"""See `yardstick.readers.mfu`."""

from port_bench.yardstick.readers import mfu as read  # noqa: F401
