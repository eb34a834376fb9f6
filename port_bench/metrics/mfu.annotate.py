"""See `yardstick.readers.mfu_untraced`."""

from port_bench.yardstick.readers import mfu_untraced as read  # noqa: F401
