"""See `yardstick.readers.device_idle`."""

from port_bench.yardstick.readers import device_idle as read  # noqa: F401
