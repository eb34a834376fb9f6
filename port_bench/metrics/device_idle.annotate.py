"""See `yardstick.readers.device_idle_untraced`."""

from port_bench.yardstick.readers import \
    device_idle_untraced as read  # noqa: F401
