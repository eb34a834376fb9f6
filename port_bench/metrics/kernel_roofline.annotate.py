"""See `yardstick.readers.kernel_roofline`."""

from port_bench.yardstick.readers import kernel_roofline as read  # noqa: F401
