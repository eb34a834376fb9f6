"""Host ms of `engine.stop_check` (the decode loop's read of the device,
waiting for it) a decode step, over the window's batches before the
profiled one."""

from port_bench.yardstick.spans import per_step


def read(rec):
    return per_step(rec, "engine.stop_check")
