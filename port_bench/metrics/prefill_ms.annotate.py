"""Mean device-clock ms of `engine.prefill` (cache and masks, the flash
prefill, the head on the last position) a batch, over the window's
batches before the profiled one."""

from port_bench.yardstick.spans import batch_mean


def read(rec):
    return batch_mean(rec, lambda r: r.device_ms("engine.prefill"))
