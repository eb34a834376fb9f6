"""Mean device-clock ms of `runner.splice` (ESM2, CSTP, the switch, the
splice) a batch, over the window's batches before the profiled one."""

from port_bench.yardstick.spans import batch_mean


def read(rec):
    return batch_mean(rec, lambda r: r.device_ms("runner.splice"))
