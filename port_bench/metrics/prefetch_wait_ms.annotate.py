"""Mean host ms the runner waited on the prefetch thread for a batch,
over the window's batches before the profiled one."""

from port_bench.yardstick.spans import batch_mean


def read(rec):
    return batch_mean(rec, lambda r: r.wait_ms())
