"""Mean host ms of `runner.detokenize` (tokens to the host, decode, cut at
the separator) a batch, over the window's batches before the profiled
one."""

from port_bench.yardstick.spans import batch_mean


def read(rec):
    return batch_mean(rec, lambda r: r.host_ms("runner.detokenize"))
