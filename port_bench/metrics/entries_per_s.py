"""Entries of the whole batches completed in the window, over the time to
the end of the last of them."""

from port_bench.yardstick.readers import whole_batches_per_s


def read(rec):
    return whole_batches_per_s(rec, "rows")
