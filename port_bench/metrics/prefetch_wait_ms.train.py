"""Median host ms the train loop waited on the prefetch thread for a
step's batch, over the window's steps less the profiled one and the one
after it."""

from port_bench.yardstick.spans import step_median


def read(rec):
    return step_median(rec, lambda r: r.wait_ms())
