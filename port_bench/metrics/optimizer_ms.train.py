"""Median device-clock ms of a step's `train.optimizer` (the per-leaf
normalize and cast, then AdamW), over the window's steps less the
profiled one and the one after it."""

from port_bench.yardstick.spans import step_median


def read(rec):
    return step_median(rec, lambda r: r.device_ms("train.optimizer"))
