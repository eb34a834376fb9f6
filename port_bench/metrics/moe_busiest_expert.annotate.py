"""The routing's imbalance in the decode steps: 100 x the busiest expert's
pairs / the mean expert's, over every (decode forward, routed layer) of
the run (`infer/engine.generate`'s counters `moe.busiest` and `moe.pairs`,
with the expert count the driver records): 100 when every expert takes
as many pairs. None where the program has no such counters."""

from port_bench.yardstick import spans


def read(rec):
    spans_rec = spans.recorder()
    moe = rec.get("moe")
    if spans_rec is None or not moe:
        return None
    c = spans_rec.counters()
    if not c.get("moe.pairs"):
        return None
    return 100.0 * c.get("moe.busiest", 0) * moe["experts"] / c["moe.pairs"]
