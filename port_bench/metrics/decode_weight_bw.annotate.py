"""The decode steps' weight stream against the HBM peak: 100 x the bytes
the replayed steps' weights need / (3.35 TB/s x those steps' time).

The bytes of one step: every weight outside the routed experts (the
embedding's rows excepted) and one routed expert's weights for each
expert with a pair in each routed layer, the latter the mean over the
run's decode forwards (`moe.experts_hit` / (`moe.slots` / (experts x
routed layers)); the driver records the sizes under `moe`). The time of a
step: its `engine.stop_check`, `engine.sample` and `engine.forward` spans
on the host's clock, over the window's batches before the profiled one.
Steps 0 and 1 of each batch are left out: the first runs the forward
eagerly (the warm-up), the second captures it. None where the program
has no such spans or counters."""

from port_bench.yardstick import spans, work

PARTS = ("engine.stop_check", "engine.sample", "engine.forward")


def read(rec):
    spans_rec, moe = spans.recorder(), rec.get("moe")
    kept = spans.annotate_batches(rec)
    if spans_rec is None or not moe or not kept:
        return None
    c = spans_rec.counters()
    forwards = c.get("moe.slots", 0) / (moe["experts"] * moe["routed_layers"])
    if not forwards:
        return None
    step_bytes = moe["fixed"] + moe["expert"] * c.get("moe.experts_hit",
                                                      0) / forwards
    steps, seconds = 0, 0.0
    for root in kept:
        parts = [sorted(root.below.get(n, ()), key=lambda s: s.start_ns)
                 for n in PARTS]
        n = min(len(p) for p in parts)
        for i in range(2, n):
            seconds += sum(p[i].host_ns for p in parts) / 1e9
            steps += 1
    if not steps:
        return None
    return 100.0 * step_bytes * steps / (work.PEAK_HBM_BYTES * seconds)
