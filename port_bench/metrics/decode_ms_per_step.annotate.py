"""The static decode loop's time per step: `GenerateOutput.decode_seconds`
over its steps, summed over the window's batches before the profiled
one."""

from port_bench.yardstick.readers import before_profiled


def read(rec):
    done = before_profiled(rec)
    steps = sum(b["steps"] for b in done)
    if not steps:
        return None
    return 1e3 * sum(b["decode_s"] for b in done) / steps
