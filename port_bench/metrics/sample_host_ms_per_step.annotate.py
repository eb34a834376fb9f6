"""Host ms of `engine.sample` (warp, nucleus bisection, Gumbel draw, EOS
bookkeeping) a decode step, over the window's batches before the profiled
one."""

from port_bench.yardstick.spans import per_step


def read(rec):
    return per_step(rec, "engine.sample")
