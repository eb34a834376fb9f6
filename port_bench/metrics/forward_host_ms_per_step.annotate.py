"""Host ms of `engine.forward` (embed, the one-token decoder forward, the
logits cast) a decode step, over the window's batches before the profiled
one."""

from port_bench.yardstick.spans import per_step


def read(rec):
    return per_step(rec, "engine.forward")
