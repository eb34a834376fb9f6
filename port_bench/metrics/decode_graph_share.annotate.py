"""100 x the decode steps whose one-token forward ran as a CUDA graph
replay over the decode steps run, over every batch the run generated
(`infer/engine.generate`'s counters `decode.graph_steps` and
`decode.steps`). None where the program has no such counters."""

from port_bench.yardstick.spans import counter_share


def read(rec):
    return counter_share("decode.graph_steps", "decode.steps")
