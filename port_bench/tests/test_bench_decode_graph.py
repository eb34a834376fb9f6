"""The decode graph share (`metrics/decode_graph_share.annotate.py`): it
reads None without the program's counters, their share with them, and 0 in
the annotate cell rehearsed traced on the CPU, where no decode step is a
graph replay."""

import sys

from port_bench.tests.test_bench_spans import CELL, ROOT, _traced


def test_decode_graph_share_reads_the_counters(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from port_bench import run
    from port_bench.yardstick import spans
    reader = run.load_file(ROOT / "port_bench" / "metrics"
                           / "decode_graph_share.annotate.py")

    class Counters:
        def __init__(self, c):
            self.c = c

        def counters(self):
            return dict(self.c)

    for held, want in (({}, None), ({"decode.row_steps": 5}, None),
                       ({"decode.steps": 128}, 0.0),
                       ({"decode.steps": 256, "decode.graph_steps": 254},
                        100.0 * 254 / 256)):
        monkeypatch.setattr(spans, "recorder", lambda h=held: Counters(h))
        assert reader.read({}) == want
    monkeypatch.setattr(spans, "recorder", lambda: None)
    assert reader.read({}) is None


def test_decode_graph_share_is_zero_on_the_cpu():
    metrics = _traced(CELL)["line"]["metrics"]
    assert metrics["decode_graph_share.annotate"]["value"] == 0.0
    assert metrics["decode_graph_share.annotate"]["unit"] == "%"
