"""The sparse-expert annotate cell (`deepseek-v2-lite.annotate-b128`,
driver `annotate_moe`) rehearsed on the CPU at the tiny configuration of
`tests/data/tiny-deepseek-v2.json`: correct as it is, not correct with a
fault planted in the decode loop or with the control in the program's
place, every per-layer metric its cell lists reported by a traced run
(the grouped GEMM's roofline only where the kernel ran: on the card); the
routed layers' readers on given counters; a program without the family
refused at once; and, on a card, the probe recording the grouped GEMM's
eager calls and none made while a stream captures."""

import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
CELL = "deepseek-v2-lite.annotate-b128"

CODE = """
import contextlib, io, json, sys
sys.path.insert(0, '.')
from port_bench import run
from port_bench.tests import rehearse
from port_bench.yardstick.traffic import load_mix
fault, argv = sys.argv[1], sys.argv[2:]
rehearse.plant(fault)
mix = load_mix('annotate-b128-moe')
mix.update(rehearse.SMALL['annotate'])
with open('port_bench/tests/data/tiny-deepseek-v2.json') as f:
    conf = json.load(f)
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert run.main(argv, device='cpu', overrides={'config': conf,
                                                   'traffic': mix}) == 0
print(buf.getvalue().strip().splitlines()[-1])
"""


@lru_cache(maxsize=None)
def _rehearse(fault="none", trace="0", control="0"):
    e = dict(os.environ)
    e.pop("JAX_PLATFORMS", None)
    p = subprocess.run(
        [sys.executable, "-c", CODE, fault, "--workload", CELL, "--seed",
         str(2 ** 33 + 7), "--seconds", "0", "--trace", trace, "--control",
         control], cwd=ROOT, env=e, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def _bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.mark.parametrize("fault,correct", [("none", True), ("token", False),
                                           ("stale", False)])
def test_rehearsal_and_its_faults(fault, correct):
    assert _rehearse(fault)["correct"] is correct


def test_control_fails_a_limit():
    r = _rehearse(control="1")
    assert r["correct"] is False
    limits = {k: c["limit"] for k, c in r["checks"].items()}
    for k, lim in limits.items():
        assert r["readings"][f"program_{k}"] <= lim


def test_traced_rehearsal_reports_the_cells_metrics():
    r = _rehearse(trace="1")
    listed = {m["name"] for m in _bench()["per_layer"]
              if CELL in m.get("workloads", [CELL])}
    # no hand-written kernel runs on the CPU: the rooflines read nothing
    rooflines = {"moe_gemm_roofline.annotate", "kernel_roofline.annotate"}
    assert set(r["metrics"]) == listed - rooflines
    assert r["metrics"]["decode_graph_share.annotate"]["value"] == 0.0
    assert r["metrics"]["moe_busiest_expert.annotate"]["value"] >= 100.0
    assert r["metrics"]["decode_weight_bw.annotate"]["value"] > 0.0


def _counters(monkeypatch, held):
    from port_bench.yardstick import spans

    class Counters:
        def counters(self):
            return dict(held)
    monkeypatch.setattr(spans, "recorder", lambda: Counters())


def test_routing_readers_on_given_counters(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from port_bench import run
    busiest = run.load_file(ROOT / "port_bench" / "metrics"
                            / "moe_busiest_expert.annotate.py")
    rec = {"moe": {"experts": 64, "routed_layers": 26, "fixed": 1.0,
                   "expert": 1.0}}
    _counters(monkeypatch, {})
    assert busiest.read(rec) is None
    # 10 forwards x 26 layers, 768 pairs each: even (12 an expert) and
    # one expert taking every row (128)
    for top, want in ((12, 100.0), (128, 100.0 * 128 / 12)):
        _counters(monkeypatch, {"moe.pairs": 768 * 260,
                                "moe.busiest": top * 260})
        assert busiest.read(rec) == pytest.approx(want)
    assert busiest.read({}) is None


def test_a_program_without_the_family_is_refused_at_once(monkeypatch):
    """The parent of this cell's PR has no deepseek_v2 preset: the driver
    raises in its set-up before it draws a weight."""
    sys.path.insert(0, str(ROOT))
    from opus_pllm_tpu_torch.core import config
    from port_bench.yardstick import deepseek
    from port_bench.yardstick.spec import load_config
    monkeypatch.delattr(config.DecoderConfig, "deepseek_v2_lite")
    with pytest.raises(AttributeError):
        deepseek.program_config(load_config("deepseek-v2-lite"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_probe_skips_calls_made_while_a_stream_captures(card):
    sys.path.insert(0, str(ROOT))
    from opus_pllm_tpu_torch.kernels import moe
    from port_bench.yardstick.moe_probe import MoEProbe
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((300, 128), generator=g, device="cuda").bfloat16()
    w = torch.randn((4, 128, 256), generator=g, device="cuda").bfloat16()
    offsets = torch.tensor([0, 100, 100, 250, 300], dtype=torch.int32,
                           device="cuda")
    probe = MoEProbe()
    with probe.installed():
        eager = moe.grouped_gemm(x, w, offsets)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin()
            out = moe.grouped_gemm(x, w, offsets)
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert [c[0] for c in probe.calls] == ["moe_grouped_gemm"]
    calls, bound = probe.bounds()["moe_grouped_gemm"]
    assert calls == 1 and bound > 0
