"""The per-layer metrics that read the program's own spans and counters
(`yardstick/spans.py`): each cell rehearsed traced on the CPU reports every
one of them as a number; the annotate readers take only the window's
batches before the profiled one; the ESM2 residue share is the share of the
rehearsal's proteins in their buckets. Each rehearsal is a fresh process,
which prints what the recorder held besides the run's line."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELL = "qwen2.5-7b.annotate-b128"
TRAIN = "galactica-6.7b.train-lora"
TINY = {CELL: "tiny-qwen2", TRAIN: "tiny-opt"}
NEW = {CELL: {"splice_ms.annotate", "prefill_ms.annotate",
              "sample_host_ms_per_step.annotate",
              "forward_host_ms_per_step.annotate",
              "stop_wait_ms_per_step.annotate", "prefetch_wait_ms.annotate",
              "detokenize_ms.annotate", "esm_residue_share.annotate",
              "decode_live_share.annotate"},
       TRAIN: {"forward_ms.train", "backward_ms.train", "optimizer_ms.train",
               "prefetch_wait_ms.train", "token_live_share.train"}}

# the rehearsal, then what its recorder holds: each window root in order
# with whether the profiler recorded it, and its runner.detokenize time
CODE = """
import contextlib, io, json, sys
sys.path.insert(0, '.')
from port_bench.tests import rehearse
from opus_pllm_tpu_torch.utils.observability import SPANS
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert rehearse.main(sys.argv[1:]) == 0
line = json.loads(buf.getvalue().strip().splitlines()[-1])
spans = sorted(SPANS.spans(), key=lambda s: s.start_ns)
roots = [s for s in spans if s.parent is None
         and s.name in ('runner.batch', 'train.step')]
detok = {s.parent: s.host_ms for s in spans
         if s.name == 'runner.detokenize'}
print(json.dumps({'line': line, 'roots': [
    [r.attrs.get('batch', r.attrs.get('step')), r.attrs['profiled'],
     detok.get(r.id)] for r in roots]}))
"""


def _rehearse(cell):
    e = dict(os.environ)
    e.pop("JAX_PLATFORMS", None)
    p = subprocess.run(
        [sys.executable, "-c", CODE, "--workload", cell, "--config",
         TINY[cell], "--trace", "1", "--seconds", "0"],
        cwd=ROOT, env=e, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


_RUNS = {}


def _traced(cell):
    if cell not in _RUNS:
        _RUNS[cell] = _rehearse(cell)
    return _RUNS[cell]


@pytest.mark.parametrize("cell", [CELL, TRAIN])
def test_each_new_metric_is_a_number(cell):
    metrics = _traced(cell)["line"]["metrics"]
    assert NEW[cell] <= set(metrics)
    for name in NEW[cell]:
        v = metrics[name]["value"]
        assert isinstance(v, float) and v >= 0, name
        assert metrics[name]["unit"] == ("%" if "share" in name else "ms")


def test_annotate_readers_take_the_batches_before_the_profiled_one():
    got = _traced(CELL)
    window = len(got["line"]["batch_s"])
    roots = got["roots"][-window:]
    # the tracer profiles window batch 2
    assert [r[0] for r in roots] == list(range(window))
    assert [r[1] for r in roots] == [i == 2 for i in range(window)]
    kept = [r[2] for r in roots[:2]]
    assert got["line"]["metrics"]["detokenize_ms.annotate"]["value"] \
        == sum(kept) / 2


def test_esm_residue_share_is_the_proteins_share():
    got = _traced(CELL)
    sys.path.insert(0, str(ROOT))
    from port_bench.tests.rehearse import SMALL
    from port_bench.yardstick import traffic
    mix = dict(traffic.load_mix("annotate-b128"), **SMALL["annotate"])
    lengths = traffic.quantile_lengths(mix["batch"], mix["protein_length"])
    bucket = -(-(int(lengths.max()) + 2) // mix["esm_bucket"]) \
        * mix["esm_bucket"]
    # every batch holds the same lengths, so every batch has this share
    want = 100.0 * sum(int(n) + 2 for n in lengths) / (len(lengths)
                                                       * bucket)
    got_share = got["line"]["metrics"]["esm_residue_share.annotate"]["value"]
    assert got_share == pytest.approx(want, rel=1e-12)
