"""`port_bench/run.py` end to end: no card, no JAX, a rehearsal of each
cell at a test size on the CPU, its faults and its control. Each run is a
fresh process, so that what the run loads is what it imports itself."""

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
E2E = {CELL: {"entries_per_s", "setup_s"},
       TRAIN: {"train_tokens_per_s", "setup_s"}}


def _limits(cell):
    return json.loads((ROOT / "port_bench" / "limits"
                       / f"{cell}.json").read_text())


def _run(*args, env=None):
    e = dict(os.environ, **(env or {}))
    e.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=e,
                          capture_output=True, text=True, timeout=600)


def _result(p):
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_without_a_card_no_result_and_nonzero_exit():
    p = _run("port_bench/run.py", "--workload", CELL, "--seed", "1",
             "--seconds", "1", "--trace", "0",
             env={"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_nothing_it_loads_is_jax_or_the_jax_package():
    code = (
        "import sys, glob, importlib.util\n"
        "sys.path.insert(0, '.')\n"
        "from port_bench import run\n"
        "from port_bench.tests import rehearse\n"
        "for f in sorted(glob.glob('port_bench/drivers/*.py')\n"
        "                + glob.glob('port_bench/metrics/*.py')):\n"
        "    run.load_file(__import__('pathlib').Path(f))\n"
        "import port_bench.reference.model, port_bench.yardstick.trace\n"
        "assert rehearse.main(['--workload', sys.argv[1]]) == 0\n"
        "print('LOADED', run.forbidden_modules())\n")
    p = _run("-c", code, CELL)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "LOADED []" in p.stdout


def test_names_are_compared_whole(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from port_bench import run
    monkeypatch.setattr(sys, "modules", {
        "opus_pllm_tpu_torch": 0, "opus_pllm_tpu_torch.models": 0,
        "jaxlib.xla": 0, "jaxtyping": 0})
    assert run.forbidden_modules() == ["jaxlib"]


def _rehearse(cell, *args):
    return _result(_run("port_bench/tests/rehearse.py", "--workload", cell,
                        "--config", TINY[cell], *args))


@pytest.mark.parametrize("cell,fault,correct", [
    (CELL, "none", True), (CELL, "token", False), (CELL, "stale", False),
    (TRAIN, "none", True), (TRAIN, "nostep", False),
    (TRAIN, "halfbatch", False)])
def test_rehearsal_and_its_faults(cell, fault, correct):
    r = _rehearse(cell, "--fault", fault)
    assert r["correct"] is correct, r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == E2E[cell]


@pytest.mark.parametrize("cell", [CELL, TRAIN])
def test_control_fails_a_limit(cell):
    """The control in the program's place comes out not correct, through
    the same comparison, while the program's own readings pass."""
    r = _rehearse(cell, "--control", "1")
    assert r["correct"] is False
    lim = _limits(cell)
    assert set(r["checks"]) == set(lim)
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
    assert all(r["readings"][f"program_{k}"] <= v for k, v in lim.items())


@pytest.mark.parametrize("cell,metrics", [
    (CELL, {"decode_ms_per_step.annotate", "mfu.annotate",
            "device_idle.annotate"}),
    (TRAIN, {"mfu.train", "device_idle.train"})])
def test_traced_rehearsal_reports_the_per_layer_metrics(cell, metrics):
    r = _rehearse(cell, "--trace", "1", "--seconds", "0")
    assert r["device"]["window_s"] > 0
    assert metrics <= set(r["metrics"])
    assert "kernel_roofline" not in " ".join(r["metrics"])  # no kernel ran


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_cell_runs_on_the_card(card):
    r = _result(_run("port_bench/run.py", "--workload", CELL, "--seed",
                     "3000000111", "--seconds", "1", "--trace", "0"))
    assert r["correct"] is True
    assert r["device"]["platform"] == "gpu"
