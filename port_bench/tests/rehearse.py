"""Drive one run of a cell at a test size on the CPU, the harness's look for
a card skipped: the tiny configuration of `tests/data/`, the cell's mix cut
to a few short rows, and optionally a fault planted in the port's timed
path underneath. Prints the run's JSON line, as `run.py` does.

    python3 port_bench/tests/rehearse.py --workload <cell> [--fault token]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DATA = Path(__file__).resolve().parent / "data"
SMALL = {
    "annotate": {"batch": 4, "batches_max": 4, "check_rows": 3,
                 "protein_length": {"median": 30, "sigma": 0.6, "min": 10,
                                    "max": 80}},
    "train": {"batch": 4, "max_len": 384, "setup_steps": 3, "steps_max": 3,
              "protein_length": {"median": 30, "sigma": 0.6, "min": 10,
                                 "max": 80},
              "answer_length": {"median": 40, "sigma": 0.9, "min": 4,
                                "max": 200}},
}
FAULTS = ("none", "token", "stale", "nostep", "halfbatch")


def plant(fault: str) -> None:
    """token: every 8th sampled token is replaced where it is sampled;
    stale: each decode step returns the state it was given (the token it
    feeds the next step is the one it received; the sampled token is still
    written to the output); nostep: the optimizer step leaves the
    train state unchanged; halfbatch: the loss leaves out half of the
    batch's rows, the mean taken over the rest."""
    from opus_pllm_tpu_torch.infer import engine
    from opus_pllm_tpu_torch.train import multimodal_trainer as mmt
    from opus_pllm_tpu_torch.train import optim
    if fault == "token":
        orig = engine.sample_token
        count = {"n": 0}

        def sample_token(logits, *a, **k):
            t = orig(logits, *a, **k)
            count["n"] += 1
            if count["n"] % 8 == 4:
                t = (t + 1) % logits.shape[-1]
            return t
        engine.sample_token = sample_token
    elif fault == "stale":
        orig_a = engine.advance_sampling
        fed = {}

        def advance_sampling(step, done, *a, **k):
            nxt, *rest = orig_a(step, done, *a, **k)
            if step == 0:
                fed["t"] = nxt
            return (fed["t"], *rest)
        engine.advance_sampling = advance_sampling
    elif fault == "nostep":
        optim.AdamW.step = lambda self: None
    elif fault == "halfbatch":
        orig_l = mmt.loss_fn

        def loss_fn(trainable, frozen, cfg, batch, *a, **k):
            n = batch["input_ids"].shape[0]
            half = {key: v[:max(n // 2, 1)] for key, v in batch.items()}
            return orig_l(trainable, frozen, cfg, half, *a, **k)
        mmt.loss_fn = loss_fn


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--config", default="tiny-qwen2")
    p.add_argument("--fault", choices=FAULTS, default="none")
    p.add_argument("--seed", type=int, default=2 ** 33 + 7)
    p.add_argument("--seconds", default="1")
    p.add_argument("--trace", default="0")
    p.add_argument("--control", default="0")
    p.add_argument("--card", action="store_true",
                   help="the cell's own configuration and mix on the card "
                        "(a fault read at the cell's size)")
    a = p.parse_args(argv)
    from port_bench import run
    from port_bench.yardstick.traffic import load_mix
    with open(ROOT / "BENCHMARK.json") as f:
        cell = {w["name"]: w for w in json.load(f)["workloads"]}[a.workload]
    argv = ["--workload", a.workload, "--seed", str(a.seed), "--seconds",
            a.seconds, "--trace", a.trace, "--control", a.control]
    plant(a.fault)
    if a.card:
        return run.main(argv)
    mix = load_mix(cell["traffic"])
    mix.update(SMALL[mix["driver"]])
    with open(DATA / f"{a.config}.json") as f:
        conf = json.load(f)
    return run.main(argv, device="cpu",
                    overrides={"config": conf, "traffic": mix})


if __name__ == "__main__":
    sys.exit(main())
