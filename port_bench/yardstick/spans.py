"""The program's own spans and counters, for the per-layer metrics that
read them.

The port records spans and counters in one recorder,
`opus_pllm_tpu_torch.utils.observability.SPANS`, which the run has loaded
with the program. The readers select the window's roots from it:

- annotate: the last `len(rec["batches"])` `runner.batch` roots, which
  must carry the window batches' indices, of which those before the first
  one opened under the profiler;
- train: the last `len(rec["steps"])` `train.step` roots, less the one
  opened under the profiler and the one after it (the profiler's exit
  slows it).

Where the program has no recorder, or the recorder holds fewer roots than
the window had, every function here returns None, and the metric is left
out of the result line.
"""

from __future__ import annotations

import importlib
import statistics
from collections import defaultdict

PROGRAM = "opus_pllm_tpu_torch.utils.observability"


def recorder():
    """The program's recorder, or None where it has none."""
    try:
        mod = importlib.import_module(PROGRAM)
    except ImportError:
        return None
    return getattr(mod, "SPANS", None)


class Root:
    """One selected root span: the spans under it by name, and the
    `prefetch.wait` that closed last on its thread before it opened."""

    def __init__(self, span, below: dict, wait):
        self.span, self.below, self.wait = span, below, wait

    def host_ms(self, name: str) -> float:
        return sum(s.host_ms for s in self.below.get(name, ()))

    def device_ms(self, name: str) -> float:
        return sum(s.device_ms for s in self.below.get(name, ()))

    def wait_ms(self) -> float:
        return self.wait.host_ms if self.wait is not None else 0.0


def _roots(name: str, n: int):
    """The last `n` roots called `name`, each a `Root`, in order; None
    where the recorder has fewer."""
    spans_rec = recorder()
    if spans_rec is None or n <= 0:
        return None
    spans = sorted(spans_rec.spans(), key=lambda s: s.start_ns)
    roots = [s for s in spans if s.name == name and s.parent is None]
    if len(roots) < n:
        return None
    roots = roots[-n:]
    children = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append(s)
    waits = [s for s in spans if s.name == "prefetch.wait"]
    out = []
    for r in roots:
        below, todo = defaultdict(list), list(children[r.id])
        while todo:
            s = todo.pop()
            below[s.name].append(s)
            todo.extend(children[s.id])
        before = [w for w in waits if w.thread == r.thread
                  and w.end_ns <= r.start_ns]
        out.append(Root(r, below, before[-1] if before else None))
    return out


def annotate_batches(rec: dict):
    """The window's batches before the profiled one, as `Root`s."""
    batches = rec.get("batches") or []
    roots = _roots("runner.batch", len(batches))
    if roots is None:
        return None
    if [r.span.attrs.get("batch") for r in roots] != [
            b["index"] for b in batches]:
        return None
    kept = []
    for r in roots:
        if r.span.attrs.get("profiled"):
            break
        kept.append(r)
    return kept or None


def train_steps(rec: dict):
    """The window's steps, less the profiled one and the one after it."""
    roots = _roots("train.step", len(rec.get("steps") or []))
    if roots is None:
        return None
    drop = set()
    for i, r in enumerate(roots):
        if r.span.attrs.get("profiled"):
            drop |= {i, i + 1}
    kept = [r for i, r in enumerate(roots) if i not in drop]
    return kept or None


def batch_mean(rec: dict, fn):
    """The mean over the annotate batches of `fn(root)`."""
    kept = annotate_batches(rec)
    if not kept:
        return None
    return sum(fn(r) for r in kept) / len(kept)


def per_step(rec: dict, name: str):
    """Σ host ms of the `name` spans over the annotate batches / Σ their
    decode steps."""
    kept = annotate_batches(rec)
    if not kept:
        return None
    steps = sum(len(r.below.get("engine.sample", ())) for r in kept)
    if not steps:
        return None
    return sum(r.host_ms(name) for r in kept) / steps


def step_median(rec: dict, fn):
    """The median over the train steps of `fn(root)`."""
    kept = train_steps(rec)
    if not kept:
        return None
    return statistics.median(fn(r) for r in kept)


def counter_share(num: str, den: str):
    """100 x counter `num` / counter `den`, over the whole run."""
    spans_rec = recorder()
    if spans_rec is None:
        return None
    c = spans_rec.counters()
    if not c.get(den):
        return None
    return 100.0 * c.get(num, 0) / c[den]
