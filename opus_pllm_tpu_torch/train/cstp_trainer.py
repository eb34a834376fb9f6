"""Stage (a): CSTP contrastive alignment training (port of
`opus_pllm_tpu/train/cstp_trainer.py`, the whole module):
`CSTPTrainState` (cstp_trainer.py:35), `create_state` (:41),
`loss_and_metrics` (:48), `make_train_step` (:77), `make_eval_step`
(:89), `evaluate` (:98), `fit` (:113) and `restore_state` (:168).

As in the reference's recommended path the encoders stay out of the
training graph: batches carry precomputed (seq_embedding, text_embedding)
pairs (`data.precompute.precompute_cstp_pairs` ->
`data.datasets.UniProtQAVecDataset.arrays`), and the trained state is the
two fp32 projection linears. The similarity logits are (B, B) with
diagonal targets, so the evidential loss's width is the batch. One step:
`loss_and_metrics`, `torch.autograd.grad` of the parameters, then the
AdamW of `train.optim.adamw` (stage (a)'s lr 0.05 and wd 1e-4 by default
in `TrainConfig`). The state's tensors are updated in place and the same
state object is returned (the JAX step returns a new state).

`fit(ckpt=, save_every=)` saves the full state ({"params", "opt_state",
"step"}) through a `core.checkpoint.CheckpointManager`; `restore_state`
loads one into a freshly built state. `fit(prefetch=N)` places the next
N batches on a background thread (`utils.prefetch`, the JAX default 2).

`fit(mesh=)` is stage (a)'s data parallelism (JAX :110-166; Lightning
DDP's role): the parameters and moments stay whole on every rank, each
batch's rows split over the data ranks (B % D == 0), and each rank's
projected embeddings are all-gathered over `data` before the similarity
(`core.mesh.gather_from`), so the contrastive matrix spans the
global batch as one process's does; its backward hands each rank its
rows' part of the gradient, and one all-reduce over `data` sums the
parameters' gradients: every rank then holds the gradient one process
computes on the global batch, and the loss, the accuracies, `grad_norm`
and `evidence_dead` are the global batch's. Ranks along `model` compute
the same, as JAX replicates it. Checkpoints as in the multimodal trainer
(rank 0 writes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..bridge import cstp, losses
from ..core import checkpoint
from ..core import mesh as mesh_mod
from ..core.config import CSTPConfig, TrainConfig
from ..core.util import resolve_device, to_device
from ..utils.prefetch import prefetch_to_device
from .multimodal_trainer import (_flat_all_reduce, _is_rank0,
                                 _trainable_copy, finish_saves, leaves,
                                 maybe_save)
from .optim import AdamW, adamw


@dataclass
class CSTPTrainState:
    params: dict          # {"protein_projection", "text_projection"}, fp32
    opt_state: AdamW      # the optimizer, holding the moments
    step: int


def create_state(cfg: CSTPConfig, tcfg: TrainConfig,
                 total_steps: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None, params=None,
                 device=None) -> Tuple[CSTPTrainState, AdamW]:
    """(state, optimizer) from fresh projections drawn from `generator` on
    `device` (None: CUDA), or from a copy of `params` (e.g.
    `core.convert.cstp_from_jax`'s)."""
    if params is None:
        params = cstp.init(cfg, generator=generator,
                           device=resolve_device(device))
    params = _trainable_copy(params)
    tx = adamw(tcfg, total_steps, leaves(params))
    return CSTPTrainState(params, tx, 0), tx


def loss_and_metrics(params, cfg: CSTPConfig, seq_emb, text_emb, step: int,
                     mesh=None):
    """(loss, metrics) of one batch: the symmetric evidential loss over the
    (B, B) similarity logits, and both directions' top-1 retrieval
    accuracy. `cfg.warmup_info_nce_steps` N > 0 takes `info_nce_sym` at
    10 x cfg.temperature for steps < N; -1 takes it on any batch where
    `losses.evidence_is_dead` holds. Both losses are computed and one is
    chosen by `torch.where` on the device (no host read in the automatic
    mode); the gradient flows through the chosen one only. With a warm-up
    the metrics carry `warmup_active` (1.0 where InfoNCE ran). Beyond the
    JAX function's metrics, `evidence_dead` is 1.0 where
    `losses.evidence_is_dead` holds for the batch (the evidential loss's
    gradient is 0 there). With `mesh` the embeddings are this data rank's
    rows and the projections are gathered over the data ranks first."""
    p, t = cstp.forward(params, seq_emb, text_emb)
    if mesh is not None and mesh.data > 1:
        p = mesh_mod.gather_from(p, mesh.data_group, dim=0)
        t = mesh_mod.gather_from(t, mesh.data_group, dim=0)
    al = cstp.alignment(p, t)
    loss = losses.trust_evidence(al["protein2text"], al["text2protein"],
                                 al["targets"], cfg)
    dead = losses.evidence_is_dead(al["protein2text"], al["text2protein"],
                                   cfg)
    w = cfg.warmup_info_nce_steps
    if w:
        l_nce = losses.info_nce_sym(al["protein2text"], al["text2protein"],
                                    al["targets"],
                                    temperature=10.0 * cfg.temperature)
        use_nce = (torch.tensor(step < w, device=loss.device) if w > 0
                   else dead)
        loss = torch.where(use_nce, l_nce, loss)
    metrics = {"loss": loss.detach(),
               "acc_seq2text": cstp.retrieval_accuracy(al["protein2text"],
                                                       al["targets"]),
               "acc_text2seq": cstp.retrieval_accuracy(al["text2protein"],
                                                       al["targets"]),
               "evidence_dead": dead.float()}
    if w:
        metrics["warmup_active"] = use_nce.float()
    return loss, metrics


def make_train_step(cfg: CSTPConfig, tx: AdamW, mesh=None):
    """train_step(state, seq_emb, text_emb) -> (state, metrics): the
    metrics at the parameters before the update, then one AdamW update in
    place. The metrics also carry `grad_norm`, the global norm of the
    gradient the update took (a 0-d tensor). With `mesh` the embeddings
    are the rank's rows of the batch and the gradients are summed over
    the data ranks in one all-reduce (module docstring)."""

    def train_step(state: CSTPTrainState, seq_emb, text_emb):
        lv = leaves(state.params)
        loss, metrics = loss_and_metrics(state.params, cfg, seq_emb,
                                         text_emb, state.step, mesh)
        grads = torch.autograd.grad(loss, lv)
        if mesh is not None and mesh.data > 1:
            grads = _flat_all_reduce([g.float() for g in grads],
                                     mesh.data_group)
        metrics["grad_norm"] = torch.sqrt(sum(g.float().pow(2).sum()
                                              for g in grads))
        for p, g in zip(lv, grads):
            p.grad = g
        tx.step()
        tx.zero_grad()
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(cfg: CSTPConfig, mesh=None):
    @torch.no_grad()
    def eval_step(params, seq_emb, text_emb):
        return loss_and_metrics(params, cfg, seq_emb, text_emb, 0, mesh)[1]
    return eval_step


def evaluate(params, cfg: CSTPConfig, batches, *, device=None,
             mesh=None) -> dict:
    """Mean loss and both retrieval accuracies over (seq_emb, text_emb)
    batches (the validation / test epoch summaries), on `device` (None:
    CUDA). With `mesh` each batch is split over the data ranks as in
    training (B % D == 0) and the metrics are the global batch's."""
    device = resolve_device(device)
    ev = make_eval_step(cfg, mesh)
    sums: dict = {}
    n = 0
    for pair in batches:
        if mesh is not None:
            pair = mesh_mod.shard_batch(mesh, tuple(pair))
        m = ev(params, *to_device(tuple(pair), device))
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}


def fit(state: CSTPTrainState, tx: AdamW, cfg: CSTPConfig, tcfg: TrainConfig,
        batches: Iterator[Tuple[np.ndarray, np.ndarray]],
        val_batches_fn=None, mesh=None, log_fn=print, prefetch: int = 2,
        ckpt=None, save_every: int = 0, device=None,
        metrics_fn=None) -> CSTPTrainState:
    """Epoch loop over batches of (seq_emb, text_emb) numpy arrays of one
    batch size, each moved to `device` (None: CUDA). Every
    `tcfg.log_every` steps the step's metrics are logged (which waits for
    the step) and, with `val_batches_fn` (callable -> a fresh iterator),
    `evaluate` runs over the held-out batches. `metrics_fn(step_no,
    metrics)`, when given, receives every step's metrics as tensors; it
    exists for callers that gate each step (chip_smoke.py's stage (a)
    checks a finite loss, `evidence_dead` and `grad_norm` per step),
    which `log_fn`'s formatted lines do not serve.

    ckpt + save_every > 0: every `save_every` steps the full state saves to
    the CheckpointManager `ckpt`; restore it with restore_state(ckpt,
    fresh_state) and skip `state.step` batches to resume."""
    device = resolve_device(device)
    if mesh is not None:
        def rows(pair):
            n = pair[0].shape[0]
            if n % mesh.data:
                raise ValueError(f"batch {n} does not split over the "
                                 f"mesh's data axis of {mesh.data}")
            return mesh_mod.shard_batch(mesh, tuple(pair))
        batches = (rows(pair) for pair in batches)
        if not _is_rank0():
            log_fn = lambda *_: None    # noqa: E731 — rank 0 logs
    stage = lambda pair: to_device(tuple(pair), device)
    if prefetch:
        batches = prefetch_to_device(batches, size=prefetch, device=device)
        stage = lambda pair: pair    # already placed by the producer
    step_fn = make_train_step(cfg, tx, mesh)
    start = state.step
    for i, pair in enumerate(batches):
        state, metrics = step_fn(state, *stage(pair))
        step_no = start + i + 1
        if metrics_fn is not None:
            metrics_fn(step_no, metrics)
        maybe_save(ckpt, save_every, step_no, state)
        if tcfg.log_every and i % tcfg.log_every == 0:
            log_fn(f"step {step_no}: " + " ".join(
                f"{k}={float(v):.4f}" for k, v in metrics.items()))
            if val_batches_fn is not None:
                vm = evaluate(state.params, cfg, val_batches_fn(),
                              device=device, mesh=mesh)
                log_fn("  val: " + " ".join(f"{k}={v:.4f}"
                                            for k, v in vm.items()))
    finish_saves(ckpt, save_every)
    return state


def restore_state(ckpt, like: CSTPTrainState,
                  step: Optional[int] = None) -> CSTPTrainState:
    """Load the state saved at `step` (None: the latest) by fit(ckpt=...)
    into `like`, a freshly built state (create_state's), and return it:
    the parameters are overwritten in place and the optimizer loads the
    moments and the schedule count, so the optimizer create_state returned
    goes on stepping them. A structure that differs raises ValueError."""
    saved = ckpt.restore(step)
    params = checkpoint.conform(saved["params"], like.params, "params")
    with torch.no_grad():
        for dst, src in zip(leaves(like.params), leaves(params)):
            dst.copy_(src)
    like.opt_state.load_state_dict(saved["opt_state"])
    like.step = int(saved["step"])
    return like
