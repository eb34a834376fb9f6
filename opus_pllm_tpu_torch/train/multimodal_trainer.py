"""Stages (c) and (d): projector training and LoRA instruction tuning (port
of `opus_pllm_tpu/train/multimodal_trainer.py`: `MMTrainState` :32,
`init_trainable` :38, `create_state` :55, `loss_fn` :86,
`make_train_step` :117, `make_eval_step` :184, `maybe_save` :66,
`finish_saves` :73, `fit` :212, `restore_state` :296).

The trainable leaves live in their own tree ({"switch": ...} and/or
{"lora": ...}, fp32, `requires_grad`); the frozen ESM / CSTP / LLM tree
takes no gradient. One step: `loss_fn` (next-token cross-entropy over the
right-padded spliced stream), `torch.autograd.grad` of the trainable
leaves, then the optimizer of `train.optim.adamw`. Unlike the JAX step,
which returns a new state, the port updates the state's tensors in place
and returns the same state object.

`fit(ckpt=, save_every=)` saves the full train state (trainable leaves,
the optimizer's moments and schedule count, the step) through a
`core.checkpoint.CheckpointManager`; `restore_state` loads one into a
freshly built state, from which `fit` over the batches after its step
continues exactly (tests/test_torch_checkpoint.py).

`fit(prefetch=N)` prepares and places the next N batches on a background
thread (`utils.prefetch`, the JAX default 2). Not ported yet, and refused
with NotImplementedError: the mesh (ROADMAP.md §1 item 10, the training
axes).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional

import torch

from ..core import checkpoint
from ..core.config import IGNORE_INDEX, LoRAConfig, OpusConfig, TrainConfig
from ..core.util import resolve_device, to_device
from ..lora import lora as lora_mod
from ..models import opus
from ..utils.prefetch import prefetch_to_device
from .optim import AdamW, adamw


@dataclass
class MMTrainState:
    trainable: Dict[str, Any]     # {"switch": ...} | {"lora": ...} | both
    opt_state: AdamW              # the optimizer, holding the moments
    step: int


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict / list, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def _trainable_copy(tree):
    if isinstance(tree, dict):
        return {k: _trainable_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_trainable_copy(v) for v in tree]
    return tree.detach().clone().requires_grad_(True)


def init_trainable(cfg: OpusConfig, *, train_switch: bool,
                   lora_cfg: Optional[LoRAConfig], frozen_params,
                   generator: torch.Generator, device=None) -> dict:
    """The trainable tree: a COPY of the frozen switch (the frozen tree's
    leaves are never updated) and/or fresh LoRA adapters from `generator`
    on `device` (None: CUDA)."""
    t: Dict[str, Any] = {}
    if train_switch:
        t["switch"] = _trainable_copy(frozen_params["switch"])
    if lora_cfg is not None:
        t["lora"] = _trainable_copy(lora_mod.init(
            cfg.llm, lora_cfg, generator=generator, device=device))
    return t


def create_state(cfg: OpusConfig, tcfg: TrainConfig, frozen_params, *,
                 generator: Optional[torch.Generator] = None,
                 train_switch: bool = True,
                 lora_cfg: Optional[LoRAConfig] = None,
                 total_steps: Optional[int] = None, device=None,
                 trainable=None):
    """(state, optimizer). `trainable` starts from a given tree (e.g.
    `core.convert.trainable_from_jax`) instead of a fresh one."""
    if trainable is None:
        trainable = init_trainable(cfg, train_switch=train_switch,
                                   lora_cfg=lora_cfg,
                                   frozen_params=frozen_params,
                                   generator=generator,
                                   device=resolve_device(device))
    else:
        trainable = _trainable_copy(trainable)
    tx = adamw(tcfg, total_steps, leaves(trainable))
    return MMTrainState(trainable, tx, 0), tx


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md §1 "
                               f"item {item})")


def state_tree(state) -> dict:
    """The tree a checkpoint holds: the state's fields with the optimizer
    as its state_dict() ({"trainable", "opt_state", "step"} here,
    {"params", "opt_state", "step"} for the CSTP state), as the JAX
    state's `_asdict()`."""
    tree = {f.name: getattr(state, f.name) for f in fields(state)}
    tree["opt_state"] = state.opt_state.state_dict()
    return tree


def maybe_save(ckpt, save_every: int, step_no: int, state) -> None:
    """Every `save_every` steps, the full state to `ckpt`. The manager
    copies the tensors to the host before it returns (the next step
    updates them in place); only the file write runs in the background."""
    if ckpt is not None and save_every and step_no % save_every == 0:
        ckpt.save(step_no, state_tree(state), wait=False)


def finish_saves(ckpt, save_every: int) -> None:
    """Wait for the saves in flight before the fit loop returns."""
    if ckpt is not None and save_every:
        ckpt.wait()


def restore_state(ckpt, like: MMTrainState,
                  step: Optional[int] = None) -> MMTrainState:
    """Load the state saved at `step` (None: the latest) by
    fit(ckpt=..., save_every=...) into `like`, a freshly built state of
    the same structure (e.g. create_state's), and return it. The leaves
    are overwritten in place and the optimizer loads the moments and the
    schedule's count, so the optimizer create_state returned with `like`
    goes on stepping the restored leaves; a structure that differs
    raises ValueError."""
    saved = ckpt.restore(step)
    trainable = checkpoint.conform(saved["trainable"], like.trainable,
                                   "trainable")
    with torch.no_grad():
        for dst, src in zip(leaves(like.trainable), leaves(trainable)):
            dst.copy_(src)
    like.opt_state.load_state_dict(saved["opt_state"])
    like.step = int(saved["step"])
    return like


def _assemble(frozen, trainable):
    params = dict(frozen)
    if "switch" in trainable:
        params["switch"] = trainable["switch"]
    return params


def loss_fn(trainable, frozen, cfg: OpusConfig, batch, lora_scale: float,
            remat=True, ce_chunk: int = 0, impl: str = "auto"):
    """Next-token CE over the spliced multimodal stream (the right-pad
    training path; labels at protein slots are IGNORE_INDEX) -> (loss,
    {"loss", "valid"}), `valid` the number of target tokens the mean is
    over. Batches with a `pooled_emb` skip the ESM tower. ce_chunk > 0
    chunks the vocab head and the CE (`opus.next_token_loss_hidden`)."""
    params = _assemble(frozen, trainable)
    out, sp = opus.forward(
        params, cfg, batch["input_ids"], batch["attn_mask"],
        batch.get("esm_tokens"), labels=batch["labels"],
        lora=trainable.get("lora"), lora_scale=lora_scale,
        pooled_emb=batch.get("pooled_emb"), remat=remat,
        return_hidden=ce_chunk > 0, impl=impl)
    if ce_chunk > 0:
        loss = opus.next_token_loss_hidden(params["llm"], cfg.llm, out,
                                           sp.labels, sp.mask, chunk=ce_chunk)
    else:
        loss = opus.next_token_loss(out, sp.labels, sp.mask)
    valid = ((sp.labels[:, 1:] != IGNORE_INDEX) & sp.mask[:, 1:]).sum()
    return loss, {"loss": loss.detach(), "valid": valid}


def make_train_step(cfg: OpusConfig, tx: AdamW, *,
                    lora_cfg: Optional[LoRAConfig] = None, ce_chunk: int = 0,
                    grad_accum: int = 1, remat=True, impl: str = "auto"):
    """step(state, frozen, batch) -> (state, metrics). grad_accum > 1 splits
    the batch into that many micro-chunks, one forward / backward each,
    and combines their gradients weighted by valid-token counts, so the
    update equals the one-big-batch step (multimodal_trainer.py:117-181)."""
    ls = lora_mod.scaling(lora_cfg) if lora_cfg is not None else 1.0

    def grads_of(trainable, frozen, batch):
        lv = leaves(trainable)

        def one(b):
            loss, metrics = loss_fn(trainable, frozen, cfg, b, ls, remat,
                                    ce_chunk, impl)
            grads = torch.autograd.grad(loss, lv, allow_unused=True,
                                        materialize_grads=True)
            return loss.detach(), metrics, grads

        if grad_accum <= 1:
            return one(batch)
        n = batch["input_ids"].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} not divisible by "
                             f"grad_accum={grad_accum}")
        per = n // grad_accum
        loss_sum = cnt = torch.zeros((), dtype=torch.float32,
                                     device=lv[0].device)
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in lv]
        for i in range(grad_accum):
            chunk = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            loss, metrics, grads = one(chunk)
            c = metrics["valid"].float()
            # d(mean)/dw * count = d(sum)/dw: sum the loss-SUM gradients in
            # fp32, normalize once by the total count
            gsum = [a + g.float() * c for a, g in zip(gsum, grads)]
            loss_sum = loss_sum + loss * c
            cnt = cnt + c
        denom = cnt.clamp_min(1.0)
        grads = [(g / denom).to(p.dtype) for g, p in zip(gsum, lv)]
        loss = loss_sum / denom
        return loss, {"loss": loss, "valid": cnt.int()}, grads

    def train_step(state: MMTrainState, frozen, batch):
        _, metrics, grads = grads_of(state.trainable, frozen, batch)
        for p, g in zip(leaves(state.trainable), grads):
            p.grad = g
        tx.step()
        tx.zero_grad()
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(cfg: OpusConfig, *, lora_cfg: Optional[LoRAConfig] = None,
                   ce_chunk: int = 0, impl: str = "auto"):
    ls = lora_mod.scaling(lora_cfg) if lora_cfg is not None else 1.0

    @torch.no_grad()
    def eval_step(trainable, frozen, batch):
        _, metrics = loss_fn(trainable, frozen, cfg, batch, ls, False,
                             ce_chunk, impl)
        return metrics

    return eval_step


def fit(state: MMTrainState, tx: AdamW, cfg: OpusConfig, tcfg: TrainConfig,
        frozen, batches, *, lora_cfg: Optional[LoRAConfig] = None, mesh=None,
        log_fn=print, prefetch: int = 2, ckpt=None, save_every: int = 0,
        val_batches_fn=None, val_every: int = 0, device=None,
        impl: str = "auto"):
    """Train loop over collated batches (numpy, as `instruction_batches`
    yields them; each is moved to `device`, None: CUDA). Logs
    `step N: loss=...` every `tcfg.log_every` steps (which reads the loss
    and so waits for the step). val_batches_fn (callable -> fresh batch
    iterable): every `val_every` steps and once after the last step, the
    token-weighted mean loss over the held-out set is logged.

    ckpt + save_every > 0: every `save_every` steps the full train state
    saves to the core.checkpoint.CheckpointManager `ckpt`; restore it with
    restore_state(ckpt, fresh_state) and skip `state.step` batches to
    resume a killed run exactly."""
    if mesh is not None:
        raise _not_ported("training on a mesh", 10)
    device = resolve_device(device)
    stage = lambda b: to_device(b, device)
    if prefetch:
        batches = prefetch_to_device(batches, size=prefetch, device=device)
        stage = lambda b: b    # already placed by the producer
    step_fn = make_train_step(cfg, tx, lora_cfg=lora_cfg,
                              ce_chunk=tcfg.ce_chunk,
                              grad_accum=tcfg.grad_accum,
                              remat=tcfg.remat_mode, impl=impl)
    eval_fn = None
    if val_batches_fn is not None:
        eval_fn = make_eval_step(cfg, lora_cfg=lora_cfg,
                                 ce_chunk=tcfg.ce_chunk, impl=impl)

    def run_val(step_no: int) -> float:
        tot = n = 0.0
        for vb in val_batches_fn():
            m = eval_fn(state.trainable, frozen, to_device(vb, device))
            w = float(m["valid"])
            tot += float(m["loss"]) * w
            n += w
        vl = tot / max(n, 1.0)
        log_fn(f"step {step_no}: val_loss={vl:.4f} "
               f"({int(n)} held-out tokens)")
        return vl

    step_no = start = state.step
    for i, batch in enumerate(batches):
        state, metrics = step_fn(state, frozen, stage(batch))
        step_no = start + i + 1
        if tcfg.log_every and i % tcfg.log_every == 0:
            log_fn(f"step {step_no}: loss={float(metrics['loss']):.4f}")
        if eval_fn is not None and val_every and step_no % val_every == 0:
            run_val(step_no)
        maybe_save(ckpt, save_every, step_no, state)
    if eval_fn is not None and not (val_every and step_no % val_every == 0):
        run_val(step_no)
    finish_saves(ckpt, save_every)
    return state
