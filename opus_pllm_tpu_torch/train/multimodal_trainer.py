"""Stages (c) and (d): projector training and LoRA instruction tuning (port
of `opus_pllm_tpu/train/multimodal_trainer.py`: `MMTrainState` :32,
`init_trainable` :38, `create_state` :55, `loss_fn` :86,
`make_train_step` :117, `make_eval_step` :184, `fit` :212).

The trainable leaves live in their own tree ({"switch": ...} and/or
{"lora": ...}, fp32, `requires_grad`); the frozen ESM / CSTP / LLM tree
takes no gradient. One step: `loss_fn` (next-token cross-entropy over the
right-padded spliced stream), `torch.autograd.grad` of the trainable
leaves, then the optimizer of `train.optim.adamw`. Unlike the JAX step,
which returns a new state, the port updates the state's tensors in place
and returns the same state object.

Not ported yet, and refused with NotImplementedError: checkpointing
(`ckpt`, `save_every`, `restore_state`: ROADMAP.md §1 item 2), the mesh
(§1 item 9) and the prefetch thread (§1 item 8).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from ..core.config import IGNORE_INDEX, LoRAConfig, OpusConfig, TrainConfig
from ..core.util import resolve_device
from ..lora import lora as lora_mod
from ..models import opus
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


def restore_state(ckpt, like: MMTrainState, step: Optional[int] = None):
    raise _not_ported("restoring a train state from a checkpoint", 2)


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


def place(batch, device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch -> tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def fit(state: MMTrainState, tx: AdamW, cfg: OpusConfig, tcfg: TrainConfig,
        frozen, batches, *, lora_cfg: Optional[LoRAConfig] = None, mesh=None,
        log_fn=print, prefetch: int = 0, ckpt=None, save_every: int = 0,
        val_batches_fn=None, val_every: int = 0, device=None,
        impl: str = "auto"):
    """Train loop over collated batches (numpy, as `instruction_batches`
    yields them; each is moved to `device`, None: CUDA). Logs
    `step N: loss=...` every `tcfg.log_every` steps (which reads the loss
    and so waits for the step). val_batches_fn (callable -> fresh batch
    iterable): every `val_every` steps and once after the last step, the
    token-weighted mean loss over the held-out set is logged."""
    if mesh is not None:
        raise _not_ported("training on a mesh", 9)
    if prefetch:
        raise _not_ported("the prefetch thread", 8)
    if ckpt is not None or save_every:
        raise _not_ported("checkpointing a train state", 2)
    device = resolve_device(device)
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
            m = eval_fn(state.trainable, frozen, place(vb, device))
            w = float(m["valid"])
            tot += float(m["loss"]) * w
            n += w
        vl = tot / max(n, 1.0)
        log_fn(f"step {step_no}: val_loss={vl:.4f} "
               f"({int(n)} held-out tokens)")
        return vl

    step_no = start = state.step
    for i, batch in enumerate(batches):
        state, metrics = step_fn(state, frozen, place(batch, device))
        step_no = start + i + 1
        if tcfg.log_every and i % tcfg.log_every == 0:
            log_fn(f"step {step_no}: loss={float(metrics['loss']):.4f}")
        if eval_fn is not None and val_every and step_no % val_every == 0:
            run_val(step_no)
    if eval_fn is not None and not (val_every and step_no % val_every == 0):
        run_val(step_no)
    return state
