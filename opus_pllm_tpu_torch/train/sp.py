"""Sequence-parallel stage-(c/d) training (port of
`opus_pllm_tpu/train/sp.py`: `_local_ce` :45, `make_sp_train_step` :61,
`fit` :174): long-context training where the activations, not the
weights, outgrow a card.

The ranks of a ("seq",) mesh (`parallel.ring.make_sp_mesh`) each hold the
whole (frozen and trainable) model and the whole batch. A step on every
rank: the front (ESM2 -> CSTP -> switch splice) runs replicated, under
grad where the switch trains; the global next-token shift happens before
sharding (a shard's last target lives in the next shard), then the
stream pads to a multiple of the shard count; each rank runs the decoder
on its S / n rows with attention as ring attention (`impl="ring"`: K/V
shards rotate around the ring, and with grad on the reverse ring carries
their gradients home, parallel/ring.py) and the dynamic-NTK context
pinned to the global padded length; the chunked cross-entropy sums its
shard's pre-shifted targets. Each rank takes the gradient of its LOSS
SUM, whose cotangents reach the other ranks' K/V through the ring; the
gradients, the loss sum and the valid count are then summed over `seq`
in one flat all-reduce and divided by the global count: the gradient of
the mean over every valid token, as one process computes it. The
trainable tree and the AdamW moments stay replicated, and the clip takes
the norm of the whole reduced gradient, so every rank makes the same
update. Checkpoints come from rank 0 in the single process's format
(`multimodal_trainer.maybe_save`).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import IGNORE_INDEX, LoRAConfig, OpusConfig, TrainConfig
from ..lora import lora as lora_mod
from ..models import decoder, opus
from . import multimodal_trainer as mmt
from .optim import AdamW


def _local_ce(llm_params, llm_cfg, hid, tg, valid, chunk: int):
    """The cross-entropy's (sum, count) over a LOCAL shard with PRE-SHIFTED
    targets (`opus.next_token_loss_hidden`'s shift=False, reduce=False);
    chunk <= 0 runs as one chunk."""
    s = hid.shape[1]
    tg = torch.where(valid, tg, torch.full_like(tg, IGNORE_INDEX))
    return opus.next_token_loss_hidden(
        llm_params, llm_cfg, hid, tg, torch.ones_like(valid),
        chunk=chunk if 0 < chunk < s else s, shift=False, reduce=False)


def _local_sums(trainable, frozen, cfg: OpusConfig, batch, sp, ls: float,
                remat, ce_chunk: int, impl: str):
    """This rank's (loss sum, valid count) of one batch (sp.py:72-115)."""
    params = mmt._assemble(frozen, trainable)
    spl = opus.splice_prompt(params, cfg, batch["input_ids"],
                             batch["attn_mask"], batch.get("esm_tokens"),
                             batch["labels"], left_pad=False,
                             pooled_emb=batch.get("pooled_emb"), impl=impl)
    emb = spl.embeds.to(cfg.llm.torch_dtype)
    b, s, _ = emb.shape
    ignore = torch.full((b, 1), IGNORE_INDEX, dtype=spl.labels.dtype,
                        device=emb.device)
    tg = torch.cat([spl.labels[:, 1:], ignore], dim=1)
    valid = (tg != IGNORE_INDEX) & torch.cat(
        [spl.mask[:, 1:], torch.zeros_like(spl.mask[:, :1])], dim=1)
    kvm, pos = spl.mask, spl.positions
    s_pad = -(-s // sp.size) * sp.size
    if s_pad != s:
        pz = s_pad - s
        emb = torch.nn.functional.pad(emb, (0, 0, 0, pz))
        tg = torch.nn.functional.pad(tg, (0, pz), value=IGNORE_INDEX)
        valid = torch.nn.functional.pad(valid, (0, pz))
        kvm = torch.nn.functional.pad(kvm, (0, pz))
        pos = torch.nn.functional.pad(pos, (0, pz))
    s_loc = s_pad // sp.size
    sl = slice(sp.index * s_loc, (sp.index + 1) * s_loc)
    # ntk_ctx: the global padded length, not the shard's (the ring's mask
    # is the 2-D local one)
    hid, _ = decoder.forward(
        params["llm"], cfg.llm, emb[:, sl], pos[:, sl], kvm[:, sl],
        lora=trainable.get("lora"), lora_scale=ls, remat=remat,
        return_hidden=True, impl="ring", ntk_ctx=s_pad, sp=sp)
    return _local_ce(params["llm"], cfg.llm, hid, tg[:, sl], valid[:, sl],
                     ce_chunk)


def make_sp_train_step(cfg: OpusConfig, tx: AdamW, sp, *,
                       lora_cfg: Optional[LoRAConfig] = None,
                       ce_chunk: int = 0, remat=True, grad_accum: int = 1,
                       impl: str = "auto"):
    """step(state, frozen, batch) -> (state, metrics) over the ("seq",)
    mesh `sp`, every rank with the whole batch: multimodal_trainer's
    surface, the state updated in place. grad_accum > 1 splits the batch
    into chunks whose loss-sum gradients add before the one division by
    the global count, so the update equals the big-batch step."""
    ls = lora_mod.scaling(lora_cfg) if lora_cfg is not None else 1.0

    def train_step(state, frozen, batch):
        lv = mmt.leaves(state.trainable)
        n = batch["input_ids"].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} not divisible by "
                             f"grad_accum={grad_accum}")
        per = n // grad_accum
        gsum = None
        stats = torch.zeros((2,), dtype=torch.float32, device=lv[0].device)
        for i in range(grad_accum):
            chunk = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            tot, cnt = _local_sums(state.trainable, frozen, cfg, chunk, sp,
                                   ls, remat, ce_chunk, impl)
            grads = torch.autograd.grad(tot, lv, allow_unused=True,
                                        materialize_grads=True)
            if gsum is None:
                gsum = [g.float() for g in grads]
            else:
                for a, g in zip(gsum, grads):
                    a.add_(g.float())
            stats = stats + torch.stack([tot.detach(), cnt.float()])
        return mmt.apply_summed(state, tx, lv, gsum, stats, sp.group)

    return train_step


def fit(state, tx: AdamW, cfg: OpusConfig, tcfg: TrainConfig, frozen,
        batches, sp, *, lora_cfg: Optional[LoRAConfig] = None,
        log_fn=print, prefetch: int = 2, ckpt=None, save_every: int = 0,
        device=None, impl: str = "auto"):
    """multimodal_trainer.fit over the ("seq",) mesh `sp` (the CLI's
    --seq-shards): every rank takes the same (whole) batches; rank 0 logs;
    checkpoints as `multimodal_trainer.fit`'s."""
    step_fn = make_sp_train_step(cfg, tx, sp, lora_cfg=lora_cfg,
                                 ce_chunk=tcfg.ce_chunk,
                                 remat=tcfg.remat_mode,
                                 grad_accum=tcfg.grad_accum, impl=impl)
    return mmt.fit_steps(step_fn, state, frozen, batches, tcfg,
                         log_fn=log_fn, prefetch=prefetch, ckpt=ckpt,
                         save_every=save_every, device=device)
