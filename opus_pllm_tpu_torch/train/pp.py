"""Pipeline-parallel stage-(c/d) training, GPipe written as a schedule
(port of `opus_pllm_tpu/train/pp.py`: `_split_llm` :49, `shard_frozen`
:64, `_apply_block` :81, `make_pp_train_step` :103, `fit` :251).

The decoder's layers split into P contiguous blocks, one a stage of a
(data, pipe) mesh (`parallel.pipeline.make_pp_mesh`); each stage holds
only its block on the card (`shard_frozen`), besides the embedding, the
final norm and the head, which the front and the loss need. A step on
each rank of replica d takes that replica's rows of the batch (B / D)
and splits them into M microbatches:

  * front: the splice (ESM2 -> CSTP -> switch) runs on every rank, since
    every stage needs the mask and positions and the last the labels;
    only stage 0's carries grad (when the switch trains);
  * forward: for each microbatch in turn, stage s receives its input from
    stage s - 1 (stage 0 takes its rows of the front), runs its L / P
    layers with its slice of the LoRA tree under the per-layer remat, and
    sends the output to stage s + 1;
  * loss: the last stage runs the final norm, the head and the chunked
    cross-entropy over the replica's rows -> the loss SUM and the valid
    count;
  * backward: the microbatches in reverse; each stage receives the
    gradient of its output (the last stage takes it from the loss),
    backpropagates through its layers into its LoRA leaves and its input,
    and sends the input's gradient to stage s - 1; stage 0 then carries
    the gradients of its inputs through the front into the switch.

Each rank's gradient is its stage's LoRA leaves (zeros for the other
stages'), the switch's on stage 0 (zeros elsewhere), and the loss sum and
count on the last stage; ONE all-reduce over the world adds them, which
gives every rank the whole tree JAX reassembles (its LoRA slices summed
over `data`, the switch over `pipe` and `data`), divided by the global
count. The trainable tree and AdamW stay replicated, so the clip and the
update match JAX's on the full tree. During the fill and drain (bubble
fraction (P - 1) / (M + P - 1)) a stage waits, where JAX's SPMD ticks run
every stage on placeholder data; the gradient is the same.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.config import LoRAConfig, OpusConfig, TrainConfig
from ..lora import lora as lora_mod
from ..models import decoder, opus
from ..models.layers import causal_mask
from ..parallel import pipeline
from . import multimodal_trainer as mmt
from .optim import AdamW


def shard_frozen(mesh, frozen, cfg: OpusConfig):
    """The frozen tree of this rank's stage: the decoder's layers cut to
    the stage's block (a tree already cut to it, as the CLI loads one,
    stays as it is); everything else as it is. Layers that do not divide
    by the stages are a ValueError."""
    rng = mesh.layer_range(cfg.llm.num_layers)
    layers = frozen["llm"]["layers"]
    if len(layers) == cfg.llm.num_layers:
        layers = layers[rng.start:rng.stop]
    elif len(layers) != len(rng):
        raise ValueError(f"the frozen tree holds {len(layers)} layers: "
                         f"neither all {cfg.llm.num_layers} nor stage "
                         f"{mesh.stage}'s {len(rng)}")
    return dict(frozen, llm=dict(frozen["llm"], layers=list(layers)))


def _apply_block(cfg, layers, lora_layers, x, mask4, cos, sin, ls: float,
                 impl: str, remat):
    """One stage's layer block (each layer under remat with grad on)."""
    block = decoder._block
    if torch.is_grad_enabled():
        block = decoder._remat_wrap(block, remat)
    for j, p in enumerate(layers):
        la = lora_layers[j] if lora_layers is not None else None
        x = block(cfg, p, x, mask4, cos, sin, None, None, impl, la, ls,
                  None, None)
    return x


def _replica_rows(mesh, batch):
    """This replica's contiguous rows of the (global) batch."""
    n = batch["input_ids"].shape[0]
    if n % mesh.data:
        raise ValueError(f"batch {n} does not split over {mesh.data} "
                         f"pipeline replicas")
    per = n // mesh.data
    rows = slice(mesh.replica * per, (mesh.replica + 1) * per)
    return {k: v[rows] for k, v in batch.items()}


def _schedule(state, frozen, cfg: OpusConfig, batch, mesh, n_micro: int,
              ls: float, ce_chunk: int, remat, impl: str):
    """One GPipe schedule over one chunk of this replica's rows: the
    gradients of the loss sum accumulate into the `.grad` of this stage's
    leaves -> (loss sum, valid count), zeros off the last stage."""
    tr = state.trainable
    lora_layers = None
    if "lora" in tr:
        rng = mesh.layer_range(cfg.llm.num_layers)
        lora_layers = tr["lora"]["layers"][rng.start:rng.stop]
    front_grad = mesh.first and "switch" in tr
    params = mmt._assemble(frozen, tr)
    with torch.set_grad_enabled(front_grad):
        spl = opus.splice_prompt(params, cfg, batch["input_ids"],
                                 batch["attn_mask"], batch.get("esm_tokens"),
                                 batch["labels"], left_pad=False,
                                 pooled_emb=batch.get("pooled_emb"),
                                 impl=impl)
        emb = spl.embeds.to(cfg.llm.torch_dtype)
        bsz, s, h = emb.shape
        if bsz % n_micro:
            raise ValueError(f"per-replica batch {bsz} not divisible by "
                             f"n_micro={n_micro}")
        x, cos, sin = decoder.positions_and_rope(params["llm"], cfg.llm, emb,
                                                 spl.positions, ctx=s)
    mask4 = causal_mask(spl.mask)
    b_mb = bsz // n_micro
    shape, dtype, dev = (b_mb, s, h), x.dtype, x.device
    layers = frozen["llm"]["layers"]
    ins, outs = [], []
    for j in range(n_micro):                           # forward
        rows = slice(j * b_mb, (j + 1) * b_mb)
        if mesh.first:
            xin = x[rows].detach()
        else:
            xin = pipeline.recv(shape, dtype, dev, mesh, mesh.stage - 1)
        xin.requires_grad_(not mesh.first or front_grad)
        out = _apply_block(cfg.llm, layers, lora_layers, xin, mask4[rows],
                           cos[rows] if cos is not None else None,
                           sin[rows] if sin is not None else None, ls, impl,
                           remat)
        if not mesh.last:
            pipeline.send(out.detach(), mesh, mesh.stage + 1)
        ins.append(xin)
        outs.append(out)
    stats = torch.zeros((2,), dtype=torch.float32, device=dev)
    if mesh.last:
        hid = decoder._final_norm(params["llm"], cfg.llm, torch.cat(outs))
        tot, cnt = opus.next_token_loss_hidden(
            params["llm"], cfg.llm, hid, spl.labels, spl.mask,
            chunk=ce_chunk if 0 < ce_chunk < s else s, reduce=False)
        douts = torch.autograd.grad(tot, outs)
        stats = torch.stack([tot.detach(), cnt.float()])
    leaves = mmt.leaves(lora_layers) if lora_layers else []
    for j in reversed(range(n_micro)):                 # backward
        if mesh.last:
            g = douts[j]
        else:
            g = pipeline.recv(shape, dtype, dev, mesh, mesh.stage + 1)
        inputs = leaves + ([ins[j]] if ins[j].requires_grad else [])
        if inputs:
            torch.autograd.backward(outs[j], g, inputs=inputs)
        outs[j] = None
        if not mesh.first:
            pipeline.send(ins[j].grad, mesh, mesh.stage - 1)
    if front_grad:
        torch.autograd.backward(x, torch.cat([i.grad for i in ins]),
                                inputs=mmt.leaves(tr["switch"]))
    return stats


def make_pp_train_step(cfg: OpusConfig, tx: AdamW, mesh, *,
                       lora_cfg: Optional[LoRAConfig] = None,
                       ce_chunk: int = 0, n_micro: Optional[int] = None,
                       remat=True, impl: str = "auto", grad_accum: int = 1):
    """step(state, frozen, batch) -> (state, metrics) over the pipeline
    mesh `mesh`: `frozen` this stage's tree (`shard_frozen`), `batch` the
    global batch (each replica takes its rows); multimodal_trainer's
    surface, the state updated in place. n_micro: the microbatches a
    replica's rows split into (default: the stage count); grad_accum > 1
    runs one schedule a chunk of the rows, their loss-sum gradients added
    before the one division by the global count (n_micro must divide the
    chunk)."""
    ls = lora_mod.scaling(lora_cfg) if lora_cfg is not None else 1.0
    m = n_micro or mesh.stages
    mesh.layer_range(cfg.llm.num_layers)               # raises if uneven

    def train_step(state, frozen, batch):
        lv = mmt.leaves(state.trainable)
        for p in lv:
            p.grad = None
        rows = _replica_rows(mesh, batch)
        n = rows["input_ids"].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} not divisible by "
                             f"grad_accum={grad_accum}")
        per = n // grad_accum
        stats = torch.zeros((2,), dtype=torch.float32, device=lv[0].device)
        for i in range(grad_accum):
            chunk = {k: v[i * per:(i + 1) * per] for k, v in rows.items()}
            stats = stats + _schedule(state, frozen, cfg, chunk, mesh, m, ls,
                                      ce_chunk, remat, impl)
        gsum = [p.grad.float() if p.grad is not None
                else torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in lv]
        return mmt.apply_summed(state, tx, lv, gsum, stats, mesh.group)

    return train_step


def fit(state, tx: AdamW, cfg: OpusConfig, tcfg: TrainConfig, frozen,
        batches, mesh, *, lora_cfg: Optional[LoRAConfig] = None,
        n_micro: Optional[int] = None, log_fn=print, prefetch: int = 2,
        ckpt=None, save_every: int = 0, device=None, impl: str = "auto"):
    """multimodal_trainer.fit over the pipeline mesh (the CLI's
    --pipe-stages / --micro-batches / --pipe-data): every rank takes the
    same global batches; `frozen` is cut to this stage first
    (`shard_frozen`); rank 0 logs; checkpoints as multimodal_trainer's."""
    step_fn = make_pp_train_step(cfg, tx, mesh, lora_cfg=lora_cfg,
                                 ce_chunk=tcfg.ce_chunk, n_micro=n_micro,
                                 remat=tcfg.remat_mode, impl=impl,
                                 grad_accum=tcfg.grad_accum)
    return mmt.fit_steps(step_fn, state, shard_frozen(mesh, frozen, cfg),
                         batches, tcfg, log_fn=log_fn, prefetch=prefetch,
                         ckpt=ckpt, save_every=save_every, device=device)
