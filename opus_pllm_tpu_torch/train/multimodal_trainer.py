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
thread (`utils.prefetch`, the JAX default 2).

`fit(mesh=)` (JAX :212-290, `shard_state` :197) trains on a (data, model)
mesh of ranks, one process a rank. The caller shards first, as in JAX:
`partition.shard_frozen` cuts the frozen tree (the LLM by projection role
over `model`, every leaf's data dim over `data`: FSDP) and `shard_state`
keeps each trainable leaf and its AdamW moments as this rank's share. A
step: the batch's rows split over the data ranks (B % D == 0); the
trainable shares are all-gathered over `data` once (the LLM's frozen
layers one at a time inside the decoder, again under remat's
recompute); each rank takes the gradient of its LOSS SUM, accumulated in
fp32 over `grad_accum` chunks; the partial sums of LoRA leaves used
against split projections are added over `model`, then every gradient
and the valid-token count over `data` in one all-reduce, and divided by
the GLOBAL count: the gradient of the mean over every valid token of the
global batch, as one process computes it. The clip takes the global norm
(optim.AdamW), AdamW steps the shares. Logs, held-out losses and
checkpoints hold global values; a checkpoint holds the single process's
full tree (`state_tree` gathers it, rank 0 writes, the others wait at a
barrier), so a mesh run resumes on one process and one process's
checkpoint on a mesh (`restore_state` on the full state, then
`shard_state`).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import torch.distributed as dist

from ..core import checkpoint
from ..core import mesh as mesh_mod
from ..core.config import IGNORE_INDEX, LoRAConfig, OpusConfig, TrainConfig
from ..core.util import resolve_device, to_device
from ..data.collate import count_positions
from ..lora import lora as lora_mod
from ..models import esm2, opus
from ..models.decoder import refuse_deepseek
from ..parallel import partition
from ..utils.observability import ranged, span
from ..utils.prefetch import prefetch_to_device
from .optim import AdamW, adamw

# leaves a profiler range of the per-leaf gradient loops covers (a few
# hundred host operations: within the reach of a trace's gap labels)
GRAD_LEAF_RUN = 32


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


def tree_from_leaves(like, xs):
    """`leaves`' inverse: the structure of `like` with the tensors `xs` in
    `leaves` order."""
    it = iter(xs)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


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


def _on_mesh() -> bool:
    return dist.is_initialized()


def _is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def full_trainable(state) -> dict:
    """The single process's trainable tree: on a mesh the ranks' shares
    gathered (every rank calls this and gets the whole tree), else the
    state's own."""
    layout = state.opt_state.layout
    if layout is None:
        return state.trainable
    full = partition.uncut_leaves(
        [x.detach() for x in leaves(state.trainable)], layout)
    return tree_from_leaves(state.trainable, full)


def _moments(sd: dict, fn) -> dict:
    """An AdamW state_dict() with fn(list of a moment's tensors in leaf
    order) applied to exp_avg and exp_avg_sq (a new dict)."""
    st = sd["opt"]["state"]
    if not st:
        return sd
    idx = sorted(st)
    new = {i: dict(st[i]) for i in idx}
    for key in ("exp_avg", "exp_avg_sq"):
        for i, x in zip(idx, fn([st[i][key] for i in idx])):
            new[i][key] = x
    return {**sd, "opt": {**sd["opt"], "state": new}}


def state_tree(state) -> dict:
    """The tree a checkpoint holds: the state's fields with the optimizer
    as its state_dict() ({"trainable", "opt_state", "step"} here,
    {"params", "opt_state", "step"} for the CSTP state), as the JAX
    state's `_asdict()`. On a mesh the shares of the leaves and moments
    are gathered into the single process's tree (every rank calls it)."""
    tree = {f.name: getattr(state, f.name) for f in fields(state)}
    tx = state.opt_state
    tree["opt_state"] = tx.state_dict()
    if tx.layout is not None:
        tree["trainable"] = full_trainable(state)
        tree["opt_state"] = _moments(
            tree["opt_state"],
            lambda xs: partition.uncut_leaves(xs, tx.layout))
    return tree


def maybe_save(ckpt, save_every: int, step_no: int, state) -> None:
    """Every `save_every` steps, the full state to `ckpt`. The manager
    copies the tensors to the host before it returns (the next step
    updates them in place); only the file write runs in the background.
    Under a process group every rank gathers, rank 0 saves and the others
    wait for its copy at a barrier."""
    if ckpt is not None and save_every and step_no % save_every == 0:
        tree = state_tree(state)
        if _is_rank0():
            ckpt.save(step_no, tree, wait=False)
        if _on_mesh():
            dist.barrier()


def finish_saves(ckpt, save_every: int) -> None:
    """Wait for the saves in flight before the fit loop returns (on a
    mesh: rank 0's writes, the others at a barrier)."""
    if ckpt is not None and save_every:
        if _is_rank0():
            ckpt.wait()
        if _on_mesh():
            dist.barrier()


def shard_state(mesh, state: MMTrainState, cfg: OpusConfig):
    """A single process's train state (fresh, or restored by
    `restore_state`) -> (this rank's state, its optimizer): each trainable
    leaf and its AdamW moments cut to the rank's share under `cfg.llm.tp`
    (the plan of the frozen share, `partition.shard_frozen`) and the
    specs' data dims (JAX `shard_state`, multimodal_trainer.py:197)."""
    tp = cfg.llm.tp
    local = dict(state.trainable)
    if "lora" in local:
        local["lora"] = partition.shard_lora(local["lora"], tp)
    layout = partition.TrainLayout(local, mesh, tp)
    xs = partition.cut_leaves(leaves(local), layout, model_cut=False)
    trainable = tree_from_leaves(
        local, [x.detach().requires_grad_(True) for x in xs])
    old = state.opt_state
    tx = old.over(leaves(trainable))
    tx.load_state_dict(_moments(old.state_dict(),
                                lambda xs: partition.cut_leaves(xs, layout)))
    tx.layout = layout
    return MMTrainState(trainable, tx, state.step), tx


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


def _mesh_params(trainable, frozen, cfg: OpusConfig, batch, impl: str):
    """The tree `loss_fn` runs on a mesh: every frozen leaf outside the
    LLM's layers gathered over the data ranks (the protein tower first, on
    its own and under no_grad: its pooled embedding goes on in the batch,
    and the gathered encoder dies here; the frozen switch is whole, and
    unused when the switch trains), the layers left as shares for the
    decoder's per-layer gather -> (params, batch)."""
    fs = cfg.llm.fsdp
    dims = fs.dims
    if batch.get("pooled_emb") is None:
        with torch.no_grad():
            esm = partition.gather_data(frozen["esm"], dims["esm"], fs.group)
            b, p, l = batch["esm_tokens"].shape
            pooled = esm2.pooled_embedding(
                esm, cfg.esm, batch["esm_tokens"].reshape(b * p, l),
                impl=impl)
            batch = dict(batch, pooled_emb=pooled.reshape(b, p, -1))
            del esm
    skip = {"esm", "llm"} | ({"switch"} if "switch" in trainable else set())
    rest = {k: v for k, v in frozen.items() if k not in skip}
    head = {k: v for k, v in frozen["llm"].items() if k != "layers"}
    got = partition.gather_data(
        {"rest": rest, "llm": head},
        {"rest": {k: dims[k] for k in rest},
         "llm": {k: dims["llm"][k] for k in head}}, fs.group)
    params = dict(got["rest"], llm=dict(got["llm"],
                                         layers=frozen["llm"]["layers"]))
    return params, batch


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
    update equals the one-big-batch step (multimodal_trainer.py:117-181):
    each chunk's gradient is that of its loss SUM, added in fp32 and
    divided once by the count. When `tx` steps a mesh's shares
    (`shard_state`) the chunks are this rank's rows, the trainable shares
    are gathered over `data` first, and before the division the partial
    sums of LoRA leaves used against split projections are added over
    `model`, then every gradient with the loss sum and the count over
    `data` in one all-reduce: the gradient of the mean over every valid
    token of the global batch, as one process computes it (module
    docstring).

    Spans (`utils.observability`, each on the device's clock too):
    `train.step` (`step` the state's step before it), in it
    `train.forward` and `train.backward` once a micro-chunk (the backward
    with the chunk's gradient added to the sum), then `train.optimizer`
    from the summed gradients to the end of `tx.zero_grad()`."""
    refuse_deepseek(cfg.llm, "training")
    ls = lora_mod.scaling(lora_cfg) if lora_cfg is not None else 1.0
    layout = tx.layout

    def train_step(state: MMTrainState, frozen, batch):
        shares = leaves(state.trainable)
        dev = shares[0].device
        with span("train.step", device=dev, step=state.step):
            tree = (state.trainable if layout is None
                    else _gathered_trainable(state.trainable, layout))
            lv = leaves(tree)
            n = batch["input_ids"].shape[0]
            if n % grad_accum:
                raise ValueError(f"batch {n} not divisible by "
                                 f"grad_accum={grad_accum}")
            per = n // grad_accum
            gsum = None
            stats = torch.zeros((2,), dtype=torch.float32, device=dev)
            for i in range(grad_accum):
                chunk = {k: v[i * per:(i + 1) * per]
                         for k, v in batch.items()}
                with span("train.forward", device=dev):
                    params = frozen
                    if layout is not None:
                        params, chunk = _mesh_params(tree, frozen, cfg,
                                                     chunk, impl)
                    loss, metrics = loss_fn(tree, params, cfg, chunk, ls,
                                            remat, ce_chunk, impl)
                    c = metrics["valid"].float()
                    # the gathered frozen leaves the backward does not
                    # need go now (the head keeps its own reference)
                    del params
                with span("train.backward", device=dev):
                    # d(mean)/dw * count = d(sum)/dw, normalized once below
                    grads = torch.autograd.grad(loss * c, lv,
                                                allow_unused=True,
                                                materialize_grads=True)
                    if gsum is None:
                        gsum = [g.float() for g in grads]
                    else:
                        for a, g in ranged(zip(gsum, grads),
                                           "train.grad_leaves",
                                           GRAD_LEAF_RUN):
                            a.add_(g.float())
                stats = stats + torch.stack([loss.detach() * c, c])
            with span("train.optimizer", device=dev):
                if layout is not None:
                    gsum, stats = _reduce_over_mesh(gsum, stats, layout)
                denom = stats[1].clamp_min(1.0)
                for i, (p, g) in ranged(enumerate(zip(shares, gsum)),
                                        "train.grad_leaves", GRAD_LEAF_RUN):
                    if layout is not None:
                        g = layout.data_share(g, i)
                    p.grad = (g / denom).to(p.dtype)
                tx.step()
                tx.zero_grad()
            state.step += 1
        return state, {"loss": stats[0] / denom, "valid": stats[1].int()}

    return train_step


def _gathered_trainable(trainable, layout):
    """The trainable shares gathered over the data ranks (one collective):
    this rank's model cut whole, as fresh leaves that take gradients."""
    xs = partition.uncut_leaves([x.detach() for x in leaves(trainable)],
                                layout, model=False)
    return tree_from_leaves(trainable,
                            [x.detach().requires_grad_(True) for x in xs])


def _flat_all_reduce(xs: List[torch.Tensor], group) -> List[torch.Tensor]:
    """fp32 tensors summed over `group` in one all-reduce."""
    if not xs:
        return xs
    flat = torch.cat([x.reshape(-1) for x in xs])
    dist.all_reduce(flat, group=group)
    out, o = [], 0
    for x in xs:
        out.append(flat[o:o + x.numel()].reshape(x.shape))
        o += x.numel()
    return out


def apply_summed(state, tx: AdamW, params, gsum, stats, group):
    """The step of the replicated trainers (train/sp.py, train/pp.py):
    each rank's loss-sum gradients `gsum` of `params` (fp32, zeros where
    the rank computed none) and its (loss sum, count) `stats` summed over
    `group` in one all-reduce and divided by the global count, then one
    AdamW step on every rank alike -> (state, metrics)."""
    *gsum, stats = _flat_all_reduce(gsum + [stats], group)
    denom = stats[1].clamp_min(1.0)
    for p, g in zip(params, gsum):
        p.grad = (g / denom).to(p.dtype)
    tx.step()
    tx.zero_grad()
    state.step += 1
    return state, {"loss": stats[0] / denom, "valid": stats[1].int()}


def fit_steps(step_fn, state, frozen, batches, tcfg: TrainConfig, *,
              log_fn=print, prefetch: int = 2, ckpt=None,
              save_every: int = 0, device=None):
    """The loop of the replicated trainers' `fit`: every rank takes the
    same batches (moved to `device`, on a thread with `prefetch`), rank 0
    logs `step N: loss=...` every `tcfg.log_every` steps, and the state
    saves to `ckpt` every `save_every` steps (`maybe_save`)."""
    device = resolve_device(device)
    if not _is_rank0():
        log_fn = lambda *_: None   # noqa: E731 — rank 0 logs
    stage = lambda b: to_device(b, device)   # noqa: E731
    if prefetch:
        batches = prefetch_to_device(batches, size=prefetch, device=device)
        stage = lambda b: b        # noqa: E731 — placed by the producer
    start = state.step
    for i, batch in enumerate(batches):
        state, metrics = step_fn(state, frozen, stage(batch))
        step_no = start + i + 1
        if tcfg.log_every and i % tcfg.log_every == 0:
            log_fn(f"step {step_no}: loss={float(metrics['loss']):.4f}")
        maybe_save(ckpt, save_every, step_no, state)
    finish_saves(ckpt, save_every)
    return state


def _reduce_over_mesh(gsum, stats, layout):
    """The loss-sum gradients of a rank's model cut and its (loss sum,
    count) -> the mesh's: the partial sums of the leaves the model ranks
    share added over `model`, then everything over `data`."""
    mesh = layout.mesh
    part = [i for i, lay in enumerate(layout.leaves) if lay.partial]
    if mesh.model > 1 and part:
        for i, g in zip(part, _flat_all_reduce([gsum[i] for i in part],
                                               mesh.model_group)):
            gsum[i] = g
    if mesh.data > 1:
        *gsum, stats = _flat_all_reduce(gsum + [stats], mesh.data_group)
    return gsum, stats


def make_eval_step(cfg: OpusConfig, *, lora_cfg: Optional[LoRAConfig] = None,
                   ce_chunk: int = 0, impl: str = "auto"):
    ls = lora_mod.scaling(lora_cfg) if lora_cfg is not None else 1.0

    @torch.no_grad()
    def eval_step(trainable, frozen, batch):
        if cfg.llm.fsdp is not None:
            frozen, batch = _mesh_params(trainable, frozen, cfg, batch, impl)
        _, metrics = loss_fn(trainable, frozen, cfg, batch, ls, False,
                             ce_chunk, impl)
        return metrics

    return eval_step


def _train_rows(mesh, batch):
    """This data rank's rows of a training batch (B % D == 0)."""
    n = batch["input_ids"].shape[0]
    if n % mesh.data:
        raise ValueError(f"batch {n} does not split over the mesh's data "
                         f"axis of {mesh.data}")
    return mesh_mod.shard_batch(mesh, batch)


def _val_rows(mesh, batch):
    """This data rank's rows of a held-out batch, which may not split
    evenly: a rank left without a row takes the first one with every
    label ignored (it adds no token to the global mean, and its forward
    keeps the data ranks' collectives in step)."""
    rows = mesh_mod.data_slice(mesh, batch["input_ids"].shape[0])
    if rows.stop > rows.start:
        return mesh_mod.shard_batch(mesh, batch)
    out = {k: v[:1] for k, v in batch.items()}
    out["labels"] = np.full_like(out["labels"], IGNORE_INDEX)
    return out


def _counted(batches, n_tokens: int):
    """`batches`, each counted (`collate.count_positions`) as it is taken:
    on the prefetch thread when there is one."""
    for b in batches:
        count_positions(b, n_tokens)
        yield b


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
    device = resolve_device(device)
    if mesh is not None:
        if tx.layout is None or cfg.llm.fsdp is None:
            raise ValueError("fit(mesh=) takes the rank's shares: "
                             "partition.shard_frozen(mesh, params, cfg) "
                             "and shard_state(mesh, state, cfg) first")
        batches = (_train_rows(mesh, b) for b in batches)
        if not _is_rank0():
            log_fn = lambda *_: None   # noqa: E731 — rank 0 logs
    batches = _counted(batches, cfg.switch.n_tokens)
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
        trainable = state.trainable
        if mesh is not None:
            trainable = _gathered_trainable(trainable, tx.layout)
        for vb in val_batches_fn():
            if mesh is not None:
                vb = _val_rows(mesh, vb)
            m = eval_fn(trainable, frozen, to_device(vb, device))
            w = float(m["valid"])
            tot += float(m["loss"]) * w
            n += w
        if mesh is not None and mesh.data > 1:
            t = torch.tensor([tot, n], dtype=torch.float64, device=device)
            dist.all_reduce(t, group=mesh.data_group)
            tot, n = t.tolist()
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
