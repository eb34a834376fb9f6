"""LoRA adapters as their own parameter tree (port of
`opus_pllm_tpu/lora/lora.py`: `_proj_dims` :29, `init` :46, `scaling` :67,
`merge` :77, `num_params` :94, and the serving bank's `tree_from_flat`
:98, `fold_scaling` :109, `stack_adapter` :120 and `make_bank` :143).

The tree mirrors the decoder's layer list: {"layers": [{proj: {"A": (in,
r), "B": (r, out)}}]}, fp32. A is drawn kaiming-uniform in U(-1/sqrt(in),
1/sqrt(in)) and B is zero, so an adapter is an exact no-op at step 0 (the
PEFT convention); the delta is scaling * (x A) B with scaling = alpha /
rank (`models.layers.lora_delta`).

The multi-LoRA serving bank (`make_bank`) stacks adapters per projection
into {proj: {"A": (layers, C+1, in, r), "B": (layers, C+1, r, out)}}: the
named adapters, then zero rows an engine can fill at runtime, then the
all-zero adapter last, which base-only requests gather.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.config import DecoderConfig, LoRAConfig
from ..core.util import resolve_device


def _proj_dims(cfg: DecoderConfig) -> Dict[str, tuple]:
    h, d = cfg.hidden_size, cfg.head_dim
    q, kv = cfg.num_heads * d, cfg.num_kv_heads * d
    dims = {"q_proj": (h, q), "k_proj": (h, kv), "v_proj": (h, kv),
            "o_proj": (q, h)}
    if cfg.family == "opt":
        dims.update({"fc1": (h, cfg.intermediate_size),
                     "fc2": (cfg.intermediate_size, h)})
    else:
        dims.update({"gate_proj": (h, cfg.intermediate_size),
                     "up_proj": (h, cfg.intermediate_size),
                     "down_proj": (cfg.intermediate_size, h)})
    return dims


def init(cfg: DecoderConfig, lora_cfg: LoRAConfig, *,
         generator: torch.Generator, device=None):
    """Adapter tree for every layer and target projection, fp32, drawn from
    `generator` on `device` (None: CUDA)."""
    device = resolve_device(device)
    dims = _proj_dims(cfg)
    targets = [t for t in lora_cfg.target_modules if t in dims]
    layers = []
    for _ in range(cfg.num_layers):
        lp = {}
        for t in targets:
            din, dout = dims[t]
            bound = 1.0 / math.sqrt(din)
            a = torch.empty((din, lora_cfg.rank), dtype=torch.float32,
                            device=device)
            a.uniform_(-bound, bound, generator=generator)
            lp[t] = {"A": a,
                     "B": torch.zeros((lora_cfg.rank, dout),
                                      dtype=torch.float32, device=device)}
        layers.append(lp)
    return {"layers": layers}


def scaling(lora_cfg: LoRAConfig) -> float:
    return lora_cfg.alpha / lora_cfg.rank


def merge(params, lora_tree, lora_cfg: LoRAConfig):
    """Fold the adapters into bf16/fp32 base kernels: W += scaling * A @ B
    in fp32, rounded once to W's dtype (PEFT merge_and_unload). Returns a
    new tree; the inputs are not changed."""
    s = scaling(lora_cfg)
    out = dict(params)
    out["layers"] = [dict(lp) for lp in params["layers"]]
    for i, lp in enumerate(lora_tree["layers"]):
        for t, ab in lp.items():
            base = out["layers"][i][t]["kernel"]
            delta = (ab["A"].float() @ ab["B"].float()) * s
            out["layers"][i][t] = dict(out["layers"][i][t],
                                       kernel=(base.float() + delta).to(
                                           base.dtype))
    return out


def num_params(lora_tree) -> int:
    return sum(ab[k].numel() for lp in lora_tree["layers"]
               for ab in lp.values() for k in ("A", "B"))


def tree_from_flat(flat: Dict[Any, Dict[str, Any]], num_layers: int,
                   dtype=torch.float32, device=None) -> dict:
    """{(layer, proj): {A, B}} (a PEFT adapter read per projection) -> the
    {"layers": [...]} adapter tree the forward takes, on `device` (None:
    CUDA)."""
    device = resolve_device(device)
    layers: list = [{} for _ in range(num_layers)]
    for (li, proj), ab in flat.items():
        layers[li][proj] = {
            k: (ab[k] if isinstance(ab[k], torch.Tensor)
                else torch.from_numpy(np.array(ab[k]))).to(device=device,
                                                           dtype=dtype)
            for k in ("A", "B")}
    return {"layers": layers}


def fold_scaling(tree: dict, s: float) -> dict:
    """Fold a per-adapter scaling into B (B' = s B, the delta unchanged),
    so adapters trained at different alpha / rank serve from one bank
    under the engine's single lora_scale = 1."""
    return {"layers": [{t: {"A": ab["A"], "B": ab["B"] * s}
                        for t, ab in lp.items()} for lp in tree["layers"]]}


def stack_adapter(name: str, t: dict) -> dict:
    """One adapter tree -> {proj: {"A": (layers, in, r), "B": (layers, r,
    out)}}. Every layer must target the same projections at the same rank
    (they stack into one gatherable tensor); the error names the adapter
    and the first layer that differs."""
    first = t["layers"][0]
    for li, lp in enumerate(t["layers"]):
        if (set(lp) != set(first)
                or any(tuple(lp[p]["A"].shape) != tuple(first[p]["A"].shape)
                       for p in lp)):
            raise ValueError(
                f"adapter {name!r} layer {li} targets {sorted(lp)} at "
                f"{[tuple(lp[p]['A'].shape) for p in sorted(lp)]}, layer 0 "
                f"has {sorted(first)}: the bank needs every layer to "
                "target the same projections at the same rank")
    return {p: {k: torch.stack([lp[p][k] for lp in t["layers"]])
                for k in ("A", "B")} for p in first}


def _shapes(stack: dict) -> list:
    return [(p, k, tuple(stack[p][k].shape))
            for p in sorted(stack) for k in ("A", "B")]


def make_bank(adapters: Dict[str, dict], capacity: Optional[int] = None):
    """Stack named adapter trees into a multi-LoRA serving bank.

    Returns ({proj: {"A": (layers, C+1, in, r), "B": (layers, C+1, r,
    out)}}, {name: row}) with C = max(capacity, len(adapters)): rows past
    the named adapters are zero free rows (`ServingEngine.add_adapter`
    fills them in place), and row C, the last, is the all-zero adapter of
    base-only requests. All adapters must target the same projections at
    the same rank."""
    if not adapters:
        raise ValueError("empty adapter bank")
    names = list(adapters)
    stacks = [stack_adapter(n, t) for n, t in adapters.items()]
    ref = _shapes(stacks[0])
    for name, st in zip(names[1:], stacks[1:]):
        if _shapes(st) != ref:
            raise ValueError(
                f"adapter {name!r} targets different projections or rank "
                f"than {names[0]!r}; a bank needs a uniform shape to stack")
    cap = max(capacity or 0, len(names))

    def rows(p, k):
        x = [st[p][k] for st in stacks]
        zero = torch.zeros_like(x[0])
        return torch.stack(x + [zero] * (cap - len(names) + 1), dim=1)

    bank = {p: {k: rows(p, k) for k in ("A", "B")} for p in stacks[0]}
    return bank, {n: i for i, n in enumerate(names)}
