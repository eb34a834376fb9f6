"""LoRA adapters as their own parameter tree (port of
`opus_pllm_tpu/lora/lora.py`: `_proj_dims` :29, `init` :46, `scaling` :67,
`merge` :77, `num_params` :94).

The tree mirrors the decoder's layer list: {"layers": [{proj: {"A": (in,
r), "B": (r, out)}}]}, fp32. A is drawn kaiming-uniform in U(-1/sqrt(in),
1/sqrt(in)) and B is zero, so an adapter is an exact no-op at step 0 (the
PEFT convention); the delta is scaling * (x A) B with scaling = alpha /
rank (`models.layers.lora_delta`). The serving bank functions
(`make_bank`, `stack_adapter`, `fold_scaling`) come with the engine's LoRA
bank (ROADMAP).
"""

from __future__ import annotations

import math
from typing import Dict

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
