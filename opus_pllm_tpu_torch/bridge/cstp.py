"""CSTP protein projection (port of `opus_pllm_tpu/bridge/cstp.py`).

`init` (cstp.py:24) and `protein_forward` (cstp.py:47): L2-normalise the
pooled ESM embedding, then one fp32 linear.
"""

from __future__ import annotations

import torch

from ..core.config import CSTPConfig
from ..core.util import resolve_device
from ..models.layers import dense, dense_init


def init(cfg: CSTPConfig, *, generator: torch.Generator, device=None):
    """Random fp32 projections on `device` (None: CUDA)."""
    kw = dict(generator=generator, device=resolve_device(device),
              dtype=torch.float32,
              bias=True)
    return {"protein_projection": dense_init(cfg.protein_dim, cfg.proj_dim,
                                             **kw),
            "text_projection": dense_init(cfg.text_dim, cfg.proj_dim, **kw)}


def _l2_normalize(x, eps: float = 1e-12):
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(n, min=eps)


def protein_forward(params, protein_emb):
    """(B, Dp) -> (B, P) fp32."""
    return dense(params["protein_projection"],
                 _l2_normalize(protein_emb.float()))
