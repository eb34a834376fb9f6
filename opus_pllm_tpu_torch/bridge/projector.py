"""Switch projector (port of `opus_pllm_tpu/bridge/projector.py`).

`init` (projector.py:18) and `apply` (projector.py:29): Linear(input ->
hidden*n_tokens) [+ (depth-1) x (GELU, Linear)] in fp32, reshaped to
(B, n_tokens, hidden).
"""

from __future__ import annotations

import torch

from ..core.config import SwitchProjectorConfig
from ..models.layers import dense, dense_init, gelu


def init(cfg: SwitchProjectorConfig, *, generator: torch.Generator,
         device=None):
    kw = dict(generator=generator, device=device, dtype=torch.float32,
              bias=True)
    layers = [dense_init(cfg.input_dim, cfg.output_dim, **kw)]
    for _ in range(1, cfg.mlp_depth):
        layers.append(dense_init(cfg.output_dim, cfg.output_dim, **kw))
    return {"layers": layers}


def apply(params, cfg: SwitchProjectorConfig, x, out_dtype=None):
    """(B, input_dim) -> (B, n_tokens, llm_hidden); compute in fp32."""
    h = dense(params["layers"][0], x.float())
    for p in params["layers"][1:]:
        h = dense(p, gelu(h))
    h = h.reshape(h.shape[0], cfg.n_tokens, cfg.llm_hidden_size)
    return h.to(out_dtype) if out_dtype is not None else h
