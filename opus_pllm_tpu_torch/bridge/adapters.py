"""Alternative CSTP adapter architectures (port of
`opus_pllm_tpu/bridge/adapters.py`, the whole module).

The reference defines, and leaves out of its active path, a family of
richer adapters: a multi-head cross attention over POOLED vectors (each
(B, D) embedding splits into `num_heads` chunks that attend across the head
slots of the key vector) in a stack of encoder layers, a residual text
projection with ratio alpha, and a ReLU + dropout protein adapter.

`cross_attention_init` / `cross_attention` (adapters.py:27, :35),
`encoder_layer_init` / `encoder_layer` (:50, :58), `adapter_stack_init` /
`adapter_stack` (:64, :69), `residual_text_projection_init` /
`residual_text_projection` (:77, :83), `relu_adapter_init` /
`relu_adapter` (:91, :95). Parameters are fp32 and drawn from an explicit
`torch.Generator`; dropout takes a `torch.Generator` where the JAX
function takes `rng` (None: no dropout).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.util import resolve_device
from ..models.layers import dense, dense_init, layer_norm, norm_init


def _kw(generator, device):
    return dict(generator=generator, device=resolve_device(device),
                dtype=torch.float32)


# --- multi-head cross attention over pooled vectors -------------------------

def cross_attention_init(d_model: int, *, generator: torch.Generator,
                         device=None):
    kw = _kw(generator, device)
    return {n: dense_init(d_model, d_model, bias=True, **kw)
            for n in ("w_q", "w_k", "w_v", "fc")}


def cross_attention(params, q_vec, k_vec, v_vec, num_heads: int):
    """(B, D) vectors; each head attends over the head axis of the key
    vector."""
    b, d = q_vec.shape
    dk = d // num_heads
    q = dense(params["w_q"], q_vec).reshape(b, num_heads, dk)
    k = dense(params["w_k"], k_vec).reshape(b, num_heads, dk)
    v = dense(params["w_v"], v_vec).reshape(b, num_heads, dk)
    scores = torch.einsum("bhd,bgd->bhg", q, k) / math.sqrt(float(dk))
    attn = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhg,bgd->bhd", attn, v).reshape(b, d)
    return dense(params["fc"], out)


# --- encoder layer + stack ---------------------------------------------------

def encoder_layer_init(d_model: int, *, generator: torch.Generator,
                       device=None):
    kw = _kw(generator, device)
    norm = lambda: norm_init(d_model, device=kw["device"],
                             dtype=torch.float32, bias=True)
    return {"mha": cross_attention_init(d_model, generator=generator,
                                        device=device),
            "norm1": norm(), "norm2": norm(),
            "ff": dense_init(d_model, d_model, bias=True, **kw)}


def encoder_layer(params, seq_vec, text_vec, num_heads: int):
    a = cross_attention(params["mha"], seq_vec, text_vec, text_vec,
                        num_heads)
    out1 = layer_norm(params["norm1"], seq_vec + a)
    return layer_norm(params["norm2"], out1 + dense(params["ff"], out1))


def adapter_stack_init(d_model: int, n_layers: int = 3, *,
                       generator: torch.Generator, device=None):
    return {"layers": [encoder_layer_init(d_model, generator=generator,
                                          device=device)
                       for _ in range(n_layers)]}


def adapter_stack(params, seq_vec, text_vec, num_heads: int = 4):
    for p in params["layers"]:
        seq_vec = encoder_layer(p, seq_vec, text_vec, num_heads)
    return seq_vec


# --- residual text projection (ratio alpha) ---------------------------------

def residual_text_projection_init(feature_dim: int, intermediate_dim: int, *,
                                  generator: torch.Generator, device=None):
    kw = _kw(generator, device)
    return {"linear1": dense_init(feature_dim, intermediate_dim, bias=True,
                                  **kw),
            "linear2": dense_init(intermediate_dim, feature_dim, bias=True,
                                  **kw)}


def residual_text_projection(params, f, alpha: float = 0.8):
    """f' = alpha * W2 relu(W1 f) + (1 - alpha) * f."""
    av = dense(params["linear2"], torch.relu(dense(params["linear1"], f)))
    return alpha * av + (1.0 - alpha) * f


# --- relu + dropout protein adapter -----------------------------------------

def relu_adapter_init(input_dim: int, output_dim: int, *,
                      generator: torch.Generator, device=None):
    return {"linear": dense_init(input_dim, output_dim, bias=True,
                                 **_kw(generator, device))}


def relu_adapter(params, x, *, dropout_rate: float = 0.1,
                 generator: Optional[torch.Generator] = None):
    """relu(linear x), then inverted dropout: each entry kept with
    probability 1 - dropout_rate (a draw from `generator`) and scaled by
    1 / (1 - dropout_rate). No generator: no dropout."""
    x = torch.relu(dense(params["linear"], x))
    if generator is not None and dropout_rate > 0:
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < 1.0 - dropout_rate
        x = torch.where(keep, x / (1.0 - dropout_rate), torch.zeros_like(x))
    return x
