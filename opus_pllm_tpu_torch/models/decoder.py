"""Decoder-only LLM, family "llama" (port of `opus_pllm_tpu/models/decoder.py`).

`init` (decoder.py:37), `init_cache` (:87, bf16/fp32 leaves only),
`_write_cache` (:171, scalar index), `_block` (:278), `forward` (:555),
`positions_and_rope` (:535), `head_logits` (:629), `embed_tokens` (:375)
and `positions_from_mask` (:644). RMSNorm, half-split RoPE, GQA and the
SiLU-gated MLP, no biases. The "qwen2" and "opt" families and quantized
KV caches are not ported yet and raise NotImplementedError.

KV cache: {"layers": [{"k", "v"}: (B, cap, Hkv, D)], "index": int,
"mask": (B, cap) bool}. `forward` writes the new keys and values into
the cache IN PLACE and advances `cache["index"]`; the returned cache is
the same object (the JAX version returns a new pytree).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..core.config import DecoderConfig
from . import layers
from .layers import (apply_rope, attention_xla, dense, embed, rms_norm,
                     rope_cos_sin, silu)


def _check_family(cfg: DecoderConfig) -> None:
    if cfg.family != "llama" or cfg.attention_bias or cfg.use_dynamic_ntk:
        raise NotImplementedError(
            f"decoder family {cfg.family!r} (attention_bias="
            f"{cfg.attention_bias}, use_dynamic_ntk={cfg.use_dynamic_ntk}) "
            "is not ported yet; only plain llama runs")


def init(cfg: DecoderConfig, *, generator: torch.Generator, device=None):
    """Random parameters drawn from `generator` (decoder.py:37-80 scheme)."""
    _check_family(cfg)
    dt = cfg.torch_dtype
    h, d = cfg.hidden_size, cfg.head_dim
    kw = dict(generator=generator, device=device, dtype=dt)
    norm = lambda: layers.norm_init(h, device=device, dtype=dt, bias=False)
    params: Dict[str, Any] = {
        "embed_tokens": layers.embed_init(cfg.vocab_size, h, **kw),
        "final_norm": norm(),
        "layers": [],
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = layers.dense_init(h, cfg.vocab_size, **kw)
    qdim, kvdim = cfg.num_heads * d, cfg.num_kv_heads * d
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "attn_norm": norm(),
            "q_proj": layers.dense_init(h, qdim, **kw),
            "k_proj": layers.dense_init(h, kvdim, **kw),
            "v_proj": layers.dense_init(h, kvdim, **kw),
            "o_proj": layers.dense_init(qdim, h, **kw),
            "ffn_norm": norm(),
            "gate_proj": layers.dense_init(h, cfg.intermediate_size, **kw),
            "up_proj": layers.dense_init(h, cfg.intermediate_size, **kw),
            "down_proj": layers.dense_init(cfg.intermediate_size, h, **kw),
        })
    return params


def init_cache(cfg: DecoderConfig, batch: int, max_len: int, dtype=None,
               *, device=None, quantize=False):
    """Zeroed KV cache with `max_len` slots per row."""
    if quantize:
        raise NotImplementedError("quantized KV caches are not ported yet")
    dtype = dtype or cfg.torch_dtype
    shp = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "layers": [{"k": torch.zeros(shp, dtype=dtype, device=device),
                    "v": torch.zeros(shp, dtype=dtype, device=device)}
                   for _ in range(cfg.num_layers)],
        "index": 0,
        "mask": torch.zeros((batch, max_len), dtype=torch.bool,
                            device=device),
    }


def _write_cache(layer_cache, k_new, v_new, index: int):
    """Write S new keys/values at slots [index, index + S) of every row,
    in place."""
    s = k_new.shape[1]
    layer_cache["k"][:, index:index + s] = k_new
    layer_cache["v"][:, index:index + s] = v_new
    return layer_cache


def _block(cfg: DecoderConfig, p, x, mask4, cos, sin, layer_cache, index):
    b, s, _ = x.shape
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    r = rms_norm(p["attn_norm"], x, eps=cfg.rms_norm_eps)
    q = dense(p["q_proj"], r).reshape(b, s, hq, d)
    k = dense(p["k_proj"], r).reshape(b, s, hkv, d)
    v = dense(p["v_proj"], r).reshape(b, s, hkv, d)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if layer_cache is not None:
        _write_cache(layer_cache, k, v, index)
        k, v = layer_cache["k"], layer_cache["v"]
    a = attention_xla(q, k, v, mask4).reshape(b, s, hq * d)
    x = x + dense(p["o_proj"], a)
    r = rms_norm(p["ffn_norm"], x, eps=cfg.rms_norm_eps)
    return x + dense(p["down_proj"],
                     silu(dense(p["gate_proj"], r)) * dense(p["up_proj"], r))


def embed_tokens(params, ids):
    return embed(params["embed_tokens"], ids)


def positions_and_rope(params, cfg: DecoderConfig, x, positions):
    """(x, cos, sin); cos/sin are cast to x's dtype before `apply_rope`,
    as at decoder.py:552."""
    cos, sin = rope_cos_sin(positions, cfg.head_dim, theta=cfg.rope_theta)
    return x, cos.to(x.dtype), sin.to(x.dtype)


def forward(params, cfg: DecoderConfig, input_embeds, positions, mask4,
            cache=None, *, return_hidden: bool = False
            ) -> Tuple[torch.Tensor, Optional[dict]]:
    """input_embeds (B, S, H); positions (B, S); mask4 (B, 1, S, Skv) bool
    (Skv = S without a cache, the cache capacity with one). With a cache,
    the new K/V land at slots [cache["index"], +S) in place and the index
    advances. Returns (logits (B, S, V) fp32 or final-normed hidden, cache).
    """
    _check_family(cfg)
    x, cos, sin = positions_and_rope(params, cfg, input_embeds, positions)
    index = cache["index"] if cache is not None else None
    for i, p in enumerate(params["layers"]):
        lc = cache["layers"][i] if cache is not None else None
        x = _block(cfg, p, x, mask4, cos, sin, lc, index)
    if cache is not None:
        cache["index"] = index + input_embeds.shape[1]
    x = rms_norm(params["final_norm"], x, eps=cfg.rms_norm_eps)
    if return_hidden:
        return x, cache
    return head_logits(params, cfg, x), cache


def head_logits(params, cfg: DecoderConfig, x):
    """Vocab projection of final-normed hidden states -> fp32 logits with
    fp32 accumulation and no rounding of the product to x's dtype. On CUDA
    a low-precision product writes fp32 directly (`out_dtype`); elsewhere
    it multiplies in fp32."""
    w = (params["embed_tokens"]["embedding"].t()
         if cfg.tie_word_embeddings or "lm_head" not in params
         else params["lm_head"]["kernel"])
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype != torch.float32:
        y = torch.mm(x2, w.to(x.dtype), out_dtype=torch.float32)
    else:
        y = x2.float() @ w.float()
    return y.reshape(*lead, -1)


def positions_from_mask(attn_mask):
    """Left-pad-aware positions: 0 at the first valid token."""
    pos = torch.cumsum(attn_mask.int(), dim=-1) - 1
    return pos.clamp_min(0).int()
