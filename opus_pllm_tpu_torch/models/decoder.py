"""Decoder-only LLM, family "llama" (port of `opus_pllm_tpu/models/decoder.py`).

`init` (decoder.py:37), `init_cache` (:87), the quantized-cache helpers
`_quantize_kv` (:131), `_quantize_kv4` (:141), `_unpack_kv4` (:155),
`_dequantize_kv` (:163), `_write_cache` (:171), `_read_cache` (:217),
`_block` (:278, with LoRA adapters), `_remat_wrap` (:457), `forward`
(:555, with `lora=`, `lora_scale=` and `remat=`), `positions_and_rope` (:535),
`head_logits` (:629), `embed_tokens` (:375) and `positions_from_mask`
(:644). RMSNorm, half-split RoPE, GQA and the SiLU-gated MLP, no biases.
Projections may be bf16 ("kernel"), int8 ("kernel_q", see
kernels/quant.py) or int4 v2 ("kernel_p", see kernels/quant4.py). The
"qwen2" and "opt" families raise NotImplementedError.

KV cache: {"layers": [{"k", "v"}], "index", "mask": (B, cap) bool}. The
index is an int (every row writes at the same slots) or a (B,) integer
tensor (each row at its own slot: the serving engine).
A bf16 leaf is (B, cap, Hkv, D). A quantized leaf is head-major:
{"q": (B, Hkv, cap, D) int8, "s": (B, Hkv, cap, 1) fp32} (int8) or
{"q4": (B, Hkv, cap, D/2) int8, "s": ...} (int4, low nibble d, high nibble
d + D/2), with one absmax scale per (token, head). `forward` writes the new
keys and values into the cache IN PLACE and advances `cache["index"]`; the
returned cache is the same object (the JAX version returns a new pytree).

`impl`: "auto" (or "fused") takes the kernels where the shapes allow them
(flash attention for prefills, decode attention over a quantized cache,
int8 and int4 projections); the kernel wrappers run their plain versions
on CPU tensors. "torch" takes the plain versions on every device.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import create_selective_checkpoint_contexts

from ..core.config import DecoderConfig
from ..core.util import mm_fp32, resolve_device
from ..kernels import decode_attention as da
from . import layers
from .layers import (apply_rope, attention, dense, embed, lora_dense,
                     rms_norm, rope_cos_sin, silu)


def _check_family(cfg: DecoderConfig) -> None:
    if cfg.family != "llama" or cfg.attention_bias or cfg.use_dynamic_ntk:
        raise NotImplementedError(
            f"decoder family {cfg.family!r} (attention_bias="
            f"{cfg.attention_bias}, use_dynamic_ntk={cfg.use_dynamic_ntk}) "
            "is not ported yet; only plain llama runs")


def init(cfg: DecoderConfig, *, generator: torch.Generator, device=None):
    """Random parameters drawn from `generator` (decoder.py:37-80 scheme) on
    `device` (None: CUDA)."""
    _check_family(cfg)
    device = resolve_device(device)
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
    """Zeroed KV cache with `max_len` slots per row. quantize=True/"int8"
    stores int8 K/V, "int4" packed int4, each with per-(token, head) fp32
    scales, head-major (decoder.py:87-128), on `device` (None: CUDA)."""
    device = resolve_device(device)
    if quantize is True:
        quantize = "int8"
    if quantize not in (False, "int8", "int4"):
        raise ValueError(f"quantize must be False/True/'int8'/'int4', "
                         f"got {quantize!r}")
    dtype = dtype or cfg.torch_dtype
    hkv, d = cfg.num_kv_heads, cfg.head_dim

    def leaf():
        if not quantize:
            return torch.zeros((batch, max_len, hkv, d), dtype=dtype,
                               device=device)
        key, width = ("q4", d // 2) if quantize == "int4" else ("q", d)
        return {key: torch.zeros((batch, hkv, max_len, width),
                                 dtype=torch.int8, device=device),
                "s": torch.zeros((batch, hkv, max_len, 1),
                                 dtype=torch.float32, device=device)}

    return {
        "layers": [{"k": leaf(), "v": leaf()}
                   for _ in range(cfg.num_layers)],
        "index": 0,
        "mask": torch.zeros((batch, max_len), dtype=torch.bool,
                            device=device),
    }


def _quantize_kv(x):
    """(B, S, H, D) -> head-major int8 leaf {"q": (B, H, S, D) int8,
    "s": (B, H, S, 1) fp32}; round half to even, as jnp.round."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return {"q": q.transpose(1, 2), "s": s.transpose(1, 2)}


def _quantize_kv4(x):
    """(B, S, H, D) -> head-major packed int4 leaf {"q4": (B, H, S, D/2)
    int8 (lo nibble = d, hi nibble = d + D/2), "s": (B, H, S, 1) fp32}."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 7.0, 1e-8)
    q = torch.clamp(torch.round(xf / s), -7, 7).to(torch.int32)
    h = x.shape[-1] // 2
    packed = (q[..., :h] & 0xF) | ((q[..., h:] & 0xF) << 4)     # [0, 255]
    packed = packed.to(torch.uint8).view(torch.int8)
    return {"q4": packed.transpose(1, 2), "s": s.transpose(1, 2)}


def _unpack_kv4(packed):
    """(..., D/2) packed bytes -> (..., D) int4-valued int8, lane halves."""
    p = packed.to(torch.int32)
    lo = (p << 28) >> 28                         # sign-extend low nibble
    hi = p >> 4                                  # arithmetic: sign-correct
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def _dequantize_kv(leaf, dtype):
    """Head-major quantized leaf (int8 or packed int4) -> (B, S, H, D) in
    `dtype` (the attention layout)."""
    q = _unpack_kv4(leaf["q4"]) if "q4" in leaf else leaf["q"]
    return (q.float() * leaf["s"]).to(dtype).transpose(1, 2)


def _write_rows(buf, new, index, slot_dim: int):
    """Row b of `new` (S tokens along `slot_dim`) goes to slots
    [index[b], index[b] + S) of row b of `buf`, in place; slots at or past
    the capacity write nothing (mode="drop"). The drop stays on the device:
    a dropped position writes back the value it reads, at its slot taken
    modulo the capacity. Those slots lie below the row's first real write,
    so each (row, slot) is written once when S <= capacity, and the
    scatter is well defined."""
    b, s = new.shape[0], new.shape[slot_dim]
    cap = buf.shape[slot_dim]
    cols = index[:, None].long() + torch.arange(s, device=buf.device)
    keep = cols < cap
    cols = cols % cap
    rows = torch.arange(b, device=buf.device)[:, None]
    if slot_dim == 1:                                   # (B, cap, H, D)
        idx = (rows, cols)
        keep = keep[:, :, None, None]
    else:                                               # (B, H, cap, X)
        heads = torch.arange(buf.shape[1], device=buf.device)
        idx = (rows[:, None], heads[None, :, None], cols[:, None, :])
        keep = keep[:, None, :, None]
    buf[idx] = torch.where(keep, new.to(buf.dtype), buf[idx])


def _write_cache(layer_cache, k_new, v_new, index):
    """Write S new keys/values into the cache in place; quantized leaves
    quantize them first (decoder.py:171-214). An int index writes slots
    [index, index + S) of every row; a (B,) tensor index writes each row at
    its own slots, dropping those past the capacity."""
    s = k_new.shape[1]
    per_row = isinstance(index, torch.Tensor) and index.dim() == 1
    for name, new in (("k", k_new), ("v", v_new)):
        buf = layer_cache[name]
        if isinstance(buf, dict):
            qn = _quantize_kv4(new) if "q4" in buf else _quantize_kv(new)
            for key, val in qn.items():
                if per_row:
                    _write_rows(buf[key], val, index, 2)
                else:
                    buf[key][:, :, index:index + s] = val
        elif per_row:
            _write_rows(buf, new, index, 1)
        else:
            buf[:, index:index + s] = new
    return layer_cache


def _read_cache(layer_cache, dtype):
    k, v = layer_cache["k"], layer_cache["v"]
    if isinstance(k, dict):
        return _dequantize_kv(k, dtype), _dequantize_kv(v, dtype)
    return k, v


def _check_impl(impl: str) -> None:
    if impl not in ("auto", "fused", "torch"):
        raise ValueError(f"impl must be auto|fused|torch, got {impl!r}")


def _block(cfg: DecoderConfig, p, x, mask4, cos, sin, layer_cache, index,
           impl: str = "auto", la=None, ls: float = 1.0):
    """One decoder layer; `la` this layer's LoRA adapters ({proj: {"A",
    "B"}} or None) at scaling `ls` (decoder.py:278-327)."""
    b, s, _ = x.shape
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    la = la or {}
    mm = lambda name, h: lora_dense(p[name], la.get(name), h, ls, impl=impl)
    r = rms_norm(p["attn_norm"], x, eps=cfg.rms_norm_eps)
    q = mm("q_proj", r).reshape(b, s, hq, d)
    k = mm("k_proj", r).reshape(b, s, hkv, d)
    v = mm("v_proj", r).reshape(b, s, hkv, d)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    a = None
    if layer_cache is not None:
        _write_cache(layer_cache, k, v, index)
        lk, lv = layer_cache["k"], layer_cache["v"]
        if (isinstance(lk, dict) and impl != "torch"
                and da.supports(q, lk, mask4)):
            # one-token attention straight over the quantized cache; the
            # dequantized K/V never exist (decoder.py:305-319)
            fn = (da.decode_attention_int4 if "q4" in lk
                  else da.decode_attention_int8)
            a = fn(q, lk, lv, mask4)
        else:
            # attend over the cache: a quantized one DEQUANTIZED, as
            # decoder.py:320-323 does (prefill, and impl="torch")
            k, v = _read_cache(layer_cache, x.dtype)
    if a is None:
        a = attention(q, k, v, mask4, impl=impl)
    x = x + mm("o_proj", a.reshape(b, s, hq * d))
    r = rms_norm(p["ffn_norm"], x, eps=cfg.rms_norm_eps)
    return x + mm("down_proj", silu(mm("gate_proj", r)) * mm("up_proj", r))


def embed_tokens(params, ids):
    return embed(params["embed_tokens"], ids)


def positions_and_rope(params, cfg: DecoderConfig, x, positions):
    """(x, cos, sin); cos/sin are cast to x's dtype before `apply_rope`,
    as at decoder.py:552."""
    cos, sin = rope_cos_sin(positions, cfg.head_dim, theta=cfg.rope_theta)
    return x, cos.to(x.dtype), sin.to(x.dtype)


# The JAX checkpoint_dots policy: what matmul / einsum / linear reach at
# the dispatcher is saved, everything else recomputed (the hand-written
# kernels, launched from outside the dispatcher, included, as Pallas calls
# are under checkpoint_dots).
_DOT_OPS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default]


def _remat_wrap(fn, remat):
    """remat False: fn as it is. True / "full": each call under
    torch.utils.checkpoint (non-reentrant), so the layer's activations are
    recomputed in the backward (decoder.py:457-470). "dots": the same with
    the JAX checkpoint_dots policy: the outputs of `_DOT_OPS` are saved,
    and only the rest is recomputed."""
    if not remat:
        return fn
    if remat not in (True, "full", "dots"):
        raise ValueError(f"remat must be False/True/'full'/'dots', got "
                         f"{remat!r}")
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _DOT_OPS)
    return lambda *a: torch.utils.checkpoint.checkpoint(
        fn, *a, use_reentrant=False, **kw)


def forward(params, cfg: DecoderConfig, input_embeds, positions, mask4,
            cache=None, *, lora=None, lora_scale: float = 1.0,
            impl: str = "auto", remat=False, return_hidden: bool = False,
            ntk_ctx: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[dict]]:
    """input_embeds (B, S, H); positions (B, S); mask4 (B, 1, S, Skv) bool
    (Skv = S without a cache, the cache capacity with one). With a cache,
    the new K/V land at slots [cache["index"], +S) in place and the index
    advances. `lora` {"layers": [...]} adapters (lora/lora.py) at scaling
    `lora_scale`; `remat` rematerializes each layer in the backward
    (`_remat_wrap`, cache-free calls with grad on only). Returns (logits
    (B, S, V) fp32 or final-normed hidden, cache). `ntk_ctx` pins the
    dynamic-NTK context (decoder.py:573-579); it changes nothing for the
    llama family without dynamic NTK, the only one ported.
    """
    _check_family(cfg)
    _check_impl(impl)
    x, cos, sin = positions_and_rope(params, cfg, input_embeds, positions)
    index = cache["index"] if cache is not None else None
    block = _block
    if cache is None and torch.is_grad_enabled():
        block = _remat_wrap(_block, remat)
    for i, p in enumerate(params["layers"]):
        lc = cache["layers"][i] if cache is not None else None
        la = lora["layers"][i] if lora is not None else None
        x = block(cfg, p, x, mask4, cos, sin, lc, index, impl, la,
                  lora_scale)
    if cache is not None:
        cache["index"] = index + input_embeds.shape[1]
    x = rms_norm(params["final_norm"], x, eps=cfg.rms_norm_eps)
    if return_hidden:
        return x, cache
    return head_logits(params, cfg, x, impl=impl), cache


class _HeadProduct(torch.autograd.Function):
    """x (M, H) @ w (H, V), both low precision, -> fp32 logits with fp32
    accumulation (the JAX `preferred_element_type=float32` dot). Backward:
    the two products in x's dtype with fp32 accumulation, the cotangent
    rounded to x's dtype first (dx always, dw when w needs it)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return mm_fp32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gl = g.to(x.dtype)
        dx = mm_fp32(gl, w.t()).to(x.dtype) if ctx.needs_input_grad[0] \
            else None
        dw = mm_fp32(x.t(), gl).to(w.dtype) if ctx.needs_input_grad[1] \
            else None
        return dx, dw


def head_logits(params, cfg: DecoderConfig, x, *, impl: str = "auto"):
    """Vocab projection of final-normed hidden states -> fp32 logits with
    fp32 accumulation and no rounding of the product to x's dtype. On CUDA
    a low-precision product writes fp32 directly (`out_dtype`); elsewhere
    it multiplies in fp32; `_HeadProduct` gives it a backward. A quantized
    head goes through `dense`, so its logits are rounded to x's dtype
    before fp32 (decoder.py:638-639)."""
    head = params.get("lm_head", {})
    if not cfg.tie_word_embeddings and (
            "kernel_p" in head or "kernel_q" in head):
        return dense(head, x, impl=impl).float()
    w = (params["embed_tokens"]["embedding"].t()
         if cfg.tie_word_embeddings or "lm_head" not in params
         else params["lm_head"]["kernel"])
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype != torch.float32:
        y = _HeadProduct.apply(x2, w.to(x.dtype))
    else:
        y = x2 @ w.float()
    return y.reshape(*lead, -1)


def positions_from_mask(attn_mask):
    """Left-pad-aware positions: 0 at the first valid token."""
    pos = torch.cumsum(attn_mask.int(), dim=-1) - 1
    return pos.clamp_min(0).int()
