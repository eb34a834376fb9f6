"""Decoder-only LLMs: Llama-3, Qwen2.5 and OPT/Galactica (port of
`opus_pllm_tpu/models/decoder.py`).

`init` (decoder.py:37), `init_cache` (:87), the quantized-cache helpers
`_quantize_kv` (:131), `_quantize_kv4` (:141), `_unpack_kv4` (:155),
`_dequantize_kv` (:163), `_write_cache` (:171), `_read_cache` (:217),
`_norm` and `_mlp` (:226, :232), `_block` (:278, with LoRA adapters),
`_remat_wrap` (:457), `forward` (:555, with `lora=`, `lora_scale=`,
`remat=` and `ntk_ctx=`), `positions_and_rope` (:535), `_head` (:618),
`head_logits` (:629), `embed_tokens` (:375), `positions_from_mask`
(:644), the beam-search cache rows `tile_cache` (:379) and
`reorder_cache` (:392), and `fuse_projections` (:330) with the fused
branch of the block (`_fused_qkv` :243, `_fused_gateup` :263). One forward
covers the three families of `DecoderConfig.family`:

  llama : RMSNorm, half-split RoPE, GQA, SiLU-gated MLP, no biases
  qwen2 : the llama skeleton with q/k/v biases (`attention_bias`)
  opt   : LayerNorm with bias (eps 1e-5), learned positions at offset 2
          and no rope, q/k/v/o biases, fc1 -> relu/gelu -> fc2 with
          biases, MHA, a final LayerNorm when `do_layer_norm_before`

and the port's own fourth, which the JAX package does not have:

  deepseek_v2 : DeepSeek-V2 (modeling_deepseek.py): RMSNorm; multi-head
          latent attention (`_mla`: q_proj, the joint kv_a product split
          into the latent c and a one-head rope key, c RMS-normed, kv_b
          decompressing c into per-head nope keys and values; YaRN rope
          on interleaved pairs; softmax scale 1/sqrt(nope + rope) x
          mscale(factor, mscale_all_dim)^2); the first
          `first_k_dense_replace` layers a SwiGLU, the others a routed
          layer (`_moe`: fp32 softmax router, top-k, the pairs sorted by
          expert on the device, `kernels/moe.grouped_gemm` for gate|up and
          down, the fp32 weighted sum) plus shared experts. Its cache
          holds the latent state: {"c": (B, cap, rank), "k_pe": (B, cap,
          rope)} a layer. A prefill decompresses the cache's keys and
          values; a one-token step attends in the absorbed form, W_UK folded
          into the query and W_UV applied after the weighted sum, so it
          reads only the latent cache. bf16 weights and cache on one
          process only (`refuse_deepseek`).

`use_dynamic_ntk` rescales the rope base for contexts past
`max_position_embeddings` (`layers.ntk_scaled_theta`), from the context
bound `forward` derives as the JAX function does. Projections may be bf16
("kernel"), int8 ("kernel_q", see kernels/quant.py) or int4 ("kernel_p",
see kernels/quant4.py), each on its own or fused by `fuse_projections`
into one [q|k|v] and one [gate|up] product.

KV cache: {"layers": [{"k", "v"}], "index", "mask": (B, cap) bool}. The
index is an int or a 0-dim integer tensor (every row writes at the same
slots; the tensor keeps the slot on the device, so a decode step captured
as a CUDA graph reads it at every replay) or a (B,) integer tensor (each
row at its own slot: the serving engine).
A bf16 leaf is (B, cap, Hkv, D). A quantized leaf is head-major:
{"q": (B, Hkv, cap, D) int8, "s": (B, Hkv, cap, 1) fp32} (int8) or
{"q4": (B, Hkv, cap, D/2) int8, "s": ...} (int4, low nibble d, high nibble
d + D/2), with one absmax scale per (token, head). `forward` writes the new
keys and values into the cache IN PLACE and advances `cache["index"]`; the
returned cache is the same object (the JAX version returns a new pytree).

`impl`: "auto" (or "fused") takes the kernels where the shapes allow them
(flash attention for prefills, decode attention over a quantized or a bf16
cache, int8 and int4 projections); the kernel wrappers run their plain versions
on CPU tensors. "torch" takes the plain versions on every device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import create_selective_checkpoint_contexts

from ..core import mesh as mesh_mod
from ..core.config import DecoderConfig
from ..core.util import mm_fp32, resolve_device
from ..kernels import decode_attention as da
from ..kernels import moe as moe_kernels
from ..utils.observability import prof_range
from . import layers
from .layers import (ACTIVATIONS, apply_rope, apply_rope_interleaved,
                     attention, dense, embed, layer_norm, lora_delta,
                     lora_dense, mla_attention, ntk_scaled_theta, rms_norm,
                     rope_cos_sin, yarn_cos_sin, yarn_get_mscale)

OPT_POS_OFFSET = 2      # HF OPT learned-position offset (decoder.py:29)
FAMILIES = ("llama", "qwen2", "opt", "deepseek_v2")
MLA = "deepseek_v2"


def refuse_deepseek(cfg: DecoderConfig, what: str) -> None:
    """ValueError where `what` meets the deepseek_v2 family, which runs
    only the annotate path: bf16 weights and cache, one process, greedy or
    sampled `engine.generate`."""
    if cfg.family == MLA:
        raise ValueError(f"{what} is not supported for the deepseek_v2 "
                         "family (bf16 weights and cache on one process, "
                         "through engine.generate, only)")


def _init_deepseek_layer(cfg: DecoderConfig, i: int, kw, norm):
    """One deepseek_v2 layer's random parameters: MLA, then a SwiGLU
    (i < first_k_dense_replace) or a router, the routed experts stacked
    (E, in, out) and the shared experts as one SwiGLU."""
    h, nh = cfg.hidden_size, cfg.num_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    dense_init = layers.dense_init
    lp = {"attn_norm": norm(h),
          "q_proj": dense_init(h, nh * (dn + dr), **kw),
          "kv_a_proj": dense_init(h, r + dr, **kw),
          "kv_a_norm": norm(r),
          "kv_b_proj": dense_init(r, nh * (dn + dv), **kw),
          "o_proj": dense_init(nh * dv, h, **kw),
          "ffn_norm": norm(h)}
    swiglu = lambda f: {"gate_proj": dense_init(h, f, **kw),
                        "up_proj": dense_init(h, f, **kw),
                        "down_proj": dense_init(f, h, **kw)}
    if i < cfg.first_k_dense_replace:
        lp.update(swiglu(cfg.intermediate_size))
        return lp
    e, f = cfg.n_routed_experts, cfg.moe_intermediate_size
    stack = lambda fan_in, fan_out: {"kernel": layers.uniform_(
        (e, fan_in, fan_out), 1.0 / fan_in ** 0.5, **kw)}
    lp["router"] = dense_init(h, e, **kw)
    lp["experts"] = {"gate_proj": stack(h, f), "up_proj": stack(h, f),
                     "down_proj": stack(f, h)}
    lp["shared"] = swiglu(f * cfg.n_shared_experts)
    return lp


def init(cfg: DecoderConfig, *, generator: torch.Generator, device=None,
         finish_head=None, finish_layer=None):
    """Random parameters drawn from `generator` (decoder.py:37-80 scheme:
    q/k/v biases for qwen2; for opt LayerNorms with bias, the learned
    position table, q/k/v/o biases and fc1/fc2) on `device` (None: CUDA).
    An unknown family raises ValueError. `finish_head(lm_head)` and
    `finish_layer(layer)` map each part as soon as it is drawn (a rank of
    a tensor-parallel mesh quantizes and keeps its slice: the draws are
    the single process's, and the whole model never exists at once)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"decoder family {cfg.family!r} is not one of "
                         f"{FAMILIES}")
    device = resolve_device(device)
    dt = cfg.torch_dtype
    h, d = cfg.hidden_size, cfg.head_dim
    is_opt = cfg.family == "opt"
    bias_attn = cfg.attention_bias or is_opt
    kw = dict(generator=generator, device=device, dtype=dt)
    norm = lambda: layers.norm_init(h, device=device, dtype=dt, bias=is_opt)
    if cfg.family == MLA:
        ds_norm = lambda n: layers.norm_init(n, device=device, dtype=dt,
                                             bias=False)
        make_layer = lambda i: _init_deepseek_layer(cfg, i, kw, ds_norm)
    params: Dict[str, Any] = {
        "embed_tokens": layers.embed_init(cfg.vocab_size, h, **kw),
        "final_norm": norm(),
        "layers": [],
    }
    if is_opt:
        params["embed_positions"] = layers.embed_init(
            cfg.max_position_embeddings + OPT_POS_OFFSET, h, **kw)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = layers.dense_init(h, cfg.vocab_size, **kw)
        if finish_head is not None:
            params["lm_head"] = finish_head(params["lm_head"])
    qdim, kvdim = cfg.num_heads * d, cfg.num_kv_heads * d
    f = cfg.intermediate_size
    for i in range(cfg.num_layers):
        if cfg.family == MLA:
            lp = make_layer(i)
            params["layers"].append(finish_layer(lp) if finish_layer
                                    else lp)
            continue
        lp = {"attn_norm": norm(),
              "q_proj": layers.dense_init(h, qdim, bias=bias_attn, **kw),
              "k_proj": layers.dense_init(h, kvdim, bias=bias_attn, **kw),
              "v_proj": layers.dense_init(h, kvdim, bias=bias_attn, **kw),
              "o_proj": layers.dense_init(qdim, h, bias=is_opt, **kw),
              "ffn_norm": norm()}
        if is_opt:
            lp["fc1"] = layers.dense_init(h, f, bias=True, **kw)
            lp["fc2"] = layers.dense_init(f, h, bias=True, **kw)
        else:
            lp["gate_proj"] = layers.dense_init(h, f, **kw)
            lp["up_proj"] = layers.dense_init(h, f, **kw)
            lp["down_proj"] = layers.dense_init(f, h, **kw)
        params["layers"].append(finish_layer(lp) if finish_layer else lp)
    return params


def init_cache(cfg: DecoderConfig, batch: int, max_len: int, dtype=None,
               *, device=None, quantize=False):
    """Zeroed KV cache with `max_len` slots per row. quantize=True/"int8"
    stores int8 K/V, "int4" packed int4, each with per-(token, head) fp32
    scales, head-major (decoder.py:87-128), on `device` (None: CUDA). The
    deepseek_v2 family's holds the latent state instead, {"c": (B, cap,
    kv_lora_rank), "k_pe": (B, cap, qk_rope_head_dim)} a layer, in
    `dtype` only."""
    device = resolve_device(device)
    if quantize is True:
        quantize = "int8"
    if quantize not in (False, "int8", "int4"):
        raise ValueError(f"quantize must be False/True/'int8'/'int4', "
                         f"got {quantize!r}")
    dtype = dtype or cfg.torch_dtype
    hkv, d = cfg.num_kv_heads, cfg.head_dim
    if cfg.family == MLA:
        if quantize:
            refuse_deepseek(cfg, "a quantized cache")
        latent = lambda n: torch.zeros((batch, max_len, n), dtype=dtype,
                                       device=device)
        return {"layers": [{"c": latent(cfg.kv_lora_rank),
                            "k_pe": latent(cfg.qk_rope_head_dim)}
                           for _ in range(cfg.num_layers)],
                "index": 0,
                "mask": torch.zeros((batch, max_len), dtype=torch.bool,
                                    device=device)}

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


def _write_rows(buf, new, index, slot_dim: int, rows=None):
    """Row b of `new` (S tokens along `slot_dim`) goes to slots
    [index[b], index[b] + S) of row b of `buf` (row rows[b] when `rows`, a
    (B,) tensor of distinct rows, is given), in place; slots at or past
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
    rows = (torch.arange(b, device=buf.device) if rows is None
            else rows.long())[:, None]
    if slot_dim == 1:                                   # (B, cap, H, D)
        idx = (rows, cols)
        keep = keep[:, :, None, None]
    else:                                               # (B, H, cap, X)
        heads = torch.arange(buf.shape[1], device=buf.device)
        idx = (rows[:, None], heads[None, :, None], cols[:, None, :])
        keep = keep[:, None, :, None]
    buf[idx] = torch.where(keep, new.to(buf.dtype), buf[idx])


def _write_cache(layer_cache, k_new, v_new, index, rows=None,
                 names=("k", "v")):
    """Write S new keys/values (under `names`: the latent c and k_pe of
    the deepseek_v2 cache, (B, S, X)) into the cache in place; quantized
    leaves quantize them first (decoder.py:171-214). An int index writes slots
    [index, index + S) of every row, and so does a 0-dim tensor index,
    without reading it on the host; a (B,) tensor index writes each row at
    its own slots, dropping those past the capacity, into the cache rows
    `rows` (B,) when given (the engine's chunked prefill: a group of slots
    of the pool, written in place)."""
    s = k_new.shape[1]
    per_row = isinstance(index, torch.Tensor) and index.dim() == 1
    slots = None
    if isinstance(index, torch.Tensor) and index.dim() == 0:
        # one token (a decode step): the slot itself, a view, no launch
        slots = (index.long().reshape(1) if s == 1
                 else index.long() + torch.arange(s, device=index.device))

    def put(buf, val, slot_dim):
        if per_row:
            _write_rows(buf, val, index, slot_dim, rows)
        elif slots is not None:
            buf.index_copy_(slot_dim, slots, val.to(buf.dtype))
        elif slot_dim == 1:
            buf[:, index:index + s] = val
        else:
            buf[:, :, index:index + s] = val

    for name, new in zip(names, (k_new, v_new)):
        buf = layer_cache[name]
        if isinstance(buf, dict):
            qn = _quantize_kv4(new) if "q4" in buf else _quantize_kv(new)
            for key, val in qn.items():
                put(buf[key], val, 2)
        else:
            put(buf, new, 1)
    return layer_cache


def _read_cache(layer_cache, dtype, rows=None):
    """The layer's keys and values in the attention layout, the rows
    `rows` only when given (a gathered copy)."""
    k, v = layer_cache["k"], layer_cache["v"]
    if rows is not None:
        take = lambda t: ({n: x[rows] for n, x in t.items()}
                          if isinstance(t, dict) else t[rows])
        k, v = take(k), take(v)
    if isinstance(k, dict):
        return _dequantize_kv(k, dtype), _dequantize_kv(v, dtype)
    return k, v


def _check_impl(impl: str) -> None:
    if impl not in ("auto", "fused", "torch", "ring", "sp_decode"):
        raise ValueError(f"impl must be auto|fused|torch|ring|sp_decode, "
                         f"got {impl!r}")


def _norm(cfg: DecoderConfig, p, x):
    """OPT's LayerNorm (eps 1e-5), else RMSNorm (decoder.py:226-229)."""
    if cfg.family == "opt":
        return layer_norm(p, x, eps=1e-5)
    return rms_norm(p, x, eps=cfg.rms_norm_eps)


def _mlp(cfg: DecoderConfig, p, x, mm, fused, row=None):
    """fc2(act(fc1 x)) for OPT, else down(silu(gate x) * up x)
    (decoder.py:232-240); `mm(name, x)` is the layer's projection,
    `fused(name, x, parts)` the sliced product of a fused one, `row` the
    out-projection (mm unless it is row-parallel)."""
    row = row or mm
    if cfg.family == "opt":
        return row("fc2", ACTIVATIONS[cfg.activation](mm("fc1", x)))
    if "gateup_proj" in p:
        i = cfg.intermediate_size
        gate, up = fused("gateup_proj", x, (("gate_proj", i), ("up_proj", i)))
    else:
        gate, up = mm("gate_proj", x), mm("up_proj", x)
    return row("down_proj", ACTIVATIONS["silu"](gate) * up)


def _row_parallel(p, la, x, ls: float, impl: str, tp):
    """A row-parallel projection under tensor parallelism: this rank's
    input rows times its rows of the weight (and of LoRA's A), summed over
    the model group by one fp32 all-reduce; the bias, held whole, is added
    once after it and the sum rounded to x's dtype. With grad on the sum
    is `reduce_from_model` (its gradient reaches every rank's rows); under
    no_grad an in-place all-reduce."""
    y = dense({k: v for k, v in p.items() if k != "bias"}, x,
              impl=impl).float()
    if la is not None:
        # the base and the LoRA delta summed apart, so that the base sum is
        # rounded to x's dtype before the fp32 delta is added, as
        # lora_dense rounds one process's product: a delta below half a
        # unit of the base's last place is lost alike on both
        y = torch.stack([y, lora_delta(la, x, ls)])
    if torch.is_grad_enabled():
        y = mesh_mod.reduce_from_model(y, tp.group)
    else:
        tp.all_reduce(y)
    if la is not None:
        y, delta = y.unbind(0)
    if "bias" in p:
        y = y + p["bias"].float()
    if la is not None:
        y = y.to(x.dtype).float() + delta
    return y.to(x.dtype)


def _fused_product(p, x, parts, la, ls, impl):
    """One product over a fused projection (`fuse_projections`), split
    into `parts` ((name, width), ...) along the output; a slice whose
    projection has an unmerged LoRA adapter gets its delta in fp32, the sum
    rounded once to x's dtype (decoder.py:243-275)."""
    y = dense(p, x, impl=impl)
    out, lo = [], 0
    for name, width in parts:
        part = y[..., lo:lo + width]
        if name in la:
            part = (part.float() + lora_delta(la[name], x, ls)).to(x.dtype)
        out.append(part)
        lo += width
    return out


def _block(cfg: DecoderConfig, p, x, mask4, cos, sin, layer_cache, index,
           impl: str = "auto", la=None, ls: float = 1.0, rows=None,
           sp=None):
    """One decoder layer; `la` this layer's LoRA adapters ({proj: {"A",
    "B"}} or None) at scaling `ls` (decoder.py:278-327). cos/sin None: no
    rope (OPT). `rows`: the cache rows x's rows use (None: the same).
    Under tensor parallelism (`cfg.tp`) the heads and the MLP width are
    this rank's shares and the out-projections all-reduce; with grad on
    the inputs of the split column-parallel products pass through
    `copy_to_model`, so training's gradients are whole. impl "ring"
    (a sequence-sharded prefill over `sp`'s group: the cache keeps this
    rank's shard, attention runs over the rotating fresh shards) and
    "sp_decode" (one token over a sequence-sharded cache, the partial
    softmaxes merged across `sp`) are the seq-shards modes
    (decoder.py:298-320); their `mask4` is the 2-D (B, S_loc) validity."""
    b, s, _ = x.shape
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    la = la or {}
    sharded = impl in ("ring", "sp_decode")
    pimpl = "auto" if sharded else impl          # the projections' choice
    mm = lambda name, h: lora_dense(p[name], la.get(name), h, ls,
                                    impl=pimpl)
    fused = lambda name, h, parts: _fused_product(p[name], h, parts, la, ls,
                                                  pimpl)
    tp = cfg.tp

    def row(split):
        if tp is None or not split:
            return mm
        return lambda name, h: _row_parallel(p[name], la.get(name), h, ls,
                                             pimpl, tp)

    def col(h, split):
        # the input of split column-parallel products: with grad on, its
        # gradient is summed over the model ranks' columns
        if tp is None or not split or not torch.is_grad_enabled():
            return h
        return mesh_mod.copy_to_model(h, tp.group)
    r = col(_norm(cfg, p["attn_norm"], x), tp is not None and tp.attn)
    if "qkv_proj" in p:
        q, k, v = fused("qkv_proj", r, (("q_proj", hq * d),
                                        ("k_proj", hkv * d),
                                        ("v_proj", hkv * d)))
    else:
        q, k, v = mm("q_proj", r), mm("k_proj", r), mm("v_proj", r)
    q = q.reshape(b, s, hq, d)
    k = k.reshape(b, s, hkv, d)
    v = v.reshape(b, s, hkv, d)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    a = None
    if layer_cache is not None:
        _write_cache(layer_cache, k, v, index, rows)
        lk, lv = layer_cache["k"], layer_cache["v"]
        if impl == "ring":
            # the ring attends the fresh shards: the local cache read back
            # would hand it capacity-length shards (decoder.py:300-306)
            pass
        elif (rows is None and isinstance(lk, dict)
                and impl not in ("torch", "sp_decode")
                and da.supports(q, lk, mask4)):
            # one-token attention straight over the quantized cache; the
            # dequantized K/V never exist (decoder.py:305-319)
            fn = (da.decode_attention_int4 if "q4" in lk
                  else da.decode_attention_int8)
            a = fn(q, lk, lv, mask4)
        elif (rows is None and impl not in ("torch", "sp_decode")
                and da.supports_bf16(q, lk, mask4)):
            # one-token attention straight over the bf16 cache: no fp32
            # or batched-layout copy of it is made
            a = da.decode_attention_bf16(q, lk, lv, mask4)
        else:
            # attend over the cache: a quantized one DEQUANTIZED, as
            # decoder.py:320-323 does (prefill, impl="torch" and
            # sp_decode, whose softmax merges across the shards)
            k, v = _read_cache(layer_cache, x.dtype, rows)
    if a is None:
        a = attention(q, k, v, mask4, impl=impl,
                      group=sp.group if sp is not None else None)
    x = x + row(tp is not None and tp.attn)("o_proj",
                                             a.reshape(b, s, hq * d))
    split = tp is not None and tp.mlp
    return x + _mlp(cfg, p, col(_norm(cfg, p["ffn_norm"], x), split), mm,
                    fused, row(split))


def mla_softmax_scale(cfg: DecoderConfig) -> float:
    """1 / sqrt(nope + rope) x mscale(factor, mscale_all_dim)^2
    (DeepseekV2Attention.softmax_scale)."""
    m = (yarn_get_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
         if cfg.rope_mscale_all_dim else 1.0)
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * m * m


def _mla_absorbed(cfg: DecoderConfig, p, q_nope, q_pe, lc, mask4, scale):
    """One token a row over the latent cache, W_UK folded into the query
    and W_UV applied after the weighted sum: q_nope (B, 1, H, nope), q_pe
    (B, 1, H, rope) -> (B, 1, H * v). Each product in the cache's dtype
    with its output rounded there, as the published attention rounds its
    q.k and weights.v products; the logits' two parts (latent, rope)
    added, scaled and softmaxed in fp32, the weights rounded to the
    cache's dtype."""
    b, nh = q_nope.shape[0], cfg.num_heads
    r, dn, dv = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.v_head_dim
    c, kpe = lc["c"], lc["k_pe"]                         # (B, cap, X)
    w = p["kv_b_proj"]["kernel"].view(r, nh, dn + dv).to(c.dtype)
    w_uk = w[..., :dn].permute(1, 2, 0)                  # (H, nope, rank)
    w_uv = w[..., dn:].permute(1, 0, 2)                  # (H, rank, v)
    q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1).to(c.dtype), w_uk)
    # the cache as the left operand (cap rows a batch, not the 16 heads):
    # cuBLAS's kernels for this shape read the cache ~8x faster
    logits = (torch.bmm(c, q_lat.permute(1, 2, 0)).float()
              + torch.bmm(kpe, q_pe[:, 0].to(c.dtype).transpose(1, 2))
              .float()).transpose(1, 2)                  # (B, H, cap)
    logits = torch.where(mask4[:, 0], logits * scale,
                         torch.full_like(logits, layers.NEG_INF))
    wts = torch.softmax(logits, dim=-1).to(c.dtype)
    o_lat = torch.bmm(c.transpose(1, 2), wts.transpose(1, 2))  # (B, rank, H)
    out = torch.bmm(o_lat.permute(2, 0, 1), w_uv)       # (H, B, v)
    return out.transpose(0, 1).reshape(b, 1, nh * dv).to(q_nope.dtype)


def _mla(cfg: DecoderConfig, p, r, mask4, cos, sin, layer_cache, index,
         impl: str):
    """Multi-head latent attention (DeepseekV2Attention, q_lora_rank
    None) of the normed input r (B, S, H) -> (B, S, H). With a cache the
    new latent c and roped k_pe are written at `index`; one token (S = 1)
    attends in the absorbed form over the cache (`_mla_absorbed`), more
    decompress the cache's slots [0, index + S) through kv_b (an int
    index: a prefill)."""
    b, s, _ = r.shape
    nh, rank = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    if "q_kv_a_proj" in p:
        q, ckv = _fused_product(p["q_kv_a_proj"], r,
                                (("q_proj", nh * (dn + dr)),
                                 ("kv_a_proj", rank + dr)), {}, 1.0, impl)
    else:
        q, ckv = dense(p["q_proj"], r, impl=impl), \
            dense(p["kv_a_proj"], r, impl=impl)
    q = q.reshape(b, s, nh, dn + dr)
    q_nope = q[..., :dn]
    q_pe = apply_rope_interleaved(q[..., dn:], cos, sin)
    c = rms_norm(p["kv_a_norm"], ckv[..., :rank], eps=cfg.rms_norm_eps)
    k_pe = apply_rope_interleaved(ckv[..., rank:].reshape(b, s, 1, dr),
                                  cos, sin)[:, :, 0]
    scale = mla_softmax_scale(cfg)
    if layer_cache is not None:
        _write_cache(layer_cache, c, k_pe, index, names=("c", "k_pe"))
        if s == 1:
            a = _mla_absorbed(cfg, p, q_nope, q_pe, layer_cache, mask4,
                              scale)
            return dense(p["o_proj"], a, impl=impl)
        if isinstance(index, torch.Tensor):
            raise ValueError("a deepseek_v2 prefill takes an int cache "
                             "index")
        n = index + s
        c, k_pe = layer_cache["c"][:, :n], layer_cache["k_pe"][:, :n]
        mask4 = mask4[..., :n]
    n = c.shape[1]
    kv = dense(p["kv_b_proj"], c, impl=impl).reshape(b, n, nh, dn + dv)
    k = torch.cat([kv[..., :dn], k_pe[:, :, None].expand(b, n, nh, dr)],
                  dim=-1)
    a = mla_attention(torch.cat([q_nope, q_pe], dim=-1), k, kv[..., dn:],
                      mask4, scale)
    return dense(p["o_proj"], a.reshape(b, s, nh * dv), impl=impl)


def _swiglu(p, x, width: int, impl: str):
    """down(silu(gate x) * up x), gate|up fused or not."""
    if "gateup_proj" in p:
        g, u = _fused_product(p["gateup_proj"], x, (("gate_proj", width),
                                                    ("up_proj", width)),
                              {}, 1.0, impl)
    else:
        g, u = dense(p["gate_proj"], x, impl=impl), \
            dense(p["up_proj"], x, impl=impl)
    return dense(p["down_proj"], ACTIVATIONS["silu"](g) * u, impl=impl)


class MoETally:
    """A decode loop's routing, counted on the device: pairs per (routed
    layer, expert), and per layer the experts with a pair and the busiest
    expert's pairs, each summed over the forwards that ran. `add` is a few
    device operations (inside a captured step, so replays count too);
    `read` is one copy to the host."""

    def __init__(self, cfg: DecoderConfig, device):
        n = cfg.num_layers - cfg.first_k_dense_replace
        self.pairs = torch.zeros((n, cfg.n_routed_experts),
                                 dtype=torch.int64, device=device)
        self.hit = torch.zeros((n,), dtype=torch.int64, device=device)
        self.busiest = torch.zeros((n,), dtype=torch.int64, device=device)
        self.first = cfg.first_k_dense_replace

    def add(self, layer: int, counts) -> None:
        i = layer - self.first
        self.pairs[i] += counts
        self.hit[i] += (counts > 0).sum()
        self.busiest[i] += counts.max()

    def read(self) -> dict:
        return {"pairs": int(self.pairs.sum()), "hit": int(self.hit.sum()),
                "busiest": int(self.busiest.sum())}


def _experts(ep, rows, offsets, impl: str):
    """The routed experts' SwiGLU over `rows` sorted by expert: the fused
    gate|up (`interleave_gate_up`) in one grouped product with the
    SiLU-mul epilogue, else gate and up apart; then down."""
    mm = lambda x, w, **kw: moe_kernels.grouped_gemm(x, w["kernel"], offsets,
                                                     impl=impl, **kw)
    if "gateup_proj" in ep:
        mid = mm(rows, ep["gateup_proj"], swiglu=True)
    else:
        g = mm(rows, ep["gate_proj"]).float()
        mid = (ACTIVATIONS["silu"](g) * mm(rows, ep["up_proj"]).float()) \
            .to(rows.dtype)
    return mm(mid, ep["down_proj"])


def _moe(cfg: DecoderConfig, p, x, impl: str, tally=None, layer: int = 0):
    """The routed layer (DeepseekV2MoE, inference): the router's fp32
    softmax scores, the top `num_experts_per_tok` (weights normalised or
    scaled by `routed_scaling_factor`), the (token, expert) pairs sorted
    by expert and their offsets computed on the device, the experts
    (`_experts`), each pair's output put back in the token's order and
    summed with its weight in fp32, plus the shared experts. Nothing is
    read on the host. `tally` (MoETally) counts the pairs."""
    b, s, h = x.shape
    xt = x.reshape(-1, h)
    k, e = cfg.num_experts_per_tok, cfg.n_routed_experts
    with prof_range("decoder.moe.route"):
        scores = torch.softmax(xt.float() @ p["router"]["kernel"].float(),
                               dim=-1)
        w, ids = torch.topk(scores, k, dim=-1)
        if cfg.norm_topk_prob:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        else:
            w = w * cfg.routed_scaling_factor
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.zeros((e,), dtype=torch.int32, device=x.device)
        counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
        offsets = torch.cat([counts.new_zeros((1,)),
                             counts.cumsum(0, dtype=torch.int32)])
        rows = xt.index_select(0, order // k)
        if tally is not None:
            tally.add(layer, counts)
    with prof_range("decoder.moe.experts"):
        y = _experts(p["experts"], rows, offsets, impl)
        y = torch.empty_like(y).index_copy_(0, order, y)
        routed = (y.view(-1, k, h).float() * w[..., None]).sum(1)
        routed = routed.to(x.dtype).reshape(b, s, h)
    return routed + _swiglu(p["shared"], x, cfg.moe_intermediate_size
                            * cfg.n_shared_experts, impl)


def _deepseek_block(cfg: DecoderConfig, p, x, mask4, cos, sin, layer_cache,
                    index, impl: str, tally, layer: int):
    """One deepseek_v2 layer: x + MLA(norm x), then + the SwiGLU or the
    routed layer of norm x."""
    eps = cfg.rms_norm_eps
    with prof_range("decoder.mla"):
        x = x + _mla(cfg, p, rms_norm(p["attn_norm"], x, eps=eps), mask4,
                     cos, sin, layer_cache, index, impl)
    r = rms_norm(p["ffn_norm"], x, eps=eps)
    if "experts" in p:
        return x + _moe(cfg, p, r, impl, tally, layer)
    return x + _swiglu(p, r, cfg.intermediate_size, impl)


def _gathered_block(cfg: DecoderConfig, p, *rest):
    """`_block` over this rank's data share of a layer (FSDP, `cfg.fsdp`):
    the layer's leaves are all-gathered over the data ranks first and die
    with the call; under remat the recompute gathers them again, on every
    rank in the same order."""
    return _block(cfg, cfg.fsdp.gather_layer(p), *rest)


def fuse_layer(lp: Dict) -> Dict:
    """One layer with q/k/v concatenated into "qkv_proj" and gate/up into
    "gateup_proj" (decoder.py:330-376): 7 projection products become 4,
    each of the remaining ones wider. A deepseek_v2 layer fuses [q |
    kv_a] into "q_kv_a_proj", the dense or shared experts' gate|up, and
    the routed experts' gate|up into the grouped GEMM's interleaved
    "gateup_proj" (`kernels.moe.interleave_gate_up`; left unfused where
    the expert width is not a multiple of 64); kv_b, o, down, the router
    and the norms stay as they are. bf16 ("kernel"), int8 ("kernel_q" +
    per-column "scale") and int4 ("kernel_p" + group "gscale") projections
    all concatenate exactly along the output: kernels and gscale on axis
    1, scale and biases on axis 0. The input layer is not changed; the
    fused projections' leaves are new tensors, the others shared."""
    def cat(ps):
        leaf = next(k for k in ("kernel", "kernel_q", "kernel_p")
                    if k in ps[0])
        out = {leaf: torch.cat([p[leaf] for p in ps], dim=1)}
        for key, dim in (("scale", 0), ("gscale", 1), ("bias", 0)):
            if key in ps[0]:
                out[key] = torch.cat([p[key] for p in ps], dim=dim)
        return out

    nlp = dict(lp)
    for fused, names in (("qkv_proj", ("q_proj", "k_proj", "v_proj")),
                         ("q_kv_a_proj", ("q_proj", "kv_a_proj")),
                         ("gateup_proj", ("gate_proj", "up_proj"))):
        if all(n in nlp for n in names):
            nlp[fused] = cat([nlp[n] for n in names])
            for n in names:
                del nlp[n]
    if "shared" in lp:
        nlp["shared"] = fuse_layer(lp["shared"])
    ep = lp.get("experts")
    if ep is not None and "gate_proj" in ep and ep["gate_proj"][
            "kernel"].shape[2] % moe_kernels.BLOCK == 0:
        gate, up = ep["gate_proj"]["kernel"], ep["up_proj"]["kernel"]
        nlp["experts"] = {"gateup_proj": {"kernel": moe_kernels
                                          .interleave_gate_up(gate, up)},
                          "down_proj": ep["down_proj"]}
    return nlp


def fuse_projections(params: Dict, cfg: DecoderConfig) -> Dict:
    """`fuse_layer` on every layer, as a new tree (the input is not
    changed). Unmerged LoRA adapters keep their per-projection names and
    land on the fused output's slices (`_fused_product`)."""
    return dict(params, layers=[fuse_layer(lp) for lp in params["layers"]])


def embed_tokens(params, ids):
    return embed(params["embed_tokens"], ids)


def _map_rows(cache, fn):
    """A new cache whose every layer leaf, scales "s" included, and whose
    mask are fn(tensor) along the batch rows (dim 0 of every leaf: the bf16
    (B, cap, H, D) and the head-major quantized (B, H, cap, X) alike)."""
    leaf = lambda t: ({k: fn(x) for k, x in t.items()}
                      if isinstance(t, dict) else fn(t))
    return {"layers": [{name: leaf(t) for name, t in lc.items()}
                       for lc in cache["layers"]],
            "index": cache["index"], "mask": fn(cache["mask"])}


def tile_cache(cache, k: int):
    """Repeat each batch row k times (row b * k + beam): a B-row prefill
    cache becomes the B * k rows of beam search (decoder.py:379-389)."""
    return _map_rows(cache, lambda x: x.repeat_interleave(k, dim=0))


def reorder_cache(cache, row_idx):
    """The cache rows `row_idx` (B * k,), as a new cache: each surviving
    beam inherits its parent's keys, values, scales and mask
    (decoder.py:392-402, HF reorder_cache's role)."""
    return _map_rows(cache, lambda x: x.index_select(0, row_idx))


def opt_positions(params, positions):
    """OPT's learned position embeddings at `positions` + OPT_POS_OFFSET.
    A position past the table (max_position_embeddings + 2 rows) gives a
    NaN row, as `jnp.take`'s fill mode does in the JAX package, and reads
    nothing out of bounds."""
    table = params["embed_positions"]["embedding"]
    idx = positions.long() + OPT_POS_OFFSET
    inside = (idx < table.shape[0])[..., None]
    rows = table[idx.clamp_max(table.shape[0] - 1)]
    return torch.where(inside, rows, torch.full_like(rows, float("nan")))


def positions_and_rope(params, cfg: DecoderConfig, x, positions, *,
                       ctx: int):
    """Front half of `forward` (decoder.py:535-552): OPT adds its learned
    position embeddings and has no rope (cos, sin None); the rope families
    build (cos, sin) in x's dtype, the base rescaled by dynamic NTK for the
    context bound `ctx` when `use_dynamic_ntk`; deepseek_v2 its YaRN
    tables over the rope dims."""
    if cfg.family == "opt":
        return x + opt_positions(params, positions), None, None
    if cfg.family == MLA:
        cos, sin = yarn_cos_sin(
            positions, cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_factor,
            cfg.rope_original_max_position, cfg.rope_beta_fast,
            cfg.rope_beta_slow, cfg.rope_mscale, cfg.rope_mscale_all_dim)
        return x, cos.to(x.dtype), sin.to(x.dtype)
    theta = cfg.rope_theta
    if cfg.use_dynamic_ntk:
        theta = ntk_scaled_theta(theta, cfg.head_dim, ctx,
                                 cfg.max_position_embeddings)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, theta=theta)
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
            ntk_ctx: Optional[int] = None, sp=None, moe_tally=None
            ) -> Tuple[torch.Tensor, Optional[dict]]:
    """input_embeds (B, S, H); positions (B, S); mask4 (B, 1, S, Skv) bool
    (Skv = S without a cache, the cache capacity with one). With a cache,
    the new K/V land at slots [cache["index"], +S) in place and the index
    advances. `lora` {"layers": [...]} adapters (lora/lora.py) at scaling
    `lora_scale`; `remat` rematerializes each layer in the backward
    (`_remat_wrap`, cache-free calls with grad on only). Returns (logits
    (B, S, V) fp32 or final-normed hidden, cache). A cache may carry
    "rows" (B,): the cache rows the B input rows write and read, with a
    (B,) index (the serving engine's chunked prefill).

    The dynamic-NTK context bound, as decoder.py:573-581 takes it: the
    caller's `ntk_ctx` (an engine that prefills into a smaller scratch
    cache than its decode cache pins one bound for both), else the cache
    capacity, else this call's key length. `sp` (parallel.ring.SeqMesh)
    goes with impl "ring" / "sp_decode" (`_block`). `moe_tally`
    (MoETally): counts the routed layers' pairs (deepseek_v2).
    """
    _check_impl(impl)
    mla = cfg.family == MLA
    if mla and (cfg.tp is not None or cfg.fsdp is not None or sp is not None
                or impl in ("ring", "sp_decode")):
        refuse_deepseek(cfg, "tensor, FSDP or sequence sharding")
    if mla and (lora is not None or remat):
        refuse_deepseek(cfg, "training (LoRA, remat)")
    ctx = ntk_ctx if ntk_ctx is not None else (
        cache["mask"].shape[-1] if cache is not None else mask4.shape[-1])
    x, cos, sin = positions_and_rope(params, cfg, input_embeds, positions,
                                     ctx=ctx)
    index = cache["index"] if cache is not None else None
    rows = cache.get("rows") if cache is not None else None
    block = _block if cfg.fsdp is None else _gathered_block
    if cache is None and torch.is_grad_enabled():
        block = _remat_wrap(block, remat)
    for i, p in enumerate(params["layers"]):
        lc = cache["layers"][i] if cache is not None else None
        la = lora["layers"][i] if lora is not None else None
        # a profiler range a layer (only while one records): keeps each
        # idle gap of the device within reach of a name in its trace
        with prof_range("decoder.layer"):
            if mla:
                x = _deepseek_block(cfg, p, x, mask4, cos, sin, lc, index,
                                    impl, moe_tally, i)
            else:
                x = block(cfg, p, x, mask4, cos, sin, lc, index, impl, la,
                          lora_scale, rows, sp)
    if cache is not None:
        cache["index"] = index + input_embeds.shape[1]
    x = _final_norm(params, cfg, x)
    if return_hidden:
        return x, cache
    return head_logits(params, cfg, x, impl=impl), cache


def _final_norm(params, cfg: DecoderConfig, x):
    """The norm before the head (decoder.py:618-624): OPT's LayerNorm only
    when `do_layer_norm_before`, else RMSNorm."""
    if cfg.family == "opt":
        return (layer_norm(params["final_norm"], x)
                if cfg.do_layer_norm_before else x)
    return rms_norm(params["final_norm"], x, eps=cfg.rms_norm_eps)


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
    tp = cfg.tp
    if tp is not None and tp.head and "lm_head" in params:
        # column-parallel head: every rank gets the whole vocabulary; with
        # grad on, x's gradient sums the ranks' columns and each rank's
        # logits take their slice of the (replicated) loss's gradient
        local = dataclasses.replace(cfg, tp=None)
        if torch.is_grad_enabled():
            x = mesh_mod.copy_to_model(x, tp.group)
        return mesh_mod.gather_from(
            head_logits(params, local, x, impl=impl), tp.group)
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
