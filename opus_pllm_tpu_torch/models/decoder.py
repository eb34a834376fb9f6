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

`use_dynamic_ntk` rescales the rope base for contexts past
`max_position_embeddings` (`layers.ntk_scaled_theta`), from the context
bound `forward` derives as the JAX function does. Projections may be bf16
("kernel"), int8 ("kernel_q", see kernels/quant.py) or int4 ("kernel_p",
see kernels/quant4.py), each on its own or fused by `fuse_projections`
into one [q|k|v] and one [gate|up] product.

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
from . import layers
from .layers import (ACTIVATIONS, apply_rope, attention, dense, embed,
                     layer_norm, lora_delta, lora_dense, ntk_scaled_theta,
                     rms_norm, rope_cos_sin)

OPT_POS_OFFSET = 2      # HF OPT learned-position offset (decoder.py:29)
FAMILIES = ("llama", "qwen2", "opt")


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
    for _ in range(cfg.num_layers):
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


def _write_cache(layer_cache, k_new, v_new, index, rows=None):
    """Write S new keys/values into the cache in place; quantized leaves
    quantize them first (decoder.py:171-214). An int index writes slots
    [index, index + S) of every row; a (B,) tensor index writes each row at
    its own slots, dropping those past the capacity, into the cache rows
    `rows` (B,) when given (the engine's chunked prefill: a group of slots
    of the pool, written in place)."""
    s = k_new.shape[1]
    per_row = isinstance(index, torch.Tensor) and index.dim() == 1
    for name, new in (("k", k_new), ("v", v_new)):
        buf = layer_cache[name]
        if isinstance(buf, dict):
            qn = _quantize_kv4(new) if "q4" in buf else _quantize_kv(new)
            for key, val in qn.items():
                if per_row:
                    _write_rows(buf[key], val, index, 2, rows)
                else:
                    buf[key][:, :, index:index + s] = val
        elif per_row:
            _write_rows(buf, new, index, 1, rows)
        else:
            buf[:, index:index + s] = new
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


def _gathered_block(cfg: DecoderConfig, p, *rest):
    """`_block` over this rank's data share of a layer (FSDP, `cfg.fsdp`):
    the layer's leaves are all-gathered over the data ranks first and die
    with the call; under remat the recompute gathers them again, on every
    rank in the same order."""
    return _block(cfg, cfg.fsdp.gather_layer(p), *rest)


def fuse_layer(lp: Dict) -> Dict:
    """One layer with q/k/v concatenated into "qkv_proj" and gate/up into
    "gateup_proj" (decoder.py:330-376): 7 projection products become 4,
    each of the remaining ones wider. bf16 ("kernel"), int8 ("kernel_q" +
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
                         ("gateup_proj", ("gate_proj", "up_proj"))):
        if all(n in lp for n in names):
            nlp[fused] = cat([lp[n] for n in names])
            for n in names:
                del nlp[n]
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
    context bound `ctx` when `use_dynamic_ntk`."""
    if cfg.family == "opt":
        return x + opt_positions(params, positions), None, None
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
            ntk_ctx: Optional[int] = None, sp=None
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
    goes with impl "ring" / "sp_decode" (`_block`).
    """
    _check_impl(impl)
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
