"""Shared transformer building blocks (port of `opus_pllm_tpu/models/layers.py`).

Plain functions over dictionaries of tensors, with the JAX module's names
and parameter layout: a linear layer is {"kernel": (in, out), "bias":
(out,)}, an embedding {"embedding": (vocab, dim)}. Matmuls accumulate in
fp32 and softmax runs in fp32, as in the JAX module.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import flash_attention as fa
from ..kernels import quant, quant4

NEG_INF = -1e9  # large finite mask value (layers.py:20)


# ---------------------------------------------------------------------------
# Initializers (layers.py:27-41); randomness from an explicit torch.Generator
# ---------------------------------------------------------------------------

def uniform_(shape, bound: float, *, generator, device, dtype):
    """U(-bound, bound) drawn directly in `dtype` on `device` (no fp32
    transient for the multi-GB decoder weights)."""
    t = torch.empty(shape, dtype=dtype, device=device)
    t.uniform_(-bound, bound, generator=generator)
    return t


def dense_init(in_dim: int, out_dim: int, *, generator, device, dtype,
               bias: bool = False):
    """Kaiming-uniform style linear init (layers.py:27-37)."""
    bound = 1.0 / math.sqrt(in_dim)
    p = {"kernel": uniform_((in_dim, out_dim), bound, generator=generator,
                            device=device, dtype=dtype)}
    if bias:
        p["bias"] = uniform_((out_dim,), bound, generator=generator,
                             device=device, dtype=dtype)
    return p


def embed_init(vocab: int, dim: int, *, generator, device, dtype,
               std: float = 0.02):
    t = torch.empty((vocab, dim), dtype=dtype, device=device)
    t.normal_(0.0, std, generator=generator)
    return {"embedding": t}


def norm_init(dim: int, *, device, dtype, bias: bool):
    p = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if bias:
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def dense(params, x, *, impl: str = "auto"):
    """x @ kernel (+ bias) with fp32 accumulation (layers.py:48-62).

    fp32 inputs multiply in full fp32. Low-precision inputs multiply in
    their own dtype, which on CUDA and CPU accumulates in fp32 and rounds
    once; a bias is then added in fp32 and the sum rounded again.
    int8 weights ("kernel_q" + "scale") go to `quant.qdense`, int4 weights
    ("kernel_p" + "gscale") to `quant4.qdense4`; `impl` is their kernel
    choice."""
    if "kernel_q" in params:
        return quant.qdense(params, x, impl=impl)
    if "kernel_p" in params:
        return quant4.qdense4(params, x, impl=impl)
    y = torch.matmul(x, params["kernel"].to(x.dtype))
    if "bias" in params:
        y = (y.float() + params["bias"].float()).to(x.dtype)
    return y


def lora_delta(lora, x, scaling: float = 1.0):
    """The fp32 LoRA delta scaling * (x A) B (layers.py:83-99), with the
    JAX dtype chain: A rounded to x's dtype and multiplied with fp32
    accumulation into an fp32 (M, r); B rounded to x's dtype and that
    product taken in fp32 (JAX promotes fp32 x bf16 to fp32). A 3-d A
    (B, in, r) and B (B, r, out) carry one adapter per row of x (B, L, in):
    the serving bank, each slot with the adapter gathered for it."""
    a_w, b_w = lora["A"].to(x.dtype).float(), lora["B"].to(x.dtype).float()
    if a_w.dim() == 3:
        return scaling * torch.bmm(torch.bmm(x.float(), a_w), b_w)
    return scaling * ((x.float() @ a_w) @ b_w)


def lora_dense(params, lora, x, scaling: float = 1.0, *,
               impl: str = "auto"):
    """dense() plus a LoRA delta (layers.py:69-80): y = xW + scaling (xA)B,
    the delta added to the base output in fp32 and the sum rounded once to
    the base output's dtype. `lora` None (no adapter) or {"A", "B"}."""
    y = dense(params, x, impl=impl)
    if lora is None:
        return y
    return (y.float() + lora_delta(lora, x, scaling)).to(y.dtype)


def embed(params, ids):
    return params["embedding"][ids]


def rms_norm(params, x, eps: float = 1e-5):
    h = x.float()
    var = torch.mean(h * h, dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return (h * params["scale"].float()).to(x.dtype)


def layer_norm(params, x, eps: float = 1e-5):
    """One-pass statistics E[x^2] - mu^2 in fp32, clamped at 0
    (layers.py:109-126)."""
    h = x.float()
    mu = torch.mean(h, dim=-1, keepdim=True)
    musq = torch.mean(h * h, dim=-1, keepdim=True)
    var = torch.clamp(musq - mu * mu, min=0.0)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * params["scale"].float() + params["bias"].float()).to(x.dtype)


def gelu(x):
    """Exact-erf gelu (the torch / fair-esm default)."""
    return F.gelu(x, approximate="none")


def silu(x):
    return F.silu(x)


ACTIVATIONS = {                     # layers.py:129-134
    "silu": silu,
    "relu": F.relu,
    "gelu": gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


# ---------------------------------------------------------------------------
# Rotary position embeddings, half-split (GPT-NeoX) convention
# ---------------------------------------------------------------------------

def ntk_scaled_theta(theta: float, head_dim: int, context_len: int,
                     max_trained: int, alpha_floor: float = 1.0) -> float:
    """Dynamic NTK-aware rope base (layers.py:142-156): past the trained
    window, theta' = theta * s ** (d / (d - 2)), s = context_len /
    max_trained (at least alpha_floor); a host-side float."""
    if context_len <= max_trained:
        return theta
    scale = max(context_len / max_trained, alpha_floor)
    return theta * (scale ** (head_dim / (head_dim - 2)))


def rope_cos_sin(positions, head_dim: int, theta: float = 10000.0):
    """cos/sin tables (fp32) for integer positions, shape (*pos, head_dim)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=positions.device)
                                / head_dim))
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D) or (S, D). Computed in fp32."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :].float(), sin[:, :, None, :].float()
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


# YaRN (DeepSeek-V2's `DeepseekV2YarnRotaryEmbedding`, modeling_deepseek.py):
# the low frequencies interpolated by `factor`, the high ones kept, a linear
# ramp between the correction dims of beta_fast and beta_slow rotations;
# cos / sin scaled by mscale(factor, mscale) / mscale(factor, mscale_all_dim)

def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _yarn_correction_dim(rotations, dim, base, max_pos):
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) \
        / (2 * math.log(base))


def yarn_inv_freq(dim: int, base: float, factor: float, original_max: int,
                  beta_fast: float, beta_slow: float, device=None):
    """The YaRN inverse frequencies (dim / 2,) fp32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (base ** exps)
    inter = 1.0 / (factor * base ** exps)
    low = max(math.floor(_yarn_correction_dim(beta_fast, dim, base,
                                              original_max)), 0)
    high = min(math.ceil(_yarn_correction_dim(beta_slow, dim, base,
                                              original_max)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def yarn_cos_sin(positions, dim: int, base: float, factor: float,
                 original_max: int, beta_fast: float, beta_slow: float,
                 mscale: float, mscale_all_dim: float):
    """cos/sin (fp32, (*pos, dim)) of YaRN rope at integer positions."""
    inv = yarn_inv_freq(dim, base, factor, original_max, beta_fast,
                        beta_slow, device=positions.device)
    freqs = positions.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    m = yarn_get_mscale(factor, mscale) / yarn_get_mscale(factor,
                                                          mscale_all_dim)
    return torch.cos(emb) * m, torch.sin(emb) * m


def apply_rope_interleaved(x, cos, sin):
    """DeepSeek-V2's rope: the last dim's interleaved pairs (0, 1), (2, 3),
    ... regrouped as evens then odds, then the half-split rotation of
    `apply_rope` (x (B, S, H, D))."""
    b, s, h, d = x.shape
    x = x.reshape(b, s, h, d // 2, 2).transpose(3, 4).reshape(b, s, h, d)
    return apply_rope(x, cos, sin)


# ---------------------------------------------------------------------------
# Attention (layers.py:186-243)
# ---------------------------------------------------------------------------

def attention(q, k, v, mask=None, *, impl: str = "auto", group=None):
    """Grouped-query attention (layers.py:186). impl "auto" (or "fused")
    takes the flash kernel where `flash_attention.supports` holds (bf16
    CUDA tensors, a broadcast mask, D % 128 == 0, Sq > 1), as the JAX
    package takes its Pallas kernel only on the TPU; "torch" and every
    other shape take `attention_xla`. "ring" (a sequence-sharded prefill:
    q/k/v this rank's shard, `mask` the (B, S_loc) key validity) and
    "sp_decode" (replicated queries over this rank's cache shard) run
    over the sequence group `group` (parallel/ring.py, layers.py:197-210)."""
    if impl == "ring":
        from ..parallel.ring import ring_attention
        return ring_attention(q, k, v, mask, group=group, causal=True)
    if impl == "sp_decode":
        from ..parallel.ring import sharded_decode_attention
        return sharded_decode_attention(q, k, v, mask, group=group)
    if impl != "torch" and fa.supports(q, k, mask):
        return fa.flash_attention(q, k, v, mask)
    return attention_xla(q, k, v, mask)


def attention_xla(q, k, v, mask=None):
    """Grouped-query scaled dot-product attention, the plain path.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); mask: bool (B, 1|Hq, Sq,
    Skv), True = attend, masked logits set to -1e9. Logits and softmax in
    fp32 from the inputs' values; the weights are rounded to v's dtype
    before the value product, as in the JAX module."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    groups = hq // hkv
    q_ = (q * (1.0 / math.sqrt(d))).reshape(b, sq, hkv, groups, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q_.float(), k.float())
    if mask is not None:
        m = (mask[:, :, None] if mask.shape[1] == 1
             else mask.reshape(b, hkv, groups, sq, -1))
        logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def mla_attention(q, k, v, mask, scale: float):
    """Multi-head attention with its own scale and a value width other
    than the query's (latent attention decompressed: q, k (B, Sq|Skv, H,
    Dqk), v (B, Skv, H, Dv)), the plain path of `attention_xla`: logits and
    softmax in fp32, masked logits -1e9, the weights rounded to v's dtype
    before the value product. mask (B, 1, Sq, Skv) bool or None."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def causal_mask(attn_mask, sq: Optional[int] = None):
    """Padding mask (B, Skv) combined with causality -> (B, 1, Sq, Skv)."""
    b, skv = attn_mask.shape
    sq = skv if sq is None else sq
    causal = torch.tril(torch.ones((skv, skv), dtype=torch.bool,
                                   device=attn_mask.device))[-sq:]
    return attn_mask[:, None, None, :] & causal[None, None]


def padding_mask(attn_mask, sq: Optional[int] = None):
    """Bidirectional padding-only mask (B, 1, Sq, Skv)."""
    b, skv = attn_mask.shape
    sq = skv if sq is None else sq
    return attn_mask[:, None, None, :].expand(b, 1, sq, skv)
