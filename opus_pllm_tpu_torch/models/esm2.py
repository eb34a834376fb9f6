"""ESM2 protein encoder (port of `opus_pllm_tpu/models/esm2.py`).

`tokenize` (esm2.py:39 `tokenize`, its Python path), `init` (:68), `encode`
(:191) with the token-dropout rescale and pad zeroing,
`residue_embeddings` (:225), `pooled_embedding` (:236) and `_block`
(:114). Parameters are a dict of tensors with the JAX
names, except that each layer's q/k/v projections are held packed as
"qkv" = {"kernel": (3, E, E), "bias": (3, E)}, the layout the fused
LN+QKV+rope kernel reads (the JAX `pack_qkv_params` layout).

`_block(impl=...)`: "fused" runs the four encoder kernels
(`kernels/fused_encoder.py`; their plain versions for CPU tensors),
"torch" the plain layer composition (the JAX "xla" path), and "auto" the
kernels where `fused_encoder.supports` takes the shape (a CUDA bf16
activation with d=64 heads) and the plain composition elsewhere.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.config import ESM2Config
from ..core.util import resolve_device
from ..kernels import fused_encoder
from . import layers
from .layers import (apply_rope, attention_xla, dense, embed, layer_norm,
                     padding_mask, rope_cos_sin)

ALPHABET: List[str] = [
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N",
    "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
    "<null_1>", "<mask>",
]
TOKEN_TO_ID = {t: i for i, t in enumerate(ALPHABET)}
MASK_RATIO_TRAIN = 0.15 * 0.8   # ESM2 token-dropout rescale constant


def tokenize(seqs: List[str], max_len: Optional[int] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Sequences -> (tokens (B, L) int32, lengths (B,)): <cls> seq <eos>,
    right-padded with <pad>, unknown residues -> <unk>."""
    enc = [[TOKEN_TO_ID["<cls>"]]
           + [TOKEN_TO_ID.get(c, TOKEN_TO_ID["<unk>"]) for c in s.upper()]
           + [TOKEN_TO_ID["<eos>"]] for s in seqs]
    longest = max(len(e) for e in enc)
    pad_to = max_len if max_len is not None else longest
    toks = np.full((len(enc), pad_to), TOKEN_TO_ID["<pad>"], dtype=np.int32)
    for i, e in enumerate(enc):
        e = e[:pad_to]
        toks[i, :len(e)] = e
    return toks, (toks != TOKEN_TO_ID["<pad>"]).sum(-1).astype(np.int32)


def init(cfg: ESM2Config, *, generator: torch.Generator, device=None):
    """Random parameters drawn from `generator` (esm2.py:68-90 scheme) on
    `device` (None: CUDA)."""
    device = resolve_device(device)
    dt = cfg.torch_dtype
    e = cfg.embed_dim
    kw = dict(generator=generator, device=device, dtype=dt)
    norm = lambda: layers.norm_init(e, device=device, dtype=dt, bias=True)
    params = {"embed_tokens": layers.embed_init(cfg.vocab_size, e, **kw),
              "final_norm": norm(), "layers": []}
    for _ in range(cfg.num_layers):
        q, k, v = (layers.dense_init(e, e, bias=True, **kw) for _ in range(3))
        params["layers"].append({
            "attn_norm": norm(),
            "qkv": {"kernel": torch.stack([q["kernel"], k["kernel"],
                                           v["kernel"]]),
                    "bias": torch.stack([q["bias"], k["bias"], v["bias"]])},
            "o_proj": layers.dense_init(e, e, bias=True, **kw),
            "ffn_norm": norm(),
            "fc1": layers.dense_init(e, cfg.ffn_dim, bias=True, **kw),
            "fc2": layers.dense_init(cfg.ffn_dim, e, bias=True, **kw),
        })
    return params


def _use_kernels(cfg: ESM2Config, x, mask, impl: str) -> bool:
    if impl == "fused":
        return True
    if impl == "torch":
        return False
    if impl != "auto":
        raise ValueError(f"impl must be auto|fused|torch, got {impl!r}")
    return fused_encoder.supports(cfg, x, mask)


def _ln_sb(norm):
    return torch.stack([norm["scale"], norm["bias"]])


def _block(p, cfg: ESM2Config, x, mask, cos, sin, impl: str):
    """One pre-LN encoder block. mask: (B, S) bool key rows or None."""
    b, s, e = x.shape
    h, d = cfg.num_heads, cfg.head_dim
    if _use_kernels(cfg, x, mask, impl):
        qkv = fused_encoder.ln_qkv_rope(
            x, p["qkv"]["kernel"], p["qkv"]["bias"], _ln_sb(p["attn_norm"]),
            cos, sin)
        a = fused_encoder.encoder_attention(qkv, mask)
        x = fused_encoder.out_proj(a, p["o_proj"]["kernel"],
                                   p["o_proj"]["bias"], x)
        return fused_encoder.ffn(
            x, p["fc1"]["kernel"], p["fc1"]["bias"], p["fc2"]["kernel"],
            p["fc2"]["bias"], _ln_sb(p["ffn_norm"]))
    mask4 = padding_mask(mask) if mask is not None else None
    r = layer_norm(p["attn_norm"], x)
    w, bias = p["qkv"]["kernel"], p["qkv"]["bias"]
    q, k, v = (dense({"kernel": w[j], "bias": bias[j]}, r).reshape(b, s, h, d)
               for j in range(3))
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    a = attention_xla(q, k, v, mask4).reshape(b, s, e)
    x = x + dense(p["o_proj"], a)
    r = layer_norm(p["ffn_norm"], x)
    return x + dense(p["fc2"], layers.gelu(dense(p["fc1"], r)))


def encode(params, cfg: ESM2Config, tokens, *, impl: str = "auto"):
    """tokens (B, L) int -> final-layer representations (B, L, E)."""
    pad_mask = tokens != cfg.pad_idx
    x = embed(params["embed_tokens"], tokens.clamp_min(0))
    if cfg.token_dropout:
        is_mask = (tokens == cfg.mask_idx)[..., None]
        x = torch.where(is_mask, torch.zeros_like(x), x)
        src_len = pad_mask.sum(-1, keepdim=True)
        n_mask = (tokens == cfg.mask_idx).sum(-1, keepdim=True)
        ratio = n_mask.float() / src_len.clamp_min(1)
        x = x * ((1.0 - MASK_RATIO_TRAIN) / (1.0 - ratio))[..., None].to(
            x.dtype)
    x = torch.where(pad_mask[..., None], x, torch.zeros_like(x))
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, theta=10000.0)
    for p in params["layers"]:
        x = _block(p, cfg, x, pad_mask, cos, sin, impl)
    return layer_norm(params["final_norm"], x)


def residue_embeddings(params, cfg: ESM2Config, tokens, *,
                       impl: str = "auto"):
    """Per-residue final-layer embeddings (B, L, E) fp32 and the residue
    mask (B, L) that drops BOS, EOS and padding."""
    reps = encode(params, cfg, tokens, impl=impl).float()
    lengths = (tokens != cfg.pad_idx).sum(-1)
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    return reps, (pos >= 1) & (pos < (lengths - 1)[:, None])


def pooled_embedding(params, cfg: ESM2Config, tokens, *, impl: str = "auto"):
    """Mean of final-layer reps over residues (cls/eos/pad excluded) ->
    (B, E) fp32."""
    reps, residue = residue_embeddings(params, cfg, tokens, impl=impl)
    num = torch.where(residue[..., None], reps, torch.zeros_like(reps)).sum(1)
    den = residue.sum(-1).clamp_min(1)[:, None]
    return num / den
