"""Flash attention backward: two hand-written Hopper kernels and their
plain version.

Port of `opus_pllm_tpu/kernels/flash_attention_bwd.py`. The CUDA source is
`opus_pllm_tpu_torch/csrc/flash_attention_bwd.cu` (built and loaded by
`kernels/build.py`). `kernels/flash_attention.py` calls
`flash_attention_bwd` from the backward of its autograd Function.

Math (flash_attention_bwd.py:8-14), with s = scale q.k^T, the forward's
lse (B, Hq, Sq) fp32 and delta = rowsum(dO * O) (B, Hq, Sq) fp32:
    p  = exp(s - lse), EXACTLY 0 where the mask (or causality) is false
    dp = dO.v^T;  ds = p (dp - delta) scale
    dq = ds.k;  dk = ds^T.q;  dv = p^T.dO   (dk, dv summed over the GQA group)
A query row with no valid key gets zero gradient (the TPU kernel's
convention, flash_attention_bwd.py:37-46); the XLA reference's -1e9
masking gives such rows uniform-attention gradients instead, and no loss
reads them.

flash_attention_bwd_dq
  Replaces: `_dq_kernel` (pallas_call at flash_attention_bwd.py:197).
  Bound (H100): three products per mask-true (query, key) pair, 6 D FLOP:
  at the training shape (B = 16, 519 right-padded rows, causal, Hq 32,
  D 128; ~69 M pairs a layer) ~53 GFLOP, ~54 us at 989 TFLOP/s.
flash_attention_bwd_dkv
  Replaces: `_dkv_kernel` (pallas_call at flash_attention_bwd.py:211).
  Bound: four products per pair, 8 D FLOP, ~71 GFLOP (~72 us) there.
  Design (both: see the source): TMA loads of 4-D tensor-map boxes into
  mbarrier rings fed by a producer warp, every product a wgmma (the ds and
  p operands from registers, the transposed ones read N-major); dq one CTA
  per (128 rows of up to 8 query heads sharing a K/V head, batch row)
  sweeping 64-key tiles in 32-key halves; dk/dv one CTA per (64 keys, KV
  head, batch row) sweeping the group's query heads and 64-row query
  tiles, so the GQA sum stays in fp32 registers (no per-q-head buffers, no
  atomics: deterministic); tiles whose mask is false everywhere are
  skipped; ragged tiles are zero-filled by TMA and masked (no
  block-multiple rule).

`delta` is one torch reduction, as the JAX package computes it in XLA
(flash_attention_bwd.py:155-158). On CPU tensors `flash_attention_bwd`
runs the plain version; on CUDA tensors it launches both kernels (through
`flash_attention_bwd_dq` and `flash_attention_bwd_dkv`, which take CUDA
tensors only) or raises. Launches are counted in `launches`.
"""

from __future__ import annotations

import math

import torch

from . import build

HEAD_DIMS = (64, 128)   # the kernels' template instances

launches = {"flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _delta(out, g):
    """rowsum(dO * O) in fp32, (B, Sq, Hq) -> (B, Hq, Sq)."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, mask, out, lse, g, *,
                              causal: bool = False):
    """The kernels' function in plain PyTorch, fp32 arithmetic:
    (dq, dk, dv) in the dtypes of q, k and v."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    grp = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, sq, hkv, grp, d)
    gf = g.float().reshape(b, sq, hkv, grp, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    p = torch.exp(s - lse.float().reshape(b, hkv, grp, sq)[..., None])
    keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        keep = torch.tril(keep)
    keep = keep[None, None, None]
    if mask is not None:
        keep = keep & mask[:, :, None]
    p = torch.where(keep, p, torch.zeros_like(p))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", gf, vf)
    delta = _delta(out, g).reshape(b, hkv, grp, sq)[..., None]
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(b, sq, hq, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _strides(name, t, want):
    if t.dtype != torch.bfloat16 or t.device != want or t.stride(-1) != 1 \
            or any(st % 8 for st in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"flash_attention_bwd: {name} must be bf16 on "
                         f"{want} with a contiguous head dim and 16-byte "
                         "aligned rows")
    return list(t.stride()[:3])


def _launch(name, q, k, v, mask, lse, delta, g, causal, out0, out1):
    """Check the operands and launch one of the two kernels."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if (d not in HEAD_DIMS or k.shape != (b, skv, hkv, d)
            or v.shape != k.shape or hq % hkv or g.shape != q.shape
            or lse.shape != (b, hq, sq) or lse.dtype != torch.float32
            or delta.shape != lse.shape or delta.dtype != torch.float32):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, dO {tuple(g.shape)}, lse "
                         f"{tuple(lse.shape)} {lse.dtype}, delta "
                         f"{tuple(delta.shape)} {delta.dtype}")
    strides = [st for nm, t in (("q", q), ("k", k), ("v", v), ("dO", g))
               for st in _strides(nm, t, q.device)]
    if mask is not None:
        if (mask.dtype != torch.bool or mask.device != q.device
                or mask.shape != (b, 1, sq, skv)):
            raise ValueError(f"{name}: mask must be bool (B, 1, Sq, Skv) on "
                             f"{q.device}, got {tuple(mask.shape)} "
                             f"{mask.dtype}")
        m3 = mask[:, 0]
        strides += list(m3.stride())
        # scratch: the mask packed by the entry point, 64-bit words per
        # query row and 64-key tile (dq) or per key and 64-row tile (dk/dv)
        shape = ((b, -(-skv // 64), sq) if name.endswith("dq")
                 else (b, -(-sq // 64), skv))
        words = torch.empty(shape, dtype=torch.int64, device=q.device)
    else:
        m3 = words = None
        strides += [0, 0, 0]
    lse, delta = lse.contiguous(), delta.contiguous()
    lib = build.library("flash_attention_bwd")
    entry = getattr(lib, f"opus_{name}")
    with torch.cuda.device(q.device):
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                   m3.data_ptr() if m3 is not None else None,
                   words.data_ptr() if words is not None else None,
                   lse.data_ptr(),
                   delta.data_ptr(), out0.data_ptr(),
                   out1.data_ptr() if out1 is not None else None, b, sq, skv,
                   hq, hkv, d, *strides, int(causal), 1.0 / math.sqrt(d),
                   torch.cuda.current_stream(q.device).cuda_stream)
    launches[name] += 1
    build.check(rc, name, lib)


def flash_attention_bwd_dq(q, k, v, mask, lse, delta, g, *,
                           causal: bool = False):
    """dq (B, Sq, Hq, D) bf16 through the dq kernel (CUDA tensors only)."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("flash_attention_bwd_dq", q, k, v, mask, lse, delta, g, causal,
            dq, None)
    return dq


def flash_attention_bwd_dkv(q, k, v, mask, lse, delta, g, *,
                            causal: bool = False):
    """dk and dv stacked, (2, B, Skv, Hkv, D) bf16, through the dk/dv
    kernel (CUDA tensors only)."""
    dkv = torch.empty((2, *k.shape), dtype=k.dtype, device=q.device)
    _launch("flash_attention_bwd_dkv", q, k, v, mask, lse, delta, g, causal,
            dkv[0], dkv[1])
    return dkv


def flash_attention_bwd(q, k, v, mask, out, lse, g, *, causal: bool = False):
    """Gradients (dq, dk, dv) of flash attention from its saved (out, lse).
    q, out, g (B, Sq, Hq, D); k, v (B, Skv, Hkv, D); mask (B, 1, Sq, Skv)
    bool or None; lse (B, Hq, Sq) fp32. CPU tensors: the plain version;
    CUDA tensors: one launch of each kernel."""
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, mask, out, lse, g,
                                         causal=causal)
    delta = _delta(out, g)
    dq = flash_attention_bwd_dq(q, k, v, mask, lse, delta, g, causal=causal)
    dkv = flash_attention_bwd_dkv(q, k, v, mask, lse, delta, g,
                                  causal=causal)
    return dq, dkv[0], dkv[1]
