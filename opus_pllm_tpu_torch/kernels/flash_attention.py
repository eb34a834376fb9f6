"""Flash attention forward: a hand-written Hopper kernel and its plain
version.

Port of `opus_pllm_tpu/kernels/flash_attention.py`. The CUDA source is
`opus_pllm_tpu_torch/csrc/flash_attention.cu` (built and loaded by
`kernels/build.py`); the backward kernels are in `flash_attention_bwd.py`.

flash_attention
  Replaces: flash_attention.py `_flash_impl` / `_kernel` (pallas_call at
  :257, kernel body :64-115).
  Computes: GQA attention with scale 1/sqrt(D): fp32 logits, an online
  softmax with fp32 statistics over the keys each query row may attend
  (the (B, 1, Sq, Skv) bool mask true and, causal, the key index at most
  the query index), out in q's dtype and, on request, lse = m + log(l) in
  fp32, (B, Hq, Sq). A key the row may not attend has weight exactly 0.
  For a row with a valid key this is the TPU kernel's function (its -1e30
  logits weigh exp(-1e30 - m) = 0); a row with no valid key gives out 0
  and lse -1e30, where the TPU kernel averages v over whichever of its
  blocks ran (no caller reads such rows: they are padding).
  Bound (H100): 4 * D FLOP per mask-true (query, key) pair and head; at the
  serving prefill (16 x 320, the admission mask) ~16 GFLOP, 16 us at 989
  TFLOP/s, under the ~106 MB of q, k, v, mask and out (32 us at 3.35 TB/s).
  Design: see the source. TMA loads of 4-D tensor-map boxes (q, k and v
  read through their (B, S, H, D) strides, so no transpose is made) into
  an mbarrier ring fed by a producer warp; two consumer warpgroups run
  S = QK^T and O += PV as wgmma; one CTA serves 128 rows of up to 8 query
  heads that share a K/V head, so a K/V tile is loaded once for all of
  them; 64-key tiles whose mask is false everywhere are skipped; any Sq
  and Skv (TMA zero-fills the ragged tiles, which are masked).

Dispatch: `supports` is the port's gate for `models.layers.attention`:
bf16 q on CUDA, a broadcast (B, 1, Sq, Skv) bool mask or none, D % 128 ==
0 (the JAX package's performance rule; the kernel is instantiated for
D = 128, and D = 64 runs when called directly), Hq % Hkv == 0 and Sq > 1.
No block-multiple rule (the JAX gate's `sq % 256` is a Mosaic tiling rule).
`flash_attention` on CPU tensors runs the plain version; on CUDA tensors it
launches the kernel or raises. Launches are counted in `launches`.

Gradients: when grad mode is on and q, k or v requires grad, the call goes
through `_FlashFunction` (the JAX `_flash_core` custom VJP,
flash_attention.py:135-176): its forward runs the kernel (or the plain
version) with the lse and saves (q, k, v, mask, out, lse); its backward is
`flash_attention_bwd.flash_attention_bwd` (the two backward kernels on
CUDA, their plain version on CPU). Without grad no lse is computed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import build
from .flash_attention_bwd import flash_attention_bwd

NEG_LARGE = -1e30       # exp(NEG_LARGE - m) == 0 in fp32 (flash_attention.py:27)
HEAD_DIMS = (64, 128)   # the kernel's template instances

launches = {"flash_attention": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check_mask(mask):
    if mask is not None and mask.shape[1] != 1:
        raise ValueError(
            f"flash_attention takes a broadcast (B, 1, Sq, Skv) mask; got "
            f"head dim {mask.shape[1]}; use attention_xla for per-head masks")


def supports(q, k, mask) -> bool:
    """The shapes `layers.attention(impl="auto")` sends to the kernel."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    if mask is not None and (mask.dim() != 4 or mask.shape[1] != 1
                             or mask.dtype != torch.bool):
        return False
    return (q.is_cuda and q.dtype == torch.bfloat16 and d % 128 == 0
            and d in HEAD_DIMS and hq % hkv == 0 and sq > 1)


def flash_attention_plain(q, k, v, mask=None, *, causal: bool = False,
                          return_lse: bool = False,
                          block_q: Optional[int] = None,
                          block_k: Optional[int] = None):
    """The kernel's function in plain PyTorch (flash_attention.py `_kernel`
    :64-115 as one pass): fp32 logits of q * scale against k, fp32 softmax
    statistics. By default the CUDA kernel's: keys a row may not attend
    (mask false, causal above the diagonal) weigh exactly 0, so its tile
    skipping changes nothing and a row with no valid key gives out 0 and
    lse -1e30. With `block_q`/`block_k` the TPU kernel's at those blocks:
    such keys get the logit -1e30 (a row with no valid key weighs each of
    them 1) and, causal, whole KV blocks above a query block's diagonal are
    dropped. The two agree on every row with a valid key."""
    _check_mask(mask)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qf = (q.float() * scale).reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    rows = torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        keep = rows >= cols
    keep = keep[None, None, None]
    if mask is not None:
        keep = keep & mask[:, :, None]
    s = torch.where(keep, s, torch.full_like(s, NEG_LARGE))
    if block_q is None:
        m = s.amax(-1, keepdim=True)
        p = torch.where(keep, torch.exp(s - m), torch.zeros_like(s))
    else:
        if causal:
            bq, bk = min(block_q, sq), min(block_k, skv)
            ran = (rows // bq) * bq + bq - 1 >= (cols // bk) * bk
            s = torch.where(ran, s, torch.full_like(s, float("-inf")))
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / l, v.float())
    out = out.reshape(b, sq, hq, d).to(q.dtype)
    if not return_lse:
        return out
    lse = (m + torch.log(l)).reshape(b, hq, sq)
    return out, lse


def _strides(name, t, want):
    if t.dtype != torch.bfloat16 or t.device != want or t.stride(-1) != 1 \
            or any(st % 8 for st in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} must be bf16 on {want} "
                         "with a contiguous head dim and 16-byte aligned "
                         "rows")
    return t.stride()[:3]


def _kernel(q, k, v, mask, causal, return_lse):
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if (d not in HEAD_DIMS or k.shape != (b, skv, hkv, d)
            or v.shape != k.shape or hq % hkv):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    strides = [st for name, t in (("q", q), ("k", k), ("v", v))
               for st in _strides(name, t, q.device)]
    if mask is not None:
        if (mask.dtype != torch.bool or mask.device != q.device
                or mask.shape != (b, 1, sq, skv)):
            raise ValueError(f"flash_attention: mask must be bool (B, 1, "
                             f"Sq, Skv) on {q.device}, got "
                             f"{tuple(mask.shape)} {mask.dtype}")
        m3 = mask[:, 0]
        strides += list(m3.stride())
        # scratch: the mask packed by the entry point, a 64-bit word per
        # query row and 64-key tile
        words = torch.empty((b, -(-skv // 64), sq), dtype=torch.int64,
                            device=q.device)
    else:
        m3 = words = None
        strides += [0, 0, 0]
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = build.library("flash_attention")
    with torch.cuda.device(q.device):
        rc = lib.opus_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            m3.data_ptr() if m3 is not None else None,
            words.data_ptr() if words is not None else None, out.data_ptr(),
            lse.data_ptr() if lse is not None else None, b, sq, skv, hq,
            hkv, d, *strides, int(causal), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    launches["flash_attention"] += 1
    build.check(rc, "flash_attention", lib)
    return (out, lse) if return_lse else out


def _forward(q, k, v, mask, causal, return_lse):
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, mask, causal=causal,
                                     return_lse=return_lse)
    return _kernel(q, k, v, mask, causal, return_lse)


class _FlashFunction(torch.autograd.Function):
    """Forward with lse saved; backward through the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        out, lse = _forward(q, k, v, mask, causal, True)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse,
                                         g.contiguous(), causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, mask=None, *, causal: bool = False,
                    return_lse: bool = False):
    """q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D); mask (B, 1, Sq, Skv) bool
    -> out (B, Sq, Hq, D) in q's dtype [, lse (B, Hq, Sq) fp32].
    Differentiable in q, k and v (not with return_lse)."""
    _check_mask(mask)
    if (not return_lse and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return _FlashFunction.apply(q, k, v, mask, causal)
    return _forward(q, k, v, mask, causal, return_lse)
