"""One-token decode attention over a quantized KV cache: two hand-written
Hopper kernels (one CUDA source, templated on the unpack).

Port of `opus_pllm_tpu/kernels/decode_attention.py`. The CUDA source is
`opus_pllm_tpu_torch/csrc/decode_attention.cu` (built and loaded by
`kernels/build.py`). Beside the two wrappers stand their plain PyTorch
version (`decode_attention_plain`, dequantize-then-attend, the JAX
`decode_attention_int8_reference` :253), the port's own `supports` gate and
the launch counts in `launches`.

Cache leaves are the JAX package's, head-major (models/decoder.init_cache):
  int8 {"q":  (B, Hkv, S, D) int8,   "s": (B, Hkv, S, 1) fp32}
  int4 {"q4": (B, Hkv, S, D/2) int8, "s": ...}, low nibble of byte j = d j,
       high nibble = d j + D/2
q (B, 1, Hq, D); mask4 (B, 1, 1, S) bool; out (B, 1, Hq, D) in q's dtype.

decode_attention_int8 / decode_attention_int4
  Replace: decode_attention.py `decode_attention_int8` / `_kernel`
  (pallas_call at :126) and `decode_attention_int4` / `_kernel4` (:234).
  Compute: q rounded to bf16; logits = (q . k_int) * k_scale / sqrt(D) in
  fp32; a masked slot gets the weight 0 exactly; fp32 softmax over the
  valid slots; weights * v_scale, then . v_int, divided by max(l, 1e-30).
  A row with no valid slot gets out 0 (the TPU kernel averages v over
  every slot there); no path has such a row, and the plain version models
  the rule. The TPU kernel rounds the weights to bf16 before its MXU
  product; here they keep ~16 bits (a bf16 value plus the bf16 of its
  remainder), so the product is fp32's up to ~2^-16.
  Bound: reading the valid slots of the cache once: per (row, KV head)
  D (int8) or D/2 (int4) bytes of K and of V and 8 bytes of scales a valid
  slot, and 4 * G * D FLOP a slot: 2G FLOP per byte for int8 (8 at G = 4),
  4G for int4, far below the tensor cores' ratio, so HBM bounds it. At
  the annotate shapes (B = 8, 391 slots, a few MB of valid int8 K/V a layer)
  the work is small, so filling the card and the loads in flight decide.
  Design (csrc/decode_attention.cu): the 64-slot tiles of a (row, KV head)
  are dealt in turn to a thread-block cluster of `decode_splits` CTAs (up
  to 8, about 2 CTAs an SM in all), merged through distributed shared
  memory in a fixed order (one launch, no workspace, the same bits every
  call); warp w of a CTA takes 16-slot slab w of each of its tiles, skips
  the slabs whose mask is false everywhere (a ballot over the mask bytes,
  no load), streams the rest through a 3-stage cp.async ring and runs both
  products on mma.sync with the cache widened exactly to bf16 in
  registers. Any
  capacity: the TPU kernel needs a multiple of 256 (a VMEM tiling rule,
  :65); here the ragged last slab is masked.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise. Nothing catches a failed build or launch.
"""

from __future__ import annotations

import math

import torch

from . import build

HEAD_DIMS = (64, 128)    # the kernel's template instances
MAX_GROUP = 8            # query heads per KV head
TILE = 64                # slots per tile, the unit a split takes
MAX_CLUSTER = 8          # CTAs a cluster (the portable limit)
TARGET_CTAS = 264        # two CTAs for each of the H100's 132 SMs

launches = {"decode_attention_int8": 0, "decode_attention_int4": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def supports(q, k_leaf, mask4) -> bool:
    """Shapes the kernels take: one query token, a quantized (dict) cache
    leaf, D in {64, 128}, Hq a multiple of Hkv with at most 8 query heads
    per KV head, and a broadcast (B, 1, 1, S) mask. Any capacity."""
    if not isinstance(k_leaf, dict):
        return False
    b, sq, hq, d = q.shape
    hkv = k_leaf["s"].shape[1]
    return (sq == 1 and d in HEAD_DIMS and hq % hkv == 0
            and hq // hkv <= MAX_GROUP and mask4 is not None
            and mask4.dim() == 4 and mask4.shape[1] == 1
            and mask4.shape[2] == 1)


def decode_splits(b: int, hkv: int, cap: int) -> int:
    """The kernel's CTAs a cluster: each (row, KV head)'s 64-slot tiles are
    dealt in turn to up to 8 CTAs, none without a tile, until the grid has
    about TARGET_CTAS CTAs."""
    tiles = -(-cap // TILE)
    return max(1, min(MAX_CLUSTER, tiles, -(-TARGET_CTAS // (b * hkv))))


def decode_attention_plain(q, k_leaf, v_leaf, mask4):
    """Plain version of both kernels: dequantize the cache to q's dtype,
    then grouped attention (`layers.attention_xla`); a row with no valid
    slot gets out 0, as the kernel gives it."""
    # imported here: models.decoder imports this module
    from ..models.decoder import _dequantize_kv
    from ..models.layers import attention_xla
    out = attention_xla(q, _dequantize_kv(k_leaf, q.dtype),
                        _dequantize_kv(v_leaf, q.dtype), mask4)
    return out * mask4.any(-1, keepdim=True).to(out.dtype)


def _kernel(name, q, k_leaf, v_leaf, mask4, int4):
    b, sq, hq, d = q.shape
    key = "q4" if int4 else "q"
    if key not in k_leaf or key not in v_leaf:
        raise ValueError(f"{name}: cache leaves have no {key!r} plane")
    kq, vq = k_leaf[key], v_leaf[key]
    hkv, cap = kq.shape[1], kq.shape[2]
    row = d // 2 if int4 else d
    if (sq != 1 or d not in HEAD_DIMS or hq % hkv
            or hq // hkv > MAX_GROUP):
        raise ValueError(f"{name}: q {tuple(q.shape)} with {hkv} KV heads")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: q of dtype {q.dtype}")
    mask = mask4.reshape(b, cap) if mask4.shape == (b, 1, 1, cap) else None
    if mask is None or mask.dtype != torch.bool:
        raise ValueError(f"{name}: mask must be bool (B, 1, 1, {cap})")
    qb = q.to(torch.bfloat16).contiguous()
    if qb.data_ptr() % 16:                  # the kernel reads q 8 bytes at once
        qb = qb.clone()
    planes = (("k", kq, torch.int8, (b, hkv, cap, row), 16),
              ("v", vq, torch.int8, (b, hkv, cap, row), 16),
              ("k scale", k_leaf["s"], torch.float32, (b, hkv, cap, 1), 4),
              ("v scale", v_leaf["s"], torch.float32, (b, hkv, cap, 1), 4),
              ("mask", mask, torch.bool, (b, cap), 1))
    for what, t, dt, shape, align in planes:
        if (t.device != q.device or t.dtype != dt or t.shape != shape
                or not t.is_contiguous() or t.data_ptr() % align):
            raise ValueError(f"{name}: {what} must be a contiguous, "
                             f"{align}-byte aligned {dt} {shape} on "
                             f"{q.device}")
    out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    lib = build.library("decode_attention")
    with torch.cuda.device(q.device):
        rc = lib.opus_decode_attention(
            qb.data_ptr(), kq.data_ptr(), k_leaf["s"].data_ptr(),
            vq.data_ptr(), v_leaf["s"].data_ptr(), mask.data_ptr(),
            out.data_ptr(), b, hkv, hq // hkv, cap, d, int(int4),
            int(q.dtype == torch.bfloat16), decode_splits(b, hkv, cap),
            1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    launches[name] += 1
    build.check(rc, name, lib)
    return out


def decode_attention_int8(q, k_leaf, v_leaf, mask4):
    """One-token attention over an int8 cache leaf pair."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_leaf, v_leaf, mask4)
    return _kernel("decode_attention_int8", q, k_leaf, v_leaf, mask4, False)


def decode_attention_int4(q, k_leaf, v_leaf, mask4):
    """One-token attention over a packed-int4 cache leaf pair."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_leaf, v_leaf, mask4)
    return _kernel("decode_attention_int4", q, k_leaf, v_leaf, mask4, True)
