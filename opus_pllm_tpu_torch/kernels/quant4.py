"""Int4 weight-only quantization (v1 and v2 layouts) and its hand-written
matmuls.

Port of `opus_pllm_tpu/kernels/quant4.py`: `quantize_grouped` (:67),
`pack_int4` (:83), `unpack_int4` (:98), `pack_int4_v2` (:110),
`unpack_int4_v2` (:142), `quantize_linear4` (:158), `quant_layout_of`
(:187), `_matmul_xla` (:215, here `dequant_matmul`), `int4_matmul` (:295),
`qdense4` (:418) and `quantize_decoder4` (:430). The storage layouts are
the JAX package's, so `core.convert.from_jax` copies the leaves as they
are; `kernel_p`'s dtype says which one a leaf holds:

    kernel_p  (K/2, N) int8    v1 nibble bytes (K % 256 == 0): byte row
                               b * 128 + i holds row b * 256 + i in its low
                               nibble and row b * 256 + 128 + i in its high
                               nibble, two's complement
    kernel_p  (K/8, N) int32   v2 magic-bitcast words (K % 512 == 0)
    gscale    (K/128, N) fp32  symmetric absmax/7 scale per (128-row group,
                               output column)

v2: word row i of 512-row superblock sb holds, per 4-bit field, the BIASED
value q + 8 of rows 2i (low half-word) and 2i+1 (high half-word) of each
of the superblock's four 128-row groups g (bits 4g and 16 + 4g), so that
((w >> 4g) & 0x000F000F) | 0x43004300, read as a bf16 pair, is 136 + q for
both rows, in order. `quantize_linear4(layout="auto")` packs v2 where K %
512 == 0 and v1 elsewhere; layout="v1" (the QLoRA training load,
`train-* --load-int4`) packs v1 everywhere.

Both kernels compute the same function: x rounded to bf16; per 128-row
group an fp32 partial sum of x * q; each partial times its fp32 group
scale, summed in fp32; the result rounded once to x's dtype.

int4_matmul (v2)
  Replaces: quant4.py `_pallas_v2` / `_kernel_v2` (pallas_call at :392).
  (The TPU kernel folds the +136 bias out with sum(x) per group; here the
  bias is subtracted from the weight pair exactly, so no correction term
  is needed.)
  Bound (H100, M = 8): the bytes. Llama-3-8B's projections plus head
  stream ~4.0 GB of words and scales per decode step (1.2 ms at 3.35
  TB/s) for ~64 GFLOP (0.07 ms on the tensor cores).
  Design (csrc/int4_matmul.cu): the products on the tensor cores with the
  operands swapped: each v2 word, through the bit trick above, is one
  bf16x2 A-fragment register of mma.sync m16n8k16 (two K rows of one
  group, one weight column), x^T the B operand; the K order inside a
  16-wide chunk and the column order inside an A tile are chosen so that
  the words need no shuffle and a lane reads 16 bytes of words a row. One
  accumulator set per scale group, scaled in fp32 at the superblock's end.
  A producer warp keeps an 8-stage TMA ring (64 KB) of word tiles in
  flight a CTA of 64 columns; a column tile's K is split over a thread-
  block cluster of up to 8 CTAs (`v2_plan`), whose partials are reduced
  through distributed shared memory in a fixed order: one launch, no
  workspace, deterministic. A tensor map needs N % 4 == 0
  (`v2_kernel_variant`; every Llama-3-8B shape); other even N take the
  earlier kernel, kept as `int4_matmul_unaligned` with its own launch
  count (fp32 FMAs on the CUDA cores, x staged in shared memory, a K split
  summed by a second launch from an fp32 workspace).
int4_matmul_v1
  Replaces: quant4.py `_int4_matmul_impl` / `_kernel` (pallas_call at :359).
  Bound (H100): the tensor cores at the training shape: M = 16 x 519 =
  8304, a 4096 -> 14336 product is 0.98 TFLOP (~0.99 ms at 989 TFLOP/s)
  against ~97 MB of activations and packed bytes.
  Design (csrc/int4_matmul_v1.cu, its core in csrc/hopper_gemm.cuh, shared
  with int8_matmul): the transposed product, widened weights as wgmma's A
  operand from registers. One CTA per 128 weight columns x 128 x rows; a
  producer warp keeps a 5-stage ring of TMA loads in flight on mbarriers,
  a stage being 64 byte rows (loaded once), the two x boxes of the K rows
  they hold and the block's two rows of group scales. Two consumer
  warpgroups widen the low nibbles (exact: lop3 into the 0x4300 exponent,
  minus 136), then the high ones, for wgmma m64n128k16 with fp32
  registers: each byte feeds both groups' chains, as the TPU kernel feeds
  `lo` and `hi`. Each group's fp32 partial fragment is multiplied by its
  fp32 column scales before it joins the accumulator (never folded into
  bf16 weights); TMA zero-fills ragged M and N.
  Tensor maps need 16-byte row strides, so that kernel takes N % 16 == 0
  (`v1_kernel_variant`; every Llama-3-8B shape, the vocab head included);
  other N take the earlier CUDA kernel, kept as `int4_matmul_v1_unaligned`
  (mma.sync on 32-deep tiles staged through registers, each byte read once
  per nibble, every load masked), with its own launch count.

Shape rule: v2 products with M > 64 rows (the annotate prefill: M = B * L
= 2616) take the dequantize-to-bf16 + matmul route of the JAX
`_matmul_xla` (quant4.py:215), which is what the JAX package runs at that
shape too (2616 % 256 != 0 sends `_pallas_v2` there, :387); decode (M =
batch) and both vocab-head calls take the kernel. Every v1 product takes
its kernel, at any M (the JAX TPU dispatch takes its Pallas kernel only
where M, N and K tile its blocks, quant4.py:337-353; the CUDA kernel masks
ragged tiles).

Dispatch: CPU tensors, or impl="torch", take the kernels' plain version
(`int4_matmul_plain`); CUDA tensors launch the kernel or raise. Launches
are counted in `launches`. Gradients: with grad on and x requiring grad,
`int4_matmul` goes through `_Int4Function`, whose backward is the JAX
`_int4_matmul_bwd` (quant4.py:314-324): the weights dequantized to bf16
with the scales rounded to bf16, then dx = g @ W^T with fp32 accumulation
(`torch.mm`), a product the JAX package computes outside Pallas.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.util import mm_fp32
from . import build

GROUP = 128   # K rows per scale group
BK = 256      # K rows per v1 block: a K that is not a multiple stays bf16
SUPER = 512   # K rows per v2 superblock (four scale groups)
KERNEL_MAX_M = 64       # larger M takes the dequantize + matmul route
V2_COLS = 64            # weight columns a CTA (csrc/int4_matmul.cu)
V2_MAX_CLUSTER = 8      # CTAs a cluster splitting K (the portable limit)
V2_N_MULTIPLE = 4       # a word row's 4N bytes: a 16-byte stride
KERNEL_COLS = 64        # the unaligned kernel's columns per CTA
KERNEL_MT = 8           # and rows of x per CTA
TARGET_CTAS = 264       # two CTAs for each of the H100's 132 SMs
SMS = 132

_QUANT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                  "up_proj", "down_proj")    # quant.py:187, unfused llama

TMA_N_MULTIPLE = 16     # the nibble rows' N bytes: a 16-byte stride

launches = {"int4_matmul": 0, "int4_matmul_unaligned": 0,
            "int4_matmul_v1": 0, "int4_matmul_v1_unaligned": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Quantize and pack (host side; the same bytes as the JAX package)
# ---------------------------------------------------------------------------

def quantize_grouped(w, group: int = GROUP):
    """fp weight (K, N) -> (int4-valued int8 (K, N), fp32 scales (K/G, N)).

    Symmetric absmax per (group, column): s = max(absmax / 7, 1e-8),
    q = clip(round(w / s), -7, 7), rounding half to even as jnp.round."""
    k, n = w.shape
    if k % group:
        raise ValueError(f"K={k} is not a multiple of the group {group}")
    wf = w.float().reshape(k // group, group, n)
    scale = torch.clamp_min(wf.abs().amax(dim=1, keepdim=True) / 7.0, 1e-8)
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int8)
    return q.reshape(k, n), scale.reshape(k // group, n)


def pack_int4(q):
    """int4-valued int8 (K, N) -> nibble bytes (K/2, N) int8, v1 layout:
    byte row b*128+i = (lo: row b*256+i, hi: row b*256+128+i)."""
    k, n = q.shape
    if k % BK:
        raise ValueError(f"K={k} is not a multiple of {BK}")
    blocks = q.to(torch.int32).reshape(k // BK, 2, BK // 2, n)
    packed = (blocks[:, 0] & 0xF) | ((blocks[:, 1] & 0xF) << 4)  # [0, 255]
    return packed.reshape(k // 2, n).to(torch.uint8).view(torch.int8)


def unpack_int4(packed):
    """Nibble bytes (K/2, N) -> int4-valued int8 (K, N)."""
    k2, n = packed.shape
    p = packed.to(torch.int32)
    lo = (p << 28) >> 28                          # sign-extend low nibble
    hi = p >> 4                                   # arithmetic: sign-correct
    blocks = torch.stack([lo.reshape(-1, BK // 2, n),
                          hi.reshape(-1, BK // 2, n)], dim=1)
    return blocks.reshape(2 * k2, n).to(torch.int8)


def pack_int4_v2(q):
    """int4-valued int8 (K, N) -> int32 words (K/8, N), v2 layout.

    Built in int64 (torch has little uint32) and wrapped to int32."""
    k, n = q.shape
    if k % SUPER:
        raise ValueError(f"K={k} is not a multiple of {SUPER}")
    b = q.to(torch.int64) + 8                             # [1, 15]
    blk = b.reshape(k // SUPER, 4, GROUP, n)              # [sb, g, j, n]
    e, o = blk[:, :, 0::2], blk[:, :, 1::2]               # (SB, 4, 64, n)
    word = (e[:, 0] | (e[:, 1] << 4) | (e[:, 2] << 8) | (e[:, 3] << 12)
            | (o[:, 0] << 16) | (o[:, 1] << 20) | (o[:, 2] << 24)
            | (o[:, 3] << 28)).reshape(k // 8, n)
    word = torch.where(word >= 2 ** 31, word - 2 ** 32, word)
    return word.to(torch.int32)


def unpack_int4_v2(packed):
    """int32 words (K/8, N) -> int4-valued int8 (K, N)."""
    k8, n = packed.shape
    sb = packed.reshape(k8 // 64, 64, n)
    groups = []
    for g in range(4):
        e = (sb >> (4 * g)) & 0xF                          # rows 2i
        o = (sb >> (16 + 4 * g)) & 0xF                     # rows 2i + 1
        groups.append(torch.stack([e, o], dim=2).reshape(-1, GROUP, n))
    out = torch.stack(groups, dim=1).reshape(8 * k8, n)
    return (out - 8).to(torch.int8)


def quantize_linear4(p: Dict, layout: str = "auto"):
    """dense params {kernel, bias?} -> {kernel_p, gscale, bias?}, or None
    when K is not a multiple of 256 (the JAX package keeps such a
    projection unquantized). layout "auto": v2 words where K % 512 == 0,
    else v1 bytes; "v1": v1 bytes (the training layout); "v2": v2 where
    the shape allows."""
    if layout not in ("auto", "v1", "v2"):
        raise ValueError(f"layout must be auto/v1/v2, got {layout!r}")
    k = p["kernel"].shape[0]
    if k % BK:
        return None
    q, s = quantize_grouped(p["kernel"])
    use_v2 = layout != "v1" and k % SUPER == 0
    out = {"kernel_p": pack_int4_v2(q) if use_v2 else pack_int4(q),
           "gscale": s}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def quantize_decoder4(params: Dict, layout: str = "auto") -> Dict:
    """Int4-quantize the vocab head and every projection of a decoder tree
    (embeddings and norms stay as they are), as the JAX function does."""
    out = dict(params)
    if "lm_head" in params:
        q = quantize_linear4(params["lm_head"], layout)
        if q is not None:
            out["lm_head"] = q
    out["layers"] = []
    for lp in params["layers"]:
        nlp = dict(lp)
        for t in _QUANT_TARGETS:
            if t in lp and "kernel" in lp[t]:
                q = quantize_linear4(lp[t], layout)
                if q is not None:
                    nlp[t] = q
        out["layers"].append(nlp)
    return out


def quant_layout_of(decoder_params: Dict) -> str:
    """'int4-v2' (int32 words), 'int4-v1' (int8 nibble bytes), 'int8'
    (kernel_q), else the kernel's dtype name, read off the first layer."""
    p = decoder_params["layers"][0].get("q_proj", {})
    if "kernel_p" in p:
        return "int4-v2" if p["kernel_p"].dtype == torch.int32 else "int4-v1"
    if "kernel_q" in p:
        return "int8"
    if "kernel" in p:
        return str(p["kernel"].dtype).replace("torch.", "")
    return "unknown"


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def unpack_any(packed):
    """Either layout -> int4-valued int8 (K, N), by kernel_p's dtype."""
    return (unpack_int4_v2(packed) if packed.dtype == torch.int32
            else unpack_int4(packed))


def _check_shapes(x, packed, gscale):
    m, k = x.shape
    k2, n = packed.shape
    if packed.dtype not in (torch.int32, torch.int8):
        raise TypeError(f"int4_matmul: kernel_p of dtype {packed.dtype}")
    v2 = packed.dtype == torch.int32
    if (k != (8 if v2 else 2) * k2 or k % (SUPER if v2 else BK)
            or gscale.shape != (k // GROUP, n)):
        raise ValueError(f"int4_matmul: x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)} {packed.dtype}, gscale "
                         f"{tuple(gscale.shape)} do not match")
    return m, k, n


def int4_matmul_plain(x, packed, gscale):
    """The kernels' function: x rounded to bf16, fp32 partial sums per
    128-row group times the fp32 group scale, one rounding to x's dtype.
    One group at a time, so only two (M, N) fp32 buffers live at once (the
    training shape's vocab head is M = 8304 by N = 128256)."""
    m, k, n = _check_shapes(x, packed, gscale)
    q = unpack_any(packed).float().reshape(k // GROUP, GROUP, n)
    xg = x.to(torch.bfloat16).float().reshape(m, k // GROUP, GROUP)
    s = gscale.float()
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for g in range(k // GROUP):
        acc.addcmul_(xg[:, g] @ q[g], s[g])
    return acc.to(x.dtype)


def dequantize_bf16(packed, gscale):
    """The weights as the JAX `_matmul_xla` and `_int4_matmul_bwd` build
    them: int4 values times the scales ROUNDED TO BF16, in bf16, (K, N)."""
    q = unpack_any(packed)
    k, n = q.shape
    w = q.to(torch.bfloat16).reshape(k // GROUP, GROUP, n)
    return (w * gscale.to(torch.bfloat16)[:, None, :]).reshape(k, n)


def dequant_matmul(x, packed, gscale):
    """The JAX `_matmul_xla` route (quant4.py:215): weights dequantized to
    bf16 with the scales ROUNDED TO BF16, then one bf16 x bf16 product
    with fp32 accumulation, rounded to x's dtype."""
    _check_shapes(x, packed, gscale)
    w = dequantize_bf16(packed, gscale)
    return mm_fp32(x.to(torch.bfloat16), w).to(x.dtype)


# ---------------------------------------------------------------------------
# Wrapper: shape rule, then CPU -> plain version, CUDA -> the kernel
# ---------------------------------------------------------------------------

def v2_kernel_variant(n: int) -> str:
    """The CUDA kernel for a v2 product with N columns: the tensor-core one
    where a tensor map can describe the words (16-byte row strides: N % 4),
    else the one kept for other even N."""
    if n % V2_N_MULTIPLE == 0:
        return "int4_matmul"
    return "int4_matmul_unaligned"


def v2_plan(m: int, n: int, k: int):
    """The tensor-core kernel's launch: (8-row tiles of x a CTA, CTAs a
    cluster, superblocks a CTA). With fewer tiles than SMs, a column
    tile's K is split over a cluster of up to 8 CTAs, whole superblocks
    each, none empty, until the grid has about TARGET_CTAS CTAs; with as
    many, it is not split (at 4096->14336 the split measured slower)."""
    mt = 1 if m <= 8 else 2
    n_sb = k // SUPER
    tiles = -(-n // V2_COLS) * -(-m // (8 * mt))
    want = 1 if tiles >= SMS else min(n_sb, V2_MAX_CLUSTER,
                                      -(-TARGET_CTAS // tiles))
    per = -(-n_sb // want)
    return mt, -(-n_sb // per), per


def _splits(n_sb: int, ctas: int) -> int:
    """The unaligned kernel's split-K factor: enough CTAs to fill the card,
    whole superblocks per split, no empty split."""
    want = min(n_sb, max(1, -(-TARGET_CTAS // ctas)))
    per = -(-n_sb // want)
    return -(-n_sb // per)


def _kernel(x, packed, gscale):
    m, k, n = _check_shapes(x, packed, gscale)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int4_matmul: x of dtype {x.dtype}")
    if gscale.dtype != torch.float32:
        raise TypeError(f"int4_matmul: gscale of dtype {gscale.dtype}")
    if n % 2:
        raise ValueError(f"int4_matmul: N={n} must be even")
    name = v2_kernel_variant(n)
    align = 16 if name == "int4_matmul" else 8        # TMA reads the words
    xb = x.to(torch.bfloat16).contiguous()
    for arg, t, a in (("x", xb, 16), ("kernel_p", packed, align),
                      ("gscale", gscale, align)):
        if t.device != x.device:
            raise ValueError(f"int4_matmul: {arg} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous() or t.data_ptr() % a:
            raise ValueError(f"int4_matmul: {arg} must be contiguous and "
                             f"{a}-byte aligned")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    out_bf16 = int(x.dtype == torch.bfloat16)
    lib = build.library("int4_matmul")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if name == "int4_matmul":
            mt, cs, sb_per = v2_plan(m, n, k)
            rc = lib.opus_int4_matmul(
                xb.data_ptr(), packed.data_ptr(), gscale.data_ptr(),
                out.data_ptr(), m, n, k, mt, cs, sb_per, out_bf16, stream)
        else:
            n_sb = k // SUPER
            splits = _splits(n_sb, -(-n // KERNEL_COLS) * -(-m // KERNEL_MT))
            sb_per = -(-n_sb // splits)
            ws = (torch.empty((splits, m, n), dtype=torch.float32,
                              device=x.device) if splits > 1 else None)
            rc = lib.opus_int4_matmul_unaligned(
                xb.data_ptr(), packed.data_ptr(), gscale.data_ptr(),
                ws.data_ptr() if ws is not None else None, out.data_ptr(),
                m, n, k, sb_per, splits, out_bf16, stream)
    launches[name] += 1
    build.check(rc, name, lib)
    return out


def v1_kernel_variant(n: int) -> str:
    """The CUDA kernel for a v1 product with N columns: the TMA + wgmma one
    where tensor maps can describe the packed bytes and the scales (16-byte
    row strides: N % 16), else the one kept for other N."""
    if n % TMA_N_MULTIPLE == 0:
        return "int4_matmul_v1"
    return "int4_matmul_v1_unaligned"


def _kernel_v1(x, packed, gscale):
    m, k, n = _check_shapes(x, packed, gscale)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"int4_matmul_v1: x of dtype {x.dtype}")
    if gscale.dtype != torch.float32:
        raise TypeError(f"int4_matmul_v1: gscale of dtype {gscale.dtype}")
    name = v1_kernel_variant(n)
    xb = x.to(torch.bfloat16).contiguous()
    s_align = 16 if name == "int4_matmul_v1" else 4       # TMA reads gscale
    for arg, t, align in (("x", xb, 16), ("kernel_p", packed, 16),
                          ("gscale", gscale, s_align)):
        if t.device != x.device:
            raise ValueError(f"int4_matmul_v1: {arg} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"int4_matmul_v1: {arg} must be contiguous "
                             f"and {align}-byte aligned")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = build.library("int4_matmul_v1")
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"opus_{name}")(
            xb.data_ptr(), packed.data_ptr(), gscale.data_ptr(),
            out.data_ptr(), m, n, k, int(x.dtype == torch.float32),
            torch.cuda.current_stream(x.device).cuda_stream)
    launches[name] += 1
    build.check(rc, name, lib)
    return out


def _forward(x, packed, gscale, impl):
    if packed.dtype == torch.int8:                                 # v1
        if impl == "torch" or not x.is_cuda:
            return int4_matmul_plain(x, packed, gscale)
        return _kernel_v1(x, packed, gscale)
    if x.shape[0] > KERNEL_MAX_M:
        return dequant_matmul(x, packed, gscale)
    if impl == "torch" or not x.is_cuda:
        return int4_matmul_plain(x, packed, gscale)
    return _kernel(x, packed, gscale)


class _Int4Function(torch.autograd.Function):
    """The JAX custom VJP (quant4.py:304-327): the forward as dispatched;
    dx = g @ W^T with W dequantized to bf16 (scales rounded to bf16), g
    rounded to bf16, fp32 accumulation, rounded to x's dtype. The frozen
    packed weights and scales get no gradient."""

    @staticmethod
    def forward(ctx, x, packed, gscale, impl):
        ctx.save_for_backward(packed, gscale)
        ctx.x_dtype = x.dtype
        return _forward(x, packed, gscale, impl)

    @staticmethod
    def backward(ctx, g):
        packed, gscale = ctx.saved_tensors
        w = dequantize_bf16(packed, gscale)
        dx = mm_fp32(g.to(torch.bfloat16), w.t()).to(ctx.x_dtype)
        return dx, None, None, None


def int4_matmul(x, packed, gscale, *, impl: str = "auto"):
    """x (M, K) @ int4 weights (v1 bytes (K/2, N) int8 or v2 words (K/8, N)
    int32) with (K/128, N) fp32 group scales -> (M, N) in x's dtype (the
    dispatch in the module docstring). Differentiable in x."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Int4Function.apply(x, packed, gscale, impl)
    return _forward(x, packed, gscale, impl)


def qdense4(p: Dict, x, *, impl: str = "auto"):
    """Int4 dense: folds the leading dims of x into M; a bias is added in
    fp32 and the sum rounded to x's dtype (quant4.py:418)."""
    shape = x.shape
    y = int4_matmul(x.reshape(-1, shape[-1]), p["kernel_p"], p["gscale"],
                    impl=impl).reshape(*shape[:-1], -1)
    if "bias" in p:
        y = (y.float() + p["bias"].float()).to(y.dtype)
    return y
