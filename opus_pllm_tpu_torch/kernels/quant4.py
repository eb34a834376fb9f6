"""Int4 weight-only quantization (v2 layout) and its hand-written matmul.

Port of the serving side of `opus_pllm_tpu/kernels/quant4.py`:
`quantize_grouped` (:67), `pack_int4_v2` (:110), `unpack_int4_v2` (:142),
`quantize_linear4` (:158), `quant_layout_of` (:187), `int4_matmul` (:295),
`qdense4` (:418) and `quantize_decoder4` (:430). The storage layout is the
JAX package's, so `core.convert.from_jax` copies the leaves as they are:

    kernel_p  (K/8, N) int32   v2 magic-bitcast words (K % 512 == 0)
    gscale    (K/128, N) fp32  symmetric absmax/7 scale per (128-row group,
                               output column)

Word row i of 512-row superblock sb holds, per 4-bit field, the BIASED
value q + 8 of rows 2i (low half-word) and 2i+1 (high half-word) of each
of the superblock's four 128-row groups g (bits 4g and 16 + 4g), so that
((w >> 4g) & 0x000F000F) | 0x43004300, read as a bf16 pair, is 136 + q for
both rows, in order.

The v1 nibble-byte layout (the QLoRA training layout, K % 256 == 0 but
K % 512 != 0 or layout="v1") comes with the training slice: asking for it
raises NotImplementedError.

int4_matmul
  Replaces: quant4.py `_pallas_v2` / `_kernel_v2` (pallas_call at :392).
  Computes: x rounded to bf16; per 128-row group an fp32 partial sum of
  x * q; each partial times its fp32 group scale, summed in fp32; the
  result rounded once to x's dtype. (The TPU kernel folds the +136 bias out
  with sum(x) per group; here the bias is subtracted from the weight pair
  exactly, so no correction term is needed.)
  Bound (H100, M = 8): per weight element one 4-bit read from HBM and M
  fp32 FMAs. Llama-3-8B's projections plus head stream ~3.75 GB of words per
  decode step (1.1 ms at 3.35 TB/s) and need ~60 G FMA (1.8 ms at the
  67 TFLOP/s fp32 rate): fp32 CUDA-core bound at M = 8.
  Design (csrc/int4_matmul.cu): a CTA takes 64 columns (two per lane) and a
  range of superblocks; its 8 warps split each superblock's 64 word rows.
  x is staged in shared memory one superblock (8 rows x 512 fp32 = 16 KB)
  at a time, so K = 14336 never needs the whole of x on chip. Unpack: one
  shift + lop3 + one bf16x2 subtract of 136 per word and group gives two
  exact weights. Narrow outputs (o_proj N = 4096: 64 column tiles) split K
  across CTAs so that about 264 CTAs fill the 132 SMs; the split partials
  go to an fp32 workspace and a second launch sums them in a fixed order
  (deterministic, no atomics).

Shape rule: products with M > 64 rows (the annotate prefill: M = B * L =
2616) take the dequantize-to-bf16 + matmul route of the JAX `_matmul_xla`
(quant4.py:215), which is what the JAX package runs at that shape too
(2616 % 256 != 0 sends `_pallas_v2` there, :387). Decode (M = batch) and
both vocab-head calls (M = batch) go through the kernel.

Dispatch: CPU tensors, or impl="torch", take the kernel's plain version
(`int4_matmul_plain`); CUDA tensors launch the kernel or raise. Launches
are counted in `launches`.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import build

GROUP = 128   # K rows per scale group
BK = 256      # K rows per v1 block: a K that is not a multiple stays bf16
SUPER = 512   # K rows per v2 superblock (four scale groups)
KERNEL_MAX_M = 64       # larger M takes the dequantize + matmul route
KERNEL_COLS = 64        # output columns per CTA (csrc/int4_matmul.cu)
KERNEL_MT = 8           # rows of x per CTA
TARGET_CTAS = 264       # two CTAs for each of the H100's 132 SMs

_QUANT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                  "up_proj", "down_proj")    # quant.py:187, unfused llama

launches = {"int4_matmul": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _v1_refused(why: str) -> NotImplementedError:
    return NotImplementedError(
        f"{why}: the int4 v1 nibble-byte layout is the QLoRA training "
        "layout and is ported with the training slice; the port packs v2 "
        "words only (K % 512 == 0)")


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
    """dense params {kernel, bias?} -> {kernel_p, gscale, bias?} (v2), or
    None when K is not a multiple of 256 (the JAX package keeps such a
    projection unquantized)."""
    if layout not in ("auto", "v1", "v2"):
        raise ValueError(f"layout must be auto/v1/v2, got {layout!r}")
    if layout == "v1":
        raise _v1_refused('layout="v1"')
    k = p["kernel"].shape[0]
    if k % BK:
        return None
    if k % SUPER:
        raise _v1_refused(f"K={k} (the JAX package packs v1 there)")
    q, s = quantize_grouped(p["kernel"])
    out = {"kernel_p": pack_int4_v2(q), "gscale": s}
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

def _check_shapes(x, packed, gscale):
    m, k = x.shape
    k8, n = packed.shape
    if packed.dtype != torch.int32:
        raise _v1_refused(f"kernel_p of dtype {packed.dtype}")
    if k != 8 * k8 or k % SUPER or gscale.shape != (k // GROUP, n):
        raise ValueError(f"int4_matmul: x {tuple(x.shape)}, words "
                         f"{tuple(packed.shape)}, gscale "
                         f"{tuple(gscale.shape)} do not match")
    return m, k, n


def int4_matmul_plain(x, packed, gscale):
    """The kernel's function: x rounded to bf16, fp32 partial sums per
    128-row group times the fp32 group scale, one rounding to x's dtype."""
    m, k, n = _check_shapes(x, packed, gscale)
    q = unpack_int4_v2(packed).float().reshape(k // GROUP, GROUP, n)
    xg = x.to(torch.bfloat16).float().reshape(m, k // GROUP, GROUP)
    part = torch.bmm(xg.transpose(0, 1), q)                  # (K/G, M, N)
    return (part * gscale.float()[:, None, :]).sum(0).to(x.dtype)


def dequant_matmul(x, packed, gscale):
    """The JAX `_matmul_xla` route (quant4.py:215): weights dequantized to
    bf16 with the scales ROUNDED TO BF16, then one bf16 x bf16 product
    with fp32 accumulation, rounded to x's dtype."""
    _, k, n = _check_shapes(x, packed, gscale)
    w = unpack_int4_v2(packed).to(torch.bfloat16).reshape(k // GROUP, GROUP,
                                                           n)
    w = (w * gscale.to(torch.bfloat16)[:, None, :]).reshape(k, n)
    xb = x.to(torch.bfloat16)
    if xb.is_cuda:
        y = torch.mm(xb, w, out_dtype=torch.float32)
    else:
        y = xb.float() @ w.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Wrapper: shape rule, then CPU -> plain version, CUDA -> the kernel
# ---------------------------------------------------------------------------

def _splits(n_sb: int, ctas: int) -> int:
    """Split-K factor: enough CTAs to fill the card, whole superblocks per
    split, no empty split."""
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
    xb = x.to(torch.bfloat16).contiguous()
    for name, t, align in (("x", xb, 16), ("kernel_p", packed, 8),
                           ("gscale", gscale, 8)):
        if t.device != x.device:
            raise ValueError(f"int4_matmul: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"int4_matmul: {name} must be contiguous and "
                             f"{align}-byte aligned")
    n_sb = k // SUPER
    tiles = -(-n // KERNEL_COLS) * -(-m // KERNEL_MT)
    splits = _splits(n_sb, tiles)
    sb_per = -(-n_sb // splits)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    lib = build.library("int4_matmul")
    with torch.cuda.device(x.device):
        rc = lib.opus_int4_matmul(
            xb.data_ptr(), packed.data_ptr(), gscale.data_ptr(),
            ws.data_ptr() if ws is not None else None, out.data_ptr(), m, n,
            k, sb_per, splits, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    launches["int4_matmul"] += 1
    build.check(rc, "int4_matmul", lib)
    return out


def int4_matmul(x, packed, gscale, *, impl: str = "auto"):
    """x (M, K) @ int4 v2 words (K/8, N) with (K/128, N) fp32 group scales
    -> (M, N) in x's dtype. M > 64 takes `dequant_matmul` (the shape rule
    above); otherwise CPU tensors or impl="torch" take the plain version
    and CUDA tensors the kernel."""
    if x.shape[0] > KERNEL_MAX_M:
        return dequant_matmul(x, packed, gscale)
    if impl == "torch" or not x.is_cuda:
        return int4_matmul_plain(x, packed, gscale)
    return _kernel(x, packed, gscale)


def qdense4(p: Dict, x, *, impl: str = "auto"):
    """Int4 dense: folds the leading dims of x into M; a bias is added in
    fp32 and the sum rounded to x's dtype (quant4.py:418)."""
    shape = x.shape
    y = int4_matmul(x.reshape(-1, shape[-1]), p["kernel_p"], p["gscale"],
                    impl=impl).reshape(*shape[:-1], -1)
    if "bias" in p:
        y = (y.float() + p["bias"].float()).to(y.dtype)
    return y
