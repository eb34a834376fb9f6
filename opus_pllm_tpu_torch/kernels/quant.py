"""Int8 weight-only quantization and its hand-written matmul.

Port of `opus_pllm_tpu/kernels/quant.py`: `quantize_per_channel` (:31),
`dequantize` (:47), `_matmul_xla` (:55, here `dequant_matmul`),
`int8_matmul` (:80), `quantize_linear` (:167), `qdense` (:176) and
`quantize_decoder` (:192). The storage layout is the JAX package's, so
`core.convert.from_jax` copies the leaves as they are:

    kernel_q  (K, N) int8   round-half-even(w / scale), clipped to +-127
    scale     (N,)   fp32   per output column: max(absmax / 127, 1e-8)

int8_matmul
  Replaces: quant.py `_int8_matmul_impl` / `_kernel` (pallas_call at :142).
  Computes: x (M, K) bf16 times the int8 weights with fp32 accumulation,
  then times scale[n] in fp32, rounded once to x's dtype.
  Bound (H100): the tensor cores. At the serving prefill (M = 16 x 320 =
  5120) a 4096 -> 14336 product is 2MNK = 0.60 TFLOP against 15 MB of
  bf16 activations and 59 MB of weights: ~8000 FLOP per byte, far above
  the ~295 FLOP/byte where 989 TFLOP/s of bf16 meets 3.35 TB/s.
  Design (csrc/int8_matmul.cu, its core in csrc/hopper_gemm.cuh): the
  transposed product out^T = W^T x^T, so that the widened weights are
  wgmma's A operand from registers and x is B from shared memory. One CTA
  per 128 weight columns x 256 x rows, two CTAs of a cluster sharing the x
  rows. A producer warp keeps a 5-stage ring of TMA loads in flight on
  mbarriers (each CTA loads half of the x box and multicasts it to both);
  two consumer warpgroups widen the raw int8 box to exact bf16 fragments
  in registers with bit tricks (|q| <= 127) and run wgmma m64n256k16 with
  fp32 accumulators in registers while the next stage is widened. So a
  dequantized W never exists in device memory; the scale multiplies the
  fp32 accumulators in the registers, one rounding, a masked store. TMA
  zero-fills ragged M, N and K. Not the int8 tensor cores: x is bf16, and
  an int8 x would compute another function.
  Tensor maps need 16-byte row strides, so that kernel takes N % 16 == 0
  (every Llama-3-8B shape; `kernel_variant`); any other N takes the
  earlier CUDA kernel, kept as `int8_matmul_unaligned` (WMMA 16x16x16 on
  32-deep tiles staged through registers, every load masked). Each has its
  own launch count, so a run shows which one its path took.

Dispatch (`int8_matmul`): the kernel's shapes are bf16 x with M >= 256
rows and K % 16 == 0 (the JAX package's M >= 256 rule, without its
M % 8 / N % 128 / K % 128 tiling rules). There, CPU tensors or
impl="torch" take the kernel's plain version (`int8_matmul_plain`) and
CUDA tensors launch one of the two kernels (`kernel_variant`) or raise.
Every other shape (decode at M = slots + 1, the vocab head at M = rows,
fp32 activations) takes `dequant_matmul`, as the JAX package takes
`_matmul_xla` there. The routes compute the same function, except that
`dequant_matmul` rounds the scale and the dequantized weights to x's
dtype. Launches are counted in `launches`. With grad on, every route
goes through `_Int8Function`, whose backward is the JAX custom VJP's dx
(quant.py:101-113), a product the JAX package computes in XLA outside
Pallas.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import build

KERNEL_MIN_M = 256     # the JAX auto-dispatch's M >= 256 (quant.py:128-130)
KERNEL_K_MULTIPLE = 16
TMA_N_MULTIPLE = 16    # the int8 rows' N bytes must be a 16-byte stride

# unfused projections (quant.py:187); the vocab head is quantized apart
_QUANT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                  "up_proj", "down_proj", "fc1", "fc2")
_FUSED = ("qkv_proj", "gateup_proj")

launches = {"int8_matmul": 0, "int8_matmul_unaligned": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Quantize (the same bytes as the JAX package)
# ---------------------------------------------------------------------------

def quantize_per_channel(w, axis: int = 0) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """fp weight (K, N) -> (int8 values, fp32 scales over the non-`axis`
    dim): s = max(absmax / 127, 1e-8), q = clip(round(w / s), -127, 127),
    rounding half to even as jnp.round."""
    w = w.float()
    scale = torch.clamp_min(w.abs().amax(dim=axis, keepdim=True) / 127.0,
                            1e-8)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(axis)


def dequantize(q, scale, axis: int = 0):
    shape = [1] * q.dim()
    for i in range(q.dim()):
        if i != axis:
            shape[i] = q.shape[i]
    return q.float() * scale.reshape(shape)


def quantize_linear(p: Dict) -> Dict:
    """dense params {kernel, bias?} -> {kernel_q, scale, bias?}."""
    q, s = quantize_per_channel(p["kernel"], axis=0)
    out = {"kernel_q": q, "scale": s}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def quantize_decoder(params: Dict) -> Dict:
    """Int8-quantize the vocab head and every projection of a decoder tree
    (embeddings and norms stay as they are), as the JAX function does.
    Fused projections (decoder.fuse_projections) are not ported."""
    out = dict(params)
    if "lm_head" in params:
        out["lm_head"] = quantize_linear(params["lm_head"])
    out["layers"] = []
    for lp in params["layers"]:
        if any(t in lp for t in _FUSED):
            raise NotImplementedError(
                "fused decoder projections (decoder.fuse_projections) are "
                "not ported yet; quantize the unfused tree")
        nlp = dict(lp)
        for t in _QUANT_TARGETS:
            if t in lp and "kernel" in lp[t]:
                nlp[t] = quantize_linear(lp[t])
        out["layers"].append(nlp)
    return out


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _check_shapes(x, wq, scale):
    m, k = x.shape
    if wq.dtype != torch.int8 or wq.dim() != 2 or wq.shape[0] != k \
            or scale.shape != (wq.shape[1],):
        raise ValueError(f"int8_matmul: x {tuple(x.shape)}, weights "
                         f"{tuple(wq.shape)} {wq.dtype}, scale "
                         f"{tuple(scale.shape)} do not match")
    return m, k, wq.shape[1]


def int8_matmul_plain(x, wq, scale):
    """The kernel's function (quant.py `_kernel` :60-75): x . q with fp32
    accumulation, times the fp32 scale, one rounding to x's dtype."""
    _check_shapes(x, wq, scale)
    y = x.float() @ wq.float()
    return (y * scale.float()).to(x.dtype)


def dequant_matmul(x, wq, scale):
    """The JAX `_matmul_xla` route (quant.py:55): w = q * scale in x's
    dtype (for bf16 x the scale and the weights ROUND to bf16), then one
    product with fp32 accumulation, rounded to x's dtype."""
    _check_shapes(x, wq, scale)
    w = wq.to(x.dtype) * scale.to(x.dtype)[None, :]
    if x.is_cuda and x.dtype != torch.float32:
        y = torch.mm(x, w, out_dtype=torch.float32)
    else:
        y = x.float() @ w.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Wrapper: shape gate, then CPU -> plain version, CUDA -> the kernel
# ---------------------------------------------------------------------------

def kernel_shape(x) -> bool:
    """The shapes the kernel takes (module docstring)."""
    m, k = x.shape
    return (x.dtype == torch.bfloat16 and m >= KERNEL_MIN_M
            and k % KERNEL_K_MULTIPLE == 0)


def kernel_variant(k: int, n: int) -> str:
    """The CUDA kernel for a (K, N) product on the kernel's shapes: the TMA
    + wgmma one where tensor maps can describe x and the weights (16-byte
    row strides: K % 8, N % 16), else the one kept for other N."""
    if k % 8 == 0 and n % TMA_N_MULTIPLE == 0:
        return "int8_matmul"
    return "int8_matmul_unaligned"


def _kernel(x, wq, scale):
    m, k, n = _check_shapes(x, wq, scale)
    if not kernel_shape(x):
        raise ValueError(f"int8_matmul kernel: x {tuple(x.shape)} "
                         f"{x.dtype} (needs bf16, M >= {KERNEL_MIN_M}, "
                         f"K % {KERNEL_K_MULTIPLE} == 0)")
    if scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul: scale of dtype {scale.dtype}")
    for name, t, align in (("x", x, 16), ("kernel_q", wq, 16),
                           ("scale", scale, 4)):
        if t.device != x.device:
            raise ValueError(f"int8_matmul: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"int8_matmul: {name} must be contiguous and "
                             f"{align}-byte aligned")
    name = kernel_variant(k, n)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = build.library("int8_matmul")
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"opus_{name}")(
            x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, n, k, torch.cuda.current_stream(x.device).cuda_stream)
    launches[name] += 1
    build.check(rc, name, lib)
    return out


def _forward(x, wq, scale, impl):
    if not kernel_shape(x):
        return dequant_matmul(x, wq, scale)
    if impl == "torch" or not x.is_cuda:
        return int8_matmul_plain(x, wq, scale)
    return _kernel(x.contiguous(), wq, scale)


class _Int8Function(torch.autograd.Function):
    """The JAX custom VJP (quant.py:91-116): the forward as dispatched, and
    dx = (g * scale) @ wq^T in fp32, rounded to x's dtype; the frozen int8
    weights and scales get no gradient."""

    @staticmethod
    def forward(ctx, x, wq, scale, impl):
        ctx.save_for_backward(wq, scale)
        ctx.x_dtype = x.dtype
        return _forward(x, wq, scale, impl)

    @staticmethod
    def backward(ctx, g):
        wq, scale = ctx.saved_tensors
        gs = g.float() * scale.float()[None, :]
        return (gs @ wq.float().t()).to(ctx.x_dtype), None, None, None


def int8_matmul(x, wq, scale, *, impl: str = "auto"):
    """x (M, K) @ int8 wq (K, N) * scale (N,) -> (M, N) in x's dtype: the
    kernel (or, on CPU tensors and with impl="torch", its plain version) on
    the kernel's shapes, `dequant_matmul` elsewhere. Differentiable in x
    (`_Int8Function`) when grad mode is on and x requires grad."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Int8Function.apply(x, wq, scale, impl)
    return _forward(x, wq, scale, impl)


def qdense(p: Dict, x, *, impl: str = "auto"):
    """Int8 dense: folds the leading dims of x into M; a bias is added in
    fp32 and the sum rounded to x's dtype (quant.py:176)."""
    shape = x.shape
    y = int8_matmul(x.reshape(-1, shape[-1]), p["kernel_q"], p["scale"],
                    impl=impl).reshape(*shape[:-1], -1)
    if "bias" in p:
        y = (y.float() + p["bias"].float()).to(y.dtype)
    return y
