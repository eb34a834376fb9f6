"""Grouped expert GEMM of the sparse-expert layer: one hand-written Hopper
kernel for every routed expert's product at once.

The CUDA source is `opus_pllm_tpu_torch/csrc/moe_grouped_gemm.cu` (built
and loaded by `kernels/build.py`). Beside the wrapper stand its plain
PyTorch version (`grouped_gemm_plain`, a loop over the experts, which the
CPU path runs and the card tests hold the kernel against) and its launch
count in `launches`.

The operation: the routed (token, expert) pairs sorted by expert, their
rows `x` (P, K), expert e's rows [offsets[e], offsets[e + 1]);
`w` (E, K, N) every expert's weight. Row p of the output is
x[p] @ w[e(p)], with fp32 accumulation, rounded once to bf16. An expert
with no rows computes nothing. `offsets` (E + 1,) int32 stays on the
device: the kernel reads it, the host never does, so a decode step that
routes inside a CUDA graph replays the same launch whatever the routing.
`swiglu=True` takes the fused gate|up weight of `interleave_gate_up`
(column blocks of 64 gate then 64 up columns) and writes silu(gate) * up
from the fp32 sums (P, N / 2).

Replaces no TPU kernel: the JAX package has no sparse-expert layer. Bound
on the H100 (DeepSeek-V2-Lite, 64 experts, K 2048 / 1408, N 2816 / 2048):
  decode (768 pairs, ~12 rows an expert): the weights, 1.1 GB a layer
    read once (~330 us at 3.35 TB/s); the tensor cores do 12 rows of 128;
  prefill (251k pairs, ~3,900 rows an expert): the tensor cores, ~4.4
    TFLOP a layer (~4.5 ms at 989 TFLOP/s).
Design: the persistent TMA + wgmma core of csrc/hopper_gemm_bf16.cuh (a
producer thread keeping a ring of A and W tiles full, two consumer
warpgroups of 64 rows, 128-column tiles) walks (expert, row tile, column
tile) tiles read from the device offsets: each CTA builds the experts'
tile starts in shared memory from `offsets`, so no launch depends on the
routing. A tile's A rows start at the expert's first row; rows of the
next expert that fall inside its last tile are computed and not stored.
Within an expert the row tiles vary fastest, so the CTAs in flight share
each weight panel in L2 (prefill) while the decode regime streams each
expert's panels once.
"""

from __future__ import annotations

import torch

from . import build

BLOCK = 64           # gate / up columns a block of the fused weight
TILE_N = 128         # the kernel's column tile
TILE_M = 128         # the kernel's row tile
KSTEP = 64           # K a stage

launches = {"moe_grouped_gemm": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def interleave_gate_up(gate, up):
    """(E, K, F) gate and up weights -> the fused (E, K, 2F) weight whose
    column block j (128 wide) holds gate columns 64 j .. 64 j + 63, then
    the same up columns (F % 64 == 0)."""
    e, k, f = gate.shape
    if f % BLOCK:
        raise ValueError(f"expert width {f} is not a multiple of {BLOCK}")
    return torch.stack([gate.reshape(e, k, f // BLOCK, BLOCK),
                        up.reshape(e, k, f // BLOCK, BLOCK)],
                       dim=3).reshape(e, k, 2 * f)


def _epilogue(y, swiglu: bool):
    """The fp32 sums (m, N) -> the values stored (before the rounding)."""
    if not swiglu:
        return y
    m, n = y.shape
    y = y.reshape(m, n // (2 * BLOCK), 2, BLOCK)
    g, u = y[:, :, 0], y[:, :, 1]
    return (torch.nn.functional.silu(g) * u).reshape(m, n // 2)


def grouped_gemm_plain(x, w, offsets, *, swiglu: bool = False):
    """The kernel's function, one expert at a time (reads `offsets` on the
    host): out[a:b] = epilogue(x[a:b] @ w[e]) in fp32, rounded to x's
    dtype, for each expert e's rows [a, b) = offsets[e], offsets[e + 1];
    rows past offsets[E] stay 0."""
    p, _ = x.shape
    n = w.shape[2] // 2 if swiglu else w.shape[2]
    out = x.new_zeros((p, n))
    offs = offsets.tolist()
    for e in range(w.shape[0]):
        a, b = offs[e], offs[e + 1]
        if b > a:
            out[a:b] = _epilogue(x[a:b].float() @ w[e].float(),
                                 swiglu).to(x.dtype)
    return out


def _check(x, w, offsets):
    p, k = x.shape
    e, kw, n = w.shape
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"moe_grouped_gemm: bf16 x and w, got {x.dtype}, "
                        f"{w.dtype}")
    if offsets.dtype != torch.int32 or offsets.shape != (e + 1,):
        raise ValueError(f"moe_grouped_gemm: offsets must be int32 "
                         f"({e + 1},), got {offsets.dtype} "
                         f"{tuple(offsets.shape)}")
    if kw != k or k % KSTEP or n % TILE_N:
        raise ValueError(f"moe_grouped_gemm: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}: K % {KSTEP} and N % {TILE_N} "
                         "must be 0")
    for t in (x, w, offsets):
        if t.device != x.device:
            raise ValueError("moe_grouped_gemm: tensors on two devices")
        if not t.is_contiguous():
            raise ValueError("moe_grouped_gemm: non-contiguous input")


def grouped_gemm(x, w, offsets, *, swiglu: bool = False,
                 impl: str = "auto"):
    """x (P, K) rows sorted by expert, w (E, K, N), offsets (E + 1,) int32
    -> (P, N) or, with swiglu, (P, N / 2), in x's dtype. CPU tensors or
    impl "torch": the plain version; CUDA tensors: the kernel (bf16, K %
    64 == 0, N % 128 == 0), or raise."""
    if not x.is_cuda or impl == "torch":
        return grouped_gemm_plain(x, w, offsets, swiglu=swiglu)
    _check(x, w, offsets)
    p, k = x.shape
    e, _, n = w.shape
    out = torch.empty((p, n // 2 if swiglu else n), dtype=x.dtype,
                      device=x.device)
    if p == 0:
        return out
    lib = build.library("moe_grouped_gemm")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    with torch.cuda.device(x.device):
        rc = lib.opus_moe_grouped_gemm(
            x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            p, k, n, e, int(swiglu), sms,
            torch.cuda.current_stream(x.device).cuda_stream)
    launches["moe_grouped_gemm"] += 1
    build.check(rc, "moe_grouped_gemm", lib)
    return out
