"""Fused ESM2 encoder block: four hand-written Hopper kernels.

Port of `opus_pllm_tpu/kernels/fused_encoder.py`. The CUDA sources are
`opus_pllm_tpu_torch/csrc/fused_encoder.cu` (built and loaded by
`kernels/build.py`). Beside each kernel's wrapper stand its plain PyTorch
version (`*_plain`), which the CPU tests hold against the JAX Pallas kernel
and `chip_smoke.py` holds the kernel against, and its launch count in
`launches`.

Dispatch: a wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises. Nothing catches a failed build or
launch and falls back.

Layouts (the TPU's pair-packed (.., H/2, S, 128) tiles exist only for its
128-lane vector unit and are not carried over):
  qkv  (3, B, H, S, 64)  head-major; rope applied to q and k
  attn (B, S, H * 64)    token-major; the out projection's A operand

Source notes, per kernel (H100 SXM, bf16, at the annotate path's shapes
B=8, S<=512, E=1280, H=20, F=5120):

ln_qkv_rope
  Replaces: fused_encoder.py `fused_ln_qkv_rope` / `_ln_qkv_kernel`
  (pallas_call at :107).
  Bound: a (B*S, E) x (E, 3E) GEMM, ~40 GFLOP against ~52 MB at S=512,
  about 775 FLOP/byte: tensor-core bound.
  Design: one bf16 GEMM core with fp32 accumulation; LayerNorm applied to
  A's rows while they are staged into shared memory (statistics from a
  row-stats pre-pass, so the 30 column tiles do not each recompute them);
  bias and half-split rope in the epilogue, where a 128-wide column tile
  holds two whole heads so rotate_half stays inside the tile; q, k, v are
  written head-major for the attention kernel.
encoder_attention
  Replaces: `flash_attention_pairs` / `_flash_pairs_kernel` (pallas_call
  at :228).
  Bound: ~11 GFLOP against ~42 MB of q/k/v/out at S=512: between the two
  roofs; the (B, H, S, S) logits would be 168 MB in fp32 if materialised.
  Design: one CTA per (batch, head, 64-query block), a loop over 64-key
  blocks in place of the TPU's sequential grid axis, mma.sync m16n8k16 with
  the online softmax in registers, so logits never leave the SM. The mask
  is the (B, S) key-validity rows, read per key block; no (B, S, S) mask
  is built. A ragged last block is masked in the kernel.
out_proj
  Replaces: `fused_out_proj` / `_out_proj_kernel` (pallas_call at :380).
  Bound: ~13 GFLOP against ~35 MB: tensor-core bound.
  Design: the GEMM core with a bias + residual epilogue (one rounding),
  reading the token-major attention output directly (no relayout).
ffn
  Replaces: `fused_ffn` / `_ffn_kernel` (pallas_call at :323).
  Bound: ~107 GFLOP against ~140 MB including the gelu scratch: tensor-core
  bound.
  Design: the TPU kernel keeps an (S, E) fp32 accumulator in VMEM across
  the F loop (2.6 MB at S=512), which no CTA's 227 KB of shared memory
  holds. Here it is two launches of the GEMM core: LN prologue + FC1 + b1 +
  exact-erf gelu into a bf16 (B*S, F) scratch, then FC2 + b2 + residual.
  Both launches count as one call of the wrapper.
"""

from __future__ import annotations

import torch

from . import build

HEAD_DIM = 64

launches = {"ln_qkv_rope": 0, "encoder_attention": 0, "out_proj": 0,
            "ffn": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (fp32 arithmetic; roundings where the kernels round)
# ---------------------------------------------------------------------------

def _ln_rows(x, ln_sb, eps):
    """One-pass LayerNorm of x's rows, rounded to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    r = (xf - mu) * torch.rsqrt(var + eps) * ln_sb[0].float() \
        + ln_sb[1].float()
    return r.to(x.dtype)


def ln_qkv_rope_plain(x, w_qkv, b_qkv, ln_sb, cos, sin, *, eps=1e-5):
    """x (B, S, E); w_qkv (3, E, E); b_qkv (3, E); ln_sb (2, E) [scale;
    bias]; cos/sin (S, 64) -> qkv (3, B, H, S, 64) with rope on q and k."""
    b, s, e = x.shape
    h = e // HEAD_DIM
    r = _ln_rows(x, ln_sb, eps).float()
    y = torch.einsum("bse,jef->jbsf", r, w_qkv.float()) \
        + b_qkv.float()[:, None, None, :]
    y = y.reshape(3, b, s, h, HEAD_DIM)
    c, sn = cos.float()[:, None, :], sin.float()[:, None, :]  # (S, 1, 64)
    half = HEAD_DIM // 2
    rot = torch.cat([-y[..., half:], y[..., :half]], dim=-1)
    y = torch.cat([y[:2] * c + rot[:2] * sn, y[2:]], dim=0)
    return y.permute(0, 1, 3, 2, 4).contiguous().to(x.dtype)


def encoder_attention_plain(qkv, mask=None):
    """qkv (3, B, H, S, 64); mask (B, S) bool key rows or None ->
    (B, S, H*64). Non-causal, scale 1/8, masked logits -1e30."""
    _, b, h, s, d = qkv.shape
    q, k, v = qkv.float().unbind(0)
    logits = torch.einsum("bhqd,bhkd->bhqk", q * 0.125, k)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :], logits,
                             torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", w.to(qkv.dtype).float(), v)
    return o.permute(0, 2, 1, 3).reshape(b, s, h * d).to(qkv.dtype)


def out_proj_plain(a, w, b, x):
    """x + a @ w + b; a, x (B, S, E); w (E, E); b (E,)."""
    y = x.float() + a.float() @ w.float() + b.float()
    return y.to(x.dtype)


def ffn_plain(x, w1, b1, w2, b2, ln_sb, *, eps=1e-5):
    """x + FC2(gelu_erf(FC1(LN(x)))); gelu output rounded to x's dtype."""
    r = _ln_rows(x, ln_sb, eps).float()
    y1 = torch.nn.functional.gelu(r @ w1.float() + b1.float())
    y1 = y1.to(x.dtype).float()
    return (x.float() + b2.float() + y1 @ w2.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Wrappers: CPU tensors -> plain version; CUDA tensors -> the kernel
# ---------------------------------------------------------------------------

def _check(name, tensors, *, dtype=torch.bfloat16, device=None):
    dev = device if device is not None else tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input {tuple(t.shape)}")


def _check_width(name, e):
    if e % 128 != 0:
        raise ValueError(f"{name}: embed dim {e} must be a multiple of 128")


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch(name, device, entry, *args):
    """Call a C entry point on `device` and PyTorch's current stream there,
    count the launch, raise on a CUDA error."""
    with torch.cuda.device(device):
        rc = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    launches[name] += 1
    build.check(rc, name)


def ln_qkv_rope(x, w_qkv, b_qkv, ln_sb, cos, sin, *, eps=1e-5):
    """LN -> QKV -> rope; see ln_qkv_rope_plain for shapes."""
    if not x.is_cuda:
        return ln_qkv_rope_plain(x, w_qkv, b_qkv, ln_sb, cos, sin, eps=eps)
    b, s, e = x.shape
    _check("ln_qkv_rope", [x, w_qkv, b_qkv, ln_sb])
    _check("ln_qkv_rope", [cos, sin], dtype=torch.float32, device=x.device)
    _check_width("ln_qkv_rope", e)
    if (w_qkv.shape != (3, e, e) or b_qkv.shape != (3, e)
            or ln_sb.shape != (2, e) or cos.shape != (s, HEAD_DIM)
            or sin.shape != (s, HEAD_DIM)):
        raise ValueError("ln_qkv_rope: parameter shapes do not match x")
    lib = build.library()
    out = torch.empty((3, b, e // HEAD_DIM, s, HEAD_DIM), dtype=x.dtype,
                      device=x.device)
    stats = torch.empty((2, b * s), dtype=torch.float32, device=x.device)
    _launch("ln_qkv_rope", x.device, lib.opus_ln_qkv_rope, _ptr(x),
            _ptr(w_qkv), _ptr(b_qkv), _ptr(ln_sb), _ptr(cos), _ptr(sin),
            _ptr(out), _ptr(stats), b, s, e, eps)
    return out


def encoder_attention(qkv, mask=None):
    """Non-causal flash attention at d=64 over (B, S) key rows."""
    if not qkv.is_cuda:
        return encoder_attention_plain(qkv, mask)
    three, b, h, s, d = qkv.shape
    if three != 3 or d != HEAD_DIM:
        raise ValueError(f"encoder_attention: qkv shape {tuple(qkv.shape)}")
    _check("encoder_attention", [qkv])
    if mask is not None and (
            mask.dtype != torch.bool or mask.shape != (b, s)
            or mask.device != qkv.device or not mask.is_contiguous()):
        raise ValueError("encoder_attention: mask must be contiguous bool "
                         "(B, S) key rows on the same device")
    lib = build.library()
    out = torch.empty((b, s, h * d), dtype=qkv.dtype, device=qkv.device)
    _launch("encoder_attention", qkv.device, lib.opus_encoder_attention,
            _ptr(qkv), _ptr(mask), _ptr(out), b, h, s)
    return out


def out_proj(a, w, b, x):
    """x + a @ w + b with a residual/bias epilogue."""
    if not x.is_cuda:
        return out_proj_plain(a, w, b, x)
    bsz, s, e = x.shape
    _check("out_proj", [a, w, b, x])
    _check_width("out_proj", e)
    if a.shape != x.shape or w.shape != (e, e) or b.shape != (e,):
        raise ValueError("out_proj: shapes do not match")
    lib = build.library()
    out = torch.empty_like(x)
    _launch("out_proj", x.device, lib.opus_out_proj, _ptr(a), _ptr(w),
            _ptr(b), _ptr(x), _ptr(out), bsz * s, e)
    return out


def ffn(x, w1, b1, w2, b2, ln_sb, *, eps=1e-5):
    """x + FC2(gelu(FC1(LN(x)))): two launches of the GEMM core."""
    if not x.is_cuda:
        return ffn_plain(x, w1, b1, w2, b2, ln_sb, eps=eps)
    bsz, s, e = x.shape
    f = w1.shape[1]
    _check("ffn", [x, w1, b1, w2, b2, ln_sb])
    _check_width("ffn", e)
    if (w1.shape != (e, f) or w2.shape != (f, e) or b1.shape != (f,)
            or b2.shape != (e,) or ln_sb.shape != (2, e) or f % 128 != 0):
        raise ValueError("ffn: shapes do not match")
    lib = build.library()
    m = bsz * s
    hidden = torch.empty((m, f), dtype=x.dtype, device=x.device)
    stats = torch.empty((2, m), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    _launch("ffn", x.device, lib.opus_ffn, _ptr(x), _ptr(w1), _ptr(b1),
            _ptr(w2), _ptr(b2), _ptr(ln_sb), _ptr(hidden), _ptr(stats),
            _ptr(out), m, e, f, eps)
    return out


def supports(cfg, x, mask=None) -> bool:
    """Shapes the CUDA kernels take (the counterpart of the JAX
    `supports` + `esm2._fused_ok`): a CUDA bf16 activation, d=64 heads
    with E = H*64 a multiple of 128 (a 128-wide GEMM column tile then holds
    whole heads and never straddles q/k/v), an FFN width that tiles by 128,
    and padding masks given as (B, S) key rows. Any sequence length: the
    attention kernel masks its ragged edge."""
    b, s, e = x.shape
    return (x.is_cuda and x.dtype == torch.bfloat16
            and cfg.head_dim == HEAD_DIM and e == cfg.num_heads * HEAD_DIM
            and e % 128 == 0 and cfg.ffn_dim % 128 == 0
            and (mask is None or mask.dim() == 2)
            and -(-b * s // 128) <= 65535)
