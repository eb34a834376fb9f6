"""Fused ESM2 encoder block: four hand-written Hopper kernels.

Port of `opus_pllm_tpu/kernels/fused_encoder.py`. The CUDA sources are
`opus_pllm_tpu_torch/csrc/fused_encoder.cu` (built and loaded by
`kernels/build.py`). Beside each kernel's wrapper stand its plain PyTorch
version (`*_plain`), which the CPU tests hold against the JAX Pallas kernel
and `chip_smoke.py` holds the kernel against, and its launch count in
`launches`.

Dispatch: a wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises. Nothing catches a failed build or
launch and falls back. ESM2 is frozen on every path (training runs it
under torch.no_grad()), so the kernels have no backward: a wrapper called
with grad mode on and an input that requires grad raises instead of
returning an output cut from the graph.

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
  Design: a LayerNorm pass (one warp per row) writes LN(x), rounded to
  bf16 as the TPU kernel rounds it, into a (B*S, E) scratch; the TMA +
  wgmma core of csrc/hopper_gemm_bf16.cuh reads it as A (K-major, 128-byte
  swizzle) and the (3, E, E) weight as an N-major B through one (3E, E)
  map, a column tile inside one of q, k, v; 384 threads (two consumer
  warpgroups of 64 rows, a producer thread filling a TMA ring), persistent
  over the tiles (`tile_width`). Bias and rotate_half rope from the
  registers (the partner column d +- 32 is the same thread's fragment
  j +- 4), staged through shared memory and stored head-major in whole
  128-byte rows for the attention kernel.
encoder_attention
  Replaces: `flash_attention_pairs` / `_flash_pairs_kernel` (pallas_call
  at :228).
  Bound: at S=512 and the annotate path's padding, ~7 GFLOP over the
  valid (query, key) pairs against ~35 MB of q, out and the valid keys'
  k and v: the bytes, slightly ahead of the tensor cores; the (B, H, S, S)
  logits would be 168 MB in fp32 if materialised.
  Design (TMA + wgmma on the pieces of csrc/hopper_attention.cuh): the
  (B, S) key mask packed into one 64-bit word per (batch row, 64-key tile)
  inside the call (`pack_key_words` models it); one CTA per (128 query
  rows, head, batch row), two consumer warpgroups, thread 0 filling a ring
  of K and V tiles by TMA from head-major tensor maps; a key tile of
  padding only is neither loaded nor computed (`key_tiles`), a full one is
  not masked; both products on wgmma, the online softmax on the fp32
  accumulators, logits never leave the SM. A masked key weighs 0 exactly:
  a batch row with no valid key gets out 0 (the TPU kernel averages v
  there; no ESM2 row lacks CLS and EOS), and `encoder_attention_plain`
  models that rule.
out_proj
  Replaces: `fused_out_proj` / `_out_proj_kernel` (pallas_call at :380).
  Bound: ~13 GFLOP against ~35 MB: tensor-core bound.
  Design: a product of the same TMA + wgmma core: A is the token-major
  attention output as encoder_attention writes it (no relayout), W_o the
  N-major B. The epilogue has FC2's arithmetic (bias and the residual
  added to the fp32 sums, one rounding) but moves its tiles by TMA: the
  producer loads the residual tile into shared memory while the tile's K
  loop runs, the consumers add in place, and the output tile leaves by a
  TMA store while the next tile's K loop runs. The tile width comes from
  `tile_width` over OUT_TILE_WIDTHS (160 at S=512, 128 at S=128; no 256,
  whose 64 KB tile buffer would leave the ring three stages).
ffn
  Replaces: `fused_ffn` / `_ffn_kernel` (pallas_call at :323).
  Bound: ~107 GFLOP against ~47 MB of inputs and outputs: tensor-core
  bound.
  Design: the TPU kernel keeps an (S, E) fp32 accumulator in VMEM across
  the F loop (2.6 MB at S=512), which no CTA's 227 KB of shared memory
  holds. Here: the LayerNorm pass of ln_qkv_rope into a (B*S, E) scratch,
  then two products of the same TMA + wgmma core: FC1 + b1 + exact-erf
  gelu, rounded to bf16 (the TPU kernel's rounding) into a (B*S, F)
  scratch, then FC2 + b2 + the residual x with one rounding. Each
  product's tile width comes from `tile_width`. The three launches count
  as one call of the wrapper.
"""

from __future__ import annotations

import torch

from . import build

HEAD_DIM = 64
KEY_TILE = 64        # keys a word of the packed mask covers
GEMM_ROWS = 128      # rows of a tile of the TMA + wgmma core
TILE_WIDTHS = (256, 128)      # the QKV product's: whole heads
FFN_TILE_WIDTHS = (256, 160, 128)
OUT_TILE_WIDTHS = (160, 128)  # out_proj's (its tile buffer)

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
    (B, S, H*64). Non-causal, scale 1/8; a masked key gets the weight 0
    exactly (its logit -1e30), and a batch row with no valid key gets out
    0, as the kernel gives it (the TPU kernel averages v there)."""
    _, b, h, s, d = qkv.shape
    q, k, v = qkv.float().unbind(0)
    logits = torch.einsum("bhqd,bhkd->bhqk", q * 0.125, k)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :], logits,
                             torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    if mask is not None:
        w = w * mask.any(-1)[:, None, None, None]
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


def _frozen(name, *tensors):
    """Raise where autograd would need a gradient through a kernel."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the fused encoder "
            "kernels have no backward (ESM2 is frozen); run the encoder "
            "under torch.no_grad()")


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch(name, device, entry, *args):
    """Call a C entry point on `device` and PyTorch's current stream there,
    count the launch, raise on a CUDA error."""
    with torch.cuda.device(device):
        rc = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    launches[name] += 1
    build.check(rc, name, build.library("fused_encoder"))


def tile_width(m, n, n_group, sms, widths=TILE_WIDTHS):
    """The column tile of the TMA + wgmma core for an (m, n) product whose
    columns come in groups of n_group (a tile never straddles one; the
    QKV product's groups are q, k and v): of `widths`, the one that
    divides n_group with the fewest rounds of `sms` persistent CTAs times
    the width, i.e. the least time if a tile takes time in proportion to
    its width; a tie goes to the wider, whose weight panels serve more
    rows."""
    best, best_cost = None, None
    for bn in widths:
        if n_group % bn:
            continue
        cost = -(-(-(-m // GEMM_ROWS) * (n // bn)) // sms) * bn
        if best is None or cost < best_cost:
            best, best_cost = bn, cost
    if best is None:
        raise ValueError(f"column group {n_group} is not a multiple of 128")
    return best


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def ln_qkv_rope(x, w_qkv, b_qkv, ln_sb, cos, sin, *, eps=1e-5):
    """LN -> QKV -> rope; see ln_qkv_rope_plain for shapes."""
    _frozen("ln_qkv_rope", x, w_qkv, b_qkv, ln_sb, cos, sin)
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
    lib = build.library("fused_encoder")
    out = torch.empty((3, b, e // HEAD_DIM, s, HEAD_DIM), dtype=x.dtype,
                      device=x.device)
    normed = torch.empty((b * s, e), dtype=x.dtype, device=x.device)
    bn = tile_width(b * s, 3 * e, e, _sms(x.device))
    _launch("ln_qkv_rope", x.device, lib.opus_ln_qkv_rope, _ptr(x),
            _ptr(w_qkv), _ptr(b_qkv), _ptr(ln_sb), _ptr(cos), _ptr(sin),
            _ptr(out), _ptr(normed), b, s, e, eps, bn)
    return out


def key_word_shape(b, s):
    """The packed key mask of `encoder_attention`: one 64-bit word per
    (batch row, 64-key tile)."""
    return (b, -(-s // KEY_TILE))


def pack_key_words(mask):
    """The kernel's packing pass in PyTorch: (B, S) bool -> (B, ceil(S /
    64)) int64, bit j of word (b, t) = mask[b, 64 t + j] (0 past S)."""
    b, s = mask.shape
    nt = key_word_shape(b, s)[1]
    bits = torch.zeros((b, nt * KEY_TILE), dtype=torch.int64,
                       device=mask.device)
    bits[:, :s] = mask.to(torch.int64)
    shifts = torch.arange(KEY_TILE, device=mask.device, dtype=torch.int64)
    return (bits.reshape(b, nt, KEY_TILE) << shifts).sum(-1)


def key_tiles(words):
    """Per (batch row, key tile) of the packed mask: 0 if no key is valid
    (the kernel loads and computes nothing), 2 if all 64 are (no
    per-element mask), else 1 (a ragged last tile is never 2: the keys
    past S are masked)."""
    return torch.where(words == 0, 0, torch.where(words == -1, 2, 1))


def encoder_attention(qkv, mask=None):
    """Non-causal flash attention at d=64 over (B, S) key rows."""
    _frozen("encoder_attention", qkv)
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
    lib = build.library("fused_encoder")
    out = torch.empty((b, s, h * d), dtype=qkv.dtype, device=qkv.device)
    words = (torch.empty(key_word_shape(b, s), dtype=torch.int64,
                         device=qkv.device) if mask is not None else None)
    _launch("encoder_attention", qkv.device, lib.opus_encoder_attention,
            _ptr(qkv), _ptr(mask), _ptr(words), _ptr(out), b, h, s)
    return out


def out_proj(a, w, b, x):
    """x + a @ w + b: one product of the TMA + wgmma core with a bias +
    residual epilogue."""
    _frozen("out_proj", a, w, b, x)
    if not x.is_cuda:
        return out_proj_plain(a, w, b, x)
    bsz, s, e = x.shape
    _check("out_proj", [a, w, b, x])
    _check_width("out_proj", e)
    if a.shape != x.shape or w.shape != (e, e) or b.shape != (e,):
        raise ValueError("out_proj: shapes do not match")
    lib = build.library("fused_encoder")
    out = torch.empty_like(x)
    m = bsz * s
    _launch("out_proj", x.device, lib.opus_out_proj, _ptr(a), _ptr(w),
            _ptr(b), _ptr(x), _ptr(out), m, e,
            tile_width(m, e, e, _sms(x.device), OUT_TILE_WIDTHS))
    return out


def ffn(x, w1, b1, w2, b2, ln_sb, *, eps=1e-5):
    """x + FC2(gelu(FC1(LN(x)))): the LayerNorm pass, then two products
    of the TMA + wgmma core."""
    _frozen("ffn", x, w1, b1, w2, b2, ln_sb)
    if not x.is_cuda:
        return ffn_plain(x, w1, b1, w2, b2, ln_sb, eps=eps)
    bsz, s, e = x.shape
    f = w1.shape[1]
    _check("ffn", [x, w1, b1, w2, b2, ln_sb])
    _check_width("ffn", e)
    if (w1.shape != (e, f) or w2.shape != (f, e) or b1.shape != (f,)
            or b2.shape != (e,) or ln_sb.shape != (2, e) or f % 128 != 0):
        raise ValueError("ffn: shapes do not match")
    lib = build.library("fused_encoder")
    m = bsz * s
    hidden = torch.empty((m, f), dtype=x.dtype, device=x.device)
    normed = torch.empty((m, e), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    sms = _sms(x.device)
    _launch("ffn", x.device, lib.opus_ffn, _ptr(x), _ptr(w1), _ptr(b1),
            _ptr(w2), _ptr(b2), _ptr(ln_sb), _ptr(hidden), _ptr(normed),
            _ptr(out), m, e, f, eps,
            tile_width(m, f, f, sms, FFN_TILE_WIDTHS),
            tile_width(m, e, e, sms, FFN_TILE_WIDTHS))
    return out


def supports(cfg, x, mask=None) -> bool:
    """Shapes the CUDA kernels take (the counterpart of the JAX
    `supports` + `esm2._fused_ok`): a CUDA bf16 activation, d=64 heads
    with E = H*64 a multiple of 128 (a GEMM column tile of 128 or 256 then
    holds whole heads and never straddles q/k/v), an FFN width that tiles
    by 128, and padding masks given as (B, S) key rows. Any sequence
    length: the products' TMA loads zero-fill the rows past B*S, the
    attention kernel masks its ragged edge."""
    b, s, e = x.shape
    return (x.is_cuda and x.dtype == torch.bfloat16
            and cfg.head_dim == HEAD_DIM and e == cfg.num_heads * HEAD_DIM
            and e % 128 == 0 and cfg.ffn_dim % 128 == 0
            and (mask is None or mask.dim() == 2))
