"""Port parity: the plain versions of the four fused-encoder kernels
(opus_pllm_tpu_torch.kernels.fused_encoder) vs the JAX Pallas kernels in
interpret mode (opus_pllm_tpu.kernels.fused_encoder); then the CUDA
kernels' own arithmetic, swept here tile by tile (the encoder attention's
key tiles; ln_qkv_rope's and ffn's LayerNorm pass, and for them and
out_proj 128-row tiles, 64-deep K steps and per-chunk epilogues), against
both, and the host-side tile plan.

ESM2 widths E=256, H=4 (d=64), S=16, B=3 with one padded row, fp32. The
tolerance is the one tests/test_fused_encoder.py:67 uses, |got - ref| /
(|ref| + 1) < 5e-5: online vs one-shot softmax and summation order differ
by fp32 conditioning only. Layouts differ on purpose (the TPU packs two
d=64 heads per 128-lane tile; the port keeps heads apart), so the test
converts: lanes [0, 64) of pair g are head 2g, lanes [64, 128) head 2g+1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opus_pllm_tpu.kernels import fused_encoder as jfe
from opus_pllm_tpu.models.layers import rope_cos_sin
from opus_pllm_tpu_torch.kernels import fused_encoder as tfe

B, S, E, H = 3, 16, 256, 4
F = 4 * E
REL = 5e-5


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(got - ref) / (np.abs(ref) + 1.0)).max())


def _pack_qkv(qkv):
    """port (3, B, H, S, 64) -> TPU pair-packed (3, B, H/2, S, 128)."""
    t, b, h, s, d = qkv.shape
    return qkv.reshape(t, b, h // 2, 2, s, d).transpose(0, 1, 2, 4, 3, 5) \
        .reshape(t, b, h // 2, s, 2 * d)


def _unpack_attn(o):
    """TPU (B, H/2, S, 128) -> port (B, S, E)."""
    b, hp, s, lanes = o.shape
    return np.asarray(o).transpose(0, 2, 1, 3).reshape(b, s, hp * lanes)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    x = rng.standard_normal((B, S, E)).astype(f32)
    mask = np.ones((B, S), bool)
    mask[1, -5:] = False
    return {
        "x": x, "mask": mask,
        "w_qkv": (rng.standard_normal((3, E, E)) / np.sqrt(E)).astype(f32),
        "b_qkv": (0.1 * rng.standard_normal((3, E))).astype(f32),
        "ln": np.stack([1 + 0.2 * rng.standard_normal(E),
                        0.1 * rng.standard_normal(E)]).astype(f32),
        "qkv": rng.standard_normal((3, B, H, S, 64)).astype(f32),
        "a": rng.standard_normal((B, S, E)).astype(f32),
        "w_o": (rng.standard_normal((E, E)) * 0.05).astype(f32),
        "b_o": (0.1 * rng.standard_normal(E)).astype(f32),
        "w1": (rng.standard_normal((E, F)) / np.sqrt(E)).astype(f32),
        "b1": (0.1 * rng.standard_normal(F)).astype(f32),
        "w2": (rng.standard_normal((F, E)) / np.sqrt(F)).astype(f32),
        "b2": (0.1 * rng.standard_normal(E)).astype(f32),
    }


def _t(a):
    return torch.from_numpy(np.array(a))


def test_ln_qkv_rope_matches_pallas(inputs):
    cos, sin = rope_cos_sin(jnp.arange(S), 64)
    with pltpu.force_tpu_interpret_mode():
        ref = jfe.fused_ln_qkv_rope(
            jnp.asarray(inputs["x"]), jnp.asarray(inputs["w_qkv"]),
            jnp.asarray(inputs["b_qkv"]), jnp.asarray(inputs["ln"]), cos, sin)
    got = tfe.ln_qkv_rope_plain(
        _t(inputs["x"]), _t(inputs["w_qkv"]), _t(inputs["b_qkv"]),
        _t(inputs["ln"]), _t(np.asarray(cos)), _t(np.asarray(sin)))
    assert got.shape == (3, B, H, S, 64)
    assert _rel_err(_pack_qkv(got.numpy()), ref) < REL


def test_encoder_attention_matches_pallas(inputs):
    qkv, mask = inputs["qkv"], inputs["mask"]
    with pltpu.force_tpu_interpret_mode():
        ref = jfe.flash_attention_pairs(jnp.asarray(_pack_qkv(qkv)),
                                        jnp.asarray(mask))
    got = tfe.encoder_attention_plain(_t(qkv), _t(mask))
    assert got.shape == (B, S, E)
    assert _rel_err(got.numpy(), _unpack_attn(ref)) < REL


def test_out_proj_matches_pallas(inputs):
    a = inputs["a"]
    packed = a.reshape(B, S, H // 2, 128).transpose(0, 2, 1, 3)
    with pltpu.force_tpu_interpret_mode():
        ref = jfe.fused_out_proj(jnp.asarray(packed), jnp.asarray(inputs["w_o"]),
                                 jnp.asarray(inputs["b_o"]),
                                 jnp.asarray(inputs["x"]))
    got = tfe.out_proj_plain(_t(a), _t(inputs["w_o"]), _t(inputs["b_o"]),
                             _t(inputs["x"]))
    assert _rel_err(got.numpy(), ref) < REL


def test_ffn_matches_pallas(inputs):
    with pltpu.force_tpu_interpret_mode():
        ref = jfe.fused_ffn(*(jnp.asarray(inputs[k]) for k in
                              ("x", "w1", "b1", "w2", "b2", "ln")))
    got = tfe.ffn_plain(*(_t(inputs[k]) for k in
                          ("x", "w1", "b1", "w2", "b2", "ln")))
    assert _rel_err(got.numpy(), ref) < REL


def test_cpu_wrappers_run_plain_versions_and_launch_nothing(inputs):
    """A CPU tensor takes the plain version; the launch counts move only
    where a kernel launches."""
    tfe.reset_launches()
    cos, sin = (_t(np.asarray(t)) for t in rope_cos_sin(jnp.arange(S), 64))
    args = (_t(inputs["x"]), _t(inputs["w_qkv"]), _t(inputs["b_qkv"]),
            _t(inputs["ln"]), cos, sin)
    torch.testing.assert_close(tfe.ln_qkv_rope(*args),
                               tfe.ln_qkv_rope_plain(*args), rtol=0, atol=0)
    qkv, mask = _t(inputs["qkv"]), _t(inputs["mask"])
    torch.testing.assert_close(tfe.encoder_attention(qkv, mask),
                               tfe.encoder_attention_plain(qkv, mask),
                               rtol=0, atol=0)
    assert tfe.launches == {k: 0 for k in tfe.launches}


def test_supports_requires_cuda_bf16_d64():
    from opus_pllm_tpu_torch.core.config import ESM2Config
    cfg = ESM2Config(num_layers=1, embed_dim=256, num_heads=4)
    x = torch.zeros((2, 16, 256), dtype=torch.bfloat16)
    assert not tfe.supports(cfg, x)            # CPU tensor
    assert not tfe.supports(ESM2Config(embed_dim=256, num_heads=8), x)


# ---------------------------------------------------------------------------
# encoder_attention's key mask: the kernel's words and its rule for a batch
# row with no valid key
# ---------------------------------------------------------------------------

S_RAGGED = 70            # not a multiple of the kernel's 64-key tiles


def _ragged_inputs():
    """B = 4 rows of 70 keys: unpadded, ragged, length 1, no valid key."""
    rng = np.random.default_rng(1)
    qkv = rng.standard_normal((3, 4, H, S_RAGGED, 64)).astype(np.float32)
    mask = np.zeros((4, S_RAGGED), bool)
    mask[0] = True
    mask[1, :37] = True
    mask[2, 0] = True
    return qkv, mask


def test_encoder_attention_plain_matches_pallas_on_rows_with_a_key():
    """At S = 70 the plain version is the Pallas kernel (interpret mode) on
    every batch row with a valid key; the row without one gets out 0 (the
    TPU kernel averages v there)."""
    qkv, mask = _ragged_inputs()
    with pltpu.force_tpu_interpret_mode():
        ref = jfe.flash_attention_pairs(jnp.asarray(_pack_qkv(qkv)),
                                        jnp.asarray(mask))
    got = tfe.encoder_attention_plain(_t(qkv), _t(mask)).numpy()
    ref = _unpack_attn(ref)
    assert _rel_err(got[:3], ref[:3]) < REL
    assert not np.any(got[3])
    assert np.any(ref[3])


def test_pack_key_words_matches_the_mask_bits():
    """Bit j of word (b, t) is mask[b, 64 t + j]; bits past S are 0."""
    rng = np.random.default_rng(2)
    for s in (1, 63, 64, 70, 129, 512):
        mask = rng.random((3, s)) < 0.7
        mask[1] = True
        words = tfe.pack_key_words(_t(mask)).numpy().view(np.uint64)
        assert words.shape == tfe.key_word_shape(3, s) == (3, -(-s // 64))
        for b in range(3):
            for t in range(words.shape[1]):
                bits = [(int(words[b, t]) >> j) & 1 for j in range(64)]
                want = [int(64 * t + j < s and mask[b, 64 * t + j])
                        for j in range(64)]
                assert bits == want


def test_key_tiles_skip_padding_and_mask_only_partial_tiles():
    """0: a tile of padding only (not loaded); 2: all 64 keys valid (no
    per-element mask); 1: the rest, a ragged last tile included."""
    mask = np.zeros((3, 130), bool)
    mask[0] = True
    mask[1, :70] = True
    kinds = tfe.key_tiles(tfe.pack_key_words(_t(mask))).tolist()
    assert kinds == [[2, 2, 1], [2, 1, 0], [0, 0, 0]]


def _sweep_like_the_kernel(qkv, mask):
    """encoder_attention as the CUDA kernel runs it, in fp64: per query
    row, the 64-key tiles whose word is not 0, in order, an online softmax
    in base 2 over the valid keys of each (p = 0 exactly elsewhere), out =
    acc / max(l, 1e-30)."""
    _, b, h, s, d = qkv.shape
    words = tfe.pack_key_words(_t(mask))
    kinds = tfe.key_tiles(words).numpy()
    q, k, v = (qkv[i].astype(np.float64) for i in range(3))
    log2e = 1.0 / np.log(2.0)
    out = np.zeros((b, s, h, d))
    for bi in range(b):
        m_run = np.full((h, s), -1e30)
        l_run = np.zeros((h, s))
        acc = np.zeros((h, s, d))
        for t in range(kinds.shape[1]):
            if kinds[bi, t] == 0:
                continue
            keys = slice(64 * t, min(64 * t + 64, s))
            x = np.einsum("hqd,hkd->hqk", q[bi], k[bi, :, keys]) \
                * 0.125 * log2e
            if kinds[bi, t] == 1:
                x = np.where(mask[bi, keys][None, None], x, -np.inf)
            m_new = np.maximum(m_run, x.max(-1))
            alpha = np.exp2(m_run - m_new)
            p = np.exp2(x - m_new[..., None])
            l_run = l_run * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + np.einsum(
                "hqk,hkd->hqd", p, v[bi, :, keys])
            m_run = m_new
        out[bi] = (acc / np.maximum(l_run, 1e-30)[..., None]).transpose(
            1, 0, 2)
    return out.reshape(b, s, h * d)


def test_kernel_sweep_matches_the_plain_version_on_every_row():
    """Skipping padding tiles and unmasked full tiles computes the plain
    version's function, the no-valid-key row (out 0) included."""
    qkv, mask = _ragged_inputs()
    got = _sweep_like_the_kernel(qkv, mask)
    ref = tfe.encoder_attention_plain(_t(qkv), _t(mask)).numpy()
    assert _rel_err(got, ref) < REL
    assert not np.any(got[3])


# ---------------------------------------------------------------------------
# ln_qkv_rope and ffn as the CUDA kernels compute them: the LayerNorm pass
# rounded to bf16, then the TMA + wgmma core's 128-row tiles (ragged M),
# 64-deep K steps and per-64-column epilogues
# ---------------------------------------------------------------------------

B2, S2, E2, F2 = 2, 70, 256, 512          # M = 140: a ragged second row tile
GROUP_TILES_M = 8                          # the core's grouped tile order


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16() \
        .float().numpy()


def _ln_pass(x, ln, eps=1e-5):
    """ln_rows_kernel: fp32 row sums, the one-pass variance, r in bf16."""
    mu = x.sum(-1, keepdims=True, dtype=np.float32) / np.float32(x.shape[-1])
    ex2 = (x * x).sum(-1, keepdims=True, dtype=np.float32) \
        / np.float32(x.shape[-1])
    rstd = np.float32(1) / np.sqrt(np.maximum(ex2 - mu * mu, 0) +
                                   np.float32(eps))
    return _bf16((x - mu) * rstd * ln[0] + ln[1])


def _tile_order(m, n, bn):
    """The core's grouped order: 8 row tiles share each column sweep."""
    tiles_m, tiles_n = -(-m // tfe.GEMM_ROWS), n // bn
    order = []
    for t in range(tiles_m * tiles_n):
        first = (t // (GROUP_TILES_M * tiles_n)) * GROUP_TILES_M
        rows = min(tiles_m - first, GROUP_TILES_M)
        within = t % (GROUP_TILES_M * tiles_n)
        order.append(((first + within % rows) * tfe.GEMM_ROWS,
                      (within // rows) * bn))
    return order


def _sweep(a, w, bn, group_cols, epilogue):
    """out tiles of a (M, K) . W, W's columns in groups of group_cols
    (group j's K rows start at j K of w's (groups * K, group_cols) view):
    per 128 x bn tile, rows past M zero (TMA's fill), fp32 sums over
    64-deep K steps, then epilogue(chunk, rows, first column) for each
    64-column chunk (the last of a 160-wide tile: 32) of the rows below
    M."""
    m, k = a.shape
    n = w.shape[0] // k * group_cols
    tiles_m = -(-m // tfe.GEMM_ROWS)
    pad = np.zeros((tiles_m * tfe.GEMM_ROWS, k), np.float32)
    pad[:m] = a
    for m0, n0 in _tile_order(m, n, bn):
        grp = n0 // group_cols
        cols = slice(n0 - grp * group_cols, n0 - grp * group_cols + bn)
        acc = np.zeros((tfe.GEMM_ROWS, bn), np.float32)
        for k0 in range(0, k, 64):
            acc += pad[m0:m0 + tfe.GEMM_ROWS, k0:k0 + 64] \
                @ w[grp * k + k0:grp * k + k0 + 64, cols]
        rows = np.arange(m0, min(m0 + tfe.GEMM_ROWS, m))
        for c in range(0, bn, 64):
            epilogue(acc[:len(rows), c:c + 64], rows, n0 + c)


def _ln_qkv_rope_sweep(x, w_qkv, b_qkv, ln, cos, sin, bn):
    """(B, S, E) -> (3, B, H, S, 64) the kernel's way: bias, rope on q and
    k with fragment f < 4 (columns 8 f .. 8 f + 7 of a head) taking its
    partner f + 4 (d + 32) and back, bf16, stored head-major."""
    b, s, e = x.shape
    out = np.zeros((3, b, e // 64, s, 64), np.float32)
    bias = b_qkv.reshape(-1)

    def epilogue(v, rows, n):
        v = v + bias[n:n + 64]
        j, h = n // e, (n % e) // 64
        if j < 2:
            frag = v.reshape(len(rows), 8, 8)
            c = cos[rows % s].reshape(len(rows), 8, 8)
            sn = sin[rows % s].reshape(len(rows), 8, 8)
            lo, hi = frag[:, :4], frag[:, 4:]
            v = np.concatenate([lo * c[:, :4] - hi * sn[:, :4],
                                hi * c[:, 4:] + lo * sn[:, 4:]], 1) \
                .reshape(len(rows), 64)
        out[j, rows // s, h, rows % s] = _bf16(v)

    _sweep(_ln_pass(x.reshape(b * s, e), ln), w_qkv.reshape(3 * e, e), bn,
           e, epilogue)
    return out


def _ffn_sweep(x, w1, b1, w2, b2, ln, bn1, bn2):
    """FC1 + b1 + erf gelu rounded to bf16 into the hidden scratch, then
    FC2 + b2 in fp32 plus the residual x, rounded once."""
    b, s, e = x.shape
    xm = x.reshape(b * s, e)
    hidden = np.zeros((b * s, w1.shape[1]), np.float32)
    out = np.zeros_like(xm)

    def fc1(v, rows, n):
        cols = slice(n, n + v.shape[1])
        v = torch.from_numpy(v + b1[cols])
        hidden[rows, cols] = _bf16(torch.nn.functional.gelu(v).numpy())

    def fc2(v, rows, n):
        cols = slice(n, n + v.shape[1])
        out[rows, cols] = _bf16((v + b2[cols]) + xm[rows, cols])

    _sweep(_ln_pass(xm, ln), w1, bn1, w1.shape[1], fc1)
    _sweep(hidden, w2, bn2, e, fc2)
    return out.reshape(b, s, e)


@pytest.fixture(scope="module")
def bf16_inputs():
    """E=256, F=512, S=70, B=2: every value bf16, as the kernels take it."""
    rng = np.random.default_rng(3)
    n = lambda *shape, scale=1.0: _bf16(scale * rng.standard_normal(shape))
    return {
        "x": n(B2, S2, E2), "w_qkv": n(3, E2, E2, scale=E2 ** -0.5),
        "b_qkv": n(3, E2, scale=0.1),
        "ln": _bf16(np.stack([1 + 0.2 * rng.standard_normal(E2),
                              0.1 * rng.standard_normal(E2)])),
        "w1": n(E2, F2, scale=E2 ** -0.5), "b1": n(F2, scale=0.1),
        "w2": n(F2, E2, scale=F2 ** -0.5), "b2": n(E2, scale=0.1),
    }


def _bf(a):
    return torch.from_numpy(np.array(a, np.float32)).bfloat16()


def _ulps(got, ref):
    """|got - ref| in units of ref's bf16 spacing (2^-7 of its binade)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2 ** -20)))
                      - 7)
    return float((np.abs(got - ref) / spacing).max())


# The sweep and its references round to bf16 at the same points (LN, the
# gelu hidden, the output) and differ only in fp32 summation order, which
# can move a value across a rounding boundary: at most 2 bf16 spacings of
# the output (an output rounding, plus an LN or hidden element one spacing
# off carried through the product), and 0.01 absolute for outputs near 0.
MAX_ULPS, ATOL_SWEEP = 2.0, 1e-2


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    big = np.abs(ref) > 0.5
    assert _ulps(got[big], ref[big]) <= MAX_ULPS
    assert np.abs(got - ref)[~big].max() <= ATOL_SWEEP


@pytest.mark.parametrize("bn", tfe.TILE_WIDTHS)
def test_ln_qkv_rope_sweep_matches_pallas_and_plain(bf16_inputs, bn):
    d = bf16_inputs
    cos, sin = rope_cos_sin(jnp.arange(S2), 64)
    cos, sin = np.asarray(cos, np.float32), np.asarray(sin, np.float32)
    got = _ln_qkv_rope_sweep(d["x"], d["w_qkv"], d["b_qkv"], d["ln"], cos,
                             sin, bn)
    with pltpu.force_tpu_interpret_mode():
        ref = jfe.fused_ln_qkv_rope(
            *(jnp.asarray(d[k], jnp.bfloat16)
              for k in ("x", "w_qkv", "b_qkv", "ln")),
            jnp.asarray(cos), jnp.asarray(sin))
    _close(_pack_qkv(got), np.asarray(ref, np.float32))
    plain = tfe.ln_qkv_rope_plain(
        *(_bf(d[k]) for k in ("x", "w_qkv", "b_qkv", "ln")),
        _t(cos), _t(sin))
    _close(got, plain.float().numpy())


@pytest.mark.parametrize("bn1,bn2", [(128, 128), (256, 128), (256, 256)])
def test_ffn_sweep_matches_pallas_and_plain(bf16_inputs, bn1, bn2):
    d = bf16_inputs
    keys = ("x", "w1", "b1", "w2", "b2", "ln")
    got = _ffn_sweep(*(d[k] for k in keys), bn1, bn2)
    with pltpu.force_tpu_interpret_mode():
        ref = jfe.fused_ffn(*(jnp.asarray(d[k], jnp.bfloat16) for k in keys))
    _close(got, np.asarray(ref, np.float32))
    plain = tfe.ffn_plain(*(_bf(d[k]) for k in keys))
    _close(got, plain.float().numpy())


def test_ffn_sweep_at_160_wide_tiles_matches_pallas_and_plain():
    """E = F = 640: both products at the 160-wide tile (a last chunk of 32
    columns), ragged M = 140."""
    rng = np.random.default_rng(4)
    n = lambda *shape, scale=1.0: _bf16(scale * rng.standard_normal(shape))
    e = f = 640
    args = (n(B2, S2, e), n(e, f, scale=e ** -0.5), n(f, scale=0.1),
            n(f, e, scale=f ** -0.5), n(e, scale=0.1),
            _bf16(np.stack([1 + 0.2 * rng.standard_normal(e),
                            0.1 * rng.standard_normal(e)])))
    got = _ffn_sweep(*args, 160, 160)
    with pltpu.force_tpu_interpret_mode():
        ref = jfe.fused_ffn(*(jnp.asarray(a, jnp.bfloat16) for a in args))
    _close(got, np.asarray(ref, np.float32))
    _close(got, tfe.ffn_plain(*(_bf(a) for a in args)).float().numpy())


def _out_proj_sweep(a, w, b, x, bn):
    """The out projection the kernel's way: the token-major (M, E)
    attention output as A; its epilogue has FC2's arithmetic (b added to
    the fp32 sums, then the residual x, rounded once)."""
    bsz, s, e = x.shape
    xm = x.reshape(bsz * s, e)
    out = np.zeros_like(xm)

    def epilogue(v, rows, n):
        cols = slice(n, n + v.shape[1])
        out[rows, cols] = _bf16((v + b[cols]) + xm[rows, cols])

    _sweep(a.reshape(bsz * s, e), w, bn, e, epilogue)
    return out.reshape(bsz, s, e)


@pytest.mark.parametrize("e,bn", [(256, 128), (640, 128), (640, 160)])
def test_out_proj_sweep_matches_pallas_and_plain(e, bn):
    """B = 2, S = 70 (M = 140: a ragged second row tile), K = E in 64-deep
    steps; at E = 640 the 160-wide tile ends in a chunk of 32 columns."""
    rng = np.random.default_rng(5)
    n = lambda *shape, scale=1.0: _bf16(scale * rng.standard_normal(shape))
    a, w, b, x = (n(B2, S2, e, scale=0.5), n(e, e, scale=e ** -0.5),
                  n(e, scale=0.1), n(B2, S2, e))
    got = _out_proj_sweep(a, w, b, x, bn)
    packed = a.reshape(B2, S2, e // 128, 128).transpose(0, 2, 1, 3)
    with pltpu.force_tpu_interpret_mode():
        ref = jfe.fused_out_proj(*(jnp.asarray(t, jnp.bfloat16)
                                   for t in (packed, w, b, x)))
    _close(got, np.asarray(ref, np.float32))
    _close(got, tfe.out_proj_plain(*(_bf(t) for t in (a, w, b, x)))
           .float().numpy())


def test_tile_order_covers_every_tile_once():
    """Ragged M, one to three groups of 8 row tiles."""
    for m, n, bn in ((1, 384, 128), (140, 768, 256), (1024, 3840, 256),
                     (4096, 1280, 128), (2100, 5120, 128)):
        order = _tile_order(m, n, bn)
        want = {(128 * i, bn * j) for i in range(-(-m // 128))
                for j in range(n // bn)}
        assert len(order) == len(want) and set(order) == want


@pytest.mark.parametrize("m,n,n_group,want", [
    (4096, 3 * 1280, 1280, 256),     # QKV at B=8, S=512: 480 tiles
    (4096, 5120, 5120, 256),         # FC1: 640 tiles
    (4096, 1280, 1280, 128),         # FC2: 320 tiles, not 160 of 256
    (1024, 3 * 1280, 1280, 256),     # S=128: 120 tiles, one round
    (1024, 5120, 5120, 128),         # 320 tiles of 128 beat 160 of 256
    (1024, 1280, 1280, 128),
    (140, 3 * 128, 128, 128),        # E = 128: 256 does not divide it
    (140, 3 * 256, 256, 128),        # few tiles: the narrow one
])
def test_tile_width_plans_the_rounds_of_132_ctas(m, n, n_group, want):
    assert tfe.tile_width(m, n, n_group, 132) == want


@pytest.mark.parametrize("m,n,want", [
    (4096, 5120, 256),               # FC1 at S=512: 640 of 256, 1024 of 160
    (4096, 1280, 160),               # FC2: 256 tiles of 160 (2 rounds), not
                                     # 320 of 128 (3 rounds)
    (1024, 5120, 160),               # FC1 at S=128: 256 tiles, 2 rounds
    (1024, 1280, 128),               # FC2 at S=128: 80 tiles, 1 round
    (140, 512, 128),                 # 160 does not divide 512
])
def test_tile_width_plans_the_ffn_products(m, n, want):
    assert tfe.tile_width(m, n, n, 132, tfe.FFN_TILE_WIDTHS) == want


@pytest.mark.parametrize("m,e,want", [
    (4096, 1280, 160),               # S=512: 256 tiles of 160, 2 rounds
    (1024, 1280, 128),               # S=128: 80 tiles of 128, one round
    (16 * 512, 1280, 160),           # a train batch: a tie goes wider
    (140, 256, 128),                 # few tiles: the narrow one
    (140, 640, 128),                 # 256 does not divide 640
    (1, 128, 128),
])
def test_tile_width_plans_the_out_projection(m, e, want):
    assert tfe.tile_width(m, e, e, 132, tfe.OUT_TILE_WIDTHS) == want


def test_tile_width_never_straddles_a_group():
    for e in range(128, 2561, 128):
        for m in (1, 140, 1024, 4096, 16384):
            bn = tfe.tile_width(m, 3 * e, e, 132)
            assert bn in tfe.TILE_WIDTHS and e % bn == 0
    with pytest.raises(ValueError):
        tfe.tile_width(128, 192, 64, 132)
