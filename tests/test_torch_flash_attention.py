"""Port parity: flash attention forward (opus_pllm_tpu_torch.kernels.
flash_attention) against opus_pllm_tpu/kernels/flash_attention.py.

`flash_attention_plain` is held to the Pallas kernel `_flash_impl(...,
want_lse=True)` in interpret mode, out and lse, at Sq = Skv = 256 with
128-blocks, D = 128, GQA 4/2, in fp32 and bf16, under the serving
engine's admission mask, a left-pad + causal mask and `causal=True`: with
`block_q`/`block_k` it models the TPU kernel on every row, and by default
(the CUDA kernel's function) it agrees with it on every row with a valid
key and gives out 0 and lse -1e30 on a row with none. It is held to the JAX
`attention_xla` at ragged shapes the Pallas kernel cannot take (rows with a
valid key: `attention_xla`'s -1e9 masking averages the others), and to a
tile-by-tile sweep written the CUDA kernel's way (128 (query, head) rows a
CTA, 64-key tiles, tiles false everywhere skipped) on every row."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opus_pllm_tpu.kernels import flash_attention as jfa
from opus_pllm_tpu.models import layers as jlayers
from opus_pllm_tpu_torch.kernels import flash_attention as fa
from opus_pllm_tpu_torch.models import layers
from opus_pllm_tpu_torch.serve.engine import admission_inputs


def _qkv(b, sq, skv, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


def _mask(kind, b, sq, skv):
    """(B, 1, Sq, Skv) bool: the serving admission mask (causal within
    each row's valid length), or left padding + causality."""
    if kind is None:
        return None
    if kind == "serving":
        n_valid = torch.tensor([sq, 100][:b])
        return admission_inputs(n_valid, sq)[1].numpy()
    valid = np.ones((b, skv), bool)
    valid[1, :57] = False                          # row 1 left-padded
    causal = np.tril(np.ones((sq, skv), bool), k=skv - sq)
    return valid[:, None, None, :] & causal[None, None]


def _valid_rows(mask, causal, b, sq, skv, hq):
    """(B, Hq, Sq) bool: query rows with at least one attended key."""
    m = np.ones((b, 1, sq, skv), bool) if mask is None else mask
    if causal:
        m = m & np.tril(np.ones((sq, skv), bool))[None, None]
    return np.broadcast_to(m.any(-1), (b, hq, sq))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_kind,causal", [("serving", False),
                                              ("leftpad", False),
                                              (None, True)])
def test_plain_matches_pallas_interpret(dtype, mask_kind, causal):
    b, s, hq, hkv, d = 2, 256, 4, 2, 128
    q, k, v = _qkv(b, s, s, hq, hkv, d)
    mask = _mask(mask_kind, b, s, s)
    jin = [jnp.asarray(t, dtype) for t in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        ref, ref_lse = jfa._flash_impl(
            *jin, None if mask is None else jnp.asarray(mask), causal, 128,
            128, want_lse=True)
    tdt = getattr(torch, dtype)
    tin = [torch.from_numpy(np.array(t.astype(jnp.float32))).to(tdt)
           for t in jin]
    tmask = None if mask is None else torch.from_numpy(mask)
    rows = _valid_rows(mask, causal, b, s, s, hq)
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 2, 1, 3)
    ref_lse = np.asarray(ref_lse)
    # fp32: summation order only; bf16: the inputs are the same bf16 values
    # and both compute in fp32, so one output rounding (2^-8 relative)
    tol = 2e-5 if dtype == "float32" else 2 ** -8
    for blocks in ({"block_q": 128, "block_k": 128}, {}):
        got, lse = fa.flash_attention_plain(*tin, tmask, causal=causal,
                                            return_lse=True, **blocks)
        assert got.dtype == tdt and lse.dtype == torch.float32
        assert got.shape == (b, s, hq, d) and lse.shape == (b, hq, s)
        out = got.float().numpy().transpose(0, 2, 1, 3)
        lse = lse.numpy()
        # the TPU kernel's blocks: every row; the default: valid rows
        sel = np.ones_like(rows) if blocks else rows
        assert np.abs(out[sel] - ref[sel]).max() <= tol * max(
            np.abs(ref).max(), 1.0)
        np.testing.assert_allclose(lse[sel], ref_lse[sel], rtol=1e-5,
                                   atol=1e-5)
        if not blocks:                       # no valid key: out 0, lse -1e30
            assert np.all(out[~rows] == 0) and np.all(lse[~rows] == -1e30)
    assert (~rows).any() == (mask_kind == "leftpad")


def _kernel_sweep(q, k, v, mask, causal, gp):
    """The CUDA kernel's loop in fp32: per CTA of 128 / gp query rows x gp
    heads, 64-key tiles in order, a tile whose mask is false for all the
    CTA's rows skipped, an online softmax in which a key the row may not
    attend weighs 0. (out, lse)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qr = 128 // gp
    keep = torch.ones((b, sq, skv), dtype=torch.bool)
    if causal:
        keep &= torch.tril(torch.ones((sq, skv), dtype=torch.bool))
    if mask is not None:
        keep &= mask[:, 0]
    out = torch.zeros(q.shape)
    lse = torch.zeros((b, hq, sq))
    s_all = torch.einsum("bqhd,bkhd->bhqk", q / d ** 0.5,
                         k.repeat_interleave(hq // hkv, dim=2))
    vx = v.repeat_interleave(hq // hkv, dim=2)
    for q0 in range(0, sq, qr):
        rows = slice(q0, min(q0 + qr, sq))
        m = torch.full((b, hq, rows.stop - q0), -1e30)
        l = torch.zeros_like(m)
        o = torch.zeros((b, hq, rows.stop - q0, d))
        for k0 in range(0, skv, 64):
            cols = slice(k0, min(k0 + 64, skv))
            kp = keep[:, rows, cols]                   # (b, rows, keys)
            live = kp.flatten(1).any(1)                # per batch row (CTA)
            x = torch.where(kp[:, None], s_all[:, :, rows, cols],
                            torch.tensor(float("-inf")))
            mx = torch.maximum(m, x.amax(-1))
            alpha = torch.exp(m - mx)
            p = torch.exp(x - mx[..., None])
            upd = live[:, None, None]
            l = torch.where(upd, l * alpha + p.sum(-1), l)
            o = torch.where(upd[..., None], o * alpha[..., None]
                            + p @ vx[:, cols].transpose(1, 2), o)
            m = torch.where(upd, mx, m)
        out[:, rows] = (o / l.clamp_min(1e-30)[..., None]).transpose(1, 2)
        lse[:, :, rows] = torch.where(l > 0, m + torch.log(l),
                                      torch.tensor(-1e30))
    return out, lse


@pytest.mark.parametrize("gp", [1, 4, 8])
@pytest.mark.parametrize("sq,skv,mask_kind,causal", [
    (63, 63, "hole", False),       # just under a tile, a dead tile mid-sweep
    (64, 64, "leftpad", False),    # at a tile, left-padded rows
    (130, 129, None, True),        # just past two query / key tiles
])
def test_plain_models_the_kernel_tile_sweep(gp, sq, skv, mask_kind, causal):
    """The default plain version (no blocks) equals the CUDA kernel's tile
    sweep on every row, fp32, rows with no valid key (left padding, a
    masked-out row) and skipped tiles included: skipping a tile that is
    false everywhere changes nothing, and such rows give out 0, lse -1e30."""
    b, hq, hkv, d = 2, 8, 1, 64
    q, k, v = (torch.from_numpy(t) for t in _qkv(b, sq, skv, hq, hkv, d, 4))
    if mask_kind == "hole":
        m = np.ones((b, 1, sq, skv), bool)
        m[:, :, :, 20:40] = False                  # keys 20..39: no one
        m[1, :, 5] = False                         # one row with no key
        m[0, :, :, 48:] = False
        mask = torch.from_numpy(m)
    else:
        mask = (None if mask_kind is None
                else torch.from_numpy(_mask(mask_kind, b, sq, skv)))
    got, got_lse = fa.flash_attention_plain(q, k, v, mask, causal=causal,
                                            return_lse=True)
    ref, ref_lse = _kernel_sweep(q, k, v, mask, causal, gp)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), ref_lse.numpy(), rtol=1e-5,
                               atol=1e-5)
    empty = ~_valid_rows(None if mask is None else mask.numpy(), causal, b,
                         sq, skv, hq)
    assert empty.any() == (mask_kind is not None)
    assert np.all(got.numpy().transpose(0, 2, 1, 3)[empty] == 0)
    assert np.all(got_lse.numpy()[empty] == -1e30)


@pytest.mark.parametrize("causal", [False, True])
def test_wrapper_on_cpu_is_the_plain_version(causal):
    """On CPU tensors `flash_attention` is `flash_attention_plain` with the
    CUDA kernel's function (no blocks), and launches nothing; a per-head
    mask raises as the JAX `_flash_impl` does."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(2, 70, 70, 4, 2, 64, 1))
    mask = torch.from_numpy(_mask("leftpad", 2, 70, 70))
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, mask, causal=causal, return_lse=True)
    ref = fa.flash_attention_plain(q, k, v, mask, causal=causal,
                                   return_lse=True)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fa.launches == {"flash_attention": 0}
    with pytest.raises(ValueError, match="broadcast"):
        fa.flash_attention(q, k, v, mask.expand(2, 4, 70, 70))


@pytest.mark.parametrize("sq,skv", [(37, 45), (70, 70), (1, 9)])
def test_plain_matches_attention_xla_on_ragged_shapes(sq, skv):
    """The shapes the Pallas kernel refuses (the static annotate prefill is
    Sq = 327 against Skv = 391): the plain version equals the JAX
    `attention_xla` on every row with a valid key, fp32."""
    b, hq, hkv, d = 2, 8, 2, 128
    q, k, v = _qkv(b, sq, skv, hq, hkv, d, seed=2)
    mask = _mask("leftpad", b, sq, skv)
    ref = np.asarray(jlayers.attention_xla(*(jnp.asarray(t) for t in
                                             (q, k, v)), jnp.asarray(mask)))
    got = fa.flash_attention_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                                   torch.from_numpy(mask)).numpy()
    rows = _valid_rows(mask, False, b, sq, skv, hq).transpose(0, 2, 1)
    np.testing.assert_allclose(got[rows], ref[rows], rtol=2e-5, atol=2e-5)


def test_layers_attention_gate_on_cpu():
    """`layers.attention` sends CPU tensors (and impl="torch") to
    `attention_xla`; `supports` holds only on CUDA bf16 tensors with
    D % 128 == 0, Hq % Hkv == 0, Sq > 1 and a broadcast bool mask."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 8, 8, 4, 2, 128, 3))
    mask = torch.ones((1, 1, 8, 8), dtype=torch.bool)
    assert not fa.supports(q.bfloat16(), k, mask)           # CPU tensors
    fa.reset_launches()
    for impl in ("auto", "torch"):
        torch.testing.assert_close(layers.attention(q, k, v, mask, impl=impl),
                                   layers.attention_xla(q, k, v, mask),
                                   rtol=0, atol=0)
    assert fa.launches == {"flash_attention": 0}
