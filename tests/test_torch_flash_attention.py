"""Port parity: flash attention forward (opus_pllm_tpu_torch.kernels.
flash_attention) against opus_pllm_tpu/kernels/flash_attention.py.

`flash_attention_plain` (the CUDA kernel's function) is held to the Pallas
kernel `_flash_impl(..., want_lse=True)` in interpret mode, out and lse, at
Sq = Skv = 256 with 128-blocks, D = 128, GQA 4/2, in fp32 and bf16, under
the serving engine's admission mask, a left-pad + causal mask and
`causal=True`; and to the JAX `attention_xla` at ragged shapes the Pallas
kernel cannot take. Query rows with no valid key are left out of the
comparisons: their output is the mean over whichever key blocks ran (a
tiling artefact that differs between kernels and from the -1e9 of
`attention_xla`), and no caller reads it (padding rows)."""

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
    got, lse = fa.flash_attention_plain(
        *tin, None if mask is None else torch.from_numpy(mask),
        causal=causal, return_lse=True, block_q=128, block_k=128)
    assert got.dtype == tdt and lse.dtype == torch.float32
    assert got.shape == (b, s, hq, d) and lse.shape == (b, hq, s)
    rows = _valid_rows(mask, causal, b, s, s, hq)
    ref = np.asarray(ref.astype(jnp.float32)).transpose(0, 2, 1, 3)[rows]
    out = got.float().numpy().transpose(0, 2, 1, 3)[rows]
    # fp32: summation order only; bf16: the inputs are the same bf16 values
    # and both compute in fp32, so one output rounding (2^-8 relative)
    tol = 2e-5 if dtype == "float32" else 2 ** -8
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(lse.numpy()[rows], np.asarray(ref_lse)[rows],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_wrapper_on_cpu_is_the_plain_version(causal):
    """On CPU tensors `flash_attention` is `flash_attention_plain` at the
    CUDA kernel's 64-blocks, and launches nothing; a per-head mask raises
    as the JAX `_flash_impl` does."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(2, 70, 70, 4, 2, 64, 1))
    mask = torch.from_numpy(_mask("leftpad", 2, 70, 70))
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, mask, causal=causal, return_lse=True)
    ref = fa.flash_attention_plain(q, k, v, mask, causal=causal,
                                   return_lse=True, block_q=64, block_k=64)
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
