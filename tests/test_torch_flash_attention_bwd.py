"""Port parity: the flash attention backward
(opus_pllm_tpu_torch.kernels.flash_attention_bwd and the autograd Function
of kernels.flash_attention) against
opus_pllm_tpu/kernels/flash_attention_bwd.py and jax.grad of the JAX
`flash_attention`, the Pallas kernels in interpret mode as
tests/test_flash_bwd.py runs them.

Sq = Skv = 256 with 128-blocks (the Pallas kernels need block multiples),
D = 128, GQA 4/2, fp32. Both compute in fp32 from the same inputs, so the
tolerance is summation order: 2e-5 of the largest gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opus_pllm_tpu.kernels import flash_attention as jfa
from opus_pllm_tpu.kernels import flash_attention_bwd as jfab
from opus_pllm_tpu_torch.kernels import flash_attention as fa
from opus_pllm_tpu_torch.kernels import flash_attention_bwd as fab

B, S, HQ, HKV, D = 2, 256, 4, 2, 128


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    g = rng.standard_normal((B, S, HQ, D)).astype(np.float32)
    return q, k, v, g


def _mask(kind):
    """(B, 1, S, S) bool: right padding + causality (the training mask,
    every row keeps its diagonal), or a padding mask whose row 1 has
    left-padded keys only (each row keeps a valid key)."""
    if kind is None:
        return None
    valid = np.ones((B, S), bool)
    if kind == "train":
        valid[1, 200:] = False
        causal = np.tril(np.ones((S, S), bool))
        m = valid[:, None, None, :] & causal[None, None]
        m[1, 0, 200:, :] = np.eye(S, dtype=bool)[200:]   # padding rows: self
        return m
    valid[1, :57] = False
    return np.broadcast_to(valid[:, None, None, :], (B, 1, S, S)).copy()


def _close(got, ref, tol=2e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


def _pallas_bwd(q, k, v, g, mask, causal):
    jin = [jnp.asarray(t) for t in (q, k, v)]
    jm = None if mask is None else jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        out, lse = jfa._flash_impl(*jin, jm, causal, 128, 128, want_lse=True)
        grads = jfab.flash_attention_bwd(*jin, jm, out, lse, jnp.asarray(g),
                                         causal=causal, block_q=128,
                                         block_k=128)
    return np.asarray(out), np.asarray(lse), [np.asarray(t) for t in grads]


@pytest.mark.parametrize("mask_kind,causal", [("train", False),
                                              ("padded", False),
                                              (None, True)])
def test_plain_matches_pallas_bwd_interpret(mask_kind, causal):
    q, k, v, g = _inputs()
    mask = _mask(mask_kind)
    out, lse, ref = _pallas_bwd(q, k, v, g, mask, causal)
    t = lambda a: torch.from_numpy(np.array(a))
    got = fab.flash_attention_bwd_plain(
        t(q), t(k), t(v), None if mask is None else t(mask), t(out), t(lse),
        t(g), causal=causal)
    for a, b_ in zip(got, ref):
        _close(a.numpy(), b_)
    # the wrapper on CPU tensors is the plain version and launches nothing
    fab.reset_launches()
    wrapped = fab.flash_attention_bwd(
        t(q), t(k), t(v), None if mask is None else t(mask), t(out), t(lse),
        t(g), causal=causal)
    for a, b_ in zip(wrapped, got):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)
    assert fab.launches == {"flash_attention_bwd_dq": 0,
                            "flash_attention_bwd_dkv": 0}


def test_fully_masked_row_gets_exactly_zero_gradient():
    """A query row with no valid key: its dq is exactly 0 in both
    packages, and it adds nothing to dk / dv (zeroing its dO changes
    neither)."""
    q, k, v, g = _inputs(1)
    mask = np.ones((B, 1, S, S), bool)
    mask[0, 0, 5, :] = False                   # row 5 of batch row 0
    out, lse, ref = _pallas_bwd(q, k, v, g, mask, False)
    t = lambda a: torch.from_numpy(np.array(a))
    dq, dk, dv = fab.flash_attention_bwd_plain(t(q), t(k), t(v), t(mask),
                                               t(out), t(lse), t(g))
    assert np.all(ref[0][0, 5] == 0)
    assert torch.all(dq[0, 5] == 0)
    g2 = g.copy()
    g2[0, 5] = 0.0
    _, dk2, dv2 = fab.flash_attention_bwd_plain(t(q), t(k), t(v), t(mask),
                                                t(out), t(lse), t(g2))
    torch.testing.assert_close(dk, dk2, rtol=0, atol=0)
    torch.testing.assert_close(dv, dv2, rtol=0, atol=0)


@pytest.mark.parametrize("mask_kind,causal", [("train", False),
                                              (None, True)])
def test_function_grads_match_jax_grad(mask_kind, causal):
    """The port's `flash_attention` with inputs that require grad goes
    through its autograd Function (forward with lse, backward through
    `flash_attention_bwd`); its gradients of sum(out * w) equal jax.grad
    of the JAX `flash_attention` (custom VJP, Pallas in interpret mode)."""
    q, k, v, w = _inputs(2)
    mask = _mask(mask_kind)
    jm = None if mask is None else jnp.asarray(mask)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, jm, causal=causal, block_q=128,
                                  block_k=128)
        return jnp.sum(out * jnp.asarray(w))

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(jloss, argnums=(0, 1, 2))(
            *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, None if mask is None
                             else torch.from_numpy(mask), causal=causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    for a, b_ in zip(got, ref):
        _close(a.numpy(), b_)
