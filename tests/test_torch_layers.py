"""Port parity: opus_pllm_tpu_torch.models.layers vs opus_pllm_tpu.models.layers.

Inputs come from a numpy seed and go through both packages in fp32; the JAX
side runs at "highest" matmul precision (tests/conftest.py). Tolerances are
fp32 op-order noise: 1e-5 relative / 1e-6 absolute unless stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opus_pllm_tpu.models import layers as jl
from opus_pllm_tpu_torch.models import layers as tl

RTOL, ATOL = 1e-5, 1e-6


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.asarray(a))


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("bias", [False, True])
def test_dense(bias):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    p = {"kernel": rng.standard_normal((16, 24)).astype(np.float32) * 0.2}
    if bias:
        p["bias"] = rng.standard_normal(24).astype(np.float32)
    jx, tx = _pair(x)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(tl.dense(tp, tx), jl.dense(jp, jx))


def test_embed():
    rng = np.random.default_rng(1)
    table = rng.standard_normal((11, 8)).astype(np.float32)
    ids = rng.integers(0, 11, (2, 7))
    _close(tl.embed({"embedding": torch.from_numpy(table)},
                    torch.from_numpy(ids)),
           jl.embed({"embedding": jnp.asarray(table)}, jnp.asarray(ids)),
           rtol=0, atol=0)


@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_norms(norm):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, 6, 32)) * 3 + 0.5).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(32)).astype(np.float32)
    jx, tx = _pair(x)
    if norm == "layer":
        got = tl.layer_norm({"scale": torch.from_numpy(scale),
                             "bias": torch.from_numpy(bias)}, tx)
        ref = jl.layer_norm({"scale": jnp.asarray(scale),
                             "bias": jnp.asarray(bias)}, jx)
    else:
        got = tl.rms_norm({"scale": torch.from_numpy(scale)}, tx, eps=1e-6)
        ref = jl.rms_norm({"scale": jnp.asarray(scale)}, jx, eps=1e-6)
    _close(got, ref, atol=1e-5)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_activations(act):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    jx, tx = _pair(x)
    _close(getattr(tl, act)(tx), jl.ACTIVATIONS[act](jx), atol=1e-6)


@pytest.mark.parametrize("theta,table_rank", [(10000.0, 2), (500000.0, 3)])
def test_rope(theta, table_rank):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = (np.arange(9) if table_rank == 2
           else np.stack([np.arange(9), np.arange(9) + 4]))
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), 16, theta)
    tc, ts = tl.rope_cos_sin(torch.from_numpy(pos), 16, theta)
    _close(tc, jc, atol=1e-6)
    _close(ts, js, atol=1e-6)
    jx, tx = _pair(x)
    _close(tl.apply_rope(tx, tc, ts), jl.apply_rope(jx, jc, js), atol=1e-5)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_attention_xla(hq, hkv):
    """GQA with a causal+padding mask; rows with no valid key (left pad)
    take the -1e9 uniform softmax on both sides."""
    rng = np.random.default_rng(4)
    b, s, d = 2, 7, 16
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    am = np.ones((b, s), bool)
    am[1, :3] = False
    jm = jl.causal_mask(jnp.asarray(am))
    tm = tl.causal_mask(torch.from_numpy(am))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    got = tl.attention_xla(*(torch.from_numpy(a) for a in (q, k, v)), tm)
    ref = jl.attention_xla(*(jnp.asarray(a) for a in (q, k, v)), jm)
    _close(got, ref, atol=1e-5)


def test_masks():
    am = np.array([[True, True, False], [False, True, True]])
    np.testing.assert_array_equal(
        tl.padding_mask(torch.from_numpy(am)).numpy(),
        np.asarray(jl.padding_mask(jnp.asarray(am))))
    np.testing.assert_array_equal(
        tl.causal_mask(torch.from_numpy(am), 2).numpy(),
        np.asarray(jl.causal_mask(jnp.asarray(am), 2)))
