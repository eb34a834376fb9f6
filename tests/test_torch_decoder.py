"""Port parity: opus_pllm_tpu_torch.models.decoder (llama) vs
opus_pllm_tpu.models.decoder, tiny config in fp32.

Same converted weights and numpy inputs. Logits agree to rtol 1e-4 /
atol 2e-5: fp32 op order through two layers and a 256-way head."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opus_pllm_tpu.core.config import DecoderConfig as JDecoderConfig
from opus_pllm_tpu.models import decoder as jdec
from opus_pllm_tpu.models.layers import causal_mask as jcausal
from opus_pllm_tpu_torch.core import convert
from opus_pllm_tpu_torch.core.config import DecoderConfig
from opus_pllm_tpu_torch.models import decoder
from opus_pllm_tpu_torch.models.layers import causal_mask

TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = JDecoderConfig.tiny("llama"), DecoderConfig.tiny("llama")
    jp = jdec.init(jax.random.PRNGKey(0), jcfg)
    tp = convert.decoder_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _inputs(b=2, s=9, h=64, pad=3):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    am = np.ones((b, s), bool)
    am[1, :pad] = False                                  # left padding
    return x, am


def test_forward_without_cache(model):
    jcfg, tcfg, jp, tp = model
    x, am = _inputs()
    pos = np.asarray(jdec.positions_from_mask(jnp.asarray(am)))
    tpos = decoder.positions_from_mask(torch.from_numpy(am))
    np.testing.assert_array_equal(tpos.numpy(), pos)
    ref, _ = jdec.forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                          jcausal(jnp.asarray(am)), impl="xla")
    got, cache = decoder.forward(tp, tcfg, torch.from_numpy(x), tpos,
                                 causal_mask(torch.from_numpy(am)))
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_prefill_then_decode_with_cache(model):
    """Prefill 9 tokens into a 16-slot cache, then 3 single-token steps;
    every step's logits and the cache contents match the JAX engine's
    pytree-returning cache."""
    jcfg, tcfg, jp, tp = model
    x, am = _inputs()
    b, l, _ = x.shape
    cap = 16
    rng = np.random.default_rng(1)
    steps = rng.standard_normal((3, b, 1, 64)).astype(np.float32)

    jc = jdec.init_cache(jcfg, b, cap)
    jc["mask"] = jc["mask"].at[:, :l].set(jnp.asarray(am))
    tc = decoder.init_cache(tcfg, b, cap, device="cpu")
    tc["mask"][:, :l] = torch.from_numpy(am)
    rows = np.arange(l)[None, None, :, None]
    cols = np.arange(cap)[None, None, None, :]
    pre = np.asarray(jc["mask"])[:, None, None, :] & (cols <= rows)
    pos = np.array(jdec.positions_from_mask(jnp.asarray(am)))
    ref, jc = jdec.forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                           jnp.asarray(pre), jc, impl="xla")
    got, tc = decoder.forward(tp, tcfg, torch.from_numpy(x),
                              torch.from_numpy(pos), torch.from_numpy(pre), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert tc["index"] == int(jc["index"]) == l

    for i, e in enumerate(steps):
        slot = l + i
        jc["mask"] = jc["mask"].at[:, slot].set(True)
        tc["mask"][:, slot] = True
        p = pos[:, -1:] + 1 + i
        ref, jc = jdec.forward(jp, jcfg, jnp.asarray(e), jnp.asarray(p),
                               jc["mask"][:, None, None, :], jc, impl="xla")
        got, tc = decoder.forward(tp, tcfg, torch.from_numpy(e),
                                  torch.from_numpy(p),
                                  tc["mask"][:, None, None, :], tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    for jl, tl in zip(jc["layers"], tc["layers"]):
        for k in ("k", "v"):
            np.testing.assert_allclose(tl[k].numpy(), np.asarray(jl[k]),
                                       **TOL)


def test_head_logits_and_embed(model):
    jcfg, tcfg, jp, tp = model
    h = np.random.default_rng(2).standard_normal((3, 64)).astype(np.float32)
    np.testing.assert_allclose(
        decoder.head_logits(tp, tcfg, torch.from_numpy(h)).numpy(),
        np.asarray(jdec.head_logits(jp, jcfg, jnp.asarray(h))), **TOL)
    ids = np.array([[0, 5, 255]])
    np.testing.assert_array_equal(
        decoder.embed_tokens(tp, torch.from_numpy(ids)).numpy(),
        np.asarray(jdec.embed_tokens(jp, jnp.asarray(ids))))


@pytest.mark.parametrize("family", ["qwen2", "opt"])
def test_unported_families_raise(family):
    cfg = DecoderConfig.tiny(family)
    with pytest.raises(NotImplementedError):
        decoder.init(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    # quantized caches are ported; an unknown cache format still raises
    with pytest.raises(ValueError):
        decoder.init_cache(DecoderConfig.tiny(), 1, 4, quantize="int2",
                           device="cpu")


def test_stacked_tree_converts(model):
    jcfg, tcfg, jp, tp = model
    tp2 = convert.decoder_from_jax(
        jax.tree.map(np.asarray, jdec.stack_params(jp)), device="cpu")
    assert len(tp2["layers"]) == jcfg.num_layers
    for a, b in zip(tp["layers"], tp2["layers"]):
        for k in a:
            for leaf in a[k]:
                torch.testing.assert_close(a[k][leaf], b[k][leaf], rtol=0,
                                           atol=0)
