"""Port parity: the quantized KV cache (opus_pllm_tpu_torch.models.decoder)
and opus_pllm_tpu_torch.kernels.decode_attention vs the JAX package.

Quantized bytes must be identical: jnp.round and torch.round both round
half to even, and the test feeds exact half-way values to show it. The
plain version (dequantize, then attend) is held to the JAX Pallas kernels
in interpret mode and to `decode_attention_int8_reference`; the decoder's
prefill and decode steps over int8 / int4 caches to the JAX decoder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opus_pllm_tpu.core.config import DecoderConfig as JDecoderConfig
from opus_pllm_tpu.kernels import decode_attention as jda
from opus_pllm_tpu.models import decoder as jdec
from opus_pllm_tpu_torch.core import convert
from opus_pllm_tpu_torch.core.config import DecoderConfig
from opus_pllm_tpu_torch.kernels import decode_attention as da
from opus_pllm_tpu_torch.models import decoder

QUANT = {"int8": (jdec._quantize_kv, decoder._quantize_kv, 127.0),
         "int4": (jdec._quantize_kv4, decoder._quantize_kv4, 7.0)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaf_np(leaf):
    return {k: np.asarray(v) for k, v in leaf.items()}


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantize_kv_bytes_match_jax_with_ties(kind):
    jfn, tfn, top = QUANT[kind]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 2, 128)).astype(np.float32)
    # rows whose absmax is `top` have scale exactly 1: put half-way values
    # there (2.5 -> 2, 3.5 -> 4 under round-half-to-even)
    x[0, :4, 0] = rng.integers(-6, 6, size=(4, 128)) + 0.5
    x[0, :4, 0, 0] = top
    ref, got = _leaf_np(jfn(jnp.asarray(x))), tfn(_t(x))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == _t(ref[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    assert (ref["s"][0, 0, :4] == 1.0).all()
    deq = decoder._dequantize_kv(got, torch.float32).numpy()
    np.testing.assert_array_equal(
        deq, np.asarray(jdec._dequantize_kv(jfn(jnp.asarray(x)),
                                            jnp.float32)))
    np.testing.assert_array_equal(deq[0, :4, 0, 1:],
                                  np.round(x[0, :4, 0, 1:]))


def _mk(kind, b=2, cap=512, hq=8, hkv=2, d=128, seed=0):
    jfn = QUANT[kind][0]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, 1, hq, d)) * 0.3).astype(np.float32)
    k = rng.standard_normal((b, cap, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, cap, hkv, d)).astype(np.float32)
    mask = np.zeros((b, cap), bool)
    for i in range(b):
        mask[i, :int(rng.integers(10, cap))] = True
    return (q, _leaf_np(jfn(jnp.asarray(k))), _leaf_np(jfn(jnp.asarray(v))),
            mask[:, None, None, :])


def _port(q, kl, vl, mask4, fn):
    return fn(_t(q), {k: _t(v) for k, v in kl.items()},
              {k: _t(v) for k, v in vl.items()}, _t(mask4)).numpy()


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4), (8, 1)])
def test_plain_matches_pallas_interpret(kind, hq, hkv):
    """The plain version (fp32 dequantize, fp32 attention) vs the TPU
    kernel in interpret mode, which rounds q and the softmax weights to
    bf16: tolerance 2e-2, the bound tests/test_decode_attention.py uses
    for the same kernel against the same reference."""
    q, kl, vl, mask4 = _mk(kind, hq=hq, hkv=hkv)
    kern = jda.decode_attention_int4 if kind == "int4" else \
        jda.decode_attention_int8
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(kern(jnp.asarray(q), jax.tree.map(jnp.asarray, kl),
                              jax.tree.map(jnp.asarray, vl),
                              jnp.asarray(mask4)))
    fn = da.decode_attention_int4 if kind == "int4" else \
        da.decode_attention_int8
    got = _port(q, kl, vl, mask4, fn)
    assert got.shape == ref.shape == (2, 1, hq, 128)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_plain_matches_reference_at_capacity_391(kind):
    """The annotate decode capacity (327 + 64 = 391, not a multiple of 256:
    the TPU kernel's gate refuses it, the port's takes it). fp32 q: the
    port's plain version and the JAX reference run the same composition,
    equal up to fp32 op order (rtol 1e-5, atol 1e-6)."""
    q, kl, vl, mask4 = _mk(kind, b=3, cap=391, hq=8, hkv=2, seed=1)
    ref = np.asarray(jda.decode_attention_int8_reference(
        jnp.asarray(q), jax.tree.map(jnp.asarray, kl),
        jax.tree.map(jnp.asarray, vl), jnp.asarray(mask4)))
    fn = da.decode_attention_int4 if kind == "int4" else \
        da.decode_attention_int8
    np.testing.assert_allclose(_port(q, kl, vl, mask4, fn), ref, rtol=1e-5,
                               atol=1e-6)
    tq = _t(q)
    kt = {k: _t(v) for k, v in kl.items()}
    assert da.supports(tq, kt, _t(mask4))
    assert not jda.supports(jnp.asarray(q), jax.tree.map(jnp.asarray, kl),
                            jnp.asarray(mask4))


def test_supports_gate():
    q, kl, vl, mask4 = _mk("int8", cap=16)
    kt = {k: _t(v) for k, v in kl.items()}
    m = _t(mask4)
    assert da.supports(_t(q), kt, m)
    assert not da.supports(_t(q), _t(np.zeros((2, 5, 2, 128))), m)
    assert not da.supports(_t(np.zeros((2, 2, 8, 128))), kt, m)    # Sq=2
    assert not da.supports(_t(np.zeros((2, 1, 32, 128))), kt, m)   # G=16
    assert not da.supports(_t(np.zeros((2, 1, 8, 96))), kt, m)     # D=96
    assert not da.supports(_t(q), kt, m.expand(2, 1, 3, 16))


def _cfgs():
    kw = dict(vocab_size=256, hidden_size=512, intermediate_size=1024,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
              dtype="float32")
    return JDecoderConfig(**kw), DecoderConfig(**kw)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = jdec.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, convert.decoder_from_jax(jax.tree.map(
        np.asarray, jp), device="cpu")


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_decoder_over_quantized_cache_matches_jax(model, kind):
    """Prefill 9 tokens (left padding in row 1) into a 12-slot quantized
    cache, then 3 decode steps: logits and cache bytes vs the JAX decoder.
    Prefill over a quantized cache attends over the DEQUANTIZED K/V
    (decoder.py:320-323), not the fresh ones: its logits part from the
    fp32-cache prefill's by ten times the tolerance or more. Tolerance
    rtol 1e-4 / atol 1e-4: fp32 op order through 2 layers and a 256-way
    head. K/V agree to fp32 op order, so a cache byte may round the other
    way where a value sits on a rounding boundary: at most 0.1% of them."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(2)
    b, l, cap = 2, 9, 12
    x = rng.standard_normal((b, l, 512)).astype(np.float32)
    am = np.ones((b, l), bool)
    am[1, :3] = False
    pos = np.asarray(jdec.positions_from_mask(jnp.asarray(am)))
    pre = (np.pad(am, ((0, 0), (0, cap - l)))[:, None, None, :]
           & (np.arange(cap)[None, None, None, :]
              <= np.arange(l)[None, None, :, None]))

    jc = jdec.init_cache(jcfg, b, cap, quantize=kind)
    jc["mask"] = jc["mask"].at[:, :l].set(jnp.asarray(am))
    tc = decoder.init_cache(tcfg, b, cap, quantize=kind, device="cpu")
    tc["mask"][:, :l] = _t(am)
    ref, jc = jdec.forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                           jnp.asarray(pre), jc)
    got, tc = decoder.forward(tp, tcfg, _t(x), _t(pos), _t(pre), tc)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
    plain, _ = decoder.forward(tp, tcfg, _t(x), _t(pos), _t(pre),
                               decoder.init_cache(tcfg, b, cap, device="cpu"))
    assert np.abs(plain.numpy() - got.numpy()).max() > 10 * tol["atol"]

    for i in range(3):
        e = rng.standard_normal((b, 1, 512)).astype(np.float32)
        jc["mask"] = jc["mask"].at[:, l + i].set(True)
        tc["mask"][:, l + i] = True
        p = pos[:, -1:] + 1 + i
        ref, jc = jdec.forward(jp, jcfg, jnp.asarray(e), jnp.asarray(p),
                               jc["mask"][:, None, None, :], jc)
        m4 = tc["mask"][:, None, None, :]
        got, tc = decoder.forward(tp, tcfg, _t(e), _t(p), m4, tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
    assert tc["index"] == int(jc["index"]) == l + 3
    for jl, tl in zip(jc["layers"], tc["layers"]):
        for kv in ("k", "v"):
            for key, val in jl[kv].items():
                if key == "s":
                    np.testing.assert_allclose(tl[kv][key].numpy(),
                                               np.asarray(val), **tol)
                else:
                    assert (tl[kv][key].numpy() != np.asarray(val)).mean() \
                        <= 1e-3
