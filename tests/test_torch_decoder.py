"""Port parity: opus_pllm_tpu_torch.models.decoder vs
opus_pllm_tpu.models.decoder, tiny configs in fp32: llama, then the qwen2
and opt families and llama with dynamic-NTK rope (forward, prefill and
decode over a cache, greedy generate, text_embeddings with both mask_pad
settings, int8 and int4 weights with biases).

Same converted weights and numpy inputs. Logits agree to rtol 1e-4 /
atol 2e-5: fp32 op order through two layers and a 256-way head. Greedy
generate is token-identical; the quantized decoders agree to 1e-4 (both
packages dequantize, as in tests/test_torch_quant.py)."""

import dataclasses

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
    """qwen2 and opt are ported: `init` draws each family's leaves (the
    JAX tree's names); a family outside the three raises."""
    cfg = DecoderConfig.tiny(family)
    gen = torch.Generator().manual_seed(0)
    got = decoder.init(cfg, generator=gen, device="cpu")
    want = jdec.init(jax.random.PRNGKey(0), JDecoderConfig.tiny(family))
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(got) == shapes(want)
    with pytest.raises(ValueError):
        decoder.init(dataclasses.replace(cfg, family="gpt2"), generator=gen,
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


# ---------------------------------------------------------------------------
# qwen2, opt and dynamic-NTK llama (one JAX tree per case, module scope)
# ---------------------------------------------------------------------------

FAMILY_CASES = {
    # llama with dynamic NTK: the 8-position trained window is exceeded by
    # the 9-token prompt, so the rope base is rescaled on every call
    "qwen2": dict(family="qwen2"),
    "opt": dict(family="opt"),
    "llama-ntk": dict(family="llama", use_dynamic_ntk=True,
                      max_position_embeddings=8),
}


def _family_cfgs(case, **kw):
    over = dict(FAMILY_CASES[case], **kw)
    fam = over.pop("family")
    return (dataclasses.replace(JDecoderConfig.tiny(fam), **over),
            dataclasses.replace(DecoderConfig.tiny(fam), **over))


@pytest.fixture(scope="module", params=list(FAMILY_CASES))
def family_model(request):
    jcfg, tcfg = _family_cfgs(request.param)
    jp = jdec.init(jax.random.PRNGKey(3), jcfg)
    # a wide embedding table keeps greedy decoding off a single token
    jp["embed_tokens"]["embedding"] = jp["embed_tokens"]["embedding"] * 50
    tp = convert.decoder_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return request.param, jcfg, tcfg, jp, tp


def test_family_forward_and_cached_decode(family_model):
    """Forward logits, then prefill into a 16-slot cache and 3 decode
    steps, each against the JAX decoder (for llama-ntk the cache capacity
    sets the rope base, so prefill and decode share it)."""
    case, jcfg, tcfg, jp, tp = family_model
    x, am = _inputs()
    x = x * 0.5
    pos = np.asarray(jdec.positions_from_mask(jnp.asarray(am)))
    ref, _ = jdec.forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                          jcausal(jnp.asarray(am)), impl="xla")
    got, _ = decoder.forward(tp, tcfg, torch.from_numpy(x),
                             torch.from_numpy(pos),
                             causal_mask(torch.from_numpy(am)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)

    b, l, _ = x.shape
    cap = 16
    jc = jdec.init_cache(jcfg, b, cap)
    jc["mask"] = jc["mask"].at[:, :l].set(jnp.asarray(am))
    tc = decoder.init_cache(tcfg, b, cap, device="cpu")
    tc["mask"][:, :l] = torch.from_numpy(am)
    pre = (np.asarray(jc["mask"])[:, None, None, :]
           & (np.arange(cap)[None, None, None, :]
              <= np.arange(l)[None, None, :, None]))
    ref, jc = jdec.forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                           jnp.asarray(pre), jc, impl="xla")
    got, tc = decoder.forward(tp, tcfg, torch.from_numpy(x),
                              torch.from_numpy(pos), torch.from_numpy(pre),
                              tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    steps = np.random.default_rng(4).standard_normal((3, b, 1, 64)) * 0.5
    for i, e in enumerate(steps.astype(np.float32)):
        jc["mask"] = jc["mask"].at[:, l + i].set(True)
        tc["mask"][:, l + i] = True
        p = pos[:, -1:] + 1 + i
        ref, jc = jdec.forward(jp, jcfg, jnp.asarray(e), jnp.asarray(p),
                               jc["mask"][:, None, None, :], jc, impl="xla")
        got, tc = decoder.forward(tp, tcfg, torch.from_numpy(e),
                                  torch.from_numpy(p),
                                  tc["mask"][:, None, None, :], tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_family_greedy_generate_token_identical(family_model):
    from opus_pllm_tpu.infer import engine as jeng
    from opus_pllm_tpu_torch.infer import engine

    case, jcfg, tcfg, jp, tp = family_model
    x, am = _inputs()
    pos = np.asarray(jdec.positions_from_mask(jnp.asarray(am)))
    ref = jeng.generate(jp, jcfg, jnp.asarray(x), jnp.asarray(am),
                        jnp.asarray(pos), jax.random.PRNGKey(0),
                        max_new_tokens=10, temperature=0.0)
    got = engine.generate(tp, tcfg, torch.from_numpy(x),
                          torch.from_numpy(am), torch.from_numpy(pos),
                          torch.Generator(), max_new_tokens=10,
                          temperature=0.0)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    assert len(set(got.tokens.numpy().ravel().tolist())) > 2


@pytest.mark.parametrize("mask_pad", [False, True])
def test_family_text_embeddings(family_model, mask_pad):
    """Right-padded captions: (first + last hidden) mean over every
    position (mask_pad=False, padding included) or the valid ones; OPT's
    first hidden state carries the learned positions."""
    from opus_pllm_tpu.models import text_encoder as jte
    from opus_pllm_tpu_torch.models import text_encoder

    case, jcfg, tcfg, jp, tp = family_model
    rng = np.random.default_rng(5)
    ids = rng.integers(3, 256, (3, 12)).astype(np.int32)
    am = np.zeros((3, 12), bool)
    for i, n in enumerate((12, 7, 3)):
        am[i, :n] = True
    ids[~am] = 0
    ref = jte.text_embeddings(jp, jcfg, jnp.asarray(ids), jnp.asarray(am),
                              mask_pad=mask_pad, impl="xla")
    got = text_encoder.text_embeddings(tp, tcfg, torch.from_numpy(ids),
                                       torch.from_numpy(am),
                                       mask_pad=mask_pad)
    assert got.dtype == torch.float32 and got.shape == (3, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_opt_positions_past_the_table_are_nan():
    """A position past OPT's 2 + max_position_embeddings table gives NaN
    rows in both packages (jnp.take fills), and reads nothing out of
    bounds."""
    jcfg, tcfg = _family_cfgs("opt", max_position_embeddings=6)
    jp = jdec.init(jax.random.PRNGKey(0), jcfg)
    tp = convert.decoder_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    pos = np.arange(8, dtype=np.int32)[None]
    ref = np.asarray(jdec.embed(jp["embed_positions"],
                                jnp.asarray(pos) + jdec.OPT_POS_OFFSET))
    got = decoder.opt_positions(tp, torch.from_numpy(pos)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[0, 6:]).all() and not np.isnan(got[0, :6]).any()
    np.testing.assert_array_equal(got[0, :6], ref[0, :6])


@pytest.mark.parametrize("case", ["qwen2", "opt"])
def test_family_quantized_with_biases(case):
    """int8 (quantize_decoder) and int4 (quantize_decoder4, v2 words)
    trees of a 512-wide qwen2 / opt decoder: the same leaves as the JAX
    quantizers (the q/k/v(/o/fc) biases kept), and logits within 1e-4 of
    the JAX quantized decoder."""
    from opus_pllm_tpu.kernels import quant as jq
    from opus_pllm_tpu.kernels import quant4 as jq4
    from opus_pllm_tpu_torch.kernels import quant, quant4

    jcfg, tcfg = _family_cfgs(case, hidden_size=512, intermediate_size=512,
                              num_heads=4, num_kv_heads=2 if case == "qwen2"
                              else 4, head_dim=128)
    jp = jdec.init(jax.random.PRNGKey(1), jcfg)
    tp = convert.decoder_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 40, 512)) * 0.5).astype(np.float32)
    pos = np.tile(np.arange(40), (2, 1)).astype(np.int32)
    mask = np.tril(np.ones((40, 40), bool))[None, None].repeat(2, 0)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, t))[0]
    for jfn, tfn, bf16 in ((jq.quantize_decoder, quant.quantize_decoder,
                            False),
                           (jq4.quantize_decoder4, quant4.quantize_decoder4,
                            True)):
        jqp = jfn(jp)
        got = tfn(tp)
        pairs = list(zip(flat(got), flat(jqp)))
        assert len(pairs) == len(flat(jqp))
        for (pa, a), (pb, b) in pairs:
            assert pa == pb
            np.testing.assert_array_equal(a, b)
        assert "bias" in got["layers"][0]["q_proj"]
        ref, _ = jdec.forward(jqp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                              jnp.asarray(mask))
        out, _ = decoder.forward(got, tcfg, torch.from_numpy(x),
                                 torch.from_numpy(pos),
                                 torch.from_numpy(mask))
        ref = np.asarray(ref)
        atol = 2.0 ** -7 * np.abs(ref).max() if bf16 else 1e-4
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=atol)


def test_family_serving_engine_and_logprobs(family_model):
    """The other entry points that take a DecoderConfig: the serving
    engine (greedy, token-identical to the JAX engine, whose prefill and
    decode share the dynamic-NTK bound `max_len`) and make_logprob_fn
    (within 1e-4 of the JAX one)."""
    from opus_pllm_tpu.infer import scoring as jscoring
    from opus_pllm_tpu.serve import engine as jserve
    from opus_pllm_tpu_torch.infer import scoring
    from opus_pllm_tpu_torch.serve.engine import ServeRequest, ServingEngine

    case, jcfg, tcfg, jp, tp = family_model
    rng = np.random.default_rng(7)
    reqs = [dict(request_id=i, embeds=(rng.standard_normal((p, 64)) * 0.3
                                       ).astype(np.float32),
                 max_new_tokens=6) for i, p in enumerate((5, 11))]
    kw = dict(max_slots=2, max_len=32, steps_per_tick=2,
              prefill_buckets=(16, 32))
    jdone = jserve.ServingEngine(jp, jcfg, **kw).run(
        [jserve.ServeRequest(**r) for r in reqs], max_ticks=50)
    tdone = ServingEngine(tp, tcfg, **kw).run(
        [ServeRequest(**r) for r in reqs], max_ticks=50)
    for r in reqs:
        assert tdone[r["request_id"]].tokens == \
            jdone[r["request_id"]].tokens
    encode = lambda t: [3 + b % 250 for b in t.encode()]
    texts = ["a short text", "another, longer text to score"]
    ref = jscoring.make_logprob_fn(jp, jcfg, encode, bos_token_id=1)(texts)
    got = scoring.make_logprob_fn(tp, tcfg, encode, bos_token_id=1)(texts)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
