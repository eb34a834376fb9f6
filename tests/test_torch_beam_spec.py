"""Port parity: beam search and static speculative decoding
(opus_pllm_tpu_torch.infer.engine.beam_generate,
infer.speculative.speculative_generate, models.decoder.tile_cache /
reorder_cache and the static runner's beam and draft branches) against
the JAX package on the CPU.

Beam search at fp32 must give the JAX tokens and lengths exactly, for
K in {2, 4}, length_penalty in {1.0, 0.5} and bf16 / int8 / int4 caches
(six cases that hold every pair of those values), on a tiny llama whose
EOS is a token its beams meet, so hypotheses finish early. K = 1 is
greedy. Speculative greedy decoding is token-identical to the JAX static
path and to the port's own `generate`; sampled speculative decoding draws
from the plain sampling distribution (a Monte Carlo test on a 6-token
vocabulary, total variation within 0.05 over 20000 rows). The static
runner with num_beams / draft_layers returns the JAX CLI's answers on the
toy checkpoint directories (tests/torch_checkpoints.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_checkpoints as tc
from opus_pllm_tpu.core.config import DecoderConfig as JDecoderConfig
from opus_pllm_tpu.infer import engine as jeng
from opus_pllm_tpu.infer import speculative as jspec
from opus_pllm_tpu.models import decoder as jdec
from opus_pllm_tpu_torch.core import builder, convert
from opus_pllm_tpu_torch.core.config import DecoderConfig, GenerationConfig
from opus_pllm_tpu_torch.evals import runner
from opus_pllm_tpu_torch.infer import engine, speculative
from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
from opus_pllm_tpu_torch.models import decoder

MAX_NEW = 6


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = JDecoderConfig.tiny("llama"), DecoderConfig.tiny("llama")
    jp = jdec.init(jax.random.PRNGKey(0), jcfg)
    jp["embed_tokens"]["embedding"] = jp["embed_tokens"]["embedding"] * 20
    tp = convert.decoder_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 8, 64)).astype(np.float32)
    am = np.ones((3, 8), bool)
    am[1, :3] = False
    am[2, :5] = False
    pos = np.array(jdec.positions_from_mask(jnp.asarray(am)))
    t = tuple(torch.from_numpy(a) for a in (x, am, pos))
    greedy = engine.generate(tp, tcfg, *t, torch.Generator(),
                             max_new_tokens=MAX_NEW, temperature=0.0)
    eos = int(greedy.tokens[0, 2])       # a token the decode meets
    return jcfg, tcfg, jp, tp, (x, am, pos), t, eos


@pytest.mark.parametrize("k, lp, cache", [
    (2, 1.0, False), (4, 0.5, False), (2, 0.5, "int8"), (4, 1.0, "int8"),
    (2, 0.5, "int4"), (4, 1.0, "int4")])
def test_beam_generate_matches_jax(model, k, lp, cache):
    jcfg, tcfg, jp, tp, arrs, t, eos = model
    kw = dict(num_beams=k, max_new_tokens=MAX_NEW, eos_token_id=eos,
              pad_token_id=0, length_penalty=lp, quantize_cache=cache)
    ref = jeng.beam_generate(jp, jcfg, *(jnp.asarray(a) for a in arrs),
                             **kw)
    got = engine.beam_generate(tp, tcfg, *t, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(ref.lengths))
    assert (got.lengths < MAX_NEW).any()        # a hypothesis finished


def test_beam_width_one_is_greedy(model):
    _, tcfg, _, tp, _, t, eos = model
    g = engine.generate(tp, tcfg, *t, torch.Generator(),
                        max_new_tokens=MAX_NEW, temperature=0.0,
                        eos_token_id=eos)
    b = engine.beam_generate(tp, tcfg, *t, num_beams=1,
                             max_new_tokens=MAX_NEW, eos_token_id=eos)
    np.testing.assert_array_equal(b.lengths.numpy(), g.lengths.numpy())
    for row, n in enumerate(g.lengths.tolist()):
        assert b.tokens[row, :n].tolist() == g.tokens[row, :n].tolist()


@pytest.mark.parametrize("quantize", [False, "int8", "int4"])
def test_tile_and_reorder_cache_match_jax(quantize):
    """Every leaf, the int8 / int4 scales "s" included, and the mask move
    with their rows, as in the JAX functions."""
    cfg = DecoderConfig.tiny("llama")
    cache = decoder.init_cache(cfg, 2, 5, device="cpu", quantize=quantize)
    g = torch.Generator().manual_seed(0)
    for lc in cache["layers"]:
        for t in lc.values():
            for x in (t.values() if isinstance(t, dict) else [t]):
                x.copy_((torch.rand(x.shape, generator=g) * 100 - 50).to(
                    x.dtype))
    cache["mask"].copy_(torch.rand(cache["mask"].shape, generator=g) > 0.5)
    cache["index"] = 3
    jc = {"layers": jax.tree.map(lambda x: jnp.asarray(x.numpy()),
                                 cache["layers"]),
          "index": jnp.int32(3), "mask": jnp.asarray(cache["mask"].numpy())}
    rows = np.array([5, 0, 0, 3, 2, 1])
    for got, ref in ((decoder.tile_cache(cache, 3), jdec.tile_cache(jc, 3)),
                     (decoder.reorder_cache(decoder.tile_cache(cache, 3),
                                            torch.from_numpy(rows)),
                      jdec.reorder_cache(jdec.tile_cache(jc, 3),
                                         jnp.asarray(rows)))):
        assert got["index"] == 3
        np.testing.assert_array_equal(got["mask"].numpy(),
                                      np.asarray(ref["mask"]))
        flat = jax.tree_util.tree_leaves_with_path
        gl = flat(jax.tree.map(lambda x: x.numpy(), got["layers"]))
        rl = flat(jax.tree.map(np.asarray, ref["layers"]))
        assert [p for p, _ in gl] == [p for p, _ in rl]
        for (_, a), (_, b) in zip(gl, rl):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quantize", [False, "int8", "int4"])
def test_speculative_greedy_matches_jax_and_generate(model, quantize):
    jcfg, tcfg, jp, tp, arrs, t, eos = model
    kw = dict(max_new_tokens=MAX_NEW + 1, eos_token_id=eos,
              quantize_cache=quantize)
    dp, dcfg = speculative.draft_from_target(tp, tcfg, 1)
    got = speculative.speculative_generate(dp, tp, dcfg, tcfg, t[0], t[0],
                                           t[1], t[2], n_draft=3, **kw)
    plain = engine.generate(tp, tcfg, *t, torch.Generator(),
                            temperature=0.0, **kw)
    np.testing.assert_array_equal(got.lengths.numpy(), plain.lengths.numpy())
    np.testing.assert_array_equal(got.tokens.numpy(), plain.tokens.numpy())
    if quantize is False:
        jdp, jdcfg = jspec.draft_from_target(jp, jcfg, 1)
        x = jnp.asarray(arrs[0])
        ref = jspec.speculative_generate(
            jdp, jp, jdcfg, jcfg, x, x, jnp.asarray(arrs[1]),
            jnp.asarray(arrs[2]), n_draft=3, **kw)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(ref.tokens))
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(ref.lengths))


def test_speculative_sampling_matches_plain_sampling():
    """Rejection-verified speculative sampling (batch-uniform acceptance,
    a 1-layer draft) draws the first three tokens with plain sampling's
    joint distribution at T = 1.0, top_p = 0.9: total variation distance
    between the two 20000-row histograms within 0.05 (a few times the
    sampling noise of 216 cells at this count)."""
    cfg = dataclasses.replace(DecoderConfig.tiny("llama"), vocab_size=6,
                              num_layers=3)
    g = torch.Generator().manual_seed(1)
    llm = decoder.init(cfg, generator=g, device="cpu")
    llm["embed_tokens"]["embedding"].mul_(40)
    n, l = 20000, 4
    x = decoder.embed_tokens(llm, torch.tensor([[1, 3, 2, 5]] * n))
    am = torch.ones((n, l), dtype=torch.bool)
    pos = torch.arange(l)[None].expand(n, l)
    dp, dcfg = speculative.draft_from_target(llm, cfg, 1)
    kw = dict(max_new_tokens=3, temperature=1.0, top_p=0.9)
    spec = speculative.speculative_generate(
        dp, llm, dcfg, cfg, x, x, am, pos, n_draft=3,
        generator=torch.Generator().manual_seed(2), **kw)
    plain = engine.generate(llm, cfg, x, am, pos,
                            torch.Generator().manual_seed(3), **kw)
    code = lambda t: (t[:, 0] * 36 + t[:, 1] * 6 + t[:, 2]).long()
    hs = torch.bincount(code(spec.tokens), minlength=216).double() / n
    hp = torch.bincount(code(plain.tokens), minlength=216).double() / n
    assert 0.5 * (hs - hp).abs().sum() < 0.05
    assert hp.max() < 0.9                       # the test is not trivial


@pytest.fixture(scope="module")
def toy_model():
    d = tc.toy_dirs()
    from opus_pllm_tpu_torch.cli.main import _opus_config
    import argparse
    args = argparse.Namespace(esm=d["esm"], weights=d["weights"],
                              no_cstp=False,
                              switch_projector_type="mlp2x_gelu")
    cfg = _opus_config(args, builder.decoder_config_for(d["llama"]))
    params, _ = builder.load_pretrained(d["llama"], d["weights"], cfg,
                                        esm_path=d["esm"], device="cpu")
    return d, cfg, params


@pytest.mark.parametrize("extra, gen_kw", [
    (("--num-beams", "2"), dict(num_beams=2)),
    (("--draft-layers", "1", "--n-draft", "3"),
     dict(draft_layers=1, n_draft=3))])
def test_static_runner_beams_and_draft_match_jax(toy_model, extra, gen_kw):
    """run_annotation_eval with beams / a draft at T = 0 returns what the
    JAX runner (through the JAX CLI) saves on the same files."""
    d, cfg, params = toy_model
    tok = ByteTokenizer()
    gen = GenerationConfig(max_new_tokens=6, temperature=0.0,
                           eos_token_id=tok.eos_token_id,
                           pad_token_id=tok.pad_token_id, **gen_kw)
    rep = runner.run_annotation_eval(params, cfg, tok, d["test_json"],
                                     gen=gen, batch_size=2,
                                     log_fn=lambda *_: None)
    assert tuple(r["generated"] for r in rep.results) == \
        tc.jax_cli_answers(extra)
