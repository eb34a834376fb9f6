"""Tensor parallelism of the port (parallel/partition.py, the decoder's
row-parallel all-reduce and gathered head, ServingEngine(mesh=...)) and
the runners' mesh / seq_mesh against the JAX package on the CPU.

Four gloo ranks start once for the file (tests/torch_dist.RankPool). The
TP static generate over 2 and 4 ranks (llama, qwen2 and opt at 2 layers,
hidden 64, 8/2 heads; at 4 ranks llama's 2 KV heads do not split and its
attention runs whole, as `_sanitize` replicates in JAX) gives the JAX
package's greedy tokens with first-step logits within 1e-4, the same
tokens on every rank; the TP engine gives the JAX engine's tokens with a
bf16 cache, an int8 cache, the adapter bank and the prefix cache (the
cases of tests/test_serve_tp.py), its cache holding the rank's heads;
and the runners (static annotate and MCQ, scored MCQ, the engine's
annotate) with mesh 2x1, 2x2 and 1x2 and with a seq mesh give the JAX
runners' results lists (JAX's own tests hold its mesh runs to its
single-device ones)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_cases as cases
from opus_pllm_tpu.core import config as jconfig
from opus_pllm_tpu.core.config import DecoderConfig as JDecoderConfig
from opus_pllm_tpu.core.config import LoRAConfig as JLoRAConfig
from opus_pllm_tpu.evals import datasets as jds
from opus_pllm_tpu.evals import runner as jrunner
from opus_pllm_tpu.infer import engine as jengine
from opus_pllm_tpu.infer.tokenization import ByteTokenizer as JByteTokenizer
from opus_pllm_tpu.lora import lora as jlora
from opus_pllm_tpu.models import decoder as jdecoder
from opus_pllm_tpu.models import opus as jopus
from opus_pllm_tpu.models.layers import causal_mask
from opus_pllm_tpu.serve import engine as jserve
from torch_dist import RankPool


def _fields(family):
    return dict(family=family, vocab_size=128, hidden_size=64,
                intermediate_size=128, num_layers=2, num_heads=8,
                num_kv_heads=2 if family != "opt" else 8, head_dim=8,
                attention_bias=family == "qwen2", dtype="float32")


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("tp"))
    yield p
    p.close()


@functools.lru_cache(maxsize=None)
def _model(family):
    cfg = JDecoderConfig(**_fields(family))
    params = jdecoder.init(jax.random.PRNGKey(0), cfg)
    return cfg, params, jax.tree.map(np.asarray, params)


def _prompt(cfg, params, l=11):
    rng = np.random.default_rng(1)
    ids = rng.integers(4, cfg.vocab_size, (2, l)).astype(np.int32)
    mask = np.ones((2, l), bool)
    mask[1, :3] = False
    emb = np.asarray(jdecoder.embed_tokens(params, jnp.asarray(ids)))
    return emb, mask


KW = dict(max_new_tokens=8, temperature=0.0, eos_token_id=-1)


@functools.lru_cache(maxsize=None)
def _jax_ref(family):
    """The JAX greedy tokens and first-step logits of `_model(family)` on
    its prompt, once a process."""
    cfg, params, _ = _model(family)
    emb, mask = _prompt(cfg, params)
    e, mk = jnp.asarray(emb), jnp.asarray(mask)
    pos = jdecoder.positions_from_mask(mk)
    ref = jengine.generate(params, cfg, e, mk, pos, jax.random.PRNGKey(1),
                           **KW)
    lg, _ = jax.jit(jdecoder.forward, static_argnums=1)(
        params, cfg, e, pos, causal_mask(mk))
    return emb, mask, np.asarray(ref.tokens), np.asarray(lg[:, -1])


@pytest.mark.parametrize("family,m,split", [
    ("llama", 2, (True, True, True)), ("llama", 4, (False, True, True)),
    ("qwen2", 2, (True, True, True)), ("opt", 4, (True, True, True))])
def test_tp_generate_matches_jax(pool, family, m, split):
    emb, mask, tokens, logits = _jax_ref(family)
    outs = pool.run(cases.tp_generate, m, _fields(family),
                    _model(family)[2], emb, mask, KW)
    for toks, got, got_split in outs[:m]:
        np.testing.assert_array_equal(toks, tokens)
        np.testing.assert_allclose(got, logits, atol=1e-4, rtol=1e-4)
        assert got_split == split
    assert all(o is None for o in outs[m:])


def _emb(cfg, seed, p):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((p, cfg.hidden_size)) * 0.3).astype(
        np.float32)


ENGINE_KW = dict(max_slots=3, max_len=64, prefill_buckets=(16, 32),
                 steps_per_tick=2)


def _bank(cfg):
    lcfg = JLoRAConfig(rank=4, alpha=8.0)
    t = jlora.init(jax.random.PRNGKey(5), cfg, lcfg)
    t = jax.tree.map(
        lambda x: x if x.shape[-1] == lcfg.rank else
        0.3 * jax.random.normal(jax.random.PRNGKey(15), x.shape), t)
    return {"a": jax.tree.map(np.asarray, t)}, jlora.scaling(lcfg)


@pytest.mark.parametrize("case", ["bf16-bank-prefix", "int8"])
def test_tp_engine_matches_jax(pool, case):
    """bf16: plain requests, two under a bank adapter and two admitted
    with only their suffix after a pinned prefix, in one engine; int8:
    the quantized cache."""
    cfg, params, tree = _model("llama")
    kw, bank, prefix = dict(ENGINE_KW), None, None
    reqs = [dict(request_id=i, embeds=_emb(cfg, i, 4 + 3 * i),
                 max_new_tokens=4 + i, temperature=0.0) for i in range(4)]
    if case == "int8":
        kw["quantize_cache"] = True
    else:
        bank, kw["lora_scale"] = _bank(cfg)
        reqs[1]["adapter_id"] = reqs[3]["adapter_id"] = "a"
        prefix = _emb(cfg, 100, 12)
        reqs += [dict(request_id=4 + i, embeds=_emb(cfg, 101 + i, 5),
                      max_new_tokens=6, temperature=0.0, prefix_id="p")
                 for i in range(2)]
    jkw = dict(kw)
    if bank is not None:
        jkw["lora_bank"] = bank
    eng = jserve.ServingEngine(params, cfg, **jkw)
    if prefix is not None:
        eng.register_prefix("p", embeds=prefix)
    ref = {c.request_id: c.tokens for c in eng.run(
        [jserve.ServeRequest(**r) for r in reqs], max_ticks=200).values()}
    outs = pool.run(cases.tp_engine, 2, _fields("llama"), tree, reqs, kw,
                    bank, prefix)
    for done, shape in outs[:2]:
        assert done == ref
        # this rank's heads: Hkv / 2 = 1 (head-major when quantized)
        assert shape == ((4, 1, 64, 8) if case == "int8" else (4, 64, 1, 8))


@functools.lru_cache(maxsize=None)
def _opus_models():
    cfg = jconfig.OpusConfig.tiny("llama")
    p = jopus.init(jax.random.PRNGKey(0), cfg)
    p["llm"]["embed_tokens"]["embedding"] = \
        p["llm"]["embed_tokens"]["embedding"] * 10
    for layer, gain in zip(p["switch"]["layers"], (100.0, 10.0)):
        layer["kernel"], layer["bias"] = layer["kernel"] * gain, \
            layer["bias"] * 0.0
    return cfg, p


ANNOTATE = [dict(instruction="Where is it located?", sequence="MKTAYIAKQR",
                 output="nucleus"),
            dict(instruction="Name the function.", sequence="ACDEFGHIKL",
                 output="enzyme"),
            dict(instruction="Keywords?", sequence="MKTAYIAKQRMKTAY",
                 output="binding")]
MCQ = [dict(question=f"Which class {i}?", options=["A) x", "B) y", "C) z",
                                                   "D) w"],
            sequence=s, answer="B")
       for i, s in enumerate(("MKTAYIAKQR", "ACDEFGHIKL", "MKTAYIAKQRMKT"))]


def _jax_run(kind, cfg, params, gen):
    """The JAX runner's report. The engine runner's greedy results are the
    static runner's (tests/test_engine_eval.py), so "annotate_engine"
    reads the static annotate run."""
    tok = JByteTokenizer()
    kw = dict(gen=gen, log_fn=lambda *_: None)
    if kind.startswith("annotate"):
        ex = [jds.AnnotationExample(**e) for e in ANNOTATE]
        name = "mini_localization.json"
    else:
        ex = [jds.MCQExample(**e) for e in MCQ]
        name = "mini_mcq_test.json"
    if kind.startswith("annotate"):
        return jrunner.run_annotation_eval(params, cfg, tok, name,
                                           examples=ex, batch_size=2, **kw)
    if kind == "mcq":
        return jrunner.run_mcq_eval(params, cfg, tok, name, examples=ex,
                                    batch_size=2, **kw)
    return jrunner.run_mcq_eval_scored(params, cfg, tok, name, examples=ex,
                                       batch_size=2, log_fn=kw["log_fn"])


@functools.lru_cache(maxsize=None)
def _jax_report(kind):
    cfg, params = _opus_models()
    tok = JByteTokenizer()
    gen = jconfig.GenerationConfig(max_new_tokens=6, temperature=0.0,
                                   eos_token_id=tok.eos_token_id,
                                   pad_token_id=tok.pad_token_id)
    return _jax_run("annotate" if kind.startswith("annotate") else kind,
                    cfg, params, gen), gen


@pytest.mark.parametrize("kind,meshes", [
    ("annotate", [(2, 1, 0), (2, 2, 0), (1, 2, 0), (0, 0, 2)]),
    ("annotate_engine", [(1, 2, 0)]),
    ("mcq", [(2, 1, 0), (0, 0, 2)]),
    ("mcq_scored", [(2, 2, 0)])])
def test_runners_with_mesh_match_jax(pool, kind, meshes):
    cfg, params = _opus_models()
    ref, gen = _jax_report(kind)
    tree = jax.tree.map(np.asarray, params)
    cfg_dicts = dataclasses.asdict(cfg)
    examples = ANNOTATE if kind.startswith("annotate") else MCQ
    name = ("mini_localization.json" if kind.startswith("annotate")
            else "mini_mcq_test.json")
    for data, model, seq in meshes:
        n = seq or data * model
        outs = pool.run(cases.runner, kind, data, model, seq, cfg_dicts,
                        tree, examples, dataclasses.asdict(gen), name)
        for rank, (results, metrics) in enumerate(outs[:n]):
            assert results == ref.results, (data, model, seq, rank)
            if rank == 0:
                assert metrics == ref.metrics
            else:
                assert kind.startswith("mcq") or metrics == {}
        assert all(o is None for o in outs[n:])
