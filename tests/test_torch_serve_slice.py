"""Port parity for the serving slice as a whole (CLI `annotate --engine
--load-int8`): opus_pllm_tpu_torch.evals.runner.run_annotation_eval_engine
vs the JAX `run_annotation_eval_engine`, with the LLM quantized to int8 by
the JAX `quantize_decoder` and carried over by `from_jax`.

The tiny OpusConfig runs in fp32, so both packages dequantize every int8
projection the same way (`_matmul_xla` / `dequant_matmul`) and greedy texts
must be identical. The embedding table and the switch projector are scaled
as in tests/test_torch_slice.py, so that greedy output varies from row to
row (which the test checks), and each request asks in its own words. Six
requests share three slots, so requests are admitted mid-stream into freed
slots."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from opus_pllm_tpu.core import config as jconfig
from opus_pllm_tpu.evals import datasets as jds
from opus_pllm_tpu.evals import runner as jrunner
from opus_pllm_tpu.infer.tokenization import ByteTokenizer as JByteTokenizer
from opus_pllm_tpu.kernels import quant as jq
from opus_pllm_tpu.lora import lora as jlora
from opus_pllm_tpu.models import opus as jopus
from opus_pllm_tpu_torch.core import config, convert
from opus_pllm_tpu_torch.evals import datasets as ds
from opus_pllm_tpu_torch.evals import runner
from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
from opus_pllm_tpu_torch.kernels import flash_attention as fa
from opus_pllm_tpu_torch.kernels import quant, quant4

FILE = "test_keywords.json"
KW = dict(max_slots=3, steps_per_tick=2, splice_batch=4, prompt_bucket=32,
          esm_bucket=32, log_fn=lambda *_: None)


def _cfg(mod):
    c = mod.OpusConfig.tiny("llama")
    return dataclasses.replace(
        c, esm=mod.ESM2Config(num_layers=2, embed_dim=128, num_heads=2),
        cstp=dataclasses.replace(c.cstp, protein_dim=128))


@pytest.fixture(scope="module")
def models():
    jp = jopus.init(jax.random.PRNGKey(0), _cfg(jconfig))
    emb = jp["llm"]["embed_tokens"]["embedding"]
    jp["llm"]["embed_tokens"]["embedding"] = emb * 10
    for layer, gain in zip(jp["switch"]["layers"], (100.0, 10.0)):
        layer["kernel"], layer["bias"] = layer["kernel"] * gain, \
            layer["bias"] * 0.0
    jp["llm"] = jq.quantize_decoder(jp["llm"])
    tp = convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert quant4.quant_layout_of(tp["llm"]) == "int8"
    return jp, tp


QUESTIONS = ("What are the keywords of this protein?", "List keywords.",
             "Keywords of the protein below, please:",
             "Name its UniProt keywords", "Keywords?",
             "Which keywords describe this sequence?")


def _examples(n=6):
    rng = np.random.default_rng(0)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    return [(q, "".join(rng.choice(aa, int(k))), "kw")
            for q, k in zip(QUESTIONS[:n], rng.integers(5, 30, n))]


def test_engine_eval_matches_jax_and_static_runner(models):
    jp, tp = models
    gen_kw = dict(max_new_tokens=8, temperature=0.0, eos_token_id=2,
                  pad_token_id=0)
    exs = _examples()
    ref = jrunner.run_annotation_eval_engine(
        jp, _cfg(jconfig), JByteTokenizer(), FILE,
        gen=jconfig.GenerationConfig(**gen_kw),
        examples=[jds.AnnotationExample(*e) for e in exs], **KW)
    quant.reset_launches()
    fa.reset_launches()
    got = runner.run_annotation_eval_engine(
        tp, _cfg(config), ByteTokenizer(), FILE,
        gen=config.GenerationConfig(**gen_kw),
        examples=[ds.AnnotationExample(*e) for e in exs], **KW)
    texts = [r["generated"] for r in got.results]
    assert texts == [r["generated"] for r in ref.results]
    assert len(set(texts)) > 1
    assert got.metrics and got.metrics == ref.metrics
    assert got.entries_per_sec > 0
    static = runner.run_annotation_eval(
        tp, _cfg(config), ByteTokenizer(), FILE,
        gen=config.GenerationConfig(**gen_kw), batch_size=3,
        prompt_bucket=32, esm_bucket=32,
        examples=[ds.AnnotationExample(*e) for e in exs],
        log_fn=lambda *_: None)
    assert texts == [r["generated"] for r in static.results]
    stats = got.engine
    assert stats["completions"] == 6 and stats["prefills"] >= 2
    assert got.decode_tokens == stats["tokens"] > 0
    assert stats["decode_steps"] == stats["ticks"] * KW["steps_per_tick"]
    # CPU tensors: plain versions only
    assert quant.launches == {"int8_matmul": 0}
    assert fa.launches == {"flash_attention": 0}


def test_sampled_engine_eval_answers_every_request(models):
    """The reference's decode mode (T = 0.1, top_p = 0.7), with an int8
    KV cache: every request is answered and the TTFT histogram saw each."""
    _, tp = models
    rep = runner.run_annotation_eval_engine(
        tp, _cfg(config), ByteTokenizer(), FILE,
        gen=config.GenerationConfig(max_new_tokens=6, temperature=0.1,
                                    top_p=0.7, eos_token_id=2,
                                    quantize_cache="int8"),
        examples=[ds.AnnotationExample(*e) for e in _examples()], **KW)
    assert len(rep.results) == 6
    assert all(isinstance(r["generated"], str) for r in rep.results)
    assert rep.engine["completions"] == 6
    assert 0 < rep.engine["ttft_p50"] <= rep.engine["ttft_p99"]


def test_engine_eval_refuses_unported_options(models):
    """A mesh with a data axis is refused (the engine runners are
    tensor-parallel only; meshes that run: tests/test_torch_serve_tp.py).
    A bank entry that is no adapter
    tree fails in make_bank, as in the JAX package; beam search needs the
    static path; an empty set returns no results."""
    _, tp = models
    exs = [ds.AnnotationExample(*e) for e in _examples(1)]
    with pytest.raises(ValueError, match="data 1"):
        runner.run_annotation_eval_engine(
            tp, _cfg(config), ByteTokenizer(), FILE, examples=exs,
            log_fn=lambda *_: None,
            mesh=types.SimpleNamespace(data=2, model=1))
    with pytest.raises(KeyError):
        runner.run_annotation_eval_engine(
            tp, _cfg(config), ByteTokenizer(), FILE, examples=exs,
            log_fn=lambda *_: None, lora_bank={"a": {}}, adapter_id="a")
    with pytest.raises(ValueError, match="beam"):
        runner.run_annotation_eval_engine(
            tp, _cfg(config), ByteTokenizer(), FILE,
            gen=config.GenerationConfig(num_beams=2), examples=exs,
            log_fn=lambda *_: None)
    assert runner.run_annotation_eval_engine(
        tp, _cfg(config), ByteTokenizer(), FILE, examples=[],
        log_fn=lambda *_: None).results == []


def test_engine_options_match_jax(models):
    """The runner's engine options against the JAX runner's, greedy:
    cache_prefix (the common professor header prefilled once) through an
    engine_cache that a second call reuses (one engine, counts per call),
    and a bank adapter on the int8 base (adapter_id; the prefix is skipped
    under an adapter, as in the JAX runner)."""
    jp, tp = models
    gen_kw = dict(max_new_tokens=6, temperature=0.0, eos_token_id=2,
                  pad_token_id=0)
    exs = _examples(4)
    jlc = jconfig.LoRAConfig(rank=4, alpha=4.0)
    tree = jax.tree.map(
        lambda x: x if x.shape[-1] == 4 else
        0.5 * jax.random.normal(jax.random.PRNGKey(3), x.shape),
        jlora.init(jax.random.PRNGKey(2), _cfg(jconfig).llm, jlc))
    ttree = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)
    cache, reports = {}, []
    for opts, topts in ((dict(cache_prefix=True),
                         dict(cache_prefix=True, engine_cache=cache)),
                        (dict(lora_bank={"kw": tree}, adapter_id="kw",
                              cache_prefix=True),
                         dict(lora_bank={"kw": ttree}, adapter_id="kw",
                              cache_prefix=True))):
        ref = jrunner.run_annotation_eval_engine(
            jp, _cfg(jconfig), JByteTokenizer(), FILE,
            gen=jconfig.GenerationConfig(**gen_kw),
            examples=[jds.AnnotationExample(*e) for e in exs], **KW, **opts)
        got = runner.run_annotation_eval_engine(
            tp, _cfg(config), ByteTokenizer(), FILE,
            gen=config.GenerationConfig(**gen_kw),
            examples=[ds.AnnotationExample(*e) for e in exs], **KW, **topts)
        assert [r["generated"] for r in got.results] == \
            [r["generated"] for r in ref.results]
        assert got.engine["completions"] == 4
        assert (got.engine["prefix_tokens"] >= 16) == ("adapter_id" not in
                                                       topts)
        reports.append(got)
    again = runner.run_annotation_eval_engine(
        tp, _cfg(config), ByteTokenizer(), FILE,
        gen=config.GenerationConfig(**gen_kw),
        examples=[ds.AnnotationExample(*e) for e in exs], **KW,
        cache_prefix=True, engine_cache=cache)
    assert len(cache) == 1
    assert [r["generated"] for r in again.results] == \
        [r["generated"] for r in reports[0].results]
    assert again.engine["completions"] == 4
    assert again.engine["prefills"] == reports[0].engine["prefills"]
