"""Port parity for the slice as a whole: opus_pllm_tpu_torch.evals.runner.
run_annotation_eval vs opus_pllm_tpu.evals.runner.run_annotation_eval.

OpusConfig.tiny("llama") with ESM2 at E=128, H=2 (d=64, so the JAX side
takes its fused Pallas encoder path, run in interpret mode) and the CSTP
input widened to match. Same converted weights, same examples, greedy
decoding: the generated texts must be identical. The decoder's embedding
table is scaled up and the switch projector's biases dropped and gain
raised, so that greedy output varies with the protein from row to row
(which the test checks): equal texts are then evidence, not a collapse
onto one repeated string."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opus_pllm_tpu.core import config as jconfig
from opus_pllm_tpu.evals import datasets as jds
from opus_pllm_tpu.evals import runner as jrunner
from opus_pllm_tpu.infer.tokenization import ByteTokenizer as JByteTokenizer
from opus_pllm_tpu.models import opus as jopus
from opus_pllm_tpu_torch.core import config, convert
from opus_pllm_tpu_torch.evals import datasets as ds
from opus_pllm_tpu_torch.evals import runner
from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
from opus_pllm_tpu_torch.kernels import fused_encoder
from opus_pllm_tpu_torch.models import opus

FILE = "test_keywords.json"


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
    # soft tokens that differ between proteins as much as text tokens do:
    # drop the projector biases (shared by every row) and widen its gain
    for layer, gain in zip(jp["switch"]["layers"], (100.0, 10.0)):
        layer["kernel"], layer["bias"] = layer["kernel"] * gain, \
            layer["bias"] * 0.0
    return jp, convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _examples():
    rng = np.random.default_rng(0)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    return [("What are the keywords of this protein?",
             "".join(rng.choice(aa, int(n))), "kw")
            for n in rng.integers(5, 30, 5)]


def test_annotation_eval_matches_jax(models, tmp_path):
    jp, tp = models
    exs = _examples()
    gen_kw = dict(max_new_tokens=10, temperature=0.0, eos_token_id=2,
                  pad_token_id=0)
    with pltpu.force_tpu_interpret_mode():
        ref = jrunner.run_annotation_eval(
            jp, _cfg(jconfig), JByteTokenizer(), FILE,
            gen=jconfig.GenerationConfig(**gen_kw), batch_size=2,
            prompt_bucket=32, esm_bucket=32, impl="fused",
            examples=[jds.AnnotationExample(*e) for e in exs],
            log_fn=lambda *_: None)
    fused_encoder.reset_launches()
    save = tmp_path / "out.json"
    got = runner.run_annotation_eval(
        tp, _cfg(config), ByteTokenizer(), FILE,
        gen=config.GenerationConfig(**gen_kw), batch_size=2,
        prompt_bucket=32, esm_bucket=32, impl="fused",
        examples=[ds.AnnotationExample(*e) for e in exs],
        save_path=str(save), log_fn=lambda *_: None)
    texts = [r["generated"] for r in got.results]
    assert texts == [r["generated"] for r in ref.results]
    assert len(set(texts)) > 1
    assert [r["ground_truth"] for r in got.results] == ["kw"] * 5
    assert got.entries_per_sec > 0 and got.decode_tokens > 0
    assert save.exists()
    # CPU tensors: the fused path ran the plain versions, no kernel launched
    assert fused_encoder.launches == {k: 0 for k in fused_encoder.launches}


def test_auto_impl_on_cpu_matches_fused(models):
    """impl="auto" on CPU takes the plain layer composition (the JAX "xla"
    path); its greedy texts agree with the fused plain versions."""
    _, tp = models
    exs = [ds.AnnotationExample(*e) for e in _examples()[:2]]
    kw = dict(gen=config.GenerationConfig(max_new_tokens=6, temperature=0.0,
                                          eos_token_id=2, pad_token_id=0),
              batch_size=2, prompt_bucket=32, esm_bucket=32, examples=exs,
              log_fn=lambda *_: None)
    a = runner.run_annotation_eval(tp, _cfg(config), ByteTokenizer(), FILE,
                                   impl="auto", **kw)
    f = runner.run_annotation_eval(tp, _cfg(config), ByteTokenizer(), FILE,
                                   impl="fused", **kw)
    assert [r["generated"] for r in a.results] == \
        [r["generated"] for r in f.results]


def test_sampled_eval_runs_and_refuses_unported_options(models):
    _, tp = models
    exs = [ds.AnnotationExample(*e) for e in _examples()[:3]]
    rep = runner.run_annotation_eval(
        tp, _cfg(config), ByteTokenizer(), FILE,
        gen=config.GenerationConfig(max_new_tokens=5, eos_token_id=2),
        batch_size=2, prompt_bucket=32, esm_bucket=32, examples=exs,
        log_fn=lambda *_: None)
    assert len(rep.results) == 3
    with pytest.raises(NotImplementedError):
        runner.run_annotation_eval(
            tp, _cfg(config), ByteTokenizer(), FILE,
            gen=config.GenerationConfig(num_beams=2), examples=exs,
            log_fn=lambda *_: None)


def test_random_init_shapes_match_jax():
    """The port's own seeded init builds the same tree shapes as the JAX
    init (what chip_smoke.py draws at full width)."""
    tp = opus.init(_cfg(config), generator=torch.Generator().manual_seed(0),
                   device="cpu")
    ref = convert.from_jax(jax.tree.map(
        np.asarray, jopus.init(jax.random.PRNGKey(0), _cfg(jconfig))),
        device="cpu")
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    assert shapes(tp) == shapes(ref)
