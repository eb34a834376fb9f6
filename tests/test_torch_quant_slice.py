"""Port parity for the quantized slice: int4 v2 weights (the JAX
`quantize_decoder4` tree, carried over by `from_jax`) with an int8 or int4
KV cache, through `engine.generate` and `runner.run_annotation_eval`.

The decoder has 512-multiple widths (hidden 512, intermediate 1024,
head_dim 128, heads 4/2), because the JAX package packs v1 bytes where
K % 512 != 0. Both packages run on the CPU: the JAX int4 matmul takes
`_matmul_xla` and its decode attention the dequantize-then-attend path;
the port takes the dequantize route for M > 64 rows (prefill) and the
kernels' plain versions otherwise (decode steps and both vocab-head calls).
Where they part: the plain int4 matmul keeps the group scales fp32 where
`_matmul_xla` rounds them (and the dequantized weights) to bf16, so the
first-step logits agree within 1% of their largest magnitude
(tests/test_torch_quant4.py measures ~0.2% for one product). Greedy tokens
must be identical: a token can flip only where its two best logits lie
within that difference, and the prompts here keep clear of that (at
8 steps the raw-embedding prompt of `test_generate_matches_jax` meets one
such near-tie in its last token, so it stops at 6). The
embedding table is scaled up, the switch projector as in
tests/test_torch_slice.py, and each request asks in its own words, so that
greedy output varies from row to row (which the test checks)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opus_pllm_tpu.core import config as jconfig
from opus_pllm_tpu.evals import datasets as jds
from opus_pllm_tpu.evals import runner as jrunner
from opus_pllm_tpu.infer import engine as jeng
from opus_pllm_tpu.infer.tokenization import ByteTokenizer as JByteTokenizer
from opus_pllm_tpu.kernels import quant4 as jq
from opus_pllm_tpu.models import decoder as jdec
from opus_pllm_tpu.models import opus as jopus
from opus_pllm_tpu_torch.core import config, convert
from opus_pllm_tpu_torch.evals import datasets as ds
from opus_pllm_tpu_torch.evals import runner
from opus_pllm_tpu_torch.infer import engine
from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
from opus_pllm_tpu_torch.kernels import decode_attention as da
from opus_pllm_tpu_torch.kernels import quant4
from opus_pllm_tpu_torch.models import decoder

FILE = "test_keywords.json"
LOGIT_BOUND = 1e-2


def _cfg(mod):
    llm = mod.DecoderConfig(vocab_size=256, hidden_size=512,
                            intermediate_size=1024, num_layers=2,
                            num_heads=4, num_kv_heads=2, head_dim=128,
                            max_position_embeddings=512, dtype="float32")
    c = mod.OpusConfig.tiny("llama")
    return dataclasses.replace(
        c, esm=mod.ESM2Config(num_layers=2, embed_dim=128, num_heads=2),
        cstp=dataclasses.replace(c.cstp, protein_dim=128),
        switch=dataclasses.replace(c.switch, llm_hidden_size=512), llm=llm)


@pytest.fixture(scope="module")
def models():
    jp = jopus.init(jax.random.PRNGKey(0), _cfg(jconfig))
    emb = jp["llm"]["embed_tokens"]["embedding"]
    jp["llm"]["embed_tokens"]["embedding"] = emb * 6
    for layer, gain in zip(jp["switch"]["layers"], (100.0, 10.0)):
        layer["kernel"], layer["bias"] = layer["kernel"] * gain, \
            layer["bias"] * 0.0
    jp["llm"] = jq.quantize_decoder4(jp["llm"])
    tp = convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    assert quant4.quant_layout_of(tp["llm"]) == "int4-v2"
    return jp, tp


def _prompt(b=2, l=40, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, l, 512)) * 0.5).astype(np.float32)
    am = np.ones((b, l), bool)
    am[1, :5] = False
    return x, am, np.asarray(jdec.positions_from_mask(jnp.asarray(am)))


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_generate_matches_jax(models, kind):
    jp, tp = models
    jcfg, tcfg = _cfg(jconfig).llm, _cfg(config).llm
    x, am, pos = _prompt()
    b, l, _ = x.shape
    kw = dict(max_new_tokens=6, temperature=0.0, eos_token_id=-1,
              pad_token_id=0, quantize_cache=kind)
    ref = jeng.generate(jp["llm"], jcfg, jnp.asarray(x), jnp.asarray(am),
                        jnp.asarray(pos), jax.random.PRNGKey(0), **kw)
    quant4.reset_launches()
    da.reset_launches()
    got = engine.generate(tp["llm"], tcfg, torch.tensor(x),
                          torch.tensor(am), torch.tensor(pos),
                          torch.Generator().manual_seed(0), **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    assert len(set(map(tuple, got.tokens.numpy()))) == b
    # CPU tensors: the plain versions ran, no kernel launched
    assert set(quant4.launches.values()) == {0}
    assert set(da.launches.values()) == {0}

    # first decode step's logits: prefill into the quantized cache, head on
    # the last position, as both engines do
    cap = engine.cache_capacity(tcfg, l, 6)
    jc = jdec.init_cache(jcfg, b, cap, quantize=kind)
    jc["mask"] = jc["mask"].at[:, :l].set(jnp.asarray(am))
    pre = (np.pad(am, ((0, 0), (0, cap - l)))[:, None, None, :]
           & (np.arange(cap)[None, None, None, :]
              <= np.arange(l)[None, None, :, None]))
    jh, _ = jdec.forward(jp["llm"], jcfg, jnp.asarray(x), jnp.asarray(pos),
                         jnp.asarray(pre), jc, return_hidden=True)
    jlog = np.asarray(jdec.head_logits(jp["llm"], jcfg, jh[:, -1]))
    tc = decoder.init_cache(tcfg, b, cap, quantize=kind, device="cpu")
    tc["mask"][:, :l] = torch.tensor(am)
    th, _ = decoder.forward(tp["llm"], tcfg, torch.tensor(x),
                            torch.tensor(pos), torch.tensor(pre), tc,
                            return_hidden=True)
    tlog = decoder.head_logits(tp["llm"], tcfg, th[:, -1]).numpy()
    assert np.abs(tlog - jlog).max() <= LOGIT_BOUND * np.abs(jlog).max()
    np.testing.assert_array_equal(tlog.argmax(-1), jlog.argmax(-1))


QUESTIONS = ("What are the keywords of this protein?", "List keywords.",
             "Keywords of the protein below, please:",
             "Name its UniProt keywords")


def _examples():
    rng = np.random.default_rng(0)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    return [(q, "".join(rng.choice(aa, int(n))), "kw")
            for q, n in zip(QUESTIONS, rng.integers(5, 30, 4))]


@pytest.mark.parametrize("kind", ["int4", "int8"])
def test_annotation_eval_matches_jax(models, kind):
    jp, tp = models
    gen_kw = dict(max_new_tokens=8, temperature=0.0, eos_token_id=2,
                  pad_token_id=0, quantize_cache=kind)
    kw = dict(batch_size=2, prompt_bucket=32, esm_bucket=32,
              log_fn=lambda *_: None)
    ref = jrunner.run_annotation_eval(
        jp, _cfg(jconfig), JByteTokenizer(), FILE,
        gen=jconfig.GenerationConfig(**gen_kw),
        examples=[jds.AnnotationExample(*e) for e in _examples()], **kw)
    got = runner.run_annotation_eval(
        tp, _cfg(config), ByteTokenizer(), FILE,
        gen=config.GenerationConfig(**gen_kw),
        examples=[ds.AnnotationExample(*e) for e in _examples()], **kw)
    texts = [r["generated"] for r in got.results]
    assert texts == [r["generated"] for r in ref.results]
    assert len(set(texts)) > 1
    assert 0 < got.decode_tokens <= 2 * 2 * 8
