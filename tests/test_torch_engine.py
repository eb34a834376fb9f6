"""Port parity: opus_pllm_tpu_torch.infer.engine vs opus_pllm_tpu.infer.engine.

nucleus_kth runs on the same numpy probabilities and must pick the same
boundary probability (an element of the input, so compared exactly; the
rows are drawn so no boundary lies within fp32 summation noise of top_p).
Greedy generate must be token-identical to the JAX engine, including the
EOS exit and a stop sequence, on a tiny llama whose embedding table is
scaled up so greedy decoding does not collapse onto one token. Sampling
draws differ by construction (torch.Generator vs jax.random); it is
checked against the distribution it should draw from."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opus_pllm_tpu.core.config import DecoderConfig as JDecoderConfig
from opus_pllm_tpu.infer import engine as jeng
from opus_pllm_tpu.models import decoder as jdec
from opus_pllm_tpu_torch.core import convert
from opus_pllm_tpu_torch.core.config import DecoderConfig
from opus_pllm_tpu_torch.infer import engine
from opus_pllm_tpu_torch.models import decoder


def test_nucleus_kth_matches_jax():
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.full(1000, 0.3), size=4).astype(np.float32)
    top_ps = np.array([0.5, 0.7, 0.9, 0.95], np.float32)
    ref = np.asarray(jeng.nucleus_kth(jnp.asarray(probs), jnp.asarray(top_ps)))
    got = engine.nucleus_kth(torch.from_numpy(probs), torch.from_numpy(top_ps))
    np.testing.assert_array_equal(got.numpy(), ref)
    # the sorted-prefix construction it replaces
    for row, tp, k in zip(probs, top_ps, got.numpy()):
        srt = np.sort(row)[::-1]
        n = int(np.searchsorted(np.cumsum(srt), tp * (1 - 1e-6))) + 1
        assert k == srt[min(n, len(srt)) - 1]


@pytest.mark.parametrize("l,head_dim", [(64, 128), (71, 128), (64, 64)])
def test_cache_capacity_matches_jax(l, head_dim):
    jc = JDecoderConfig(head_dim=head_dim)
    tc = DecoderConfig(head_dim=head_dim)
    for new in (1, 64, 300):
        assert engine.cache_capacity(tc, l, new) == \
            jeng.cache_capacity(jc, l, new)


def test_sample_token_draws_from_the_nucleus():
    logits = torch.log(torch.tensor([[0.4, 0.3, 0.15, 0.1, 0.05]]))
    g = torch.Generator().manual_seed(0)
    draws = torch.cat([engine.sample_token(logits, g, 1.0, 1.0)
                       for _ in range(4000)])
    freq = torch.bincount(draws, minlength=5).float() / len(draws)
    np.testing.assert_allclose(freq.numpy(), [0.4, 0.3, 0.15, 0.1, 0.05],
                               atol=0.03)
    nucleus = torch.cat([engine.sample_token(logits, g, 1.0, 0.6)
                         for _ in range(500)])
    assert set(nucleus.tolist()) == {0, 1}       # mass 0.7 >= 0.6
    assert engine.sample_token(logits, g, 0.0, 0.7).item() == 0


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = JDecoderConfig.tiny("llama"), DecoderConfig.tiny("llama")
    jp = jdec.init(jax.random.PRNGKey(0), jcfg)
    jp["embed_tokens"]["embedding"] = jp["embed_tokens"]["embedding"] * 50
    tp = convert.decoder_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 8, 64)).astype(np.float32)
    am = np.ones((3, 8), bool)
    am[1, :3] = False
    am[2, :5] = False
    pos = np.array(jdec.positions_from_mask(jnp.asarray(am)))
    return jcfg, tcfg, jp, tp, x, am, pos


def _both(model, **kw):
    jcfg, tcfg, jp, tp, x, am, pos = model
    ref = jeng.generate(jp, jcfg, jnp.asarray(x), jnp.asarray(am),
                        jnp.asarray(pos), jax.random.PRNGKey(0),
                        temperature=0.0, **kw)
    stop = kw.pop("stop_sequences", None)
    got = engine.generate(tp, tcfg, torch.from_numpy(x), torch.from_numpy(am),
                          torch.from_numpy(pos), torch.Generator(),
                          temperature=0.0, stop_sequences=stop, **kw)
    return ref, got


def test_greedy_generate_token_identical(model):
    ref, got = _both(model, max_new_tokens=12)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    assert got.steps == 12


def test_greedy_generate_eos_and_stop_sequence(model):
    free, _ = _both(model, max_new_tokens=12)
    toks = np.asarray(free.tokens)
    eos = int(toks[0, 2])                     # row 0 ends at its 3rd token
    stop = ((int(toks[1, 4]), int(toks[1, 5])),)
    ref, got = _both(model, max_new_tokens=12, eos_token_id=eos,
                     pad_token_id=0, stop_sequences=stop)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    lengths = got.lengths.tolist()
    assert lengths[0] == 3 and lengths[1] <= 6
    assert (got.tokens[0, 3:] == 0).all()     # pad after done
