"""Port parity: opus_pllm_tpu_torch.infer.engine vs opus_pllm_tpu.infer.engine.

nucleus_kth runs on the same numpy probabilities and must pick the same
boundary probability (an element of the input, so compared exactly; the
rows are drawn so no boundary lies within fp32 summation noise of top_p).
Greedy generate must be token-identical to the JAX engine, including the
EOS exit and a stop sequence, on a tiny llama whose embedding table is
scaled up so greedy decoding does not collapse onto one token. Sampling
draws differ by construction (torch.Generator vs jax.random); it is
checked against the distribution it should draw from.

The decode step's one-token forward (`engine.DecodeStep`, a device-tensor
cache slot) gives, called directly, bit for bit the logits and the cache
leaves of a `decoder.forward` step at an int index, in fp32 for the three
families over bf16-layout, int8 and int4 caches; `generate` counts its
steps, none of them a graph replay on the CPU, and hands every step's
logits to `engine.advance_sampling` by its module attribute."""

import dataclasses

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
from opus_pllm_tpu_torch.utils.observability import SPANS


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


def _leaves(cache):
    """Every tensor of a cache: the K/V planes (q, q4 and s of a quantized
    leaf) of each layer, then the mask."""
    out = []
    for lc in cache["layers"]:
        for name in ("k", "v"):
            t = lc[name]
            out += [t[k] for k in sorted(t)] if isinstance(t, dict) else [t]
    return out + [cache["mask"]]


@pytest.mark.parametrize("quantize", [False, "int8", "int4"])
@pytest.mark.parametrize("family", ["qwen2", "llama", "opt"])
def test_decode_step_matches_the_int_index_step(family, quantize):
    cfg = DecoderConfig.tiny(family)
    g = torch.Generator().manual_seed(0)
    params = decoder.init(cfg, generator=g, device="cpu")
    b, l, new = 3, 6, 4
    cap = engine.cache_capacity(cfg, l, new)
    x = torch.randn((b, l, cfg.hidden_size), generator=g)
    am = torch.ones((b, l), dtype=torch.bool)
    am[1, :2] = False
    pos = decoder.positions_from_mask(am)
    caches = []
    for _ in range(2):
        c = decoder.init_cache(cfg, b, cap, device="cpu", quantize=quantize)
        c["mask"][:, :l] = am
        pre = c["mask"][:, None, None, :] & (
            torch.arange(cap)[None, :] <= torch.arange(l)[:, None])
        decoder.forward(params, cfg, x, pos, pre, c,
                        return_hidden=True, ntk_ctx=cap)
        caches.append(c)
    want_c, got_c = caches
    step = engine.DecodeStep(params, cfg, got_c, pos_dtype=pos.dtype,
                             impl="auto", ntk_ctx=cap)
    assert not step.graphed
    for i in range(new):
        tok = torch.randint(0, cfg.vocab_size, (b,), generator=g,
                            dtype=torch.int32)
        p = (pos[:, -1] + 1 + i)[:, None]
        for c in caches:
            c["mask"][:, l + i] = torch.tensor([True, i != 2, True])
        emb = decoder.embed_tokens(params, tok.long())[:, None]
        want, _ = decoder.forward(params, cfg, emb, p,
                                  want_c["mask"][:, None, None, :], want_c,
                                  ntk_ctx=cap)
        got = step(tok, p, l + i)
        assert got.dtype == torch.float32
        assert torch.equal(got, want[:, 0])
    assert want_c["index"] == l + new and step.replays == 0
    for w, t in zip(_leaves(want_c), _leaves(got_c), strict=True):
        assert torch.equal(w, t)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_generate_counts_its_steps_and_samples_every_step(model, monkeypatch,
                                                          temperature):
    _, tcfg, _, tp, x, am, pos = model
    seen = []
    sample = engine.advance_sampling

    def spy(step, done, cur_logits, *a, **k):
        seen.append((step, cur_logits.clone()))
        return sample(step, done, cur_logits, *a, **k)

    monkeypatch.setattr(engine, "advance_sampling", spy)
    before = SPANS.counters()
    out = engine.generate(tp, tcfg, torch.from_numpy(x),
                          torch.from_numpy(am), torch.from_numpy(pos),
                          torch.Generator().manual_seed(0), max_new_tokens=6,
                          temperature=temperature, top_p=0.9)
    after = SPANS.counters()
    grew = lambda k: after.get(k, 0) - before.get(k, 0)
    assert out.steps == 6
    assert [s for s, _ in seen] == list(range(out.steps))
    assert all(type(s) is int for s, _ in seen)
    # each step hands on the logits of the token sampled before it
    assert all(not torch.equal(a, b) for (_, a), (_, b) in
               zip(seen, seen[1:]))
    assert grew("decode.steps") == out.steps
    assert grew("decode.graph_steps") == 0


@pytest.mark.parametrize("device,mesh,graphed", [
    ("cpu", None, False), ("cuda", None, True), ("cuda", "tp", False),
    ("cuda", "fsdp", False)])
def test_the_step_is_a_graph_only_where_one_process_owns_a_card(
        device, mesh, graphed):
    cfg = DecoderConfig.tiny("qwen2")
    if mesh is not None:
        cfg = dataclasses.replace(cfg, **{mesh: object()})
    assert engine._graphable(torch.device(device), cfg) is graphed
