"""Sequence parallelism of the port (opus_pllm_tpu_torch.parallel.ring,
infer/sp_engine.py) against the JAX package on the CPU.

Four gloo ranks start once for the file (tests/torch_dist.RankPool); the
2-rank cases run on the first two. `ring_attention` (causal and not, GQA
(8, 2)) and `sharded_decode_attention` (MHA and GQA) equal the JAX functions
over the conftest's fake devices within 1e-5 in fp32, and the ring's
backward (dq, dk, dv at 2 and 4 ranks, causal and not, once under a
checkpoint that repeats the forward ring) equals jax.vjp through JAX's
ring within 1e-5 of each tensor's largest entry.
`generate_seq_sharded` gives the JAX package's greedy tokens (its own
`generate_seq_sharded`, and `engine.generate`, which the JAX tests hold it
to) with a prompt that is not a multiple of the shard count, stop
sequences, dynamic NTK and an int8 cache; the first step's logits are
within 1e-4, and every rank holds the same tokens."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_cases as cases
from opus_pllm_tpu.core.config import DecoderConfig as JDecoderConfig
from opus_pllm_tpu.infer import engine as jengine
from opus_pllm_tpu.infer import sp_engine as jsp
from opus_pllm_tpu.models import decoder as jdecoder
from opus_pllm_tpu.parallel import ring as jring
from torch_dist import RankPool

CFG = dict(family="llama", vocab_size=256, hidden_size=64,
           intermediate_size=128, num_layers=2, num_heads=8, num_kv_heads=2,
           head_dim=8, max_position_embeddings=512, dtype="float32")


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("ring"))
    yield p
    p.close()


def _qkv(hq, hkv, b=2, s=32, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, hq, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, s, hkv, d)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    mask = np.ones((b, s), bool)
    mask[1, -11:] = False                        # a right-padded row
    return q, k, v, mask


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(pool, n, causal):
    q, k, v, mask = _qkv(8, 2)
    ref = np.asarray(jring.ring_self_attention(
        jring.make_sp_mesh(n), *map(jnp.asarray, (q, k, v, mask)),
        causal=causal))
    outs = pool.run(cases.ring_attention, n, q, k, v, mask, causal)
    for out in outs[:n]:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert all(o is None for o in outs[n:])


@pytest.mark.parametrize("n,causal,remat", [
    (2, True, False), (2, False, False), (4, True, True), (4, False, False)],
    ids=["2-causal", "2-full", "4-causal-remat", "4-full"])
def test_ring_attention_backward_matches_jax_vjp(pool, n, causal, remat):
    """dq, dk, dv of the reverse ring against jax.vjp through JAX's ring
    (GQA 8 / 2, a right-padded tail), within 1e-5 of each tensor's
    largest entry; every rank returns (none hangs under the causal skip),
    also when a checkpoint repeats the forward ring in the backward."""
    q, k, v, mask = _qkv(8, 2)
    dout = np.random.default_rng(5).standard_normal(q.shape).astype(
        np.float32)
    mesh = jring.make_sp_mesh(n)
    out, vjp = jax.vjp(
        lambda a, b, c: jring.ring_self_attention(mesh, a, b, c,
                                                  jnp.asarray(mask),
                                                  causal=causal),
        *map(jnp.asarray, (q, k, v)))
    ref = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    outs = pool.run(cases.ring_attention_grad, n, q, k, v, mask, dout,
                    causal, remat)
    assert all(o is None for o in outs[n:])
    got = [np.concatenate([o[i] for o in outs[:n]], axis=1)
           for i in range(4)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        err = np.abs(a - b).max()
        assert err <= 1e-5 * np.abs(b).max(), (name, err)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_sharded_decode_attention_matches_jax(pool, hq, hkv):
    from jax.sharding import PartitionSpec as P
    b, s, d, n = 2, 64, 16, 4
    rng = np.random.default_rng(7)
    q = (rng.standard_normal((b, 1, hq, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, s, hkv, d)) * 0.5).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    mask = np.ones((b, s), bool)
    mask[0, 50:] = False
    mask[1, 23:] = False
    fn = jax.shard_map(jring.sharded_decode_attention,
                       mesh=jring.make_sp_mesh(n),
                       in_specs=(P(), P(None, jring.SEQ_AXIS),
                                 P(None, jring.SEQ_AXIS),
                                 P(None, jring.SEQ_AXIS)),
                       out_specs=P())
    ref = np.asarray(jax.jit(fn)(*map(jnp.asarray, (q, k, v, mask))))
    for out in pool.run(cases.sharded_decode, n, q, k, v, mask):
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _model(seed=0, l=13):
    cfg = JDecoderConfig(**CFG)
    params = jdecoder.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, cfg.vocab_size, (2, l)).astype(np.int32)
    mask = np.ones((2, l), bool)
    mask[1, :4] = False                       # row 1 left-padded shorter
    ids[1, :4] = 0
    emb = np.asarray(jdecoder.embed_tokens(params, jnp.asarray(ids)))
    return cfg, params, emb, mask


@functools.lru_cache(maxsize=None)
def _jax_tokens(seed, l, kw_items, n=None, ntk=False):
    """The JAX greedy tokens and lengths of `_model(seed, l)` (dynamic NTK
    over a 16-position window when `ntk`), once a process."""
    cfg, params, emb, mask = _model(seed, l)
    if ntk:
        cfg = dataclasses.replace(cfg, use_dynamic_ntk=True,
                                  max_position_embeddings=16)
    return _jax_generate(cfg, params, emb, mask, dict(kw_items), n)


def _jax_generate(cfg, params, emb, mask, kw, n=None):
    e, m = jnp.asarray(emb), jnp.asarray(mask)
    pos = jdecoder.positions_from_mask(m)
    if n is None:
        out = jengine.generate(params, cfg, e, m, pos,
                               jax.random.PRNGKey(1), **kw)
    else:
        out = jsp.generate_seq_sharded(params, cfg, e, m, pos,
                                       jax.random.PRNGKey(1),
                                       mesh=jring.make_sp_mesh(n), **kw)
    return np.asarray(out.tokens), np.asarray(out.lengths)


def _first_logits(cfg, params, emb, mask):
    from opus_pllm_tpu.models.layers import causal_mask
    m = jnp.asarray(mask)
    lg, _ = jax.jit(jdecoder.forward, static_argnums=1)(
        params, cfg, jnp.asarray(emb), jdecoder.positions_from_mask(m),
        causal_mask(m))
    return np.asarray(lg[:, -1])


def _check(outs, n, tokens, lengths, logits=None):
    mine = [o for o in outs if o is not None]
    assert len(mine) == n
    for toks, lens, _ in mine:                   # every rank in lockstep
        np.testing.assert_array_equal(toks, tokens)
        np.testing.assert_array_equal(lens, lengths)
    if logits is not None:
        np.testing.assert_allclose(mine[-1][2], logits, atol=1e-4,
                                   rtol=1e-4)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


GREEDY = (("eos_token_id", -1), ("max_new_tokens", 10), ("temperature", 0.0))


def test_sp_generate_matches_jax_greedy(pool):
    """L = 13 over 2 shards and over 4 (left-padded to 16) against the
    JAX generate_seq_sharded over 2 (which the JAX tests hold to its
    engine.generate)."""
    cfg, params, emb, mask = _model()
    toks, lens = _jax_tokens(0, 13, GREEDY, 2)
    logits = _first_logits(cfg, params, emb, mask)
    for n in (2, 4):
        outs = pool.run(cases.sp_generate, n, CFG, _np_tree(params), emb,
                        mask, dict(GREEDY))
        _check(outs, n, toks, lens, logits)


def test_sp_generate_stop_sequences_and_eos(pool):
    cfg, params, emb, mask = _model()
    first, _ = _jax_tokens(0, 13, GREEDY, 2)
    kw = dict(GREEDY, stop_sequences=jengine.make_stop_sequences(
        [[int(first[0, 0])]]), eos_token_id=int(first[1, 2]))
    toks, lens = _jax_generate(cfg, params, emb, mask, kw)
    assert lens[0] == 1 and lens.max() < 10       # both stops act
    outs = pool.run(cases.sp_generate, 2, CFG, _np_tree(params), emb, mask,
                    kw)
    _check(outs, 2, toks, lens)


def test_sp_generate_dynamic_ntk(pool):
    _, params, emb, mask = _model()
    fields = dict(CFG, use_dynamic_ntk=True, max_position_embeddings=16)
    toks, lens = _jax_tokens(0, 13, GREEDY, ntk=True)
    outs = pool.run(cases.sp_generate, 4, fields, _np_tree(params), emb,
                    mask, dict(GREEDY))
    _check(outs, 4, toks, lens)


def test_sp_generate_int8_cache(pool):
    _, params, emb, mask = _model()
    kw = GREEDY + (("quantize_cache", "int8"),)
    toks, lens = _jax_tokens(0, 13, kw)
    outs = pool.run(cases.sp_generate, 2, CFG, _np_tree(params), emb, mask,
                    dict(kw))
    _check(outs, 2, toks, lens)
