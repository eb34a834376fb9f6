"""Port parity for the serving engine's options: the multi-LoRA bank
(opus_pllm_tpu_torch.lora.lora's bank functions, the per-row
`layers.lora_delta`, `ServingEngine(lora_bank=...)`, add_adapter /
remove_adapter), self-speculative ticks (`draft_layers`, `spec_k`,
`spec_adaptive`, `infer.speculative.accept_and_emit`), the prefix cache
(`register_prefix`, `prefix_id`) and chunked prefill (`chunk_prefill`),
each against the JAX package on a tiny fp32 llama decoder whose weights
cross over through `from_jax`.

Greedy output must be token-identical to the JAX engine (and to the port's
plain engine, or to merged weights): both run the same fp32 function,
within 1e-4 of each other (tests/test_torch_decoder.py), and the prompts
keep clear of near-ties. Cache contents after a speculative tick and after
a chunk step are held to the JAX engine's at every valid slot within
CACHE_ATOL. Sampled rows match in distribution only (`torch.Generator` is
not `jax.random`): `accept_and_emit` is held to the target distribution
by Monte Carlo."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opus_pllm_tpu.core.config import DecoderConfig as JDecoderConfig
from opus_pllm_tpu.core.config import LoRAConfig
from opus_pllm_tpu.infer import speculative as jspec
from opus_pllm_tpu.lora import lora as jlora
from opus_pllm_tpu.models import decoder as jdec
from opus_pllm_tpu.models import layers as jlayers
from opus_pllm_tpu.serve import engine as jserve
from opus_pllm_tpu_torch.core import convert
from opus_pllm_tpu_torch.core.config import DecoderConfig
from opus_pllm_tpu_torch.infer.speculative import (accept_and_emit,
                                                   draft_from_target)
from opus_pllm_tpu_torch.lora import lora
from opus_pllm_tpu_torch.models import layers
from opus_pllm_tpu_torch.serve import engine as tserve
from opus_pllm_tpu_torch.serve.engine import ServeRequest, ServingEngine

CFG = dict(family="llama", vocab_size=128, hidden_size=64,
           intermediate_size=128, num_layers=3, num_heads=4, num_kv_heads=2,
           head_dim=16, dtype="float32")
CACHE_ATOL = 1e-4      # fp32 keys / values, one summation order apart
DELTA_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-5}


def _t(tree):
    """JAX adapter tree -> the same tree of CPU torch tensors."""
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


def _identity_upper(jp):
    """Layers past the first made residual no-ops (zero o_proj and
    down_proj): the 1-layer draft then equals the target."""
    p2 = dict(jp)
    p2["layers"] = list(jp["layers"][:1]) + [
        {**lyr, "o_proj": {"kernel": jnp.zeros_like(lyr["o_proj"]["kernel"])},
         "down_proj": {"kernel":
                       jnp.zeros_like(lyr["down_proj"]["kernel"])}}
        for lyr in jp["layers"][1:]]
    return p2


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = JDecoderConfig(**CFG), DecoderConfig(**CFG)
    jp = jdec.init(jax.random.PRNGKey(0), jcfg)
    tp = convert.decoder_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    lcfg = LoRAConfig(rank=4, alpha=8.0)
    adapters = {}
    for i, name in enumerate(("loc", "go", "ec")):
        t = jlora.init(jax.random.PRNGKey(10 + i), jcfg, lcfg)
        # a PEFT-initialized B is zero: randomize it so the adapter acts
        t = jax.tree.map(
            lambda x: x if x.shape[-1] == lcfg.rank else
            0.3 * jax.random.normal(jax.random.PRNGKey(20 + i), x.shape), t)
        adapters[name] = jlora.fold_scaling(t, jlora.scaling(lcfg))
    return jcfg, tcfg, jp, tp, adapters


def _emb(seed, p):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((p, CFG["hidden_size"])) * 0.3).astype(
        np.float32)


def _run(params, cfg, reqs, mod, max_ticks=400, **kw):
    eng = mod.ServingEngine(params, cfg, **kw)
    done = eng.run([mod.ServeRequest(**r) for r in reqs],
                   max_ticks=max_ticks)
    assert set(done) == {r["request_id"] for r in reqs}
    return done, eng


def _both(tiny, reqs, jax_kw=None, **kw):
    """The same requests through the JAX engine and the port's (the JAX
    one with `jax_kw` in place of kw's bank); greedy tokens and finish
    reasons must agree."""
    jcfg, tcfg, jp, tp, _ = tiny
    jdone, jeng = _run(jp, jcfg, reqs, jserve, **{**kw, **(jax_kw or {})})
    tdone, teng = _run(tp, tcfg, reqs, tserve, **kw)
    for rid in jdone:
        assert tdone[rid].tokens == jdone[rid].tokens, rid
        assert tdone[rid].finish_reason == jdone[rid].finish_reason, rid
    return jdone, tdone, jeng, teng


# ---------------------------------------------------------------------------
# the bank
# ---------------------------------------------------------------------------

def test_bank_functions_match_jax(tiny):
    """make_bank's rows (named, free, zero last), fold_scaling,
    tree_from_flat and stack_adapter's named error, exactly as JAX."""
    *_, adapters = tiny
    jbank, jidx = jlora.make_bank(adapters, capacity=4)
    tbank, tidx = lora.make_bank({n: _t(a) for n, a in adapters.items()},
                                 capacity=4)
    assert tidx == jidx == {"loc": 0, "go": 1, "ec": 2}
    assert set(tbank) == set(jbank)
    for p in jbank:
        for k in ("A", "B"):
            assert tuple(tbank[p][k].shape) == jbank[p][k].shape
            assert tbank[p][k].shape[1] == 5
            np.testing.assert_array_equal(tbank[p][k].numpy(),
                                          np.asarray(jbank[p][k]))
            assert not tbank[p][k][:, 3:].any()        # free + zero rows
    a = adapters["loc"]
    np.testing.assert_array_equal(
        lora.fold_scaling(_t(a), 0.5)["layers"][1]["q_proj"]["B"].numpy(),
        np.asarray(jlora.fold_scaling(a, 0.5)["layers"][1]["q_proj"]["B"]))
    flat = {(li, p): {k: np.asarray(ab[k]) for k in ("A", "B")}
            for li, lp in enumerate(a["layers"]) for p, ab in lp.items()}
    tt = lora.tree_from_flat(flat, 3, device="cpu")
    jt = jlora.tree_from_flat(flat, 3)
    for li in range(3):
        for p, ab in jt["layers"][li].items():
            for k in ("A", "B"):
                np.testing.assert_array_equal(
                    tt["layers"][li][p][k].numpy(), np.asarray(ab[k]))
    bad = {"layers": [dict(lp) for lp in a["layers"]]}
    del bad["layers"][2]["q_proj"]
    for mod, tree in ((jlora, bad), (lora, _t(bad))):
        with pytest.raises(ValueError, match="adapter 'bad' layer 2"):
            mod.stack_adapter("bad", tree)
    with pytest.raises(ValueError, match="empty adapter bank"):
        lora.make_bank({})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_row_lora_delta_matches_jax(dtype):
    """The 3-d (per-row) lora_delta against the JAX one: the same dtype
    chain, within DELTA_ATOL of its fp32 result."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    a = rng.standard_normal((3, 16, 4)).astype(np.float32)
    b = rng.standard_normal((3, 4, 8)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jlayers.lora_delta({"A": jnp.asarray(a), "B": jnp.asarray(b)},
                             jnp.asarray(x).astype(jdt), 0.5)
    got = layers.lora_delta({"A": torch.from_numpy(a),
                             "B": torch.from_numpy(b)},
                            torch.from_numpy(x).to(dtype), 0.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=DELTA_ATOL[dtype], rtol=1e-5)


def test_bank_engine_matches_jax_and_merged_weights(tiny):
    """Mixed adapters and base requests in one batch: greedy tokens equal
    the JAX engine's and, per adapter, a base-only engine over the weights
    with that adapter merged in."""
    jcfg, tcfg, jp, tp, adapters = tiny
    prompts = {name: _emb(i, 5 + 3 * i)
               for i, name in enumerate((None, "loc", "go", "ec"))}
    reqs = [dict(request_id=str(n), embeds=e, max_new_tokens=6,
                 adapter_id=n) for n, e in prompts.items()]
    bank = {n: _t(a) for n, a in adapters.items()}
    _, done, _, _ = _both(tiny, reqs, jax_kw=dict(lora_bank=adapters),
                          lora_bank=bank, max_slots=4, max_len=64,
                          prefill_buckets=(16,), steps_per_tick=2)
    base = LoRAConfig(rank=4, alpha=4.0)           # scaling 1: folded
    refs = {}
    for n, e in prompts.items():
        params = tp if n is None else lora.merge(tp, bank[n], base)
        refs[n], _ = _run(params, tcfg, [dict(request_id=0, embeds=e,
                                              max_new_tokens=6)],
                          tserve,
                          max_slots=2, max_len=64, prefill_buckets=(16,))
        assert done[str(n)].tokens == refs[n][0].tokens, n
    assert len({tuple(r[0].tokens) for r in refs.values()}) > 1


def test_add_and_remove_adapter(tiny):
    """A runtime adapter fills a free row and serves like a built-in one;
    removal is refused while a request uses it, and the bank checks its
    capacity and shapes."""
    _, tcfg, _, tp, adapters = tiny
    bank = {n: _t(a) for n, a in adapters.items()}
    eng = ServingEngine(tp, tcfg, max_slots=2, max_len=64,
                        prefill_buckets=(16,), lora_bank={"loc": bank["loc"]},
                        adapter_capacity=2)
    ref = ServingEngine(tp, tcfg, max_slots=2, max_len=64,
                        prefill_buckets=(16,), lora_bank={"go": bank["go"]})
    assert eng.adapters == ("loc",) and eng.adapter_capacity == 2
    eng.add_adapter("go", bank["go"])
    assert set(eng.adapters) == {"loc", "go"}
    with pytest.raises(ValueError, match="bank is full"):
        eng.add_adapter("ec", bank["ec"])
    with pytest.raises(ValueError, match="already serves"):
        eng.add_adapter("go", bank["go"])
    e = _emb(3, 7)
    want = ref.run([ServeRequest(0, embeds=e, max_new_tokens=8,
                                 adapter_id="go")])[0].tokens
    eng.submit(ServeRequest(0, embeds=e, max_new_tokens=8, adapter_id="go"))
    eng.step()
    with pytest.raises(ValueError, match="in-flight"):
        eng.remove_adapter("go")
    done = eng.run([])
    assert done[0].tokens == want
    eng.remove_adapter("go")
    assert eng.adapters == ("loc",)
    for ab in eng._lora_bank.values():
        assert not ab["A"][:, 1].any() and not ab["B"][:, 1].any()
    narrow = {"layers": [{p: {"A": ab["A"][:, :2], "B": ab["B"][:2]}
                          for p, ab in lp.items()}
                         for lp in bank["ec"]["layers"]]}
    with pytest.raises(ValueError, match="do not match"):
        eng.add_adapter("ec", narrow)
    with pytest.raises(ValueError, match="no adapter bank"):
        ServingEngine(tp, tcfg, max_slots=2, max_len=64,
                      prefill_buckets=(16,)).add_adapter("x", bank["ec"])


# ---------------------------------------------------------------------------
# speculative ticks
# ---------------------------------------------------------------------------

def _spec_reqs(eos=None):
    out = [dict(request_id=i, embeds=_emb(10 + i, 4 + 2 * i),
                max_new_tokens=b)
           for i, b in enumerate((1, 6, 8, 5, 7, 9))]
    if eos is not None:
        out.append(dict(request_id="eos", embeds=_emb(7, 6),
                        max_new_tokens=20, eos_token_id=eos))
    return out


@pytest.mark.parametrize("quantize_cache", [False, "int8"])
def test_spec_ticks_match_jax_and_plain(tiny, quantize_cache):
    """Greedy speculative ticks (several iterations a tick, more requests
    than slots, so slots are parked and handed over) are token-identical
    to the JAX engine and to the port's plain ticks, with budgets and an
    EOS ending mid-chunk."""
    _, tcfg, _, tp, _ = tiny
    kw = dict(max_slots=3, max_len=96, prefill_buckets=(16,),
              steps_per_tick=2, quantize_cache=quantize_cache)
    probe, _ = _run(tp, tcfg, [dict(request_id="p", embeds=_emb(7, 6),
                                    max_new_tokens=20)], tserve, **kw)
    reqs = _spec_reqs(eos=probe["p"].tokens[4])
    plain, _ = _run(tp, tcfg, reqs, tserve, **kw)
    _, done, jeng, eng = _both(tiny, reqs, draft_layers=1, spec_k=3,
                               spec_adaptive=False, **kw)
    for r in reqs:
        assert done[r["request_id"]].tokens == plain[r["request_id"]].tokens
    assert done["eos"].finish_reason == "eos"
    assert [len(done[i].tokens) for i in range(6)] == [1, 6, 8, 5, 7, 9]
    # the same schedule: prefills, slot handovers and ticks
    assert eng.counters == jeng.counters and eng._tick == jeng._tick
    assert eng.counters["parked"] > 0


def test_spec_full_acceptance_and_adaptive_fallback(tiny):
    """Identity upper layers: every proposal verifies, so a greedy row
    consumes spec_k tokens an iteration (few ticks) and the adaptive
    engine keeps speculating; on random weights it falls back to plain
    ticks, and a probe tick turns speculation back on once it pays."""
    _, tcfg, jp, _, _ = tiny
    ident = convert.decoder_from_jax(
        jax.tree.map(np.asarray, _identity_upper(jp)), device="cpu")
    kw = dict(max_slots=2, max_len=96, prefill_buckets=(16,))
    req = [dict(request_id="r", embeds=_emb(5, 6), max_new_tokens=13)]
    plain_ident, _ = _run(ident, tcfg, req, tserve, **kw)
    spec, eng = _run(ident, tcfg, req, tserve, draft_layers=1, spec_k=4,
                     **kw)
    assert spec["r"].tokens == plain_ident["r"].tokens
    # 1 token from the prefill + 3 full-acceptance iterations, where
    # plain ticks need 12
    assert eng._tick <= 5, eng._tick
    assert eng._spec_on and eng._spec_ema > 3.0

    rand = [dict(request_id=i, embeds=_emb(90 + i, 5), max_new_tokens=20)
            for i in range(2)]
    plain, _ = _run(tiny[3], tcfg, rand, tserve, **kw)
    spec, eng = _run(tiny[3], tcfg, rand, tserve, draft_layers=2, spec_k=4,
                     **kw)
    assert eng.spec_adaptive and not eng._spec_on
    for i in range(2):
        assert spec[i].tokens == plain[i].tokens

    eng = ServingEngine(ident, tcfg, draft_layers=1, spec_k=4, **kw)
    eng._spec_on, eng._spec_probe_in = False, 2     # after a fall-back
    done = eng.run([ServeRequest("r", embeds=_emb(5, 6), max_new_tokens=13)])
    assert eng._spec_on, "the probe never turned speculation back on"
    assert done["r"].tokens == plain_ident["r"].tokens


def test_accept_and_emit_matches_jax_and_target_distribution():
    """Greedy rows emit exactly what the JAX rule emits. Sampled rows: with
    proposals drawn from q, the emitted token at position 0 is distributed
    as p_0 and, given one acceptance, position 1 as p_1 (40k rows; the TV
    bounds sit well above the sampling noise)."""
    V, K, n = 10, 4, 40000
    rng = np.random.default_rng(0)
    p = torch.softmax(torch.from_numpy(rng.standard_normal((K, V)) * 1.5)
                      .float(), -1)
    q = torch.softmax(torch.from_numpy(rng.standard_normal((K - 1, V)) * 1.5)
                      .float(), -1)
    g = torch.Generator().manual_seed(1)
    props = torch.stack([torch.multinomial(q[j], n, replacement=True,
                                           generator=g)
                         for j in range(K - 1)], dim=1)
    v = torch.argmax(p, -1).expand(n, K)
    emit, n_emit = accept_and_emit(props, q.expand(n, K - 1, V), v,
                                   p.expand(n, K, V),
                                   torch.zeros(n, dtype=torch.bool), g)
    emit, n_emit = emit.numpy(), n_emit.numpy()
    h0 = np.bincount(emit[:, 0], minlength=V) / n
    assert 0.5 * np.abs(h0 - p[0].numpy()).sum() < 0.02
    sel = emit[n_emit >= 2, 1]
    assert len(sel) > n // 10
    h1 = np.bincount(sel, minlength=V) / len(sel)
    assert 0.5 * np.abs(h1 - p[1].numpy()).sum() < 0.03
    assert (n_emit == 1).sum() > n // 20

    m = 64
    lg = rng.standard_normal((m, K, V)).astype(np.float32)
    pg = np.asarray(jax.nn.softmax(jnp.asarray(lg), -1))
    vg = lg.argmax(-1).astype(np.int32)
    # proposals that match the argmax up to a per-row point
    cut = rng.integers(0, K, m)
    pr = np.where(np.arange(K - 1)[None] < cut[:, None], vg[:, :K - 1],
                  (vg[:, :K - 1] + 1) % V).astype(np.int32)
    qg = np.full((m, K - 1, V), 1.0 / V, np.float32)
    je, jn = jspec.accept_and_emit(jnp.asarray(pr), jnp.asarray(qg),
                                   jnp.asarray(vg), jnp.asarray(pg),
                                   jnp.ones((m,), bool),
                                   jax.random.PRNGKey(0))
    te, tn = accept_and_emit(torch.from_numpy(pr), torch.from_numpy(qg),
                             torch.from_numpy(vg), torch.from_numpy(pg),
                             torch.ones(m, dtype=torch.bool),
                             torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))


def test_draft_from_target_shares_layers(tiny):
    _, tcfg, _, tp, _ = tiny
    dp, dcfg = draft_from_target(tp, tcfg, 2)
    assert dcfg.num_layers == 2 and len(dp["layers"]) == 2
    assert dp["layers"][1] is tp["layers"][1]
    with pytest.raises(ValueError, match=r"draft_layers must be in \[1, 2\]"):
        draft_from_target(tp, tcfg, 3)


def _caches_agree(jeng, teng):
    """Drain both engines; the mirrors agree, and every owned slot's keys
    and values at [0, length) agree within CACHE_ATOL."""
    jeng._drain_pending()
    teng._drain_pending()
    for k in ("active", "length", "remaining", "last_token"):
        np.testing.assert_array_equal(teng.state[k], jeng.state[k])
    slots = sorted(teng._slot_owner)
    assert slots == sorted(jeng._slot_owner) and slots
    for jl, tl in zip(jeng.cache["layers"], teng.cache["layers"]):
        for name in ("k", "v"):
            for s in slots:
                n = int(teng.state["length"][s])
                np.testing.assert_allclose(
                    tl[name][s, :n].numpy(), np.asarray(jl[name][s, :n]),
                    atol=CACHE_ATOL, rtol=0)
    return slots


def test_cache_after_spec_tick_and_chunk_matches_jax(tiny):
    """The port's draft writes the big cache in place and its chunks write
    their slots' rows in place; after a speculative tick, and after each
    chunk step, the cache at every valid slot equals the JAX engine's
    (whose draft writes a copy and whose chunk gathers and scatters)."""
    jcfg, tcfg, jp, tp, _ = tiny
    kw = dict(max_slots=3, max_len=64, prefill_buckets=(8,),
              chunk_prefill=8, draft_layers=2, spec_k=3,
              spec_adaptive=False)
    jeng = jserve.ServingEngine(jp, jcfg, **kw)
    teng = ServingEngine(tp, tcfg, **kw)
    reqs = [dict(request_id=0, embeds=_emb(1, 6), max_new_tokens=12),
            dict(request_id=1, embeds=_emb(2, 20), max_new_tokens=8)]
    for r in reqs:
        jeng.submit(jserve.ServeRequest(**r))
        teng.submit(ServeRequest(**r))
    lens = []
    for _ in range(4):          # admission + chunks beside spec ticks
        jeng.step()
        teng.step()
        slots = _caches_agree(jeng, teng)
        lens.append([int(teng.state["length"][s]) for s in slots])
    assert teng._tick >= 2 and not teng._chunking
    assert lens[-1] != lens[0]


# ---------------------------------------------------------------------------
# prefix cache and chunked prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantize_cache", [False, "int8"])
def test_prefix_and_chunked_prefill_match_jax(tiny, quantize_cache):
    """Requests with a pinned prefix, long prompts in chunks and plain
    admissions, together, greedy: token-identical to the JAX engine; the
    prefix requests also equal their full prompts admitted whole."""
    jcfg, tcfg, jp, tp, _ = tiny
    ids = np.asarray([5, 17, 42, 9, 77, 3, 11, 60, 2, 33], np.int32)
    kw = dict(max_slots=3, max_len=80, prefill_buckets=(8, 16),
              chunk_prefill=8, steps_per_tick=2,
              quantize_cache=quantize_cache)
    jeng = jserve.ServingEngine(jp, jcfg, **kw)
    teng = ServingEngine(tp, tcfg, **kw)
    assert jeng.register_prefix("sys", token_ids=ids) == \
        teng.register_prefix("sys", token_ids=ids.astype(np.int64)) == 10
    reqs = [dict(request_id="p0", embeds=_emb(30, 5), max_new_tokens=6,
                 prefix_id="sys"),
            dict(request_id="c0", embeds=_emb(31, 27), max_new_tokens=7),
            dict(request_id="p1", embeds=_emb(32, 9), max_new_tokens=5,
                 prefix_id="sys"),
            dict(request_id="s0", embeds=_emb(33, 4), max_new_tokens=6),
            dict(request_id="c1", embeds=_emb(34, 19), max_new_tokens=4)]
    jdone = jeng.run([jserve.ServeRequest(**r) for r in reqs])
    tdone = teng.run([ServeRequest(**r) for r in reqs])
    for r in reqs:
        rid = r["request_id"]
        assert tdone[rid].tokens == jdone[rid].tokens, rid
        assert len(tdone[rid].tokens) == r["max_new_tokens"]
    pemb = teng._embed(ServeRequest(0, token_ids=ids.astype(np.int64)))
    full = [dict(request_id=r["request_id"], max_new_tokens=
                 r["max_new_tokens"], embeds=np.concatenate(
                     [pemb.numpy(), r["embeds"]]))
            for r in reqs if r["request_id"][0] == "p"]
    whole, _ = _run(tp, tcfg, full, tserve, **kw)
    for r in full:
        assert whole[r["request_id"]].tokens == \
            tdone[r["request_id"]].tokens


def test_every_option_together_matches_jax(tiny):
    """The bank, speculative ticks (the draft gathers its rows' adapters
    too), a pinned prefix and chunked prefill in one engine, greedy:
    token-identical to the JAX engine with the same options."""
    jcfg, tcfg, jp, tp, adapters = tiny
    ids = np.asarray([9, 4, 77, 31, 5, 60], np.int32)
    kw = dict(max_slots=3, max_len=96, prefill_buckets=(8, 16),
              chunk_prefill=8, steps_per_tick=2, draft_layers=1, spec_k=3,
              spec_adaptive=False)
    jeng = jserve.ServingEngine(jp, jcfg, lora_bank=adapters, **kw)
    teng = ServingEngine(tp, tcfg, lora_bank={n: _t(a) for n, a in
                                              adapters.items()}, **kw)
    jeng.register_prefix("sys", token_ids=ids)
    teng.register_prefix("sys", token_ids=ids.astype(np.int64))
    reqs = [dict(request_id="a", embeds=_emb(60, 6), max_new_tokens=9,
                 adapter_id="loc"),
            dict(request_id="c", embeds=_emb(61, 21), max_new_tokens=7,
                 adapter_id="go"),
            dict(request_id="p", embeds=_emb(62, 5), max_new_tokens=8,
                 prefix_id="sys"),
            dict(request_id="b", embeds=_emb(63, 12), max_new_tokens=6)]
    jdone = jeng.run([jserve.ServeRequest(**r) for r in reqs])
    tdone = teng.run([ServeRequest(**r) for r in reqs])
    for r in reqs:
        rid = r["request_id"]
        assert tdone[rid].tokens == jdone[rid].tokens, rid
        assert len(tdone[rid].tokens) == r["max_new_tokens"]
    assert teng.counters == jeng.counters


def test_prefix_and_chunk_validation_and_cancel_mid_chunk(tiny):
    """Submit's prefix / chunk rules as the JAX engine's; a request
    cancelled between its chunks frees its slot, and the others' tokens
    do not change."""
    _, tcfg, _, tp, adapters = tiny
    kw = dict(max_slots=2, max_len=64, prefill_buckets=(8,), chunk_prefill=8)
    eng = ServingEngine(tp, tcfg, lora_bank={"loc": _t(adapters["loc"])},
                        **kw)
    eng.register_prefix("sys", embeds=_emb(40, 6))
    with pytest.raises(ValueError, match="largest prefill bucket"):
        eng.submit(ServeRequest("x", embeds=_emb(0, 12), prefix_id="sys",
                                max_new_tokens=4))
    with pytest.raises(ValueError, match="suffix token"):
        eng.submit(ServeRequest("x", embeds=np.zeros((0, 64), np.float32),
                                prefix_id="sys", max_new_tokens=4))
    with pytest.raises(ValueError, match="prefix \\(6\\) \\+ prompt"):
        eng.submit(ServeRequest("x", embeds=_emb(0, 4), prefix_id="sys",
                                max_new_tokens=60))
    with pytest.raises(ValueError, match="adapter_id with prefix_id"):
        eng.submit(ServeRequest("x", embeds=_emb(0, 4), prefix_id="sys",
                                max_new_tokens=4, adapter_id="loc"))
    with pytest.raises(ValueError, match="no room"):
        eng.register_prefix("big", embeds=_emb(0, 64))
    with pytest.raises(ValueError, match="chunk_prefill 99 > max_len"):
        ServingEngine(tp, tcfg, max_slots=2, max_len=64,
                      prefill_buckets=(8,), chunk_prefill=99)

    short = dict(request_id="s", embeds=_emb(41, 5), max_new_tokens=10)
    ref, _ = _run(tp, tcfg, [short], tserve, **kw)
    eng = ServingEngine(tp, tcfg, **kw)
    eng.submit(ServeRequest("long", embeds=_emb(42, 30), max_new_tokens=4))
    eng.submit(ServeRequest(**short))
    got = {c.request_id: c for c in eng.step()}
    assert 0 in eng._chunking and eng._chunking[0][2] == 8
    assert eng.cancel("long") and not eng._chunking
    while eng.busy:
        got.update((c.request_id, c) for c in eng.step())
    assert got["long"].finish_reason == "cancelled"
    assert got["long"].tokens == []
    assert got["s"].tokens == ref["s"].tokens
    assert eng.counters["cancelled"] == 1


def test_no_option_mask_leaves_a_query_without_a_key():
    """Every mask the options give the flash kernel lets each query row
    attend at least one key (column 0, or the prefix): the verify pass at
    any lengths, chunks at any offsets and valid counts, prefix merges
    with padded query rows."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        lengths = torch.from_numpy(rng.integers(0, 60, 5))
        assert tserve.verify_mask(lengths, 4, 64).any(-1).all()
        n_valid = torch.from_numpy(rng.integers(1, 17, 5))
        off = torch.from_numpy(rng.integers(0, 48, 5))
        pos, mask = tserve.chunk_inputs(n_valid, off, 16, 64)
        assert mask.any(-1).all() and pos.shape == (5, 16)
        for plen in (0, 7):
            pos, mask = tserve.admission_inputs(n_valid, 16, plen)
            assert mask.any(-1).all() and mask.shape == (5, 1, 16,
                                                         plen + 16)
            assert (pos[:, 0] == plen).all()
