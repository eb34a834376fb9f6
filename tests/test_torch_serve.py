"""Port parity: the continuous-batching serving engine
(opus_pllm_tpu_torch.serve.engine) against the JAX `ServingEngine` and the
port's own one-shot `infer.engine.generate`, on a tiny fp32 llama decoder
whose weights cross over through `from_jax`.

Greedy output must be token-identical to both: the two engines run the same
fp32 function (tests/test_torch_decoder.py holds the decoders to 1e-4), and
the prompts here keep clear of near-ties. The scheduler scenarios mirror
tests/test_serve.py: mixed lengths, EOS stop, mid-stream admission, slot
reuse, several steps a tick, no-drain parking with streaming. Also the
(B,)-indexed cache write with mode="drop" against the JAX `_write_cache`,
and the per-row sampler against the JAX one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opus_pllm_tpu.core.config import DecoderConfig as JDecoderConfig
from opus_pllm_tpu.infer import engine as jeng
from opus_pllm_tpu.models import decoder as jdec
from opus_pllm_tpu.serve import engine as jserve
from opus_pllm_tpu_torch.core import convert
from opus_pllm_tpu_torch.core.config import DecoderConfig
from opus_pllm_tpu_torch.infer import engine
from opus_pllm_tpu_torch.models import decoder
from opus_pllm_tpu_torch.serve.engine import (LatencyHistogram, ServeRequest,
                                              ServingEngine)

CFG = dict(family="llama", vocab_size=128, hidden_size=64,
           intermediate_size=128, num_layers=2, num_heads=4, num_kv_heads=2,
           head_dim=16, dtype="float32")


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = JDecoderConfig(**CFG), DecoderConfig(**CFG)
    jp = jdec.init(jax.random.PRNGKey(0), jcfg)
    tp = convert.decoder_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _emb(seed, p):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((p, CFG["hidden_size"])) * 0.3).astype(
        np.float32)


def _ref_tokens(tp, tcfg, emb, max_new, eos=-1):
    """Greedy reference through the port's one-shot engine, eos trimmed."""
    p = emb.shape[0]
    out = engine.generate(
        tp, tcfg, torch.from_numpy(emb[None]), torch.ones((1, p), dtype=bool),
        torch.arange(p)[None], torch.Generator().manual_seed(0),
        max_new_tokens=max_new, temperature=0.0, eos_token_id=eos,
        pad_token_id=0)
    toks = out.tokens[0, :int(out.lengths[0])].tolist()
    return toks[:-1] if toks and toks[-1] == eos else toks


def _both(tiny, reqs, max_ticks=300, **kw):
    """Run the same requests (dicts of ServeRequest fields) through the JAX
    engine and the port's; returns (jax done, port done, port engine)."""
    jcfg, tcfg, jp, tp = tiny
    jdone = jserve.ServingEngine(jp, jcfg, **kw).run(
        [jserve.ServeRequest(**r) for r in reqs], max_ticks=max_ticks)
    eng = ServingEngine(tp, tcfg, **kw)
    tdone = eng.run([ServeRequest(**r) for r in reqs], max_ticks=max_ticks)
    assert set(tdone) == set(jdone) == {r["request_id"] for r in reqs}
    for rid in jdone:
        assert tdone[rid].tokens == jdone[rid].tokens, rid
        assert tdone[rid].finish_reason == jdone[rid].finish_reason, rid
    return jdone, tdone, eng


@pytest.mark.parametrize("k", [1, 4])
def test_mixed_lengths_match_jax_and_generate(tiny, k):
    """Mixed prompt lengths and budgets, two slots; with k = 4 the short
    budgets finish mid-tick."""
    _, tcfg, _, tp = tiny
    prompts = [_emb(s, p) for s, p in ((0, 5), (1, 11), (2, 3), (3, 8))]
    budgets = [6, 3, 9, 5]
    _, done, eng = _both(
        tiny, [dict(request_id=i, embeds=e, max_new_tokens=m)
               for i, (e, m) in enumerate(zip(prompts, budgets))],
        max_slots=2, max_len=64, prefill_buckets=(8, 16), steps_per_tick=k)
    for i, (e, m) in enumerate(zip(prompts, budgets)):
        assert done[i].tokens == _ref_tokens(tp, tcfg, e, m), i
        assert done[i].finish_reason == "length"
    assert len({tuple(done[i].tokens) for i in done}) == 4
    assert eng.counters["completions"] == 4
    assert eng.counters["tokens"] == sum(budgets)
    assert not eng.busy


def test_eos_stops_early(tiny):
    _, tcfg, _, tp = tiny
    emb = _emb(7, 6)
    eos = _ref_tokens(tp, tcfg, emb, 20)[2]     # EOS on the 3rd token
    _, done, _ = _both(tiny, [dict(request_id="r", embeds=emb,
                                   max_new_tokens=20, eos_token_id=eos)],
                       max_slots=2, max_len=64, prefill_buckets=(8,))
    assert done["r"].finish_reason == "eos"
    assert done["r"].tokens == _ref_tokens(tp, tcfg, emb, 20, eos=eos)
    assert len(done["r"].tokens) == 2


def test_mid_stream_admission_does_not_disturb(tiny):
    """A request admitted while another decodes changes neither result."""
    _, tcfg, _, tp = tiny
    a, b = _emb(10, 9), _emb(11, 4)
    eng = ServingEngine(tp, tcfg, max_slots=2, max_len=64,
                        prefill_buckets=(16,))
    eng.submit(ServeRequest("a", embeds=a, max_new_tokens=8))
    got = {}
    for _ in range(4):                       # a few ticks of A alone
        got.update((c.request_id, c) for c in eng.step())
    eng.submit(ServeRequest("b", embeds=b, max_new_tokens=8))
    for _ in range(40):
        got.update((c.request_id, c) for c in eng.step())
        if len(got) == 2:
            break
    assert got["a"].tokens == _ref_tokens(tp, tcfg, a, 8)
    assert got["b"].tokens == _ref_tokens(tp, tcfg, b, 8)


def test_slot_reuse_after_completion(tiny):
    _, tcfg, _, tp = tiny
    e1, e2 = _emb(20, 4), _emb(21, 7)
    _, done, _ = _both(tiny, [dict(request_id=1, embeds=e1, max_new_tokens=3),
                              dict(request_id=2, embeds=e2, max_new_tokens=5)],
                       max_slots=1, max_len=32, prefill_buckets=(8,))
    assert done[2].tokens == _ref_tokens(tp, tcfg, e2, 5)


def test_no_drain_parking_with_streaming_and_eos(tiny):
    """Synchronized waves hand finishing slots over without a drain
    (parking); an EOS-able request finishes early. Every completion and
    every stream matches the JAX engine and the one-shot engine."""
    _, tcfg, _, tp = tiny
    eos = _ref_tokens(tp, tcfg, _emb(400, 5), 12)[3]
    specs = [(i, 300 + i, 6, 8, -1) for i in range(6)] + [
        ("e", 400, 5, 12, eos)]
    streams = {rid: [] for rid, *_ in specs}
    reqs = [dict(request_id=rid, embeds=_emb(s, p), max_new_tokens=m,
                 eos_token_id=e,
                 on_tokens=lambda t, r=rid: streams[r].extend(t))
            for rid, s, p, m, e in specs]
    _, done, eng = _both(tiny, reqs, max_slots=2, max_len=64,
                         prefill_buckets=(8,), steps_per_tick=4,
                         admit_min_free=2)
    for rid, s, p, m, e in specs:
        ref = _ref_tokens(tp, tcfg, _emb(s, p), m, eos=e)
        assert done[rid].tokens == ref, rid
    # both engines streamed into the same lists: the JAX run, then the port's
    for rid in streams:
        assert streams[rid] == done[rid].tokens * 2, rid
    assert done["e"].finish_reason == "eos"
    assert eng.counters["parked"] > 0
    assert all(rs.done for rs in eng._parked) and not eng._slot_owner


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_cache_matches_jax(tiny, kind):
    """The quantized cache holds the same bytes in both packages
    (tests/test_torch_decode_attention.py), so greedy serving over it is
    token-identical too."""
    prompts = [_emb(s, p) for s, p in ((0, 5), (1, 11), (2, 7))]
    _, done, _ = _both(
        tiny, [dict(request_id=i, embeds=e, max_new_tokens=5)
               for i, e in enumerate(prompts)],
        max_slots=2, max_len=64, prefill_buckets=(16,), quantize_cache=kind,
        steps_per_tick=2)
    assert all(len(c.tokens) == 5 for c in done.values())


def test_token_ids_and_tensor_embeds(tiny):
    """A token-id prompt embeds from the vocabulary; an embeds tensor is
    taken as it is (no host round trip)."""
    _, tcfg, _, tp = tiny
    ids = np.asarray([3, 17, 42, 9], np.int64)
    emb = decoder.embed_tokens(tp, torch.from_numpy(ids)).numpy()
    ref = _ref_tokens(tp, tcfg, emb, 6)
    eng = ServingEngine(tp, tcfg, max_slots=2, max_len=32,
                        prefill_buckets=(8,))
    done = eng.run([ServeRequest("t", token_ids=ids, max_new_tokens=6),
                    ServeRequest("e", embeds=torch.from_numpy(emb),
                                 max_new_tokens=6)])
    assert done["t"].tokens == ref and done["e"].tokens == ref


def test_submit_validates_and_refuses_unported(tiny):
    _, tcfg, _, tp = tiny
    eng = ServingEngine(tp, tcfg, max_slots=2, max_len=32,
                        prefill_buckets=(16,))
    with pytest.raises(ValueError, match="largest prefill bucket"):
        eng.submit(ServeRequest("big", embeds=_emb(0, 20)))
    with pytest.raises(ValueError, match="KV capacity"):
        eng.submit(ServeRequest("tight", embeds=_emb(0, 16),
                                max_new_tokens=20))
    with pytest.raises(ValueError, match="embeds or token_ids"):
        eng.submit(ServeRequest("none"))
    with pytest.raises(NotImplementedError, match="prefix cache"):
        eng.submit(ServeRequest("p", embeds=_emb(0, 4), prefix_id="sys"))
    with pytest.raises(NotImplementedError, match="LoRA bank"):
        eng.submit(ServeRequest("l", embeds=_emb(0, 4), adapter_id="x"))
    for kw in (dict(lora_bank={"a": {}}), dict(mesh=object()),
               dict(chunk_prefill=8), dict(draft_layers=1)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingEngine(tp, tcfg, max_slots=2, max_len=32,
                          prefill_buckets=(16,), **kw)
    ok = _emb(1, 8)
    done = eng.run([ServeRequest("ok", embeds=ok, max_new_tokens=4)])
    assert done["ok"].tokens == _ref_tokens(tp, tcfg, ok, 4)


def test_cancel_queued_and_running(tiny):
    """Cancel drops a queued request at once and frees a running one's
    slot; the other requests are untouched."""
    _, tcfg, _, tp = tiny
    a, b, c = _emb(50, 5), _emb(51, 6), _emb(52, 4)
    eng = ServingEngine(tp, tcfg, max_slots=1, max_len=64,
                        prefill_buckets=(8,))
    for rid, e in (("a", a), ("b", b), ("c", c)):
        eng.submit(ServeRequest(rid, embeds=e, max_new_tokens=10))
    got = {}
    for _ in range(3):
        got.update((x.request_id, x) for x in eng.step())
    assert eng.cancel("b") and eng.cancel("a")
    assert not eng.cancel("nope")
    while eng.busy:
        got.update((x.request_id, x) for x in eng.step())
    assert got["b"].finish_reason == got["a"].finish_reason == "cancelled"
    assert got["b"].tokens == []
    ref_a = _ref_tokens(tp, tcfg, a, 10)
    assert 0 < len(got["a"].tokens) < 10
    assert got["a"].tokens == ref_a[:len(got["a"].tokens)]
    assert got["c"].tokens == _ref_tokens(tp, tcfg, c, 10)
    assert eng.counters["cancelled"] == 2


@pytest.mark.parametrize("kind", [None, "int8", "int4"])
def test_per_row_write_cache_drops_like_jax(kind):
    """Each row writes its S new tokens at its own index; rows at or past
    the capacity (and the tail of a row that runs over it) write nothing,
    as the JAX scatter's mode="drop"."""
    b, cap, s, h, d = 4, 8, 3, 2, 16
    rng = np.random.default_rng(0)
    k_new, v_new = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                    for _ in range(2))
    old = rng.standard_normal((b, cap, h, d)).astype(np.float32)
    index = np.asarray([0, 4, 6, 8], np.int32)   # row 2 runs over, 3 drops
    if kind is None:
        jl = {"k": jnp.asarray(old), "v": jnp.asarray(old)}
        tl = {"k": torch.tensor(old), "v": torch.tensor(old)}
    else:
        qf = jdec._quantize_kv4 if kind == "int4" else jdec._quantize_kv
        jl = {"k": qf(jnp.asarray(old)), "v": qf(jnp.asarray(old))}
        tl = {n: {key: torch.tensor(np.asarray(val))
                  for key, val in jl[n].items()} for n in ("k", "v")}
    ref = jdec._write_cache(jl, jnp.asarray(k_new), jnp.asarray(v_new),
                            jnp.asarray(index))
    got = decoder._write_cache(tl, torch.tensor(k_new), torch.tensor(v_new),
                               torch.tensor(index))
    for n in ("k", "v"):
        pairs = ([(got[n], ref[n])] if kind is None else
                 [(got[n][key], ref[n][key]) for key in ref[n]])
        for t, j in pairs:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if kind is None:         # row 3 untouched, row 2 only at slots 6, 7
        np.testing.assert_array_equal(got["k"][3].numpy(), old[3])
        np.testing.assert_array_equal(got["k"][2, 6:].numpy(), k_new[2, :2])


def test_sample_token_rows_mixed_rows_and_warp_parity():
    """The warp (temperature + nucleus) equals the JAX one row for row;
    greedy rows take the argmax unwarped; a top_p of 1e-6 keeps only the
    argmax; a top_p = 1 row really samples; nucleus=False (the host's
    decision when no row needs the pass) changes nothing then."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((4, 64)) * 5).astype(np.float32)
    logits[2] /= 10                           # a flat row to sample from
    temps = np.asarray([0.0, 1.0, 1.0, 0.5], np.float32)
    top_ps = np.asarray([0.7, 1e-6, 1.0, 0.3], np.float32)
    ref = np.asarray(jeng.warp_logits_rows(jnp.asarray(logits),
                                           jnp.asarray(temps),
                                           jnp.asarray(top_ps)))
    got = engine.warp_logits_rows(torch.tensor(logits), torch.tensor(temps),
                                  torch.tensor(top_ps)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6)
    assert np.isfinite(got[0]).all()          # greedy row: left whole
    # the distribution sampled from (softmax of the warp), fp32
    np.testing.assert_allclose(
        engine.warp_probs_rows(torch.tensor(logits), torch.tensor(temps),
                               torch.tensor(top_ps)).numpy(),
        np.asarray(jeng.warp_probs_rows(jnp.asarray(logits),
                                        jnp.asarray(temps),
                                        jnp.asarray(top_ps))),
        rtol=1e-5, atol=1e-7)
    greedy = logits.argmax(-1)
    seen = set()
    for seed in range(32):
        out = engine.sample_token_rows(
            torch.tensor(logits), torch.Generator().manual_seed(seed),
            torch.tensor(temps), torch.tensor(top_ps)).numpy()
        assert out[0] == greedy[0] and out[1] == greedy[1]
        assert np.isfinite(ref[3, out[3]])    # inside row 3's nucleus
        seen.add(int(out[2]))
    assert len(seen) > 1
    no_nucleus = np.asarray([1.0, 1.0, 1.0, 1.0], np.float32)
    for flag in (True, False):
        out = engine.warp_logits_rows(torch.tensor(logits),
                                      torch.tensor(temps),
                                      torch.tensor(no_nucleus),
                                      nucleus=flag).numpy()
        np.testing.assert_array_equal(out, logits / np.maximum(
            temps, 1e-6)[:, None])


def test_sampled_serving_answers_every_request(tiny):
    """T = 0.1 / top_p = 0.7 (the reference's decode mode) next to greedy
    requests: every request gets its full budget of valid ids, the greedy
    ones token-identical to the one-shot engine."""
    _, tcfg, _, tp = tiny
    eng = ServingEngine(tp, tcfg, max_slots=3, max_len=64,
                        prefill_buckets=(16,), steps_per_tick=2, seed=3)
    reqs = [ServeRequest(i, embeds=_emb(60 + i, 5 + i), max_new_tokens=6,
                         temperature=0.1 if i % 2 else 0.0, top_p=0.7)
            for i in range(5)]
    done = eng.run(reqs)
    for i in range(5):
        assert len(done[i].tokens) == 6
        assert all(0 <= t < CFG["vocab_size"] for t in done[i].tokens)
        if i % 2 == 0:
            assert done[i].tokens == _ref_tokens(tp, tcfg, _emb(60 + i, 5 + i),
                                                 6)


def test_reseed_repeats_sampled_output(tiny):
    """reseed() restarts the sampling stream: the same sampled requests
    run again on the same engine give the same tokens."""
    _, tcfg, _, tp = tiny
    eng = ServingEngine(tp, tcfg, max_slots=2, max_len=32,
                        prefill_buckets=(8,), seed=5)

    def run():
        eng.reseed(5)
        done = eng.run([ServeRequest(i, embeds=_emb(70 + i, 6),
                                     max_new_tokens=5, temperature=1.0)
                        for i in range(3)])
        return [done[i].tokens for i in range(3)]

    assert run() == run()


def test_latency_histogram_matches_jax():
    values = [0.001, 0.02, 0.02, 0.3, 0.7, 4.0, 100.0]
    j, t = jserve.LatencyHistogram(), LatencyHistogram()
    for v in values:
        j.observe(v)
        t.observe(v)
    assert t.counts == j.counts and t.mean == pytest.approx(j.mean)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert t.percentile(q) == j.percentile(q)
