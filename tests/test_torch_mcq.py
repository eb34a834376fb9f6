"""Port parity for the MCQ benchmark: opus_pllm_tpu_torch.evals.mcq, the
MCQ half of evals.datasets, infer.conversation and the three MCQ runners
of evals.runner against the JAX package's.

The model is tests/test_torch_slice.py's (OpusConfig.tiny("llama") with
ESM2 at E=128, H=2, so the JAX side runs its fused Pallas encoder in
interpret mode; embeddings and switch gains raised so that greedy output
varies with the protein). Same converted weights, same questions, greedy
decoding: texts, Accuracy and OptionCounts must be identical."""

import dataclasses
import json
import types

import jax
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from opus_pllm_tpu.core import config as jconfig
from opus_pllm_tpu.evals import datasets as jds
from opus_pllm_tpu.evals import mcq as jmcq
from opus_pllm_tpu.evals import runner as jrunner
from opus_pllm_tpu.infer import conversation as jconv
from opus_pllm_tpu.infer.tokenization import ByteTokenizer as JByteTokenizer
from opus_pllm_tpu.models import opus as jopus
from opus_pllm_tpu_torch.core import config, convert
from opus_pllm_tpu_torch.evals import datasets as ds
from opus_pllm_tpu_torch.evals import mcq, runner
from opus_pllm_tpu_torch.infer import conversation as conv
from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer

FILE = "mini_mcq.json"
# the scored prefill's logits: fp32 on both sides, one summation order
# apart (ESM2's plain versions vs the interpreted Pallas kernels, the
# decoder's torch vs XLA products)
LOGIT_ATOL = 1e-3

ANSWERS = ["A", "B", "C", "D", "b", "The correct answer is C)", "answer: d",
           "答案是 B", "答案是B", "(A) first", "none of them", "", "D.",
           "c】", "E) other", "the answer is maybe"]


def _cfg(mod):
    c = mod.OpusConfig.tiny("llama")
    return dataclasses.replace(
        c, esm=mod.ESM2Config(num_layers=2, embed_dim=128, num_heads=2),
        cstp=dataclasses.replace(c.cstp, protein_dim=128))


def _questions():
    rng = np.random.default_rng(0)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    qs = ["Which compartment hosts this protein?", "Pick the cofactor.",
          "What is the catalytic residue?", "Which family is it in?",
          "What does it bind?"]
    opts = [["A) Nucleus", "B) Membrane", "C) Cytosol", "D) Golgi"],
            ["A) Zn", "B) Mg", "C) Fe", "D) Cu"],
            ["A) Serine", "B) Histidine", "C) Cysteine", "D) Lysine"],
            ["A) Kinase", "B) Protease", "C) Lipase", "D) Ligase"],
            ["A) DNA", "B) RNA", "C) ATP"]]
    return [(q, o, "".join(rng.choice(aa, int(n))), "ABCD"[i % 4])
            for i, (q, o, n) in enumerate(zip(qs, opts,
                                              rng.integers(5, 30, 5)))]


def _chat_tokenizer(base):
    """A stand-in for a tokenizer with a chat template (the HF branch of
    the MCQ prompt rendering): Llama-3-style headers over `base`."""

    class ChatTok(base):
        def apply_chat_template(self, messages, add_generation_prompt):
            out = "<|begin_of_text|>"
            for m in messages:
                out += (f"<|start_header_id|>{m['role']}<|end_header_id|>"
                        f"\n\n{m['content']}<|eot_id|>")
            if add_generation_prompt:
                out += "<|start_header_id|>assistant<|end_header_id|>\n\n"
            return out

    return ChatTok()


GEN = dict(max_new_tokens=6, temperature=0.0, eos_token_id=2, pad_token_id=0)
KW = dict(batch_size=2, prompt_bucket=32, esm_bucket=32)


@pytest.fixture(scope="module")
def models():
    # seed 2: a draw whose greedy answers differ between rows at these
    # long ChatML prompts (most draws answer every row alike)
    jp = jopus.init(jax.random.PRNGKey(2), _cfg(jconfig))
    emb = jp["llm"]["embed_tokens"]["embedding"]
    jp["llm"]["embed_tokens"]["embedding"] = emb * 10
    for layer, gain in zip(jp["switch"]["layers"], (100.0, 10.0)):
        layer["kernel"], layer["bias"] = layer["kernel"] * gain, \
            layer["bias"] * 0.0
    return jp, convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX runners' results, computed once: the static runner with the
    ByteTokenizer and with the chat-template stand-in, and the scored
    runner's next-token logits and letters."""
    jp, _ = models
    exs = [jds.MCQExample(*q) for q in _questions()]
    quiet = dict(log_fn=lambda *_: None)
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for name, tok in (("bytes", JByteTokenizer()),
                          ("chat", _chat_tokenizer(JByteTokenizer))):
            out[name] = jrunner.run_mcq_eval(
                jp, _cfg(jconfig), tok, FILE,
                gen=jconfig.GenerationConfig(**GEN), impl="fused",
                examples=list(exs), **KW, **quiet)
        out["scored"] = jrunner.run_mcq_eval_scored(
            jp, _cfg(jconfig), JByteTokenizer(), FILE, impl="fused",
            examples=list(exs), **KW, **quiet)
        tok = JByteTokenizer()
        prompts = [_chatml(jds.mcq_prompt(e.question, e.options))
                   for e in exs[:2]]
        ids, mask, esm_toks = jrunner._prepare_inputs(
            tok, prompts, [e.sequence for e in exs[:2]],
            prompt_bucket=32, esm_bucket=32)
        out["logits"] = np.asarray(jrunner._mcq_next_logits(
            jp, _cfg(jconfig), ids, mask, esm_toks, impl="fused"))
    return out


def _chatml(instr):
    c = jconv.VICUNA_V3.copy()
    c.append("user", "<seq>\n" + instr)
    return c.get_prompt_chatml(add_generation_prompt=True)


def _examples():
    return [ds.MCQExample(*q) for q in _questions()]


# --- scoring, prompts, templates ------------------------------------------

@pytest.mark.parametrize("text", ANSWERS + [None])
def test_extract_option_letter_matches_jax(text):
    if text is None:
        with pytest.raises(TypeError):
            jmcq.extract_option_letter(text)
        with pytest.raises(TypeError):
            mcq.extract_option_letter(text)
        return
    assert mcq.extract_option_letter(text) == \
        jmcq.extract_option_letter(text)


def test_score_matches_jax():
    results = [{"generated": g, "ground_truth": t}
               for g, t in zip(ANSWERS, "ABCDBCDBBAANDCEA")]
    got = mcq.score(results)
    assert got == jmcq.score(results)
    assert got[0] == pytest.approx(11 / 16)
    assert got[1] == {"A": 2, "B": 3, "C": 3, "D": 3, "None": 5}
    assert mcq.score([]) == (0.0, {"A": 0, "B": 0, "C": 0, "D": 0,
                                   "None": 0})


def test_mcq_prompt_and_loader_match_jax(tmp_path):
    q, opts, seq, ans = _questions()[0]
    got = ds.mcq_prompt(q, opts)
    assert got == jds.mcq_prompt(q, opts)
    assert "\n        Options:\n        A) Nucleus\nB) Membrane" in got
    path = tmp_path / "x_mcq_1.json"
    path.write_text(json.dumps(
        [{"question": q, "options": opts, "input": seq, "answer": ans},
         {"question": "dropped", "options": [], "input": None,
          "answer": "A"}]))
    got = ds.load_mcq_json(str(path))
    assert [dataclasses.astuple(e) for e in got] == \
        [dataclasses.astuple(e) for e in jds.load_mcq_json(str(path))]
    assert got == [ds.MCQExample(q, opts, seq, ans)]


def _filled(mod, style):
    c = mod.Conversation(system="You are a protein expert.",
                         roles=["USER", "ASSISTANT"], sep="###",
                         sep2="</s>", sep_style=getattr(
                             mod.SeparatorStyle, style))
    c.append("USER", "What is <seq>?")
    c.append("ASSISTANT", "A kinase.")
    c.append("USER", "Which family?")
    c.append("ASSISTANT", "")
    return c


@pytest.mark.parametrize("style", [s.name for s in jconv.SeparatorStyle])
def test_every_separator_style_matches_jax(style):
    assert [s.name for s in conv.SeparatorStyle] == \
        [s.name for s in jconv.SeparatorStyle]
    got, ref = _filled(conv, style), _filled(jconv, style)
    assert got.get_prompt() == ref.get_prompt()
    assert got.get_prompt_chatml() == ref.get_prompt_chatml()
    assert got.get_prompt_chatml(add_generation_prompt=False) == \
        ref.get_prompt_chatml(add_generation_prompt=False)
    cp = got.copy()
    cp.append("USER", "more")
    assert len(cp.messages) == len(got.messages) + 1


def test_presets_and_reference_template_match_jax():
    assert conv.REFERENCE_CHATML_TEMPLATE == jconv.REFERENCE_CHATML_TEMPLATE
    for name in ("VICUNA_V0", "VICUNA_V1", "VICUNA_V3"):
        a, b = getattr(conv, name), getattr(jconv, name)
        assert (a.system, a.roles, a.sep, a.sep2, a.sep_style.name) == \
            (b.system, b.roles, b.sep, b.sep2, b.sep_style.name)
    instr = ds.mcq_prompt(*_questions()[1][:2])
    c = conv.VICUNA_V3.copy()
    c.append("user", "<seq>\n" + instr)
    assert c.get_prompt_chatml() == _chatml(instr)
    assert conv.VICUNA_V3.messages == []      # copy() leaves the preset
    assert conv.annotation_prompt("x") == jconv.annotation_prompt("x")


def test_letter_candidates_pin_the_jax_behaviour():
    """With the byte tokenizer " A" starts with the space byte, so every
    letter shares that candidate: the JAX behaviour, kept."""
    for c in "ABCD":
        got = runner._letter_token_candidates(ByteTokenizer(), c)
        assert got == jrunner._letter_token_candidates(JByteTokenizer(), c)
        assert got == [ord(c) + 4, ord(" ") + 4]


# --- the runners ----------------------------------------------------------

def test_mcq_eval_matches_jax(models, jax_runs, tmp_path):
    _, tp = models
    save = tmp_path / "out.json"
    got = runner.run_mcq_eval(
        tp, _cfg(config), ByteTokenizer(), FILE,
        gen=config.GenerationConfig(**GEN), impl="fused",
        examples=_examples(), save_path=str(save), **KW,
        log_fn=lambda *_: None)
    ref = jax_runs["bytes"]
    texts = [r["generated"] for r in got.results]
    assert texts == [r["generated"] for r in ref.results]
    assert len(set(texts)) > 1
    assert got.metrics == ref.metrics
    assert set(got.metrics) == {"Accuracy", "OptionCounts"}
    assert sum(got.metrics["OptionCounts"].values()) == 5
    assert [r["ground_truth"] for r in got.results] == list("ABCDA")
    assert got.decode_tokens > 0 and json.loads(save.read_text()) == \
        got.results


def test_chat_template_branch_matches_jax(models, jax_runs):
    _, tp = models
    tok = _chat_tokenizer(ByteTokenizer)
    render = runner._mcq_renderer(tok, None)
    prompt = render("Q")
    assert prompt.startswith("<|begin_of_text|><|start_header_id|>system")
    assert conv.VICUNA_V3.system in prompt and "<seq>\nQ" in prompt
    got = runner.run_mcq_eval(
        tp, _cfg(config), tok, FILE, gen=config.GenerationConfig(**GEN),
        impl="fused", examples=_examples(), **KW, log_fn=lambda *_: None)
    ref = jax_runs["chat"]
    assert [r["generated"] for r in got.results] == \
        [r["generated"] for r in ref.results]
    assert got.metrics == ref.metrics


def test_mcq_next_logits_and_scored_letters_match_jax(models, jax_runs):
    _, tp = models
    tok = ByteTokenizer()
    exs = _examples()
    prompts = [_chatml(ds.mcq_prompt(e.question, e.options))
               for e in exs[:2]]
    ids, mask, esm_toks = runner._prepare_inputs(
        tok, prompts, [e.sequence for e in exs[:2]], prompt_bucket=32,
        esm_bucket=32, device="cpu")
    got = runner._mcq_next_logits(tp, _cfg(config), ids, mask, esm_toks,
                                  impl="fused").numpy()
    ref = jax_runs["logits"]
    assert got.shape == ref.shape == (2, _cfg(config).llm.vocab_size)
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_ATOL)

    rep = runner.run_mcq_eval_scored(
        tp, _cfg(config), tok, FILE, impl="fused", examples=exs, **KW,
        log_fn=lambda *_: None)
    jrep = jax_runs["scored"]
    assert all(r["generated"] in "ABCD"[:len(e.options)]
               for r, e in zip(rep.results, exs))
    # the letter of each row whose top two option scores differ by more
    # than twice the logit tolerance is the JAX runner's
    cands = {c: runner._letter_token_candidates(tok, c) for c in "ABCD"}
    checked = 0
    for s in range(0, len(exs), 2):
        chunk, n = runner._pad_chunk(exs[s:s + 2], 2)
        ids, mask, esm_toks = runner._prepare_inputs(
            tok, [_chatml(ds.mcq_prompt(e.question, e.options))
                  for e in chunk], [e.sequence for e in chunk],
            prompt_bucket=32, esm_bucket=32, device="cpu")
        lg = runner._mcq_next_logits(tp, _cfg(config), ids, mask,
                                     esm_toks).numpy()
        logp = lg - runner._logsumexp(lg)
        for r, e in enumerate(chunk[:n]):
            sc = sorted(runner._logsumexp_ids(logp[r], cands[c])
                        for c in "ABCD"[:len(e.options)])
            if sc[-1] - sc[-2] > 2 * LOGIT_ATOL:
                checked += 1
                assert rep.results[s + r] == jrep.results[s + r]
    assert checked > 0
    assert rep.metrics["Accuracy"] == round(
        sum(r["generated"] == r["ground_truth"] for r in rep.results) / 5, 4)


def test_engine_matches_static_runner(models):
    _, tp = models
    kw = dict(gen=config.GenerationConfig(**GEN), examples=_examples(),
              log_fn=lambda *_: None)
    static = runner.run_mcq_eval(tp, _cfg(config), ByteTokenizer(), FILE,
                                 impl="auto", **KW, **kw)
    eng = runner.run_mcq_eval_engine(
        tp, _cfg(config), ByteTokenizer(), FILE, max_slots=2,
        steps_per_tick=2, splice_batch=2, prompt_bucket=32, esm_bucket=32,
        **kw)
    assert [r["generated"] for r in eng.results] == \
        [r["generated"] for r in static.results]
    assert eng.metrics == static.metrics
    assert eng.engine["completions"] == 5 and eng.decode_tokens > 0


# The engine runner's options run now, as the JAX runner takes them, and
# so do the static runner's beams and draft; the case ids keep the names
# they had when every option here was refused.
# "runs": greedy letters equal to the runner's without the option (which
# test_engine_matches_static_runner holds to the static runner, and the
# static runner tests to the JAX one). "scored": the run answers every
# question (tests/test_torch_beam_spec.py holds beam search to JAX).
@pytest.mark.parametrize("which, kw, expect", [
    # a mesh of one rank runs as no mesh (meshes of 2 and 4 gloo ranks:
    # tests/test_torch_serve_tp.py)
    pytest.param("static", dict(mesh=types.SimpleNamespace(
        data=1, model=1, data_index=0, model_index=0)), "static-runs",
        id="static-kw0-NotImplementedError"),
    # beams over a sequence-sharded cache are refused, as in JAX
    pytest.param("static", dict(seq_mesh=object(), gen=config.
                                GenerationConfig(**GEN, num_beams=2)),
                 ValueError, id="static-kw1-NotImplementedError"),
    pytest.param("static", dict(gen=config.GenerationConfig(**GEN,
                                                           num_beams=2)),
                 "scored", id="static-kw2-NotImplementedError"),
    # the 2-layer decoder has no 2-layer draft (speculative.py:166-169)
    pytest.param("static",
                 dict(gen=config.GenerationConfig(draft_layers=2)),
                 ValueError, id="static-kw3-NotImplementedError"),
    # an empty bank is no bank (`if lora_bank:`, serve/engine.py:220)
    pytest.param("engine", dict(lora_bank={}), "runs",
                 id="engine-kw4-NotImplementedError"),
    # an adapter the (absent) bank does not hold (serve/engine.py:1103)
    pytest.param("engine", dict(adapter_id="x"), ValueError,
                 id="engine-kw5-NotImplementedError"),
    pytest.param("engine", dict(engine_cache={}), "runs",
                 id="engine-kw6-NotImplementedError"),
    pytest.param("engine", dict(cache_prefix=True), "runs",
                 id="engine-kw7-NotImplementedError"),
    # the engine is tensor-parallel only: a data axis is refused
    pytest.param("engine", dict(mesh=types.SimpleNamespace(data=2,
                                                           model=1)),
                 ValueError, id="engine-kw8-NotImplementedError"),
    pytest.param("engine", dict(gen=config.GenerationConfig(num_beams=2)),
                 ValueError, id="engine-kw9-ValueError"),
    # the 2-layer decoder has no 2-layer draft (serve/engine.py:316-320)
    pytest.param("engine",
                 dict(gen=config.GenerationConfig(draft_layers=2)),
                 ValueError, id="engine-kw10-NotImplementedError"),
])
def test_unported_options_are_refused(models, which, kw, expect):
    _, tp = models
    fn = runner.run_mcq_eval if which == "static" else \
        runner.run_mcq_eval_engine
    call = dict(examples=_examples(), log_fn=lambda *_: None, **kw)
    if expect == "scored":
        rep = fn(tp, _cfg(config), ByteTokenizer(), FILE, **KW, **call)
        assert len(rep.results) == len(_examples())
        assert sum(rep.metrics["OptionCounts"].values()) == len(_examples())
        return
    if expect == "static-runs":
        gen = config.GenerationConfig(**GEN)
        rep = fn(tp, _cfg(config), ByteTokenizer(), FILE, **KW, **call,
                 gen=gen)
        base = fn(tp, _cfg(config), ByteTokenizer(), FILE, **KW, gen=gen,
                  examples=_examples(), log_fn=lambda *_: None)
        assert rep.results == base.results
        return
    if expect == "runs":
        small = dict(gen=config.GenerationConfig(**GEN), max_slots=2,
                     steps_per_tick=2, splice_batch=2, prompt_bucket=32,
                     esm_bucket=32, examples=_examples(),
                     log_fn=lambda *_: None)
        rep = fn(tp, _cfg(config), ByteTokenizer(), FILE, **small, **kw)
        base = fn(tp, _cfg(config), ByteTokenizer(), FILE, **small)
        assert [r["generated"] for r in rep.results] == \
            [r["generated"] for r in base.results]
        assert rep.engine["completions"] == 5
        if "cache_prefix" in kw:
            assert rep.engine["prefix_tokens"] >= 16
        return
    match = {NotImplementedError: "not ported", ValueError:
             "beam search|unknown adapter|draft_layers must be|data 1"}[
                 expect]
    with pytest.raises(expect, match=match):
        fn(tp, _cfg(config), ByteTokenizer(), FILE, **call)
