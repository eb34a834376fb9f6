"""The port's recorder (`utils.observability`): spans, their parents and
threads, the ring's bound, counters under two threads, the off state, the
profiler ranges a span enters only under a recording profiler, and the
spans and counters the annotate batch, the train step, the prefetch thread
and the collated batches record, at the tiny configuration on the CPU."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from opus_pllm_tpu_torch.cli import main as cli
from opus_pllm_tpu_torch.core.config import (GenerationConfig, LoRAConfig,
                                             OpusConfig, TrainConfig)
from opus_pllm_tpu_torch.data import collate
from opus_pllm_tpu_torch.evals import runner
from opus_pllm_tpu_torch.infer import engine
from opus_pllm_tpu_torch.infer.conversation import (VICUNA_V0,
                                                    annotation_prompt)
from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
from opus_pllm_tpu_torch.models import opus
from opus_pllm_tpu_torch.train import multimodal_trainer as mmt
from opus_pllm_tpu_torch.utils import observability as obs
from opus_pllm_tpu_torch.utils.prefetch import prefetch_to_device

PROTEINS = ["MKTAYIAKQRQISFVKSHF", "MKVL", "MSTNPKPQRKTKRNTNRRPQDVKFPGG"]


def _since(mark):
    """The global recorder's spans opened after `mark` (a span id), by
    name."""
    out = {}
    for s in obs.SPANS.spans():
        if s.id > mark:
            out.setdefault(s.name, []).append(s)
    return out


def _mark():
    with obs.span("test.mark") as s:
        return s.id


def test_spans_nest_with_parents_and_attributes():
    rec = obs.Recorder()
    with rec.span("a", batch=3) as a:
        with rec.span("b", device="cpu") as b:
            with rec.span("c") as c:
                pass
        with rec.span("d") as d:
            pass
    got = {s.name: s for s in rec.spans()}
    assert [s.name for s in rec.spans()] == ["c", "b", "d", "a"]
    assert (a.parent, b.parent, c.parent, d.parent) == (None, a.id, b.id,
                                                        a.id)
    assert got["a"].attrs == {"batch": 3, "profiled": False}
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns
    assert b.end_ns <= d.start_ns <= d.end_ns <= a.end_ns
    assert {s.thread for s in rec.spans()} == {
        threading.current_thread().name}
    # a device span on the CPU reads the host clock; a host span has none
    assert b.device_ms == b.host_ms and a.device_ms is None


def test_spans_of_another_thread_have_their_own_parents():
    rec = obs.Recorder()
    opened, release = threading.Event(), threading.Event()

    def other():
        with rec.span("other.root"):
            opened.set()
            release.wait(10)
            with rec.span("other.child"):
                pass

    t = threading.Thread(target=other, name="other-thread")
    with rec.span("main.root") as root:
        t.start()
        assert opened.wait(10)
        with rec.span("main.child") as child:
            release.set()
            t.join(10)
    assert not t.is_alive()
    got = {s.name: s for s in rec.spans()}
    assert child.parent == root.id
    assert got["other.root"].parent is None
    assert got["other.child"].parent == got["other.root"].id
    assert got["other.root"].thread == "other-thread"
    assert got["main.root"].thread == threading.current_thread().name


def test_the_ring_keeps_the_newest_spans():
    rec = obs.Recorder(ring=8)
    for i in range(20):
        with rec.span("s", i=i):
            pass
    assert [s.attrs["i"] for s in rec.spans()] == list(range(12, 20))


def test_counters_are_exact_under_two_threads():
    rec = obs.Recorder()
    n = 20000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [rec.count("x", 3)
                                               for _ in range(n)])
              for _ in range(2)]
        for t in ts:
            t.start()
        for _ in range(n):
            rec.count("x")
        for t in ts:
            t.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert rec.counters() == {"x": 7 * n}


def test_off_records_nothing():
    rec = obs.Recorder()
    rec.enabled = False
    first = rec.span("a", device="cpu")
    assert first is rec.span("b")
    with first as s:
        rec.count("n", 5)
    assert s is None
    assert rec.spans() == [] and rec.counters() == {}


def test_no_profiler_range_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def record_function(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    rec = obs.Recorder()
    with rec.span("a", device="cpu"), obs.prof_range("r"):
        assert list(obs.ranged(range(5), "q", 2)) == list(range(5))
    assert entered == []
    assert rec.spans()[0].attrs["profiled"] is False
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with rec.span("a"), obs.prof_range("r"):
            assert list(obs.ranged(range(5), "q", 2)) == list(range(5))
    assert entered == ["a", "r", "q", "q", "q"]
    assert rec.spans()[-1].attrs["profiled"] is True


def test_spans_stand_in_the_profiler_trace_as_recorded(tmp_path):
    rec = obs.Recorder()
    x = torch.ones(8)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.span("outer"):
            with rec.span("inner"):
                x = x * 2
            with obs.prof_range("profiler.only"):
                x = x + 1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("cat") == "user_annotation"}
    assert {"outer", "inner", "profiler.only"} <= set(ev)

    def inside(a, b):
        return (ev[b]["ts"] <= ev[a]["ts"]
                and ev[a]["ts"] + ev[a]["dur"] <= ev[b]["ts"] + ev[b]["dur"])
    assert inside("inner", "outer") and inside("profiler.only", "outer")
    assert [s.name for s in rec.spans()] == ["inner", "outer"]


@pytest.fixture(scope="module")
def tiny():
    cfg = OpusConfig.tiny("qwen2")
    params = opus.init(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    return cfg, params


@pytest.mark.parametrize("stop", ["length", "eos"])
def test_one_annotate_batch_records_its_span_tree(tiny, stop, monkeypatch):
    cfg, params = tiny
    tok = ByteTokenizer()
    max_new = 5
    if stop == "eos":
        # every row draws EOS at the second step: the loop's test ends it
        orig, calls = engine.sample_token, []

        def sample_token(logits, *a, **k):
            calls.append(1)
            t = orig(logits, *a, **k)
            return torch.full_like(t, tok.eos_token_id) if len(calls) == 2 \
                else t
        monkeypatch.setattr(engine, "sample_token", sample_token)
    mark = _mark()
    counts0 = obs.SPANS.counters()
    ids, mask, esm = runner._prepare_inputs(
        tok, [annotation_prompt("<seq>\nWhat is it?", VICUNA_V0)] * 3,
        PROTEINS, prompt_bucket=32, esm_bucket=16, device="cpu")
    gen = GenerationConfig(max_new_tokens=max_new, temperature=0.7,
                           top_p=0.9, eos_token_id=tok.eos_token_id,
                           pad_token_id=tok.pad_token_id, seed=1)
    _, out = runner._generate_spliced(params, cfg, tok, ids, mask, esm, gen,
                                      impl="auto", batch_index=4)
    got = _since(mark)
    (batch,) = got["runner.batch"]
    assert batch.parent is None and batch.attrs["batch"] == 4
    assert batch.attrs["rows"] == 3
    for name in ("runner.splice", "engine.prefill", "engine.decode",
                 "runner.detokenize"):
        (s,) = got[name]
        assert s.parent == batch.id, name
    (decode,) = got["engine.decode"]
    steps = out.steps
    assert len(got["engine.sample"]) == len(got["engine.forward"]) == steps
    assert steps == (max_new if stop == "length" else 2)
    checks = len(got["engine.stop_check"])
    assert checks == (steps if stop == "length" else steps + 1)
    assert all(s.parent == decode.id for name in
               ("engine.sample", "engine.forward", "engine.stop_check")
               for s in got[name])
    assert out.decode_seconds == decode.host_ns / 1e9
    lens = out.lengths.numpy()
    counts = obs.SPANS.counters()

    def delta(k):
        return counts[k] - counts0.get(k, 0)
    assert delta("decode.row_steps") == steps * 3
    assert delta("decode.row_steps_live") == int(lens.sum())
    assert delta("esm.rows") == 3 * esm.shape[-1]
    assert delta("esm.rows_residue") == sum(len(p) + 2 for p in PROTEINS)


def test_decode_seconds_without_the_recorder(tiny, monkeypatch):
    cfg, params = tiny
    tok = ByteTokenizer()
    monkeypatch.setattr(obs.SPANS, "enabled", False)
    mark = max((s.id for s in obs.SPANS.spans()), default=-1)
    ids, mask, esm = runner._prepare_inputs(
        tok, [annotation_prompt("<seq>\nWhat is it?", VICUNA_V0)],
        PROTEINS[:1], prompt_bucket=32, esm_bucket=16, device="cpu")
    _, out = runner._generate_spliced(
        params, cfg, tok, ids, mask, esm,
        GenerationConfig(max_new_tokens=3, temperature=0.0), impl="auto",
        batch_index=0)
    assert out.decode_seconds > 0
    assert not [s for s in obs.SPANS.spans() if s.id > mark]


def _train_batches(n, rows=4, seed=0):
    tok = ByteTokenizer()
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        exs = [{"instruction": "Describe it.",
                "sequence": PROTEINS[j % 3],
                "output": "ab " * int(r.integers(1, 12))}
               for j in range(rows)]
        out.append(collate.collate_instruction_batch(
            exs, tok, max_len=96, prompt_bucket=16, esm_bucket=16))
    return out


def test_counted_positions_are_the_train_tokens():
    (b,) = _train_batches(1)
    n_tokens = 4
    rec = obs.SPANS
    before = rec.counters()
    collate.count_positions(b, n_tokens)
    after = rec.counters()
    rows, length = b["attn_mask"].shape
    # the benchmark's train cell counts a batch's tokens so
    tokens = int(b["attn_mask"].sum()) + rows * (n_tokens - 1)
    assert (after["collate.positions_live"]
            - before.get("collate.positions_live", 0)) == tokens
    assert (after["collate.positions"] - before.get("collate.positions", 0)
            == rows * (length + n_tokens - 1))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_one_train_step_records_its_phases(tiny, grad_accum):
    cfg, frozen = tiny
    tcfg = TrainConfig(learning_rate=1e-3, batch_size=4,
                       grad_accum=grad_accum, log_every=0)
    state, tx = mmt.create_state(
        cfg, tcfg, frozen, generator=torch.Generator().manual_seed(1),
        train_switch=False, lora_cfg=LoRAConfig(rank=2, alpha=4.0),
        device="cpu")
    batches = _train_batches(2)
    mark = _mark()
    before = obs.SPANS.counters()
    mmt.fit(state, tx, cfg, tcfg, frozen, batches,
            lora_cfg=LoRAConfig(rank=2, alpha=4.0), log_fn=lambda *_: None,
            device="cpu")
    got = _since(mark)
    steps = got["train.step"]
    assert [s.attrs["step"] for s in steps] == [0, 1]
    for st in steps:
        assert st.parent is None and st.device_ms == st.host_ms
        kids = {n: [s for s in got[n] if s.parent == st.id] for n in
                ("train.forward", "train.backward", "train.optimizer")}
        assert [len(v) for v in kids.values()] == [grad_accum, grad_accum,
                                                  1]
        assert all(s.device_ms is not None for v in kids.values()
                   for s in v)
    # fit prefetches: a wait a step (and one for the end), on this thread
    assert len(got["prefetch.wait"]) == 3
    assert {s.parent for s in got["prefetch.wait"]} == {None}
    after = obs.SPANS.counters()
    want = sum(int(b["attn_mask"].sum())
               + b["attn_mask"].shape[0] * (cfg.switch.n_tokens - 1)
               for b in batches)
    assert (after["collate.positions_live"]
            - before.get("collate.positions_live", 0)) == want


def test_prefetch_records_produce_and_wait_on_their_threads():
    mark = _mark()
    got_items = list(prefetch_to_device(
        [{"x": np.ones(2)}] * 3, device="cpu"))
    assert len(got_items) == 3
    got = _since(mark)
    # the last of each covers the end of the stream
    assert len(got["prefetch.produce"]) == len(got["prefetch.wait"]) == 4
    assert {s.thread for s in got["prefetch.produce"]} == {
        "opus-pllm-prefetch"}
    assert {s.thread for s in got["prefetch.wait"]} == {
        threading.current_thread().name}


def test_export_writes_spans_device_track_and_counters(tmp_path):
    rec = obs.Recorder()
    with rec.span("root", step=1):
        with rec.span("dev", device="cpu"):
            rec.count("c", 7)
    path = rec.export_chrome(str(tmp_path / "spans.json"), pid=2)
    trace = json.loads(open(path).read())
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    host = {e["name"]: e for e in xs if e["cat"] == "host"}
    dev = [e for e in xs if e["cat"] == "device"]
    assert set(host) == {"root", "dev"}
    assert host["root"]["args"]["step"] == 1
    assert host["dev"]["args"]["parent"] == host["root"]["args"]["id"]
    assert [e["name"] for e in dev] == ["dev"]
    assert dev[0]["tid"] != host["dev"]["tid"]
    assert {e["pid"] for e in trace["traceEvents"]} == {2}
    (c,) = [e for e in trace["traceEvents"] if e["ph"] == "C"]
    assert (c["name"], c["args"]["value"]) == ("c", 7)


@pytest.mark.parametrize("cmd", ["annotate", "train-lora",
                                 "train-projector"])
def test_cli_trace_spans_option(cmd, tmp_path):
    need = {"annotate": ["--test-json", "t.json"],
            "train-lora": ["--train-json", "t.json", "--out", "o"],
            "train-projector": ["--train-json", "t.json", "--out", "o"]}
    path = str(tmp_path / "sub" / "spans.json")
    args = cli.build_parser().parse_args(
        [cmd, *need[cmd], "--trace-spans", path])
    assert args.trace_spans == path
    with obs.span("cli.test"):
        pass
    assert cli.write_spans(path) == path
    names = {e.get("name") for e in
             json.loads(open(path).read())["traceEvents"]}
    assert "cli.test" in names
