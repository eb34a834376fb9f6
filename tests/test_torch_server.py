"""Port parity and behaviour of the HTTP serving front
(opus_pllm_tpu_torch.serve.server.OpusServer) and its OpenAI API
(serve.openai_api), on OpusConfig.tiny("llama") with the JAX weights
carried over by `from_jax`.

One parity test holds greedy `handle_annotate` text and the OpenAI chat /
completion handlers to the JAX `OpusServer` on the same requests, with the
port also behind the pinned system prefix (`cache_system_prefix`) and an
adapter bank. The rest are port-only: every endpoint over HTTP, SSE
streams equal to the blocking text, cancelling a stream, `max_queue`
backpressure, drain, the adapter routes and /metrics against the engine's
counters."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from opus_pllm_tpu.core import config as jconfig
from opus_pllm_tpu.infer.tokenization import ByteTokenizer as JByteTokenizer
from opus_pllm_tpu.models import opus as jopus
from opus_pllm_tpu.serve import openai_api as joai
from opus_pllm_tpu.serve.server import OpusServer as JOpusServer
from opus_pllm_tpu_torch.core import config, convert
from opus_pllm_tpu_torch.core.config import LoRAConfig
from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
from opus_pllm_tpu_torch.lora import lora
from opus_pllm_tpu_torch.serve import openai_api as oai
from opus_pllm_tpu_torch.serve.server import (OpusServer, ServerDraining,
                                              ServerOverloaded)

INSTR = "What is the subcellular localization?"
SEQ = "MKTAYIAKQR"
# ByteTokenizer is byte-level: the professor prompt alone is ~260 tokens
ENGINE = dict(max_slots=4, max_len=512, prefill_buckets=(64, 128, 256, 384),
              default_max_new=8)


def _adapter(cfg, seed):
    t = lora.init(cfg.llm, LoRAConfig(rank=4, alpha=4.0),
                  generator=torch.Generator().manual_seed(seed),
                  device="cpu")
    for lp in t["layers"]:
        for ab in lp.values():
            ab["B"].normal_(0.0, 0.5,
                            generator=torch.Generator().manual_seed(seed))
    return t


@pytest.fixture(scope="module")
def served():
    jp = jopus.init(jax.random.PRNGKey(0), jconfig.OpusConfig.tiny("llama"))
    cfg = config.OpusConfig.tiny("llama")
    tp = convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    srv = OpusServer(tp, cfg, ByteTokenizer(), cache_system_prefix=True,
                     lora_bank={"loc": _adapter(cfg, 1),
                                "go": _adapter(cfg, 2)},
                     adapter_capacity=3, **ENGINE)
    yield jp, tp, cfg, srv
    srv.close()


def _post(port, path, body, timeout=300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.headers["Content-Type"] == "text/event-stream":
            return [line[len(b"data: "):].decode()
                    for line in r.read().split(b"\n\n")
                    if line.startswith(b"data: ")]
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        data = r.read()
        return (json.loads(data) if r.headers["Content-Type"]
                == "application/json" else data.decode())


def _http(srv):
    httpd = srv.make_http_server("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


def _error(fn):
    try:
        fn()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    raise AssertionError("expected an HTTP error")


def test_annotate_and_openai_handlers_match_jax_server(served):
    """Greedy handle_annotate text and the OpenAI chat / completion
    handlers' outputs equal the JAX server's; the port answers through its
    pinned system prefix (the JAX server admits whole prompts), which must
    not change a token."""
    jp, tp, cfg, srv = served
    jsrv = JOpusServer(jp, jconfig.OpusConfig.tiny("llama"),
                       JByteTokenizer(), **ENGINE)
    plain = OpusServer(tp, cfg, ByteTokenizer(), **ENGINE)
    try:
        assert srv._sys_ids and srv.engine._prefixes
        for instr in (INSTR, "Name its keywords."):
            body = {"instruction": instr, "sequence": SEQ,
                    "max_new_tokens": 8, "temperature": 0.0}
            want = jsrv.handle_annotate(body)
            assert srv.handle_annotate(body) == want
            assert plain.handle_annotate(body) == want
        chat = {"messages": [{"role": "user", "content": [
                    {"type": "text", "text": INSTR},
                    {"type": "protein", "sequence": SEQ}]}],
                "max_tokens": 6, "stop": ["###"]}
        comp = {"prompt": "Hello there", "max_tokens": 5}
        for fn_t, fn_j, body in ((oai.handle_chat, joai.handle_chat, chat),
                                 (oai.handle_completion,
                                  joai.handle_completion, comp)):
            got, want = fn_t(srv, body), fn_j(jsrv, body)
            assert got["choices"] == want["choices"]
            assert got["usage"] == want["usage"]
            assert got["object"] == want["object"]
        assert oai.list_models(plain)["data"][0]["id"] == \
            joai.list_models(jsrv)["data"][0]["id"]
    finally:
        jsrv.close()
        plain.close()


def test_http_endpoints_round_trip(served):
    """Every endpoint over HTTP: annotate (16 concurrent), generate, chat
    (blocking and SSE: the streamed greedy text equals the blocking text),
    completions, embeddings (a protein and a text), models, adapters,
    health and /metrics, whose completions counter equals the requests
    answered."""
    _, _, cfg, srv = served
    httpd, port = _http(srv)
    try:
        c0 = srv.engine.counters["completions"]
        outs = [None] * 16

        def one(i):
            outs[i] = _post(port, "/v1/annotate", {
                "instruction": f"{INSTR} #{i}", "sequence": SEQ,
                "max_new_tokens": 4,
                "adapter": (None, "loc", "go", None)[i % 4]})
        ts = [threading.Thread(target=one, args=(i,)) for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        assert all(o and o["tokens"] > 0 for o in outs)
        assert _post(port, "/v1/generate", {"prompt": "Hello",
                                            "max_new_tokens": 3})["tokens"]
        chat = {"messages": [{"role": "user", "content": "Say hi"}],
                "max_tokens": 6}
        blocking = _post(port, "/v1/chat/completions", chat)
        text = blocking["choices"][0]["message"]["content"]
        events = _post(port, "/v1/chat/completions", {**chat,
                                                      "stream": True})
        assert events[-1] == "[DONE]"
        chunks = [json.loads(e) for e in events[:-1]]
        assert "".join(c["choices"][0]["delta"].get("content", "")
                       for c in chunks) == text
        assert chunks[-1]["choices"][0]["finish_reason"] in ("stop",
                                                             "length")
        comp = _post(port, "/v1/completions", {"prompt": "Once",
                                               "max_tokens": 3,
                                               "model": "go"})
        assert comp["model"] == "go" and comp["usage"]["completion_tokens"]
        code, err = _error(lambda: _post(port, "/v1/completions", {
            "prompt": "x", "model": "nope"}))
        assert code == 400 and "not found" in err["error"]["message"]
        emb = _post(port, "/v1/embeddings", {"input": [
            {"type": "protein", "sequence": SEQ}]})
        vec = np.asarray(emb["data"][0]["embedding"])
        assert vec.shape == (cfg.cstp.proj_dim,) and np.isfinite(vec).all()
        code, err = _error(lambda: _post(port, "/v1/embeddings",
                                         {"input": "a text"}))
        assert code == 400 and "text embeddings" in err["error"]["message"]
        models = _get(port, "/v1/models")
        assert [m["id"] for m in models["data"]] == [srv.model_id, "loc",
                                                     "go"]
        assert _get(port, "/v1/adapters") == {"adapters": ["go", "loc"],
                                              "capacity": 3, "free": 1}
        # loading from disk is ported (tests/test_torch_loaders.py); a
        # path that does not exist fails on the reader, the bank unchanged
        code, err = _error(lambda: _post(port, "/v1/adapters", {
            "name": "x", "path": "/nowhere"}))
        assert code == 500 and "FileNotFoundError" in err["error"]
        assert _get(port, "/v1/adapters")["adapters"] == ["go", "loc"]
        health = _get(port, "/health")
        assert health["status"] == "ok" and health["slots"] == 4
        metrics = _get(port, "/metrics")
        vals = {ln.split()[0]: float(ln.split()[1])
                for ln in metrics.splitlines()
                if ln and not ln.startswith("#")}
        answered = 16 + 1 + 2 + 1
        assert vals["opus_serve_completions_total"] == \
            srv.engine.counters["completions"] == c0 + answered
        assert vals["opus_serve_ttft_seconds_count"] >= answered
        assert vals['opus_serve_ttft_seconds_bucket{le="+Inf"}'] == \
            vals["opus_serve_ttft_seconds_count"]
    finally:
        httpd.shutdown()


def test_adapters_add_remove_and_route(served):
    """An in-memory adapter installs through run_on_engine and routes by
    name; removal frees the row; an unknown removal is a 400."""
    _, _, cfg, srv = served
    httpd, port = _http(srv)
    try:
        srv.run_on_engine(lambda: srv.engine.add_adapter(
            "ec", _adapter(cfg, 3)))
        out = _post(port, "/v1/annotate", {"instruction": INSTR,
                                           "sequence": SEQ,
                                           "max_new_tokens": 3,
                                           "adapter": "ec"})
        assert out["tokens"] > 0
        gone = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/adapters/ec", method="DELETE")
        with urllib.request.urlopen(gone, timeout=60) as r:
            assert json.loads(r.read())["adapters"] == ["go", "loc"]
        code, err = _error(lambda: urllib.request.urlopen(
            urllib.request.Request(f"http://127.0.0.1:{port}/v1/adapters/ec",
                                   method="DELETE"), timeout=60))
        assert code == 400 and "unknown adapter" in err["error"]
    finally:
        httpd.shutdown()


def test_stream_cancel_frees_slot(served):
    """Closing a stream (a client disconnect) cancels its request: the
    slot frees without decoding to budget and nothing leaks."""
    _, _, _, srv = served
    g = srv.stream_annotate({"instruction": INSTR, "sequence": SEQ,
                             "max_new_tokens": 100})
    assert next(g)["token_ids"]
    g.close()
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and (
            srv.engine.busy or np.any(srv.engine.state["active"])):
        time.sleep(0.05)
    assert not np.any(srv.engine.state["active"])
    assert not srv._events and not srv._results
    assert srv.engine.counters["cancelled"] >= 1


def test_max_queue_and_drain(served):
    """max_queue sheds load with ServerOverloaded (HTTP 429) while the one
    slot is busy and one request waits; drain finishes the in-flight
    requests and then refuses new ones (HTTP 503)."""
    _, tp, cfg, _ = served
    srv = OpusServer(tp, cfg, ByteTokenizer(), max_queue=1,
                     **{**ENGINE, "max_slots": 1})
    try:
        results = []

        def worker(budget):
            results.append(srv.handle_generate(
                {"prompt": "Hello", "max_new_tokens": budget,
                 "_timeout": 600}))
        ts = [threading.Thread(target=worker, args=(100,)),
              threading.Thread(target=worker, args=(4,))]
        ts[0].start()
        deadline = time.monotonic() + 120
        while not srv.engine.busy and time.monotonic() < deadline:
            time.sleep(0.01)
        ts[1].start()
        while srv._queued() < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(ServerOverloaded, match="max-queue"):
            srv.handle_generate({"prompt": "Hi", "max_new_tokens": 2})
        assert srv.drain(timeout=600)
        for t in ts:
            t.join(timeout=60)
        assert [r["tokens"] for r in results] == [100, 4]
        with pytest.raises(ServerDraining):
            srv.handle_generate({"prompt": "Hi", "max_new_tokens": 2})
        httpd, port = _http(srv)
        try:
            code, err = _error(lambda: _post(port, "/v1/generate",
                                             {"prompt": "Hi"}))
            assert code == 503 and "draining" in err["error"]
            assert _get(port, "/health")["status"] == "draining"
        finally:
            httpd.shutdown()
    finally:
        srv.close()
