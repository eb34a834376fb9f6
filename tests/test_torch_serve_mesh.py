"""Serving and the train commands on a mesh of two gloo ranks, against the
JAX package and against one process of the port, on the CPU.

Two ranks start once for the file (tests/torch_dist.RankPool):
- the lockstep server (serve.server.OpusServer(mesh=) on rank 0,
  `serve_follower` on rank 1, tensor-parallel over both, the pinned
  system prefix on): two greedy annotate requests over HTTP give the JAX
  runner's text for the same examples, a request cancelled by its timeout
  answers 504, an adapter added over POST /v1/adapters serves a request
  with the single process's text, /v1/embeddings of a text (an LLM
  forward every rank runs) and a protein equal one process's within
  1e-5, and the follower's engine counts what rank 0's counts;
- `annotate --engine --distributed` and `mcq --engine --distributed`'s
  runners (each rank an engine on its slice, the results gathered) give
  the JAX runners' reports (greedy);
- the CLI: `serve --mesh 1,2` answers over HTTP, drains on SIGTERM and
  returns on both ranks; `serve --distributed` serves alone on one rank
  and stops naming the port when two ranks share a host; train-lora
  (--mesh 2,1, --mesh 1,2, --distributed, a mesh run resumed from one
  process's checkpoint, --mesh 2,1 with --val-json at lr 0: the held-out
  loss over the same tokens within 2e-4 of one process's), train-projector
  --mesh 2 and train-cstp --mesh 2 save what one process saves (parameters within 2 lr x steps, Adam's
  first steps being lr sign(g); 95% within 5e-5: after two steps Adam's
  update moves with fp32 summation order where a gradient is tiny;
  tests/test_torch_train_mesh.py holds the gradients themselves to 1e-4).
Without a pool: precompute-pairs and convert-weights take --mesh 1,2 and
write what they write without it, byte for byte."""

import argparse
import dataclasses
import functools
import json
import os
import pickle
import socket

import jax
import numpy as np
import pytest

import torch_checkpoints as tc
import torch_dist_cases as cases
from opus_pllm_tpu.core import config as jconfig
from opus_pllm_tpu.evals import datasets as jds
from opus_pllm_tpu.evals import runner as jrunner
from opus_pllm_tpu.infer.tokenization import ByteTokenizer as JByteTokenizer
from opus_pllm_tpu.models import opus as jopus
from opus_pllm_tpu_torch.cli import main as cli
from opus_pllm_tpu_torch.core import builder
from opus_pllm_tpu_torch.core.checkpoint import CheckpointManager
from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
from opus_pllm_tpu_torch.lora.lora import fold_scaling
from opus_pllm_tpu_torch.serve import openai_api as oai
from opus_pllm_tpu_torch.serve.server import OpusServer
from torch_dist import RankPool

ANNOTATE = [dict(instruction="Where is it located?", sequence="MKTAYIAKQR",
                 output="nucleus"),
            dict(instruction="Name the function.", sequence="ACDEFGHIKL",
                 output="enzyme"),
            dict(instruction="Keywords?", sequence="MKTAYIAKQRMKTAY",
                 output="binding")]
MCQ = [dict(question=f"Which class {i}?", options=["A) x", "B) y", "C) z",
                                                   "D) w"],
            sequence=s, answer="B")
       for i, s in enumerate(("MKTAYIAKQR", "ACDEFGHIKL", "MKTAYIAKQRMKT"))]
FILES = {"annotate": "mini_keywords.json", "mcq": "mini_mcq_test.json"}
ENGINE = dict(max_slots=4, max_len=512, prefill_buckets=(64, 128, 256, 384))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(2, tmp_path_factory.mktemp("serve"))
    yield p
    p.close()


@functools.lru_cache(maxsize=None)
def _opus_models():
    """OpusConfig.tiny (the CSTP text input at the LLM's width) with the
    embeddings and the switch scaled up, so that greedy decoding depends
    on the protein (as in tests/test_torch_serve_tp.py)."""
    cfg = jconfig.OpusConfig.tiny("llama")
    # the CSTP text projection takes the LLM's width, so the server embeds
    # text (an LLM forward every rank of the lockstep server runs)
    cfg = dataclasses.replace(cfg, cstp=dataclasses.replace(
        cfg.cstp, text_dim=cfg.llm.hidden_size))
    p = jopus.init(jax.random.PRNGKey(0), cfg)
    p["llm"]["embed_tokens"]["embedding"] = \
        p["llm"]["embed_tokens"]["embedding"] * 10
    for layer, gain in zip(p["switch"]["layers"], (100.0, 10.0)):
        layer["kernel"], layer["bias"] = layer["kernel"] * gain, \
            layer["bias"] * 0.0
    return cfg, p


@functools.lru_cache(maxsize=None)
def _jax_report(kind):
    """The JAX static runner's greedy report (the engine runner's greedy
    results are the static runner's: tests/test_engine_eval.py)."""
    cfg, params = _opus_models()
    tok = JByteTokenizer()
    gen = jconfig.GenerationConfig(max_new_tokens=6, temperature=0.0,
                                   eos_token_id=tok.eos_token_id,
                                   pad_token_id=tok.pad_token_id)
    kw = dict(gen=gen, batch_size=2, log_fn=lambda *_: None)
    if kind == "annotate":
        rep = jrunner.run_annotation_eval(
            params, cfg, tok, FILES[kind],
            examples=[jds.AnnotationExample(**e) for e in ANNOTATE], **kw)
    else:
        rep = jrunner.run_mcq_eval(
            params, cfg, tok, FILES[kind],
            examples=[jds.MCQExample(**e) for e in MCQ], **kw)
    return rep, gen


def _tree():
    cfg, params = _opus_models()
    return dataclasses.asdict(cfg), jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("kind", ["annotate", "mcq"])
def test_engine_runners_distributed_match_jax(pool, kind):
    """Fault 1: each rank runs its own engine on its slice and the ranks
    gather: the JAX runner's results on both ranks, its metrics on rank
    0."""
    ref, gen = _jax_report(kind)
    cfg_dicts, tree = _tree()
    outs = pool.run(cases.engine_runner, kind, 2, cfg_dicts, tree,
                    ANNOTATE if kind == "annotate" else MCQ,
                    dataclasses.asdict(gen), FILES[kind])
    for rank, (results, metrics) in enumerate(outs):
        assert results == ref.results, rank
    assert outs[0][1] == ref.metrics
    assert kind == "mcq" or outs[1][1] == {}


def test_lockstep_server_matches_jax(pool, tmp_path):
    ref, _ = _jax_report("annotate")
    cfg_dicts, tree = _tree()
    adapters = {n: tc.write_peft_dir(str(tmp_path / n), "llama",
                                     safetensors=True, seed=s)
                for n, s in (("a", 11), ("b", 12))}
    annotate = lambda e, **kw: ("/v1/annotate", dict(
        instruction=e["instruction"], sequence=e["sequence"],
        max_new_tokens=6, temperature=0.0, **kw))
    requests = [annotate(ANNOTATE[0]), annotate(ANNOTATE[1]),
                ("/v1/generate", {"prompt": "count " * 20,
                                  "max_new_tokens": 300, "_timeout": 0.02}),
                ("/v1/adapters", {"name": "b"}),
                annotate(ANNOTATE[2], adapter="b"),
                ("/v1/embeddings", {"input": [
                    "a zinc finger protein",
                    {"type": "protein", "sequence": "MKTAYIAKQR"}]})]
    outs = pool.run(cases.lockstep_server, cfg_dicts, tree, adapters,
                    requests, ENGINE)
    answers, health, counters = outs[0]
    codes = [a[0] for a in answers]
    assert codes == [200, 200, 504, 200, 200, 200], answers
    for got, want in zip(answers[:2], ref.results[:2]):
        assert got[1]["text"] == want["generated"]
    assert sorted(answers[3][1]["adapters"]) == ["a", "b"]
    # the adapter request and the embeddings against one process of the
    # port with the bank
    params, cfg = cases._opus(cfg_dicts, tree)
    bank = {n: fold_scaling(*builder.load_peft_adapter(d, 2))
            for n, d in adapters.items()}
    one = OpusServer(params, cfg, ByteTokenizer(), default_max_new=6,
                     lora_bank=bank, **ENGINE)
    try:
        want = one.handle_annotate(requests[4][1])
        want_emb = oai.handle_embeddings(one, requests[5][1])
    finally:
        one.close()
    assert answers[4][1]["text"] == want["text"]
    for got, ref in zip(answers[5][1]["data"], want_emb["data"]):
        np.testing.assert_allclose(got["embedding"], ref["embedding"],
                                   rtol=1e-5, atol=1e-6)
    assert health["status"] == "ok" and health["total_cancelled"] == 1
    assert outs[1] == counters            # the follower did what rank 0 did


@pytest.fixture(scope="module")
def dirs():
    return tc.toy_dirs()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_argv(dirs, port, *extra):
    return ["serve", "--model-base", dirs["llama"], "--weights",
            dirs["weights"], "--esm", dirs["esm"], "--host", "127.0.0.1",
            "--port", str(port), "--max-len", "512", "--max-new-tokens",
            "6", "--drain-grace", "5", "--device", "cpu", *extra]


BODY = {"instruction": "Where is it located?", "sequence": "MKTAYIAKQR",
        "temperature": 0.0}


def test_serve_mesh_cli_drains_every_rank(pool, dirs):
    port = _free_port()
    outs = pool.run(cases.cli_serve,
                    _serve_argv(dirs, port, "--mesh", "1,2",
                                "--cache-system-prefix"), port, BODY)
    (code, answer), printed = outs[0]
    assert code == 200 and answer["tokens"] >= 1, answer
    assert "SIGTERM: draining" in printed
    assert outs[1] == (None, "")          # the follower returned, quietly


def test_serve_distributed_serves_alone_or_names_the_port(pool, dirs,
                                                          monkeypatch):
    port = _free_port()
    outs = pool.run(cases.cli_serve, _serve_argv(
        dirs, port, "--distributed", "--cache-system-prefix"), port, BODY,
        True)
    (code, answer), _ = outs[0]
    assert code == 200 and outs[1] is None, answer
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match=f"bind port {port}"):
        cli.main(_serve_argv(dirs, port, "--distributed"))


def _train_json(path, n=4):
    with open(path, "w") as f:
        json.dump([{"instruction": "What does this protein do?",
                    "input": tc.SEQS[i % 3], "output": "It binds zinc."}
                   for i in range(n)], f)
    return path


def _vec_pickle(path, n=16):
    rng = np.random.default_rng(0)
    with open(path, "wb") as f:
        pickle.dump([{"seq_embedding": rng.standard_normal(64).astype(
                          np.float32),
                      "text_embedding": rng.standard_normal(96).astype(
                          np.float32)} for _ in range(n)], f)
    return path


LR, STEPS = 1e-3, 2


def _train_argv(dirs, tmp_path, cmd, out, *extra):
    if cmd == "train-cstp":
        return ["train-cstp", "--vec-pickle",
                _vec_pickle(str(tmp_path / "vec.pkl")), "--batch-size",
                "8", "--lr", str(LR), "--out", out, "--device", "cpu",
                "--max-steps", str(STEPS), *extra]
    return [cmd, "--model-base", dirs["llama"], "--esm", dirs["esm"],
            "--weights", dirs["weights"], "--train-json",
            _train_json(str(tmp_path / "train.json")), "--out", out,
            "--batch-size", "2", "--max-len", "320", "--lora-rank", "4",
            "--lr", str(LR), "--device", "cpu", "--max-steps", str(STEPS),
            *extra]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("cmd,flags", [
    ("train-lora", ("--mesh", "2,1")), ("train-lora", ("--mesh", "1,2")),
    ("train-lora", ("--distributed",)), ("train-lora", ("resume",)),
    ("train-lora", ("val",)),
    ("train-projector", ("--mesh", "2")), ("train-cstp", ("--mesh", "2"))],
    ids=lambda v: v if isinstance(v, str) else " ".join(v))
def test_train_commands_on_mesh_match_one_process(pool, dirs, tmp_path,
                                                  monkeypatch, capsys, cmd,
                                                  flags):
    monkeypatch.setattr(cli, "load_tokenizer",
                        lambda path, family: ByteTokenizer())
    extra = ()
    if flags == ("val",):
        # 3 held-out examples in batches of 2: the last batch's one row
        # leaves a data rank without a row; lr 0 keeps the parameters
        # where one process has them, so the held-out losses compare
        # tightly
        extra = ("--val-json", _train_json(str(tmp_path / "val.json"), 3),
                 "--lr", "0")
        flags = ("--mesh", "2,1") + extra
    ref = str(tmp_path / "one")
    capsys.readouterr()
    cli.main(_train_argv(dirs, tmp_path, cmd, ref, *extra))
    val_line = [ln for ln in capsys.readouterr().out.splitlines()
                if "val_loss" in ln]
    out = str(tmp_path / "mesh")
    if flags == ("resume",):
        # one process's checkpoint of step 1, resumed on --mesh 2,1
        argv = _train_argv(dirs, tmp_path, cmd, out, "--save-every", "1")
        argv[argv.index("--max-steps") + 1] = "1"
        cli.main(argv)
        flags = ("--mesh", "2,1", "--resume")
    printed = pool.run(cases.cli, _train_argv(dirs, tmp_path, cmd, out,
                                              *flags))
    assert f"step {STEPS}" in printed[0] and printed[1] == ""
    assert "loss=0.0000" not in printed[0]    # the targets are in reach
    if extra:
        # the global token-weighted mean over every held-out token
        got_val = [ln for ln in printed[0].splitlines() if "val_loss" in ln]
        assert len(val_line) == len(got_val) == 1
        n_tok = lambda ln: ln.split("(")[1]
        val = lambda ln: float(ln.split("val_loss=")[1].split()[0])
        assert n_tok(got_val[0]) == n_tok(val_line[0])
        assert abs(val(got_val[0]) - val(val_line[0])) <= 2e-4
    want = CheckpointManager(ref).restore()
    got = CheckpointManager(out).restore()
    assert CheckpointManager(out).latest_step() == STEPS
    wl, gl = _leaves(want), _leaves(got)
    assert len(wl) == len(gl) > 0
    for a, b in zip(gl, wl):
        assert a.shape == b.shape
        d = (a.float() - b.float()).abs()
        assert d.max() <= 2 * LR * STEPS
        assert (d <= 5e-5).float().mean() >= 0.95


def _uniprot(path):
    recs = {f"P{i}": {"Sequence": tc.SEQS[i % 3], "Name": [f"Prot. {i}"],
                      "Similarity": f"Belongs to family {i}.",
                      "Subcellular_Location": "Nucleus."} for i in range(3)}
    with open(path, "wb") as f:
        pickle.dump(recs, f)
    return path


@pytest.mark.parametrize("cmd", ["precompute-pairs", "convert-weights"])
def test_one_device_commands_take_the_mesh_flags(dirs, tmp_path,
                                                 monkeypatch, cmd):
    """Fault 2: the flags are taken, as the JAX CLI takes them, and change
    nothing: the output with --mesh 1,2 (no process group needed) is the
    output without it, byte for byte."""
    monkeypatch.setattr(cli, "load_tokenizer",
                        lambda path, family: ByteTokenizer())
    outs = []
    for extra in ((), ("--mesh", "1,2"), ("--distributed",)):
        out = str(tmp_path / ("o" + "".join(extra).replace(",", "")))
        base = ["--model-base", dirs["llama"], "--esm", dirs["esm"],
                "--out", out, "--device", "cpu", *extra]
        if cmd == "precompute-pairs":
            cli.main([cmd, "--uniprot-pickle",
                      _uniprot(str(tmp_path / "u.pkl"))] + base)
            with open(out, "rb") as f:
                outs.append(f.read())
        else:
            cli.main([cmd, "--weights", dirs["weights"]] + base)
            outs.append(sorted(
                (os.path.relpath(os.path.join(r, n), out),
                 open(os.path.join(r, n), "rb").read())
                for r, _, names in os.walk(out) for n in names))
    assert outs[0] and outs[1] == outs[0] and outs[2] == outs[0]
    sub = next(a for a in cli.build_parser()._actions
               if isinstance(a, argparse._SubParsersAction))
    helps = {a.dest: a.help for a in sub.choices[cmd]._actions}
    assert "changes nothing" in helps["mesh"]
    assert "changes nothing" in helps["distributed"]
