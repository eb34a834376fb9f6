"""The port's command line (opus_pllm_tpu_torch.cli.main) against the JAX
CLI on the CPU.

The parser has every subcommand, option, default, choice, nargs and
const of the JAX `build_parser()`, with `--device` the one addition.
`annotate --device cpu` on the toy checkpoint directories of
tests/torch_checkpoints.py (two `.safetensors` shards, a HF-ESM
directory, a CSTP Lightning ckpt, the switch `.bin` and a PEFT adapter
merged on load) saves the answers the JAX CLI saves at T = 0: plain,
--num-beams 2 and --draft-layers 1. Both CLIs get the byte tokenizer in
place of their HF tokenizer (the toy directories carry no tokenizer
files). The generation commands decode on fused projections and the train
commands on the unfused ones. The rest runs the port's commands: mcq (static, --scored,
--engine), train-cstp with --resume equal to an uninterrupted run,
train-lora for 2 steps with --export-reference-format (its
adapter_config.json as the JAX CLI writes it, the PEFT export loading back
as the trained adapters) and --resume, convert-weights through
load_native, chat over stdin, the parallel axes without torchrun's
environment (--mesh, --seq-shards and --pipe-stages stop naming it;
--micro-batches and --pipe-data without --pipe-stages change nothing)
and the missing GPU."""

import argparse
import io
import json
import os
import pickle

import numpy as np
import pytest
import torch

import torch_checkpoints as tc
from opus_pllm_tpu.cli.main import build_parser as jax_parser
from opus_pllm_tpu_torch.cli import main as cli
from opus_pllm_tpu_torch.core import builder
from opus_pllm_tpu_torch.core.checkpoint import CheckpointManager
from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer


@pytest.fixture
def byte_tok(monkeypatch):
    monkeypatch.setattr(cli, "load_tokenizer",
                        lambda path, family: ByteTokenizer())


@pytest.fixture(scope="module")
def dirs():
    return tc.toy_dirs()


def _options(parser):
    """{subcommand: {dest: (option strings, default, choices, nargs,
    const, required, type name)}}."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    out = {}
    for name, p in sub.choices.items():
        out[name] = {a.dest: (tuple(a.option_strings), a.default,
                              tuple(a.choices) if a.choices else None,
                              a.nargs, a.const, a.required,
                              getattr(a.type, "__name__", None))
                     for a in p._actions if a.dest not in ("help", "fn")}
    return out


def test_parser_matches_jax():
    got, ref = _options(cli.build_parser()), _options(jax_parser())
    assert sorted(got) == sorted(ref)
    for name in ref:
        extra = set(got[name]) - set(ref[name])
        want = {"device"} if name != "bench" else set()
        if name in ("annotate", "train-lora", "train-projector"):
            want.add("trace_spans")     # the port's span export
        assert extra == want, name
        for dest, spec in ref[name].items():
            assert got[name][dest] == spec, (name, dest)
        if name != "bench":
            assert got[name]["device"][:2] == (("--device",), "cuda")


@pytest.mark.parametrize("extra", [(), ("--num-beams", "2"),
                                   ("--draft-layers", "1", "--n-draft", "3")])
def test_annotate_matches_jax_cli(dirs, byte_tok, tmp_path, extra):
    out = str(tmp_path / "a.json")
    cli.main(tc.annotate_args(dirs, extra)
             + ["--save-path", out, "--device", "cpu"])
    with open(out) as f:
        got = json.load(f)
    assert tuple(r["generated"] for r in got) == tc.jax_cli_answers(extra)
    assert [r["ground_truth"] for r in got] == ["Hydrolase"] * 3


def test_generation_commands_fuse_the_projections(dirs, byte_tok, tmp_path):
    # annotate decodes on the fused [q|k|v] / [gate|up] products (the
    # answers above equal the unfused JAX CLI's); training keeps the seven
    parse = cli.build_parser().parse_args
    _, params, _ = cli._build(parse(tc.annotate_args(dirs)
                                    + ["--device", "cpu"]))
    for lp in params["llm"]["layers"]:
        assert {"qkv_proj", "gateup_proj"} <= set(lp)
        assert not {"q_proj", "k_proj", "v_proj", "gate_proj",
                    "up_proj"} & set(lp)
    train = str(tmp_path / "train.json")
    _train_json(train)
    _, params, _ = cli._build(parse(_lora_args(dirs, train,
                                               str(tmp_path / "o"))))
    assert "q_proj" in params["llm"]["layers"][0]
    assert "qkv_proj" not in params["llm"]["layers"][0]


def test_mcq_static_scored_and_engine(dirs, byte_tok, tmp_path, capsys):
    path = str(tmp_path / "x_mcq_test.json")
    with open(path, "w") as f:
        json.dump([{"question": "Which class?",
                    "options": ["A) x", "B) y", "C) z", "D) w"],
                    "input": s, "answer": "B"} for s in tc.SEQS], f)
    base = ["mcq", "--model-base", dirs["llama"], "--weights",
            dirs["weights"], "--esm", dirs["esm"], "--test-json", path,
            "--temperature", "0", "--max-new-tokens", "3", "--device",
            "cpu", "--batch-size", "2"]
    answers = {}
    for mode in ([], ["--scored"], ["--engine", "--max-slots", "2"]):
        out = str(tmp_path / "m.json")
        cli.main(base + mode + ["--save-path", out])
        metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert sum(metrics["OptionCounts"].values()) == 3
        with open(out) as f:
            answers[tuple(mode)] = [r["generated"] for r in json.load(f)]
    assert set(answers[("--scored",)]) <= set("ABCD")
    assert answers[()] == answers[("--engine", "--max-slots", "2")]
    with pytest.raises(SystemExit, match="drop --engine"):
        cli.main(base + ["--scored", "--engine"])


def _vec_pickle(path, n=16):
    rng = np.random.default_rng(0)
    with open(path, "wb") as f:
        pickle.dump([{"seq_embedding": rng.standard_normal(64).astype(
                          np.float32),
                      "text_embedding": rng.standard_normal(96).astype(
                          np.float32)} for _ in range(n)], f)


def test_train_cstp_and_resume(tmp_path):
    """train-cstp --max-steps 1 --save-every 1, then --resume, ends equal
    to an uninterrupted run (the same seeded batch stream, cut). The
    adapter's input widths come from the pairs (64 / 96 here; the JAX CLI
    hard-wires 1280 / 5120, which a 4096-wide text LM's pairs miss)."""
    vec = str(tmp_path / "vec.pkl")
    _vec_pickle(vec)
    base = ["train-cstp", "--vec-pickle", vec, "--batch-size", "8",
            "--epochs", "1", "--lr", "0.01", "--device", "cpu"]
    cli.main(base + ["--out", str(tmp_path / "ref")])
    ref = CheckpointManager(str(tmp_path / "ref")).restore()
    out = str(tmp_path / "res")
    cli.main(base + ["--out", out, "--max-steps", "1", "--save-every", "1"])
    assert CheckpointManager(os.path.join(out, "resume_state")
                             ).latest_step() == 1
    cli.main(base + ["--out", out, "--resume"])
    mgr = CheckpointManager(out)
    assert mgr.latest_step() == 2
    got = mgr.restore()
    assert got["protein_projection"]["kernel"].shape == (64, 5120)
    assert got["text_projection"]["kernel"].shape == (96, 5120)
    for k in ref:
        for leaf in ref[k]:
            assert torch.equal(got[k][leaf], ref[k][leaf]), (k, leaf)


def _train_json(path, n=6):
    with open(path, "w") as f:
        json.dump([{"instruction": "What does this protein do?",
                    "input": tc.SEQS[i % 3], "output": "It binds zinc."}
                   for i in range(n)], f)


def _lora_args(dirs, train, out, *extra):
    return ["train-lora", "--model-base", dirs["llama"], "--esm",
            dirs["esm"], "--weights", dirs["weights"], "--train-json", train,
            "--out", out, "--batch-size", "2", "--max-len", "96",
            "--lora-rank", "4", "--lr", "1e-3", "--device", "cpu", *extra]


def test_train_lora_export_and_resume(dirs, byte_tok, tmp_path):
    from opus_pllm_tpu.core.config import (DecoderConfig as JDecoderConfig,
                                           LoRAConfig as JLoRAConfig)
    from opus_pllm_tpu.lora.lora import _proj_dims
    train = str(tmp_path / "train.json")
    _train_json(train)
    ref_out = str(tmp_path / "ref")
    cli.main(_lora_args(dirs, train, ref_out, "--max-steps", "2",
                        "--export-reference-format"))
    trained = CheckpointManager(ref_out).restore()
    assert set(trained) == {"lora"}
    # the PEFT export: the JAX CLI's adapter_config.json, and the
    # adapters load back (folded scaling alpha / r = 32 / 4)
    d = os.path.join(ref_out, "lora_adapter")
    with open(os.path.join(d, "adapter_config.json")) as f:
        meta = json.load(f)
    lcfg = JLoRAConfig(rank=4)
    jcfg = JDecoderConfig(**tc.llm_config_fields("llama"))
    assert meta == {"r": 4, "lora_alpha": lcfg.alpha, "peft_type": "LORA",
                    "task_type": "CAUSAL_LM", "lora_dropout": 0.0,
                    "bias": "none", "target_modules": [
                        t for t in lcfg.target_modules
                        if t in _proj_dims(jcfg)]}
    tree, scale = builder.load_peft_adapter(d, 2)
    assert scale == 8.0
    for lp, tp in zip(tree["layers"], trained["lora"]["layers"]):
        assert sorted(lp) == sorted(tp)
        for proj in lp:
            for ab in ("A", "B"):
                assert torch.equal(lp[proj][ab], tp[proj][ab].float())
    # 1 step, saved, then --resume: the uninterrupted run's adapters
    out = str(tmp_path / "res")
    cli.main(_lora_args(dirs, train, out, "--max-steps", "1",
                        "--save-every", "1"))
    cli.main(_lora_args(dirs, train, out, "--max-steps", "2", "--resume"))
    got = CheckpointManager(out).restore()
    for lg, lr in zip(got["lora"]["layers"], trained["lora"]["layers"]):
        for proj in lr:
            for ab in ("A", "B"):
                assert torch.equal(lg[proj][ab], lr[proj][ab])


def test_convert_weights_roundtrip(dirs, tmp_path, capsys):
    out = str(tmp_path / "native")
    cli.main(["convert-weights", "--model-base", dirs["llama256"], "--esm",
              dirs["esm"], "--weights", dirs["weights256"], "--load-int4",
              "--int4-layout", "v1", "--out", out, "--device", "cpu"])
    assert "int4-v1" in capsys.readouterr().out
    with open(os.path.join(out, "quant_layout.json")) as f:
        assert json.load(f)["llm_layout"] == "int4-v1"
    args = cli.build_parser().parse_args(
        ["convert-weights", "--model-base", dirs["llama256"], "--esm",
         dirs["esm"], "--weights", dirs["weights256"], "--out", out])
    cfg = cli._opus_config(args, builder.decoder_config_for(
        dirs["llama256"]))
    want, _ = builder.load_pretrained(dirs["llama256"], dirs["weights256"],
                                      cfg, esm_path=dirs["esm"],
                                      quantize="int4", int4_layout="v1",
                                      device="cpu")
    back = builder.load_native(out, device="cpu")
    flat = lambda t: [(k, v) for k, v in _leaves(t)]
    assert [k for k, _ in flat(back)] == [k for k, _ in flat(want)]
    for (k, a), (_, b) in zip(flat(back), flat(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def _leaves(t, pre=""):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _leaves(t[k], f"{pre}/{k}")
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            yield from _leaves(v, f"{pre}/{i}")
    else:
        yield pre, t


def test_chat_over_stdin(dirs, byte_tok, monkeypatch, capsys):
    """The REPL answers each (instruction, sequence) turn, rejects a bad
    sequence and stops at an empty instruction; a turn's greedy answer is
    the static runner's for the same prompt."""
    from opus_pllm_tpu_torch.core.config import GenerationConfig
    from opus_pllm_tpu_torch.evals import runner
    from opus_pllm_tpu_torch.infer.conversation import (VICUNA_V0,
                                                        annotation_prompt)
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "What is it?\nMKTAYIAKQR\nAgain?\nMKXZ\n\n"))
    cli.main(["chat", "--model-base", dirs["llama"], "--weights",
              dirs["weights"], "--esm", dirs["esm"], "--temperature", "0",
              "--max-new-tokens", "5", "--device", "cpu"])
    out = capsys.readouterr().out
    # input() writes its prompts without a newline
    lines = out.replace("instruction> ", "").replace(
        "sequence> ", "").splitlines()
    assert lines[0].startswith("opus-pllm-tpu chat")
    assert lines[2].startswith("invalid amino acids: XZ")
    args = cli.build_parser().parse_args(tc.annotate_args(dirs))
    cfg = cli._opus_config(args, builder.decoder_config_for(dirs["llama"]))
    params, _ = builder.load_pretrained(dirs["llama"], dirs["weights"], cfg,
                                        esm_path=dirs["esm"], device="cpu")
    tok = ByteTokenizer()
    ids, mask, esm = runner._prepare_inputs(
        tok, [annotation_prompt("<seq>\nWhat is it?", VICUNA_V0)],
        ["MKTAYIAKQR"], prompt_bucket=64, esm_bucket=128, device="cpu")
    texts, _ = runner._generate_spliced(
        params, cfg, tok, ids, mask, esm,
        GenerationConfig(max_new_tokens=5, temperature=0.0,
                         eos_token_id=2), impl="auto", batch_index=0)
    assert lines[1] == texts[0]


@pytest.mark.parametrize("argv", [
    ["--mesh", "2,1"], ["--distributed"], ["--seq-shards", "2"]])
def test_model_commands_refuse_the_parallel_axes(dirs, argv, monkeypatch):
    # the flags run under torchrun (tests/test_torch_mesh.py); a single
    # process without its environment stops before loading anything
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        cli.main(tc.annotate_args(dirs) + argv + ["--device", "cpu"])


@pytest.mark.parametrize("argv", [
    ["--pipe-stages", "2"], ["--micro-batches", "2"], ["--pipe-data", "2"],
    ["--seq-shards", "2"], ["--mesh", "4"]])
def test_train_commands_refuse_the_parallel_axes(dirs, tmp_path, argv,
                                                 monkeypatch):
    # the axes run under torchrun (tests/test_torch_serve_mesh.py,
    # test_torch_mesh.py); a single process without its environment stops
    # before loading anything, while --micro-batches and --pipe-data
    # without --pipe-stages change nothing, as in JAX: no process group
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    if argv[0] in ("--micro-batches", "--pipe-data"):
        args = cli.build_parser().parse_args(
            _lora_args(dirs, "t.json", str(tmp_path), *argv))
        assert cli._train_parallel(args) == (None, None, None)
        return
    cmds = [_lora_args(dirs, "t.json", str(tmp_path))]
    if argv[0] == "--mesh":
        cmds.append(["train-cstp", "--vec-pickle", "v.pkl", "--out",
                     str(tmp_path), "--device", "cpu"])
    for cmd in cmds:
        with pytest.raises(SystemExit, match="torchrun"):
            cli.main(cmd + argv)


def test_no_gpu_without_device_cpu_is_an_error(dirs, tmp_path):
    """Without a GPU every model command stops before loading anything,
    unless --device cpu asks for the CPU (skipped on a machine with one)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(tc.annotate_args(dirs))
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["train-cstp", "--vec-pickle", "v.pkl", "--out",
                  str(tmp_path)])


def test_unroll_layers_parses_and_bench_points_to_the_benchmark(
        dirs, byte_tok, tmp_path):
    out = str(tmp_path / "u.json")
    cli.main(tc.annotate_args(dirs, ("--unroll-layers",))
             + ["--save-path", out, "--device", "cpu"])
    with open(out) as f:
        assert tuple(r["generated"] for r in json.load(f)) == \
            tc.jax_cli_answers(())
    with pytest.raises(SystemExit, match=r"port_bench/run\.py --workload"):
        cli.main(["bench"])
