"""The port's mesh layer (opus_pllm_tpu_torch.core.mesh,
parallel/partition.py) and its CLI flags against the JAX package.

`specs` equals the JAX rules leaf for leaf (llama / qwen2 / opt; bf16,
int8, int4 v1 and v2; a LoRA tree and a serving bank) at meshes 1x4, 2x2
and 4x1, `_sanitize` included; `parse_mesh_flag`, `local_slice` and
`gather_json_blobs` equal the JAX functions. The rest needs no process
group: the backend rule, `initialize_distributed` without torchrun's
environment, and the CLI's exclusions (the training mesh and serve's
run in tests/test_torch_serve_mesh.py and test_torch_train_mesh.py).
Then two gloo ranks run the port's CLI (tests/torch_dist.RankPool):
`annotate --mesh 1,2`, `annotate --seq-shards 2` and `chat --seq-shards
2` give the JAX CLI's answers on the toy checkpoints, and both ranks
print the same; `train-lora --seq-shards 2` and `--pipe-stages 2` save
one process's trained tree."""

import json
import types

import jax
import numpy as np
import pytest

import torch_checkpoints as tc
import torch_dist_cases as cases
from opus_pllm_tpu.core import mesh as jmesh
from opus_pllm_tpu.core.config import DecoderConfig as JDecoderConfig
from opus_pllm_tpu.core.config import LoRAConfig as JLoRAConfig
from opus_pllm_tpu.core.config import MeshConfig as JMeshConfig
from opus_pllm_tpu.evals import runner as jrunner
from opus_pllm_tpu.kernels import quant as jquant
from opus_pllm_tpu.kernels import quant4 as jquant4
from opus_pllm_tpu.lora import lora as jlora
from opus_pllm_tpu.models import decoder as jdecoder
from opus_pllm_tpu.parallel import partition as jpartition
from opus_pllm_tpu_torch.cli import main as cli
from opus_pllm_tpu_torch.core import mesh
from opus_pllm_tpu_torch.core.config import MeshConfig
from opus_pllm_tpu_torch.evals import runner
from opus_pllm_tpu_torch.parallel import partition
from torch_dist import RankPool

SHAPES = [(1, 4), (2, 2), (4, 1)]


def _decoder_tree(family, quant):
    """A 2-layer JAX decoder 512 wide (int4 v2 packs K % 512 == 0), in the
    requested storage, as shape-and-dtype leaves."""
    cfg = JDecoderConfig(family=family, vocab_size=256, hidden_size=512,
                         intermediate_size=1024, num_layers=2, num_heads=8,
                         num_kv_heads=2 if family != "opt" else 8,
                         head_dim=64, attention_bias=family == "qwen2",
                         dtype="float32")
    def build():
        p = jdecoder.init(jax.random.PRNGKey(0), cfg)
        if quant == "int8":
            p = jquant.quantize_decoder(p)
        elif quant in ("v1", "v2"):
            p = jquant4.quantize_decoder4(p, quant)
        return p
    # the rules read names and shapes only: trace, do not compute
    return jax.eval_shape(build), cfg


def _flat_specs(tree):
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, path + (k,))
        elif isinstance(x, list):
            for i, v in enumerate(x):
                walk(v, path + (i,))
        else:
            out[path] = tuple(x)
    walk(tree, ())
    return out


def _jax_specs(tree, shape):
    jm = jmesh.make_mesh(JMeshConfig(*shape),
                         devices=jax.devices()[:shape[0] * shape[1]])
    return _flat_specs(jax.tree.map(
        tuple, jpartition.specs(tree, jm),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))


@pytest.fixture(scope="module")
def trees():
    out = {}
    for fam in ("llama", "qwen2", "opt"):
        for quant in ("bf16", "int8", "v1", "v2"):
            out[fam, quant] = _decoder_tree(fam, quant)[0]
    _, cfg = _decoder_tree("llama", "bf16")
    lcfg = JLoRAConfig(rank=4)
    lt = jax.eval_shape(lambda: jlora.init(jax.random.PRNGKey(1), cfg, lcfg))
    out["lora"] = lt
    out["bank"] = jax.eval_shape(
        lambda t: jlora.make_bank({"a": t, "b": t}, capacity=3)[0], lt)
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("which", [
    ("llama", "bf16"), ("llama", "int8"), ("llama", "v1"), ("llama", "v2"),
    ("qwen2", "bf16"), ("qwen2", "int8"), ("qwen2", "v2"), ("opt", "bf16"),
    ("opt", "int8"), ("opt", "v1"), "lora", "bank"], ids=str)
def test_specs_match_jax(trees, which, shape):
    tree = trees[which]
    got = _flat_specs(partition.specs(tree, MeshConfig(*shape)))
    assert got == _jax_specs(tree, shape)
    assert _flat_specs(partition.specs(tree)) == _flat_specs(jax.tree.map(
        tuple, jpartition.specs(tree),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))


def test_parse_mesh_flag_and_local_slice_match_jax():
    for flag in ("4", "2,2", "1,4", " 8 , 1"):
        assert mesh.parse_mesh_flag(flag) == MeshConfig(
            **vars(jmesh.parse_mesh_flag(flag)))
    with pytest.raises(ValueError, match="DATA,MODEL"):
        mesh.parse_mesh_flag("1,2,3")
    for n in (0, 1, 5, 7, 16):
        for pc in (1, 2, 3, 4):
            for pi in range(pc):
                assert mesh.local_slice(n, pi, pc) == jmesh.local_slice(
                    n, pi, pc)


def test_shard_batch_takes_the_data_rows_share():
    import torch
    batch = {"ids": torch.arange(10).reshape(5, 2), "m": [torch.arange(5)]}
    rows = []
    for d in range(2):
        share = mesh.shard_batch(types.SimpleNamespace(data=2, data_index=d),
                                 batch)
        assert torch.equal(share["ids"], batch["ids"][jmesh.local_slice(
            5, d, 2)])
        rows.extend(share["m"][0].tolist())
    assert rows == list(range(5))
    assert mesh.shard_batch(None, batch) is not None


def test_gather_json_blobs_matches_jax():
    parts = [[{"g": "a" * i, "i": i}] * (i % 3) for i in range(4)]

    def fake_allgather(local_of):
        # every process's array, stacked: the test plays all four
        def fn(a):
            return np.stack([local_of(p, a) for p in range(4)])
        return fn

    for pi in range(4):
        def local_of(p, a, pi=pi):
            blob = json.dumps(parts[p]).encode()
            if a.dtype == np.int32:
                n = np.zeros_like(a)
                n[p] = len(blob)
                return n
            buf = np.zeros_like(a)
            buf[:len(blob)] = np.frombuffer(blob, np.uint8)
            return buf
        got = runner.gather_json_blobs(parts[pi], 4, pi,
                                       fake_allgather(local_of))
        ref = jrunner.gather_json_blobs(parts[pi], 4, pi,
                                        fake_allgather(local_of))
        assert got == ref == [r for p in parts for r in p]


def test_backend_rule_and_no_process_group(monkeypatch):
    assert mesh.pick_backend("cpu", 4) == ("gloo", False)
    assert mesh.pick_backend("cuda", 4, n_cards=4) == ("nccl", False)
    assert mesh.pick_backend("cuda", 4, n_cards=1) == ("gloo", True)
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.initialize_distributed(device_type="cpu") is False
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh.make_mesh(MeshConfig(1, 2))


@pytest.fixture(scope="module")
def dirs():
    return tc.toy_dirs()


def _base(dirs, *extra):
    return tc.annotate_args(dirs, extra) + ["--device", "cpu"]


@pytest.mark.parametrize("extra,match", [
    (("--mesh", "1,2"), "torchrun --nproc-per-node 2"),
    (("--seq-shards", "2"), "torchrun --nproc-per-node 2"),
    (("--distributed",), "torchrun"),
    (("--mesh", "1,2", "--seq-shards", "2"), "mutually exclusive"),
])
def test_parallel_flags_need_a_process_group(dirs, monkeypatch, extra,
                                             match):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match=match):
        cli.main(_base(dirs, *extra))


def test_engine_exclusions():
    cli._engine_mesh(None, None)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli._engine_mesh(None, object())
    with pytest.raises(SystemExit, match="--mesh 1,N"):
        cli._engine_mesh(types.SimpleNamespace(data=2, model=1), None)
    with pytest.raises(ValueError, match="data 1"):
        runner._engine_mesh(types.SimpleNamespace(data=2, model=2))


@pytest.mark.parametrize("argv", [
    ["train-lora", "--seq-shards", "2", "--mesh", "2,1"],
    ["train-lora", "--pipe-stages", "2", "--seq-shards", "2"],
    ["train-lora", "--seq-shards", "2", "--val-json", "v.json"],
    ["train-lora", "--pipe-stages", "2", "--val-json", "v.json"]],
    ids=lambda a: " ".join(a))
def test_training_axes_refused_naming_item_10(dirs, tmp_path, argv):
    """The training axes' exclusions that remain, as the JAX CLI makes
    them, before anything loads (the axes themselves run below and in
    tests/test_torch_sp_train.py, test_torch_pp_train.py)."""
    args = ["--train-json", "x", "--out", str(tmp_path)]
    model = ["--model-base", dirs["llama"], "--esm", dirs["esm"]]
    with pytest.raises(SystemExit, match="mutually exclusive|--val-json"):
        cli.main(argv + args + model + ["--device", "cpu"])


@pytest.mark.parametrize("extra,want", [
    (("--seq-shards", "2"), 2), (("--pipe-stages", "2"), 2),
    (("--pipe-stages", "2", "--pipe-data", "2", "--micro-batches", "4"), 4)],
    ids=lambda v: " ".join(v) if isinstance(v, tuple) else str(v))
def test_train_axes_need_a_process_group(dirs, tmp_path, monkeypatch, extra,
                                         want):
    """--seq-shards N starts N ranks, --pipe-stages P --pipe-data D P x D:
    without torchrun's process group the command stops naming it."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    argv = ["train-lora", "--train-json", "x", "--out", str(tmp_path),
            "--model-base", dirs["llama"], "--esm", dirs["esm"],
            "--device", "cpu", *extra]
    with pytest.raises(SystemExit, match=f"torchrun --nproc-per-node {want}"):
        cli.main(argv)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(2, tmp_path_factory.mktemp("cli"))
    yield p
    p.close()


def _jax_cli(argv, monkeypatch=None, feeds=None):
    """The JAX CLI's output with the byte tokenizer (its toy directories
    carry no tokenizer files)."""
    import contextlib
    import io

    from opus_pllm_tpu.cli.main import main
    from opus_pllm_tpu.infer import hf_tokenizer
    saved = hf_tokenizer.HFTokenizer
    hf_tokenizer.HFTokenizer = tc._ByteTok
    buf = io.StringIO()
    try:
        if feeds is not None:
            it = iter(feeds)
            monkeypatch.setattr("builtins.input", lambda *_: next(it))
        with contextlib.redirect_stdout(buf):
            main(argv)
    finally:
        hf_tokenizer.HFTokenizer = saved
    return buf.getvalue()


def test_cli_mesh_and_seq_shards_match_jax(dirs, pool, tmp_path):
    """annotate --mesh 1,2 and --seq-shards 2 over two gloo ranks save the
    JAX CLI's --seq-shards 2 answers (which its own tests hold to its
    single-device and --mesh runs)."""
    out = str(tmp_path / "jax.json")
    _jax_cli(tc.annotate_args(dirs, ("--seq-shards", "2"))
             + ["--save-path", out])
    with open(out) as f:
        ref = [r["generated"] for r in json.load(f)]
    for extra in (("--mesh", "1,2"), ("--seq-shards", "2")):
        out = str(tmp_path / f"port{extra[0]}.json")
        printed = pool.run(cases.cli, _base(dirs, *extra)
                           + ["--save-path", out])
        with open(out) as f:
            assert [r["generated"] for r in json.load(f)] == ref
        metrics = json.loads(printed[0].strip().splitlines()[-1])
        assert set(metrics) and printed[1] == ""     # rank 0 prints


def test_chat_seq_shards_matches_jax(dirs, pool, monkeypatch):
    feeds = ["Where is this protein located?", "MKTAYIAKQR", ""]
    chat = ["chat", "--model-base", dirs["llama"], "--weights",
            dirs["weights"], "--esm", dirs["esm"], "--temperature", "0",
            "--max-new-tokens", "8"]
    ref = _jax_cli(chat + ["--seq-shards", "2"], monkeypatch, feeds)
    got = pool.run(cases.cli, chat + ["--seq-shards", "2", "--device",
                                      "cpu"], feeds)
    assert got[0].strip().splitlines()[-1] == ref.strip().splitlines()[-1]
    assert got[1] == ""


def _train_json(path, n=4):
    with open(path, "w") as f:
        json.dump([{"instruction": "What does this protein do?",
                    "input": tc.SEQS[i % 3], "output": "It binds zinc."}
                   for i in range(n)], f)
    return path


TRAIN_LR, TRAIN_STEPS = 1e-3, 2


@pytest.mark.parametrize("flags", [("--seq-shards", "2"),
                                   ("--pipe-stages", "2")],
                         ids=lambda f: " ".join(f))
def test_train_lora_seq_and_pipe_match_one_process(dirs, pool, tmp_path,
                                                    monkeypatch, flags):
    """train-lora --seq-shards 2 (ring attention over the sequence) and
    --pipe-stages 2 (a stage a rank, 2 microbatches) over both ranks save
    one process's trained tree: within 2 lr x steps, 95% of the entries
    within 5e-5 (bf16 base; tests/test_torch_serve_mesh.py's bounds);
    rank 0 prints and saves."""
    from opus_pllm_tpu_torch.core.checkpoint import CheckpointManager
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.train.multimodal_trainer import leaves
    monkeypatch.setattr(cli, "load_tokenizer",
                        lambda path, family: ByteTokenizer())
    train = _train_json(str(tmp_path / "train.json"))

    def argv(out, *extra):
        return ["train-lora", "--model-base", dirs["llama"], "--esm",
                dirs["esm"], "--weights", dirs["weights"], "--train-json",
                train, "--out", out, "--batch-size", "2", "--max-len", "320",
                "--lora-rank", "4", "--lr", str(TRAIN_LR), "--device", "cpu",
                "--max-steps", str(TRAIN_STEPS), *extra]
    one, out = str(tmp_path / "one"), str(tmp_path / "axis")
    cli.main(argv(one))
    printed = pool.run(cases.cli, argv(out, *flags))
    assert f"step {TRAIN_STEPS}" in printed[0] and printed[1] == ""
    assert CheckpointManager(out).latest_step() == TRAIN_STEPS
    want = leaves(CheckpointManager(one).restore())
    got = leaves(CheckpointManager(out).restore())
    assert len(want) == len(got) > 0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        d = (a.float() - b.float()).abs()
        assert d.max() <= 2 * TRAIN_LR * TRAIN_STEPS
        assert (d <= 5e-5).float().mean() >= 0.95
