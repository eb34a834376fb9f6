"""The port's checkpoints, resume and reference-format export:
core.checkpoint (torch.save format), multimodal_trainer.fit(ckpt=,
save_every=) / restore_state, and the reverse converters of core.convert
against the JAX package's (convert.py:353-417).

A resumed run is held to an uninterrupted one bit for bit on the CPU: the
same batches, the same optimizer (warmup-cosine schedule, clip, weight
decay), restored into a freshly built state."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from opus_pllm_tpu.bridge import projector as jprojector
from opus_pllm_tpu.core import convert as jconvert
from opus_pllm_tpu.core.config import DecoderConfig as JDecoderConfig
from opus_pllm_tpu.core.config import LoRAConfig as JLoRAConfig
from opus_pllm_tpu.core.config import SwitchProjectorConfig as JSwitchConfig
from opus_pllm_tpu.lora import lora as jlora
from opus_pllm_tpu_torch.core import checkpoint, convert
from opus_pllm_tpu_torch.core.config import (IGNORE_INDEX, LoRAConfig,
                                             OpusConfig, SEQ_TOKEN_INDEX,
                                             TrainConfig)
from opus_pllm_tpu_torch.core.util import to_device
from opus_pllm_tpu_torch.models import opus
from opus_pllm_tpu_torch.train import multimodal_trainer as mmt

STEPS = 4
TCFG = TrainConfig(learning_rate=1e-2, weight_decay=0.01, warmup_steps=2,
                   grad_clip_norm=1.0, log_every=1)
LCFG = LoRAConfig(rank=2, alpha=4.0)


def _tree(dtype):
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 4, generator=g).to(dtype),
            "layers": [{"a": torch.randn(2, generator=g).to(dtype)},
                       {"a": torch.randn(2, generator=g).to(dtype),
                        "b": (torch.arange(3), 1.5)}],
            "step": 7, "name": "x", "none": None}


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pytree_round_trip(dtype, tmp_path):
    tree = _tree(dtype)
    path = str(tmp_path / "t.pt")
    checkpoint.save_pytree(path, tree)
    assert _equal(checkpoint.restore_pytree(path), tree)
    # saved again over the same file
    tree["step"] = 8
    checkpoint.save_pytree(path, tree)
    assert checkpoint.restore_pytree(path)["step"] == 8


def test_restore_like_takes_dtype_device_and_grad(tmp_path):
    tree = _tree(torch.bfloat16)
    path = str(tmp_path / "t.pt")
    checkpoint.save_pytree(path, tree)
    like = _tree(torch.float32)
    like["w"].requires_grad_(True)
    got = checkpoint.restore_pytree(path, like=like)
    assert got["w"].dtype == torch.float32 and got["w"].requires_grad
    assert torch.equal(got["w"].detach(), tree["w"].float())
    assert got["layers"][1]["a"].dtype == torch.float32
    assert not got["layers"][1]["a"].requires_grad
    assert got["layers"][1]["b"][0].dtype == torch.int64  # like's dtype
    assert got["step"] == 7 and got["none"] is None


@pytest.mark.parametrize("change", ["key", "length", "shape", "leaf"])
def test_restore_like_structure_mismatch_raises(change, tmp_path):
    path = str(tmp_path / "t.pt")
    checkpoint.save_pytree(path, _tree(torch.float32))
    like = _tree(torch.float32)
    if change == "key":
        like["extra"] = torch.zeros(1)
    elif change == "length":
        like["layers"].append({"a": torch.zeros(2)})
    elif change == "shape":
        like["w"] = torch.zeros(4, 3)
    else:
        like["step"] = {"n": 7}
    with pytest.raises(ValueError):
        checkpoint.restore_pytree(path, like=like)


def test_manager_retention_and_latest_step(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in (1, 2, 3, 5):
        mgr.save(step, {"v": torch.full((2,), float(step))},
                 wait=step != 5)
    assert mgr.latest_step() == 5
    assert mgr.all_steps() == [3, 5]
    assert sorted(os.listdir(tmp_path / "ck")) == ["3", "5"]
    assert mgr.restore()["v"].tolist() == [5.0, 5.0]
    assert mgr.restore(3)["v"].tolist() == [3.0, 3.0]
    with pytest.raises(FileNotFoundError):
        mgr.restore(2)
    # a second manager over the same directory sees the same steps
    again = checkpoint.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert again.latest_step() == 5
    keep_all = checkpoint.CheckpointManager(str(tmp_path / "all"),
                                            max_to_keep=None)
    for step in range(4):
        keep_all.save(step, {"s": step}, wait=False)
    keep_all.close()
    assert keep_all.all_steps() == [0, 1, 2, 3]
    mgr.close()


def test_empty_directory_has_nothing_to_restore(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path / "empty"))
    assert mgr.latest_step() is None and mgr.all_steps() == []
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    (tmp_path / "empty" / "4.tmp").mkdir()       # an unfinished write
    assert mgr.latest_step() is None


# --- fit, save, restore ---------------------------------------------------

def _cfg():
    c = OpusConfig.tiny("llama")
    return dataclasses.replace(c, esm=dataclasses.replace(c.esm,
                                                          num_layers=1))


def _batches(cfg, n, b=2, l=10):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        ids = rng.integers(4, cfg.llm.vocab_size, (b, l)).astype(np.int32)
        ids[:, 1] = SEQ_TOKEN_INDEX
        attn = np.ones((b, l), bool)
        attn[1, l - 3:] = False
        labels = np.where(attn, ids, IGNORE_INDEX).astype(np.int32)
        labels[:, :3] = IGNORE_INDEX
        esm = rng.integers(4, 24, (b, 1, 8)).astype(np.int32)
        esm[:, :, 0], esm[:, :, -1] = 0, 2
        out.append({"input_ids": ids, "attn_mask": attn, "labels": labels,
                    "esm_tokens": esm})
    return out


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    frozen = opus.init(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    return cfg, frozen, _batches(cfg, STEPS)


def _fresh(cfg, frozen, train_switch=False, seed=1):
    return mmt.create_state(cfg, TCFG, frozen,
                            generator=torch.Generator().manual_seed(seed),
                            train_switch=train_switch, lora_cfg=LCFG,
                            total_steps=STEPS, device="cpu")


def _fit(state, tx, cfg, frozen, batches, **kw):
    return mmt.fit(state, tx, cfg, TCFG, frozen, batches, lora_cfg=LCFG,
                   log_fn=lambda *_: None, device="cpu", **kw)


def _same_state(a, b):
    assert a.step == b.step
    for x, y in zip(mmt.leaves(a.trainable), mmt.leaves(b.trainable)):
        assert torch.equal(x, y)
    sa, sb = a.opt_state.state_dict(), b.opt_state.state_dict()
    assert sa["count"] == sb["count"]
    assert set(sa["opt"]["state"]) == set(sb["opt"]["state"])
    for k, v in sa["opt"]["state"].items():
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(v[name], sb["opt"]["state"][k][name]), name


@pytest.mark.parametrize("train_switch", [False, True])
def test_resumed_fit_equals_uninterrupted(setup, train_switch, tmp_path):
    """4 steps straight against 2 steps + save + restore_state into a
    fresh state + the 2 batches after the saved step: bit for bit."""
    cfg, frozen, batches = setup
    state, tx = _fresh(cfg, frozen, train_switch)
    straight = _fit(state, tx, cfg, frozen, batches)

    state, tx = _fresh(cfg, frozen, train_switch)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "rs"), max_to_keep=2)
    _fit(state, tx, cfg, frozen, batches[:2], ckpt=mgr, save_every=2)
    assert mgr.all_steps() == [2]

    like, like_tx = _fresh(cfg, frozen, train_switch, seed=9)
    resumed = mmt.restore_state(mgr, like)
    assert resumed is like and resumed.step == 2
    assert all(p.requires_grad for p in mmt.leaves(resumed.trainable))
    _same_state(resumed, state)
    resumed = _fit(resumed, like_tx, cfg, frozen,
                   batches[resumed.step:])
    _same_state(resumed, straight)


def test_async_save_records_the_step_it_was_called_at(setup, tmp_path):
    """The step updates the leaves and moments in place; a save issued
    without waiting, followed by more steps, still holds the state of its
    own step (the manager copies to the host before it returns)."""
    cfg, frozen, batches = setup
    state, tx = _fresh(cfg, frozen)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "rs"), max_to_keep=3)
    step_fn = mmt.make_train_step(cfg, tx, lora_cfg=LCFG)
    copies = {}
    for i, b in enumerate(batches, 1):
        state, _ = step_fn(state, frozen, to_device(b, "cpu"))
        copies[i] = checkpoint.snapshot(mmt.state_tree(state))
        mmt.maybe_save(mgr, 2, i, state)
    mmt.finish_saves(mgr, 2)
    assert mgr.all_steps() == [2, 4]
    for k in (2, 4):
        like, _ = _fresh(cfg, frozen, seed=k)
        got = mmt.restore_state(mgr, like, step=k)
        assert got.step == k
        ref = copies[k]
        for x, y in zip(mmt.leaves(got.trainable),
                        mmt.leaves(ref["trainable"])):
            assert torch.equal(x.detach(), y)
        assert _equal(got.opt_state.state_dict()["opt"]["state"],
                      ref["opt_state"]["opt"]["state"])
    # the step-2 snapshot differs from the live state: a write made after
    # the later steps would have recorded theirs
    assert not torch.equal(mmt.leaves(copies[2]["trainable"])[0],
                           mmt.leaves(state.trainable)[0].detach())


def test_restore_state_refuses_another_structure(setup, tmp_path):
    cfg, frozen, batches = setup
    state, tx = _fresh(cfg, frozen)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "rs"))
    _fit(state, tx, cfg, frozen, batches[:1], ckpt=mgr, save_every=1)
    other, _ = mmt.create_state(
        cfg, TCFG, frozen, generator=torch.Generator().manual_seed(0),
        train_switch=False, lora_cfg=LoRAConfig(rank=4, alpha=8.0),
        device="cpu")
    with pytest.raises(ValueError):
        mmt.restore_state(mgr, other)
    with pytest.raises(FileNotFoundError):
        mmt.restore_state(checkpoint.CheckpointManager(
            str(tmp_path / "none")), state)


# --- reverse converters ---------------------------------------------------

def _jax_trainable():
    scfg = JSwitchConfig(input_dim=32, llm_hidden_size=16, n_tokens=4,
                         projector_type="mlp2x_gelu")
    switch = jprojector.init(jax.random.PRNGKey(0), scfg)
    lora = jlora.init(jax.random.PRNGKey(1), JDecoderConfig.tiny(),
                      JLoRAConfig(rank=2))
    lora = jax.tree.map(lambda x: x + 0.1, lora)
    return jax.tree.map(np.asarray, {"switch": switch, "lora": lora})


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_reverse_converters_match_jax(family):
    jt = _jax_trainable()
    tt = convert.trainable_from_jax(jt, device="cpu")
    for got, ref in ((convert.switch_projector_to_torch(tt["switch"]),
                      jconvert.switch_projector_to_torch(jt["switch"])),
                     (convert.lora_to_peft(tt["lora"], family=family),
                      jconvert.lora_to_peft(jt["lora"], family=family))):
        assert list(got) == list(ref)
        for k in ref:
            assert got[k].dtype == np.float32 and got[k].shape == \
                ref[k].shape
            np.testing.assert_array_equal(got[k], ref[k])
    sd = convert.lora_to_peft(tt["lora"], family=family)
    assert all(v.flags["C_CONTIGUOUS"] for v in sd.values())
    n_layers = len(jt["lora"]["layers"])
    assert len(sd) == n_layers * len(jt["lora"]["layers"][0]) * 2


def test_export_round_trips_through_torch_load(tmp_path):
    """save_torch_state_dict, then torch.load: the same tensors, (out, in)
    orientation, from a bf16 CUDA-style tree (leaves converted to fp32)."""
    jt = _jax_trainable()
    tt = convert.trainable_from_jax(jt, device="cpu")
    tt["lora"]["layers"][0]["q_proj"]["A"] = \
        tt["lora"]["layers"][0]["q_proj"]["A"].to(torch.bfloat16)
    for name, sd in (("switch.bin",
                      convert.switch_projector_to_torch(tt["switch"])),
                     ("adapter_model.bin", convert.lora_to_peft(tt["lora"]))):
        path = str(tmp_path / name)
        convert.save_torch_state_dict(sd, path)
        back = torch.load(path, weights_only=True)
        assert list(back) == list(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], torch.from_numpy(np.asarray(v)))
    a = tt["lora"]["layers"][0]["q_proj"]["A"]
    key = "base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight"
    assert torch.equal(torch.load(str(tmp_path / "adapter_model.bin"),
                                  weights_only=True)[key],
                       a.float().t())
    w = tt["switch"]["layers"][0]["kernel"]
    assert torch.load(str(tmp_path / "switch.bin"), weights_only=True)[
        "switch_projector.0.weight"].shape == (w.shape[1], w.shape[0])
