"""The trainers on a (data, model) mesh of gloo ranks against the JAX
package on the CPU (train.multimodal_trainer.fit(mesh=)'s step with
`parallel.partition.shard_frozen` / `shard_state`, and
train.cstp_trainer.fit(mesh=)).

Four ranks start once for the file (tests/torch_dist.RankPool). Two
train-lora steps (LoRA on every projection and the switch trained) on
OpusConfig.tiny at meshes 2x2 (tensor-parallel attention and MLP, FSDP
over the data pair) and 4x1, with grad_accum 1 and 2, the chunked
cross-entropy (each chunk's head under its checkpoint) and a global-norm
clip that binds, against two JAX single-device steps on the same numpy
batches (tests/test_train.py::test_multimodal_step_sharded_matches_single_
device holds JAX's sharded step to it): each step's loss (1e-5
relative) and every gradient as AdamW takes it (the JAX gradient through
optax's clip_by_global_norm; 1e-4 of each leaf's largest entry, fp32
summation order), so the second step runs on the sharded moments; the
parameters after both (within 2 lr x steps: Adam's update is about
lr sign(g), so a near-zero gradient may move the other way; 99% within
1e-6). A mesh checkpoint restores on one process bit for bit. A
row-parallel LoRA projection on two model ranks rounds as one process
does, in bf16 (exactly). cstp_trainer.fit at data 2 against the JAX step
on the global batch: each step's loss and accuracies (5e-4,
tests/test_torch_cstp.py's bound), the parameters after 2 steps (2 lr x
steps, 99% within 1e-4)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_cases as cases
from opus_pllm_tpu.core.config import CSTPConfig as JCSTPConfig
from opus_pllm_tpu.core.config import LoRAConfig as JLoRAConfig
from opus_pllm_tpu.core.config import OpusConfig as JOpusConfig
from opus_pllm_tpu.core.config import TrainConfig as JTrainConfig
from opus_pllm_tpu.models import opus as jopus
from opus_pllm_tpu.train import cstp_trainer as jct
from opus_pllm_tpu.train import multimodal_trainer as jmmt
from opus_pllm_tpu.train import optim as joptim
from opus_pllm_tpu_torch.core.checkpoint import CheckpointManager
from opus_pllm_tpu_torch.core.config import (IGNORE_INDEX, LoRAConfig,
                                             OpusConfig, SEQ_TOKEN_INDEX,
                                             TrainConfig)
from opus_pllm_tpu_torch.train import multimodal_trainer as mmt
from torch_dist import RankPool

LS = 2.0                                   # LoRAConfig(rank=2, alpha=4)
LR, CLIP = 1e-3, 0.05
STEPS = 2
TCFG = dict(learning_rate=LR, grad_clip_norm=CLIP, log_every=0)
LORA = dict(rank=2, alpha=4.0)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("train"))
    yield p
    p.close()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, b=8, l=12, seed=0):
    """Random prompts with a <seq> sentinel, right-padded by different
    amounts (so data ranks and accumulation chunks hold different valid
    counts), the first 4 labels ignored."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, cfg.llm.vocab_size, (b, l)).astype(np.int32)
    ids[:, 1] = SEQ_TOKEN_INDEX
    attn = np.ones((b, l), bool)
    for r in range(b):
        attn[r, l - (r % 4) * 2:] = False
    labels = np.where(attn, ids, IGNORE_INDEX).astype(np.int32)
    labels[:, :4] = IGNORE_INDEX
    esm = rng.integers(4, 24, (b, 1, 8)).astype(np.int32)
    esm[:, :, 0] = 0
    esm[:, :, -1] = 2
    return {"input_ids": ids, "attn_mask": attn, "labels": labels,
            "esm_tokens": esm}


@functools.lru_cache(maxsize=None)
def _reference():
    """The JAX trees, the batches and STEPS JAX steps: each step's loss
    and clipped gradient, the post-step trainable tree."""
    jcfg = JOpusConfig.tiny()
    frozen = jopus.init(jax.random.PRNGKey(0), jcfg)
    trainable = _np(jmmt.init_trainable(
        jax.random.PRNGKey(1), jcfg, train_switch=True,
        lora_cfg=JLoRAConfig(**LORA), frozen_params=frozen))
    rng = np.random.default_rng(3)
    for la in trainable["lora"]["layers"]:     # B != 0: A takes gradient
        for ab in la.values():
            ab["B"] = (rng.normal(size=ab["B"].shape) / 8).astype(np.float32)
    batches = [_batch(OpusConfig.tiny(), seed=s) for s in range(STEPS)]
    tx = joptim.adamw(JTrainConfig(**TCFG))

    @jax.jit
    def step(t, opt, frozen, b):
        # the JAX step (make_train_step's value_and_grad and optax
        # update), with the gradient before and after the clip
        (loss, _), g = jax.value_and_grad(jmmt.loss_fn, has_aux=True)(
            t, frozen, jcfg, b, LS, True, 0)
        updates, opt = tx.update(g, opt, t)
        clipped, _ = optax.clip_by_global_norm(CLIP).update(g, None)
        return (loss, clipped, optax.apply_updates(t, updates), opt,
                optax.global_norm(g))

    t = jax.tree.map(jnp.asarray, trainable)
    opt, steps = tx.init(t), []
    for batch in batches:
        loss, clipped, t, opt, norm = step(
            t, opt, frozen, {k: jnp.asarray(v) for k, v in batch.items()})
        assert float(norm) > 2 * CLIP, float(norm)     # the clip binds
        steps.append((float(loss), _np(clipped)))
    return (dataclasses.asdict(jcfg), _np(frozen), trainable, batches,
            steps, _np(t))


def _close(got, ref, rel, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-6), (what, err)


@pytest.mark.parametrize("shape,accum,chunk", [
    ((2, 2), 1, 0), ((2, 2), 2, 0), ((4, 1), 2, 0), ((2, 2), 1, 4)],
    ids=["2x2", "2x2-accum2", "4x1-accum2", "2x2-ce_chunk4"])
def test_train_lora_step_on_mesh_matches_jax(pool, shape, accum, chunk,
                                             tmp_path):
    cfg_dicts, frozen, trainable, batches, ref, after = _reference()
    ckpt = str(tmp_path / "ckpt") if (accum, chunk) == (1, 0) else None
    outs = pool.run(cases.train_step, *shape, cfg_dicts, frozen, trainable,
                    batches, dict(TCFG, grad_accum=accum, ce_chunk=chunk),
                    LORA, ckpt)
    n = shape[0] * shape[1]
    assert all(o is None for o in outs[n:])
    ref_p = mmt.leaves(after)
    for rank, (got_steps, got_p, split) in enumerate(outs[:n]):
        assert len(got_steps) == STEPS
        for s, ((got_loss, valid, got_g), (loss, grads), batch) in \
                enumerate(zip(got_steps, ref, batches)):
            np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
            assert valid == int(((batch["labels"][:, 1:] != IGNORE_INDEX)
                                 & batch["attn_mask"][:, 1:]).sum())
            for i, (a, b) in enumerate(zip(mmt.leaves(got_g),
                                           mmt.leaves(grads))):
                _close(a, b, 1e-4, (rank, s, "grad", i))
        for a, b in zip(mmt.leaves(got_p), ref_p):
            d = np.abs(a - b)
            assert d.max() <= 2 * LR * STEPS and (d <= 1e-6).mean() >= 0.99
    # the shares really were cut: over model at 2x2, over data at both
    dims = outs[0][2]
    assert any(m is not None for m, _ in dims) == (shape[1] > 1)
    assert any(d is not None for _, d in dims)
    if ckpt:
        # the full tree, restored into a fresh single-process state
        tcfg = OpusConfig.tiny()
        from opus_pllm_tpu_torch.core import convert
        like, _ = mmt.create_state(
            tcfg, TrainConfig(**TCFG), convert.from_jax(frozen, device="cpu"),
            trainable=convert.trainable_from_jax(trainable, device="cpu"),
            lora_cfg=LoRAConfig(**LORA), device="cpu")
        got = mmt.restore_state(CheckpointManager(ckpt), like)
        assert got.step == STEPS and got.opt_state.count == STEPS
        for a, b in zip(mmt.leaves(got.trainable), mmt.leaves(outs[0][1])):
            assert np.array_equal(a.detach().numpy(), b)
        moments = got.opt_state.state_dict()["opt"]["state"]
        assert len(moments) == len(ref_p)
        for i, b in enumerate(mmt.leaves(outs[0][1])):
            assert moments[i]["exp_avg"].shape == b.shape


def test_row_parallel_lora_rounds_as_one_process(pool):
    """A row-parallel LoRA projection on 2 model ranks rounds as
    layers.lora_dense does on one process: the base sum to bf16 first,
    then the fp32 delta added and rounded once. The base products are
    exact in bf16 and sum to just under the midpoint between 1 and the
    next bf16 value; the delta (2^-15) is below half a unit in the last
    place, so one process returns 1.0, and so must the mesh (a delta added
    to the fp32 sum before its one rounding would carry it over the
    midpoint). Both with grad on and under no_grad; exact equality."""
    from opus_pllm_tpu_torch.models.layers import lora_dense
    x = np.ones((1, 2), np.float32)
    w = np.array([[1.0], [2 ** -8 - 2 ** -16]], np.float32)
    a = np.ones((2, 1), np.float32)
    b = np.full((1, 1), 2 ** -16, np.float32)
    one = lora_dense({"kernel": torch.from_numpy(w).to(torch.bfloat16)},
                     {"A": torch.from_numpy(a), "B": torch.from_numpy(b)},
                     torch.from_numpy(x).to(torch.bfloat16), 1.0)
    assert one.float().item() == 1.0
    outs = pool.run(cases.row_parallel_lora, 2, x, w, a, b, 1.0)
    assert outs[2] is None and outs[3] is None
    for off, on in outs[:2]:
        assert off.item() == 1.0 and on.item() == 1.0


def test_cstp_fit_on_data_mesh_matches_jax(pool):
    """2 steps of fit at --mesh 2 (ranks 0-1 of the pool) against the JAX
    step on the global batch of 8: the similarity spans both ranks'
    rows."""
    jc = JCSTPConfig.tiny()
    js, jtx = jct.create_state(jax.random.PRNGKey(0), jc,
                               JTrainConfig(batch_size=8))
    params = _np(js.params)
    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((8, 64)).astype(np.float32),
                rng.standard_normal((8, 96)).astype(np.float32))
               for _ in range(2)]
    jstep = jct.make_train_step(jc, jtx)
    ref = []
    for se, te in batches:
        js, jm = jstep(js, jnp.asarray(se), jnp.asarray(te))
        ref.append({k: float(v) for k, v in jm.items()})
    outs = pool.run(cases.cstp_steps, 2, params, batches,
                    dataclasses.asdict(jc), dict(batch_size=8))
    assert outs[2] is None and outs[3] is None
    lr, steps = TrainConfig().learning_rate, 2
    for got_steps, got_params in outs[:2]:
        for got, want in zip(got_steps, ref):
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=5e-4, atol=5e-4)
        for name in ("protein_projection", "text_projection"):
            for leaf in ("kernel", "bias"):
                d = np.abs(got_params[name][leaf]
                           - np.asarray(js.params[name][leaf]))
                assert d.max() <= 2 * lr * steps
                assert (d <= 1e-4).mean() >= 0.99
    assert outs[0][0] == outs[1][0]         # every rank logs the same
    assert torch.equal(torch.as_tensor(outs[0][1]["text_projection"][
        "kernel"]), torch.as_tensor(outs[1][1]["text_projection"]["kernel"]))
