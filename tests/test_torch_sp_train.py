"""Sequence-parallel training of the port (opus_pllm_tpu_torch.train.sp)
against the JAX package on the CPU.

Four gloo ranks start once for the file (tests/torch_dist.RankPool); the
2-rank cases run on the first two. Two train-lora steps (LoRA on every
projection, the switch trained, a global-norm clip that binds) on
OpusConfig.tiny at 2 and 4 sequence shards (the spliced stream padded to
a multiple of the shard count), the chunked cross-entropy, dynamic-NTK
rope past the trained length and grad_accum 2, on the same numpy
batches as JAX: each step's loss (1e-5 relative), every gradient as
AdamW takes it (1e-4 of each leaf's largest entry), the parameters after
both steps (within 2 lr x steps, 99% within 1e-6;
tests/test_torch_train_mesh.py's bounds), against the JAX single-device
step, which JAX's `sp.make_sp_train_step` equals by its contract
(tests/test_sp_train.py); with dynamic NTK, whose rope context is the
padded stream's, and at 4 shards with the chunked cross-entropy against
`sp.make_sp_train_step` itself over the conftest's fake devices (there
also its gradient before the clip, which is the shard count times the
port's: tests/torch_train_ref.py). Rank 0's checkpoint restores on one
process bit for bit."""

import dataclasses
import functools

import numpy as np
import pytest

import torch_dist_cases as cases
import torch_train_ref as ref
from opus_pllm_tpu.core.config import LoRAConfig as JLoRAConfig
from opus_pllm_tpu.core.config import OpusConfig as JOpusConfig
from opus_pllm_tpu.parallel import ring as jring
from opus_pllm_tpu.train import sp as jsp
from opus_pllm_tpu_torch.core import convert
from opus_pllm_tpu_torch.core.checkpoint import CheckpointManager
from opus_pllm_tpu_torch.core.config import LoRAConfig, OpusConfig, \
    TrainConfig
from opus_pllm_tpu_torch.train import multimodal_trainer as mmt
from torch_dist import RankPool


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("sp_train"))
    yield p
    p.close()


@functools.lru_cache(maxsize=None)
def _inputs(ntk):
    jcfg = JOpusConfig.tiny()
    if ntk:
        # a trained length below the spliced stream's: the rope base
        # rescales from the GLOBAL padded length on every shard
        jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(
            jcfg.llm, use_dynamic_ntk=True, max_position_embeddings=8))
    frozen, trainable = ref.trees(jcfg)
    batches = [ref.batch(OpusConfig.tiny(), seed=s) for s in range(ref.STEPS)]
    return jcfg, frozen, trainable, batches


@functools.lru_cache(maxsize=None)
def _single(ntk):
    return ref.single_steps(*_inputs(ntk))


@functools.lru_cache(maxsize=None)
def _sharded(n, chunk, ntk):
    """JAX's sequence-parallel steps over n of the fake devices."""
    jcfg, frozen, trainable, batches = _inputs(ntk)
    return ref.jax_steps(
        lambda tx: jsp.make_sp_train_step(
            jcfg, tx, jring.make_sp_mesh(n), lora_cfg=JLoRAConfig(**ref.LORA),
            donate=False, ce_chunk=chunk, remat=False),
        jcfg, frozen, trainable, batches)


@pytest.mark.parametrize("n,accum,chunk,ntk", [
    (2, 1, 0, False), (4, 1, 8, False), (4, 1, 0, True), (2, 2, 0, False)],
    ids=["2", "4-ce_chunk8", "4-ntk", "2-accum2"])
def test_sp_step_matches_jax(pool, n, accum, chunk, ntk, tmp_path):
    jcfg, frozen, trainable, batches = _inputs(ntk)
    # dynamic NTK takes its context from the padded stream, which one
    # device does not pad: that case is held to JAX's sharded step alone
    single, after = _sharded(n, chunk, ntk) if ntk else _single(ntk)
    vs_sharded = (n, chunk) == (4, 8)
    ckpt = str(tmp_path / "ckpt") if vs_sharded else None
    outs = pool.run(cases.sp_train_steps, n, ref.cfg_dicts(jcfg), frozen,
                    trainable, batches, dict(ref.TCFG, grad_accum=accum,
                                             ce_chunk=chunk), ref.LORA, ckpt)
    ref.check(outs, n, [x[0] for x in single], single, after, batches)
    if not vs_sharded:
        return
    sharded, _ = _sharded(n, chunk, ntk)
    for (loss, _, _), (want, _, _) in zip(outs[0][0], sharded):
        np.testing.assert_allclose(loss, want, rtol=1e-5)
    ref.raw_times(outs[0][0][0][2], single[0], sharded[0],
                  {"switch": n, "lora": n})
    # rank 0's checkpoint, restored into a fresh single-process state
    like, _ = mmt.create_state(
        OpusConfig.tiny(), TrainConfig(**ref.TCFG),
        convert.from_jax(frozen, device="cpu"),
        trainable=convert.trainable_from_jax(trainable, device="cpu"),
        lora_cfg=LoRAConfig(**ref.LORA), device="cpu")
    got = mmt.restore_state(CheckpointManager(ckpt), like)
    assert got.step == ref.STEPS and got.opt_state.count == ref.STEPS
    for a, b in zip(mmt.leaves(got.trainable), mmt.leaves(outs[0][1])):
        assert np.array_equal(a.detach().numpy(), b)
