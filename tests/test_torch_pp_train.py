"""Pipeline-parallel training of the port (opus_pllm_tpu_torch.train.pp,
parallel/pipeline.py) against the JAX package on the CPU.

Four gloo ranks start once for the file (tests/torch_dist.RankPool); the
2-stage cases run on the first two. Two steps (a global-norm clip that
binds) on OpusConfig.tiny at 4 layers, on the same numpy batches as the
JAX step over the conftest's fake devices: (stages, microbatches) = (2,
2) and (4, 4) with the chunked cross-entropy, DP x PP 2 x 2, the OPT
family training the switch alone (the stages pass input gradients back
through layers without adapters), an int8 base and grad_accum 2. Each
step's loss (1e-5 relative), every gradient as AdamW takes it (1e-4 of
each leaf's largest entry), the parameters after both steps (within 2 lr
x steps, 99% within 1e-6; tests/test_torch_train_mesh.py's bounds),
against the JAX single-device step, which JAX's `pp.make_pp_train_step`
equals by its contract (tests/test_pp_train.py); at DP x PP also against
`pp.make_pp_train_step` itself over the conftest's fake devices: its
losses and its gradient before the clip (tests/torch_train_ref.py on
its scale). Each stage holds only its block of layers; rank 0's
checkpoint restores on one process bit for bit; a layer count the
stages do not divide raises."""

import dataclasses
import functools

import jax
import numpy as np
import pytest

import torch_dist_cases as cases
import torch_train_ref as ref
from opus_pllm_tpu.core.config import LoRAConfig as JLoRAConfig
from opus_pllm_tpu.core.config import OpusConfig as JOpusConfig
from opus_pllm_tpu.kernels.quant import quantize_decoder as jquantize
from opus_pllm_tpu.models import decoder as jdecoder
from opus_pllm_tpu.parallel import pipeline as jpipeline
from opus_pllm_tpu.train import multimodal_trainer as jmmt
from opus_pllm_tpu.train import pp as jpp
from opus_pllm_tpu_torch.core import convert
from opus_pllm_tpu_torch.core.checkpoint import CheckpointManager
from opus_pllm_tpu_torch.core.config import LoRAConfig, OpusConfig, \
    TrainConfig
from opus_pllm_tpu_torch.parallel import pipeline
from opus_pllm_tpu_torch.train import multimodal_trainer as mmt
from opus_pllm_tpu_torch.train import pp
from torch_dist import RankPool

LAYERS = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("pp_train"))
    yield p
    p.close()


def _jcfg(family="llama"):
    jcfg = JOpusConfig.tiny(family)
    return dataclasses.replace(jcfg, llm=dataclasses.replace(
        jcfg.llm, num_layers=LAYERS))


@functools.lru_cache(maxsize=None)
def _inputs(family, int8):
    """The config's field dicts, the numpy trees (the LLM int8 when
    `int8`; LoRA except for OPT, which trains the switch alone) and the
    batches."""
    jcfg = _jcfg(family)
    frozen, trainable = ref.trees(jcfg, lora=family != "opt")
    if int8:
        frozen["llm"] = ref.np_tree(jquantize(frozen["llm"]))
    batches = [ref.batch(OpusConfig.tiny(), seed=s) for s in range(ref.STEPS)]
    return jcfg, frozen, trainable, batches


def _lora(family):
    return JLoRAConfig(**ref.LORA) if family != "opt" else None


@functools.lru_cache(maxsize=None)
def _single(family, int8):
    jcfg, frozen, trainable, batches = _inputs(family, int8)
    return ref.single_steps(jcfg, frozen, trainable, batches,
                            lora=family != "opt")


@functools.lru_cache(maxsize=None)
def _pipelined(stages, data, micro):
    """JAX's pipeline steps over the conftest's fake devices."""
    jcfg, frozen, trainable, batches = _inputs("llama", False)
    stacked = dict(frozen, llm=jdecoder.stack_params(
        jax.tree.map(jax.numpy.asarray, frozen["llm"])))
    return ref.jax_steps(
        lambda tx: jpp.make_pp_train_step(
            jcfg, tx, jpipeline.make_pp_mesh(stages, data=data),
            lora_cfg=JLoRAConfig(**ref.LORA), donate=False, n_micro=micro,
            remat=False),
        jcfg, stacked, trainable, batches)


@pytest.mark.parametrize("stages,data,micro,chunk,accum,family,int8", [
    (2, 1, 2, 0, 1, "llama", False), (4, 1, 4, 8, 1, "llama", False),
    (2, 2, 2, 0, 1, "llama", False), (2, 1, 2, 0, 1, "opt", False),
    (2, 1, 2, 0, 1, "llama", True), (2, 1, 2, 0, 2, "llama", False)],
    ids=["2x2", "4x4-ce_chunk8", "dp2xpp2", "opt-switch", "int8",
         "accum2"])
def test_pp_step_matches_jax(pool, stages, data, micro, chunk, accum,
                             family, int8, tmp_path):
    jcfg, frozen, trainable, batches = _inputs(family, int8)
    single, after = _single(family, int8)
    ckpt = str(tmp_path / "ckpt") if stages == 4 else None
    outs = pool.run(cases.pp_train_steps, stages, data, micro,
                    ref.cfg_dicts(jcfg), frozen, trainable, batches,
                    dict(ref.TCFG, grad_accum=accum, ce_chunk=chunk),
                    ref.LORA if family != "opt" else None, ckpt)
    n = stages * data
    ref.check([o and o[0] for o in outs], n, [x[0] for x in single], single,
              after, batches)
    # each stage holds its block of the layers only
    assert [o[1] for o in outs[:n]] == [LAYERS // stages] * n
    if data > 1:
        # JAX's pipeline step itself: its losses, and its gradient before
        # the clip, the single-device one times the devices its explicit
        # gradient sum adds over (the stages and replicas for the switch,
        # the replicas for LoRA; tests/torch_train_ref.py)
        piped, _ = _pipelined(stages, data, micro)
        for (loss, _, _), (want, _, _) in zip(outs[0][0][0], piped):
            np.testing.assert_allclose(loss, want, rtol=1e-5)
        ref.raw_times(outs[0][0][0][0][2], single[0], piped[0],
                      {"switch": stages * data, "lora": data})
    if ckpt:
        like, _ = mmt.create_state(
            OpusConfig.tiny(), TrainConfig(**ref.TCFG),
            convert.from_jax(frozen, device="cpu"),
            trainable=convert.trainable_from_jax(trainable, device="cpu"),
            lora_cfg=LoRAConfig(**ref.LORA), device="cpu")
        got = mmt.restore_state(CheckpointManager(ckpt), like)
        assert got.step == ref.STEPS and got.opt_state.count == ref.STEPS
        for a, b in zip(mmt.leaves(got.trainable),
                        mmt.leaves(outs[0][0][1])):
            assert np.array_equal(a.detach().numpy(), b)


def test_pp_layer_count_must_divide():
    """3 layers over 2 stages: the mesh's split, `shard_frozen` and the
    step factory raise ValueError, as the JAX step does."""
    mesh = pipeline.PipeMesh(2, 1, 0, 0, [[0, 1]], None, None, None)
    cfg = OpusConfig.tiny()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                           num_layers=3))
    with pytest.raises(ValueError, match="divisible"):
        mesh.layer_range(3)
    with pytest.raises(ValueError, match="divisible"):
        pp.shard_frozen(mesh, {"llm": {"layers": [{}] * 3}}, cfg)
    with pytest.raises(ValueError, match="divisible"):
        pp.make_pp_train_step(cfg, None, mesh)
    assert mesh.layer_range(4) == range(0, 2)
