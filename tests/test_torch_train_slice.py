"""Port parity for the training slice as `train-lora` runs it: synthetic
instruction records in a JSON file -> InstructionDataset ->
instruction_batches -> three steps of the port's `fit` against three
steps of the JAX `make_train_step` (donate=False) from the same trainable
tree, LoRA only (rank 2, alpha 4, the seven projections), remat on, on the
CPU with each package's plain paths.

Two frozen bases: the tiny config (fp32), and a tiny LLM at the dims of
tests/test_train.py:203-206 (hidden 256, intermediate 512, head_dim 64)
quantized with `quantize_decoder4(layout="v1")`, the `train-* --load-int4`
layout. The vocabulary is 260, the ByteTokenizer's.

On the CPU the JAX package runs every v1 product through `_matmul_xla`,
which rounds the group scales and the dequantized weights to bf16, while
the port's v1 version (the CUDA kernel's function) keeps them fp32. The v1
base therefore gets power-of-two group scales (the nearest to each
absmax/7 scale) in both packages: then q * scale is exact in bf16 and the
two compute the same function. Both still round each projection's input
to bf16 (as the TPU kernel does), so an fp32 summation-order difference
upstream can move an input element across a bf16 rounding boundary: the v1
base's two runs differ at that level, not at fp32's.

Tolerances: the per-step losses (logged with 4 decimals by `fit`) within
2e-4 of the largest. The LoRA leaves after three steps: Adam's first
update is lr * sign(g), and LoRA A takes its first gradient only once B
has moved, so an element whose gradient is about zero may move the other
way in the other package; all elements are within 2 lr x steps, and all
but 0.5% (fp32) or 5% (v1, the bf16-rounding level above: up to 3.3% of
one leaf seen) of each leaf within 2% of lr."""

import dataclasses
import json

import jax
import numpy as np
import pytest

from opus_pllm_tpu.core.config import (CSTPConfig as JCSTPConfig,
                                       DecoderConfig as JDecoderConfig,
                                       ESM2Config as JESM2Config,
                                       LoRAConfig as JLoRAConfig,
                                       OpusConfig as JOpusConfig,
                                       SwitchProjectorConfig as JSwitchConfig,
                                       TrainConfig as JTrainConfig)
from opus_pllm_tpu.data import collate as jcollate
from opus_pllm_tpu.data import datasets as jdatasets
from opus_pllm_tpu.infer.tokenization import ByteTokenizer as JByteTokenizer
from opus_pllm_tpu.kernels import quant4 as jq
from opus_pllm_tpu.models import opus as jopus
from opus_pllm_tpu.train import multimodal_trainer as jmmt
from opus_pllm_tpu_torch.core import convert
from opus_pllm_tpu_torch.core.config import (CSTPConfig, DecoderConfig,
                                             ESM2Config, LoRAConfig,
                                             OpusConfig,
                                             SwitchProjectorConfig,
                                             TrainConfig)
from opus_pllm_tpu_torch.data import collate, datasets
from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
from opus_pllm_tpu_torch.kernels import quant4
from opus_pllm_tpu_torch.train import multimodal_trainer as mmt

LR, STEPS, BATCH, MAX_LEN = 1e-3, 3, 4, 320


def _jcfg(base):
    if base == "fp32":
        c = JOpusConfig.tiny()
        return dataclasses.replace(c, llm=dataclasses.replace(c.llm,
                                                              vocab_size=260))
    llm = JDecoderConfig(family="llama", vocab_size=260, hidden_size=256,
                         intermediate_size=512, num_layers=2, num_heads=4,
                         num_kv_heads=2, head_dim=64,
                         max_position_embeddings=512, dtype="float32")
    esm = JESM2Config.tiny()
    return JOpusConfig(
        esm=esm, cstp=JCSTPConfig(protein_dim=esm.embed_dim,
                                  text_dim=llm.hidden_size,
                                  proj_dim=llm.hidden_size),
        switch=JSwitchConfig(input_dim=llm.hidden_size,
                             llm_hidden_size=llm.hidden_size),
        llm=llm, max_prompt_len=64)


def _tcfg(j):
    """The port's OpusConfig with the same fields."""
    return OpusConfig(esm=ESM2Config(**dataclasses.asdict(j.esm)),
                      cstp=CSTPConfig(**dataclasses.asdict(j.cstp)),
                      switch=SwitchProjectorConfig(
                          **dataclasses.asdict(j.switch)),
                      llm=DecoderConfig(**dataclasses.asdict(j.llm)),
                      max_prompt_len=j.max_prompt_len,
                      max_proteins_per_prompt=j.max_proteins_per_prompt)


def _records(n):
    rng = np.random.default_rng(0)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    words = ["Membrane", "Transport", "Zinc", "Kinase", "Nucleus"]
    return [{"instruction": "What are the UniProtKB keywords of this "
             "protein?", "input": "".join(rng.choice(
                 aa, int(rng.integers(30, 100)))),
             "output": "; ".join(rng.choice(words, int(rng.integers(1, 4))))}
            for _ in range(n)]


def _pow2_scales(tree):
    """Every int4 group scale replaced by the nearest power of two (module
    docstring)."""
    if isinstance(tree, dict):
        return {k: (2.0 ** np.round(np.log2(np.asarray(v)))).astype(
            np.float32) if k == "gscale" else _pow2_scales(v)
            for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pow2_scales(v) for v in tree]
    return tree


def _within(got, ref, frac):
    d = np.abs(np.asarray(got) - np.asarray(ref))
    assert d.max() <= 2 * LR * STEPS
    assert np.mean(d > 0.02 * LR) <= frac, np.mean(d > 0.02 * LR)


@pytest.mark.parametrize("base", ["fp32", "int4-v1"])
def test_fit_matches_jax_train_steps(base, tmp_path):
    path = tmp_path / "train.json"
    path.write_text(json.dumps(_records(BATCH * STEPS)))
    jcfg = _jcfg(base)
    tcfg = _tcfg(jcfg)
    jlcfg, lcfg = JLoRAConfig(rank=2, alpha=4.0), LoRAConfig(rank=2,
                                                             alpha=4.0)
    jt = JTrainConfig(learning_rate=LR, weight_decay=0.0,
                      batch_size=BATCH, log_every=1)
    tt = TrainConfig(**dataclasses.asdict(jt))

    jfrozen = jopus.init(jax.random.PRNGKey(0), jcfg)
    if base == "int4-v1":
        jfrozen["llm"] = _pow2_scales(
            jq.quantize_decoder4(jfrozen["llm"], layout="v1"))
    jstate, jtx = jmmt.create_state(jax.random.PRNGKey(1), jcfg, jt, jfrozen,
                                    train_switch=False, lora_cfg=jlcfg)
    start = jax.tree.map(np.asarray, jstate.trainable)
    step = jmmt.make_train_step(jcfg, jtx, lora_cfg=jlcfg, donate=False)
    jbatches = list(jcollate.instruction_batches(
        jdatasets.InstructionDataset(str(path)), JByteTokenizer(), BATCH,
        seed=0, max_len=MAX_LEN))
    assert len(jbatches) == STEPS
    jloss = []
    for b in jbatches:
        jstate, m = step(jstate, jfrozen, b)
        jloss.append(float(m["loss"]))

    frozen = convert.from_jax(jax.tree.map(np.asarray, jfrozen),
                              device="cpu")
    if base == "int4-v1":
        assert quant4.quant_layout_of(frozen["llm"]) == "int4-v1"
    state, tx = mmt.create_state(
        tcfg, tt, frozen, trainable=convert.trainable_from_jax(start, "cpu"),
        lora_cfg=lcfg, device="cpu")
    batches = collate.instruction_batches(
        datasets.InstructionDataset(str(path)), ByteTokenizer(), BATCH,
        seed=0, max_len=MAX_LEN)
    logs = []
    state = mmt.fit(state, tx, tcfg, tt, frozen, batches, lora_cfg=lcfg,
                    log_fn=logs.append, device="cpu")
    assert state.step == STEPS and set(state.trainable) == {"lora"}
    loss = [float(line.split("loss=")[1]) for line in logs]
    assert len(loss) == STEPS and all(np.isfinite(loss))
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=2e-4 * max(jloss))
    got = mmt.leaves(convert.trainable_to_numpy(state.trainable))
    ref = mmt.leaves(jax.tree.map(np.asarray, jstate.trainable))
    moved = mmt.leaves(start)
    assert len(got) == len(ref) == 2 * 7 * tcfg.llm.num_layers
    for g, r, s in zip(got, ref, moved):
        _within(g, r, 0.005 if base == "fp32" else 0.05)
        assert not np.array_equal(g, s)             # every leaf trained
