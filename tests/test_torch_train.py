"""Port parity: the stage-(c)/(d) training modules of opus_pllm_tpu_torch
(lora, layers.lora_dense, decoder.forward(lora=, remat=), opus losses,
train.multimodal_trainer, train.optim, data.collate / data.datasets)
against the JAX package at the tiny config, fp32 unless a test says
otherwise, inputs and LoRA B drawn by numpy from a seed (B != 0, so that
A takes a gradient).

Gradients are compared directly (`loss_fn` under jax.value_and_grad and
torch.autograd): both compute in fp32 from the same numbers, so the
tolerances are fp32 summation order. Optimizer steps are compared on
their own, against optax, on the same gradient sequence."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from opus_pllm_tpu.core.config import LoRAConfig as JLoRAConfig
from opus_pllm_tpu.core.config import OpusConfig as JOpusConfig
from opus_pllm_tpu.core.config import TrainConfig as JTrainConfig
from opus_pllm_tpu.data import collate as jcollate
from opus_pllm_tpu.data import datasets as jdatasets
from opus_pllm_tpu.infer.tokenization import ByteTokenizer as JByteTokenizer
from opus_pllm_tpu.models import decoder as jdec
from opus_pllm_tpu.models import layers as jlayers
from opus_pllm_tpu.models import opus as jopus
from opus_pllm_tpu.train import multimodal_trainer as jmmt
from opus_pllm_tpu.train import optim as joptim
from opus_pllm_tpu_torch.core import convert
from opus_pllm_tpu_torch.core.config import (IGNORE_INDEX, LoRAConfig,
                                             OpusConfig, SEQ_TOKEN_INDEX,
                                             TrainConfig)
from opus_pllm_tpu_torch.data import collate, datasets
from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
from opus_pllm_tpu_torch.lora import lora as lora_mod
from opus_pllm_tpu_torch.models import decoder, layers
from opus_pllm_tpu_torch.train import multimodal_trainer as mmt
from opus_pllm_tpu_torch.train import optim

LS = 2.0    # LoRAConfig(rank=2, alpha=4.0) scaling


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, ref, rel):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-6), (
        np.abs(got - ref).max(), np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_dense_matches_jax(dtype):
    """y = xW + s (xA)B and its gradients in x, A and B. fp32: summation
    order (1e-5 of the largest value). bf16: both packages keep the JAX
    dtype chain (A and B rounded to bf16, fp32 products, one rounding of
    y), so they differ where fp32 order moves a value across a bf16
    rounding boundary: 2^-7 of the largest value."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 48)) / 8).astype(np.float32)
    a = rng.normal(size=(64, 4)).astype(np.float32) / 8
    b = rng.normal(size=(4, 48)).astype(np.float32) / 2
    cot = rng.normal(size=(2, 5, 48)).astype(np.float32)
    jdt = getattr(jnp, dtype)

    def jloss(x, a, b):
        y = jlayers.lora_dense({"kernel": jnp.asarray(w, jdt)},
                               {"A": a, "B": b}, x.astype(jdt), LS)
        return jnp.sum(y.astype(jnp.float32) * cot), y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    tdt = getattr(torch, dtype)
    tx, ta, tb = (_t(v).requires_grad_(True) for v in (x, a, b))
    ty = layers.lora_dense({"kernel": _t(w).to(tdt)}, {"A": ta, "B": tb},
                           tx.to(tdt), LS)
    assert ty.dtype == tdt
    tg = torch.autograd.grad((ty.float() * _t(cot)).sum(), (tx, ta, tb))
    rel = 1e-5 if dtype == "float32" else 2 ** -7
    _close(ty.float().detach().numpy(), np.asarray(jy.astype(jnp.float32)),
           rel)
    for got, ref in zip(tg, jg):
        _close(got.numpy(), ref, rel)
    assert lora_mod.scaling(LoRAConfig(rank=2, alpha=4.0)) == LS


def _cfgs():
    return JOpusConfig.tiny(), OpusConfig.tiny()


def _lora_np(cfg_llm, seed):
    """A LoRA tree for every projection with A and B drawn by numpy."""
    rng = np.random.default_rng(seed)
    dims = lora_mod._proj_dims(cfg_llm)
    return {"layers": [{t: {"A": (rng.normal(size=(din, 2)) / 8).astype(
        np.float32), "B": (rng.normal(size=(2, dout)) / 8).astype(
        np.float32)} for t, (din, dout) in dims.items()}
        for _ in range(cfg_llm.num_layers)]}


def test_decoder_forward_with_lora_and_remat_matches_jax():
    jcfg, tcfg = _cfgs()
    jp = jdec.init(jax.random.PRNGKey(0), jcfg.llm)
    tp = convert.decoder_from_jax(_np(jp), device="cpu")
    lora = _lora_np(tcfg.llm, 1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    pos = np.tile(np.arange(7, dtype=np.int32), (2, 1))
    mask = np.tril(np.ones((7, 7), bool))[None, None].repeat(2, 0)
    ref, _ = jdec.forward(jp, jcfg.llm, jnp.asarray(x), jnp.asarray(pos),
                          jnp.asarray(mask), lora=jax.tree.map(jnp.asarray,
                                                               lora),
                          lora_scale=LS, remat=True)
    tl = convert.lora_from_jax(lora, device="cpu")
    got = {}
    for remat in (False, True):
        got[remat], _ = decoder.forward(tp, tcfg.llm, _t(x), _t(pos),
                                        _t(mask), lora=tl, lora_scale=LS,
                                        remat=remat)
    _close(got[True].numpy(), np.asarray(ref), 1e-5)
    torch.testing.assert_close(got[True], got[False], rtol=0, atol=0)


def _batch(cfg, b=4, l=12, seed=0):
    """Random prompts with one <seq> sentinel; labels IGNORE over the
    first 4 tokens; rows right-padded by different amounts, so the chunks
    of grad_accum see different valid counts."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, cfg.llm.vocab_size, (b, l)).astype(np.int32)
    ids[:, 1] = SEQ_TOKEN_INDEX
    attn = np.ones((b, l), bool)
    for r in range(1, b):
        attn[r, l - 2 * r:] = False
    labels = np.where(attn, ids, IGNORE_INDEX).astype(np.int32)
    labels[:, :4] = IGNORE_INDEX
    esm = rng.integers(4, 24, (b, 1, 8)).astype(np.int32)
    esm[:, :, 0] = 0
    esm[:, :, -1] = 2
    return {"input_ids": ids, "attn_mask": attn, "labels": labels,
            "esm_tokens": esm}


def _setup(kind):
    """JAX and port frozen trees and one trainable tree for `kind`
    (switch only, LoRA only, both) with LoRA B drawn nonzero."""
    jcfg, tcfg = _cfgs()
    jfrozen = jopus.init(jax.random.PRNGKey(0), jcfg)
    lcfg = (JLoRAConfig(rank=2, alpha=4.0), LoRAConfig(rank=2, alpha=4.0))
    jtrain = _np(jmmt.init_trainable(
        jax.random.PRNGKey(1), jcfg, train_switch=kind != "lora",
        lora_cfg=lcfg[0] if kind != "switch" else None,
        frozen_params=jfrozen))
    if "lora" in jtrain:
        jtrain["lora"] = _lora_np(tcfg.llm, 3)
    tfrozen = convert.from_jax(_np(jfrozen), device="cpu")
    ttrain = convert.trainable_from_jax(jtrain, device="cpu")
    for p in mmt.leaves(ttrain):
        p.requires_grad_(True)
    return jcfg, tcfg, jfrozen, tfrozen, jtrain, ttrain, lcfg


def _port_grads(ttrain, tfrozen, tcfg, batch, **kw):
    loss, metrics = mmt.loss_fn(ttrain, tfrozen, tcfg, batch, LS, **kw)
    return loss, metrics, torch.autograd.grad(loss, mmt.leaves(ttrain))


@pytest.mark.parametrize("kind", ["switch", "lora", "both"])
def test_loss_fn_value_and_grads_match_jax(kind):
    """`loss_fn`'s loss and its gradients in every trainable leaf equal
    jax.value_and_grad of the JAX `loss_fn` (remat on), fp32: loss 1e-5
    relative, each gradient leaf 1e-4 of its largest entry."""
    jcfg, tcfg, jfrozen, tfrozen, jtrain, ttrain, _ = _setup(kind)
    batch = _batch(tcfg)
    (jl, jm), jg = jax.value_and_grad(jmmt.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, jtrain), jfrozen, jcfg,
        {k: jnp.asarray(v) for k, v in batch.items()}, LS, True, 0)
    tb = {k: _t(v) for k, v in batch.items()}
    loss, metrics, grads = _port_grads(ttrain, tfrozen, tcfg, tb)
    assert int(metrics["valid"]) == int(jm["valid"])
    _close(loss.item(), float(jl), 1e-5)
    jleaves = mmt.leaves(_np(jg))
    assert len(jleaves) == len(grads)
    for got, ref in zip(grads, jleaves):
        _close(got.numpy(), ref, 1e-4)


def test_ce_chunk_and_remat_give_the_same_loss_and_grads():
    """ce_chunk=5 (the chunked head + CE under checkpoint) equals the full
    loss (fp32 order, 1e-6 / 1e-5); remat on and off are the same
    computation, bit for bit."""
    _, tcfg, _, tfrozen, _, ttrain, _ = _setup("both")
    tb = {k: _t(v) for k, v in _batch(tcfg, seed=1).items()}
    full = _port_grads(ttrain, tfrozen, tcfg, tb, remat=True)
    chunked = _port_grads(ttrain, tfrozen, tcfg, tb, remat=True, ce_chunk=5)
    plain = _port_grads(ttrain, tfrozen, tcfg, tb, remat=False)
    _close(chunked[0].item(), full[0].item(), 1e-6)
    for a, b in zip(chunked[2], full[2]):
        _close(a.numpy(), b.numpy(), 1e-5)
    torch.testing.assert_close(plain[0], full[0], rtol=0, atol=0)
    for a, b in zip(plain[2], full[2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


class _CountDots(TorchDispatchMode):
    """Counts the matrix products that reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in decoder._DOT_OPS
        return func(*args, **(kwargs or {}))


def test_remat_dots_gives_the_grads_of_full_and_none():
    """remat="dots" (the checkpoint_dots policy: matmul outputs saved,
    the rest recomputed) is the same computation as remat on and off: the
    same loss and LoRA / switch gradients, bit for bit."""
    _, tcfg, _, tfrozen, _, ttrain, _ = _setup("both")
    tb = {k: _t(v) for k, v in _batch(tcfg, seed=3).items()}
    dots = _port_grads(ttrain, tfrozen, tcfg, tb, remat="dots")
    for remat in (True, False):
        ref = _port_grads(ttrain, tfrozen, tcfg, tb, remat=remat)
        torch.testing.assert_close(dots[0], ref[0], rtol=0, atol=0)
        for a, b in zip(dots[2], ref[2]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_remat_dots_recomputes_no_matmul():
    """In the backward, remat="full" recomputes each layer's forward
    products and "dots" none of them: dots runs exactly the products of
    the backward with no remat, full runs more."""
    _, tcfg, _, tfrozen, _, ttrain, _ = _setup("both")
    tb = {k: _t(v) for k, v in _batch(tcfg, seed=4).items()}
    counts = {}
    for remat in (False, True, "dots"):
        loss, _ = mmt.loss_fn(ttrain, tfrozen, tcfg, tb, LS, remat=remat)
        with _CountDots() as mode:
            torch.autograd.grad(loss, mmt.leaves(ttrain))
        counts[remat] = mode.n
    assert counts["dots"] == counts[False] > 0
    assert counts[True] > counts["dots"]


def test_remat_dots_grads_match_jax():
    """`loss_fn` under remat="dots" against jax.value_and_grad of the JAX
    `loss_fn` with its checkpoint_dots policy, fp32: loss 1e-5 relative,
    each gradient leaf 1e-4 of its largest entry."""
    jcfg, tcfg, jfrozen, tfrozen, jtrain, ttrain, _ = _setup("both")
    batch = _batch(tcfg, seed=5)
    (jl, _), jg = jax.value_and_grad(jmmt.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, jtrain), jfrozen, jcfg,
        {k: jnp.asarray(v) for k, v in batch.items()}, LS, "dots", 0)
    tb = {k: _t(v) for k, v in batch.items()}
    loss, _, grads = _port_grads(ttrain, tfrozen, tcfg, tb, remat="dots")
    _close(loss.item(), float(jl), 1e-5)
    jleaves = mmt.leaves(_np(jg))
    assert len(jleaves) == len(grads)
    for got, ref in zip(grads, jleaves):
        _close(got.numpy(), ref, 1e-4)


def test_grad_accum_equals_one_big_batch():
    """grad_accum=2 (two micro-chunks with different valid-token counts)
    hands the optimizer the gradients of the one-big-batch step (fp32
    order: 1e-5 of each leaf's largest entry)."""
    _, tcfg, _, tfrozen, _, ttrain, lcfg = _setup("both")
    batch = {k: _t(v) for k, v in _batch(tcfg, seed=2).items()}
    seen = {}
    for accum in (1, 2):
        state, tx = mmt.create_state(tcfg, TrainConfig(learning_rate=1e-3),
                                     tfrozen, trainable=ttrain,
                                     lora_cfg=lcfg[1], device="cpu")
        step_fn = tx.step
        tx.step = lambda: (seen.__setitem__(accum, [
            p.grad.clone() for p in tx.params]), step_fn())
        step = mmt.make_train_step(tcfg, tx, lora_cfg=lcfg[1],
                                   grad_accum=accum)
        state, metrics = step(state, tfrozen, batch)
        assert state.step == 1
    assert len(seen[1]) == len(seen[2])
    for a, b in zip(seen[2], seen[1]):
        _close(a.numpy(), b.numpy(), 1e-5)


@pytest.mark.parametrize("warmup,clip,wd,lr", [(2, 1.0, 0.01, 0.1),
                                               (0, 0.0, 0.0, 2e-5)])
def test_adamw_matches_optax(warmup, clip, wd, lr):
    """Three updates on the same gradient sequence: the port's AdamW with
    the warmup-cosine schedule and the global-norm clip (both triggering
    in the first case; the second is train-lora's defaults) equals
    optax's chain: fp32 order in the moments, the clip and the update, up
    to 2e-5 of an lr-sized step."""
    rng = np.random.default_rng(4)
    p0 = [rng.normal(size=(3, 4)).astype(np.float32),
          rng.normal(size=(5,)).astype(np.float32)]
    gs = [[3 * rng.normal(size=p.shape).astype(np.float32) for p in p0]
          for _ in range(3)]
    jcfg = JTrainConfig(learning_rate=lr, weight_decay=wd,
                        warmup_steps=warmup, grad_clip_norm=clip)
    tx = joptim.adamw(jcfg, 5)
    jp = [jnp.asarray(p) for p in p0]
    st = tx.init(jp)
    tp = [_t(p) for p in p0]
    opt = optim.adamw(TrainConfig(**dataclasses.asdict(jcfg)), 5, tp)
    for g in gs:
        upd, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = _t(x)
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=2e-5 * lr + 1e-7)
    assert opt.count == 3


def _records(n, seed):
    rng = np.random.default_rng(seed)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    return [{"instruction": "What are the UniProtKB keywords of this "
             "protein?", "input": "".join(rng.choice(
                 aa, int(rng.integers(20, 90)))),
             "output": " ".join(["Membrane", "Transport", "Zinc"][
                 :int(rng.integers(1, 4))])} for _ in range(n)]


def test_collate_and_batches_match_jax(tmp_path):
    """The collated arrays (prompt, <seq> sentinel, labels, ESM tokens,
    truncation at max_len, padding buckets) and the shuffled batch order
    equal the JAX package's."""
    recs = _records(7, 5)
    recs.append({"instruction": "x", "input": "", "output": "dropped"})
    path = tmp_path / "train.json"
    path.write_text(json.dumps(recs))
    for kw in ({}, {"max_len": 260}):
        ex = [{"instruction": r["instruction"], "sequence": r["input"],
               "output": r["output"]} for r in recs[:3]]
        ref = jcollate.collate_instruction_batch(ex, JByteTokenizer(), **kw)
        got = collate.collate_instruction_batch(ex, ByteTokenizer(), **kw)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
            assert got[k].dtype == ref[k].dtype
    for shuffle, drop in ((True, True), (False, False)):
        ref = list(jdatasets.batch_iterator(7, 3, shuffle=shuffle, seed=3,
                                            drop_remainder=drop, epochs=2))
        got = list(datasets.batch_iterator(7, 3, shuffle=shuffle, seed=3,
                                           drop_remainder=drop, epochs=2))
        assert [list(a) for a in got] == [list(a) for a in ref]
    jds, ds = jdatasets.InstructionDataset(str(path)), \
        datasets.InstructionDataset(str(path))
    assert len(ds) == len(jds) == 7
    ref = list(jcollate.instruction_batches(jds, JByteTokenizer(), 3, seed=1))
    got = list(collate.instruction_batches(ds, ByteTokenizer(), 3, seed=1))
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_unported_trainer_options_raise():
    """The mesh is refused with NotImplementedError naming its ROADMAP
    item, before any step runs; the prefetch thread runs (an empty stream
    ends at once). (Checkpointing is ported:
    tests/test_torch_checkpoint.py; prefetch: tests/test_torch_loaders.py.)
    """
    _, tcfg, _, tfrozen, _, ttrain, lcfg = _setup("lora")
    state, tx = mmt.create_state(tcfg, TrainConfig(), tfrozen,
                                 trainable=ttrain, lora_cfg=lcfg[1],
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        mmt.fit(state, tx, tcfg, TrainConfig(), tfrozen, [],
                lora_cfg=lcfg[1], device="cpu", mesh=object())
    mmt.fit(state, tx, tcfg, TrainConfig(), tfrozen, [], lora_cfg=lcfg[1],
            device="cpu", prefetch=2)
    assert state.step == 0


def test_lora_init_merge_and_num_params_match_jax():
    """Fresh adapters: A in U(-1/sqrt(in), 1/sqrt(in)) fp32, B zero, the
    JAX tree's shapes and parameter count; `merge` folds the same numbers
    into the same kernels as the JAX `merge` (fp32 product, one rounding:
    fp32 order, 1e-6 of the largest weight)."""
    from opus_pllm_tpu.lora import lora as jlora
    jcfg, tcfg = _cfgs()
    lcfg = (JLoRAConfig(rank=2, alpha=4.0), LoRAConfig(rank=2, alpha=4.0))
    fresh = lora_mod.init(tcfg.llm, lcfg[1],
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    ref = jlora.init(jax.random.PRNGKey(0), jcfg.llm, lcfg[0])
    assert lora_mod.num_params(fresh) == jlora.num_params(ref)
    dims = lora_mod._proj_dims(tcfg.llm)
    for lp, jp in zip(fresh["layers"], ref["layers"]):
        assert set(lp) == set(jp) == set(dims)
        for t, ab in lp.items():
            assert ab["A"].shape == jp[t]["A"].shape
            assert ab["A"].dtype == ab["B"].dtype == torch.float32
            assert ab["A"].abs().max() <= dims[t][0] ** -0.5
            assert not ab["B"].any()
    jparams = jdec.init(jax.random.PRNGKey(1), jcfg.llm)
    lora = _lora_np(tcfg.llm, 4)
    want = _np(jlora.merge(jparams, jax.tree.map(jnp.asarray, lora),
                           lcfg[0]))
    got = lora_mod.merge(convert.decoder_from_jax(_np(jparams), device="cpu"),
                         convert.lora_from_jax(lora, device="cpu"), lcfg[1])
    for lg, lw in zip(got["layers"], want["layers"]):
        for t in dims:
            _close(lg[t]["kernel"].numpy(), lw[t]["kernel"], 1e-6)


def test_pooled_emb_eval_step_and_validation_match_jax():
    """A batch with precomputed pooled embeddings (no ESM tower) through
    `make_eval_step` gives the JAX eval step's loss and valid count (fp32:
    1e-5), and `fit`'s validation logs the token-weighted mean loss over
    the held-out batches."""
    jcfg, tcfg, jfrozen, tfrozen, jtrain, ttrain, lcfg = _setup("both")
    batches = []
    for seed in (5, 6):
        b = _batch(tcfg, seed=seed)
        del b["esm_tokens"]
        b["pooled_emb"] = np.random.default_rng(seed).normal(
            size=(4, 1, tcfg.esm.embed_dim)).astype(np.float32)
        batches.append(b)
    jstep = jmmt.make_eval_step(jcfg, lora_cfg=lcfg[0])
    step = mmt.make_eval_step(tcfg, lora_cfg=lcfg[1])
    tot = cnt = 0.0
    for b in batches:
        ref = jstep(jax.tree.map(jnp.asarray, jtrain), jfrozen,
                    {k: jnp.asarray(v) for k, v in b.items()})
        got = step(ttrain, tfrozen, {k: _t(v) for k, v in b.items()})
        assert int(got["valid"]) == int(ref["valid"])
        _close(float(got["loss"]), float(ref["loss"]), 1e-5)
        tot += float(ref["loss"]) * int(ref["valid"])
        cnt += int(ref["valid"])
    state, tx = mmt.create_state(tcfg, TrainConfig(), tfrozen,
                                 trainable=ttrain, lora_cfg=lcfg[1],
                                 device="cpu")
    logs = []
    mmt.fit(state, tx, tcfg, TrainConfig(), tfrozen, [], lora_cfg=lcfg[1],
            log_fn=logs.append, val_batches_fn=lambda: batches,
            device="cpu")
    assert len(logs) == 1 and f"({int(cnt)} held-out tokens)" in logs[0]
    _close(float(logs[0].split("val_loss=")[1].split()[0]), tot / cnt, 1e-4)
