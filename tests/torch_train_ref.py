"""The JAX side of the port's sequence- and pipeline-parallel training
tests (test_torch_sp_train.py, test_torch_pp_train.py): the trees and
batches, two steps of a JAX train step whose optimizer keeps each
gradient it is given, and the bounds the ranks' results are held to
(those of tests/test_torch_train_mesh.py).

JAX's sequence-parallel step hands its optimizer n times the
single-device gradient (n the shard count), and its pipeline step P
times the switch's (P the stage count; the LoRA gradient is the
single-device one): each device seeds the psum'd loss. Under Adam, and
under a clip that binds when the scale is uniform, the updates do not
see it; the port's gradients are the single-device ones (ROADMAP.md §3
holds the difference)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax

from opus_pllm_tpu.core.config import IGNORE_INDEX, SEQ_TOKEN_INDEX
from opus_pllm_tpu.core.config import LoRAConfig as JLoRAConfig
from opus_pllm_tpu.core.config import TrainConfig as JTrainConfig
from opus_pllm_tpu.models import opus as jopus
from opus_pllm_tpu.train import multimodal_trainer as jmmt
from opus_pllm_tpu.train import optim as joptim
from opus_pllm_tpu_torch.train import multimodal_trainer as mmt

LR, CLIP = 1e-3, 0.05
STEPS = 2
TCFG = dict(learning_rate=LR, grad_clip_norm=CLIP, log_every=0)
LORA = dict(rank=2, alpha=4.0)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def batch(cfg, b=8, l=12, seed=0):
    """Random prompts with a <seq> sentinel, right-padded by different
    amounts (so shards, replicas and accumulation chunks hold different
    valid counts), the first 4 labels ignored."""
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
def _trees(jcfg, lora):
    return _draw(jcfg, lora)


def trees(jcfg, lora=True):
    """(frozen, trainable) numpy trees: the switch trained, and LoRA on
    every projection with B != 0 (so A takes gradient) when `lora`; drawn
    once a process for each config (the caller gets its own top-level
    dicts)."""
    frozen, trainable = _trees(jcfg, lora)
    return dict(frozen), dict(trainable)


def _draw(jcfg, lora):
    frozen = jax.jit(jopus.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                   jcfg)
    trainable = np_tree(jax.jit(
        lambda key, f: jmmt.init_trainable(
            key, jcfg, train_switch=True,
            lora_cfg=JLoRAConfig(**LORA) if lora else None,
            frozen_params=f))(jax.random.PRNGKey(1), frozen))
    rng = np.random.default_rng(3)
    for la in trainable.get("lora", {"layers": []})["layers"]:
        for ab in la.values():
            ab["B"] = (rng.normal(size=ab["B"].shape) / 8).astype(np.float32)
    return np_tree(frozen), trainable


def _keep_grads():
    """An optax transformation passing the gradient on unchanged and
    keeping it as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


def jax_steps(make_step, jcfg, frozen, trainable, batches):
    """STEPS steps of `make_step(tx)` (a JAX train step over MMTrainState)
    from `trainable` -> (each step's (loss, gradient as AdamW takes it:
    through optax's clip, the gradient before the clip), the post-step
    trainable tree). The clip binds at every step. (The clip is redone in
    numpy, fp64 norm: eager JAX ops each cost a compile.)"""
    tx = optax.chain(_keep_grads(), joptim.adamw(JTrainConfig(**TCFG)))
    step = make_step(tx)
    t = jax.tree.map(jnp.asarray, trainable)
    state = jmmt.MMTrainState(t, jax.jit(tx.init)(t),
                              jnp.zeros((), jnp.int32))
    steps = []
    for b in batches:
        state, m = step(state, frozen, b)
        g = np_tree(state.opt_state[0])
        norm = float(np.sqrt(sum((x.astype(np.float64) ** 2).sum()
                                 for x in jax.tree.leaves(g))))
        assert norm > 2 * CLIP
        clipped = jax.tree.map(lambda x: x * np.float32(CLIP / norm), g)
        steps.append((float(m["loss"]), clipped, g))
    return steps, np_tree(state.trainable)


def single_steps(jcfg, frozen, trainable, batches, lora=True):
    """`jax_steps` of the JAX single-device step (multimodal_trainer's),
    which JAX's sequence- and pipeline-parallel steps equal by their
    contract: the same for every mesh, chunking and accumulation."""
    return jax_steps(
        lambda tx: jmmt.make_train_step(
            jcfg, tx, lora_cfg=JLoRAConfig(**LORA) if lora else None,
            donate=False), jcfg, frozen, trainable, batches)


def raw_times(got_step, single_step, jax_step, times):
    """Step 1's gradient before the clip (the port's, from what AdamW took
    and the single-device clip factor) times `times` {subtree: factor}
    against the JAX parallel step's, within 1e-4 of each leaf's largest
    entry."""
    clip = CLIP / float(np.sqrt(sum(
        (x.astype(np.float64) ** 2).sum()
        for x in jax.tree.leaves(single_step[2]))))
    for name, k in times.items():
        if name in got_step:
            for i, (x, y) in enumerate(zip(mmt.leaves(got_step[name]),
                                           mmt.leaves(jax_step[2][name]))):
                close(x / clip * k, y, 1e-4, (name, i))


def close(got, ref, rel, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-6), (what, err)


def check(outs, n, losses, ref, after, batches):
    """The n ranks' (steps, final trainable) against JAX: each step's loss
    within 1e-5 relative of `losses` and its valid count, every gradient
    AdamW took within 1e-4 of the leaf's largest entry of `ref`'s (steps
    as `jax_steps` gives them), the parameters after STEPS steps within 2
    lr x steps of `after`, 99% within 1e-6; the ranks beyond n are off
    the mesh (None)."""
    assert all(o is None for o in outs[n:])
    ref_p = mmt.leaves(after)
    for rank, (got_steps, got_p) in enumerate(outs[:n]):
        assert len(got_steps) == STEPS
        for s, ((loss, valid, got_g), want, (_, grads, _), b) in enumerate(
                zip(got_steps, losses, ref, batches)):
            np.testing.assert_allclose(loss, want, rtol=1e-5)
            assert valid == int(((b["labels"][:, 1:] != IGNORE_INDEX)
                                 & b["attn_mask"][:, 1:]).sum())
            for i, (x, y) in enumerate(zip(mmt.leaves(got_g),
                                           mmt.leaves(grads))):
                close(x, y, 1e-4, (rank, s, "grad", i))
        for x, y in zip(mmt.leaves(got_p), ref_p):
            d = np.abs(x - y)
            assert d.max() <= 2 * LR * STEPS and (d <= 1e-6).mean() >= 0.99


def cfg_dicts(jcfg):
    return dataclasses.asdict(jcfg)
