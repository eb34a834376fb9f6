"""Port parity for stage (a): opus_pllm_tpu_torch.bridge.losses, .cstp,
.adapters and train.cstp_trainer against the JAX package, tiny configs.

Tolerances:
  * losses: rtol / atol 5e-4 for the evidential ones (torch's digamma and
    lgamma against JAX's, as tests/test_losses.py budgets), 1e-5 for the
    InfoNCE ones (log-softmax only);
  * CSTP projections, similarities and adapters: rtol 1e-5 / atol 1e-5
    (fp32 op order);
  * the trainer, 3 steps from the same weights: metrics within 5e-4 of
    the JAX step's, parameters within 2 x lr x steps everywhere (Adam's
    first update is lr * sign(g): an entry whose gradient is near zero may
    move the other way, ROADMAP.md §3) and 99% of entries within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opus_pllm_tpu.bridge import adapters as jad
from opus_pllm_tpu.bridge import cstp as jcstp
from opus_pllm_tpu.bridge import losses as jlosses
from opus_pllm_tpu.core.config import CSTPConfig as JCSTPConfig
from opus_pllm_tpu.core.config import TrainConfig as JTrainConfig
from opus_pllm_tpu.train import cstp_trainer as jct
from opus_pllm_tpu_torch.bridge import adapters, cstp, losses
from opus_pllm_tpu_torch.core import checkpoint, convert
from opus_pllm_tpu_torch.core.config import CSTPConfig, TrainConfig
from opus_pllm_tpu_torch.train import cstp_trainer as ct

EVID = dict(rtol=5e-4, atol=5e-4)
TIGHT = dict(rtol=1e-5, atol=1e-5)
B = 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _logits(seed, scale=3.0, b=B):
    return (np.random.default_rng(seed).normal(size=(b, b)) * scale
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("global_step", [0, 100, 1000])
def test_evidential_losses_match_jax(global_step):
    """The three evidential variants (EVIDENTIAL_LOSSES) before, inside and
    after the KL annealing, with W and c from the batch and given."""
    lg, tg = _logits(0), np.arange(B)
    assert set(losses.EVIDENTIAL_LOSSES) == set(jlosses.EVIDENTIAL_LOSSES)
    for name, fn in losses.EVIDENTIAL_LOSSES.items():
        jfn = jlosses.EVIDENTIAL_LOSSES[name]
        for kw in ({}, {"w": 16.0, "num_classes": B}):
            ref = float(jfn(jnp.asarray(lg), jnp.asarray(tg),
                            global_step=global_step, **kw))
            got = fn(_t(lg), _t(tg), global_step=global_step, **kw)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.item(), ref, **EVID)


def test_dirichlet_kl_and_info_nce_match_jax():
    alpha = np.random.default_rng(1).uniform(0.5, 30.0, (B, B)).astype(
        np.float32)
    np.testing.assert_allclose(
        losses.dirichlet_kl(_t(alpha)).numpy(),
        np.asarray(jlosses.dirichlet_kl(jnp.asarray(alpha))), **EVID)
    p2t, t2p, tg = _logits(2), _logits(3), np.arange(B)
    np.testing.assert_allclose(
        losses.info_nce(_t(p2t), _t(tg), 0.07).item(),
        float(jlosses.info_nce(jnp.asarray(p2t), jnp.asarray(tg), 0.07)),
        **TIGHT)
    np.testing.assert_allclose(
        losses.info_nce_sym(_t(p2t), _t(t2p), _t(tg)).item(),
        float(jlosses.info_nce_sym(jnp.asarray(p2t), jnp.asarray(t2p),
                                   jnp.asarray(tg))), **TIGHT)


def test_trust_evidence_big_logits_and_dead_evidence():
    """At T = 0.0007 similarities in [-1, 1] scale to |x| ~ 1400: the loss
    stays finite and matches JAX; evidence_is_dead is false there and true
    once every similarity is below -15 T (elu + 1 evidence ~ 0)."""
    cfg, jcfg = CSTPConfig(), JCSTPConfig()
    sims = np.random.default_rng(4).uniform(-1, 1, (B, B)).astype(np.float32)
    tg = np.arange(B)
    got = losses.trust_evidence(_t(sims), _t(sims.T), _t(tg), cfg)
    ref = jlosses.trust_evidence(jnp.asarray(sims), jnp.asarray(sims.T),
                                 jnp.asarray(tg), jcfg)
    assert np.isfinite(got.item())
    np.testing.assert_allclose(got.item(), float(ref), **EVID)
    for s in (sims, -0.5 - np.abs(sims)):
        dead = losses.evidence_is_dead(_t(s), _t(s.T), cfg)
        assert dead.dim() == 0 and dead.dtype == torch.bool
        assert bool(dead) == bool(jlosses.evidence_is_dead(
            jnp.asarray(s), jnp.asarray(s.T), jcfg))
    assert not bool(losses.evidence_is_dead(_t(sims), _t(sims.T), cfg))
    assert bool(losses.evidence_is_dead(_t(-0.5 - np.abs(sims)),
                                        _t(-0.5 - np.abs(sims.T)), cfg))


def _trust_evidence_fp64(p2t, t2p, cfg):
    """trust_evidence written out in fp64 on the same logits: (loss, bound
    on an fp32 evaluation's rounding error). The bound is 8 x 2^-24 times
    the summed magnitudes of the lgamma / digamma terms that the
    evidential CE and the Dirichlet KL add and subtract, plus the evidence
    (the rounding of logits / T), meaned as the loss is (chip_smoke.py's
    evidential_fp64 holds the card's reading to the same bound)."""
    import math
    coef = min(cfg.kl_coefficient, (cfg.evidence_global_step
                                    - cfg.kl_threshold_step + 1)
               / cfg.kl_annealing_steps)

    def direction(logits):
        x = torch.from_numpy(logits).double() / cfg.temperature
        c = x.shape[-1]
        alpha = torch.nn.functional.elu(x) + 2.0          # W / c = 1
        s, eye = alpha.sum(-1), torch.eye(c, dtype=torch.float64)
        a_t = (alpha * eye).sum(-1)
        alp = (alpha - 1.0) * (1.0 - eye) + 1.0
        s2, lg = alp.sum(-1), torch.lgamma(alp)
        kl = (torch.lgamma(s2) - lg.sum(-1) - math.lgamma(c)
              + ((alp - 1.0) * (torch.digamma(alp)
                                - torch.digamma(s2)[:, None])).sum(-1))
        mag = (torch.digamma(s).abs() + torch.digamma(a_t).abs()
               + coef * (torch.lgamma(s2).abs() + lg.abs().sum(-1)
                         + math.lgamma(c)
                         + ((alp - 1.0).abs()
                            * (torch.digamma(alp).abs()
                               + torch.digamma(s2).abs()[:, None])).sum(-1))
               + 2.0 * alpha.sum(-1))
        loss = torch.digamma(s) - torch.digamma(a_t) + coef * kl
        return loss.mean().item(), mag.mean().item()

    (lp, mp), (lt, mt) = direction(p2t), direction(t2p)
    return 0.5 * (lp + lt), 8.0 * 2.0 ** -24 * 0.5 * (mp + mt)


@pytest.mark.parametrize("regime", ["alpha~1e5", "chip"])
def test_trust_evidence_fp32_rounding_at_huge_alpha(regime):
    """Where every similarity is large and positive, as after stage (a)'s
    InfoNCE warm-up step (chip_smoke.py's similarities / T lay in
    [1.05e7, 4.04e7] on an H100, where the port's fp32 loss read -147.1
    and an fp64 reading of the same logits +1051.6), the Dirichlet KL
    adds and subtracts lgamma / digamma terms of up to 1e11, so fp32
    keeps no digit of the loss (which is >= 0). The JAX function is written the
    same way: the port's and the JAX readings each lie within fp32's
    rounding bound of the fp64 reading; the fp64 reading is >= 0. Batch
    128, the train-cstp batch. Run with -s to see the readings."""
    cfg, jcfg = CSTPConfig(), JCSTPConfig()
    rng = np.random.default_rng(7)
    if regime == "alpha~1e5":      # similarities ~70: alpha ~ 70 / T
        sims = 70.0 * (1.0 + 0.01 * rng.standard_normal((128, 128)))
    else:                          # the card's range of similarities / T
        sims = rng.uniform(1.053e7, 4.036e7, (128, 128)) * cfg.temperature
    sims = sims.astype(np.float32)
    tg = np.arange(128)
    got = losses.trust_evidence(_t(sims), _t(sims.T), _t(tg), cfg).item()
    ref = float(jlosses.trust_evidence(jnp.asarray(sims),
                                       jnp.asarray(sims.T),
                                       jnp.asarray(tg), jcfg))
    f64, bound = _trust_evidence_fp64(sims, sims.T, cfg)
    print(f"{regime}: port fp32 {got:.6g}, JAX fp32 {ref:.6g}, fp64 "
          f"{f64:.6g}, fp32 bound {bound:.4g}")
    assert f64 >= 0.0
    assert abs(got - f64) <= bound and abs(ref - f64) <= bound


# ---------------------------------------------------------------------------
# cstp and the adapters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cstp_params():
    jp = jcstp.init(jax.random.PRNGKey(0), JCSTPConfig.tiny())
    return jp, convert.cstp_from_jax(_np(jp), device="cpu")


def test_cstp_forward_alignment_accuracy(cstp_params):
    jp, tp = cstp_params
    rng = np.random.default_rng(5)
    se = rng.normal(size=(B, 64)).astype(np.float32)
    te = rng.normal(size=(B, 96)).astype(np.float32)
    jpp, jtt = jcstp.forward(jp, jnp.asarray(se), jnp.asarray(te))
    p, t = cstp.forward(tp, _t(se), _t(te))
    np.testing.assert_allclose(p.numpy(), np.asarray(jpp), **TIGHT)
    np.testing.assert_allclose(t.numpy(), np.asarray(jtt), **TIGHT)
    np.testing.assert_allclose(cstp.text_forward(tp, _t(te)).numpy(),
                               np.asarray(jtt), **TIGHT)
    np.testing.assert_allclose(cstp.protein_forward(tp, _t(se)).numpy(),
                               np.asarray(jpp), **TIGHT)
    jal, al = jcstp.alignment(jpp, jtt), cstp.alignment(p, t)
    for k in ("protein2text", "text2protein", "targets"):
        np.testing.assert_allclose(al[k].numpy(), np.asarray(jal[k]),
                                   **TIGHT)
    for k in ("protein2text", "text2protein"):
        acc = cstp.retrieval_accuracy(al[k], al["targets"])
        assert acc.dim() == 0 and 0.0 <= acc.item() <= 1.0
        assert acc.item() == float(jcstp.retrieval_accuracy(
            jal[k], jal["targets"]))


def test_adapters_match_jax():
    """Cross attention over pooled vectors in a 2-layer encoder stack, the
    residual text projection and the ReLU adapter without dropout, on the
    JAX parameters."""
    d, rng = 64, np.random.default_rng(6)
    seq = rng.normal(size=(3, d)).astype(np.float32)
    txt = rng.normal(size=(3, d)).astype(np.float32)
    js = jad.adapter_stack_init(jax.random.PRNGKey(1), d, n_layers=2)
    ts = convert.cstp_from_jax(_np(js), device="cpu")
    np.testing.assert_allclose(
        adapters.adapter_stack(ts, _t(seq), _t(txt), num_heads=4).numpy(),
        np.asarray(jad.adapter_stack(js, jnp.asarray(seq), jnp.asarray(txt),
                                     num_heads=4)), **TIGHT)
    jr = jad.residual_text_projection_init(jax.random.PRNGKey(2), d, 32)
    np.testing.assert_allclose(
        adapters.residual_text_projection(
            convert.cstp_from_jax(_np(jr), device="cpu"), _t(txt),
            alpha=0.7).numpy(),
        np.asarray(jad.residual_text_projection(jr, jnp.asarray(txt),
                                                alpha=0.7)), **TIGHT)
    ja = jad.relu_adapter_init(jax.random.PRNGKey(3), d, 48)
    np.testing.assert_allclose(
        adapters.relu_adapter(convert.cstp_from_jax(_np(ja), device="cpu"),
                              _t(seq)).numpy(),
        np.asarray(jad.relu_adapter(ja, jnp.asarray(seq))), **TIGHT)
    # the init functions draw the JAX trees' structure and shapes
    g = torch.Generator().manual_seed(0)
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(adapters.adapter_stack_init(d, 2, generator=g,
                                              device="cpu")) == shapes(js)
    assert shapes(adapters.residual_text_projection_init(
        d, 32, generator=g, device="cpu")) == shapes(jr)
    assert shapes(adapters.relu_adapter_init(d, 48, generator=g,
                                             device="cpu")) == shapes(ja)


def test_relu_adapter_dropout_keep_rate_and_scale():
    """With a generator, each entry is kept with probability 1 - rate and
    scaled by 1 / (1 - rate); the same generator seed gives the same mask."""
    g = torch.Generator().manual_seed(0)
    p = adapters.relu_adapter_init(32, 256, generator=g, device="cpu")
    x = torch.randn(64, 32, generator=g)
    plain = adapters.relu_adapter(p, x)
    rate = 0.25
    out = adapters.relu_adapter(p, x, dropout_rate=rate,
                                generator=torch.Generator().manual_seed(1))
    live = plain > 0
    kept = out[live] != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.02
    torch.testing.assert_close(out[live][kept],
                               plain[live][kept] / (1 - rate))
    again = adapters.relu_adapter(p, x, dropout_rate=rate,
                                  generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(out, again, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _batches(n, seed=0, b=B):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, 64)).astype(np.float32),
             rng.standard_normal((b, 96)).astype(np.float32))
            for _ in range(n)]


def _both_states(warmup, tcfg_kw=()):
    jc = dataclasses.replace(JCSTPConfig.tiny(),
                             warmup_info_nce_steps=warmup)
    tc = dataclasses.replace(CSTPConfig.tiny(), warmup_info_nce_steps=warmup)
    js, jtx = jct.create_state(jax.random.PRNGKey(0), jc,
                               JTrainConfig(batch_size=B, **dict(tcfg_kw)))
    ts, ttx = ct.create_state(
        tc, TrainConfig(batch_size=B, **dict(tcfg_kw)),
        params=convert.cstp_from_jax(_np(js.params), device="cpu"),
        device="cpu")
    return jc, tc, js, jtx, ts, ttx


@pytest.mark.parametrize("warmup", [0, 2, -1])
def test_train_steps_match_jax(warmup):
    """3 steps of make_train_step from the same weights at stage (a)'s lr
    0.05: the evidential loss (warmup 0), InfoNCE for the first 2 steps
    (warmup 2), and the automatic fallback (-1), which takes InfoNCE on
    the steps whose evidence is dead; `warmup_active` shows which ran."""
    jc, tc, js, jtx, ts, ttx = _both_states(warmup)
    jstep, tstep = jct.make_train_step(jc, jtx), ct.make_train_step(tc, ttx)
    active = []
    for se, te in _batches(3):
        js, jm = jstep(js, jnp.asarray(se), jnp.asarray(te))
        ts, tm = tstep(ts, _t(se), _t(te))
        assert set(jm) <= set(tm) and "grad_norm" in tm
        for k, v in jm.items():
            np.testing.assert_allclose(float(tm[k]), float(v), **EVID)
        if warmup:
            active.append(float(tm["warmup_active"]))
    assert ts.step == int(js.step) == 3
    if warmup == 2:
        assert active == [1.0, 1.0, 0.0]
    if warmup == -1:
        assert 1.0 in active
    lr, steps = TrainConfig().learning_rate, 3
    for name in ("protein_projection", "text_projection"):
        for leaf in ("kernel", "bias"):
            a = np.asarray(js.params[name][leaf])
            d = np.abs(ts.params[name][leaf].detach().numpy() - a)
            assert d.max() <= 2 * lr * steps
            assert (d <= 1e-4).mean() >= 0.99


def test_evaluate_matches_jax():
    jc, tc, js, _, ts, _ = _both_states(0)
    val = _batches(2, seed=7)
    ref = jct.evaluate(js.params, jc, val)
    got = ct.evaluate(ts.params, tc, val, device="cpu")
    assert set(got) == set(ref) | {"evidence_dead"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], **EVID)


def test_fit_checkpoints_restore_and_resume(tmp_path):
    """fit over 4 batches with save_every=2 keeps steps 2 and 4;
    restore_state of step 4 equals the state in memory bit for bit, and
    step 2 restored into a fresh state and fit over the last two batches
    gives the uninterrupted run's parameters and moments bit for bit.
    The mesh and the prefetch thread are refused."""
    tcfg = TrainConfig(batch_size=B, warmup_steps=2, grad_clip_norm=1.0,
                       log_every=1)
    _, tc, js, _, _, _ = _both_states(0, dict(warmup_steps=2,
                                              grad_clip_norm=1.0))
    start = convert.cstp_from_jax(_np(js.params), device="cpu")
    batches = _batches(4, seed=8)
    fresh = lambda: ct.create_state(tc, tcfg, 4, params=start, device="cpu")
    state, tx = fresh()
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    logs = []
    state = ct.fit(state, tx, tc, tcfg, batches, log_fn=logs.append,
                   ckpt=mgr, save_every=2, device="cpu",
                   val_batches_fn=lambda: _batches(1, seed=9))
    assert mgr.all_steps() == [2, 4] and state.step == 4
    assert any(line.startswith("  val: loss=") for line in logs)
    leaves = lambda s: [t.detach() for t in ct.leaves(s.params)]
    moments = lambda s: [v for st in s.opt_state.opt.state.values()
                         for v in st.values()]
    back, _ = fresh()
    back = ct.restore_state(mgr, back)
    assert back.step == 4 and back.opt_state.count == tx.count
    for a, b in zip(leaves(back) + moments(back),
                    leaves(state) + moments(state)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    resumed, rtx = fresh()
    resumed = ct.restore_state(mgr, resumed, step=2)
    resumed = ct.fit(resumed, rtx, tc, tcfg, batches[2:], log_fn=print,
                     device="cpu")
    assert resumed.step == 4
    for a, b in zip(leaves(resumed) + moments(resumed),
                    leaves(state) + moments(state)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="item 10"):
        ct.fit(state, tx, tc, tcfg, batches, device="cpu", mesh=object())
