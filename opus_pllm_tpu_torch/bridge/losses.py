"""Contrastive losses for stage-(a) CSTP training (port of
`opus_pllm_tpu/bridge/losses.py`, the whole module).

`info_nce` (losses.py:40), `info_nce_sym` (:44), `dirichlet_kl` (:49),
`evidential_ce` (:64), `evidential_likelihood` (:94), `evidential_mse`
(:116), `EVIDENTIAL_LOSSES` (:138), `trust_evidence` (:142) and
`evidence_is_dead` (:155). Everything runs in fp32 with `torch.digamma` /
`torch.lgamma`; `global_step` is a Python int, as in the JAX functions
(CSTPConfig.evidence_global_step, fixed at 1000).

The dead-gradient region the JAX docstring describes holds here too: at
T = 0.0007 the similarity logits reach O(10^3); when every scaled logit of
a row is below about -15, elu(x) + 1 evidence is 0 in fp32 with a zero
gradient, and the loss stays flat. `evidence_is_dead` reports it; the
trainer's `warmup_info_nce_steps` falls back to `info_nce_sym` there.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.config import CSTPConfig


def _xent(logits, targets):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.gather(logp, 1, targets[:, None].long()))


def info_nce(p2t_logits, targets, temperature: float = 0.0007):
    """InfoNCE in one direction at temperature T."""
    return _xent(p2t_logits / temperature, targets)


def info_nce_sym(p2t_logits, t2p_logits, targets, temperature: float = 0.007):
    """The mean of InfoNCE in both directions."""
    return 0.5 * (_xent(p2t_logits / temperature, targets)
                  + _xent(t2p_logits / temperature, targets))


def dirichlet_kl(alpha):
    """KL(Dir(alpha) || Dir(1)) per row, (B, 1) fp32."""
    a = alpha.float()
    c = a.shape[-1]
    s = torch.sum(a, dim=-1, keepdim=True)
    first = (torch.lgamma(s) - torch.sum(torch.lgamma(a), dim=-1,
                                         keepdim=True)
             - math.lgamma(c))
    second = torch.sum((a - 1.0) * (torch.digamma(a) - torch.digamma(s)),
                       dim=-1, keepdim=True)
    return first + second


def _kl_coef(global_step: int, kl_threshold: int, annealing_steps: int,
             kl_coefficient: float) -> float:
    if global_step >= kl_threshold:
        return min(kl_coefficient,
                   (global_step - kl_threshold + 1) / annealing_steps)
    return 0.0


def _alpha(logits, w, num_classes):
    """(fp32 logits, alpha = elu + 1 + W / c, one-hot width c)."""
    x = logits.float()
    c = num_classes if num_classes is not None else x.shape[-1]
    w = float(w if w is not None else c)
    return x, F.elu(x) + 1.0 + w / c


def _kl_term(alpha, label, coef: float):
    alp = (alpha - 1.0) * (1.0 - label) + 1.0
    return coef * dirichlet_kl(alp)


def evidential_ce(logits, targets, *, global_step: int = 100,
                  w: Optional[float] = None, num_classes: Optional[int] = None,
                  annealing_steps: int = 500, kl_threshold: int = 30,
                  kl_coefficient: float = 1.0):
    """Evidential (Dirichlet) cross-entropy: sum_k y_k (digamma(S) -
    digamma(alpha_k)) plus the KL of the non-target evidence to the
    uniform Dirichlet, annealed in after `kl_threshold` steps."""
    x, alpha = _alpha(logits, w, num_classes)
    s = torch.sum(alpha, dim=-1, keepdim=True)
    label = F.one_hot(targets.long(), x.shape[-1]).float()
    a_term = torch.sum(label * (torch.digamma(s) - torch.digamma(alpha)),
                       dim=-1, keepdim=True)
    coef = _kl_coef(global_step, kl_threshold, annealing_steps,
                    kl_coefficient)
    return torch.mean(a_term + _kl_term(alpha, label, coef))


def evidential_likelihood(logits, targets, *, global_step: int = 100,
                          w: Optional[float] = None,
                          num_classes: Optional[int] = None,
                          annealing_steps: int = 500, kl_threshold: int = 30,
                          kl_coefficient: float = 1.0):
    """The Dirichlet likelihood variant: log(S) - log(alpha_k)."""
    x, alpha = _alpha(logits, w, num_classes)
    s = torch.sum(alpha, dim=-1, keepdim=True)
    label = F.one_hot(targets.long(), x.shape[-1]).float()
    a_term = torch.sum(label * (torch.log(s) - torch.log(alpha)), dim=-1,
                       keepdim=True)
    coef = _kl_coef(global_step, kl_threshold, annealing_steps,
                    kl_coefficient)
    return torch.mean(a_term + _kl_term(alpha, label, coef))


def evidential_mse(logits, targets, *, global_step: int = 100,
                   w: Optional[float] = None,
                   num_classes: Optional[int] = None,
                   annealing_steps: int = 500, kl_threshold: int = 30,
                   kl_coefficient: float = 1.0):
    """The Dirichlet MSE variant: squared error to alpha / S plus the
    Dirichlet variance."""
    x, alpha = _alpha(logits, w, num_classes)
    s = torch.sum(alpha, dim=-1, keepdim=True)
    label = F.one_hot(targets.long(), x.shape[-1]).float()
    err = torch.sum(torch.square(label - alpha / s), dim=-1, keepdim=True)
    var = torch.sum(alpha * (s - alpha) / (s * s * (s + 1.0)), dim=-1,
                    keepdim=True)
    coef = _kl_coef(global_step, kl_threshold, annealing_steps,
                    kl_coefficient)
    return torch.mean(err + var + _kl_term(alpha, label, coef))


EVIDENTIAL_LOSSES = {"ce": evidential_ce, "likelihood": evidential_likelihood,
                     "mse": evidential_mse}


def trust_evidence(p2t_logits, t2p_logits, targets,
                   cfg: Optional[CSTPConfig] = None):
    """The symmetric evidential loss at cfg.temperature (0.0007)."""
    cfg = cfg or CSTPConfig()
    kw = dict(global_step=cfg.evidence_global_step,
              annealing_steps=cfg.kl_annealing_steps,
              kl_threshold=cfg.kl_threshold_step,
              kl_coefficient=cfg.kl_coefficient)
    lp = evidential_ce(p2t_logits / cfg.temperature, targets, **kw)
    lt = evidential_ce(t2p_logits / cfg.temperature, targets, **kw)
    return 0.5 * (lp + lt)


def evidence_is_dead(p2t_logits, t2p_logits, cfg: CSTPConfig,
                     threshold: float = 1e-3):
    """A 0-d bool tensor, true when the evidential loss is in its
    zero-gradient region: the largest scaled similarity's elu + 1 evidence
    is below `threshold`. Stays on the logits' device (no host read)."""
    x = torch.maximum(p2t_logits.max(), t2p_logits.max()) / cfg.temperature
    return (F.elu(x.float()) + 1.0) < threshold
