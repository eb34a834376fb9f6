"""The stage-(c)/(d) optimizer (port of `opus_pllm_tpu/train/optim.py`
`adamw` :20): AdamW with betas (0.9, 0.999), eps 1e-8 and decoupled weight
decay, an optional warmup-cosine learning-rate schedule and an optional
global-norm gradient clip, each written to optax's formula:

  * the schedule is optax's `warmup_cosine_decay_schedule(init_value=0,
    peak_value=lr, warmup_steps, decay_steps=max(total, warmup + 1))`,
    evaluated at the number of updates already made (so a warmup's first
    update has lr 0, as in optax);
  * the clip is optax's `clip_by_global_norm`: g / norm * max_norm when the
    global norm reaches max_norm, g otherwise (`clip_grad_norm_` adds 1e-6
    to the norm, which is another function).

`torch.optim.AdamW` applies the update: its decoupled decay p -= lr wd p
and its bias-corrected m / (sqrt(v) + eps) step are optax's adamw
(p_old - lr (adam + wd p_old)).
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import torch

from ..core.config import TrainConfig


def warmup_cosine(step: int, peak: float, warmup: int, decay: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay) at
    `step`: linear 0 -> peak over `warmup` steps, then cosine to 0 over
    decay - warmup steps."""
    if step < warmup:
        return peak * step / warmup
    span = decay - warmup
    frac = min(step - warmup, span) / span
    return peak * 0.5 * (1.0 + math.cos(math.pi * frac))


class AdamW:
    """The optimizer of `adamw(cfg, total_steps)` over a list of leaves.
    `step()` reads each leaf's `.grad`, clips, sets the scheduled lr and
    applies torch.optim.AdamW."""

    def __init__(self, params: Iterable[torch.Tensor], cfg: TrainConfig,
                 total_steps: Optional[int] = None):
        self.params = list(params)
        self.lr = cfg.learning_rate
        self.warmup = cfg.warmup_steps if total_steps else 0
        self.decay = max(total_steps or 0, cfg.warmup_steps + 1)
        self.clip = cfg.grad_clip_norm
        self.count = 0
        self.opt = torch.optim.AdamW(self.params, lr=self.lr,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=cfg.weight_decay)

    def current_lr(self) -> float:
        if self.warmup > 0:
            return warmup_cosine(self.count, self.lr, self.warmup,
                                 self.decay)
        return self.lr

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.clip > 0 and grads:
            norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
            factor = torch.where(norm < self.clip, torch.ones_like(norm),
                                 self.clip / norm)
            for g in grads:
                g.mul_(factor.to(g.dtype))
        for group in self.opt.param_groups:
            group["lr"] = self.current_lr()
        self.opt.step()
        self.count += 1

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


def adamw(cfg: TrainConfig, total_steps: Optional[int] = None, params=()):
    """AdamW over `params` with `cfg`'s lr, weight decay, warmup-cosine
    schedule (when warmup_steps > 0 and total_steps are given) and
    global-norm clip (when grad_clip_norm > 0), as train/optim.py:20-32."""
    return AdamW(params, cfg, total_steps)
