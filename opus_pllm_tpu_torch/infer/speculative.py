"""Speculative decoding pieces the serving engine needs (port of
`opus_pllm_tpu/infer/speculative.py`: `accept_and_emit` :56 and
`draft_from_target` :152).

`accept_and_emit` is the per-row acceptance rule of one verify pass.
Greedy rows accept while each proposal is the target's argmax, then emit
the target argmax: token-identical to plain greedy decode. Sampled rows run
rejection-verified speculative sampling: proposal d_j is accepted with
probability min(1, p_j(d_j) / q_j(d_j)), the first rejection emits a draw
from the residual norm(max(p_j - q_j, 0)) and full acceptance a draw from
p_{K-1}, so each emitted token is distributed exactly as plain sampling.
The uniforms and the residual draw come from the caller's
`torch.Generator`, so sampled rows match the JAX package in distribution,
not bit for bit.

The static `speculative_generate` is not ported (ROADMAP.md §1 item 7).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.config import DecoderConfig
from .engine import _categorical


def accept_and_emit(props, q_probs, v, p_probs, greedy,
                    generator: torch.Generator):
    """props (B, K-1) draft proposals; q_probs (B, K-1, V) fp32 the warped
    draft distributions they were drawn from (unused on greedy rows); v
    (B, K) the target argmaxes after chunk[0..j]; p_probs (B, K, V) fp32
    the warped target distributions; greedy (B,) bool rows with
    temperature <= 0. Returns (emit (B, K) long, n_emit (B,) long): each
    row emits emit[:, :n_emit]."""
    b, km1 = props.shape
    props = props.long()
    v = v.long()
    p_tok = torch.gather(p_probs[:, :km1], 2, props[..., None])[..., 0]
    q_tok = torch.gather(q_probs, 2, props[..., None])[..., 0]
    u = torch.rand((b, km1), generator=generator, device=props.device)
    # u < p/q written as a product, so q == 0 rejects
    acc = torch.where(greedy[:, None], props == v[:, :km1],
                      u * q_tok < p_tok)
    a_row = torch.cumprod(acc.long(), dim=1).sum(dim=1)          # 0..K-1

    # the bonus at position a_row: the residual on a rejection, a plain p
    # draw on full acceptance (q taken as 0 there), the argmax if greedy
    rows = torch.arange(b, device=props.device)
    p_bon = p_probs[rows, a_row]
    q_bon = q_probs[rows, a_row.clamp_max(km1 - 1)]
    q_bon = torch.where((a_row < km1)[:, None], q_bon,
                        torch.zeros_like(q_bon))
    resid = torch.clamp_min(p_bon - q_bon, 0.0)
    # no residual mass only when p == q (a rejection then has probability
    # 0); a zero distribution must not turn into NaN
    resid = torch.where(resid.sum(-1, keepdim=True) > 1e-9, resid, p_bon)
    bonus_sampled = _categorical(torch.log(torch.clamp_min(resid, 1e-38)),
                                 generator).long()
    bonus = torch.where(greedy, v[rows, a_row], bonus_sampled)

    cols = torch.arange(km1 + 1, device=props.device)[None, :]
    props_pad = torch.cat([props, props[:, -1:]], dim=1)
    emit = torch.where(cols < a_row[:, None], props_pad,
                       torch.where(cols == a_row[:, None], bonus[:, None],
                                   torch.zeros_like(props_pad)))
    return emit, a_row + 1


def draft_from_target(params, cfg: DecoderConfig, n_layers: int):
    """Self-speculative (layer-skip) draft: the target's first `n_layers`
    with its embedding, final norm and head, sharing the tensors (no
    copy). Returns (draft params, draft config)."""
    if not 0 < n_layers < cfg.num_layers:
        raise ValueError(f"draft_layers must be in [1, {cfg.num_layers - 1}]"
                         f" (target has {cfg.num_layers} layers), "
                         f"got {n_layers}")
    dcfg = dataclasses.replace(cfg, num_layers=n_layers)
    dp = {k: v for k, v in params.items() if k != "layers"}
    dp["layers"] = params["layers"][:n_layers]
    return dp, dcfg
