"""Speculative decoding (port of `opus_pllm_tpu/infer/speculative.py`:
`accept_and_emit` :56, `SpecOutput` :123, `_decode_mask` :133,
`_one_step` :143, `draft_from_target` :152, `speculative_generate` :183
and `_speculative` :218).

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

`speculative_generate` is the static path's draft-then-verify loop: the
draft (the target's first N layers, `draft_from_target`) proposes K
tokens one at a time into its own KV cache, the target verifies them in
one K-token forward over its cache, and every row of the batch advances by
the same count, the least acceptance over the rows still running, so
every cache write stays at one batch-uniform slot. Both caches hold K
slots of slack; slots past the valid count are masked out
(`_decode_mask`) and rewritten later. Greedy output is token-identical to
`engine.generate` by construction (every emitted token is the target's
argmax after a verified prefix). Sampled output uses the rejection rule
above at the batch-uniform emission slot, drawing from the caller's
`torch.Generator`. The loop reads the acceptance count and the rows' done
flags on the host once an iteration.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import torch

from ..core.config import DecoderConfig
from ..models import decoder
from .engine import (GenerateOutput, _categorical, _sync, sample_token,
                     warp_logits_rows, warp_probs_rows)


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
    decoder.refuse_deepseek(cfg, "speculative decoding")
    if not 0 < n_layers < cfg.num_layers:
        raise ValueError(f"draft_layers must be in [1, {cfg.num_layers - 1}]"
                         f" (target has {cfg.num_layers} layers), "
                         f"got {n_layers}")
    dcfg = dataclasses.replace(cfg, num_layers=n_layers)
    dp = {k: v for k, v in params.items() if k != "layers"}
    dp["layers"] = params["layers"][:n_layers]
    return dp, dcfg


class SpecOutput(NamedTuple):
    tokens: torch.Tensor    # (B, max_new) int32, pad after EOS
    lengths: torch.Tensor   # (B,) generated incl. EOS
    iterations: int         # verify passes (max_new / iterations ~ tokens
    #                         per pass over the target's weights)
    positions: int          # batch-uniform positions emitted
    decode_seconds: float   # wall time of the loop, device synced


def _decode_mask(prompt_mask, cap: int, upto: int):
    """(B, 1, 1, cap) valid slots: the prompt's per `prompt_mask`, the
    decode slots below `upto` (stale speculative slots excluded)."""
    b, l = prompt_mask.shape
    base = torch.cat([prompt_mask.bool(),
                      torch.ones((b, cap - l), dtype=torch.bool,
                                 device=prompt_mask.device)], dim=1)
    cols = torch.arange(cap, device=prompt_mask.device)[None, :]
    return (base & (cols < upto))[:, None, None, :]


def _one_step(params, cfg, prompt_mask, cap, cache, emb, pos, slot: int,
              impl):
    """One token at the batch-uniform `slot` -> its fp32 logits (B, V)."""
    sub = {"layers": cache["layers"], "index": slot, "mask": cache["mask"]}
    hid, _ = decoder.forward(params, cfg, emb, pos,
                             _decode_mask(prompt_mask, cap, slot + 1), sub,
                             impl=impl, return_hidden=True, ntk_ctx=cap)
    return decoder.head_logits(params, cfg, hid, impl=impl)[:, -1].float()


@torch.no_grad()
def speculative_generate(draft_params, params, cfg_draft: DecoderConfig,
                         cfg: DecoderConfig, input_embeds,
                         draft_input_embeds, attn_mask, positions, *,
                         max_new_tokens: int, n_draft: int = 4,
                         eos_token_id: int = -1, pad_token_id: int = 0,
                         quantize_cache=False, temperature: float = 0.0,
                         top_p: float = 1.0,
                         generator: Optional[torch.Generator] = None,
                         impl: str = "auto") -> GenerateOutput:
    """Speculative decode -> engine.GenerateOutput (steps: the
    batch-uniform positions emitted).

    input_embeds / draft_input_embeds (B, L, H) LEFT-padded prompt
    embeddings in each model's embedding space (the same tensor for a
    layer-skip draft); attn_mask / positions (B, L) as in
    engine.generate; n_draft = K proposals a verify pass. temperature 0:
    greedy, token-identical to engine.generate. temperature > 0:
    rejection-verified speculative sampling under generate's warp, with
    randomness from `generator` (None: a fresh generator seeded 0 on the
    embeddings' device)."""
    decoder.refuse_deepseek(cfg, "speculative decoding")
    out = _speculative(draft_params, params, cfg_draft, cfg, input_embeds,
                       draft_input_embeds, attn_mask, positions,
                       max_new_tokens, n_draft, eos_token_id, pad_token_id,
                       quantize_cache, temperature, top_p, generator, impl)
    return GenerateOutput(out.tokens, out.lengths, out.positions,
                          out.decode_seconds)


def _speculative(draft_params, params, cfg_draft, cfg, input_embeds,
                 draft_input_embeds, attn_mask, positions, max_new_tokens,
                 K, eos_id, pad_id, quantize_cache, temperature, top_p,
                 generator, impl) -> SpecOutput:
    b, l, _ = input_embeds.shape
    dev = input_embeds.device
    do_sample = temperature > 0
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    cap = l + max_new_tokens + K          # slack: the last chunk overshoots
    mask = attn_mask.bool()

    def prefill(p, c, emb):
        cache = decoder.init_cache(c, b, cap, dtype=c.torch_dtype,
                                   device=dev, quantize=quantize_cache)
        cache["mask"][:, :l] = mask
        rows = torch.arange(l, device=dev)[None, None, :, None]
        cols = torch.arange(cap, device=dev)[None, None, None, :]
        m4 = cache["mask"][:, None, None, :] & (cols <= rows)
        hid, cache = decoder.forward(p, c, emb.to(c.torch_dtype), positions,
                                     m4, cache, impl=impl,
                                     return_hidden=True, ntk_ctx=cap)
        lg = decoder.head_logits(p, c, hid[:, -1:], impl=impl)[:, 0].float()
        return cache, lg

    t_cache, t_logits = prefill(params, cfg, input_embeds)
    d_cache, _ = prefill(draft_params, cfg_draft, draft_input_embeds)
    last_pos = positions[:, -1].long()
    rows_b = torch.arange(b, device=dev)

    # the first token comes straight from the target's prefill
    if do_sample:
        t_last = sample_token(t_logits, generator, temperature, top_p)
    else:
        t_last = torch.argmax(t_logits, dim=-1).int()
    out = torch.full((b, max_new_tokens), pad_id, dtype=torch.int32,
                     device=dev)
    out[:, 0] = t_last
    done = (t_last == eos_id) | (max_new_tokens <= 1)
    nw = torch.ones((b,), dtype=torch.int32, device=dev)
    temps = torch.full((b,), temperature, dtype=torch.float32, device=dev)
    tops = torch.full((b,), top_p, dtype=torch.float32, device=dev)
    ar = torch.arange(K, device=dev)
    idx = l                               # valid slots: prompt + accepted
    iters = 0
    _sync(dev)
    t0 = time.perf_counter()
    while not bool(done.all()):
        # draft: K one-token steps; proposal j is written to slot idx + j
        # of the draft's cache as the input of step j + 1
        tok, props, qs = t_last, [], []
        for j in range(K):
            emb = decoder.embed_tokens(draft_params, tok.long().clamp_min(0))
            lg = _one_step(draft_params, cfg_draft, mask, cap, d_cache,
                           emb[:, None].to(cfg_draft.torch_dtype),
                           (last_pos + 1 + j)[:, None], idx + j, impl)
            if do_sample:
                warped = warp_logits_rows(lg, temps, tops)
                tok = _categorical(warped, generator)
                qs.append(torch.softmax(warped, dim=-1))
            else:
                tok = torch.argmax(lg, dim=-1).int()
            props.append(tok)
        d_prop = torch.stack(props, dim=1)                       # (B, K)
        chunk = torch.cat([t_last[:, None], d_prop[:, :K - 1]], dim=1)

        # target: one forward over the K-token chunk at slots idx..idx+K-1
        emb = decoder.embed_tokens(params, chunk.long().clamp_min(0))
        cols = torch.arange(cap, device=dev)[None, None, None, :]
        m4 = _decode_mask(mask, cap, idx + K) & (
            cols <= idx + ar[None, None, :, None])              # (B,1,K,cap)
        sub = {"layers": t_cache["layers"], "index": idx,
               "mask": t_cache["mask"]}
        hid, _ = decoder.forward(params, cfg, emb.to(cfg.torch_dtype),
                                 last_pos[:, None] + 1 + ar[None, :], m4,
                                 sub, impl=impl, return_hidden=True,
                                 ntk_ctx=cap)
        lg = decoder.head_logits(params, cfg, hid, impl=impl).float()
        v = torch.argmax(lg, dim=-1).int()      # v[:, j]: after chunk[..j]

        # batch-uniform acceptance: the least over the running rows
        if do_sample:
            ps = warp_probs_rows(lg, temps[:, None], tops[:, None])
            q_all = torch.stack(qs, dim=1)                       # (B,K,V)
            pk = d_prop[:, :K - 1, None].long()
            p_tok = torch.gather(ps[:, :K - 1], 2, pk)[..., 0]
            q_tok = torch.gather(q_all[:, :K - 1], 2, pk)[..., 0]
            u = torch.rand((b, K - 1), generator=generator, device=dev)
            acc = u * q_tok < p_tok             # u < p/q; q == 0 rejects
        else:
            acc = d_prop[:, :K - 1] == v[:, :K - 1]
        a_full = torch.cumprod(acc.int(), dim=1).sum(dim=1)      # 0..K-1
        a_row = torch.where(done, torch.full_like(a_full, K - 1), a_full)
        a = int(a_row.min())
        n_emit = a + 1

        if do_sample:
            # position a, per row: its accepted draft (a_full > a), its
            # residual draw (rejected at a) or a plain p draw (a == K-1)
            p_bon = ps[:, a]
            q_bon = (q_all[:, min(a, K - 2)] if a < K - 1
                     else torch.zeros_like(p_bon))
            resid = torch.clamp_min(p_bon - q_bon, 0.0)
            resid = torch.where(resid.sum(-1, keepdim=True) > 1e-9, resid,
                                p_bon)
            bonus = _categorical(torch.log(torch.clamp_min(resid, 1e-38)),
                                 generator)
            bonus = torch.where(a_full > a, d_prop[:, a], bonus)
            emit = torch.where(ar[None, :] < a, d_prop,
                               torch.where(ar[None, :] == a, bonus[:, None],
                                           torch.zeros_like(d_prop)))
        else:
            emit = v              # the matched prefix is the drafts'

        for j in range(n_emit):
            tok = emit[:, j]
            write = ~done & (nw < max_new_tokens)
            col = nw.clamp_max(max_new_tokens - 1).long()
            out[rows_b, col] = torch.where(write, tok, out[rows_b, col])
            nw = nw + write.int()
            done = done | (write & (tok == eos_id))
        done = done | (nw >= max_new_tokens)
        t_last = emit[:, a]
        idx += n_emit
        last_pos = last_pos + n_emit
        iters += 1
    _sync(dev)
    return SpecOutput(out, nw, iters, idx - l, time.perf_counter() - t0)
