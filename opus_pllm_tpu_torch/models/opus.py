"""Opus multimodal model: ESM2 -> CSTP -> switch projector -> LLM (port of
`opus_pllm_tpu/models/opus.py`: `init` :37, `encode_proteins` :49,
`splice_prompt` :76, `forward` :123, `next_token_loss` :142 and
`next_token_loss_hidden` :156). Parameters: {"esm", "cstp" (optional),
"switch", "llm"}.

Training (stages c/d) differentiates through the switch projector and the
LLM only: the frozen ESM tower and the CSTP projection run under
torch.no_grad(), so the fused encoder kernels (which have no backward)
never see grad mode; the switch builds a graph only when its parameters
require grad (stage c)."""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from ..bridge import cstp as cstp_mod
from ..bridge import projector as switch_mod
from ..bridge.splice import Spliced, splice
from ..core.config import IGNORE_INDEX, OpusConfig
from ..core.util import resolve_device
from . import decoder, esm2
from .layers import causal_mask


def init(cfg: OpusConfig, *, generator: torch.Generator, device=None):
    """Random parameters for the whole model, drawn from `generator` on
    `device` (None: CUDA)."""
    kw = dict(generator=generator, device=resolve_device(device))
    params = {"esm": esm2.init(cfg.esm, **kw),
              "switch": switch_mod.init(cfg.switch, **kw),
              "llm": decoder.init(cfg.llm, **kw)}
    if cfg.cstp is not None:
        params["cstp"] = cstp_mod.init(cfg.cstp, **kw)
    return params


def encode_proteins(params, cfg: OpusConfig, esm_tokens=None, *,
                    pooled_emb=None, impl: str = "auto"):
    """(B, P, L_aa) ESM tokens -> (B, P, n_tokens, H) soft tokens in the
    LLM's dtype. Without a CSTP adapter the pooled ESM embedding feeds the
    switch projector directly. `pooled_emb` (B, P, E) skips the ESM tower
    (the precomputed-embedding training path, opus.py:62-64)."""
    with torch.no_grad():
        if pooled_emb is not None:
            b, p, _ = pooled_emb.shape
            emb = pooled_emb.reshape(b * p, -1).float()
        else:
            b, p, l = esm_tokens.shape
            emb = esm2.pooled_embedding(params["esm"], cfg.esm,
                                        esm_tokens.reshape(b * p, l),
                                        impl=impl)
        if "cstp" in params:
            emb = cstp_mod.protein_forward(params["cstp"], emb)
    soft = switch_mod.apply(params["switch"], cfg.switch, emb,
                            out_dtype=cfg.llm.torch_dtype)
    return soft.reshape(b, p, cfg.switch.n_tokens, cfg.llm.hidden_size)


def splice_prompt(params, cfg: OpusConfig, input_ids, attn_mask, esm_tokens,
                  labels=None, *, left_pad: bool, pooled_emb=None,
                  impl: str = "auto") -> Spliced:
    """Tokenized prompt (with SEQ_TOKEN_INDEX sentinels) -> decoder inputs."""
    prot = encode_proteins(params, cfg, esm_tokens, pooled_emb=pooled_emb,
                           impl=impl)
    text = decoder.embed_tokens(params["llm"], input_ids.long().clamp_min(0))
    return splice(input_ids, attn_mask, text, prot, labels,
                  n_tokens=cfg.switch.n_tokens, left_pad=left_pad)


def splice_prompt_left(params, cfg: OpusConfig, input_ids, attn_mask,
                       esm_tokens, *, impl: str = "auto") -> Spliced:
    """The left-pad splice the engine eval runner uses (opus.py:114)."""
    return splice_prompt(params, cfg, input_ids, attn_mask, esm_tokens,
                         left_pad=True, impl=impl)


def forward(params, cfg: OpusConfig, input_ids, attn_mask, esm_tokens=None,
            labels=None, *, lora=None, lora_scale: float = 1.0,
            pooled_emb=None, remat=False, return_hidden: bool = False,
            impl: str = "auto"):
    """Full multimodal forward on the right-padded training path
    (opus.py:123-139) -> (logits (B, L_out, V) fp32, or the final-normed
    hidden states with return_hidden, and the Spliced inputs)."""
    sp = splice_prompt(params, cfg, input_ids, attn_mask, esm_tokens, labels,
                       left_pad=False, pooled_emb=pooled_emb, impl=impl)
    out, _ = decoder.forward(
        params["llm"], cfg.llm, sp.embeds.to(cfg.llm.torch_dtype),
        sp.positions, causal_mask(sp.mask), lora=lora, lora_scale=lora_scale,
        remat=remat, return_hidden=return_hidden, impl=impl)
    return out, sp


def _nll(logits, targets):
    """-log softmax(logits)[target] in fp32, per position."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0]


def next_token_loss(logits, labels, mask):
    """Shifted next-token cross-entropy, mean over the positions whose
    target is not IGNORE_INDEX and whose slot is valid (opus.py:142-153)."""
    tg = labels[:, 1:]
    valid = (tg != IGNORE_INDEX) & mask[:, 1:]
    nll = _nll(logits[:, :-1], tg.clamp_min(0))
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp_min(1)


def next_token_loss_hidden(llm_params, llm_cfg, hidden, labels, mask, *,
                           chunk: int = 64):
    """The same loss from final-normed hidden states, the vocab projection
    and cross-entropy applied per sequence chunk of `chunk` positions
    (opus.py:156-216): each chunk runs under torch.utils.checkpoint, so
    only (B, chunk, V) fp32 logits live at a time and the backward
    recomputes each chunk's head. (The JAX function's shift=False /
    reduce=False forms serve its sequence-parallel trainer, not ported.)"""
    hs, tg = hidden[:, :-1], labels[:, 1:]
    valid = (tg != IGNORE_INDEX) & mask[:, 1:]
    tg = tg.clamp_min(0)

    def chunk_sum(hc, tc, vc):
        nll = _nll(decoder.head_logits(llm_params, llm_cfg, hc), tc)
        return torch.where(vc, nll, torch.zeros_like(nll)).sum()

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, hs.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        args = (hs[:, sl], tg[:, sl], valid[:, sl])
        if torch.is_grad_enabled():
            tot = tot + torch.utils.checkpoint.checkpoint(
                chunk_sum, *args, use_reentrant=False)
        else:
            tot = tot + chunk_sum(*args)
    return tot / valid.sum().clamp_min(1)
