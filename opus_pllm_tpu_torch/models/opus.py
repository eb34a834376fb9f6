"""Opus multimodal model: ESM2 -> CSTP -> switch projector -> LLM (port of
`opus_pllm_tpu/models/opus.py`: `init` :37, `encode_proteins` :49,
`splice_prompt` :76). Parameters: {"esm", "cstp" (optional), "switch",
"llm"}."""

from __future__ import annotations

import torch

from ..bridge import cstp as cstp_mod
from ..bridge import projector as switch_mod
from ..bridge.splice import Spliced, splice
from ..core.config import OpusConfig
from . import decoder, esm2


def init(cfg: OpusConfig, *, generator: torch.Generator, device=None):
    """Random parameters for the whole model, drawn from `generator` on
    `device`."""
    kw = dict(generator=generator, device=device)
    params = {"esm": esm2.init(cfg.esm, **kw),
              "switch": switch_mod.init(cfg.switch, **kw),
              "llm": decoder.init(cfg.llm, **kw)}
    if cfg.cstp is not None:
        params["cstp"] = cstp_mod.init(cfg.cstp, **kw)
    return params


def encode_proteins(params, cfg: OpusConfig, esm_tokens, *,
                    impl: str = "auto"):
    """(B, P, L_aa) ESM tokens -> (B, P, n_tokens, H) soft tokens in the
    LLM's dtype. Without a CSTP adapter the pooled ESM embedding feeds the
    switch projector directly."""
    b, p, l = esm_tokens.shape
    emb = esm2.pooled_embedding(params["esm"], cfg.esm,
                                esm_tokens.reshape(b * p, l), impl=impl)
    if "cstp" in params:
        emb = cstp_mod.protein_forward(params["cstp"], emb)
    soft = switch_mod.apply(params["switch"], cfg.switch, emb,
                            out_dtype=cfg.llm.torch_dtype)
    return soft.reshape(b, p, cfg.switch.n_tokens, cfg.llm.hidden_size)


def splice_prompt(params, cfg: OpusConfig, input_ids, attn_mask, esm_tokens,
                  labels=None, *, left_pad: bool,
                  impl: str = "auto") -> Spliced:
    """Tokenized prompt (with SEQ_TOKEN_INDEX sentinels) -> decoder inputs."""
    prot = encode_proteins(params, cfg, esm_tokens, impl=impl)
    text = decoder.embed_tokens(params["llm"], input_ids.long().clamp_min(0))
    return splice(input_ids, attn_mask, text, prot, labels,
                  n_tokens=cfg.switch.n_tokens, left_pad=left_pad)
