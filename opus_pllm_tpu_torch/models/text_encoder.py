"""Text embeddings of a causal LM for CSTP stage-(a) data (port of
`opus_pllm_tpu/models/text_encoder.py`: `text_embeddings` :20).

The text embedding of a caption is the mean over token positions of
(first hidden state + last hidden state) of the decoder, in fp32. The
first hidden state is the token embedding, plus the learned positions for
OPT (HF's hidden_states[0]); the last is the final-normed output of
`decoder.forward(return_hidden=True)`, so the prefill runs the flash
kernel at every layer where `layers.attention` takes it. The reference
averages over ALL positions, padding included (`mask_pad=False`, the
default); `mask_pad=True` takes the masked mean instead.
"""

from __future__ import annotations

import torch

from ..core.config import DecoderConfig
from . import decoder
from .layers import causal_mask


def text_embeddings(params, cfg: DecoderConfig, input_ids, attn_mask, *,
                    mask_pad: bool = False, impl: str = "auto"):
    """(B, L) right-padded ids + bool mask -> (B, H) fp32 embeddings."""
    x0 = decoder.embed_tokens(params, input_ids.long())
    positions = decoder.positions_from_mask(attn_mask)
    first = x0
    if cfg.family == "opt":
        first = x0 + decoder.opt_positions(params, positions)
    last, _ = decoder.forward(params, cfg, x0, positions,
                              causal_mask(attn_mask), impl=impl,
                              return_hidden=True)
    s = first.float() + last.float()
    if mask_pad:
        m = attn_mask[..., None].float()
        return torch.sum(s * m, dim=1) / torch.clamp_min(m.sum(1), 1.0)
    return torch.mean(s, dim=1)
