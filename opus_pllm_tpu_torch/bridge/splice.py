"""Static-shape multimodal splicer (port of `opus_pllm_tpu/bridge/splice.py`).

`splice` (splice.py:45) and `output_len` (splice.py:40): each input
position j expands to e_j slots (n_tokens for a `<seq>` sentinel, 1 for a
text token, 0 for padding); an exclusive cumsum gives each token's start,
and each output slot finds its source token by searchsorted. Left padding
shifts the stream right (inference), right padding keeps it at 0
(training); positions restart at 0 at the first valid slot. The batch
dimension is written out instead of the JAX vmap.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import IGNORE_INDEX, SEQ_TOKEN_INDEX


class Spliced(NamedTuple):
    embeds: torch.Tensor       # (B, L_out, H)
    labels: torch.Tensor       # (B, L_out) int32, IGNORE_INDEX at protein/pad
    mask: torch.Tensor         # (B, L_out) bool
    positions: torch.Tensor    # (B, L_out) int32


def output_len(input_len: int, max_proteins: int, n_tokens: int) -> int:
    return input_len + max_proteins * (n_tokens - 1)


def splice(input_ids, attn_mask, text_embeds, protein_tokens, labels=None,
           *, n_tokens: int, left_pad: bool,
           l_out: Optional[int] = None) -> Spliced:
    """input_ids (B, L) with SEQ_TOKEN_INDEX sentinels; attn_mask (B, L)
    bool; text_embeds (B, L, H); protein_tokens (B, P, T, H), protein p
    replacing the p-th sentinel of its row; labels (B, L) or None."""
    b, l = input_ids.shape
    p_max, t = protein_tokens.shape[1], protein_tokens.shape[2]
    if t != n_tokens:
        raise ValueError(f"protein_tokens carry {t} tokens, not {n_tokens}")
    lo = l_out if l_out is not None else output_len(l, p_max, n_tokens)
    dev = input_ids.device
    ids = input_ids.long()
    if labels is None:
        labels = torch.full_like(ids, IGNORE_INDEX)

    is_seq = (ids == SEQ_TOKEN_INDEX) & attn_mask
    e = torch.where(is_seq, n_tokens, attn_mask.long())            # (B, L)
    starts = torch.cumsum(e, dim=1) - e
    total = e.sum(dim=1, keepdim=True)                             # (B, 1)
    rank = torch.cumsum(is_seq.long(), dim=1) - 1

    k = torch.arange(lo, device=dev)[None, :].expand(b, lo)
    if left_pad:
        k = k - (lo - total)
    valid = (k >= 0) & (k < total)
    kq = k.clamp_min(0).contiguous()
    j = torch.searchsorted(starts.contiguous(), kq, right=True) - 1
    j = j.clamp(0, l - 1)
    within = kq - starts.gather(1, j)
    from_protein = is_seq.gather(1, j)
    rows = torch.arange(b, device=dev)[:, None]
    text_part = text_embeds[rows, j]
    prot_part = protein_tokens[rows, rank.gather(1, j).clamp(0, p_max - 1),
                               within.clamp(0, n_tokens - 1)]
    emb = torch.where(from_protein[..., None], prot_part.to(text_part.dtype),
                      text_part)
    emb = torch.where(valid[..., None], emb, torch.zeros_like(emb))
    lab = torch.where(valid & ~from_protein, labels.long().gather(1, j),
                      torch.full_like(j, IGNORE_INDEX))
    pos = torch.where(valid, kq, torch.zeros_like(kq))
    return Spliced(emb.to(text_embeds.dtype), lab.int(), valid, pos.int())
