"""CSTP: the contrastive protein-sequence <-> text adapter of stage (a)
(port of `opus_pllm_tpu/bridge/cstp.py`, the whole module).

`init` (cstp.py:24), `forward` (:40), `protein_forward` (:47),
`text_forward` (:53), `alignment` (:62) and `retrieval_accuracy` (:71):
L2-normalise each input, project it with one fp32 linear (protein
1280 -> 5120, text -> 5120), and score with the unnormalised similarity
matrices p @ t.T and t @ p.T against diagonal targets. Everything runs in
fp32: the evidential loss divides the logits by T = 0.0007.
"""

from __future__ import annotations

import torch

from ..core.config import CSTPConfig
from ..core.util import resolve_device
from ..models.layers import dense, dense_init


def init(cfg: CSTPConfig, *, generator: torch.Generator, device=None):
    """Random fp32 projections on `device` (None: CUDA)."""
    kw = dict(generator=generator, device=resolve_device(device),
              dtype=torch.float32,
              bias=True)
    return {"protein_projection": dense_init(cfg.protein_dim, cfg.proj_dim,
                                             **kw),
            "text_projection": dense_init(cfg.text_dim, cfg.proj_dim, **kw)}


def _l2_normalize(x, eps: float = 1e-12):
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(n, min=eps)


def protein_forward(params, protein_emb):
    """(B, Dp) -> (B, P) fp32."""
    return dense(params["protein_projection"],
                 _l2_normalize(protein_emb.float()))


def forward(params, protein_emb, text_emb):
    """(B, Dp), (B, Dt) -> projected (B, P), (B, P), fp32."""
    return protein_forward(params, protein_emb), text_forward(params,
                                                              text_emb)


def text_forward(params, text_emb):
    """(B, Dt) -> (B, P) fp32: the text half of `forward`."""
    return dense(params["text_projection"], _l2_normalize(text_emb.float()))


def alignment(projected_protein, projected_text):
    """Both directions' unnormalised similarity logits and the diagonal
    targets."""
    return {"protein2text": projected_protein @ projected_text.t(),
            "text2protein": projected_text @ projected_protein.t(),
            "targets": torch.arange(projected_protein.shape[0],
                                    device=projected_protein.device)}


def retrieval_accuracy(logits, targets):
    """Top-1 retrieval accuracy, a 0-d fp32 tensor."""
    return (torch.argmax(logits, dim=1) == targets).float().mean()
