"""BERT encoder: backs BERTScore with BioBERT-large (port of
`opus_pllm_tpu/models/bert.py`: `init` :21, `encode` :51, `make_embed_fn`
:81).

The reference computes BERTScore with `dmis-lab/biobert-large-cased-v1.1`
at num_layers=24 through torch (eval/metrics_computing_opi.py:57-70,
eval/metrics/bertscore). This is a post-LN BERT encoder whose last-layer
hidden states feed the greedy cosine matching in
`evals.metrics.bertscore_from_embeddings`, with the JAX module's parameter
tree (`core.convert.bert_from_jax` carries a JAX tree across). Attention
goes through `layers.attention`; at d = 64 in fp32 that is the plain path,
as in the JAX package, whose flash kernel refuses d % 128 != 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import BertConfig
from ..core.util import resolve_device, round_up
from . import layers
from .layers import attention, dense, embed, layer_norm, padding_mask


def init(cfg: BertConfig, *, generator: torch.Generator, device=None):
    """Random parameters drawn from `generator` (bert.py:21-48 scheme) on
    `device` (None: CUDA)."""
    device = resolve_device(device)
    kw = dict(generator=generator, device=device, dtype=cfg.torch_dtype)
    h = cfg.hidden_size
    norm = lambda: layers.norm_init(h, device=device, dtype=cfg.torch_dtype,
                                    bias=True)
    params = {
        "word_embeddings": layers.embed_init(cfg.vocab_size, h, **kw),
        "position_embeddings": layers.embed_init(
            cfg.max_position_embeddings, h, **kw),
        "token_type_embeddings": layers.embed_init(cfg.type_vocab_size, h,
                                                   **kw),
        "embed_norm": norm(),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "q_proj": layers.dense_init(h, h, bias=True, **kw),
            "k_proj": layers.dense_init(h, h, bias=True, **kw),
            "v_proj": layers.dense_init(h, h, bias=True, **kw),
            "o_proj": layers.dense_init(h, h, bias=True, **kw),
            "attn_norm": norm(),
            "fc1": layers.dense_init(h, cfg.intermediate_size, bias=True,
                                     **kw),
            "fc2": layers.dense_init(cfg.intermediate_size, h, bias=True,
                                     **kw),
            "ffn_norm": norm(),
        })
    return params


def encode(params, cfg: BertConfig, input_ids, attn_mask,
           token_type_ids=None):
    """(B, L) ids + bool mask -> final-layer hidden states (B, L, H).
    Post-LN (original BERT): residual add, then LayerNorm, after both the
    attention and the FFN."""
    b, l = input_ids.shape
    nh = cfg.num_heads
    hd = cfg.hidden_size // nh
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    pos = torch.arange(l, device=input_ids.device)[None, :]
    x = (embed(params["word_embeddings"], input_ids)
         + embed(params["position_embeddings"], pos)
         + embed(params["token_type_embeddings"], token_type_ids))
    x = layer_norm(params["embed_norm"], x, eps=cfg.layer_norm_eps)
    mask4 = padding_mask(attn_mask)
    for p in params["layers"]:
        q = dense(p["q_proj"], x).reshape(b, l, nh, hd)
        k = dense(p["k_proj"], x).reshape(b, l, nh, hd)
        v = dense(p["v_proj"], x).reshape(b, l, nh, hd)
        a = attention(q, k, v, mask4).reshape(b, l, cfg.hidden_size)
        x = layer_norm(p["attn_norm"], x + dense(p["o_proj"], a),
                       eps=cfg.layer_norm_eps)
        f = dense(p["fc2"], layers.gelu(dense(p["fc1"], x)))
        x = layer_norm(p["ffn_norm"], x + f, eps=cfg.layer_norm_eps)
    return x


def make_embed_fn(params, cfg: BertConfig, tokenizer, *,
                  max_tokens: int = 500, batch_size: int = 32,
                  len_bucket: int = 64):
    """Closure for `evals.metrics.compute_metrics(bert_embed_fn=...)`:
    texts -> numpy (embeddings (N, L, H) fp32, mask (N, L)) with CLS/SEP
    masked out, inputs truncated to `max_tokens` WordPieces
    (metrics_computing_opi.py:12), lengths rounded up to `len_bucket`, in
    batches of `batch_size`, on the device that holds the parameters."""
    device = params["word_embeddings"]["embedding"].device

    @torch.no_grad()
    def embed_texts(texts):
        encs = [tokenizer.encode(t, max_tokens=max_tokens) for t in texts]
        out_e, out_m = [], []
        for s in range(0, len(encs), batch_size):
            chunk = encs[s:s + batch_size]
            ln = round_up(max(len(e) for e in chunk), len_bucket)
            ids = np.full((len(chunk), ln), tokenizer.pad_id, np.int64)
            mask = np.zeros((len(chunk), ln), bool)
            content = np.zeros((len(chunk), ln), bool)
            for i, e in enumerate(chunk):
                ids[i, :len(e)] = e
                mask[i, :len(e)] = True
                content[i, 1:len(e) - 1] = True   # drop [CLS]/[SEP]
            emb = encode(params, cfg, torch.from_numpy(ids).to(device),
                         torch.from_numpy(mask).to(device))
            out_e.append(emb.float().cpu().numpy())
            out_m.append(content)
        ln = max(e.shape[1] for e in out_e)
        pe = np.zeros((len(encs), ln, out_e[0].shape[-1]), np.float32)
        pm = np.zeros((len(encs), ln), bool)
        row = 0
        for e, m in zip(out_e, out_m):
            pe[row:row + len(e), :e.shape[1]] = e
            pm[row:row + len(m), :m.shape[1]] = m
            row += len(e)
        return pe, pm

    return embed_texts
