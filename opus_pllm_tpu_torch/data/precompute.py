"""Offline embedding precompute (port of `opus_pllm_tpu/data/precompute.py`,
the whole module): `embed_sequences` (precompute.py:26),
`precompute_instruction_embeddings` (:47), `precompute_sequence_map` (:65)
and `precompute_cstp_pairs` (:76), the `precompute-embeddings` and
`precompute-pairs` steps.

Sequences are deduplicated, sorted by length and batched with their
tokens padded to a multiple of `len_bucket`, so ESM2 runs full batches
(through the four fused-encoder kernels on the card); sequences over
`MAX_PRECOMPUTE_LEN` residues are skipped, as the reference skips them.
The CSTP pairs pair each UniProt record's pooled ESM2 embedding with its
caption's causal-LM text embedding (`models.text_encoder`), whose prefill
runs the flash kernel at every decoder layer.

The files hold numpy fp32 arrays under the JAX module's keys, so each
package reads the other's output. Every function runs on `device` (None:
CUDA), where the parameters must lie.
"""

from __future__ import annotations

import json
import pickle
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..core.config import ESM2Config
from ..core.util import resolve_device, round_up
from ..models import esm2, text_encoder
from .datasets import UniProtQADataset

MAX_PRECOMPUTE_LEN = 4000


@torch.no_grad()
def embed_sequences(params, cfg: ESM2Config, seqs: Iterable[str], *,
                    batch_size: int = 16, len_bucket: int = 128,
                    max_len: int = MAX_PRECOMPUTE_LEN, impl: str = "auto",
                    device=None) -> Dict[str, np.ndarray]:
    """Dedup + length-bucket + batch-encode -> {sequence: (E,) fp32}."""
    device = resolve_device(device)
    uniq = [s for s in dict.fromkeys(seqs) if len(s) <= max_len]
    uniq.sort(key=len)
    out: Dict[str, np.ndarray] = {}
    for s in range(0, len(uniq), batch_size):
        chunk = uniq[s:s + batch_size]
        pad_to = round_up(max(len(c) for c in chunk) + 2, len_bucket)
        toks, _ = esm2.tokenize(chunk, max_len=pad_to)
        emb = esm2.pooled_embedding(
            params, cfg, torch.from_numpy(toks).to(device), impl=impl)
        for seq, e in zip(chunk, emb.cpu().numpy()):
            out[seq] = e
    return out


def _instruction_items(json_path: str):
    with open(json_path) as f:
        return [d for d in json.load(f) if d.get("input")]


def precompute_instruction_embeddings(params, cfg: ESM2Config,
                                      json_path: str, out_jsonl: str,
                                      **kw) -> int:
    """instruction JSON -> jsonl lines with an `input_embed` per item."""
    items = _instruction_items(json_path)
    table = embed_sequences(params, cfg, (d["input"] for d in items), **kw)
    n = 0
    with open(out_jsonl, "w") as f:
        for d in items:
            emb = table.get(d["input"])
            if emb is None:      # over max_len residues: skipped
                continue
            f.write(json.dumps({**d, "input_embed": emb.tolist()}) + "\n")
            n += 1
    return n


def precompute_sequence_map(params, cfg: ESM2Config, json_path: str,
                            out_json: str, **kw) -> int:
    """instruction JSON -> {sequence: embedding} dedup map."""
    items = _instruction_items(json_path)
    table = embed_sequences(params, cfg, (d["input"] for d in items), **kw)
    with open(out_json, "w") as f:
        json.dump({k: v.tolist() for k, v in table.items()}, f)
    return len(table)


@torch.no_grad()
def precompute_cstp_pairs(esm_params, esm_cfg: ESM2Config, llm_params,
                          llm_cfg, tokenizer, uniprot_pickle: str,
                          out_pickle: str, *, batch_size: int = 8,
                          max_text_len: int = 4096, len_bucket: int = 128,
                          mask_pad: bool = False, device=None,
                          stats: Optional[dict] = None) -> int:
    """UniProtQA pickle -> a pickle list of {"seq_embedding": (E,),
    "text_embedding": (H,)} fp32 pairs, one per record kept; returns the
    count. Captions are cut to `max_text_len` tokens and right-padded to a
    multiple of `len_bucket`, `batch_size` a batch. `stats`, when given,
    receives the seconds of the ESM2 and text halves ("esm_seconds",
    "text_seconds"), each ending with a device sync."""
    device = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
        else (lambda: None)
    ds = UniProtQADataset(uniprot_pickle)
    t0 = time.perf_counter()
    seq_table = embed_sequences(esm_params, esm_cfg,
                                (p["sequence"] for p in ds.pairs),
                                batch_size=batch_size, len_bucket=len_bucket,
                                device=device)
    sync()
    t1 = time.perf_counter()
    out = []
    for s in range(0, len(ds), batch_size):
        chunk = ds.pairs[s:s + batch_size]
        enc = [tokenizer.encode(c["text"])[:max_text_len] for c in chunk]
        pad_to = round_up(max(len(e) for e in enc), len_bucket)
        ids = np.full((len(chunk), pad_to), tokenizer.pad_token_id, np.int32)
        mask = np.zeros((len(chunk), pad_to), bool)
        for i, e in enumerate(enc):
            ids[i, :len(e)] = e
            mask[i, :len(e)] = True
        te = text_encoder.text_embeddings(
            llm_params, llm_cfg, torch.from_numpy(ids).to(device),
            torch.from_numpy(mask).to(device),
            mask_pad=mask_pad).cpu().numpy()
        for c, t in zip(chunk, te):
            out.append({"seq_embedding": seq_table[c["sequence"]],
                        "text_embedding": t})
    sync()
    if stats is not None:
        stats.update(esm_seconds=t1 - t0,
                     text_seconds=time.perf_counter() - t1)
    with open(out_pickle, "wb") as f:
        pickle.dump(out, f)
    return len(out)
