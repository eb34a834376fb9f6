"""Sequence-sharded generation: the KV cache split over a ("seq",) group
of ranks (port of `opus_pllm_tpu/infer/sp_engine.py`,
`generate_seq_sharded` :47).

  prefill : ring attention (parallel/ring.ring_attention): each rank
            embeds and projects its own L/n slice of the prompt, the K/V
            shards rotate around the ring, and each rank's cache keeps its
            own shard (decoder impl="ring").
  decode  : every rank computes the new token's K/V and appends it to its
            local cache tail, but only the LAST rank marks those slots
            valid; attention is the LSE-merged partial softmax over the
            shards (ring.sharded_decode_attention, impl="sp_decode"): one
            MAX and two SUM all-reduces a layer and step.

The prompt's last real row (left padding) lies on the last rank, whose
logits are broadcast. Every rank then samples the same token from the
same logits with its own generator seeded alike (the tests check the
ranks' tokens are equal). Greedy output is token-identical to
`infer.engine.generate` on one device up to the softmax's reassociation.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.config import DecoderConfig
from ..models import decoder
from ..parallel.ring import SeqMesh
from .engine import GenerateOutput, _sync, advance_sampling, cache_capacity


@torch.no_grad()
def generate_seq_sharded(params, cfg: DecoderConfig, input_embeds,
                         attn_mask, positions, generator: torch.Generator,
                         *, mesh: SeqMesh, max_new_tokens: int,
                         temperature: float = 0.1, top_p: float = 0.7,
                         eos_token_id: int = -1, pad_token_id: int = 0,
                         stop_sequences: Optional[tuple] = None,
                         quantize_cache=False) -> GenerateOutput:
    """`engine.generate` over `mesh` (ring.make_sp_mesh), with its
    argument surface: LEFT-padded (B, L, H) prompt embeddings, the same on
    every rank. The prompt left-pads further to a multiple of the shard
    count so every rank owns an equal slice; the dynamic-NTK bound is the
    unsharded engine's (`cache_capacity` of the unpadded L)."""
    n, idx = mesh.size, mesh.index
    b, l, _ = input_embeds.shape
    dev = input_embeds.device
    dt = cfg.torch_dtype
    ctx = cache_capacity(cfg, l, max_new_tokens)
    l_pad = -(-l // n) * n
    if l_pad != l:
        pz = l_pad - l
        input_embeds = F.pad(input_embeds, (0, 0, pz, 0))
        attn_mask = F.pad(attn_mask, (pz, 0))
        positions = F.pad(positions, (pz, 0))
    l_loc = l_pad // n
    cap_loc = l_loc + max_new_tokens
    tail_len = (max(len(s) for s in stop_sequences) if stop_sequences
                else 0)
    sl = slice(idx * l_loc, (idx + 1) * l_loc)
    mask_s = attn_mask[:, sl]

    cache = decoder.init_cache(cfg, b, cap_loc, dtype=dt, device=dev,
                               quantize=quantize_cache)
    cache["mask"][:, :l_loc] = mask_s
    hid, cache = decoder.forward(params, cfg, input_embeds[:, sl].to(dt),
                                 positions[:, sl], mask_s, cache,
                                 impl="ring", return_hidden=True,
                                 ntk_ctx=ctx, sp=mesh)
    last = idx == n - 1
    if last:
        cur_logits = decoder.head_logits(params, cfg,
                                         hid[:, -1:])[:, 0].float()
    else:
        cur_logits = torch.empty((b, cfg.vocab_size), dtype=torch.float32,
                                 device=dev)
    dist.broadcast(cur_logits, src=mesh.ranks[-1], group=mesh.group)

    last_pos = positions[:, -1]
    out = torch.full((b, max_new_tokens), pad_token_id, dtype=torch.int32,
                     device=dev)
    tail = torch.full((b, max(tail_len, 1)), -1, dtype=torch.int32,
                      device=dev)
    nwritten = torch.zeros((b,), dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    step = 0
    while step < max_new_tokens and not bool(done.all()):
        nxt, new_done, tail, nwritten = advance_sampling(
            step, done, cur_logits, generator, out, tail, nwritten,
            temperature=temperature, top_p=top_p, pad_token_id=pad_token_id,
            eos_token_id=eos_token_id, stop_sequences=stop_sequences,
            tail_len=tail_len)
        emb = decoder.embed_tokens(params, nxt.long())[:, None].to(dt)
        pos = (last_pos + 1 + step)[:, None]
        # every rank appends the token's K/V; only the last one owns the
        # slot (a slot valid on one rank only, for the LSE merge)
        cache["mask"][:, l_loc + step] = ~done & last
        lg, cache = decoder.forward(params, cfg, emb, pos, cache["mask"],
                                    cache, impl="sp_decode", ntk_ctx=ctx,
                                    sp=mesh)
        cur_logits = lg[:, 0].float()
        done = new_done
        step += 1
    _sync(dev)
    return GenerateOutput(out, nwritten, step, time.perf_counter() - t0)
