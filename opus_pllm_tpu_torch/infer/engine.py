"""Batched KV-cache generation (port of `opus_pllm_tpu/infer/engine.py`).

`cache_capacity` (engine.py:44), `advance_sampling` (:63), `nucleus_kth`
(:90), `sample_token` (:133) and `generate` (:207). Left-padded prompt
embeddings in, greedy or temperature + nucleus sampling out; the reference's
quirk `do_sample iff temperature > 0` is kept. The JAX `lax.while_loop`
becomes a Python loop with the same early exit once every row is done;
the KV cache is updated in place. Randomness comes from an explicit
`torch.Generator` on the logits' device (Gumbel-max over the warped
logits, as `jax.random.categorical` draws), so sampled tokens match the
JAX engine in distribution, not bit for bit.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from ..core.config import DecoderConfig
from ..models import decoder

# KV block of the JAX flash-attention kernel (flash_attention.py:30); kept
# as a literal so the capacity rounding matches without importing it
FLASH_BLOCK_K = 256


class GenerateOutput(NamedTuple):
    tokens: torch.Tensor    # (B, max_new) int32, pad_token after EOS
    lengths: torch.Tensor   # (B,) tokens generated incl. EOS
    steps: int              # decode steps run (<= max_new)
    decode_seconds: float   # wall time of the decode loop, device synced


def cache_capacity(cfg: DecoderConfig, l: int, max_new_tokens: int) -> int:
    """KV-cache capacity for an L-token prompt + max_new_tokens decode,
    rounded to 256 slots exactly where the JAX engine rounds it."""
    cap = l + max_new_tokens
    if cfg.head_dim % 128 == 0 and l % 8 == 0:
        cap = -(-cap // FLASH_BLOCK_K) * FLASH_BLOCK_K
    return cap


def nucleus_kth(probs, top_ps, *, iters: int = 50):
    """Per-row nucleus boundary probability by bisection, without a sort:
    kth = max{p : mass(probs >= p) >= top_p}. probs (..., V) fp32."""
    shape = probs.shape[:-1]
    tp = torch.as_tensor(top_ps, dtype=torch.float32,
                         device=probs.device).expand(shape)
    lo = torch.zeros(shape, dtype=torch.float32, device=probs.device)
    hi = torch.ones(shape, dtype=torch.float32, device=probs.device)
    zero = probs.new_zeros(())
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        mass = torch.where(probs >= mid[..., None], probs, zero).sum(-1)
        ge = mass >= tp
        lo = torch.where(ge, mid, lo)
        hi = torch.where(ge, hi, mid)
    return torch.where(probs <= hi[..., None], probs, zero).amax(-1)


def sample_token(logits, generator: torch.Generator, temperature: float,
                 top_p: float):
    """Temperature + nucleus sampling over (B, V) fp32 logits; argmax when
    temperature <= 0."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).int()
    logits = logits.float() / temperature
    if top_p < 1.0:
        probs = torch.softmax(logits, dim=-1)
        kth = nucleus_kth(probs, top_p)
        logits = torch.where(probs >= kth[:, None], logits,
                             torch.full_like(logits, float("-inf")))
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).int()


def advance_sampling(step: int, done, cur_logits, generator, out, tail,
                     nwritten, *, temperature, top_p, pad_token_id,
                     eos_token_id, stop_sequences, tail_len):
    """One decode step's sampling and stopping bookkeeping: EOS, the
    rolling stop-sequence tail, pad after done. Writes token `step` of
    `out` in place. Returns (next_token, new_done, tail, nwritten)."""
    nxt = sample_token(cur_logits, generator, temperature, top_p)
    nxt = torch.where(done, torch.full_like(nxt, pad_token_id), nxt)
    out[:, step] = nxt
    nwritten = nwritten + (~done).int()
    new_done = done | (nxt == eos_token_id)
    if tail_len > 0:
        tail = torch.cat([tail[:, 1:], nxt[:, None]], dim=1)
        for seq in stop_sequences:
            sl = len(seq)
            want = torch.tensor(seq, dtype=tail.dtype, device=tail.device)
            hit = (tail[:, tail_len - sl:] == want).all(dim=1)
            if step + 1 >= sl:
                new_done = new_done | hit
    return nxt, new_done, tail, nwritten


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(params, cfg: DecoderConfig, input_embeds, attn_mask, positions,
             generator: torch.Generator, *, max_new_tokens: int,
             temperature: float = 0.1, top_p: float = 0.7,
             eos_token_id: int = -1, pad_token_id: int = 0,
             stop_sequences: Optional[tuple] = None) -> GenerateOutput:
    """input_embeds (B, L, H) LEFT-padded; attn_mask/positions (B, L).

    Prefill runs causally over the prompt into a (B, 1, L, cap) mask and
    applies the vocab head to the last position only; then one token per
    step until max_new_tokens or every row has hit EOS or a stop
    sequence."""
    b, l, _ = input_embeds.shape
    dev = input_embeds.device
    dt = cfg.torch_dtype
    tail_len = (max(len(s) for s in stop_sequences) if stop_sequences
                else 0)
    cap = cache_capacity(cfg, l, max_new_tokens)
    cache = decoder.init_cache(cfg, b, cap, dtype=dt, device=dev)
    cache["mask"][:, :l] = attn_mask

    rows = torch.arange(l, device=dev)[None, None, :, None]
    cols = torch.arange(cap, device=dev)[None, None, None, :]
    pre_mask4 = cache["mask"][:, None, None, :] & (cols <= rows)
    hid, cache = decoder.forward(params, cfg, input_embeds.to(dt), positions,
                                 pre_mask4, cache, return_hidden=True)
    cur_logits = decoder.head_logits(params, cfg, hid[:, -1:])[:, 0].float()

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
        cache["mask"][:, l + step] = ~done
        step_mask4 = cache["mask"][:, None, None, :]
        lg, cache = decoder.forward(params, cfg, emb, pos, step_mask4, cache)
        cur_logits = lg[:, 0].float()
        done = new_done
        step += 1
    _sync(dev)
    return GenerateOutput(out, nwritten, step, time.perf_counter() - t0)
