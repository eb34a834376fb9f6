"""Batched KV-cache generation (port of `opus_pllm_tpu/infer/engine.py`).

`cache_capacity` (engine.py:44), `advance_sampling` (:63), `nucleus_kth`
(:90), `sample_token` (:133), the serving engine's per-row sampler
(`warp_logits_rows` :150, `warp_probs_rows` :179, `sample_token_rows`
:188), `generate` (:207) and `beam_generate` (:287). Left-padded prompt
embeddings in, greedy or temperature + nucleus sampling out; the reference's
quirk `do_sample iff temperature > 0` is kept. The JAX `lax.while_loop`
becomes a Python loop with the same early exit once every row is done;
the KV cache is updated in place. Randomness comes from an explicit
`torch.Generator` on the logits' device (Gumbel-max over the warped
logits, as `jax.random.categorical` draws), so sampled tokens match the
JAX engine in distribution, not bit for bit.

`generate`'s decode step is the sampler, run eagerly, then the one-token
forward (`DecodeStep`): one function of device tensors, captured once as a
CUDA graph and replayed at every later step where one process owns a CUDA
device, called directly elsewhere (the CPU, a tensor-parallel or FSDP
mesh).

`generate` records spans (`utils.observability`): `engine.prefill`
(device clock), `engine.decode` around the decode loop between its two
synchronizations (its host duration is `GenerateOutput.decode_seconds`),
and in each step `engine.stop_check` (the loop's one read of the device),
`engine.sample` and `engine.forward` (the step's input copies and its
forward: a graph's launch once captured). Counters: `decode.steps` (the
steps run) and `decode.graph_steps` (those whose forward was a replay);
for a routed family (deepseek_v2) the decode forwards' routing, tallied on
the device inside the step (`decoder.MoETally`) and read once at the end:
`moe.pairs`, `moe.experts_hit` (experts with a pair, summed over the
forwards and routed layers), `moe.busiest` (the busiest expert's pairs,
summed alike) and `moe.slots` (routed layers x experts x forwards).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from ..core.config import DecoderConfig
from ..kernels import (decode_attention, flash_attention, flash_attention_bwd,
                       fused_encoder, moe, quant, quant4)
from ..models import decoder
from ..utils.observability import count, prof_range, ranged, span

# KV block of the JAX flash-attention kernel (flash_attention.py:30); kept
# as a literal so the capacity rounding matches without importing it
FLASH_BLOCK_K = 256
# the modules whose hand-written kernels count their launches (`launches`)
KERNELS = (decode_attention, flash_attention, flash_attention_bwd,
           fused_encoder, moe, quant, quant4)


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
    with prof_range("engine.nucleus_kth"):
        for _ in ranged(range(iters), "engine.nucleus_kth.passes", 10):
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
    return _categorical(logits, generator)


def _categorical(logits, generator: torch.Generator):
    """One draw per row from softmax(logits) (Gumbel-max)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).int()


def warp_logits_rows(logits, temps, top_ps, *, nucleus: bool = True):
    """Per-row temperature scaling + HF nucleus mask over (..., V) fp32
    logits; temps/top_ps (tensors) broadcast to logits.shape[:-1]. The one
    definition of the serving engine's sampling distribution.

    Greedy rows (temperature <= 0) pass through UNWARPED by the nucleus:
    they are divided by 1e-6 and left whole, because `sample_token_rows`
    gives them the argmax. The nucleus pass runs for rows with top_p < 1
    and temperature > 0. `nucleus=False` skips it for the whole batch: the
    caller decides it from its host state (the JAX `lax.cond` over
    any(need), without a device-to-host read); it must be True whenever
    any row needs the pass."""
    t = torch.as_tensor(temps, dtype=torch.float32,
                        device=logits.device).expand(logits.shape[:-1])
    tp = torch.as_tensor(top_ps, dtype=torch.float32,
                         device=logits.device).expand(logits.shape[:-1])
    lg = logits.float() / torch.clamp_min(t, 1e-6)[..., None]
    if not nucleus:
        return lg
    need = (tp < 1.0) & (t > 0.0)
    probs = torch.softmax(lg, dim=-1)
    kth = nucleus_kth(probs, tp)
    drop = need[..., None] & (probs < kth[..., None])
    return torch.where(drop, torch.full_like(lg, float("-inf")), lg)


def warp_probs_rows(logits, temps, top_ps, *, nucleus: bool = True):
    """softmax of `warp_logits_rows`: the distribution sampled from."""
    return torch.softmax(warp_logits_rows(logits, temps, top_ps,
                                          nucleus=nucleus), dim=-1)


def sample_token_rows(logits, generator: torch.Generator, temps, top_ps, *,
                      nucleus: bool = True):
    """Per-row temperature + nucleus sampling over (B, V) fp32 logits, each
    row with its own temperature and top_p; rows with temperature <= 0 take
    the argmax. Randomness from `generator`."""
    greedy = torch.argmax(logits, dim=-1).int()
    sampled = _categorical(warp_logits_rows(logits, temps, top_ps,
                                            nucleus=nucleus), generator)
    t = torch.as_tensor(temps, device=logits.device)
    return torch.where(t > 0, sampled, greedy)


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


def _graphable(device, cfg: DecoderConfig) -> bool:
    """Whether the decode step runs as a CUDA graph: where one process owns
    a CUDA device. Under a tensor-parallel or FSDP mesh each layer's
    collectives stay eager."""
    return device.type == "cuda" and cfg.tp is None and cfg.fsdp is None


_SIDE_STREAMS: dict = {}


def _side_stream(device):
    """The device's one stream for warm-ups and captures (cuBLAS sets up a
    workspace for each stream it runs on: one stream, one workspace)."""
    key = torch.cuda.current_device() if device.index is None \
        else device.index
    if key not in _SIDE_STREAMS:
        _SIDE_STREAMS[key] = torch.cuda.Stream(device=key)
    return _SIDE_STREAMS[key]


class DecodeStep:
    """The one-token forward of a decode step: the sampled tokens'
    embedding, the decoder over `cache`, the head and the fp32 logits, as
    one function of device tensors (`forward`). A call writes its inputs
    in place (the token ids, the positions, the cache slot as a 0-dim
    tensor), so the function reads nothing from the host, and returns the
    logits (B, V).

    Where one process owns a CUDA device (`_graphable`), the first call
    runs the function on a side stream (its warm-up), the second captures
    it there as a CUDA graph in thread-local mode (another thread, such as
    the runner's prefetch, may copy to the card meanwhile) and replays it,
    as does every later call; `logits` is then the graph's output buffer.
    Elsewhere every call runs the function directly. A failed capture
    raises. A replay adds the launches its capture recorded to the
    hand-written kernels' counters, which the capture itself leaves as
    they were."""

    def __init__(self, params, cfg: DecoderConfig, cache, *, pos_dtype,
                 impl: str, ntk_ctx: int):
        self.params, self.cfg, self.impl = params, cfg, impl
        self.ntk_ctx = ntk_ctx
        self.layers, self.mask = cache["layers"], cache["mask"]
        b, dev = self.mask.shape[0], self.mask.device
        self.device = dev
        self.tok = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((b, 1), dtype=pos_dtype, device=dev)
        self.slot = torch.zeros((), dtype=torch.long, device=dev)
        self.graphed = _graphable(dev, cfg)
        self.tally = (decoder.MoETally(cfg, dev)
                      if cfg.family == decoder.MLA else None)
        self.calls = self.replays = 0
        self.graph = self.logits = None
        self.recorded = []       # (counters, kernel, launches) a replay adds

    def forward(self):
        """The step function: fp32 logits (B, V) of the tokens `tok` at
        positions `pos`, their keys and values written at slot `slot`."""
        emb = decoder.embed_tokens(self.params, self.tok.long())[:, None]
        view = {"layers": self.layers, "index": self.slot,
                "mask": self.mask}
        lg, _ = decoder.forward(self.params, self.cfg,
                                emb.to(self.cfg.torch_dtype), self.pos,
                                self.mask[:, None, None, :], view,
                                impl=self.impl, ntk_ctx=self.ntk_ctx,
                                moe_tally=self.tally)
        return lg[:, 0].float()

    def __call__(self, tokens, positions, slot: int):
        """tokens (B,), positions (B, 1), slot: the cache slot they take."""
        self.tok.copy_(tokens)
        self.pos.copy_(positions)
        self.slot.fill_(slot)
        self.calls += 1
        if self.graph is not None:
            self._replay()
        elif not self.graphed:
            self.logits = self.forward()
        elif self.calls == 1:
            self.logits = self._warm_up()
        else:
            self._capture()
            self._replay()
        return self.logits

    def _warm_up(self):
        here, side = torch.cuda.current_stream(self.device), \
            _side_stream(self.device)
        side.wait_stream(here)
        with torch.cuda.stream(side):
            out = self.forward()
        here.wait_stream(side)
        return out

    def _capture(self):
        before = [dict(m.launches) for m in KERNELS]
        side = _side_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.logits = self.forward()
            finally:
                graph.capture_end()
        for counters, was in zip((m.launches for m in KERNELS), before):
            for name, n in counters.items():
                if n != was[name]:
                    self.recorded.append((counters, name, n - was[name]))
                    counters[name] = was[name]
        self.graph = graph

    def _replay(self):
        self.graph.replay()
        self.replays += 1
        for counters, name, n in self.recorded:
            counters[name] += n


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _running(done) -> bool:
    """The decode loop's test: some row not done (a read of the device)."""
    with span("engine.stop_check"):
        return not bool(done.all())


@torch.no_grad()
def generate(params, cfg: DecoderConfig, input_embeds, attn_mask, positions,
             generator: torch.Generator, *, max_new_tokens: int,
             temperature: float = 0.1, top_p: float = 0.7,
             eos_token_id: int = -1, pad_token_id: int = 0,
             stop_sequences: Optional[tuple] = None, quantize_cache=False,
             impl: str = "auto") -> GenerateOutput:
    """input_embeds (B, L, H) LEFT-padded; attn_mask/positions (B, L).

    Prefill runs causally over the prompt into a (B, 1, L, cap) mask and
    applies the vocab head to the last position only; then one token per
    step until max_new_tokens or every row has hit EOS or a stop
    sequence. quantize_cache: False, True/"int8" or "int4" KV cache
    (decoder.init_cache); impl: the decoder's kernel choice
    (engine.py:207-227)."""
    b, l, _ = input_embeds.shape
    dev = input_embeds.device
    dt = cfg.torch_dtype
    tail_len = (max(len(s) for s in stop_sequences) if stop_sequences
                else 0)
    cap = cache_capacity(cfg, l, max_new_tokens)
    with span("engine.prefill", device=dev):
        cache = decoder.init_cache(cfg, b, cap, dtype=dt, device=dev,
                                   quantize=quantize_cache)
        cache["mask"][:, :l] = attn_mask

        rows = torch.arange(l, device=dev)[None, None, :, None]
        cols = torch.arange(cap, device=dev)[None, None, None, :]
        pre_mask4 = cache["mask"][:, None, None, :] & (cols <= rows)
        # ntk_ctx: the cache capacity, the dynamic-NTK bound the JAX
        # forward derives from its cache (engine.py:44-53)
        hid, cache = decoder.forward(params, cfg, input_embeds.to(dt),
                                     positions, pre_mask4, cache, impl=impl,
                                     return_hidden=True, ntk_ctx=cap)
        cur_logits = decoder.head_logits(params, cfg, hid[:, -1:],
                                         impl=impl)[:, 0].float()

    last_pos = positions[:, -1]
    forward = DecodeStep(params, cfg, cache, pos_dtype=positions.dtype,
                         impl=impl, ntk_ctx=cap)
    out = torch.full((b, max_new_tokens), pad_token_id, dtype=torch.int32,
                     device=dev)
    tail = torch.full((b, max(tail_len, 1)), -1, dtype=torch.int32,
                      device=dev)
    nwritten = torch.zeros((b,), dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    _sync(dev)
    t0 = time.perf_counter_ns()
    step = 0
    with span("engine.decode") as decode:
        while step < max_new_tokens and _running(done):
            with span("engine.sample"):
                nxt, new_done, tail, nwritten = advance_sampling(
                    step, done, cur_logits, generator, out, tail, nwritten,
                    temperature=temperature, top_p=top_p,
                    pad_token_id=pad_token_id, eos_token_id=eos_token_id,
                    stop_sequences=stop_sequences, tail_len=tail_len)
            with span("engine.forward"):
                cache["mask"][:, l + step] = ~done
                cur_logits = forward(nxt, (last_pos + 1 + step)[:, None],
                                     l + step)
            done = new_done
            step += 1
        _sync(dev)
    count("decode.steps", step)
    count("decode.graph_steps", forward.replays)
    if forward.tally is not None:
        moe_counts = forward.tally.read()
        count("moe.pairs", moe_counts["pairs"])
        count("moe.experts_hit", moe_counts["hit"])
        count("moe.busiest", moe_counts["busiest"])
        count("moe.slots", forward.tally.pairs.numel() * forward.calls)
    # the span's own interval when the recorder is on
    ns = decode.host_ns if decode is not None else time.perf_counter_ns() - t0
    return GenerateOutput(out, nwritten, step, ns / 1e9)


NEG_INF = -1.0e9   # HF beam search's masking constant (engine.py:284)


def _top(x, k: int):
    """The k largest of fp32 `x` along the last dim, ties to the lower
    index (`jax.lax.top_k`'s order, and `argmax`'s: a quantized head's
    logits are bf16 values, which tie): (values, int64 indices). One
    `topk` over int64 keys: the float's bits mapped to an order-keeping
    integer, above the index's complement."""
    i = x.contiguous().view(torch.int32).long()
    ordered = torch.where(i >= 0, i, -(i + 2 ** 31) - 1)
    n = x.shape[-1]
    pos = torch.arange(n, device=x.device, dtype=torch.int64)
    key, _ = torch.topk(ordered * 2 ** 32 + (2 ** 32 - 1 - pos), k, dim=-1)
    idx = 2 ** 32 - 1 - (key & (2 ** 32 - 1))
    return torch.gather(x, -1, idx), idx


@torch.no_grad()
def beam_generate(params, cfg: DecoderConfig, input_embeds, attn_mask,
                  positions, *, num_beams: int, max_new_tokens: int,
                  eos_token_id: int = -1, pad_token_id: int = 0,
                  length_penalty: float = 1.0, quantize_cache=False,
                  impl: str = "auto") -> GenerateOutput:
    """Beam search over left-padded prompt embeddings (the reference's
    --num_beams, run_opus_ddp.py:156-158), with transformers' static beam
    rules as engine.py:287-418 has them (do_sample off, early_stopping
    off): 2K candidates a step, only the top K ranks may finish, scores
    the summed logprobs over generated length ** length_penalty, and the
    stop once no running beam can beat the worst finished hypothesis.

    The prefill runs once on the B rows; its cache is tiled to B * K rows
    (`decoder.tile_cache`) and every step hands each surviving beam its
    parent's rows (`decoder.reorder_cache`). The loop reads one boolean a
    step on the host (the JAX while_loop's condition). Returns the best
    finished hypothesis per row: tokens with the terminal EOS, padded with
    pad_token_id; lengths count the EOS; steps the beam steps run."""
    decoder.refuse_deepseek(cfg, "beam search")
    k, k2 = num_beams, 2 * num_beams
    b, l, _ = input_embeds.shape
    v = cfg.vocab_size
    dev = input_embeds.device
    dt = cfg.torch_dtype
    cap = cache_capacity(cfg, l, max_new_tokens)
    cache = decoder.init_cache(cfg, b, cap, dtype=dt, device=dev,
                               quantize=quantize_cache)
    cache["mask"][:, :l] = attn_mask
    rows = torch.arange(l, device=dev)[None, None, :, None]
    cols = torch.arange(cap, device=dev)[None, None, None, :]
    pre_mask4 = cache["mask"][:, None, None, :] & (cols <= rows)
    hid, cache = decoder.forward(params, cfg, input_embeds.to(dt), positions,
                                 pre_mask4, cache, impl=impl,
                                 return_hidden=True, ntk_ctx=cap)
    cur_logits = decoder.head_logits(params, cfg, hid[:, -1:],
                                     impl=impl)[:, 0].float()
    cache = decoder.tile_cache(cache, k)
    cur_logits = cur_logits.repeat_interleave(k, dim=0)
    last_pos = positions[:, -1].repeat_interleave(k, dim=0)      # (B*K,)

    top_mask = torch.arange(k2, device=dev) < k                  # (2K,)
    batch_off = torch.arange(b, device=dev)[:, None] * k         # (B, 1)
    gather = lambda x, idx: torch.gather(
        x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
            idx.shape + x.shape[2:]))
    run_seq = torch.full((b, k, max_new_tokens), pad_token_id,
                         dtype=torch.int32, device=dev)
    run_sc = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    run_sc[:, 0] = 0.0
    fin_seq = run_seq.clone()
    fin_sc = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    fin_done = torch.zeros((b, k), dtype=torch.bool, device=dev)
    fin_len = torch.zeros((b, k), dtype=torch.int32, device=dev)
    improve_ok = torch.ones((b, 1), dtype=torch.bool, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    gen_i = 0
    while gen_i < max_new_tokens:
        logp = torch.log_softmax(cur_logits, dim=-1)             # (B*K, V)
        cand = (logp.reshape(b, k, v) + run_sc[:, :, None]).reshape(b, k * v)
        topv, topi = _top(cand, k2)                              # (B, 2K)
        tok = (topi % v).int()
        parent = topi // v
        topk_seq = gather(run_seq, parent)                       # (B, 2K, T)
        topk_seq[:, :, gen_i] = tok
        hits = (tok == eos_token_id) | (gen_i + 1 >= max_new_tokens)

        # the running beams: the best K continuations that did not finish
        run_cand = topv + hits.float() * NEG_INF
        new_run_sc, idx2 = _top(run_cand, k)
        new_run_seq = gather(topk_seq, idx2)
        parent_sel = torch.gather(parent, 1, idx2)

        # the finished hypotheses (only the top K ranks may finish)
        norm = torch.tensor(float(gen_i + 1), device=dev) ** length_penalty
        fin_gate = hits & top_mask[None, :] & improve_ok
        fin_cand = torch.where(fin_gate, topv / norm,
                               torch.full_like(topv, NEG_INF))
        m_sc = torch.cat([fin_sc, fin_cand], dim=1)              # (B, 3K)
        m_seq = torch.cat([fin_seq, topk_seq], dim=1)
        m_done = torch.cat([fin_done, fin_gate], dim=1)
        m_len = torch.cat([fin_len, torch.full((b, k2), gen_i + 1,
                                               dtype=torch.int32,
                                               device=dev)], dim=1)
        fin_sc, idx3 = _top(m_sc, k)
        fin_seq = gather(m_seq, idx3)
        fin_done = torch.gather(m_done, 1, idx3)
        fin_len = torch.gather(m_len, 1, idx3)

        # each surviving beam takes its parent's cache rows
        cache = decoder.reorder_cache(
            cache, (parent_sel + batch_off).reshape(-1))
        nxt = new_run_seq[:, :, gen_i].reshape(-1)               # (B*K,)
        emb = decoder.embed_tokens(params, nxt.long())[:, None].to(dt)
        pos = (last_pos + 1 + gen_i)[:, None]
        cache["mask"][:, l + gen_i] = True
        lg, cache = decoder.forward(params, cfg, emb, pos,
                                    cache["mask"][:, None, None, :], cache,
                                    impl=impl, ntk_ctx=cap)
        cur_logits = lg[:, 0].float()
        run_seq, run_sc = new_run_seq, new_run_sc

        # can a running beam still beat the worst finished hypothesis?
        best_possible = new_run_sc[:, :1] / norm
        worst_fin = torch.where(fin_done,
                                fin_sc.amin(dim=1, keepdim=True),
                                torch.full_like(fin_sc, NEG_INF))
        improve_ok = improve_ok & (best_possible > worst_fin).any(
            dim=-1, keepdim=True)
        gen_i += 1
        if not bool((improve_ok.any() & ~hits.all()).item()):
            break
    _sync(dev)
    return GenerateOutput(fin_seq[:, 0], fin_len[:, 0], gen_i,
                          time.perf_counter() - t0)
