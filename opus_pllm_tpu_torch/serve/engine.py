"""Continuous-batching serving engine (port of
`opus_pllm_tpu/serve/engine.py`).

A fixed pool of `max_slots` sequence slots shares one KV cache on the
device, updated in place. Slot bookkeeping (lengths, budgets, temperatures,
eos ids, adapters) lives in a host numpy mirror that follows the device's
transition rules exactly, so the host never has to ask the device for it.

* A decode tick advances every slot by `steps_per_tick` tokens (a Python
  loop of decoder steps in place of the JAX `lax.scan`), with per-slot
  cache writes through the decoder's (B,)-indexed path. Its input and
  output slot state is one packed (8, max_slots + 1) fp32 tensor that
  stays on the device from tick to tick.
* New requests join between ticks, grouped by (prompt bucket, prefix) and
  padded to a power of two: each group is one bucketed prefill over a
  scratch cache (Sq = bucket, Skv = prefix + bucket: the flash kernel's
  shape, and with int8 weights M = n x bucket rows for the int8 kernel),
  merged into the admitted slots, with each first token sampled on the
  device.
* Multi-LoRA: a bank ({proj: (layers, C+1, in, r)}, `lora.make_bank`)
  serves a different adapter on every slot. Each tick, and each admission
  group, gathers its rows' adapters once ((layers, rows, in, r)); the last
  bank row is the zero adapter of base-only requests. `add_adapter` /
  `remove_adapter` write a bank row in place.
* Self-speculative ticks (`draft_layers=N`, `spec_k=K`): each iteration
  the target's first N layers propose K-1 tokens, one K-token forward of
  the whole target verifies them (`infer.speculative.accept_and_emit`:
  greedy rows token-identical to plain decode, sampled rows
  rejection-verified), and each slot advances by its own 1..K tokens. The
  draft writes its keys and values into the first N layers of the big
  cache in place (the JAX draft writes a functional copy and drops it):
  the verify pass rewrites slots length .. length+K-1 of every layer
  before it attends, and inactive rows write at max_len, which drops, so
  the cache ends as the JAX engine's. `spec_adaptive` falls back to plain
  ticks while acceptance does not pay for the draft, with a probe tick
  every 32 plain ones.
* Prefix cache: `register_prefix` computes a shared prompt prefix's keys
  and values once; requests with its `prefix_id` prefill only their
  suffix over a scratch cache loaded with it.
* Chunked prefill (`chunk_prefill=C`): a prompt past the largest bucket
  claims a slot and prefills C tokens a tick, each chunk written straight
  into its slot's rows of the big cache (the decoder's `rows` path; the
  JAX engine gathers the group's rows and scatters them back whole, which
  leaves the same state), while the other slots keep decoding.
* Tensor parallelism (`mesh`, a core.mesh.Mesh of data 1;
  serve/engine.py:197-211, :259-265, :359): the engine shards a whole
  tree itself (`parallel.partition.shard_decoder`) or takes a rank's
  share as it is; the cache holds the rank's KV heads ((B, S, Hkv/M, D),
  head-major for quantized leaves) and the bank its slice of each
  projection. Every rank runs the same host scheduler on the same
  (gathered) logits, so their slots stay in step.
* The depth-1 pipeline: a tick's tokens (and an admission's first tokens)
  are copied to the host only when that entry is processed, after the next
  tick has been issued, so the host issues tick t + 1 while the card runs
  tick t. Nothing inside a tick reads the device: the nucleus pass is
  gated by a Python bool from the host mirror, cache writes past capacity
  drop on the device, and host arrays go up through pinned buffers.
* Slots whose occupant provably finishes within the in-flight ticks are
  handed to the next request without draining the pipeline ("parking"):
  each tick's tokens route through the owner snapshot taken when it was
  issued. A speculative iteration emits 1 to K tokens, so the proof uses
  the guaranteed minimum (`_inflight_steps_min`) and the "may have
  finished" drain test the upper bound (`_inflight_steps`).

Greedy results are token-identical to the JAX engine and to
`infer.engine.generate` run per request (tests/test_torch_serve.py,
tests/test_torch_serve_options.py).

Ported: `ServeRequest` (:65), `Completion` (:92), `_RowState` (:98),
`_bucket` (:118), `LatencyHistogram` (:125) and `ServingEngine` (:182)
with its bank, speculative ticks, prefix cache, chunked prefill, mesh
and scheduler. The padding rows of an admission group are not merged
anywhere (the JAX engine scatters them to the trash row, index
max_slots, which stays an inactive decode row here), and a chunk group
is not padded. Not
ported: `warmup` (a jit warm-up) is not needed: PyTorch runs eagerly.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import DecoderConfig
from ..infer.engine import (_categorical, sample_token_rows,
                            warp_logits_rows, warp_probs_rows)
from ..infer.speculative import accept_and_emit, draft_from_target
from ..lora.lora import make_bank, stack_adapter
from ..models import decoder


@dataclasses.dataclass
class ServeRequest:
    """One generation request. `embeds` (P, H): an already-embedded prompt,
    a tensor (best on the engine's device: no host round trip) or a numpy
    array; or `token_ids` (P,) to embed from the vocabulary. With
    `prefix_id` (register_prefix) the prompt is only the suffix after the
    shared prefix. `adapter_id` names a bank adapter (None: the base
    weights). `on_tokens`, if set, is called from `step` with each batch of
    new tokens (EOS never included)."""
    request_id: Any
    embeds: Optional[Any] = None
    token_ids: Optional[np.ndarray] = None
    max_new_tokens: int = 128
    temperature: float = 0.0
    top_p: float = 1.0
    eos_token_id: int = -1
    prefix_id: Optional[Any] = None
    on_tokens: Optional[Any] = None
    adapter_id: Optional[str] = None


@dataclasses.dataclass
class Completion:
    request_id: Any
    tokens: List[int]
    finish_reason: str          # "eos" | "length" | "cancelled"


class _RowState:
    """Per-REQUEST decode mirror: budget and emitted tokens travel with the
    request, not the slot, so a slot can serve the next request while the
    previous occupant's last ticks are in flight (serve/engine.py:98)."""

    __slots__ = ("req", "remaining", "tokens", "done")

    def __init__(self, req: ServeRequest):
        self.req = req
        self.remaining = req.max_new_tokens   # budget left incl. unfetched
        self.tokens: List[int] = []
        self.done = False


def _bucket(n: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


class LatencyHistogram:
    """Fixed upper bounds, per-bucket counts, running sum and count
    (serve/engine.py:125)."""

    DEFAULT_BOUNDS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                      1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

    def __init__(self, bounds: Tuple[float, ...] = DEFAULT_BOUNDS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Upper-bound estimate of the q-quantile (0..1): the first bucket
        bound whose cumulative count reaches q of the total."""
        if not self.count:
            return 0.0
        target = q * self.count
        cum = 0
        for b, c in zip(self.bounds, self.counts):
            cum += c
            if cum >= target:
                return b
        return float("inf")

    def prometheus(self, name: str) -> List[str]:
        """Text-exposition lines: cumulative `le` buckets, sum, count."""
        lines = [f"# TYPE {name} histogram"]
        cum = 0
        for b, c in zip(self.bounds, self.counts):
            cum += c
            lines.append(f'{name}_bucket{{le="{b}"}} {cum}')
        lines.append(f'{name}_bucket{{le="+Inf"}} {self.count}')
        lines.append(f"{name}_sum {self.sum}")
        lines.append(f"{name}_count {self.count}")
        return lines


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without waiting for the device: a
    pinned staging buffer and an asynchronous copy (a pageable copy would
    wait for every queued kernel, the in-flight tick included)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def admission_inputs(n_valid, bucket: int, plen: int = 0):
    """Positions (n, bucket) and mask (n, 1, bucket, plen + bucket) of one
    admission group's prefill: query i of row r attends every prefix key
    and the suffix keys j <= i with j < n_valid[r], at positions plen + i
    (serve/engine.py:831-859)."""
    ar = torch.arange(bucket, device=n_valid.device)
    valid = ar[None, :] < n_valid[:, None]
    pos = (plen + ar)[None, :] * valid
    kv = torch.arange(plen + bucket, device=n_valid.device)[
        None, None, None, :] - plen
    mask4 = (kv < 0) | ((kv <= ar[None, None, :, None])
                        & (kv < n_valid[:, None, None, None]))
    return pos, mask4


def chunk_inputs(n_valid, off, chunk: int, cap: int):
    """Positions (n, chunk) and mask (n, 1, chunk, cap) of one chunked
    prefill step: row r's query i sits at off[r] + i and attends every
    earlier slot and the chunk's keys j <= i with j < n_valid[r]
    (serve/engine.py:953-968)."""
    ar = torch.arange(chunk, device=n_valid.device)
    pos = (off[:, None] + ar[None, :]) * (ar[None, :] < n_valid[:, None])
    rel = torch.arange(cap, device=n_valid.device)[None, None, None, :] \
        - off[:, None, None, None]
    mask4 = (rel < 0) | ((rel <= ar[None, None, :, None])
                         & (rel < n_valid[:, None, None, None]))
    return pos, mask4


def verify_mask(length, k: int, cap: int):
    """(B, 1, K, cap) mask of a speculative verify pass: chunk row j of
    slot b attends slots [0, length[b] + j] (serve/engine.py:726-730)."""
    cols = torch.arange(cap, device=length.device)[None, None, None, :]
    rows = torch.arange(k, device=length.device)[None, None, :, None]
    return cols <= (length[:, None, None, None] + rows)


@torch.no_grad()
def pin_prefix(params, cfg: DecoderConfig, emb, *, max_len: int,
               quantize=False, impl: str = "auto") -> Dict[str, Any]:
    """A prompt prefix's keys and values, computed once: emb (P, H) ->
    {"layers": a 1-row cache of P slots, "len": P}
    (serve/engine.py:393-422). ntk_ctx is the decode cache's capacity."""
    plen = emb.shape[0]
    cache = decoder.init_cache(cfg, 1, plen, device=emb.device,
                               quantize=quantize)
    ar = torch.arange(plen, device=emb.device)
    mask4 = ar[None, None, None, :] <= ar[None, None, :, None]
    decoder.forward(params, cfg, emb.to(cfg.torch_dtype)[None], ar[None],
                    mask4, cache, impl=impl, return_hidden=True,
                    ntk_ctx=max_len)
    return {"layers": cache["layers"], "len": plen}


@torch.no_grad()
def prefill_group(params, cfg: DecoderConfig, embs, n_valid, bucket: int, *,
                  max_len: int, quantize=False, prefix=None, lora=None,
                  lora_scale: float = 1.0, impl: str = "auto"):
    """One admission group's prefill (serve/engine.py:801-903): embs (n,
    bucket, H) with n_valid (n,) valid rows each, over a scratch cache of
    prefix + bucket slots loaded with the pinned `prefix` (pin_prefix)
    when given. Returns (the fp32 logits (n, V) at each row's last valid
    position, the scratch cache)."""
    n, dev = embs.shape[0], embs.device
    plen = prefix["len"] if prefix is not None else 0
    pos, mask4 = admission_inputs(n_valid, bucket, plen)
    scratch = decoder.init_cache(cfg, n, plen + bucket, device=dev,
                                 quantize=quantize)
    if prefix is not None:
        # the prefix rows broadcast into every scratch row; quantized
        # leaves are head-major, so the slot dim comes after H
        for sl, pl in zip(scratch["layers"], prefix["layers"]):
            for name in ("k", "v"):
                if isinstance(sl[name], dict):
                    for key, buf in sl[name].items():
                        buf[:, :, :plen] = pl[name][key]
                else:
                    sl[name][:, :plen] = pl[name]
        scratch["index"] = plen
    # ntk_ctx pins the dynamic-NTK base to the decode cache's capacity:
    # the scratch cache is narrower (serve/engine.py:861-869)
    hid, scratch = decoder.forward(params, cfg, embs, pos, mask4, scratch,
                                   lora=lora, lora_scale=lora_scale,
                                   impl=impl, return_hidden=True,
                                   ntk_ctx=max_len)
    # the head on each row's last valid position only
    last_h = hid[torch.arange(n, device=dev), (n_valid - 1).clamp_min(0)]
    return decoder.head_logits(params, cfg, last_h[:, None],
                               impl=impl)[:, 0].float(), scratch


@torch.no_grad()
def chunk_logits(params, cfg: DecoderConfig, cache, embs, n_valid, off,
                 rows, *, max_len: int, lora=None, lora_scale: float = 1.0,
                 impl: str = "auto"):
    """One chunked-prefill step (serve/engine.py:931-987): embs (n, C, H)
    with n_valid (n,) valid rows each, written at offsets off (n,) of the
    cache rows `rows` (n,) in place, attending [0, off + valid). Returns
    the fp32 logits (n, V) at each row's last valid position."""
    n, dev = embs.shape[0], embs.device
    pos, mask4 = chunk_inputs(n_valid, off, embs.shape[1], max_len)
    view = {"layers": cache["layers"], "index": off, "rows": rows,
            "mask": cache["mask"]}
    hid, _ = decoder.forward(params, cfg, embs, pos, mask4, view,
                             lora=lora, lora_scale=lora_scale, impl=impl,
                             return_hidden=True, ntk_ctx=max_len)
    last_h = hid[torch.arange(n, device=dev), (n_valid - 1).clamp_min(0)]
    return decoder.head_logits(params, cfg, last_h[:, None],
                               impl=impl)[:, 0].float()


class ServingEngine:
    """Slot-based continuous batching over a fixed decoder, on the device
    that holds `params`.

    max_slots: concurrent sequences; max_len: per-slot KV capacity (prefix
    + prompt + generation); prefill_buckets: prompt paddings (ascending);
    steps_per_tick: decode steps (speculative iterations) per tick;
    admit_min_free: admit only once this many slots are free (or the queue
    is shorter). lora_bank {name: adapter tree} (folded, unmerged) with
    `adapter_capacity` rows and `lora_scale`; draft_layers / spec_k /
    spec_adaptive: self-speculative ticks; chunk_prefill: the chunk width
    for prompts past the largest bucket."""

    def __init__(self, params, cfg: DecoderConfig, *, max_slots: int = 8,
                 max_len: int = 512,
                 prefill_buckets: Tuple[int, ...] = (64, 128, 256),
                 quantize_cache=False, seed: int = 0,
                 steps_per_tick: int = 1, admit_min_free: int = 1,
                 lora_bank=None, lora_scale: float = 1.0, mesh=None,
                 chunk_prefill: Optional[int] = None,
                 adapter_capacity: Optional[int] = None,
                 draft_layers: Optional[int] = None, spec_k: int = 4,
                 spec_adaptive: bool = True):
        decoder.refuse_deepseek(cfg, "the serving engine")
        if mesh is not None:
            # tensor-parallel serving (serve/engine.py:197-211): this rank
            # holds its heads' cache and its slice of every projection;
            # the host scheduler runs alike on every rank
            if mesh.data != 1:
                raise ValueError("the engine shards tensor-parallel only: "
                                 "a mesh of data 1 (--mesh 1,N; the slot "
                                 "pool is the batch axis)")
            if cfg.tp is None and mesh.model > 1:
                from ..parallel import partition
                params, cfg = partition.shard_decoder(params, cfg, mesh)
        self.params = params
        self.cfg = cfg
        self.device = params["embed_tokens"]["embedding"].device
        # multi-LoRA: one gatherable tensor per projection; the last bank
        # row is the zero adapter, the rows between the named adapters and
        # it are free rows add_adapter fills
        if lora_bank:
            bank, self._adapter_index = make_bank(lora_bank,
                                                  capacity=adapter_capacity)
            # stored whole, sliced per projection to this rank's share
            bank = self._shard_bank(bank, cfg)
            self._lora_bank = {p: {k: x.to(self.device)
                                   for k, x in ab.items()}
                               for p, ab in bank.items()}
            self._bank_capacity = (
                next(iter(bank.values()))["A"].shape[1] - 1)
            self._zero_adapter = self._bank_capacity
        else:
            self._lora_bank, self._adapter_index = None, {}
            self._bank_capacity = 0
            self._zero_adapter = 0
        self.lora_scale = float(lora_scale)
        self.max_slots = max_slots
        self.max_len = max_len
        self.steps_per_tick = int(steps_per_tick)
        self.admit_min_free = int(admit_min_free)
        self.buckets = tuple(sorted(b for b in prefill_buckets
                                    if b <= max_len))
        if not self.buckets:
            raise ValueError("no prefill bucket fits max_len")
        self._quantized = quantize_cache

        # one extra row (index max_slots) that no request owns: an
        # always-inactive decode row, as the JAX engine's trash row
        nrows = max_slots + 1
        self.cache = decoder.init_cache(cfg, nrows, max_len,
                                        device=self.device,
                                        quantize=quantize_cache)
        # per-slot write indices, set from the slot lengths every step;
        # cache["mask"] is unused by serving
        self.cache["index"] = torch.zeros((nrows,), dtype=torch.long,
                                          device=self.device)
        z = lambda dt: np.zeros((nrows,), dt)
        self.state = {
            "active": z(bool),
            "length": z(np.int32),         # valid cache slots per row
            "last_token": z(np.int32),
            "remaining": z(np.int32),      # new-token budget left
            "eos": np.full((nrows,), -1, np.int32),
            "temperature": z(np.float32),
            # 1.0 when unused: the nucleus pass runs only while some slot
            # samples with top_p < 1
            "top_p": np.full((nrows,), 1.0, np.float32),
            "adapter": np.full((nrows,), self._zero_adapter, np.int32),
        }
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._tick = 0
        self.counters = {"completions": 0, "tokens": 0, "prefills": 0,
                         "cancelled": 0, "parked": 0}
        # queue_wait = submit -> slot claim, ttft = submit -> first token,
        # service_ttft = claim -> first token, duration = submit ->
        # completion; cancelled requests are dropped
        self.latency = {"queue_wait": LatencyHistogram(),
                        "ttft": LatencyHistogram(),
                        "service_ttft": LatencyHistogram(),
                        "duration": LatencyHistogram()}
        self._t_submit: Dict[Any, float] = {}
        self._t_claim: Dict[Any, float] = {}

        self._queue: deque = deque()
        self._slot_owner: Dict[int, _RowState] = {}
        self._parked: List[_RowState] = []
        self._completions: List[Completion] = []
        # issued-but-unprocessed entries ("tick" / "stick" / "admit"), and
        # the latest entry's post-state ON DEVICE (None: rebuild from the
        # host mirror)
        self._pending: deque = deque()
        self._dev_packed: Optional[torch.Tensor] = None

        self.draft_layers = int(draft_layers) if draft_layers else 0
        self.spec_k = int(spec_k)
        if self.draft_layers:
            self._draft, self._draft_cfg = draft_from_target(
                params, cfg, self.draft_layers)
            if self.spec_k < 2:
                raise ValueError(f"spec_k must be >= 2, got {self.spec_k}")
            # a spec iteration costs ~1 + (K-1) N / L target passes, a
            # plain step 1 a token: speculate while the accepted tokens an
            # iteration (an EMA) clear that, probing every 32 plain ticks
            self._spec_threshold = 1.0 + ((self.spec_k - 1)
                                          * self.draft_layers
                                          / cfg.num_layers) + 0.05
        self.spec_adaptive = bool(spec_adaptive) and bool(self.draft_layers)
        self._spec_on = bool(self.draft_layers)
        self._spec_ema: Optional[float] = None
        self._spec_probe_every = 32
        self._spec_probe_in = 0
        self._prefixes: Dict[Any, Dict[str, Any]] = {}
        # chunked prefill: {slot: [req, emb, tokens written]}
        self.chunk = int(chunk_prefill) if chunk_prefill else 0
        if self.chunk and self.chunk > max_len:
            raise ValueError(f"chunk_prefill {self.chunk} > max_len "
                             f"{max_len}")
        self._chunking: Dict[int, list] = {}

    # ------------------------------------------------------------------
    # prefix cache
    # ------------------------------------------------------------------

    @torch.no_grad()
    def register_prefix(self, prefix_id: Any, embeds=None,
                        token_ids=None) -> int:
        """Compute and pin the KV cache of a shared prompt prefix once
        (a system prompt, a few-shot header). Requests carrying
        `prefix_id` then admit with only their suffix, attending over the
        pinned keys and values. Returns the prefix length in tokens."""
        if embeds is None and token_ids is None:
            raise ValueError("prefix needs embeds or token_ids")
        emb = self._embed(ServeRequest(prefix_id, embeds=embeds,
                                       token_ids=token_ids))
        plen = emb.shape[0]
        if plen >= self.max_len:
            raise ValueError(f"prefix length {plen} >= max_len "
                             f"{self.max_len}: no room for suffix/decode")
        self._prefixes[prefix_id] = pin_prefix(
            self.params, self.cfg, emb, max_len=self.max_len,
            quantize=self._quantized)
        return plen

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------

    def _dummy_meta(self, n: int) -> np.ndarray:
        meta = np.zeros((7, n), np.float32)
        meta[0, :] = 1.0                    # padding rows: length 1
        meta[2, :] = self.max_slots         # padding rows: the spare row
        meta[3, :] = self._zero_adapter     # padding rows: base weights
        meta[4, :] = 1.0                    # top_p off
        meta[5, :] = 0.0                    # zero budget
        meta[6, :] = -1.0                   # no eos
        return meta

    def _packed_in(self) -> torch.Tensor:
        """Packed slot state for the next device step: the device-chained
        one when valid, else rebuilt from the (drained) host mirror."""
        if self._dev_packed is not None:
            return self._dev_packed
        self._drain_pending()
        st = self.state
        return _upload(np.stack(
            [st["active"], st["length"], st["last_token"], st["remaining"],
             st["eos"], st["temperature"], st["adapter"],
             st["top_p"]]).astype(np.float32), self.device)

    def _need_nucleus(self) -> bool:
        """Does any slot sample through the nucleus? From the host mirror,
        which holds every device row's top_p from admission on and resets
        it to 1 only once the row's request is done."""
        st = self.state
        return bool(np.any((st["top_p"] < 1.0) & (st["temperature"] > 0)))

    def _gather_lora(self, aidx: torch.Tensor):
        """Per-row adapters {"layers": [{proj: {"A": (rows, in, r), "B":
        (rows, r, out)}}]}: one gather of the bank's rows `aidx` for a
        whole tick or admission group (serve/engine.py:525). None without
        a bank."""
        if self._lora_bank is None:
            return None
        g = {p: {k: x.index_select(1, aidx) for k, x in ab.items()}
             for p, ab in self._lora_bank.items()}
        return {"layers": [{p: {k: x[i] for k, x in ab.items()}
                            for p, ab in g.items()}
                           for i in range(self.cfg.num_layers)]}

    @torch.no_grad()
    def _run_prefill(self, bucket: int, embs, meta: np.ndarray,
                     n_real: int, prefix_id=None):
        """Prefill one admission group over a scratch cache (loaded with
        the pinned prefix when `prefix_id` is set), merge its real rows
        into their slots, sample the first tokens and write the rows into
        the packed state, all on the device (serve/engine.py:801-929).
        Returns the first tokens (n,) ON DEVICE."""
        self.counters["prefills"] += 1
        cfg, dev = self.cfg, self.device
        pref = self._prefixes[prefix_id] if prefix_id is not None else None
        plen = pref["len"] if pref is not None else 0
        # meta (7, n): [prompt_len, temperature, slot, adapter, top_p,
        # budget, eos]: one small transfer
        m = _upload(meta, dev)
        n_valid = m[0].long()
        temps, top_ps = m[1], m[4]
        slots = m[2].long()[:n_real]
        budgets, eos_ids = m[5].long(), m[6].long()
        last, scratch = prefill_group(
            self.params, cfg, embs, n_valid, bucket, max_len=self.max_len,
            quantize=self._quantized, prefix=pref,
            lora=self._gather_lora(m[3].long()), lora_scale=self.lora_scale)
        first = sample_token_rows(
            last, self._gen, temps, top_ps,
            nucleus=bool(np.any((meta[4] < 1.0) & (meta[1] > 0)))).long()

        # a first token that already finishes the request (EOS, or budget
        # 1) enters the packed state inactive
        act = (budgets > 1) & (first != eos_ids)
        rows = torch.stack([act.float(), (plen + n_valid).float(),
                            first.float(), (budgets - 1).float(),
                            eos_ids.float(), temps, m[3], top_ps])
        packed = self._packed_in()
        packed[:, slots] = rows[:, :n_real]
        self._dev_packed = packed

        # only the real rows are merged, so every slot is written once
        w = min(plen + bucket, self.max_len)
        for big, new in zip(self.cache["layers"], scratch["layers"]):
            for name in ("k", "v"):
                if isinstance(big[name], dict):      # head-major leaves
                    for key, buf in big[name].items():
                        buf[slots, :, :w] = new[name][key][:n_real, :, :w]
                else:
                    big[name][slots, :w] = new[name][:n_real, :w]
        return first

    def _set_index(self, active, at):
        """Cache write pointers: `at` for active rows, max_len (writes
        drop) for the rest, a row mid-chunked-prefill included."""
        self.cache["index"] = torch.where(active, at,
                                          torch.full_like(at, self.max_len))

    @torch.no_grad()
    def _decode_tick(self, packed: torch.Tensor):
        """`steps_per_tick` decode steps over every row
        (serve/engine.py:540-616). Returns (post-tick packed state, tokens
        (K, rows)), both on the device."""
        cfg, params, L = self.cfg, self.params, self.max_len
        active = packed[0] > 0
        length = packed[1].long()
        last = packed[2].long()
        remaining = packed[3].long()
        eos = packed[4].long()
        temp, top_ps = packed[5], packed[7]
        # per-row adapters are fixed for the tick: one gather
        la = self._gather_lora(packed[6].long())
        nucleus = self._need_nucleus()
        slots = torch.arange(L, device=self.device)
        toks = []
        for _ in range(self.steps_per_tick):
            emb = decoder.embed_tokens(params, last.clamp_min(0))[:, None]
            # row i attends to its slots [0, length_i], the one being
            # written included; inactive rows write at L, which drops
            mask4 = (slots[None, :] <= length[:, None])[:, None, None, :]
            self._set_index(active, length)
            logits, _ = decoder.forward(params, cfg, emb.to(cfg.torch_dtype),
                                        length[:, None], mask4, self.cache,
                                        lora=la, lora_scale=self.lora_scale,
                                        ntk_ctx=L)
            nxt = sample_token_rows(logits[:, -1].float(), self._gen, temp,
                                    top_ps, nucleus=nucleus).long()
            nxt = torch.where(active, nxt, last)
            remaining = remaining - active.long()
            done = active & ((nxt == eos) | (remaining <= 0))
            length = length + active.long()
            active = active & ~done
            last = nxt
            toks.append(nxt)
        packed_out = torch.stack([active.float(), length.float(),
                                  last.float(), remaining.float(),
                                  eos.float(), temp, packed[6], top_ps])
        return packed_out, torch.stack(toks)

    @torch.no_grad()
    def _spec_tick(self, packed: torch.Tensor):
        """`steps_per_tick` draft-then-verify iterations over every row
        (serve/engine.py:618-799). Returns (post-tick packed state, (tokens
        (S, K, rows), consumed (S, rows))), all on the device."""
        cfg, params, L = self.cfg, self.params, self.max_len
        K, dcfg = self.spec_k, self._draft_cfg
        active = packed[0] > 0
        length = packed[1].long()
        last = packed[2].long()
        remaining = packed[3].long()
        eos = packed[4].long()
        temp, top_ps = packed[5], packed[7]
        greedy = temp <= 0.0
        la = self._gather_lora(packed[6].long())
        dla = None if la is None else {
            "layers": la["layers"][:self.draft_layers]}
        nucleus = self._need_nucleus()
        slots = torch.arange(L, device=self.device)
        rows = torch.arange(last.shape[0], device=self.device)
        steps = torch.arange(K, device=self.device)
        toks, cons = [], []
        for _ in range(self.steps_per_tick):
            # draft: K-1 proposals from the first N layers, written into
            # the big cache's first N layers (the verify pass rewrites
            # them); sampled rows draw from the draft's warped q_j
            tok, props, qs = last, [], []
            for j in range(K - 1):
                emb = decoder.embed_tokens(params, tok.clamp_min(0))[:, None]
                mask4 = (slots[None, :] <= (length + j)[:, None])[
                    :, None, None, :]
                self._set_index(active, length + j)
                lg, _ = decoder.forward(
                    self._draft, dcfg, emb.to(cfg.torch_dtype),
                    (length + j)[:, None], mask4, self.cache, lora=dla,
                    lora_scale=self.lora_scale, ntk_ctx=L)
                lgf = lg[:, -1].float()
                warped = warp_logits_rows(lgf, temp, top_ps,
                                          nucleus=nucleus)
                tok = torch.where(greedy, torch.argmax(lgf, dim=-1),
                                  _categorical(warped, self._gen).long())
                props.append(tok)
                qs.append(torch.softmax(warped, dim=-1))
            props_t = torch.stack(props, dim=1)                # (B, K-1)
            chunk = torch.cat([last[:, None], props_t], dim=1)
            # verify: one K-token target forward; row j attends
            # [0, length + j]
            emb = decoder.embed_tokens(params, chunk.clamp_min(0))
            self._set_index(active, length)
            logits, _ = decoder.forward(
                params, cfg, emb.to(cfg.torch_dtype),
                length[:, None] + steps[None, :], verify_mask(length, K, L),
                self.cache, lora=la, lora_scale=self.lora_scale, ntk_ctx=L)
            lg = logits.float()                                 # (B, K, V)
            ps = warp_probs_rows(lg, temp[:, None], top_ps[:, None],
                                 nucleus=nucleus)
            emit, n_emit = accept_and_emit(
                props_t, torch.stack(qs, dim=1), torch.argmax(lg, dim=-1),
                ps, greedy, self._gen)
            # finish inside the emitted prefix by plain decode's per-step
            # rule (remaining -= 1; done on eos or an empty budget)
            j1 = steps[None, :] + 1
            in_emit = j1 <= n_emit[:, None]
            finish = (((emit == eos[:, None])
                       | ((remaining[:, None] - j1) <= 0)) & in_emit)
            any_fin = finish.any(dim=1)
            consumed = torch.where(any_fin, finish.long().argmax(dim=1) + 1,
                                   n_emit)
            consumed = torch.where(active, consumed,
                                   torch.zeros_like(consumed))
            length = length + consumed
            remaining = remaining - consumed
            last = torch.where(consumed > 0,
                               emit[rows, (consumed - 1).clamp_min(0)], last)
            active = active & ~any_fin
            toks.append(emit.t())
            cons.append(consumed)
        packed_out = torch.stack([active.float(), length.float(),
                                  last.float(), remaining.float(),
                                  eos.float(), temp, packed[6], top_ps])
        return packed_out, (torch.stack(toks), torch.stack(cons))

    @torch.no_grad()
    def _chunk_step(self, embs, meta: np.ndarray):
        """One C-token prefill chunk for n chunking slots, each written at
        its own offset of its own rows of the big cache, attending
        [0, offset + valid) (serve/engine.py:931-987). Returns the sampled
        last-position tokens (n,) on the device (read only for a row's
        final chunk)."""
        # meta (6, n): [valid, temperature, slot, adapter, offset, top_p]
        m = _upload(meta, self.device)
        temps, top_ps = m[1], m[5]
        last = chunk_logits(self.params, self.cfg, self.cache, embs,
                            m[0].long(), m[4].long(), m[2].long(),
                            max_len=self.max_len,
                            lora=self._gather_lora(m[3].long()),
                            lora_scale=self.lora_scale)
        return sample_token_rows(
            last, self._gen, temps, top_ps,
            nucleus=bool(np.any((meta[5] < 1.0) & (meta[1] > 0)))).long()

    def _advance_chunks(self) -> None:
        """One prefill chunk for every chunking slot, in one call; rows
        whose prompt just completed activate for decode with their sampled
        first token (serve/engine.py:989-1045)."""
        if not self._chunking:
            return
        self._dev_packed = None        # slot state changes: rebuild packed
        self.counters["prefills"] += 1
        C = self.chunk
        group = sorted(self._chunking)            # slot order, determinism
        n = len(group)
        embs = torch.zeros((n, C, self.cfg.hidden_size),
                           dtype=self.cfg.torch_dtype, device=self.device)
        meta = np.zeros((6, n), np.float32)
        for r, slot in enumerate(group):
            req, emb, done = self._chunking[slot]
            piece = emb[done:done + C]
            embs[r, :piece.shape[0]] = piece.to(embs.dtype)
            meta[:, r] = (piece.shape[0], req.temperature, slot,
                          self._adapter_of(req), done, req.top_p)
        first = self._chunk_step(embs, meta).cpu().numpy()
        st = self.state
        for r, slot in enumerate(group):
            req, emb, done = self._chunking[slot]
            done += int(meta[0, r])
            if done < emb.shape[0]:
                self._chunking[slot][2] = done
                continue
            del self._chunking[slot]              # prompt complete
            tok = int(first[r])
            self._observe_ttft(req)
            st["active"][slot] = True
            st["length"][slot] = done
            st["last_token"][slot] = tok
            st["remaining"][slot] = req.max_new_tokens - 1
            st["eos"][slot] = req.eos_token_id
            st["temperature"][slot] = req.temperature
            st["top_p"][slot] = req.top_p
            st["adapter"][slot] = self._adapter_of(req)
            rs = self._slot_owner[slot]
            rs.tokens.append(tok)
            rs.remaining -= 1
            if req.on_tokens is not None and tok != req.eos_token_id:
                req.on_tokens([tok])
            if tok == req.eos_token_id:
                self._complete(rs, "eos", slot)
            elif req.max_new_tokens <= 1:
                self._complete(rs, "length", slot)

    # ------------------------------------------------------------------
    # scheduler (host-side mirror of the device transition rules)
    # ------------------------------------------------------------------

    @property
    def busy(self) -> bool:
        """Work pending: queued requests, occupied slots, unharvested
        completions, chunked prefills or unprocessed entries."""
        return bool(self._queue or self._slot_owner or self._completions
                    or self._chunking or self._pending)

    def submit(self, req: ServeRequest) -> None:
        """Validate eagerly: a request that cannot be served fails HERE,
        not mid-admission where it would take dequeued requests with it
        (serve/engine.py:1074-1114)."""
        if req.embeds is None and req.token_ids is None:
            raise ValueError("request needs embeds or token_ids")
        p = (req.embeds.shape[0] if req.embeds is not None
             else len(req.token_ids))
        plen = 0
        if req.prefix_id is not None:
            if req.prefix_id not in self._prefixes:
                raise ValueError(f"unknown prefix_id {req.prefix_id!r} "
                                 "(register_prefix first)")
            if p < 1:
                raise ValueError("prefix requests need >= 1 suffix token")
            plen = self._prefixes[req.prefix_id]["len"]
        if p > self.buckets[-1] and not (self.chunk
                                         and req.prefix_id is None):
            raise ValueError(
                f"prompt length {p} exceeds the largest prefill bucket "
                f"{self.buckets[-1]}"
                + ("" if self.chunk else
                   " (chunk_prefill=N admits longer prompts in chunks)"))
        if plen + p + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prefix ({plen}) + prompt ({p}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds per-slot KV capacity "
                f"max_len={self.max_len}; writes past capacity would be "
                "silently dropped")
        if req.adapter_id is not None:
            if req.adapter_id not in self._adapter_index:
                raise ValueError(
                    f"unknown adapter {req.adapter_id!r} "
                    f"(bank has: {sorted(self._adapter_index) or 'none'})")
            if req.prefix_id is not None:
                raise ValueError(
                    "adapter_id with prefix_id is unsupported: the pinned "
                    "prefix KV was computed with base weights, so an "
                    "adapted suffix would attend inconsistent state")
        self._t_submit[req.request_id] = time.monotonic()
        self._queue.append(req)

    def _adapter_of(self, req: ServeRequest) -> int:
        return (self._zero_adapter if req.adapter_id is None
                else self._adapter_index[req.adapter_id])

    def cancel(self, request_id: Any) -> bool:
        """Abandon a request: drop it from the queue, or free its slot so
        the next tick stops decoding it (a chunked prefill stops too).
        Returns True if it was found (a completion with finish_reason
        "cancelled" is emitted)."""
        self._drain_pending()
        self._dev_packed = None
        for i, q in enumerate(self._queue):
            if q.request_id == request_id:
                del self._queue[i]
                self._t_submit.pop(request_id, None)
                self._t_claim.pop(request_id, None)
                self._completions.append(
                    Completion(request_id, [], "cancelled"))
                self.counters["cancelled"] += 1
                return True
        for slot, rs in self._slot_owner.items():
            if rs.req.request_id == request_id:
                self._slot_owner.pop(slot)
                rs.done = True
                self._chunking.pop(slot, None)
                self._t_submit.pop(request_id, None)
                self._t_claim.pop(request_id, None)
                self.state["active"][slot] = False
                self.state["top_p"][slot] = 1.0
                self._completions.append(
                    Completion(request_id, rs.tokens, "cancelled"))
                self.counters["cancelled"] += 1
                return True
        return False

    def _free_slots(self) -> List[int]:
        return [i for i in range(self.max_slots)
                if not self.state["active"][i]
                and i not in self._slot_owner]

    def _embed(self, req: ServeRequest) -> torch.Tensor:
        if req.embeds is not None:
            e = req.embeds
            if isinstance(e, torch.Tensor):
                return e.to(self.device)
            return _upload(np.asarray(e), self.device)
        ids = _upload(np.asarray(req.token_ids, np.int64), self.device)
        return decoder.embed_tokens(self.params, ids)

    def _predicted_free(self) -> List[int]:
        """Active slots whose occupant provably finishes within the
        in-flight ticks (its mirror budget, which excludes in-flight
        consumption, runs out within their guaranteed tokens)."""
        st = self.state
        g = self._inflight_steps_min()
        if not g:
            return []
        out = []
        for s in range(self.max_slots):
            if (st["active"][s] and s not in self._chunking
                    and st["remaining"][s] <= g):
                rs = self._slot_owner.get(s)
                if rs is not None and not rs.done:
                    out.append(s)
        return out

    def _park(self, slot: int) -> None:
        """Hand a provably finishing slot over; the old occupant lives on
        in its _RowState, which the in-flight ticks' snapshots hold."""
        self._parked.append(self._slot_owner.pop(slot))
        self.counters["parked"] += 1
        self.state["active"][slot] = False
        self.state["top_p"][slot] = 1.0

    def _admit(self) -> None:
        """Group queued requests by (prompt bucket, prefix) and admit each
        group with one prefill; a prompt past the largest bucket (with
        chunk_prefill) claims its slot and prefills a chunk a tick. Slots
        whose occupants provably finish in flight are handed over without
        a drain."""
        free = self._free_slots()
        want = min(self.admit_min_free, len(self._queue), self.max_slots)
        if len(free) < want:
            need = min(len(self._queue), self.max_slots) - len(free)
            for slot in self._predicted_free()[:max(need, 0)]:
                self._park(slot)
                free.append(slot)
        if len(free) < want:
            return
        batch = []
        while free and self._queue:
            req = self._queue.popleft()   # submit() validated capacity
            t0 = self._t_submit.get(req.request_id)
            if t0 is not None:
                now = time.monotonic()
                self.latency["queue_wait"].observe(now - t0)
                self._t_claim[req.request_id] = now
            emb = self._embed(req)
            if self.chunk and emb.shape[0] > self.buckets[-1]:
                slot = free.pop(0)
                self._slot_owner[slot] = _RowState(req)
                self._chunking[slot] = [req, emb, 0]
                continue
            batch.append((free.pop(0), req, emb,
                          (_bucket(emb.shape[0], self.buckets),
                           req.prefix_id)))
        for gkey in sorted({x[3] for x in batch},
                           key=lambda g: (g[0], str(g[1]))):
            self._admit_group(gkey[0], [x for x in batch if x[3] == gkey],
                              prefix_id=gkey[1])

    @staticmethod
    def _pad_group(n: int) -> int:
        p = 1
        while p < n:
            p *= 2
        return p

    def _admit_group(self, bucket: int, group, prefix_id=None) -> None:
        # padded to a power-of-two group size as in the JAX engine;
        # padding rows prefill a 1-token dummy and are never merged
        n = self._pad_group(len(group))
        embs = torch.zeros((n, bucket, self.cfg.hidden_size),
                           dtype=self.cfg.torch_dtype, device=self.device)
        meta = self._dummy_meta(n)
        for r, (slot, req, emb, _) in enumerate(group):
            embs[r, :emb.shape[0]] = emb.to(embs.dtype)
            meta[:, r] = (emb.shape[0], req.temperature, slot,
                          self._adapter_of(req), req.top_p,
                          req.max_new_tokens, req.eos_token_id)
        first = self._run_prefill(bucket, embs, meta, len(group), prefix_id)
        plen = self._prefixes[prefix_id]["len"] if prefix_id is not None \
            else 0

        # the mirror takes what is known now, the first token at drain
        st = self.state
        records = []
        for r, (slot, req, emb, _) in enumerate(group):
            st["active"][slot] = True       # provisional: drain reconciles
            st["length"][slot] = plen + emb.shape[0]
            st["remaining"][slot] = req.max_new_tokens - 1
            st["eos"][slot] = req.eos_token_id
            st["temperature"][slot] = req.temperature
            st["top_p"][slot] = req.top_p
            st["adapter"][slot] = self._adapter_of(req)
            rs = _RowState(req)
            self._slot_owner[slot] = rs
            records.append((r, slot, rs))
        self._pending.append(("admit", first, records))

    def _process_admit(self, first, records) -> None:
        st = self.state
        first_h = first.cpu().numpy()
        for r, slot, rs in records:
            if rs.done:                     # cancelled before the drain
                continue
            req = rs.req
            tok = int(first_h[r])
            self._observe_ttft(req)
            if self._slot_owner.get(slot) is rs:
                st["last_token"][slot] = tok
            rs.tokens.append(tok)
            rs.remaining -= 1
            if req.on_tokens is not None and tok != req.eos_token_id:
                req.on_tokens([tok])
            if tok == req.eos_token_id:
                self._complete(rs, "eos", slot)
            elif req.max_new_tokens <= 1:
                self._complete(rs, "length", slot)

    def _observe_ttft(self, req: ServeRequest) -> None:
        now = time.monotonic()
        t0 = self._t_submit.get(req.request_id)
        if t0 is not None:
            self.latency["ttft"].observe(now - t0)
        tc = self._t_claim.pop(req.request_id, None)
        if tc is not None:
            self.latency["service_ttft"].observe(now - tc)

    def _complete(self, rs: _RowState, reason: str, slot: int) -> None:
        """Emit rs's completion; free the slot's mirror iff rs still owns
        it (a parked rs's slot already serves its successor)."""
        rs.done = True
        req = rs.req
        toks = rs.tokens
        if reason == "eos" and toks and toks[-1] == req.eos_token_id:
            toks = toks[:-1]
        self._t_claim.pop(req.request_id, None)
        t0 = self._t_submit.pop(req.request_id, None)
        if t0 is not None:
            self.latency["duration"].observe(time.monotonic() - t0)
        self._completions.append(Completion(req.request_id, toks, reason))
        self.counters["completions"] += 1
        self.counters["tokens"] += len(toks)
        if self._slot_owner.get(slot) is rs:
            self._slot_owner.pop(slot)
            self.state["active"][slot] = False
            # a freed slot must not keep a top_p < 1: it would turn the
            # nucleus pass on for every later tick
            self.state["top_p"][slot] = 1.0

    def step(self) -> List[Completion]:
        """One scheduler tick: admit queued requests, push chunked
        prefills one chunk forward, advance every active slot by up to
        `steps_per_tick` tokens (iterations), harvest completions. Ticks
        pipeline one deep; completions surface at most one tick later."""
        if self._chunking:
            self._drain_pending()
        elif self._queue and self._pending:
            # admissions need no drain (owner snapshots route in-flight
            # tokens); drain only when admission is blocked and an
            # in-flight tick may have freed a slot the mirror cannot
            # predict (an early EOS, or a speculative tick consuming more
            # than its guaranteed minimum)
            st0 = self.state
            want = min(self.admit_min_free, len(self._queue),
                       self.max_slots)
            if len(self._free_slots()) + len(self._predicted_free()) < want:
                act = st0["active"][:self.max_slots]
                may_free = bool(np.any(act & (
                    (st0["remaining"][:self.max_slots]
                     <= self._inflight_steps())
                    | (st0["eos"][:self.max_slots] != -1))))
                if may_free:
                    self._drain_pending()
        self._admit()
        self._advance_chunks()
        st = self.state
        if not self._slot_owner \
                or not np.any(st["active"][:self.max_slots]):
            self._drain_pending()
            out, self._completions = self._completions, []
            return out
        if self._pending:
            rem = st["remaining"][:self.max_slots][
                st["active"][:self.max_slots]]
            if rem.size and (rem - self._inflight_steps_min() <= 0).all():
                # every active slot certainly finishes in flight: another
                # tick would be pure waste
                self._drain_pending()
                out, self._completions = self._completions, []
                return out

        use_spec = self._spec_use_now()
        tick = self._spec_tick if use_spec else self._decode_tick
        self._dev_packed, toks = tick(self._packed_in())
        self._tick += 1
        # owner snapshot: this tick's tokens belong to whoever holds the
        # slot NOW, even if the slot is handed over before the fetch
        owners = {s: rs for s, rs in self._slot_owner.items()
                  if st["active"][s]}
        self._pending.append(("stick" if use_spec else "tick", toks,
                              owners))
        while len(self._pending) > 1:                  # depth-1 pipeline
            self._process_one(self._pending.popleft())
        out, self._completions = self._completions, []
        return out

    def _spec_use_now(self) -> bool:
        """Speculate this tick? Always when not adaptive; when adaptive,
        while acceptance pays, with one probe tick every
        `_spec_probe_every` plain ticks after a fall-back."""
        if not self.draft_layers:
            return False
        if not self.spec_adaptive or self._spec_on:
            return True
        self._spec_probe_in -= 1
        return self._spec_probe_in <= 0

    def _inflight_ticks(self) -> int:
        return sum(1 for e in self._pending if e[0] in ("tick", "stick"))

    def _inflight_steps(self) -> int:
        """Upper bound of the tokens a slot may consume in the in-flight
        ticks (K an iteration with speculation): a slot MAY have
        finished."""
        per = self.steps_per_tick * (self.spec_k if self.draft_layers
                                     else 1)
        return per * self._inflight_ticks()

    def _inflight_steps_min(self) -> int:
        """Tokens every still-active slot is guaranteed to consume in the
        in-flight ticks (an iteration emits at least one): `remaining <=
        this` proves the slot finishes in flight."""
        return self.steps_per_tick * self._inflight_ticks()

    def _drain_pending(self) -> None:
        """Process every in-flight entry so the host mirror is current. A
        parked request must have finished within the entries in flight
        when its slot was handed over."""
        while self._pending:
            self._process_one(self._pending.popleft())
        if self._parked:
            stuck = [rs.req.request_id for rs in self._parked
                     if not rs.done]
            if stuck:
                raise RuntimeError(f"parked requests did not finish: "
                                   f"{stuck}")
            self._parked = []

    def _process_one(self, entry) -> None:
        if entry[0] == "admit":
            self._process_admit(entry[1], entry[2])
        elif entry[0] == "stick":
            self._process_spec_tick(entry[1], entry[2])
        else:
            self._process_tick(entry[1], entry[2])

    def _apply_row(self, rs: _RowState, slot: int, new: List[int],
                   by_eos: bool, fin: bool) -> None:
        rs.tokens.extend(new)
        rs.remaining -= len(new)
        if self._slot_owner.get(slot) is rs:
            st = self.state
            st["remaining"][slot] -= len(new)
            st["length"][slot] += len(new)
            st["last_token"][slot] = new[-1]
        cb = rs.req.on_tokens
        if cb is not None:
            delta = new[:-1] if by_eos else new       # never stream EOS
            if delta:
                cb(delta)
        if fin:
            self._complete(rs, "eos" if by_eos else "length", slot)

    def _process_tick(self, toks, owners) -> None:
        """Replay the device's per-step rule (remaining -= 1; done on eos
        or an empty budget) against the tick's owner snapshot."""
        toks_h = toks.cpu().numpy()                    # the per-tick fetch
        k = toks_h.shape[0]
        for slot, rs in owners.items():
            if rs.done or rs.remaining <= 0:
                continue                # finished in an earlier entry
            eos = rs.req.eos_token_id
            c, by_eos, fin = 0, False, False
            rem = rs.remaining
            for i in range(k):
                tok = int(toks_h[i, slot])
                c += 1
                rem -= 1
                if tok == eos:
                    by_eos = fin = True
                    break
                if rem <= 0:
                    fin = True
                    break
            self._apply_row(rs, slot, toks_h[:c, slot].tolist(), by_eos,
                            fin)

    def _process_spec_tick(self, tc, owners) -> None:
        """Apply a speculative tick's device-computed consumption: tokens
        (S, K, rows) and consumed (S, rows); the device already applied
        the finish rule inside each emitted prefix
        (serve/engine.py:1511-1549). Feeds the adaptive EMA."""
        toks, cons = tc
        toks_h = toks.cpu().numpy()                    # the per-tick fetch
        cons_h = cons.cpu().numpy().astype(np.int64)
        B = self.max_slots
        for s in range(toks_h.shape[0]):
            T = toks_h[s, :, :B]                       # (K, B)
            C = cons_h[s, :B]
            idx = np.flatnonzero(C > 0)
            if idx.size == 0:
                continue
            acc = float(C[idx].sum()) / idx.size       # tokens/iteration
            self._spec_ema = (acc if self._spec_ema is None
                              else 0.8 * self._spec_ema + 0.2 * acc)
            for slot in idx:
                rs = owners.get(int(slot))
                if rs is None or rs.done:
                    continue
                c = int(C[slot])
                new = T[:c, slot].tolist()
                # the device stops at the first finish condition, so an
                # eos can only be the last consumed token
                by_eos = new[-1] == rs.req.eos_token_id
                fin = by_eos or rs.remaining - c <= 0
                self._apply_row(rs, int(slot), new, by_eos, fin)
        if self.spec_adaptive and self._spec_ema is not None:
            on = self._spec_ema >= self._spec_threshold
            if not on:
                # falling back (or a failed probe): forget the EMA so the
                # next probe is judged on its own, restart the countdown
                self._spec_ema = None
                self._spec_probe_in = self._spec_probe_every
            self._spec_on = on

    # ------------------------------------------------------------------
    # the adapter bank at runtime (serve/engine.py:1551-1613)
    # ------------------------------------------------------------------

    @property
    def adapters(self) -> tuple:
        """Names of the bank adapters this engine serves (empty: base)."""
        return tuple(self._adapter_index)

    @property
    def adapter_capacity(self) -> int:
        """Bank rows available for adapters (0: no bank)."""
        return self._bank_capacity

    def add_adapter(self, name: str, tree: dict) -> None:
        """Install a folded, unmerged adapter into a free bank row, in
        place. Call from the thread that owns submit()/step()."""
        if self._lora_bank is None:
            raise ValueError(
                "engine has no adapter bank; construct it with lora_bank "
                "and spare capacity (adapter_capacity)")
        if name in self._adapter_index:
            raise ValueError(f"adapter {name!r} already serves; "
                             "remove_adapter first")
        used = set(self._adapter_index.values())
        free = next((i for i in range(self._bank_capacity)
                     if i not in used), None)
        if free is None:
            raise ValueError(
                f"adapter bank is full ({self._bank_capacity} slots); "
                "remove one or build the engine with more adapter_capacity")
        stacked = self._shard_bank(stack_adapter(name, tree), self.cfg)
        want = sorted((p, k, tuple(x.shape)) for p, ab in stacked.items()
                      for k, x in ab.items())
        have = sorted((p, k, tuple(x.shape[:1] + x.shape[2:]))
                      for p, ab in self._lora_bank.items()
                      for k, x in ab.items())
        if want != have:
            raise ValueError(
                f"adapter {name!r} shapes {want} do not match the bank's "
                f"row shapes {have} (same projections, same rank required)")
        for p, ab in self._lora_bank.items():
            for k, x in ab.items():
                x[:, free] = stacked[p][k].to(device=x.device, dtype=x.dtype)
        self._adapter_index[name] = free

    def remove_adapter(self, name: str) -> None:
        """Free a bank row: refused while a queued or in-flight request
        uses the adapter; then the row is zeroed and the name dropped."""
        if name not in self._adapter_index:
            raise ValueError(f"unknown adapter {name!r} "
                             f"(serving: {sorted(self._adapter_index)})")
        self._drain_pending()    # parked/in-flight rows must settle first
        in_use = (any(q.adapter_id == name for q in self._queue)
                  or any(rs.req.adapter_id == name
                         for rs in self._slot_owner.values()))
        if in_use:
            raise ValueError(f"adapter {name!r} has queued or in-flight "
                             "requests; retry once they finish")
        idx = self._adapter_index.pop(name)
        for ab in self._lora_bank.values():
            for x in ab.values():
                x[:, idx] = 0

    @staticmethod
    def _shard_bank(bank: dict, cfg: DecoderConfig) -> dict:
        if cfg.tp is None:
            return bank
        from ..parallel import partition
        return partition.shard_bank(bank, cfg.tp)

    def reseed(self, seed: int) -> None:
        """Reset the sampling generator (engine reuse across repeats)."""
        self._gen.manual_seed(seed)

    def run(self, requests: List[ServeRequest],
            max_ticks: Optional[int] = None) -> Dict[Any, Completion]:
        """Drive the queue to completion; returns {request_id: Completion}."""
        for r in requests:
            self.submit(r)
        done: Dict[Any, Completion] = {}
        ticks = 0
        while (self._queue or self._slot_owner) and (
                max_ticks is None or ticks < max_ticks):
            for c in self.step():
                done[c.request_id] = c
            ticks += 1
        for c in self._completions:
            done[c.request_id] = c
        self._completions = []
        return done
