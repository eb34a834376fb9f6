"""Continuous-batching serving engine (port of the core of
`opus_pllm_tpu/serve/engine.py`).

A fixed pool of `max_slots` sequence slots shares one KV cache on the
device, updated in place. Slot bookkeeping (lengths, budgets, temperatures,
eos ids) lives in a host numpy mirror that follows the device's transition
rules exactly, so the host never has to ask the device for it.

* A decode tick advances every slot by `steps_per_tick` tokens (a Python
  loop of decoder steps in place of the JAX `lax.scan`), with per-slot
  cache writes through the decoder's (B,)-indexed path. Its input and
  output slot state is one packed (8, max_slots + 1) fp32 tensor that
  stays on the device from tick to tick.
* New requests join between ticks, grouped by prompt bucket and padded to
  a power of two: each group is one bucketed prefill over a scratch cache
  (Sq = Skv = bucket: the flash kernel's shape, and with int8 weights
  M = n x bucket rows for the int8 kernel), merged into the admitted slots,
  with each first token sampled on the device.
* The depth-1 pipeline: a tick's tokens (and an admission's first tokens)
  are copied to the host only when that entry is processed, after the next
  tick has been issued, so the host issues tick t + 1 while the card runs
  tick t. Nothing inside a tick reads the device: the nucleus pass is
  gated by a Python bool from the host mirror, cache writes past capacity
  drop on the device, and host arrays go up through pinned buffers.
* Slots whose occupant provably finishes within the in-flight ticks are
  handed to the next request without draining the pipeline ("parking"):
  each tick's tokens route through the owner snapshot taken when it was
  issued.

Greedy results are token-identical to the JAX engine and to
`infer.engine.generate` run per request (tests/test_torch_serve.py).

Ported: `ServeRequest` (:65), `Completion` (:92), `_RowState` (:98),
`_bucket` (:118), `LatencyHistogram` (:125, without the Prometheus text
exposition, which comes with the HTTP server) and `ServingEngine` with the
scheduler of :1067-1636. The padding rows of an admission group are not
merged anywhere (the JAX engine scatters them to the trash row, index
max_slots, which stays an inactive decode row here). Not ported (ROADMAP.md
§1 item 4): the LoRA bank, speculative ticks, the prefix cache, chunked
prefill and the mesh, each refused with NotImplementedError; `warmup` (a
jit warm-up) is not needed: PyTorch runs eagerly.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import DecoderConfig
from ..infer.engine import sample_token_rows
from ..models import decoder

_LATER = ("is not ported yet (ROADMAP.md §1 item 4: the engine's LoRA "
          "bank, speculative ticks, prefix cache, chunked prefill and mesh)")


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} {_LATER}")


@dataclasses.dataclass
class ServeRequest:
    """One generation request. `embeds` (P, H): an already-embedded prompt,
    a tensor (best on the engine's device: no host round trip) or a numpy
    array; or `token_ids` (P,) to embed from the vocabulary. `on_tokens`,
    if set, is called from `step` with each batch of new tokens (EOS never
    included). `prefix_id` and `adapter_id` must stay None (not ported)."""
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


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without waiting for the device: a
    pinned staging buffer and an asynchronous copy (a pageable copy would
    wait for every queued kernel, the in-flight tick included)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def admission_inputs(n_valid, bucket: int):
    """Positions (n, bucket) and mask (n, 1, bucket, bucket) of one
    admission group's prefill: query i of row r attends keys j <= i with
    j < n_valid[r] (serve/engine.py:831-859 at plen = 0)."""
    ar = torch.arange(bucket, device=n_valid.device)
    pos = ar[None, :] * (ar[None, :] < n_valid[:, None])
    kv = ar[None, None, None, :]
    mask4 = (kv <= ar[None, None, :, None]) & (
        kv < n_valid[:, None, None, None])
    return pos, mask4


class ServingEngine:
    """Slot-based continuous batching over a fixed decoder, on the device
    that holds `params`.

    max_slots: concurrent sequences; max_len: per-slot KV capacity (prompt
    + generation); prefill_buckets: prompt paddings (ascending);
    steps_per_tick: decode steps per tick; admit_min_free: admit only once
    this many slots are free (or the queue is shorter)."""

    def __init__(self, params, cfg: DecoderConfig, *, max_slots: int = 8,
                 max_len: int = 512,
                 prefill_buckets: Tuple[int, ...] = (64, 128, 256),
                 quantize_cache=False, seed: int = 0,
                 steps_per_tick: int = 1, admit_min_free: int = 1,
                 lora_bank=None, mesh=None,
                 chunk_prefill: Optional[int] = None,
                 draft_layers: Optional[int] = None):
        for what, val in (("lora_bank (multi-LoRA serving)", lora_bank),
                          ("mesh (tensor-parallel serving)", mesh),
                          ("chunk_prefill", chunk_prefill),
                          ("draft_layers (speculative ticks)", draft_layers)):
            if val:
                raise not_ported(what)
        self.params = params
        self.cfg = cfg
        self.device = params["embed_tokens"]["embedding"].device
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
            "adapter": z(np.int32),        # the packed format's row 6
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
        # issued-but-unprocessed entries ("tick" / "admit"), and the latest
        # entry's post-state ON DEVICE (None: rebuild from the host mirror)
        self._pending: deque = deque()
        self._dev_packed: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------

    def _dummy_meta(self, n: int) -> np.ndarray:
        meta = np.zeros((7, n), np.float32)
        meta[0, :] = 1.0                    # padding rows: length 1
        meta[2, :] = self.max_slots         # padding rows: the spare row
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

    @torch.no_grad()
    def _run_prefill(self, bucket: int, embs, meta: np.ndarray,
                     n_real: int):
        """Prefill one admission group over a scratch cache, merge its real
        rows into their slots, sample the first tokens and write the rows
        into the packed state, all on the device (serve/engine.py:801-903
        at plen = 0). Returns the first tokens (n,) ON DEVICE."""
        self.counters["prefills"] += 1
        cfg, dev = self.cfg, self.device
        n = embs.shape[0]
        # meta (7, n): [prompt_len, temperature, slot, adapter, top_p,
        # budget, eos]: one small transfer
        m = _upload(meta, dev)
        n_valid = m[0].long()
        temps, top_ps = m[1], m[4]
        slots = m[2].long()[:n_real]
        budgets, eos_ids = m[5].long(), m[6].long()
        pos, mask4 = admission_inputs(n_valid, bucket)
        scratch = decoder.init_cache(cfg, n, bucket, device=dev,
                                     quantize=self._quantized)
        # ntk_ctx pins the dynamic-NTK base to the decode cache's capacity:
        # the scratch cache is narrower (serve/engine.py:861-869)
        hid, scratch = decoder.forward(self.params, cfg, embs, pos, mask4,
                                       scratch, return_hidden=True,
                                       ntk_ctx=self.max_len)
        # the head on each row's last valid position only
        last_h = hid[torch.arange(n, device=dev), (n_valid - 1).clamp_min(0)]
        last = decoder.head_logits(self.params, cfg,
                                   last_h[:, None])[:, 0].float()
        first = sample_token_rows(
            last, self._gen, temps, top_ps,
            nucleus=bool(np.any((meta[4] < 1.0) & (meta[1] > 0)))).long()

        # a first token that already finishes the request (EOS, or budget
        # 1) enters the packed state inactive
        act = (budgets > 1) & (first != eos_ids)
        rows = torch.stack([act.float(), n_valid.float(), first.float(),
                            (budgets - 1).float(), eos_ids.float(), temps,
                            m[3], top_ps])
        packed = self._packed_in()
        packed[:, slots] = rows[:, :n_real]
        self._dev_packed = packed

        # only the real rows are merged, so every slot is written once
        w = min(bucket, self.max_len)
        for big, new in zip(self.cache["layers"], scratch["layers"]):
            for name in ("k", "v"):
                if isinstance(big[name], dict):      # head-major leaves
                    for key, buf in big[name].items():
                        buf[slots, :, :w] = new[name][key][:n_real, :, :w]
                else:
                    big[name][slots, :w] = new[name][:n_real, :w]
        return first

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
        nucleus = self._need_nucleus()
        slots = torch.arange(L, device=self.device)
        toks = []
        for _ in range(self.steps_per_tick):
            emb = decoder.embed_tokens(params, last.clamp_min(0))[:, None]
            # row i attends to its slots [0, length_i], the one being
            # written included; inactive rows write at L, which drops
            mask4 = (slots[None, :] <= length[:, None])[:, None, None, :]
            self.cache["index"] = torch.where(active, length,
                                              torch.full_like(length, L))
            logits, _ = decoder.forward(params, cfg, emb.to(cfg.torch_dtype),
                                        length[:, None], mask4, self.cache,
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

    # ------------------------------------------------------------------
    # scheduler (host-side mirror of the device transition rules)
    # ------------------------------------------------------------------

    @property
    def busy(self) -> bool:
        """Work pending: queued requests, occupied slots, unharvested
        completions or unprocessed entries."""
        return bool(self._queue or self._slot_owner or self._completions
                    or self._pending)

    def submit(self, req: ServeRequest) -> None:
        """Validate eagerly: a request that cannot be served fails HERE,
        not mid-admission where it would take dequeued requests with it."""
        if req.prefix_id is not None:
            raise not_ported("prefix_id (the prefix cache)")
        if req.adapter_id is not None:
            raise not_ported("adapter_id (the LoRA bank)")
        if req.embeds is None and req.token_ids is None:
            raise ValueError("request needs embeds or token_ids")
        p = (req.embeds.shape[0] if req.embeds is not None
             else len(req.token_ids))
        if p > self.buckets[-1]:
            raise ValueError(f"prompt length {p} exceeds the largest "
                             f"prefill bucket {self.buckets[-1]}")
        if p + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({p}) + max_new_tokens ({req.max_new_tokens}) "
                f"exceeds per-slot KV capacity max_len={self.max_len}; "
                "writes past capacity would be silently dropped")
        self._t_submit[req.request_id] = time.monotonic()
        self._queue.append(req)

    def cancel(self, request_id: Any) -> bool:
        """Abandon a request: drop it from the queue, or free its slot so
        the next tick stops decoding it. Returns True if it was found (a
        completion with finish_reason "cancelled" is emitted)."""
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
        consumption, runs out within them)."""
        st = self.state
        g = self._inflight_steps()
        if not g:
            return []
        out = []
        for s in range(self.max_slots):
            if st["active"][s] and st["remaining"][s] <= g:
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
        """Group queued requests by prompt bucket and admit each group
        with one prefill; slots whose occupants provably finish in flight
        are handed over without a drain."""
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
            batch.append((free.pop(0), req, emb,
                          _bucket(emb.shape[0], self.buckets)))
        for bucket in sorted({x[3] for x in batch}):
            self._admit_group(bucket, [x for x in batch if x[3] == bucket])

    @staticmethod
    def _pad_group(n: int) -> int:
        p = 1
        while p < n:
            p *= 2
        return p

    def _admit_group(self, bucket: int, group) -> None:
        # padded to a power-of-two group size as in the JAX engine;
        # padding rows prefill a 1-token dummy and are never merged
        n = self._pad_group(len(group))
        embs = torch.zeros((n, bucket, self.cfg.hidden_size),
                           dtype=self.cfg.torch_dtype, device=self.device)
        meta = self._dummy_meta(n)
        for r, (slot, req, emb, _) in enumerate(group):
            embs[r, :emb.shape[0]] = emb.to(embs.dtype)
            meta[:, r] = (emb.shape[0], req.temperature, slot, 0,
                          req.top_p, req.max_new_tokens, req.eos_token_id)
        first = self._run_prefill(bucket, embs, meta, len(group))

        # the mirror takes what is known now, the first token at drain
        st = self.state
        records = []
        for r, (slot, req, emb, _) in enumerate(group):
            st["active"][slot] = True       # provisional: drain reconciles
            st["length"][slot] = emb.shape[0]
            st["remaining"][slot] = req.max_new_tokens - 1
            st["eos"][slot] = req.eos_token_id
            st["temperature"][slot] = req.temperature
            st["top_p"][slot] = req.top_p
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
        """One scheduler tick: admit queued requests, advance every active
        slot by up to `steps_per_tick` tokens, harvest completions. Ticks
        pipeline one deep; completions surface at most one tick later."""
        if self._queue and self._pending:
            # admissions need no drain (owner snapshots route in-flight
            # tokens); drain only when admission is blocked and an
            # in-flight tick may have freed a slot the mirror cannot
            # predict (an early EOS)
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
        st = self.state
        if not self._slot_owner \
                or not np.any(st["active"][:self.max_slots]):
            self._drain_pending()
            out, self._completions = self._completions, []
            return out
        if self._pending:
            rem = st["remaining"][:self.max_slots][
                st["active"][:self.max_slots]]
            if rem.size and (rem - self._inflight_steps() <= 0).all():
                # every active slot certainly finishes in flight: another
                # tick would be pure waste
                self._drain_pending()
                out, self._completions = self._completions, []
                return out

        self._dev_packed, toks = self._decode_tick(self._packed_in())
        self._tick += 1
        # owner snapshot: this tick's tokens belong to whoever holds the
        # slot NOW, even if the slot is handed over before the fetch
        owners = {s: rs for s, rs in self._slot_owner.items()
                  if st["active"][s]}
        self._pending.append(("tick", toks, owners))
        while len(self._pending) > 1:                  # depth-1 pipeline
            self._process_one(self._pending.popleft())
        out, self._completions = self._completions, []
        return out

    def _inflight_steps(self) -> int:
        """Tokens per still-active slot in the issued-but-unprocessed
        ticks (each tick runs all of its steps)."""
        return self.steps_per_tick * sum(1 for e in self._pending
                                         if e[0] == "tick")

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

    def reseed(self, seed: int) -> None:
        """Reset the sampling generator."""
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
