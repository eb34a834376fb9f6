"""Logging, and the port's spans and counters (port of
`opus_pllm_tpu/utils/observability.py`, whose step timers, throughput
meters and `jax.profiler` scope the recorder below replaces).

* `build_logger`: a console handler and, on rank 0, a rotating file one
* `rank0_print`: print on rank 0 only
* `SPANS`, `span`, `count`: the process's recorder. `span(name,
  device=None, **attrs)` is a context manager that records the span's
  name, its start and end on `time.perf_counter_ns()`, its parent (the
  span open on the same thread when it opened), its thread and its
  attributes, among them whether a `torch.profiler` profile was recording
  when it opened (`profiled`). A span opened with a CUDA `device` also
  records a pair of timing events on that device's current stream; they
  are resolved to a device-clock duration only when the span is read, so
  no span synchronizes (on the CPU the device duration is the host one).
  Spans go to a bounded in-memory ring (`RING_SPANS`), counters
  (`count(name, n)`, host-known values only) to plain ints behind one
  lock; nothing is written until `export_chrome` is asked for. Under a
  recording profiler a span also enters `record_function(name)`, so it
  stands in the profiler's trace on the clock of the device's kernels.
  The recorder is on by default; `SPANS.enabled = False` makes `span()`
  return one shared no-op context and `count()` return at once.
* `prof_range` / `ranged`: ranges entered into a recording profiler only
  (never into the ring), for the finer structure of a span: a decoder
  layer, a run of the nucleus bisection's passes, a run of a per-leaf
  loop.

The rank is `torch.distributed`'s when a process group is up, else 0 (a
single process).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import logging.handlers
import os
import threading
import time
from typing import Iterable, Optional

import torch


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank0_print(*args, **kwargs) -> None:
    if _rank() == 0:
        print(*args, **kwargs)


def build_logger(name: str, log_file: Optional[str] = None,
                 level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter(
        "%(asctime)s | %(levelname)s | %(name)s | %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file and _rank() == 0:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=32 * 1024 * 1024, backupCount=3)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if _rank() != 0:
        logger.setLevel(logging.WARNING)
    return logger




# ---- spans and counters -------------------------------------------------

RING_SPANS = 65536          # spans the ring keeps, the oldest dropped first
_NOOP = contextlib.nullcontext()
# whether a profiler records is one read of the flag torch's profiler
# sets while it records: `_AP._is_profiler_enabled`
_AP = torch.autograd.profiler


def prof_range(name: str):
    """A `record_function(name)` range while a profiler records, else a
    shared no-op context. Never recorded in the ring."""
    if _AP._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NOOP


def ranged(items: Iterable, name: str, every: int) -> Iterable:
    """`items`, each run of `every` of them inside a profiler range `name`
    while a profiler records (`items` itself otherwise): a loop of many
    small operations stays within reach of the range that names it."""
    if not _AP._is_profiler_enabled:
        return items
    return _ranged(iter(items), name, every)


def _ranged(it, name, every):
    while True:
        run = list(itertools.islice(it, every))
        if not run:
            return
        with torch.profiler.record_function(name):
            yield from run


def _cuda_event(device):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class Span:
    """One span (see the module docstring). `events` is None for a host
    span, () for a device span on the CPU, else (start, end) CUDA events."""

    __slots__ = ("name", "id", "parent", "thread", "attrs", "start_ns",
                 "end_ns", "device", "events", "_rec", "_rf")

    def __init__(self, rec, name: str, device, attrs: dict):
        self._rec, self.name, self.attrs = rec, name, attrs
        self.device = device
        self.events = None if device is None else ()
        self.id = next(rec._ids)
        self.parent = None
        self.thread = threading.current_thread().name
        self.start_ns = self.end_ns = 0
        self._rf = None

    def __enter__(self) -> "Span":
        rec = self._rec
        prof = self.attrs["profiled"] = _AP._is_profiler_enabled
        if prof:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        stack = rec._stack()
        if stack:
            self.parent = stack[-1].id
        stack.append(self)
        if self.device is not None and self.device.type == "cuda":
            rec._anchor_once(self.device)
            self.events = (_cuda_event(self.device),)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.events:
            self.events = (self.events[0], _cuda_event(self.device))
        self.end_ns = time.perf_counter_ns()
        self._rec._stack().pop()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        self._rec._ring.append(self)
        return False

    @property
    def host_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def host_ms(self) -> float:
        return self.host_ns / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """The span on the device's clock (waits for its end event), the
        host duration for a device span on the CPU, None for a host
        span."""
        if self.events is None:
            return None
        if not self.events:
            return self.host_ms
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


class Recorder:
    """Spans in a ring and counters, for the whole process (`SPANS`)."""

    def __init__(self, ring: int = RING_SPANS):
        self.enabled = True
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self._local = threading.local()
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._counters: dict = {}
        # (host ns, CUDA event) taken together after a synchronize: at the
        # first device span, then at each export
        self.anchors: list = []

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, device=None, **attrs):
        """A context manager recording span `name` (module docstring);
        `device`: a torch.device (or its name) whose clock the span also
        reads. Yields the `Span`, or None while the recorder is off."""
        if not self.enabled:
            return _NOOP
        return Span(self, name, None if device is None
                    else torch.device(device), attrs)

    def count(self, name: str, n: int = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def counters(self) -> dict:
        with self._lock:
            return dict(self._counters)

    def spans(self) -> list:
        """The ring's spans, in the order they closed (a parent after its
        children)."""
        return list(self._ring)

    def _anchor(self, device) -> None:
        torch.cuda.synchronize(device)
        host = time.perf_counter_ns()
        ev = _cuda_event(device)
        ev.synchronize()
        self.anchors.append((host, ev))

    def _anchor_once(self, device) -> None:
        if not self.anchors:
            self._anchor(device)

    def export_chrome(self, path: str, pid: int = 0) -> str:
        """Write the ring and the counters to `path` as a Chrome trace
        (chrome://tracing, Perfetto): each thread's host spans on a track of
        their own, the device-clock durations of the device spans on a
        "device clock" track placed on the host timeline by the first
        anchor, the counters as counter events at the export. The drift
        between the host's and the device's clock from the first anchor to
        the export's is in `otherData`."""
        spans = sorted(self.spans(), key=lambda s: s.start_ns)
        cuda = next((s.device for s in spans if s.events), None)
        if cuda is not None:
            self._anchor(cuda)
        tids: dict = {}
        events = [{"ph": "M", "name": "process_name", "pid": pid,
                   "args": {"name": f"opus-pllm rank {pid}"}}]

        def tid(thread: str) -> int:
            if thread not in tids:
                tids[thread] = len(tids) + 1
                events.append({"ph": "M", "name": "thread_name", "pid": pid,
                               "tid": tids[thread], "args": {"name": thread}})
            return tids[thread]

        dev_tid = tid("device clock")
        first = self.anchors[0] if self.anchors else None
        for s in spans:
            args = dict(s.attrs, id=s.id, parent=s.parent)
            events.append({"ph": "X", "cat": "host", "name": s.name,
                           "pid": pid, "tid": tid(s.thread),
                           "ts": s.start_ns / 1e3, "dur": s.host_ns / 1e3,
                           "args": args})
            ms = s.device_ms
            if ms is None:
                continue
            ts = s.start_ns / 1e3
            if s.events and first is not None:
                ts = first[0] / 1e3 + first[1].elapsed_time(
                    s.events[0]) * 1e3
            events.append({"ph": "X", "cat": "device", "name": s.name,
                           "pid": pid, "tid": dev_tid, "ts": ts,
                           "dur": ms * 1e3, "args": args})
        now = time.perf_counter_ns() / 1e3
        for name, v in sorted(self.counters().items()):
            events.append({"ph": "C", "name": name, "pid": pid, "ts": now,
                           "args": {"value": v}})
        other = {"spans": len(spans), "ring": self._ring.maxlen}
        if len(self.anchors) > 1:
            (h0, e0), (h1, e1) = self.anchors[0], self.anchors[-1]
            other["clock_drift_us"] = ((h1 - h0) / 1e3
                                       - e0.elapsed_time(e1) * 1e3)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "otherData": other}, f, default=str)
        return path


SPANS = Recorder()
span = SPANS.span
count = SPANS.count
