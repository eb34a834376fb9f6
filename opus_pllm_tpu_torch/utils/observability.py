"""Logging, step timing, throughput meters and profiler traces (port of
`opus_pllm_tpu/utils/observability.py`).

* `build_logger`: a console handler and, on rank 0, a rotating file one
* `rank0_print`: print on rank 0 only
* `StepTimer` / `Throughput`: step timing with an EMA; items/s and
  tokens/s, also per GPU
* `profile_trace` / `annotate`: a `torch.profiler.profile` scope that
  writes a TensorBoard-loadable trace, and a named region in it
  (`torch.profiler.record_function`), where the JAX module uses
  `jax.profiler`

The rank is `torch.distributed`'s when a process group is up, else 0 (a
single process).
"""

from __future__ import annotations

import contextlib
import logging
import logging.handlers
import os
import time
from typing import Dict, Iterator, Optional

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


class StepTimer:
    """Wall-clock step timer with an EMA; call `tick()` once per step."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg_s: Optional[float] = None
        self._last: Optional[float] = None
        self.steps = 0

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.avg_s = dt if self.avg_s is None else \
                self.ema * self.avg_s + (1 - self.ema) * dt
            self.steps += 1
        self._last = now
        return dt


class Throughput:
    """items/s and tokens/s, and the same per GPU (the process's visible
    CUDA devices, at least 1)."""

    def __init__(self):
        self.items = 0
        self.tokens = 0
        self._t0 = time.perf_counter()

    def add(self, items: int = 0, tokens: int = 0) -> None:
        self.items += items
        self.tokens += tokens

    def report(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        chips = max(torch.cuda.device_count(), 1)
        return {"seconds": dt,
                "items_per_sec": self.items / dt,
                "tokens_per_sec": self.tokens / dt,
                "items_per_sec_per_chip": self.items / dt / chips,
                "tokens_per_sec_per_chip": self.tokens / dt / chips}


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """A torch.profiler scope (CPU, and CUDA when available) whose trace
    lands in `log_dir` for TensorBoard; a no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in profiler timelines."""
    with torch.profiler.record_function(name):
        yield
