"""Arithmetic the metric readers share. Each takes the run's record and
returns a number, or None where the record holds nothing to read (then
the metric is left out of the result line)."""

from __future__ import annotations

from . import work


def whole_batches_per_s(rec: dict, key: str = "rows"):
    """Units of the whole batches or steps completed in the window, over
    the time from the window's start to the end of the last of them."""
    done = rec.get("batches") or []
    if not done:
        return None
    return sum(b[key] for b in done) / done[-1]["end_s"]


def kernel_roofline(rec: dict):
    """100 x Σ bound time / Σ device time over the hand-written kernels
    that ran in the traced sub-window."""
    tr = rec.get("trace") or {}
    bound = dev = 0.0
    for name, (_, b) in (tr.get("bounds") or {}).items():
        d = tr.get("kernel_s", {}).get(name)
        if d:
            bound += b
            dev += d
    return 100.0 * bound / dev if dev > 0 else None


def mfu(rec: dict):
    """100 x model FLOPs of the traced sub-window's work / (its length x
    the bf16 peak)."""
    tr = rec.get("trace") or {}
    if not tr.get("window_s") or not tr.get("model_flops"):
        return None
    return 100.0 * tr["model_flops"] / (tr["window_s"]
                                        * work.PEAK_BF16_FLOPS)


def device_idle(rec: dict):
    """100 x the share of the traced sub-window with no device operation
    running."""
    tr = rec.get("trace") or {}
    if not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def before_profiled(rec: dict) -> list:
    """The window's batches before the profiled one (all of them in a run
    without one): the profiler slows the host side of its own batch, and
    its teardown the batch after it."""
    out = []
    for b in rec.get("batches") or []:
        if b.get("traced"):
            break
        out.append(b)
    return out


def _untraced(rec: dict):
    return [b for b in before_profiled(rec) if b.get("device_s")]


def mfu_untraced(rec: dict):
    """100 x model FLOPs of the window's batches before the profiled one /
    (their length on the device's clock x the bf16 peak)."""
    done = _untraced(rec)
    if not done:
        return None
    return 100.0 * sum(b["flops"] for b in done) / (
        sum(b["device_s"] for b in done) * work.PEAK_BF16_FLOPS)


def device_idle_untraced(rec: dict):
    """100 x the share of a batch's length before the profiled one (device
    clock, their mean) in which the profiled batch's device operations did
    not run: every batch does the same work, and the profiler slows only
    the host side."""
    tr = rec.get("trace") or {}
    done = _untraced(rec)
    if tr.get("busy_s") is None or not done:
        return None
    length = sum(b["device_s"] for b in done) / len(done)
    return 100.0 * (1.0 - tr["busy_s"] / length)
