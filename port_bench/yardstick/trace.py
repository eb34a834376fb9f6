"""Reduce a `torch.profiler` Chrome trace to the run's device numbers.

The harness marks the traced window with a `bench.window` range and each
call of a hand-written kernel with a `pk.<kernel>` range (host side). A
device operation is the kernel's when the runtime call that launched it
(joined by the CUPTI correlation id) lies inside such a range on the same
thread: the kernel proper and whatever its wrapper launches around it
(the mask packing of the attention kernels, output allocation).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
NAME_CHARS = 160     # a kernel's name is cut to this many characters


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def analyze(path: str, top: int = 10) -> dict:
    """-> {"window_s", "busy_s", "kernel_s": {pk name: s}, "device_ops":
    [[name, s]], "idle_gaps": [[host op, s]]}, or {} without a window."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    win = None
    dev, runtime, pk, host = [], {}, defaultdict(list), defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, name,
                        e.get("args", {}).get("correlation")))
        elif cat in RUNTIME_CATS:
            runtime[e.get("args", {}).get("correlation")] = (ts, e.get("tid"))
        elif cat in HOST_CATS:
            if name == "bench.window":
                win = (ts, ts + dur, e.get("tid"))
            elif cat == "user_annotation" and name.startswith("pk."):
                pk[e.get("tid")].append((ts, ts + dur, name[3:]))
            host[e.get("tid")].append((ts, ts + dur, name))
    if win is None:
        return {}
    w0, w1, main = win
    dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    merged = _merge([(max(a, w0), min(b, w1)) for a, b, *_ in dev])
    busy = sum(b - a for a, b in merged)

    for lst in pk.values():
        lst.sort()
    starts = {t: [a for a, _, _ in lst] for t, lst in pk.items()}
    kernel_s: dict = defaultdict(float)
    by_name: dict = defaultdict(float)
    for a, b, name, corr in dev:
        by_name[name] += b - a
        launch = runtime.get(corr)
        if launch is None or launch[1] not in pk:
            continue
        ts, tid = launch
        i = bisect.bisect_right(starts[tid], ts) - 1
        if i >= 0 and pk[tid][i][1] >= ts:
            kernel_s[pk[tid][i][2]] += b - a

    ops = sorted(host.get(main, []))
    op_starts = [a for a, _, _ in ops]
    idle: dict = defaultdict(float)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        label = "(python between ops)"
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(op_starts, mid) - 1
        for j in range(i, max(i - 400, -1), -1):
            a, b, name = ops[j]
            if b >= mid and name != "bench.window":
                label = name
                break
        idle[label] += (g1 - g0)
    us = 1e-6
    return {
        "window_s": (w1 - w0) * us,
        "busy_s": busy * us,
        "kernel_s": {k: v * us for k, v in kernel_s.items()},
        "device_ops": [[k[:NAME_CHARS], v * us] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[k, v * us] for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])[:top]],
    }
