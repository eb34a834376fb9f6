"""The kernel probe of the sparse-expert cells: `KernelProbe` with the
grouped expert GEMM (`kernels/moe.grouped_gemm`) added to its targets, and
no call recorded while a stream captures a CUDA graph.

A decode step captured as a graph launches its kernels at every replay
with no Python call and no `pk.` range around them, so a record made at
the capture would add a bound with no device time. The probe therefore
records the eager calls only: the prefill's and the eager warm-up step's.
Each record's bound is the larger of 2 K N FLOPs a pair at the bf16 peak
and the bytes of the experts with a pair, the rows in and the output out,
at the HBM peak (`yardstick.deepseek.moe_grouped_gemm`); the experts with
a pair are counted on the device and read after the window.
"""

from __future__ import annotations

import importlib.util

import torch

from port_bench.yardstick import deepseek
from port_bench.yardstick.instrument import PKG, KernelProbe, Tracer


class MoEProbe(KernelProbe):
    def _moe(self, x, w, offsets, *, swiglu=False, impl="auto"):
        p, k = x.shape
        n = w.shape[2]
        hit = (offsets[1:] > offsets[:-1]).sum(dtype=torch.float64)
        return (lambda t: deepseek.moe_grouped_gemm(p, k, n, t, swiglu)), \
            hit

    def _targets(self):
        out = super()._targets()
        if importlib.util.find_spec(f"{PKG}.moe") is not None:
            out.append(("moe", "grouped_gemm", "moe_grouped_gemm",
                        self._moe))
        return out

    def _wrap(self, orig, name, rec):
        recorded = super()._wrap(orig, name, rec)

        def wrapper(*a, **kw):
            if torch.cuda.is_available() \
                    and torch.cuda.is_current_stream_capturing():
                return orig(*a, **kw)
            return recorded(*a, **kw)
        return wrapper


class MoETracer(Tracer):
    """`Tracer` with the `MoEProbe`."""

    def __init__(self, batch: int = 1):
        super().__init__(batch)
        self.probe = MoEProbe()
