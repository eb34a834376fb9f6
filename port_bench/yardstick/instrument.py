"""Ranges and work records around the port's kernel launchers, for the
traced run only.

Each launcher below is wrapped, for the life of a `KernelProbe`, by a
function that records the call's work (`yardstick.work`, from the shapes
and masks it was given) and runs it inside a `pk.<name>` profiler range,
so that `yardstick.trace` can give each kernel its device time. What the
masks let through is summed on the device and read once, after the
window. The ESM2 block is wrapped too, to hand its key mask to the
encoder's row-wise kernels, which are not given it: they are counted over
the residue rows, not the bucket's padding. A launcher the port no longer
has is skipped, and its kernel then reports nothing.
"""

from __future__ import annotations

import importlib
from contextlib import contextmanager

import torch

from . import work

PKG = "opus_pllm_tpu_torch.kernels"
ESM2 = "opus_pllm_tpu_torch.models.esm2"


def _pairs(mask, sq, skv, causal):
    """Mask-true (query, key) pairs over the batch, a 0-d device tensor
    (or a number without a mask)."""
    if mask is None:
        return None
    m = mask[:, 0] if mask.dim() == 4 else mask
    if causal:
        tri = torch.ones((sq, skv), dtype=torch.bool,
                         device=m.device).tril(skv - sq)
        m = m & tri
    return m.sum(dtype=torch.float64)


class KernelProbe:
    def __init__(self):
        self.calls = []          # (name, fn(resolved) -> (flops, bytes), lazy)
        self._saved = []
        self._rows = None        # the current ESM2 block's valid rows

    # ---- records -------------------------------------------------------

    def _rowwise(self, x, fn):
        """A row-wise encoder kernel's record: its work `fn(rows)` over the
        rows the current ESM2 block's key mask lets through (summed on the
        device), or over every row where the block had none."""
        if self._rows is None:
            return fn(x.shape[0] * x.shape[1]), None
        return fn, self._rows

    def _ln_qkv_rope(self, x, *a, **k):
        s, e = x.shape[1], x.shape[2]
        return self._rowwise(x, lambda t: work.ln_qkv_rope(t, e, s))

    def _encoder_attention(self, qkv, mask=None, **k):
        _, b, h, s, d = qkv.shape
        if mask is None:
            return work.encoder_attention(h, d, b * s, b * s * s), None
        v = mask.sum(1, dtype=torch.float64)
        lazy = torch.stack([v.sum(), (v * v).sum()])
        return (lambda t: work.encoder_attention(h, d, t[0], t[1])), lazy

    def _out_proj(self, a, w, b, x, **k):
        e = x.shape[2]
        return self._rowwise(x, lambda t: work.out_proj(t, e))

    def _ffn(self, x, w1, *a, **k):
        e, f = x.shape[2], w1.shape[1]
        return self._rowwise(x, lambda t: work.ffn(t, e, f))

    def _flash(self, q, k, v, mask, causal, *a, **kw):
        b, sq, hq, d = q.shape
        skv, hkv = k.shape[1], k.shape[2]
        lazy = _pairs(mask, sq, skv, causal)
        full = b * (sq * (sq + 1) / 2 if causal else sq * skv)
        fn = (lambda t: work.flash_attention(
            b, sq, skv, hq, hkv, d, full if t is None else t))
        return (fn, lazy) if lazy is not None else (fn(None), None)

    def _bwd(self, part):
        def rec(q, k, v, mask, lse, delta, g, *, causal=False):
            b, s, hq, d = q.shape
            hkv = k.shape[2]
            lazy = _pairs(mask, s, s, causal)
            full = b * (s * (s + 1) / 2 if causal else s * s)
            fn = (lambda t: work.flash_attention_bwd(
                b, s, hq, hkv, d, full if t is None else t, part))
            return (fn, lazy) if lazy is not None else (fn(None), None)
        return rec

    def _int8(self, x, wq, scale, *a, **k):
        kk, n = wq.shape
        return work.int8_matmul(x.numel() // kk, kk, n), None

    def _decode(self, name, q, k_leaf, v_leaf, mask4, *a, **k):
        b, _, hq, d = q.shape
        hkv = k_leaf["s"].shape[1]
        lazy = mask4.sum(dtype=torch.float64)
        return (lambda t: work.decode_attention_int8(b, hq, hkv, d, t)), \
            lazy

    # ---- install -------------------------------------------------------

    def _targets(self):
        return [
            ("fused_encoder", "ln_qkv_rope", "ln_qkv_rope",
             self._ln_qkv_rope),
            ("fused_encoder", "encoder_attention", "encoder_attention",
             self._encoder_attention),
            ("fused_encoder", "out_proj", "out_proj", self._out_proj),
            ("fused_encoder", "ffn", "ffn", self._ffn),
            ("flash_attention", "_kernel", "flash_attention", self._flash),
            ("flash_attention_bwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dq", self._bwd("dq")),
            ("flash_attention_bwd", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dkv", self._bwd("dkv")),
            ("quant", "_kernel", "int8_matmul", self._int8),
            ("decode_attention", "_kernel", "decode_attention", self._decode),
        ]

    def _block(self, orig):
        """esm2._block with its key mask's valid rows held for the
        encoder kernels it calls."""
        def block(p, cfg, x, mask, *a, **k):
            self._rows = (mask.sum(dtype=torch.float64)
                          if mask is not None and x.is_cuda else None)
            try:
                return orig(p, cfg, x, mask, *a, **k)
            finally:
                self._rows = None
        return block

    @contextmanager
    def installed(self):
        for mod_name, attr, name, rec in self._targets():
            mod = importlib.import_module(f"{PKG}.{mod_name}")
            orig = getattr(mod, attr, None)
            if orig is None:
                continue
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(orig, name, rec))
        esm2 = importlib.import_module(ESM2)
        orig = getattr(esm2, "_block", None)
        if orig is not None:
            self._saved.append((esm2, "_block", orig))
            esm2._block = self._block(orig)
        try:
            yield self
        finally:
            for mod, attr, orig in reversed(self._saved):
                setattr(mod, attr, orig)
            self._saved.clear()

    def _wrap(self, orig, name, rec):
        def wrapper(*a, **kw):
            if name == "decode_attention":
                kname = a[0]
            else:
                kname = name
            if not _on_cuda(a):
                return orig(*a, **kw)
            self.calls.append((kname, *rec(*a, **kw)))
            with torch.profiler.record_function(f"pk.{kname}"):
                return orig(*a, **kw)
        return wrapper

    def bounds(self) -> dict:
        """{kernel: (calls, Σ bound seconds)} over the recorded calls."""
        out: dict = {}
        for name, desc, lazy in self.calls:
            if lazy is not None:
                t = lazy.cpu().tolist()
                desc = desc(t)
            n, s = out.get(name, (0, 0.0))
            out[name] = (n + 1, s + work.bound_s(*desc))
        return out


def _on_cuda(args) -> bool:
    for x in args:
        if isinstance(x, torch.Tensor):
            return x.is_cuda
    return False


class Tracer:
    """A run's traced sub-window: window batch or step `batch`, profiled
    with the kernel launchers wrapped, inside a `bench.window` range."""

    def __init__(self, batch: int = 1):
        self.batch = batch
        self.probe = KernelProbe()
        self.prof = None
        self.lengths = None      # the batch's served lengths, where known

    @contextmanager
    def profiled(self, device):
        with self.probe.installed():
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            with self.prof:
                with torch.profiler.record_function("bench.window"):
                    yield
                    if torch.device(device).type == "cuda":
                        torch.cuda.synchronize()
