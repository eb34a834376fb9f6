"""The grouped expert GEMM's share of its roofline: 100 x Σ bound / Σ
device time over the traced batch's recorded `pk.moe_grouped_gemm` calls
(`yardstick/moe_probe.py`: the eager calls, the prefill's and the warm-up
step's; a replayed decode step's launches carry no range). None where no
such call was traced."""


def read(rec):
    tr = rec.get("trace") or {}
    bound = (tr.get("bounds") or {}).get("moe_grouped_gemm")
    dev = (tr.get("kernel_s") or {}).get("moe_grouped_gemm")
    if not bound or not dev:
        return None
    return 100.0 * bound[1] / dev
