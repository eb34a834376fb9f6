"""The yardstick's arithmetic: the traffic, the rates, the roofline."""

import numpy as np
import pytest

from port_bench.yardstick import readers, traffic, work

MIX = traffic.load_mix("annotate-b128")


def test_same_seed_same_traffic_other_seed_other_order():
    a = traffic.annotate_batch(MIX, 2 ** 33 + 1, 0)
    b = traffic.annotate_batch(MIX, 2 ** 33 + 1, 0)
    c = traffic.annotate_batch(MIX, 2 ** 33 + 2, 0)
    assert a == b
    assert a != c
    # the same work: the same lengths and instruction counts, reordered
    assert sorted(len(p) for _, p in a) == sorted(len(p) for _, p in c)
    assert sorted(i for i, _ in a) == sorted(i for i, _ in c)
    assert a != traffic.annotate_batch(MIX, 2 ** 33 + 1, 1)


def test_lengths_are_clipped_lognormal_quantiles():
    q = traffic.quantile_lengths(128, MIX["protein_length"])
    assert len(q) == 128 and q.min() >= 30 and q.max() == 1022
    assert abs(np.median(q) - 350) <= 3


def test_rate_covers_whole_batches_to_the_end_of_the_last():
    rec = {"batches": [{"rows": 128, "end_s": 4.0},
                       {"rows": 128, "end_s": 8.5},
                       {"rows": 128, "end_s": 13.0}]}
    assert readers.whole_batches_per_s(rec) == pytest.approx(384 / 13.0)
    assert readers.whole_batches_per_s({"batches": []}) is None


@pytest.mark.parametrize("flops_bytes,ms", [
    (work.int8_matmul(5120, 4096, 14336), 0.6080),
    (work.ffn(8 * 512, 1280, 5120), 0.1086),
])
def test_bounds_match_the_kernel_table(flops_bytes, ms):
    assert 1e3 * work.bound_s(*flops_bytes) == pytest.approx(ms, abs=5e-5)


def test_roofline_reads_nothing_without_device_time():
    assert readers.kernel_roofline({"trace": {}}) is None
    rec = {"trace": {"bounds": {"ffn": (33, 0.002)},
                     "kernel_s": {"ffn": 0.004}}}
    assert readers.kernel_roofline(rec) == pytest.approx(50.0)


def test_encoder_row_kernels_count_the_residue_rows():
    import torch
    from port_bench.yardstick.instrument import KernelProbe
    probe = KernelProbe()
    x, w1 = torch.zeros((2, 8, 64)), torch.zeros((64, 256))
    mask = torch.tensor([[1] * 5 + [0] * 3, [1] * 3 + [0] * 5],
                        dtype=torch.bool)
    seen = {}

    def block(p, cfg, x, mask):
        seen["ffn"] = probe._ffn(x, w1)
        seen["out_proj"] = probe._out_proj(x, w1, None, x)
        seen["ln_qkv_rope"] = probe._ln_qkv_rope(x)
    # what the wrapped esm2._block holds while a CUDA block runs
    probe._rows = mask.sum(dtype=torch.float64)
    block(None, None, x, mask)
    for name, want in (("ffn", work.ffn(8, 64, 256)),
                       ("out_proj", work.out_proj(8, 64)),
                       ("ln_qkv_rope", work.ln_qkv_rope(8, 64, 8))):
        fn, lazy = seen[name]
        assert fn(lazy.tolist()) == want
    probe._rows = None
    assert probe._ffn(x, w1) == (work.ffn(16, 64, 256), None)


def test_annotate_idle_and_mfu_read_the_unprofiled_batches():
    rec = {"trace": {"busy_s": 6.0, "window_s": 12.0},
           "batches": [{"traced": False, "device_s": 7.0, "flops": 7e14},
                       {"traced": True, "device_s": 12.0, "flops": 7e14},
                       {"traced": False, "device_s": 8.0, "flops": 7e14}]}
    # the batch after the profiled one is left out with it
    assert readers.device_idle_untraced(rec) == pytest.approx(
        100 * (1 - 6.0 / 7.0))
    assert readers.mfu_untraced(rec) == pytest.approx(
        100 * 7e14 / (7.0 * work.PEAK_BF16_FLOPS))
    assert readers.mfu_untraced({"batches": rec["batches"][1:]}) is None
