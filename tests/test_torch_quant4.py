"""Port parity: opus_pllm_tpu_torch.kernels.quant4 vs
opus_pllm_tpu.kernels.quant4 (int4 weights, v2 word layout).

Packing is held to identical bytes (the same weights give the same int32
words, so `from_jax` is a copy). The matmul is held to the JAX Pallas
kernel `_pallas_v2` in interpret mode and to the JAX `_matmul_xla` route,
with each tolerance explained where it is used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opus_pllm_tpu.core.config import DecoderConfig as JDecoderConfig
from opus_pllm_tpu.kernels import quant4 as jq
from opus_pllm_tpu.models import decoder as jdec
from opus_pllm_tpu_torch.core import convert
from opus_pllm_tpu_torch.core.config import DecoderConfig
from opus_pllm_tpu_torch.kernels import quant4
from opus_pllm_tpu_torch.models import decoder
from opus_pllm_tpu_torch.models.layers import dense


def _t(a):
    return torch.from_numpy(np.array(a))


def _w(seed, k, n):
    return np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)


@pytest.mark.parametrize("k,n,jnp_input", [(1024, 384, False),
                                           (512, 256, True)])
def test_quantize_and_pack_bytes_match_jax(k, n, jnp_input):
    """Same scales, same int4 values, same int32 words as the JAX package,
    from numpy or jnp weights. The words are built in int64 and wrapped
    (torch has little uint32): the top nibble reaches the sign bit."""
    w = _w(0, k, n)
    qj, sj = jq.quantize_grouped(jnp.asarray(w) if jnp_input else w)
    pj = np.asarray(jq.pack_int4_v2(np.asarray(qj)))
    qt, st = quant4.quantize_grouped(_t(w))
    pt = quant4.pack_int4_v2(qt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert pt.dtype == torch.int32 and pt.shape == (k // 8, n)
    np.testing.assert_array_equal(pt.numpy(), pj)
    assert (pt < 0).any()                        # sign bit in use
    np.testing.assert_array_equal(quant4.unpack_int4_v2(pt).numpy(),
                                  np.asarray(jq.unpack_int4_v2(pj)))


def test_quantize_linear4_layouts():
    """The layout rule of the JAX package (quant4.py:173-184): v2 words
    where K % 512 == 0, v1 nibble bytes where K % 512 != 0 or with
    layout="v1" (the training layout), K % 256 != 0 unquantized; the port
    gives the same bytes in each case."""
    p = {"kernel": _w(1, 1024, 128), "bias": np.ones(128, np.float32)}
    ref = jq.quantize_linear4(p)
    got = quant4.quantize_linear4({k: _t(v) for k, v in p.items()})
    assert set(got) == set(ref) == {"kernel_p", "gscale", "bias"}
    np.testing.assert_array_equal(got["kernel_p"].numpy(), ref["kernel_p"])
    np.testing.assert_array_equal(got["gscale"].numpy(), ref["gscale"])
    for w, layout in ((_w(2, 768, 128), "auto"), (_w(3, 1024, 128), "v1")):
        ref = jq.quantize_linear4({"kernel": w}, layout)
        got = quant4.quantize_linear4({"kernel": _t(w)}, layout)
        assert ref["kernel_p"].dtype == np.int8      # JAX: v1 bytes there
        assert got["kernel_p"].dtype == torch.int8
        np.testing.assert_array_equal(got["kernel_p"].numpy(),
                                      ref["kernel_p"])
    assert quant4.quantize_linear4({"kernel": _t(_w(4, 300, 8))}) is None
    assert jq.quantize_linear4({"kernel": _w(4, 300, 8)}) is None


def test_plain_matches_pallas_v2_interpret():
    """int4_matmul's plain version vs the TPU kernel (interpret mode), at
    the shape of tests/test_quant4.py. Both round x to bf16, keep the scales
    fp32 and scale fp32 partials; the Pallas kernel folds the +136 weight
    bias out with 136 * sum(x) per group, which cancels ~136x larger terms
    in fp32: bound 2e-5 of max|y| (measured ~3e-6)."""
    rng = np.random.default_rng(10)
    m, k, n = 16, 1536, 256
    x = rng.normal(size=(m, k)).astype(np.float32)
    q, s = jq.quantize_grouped(_w(11, k, n))
    packed = jq.pack_int4_v2(q)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jq.int4_matmul(jnp.asarray(x), jnp.asarray(packed),
                                        jnp.asarray(s), impl="pallas"))
    got = quant4.int4_matmul(_t(x), _t(packed), _t(s)).numpy()
    assert got.dtype == np.float32 and got.shape == (m, n)
    assert np.abs(got - ref).max() <= 2e-5 * np.abs(ref).max()


def test_dequant_route_matches_jax_xla_and_gscale_rounding():
    """M > 64 takes the `_matmul_xla` route in both packages: identical
    roundings (scales and weights to bf16), only fp32 summation order
    differs (bound 2e-6 of max|y|). The kernel's function keeps the scales
    fp32, so it parts from `_matmul_xla` by the bf16 rounding of
    the scales and dequantized weights (up to ~2^-8 relative per weight,
    bound 1e-2 of max|y|) and sits closer to the fp32-scale product."""
    rng = np.random.default_rng(12)
    k, n = 1024, 256
    q, s = jq.quantize_grouped(_w(13, k, n))
    packed = jq.pack_int4_v2(q)
    exact_w = (q.astype(np.float32).reshape(k // 128, 128, n)
               * s[:, None, :]).reshape(k, n)
    for m in (65, 8):
        x = rng.normal(size=(m, k)).astype(np.float32)
        xla = np.asarray(jq.int4_matmul(jnp.asarray(x), jnp.asarray(packed),
                                        jnp.asarray(s), impl="xla"))
        got = quant4.int4_matmul(_t(x), _t(packed), _t(s)).numpy()
        scale = np.abs(xla).max()
        if m > quant4.KERNEL_MAX_M:
            np.testing.assert_array_equal(
                got, quant4.dequant_matmul(_t(x), _t(packed), _t(s)).numpy())
            assert np.abs(got - xla).max() <= 2e-6 * scale
        else:
            np.testing.assert_array_equal(got, quant4.int4_matmul_plain(
                _t(x), _t(packed), _t(s)).numpy())
            exact = x.astype(jnp.bfloat16).astype(np.float32) @ exact_w
            assert np.abs(got - xla).max() <= 1e-2 * scale
            assert np.abs(got - exact).max() < np.abs(xla - exact).max()


def test_qdense4_folds_batch_and_adds_bias():
    """(B, S, K) input with a bias through `layers.dense`, vs JAX qdense4:
    B*S = 80 rows take the dequantize route in both (bound 2e-6 of max|y|,
    fp32 order); the bias is added in fp32 and rounded to x's dtype."""
    rng = np.random.default_rng(14)
    p = {"kernel": _w(15, 512, 128), "bias": rng.normal(size=128).astype(
        np.float32)}
    jp = jq.quantize_linear4(p)
    tp = {k: _t(v) for k, v in jp.items()}
    x = rng.normal(size=(4, 20, 512)).astype(np.float32)
    ref = np.asarray(jq.qdense4(jax.tree.map(jnp.asarray, jp),
                                jnp.asarray(x)))
    got = dense(tp, _t(x)).numpy()
    assert got.shape == (4, 20, 128)
    assert np.abs(got - ref).max() <= 2e-6 * np.abs(ref).max()
    # "kernel_q" goes to the int8 route, which refuses int4 words
    with pytest.raises(ValueError):
        dense({"kernel_q": tp["kernel_p"], "scale": tp["gscale"]}, _t(x))


def _cfgs(dtype):
    kw = dict(vocab_size=256, hidden_size=512, intermediate_size=1024,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
              dtype=dtype)
    return JDecoderConfig(**kw), DecoderConfig(**kw)


def test_quantize_decoder4_matches_jax_and_converts():
    """The port's quantize_decoder4 on converted weights gives the same
    leaves as the JAX one; from_jax copies JAX's int4 v2 tree and its v1
    bytes (layout="v1"); int8 trees are copied, fused ones refused."""
    jcfg, _ = _cfgs("float32")
    jp = jdec.init(jax.random.PRNGKey(0), jcfg)
    ref = convert.decoder_from_jax(jax.tree.map(
        np.asarray, jq.quantize_decoder4(jax.tree.map(np.asarray, jp))),
        device="cpu")
    got = quant4.quantize_decoder4(
        convert.decoder_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    assert quant4.quant_layout_of(got) == "int4-v2"
    assert jq.quant_layout_of(jq.quantize_decoder4(jp)) == "int4-v2"
    flat = lambda t: jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda a: a.numpy(), t))[0]
    for (pa, a), (pb, b) in zip(flat(got), flat(ref)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)
    j1 = jax.tree.map(np.asarray, jq.quantize_decoder4(jp, layout="v1"))
    t1 = convert.decoder_from_jax(j1, device="cpu")
    assert quant4.quant_layout_of(t1) == "int4-v1"
    np.testing.assert_array_equal(t1["layers"][0]["q_proj"]["kernel_p"],
                                  j1["layers"][0]["q_proj"]["kernel_p"])
    # int8 trees cross over as they are (kernels/quant.py); fused
    # projections stay refused
    from opus_pllm_tpu.kernels.quant import quantize_decoder
    j8 = jax.tree.map(np.asarray, quantize_decoder(jp))
    t8 = convert.decoder_from_jax(j8, device="cpu")
    assert quant4.quant_layout_of(t8) == "int8"
    np.testing.assert_array_equal(t8["layers"][0]["q_proj"]["kernel_q"],
                                  j8["layers"][0]["q_proj"]["kernel_q"])
    with pytest.raises(NotImplementedError):
        convert.decoder_from_jax(jax.tree.map(np.asarray, quantize_decoder(
            jdec.fuse_projections(jp, jcfg))), device="cpu")


def test_quantized_head_rounds_logits_to_bf16():
    """A quantized vocab head goes through `dense` (decoder.py:638-639), so
    bf16 hidden states give logits rounded to bf16 before fp32, in both
    packages. 72 rows take the dequantize route in both: the logits agree
    to one bf16 rounding step (fp32 order can move a value across a
    rounding boundary: bound 2^-7 of max|logit|)."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jq.quantize_decoder4(jdec.init(jax.random.PRNGKey(1), jcfg))
    tp = convert.decoder_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    h = np.random.default_rng(3).normal(size=(72, 512)).astype(np.float32)
    ref = np.asarray(jdec.head_logits(jp, jcfg,
                                      jnp.asarray(h, jnp.bfloat16)))
    got = decoder.head_logits(tp, tcfg, _t(h).bfloat16())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, got.bfloat16().float(), rtol=0, atol=0)
    assert np.abs(got.numpy() - ref).max() <= 2 ** -7 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# The tensor-core v2 kernel's host side: its launch plan and the word trick
# its A fragments rest on
# ---------------------------------------------------------------------------

DECODE_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                 (4096, 128256))


@pytest.mark.parametrize("m", [1, 3, 8, 9, 16, 17, 33, 64])
@pytest.mark.parametrize("k,n", DECODE_SHAPES + ((512, 4), (1536, 260),
                                                 (28672, 1024)))
def test_v2_plan_splits_k_over_a_cluster_without_empty_ctas(m, k, n):
    """Whole superblocks a CTA, every K row covered once, no CTA of a
    cluster without work, at most 8 CTAs a cluster (the portable limit),
    one or two 8-row x tiles a CTA."""
    mt, cs, per = quant4.v2_plan(m, n, k)
    n_sb = k // quant4.SUPER
    assert mt == (1 if m <= 8 else 2)
    assert 1 <= cs <= quant4.V2_MAX_CLUSTER and per >= 1
    assert (cs - 1) * per < n_sb <= cs * per
    # split far enough to come within half of the CTA target, or as far as
    # K and the cluster limit allow
    tiles = -(-n // quant4.V2_COLS) * -(-m // (8 * mt))
    assert 2 * tiles * cs >= min(quant4.TARGET_CTAS,
                                 tiles * min(n_sb, quant4.V2_MAX_CLUSTER))


def test_v2_plan_at_the_decode_shapes():
    """M = 8: the narrow outputs split K over a cluster, the wide ones and
    the vocab head do not; the unaligned kernel takes N % 4 != 0 only."""
    plans = {(k, n): quant4.v2_plan(8, n, k) for k, n in DECODE_SHAPES}
    assert plans == {(4096, 4096): (1, 4, 2), (4096, 1024): (1, 8, 1),
                     (4096, 14336): (1, 1, 8), (14336, 4096): (1, 5, 6),
                     (4096, 128256): (1, 1, 8)}
    assert [quant4.v2_kernel_variant(n) for n in (4, 130, 1024, 1026)] == [
        "int4_matmul", "int4_matmul_unaligned", "int4_matmul",
        "int4_matmul_unaligned"]


def test_v2_word_is_an_a_fragment_register():
    """((w >> 4g) & 0x000F000F) | 0x43004300, read as two bf16 and minus
    136, is group g's weights of K rows 2i (low half) and 2i + 1 (high
    half) for word row i, exactly: the kernel's A operand needs no
    shuffle."""
    rng = np.random.default_rng(5)
    q = rng.integers(-7, 8, size=(1024, 8)).astype(np.int8)
    words = quant4.pack_int4_v2(_t(q)).numpy().view(np.uint32)   # (128, 8)
    for g in range(4):
        bits = ((words >> np.uint32(4 * g)) & np.uint32(0x000F000F)) \
            | np.uint32(0x43004300)
        pair = (bits.astype("<u4").view("<u2").reshape(128, 8, 2)
                .astype(np.uint32) << 16).view(np.float32) - 136.0
        i = np.arange(128)
        rows = (i // 64) * 512 + 128 * g + 2 * (i % 64)
        assert np.array_equal(pair[..., 0], q[rows].astype(np.float32))
        assert np.array_equal(pair[..., 1], q[rows + 1].astype(np.float32))
