"""Port parity: int8 weight-only quantization and the int8 matmul
(opus_pllm_tpu_torch.kernels.quant) against opus_pllm_tpu/kernels/quant.py.

Quantized bytes and scales must be identical: jnp.round and torch.round both
round half to even, and the test feeds exact half-way values to show it. The
plain version of the CUDA kernel (`int8_matmul_plain`) is held to the Pallas
kernel in interpret mode, `dequant_matmul` to `_matmul_xla`, and the decoder
with int8 weights to the JAX decoder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opus_pllm_tpu.core.config import DecoderConfig as JDecoderConfig
from opus_pllm_tpu.kernels import quant as jq
from opus_pllm_tpu.models import decoder as jdec
from opus_pllm_tpu_torch.core import convert
from opus_pllm_tpu_torch.core.config import DecoderConfig
from opus_pllm_tpu_torch.kernels import quant, quant4
from opus_pllm_tpu_torch.models import decoder
from opus_pllm_tpu_torch.models.layers import dense


def _t(a):
    return torch.from_numpy(np.array(a))


def _w(k, n, seed=0):
    return np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)


def test_quantize_per_channel_is_exact_with_ties():
    w = _w(64, 9)
    # a column whose absmax is 127 has scale exactly 1: put half-way values
    # there (2.5 -> 2, 3.5 -> 4 under round-half-to-even)
    w[:, 0] = np.random.default_rng(1).integers(-60, 60, 64) + 0.5
    w[0, 0] = 127.0
    w[:, 1] = 0.0                                  # scale clamps to 1e-8
    jqv, js = jq.quantize_per_channel(jnp.asarray(w))
    tq, ts = quant.quantize_per_channel(_t(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0] == 1.0 and ts[1] == np.float32(1e-8)
    np.testing.assert_array_equal(tq[1:, 0].numpy(), np.round(w[1:, 0]))
    np.testing.assert_array_equal(
        quant.dequantize(tq, ts).numpy(),
        np.asarray(jq.dequantize(jqv, js)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_matmul_matches_matmul_xla(dtype):
    """The route for every shape off the kernel's: the scale and the
    dequantized weights round to x's dtype first, as in `_matmul_xla`."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(17, 256)).astype(np.float32)
    q, s = jq.quantize_per_channel(jnp.asarray(_w(256, 96)))
    jx = jnp.asarray(x, dtype)
    ref = np.asarray(jq._matmul_xla(jx, q, s).astype(jnp.float32))
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = quant.dequant_matmul(tx, _t(q), _t(s))
    assert got.dtype == tx.dtype
    # fp32: summation order only; bf16: one bf16 rounding of the output
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    assert np.abs(got.float().numpy() - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("k", [512, 1280])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_plain_matches_pallas_interpret(k, dtype):
    """The CUDA kernel's function against the Pallas kernel run in interpret
    mode: M = 256, N = 256, K = 512 (one K block) and K = 1280 (not a
    multiple of the 512 block: the JAX kernel tiles it by 256)."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(256, k)).astype(np.float32), dtype)
    q, s = jq.quantize_per_channel(jnp.asarray(_w(k, 256, seed=4)))
    with pltpu.force_tpu_interpret_mode():
        ref = jq._int8_matmul_impl(x, q, s, 256, 256, 512, "pallas")
    ref = np.asarray(ref.astype(jnp.float32))
    tx = _t(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
    got = quant.int8_matmul_plain(tx, _t(q), _t(s))
    assert got.dtype == tx.dtype and got.shape == (256, 256)
    # both accumulate exact products in fp32 and scale in fp32: summation
    # order (and, in bf16, one output rounding) apart
    tol = 1e-5 if dtype == "float32" else 2 ** -8
    assert np.abs(got.float().numpy() - ref).max() <= tol * np.abs(ref).max()


def test_int8_matmul_dispatch_on_cpu():
    """On CPU tensors nothing launches: the kernel's shapes (bf16, M >= 256,
    K % 16 == 0) take the plain version, every other shape (decode M, fp32
    x) `dequant_matmul`; qdense folds leading dims and adds the bias in
    fp32."""
    q, s = quant.quantize_per_channel(_t(_w(64, 32)))
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 150, 64)).astype(np.float32)).bfloat16()
    quant.reset_launches()
    assert quant.kernel_shape(x.reshape(-1, 64))
    assert not quant.kernel_shape(x[0])                     # M = 150
    assert not quant.kernel_shape(x.reshape(-1, 64).float())
    bias = torch.linspace(-1, 1, 32)
    got = quant.qdense({"kernel_q": q, "scale": s, "bias": bias}, x)
    ref = (quant.int8_matmul_plain(x.reshape(-1, 64), q, s).float()
           + bias).bfloat16().reshape(2, 150, 32)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(quant.int8_matmul(x[0], q, s),
                               quant.dequant_matmul(x[0], q, s),
                               rtol=0, atol=0)
    torch.testing.assert_close(quant.int8_matmul(x.reshape(-1, 64), q, s,
                                                 impl="torch"),
                               quant.int8_matmul_plain(x.reshape(-1, 64),
                                                       q, s), rtol=0, atol=0)
    assert quant.launches == {"int8_matmul": 0, "int8_matmul_unaligned": 0}
    with pytest.raises(ValueError):
        quant.int8_matmul_plain(x[0], q[:, :5], s)


def _cfgs(dtype):
    kw = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
              max_position_embeddings=512, dtype=dtype)
    return JDecoderConfig(**kw), DecoderConfig(**kw)


@pytest.mark.parametrize("k,n,want", [
    (4096, 4096, "int8_matmul"), (4096, 1024, "int8_matmul"),
    (4096, 14336, "int8_matmul"), (14336, 4096, "int8_matmul"),
    (4096, 128256, "int8_matmul"), (4112, 1040, "int8_matmul"),
    (64, 130, "int8_matmul_unaligned"), (512, 1000, "int8_matmul_unaligned")])
def test_int8_kernel_variant(k, n, want):
    """The CUDA kernel a (K, N) product takes on the kernel's shapes: the
    TMA + wgmma kernel needs 16-byte row strides in its tensor maps (N
    int8 bytes of W, K bf16 of x), which every Llama-3-8B shape has; other
    N take the kernel kept for them, each counted apart."""
    assert quant.kernel_variant(k, n) == want
    assert quant.launches[want] == 0


@pytest.fixture(scope="module")
def int8_model():
    jcfg, tcfg = _cfgs("float32")
    jp = jdec.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, jq.quantize_decoder(jp)


def test_quantize_decoder_tree_and_from_jax(int8_model):
    """The port's quantize_decoder on converted weights gives the JAX
    tree's leaves; from_jax copies the JAX int8 tree; fused projections
    are refused on both roads."""
    jcfg, _, jp, j8 = int8_model
    t8 = convert.decoder_from_jax(jax.tree.map(np.asarray, j8), device="cpu")
    got = quant.quantize_decoder(convert.decoder_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu"))
    assert quant4.quant_layout_of(got) == quant4.quant_layout_of(t8) == "int8"
    flat = lambda t: jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda a: np.asarray(a), t))[0]
    pairs = list(zip(flat(got), flat(t8)))
    assert len(pairs) == len(flat(j8)) and pairs
    for (pa, a), (pb, b) in pairs:
        assert pa == pb
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert t8["layers"][0]["q_proj"]["kernel_q"].dtype == torch.int8
    fused = jdec.fuse_projections(jp, jcfg)
    with pytest.raises(NotImplementedError):
        convert.decoder_from_jax(jax.tree.map(
            np.asarray, jq.quantize_decoder(fused)), device="cpu")
    with pytest.raises(NotImplementedError):
        quant.quantize_decoder(
            {"layers": [{"qkv_proj": {"kernel": torch.zeros((4, 12))}}]})


def test_decoder_forward_with_int8_weights_matches_jax(int8_model):
    """fp32 activations: both packages dequantize (`_matmul_xla` and
    `dequant_matmul`), so the logits agree to fp32 summation order. The
    head is quantized too (`lm_head` goes through `dense`)."""
    jcfg, tcfg, _, j8 = int8_model
    t8 = convert.decoder_from_jax(jax.tree.map(np.asarray, j8), device="cpu")
    rng = np.random.default_rng(6)
    b, s = 2, 12
    x = (rng.standard_normal((b, s, 128)) * 0.5).astype(np.float32)
    pos = np.tile(np.arange(s), (b, 1)).astype(np.int32)
    mask = np.tril(np.ones((s, s), bool))[None, None].repeat(b, 0)
    ref, _ = jdec.forward(j8, jcfg, jnp.asarray(x), jnp.asarray(pos),
                          jnp.asarray(mask))
    got, _ = decoder.forward(t8, tcfg, _t(x), _t(pos), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    assert "kernel_q" in t8["lm_head"]


def test_bf16_prefill_takes_the_kernel_function():
    """bf16 activations with M = 2 x 160 >= 256 rows: the port's projections
    take the kernel's function (fp32 scale), the JAX package on the CPU
    `_matmul_xla` (scale rounded to bf16, ~2^-9 relative per product).
    Hidden states agree within 2% of their largest magnitude after two
    layers of bf16 rounding; with impl="torch" the port takes the plain
    version too, so the two impls agree exactly on the CPU."""
    jcfg, tcfg = _cfgs("bfloat16")
    jb = jq.quantize_decoder(jdec.init(jax.random.PRNGKey(0), jcfg))
    tb = convert.decoder_from_jax(jax.tree.map(np.asarray, jb), device="cpu")
    assert tb["layers"][0]["q_proj"]["scale"].dtype == torch.float32
    rng = np.random.default_rng(7)
    b, s = 2, 160
    x = (rng.standard_normal((b, s, 128)) * 0.5).astype(np.float32)
    pos = np.tile(np.arange(s), (b, 1)).astype(np.int32)
    mask = np.tril(np.ones((s, s), bool))[None, None].repeat(b, 0)
    ref, _ = jdec.forward(jb, jcfg, jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(pos), jnp.asarray(mask),
                          return_hidden=True)
    ref = np.asarray(ref.astype(jnp.float32))
    args = (tb, tcfg, _t(x).bfloat16(), _t(pos), _t(mask))
    got, _ = decoder.forward(*args, return_hidden=True)
    plain, _ = decoder.forward(*args, return_hidden=True, impl="torch")
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert np.abs(got.float().numpy() - ref).max() <= 2e-2 * np.abs(ref).max()


def test_dense_dispatches_int8_leaves():
    q, s = quant.quantize_per_channel(_t(_w(64, 16)))
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(3, 64)).astype(np.float32))
    torch.testing.assert_close(dense({"kernel_q": q, "scale": s}, x),
                               quant.dequant_matmul(x, q, s), rtol=0, atol=0)
