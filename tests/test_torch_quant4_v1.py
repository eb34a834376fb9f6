"""Port parity: the int4 v1 (nibble-byte) layout of
opus_pllm_tpu_torch.kernels.quant4 against opus_pllm_tpu.kernels.quant4,
and the gradients of the int4 and int8 matmul Functions against jax.grad
of the JAX custom VJPs.

Packing is held to identical bytes (from_jax is a copy). The v1 matmul's
plain version is held to the Pallas `_kernel` (pallas_call at
quant4.py:359) in interpret mode and to the JAX `_matmul_xla`, with each
tolerance explained where it is used."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opus_pllm_tpu.core.config import DecoderConfig as JDecoderConfig
from opus_pllm_tpu.kernels import quant as jquant
from opus_pllm_tpu.kernels import quant4 as jq
from opus_pllm_tpu.models import decoder as jdec
from opus_pllm_tpu_torch.core import convert
from opus_pllm_tpu_torch.kernels import quant, quant4


def _t(a):
    return torch.from_numpy(np.array(a))


def _w(seed, k, n):
    return np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)


@pytest.mark.parametrize("k,n", [(768, 256), (256, 130)])
def test_pack_int4_bytes_match_jax(k, n):
    """The same nibble bytes as the JAX `pack_int4`; `unpack_int4` inverts
    it as the JAX one does (sign-extended nibbles)."""
    qj, _ = jq.quantize_grouped(_w(0, k, n))
    pj = np.asarray(jq.pack_int4(np.asarray(qj)))
    pt = quant4.pack_int4(_t(qj))
    assert pt.dtype == torch.int8 and pt.shape == (k // 2, n)
    np.testing.assert_array_equal(pt.numpy(), pj)
    assert (pt < 0).any()                         # high nibble sign in use
    np.testing.assert_array_equal(quant4.unpack_int4(pt).numpy(),
                                  np.asarray(qj))
    np.testing.assert_array_equal(quant4.unpack_int4(pt).numpy(),
                                  np.asarray(jq.unpack_int4(pj)))


def _cfgs():
    """hidden 256 (K % 512 != 0: auto packs v1), intermediate 512."""
    j = JDecoderConfig(family="llama", vocab_size=256, hidden_size=256,
                       intermediate_size=512, num_layers=2, num_heads=4,
                       num_kv_heads=2, head_dim=64,
                       max_position_embeddings=512, dtype="float32")
    return j


@pytest.mark.parametrize("layout", ["v1", "auto"])
def test_quantize_decoder4_v1_matches_jax_and_converts(layout):
    """quantize_decoder4 gives the JAX leaves (v1 bytes everywhere with
    layout="v1"; with "auto", v1 where K % 512 != 0 and v2 words for
    down_proj's K = 512); from_jax copies the JAX tree as it is."""
    jcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jdec.init(jax.random.PRNGKey(0), jcfg))
    jqp = jax.tree.map(np.asarray, jq.quantize_decoder4(jp, layout=layout))
    ref = convert.decoder_from_jax(jqp, device="cpu")
    got = quant4.quantize_decoder4(convert.decoder_from_jax(jp, device="cpu"),
                                   layout=layout)
    assert quant4.quant_layout_of(got) == "int4-v1"
    assert got["layers"][0]["down_proj"]["kernel_p"].dtype == (
        torch.int8 if layout == "v1" else torch.int32)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda a: a.numpy(), t))[0]
    for (pa, a), (pb, b) in zip(flat(got), flat(ref)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_v1_plain_matches_pallas_interpret():
    """The kernel's plain version vs the TPU kernel (interpret mode) at the
    shape of tests/test_quant4.py: both round x to bf16, multiply exact
    int4 values with fp32 accumulation and scale fp32 group partials by the
    fp32 scales; only the summation order differs: 2e-5 of max|y|."""
    rng = np.random.default_rng(3)
    m, k, n = 16, 768, 256
    x = rng.normal(size=(m, k)).astype(np.float32)
    q, s = jq.quantize_grouped(_w(4, k, n))
    packed = np.asarray(jq.pack_int4(q))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jq.int4_matmul(jnp.asarray(x), jnp.asarray(packed),
                                        jnp.asarray(s), impl="pallas"))
    quant4.reset_launches()
    got = quant4.int4_matmul(_t(x), _t(packed), _t(s)).numpy()
    assert quant4.launches == {"int4_matmul": 0, "int4_matmul_unaligned": 0,
                               "int4_matmul_v1": 0,
                               "int4_matmul_v1_unaligned": 0}
    assert got.dtype == np.float32 and got.shape == (m, n)
    assert np.abs(got - ref).max() <= 2e-5 * np.abs(ref).max()
    torch.testing.assert_close(
        quant4.int4_matmul_plain(_t(x), _t(packed), _t(s)), _t(got),
        rtol=0, atol=0)


@pytest.mark.parametrize("n,want", [
    (4096, "int4_matmul_v1"), (1024, "int4_matmul_v1"),
    (14336, "int4_matmul_v1"), (128256, "int4_matmul_v1"),
    (1040, "int4_matmul_v1"), (130, "int4_matmul_v1_unaligned"),
    (260, "int4_matmul_v1_unaligned"), (1000, "int4_matmul_v1_unaligned")])
def test_v1_kernel_variant(n, want):
    """The CUDA kernel a v1 product with N columns takes: the TMA + wgmma
    kernel needs 16-byte row strides for the nibble bytes (N) and the fp32
    scales, which every Llama-3-8B shape has, the vocab head included;
    other N (a tiny test head of 260) take the kernel kept for them."""
    assert quant4.v1_kernel_variant(n) == want
    assert quant4.launches[want] == 0


def test_v1_plain_vs_matmul_xla():
    """Against the JAX `_matmul_xla` route (what the JAX package runs on
    the CPU and for untiled shapes): it rounds the group scales and the
    dequantized weights to bf16, the kernel keeps them fp32, so the two
    differ by that rounding (~0.4% of a weight at most, 1% of max|y|
    allowed); the port's `dequant_matmul` IS that route (fp32 order)."""
    rng = np.random.default_rng(5)
    m, k, n = 24, 512, 384
    x = rng.normal(size=(m, k)).astype(np.float32)
    q, s = jq.quantize_grouped(_w(6, k, n))
    packed = np.asarray(jq.pack_int4(q))
    ref = np.asarray(jq._matmul_xla(jnp.asarray(x), jnp.asarray(packed),
                                    jnp.asarray(s)))
    got = quant4.int4_matmul(_t(x), _t(packed), _t(s)).numpy()
    assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()
    route = quant4.dequant_matmul(_t(x), _t(packed), _t(s)).numpy()
    np.testing.assert_allclose(route, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("layout", ["v1", "v2"])
def test_int4_dx_matches_jax_grad(layout):
    """dx of sum(int4_matmul(x) * w) through the port's Function equals
    jax.grad through the JAX custom VJP: both dequantize W to bf16 with
    bf16 scales and multiply the cotangent rounded to bf16 with fp32
    accumulation (fp32 order only: 1e-5 of max|dx|)."""
    rng = np.random.default_rng(7)
    m, k, n = 8, 512, 256
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(m, n)).astype(np.float32)
    q, s = jq.quantize_grouped(_w(8, k, n))
    packed = np.asarray(jq.pack_int4(q) if layout == "v1"
                        else jq.pack_int4_v2(q))
    ref = np.asarray(jax.grad(lambda x: jnp.sum(jq.int4_matmul(
        x, jnp.asarray(packed), jnp.asarray(s)) * jnp.asarray(w)))(
        jnp.asarray(x)))
    tx = _t(x).requires_grad_(True)
    y = quant4.int4_matmul(tx, _t(packed), _t(s))
    assert y.grad_fn is not None
    got, = torch.autograd.grad((y * _t(w)).sum(), tx)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_int8_dx_matches_jax_grad():
    """The int8 Function's dx = (g * scale) @ wq^T in fp32, as the JAX
    custom VJP (quant.py:101-113), on both of the port's forward routes
    (the kernel's shape, M >= 256, and the dequantize route)."""
    rng = np.random.default_rng(9)
    k, n = 256, 192
    wq, s = jquant.quantize_per_channel(jnp.asarray(_w(10, k, n)))
    for m in (300, 8):
        x = rng.normal(size=(m, k)).astype(np.float32)
        w = rng.normal(size=(m, n)).astype(np.float32)
        ref = np.asarray(jax.grad(lambda x: jnp.sum(
            jquant.int8_matmul(x, wq, s) * jnp.asarray(w)))(jnp.asarray(x)))
        tx = _t(x).requires_grad_(True)
        y = quant.int8_matmul(tx, _t(wq), _t(s))
        got, = torch.autograd.grad((y * _t(w)).sum(), tx)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


def test_from_jax_copies_v1_trees_and_training_layout():
    """A JAX tree quantized with layout="v1" (what `train-* --load-int4`
    loads) crosses over byte for byte, and the port's decoder runs it
    (fp32 activations; the plain v1 version on CPU) close to the JAX
    decoder (its `_matmul_xla` rounds the scales to bf16: 1% of
    max|logit|)."""
    jcfg = _cfgs()
    jp = jdec.init(jax.random.PRNGKey(1), jcfg)
    jqp = jq.quantize_decoder4(jp, layout="v1")
    tp = convert.decoder_from_jax(jax.tree.map(np.asarray, jqp), device="cpu")
    assert quant4.quant_layout_of(tp) == "int4-v1"
    np.testing.assert_array_equal(
        tp["lm_head"]["kernel_p"].numpy(),
        np.asarray(jqp["lm_head"]["kernel_p"]))
    from opus_pllm_tpu_torch.core.config import DecoderConfig
    from opus_pllm_tpu_torch.models import decoder
    tcfg = DecoderConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 9, 256)).astype(np.float32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    mask = np.tril(np.ones((9, 9), bool))[None, None].repeat(2, 0)
    ref, _ = jdec.forward(jqp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                          jnp.asarray(mask))
    got, _ = decoder.forward(tp, tcfg, _t(x), _t(pos), _t(mask))
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() <= 1e-2 * np.abs(ref).max()
