"""Port parity: the plain versions of the four fused-encoder kernels
(opus_pllm_tpu_torch.kernels.fused_encoder) vs the JAX Pallas kernels in
interpret mode (opus_pllm_tpu.kernels.fused_encoder).

ESM2 widths E=256, H=4 (d=64), S=16, B=3 with one padded row, fp32. The
tolerance is the one tests/test_fused_encoder.py:67 uses, |got - ref| /
(|ref| + 1) < 5e-5: online vs one-shot softmax and summation order differ
by fp32 conditioning only. Layouts differ on purpose (the TPU packs two
d=64 heads per 128-lane tile; the port keeps heads apart), so the test
converts: lanes [0, 64) of pair g are head 2g, lanes [64, 128) head 2g+1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opus_pllm_tpu.kernels import fused_encoder as jfe
from opus_pllm_tpu.models.layers import rope_cos_sin
from opus_pllm_tpu_torch.kernels import fused_encoder as tfe

B, S, E, H = 3, 16, 256, 4
F = 4 * E
REL = 5e-5


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(got - ref) / (np.abs(ref) + 1.0)).max())


def _pack_qkv(qkv):
    """port (3, B, H, S, 64) -> TPU pair-packed (3, B, H/2, S, 128)."""
    t, b, h, s, d = qkv.shape
    return qkv.reshape(t, b, h // 2, 2, s, d).transpose(0, 1, 2, 4, 3, 5) \
        .reshape(t, b, h // 2, s, 2 * d)


def _unpack_attn(o):
    """TPU (B, H/2, S, 128) -> port (B, S, E)."""
    b, hp, s, lanes = o.shape
    return np.asarray(o).transpose(0, 2, 1, 3).reshape(b, s, hp * lanes)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    x = rng.standard_normal((B, S, E)).astype(f32)
    mask = np.ones((B, S), bool)
    mask[1, -5:] = False
    return {
        "x": x, "mask": mask,
        "w_qkv": (rng.standard_normal((3, E, E)) / np.sqrt(E)).astype(f32),
        "b_qkv": (0.1 * rng.standard_normal((3, E))).astype(f32),
        "ln": np.stack([1 + 0.2 * rng.standard_normal(E),
                        0.1 * rng.standard_normal(E)]).astype(f32),
        "qkv": rng.standard_normal((3, B, H, S, 64)).astype(f32),
        "a": rng.standard_normal((B, S, E)).astype(f32),
        "w_o": (rng.standard_normal((E, E)) * 0.05).astype(f32),
        "b_o": (0.1 * rng.standard_normal(E)).astype(f32),
        "w1": (rng.standard_normal((E, F)) / np.sqrt(E)).astype(f32),
        "b1": (0.1 * rng.standard_normal(F)).astype(f32),
        "w2": (rng.standard_normal((F, E)) / np.sqrt(F)).astype(f32),
        "b2": (0.1 * rng.standard_normal(E)).astype(f32),
    }


def _t(a):
    return torch.from_numpy(np.array(a))


def test_ln_qkv_rope_matches_pallas(inputs):
    cos, sin = rope_cos_sin(jnp.arange(S), 64)
    with pltpu.force_tpu_interpret_mode():
        ref = jfe.fused_ln_qkv_rope(
            jnp.asarray(inputs["x"]), jnp.asarray(inputs["w_qkv"]),
            jnp.asarray(inputs["b_qkv"]), jnp.asarray(inputs["ln"]), cos, sin)
    got = tfe.ln_qkv_rope_plain(
        _t(inputs["x"]), _t(inputs["w_qkv"]), _t(inputs["b_qkv"]),
        _t(inputs["ln"]), _t(np.asarray(cos)), _t(np.asarray(sin)))
    assert got.shape == (3, B, H, S, 64)
    assert _rel_err(_pack_qkv(got.numpy()), ref) < REL


def test_encoder_attention_matches_pallas(inputs):
    qkv, mask = inputs["qkv"], inputs["mask"]
    with pltpu.force_tpu_interpret_mode():
        ref = jfe.flash_attention_pairs(jnp.asarray(_pack_qkv(qkv)),
                                        jnp.asarray(mask))
    got = tfe.encoder_attention_plain(_t(qkv), _t(mask))
    assert got.shape == (B, S, E)
    assert _rel_err(got.numpy(), _unpack_attn(ref)) < REL


def test_out_proj_matches_pallas(inputs):
    a = inputs["a"]
    packed = a.reshape(B, S, H // 2, 128).transpose(0, 2, 1, 3)
    with pltpu.force_tpu_interpret_mode():
        ref = jfe.fused_out_proj(jnp.asarray(packed), jnp.asarray(inputs["w_o"]),
                                 jnp.asarray(inputs["b_o"]),
                                 jnp.asarray(inputs["x"]))
    got = tfe.out_proj_plain(_t(a), _t(inputs["w_o"]), _t(inputs["b_o"]),
                             _t(inputs["x"]))
    assert _rel_err(got.numpy(), ref) < REL


def test_ffn_matches_pallas(inputs):
    with pltpu.force_tpu_interpret_mode():
        ref = jfe.fused_ffn(*(jnp.asarray(inputs[k]) for k in
                              ("x", "w1", "b1", "w2", "b2", "ln")))
    got = tfe.ffn_plain(*(_t(inputs[k]) for k in
                          ("x", "w1", "b1", "w2", "b2", "ln")))
    assert _rel_err(got.numpy(), ref) < REL


def test_cpu_wrappers_run_plain_versions_and_launch_nothing(inputs):
    """A CPU tensor takes the plain version; the launch counts move only
    where a kernel launches."""
    tfe.reset_launches()
    cos, sin = (_t(np.asarray(t)) for t in rope_cos_sin(jnp.arange(S), 64))
    args = (_t(inputs["x"]), _t(inputs["w_qkv"]), _t(inputs["b_qkv"]),
            _t(inputs["ln"]), cos, sin)
    torch.testing.assert_close(tfe.ln_qkv_rope(*args),
                               tfe.ln_qkv_rope_plain(*args), rtol=0, atol=0)
    qkv, mask = _t(inputs["qkv"]), _t(inputs["mask"])
    torch.testing.assert_close(tfe.encoder_attention(qkv, mask),
                               tfe.encoder_attention_plain(qkv, mask),
                               rtol=0, atol=0)
    assert tfe.launches == {k: 0 for k in tfe.launches}


def test_supports_requires_cuda_bf16_d64():
    from opus_pllm_tpu_torch.core.config import ESM2Config
    cfg = ESM2Config(num_layers=1, embed_dim=256, num_heads=4)
    x = torch.zeros((2, 16, 256), dtype=torch.bfloat16)
    assert not tfe.supports(cfg, x)            # CPU tensor
    assert not tfe.supports(ESM2Config(embed_dim=256, num_heads=8), x)
