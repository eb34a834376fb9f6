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


# ---------------------------------------------------------------------------
# encoder_attention's key mask: the kernel's words and its rule for a batch
# row with no valid key
# ---------------------------------------------------------------------------

S_RAGGED = 70            # not a multiple of the kernel's 64-key tiles


def _ragged_inputs():
    """B = 4 rows of 70 keys: unpadded, ragged, length 1, no valid key."""
    rng = np.random.default_rng(1)
    qkv = rng.standard_normal((3, 4, H, S_RAGGED, 64)).astype(np.float32)
    mask = np.zeros((4, S_RAGGED), bool)
    mask[0] = True
    mask[1, :37] = True
    mask[2, 0] = True
    return qkv, mask


def test_encoder_attention_plain_matches_pallas_on_rows_with_a_key():
    """At S = 70 the plain version is the Pallas kernel (interpret mode) on
    every batch row with a valid key; the row without one gets out 0 (the
    TPU kernel averages v there)."""
    qkv, mask = _ragged_inputs()
    with pltpu.force_tpu_interpret_mode():
        ref = jfe.flash_attention_pairs(jnp.asarray(_pack_qkv(qkv)),
                                        jnp.asarray(mask))
    got = tfe.encoder_attention_plain(_t(qkv), _t(mask)).numpy()
    ref = _unpack_attn(ref)
    assert _rel_err(got[:3], ref[:3]) < REL
    assert not np.any(got[3])
    assert np.any(ref[3])


def test_pack_key_words_matches_the_mask_bits():
    """Bit j of word (b, t) is mask[b, 64 t + j]; bits past S are 0."""
    rng = np.random.default_rng(2)
    for s in (1, 63, 64, 70, 129, 512):
        mask = rng.random((3, s)) < 0.7
        mask[1] = True
        words = tfe.pack_key_words(_t(mask)).numpy().view(np.uint64)
        assert words.shape == tfe.key_word_shape(3, s) == (3, -(-s // 64))
        for b in range(3):
            for t in range(words.shape[1]):
                bits = [(int(words[b, t]) >> j) & 1 for j in range(64)]
                want = [int(64 * t + j < s and mask[b, 64 * t + j])
                        for j in range(64)]
                assert bits == want


def test_key_tiles_skip_padding_and_mask_only_partial_tiles():
    """0: a tile of padding only (not loaded); 2: all 64 keys valid (no
    per-element mask); 1: the rest, a ragged last tile included."""
    mask = np.zeros((3, 130), bool)
    mask[0] = True
    mask[1, :70] = True
    kinds = tfe.key_tiles(tfe.pack_key_words(_t(mask))).tolist()
    assert kinds == [[2, 2, 1], [2, 1, 0], [0, 0, 0]]


def _sweep_like_the_kernel(qkv, mask):
    """encoder_attention as the CUDA kernel runs it, in fp64: per query
    row, the 64-key tiles whose word is not 0, in order, an online softmax
    in base 2 over the valid keys of each (p = 0 exactly elsewhere), out =
    acc / max(l, 1e-30)."""
    _, b, h, s, d = qkv.shape
    words = tfe.pack_key_words(_t(mask))
    kinds = tfe.key_tiles(words).numpy()
    q, k, v = (qkv[i].astype(np.float64) for i in range(3))
    log2e = 1.0 / np.log(2.0)
    out = np.zeros((b, s, h, d))
    for bi in range(b):
        m_run = np.full((h, s), -1e30)
        l_run = np.zeros((h, s))
        acc = np.zeros((h, s, d))
        for t in range(kinds.shape[1]):
            if kinds[bi, t] == 0:
                continue
            keys = slice(64 * t, min(64 * t + 64, s))
            x = np.einsum("hqd,hkd->hqk", q[bi], k[bi, :, keys]) \
                * 0.125 * log2e
            if kinds[bi, t] == 1:
                x = np.where(mask[bi, keys][None, None], x, -np.inf)
            m_new = np.maximum(m_run, x.max(-1))
            alpha = np.exp2(m_run - m_new)
            p = np.exp2(x - m_new[..., None])
            l_run = l_run * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + np.einsum(
                "hqk,hkd->hqd", p, v[bi, :, keys])
            m_run = m_new
        out[bi] = (acc / np.maximum(l_run, 1e-30)[..., None]).transpose(
            1, 0, 2)
    return out.reshape(b, s, h * d)


def test_kernel_sweep_matches_the_plain_version_on_every_row():
    """Skipping padding tiles and unmasked full tiles computes the plain
    version's function, the no-valid-key row (out 0) included."""
    qkv, mask = _ragged_inputs()
    got = _sweep_like_the_kernel(qkv, mask)
    ref = tfe.encoder_attention_plain(_t(qkv), _t(mask)).numpy()
    assert _rel_err(got, ref) < REL
    assert not np.any(got[3])
