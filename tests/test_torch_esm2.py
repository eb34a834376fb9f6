"""Port parity: opus_pllm_tpu_torch.models.esm2 vs opus_pllm_tpu.models.esm2.

Same weights (converted with core.convert), same tokens. pooled_embedding
is compared with the JAX side on its fused Pallas path (interpret mode) and
on its XLA path, at atol 3e-5 / rtol 1e-4 (tests/test_fused_encoder.py:80
holds the two JAX paths to the same bound): fp32 summation order only."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opus_pllm_tpu.core.config import ESM2Config as JESM2Config
from opus_pllm_tpu.models import esm2 as jesm2
from opus_pllm_tpu_torch.core import convert
from opus_pllm_tpu_torch.core.config import ESM2Config
from opus_pllm_tpu_torch.models import esm2

SEQS = ["MKTAYIAKQRQISFVKSHFSRQ", "ACDEFGHIKLMNPQRSTVWYXBZUO", "mkt*<q"]


def test_tokenize_matches_python_path(monkeypatch):
    from opus_pllm_tpu import native
    monkeypatch.setattr(native, "esm_tokenize_batch", lambda *a: None)
    for max_len in (None, 12, 40):
        jt, jl = jesm2.tokenize(SEQS, max_len=max_len)
        tt, tl = esm2.tokenize(SEQS, max_len=max_len)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tl, jl)
        assert tt.dtype == jt.dtype == np.int32


@pytest.fixture(scope="module")
def model():
    jcfg = JESM2Config(num_layers=2, embed_dim=128, num_heads=2)
    tcfg = ESM2Config(num_layers=2, embed_dim=128, num_heads=2)
    jp = jesm2.init(jax.random.PRNGKey(3), jcfg)
    tp = convert.esm2_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks, _ = jesm2.tokenize(SEQS[:2] + ["MKV"], max_len=32)
    toks[2, 2] = jcfg.mask_idx           # exercises the token-dropout rescale
    return jcfg, tcfg, jp, tp, toks


@pytest.mark.parametrize("jax_impl,port_impl", [("fused", "fused"),
                                                ("xla", "torch"),
                                                ("xla", "auto")])
def test_pooled_embedding_matches_jax(model, jax_impl, port_impl):
    jcfg, tcfg, jp, tp, toks = model
    with pltpu.force_tpu_interpret_mode():
        ref = jesm2.pooled_embedding(jp, jcfg, jnp.asarray(toks),
                                     impl=jax_impl)
    got = esm2.pooled_embedding(tp, tcfg, torch.from_numpy(toks),
                                impl=port_impl)
    assert got.dtype == torch.float32 and got.shape == (3, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5,
                               rtol=1e-4)


def test_encode_matches_jax_on_stacked_and_qkv_proj_layouts(model):
    """from_jax reads the layers_stacked and the fused (E, 3E) qkv_proj
    layouts to the same parameters as the plain per-layer tree."""
    jcfg, tcfg, jp, tp, toks = model
    stacked = jesm2.stack_params(jesm2.fuse_qkv(jp))
    tp2 = convert.esm2_from_jax(jax.tree.map(np.asarray, stacked),
                                device="cpu")
    for a, b in zip(tp["layers"], tp2["layers"]):
        torch.testing.assert_close(a["qkv"]["kernel"], b["qkv"]["kernel"],
                                   rtol=0, atol=0)
        torch.testing.assert_close(a["qkv"]["bias"], b["qkv"]["bias"],
                                   rtol=0, atol=0)
    ref = jesm2.encode(jp, jcfg, jnp.asarray(toks), impl="xla")
    got = esm2.encode(tp2, tcfg, torch.from_numpy(toks), impl="torch")
    valid = (toks != jcfg.pad_idx)[..., None]
    np.testing.assert_allclose(np.where(valid, got.numpy(), 0),
                               np.where(valid, np.asarray(ref), 0),
                               atol=3e-5, rtol=1e-4)


def test_bf16_tree_converts():
    """A bf16 JAX tree (core/builder.py loads ESM2 in bf16) arrives as bf16."""
    jcfg = dataclasses.replace(JESM2Config.tiny(), dtype="bfloat16")
    jp = jesm2.init(jax.random.PRNGKey(0), jcfg)
    tp = convert.esm2_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    emb = tp["embed_tokens"]["embedding"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        emb.float().numpy(),
        np.asarray(jp["embed_tokens"]["embedding"], np.float32))
