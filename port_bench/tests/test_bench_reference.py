"""The plain reference of `port_bench/reference/` against the JAX package,
at tiny sizes on the CPU: ESM2's pooled embedding, CSTP and the switch,
the splice, and the qwen2 and opt decoders' logits. The weights are
`port_bench`'s own draw, converted to the JAX layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opus_pllm_tpu.bridge import cstp as jcstp
from opus_pllm_tpu.bridge import projector as jproj
from opus_pllm_tpu.bridge import splice as jsplice
from opus_pllm_tpu.core.config import OpusConfig
from opus_pllm_tpu.models import decoder as jdec
from opus_pllm_tpu.models import esm2 as jesm
from opus_pllm_tpu.models.layers import causal_mask
from port_bench.reference import model as ref
from port_bench.yardstick.spec import model_spec
from port_bench.yardstick.weights import make_weights

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")


def _conf(family):
    cfg = OpusConfig.tiny(family)
    llm, esm = cfg.llm, cfg.esm
    return cfg, {
        "model_type": family, "hidden_size": llm.hidden_size,
        "intermediate_size": llm.intermediate_size,
        "num_hidden_layers": llm.num_layers,
        "num_attention_heads": llm.num_heads,
        "num_key_value_heads": llm.num_kv_heads,
        "vocab_size": llm.vocab_size,
        "max_position_embeddings": llm.max_position_embeddings,
        "rope_theta": llm.rope_theta, "rms_norm_eps": llm.rms_norm_eps,
        "activation_function": llm.activation,
        "esm": {"num_hidden_layers": esm.num_layers,
                "hidden_size": esm.embed_dim,
                "num_attention_heads": esm.num_heads,
                "intermediate_size": esm.ffn_dim, "vocab_size": 33},
        "cstp": {"protein_dim": cfg.cstp.protein_dim,
                 "proj_dim": cfg.cstp.proj_dim},
        "switch": {"projector_type": cfg.switch.projector_type,
                   "input_dim": cfg.switch.input_dim,
                   "n_tokens": cfg.switch.n_tokens},
    }


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_jax(v) for v in tree]
    return jnp.asarray(tree.float().numpy())


def _jax_esm(esm):
    t = _jax(esm)
    for lp in t["layers"]:
        qkv = lp.pop("qkv")
        for j, n in enumerate(("q_proj", "k_proj", "v_proj")):
            lp[n] = {"kernel": qkv["kernel"][j], "bias": qkv["bias"][j]}
    return t


@pytest.fixture(params=["qwen2", "opt"])
def setup(request):
    cfg, conf = _conf(request.param)
    spec = model_spec(conf)
    w = make_weights(spec, 2 ** 33 + 11, "cpu", llm_dtype=torch.float32,
                     esm_dtype=torch.float32)
    return cfg, spec, w


def test_esm2_cstp_switch(setup):
    cfg, spec, w = setup
    seq = "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ"
    got = ref.soft_tokens(w, spec, seq, ref.Precision("fp32"))
    toks, _ = jesm.tokenize([seq])
    emb = jesm.pooled_embedding(_jax_esm(w["esm"]), cfg.esm,
                                jnp.asarray(toks), impl="xla")
    emb = jcstp.protein_forward(_jax(w["cstp"]), emb)
    want = jproj.apply(_jax(w["switch"]), cfg.switch, emb)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


def test_splice_and_decoder_logits(setup):
    cfg, spec, w = setup
    seq = "MSTNPKPQRKTKRNTNRRPQDVKFPGG"
    ids = ref.byte_ids("A protein: <seq> what does it do?")
    soft = ref.soft_tokens(w, spec, seq, ref.Precision("fp32"))
    row = ref.splice_row(w["llm"], ids, soft)
    hid = ref.decoder_hidden(w["llm"], spec, row[None], [row.shape[0]],
                             ref.Precision("fp32"))
    got = ref.head(w["llm"], spec, hid, ref.Precision("fp32"))[0]

    jl = _jax(w["llm"])
    jids = jnp.asarray(np.asarray(ids, np.int32)[None])
    m = jnp.ones(jids.shape, bool)
    te = jdec.embed_tokens(jl, jnp.clip(jids, 0, None))
    s = jsplice.splice(jids, m, te, jnp.asarray(soft.numpy())[None, None],
                       n_tokens=cfg.switch.n_tokens, left_pad=True)
    np.testing.assert_allclose(row.numpy(), np.asarray(s.embeds[0]),
                               rtol=1e-6, atol=1e-7)
    want, _ = jdec.forward(jl, cfg.llm, s.embeds, s.positions,
                           causal_mask(s.mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), rtol=2e-4,
                               atol=2e-4)


def test_right_padding_leaves_each_row_alone(setup):
    _, spec, w = setup
    g = torch.Generator().manual_seed(3)
    a = torch.randn((7, spec["hidden_size"]), generator=g) * 0.02
    b = torch.randn((11, spec["hidden_size"]), generator=g) * 0.02
    x, lens = ref.right_pad([a, b])
    both = ref.decoder_hidden(w["llm"], spec, x, lens, ref.Precision("fp32"))
    alone = ref.decoder_hidden(w["llm"], spec, a[None], [7],
                               ref.Precision("fp32"))
    torch.testing.assert_close(both[0, :7], alone[0], rtol=1e-5, atol=1e-6)


def test_fp8_control_differs_and_fp32_does_not():
    x = torch.randn((4, 64), generator=torch.Generator().manual_seed(1))
    p = {"kernel": torch.randn((64, 32),
                               generator=torch.Generator().manual_seed(2))}
    exact = x @ p["kernel"]
    torch.testing.assert_close(ref.Precision("fp32").linear(x, p), exact)
    err = (ref.Precision("fp8").linear(x, p) - exact).abs().max()
    assert 1e-3 < float(err) / float(exact.abs().max()) < 0.2
