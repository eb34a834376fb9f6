"""Port parity of the checkpoint readers and what stands on them
(opus_pllm_tpu_torch.core.convert's readers, the safetensors reader and
the bitsandbytes dequantizers, core.builder, decoder.fuse_projections,
utils.prefetch, infer.hf_tokenizer and the server's POST /v1/adapters)
against the JAX package on the CPU.

Every reader must give the JAX reader's tree exactly (the JAX tree carried
over with `from_jax`, bit for bit) on the toy directories of
tests/torch_checkpoints.py: llama from two `.safetensors` shards and from
a `.bin`, qwen2, OPT, a HF-ESM directory, a fair-esm `.pt`, the
reference's weights directory (CSTP Lightning ckpt, switch `.bin`, PEFT
adapter from `.safetensors` and from `.bin`), and a BERT state dict.
The safetensors reader equals the `safetensors` package on every dtype it
takes; NF4 / bnb dequantization equals the JAX functions exactly on the
cases of tests/test_nf4.py. `load_pretrained` (raw, reference contract,
int8, int4) equals the JAX one on every loaded leaf; what both draw at
random (their generators differ) matches in structure, shape and dtype.
Fused projections: forward within 1e-5 (bf16 weights in fp32 compute;
1e-4 int8 / int4, the JAX test's tolerances) of the unfused tree and of
JAX's fused forward (int4: 2^-7, one bf16 step of an activation, see the
test), LoRA deltas on the slices, and greedy generate with a cache
token-identical."""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_checkpoints as tc
from opus_pllm_tpu.core import builder as jbuilder
from opus_pllm_tpu.core import convert as jconvert
from opus_pllm_tpu.core.config import DecoderConfig as JDecoderConfig
from opus_pllm_tpu.core.config import LoRAConfig as JLoRAConfig
from opus_pllm_tpu.kernels import quant as jquant
from opus_pllm_tpu.kernels import quant4 as jquant4
from opus_pllm_tpu.lora import lora as jlora
from opus_pllm_tpu.models import decoder as jdec
from opus_pllm_tpu.models.layers import causal_mask as jcausal_mask
from opus_pllm_tpu_torch.core import builder, convert
from opus_pllm_tpu_torch.core.config import (BertConfig, DecoderConfig,
                                             OpusConfig,
                                             SwitchProjectorConfig)
from opus_pllm_tpu_torch.infer import engine
from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
from opus_pllm_tpu_torch.kernels import quant, quant4
from opus_pllm_tpu_torch.lora import lora
from opus_pllm_tpu_torch.models import decoder
from opus_pllm_tpu_torch.utils.prefetch import prefetch_to_device
from test_nf4 import bnb_4bit_entry


def _np(x):
    """(dtype name, fp32-or-native numpy values) of a tensor or array."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).replace("torch.", "")
        x = x.float() if x.dtype == torch.bfloat16 else x
        return name, x.numpy()
    x = np.asarray(x)
    return x.dtype.name, (x.astype(np.float32) if x.dtype.name == "bfloat16"
                          else x)


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]


def assert_trees_equal(got, ref):
    """Same paths, dtypes and values, bit for bit."""
    g, r = _flat(got), _flat(ref)
    assert [p for p, _ in g] == [p for p, _ in r]
    for (p, a), (_, b) in zip(g, r):
        (da, a), (db, b) = _np(a), _np(b)
        assert da == db and a.shape == b.shape, (p, da, db)
        np.testing.assert_array_equal(a, b, err_msg=str(p))


def assert_same_structure(got, ref):
    g, r = _flat(got), _flat(ref)
    assert [(p, _np(a)[0], tuple(a.shape)) for p, a in g] == \
        [(p, _np(b)[0], tuple(b.shape)) for p, b in r]


@pytest.fixture(scope="module")
def dirs():
    return tc.toy_dirs()


SAFE_DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int8,
               torch.uint8, torch.int32, torch.int64]


def test_safetensors_reader_matches_package(tmp_path):
    from safetensors.torch import load_file, save_file
    g = torch.Generator().manual_seed(0)
    sd = {}
    for i, dt in enumerate(SAFE_DTYPES):
        x = torch.randn((3, 5 + i), generator=g) * 100
        sd[f"t{i}"] = x.to(dt)
    sd["scalar"], sd["empty"] = torch.tensor(2.5), torch.zeros((0, 3))
    path = str(tmp_path / "x.safetensors")
    save_file(sd, path)
    got, ref = convert.load_safetensors(path), load_file(path)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        assert torch.equal(got[k], ref[k]), k
    # a dtype outside the list is refused, not misread
    save_file({"b": torch.ones(2, dtype=torch.bool)}, path)
    with pytest.raises(ValueError, match="BOOL"):
        convert.load_safetensors(path)


@pytest.mark.parametrize("name, int8", [("llama", False), ("llama_bin", False),
                                        ("qwen2", False), ("opt", False),
                                        ("llama", True), ("opt", True)])
def test_decoder_readers_match_jax(dirs, name, int8):
    path = dirs[name]
    jcfg = jbuilder.decoder_config_for(path)
    tcfg = builder.decoder_config_for(path)
    assert tcfg.family == jcfg.family and tcfg.num_layers == 2
    with jconvert.host_arrays():
        ref = jconvert.decoder_from_hf(jconvert.load_hf_dir(path), jcfg,
                                       jnp.bfloat16, quantize_int8=int8)
    got = convert.decoder_from_hf(convert.load_hf_dir(path), tcfg,
                                  torch.bfloat16, quantize_int8=int8)
    assert_trees_equal(got, convert.decoder_from_jax(
        jax.tree.map(np.asarray, ref), device="cpu"))


def test_esm_readers_match_jax(dirs):
    jcfg = jbuilder.esm_config_for(dirs["esm"])
    cfg = builder.esm_config_for(dirs["esm"])
    assert cfg == builder.esm_config_for(dirs["fair_esm"])
    assert (cfg.num_layers, cfg.embed_dim, cfg.num_heads) == (2, 64, 4)
    ref = jconvert.esm2_from_hf(jconvert.load_hf_dir(dirs["esm"]), jcfg)
    got = convert.esm2_from_hf(convert.load_hf_dir(dirs["esm"]), cfg)
    want = convert.esm2_from_jax(jax.tree.map(np.asarray, ref), device="cpu")
    assert_trees_equal(got, want)
    # the fair-esm .pt (nested under "model", prefixed) loads the same
    assert_trees_equal(builder.load_esm(dirs["fair_esm"], cfg,
                                        dtype=torch.float32, device="cpu"),
                       want)
    fair = tc.fair_esm_state_dict()
    assert_trees_equal(convert.esm2_from_fair_esm(fair, cfg),
                       convert.esm2_from_jax(jax.tree.map(
                           np.asarray, jconvert.esm2_from_fair_esm(
                               fair, jcfg)), device="cpu"))


def test_weights_dir_readers_match_jax(dirs):
    wd = dirs["weights"]
    ck = os.path.join(wd, "modality_encoder", "modality_encoding_adapter.ckpt")
    assert_trees_equal(
        convert.cstp_from_lightning(convert.load_torch_file(ck)),
        jconvert.cstp_from_lightning(jconvert.load_torch_file(ck), None))
    sw = os.path.join(wd, "modality_refinement_projector",
                      "modality_refinement_projection.bin")
    assert_trees_equal(
        convert.switch_projector_from_torch(convert.load_torch_file(sw)),
        jconvert.switch_projector_from_torch(jconvert.load_torch_file(sw),
                                             None))
    for w, fam in ((wd, "llama"), (dirs["weights_opt"], "opt")):
        lora_dir = os.path.join(w, "lora_adapter")
        got = convert.lora_from_peft(builder._load_peft_sd(lora_dir))
        ref = jconvert.lora_from_peft(jbuilder._load_peft_sd(lora_dir))
        assert sorted(got) == sorted(ref) and len(got) == 2 * len(
            tc.LORA_TARGETS["opt" if fam == "opt" else "llama"])
        for key in ref:
            for ab in ("A", "B"):
                np.testing.assert_array_equal(got[key][ab].numpy(),
                                              np.asarray(ref[key][ab]))
        # the merge: W + s A B in fp32, rounded once to W's dtype
        path = dirs["llama" if fam == "llama" else "opt"]
        jcfg = jbuilder.decoder_config_for(path)
        with jconvert.host_arrays():
            jllm = jconvert.decoder_from_hf(jconvert.load_hf_dir(path),
                                            jcfg, jnp.bfloat16)
        tllm = convert.decoder_from_hf(convert.load_hf_dir(path),
                                       builder.decoder_config_for(path),
                                       torch.bfloat16)
        assert_trees_equal(
            convert.merge_lora_into_decoder(tllm, got, 2.0),
            convert.decoder_from_jax(jax.tree.map(
                np.asarray, jconvert.merge_lora_into_decoder(jllm, ref, 2.0)),
                device="cpu"))


def test_bert_reader_matches_jax():
    from opus_pllm_tpu.core.config import BertConfig as JBertConfig
    rng = np.random.default_rng(3)
    cfg = BertConfig.tiny()
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    sd = {"bert.embeddings.word_embeddings.weight": r(128, 64),
          "bert.embeddings.position_embeddings.weight": r(128, 64),
          "bert.embeddings.token_type_embeddings.weight": r(2, 64),
          "bert.embeddings.LayerNorm.weight": r(64),
          "bert.embeddings.LayerNorm.bias": r(64)}
    for i in range(cfg.num_layers):
        lp = f"bert.encoder.layer.{i}."
        for n, (o, k) in (("attention.self.query", (64, 64)),
                          ("attention.self.key", (64, 64)),
                          ("attention.self.value", (64, 64)),
                          ("attention.output.dense", (64, 64)),
                          ("intermediate.dense", (128, 64)),
                          ("output.dense", (64, 128))):
            sd[lp + n + ".weight"], sd[lp + n + ".bias"] = r(o, k), r(o)
        for n in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[lp + n + ".weight"], sd[lp + n + ".bias"] = r(64), r(64)
    assert_trees_equal(convert.bert_from_hf(sd, cfg),
                       jconvert.bert_from_hf(sd, JBertConfig.tiny()))


@pytest.mark.parametrize("shape", [(8, 16), (7, 33), (128, 64)])
@pytest.mark.parametrize("double_quant", [False, True])
def test_bnb_4bit_matches_jax(shape, double_quant):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    sd = bnb_4bit_entry(w, "weight", double_quant=double_quant)
    tsd = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    ref = jconvert.dequantize_bnb_4bit(sd, "weight")
    for src in (sd, tsd):             # numpy or torch entries
        np.testing.assert_array_equal(convert.dequantize_bnb_4bit(
            src, "weight"), ref)
    assert convert.has_bnb_4bit(sd)
    full = {"other": np.ones(3, np.float32), **sd}
    got = convert.dequantize_bnb_state_dict(full)
    want = jconvert.dequantize_bnb_state_dict(full)
    assert sorted(got) == sorted(want) == ["other", "weight"]
    np.testing.assert_array_equal(got["weight"], want["weight"])


def test_nf4_codes_and_blockwise_match_jax():
    np.testing.assert_array_equal(convert.NF4_CODE, jconvert.NF4_CODE)
    idx = np.tile(np.arange(16, dtype=np.uint8), 8)
    packed = (idx[0::2] << 4) | idx[1::2]
    absmax = np.array([2.0, 0.5], np.float32)
    np.testing.assert_array_equal(
        convert.dequantize_nf4(packed, absmax, 64, (128,)),
        jconvert.dequantize_nf4(packed, absmax, 64, (128,)))
    q = np.arange(256, dtype=np.uint8)
    code = np.linspace(-1, 1, 256).astype(np.float32)
    np.testing.assert_array_equal(
        convert.dequantize_blockwise_8bit(q, np.array([3.0]), code, 256),
        jconvert.dequantize_blockwise_8bit(q, np.array([3.0]), code, 256))


def test_decoder_from_hf_4bit_state_dict_matches_jax(dirs):
    """A 4-bit-saved llama (every projection and the head NF4 with double
    quant) loads the JAX reader's dequantized weights."""
    sd = dict(convert.load_hf_dir(dirs["llama"]))
    sd = {k: v.numpy() for k, v in sd.items()}
    for k in [k for k in sd if k.endswith("_proj.weight")] + \
            ["lm_head.weight"]:
        sd.update(bnb_4bit_entry(sd.pop(k), k))
    path = dirs["llama"]
    ref = jconvert.decoder_from_hf(sd, jbuilder.decoder_config_for(path),
                                   jnp.float32)
    got = convert.decoder_from_hf(sd, builder.decoder_config_for(path),
                                  torch.float32)
    assert_trees_equal(got, convert.decoder_from_jax(
        jax.tree.map(np.asarray, ref), device="cpu"))


def _cfgs(dirs, llm_dir, cstp=True):
    from opus_pllm_tpu.core.config import OpusConfig as JOpusConfig
    from opus_pllm_tpu.core.config import (
        SwitchProjectorConfig as JSwitchProjectorConfig)
    out = []
    for b, O, S in ((jbuilder, JOpusConfig, JSwitchProjectorConfig),
                    (builder, OpusConfig, SwitchProjectorConfig)):
        llm = b.decoder_config_for(llm_dir)
        c = b.cstp_config_for(dirs["weights"]) if cstp else None
        c = c if b is builder else type(c)(protein_dim=64, text_dim=32,
                                           proj_dim=96) if c else None
        out.append(O(esm=b.esm_config_for(dirs["esm"]), cstp=c,
                     switch=S(input_dim=c.proj_dim if c else 64,
                              llm_hidden_size=llm.hidden_size),
                     llm=llm))
    return out


@pytest.mark.parametrize("llm, weights, quantize", [
    ("llama", False, None), ("llama", True, None), ("llama", True, "int8"),
    ("llama", False, "int8"), ("llama256", True, "int4")])
def test_load_pretrained_matches_jax(dirs, llm, weights, quantize):
    jcfg, cfg = _cfgs(dirs, dirs[llm])
    assert builder.cstp_config_for(dirs["weights"]) == cfg.cstp
    wd = (dirs["weights256" if llm == "llama256" else "weights"]
          if weights else None)
    with jconvert.host_arrays():       # the JAX CLI's numpy load path
        ref, _ = jbuilder.load_pretrained(dirs[llm], wd, jcfg,
                                          esm_path=dirs["esm"],
                                          quantize=quantize)
    got, unmerged = builder.load_pretrained(dirs[llm], wd, cfg,
                                            esm_path=dirs["esm"],
                                            quantize=quantize, device="cpu")
    assert unmerged is None
    ref = jax.tree.map(np.asarray, ref)
    assert_trees_equal(got["llm"], convert.decoder_from_jax(ref["llm"],
                                                            device="cpu"))
    assert_trees_equal(got["esm"], convert.esm2_from_jax(ref["esm"],
                                                         device="cpu"))
    if quantize == "int4":
        assert quant4.quant_layout_of(got["llm"]) == "int4-v1"  # K % 512
    if wd:
        assert_trees_equal(got["cstp"], ref["cstp"])
        assert_trees_equal(got["switch"], ref["switch"])
    else:                              # drawn at random by both
        assert_same_structure(got["cstp"], ref["cstp"])
        assert_same_structure(got["switch"], ref["switch"])


def test_unmerged_lora_and_peft_adapter_match_jax(dirs):
    jcfg, cfg = _cfgs(dirs, dirs["llama"])
    _, unmerged = builder.load_pretrained(dirs["llama"], dirs["weights"],
                                          cfg, esm_path=dirs["esm"],
                                          merge_lora=False, device="cpu")
    tree, scale = builder.load_peft_adapter(dirs["weights"], 2)
    jtree, jscale = jbuilder.load_peft_adapter(dirs["weights"], 2)
    assert scale == jscale == 2.0
    assert_trees_equal(tree, jtree)
    assert_trees_equal(unmerged, jtree)
    with pytest.raises(ValueError, match="adapter_config.json"):
        d = os.path.join(dirs["root"], "no-config")
        os.makedirs(d, exist_ok=True)
        torch.save({}, os.path.join(d, "adapter_model.bin"))
        torch.save(tc.peft_state_dict("llama"), os.path.join(
            d, "adapter_model.bin"))
        builder.load_peft_adapter(d, 2)


def test_native_roundtrip_and_train_layout(dirs, tmp_path):
    _, cfg = _cfgs(dirs, dirs["llama256"])
    params, _ = builder.load_pretrained(dirs["llama256"], None, cfg,
                                        esm_path=dirs["esm"], quantize="int4",
                                        int4_layout="v2", device="cpu")
    params["llm"] = quant4.quantize_decoder4(
        convert.decoder_from_hf(convert.load_hf_dir(dirs["llama256"]),
                                cfg.llm, torch.bfloat16), "auto")
    builder.save_native(str(tmp_path / "n"), params)
    with open(tmp_path / "n" / "quant_layout.json") as f:
        assert json.load(f)["llm_layout"] == quant4.quant_layout_of(
            params["llm"])
    back = builder.load_native(str(tmp_path / "n"), device="cpu")
    assert_trees_equal(back, params)
    v1 = quant4.quantize_decoder4(
        convert.decoder_from_hf(convert.load_hf_dir(dirs["llama256"]),
                                cfg.llm, torch.bfloat16), "v1")
    builder.check_train_layout("train-lora", v1)
    builder.check_train_layout("annotate", params["llm"])
    v2 = {"layers": [{"q_proj": {"kernel_p": torch.zeros(
        (1, 1), dtype=torch.int32)}}]}
    with pytest.raises(SystemExit, match="v1"):
        builder.check_train_layout("train-lora", v2)


def _fuse_cfgs(family="llama", hidden=256, layers=2):
    kw = dict(family=family, vocab_size=256, hidden_size=hidden,
              intermediate_size=2 * hidden, num_layers=layers, num_heads=4,
              num_kv_heads=2, head_dim=hidden // 4,
              max_position_embeddings=512, dtype="float32",
              attention_bias=(family == "qwen2"))
    return JDecoderConfig(**kw), DecoderConfig(**kw)


def _fuse_inputs(hidden=256, s=6):
    emb = (np.random.default_rng(1).standard_normal((2, s, hidden))
           * 0.1).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    m4 = np.array(jcausal_mask(jnp.ones((2, s), bool)))
    t = tuple(torch.from_numpy(a) for a in (emb, pos, m4))
    return emb, pos, m4, t


def _jinit(jcfg, seed=0):
    """The JAX decoder's random init, jitted (one compile, not one per
    op), as numpy."""
    return jax.tree.map(np.asarray, jax.jit(
        lambda k: jdec.init(k, jcfg))(jax.random.PRNGKey(seed)))


def _jforward(jp, jcfg, emb, pos, m4, **kw):
    """The JAX decoder forward's logits, jitted."""
    return np.asarray(jax.jit(lambda p, *a: jdec.forward(
        p, jcfg, *a, **kw)[0])(jp, emb, pos, m4))


@pytest.fixture(scope="module")
def fuse_inputs():
    return _fuse_inputs()


@pytest.mark.parametrize("form, family", [("bf16", "llama"),
                                          ("bf16", "qwen2"),
                                          ("int8", "llama"),
                                          ("int4", "llama")])
def test_fuse_projections_matches_jax_and_unfused(fuse_inputs, form, family):
    """int4 at 512 wide (one layer): v2 words (K % 512 == 0) past M = 64 take the JAX
    `_matmul_xla` function in both packages (v1 bytes take the kernel's
    fp32-scale function in the port, tests/test_torch_quant4.py)."""
    hidden = 512 if form == "int4" else 256
    jcfg, cfg = _fuse_cfgs(family, hidden, 1 if form == "int4" else 2)
    jp = _jinit(jcfg)
    jp = {"bf16": lambda p: p, "int8": jquant.quantize_decoder,
          "int4": jquant4.quantize_decoder4}[form](jp)     # numpy: host
    jfused = jdec.fuse_projections(jp, jcfg)
    tp = convert.decoder_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    fused = decoder.fuse_projections(tp, cfg)
    assert_trees_equal(fused, convert.decoder_from_jax(
        jax.tree.map(np.asarray, jfused), device="cpu"))
    leaf = {"bf16": "kernel", "int8": "kernel_q", "int4": "kernel_p"}[form]
    assert leaf in fused["layers"][0]["qkv_proj"]
    assert leaf in fused["layers"][0]["gateup_proj"]
    assert "q_proj" not in fused["layers"][0]
    # int4: 80 rows, past the int4 kernel's M <= 64, where both packages
    # take the dequantize-then-multiply route (quant4.py:215)
    emb, pos, m4, t = (fuse_inputs if hidden == 256
                       else _fuse_inputs(hidden, 40))
    tol = 1e-5 if form == "bf16" else 1e-4
    ref = _jforward(jfused, jcfg, emb, pos, m4)
    got, _ = decoder.forward(fused, cfg, *t)
    plain, _ = decoder.forward(tp, cfg, *t)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=tol,
                               atol=tol)
    # the quantized routes round activations to bf16 before each product:
    # the packages' fp32 sums in another order may round one activation
    # the other way, one bf16 step (2^-8 relative) of a logit of ~1
    jtol = tol if form != "int4" else 2.0 ** -7
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=jtol,
                               atol=jtol)
    # int8 / int4 trees quantized after the fuse equal the fused quantized
    if form == "bf16" and family == "llama":
        for q in (quant.quantize_decoder, quant4.quantize_decoder4):
            assert_trees_equal(q(fused), decoder.fuse_projections(q(tp),
                                                                  cfg))


def test_fused_lora_slices_and_generate(fuse_inputs):
    jcfg, cfg = _fuse_cfgs()
    jp = _jinit(jcfg)
    lcfg = JLoRAConfig(rank=4, alpha=8.0)
    rng = np.random.default_rng(3)
    jtree = jax.tree.map(
        lambda x: (np.asarray(x) + 0.01 * rng.standard_normal(x.shape)
                   ).astype(np.float32),
        jlora.init(jax.random.PRNGKey(2), jcfg, lcfg))
    tp = convert.decoder_from_jax(jp, device="cpu")
    tree = convert.lora_from_jax(jtree, device="cpu")
    fused = decoder.fuse_projections(tp, cfg)
    emb, pos, m4, t = fuse_inputs
    s = jlora.scaling(lcfg)
    ref = _jforward(jdec.fuse_projections(jp, jcfg), jcfg, emb, pos, m4,
                    lora=jtree, lora_scale=s)
    got, _ = decoder.forward(fused, cfg, *t, lora=tree, lora_scale=s)
    plain, _ = decoder.forward(tp, cfg, *t, lora=tree, lora_scale=s)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-4)
    x = t[0][:1, :5]
    msk = torch.ones((1, 5), dtype=torch.bool)
    p5 = torch.arange(5)[None]
    kw = dict(max_new_tokens=4, temperature=0.0)
    for qc in (False, "int8"):
        a = engine.generate(tp, cfg, x, msk, p5, torch.Generator(),
                            quantize_cache=qc, **kw)
        b = engine.generate(fused, cfg, x, msk, p5, torch.Generator(),
                            quantize_cache=qc, **kw)
        assert torch.equal(a.tokens, b.tokens)


# --- prefetch (the cases of tests/test_prefetch.py) -------------------------

def test_prefetch_order_and_completeness():
    batches = [{"x": np.full((2,), i)} for i in range(7)]
    out = list(prefetch_to_device(iter(batches), size=3,
                                  place=lambda b: {k: torch.from_numpy(v)
                                                   for k, v in b.items()}))
    assert [int(b["x"][0]) for b in out] == list(range(7))
    assert all(isinstance(b["x"], torch.Tensor) for b in out)


def test_prefetch_default_place_moves_to_the_device():
    import ml_dtypes
    frozen = np.arange(4, dtype=np.float32).astype(ml_dtypes.bfloat16)
    frozen.flags.writeable = False          # as np.asarray of a JAX array
    b, = prefetch_to_device([{"x": np.ones(2), "y": (torch.zeros(1),),
                              "w": frozen, "n": 3, "s": "id"}],
                            device="cpu")
    assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
    assert isinstance(b["y"], tuple) and b["y"][0].device.type == "cpu"
    assert b["w"].dtype == torch.bfloat16
    assert b["w"].float().tolist() == [0.0, 1.0, 2.0, 3.0]
    assert (b["n"], b["s"]) == (3, "id")
    with pytest.raises(ValueError):
        next(prefetch_to_device([], size=0))


def test_prefetch_producer_error_reraises():
    def gen():
        yield 1
        raise RuntimeError("boom in loader")

    it = prefetch_to_device(gen(), size=2, place=lambda b: b)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom in loader"):
        list(it)


def test_prefetch_custom_place_runs_on_producer():
    seen = []

    def place(b):
        seen.append(threading.current_thread().name)
        return b * 2

    assert list(prefetch_to_device([1, 2, 3], size=1, place=place)) == \
        [2, 4, 6]
    assert seen == ["opus-pllm-prefetch"] * 3


def test_prefetch_abandoned_consumer_unblocks_producer():
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield i

    it = prefetch_to_device(gen(), size=2, place=lambda b: b)
    next(it)
    it.close()
    deadline = time.time() + 5.0
    alive = True
    while time.time() < deadline:
        alive = any(t.name == "opus-pllm-prefetch" and t.is_alive()
                    for t in threading.enumerate())
        if not alive:
            break
        time.sleep(0.05)
    assert not alive and len(produced) < 100


def test_fit_with_and_without_prefetch_identical():
    """The multimodal and CSTP train loops end in the same state with the
    prefetch thread (the default, 2) and without it."""
    from opus_pllm_tpu_torch.core.config import (IGNORE_INDEX, SEQ_TOKEN_INDEX,
                                                 CSTPConfig, LoRAConfig,
                                                 TrainConfig)
    from opus_pllm_tpu_torch.models import opus
    from opus_pllm_tpu_torch.train import cstp_trainer
    from opus_pllm_tpu_torch.train import multimodal_trainer as mmt

    cfg = OpusConfig.tiny("llama")
    tcfg = TrainConfig(learning_rate=1e-3, batch_size=2, log_every=0)
    lcfg = LoRAConfig(rank=2)
    params = opus.init(cfg, generator=torch.Generator().manual_seed(0),
                       device="cpu")
    rng = np.random.default_rng(0)

    def batch():
        ids = rng.integers(4, cfg.llm.vocab_size, (2, 16)).astype(np.int32)
        ids[:, 1] = SEQ_TOKEN_INDEX
        labels = ids.copy()
        labels[:, :4] = IGNORE_INDEX
        esm = np.full((2, 1, 8), 5, np.int32)
        esm[:, :, 0], esm[:, :, -1] = 0, 2
        return {"input_ids": ids, "attn_mask": np.ones((2, 16), bool),
                "labels": labels, "esm_tokens": esm}

    data = [batch() for _ in range(3)]
    runs = []
    for prefetch in (0, 2):
        st, tx = mmt.create_state(cfg, tcfg, params, train_switch=True,
                                  lora_cfg=lcfg, device="cpu",
                                  generator=torch.Generator().manual_seed(1))
        runs.append(mmt.fit(st, tx, cfg, tcfg, params, iter(data),
                            lora_cfg=lcfg, log_fn=lambda *a: None,
                            prefetch=prefetch, device="cpu"))
    for a, b in zip(mmt.leaves(runs[0].trainable),
                    mmt.leaves(runs[1].trainable)):
        assert torch.equal(a, b)
    ccfg = CSTPConfig.tiny()
    pairs = [(rng.standard_normal((4, 64)).astype(np.float32),
              rng.standard_normal((4, 96)).astype(np.float32))
             for _ in range(3)]
    cruns = []
    for prefetch in (0, 2):
        st, tx = cstp_trainer.create_state(
            ccfg, tcfg, generator=torch.Generator().manual_seed(0),
            device="cpu")
        cruns.append(cstp_trainer.fit(st, tx, ccfg, tcfg, iter(pairs),
                                      prefetch=prefetch, device="cpu"))
    for a, b in zip(mmt.leaves(cruns[0].params), mmt.leaves(cruns[1].params)):
        assert torch.equal(a, b)


def test_hf_tokenizer_matches_jax(tmp_path):
    """The wrapper's per-family pad / eos / bos rules, encode, decode and
    chat template equal the JAX wrapper's on the toy GPT-2 tokenizer."""
    from reference_fixtures import _make_toy_tokenizer

    from opus_pllm_tpu.infer.hf_tokenizer import HFTokenizer as JHF
    from opus_pllm_tpu_torch.infer.hf_tokenizer import HFTokenizer
    _make_toy_tokenizer(str(tmp_path / "tok"))
    text = "What is <seq> MKTAYIAKQR? Nucleus."
    msgs = [{"role": "system", "content": "sys"},
            {"role": "user", "content": "<seq>\nhi"}]
    for family in ("llama", "opt", "qwen2"):
        a, b = HFTokenizer(str(tmp_path / "tok"), family), \
            JHF(str(tmp_path / "tok"), family)
        for attr in ("pad_token_id", "eos_token_id", "bos_token_id",
                     "vocab_size", "family"):
            assert getattr(a, attr) == getattr(b, attr), (family, attr)
        assert a.encode(text) == b.encode(text)
        assert a.decode(a.encode(text)) == b.decode(b.encode(text))
        assert a.apply_chat_template(msgs) == b.apply_chat_template(msgs)


def test_server_post_adapter_from_disk_equals_bank(dirs):
    """POST /v1/adapters loads the PEFT directory into a free bank row;
    a greedy request through it equals the same adapter installed in
    memory (the in-memory bank path)."""
    import urllib.request
    from opus_pllm_tpu_torch.serve.server import OpusServer

    _, cfg = _cfgs(dirs, dirs["llama"])
    params, unmerged = builder.load_pretrained(
        dirs["llama"], dirs["weights"], cfg, esm_path=dirs["esm"],
        merge_lora=False, dtype=torch.float32, device="cpu")
    bank = {"mem": lora.fold_scaling(unmerged, 2.0)}
    srv = OpusServer(params, cfg, ByteTokenizer(), lora_bank=bank,
                     adapter_capacity=2, max_slots=2, max_len=512,
                     prefill_buckets=(320,), default_max_new=6)
    httpd = srv.make_http_server("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]

    def post(path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    try:
        info = post("/v1/adapters", {"name": "disk", "path": os.path.join(
            dirs["weights"], "lora_adapter")})
        assert info == {"adapters": ["disk", "mem"], "capacity": 2,
                        "free": 0}
        ask = {"instruction": "What are the keywords?",
               "sequence": tc.SEQS[0], "max_new_tokens": 6,
               "temperature": 0.0}
        disk = post("/v1/annotate", {**ask, "adapter": "disk"})
        mem = post("/v1/annotate", {**ask, "adapter": "mem"})
        assert (disk["text"], disk["tokens"]) == (mem["text"], mem["tokens"])
        assert disk["tokens"] > 0
    finally:
        httpd.shutdown()
        srv.close()
