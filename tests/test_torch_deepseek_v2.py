"""The deepseek_v2 family (multi-head latent attention over a latent cache,
routed and shared experts) against the plain fp32 reference of the
benchmark (`port_bench/reference/deepseek_v2.py`), at a tiny seeded size
on the CPU: hidden 64, 4 heads, latent rank 32, rope 8 / nope 16 / v 16,
3 layers (1 dense + 2 with 8 experts, top 2, 1 shared), YaRN with mscale
!= mscale_all_dim. The weights are the benchmark's own draw
(`port_bench/yardstick/deepseek.py`) in fp32.

Tolerances: both sides compute in fp32 from the same weights; they differ
only in the order of sums (the fused products, the absorbed decode
against the decompressed reference, the expert outputs summed per token
against the reference's scatter-add), ~1e-6 of the values. Logits are
held to 1e-4 of their largest magnitude: 100x that rounding, and far
below what a wrong position, rope pair, scale, mask or expert gives
(O(1) of the logits).
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from opus_pllm_tpu_torch.core import builder, convert
from opus_pllm_tpu_torch.evals import runner
from opus_pllm_tpu_torch.infer import engine
from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
from opus_pllm_tpu_torch.kernels import moe
from opus_pllm_tpu_torch.models import decoder, opus
from port_bench.reference import deepseek_v2 as dref
from port_bench.reference import model as ref
from port_bench.yardstick import deepseek

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 33 + 19
REL = 1e-4
PROMPTS = ["Describe <seq>\nthe protein.", "<seq>\nKeywords?",
           "Which family does <seq>\nbelong to, and where?"]
PROTEINS = ["MKTAYIAKQRQISFVKSHFSRQ", "MLEERLGLIEVQ", "MAPKKVLLSAGHS"]


@pytest.fixture(scope="module")
def model():
    with open(ROOT / "port_bench" / "tests" / "data"
              / "tiny-deepseek-v2.json") as f:
        conf = json.load(f)
    cfg, spec = deepseek.program_config(conf)
    w = deepseek.draw_weights(conf, spec, SEED, "cpu")
    fused = dict(w, llm=decoder.fuse_projections(w["llm"], cfg.llm))
    return cfg, spec, w, fused


def _close(a, b):
    err = (a - b).abs().max().item()
    assert err <= REL * b.abs().max().item(), err


def _spliced(cfg, params):
    """The three prompts spliced as the runner does: left-padded byte ids,
    the proteins' soft tokens in place of the sentinel."""
    tok = ByteTokenizer()
    ids = [ref.byte_ids(p) for p in PROMPTS]
    t_ids, mask, esm_toks = runner._prepare_from_ids(
        tok, ids, PROTEINS, prompt_bucket=16, esm_bucket=8, device="cpu")
    sp = opus.splice_prompt(params, cfg, t_ids, mask, esm_toks,
                            left_pad=True)
    return ids, sp


def test_spliced_prefill_matches_the_reference(model):
    """The spliced prefill over a left-padded batch, into the latent cache
    as `generate` runs it, against the reference's full forward: the
    logits at every valid position of every row."""
    cfg, spec, w, fused = model
    ids, sp = _spliced(cfg, fused)
    b, l, _ = sp.embeds.shape
    cache = decoder.init_cache(cfg.llm, b, l + 4, device="cpu")
    cache["mask"][:, :l] = sp.mask
    rows = torch.arange(l)[None, None, :, None]
    cols = torch.arange(l + 4)[None, None, None, :]
    m4 = cache["mask"][:, None, None, :] & (cols <= rows)
    with torch.no_grad():
        lg, cache = decoder.forward(fused["llm"], cfg.llm, sp.embeds,
                                    decoder.positions_from_mask(sp.mask), m4,
                                    cache)
        rows_ref = [ref.splice_row(w["llm"], i, ref.soft_tokens(
            w, spec, p, ref.Precision("fp32"))) for i, p in zip(ids,
                                                                PROTEINS)]
        x, lengths = ref.right_pad(rows_ref)
        want = ref.head(w["llm"], spec, dref.decoder_hidden(
            w["llm"], spec, x, lengths, ref.Precision("fp32")),
            ref.Precision("fp32"))
    assert set(cache["layers"][0]) == {"c", "k_pe"}
    for r, n in enumerate(lengths):
        _close(lg[r, l - n:], want[r, :n])


def test_greedy_decode_through_the_latent_cache(model, monkeypatch):
    """`generate` greedy over the spliced batch: the logits it hands its
    sampler at every step (the prefill's, then each absorbed one-token
    step over the latent cache) against the reference teacher-forced over
    the prompt and the tokens served."""
    cfg, spec, w, fused = model
    ids, sp = _spliced(cfg, fused)
    seen, sample = {}, engine.advance_sampling

    def spy(step, done, cur_logits, *a, **k):
        seen[step] = cur_logits.clone()
        return sample(step, done, cur_logits, *a, **k)

    monkeypatch.setattr(engine, "advance_sampling", spy)
    new = 6
    out = engine.generate(fused["llm"], cfg.llm, sp.embeds, sp.mask,
                          decoder.positions_from_mask(sp.mask),
                          torch.Generator().manual_seed(0),
                          max_new_tokens=new, temperature=0.0)
    assert out.steps == new
    served = [out.tokens[r].tolist() for r in range(len(PROMPTS))]
    with torch.no_grad():
        want = dref.position_logits(w, spec, ids, PROTEINS, served,
                                    ref.Precision("fp32"))
    for step in range(new):
        for r in range(len(PROMPTS)):
            _close(seen[step][r], want[r][step])


def test_moe_layer_with_an_expert_given_no_rows(model):
    """The routed layer where the router never picks expert 3 (its
    column -1 against a positive input: a logit far below the others):
    equal to the reference's layer, and the tally counts no pair for
    it."""
    cfg, spec, w, fused = model
    lp = dict(fused["llm"]["layers"][1])
    kern = lp["router"]["kernel"].clone()
    kern[:, 3] = -1.0
    lp["router"] = {"kernel": kern}
    rlp = dict(w["llm"]["layers"][1], router={"kernel": kern})
    x = torch.randn(2, 9, cfg.llm.hidden_size,
                    generator=torch.Generator().manual_seed(1)).abs()
    tally = decoder.MoETally(cfg.llm, "cpu")
    with torch.no_grad():
        got = decoder._moe(cfg.llm, lp, x, "auto", tally, 1)
        want = dref._moe(rlp, spec, x, ref.Precision("fp32"))
    _close(got, want)
    assert tally.pairs[0, 3] == 0
    assert int(tally.pairs.sum()) == 2 * 9 * cfg.llm.num_experts_per_tok


@pytest.mark.parametrize("swiglu", [False, True])
def test_grouped_gemm_plain_matches_a_per_row_product(swiglu):
    """The grouped GEMM's plain version (a loop over the experts) against
    each row times its own expert's weight, gathered per row, with two
    experts given no rows; the fused gate|up against silu(gate) * up of
    the weights before `interleave_gate_up`. Both in fp32: equal to
    1e-5 of the largest value (the same products summed in another
    order)."""
    g = torch.Generator().manual_seed(2)
    e, k, f = 6, 64, 128
    counts = torch.tensor([5, 0, 3, 9, 0, 1])
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                         counts.cumsum(0)]).int()
    x = torch.randn(int(counts.sum()), k, generator=g)
    gate, up = (torch.randn(e, k, f, generator=g) * k ** -0.5
                for _ in range(2))
    expert = torch.repeat_interleave(torch.arange(e), counts)
    if swiglu:
        got = moe.grouped_gemm_plain(x, moe.interleave_gate_up(gate, up),
                                     offsets, swiglu=True)
        want = torch.nn.functional.silu(
            torch.einsum("pk,pkn->pn", x, gate[expert])) \
            * torch.einsum("pk,pkn->pn", x, up[expert])
    else:
        got = moe.grouped_gemm_plain(x, gate, offsets)
        want = torch.einsum("pk,pkn->pn", x, gate[expert])
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_decode_step_matches_the_int_index_step(model):
    """`engine.DecodeStep` called directly (its slot a 0-dim tensor on
    the device, the form a CUDA graph replays) against `decoder.forward`
    with an int index on a copy of the cache: bit-equal logits and latent
    cache leaves, and the step's routing tally filled."""
    cfg, _, _, fused = model
    llm, c = fused["llm"], cfg.llm
    g = torch.Generator().manual_seed(4)
    b, l, cap = 3, 7, 12
    x = torch.randn(b, l, c.hidden_size, generator=g)
    am = torch.ones(b, l, dtype=torch.bool)
    am[0, :2] = False
    pos = decoder.positions_from_mask(am)
    cache = decoder.init_cache(c, b, cap, device="cpu")
    cache["mask"][:, :l] = am
    rows = torch.arange(l)[None, None, :, None]
    cols = torch.arange(cap)[None, None, None, :]
    with torch.no_grad():
        decoder.forward(llm, c, x, pos, cache["mask"][:, None, None, :]
                        & (cols <= rows), cache)
        twin = {"layers": [{n: t.clone() for n, t in lc.items()}
                           for lc in cache["layers"]],
                "index": l, "mask": cache["mask"].clone()}
        step = engine.DecodeStep(llm, c, cache, pos_dtype=pos.dtype,
                                 impl="auto", ntk_ctx=cap)
        tok = torch.tensor([5, 9, 200], dtype=torch.int32)
        cache["mask"][:, l] = True
        twin["mask"][:, l] = True
        got = step(tok, pos[:, -1:] + 1, l)
        emb = decoder.embed_tokens(llm, tok.long())[:, None]
        want, _ = decoder.forward(llm, c, emb, pos[:, -1:] + 1,
                                  twin["mask"][:, None, None, :], twin)
    assert torch.equal(got, want[:, 0].float())
    for a, t in zip(cache["layers"], twin["layers"]):
        assert all(torch.equal(a[n], t[n]) for n in ("c", "k_pe"))
    assert step.tally.read()["pairs"] == (
        (c.num_layers - c.first_k_dense_replace) * b
        * c.num_experts_per_tok)


def _refusals(cfg, fused):
    from opus_pllm_tpu_torch.infer import speculative
    from opus_pllm_tpu_torch.serve.engine import ServingEngine
    from opus_pllm_tpu_torch.train import multimodal_trainer as mmt
    llm, c = fused["llm"], cfg.llm
    x = torch.zeros(1, 4, c.hidden_size)
    pos = torch.arange(4)[None]
    m4 = torch.ones(1, 1, 4, 4, dtype=torch.bool)
    return {
        # no LoRA and no remat: a step decoder.forward would not refuse
        "training": lambda: mmt.make_train_step(cfg, None, remat=False),
        "train_step": lambda: mmt.make_train_step(cfg, None),
        "int8_weights": lambda: builder.load_pretrained(
            None, None, cfg, quantize="int8", device="cpu"),
        "int4_weights": lambda: builder.load_pretrained(
            None, None, cfg, quantize="int4", device="cpu"),
        "int8_cache": lambda: decoder.init_cache(c, 1, 8, device="cpu",
                                                 quantize="int8"),
        "tensor_parallel": lambda: decoder.forward(
            llm, dataclasses.replace(c, tp=object()), x, pos, m4),
        "lora": lambda: decoder.forward(llm, c, x, pos, m4,
                                        lora={"layers": [{}] * 3}),
        "beams": lambda: engine.beam_generate(
            llm, c, x, torch.ones(1, 4, dtype=torch.bool), pos,
            num_beams=2, max_new_tokens=2),
        "speculation": lambda: speculative.draft_from_target(llm, c, 1),
        "serving_engine": lambda: ServingEngine(llm, c),
    }


@pytest.mark.parametrize("what", ["training", "train_step", "int8_weights",
                                  "int4_weights", "int8_cache",
                                  "tensor_parallel", "lora", "beams",
                                  "speculation", "serving_engine"])
def test_refused_combinations_raise(model, what):
    """Each combination outside the annotate path raises ValueError
    naming the family."""
    cfg, _, _, fused = model
    with pytest.raises(ValueError, match="deepseek_v2"):
        _refusals(cfg, fused)[what]()


def _hf_state(llm, c):
    """The tiny decoder tree as a DeepSeek-V2 HF state dict ((out, in)
    weights, experts one by one)."""
    t = lambda p: p["kernel"].t().contiguous()
    sd = {"model.embed_tokens.weight": llm["embed_tokens"]["embedding"],
          "model.norm.weight": llm["final_norm"]["scale"],
          "lm_head.weight": t(llm["lm_head"])}
    for i, lp in enumerate(llm["layers"]):
        at, mp = f"model.layers.{i}.self_attn.", f"model.layers.{i}.mlp."
        sd[f"model.layers.{i}.input_layernorm.weight"] = \
            lp["attn_norm"]["scale"]
        sd[f"model.layers.{i}.post_attention_layernorm.weight"] = \
            lp["ffn_norm"]["scale"]
        sd[at + "q_proj.weight"] = t(lp["q_proj"])
        sd[at + "kv_a_proj_with_mqa.weight"] = t(lp["kv_a_proj"])
        sd[at + "kv_a_layernorm.weight"] = lp["kv_a_norm"]["scale"]
        sd[at + "kv_b_proj.weight"] = t(lp["kv_b_proj"])
        sd[at + "o_proj.weight"] = t(lp["o_proj"])
        if "experts" not in lp:
            for n in ("gate_proj", "up_proj", "down_proj"):
                sd[mp + n + ".weight"] = t(lp[n])
            continue
        sd[mp + "gate.weight"] = t(lp["router"])
        for n in ("gate_proj", "up_proj", "down_proj"):
            for j in range(c.n_routed_experts):
                sd[f"{mp}experts.{j}.{n}.weight"] = \
                    lp["experts"][n]["kernel"][j].t().contiguous()
            sd[f"{mp}shared_experts.{n}.weight"] = t(lp["shared"][n])
    return sd


def test_deepseek_checkpoint_loads(model, tmp_path):
    """A DeepSeek-V2 HF directory written here (config.json and one
    .safetensors file of the tiny model) -> `decoder_config_for` gives the
    tiny config and `load_hf_dir` + `decoder_from_hf` the same tree;
    `fuse_layer` fuses [q | kv_a], the gate|up pairs and the experts'
    interleaved gate|up, and leaves kv_b, o, down and the router."""
    from safetensors.torch import save_file
    cfg, spec, w, _ = model
    llm, c = w["llm"], cfg.llm
    d = tmp_path / "DeepSeek-V2-tiny"
    d.mkdir()
    hf = {k: spec[k] for k in (
        "model_type", "hidden_size", "intermediate_size", "kv_lora_rank",
        "moe_intermediate_size", "n_routed_experts", "n_shared_experts",
        "norm_topk_prob", "num_attention_heads", "num_experts_per_tok",
        "num_hidden_layers", "num_key_value_heads", "q_lora_rank",
        "qk_nope_head_dim", "qk_rope_head_dim", "rms_norm_eps",
        "rope_scaling", "rope_theta", "routed_scaling_factor",
        "v_head_dim", "vocab_size", "first_k_dense_replace",
        "max_position_embeddings", "tie_word_embeddings")}
    (d / "config.json").write_text(json.dumps(hf))
    save_file({k: v.contiguous() for k, v in _hf_state(llm, c).items()},
              str(d / "model.safetensors"))
    got_cfg = builder.decoder_config_for(str(d))
    assert got_cfg == dataclasses.replace(c, dtype="bfloat16")
    tree = convert.decoder_from_hf(convert.load_hf_dir(str(d)), c,
                                   torch.float32)

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            return all(same(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return all(same(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)
    assert same(tree, llm)
    fused = decoder.fuse_layer(tree["layers"][1])
    assert set(fused) == {"attn_norm", "q_kv_a_proj", "kv_a_norm",
                          "kv_b_proj", "o_proj", "ffn_norm", "router",
                          "experts", "shared"}
    assert set(fused["experts"]) == {"gateup_proj", "down_proj"}
    assert set(fused["shared"]) == {"gateup_proj", "down_proj"}
    assert np.isclose(decoder.mla_softmax_scale(c), dref.softmax_scale(spec))


@pytest.mark.parametrize("name, model_type, family", [
    ("DeepSeek-R1-Distill-Llama-8B", "llama", "llama"),
    ("deepseek-coder-7b-qwen", "qwen2", "qwen2"),
    ("my-model", "deepseek_v2", "deepseek_v2"),
    ("DeepSeek-R1-Distill-Llama-8B", None, "llama"),
    ("DeepSeek-V2-Lite", None, "deepseek_v2"),
])
def test_family_from_config_json_first(tmp_path, name, model_type, family):
    """A directory's config.json `model_type` decides its family; only
    without one does the name, with "deepseek" counted after the other
    families' names. A deepseek-named llama or qwen2 directory builds as
    that family (and its config, not DeepSeek's, is read)."""
    d = tmp_path / name
    d.mkdir()
    if model_type is not None:
        hf = {"model_type": model_type, "vocab_size": 300,
              "hidden_size": 64, "intermediate_size": 128,
              "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2}
        if model_type == "deepseek_v2":
            hf.update(kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
                      num_experts_per_tok=2, moe_intermediate_size=64,
                      n_shared_experts=1, first_k_dense_replace=1)
        (d / "config.json").write_text(json.dumps(hf))
    assert builder.family_from_path(str(d)) == family
    if model_type is not None:
        cfg = builder.decoder_config_for(str(d))
        assert cfg.family == family and cfg.hidden_size == 64
