"""Tiny checkpoints in the reference's file formats, written without
transformers: HF llama / qwen2 / OPT directories (config.json and
`.safetensors` shards or a `.bin`), a HF-ESM directory, a fair-esm `.pt`,
the reference's weights directory (Lightning CSTP ckpt, the switch
`.bin`, a PEFT `lora_adapter/`) and an annotation test set. Weights come
from numpy with a fixed seed, on the fp16 grid. `toy_dirs()` builds them
once a process; `jax_cli_answers` runs the JAX CLI on them once a process,
the reference the port's CLI and runner tests hold their answers to.
"""

from __future__ import annotations

import atexit
import functools
import json
import os
import shutil
import tempfile

import numpy as np
import torch

HIDDEN = 64
VOCAB = 260                  # infer.tokenization.ByteTokenizer's
ESM_DIM, ESM_HEADS = 64, 4
CSTP_OUT, TEXT_DIM = 96, 32
N_TOKENS = 8                 # SwitchProjectorConfig default
LAYERS = 2
SEQS = ["MKTAYIAKQR", "ACDEFGHIKLMNPQRSTVWY", "MSTNPKPQRKTKRNTNRRPQDVKF"]
LORA_TARGETS = {"llama": ("q_proj", "k_proj", "v_proj", "o_proj",
                          "gate_proj", "up_proj", "down_proj"),
                "opt": ("q_proj", "k_proj", "v_proj", "out_proj", "fc1",
                        "fc2")}


def _rnd(rng, *shape, scale=0.08):
    return (rng.standard_normal(shape) * scale).astype(np.float16).astype(
        np.float32)


def _save(sd: dict, path: str, safetensors: bool) -> None:
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    if safetensors:
        from safetensors.torch import save_file
        save_file(t, path, metadata={"format": "pt"})
    else:
        torch.save(t, path)


def llm_state_dict(family: str, seed: int, hidden: int = HIDDEN) -> dict:
    """HF key names of a 2-layer LlamaForCausalLM / Qwen2ForCausalLM /
    OPTForCausalLM, `hidden` wide (4 heads, 2 KV heads), MLP 2 x hidden."""
    rng = np.random.default_rng(seed)
    h, f = hidden, 2 * hidden
    sd = {}
    if family == "opt":
        pre = "model.decoder."
        sd[pre + "embed_tokens.weight"] = _rnd(rng, VOCAB, h, scale=0.5)
        sd[pre + "embed_positions.weight"] = _rnd(rng, 512 + 2, h)
        sd[pre + "final_layer_norm.weight"] = 1 + _rnd(rng, h)
        sd[pre + "final_layer_norm.bias"] = _rnd(rng, h)
        sd["lm_head.weight"] = _rnd(rng, VOCAB, h, scale=0.5)
        for i in range(LAYERS):
            lp = f"{pre}layers.{i}."
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[lp + f"self_attn.{n}.weight"] = _rnd(rng, h, h)
                sd[lp + f"self_attn.{n}.bias"] = _rnd(rng, h)
            for n in ("self_attn_layer_norm", "final_layer_norm"):
                sd[lp + n + ".weight"] = 1 + _rnd(rng, h)
                sd[lp + n + ".bias"] = _rnd(rng, h)
            sd[lp + "fc1.weight"], sd[lp + "fc1.bias"] = (_rnd(rng, f, h),
                                                          _rnd(rng, f))
            sd[lp + "fc2.weight"], sd[lp + "fc2.bias"] = (_rnd(rng, h, f),
                                                          _rnd(rng, h))
        return sd
    kv = h // 2                               # 2 KV heads of h / 4
    sd["model.embed_tokens.weight"] = _rnd(rng, VOCAB, h, scale=0.5)
    sd["model.norm.weight"] = 1 + _rnd(rng, h)
    sd["lm_head.weight"] = _rnd(rng, VOCAB, h, scale=0.5)
    for i in range(LAYERS):
        lp = f"model.layers.{i}."
        for n, out in (("q_proj", h), ("k_proj", kv), ("v_proj", kv),
                       ("o_proj", h)):
            sd[lp + f"self_attn.{n}.weight"] = _rnd(rng, out, h)
            if family == "qwen2" and n != "o_proj":
                sd[lp + f"self_attn.{n}.bias"] = _rnd(rng, out)
        for n, shape in (("gate_proj", (f, h)), ("up_proj", (f, h)),
                         ("down_proj", (h, f))):
            sd[lp + f"mlp.{n}.weight"] = _rnd(rng, *shape)
        sd[lp + "input_layernorm.weight"] = 1 + _rnd(rng, h)
        sd[lp + "post_attention_layernorm.weight"] = 1 + _rnd(rng, h)
    return sd


def llm_config(family: str, hidden: int = HIDDEN) -> dict:
    if family == "opt":
        return {"vocab_size": VOCAB, "hidden_size": hidden,
                "ffn_dim": 2 * hidden, "num_hidden_layers": LAYERS,
                "num_attention_heads": 4, "max_position_embeddings": 512,
                "do_layer_norm_before": True,
                "activation_function": "relu", "word_embed_proj_dim": hidden,
                "tie_word_embeddings": False}
    return {"vocab_size": VOCAB, "hidden_size": hidden,
            "intermediate_size": 2 * hidden, "num_hidden_layers": LAYERS,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "max_position_embeddings": 512, "rope_theta": 10000.0,
            "rms_norm_eps": 1e-6 if family == "qwen2" else 1e-5,
            "tie_word_embeddings": False}


def llm_config_fields(family: str, hidden: int = HIDDEN) -> dict:
    """The DecoderConfig fields of `llm_config` (either package's)."""
    c = llm_config(family, hidden)
    return dict(family=family, vocab_size=c["vocab_size"],
                hidden_size=hidden, intermediate_size=2 * hidden,
                num_layers=LAYERS, num_heads=4, num_kv_heads=2,
                head_dim=hidden // 4)


def write_llm_dir(root: str, family: str, *, safetensors: bool,
                  shards: int = 1, name=None, hidden: int = HIDDEN) -> str:
    name = name or {"llama": "tiny-llama-3", "qwen2": "tiny-qwen2.5",
                    "opt": "tiny-galactica-opt"}[family]
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(llm_config(family, hidden), f)
    sd = llm_state_dict(family, {"llama": 0, "opt": 1, "qwen2": 2}[family],
                        hidden)
    keys = sorted(sd)
    for s in range(shards):
        part = {k: sd[k] for k in keys[s::shards]}
        ext = "safetensors" if safetensors else "bin"
        fname = (f"model-{s + 1:05d}-of-{shards:05d}.{ext}" if safetensors
                 else f"pytorch_model-{s + 1:05d}.{ext}")
        _save(part, os.path.join(path, fname), safetensors)
    return path


def esm_state_dict(seed: int = 7, prefix: str = "") -> dict:
    """A 2-layer, 64-wide EsmModel (HF names, or fair-esm's with
    fair=True via `fair_esm_state_dict`)."""
    rng = np.random.default_rng(seed)
    e = ESM_DIM
    sd = {prefix + "embeddings.word_embeddings.weight": _rnd(rng, 33, e,
                                                             scale=0.5),
          prefix + "encoder.emb_layer_norm_after.weight": 1 + _rnd(rng, e),
          prefix + "encoder.emb_layer_norm_after.bias": _rnd(rng, e)}
    for i in range(LAYERS):
        lp = f"{prefix}encoder.layer.{i}."
        for n in ("attention.self.query", "attention.self.key",
                  "attention.self.value", "attention.output.dense"):
            sd[lp + n + ".weight"], sd[lp + n + ".bias"] = (_rnd(rng, e, e),
                                                            _rnd(rng, e))
        for n in ("attention.LayerNorm", "LayerNorm"):
            sd[lp + n + ".weight"], sd[lp + n + ".bias"] = (1 + _rnd(rng, e),
                                                            _rnd(rng, e))
        sd[lp + "intermediate.dense.weight"] = _rnd(rng, 4 * e, e)
        sd[lp + "intermediate.dense.bias"] = _rnd(rng, 4 * e)
        sd[lp + "output.dense.weight"] = _rnd(rng, e, 4 * e)
        sd[lp + "output.dense.bias"] = _rnd(rng, e)
    return sd


_HF_TO_FAIR = (("embeddings.word_embeddings", "embed_tokens"),
               ("encoder.emb_layer_norm_after", "emb_layer_norm_after"),
               ("encoder.layer.", "layers."),
               ("attention.self.query", "self_attn.q_proj"),
               ("attention.self.key", "self_attn.k_proj"),
               ("attention.self.value", "self_attn.v_proj"),
               ("attention.output.dense", "self_attn.out_proj"),
               ("attention.LayerNorm", "self_attn_layer_norm"),
               ("intermediate.dense", "fc1"), ("output.dense", "fc2"),
               (".LayerNorm", ".final_layer_norm"))


def fair_esm_state_dict(seed: int = 7) -> dict:
    out = {}
    for k, v in esm_state_dict(seed).items():
        for a, b in _HF_TO_FAIR:
            k = k.replace(a, b)
        out[k] = v
    return out


def write_esm_dir(root: str) -> str:
    path = os.path.join(root, "tiny-esm2")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"num_hidden_layers": LAYERS, "hidden_size": ESM_DIM,
                   "num_attention_heads": ESM_HEADS,
                   "token_dropout": True}, f)
    _save(esm_state_dict(), os.path.join(path, "model.safetensors"), True)
    return path


def write_fair_esm(root: str) -> str:
    path = os.path.join(root, "tiny_esm2_t2.pt")
    torch.save({"model": {"encoder.sentence_encoder." + k:
                          torch.from_numpy(v)
                          for k, v in fair_esm_state_dict().items()},
                "args": {"encoder_layers": LAYERS,
                         "encoder_embed_dim": ESM_DIM,
                         "encoder_attention_heads": ESM_HEADS}}, path)
    return path


def peft_state_dict(family: str, rank: int = 2, seed: int = 11,
                    hidden: int = HIDDEN) -> dict:
    rng = np.random.default_rng(seed)
    cfg = llm_config(family, hidden)
    h, f = hidden, 2 * hidden
    kv = h // 2 if family != "opt" else h
    dims = {"q_proj": (h, h), "k_proj": (h, kv), "v_proj": (h, kv),
            "o_proj": (h, h), "out_proj": (h, h), "gate_proj": (h, f),
            "up_proj": (h, f), "down_proj": (f, h), "fc1": (h, f),
            "fc2": (f, h)}
    sd = {}
    for i in range(cfg["num_hidden_layers"]):
        for n in LORA_TARGETS["opt" if family == "opt" else "llama"]:
            if family == "opt":
                stem = f"base_model.model.model.decoder.layers.{i}."
                stem += n if n in ("fc1", "fc2") else f"self_attn.{n}"
            else:
                where = "mlp" if n in ("gate_proj", "up_proj",
                                       "down_proj") else "self_attn"
                stem = f"base_model.model.model.layers.{i}.{where}.{n}"
            din, dout = dims[n]
            sd[stem + ".lora_A.weight"] = _rnd(rng, rank, din, scale=0.1)
            sd[stem + ".lora_B.weight"] = _rnd(rng, dout, rank, scale=0.1)
    return sd


def write_peft_dir(path: str, family: str, *, safetensors: bool,
                   rank: int = 2, alpha: float = 4.0, seed: int = 11,
                   hidden: int = HIDDEN) -> str:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": alpha, "peft_type": "LORA",
                   "task_type": "CAUSAL_LM",
                   "target_modules": list(LORA_TARGETS[
                       "opt" if family == "opt" else "llama"])}, f)
    fname = ("adapter_model.safetensors" if safetensors
             else "adapter_model.bin")
    _save(peft_state_dict(family, rank, seed, hidden),
          os.path.join(path, fname), safetensors)
    return path


def write_weights_dir(root: str, family: str, *, safetensors: bool,
                      hidden: int = HIDDEN) -> str:
    """The reference contract for a `hidden`-wide LLM: CSTP Lightning ckpt
    (with hyper_parameters), switch `.bin`, PEFT adapter."""
    wd = os.path.join(root, f"opus-weights-{family}-{hidden}")
    os.makedirs(os.path.join(wd, "modality_encoder"), exist_ok=True)
    os.makedirs(os.path.join(wd, "modality_refinement_projector"),
                exist_ok=True)
    rng = np.random.default_rng(13)
    t = lambda *s, scale=0.08: torch.from_numpy(_rnd(rng, *s, scale=scale))
    torch.save({"state_dict": {
        "protein_projection.linear.weight": t(CSTP_OUT, ESM_DIM),
        "protein_projection.linear.bias": t(CSTP_OUT),
        "text_projection.linear.weight": t(CSTP_OUT, TEXT_DIM),
        "text_projection.linear.bias": t(CSTP_OUT)},
        "hyper_parameters": {"protein_projection_input_dim": ESM_DIM,
                             "protein_projection_output_dim": CSTP_OUT,
                             "text_projection_input_dim": TEXT_DIM,
                             "text_projection_output_dim": CSTP_OUT}},
        os.path.join(wd, "modality_encoder", "modality_encoding_adapter.ckpt"))
    out = hidden * N_TOKENS
    torch.save({"switch_projector.0.weight": t(out, CSTP_OUT),
                "switch_projector.0.bias": t(out),
                "switch_projector.2.weight": t(out, out),
                "switch_projector.2.bias": t(out)},
               os.path.join(wd, "modality_refinement_projector",
                            "modality_refinement_projection.bin"))
    write_peft_dir(os.path.join(wd, "lora_adapter"), family,
                   safetensors=safetensors, hidden=hidden)
    return wd


def write_annotation_json(path: str, n: int = 3) -> str:
    with open(path, "w") as f:
        json.dump([{"instruction": "What are the UniProtKB keywords of "
                                   "this protein?",
                    "input": SEQS[i % len(SEQS)], "output": "Hydrolase"}
                   for i in range(n)], f)
    return path


@functools.lru_cache(maxsize=None)
def toy_dirs() -> dict:
    """Every fixture directory, written once a process into a temporary
    directory removed at exit."""
    root = tempfile.mkdtemp(prefix="opus-toy-ckpt-")
    atexit.register(shutil.rmtree, root, True)
    d = {"root": root, "esm": write_esm_dir(root),
         "fair_esm": write_fair_esm(root),
         "llama": write_llm_dir(root, "llama", safetensors=True, shards=2),
         "qwen2": write_llm_dir(root, "qwen2", safetensors=True),
         "opt": write_llm_dir(root, "opt", safetensors=False),
         "llama_bin": write_llm_dir(root, "llama", safetensors=False,
                                    name="tiny-llama-bin"),
         # 256 wide: K % 256 == 0, so int4 packs every projection
         "llama256": write_llm_dir(root, "llama", safetensors=True,
                                   name="tiny-llama-256", hidden=256)}
    d["weights"] = write_weights_dir(root, "llama", safetensors=True)
    d["weights_opt"] = write_weights_dir(root, "opt", safetensors=False)
    d["weights256"] = write_weights_dir(root, "llama", safetensors=False,
                                        hidden=256)
    d["test_json"] = write_annotation_json(
        os.path.join(root, "test_keywords.json"))
    return d


class _ByteTok:
    """The JAX package's ByteTokenizer in the HFTokenizer's place (the toy
    directories carry no tokenizer files)."""

    def __new__(cls, path, family=None):
        from opus_pllm_tpu.infer.tokenization import ByteTokenizer
        return ByteTokenizer()


CLI_BASE = ("--temperature", "0", "--batch-size", "2",
            "--max-new-tokens", "6")


def annotate_args(d: dict, extra=()) -> list:
    return ["annotate", "--model-base", d["llama"], "--weights",
            d["weights"], "--esm", d["esm"], "--test-json", d["test_json"],
            *CLI_BASE, *extra]


CLI_MODES = ((), ("--num-beams", "2"), ("--draft-layers", "1", "--n-draft",
                                         "3"))


@functools.lru_cache(maxsize=None)
def _jax_cli_runs() -> dict:
    """The JAX CLI's saved annotate answers on the toy directories for
    every mode of CLI_MODES, at T = 0 (its HFTokenizer replaced by the
    byte tokenizer, which the port's CLI tests use as well). All in one
    go: the splice's compiled functions are shared while they live."""
    from opus_pllm_tpu.cli.main import main
    from opus_pllm_tpu.infer import hf_tokenizer
    d = toy_dirs()
    saved = hf_tokenizer.HFTokenizer
    hf_tokenizer.HFTokenizer = _ByteTok
    answers = {}
    try:
        for extra in CLI_MODES:
            out = os.path.join(d["root"], "jax-" + "-".join(extra) + ".json")
            main(annotate_args(d, extra) + ["--save-path", out])
            with open(out) as f:
                answers[extra] = tuple(r["generated"] for r in json.load(f))
    finally:
        hf_tokenizer.HFTokenizer = saved
    return answers


def jax_cli_answers(extra: tuple) -> tuple:
    """The JAX CLI's saved answers for one of CLI_MODES."""
    return _jax_cli_runs()[tuple(extra)]
