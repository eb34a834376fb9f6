"""Model assembly from checkpoint files (port of
`opus_pllm_tpu/core/builder.py`, the whole module).

The counterpart of the reference's `load_pretrained_model`
(multi_modality_v1/model/builder.py:19-131), with its checkpoint-directory
contract:

    <weights>/modality_encoder/modality_encoding_adapter.ckpt   (Lightning
        CSTP; may also carry a fine-tuned ESM2 under `protein_model.model.*`)
    <weights>/modality_refinement_projector/
        modality_refinement_projection.bin                      (switch MLP)
    <weights>/lora_adapter/                                     (PEFT LoRA)

plus a HF directory for the base LLM (its family from the directory's
name: 'llama' / 'opt' / 'galactica' / 'qwen', builder.py:59-96) and a
fair-esm `.pt` or HF-ESM directory for the encoder. A LoRA adapter merges
into the base weights as PEFT's merge_and_unload does.

Files are read into CPU tensors (core.convert) and the finished tree moves
to the device once; int8 / int4 quantization after a merge runs there.
What no file provides is drawn at random on the device from
`torch.Generator`s seeded 0 (ESM2), 1 (CSTP), 2 (switch) and 3 (LLM), the
seeds of the JAX package's PRNGKeys (the numbers differ: another
generator). The random ESM2 takes the loaded one's dtype (the JAX package
draws it in the config's fp32), so the encoder runs the same kernels with
and without a file. `save_native` / `load_native` keep the assembled tree
in `torch.save` format (core.checkpoint) beside the same
`quant_layout.json` as the JAX package's Orbax directory.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Any, Dict, Optional, Tuple

import torch

from . import checkpoint as ckpt
from . import convert
from .config import (CSTPConfig, DecoderConfig, ESM2Config, LoRAConfig,
                     OpusConfig)
from .util import resolve_device, to_device

CSTP_CKPT = "modality_encoder/modality_encoding_adapter.ckpt"
SWITCH_BIN = ("modality_refinement_projector/"
              "modality_refinement_projection.bin")
LORA_DIR = "lora_adapter"
ESM_OVERLAY_PREFIX = "protein_model.model."
NATIVE_FILE = "params.pt"


def family_from_path(model_base: str) -> str:
    """The decoder family of a model directory: its config.json's
    `model_type` where the port runs that type, else the directory's NAME
    (its basename, so a directory under a parent named "opt" is not taken
    for OPT). "deepseek" in a name counts after the other families' names,
    so DeepSeek-R1-Distill-Llama-8B without a config.json is a llama."""
    cfg_path = os.path.join(model_base, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            model_type = json.load(f).get("model_type")
        # each family is named after the model_type it runs
        if model_type in ("llama", "qwen2", "opt", "deepseek_v2"):
            return model_type
    b = os.path.basename(os.path.normpath(model_base)).lower()
    if "llama" in b:
        return "llama"
    if "opt" in b or "galactica" in b:
        return "opt"
    if "qwen" in b:
        return "qwen2"
    if "deepseek" in b:
        return "deepseek_v2"
    raise NotImplementedError(f"unknown LLM family in name: {model_base}")


def decoder_config_for(model_base: str) -> DecoderConfig:
    """DecoderConfig from the HF config.json in `model_base`; without one,
    the family's published preset (llama3_8b, qwen25_7b,
    galactica_6_7b)."""
    fam = family_from_path(model_base)
    cfg_path = os.path.join(model_base, "config.json")
    if not os.path.exists(cfg_path):
        return {"llama": DecoderConfig.llama3_8b,
                "qwen2": DecoderConfig.qwen25_7b,
                "opt": DecoderConfig.galactica_6_7b,
                "deepseek_v2": DecoderConfig.deepseek_v2_lite}[fam]()
    with open(cfg_path) as f:
        hf = json.load(f)
    if fam == "deepseek_v2":
        return deepseek_config(hf)
    if fam == "opt":
        return DecoderConfig(
            family="opt", vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["ffn_dim"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf["num_attention_heads"],
            head_dim=hf["hidden_size"] // hf["num_attention_heads"],
            max_position_embeddings=hf["max_position_embeddings"],
            do_layer_norm_before=hf.get("do_layer_norm_before", True),
            activation={"relu": "relu", "gelu": "gelu"}.get(
                hf.get("activation_function", "relu"), "relu"),
            tie_word_embeddings=hf.get("tie_word_embeddings", True))
    nh = hf["num_attention_heads"]
    return DecoderConfig(
        family=fam, vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"], num_heads=nh,
        num_kv_heads=hf.get("num_key_value_heads", nh),
        head_dim=hf.get("head_dim", hf["hidden_size"] // nh),
        rope_theta=hf.get("rope_theta", 10000.0),
        # only where the HF config sets it (builder.py:93-94 is commented
        # out in the reference, and HF Qwen2 never applies dynamic NTK)
        use_dynamic_ntk=bool(hf.get("use_dynamic_ntk", False)),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_position_embeddings=hf.get("max_position_embeddings", 8192),
        attention_bias=(fam == "qwen2"),
        tie_word_embeddings=hf.get("tie_word_embeddings", False))


def deepseek_config(hf: dict) -> DecoderConfig:
    """DecoderConfig of a DeepSeek-V2 config.json (model_type
    deepseek_v2): MLA without q-LoRA, greedy softmax routing every layer
    after the dense ones, YaRN or no rope scaling; other settings raise."""
    rs = hf.get("rope_scaling") or {}
    if (hf.get("q_lora_rank") is not None
            or hf.get("moe_layer_freq", 1) != 1
            or hf.get("topk_method", "greedy") != "greedy"
            or hf.get("scoring_func", "softmax") != "softmax"
            or hf.get("attention_bias", False)
            or rs.get("type", "yarn") != "yarn"):
        raise ValueError("this DeepSeek-V2 variant is not supported (the "
                         "port runs q_lora_rank null, moe_layer_freq 1, "
                         "greedy softmax routing, no attention bias, YaRN)")
    nope, rope = hf["qk_nope_head_dim"], hf["qk_rope_head_dim"]
    nh = hf["num_attention_heads"]
    return DecoderConfig(
        family="deepseek_v2", vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"], num_heads=nh,
        num_kv_heads=hf.get("num_key_value_heads", nh),
        head_dim=nope + rope, rope_theta=float(hf.get("rope_theta", 1e4)),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        max_position_embeddings=hf.get("max_position_embeddings", 8192),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        kv_lora_rank=hf["kv_lora_rank"], qk_nope_head_dim=nope,
        qk_rope_head_dim=rope, v_head_dim=hf["v_head_dim"],
        n_routed_experts=hf["n_routed_experts"],
        num_experts_per_tok=hf["num_experts_per_tok"],
        moe_intermediate_size=hf["moe_intermediate_size"],
        n_shared_experts=hf.get("n_shared_experts") or 0,
        first_k_dense_replace=hf.get("first_k_dense_replace", 0),
        norm_topk_prob=bool(hf.get("norm_topk_prob", False)),
        routed_scaling_factor=float(hf.get("routed_scaling_factor", 1.0)),
        rope_factor=float(rs.get("factor", 1.0)),
        rope_original_max_position=rs.get(
            "original_max_position_embeddings", 4096),
        rope_beta_fast=float(rs.get("beta_fast", 32)),
        rope_beta_slow=float(rs.get("beta_slow", 1)),
        rope_mscale=float(rs.get("mscale", 1.0)),
        rope_mscale_all_dim=float(rs.get("mscale_all_dim", 0.0)))


def esm_config_for(esm_path: Optional[str]) -> ESM2Config:
    """ESM2Config from the checkpoint: a HF-ESM directory's config.json or
    a fair-esm `.pt`'s args; else the reference's esm2_t33_650M."""
    if esm_path is None:
        return ESM2Config.t33_650M()
    if os.path.isdir(esm_path):
        cfg_path = os.path.join(esm_path, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                hf = json.load(f)
            return ESM2Config(num_layers=hf["num_hidden_layers"],
                              embed_dim=hf["hidden_size"],
                              num_heads=hf["num_attention_heads"],
                              token_dropout=hf.get("token_dropout", True))
        return ESM2Config.t33_650M()
    try:
        obj = convert.load_torch_file(esm_path)
    except (OSError, RuntimeError, ValueError, pickle.UnpicklingError):
        return ESM2Config.t33_650M()
    a = obj.get("args") if isinstance(obj, dict) else None
    if a is None:
        return ESM2Config.t33_650M()
    get = (a.get if isinstance(a, dict)
           else lambda k, d=None: getattr(a, k, d))
    return ESM2Config(num_layers=get("encoder_layers", 33),
                      embed_dim=get("encoder_embed_dim", 1280),
                      num_heads=get("encoder_attention_heads", 20))


def cstp_config_for(weights_dir: Optional[str]) -> CSTPConfig:
    """CSTPConfig from the Lightning ckpt's hyper_parameters (the dims the
    reference reads, protein_projector/builder.py:5-13); else the
    published 1280 -> 5120 adapter."""
    if weights_dir:
        path = os.path.join(weights_dir, CSTP_CKPT)
        if os.path.exists(path):
            try:
                hp = torch.load(path, map_location="cpu",
                                weights_only=False).get(
                                    "hyper_parameters", {})
                return CSTPConfig(
                    protein_dim=hp["protein_projection_input_dim"],
                    text_dim=hp["text_projection_input_dim"],
                    proj_dim=hp["protein_projection_output_dim"])
            except (KeyError, TypeError, AttributeError):
                pass
    return CSTPConfig()


def context_len_for(model_base: Optional[str]) -> int:
    """max_sequence_length from config.json, else 512
    (builder.py:126-129)."""
    if model_base:
        p = os.path.join(model_base, "config.json")
        if os.path.exists(p):
            with open(p) as f:
                hf = json.load(f)
            if "max_sequence_length" in hf:
                return int(hf["max_sequence_length"])
    return 512


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def load_esm(esm_path: Optional[str], cfg: ESM2Config,
             overlay_sd: Optional[Dict] = None, dtype=torch.bfloat16, *,
             device=None):
    """ESM2 weights from a fair-esm `.pt`, a HF-ESM directory or a random
    draw, on `device` (None: CUDA); `overlay_sd` (the fair-esm dialect)
    takes precedence: the CSTP-finetuned encoder inside the Lightning ckpt
    (cstp_v3/modelling.py:25-30)."""
    device = resolve_device(device)
    if overlay_sd:
        tree = convert.esm2_from_fair_esm(overlay_sd, cfg, dtype)
    elif esm_path is None:
        from ..models import esm2
        name = {torch.bfloat16: "bfloat16", torch.float32: "float32",
                torch.float16: "float16"}[dtype]
        return esm2.init(dataclasses.replace(cfg, dtype=name),
                         generator=_generator(0, device), device=device)
    elif os.path.isdir(esm_path):
        tree = convert.esm2_from_hf(convert.load_hf_dir(esm_path), cfg,
                                    dtype)
    else:
        sd = convert.load_torch_file(esm_path)
        if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
            sd = sd["model"]            # fair-esm nests under 'model'
        sd = {k.removeprefix("encoder.sentence_encoder.")
              .removeprefix("encoder."): v for k, v in sd.items()}
        tree = convert.esm2_from_fair_esm(sd, cfg, dtype)
    return to_device(tree, device)


def _lora_files(lora_dir: str):
    return [f for f in sorted(os.listdir(lora_dir))
            if f.endswith((".bin", ".safetensors"))]


def load_pretrained(model_base: Optional[str], weights_dir: Optional[str],
                    cfg: OpusConfig, *, esm_path: Optional[str] = None,
                    lora_cfg: Optional[LoRAConfig] = None,
                    merge_lora: bool = True, quantize: Optional[str] = None,
                    int4_layout: str = "auto", dtype=torch.bfloat16,
                    device=None, mesh=None,
                    keep_layers: Optional[range] = None
                    ) -> Tuple[dict, Optional[dict]]:
    """The full parameter tree on `device` (None: CUDA) -> (params,
    unmerged LoRA tree or None).

    model_base: HF directory of the base LLM (None or missing: random).
    weights_dir: the reference-contract directory (None: the raw pipeline,
        random CSTP and switch, no LoRA, builder.py:117-118).
    quantize: "int8" (each projection quantized on load on the host, or
        after the LoRA merge on the device) or "int4" (after the merge, on
        the device, `int4_layout` "auto" / "v1" / "v2" as
        quant4.quantize_linear4 takes it): load_8bit / load_4bit's role
        (builder.py:44-57).
    mesh: a core.mesh.Mesh whose model axis splits the LLM: each rank
        keeps only its slice (`_load_llm_sharded`); its local config is
        `parallel.partition.config_for(params["llm"], cfg.llm, mesh)`.
    keep_layers: only these decoder layers are kept (a pipeline stage's
        block, `parallel.pipeline.PipeMesh.layer_range`): every layer is
        still drawn or read as one process does, and the others dropped
        before the next, so the tree's "layers" holds the block alone."""
    device = resolve_device(device)
    if quantize not in (None, "int8", "int4"):
        raise ValueError(f"unknown quantize mode: {quantize}")
    if quantize:
        from ..models.decoder import refuse_deepseek
        refuse_deepseek(cfg.llm, "quantized weights")
    params: Dict[str, Any] = {}

    # CSTP adapter (+ the fine-tuned ESM2 it may carry)
    overlay = None
    cstp_file = weights_dir and os.path.join(weights_dir, CSTP_CKPT)
    if cstp_file and os.path.exists(cstp_file):
        full = convert.load_torch_file(cstp_file)
        if cfg.cstp is not None:
            params["cstp"] = to_device(convert.cstp_from_lightning(full),
                                       device)
        overlay = convert.filter_prefix(full, ESM_OVERLAY_PREFIX) or None
    elif cfg.cstp is not None:
        from ..bridge import cstp as cstp_mod
        params["cstp"] = cstp_mod.init(cfg.cstp,
                                       generator=_generator(1, device),
                                       device=device)

    params["esm"] = load_esm(esm_path, cfg.esm, overlay, dtype,
                             device=device)

    switch_file = weights_dir and os.path.join(weights_dir, SWITCH_BIN)
    if switch_file and os.path.exists(switch_file):
        params["switch"] = to_device(convert.switch_projector_from_torch(
            convert.load_torch_file(switch_file)), device)
    else:
        from ..bridge import projector
        params["switch"] = projector.init(cfg.switch,
                                          generator=_generator(2, device),
                                          device=device)

    # the LoRA merge needs full-precision weights: quantize on load only
    # when no adapter with weight files will merge below
    lora_dir = weights_dir and os.path.join(weights_dir, LORA_DIR)
    has_lora = bool(lora_dir and os.path.isdir(lora_dir))
    will_merge = has_lora and merge_lora and bool(_lora_files(lora_dir))
    tp_mesh = mesh if mesh is not None and mesh.model > 1 else None
    if tp_mesh is not None or keep_layers is not None:
        params["llm"], unmerged = _load_llm_sharded(
            model_base, cfg.llm, lora_dir if has_lora else None, lora_cfg,
            merge_lora, quantize, int4_layout, dtype, device, tp_mesh,
            keep_layers)
        return params, unmerged
    if model_base and os.path.isdir(model_base):
        llm = to_device(convert.decoder_from_hf(
            convert.load_hf_dir(model_base), cfg.llm, dtype,
            quantize_int8=(quantize == "int8" and not will_merge)), device)
    else:
        from ..models import decoder
        # no adapter merges into a random draw: each part is quantized as
        # it is drawn (the same values as quantizing the whole tree after,
        # without the whole model in bf16 on the device first)
        q = (lambda tree: _quantize_part(tree, quantize, int4_layout)) \
            if quantize and not has_lora else (lambda tree: tree)
        llm = decoder.init(
            cfg.llm, generator=_generator(3, device), device=device,
            finish_head=lambda h: q({"lm_head": h, "layers": []})["lm_head"],
            finish_layer=lambda lp: q({"layers": [lp]})["layers"][0])

    unmerged = None
    if has_lora:
        flat = convert.lora_from_peft(_load_peft_sd(lora_dir))
        scale = _peft_scaling(lora_dir, lora_cfg)
        if merge_lora:
            llm = convert.merge_lora_into_decoder(
                llm, to_device(flat, device), scale)
        else:
            from ..lora.lora import tree_from_flat
            unmerged = tree_from_flat(flat, cfg.llm.num_layers,
                                      device=device)

    first = llm["layers"][0].get("q_proj", {})
    if quantize == "int8" and "kernel_q" not in first:
        from ..kernels.quant import quantize_decoder
        llm = quantize_decoder(llm)
    elif quantize == "int4" and "kernel_p" not in first:
        from ..kernels.quant4 import quantize_decoder4
        llm = quantize_decoder4(llm, int4_layout)
    params["llm"] = llm
    return params, unmerged


def _quantize_part(tree: dict, quantize: Optional[str], layout: str):
    """int8 / int4 quantization of a partial decoder tree ({"lm_head"?,
    "layers": [...]}); projections already quantized stay as they are."""
    if quantize == "int8":
        from ..kernels.quant import quantize_decoder
        return quantize_decoder(tree)
    if quantize == "int4":
        from ..kernels.quant4 import quantize_decoder4
        return quantize_decoder4(tree, layout)
    return tree


def _load_llm_sharded(model_base, llm_cfg: DecoderConfig, lora_dir,
                      lora_cfg, merge_lora: bool, quantize, int4_layout,
                      dtype, device, mesh, keep=None):
    """The decoder of one rank of a tensor-parallel mesh (`mesh`) and / or
    of one pipeline stage (`keep`, its layers): each part is drawn (the
    single process's generators) or read from the files on the host,
    merged with the LoRA adapter, moved to the device, quantized as a
    single process quantizes it, and cut to this rank's slice
    (parallel.partition), or dropped when it is a layer outside `keep`,
    before the next part: no rank holds the whole LLM on its device. A
    layer quantizes whole, then is cut (int8's scale of a row-parallel
    product spans every row); the head is cut first. -> (this rank's
    tree, its unmerged LoRA or None)."""
    from ..parallel import partition

    head_tp = partition.plan(llm_cfg, mesh) if mesh is not None else None
    state = {"tp": None, "i": -1}

    def finish_head(head):
        # column-parallel: each column quantizes on its own (int8 and int4
        # scales are per column), so the slice quantizes first, the same
        # values without the whole head's transients
        head = {"lm_head": to_device(head, device)}
        if head_tp is not None:
            head = partition.shard_head(head, head_tp)
        return _quantize_part(dict(head, layers=[]), quantize,
                              int4_layout)["lm_head"]

    def finish_layer(lp):
        state["i"] += 1
        if keep is not None and state["i"] not in keep:
            return None
        lp = _quantize_part({"layers": [to_device(lp, device)]}, quantize,
                            int4_layout)["layers"][0]
        if mesh is None:
            return lp
        if state["tp"] is None:
            state["tp"] = partition.plan(llm_cfg, mesh, lp)
        return partition.shard_layer(lp, state["tp"])

    flat = scale = None
    if lora_dir is not None:
        flat = convert.lora_from_peft(_load_peft_sd(lora_dir))
        scale = _peft_scaling(lora_dir, lora_cfg)
    if model_base and os.path.isdir(model_base):
        host = convert.decoder_from_hf(convert.load_hf_dir(model_base),
                                       llm_cfg, dtype)
        if flat is not None and merge_lora:
            host = convert.merge_lora_into_decoder(host, flat, scale)
        llm = {k: to_device(v, device) for k, v in host.items()
               if k not in ("layers", "lm_head")}
        if "lm_head" in host:
            llm["lm_head"] = finish_head(host.pop("lm_head"))
        llm["layers"] = []
        for i in range(len(host["layers"])):
            llm["layers"].append(finish_layer(host["layers"][i]))
            host["layers"][i] = None
    else:
        from ..models import decoder
        llm = decoder.init(llm_cfg, generator=_generator(3, device),
                           device=device, finish_head=finish_head,
                           finish_layer=finish_layer)
        if flat is not None and merge_lora:
            raise ValueError("a LoRA adapter merges into loaded base "
                             "weights: give --model-base a HF directory")
    llm["layers"] = [lp for lp in llm["layers"] if lp is not None]
    unmerged = None
    if flat is not None and not merge_lora:
        from ..lora.lora import tree_from_flat
        unmerged = tree_from_flat(flat, llm_cfg.num_layers, device=device)
        if keep is not None:
            unmerged = {"layers": [unmerged["layers"][i] for i in keep]}
        if mesh is not None:
            unmerged = partition.shard_lora(unmerged, state["tp"])
    return llm, unmerged


def _load_peft_sd(lora_dir: str) -> Dict[str, Any]:
    sd: Dict[str, Any] = {}
    for f in _lora_files(lora_dir):
        p = os.path.join(lora_dir, f)
        sd.update(convert.load_safetensors(p) if f.endswith(".safetensors")
                  else convert.load_torch_file(p))
    return sd


def load_peft_adapter(lora_dir: str, num_layers: int):
    """A PEFT adapter directory (or a weights directory holding
    lora_adapter/) -> ({"layers": [...]} fp32 CPU tensors, scaling): the
    unmerged form the serving engine's bank takes. Without an
    adapter_config.json it raises ValueError: the bank needs the trained
    lora_alpha / r to fold the scaling."""
    sub = os.path.join(lora_dir, LORA_DIR)
    if os.path.isdir(sub):
        lora_dir = sub
    sd = _load_peft_sd(lora_dir)
    if not sd:
        raise ValueError(f"no .bin/.safetensors adapter weights in "
                         f"{lora_dir}")
    if not os.path.exists(os.path.join(lora_dir, "adapter_config.json")):
        raise ValueError(
            f"{lora_dir} has no adapter_config.json; the bank needs the "
            "trained lora_alpha/r to fold the per-adapter scaling")
    from ..lora.lora import tree_from_flat
    return (tree_from_flat(convert.lora_from_peft(sd), num_layers,
                           device="cpu"),
            _peft_scaling(lora_dir, None))


def _peft_scaling(lora_dir: str, lora_cfg: Optional[LoRAConfig]) -> float:
    cfg_file = os.path.join(lora_dir, "adapter_config.json")
    if os.path.exists(cfg_file):
        with open(cfg_file) as f:
            c = json.load(f)
        return c.get("lora_alpha", 32) / c.get("r", 16)
    if lora_cfg is not None:
        return lora_cfg.alpha / lora_cfg.rank
    return 2.0


def check_train_layout(cmd: str, llm_params: dict) -> None:
    """A train-* command refuses the int4 v2 (decode) pack: training takes
    the v1 nibble-byte layout (quant4.py; SystemExit with the remedy)."""
    from ..kernels.quant4 import quant_layout_of
    if cmd.startswith("train") and quant_layout_of(llm_params) == "int4-v2":
        raise SystemExit(
            "the loaded int4 weights use the v2 magic-bitcast DECODE "
            "layout (quant_layout.json: int4-v2); train-* commands need "
            "the v1 nibble-byte layout. Re-convert with `convert-weights "
            "--load-int4 --int4-layout v1`, or load directly from the "
            "torch checkpoint with --load-int4 (train commands pick v1 "
            "automatically).")


def save_native(path: str, params: dict) -> None:
    """The assembled tree into the directory `path` (`params.pt`, the
    torch.save format of core.checkpoint), with `quant_layout.json` naming
    the LLM's weight layout (bf16 / int8 / int4-v1 / int4-v2)."""
    os.makedirs(path, exist_ok=True)
    ckpt.save_pytree(os.path.join(path, NATIVE_FILE), params)
    if "llm" in params:
        from ..kernels.quant4 import quant_layout_of
        meta = {"llm_layout": quant_layout_of(params["llm"]),
                "note": ("int4-v1 = nibble bytes (QLoRA training fast "
                         "path); int4-v2 = magic-bitcast words (decode/"
                         "serving fast path; train-* commands reject it)")}
        with open(os.path.join(path, "quant_layout.json"), "w") as f:
            json.dump(meta, f, indent=1)


def load_native(path: str, like: Optional[dict] = None, *, device=None):
    """A tree saved by `save_native`; `like` gives it its structure,
    devices and dtypes (core.checkpoint.restore_pytree), else it lands on
    `device` (None: CUDA)."""
    tree = ckpt.restore_pytree(os.path.join(path, NATIVE_FILE), like)
    return tree if like is not None else to_device(tree, device)
