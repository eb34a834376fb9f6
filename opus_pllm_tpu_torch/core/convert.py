"""Carry a JAX parameter tree over to the port (new; no JAX counterpart).

`from_jax(tree)` takes the JAX package's Opus parameter tree, with numpy
leaves (np.asarray of each jax array; bf16 arrives as the ml_dtypes
bfloat16 numpy type), in either the per-layer `layers` list or the
`layers_stacked` layout (decoder.py:409 `stack_params`), and returns the
port's parameters. Both packages then compute the same function.

What changes on the way, and nothing else:
  * `layers_stacked` is split back into a `layers` list (leading axis);
  * each ESM2 layer's q/k/v projections become one packed
    "qkv" = {"kernel": (3, E, E), "bias": (3, E)} by stacking the three
    (E, E) kernels (no transpose). From esm2.fuse_qkv's (E, 3E) "qkv_proj"
    the kernel is reshaped to (E, 3, E) and TRANSPOSED to (3, E, E) — axes
    (1, 0, 2) — the one transpose this module makes; "qkv_fused" (already
    (3, E, E)) is taken as it is.
  * Linear kernels stay (in, out): the port multiplies x @ kernel as the
    JAX package does, so no kernel is transposed.
  * int8 decoder leaves ("kernel_q" int8, "scale" fp32; kernels/quant.py)
    and int4 ones ("kernel_p" int32 v2 words or int8 v1 nibble bytes,
    "gscale" fp32; kernels/quant4.py) are copied as they are: the port
    keeps the JAX storage layouts.
Fused decoder projections (decoder.fuse_projections: "qkv_proj",
"gateup_proj", bf16 / int8 / int4) are copied as they are too. A
quantized leaf the port has no kernel for (any in ESM2, BERT or the
switch, or a decoder "kernel_q" / "kernel_p" of another dtype) raises
ValueError. `device=None` puts the parameters on CUDA
(core.util.resolve_device).

`bert_from_jax` carries the JAX BERTScore encoder's tree across as it
is, `cstp_from_jax` the CSTP adapter's (the stage-(a) trainer's
parameters: two fp32 linears). `lora_from_jax` and `trainable_from_jax`
carry a JAX LoRA tree ({"layers": [{proj: {"A", "B"}}]}) and a
stage-(c)/(d) trainable tree ({"switch"?, "lora"?}) across, so both
packages can start a step from the same numbers; `trainable_to_numpy` brings a port tree back as numpy.

The reverse converters (convert.py:353-417) write a trained tree in the
reference's PyTorch formats, as train-lora's --export-reference-format
does: `switch_projector_to_torch` (the `switch_projector.{i}` Sequential),
`lora_to_peft` (PEFT keys in the family's HF layout, (out, in)) and
`save_torch_state_dict`.

The checkpoint readers (port of convert.py:59-350, 419-561) turn the
reference's PyTorch checkpoints into the port's trees: `esm2_from_hf`,
`esm2_from_fair_esm`, `filter_prefix`, `decoder_from_hf` (llama, qwen2,
OPT; `quantize_int8` quantizes each projection on the host as
`quant.quantize_linear` does), `bert_from_hf`, `cstp_from_lightning`,
`switch_projector_from_torch`, `lora_from_peft` and
`merge_lora_into_decoder`; the file loaders `load_torch_file` and
`load_hf_dir`; the bitsandbytes 4-bit dequantizers (`NF4_CODE`,
`dequantize_nf4`, `dequantize_blockwise_8bit`, `dequantize_bnb_4bit`,
`has_bnb_4bit`, `dequantize_bnb_state_dict`: numpy, copied). A state dict
may hold torch tensors or numpy arrays. Torch Linear weights (out, in)
become (in, out) kernels. Every reader builds CPU tensors; the caller
moves the finished tree to the device once (core.builder). The JAX
package's `host_arrays` (an XLA staging switch) has no counterpart.

`.safetensors` files are read by `load_safetensors`, this module's own
reader of the format (an 8-byte little-endian header length, the JSON
header, then the raw little-endian tensor bytes), over a copy-on-write
mmap with `torch.frombuffer`: BF16, F16, F32, I8, U8, I32 and I64. The
`safetensors` package is not used.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .util import resolve_device, to_device, to_tensor


def _unstack(tree: dict) -> dict:
    if "layers_stacked" not in tree:
        return tree
    stacked = tree["layers_stacked"]

    def take(t, i):
        return {k: take(v, i) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]

    def n_layers(t):
        return n_layers(next(iter(t.values()))) if isinstance(t, dict) \
            else t.shape[0]

    out = {k: v for k, v in tree.items() if k != "layers_stacked"}
    out["layers"] = [take(stacked, i) for i in range(n_layers(stacked))]
    return out


def _refuse_quantized(tree, where: str, *, decoder: bool = False) -> None:
    """Raise ValueError on quantized leaves the port has no kernel for; in
    a decoder tree, int8 "kernel_q" and int32 (v2) or int8 (v1)
    "kernel_p" leaves pass."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            dt = np.asarray(v).dtype if k in ("kernel_q", "kernel_p") \
                else None
            ok = decoder and ((k == "kernel_q" and dt == np.int8)
                              or (k == "kernel_p"
                                  and dt in (np.int32, np.int8)))
            if dt is not None and not ok:
                raise ValueError(
                    f"quantized weights ({where}.{k}, dtype "
                    f"{np.asarray(v).dtype}): the port runs int8 and int4 "
                    "projections of the decoder only")
            _refuse_quantized(v, f"{where}.{k}", decoder=decoder)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _refuse_quantized(v, f"{where}[{i}]", decoder=decoder)


def _esm_layer(lp: dict) -> dict:
    if "qkv_fused" in lp:
        w, b = lp["qkv_fused"]["kernel"], lp["qkv_fused"]["bias"]
    elif "qkv_proj" in lp:
        k = lp["qkv_proj"]["kernel"]                       # (E, 3E)
        e = k.shape[0]
        w = k.reshape(e, 3, e).permute(1, 0, 2).contiguous()
        b = lp["qkv_proj"]["bias"].reshape(3, e)
    else:
        w = torch.stack([lp[n]["kernel"] for n in
                         ("q_proj", "k_proj", "v_proj")])
        b = torch.stack([lp[n]["bias"] for n in
                         ("q_proj", "k_proj", "v_proj")])
    keep = ("attn_norm", "o_proj", "ffn_norm", "fc1", "fc2")
    return {"qkv": {"kernel": w, "bias": b}, **{k: lp[k] for k in keep}}


def esm2_from_jax(tree: dict, device=None) -> dict:
    _refuse_quantized(tree, "esm")
    t = _unstack(to_device(tree, device))
    return {"embed_tokens": t["embed_tokens"], "final_norm": t["final_norm"],
            "layers": [_esm_layer(lp) for lp in t["layers"]]}


def decoder_from_jax(tree: dict, device=None) -> dict:
    _refuse_quantized(tree, "llm", decoder=True)
    return _unstack(to_device(tree, device))


def from_jax(tree: dict, device=None) -> dict:
    """JAX Opus parameter tree {"esm", "cstp"?, "switch", "llm"} with numpy
    leaves -> the port's parameters on `device` (None: CUDA)."""
    device = resolve_device(device)
    out = {"esm": esm2_from_jax(tree["esm"], device),
           "switch": to_device(tree["switch"], device),
           "llm": decoder_from_jax(tree["llm"], device)}
    if "cstp" in tree:
        out["cstp"] = cstp_from_jax(tree["cstp"], device)
    return out


def bert_from_jax(tree: dict, device=None) -> dict:
    """The JAX BERT tree (models/bert.py `init`: word / position /
    token-type embeddings, `embed_norm`, a `layers` list of q/k/v/o
    projections, two norms, fc1 and fc2) with numpy leaves -> the port's
    `models.bert` parameters: the same layout and dtypes (no kernel is
    transposed), on `device` (None: CUDA)."""
    _refuse_quantized(tree, "bert")
    return to_device(tree, device)


def cstp_from_jax(tree: dict, device=None) -> dict:
    """The JAX CSTP tree ({"protein_projection", "text_projection"}, fp32;
    a JAX `CSTPTrainState.params`) with numpy leaves -> the port's, on
    `device` (None: CUDA)."""
    return to_device(tree, device)


def lora_from_jax(tree: dict, device=None) -> dict:
    """JAX LoRA tree with numpy leaves -> the port's, same dtypes."""
    return {"layers": to_device(tree["layers"], device)}


def trainable_from_jax(tree: dict, device=None) -> dict:
    """JAX trainable tree {"switch"?, "lora"?} (numpy leaves) -> the
    port's, on `device` (None: CUDA)."""
    device = resolve_device(device)
    out = {}
    if "switch" in tree:
        out["switch"] = to_device(tree["switch"], device)
    if "lora" in tree:
        out["lora"] = lora_from_jax(tree["lora"], device)
    return out


def trainable_to_numpy(tree):
    """A port tree of tensors -> the same structure of numpy arrays (fp32
    and wider dtypes as they are; bf16 as fp32)."""
    if isinstance(tree, dict):
        return {k: trainable_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [trainable_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _np32(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def switch_projector_to_torch(params) -> Dict[str, np.ndarray]:
    """Switch-projector tree -> the reference's
    `switch_projector.{i}.weight/bias` layout (nn.Sequential indices with
    GELU at odd slots, opus_arch.py:85-89), fp32, weights (out, in)."""
    sd: Dict[str, np.ndarray] = {}
    for i, lp in enumerate(params["layers"]):
        slot = 2 * i   # Linear, GELU, Linear, GELU, ...
        sd[f"switch_projector.{slot}.weight"] = _np32(lp["kernel"]).T
        if "bias" in lp:
            sd[f"switch_projector.{slot}.bias"] = _np32(lp["bias"])
    return sd


_PEFT_PROJ_MAP_INV = {"o_proj": "out_proj"}


def lora_to_peft(lora_tree, *, family: str = "llama") -> Dict[str, np.ndarray]:
    """LoRA tree {"layers": [{proj: {"A", "B"}}]} -> PEFT state-dict keys in
    the target family's HF layout, fp32, torch (out, in) orientation.

    llama/qwen2: `base_model.model.model.layers.{i}.self_attn.{p}` /
                 `...mlp.{p}`
    opt:         `base_model.model.model.decoder.layers.{i}.self_attn.{p}`
                 (out_proj) / `...layers.{i}.fc{1,2}` (no mlp wrapper)
    """
    def path_of(i: int, proj: str) -> str:
        if family == "opt":
            name = _PEFT_PROJ_MAP_INV.get(proj, proj)
            stem = f"base_model.model.model.decoder.layers.{i}"
            if proj in ("fc1", "fc2"):
                return f"{stem}.{name}"
            return f"{stem}.self_attn.{name}"
        where = "self_attn" if proj in ("q_proj", "k_proj", "v_proj",
                                        "o_proj") else "mlp"
        return f"base_model.model.model.layers.{i}.{where}.{proj}"

    sd: Dict[str, np.ndarray] = {}
    for i, lp in enumerate(lora_tree["layers"]):
        for proj, ab in lp.items():
            base = path_of(i, proj)
            # ascontiguousarray, not a .T view: safetensors save_file
            # writes the raw buffer and silently corrupts non-contiguous
            # arrays (observed — layer-1 MLP adapters came back permuted)
            sd[f"{base}.lora_A.weight"] = np.ascontiguousarray(
                _np32(ab["A"]).T)
            sd[f"{base}.lora_B.weight"] = np.ascontiguousarray(
                _np32(ab["B"]).T)
    return sd


def save_torch_state_dict(sd: Dict[str, np.ndarray], path: str) -> None:
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               path)


# ---------------------------------------------------------------------------
# Checkpoint readers: the reference's PyTorch formats -> the port's trees
# (convert.py:59-350). Every reader builds CPU tensors.
# ---------------------------------------------------------------------------

def _torch(x) -> torch.Tensor:
    """A state-dict entry (torch tensor or numpy array) as a CPU tensor."""
    return x.detach().cpu() if isinstance(x, torch.Tensor) else to_tensor(x)


def _cast(x, dtype) -> torch.Tensor:
    """x in `dtype`, rounded once from its fp32 value (the JAX readers'
    fp32 numpy -> jnp.asarray(dtype) chain)."""
    t = _torch(x)
    if t.dtype not in (torch.float32, dtype):
        t = t.float()
    return t.to(dtype)


def _linear(sd, prefix: str, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A torch Linear (out, in) -> {"kernel": (in, out), "bias"?}."""
    p = {"kernel": _cast(sd[prefix + ".weight"], dtype).t().contiguous()}
    if prefix + ".bias" in sd:
        p["bias"] = _cast(sd[prefix + ".bias"], dtype)
    return p


def _linear_int8(sd, prefix: str, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Quantize-on-load (convert.py:66-79): the fp32 (in, out) kernel to
    int8 with per-column fp32 scales, the same bytes as
    `quant.quantize_linear` of the fp32 kernel; the bias in `dtype`."""
    from ..kernels.quant import quantize_per_channel
    q, s = quantize_per_channel(_cast(sd[prefix + ".weight"],
                                      torch.float32).t(), axis=0)
    p = {"kernel_q": q.contiguous(), "scale": s}
    if prefix + ".bias" in sd:
        p["bias"] = _cast(sd[prefix + ".bias"], dtype)
    return p


def _norm(sd, prefix: str, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    p = {"scale": _cast(sd[prefix + ".weight"], dtype)}
    if prefix + ".bias" in sd:
        p["bias"] = _cast(sd[prefix + ".bias"], dtype)
    return p


def _embedding(sd, key: str, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return {"embedding": _cast(sd[key], dtype)}


def _esm_tree(sd, cfg, dtype, embed_key, final_norm, layer_keys) -> dict:
    """ESM2 tree from one state-dict dialect; `layer_keys` maps the JAX
    layer names to the dialect's module names under `layer_keys["pre"]`."""
    layers = []
    for i in range(cfg.num_layers):
        lp = layer_keys["pre"].format(i)
        layers.append(_esm_layer({
            name: (_norm if name.endswith("norm") else _linear)(
                sd, lp + mod, dtype)
            for name, mod in layer_keys.items() if name != "pre"}))
    return {"embed_tokens": _embedding(sd, embed_key, dtype),
            "final_norm": _norm(sd, final_norm, dtype), "layers": layers}


def esm2_from_hf(sd, cfg, dtype=torch.float32) -> dict:
    """A HF `EsmModel` state dict (facebook/esm2_* ports) -> the port's
    ESM2 tree (q/k/v packed, esm2.py's layout)."""
    pre = "esm." if any(k.startswith("esm.") for k in sd) else ""
    return _esm_tree(sd, cfg, dtype, pre + "embeddings.word_embeddings.weight",
                     pre + "encoder.emb_layer_norm_after", {
                         "pre": pre + "encoder.layer.{}.",
                         "attn_norm": "attention.LayerNorm",
                         "q_proj": "attention.self.query",
                         "k_proj": "attention.self.key",
                         "v_proj": "attention.self.value",
                         "o_proj": "attention.output.dense",
                         "ffn_norm": "LayerNorm",
                         "fc1": "intermediate.dense",
                         "fc2": "output.dense"})


def esm2_from_fair_esm(sd, cfg, dtype=torch.float32) -> dict:
    """A fair-esm ESM2 state dict (`layers.0.self_attn.q_proj`...; the
    dialect inside the CSTP Lightning checkpoint under
    `protein_model.model.*`, stripped with `filter_prefix`)."""
    return _esm_tree(sd, cfg, dtype, "embed_tokens.weight",
                     "emb_layer_norm_after", {
                         "pre": "layers.{}.",
                         "attn_norm": "self_attn_layer_norm",
                         "q_proj": "self_attn.q_proj",
                         "k_proj": "self_attn.k_proj",
                         "v_proj": "self_attn.v_proj",
                         "o_proj": "self_attn.out_proj",
                         "ffn_norm": "final_layer_norm",
                         "fc1": "fc1", "fc2": "fc2"})


def filter_prefix(sd, prefix: str) -> Dict[str, Any]:
    """The entries under `prefix`, prefix stripped (opus_arch.py:85-89)."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def decoder_from_hf(sd, cfg, dtype=None, *, quantize_int8: bool = False):
    """A HF Llama / Qwen2 / OPT / DeepSeek-V2 state dict -> the port's
    decoder tree in `dtype` (None: the config's). A bitsandbytes 4-bit
    checkpoint is dequantized first. quantize_int8: every projection and
    the head as int8 + per-column scales (`_linear_int8`; refused for
    deepseek_v2)."""
    dtype = dtype or cfg.torch_dtype
    if has_bnb_4bit(sd):
        sd = dequantize_bnb_state_dict(sd)
    lin = _linear_int8 if quantize_int8 else _linear
    if cfg.family in ("llama", "qwen2"):
        return _llama_like_from_hf(sd, cfg, dtype, lin)
    if cfg.family == "opt":
        return _opt_from_hf(sd, cfg, dtype, lin)
    if cfg.family == "deepseek_v2":
        if quantize_int8:
            raise ValueError("quantized weights are not supported for the "
                             "deepseek_v2 family")
        return _deepseek_from_hf(sd, cfg, dtype)
    raise ValueError(cfg.family)


def _llama_like_from_hf(sd, cfg, dtype, lin):
    pre = "model." if any(k.startswith("model.") for k in sd) else ""
    scale = lambda key: {"scale": _cast(sd[key], dtype)}
    params = {"embed_tokens": _embedding(sd, pre + "embed_tokens.weight",
                                         dtype),
              "final_norm": scale(pre + "norm.weight"), "layers": []}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = lin(sd, "lm_head", dtype)
    for i in range(cfg.num_layers):
        lp = f"{pre}layers.{i}."
        layer = {"attn_norm": scale(lp + "input_layernorm.weight")}
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            layer[name] = lin(sd, lp + "self_attn." + name, dtype)
        layer["ffn_norm"] = scale(lp + "post_attention_layernorm.weight")
        for name in ("gate_proj", "up_proj", "down_proj"):
            layer[name] = lin(sd, lp + "mlp." + name, dtype)
        params["layers"].append(layer)
    return params


def _deepseek_from_hf(sd, cfg, dtype):
    """DeepSeek-V2 (modeling_deepseek.py names): per layer
    self_attn.{q_proj, kv_a_proj_with_mqa, kv_a_layernorm, kv_b_proj,
    o_proj}, then mlp.{gate,up,down}_proj (the first
    `first_k_dense_replace` layers) or mlp.gate (the router, (E, H)),
    mlp.experts.{j}.{gate,up,down}_proj stacked into (E, in, out) and
    mlp.shared_experts.*; each Linear's (out, in) weight transposed."""
    pre = "model." if any(k.startswith("model.") for k in sd) else ""
    scale = lambda key: {"scale": _cast(sd[key], dtype)}
    params = {"embed_tokens": _embedding(sd, pre + "embed_tokens.weight",
                                         dtype),
              "final_norm": scale(pre + "norm.weight"), "layers": []}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _linear(sd, "lm_head", dtype)
    swiglu = lambda mp: {n: _linear(sd, mp + n, dtype)
                         for n in ("gate_proj", "up_proj", "down_proj")}
    for i in range(cfg.num_layers):
        lp, at, mp = (f"{pre}layers.{i}.", f"{pre}layers.{i}.self_attn.",
                      f"{pre}layers.{i}.mlp.")
        layer = {"attn_norm": scale(lp + "input_layernorm.weight"),
                 "q_proj": _linear(sd, at + "q_proj", dtype),
                 "kv_a_proj": _linear(sd, at + "kv_a_proj_with_mqa", dtype),
                 "kv_a_norm": scale(at + "kv_a_layernorm.weight"),
                 "kv_b_proj": _linear(sd, at + "kv_b_proj", dtype),
                 "o_proj": _linear(sd, at + "o_proj", dtype),
                 "ffn_norm": scale(lp + "post_attention_layernorm.weight")}
        if i < cfg.first_k_dense_replace:
            layer.update(swiglu(mp))
        else:
            layer["router"] = _linear(sd, mp + "gate", dtype)
            layer["experts"] = {n: {"kernel": torch.stack([
                _cast(sd[f"{mp}experts.{j}.{n}.weight"], dtype).t()
                for j in range(cfg.n_routed_experts)]).contiguous()}
                for n in ("gate_proj", "up_proj", "down_proj")}
            layer["shared"] = swiglu(mp + "shared_experts.")
        params["layers"].append(layer)
    return params


def _opt_from_hf(sd, cfg, dtype, lin):
    pre = next((c for c in ("model.decoder.", "decoder.")
                if any(k.startswith(c) for k in sd)), "")
    params = {"embed_tokens": _embedding(sd, pre + "embed_tokens.weight",
                                         dtype),
              "embed_positions": _embedding(
                  sd, pre + "embed_positions.weight", dtype),
              "final_norm": _norm(sd, pre + "final_layer_norm", dtype),
              "layers": []}
    if "lm_head.weight" in sd and not cfg.tie_word_embeddings:
        params["lm_head"] = lin(sd, "lm_head", dtype)
    for i in range(cfg.num_layers):
        lp = f"{pre}layers.{i}."
        params["layers"].append({
            "attn_norm": _norm(sd, lp + "self_attn_layer_norm", dtype),
            "q_proj": lin(sd, lp + "self_attn.q_proj", dtype),
            "k_proj": lin(sd, lp + "self_attn.k_proj", dtype),
            "v_proj": lin(sd, lp + "self_attn.v_proj", dtype),
            "o_proj": lin(sd, lp + "self_attn.out_proj", dtype),
            "ffn_norm": _norm(sd, lp + "final_layer_norm", dtype),
            "fc1": lin(sd, lp + "fc1", dtype),
            "fc2": lin(sd, lp + "fc2", dtype)})
    return params


def bert_from_hf(sd, cfg, dtype=torch.float32) -> dict:
    """A HF BERT state dict (BioBERT, for BERTScore) -> models.bert's
    tree."""
    pre = "bert." if any(k.startswith("bert.") for k in sd) else ""
    emb = pre + "embeddings."
    params = {
        "word_embeddings": _embedding(sd, emb + "word_embeddings.weight",
                                      dtype),
        "position_embeddings": _embedding(
            sd, emb + "position_embeddings.weight", dtype),
        "token_type_embeddings": _embedding(
            sd, emb + "token_type_embeddings.weight", dtype),
        "embed_norm": _norm(sd, emb + "LayerNorm", dtype),
        "layers": []}
    for i in range(cfg.num_layers):
        lp = f"{pre}encoder.layer.{i}."
        params["layers"].append({
            "q_proj": _linear(sd, lp + "attention.self.query", dtype),
            "k_proj": _linear(sd, lp + "attention.self.key", dtype),
            "v_proj": _linear(sd, lp + "attention.self.value", dtype),
            "o_proj": _linear(sd, lp + "attention.output.dense", dtype),
            "attn_norm": _norm(sd, lp + "attention.output.LayerNorm", dtype),
            "fc1": _linear(sd, lp + "intermediate.dense", dtype),
            "fc2": _linear(sd, lp + "output.dense", dtype),
            "ffn_norm": _norm(sd, lp + "output.LayerNorm", dtype)})
    return params


def cstp_from_lightning(ckpt_or_sd, cfg=None, dtype=torch.float32) -> dict:
    """A CSTP Lightning checkpoint (or its state dict) -> the two
    projection linears (cstp_v3/modelling.py:370-371)."""
    sd = (ckpt_or_sd.get("state_dict", ckpt_or_sd)
          if isinstance(ckpt_or_sd, dict) else ckpt_or_sd)
    return {"protein_projection": _linear(sd, "protein_projection.linear",
                                          dtype),
            "text_projection": _linear(sd, "text_projection.linear", dtype)}


def switch_projector_from_torch(sd, cfg=None, dtype=torch.float32) -> dict:
    """Switch-projector weights saved as `switch_projector.{i}.weight`
    (nn.Sequential indices, opus_arch.py:85-89), or already stripped
    `{i}.weight`, or one bare nn.Linear."""
    sd = {k.replace("switch_projector.", ""): v for k, v in sd.items()}
    ids = sorted({int(k.split(".")[0]) for k in sd if k[0].isdigit()})
    layers = [_linear(sd, str(i), dtype) for i in ids]
    if not layers:
        if "weight" not in sd:
            raise ValueError("no switch projector weights found")
        p = {"kernel": _cast(sd["weight"], dtype).t().contiguous()}
        if "bias" in sd:
            p["bias"] = _cast(sd["bias"], dtype)
        layers = [p]
    return {"layers": layers}


_PEFT_PROJ_MAP = {"out_proj": "o_proj"}


def lora_from_peft(sd, dtype=torch.float32) -> Dict[Any, Dict[str, torch.Tensor]]:
    """A PEFT LoRA state dict (llama / qwen2 `...layers.{i}.self_attn.
    q_proj.lora_A.weight`, OPT `...decoder.layers.{i}.self_attn.out_proj`,
    `...layers.{i}.fc1`) -> {(layer, proj): {"A": (in, r), "B": (r,
    out)}}."""
    out: Dict[Any, Dict[str, torch.Tensor]] = {}
    for k, v in sd.items():
        if ".lora_A." not in k and ".lora_B." not in k:
            continue
        which = "A" if ".lora_A." in k else "B"
        parts = k.split(".")
        li = int(parts[parts.index("layers") + 1])
        proj = parts[parts.index(f"lora_{which}") - 1]
        proj = _PEFT_PROJ_MAP.get(proj, proj)
        out.setdefault((li, proj), {})[which] = \
            _cast(v, dtype).t().contiguous()
    return out


def merge_lora_into_decoder(params, lora_tree, scaling: float):
    """W += scaling * A @ B in fp32, rounded once to W's dtype (PEFT
    merge_and_unload, builder.py:107-109). Returns a new tree; the input
    tree's tensors are not changed."""
    out = dict(params)
    out["layers"] = [dict(lp) for lp in params["layers"]]
    for (li, proj), ab in lora_tree.items():
        base = out["layers"][li][proj]
        w = base["kernel"]
        delta = (ab["A"].float() @ ab["B"].float()) * scaling
        out["layers"][li][proj] = {**base, "kernel": (
            w.float() + delta.to(w.device)).to(w.dtype)}
    return out


# ---------------------------------------------------------------------------
# Checkpoint files (torch / safetensors), used by core.builder and the CLI
# ---------------------------------------------------------------------------

_SAFETENSORS_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
                       "F32": torch.float32, "I8": torch.int8,
                       "U8": torch.uint8, "I32": torch.int32,
                       "I64": torch.int64}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one `.safetensors` file as a CPU tensor over a
    copy-on-write mmap of the file (nothing is read until it is used, and
    nothing is written back). Raises ValueError on a dtype outside
    BF16 / F16 / F32 / I8 / U8 / I32 / I64 or a malformed header."""
    import json
    import mmap
    import struct
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}, which this reader does not "
                             f"take ({sorted(_SAFETENSORS_DTYPES)})")
        lo, hi = info["data_offsets"]
        shape = tuple(info["shape"])
        size = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        if hi - lo != size or base + hi > len(buf):
            raise ValueError(f"{path}: tensor {name} has offsets {lo}..{hi} "
                             f"for {size} bytes of {shape}")
        t = (torch.frombuffer(buf, dtype=torch.uint8, count=size,
                              offset=base + lo) if size else
             torch.empty((0,), dtype=torch.uint8))
        out[name] = t.view(dt).reshape(shape)
    return out


def load_torch_file(path: str) -> Dict[str, Any]:
    """A torch checkpoint (a Lightning ckpt's `state_dict` unwrapped)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


def load_hf_dir(path: str) -> Dict[str, Any]:
    """Every weight of a HF model directory: its `.safetensors` shards
    when it has any, else its `.bin` files."""
    files = sorted(os.listdir(path))
    st = [f for f in files if f.endswith(".safetensors")]
    sd: Dict[str, Any] = {}
    for f in st or [f for f in files if f.endswith(".bin")]:
        full = os.path.join(path, f)
        sd.update(load_safetensors(full) if st else
                  torch.load(full, map_location="cpu", weights_only=True))
    return sd


# ---------------------------------------------------------------------------
# bitsandbytes 4-bit (NF4 / FP4, double quant) dequantize-on-load
# (convert.py:449-561, numpy)
# ---------------------------------------------------------------------------

# The 16 NF4 code values (normalized-float4 quantiles), as bitsandbytes
# defines them; the reference loads its LLMs 4-bit NF4 with double quant
# (builder.py:50-55).
NF4_CODE = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
], dtype=np.float32)


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().to("cpu").float().numpy()


def dequantize_nf4(packed, absmax, blocksize: int, shape,
                   code: Optional[np.ndarray] = None) -> np.ndarray:
    """bitsandbytes 4-bit data (packed uint8, high nibble first), per-block
    absmax scales and the 16-entry `code` table (NF4 by default) -> fp32
    of `shape`."""
    code = NF4_CODE if code is None else np.asarray(code, np.float32)
    packed = np.asarray(packed, np.uint8).reshape(-1)
    flat = np.empty(packed.size * 2, dtype=np.float32)
    flat[0::2] = code[(packed >> 4) & 0xF]
    flat[1::2] = code[packed & 0xF]
    n = int(np.prod(shape))
    flat = flat[:n]
    nblocks = (n + blocksize - 1) // blocksize
    scales = np.repeat(
        np.asarray(absmax, np.float32).reshape(-1)[:nblocks], blocksize)[:n]
    return (flat * scales).reshape(shape)


def dequantize_blockwise_8bit(q, absmax, code, blocksize: int) -> np.ndarray:
    """bitsandbytes blockwise 8-bit: code[q] * absmax[block] (the nested
    level of double quantization, which stores the 4-bit data's absmax)."""
    q = np.asarray(q, np.uint8).reshape(-1)
    vals = np.asarray(code, np.float32)[q]
    scales = np.repeat(np.asarray(absmax, np.float32).reshape(-1),
                       blocksize)[:q.size]
    return vals * scales


def _bnb_meta(sd, wkey: str) -> Optional[dict]:
    """The JSON of `{wkey}.quant_state.bitsandbytes__{nf4,fp4}` (the
    serialization transformers writes for 4-bit-saved models)."""
    import json
    for qt in ("nf4", "fp4"):
        k = f"{wkey}.quant_state.bitsandbytes__{qt}"
        if k in sd:
            raw = bytes(np.asarray(_np(sd[k]), np.uint8).tolist())
            meta = json.loads(raw.decode("utf-8"))
            meta["quant_type"] = qt
            return meta
    return None


def dequantize_bnb_4bit(sd, wkey: str) -> np.ndarray:
    """The fp32 weight `wkey` of a bitsandbytes 4-bit state dict, double
    quant included:
        absmax = nested_quant_map[absmax_q8] * repeat(nested_absmax)
                 + nested_offset                 (with double quant)
        w      = quant_map[nibble] * repeat(absmax)."""
    meta = _bnb_meta(sd, wkey)
    if meta is None:
        raise ValueError(f"no bitsandbytes quant_state for {wkey}")
    blocksize = int(meta.get("blocksize", 64))
    code = (_np(sd[f"{wkey}.quant_map"]) if f"{wkey}.quant_map" in sd
            else NF4_CODE)
    absmax = _np(sd[f"{wkey}.absmax"])
    if f"{wkey}.nested_absmax" in sd:
        absmax = dequantize_blockwise_8bit(
            absmax, _np(sd[f"{wkey}.nested_absmax"]),
            _np(sd[f"{wkey}.nested_quant_map"]),
            int(meta.get("nested_blocksize", 256)))
        absmax = absmax + np.float32(meta.get("nested_offset", 0.0))
    return dequantize_nf4(_np(sd[wkey]), absmax, blocksize, meta["shape"],
                          code)


_BNB_AUX_SUFFIXES = (".absmax", ".quant_map", ".nested_absmax",
                     ".nested_quant_map", ".quant_state.bitsandbytes__nf4",
                     ".quant_state.bitsandbytes__fp4")


def has_bnb_4bit(sd) -> bool:
    return any(".quant_state.bitsandbytes__" in k for k in sd)


def dequantize_bnb_state_dict(sd) -> Dict[str, Any]:
    """`sd` with every bitsandbytes 4-bit weight replaced by its fp32
    reconstruction and the auxiliary entries dropped, so the readers
    above apply."""
    quantized = {k[:k.index(".quant_state.bitsandbytes__")]
                 for k in sd if ".quant_state.bitsandbytes__" in k}
    out = {k: v for k, v in sd.items()
           if not any(k == q or (k.startswith(q)
                                 and k[len(q):] in _BNB_AUX_SUFFIXES)
                      for q in quantized)}
    for q in quantized:
        out[q] = dequantize_bnb_4bit(sd, q)
    return out
