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
Any quantized ESM2 leaf and fused decoder projections are not ported yet
and raise NotImplementedError. `device=None` puts the parameters on CUDA
(core.util.resolve_device).

`bert_from_jax` carries the JAX BERTScore encoder's tree across as it
is. `lora_from_jax` and `trainable_from_jax` carry a JAX LoRA tree
({"layers": [{proj: {"A", "B"}}]}) and a stage-(c)/(d) trainable tree
({"switch"?, "lora"?}) across, so both packages can start a step from the
same numbers; `trainable_to_numpy` brings a port tree back as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .util import resolve_device


def to_tensor(a, device=None) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) -> torch tensor, same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device) if device is not None else t


def _tree(x, device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, device) for v in x]
    return to_tensor(x, device)


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
    """Raise on quantized leaves the port cannot run; in a decoder tree,
    int8 "kernel_q" and int32 (v2) or int8 (v1) "kernel_p" leaves pass."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            dt = np.asarray(v).dtype if k in ("kernel_q", "kernel_p") \
                else None
            ok = decoder and ((k == "kernel_q" and dt == np.int8)
                              or (k == "kernel_p"
                                  and dt in (np.int32, np.int8)))
            if dt is not None and not ok:
                raise NotImplementedError(
                    f"quantized weights ({where}.{k}, dtype "
                    f"{np.asarray(v).dtype}) are not ported yet")
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
    t = _unstack(_tree(tree, resolve_device(device)))
    return {"embed_tokens": t["embed_tokens"], "final_norm": t["final_norm"],
            "layers": [_esm_layer(lp) for lp in t["layers"]]}


def decoder_from_jax(tree: dict, device=None) -> dict:
    _refuse_quantized(tree, "llm", decoder=True)
    t = _unstack(_tree(tree, resolve_device(device)))
    for lp in t["layers"]:
        if "qkv_proj" in lp or "gateup_proj" in lp:
            raise NotImplementedError(
                "fused decoder projections (decoder.fuse_projections) are "
                "not ported yet; convert the unfused tree")
    return t


def from_jax(tree: dict, device=None) -> dict:
    """JAX Opus parameter tree {"esm", "cstp"?, "switch", "llm"} with numpy
    leaves -> the port's parameters on `device` (None: CUDA)."""
    device = resolve_device(device)
    out = {"esm": esm2_from_jax(tree["esm"], device),
           "switch": _tree(tree["switch"], device),
           "llm": decoder_from_jax(tree["llm"], device)}
    if "cstp" in tree:
        out["cstp"] = _tree(tree["cstp"], device)
    return out


def bert_from_jax(tree: dict, device=None) -> dict:
    """The JAX BERT tree (models/bert.py `init`: word / position /
    token-type embeddings, `embed_norm`, a `layers` list of q/k/v/o
    projections, two norms, fc1 and fc2) with numpy leaves -> the port's
    `models.bert` parameters: the same layout and dtypes (no kernel is
    transposed), on `device` (None: CUDA)."""
    _refuse_quantized(tree, "bert")
    return _tree(tree, resolve_device(device))


def lora_from_jax(tree: dict, device=None) -> dict:
    """JAX LoRA tree with numpy leaves -> the port's, same dtypes."""
    return {"layers": _tree(tree["layers"], resolve_device(device))}


def trainable_from_jax(tree: dict, device=None) -> dict:
    """JAX trainable tree {"switch"?, "lora"?} (numpy leaves) -> the
    port's, on `device` (None: CUDA)."""
    device = resolve_device(device)
    out = {}
    if "switch" in tree:
        out["switch"] = _tree(tree["switch"], device)
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
