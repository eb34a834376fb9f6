"""Partition rules and tensor-parallel slicing (port of
`opus_pllm_tpu/parallel/partition.py`: `_COL` / `_ROW` :33-36, `_rule`
:49, `_sanitize` :101, `specs` :123, `shard_params` :150).

`specs(params, mesh)` returns, leaf for leaf, the PartitionSpecs of the
JAX rules as tuples of axis names or None (the JAX package hands them to
XLA, which inserts the collectives). The port runs tensor parallelism by
hand, Megatron style, so `shard_params` cuts each rank's share of the
decoder by projection ROLE rather than by spec:

  column-parallel (q/k/v, gate/up, fc1, the vocabulary head): the output
      columns of kernel / kernel_q / kernel_p / gscale, and scale / bias;
  row-parallel (o_proj, down_proj, fc2): the input rows of kernel /
      kernel_q / kernel_p / gscale; scale and bias stay whole (the bias is
      added once, after the all-reduce).

A rank holds Hq/M query heads and Hkv/M KV heads, F/M of the MLP and V/M
of the vocabulary; the decoder all-reduces after each row-parallel
product and all-gathers the head's logits (`TensorParallel`). A group
whose widths do not split (heads not divisible by M, an int4 row block
that a shard would cut) runs whole on every rank, as `_sanitize`
replicates a dimension in JAX. The "data" half of each spec (FSDP) leaves
the parameter replicated here. The protein encoder, CSTP and switch run
whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..core import mesh as mesh_mod
from ..core.mesh import DATA_AXIS, MODEL_AXIS

# kernels whose OUTPUT dim is TP-sharded (column-parallel)
_COL = {"q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "fc1",
        "query", "key", "value", "lm_head", "qkv_proj", "gateup_proj"}
# kernels whose INPUT dim is TP-sharded (row-parallel)
_ROW = {"o_proj", "down_proj", "fc2", "out_proj"}

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj", "fc1", "fc2")


# ---------------------------------------------------------------------------
# the JAX rules, as tuples
# ---------------------------------------------------------------------------

def _rule(names, leaf) -> tuple:
    last = names[-1] if names else ""
    parent = next((n for n in reversed(names[:-1]) if isinstance(n, str)),
                  "")
    stacked = "layers_stacked" in names

    def spec(*axes) -> tuple:
        return (None, *axes) if stacked else tuple(axes)

    if last == "embedding":
        return (None, DATA_AXIS) if leaf.ndim == 2 else ()
    if last == "kernel":
        if parent in _ROW:
            return spec(MODEL_AXIS, DATA_AXIS)
        return spec(DATA_AXIS, MODEL_AXIS)
    if last in ("kernel_q", "kernel_p"):
        if parent in _ROW:
            return spec(MODEL_AXIS, DATA_AXIS)
        return spec(DATA_AXIS, MODEL_AXIS)
    if last == "gscale":
        if parent in _ROW:
            return spec(MODEL_AXIS, DATA_AXIS)
        return spec(None, MODEL_AXIS)
    if last == "bias":
        return spec(MODEL_AXIS) if parent in _COL else spec()
    if last == "scale" and parent in (_COL | _ROW):
        return spec(MODEL_AXIS) if parent in _COL else spec(DATA_AXIS)
    if last == "scale":
        return spec()
    if last == "A":
        return spec(DATA_AXIS, None)
    if last == "B":
        return spec(None, MODEL_AXIS)
    return spec()


def _axis_sizes(mesh) -> Dict[str, int]:
    """{axis: size} of a Mesh (its `shape`) or a MeshConfig."""
    if hasattr(mesh, "shape"):
        return dict(mesh.shape)
    return {DATA_AXIS: mesh.data, MODEL_AXIS: mesh.model}


def _sanitize(spec: tuple, leaf, sizes: Dict[str, int]) -> tuple:
    """Drop any sharded dim the mesh cannot split evenly (None: that dim
    replicated)."""
    if len(spec) > leaf.ndim:
        return spec
    out = []
    for dim, ax in enumerate(spec):
        if ax is None:
            out.append(None)
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        size = 1
        for n in names:
            size *= sizes.get(n, 1)
        out.append(ax if leaf.shape[dim] % size == 0 else None)
    return tuple(out)


def _map_with_names(fn, tree, names=()):
    if isinstance(tree, dict):
        return {k: _map_with_names(fn, v, names + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_names(fn, v, names + (i,))
                          for i, v in enumerate(tree))
    return fn(list(names), tree)


def specs(params, mesh=None) -> Any:
    """The spec tree of `params` (tuples of axis names / None). With
    `mesh` (a Mesh or a MeshConfig) a dim the axis size does not divide
    falls back to None, as in JAX."""
    if mesh is None:
        return _map_with_names(_rule, params)
    sizes = _axis_sizes(mesh)
    return _map_with_names(
        lambda n, x: _sanitize(_rule(n, x), x, sizes), params)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TensorParallel:
    """This rank's share of a decoder over the mesh's model axis: `size`
    ranks in `group`, this one at `index`; `attn` / `mlp` / `head` say
    which groups of projections are split (the others run whole)."""
    group: Any
    size: int
    index: int
    attn: bool
    mlp: bool
    head: bool

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return mesh_mod.all_reduce(t, self.group)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' slices concatenated along the last dim."""
        return mesh_mod.all_gather_cat(t, self.group, dim=-1)


def _row_block(p: Dict) -> int:
    """The K rows an int4 leaf packs together: 512 (v2 words), 256 (v1
    bytes); 1 for everything else."""
    kp = p.get("kernel_p")
    if kp is None:
        return 1
    return 512 if kp.dtype == torch.int32 else 256


def plan(cfg, mesh, layer: Optional[Dict] = None,
         params: Optional[Dict] = None) -> Optional[TensorParallel]:
    """The TensorParallel of decoder `cfg` over `mesh`'s model axis (None
    at M = 1). `layer` (a layer's projections as they will be sliced)
    adds the int4 rule: a row-parallel K must split into whole packing
    blocks. `params` tells whether the head is a separate lm_head."""
    m = mesh.model
    if m <= 1:
        return None
    attn = cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0
    mlp = cfg.intermediate_size % m == 0
    if layer is not None:
        for name in ("o_proj",):
            if name in layer:
                k = cfg.num_heads * cfg.head_dim
                attn = attn and k % (m * _row_block(layer[name])) == 0
        for name in ("down_proj", "fc2"):
            if name in layer:
                k = cfg.intermediate_size
                mlp = mlp and k % (m * _row_block(layer[name])) == 0
        if any(n in layer for n in ("qkv_proj", "gateup_proj")):
            raise ValueError("shard the decoder before fusing its "
                             "projections (a fused [q|k|v] cut in M "
                             "parts is not head-aligned)")
    has_head = not cfg.tie_word_embeddings and (
        params is None or "lm_head" in params)
    head = has_head and cfg.vocab_size % m == 0
    return TensorParallel(mesh.model_group, m, mesh.model_index, attn, mlp,
                          head)


def local_config(cfg, tp: Optional[TensorParallel]):
    """The decoder config of this rank's share: its heads and MLP width,
    with `tp` attached (the decoder reads it for the collectives)."""
    if tp is None:
        return cfg
    m = tp.size
    return dataclasses.replace(
        cfg,
        num_heads=cfg.num_heads // m if tp.attn else cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads // m if tp.attn else cfg.num_kv_heads,
        intermediate_size=(cfg.intermediate_size // m if tp.mlp
                           else cfg.intermediate_size),
        tp=tp)


def config_for(llm_params: Dict, cfg, mesh):
    """The local config of a decoder share (`shard_decoder`, or the
    sharded load of `core.builder`) over `mesh`."""
    layers = llm_params["layers"]
    return local_config(cfg, plan(cfg, mesh, layers[0] if layers else None,
                                  llm_params))


def _cut(x: torch.Tensor, dim: int, tp: TensorParallel) -> torch.Tensor:
    n = x.shape[dim] // tp.size
    return x.narrow(dim, tp.index * n, n).contiguous()


def shard_projection(name: str, p: Dict, tp: TensorParallel) -> Dict:
    """This rank's slice of projection `name` ({kernel | kernel_q + scale
    | kernel_p + gscale, bias?}) by its role."""
    out = {}
    for key, x in p.items():
        if name in _ROW:
            cut = key in ("kernel", "kernel_q", "kernel_p", "gscale")
            out[key] = _cut(x, 0, tp) if cut else x
        else:
            dim = -1 if key in ("kernel", "kernel_q", "kernel_p",
                                "gscale") else 0
            out[key] = _cut(x, dim, tp)
    return out


def shard_lora_proj(name: str, ab: Dict, tp: TensorParallel) -> Dict:
    """A LoRA adapter follows its base: B's columns of a column-parallel
    projection, A's rows of a row-parallel one (2-d (in, r) / (r, out),
    or the bank's stacked (..., in, r) / (..., r, out))."""
    if name in _ROW:
        return {"A": _cut(ab["A"], -2, tp), "B": ab["B"]}
    return {"A": ab["A"], "B": _cut(ab["B"], -1, tp)}


def _split(name: str, tp: TensorParallel) -> bool:
    if name in _ATTN:
        return tp.attn
    if name in _MLP:
        return tp.mlp
    return False


def shard_layer(lp: Dict, tp: Optional[TensorParallel]) -> Dict:
    """One decoder layer's share (norms whole)."""
    if tp is None:
        return lp
    return {n: (shard_projection(n, p, tp) if _split(n, tp) else p)
            for n, p in lp.items()}


def shard_head(params: Dict, tp: Optional[TensorParallel]) -> Dict:
    """The decoder's non-layer leaves: lm_head's columns when the head is
    split; the embeddings and the final norm whole."""
    if tp is None or not tp.head or "lm_head" not in params:
        return params
    return dict(params,
                lm_head=shard_projection("lm_head", params["lm_head"], tp))


def shard_lora(tree: Optional[Dict], tp: Optional[TensorParallel]):
    """{"layers": [{proj: {"A", "B"}}]} -> this rank's share."""
    if tree is None or tp is None:
        return tree
    return {"layers": [{n: (shard_lora_proj(n, ab, tp) if _split(n, tp)
                            else ab) for n, ab in la.items()}
                       for la in tree["layers"]]}


def shard_bank(bank: Dict, tp: Optional[TensorParallel]) -> Dict:
    """The serving bank {proj: {"A": (L, C+1, in, r), "B": (L, C+1, r,
    out)}} -> this rank's share, sliced per projection."""
    if tp is None:
        return bank
    return {n: (shard_lora_proj(n, ab, tp) if _split(n, tp) else ab)
            for n, ab in bank.items()}


def shard_decoder(params: Dict, cfg, mesh):
    """(decoder tree, config) -> (this rank's share, its local config).
    The tree must be unfused (fuse after sharding)."""
    tp = plan(cfg, mesh, params["layers"][0] if params["layers"] else None,
              params)
    if tp is None:
        return params, cfg
    out = shard_head(params, tp)
    out["layers"] = [shard_layer(lp, tp) for lp in params["layers"]]
    return out, local_config(cfg, tp)


def shard_params(mesh, params: Dict, cfg):
    """An Opus tree ({"llm", ...}) and its OpusConfig, or a decoder tree
    and its DecoderConfig -> (this rank's tree, its config)."""
    if "llm" in params:
        llm, lcfg = shard_decoder(params["llm"], cfg.llm, mesh)
        return dict(params, llm=llm), dataclasses.replace(cfg, llm=lcfg)
    return shard_decoder(params, cfg, mesh)
