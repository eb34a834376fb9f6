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
replicates a dimension in JAX. For serving and eval the "data" half of
each spec (FSDP) leaves the parameter replicated, and the protein
encoder, CSTP and switch run whole on every rank.

Training adds the "data" half (JAX's partition.py:49-150 through
`shard_state`): `data_dims` names, leaf for leaf, the dim a spec puts on
`data` (None where the spec has none or the rank's dim does not divide),
`cut_data` keeps this rank's 1/D of each such dim on top of the model
cut, and `gather_data` puts the D shares back together
(`shard_frozen`: every frozen leaf but the switch). The decoder gathers
each layer that way just before it runs (`DataShards`, attached to the
local config as `fsdp`); the trainers gather the rest of the frozen tree
and the trainable leaves once a step. `TrainLayout` says how each
trainable leaf lies across the mesh: its model-cut and data-cut dims, and
whether its gradient is a partial sum on each model rank (LoRA A of a
split column-parallel projection, LoRA B of a split row-parallel one);
`cut_leaves` / `uncut_leaves` turn the single process's leaves into a
rank's shares and back (checkpoints).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

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

def data_dims(tree, mesh) -> Any:
    """Leaf for leaf, the dim of this rank's leaf that its spec puts on
    the mesh's data axis, or None: no data axis in the spec, a data axis
    of 1, or a size the axis does not divide (JAX's `_sanitize`, on the
    leaf as the model cut left it)."""
    d = _axis_sizes(mesh)[DATA_AXIS]

    def dim_of(names, leaf):
        if d <= 1 or not isinstance(leaf, torch.Tensor):
            return None
        spec = _rule(names, leaf)
        for dim, ax in enumerate(spec[:leaf.ndim]):
            if ax == DATA_AXIS and leaf.shape[dim] % d == 0:
                return dim
        return None
    return _map_with_names(dim_of, tree)


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def _flat(tree, out=None) -> list:
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k in tree:
            _flat(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _flat(v, out)
    else:
        out.append(tree)
    return out


def cut_data(tree, dims, index: int, size: int) -> Any:
    """This data rank's share of every leaf whose `dims` entry is a dim
    (a copy, so the whole leaf can be freed); the other leaves as they
    are."""
    def cut(x, dim):
        if dim is None:
            return x
        n = x.shape[dim] // size
        return x.narrow(dim, index * n, n).clone()
    return _zip_map(cut, tree, dims)


BUCKET_BYTES = 256 << 20     # shares gathered in one collective, at most


def _gather_big(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """One large share gathered into the whole leaf without a staging
    buffer: along dim 0 the ranks' shares land in the output's rows."""
    n = dist.get_world_size(group)
    if dim == 0:
        shape = (x.shape[0] * n,) + tuple(x.shape[1:])
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        dist.all_gather(list(out.chunk(n, 0)), x.contiguous(), group=group)
        return out
    return torch.cat(mesh_mod.all_gather_list(x, group), dim=dim)


def gather_data(tree, dims, group) -> Any:
    """`cut_data`'s inverse over the data `group`: the shares of every
    leaf with a dim all-gathered and concatenated in group-rank order; the
    other leaves as they are (the same objects). Shares of up to a
    quarter of BUCKET_BYTES go together, up to BUCKET_BYTES a collective
    (`all_gather_flat`); a larger one alone into its whole leaf, so a
    gather holds little more than the whole leaves it returns."""
    flat_x, flat_d = _flat(tree), _flat(dims)
    todo = [i for i, d in enumerate(flat_d) if d is not None]
    if not todo:
        return tree
    whole = {}
    bucket, size = [], 0

    def flush():
        nonlocal bucket, size
        if bucket:
            parts = mesh_mod.all_gather_flat([flat_x[i] for i in bucket],
                                             group)
            for j, i in enumerate(bucket):
                whole[i] = torch.cat([p[j] for p in parts], dim=flat_d[i])
        bucket, size = [], 0
    for i in todo:
        nb = flat_x[i].numel() * flat_x[i].element_size()
        if nb > BUCKET_BYTES // 4:
            whole[i] = _gather_big(flat_x[i], flat_d[i], group)
            continue
        if size + nb > BUCKET_BYTES:
            flush()
        bucket.append(i)
        size += nb
    flush()
    it = iter(range(len(flat_x)))
    return _zip_map(lambda x, d: whole.get(next(it), x), tree, dims)


@dataclasses.dataclass
class DataShards:
    """The FSDP half of a decoder share: its layers' leaves stored 1/D
    over the data `group` (`layer_dims`: the data dims of a layer, the
    same for every layer). The decoder calls `gather_layer` just before a
    layer runs; the gathered tensors die with the layer's call (and are
    gathered again by the recompute under remat)."""
    group: Any
    layer_dims: Any
    dims: Any                  # the data dims of the whole frozen tree

    def gather_layer(self, lp: Dict) -> Dict:
        return gather_data(lp, self.layer_dims, self.group)


@dataclasses.dataclass
class LeafLayout:
    """One trainable leaf across the mesh: the dim the model cut splits
    (None: whole on every model rank), the dim the data cut splits, and
    whether each model rank's gradient is a partial sum (a whole leaf
    used against a split projection)."""
    model_dim: Optional[int]
    data_dim: Optional[int]
    partial: bool


class TrainLayout:
    """How a trainable tree ({"lora"?, "switch"?}) lies across `mesh`
    under the decoder plan `tp` (None at M = 1): built from the tree as a
    rank holds it after the model cut (LoRA by `shard_lora`, the switch
    whole)."""

    def __init__(self, local_tree, mesh, tp: Optional[TensorParallel]):
        self.mesh = mesh
        roles = {}
        if "lora" in local_tree:
            roles["lora"] = {"layers": [
                {n: _lora_roles(n, tp) for n in la}
                for la in local_tree["lora"]["layers"]]}
        if "switch" in local_tree:
            roles["switch"] = _map_with_names(
                lambda n, x: LeafLayout(None, None, False),
                local_tree["switch"])
        self.leaves: List[LeafLayout] = _sorted_leaves(_zip_map(
            lambda lay, dd: dataclasses.replace(lay, data_dim=dd), roles,
            data_dims({k: local_tree[k] for k in roles}, mesh)))

    def replicas(self, lay: LeafLayout) -> int:
        """On how many ranks of the mesh this leaf's share is held."""
        return ((self.mesh.model if lay.model_dim is None else 1)
                * (self.mesh.data if lay.data_dim is None else 1))

    def data_share(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf i's tensor as this rank's model cut holds it -> this
        rank's share of it along the data axis."""
        dim = self.leaves[i].data_dim
        if dim is None:
            return x
        w = x.shape[dim] // self.mesh.data
        return x.narrow(dim, self.mesh.data_index * w, w)


def _lora_roles(name: str, tp) -> Dict:
    """{"A", "B"} layouts (data dims left None) of a LoRA adapter on
    projection `name` (`shard_lora_proj`'s cut)."""
    lay = LeafLayout
    if tp is None or not _split(name, tp):
        return {"A": lay(None, None, False), "B": lay(None, None, False)}
    if name in _ROW:
        return {"A": lay(0, None, False), "B": lay(None, None, True)}
    return {"A": lay(None, None, True), "B": lay(1, None, False)}


def _sorted_leaves(tree) -> list:
    """The leaves in the trainers' order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _sorted_leaves(v)]
    return [tree]


def cut_leaves(xs: List[torch.Tensor], layout: TrainLayout,
               model_cut: bool = True) -> List[torch.Tensor]:
    """Whole leaves (in the trainers' order) -> this rank's shares: the
    model cut (unless `model_cut` is False: already taken), then the data
    cut."""
    m = layout.mesh
    out = []
    for i, (x, lay) in enumerate(zip(xs, layout.leaves)):
        if model_cut and lay.model_dim is not None:
            n = x.shape[lay.model_dim] // m.model
            x = x.narrow(lay.model_dim, m.model_index * n, n)
        out.append(layout.data_share(x, i).clone())
    return out


def uncut_leaves(xs: List[torch.Tensor], layout: TrainLayout,
                 model: bool = True) -> List[torch.Tensor]:
    """`cut_leaves`' inverse on every rank: the data shares all-gathered
    (one collective), then (unless `model` is False) the model shares."""
    m = layout.mesh
    idx = [i for i, lay in enumerate(layout.leaves)
           if lay.data_dim is not None]
    out = list(xs)
    if idx:
        parts = mesh_mod.all_gather_flat([xs[i] for i in idx], m.data_group)
        for j, i in enumerate(idx):
            out[i] = torch.cat([p[j] for p in parts],
                               dim=layout.leaves[i].data_dim)
    if not model:
        return out
    idx = [i for i, lay in enumerate(layout.leaves)
           if lay.model_dim is not None]
    if idx:
        parts = mesh_mod.all_gather_flat([out[i] for i in idx],
                                         m.model_group)
        for j, i in enumerate(idx):
            out[i] = torch.cat([p[j] for p in parts],
                               dim=layout.leaves[i].model_dim)
    return out


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


def shard_frozen(mesh, params: Dict, cfg):
    """The frozen Opus tree and its OpusConfig -> (this rank's share, the
    share's config) for training on `mesh`: the LLM cut over `model` by
    projection role (`shard_params`, unless `cfg.llm.tp` says the tree is
    a share already), then every leaf's data dim over `data` (FSDP), with
    `DataShards` on the LLM's config so the decoder gathers each layer as
    it runs; the frozen switch stays whole (below). The LLM must be
    unfused."""
    if mesh.model > 1 and cfg.llm.tp is None:
        params, cfg = shard_params(mesh, params, cfg)
    dims = data_dims(params, mesh)
    if "switch" in dims:
        # the frozen switch stays whole: it runs as one matrix (4.3 GB
        # fp32 at Llama-3-8B) on one activation, so its data cut would
        # add the share to the peak (share + the gathered whole) and
        # all-gather the whole matrix every step
        dims["switch"] = _map_with_names(lambda n, x: None,
                                         params["switch"])
    share = cut_data(params, dims, mesh.data_index, mesh.data)
    layers = dims["llm"]["layers"]
    fs = DataShards(mesh.data_group, layers[0] if layers else {}, dims)
    return share, dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, fsdp=fs))
