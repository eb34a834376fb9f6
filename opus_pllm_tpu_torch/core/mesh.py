"""The ("data", "model") mesh over torch.distributed ranks (port of
`opus_pllm_tpu/core/mesh.py`: `initialize_distributed` :23,
`parse_mesh_flag` :56, `make_mesh` :66, `shard_batch` :91, `local_slice`
:97).

The JAX package is single-controller SPMD: one process drives every
device and XLA inserts the collectives from sharding annotations. Here
every rank is its own process (started by `torchrun`, or by
`torch.multiprocessing` in the tests), and the collectives are explicit
calls on process groups. A `Mesh` holds this rank's coordinates and two
groups: the ranks of its data row (same data index: the "model" axis,
tensor parallelism) and of its model column (same model index: the
"data" axis, data parallelism).

Backend: `pick_backend` takes NCCL when every local rank has a card of its
own, else gloo (the CPU, and ranks that share one card: NCCL refuses two
ranks on one device). Gloo takes CUDA tensors for `all_reduce`,
`broadcast` and `all_gather`, not for `send` / `recv`: the ring's rotation
on a shared card goes through host memory, explicitly in `ring_shift`,
and is counted in `host_staged`. The trainers' gradient reduce-scatter
is one all-reduce and a slice (train/multimodal_trainer.py), so nothing
depends on what a backend offers beyond those three.

Training runs through collectives that autograd differentiates (the JAX
package gets them from XLA's transpose of the sharded program):
`copy_to_model` (identity forward, sum backward: before a column-parallel
product), `reduce_from_model` (sum forward, identity backward: after a
row-parallel product), `gather_from` (an
all-gather forward whose backward takes this rank's slice and sums
nothing: every rank of the group computes the same loss from the same
gathered tensor). `all_gather_flat` gathers a list of tensors of any
dtypes in one collective (the FSDP gathers of parallel/partition.py).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"
TIMEOUT = datetime.timedelta(seconds=60)

# collectives that went through host memory because the backend does not
# take the tensor's device (gloo send / recv with CUDA tensors)
host_staged: Dict[str, int] = {"ring_shift": 0}
# what initialize_distributed chose: backend, whether ranks share a card,
# this rank's device type
_STATE: Dict[str, object] = {}


def reset_host_staged() -> None:
    for k in host_staged:
        host_staged[k] = 0


def pick_backend(device_type: str, local_world: int,
                 n_cards: Optional[int] = None):
    """-> (backend, shared): NCCL when the run is on CUDA and every local
    rank has a card of its own; gloo on the CPU, and when ranks share a
    card (`shared` True)."""
    if device_type != "cuda":
        return "gloo", False
    n = torch.cuda.device_count() if n_cards is None else n_cards
    if n >= local_world:
        return "nccl", False
    return "gloo", True


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           local_rank: Optional[int] = None, *,
                           device_type: str = "cuda",
                           timeout: datetime.timedelta = TIMEOUT,
                           log_fn=print) -> bool:
    """Start this rank's process group. Explicit arguments win; otherwise
    torchrun's RANK / WORLD_SIZE / LOCAL_RANK / LOCAL_WORLD_SIZE and
    MASTER_ADDR / MASTER_PORT are read. With neither this is a single
    process and the call is a no-op returning False. Idempotent: True when
    a process group is live after the call. Prints the backend it chose
    and whether the ranks share a card."""
    if dist.is_initialized():
        return True
    env = os.environ
    rank = rank if rank is not None else env.get("RANK")
    world_size = world_size if world_size is not None else \
        env.get("WORLD_SIZE")
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    if init_method is None and world_size is None and rank is None:
        return False
    if rank is None or world_size is None:
        raise ValueError("initialize_distributed needs a rank and a world "
                         "size (RANK / WORLD_SIZE, as torchrun sets them)")
    rank, world_size = int(rank), int(world_size)
    local_rank = int(local_rank if local_rank is not None
                     else env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    backend, shared = pick_backend(device_type, local_world)
    if device_type == "cuda":
        card = 0 if shared else local_rank
        torch.cuda.set_device(card)
    _STATE.update(backend=backend, shared=shared, device_type=device_type,
                  local_rank=local_rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    if rank == 0 and log_fn is not None:
        log_fn(f"torch.distributed: {world_size} ranks, backend {backend}"
               + (", sharing one card" if shared else ""))
    return True


def backend_info() -> Dict[str, object]:
    """{"backend", "shared", "device_type"} of the live process group."""
    if not dist.is_initialized():
        return {"backend": None, "shared": False, "device_type": None}
    return {"backend": dist.get_backend(),
            "shared": bool(_STATE.get("shared", False)),
            "device_type": _STATE.get("device_type", "cpu")}


def rank_device(device_type: Optional[str] = None) -> torch.device:
    """This rank's device: its own card (NCCL), the shared card 0 (gloo
    on one card), or the CPU."""
    device_type = device_type or _STATE.get("device_type", "cpu")
    if device_type != "cuda":
        return torch.device("cpu")
    if _STATE.get("shared", False):
        return torch.device("cuda", 0)
    return torch.device("cuda", int(_STATE.get("local_rank", 0)))


def parse_mesh_flag(flag: str) -> MeshConfig:
    """'D,M' (or 'D' for pure DP) -> MeshConfig: the CLI --mesh surface."""
    parts = [int(p) for p in flag.split(",") if p.strip()]
    if len(parts) == 1:
        return MeshConfig(data=parts[0], model=1)
    if len(parts) == 2:
        return MeshConfig(data=parts[0], model=parts[1])
    raise ValueError(f"--mesh expects 'DATA,MODEL', got {flag!r}")


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, model) mesh. `ranks[d][m]` is the
    global rank at data index d, model index m; `model_group` joins this
    rank's data row (the tensor-parallel ranks), `data_group` its model
    column (the data-parallel ranks), `group` the whole mesh."""
    data: int
    model: int
    data_index: int
    model_index: int
    ranks: List[List[int]]
    model_group: object
    data_group: object
    group: object
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}


def make_mesh(cfg: Optional[MeshConfig] = None,
              ranks: Optional[Sequence[int]] = None,
              device: Optional[torch.device] = None) -> Optional[Mesh]:
    """The (data, model) mesh over `ranks` (default: the whole world), in
    row-major order. Every rank of the world calls it (group creation is
    collective); a rank outside `ranks` gets None. With no config every
    rank goes on the data axis. data x model != len(ranks) is a
    ValueError, as the JAX function raises when the mesh does not match
    the device count."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a live process group: start "
                           "the ranks with torchrun (or call "
                           "initialize_distributed)")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    n = len(ranks)
    if cfg is None:
        cfg = MeshConfig(data=n, model=1)
    if cfg.data * cfg.model != n:
        raise ValueError(f"mesh {cfg.data}x{cfg.model} != {n} ranks")
    grid = [ranks[d * cfg.model:(d + 1) * cfg.model]
            for d in range(cfg.data)]
    me = dist.get_rank()
    group = dist.new_group(ranks)
    model_group = data_group = None
    for row in grid:                                   # data rows
        g = dist.new_group(row)
        if me in row:
            model_group = g
    for m in range(cfg.model):                         # model columns
        col = [row[m] for row in grid]
        g = dist.new_group(col)
        if me in col:
            data_group = g
    if me not in ranks:
        return None
    pos = ranks.index(me)
    return Mesh(cfg.data, cfg.model, pos // cfg.model, pos % cfg.model,
                grid, model_group, data_group, group,
                device if device is not None else rank_device())


def local_slice(n_items: int, process_index: int = 0,
                process_count: int = 1) -> slice:
    """Contiguous slice of a dataset for one of `process_count` data
    ranks (the split of `accelerator.split_between_processes`,
    run_opus_ddp.py:77)."""
    base, rem = divmod(n_items, process_count)
    start = process_index * base + min(process_index, rem)
    return slice(start, start + base + (1 if process_index < rem else 0))


def data_slice(mesh: Optional[Mesh], n_items: int) -> slice:
    """This rank's rows of `n_items`: the local_slice of its data index
    (every model rank of a data row takes the same rows)."""
    if mesh is None:
        return slice(0, n_items)
    return local_slice(n_items, mesh.data_index, mesh.data)


def shard_batch(mesh: Optional[Mesh], tree):
    """This rank's rows of every leaf's leading (batch) dim: the same
    contiguous split as `local_slice`, by the data index."""
    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        return x[data_slice(mesh, x.shape[0])]
    return take(tree)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over `group` (the backend takes the tensor's device:
    NCCL on cards, gloo on the CPU and on a shared card)."""
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_list(t: torch.Tensor, group) -> List[torch.Tensor]:
    """The group's tensors (all of t's shape), in group-rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return parts


def all_gather_cat(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group-rank order."""
    return torch.cat(all_gather_list(t, group), dim=dim)


def ring_shift(tensors: Sequence[torch.Tensor], group
               ) -> List[torch.Tensor]:
    """Each tensor sent to the next rank of `group` (group rank i + 1 mod
    n) and the previous rank's received: one rotation of the ring. gloo
    has no send / recv for CUDA tensors: there the tensors go through
    host memory (copied to the CPU, rotated, copied back), counted in
    host_staged["ring_shift"]."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    staged = tensors[0].is_cuda and dist.get_backend(group) == "gloo"
    if staged:
        host_staged["ring_shift"] += 1
    send = [t.cpu() if staged else t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = []
    for s, r in zip(send, recv):
        ops.append(dist.P2POp(dist.isend, s, nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if staged:
        return [r.to(t.device) for r, t in zip(recv, tensors)]
    return recv


_ALIGN = 16       # byte alignment of each tensor in a flat buffer


def all_gather_flat(tensors: Sequence[torch.Tensor], group
                    ) -> List[List[torch.Tensor]]:
    """Every rank's `tensors` (the same shapes and dtypes on every rank of
    `group`), in ONE all-gather of a byte buffer: out[r][i] is rank r's
    tensors[i]. The tensors share one device."""
    if not tensors:
        return [[] for _ in range(dist.get_world_size(group))]
    offs, total = [], 0
    for t in tensors:
        offs.append(total)
        total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    buf = torch.empty(total, dtype=torch.uint8, device=tensors[0].device)
    for t, o in zip(tensors, offs):
        nb = t.numel() * t.element_size()
        buf[o:o + nb] = t.contiguous().reshape(-1).view(torch.uint8)
    out = []
    for part in all_gather_list(buf, group):
        out.append([part[o:o + t.numel() * t.element_size()].view(
            t.dtype).reshape(t.shape) for t, o in zip(tensors, offs)])
    return out


# ---------------------------------------------------------------------------
# collectives that autograd differentiates
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim = dim % x.dim()
        ctx.width = x.shape[ctx.dim]
        ctx.index = dist.get_rank(group)
        return all_gather_cat(x, group, dim=ctx.dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.width,
                         ctx.width).contiguous(), None, None)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """x as it is; in the backward its gradient is summed over `group`
    (the input of a column-parallel product: each rank's product
    contributes its columns' part of the input's gradient)."""
    return _CopyTo.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group` (after a row-parallel product); the
    gradient passes to every rank's x unchanged."""
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The group's x concatenated along `dim`: a column-parallel head's
    logits over `model`, the CSTP projections of each rank's rows over
    `data` (so the similarity spans the global batch). Backward: this
    rank's slice of the gradient, not summed: every rank computes the same
    loss from the same gathered tensor, so a sum would count the gradient
    once a rank (the parameters' gradients are summed over `data`
    afterwards)."""
    return _GatherFrom.apply(x, group, dim)
