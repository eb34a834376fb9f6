"""The ("pipe",) and ("data", "pipe") meshes of pipeline parallelism over
torch.distributed ranks, and the stage-to-stage activation transfer (port
of `opus_pllm_tpu/parallel/pipeline.py`: `make_pp_mesh` :43; its
`pipeline_apply` :64, the tick scan that SPMD runs on every stage, becomes
the schedule of `train/pp.py`, one stage a rank).

The ranks form `data` pipeline replicas of `stages` stages each, in the
JAX mesh's row-major order: rank r is stage r % stages of replica
r // stages. `pipe_group` joins the stages of this rank's replica (the
activations pass along it), `data_group` the replicas of this rank's
stage. `send` / `recv` move one activation or its gradient to a
neighbouring stage of the same replica; gloo has no send / recv for CUDA
tensors, so on a shared card the tensor goes through host memory,
counted in `core.mesh.host_staged["pipe_p2p"]`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core import mesh as mesh_mod


@dataclasses.dataclass
class PipeMesh:
    """This rank's place in a (data, pipe) mesh: stage `stage` of replica
    `replica`; `ranks[d][p]` is the global rank of stage p of replica d."""
    stages: int
    data: int
    stage: int
    replica: int
    ranks: List[List[int]]
    pipe_group: object
    data_group: object
    group: object

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.stages - 1

    def layer_range(self, num_layers: int) -> range:
        """This stage's contiguous block of the decoder's layers; a count
        that does not divide by the stages is a ValueError."""
        if num_layers % self.stages:
            raise ValueError(f"{num_layers} layers not divisible by "
                             f"{self.stages} pipeline stages")
        per = num_layers // self.stages
        return range(self.stage * per, (self.stage + 1) * per)


def make_pp_mesh(n: Optional[int] = None, *, data: int = 1,
                 ranks: Optional[Sequence[int]] = None
                 ) -> Optional[PipeMesh]:
    """The mesh of `data` replicas of `n` stages over the first n x data
    of `ranks` (default: the whole world; n None: every rank a stage of
    one of `data` replicas). Every rank of the world calls it (group
    creation is collective); a rank outside gets None. More stages x
    replicas than ranks is a ValueError, as in JAX: a silent truncation
    would change the layers-per-stage split a user sized for memory."""
    if not dist.is_initialized():
        raise RuntimeError("make_pp_mesh needs a live process group: start "
                           "the ranks with torchrun")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    need = (n if n is not None else len(ranks) // data) * data
    if need > len(ranks):
        raise ValueError(f"--pipe-stages {n} x --pipe-data {data} "
                         f"> {len(ranks)} devices")
    ranks = ranks[:need]
    n = need // data
    grid = [ranks[d * n:(d + 1) * n] for d in range(data)]
    me = dist.get_rank()
    group = dist.new_group(ranks)
    pipe_group = data_group = None
    for row in grid:
        g = dist.new_group(row)
        if me in row:
            pipe_group = g
    for p in range(n):
        col = [row[p] for row in grid]
        g = dist.new_group(col)
        if me in col:
            data_group = g
    if me not in ranks:
        return None
    pos = ranks.index(me)
    return PipeMesh(n, data, pos % n, pos // n, grid, pipe_group,
                    data_group, group)


def _staged(device, group) -> bool:
    return torch.device(device).type == "cuda" and \
        dist.get_backend(group) == "gloo"


def send(t: torch.Tensor, mesh: PipeMesh, stage: int) -> None:
    """t to stage `stage` of this rank's replica (blocking)."""
    dst = mesh.ranks[mesh.replica][stage]
    if _staged(t.device, mesh.pipe_group):
        mesh_mod.host_staged["pipe_p2p"] += 1
        t = t.cpu()
    dist.send(t.contiguous(), dst, group=mesh.pipe_group)


def recv(shape, dtype, device, mesh: PipeMesh, stage: int) -> torch.Tensor:
    """A tensor of `shape` / `dtype` from stage `stage` of this rank's
    replica, on `device` (blocking)."""
    src = mesh.ranks[mesh.replica][stage]
    staged = _staged(device, mesh.pipe_group)
    if staged:
        mesh_mod.host_staged["pipe_p2p"] += 1
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if staged else device)
    dist.recv(buf, src, group=mesh.pipe_group)
    return buf.to(device) if staged else buf
