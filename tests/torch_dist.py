"""A pool of gloo ranks for the port's parallel tests.

`RankPool(world, tmp)` spawns `world` processes once (torch.multiprocessing,
"spawn"), each of which starts its process group through a file in `tmp`
(no port, so pytest-xdist workers never collide) and then runs the
functions the test sends it: `pool.run(fn, *args)` calls fn(rank, *args)
on every rank and returns the ranks' results in rank order. Every wait has
a timeout: a rank that raises fails the call with its traceback, and a
rank that hangs fails it within `timeout` seconds; either way the pool is
torn down. The functions live in modules that import torch and the port
only (never jax): the ranks do not load the JAX package.
"""

from __future__ import annotations

import datetime
import os
import queue
import time
import traceback

import torch.multiprocessing as mp

START_TIMEOUT = 60.0


def _serve(rank: int, world: int, init: str, inq, outq) -> None:
    import torch
    torch.set_num_threads(1)
    from opus_pllm_tpu_torch.core import mesh
    try:
        mesh.initialize_distributed(init, world, rank, device_type="cpu",
                                    timeout=datetime.timedelta(seconds=60),
                                    log_fn=None)
        outq.put((rank, "ready", None))
    except BaseException:
        outq.put((rank, "error", traceback.format_exc()))
        return
    while True:
        task = inq.get()
        if task is None:
            break
        fn, args = task
        try:
            outq.put((rank, "ok", fn(rank, *args)))
        except BaseException:
            outq.put((rank, "error", traceback.format_exc()))
    import torch.distributed as dist
    dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int, tmpdir: str):
        ctx = mp.get_context("spawn")
        self.world = world
        self.outq = ctx.Queue()
        self.inqs = [ctx.Queue() for _ in range(world)]
        init = "file://" + os.path.join(str(tmpdir), f"rendezvous{world}")
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, init, self.inqs[r],
                                        self.outq))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self._collect(START_TIMEOUT)

    def _collect(self, timeout: float) -> list:
        out = [None] * self.world
        seen = 0
        end = time.monotonic() + timeout
        while seen < self.world:
            try:
                rank, status, value = self.outq.get(
                    timeout=max(0.1, end - time.monotonic()))
            except queue.Empty:
                self.close(force=True)
                raise AssertionError(f"{self.world - seen} rank(s) did not "
                                     f"answer within {timeout:.0f} s")
            if status == "error":
                self.close(force=True)
                raise AssertionError(f"rank {rank} failed:\n{value}")
            out[rank] = value
            seen += 1
        return out

    def run(self, fn, *args, timeout: float = 60.0) -> list:
        """fn(rank, *args) on every rank -> the results in rank order."""
        if not self.procs:
            raise AssertionError("the rank pool was torn down by an "
                                 "earlier failure")
        for q in self.inqs:
            q.put((fn, args))
        return self._collect(timeout)

    def close(self, force: bool = False) -> None:
        if not force:
            for q in self.inqs:
                q.put(None)
        for p in self.procs:
            p.join(0 if force else 10)
            if p.is_alive():
                p.kill()
                p.join(5)
        self.procs = []
