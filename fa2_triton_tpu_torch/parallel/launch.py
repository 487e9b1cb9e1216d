"""Ranks for the parallel layer: join a process group, or spawn a world.

Nothing tells a program of a cluster here, so a world is made explicitly:
`spawn_ranks(fn, world)` starts `world` processes by `spawn` (never `fork`:
a CUDA parent cannot fork), each of which joins one process group at
`tcp://localhost:<port>` with a timeout, runs `fn(rank, world, *args)`
and hands its picklable result back. A rank that raises, dies or outlives
the deadline fails the whole call, and every process started is stopped
before it returns. `init_rank` is the join alone, for a launcher of one's
own (`torchrun` sets MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE, and
`init_rank(env=True)` reads them).

The backend is chosen by the caller: gloo for CPU ranks and for ranks that
share one GPU (NCCL refuses two ranks on one device), NCCL for one GPU a
rank.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional

import torch.distributed as dist
import torch.multiprocessing as mp

DEFAULT_TIMEOUT_S = 300.0


def free_port() -> int:
    """A TCP port on localhost that nothing listens on right now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_rank(rank: int = 0, world: int = 1, port: Optional[int] = None, backend: str = "gloo",
              timeout_s: float = DEFAULT_TIMEOUT_S, env: bool = False) -> None:
    """Join the default process group: rank `rank` of `world` at
    tcp://localhost:`port` (or, with `env`, the torchrun variables), with a
    timeout on every collective of the group. Gloo is pinned to the
    loopback device unless GLOO_SOCKET_IFNAME says otherwise (the ranks
    share one host)."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    timeout = datetime.timedelta(seconds=timeout_s)
    if env:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
        return
    if port is None:
        raise ValueError("init_rank needs a port (or env=True under torchrun)")
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=timeout)


def _rank_main(rank, world, port, backend, timeout_s, fn, args, results):
    try:
        init_rank(rank, world, port, backend, timeout_s)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:   # the parent must hear of every failure
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_ranks(fn: Callable, world: int, args: tuple = (), backend: str = "gloo",
                timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run `fn(rank, world, *args)` on `world` spawned ranks joined in one
    process group; returns the ranks' results in rank order. `fn` must be
    importable by name (a module-level function). Raises RuntimeError if a
    rank fails or the deadline `timeout_s` passes; every rank is stopped
    before this returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, timeout_s, fn, args, results),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"ranks {sorted(set(range(world)) - set(out))} did not finish "
                                   f"within {timeout_s} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and not p.is_alive()]
                if dead and results.empty():
                    time.sleep(0.5)   # a result may still be in the pipe
                    if results.empty():
                        raise RuntimeError(f"ranks {dead} exited without a result (exit codes "
                                           f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.exitcode not in (0, None):
                raise RuntimeError(f"a rank exited with code {p.exitcode}")
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
