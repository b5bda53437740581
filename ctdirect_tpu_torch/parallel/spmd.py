"""SPMD launcher: one function on every rank of a torch.distributed world.

`launch(fn, nproc, device=..., backend=...)` spawns `nproc` processes (the
spawn start method: no CUDA state of the caller reaches them), gives each the
rendezvous address of a free localhost port, its RANK and WORLD_SIZE,
initialises the process group and calls `fn(world, *args)` there. `world`
knows its rank, size, device and backend and builds named `DeviceMesh`es over
the ranks (`world.mesh((2, 2), ("batch", "time"))`). The ranks' return values
(picklable: numbers, numpy arrays, strings) come back to the caller in rank
order. A rank that raises, dies or outlives the time limit makes `launch`
stop every process it started and raise.

`fn` must be importable by name (a module-level function of an importable
module): the spawned processes import it afresh.

Backends (`check_backend`):
  - "gloo" carries CPU tensors; given CUDA tensors (several ranks sharing one
    card, which NCCL refuses) every message is staged through the host
    (`time_shard.ShardAxis` counts those);
  - "nccl" carries CUDA tensors, one card per rank.
Any other backend, an NCCL world on the CPU and an NCCL world with more ranks
than cards raise before anything is spawned."""

from __future__ import annotations

import contextlib
import os
import queue as queue_mod
import socket
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def check_backend(backend: str, device_type: str, world_size: int) -> None:
    """Raise ValueError for a world no backend of the port carries: an
    unknown backend, NCCL with CPU tensors, NCCL with more ranks than cards."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: the port's collectives run on {BACKENDS}")
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError(f"an NCCL group carries CUDA tensors, not {device_type} tensors")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(
                f"NCCL puts one rank on each card: {world_size} ranks, {cards} cards "
                f"(ranks sharing a card run on gloo, which stages CUDA tensors through the host)"
            )


@dataclass
class World:
    """What a rank knows of its world: its rank, the world's size, the device
    its tensors live on and the backend of its process group."""

    rank: int
    size: int
    device: torch.device
    backend: str

    def mesh(self, shape, names):
        """A DeviceMesh of `shape` over all ranks (row-major) with the axis
        `names`; every rank must build the same meshes in the same order.
        Its groups have the world's backend."""
        from torch.distributed.device_mesh import init_device_mesh

        device_type = "cuda" if self.backend == "nccl" else "cpu"
        return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


class SPMDError(RuntimeError):
    """A rank of a launched world failed, died or ran out of time."""


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, nproc, port, device, backend, fn, args, results, timeout):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(nproc), LOCAL_RANK=str(rank))
    # rendezvous and messages stay on the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nproc))
        dev = torch.device(device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=nproc, timeout=timedelta(seconds=timeout))
        out = fn(World(rank, nproc, dev, backend), *args)
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, nproc: int, *, device, backend: str, args=(), timeout: float = 300.0) -> list:
    """Run fn(world, *args) on `nproc` spawned ranks on `device` ("cpu",
    "cuda": rank r on card r % cards, or "cuda:i" for all) over `backend`;
    returns the ranks' results in rank order. Raises SPMDError if a rank
    raises or dies, or if the world has not finished within `timeout`
    seconds; every process is stopped before `launch` returns or raises."""
    dev = torch.device(device)
    check_backend(backend, dev.type, nproc)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ValueError("device cuda asked for, but torch sees no CUDA device")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [
        ctx.Process(target=_rank_main, args=(r, nproc, port, str(dev), backend, fn, tuple(args), results, timeout),
                    daemon=True)
        for r in range(nproc)
    ]
    for p in procs:
        p.start()
    outs, errors = {}, {}

    def take(wait):
        rank, err, out = results.get(timeout=wait)
        if err is None:
            outs[rank] = out
        else:
            errors[rank] = err

    deadline = time.monotonic() + timeout
    try:
        while len(outs) < nproc and not errors and time.monotonic() < deadline:
            try:
                take(min(1.0, max(0.01, deadline - time.monotonic())))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in outs and p.exitcode not in (None, 0)]
                if dead:
                    # a rank that raised has reported before it exited
                    with contextlib.suppress(queue_mod.Empty):
                        while True:
                            take(0.5)
                    for r in dead:
                        errors.setdefault(r, f"rank {r} died with exit code {procs[r].exitcode}")
    finally:
        # a finished world leaves on its own; a failed or late one is stopped
        grace = time.monotonic() + (30.0 if len(outs) == nproc else 0.0)
        for p in procs:
            p.join(timeout=max(0.0, grace - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if errors:
        first = min(errors)
        raise SPMDError(f"{len(errors)} of {nproc} ranks failed; rank {first}:\n{errors[first]}")
    if len(outs) < nproc:
        missing = sorted(set(range(nproc)) - set(outs))
        raise SPMDError(f"ranks {missing} of {nproc} did not finish within {timeout:.0f} s")
    return [outs[r] for r in range(nproc)]
