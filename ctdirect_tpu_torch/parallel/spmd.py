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

A world may span hosts (`benchmarks/multihost.py`'s vocabulary): with
`coordinator="host:port"`, `num_hosts=H` and `host_id=h`, each of the H hosts
calls `launch` with its own `host_id` and spawns its `nproc` local ranks, the
global ranks h*nproc .. h*nproc + nproc - 1 of one world of H*nproc
(`rank_layout`: local rank l on the host's card l). Global rank 0 serves the
rendezvous store at the coordinator's address, so host 0 must run on that
machine (`launch` there fails before spawning when it cannot bind it); every
other host connects to it within `timeout`. Each host's `launch` returns its
own ranks' results; what a rank needs of the others travels through the
world itself (a collective). Several hosts on one machine each see their own
cards (CUDA_VISIBLE_DEVICES).

`fn` must be importable by name (a module-level function of an importable
module): the spawned processes import it afresh.

Backends (`check_backend`):
  - "gloo" carries CPU tensors; given CUDA tensors (several ranks sharing one
    card, which NCCL refuses) every message is staged through the host
    (`time_shard.ShardAxis` counts those);
  - "nccl" carries CUDA tensors, one card per rank.
Any other backend, an NCCL world on the CPU and an NCCL world with more ranks
on a host than the host has cards raise before anything is spawned."""

from __future__ import annotations

import contextlib
import ipaddress
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


def check_backend(backend: str, device_type: str, local_ranks: int) -> None:
    """Raise ValueError for a world no backend of the port carries: an
    unknown backend, NCCL with CPU tensors, NCCL with more ranks on this host
    (`local_ranks`) than this host has cards."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: the port's collectives run on {BACKENDS}")
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError(f"an NCCL group carries CUDA tensors, not {device_type} tensors")
        cards = torch.cuda.device_count()
        if local_ranks > cards:
            raise ValueError(
                f"NCCL puts one rank on each card: {local_ranks} ranks on this host, {cards} cards "
                f"(ranks sharing a card run on gloo, which stages CUDA tensors through the host)"
            )


def local_world_size() -> int:
    """The ranks on this rank's host (LOCAL_WORLD_SIZE, which `launch` sets;
    the world's size where it is not set)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def parse_coordinator(coordinator: str) -> tuple:
    """(host, port) of "host:port" (or "[v6 address]:port"); ValueError
    where the host or the port is missing."""
    host, sep, port = coordinator.rpartition(":")
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    if not sep or not host or not port.isdigit() or not 0 < int(port) < 65536:
        raise ValueError(f"a coordinator is host:port, not {coordinator!r}")
    return host, int(port)


def is_loopback(host: str) -> bool:
    """Whether `host` names this machine's loopback interface."""
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


def check_hosts(coordinator, num_hosts: int, host_id: int) -> None:
    """ValueError for a world of hosts no launch can join: fewer than one
    host, a host_id outside [0, num_hosts), several hosts without a
    coordinator, a coordinator without a host or a port."""
    if not (isinstance(num_hosts, int) and num_hosts >= 1):
        raise ValueError(f"a world has at least one host, not {num_hosts!r}")
    if not (isinstance(host_id, int) and 0 <= host_id < num_hosts):
        raise ValueError(f"host_id {host_id!r} is outside [0, {num_hosts})")
    if coordinator is not None:
        parse_coordinator(coordinator)
    elif num_hosts > 1:
        raise ValueError(f"a world of {num_hosts} hosts needs a coordinator host:port")


def rank_layout(num_hosts: int, nproc: int, host_id: int, cards: int = 0) -> list:
    """(global rank, local rank, card) of each of host `host_id`'s `nproc`
    ranks in a world of num_hosts x nproc: local rank l is global rank
    host_id * nproc + l, on card l % cards (None where `cards` is 0)."""
    return [(host_id * nproc + l, l, l % cards if cards else None) for l in range(nproc)]


@dataclass
class World:
    """What a rank knows of its world: its rank, the world's size, the device
    its tensors live on and the backend of its process group; its rank among
    its host's ranks, its host and the number of hosts."""

    rank: int
    size: int
    device: torch.device
    backend: str
    local_rank: int
    host: int
    num_hosts: int

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


def _check_bind(host: str, port: int) -> None:
    """SPMDError unless this machine can listen at host:port, where global
    rank 0 serves the rendezvous store."""
    try:
        infos = socket.getaddrinfo(host, port, type=socket.SOCK_STREAM)
        family, _, _, _, addr = infos[0]
        with socket.socket(family, socket.SOCK_STREAM) as s:
            s.bind(addr)
    except OSError as e:
        raise SPMDError(
            f"host 0 serves the rendezvous store at {host}:{port}, and this machine cannot listen there ({e}): "
            f"run host 0 on the coordinator's machine, at a free port"
        ) from e


def _rank_main(rank, local_rank, nproc, size, host, port, loopback, place, device, backend, fn, args, results,
               timeout):
    os.environ.update(MASTER_ADDR=host, MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(size),
                      LOCAL_RANK=str(local_rank), LOCAL_WORLD_SIZE=str(nproc))
    if loopback:
        # rendezvous and messages stay on the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        # the host's ranks share its cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nproc))
        dev = torch.device(device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", local_rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        address = f"[{host}]" if ":" in host else host
        dist.init_process_group(backend, init_method=f"tcp://{address}:{port}", rank=rank, world_size=size,
                                timeout=timedelta(seconds=timeout))
        out = fn(World(rank, size, dev, backend, local_rank, place[0], place[1]), *args)
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, nproc: int, *, device, backend: str, args=(), timeout: float = 300.0, coordinator=None,
           num_hosts: int = 1, host_id: int = 0) -> list:
    """Run fn(world, *args) on `nproc` spawned ranks on `device` ("cpu",
    "cuda": local rank l on card l % cards, or "cuda:i" for all) over
    `backend`; returns the ranks' results in rank order. With `coordinator`
    ("host:port"), these are host `host_id`'s ranks of a world of
    num_hosts x nproc (the module docstring); without, a world of `nproc`
    on a free localhost port. Raises ValueError before anything is spawned
    for a world no launch can run (`check_backend`, `check_hosts`), and
    SPMDError if a rank raises or dies, or if the world has not finished
    within `timeout` seconds (a host whose peers never join included);
    every process is stopped before `launch` returns or raises."""
    check_hosts(coordinator, num_hosts, host_id)
    dev = torch.device(device)
    check_backend(backend, dev.type, nproc)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ValueError("device cuda asked for, but torch sees no CUDA device")
    if coordinator is None:
        host, port = "127.0.0.1", _free_port()
    else:
        host, port = parse_coordinator(coordinator)
        if host_id == 0:
            _check_bind(host, port)
    layout = rank_layout(num_hosts, nproc, host_id)
    ranks = [r for r, _, _ in layout]
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = {
        r: ctx.Process(target=_rank_main,
                       args=(r, l, nproc, num_hosts * nproc, host, port, is_loopback(host), (host_id, num_hosts),
                             str(dev), backend, fn, tuple(args), results, timeout),
                       daemon=True)
        for r, l, _ in layout
    }
    for p in procs.values():
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
                dead = [r for r, p in procs.items() if r not in outs and p.exitcode not in (None, 0)]
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
        for p in procs.values():
            p.join(timeout=max(0.0, grace - time.monotonic()))
        for p in procs.values():
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    where = "" if coordinator is None else f" (host {host_id} of {num_hosts}, coordinator {coordinator})"
    if errors:
        first = min(errors)
        raise SPMDError(f"{len(errors)} of {nproc} ranks failed{where}; rank {first}:\n{errors[first]}")
    if len(outs) < nproc:
        missing = sorted(set(ranks) - set(outs))
        raise SPMDError(f"ranks {missing} of {num_hosts * nproc} did not finish within {timeout:.0f} s{where}")
    return [outs[r] for r in ranks]
