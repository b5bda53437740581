"""ctdirect_tpu_torch.multihost across hosts (benchmarks/multihost.py's
--coordinator / --num-hosts / --host-id mode) on the CPU: two host
processes, one rank each, joined into one gloo world over a loopback
coordinator (`multihost.loopback_hosts`, each host calling `run_hosts`),
held bit for bit to the single-host `multihost.run(2, cfg)` world at
tests/test_torch_multihost.py's sizes, and their double-integrator ticks to
the JAX package's MPCController(mesh=) on 2 of the 8 virtual CPU devices of
tests/conftest.py; parallel/spmd.py's rank layout, its refusals, and a host
whose peer never joins. On the card (marked `cuda`, skipped without one; no
JAX needed: `python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_multihost_hosts.py`): the two-host gloo world on one card
against a one-rank NCCL world."""

import concurrent.futures
import multiprocessing
import socket
import time

import numpy as np
import pytest
import torch

from ctdirect_tpu_torch import multihost
from ctdirect_tpu_torch.parallel import spmd
from test_torch_multihost import PER_RANK, small_cfg
from torch_helpers import WORLD_TIMEOUT, spmd_sleeping_world

DI, CP = "double_integrator_minenergy", "cartpole"
HOSTS = 2
# the fields of a rank's record that are clock readings or memory sizes,
# which differ between two runs of the same world
CLOCKS = {"cold_s", "first_s", "capture_s", "p50", "p90", "host_ms", "dp_host_ms", "slowest_host_ms",
          "slowest_dp_host_ms", "wall_s", "pool_mib", "peak_mib", "peak_reserved_mib", "peak_with_eager_mib"}
MISSING_PEER_TIMEOUT = 15.0


def same_record(a, b, path="record"):
    """Assert two rank records equal, bit for bit, but for their CLOCKS."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            if k not in CLOCKS:
                same_record(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same_record(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (path, a, b)


@pytest.fixture(scope="module")
def cfg():
    return small_cfg()


@pytest.fixture(scope="module")
def worlds(cfg, tmp_path_factory):
    """(the two hosts' results, the single-host worlds of run(2, cfg)),
    made side by side."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        hosts = pool.submit(multihost.loopback_hosts, 1, cfg, HOSTS, tmp_path_factory.mktemp("hosts"),
                            timeout=WORLD_TIMEOUT)
        single = multihost.run(HOSTS, cfg, timeout=WORLD_TIMEOUT)
        return hosts.result(), single


@pytest.fixture(scope="module")
def jax_ticks(cfg, worlds):
    """The JAX package's batch-sharded double-integrator tick over a mesh of
    2 devices, jitted, from the hosts' warm state over the same x0 draws."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from ctdirect_tpu import transcribe
    from ctdirect_tpu.parallel.mpc import MPCController, broadcast_state
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.resolve import WarmState

    pc = cfg["problems"][DI]
    B = PER_RANK * HOSTS
    mesh = Mesh(np.array(jax.devices()[:HOSTS]), axis_names=("batch",))
    rows = NamedSharding(mesh, PartitionSpec("batch"))
    d = transcribe(get_problem(DI).ocp, grid_size=pc["N"], scheme="trapeze")
    ctrl = MPCController(d, x0_boundary_rows=list(pc["rows"]), resolve_iters=pc["iters"], kkt_algorithm="cr",
                         mesh=mesh, resolve_loop="scan")
    warm = worlds[0][0]["ranks"][0][DI]["warm"]
    states = jax.device_put(broadcast_state(WarmState(*(jnp.asarray(warm[f]) for f in WarmState._fields)), B), rows)
    u0s, kkts = [], []
    for x0 in multihost.x0_draws(pc, cfg["seed"], pc["warmup"] + pc["timed"], B):
        states, u0, kkt, _ = ctrl(states, jax.device_put(jnp.asarray(x0), rows))
        u0s.append(np.asarray(u0))
        kkts.append(np.asarray(kkt))
    return dict(states=[np.asarray(a) for a in jax.device_get(states)], u0s=u0s, kkts=kkts)


def test_two_hosts_are_the_single_host_world_bit_for_bit(worlds):
    """Host h feeds only its own rank's rows; every field of every rank's
    record is the single-host world's, bit for bit, but for clock readings;
    host 0 holds every record and reports, and both hosts hold its verdict."""
    hosts, single = worlds
    h0, h1 = hosts
    assert [h["host"] for h in hosts] == [0, 1] and h0["failed"] == h1["failed"] == []
    assert [r["rank"] for r in h0["ranks"]] == [0, 1] and [r["rank"] for r in h1["local"]] == [1]
    for a, b in zip(h0["ranks"], single[HOSTS]):
        same_record(a, b)
    same_record(h1["local"][0], h0["ranks"][1])
    for r in h0["ranks"]:
        for name in (DI, CP):
            assert r[name]["rows"] == (PER_RANK * r["rank"], PER_RANK * (r["rank"] + 1))
    assert h0["summary"]["failed"] == [] and len(h0["lines"]) == 3, h0["lines"]
    row = h0["summary"]["problems"][DI]["ticks"]
    assert [(t["D"], t["B"]) for t in row] == [(HOSTS, HOSTS * PER_RANK)]
    keys = multihost.jax_keys(h0["summary"], HOSTS)
    assert (keys["n_hosts"], keys["n_chips"], keys["batch"]) == (HOSTS, HOSTS, HOSTS * PER_RANK)
    assert keys["solves_per_s"] == row[0]["solves_per_s"] and keys["kkt_max"] < 1e-10


def test_two_hosts_tick_matches_jax(worlds, jax_ticks):
    """The hosts' double-integrator rows put together are the JAX tick's
    global batch at every tick (u0, KKT) and after the last (the states),
    within 1e-10."""
    ranks = [r[DI] for r in worlds[0][0]["ranks"]]
    for k, (u0, kkt) in enumerate(zip(jax_ticks["u0s"], jax_ticks["kkts"])):
        np.testing.assert_allclose(np.concatenate([t["u0s"][k] for t in ranks]), u0, rtol=0, atol=1e-10)
        np.testing.assert_allclose(np.concatenate([t["kkts"][k] for t in ranks]), kkt, rtol=0, atol=1e-10)
    for i, a in enumerate(jax_ticks["states"]):
        np.testing.assert_allclose(np.concatenate([t["states"][i] for t in ranks]), a, rtol=0, atol=1e-10)
    assert max(k.max() for k in jax_ticks["kkts"]) < 1e-10


def test_rank_layout():
    """Local rank l of host h is global rank h * nproc + l, on card
    l % cards: each host's ranks are a block of the world."""
    assert spmd.rank_layout(2, 3, 1, cards=2) == [(3, 0, 0), (4, 1, 1), (5, 2, 0)]
    assert spmd.rank_layout(1, 2, 0) == [(0, 0, None), (1, 1, None)]
    world = [r for h in range(3) for r, _, _ in spmd.rank_layout(3, 2, h, cards=2)]
    assert world == list(range(6))
    assert multihost.split_rows(12, 4, 2) == slice(6, 9)  # rank 2 = host 1's local rank 0 at nproc 2
    assert spmd.parse_coordinator("node0:8476") == ("node0", 8476)
    assert spmd.parse_coordinator("[::1]:8476") == ("::1", 8476)
    assert spmd.is_loopback("127.0.0.1") and spmd.is_loopback("::1") and spmd.is_loopback("localhost")
    assert not spmd.is_loopback("10.0.0.2") and not spmd.is_loopback("node0")


@pytest.mark.parametrize("kw, match", [
    (dict(host_id=2, num_hosts=2), r"outside \[0, 2\)"),
    (dict(host_id=-1, num_hosts=2), r"outside \[0, 2\)"),
    (dict(host_id=0, num_hosts=0), "at least one host"),
    (dict(coordinator="127.0.0.1", num_hosts=2, host_id=1), "host:port"),
    (dict(coordinator="node0:", num_hosts=2, host_id=1), "host:port"),
    (dict(coordinator=":8476", num_hosts=2, host_id=1), "host:port"),
    (dict(coordinator=None, num_hosts=2, host_id=1), "needs a coordinator"),
    (dict(backend="nccl"), "NCCL group carries CUDA"),
    (dict(backend="nccl", device="cuda", nproc="cards + 1"), "one rank on each card"),
])
def test_refusals(kw, match):
    """A world of hosts no launch can join is refused with ValueError
    before any process is spawned."""
    args = dict(nproc=1, device="cpu", backend="gloo", coordinator="127.0.0.1:8476", num_hosts=2, host_id=1)
    args.update(kw)
    if args["nproc"] == "cards + 1":
        args["nproc"] = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=match):
        spmd.launch(spmd_sleeping_world, args.pop("nproc"), args=(0,), timeout=5, **args)
    assert not multiprocessing.active_children()
    cfg = small_cfg()
    cfg["backend"] = args["backend"]
    cfg["device"] = args["device"]
    if kw.get("nproc") is None:
        with pytest.raises(ValueError, match=match):
            multihost.run_hosts(1, cfg, coordinator=args["coordinator"], num_hosts=args["num_hosts"],
                                host_id=args["host_id"])


def test_host_zero_must_hold_the_coordinators_address():
    """Host 0 serves the rendezvous store: a coordinator address this
    machine cannot listen at fails before any rank is spawned, and the
    command line refuses --num-hosts without --coordinator."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        port = taken.getsockname()[1]
        with pytest.raises(spmd.SPMDError, match="host 0 serves the rendezvous store"):
            spmd.launch(spmd_sleeping_world, 1, device="cpu", backend="gloo", args=(0,),
                        coordinator=f"127.0.0.1:{port}", num_hosts=2, host_id=0, timeout=5)
    assert not multiprocessing.active_children()
    with pytest.raises(SystemExit) as e:
        multihost.main(["--cpu", "--num-hosts", "2", "--host-id", "1"])
    assert e.value.code == 2


def _alone(host_id):
    """Host `host_id` of a world of two, launched alone: (the SPMDError, s)."""
    t0 = time.monotonic()
    try:
        spmd.launch(spmd_sleeping_world, 1, device="cpu", backend="gloo", args=(0,),
                    coordinator=f"127.0.0.1:{spmd._free_port()}", num_hosts=2, host_id=host_id,
                    timeout=MISSING_PEER_TIMEOUT)
    except spmd.SPMDError as e:
        return e, time.monotonic() - t0
    return None, time.monotonic() - t0


def test_missing_peer_ends_within_the_timeout():
    """Host 0 alone (its store waits for a peer that never comes) and host 1
    alone (the coordinator never comes up), side by side, each end in
    SPMDError within the timeout, with no process of theirs left alive."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ends = list(pool.map(_alone, (0, 1)))
    for host_id, (err, secs) in enumerate(ends):
        assert err is not None and f"did not finish within {MISSING_PEER_TIMEOUT:.0f} s" in str(err), (host_id, err)
        assert f"host {host_id} of 2" in str(err), err
        # the limit, then at most a terminate's and a kill's waits
        assert secs < MISSING_PEER_TIMEOUT + 12.0, (host_id, secs)
    assert not multiprocessing.active_children()


@pytest.mark.cuda
def test_two_hosts_share_one_card_over_gloo(tmp_path):
    """Two host processes, one rank each on the one card, over gloo:
    rank 0's ticks bitwise a one-rank NCCL world's (the same rows, draws and
    cold start), ticks x 3 CR launches on both ranks, the scan kernel in
    each rank's cold start, every check of `report` passed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CR and scan kernels have no CPU mode")
    cfg = small_cfg("cuda")
    one = multihost.run(1, cfg, timeout=WORLD_TIMEOUT)[1][0]
    hosts = multihost.loopback_hosts(1, dict(cfg, backend="gloo"), HOSTS, tmp_path, timeout=WORLD_TIMEOUT)
    h0 = hosts[0]
    assert h0["failed"] == [] and hosts[1]["failed"] == [], h0["failed"]
    for name in (DI, CP):
        assert h0["ranks"][0][name]["digest"] == one[name]["digest"], name
        for r in h0["ranks"]:
            t = r[name]
            assert t["replay"]["launches"] == 3 * t["ticks"] and t["graphed"], t
            assert t["cold"]["scan_launches"] == t["cold"]["block_solves"] > 0, t["cold"]
