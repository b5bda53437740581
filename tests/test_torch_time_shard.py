"""Time-axis sharding: the port's distributed cyclic reduction
(ctdirect_tpu_torch.parallel.time_shard) against the JAX package's on a mesh
of the same size D, and against the port's unsharded CR, float64, CPU.

The port runs in one gloo world of WORLD spawned processes
(ctdirect_tpu_torch.parallel.spmd.launch) whose worker,
torch_helpers.spmd_time_shard_world, imports no JAX: D=4 is a 1-D mesh over
the world, D=2 the time axis of a 2 x 2 mesh, D=1 that of a 4 x 1 mesh. The
JAX side runs on D of the 8 virtual CPU devices of tests/conftest.py.
Tolerances as tests/test_parallel.py: atol 1e-10 (1 + max |x|).

The time-sharded solve as the card compiles it (the B=1 program of
solver/interface.py::DOCPSolver with kkt=TimeShardedKKT) runs here op by op
(`BatchGraph(capture=False)`): held to the eager ipm_solve and to the JAX
package's, free of capture hazards, its ranks in lockstep. On the card
(marked `cuda`, skipped without one; no JAX needed: `python -m pytest
--noconftest -p no:cacheprovider -m cuda tests/test_torch_time_shard.py`):
a one-rank NCCL world whose distributed CR and time-sharded solve replay
CUDA graphs with their messages inside, against their eager forms."""

import numpy as np
import pytest
import torch

from torch_helpers import (
    WORLD,
    WORLD_TIMEOUT,
    random_chain_lanes,
    spmd_refusals_world,
    spmd_time_shard_world,
)

# (D, N, bs, wb, B, seed): N=13 pads to 16 (local levels on every rank);
# N=D leaves one block per rank (no local level); D=1 solves on one rank
CHAINS = [(2, 13, 5, 7, 2, 0), (4, 13, 5, 7, 2, 1), (2, 2, 5, 7, 2, 2), (4, 4, 5, 7, 2, 3), (1, 13, 5, 7, 2, 4)]
# tests/test_parallel.py's fast cell and its seeded inputs (:51-66)
KKT_CASE = dict(name="double_integrator_minenergy", scheme="trapeze", grid_size=32)
# tests/test_parallel.py::test_time_sharded_full_solve
IPM_CASE = dict(name="beam", scheme="trapeze", grid_size=16, options=dict(tol=1e-8, lsq_lambda_init=False))


def jmesh(D, axis="time"):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:D]), axis_names=(axis,))


def kkt_inputs():
    from ctdirect_tpu.problems import get_problem

    from torch_helpers import jax_docp

    rng = np.random.default_rng(5)
    p = get_problem(KKT_CASE["name"])
    d = jax_docp(KKT_CASE["name"], grid_size=KKT_CASE["grid_size"], scheme=KKT_CASE["scheme"])
    return dict(
        z=d.initial_guess(p.init) + 0.01 * rng.standard_normal(d.nz),
        lam=rng.standard_normal(d.nc),
        sigma=rng.uniform(0.1, 2.0, d.nz),
        Drow=rng.uniform(0.0, 1.0, d.nc),
        rz=rng.standard_normal(d.nz),
        rp=rng.standard_normal(d.nc),
    )


@pytest.fixture(scope="module")
def inputs():
    return kkt_inputs()


@pytest.fixture(scope="module")
def world(inputs):
    from ctdirect_tpu_torch.parallel.spmd import launch

    ranks = launch(spmd_time_shard_world, WORLD, device="cpu", backend="gloo",
                   args=(CHAINS, dict(KKT_CASE, inputs=inputs), IPM_CASE), timeout=WORLD_TIMEOUT)
    return ranks


def test_world_imports_no_jax(world):
    assert not any(r["jax_loaded"] for r in world)


@pytest.mark.parametrize("case", range(len(CHAINS)), ids=[f"D{c[0]}-N{c[1]}" for c in CHAINS])
def test_dcr_solve_matches_jax_and_plain(world, case):
    """make_sharded_tridiag_solver at D ranks against the JAX package's at D
    devices (lane by lane) and against the port's unsharded cr_solve_lanes;
    every rank holds the same result; on the CPU nothing is captured."""
    import jax
    import jax.numpy as jnp
    from ctdirect_tpu.parallel.time_shard import make_sharded_tridiag_solver as solver_j

    from ctdirect_tpu_torch.parallel.time_shard import padded_len

    D, N, bs, wb, B, seed = CHAINS[case]
    A, Bp, E, F, r, rb = random_chain_lanes(N, bs, wb, B, seed=seed)
    got = world[0]["chains"][case]
    for other in world[1:]:
        np.testing.assert_array_equal(other["chains"][case]["X"], got["X"])
        np.testing.assert_array_equal(other["chains"][case]["xb"], got["xb"])
    solve_j = jax.jit(solver_j(jmesh(D), "time", N, bs, wb))
    for b in range(B):
        Xj, xbj = solve_j(*(jnp.asarray(x[..., b]) for x in (A, Bp[:-1], E, F, r, rb)))
        atol = 1e-10 * (1 + np.max(np.abs(np.asarray(Xj))))
        np.testing.assert_allclose(got["X"][..., b], np.asarray(Xj), rtol=0, atol=atol)
        np.testing.assert_allclose(got["xb"][..., b], np.asarray(xbj), rtol=0, atol=atol)
    atol = 1e-10 * (1 + np.max(np.abs(got["X_plain"])))
    np.testing.assert_allclose(got["X"], got["X_plain"], rtol=0, atol=atol)
    np.testing.assert_allclose(got["xb"], got["xb_plain"], rtol=0, atol=atol)
    # per local level a halo each way (a send and a receive, one of them on
    # the edge ranks) down and up; one psum, one gather of the roots, one of X
    levels = int(np.log2(padded_len(N, D) // D))
    for r in world:
        c = r["chains"][case]
        assert c["staged"] == 0 and c["graphs"] == 0
        assert c["messages"] == 2 * levels * ((c["rank"] > 0) + (c["rank"] < D - 1)) + 3


@pytest.mark.parametrize("D", [1, 2, 4])
def test_time_sharded_kkt_matches_jax(world, inputs, D):
    """TimeShardedKKT.solve against the JAX TimeShardedKKT.solve at the same
    D, on tests/test_parallel.py's fast cell."""
    import jax
    import jax.numpy as jnp
    from ctdirect_tpu.parallel.time_shard import TimeShardedKKT as TSJ

    from torch_helpers import jax_docp

    d = jax_docp(KKT_CASE["name"], grid_size=KKT_CASE["grid_size"], scheme=KKT_CASE["scheme"])
    kkt = TSJ(d, jmesh(D), axis="time")
    j = {k: jnp.asarray(v) for k, v in inputs.items()}

    @jax.jit
    def step(z, lam, sigma, Drow, rz, rp):
        data = kkt.prepare(z, lam, jnp.asarray(1.0), jnp.ones(d.nc))
        return kkt.solve(data, sigma, Drow, 1e-6, 1e-7, rz, rp)

    dz, dlam = step(j["z"], j["lam"], j["sigma"], j["Drow"], j["rz"], j["rp"])
    got = world[0]["kkt"][D]
    scale = 1 + np.max(np.abs(np.asarray(dz)))
    np.testing.assert_allclose(got["dz"], np.asarray(dz), rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(got["dlam"], np.asarray(dlam), rtol=0, atol=1e-10 * scale)
    assert got["block_solves"] == 1


def test_time_sharded_full_solve_matches_jax(world):
    """The full IPM with TimeShardedKKT at D=4 (beam, trapeze, N=16) reaches
    the JAX run's status and objective (tests/test_parallel.py:72-93)."""
    res = jax_full_solve(4)
    for r in world:
        assert r["ipm"]["status"] == int(res.status) == 0
        np.testing.assert_allclose(r["ipm"]["objective"], float(res.objective), rtol=1e-8)
    assert world[0]["ipm"]["block_solves"] >= world[0]["ipm"]["iterations"] > 0


def jax_full_solve(D):
    """The JAX package's jitted ipm_solve with its TimeShardedKKT over D
    devices on IPM_CASE."""
    import jax
    import jax.numpy as jnp
    from ctdirect_tpu import transcribe
    from ctdirect_tpu.parallel.time_shard import TimeShardedKKT as TSJ
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.ipm import IPMOptions, ipm_solve, make_spec

    d = transcribe(get_problem(IPM_CASE["name"]).ocp, grid_size=IPM_CASE["grid_size"], scheme=IPM_CASE["scheme"])
    spec = make_spec(d._z_lb, d._z_ub, d._c_lb, d._c_ub)
    kkt = TSJ(d, jmesh(D), axis="time")
    return jax.jit(lambda z0: ipm_solve(d.nlp_objective, d.constraints, spec, z0, d._z_lb, d._z_ub, d._c_lb,
                                        d._c_ub, options=IPMOptions(**IPM_CASE["options"]), kkt=kkt))(
        jnp.asarray(d.initial_guess(None)))


def test_time_sharded_b1_program_matches_eager_and_jax(world):
    """The time-sharded solve as the card compiles it (DOCPSolver(kkt=
    TimeShardedKKT): the B=1 program, run op by op) at D=2: the eager
    ipm_solve's status and iterations, z within 1e-10; the JAX run's status
    and objective over a mesh of 2 (as the D=4 test). On the CPU the solver
    runs eagerly (graphed false)."""
    res = jax_full_solve(2)
    for r in world:
        b1 = r["b1"]
        assert (b1["status"], b1["iterations"]) == (b1["eager"]["status"], b1["eager"]["iterations"])
        np.testing.assert_allclose(b1["z"], b1["eager"]["z"], rtol=0, atol=1e-10)
        assert b1["status"] == int(res.status) == 0
        np.testing.assert_allclose(b1["objective"], float(res.objective), rtol=1e-8)
        assert not b1["graphed"] and b1["messages"] > 0


def test_time_sharded_b1_segments_make_no_capture_hazard(world):
    """No segment of the time-sharded B=1 program makes a call a CUDA graph
    capture refuses (`CaptureHazards`, on every rank)."""
    for r in world:
        assert r["b1"]["hazards"] == [], r["b1"]["hazards"]


def test_time_group_ranks_stay_in_lockstep(world):
    """Every rank of a time axis holds the same bytes where the sharded solve
    hands them over: the distributed CR's X and xb on every chain, and so
    the time-sharded solve's z and every flag read of its B=1 program, in
    order (ranks whose reads differed would leave lockstep and hang in the
    next collective)."""
    ref = world[0]
    assert len(ref["b1"]["flags"]) > 0
    for r in world[1:]:
        for mine, theirs in zip(r["chains"], ref["chains"]):
            np.testing.assert_array_equal(mine["X"], theirs["X"])
            np.testing.assert_array_equal(mine["xb"], theirs["xb"])
        assert r["b1"]["flags"] == ref["b1"]["flags"]
        np.testing.assert_array_equal(r["b1"]["z"], ref["b1"]["z"])
    assert {r["b1"]["time_rank"] for r in world} == {0, 1}


@pytest.mark.cuda
def test_nccl_one_rank_graphs_equal_eager_on_card():
    """A one-rank NCCL world on the card (time=1), through shard_timing's
    run and checks: the distributed CR on a short chain replays one graph,
    bitwise its eager form and within 1e-10 x scale of the CR kernel, each
    replay adding the root's kernel launch and the psum and two gathers to
    the counts; Goddard config 2 through DOCPSolver(kkt=TimeShardedKKT) is
    graphed, its replay the first call bit for bit, with the eager
    ipm_solve's status and objective to 1e-8; a profiled replay of the
    distributed CR sees its CR kernel launches; nothing is staged through
    the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL and the CR kernel have no CPU mode")
    from ctdirect_tpu_torch import shard_timing

    cfg = dict(chains={"short": (16, 5, 7, 3)}, chain_sizes=[1], goddard_sizes=[1])
    ranks = shard_timing.run(1, cfg, timeout=WORLD_TIMEOUT)
    shard_timing.report(ranks, cfg, log=lambda m: None)
    c, g = ranks[0]["chains"][0], ranks[0]["goddard"][0]
    assert c["graphs"] == 1 and c["bitwise"], c
    assert (c["messages"], c["launches"], c["staged"]) == (3, 1, 0), c
    assert c["profiled"]["seen"] == 3, c
    assert g["graphed"] and g["captures"] > 0 and g["status"] == (0, 0, 0) and g["replay_first"] == 0.0, g
    assert g["launches"] > 0 and g["grid_launches"] == 3 * g["launches"], g


def test_refusals():
    """What the port refuses: a time axis whose size is not a power of two,
    a batch that does not split over its axis (a world of 3; the JAX
    BatchSolver accepts that split, a deliberate deviation), an unknown
    backend, NCCL on CPU tensors or with more ranks than cards."""
    import jax.numpy as jnp
    from ctdirect_tpu.parallel.batch import BatchSolver as BatchJ
    from ctdirect_tpu.solver.ipm import IPMOptions

    from ctdirect_tpu_torch.parallel.spmd import check_backend, launch
    from ctdirect_tpu_torch.parallel.time_shard import _staged, padded_len
    from torch_helpers import jax_docp

    msgs = launch(spmd_refusals_world, 3, device="cpu", backend="gloo", args=(6,), timeout=WORLD_TIMEOUT)
    for m in msgs:
        assert "power-of-two" in m["tridiag"] and "power-of-two" in m["kkt"], m
        assert "does not split" in m["batch"], m
    d = jax_docp(grid_size=6)
    res = BatchJ(d, options=IPMOptions(tol=1e-6, max_iter=5), mesh=jmesh(3, "batch"))(
        jnp.asarray(np.tile(d.initial_guess(None), (4, 1))))
    assert np.asarray(res.status).shape == (4,)
    with pytest.raises(ValueError, match="power-of-two"):
        padded_len(13, 6)
    with pytest.raises(ValueError, match="unknown backend"):
        launch(spmd_refusals_world, 2, device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="NCCL group carries CUDA"):
        launch(spmd_refusals_world, 2, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="one rank on each card"):
        check_backend("nccl", "cuda", torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="NCCL group carries CUDA"):
        _staged("nccl", torch.zeros(2))
    with pytest.raises(ValueError, match="unknown backend"):
        _staged("ucc", torch.zeros(2))
    assert _staged("gloo", torch.zeros(2)) is False


def test_launch_stops_failed_and_late_worlds():
    """A rank that raises fails the launch with its traceback, and a world
    that outlives its limit is stopped; no process is left behind."""
    import multiprocessing

    from ctdirect_tpu_torch.parallel.spmd import SPMDError, launch
    from torch_helpers import spmd_failing_world, spmd_sleeping_world

    with pytest.raises(SPMDError, match="rank 1 fails on purpose"):
        launch(spmd_failing_world, 3, device="cpu", backend="gloo", timeout=WORLD_TIMEOUT)
    with pytest.raises(SPMDError, match="did not finish within"):
        launch(spmd_sleeping_world, 2, device="cpu", backend="gloo", args=(120,), timeout=10)
    assert not multiprocessing.active_children()
