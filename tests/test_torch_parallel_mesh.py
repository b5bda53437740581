"""The mesh paths of ctdirect_tpu_torch.parallel against the JAX package's on
a mesh of the same shape, float64, CPU: BatchSolver(mesh=) over a batch axis
of 4, the 1-D batch-sharded MPC tick, the 2-D (batch 2 x time 2) tick and
the 2-D tick over a time axis of one rank (batch 4 x time 1), and the five
legs of ctdirect_tpu_torch.entry.dryrun_multichip.

The port runs in gloo worlds of WORLD spawned processes
(ctdirect_tpu_torch.parallel.spmd.launch; worker
torch_helpers.spmd_mesh_world, which imports no JAX); rank i of a batch axis
of D holds rows [i B/D, (i+1) B/D) of the JAX call's global batch. The JAX
side runs on 4 of the 8 virtual CPU devices of tests/conftest.py. On the
card (marked `cuda`, skipped without one; no JAX needed: `python -m pytest
--noconftest -p no:cacheprovider -m cuda tests/test_torch_parallel_mesh.py`):
the 2-D tick in a one-rank NCCL world replays one CUDA graph with its
messages inside, held to the eager tick."""

import numpy as np
import pytest
import torch

from torch_helpers import WORLD, WORLD_TIMEOUT, jax_docp, spmd_mesh_world

# tests/test_parallel.py::test_batch_solver_sharded, at B=16 over 4 ranks
BATCH = dict(grid_size=12, options=dict(tol=1e-6, max_iter=20), B=16)
# tests/test_parallel.py::test_mpc_controller_converges: N=30, B=4, 2 ticks
TICK = dict(grid_size=30, iters=3, B=4, ticks=2)


def jmesh(shape, names):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[: int(np.prod(shape))]).reshape(shape), axis_names=names)


def batch_inputs():
    d = jax_docp(grid_size=BATCH["grid_size"])
    B = BATCH["B"]
    z0 = np.tile(d.initial_guess(None), (B, 1))
    zl, zu = np.tile(d._z_lb, (B, 1)), np.tile(d._z_ub, (B, 1))
    cols = d.control_col_indices()
    scale = np.linspace(0.9, 1.1, B)[:, None]  # dryrun leg 4's dispersion
    zl[:, cols] *= scale
    zu[:, cols] *= scale
    return dict(BATCH, z0=z0, zl=zl, zu=zu)


@pytest.fixture(scope="module")
def jax_runs():
    import jax
    import jax.numpy as jnp
    from ctdirect_tpu.parallel.batch import BatchSolver
    from ctdirect_tpu.parallel.mpc import MPCController, broadcast_state
    from ctdirect_tpu.solver.ipm import IPMOptions

    bc = batch_inputs()
    d = jax_docp(grid_size=BATCH["grid_size"])
    solver = BatchSolver(d, options=IPMOptions(**BATCH["options"]), mesh=jmesh((4,), ("batch",)))
    batch = solver(jnp.asarray(bc["z0"]))
    boxes = solver(jnp.asarray(bc["z0"]), zl_batch=jnp.asarray(bc["zl"]), zu_batch=jnp.asarray(bc["zu"]))

    d = jax_docp(grid_size=TICK["grid_size"])
    cold = MPCController(d, x0_boundary_rows=[0, 1], resolve_iters=TICK["iters"], kkt_algorithm="cr")
    warm = jax.device_get(cold.cold_start(options=IPMOptions(tol=1e-8, max_iter=40)))
    x0 = 0.02 * np.random.default_rng(0).standard_normal((TICK["B"], 2))
    ticks = {}
    for key, mesh, kw in (
        ("tick", jmesh((4,), ("batch",)), dict(kkt_algorithm="cr")),
        ("tick_2d", jmesh((2, 2), ("batch", "time")), dict(time_axis="time")),
        ("tick_2d_t1", jmesh((4, 1), ("batch", "time")), dict(time_axis="time")),
    ):
        ctrl = MPCController(d, x0_boundary_rows=[0, 1], resolve_iters=TICK["iters"], mesh=mesh, **kw)
        states = broadcast_state(warm, TICK["B"])
        for _ in range(TICK["ticks"]):
            states, u0, kkt, viol = ctrl(states, jnp.asarray(x0))
        ticks[key] = jax.device_get(dict(states=list(states), u0=u0, kkt=kkt, viol=viol))
    return dict(batch_inputs=bc, batch=jax.device_get(batch), boxes=jax.device_get(boxes),
                warm={f: np.asarray(getattr(warm, f)) for f in warm._fields}, x0=x0, **ticks)


@pytest.fixture(scope="module")
def world(jax_runs):
    from ctdirect_tpu_torch.parallel.spmd import launch

    tick_case = dict(TICK, warm=jax_runs["warm"], x0=jax_runs["x0"])
    return launch(spmd_mesh_world, WORLD, device="cpu", backend="gloo",
                  args=(jax_runs["batch_inputs"], tick_case), timeout=WORLD_TIMEOUT)


def test_world_imports_no_jax(world):
    assert not any(r["jax_loaded"] for r in world)


@pytest.mark.parametrize("key", ["batch", "boxes"])
def test_batch_solver_mesh_matches_jax(jax_runs, world, key):
    """BatchSolver(mesh=) at D=4, B=16 (and with per-instance zl/zu): every
    rank returns the global result; statuses equal, objectives to 1e-8."""
    want = jax_runs[key]
    for r in world:
        got = r[key]
        np.testing.assert_array_equal(got["status"], np.asarray(want.status))
        np.testing.assert_allclose(got["objective"], np.asarray(want.objective), rtol=1e-8)
        np.testing.assert_allclose(got["z"], np.asarray(want.z), rtol=0, atol=1e-8)
        np.testing.assert_array_equal(got["z"], world[0][key]["z"])
    assert (np.asarray(want.status) == 0).all()


# the ticks: the mesh key -> the batch shards it has over the world of 4
TICK_SHARDS = {"tick": 4, "tick_2d": 2, "tick_2d_t1": 4}


@pytest.mark.parametrize("key", sorted(TICK_SHARDS))
def test_sharded_tick_matches_jax(jax_runs, world, key):
    """The ranks' rows, put together, are the JAX tick's global result after
    2 ticks from one warm state (states, u0, KKT to 1e-10); on the 2 x 2
    mesh the two ranks of a time group hold the same rows and agree to
    1e-13; a time axis of one rank solves its chain alone."""
    want = jax_runs[key]
    B = TICK["B"]
    by_rows = {}
    for r in world:
        by_rows.setdefault(r[key]["rows"], []).append(r[key])
    assert sorted(by_rows) == [(i * B // len(by_rows), (i + 1) * B // len(by_rows)) for i in range(len(by_rows))]
    assert len(by_rows) == TICK_SHARDS[key]
    for (lo, hi), group in by_rows.items():
        got = group[0]
        for a, b in zip(got["states"], want["states"]):
            np.testing.assert_allclose(a, np.asarray(b)[lo:hi], rtol=0, atol=1e-10)
        for f in ("u0", "kkt", "viol"):
            np.testing.assert_allclose(got[f], np.asarray(want[f])[lo:hi], rtol=0, atol=1e-10)
        assert got["kkt"].max() < 1e-10
        for other in group[1:]:
            for a, b in zip(other["states"] + [other["u0"], other["kkt"]], got["states"] + [got["u0"], got["kkt"]]):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-13)
        assert got["block_solves"] == TICK["ticks"] * TICK["iters"]


@pytest.mark.parametrize("key", sorted(TICK_SHARDS))
def test_sharded_tick_makes_no_capture_hazard(world, key):
    """No rank's first tick makes a call a CUDA graph capture refuses
    (`CaptureHazards`): over NCCL the card captures these ticks, the 2-D
    ones with their messages; on the CPU they run eagerly."""
    for r in world:
        assert r[key]["hazards"] == [], r[key]["hazards"]
        assert not r[key]["graphed"]


@pytest.mark.cuda
def test_nccl_one_rank_2d_tick_replays_on_card():
    """The 2-D tick over batch=1 x time=1 in a one-rank NCCL world on the
    card, through shard_timing's run and checks: graphed, one capture, each
    replay within 1e-13 of the eager tick from the same state (bitwise
    expected), max KKT < 1e-10, u0 within 1e-10 of the unsharded tick, each
    replay adding the distributed solves' messages (3 per solve: a psum and
    two gathers, none staged); a profiled replay sees the root solves' CR
    kernel launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL and the CR kernel have no CPU mode")
    from ctdirect_tpu_torch import shard_timing

    tick = dict(shard_timing.TICK, B=4, N=8, iters=2, warmup=1, timed=2, time=1, one_card=True)
    cfg = dict(tick=tick)
    ranks = shard_timing.run(1, cfg, timeout=WORLD_TIMEOUT)
    shard_timing.report(ranks, cfg, log=lambda m: None)
    t = ranks[0]["tick"]
    assert t["graphed"] and t["captures"] == 1 and t["replay_eager"] <= 1e-13, t
    assert t["replay"]["messages"] == 3 * 2 * t["ticks"] and t["replay"]["staged"] == 0, t
    assert t["profiled"]["seen"] == 3 * 2, t


def test_dryrun_multichip_passes_all_legs(capsys):
    """The port's dryrun_multichip on a gloo world of 4 CPU ranks: all five
    legs, one line each; every rank holds the same global batch results."""
    from ctdirect_tpu_torch.entry import dryrun_multichip

    ranks = dryrun_multichip(4, device="cpu", backend="gloo", timeout=WORLD_TIMEOUT)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5 and all(" OK" in line for line in lines), lines
    assert len(ranks) == 4
    for r in ranks:
        assert set(r) == {"batch", "time", "tick", "boxes", "tick_2d"}
        for key in ("batch", "boxes"):
            assert (r[key]["status"] == 0).all()
            np.testing.assert_array_equal(r[key]["z"], ranks[0][key]["z"])
        assert r["tick"]["kkt"] < 1e-10 and r["tick_2d"]["kkt"] < 1e-10
        assert r["time"]["staged"] == 0 and r["time"]["messages"] > 0


def test_kkt_factory_takes_precedence():
    """MPCController(kkt_factory=) ticks with the factory's operator, as the
    JAX controller does (mpc.py:90-91), and no other."""
    from ctdirect_tpu_torch.parallel import MPCController, broadcast_state
    from ctdirect_tpu_torch.solver.ipm import IPMOptions
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT
    from torch_helpers import torch_docp

    d = torch_docp(grid_size=6)
    made = []

    def factory(docp):
        made.append(StructuredKKT(docp, algorithm="cr"))
        return made[-1]

    ctrl = MPCController(d, [0, 1], resolve_iters=2, kkt_algorithm="scan", kkt_factory=factory, device="cpu")
    assert len(made) == 1 and ctrl.kkt is made[0]
    warm = ctrl.cold_start(options=IPMOptions(tol=1e-8, max_iter=40))
    before = made[0].block_solves
    _, u0, kkt, _ = ctrl(broadcast_state(warm, 2), torch.zeros(2, 2, dtype=torch.float64))
    assert made[0].block_solves == before + 2 and kkt.max() < 1e-8
