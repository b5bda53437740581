"""ctdirect_tpu_torch.multihost (BASELINE config 5: the batch-sharded tick
and BatchSolver across ranks) on the CPU: its run and checks in gloo worlds
of 1 and 2 ranks (one `multihost.run(2, cfg)` for the module), the ticks
held to the JAX package's MPCController(mesh=) on 2 of the 8 virtual CPU
devices of tests/conftest.py from the same warm state over the same x0
draws, rank 0's rows held bit for bit across D, `report`'s arithmetic on
synthetic rank records, and the refusals. On the card (marked `cuda`,
skipped without one; no JAX needed: `python -m pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_multihost.py`): a one-rank NCCL
world through run and report at small sizes."""

import numpy as np
import pytest
import torch

from ctdirect_tpu_torch import multihost
from torch_helpers import WORLD_TIMEOUT

DI, CP = "double_integrator_minenergy", "cartpole"
# tests/test_torch_parallel_mesh.py's tick (N=30, 3 Newton steps, 2 ticks)
# over 2 ranks x 2 rows; cart-pole at N=20; the scenario batch 2 a rank
SMALL = {DI: dict(N=30), CP: dict(N=20, solver=dict(multihost.PROBLEMS[CP]["solver"], batch_per_chip=2))}
PER_RANK, D = 2, 2
RTOL = {DI: 0.0, CP: 1e-10}


def small_cfg(device="cpu"):
    cfg = multihost.default_cfg(ticks=1, device=device)
    for name, pc in cfg["problems"].items():
        pc.update(SMALL[name], batch_per_chip=PER_RANK, warmup=1, eager=2)
    return dict(cfg, arrays=True)


@pytest.fixture(scope="module")
def cfg():
    return small_cfg()


@pytest.fixture(scope="module")
def worlds(cfg):
    return multihost.run(D, cfg, timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def jax_ticks(cfg, worlds):
    """The JAX package's batch-sharded tick over a mesh of 2 devices, from
    the port's warm state, over the same global x0 draws."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from ctdirect_tpu import transcribe
    from ctdirect_tpu.parallel.mpc import MPCController, broadcast_state
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.resolve import WarmState

    mesh = Mesh(np.array(jax.devices()[:D]), axis_names=("batch",))
    rows = NamedSharding(mesh, PartitionSpec("batch"))
    out = {}
    for name, pc in cfg["problems"].items():
        B = PER_RANK * D
        d = transcribe(get_problem(name).ocp, grid_size=pc["N"], scheme="trapeze")
        # the Newton steps as a loop ("the identical iteration", tests/test_lanes.py), which
        # compiles in a third of the unrolled steps' time; the inputs sharded as the outputs
        # are, so that the second tick does not compile again
        ctrl = MPCController(d, x0_boundary_rows=list(pc["rows"]), resolve_iters=pc["iters"], kkt_algorithm="cr",
                             mesh=mesh, resolve_loop="scan")
        warm = worlds[D][0][name]["warm"]
        states = jax.device_put(broadcast_state(WarmState(*(jnp.asarray(warm[f]) for f in WarmState._fields)), B),
                                rows)
        u0s, kkts = [], []
        for x0 in multihost.x0_draws(pc, cfg["seed"], pc["warmup"] + pc["timed"], B):
            states, u0, kkt, _ = ctrl(states, jax.device_put(jnp.asarray(x0), rows))
            u0s.append(np.asarray(u0))
            kkts.append(np.asarray(kkt))
        out[name] = dict(states=[np.asarray(a) for a in jax.device_get(states)], u0s=u0s, kkts=kkts)
    return out


def test_run_passes_its_checks(cfg, worlds):
    """Every check of `report` holds in both worlds: the tick bitwise its
    eager form, the block solves ticks x 3, no message in the tick and one
    a tick in the isolation loop, the DI KKT below 1e-10, the scenario
    batch's replay its first call and rank 0's rows its eager solve."""
    lines = []
    summary = multihost.report(worlds, cfg, log=lines.append)
    assert summary["failed"] == [], summary["failed"]
    assert sorted(worlds) == [1, 2] and [len(worlds[k]) for k in (1, 2)] == [1, 2]
    assert len(lines) == 2 * 2 + 2, lines  # a tick line per (problem, D), a BatchSolver line per D
    for name in (DI, CP):
        assert [row["B"] for row in summary["problems"][name]["ticks"]] == [PER_RANK, PER_RANK * D]
    for r in worlds[D]:
        t = r[DI]
        assert t["rows"] == (PER_RANK * r["rank"], PER_RANK * (r["rank"] + 1))
        assert t["replay"]["messages"] == 0 and t["dp"]["messages"] == t["timed"]
        assert t["replay"]["block_solves"] == 3 * t["ticks"] and t["replay"]["launches"] == 0  # the plain CR
        assert {q[DI]["dp_kkt_max"] for q in worlds[D]} == {t["dp_kkt_max"]}  # the all_reduce MAX
        assert not t["graphed"] and t["bitwise"]


@pytest.mark.parametrize("name", [DI, CP])
def test_sharded_tick_matches_jax(worlds, jax_ticks, name):
    """The ranks' rows put together are the JAX tick's global batch at every
    tick (u0, KKT) and after the last (the states), to 1e-10."""
    want = jax_ticks[name]
    ranks = [r[name] for r in worlds[D]]
    # cart-pole's 3 Newton steps do not converge: its KKT and multipliers reach 10-80, where
    # the two packages' rounding parts them by a few 1e-12 relative; 1e-10 relative there too
    rtol = RTOL[name]
    for k, (u0, kkt) in enumerate(zip(want["u0s"], want["kkts"])):
        np.testing.assert_allclose(np.concatenate([t["u0s"][k] for t in ranks]), u0, rtol=rtol, atol=1e-10)
        np.testing.assert_allclose(np.concatenate([t["kkts"][k] for t in ranks]), kkt, rtol=rtol, atol=1e-10)
    for i, a in enumerate(want["states"]):
        np.testing.assert_allclose(np.concatenate([t["states"][i] for t in ranks]), a, rtol=rtol, atol=1e-10)
    if name == DI:
        assert max(k.max() for k in want["kkts"]) < 1e-10


@pytest.mark.parametrize("name", [DI, CP])
def test_rank0_rows_bitwise_across_worlds(worlds, name):
    """Rank 0 ticks the same rows from the same warm state over the same
    draws at D=1 and D=2: the same bytes (and the same scenario batch)."""
    one, two = worlds[1][0][name], worlds[D][0][name]
    for key in ("u0s", "kkts", "states"):
        for a, b in zip(one[key], two[key]):
            np.testing.assert_array_equal(a, b)
    for f in one["warm"]:
        np.testing.assert_array_equal(one["warm"][f], two["warm"][f])
    assert one["digest"] == two["digest"]
    if name == CP:
        # every rank holds the gathered batch and digests rank 0's rows of it
        assert one["solver"]["digest"] == two["solver"]["digest"] == worlds[D][1][name]["solver"]["digest"]


def test_x0_draws_do_not_depend_on_the_batch():
    pc = multihost.PROBLEMS[CP]
    small, big = multihost.x0_draws(pc, 0, 3, 4), multihost.x0_draws(pc, 0, 3, 10)
    for a, b in zip(small, big):
        np.testing.assert_array_equal(a, b[:4])
    assert not np.array_equal(small[0], small[1])
    np.testing.assert_array_equal(multihost.scenario_x0(pc, 0, 8), 0.02 * np.random.default_rng(0).standard_normal(
        (8, 4)) * np.array([1, 1, 0.5, 0.5]))


def _synthetic(D, host_ms, dp_ms, B_local=8):
    """Rank records of a clean CPU run of the double integrator at D ranks
    with the given per-rank host and isolation-loop ms a tick."""
    timed, ticks = 4, 6
    ranks = []
    for r in range(D):
        t = dict(B=B_local * D, rows=(r * B_local, (r + 1) * B_local), ticks=ticks, timed=timed, graphed=False,
                 captures=0, cold_s=1.0, first_s=0.1, capture_s=0.0, pool_mib=0.0, p50=host_ms[r] - 0.5,
                 p90=host_ms[r] + 0.5, host_ms=host_ms[r], dp_host_ms=dp_ms[r], slowest_host_ms=max(host_ms),
                 slowest_dp_host_ms=max(dp_ms), dp_kkt_max=1e-15,
                 replay=dict(messages=0, block_solves=3 * ticks, launches=0, grid_launches=0),
                 dp=dict(messages=timed, block_solves=3 * timed, launches=0, grid_launches=0),
                 eager=dict(p50=50.0, ticks=6), replay_eager=0.0, bitwise=True, kkt_max=1e-15, u0_finite=True,
                 u0_absmax=1.0, digest="same" if r == 0 else f"rank{r}", peak_mib=None, peak_reserved_mib=None,
                 peak_with_eager_mib=None, per=24, P=128)
        ranks.append({"rank": r, "size": D, "device": "cpu", "card": "cpu", DI: t})
    return ranks


def test_report_takes_the_slowest_rank():
    """The slowest rank's host ms sets the tick; solves/s, the per-card
    rate, linearity against D=1 and the all-reduce delta follow from it;
    a rank whose all-reduced time is not the ranks' max fails."""
    cfg = dict(problems={DI: dict(multihost.PROBLEMS[DI], iters=3)})
    results = {1: _synthetic(1, [10.0], [10.5]), 2: _synthetic(2, [11.0, 12.5], [12.0, 14.0])}
    summary = multihost.report(results, cfg, log=lambda m: None)
    assert summary["failed"] == []
    one, two = summary["problems"][DI]["ticks"]
    assert one["ms_per_tick"] == 10.0 and one["solves_per_s"] == 8 / 10e-3 and one["linearity"] == 1.0
    assert two["ms_per_tick"] == 12.5 and two["p50"] == 12.0 and two["p90"] == 13.0
    assert two["solves_per_s"] == 16 / 12.5e-3 and two["solves_per_s_per_chip"] == 8 / 12.5e-3
    assert two["linearity"] == pytest.approx(10.0 / 12.5, rel=1e-15)
    assert two["ms_per_tick_with_dp_allreduce"] == 14.0 and two["dp_allreduce_cost_ms"] == 1.5
    results[2][1][DI]["slowest_host_ms"] = 11.0
    results[2][1][DI]["digest"] = results[2][0][DI]["digest"] = "other"
    failed = multihost.report(results, cfg, log=lambda m: None)["failed"]
    assert len(failed) == 2 and "not the ranks' max" in failed[0] and "differ from the D=1" in failed[1], failed


def test_refusals(monkeypatch):
    """A batch that does not split over its ranks, a per-card batch that is
    not a positive integer and an NCCL world of more ranks than cards are
    refused before any world is spawned; without a card and without --cpu
    the script exits non-zero."""
    with pytest.raises(ValueError, match="does not split"):
        multihost.split_rows(10, 4, 0)
    assert multihost.split_rows(12, 4, 3) == slice(9, 12)
    bad = small_cfg()
    bad["problems"][DI]["batch_per_chip"] = 0
    with pytest.raises(ValueError, match="positive integer"):
        multihost.run(1, bad)
    with pytest.raises(ValueError, match="one rank on each card"):
        multihost.run(torch.cuda.device_count() + 1, multihost.default_cfg())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        multihost.main(["--nproc", "1"])
    assert e.value.code == 1
    assert multihost.sizes_up_to(4) == [1, 2, 4] and multihost.sizes_up_to(3) == [1, 2]


@pytest.mark.cuda
def test_one_rank_nccl_world_on_card():
    """A one-rank NCCL world on the card through run and report: the tick
    graphed (one capture) and bitwise its eager form, ticks x 3 CR launches
    and the profiled replay seeing their CUDA launches and no NCCL kernel;
    the scenario batch graphed and bitwise its eager solve on its rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL and the CR kernel have no CPU mode")
    cfg = small_cfg("cuda")
    results = multihost.run(1, cfg, timeout=WORLD_TIMEOUT)
    summary = multihost.report(results, cfg, log=lambda m: None)
    assert summary["failed"] == [], summary["failed"]
    (r,) = results[1]
    for name in (DI, CP):
        t = r[name]
        assert t["graphed"] and t["captures"] == 1 and t["bitwise"], t
        assert t["replay"]["launches"] == 3 * t["ticks"] and t["profiled"]["nccl"] == 0, t
    assert r[CP]["solver"]["eager_bitwise"], r[CP]["solver"]
