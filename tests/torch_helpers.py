"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Every test feeds the same numpy inputs, made from a seed, to the JAX package
and to its PyTorch port (on the CPU, in float64 unless stated) and compares
the outputs. One intra-op thread per test worker: the suite runs under
pytest-xdist with several workers on a shared machine."""

import contextlib
import os
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

torch.set_num_threads(1)

DI = "double_integrator_minenergy"


def jax_docp(name=DI, grid_size=12, scheme="trapeze"):
    from ctdirect_tpu import transcribe
    from ctdirect_tpu.problems import get_problem

    return transcribe(get_problem(name).ocp, grid_size=grid_size, scheme=scheme)


def torch_docp(name=DI, grid_size=12, scheme="trapeze", dtype=torch.float64):
    from ctdirect_tpu_torch import transcribe
    from ctdirect_tpu_torch.problems import get_problem

    return transcribe(
        get_problem(name).ocp, grid_size=grid_size, scheme=scheme, device="cpu", dtype=dtype
    )


def t(x, dtype=torch.float64):
    """numpy (or jax) array -> CPU tensor."""
    return torch.tensor(np.array(x), dtype=dtype)


def n(x):
    """tensor / jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def box_sample(rng, lb, ub, shape=None):
    """A numpy point inside the box [lb, ub] (broadcast to `shape` if given):
    uniform where both bounds are finite, the finite bound plus |N(0,1)|
    where one is, N(0,1) where none is (keeps fixtures such as goddard's
    exp(-500 (r - 1)) finite)."""
    lb, ub = np.asarray(lb, dtype=np.float64), np.asarray(ub, dtype=np.float64)
    if shape is not None:
        lb, ub = np.broadcast_to(lb, shape), np.broadcast_to(ub, shape)
    lo, hi = np.isfinite(lb), np.isfinite(ub)
    z = rng.standard_normal(lb.shape)
    width = np.where(lo & hi, ub - lb, 0.0)
    out = np.where(lo & hi, lb + rng.uniform(0.0, 1.0, lb.shape) * width, z)
    out = np.where(lo & ~hi, lb + np.abs(z), out)
    return np.where(~lo & hi, ub - np.abs(z), out)


# ---- fixture parity (tests/test_torch_fixtures*.py) ----

TOL = 1e-12  # the same formulas in both packages agree at rounding level


def fixture_points(ocp, seed, t=None):
    """A numpy point (t, x, xf, u, v) inside the OCP's boxes, made from a
    seed; t uniform in [0, 1) unless given."""
    rng = np.random.default_rng(seed)
    return dict(
        t=rng.uniform(0.0, 1.0) if t is None else t,
        x=box_sample(rng, ocp.x_lb, ocp.x_ub),
        xf=box_sample(rng, ocp.x_lb, ocp.x_ub),
        u=box_sample(rng, ocp.u_lb, ocp.u_ub),
        v=box_sample(rng, ocp.v_lb, ocp.v_ub),
    )


def fixture_calls(ocp, p, arr):
    """Every callable of an OCP evaluated at the point p (arrays built by arr)."""
    tt, x, xf, u, v = (arr(p[k]) for k in ("t", "x", "xf", "u", "v"))
    out = {"dynamics": ocp.dynamics(tt, x, u, v)}
    if ocp.lagrange is not None:
        out["lagrange"] = ocp.lagrange(tt, x, u, v)
    if ocp.mayer is not None:
        out["mayer"] = ocp.mayer(x, xf, v)
    if ocp.path is not None:
        out["path"] = ocp.path(tt, x, u, v)
    if ocp.boundary is not None:
        out["boundary"] = ocp.boundary(x, xf, v)
    return out


def assert_same_spec(ot, oj):
    """Dims, flags, time spec, name and every bound of a port OCP equal the
    JAX OCP's."""
    assert (ot.n, ot.m, ot.q, ot.maximize, ot.name) == (oj.n, oj.m, oj.q, oj.maximize, oj.name)
    assert (ot.n_path, ot.n_boundary, ot.has_lagrange, ot.has_mayer) == (
        oj.n_path, oj.n_boundary, oj.has_lagrange, oj.has_mayer)
    ts = lambda o: (o.time.t0, o.time.tf, o.time.t0_index, o.time.tf_index)  # noqa: E731
    assert ts(ot) == ts(oj)
    for attr in ("x_lb", "x_ub", "u_lb", "u_ub", "v_lb", "v_ub", "path_lb", "path_ub",
                 "boundary_lb", "boundary_ub"):
        a, b = getattr(ot, attr), getattr(oj, attr)
        assert (a is None) == (b is None), attr
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=attr)


def assert_same_calls(ot, oj, seeds=(0, 1, 2), times=()):
    """Every callable of the port OCP against the JAX OCP's at the points of
    `seeds` (t in [0, 1)) and at one more point per t in `times`, to TOL."""
    import jax.numpy as jnp

    points = [(s, None) for s in seeds] + [(len(seeds) + k, tv) for k, tv in enumerate(times)]
    for seed, tv in points:
        p = fixture_points(oj, seed, t=tv)
        ct = fixture_calls(ot, p, lambda a: torch.tensor(np.asarray(a), dtype=torch.float64))
        cj = fixture_calls(oj, p, lambda a: jnp.asarray(a, dtype=jnp.float64))
        assert ct.keys() == cj.keys()
        for key in cj:
            np.testing.assert_allclose(n(ct[key]), np.asarray(cj[key]), rtol=TOL, atol=TOL,
                                       err_msg=f"{key}, seed {seed}, t {p['t']}")


def gj_loop(M, n):
    """Gauss-Jordan with partial pivoting on an augmented numpy (n, n+k)
    matrix as a plain loop: the first row of maximal |value| at or below the
    diagonal, an explicit swap (the reference of solver/kkt.py::_gj_eliminate)."""
    M = M.copy()
    for j in range(n):
        p = j + int(np.argmax(np.abs(M[j:, j])))
        M[[j, p]] = M[[p, j]]
        row = M[j] / M[j, j]
        M = M - M[:, j : j + 1] * row
        M[j] = row
    return M


def random_chain_lanes(P, bs, wb, B, seed=0, dtype=np.float64, shift=None):
    """Random well-conditioned padded block chain, lane-minor, numpy.

    A and F are SYMMETRIC: the CR recurrences exploit the KKT system's
    symmetry. Same construction as tests/test_pallas.py, whose diagonal
    shift of 4 keeps blocks up to bs = 12 well conditioned; wider blocks get
    a shift of 4 + bs (their off-diagonal row sums grow with bs, and with a
    shift of 4 a width-41 chain has f64 solutions that differ by 0.5), and
    so do chains of more than 4,096 blocks: with a shift of 4 the chain's
    spectrum reaches near zero as it grows (bs=10, wb=12: max |x| 32 at
    P=256, 3.7e3 at P=8,192, where the plain f32 and f64 solutions differ
    by 1.9e-3 relative; with 4 + bs, 0.33 and 3.1e-7). `shift` sets the
    shift instead of that rule (chip_smoke.py's scan chains take 4 + bs:
    with 4, the orbit-width chain of 500 blocks, bs=11, wb=13, has max |x|
    396, and two f32 solves of it differ by 1.1e-3 relative)."""
    rng = np.random.default_rng(seed)

    def rnd(*s):
        return rng.standard_normal(s).astype(dtype)

    if shift is None:
        shift = 4.0 if bs <= 12 and P <= 4096 else 4.0 + bs
    A = rnd(P, bs, bs, B) * 0.3
    A = A + np.swapaxes(A, 1, 2) + np.eye(bs, dtype=dtype)[None, :, :, None] * shift
    Bp = rnd(P, bs, bs, B) * 0.3
    Bp[-1] = 0.0
    E = rnd(P, bs, wb, B) * 0.2
    F = rnd(wb, wb, B) * 0.2
    F = F + np.swapaxes(F, 0, 1) + np.eye(wb, dtype=dtype)[:, :, None] * (4.0 + P)
    r = rnd(P, bs, B)
    rb = rnd(wb, B)
    return A, Bp, E, F, r, rb


def dense_lane_system(chain, lane):
    """Reassemble one lane of a lane-minor chain (arrays or tensors on any
    device) as a dense float64 (K, rhs)."""
    A, Bp, E, F, r, rb = (n(x).astype(np.float64)[..., lane] for x in chain)
    P, bs, wb = A.shape[0], A.shape[1], E.shape[2]
    size = P * bs + wb
    K = np.zeros((size, size))
    rhs = np.zeros(size)
    for i in range(P):
        sl = slice(i * bs, (i + 1) * bs)
        K[sl, sl] = A[i]
        if i + 1 < P:
            sl1 = slice((i + 1) * bs, (i + 2) * bs)
            K[sl, sl1] = Bp[i]
            K[sl1, sl] = Bp[i].T
        K[sl, P * bs :] = E[i]
        K[P * bs :, sl] = E[i].T
        rhs[sl] = r[i]
    K[P * bs :, P * bs :] = F
    rhs[P * bs :] = rb
    return K, rhs


def relative_residual(chain, X, xb, lane):
    """|K x - rhs| / (|K| |x| + |rhs|) of one lane's reassembled dense system,
    for a lane-minor solution X (P, bs, B), xb (wb, B)."""
    K, rhs = dense_lane_system(chain, lane)
    X, xb = n(X).astype(np.float64), n(xb).astype(np.float64)
    x = np.concatenate([X[:, :, lane].reshape(-1), xb[:, lane]])
    scale = np.abs(K).sum(axis=1).max() * np.abs(x).max() + np.abs(rhs).max()
    return float(np.abs(K @ x - rhs).max() / scale)


def lane_residuals(chain, X, xb):
    """relative_residual of EVERY lane at once, without a dense matrix: the
    block matvec of the lane-minor chain (tensors on any device, computed in
    float64), |K x - rhs| / (max row sum |K| * max |x| + max |rhs|) per lane.
    Returns a (B,) float64 tensor."""
    A, Bp, E, F, r, rb = (x.to(torch.float64) for x in chain)
    X, xb = X.to(torch.float64), xb.to(torch.float64)
    BpT = Bp.transpose(1, 2)
    zero = torch.zeros_like(X[:1])
    X_next = torch.cat([X[1:], zero])
    X_prev = torch.cat([zero, X[:-1]])
    BpT_prev = torch.cat([torch.zeros_like(BpT[:1]), BpT[:-1]])
    y = (torch.einsum("pijb,pjb->pib", A, X) + torch.einsum("pijb,pjb->pib", Bp, X_next)
         + torch.einsum("pijb,pjb->pib", BpT_prev, X_prev) + torch.einsum("piwb,wb->pib", E, xb))
    yb = torch.einsum("piwb,pib->wb", E, X) + torch.einsum("vwb,wb->vb", F, xb)
    res = torch.maximum((y - r).abs().amax(dim=(0, 1)), (yb - rb).abs().amax(dim=0))
    rows = (A.abs().sum(2) + Bp.abs().sum(2) + BpT_prev.abs().sum(2) + E.abs().sum(2)).amax(dim=(0, 1))
    rows = torch.maximum(rows, (E.abs().sum(dim=(0, 1)) + F.abs().sum(1)).amax(dim=0))
    x_max = torch.maximum(X.abs().amax(dim=(0, 1)), xb.abs().amax(dim=0))
    rhs_max = torch.maximum(r.abs().amax(dim=(0, 1)), rb.abs().amax(dim=0))
    return res / (rows * x_max + rhs_max)


# ---- batched whole-IPM solves (tests/test_torch_batch*.py) ----

BATCH = 3


def batch_inputs(d, init, seed, box_scale=None):
    """(z0, cl, cu, zl, zu) of BATCH instances: x0 perturbed through the
    initial-state boundary rows (instance 0 unperturbed), optionally the
    control box scaled per instance."""
    rng = np.random.default_rng(seed)
    rows = d.boundary_row_indices()[: d.n]
    cl, cu = np.tile(d._c_lb, (BATCH, 1)), np.tile(d._c_ub, (BATCH, 1))
    dx = 0.05 * rng.standard_normal((BATCH, d.n))
    dx[0] = 0.0
    cl[:, rows] += dx
    cu[:, rows] += dx
    zl, zu = np.tile(d._z_lb, (BATCH, 1)), np.tile(d._z_ub, (BATCH, 1))
    if box_scale is not None:
        cols = d.control_col_indices()
        zl[:, cols] *= np.asarray(box_scale)[:, None]
        zu[:, cols] *= np.asarray(box_scale)[:, None]
    return np.tile(d.initial_guess(init), (BATCH, 1)), cl, cu, zl, zu


CASES = {
    "cartpole": dict(name="cartpole", grid_size=12, box_scale=[1.0, 0.8, 1.25]),
    "double_integrator": dict(name=DI, grid_size=12, box_scale=None),
    # BASELINE config 4 cut to N=40 (tests/test_torch_orbit_scenarios.py gives its inputs)
    "orbit_transfer": dict(name="orbit_transfer", grid_size=40, box_scale=None),
}


def check_batch_solver_matches_jax(case, scheme="trapeze", inputs=None, dense=False, **options):
    """The port's BatchSolver against the JAX BatchSolver (both given the
    cyclic-reduction StructuredKKT; with `dense`, both the dense KKT solve,
    which the JAX BatchSolver runs for kkt_mode="cr") on one of CASES
    transcribed with `scheme`, with `options` over tol 1e-8 and 60
    iterations at most: same status and iterations per instance, objective
    to 1e-8 relative, z to 1e-8 absolute. The instances are
    `inputs(jax_docp)` -> (z0, cl, cu, zl, zu) where given, else BATCH of
    `batch_inputs`, which must all converge."""
    import jax.numpy as jnp

    from ctdirect_tpu import transcribe as transcribe_j
    from ctdirect_tpu.parallel.batch import BatchSolver as BatchJ
    from ctdirect_tpu.problems import get_problem as problem_j
    from ctdirect_tpu.solver.ipm import IPMOptions as OptsJ
    from ctdirect_tpu.solver.structured_kkt import StructuredKKT as SJ
    from ctdirect_tpu_torch import transcribe as transcribe_t
    from ctdirect_tpu_torch.parallel import BatchSolver as BatchT
    from ctdirect_tpu_torch.problems import get_problem as problem_t
    from ctdirect_tpu_torch.solver.ipm import IPMOptions as OptsT
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT as ST

    c = CASES[case]
    dj = transcribe_j(problem_j(c["name"]).ocp, grid_size=c["grid_size"], scheme=scheme)
    dt = transcribe_t(problem_t(c["name"]).ocp, grid_size=c["grid_size"], scheme=scheme, device="cpu")
    np.testing.assert_array_equal(dt.control_col_indices(), dj.control_col_indices())
    if inputs is None:
        z0, cl, cu, zl, zu = batch_inputs(dj, problem_j(c["name"]).init, seed=1, box_scale=c["box_scale"])
    else:
        z0, cl, cu, zl, zu = inputs(dj)
    opts = {**dict(tol=1e-8, max_iter=60), **options}
    if dense:
        bj = BatchJ(dj, OptsJ(**opts, kkt_mode="cr"))
        bt = BatchT(dt, OptsT(**opts, kkt_mode="dense"), device="cpu")
    else:
        bj = BatchJ(dj, OptsJ(**opts), kkt=SJ(dj, algorithm="cr"))
        bt = BatchT(dt, OptsT(**opts), kkt=ST(dt, algorithm="cr"), device="cpu")
    rj = bj(*(jnp.asarray(a) for a in (z0, cl, cu, zl, zu)))
    rt = bt(z0, cl, cu, zl, zu)
    np.testing.assert_array_equal(n(rt.status), np.asarray(rj.status))
    np.testing.assert_array_equal(n(rt.iterations), np.asarray(rj.iterations))
    if inputs is None:
        assert n(rt.successful).all()
    np.testing.assert_allclose(n(rt.objective), np.asarray(rj.objective), rtol=1e-8)
    np.testing.assert_allclose(n(rt.z), np.asarray(rj.z), rtol=0, atol=1e-8)
    for field in rt._fields:  # a leading batch axis on every field
        assert n(getattr(rt, field)).shape[0] == len(z0), field


# ---- a tiny NLP whose first dense KKT system is exactly singular
# (tests/test_torch_kkt_singular.py, tests/test_torch_ipm_history.py) ----


def singular_nlp(xp):
    """min (a - 1)^2 + (b - 2)^2 s.t. a + b = 1, with a third variable in
    neither f nor c and unbounded: its KKT row is zero until the IPM
    regularizes. `xp` is `jax.numpy` or `torch`; returns (f, c, bounds
    (zl, zu, cl, cu), z0) with numpy bounds and guess. Optimum a=0, b=1,
    f=2."""
    inf = np.inf
    zl = np.full(3, -inf)

    def f(z):
        return (z[0] - 1.0) ** 2 + (z[1] - 2.0) ** 2

    def c(z):
        return xp.stack([z[0] + z[1]])

    return f, c, (zl, -zl, np.array([1.0]), np.array([1.0])), np.array([0.3, 0.2, 0.5])


def solve_both(f_c_bounds_z0, jax_kkt, torch_kkt, **options):
    """The same NLP through the JAX `ipm_solve` (jitted, return_history) and
    the port's (eager, return_history) on the CPU: (jax result, jax history,
    port result, port history). `f_c_bounds_z0` maps an array module to
    (f, c, (zl, zu, cl, cu), z0), as `singular_nlp` does."""
    import jax
    import jax.numpy as jnp

    from ctdirect_tpu.solver.ipm import IPMOptions as OptsJ
    from ctdirect_tpu.solver.ipm import ipm_solve as ipm_j
    from ctdirect_tpu.solver.ipm import make_spec as spec_j
    from ctdirect_tpu_torch.solver.ipm import IPMOptions as OptsT
    from ctdirect_tpu_torch.solver.ipm import ipm_solve as ipm_t
    from ctdirect_tpu_torch.solver.ipm import make_spec as spec_t

    fj, cj, bounds, z0 = f_c_bounds_z0(jnp)
    ft, ctt, _, _ = f_c_bounds_z0(torch)
    rj, hj = jax.jit(lambda z: ipm_j(fj, cj, spec_j(*bounds), z, *bounds, options=OptsJ(**options), kkt=jax_kkt,
                                     return_history=True))(jnp.asarray(z0))
    rt, ht = ipm_t(ft, ctt, spec_t(*bounds), z0, *bounds, options=OptsT(**options), kkt=torch_kkt,
                   return_history=True, device="cpu")
    return rj, hj, rt, ht


# ---- sharded paths in gloo worlds (tests/test_torch_time_shard.py,
# tests/test_torch_parallel_mesh.py) ----
# The worlds are spawned processes (ctdirect_tpu_torch.parallel.spmd.launch):
# their workers live here, in an importable module that imports no JAX, and
# take and return numpy only.

WORLD = 4  # ranks of the test worlds
WORLD_TIMEOUT = 240.0  # seconds a test world may take before it is stopped


def _jax_loaded():
    import sys

    return any(m.split(".")[0] in ("jax", "jaxlib", "ctdirect_tpu") for m in sys.modules)


def spmd_time_shard_world(world, chains, kkt_case, ipm_case):
    """One gloo world for tests/test_torch_time_shard.py: the distributed CR
    of each chain (D, N, bs, wb, B, seed) through make_sharded_tridiag_solver,
    beside the port's unsharded cr_solve_lanes; TimeShardedKKT.solve at D=1,
    2 and 4 on kkt_case's seeded inputs; a full IPM with TimeShardedKKT at
    D=4 on ipm_case; at D=2 the same IPM as the card compiles it (the B=1
    program, its segments run op by op under CaptureHazards, its flag reads
    logged) beside the eager ipm_solve."""
    from ctdirect_tpu_torch.parallel.time_shard import TimeShardedKKT, make_sharded_tridiag_solver
    from ctdirect_tpu_torch.solver.graph import BatchGraph, graph_counters
    from ctdirect_tpu_torch.solver.interface import DOCPSolver
    from ctdirect_tpu_torch.solver.ipm import IPMOptions, ipm_solve, make_spec
    from ctdirect_tpu_torch.solver.lanes import _pad_pow2_lanes, cr_solve_lanes

    torch.set_num_threads(1)
    # D=4 over a 1-D mesh, D=2 over the time axis of a 2 x 2 mesh, D=1 over
    # that of a 4 x 1 mesh (every rank builds the same meshes in the same
    # order)
    meshes = {4: world.mesh((4,), ("time",)), 2: world.mesh((2, 2), ("batch", "time")),
              1: world.mesh((4, 1), ("batch", "time"))}
    out = dict(chains=[], kkt={})
    for D, N, bs, wb, B, seed in chains:
        A, Bp, E, F, r, rb = (torch.tensor(x) for x in random_chain_lanes(N, bs, wb, B, seed=seed))
        solve = make_sharded_tridiag_solver(meshes[D], "time", N, bs, wb)
        X, xb = solve(A, Bp[:-1], E, F, r, rb)
        Ap, Bpp, Ep, rp = _pad_pow2_lanes(A, Bp[:-1], E, r)
        Xp, xbp = cr_solve_lanes(Ap, Bpp, Ep, F, rp, rb)
        out["chains"].append(dict(X=n(X), xb=n(xb), X_plain=n(Xp[:N]), xb_plain=n(xbp), rank=solve.axis.rank,
                                  messages=solve.axis.messages, staged=solve.axis.staged_messages,
                                  graphs=len(solve.graphs)))

    d = torch_docp(kkt_case["name"], grid_size=kkt_case["grid_size"], scheme=kkt_case["scheme"])
    for D in (1, 2, 4):
        kkt = TimeShardedKKT(d, meshes[D], axis="time")
        inp = {k: t(v) for k, v in kkt_case["inputs"].items()}
        data = kkt.prepare(inp["z"], inp["lam"], t(1.0), torch.ones(d.nc, dtype=torch.float64))
        dz, dlam = kkt.solve(data, inp["sigma"], inp["Drow"], 1e-6, 1e-7, inp["rz"], inp["rp"])
        out["kkt"][D] = dict(dz=n(dz), dlam=n(dlam), block_solves=kkt.block_solves)

    d = torch_docp(ipm_case["name"], grid_size=ipm_case["grid_size"], scheme=ipm_case["scheme"])
    args = (d.initial_guess(None), d._z_lb, d._z_ub, d._c_lb, d._c_ub)
    opts = IPMOptions(**ipm_case["options"])
    kkt = TimeShardedKKT(d, meshes[4], axis="time")
    res = ipm_solve(d.nlp_objective, d.constraints, make_spec(d._z_lb, d._z_ub, d._c_lb, d._c_ub), *args,
                    options=opts, kkt=kkt, device="cpu")
    out["ipm"] = dict(status=int(res.status), objective=float(res.objective), iterations=int(res.iterations),
                      block_solves=kkt.block_solves)

    run = DOCPSolver(d, opts, kkt=TimeShardedKKT(d, meshes[2], axis="time"))
    mode = CaptureHazards()

    def watched(fn):
        def segment(state):
            with mode:
                return fn(state)

        return segment

    segments = {k: watched(f) for k, f in run.program.segments.items()}
    run.stats.flag_log = []
    res, _ = run.batched(BatchGraph(segments, graph_counters(run.kkt), "cpu", capture=False), *args)
    ref, _ = run.eager(*args)
    out["b1"] = dict(status=res.status, iterations=res.iterations, objective=float(res.objective), z=n(res.z),
                     eager=dict(status=ref.status, iterations=int(ref.iterations), z=n(ref.z)),
                     flags=run.stats.flag_log, hazards=mode.where, graphed=run.graphed,
                     time_rank=run.kkt.axis.rank, messages=run.kkt.axis.messages)
    out["jax_loaded"] = _jax_loaded()
    return out


def spmd_refusals_world(world, N):
    """A world whose size is not a power of two: every time-sharded
    constructor and a BatchSolver call with B % D != 0 must raise
    ValueError. Returns the messages."""
    from ctdirect_tpu_torch.parallel import BatchSolver, TimeShardedKKT, make_sharded_tridiag_solver

    torch.set_num_threads(1)
    mesh = world.mesh((world.size,), ("time",))
    mesh_b = world.mesh((world.size,), ("batch",))
    d = torch_docp(grid_size=N)
    out = {}
    for what, call in (
        ("tridiag", lambda: make_sharded_tridiag_solver(mesh, "time", N, 5, 7)),
        ("kkt", lambda: TimeShardedKKT(d, mesh, axis="time")),
        ("batch", lambda: BatchSolver(d, mesh=mesh_b, device="cpu")(
            np.tile(d.initial_guess(None), (world.size + 1, 1)))),
    ):
        try:
            call()
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    return out


def spmd_mesh_world(world, batch_case, tick_case):
    """One gloo world for tests/test_torch_parallel_mesh.py: a BatchSolver
    over a 1-D batch mesh of the world (the global batch in and out), with
    and without per-instance boxes; then, from one warm state, two MPC ticks
    on the 1-D batch mesh (this rank's rows), two on the 2 x 2 batch x time
    mesh (this batch shard's rows, the KKT solve over the time axis) and two
    on the 4 x 1 batch x time mesh (a time axis of one rank); each first
    tick under CaptureHazards."""
    from ctdirect_tpu_torch.parallel import BatchSolver, MPCController, broadcast_state
    from ctdirect_tpu_torch.solver.ipm import IPMOptions
    from ctdirect_tpu_torch.solver.resolve import warm_state_from_numpy

    torch.set_num_threads(1)
    mesh_b = world.mesh((world.size,), ("batch",))
    mesh_2d = world.mesh((2, world.size // 2), ("batch", "time"))
    out = {}
    d = torch_docp(grid_size=batch_case["grid_size"])
    solver = BatchSolver(d, IPMOptions(**batch_case["options"]), mesh=mesh_b, device="cpu")
    for key, boxes in (("batch", {}), ("boxes", dict(zl_batch=batch_case["zl"], zu_batch=batch_case["zu"]))):
        res = solver(batch_case["z0"], **boxes)
        out[key] = {f: n(getattr(res, f)) for f in ("z", "objective", "status", "iterations")}

    d = torch_docp(grid_size=tick_case["grid_size"])
    warm = warm_state_from_numpy(tick_case["warm"], "cpu")
    x0 = tick_case["x0"]
    meshes = (("tick", mesh_b, dict(kkt_algorithm="cr")), ("tick_2d", mesh_2d, dict(time_axis="time")),
              ("tick_2d_t1", world.mesh((world.size, 1), ("batch", "time")), dict(time_axis="time")))
    for key, mesh, kw in meshes:
        ctrl = MPCController(d, x0_boundary_rows=[0, 1], resolve_iters=tick_case["iters"], mesh=mesh,
                             device="cpu", **kw)
        rows = x0.shape[0] // ctrl.axis.size
        mine = slice(ctrl.axis.rank * rows, (ctrl.axis.rank + 1) * rows)
        states = broadcast_state(warm, rows)
        mode = CaptureHazards()
        for k in range(tick_case["ticks"]):
            x0_mine = t(x0[mine])
            with mode if k == 0 else contextlib.nullcontext():
                states, u0, kkt, viol = ctrl(states, x0_mine)
        out[key] = dict(rows=(mine.start, mine.stop), states=[n(a) for a in states], u0=n(u0), kkt=n(kkt),
                        viol=n(viol), block_solves=ctrl.kkt.block_solves, hazards=mode.where,
                        graphed=ctrl.graphed)
    out["jax_loaded"] = _jax_loaded()
    return out


def spmd_failing_world(world):
    """Rank 1 raises while the others wait in a collective for it."""
    import torch.distributed as dist

    if world.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
    return world.rank


def spmd_sleeping_world(world, seconds):
    """Every rank outlives its world's time limit."""
    import time

    time.sleep(seconds)


# ---- CUDA graph capture (tests/test_torch_tick_graph.py, tests/test_torch_batch_graph.py) ----

_TORCH_DIR = os.path.dirname(torch.__file__)
# PyTorch's dispatch machinery and Python tensor methods between an op's caller and a mode
_MACHINERY = ("_compile.py", "_dynamo", "_python_dispatch.py", "_ops.py", "overrides.py", "_tensor.py", "functional.py")


class CaptureHazards(TorchDispatchMode):
    """Records every op that a CUDA graph capture refuses, or that would
    wait for the device or copy host data to it in an eager tick:
    - `aten::lift_fresh` (and `lift_fresh_copy`): a tensor made from host
      data, which is what `torch.as_tensor` / `torch.tensor` of a Python
      number, list or numpy array reaches, under `torch.func.vmap` as outside
      it; on the card a host-to-device copy follows it, or a value fixed at
      capture;
    - `aten::_local_scalar_dense`: `.item()`, `bool()`, `float()` of a tensor;
    - `aten::nonzero`, `aten::masked_select`: outputs whose shape depends on
      the data (a sync);
    - a copy from the CPU onto another device (`_to_copy` with a device,
      `copy_` from a CPU tensor), whatever code asks for it; only a run on
      the card can show one.
    The first three count when the port or a user callable asks for them,
    and a read-back also when its tensor is on a device. PyTorch's own
    Python may make small CPU tensors of shape metadata that never reach the
    device (torch 2.11's `jacfwd` / `hessian` make their basis offsets with
    `torch.tensor(tensor_numels)`); those are not hazards."""

    MADE = {"aten::lift_fresh", "aten::lift_fresh_copy"}
    READ = {"aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select"}

    def __init__(self):
        super().__init__()
        self.seen = []
        self.where = []  # the code that asked for each hazard

    @staticmethod
    def _issuer():
        """The innermost frame outside this mode and PyTorch's dispatch
        machinery: the code that asked for the op."""
        for f in reversed(traceback.extract_stack()):
            if f.filename == __file__ and f.name in ("__torch_dispatch__", "_issuer"):
                continue
            if f.filename.startswith(_TORCH_DIR) and any(m in f.filename for m in _MACHINERY):
                continue
            return f

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        src = args[0] if args and isinstance(args[0], torch.Tensor) else None
        what = None
        if name in self.MADE or name in self.READ:
            ours = not self._issuer().filename.startswith(_TORCH_DIR)
            if ours or (name in self.READ and src is not None and src.device.type != "cpu"):
                what = name
        elif (name == "aten::_to_copy" and src is not None and src.device.type == "cpu"
              and kwargs.get("device") not in (None, src.device)):
            what = f"{name} cpu -> {kwargs['device']}"
        elif (name == "aten::copy_" and isinstance(args[1], torch.Tensor) and args[1].device.type == "cpu"
              and args[0].device.type != "cpu" and args[1].dim() > 0):
            what = f"{name} cpu -> {args[0].device}"
        if what is not None:
            f = self._issuer()
            self.seen.append(what)
            self.where.append(f"{what} at {f.filename.rsplit('/', 1)[-1]}:{f.lineno} {f.line}")
        return func(*args, **kwargs)
