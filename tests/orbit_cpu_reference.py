"""The CPU measurements behind BASELINE config 4's constants and bounds
(ctdirect_tpu_torch/orbit_scenarios.py), both packages, float64:

    python tests/orbit_cpu_reference.py

1. The JAX package's nominal solves at N=500 under the script's options
   (NOMINAL_OPTS) with the structured and the CR KKT solve: status,
   iterations, objective, wall (the script's JAX_NOMINAL).
2. The JAX package's scenario batch at N=500: rows 0-15 of the B=2048
   draw warm from its structured nominal, StructuredKKT(algorithm="cr"),
   the batch options: the converged share (ORBIT_MIN_CONVERGED).
3. The N=40 nominals of both packages (the port's on the CPU), against
   the script's NOMINAL_RTOL.
4. Rows 0-3 of the draw warm from the JAX package's N=40 nominal: one
   batch iteration of each package under the dense, scan and CR KKT
   solves (objectives, z apart), and the dense solves' gap over 1-3
   iterations.
5. The first KKT system of the port's CR batch (row 0 of item 4): its
   condition number, the relative residual |K x - rhs| / (|K| |x| + |rhs|)
   of the dense solve and of both packages' CR on the same blocks, how far
   the two CR solutions are apart, and how far each solve moves when every
   entry of the diagonal blocks moves by one ulp.

It prints one line per measurement; PERF.md quotes them."""

import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)), os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from test_torch_orbit_scenarios import SIGMA, first_cr_system, reference_scenarios  # noqa: E402
from torch_helpers import dense_lane_system, relative_residual  # noqa: E402


def jax_nominal(N, mode):
    from ctdirect_tpu import transcribe
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.interface import solve_docp
    from ctdirect_tpu.solver.ipm import IPMOptions
    from ctdirect_tpu_torch.orbit_scenarios import NOMINAL_OPTS

    t0 = time.perf_counter()
    dj = transcribe(get_problem("orbit_transfer").ocp, grid_size=N, scheme="midpoint")
    sol = solve_docp(dj, init=get_problem("orbit_transfer").init, options=IPMOptions(kkt_mode=mode, **NOMINAL_OPTS))
    print(f"JAX nominal N={N} {mode}: status {sol.status} ({sol.message}), {sol.iterations} iterations, objective "
          f"{sol.objective!r}, {time.perf_counter() - t0:.1f} s", flush=True)
    return dj, sol


def draw_rows(dj, nominal, rows):
    from ctdirect_tpu import InitialGuess

    z_nom = dj.initial_guess(InitialGuess.from_solution(nominal))
    return tuple(np.ascontiguousarray(x[:rows]) for x in reference_scenarios(dj, z_nom, sigma=SIGMA))


def batch_pair(dj, dt, inputs, mode, max_iter):
    """(JAX result, port result) of one BatchSolver call each under `mode`
    ("dense": the JAX BatchSolver's own operator for kkt_mode="cr")."""
    from ctdirect_tpu.parallel.batch import BatchSolver as BatchJ
    from ctdirect_tpu.solver.ipm import IPMOptions as OptsJ
    from ctdirect_tpu.solver.structured_kkt import StructuredKKT as SJ
    from ctdirect_tpu_torch.parallel import BatchSolver as BatchT
    from ctdirect_tpu_torch.solver.ipm import IPMOptions as OptsT
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT as ST

    opts = dict(tol=1e-6, max_iter=max_iter, lsq_lambda_init=False)
    if mode == "dense":
        bj, bt = BatchJ(dj, OptsJ(**opts, kkt_mode="cr")), BatchT(dt, OptsT(**opts, kkt_mode="dense"), device="cpu")
    else:
        bj = BatchJ(dj, OptsJ(**opts), kkt=SJ(dj, algorithm=mode))
        bt = BatchT(dt, OptsT(**opts), kkt=ST(dt, algorithm=mode), device="cpu")
    return bj(*(jnp.asarray(a) for a in inputs)), bt(*inputs)


def main():
    import torch

    from ctdirect_tpu.parallel.batch import BatchSolver as BatchJ
    from ctdirect_tpu.solver.ipm import IPMOptions as OptsJ
    from ctdirect_tpu.solver.lanes import cr_solve_lanes as cr_j
    from ctdirect_tpu.solver.structured_kkt import StructuredKKT as SJ
    from ctdirect_tpu_torch import solve_docp as solve_t
    from ctdirect_tpu_torch import transcribe as transcribe_t
    from ctdirect_tpu_torch.orbit_scenarios import NOMINAL_OPTS, NOMINAL_RTOL
    from ctdirect_tpu_torch.problems import get_problem as problem_t
    from ctdirect_tpu_torch.solver.ipm import IPMOptions as OptsT
    from ctdirect_tpu_torch.solver.lanes import cr_solve_lanes as cr_t

    # 1, 2
    dj500, nom500 = jax_nominal(500, "structured")
    jax_nominal(500, "cr")
    t0 = time.perf_counter()
    inputs = draw_rows(dj500, nom500, 16)
    res = BatchJ(dj500, OptsJ(tol=1e-6, max_iter=30, lsq_lambda_init=False), kkt=SJ(dj500, algorithm="cr"))(
        *(jnp.asarray(a) for a in inputs))
    print(f"JAX batch N=500 rows 0-15, cr, 30 iterations: converged {int(np.asarray(res.successful).sum())} of 16, "
          f"status {np.asarray(res.status).tolist()}, objectives {np.round(np.asarray(res.objective), 4).tolist()}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 3
    dj, nom40 = jax_nominal(40, "structured")
    dt = transcribe_t(problem_t("orbit_transfer").ocp, grid_size=40, scheme="midpoint", device="cpu")
    t0 = time.perf_counter()
    nom_t = solve_t(dt, init=problem_t("orbit_transfer").init, options=OptsT(**NOMINAL_OPTS))
    rel = abs(nom_t.objective - nom40.objective) / abs(nom40.objective)
    print(f"port nominal N=40 structured (CPU): status {nom_t.status} ({nom_t.message}), {nom_t.iterations} "
          f"iterations, objective {nom_t.objective!r}, rel diff to the JAX package's {rel:.2e} (NOMINAL_RTOL "
          f"{NOMINAL_RTOL:g}), {time.perf_counter() - t0:.1f} s", flush=True)

    # 4
    inputs = draw_rows(dj, nom40, 4)
    zs = {}
    for mode in ("dense", "scan", "cr"):
        rj, rt = batch_pair(dj, dt, inputs, mode, 1)
        zs[f"JAX {mode}"], zs[f"port {mode}"] = np.asarray(rj.z), rt.z.numpy()
        print(f"one iteration, {mode}: objectives JAX {np.asarray(rj.objective).tolist()}, port "
              f"{rt.objective.numpy().tolist()}", flush=True)
    names = list(zs)
    print("one iteration, max |z| apart: " + "; ".join(
        f"{a} vs {b} {np.abs(zs[a] - zs[b]).max():.3e}" for i, a in enumerate(names) for b in names[i + 1:]))
    for it in (2, 3):
        rj, rt = batch_pair(dj, dt, inputs, "dense", it)
        print(f"{it} iterations, dense: max |z| apart {np.abs(rt.z.numpy() - np.asarray(rj.z)).max():.3e}, "
              f"objectives rel {np.abs(rt.objective.numpy() / np.asarray(rj.objective) - 1).max():.3e}", flush=True)

    # 5
    chain = first_cr_system(dt, inputs)
    Xt, xbt = cr_t(*chain)
    Xj, xbj = (np.asarray(x) for x in cr_j(*(jnp.asarray(x.numpy()) for x in chain)))
    K, rhs = dense_lane_system(chain, 0)
    sv = np.linalg.svd(K, compute_uv=False)
    xd = np.linalg.solve(K, rhs)
    flat = lambda X, xb: np.concatenate([np.asarray(X)[:, :, 0].reshape(-1), np.asarray(xb)[:, 0]])  # noqa: E731
    xt, xj = flat(Xt, xbt), flat(Xj, xbj)
    scale = np.abs(K).sum(axis=1).max() * np.abs(xd).max() + np.abs(rhs).max()
    print(f"first CR system, row 0 (P={chain[0].shape[0]}, bs={chain[0].shape[1]}, wb={chain[2].shape[2]}): cond "
          f"{sv[0] / sv[-1]:.3e}; relative residual dense {np.abs(K @ xd - rhs).max() / scale:.2e}, port CR "
          f"{relative_residual(chain, Xt, xbt, 0):.2e}, JAX CR {relative_residual(chain, Xj, xbj, 0):.2e}; "
          f"|x| {np.abs(xd).max():.3e}; port CR vs JAX CR {np.abs(xt - xj).max():.3e}, CR vs dense "
          f"{np.abs(xt - xd).max():.3e}", flush=True)
    bumped = [chain[0].clone()] + chain[1:]
    bumped[0] = torch.nextafter(bumped[0], torch.full_like(bumped[0], np.inf))
    Xu, xbu = cr_t(*bumped)
    Kb, _ = dense_lane_system(bumped, 0)
    print(f"first CR system, row 0, every diagonal-block entry one ulp up: the port's CR moves by "
          f"{np.abs(flat(Xu, xbu) - xt).max():.3e}, the dense solve by {np.abs(np.linalg.solve(Kb, rhs) - xd).max():.3e}",
          flush=True)


if __name__ == "__main__":
    main()
