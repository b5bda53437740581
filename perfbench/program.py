"""The benchmark's one door into the program under test, ctdirect_tpu_torch:
the problem transcribed as a configuration states it, the warm state of its
cold start, and the counters and objects the readers look at. Nothing here
measures or judges."""

from __future__ import annotations

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def precision(cfg: dict) -> tuple:
    """(the Newton loop's dtype, the block solve's dtype or None where it is
    the loop's) as the configuration states them."""
    p = cfg["precision"]
    dtype, solve = DTYPES[p["newton"]], DTYPES[p["block_solve"]]
    return dtype, None if solve == dtype else solve


def transcribe(cfg: dict, device, dtype):
    """(the fixture's problem, its DOCP) at the configuration's grid and scheme."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem

    prob = get_problem(cfg["fixture"])
    return prob, ct.transcribe(prob.ocp, grid_size=cfg["grid_size"], scheme=cfg["scheme"], device=device,
                               dtype=dtype)


def controller(cfg: dict, docp, solve_dtype):
    from ctdirect_tpu_torch.parallel.mpc import MPCController

    return MPCController(docp, x0_boundary_rows=list(cfg["x0_rows"]), resolve_iters=cfg["newton_steps"],
                         kkt_algorithm=cfg["kkt_algorithm"], kkt_solve_dtype=solve_dtype, device=docp.device,
                         dtype=docp.dtype)


def cold_start(cfg: dict, prob, docp, ctrl):
    """(the configuration's cold start as the controller hands it to its
    ticks: a full IPM on the program's compiled B=1 solve, moved inside the
    boxes; what the check reads of it: its z, its multipliers, the point the
    solve started from ("z0") and the distance by which the controller moved
    z inside each finite bound ("inside": that factor times max(1, |bound|))).
    The solve's graphs are released after."""
    import ctdirect_tpu_torch as ct

    options = ct.IPMOptions(**cfg["cold_start"])
    init = prob.init if cfg["cold_start_from_init"] else None
    warm = ctrl.cold_start(options=options, init=init)
    docp.release_solvers()
    seen = dict(z=warm.z, lam=warm.lam, zL=warm.wL, zU=warm.wU, z0=torch.as_tensor(docp.initial_guess(init)),
                inside=options.bound_relax_factor)
    return warm, {k: (v.detach().cpu() if torch.is_tensor(v) else v) for k, v in seen.items()}


def broadcast(warm, batch: int):
    from ctdirect_tpu_torch.parallel.mpc import broadcast_state

    return broadcast_state(warm, batch)


def build_kernels(device) -> None:
    """The CR kernel's library, built (first run in a checkout) or loaded."""
    if torch.device(device).type == "cuda":
        from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched

        cr_solve_batched.library()
