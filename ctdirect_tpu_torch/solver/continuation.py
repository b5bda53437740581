"""Discrete continuation (PyTorch port of `ctdirect_tpu.solver.continuation`):
re-solve a family of OCPs, warm-starting each from the previous solution.

`continuation(make_ocp, values, ..., device=...)` rebuilds the OCP per value
and passes the previous Solution as the initial guess; `grid_continuation`
solves one OCP on a sequence of grids, coarse to fine. The warm start goes
through `InitialGuess.from_solution`: the Solution's host-side accessors
resample t -> x, u onto the next grid, and the solver moves the packed guess
to the DOCP's device."""

from __future__ import annotations

import warnings
from typing import Callable, Iterable, List, Optional

import torch

from ctdirect_tpu_torch.model.init import InitialGuess
from ctdirect_tpu_torch.model.solution import Solution
from ctdirect_tpu_torch.solver.interface import solve_docp
from ctdirect_tpu_torch.solver.ipm import IPMOptions
from ctdirect_tpu_torch.transcription.docp import transcribe


def continuation(
    make_ocp: Callable,
    values: Iterable,
    grid_size: int = 100,
    scheme: str = "midpoint",
    options: IPMOptions = IPMOptions(),
    init: Optional[InitialGuess] = None,
    display: bool = False,
    *,
    device,
    dtype: torch.dtype = torch.float64,
) -> List[Solution]:
    """Solve make_ocp(v) for each v in values on `device`, warm-starting from
    the previous solution. Returns all solutions in order."""
    sols: List[Solution] = []
    guess = init
    for v in values:
        docp = transcribe(make_ocp(v), grid_size=grid_size, scheme=scheme, device=device, dtype=dtype)
        sol = solve_docp(docp, init=guess, options=options)
        docp.release_solvers()
        if display:
            print(f"continuation {v}: {sol}")
        sols.append(sol)
        guess = InitialGuess.from_solution(sol)
    return sols


def grid_continuation(
    ocp,
    grids: Iterable[int],
    scheme: str = "trapeze",
    options: IPMOptions = IPMOptions(),
    warm_options: Optional[IPMOptions] = None,
    init: Optional[InitialGuess] = None,
    display: bool = False,
    strict: bool = False,
    *,
    device,
    dtype: torch.dtype = torch.float64,
) -> List[Solution]:
    """Coarse-to-fine mesh refinement: solve the SAME ocp on grids[0], then
    warm-start each finer grid from the previous solution.

    warm_options, when given, is used for every stage after the first (e.g. a
    cooler barrier: options.replace(mu_init=1e-4)). Returns the list of
    Solutions, finest last.

    Every intermediate stage warm-starts the next one even if it did not
    converge, with a warnings.warn for each such stage; strict=True raises
    RuntimeError instead."""
    sols: List[Solution] = []
    guess = init
    grids = list(grids)
    for k, n in enumerate(grids):
        docp = transcribe(ocp, grid_size=int(n), scheme=scheme, device=device, dtype=dtype)
        opts = options if (k == 0 or warm_options is None) else warm_options
        sol = solve_docp(docp, init=guess, options=opts)
        docp.release_solvers()
        if display:
            print(f"grid_continuation N={n}: {sol}")
        if k < len(grids) - 1 and not bool(sol.successful):
            msg = (
                f"grid_continuation: intermediate stage N={n} did not converge "
                f"({sol.message}); the next stage is warm-started from it anyway"
            )
            if strict:
                raise RuntimeError(msg)
            warnings.warn(msg, stacklevel=2)
        sols.append(sol)
        guess = InitialGuess.from_solution(sol)
    return sols
