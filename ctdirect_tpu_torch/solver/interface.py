"""High-level solve API (PyTorch port of `ctdirect_tpu.solver.interface`).

`solve(ocp, ..., device=...)` is the front door: transcribe + solve + build
Solution. The KKT operator is cached per (DOCP, options)."""

from __future__ import annotations

from typing import Optional

import torch

from ctdirect_tpu_torch.model.init import InitialGuess
from ctdirect_tpu_torch.model.ocp import OCP
from ctdirect_tpu_torch.model.solution import Solution
from ctdirect_tpu_torch.solver.ipm import STATUS_MESSAGES, IPMOptions, ipm_solve, make_spec
from ctdirect_tpu_torch.transcription.docp import DOCP, transcribe


def make_kkt(docp: DOCP, options: IPMOptions):
    """The KKT operator `options.kkt_mode` asks for: None for "dense" (the
    solvers default to DenseKKT), a StructuredKKT with the scan solve for
    "structured" and with the cyclic-reduction solve for "cr"."""
    if options.kkt_mode == "dense":
        return None
    if options.kkt_mode not in ("structured", "cr"):
        raise ValueError(f"unknown kkt_mode {options.kkt_mode!r}")
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT

    sdt = torch.float32 if options.kkt_solve_dtype in ("f32", "float32") else None
    return StructuredKKT(
        docp,
        algorithm="cr" if options.kkt_mode == "cr" else "scan",
        solve_dtype=sdt,
        refine=options.kkt_refine if sdt is not None else 0,
        equilibrate=options.kkt_equilibrate,
    )


def _get_solver(docp: DOCP, options: IPMOptions):
    """run(z0, zl, zu, cl, cu) -> (IPMResult, postprocess tuple) on docp's
    device, cached on the DOCP per options; `run.kkt` is its KKT operator
    (None for the dense mode)."""
    cache = docp.__dict__.setdefault("_solver_cache", {})
    if options not in cache:
        spec = make_spec(docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
        kkt = make_kkt(docp, options)

        def run(z0, zl, zu, cl, cu):
            result = ipm_solve(
                docp.nlp_objective,
                docp.constraints,
                spec,
                z0,
                zl,
                zu,
                cl,
                cu,
                options=options,
                kkt=kkt,
                device=docp.device,
                dtype=docp.dtype,
            )
            return result, docp.postprocess(result.z)

        run.kkt = kkt
        cache[options] = run
    return cache[options]


def solve_docp(
    docp: DOCP,
    init: Optional[InitialGuess] = None,
    options: IPMOptions = IPMOptions(),
    display: bool = False,
) -> Solution:
    """Solve a transcribed DOCP (on its device) and map the result back to
    continuous time. With a structured KKT operator, `sol.infos
    ["kkt_block_solves"]` counts the block solves of this solve (on the
    card with kkt_mode="cr": the CR kernel launches)."""
    if isinstance(init, Solution):
        init = InitialGuess.from_solution(init)
    z0 = docp.initial_guess(init)
    solver = _get_solver(docp, options)
    before = None if solver.kkt is None else solver.kkt.block_solves
    result, post = solver(z0, docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
    infos = {} if before is None else {"kkt_block_solves": solver.kkt.block_solves - before}
    sol = docp.build_solution(
        result, message=STATUS_MESSAGES.get(int(result.status), "Unknown"), infos=infos, post=post
    )
    if display:
        print(sol)
    return sol


def solve(
    ocp: OCP,
    grid_size: int = 250,
    scheme: str = "midpoint",
    time_grid=None,
    control_steps: int = 1,
    init: Optional[InitialGuess] = None,
    options: Optional[IPMOptions] = None,
    display: bool = False,
    *,
    device,
    dtype: torch.dtype = torch.float64,
    **opt_kwargs,
) -> Solution:
    """Transcribe and solve an OCP on `device` ("cpu", "cuda", ...) in `dtype`.

    Defaults mirror the JAX package (grid_size=250, scheme="midpoint"). Extra
    keyword args are IPMOptions fields (tol=..., max_iter=..., ...)."""
    if options is None:
        options = IPMOptions(**opt_kwargs)
    elif opt_kwargs:
        options = options.replace(**opt_kwargs)
    docp = transcribe(
        ocp,
        grid_size=grid_size,
        scheme=scheme,
        time_grid=time_grid,
        control_steps=control_steps,
        device=device,
        dtype=dtype,
    )
    return solve_docp(docp, init=init, options=options, display=display)
