from ctdirect_tpu_torch.solver.ipm import (
    BatchStats,
    IPMOptions,
    IPMResult,
    ipm_solve,
    ipm_solve_batched,
)
from ctdirect_tpu_torch.solver.interface import solve, solve_docp
from ctdirect_tpu_torch.solver.continuation import continuation, grid_continuation

__all__ = [
    "BatchStats",
    "IPMOptions",
    "IPMResult",
    "ipm_solve",
    "ipm_solve_batched",
    "solve",
    "solve_docp",
    "continuation",
    "grid_continuation",
]
