from ctdirect_tpu_torch.solver.ipm import IPMOptions, IPMResult, ipm_solve
from ctdirect_tpu_torch.solver.interface import solve, solve_docp

__all__ = ["IPMOptions", "IPMResult", "ipm_solve", "solve", "solve_docp"]
