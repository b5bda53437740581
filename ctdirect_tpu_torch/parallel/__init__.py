from ctdirect_tpu_torch.parallel.batch import BatchSolver, make_batch_solver
from ctdirect_tpu_torch.parallel.mpc import MPCController, broadcast_state, shift_state

__all__ = ["BatchSolver", "make_batch_solver", "MPCController", "broadcast_state", "shift_state"]
