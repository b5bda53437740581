from ctdirect_tpu_torch.parallel.batch import BatchSolver, make_batch_solver
from ctdirect_tpu_torch.parallel.mpc import MPCController, broadcast_state, shift_state
from ctdirect_tpu_torch.parallel.spmd import World, launch
from ctdirect_tpu_torch.parallel.time_shard import (
    InsideTimeShardKKT,
    ShardAxis,
    TimeShardedKKT,
    dcr_solve,
    make_sharded_tridiag_solver,
)

__all__ = [
    "BatchSolver", "make_batch_solver", "MPCController", "broadcast_state", "shift_state",
    "World", "launch", "InsideTimeShardKKT", "ShardAxis", "TimeShardedKKT", "dcr_solve",
    "make_sharded_tridiag_solver",
]
