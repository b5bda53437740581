"""Batched whole-IPM solves: the port's BatchSolver against the JAX BatchSolver
(both given the cyclic-reduction StructuredKKT, float64, CPU) on cart-pole.
tests/test_torch_batch_masking.py holds the double-integrator case and each
batched instance against the port's own unbatched solve of it (the JAX batch
compile takes most of a file's time, so the cases are split in two files).

Instances differ in their initial state x0 (through the boundary rows) and,
in one case, in their control box (zl/zu): they need different iteration
counts, and only some of them engage the regularization ladder, so a
batch-wide condition standing in for a per-instance one shows up here."""

from types import SimpleNamespace

import pytest
import torch

from torch_helpers import check_batch_solver_matches_jax


def test_batch_solver_matches_jax():
    check_batch_solver_matches_jax("cartpole")


def test_batch_solver_rejects_mesh_and_mismatched_device():
    from ctdirect_tpu_torch.parallel import BatchSolver, make_batch_solver
    from torch_helpers import torch_docp

    d = torch_docp(grid_size=4)
    # a mesh without the named batch axis (the split B % D != 0 is refused in
    # tests/test_torch_time_shard.py::test_refusals, in a world of 3)
    with pytest.raises(ValueError, match="no axis 'batch'"):
        BatchSolver(d, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="no axis 'rows'"):
        BatchSolver(d, mesh=SimpleNamespace(mesh_dim_names=("batch",)), batch_axis="rows", device="cpu")
    with pytest.raises(ValueError, match="DOCP is on"):
        make_batch_solver(d, device="cpu", dtype=torch.float32)
