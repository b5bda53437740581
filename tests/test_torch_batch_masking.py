"""Batched whole-IPM solves, continued from tests/test_torch_batch.py: the
double-integrator case against the JAX BatchSolver, and each batched
instance against the port's own unbatched solve of it."""

import numpy as np
import pytest

from torch_helpers import BATCH as B
from torch_helpers import batch_inputs, check_batch_solver_matches_jax, n


def test_batch_solver_matches_jax_double_integrator():
    check_batch_solver_matches_jax("double_integrator")


@pytest.mark.parametrize("kkt_mode", ["cr", "structured"])
def test_batched_instances_equal_unbatched_solves(kkt_mode, capsys, monkeypatch):
    """Each batched instance follows its own unbatched solve: same status and
    iteration count, z to 1e-10. The instances need different iteration counts
    and only some of them regularize (read from the unbatched solver's debug
    lines). With the CR solve, every batched KKT solve is ONE call of the
    batched CR (the kernel launch on a card)."""
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.parallel import BatchSolver
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver import cr_kernel
    from ctdirect_tpu_torch.solver.interface import _get_solver

    calls = []
    batched_cr = cr_kernel.cr_solve_batched

    def counting(*args):
        calls.append(args[0].shape[-1])
        return batched_cr(*args)

    monkeypatch.setattr(cr_kernel, "cr_solve_batched", counting)
    p = get_problem("cartpole")
    d = ct.transcribe(p.ocp, grid_size=12, scheme="trapeze", device="cpu")
    z0, cl, cu, zl, zu = batch_inputs(d, p.init, seed=0)
    opts = ct.IPMOptions(tol=1e-8, max_iter=60, kkt_mode=kkt_mode, debug=True)
    solver = BatchSolver(d, opts, device="cpu")
    res = solver(z0, cl, cu)
    if kkt_mode == "cr":
        assert calls == [B] * solver.stats.kkt_solves  # one whole-batch CR per KKT solve
    assert solver.stats.iterations == int(res.iterations.max())
    capsys.readouterr()

    run = _get_solver(d, opts)
    regularized = []
    for b in range(B):
        r, _ = run(z0[b], d._z_lb, d._z_ub, cl[b], cu[b])
        lines = capsys.readouterr().out.splitlines()
        regularized.append(any(not line.endswith("dw=0.0e+00") for line in lines))
        assert int(r.status) == int(res.status[b]) == 0
        assert int(r.iterations) == int(res.iterations[b])
        np.testing.assert_allclose(n(res.z[b]), n(r.z), rtol=0, atol=1e-10)
        np.testing.assert_allclose(float(res.objective[b]), float(r.objective), rtol=1e-12)
    assert len(set(n(res.iterations).tolist())) == B
    assert set(regularized) == {True, False}
