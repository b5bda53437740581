"""How each package's BatchSolver reads the f32 block-solve options under
kkt_mode="structured" (ROADMAP.md queue 3, deviations).

The JAX BatchSolver builds the f64 `StructuredKKT(docp)` whatever the
options say (`ctdirect_tpu/parallel/batch.py:53-56`): kkt_solve_dtype,
kkt_refine and kkt_equilibrate are dropped. The port's builds the operator
`solve` builds (`solver/interface.py::make_kkt`), so it honours them. Each
side is held to its own reading: the JAX batch under the f32 options equals
its f64 batch; the port's equals its batch given the f32 operator
explicitly, and that one equals the JAX batch given the same operator, by
status and objective to 1e-8. The instances (DI trapeze and midpoint,
midpoint cart-pole; `torch_helpers.batch_inputs`) end where they end
whatever the rounding (ROADMAP.md queue 3, behaviours of the reference), so
the comparison with the JAX package does not rest on rounding. The JAX
batches run jitted, as the JAX BatchSolver always does."""

import functools

import numpy as np
import pytest
import torch

from torch_helpers import CASES, batch_inputs, n

OPTS = dict(tol=1e-8, max_iter=60)
F32 = dict(kkt_solve_dtype="f32")
# (CASES key, scheme)
INSTANCES = [("double_integrator", "trapeze"), ("double_integrator", "midpoint"), ("cartpole", "midpoint")]


@functools.lru_cache(maxsize=None)
def _docps(case, scheme):
    from ctdirect_tpu import transcribe as transcribe_j
    from ctdirect_tpu.problems import get_problem as problem_j
    from ctdirect_tpu_torch import transcribe as transcribe_t
    from ctdirect_tpu_torch.problems import get_problem as problem_t

    c = CASES[case]
    dj = transcribe_j(problem_j(c["name"]).ocp, grid_size=c["grid_size"], scheme=scheme)
    dt = transcribe_t(problem_t(c["name"]).ocp, grid_size=c["grid_size"], scheme=scheme, device="cpu")
    inputs = batch_inputs(dj, problem_j(c["name"]).init, seed=1, box_scale=c["box_scale"])
    return dj, dt, inputs


@functools.lru_cache(maxsize=None)
def _jax(case, scheme, options, f32_kkt):
    """The JAX BatchSolver's result (numpy fields) under IPMOptions(**OPTS,
    **options), given StructuredKKT(solve_dtype=float32, refine=2) when
    f32_kkt, else the operator it builds itself."""
    import jax.numpy as jnp

    from ctdirect_tpu.parallel.batch import BatchSolver
    from ctdirect_tpu.solver.ipm import IPMOptions
    from ctdirect_tpu.solver.structured_kkt import StructuredKKT

    dj, _, inputs = _docps(case, scheme)
    kkt = StructuredKKT(dj, solve_dtype=jnp.float32, refine=2) if f32_kkt else None
    res = BatchSolver(dj, IPMOptions(**OPTS, **dict(options)), kkt=kkt)(*(jnp.asarray(a) for a in inputs))
    return {f: np.asarray(getattr(res, f)) for f in res._fields}


def _torch(case, scheme, options, f32_kkt):
    from ctdirect_tpu_torch.parallel import BatchSolver
    from ctdirect_tpu_torch.solver.ipm import IPMOptions
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT

    _, dt, inputs = _docps(case, scheme)
    kkt = StructuredKKT(dt, solve_dtype=torch.float32, refine=2) if f32_kkt else None
    res = BatchSolver(dt, IPMOptions(**OPTS, **options), kkt=kkt, device="cpu")(*inputs)
    return {f: n(getattr(res, f)) for f in res._fields}


@pytest.mark.parametrize("case,scheme", INSTANCES)
def test_jax_batch_solver_drops_the_f32_options(case, scheme):
    """The JAX batch under kkt_solve_dtype="f32" is its f64 batch, bit for
    bit: it solves with StructuredKKT(docp) whatever the options say."""
    f64 = _jax(case, scheme, (), False)
    f32 = _jax(case, scheme, tuple(F32.items()), False)
    assert f64["successful"].all()
    for field, value in f64.items():
        np.testing.assert_array_equal(f32[field], value, err_msg=field)


@pytest.mark.parametrize("case,scheme", INSTANCES)
def test_port_batch_solver_honours_the_f32_options(case, scheme):
    """The port's batch under kkt_solve_dtype="f32" is its batch given
    StructuredKKT(solve_dtype=float32, refine=2) (Ruiz on, as the options
    default it), bit for bit; and that batch is the JAX batch given the
    same operator, by status and objective to 1e-8."""
    honoured = _torch(case, scheme, F32, False)
    explicit = _torch(case, scheme, {}, True)
    for field, value in explicit.items():
        np.testing.assert_array_equal(honoured[field], value, err_msg=field)
    jax_f32 = _jax(case, scheme, (), True)
    assert explicit["successful"].all()
    np.testing.assert_array_equal(explicit["status"], jax_f32["status"])
    np.testing.assert_allclose(explicit["objective"], jax_f32["objective"], rtol=1e-8)
