"""Structure reports of the port (mirrors tests/test_structure.py): the true
AD Jacobian of the constraint program lies inside the block-band +
arrowhead envelope that StructuredKKT assembles, for every scheme and for
the edge cases (zero control, free tf, path + boundary constraints); and
the goddard report equals the JAX package's field by field."""

import numpy as np
import pytest

from torch_helpers import jax_docp, torch_docp

from ctdirect_tpu_torch.utils.structure import (
    hessian_occupancy,
    jacobian_occupancy,
    predicted_jacobian_envelope,
    structure_report,
    verify_structure,
)

ALL_SCHEMES = [
    "trapeze",
    "midpoint",
    "euler",
    "euler_implicit",
    "gauss_legendre_1",
    "gauss_legendre_2",
    "gauss_legendre_3",
    "gauss_legendre_2_constant_control",
    "gauss_legendre_3_constant_control",
]


@pytest.mark.parametrize("scheme", ALL_SCHEMES)
def test_pattern_problem_envelope(scheme):
    """pattern problem: every KKT coupling active at dims (1,1,1)."""
    assert verify_structure(torch_docp("pattern", grid_size=5, scheme=scheme))


@pytest.mark.parametrize(
    "name,scheme",
    [
        ("goddard", "trapeze"),  # free tf + path cons + boundary
        ("goddard", "gauss_legendre_2"),
        ("double_integrator_minenergy", "midpoint"),
        ("estimate_initial_condition", "trapeze"),  # zero control
        ("truck_trailer", "midpoint"),  # free tf + path + multi-boundary
    ],
)
def test_fixture_envelopes(name, scheme):
    assert verify_structure(torch_docp(name, grid_size=4, scheme=scheme))


def test_report_contents():
    docp = torch_docp("goddard", grid_size=10)
    rep = structure_report(docp)
    n, m = 3, 1
    assert rep["step_block_width"] == n + m
    assert rep["tail_width"] == n + m  # trapeze carries the final control
    assert rep["nz"] == docp.nz and rep["nc"] == docp.nc
    assert rep["envelope_contains_jacobian"]
    # the true jacobian is strictly sparser than dense
    assert rep["jacobian_density"] < 0.5


def test_occupancy_vs_envelope_shapes():
    docp = torch_docp("pattern", grid_size=3)
    occ = jacobian_occupancy(docp)
    env = predicted_jacobian_envelope(docp)
    assert occ.shape == env.shape == (docp.nc, docp.nz)
    # envelope is banded: first defect row must NOT touch the last step block
    assert not env[0, (docp.N - 1) * docp.bw + docp.tail_w - 1]
    assert np.all(env | ~occ)


def test_report_matches_jax():
    """structure_report of goddard at trapeze N=10 equals the JAX package's
    field by field; so do the Jacobian and Hessian occupancies."""
    from ctdirect_tpu.utils import structure as sj

    dj, dt = jax_docp("goddard", grid_size=10), torch_docp("goddard", grid_size=10)
    rj, rt = sj.structure_report(dj), structure_report(dt)
    assert rt == rj
    np.testing.assert_array_equal(jacobian_occupancy(dt), sj.jacobian_occupancy(dj))
    np.testing.assert_array_equal(hessian_occupancy(dt), sj.hessian_occupancy(dj))
    np.testing.assert_array_equal(predicted_jacobian_envelope(dt), sj.predicted_jacobian_envelope(dj))
