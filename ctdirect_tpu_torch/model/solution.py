"""Solution object: continuous-time accessors over the discrete solve result.

Plays the role of CTModels.Solution in the reference (built by build_OCP_solution,
DOCP_data.jl:514–633): functional accessors t -> x(t), u(t), p(t) by piecewise-linear
interpolation of the grid values, plus duals and solver info. The costate p(t_i) comes
from the NLP multipliers of the state-equation rows (reference common.jl:20–32); path
multipliers are normalized by the local step h_i to approximate the continuous measure
(DOCP_data.jl:594–602) — both are done when the solution is assembled in
ctdirect_tpu_torch.transcription.docp before this object is constructed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _interp(t, tk, vk):
    """Piecewise-linear interp of (nt, d) values at scalar-or-vector t."""
    t_arr = np.atleast_1d(np.asarray(t, dtype=np.float64))
    out = np.stack(
        [np.interp(t_arr, tk, vk[:, j]) for j in range(vk.shape[1])], axis=1
    )
    if np.isscalar(t) or np.ndim(t) == 0:
        return out[0]
    return out


class Solution:
    """Result of one DOCP solve, with interpolating trajectory accessors."""

    def __init__(
        self,
        *,
        ocp,
        time_grid: np.ndarray,  # (N+1,)
        control_grid: np.ndarray,  # (Nc,) times where U rows live
        X: np.ndarray,  # (N+1, n)
        U: np.ndarray,  # (Nc, m)
        P: np.ndarray,  # (N, n) costate at interior nodes (state-eq multipliers)
        v: np.ndarray,  # (q,)
        objective: float,
        iterations: int,
        constraints_violation: float,
        status: int,
        message: str,
        successful: bool,
        path_duals: Optional[np.ndarray] = None,  # (N+1, n_path), h-normalized
        boundary_duals: Optional[np.ndarray] = None,  # (n_boundary,)
        lower_box_duals: Optional[np.ndarray] = None,  # flat, layout of z
        upper_box_duals: Optional[np.ndarray] = None,
        state_box_duals_lower: Optional[np.ndarray] = None,  # (N+1, n)
        state_box_duals_upper: Optional[np.ndarray] = None,
        control_box_duals_lower: Optional[np.ndarray] = None,  # (Nc, m)
        control_box_duals_upper: Optional[np.ndarray] = None,
        variable_box_duals_lower: Optional[np.ndarray] = None,  # (q,)
        variable_box_duals_upper: Optional[np.ndarray] = None,
        infos: Optional[dict] = None,
    ):
        self.ocp = ocp
        self.time_grid = np.asarray(time_grid, dtype=np.float64)
        self.control_grid = np.asarray(control_grid, dtype=np.float64)
        self._X = np.asarray(X, dtype=np.float64).reshape(len(self.time_grid), ocp.n)
        self._U = np.asarray(U, dtype=np.float64).reshape(len(self.control_grid), ocp.m)
        # costate lives on the N interior defect rows; extend to N+1 nodes by
        # repeating the last value so p(t) interpolates over the full grid
        P = np.asarray(P, dtype=np.float64).reshape(-1, ocp.n)
        if P.shape[0] == len(self.time_grid) - 1 and P.shape[0] > 0:
            P = np.vstack([P, P[-1:]])
        self._P = P
        self.variable = np.asarray(v, dtype=np.float64).reshape(ocp.q)
        self.objective = float(objective)
        self.iterations = int(iterations)
        self.constraints_violation = float(constraints_violation)
        self.status = int(status)
        self.message = str(message)
        self.successful = bool(successful)
        self.path_duals = path_duals
        self.boundary_duals = boundary_duals
        self.lower_box_duals = lower_box_duals
        self.upper_box_duals = upper_box_duals
        # per-group box-multiplier views (≙ the reference Solution's per-node
        # state/control/variable bound-multiplier components,
        # DOCP_data.jl:521–560); grid arrays + functional accessors below
        self.state_box_duals_lower = state_box_duals_lower
        self.state_box_duals_upper = state_box_duals_upper
        self.control_box_duals_lower = control_box_duals_lower
        self.control_box_duals_upper = control_box_duals_upper
        self.variable_box_duals_lower = variable_box_duals_lower
        self.variable_box_duals_upper = variable_box_duals_upper
        self.infos = infos or {}

    # ---- dims ----
    @property
    def n(self):
        return self.ocp.n

    @property
    def m(self):
        return self.ocp.m

    @property
    def q(self):
        return self.ocp.q

    # ---- functional accessors ----
    def state(self, t):
        return _interp(t, self.time_grid, self._X)

    def control(self, t):
        """u(t). Zero-dimensional control returns an empty array
        (reference test/ci/test_zero_control.jl:50–70)."""
        if self.ocp.m == 0:
            t_arr = np.atleast_1d(np.asarray(t))
            out = np.zeros((len(t_arr), 0))
            return out[0] if np.ndim(t) == 0 else out
        return _interp(t, self.control_grid, self._U)

    def costate(self, t):
        return _interp(t, self.time_grid[: len(self._P)], self._P)

    def state_box_duals(self, t):
        """(lower, upper) state bound multipliers at time t, each (n,) —
        positive where the corresponding box bound is active."""
        return (
            _interp(t, self.time_grid, self.state_box_duals_lower),
            _interp(t, self.time_grid, self.state_box_duals_upper),
        )

    def control_box_duals(self, t):
        """(lower, upper) control bound multipliers at time t, each (m,)."""
        return (
            _interp(t, self.control_grid, self.control_box_duals_lower),
            _interp(t, self.control_grid, self.control_box_duals_upper),
        )

    @property
    def variable_box_duals(self):
        """(lower, upper) bound multipliers on the static variable v."""
        return self.variable_box_duals_lower, self.variable_box_duals_upper

    # ---- grid values (no interpolation) ----
    @property
    def state_values(self):
        return self._X

    @property
    def control_values(self):
        return self._U

    @property
    def costate_values(self):
        return self._P

    def __repr__(self):
        return (
            f"Solution(name={self.ocp.name!r}, objective={self.objective:.6g}, "
            f"iterations={self.iterations}, successful={self.successful}, "
            f"status={self.status}, message={self.message!r})"
        )
