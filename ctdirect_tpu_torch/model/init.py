"""Initial guess handling.

Reference behavior (DOCP_variables.jl:122–145, test/ci/test_initial_guess.jl:32–54):
the default initial guess is the constant 0.1 for EVERY NLP variable, selectively
overwritten by whatever the user supplies. Supported forms per component group:

- state / control: constant vector, callable ``t -> value``, or an interpolation
  table ``(times, values)`` with values of shape (nt, dim) — linearly interpolated.
- variable: constant vector.
- a previous :class:`~ctdirect_tpu_torch.model.solution.Solution` is a valid init
  (warm start, test/ci/test_initial_guess.jl:179–185): pass
  ``InitialGuess.from_solution(sol)``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np

DEFAULT_FILL = 0.1

GuessLike = Union[None, float, np.ndarray, Callable, Tuple[np.ndarray, np.ndarray]]


def _interp_rows(t: np.ndarray, tk: np.ndarray, vk: np.ndarray) -> np.ndarray:
    """Piecewise-linear interpolation of (nt, d) table rows at times t -> (len(t), d)."""
    vk = np.atleast_2d(np.asarray(vk, dtype=np.float64))
    if vk.shape[0] != len(tk):
        vk = vk.T
    return np.stack([np.interp(t, tk, vk[:, j]) for j in range(vk.shape[1])], axis=1)


def _eval_group(guess: GuessLike, t: np.ndarray, dim: int) -> Optional[np.ndarray]:
    """Evaluate one guess group at times t -> (len(t), dim), or None if not given."""
    if guess is None or dim == 0:
        return None
    if callable(guess):
        vals = np.stack(
            [np.atleast_1d(np.asarray(guess(ti), dtype=np.float64)) for ti in t]
        )
        return vals.reshape(len(t), dim)
    if isinstance(guess, tuple) and len(guess) == 2:
        tk = np.asarray(guess[0], dtype=np.float64)
        return _interp_rows(t, tk, guess[1]).reshape(len(t), dim)
    arr = np.atleast_1d(np.asarray(guess, dtype=np.float64))
    if arr.ndim == 1:
        if arr.shape[0] != dim:
            raise ValueError(f"constant guess shape {arr.shape} != ({dim},)")
        return np.broadcast_to(arr, (len(t), dim)).copy()
    raise ValueError(f"unsupported guess form: {type(guess)} with shape {arr.shape}")


class InitialGuess:
    """User initial guess for (state, control, variable)."""

    def __init__(
        self,
        state: GuessLike = None,
        control: GuessLike = None,
        variable: GuessLike = None,
    ):
        self.state = state
        self.control = control
        if variable is not None:
            variable = np.atleast_1d(np.asarray(variable, dtype=np.float64))
        self.variable = variable

    @classmethod
    def from_solution(cls, sol) -> "InitialGuess":
        """Warm start from a previous Solution (its interpolating accessors)."""
        return cls(
            state=sol.state,
            control=sol.control if sol.m > 0 else None,
            variable=sol.variable if sol.q > 0 else None,
        )

    def eval_variable(self, q: int) -> np.ndarray:
        v = np.full((q,), DEFAULT_FILL, dtype=np.float64)
        if self.variable is not None and q > 0:
            v[:] = np.asarray(self.variable, dtype=np.float64).reshape(q)
        return v

    def eval_state(self, t: np.ndarray, n: int) -> np.ndarray:
        vals = _eval_group(self.state, t, n)
        if vals is None:
            vals = np.full((len(t), n), DEFAULT_FILL, dtype=np.float64)
        return vals

    def eval_control(self, t: np.ndarray, m: int) -> np.ndarray:
        vals = _eval_group(self.control, t, m)
        if vals is None:
            vals = np.full((len(t), m), DEFAULT_FILL, dtype=np.float64)
        return vals
