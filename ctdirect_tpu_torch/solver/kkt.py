"""KKT operators: derivative computation + condensed-system solve (PyTorch port
of `ctdirect_tpu.solver.kkt`).

The IPM core (ipm.py) is agnostic to HOW the condensed symmetric system

    [ W~ + Sigma_z + dw I    J~^T          ] [dz  ]   [ -rz ]
    [ J~                     -(D + dc I)   ] [dlam] = [ -rp ]

is represented and solved (W~ and J~ are the gradient-SCALED Lagrangian Hessian
and constraint Jacobian). A KKT operator provides:

    row_norms(z)                      -> (nc,) unscaled |J| row-inf-norms
    prepare(z, lam, sf, sc)           -> opaque data (the scaled W~, J~ in some form)
    solve(data, sigma_z, Drow, dw, dc, rz, rp) -> (dz, dlam)
    diag_scale(data)                  -> scalar ~ 1 + max |diag W~|
    gauss_newton_data(data)           -> data with the Hessian zeroed
    lsq_lambda(z, g, sf, sc, Drow)    -> lam least-squares init

`DenseKKT` materializes W and J and solves densely — the correctness oracle for
the structured path (structured_kkt.py)."""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.func import hessian, jacfwd


@functools.lru_cache(maxsize=None)
def _gj_tables(n: int, device: torch.device) -> tuple:
    """Per column j, the row permutations that swap row j with row j + k
    ((n - j, n) int64), and the one-hot row masks ((n, n, 1) bool); made
    once per width and device, read only."""
    rows = torch.arange(n)
    swaps = []
    for j in range(n):
        k = torch.arange(n - j)
        perm = rows.repeat(n - j, 1)
        perm[k, j] = j + k
        perm[k, j + k] = j
        swaps.append(perm.to(device))
    return swaps, torch.eye(n, dtype=torch.bool, device=device)[:, :, None]


def _gj_eliminate(M: torch.Tensor, n: int) -> torch.Tensor:
    """Gauss-Jordan elimination WITH partial pivoting on an augmented (n, n+k)
    matrix: the pivot is the first row of maximal |value| at or below the
    diagonal. Gathers and selects instead of indexed writes, so that it runs
    under `torch.func.vmap` and the pivot never goes to the host; the row
    swap is exact. Eight launches per column (the unbatched structured solve
    is launch-bound on a GPU)."""
    swaps, is_row = _gj_tables(n, M.device)
    m = M.shape[-1]
    for j in range(n):
        k = torch.argmax(torch.abs(M[j:, j]))
        perm = swaps[j].gather(0, k.reshape(1, 1).expand(1, n))[0]
        M = M.gather(0, perm[:, None].expand(n, m))
        row = M[j] / M[j, j]
        # row j's own update is discarded by the select
        M = torch.where(is_row[j], row, M - M[:, j : j + 1] * row)
    return M


def gj_inverse(A: torch.Tensor) -> torch.Tensor:
    """Matrix inverse via pivoted Gauss-Jordan. A: (n, n) (vmap for batches)."""
    n = A.shape[-1]
    M = torch.cat([A, torch.eye(n, dtype=A.dtype, device=A.device)], dim=-1)
    return _gj_eliminate(M, n)[:, n:]


def gj_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B via pivoted Gauss-Jordan. A: (n, n), B: (n, k)."""
    n = A.shape[-1]
    M = torch.cat([A, B], dim=-1)
    return _gj_eliminate(M, n)[:, n:]


class DenseKKT:
    """Dense W/J via torch.func.hessian / jacfwd; dense LU solve.

    The correctness oracle for StructuredKKT at small sizes. f_user/c_user are
    the UNSCALED problem callables."""

    def __init__(self, f_user: Callable, c_user: Callable, nz: int, nc: int):
        self.f_user = f_user
        self.c_user = c_user
        self.nz = nz
        self.nc = nc

    def row_norms(self, z):
        J = jacfwd(self.c_user)(z)
        return torch.amax(torch.abs(J), dim=1)

    def prepare(self, z, lam, sf, sc):
        def lag(zz):
            return sf * self.f_user(zz) + torch.dot(sc * lam, self.c_user(zz))

        W = hessian(lag)(z)
        J = sc[:, None] * jacfwd(self.c_user)(z)
        return (W, J)

    def solve(self, data, sigma_z, Drow, delta_w, delta_c, rz, rp):
        W, J = data
        Hbar = W + torch.diag(sigma_z + delta_w)
        Dreg = Drow + delta_c
        KKT = torch.cat(
            [torch.cat([Hbar, J.T], dim=1), torch.cat([J, -torch.diag(Dreg)], dim=1)],
            dim=0,
        )
        rhs = -torch.cat([rz, rp])
        # LU without the `info` check: an exactly singular system gives
        # non-finite entries, as the JAX function's does, which the IPM's
        # finiteness test rejects, and nothing waits for the device
        sol = torch.linalg.solve_ex(KKT, rhs)[0]
        return sol[: self.nz], sol[self.nz :]

    def diag_scale(self, data):
        W, _ = data
        return 1.0 + torch.amax(torch.abs(torch.diagonal(W)))

    def gauss_newton_data(self, data):
        """Same constraint Jacobians, zero Hessian — the Gauss-Newton system
        the restoration step solves."""
        W, J = data
        return (torch.zeros_like(W), J)

    def lsq_lambda(self, z, g, sf, sc, Drow=None):
        """argmin_lam |g + J~^T lam| via (J~ J~^T + D + eps) lam = -J~ g."""
        J = sc[:, None] * jacfwd(self.c_user)(z)
        M = J @ J.T + 1e-8 * torch.eye(self.nc, dtype=z.dtype, device=z.device)
        if Drow is not None:
            M = M + torch.diag(Drow)
        return gj_solve(M, -(J @ g)[:, None])[:, 0]
