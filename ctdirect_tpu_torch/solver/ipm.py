"""Primal-dual interior-point NLP solver (PyTorch port of
`ctdirect_tpu.solver.ipm`).

Problem form (the DOCP emits exactly this):

    min  f(z)   s.t.   cl <= c(z) <= cu,   zl <= z <= zu

Rows with cl == cu are equalities; the rest get slacks s with box [cl, cu]
(Ipopt's formulation). Barrier terms are applied to every finite bound of z and
s. The Newton system is condensed to the symmetric (nz + nc) form

    [ W + Sigma_z + dw*I    J^T          ] [dz  ]   [ -rbar_z ]
    [ J                     -(D + dc*I)  ] [dlam] = [ -rbar_p ]

with D = 0 on equality rows and Sigma_s^{-1} on inequality rows, followed by
recovery of ds and the bound multiplier steps, fraction-to-boundary step limits
and a filter line search (Waechter-Biegler) with second-order correction.
Regularization (dw, dc) is adapted inertia-free: if the step has insufficient
positive curvature (or the solve produced NaNs), dw is increased and the KKT
system re-solved. Monotone Fiacco-McCormick barrier schedule (or the LOQO
adaptive rule), Ipopt-scaled termination error.

The JAX package runs this as one traced program (`lax.while_loop`/`cond`);
here `ipm_solve` is one instance with Python control flow: every branch reads
its condition back from the device (`.item()`), and the arithmetic follows
the JAX package step for step so that a solve lands on the same iterates.
`ipm_solve_batched` is the counterpart of `jax.vmap(ipm_solve)`: B instances
in one masked loop, each on the iterates `ipm_solve` gives it alone: bit for
bit under the "cr" and "dense" solves in f64, to rounding where a reduction
runs in another order under vmap (the structured scan; the f64 refinement
residual's einsums). Its iteration is ten segments between the host's reads
(`batched_ipm`), which `solver/graph.py` replays as CUDA graphs on a card:
for `BatchSolver`, and at B=1 for the compiled unbatched solve
(`solver/interface.py::DOCPSolver`).
Derivatives come from `torch.func` (grad, vjp, jvp, vmap).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.func import grad, jvp, vjp, vmap

from ctdirect_tpu_torch.solver.kkt import DenseKKT


# ----------------------------------------------------------------------------
# Specs
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class IPMOptions:
    """Solver options (defaults chosen to match Ipopt's), field for field the
    JAX package's IPMOptions. `eta_ls`, `delta_w_max` and `max_soc` are
    accepted and read by no code, as in the JAX package."""

    tol: float = 1e-8
    acceptable_tol: float = 1e-6  # Ipopt Solved_To_Acceptable_Level fallback
    mu_init: float = 0.1
    mu_min: float = 1e-12
    # "monotone" (Fiacco-McCormick) or "adaptive" (LOQO-style centrality rule)
    mu_strategy: str = "monotone"
    kappa_mu: float = 0.2  # linear barrier decrease factor
    theta_mu: float = 1.5  # superlinear barrier decrease exponent
    # Ipopt bound_relax_factor: every box bound is relaxed internally by
    # eps*max(1,|b|); the final primal point is clipped back
    bound_relax_factor: float = 1e-8
    kappa_eps: float = 10.0  # barrier subproblem tolerance = kappa_eps * mu
    tau_min: float = 0.99  # fraction-to-boundary minimum
    max_iter: int = 200
    max_ls: int = 25  # backtracking steps
    eta_ls: float = 1e-4  # Armijo constant (unread)
    s_max: float = 100.0  # KKT error scaling threshold (Ipopt s_max)
    kappa_push: float = 1e-2  # initial-point push from bounds
    delta_w_init: float = 1e-8
    delta_w_max: float = 1e20  # (unread)
    delta_c: float = 1e-8  # constraint-block regularization
    max_reg_trials: int = 20
    curvature_frac: float = 1e-11  # inertia-free test threshold (Chiang-Zavala)
    max_soft_fail: int = 8  # consecutive failed line searches before abort
    # "structured" (block-tridiag elimination, O(N) depth) | "cr" (block cyclic
    # reduction) | "dense" (correctness oracle, small N only)
    kkt_mode: str = "structured"
    # "f32": block solve in float32 inside the f64 Newton loop, with
    # kkt_refine refinement sweeps and Ruiz scaling (kkt_equilibrate=None:
    # on for f32); None = full precision
    kkt_solve_dtype: Optional[str] = None
    kkt_refine: int = 2
    kkt_equilibrate: Optional[bool] = None
    grad_scaling: bool = True  # Ipopt gradient-based f/c scaling at z0
    scaling_max_grad: float = 100.0
    lsq_lambda_init: bool = True  # least-squares equality multiplier init
    lambda_init_max: float = 1e3  # reject LS init if larger
    # dual refresh (Ipopt recalc_y) when the line search collapses while
    # nearly feasible
    recalc_lam: bool = True
    recalc_lam_feas_tol: float = 1e-3
    recalc_lam_alpha: float = 0.02
    # --- filter line search (Waechter-Biegler) parameters, Ipopt defaults ---
    filter_size: int = 64  # fixed-capacity filter (circular overwrite)
    gamma_theta: float = 1e-5
    gamma_phi: float = 1e-8
    delta_switch: float = 1.0
    s_theta: float = 1.1
    s_phi: float = 2.3
    eta_phi: float = 1e-8  # Armijo constant for f-type steps
    kappa_soc: float = 0.99  # SOC acceptance: theta_soc <= kappa_soc * theta
    max_soc: int = 3  # second-order correction rounds (unread)
    debug: bool = False  # print one line of line-search diagnostics per iteration

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class NLPSpec(NamedTuple):
    """Static structure of the NLP (masks are numpy bools)."""

    nz: int
    nc: int
    eq_mask: np.ndarray  # (nc,) True on equality rows (cl == cu)
    zl_mask: np.ndarray  # (nz,) True where zl finite
    zu_mask: np.ndarray
    sl_mask: np.ndarray  # (nc,) finite lower bound on inequality-row slack
    su_mask: np.ndarray


def make_spec(zl, zu, cl, cu) -> NLPSpec:
    zl, zu = np.asarray(zl), np.asarray(zu)
    cl, cu = np.asarray(cl), np.asarray(cu)
    eq = np.isfinite(cl) & np.isfinite(cu) & (cl == cu)
    ineq = ~eq
    return NLPSpec(
        nz=zl.shape[0],
        nc=cl.shape[0],
        eq_mask=eq,
        zl_mask=np.isfinite(zl),
        zu_mask=np.isfinite(zu),
        sl_mask=ineq & np.isfinite(cl),
        su_mask=ineq & np.isfinite(cu),
    )


class IPMResult(NamedTuple):
    z: torch.Tensor
    lam: torch.Tensor  # constraint multipliers (nc,)
    zL: torch.Tensor  # lower bound multipliers on z (nz,)
    zU: torch.Tensor
    s: torch.Tensor  # slacks (nc; meaningful on inequality rows)
    yL: torch.Tensor  # slack lower-bound duals (inequality rows)
    yU: torch.Tensor
    objective: torch.Tensor
    iterations: int
    kkt_error: torch.Tensor
    constraints_violation: torch.Tensor
    status: int  # 0 solved, 1 max_iter, 2 line-search stall, 3 diverged, 4 acceptable
    successful: bool


STATUS_MESSAGES = {
    0: "Solve_Succeeded",
    1: "Maximum_Iterations_Exceeded",
    2: "Search_Direction_Becomes_Too_Small",
    3: "Diverging_Iterates",
    4: "Solved_To_Acceptable_Level",
}


# ----------------------------------------------------------------------------
# Helpers (all vmappable: the warm resolve runs them under torch.func.vmap,
# where every reduction stays per instance)
# ----------------------------------------------------------------------------


def _safe_gap(x, lb, mask):
    """x - lb where the bound is finite, else 1 (keeps arithmetic NaN-free)."""
    return torch.where(mask, x - torch.where(mask, lb, 0.0), 1.0)


def _amin(x, initial: float):
    """min(x) with an initial value (jnp.min(x, initial=...)); empty x gives
    the initial value."""
    if x.shape[-1] == 0:
        return x.new_full((), initial)
    return torch.clamp(torch.amin(x), max=initial)


def _amax(x, initial: float):
    """max(x) with an initial value (jnp.max(x, initial=...))."""
    if x.shape[-1] == 0:
        return x.new_full((), initial)
    return torch.clamp(torch.amax(x), min=initial)


def _max_step_to_boundary(x, dx, lb, ub, lmask, umask, tau):
    """Largest alpha in (0, 1] with x + alpha dx >= lb + (1-tau) gap etc."""
    gapL = _safe_gap(x, lb, lmask)
    gapU = _safe_gap(ub, x, umask)
    # alpha limit where dx pushes toward a finite bound
    aL = torch.where(lmask & (dx < 0), -tau * gapL / torch.where(dx < 0, dx, -1.0), 1.0)
    aU = torch.where(umask & (dx > 0), tau * gapU / torch.where(dx > 0, dx, 1.0), 1.0)
    lo = torch.minimum(_amin(aL, 1.0), _amin(aU, 1.0))
    return torch.clamp(lo, 0.0, 1.0)


def _dual_step_to_boundary(w, dw, mask, tau):
    """Largest alpha keeping w + alpha dw >= (1-tau) w (w >= 0 duals)."""
    a = torch.where(mask & (dw < 0), -tau * w / torch.where(dw < 0, dw, -1.0), 1.0)
    return torch.clamp(_amin(a, 1.0), 0.0, 1.0)


def _clip(x, lo, hi):
    """jnp.clip with tensor bounds: min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


# ----------------------------------------------------------------------------
# Core solver
# ----------------------------------------------------------------------------


class _Carry(NamedTuple):
    z: torch.Tensor
    s: torch.Tensor  # (nc,) slacks; 0 on eq rows
    lam: torch.Tensor
    wL: torch.Tensor  # z lower bound duals
    wU: torch.Tensor
    yL: torch.Tensor  # slack lower bound duals
    yU: torch.Tensor
    mu: torch.Tensor
    filt_theta: torch.Tensor  # (filter_size,) augmented theta entries (inf = empty)
    filt_phi: torch.Tensor  # (filter_size,) augmented phi entries
    filt_n: int  # next write slot
    delta_w_last: torch.Tensor
    it: int
    done: bool
    status: int
    kkt_err: torch.Tensor
    soft_fails: int


def ipm_solve(
    f: Callable,
    c: Callable,
    spec: NLPSpec,
    z0,
    zl,
    zu,
    cl,
    cu,
    options: IPMOptions = IPMOptions(),
    kkt=None,
    return_history: bool = False,
    *,
    device,
    dtype: torch.dtype = torch.float64,
):
    """Solve the NLP on `device` in `dtype`.

    `kkt` is a KKT operator (see solver/kkt.py) supplying derivative assembly
    and the condensed-system solve; defaults to DenseKKT. Pass a StructuredKKT
    to solve the block-tridiagonal + arrowhead collocation system in O(N).

    return_history=True returns (result, history), as the JAX package's
    does: history is six tensors of length max_iter on `device` (the
    iteration count, mu, the KKT error, the filter's next slot, the last
    primal regularization and the scaled objective f(z) after each
    iteration; the rows after the last iteration repeat its values, as the
    JAX package's masked scan does), None at max_iter == 0. The rows are
    written on the device as the solve goes, with no read back."""
    opts = options
    nz, nc = spec.nz, spec.nc

    def tensor(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    def mask(x):
        return torch.as_tensor(x, dtype=torch.bool, device=device)

    z0, zl, zu, cl, cu = (tensor(x) for x in (z0, zl, zu, cl, cu))
    zl_orig, zu_orig = zl, zu

    eq = mask(spec.eq_mask)
    ineq = ~eq
    zlm = mask(spec.zl_mask)
    zum = mask(spec.zu_mask)
    slm = mask(spec.sl_mask)
    sum_ = mask(spec.su_mask)
    n_duals = float(nc + nz)  # for Ipopt-style scaling

    # Ipopt bound_relax_factor: relax every finite box bound (z boxes and
    # inequality-row slack boxes) by eps*max(1,|b|); equality rows untouched.
    if opts.bound_relax_factor > 0:
        brf = opts.bound_relax_factor

        def _relax(lo, hi, row_eq=None):
            rl = lo - brf * torch.clamp(torch.abs(lo), min=1.0)
            rh = hi + brf * torch.clamp(torch.abs(hi), min=1.0)
            if row_eq is not None:  # keep equality rows exact
                rl = torch.where(row_eq, lo, rl)
                rh = torch.where(row_eq, hi, rh)
            return rl, rh

        zl, zu = _relax(zl, zu)
        cl, cu = _relax(cl, cu, eq)

    # ---- gradient-based scaling (Ipopt nlp_scaling_method=gradient-based):
    # scale f and each constraint row so its gradient inf-norm at z0 is <= 100.
    f_user, c_user = f, c
    if kkt is None:
        kkt = DenseKKT(f_user, c_user, nz, nc)
    if opts.grad_scaling:
        g0 = grad(f_user)(z0)
        scale_f = torch.clamp(
            opts.scaling_max_grad / torch.clamp(torch.amax(torch.abs(g0)), min=1e-8), max=1.0
        )
        row_norm = kkt.row_norms(z0)
        scale_c = torch.clamp(opts.scaling_max_grad / torch.clamp(row_norm, min=1e-8), max=1.0)

        def f(z):
            return scale_f * f_user(z)

        def c(z):
            return scale_c * c_user(z)

        cl = scale_c * cl
        cu = scale_c * cu
    else:
        scale_f = tensor(1.0)
        scale_c = torch.ones((nc,), dtype=dtype, device=device)

    grad_f = grad(f)

    def lag_hvp(z, lam, v):
        """(scaled) Lagrangian Hessian-vector product, matrix-free."""
        g = grad(lambda z3: f(z3) + torch.dot(lam, c(z3)))
        return jvp(g, (z,), (v,))[1]

    def vjp_c(z, lam):
        return vjp(c, z)[1](lam)[0]

    # slack bounds: cl/cu on inequality rows; harmless [0,0] placeholders on eq rows
    sl = torch.where(ineq, cl, 0.0)
    su = torch.where(ineq, cu, 0.0)

    # ---- initial point (Ipopt-style push into the interior) ----
    kap = opts.kappa_push

    def push_interior(x, lb, ub, lmask, umask):
        lo = torch.where(lmask, lb, -torch.inf)
        hi = torch.where(umask, ub, torch.inf)
        width = torch.where(lmask & umask, hi - lo, torch.inf)
        pL = torch.where(
            lmask, torch.minimum(kap * torch.clamp(torch.abs(lo), min=1.0), 0.5 * width), 0.0
        )
        pU = torch.where(
            umask, torch.minimum(kap * torch.clamp(torch.abs(hi), min=1.0), 0.5 * width), 0.0
        )
        x = torch.where(lmask, torch.maximum(x, lo + pL), x)
        x = torch.where(umask, torch.minimum(x, hi - pU), x)
        return x

    z_init = push_interior(z0, zl, zu, zlm, zum)
    c0 = c(z_init)
    s_init = torch.where(ineq, push_interior(c0, sl, su, slm, sum_), 0.0)

    mu0 = tensor(opts.mu_init)
    gapL0 = _safe_gap(z_init, zl, zlm)
    gapU0 = _safe_gap(zu, z_init, zum)
    sgapL0 = _safe_gap(s_init, sl, slm)
    sgapU0 = _safe_gap(su, s_init, sum_)
    wL0 = torch.where(zlm, mu0 / gapL0, 0.0)
    wU0 = torch.where(zum, mu0 / gapU0, 0.0)
    yL0 = torch.where(slm, mu0 / sgapL0, 0.0)
    yU0 = torch.where(sum_, mu0 / sgapU0, 0.0)

    rhs_eq = torch.where(eq, cl, 0.0)

    # ---- residuals ----
    def primal_residual(z, s):
        return c(z) - rhs_eq - torch.where(ineq, s, 0.0)

    def kkt_error_pair(z, s, lam, wL, wU, yL, yU, mu):
        """Ipopt's scaled optimality error E_mu, at BOTH the current barrier mu
        and mu = 0 in one pass (they share every residual)."""
        gL = _safe_gap(z, zl, zlm)
        gU = _safe_gap(zu, z, zum)
        sgL = _safe_gap(s, sl, slm)
        sgU = _safe_gap(su, s, sum_)
        r_d = grad_f(z) + vjp_c(z, lam) - wL + wU
        r_s = torch.where(ineq, -lam - yL + yU, 0.0)
        r_p = primal_residual(z, s)
        prods = torch.cat(
            [
                torch.where(zlm, wL * gL, 0.0),
                torch.where(zum, wU * gU, 0.0),
                torch.where(slm, yL * sgL, 0.0),
                torch.where(sum_, yU * sgU, 0.0),
            ]
        )
        masks = torch.cat([zlm, zum, slm, sum_])
        bound_dual_sum = torch.sum(wL + wU) + torch.sum(yL + yU)
        dual_sum = torch.sum(torch.abs(lam)) + bound_dual_sum
        s_d = torch.clamp(dual_sum / n_duals, min=opts.s_max) / opts.s_max
        s_c = (
            torch.clamp(bound_dual_sum / max(1.0, float(nz + nc)), min=opts.s_max)
            / opts.s_max
        )
        e_d = torch.amax(torch.abs(torch.cat([r_d, r_s]))) / s_d
        e_p = _amax(torch.abs(r_p), 0.0)
        e_c0 = _amax(torch.abs(prods), 0.0) / s_c
        e_cmu = _amax(torch.abs(torch.where(masks, prods - mu, 0.0)), 0.0) / s_c
        base = torch.maximum(e_d, e_p)
        return torch.maximum(base, e_cmu), torch.maximum(base, e_c0), e_p

    def barrier_phi(z, s):
        gL = _safe_gap(z, zl, zlm)
        gU = _safe_gap(zu, z, zum)
        sgL = _safe_gap(s, sl, slm)
        sgU = _safe_gap(su, s, sum_)
        barr = (
            torch.sum(torch.where(zlm, torch.log(gL), 0.0))
            + torch.sum(torch.where(zum, torch.log(gU), 0.0))
            + torch.sum(torch.where(slm, torch.log(sgL), 0.0))
            + torch.sum(torch.where(sum_, torch.log(sgU), 0.0))
        )
        return f(z), barr

    # ---- filter initialization (Ipopt: theta_max = 1e4 max(1, theta_0),
    # theta_min = 1e-4 max(1, theta_0); the filter starts as {theta >= theta_max}) ----
    theta_at_init = torch.sum(torch.abs(primal_residual(z_init, s_init)))
    theta_max = 1e4 * torch.clamp(theta_at_init, min=1.0)
    theta_min = 1e-4 * torch.clamp(theta_at_init, min=1.0)

    def _fresh_filter():
        th = torch.full((opts.filter_size,), torch.inf, dtype=dtype, device=device)
        th[0] = theta_max
        ph = torch.full((opts.filter_size,), -torch.inf, dtype=dtype, device=device)
        return th, ph

    n_compl = int(
        np.sum(spec.zl_mask) + np.sum(spec.zu_mask) + np.sum(spec.sl_mask) + np.sum(spec.su_mask)
    )
    zeros_nz = torch.zeros((nz,), dtype=dtype, device=device)
    zeros_nc = torch.zeros((nc,), dtype=dtype, device=device)

    # ---- one IPM iteration ----
    def step(carry: _Carry) -> _Carry:
        z, s, lam, wL, wU, yL, yU = carry[:7]
        mu = carry.mu

        gL = _safe_gap(z, zl, zlm)
        gU = _safe_gap(zu, z, zum)
        sgL = _safe_gap(s, sl, slm)
        sgU = _safe_gap(su, s, sum_)

        if opts.mu_strategy == "adaptive" and n_compl > 0:
            # LOQO centrality rule: mu = sigma * avg_compl with sigma driven by
            # how uncentered the most-converged complementarity pair is
            prods = torch.cat(
                [
                    torch.where(zlm, wL * gL, torch.nan),
                    torch.where(zum, wU * gU, torch.nan),
                    torch.where(slm, yL * sgL, torch.nan),
                    torch.where(sum_, yU * sgU, torch.nan),
                ]
            )
            avg = torch.nansum(prods) / n_compl
            xi = torch.amin(torch.where(torch.isnan(prods), torch.inf, prods)) / torch.clamp(
                avg, min=1e-300
            )
            sigma_c = 0.1 * torch.clamp(0.05 * (1.0 - xi) / torch.clamp(xi, min=1e-12), max=2.0) ** 3
            # rate-limit the decrease (factor 100/iter)
            mu = _clip(sigma_c * avg, torch.clamp(1e-2 * mu, min=opts.mu_min), tensor(opts.mu_init))

        sigma_z = torch.where(zlm, wL / gL, 0.0) + torch.where(zum, wU / gU, 0.0)
        sigma_s = torch.where(slm, yL / sgL, 0.0) + torch.where(sum_, yU / sgU, 0.0)
        # inequality rows with no finite slack bound at all would make D singular
        sigma_s = torch.where(ineq, torch.clamp(sigma_s, min=1e-12), 1.0)

        kdata = kkt.prepare(z, lam, scale_f, scale_c)

        gf = grad_f(z)
        rbar_z = (
            gf
            + vjp_c(z, lam)
            - torch.where(zlm, mu / gL, 0.0)
            + torch.where(zum, mu / gU, 0.0)
        )
        rbar_s = torch.where(
            ineq,
            -lam - torch.where(slm, mu / sgL, 0.0) + torch.where(sum_, mu / sgU, 0.0),
            0.0,
        )
        r_p = primal_residual(z, s)
        rbar_p = r_p + torch.where(ineq, rbar_s / sigma_s, 0.0)
        Drow = torch.where(ineq, 1.0 / sigma_s, 0.0)

        # ---- regularized KKT solve with inertia-free curvature retry ----
        # delta_w is scaled by the Lagrangian Hessian's diagonal only
        h_scale = kkt.diag_scale(kdata)

        def reg_solve(delta_w, delta_c):
            dz, dlam = kkt.solve(kdata, sigma_z, Drow, delta_w, delta_c, rbar_z, rbar_p)
            ds = torch.where(ineq, (dlam - rbar_s) / sigma_s, 0.0)
            # inertia-free acceptance (Chiang-Zavala): curvature along the full
            # primal step (z AND slacks) must be sufficiently positive
            curv = (
                dz @ lag_hvp(z, lam, dz)
                + (sigma_z + delta_w) @ (dz * dz)
                + ds @ (sigma_s * ds)
            )
            nrm2 = dz @ dz + ds @ ds
            ok = (
                torch.isfinite(dz).all()
                & torch.isfinite(dlam).all()
                & (curv >= opts.curvature_frac * nrm2)
            )
            return dz, dlam, ds, bool(ok)

        # retry ladder (Ipopt inertia-correction analogue, Waechter-Biegler
        # Algorithm IC): trial 0 unregularized; then the decayed last-used
        # value (kappa_w^- = 1/3), escalating by 8 (100 on the very first
        # correction); the dual regularization delta_c = delta_c_bar mu^{1/4}
        # engages with it, proportional to the primal one
        delta_c_reg = torch.clamp(1e-8 * mu**0.25, min=opts.delta_c)
        never_used = bool(carry.delta_w_last == 0.0)
        delta_w, trials = tensor(0.0), 0
        dz, dlam, ds, solve_ok = zeros_nz, zeros_nc, zeros_nc, False
        while (not solve_ok) and trials <= opts.max_reg_trials:
            if trials == 0:
                new_dw = tensor(0.0)
                new_dc = tensor(opts.delta_c)
            else:
                if trials == 1:
                    if never_used:
                        new_dw = opts.delta_w_init * h_scale
                    else:
                        new_dw = torch.maximum(1e-20 * h_scale, carry.delta_w_last / 3.0)
                else:
                    new_dw = delta_w * (100.0 if never_used else 8.0)
                new_dc = torch.maximum(delta_c_reg, 1e-8 * new_dw)
            dz, dlam, ds, solve_ok = reg_solve(new_dw, new_dc)
            delta_w, trials = new_dw, trials + 1
        delta_w_used = delta_w
        delta_w_last = torch.where(delta_w_used > 0, delta_w_used, carry.delta_w_last)

        # ---- fraction-to-boundary (primal) ----
        tau = torch.clamp(1.0 - mu, min=opts.tau_min)
        a_z = _max_step_to_boundary(z, dz, zl, zu, zlm, zum, tau)
        a_s = _max_step_to_boundary(s, ds, sl, su, slm, sum_, tau)
        alpha_max = torch.minimum(a_z, a_s)

        # ---- filter line search (Waechter-Biegler / Ipopt) ----
        theta0 = torch.sum(torch.abs(r_p))
        f0, b0 = barrier_phi(z, s)
        phi0 = f0 - mu * b0
        # barrier-function directional derivative
        dphi = (
            gf @ dz
            - torch.sum(torch.where(zlm, mu / gL * dz, 0.0))
            + torch.sum(torch.where(zum, mu / gU * dz, 0.0))
            - torch.sum(torch.where(slm, mu / sgL * ds, 0.0))
            + torch.sum(torch.where(sum_, mu / sgU * ds, 0.0))
        )
        filt_th, filt_ph = carry.filt_theta, carry.filt_phi

        def eval_trial(zt, st):
            ft, bt = barrier_phi(zt, st)
            phi_t = ft - mu * bt
            theta_t = torch.sum(torch.abs(primal_residual(zt, st)))
            return theta_t, phi_t

        def trial_accept(alpha, theta_t, phi_t):
            """(accepted, is_ftype) per the filter method's case analysis."""
            not_blocked = ~torch.any((theta_t >= filt_th) & (phi_t >= filt_ph))
            switching = (dphi < 0) & (
                alpha * (-dphi) ** opts.s_phi > opts.delta_switch * theta0**opts.s_theta
            )
            armijo = phi_t <= phi0 + opts.eta_phi * alpha * dphi
            suff = (theta_t <= (1.0 - opts.gamma_theta) * theta0) | (
                phi_t <= phi0 - opts.gamma_phi * theta0
            )
            ok_f = switching & armijo
            ok = torch.where(theta0 <= theta_min, torch.where(switching, ok_f, suff), ok_f | suff)
            ok = ok & not_blocked & torch.isfinite(phi_t) & torch.isfinite(theta_t)
            ok, ok_f = torch.stack([ok, ok_f]).tolist()
            return ok, ok_f

        # first trial at alpha_max (+ second-order correction on rejection)
        th_1, ph_1 = eval_trial(z + alpha_max * dz, s + alpha_max * ds)
        ok_1, ftype_1 = trial_accept(alpha_max, th_1, ph_1)

        # SOC: if the full step was rejected and did not reduce infeasibility,
        # re-solve with rhs alpha*r_p + r_p(trial) (same KKT matrix)
        delta_c_used = (
            torch.maximum(delta_c_reg, 1e-8 * delta_w_used) if bool(delta_w_used > 0)
            else tensor(opts.delta_c)
        )
        soc_wanted = (not ok_1) and bool(th_1 >= theta0)
        soc_valid, ftype_soc = False, False
        if soc_wanted:
            rp_trial = primal_residual(z + alpha_max * dz, s + alpha_max * ds)
            rbar_p_soc = (alpha_max * r_p + rp_trial) + torch.where(ineq, rbar_s / sigma_s, 0.0)
            dz_c, dlam_c = kkt.solve(
                kdata, sigma_z, Drow, delta_w_used, delta_c_used, rbar_z, rbar_p_soc
            )
            ds_c = torch.where(ineq, (dlam_c - rbar_s) / sigma_s, 0.0)
            a_soc = torch.minimum(
                _max_step_to_boundary(z, dz_c, zl, zu, zlm, zum, tau),
                _max_step_to_boundary(s, ds_c, sl, su, slm, sum_, tau),
            )
            th_soc, ph_soc = eval_trial(z + a_soc * dz_c, s + a_soc * ds_c)
            ok_soc_raw, ftype_soc = trial_accept(a_soc, th_soc, ph_soc)
            soc_valid = (
                ok_soc_raw
                and bool(torch.isfinite(dz_c).all())
                and bool(th_soc <= opts.kappa_soc * theta0)
            )

        # backtracking from alpha_max/2 (only reached if both trials failed)
        alpha_bt, ls_it = alpha_max * 0.5, 0
        ok_bt, ftype_bt = ok_1 or soc_valid, False
        while (not ok_bt) and ls_it < opts.max_ls:
            th_t, ph_t = eval_trial(z + alpha_bt * dz, s + alpha_bt * ds)
            ok_bt, ftype_bt = trial_accept(alpha_bt, th_t, ph_t)
            if not ok_bt:
                alpha_bt = alpha_bt * 0.5
            ls_it += 1

        use_soc = soc_valid and not ok_1
        accepted = ok_1 or soc_valid or ok_bt
        if opts.debug:
            print(
                f"it={carry.it} mu={float(mu):.1e} amax={float(alpha_max):.2e} "
                f"th0={float(theta0):.3e} phi0={float(phi0):.6e} dphi={float(dphi):.3e} "
                f"ok1={ok_1} soc={soc_valid} okbt={ok_bt} abt={float(alpha_bt):.2e} "
                f"dw={float(delta_w_used):.1e}"
            )
        if ok_1:
            alpha, is_ftype = alpha_max, ftype_1
        elif use_soc:
            alpha, is_ftype = a_soc, ftype_soc
        else:
            alpha, is_ftype = alpha_bt, ftype_bt
        if not accepted:
            alpha = alpha_max * (0.5 ** opts.max_ls)
        if use_soc:
            dz_f, ds_f, dlam_f = dz_c, ds_c, dlam_c
        else:
            dz_f, ds_f, dlam_f = dz, ds, dlam

        # augment the filter on h-type (non-Armijo) accepted steps
        filt_th_n, filt_ph_n, filt_n_n = filt_th, filt_ph, carry.filt_n
        if accepted and not is_ftype:
            slot = carry.filt_n % opts.filter_size
            filt_th_n, filt_ph_n = filt_th.clone(), filt_ph.clone()
            filt_th_n[slot] = (1.0 - opts.gamma_theta) * theta0
            filt_ph_n[slot] = phi0 - opts.gamma_phi * theta0
            filt_n_n = carry.filt_n + 1

        # bound-multiplier steps along the selected direction, full dual FTB step
        dwL = torch.where(zlm, -(wL / gL) * dz_f - wL + mu / gL, 0.0)
        dwU = torch.where(zum, (wU / gU) * dz_f - wU + mu / gU, 0.0)
        dyL = torch.where(slm, -(yL / sgL) * ds_f - yL + mu / sgL, 0.0)
        dyU = torch.where(sum_, (yU / sgU) * ds_f - yU + mu / sgU, 0.0)
        a_wL = _dual_step_to_boundary(wL, dwL, zlm, tau)
        a_wU = _dual_step_to_boundary(wU, dwU, zum, tau)
        a_yL = _dual_step_to_boundary(yL, dyL, slm, tau)
        a_yU = _dual_step_to_boundary(yU, dyU, sum_, tau)
        alpha_dual = torch.minimum(torch.minimum(a_wL, a_wU), torch.minimum(a_yL, a_yU))

        z_n = z + alpha * dz_f
        s_n = s + alpha * ds_f
        lam_n = lam + alpha * dlam_f
        wL_n = torch.clamp(wL + alpha_dual * dwL, min=0.0)
        wU_n = torch.clamp(wU + alpha_dual * dwU, min=0.0)
        yL_n = torch.clamp(yL + alpha_dual * dyL, min=0.0)
        yU_n = torch.clamp(yU + alpha_dual * dyU, min=0.0)

        # ---- feasibility restoration (lite): when NO trial step is
        # acceptable, take a damped Gauss-Newton step on the constraint
        # violation with the slacks reset to the projection of c(z) onto their
        # box, reset the equality multipliers and restart the filter ----
        did_restore = not accepted
        resto_progress = False
        if did_restore:
            gn_data = kkt.gauss_newton_data(kdata)
            s_r = torch.where(ineq, push_interior(c(z), sl, su, slm, sum_), 0.0)
            r_r = primal_residual(z, s_r)
            dz_gn, _ = kkt.solve(
                gn_data,
                zeros_nz,
                torch.ones((nc,), dtype=dtype, device=device),
                tensor(1e-8),
                tensor(0.0),
                zeros_nz,
                r_r,
            )
            dz_gn = torch.where(torch.isfinite(dz_gn), dz_gn, 0.0)
            a_r = _max_step_to_boundary(z, dz_gn, zl, zu, zlm, zum, tau)
            cand = a_r * 0.5 ** torch.arange(8, dtype=dtype, device=device)
            ths = torch.stack(
                [torch.sum(torch.abs(primal_residual(z + a * dz_gn, s_r))) for a in cand]
            )
            kbest = torch.argmin(ths)
            z_n = z + cand[kbest] * dz_gn
            s_n = torch.where(ineq, push_interior(c(z_n), sl, su, slm, sum_), 0.0)
            lam_n = torch.zeros_like(lam)
            resto_progress = bool(ths[kbest] <= (1.0 - 1e-4) * theta0)
        if accepted and solve_ok:
            soft_fails = 0
        elif resto_progress:
            soft_fails = carry.soft_fails
        else:
            soft_fails = carry.soft_fails + 1

        # Ipopt's kappa_Sigma dual safeguard: keep bound duals consistent with mu
        def clamp_dual(wv, gap, mask_):
            lo = mu / (1e10 * gap)
            hi = 1e10 * mu / gap
            return torch.where(mask_, _clip(wv, lo, hi), 0.0)

        wL_n = clamp_dual(wL_n, _safe_gap(z_n, zl, zlm), zlm)
        wU_n = clamp_dual(wU_n, _safe_gap(zu, z_n, zum), zum)
        yL_n = clamp_dual(yL_n, _safe_gap(s_n, sl, slm), slm)
        yU_n = clamp_dual(yU_n, _safe_gap(su, s_n, sum_), sum_)

        # ---- dual refresh (Ipopt recalc_y; see IPMOptions.recalc_lam) ----
        if (
            opts.recalc_lam
            and nc > 0
            and accepted
            and bool(alpha <= opts.recalc_lam_alpha)
            and bool(theta0 <= opts.recalc_lam_feas_tol)
        ):
            g_n = grad_f(z_n) - wL_n + wU_n
            # damp inequality rows in the LSQ system and refresh ONLY the
            # equality multipliers
            lam_ls = kkt.lsq_lambda(z_n, g_n, scale_f, scale_c, Drow=ineq.to(dtype))
            lam_ls = torch.where(eq, lam_ls, lam_n)

            def e_d(lam_try):
                return torch.amax(torch.abs(g_n + vjp_c(z_n, lam_try)))

            # monotone safeguard: keep the refresh only if it strictly reduces
            # the dual residual at z_n
            ok = (
                torch.isfinite(lam_ls).all()
                & (torch.amax(torch.abs(lam_ls)) < 1e8)
                & (e_d(lam_ls) < 0.5 * e_d(lam_n))
            )
            if bool(ok):
                lam_n = lam_ls

        # ---- convergence & barrier update ----
        err_mu, err_0, _ = kkt_error_pair(z_n, s_n, lam_n, wL_n, wU_n, yL_n, yU_n, mu)

        # a non-finite TRIAL point is a failed iteration, not divergence:
        # revert to the previous iterate
        if not bool(torch.isfinite(err_0)):
            z_n, s_n, lam_n, wL_n, wU_n, yL_n, yU_n = z, s, lam, wL, wU, yL, yU
            err_0 = carry.kkt_err
            err_mu = tensor(torch.inf)  # no barrier decrease
            soft_fails = carry.soft_fails + 1

        if opts.mu_strategy == "adaptive" and n_compl > 0:
            # adaptive mode recomputes mu at the top of every iteration; the
            # filter is only restarted on restoration
            mu_next, mu_changed = mu, False
        else:
            mu_next = mu
            if bool(err_mu <= opts.kappa_eps * mu):
                mu_next = torch.clamp(
                    torch.minimum(opts.kappa_mu * mu, mu**opts.theta_mu), min=opts.mu_min
                )
            mu_next = torch.clamp(mu_next, min=opts.mu_min)
            mu_changed = bool(mu_next < mu)

        # the filter belongs to one barrier subproblem: reset it when mu drops
        # and after a restoration step
        if mu_changed or did_restore:
            filt_th_n, filt_ph_n = _fresh_filter()
            filt_n_n = 1

        converged = bool(err_0 <= opts.tol)
        diverged = (not bool(torch.isfinite(err_0))) or bool(torch.amax(torch.abs(z_n)) > 1e20)
        stalled = soft_fails >= opts.max_soft_fail
        status = 0 if converged else 3 if diverged else 2 if stalled else 1

        return _Carry(
            z=z_n,
            s=s_n,
            lam=lam_n,
            wL=wL_n,
            wU=wU_n,
            yL=yL_n,
            yU=yU_n,
            mu=mu_next,
            filt_theta=filt_th_n,
            filt_phi=filt_ph_n,
            filt_n=filt_n_n,
            delta_w_last=delta_w_last,
            it=carry.it + 1,
            done=converged or diverged or stalled,
            status=status,
            kkt_err=err_0,
            soft_fails=soft_fails,
        )

    # ---- outer iteration loop ----
    lam0 = zeros_nc
    if opts.lsq_lambda_init and nc > 0:
        # least-squares multiplier init: solve (J J^T + eps I) lam =
        # -J (grad f - wL + wU); reject if too large
        g_init = grad_f(z_init) - wL0 + wU0
        lam_ls = kkt.lsq_lambda(z_init, g_init, scale_f, scale_c)
        if bool(
            (torch.amax(torch.abs(lam_ls)) <= opts.lambda_init_max)
            & torch.isfinite(lam_ls).all()
        ):
            lam0 = lam_ls
    _, err_init, _ = kkt_error_pair(z_init, s_init, lam0, wL0, wU0, yL0, yU0, 0.0)
    init_done = bool(err_init <= opts.tol)
    th0, ph0 = _fresh_filter()

    carry = _Carry(
        z=z_init,
        s=s_init,
        lam=lam0,
        wL=wL0,
        wU=wU0,
        yL=yL0,
        yU=yU0,
        mu=mu0,
        filt_theta=th0,
        filt_phi=ph0,
        filt_n=1,
        delta_w_last=tensor(0.0),
        it=0,
        done=init_done,
        status=0 if init_done else 1,
        kkt_err=err_init,
        soft_fails=0,
    )

    history = None
    if opts.max_iter > 0 and return_history:
        history = tuple(
            torch.empty((opts.max_iter,), dtype=dt, device=device)
            for dt in (torch.long, dtype, dtype, torch.long, dtype, dtype)
        )

    def record(row, cr):
        # row `row` and every later one: those after the last iteration keep
        # its values
        for buf, value in zip(history, (cr.it, cr.mu, cr.kkt_err, cr.filt_n, cr.delta_w_last, f(cr.z))):
            buf[row:] = value

    if opts.max_iter > 0:
        if history is not None:
            record(0, carry)
        while (not carry.done) and carry.it < opts.max_iter:
            carry = step(carry)
            if history is not None:
                record(carry.it - 1, carry)
    final = carry

    viol_final = _amax(torch.abs(primal_residual(final.z, final.s) / scale_c), 0.0)
    status = final.status if final.done else 1
    # acceptable-level fallback: a stall or iteration cap with the error already
    # below acceptable_tol counts as success (Ipopt Solved_To_Acceptable_Level)
    if status not in (0, 3) and bool(final.kkt_err <= opts.acceptable_tol):
        status = 4
    if opts.max_iter == 0:
        # transcription round-trip mode: report the init as "solved"
        status = 0

    # honor_original_bounds: project the final point back inside the
    # UNRELAXED box
    z_out = torch.clamp(final.z, zl_orig, zu_orig)

    # unscale duals back to the user's problem: the scaled problem is
    # min s_f f s.t. s_c c, so lam_user = lam * s_c / s_f, bound duals / s_f
    result = IPMResult(
        z=z_out,
        lam=final.lam * scale_c / scale_f,
        zL=final.wL / scale_f,
        zU=final.wU / scale_f,
        s=final.s,
        yL=final.yL,
        yU=final.yU,
        objective=f_user(z_out),
        iterations=final.it,
        kkt_error=final.kkt_err,
        constraints_violation=viol_final,
        status=status,
        successful=status in (0, 4),
    )
    return (result, history) if return_history else result


# ----------------------------------------------------------------------------
# Batched solver: the counterpart of the JAX package's `jax.vmap(ipm_solve)`
# ----------------------------------------------------------------------------


@dataclass
class BatchStats:
    """Plain-int counters of batched solves (cumulative over calls)."""

    # batched KKT operator calls; each runs 1 + kkt_refine block solves under
    # an f32 solve with refinement (else one), one CR kernel launch per block
    # solve on the cr path (the operator's `block_solves` counts those)
    kkt_solves: int = 0
    host_syncs: int = 0  # device->host reads of a batch-wide loop condition
    iterations: int = 0  # trips of the batch's outer loop
    segments: dict = field(default_factory=dict)  # runs of each segment (`batched_ipm`)
    # a list to record every flag read in order ((flag name, value)): the
    # ranks of a time-sharded solve compare theirs to show lockstep
    flag_log: Optional[list] = None


class _Prob(NamedTuple):
    """Per-instance problem data (relaxed, scaled bounds and scale factors)."""

    zl: torch.Tensor
    zu: torch.Tensor
    zl_orig: torch.Tensor
    zu_orig: torch.Tensor
    sl: torch.Tensor  # slack bounds (scaled cl/cu on inequality rows, 0 elsewhere)
    su: torch.Tensor
    rhs_eq: torch.Tensor
    sf: torch.Tensor  # objective scale
    sc: torch.Tensor  # (nc,) constraint row scales
    theta_max: torch.Tensor
    theta_min: torch.Tensor


class _Step(NamedTuple):
    """Per-instance quantities of one iteration, shared by its stages."""

    mu: torch.Tensor
    gL: torch.Tensor
    gU: torch.Tensor
    sgL: torch.Tensor
    sgU: torch.Tensor
    sigma_z: torch.Tensor
    sigma_s: torch.Tensor
    Drow: torch.Tensor
    kdata: object
    gf: torch.Tensor
    rbar_z: torch.Tensor
    rbar_s: torch.Tensor
    r_p: torch.Tensor
    rbar_p: torch.Tensor
    h_scale: torch.Tensor
    delta_c_reg: torch.Tensor


class _LineSearch(NamedTuple):
    tau: torch.Tensor
    alpha_max: torch.Tensor
    theta0: torch.Tensor
    phi0: torch.Tensor
    dphi: torch.Tensor


def _sel(mask, new, old):
    """Per-instance select along the leading batch axis (a `lax.cond` or a
    while-loop carry under `jax.vmap`): instances outside `mask` keep `old`
    bit for bit."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


# the segments of one batched IPM iteration, in the order the host loop first
# runs them (`batched_ipm`)
SEGMENTS = ("prologue", "reg_trial", "ls_setup", "soc", "bt_trial", "select", "restore", "clamp", "refresh",
            "close")


class BatchedIPM(NamedTuple):
    """The batched IPM as a host loop over pure segment functions
    (`batched_ipm` builds it; `ipm_solve_batched` runs it eagerly)."""

    # (z0, zl, zu, cl, cu, stats) -> the state at the first iteration: a dict
    # of tensors and NamedTuples / dicts of tensors, (B, ...) each
    setup: Callable
    # SEGMENTS name -> segment(state) -> the state entries it renews
    segments: dict
    # (state, run, stats): the loops of the solve; run(name) brings `state`
    # up to date with segment `name`, each decision is one read of a flag
    drive: Callable
    # state -> IPMResult
    epilogue: Callable

    def eager(self, z0, zl, zu, cl, cu, stats: BatchStats) -> IPMResult:
        """The solve with every segment run op by op, on any device."""
        state = self.setup(z0, zl, zu, cl, cu, stats)
        self.drive(state, lambda name: state.update(self.segments[name](state)), stats)
        return self.epilogue(state)


def batched_ipm(
    f: Callable,
    c: Callable,
    spec: NLPSpec,
    options: IPMOptions = IPMOptions(),
    kkt=None,
    *,
    device,
    dtype: torch.dtype = torch.float64,
) -> BatchedIPM:
    """The batched IPM (`ipm_solve_batched`) split at its host reads.

    A solve is `setup`, then `drive`, then `epilogue`. One IPM iteration is
    ten segments, each a pure function of the solver's state that returns
    the entries it renews; a segment that ends in a decision returns it as
    a 0-dim bool flag computed on the device, and the host loop reads that flag
    back (one host sync, counted in `stats.host_syncs`):
      prologue   the iteration's per-instance quantities and the ladder's
                 first values;
      reg_trial  one trial of the regularization ladder (a KKT solve), flag
                 `reg_more`, run again while it is set;
      ls_setup   the line search's set-up and first trial, flag `soc`;
      soc        the second-order correction (a KKT solve), then flag
                 `bt_more` (ls_setup's when it does not run);
      bt_trial   one backtracking trial, flag `bt_more`, run again while set;
      select     the step's selection, the filter and the advance, flag
                 `restore`;
      restore    feasibility restoration (a KKT solve);
      clamp      the soft-fail count, the dual clamp and flag `refresh`;
      refresh    the dual refresh (a KKT solve);
      close      the KKT error, revert, mu, filter reset, status and carry
                 select, flag `more` (another iteration).
    The set-up's flag `more` opens the outer loop. The state is all that
    passes between segments, so the same loop runs them eagerly
    (`ipm_solve_batched`) or as replayed CUDA graphs whose outputs are
    copied into persistent tensors (solver/graph.py::BatchGraph), and
    both make the same KKT solves and land on the same iterates bit for
    bit. The segments read no host data and no device value back, so each
    can be captured. Everything but the batch size B is fixed here."""
    opts = options
    nz, nc = spec.nz, spec.nc

    def tensor(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    def mask(x):
        return torch.as_tensor(x, dtype=torch.bool, device=device)

    eq = mask(spec.eq_mask)
    ineq = ~eq
    zlm = mask(spec.zl_mask)
    zum = mask(spec.zu_mask)
    slm = mask(spec.sl_mask)
    sum_ = mask(spec.su_mask)
    n_duals = float(nc + nz)
    n_compl = int(
        np.sum(spec.zl_mask) + np.sum(spec.zu_mask) + np.sum(spec.sl_mask) + np.sum(spec.su_mask)
    )
    adaptive = opts.mu_strategy == "adaptive" and n_compl > 0
    if kkt is None:
        kkt = DenseKKT(f, c, nz, nc)
    kap = opts.kappa_push
    # constants the segments use, made once here: a tensor made from host
    # data inside a segment is a copy from the host per call, which a CUDA
    # graph would refuse or fix at its capture-time value
    mu_init = tensor(opts.mu_init)
    gn_delta_w, gn_delta_c = tensor(1e-8), tensor(0.0)

    # ---- per-instance functions (each vmapped over the batch below) ----
    def f_s(pb, z):
        return pb.sf * f(z)

    def c_s(pb, z):
        return pb.sc * c(z)

    def grad_f(pb, z):
        return grad(lambda zz: f_s(pb, zz))(z)

    def vjp_c(pb, z, lam):
        return vjp(lambda zz: c_s(pb, zz), z)[1](lam)[0]

    def lag_hvp(pb, z, lam, v):
        g = grad(lambda z3: f_s(pb, z3) + torch.dot(lam, c_s(pb, z3)))
        return jvp(g, (z,), (v,))[1]

    def primal_residual(pb, z, s):
        return c_s(pb, z) - pb.rhs_eq - torch.where(ineq, s, 0.0)

    def push_interior(x, lb, ub, lmask, umask):
        lo = torch.where(lmask, lb, -torch.inf)
        hi = torch.where(umask, ub, torch.inf)
        width = torch.where(lmask & umask, hi - lo, torch.inf)
        pL = torch.where(
            lmask, torch.minimum(kap * torch.clamp(torch.abs(lo), min=1.0), 0.5 * width), 0.0
        )
        pU = torch.where(
            umask, torch.minimum(kap * torch.clamp(torch.abs(hi), min=1.0), 0.5 * width), 0.0
        )
        x = torch.where(lmask, torch.maximum(x, lo + pL), x)
        return torch.where(umask, torch.minimum(x, hi - pU), x)

    def kkt_error_pair(pb, z, s, lam, wL, wU, yL, yU, mu):
        gL = _safe_gap(z, pb.zl, zlm)
        gU = _safe_gap(pb.zu, z, zum)
        sgL = _safe_gap(s, pb.sl, slm)
        sgU = _safe_gap(pb.su, s, sum_)
        r_d = grad_f(pb, z) + vjp_c(pb, z, lam) - wL + wU
        r_s = torch.where(ineq, -lam - yL + yU, 0.0)
        r_p = primal_residual(pb, z, s)
        prods = torch.cat(
            [
                torch.where(zlm, wL * gL, 0.0),
                torch.where(zum, wU * gU, 0.0),
                torch.where(slm, yL * sgL, 0.0),
                torch.where(sum_, yU * sgU, 0.0),
            ]
        )
        masks = torch.cat([zlm, zum, slm, sum_])
        bound_dual_sum = torch.sum(wL + wU) + torch.sum(yL + yU)
        dual_sum = torch.sum(torch.abs(lam)) + bound_dual_sum
        s_d = torch.clamp(dual_sum / n_duals, min=opts.s_max) / opts.s_max
        s_c = (
            torch.clamp(bound_dual_sum / max(1.0, float(nz + nc)), min=opts.s_max)
            / opts.s_max
        )
        e_d = torch.amax(torch.abs(torch.cat([r_d, r_s]))) / s_d
        e_p = _amax(torch.abs(r_p), 0.0)
        e_c0 = _amax(torch.abs(prods), 0.0) / s_c
        e_cmu = _amax(torch.abs(torch.where(masks, prods - mu, 0.0)), 0.0) / s_c
        base = torch.maximum(e_d, e_p)
        return torch.maximum(base, e_cmu), torch.maximum(base, e_c0)

    def barrier_phi(pb, z, s):
        barr = (
            torch.sum(torch.where(zlm, torch.log(_safe_gap(z, pb.zl, zlm)), 0.0))
            + torch.sum(torch.where(zum, torch.log(_safe_gap(pb.zu, z, zum)), 0.0))
            + torch.sum(torch.where(slm, torch.log(_safe_gap(s, pb.sl, slm)), 0.0))
            + torch.sum(torch.where(sum_, torch.log(_safe_gap(pb.su, s, sum_)), 0.0))
        )
        return f_s(pb, z), barr

    def fresh_filter(pb):
        th = torch.full((opts.filter_size,), torch.inf, dtype=dtype, device=device)
        th = torch.where(torch.arange(opts.filter_size, device=device) == 0, pb.theta_max, th)
        ph = torch.full((opts.filter_size,), -torch.inf, dtype=dtype, device=device)
        return th, ph

    def setup(z0, zl, zu, cl, cu):
        """Bound relaxation, gradient scaling and the interior initial point."""
        zl_orig, zu_orig = zl, zu
        if opts.bound_relax_factor > 0:
            brf = opts.bound_relax_factor

            def _relax(lo, hi, row_eq=None):
                rl = lo - brf * torch.clamp(torch.abs(lo), min=1.0)
                rh = hi + brf * torch.clamp(torch.abs(hi), min=1.0)
                if row_eq is not None:
                    rl = torch.where(row_eq, lo, rl)
                    rh = torch.where(row_eq, hi, rh)
                return rl, rh

            zl, zu = _relax(zl, zu)
            cl, cu = _relax(cl, cu, eq)
        if opts.grad_scaling:
            g0 = grad(f)(z0)
            sf = torch.clamp(
                opts.scaling_max_grad / torch.clamp(torch.amax(torch.abs(g0)), min=1e-8), max=1.0
            )
            sc = torch.clamp(
                opts.scaling_max_grad / torch.clamp(kkt.row_norms(z0), min=1e-8), max=1.0
            )
            cl, cu = sc * cl, sc * cu
        else:
            sf = torch.ones((), dtype=dtype, device=device)
            sc = torch.ones((nc,), dtype=dtype, device=device)
        sl = torch.where(ineq, cl, 0.0)
        su = torch.where(ineq, cu, 0.0)
        # the filter bounds depend on the initial point: placeholders until then
        pb = _Prob(zl, zu, zl_orig, zu_orig, sl, su, torch.where(eq, cl, 0.0), sf, sc,
                   theta_max=sf, theta_min=sf)
        z_init = push_interior(z0, zl, zu, zlm, zum)
        s_init = torch.where(ineq, push_interior(c_s(pb, z_init), sl, su, slm, sum_), 0.0)
        theta_at_init = torch.sum(torch.abs(primal_residual(pb, z_init, s_init)))
        pb = pb._replace(
            theta_max=1e4 * torch.clamp(theta_at_init, min=1.0),
            theta_min=1e-4 * torch.clamp(theta_at_init, min=1.0),
        )
        mu0 = tensor(opts.mu_init)
        wL0 = torch.where(zlm, mu0 / _safe_gap(z_init, zl, zlm), 0.0)
        wU0 = torch.where(zum, mu0 / _safe_gap(zu, z_init, zum), 0.0)
        yL0 = torch.where(slm, mu0 / _safe_gap(s_init, sl, slm), 0.0)
        yU0 = torch.where(sum_, mu0 / _safe_gap(su, s_init, sum_), 0.0)
        g_init = grad_f(pb, z_init) - wL0 + wU0
        return pb, z_init, s_init, wL0, wU0, yL0, yU0, g_init

    def init_carry(pb, z, s, lam_ls, wL, wU, yL, yU):
        lam0 = torch.zeros((nc,), dtype=dtype, device=device)
        if lam_ls is not None:
            ok = (torch.amax(torch.abs(lam_ls)) <= opts.lambda_init_max) & torch.isfinite(
                lam_ls
            ).all()
            lam0 = torch.where(ok, lam_ls, lam0)
        _, err = kkt_error_pair(pb, z, s, lam0, wL, wU, yL, yU, 0.0)
        th, ph = fresh_filter(pb)
        zero_i = torch.zeros((), dtype=torch.long, device=device)
        done = err <= opts.tol
        return _Carry(
            z=z, s=s, lam=lam0, wL=wL, wU=wU, yL=yL, yU=yU, mu=tensor(opts.mu_init),
            filt_theta=th, filt_phi=ph, filt_n=zero_i + 1, delta_w_last=tensor(0.0),
            it=zero_i, done=done, status=torch.where(done, 0, 1), kkt_err=err,
            soft_fails=zero_i,
        )

    def prologue(pb, cr):
        z, s, lam, wL, wU, yL, yU = cr[:7]
        mu = cr.mu
        gL = _safe_gap(z, pb.zl, zlm)
        gU = _safe_gap(pb.zu, z, zum)
        sgL = _safe_gap(s, pb.sl, slm)
        sgU = _safe_gap(pb.su, s, sum_)
        if adaptive:
            prods = torch.cat(
                [
                    torch.where(zlm, wL * gL, torch.nan),
                    torch.where(zum, wU * gU, torch.nan),
                    torch.where(slm, yL * sgL, torch.nan),
                    torch.where(sum_, yU * sgU, torch.nan),
                ]
            )
            avg = torch.nansum(prods) / n_compl
            xi = torch.amin(torch.where(torch.isnan(prods), torch.inf, prods)) / torch.clamp(
                avg, min=1e-300
            )
            sigma_c = 0.1 * torch.clamp(0.05 * (1.0 - xi) / torch.clamp(xi, min=1e-12), max=2.0) ** 3
            mu = _clip(sigma_c * avg, torch.clamp(1e-2 * mu, min=opts.mu_min), mu_init)
        sigma_z = torch.where(zlm, wL / gL, 0.0) + torch.where(zum, wU / gU, 0.0)
        sigma_s = torch.where(slm, yL / sgL, 0.0) + torch.where(sum_, yU / sgU, 0.0)
        sigma_s = torch.where(ineq, torch.clamp(sigma_s, min=1e-12), 1.0)
        kdata = kkt.prepare(z, lam, pb.sf, pb.sc)
        gf = grad_f(pb, z)
        rbar_z = (
            gf
            + vjp_c(pb, z, lam)
            - torch.where(zlm, mu / gL, 0.0)
            + torch.where(zum, mu / gU, 0.0)
        )
        rbar_s = torch.where(
            ineq,
            -lam - torch.where(slm, mu / sgL, 0.0) + torch.where(sum_, mu / sgU, 0.0),
            0.0,
        )
        r_p = primal_residual(pb, z, s)
        return _Step(
            mu=mu, gL=gL, gU=gU, sgL=sgL, sgU=sgU, sigma_z=sigma_z, sigma_s=sigma_s,
            Drow=torch.where(ineq, 1.0 / sigma_s, 0.0), kdata=kdata, gf=gf, rbar_z=rbar_z,
            rbar_s=rbar_s, r_p=r_p, rbar_p=r_p + torch.where(ineq, rbar_s / sigma_s, 0.0),
            h_scale=kkt.diag_scale(kdata),
            delta_c_reg=torch.clamp(1e-8 * mu**0.25, min=opts.delta_c),
        )

    def reg_solve(pb, cr, sp, delta_w, delta_c):
        dz, dlam = kkt.solve(sp.kdata, sp.sigma_z, sp.Drow, delta_w, delta_c, sp.rbar_z, sp.rbar_p)
        ds = torch.where(ineq, (dlam - sp.rbar_s) / sp.sigma_s, 0.0)
        curv = (
            dz @ lag_hvp(pb, cr.z, cr.lam, dz)
            + (sp.sigma_z + delta_w) @ (dz * dz)
            + ds @ (sp.sigma_s * ds)
        )
        nrm2 = dz @ dz + ds @ ds
        ok = (
            torch.isfinite(dz).all()
            & torch.isfinite(dlam).all()
            & (curv >= opts.curvature_frac * nrm2)
        )
        return dz, dlam, ds, ok

    def line_search_setup(pb, cr, sp, dz, ds):
        mu = sp.mu
        tau = torch.clamp(1.0 - mu, min=opts.tau_min)
        alpha_max = torch.minimum(
            _max_step_to_boundary(cr.z, dz, pb.zl, pb.zu, zlm, zum, tau),
            _max_step_to_boundary(cr.s, ds, pb.sl, pb.su, slm, sum_, tau),
        )
        f0, b0 = barrier_phi(pb, cr.z, cr.s)
        dphi = (
            sp.gf @ dz
            - torch.sum(torch.where(zlm, mu / sp.gL * dz, 0.0))
            + torch.sum(torch.where(zum, mu / sp.gU * dz, 0.0))
            - torch.sum(torch.where(slm, mu / sp.sgL * ds, 0.0))
            + torch.sum(torch.where(sum_, mu / sp.sgU * ds, 0.0))
        )
        return _LineSearch(tau, alpha_max, torch.sum(torch.abs(sp.r_p)), f0 - mu * b0, dphi)

    def trial(pb, cr, sp, ls, alpha, dz, ds):
        """(accepted, is_ftype, theta) of the trial point at step alpha."""
        zt, st = cr.z + alpha * dz, cr.s + alpha * ds
        ft, bt = barrier_phi(pb, zt, st)
        phi_t = ft - sp.mu * bt
        theta_t = torch.sum(torch.abs(primal_residual(pb, zt, st)))
        theta0, phi0, dphi = ls.theta0, ls.phi0, ls.dphi
        not_blocked = ~torch.any((theta_t >= cr.filt_theta) & (phi_t >= cr.filt_phi))
        switching = (dphi < 0) & (
            alpha * (-dphi) ** opts.s_phi > opts.delta_switch * theta0**opts.s_theta
        )
        armijo = phi_t <= phi0 + opts.eta_phi * alpha * dphi
        suff = (theta_t <= (1.0 - opts.gamma_theta) * theta0) | (
            phi_t <= phi0 - opts.gamma_phi * theta0
        )
        ok_f = switching & armijo
        ok = torch.where(theta0 <= pb.theta_min, torch.where(switching, ok_f, suff), ok_f | suff)
        ok = ok & not_blocked & torch.isfinite(phi_t) & torch.isfinite(theta_t)
        return ok, ok_f, theta_t

    def soc(pb, cr, sp, ls, dz, ds, delta_w, delta_c):
        """Second-order correction: re-solve with rhs alpha*r_p + r_p(trial)."""
        a = ls.alpha_max
        rp_trial = primal_residual(pb, cr.z + a * dz, cr.s + a * ds)
        rbar_p_soc = (a * sp.r_p + rp_trial) + torch.where(ineq, sp.rbar_s / sp.sigma_s, 0.0)
        dz_c, dlam_c = kkt.solve(
            sp.kdata, sp.sigma_z, sp.Drow, delta_w, delta_c, sp.rbar_z, rbar_p_soc
        )
        ds_c = torch.where(ineq, (dlam_c - sp.rbar_s) / sp.sigma_s, 0.0)
        a_soc = torch.minimum(
            _max_step_to_boundary(cr.z, dz_c, pb.zl, pb.zu, zlm, zum, ls.tau),
            _max_step_to_boundary(cr.s, ds_c, pb.sl, pb.su, slm, sum_, ls.tau),
        )
        ok_raw, ftype, th_soc = trial(pb, cr, sp, ls, a_soc, dz_c, ds_c)
        valid = ok_raw & torch.isfinite(dz_c).all() & (th_soc <= opts.kappa_soc * ls.theta0)
        return dz_c, dlam_c, ds_c, a_soc, valid, ftype

    def advance(cr, sp, ls, alpha, dz, ds, dlam):
        """Primal step along the selected direction, full dual FTB step."""
        z, s, lam, wL, wU, yL, yU = cr[:7]
        mu, tau = sp.mu, ls.tau
        dwL = torch.where(zlm, -(wL / sp.gL) * dz - wL + mu / sp.gL, 0.0)
        dwU = torch.where(zum, (wU / sp.gU) * dz - wU + mu / sp.gU, 0.0)
        dyL = torch.where(slm, -(yL / sp.sgL) * ds - yL + mu / sp.sgL, 0.0)
        dyU = torch.where(sum_, (yU / sp.sgU) * ds - yU + mu / sp.sgU, 0.0)
        alpha_dual = torch.minimum(
            torch.minimum(
                _dual_step_to_boundary(wL, dwL, zlm, tau), _dual_step_to_boundary(wU, dwU, zum, tau)
            ),
            torch.minimum(
                _dual_step_to_boundary(yL, dyL, slm, tau), _dual_step_to_boundary(yU, dyU, sum_, tau)
            ),
        )
        return (
            z + alpha * dz,
            s + alpha * ds,
            lam + alpha * dlam,
            torch.clamp(wL + alpha_dual * dwL, min=0.0),
            torch.clamp(wU + alpha_dual * dwU, min=0.0),
            torch.clamp(yL + alpha_dual * dyL, min=0.0),
            torch.clamp(yU + alpha_dual * dyU, min=0.0),
        )

    def restore(pb, cr, sp, ls):
        """Feasibility restoration (lite): damped Gauss-Newton step on the
        constraint violation, slacks reset to the projection of c(z)."""
        z = cr.z
        s_r = torch.where(ineq, push_interior(c_s(pb, z), pb.sl, pb.su, slm, sum_), 0.0)
        r_r = primal_residual(pb, z, s_r)
        dz_gn, _ = kkt.solve(
            kkt.gauss_newton_data(sp.kdata),
            torch.zeros((nz,), dtype=dtype, device=device),
            torch.ones((nc,), dtype=dtype, device=device),
            gn_delta_w,
            gn_delta_c,
            torch.zeros((nz,), dtype=dtype, device=device),
            r_r,
        )
        dz_gn = torch.where(torch.isfinite(dz_gn), dz_gn, 0.0)
        a_r = _max_step_to_boundary(z, dz_gn, pb.zl, pb.zu, zlm, zum, ls.tau)
        cand = a_r * 0.5 ** torch.arange(8, dtype=dtype, device=device)
        ths = torch.stack(
            [torch.sum(torch.abs(primal_residual(pb, z + cand[k] * dz_gn, s_r))) for k in range(8)]
        )
        best = torch.arange(8, device=device) == torch.argmin(ths)
        z_r = z + torch.sum(torch.where(best, cand, 0.0)) * dz_gn
        s_rr = torch.where(ineq, push_interior(c_s(pb, z_r), pb.sl, pb.su, slm, sum_), 0.0)
        progressed = torch.sum(torch.where(best, ths, 0.0)) <= (1.0 - 1e-4) * ls.theta0
        return z_r, s_rr, torch.zeros_like(cr.lam), progressed

    def clamp_duals(pb, mu, z, s, wL, wU, yL, yU):
        """Ipopt's kappa_Sigma safeguard: bound duals consistent with mu."""

        def one(wv, gap, mask_):
            return torch.where(mask_, _clip(wv, mu / (1e10 * gap), 1e10 * mu / gap), 0.0)

        return (
            one(wL, _safe_gap(z, pb.zl, zlm), zlm),
            one(wU, _safe_gap(pb.zu, z, zum), zum),
            one(yL, _safe_gap(s, pb.sl, slm), slm),
            one(yU, _safe_gap(pb.su, s, sum_), sum_),
        )

    def refresh(pb, z, lam, wL, wU):
        """Dual refresh (Ipopt recalc_y) of the equality multipliers, kept only
        if it halves the dual residual."""
        g_n = grad_f(pb, z) - wL + wU
        lam_ls = kkt.lsq_lambda(z, g_n, pb.sf, pb.sc, Drow=ineq.to(dtype))
        lam_ls = torch.where(eq, lam_ls, lam)

        def e_d(lam_try):
            return torch.amax(torch.abs(g_n + vjp_c(pb, z, lam_try)))

        ok = (
            torch.isfinite(lam_ls).all()
            & (torch.amax(torch.abs(lam_ls)) < 1e8)
            & (e_d(lam_ls) < 0.5 * e_d(lam))
        )
        return torch.where(ok, lam_ls, lam)

    def exit_violation(pb, z, s):
        return _amax(torch.abs(primal_residual(pb, z, s) / pb.sc), 0.0)

    v_setup, v_prologue = vmap(setup), vmap(prologue)
    v_reg_solve, v_ls_setup, v_trial = vmap(reg_solve), vmap(line_search_setup), vmap(trial)
    v_soc, v_advance, v_restore = vmap(soc), vmap(advance), vmap(restore)
    v_clamp, v_refresh, v_kkt_error = vmap(clamp_duals), vmap(refresh), vmap(kkt_error_pair)
    v_fresh_filter = vmap(fresh_filter)

    # ---- the solve's set-up: bound relaxation, scaling, initial point,
    # multiplier init; flag `more` opens the outer loop ----
    def start(z0, zl, zu, cl, cu, stats: BatchStats) -> dict:
        # every entry materialised (vmap broadcasts the ones made from
        # constants, the caller may pass expanded bounds): a copy of the state
        # into persistent tensors then keeps every layout, and so every result
        Z0, ZL, ZU, CL, CU = (tensor(x).contiguous() for x in (z0, zl, zu, cl, cu))
        PB, z_init, s_init, wL0, wU0, yL0, yU0, g_init = v_setup(Z0, ZL, ZU, CL, CU)
        PB = _Prob(*(x.contiguous() for x in PB))
        lam_ls = None
        if opts.lsq_lambda_init and nc > 0:
            stats.kkt_solves += 1
            lam_ls = vmap(kkt.lsq_lambda)(z_init, g_init, PB.sf, PB.sc)
        carry = vmap(init_carry, in_dims=(0, 0, 0, None if lam_ls is None else 0, 0, 0, 0, 0))(
            PB, z_init, s_init, lam_ls, wL0, wU0, yL0, yU0
        )
        carry = _Carry(*(x.contiguous() for x in carry))
        active = ~carry.done & (carry.it < opts.max_iter)
        return dict(pb=PB, cr=carry, active=active, more=active.any())

    # ---- the segments of one iteration; `active` marks the instances
    # whose result is kept ----
    def seg_prologue(S):
        cr = S["cr"]
        sp = v_prologue(S["pb"], cr)
        B = cr.z.shape[0]
        false_b = torch.zeros((B,), dtype=torch.bool, device=device)
        # regularization ladder: trial 0 unregularized, then the decayed last
        # value (or delta_w_init on the first-ever correction), escalating by 8
        # (100 on the first-ever correction)
        never_used = cr.delta_w_last == 0.0
        first = torch.where(
            never_used,
            opts.delta_w_init * sp.h_scale,
            torch.maximum(1e-20 * sp.h_scale, cr.delta_w_last / 3.0),
        )
        dlam = torch.zeros((B, nc), dtype=dtype, device=device)
        return dict(
            sp=sp, first=first, grow=torch.where(never_used, 100.0, 8.0),
            delta_w=torch.zeros((B,), dtype=dtype, device=device),
            trials=torch.zeros((B,), dtype=torch.long, device=device),
            dz=torch.zeros((B, nz), dtype=dtype, device=device), dlam=dlam, ds=torch.zeros_like(dlam),
            solve_ok=false_b, reg_run=S["active"],
        )

    def seg_reg_trial(S):
        trials, delta_w, run, sp = S["trials"], S["delta_w"], S["reg_run"], S["sp"]
        new_dw = torch.where(trials == 0, 0.0, torch.where(trials == 1, S["first"], delta_w * S["grow"]))
        new_dc = torch.where(
            trials == 0, opts.delta_c, torch.maximum(sp.delta_c_reg, 1e-8 * new_dw)
        )
        dz_t, dlam_t, ds_t, ok_t = v_reg_solve(S["pb"], S["cr"], sp, new_dw, new_dc)
        solve_ok = torch.where(run, ok_t, S["solve_ok"])
        trials = torch.where(run, trials + 1, trials)
        more = run & ~solve_ok & (trials <= opts.max_reg_trials)
        return dict(
            dz=_sel(run, dz_t, S["dz"]), dlam=_sel(run, dlam_t, S["dlam"]), ds=_sel(run, ds_t, S["ds"]),
            solve_ok=solve_ok, delta_w=torch.where(run, new_dw, delta_w), trials=trials, reg_run=more,
            reg_more=more.any(),
        )

    def backtracking(S, ok_1, soc_valid):
        """The backtracking loop's entry state and its first flag."""
        ok_bt = ok_1 | soc_valid
        run = S["active"] & ~ok_bt & (opts.max_ls > 0)
        return dict(ok_bt=ok_bt, bt_run=run, bt_more=run.any())

    # filter line search: first trial at alpha_max, SOC on rejection, then
    # backtracking from alpha_max / 2
    def seg_ls_setup(S):
        pb, cr, sp, dz, ds, delta_w = S["pb"], S["cr"], S["sp"], S["dz"], S["ds"], S["delta_w"]
        ls = v_ls_setup(pb, cr, sp, dz, ds)
        ok_1, ftype_1, th_1 = v_trial(pb, cr, sp, ls, ls.alpha_max, dz, ds)
        soc_wanted = ~ok_1 & (th_1 >= ls.theta0)
        zeros_b, false_b = torch.zeros_like(delta_w), torch.zeros_like(ok_1)
        return dict(
            delta_w_last=torch.where(delta_w > 0, delta_w, cr.delta_w_last), ls=ls, ok_1=ok_1,
            ftype_1=ftype_1, soc_wanted=soc_wanted,
            delta_c_used=torch.where(
                delta_w > 0, torch.maximum(sp.delta_c_reg, 1e-8 * delta_w), opts.delta_c
            ),
            dz_c=torch.zeros_like(dz), dlam_c=torch.zeros_like(S["dlam"]), ds_c=torch.zeros_like(ds),
            a_soc=zeros_b, soc_valid=false_b, ftype_soc=false_b,
            alpha_bt=ls.alpha_max * 0.5, ls_it=torch.zeros_like(S["trials"]), ftype_bt=false_b,
            soc=(S["active"] & soc_wanted).any(), **backtracking(S, ok_1, false_b),
        )

    def seg_soc(S):
        dz_c, dlam_c, ds_c, a_soc, valid, ftype_soc = v_soc(
            S["pb"], S["cr"], S["sp"], S["ls"], S["dz"], S["ds"], S["delta_w"], S["delta_c_used"]
        )
        soc_valid = S["soc_wanted"] & valid
        return dict(dz_c=dz_c, dlam_c=dlam_c, ds_c=ds_c, a_soc=a_soc, soc_valid=soc_valid, ftype_soc=ftype_soc,
                    **backtracking(S, S["ok_1"], soc_valid))

    def seg_bt_trial(S):
        run, alpha_bt, ls_it = S["bt_run"], S["alpha_bt"], S["ls_it"]
        ok_t, ftype_t, _ = v_trial(S["pb"], S["cr"], S["sp"], S["ls"], alpha_bt, S["dz"], S["ds"])
        ok_bt = torch.where(run, ok_t, S["ok_bt"])
        ls_it = torch.where(run, ls_it + 1, ls_it)
        more = run & ~ok_bt & (ls_it < opts.max_ls)
        return dict(
            alpha_bt=torch.where(run & ~ok_t, alpha_bt * 0.5, alpha_bt), ok_bt=ok_bt,
            ftype_bt=torch.where(run, ftype_t, S["ftype_bt"]), ls_it=ls_it, bt_run=more, bt_more=more.any(),
        )

    def seg_select(S):
        cr, sp, ls, ok_1, soc_valid = S["cr"], S["sp"], S["ls"], S["ok_1"], S["soc_valid"]
        use_soc = soc_valid & ~ok_1
        accepted = ok_1 | soc_valid | S["ok_bt"]
        alpha = torch.where(ok_1, ls.alpha_max, torch.where(use_soc, S["a_soc"], S["alpha_bt"]))
        alpha = torch.where(accepted, alpha, ls.alpha_max * (0.5**opts.max_ls))
        is_ftype = torch.where(ok_1, S["ftype_1"], torch.where(use_soc, S["ftype_soc"], S["ftype_bt"]))
        dz_f, ds_f = _sel(use_soc, S["dz_c"], S["dz"]), _sel(use_soc, S["ds_c"], S["ds"])
        dlam_f = _sel(use_soc, S["dlam_c"], S["dlam"])

        # augment the filter on h-type accepted steps
        add = (accepted & ~is_ftype)[:, None] & (
            torch.arange(opts.filter_size, device=device)[None, :]
            == (cr.filt_n % opts.filter_size)[:, None]
        )
        new = v_advance(cr, sp, ls, alpha, dz_f, ds_f, dlam_f)
        return dict(
            accepted=accepted, alpha=alpha,
            filt_th=torch.where(add, ((1.0 - opts.gamma_theta) * ls.theta0)[:, None], cr.filt_theta),
            filt_ph=torch.where(add, (ls.phi0 - opts.gamma_phi * ls.theta0)[:, None], cr.filt_phi),
            filt_n=torch.where(accepted & ~is_ftype, cr.filt_n + 1, cr.filt_n),
            new=new, resto_progress=torch.zeros_like(accepted), restore=(S["active"] & ~accepted).any(),
        )

    def seg_restore(S):
        did_restore = ~S["accepted"]
        z_r, s_r, lam_r, progressed = v_restore(S["pb"], S["cr"], S["sp"], S["ls"])
        z_n, s_n, lam_n, *duals = S["new"]
        new = (_sel(did_restore, z_r, z_n), _sel(did_restore, s_r, s_n), _sel(did_restore, lam_r, lam_n), *duals)
        return dict(new=new, resto_progress=did_restore & progressed)

    def seg_clamp(S):
        cr, sp, accepted = S["cr"], S["sp"], S["accepted"]
        soft_fails = torch.where(
            accepted & S["solve_ok"],
            0,
            torch.where(S["resto_progress"], cr.soft_fails, cr.soft_fails + 1),
        )
        z_n, s_n, lam_n, wL_n, wU_n, yL_n, yU_n = S["new"]
        duals = v_clamp(S["pb"], sp.mu, z_n, s_n, wL_n, wU_n, yL_n, yU_n)
        out = dict(soft_fails=soft_fails, new=(z_n, s_n, lam_n, *duals))
        if opts.recalc_lam and nc > 0:
            want = (
                accepted & (S["alpha"] <= opts.recalc_lam_alpha) & (S["ls"].theta0 <= opts.recalc_lam_feas_tol)
            )
            out.update(want=want, refresh=(S["active"] & want).any())
        return out

    def seg_refresh(S):
        z_n, s_n, lam_n, wL_n, wU_n, yL_n, yU_n = S["new"]
        lam_n = _sel(S["want"], v_refresh(S["pb"], z_n, lam_n, wL_n, wU_n), lam_n)
        return dict(new=(z_n, s_n, lam_n, wL_n, wU_n, yL_n, yU_n))

    def seg_close(S):
        pb, cr, mu, active = S["pb"], S["cr"], S["sp"].mu, S["active"]
        z_n, s_n, lam_n, wL_n, wU_n, yL_n, yU_n = S["new"]
        err_mu, err_0 = v_kkt_error(pb, z_n, s_n, lam_n, wL_n, wU_n, yL_n, yU_n, mu)
        # a non-finite trial point is a failed iteration: revert
        bad = ~torch.isfinite(err_0)
        z_n, s_n, lam_n = _sel(bad, cr.z, z_n), _sel(bad, cr.s, s_n), _sel(bad, cr.lam, lam_n)
        wL_n, wU_n = _sel(bad, cr.wL, wL_n), _sel(bad, cr.wU, wU_n)
        yL_n, yU_n = _sel(bad, cr.yL, yL_n), _sel(bad, cr.yU, yU_n)
        err_0 = torch.where(bad, cr.kkt_err, err_0)
        err_mu = torch.where(bad, torch.inf, err_mu)
        soft_fails = torch.where(bad, cr.soft_fails + 1, S["soft_fails"])

        if adaptive:
            mu_next, mu_changed = mu, torch.zeros_like(bad)
        else:
            mu_next = torch.where(
                err_mu <= opts.kappa_eps * mu,
                torch.clamp(torch.minimum(opts.kappa_mu * mu, mu**opts.theta_mu), min=opts.mu_min),
                mu,
            )
            mu_next = torch.clamp(mu_next, min=opts.mu_min)
            mu_changed = mu_next < mu
        # the filter belongs to one barrier subproblem
        reset = mu_changed | ~S["accepted"]
        fresh_th, fresh_ph = v_fresh_filter(pb)
        filt_th, filt_ph = _sel(reset, fresh_th, S["filt_th"]), _sel(reset, fresh_ph, S["filt_ph"])
        filt_n = torch.where(reset, 1, S["filt_n"])

        converged = err_0 <= opts.tol
        diverged = ~torch.isfinite(err_0) | (torch.amax(torch.abs(z_n), dim=1) > 1e20)
        stalled = soft_fails >= opts.max_soft_fail
        status = torch.where(converged, 0, torch.where(diverged, 3, torch.where(stalled, 2, 1)))
        new = _Carry(
            z=z_n, s=s_n, lam=lam_n, wL=wL_n, wU=wU_n, yL=yL_n, yU=yU_n, mu=mu_next,
            filt_theta=filt_th, filt_phi=filt_ph, filt_n=filt_n, delta_w_last=S["delta_w_last"],
            it=cr.it + 1, done=converged | diverged | stalled, status=status, kkt_err=err_0,
            soft_fails=soft_fails,
        )
        carry = _Carry(*(_sel(active, a, b) for a, b in zip(new, cr)))
        active = ~carry.done & (carry.it < opts.max_iter)
        return dict(cr=carry, active=active, more=active.any())

    segments = dict(zip(SEGMENTS, (seg_prologue, seg_reg_trial, seg_ls_setup, seg_soc, seg_bt_trial, seg_select,
                                   seg_restore, seg_clamp, seg_refresh, seg_close)))
    refresh_read = opts.recalc_lam and nc > 0

    def drive(state, run, stats: BatchStats):
        def go(name):
            stats.segments[name] = stats.segments.get(name, 0) + 1
            run(name)

        def flag(name) -> bool:
            stats.host_syncs += 1
            value = bool(state[name])
            if stats.flag_log is not None:
                stats.flag_log.append((name, value))
            return value

        if opts.max_iter == 0:
            return
        while flag("more"):
            go("prologue")
            while True:
                stats.kkt_solves += 1
                go("reg_trial")
                if not flag("reg_more"):
                    break
            go("ls_setup")
            if flag("soc"):
                stats.kkt_solves += 1
                go("soc")
            while flag("bt_more"):
                go("bt_trial")
            go("select")
            if flag("restore"):
                stats.kkt_solves += 1
                go("restore")
            go("clamp")
            if refresh_read and flag("refresh"):
                stats.kkt_solves += 1
                go("refresh")
            go("close")
            stats.iterations += 1

    def epilogue(state) -> IPMResult:
        PB, carry = state["pb"], state["cr"]
        status = torch.where(carry.done, carry.status, 1)
        status = torch.where(
            (status != 0) & (status != 3) & (carry.kkt_err <= opts.acceptable_tol), 4, status
        )
        if opts.max_iter == 0:
            status = torch.zeros_like(status)
        z_out = torch.clamp(carry.z, PB.zl_orig, PB.zu_orig)
        return IPMResult(
            z=z_out,
            lam=carry.lam * PB.sc / PB.sf[:, None],
            zL=carry.wL / PB.sf[:, None],
            zU=carry.wU / PB.sf[:, None],
            s=carry.s,
            yL=carry.yL,
            yU=carry.yU,
            objective=vmap(f)(z_out),
            iterations=carry.it,
            kkt_error=carry.kkt_err,
            constraints_violation=vmap(exit_violation)(PB, carry.z, carry.s),
            status=status,
            successful=(status == 0) | (status == 4),
        )

    return BatchedIPM(setup=start, segments=segments, drive=drive, epilogue=epilogue)


def ipm_solve_batched(
    f: Callable,
    c: Callable,
    spec: NLPSpec,
    z0,
    zl,
    zu,
    cl,
    cu,
    options: IPMOptions = IPMOptions(),
    kkt=None,
    *,
    device,
    dtype: torch.dtype = torch.float64,
    stats: Optional[BatchStats] = None,
) -> IPMResult:
    """Solve B instances of one NLP structure at once: z0, zl, zu (B, nz) and
    cl, cu (B, nc), one instance per row. Returns an IPMResult whose every
    field has a leading batch axis (iterations, status and successful are
    (B,) tensors).

    Each instance follows the iterates `ipm_solve` gives it alone, with its
    own scaling, barrier parameter, regularization, filter and counters: bit
    for bit under the "cr" and "dense" solves in f64 (also with an f32 block
    solve, refinement and Ruiz scaling, until a refinement residual
    differs), to rounding under the structured scan and in the f64
    refinement residual, whose reductions run in another order under vmap.
    A loop runs another trip while ANY instance still needs one; instances
    that finished, or that are outside a branch, keep their values
    (`torch.where`), as under `jax.vmap` of the JAX solver. Derivatives and
    the KKT operator run through `torch.func.vmap` of the per-instance
    functions, so each KKT solve is ONE batched call (one launch of the CR
    kernel for the whole batch with a CUDA `StructuredKKT(algorithm="cr")`).
    `stats` (if given) counts the batched KKT solves, the host reads of loop
    conditions, the outer iterations and the runs of each segment. This is
    the eager run of `batched_ipm`'s segments, op by op on any device."""
    prog = batched_ipm(f, c, spec, options, kkt, device=device, dtype=dtype)
    return prog.eager(z0, zl, zu, cl, cu, BatchStats() if stats is None else stats)
