"""The plain reference: the trapezoidal transcription of a fixed-time optimal
control problem, the warm MPC tick's Newton steps, and the KKT error of a
cold IPM solve, in plain PyTorch, float64, dense.

It imports nothing of the program (neither package of this repository) and
takes nothing the program made: the problem comes from the configuration file
and from the configuration's own equations (`perfbench/reference/<config>.py`),
the x0 rows from the benchmark's traffic. The program's outputs are read only
to be judged; where the tick follows the program's own warm state (the state
a tick starts from is the previous tick's result), that is said in PERF.md.

Layout (the program's public state layout, which the reference has to read):
z = [x_0, u_0, x_1, u_1, ..., x_N, u_N], (N + 1)(n + m) entries; the
constraints are the N defect blocks x_{i+1} - x_i - h_i/2 (f_i + f_{i+1}) (n
rows each), then the boundary rows [x_0; x_N] (2n rows), every one an
equality. The warm state's slacks and constraint multipliers follow the
constraint rows, its bound multipliers the z entries.

Departures from the program's arithmetic, each with its reason:
- The Newton step's linear system is assembled whole and solved by LU
  (`torch.linalg.solve`) in float64, where the program assembles the KKT
  chain and solves it by block cyclic reduction, in float32 for the double
  integrator. Same system, other rounding: the tick's limits (perfbench/
  limits/) are set from the two readings of PERF.md.
- The Hessian and Jacobians come from `torch.func` on the whole transcribed
  functions, where the program differentiates step blocks."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, vmap

# the warm resolve's fixed parameters (the tick's Newton steps)
MU, DELTA_W, DELTA_C, TAU = 1e-6, 1e-8, 1e-8, 0.99
# Ipopt's KKT error scaling: s_max and the gradient-scaling threshold
S_MAX, SCALING_MAX_GRAD = 100.0, 100.0


class State(NamedTuple):
    """A primal-dual state, with the program's field names and order."""

    z: torch.Tensor
    s: torch.Tensor
    lam: torch.Tensor
    wL: torch.Tensor
    wU: torch.Tensor
    yL: torch.Tensor
    yU: torch.Tensor


class Trapeze:
    """The trapezoidal transcription of `equations` (a module with
    `dynamics(x, u, cfg)` and `lagrange(x, u, cfg)`) at the configuration
    `cfg`: N steps on [0, T], state and control boxes, x(0) and x(T) fixed.
    `dtype` is float64 but for the control, which runs the reference in the
    program's place at the next lower precision."""

    def __init__(self, cfg: dict, equations, device="cpu", dtype=torch.float64):
        self.cfg, self.eq = cfg, equations
        p = cfg["problem"]
        self.N, self.n, self.m = cfg["grid_size"], len(p["x_initial"]), len(p["u_lower"])
        self.device, self.dtype = torch.device(device), dtype
        # no TF32 in a float32 product on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        N, n, m = self.N, self.n, self.m
        # the grid as the program makes it: a normalized linspace scaled to [0, T]
        t = np.linspace(0.0, 1.0, N + 1) * p["horizon"]
        self.h = self.tensor(t)[1:] - self.tensor(t)[:-1]
        self.nz, self.nc = (N + 1) * (n + m), N * n + 2 * n
        self.z_lb = np.tile(np.concatenate([_bound(p["x_lower"]), _bound(p["u_lower"])]), N + 1)
        self.z_ub = np.tile(np.concatenate([_bound(p["x_upper"]), _bound(p["u_upper"])]), N + 1)
        self.c_lb = np.concatenate([np.zeros(N * n), p["x_initial"], p["x_final"]])
        self.c_ub = self.c_lb.copy()
        self.x0_rows = N * n + np.arange(n)  # the boundary rows that fix x(0)

    def tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=self.dtype, device=self.device)

    def nodes(self, z):
        V = z.reshape(self.N + 1, self.n + self.m)
        return V[:, : self.n], V[:, self.n:]

    def objective(self, z):
        X, U = self.nodes(z)
        L = vmap(lambda x, u: self.eq.lagrange(x, u, self.cfg))(X, U)
        return torch.sum(0.5 * self.h * (L[:-1] + L[1:]))

    def constraints(self, z):
        X, U = self.nodes(z)
        F = vmap(lambda x, u: self.eq.dynamics(x, u, self.cfg))(X, U)
        D = X[1:] - X[:-1] - 0.5 * self.h[:, None] * (F[:-1] + F[1:])
        return torch.cat([D.reshape(-1), X[0], X[-1]])

    def u0(self, z):
        return self.nodes(z)[1][0]

    def rhs(self, x0):
        """The constraint bounds (cl, cu) of a tick or scenario whose x(0) is
        x0: (n,) or (k, n) -> (nc,) or (k, nc) each."""
        x0 = torch.as_tensor(x0, dtype=self.dtype, device=self.device)
        a, b = self.x0_rows[0], self.x0_rows[-1] + 1

        def put(bounds):
            part = lambda v: self.tensor(v).expand(x0.shape[:-1] + (len(v),))
            return torch.cat([part(bounds[:a]), x0, part(bounds[b:])], dim=-1)

        return put(self.c_lb), put(self.c_ub)

    def shift(self, st: State) -> State:
        """The MPC warm start: every per-step row block moves one step
        forward and the last is duplicated; the boundary rows (and, for the
        bound multipliers, the last node's entries) stay as they are; z's
        node blocks all move, the last node duplicated."""
        N, n, m = self.N, self.n, self.m

        def rows(a, width):
            head = a[: N * width].reshape(N, width)
            return torch.cat([head[1:].reshape(-1), head[-1], a[N * width:]])

        V = st.z.reshape(N + 1, n + m)
        z = torch.cat([V[1:], V[-1:]]).reshape(-1)
        return State(z, rows(st.s, n), rows(st.lam, n), rows(st.wL, n + m), rows(st.wU, n + m),
                     rows(st.yL, n), rows(st.yU, n))

    def masks(self, cl, cu):
        """(eq, zl finite, zu finite, slack lower finite, slack upper finite),
        from the static bounds as the program takes them."""
        t = lambda a: torch.as_tensor(a, device=self.device)
        c_lb, c_ub = self.c_lb, self.c_ub
        eq = np.isfinite(c_lb) & np.isfinite(c_ub) & (c_lb == c_ub)
        return (t(eq), t(np.isfinite(self.z_lb)), t(np.isfinite(self.z_ub)), t(~eq & np.isfinite(c_lb)),
                t(~eq & np.isfinite(c_ub)))


def _bound(values):
    return np.array([np.inf if v == "inf" else -np.inf if v == "-inf" else float(v) for v in values])


def _gap(x, lb, mask):
    return torch.where(mask, x - torch.where(mask, lb, 0.0), 1.0)


def _min_ratio(a):
    return torch.clamp(torch.amin(a), max=1.0) if a.numel() else a.new_ones(())


def _primal_step(x, dx, lb, ub, lm, um):
    aL = torch.where(lm & (dx < 0), -TAU * _gap(x, lb, lm) / torch.where(dx < 0, dx, -1.0), 1.0)
    aU = torch.where(um & (dx > 0), TAU * _gap(ub, x, um) / torch.where(dx > 0, dx, 1.0), 1.0)
    return torch.clamp(torch.minimum(_min_ratio(aL), _min_ratio(aU)), 0.0, 1.0)


def _dual_step(w, dw, mask):
    a = torch.where(mask & (dw < 0), -TAU * w / torch.where(dw < 0, dw, -1.0), 1.0)
    return torch.clamp(_min_ratio(a), 0.0, 1.0)


def tick(tr: Trapeze, st: State, x0, iters: int, solve_dtype=None):
    """One warm MPC tick of one controller: the shift, x0 into the boundary
    rows, `iters` Newton steps at the fixed barrier parameter MU with the
    fraction-to-boundary rule TAU and no line search; the dense system
    [[W + Sigma_z + dw I, J^T], [J, -(D + dc I)]] [dz; dlam] = -[rz; rp].
    Returns (state, u0, the exit KKT error: max(|dual residual|, |primal
    residual|), inf-norms, no Ipopt scaling). `solve_dtype` (the control
    only) solves the system in that dtype. vmap it over controllers."""
    f, c = tr.objective, tr.constraints
    cl, cu = tr.rhs(x0)
    zl, zu = tr.tensor(tr.z_lb), tr.tensor(tr.z_ub)
    eq, zlm, zum, slm, sum_ = tr.masks(cl, cu)
    ineq = ~eq
    sl, su, rhs_eq = torch.where(ineq, cl, 0.0), torch.where(ineq, cu, 0.0), torch.where(eq, cl, 0.0)

    def lagrangian(z, lam):
        return f(z) + torch.dot(lam, c(z))

    st = tr.shift(st)
    for _ in range(iters):
        z, s, lam, wL, wU, yL, yU = st
        gL, gU, sgL, sgU = _gap(z, zl, zlm), _gap(zu, z, zum), _gap(s, sl, slm), _gap(su, s, sum_)
        sigma_z = torch.where(zlm, wL / gL, 0.0) + torch.where(zum, wU / gU, 0.0)
        sigma_s = torch.where(slm, yL / sgL, 0.0) + torch.where(sum_, yU / sgU, 0.0)
        sigma_s = torch.where(ineq, torch.clamp(sigma_s, min=1e-12), 1.0)
        Drow = torch.where(ineq, 1.0 / sigma_s, 0.0)
        W = hessian(lagrangian, argnums=0)(z, lam)
        J = jacfwd(c)(z)
        rz = grad(f)(z) + J.T @ lam - torch.where(zlm, MU / gL, 0.0) + torch.where(zum, MU / gU, 0.0)
        rs = torch.where(ineq, -lam - torch.where(slm, MU / sgL, 0.0) + torch.where(sum_, MU / sgU, 0.0), 0.0)
        rp = c(z) - rhs_eq - torch.where(ineq, s, 0.0) + torch.where(ineq, rs / sigma_s, 0.0)
        K = torch.cat([torch.cat([W + torch.diag(sigma_z + DELTA_W), J.T], 1),
                       torch.cat([J, -torch.diag(Drow + DELTA_C)], 1)], 0)
        # no check of LU's pivots: a singular system gives non-finite entries, which
        # the finiteness test below turns into a step of zero, as the program does
        rhs = -torch.cat([rz, rp])
        sd = solve_dtype or K.dtype
        sol = torch.linalg.solve_ex(K.to(sd), rhs.to(sd))[0].to(K.dtype)
        dz, dlam = sol[: tr.nz], sol[tr.nz:]
        ds = torch.where(ineq, (dlam - rs) / sigma_s, 0.0)
        dwL = torch.where(zlm, -(wL / gL) * dz - wL + MU / gL, 0.0)
        dwU = torch.where(zum, (wU / gU) * dz - wU + MU / gU, 0.0)
        dyL = torch.where(slm, -(yL / sgL) * ds - yL + MU / sgL, 0.0)
        dyU = torch.where(sum_, (yU / sgU) * ds - yU + MU / sgU, 0.0)
        alpha = torch.minimum(_primal_step(z, dz, zl, zu, zlm, zum), _primal_step(s, ds, sl, su, slm, sum_))
        a_d = torch.minimum(torch.minimum(_dual_step(wL, dwL, zlm), _dual_step(wU, dwU, zum)),
                            torch.minimum(_dual_step(yL, dyL, slm), _dual_step(yU, dyU, sum_)))
        finite = torch.isfinite(dz).all() & torch.isfinite(dlam).all()
        alpha, a_d = torch.where(finite, alpha, 0.0), torch.where(finite, a_d, 0.0)
        st = State(z + alpha * dz, s + alpha * ds, lam + alpha * dlam, torch.clamp(wL + a_d * dwL, min=0.0),
                   torch.clamp(wU + a_d * dwU, min=0.0), torch.clamp(yL + a_d * dyL, min=0.0),
                   torch.clamp(yU + a_d * dyU, min=0.0))
    return st, tr.u0(st.z), tick_kkt(tr, st, x0)


def tick_kkt(tr: Trapeze, st: State, x0):
    """The tick's exit KKT error of state `st` for the tick with x0: the
    inf-norm of the dual residual grad f + J^T lam - wL + wU and of the
    primal residual, whichever is larger (no barrier terms, no scaling)."""
    cl, cu = tr.rhs(x0)
    eq, zlm, zum, _, _ = tr.masks(cl, cu)
    ineq = ~eq
    z = st.z
    r_d = (grad(tr.objective)(z) + jacfwd(tr.constraints)(z).T @ st.lam - torch.where(zlm, st.wL, 0.0)
           + torch.where(zum, st.wU, 0.0))
    r_p = tr.constraints(z) - torch.where(eq, cl, 0.0) - torch.where(ineq, st.s, 0.0)
    return torch.maximum(torch.amax(torch.abs(r_d)), torch.amax(torch.abs(r_p)))


def ipm_kkt_error(tr: Trapeze, z0, x0, z, lam, zL, zU):
    """The KKT error of a cold IPM solve's result for the scenario with
    initial state x0, started from z0, in the solver's stated measure
    (Ipopt's scaled error at mu = 0, against the solve's tolerance): the
    objective and each constraint row scaled by min(1, 100 / |gradient at
    z0|_inf) (Ipopt's gradient-based scaling), the dual residual divided by
    s_d and the complementarity by s_c (Ipopt's s_max rule). The result's
    multipliers are in the problem's own units, as the solver returns them.

    The solver relaxes every box bound by 1e-8 max(1, |bound|) and clips its
    iterate onto the original box at the end, so an entry of z that sits on
    a bound stood on the relaxed bound inside the solver (`clip_shift`):
    the dual and primal residuals are read there; a clip of 1.2e-7 moves
    cart-pole's dual residual by up to ~4e-7 through the multipliers of the
    active boxes. The complementarity is read at z on the original box,
    where the clip only shrinks each product. vmap it over scenarios."""
    cl, cu = tr.rhs(x0)
    eq, zlm, zum, _, _ = tr.masks(cl, cu)
    zl, zu = tr.tensor(tr.z_lb), tr.tensor(tr.z_ub)
    f, c = tr.objective, tr.constraints
    sf = torch.clamp(SCALING_MAX_GRAD / torch.clamp(torch.amax(torch.abs(grad(f)(z0))), min=1e-8), max=1.0)
    J0 = jacfwd(c)(z0)
    sc = torch.clamp(SCALING_MAX_GRAD / torch.clamp(torch.amax(torch.abs(J0), dim=1), min=1e-8), max=1.0)
    # the solver's own (scaled) multipliers
    lam_s, wL, wU = lam * sf / sc, torch.where(zlm, zL * sf, 0.0), torch.where(zum, zU * sf, 0.0)
    zi = clip_shift(tr, z)
    r_d = sf * grad(f)(zi) + jacfwd(c)(zi).T @ (sc * lam_s) - wL + wU
    r_p = torch.where(eq, sc * (c(zi) - cl), 0.0)
    prods = torch.cat([torch.where(zlm, wL * _gap(z, zl, zlm), 0.0), torch.where(zum, wU * _gap(zu, z, zum), 0.0)])
    bound_sum = torch.sum(wL + wU)
    n = float(tr.nz + tr.nc)
    s_d = torch.clamp((torch.sum(torch.abs(lam_s)) + bound_sum) / n, min=S_MAX) / S_MAX
    s_c = torch.clamp(bound_sum / max(1.0, n), min=S_MAX) / S_MAX
    e_d = torch.amax(torch.abs(r_d)) / s_d
    return torch.maximum(torch.maximum(e_d, torch.amax(torch.abs(r_p))), torch.amax(torch.abs(prods)) / s_c)


def clip_shift(tr: Trapeze, z, relax: float = 1e-8):
    """z with every entry that sits on a finite box bound moved outward by
    the solver's internal relaxation, relax x max(1, |bound|): where the
    solver's own iterate stood before its final clip onto the box."""
    zl, zu = tr.tensor(tr.z_lb), tr.tensor(tr.z_ub)
    on_l = torch.isfinite(zl) & (z <= zl)
    on_u = torch.isfinite(zu) & (z >= zu)
    z = torch.where(on_l, zl - relax * torch.clamp(torch.abs(zl), min=1.0), z)
    return torch.where(on_u, zu + relax * torch.clamp(torch.abs(zu), min=1.0), z)


def onto_box(tr: Trapeze, z, inside: float):
    """z with every entry within inside x max(1, |bound|) of a finite box
    bound put on that bound: a solve's result that a warm start moved that
    far inside its boxes (the MPC cold start), back where the solve left it."""
    zl, zu = tr.tensor(tr.z_lb), tr.tensor(tr.z_ub)
    z = torch.where(torch.isfinite(zl) & (z <= zl + inside * torch.clamp(torch.abs(zl), min=1.0)), zl, z)
    return torch.where(torch.isfinite(zu) & (z >= zu - inside * torch.clamp(torch.abs(zu), min=1.0)), zu, z)


def cold_start_error(tr: Trapeze, cold: dict, to_answer=lambda a: a):
    """`ipm_kkt_error` of the cold start (`cold`: its z, lam, zL, zU, its
    starting point "z0", and "inside", how far the controller moved z inside
    its boxes, which `onto_box` undoes), for the configuration's own x(0);
    `to_answer` maps each of the result's tensors as the control does."""
    get = lambda k: to_answer(torch.as_tensor(cold[k])).to(tr.device, tr.dtype)
    z = onto_box(tr, get("z"), cold["inside"])
    return float(ipm_kkt_error(tr, tr.tensor(cold["z0"]), tr.tensor(tr.cfg["problem"]["x_initial"]), z,
                               get("lam"), get("zL"), get("zU")))
