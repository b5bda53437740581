"""Fixed-iteration warm resolve (real-time-iteration mode for batched MPC;
PyTorch port of `ctdirect_tpu.solver.resolve`).

A warm-started MPC re-solve starts next to the solution, so K fixed Newton
steps at a fixed small barrier parameter converge quadratically: no line
search, no regularization retries, only the fraction-to-boundary rule. The
resolve is written for ONE instance and is batched by `torch.func.vmap`
(parallel/mpc.py); every reduction in it (the finiteness guard, the step
limits, the exit norms) is therefore per instance.

The resolve consumes and produces a full primal-dual state, so controllers
hand the state from one horizon to the next (shift + resolve)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import grad, vjp

from ctdirect_tpu_torch.solver.ipm import (
    NLPSpec,
    _amax,
    _dual_step_to_boundary,
    _max_step_to_boundary,
    _safe_gap,
)


class WarmState(NamedTuple):
    """Full primal-dual state handed between resolves."""

    z: torch.Tensor
    s: torch.Tensor
    lam: torch.Tensor
    wL: torch.Tensor
    wU: torch.Tensor
    yL: torch.Tensor
    yU: torch.Tensor


def warm_state_from_result(res) -> WarmState:
    """Build a WarmState from a full-IPM IPMResult."""
    return WarmState(
        z=res.z, s=res.s, lam=res.lam, wL=res.zL, wU=res.zU, yL=res.yL, yU=res.yU
    )


def push_inside(st: WarmState, spec: NLPSpec, zl, zu, cl, cu, margin: float) -> WarmState:
    """Move a warm state strictly inside the resolve's boxes: each finite bound
    b keeps z (and each inequality row's slack) at least margin * max(1, |b|)
    away, and at most half the box width.

    The full IPM relaxes every bound by bound_relax_factor * max(1, |b|)
    internally and projects its final z back onto the original box, so an
    active bound holds z EXACTLY; the resolve's barrier terms mu/gap are then
    infinite and the first tick turns the whole state into NaN (the JAX
    package's MPCController.cold_start hands the resolve such a state).
    margin = the cold solve's bound_relax_factor undoes exactly that move."""

    def push(x, lo, hi, lmask, umask):
        lmask = torch.as_tensor(lmask, device=x.device)
        umask = torch.as_tensor(umask, device=x.device)
        lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
        hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
        width = torch.where(lmask & umask, hi - lo, torch.inf)
        pL = torch.minimum(margin * torch.clamp(torch.abs(lo), min=1.0), 0.5 * width)
        pU = torch.minimum(margin * torch.clamp(torch.abs(hi), min=1.0), 0.5 * width)
        x = torch.where(lmask, torch.maximum(x, lo + pL), x)
        return torch.where(umask, torch.minimum(x, hi - pU), x)

    return st._replace(
        z=push(st.z, zl, zu, spec.zl_mask, spec.zu_mask),
        s=push(st.s, cl, cu, spec.sl_mask, spec.su_mask),
    )


def warm_state_from_numpy(arrays, device, dtype: torch.dtype = torch.float64) -> WarmState:
    """A WarmState from host arrays: any object with the fields z, s, lam, wL,
    wU, yL, yU (e.g. the JAX package's WarmState, or a mapping with those
    keys), with or without a leading batch axis."""
    def get(name):
        return arrays[name] if isinstance(arrays, dict) else getattr(arrays, name)

    return WarmState(
        *(
            torch.tensor(np.array(get(name)), dtype=dtype, device=device)
            for name in WarmState._fields
        )
    )


class ResolveResult(NamedTuple):
    state: WarmState
    objective: torch.Tensor
    kkt_error: torch.Tensor
    constraints_violation: torch.Tensor


def make_resolver(
    f,
    c,
    spec: NLPSpec,
    kkt,
    *,
    device,
    iters: int = 3,
    mu: float = 1e-6,
    delta_w: float = 1e-8,
    delta_c: float = 1e-8,
    tau: float = 0.99,
):
    """Build resolve(state, zl, zu, cl, cu) -> ResolveResult for one instance
    (vmap it for a batch).

    `kkt` is a KKT operator (StructuredKKT for production). No scaling is
    applied (warm MPC problems should be pre-scaled by construction)."""

    def mask(x):
        return torch.as_tensor(x, dtype=torch.bool, device=device)

    eq = mask(spec.eq_mask)
    ineq = ~eq
    zlm = mask(spec.zl_mask)
    zum = mask(spec.zu_mask)
    slm = mask(spec.sl_mask)
    sum_ = mask(spec.su_mask)
    grad_f = grad(f)

    def resolve(state: WarmState, zl, zu, cl, cu) -> ResolveResult:
        dtype = state.z.dtype
        sl = torch.where(ineq, cl, 0.0)
        su = torch.where(ineq, cu, 0.0)
        rhs_eq = torch.where(eq, cl, 0.0)
        sf = torch.ones((), dtype=dtype, device=device)
        sc = torch.ones_like(cl)

        def primal_residual(z, s):
            return c(z) - rhs_eq - torch.where(ineq, s, 0.0)

        def one_step(st: WarmState) -> WarmState:
            z, s, lam, wL, wU, yL, yU = st
            gL = _safe_gap(z, zl, zlm)
            gU = _safe_gap(zu, z, zum)
            sgL = _safe_gap(s, sl, slm)
            sgU = _safe_gap(su, s, sum_)
            sigma_z = torch.where(zlm, wL / gL, 0.0) + torch.where(zum, wU / gU, 0.0)
            sigma_s = torch.where(slm, yL / sgL, 0.0) + torch.where(sum_, yU / sgU, 0.0)
            sigma_s = torch.where(ineq, torch.clamp(sigma_s, min=1e-12), 1.0)
            Drow = torch.where(ineq, 1.0 / sigma_s, 0.0)

            data = kkt.prepare(z, lam, sf, sc)
            gf = grad_f(z)
            rbar_z = (
                gf
                + vjp(c, z)[1](lam)[0]
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

            # ONE block solve per iteration; a non-finite direction (singular
            # system) freezes the iterate instead of destroying the state
            dz, dlam = kkt.solve(data, sigma_z, Drow, delta_w, delta_c, rbar_z, rbar_p)
            ds = torch.where(ineq, (dlam - rbar_s) / sigma_s, 0.0)
            dwL = torch.where(zlm, -(wL / gL) * dz - wL + mu / gL, 0.0)
            dwU = torch.where(zum, (wU / gU) * dz - wU + mu / gU, 0.0)
            dyL = torch.where(slm, -(yL / sgL) * ds - yL + mu / sgL, 0.0)
            dyU = torch.where(sum_, (yU / sgU) * ds - yU + mu / sgU, 0.0)

            a_z = _max_step_to_boundary(z, dz, zl, zu, zlm, zum, tau)
            a_s = _max_step_to_boundary(s, ds, sl, su, slm, sum_, tau)
            alpha = torch.minimum(a_z, a_s)
            a_d = torch.minimum(
                torch.minimum(
                    _dual_step_to_boundary(wL, dwL, zlm, tau),
                    _dual_step_to_boundary(wU, dwU, zum, tau),
                ),
                torch.minimum(
                    _dual_step_to_boundary(yL, dyL, slm, tau),
                    _dual_step_to_boundary(yU, dyU, sum_, tau),
                ),
            )
            finite = torch.isfinite(dz).all() & torch.isfinite(dlam).all()
            alpha = torch.where(finite, alpha, 0.0)
            a_d = torch.where(finite, a_d, 0.0)
            return WarmState(
                z=z + alpha * dz,
                s=s + alpha * ds,
                lam=lam + alpha * dlam,
                wL=torch.clamp(wL + a_d * dwL, min=0.0),
                wU=torch.clamp(wU + a_d * dwU, min=0.0),
                yL=torch.clamp(yL + a_d * dyL, min=0.0),
                yU=torch.clamp(yU + a_d * dyU, min=0.0),
            )

        st = state
        for _ in range(iters):
            st = one_step(st)

        # cheap exit diagnostics (no Ipopt scaling — raw inf norms)
        r_d = (
            grad_f(st.z)
            + vjp(c, st.z)[1](st.lam)[0]
            - torch.where(zlm, st.wL, 0.0)
            + torch.where(zum, st.wU, 0.0)
        )
        r_p = primal_residual(st.z, st.s)
        viol = _amax(torch.abs(r_p), 0.0)
        kkt_err = torch.maximum(torch.amax(torch.abs(r_d)), viol)
        return ResolveResult(
            state=st, objective=f(st.z), kkt_error=kkt_err, constraints_violation=viol
        )

    return resolve
