"""Structured KKT operator: block-tridiagonal + arrowhead, solved in O(N)
(PyTorch port of `ctdirect_tpu.solver.structured_kkt`).

After interleaving primal step-blocks with their constraint multipliers, the
condensed IPM system of a collocation DOCP is a symmetric block-TRIDIAGONAL
matrix with a dense ARROWHEAD border:

    [ A_1  B_1              E_1 ] [x_1]   [r_1]
    [ B_1' A_2  B_2         E_2 ] [x_2]   [r_2]
    [          ...          ... ] [...] = [...]
    [            B_{N-1}' A_N E_N] [x_N]   [r_N]
    [ E_1' E_2' ...  E_N'     F ] [xb ]   [rb ]

    x_i = [dw_i; dlam_i]   (step variables + step constraint multipliers)
    xb  = [d_tail; dv; dlam_finalpath; dlam_boundary]

Blocks come from `torch.func.vmap`ped per-step Hessians/Jacobians of the
scheme's LOCAL residual/cost forms. Assembly is written out of place
(`torch.cat`, `F.pad`) so that it runs under the batched tick's vmap.

Two solves: "scan" (sequential forward block elimination + border Schur +
back substitution; the full IPM's default) through `scan_kernel.scan_solve`,
and "cr" (block cyclic reduction) through `lanes.cr_solve`; each reaches its
hand-written CUDA kernel on the card, one launch per block solve (under
`torch.func.vmap`, one for the whole batch), and its plain version on the
CPU (`_scan_solve` below, `lanes.cr_solve_lanes`). Around a
reduced-precision block solve the operator runs two symmetric Ruiz passes on
the assembled blocks and iterative refinement with the residual in the
DOCP's dtype, as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as nnf
from torch.func import hessian, jacfwd, vmap

from ctdirect_tpu_torch.solver.kkt import gj_inverse, gj_solve
from ctdirect_tpu_torch.solver.lanes import cr_solve
from ctdirect_tpu_torch.solver.scan_kernel import scan_solve
from ctdirect_tpu_torch.transcription.docp import DOCP


class _Dims(NamedTuple):
    N: int
    bw: int  # step primal width
    cw: int  # step constraint rows
    iw: int  # interface width (tail width): n (+m for trapeze)
    q: int
    n: int
    npath: int
    nb: int
    bs: int  # super-block = bw + cw
    wb: int  # border width = iw + q + npath + nb


def _place(x, shape, offsets):
    """x zero-padded into a tensor of `shape` with its corner at `offsets`."""
    pad = []
    for size, off, full in reversed(list(zip(x.shape, offsets, shape))):
        pad += [off, full - off - size]
    return nnf.pad(x, pad)


def _sum_placed(shape, pieces, like):
    """Sum of (x, offsets) pieces placed into zeros of `shape`, in order — the
    out-of-place form of a chain of `.at[...].add(x)` updates."""
    out = None
    for x, offsets in pieces:
        if 0 in x.shape:
            continue
        y = _place(x, shape, offsets)
        out = y if out is None else out + y
    if out is None:
        out = torch.zeros(shape, dtype=like.dtype, device=like.device)
    return out


class StructuredKKT:
    """KKT operator exploiting the DOCP's step structure (see solver/kkt.py
    for the operator protocol)."""

    def __init__(self, docp: DOCP, algorithm: str = "scan", solve_dtype=None,
                 refine: int = 0, equilibrate: Optional[bool] = None,
                 assemble_dtype=None):
        """algorithm: "scan" (sequential block elimination, O(N) depth) or
        "cr" (block cyclic reduction, O(log N) depth).

        solve_dtype: optional lower precision (torch.float32) for the BLOCK
        SOLVE only — assembly, residuals and the applied step stay in the
        DOCP's dtype (inexact Newton).

        refine: iterative-refinement sweeps around the reduced-precision
        solve: the residual r - K x is taken on the assembled blocks in their
        dtype and the correction is solved in solve_dtype. The loop starts
        from zero, so 1 + refine block solves per call. No effect when
        solve_dtype is None.

        equilibrate: two symmetric Ruiz passes (K' = D K D, d_i =
        rownorm^-1/2) on the assembled blocks before the solve, unscaled
        after. None means "on iff solve_dtype is set", as in the JAX package.

        assemble_dtype: run prepare and assembly in this dtype (the JAX
        package's option for the warm resolve tick; not for the full IPM).
        None keeps the input's dtype.

        `block_solves` counts the block solves this operator ran (one per
        batched call under `torch.func.vmap`): on CUDA tensors one kernel
        launch each, of the scan kernel with "scan" and of the CR kernel
        with "cr"."""
        if algorithm not in ("scan", "cr"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        self.algorithm = algorithm
        self.solve_dtype = solve_dtype
        self.refine = int(refine)
        self.equilibrate = (solve_dtype is not None) if equilibrate is None else bool(equilibrate)
        self.assemble_dtype = assemble_dtype
        self.block_solves = 0
        self.docp = docp
        d = _Dims(
            N=docp.N,
            bw=docp.bw,
            cw=docp.cw,
            iw=docp.tail_w,
            q=docp.q,
            n=docp.n,
            npath=docp.n_path,
            nb=docp.n_boundary,
            bs=docp.bw + docp.cw,
            wb=docp.tail_w + docp.q + docp.n_path + docp.n_boundary,
        )
        self.d = d
        self._si = docp._snorm_t[:-1]  # normalized grid, on the device
        self._sip1 = docp._snorm_t[1:]
        scheme = docp.scheme
        fns = docp.fns
        ocp = docp.ocp
        n, m, s, cs = docp.n, docp.m, docp.s, docp.cs

        def times(si, sip1, v):
            ts = ocp.time
            t0 = ts.t0 if not ts.free_t0 else v[ts.t0_index]
            tf = ts.tf if not ts.free_tf else v[ts.tf_index]
            return t0 + si * (tf - t0), t0 + sip1 * (tf - t0)

        def split_w(w):
            x = w[:n]
            U = w[n : n + cs * m].reshape(cs, m)
            K = w[n + cs * m :].reshape(s, n) if s > 0 else None
            return x, U, K

        def split_y(y):
            xn = y[:n]
            un = y[n:] if scheme.u_at_nodes else None
            return xn, un

        # ---- per-step local constraint rows [defect | stages | path(t_i)] ----
        def cons_step(si, sip1, w, y, v):
            ti, tip1 = times(si, sip1, v)
            x, U, K = split_w(w)
            xn, un = split_y(y)
            res = scheme.local_residual(fns, ti, tip1, x, U, K, xn, un, v)
            if docp._path is not None:
                u_node = scheme.local_node_control(U)
                res = torch.cat([res, docp._path(ti, x, u_node, v)])
            return res

        def cost_step(si, sip1, w, y, v):
            if fns.lagrange is None:
                return torch.zeros((), dtype=w.dtype, device=w.device)
            ti, tip1 = times(si, sip1, v)
            x, U, K = split_w(w)
            xn, un = split_y(y)
            return scheme.local_cost(fns, ti, tip1, x, U, K, xn, un, v)

        # ---- border rows: final-node path, boundary; border cost: Mayer ----
        def final_node_control(wN, tail):
            if scheme.u_at_nodes:  # trapeze: control stored in the tail
                return tail[n:]
            _, U, _ = split_w(wN)
            return scheme.local_node_control(U)

        def cons_fp(wN, tail, v):
            ts = ocp.time
            tf = ts.tf if not ts.free_tf else v[ts.tf_index]
            return docp._path(tf, tail[:n], final_node_control(wN, tail), v)

        def cons_bc(x0, tail, v):
            return docp._boundary(x0, tail[:n], v)

        def cost_border(x0, wN, tail, v):
            if docp._mayer is None:
                return torch.zeros((), dtype=tail.dtype, device=tail.device)
            g = docp._mayer(x0, tail[:n], v)
            return -g if ocp.maximize else g

        self._cons_step = cons_step
        self._cost_step = cost_step
        self._cons_fp = cons_fp if docp._path is not None else None
        self._cons_bc = cons_bc if docp._boundary is not None else None
        self._cost_border = cost_border
        # local cost forms are in user sense; flip for max problems
        self._obj_sign = -1.0 if ocp.maximize else 1.0

    # ------------------------------------------------------------------
    # flat-vector split/merge
    # ------------------------------------------------------------------
    def _split_z(self, z):
        d = self.d
        Wm = z[: d.N * d.bw].reshape(d.N, d.bw)
        tail = z[d.N * d.bw : d.N * d.bw + d.iw]
        v = z[d.N * d.bw + d.iw :]
        # interface rows: y_i = first iw entries of the NEXT block; y_{N-1} = tail
        Y = torch.cat([Wm[1:, : d.iw], tail[None, :]], dim=0)  # (N, iw)
        return Wm, Y, tail, v

    def _split_lam(self, lam):
        d = self.d
        lam_steps = lam[: d.N * d.cw].reshape(d.N, d.cw)
        lam_fp = lam[d.N * d.cw : d.N * d.cw + d.npath]
        lam_bc = lam[d.N * d.cw + d.npath :]
        return lam_steps, lam_fp, lam_bc

    def _border_jacobians(self, Wm, tail, v, sc_fp, sc_bc, like):
        d = self.d
        if self._cons_fp is not None:
            Jfp = sc_fp[:, None] * jacfwd(
                lambda a: self._cons_fp(a[: d.bw], a[d.bw : d.bw + d.iw], a[d.bw + d.iw :])
            )(torch.cat([Wm[-1], tail, v]))  # (npath, bw+iw+q)
        else:
            Jfp = like.new_zeros((0, d.bw + d.iw + d.q))
        if self._cons_bc is not None:
            Jbc = sc_bc[:, None] * jacfwd(
                lambda a: self._cons_bc(a[: d.n], a[d.n : d.n + d.iw], a[d.n + d.iw :])
            )(torch.cat([Wm[0][: d.n], tail, v]))  # (nb, n+iw+q)
        else:
            Jbc = like.new_zeros((0, d.n + d.iw + d.q))
        return Jfp, Jbc

    # ------------------------------------------------------------------
    # operator protocol
    # ------------------------------------------------------------------
    def row_norms(self, z):
        """Unscaled |J| row-inf-norms from the block jacobians."""
        d = self.d
        Wm, Y, tail, v = self._split_z(z)

        def one(si_, sip1_, w, y):
            Jl = jacfwd(
                lambda arg: self._cons_step(
                    si_, sip1_, arg[: d.bw], arg[d.bw : d.bw + d.iw], arg[d.bw + d.iw :]
                )
            )(torch.cat([w, y, v]))
            return torch.amax(torch.abs(Jl), dim=1)

        rows = vmap(one)(self._si, self._sip1, Wm, Y).reshape(-1)
        ones_fp = z.new_ones((d.npath,))
        ones_bc = z.new_ones((d.nb,))
        Jfp, Jbc = self._border_jacobians(Wm, tail, v, ones_fp, ones_bc, z)
        parts = [rows]
        if self._cons_fp is not None:
            parts.append(torch.amax(torch.abs(Jfp), dim=1))
        if self._cons_bc is not None:
            parts.append(torch.amax(torch.abs(Jbc), dim=1))
        return torch.cat(parts)

    def prepare(self, z, lam, sf, sc):
        """Per-step scaled Lagrangian Hessians + constraint Jacobians."""
        d = self.d
        if self.assemble_dtype is not None:
            z, lam, sf, sc = (_cast(a, self.assemble_dtype) for a in (z, lam, sf, sc))
        Wm, Y, tail, v = self._split_z(z)
        lam_steps, lam_fp, lam_bc = self._split_lam(lam)
        sc_steps, sc_fp, sc_bc = self._split_lam(sc)
        # the grid in the working dtype (an f64 grid would promote the whole
        # AD pass back to f64 under assemble_dtype=float32)
        si, sip1 = self._si.to(z.dtype), self._sip1.to(z.dtype)
        sgn = self._obj_sign

        def step_data(si_, sip1_, w, y, lam_i, sc_i):
            arg = torch.cat([w, y, v])

            def cons(a):
                return self._cons_step(si_, sip1_, a[: d.bw], a[d.bw : d.bw + d.iw], a[d.bw + d.iw :])

            def lag(a):
                cost = self._cost_step(
                    si_, sip1_, a[: d.bw], a[d.bw : d.bw + d.iw], a[d.bw + d.iw :]
                )
                return sgn * sf * cost + torch.dot(sc_i * lam_i, cons(a))

            H = hessian(lag)(arg)  # (D, D)
            J = sc_i[:, None] * jacfwd(cons)(arg)  # (cw, D)
            return H, J

        Hloc, Jloc = vmap(step_data)(si, sip1, Wm, Y, lam_steps, sc_steps)

        # border: hessian of sf*mayer + lam_fp' fp + lam_bc' bc over (x0,wN,tail,v)
        argb = torch.cat([Wm[0][: d.n], Wm[-1], tail, v])

        def border_lag(a):
            x0 = a[: d.n]
            wN = a[d.n : d.n + d.bw]
            tl = a[d.n + d.bw : d.n + d.bw + d.iw]
            vv = a[d.n + d.bw + d.iw :]
            val = sf * self._cost_border(x0, wN, tl, vv)
            if self._cons_fp is not None:
                val = val + torch.dot(sc_fp * lam_fp, self._cons_fp(wN, tl, vv))
            if self._cons_bc is not None:
                val = val + torch.dot(sc_bc * lam_bc, self._cons_bc(x0, tl, vv))
            return val

        Hb = hessian(border_lag)(argb)  # (Db, Db)
        Jfp, Jbc = self._border_jacobians(Wm, tail, v, sc_fp, sc_bc, z)
        return dict(Hloc=Hloc, Jloc=Jloc, Hb=Hb, Jfp=Jfp, Jbc=Jbc)

    def prepare_jac_only(self, z, sc):
        """prepare() minus the Lagrangian Hessians (zeros instead): the
        Jacobian-only data the LSQ multiplier init needs."""
        d = self.d
        Wm, Y, tail, v = self._split_z(z)
        sc_steps, sc_fp, sc_bc = self._split_lam(sc)
        D = d.bw + d.iw + d.q

        def step_jac(si_, sip1_, w, y, sc_i):
            def cons(a):
                return self._cons_step(
                    si_, sip1_, a[: d.bw], a[d.bw : d.bw + d.iw], a[d.bw + d.iw :]
                )

            return sc_i[:, None] * jacfwd(cons)(torch.cat([w, y, v]))

        Jloc = vmap(step_jac)(self._si, self._sip1, Wm, Y, sc_steps)
        Db = d.n + d.bw + d.iw + d.q
        Jfp, Jbc = self._border_jacobians(Wm, tail, v, sc_fp, sc_bc, z)
        return dict(
            Hloc=z.new_zeros((d.N, D, D)),
            Jloc=Jloc,
            Hb=z.new_zeros((Db, Db)),
            Jfp=Jfp,
            Jbc=Jbc,
        )

    def diag_scale(self, data):
        return 1.0 + torch.amax(torch.abs(torch.diagonal(data["Hloc"], dim1=-2, dim2=-1)))

    def gauss_newton_data(self, data):
        """Zero-Hessian view of prepared data (same scaled Jacobians) — the
        Gauss-Newton system of the restoration step."""
        return dict(
            Hloc=torch.zeros_like(data["Hloc"]),
            Jloc=data["Jloc"],
            Hb=torch.zeros_like(data["Hb"]),
            Jfp=data["Jfp"],
            Jbc=data["Jbc"],
        )

    def lsq_lambda(self, z, g, sf, sc, Drow=None):
        """Least-squares multiplier init on the structured path: solving the
        block system [I J~^T; J~ -(D + eps) I][dz; lam] = [-g; 0] yields
        lam = -(J~ J~^T + D + eps)^-1 J~ g, via the instance's own algorithm
        and precision. The identity Hessian enters through sigma_z = 1."""
        nz, nc = self.docp.nz, self.docp.nc
        data = self.prepare_jac_only(z, sc)
        blocks = self._assemble(
            data,
            z.new_ones((nz,)),  # sigma_z = 1 -> unit Hessian block
            z.new_zeros((nc,)) if Drow is None else Drow,
            0.0,
            1e-8,  # eps regularization on the J J^T block
            g,
            z.new_zeros((nc,)),
        )
        X, xb = self._block_solve(*blocks)
        _, lam = self._unscatter(X, xb)
        return lam

    # ------------------------------------------------------------------
    # assembly + solve
    # ------------------------------------------------------------------
    def _block_solve(self, A, B, E, F, r, rb):
        """One block solve, in solve_dtype when set; the result comes back in
        r's dtype."""
        self.block_solves += 1
        blocks = (A, B, E, F, r, rb)
        if self.solve_dtype is not None:
            blocks = tuple(b.to(self.solve_dtype) for b in blocks)
        if self.algorithm == "cr":
            X, xb = cr_solve(*blocks)
        else:
            X, xb = scan_solve(*blocks)
        return X.to(r.dtype), xb.to(r.dtype)

    def solve(self, data, sigma_z, Drow, delta_w, delta_c, rz, rp):
        out_dtype = rz.dtype
        if self.assemble_dtype is not None:
            sigma_z, Drow, delta_w, delta_c, rz, rp = (
                _cast(a, self.assemble_dtype) for a in (sigma_z, Drow, delta_w, delta_c, rz, rp)
            )
        A, B, E, F, r, rb = self._assemble(data, sigma_z, Drow, delta_w, delta_c, rz, rp)
        if self.equilibrate:
            # two symmetric Ruiz passes: one leaves the cross-coupled rows
            # unbalanced; the solution is unscaled at the end (x = D x')
            d_step, d_b = _ruiz_scales(A, B, E, F)
            A, B, E, F, r, rb = _apply_scales(A, B, E, F, r, rb, d_step, d_b)
            d2_step, d2_b = _ruiz_scales(A, B, E, F)
            A, B, E, F, r, rb = _apply_scales(A, B, E, F, r, rb, d2_step, d2_b)
            d_step, d_b = d_step * d2_step, d_b * d2_b
        if self.solve_dtype is None or self.refine == 0:
            X, xb = self._block_solve(A, B, E, F, r, rb)
        else:
            # refinement from zero: pass 0 is the base solve (the residual of
            # x = 0 is r); a fixed count, so no data-dependent branch under vmap
            X, xb = torch.zeros_like(r), torch.zeros_like(rb)
            for _ in range(1 + self.refine):
                y, yb = _block_matvec(A, B, E, F, X, xb)
                dX, dxb = self._block_solve(A, B, E, F, r - y, rb - yb)
                X, xb = X + dX, xb + dxb
        if self.equilibrate:
            X, xb = X * d_step, xb * d_b
        return self._unscatter(X.to(out_dtype), xb.to(out_dtype))

    def _assemble(self, data, sigma_z, Drow, delta_w, delta_c, rz, rp):
        """Build (A, B, E, F, r, rb) block-tridiagonal + border data."""
        d = self.d
        Hloc, Jloc = data["Hloc"], data["Jloc"]
        Hb, Jfp, Jbc = data["Hb"], data["Jfp"], data["Jbc"]
        N, n, bw, cw, iw, q, bs, wb = d.N, d.n, d.bw, d.cw, d.iw, d.q, d.bs, d.wb

        # index ranges inside the per-step D-dim: [w | y | v]
        y0, y1 = bw, bw + iw
        v0, v1 = bw + iw, bw + iw + q
        # border block col layout: [tail | v | lam_fp | lam_bc]
        vb0 = iw
        fp0 = iw + q
        bc0 = fp0 + d.npath
        # border-hessian arg layout: [x0 | wN | tail | v]
        bw0, bw1 = n, n + bw
        bt0, bt1 = n + bw, n + bw + iw
        bv0, bv1 = n + bw + iw, n + bw + iw + q

        sig_steps = sigma_z[: N * bw].reshape(N, bw)
        sig_tail = sigma_z[N * bw : N * bw + iw]
        sig_v = sigma_z[N * bw + iw :]
        D_steps, D_fp, D_bc = self._split_lam(Drow)
        rz_steps = rz[: N * bw].reshape(N, bw)
        rz_tail = rz[N * bw : N * bw + iw]
        rz_v = rz[N * bw + iw :]
        rp_steps, rp_fp, rp_bc = self._split_lam(rp)
        like = rz

        # ---- A blocks ----
        Hww = Hloc[:, :bw, :bw]
        # interface-interface of the PREVIOUS step lands in the first iw of w_i
        Hyy_prev = _sum_placed((N, bw, bw), [(Hloc[:-1, y0:y1, y0:y1], (1, 0, 0))], like)
        # border (x0,x0) into A_0; (wN,wN) into A_{N-1}
        Hww_border = _sum_placed(
            (N, bw, bw),
            [(Hb[None, :n, :n], (0, 0, 0)), (Hb[None, bw0:bw1, bw0:bw1], (N - 1, 0, 0))],
            like,
        )
        Aw = Hww + Hyy_prev + Hww_border
        Aw = Aw + torch.diag_embed(sig_steps + delta_w)
        Jw = Jloc[:, :, :bw]  # (N, cw, bw)
        Dreg = torch.diag_embed(D_steps + delta_c)  # (N, cw, cw)
        A = torch.cat(
            [
                torch.cat([Aw, Jw.transpose(1, 2)], dim=2),
                torch.cat([Jw, -Dreg], dim=2),
            ],
            dim=1,
        )  # (N, bs, bs)

        # ---- B blocks (couple super-block i -> i+1), i = 0..N-2 ----
        if N > 1:
            Bw_ = _place(Hloc[:-1, :bw, y0:y1], (N - 1, bw, bw), (0, 0, 0))
            BJ = _place(Jloc[:-1, :, y0:y1], (N - 1, cw, bw), (0, 0, 0))
            B = _place(torch.cat([Bw_, BJ], dim=1), (N - 1, bs, bs), (0, 0, 0))
        else:
            B = like.new_zeros((0, bs, bs))

        # ---- E blocks (step -> border) ----
        E = _sum_placed(
            (N, bs, wb),
            [
                # v coupling: every step
                (Hloc[:, :bw, v0:v1], (0, 0, vb0)),
                (Hloc[:-1, y0:y1, v0:v1], (1, 0, vb0)),
                (Jloc[:, :, v0:v1], (0, bw, vb0)),
                # tail coupling: last step's (w,y) and (lam,y)
                (Hloc[N - 1 :, :bw, y0:y1], (N - 1, 0, 0)),
                (Jloc[N - 1 :, :, y0:y1], (N - 1, bw, 0)),
                # border-hessian couplings
                (Hb[None, :n, bt0:bt1], (0, 0, 0)),
                (Hb[None, :n, bv0:bv1], (0, 0, vb0)),
                (Hb[None, bw0:bw1, bt0:bt1], (N - 1, 0, 0)),
                (Hb[None, bw0:bw1, bv0:bv1], (N - 1, 0, vb0)),
                # final-path multiplier column: fp depends on wN
                (Jfp[:, :bw].T[None], (N - 1, 0, fp0)),
                # boundary multiplier column: bc depends on x0
                (Jbc[:, :n].T[None], (0, 0, bc0)),
            ],
            like,
        )

        # ---- F border block ----
        Hty = Hloc[N - 1, y0:y1, v0:v1] + Hb[bt0:bt1, bv0:bv1]
        F = _sum_placed(
            (wb, wb),
            [
                (
                    Hloc[N - 1, y0:y1, y0:y1] + Hb[bt0:bt1, bt0:bt1]
                    + torch.diag(sig_tail + delta_w),
                    (0, 0),
                ),
                (Hty, (0, vb0)),
                (Hty.T, (vb0, 0)),
                (
                    torch.sum(Hloc[:, v0:v1, v0:v1], dim=0)
                    + Hb[bv0:bv1, bv0:bv1]
                    + torch.diag(sig_v + delta_w),
                    (vb0, vb0),
                ),
                # final-path rows/cols (fp args: [wN | tail | v])
                (Jfp[:, bw : bw + iw].T, (0, fp0)),
                (Jfp[:, bw : bw + iw], (fp0, 0)),
                (Jfp[:, bw + iw :].T, (vb0, fp0)),
                (Jfp[:, bw + iw :], (fp0, vb0)),
                (-torch.diag(D_fp + delta_c), (fp0, fp0)),
                # boundary rows/cols (bc args: [x0 | tail | v])
                (Jbc[:, n : n + iw].T, (0, bc0)),
                (Jbc[:, n : n + iw], (bc0, 0)),
                (Jbc[:, n + iw :].T, (vb0, bc0)),
                (Jbc[:, n + iw :], (bc0, vb0)),
                (-torch.diag(D_bc + delta_c), (bc0, bc0)),
            ],
            like,
        )

        # ---- rhs ----
        r = -torch.cat([rz_steps, rp_steps], dim=1)  # (N, bs)
        rb = -torch.cat([rz_tail, rz_v, rp_fp, rp_bc])  # (wb,)
        return A, B, E, F, r, rb

    def _unscatter(self, X, xb):
        d = self.d
        vb0, vb1 = d.iw, d.iw + d.q
        fp1 = vb1 + d.npath
        dz = torch.cat([X[:, : d.bw].reshape(d.N * d.bw), xb[: d.iw], xb[vb0:vb1]])
        dlam = torch.cat([X[:, d.bw :].reshape(d.N * d.cw), xb[vb1:fp1], xb[fp1:]])
        return dz, dlam


def _cast(x, dtype):
    """A tensor in `dtype`; Python scalars stay as they are."""
    return x.to(dtype) if isinstance(x, torch.Tensor) else x


# ----------------------------------------------------------------------------
# Ruiz scaling, block matvec, sequential solve (on assembled block data)
# ----------------------------------------------------------------------------


def _shift_pad(x, front: bool):
    """x with a zero block added at the front (or the back) of axis 0."""
    z = torch.zeros_like(x[:1])
    return torch.cat([z, x] if front else [x, z], dim=0)


def _ruiz_scales(A, B, E, F):
    """Row-inf-norm scales for one symmetric Ruiz pass over the block
    tridiagonal + arrowhead system: (d_step (N, bs), d_b (wb,)) with
    d = rownorm^-1/2. Row i and column i get the same scale, so symmetry is
    kept. Out of place (it runs under vmap)."""
    rn = torch.amax(torch.abs(A), dim=2)  # (N, bs)
    if B.shape[0] > 0:
        absB = torch.abs(B)
        rn = torch.maximum(rn, _shift_pad(torch.amax(absB, dim=1), front=True))  # B^T rows of block i+1
        rn = torch.maximum(rn, _shift_pad(torch.amax(absB, dim=2), front=False))  # B rows of block i
    absE = torch.abs(E)
    rn = torch.maximum(rn, torch.amax(absE, dim=2))
    rb_n = torch.maximum(torch.amax(absE, dim=(0, 1)), torch.amax(torch.abs(F), dim=1))
    d_step = 1.0 / torch.sqrt(torch.clamp(rn, min=1e-30))
    d_b = 1.0 / torch.sqrt(torch.clamp(rb_n, min=1e-30))
    return d_step, d_b


def _apply_scales(A, B, E, F, r, rb, d_step, d_b):
    """K' = D K D, r' = D r for the block system (D = diag(d_step..., d_b))."""
    A = A * d_step[:, :, None] * d_step[:, None, :]
    if B.shape[0] > 0:
        B = B * d_step[:-1, :, None] * d_step[1:, None, :]
    E = E * d_step[:, :, None] * d_b[None, None, :]
    F = F * d_b[:, None] * d_b[None, :]
    return A, B, E, F, r * d_step, rb * d_b


def _block_matvec(A, B, E, F, X, xb):
    """K @ [X; xb] for the symmetric block-tridiagonal + arrowhead system:
    row i: A_i X_i + B_{i-1}^T X_{i-1} + B_i X_{i+1} + E_i xb;
    border: sum_i E_i^T X_i + F xb (the refinement residual)."""
    y = torch.einsum("nij,nj->ni", A, X)
    if B.shape[0] > 0:
        y = y + _shift_pad(torch.einsum("nji,nj->ni", B, X[:-1]), front=True)
        y = y + _shift_pad(torch.einsum("nij,nj->ni", B, X[1:]), front=False)
    y = y + torch.einsum("niw,w->ni", E, xb)
    yb = torch.einsum("nsw,ns->w", E, X) + F @ xb
    return y, yb


def _scan_solve(A, B, E, F, r, rb):
    """Sequential forward block elimination + border Schur + back substitution.
    O(N) depth; minimal flops. A:(N,bs,bs), B:(N-1,bs,bs), E:(N,bs,wb)."""
    N = A.shape[0]
    Ainvs, Etils, rtils = [gj_inverse(A[0])], [E[0]], [r[0]]
    for i in range(1, N):
        C = B[i - 1].T @ Ainvs[-1]
        Ainvs.append(gj_inverse(A[i] - C @ B[i - 1]))
        Etils.append(E[i] - C @ Etils[-1])
        rtils.append(r[i] - C @ rtils[-1])
    Ainvs = torch.stack(Ainvs)
    Etils = torch.stack(Etils)
    rtils = torch.stack(rtils)

    AinvE = torch.einsum("nij,njk->nik", Ainvs, Etils)
    Ainvr = torch.einsum("nij,nj->ni", Ainvs, rtils)
    Ftil = F - torch.einsum("nji,njk->ik", Etils, AinvE)
    rbtil = rb - torch.einsum("nji,nj->i", Etils, Ainvr)
    xb = gj_solve(Ftil, rbtil[:, None])[:, 0]

    xs = [Ainvr[N - 1] - AinvE[N - 1] @ xb]
    for i in range(N - 2, -1, -1):
        xs.append(Ainvs[i] @ (rtils[i] - B[i] @ xs[-1] - Etils[i] @ xb))
    return torch.stack(xs[::-1]), xb
