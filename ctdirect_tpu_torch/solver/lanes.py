"""Lane-minor (batch-last) small-block linear algebra + block cyclic reduction
(PyTorch port of `ctdirect_tpu.solver.lanes`).

Every tensor ends in the batch axis B; block indices live in the leading dims
and all tiny-dim contractions are unrolled into elementwise multiply-adds.
`cr_solve_lanes` is the plain PyTorch version of the hand-written CUDA kernel
`cr_kernel.cr_solve_batched` (csrc/cr_solve.cu): the CPU tests run it, and
the card-side checks hold the kernel against it.

`cr_solve` is the dispatch that replaces the JAX package's `custom_vmap`
wrapper: a `torch.autograd.Function` whose `vmap` rule moves the batch axis
last, pads the chain to a power of two and calls the batched CR — so the
batched MPC tick (`torch.func.vmap` of the single-instance tick) reaches the
kernel once per Newton step. Unbatched calls run the same batched CR at B=1.
On CPU tensors both routes run the plain version; on CUDA tensors both
launch the kernel. The dispatch itself is `lane_solve(engine, ...)`, which
also carries the time-sharded distributed CR (parallel/time_shard.py).

Shapes (lane-minor): A (P, bs, bs, B) diagonal blocks, Bp (P, bs, bs, B)
super-diagonal couplings (Bp[i]: block i -> i+1, last slot zero), E (P, bs,
wb, B) border coupling, F (wb, wb, B) border block, r (P, bs, B), rb (wb, B).
"""

from __future__ import annotations

import torch


# ----------------------------------------------------------------------------
# lane-minor primitives (trailing batch axis; tiny dims unrolled)
# ----------------------------------------------------------------------------


def bmm(X, Y):
    """(..., i, j, B) @ (..., j, k, B) -> (..., i, k, B), unrolled over j."""
    j = X.shape[-2]
    return sum(X[..., :, t, None, :] * Y[..., None, t, :, :] for t in range(j))


def bmm_tn(X, Y):
    """X^T @ Y: (..., j, i, B), (..., j, k, B) -> (..., i, k, B)."""
    j = X.shape[-3]
    return sum(X[..., t, :, None, :] * Y[..., t, None, :, :] for t in range(j))


def bmv(X, y):
    """(..., i, j, B) @ (..., j, B) -> (..., i, B)."""
    j = X.shape[-2]
    return sum(X[..., :, t, :] * y[..., None, t, :] for t in range(j))


def bmv_tn(X, y):
    """X^T @ y: (..., j, i, B), (..., j, B) -> (..., i, B)."""
    j = X.shape[-3]
    return sum(X[..., t, :, :] * y[..., t, None, :] for t in range(j))


def _gj_eliminate_lanes(M, n):
    """Gauss-Jordan on augmented (..., n, n + k, B), unrolled over the n
    columns, with per-lane partial pivoting: the pivot row (first row of
    maximal |value| at or below the diagonal) is chosen independently for
    every lane via argmax + one-hot selects."""
    rows = torch.arange(n, device=M.device)
    rsel = rows.reshape((1,) * (M.ndim - 3) + (n, 1))  # (..., n, 1)
    for j in range(n):
        is_j = (rsel == j)[..., None]  # (..., n, 1, 1)
        colj = torch.where(rsel >= j, torch.abs(M[..., :, j, :]), -torch.inf)
        p = torch.argmax(colj, dim=-2)  # (..., B)
        oh = (p[..., None, :] == rsel).to(M.dtype)  # (..., n, B)
        rowp = (oh[..., :, None, :] * M).sum(dim=-3)  # pivot row (..., c, B)
        rowj = M[..., j, :, :]
        # swap rows j and p lane-wise: row p receives row j, row j receives row p
        M = M + oh[..., :, None, :] * (rowj[..., None, :, :] - rowp[..., None, :, :])
        M = torch.where(is_j, rowp[..., None, :, :], M)
        piv = M[..., j, j, :]
        row = M[..., j, :, :] / piv[..., None, :]
        colv = torch.where(rsel == j, 0.0, M[..., :, j, :])
        M = M - colv[..., :, None, :] * row[..., None, :, :]
        M = torch.where(is_j, row[..., None, :, :], M)
    return M


def gj_inverse_lanes(A):
    """Gauss-Jordan inverse, lane-minor. A: (..., n, n, B)."""
    n = A.shape[-2]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)[..., None]
    M = torch.cat([A, eye.expand(A.shape)], dim=-2)
    return _gj_eliminate_lanes(M, n)[..., :, n:, :]


def gj_solve_lanes(A, B_):
    """Solve A X = B lane-minor. A: (..., n, n, B), B: (..., n, k, B)."""
    n = A.shape[-2]
    M = torch.cat([A, B_], dim=-2)
    return _gj_eliminate_lanes(M, n)[..., :, n:, :]


def _add_shifted(X, Y):
    """X[1:] += Y[:-1] along the block axis, out of place."""
    return torch.cat([X[:1], X[1:] + Y[:-1]], dim=0)


# ----------------------------------------------------------------------------
# lane-minor block cyclic reduction + arrowhead border (plain version)
# ----------------------------------------------------------------------------


def cr_solve_lanes(A, Bp, E, F, r, rb):
    """Block cyclic reduction + border Schur, lane-minor layout (see module
    docstring for shapes). P = A.shape[0] must be a power of two (caller pads).
    Returns X (P, bs, B), xb (wb, B)."""
    P, bs, _, B = A.shape

    levels = []
    M = P
    while M > 1:
        Ae, Ao = A[0::2], A[1::2]
        Bl = Bp[0::2]  # even_j -> odd_j
        Br = Bp[1::2]  # odd_j -> even_{j+1} (last slot zero)
        Eo, ro = E[1::2], r[1::2]
        Ainv_o = gj_inverse_lanes(Ao)

        CL = bmm(Bl, Ainv_o)  # (M/2, bs, bs, B)
        CR = bmm_tn(Br, Ainv_o)  # B_r^T A_o^{-1}

        # A'[even_j] -= CL @ Bl^T ; A'[even_{j+1}] -= CR @ Br
        A_new = _add_shifted(Ae - bmm(CL, Bl.transpose(-3, -2)), -bmm(CR, Br))
        E_new = _add_shifted(E[0::2] - bmm(CL, Eo), -bmm(CR, Eo))
        r_new = _add_shifted(r[0::2] - bmv(CL, ro), -bmv(CR, ro))
        B_new = -bmm(CL, Br)
        B_new = torch.cat([B_new[:-1], torch.zeros_like(B_new[-1:])], dim=0)

        AiE = bmm(Ainv_o, Eo)  # (M/2, bs, wb, B)
        F = F - torch.einsum("msvb,mswb->vwb", Eo, AiE)
        rb = rb - torch.einsum("msvb,msb->vb", Eo, bmv(Ainv_o, ro))

        levels.append((Ainv_o, Bl, Br, Eo, ro))
        A, Bp, E, r = A_new, B_new, E_new, r_new
        M //= 2

    # root: [[A0, E0], [E0^T, F]] [x0; xb] = [r0; rb]
    top = torch.cat([A[0], E[0]], dim=-2)  # (bs, bs+wb, B)
    bot = torch.cat([E[0].transpose(-3, -2), F], dim=-2)
    root = torch.cat([top, bot], dim=-3)  # (bs+wb, bs+wb, B)
    rhs = torch.cat([r[0], rb], dim=-2)[..., :, None, :]
    sol = gj_solve_lanes(root, rhs)[..., :, 0, :]  # (bs+wb, B)
    X = sol[:bs][None]  # (1, bs, B)
    xb = sol[bs:]  # (wb, B)

    for Ainv_o, Bl, Br, Eo, ro in reversed(levels):
        m = Ainv_o.shape[0]
        x_e = X  # (m, bs, B)
        x_e_next = torch.cat([x_e[1:], torch.zeros_like(x_e[:1])], dim=0)
        rhs = (
            ro
            - bmv_tn(Bl, x_e)
            - bmv(Br, x_e_next)
            - bmv(Eo, xb.expand(m, *xb.shape))
        )
        x_o = bmv(Ainv_o, rhs)
        X = torch.stack([x_e, x_o], dim=1).reshape(2 * m, bs, B)

    return X, xb


def _pad_pow2_lanes(A, B_, E, r, P=None):
    """Pad to P blocks (default: the next power of two), lane-minor layout:
    A (N, bs, bs, B) etc. Padding is identity A, zero couplings/rhs; Bp gets
    its zero last slot."""
    N, bs, _, B = A.shape
    if P is None:
        P = 1
        while P < N:
            P *= 2
    pad = P - N
    if pad:
        eye = torch.eye(bs, dtype=A.dtype, device=A.device)[..., None]
        A = torch.cat([A, eye.expand(pad, bs, bs, B)], dim=0)
        E = torch.cat([E, E.new_zeros((pad,) + E.shape[1:])], dim=0)
        r = torch.cat([r, r.new_zeros((pad,) + r.shape[1:])], dim=0)
    Bp = torch.cat([B_, B_.new_zeros((P - B_.shape[0],) + B_.shape[1:])], dim=0)
    return A, Bp, E, r


# ----------------------------------------------------------------------------
# dispatch (the counterpart of the JAX package's custom_vmap wrapper)
# ----------------------------------------------------------------------------


def _cr_chain_lanes(A, B_, E, F, r, rb):
    """Batched CR of a lane-minor chain of any length N: pad to a power of
    two, run the batched CR (the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors), drop the padding."""
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched

    N = A.shape[0]
    Ax, Bx, Ex, rx = _pad_pow2_lanes(A, B_, E, r)
    X, xb = cr_solve_batched(
        *(x.contiguous() for x in (Ax, Bx, Ex, F, rx, rb))
    )
    return X[:N], xb


class _LaneSolve(torch.autograd.Function):
    """The vmap-aware call of a lane-minor chain solver `engine` (a
    non-tensor input): unbatched, the engine at B=1; under vmap, the rule
    moves each operand's batch axis last and calls the engine once for the
    whole batch."""

    generate_vmap_rule = False

    @staticmethod
    def forward(A, B_, E, F, r, rb, engine):
        X, xb = engine(*(x[..., None] for x in (A, B_, E, F, r, rb)))
        return X[..., 0], xb[..., 0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, A, B_, E, F, r, rb, engine):
        # move each batched operand's batch axis LAST; broadcast the others
        def lanes(x, d):
            if d is None:
                return x[..., None].expand(*x.shape, info.batch_size)
            return x.movedim(d, -1)

        args = [lanes(x, d) for x, d in zip((A, B_, E, F, r, rb), in_dims)]
        X, xb = engine(*args)
        return (X.movedim(-1, 0), xb.movedim(-1, 0)), (0, 0)


def lane_solve(engine, A, B_, E, F, r, rb):
    """Solve one block chain (shapes as `cr_solve`) with `engine`, a solver
    of lane-minor chains of any length N (engine(A, B_, E, F, r, rb) with a
    trailing batch axis -> (X, xb)). Under `torch.func.vmap` the engine sees
    the whole batch at once and never a batched tensor."""
    return _LaneSolve.apply(A, B_, E, F, r, rb, engine)


def cr_solve(A, B_, E, F, r, rb):
    """Block-tridiagonal + arrowhead solve via cyclic reduction.

    Single instance: A (N, bs, bs), B_ (N-1, bs, bs), E (N, bs, wb),
    F (wb, wb), r (N, bs), rb (wb) -> (X (N, bs), xb (wb)). Under
    `torch.func.vmap` the whole batch goes to one batched CR call (the same
    math as the JAX package's chain-in-lanes CR at B=1 when unbatched)."""
    return lane_solve(_cr_chain_lanes, A, B_, E, F, r, rb)
