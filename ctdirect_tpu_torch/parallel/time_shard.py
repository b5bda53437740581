"""Time-axis-sharded block-tridiagonal solve: distributed cyclic reduction
(PyTorch port of `ctdirect_tpu.parallel.time_shard`, on torch.distributed).

The collocation KKT chain (one super-block per time step) is split over the
ranks of one axis of a `DeviceMesh`. Execution is SPMD, one process per rank
(parallel/spmd.py launches such worlds): every rank runs the same code on its
own blocks. Each cyclic-reduction level does the local block algebra of
`lanes.cr_solve_lanes` and ONE halo exchange with a neighbouring rank (a
point-to-point send and receive, the counterpart of `jax.lax.ppermute`). The
border (arrowhead) Schur deltas of all local levels are summed once
(`all_reduce`, for `psum`); the D blocks left are gathered on every rank
(`all_gather`) and reduced to the root there, redundantly; the
back-substitution retraces the local levels with the reverse halos.

Layout: lane-minor as in solver/lanes.py, a trailing batch axis B: A and Bp
(L, bs, bs, B), E (L, bs, wb, B), r (L, bs, B) hold a rank's L blocks; F
(wb, wb, B) and rb (wb, B) are replicated. So under `torch.func.vmap` (the
batched MPC tick) the whole batch's halo goes out as one message per level.
The chain is padded to P = 2^k >= max(N, D) blocks (identity blocks), D the
axis size, which must be a power of two; rank i holds blocks [i L, (i+1) L),
L = P / D.

Transport (`ShardAxis`): a gloo group carries CPU tensors; an NCCL group
CUDA tensors; a gloo group given CUDA tensors (several ranks sharing one
card, which NCCL refuses) stages every message through the host and counts
it in `staged_messages`. Anything else raises; nothing falls back.

Compiled form: over NCCL the distributed CR, the 2-D tick that calls it
(parallel/mpc.py) and the time-sharded solve (`TimeShardedKKT` in
solver/interface.py::DOCPSolver) run as CUDA graphs with their sends,
receives, all_reduce and all_gathers captured inside, the counterpart of the
JAX package's shard_map under jit. Every rank of an axis captures and
replays the same graphs in the same order; the gathered blocks, the summed
border terms and so the root are the same bytes on every rank, so ranks
that read the same flags stay in lockstep. Over gloo the paths stay eager."""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist

from ctdirect_tpu_torch.parallel.spmd import check_backend, local_world_size
from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched
from ctdirect_tpu_torch.solver.graph import KERNEL_COUNTERS, CallGraph, signature
from ctdirect_tpu_torch.solver.lanes import (
    _add_shifted,
    _pad_pow2_lanes,
    bmm,
    bmm_tn,
    bmv,
    bmv_tn,
    gj_inverse_lanes,
    lane_solve,
)


def _staged(backend: str, x: torch.Tensor) -> bool:
    """Whether a message of `x` on a `backend` group goes through the host
    (gloo with a CUDA tensor); raises for a pairing no backend carries."""
    check_backend(backend, x.device.type, 1)
    return backend == "gloo" and x.device.type != "cpu"


def _pack(*xs):
    """One flat message of several tensors of one dtype."""
    return torch.cat([x.reshape(-1) for x in xs])


def _unpack(flat, likes, lead=()):
    """The tensors shaped like `likes` back out of a flat message packed
    from them; with `lead` (e.g. (D,) after a gather of D such messages)
    each gets those dims in front."""
    flat = flat.reshape(math.prod(lead), -1)
    sizes = [x.numel() for x in likes]
    return [part.reshape(*lead, *x.shape) for part, x in zip(flat.split(sizes, dim=1), likes)]


class ShardAxis:
    """One named axis of a DeviceMesh as this rank sees it: its process
    group, the rank in it, its size and backend, and the collectives the
    distributed CR needs (`halo_from_left`, `halo_from_right`, `psum`,
    `all_gather`), and `pmax`. `messages` counts this rank's point-to-point sends and
    receives and its collective calls; `staged_messages` those of them that
    went through the host. `capturable` says whether its messages can sit
    in a CUDA graph (NCCL)."""

    def __init__(self, mesh, name: str):
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        if name not in names:
            raise ValueError(f"the mesh has no axis {name!r} (its axes: {names})")
        self.name = name
        self.group = mesh.get_group(name)
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)
        self.backend = str(dist.get_backend(self.group))
        device_type = "cuda" if self.backend == "nccl" else "cpu"
        check_backend(self.backend, device_type, local_world_size())
        self._peers = [dist.get_global_rank(self.group, i) for i in range(self.size)]
        self.capturable = self.backend == "nccl"
        self.messages = 0
        self.staged_messages = 0

    def _count(self, x) -> bool:
        staged = _staged(self.backend, x)
        self.messages += 1
        self.staged_messages += int(staged)
        return staged

    def _shift(self, x, to_right: bool):
        """Send x to the next rank (to_right) or the previous one and receive
        the other neighbour's x; the edge rank without a sender gets zeros
        (on an axis of one rank, with no message at all)."""
        src = self.rank - 1 if to_right else self.rank + 1
        dst = self.rank + 1 if to_right else self.rank - 1
        ops, recv, staged = [], None, False
        if 0 <= dst < self.size:
            buf = x.cpu() if self._count(x) else x.contiguous()
            ops.append(dist.P2POp(dist.isend, buf, self._peers[dst], self.group))
        if 0 <= src < self.size:
            staged = self._count(x)
            recv = torch.empty(x.shape, dtype=x.dtype, device="cpu" if staged else x.device)
            ops.append(dist.P2POp(dist.irecv, recv, self._peers[src], self.group))
        if not ops:
            return torch.zeros_like(x)
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if recv is None:
            return torch.zeros_like(x)
        return recv.to(x.device) if staged else recv

    def halo_from_left(self, x):
        """The left neighbour's x (a rank sends the last block of its shard);
        rank 0 receives zeros."""
        return self._shift(x, to_right=True)

    def halo_from_right(self, x):
        """The right neighbour's x (a rank sends the first block of its
        shard); the last rank receives zeros."""
        return self._shift(x, to_right=False)

    def psum(self, x):
        """Sum of x over the axis, on every rank."""
        buf = x.cpu() if self._count(x) else x.clone()
        dist.all_reduce(buf, group=self.group)
        return buf.to(x.device)

    def pmax(self, x):
        """Max of x over the axis, on every rank."""
        buf = x.cpu() if self._count(x) else x.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=self.group)
        return buf.to(x.device)

    def all_gather(self, x):
        """The ranks' x concatenated along dim 0 in rank order, on every rank
        (`all_gather(tiled=True)`)."""
        buf = x.cpu() if self._count(x) else x.contiguous()
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        return torch.cat(parts).to(x.device)


def padded_len(N: int, D: int) -> int:
    """P = the power of two >= max(N, D) a chain of N blocks is padded to
    over an axis of D ranks; D must be a power of two (ValueError)."""
    if D < 1 or D & (D - 1):
        raise ValueError(f"the time axis must have a power-of-two size, not {D}")
    P = 1
    while P < max(N, D):
        P *= 2
    return P


def _cr_local_level(A, Bp, E, r, axis: ShardAxis):
    """One cyclic-reduction level over the sharded block axis, lane-minor.

    A/E/r hold this rank's L blocks (L even), Bp[i] couples global block i
    to i+1 (the last rank's final slot is zero). Returns the halved arrays
    (still sharded), this rank's border-Schur DELTAS (summed over the axis
    later) and the level's back-substitution data. One halo: the last odd
    block's contribution to the right neighbour's first even block."""
    Ae, Ao = A[0::2], A[1::2]
    Bl = Bp[0::2]  # even_j -> odd_j (both local: L is even)
    Br = Bp[1::2]  # odd_j -> even_{j+1}; the last one's even is on the next rank
    Eo, ro = E[1::2], r[1::2]
    Ainv_o = gj_inverse_lanes(Ao)
    CL = bmm(Bl, Ainv_o)
    CR = bmm_tn(Br, Ainv_o)
    cA, cE, cr = bmm(CR, Br), bmm(CR, Eo), bmv(CR, ro)
    hA, hE, hr = _unpack(axis.halo_from_left(_pack(cA[-1], cE[-1], cr[-1])), (cA[-1], cE[-1], cr[-1]), (1,))
    A_new = _add_shifted(Ae - bmm(CL, Bl.transpose(-3, -2)), -cA)
    E_new = _add_shifted(E[0::2] - bmm(CL, Eo), -cE)
    r_new = _add_shifted(r[0::2] - bmv(CL, ro), -cr)
    A_new = torch.cat([A_new[:1] - hA, A_new[1:]])
    E_new = torch.cat([E_new[:1] - hE, E_new[1:]])
    r_new = torch.cat([r_new[:1] - hr, r_new[1:]])
    B_new = -bmm(CL, Br)  # even_j -> even_{j+1}
    dF = -torch.einsum("msvb,mswb->vwb", Eo, bmm(Ainv_o, Eo))
    drb = -torch.einsum("msvb,msb->vb", Eo, bmv(Ainv_o, ro))
    return A_new, B_new, E_new, r_new, dF, drb, (Ainv_o, Bl, Br, Eo, ro)


def _cr_local_back(level, X, xb, axis: ShardAxis):
    """Back-substitute one level: X are this rank's even solutions; the last
    odd block needs the right neighbour's first even one (one halo)."""
    Ainv_o, Bl, Br, Eo, ro = level
    m = X.shape[0]
    x_next = torch.cat([X[1:], axis.halo_from_right(X[:1])])
    rhs = ro - bmv_tn(Bl, X) - bmv(Br, x_next) - bmv(Eo, xb.expand(m, *xb.shape))
    x_o = bmv(Ainv_o, rhs)
    return torch.stack([X, x_o], dim=1).reshape(2 * m, *X.shape[1:])


def dcr_solve(A, Bp, E, r, F, rb, axis: ShardAxis, local_len: int, n_dev: int):
    """Distributed cyclic reduction on every rank of `axis` (SPMD).

    A/Bp/E/r: this rank's (local_len, ...) blocks, lane-minor; Bp's last
    global slot is zero; F/rb replicated. Returns this rank's X (local_len,
    bs, B) and the replicated xb (wb, B)."""
    if axis.size != n_dev or A.shape[0] != local_len:
        raise ValueError(f"dcr_solve: {A.shape[0]} local blocks on an axis of {axis.size}, "
                         f"want {local_len} on {n_dev}")
    # phase 1: reduce to one block per rank; the border-Schur deltas add up
    # locally and are summed over the axis once
    levels, L = [], local_len
    dF_acc, drb_acc = torch.zeros_like(F), torch.zeros_like(rb)
    while L > 1:
        A, Bp, E, r, dF, drb, level = _cr_local_level(A, Bp, E, r, axis)
        dF_acc, drb_acc = dF_acc + dF, drb_acc + drb
        levels.append(level)
        L //= 2
    dF_sum, drb_sum = _unpack(axis.psum(_pack(dF_acc, drb_acc)), (dF_acc, drb_acc))

    # phase 2: gather the D blocks left and reduce them to the root on every
    # rank (D is small; every rank keeps its back-substitution data local):
    # the CR kernel on a card, its plain version on the CPU
    blocks = (A, Bp, E, r)
    Ag, Bg, Eg, rg = _unpack(axis.all_gather(_pack(*blocks)), [x[0] for x in blocks], (n_dev,))
    root = (Ag, Bg, Eg, F + dF_sum, rg, rb + drb_sum)
    Xg, xb = cr_solve_batched(*(x.contiguous() for x in root))
    X = Xg[axis.rank : axis.rank + 1]

    # phase 3: local back-substitution down the rank's levels
    for level in reversed(levels):
        X = _cr_local_back(level, X, xb, axis)
    return X, xb


def _sharded_chain_lanes(axis: ShardAxis, A, B_, E, F, r, rb):
    """The distributed CR of a replicated lane-minor chain of N blocks (B_
    has N-1 couplings): pad, take this rank's blocks, solve, gather X.
    Returns the full X (N, bs, B) and xb (wb, B) on every rank."""
    N = A.shape[0]
    P = padded_len(N, axis.size)
    L = P // axis.size
    A, Bp, E, r = _pad_pow2_lanes(A, B_, E, r, P)
    mine = slice(axis.rank * L, (axis.rank + 1) * L)
    X, xb = dcr_solve(A[mine], Bp[mine], E[mine], r[mine], F, rb, axis, L, axis.size)
    return axis.all_gather(X)[:N], xb


def make_sharded_tridiag_solver(mesh, axis: str, N: int, bs: int, wb: int):
    """solve(A, B, E, F, r, rb) -> (X, xb) running the distributed CR over
    `axis` of `mesh` on every rank. Inputs are the whole chain, lane-minor
    (A (N, bs, bs, B), B (N-1, bs, bs, B), E (N, bs, wb, B), F (wb, wb, B),
    r (N, bs, B), rb (wb, B)), the same on every rank of the axis; so are
    the outputs X (N, bs, B) and xb (wb, B). The chain is padded to a power
    of two >= max(N, D); `solve.axis` is the ShardAxis (its counters).

    Over NCCL with CUDA tensors a call replays a CUDA graph (`CallGraph`)
    captured at the first call of each input signature (warm-up, then
    capture, as the JAX package jits its shard_map'd solve), its messages
    and the CR kernel's root solve inside; `solve.graphs` holds them and a
    replay adds to the axis's and the kernel's counters what its capture
    added. Every rank of the axis must make the same calls. `solve.eager`
    runs the solve op by op on any device (the form over gloo and on the
    CPU); a capture or replay that fails raises."""
    ax = ShardAxis(mesh, axis)
    padded_len(N, ax.size)
    counters = [*KERNEL_COUNTERS, (ax, "messages"), (ax, "staged_messages")]
    graphs = {}

    def eager(A, B, E, F, r, rb):
        if tuple(A.shape[:3]) != (N, bs, bs) or tuple(E.shape[1:3]) != (bs, wb):
            raise ValueError(f"chain of shape A {tuple(A.shape)}, E {tuple(E.shape)}; "
                             f"this solver takes N={N}, bs={bs}, wb={wb}")
        return _sharded_chain_lanes(ax, A, B, E, F, r, rb)

    def solve(A, B, E, F, r, rb):
        args = (A, B, E, F, r, rb)
        if not (ax.capturable and A.device.type == "cuda"):
            return eager(*args)
        key = signature(args)
        if key not in graphs:
            graphs[key] = CallGraph(eager, args, counters)
        return graphs[key].replay(args)

    solve.axis, solve.eager, solve.graphs = ax, eager, graphs
    return solve


class _ShardedSolveKKT:
    """A StructuredKKT (`inner`) whose block solve runs the distributed CR
    over `axis`; assembly, preparation and the LSQ multiplier solve run
    locally (replicated over the axis). As in the JAX package, the sharded
    solve ignores the inner operator's refinement and Ruiz scaling.
    `block_solves` counts the block solves as StructuredKKT does: the
    distributed ones and the inner operator's local ones (lsq_lambda).
    `counters` are the plain ints a solve with it moves (its block solves,
    the inner operator's, the axis's messages), which a graph's replay adds
    to (solver/graph.py::graph_counters)."""

    def __init__(self, inner, axis: ShardAxis):
        self.inner = inner
        self.axis = axis
        self.block_solves = 0
        self.counters = [(self, "block_solves"), (inner, "block_solves"), (axis, "messages"),
                         (axis, "staged_messages")]

    def row_norms(self, z):
        return self.inner.row_norms(z)

    def prepare(self, z, lam, sf, sc):
        return self.inner.prepare(z, lam, sf, sc)

    def diag_scale(self, data):
        return self.inner.diag_scale(data)

    def gauss_newton_data(self, data):
        return self.inner.gauss_newton_data(data)

    def lsq_lambda(self, z, g, sf, sc, Drow=None):
        # the LSQ init/refresh solve is small next to the IPM iterations: it
        # runs through the local (unsharded) block elimination
        before = self.inner.block_solves
        lam = self.inner.lsq_lambda(z, g, sf, sc, Drow)
        self.block_solves += self.inner.block_solves - before
        return lam

    def solve(self, data, sigma_z, Drow, delta_w, delta_c, rz, rp):
        blocks = self.inner._assemble(data, sigma_z, Drow, delta_w, delta_c, rz, rp)
        sdt = self.inner.solve_dtype
        if sdt is not None:
            blocks = tuple(x.to(sdt) for x in blocks)
        self.block_solves += 1
        # under the tick's vmap the whole batch goes through one distributed
        # solve, and the collectives never see a batched tensor
        X, xb = lane_solve(functools.partial(_sharded_chain_lanes, self.axis), *blocks)
        return self.inner._unscatter(X.to(rz.dtype), xb.to(rz.dtype))


class InsideTimeShardKKT(_ShardedSolveKKT):
    """StructuredKKT variant for the 2-D batch x time MPC tick
    (parallel/mpc.py): block assembly runs replicated over the time axis,
    each rank takes its shard of the chain, the solve is the distributed CR
    over `axis` (a ShardAxis), and one all_gather rebuilds the full step for
    the replicated update. Under the tick's vmap the whole batch goes
    through one distributed solve. solve_dtype (e.g. torch.float32) runs the
    block solve in that dtype. Refinement and Ruiz scaling are ignored and
    lsq_lambda runs locally, unsharded, as in the JAX package."""

    def __init__(self, docp, axis: ShardAxis, n_dev: int, solve_dtype=None):
        from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT

        padded_len(docp.N, n_dev)
        if axis.size != n_dev:
            raise ValueError(f"n_dev={n_dev}, but axis {axis.name!r} has {axis.size} ranks")
        super().__init__(StructuredKKT(docp, solve_dtype=solve_dtype), axis)


class TimeShardedKKT(_ShardedSolveKKT):
    """KKT operator running block assembly locally and the block solve
    distributed over the `axis` of `mesh` (every rank runs the same IPM;
    the distributed CR hands every rank the full step). Wraps a
    StructuredKKT; refinement and Ruiz scaling are ignored and lsq_lambda
    runs locally, unsharded, as in the JAX package."""

    def __init__(self, docp, mesh, axis: str = "time"):
        from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT

        ax = ShardAxis(mesh, axis)
        padded_len(docp.N, ax.size)
        super().__init__(StructuredKKT(docp), ax)
