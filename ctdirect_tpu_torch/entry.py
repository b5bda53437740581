"""Entry points of the PyTorch port: a batched solve step and a multi-rank
dry run (the counterpart of the repo's `__graft_entry__.py`).

entry(device=...) -> (fn, example_args): a batched whole-IPM solve step on
the flagship problem (double-integrator min-energy, trapezoidal collocation),
the configuration behind the headline benchmark (BASELINE.json).

dryrun_multichip(n_devices, device=..., backend=...) spawns a world of
n_devices ranks (parallel/spmd.py) and runs five sharded legs on it:
  1. a batch-sharded BatchSolver (data-parallel whole-IPM solves);
  2. the full IPM with the time-sharded KKT operator (distributed cyclic
     reduction: halo sends and receives, a border all_reduce, an all_gather)
     through `DOCPSolver(..., kkt=TimeShardedKKT)`, held to its eager form
     (`ipm_solve(kkt=TimeShardedKKT)`: same status, objective to 1e-8);
  3. the RTI MPC tick with the batch axis sharded and kkt_algorithm="cr";
  4. a batch-sharded BatchSolver with per-instance variable boxes (zl/zu);
  5. the 2-D (batch = D/2, time = 2) MPC tick: instances over the batch
     axis, each instance's KKT chain over the time axis, held to the eager
     tick (`MPCController.eager`) within 1e-13.
Over NCCL on cards, legs 2 and 5 are compiled (CUDA graphs with their
messages inside); over gloo they run eagerly, and leg 2 solves once.
It prints one line per leg and returns the legs' results.

    python -m ctdirect_tpu_torch.entry --nproc 4 --device cpu
    python -m ctdirect_tpu_torch.entry --nproc 4 --device cuda --backend nccl   # four cards
    python -m ctdirect_tpu_torch.entry --nproc 4 --device cuda --backend gloo   # one card, 4 ranks
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

# the legs' tick KKT limit (PERF.md section 2)
TICK_KKT_MAX = 1e-10
# a compiled leg against its eager form: the tick's outputs (bitwise
# expected), the time-sharded solve's objective (relative; PERF.md section 2)
GRAPH_TOL = 1e-13
SOLVE_RTOL = 1e-8


def _flagship(grid_size=20, max_iter=8, *, device):
    from ctdirect_tpu_torch import transcribe
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.ipm import IPMOptions, make_spec

    prob = get_problem("double_integrator_minenergy")
    docp = transcribe(prob.ocp, grid_size=grid_size, scheme="trapeze", device=device)
    spec = make_spec(docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
    opts = IPMOptions(tol=1e-6, max_iter=max_iter, lsq_lambda_init=False)
    return docp, spec, opts


def entry(*, device):
    """(fn, (z0, cl, cu)): fn(z0_batch, cl_batch, cu_batch) -> (z, objective,
    status) of a batched IPM solve of B=4 flagship instances on `device`."""
    from ctdirect_tpu_torch.solver.ipm import ipm_solve_batched

    docp, spec, opts = _flagship(device=device)

    def fn(z0_batch, cl_batch, cu_batch):
        B = z0_batch.shape[0]
        zl = docp.tensor(docp._z_lb).expand(B, -1)
        zu = docp.tensor(docp._z_ub).expand(B, -1)
        res = ipm_solve_batched(docp.nlp_objective, docp.constraints, spec, z0_batch, zl, zu,
                                cl_batch, cu_batch, options=opts, device=docp.device, dtype=docp.dtype)
        return res.z, res.objective, res.status

    B = 4
    z0 = docp.tensor(np.tile(docp.initial_guess(None), (B, 1)))
    cl = docp.tensor(np.tile(docp._c_lb, (B, 1)))
    cu = docp.tensor(np.tile(docp._c_ub, (B, 1)))
    return fn, (z0, cl, cu)


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _form(leg, what):
    """How a leg ran on rank 0: its graphs, or eagerly."""
    return f"{leg['captures']} {what} on rank 0" if leg["graphed"] else "eager"


def _dryrun_rank(world):
    """The five legs on one rank; returns this rank's numbers per leg."""
    from ctdirect_tpu_torch.parallel import BatchSolver, MPCController, TimeShardedKKT, broadcast_state
    from ctdirect_tpu_torch.solver.interface import DOCPSolver
    from ctdirect_tpu_torch.solver.ipm import IPMOptions

    n, dev = world.size, world.device
    out = {}

    # 1. batch-parallel solve: the global batch in, the global result out
    mesh_b = world.mesh((n,), ("batch",))
    docp, spec, opts = _flagship(grid_size=10, max_iter=3, device=dev)
    solver = BatchSolver(docp, options=opts, mesh=mesh_b, device=dev)
    B = 2 * n
    z0 = np.tile(docp.initial_guess(None), (B, 1))
    res = solver(z0)
    _check(tuple(res.z.shape) == (B, docp.nz) and bool(torch.isfinite(res.z).all()), "leg 1: z")
    out["batch"] = dict(status=res.status.cpu().numpy(), z=res.z.cpu().numpy(), graphed=solver.graphed,
                        captures=solver.captures)

    # 2. time-parallel solve: the full IPM with the time-sharded KKT operator,
    # compiled over NCCL, against its eager form
    mesh_t = world.mesh((n,), ("time",))
    docp_t, _, opts_t = _flagship(grid_size=4 * n, max_iter=3, device=dev)
    kkt = TimeShardedKKT(docp_t, mesh_t, axis="time")
    run = DOCPSolver(docp_t, opts_t, kkt=kkt)
    args = (docp_t.initial_guess(None), docp_t._z_lb, docp_t._z_ub, docp_t._c_lb, docp_t._c_ub)
    ref_t, _ = run.eager(*args)
    res_t, drel = ref_t, 0.0  # off NCCL, run(...) is run.eager(...)
    if run.graphed:
        res_t, _ = run(*args)
        drel = abs(float(res_t.objective) - float(ref_t.objective)) / max(1.0, abs(float(ref_t.objective)))
        _check(res_t.status == ref_t.status and drel <= SOLVE_RTOL,
               f"leg 2: status {res_t.status} vs eager {ref_t.status}, objective rel diff {drel:.3e}")
    kkt_t, obj_t = float(res_t.kkt_error), float(res_t.objective)
    _check(np.isfinite(kkt_t) and bool(torch.isfinite(res_t.z).all()), "leg 2: not finite")
    out["time"] = dict(kkt=kkt_t, objective=obj_t, block_solves=kkt.block_solves, messages=kkt.axis.messages,
                       staged=kkt.axis.staged_messages, graphed=run.graphed, captures=run.captures,
                       eager_drel=drel)

    # 3. batch-sharded RTI MPC tick: this rank's rows of the global batch
    ctrl = MPCController(docp, x0_boundary_rows=[0, 1], resolve_iters=2, kkt_algorithm="cr", mesh=mesh_b,
                         device=dev)
    warm = ctrl.cold_start(options=IPMOptions(tol=1e-6, max_iter=30))
    rows = B // n
    x0 = docp.tensor(np.tile([0.02, -0.01], (rows, 1)))
    _, u0, kkt_err, _ = ctrl(broadcast_state(warm, rows), x0)
    k3 = float(kkt_err.max())
    _check(tuple(u0.shape) == (rows, 1) and k3 < TICK_KKT_MAX, f"leg 3: u0 {tuple(u0.shape)}, kkt {k3:.3e}")
    out["tick"] = dict(kkt=k3, u0=u0.cpu().numpy())

    # 4. batched per-instance variable boxes (zl/zu) under the mesh
    zl = np.tile(docp._z_lb, (B, 1))
    zu = np.tile(docp._z_ub, (B, 1))
    cols = docp.control_col_indices()
    if cols.size:
        scale = np.linspace(0.9, 1.1, B)[:, None]
        zu[:, cols] = zu[:, cols] * scale
        zl[:, cols] = zl[:, cols] * scale
    res_b = solver(z0, zl_batch=zl, zu_batch=zu)
    _check(tuple(res_b.z.shape) == (B, docp.nz) and bool(torch.isfinite(res_b.z).all()), "leg 4: z")
    out["boxes"] = dict(status=res_b.status.cpu().numpy(), z=res_b.z.cpu().numpy(), captures=solver.captures)

    # 5. 2-D batch x time mesh MPC tick: instances over the batch axis, each
    # instance's KKT chain by distributed CR over the time axis
    if n >= 2:
        bt = n // 2
        mesh_2d = world.mesh((bt, 2), ("batch", "time"))
        ctrl2 = MPCController(docp, x0_boundary_rows=[0, 1], resolve_iters=2, mesh=mesh_2d, time_axis="time",
                              device=dev)
        rows2 = 2  # the global batch 2 * bt over bt batch shards
        x02 = docp.tensor(np.tile([0.02, -0.01], (rows2, 1)))
        states2 = broadcast_state(warm, rows2)
        _, u02, kkt2, viol2 = ctrl2(states2, x02)
        _, u02e, kkt2e, viol2e = ctrl2.eager(states2, x02)
        k5 = float(kkt2.max())
        d5 = max(float((a - b).abs().max()) for a, b in ((u02, u02e), (kkt2, kkt2e), (viol2, viol2e)))
        _check(tuple(u02.shape) == (rows2, 1) and k5 < TICK_KKT_MAX, f"leg 5: u0 {tuple(u02.shape)}, kkt {k5:.3e}")
        _check(d5 <= GRAPH_TOL, f"leg 5: the tick and its eager form differ by {d5:.3e}")
        out["tick_2d"] = dict(kkt=k5, u0=u02.cpu().numpy(), batch_shard=ctrl2.axis.rank,
                              messages=ctrl2.kkt.axis.messages, staged=ctrl2.kkt.axis.staged_messages,
                              graphed=ctrl2.graphed, captures=ctrl2.captures, eager_diff=d5)
    return out


def dryrun_multichip(n_devices: int, *, device, backend: str, timeout: float = 600.0) -> list:
    """The five sharded legs on a spawned world of n_devices ranks on
    `device` over `backend` (see the module docstring); prints one line per
    leg and returns the ranks' results (one dict per rank). Raises if a leg
    fails on any rank."""
    from ctdirect_tpu_torch.parallel.spmd import launch

    ranks = launch(_dryrun_rank, n_devices, device=device, backend=backend, timeout=timeout)
    r0 = ranks[0]
    tag = f"dryrun_multichip({n_devices}, {device}, {backend})"
    graphs = f"{r0['batch']['captures']} segment graphs on rank 0" if r0["batch"]["graphed"] else "eager"
    print(f"{tag}: batch-sharded solve OK ({graphs}); statuses={r0['batch']['status'][:4]}...")
    print(f"{tag}: time-sharded distributed-CR solve OK ({_form(r0['time'], 'segment graphs')}); "
          f"kkt_error={r0['time']['kkt']:.2e}, objective vs eager {r0['time']['eager_drel']:.1e} "
          f"({r0['time']['messages']} messages on rank 0, {r0['time']['staged']} staged through the host)")
    print(f"{tag}: batch-sharded RTI tick OK; max kkt={max(r['tick']['kkt'] for r in ranks):.2e}")
    print(f"{tag}: batched-zl/zu sharded solve OK ({r0['boxes']['captures']} segment graphs on rank 0 after "
          f"it); statuses={r0['boxes']['status'][:4]}...")
    if "tick_2d" in r0:
        print(f"{tag}: 2-D (batch={n_devices // 2}, time=2) mesh MPC tick OK ({_form(r0['tick_2d'], 'tick graphs')}); "
              f"max kkt={max(r['tick_2d']['kkt'] for r in ranks):.2e}, vs eager "
              f"{max(r['tick_2d']['eager_diff'] for r in ranks):.1e}")
    return ranks


def main(argv=None):
    parser = argparse.ArgumentParser(description="the port's batched entry step and its multi-rank dry run")
    parser.add_argument("--nproc", type=int, default=4, help="ranks of the dry run's world")
    parser.add_argument("--device", required=True, help="cpu or cuda")
    parser.add_argument("--backend", default="gloo",
                        help="gloo (CPU tensors, or CUDA tensors staged through the host) or nccl (one card per rank)")
    args = parser.parse_args(argv)
    fn, ex = entry(device=args.device)
    out = fn(*ex)
    print("entry() run OK:", [tuple(o.shape) for o in out])
    dryrun_multichip(args.nproc, device=args.device, backend=args.backend)


if __name__ == "__main__":
    main()
