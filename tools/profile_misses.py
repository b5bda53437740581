"""Where a profile of a replayed solve loses CR kernel events. Two cases:
`goddard`, BASELINE config 2 (Goddard GL2 N=200, f64, the compiled solve),
and `cartpole_batch`, chip_smoke.py's phase 9 (BatchSolver, kkt_mode="cr",
over 1,024 cart-pole x0 scenarios at trapeze N=60 from a converged solve,
graphed). The case is replayed under torch.profiler `--profiles` times for
each `--margins` value (seconds of idle kept inside the profiler before and
after the replay, utils/profiling.py's PROFILE_MARGIN_S); `--deadline`
starts no profile after that many seconds. Per profile it prints one JSON
line: the CR kernel's CUDA launches seen against the plan (the replay's
block solves x the launches of one), all device events, CUPTI's dropped
records, how far the first device event starts after the profile's first
host event and the last host event ends after the last device event (the
device clock's offset shows there), and, where some are missing, which of
the planned launches they are (by aligning the kernels' names, in start
order, with the planned sequence). Needs a card:

    python tools/profile_misses.py --case cartpole_batch --profiles 60 --margins 0.1,0 --deadline 600
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

os.environ.setdefault("KINETO_LOG_LEVEL", "2")  # kineto's dropped-record warnings (utils/profiling.py)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the planned launch kinds as the profiler names their CUDA kernels
NAMES = {"pack": "transpose_kernel", "unpack": "transpose_kernel", "up_odd": "up_odd", "up_even": "up_even",
         "root": "root_solve", "down": "down"}
# chip_smoke.py's phase 9: grid and batch
CP_N, CP_BATCH = 60, 1024


def missing_positions(seen, planned):
    """Indices of `planned` (names) that the in-order names `seen` skip (a
    greedy alignment: each seen name takes the next planned one of its
    name)."""
    out, i = [], 0
    for name in seen:
        while i < len(planned) and planned[i] != name:
            out.append(i)
            i += 1
        i += 1
    return out + list(range(i, len(planned)))


def spans(idx):
    """[3, 4, 5, 9] -> '3-5, 9'."""
    out, start = [], None
    for k, v in enumerate(idx):
        if start is None:
            start = v
        if k + 1 == len(idx) or idx[k + 1] != v + 1:
            out.append(f"{start}-{v}" if v > start else f"{v}")
            start = None
    return ", ".join(out)


def goddard_case(ct, get_problem):
    """(replay, block solves so far, P): the compiled B=1 Goddard solve."""
    from ctdirect_tpu_torch.solver.interface import _get_solver

    prob = get_problem("goddard")
    opts = ct.IPMOptions(tol=1e-8, mu_strategy="adaptive", kkt_mode="cr")
    docp = ct.transcribe(prob.ocp, grid_size=200, scheme="gauss_legendre_2_constant_control", device="cuda")
    run = _get_solver(docp, opts)
    inputs = (docp.initial_guess(prob.init), docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
    run(*inputs)
    return (lambda: run(*inputs)), (lambda: run.kkt.block_solves), docp.N


def cartpole_batch_case(ct, get_problem):
    """(replay, batched KKT solves so far, P): chip_smoke.py's phase 9
    batch from a converged cart-pole solve, graphed (first call captures)."""
    from ctdirect_tpu_torch.parallel import BatchSolver
    from ctdirect_tpu_torch.solver.interface import _get_solver

    prob = get_problem("cartpole")
    docp = ct.transcribe(prob.ocp, grid_size=CP_N, scheme="trapeze", device="cuda")
    warm, _ = _get_solver(docp, ct.IPMOptions(tol=1e-8, max_iter=200, kkt_mode="cr"))(
        docp.initial_guess(prob.init), docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
    solver = BatchSolver(docp, ct.IPMOptions(tol=1e-6, max_iter=30, lsq_lambda_init=False, kkt_mode="cr"),
                         device="cuda")
    rows = docp.boundary_row_indices()[:4]
    x0 = 0.02 * np.random.default_rng(0).standard_normal((CP_BATCH, 4)) * np.array([1.0, 1.0, 0.5, 0.5])
    cl, cu = np.tile(docp._c_lb, (CP_BATCH, 1)), np.tile(docp._c_ub, (CP_BATCH, 1))
    cl[:, rows] += x0
    cu[:, rows] += x0
    z0 = warm.z.expand(CP_BATCH, -1)
    solver(z0, cl, cu)
    return (lambda: solver(z0, cl, cu)), (lambda: solver.stats.kkt_solves), docp.N


def read_profile(prof):
    """(host spans, device events as (start ns, end ns, demangled name))."""
    host, dev, names = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CPU":
            host.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif not e.is_user_annotation():
            name = e.name()
            if name not in names:
                names[name] = torch._C._demangle(name)
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), names[name]))
    dev.sort()
    return host, dev


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", choices=("goddard", "cartpole_batch"), default="goddard")
    ap.add_argument("--profiles", type=int, default=12)
    ap.add_argument("--margins", default="0,0.05")
    ap.add_argument("--deadline", type=float, default=float("inf"))
    args = ap.parse_args()
    t_start = time.perf_counter()
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched as kernel
    from ctdirect_tpu_torch.utils import profiling

    replay, solves_so_far, N = (goddard_case if args.case == "goddard" else cartpole_batch_case)(ct, get_problem)
    plan = [NAMES[k] for k, *_ in kernel.plan(1 << (N - 1).bit_length(), 1, 0, 1, 8)]
    for margin in (float(m) for m in args.margins.split(",")):
        profiling.PROFILE_MARGIN_S = margin
        for k in range(args.profiles):
            if time.perf_counter() - t_start > args.deadline:
                break
            n0 = solves_so_far()
            _, prof, wall, dropped = profiling.device_profile(replay)
            solves = solves_so_far() - n0
            host, dev = read_profile(prof)
            hits = ((s, profiling.CR_KERNELS.search(name)) for s, _, name in dev)
            cr = [(s, hit.group(1)) for s, hit in hits if hit]
            planned = plan * solves
            row = dict(case=args.case, margin_s=margin, profile=k, seen=len(cr), planned=len(planned),
                       events=len(dev), dropped=dropped, wall_s=round(wall, 4),
                       first_device_after_first_host_us=(dev[0][0] - min(host)[0]) / 1e3,
                       last_host_after_last_device_us=(max(h for _, h in host) - max(d for _, d, _ in dev)) / 1e3)
            if len(cr) != len(planned):
                miss = missing_positions([n for _, n in cr], planned)
                row.update(missing=spans(miss), missing_solves=sorted({i // len(plan) for i in miss}), solves=solves)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
