"""Where a profile of a replayed solve loses CR kernel events: BASELINE
config 2 (Goddard GL2 N=200, f64, the compiled solve) replayed under
torch.profiler `--profiles` times for each `--margins` value (seconds of
idle kept inside the profiler before and after the replay,
utils/profiling.py's PROFILE_MARGIN_S). Per profile it prints the CR
kernel's CUDA launches seen against the plan (the replay's block solves x
the launches of one) and, where some are missing, which of the planned
launches they are (by aligning the kernels' names, in start order, with the
planned sequence) and how far the first and last device events lie from
the profile's first and last host events. Needs a card:

    python tools/profile_misses.py --profiles 12 --margins 0,0.05
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

# the planned launch kinds as the profiler names their CUDA kernels
NAMES = {"pack": "transpose_kernel", "unpack": "transpose_kernel", "up_odd": "up_odd", "up_even": "up_even",
         "root": "root_solve", "down": "down"}


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profiles", type=int, default=12)
    ap.add_argument("--margins", default="0,0.05")
    args = ap.parse_args()
    import ctdirect_tpu_torch as ct
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched as kernel
    from ctdirect_tpu_torch.solver.interface import _get_solver
    from ctdirect_tpu_torch.utils import profiling

    prob = get_problem("goddard")
    opts = ct.IPMOptions(tol=1e-8, mu_strategy="adaptive", kkt_mode="cr")
    docp = ct.transcribe(prob.ocp, grid_size=200, scheme="gauss_legendre_2_constant_control", device="cuda")
    run = _get_solver(docp, opts)
    inputs = (docp.initial_guess(prob.init), docp._z_lb, docp._z_ub, docp._c_lb, docp._c_ub)
    run(*inputs)
    plan = [NAMES[k] for k, *_ in kernel.plan(1 << (docp.N - 1).bit_length(), 1, 0, 1, 8)]
    for margin in (float(m) for m in args.margins.split(",")):
        profiling.PROFILE_MARGIN_S = margin
        for k in range(args.profiles):
            n0 = run.kkt.block_solves
            _, prof, wall, dropped = profiling.device_profile(lambda: run(*inputs))
            solves = run.kkt.block_solves - n0
            host, cr, dev = [], [], []
            for e in prof.profiler.kineto_results.events():
                if e.device_type().name == "CPU":
                    host.append((e.start_ns(), e.start_ns() + e.duration_ns()))
                elif not e.is_user_annotation():
                    name = torch._C._demangle(e.name())
                    dev.append((e.start_ns(), e.start_ns() + e.duration_ns()))
                    hit = profiling.CR_KERNELS.search(name)
                    if hit:
                        cr.append((e.start_ns(), hit.group(1)))
            cr.sort()
            planned = plan * solves
            row = dict(margin_s=margin, profile=k, seen=len(cr), planned=len(planned), dropped=dropped,
                       wall_s=round(wall, 4))
            if len(cr) != len(planned):
                miss = missing_positions([n for _, n in cr], planned)
                row.update(missing=spans(miss), missing_solves=sorted({i // len(plan) for i in miss}),
                           solves=solves,
                           first_device_after_first_host_us=(min(dev)[0] - min(host)[0]) / 1e3,
                           last_host_after_last_device_us=(max(h for _, h in host) - max(d for _, d in dev)) / 1e3)
            print(json.dumps(row), flush=True)
    docp.release_solvers()


if __name__ == "__main__":
    main()
