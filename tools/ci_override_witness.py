"""The evidence behind chip_smoke.py's CI_CARD_OVERRIDES: a fixture's CI
recipe (tests/test_all_ocp.py) in either package, with another KKT solve or
a guess moved by a few ulps, held to the CI's oracle. It runs the recipe
stage by stage and prints one JSON line per stage.

A job is [fixture, package, device, block, dtv]:
  package  "jax" (the JAX package, CPU only) or "torch" (the port)
  block    structured  the CI's own scan solve (kkt_mode="structured")
           kernel      kkt_mode="cr" as dispatched: the CR kernel on a CUDA
                       device, its plain version on the CPU
           plain       kkt_mode="cr" through lanes.cr_solve_lanes on the same
                       device, the kernel's plain version
           shadow      as kernel, and every block solve is also solved by the
                       plain version on the same inputs: the largest relative
                       difference of the two solutions, both relative
                       residuals, and how often each residual is 10x the other
  dtv      added to the first entry of the fixture's variable guess (for
           space_shuttle its tf guess, 500: 1e-10 is a change of a few ulps)

    python tools/ci_override_witness.py --workers 4 --jobs \
        '[["space_shuttle","jax","cpu","kernel",1e-10],["quadrotor","jax","cpu","kernel",0]]'
    python tools/ci_override_witness.py --workers 3 --deadline 360 --stages 1 --jobs \
        '[["space_shuttle","torch","cuda","shadow",0],["space_shuttle","torch","cuda","plain",1e-10]]'

--stages cuts every job after that many stages; --deadline (seconds) ends the
pool then, so a run on a card fits its time limit.
"""

import argparse
import json
import multiprocessing
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _paths():
    for p in (str(ROOT / "tests"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def emit(row):
    print(json.dumps(row), flush=True)


def run_jax(tag):
    """The JAX package on the CPU ("kernel" and "plain" are both its plain CR
    there)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import ctdirect_tpu as ct
    from ctdirect_tpu.model.init import InitialGuess
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.interface import solve_docp
    from ctdirect_tpu.solver.ipm import IPMOptions
    from test_all_ocp import CONFIG, Cfg

    name = tag["fixture"]
    return stages(ct.transcribe, solve_docp, InitialGuess, IPMOptions, get_problem(name), CONFIG.get(name, Cfg()),
                  tag, {})


def run_torch(tag):
    import torch

    import ctdirect_tpu_torch as ct
    from chip_smoke import CI_CONFIG, Cfg
    from ctdirect_tpu_torch.model.init import InitialGuess
    from ctdirect_tpu_torch.problems import get_problem
    from ctdirect_tpu_torch.solver import cr_kernel, lanes

    device, block, name = tag["device"], tag["block"], tag["fixture"]
    torch.set_num_threads(1)
    stats = dict(solves=0, max_rel_diff=0.0, max_res_kernel=0.0, max_res_plain=0.0, kernel_10x=0, plain_10x=0)
    kernel = cr_kernel.cr_solve_batched
    if block == "plain":
        cr_kernel.cr_solve_batched = lambda *a: lanes.cr_solve_lanes(*a)
    elif block == "shadow":
        from torch_helpers import lane_residuals

        def shadow(*a):
            X, xb = kernel(*a)
            Xp, xbp = lanes.cr_solve_lanes(*a)
            s = torch.cat([X.reshape(-1), xb.reshape(-1)])
            p = torch.cat([Xp.reshape(-1), xbp.reshape(-1)])
            rk, rp = float(lane_residuals(a, X, xb).max()), float(lane_residuals(a, Xp, xbp).max())
            stats["solves"] += 1
            stats["max_rel_diff"] = max(stats["max_rel_diff"], float((s - p).abs().max() / p.abs().max()))
            stats["max_res_kernel"] = max(stats["max_res_kernel"], rk)
            stats["max_res_plain"] = max(stats["max_res_plain"], rp)
            stats["kernel_10x"] += int(rk > 10 * rp)
            stats["plain_10x"] += int(rp > 10 * rk)
            return X, xb

        cr_kernel.cr_solve_batched = shadow
    kernel.reset_counts()

    def solve(docp, init, options):
        from ctdirect_tpu_torch.solver.interface import solve_docp

        sol = solve_docp(docp, init=init, options=options)
        if device != "cpu":
            torch.cuda.synchronize()
        return sol

    def transcribe(ocp, grid_size, scheme):
        return ct.transcribe(ocp, grid_size=grid_size, scheme=scheme, device=device)

    return stages(transcribe, solve, InitialGuess, ct.IPMOptions, get_problem(name), CI_CONFIG.get(name, Cfg()),
                  tag, stats if block == "shadow" else {}, kernel)


def stages(transcribe, solve, InitialGuess, IPMOptions, prob, cfg, tag, stats, kernel=None):
    from chip_smoke import ci_verdict

    guess = prob.init
    if tag["dtv"]:
        v = [float(a) for a in guess.variable]
        guess = InitialGuess(state=guess.state, control=guess.control, variable=[v[0] + tag["dtv"]] + v[1:])
    mode = "structured" if tag["block"] == "structured" else "cr"
    opts = IPMOptions(**{**cfg.opts, "kkt_mode": mode})
    warm = opts if cfg.warm_mu is None else opts.replace(mu_init=cfg.warm_mu)
    grids = (cfg.pre_grids + [cfg.grid])[:tag["stages"]]
    t0 = time.perf_counter()
    for k, n in enumerate(grids):
        docp = transcribe(prob.ocp, grid_size=n, scheme=cfg.scheme)
        sol = solve(docp, guess, opts if k == 0 or cfg.warm_mu is None else warm)
        row = dict(tag, stage=k, N=n, status=int(sol.status), message=str(sol.message),
                   iterations=int(sol.iterations), objective=float(sol.objective),
                   wall_s=round(time.perf_counter() - t0, 2), **stats)
        if kernel is not None:
            row["kernel_launches"] = kernel.launches
        if k == len(cfg.pre_grids):
            row["verdict"] = ci_verdict(tag["fixture"], prob, cfg, sol)
        emit(row)
        guess = InitialGuess.from_solution(sol)
    return tag


def job(args):
    fixture, package, device, block, dtv, n_stages = args
    _paths()
    tag = dict(fixture=fixture, package=package, device=device, block=block, dtv=dtv, stages=n_stages)
    try:
        return run_jax(tag) if package == "jax" else run_torch(tag)
    except Exception as e:  # noqa: BLE001 - report it and go on with the other jobs
        emit(dict(tag, error=repr(e)))
        return tag


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", required=True)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--deadline", type=float, default=1e9, help="seconds; then the pool is terminated")
    ap.add_argument("--stages", type=int, default=99, help="stages of the recipe to run (default: all)")
    args = ap.parse_args()
    _paths()
    jobs = [tuple(j) + (args.stages,) for j in json.loads(args.jobs)]
    t0 = time.time()
    if any(j[2] == "cuda" for j in jobs):  # build the kernel once, before the workers
        from ctdirect_tpu_torch.solver.cr_kernel import cr_solve_batched

        cr_solve_batched.library()
    pool = multiprocessing.get_context("spawn").Pool(args.workers)
    res = pool.map_async(job, jobs)
    res.wait(args.deadline)
    done = res.ready()
    pool.terminate()
    pool.join()
    emit(dict(done=done, seconds=round(time.time() - t0, 1)))


if __name__ == "__main__":
    main()
