"""The JAX package's solves under the latency lab's configurations, on the CPU.

    JAX_PLATFORMS=cpu python tools/latency_lab_jax.py [--problems beam,goddard]
        [--grids 250,1000,5000] [--configs structured:f64,cr:f64,cr:f32,structured:f32]
        [--tol 1e-6] [--max-iter 500] [--ulps U] --json PATH

For each (problem, N, config): `transcribe(ocp, grid_size=N, scheme="trapeze")`
and one `solve_docp` from the fixture's guess (with --ulps, that guess with
every entry moved by about that many ulps: how far a cell's outcome rests on
rounding) with `IPMOptions(tol, max_iter, kkt_mode, kkt_solve_dtype)`, as
benchmarks/latency_lab.py sets them up. It
prints one JSON line a solve and writes
{"<problem> <N> <mode>:<dtype>": {"status", "iterations", "objective", "wall_s"}}
to PATH, the file `python -m ctdirect_tpu_torch.latency_lab --jax-objectives
PATH` reads (the lab's stored table, `latency_lab.JAX_CPU`, holds such a
run's objectives). It writes nothing else (no compilation cache).
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problems", default="beam,goddard")
    ap.add_argument("--grids", default="250,1000,5000")
    ap.add_argument("--configs", default="structured:f64,cr:f64,cr:f32,structured:f32")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-iter", type=int, default=500)
    ap.add_argument("--ulps", type=float, default=0.0,
                    help="scale the starting guess z0 by 1 + ulps * 2**-52 (each entry moved by about ulps ulps)")
    ap.add_argument("--json", required=True)
    args = ap.parse_args(argv)

    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from ctdirect_tpu import transcribe
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.interface import solve_docp
    from ctdirect_tpu.solver.ipm import IPMOptions

    out = {}
    for name in args.problems.split(","):
        prob = get_problem(name)
        for N in (int(g) for g in args.grids.split(",")):
            docp = transcribe(prob.ocp, grid_size=N, scheme="trapeze")
            if args.ulps:
                z0 = np.asarray(docp.initial_guess(prob.init), dtype=np.float64) * (1 + args.ulps * 2.0**-52)
                docp.initial_guess = lambda init=None, z0=z0: z0.copy()
            for cfg in args.configs.split(","):
                mode, dt = cfg.split(":")
                opts = IPMOptions(tol=args.tol, max_iter=args.max_iter, kkt_mode=mode,
                                  kkt_solve_dtype=None if dt == "f64" else dt)
                t0 = time.perf_counter()
                sol = solve_docp(docp, init=prob.init, options=opts)
                row = dict(status=int(sol.status), iterations=int(sol.iterations), objective=float(sol.objective),
                           wall_s=time.perf_counter() - t0)
                out[f"{name} {N} {cfg}"] = row
                print(json.dumps(dict(problem=name, N=N, config=cfg, **row)), flush=True)
                Path(args.json).write_text(json.dumps(out, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
