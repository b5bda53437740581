"""How accurate the scan kernel's f32 solve is against its plain version's
on long chains, where the border sums (Ftil, rbtil) run over N bs terms,
and how long it takes; for the shipped kernel and for other sources of it.

    python3 tools/scan_border_accuracy.py [--sources shipped,PATH,...]

On the card. For each of the seeds 0-5, a random chain of goddard trapeze's
shape at N=5000 (5,000 blocks of width 10, a border of 12: 50,000 terms a
border sum; tests/torch_helpers.py::random_chain_lanes, B=1) in float32:
the relative xb error of each source's kernel and of the plain version on
the CPU (`scan_kernel.scan_solve_plain`), each against the plain float64
solve of the same float32 inputs; one JSON line a seed. Then each source's
kernel time at seed 0's chain, float32 and float64: CUDA events around 5
calls, the sources in turns, 3 rounds; one JSON line a dtype. A source
other than "shipped" is a variant of csrc/scan_solve.cu with the same C
interface, built for the width (`rounding_witness.install_scan_source`).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "tests"), str(ROOT), str(ROOT / "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)
P, BS, WB, SEEDS, ROUNDS = 5000, 10, 12, range(6), 3


def libraries(sources, bs):
    """{source: loaded library} for width bs; "shipped" is the package's."""
    from rounding_witness import install_scan_source

    from ctdirect_tpu_torch.solver import scan_kernel

    key = scan_kernel.width_key(bs)
    libs = {}
    for src in sources:
        if src == "shipped":
            libs[src] = scan_kernel._load(scan_kernel.scan_solve_batched.library(key)[0])
        else:
            install_scan_source(src, bs)
            libs[src] = scan_kernel.scan_solve_batched._libs[key]
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sources", default="shipped")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ctdirect_tpu_torch.shard_timing import card_line
    from ctdirect_tpu_torch.solver.scan_kernel import scan_solve_batched, scan_solve_plain, width_key
    from torch_helpers import random_chain_lanes

    if not torch.cuda.is_available():
        print("scan_border_accuracy: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    key = width_key(BS)
    libs = libraries(args.sources.split(","), BS)

    def chain(seed, dtype):
        lanes = random_chain_lanes(P, BS, WB, 1, seed=seed, dtype=np.float32)
        A, Bp, E, F, r, rb = (np.ascontiguousarray(np.moveaxis(x, -1, 0)) for x in lanes)
        return tuple(torch.from_numpy(x).to(dtype) for x in (A, Bp[:, : P - 1], E, F, r, rb))

    for seed in SEEDS:
        cpu = chain(seed, torch.float32)
        _, xb64 = scan_solve_plain(*(x.double() for x in cpu))
        scale = xb64.abs().max().item()

        def err(xb):
            return (xb.cpu().double() - xb64).abs().max().item() / scale

        row = dict(seed=seed, plain_cpu=err(scan_solve_plain(*cpu)[1]))
        for src, lib in libs.items():
            scan_solve_batched._libs[key] = lib
            row[src] = err(scan_solve_batched(*(x.cuda() for x in cpu))[1])
        print(json.dumps(row), flush=True)

    for dtype in (torch.float32, torch.float64):
        dev = tuple(x.cuda() for x in chain(SEEDS[0], dtype))
        ms = {src: [] for src in libs}
        for _ in range(ROUNDS):
            for src, lib in libs.items():
                scan_solve_batched._libs[key] = lib
                scan_solve_batched(*dev)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    scan_solve_batched(*dev)
                end.record()
                torch.cuda.synchronize()
                ms[src].append(start.elapsed_time(end) / 5)
        print(json.dumps(dict(dtype=str(dtype), ms=ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
