"""The benchmark's command: one run of one cell, in a fresh process.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1> [--control]

It needs the CUDA cards the cell asks for and exits non-zero, printing no
result, without them; it never falls back to the CPU. It prints, as the last
line of its standard output, one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
ones), device (and, traced, breakdown), and last the checks, each number
compared with its limit, which also close its standard error. --control
runs the configuration's lower precision (its check has to come out false)."""

import os
import sys
import time


def process_start_epoch() -> float:
    """The wall-clock time this process started (Linux's /proc; the
    interpreter's start-up counts towards set-up)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


START = process_start_epoch()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description="one run of one benchmark cell on the card")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", action="store_true", help="the configuration's lower precision")
    args = parser.parse_args(argv)

    from perfbench import harness

    chips = harness.load(args.workload)["cell"]["chips"]
    import torch

    torch.set_num_threads(4)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s), this machine has {n}", file=sys.stderr)
        return 2
    line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), START, control=args.control)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: JAX or the JAX package loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
