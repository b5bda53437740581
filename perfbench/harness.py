"""One run of one cell: the cell's files found by the names in BENCHMARK.json,
the traffic kind's runner, the end-to-end metrics (--trace 0) or the
per-layer readers (--trace 1), the checks against their limits, and the
result's line.

A cell's files: perfbench/configs/<config>.json (its sizes, with its
equations in perfbench/reference/<config>.py), perfbench/traffic/<mix>.json
(whose "kind" names the runner, perfbench/kinds/<kind>.py),
perfbench/limits/<cell>.json (the checks the cell holds its runs to, each
number's largest allowed value) and perfbench/metrics/<metric>.py (a reader:
`read(run) -> float or None`)."""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ctdirect_tpu"}


def load(cell: str) -> dict:
    """The cell's entry of BENCHMARK.json, its configuration (with its name),
    traffic mix, limits and the metrics it reports."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise SystemExit(f"perfbench: no workload {cell!r} in BENCHMARK.json ({', '.join(cells)})")
    w = cells[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = dict(json.loads((ROOT / conf["file"]).read_text()), name=w["config"])
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return dict(cell=w, cfg=cfg, mix=mix, limits=limits, e2e=e2e, per_layer=layer)


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cards() -> list:
    """The cards' names and power limits (nvidia-smi), one line a card, for
    every number's record."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi: {e}"
    return out.splitlines()


def run_cell(cell: str, seed: int, seconds: float, trace: bool, start_epoch: float, *, control: bool = False,
             device: str = "cuda", sizes: dict = None, log=None) -> dict:
    """One run of `cell`; returns the result's line (a dict, "checks" last)
    and logs, last, each number compared beside its limit. `control` runs
    the configuration's control precision; `device` and `sizes` (config
    keys -> values, traffic keys -> values) are for the CPU tests."""
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    spec = load(cell)
    sizes = sizes or {}
    cfg = dict(spec["cfg"], **sizes.get("config", {}))
    mix = dict(spec["mix"], **sizes.get("traffic", {}))
    ctx = dict(cell=cell, cfg=cfg, mix=mix, seed=int(seed), seconds=float(seconds), trace=bool(trace),
               control=bool(control), device=device)
    kind = importlib.import_module(f"perfbench.kinds.{mix['kind']}")
    run = kind.run(ctx)
    run["setup_s"] = run["setup_epoch"] - start_epoch

    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        values = dict(run["e2e"], setup_s=run["setup_s"])
        for m in spec["e2e"]:
            metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    import torch

    dev = torch.device(device)
    info = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                kind=torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu", count=spec["cell"]["chips"],
                memory_peak_bytes=int(run["memory_peak_bytes"]))
    if dev.type == "cuda":
        info["cards"] = cards()
    if trace:
        info.update(busy_s=run["busy_s"], window_s=run["trace_window_s"])
    log(f"perfbench {cell} seed {seed}: {json.dumps(dict(info=run['info'], setup_s=run['setup_s'], samples=run['samples'], e2e=run['e2e']))}")

    checks, correct = {}, run["samples"] > 0
    for name, limit in spec["limits"]["max"].items():
        value = run["checks"].get(name, float("inf")) if name != "failed" else run["failed"]
        ok = value <= limit
        correct &= ok
        checks[name] = dict(value=value, limit=limit)
    line = dict(correct=bool(correct), attempted=int(run["attempted"]), failed=int(run["failed"]), metrics=metrics,
                device=info)
    if trace:
        line["breakdown"] = run["breakdown"]
    line["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r}) {'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    return line


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process (by the
    whole top-level name)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
