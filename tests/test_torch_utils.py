"""The port's profiling and plotting helpers on the CPU: `timed` records
into a Timings, `benchmark` returns the JAX package's keys, `trace` writes
a Chrome trace, and `plot_solution` draws state, control and costate."""

import json

import pytest
import torch

import ctdirect_tpu_torch as ct
from ctdirect_tpu_torch.problems import get_problem
from ctdirect_tpu_torch.utils import profiling


def test_timed_records_into_timings():
    tm = profiling.Timings()
    x = torch.ones(4)
    for _ in range(3):
        with profiling.timed("matmul", tm, sync=x):
            x = x * 2
    with profiling.timed("nested", tm, sync={"a": [x, torch.device("cpu")], "b": "cpu"}):
        pass
    assert len(tm.records["matmul"]) == 3 and len(tm.records["nested"]) == 1
    assert all(s >= 0 for s in tm.records["matmul"])
    assert tm.summary().splitlines()[0].startswith("matmul: n=3 p50=")


def test_timed_defaults_to_the_global_timings():
    before = len(profiling.GLOBAL_TIMINGS.records.get("test_torch_utils", []))
    with profiling.timed("test_torch_utils"):
        pass
    assert len(profiling.GLOBAL_TIMINGS.records["test_torch_utils"]) == before + 1


def test_benchmark_returns_the_jax_keys():
    calls = []

    def fn(a, b):
        calls.append(1)
        return a @ b

    a = torch.eye(8, dtype=torch.float64)
    out = profiling.benchmark(fn, a, a, warmup=2, reps=3)
    assert set(out) == {"compile_s", "p50_s", "min_s", "max_s", "reps"}
    assert out["reps"] == 3 and 0 <= out["min_s"] <= out["p50_s"] <= out["max_s"]
    assert len(calls) == 1 + 1 + 3  # first call, one more warm-up, reps


def test_trace_writes_a_chrome_trace(tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with profiling.trace(str(tmp_path / "tr"), acts) as prof:
        torch.ones(16, 16) @ torch.ones(16, 16)
    path = tmp_path / "tr" / profiling.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any("aten::mm" in e.key for e in prof.key_averages())


def test_plot_solution_draws_state_control_costate(tmp_path):
    pytest.importorskip("matplotlib")
    from ctdirect_tpu_torch.utils.plot import plot_solution

    sol = ct.solve(get_problem("double_integrator_minenergy").ocp, grid_size=10, scheme="trapeze",
                   device="cpu")
    fig = plot_solution(sol, path=str(tmp_path / "sol.png"))
    assert [ax.get_ylabel() for ax in fig.axes] == ["state", "control", "costate"]
    assert len(fig.axes[0].lines) == 2 and len(fig.axes[1].lines) == 1
    assert (tmp_path / "sol.png").stat().st_size > 0
    import matplotlib.pyplot as plt

    plt.close(fig)
