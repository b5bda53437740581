"""The port's profiling and plotting helpers on the CPU: `timed` records
into a Timings, `benchmark` returns the JAX package's keys, `trace` writes
a Chrome trace, kineto's dropped-record warnings are read off stderr,
`kernel_events` profiles again only where records were dropped, and
`plot_solution` draws state, control and costate."""

import json
import os
import tempfile
from types import SimpleNamespace

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


def test_dropped_records_are_read_off_stderr():
    """What kineto writes to file descriptor 2 while a profile runs lands
    in the capture, its dropped-record counts are summed, and descriptor 2
    is restored after."""
    before = os.fstat(2)
    with tempfile.TemporaryFile() as f:
        with profiling._stderr_to(f):
            os.write(2, b"W1017 CuptiActivityApi.cpp:1] Dropped 12 activity records\nother\n")
            os.write(2, b"W1017 CuptiActivityApi.cpp:1] Dropped 3 activity records\n")
        f.seek(0)
        err = f.read()
    assert profiling.dropped_records(err) == 15
    assert profiling.dropped_records(b"no kineto warning\n") == 0
    after = os.fstat(2)
    assert (after.st_dev, after.st_ino) == (before.st_dev, before.st_ino)


def _event(name, device, start, end, corr=0, linked=0):
    """A raw profiler event (the methods of torch's _KinetoEvent that
    stage_split reads)."""
    return SimpleNamespace(name=lambda: name, device_type=lambda: SimpleNamespace(name=device),
                           start_ns=lambda: start, end_ns=lambda: end, duration_ns=lambda: end - start,
                           correlation_id=lambda: corr, linked_correlation_id=lambda: linked,
                           is_user_annotation=lambda: device == "CUDA" and name.startswith(profiling.STAGE))


def _profile(events):
    """A profile whose raw events are `events`."""
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))


# (CR kernel events seen, records dropped) per profile, and what kernel_events does
PROFILES = {
    "exact": ([(27, 0)], dict(tries=1, dropped=0)),
    "dropped_then_exact": ([(20, 5), (27, 0)], dict(tries=2, dropped=5)),
    "short_with_nothing_dropped": ([(20, 0), (27, 0)], "planned 27 (1 profiles, 0 activity"),
    "dropped_every_time": ([(20, 5), (21, 4), (26, 1)], "planned 27 (3 profiles, 10 activity"),
}


@pytest.mark.parametrize("case", sorted(PROFILES))
def test_kernel_events_profiles_again_only_where_records_were_dropped(monkeypatch, case):
    """A profile whose count differs from the plan fails unless CUPTI
    dropped records in it; then it is taken again, three profiles at most."""
    readings, expect = PROFILES[case]
    taken = []

    def fake_profile(fn):
        seen, lost = readings[len(taken)]
        taken.append(seen)
        events = [_event("void up_odd<double>(double*)", "CUDA", 0, 1)] * seen
        events += [_event("void elementwise_kernel<128, 4>()", "CUDA", 0, 1)] * 100
        return fn(), _profile(events), 0.5, lost

    monkeypatch.setattr(profiling, "device_profile", fake_profile)
    if isinstance(expect, str):
        with pytest.raises(AssertionError, match=expect.replace("(", r"\(")):
            profiling.kernel_events(lambda: 27)
        assert len(taken) == (1 if case == "short_with_nothing_dropped" else 3)
    else:
        rec = profiling.kernel_events(lambda: 27)
        assert (rec["seen"], rec["want"], rec["tries"], rec["dropped"]) == (27, 27, expect["tries"], expect["dropped"])
        assert rec["totals"] == dict(busy=127e-9, cr=27e-9, cr_events=27, events=127)


def test_profiled_solve_counts_the_block_solves_of_every_profile(monkeypatch):
    """A profile taken again (CUPTI dropped records in the first) runs the
    solve again: profiled_solve's block_solves counts the solves of every
    profile taken, as the kernel's own counts do, and its plan is the last
    profile's."""
    readings = [(20, 5), (27, 0)]
    solves = []

    def fake_profile(fn):
        seen, lost = readings[len(solves)]
        want = fn()
        events = [_event("void up_odd<double>(double*)", "CUDA", 0, 1)] * seen
        return want, _profile(events), 0.5, lost

    monkeypatch.setattr(profiling, "device_profile", fake_profile)
    rec = profiling.profiled_solve(lambda: solves.append(1), lambda: len(solves), 27)
    assert (rec["tries"], rec["dropped"], rec["cr_launches"]) == (2, 5, 27)
    assert rec["block_solves"] == len(solves) == 2


def test_kkt_ranges_wrap_the_operator_for_the_block_only():
    """kkt_ranges puts each KKT_STAGES method of one operator in a profiler
    range named after its stage over the block and takes it off after; the
    results are the method's."""
    from ctdirect_tpu_torch.solver.structured_kkt import StructuredKKT

    d = ct.transcribe(get_problem("double_integrator_minenergy").ocp, grid_size=4, scheme="trapeze", device="cpu")
    kkt = StructuredKKT(d, algorithm="cr")
    z = d.tensor(d.initial_guess())
    lam = torch.zeros(d._c_lb.shape[0], dtype=torch.float64)
    one = torch.ones((), dtype=torch.float64)
    plain = kkt.prepare(z, lam, one, torch.ones_like(lam))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.kkt_ranges(kkt) as ranged:
            assert ranged is kkt and set(profiling.KKT_STAGES) <= set(vars(kkt))
            inside = kkt.prepare(z, lam, one, torch.ones_like(lam))
    assert not set(profiling.KKT_STAGES) & set(vars(kkt))
    assert all(torch.equal(a, b) for a, b in zip(torch.utils._pytree.tree_leaves(plain),
                                                 torch.utils._pytree.tree_leaves(inside)))
    names = {e.name for e in prof.events()}
    assert profiling.STAGE + "prepare" in names and profiling.STAGE + "assemble" not in names
    assert profiling.stage_split(prof, 1, outside="rest") == {}  # the raw events of a CPU profile: no device time


def test_stage_split_gives_each_kernel_to_the_innermost_open_range():
    """stage_split's attribution on a made-up profile: nested ranges, a
    kernel launched after an inner range closed (its outer range's), one
    outside every range, the CR kernel's (by name, linked to no op), a
    kernel linked to no op and a range's own device span (ignored); ms per
    call over 2 calls."""
    S = profiling.STAGE
    ops = [(S + "prepare", 0, 100), (S + "assemble", 10, 20), (S + "solve (other)", 200, 300),
           (S + "block solve (casts, pad)", 210, 220)]
    launches = [("aten::mul", 5, "mul_kernel", 1), ("aten::add", 15, "add_kernel", 2),
                ("aten::sub", 50, "sub_kernel", 4), ("aten::div", 150, "div_kernel", 8),
                ("aten::copy_", 215, "copy_kernel", 16), ("aten::neg", 250, "neg_kernel", 32)]
    events = [_event(name, "CPU", a, b) for name, a, b in ops]
    events += [_event(S + "prepare", "CUDA", 0, 10**9)]
    for k, (op, t, kernel, ms) in enumerate(launches, start=1):
        events += [_event(op, "CPU", t, t + 1, corr=k), _event(kernel, "CUDA", 0, 2 * ms * 10**6, linked=k)]
    events += [_event("up_odd<double>", "CUDA", 0, 7 * 10**6), _event("memset_kernel", "CUDA", 0, 64 * 10**6, linked=99)]
    split = profiling.stage_split(_profile(events), 2, outside="rest")
    assert split == {"prepare": 5.0, "assemble": 2.0, "rest": 8.0, "block solve (casts, pad)": 16.0,
                     "solve (other)": 32.0, "CR kernel": 3.5, "not linked to a host event": 32.0}


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
