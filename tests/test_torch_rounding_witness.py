"""tools/rounding_witness.py: the rule that tells a fault from rounding
(a two-sided Fisher exact test, against p-values worked out by hand), the
ulp-moved guess against tools/latency_lab_jax.py's, a draw run end to end
on the CPU at a small size, and the counting of the three kinds of line."""

import importlib.util
import json
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


rw = _tool("rounding_witness")


# (fails_a, n_a, fails_b, n_b, p): the hypergeometric probabilities of the
# tables with the margins fixed, summed over those no more likely than the
# observed one. 8/8 vs 0/8: the two extreme tables, 2 / C(16, 8). 4/6 vs
# 1/6: 5 failures in 12 draws, P(k in arm a) = C(6,k) C(6,5-k) / 792 = (6,
# 90, 300, 300, 90, 6) / 792 for k = 0..5; the observed k=4 (90) and those
# as unlikely: (6 + 90 + 90 + 6) / 792. 5/8 vs 0/8: (56 + 56) / C(16, 5).
# 2/4 vs 2/4: every table is at least as likely as some other, p = 1.
CASES = [
    (8, 8, 0, 8, Fraction(2, 12870)),
    (4, 6, 1, 6, Fraction(192, 792)),
    (5, 8, 0, 8, Fraction(112, 4368)),
    (0, 8, 5, 8, Fraction(112, 4368)),
    (2, 4, 2, 4, Fraction(1)),
    (0, 8, 0, 8, Fraction(1)),
]


@pytest.mark.parametrize("fa,na,fb,nb,p", CASES)
def test_fault_or_rounding_against_hand_computed_fisher_p_values(fa, na, fb, nb, p):
    out = rw.fault_or_rounding(fa, na, fb, nb)
    assert out["p"] == pytest.approx(float(p), rel=1e-12)
    assert out["verdict"] == ("fault" if p < Fraction(1, 20) else "rounding")
    # the test is symmetric in the arms
    assert rw.fault_or_rounding(fb, nb, fa, na)["p"] == pytest.approx(float(p), rel=1e-12)


def test_fault_or_rounding_refuses_counts_out_of_range():
    with pytest.raises(ValueError):
        rw.fault_or_rounding(9, 8, 0, 8)


@pytest.mark.parametrize("k", [0, 1, -3, 4])
def test_moved_guess_is_latency_lab_jaxs(monkeypatch, tmp_path, k):
    """The guess the JAX lab tool solves from with --ulps k, bit for bit
    the port's fixture guess moved by rounding_witness.moved_guess."""
    import ctdirect_tpu.solver.interface as interface_j

    from ctdirect_tpu_torch import transcribe
    from ctdirect_tpu_torch.problems import get_problem

    seen = []

    class Sol:
        status, iterations, objective = 1, 0, 0.0

    def fake_solve(docp, init=None, options=None):
        seen.append(np.asarray(docp.initial_guess(init), dtype=np.float64))
        return Sol()

    monkeypatch.setattr(interface_j, "solve_docp", fake_solve)
    lab_jax = _tool("latency_lab_jax")
    lab_jax.main(["--problems", "goddard", "--grids", "20", "--configs", "structured:f32", "--ulps", str(k),
                  "--json", str(tmp_path / "jax.json")])
    assert len(seen) == 1
    prob = get_problem("goddard")
    z0 = np.asarray(transcribe(prob.ocp, grid_size=20, scheme="trapeze", device="cpu").initial_guess(prob.init),
                    dtype=np.float64)
    moved = rw.moved_guess(z0, k)
    np.testing.assert_array_equal(moved, seen[0])
    assert (moved != z0).any() == (k != 0)


def test_a_draw_runs_end_to_end_on_the_cpu(tmp_path, capsys):
    """goddard trapeze N=50 at 5 iterations, two draws: one JSON line each,
    the plain scan (no kernel launch), counted by `compare`."""
    out = tmp_path / "draws.jsonl"
    assert rw.main(["draws", "--device", "cpu", "--grid", "50", "--max-iter", "5", "--ulps", "0,2",
                    "--json", str(out)]) == 0
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    rows = rw.read_rows(out)
    assert printed == rows and [r["k"] for r in rows] == [0, 2]
    for r in rows:
        assert (r["problem"], r["N"], r["config"], r["device"], r["kernel"]) == (
            "goddard", 50, "structured:f32", "cpu", "shipped")
        assert r["iterations"] == 5 and r["status"] == 1 and r["failed"] is True
        assert r["gap"] is None  # no JAX objective at N=50
        assert r["block_solves"] > 0 and r["launches"] == 0 and r["wall_s"] > 0
    assert rows[0]["objective"] != rows[1]["objective"]  # the moved guess moved the solve
    res = rw.compare(out, out)
    assert (res["a"], res["b"], res["verdict"]) == ("2/2", "2/2", "rounding")


def test_outcomes_count_the_three_kinds_of_line():
    lab = dict(problem="goddard", N=5000, config="structured:f32")
    ref = 1.0125539498056622  # latency_lab.JAX_CPU's objective of that cell
    rows = [
        dict(lab, k=0, status=0, objective=ref, failed=False),  # a draw of the tool
        dict(lab, k=1, status=2, objective=ref, failed=True),
        dict(lab, k=2, skipped="deadline"),
        dict(lab, status=0, iterations=122, objective=ref * (1 + 5e-5)),  # tools/latency_lab_jax.py
        dict(lab, status=0, iterations=122, objective=ref * (1 + 5e-4)),  # beyond JAX_RTOL
        dict(lab, status=1, iterations=500, objective=ref),
    ]
    stage = dict(fixture="algal_bacterial", package="torch", block="structured", dtv=0)
    rows += [
        dict(stage, ulps=0, stage=0), dict(stage, ulps=0, stage=2, verdict=""),
        dict(stage, ulps=1, stage=2, verdict="not successful: Maximum_Iterations_Exceeded"),
        dict(stage, ulps=2, stage=1),  # cut by the deadline
        dict(stage, ulps=3, error="RuntimeError()"),
        dict(done=True, seconds=1.0),
    ]
    got = rw.outcomes(rows)
    assert sorted(f for _, f in got["draws"]) == [False] * 3 + [True] * 5
    assert sorted(got["unfinished"]) == [2, 2]
