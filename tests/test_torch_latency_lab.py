"""The single-solve latency lab (`python -m ctdirect_tpu_torch.latency_lab`,
the port of benchmarks/latency_lab.py) on the CPU: beam and goddard at N=20
under the lab's four configurations, each held to the JAX package's
`solve_docp` under the same options by status and, where it converged, by
objective (1e-6 relative; goddard 1e-4, PERF.md section 2); and its command
line with a --jax-objectives file in tools/latency_lab_jax.py's form.

Both packages get max_iter=100 here (the lab's is 500): goddard's
structured:f32 stalls in both (status 1; in the JAX package at 500
iterations too, N = 20 and 250), and 100 iterations keep its eager solve on
the CPU short; every other config converges in fewer."""

import json

import pytest

from ctdirect_tpu_torch import latency_lab

N, MAX_ITER = 20, 100


def _jax_solve(name, cfg):
    from ctdirect_tpu import transcribe
    from ctdirect_tpu.problems import get_problem
    from ctdirect_tpu.solver.interface import solve_docp
    from ctdirect_tpu.solver.ipm import IPMOptions

    prob = get_problem(name)
    docp = transcribe(prob.ocp, grid_size=N, scheme="trapeze")
    sol = solve_docp(docp, init=prob.init, options=IPMOptions(**latency_lab.options(cfg, max_iter=MAX_ITER)))
    return int(sol.status), float(sol.objective)


@pytest.mark.parametrize("cfg", latency_lab.CONFIGS)
@pytest.mark.parametrize("name", latency_lab.PROBLEMS)
def test_lab_row_matches_the_jax_solve(name, cfg):
    status, obj = _jax_solve(name, cfg)
    (row,) = latency_lab.run_lab([name], [N], [cfg], device="cpu", reps=0, max_iter=MAX_ITER,
                                 jax={(name, N, cfg): (status, obj)}, log=lambda m: None)
    assert row["failed"] == [], row["failed"]
    assert (row["problem"], row["N"], f"{row['mode']}:{row['dtype']}", row["card"]) == (name, N, cfg, "cpu")
    assert row["status"] == status == row["jax_status"]
    assert row["jax_rtol"] == (1e-4 if name == "goddard" else 1e-6)
    if status == 0:
        assert row["jax_gap"] <= row["jax_rtol"]
    assert row["block_solves"] > 0 and row["launches"] == row["launches_first"] == 0
    assert row["first_s"] > 0 and row["iters"] <= MAX_ITER and row["capture_s"] == 0.0
    json.dumps(row)


def test_main_reads_a_jax_objectives_file(tmp_path, capsys):
    """The command line on the CPU: a --jax-objectives file (the tool's
    form) is read and held to; a wrong objective there fails the row and
    the exit code."""
    rows = tmp_path / "rows.json"
    argv = ["--cpu", "--problems", "beam", "--grids", str(N), "--configs", "structured:f64", "--reps", "1",
            "--json", str(rows)]
    (row,) = latency_lab.run_lab(["beam"], [N], ["structured:f64"], device="cpu", reps=0, log=lambda m: None)
    good = tmp_path / "jax.json"
    good.write_text(json.dumps({f"beam {N} structured:f64": dict(status=0, iterations=row["iters"],
                                                                  objective=row["obj"], wall_s=1.0)}))
    assert latency_lab.read_jax(good) == {("beam", N, "structured:f64"): (0, row["obj"])}
    assert latency_lab.main(argv + ["--jax-objectives", str(good)]) == 0
    (out,) = json.loads(rows.read_text())["rows"]
    assert out["jax_gap"] == 0.0 and len(out["warm_all"]) == 1 and out["failed"] == []
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({f"beam {N} structured:f64": dict(status=0, iterations=1, objective=2 * row["obj"],
                                                                 wall_s=1.0)}))
    assert latency_lab.main(argv + ["--jax-objectives", str(bad)]) == 1
    assert "FAILED beam N=20 structured:f64" in capsys.readouterr().out


def test_a_status_that_rests_on_rounding_is_reported_not_held(monkeypatch):
    """A status that differs from the JAX package's fails the row, but for
    the cells of STATUS_RESTS_ON_ROUNDING (the reference's own status moves
    with a few ulps of its guess), where it is reported."""
    cell = ("beam", N, "structured:f64")
    (row,) = latency_lab.run_lab(*([x] for x in cell), device="cpu", reps=0, jax={cell: (1, 1.0)},
                                 log=lambda m: None)
    assert row["failed"] == ["status 0, the JAX package's 1"] and "status_rests_on_rounding" not in row
    monkeypatch.setattr(latency_lab, "STATUS_RESTS_ON_ROUNDING", {cell})
    (row,) = latency_lab.run_lab(*([x] for x in cell), device="cpu", reps=0, jax={cell: (1, 1.0)},
                                 log=lambda m: None)
    assert row["failed"] == [] and row["status_rests_on_rounding"] and row["jax_status"] == 1
