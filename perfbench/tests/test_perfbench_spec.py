"""BENCHMARK.json against the benchmark's contract, and the harness's files
found by the names in it; no module of perfbench/ imports JAX or the JAX
package (top-level names compared whole), and the reference imports nothing
of the program.

    python -m pytest -p no:cacheprovider perfbench/tests
"""

import ast
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_CHARS = re.compile(r"^[A-Za-z0-9_./-]+$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= len(BENCH["command"]) <= 32 and all(isinstance(w, str) and 1 <= len(w) <= 200 for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # every file under paths is named from a name's characters and "/"
    for path in HERE.rglob("*"):
        if "__pycache__" not in path.parts and path.is_file():
            assert PATH_CHARS.match(str(path.relative_to(ROOT))), path


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_configs():
    names = [c["name"] for c in BENCH["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"]) and c["name"] in used
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) and k in cfg for k in c["reduced"])
        assert (HERE / "reference" / f"{c['name']}.py").exists()
        assert set(cfg["precision"]) == set(cfg["control"]) == {"newton", "block_solve"}


def test_workloads():
    cells = BENCH["workloads"]
    names = [w["name"] for w in cells]
    assert 1 <= len(cells) <= 24 and len(set(names)) == len(names)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"]) and w["chips"] in (1, 4)
        mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (HERE / "kinds" / f"{mix['kind']}.py").exists()
        limits = json.loads((HERE / "limits" / f"{w['name']}.json").read_text())
        assert limits["max"] and all(isinstance(v, (int, float)) and v >= 0 for v in limits["max"].values())


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e, layer = BENCH["end_to_end"], BENCH["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names) and 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    reported = {c: set() for c in cells}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        for c in m.get("workloads", cells):
            assert c in cells
            reported[c].add(m["name"])
    setup = next(m for m in e2e if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25
    assert all(len(r) >= 2 for r in reported.values())
    layers = {}
    for m in layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and _line(m["layer"]) and (HERE / "metrics" / f"{m['name']}.py").exists()
        for c in m["workloads"]:
            assert m["moves"] in reported[c], (m["name"], c)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for c in cells:
        assert any(c in m["workloads"] for m in layer)


def test_check_time_fits_with_24_cells():
    rs = BENCH["run_seconds"]
    assert 2 * (rs + 60) + 24 * (14 * (rs + 60) + 2 * 90) + 1200 <= 43200


def test_size_of_the_file():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                yield arg.value
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                yield arg.values[0].value


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    top = {name.split(".")[0] for name in _imports(path)}
    assert not top & {"jax", "jaxlib", "flax", "ctdirect_tpu"}, top


def test_reference_imports_only_plain_libraries():
    for path in (HERE / "reference").glob("*.py"):
        top = {name.split(".")[0] for name in _imports(path)}
        assert top <= {"__future__", "typing", "numpy", "torch"}, (path, top)

