"""BENCHMARK.json and the files it names: shapes, names, lengths, readers,
and the references' isolation from the program."""
import ast
import json
import re
import subprocess
import sys

import pytest

from _pb_tiny import REPO

MAN = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer",
                      "moves"}}


def test_top_level():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        extra = set(e) - KEYS[kind] - ({"workloads"} if kind in (
            "end_to_end", "per_layer") else set())
        assert set(e) >= KEYS[kind] and not extra, (e["name"], extra)
        assert NAME.match(e["name"])
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k], e
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                              "higher")


def test_cells_configs_and_metrics():
    configs = {c["name"]: c for c in MAN["configs"]}
    cells = [w["name"] for w in MAN["workloads"]]
    pairs = {(w["config"], w["traffic"]) for w in MAN["workloads"]}
    assert len(pairs) == len(cells)
    for c in MAN["configs"]:
        f = json.loads((REPO / c["file"]).read_text())
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
    for w in MAN["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        assert (REPO / f"portbench/traffic/{w['traffic']}.json").exists()
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert (REPO / "portbench/metrics"
                / f"{m['name'].split('.')[0]}.py").exists(), m["name"]
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells)
    for cell in cells:
        reported = [m for m in MAN["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in MAN["per_layer"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_references_import_nothing_of_the_program():
    files = sorted((REPO / "portbench/reference").glob("*.py")) \
        + [REPO / "portbench/weights.py"]
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"repro_torch", "repro", "jax", "jaxlib",
                           "flax"}, (f, tops)
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.dense_gqa, "
            "portbench.reference.deepseek_moe; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    assert "repro_torch" not in out and "'repro'" not in out
