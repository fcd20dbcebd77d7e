"""BENCHMARK.json and the files it names: every cell's configuration,
traffic driver and metrics exist and agree, names and units use the
allowed characters, and nothing under benchmark/ imports JAX or the JAX
package (compared by top-level module name)."""

import ast
import importlib.util
import json
import re

import pytest

from conftest import ROOT

BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metric_module(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == KEYS
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_text(kind):
    entries = bench()[kind]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_each_cell_finds_its_files(cell):
    b = bench()
    entry = next(w for w in b["workloads"] if w["name"] == cell)
    w = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    assert w["name"] == cell and w["config"] == entry["config"]
    assert w["chips"] == entry["chips"] and w["why"] == entry["why"]
    assert NAME.match(entry["traffic"])
    assert (BENCH / "traffic" / f"{w['traffic']}.py").exists()
    cfg = next(c for c in b["configs"] if c["name"] == w["config"])
    assert (ROOT / cfg["file"]).exists()
    assert json.loads((ROOT / cfg["file"]).read_text())["name"] == cfg["name"]
    assert set(w["check"]["limits"]) == {"image_rms_levels"}
    reported = {kind: [m["name"] for m in b[kind]
                       if "workloads" not in m or cell in m["workloads"]]
                for kind in ("end_to_end", "per_layer")}
    assert "setup_s" in reported["end_to_end"]
    assert len(reported["end_to_end"]) >= 2 and reported["per_layer"]
    for m in reported["per_layer"]:
        moves = next(x["moves"] for x in b["per_layer"] if x["name"] == m)
        assert moves in reported["end_to_end"], (m, moves)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_files_agree(kind):
    for m in bench()[kind]:
        mod = metric_module(m["name"])
        assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"]
        if kind == "per_layer":
            assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
        assert callable(mod.read)


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in bench()["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in bench()["workloads"]}
    assert used == {c["name"] for c in bench()["configs"]}


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_under_benchmark():
    forbidden = {"jax", "jaxlib", "flax", "imagdressing_tpu"}
    for path in BENCH.rglob("*.py"):
        assert not set(_top_level_imports(path)) & forbidden, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        names = set(_top_level_imports(path))
        assert "imagdressing_tpu_torch" not in names, path


def test_every_metric_file_moves_an_end_to_end_metric_file():
    files = {p.stem: metric_module(p.stem)
             for p in (BENCH / "metrics").glob("*.py")}
    for name, mod in files.items():
        if mod.MOVES is not None:
            assert files[mod.MOVES].MOVES is None, name
