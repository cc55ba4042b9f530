"""BENCHMARK.json against the rules of its format, the files it names, and
the imports of the benchmark's modules (CPU only)."""

import ast
import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert (runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)


@pytest.mark.parametrize("entry", METRICS + BENCH["workloads"]
                         + BENCH["configs"], ids=lambda e: e["name"])
def test_names_units_and_text(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert TEXT.match(entry[key])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_names_are_unique():
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_metric_keys():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_moves_names_a_metric_every_listed_cell_reports():
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E
        for cell in m.get("workloads", list(CELLS)):
            assert cell in CELLS
            assert reports(E2E[m["moves"]], cell), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if reports(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reports(m, cell) for m in BENCH["per_layer"])


def test_one_chip_cells_and_pairs_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    configs = {c["name"] for c in BENCH["configs"]}
    assert configs == {w["config"] for w in BENCH["workloads"]}


WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                    r"_rank$|head|expansion|experts_per)")


def test_config_files():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert not any(WIDTHS.search(k) for k in c["reduced"])


def test_every_file_resolves_by_name():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert harness.entry(cell.traffic["entry"]).run
        assert harness.source(cell.traffic["source"]).make
        assert set(cell.traffic["limits"])
    for m in BENCH["per_layer"]:
        assert harness.reader(m["name"]).read


def _modules(root: Path):
    return sorted(p for p in root.rglob("*.py")
                  if "__pycache__" not in p.parts)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _modules(ROOT / "benchmark"),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere_and_no_program_in_the_reference(path):
    got = set(_imports(path))
    assert not got & set(harness.BANNED), got
    if "reference" in path.relative_to(ROOT / "benchmark").parts:
        assert "adamml_tpu_torch" not in got, got


def test_banned_names_compare_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "adamml_tpu_torch_like",
                        types.ModuleType("adamml_tpu_torch_like"))
    assert "adamml_tpu_torch_like" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert "jax" in harness.banned_modules()
