"""A run rehearsed on the CPU at a tiny size: the harness's look for a card
is skipped and its internal functions drive the rest, down to the result
line; and run.py itself refuses to run without a card or without the
program."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def rehearse(name: str, trace: bool, **traffic):
    cell = tiny.cell(name, **traffic)
    # a traced window reaches the stretch: the profile starts a dispatch
    # (a request) before it
    out = harness.entry(cell.traffic["entry"]).run(
        cell, 2 ** 31 + 12345, 5.0 if trace else 2.0, trace,
        torch.device("cpu"),
        __import__("time").perf_counter())
    return cell, out, harness.result_line(cell, out, trace=trace,
                                          kind="cpu", count=1)


@pytest.mark.parametrize("name", ["flagship.train-main", "flagship.serve"])
def test_the_result_line_has_the_required_keys(name):
    cell, out, line = rehearse(name, False)
    assert list(line)[:5] == KEYS and list(line)[-1] == "compared"
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["compared"]) == set(cell.traffic["limits"])
    for value, limit in line["compared"].values():
        assert value == value and limit > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    json.dumps(line)


def test_a_traced_run_reports_only_per_layer_metrics():
    cell, out, line = rehearse("flagship.train-main", True)
    names = {m["name"] for m in cell.per_layer}
    assert set(line["metrics"]) <= names
    # the host-side reading needs no device
    assert "loader_wait_share.train" in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "compared"


def test_a_traced_serve_run_reads_the_latency_tail_unprofiled():
    cell, out, line = rehearse("flagship.serve", True)
    assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    # requests 0 and 1 ran under the profiler (skip_requests 1)
    assert len(out.ctx.latency_s) == out.attempted - 2
    assert line["metrics"]["request_p95_ms.serve"]["value"] > 0


def _run(cwd, code):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_run_refuses_without_a_card():
    got = _run(harness.ROOT, "import sys, runpy; sys.argv = ['run.py', "
               "'--workload', 'flagship.train-main', '--seed', '1', "
               "'--seconds', '1']; runpy.run_path('benchmark/run.py', "
               "run_name='__main__')")
    assert got.returncode != 0 and got.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    # as if a card were there: the run gets as far as the program
    got = _run(tmp_path, "import sys, runpy, torch; "
               "torch.cuda.is_available = lambda: True; "
               "torch.cuda.device_count = lambda: 1; "
               "sys.argv = ['run.py', '--workload', 'flagship.train-main', "
               "'--seed', '1', '--seconds', '1']; "
               "runpy.run_path('benchmark/run.py', run_name='__main__')")
    assert got.returncode != 0 and got.stdout.strip() == ""
    assert "adamml_tpu_torch" in got.stderr
