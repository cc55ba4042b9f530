"""What every cell shares: finding a cell's files by name, the seeds, the
readers of per-layer metrics, the result line.

A cell (an entry of BENCHMARK.json's ``workloads``) names a configuration,
``benchmark/configs/<config>.json``, and a traffic mix,
``benchmark/traffic/<cell>.json``. The mix names its entry,
``benchmark/entries/<entry>.py``, and its data source,
``benchmark/sources/<source>.py``; each per-layer metric has its reader,
``benchmark/metrics/<metric>.py``, whose ``read(ctx)`` returns a number or
None when the run has nothing for it to read.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "adamml_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # benchmark/configs/<config>.json
    traffic: dict         # benchmark/traffic/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    config = json.loads((HERE / "configs" / f"{w['config']}.json")
                        .read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str):
    return importlib.import_module(f"benchmark.entries.{name}")


def source(name: str):
    return importlib.import_module(f"benchmark.sources.{name}")


def reader(metric: str):
    return load_file(HERE / "metrics" / f"{metric}.py",
                     "benchmark_metric_" + metric.replace(".", "_"))


@dataclasses.dataclass
class Seeds:
    """Independent sub-seeds of a run's ``--seed`` (any whole number)."""

    weights: int
    data: int
    loader: int
    steps: int
    check: int

    @classmethod
    def of(cls, seed: int) -> "Seeds":
        st = np.random.SeedSequence(abs(int(seed))).generate_state(
            5, np.uint32)
        return cls(*(int(v) % (2 ** 31 - 8192) for v in st))


@dataclasses.dataclass
class Outcome:
    """What an entry hands back: end-to-end values by metric name, the
    context the per-layer readers read, the compared numbers."""

    end_to_end: Dict[str, float]
    ctx: object
    attempted: int
    failed: int
    correct: bool
    compared: Dict[str, list]
    memory_peak_bytes: int
    trace: Optional[object] = None   # trace.Trace of the traced stretch


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def banned_modules() -> List[str]:
    return sorted({k.split(".")[0] for k in sys.modules}
                  & set(BANNED))


def result_line(cell: Cell, out: Outcome, *, trace: bool, kind: str,
                count: int) -> dict:
    """The last line of standard output."""
    metrics: Dict[str, dict] = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] not in out.end_to_end:
                raise RuntimeError(f"{cell.name} has no value for "
                                   f"{m['name']}")
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = reader(m["name"]).read(out.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": out.memory_peak_bytes,
              "power_limit": power_limit()}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s()
        device["window_s"] = out.trace.window_s
        line["breakdown"] = {"device_ops": out.trace.top_ops(),
                             "idle_gaps": out.trace.idle_gaps()}
    line["compared"] = out.compared
    return line
