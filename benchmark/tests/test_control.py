"""The control comes out as not correct: the reference in the program's
place, its convolutions and matmuls rounded to float8 (one precision below
the configurations' bfloat16), fails at least one of the cell's compared
numbers, and so does each fault that benchmark/tools/control.py reads from
the reference.

At a tiny size on the CPU here; at the cells' own size on a card, where
the test runs only with a card present (three seeds a cell, about two
minutes a train cell)."""

import pytest
import torch

from benchmark import check, harness
from benchmark.tests import tiny
from benchmark.tests.test_rehearsal import few_threads  # noqa
from benchmark.tools import control

CELLS = ["flagship.train-main", "rgbflow.train-main", "flagship.serve"]


def fails(cell, numbers) -> bool:
    return not check.verdict(numbers, cell.traffic["limits"])[0]


@pytest.mark.parametrize("name", ["flagship.train-main", "flagship.serve"])
def test_control_and_faults_fail_at_a_tiny_size(name):
    cell = tiny.cell(name)
    for kind, numbers in control.readings(cell, 3, torch.device("cpu")
                                          ).items():
        assert fails(cell, numbers), (kind, numbers)


@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_at_the_cells_size_on_a_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    names = [w["name"] for w in __import__("json").loads(
        (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
    if name not in names:
        pytest.skip(f"{name} is not a cell of BENCHMARK.json")
    cell = harness.load_cell(name)
    for seed in (101, 202, 303):
        for kind, numbers in control.readings(
                cell, seed, torch.device("cuda")).items():
            assert fails(cell, numbers), (seed, kind, numbers)
