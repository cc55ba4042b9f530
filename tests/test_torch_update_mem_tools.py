"""PyTorch port: the optimizer-update and memory tools
(``adamml_tpu_torch/tools/bench_update.py``, ``mem_analysis.py``), the
counterparts of tools/bench_update.py and tools/mem_analysis.py, on the
CPU. Their measurements need a card (tests/test_torch_gpu.py); here
bench_update's three rows take three untimed updates at the tiny
flagship's parameters.
"""

import pytest
import torch

from adamml_tpu_torch.tools import bench_update, mem_analysis

from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def rows():
    return bench_update.run(torch.device("cpu"), tiny=True, iters=3,
                            warmup=0)


@pytest.mark.parametrize("optimizer,n,tensors",
                         [("sgd", 13408779, 221), ("adam", 16254916, 324)])
def test_update_rows_agree(rows, optimizer, n, tensors):
    """The per_tensor, foreach and vector rows leave the same parameters
    and state after the same three updates: bit for bit, since all three
    run the same operations in the same order on each element (on the CPU
    the foreach ops run tensor by tensor)."""
    mine = [r for r in rows if r["optimizer"] == optimizer]
    assert [r.get("row") for r in mine[:3]] == list(bench_update.ROWS)
    for r in mine[:3]:
        assert r["parameters"] == n and r["tensors"] == tensors
        assert r["updates"] == 3 and r["ms"] is None
    agreement = mine[3]["agreement"]
    keys = {"sgd": {"param", "momentum_buffer", "step"},
            "adam": {"param", "exp_avg", "exp_avg_sq", "step"}}[optimizer]
    for label in ("per_tensor", "vector"):
        assert set(agreement[label]) == keys
        for k, a in agreement[label].items():
            assert a["bitwise"], (label, k, a)


def test_update_bound_counts_the_bytes(rows):
    """20 bytes a parameter for SGD, 28 for Adam, over 3.35 TB/s."""
    for r in rows:
        if "row" in r:
            per = 20 if r["optimizer"] == "sgd" else 28
            assert r["bound_ms"] == pytest.approx(
                r["parameters"] * per / 3.35e12 * 1e3)


def test_agreement_sees_a_wrong_row():
    """A row one element off is neither bit for bit nor within 1e-6."""
    want = {"param": [torch.ones(4)], "step": []}
    got = {"param": [torch.tensor([1.0, 1.0, 1.0, 1.001])], "step": []}
    a = bench_update._agreement(got, want)["param"]
    assert not a["bitwise"] and a["max_rel_diff"] == pytest.approx(1e-3,
                                                                   rel=1e-3)


def test_mem_analysis_needs_cuda(monkeypatch):
    """On the CPU it raises, naming CUDA, before it builds or allocates
    anything."""
    built = []
    monkeypatch.setattr(mem_analysis, "build_model",
                        lambda *a, **k: built.append(1))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mem_analysis.run(torch.device("cpu"), phase="main", batch=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mem_analysis.main(["--batch", "2"])
    assert built == []


def test_parsers_default_as_the_jax_tools():
    """mem_analysis: the policy phase at batch 24 with the fused epilogue
    and the policy trunks' remat (tools/mem_analysis.py's defaults);
    bench_update: at least 20 timed updates after a warm-up."""
    a = mem_analysis.parse_args([])
    assert (a.phase, a.batch, a.fused_tpool, a.remat_policy) == (
        "policy", 24, 1, 1)
    assert a.remat_stages is None and a.snapshot == ""
    b = mem_analysis.parse_args("--phase main --batch 8 --fused_tpool 0 "
                                "--remat_policy 0 --remat_stages 1 2".split())
    assert (b.phase, b.batch, b.fused_tpool, b.remat_policy,
            b.remat_stages) == ("main", 8, 0, 0, [1, 2])
    u = bench_update.parse_args([])
    assert u.iters >= 20 and u.warmup >= 1
    assert bench_update.LR == 0.01
