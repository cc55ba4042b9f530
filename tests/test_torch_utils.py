"""PyTorch port, the remaining utils against the JAX package:
``ensemble_score`` and ``--pred_files`` scoring, ``StepProfiler`` on
``torch.profiler``, ``count_model_flops`` on ``FlopCounterMode`` (its gap to
the JAX package's XLA count recorded at the tiny config), ``--show_model``,
and the AdaMML CLI with ``--steps_per_dispatch``, ``--eval_capacity`` and
``--profile_dir`` on the CPU.

Host arithmetic compares exactly or to float64 rounding (1e-12).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from adamml_tpu.cli import train_adamml as jcli
from adamml_tpu.models import model_builder as jbuilder
from adamml_tpu.utils import ensemble as jensemble
from adamml_tpu.utils import flops as jflops
from adamml_tpu_torch.cli import train_adamml as tcli
from adamml_tpu_torch.cli import train_unimodal as tuni
from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.models import model_builder as tbuilder
from adamml_tpu_torch.utils import ensemble as tensemble
from adamml_tpu_torch.utils.flops import count_model_flops
from adamml_tpu_torch.utils.profiling import StepProfiler

from test_torch_cli import TINY
from torch_parity import one_torch_thread  # noqa: F401

TOL = 1e-12


@pytest.fixture(scope="module")
def pred_files(tmp_path_factory):
    """Three (12, 6) logits files and integer labels."""
    d = tmp_path_factory.mktemp("preds")
    rs = np.random.RandomState(0)
    paths = []
    for i in range(3):
        p = str(d / f"val_{i}.npy")
        np.save(p, (rs.randn(12, 6) * 2).astype(np.float32))
        paths.append(p)
    return paths, rs.randint(0, 6, 12)


@pytest.mark.parametrize("after_softmax", [False, True],
                         ids=["logits", "softmax"])
@pytest.mark.parametrize("weights", [None, [0.5, 1.0, 2.0]],
                         ids=["unweighted", "weighted"])
def test_ensemble_score_matches_jax(pred_files, weights, after_softmax):
    paths, labels = pred_files
    want = jensemble.ensemble_score(paths, labels, pred_weights=weights,
                                    after_softmax=after_softmax)
    got = tensemble.ensemble_score(paths, labels, pred_weights=weights,
                                   after_softmax=after_softmax)
    for k in ("top1", "top5", "mAP"):
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=TOL)
    with pytest.raises(ValueError, match="pred_weights"):
        tensemble.ensemble_score(paths, labels, pred_weights=[1.0])


def test_pred_files_cli_matches_jax(tmp_path, capsys):
    """--pred_files on a synthetic val set: the port's CLI scores the files
    against the same labels and prints the JAX CLI's line."""
    argv = TINY + ["--synthetic_length", "10"]
    rs = np.random.RandomState(1)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"val_{i}.npy"))
        np.save(paths[-1], rs.randn(10, 31).astype(np.float32))
    argv += ["--pred_files", *paths, "--pred_weights", "1.0", "0.5",
             "--after_softmax"]
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert tcli.main(argv, device="cpu") == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want and got.startswith("Ensemble of 2 prediction")


def test_step_profiler_writes_a_trace(tmp_path):
    """Steps [2, 5) of 7 are traced (the ops of those steps only) and the
    trace is written as Chrome JSON; a profiler with no directory records
    nothing."""
    prof = StepProfiler(str(tmp_path / "traces"), start_step=2, num_steps=3)
    x = torch.ones(4)
    for i in range(7):
        prof.step(i)
        with torch.profiler.record_function(f"step_{i}"):
            x = x * 2
    prof.close()
    files = glob.glob(str(tmp_path / "traces" / "*.pt.trace.json"))
    assert files == [prof.path]
    with open(prof.path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"step_2", "step_3", "step_4"} <= names
    assert not names & {"step_0", "step_1", "step_5", "step_6"}
    off = StepProfiler(None)
    for i in range(5):
        off.step(i)
    off.close()
    assert off.path is None


def test_count_model_flops_hand_count():
    """A conv (3x3, 3 -> 8 channels, no padding, on 10x10) and a dense
    layer (8*8*8 -> 5) at batch 2: 2 FLOPs per multiply-add, elementwise
    work (bias, ReLU) not counted."""
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3), torch.nn.ReLU(),
                                torch.nn.Flatten(),
                                torch.nn.Linear(8 * 8 * 8, 5))
    conv_macs = 2 * 8 * 8 * 8 * (3 * 3 * 3)
    dense_macs = 2 * (8 * 8 * 8) * 5
    assert count_model_flops(model, torch.randn(2, 3, 10, 10)) == 2 * (
        conv_macs + dense_macs)


def test_count_model_flops_against_xla_at_the_tiny_config():
    """The tiny flagship's eval forward at batch 1: the port counts the
    matmuls' and convolutions' multiply-adds; XLA's cost analysis (the JAX
    package's count) adds elementwise work and counts some ops otherwise,
    so the two are not equal. Recorded in PERF.md; held here: the port's
    count is positive and within 30% of XLA's."""
    cfg = flagship_cfg(tiny=True)
    jcfg = graft._flagship_cfg(tiny=True)
    tmodel, _ = tbuilder.build_model(cfg, device="cpu")
    x = tbuilder.example_inputs(cfg, batch=1, device="cpu")
    port = count_model_flops(tmodel, x, train=False,
                             generator=torch.Generator().manual_seed(0))
    jmodel, _ = jbuilder.build_model(jcfg)
    jx = [jnp.asarray(a.numpy()) for a in x]
    rngs = {"params": jax.random.PRNGKey(0),
            "gumbel": jax.random.PRNGKey(1)}
    v = jax.eval_shape(lambda: jmodel.init(rngs, jx, train=False))
    v = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), v)
    xla = jflops.count_model_flops(jmodel, v, jx, train=False,
                                   rngs={"gumbel": jax.random.PRNGKey(2)})
    print(f"count_model_flops tiny flagship, batch 1: port {port}, "
          f"XLA {xla}, port/XLA {port / xla:.4f}")
    assert port > 0 and abs(port - xla) <= 0.3 * xla


@pytest.mark.parametrize("cli", ["train_adamml", "train_unimodal"])
def test_show_model_prints_flops(cli, capsys, tmp_path):
    argv = TINY + ["--show_model", "--logdir", str(tmp_path)]
    if cli == "train_adamml":
        assert tcli.main(argv, device="cpu") == 0
    else:
        argv = [a for a in argv if a not in ("sound",)] + [
            "--backbone_net", "resnet"]
        assert tuni.main(argv, device="cpu") == 0
    out = capsys.readouterr().out
    assert "Total params:" in out
    line = [ln for ln in out.splitlines() if ln.startswith("Total flops")]
    assert len(line) == 1 and "GFLOPs (fwd, batch 1)" in line[0], line


def test_adamml_cli_with_multi_step_capacity_and_profile(tmp_path, capsys):
    """The tiny curriculum through the CLI with --steps_per_dispatch 2
    (5 batches a pass: two dispatches of 2 and a single step),
    --eval_capacity 0.5 and --profile_dir: every stage runs, the
    validations report their epochs, and each pass's first epoch writes a
    trace from loader index 4 on, after the dispatch that captures the
    graph on a card (here the single tail step), with its counters and
    capture maps beside it."""
    traces = tmp_path / "traces"
    argv = TINY + ["--synthetic_length", "40", "--steps_per_dispatch", "2",
                   "--eval_capacity", "0.5", "--profile_dir", str(traces),
                   "--logdir", str(tmp_path / "logs")]
    assert tcli.main(argv, device="cpu") == 0
    files = glob.glob(str(traces / "*.pt.trace.json"))
    # warmup, alternating main, alternating policy, finetune
    assert len(files) == 4
    assert all(os.path.basename(f).startswith("steps_4-8_") for f in files)
    for f in files:
        with open(f.replace(".pt.trace.json", ".spans.json")) as g:
            assert json.load(g)["counters"]["data.collate"]["count"]
    log = glob.glob(str(tmp_path / "logs" / "*" / "log.log"))
    with open(log[0]) as f:
        text = f.read()
    assert text.count("Val: [") == 2
    assert "Stage [Post finetuning]" in text
    assert os.path.isdir(os.path.dirname(log[0]))
