"""PyTorch port, the slice as a whole: the tiny flagship AdaMML forward and
eval step against the JAX package (weights carried by load_flax_variables),
the converter's completeness checks, the port's freedom from JAX, and its
entry points' device rules.

Float32 (``_flagship_cfg(tiny=True)``: depth 18, 4 frames, 2 segments, 32x32,
5 classes). Gumbel noise is patched to zero-noise argmax on both sides, as
tests/test_parity_full.py does. Decisions must be exactly equal; logits and
loss within 1e-4 (float32 convolution sums in another order).
"""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from adamml_tpu.models import model_builder as jbuilder
from adamml_tpu.models import policy_net as jpolicy
from adamml_tpu.train import steps as jsteps
from adamml_tpu.train.train_state import AdaMMLTrainState
import adamml_tpu_torch
from adamml_tpu_torch.ckpt.flax_convert import load_flax_variables
from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.models import model_builder as tbuilder
from adamml_tpu_torch.models import policy_net as tpolicy
from adamml_tpu_torch.ops.augment import policy_stream
from adamml_tpu_torch.train import steps as tsteps
from adamml_tpu_torch.train.train_state import EvalState

from torch_parity import (flax_variables, one_torch_thread, t,  # noqa: F401
                          zero_noise_jax, zero_noise_torch)

REPO = Path(__file__).resolve().parents[1]
N = 4
TOL = 1e-4


def _inputs(cfg, rs):
    s = cfg.model.num_segments
    return [rs.randn(*tbuilder.modality_input_shape(cfg, m, N, s)).astype(
        np.float32) for m in cfg.model.modality]


def _center_rgb_decisions(tmodel, x, params):
    """Shift the rgb decision head's 'on' bias to the median margin, so the
    zero-noise rgb decisions are mixed and the ResNet path (and its fused
    epilogue) reaches the fused logits. Writes the same bias into the flax
    tree."""
    pol = tmodel.policy_net
    bias = params["policy_net"]["lstm"]["fc_0"]["bias"]
    size = tmodel.policy_input_size

    def margins():
        with torch.no_grad():
            _, logits = pol([policy_stream(t(x[0]), size), t(x[1])], 5.0)
        return (logits[:, 0, :, 1] - logits[:, 0, :, 0]).flatten()

    for _ in range(3):
        bias[1] -= float(margins().median()) + 1e-3
        with torch.no_grad():
            pol.lstm.fc_0.bias.copy_(torch.from_numpy(bias))
    # far enough from a tie that float32 reordering cannot flip a decision
    assert margins().abs().min() > 1e-4


def make_bundle(use_pallas_dw=False):
    """(cfg, port model, flax variables, inputs, target, the JAX eval
    step's results) of the tiny flagship, zero-noise decisions centred."""
    cfg = flagship_cfg(tiny=True)
    jcfg = graft._flagship_cfg(tiny=True)
    cfg.model.use_pallas_dw = jcfg.model.use_pallas_dw = use_pallas_dw
    rs = np.random.RandomState(0)
    x = _inputs(cfg, rs)
    target = rs.randint(0, cfg.model.num_classes, N)
    jmodel, _ = jbuilder.build_model(jcfg)
    v = flax_variables(jmodel, rs, [jnp.asarray(a) for a in x], train=False)
    tmodel, _ = tbuilder.build_model(cfg, device="cpu")
    load_flax_variables(tmodel, v["params"], v["batch_stats"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpolicy, "gumbel_decision", zero_noise_torch)
        _center_rgb_decisions(tmodel, x, v["params"])
        mp.setattr(jpolicy, "gumbel_decision", zero_noise_jax)
        state = AdaMMLTrainState.create(v["params"], v["batch_stats"], None,
                                        None)
        logits, dec, loss = jsteps.make_adamml_eval_step(jmodel)(
            state, [jnp.asarray(a) for a in x], jnp.asarray(target),
            jax.random.PRNGKey(0))
        want = {"logits": np.asarray(logits), "decisions": np.asarray(dec),
                "loss": float(loss),
                **{k: float(m) for k, m in jsteps._topk_metrics(
                    logits, jnp.asarray(target)).items()}}
    return cfg, tmodel, v, x, target, want


@pytest.fixture(scope="module")
def bundle():
    return make_bundle()


@pytest.fixture
def zero_noise(monkeypatch):
    monkeypatch.setattr(tpolicy, "gumbel_decision", zero_noise_torch)


def test_decisions_are_mixed(bundle):
    """Guard on the fixture: some rgb segments on, some off."""
    want = bundle[-1]["decisions"]
    assert want.shape == (N, 2, 2)
    assert 0 < want[:, :, 0].sum() < want[:, :, 0].size


def test_adamml_forward(bundle, zero_noise):
    cfg, tmodel, _, x, _, want = bundle
    with torch.no_grad():
        logits, dec = tmodel([t(a) for a in x], 5.0)
    assert logits.dtype == torch.float32
    np.testing.assert_array_equal(dec.numpy(), want["decisions"])
    np.testing.assert_allclose(logits.numpy(), want["logits"], atol=TOL,
                               rtol=TOL)


def test_eval_step(bundle, zero_noise):
    cfg, tmodel, _, x, target, want = bundle
    step = tsteps.make_adamml_eval_step(tmodel)
    logits, dec, loss = step(EvalState(), [t(a) for a in x], t(target), 0)
    np.testing.assert_array_equal(dec.numpy(), want["decisions"])
    np.testing.assert_allclose(logits.numpy(), want["logits"], atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(loss.item(), want["loss"], atol=TOL, rtol=TOL)
    metrics = tsteps._topk_metrics(logits, t(target))
    for k in ("top1", "top5"):
        assert float(metrics[k]) == want[k]


def test_plain_composition_matches_fused(bundle, zero_noise):
    """fused_tpool=False (temporal pool after relu(bn + identity)) gives the
    fused path's result on the same weights (float32: within 1e-5)."""
    cfg, tmodel, v, x, _, _ = bundle
    cfg_plain = flagship_cfg(tiny=True)
    cfg_plain.model.fused_tpool = False
    plain, _ = tbuilder.build_model(cfg_plain, device="cpu")
    plain.load_state_dict(tmodel.state_dict())
    with torch.no_grad():
        l1, d1 = tmodel([t(a) for a in x], 5.0)
        l2, d2 = plain([t(a) for a in x], 5.0)
    assert torch.equal(d1, d2)
    torch.testing.assert_close(l1, l2, atol=1e-5, rtol=1e-5)


def test_eval_step_draws_seeded_noise(bundle):
    """Real Gumbel noise at eval: decisions in {0, 1}, the same seed and
    step give the same result, and the step counter moves the noise."""
    cfg, tmodel, _, x, target, _ = bundle
    step = tsteps.make_adamml_eval_step(tmodel)
    inputs = [t(a) for a in x]
    runs = [step(EvalState(step=k), inputs, t(target), 7) for k in (0, 0)]
    assert set(runs[0][1].unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(runs[0][0], runs[1][0])
    assert tsteps.step_seed(7, 0) != tsteps.step_seed(7, 1)
    # three identical crops folded crop-major into the batch: their mean is
    # the single crop's logits, and the centre crop's noise is drawn too
    step3 = tsteps.make_adamml_eval_step(tmodel, num_crops=3)
    logits3, dec3, _ = step3(EvalState(), [a.repeat_interleave(3, 0)
                                           for a in inputs], t(target), 7)
    assert tuple(logits3.shape) == tuple(runs[0][0].shape)
    assert tuple(dec3.shape) == tuple(runs[0][1].shape)
    assert set(dec3.unique().tolist()) <= {0.0, 1.0}


def test_converter_fills_every_parameter(bundle):
    """Every flax key was consumed and every port tensor filled (the load in
    the fixture raises otherwise); spot-check the layout of each kind."""
    _, tmodel, v, _, _, _ = bundle
    p, st = v["params"], v["batch_stats"]
    sd = tmodel.state_dict()
    rgb = p["main_net"]["net_rgb"]
    np.testing.assert_array_equal(
        sd["main_net.net_rgb.layer1_0.cb1.conv.weight"].numpy(),
        rgb["layer1_0"]["cb1"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["main_net.net_rgb.fc.weight"].numpy(),
                                  rgb["fc"]["kernel"].T)
    dw = p["main_net"]["net_sound"]["features_2"]["dw"]["conv"]["kernel"]
    assert dw.shape[2] == 1
    np.testing.assert_array_equal(
        sd["main_net.net_sound.features_2.dw.conv.weight"].numpy(),
        dw.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["main_net.net_rgb.bn1.running_var"].numpy(),
        st["main_net"]["net_rgb"]["bn1"]["var"])
    np.testing.assert_array_equal(sd["main_net.net_rgb.bn1.weight"].numpy(),
                                  rgb["bn1"]["scale"])
    np.testing.assert_array_equal(sd["main_net.lf_weights"].numpy(),
                                  p["main_net"]["lf_weights"])
    np.testing.assert_array_equal(
        sd["policy_net.lstm.ih.weight"].numpy(),
        p["policy_net"]["lstm"]["ih"]["kernel"].T)
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(v))
    assert n_flax == sum(x.numel() for x in sd.values())


@pytest.mark.parametrize("fault", ["extra", "missing", "shape"])
def test_converter_refuses_incomplete_trees(bundle, fault):
    cfg, _, v, _, _, _ = bundle
    params = jax.tree_util.tree_map(np.copy, v["params"])
    if fault == "extra":
        params["main_net"]["net_rgb"]["bogus"] = {"kernel": np.zeros((1, 1))}
        match = "left unused"
    elif fault == "missing":
        del params["policy_net"]["lstm"]["fc_1"]
        match = "left unfilled"
    else:
        params["main_net"]["lf_weights"] = np.zeros(2, np.float32)
        match = "does not fit"
    fresh, _ = tbuilder.build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match=match):
        load_flax_variables(fresh, params, v["batch_stats"])


_PORT_FILES = sorted((REPO / "adamml_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def test_port_source_names_no_jax():
    """No import statement in the port or chip_smoke.py, at any depth,
    names jax, flax or the JAX package."""
    bad = []
    for path in _PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "flax",
                                           "adamml_tpu")]
    assert bad == []


def test_port_imports_no_jax():
    """Importing every port module and chip_smoke.py, in a fresh process,
    loads no jax, flax or adamml_tpu module."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import adamml_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'adamml_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke',\n"
        "                                              'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'adamml_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = len(list(pkgutil.walk_packages(
        adamml_tpu_torch.__path__, "adamml_tpu_torch.")))
    assert n_modules >= 20


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the refusal needs none")
    cfg = flagship_cfg(tiny=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbuilder.build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbuilder.example_inputs(cfg)
    inputs = tbuilder.example_inputs(cfg, device="cpu", seed=1)
    assert [tuple(a.shape) for a in inputs] == [
        tbuilder.modality_input_shape(cfg, m, 2, 2)
        for m in cfg.model.modality]
    assert torch.equal(inputs[0], tbuilder.example_inputs(
        cfg, device="cpu", seed=1)[0])


def test_rng_policy_baseline():
    cfg = flagship_cfg(tiny=True)
    cfg.model.rng_policy = True
    model, name = tbuilder.build_model(cfg, device="cpu")
    assert model.policy_net is None and "-rng-0.5" in name
    x = tbuilder.example_inputs(cfg, device="cpu")
    with torch.no_grad():
        logits, dec = model(x, generator=torch.Generator().manual_seed(0))
    assert tuple(logits.shape) == (2, 5) and tuple(dec.shape) == (2, 2, 2)
    assert set(dec.unique().tolist()) <= {0.0, 1.0}
