"""PyTorch port, pretrained loading, against the JAX package: reference
torch checkpoints (torchvision key layouts, written as oracles in
tests/test_ckpt.py) grafted into the tiny flagship by both packages, the
converters' layouts, the whole-model ``--pretrained`` graft, and the
refusals.

Tolerances: the two weight routes into the port, the JAX converter plus
``load_flax_variables`` and the port's own loader, give bit-equal models
(the conversions are transposes); converted trees are equal to the JAX
converter's exactly; the eval-step logits after the unimodal graft within
1e-4 absolute and relative of the JAX eval step's (float32 convolution
sums in another order, as tests/test_torch_adamml.py); the LSTM cell
within 1e-5 relative / 1e-6 absolute of ``torch.nn.LSTMCell``.
"""

import json

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from adamml_tpu.ckpt import pretrained as jpre
from adamml_tpu.ckpt import torch_convert as jconv
from adamml_tpu.models import joint_net as jjoint
from adamml_tpu.models import model_builder as jbuilder
from adamml_tpu.models import policy_net as jpolicy
from adamml_tpu.train import steps as jsteps
from adamml_tpu.train.train_state import AdaMMLTrainState
from adamml_tpu_torch.ckpt import pretrained as tpre
from adamml_tpu_torch.ckpt import torch_convert as tconv
from adamml_tpu_torch.ckpt.checkpoint import save_checkpoint
from adamml_tpu_torch.ckpt.flax_convert import flax_leaves, load_flax_variables
from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.models import joint_net as tjoint
from adamml_tpu_torch.models import model_builder as tbuilder
from adamml_tpu_torch.models import policy_net as tpolicy
from adamml_tpu_torch.train import steps as tsteps
from adamml_tpu_torch.train.train_state import EvalState, TrainState

from test_ckpt import (TorchDli14MobileNetV2, TorchMobileNetV2,
                       TorchResNet18, _randomize_bn_stats)
from test_torch_adamml import TOL, _center_rgb_decisions, _inputs
from torch_parity import (flax_variables, one_torch_thread, t,  # noqa: F401
                          zero_noise_jax, zero_noise_torch)

MODALITY = ["rgb", "sound"]
CLASSES = 5  # the tiny flagship's


def _reference_files(folder, rgb_classes=CLASSES, drop=None):
    """rgb.pth: a torchvision ResNet-18 as {'state_dict': ...} with the DDP
    'module.' prefix; sound.pth.tar: a torchvision MobileNetV2 (3 input
    channels, inflated to 1 by the loaders), plain state dict."""
    torch.manual_seed(0)
    rgb = TorchResNet18(num_classes=rgb_classes)
    _randomize_bn_stats(rgb, seed=3)
    sound = TorchMobileNetV2(num_classes=CLASSES)
    _randomize_bn_stats(sound, seed=4)
    sd = {f"module.{k}": v for k, v in rgb.state_dict().items()
          if k != drop}
    paths = [str(folder / "rgb.pth"), str(folder / "sound.pth.tar")]
    torch.save({"state_dict": sd, "epoch": 3}, paths[0])
    torch.save(sound.state_dict(), paths[1])
    return paths, rgb, sound


def _models():
    """(port cfg, JAX model, flax variables, inputs) of the tiny flagship,
    the same random weights on both sides."""
    cfg = flagship_cfg(tiny=True)
    jcfg = graft._flagship_cfg(tiny=True)
    rs = np.random.RandomState(0)
    x = _inputs(cfg, rs)
    jmodel, _ = jbuilder.build_model(jcfg)
    v = flax_variables(jmodel, rs, [jnp.asarray(a) for a in x], train=False)
    return cfg, jmodel, v, x


def _port(cfg, v):
    model, _ = tbuilder.build_model(cfg, device="cpu")
    return load_flax_variables(model, v["params"], v["batch_stats"])


@pytest.fixture(scope="module")
def routes(tmp_path_factory):
    """Route (a): the JAX loader, then load_flax_variables; route (b): the
    port's loader straight from the files. Both start from the same
    weights."""
    cfg, jmodel, v, x = _models()
    paths, rgb, sound = _reference_files(tmp_path_factory.mktemp("ref"))
    jstate = jpre.load_unimodality_pretrained(
        AdaMMLTrainState.create(v["params"], v["batch_stats"], None, None),
        MODALITY, paths, depth=18)
    a = _port(cfg, {"params": jstate.params,
                    "batch_stats": jstate.batch_stats})
    b = _port(cfg, v)
    tpre.load_unimodality_pretrained(b, MODALITY, paths, depth=18)
    return dict(cfg=cfg, jmodel=jmodel, v=v, x=x, jstate=jstate, a=a, b=b,
                rgb=rgb, sound=sound, paths=paths)


def _assert_models_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_two_routes_give_bit_equal_models(routes):
    _assert_models_equal(routes["a"], routes["b"])
    # and the graft took: the backbones hold the reference tensors
    sd = routes["b"].state_dict()
    ref = routes["rgb"].state_dict()
    assert torch.equal(sd["main_net.net_rgb.layer3_1.cb2.conv.weight"],
                       ref["layer3.1.conv2.weight"])
    assert torch.equal(sd["main_net.net_rgb.fc.weight"], ref["fc.weight"])
    assert torch.equal(sd["main_net.net_rgb.bn1.running_var"],
                       ref["bn1.running_var"])
    assert torch.equal(sd["main_net.net_sound.classifier.bias"],
                       routes["sound"].state_dict()["classifier.1.bias"])


def test_eval_logits_after_the_graft_match_jax(routes, monkeypatch):
    """The JAX eval step on the JAX-grafted weights against the port's on
    the port-grafted weights (zero-noise decisions, centred as in
    tests/test_torch_adamml.py so both paths of the rgb backbone run)."""
    b, x, jstate = routes["b"], routes["x"], routes["jstate"]
    target = np.random.RandomState(1).randint(0, CLASSES, len(x[0]))
    monkeypatch.setattr(tpolicy, "gumbel_decision", zero_noise_torch)
    monkeypatch.setattr(jpolicy, "gumbel_decision", zero_noise_jax)
    _center_rgb_decisions(b, x, jstate.params)
    state = AdaMMLTrainState.create(jstate.params, jstate.batch_stats, None,
                                    None)
    jlogits, jdec, jloss = jsteps.make_adamml_eval_step(routes["jmodel"])(
        state, [jnp.asarray(a) for a in x], jnp.asarray(target),
        jax.random.PRNGKey(0))
    logits, dec, loss = tsteps.make_adamml_eval_step(b)(
        EvalState(), [t(a) for a in x], t(target), 0)
    assert 0 < float(np.asarray(jdec)[:, :, 0].sum()) < jdec[:, :, 0].size
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=TOL, rtol=TOL)


def test_module_prefix_is_stripped(routes):
    sd = {f"module.{k}": v.numpy()
          for k, v in routes["rgb"].state_dict().items()}
    stripped = tconv.strip_module_prefix(sd)
    assert not any(k.startswith("module.") for k in stripped)
    assert stripped.keys() == jconv.strip_module_prefix(sd).keys()
    for k, v in routes["rgb"].state_dict().items():
        np.testing.assert_array_equal(stripped[k], v.numpy())


def test_sound_first_conv_is_inflated(routes):
    """torchvision's 3-channel first conv, averaged over RGB, into the
    1-channel spectrogram backbone."""
    w = routes["sound"].state_dict()["features.0.0.weight"]
    got = routes["b"].state_dict()["main_net.net_sound.features_0.conv.weight"]
    assert tuple(got.shape) == (32, 1, 3, 3)
    np.testing.assert_array_equal(
        got.numpy(), tconv.inflate_first_conv(w.numpy(), 1))
    np.testing.assert_array_equal(
        tconv.inflate_first_conv(w.numpy(), 10),
        jconv.inflate_first_conv(w.numpy(), 10))


def test_fc2_fusion_pops_the_heads(tmp_path):
    """Under fc2 fusion the backbones have no heads: the reference fc and
    classifier are dropped, and the two routes agree bit for bit. (The
    AdaMML model masks decisions at the logits, so fc2 is a main net of its
    own here, under ``main_net`` as in the AdaMML model.)"""
    kw = dict(modality=("rgb", "sound"), depth=18, num_classes=CLASSES,
              fusion_point="fc2")
    xs = [jnp.zeros((2, 4, 32, 32, 3)), jnp.zeros((2, 1, 256, 32, 1))]
    v = flax_variables(jjoint.JointMainNet(**kw), np.random.RandomState(0),
                       xs, train=False)
    v = {"params": {"main_net": v["params"]},
         "batch_stats": {"main_net": v["batch_stats"]}}
    paths, rgb, _ = _reference_files(tmp_path)
    jstate = jpre.load_unimodality_pretrained(
        AdaMMLTrainState.create(v["params"], v["batch_stats"], None, None),
        MODALITY, paths, depth=18, fusion_point="fc2")
    models = []
    for tree in (jstate, None):
        model = nn.Module()
        model.main_net = tjoint.JointMainNet(**kw)
        if tree is None:
            load_flax_variables(model, v["params"], v["batch_stats"])
            tpre.load_unimodality_pretrained(model, MODALITY, paths,
                                             depth=18, fusion_point="fc2")
        else:
            load_flax_variables(model, tree.params, tree.batch_stats)
        models.append(model)
    _assert_models_equal(*models)
    sd = models[1].state_dict()
    assert not any(k.startswith(("main_net.net_rgb.fc.",
                                 "main_net.net_sound.classifier."))
                   for k in sd)
    assert torch.equal(sd["main_net.net_rgb.conv1.weight"],
                       rgb.state_dict()["conv1.weight"])


def test_strict_refuses_a_wrong_shape(tmp_path):
    """A 6-class reference head into the 5-class backbone: both packages
    raise, and the port writes nothing."""
    cfg, _, v, _ = _models()
    paths, _, _ = _reference_files(tmp_path, rgb_classes=6)
    with pytest.raises(ValueError, match="shape mismatch"):
        jpre.load_unimodality_pretrained(
            AdaMMLTrainState.create(v["params"], v["batch_stats"], None,
                                    None), MODALITY, paths, depth=18)
    model = _port(cfg, v)
    before = {k: x.clone() for k, x in model.state_dict().items()}
    with pytest.raises(ValueError,
                       match="shape mismatch at main_net.net_rgb.fc.weight"):
        tpre.load_unimodality_pretrained(model, MODALITY, paths, depth=18)
    for k, x in model.state_dict().items():
        assert torch.equal(x, before[k]), k


def test_strict_refuses_a_missing_key(tmp_path):
    """A reference file without one BN buffer fails conversion in both
    packages; a port checkpoint with a tensor the backbone lacks fails the
    graft."""
    cfg, _, v, _ = _models()
    paths, _, _ = _reference_files(tmp_path,
                                   drop="layer1.0.bn1.running_var")
    with pytest.raises(KeyError, match="layer1.0.bn1.running_var"):
        jpre.load_unimodality_pretrained(
            AdaMMLTrainState.create(v["params"], v["batch_stats"], None,
                                    None), MODALITY, paths, depth=18)
    model = _port(cfg, v)
    with pytest.raises(KeyError, match="layer1.0.bn1.running_var"):
        tpre.load_unimodality_pretrained(model, MODALITY, paths, depth=18)
    sd = dict(model.main_net.net_rgb.state_dict())
    sd["bogus.weight"] = torch.zeros(3)
    ckpt = _port_checkpoint(tmp_path / "extra", sd)
    with pytest.raises(KeyError,
                       match="missing key in target: main_net.net_rgb.bogus"):
        tpre.load_unimodality_pretrained(model, ["rgb"], [ckpt], depth=18)


def _port_checkpoint(folder, model_sd, temperature=5.0):
    folder.mkdir(parents=True)
    torch.save({"model": model_sd, "temperature": temperature},
               folder / "state.pt")
    (folder / "meta.json").write_text(json.dumps({"optim_layout": "torch"}))
    return str(folder)


def test_unimodal_graft_from_port_checkpoints(tmp_path):
    """Unimodal checkpoint directories of the port (a backbone's state dict
    at the top level) land in main_net.net_<m> bit for bit."""
    cfg, _, v, _ = _models()
    src = _port(cfg, v)
    tbuilder.init_model(src, seed=9)
    paths = [_port_checkpoint(tmp_path / m, getattr(
        src.main_net, f"net_{m}").state_dict()) for m in MODALITY]
    dst = _port(cfg, v)
    tpre.load_unimodality_pretrained(dst, MODALITY, paths, depth=18)
    for m in MODALITY:
        _assert_models_equal(getattr(dst.main_net, f"net_{m}"),
                             getattr(src.main_net, f"net_{m}"))
    assert not torch.equal(dst.policy_net.lstm.ih.weight,
                           src.policy_net.lstm.ih.weight)


def test_pretrained_grafts_weights_and_temperature(tmp_path):
    """--pretrained: every parameter and BN buffer of a port checkpoint,
    and its temperature; a checkpoint of another head width grafts the
    rest; one with nothing in common is refused."""
    cfg = flagship_cfg(tiny=True)
    src, _ = tbuilder.build_model(cfg, device="cpu")
    tbuilder.init_model(src, seed=4)
    with torch.no_grad():
        for name, buf in src.named_buffers():
            buf.add_(0.25)
    save_checkpoint(src, TrainState(torch.optim.SGD(src.parameters(), 0.1),
                                    None, temperature=3.25),
                    {"epoch": 1}, str(tmp_path / "run"))
    dst, _ = tbuilder.build_model(cfg, device="cpu")
    state = TrainState(None, None, temperature=5.0)
    n = tpre.load_pretrained_adamml(dst, state,
                                    str(tmp_path / "run" / "checkpoint"))
    assert n == len(list(dst.parameters()))
    _assert_models_equal(dst, src)
    assert state.temperature == 3.25

    cfg6 = flagship_cfg(tiny=True)
    cfg6.model.num_classes = 6
    other, _ = tbuilder.build_model(cfg6, device="cpu")
    _port_checkpoint(tmp_path / "six", other.state_dict(), 2.0)
    fresh, _ = tbuilder.build_model(cfg, device="cpu")
    heads = {k: x.clone() for k, x in fresh.state_dict().items()
             if k.startswith(("main_net.net_rgb.fc.",
                              "main_net.net_sound.classifier."))}
    n = tpre.load_pretrained_adamml(fresh, state, str(tmp_path / "six"))
    assert n == len(list(fresh.parameters())) - len(heads)
    assert state.temperature == 2.0
    for k, x in heads.items():  # shape mismatch: skipped, not written
        assert torch.equal(fresh.state_dict()[k], x)
    assert torch.equal(fresh.policy_net.lstm.ih.weight,
                       other.policy_net.lstm.ih.weight)

    _port_checkpoint(tmp_path / "backbone",
                     other.main_net.net_rgb.state_dict())
    with pytest.raises(ValueError, match="no parameters matched"):
        tpre.load_pretrained_adamml(fresh, state, str(tmp_path / "backbone"))


@pytest.mark.parametrize("loader", ["pretrained", "unimodality_pretrained"])
def test_orbax_checkpoint_is_refused_by_name(tmp_path, loader):
    """A JAX package checkpoint (orbax, layout tag 'fused') is named as
    such, with the tool that would import it."""
    (tmp_path / "meta.json").write_text(json.dumps(
        {"epoch": 1, "optim_layout": "fused"}))
    model, _ = tbuilder.build_model(flagship_cfg(tiny=True), device="cpu")
    with pytest.raises(RuntimeError, match="orbax checkpoint of the JAX "
                       r"package.*convert it with python orbax_to_torch.py"):
        if loader == "pretrained":
            tpre.load_pretrained_adamml(model, TrainState(None, None),
                                        str(tmp_path))
        else:
            tpre.load_unimodality_pretrained(
                model, ["rgb"], [str(tmp_path)], depth=18)


@pytest.mark.parametrize("marker", ["_CHECKPOINT_METADATA", "manifest.ocdbt"])
def test_untagged_orbax_checkpoint_is_refused_by_name(tmp_path, marker):
    """A checkpoint saved outside the JAX curriculum has no layout tag; the
    files orbax writes name it."""
    (tmp_path / "meta.json").write_text(json.dumps({"epoch": 1}))
    (tmp_path / marker).write_text("{}")
    model, _ = tbuilder.build_model(flagship_cfg(tiny=True), device="cpu")
    with pytest.raises(RuntimeError, match="layout None, an orbax checkpoint "
                       "of the JAX package.*convert it with python "
                       "orbax_to_torch.py"):
        tpre.load_pretrained_adamml(model, TrainState(None, None),
                                    str(tmp_path))


def test_path_count_must_match_modalities(tmp_path):
    model, _ = tbuilder.build_model(flagship_cfg(tiny=True), device="cpu")
    with pytest.raises(ValueError, match="number of pretrained models"):
        tpre.load_unimodality_pretrained(model, MODALITY, [str(tmp_path)],
                                         depth=18)


def _assert_trees_equal(a, b, where=""):
    assert a.keys() == b.keys(), where
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{where}/{k}")
        else:
            assert a[k].dtype == b[k].dtype, f"{where}/{k}"
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where}/{k}")


@pytest.mark.parametrize("layout", ["torchvision", "d-li14"])
def test_mobilenet_layouts_match_jax_and_fill_the_trunk(layout):
    """Both MobileNetV2 layouts convert to the JAX converter's tree exactly,
    and (without the head) fill a policy trunk of the port name for
    name."""
    torch.manual_seed(1)
    tm = (TorchMobileNetV2(num_classes=6) if layout == "torchvision"
          else TorchDli14MobileNetV2(num_classes=6))
    _randomize_bn_stats(tm, seed=5)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    got = tconv.convert_mobilenet_v2_state_dict(sd, layout=layout)
    want = jconv.convert_mobilenet_v2_state_dict(sd, layout=layout)
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    trunk = tbuilder.build_model(flagship_cfg(tiny=True),
                                 device="cpu")[0].policy_net.net_rgb
    bp, bs = tconv.convert_mobilenet_v2_state_dict(sd, layout=layout,
                                                   include_head=False)
    leaves = [(name, torch.from_numpy(np.ascontiguousarray(x)))
              for _, name, x in flax_leaves(bp, bs)]
    assert tpre._graft(trunk, leaves, strict=True) == len(
        list(trunk.parameters()))
    assert {name for name, _ in leaves} == set(trunk.state_dict())


def test_lstm_cell_matches_jax_and_torch_gate_order():
    """torch LSTMCell weights: the port's conversion equals the JAX one,
    and the port's decision cell, so loaded, steps like the LSTMCell
    (gates i, f, g, o)."""
    model, _ = tbuilder.build_model(flagship_cfg(tiny=True), device="cpu")
    lstm = model.policy_net.lstm
    n_in, hidden = lstm.ih.weight.shape[1], lstm.hh.weight.shape[1]
    torch.manual_seed(2)
    cell = nn.LSTMCell(n_in, hidden)
    sd = {f"module.lstm.{k}": v.numpy() for k, v in cell.state_dict().items()}
    got = tconv.convert_lstm_cell(sd)
    _assert_trees_equal(got, jconv.convert_lstm_cell(sd))
    leaves = [(name, torch.from_numpy(np.ascontiguousarray(x)))
              for _, name, x in flax_leaves(got, {})]
    assert tpre._graft(lstm, leaves, strict=True) == 4
    rs = np.random.RandomState(3)
    x = t(rs.randn(4, n_in).astype(np.float32))
    h0 = t(rs.randn(4, hidden).astype(np.float32))
    c0 = t(rs.randn(4, hidden).astype(np.float32))
    feat_dim = n_in - 2 * lstm.num_modality
    with torch.no_grad():
        want_h, want_c = cell(x, (h0, c0))
        (h, c, _), _ = lstm((h0, c0, x[:, feat_dim:]), x[:, :feat_dim], 5.0,
                            torch.Generator().manual_seed(0))
    torch.testing.assert_close(h, want_h, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(c, want_c, rtol=1e-5, atol=1e-6)
