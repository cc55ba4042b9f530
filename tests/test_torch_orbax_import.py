"""PyTorch port: the orbax import tool (``orbax_to_torch.py``) against the
JAX package's own checkpoints.

Each JAX checkpoint is written here by
``adamml_tpu.ckpt.checkpoint.save_checkpoint``, with its optimizer state
filled from a numpy seed (a nonzero momentum trace, Adam moments with a
positive nu, count 3), so that no mapping error hides behind zeros. The
import runs ``orbax_to_torch.convert`` in this process; the port reads the
product through its own loaders.

The comparisons use the tiny float32 flagship (depth 18, 4 frames, 2
segments, 5 classes) at tests/test_torch_train.py's step shapes (8 clips at
64x64), dropout 0 and the zero-noise straight-through decision on both
sides, with the rgb decision head centred so both backbones run. One JAX
trace of each phase serves both optimizer layouts: the "per_tensor"
checkpoint holds the "fused" one's values in optax's per-tensor form, and
optax's per-tensor SGD is FusedSGD's function
(tests/test_torch_train.py::test_optimizers_and_clip_match), while the
policy's Adam is per-tensor in both. The CLI cases use
tests/test_torch_cli.py's flags.
"""

import ast
import contextlib
import io
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

import __graft_entry__ as graft
import orbax_to_torch
from adamml_tpu.ckpt import checkpoint as jckpt
from adamml_tpu.ckpt import pretrained as jpre
from adamml_tpu.configs import config as jconfig
from adamml_tpu.models import model_builder as jbuilder
from adamml_tpu.models import policy_net as jpolicy
from adamml_tpu.train import optim as joptim
from adamml_tpu.train import schedulers as jsched
from adamml_tpu.train import steps as jsteps
from adamml_tpu.train.train_state import AdaMMLTrainState
from adamml_tpu.train.train_state import StageFlags as JStageFlags
from adamml_tpu_torch.ckpt import checkpoint as tckpt
from adamml_tpu_torch.ckpt import pretrained as tpre
from adamml_tpu_torch.ckpt.flax_convert import (flax_optimizer_state,
                                                load_flax_variables,
                                                optimizer_state_dict,
                                                unravel_like)
from adamml_tpu_torch.cli import train_adamml
from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.models import model_builder as tbuilder
from adamml_tpu_torch.models import policy_net as tpolicy
from adamml_tpu_torch.train import optim as toptim
from adamml_tpu_torch.train import schedulers as tsched
from adamml_tpu_torch.train import steps as tsteps
from adamml_tpu_torch.train.train_state import (EvalState, StageFlags,
                                                TrainState)

from test_torch_cli import TINY
from test_torch_train import (COST, LR, P_LR, STEP_CLIPS, STEP_INPUT_SIZE,
                              _center_rgb_decisions, _inputs, check_bn_statistics,
                              check_metrics, check_parameters)
from torch_parity import (flax_variables, one_torch_thread,  # noqa: F401
                          st_zero_noise_jax, st_zero_noise_torch, t)

REPO = Path(__file__).resolve().parents[1]
LAYOUTS = ("fused", "per_tensor")
PHASES = ("main", "policy")
COUNT = 3          # Adam steps the checkpoint has taken
TEMPERATURE = 3.5  # the checkpoint's Gumbel temperature
STEP = 11
META = {"epoch": 2, "stage": "alternative_training", "best_top1": 12.5,
        "rng": [7, 42], "scheduler": {"lr": 0.01, "best": 1.5, "num_bad": 2},
        "p_scheduler": {"lr": 0.001, "best": 2.5, "num_bad": 0}}
# tests/test_torch_adamml.py's tolerance for eval logits (float32
# convolution sums in another order)
TOL = 1e-4


def _cfgs(**optim):
    cfg, jcfg = flagship_cfg(tiny=True), graft._flagship_cfg(tiny=True)
    for c in (cfg, jcfg):
        c.model.dropout = 0.0
        c.data.input_size = STEP_INPUT_SIZE
        for k, v in optim.items():
            setattr(c.optim, k, v)
    return cfg, jcfg


def _optax_state(state, **fields):
    """An optax chain state with the named fields of its members
    replaced."""
    return tuple(s._replace(**{k: v for k, v in fields.items()
                               if k in s._fields})
                 if hasattr(s, "_fields") else s for s in state)


def _jax_state(jcfg, params, stats, trace, mu, nu, count=COUNT,
               policy=True):
    """The JAX train state of ``jcfg``'s optimizers (the layout its
    ``fused_update`` picks) holding the given values (as the JAX package
    would after training)."""
    tx_main = joptim.build_optimizer("main", jcfg.optim)
    main_opt = tx_main.init(params["main_net"])
    if isinstance(tx_main, joptim.FusedSGD):
        if main_opt:
            main_opt = {"trace": jnp.asarray(trace)}
    else:
        main_opt = _optax_state(main_opt, trace=unravel_like(
            trace, params["main_net"]))
    policy_opt = None
    if policy:
        policy_opt = _optax_state(
            joptim.build_optimizer("policy", jcfg.optim).init(
                params["policy_net"]),
            count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu)
    state = AdaMMLTrainState.create(params, stats, main_opt, policy_opt,
                                    temperature=TEMPERATURE)
    return state.replace(step=jnp.asarray(STEP, jnp.int32))


def _save(state, folder, meta):
    return jckpt.save_checkpoint(state, meta, str(folder))


@contextlib.contextmanager
def _patched():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpolicy, "gumbel_decision", st_zero_noise_torch)
        mp.setattr(jpolicy, "gumbel_decision", st_zero_noise_jax)
        yield


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """One JAX init of the tiny flagship, its optimizer state drawn from a
    seed, and a checkpoint of each layout, saved by the JAX package and
    imported."""
    tmp = tmp_path_factory.mktemp("orbax")
    cfg, jcfg = _cfgs()
    rs = np.random.RandomState(0)
    x = _inputs(cfg, rs, STEP_CLIPS)
    target = rs.randint(0, cfg.model.num_classes, STEP_CLIPS)
    jmodel, _ = jbuilder.build_model(jcfg)
    v = flax_variables(jmodel, rs, [jnp.asarray(a) for a in x], train=False)
    tmodel, _ = tbuilder.build_model(cfg, device="cpu")
    load_flax_variables(tmodel, v["params"], v["batch_stats"])
    with _patched():
        _center_rgb_decisions(tmodel, x, v["params"])
    n_main = sum(a.size for a in jax.tree_util.tree_leaves(
        v["params"]["main_net"]))
    trace = (rs.randn(n_main) * 1e-2).astype(np.float32)
    shaped = lambda f: jax.tree_util.tree_map(  # noqa: E731
        lambda p: f(p.shape).astype(np.float32), v["params"]["policy_net"])
    mu = shaped(lambda s: rs.randn(*s) * 1e-3)
    nu = shaped(lambda s: rs.uniform(1e-7, 1e-6, s))
    out = dict(cfg=cfg, x=x, target=target, jmodel=jmodel, v=v, trace=trace,
               mu=mu, nu=nu, src={}, dst={}, summary={})
    for layout in LAYOUTS:
        c, jc = _cfgs(fused_update=layout == "fused")
        state = _jax_state(jc, v["params"], v["batch_stats"], trace, mu, nu)
        # the per_tensor checkpoint untagged, as a bare save_checkpoint
        # writes it: its layout comes from the tree
        src = _save(state, tmp / f"jax_{layout}",
                    {**META, "optim_layout": "fused"} if layout == "fused"
                    else META)
        dst = str(tmp / f"port_{layout}")
        out["summary"][layout] = orbax_to_torch.convert(src, dst, c)
        out["src"][layout], out["dst"][layout] = src, dst
    yield out
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture
def scratch(tmp_path):
    """tmp_path, removed after the test (the tiny flagship's checkpoints
    are about 0.2 GB each)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _jax_target(setup, fused=True):
    _, jcfg = _cfgs(fused_update=fused)
    v = setup["v"]
    return _jax_state(jcfg, jax.tree_util.tree_map(jnp.asarray, v["params"]),
                      jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
                      setup["trace"], setup["mu"], setup["nu"])


def _port(setup, path=None, cfg=None):
    """A port model and train state, resumed from ``path`` with the port's
    own loader."""
    cfg = cfg or setup["cfg"]
    model, _ = tbuilder.build_model(cfg, device="cpu")
    state = TrainState(
        toptim.build_optimizer("main", cfg.optim, model.main_net.parameters()),
        toptim.build_optimizer("policy", cfg.optim,
                               model.policy_net.parameters()))
    meta = tckpt.load_checkpoint(path, model, state) if path else None
    return model, state, meta


# --------------------------------------------------------------------------
# the raveled trace's order
# --------------------------------------------------------------------------

def _reinsert(tree):
    """The same tree with every dict's keys inserted in reverse sorted
    order."""
    if not isinstance(tree, dict):
        return tree
    return {k: _reinsert(tree[k]) for k in sorted(tree, reverse=True)}


def test_ravel_order_is_jax_flatten_order(setup):
    """FusedSGD's trace filled with arange: each port momentum_buffer
    equals, bit for bit, the slice jax.flatten_util.ravel_pytree's unravel
    gives its flax path (transposed like its kernel), with the raw tree's
    dicts built in an order that is not sorted."""
    params = setup["v"]["params"]["main_net"]
    unsorted = _reinsert(params)
    assert list(unsorted) != sorted(unsorted)
    flat, unravel = ravel_pytree(params)
    arange = np.arange(flat.size, dtype=np.float32)
    assert flat.size < 2 ** 24  # every index exact in float32
    layout, state = flax_optimizer_state("sgd", {"trace": arange}, unsorted)
    assert layout == "fused"
    model, _ = tbuilder.build_model(setup["cfg"], device="cpu")
    opt = toptim.build_optimizer("main", setup["cfg"].optim,
                                 model.main_net.parameters())
    names = [n for n, _ in model.main_net.named_parameters()]
    opt.load_state_dict(optimizer_state_dict(opt, names, state))
    want = _subnet_state(setup["cfg"], setup["v"]["params"],
                         setup["v"]["batch_stats"], "main_net",
                         unravel(jnp.asarray(arange)))
    for name, p in model.main_net.named_parameters():
        got = opt.state[p]["momentum_buffer"]
        assert torch.equal(got, want[name]), name


def test_flat_vector_of_another_length_is_refused(setup):
    params = setup["v"]["params"]["main_net"]
    with pytest.raises(ValueError, match=r"main_opt/trace: a raveled vector "
                       r"of shape \(5,\) against \d+ parameters"):
        flax_optimizer_state("sgd", {"trace": np.zeros(5, np.float32)},
                             params)


# --------------------------------------------------------------------------
# eval after the import
# --------------------------------------------------------------------------

def _jax_eval(jmodel, state, x, target):
    logits, dec, _ = jsteps.make_adamml_eval_step(jmodel)(
        state, [jnp.asarray(a) for a in x], jnp.asarray(target),
        jax.random.PRNGKey(0))
    return np.asarray(logits), np.asarray(dec)


def _port_eval(model, temperature, x, target):
    logits, dec, _ = tsteps.make_adamml_eval_step(model)(
        EvalState(temperature=temperature), [t(a) for a in x], t(target), 0)
    return logits.detach().numpy(), dec.detach().numpy()


def test_summary_and_meta(setup):
    """The summary names each layout, found from the tree; the meta keeps
    the JAX keys, with the port's layout tag, the source and the key as a
    seed; the plateau schedulers' dicts as they are."""
    for layout in LAYOUTS:
        s = setup["summary"][layout]
        assert s["main_opt_layout"] == layout and not s["unimodal"]
        assert s["main_opt_tensors"] == 221 and s["policy_opt_tensors"] == 324
        meta = tckpt.peek_meta(setup["dst"][layout])
        assert meta["optim_layout"] == "torch"
        assert meta["imported_from"] == {
            "layout": layout, "path": os.path.abspath(setup["src"][layout])}
        assert meta["rng"] == (7 << 32) | 42
        for k in ("epoch", "stage", "best_top1", "scheduler", "p_scheduler"):
            assert meta[k] == META[k], k


def test_plateau_state_reads_as_it_is():
    """The JAX ReduceLROnPlateau's state dict, through JSON, loads into the
    port's unchanged (the same keys), and both then step alike."""
    j = jsched.ReduceLROnPlateau(0.01, patience=1)
    for m in (3.0, 3.0, 3.0, 2.0):
        j.step(m)
    p = tsched.ReduceLROnPlateau(0.5, patience=1)
    p.load_state_dict(json.loads(json.dumps(j.state_dict())))
    assert p.state_dict() == j.state_dict()
    for m in (2.5, 2.5, 1.0):
        assert p.step(m) == j.step(m)


def test_eval_after_import_matches_jax(setup):
    """The imported checkpoint, resumed by the port, against the JAX eval
    step on the state the JAX package restores: decisions equal, logits
    within 1e-4."""
    with _patched():
        jstate, _ = jckpt.load_checkpoint(setup["src"]["fused"],
                                          _jax_target(setup))
        want, wdec = _jax_eval(setup["jmodel"], jstate, setup["x"],
                               setup["target"])
        model, state, _ = _port(setup, setup["dst"]["fused"])
        got, gdec = _port_eval(model, state.temperature, setup["x"],
                               setup["target"])
    assert state.temperature == TEMPERATURE and state.step == STEP
    np.testing.assert_array_equal(gdec, wdec)
    assert 0.0 < gdec[..., 0].mean() < 1.0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _unimodal(setup, tmp, m, seed):
    """A JAX unimodal checkpoint of modality ``m`` (the tiny flagship's
    backbone, as train_unimodal builds it), imported; (JAX path, port
    path, JAX params, JAX statistics)."""
    cfg, jcfg = _cfgs()
    for c in (cfg, jcfg):
        c.model.modality = [m]
    jcfg.model.backbone_net = ("sound_mobilenet_v2" if m == "sound"
                               else "resnet")
    jmodel, _ = jbuilder.build_model(jcfg)
    shape = jbuilder.modality_input_shape(jcfg, m, 2, 1)
    x = jnp.zeros((2, 1) + shape[3:] if m == "sound"
                  else (2, shape[1] * shape[2]) + shape[3:])
    v = flax_variables(jmodel, np.random.RandomState(seed), x, train=True)
    tx = joptim.build_optimizer("main", jcfg.optim)
    state = AdaMMLTrainState.create(v["params"], v["batch_stats"],
                                    tx.init(v["params"]), None)
    src = _save(state, tmp / f"jax_{m}",
                {"epoch": 1, "arch": m, "best_top1": 0.0, "stage": "unimodal",
                 "optim_layout": "fused", "rng": [0, 23]})
    dst = str(tmp / f"port_{m}")
    s = orbax_to_torch.convert(src, dst, cfg)
    assert s["unimodal"] and s["policy_opt_tensors"] == 0
    return src, dst, v


@pytest.fixture(scope="module")
def unimodal(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("unimodal")
    yield {m: _unimodal(setup, tmp, m, seed)
           for m, seed in (("rgb", 1), ("sound", 2))}
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("m", ["rgb", "sound"])
def test_unimodal_import_is_the_backbone(unimodal, m):
    """Every tensor of the imported unimodal checkpoint equals the JAX
    tree's, through load_flax_variables into the backbone."""
    _, dst, v = unimodal[m]
    _, payload = tckpt.read_checkpoint(dst)
    cfg, _ = _cfgs()
    model, _ = tbuilder.build_model(cfg, device="cpu")
    net = getattr(model.main_net, f"net_{m}")
    load_flax_variables(net, v["params"], v["batch_stats"])
    want = net.state_dict()
    assert sorted(payload["model"]) == sorted(want)
    for k, x in want.items():
        assert torch.equal(payload["model"][k], x), k


def test_eval_after_unimodality_graft_matches_jax(setup, unimodal):
    """The rgb and sound checkpoints grafted through
    --unimodality_pretrained: the JAX package grafts its orbax files, the
    port the imported ones, into the same AdaMML weights; then both eval
    steps, within 1e-4."""
    cfg = setup["cfg"]
    with _patched():
        jstate = jpre.load_unimodality_pretrained(
            _jax_target(setup), ["rgb", "sound"],
            [unimodal["rgb"][0], unimodal["sound"][0]], depth=18)
        jstate = jax.tree_util.tree_map(jnp.asarray, jstate)
        want, wdec = _jax_eval(setup["jmodel"], jstate, setup["x"],
                               setup["target"])
        model, _, _ = _port(setup)
        load_flax_variables(model, setup["v"]["params"],
                            setup["v"]["batch_stats"])
        tpre.load_unimodality_pretrained(
            model, ["rgb", "sound"],
            [unimodal["rgb"][1], unimodal["sound"][1]], depth=18)
        got, gdec = _port_eval(model, TEMPERATURE, setup["x"],
                               setup["target"])
    np.testing.assert_array_equal(gdec, wdec)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert cfg.model.fusion_point == "logits"


# --------------------------------------------------------------------------
# resume: one step of each phase from the import
# --------------------------------------------------------------------------

def _port_layout(cfg, params, stats):
    model, _ = tbuilder.build_model(cfg, device="cpu")
    load_flax_variables(model, jax.tree_util.tree_map(np.asarray, params),
                        jax.tree_util.tree_map(np.asarray, stats))
    return model


def _subnet_state(cfg, params, stats, key, tree):
    """A params-shaped JAX state of subnet ``key`` in the port's names and
    layouts (through load_flax_variables, not the code under test)."""
    model = _port_layout(cfg, {**params, key: tree}, stats)
    return {n: p.detach().clone()
            for n, p in getattr(model, key).named_parameters()}


@pytest.fixture(scope="module")
def jax_steps(setup):
    """One JAX step of each phase from the state the JAX package restores
    (its resume), in the port's layout: tensors, metrics, the momentum
    (raveled trace unraveled by jax) and the Adam moments and count."""
    cfg, jmodel = setup["cfg"], setup["jmodel"]
    _, jcfg = _cfgs()
    tx_main = joptim.build_optimizer("main", jcfg.optim)
    tx_policy = joptim.build_optimizer("policy", jcfg.optim)
    flags = {"main": JStageFlags.main_phase(),
             "policy": JStageFlags.policy_phase()}
    x = [jnp.asarray(a) for a in setup["x"]]
    out = {}
    with _patched():
        for phase in PHASES:
            jstate, _ = jckpt.load_checkpoint(setup["src"]["fused"],
                                              _jax_target(setup))
            step = jsteps.make_adamml_train_step(
                jmodel, tx_main, tx_policy, flags=flags[phase],
                penalty_type="blockdrop", gammas=10.0, clip_gradient=None,
                has_policy_params=True)
            cw = COST if phase == "policy" else [0.0, 0.0]
            jstate, jm = step(jstate, x, jnp.asarray(setup["target"]),
                              jnp.asarray(LR), jnp.asarray(P_LR),
                              jnp.asarray(cw), jax.random.PRNGKey(0))
            params = jax.tree_util.tree_map(np.asarray, jstate.params)
            stats = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
            _, unravel = ravel_pytree(params["main_net"])
            adam = [s for s in jstate.policy_opt if hasattr(s, "mu")][0]
            out[phase] = dict(
                metrics={k: np.asarray(m) for k, m in jm.items()},
                tensors={k: v.detach().clone() for k, v in
                         _port_layout(cfg, params, stats).state_dict().items()},
                trace=_subnet_state(cfg, params, stats, "main_net", unravel(
                    jstate.main_opt["trace"])),
                mu=_subnet_state(cfg, params, stats, "policy_net", adam.mu),
                nu=_subnet_state(cfg, params, stats, "policy_net", adam.nu),
                count=int(adam.count), step=int(jstate.step))
    return out


@pytest.fixture(scope="module")
def port_steps(setup):
    """The port's step of each phase from each imported layout, resumed
    through its own load_checkpoint."""
    out = {}
    with _patched():
        for layout in LAYOUTS:
            for phase in PHASES:
                model, state, _ = _port(setup, setup["dst"][layout])
                start = {n: p.detach().clone()
                         for n, p in model.named_parameters()}
                step = tsteps.make_adamml_train_step(
                    model, flags=(StageFlags.main_phase() if phase == "main"
                                  else StageFlags.policy_phase()),
                    penalty_type="blockdrop", gammas=10.0, clip_gradient=None)
                cw = COST if phase == "policy" else [0.0, 0.0]
                m = step(state, [t(a) for a in setup["x"]],
                         t(setup["target"]), LR, P_LR, cw, seed=0)
                out[layout, phase] = dict(
                    model=model, state=state, start=start,
                    metrics={k: v.numpy() for k, v in m.items()},
                    tensors={k: v.detach().clone()
                             for k, v in model.state_dict().items()})
    return out


def _norm(d):
    return float(np.sqrt(sum(float((v.double() ** 2).sum())
                             for v in d.values())))


CASES = [(layout, phase) for layout in LAYOUTS for phase in PHASES]


@pytest.mark.parametrize("layout,phase", CASES,
                         ids=[f"{a}-{b}" for a, b in CASES])
def test_resume_step_matches_jax(setup, jax_steps, port_steps, layout,
                                 phase):
    """One step from the import against the JAX package's step from its
    restore. Metrics, live parameters and every BN statistic with
    tests/test_torch_train.py's one-step tolerances (decisions exact,
    losses 1e-4; SGD elements within 0.1 lr, 99% of Adam's within 0.1
    p_lr; statistics 2e-4). The optimizer state: the step counts exactly;
    the frozen subnet's state unchanged (bit for bit); the live one's new
    part (the momentum less 0.9 of the imported trace, the moments less
    their decayed imported values), which is the gradient's share, within
    3% in norm of JAX's, test_torch_train's gradient tolerance (6% for nu,
    whose share is the squared gradient)."""
    want, got = jax_steps[phase], port_steps[layout, phase]
    rec = {"phase": phase, "jax_metrics": want["metrics"],
           "torch_metrics": got["metrics"], "torch": got["tensors"],
           "jax": want["tensors"],
           "jax_grads": {n: None for n in got["start"]}}
    check_metrics(rec, first_step=True)
    check_parameters(rec)
    check_bn_statistics(rec)
    model, state = got["model"], got["state"]
    assert state.step == want["step"] == STEP + 1
    trace0 = _subnet_state(setup["cfg"], setup["v"]["params"],
                           setup["v"]["batch_stats"], "main_net",
                           unravel_like(setup["trace"],
                                        setup["v"]["params"]["main_net"]))
    mom = {n: state.main_opt.state[p]["momentum_buffer"]
           for n, p in model.main_net.named_parameters()}
    adam = {n: state.policy_opt.state[p]
            for n, p in model.policy_net.named_parameters()}
    mu0 = _subnet_state(setup["cfg"], setup["v"]["params"],
                        setup["v"]["batch_stats"], "policy_net", setup["mu"])
    nu0 = _subnet_state(setup["cfg"], setup["v"]["params"],
                        setup["v"]["batch_stats"], "policy_net", setup["nu"])
    if phase == "main":
        assert all(float(s["step"]) == COUNT for s in adam.values())
        for n, s in adam.items():
            assert torch.equal(s["exp_avg"], mu0[n]), n
            assert torch.equal(s["exp_avg_sq"], nu0[n]), n
        new = {n: mom[n] - 0.9 * trace0[n] for n in mom}
        ref = {n: want["trace"][n] - 0.9 * trace0[n] for n in mom}
        assert _norm({n: new[n] - ref[n] for n in new}) <= 0.03 * _norm(ref)
    else:
        for n in mom:
            assert torch.equal(mom[n], trace0[n]), n
        assert want["count"] == COUNT + 1
        assert all(float(s["step"]) == COUNT + 1 for s in adam.values())
        for key, decay, tol, ref0 in (("exp_avg", 0.9, 0.03, mu0),
                                      ("exp_avg_sq", 0.999, 0.06, nu0)):
            jkey = "mu" if key == "exp_avg" else "nu"
            new = {n: s[key] - decay * ref0[n] for n, s in adam.items()}
            ref = {n: want[jkey][n] - decay * ref0[n] for n in adam}
            assert (_norm({n: new[n] - ref[n] for n in new})
                    <= tol * _norm(ref)), key


# --------------------------------------------------------------------------
# layouts found from the tree; refusals
# --------------------------------------------------------------------------

def _convert_variant(setup, scratch, meta, policy=True, **optim):
    cfg, jcfg = _cfgs(**optim)
    v = setup["v"]
    params, stats = v["params"], v["batch_stats"]
    if not policy:
        for c in (cfg, jcfg):
            c.model.rng_policy = True
        params = {"main_net": params["main_net"]}
        stats = {"main_net": stats["main_net"]}
    state = _jax_state(jcfg, params, stats, setup["trace"], setup["mu"],
                       setup["nu"], policy=policy)
    src = _save(state, scratch / "jax", meta)
    dst = str(scratch / "port")
    return orbax_to_torch.convert(src, dst, cfg), dst, cfg


VARIANTS = {
    "momentum_0": (dict(momentum=0.0), True, None, 0),
    # optax's chain without add_decayed_weights: one state shorter
    "weight_decay_0": (dict(weight_decay=0.0, fused_update=False), True,
                       "per_tensor", 221),
    "rng_policy": (dict(), False, "fused", 221),
}


@pytest.mark.parametrize("tree", [{}, None, [None], [None, None], (None,)],
                         ids=["fused", "none", "chain", "chain2", "tuple"])
def test_no_momentum_leaves_no_state(setup, tree):
    """momentum 0: FusedSGD's {} and optax's chains without a trace (as
    orbax restores them) give no state and no layout."""
    assert flax_optimizer_state("sgd", tree,
                                setup["v"]["params"]["main_net"]) == (None, {})


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_layout_is_found_from_the_tree(setup, scratch, variant):
    optim, policy, layout, n_main = VARIANTS[variant]
    s, dst, cfg = _convert_variant(setup, scratch, {"epoch": 1}, policy,
                                   **optim)
    assert s["main_opt_layout"] == layout
    assert s["main_opt_tensors"] == n_main
    assert s["policy_opt_tensors"] == (324 if policy else 0)
    model, _ = tbuilder.build_model(cfg, device="cpu")
    state = TrainState(
        toptim.build_optimizer("main", cfg.optim, model.main_net.parameters()),
        toptim.build_optimizer("policy", cfg.optim,
                               model.policy_net.parameters())
        if policy else None)
    meta = tckpt.load_checkpoint(dst, model, state)
    assert meta["imported_from"]["layout"] == layout
    assert len(state.main_opt.state) == n_main
    if policy:
        p = next(model.policy_net.parameters())
        assert float(state.policy_opt.state[p]["step"]) == COUNT


def test_momentum_state_against_momentum_0_flags_is_refused(setup,
                                                            scratch):
    cfg, _ = _cfgs(momentum=0.0)
    with pytest.raises(ValueError, match="main_opt/trace: the checkpoint "
                       "holds SGD momentum"):
        orbax_to_torch.convert(setup["src"]["fused"], str(scratch / "port"),
                               cfg)


def test_flags_that_do_not_fit_fail_on_the_first_path(scratch):
    """A ResNet-50 unimodal tree against -d 18: the first path that does
    not fit, named."""
    jcfg = jconfig.config_from_args(jconfig.arg_parser().parse_args(
        "--modality rgb --backbone_net resnet -d 50 --groups 1 "
        "--input_size 32 --momentum 0".split()))
    jmodel, _ = jbuilder.build_model(jcfg)
    v = flax_variables(jmodel, np.random.RandomState(3),
                       jnp.zeros((1, 1, 32, 32, 3)), train=True)
    state = AdaMMLTrainState.create(v["params"], v["batch_stats"], {}, None)
    src = _save(state, scratch / "jax", {"epoch": 1})
    argv = [src, str(scratch / "port"), "--", "--modality", "rgb",
            "--backbone_net", "resnet", "-d", "18", "--groups", "1"]
    with pytest.raises(ValueError, match=r"^fc/kernel: does not fit "
                       r"fc\.weight \(31, 512\) \(port layout \(31, 2048\)\)"):
        orbax_to_torch.main(argv)
    assert not (scratch / "port").exists()


def _opt_case(setup):
    model, _ = tbuilder.build_model(setup["cfg"], device="cpu")
    opt = toptim.build_optimizer("main", setup["cfg"].optim,
                                 model.main_net.parameters())
    names = [n for n, _ in model.main_net.named_parameters()]
    tree = unravel_like(setup["trace"], setup["v"]["params"]["main_net"])
    return opt, names, tree


def test_leftover_leaf_is_refused_by_name(setup):
    opt, names, tree = _opt_case(setup)
    tree["net_rgb"]["extra"] = {"kernel": np.zeros((3, 3), np.float32)}
    _, state = flax_optimizer_state("sgd", [None, {"trace": tree}],
                                    setup["v"]["params"]["main_net"])
    with pytest.raises(ValueError, match=r"left over: \['main_opt/trace/"
                       r"net_rgb/extra/kernel'\]"):
        optimizer_state_dict(opt, names, state)


def test_parameter_without_state_is_refused_by_name(setup):
    opt, names, tree = _opt_case(setup)
    del tree["net_sound"]["classifier"]
    _, state = flax_optimizer_state("sgd", [None, {"trace": tree}],
                                    setup["v"]["params"]["main_net"])
    with pytest.raises(ValueError, match=r"left without optimizer state: "
                       r"\['net_sound\.classifier\.weight', "
                       r"'net_sound\.classifier\.bias'\]"):
        optimizer_state_dict(opt, names, state)


# --------------------------------------------------------------------------
# the port's CLI takes the product
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_import(tmp_path_factory):
    """A JAX checkpoint of TINY's model (the finetune stage after its first
    epoch), imported with ``orbax_to_torch.main`` and TINY's flags."""
    tmp = tmp_path_factory.mktemp("cli_import")
    jcfg = jconfig.config_from_args(jconfig.arg_parser().parse_args(TINY))
    jmodel, _ = jbuilder.build_model(jcfg)
    x = jbuilder.example_inputs(jcfg, batch=1, num_segments=2,
                                rng=jax.random.PRNGKey(0))
    v = flax_variables(jmodel, np.random.RandomState(4), x, train=False)
    state = AdaMMLTrainState.create(
        v["params"], v["batch_stats"],
        joptim.build_optimizer("main", jcfg.optim).init(
            v["params"]["main_net"]),
        joptim.build_optimizer("policy", jcfg.optim).init(
            v["params"]["policy_net"]))
    src = _save(state, tmp / "jax",
                {"epoch": 1, "arch": "jax", "best_top1": 0.0,
                 "stage": "finetune", "optim_layout": "fused",
                 "rng": [0, 5]})
    dst = str(tmp / "imported")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert orbax_to_torch.main([src, dst, "--", *TINY]) == 0
    yield dst, out.getvalue()
    shutil.rmtree(tmp, ignore_errors=True)


def test_cli_resumes_from_the_import(cli_import, scratch):
    """--resume: the finetune stage continues at its second epoch (one
    more Train line), from the imported optimizer state."""
    cli_import, _ = cli_import
    logdir = scratch / "logs"
    assert train_adamml.main(TINY + ["--logdir", str(logdir), "--resume",
                                     cli_import, "--finetune_epochs", "2"],
                             device="cpu") == 0
    folder = next(p for p in logdir.iterdir() if p.is_dir())
    lines = (folder / "log.log").read_text().splitlines()
    assert any(line.startswith(f"=> loaded checkpoint '{cli_import}' "
                               "(epoch 1)") for line in lines)
    train = [line for line in lines if line.startswith("Train:")]
    assert len(train) == 1 and train[0].startswith("Train: [002/002]")
    assert tckpt.peek_meta(folder / "checkpoint_finetune_02")["epoch"] == 2


def test_cli_evaluates_the_import(cli_import, scratch, capsys):
    cli_import, _ = cli_import
    assert train_adamml.main(TINY + ["--logdir", str(scratch), "-e",
                                     "--pretrained", cli_import],
                             device="cpu") == 0
    out = capsys.readouterr().out
    assert "=> using pre-trained model (temperature: 5.0)" in out
    assert sum(line.startswith("Val:") for line in out.splitlines()) == 1


def test_import_prints_one_summary_line(cli_import):
    """One line: the leaves mapped, the layout found, parameter and state
    counts."""
    dst, out = cli_import
    assert len(out.splitlines()) == 1
    assert out.startswith("orbax_to_torch: ")
    for part in ("leaves mapped", "main_opt layout fused (220 tensors with "
                 "momentum)", "Adam state for 324 tensors", "stage finetune"):
        assert part in out, part
    meta = tckpt.peek_meta(dst)
    assert meta["imported_from"]["layout"] == "fused"
    assert meta["rng"] == 5


def test_script_imports_nothing_of_the_jax_package():
    """orbax_to_torch.py names orbax and the port, never adamml_tpu (nor
    jax or flax directly)."""
    names = []
    for node in ast.walk(ast.parse((REPO / "orbax_to_torch.py").read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "orbax" in roots and "adamml_tpu_torch" in roots
    assert not roots & {"adamml_tpu", "jax", "jaxlib", "flax"}
