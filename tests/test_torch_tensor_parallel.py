"""PyTorch port, tensor parallelism (``--mesh_model``, parallel/mesh.py) on
the CPU: gloo ranks at a (data, model) layout against the JAX package's
mesh of the same shape and against the port's single process.

  * the sharding rule: ``mesh.shards_param`` against the JAX package's
    ``_spec_for_param`` on every leaf of the tiny flagship's parameters
    (5 classes, and 6 so that ``fc`` and ``classifier`` divide), at
    M = 2 and 4;
  * two ranks at (1, 2) against the JAX step jitted over
    ``make_mesh(1, 2)`` with ``place_on_mesh``'s column-sharded kernels:
    three main-phase and three policy-phase steps, each from the JAX
    state (tests/test_torch_train.py's settings and checks: float32, 8
    clips at 64x64, dropout 0, zero-noise straight-through decisions),
    then the eval logits;
  * two ranks at (1, 2) and four at (2, 2), both BN modes, against the
    single process (tests/test_torch_multiprocess.py's ``steps`` task and
    tolerances), the ranks' gathered states bit-identical; the dry run's
    loss drop at (2, 2);
  * the clip's norm on every rank against the single process's,
    checkpoints across M = 1 and M = 2, and both CLIs at --mesh_model 2
    (train_adamml at (2, 2) with eval capacity blocks that span ranks).

JAX runs in this process; the ranks are JAX-free children
(tests/test_torch_multiprocess.py's ``_launch``) that read the JAX states
from files.
"""

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

import __graft_entry__ as graft
from adamml_tpu.models import model_builder as jbuilder
from adamml_tpu.models import policy_net as jpolicy
from adamml_tpu.parallel import mesh as jmesh
from adamml_tpu.train import optim as joptim
from adamml_tpu.train import steps as jsteps
from adamml_tpu.train.train_state import AdaMMLTrainState
from adamml_tpu.train.train_state import StageFlags as JStageFlags
from adamml_tpu_torch.ckpt.checkpoint import save_checkpoint
from adamml_tpu_torch.ckpt.flax_convert import load_flax_variables
from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.models import model_builder as tbuilder
from adamml_tpu_torch.models import policy_net as tpolicy
from adamml_tpu_torch.parallel import mesh
from adamml_tpu_torch.train.optim import ADAM_BETAS, build_optimizer
from adamml_tpu_torch.train.steps import make_adamml_train_step
from adamml_tpu_torch.train.train_state import StageFlags, TrainState

from test_torch_multiprocess import (HEADER, LR, P_LR_K, REPO, RTOL,
                                     TIMEOUT_S, _launch, check_compare)
from test_torch_train import (COST, P_LR, STEP_CLIPS, STEP_INPUT_SIZE,
                              _center_rgb_decisions, _inputs,
                              check_bn_statistics,
                              check_freezes, check_gradients, check_metrics,
                              check_parameters)
from torch_parity import (flax_variables, one_torch_thread,  # noqa: F401
                          st_zero_noise_jax, st_zero_noise_torch, t)

# the flagship's layer names that M = 2 shards (31 classes: fc and
# classifier do not divide); the tiny flagship has the same at 5 classes
SHARDED = ["policy_net.joint_fc1.weight", "policy_net.joint_fc2.weight",
           "policy_net.lstm.hh.weight", "policy_net.lstm.ih.weight"]
PHASES = ("main",) * 3 + ("policy",) * 3
STEP_IDS = [f"{i}-{p}" for i, p in enumerate(PHASES)]


# --------------------------------------------------------------------------
# the sharding rule
# --------------------------------------------------------------------------

_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
         "lf_weights": "lf_weights"}


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("num_classes", [5, 6])
def test_sharding_rule_matches_spec_for_param(num_classes, model):
    """For every parameter leaf of the JAX tiny flagship, _spec_for_param
    gives P(None, 'model') exactly where the port shards the matching
    torch weight on dim 0 (shards_param), and P() everywhere else: the
    policy's joint_fc1, joint_fc2, ih and hh always, fc and classifier
    when the classes divide by M."""
    jcfg = graft._flagship_cfg(tiny=True)
    cfg = flagship_cfg(tiny=True)
    jcfg.model.num_classes = cfg.model.num_classes = num_classes
    jmodel, _ = jbuilder.build_model(jcfg)
    x = [jnp.zeros(tbuilder.modality_input_shape(cfg, m, 1,
                                                 cfg.model.num_segments))
         for m in cfg.model.modality]
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1)},
        x, train=False))["params"]
    tmodel, _ = tbuilder.build_model(cfg, device="cpu")
    params = dict(tmodel.named_parameters())
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    sharded = []
    for path, leaf in leaves:
        keys = [p.key for p in path]
        name = ".".join(keys[:-1] + [_LEAF[keys[-1]]])
        spec = jmesh._spec_for_param(path, leaf, model)
        assert spec in (jmesh.P(), jmesh.P(None, "model")), (name, spec)
        port = mesh.shards_param(name, params[name], model)
        assert port == (spec == jmesh.P(None, "model")), name
        sharded += [name] * port
    assert len(leaves) == len(params)
    heads = ["main_net.net_rgb.fc.weight",
             "main_net.net_sound.classifier.weight"]
    assert sorted(sharded) == sorted(
        SHARDED + (heads if num_classes % model == 0 else []))


# --------------------------------------------------------------------------
# two ranks at (1, 2) against the JAX step on a (1, 2) mesh
# --------------------------------------------------------------------------

_TASKS = HEADER + r'''
from adamml_tpu_torch.models import model_builder as mb
from adamml_tpu_torch.models import policy_net as tpolicy
from adamml_tpu_torch.ops.kernels import tpool_fused as ttp
from adamml_tpu_torch.train.optim import build_optimizer, clip_by_global_norm
from adamml_tpu_torch.train.steps import (make_adamml_eval_step,
                                          make_adamml_train_step)
from adamml_tpu_torch.train.train_state import (EvalState, StageFlags,
                                                TrainState)

out = args.get("out")


def sharded_names(model):
    return sorted(n for n, p in model.named_parameters()
                  if mesh.param_shard(p) is not None)


def optimizers(cfg, model):
    return TrainState(
        build_optimizer("main", cfg.optim, model.main_net.parameters()),
        build_optimizer("policy", cfg.optim, model.policy_net.parameters()))


def st_zero_noise(generator, logits, tau):
    y = torch.softmax(logits / tau, dim=-1)
    hard = (logits.argmax(-1) == 1).float()
    return hard + y[..., 1] - y[..., 1].detach()


if task == "jax_steps":
    # the JAX states arrive in the port's layout while the parent steps
    # JAX: init.pt, then after_i.pt (what step i changed: the live subnet,
    # the BN statistics and the live optimizer's state)
    import time
    tpolicy.gumbel_decision = st_zero_noise
    bwd, real_bwd = [], ttp.reference_bwd
    ttp.reference_bwd = lambda *a: bwd.append(1) or real_bwd(*a)
    cfg = flagship_cfg(tiny=True)
    cfg.model.dropout = 0.0
    cfg.data.input_size = args["input_size"]
    join(cfg)
    init = torch.load(os.path.join(out, "init.pt"), weights_only=False)
    x = [torch.from_numpy(a) for a in init["x"]]
    target = torch.from_numpy(init["target"])
    full = init["model"]
    model, _ = mb.build_model(cfg, dev)
    state = optimizers(cfg, model)
    names = {id(p): n for n, p in model.named_parameters()}
    grads = {}

    def snapshot(o, a, kw):
        grads.clear()
        for g in o.param_groups:
            for p in g["params"]:
                if p.grad is not None:
                    sh = mesh.param_shard(p)
                    grads[names[id(p)]] = (p.grad.clone() if sh is None else
                                           mesh._model_gather(p.grad, sh))

    for opt in (state.main_opt, state.policy_opt):
        opt.register_step_pre_hook(snapshot)
    steps = {"main": make_adamml_train_step(
        model, flags=StageFlags.main_phase(), penalty_type="blockdrop",
        gammas=10.0, clip_gradient=None),
        "policy": make_adamml_train_step(
        model, flags=StageFlags.policy_phase(), penalty_type="blockdrop",
        gammas=10.0, clip_gradient=None)}

    def load(i):
        path = os.path.join(out, f"after_{i}.pt")
        while not os.path.exists(path):  # the parent is still stepping JAX
            if os.path.exists(os.path.join(out, "abort")):
                raise SystemExit("the parent's JAX steps failed")
            time.sleep(0.2)
        got = torch.load(path, weights_only=False)
        full.update(got["model"])
        model.load_state_dict(mesh.shard_state_dict(model, full))
        net = getattr(model, got["net"])
        opt = state.main_opt if got["net"] == "main_net" else \
            state.policy_opt
        for name, p in net.named_parameters():
            sh = mesh.param_shard(p)
            cut = (lambda v: v.clone()) if sh is None else (
                lambda v: sh.rows(v).clone())
            st = opt.state[p]
            if "momentum" in got:
                st["momentum_buffer"] = cut(got["momentum"][name])
            if "mu" in got:
                st["exp_avg"] = cut(got["mu"][name])
                st["exp_avg_sq"] = cut(got["nu"][name])
                st["step"] = torch.tensor(float(got["count"]))

    model.load_state_dict(mesh.shard_state_dict(model, full))
    digests, frozen = [], []
    for i, phase in enumerate(args["phases"]):
        if i:
            load(i - 1)
        start = dict(full)
        before = len(bwd)
        cw = args["cost"] if phase == "policy" else [0.0, 0.0]
        m = steps[phase](state, x, target, args["lr"], args["p_lr"], cw,
                         seed=0)
        end = full_tensors(model)
        live = phase + "_net."
        frozen.append(all(torch.equal(end[k], start[k]) for k, _ in
                          model.named_parameters() if not k.startswith(live)))
        digests.append(digest(list(end.values()) + list(m.values())))
        if rank == 0:
            torch.save({"metrics": {k: v.numpy() for k, v in m.items()},
                        "grads": dict(grads), "bwd_calls": len(bwd) - before,
                        "live": {k: v for k, v in end.items()
                                 if k.startswith(live)
                                 or k.endswith(("running_mean",
                                                "running_var"))}},
                       os.path.join(out, f"rank_{i}.pt"))
    load(len(args["phases"]) - 1)
    logits, dec, loss = make_adamml_eval_step(model)(
        EvalState(temperature=float(init["temperature"])), x, target, 0)
    if rank == 0:
        torch.save({"logits": logits, "decisions": dec, "loss": loss},
                   os.path.join(out, "eval.pt"))
    mesh.shutdown()
    report(digests=digests, frozen=frozen, sharded=sharded_names(model),
           eval=digest([logits, dec, loss]))

elif task == "clip":
    # gradients drawn for the full model; each rank keeps its rows
    cfg = flagship_cfg(tiny=True)
    join(cfg)
    model, _ = mb.build_model(cfg, dev)

    def draw(model):
        gen = torch.Generator().manual_seed(7)
        for _, p in model.named_parameters():
            sh = mesh.param_shard(p)
            shape = ((sh.size * p.shape[0],) + tuple(p.shape[1:])
                     if sh is not None else tuple(p.shape))
            g = torch.randn(shape, generator=gen) * 1e-3
            p.grad = sh.rows(g).clone() if sh is not None else g
        return list(model.parameters())

    norm = float(clip_by_global_norm(draw(model), args["max_norm"]))
    clipped = digest([mesh._model_gather(p.grad, mesh.param_shard(p))
                      if mesh.param_shard(p) is not None else p.grad
                      for p in model.parameters()])
    sharded = sharded_names(model)
    mesh.shutdown()
    res = dict(norm=norm, clipped=clipped, sharded=sharded)
    if rank == 0:
        single, _ = mb.build_model(cfg, dev)
        res["single_norm"] = float(clip_by_global_norm(draw(single),
                                                       args["max_norm"]))
        res["single_clipped"] = digest([p.grad for p in single.parameters()])
    report(**res)

elif task == "checkpoints":
    # (a) written at M = 2, loaded at M = 1; (b) the parent's M = 1
    # checkpoint resumed at M = 2; (c) that checkpoint grafted by
    # --pretrained at M = 2 and at M = 1, then one eval step on each
    from adamml_tpu_torch.ckpt.checkpoint import (load_checkpoint,
                                                  read_checkpoint,
                                                  save_checkpoint)
    from adamml_tpu_torch.ckpt.pretrained import load_pretrained_adamml

    def graft(model):
        """(the graft's count, [each sharded tensor holds its rows of the
        saved value], [each other tensor the saved value], the eval step's
        logits and decisions on x as lists)."""
        estate = EvalState(temperature=-1.0)
        n = load_pretrained_adamml(model, estate, args["m1"])
        sd, params = model.state_dict(), dict(model.named_parameters())
        rows, full = [], []
        for name, v in payload["model"].items():
            sh = mesh.param_shard(params[name]) if name in params else None
            (rows if sh is not None else full).append(bool(torch.equal(
                sd[name], sh.rows(v) if sh is not None else v)))
        logits, dec, _ = make_adamml_eval_step(model)(estate, x, target, 0)
        return dict(grafted=n, rows=rows, full=full,
                    temperature=estate.temperature,
                    logits=logits.tolist(), decisions=dec.tolist())

    cfg = flagship_cfg(tiny=True)
    join(cfg)
    model, _ = mb.build_model(cfg, dev)
    state = optimizers(cfg, model)
    rs = np.random.RandomState(3)
    x = [torch.from_numpy(rs.randn(*mb.modality_input_shape(
        cfg, m, 4, cfg.model.num_segments)).astype(np.float32))
        for m in cfg.model.modality]
    target = torch.arange(4) % cfg.model.num_classes
    for flags, cw in ((StageFlags.main_phase(), [0.0, 0.0]),
                      (StageFlags.policy_phase(), [1.0, 0.05])):
        make_adamml_train_step(model, flags=flags, penalty_type="blockdrop",
                               gammas=10.0, clip_gradient=None)(
            state, x, target, 1e-3, 1e-2, cw, seed=1)
    written = save_checkpoint(model, state, {"epoch": 1}, args["logdir"],
                              rank=rank)
    mine = {"model": full_tensors(model),
            "main": mesh.full_optimizer_state(state.main_opt)["state"],
            "policy": mesh.full_optimizer_state(state.policy_opt)["state"]}
    # (b): every rank loads the M = 1 checkpoint and keeps its rows
    resumed, _ = mb.build_model(cfg, dev)
    rstate = optimizers(cfg, resumed)
    load_checkpoint(args["m1"], resumed, rstate)
    _, payload = read_checkpoint(args["m1"])
    rows, full_rows = [], []
    named = dict(resumed.named_parameters())
    for key, opt in (("main_opt", rstate.main_opt),
                     ("policy_opt", rstate.policy_opt)):
        params = [p for g in opt.param_groups for p in g["params"]]
        for i, st in payload[key]["state"].items():
            sh = mesh.param_shard(params[i])
            for k, v in st.items():
                got = opt.state[params[i]][k]
                want = v if sh is None or v.dim() == 0 else sh.rows(v)
                (rows if sh is not None else full_rows).append(
                    bool(torch.equal(got, want)))
    for name, v in payload["model"].items():
        p = named.get(name)
        sh = mesh.param_shard(p) if p is not None else None
        got = resumed.state_dict()[name]
        (rows if sh is not None else full_rows).append(
            bool(torch.equal(got, sh.rows(v) if sh is not None else v)))
    sharded = sharded_names(resumed)
    pretrained = graft(mb.build_model(cfg, dev)[0])
    mesh.shutdown()
    res = dict(rows=rows, full=full_rows, sharded=sharded,
               pretrained=pretrained)
    if rank == 0:
        res["pretrained_m1"] = graft(mb.build_model(cfg, dev)[0])
        # (a): the single process loads the M = 2 checkpoint
        single, _ = mb.build_model(cfg, dev)
        sstate = optimizers(cfg, single)
        load_checkpoint(written, single, sstate)
        sd = single.state_dict()
        res["model_equal"] = all(torch.equal(sd[k], v)
                                 for k, v in mine["model"].items())
        res["opt_equal"] = all(
            all(torch.equal(o.state_dict()["state"][i][k], v)
                for i, st in mine[key].items() for k, v in st.items())
            for key, o in (("main", sstate.main_opt),
                           ("policy", sstate.policy_opt)))
    report(**res)

else:
    raise SystemExit(f"unknown task {task}")
'''


def _port_layout(cfg, params, stats):
    model, _ = tbuilder.build_model(cfg, device="cpu")
    return load_flax_variables(
        model, jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, stats))


def _stats(name):
    return name.endswith(("running_mean", "running_var"))


def _save(obj, path):
    """torch.save, then a rename: a rank polling for ``path`` never reads
    a half-written file."""
    torch.save(obj, str(path) + ".part")
    os.replace(str(path) + ".part", path)


def _applied_gradient(cfg, phase, saved, prev, start):
    """The gradient JAX's step applied to the live subnet, from its
    optimizer state in the port's layout (names under the subnet): SGD's
    trace v = momentum * v_prev + g + wd * p (FusedSGD.apply), Adam's
    mu = b1 * mu_prev + (1 - b1) * (g + wd * p) (optax add_decayed_weights,
    scale_by_adam), p the step's start. The step's own gradient, without
    a second compile of the loss's backward; float32 rounding of the state
    moves it by about 1e-6 of its norm."""
    net, wd = f"{phase}_net.", cfg.optim.weight_decay
    if phase == "main":
        state, keep = saved["momentum"], cfg.optim.momentum
        return {net + k: v - keep * (prev[k] if prev else 0.0)
                - wd * start[net + k] for k, v in state.items()}
    b1 = ADAM_BETAS[0]
    return {net + k: (v - b1 * (prev[k] if prev else 0.0)) / (1.0 - b1)
            - wd * start[net + k] for k, v in saved["mu"].items()}


@pytest.fixture(scope="module")
def jax_tp_run(tmp_path_factory):
    """Three main and three policy steps of the tiny flagship: the JAX
    step jitted over make_mesh(1, 2) (params by place_on_mesh, so the wide
    kernels column-sharded), and two gloo ranks at --mesh_model 2 that
    start each step from the JAX state, written here in the port's layout
    as JAX steps (the ranks run meanwhile). One record a step in
    tests/test_torch_train.py's form (the port's side gathered over the
    model group), the ranks' own digests and checks, and both eval steps'
    outputs on the final JAX state."""
    tmp = tmp_path_factory.mktemp("tp_jax")
    cfg = flagship_cfg(tiny=True)
    jcfg = graft._flagship_cfg(tiny=True)
    cfg.model.dropout = jcfg.model.dropout = 0.0
    cfg.data.input_size = jcfg.data.input_size = STEP_INPUT_SIZE
    jcfg.runtime.mesh_data, jcfg.runtime.mesh_model = 1, 2
    rs = np.random.RandomState(0)
    x = _inputs(cfg, rs, STEP_CLIPS)
    target = rs.randint(0, cfg.model.num_classes, STEP_CLIPS)
    jmodel, _ = jbuilder.build_model(jcfg)
    v = flax_variables(jmodel, rs, [jnp.asarray(a) for a in x], train=False)
    tmodel, _ = tbuilder.build_model(cfg, device="cpu")
    load_flax_variables(tmodel, v["params"], v["batch_stats"])
    m2 = jmesh.make_mesh(1, 2, devices=jax.devices()[:2])
    records = []
    pool = ThreadPoolExecutor(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpolicy, "gumbel_decision", st_zero_noise_torch)
        mp.setattr(jpolicy, "gumbel_decision", st_zero_noise_jax)
        _center_rgb_decisions(tmodel, x, v["params"])
        start = {k: t_.detach().clone()
                 for k, t_ in tmodel.state_dict().items()}
        del tmodel
        _save({"x": x, "target": target, "model": start,
               "temperature": 5.0}, tmp / "init.pt")
        ranks = pool.submit(
            _launch, tmp, "jax_steps", worker=_TASKS, timeout_s=900,
            mesh_model=2, out=str(tmp), phases=PHASES,
            input_size=STEP_INPUT_SIZE, lr=LR, p_lr=P_LR, cost=COST)
        tx_main = joptim.build_optimizer("main", jcfg.optim)
        tx_policy = joptim.build_optimizer("policy", jcfg.optim)
        params = jmesh.place_on_mesh(
            jax.tree_util.tree_map(jnp.asarray, v["params"]), m2)
        jstate = AdaMMLTrainState.create(
            params, jmesh.place_on_mesh(jax.tree_util.tree_map(
                jnp.asarray, v["batch_stats"]), m2),
            tx_main.init(params["main_net"]),
            tx_policy.init(params["policy_net"]))
        flags = {"main": JStageFlags.main_phase(),
                 "policy": JStageFlags.policy_phase()}
        jstep = {p: jsteps.make_adamml_train_step(
            jmodel, tx_main, tx_policy, flags=flags[p],
            has_policy_params=True, penalty_type="blockdrop", gammas=10.0,
            clip_gradient=None) for p in flags}
        jx = jmesh.shard_batch([np.asarray(a) for a in x], m2)
        jt = jmesh.shard_batch(np.asarray(target), m2)
        try:
            jeval = _jax_steps(cfg, jmodel, jstep, jstate, jx, jt, start,
                               records, tmp)
        except BaseException:
            (tmp / "abort").touch()  # the ranks stop waiting for a state
            raise
        results, _ = ranks.result()
    pool.shutdown()
    for i, rec in enumerate(records):
        got = torch.load(tmp / f"rank_{i}.pt", weights_only=False)
        rec.update(torch_metrics=got["metrics"], torch_grads=got["grads"],
                   torch={**rec["start"], **got["live"]},
                   bwd_calls=got["bwd_calls"])
    evals = torch.load(tmp / "eval.pt", weights_only=False)
    for f in os.listdir(tmp):
        os.remove(tmp / f)
    return dict(records=records, ranks=results, eval=evals, jax_eval=jeval)


def _jax_steps(cfg, jmodel, jstep, jstate, jx, jt, start, records, tmp):
    """The JAX side of ``jax_tp_run``: each step, then the state it left
    in the port's layout (after_i.pt) and its record; then the eval step
    on the final state."""
    prev = {"main": None, "policy": None}
    for i, phase in enumerate(PHASES):
        net = f"{phase}_net"
        cw = COST if phase == "policy" else [0.0, 0.0]
        jstate, jm = jstep[phase](jstate, jx, jt, jnp.asarray(LR),
                                  jnp.asarray(P_LR), jnp.asarray(cw),
                                  jax.random.PRNGKey(0))
        after = _port_layout(cfg, jstate.params, jstate.batch_stats)
        changed = {k: t_.detach().clone()
                   for k, t_ in after.state_dict().items()
                   if k.startswith(net + ".") or _stats(k)}
        saved = {"model": changed, "net": net}
        if phase == "main":
            _, unravel = ravel_pytree(jstate.params["main_net"])
            saved["momentum"] = {k: t_.detach().clone() for k, t_ in (
                _port_layout(cfg, {**jstate.params, "main_net": unravel(
                    jstate.main_opt["trace"])}, jstate.batch_stats)
                .main_net.named_parameters())}
        else:
            adam = [s_ for s_ in jstate.policy_opt if hasattr(s_, "mu")][0]
            for key in ("mu", "nu"):
                saved[key] = {k: t_.detach().clone() for k, t_ in (
                    _port_layout(cfg, {**jstate.params,
                                       "policy_net": getattr(adam, key)},
                                 jstate.batch_stats)
                    .policy_net.named_parameters())}
            saved["count"] = int(adam.count)
        _save(saved, tmp / f"after_{i}.pt")
        grads = _applied_gradient(cfg, phase, saved, prev[phase], start)
        prev[phase] = saved["momentum" if phase == "main" else "mu"]
        records.append({
            "phase": phase, "start": start,
            "jax_metrics": {k: np.asarray(m) for k, m in jm.items()},
            "jax": {**start, **changed},
            "jax_grads": {k: grads.get(k, t_) for k, t_ in start.items()
                          if not _stats(k)}})
        start = {**start, **changed}
    jeval = jsteps.make_adamml_eval_step(jmodel)(
        jstate, jx, jt, jax.random.PRNGKey(0))
    return [np.asarray(a) for a in jeval]


def test_ranks_shard_the_policy_layers_and_agree(jax_tp_run):
    """Both ranks shard exactly joint_fc1, joint_fc2, ih and hh (fc and
    classifier stay replicated: 5 classes do not divide by 2), end every
    step and the eval with the same gathered state and outputs, bit for
    bit, and leave the frozen subnet unchanged at every step."""
    a, b = jax_tp_run["ranks"]
    assert a["sharded"] == b["sharded"] == SHARDED
    assert a["digests"] == b["digests"] and len(a["digests"]) == len(PHASES)
    assert a["eval"] == b["eval"]
    assert all(a["frozen"]) and all(b["frozen"])


@pytest.mark.parametrize("i", range(len(PHASES)), ids=STEP_IDS)
def test_tp_step_metrics_match_jax_mesh(jax_tp_run, i):
    """tests/test_torch_train.py's check_metrics: decisions exact, losses
    within 1e-4 relative."""
    check_metrics(jax_tp_run["records"][i], i == 0)


@pytest.mark.parametrize("i", range(len(PHASES)), ids=STEP_IDS)
def test_tp_step_gradients_match_jax_mesh(jax_tp_run, i):
    """The live gradient, sharded rows gathered: within 3% in norm of the
    gradient the JAX mesh step applied (check_gradients;
    _applied_gradient)."""
    check_gradients(jax_tp_run["records"][i])


@pytest.mark.parametrize("i", range(len(PHASES)), ids=STEP_IDS)
def test_tp_step_parameters_match_jax_mesh(jax_tp_run, i):
    """SGD updates within 0.1 lr of JAX's; 99% of Adam's within 0.1 p_lr
    (check_parameters)."""
    check_parameters(jax_tp_run["records"][i])


@pytest.mark.parametrize("i", range(len(PHASES)), ids=STEP_IDS)
def test_tp_step_bn_statistics_match_jax_mesh(jax_tp_run, i):
    """Every BN running statistic within rtol 1e-4, atol 2e-4
    (check_bn_statistics)."""
    check_bn_statistics(jax_tp_run["records"][i])


@pytest.mark.parametrize("i", range(len(PHASES)), ids=STEP_IDS)
def test_tp_step_freezes_and_runs_fused_backward(jax_tp_run, i):
    """check_freezes: the live subnet moves, its BN statistics too, and the
    fused epilogue's backward runs twice in a main step and not in a policy
    step."""
    check_freezes(jax_tp_run["records"][i])


def test_tp_eval_logits_match_jax_mesh(jax_tp_run):
    """The eval step on the final JAX state: decisions equal, logits and
    loss within 1e-4 (tests/test_torch_adamml.py's TOL)."""
    logits, dec, loss = jax_tp_run["jax_eval"]
    got = jax_tp_run["eval"]
    np.testing.assert_array_equal(got["decisions"].numpy(), dec)
    np.testing.assert_allclose(got["logits"].numpy(), logits, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-4,
                               atol=1e-4)


# --------------------------------------------------------------------------
# (1, 2) and (2, 2) against the single process
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(2, False), (4, False), (4, True)],
                ids=["1x2", "2x2_per_replica_bn", "2x2_sync_bn"])
def tp_steps(request, tmp_path_factory):
    world, sync_bn = request.param
    results, _ = _launch(tmp_path_factory.mktemp("tp_steps"), "steps",
                         world=world, mesh_model=2, sync_bn=sync_bn,
                         batch=8, lr=LR, p_lr=P_LR_K, rtol=RTOL)
    return sync_bn, results


def test_tp_ranks_are_bit_identical(tp_steps):
    """After each step every rank's gathered state and metrics are the
    same, bit for bit; --sync-bn marks every BN synchronized."""
    sync_bn, results = tp_steps
    assert len({tuple(r["digests"]) for r in results}) == 1
    assert all(r["synced"] is sync_bn for r in results)


@pytest.mark.parametrize("i", [0, 1], ids=["main", "policy"])
def test_tp_ranks_match_the_single_process(tp_steps, i):
    """Each phase's step from one start, tensor-parallel ranks against the
    single process on the global batch (bn_groups = the data shards, or 1
    under --sync-bn), real Gumbel and dropout noise, with
    tests/test_torch_multiprocess.py's tolerances (check_compare)."""
    check_compare(tp_steps[1][0]["compare"][i], i)


def test_dryrun_multichip_counterpart_at_2x2(tmp_path):
    """__graft_entry__.py::dryrun_multichip's 4-device layout (mesh_data
    2, mesh_model 2) as four ranks: five main steps on one batch drop
    cls_loss by at least 25%, a policy step moves the policy, and all four
    ranks end with the same gathered state."""
    results, _ = _launch(tmp_path, "dryrun", world=4, mesh_model=2,
                         logdir=str(tmp_path / "logs"))
    a = results[0]
    assert all(r["cls"] == a["cls"] and r["state"] == a["state"]
               for r in results)
    assert a["cls"][-1] <= 0.75 * a["cls"][0], a["cls"]
    assert a["moved"] > 0


# --------------------------------------------------------------------------
# the clip and checkpoints
# --------------------------------------------------------------------------

def test_clip_norm_and_scale_match_the_single_process(tmp_path):
    """--clip_gradient at (1, 2): each rank sums its sharded gradients'
    squares over the model group and counts the replicated ones once, so
    both ranks take the single process's norm and scale, and the gathered
    clipped gradients are the same on both ranks. Within 1e-4: the float32
    norm of a 5M-element weight sits about 1e-4 off its float64 value
    whichever way it is split (measured: the halves' 2.4e-5 apart from the
    whole's), so the two sums differ at that size."""
    results, _ = _launch(tmp_path, "clip", worker=_TASKS, mesh_model=2,
                         max_norm=0.05)
    a, b = results
    assert a["sharded"] == SHARDED
    assert a["norm"] == b["norm"] and a["clipped"] == b["clipped"]
    assert a["norm"] == pytest.approx(a["single_norm"], rel=1e-4)
    assert a["norm"] > 0.05  # the clip scales
    scale = [min(1.0, 0.05 / (n + 1e-6)) for n in (a["norm"],
                                                    a["single_norm"])]
    assert scale[0] == pytest.approx(scale[1], rel=1e-4)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """An M = 1 checkpoint written here (one main and one policy step, so
    both optimizers hold state), then two ranks at (1, 2) that write their
    own and resume this one."""
    tmp = tmp_path_factory.mktemp("tp_ckpt")
    cfg = flagship_cfg(tiny=True)
    model, _ = tbuilder.build_model(cfg, device="cpu")
    state = TrainState(
        build_optimizer("main", cfg.optim, model.main_net.parameters()),
        build_optimizer("policy", cfg.optim, model.policy_net.parameters()))
    rs = np.random.RandomState(4)
    x = [torch.from_numpy(rs.randn(*tbuilder.modality_input_shape(
        cfg, m, 4, cfg.model.num_segments)).astype(np.float32))
        for m in cfg.model.modality]
    for flags, cw in ((StageFlags.main_phase(), [0.0, 0.0]),
                      (StageFlags.policy_phase(), [1.0, 0.05])):
        make_adamml_train_step(model, flags=flags, penalty_type="blockdrop",
                               gammas=10.0, clip_gradient=None)(
            state, x, torch.arange(4) % 5, 1e-3, 1e-2, cw, seed=2)
    m1 = save_checkpoint(model, state, {"epoch": 1}, str(tmp / "m1"))
    results, _ = _launch(tmp, "checkpoints", worker=_TASKS, mesh_model=2,
                         logdir=str(tmp / "m2"), m1=m1)
    return results


def test_checkpoint_written_at_m2_loads_at_m1(checkpoints):
    """Rank 0 writes the gathered, unsharded model and optimizer states;
    the single process loads them bit for bit (parameters, BN statistics,
    SGD momentum, Adam moments and counts)."""
    a = checkpoints[0]
    assert a["model_equal"] and a["opt_equal"]


def test_pretrained_graft_at_m2_takes_each_ranks_rows(checkpoints):
    """``-e --pretrained``'s graft (ckpt/pretrained.py::_graft) of the
    M = 1 checkpoint at (1, 2): each rank's sharded weights hold its rows
    of the saved tensors and every other tensor the saved one, bit for bit,
    with the saved temperature; the eval step's decisions on both ranks
    equal the single process's graft and eval, and its logits within 1e-4
    (the sharded policy layers sum in another order)."""
    single = checkpoints[0]["pretrained_m1"]
    assert not single["rows"] and single["full"] and all(single["full"])
    for r in checkpoints:
        got = r["pretrained"]
        assert got["grafted"] == single["grafted"] > 0
        assert got["rows"] and all(got["rows"])
        assert got["full"] and all(got["full"])
        assert got["temperature"] == single["temperature"] != -1.0
        assert got["decisions"] == single["decisions"]
        np.testing.assert_allclose(got["logits"], single["logits"],
                                   rtol=1e-4, atol=1e-4)


def test_checkpoint_written_at_m1_resumes_at_m2(checkpoints):
    """Both ranks at (1, 2) read the M = 1 checkpoint: each sharded weight
    and its momentum and Adam moments hold the rank's rows of the saved
    tensors, every other tensor the saved one, bit for bit."""
    for r in checkpoints:
        assert r["sharded"] == SHARDED
        assert r["rows"] and all(r["rows"])
        assert r["full"] and all(r["full"])


# --------------------------------------------------------------------------
# both CLIs at --mesh_model 2, spawned on the CPU
# --------------------------------------------------------------------------

def _spawned_cli(tmp_path, module, argv):
    """``module.main(argv, device="cpu")`` in a child process (which spawns
    the ranks, one a --gpu id); its stdout."""
    code = ("import sys, torch; torch.set_num_threads(1); "
            "from adamml_tpu_torch.parallel import mesh; "
            "mesh.DEFAULT_TIMEOUT_S = 60.0; "
            f"from adamml_tpu_torch.cli import {module}; "
            f"sys.exit({module}.main(sys.argv[1:], device='cpu'))")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    p = subprocess.Popen([sys.executable, "-c", code, *argv,
                          "--multiprocessing-distributed", "--logdir",
                          str(tmp_path / "logs")], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    try:
        out, err = p.communicate(timeout=TIMEOUT_S)
    finally:
        p.kill()
        p.wait()
    assert p.returncode == 0, (out + err)[-4000:]
    return out


def _val_lines(out, rank):
    tag = "Val: " if rank == 0 else f"[rank {rank}] Val: "
    return [re.sub(r"Speed: [0-9.]+ ms/batch\t", "", ln[len(tag) - 5:])
            for ln in out.splitlines() if ln.startswith(tag)]


def test_train_unimodal_at_mesh_model_2(tmp_path):
    """train_unimodal spawning two CPU ranks at --mesh_model 2 trains and
    validates over 13 samples, the two ranks one data shard; both print
    the same Val line. (Its only Dense, the 31-class fc, does not divide
    by 2, so it stays whole, as in the JAX package.)"""
    out = _spawned_cli(tmp_path, "train_unimodal", [
        "--dataset", "synthetic", "--modality", "rgb", "--backbone_net",
        "resnet", "-d", "18", "--groups", "2", "-b", "8", "--epochs", "1",
        "--input_size", "16", "--synthetic_length", "13", "-j", "1",
        "--lr_scheduler", "multisteps", "--compute_dtype", "float32",
        "--gpu", "0,1", "--mesh_model", "2"])
    val = _val_lines(out, 0)
    assert len(val) == 1 and _val_lines(out, 1) == val


def test_train_adamml_at_2x2_packs_across_ranks(tmp_path):
    """train_adamml spawning four CPU ranks at --mesh_model 2 (two data
    shards of two) through the whole tiny curriculum, with eval capacity
    0.5 in one block (--capacity_groups 1, no multiple of the two shards,
    so the block spans them): every rank prints the same Val lines."""
    out = _spawned_cli(tmp_path, "train_adamml", [
        "--dataset", "synthetic", "--modality", "rgb", "sound", "-d", "18",
        "--groups", "4", "--num_segments", "2", "--dense_sampling",
        "--val_num_clips", "2", "-b", "8", "--epochs", "1",
        "--warmup_epochs", "1", "--finetune_epochs", "1", "--input_size",
        "32", "--audio_length", "0.16", "--synthetic_length", "8",
        "--causality_modeling", "lstm", "--cost_weights", "1.0", "0.05",
        "--compute_dtype", "float32", "--seed", "5", "-j", "1",
        "--gpu", "0,1,2,3", "--mesh_model", "2", "--eval_capacity", "0.5",
        "--capacity_groups", "1"])
    val = _val_lines(out, 0)
    assert len(val) == 2
    assert all(_val_lines(out, r) == val for r in (1, 2, 3))
