"""PyTorch port, the training slice, against the JAX package: train-mode
GroupedBatchNorm, the policy loss, the optimizers and clip, and two
alternating iterations (main, policy, main, policy) of the tiny flagship
AdaMML train step.

Float32 (``flagship_cfg(tiny=True)``: depth 18, 4 frames, 2 segments,
5 classes; the step runs 8 clips at 64x64), dropout 0 on both sides, and the zero-noise
straight-through decision patched into both policy nets
(tests/test_parity_training.py:52-55), so no generator stream enters the
comparison. Weights go across with load_flax_variables, and the JAX state
after each step is loaded into a fresh port model to compare tensor by
tensor. Tolerances, each with its reason, sit beside the comparisons.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

import __graft_entry__ as graft
from adamml_tpu.models import model_builder as jbuilder
from adamml_tpu.models import policy_net as jpolicy
from adamml_tpu.models.norm import GroupedBatchNorm as JBN
from adamml_tpu.train import losses as jlosses
from adamml_tpu.train import optim as joptim
from adamml_tpu.train import steps as jsteps
from adamml_tpu.train.train_state import AdaMMLTrainState
from adamml_tpu.train.train_state import StageFlags as JStageFlags
from adamml_tpu_torch.ckpt.flax_convert import load_flax_variables
from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.models import model_builder as tbuilder
from adamml_tpu_torch.models import policy_net as tpolicy
from adamml_tpu_torch.models.norm import GroupedBatchNorm
from adamml_tpu_torch.ops.augment import policy_stream
from adamml_tpu_torch.ops.kernels import depthwise as tdw
from adamml_tpu_torch.ops.kernels import tpool_fused as ttp
from adamml_tpu_torch.train import losses as tlosses
from adamml_tpu_torch.train import optim as toptim
from adamml_tpu_torch.train import steps as tsteps
from adamml_tpu_torch.train.train_state import StageFlags, TrainState

from torch_parity import (flax_variables, one_torch_thread,  # noqa: F401
                          st_zero_noise_jax, st_zero_noise_torch, t)

N = 4
LR, P_LR = 1e-3, 1e-2          # bench.py:159-160
COST = [1.0, 0.05]             # bench.py:161
STEP_CLIPS, STEP_INPUT_SIZE = 8, 64
PHASES = ("main", "policy", "main", "policy")


# --------------------------------------------------------------------------
# train-mode GroupedBatchNorm
# --------------------------------------------------------------------------

# (R, S, seq_inner, rows): global, replica groups, segments x frames, both,
# and a batch that does not split into whole groups (global fallback)
BN_CASES = [(1, 1, 1, 6), (2, 1, 1, 8), (1, 3, 2, 12), (2, 2, 2, 16),
            (1, 4, 1, 6)]


@pytest.mark.parametrize("return_affine", [False, True],
                         ids=["apply", "affine"])
@pytest.mark.parametrize("r,s,si,n", BN_CASES,
                         ids=[f"R{c[0]}S{c[1]}i{c[2]}n{c[3]}"
                              for c in BN_CASES])
def test_grouped_batchnorm_train(r, s, si, n, return_affine):
    """Outputs (or the (R, S, C) affine), gradients to x, scale and bias,
    and the folded running statistics against flax, float32. Tolerance 1e-5:
    the port applies x*a + b where flax applies (x - mean)*rsqrt*scale +
    bias, a reassociation of the same float32 math."""
    check_grouped_batchnorm(r, s, si, n, return_affine)


def check_grouped_batchnorm(r, s, si, n, return_affine):
    """test_grouped_batchnorm_train's comparison for one case."""
    rs = np.random.RandomState(r * 100 + s * 10 + si + n)
    x = (rs.randn(n, 3, 3, 16) * 2.0 + 0.5).astype(np.float32)
    jmod = JBN(use_running_average=False, groups=r, seq_groups=s,
               seq_inner=si, return_affine=return_affine)
    v = flax_variables(jmod, rs, jnp.asarray(x))

    def jfwd(params, xx):
        return jmod.apply({"params": params, "batch_stats": v["batch_stats"]},
                          xx, mutable=["batch_stats"])

    (want, mut) = jfwd(v["params"], jnp.asarray(x))
    outs = want if return_affine else (want,)
    cts = [rs.randn(*o.shape).astype(np.float32) for o in outs]
    _, vjp = jax.vjp(lambda p, xx: jfwd(p, xx)[0], v["params"],
                     jnp.asarray(x))
    jgp, jgx = vjp(tuple(jnp.asarray(c) for c in cts) if return_affine
                   else jnp.asarray(cts[0]))

    bn = load_flax_variables(GroupedBatchNorm(16, groups=r), v["params"],
                             v["batch_stats"])
    tx = t(x).requires_grad_(True)
    got = bn(tx, train=True, return_affine=return_affine, seq_groups=s,
             seq_inner=si)
    got = got if return_affine else (got,)
    for g, w in zip(got, outs):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    if return_affine:
        assert tuple(got[0].shape) == ((r, s, 16) if r * s > 1
                                       and n % (r * s * si) == 0
                                       else (1, 1, 16))
    grads = torch.autograd.grad(got, [tx, bn.weight, bn.bias],
                                [t(c) for c in cts])
    for g, w, name in zip(grads, (jgx, jgp["scale"], jgp["bias"]),
                          ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(bn, ours).numpy(),
            np.asarray(mut["batch_stats"][theirs]), rtol=1e-6, atol=1e-6,
            err_msg=ours)


def test_grouped_batchnorm_update_switch():
    """update_stats=False (set while a checkpoint recomputes) leaves the
    running statistics alone; the output is the same."""
    x = torch.randn(8, 2, 2, 8)
    bn = GroupedBatchNorm(8)
    want = bn(x, train=True, seq_groups=2)
    stats = (bn.running_mean.clone(), bn.running_var.clone())
    bn.update_stats = False
    got = bn(x, train=True, seq_groups=2)
    assert torch.equal(got, want)
    assert torch.equal(bn.running_mean, stats[0])
    assert torch.equal(bn.running_var, stats[1])


# --------------------------------------------------------------------------
# policy loss, optimizers, clip
# --------------------------------------------------------------------------

@pytest.mark.parametrize("penalty", ["blockdrop", "mean"])
@pytest.mark.parametrize("multi_hot", [False, True], ids=["labels", "multi"])
def test_compute_policy_loss(penalty, multi_hot):
    """Value and gradient w.r.t. the selection (1e-6: the same float32
    reductions)."""
    rs = np.random.RandomState(3)
    sel = (rs.rand(6, 3, 2) > 0.5).astype(np.float32)
    logits = rs.randn(6, 5).astype(np.float32)
    target = ((rs.rand(6, 5) > 0.6).astype(np.float32) if multi_hot
              else rs.randint(0, 5, 6))
    args = (COST, 10.0)
    want, jgrad = jax.value_and_grad(
        lambda s_: jlosses.compute_policy_loss(
            penalty, s_, jnp.asarray(COST), 10.0, jnp.asarray(logits),
            jnp.asarray(target)))(jnp.asarray(sel))
    ts = t(sel).requires_grad_(True)
    got = tlosses.compute_policy_loss(penalty, ts, *args, t(logits),
                                      t(target))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="penalty_type"):
        tlosses.compute_policy_loss("nope", ts, *args, t(logits), t(target))


@pytest.mark.parametrize("clip", [None, 0.5])
def test_optimizers_and_clip_match(clip):
    """Two steps of SGD (momentum, L2) and of Adam (L2) with the global-norm
    clip, against the JAX package's FusedSGD / optax Adam and
    clip_by_global_norm; 1e-6 on parameters of order 1 (float32)."""
    rs = np.random.RandomState(4)
    p0 = {"w": rs.randn(3, 4).astype(np.float32),
          "b": rs.randn(4).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in
              p0.items()} for _ in range(2)]
    cfg = flagship_cfg(tiny=True).optim
    for kind, lr in (("main", 0.1), ("policy", 0.01)):
        tx = joptim.build_optimizer(kind, cfg)
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        tp = {k: torch.nn.Parameter(t(v)) for k, v in p0.items()}
        opt = toptim.build_optimizer(kind, cfg, tp.values())
        st = tx.init(jp)
        for g in grads:
            jg = joptim.clip_by_global_norm(
                {k: jnp.asarray(v) for k, v in g.items()}, clip)
            if hasattr(tx, "apply"):
                jp, st = tx.apply(jg, st, jp, lr)
            else:
                upd, st = tx.update(jg, st, jp)
                jp = jax.tree_util.tree_map(lambda p, u: p - lr * u, jp, upd)
            for k, p in tp.items():
                p.grad = t(g[k])
            toptim.clip_by_global_norm(tp.values(), clip)
            toptim.set_lr(opt, lr)
            opt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{kind} {k}")


# --------------------------------------------------------------------------
# the tiny flagship train step, two alternating iterations
# --------------------------------------------------------------------------

def _inputs(cfg, rs, clips=N):
    s = cfg.model.num_segments
    return [rs.randn(*tbuilder.modality_input_shape(cfg, m, clips, s)).astype(
        np.float32) for m in cfg.model.modality]


def _center_rgb_decisions(tmodel, x, params):
    """Shift the rgb decision head's 'on' bias to the median train-mode
    margin, so the zero-noise rgb decisions are mixed and the ResNet path
    (and the fused epilogue's backward) carries gradient. Writes the same
    bias into the flax tree. A copy of the policy net measures the margins,
    so the model's BN statistics do not move."""
    pol = copy.deepcopy(tmodel.policy_net)
    bias = params["policy_net"]["lstm"]["fc_0"]["bias"]
    size = tmodel.policy_input_size

    def margins():
        with torch.no_grad():
            _, logits = pol([policy_stream(t(x[0]), size), t(x[1])], 5.0,
                            train=True)
        return (logits[:, 0, :, 1] - logits[:, 0, :, 0]).flatten()

    for _ in range(3):
        bias[1] -= float(margins().median()) + 1e-3
        for net in (pol, tmodel.policy_net):
            with torch.no_grad():
                net.lstm.fc_0.bias.copy_(torch.from_numpy(bias))
    assert margins().abs().min() > 1e-4


def _torch_tensors(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _snapshot_grads(opt, into):
    """Keep the gradients an optimizer is about to apply."""
    names = {id(p): n for n, p in into["model"].named_parameters()}

    def hook(o, args, kwargs):
        into["grads"] = {names[id(p)]: p.grad.clone()
                         for g in o.param_groups for p in g["params"]
                         if p.grad is not None}
    opt.register_step_pre_hook(hook)


def _jax_grad_fn(jmodel, live_key, with_policy_loss):
    """jit(grad) of the step's loss w.r.t. its live subtree, at a state."""

    def fn(state, x, target, cw):
        def loss_fn(live):
            params = {**state.params, live_key: live}
            (logits, dec), _ = jmodel.apply(
                {"params": params, "batch_stats": state.batch_stats}, x,
                state.temperature, train=True, mutable=["batch_stats"],
                rngs={"gumbel": jax.random.PRNGKey(0),
                      "dropout": jax.random.PRNGKey(1)})
            loss = jlosses.cross_entropy(logits, target)
            if with_policy_loss:
                loss = loss + jlosses.compute_policy_loss(
                    "blockdrop", dec, cw, 10.0, logits, target)
            return loss
        return jax.grad(loss_fn)(state.params[live_key])

    return jax.jit(fn)


def run_alternating(phases, use_pallas_dw=False, policy_input_size=None,
                    bn_groups=None, clips=STEP_CLIPS):
    """Both frameworks take the same steps (``phases``, each "main" or
    "policy") from the same weights, at the tiny config's policy-stream
    size unless ``policy_input_size`` is given, with --sync-bn (the
    flagship's) unless ``bn_groups`` R is given: then per-replica BN, the
    JAX package on a data mesh of R (``mesh_data`` R) against the port's
    one process at ``bn_groups`` R, on ``clips`` clips; after each, the
    metrics, the port's
    tensors and gradients, the JAX state and its gradient at the step's
    start (both in the port's layout), the number of plain-backward calls of
    the fused epilogue, and the depthwise op's calls by launch key (forward,
    stride-1 input gradient). 8 clips at 64x64: at fewer samples per BN
    group the gradient is ill-conditioned (JAX's own jitted and eager
    gradients disagree by more than the tolerances)."""
    cfg = flagship_cfg(tiny=True)
    jcfg = graft._flagship_cfg(tiny=True)
    cfg.model.dropout = jcfg.model.dropout = 0.0
    cfg.data.input_size = jcfg.data.input_size = STEP_INPUT_SIZE
    cfg.model.use_pallas_dw = jcfg.model.use_pallas_dw = use_pallas_dw
    if policy_input_size is not None:
        cfg.model.policy_input_size = policy_input_size
        jcfg.model.policy_input_size = policy_input_size
    if bn_groups is not None:
        cfg.runtime.sync_bn = jcfg.runtime.sync_bn = False
        jcfg.runtime.mesh_data = bn_groups
    rs = np.random.RandomState(0)
    x = _inputs(cfg, rs, clips)
    target = rs.randint(0, cfg.model.num_classes, clips)
    jmodel, _ = jbuilder.build_model(jcfg)
    v = flax_variables(jmodel, rs, [jnp.asarray(a) for a in x], train=False)
    assert jbuilder._bn_groups(jcfg) == (bn_groups or 1)
    tmodel, _ = tbuilder.build_model(cfg, device="cpu", bn_groups=bn_groups)
    load_flax_variables(tmodel, v["params"], v["batch_stats"])

    def port_layout(params, stats):
        ref, _ = tbuilder.build_model(cfg, device="cpu")
        load_flax_variables(ref, jax.tree_util.tree_map(np.asarray, params),
                            jax.tree_util.tree_map(np.asarray, stats))
        return ref

    bwd_calls, dw_calls = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpolicy, "gumbel_decision", st_zero_noise_torch)
        mp.setattr(jpolicy, "gumbel_decision", st_zero_noise_jax)
        real_bwd = ttp.reference_bwd
        mp.setattr(ttp, "reference_bwd",
                   lambda *a: bwd_calls.append(1) or real_bwd(*a))
        real_dw = tdw._dw
        mp.setattr(tdw, "_dw", lambda *a: dw_calls.append(
            a[6] if len(a) > 6 else tdw.KERNEL) or real_dw(*a))
        _center_rgb_decisions(tmodel, x, v["params"])

        tx_main = joptim.build_optimizer("main", jcfg.optim)
        tx_policy = joptim.build_optimizer("policy", jcfg.optim)
        params = jax.tree_util.tree_map(jnp.asarray, v["params"])
        jstate = AdaMMLTrainState.create(
            params, jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
            tx_main.init(params["main_net"]),
            tx_policy.init(params["policy_net"]))
        common = dict(penalty_type="blockdrop", gammas=10.0,
                      clip_gradient=None)
        jflags = {"main": JStageFlags.main_phase(),
                  "policy": JStageFlags.policy_phase()}
        tflags = {"main": StageFlags.main_phase(),
                  "policy": StageFlags.policy_phase()}
        jstep = {p: jsteps.make_adamml_train_step(
            jmodel, tx_main, tx_policy, flags=jflags[p],
            has_policy_params=True, **common) for p in jflags}
        jgrad = {p: _jax_grad_fn(jmodel, f"{p}_net", p == "policy")
                 for p in jflags}
        tstep = {p: tsteps.make_adamml_train_step(tmodel, flags=tflags[p],
                                                  **common) for p in tflags}
        tstate = TrainState(
            toptim.build_optimizer("main", cfg.optim,
                                   tmodel.main_net.parameters()),
            toptim.build_optimizer("policy", cfg.optim,
                                   tmodel.policy_net.parameters()))
        grads = {"model": tmodel}
        for opt in (tstate.main_opt, tstate.policy_opt):
            _snapshot_grads(opt, grads)
        jx, jt = [jnp.asarray(a) for a in x], jnp.asarray(target)
        tx, tt = [t(a) for a in x], t(target)
        records = []
        for i, phase in enumerate(phases):
            if i:
                _sync_state(tmodel, tstate, jstate, port_layout)
            start = _torch_tensors(tmodel)
            cw = COST if phase == "policy" else [0.0, 0.0]
            jg = jgrad[phase](jstate, jx, jt, jnp.asarray(cw))
            # numpy now: the JAX step donates the state's buffers
            jg_full = jax.tree_util.tree_map(
                np.asarray, {**jstate.params, f"{phase}_net": jg})
            jstate, jm = jstep[phase](jstate, jx, jt, jnp.asarray(LR),
                                      jnp.asarray(P_LR), jnp.asarray(cw),
                                      jax.random.PRNGKey(0))
            before, dw_before = len(bwd_calls), len(dw_calls)
            tm = tstep[phase](tstate, tx, tt, LR, P_LR, cw, seed=0)
            dw_step = dw_calls[dw_before:]
            records.append({
                "phase": phase, "start": start,
                "jax_metrics": {k: np.asarray(m) for k, m in jm.items()},
                "torch_metrics": {k: m.numpy() for k, m in tm.items()},
                "torch": _torch_tensors(tmodel),
                "jax": _torch_tensors(port_layout(jstate.params,
                                                  jstate.batch_stats)),
                "torch_grads": grads.pop("grads"),
                "jax_grads": dict(port_layout(
                    jg_full, jstate.batch_stats).named_parameters()),
                "bwd_calls": len(bwd_calls) - before,
                "dw_calls": {k: dw_step.count(k) for k in tdw.launch_counts}})
    assert tstate.step == len(phases)
    return records


@pytest.fixture(scope="module")
def train_run():
    return run_alternating(PHASES)


def _sync_state(tmodel, tstate, jstate, port_layout):
    """Copy the JAX state into the port before a step, so that every step is
    compared from one state: parameters, BN statistics, the SGD momentum
    (FusedSGD's raveled trace) and the Adam moments and count, for each
    optimizer that has stepped."""
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    stats = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    load_flax_variables(tmodel, params, stats)

    def in_port_layout(key, tree):
        model = port_layout({**params, key: tree}, stats)
        return dict(getattr(model, key).named_parameters())

    main = dict(tmodel.main_net.named_parameters())
    if tstate.main_opt.state:
        _, unravel = ravel_pytree(jstate.params["main_net"])
        trace = in_port_layout("main_net", unravel(
            jstate.main_opt["trace"]))
        for name, p in main.items():
            tstate.main_opt.state[p]["momentum_buffer"] = (
                trace[name].detach().clone())
    if tstate.policy_opt.state:
        adam = [s_ for s_ in jstate.policy_opt if hasattr(s_, "mu")][0]
        mu = in_port_layout("policy_net", adam.mu)
        nu = in_port_layout("policy_net", adam.nu)
        for name, p in tmodel.policy_net.named_parameters():
            st = tstate.policy_opt.state[p]
            st["exp_avg"] = mu[name].detach().clone()
            st["exp_avg_sq"] = nu[name].detach().clone()
            st["step"] = torch.tensor(float(adam.count))


STEP_IDS = [f"{i}-{p}" for i, p in enumerate(PHASES)]


def _live(phase):
    return f"{phase}_net."


def check_metrics(rec, first_step):
    """Decisions are exact (the selection and top-1/top-5 equal); losses
    within 1e-4 relative (float32 reductions in another order, after the
    earlier steps' updates)."""
    want, got = rec["jax_metrics"], rec["torch_metrics"]
    assert set(got) == set(want)
    for k in ("selection", "top1", "top5"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("loss", "cls_loss", "policy_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    if first_step:  # mixed decisions: both backbones reach the loss
        assert 0.0 < float(got["selection"][0]) < 1.0


def check_gradients(rec):
    """The live subnet's gradient against JAX's at the step's start: within
    3% in norm over the whole subnet. The tiny model's gradient is not
    better conditioned than that: JAX's own jitted and eager gradients
    disagree at the percent level, and activations that float32 reordering
    moves across a ReLU's 0 switch single elements."""
    live = _live(rec["phase"])
    got, want = rec["torch_grads"], rec["jax_grads"]
    names = [n for n in want if n.startswith(live)]
    assert sorted(got) == sorted(names)
    num = sum(float(((got[n] - want[n].detach()) ** 2).sum()) for n in names)
    den = sum(float((want[n].detach() ** 2).sum()) for n in names)
    # with every decision off (after the first policy step) the main net's
    # logits are masked to 0 and its gradient is exactly 0 on both sides
    assert num <= 0.03 ** 2 * den


def check_parameters(rec):
    """Every live parameter's update from the shared start. SGD's update is
    linear in the gradient (and the momentum): each element within 0.1 * lr
    of JAX's. Adam's normalizes each element by its own size, so a gradient
    element within float32 noise of -wd * p steps by about +-p_lr on either
    side: 99% of the policy elements within 0.1 * p_lr (Adam itself matches
    optax exactly, test_optimizers_and_clip_match)."""
    live = _live(rec["phase"])
    lr = LR if rec["phase"] == "main" else P_LR
    close = total = 0
    for name in rec["jax_grads"]:
        if not name.startswith(live):
            continue
        off = (rec["torch"][name] - rec["jax"][name]).abs() > 0.1 * lr
        close += int((~off).sum())
        total += off.numel()
        if rec["phase"] == "main":
            assert not bool(off.any()), name
    assert close / total >= 0.99


def check_bn_statistics(rec):
    """Every BN running statistic, of the live and the frozen subnet: within
    2e-4 (float32 moments of activations that 18 float32 layers summed in
    another order move apart by about 1e-5 relative)."""
    buffers = [k for k in rec["torch"] if k.endswith(("running_mean",
                                                       "running_var"))]
    assert len(buffers) > 100
    for name in buffers:
        np.testing.assert_allclose(rec["torch"][name].numpy(),
                                   rec["jax"][name].numpy(), rtol=1e-4,
                                   atol=2e-4, err_msg=name)


def check_freezes(rec):
    """The frozen subnet's parameters are bit-unchanged and the live one's
    move; BN statistics of both move. The fused epilogue's backward runs at
    each pooled stage boundary (two at F=4) in the main phase only: in the
    policy phase no gradient reaches the main net."""
    prev = rec["start"]
    live = _live(rec["phase"])
    moved = {"live": 0, "frozen": 0, "stats": 0}
    for name in rec["jax_grads"]:
        changed = not torch.equal(prev[name], rec["torch"][name])
        moved["live" if name.startswith(live) else "frozen"] += changed
    for name in prev:
        if name.endswith("running_mean"):
            moved["stats"] += not torch.equal(prev[name], rec["torch"][name])
    assert moved["frozen"] == 0 and moved["live"] > 50 and moved["stats"] > 50
    assert rec["bwd_calls"] == (2 if rec["phase"] == "main" else 0)


@pytest.mark.parametrize("i", range(len(PHASES)), ids=STEP_IDS)
def test_train_step_metrics(train_run, i):
    check_metrics(train_run[i], i == 0)


@pytest.mark.parametrize("i", range(len(PHASES)), ids=STEP_IDS)
def test_train_step_gradients(train_run, i):
    check_gradients(train_run[i])


@pytest.mark.parametrize("i", range(len(PHASES)), ids=STEP_IDS)
def test_train_step_parameters(train_run, i):
    """The frozen subnet does not move
    (test_train_step_freezes_and_runs_fused_backward)."""
    check_parameters(train_run[i])


@pytest.mark.parametrize("i", range(len(PHASES)), ids=STEP_IDS)
def test_train_step_bn_statistics(train_run, i):
    check_bn_statistics(train_run[i])


@pytest.mark.parametrize("i", range(len(PHASES)), ids=STEP_IDS)
def test_train_step_freezes_and_runs_fused_backward(train_run, i):
    """With use_pallas_dw off the depthwise op is never called."""
    check_freezes(train_run[i])
    assert set(train_run[i]["dw_calls"].values()) == {0}


def test_policy_remat_lands_statistics_once():
    """One policy-phase step with the trunks rematerialized and one without:
    the same BN statistics and parameters (the checkpoint's recompute does
    not update the statistics a second time) and the same loss."""
    cfg = flagship_cfg(tiny=True)
    cfg.model.dropout = 0.0
    x = [t(a) for a in _inputs(cfg, np.random.RandomState(5))]
    target = torch.arange(N) % cfg.model.num_classes
    out = []
    for remat_policy in (True, False):
        cfg.model.remat_policy = remat_policy
        model, _ = tbuilder.build_model(cfg, device="cpu")
        state = TrainState(
            toptim.build_optimizer("main", cfg.optim,
                                   model.main_net.parameters()),
            toptim.build_optimizer("policy", cfg.optim,
                                   model.policy_net.parameters()))
        step = tsteps.make_adamml_train_step(
            model, flags=StageFlags.policy_phase(), penalty_type="blockdrop",
            gammas=10.0, clip_gradient=None)
        m = step(state, x, target, LR, P_LR, COST, seed=3)
        out.append((m["loss"], _torch_tensors(model)))
    assert out[0][0] == out[1][0]
    for name, v in out[0][1].items():
        assert torch.equal(v, out[1][1][name]), name


def test_backbone_remat_matches():
    """remat_backbone: a main-phase step gives the same parameters and BN
    statistics as without it."""
    cfg = flagship_cfg(tiny=True)
    cfg.model.dropout = 0.0
    x = [t(a) for a in _inputs(cfg, np.random.RandomState(6))]
    target = torch.arange(N) % cfg.model.num_classes
    out = []
    for remat_backbone in (True, False):
        cfg.model.remat_backbone = remat_backbone
        model, _ = tbuilder.build_model(cfg, device="cpu")
        state = TrainState(toptim.build_optimizer(
            "main", cfg.optim, model.main_net.parameters()), None)
        step = tsteps.make_adamml_train_step(
            model, flags=StageFlags.main_phase(), penalty_type="blockdrop",
            gammas=10.0, clip_gradient=None)
        step(state, x, target, LR, P_LR, [0.0, 0.0], seed=4)
        out.append(_torch_tensors(model))
    for name, v in out[0].items():
        torch.testing.assert_close(v, out[1][name], rtol=0, atol=0,
                                   msg=name)


def test_train_step_draws_seeded_dropout():
    """Dropout and Gumbel noise come from generators seeded by (seed, step):
    the same seed gives the same step whatever the global generator holds;
    another seed another."""
    cfg = flagship_cfg(tiny=True)
    x = [t(a) for a in _inputs(cfg, np.random.RandomState(7))]
    target = torch.arange(N) % cfg.model.num_classes
    losses = []
    for seed, global_seed in ((1, 0), (1, 99), (2, 0)):
        torch.manual_seed(global_seed)
        model, _ = tbuilder.build_model(cfg, device="cpu")
        state = TrainState(toptim.build_optimizer(
            "main", cfg.optim, model.main_net.parameters()), None)
        step = tsteps.make_adamml_train_step(
            model, flags=StageFlags.main_phase(), penalty_type="blockdrop",
            gammas=10.0, clip_gradient=None)
        losses.append(float(step(state, x, target, LR, P_LR, [0.0, 0.0],
                                 seed=seed)["loss"]))
    assert losses[0] == losses[1] != losses[2]
