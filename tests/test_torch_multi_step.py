"""PyTorch port, the multi-step dispatch (``make_adamml_multi_step``: K real
steps per call; on the CPU K calls of the single step, on a card one
replayed CUDA graph, tests/test_torch_gpu.py) against the JAX package's
scanned ``make_adamml_multi_step``, against K single steps, and through the
epoch engine (tests/test_e2e.py's TestMultiStepDispatch mirrored).

The JAX comparison takes the settings of tests/test_torch_train.py: the
tiny flagship config in float32, 8 clips at 64x64, dropout 0 and the
zero-noise straight-through decision on both sides, the rgb decision head
centred so that both backbones carry gradient; K = 3 steps of one phase
from one state, with no state copied between the steps. Tolerances sit
beside the comparisons.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from adamml_tpu.models import model_builder as jbuilder
from adamml_tpu.models import policy_net as jpolicy
from adamml_tpu.train import optim as joptim
from adamml_tpu.train import steps as jsteps
from adamml_tpu.train.train_state import AdaMMLTrainState
from adamml_tpu.train.train_state import StageFlags as JStageFlags
from adamml_tpu_torch.ckpt.flax_convert import load_flax_variables
from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.models import model_builder as tbuilder
from adamml_tpu_torch.models import policy_net as tpolicy
from adamml_tpu_torch.train import engine as tengine
from adamml_tpu_torch.train import optim as toptim
from adamml_tpu_torch.train import steps as tsteps
from adamml_tpu_torch.train.train_state import StageFlags, TrainState

from test_torch_train import (COST, LR, P_LR, STEP_CLIPS, STEP_INPUT_SIZE,
                              _center_rgb_decisions, _inputs, _torch_tensors)
from torch_parity import (flax_variables, one_torch_thread,  # noqa: F401
                          st_zero_noise_jax, st_zero_noise_torch, t)

K = 3
# the policy phase's learning rate over the K steps: Adam moves an element
# whose gradient is float32 noise by about +-p_lr either way, and with no
# state copied between the steps those flips feed the policy trunks'
# activations; at bench.py's 1e-2 the trunks' BN statistics part by 15%
# in three steps, at 1e-5 by 8e-4 (the single step at 1e-2 is
# tests/test_torch_train.py's)
P_LR_K = 1e-5
PHASES = ("main", "policy")
FLAGS = {"main": StageFlags.main_phase(),
         "policy": StageFlags.policy_phase()}
COMMON = dict(penalty_type="blockdrop", gammas=10.0, clip_gradient=None)


def _stacked(batches):
    """K (inputs, target) pairs -> (per-modality stacks, stacked targets)."""
    xs = [np.stack([b[0][mi] for b in batches])
          for mi in range(len(batches[0][0]))]
    return xs, np.stack([b[1] for b in batches])


def _state(cfg, model):
    return TrainState(
        toptim.build_optimizer("main", cfg.optim,
                               model.main_net.parameters()),
        toptim.build_optimizer("policy", cfg.optim,
                               model.policy_net.parameters()))


@pytest.fixture(scope="module", params=PHASES)
def jax_pair(request):
    """K steps of one phase on both frameworks from the same weights: the
    metrics with their K axis and both models' tensors after the K steps,
    in the port's layout."""
    phase = request.param
    cfg = flagship_cfg(tiny=True)
    jcfg = graft._flagship_cfg(tiny=True)
    cfg.model.dropout = jcfg.model.dropout = 0.0
    cfg.data.input_size = jcfg.data.input_size = STEP_INPUT_SIZE
    rs = np.random.RandomState(2)
    batches = [(_inputs(cfg, rs, STEP_CLIPS),
                rs.randint(0, cfg.model.num_classes, STEP_CLIPS))
               for _ in range(K)]
    xs, ts = _stacked(batches)
    jmodel, _ = jbuilder.build_model(jcfg)
    v = flax_variables(jmodel, rs, [jnp.asarray(a) for a in batches[0][0]],
                       train=False)
    tmodel, _ = tbuilder.build_model(cfg, device="cpu")
    load_flax_variables(tmodel, v["params"], v["batch_stats"])
    cw = COST if phase == "policy" else [0.0, 0.0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpolicy, "gumbel_decision", st_zero_noise_torch)
        mp.setattr(jpolicy, "gumbel_decision", st_zero_noise_jax)
        _center_rgb_decisions(tmodel, batches[0][0], v["params"])
        tx_main = joptim.build_optimizer("main", jcfg.optim)
        tx_policy = joptim.build_optimizer("policy", jcfg.optim)
        params = jax.tree_util.tree_map(jnp.asarray, v["params"])
        jstate = AdaMMLTrainState.create(
            params, jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
            tx_main.init(params["main_net"]),
            tx_policy.init(params["policy_net"]))
        jflags = (JStageFlags.main_phase() if phase == "main"
                  else JStageFlags.policy_phase())
        jmulti = jsteps.make_adamml_multi_step(
            jmodel, tx_main, tx_policy, flags=jflags,
            has_policy_params=True, **COMMON)
        jstate, jm = jmulti(jstate, [jnp.asarray(a) for a in xs],
                            jnp.asarray(ts), jnp.asarray(LR),
                            jnp.asarray(P_LR_K), jnp.asarray(cw),
                            jax.random.PRNGKey(0))
        tstate = _state(cfg, tmodel)
        tmulti = tsteps.make_adamml_multi_step(tmodel, flags=FLAGS[phase],
                                               **COMMON)
        tm = tmulti(tstate, [t(a) for a in xs], t(ts), LR, P_LR_K, cw,
                    seed=0)
    ref, _ = tbuilder.build_model(cfg, device="cpu")
    load_flax_variables(ref, jax.tree_util.tree_map(np.asarray,
                                                    jstate.params),
                        jax.tree_util.tree_map(np.asarray,
                                               jstate.batch_stats))
    return dict(phase=phase, tstep=tstate.step, jstep=int(jstate.step),
                jax_metrics={k: np.asarray(m) for k, m in jm.items()},
                torch_metrics={k: m.numpy() for k, m in tm.items()},
                jax=_torch_tensors(ref), torch=_torch_tensors(tmodel),
                live={n for n, _ in tmodel.named_parameters()
                      if n.startswith(f"{phase}_net.")})


def test_multi_step_metrics_match_jax(jax_pair):
    """Every metric has the K axis; per step the decisions are the same
    (top-1/top-5 equal; the selection rates equal to 1e-7, since inside
    JAX's scan a straight-through decision can land one ulp off 0/1,
    ROADMAP C) and the losses within 1e-4 relative, the single step's
    tolerance (tests/test_torch_train.py)."""
    want, got = jax_pair["jax_metrics"], jax_pair["torch_metrics"]
    assert set(got) == set(want)
    assert jax_pair["tstep"] == jax_pair["jstep"] == K
    for k in want:
        assert got[k].shape[0] == K == want[k].shape[0], k
    for k in ("top1", "top5"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["selection"], want["selection"], rtol=0,
                               atol=1e-7)
    assert 0.0 < float(got["selection"][0, 0]) < 1.0
    for k in ("loss", "cls_loss", "policy_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_multi_step_parameters_match_jax(jax_pair):
    """The live subnet's parameters after the K steps. SGD (main): each
    element within 0.1 * lr per step taken, K * 0.1 * lr, since nothing
    is copied between the steps and the single step's 0.1 * lr can add up.
    Adam (policy, at P_LR_K): an element whose gradient is within float32
    noise of -wd * p steps by about +-p_lr either way, which leaves 99% of
    the elements within 0.1 * p_lr after one step
    (tests/test_torch_train.py); each of the K steps can flip another 1%,
    so 1 - K * 1% of them within K * 0.1 * p_lr (measured: 98.4%). The
    frozen subnet does not move on either side."""
    lr = LR if jax_pair["phase"] == "main" else P_LR_K
    close = total = 0
    for name in jax_pair["live"]:
        off = (jax_pair["torch"][name] - jax_pair["jax"][name]).abs() > (
            K * 0.1 * lr)
        close += int((~off).sum())
        total += off.numel()
        if jax_pair["phase"] == "main":
            assert not bool(off.any()), name
    assert close / total >= 1.0 - K * 0.01
    for name, p in jax_pair["torch"].items():
        if (name.endswith(("weight", "bias", "lf_weights"))
                and name not in jax_pair["live"]):
            torch.testing.assert_close(p, jax_pair["jax"][name], rtol=0,
                                       atol=0, msg=name)


def test_multi_step_bn_statistics_match_jax(jax_pair):
    """Every BN running statistic after the K steps, in relative norm per
    tensor within 2e-3 (largest measured: 2.4e-4 main, 7.7e-4 policy).
    The single step holds each element to 2e-4 (tests/test_torch_train.py),
    but here steps 2..K fold in the moments of activations of weights that
    already differ by the parameter tolerance, which moves single elements
    of the deep layers' variances by up to 1e-3 relative."""
    buffers = [k for k in jax_pair["torch"]
               if k.endswith(("running_mean", "running_var"))]
    assert len(buffers) > 100
    for name in buffers:
        got, want = jax_pair["torch"][name], jax_pair["jax"][name]
        rel = float((got - want).norm() / want.norm())
        assert rel <= 2e-3, (name, rel)


@pytest.mark.parametrize("phase", PHASES)
def test_multi_step_equals_single_steps(phase):
    """K = 3 in one call equals 3 single steps bit for bit (parameters, BN
    statistics, optimizer state, metrics, step count), real Gumbel and
    dropout noise included: each step draws from (seed, step) as the single
    step does."""
    cfg = flagship_cfg(tiny=True)
    rs = np.random.RandomState(3)
    batches = [([t(a) for a in _inputs(cfg, rs)],
                t(rs.randint(0, cfg.model.num_classes, 4)))
               for _ in range(K)]
    out = []
    for multi in (False, True):
        model, _ = tbuilder.build_model(cfg, device="cpu")
        state = _state(cfg, model)
        if multi:
            fn = tsteps.make_adamml_multi_step(model, flags=FLAGS[phase],
                                               **COMMON)
            xs = [torch.stack([b[0][mi] for b in batches]) for mi in (0, 1)]
            m = fn(state, xs, torch.stack([b[1] for b in batches]), LR,
                   P_LR, COST, seed=5)
        else:
            fn = tsteps.make_adamml_train_step(model, flags=FLAGS[phase],
                                               **COMMON)
            ms = [fn(state, x, y, LR, P_LR, COST, seed=5)
                  for x, y in batches]
            m = {k: torch.stack([mi[k] for mi in ms]) for k in ms[0]}
        opt = state.main_opt if phase == "main" else state.policy_opt
        out.append((m, _torch_tensors(model), state.step,
                    [v.clone() for st in opt.state.values()
                     for v in st.values()]))
    (m0, t0, s0, o0), (m1, t1, s1, o1) = out
    assert s0 == s1 == K
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for name in t0:
        assert torch.equal(t0[name], t1[name]), name
    assert len(o0) == len(o1) > 0
    assert all(torch.equal(a, b) for a, b in zip(o0, o1))


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def test_engine_dispatches_k_steps_and_the_tail():
    """train_epoch with steps_per_dispatch=2 over 5 batches: 2 dispatches
    of 2 steps and 1 single step, state.step 5, the same parameters and
    BN statistics (bit for bit) and epoch averages as with K = 1, and a
    profiler called at every loader index (tests/test_e2e.py:337,391)."""
    cfg = flagship_cfg(tiny=True)
    rs = np.random.RandomState(4)
    batches = [([t(a) for a in _inputs(cfg, rs, 2)],
                t(rs.randint(0, cfg.model.num_classes, 2)))
               for _ in range(5)]
    runs = []
    for k in (1, 2):
        model, _ = tbuilder.build_model(cfg, device="cpu")
        state = _state(cfg, model)
        step = tsteps.make_adamml_train_step(model, flags=FLAGS["main"],
                                             **COMMON)
        multi = tsteps.make_adamml_multi_step(model, flags=FLAGS["main"],
                                              **COMMON)
        calls = {"single": 0, "multi": 0}

        def counted(name, fn):
            def run(*args):
                calls[name] += 1
                return fn(*args)
            return run

        seen = []
        profiler = type("P", (), {"step": lambda self, i: seen.append(i)})()
        state, summary = tengine.train_epoch(
            _Loader(batches), lambda b: b, counted("single", step), state,
            lr=LR, p_lr=P_LR, cost_weights=[0.0, 0.0], seed=9,
            modality=["rgb", "sound"], profiler=profiler,
            multi_step_fn=counted("multi", multi), steps_per_dispatch=k)
        assert state.step == 5 and summary["num_batch"] == 5
        assert seen == list(range(5))
        runs.append((calls, _torch_tensors(model), summary))
    assert runs[0][0] == {"single": 5, "multi": 0}
    assert runs[1][0] == {"single": 1, "multi": 2}
    for name, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][name]), name
    for key in ("loss", "top1", "top5", "selection"):
        assert runs[0][2][key] == runs[1][2][key], key


def test_unimodal_trainer_refuses_multi_step():
    cfg = flagship_cfg(tiny=True)
    cfg.optim.steps_per_dispatch = 2
    from adamml_tpu_torch.train.curriculum import UnimodalTrainer

    with pytest.raises(ValueError, match="steps_per_dispatch"):
        UnimodalTrainer(cfg, device="cpu")
