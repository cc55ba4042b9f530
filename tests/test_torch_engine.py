"""PyTorch port, the epoch engine and the checkpoints.

The engine against the JAX package's (tests/test_engine.py and
tests/test_eval_padding.py mirrored): with stub steps that return fixed
metrics on both sides, ``train_epoch`` summaries and display lines and
``validate`` outputs are equal -- the bulk metric fetch, the padded val
tail masked out with its loss re-scored on the host, and the val-list row
order restored from shard-interleaved rows. Values equal to float64
rounding (1e-12).

Checkpoints: the save/load round trip restores parameters, BN statistics,
both optimizers' states, temperature and step; the file names and meta keys
are the JAX layout's; a JAX (orbax) checkpoint's meta is refused.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adamml_tpu.data.dataflow import HostDataLoader as JLoader
from adamml_tpu.train import engine as jengine
from adamml_tpu_torch.ckpt import checkpoint as tckpt
from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.data.dataflow import HostDataLoader as TLoader
from adamml_tpu_torch.train import engine as tengine
from adamml_tpu_torch.train.optim import build_optimizer
from adamml_tpu_torch.train.train_state import TrainState

from torch_parity import one_torch_thread, t  # noqa: F401

TOL = 1e-12


class _FakeLoader:
    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, e):
        self.epoch = e

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


class _Logger:
    def __init__(self):
        self.lines = []

    def log(self, m):
        self.lines.append(m)


def _masked_fields(line):
    """A display line without its host timings."""
    return [f for f in line.split("\t")
            if not f.startswith(("Time", "Wall", "Data"))]


@pytest.mark.parametrize("adamml", [False, True], ids=["unimodal", "adamml"])
def test_train_epoch_summary_matches(adamml):
    """Five batches of 4, display every 2 steps: the loss, top-1/top-5 and
    selection averages, the batch count and the display lines (timings
    aside) of both engines."""
    rs = np.random.RandomState(0)
    # float32 metrics, as both steps return them
    losses = (rs.rand(5) * 3).astype(np.float32)
    top1 = (rs.rand(5) * 100).astype(np.float32)
    sel = rs.rand(5, 2).astype(np.float32)
    batches = [{"i": np.asarray(i), "y": np.arange(4) % 3} for i in range(5)]

    def metrics(i, lib):
        out = {"loss": lib(losses[i]), "top1": lib(top1[i]),
               "top5": lib(np.float32(100.0 - i))}
        if adamml:
            out["selection"] = lib(sel[i])
        return out

    def jstep(state, inputs, target, *args):
        return state + 1, metrics(int(inputs), jnp.asarray)

    def tstep(state, inputs, target, *args):
        state["n"] += 1
        return metrics(int(inputs), lambda v: torch.tensor(v))

    kw = dict(lr=0.1, display=2, rank=0, epoch=3, adamml=adamml,
              modality=["rgb", "sound"] if adamml else None)
    jlog, tlog = _Logger(), _Logger()
    jstate, jsum = jengine.train_epoch(
        _FakeLoader(batches), lambda b: (jnp.asarray(b["i"]),
                                         jnp.asarray(b["y"])),
        jstep, jnp.asarray(0), logger=jlog, **kw)
    tstate, tsum = tengine.train_epoch(
        _FakeLoader(batches), lambda b: (t(b["i"]), t(b["y"])), tstep,
        {"n": 0}, logger=tlog, **kw)
    assert int(jstate) == tstate["n"] == 5
    assert tsum["num_batch"] == jsum["num_batch"] == 5
    for k in ("loss", "top1", "top5"):
        assert tsum[k] == pytest.approx(jsum[k], rel=TOL), k
    assert tsum["selection"].keys() == jsum["selection"].keys()
    for k in jsum["selection"]:
        assert tsum["selection"][k] == pytest.approx(jsum["selection"][k],
                                                     rel=TOL)
    assert len(tlog.lines) == len(jlog.lines) == 3
    for a, b in zip(tlog.lines, jlog.lines):
        assert _masked_fields(a) == _masked_fields(b)


class _IdxDataset:
    """Payload IS the index, so padding provenance is checkable
    (tests/test_eval_padding.py)."""

    modality = ["rgb"]

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return ({"rgb": {"frames": np.full((1, 4, 4, 3), i, np.uint8),
                         "hw": np.asarray([4, 4])}}, i % 3)


def _logits(hb):
    """Logits right for the sample's label (index % 3) with a margin that
    varies per row, so the loss and mAP see every row."""
    idx = hb["rgb_frames"][:, 0, 0, 0, 0].astype(np.int64)
    logits = np.zeros((len(idx), 3), np.float32)
    logits[np.arange(len(idx)), hb["target"]] = 1.0 + 0.1 * idx
    logits[:, 0] += 0.01 * idx
    return logits


@pytest.mark.parametrize("n,bs,adamml", [(10, 4, False), (6, 4, False),
                                         (8, 4, False), (11, 4, True)])
def test_validate_masks_the_padded_tail_like_jax(n, bs, adamml):
    """The loader pads the ragged last batch with wrapped samples; both
    engines drop those rows from outputs, selections, loss and metrics, and
    re-score a padded batch's loss from its real rows."""
    rs = np.random.RandomState(n)
    dec = (rs.rand(n + bs, 2, 2) > 0.5).astype(np.float32)

    def run(engine, loader, lib, as_np):
        def preprocess(hb):
            return lib(_logits(hb)), lib(hb["target"])

        def step(state, inputs, target, seed):
            logits = inputs
            lg = as_np(logits).astype(np.float64)
            lse = np.log(np.exp(lg).sum(-1))
            loss = float(np.mean(lse - lg[np.arange(len(lg)),
                                          as_np(target)]))
            if adamml:
                return logits, lib(dec[: len(lg)]), lib(np.float32(loss))
            return logits, lib(np.float32(loss))

        kw = dict(adamml=adamml, num_segments=2,
                  modality=["rgb", "sound"] if adamml else None)
        return engine.validate(loader, preprocess, step, None, **kw)

    jout = run(jengine, JLoader(_IdxDataset(n), bs, is_train=False,
                                workers=1), jnp.asarray, np.asarray)
    tout = run(tengine, TLoader(_IdxDataset(n), bs, is_train=False,
                                workers=1), t, lambda x: x.numpy())
    assert tout["outputs"].shape[0] == n
    np.testing.assert_array_equal(tout["outputs"], jout["outputs"])
    for k in ("top1", "top5", "mAP", "loss"):
        assert tout[k] == pytest.approx(jout[k], rel=1e-6), k
    if adamml:
        np.testing.assert_array_equal(tout["all_selections"],
                                      jout["all_selections"])
        assert tout["flops"] == pytest.approx(jout["flops"], rel=TOL)
        for k in jout["selection"]:
            assert tout["selection"][k] == pytest.approx(
                jout["selection"][k], rel=TOL)


class _GatheredTwoShard:
    """The global stream a 2-process eval produces, with the loader's
    index/mask math (tests/test_eval_padding.py)."""

    def __init__(self, loader_cls, n, bs):
        self._ld = loader_cls(_IdxDataset(n), bs, is_train=False, workers=1,
                              num_shards=2, shard_index=0)

    def global_valid_masks(self):
        return self._ld.global_valid_masks()

    def global_row_indices(self):
        return self._ld.global_row_indices()

    def __iter__(self):
        for rows in self._ld.global_row_indices():
            yield {"idx": rows}


def test_validate_restores_val_list_order_like_jax():
    """Shard-interleaved rows come back in val-list order from both
    engines."""
    n, bs = 9, 4

    def run(engine, loader_cls, lib):
        def preprocess(hb):
            idx = np.asarray(hb["idx"])
            logits = np.full((len(idx), 3), -5.0, np.float32)
            logits[np.arange(len(idx)), idx % 3] = 5.0
            logits[:, 0] = idx  # provenance in channel 0
            return lib(logits), lib(idx % 3)

        def step(state, inputs, target, seed):
            return inputs, lib(np.float32(0.01))

        return engine.validate(_GatheredTwoShard(loader_cls, n, bs),
                               preprocess, step, None, adamml=False)

    jout = run(jengine, JLoader, jnp.asarray)
    tout = run(tengine, TLoader, t)
    np.testing.assert_array_equal(tout["outputs"][:, 0].astype(np.int64),
                                  np.arange(n))
    np.testing.assert_array_equal(tout["outputs"], jout["outputs"])
    assert tout["loss"] == pytest.approx(jout["loss"], rel=TOL)


def test_validate_seeds_each_batch():
    """Every eval batch gets its own seed (fresh Gumbel noise), from the
    validation's seed and the batch index."""
    seeds = []

    def step(state, inputs, target, seed):
        seeds.append(seed)
        return inputs, torch.tensor(0.0)

    batches = [{"x": np.eye(3, dtype=np.float32)} for _ in range(3)]
    for s in (5, 5, 6):
        tengine.validate(batches, lambda b: (t(b["x"]), t(np.arange(3))),
                         step, None, seed=s, adamml=False)
    assert len(set(seeds[:3])) == 3 and seeds[:3] == seeds[3:6]
    assert seeds[6:] != seeds[:3]


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

class _Toy(torch.nn.Module):
    """A main net and a policy net with parameters and BN statistics: what
    a checkpoint holds, at a few hundred floats (the flagship's are
    hundreds of MB)."""

    def __init__(self, seed):
        super().__init__()
        torch.manual_seed(seed)
        self.main_net = torch.nn.Sequential(torch.nn.Linear(6, 8),
                                            torch.nn.BatchNorm1d(8),
                                            torch.nn.Linear(8, 3))
        self.policy_net = torch.nn.Sequential(torch.nn.Linear(6, 4),
                                              torch.nn.BatchNorm1d(4))


def _fresh(seed):
    cfg = flagship_cfg(tiny=True)
    model = _Toy(seed)
    return model, TrainState(
        build_optimizer("main", cfg.optim, model.main_net.parameters()),
        build_optimizer("policy", cfg.optim, model.policy_net.parameters()))


@pytest.fixture(scope="module")
def trained():
    """The toy after two steps of both optimizers (SGD momentum, Adam
    moments and count in their state) and BN statistics moved."""
    model, state = _fresh(0)
    state.temperature = 4.825
    x = torch.randn(5, 6)
    for _ in range(2):
        loss = model.main_net(x).square().mean() + model.policy_net(
            x).sum()
        loss.backward()
        for opt in (state.main_opt, state.policy_opt):
            opt.step()
            opt.zero_grad()
        state.step += 1
    return model, state


def _opt_tensors(opt):
    return [v for st in opt.state_dict()["state"].values()
            for v in st.values() if torch.is_tensor(v)]


def test_checkpoint_round_trip(tmp_path, trained):
    model, state = trained
    meta = {"epoch": 3, "arch": "x", "best_top1": 12.5,
            "stage": "alternative_training", "rng": 123}
    path = tckpt.save_checkpoint(model, state, meta, str(tmp_path),
                                 is_best=True, epoch=3, suffix="_main")
    assert sorted(os.listdir(tmp_path)) == ["checkpoint", "checkpoint_main_03",
                                            "model_best"]
    for d in os.listdir(tmp_path):
        assert sorted(os.listdir(tmp_path / d)) == ["meta.json", "state.pt"]
    assert tckpt.peek_meta(path) == {**meta, "optim_layout": "torch"}

    fresh, fstate = _fresh(1)  # other weights, empty optimizers
    fresh_before = {k: v.clone() for k, v in fresh.state_dict().items()}
    got = tckpt.load_checkpoint(str(tmp_path / "model_best"), fresh, fstate)
    assert got["epoch"] == 3 and got["stage"] == "alternative_training"
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert any(not torch.equal(fresh_before[k], v)
               for k, v in fresh.state_dict().items()
               if k.endswith("running_mean"))
    for a, b in ((state.main_opt, fstate.main_opt),
                 (state.policy_opt, fstate.policy_opt)):
        want, have = _opt_tensors(a), _opt_tensors(b)
        assert len(want) == len(have) > 0
        assert all(torch.equal(x, y) for x, y in zip(want, have))
    assert fstate.temperature == 4.825 and fstate.step == state.step == 2
    # the restored optimizers step on the restored parameters
    assert all(p is q for g in fstate.main_opt.param_groups
               for p, q in zip(g["params"], fresh.main_net.parameters()))


def test_checkpoint_layout_is_the_jax_one(tmp_path, trained):
    """Latest and per-epoch copies under the JAX package's names, and the
    manager finds them."""
    model, state = trained
    tckpt.save_checkpoint(model, state, {"epoch": 1}, str(tmp_path),
                          epoch=1)
    tckpt.save_checkpoint(model, state, {"epoch": 2}, str(tmp_path),
                          epoch=2, suffix="_warmup")
    assert sorted(os.listdir(tmp_path)) == ["checkpoint", "checkpoint_01",
                                            "checkpoint_warmup_02"]
    mgr = tckpt.CheckpointManager(str(tmp_path))
    assert mgr.latest() == os.path.join(str(tmp_path), "checkpoint")
    assert mgr.best() is None
    assert tckpt.peek_meta(mgr.latest())["epoch"] == 2


@pytest.mark.parametrize("layout", ["fused", "per_tensor", None])
def test_jax_checkpoint_is_refused(tmp_path, layout, trained):
    model, state = trained
    path = tckpt.save_checkpoint(model, state, {"epoch": 1}, str(tmp_path))
    meta = {"epoch": 1, "stage": "warmup", "best_top1": 0.0}
    if layout is not None:
        meta["optim_layout"] = layout
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(RuntimeError,
                       match="orbax" if layout else "not a checkpoint"):
        tckpt.load_checkpoint(path, model, state)
