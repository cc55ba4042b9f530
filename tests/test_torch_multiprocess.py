"""PyTorch port, multi-process data-parallel runs (parallel/mesh.py) on the
CPU: two processes under gloo, each a rank, meeting through a ``file://``
rendezvous in the test's tmp_path, against the port's single process on
the same global batch.

  * one main-phase and one policy-phase step of the tiny flagship, float32,
    real Gumbel and dropout noise, per-replica BN (against the single
    process at ``bn_groups = 2``) and --sync-bn (against ``bn_groups =
    1``); both ranks bit-identical (parameters, BN statistics, metrics);
  * the counterpart of tests/test_multiprocess.py: ``UnimodalTrainer`` for
    one epoch on 13 synthetic samples (not a multiple of 2 x the batch, so
    the padded rows are masked), both ranks reporting the gathered
    validation of exactly 13 rows;
  * the counterpart of ``__graft_entry__.py::dryrun_multichip``: five main
    steps on one batch drop cls_loss by at least 25%, two policy steps move
    the policy and its selection rates;
  * checkpoints: rank 0 writes the one checkpoint, resuming it on two ranks
    gives both the saved state; and train_unimodal's
    --multiprocessing-distributed spawning two CPU ranks;
  * the spawn path itself: each spawned rank joins with the parent's
    timeout through a file rendezvous, and a logged line reaches a pipe
    the ranks share in one write.

Every child runs torch on one thread and joins its group with a 60 s
timeout; every test waits for its children with a timeout and kills them
in a ``finally``, so a hang fails the test instead of the whole run. The
file imports no JAX: tests/test_torch_gpu.py runs the steps' comparison on
a card with ``_launch(..., device="cuda:0")``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from adamml_tpu_torch.parallel.mesh import file_url
from adamml_tpu_torch.utils.logging import RankZeroLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240

# the children's shared code: argv = task, url, rank, world, out dir, args
# (tests/test_torch_tensor_parallel.py adds its tasks to this header)
HEADER = r'''
import copy, hashlib, json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.configs.config import ExperimentConfig
from adamml_tpu_torch.parallel import mesh
mesh.DEFAULT_TIMEOUT_S = 60.0

task, url, rank, world, out = sys.argv[1:6]
rank, world = int(rank), int(world)
args = json.loads(sys.argv[6])


dev = torch.device(args.get("device", "cpu"))
if dev.type == "cuda":
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def join(cfg):
    cfg.runtime.dist_url, cfg.runtime.world_size = url, world
    cfg.runtime.rank = rank
    cfg.runtime.mesh_model = args.get("mesh_model", 1)
    return mesh.init_distributed(cfg, dev, backend="gloo")


def report(**fields):
    print("RESULT " + json.dumps({"rank": rank, **fields}), flush=True)


def digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def unimodal_cfg(logdir):
    cfg = ExperimentConfig()
    cfg.model.backbone_net = "resnet"
    cfg.model.depth = 18
    cfg.model.groups = 2
    cfg.model.modality = ["rgb"]
    cfg.model.num_classes = 4
    cfg.model.compute_dtype = "float32"
    cfg.optim.batch_size = 8
    cfg.optim.epochs = 1
    cfg.optim.lr_scheduler = "multisteps"
    cfg.data.dataset = "synthetic"
    cfg.data.synthetic_length = 13
    cfg.data.input_size = 16
    cfg.data.canvas_size = (32, 48)
    cfg.data.scale_range = [20, 24]
    cfg.data.workers = 1
    cfg.runtime.logdir = logdir
    return cfg


def full_tensors(model):
    """The model's state with sharded weights gathered (every rank calls
    it; the state itself without a group)."""
    return {k: v.clone() for k, v in mesh.full_state_dict(model).items()}
'''

_WORKER = HEADER + r'''
if task == "steps":
    from adamml_tpu_torch.models import model_builder as mb
    from adamml_tpu_torch.ops.kernels import tpool_fused
    from adamml_tpu_torch.train.optim import build_optimizer
    from adamml_tpu_torch.train.steps import make_adamml_train_step
    from adamml_tpu_torch.train.train_state import StageFlags, TrainState

    cfg = flagship_cfg(tiny=True)
    cfg.runtime.sync_bn = args["sync_bn"]
    join(cfg)
    rs = np.random.RandomState(0)
    s = cfg.model.num_segments
    batch = args["batch"]
    x = [torch.from_numpy(rs.randn(*mb.modality_input_shape(
        cfg, m, batch, s)).astype(np.float32)).to(dev)
        for m in cfg.model.modality]
    target = torch.from_numpy(rs.randint(0, cfg.model.num_classes,
                                         batch)).to(dev)
    phases = [("main", [0.0, 0.0]), ("policy", [1.0, 0.05])]

    def run(model, xs, ts, starts=None):
        """Each phase's (start, metrics, end), from ``starts`` if given."""
        state = TrainState(
            build_optimizer("main", cfg.optim, model.main_net.parameters()),
            build_optimizer("policy", cfg.optim,
                            model.policy_net.parameters()))
        recs = []
        for i, (phase, cw) in enumerate(phases):
            if starts is not None:
                sd, main_sd, policy_sd, state.step = starts[i]
                model.load_state_dict(sd)
                state.main_opt.load_state_dict(main_sd)
                state.policy_opt.load_state_dict(policy_sd)
            start = (full_tensors(model),
                     copy.deepcopy(mesh.full_optimizer_state(state.main_opt)),
                     copy.deepcopy(mesh.full_optimizer_state(
                         state.policy_opt)),
                     state.step)
            flags = (StageFlags.main_phase() if phase == "main"
                     else StageFlags.policy_phase())
            step = make_adamml_train_step(
                model, flags=flags, penalty_type="blockdrop", gammas=10.0,
                clip_gradient=None)
            m = step(state, xs, ts, args["lr"], args["p_lr"], cw, seed=3)
            recs.append((start, {k: v.clone() for k, v in m.items()},
                         full_tensors(model)))
        return recs

    # the rows of this rank's data index (model peers share them)
    shards, d = mesh.data_world()
    n = batch // shards
    model, _ = mb.build_model(cfg, dev)
    mine = run(model, [a[d * n:(d + 1) * n] for a in x],
               target[d * n:(d + 1) * n])
    # the fused epilogue's kernel launches of this rank's two steps (none
    # on the CPU)
    launches = dict(tpool_fused.launch_counts)
    synced = all(getattr(m_, "sync", False) for m_ in model.modules()
                 if hasattr(m_, "running_mean"))
    mesh.shutdown()
    digests = [digest(list(end.values()) + list(m.values()))
               for _, m, end in mine]
    report(digests=digests, synced=synced, launches=launches)
    if rank == 0:
        # the single process on the global batch, each phase from the
        # 2-rank run's start of that phase, compared here (the tiny
        # flagship's state is 120 MB)
        cfg.runtime.mesh_model = 1
        ref, _ = mb.build_model(cfg, dev,
                                bn_groups=1 if args["sync_bn"] else shards)
        theirs = run(ref, x, target, starts=[r[0] for r in mine])
        rtol, p_lr = args["rtol"], args["p_lr"]
        cmp = []
        for (start, got_m, got), (_, want_m, want), (phase, _) in zip(
                mine, theirs, phases):
            live = phase + "_net."
            c = {"exact": {k: bool(torch.equal(got_m[k], want_m[k]))
                           for k in ("selection", "top1", "top5")},
                 "loss_rel": {k: float((got_m[k] - want_m[k]).abs()
                                       / want_m[k].abs().clamp_min(1e-12))
                              for k in ("loss", "cls_loss", "policy_loss")},
                 "stats": 0.0, "params": 0.0, "policy_max": 0.0,
                 "frozen_equal": True, "moved": 0, "close": 0, "total": 0}
            for k, v in want.items():
                d = (got[k] - v).abs()
                beyond = float((d - rtol * v.abs()).max())
                if k.endswith(("running_mean", "running_var")):
                    c["stats"] = max(c["stats"], beyond)
                    continue
                if not v.is_floating_point() or not k.startswith(live):
                    c["frozen_equal"] &= bool(torch.equal(got[k], v))
                    continue
                c["moved"] += not torch.equal(start[0][k], got[k])
                if phase == "main":
                    c["params"] = max(c["params"], beyond)
                else:
                    c["policy_max"] = max(c["policy_max"], float(d.max()))
                    c["close"] += int((d <= 0.1 * p_lr).sum())
                    c["total"] += d.numel()
            cmp.append(c)
        report(digests=digests, synced=synced, launches=launches,
               compare=cmp)

elif task == "unimodal":
    from adamml_tpu_torch.train.curriculum import UnimodalTrainer

    cfg = unimodal_cfg(args["logdir"])
    join(cfg)
    trainer = UnimodalTrainer(cfg, "cpu")
    assert trainer.train_loader.num_shards == world
    assert trainer.train_loader.shard_index == rank
    assert trainer.train_loader.batch_size == 8 // world
    from adamml_tpu_torch.ckpt import checkpoint
    writes = []
    real_write = checkpoint._write
    checkpoint._write = lambda *a: writes.append(rank) or real_write(*a)
    result = trainer.run()
    mesh.shutdown()
    report(top1=result["top1"], mAP=result["mAP"], loss=result["loss"],
           val_rows=int(result["outputs"].shape[0]), writes=writes,
           state=digest(trainer.model.state_dict().values()))

elif task == "resume":
    from adamml_tpu_torch.ckpt.checkpoint import read_checkpoint
    from adamml_tpu_torch.train.curriculum import UnimodalTrainer
    from adamml_tpu_torch.utils.logging import RankZeroLogger

    cfg = unimodal_cfg(args["logdir"])
    cfg.runtime.resume = args["resume"]
    join(cfg)
    trainer = UnimodalTrainer(cfg, "cpu")
    trainer.maybe_resume(RankZeroLogger("", rank=rank))
    mesh.shutdown()
    _, payload = read_checkpoint(args["resume"])
    got = trainer.model.state_dict()
    report(equal=all(torch.equal(got[k], v)
                     for k, v in payload["model"].items()),
           step=trainer.state.step, start_epoch=trainer.start_epoch,
           momentum=all(
               torch.equal(trainer.state.main_opt.state_dict()["state"][i][
                   "momentum_buffer"], st["momentum_buffer"])
               for i, st in payload["main_opt"]["state"].items()))

elif task == "dryrun":
    from adamml_tpu_torch.train.curriculum import AdaMMLTrainer

    cfg = flagship_cfg(tiny=True)
    cfg.data.synthetic_length = cfg.optim.batch_size
    cfg.runtime.logdir = args["logdir"]
    join(cfg)
    trainer = AdaMMLTrainer(cfg, "cpu")
    inputs, target = trainer.train_pre(next(iter(trainer.train_loader)))
    state, lr, cw = trainer.state, 0.01, cfg.model.cost_weights
    cls = [float(trainer.step_main(state, inputs, target, lr, lr, cw,
                                   seed=i)["cls_loss"]) for i in range(5)]
    before = [p.detach().clone() for p in
              trainer.model.policy_net.parameters()]
    m2 = trainer.step_policy(state, inputs, target, lr, lr, cw, seed=0)
    moved = sum(not torch.equal(a, p) for a, p in zip(
        before, trainer.model.policy_net.parameters()))
    m3 = trainer.step_policy(state, inputs, target, lr, lr, cw, seed=0)
    state = digest(full_tensors(trainer.model).values())
    mesh.shutdown()
    report(cls=cls, moved=moved, sel=[m2["selection"].tolist(),
                                      m3["selection"].tolist()],
           state=state)

else:
    raise SystemExit(f"unknown task {task}")
'''


def _launch(tmp_path, task, world=2, worker=_WORKER, timeout_s=TIMEOUT_S,
            **args):
    """Run ``task`` of ``worker`` on ``world`` ranks; returns each rank's
    RESULT dict. Any rank that fails or outlives ``timeout_s`` fails the
    test; every child is killed on the way out."""
    url = file_url(tmp_path)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    # stdout apart from stderr: the C++ side's warnings on stderr can land
    # in the middle of a line printed to a shared pipe
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, task, url, str(r), str(world),
         str(tmp_path), json.dumps(args)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        got = [p.communicate(timeout=timeout_s) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    outs = [out for out, _ in got]
    results = []
    for r, (p, (out, err)) in enumerate(zip(procs, got)):
        assert p.returncode == 0, f"rank {r} failed:\n{(out + err)[-4000:]}"
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, out[-2000:]
        results.append(json.loads(lines[-1][len("RESULT "):]))
    return results, outs


LR, P_LR_K = 1e-3, 1e-5  # the policy phase at tests/test_torch_multi_step.py's P_LR_K


RTOL = 1e-4


@pytest.fixture(scope="module", params=[False, True],
                ids=["per_replica_bn", "sync_bn"])
def two_rank_steps(request, tmp_path_factory):
    results, _ = _launch(tmp_path_factory.mktemp("steps"), "steps",
                         sync_bn=request.param, batch=8, lr=LR,
                         p_lr=P_LR_K, rtol=RTOL)
    return request.param, results


def test_two_ranks_are_bit_identical(two_rank_steps):
    """After each step both ranks hold the same parameters, BN statistics
    and metrics, bit for bit; --sync-bn marks every BN synchronized."""
    sync_bn, results = two_rank_steps
    assert results[0]["digests"] == results[1]["digests"]
    assert results[0]["synced"] is results[1]["synced"] is sync_bn


@pytest.mark.parametrize("i", [0, 1], ids=["main", "policy"])
def test_two_ranks_match_the_single_process(two_rank_steps, i):
    """Each phase's step from one start: the 2-rank step against the
    single process on the global batch (bn_groups 2, or 1 under --sync-bn),
    real Gumbel and dropout noise. Decisions and top-1/top-5 exact; losses
    within 1e-5 relative; the frozen subnet bit-equal; and
    tests/test_torch_train.py's tolerances: BN statistics within rtol
    1e-4, atol 2e-4, main-phase parameters within 0.1 lr (atol 1e-4, with
    rtol 1e-4); every policy update within 2.5 p_lr of the
    single process's and 99% of them within 0.1 p_lr (Adam's first step
    moves an element by about p_lr whatever its gradient's size, so a
    float32-noise gradient can flip its sign). The two sides sum the same
    float32 numbers in another order (moments of two halves, convolutions
    over four rows), and the tiny model's gradient amplifies such
    differences (ROADMAP C)."""
    check_compare(two_rank_steps[1][0]["compare"][i], i)


def check_compare(c, i):
    """test_two_ranks_match_the_single_process's tolerances on rank 0's
    comparison of phase ``i``."""
    assert all(c["exact"].values()), c["exact"]
    assert max(c["loss_rel"].values()) <= 1e-5, c["loss_rel"]
    assert c["stats"] <= 2e-4
    assert c["frozen_equal"]
    assert c["moved"] > 50
    if i == 0:
        assert c["params"] <= 0.1 * LR
    else:
        assert c["policy_max"] <= 2.5 * P_LR_K
        assert c["close"] / c["total"] >= 0.99


@pytest.fixture(scope="module")
def unimodal_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("unimodal")
    results, outs = _launch(tmp, "unimodal", logdir=str(tmp / "logs"))
    return tmp, results, outs


def test_unimodal_trainer_gathers_eval(unimodal_run):
    """tests/test_multiprocess.py's counterpart: one epoch of
    UnimodalTrainer on two ranks over 13 synthetic samples (7 a shard after
    the wrap padding; each rank's second val batch has 3 padded rows). Both
    ranks report the same validation over exactly the 13 real rows, end
    with the same model, and only rank 0 writes the checkpoint."""
    _, results, outs = unimodal_run
    a, b = results
    assert a["top1"] == pytest.approx(b["top1"])
    assert a["mAP"] == pytest.approx(b["mAP"])
    assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    assert a["val_rows"] == b["val_rows"] == 13
    assert a["state"] == b["state"]
    assert a["writes"] == [0] and b["writes"] == []
    # rank 0 logs the Val line, rank 1 prints the same one
    val = [ln for ln in outs[0].splitlines() if ln.startswith("Val: ")]
    assert val and [f"[rank 1] {ln}" for ln in val] == [
        ln for ln in outs[1].splitlines() if ln.startswith("[rank 1] Val")]


def test_checkpoint_written_once_and_resumed_on_both_ranks(unimodal_run,
                                                           tmp_path):
    """The 2-rank epoch leaves one checkpoint, written by rank 0; resuming
    it on two ranks gives both the saved parameters, statistics, momentum
    and step."""
    tmp, results, _ = unimodal_run
    logdir = tmp / "logs"
    assert [r["writes"] for r in results] == [[0], []]
    (arch,) = os.listdir(logdir)
    ckpt = logdir / arch / "checkpoint"
    assert sorted(os.listdir(ckpt)) == ["meta.json", "state.pt"]
    results, _ = _launch(tmp_path, "resume", logdir=str(tmp_path / "r"),
                         resume=str(ckpt))
    for r in results:
        assert r["equal"] and r["momentum"], r
        assert r["start_epoch"] == 1 and r["step"] == results[0]["step"] > 0


def test_dryrun_multichip_counterpart(tmp_path):
    """__graft_entry__.py::dryrun_multichip on two ranks: five main steps on
    one batch of the tiny flagship (8 clips, 4 a rank) drop cls_loss by at
    least 25%; a policy step moves policy parameters; the selection rates
    of two policy steps differ; both ranks end bit-identical."""
    results, _ = _launch(tmp_path, "dryrun", logdir=str(tmp_path / "logs"))
    a, b = results
    assert a["cls"] == b["cls"] and a["state"] == b["state"]
    assert a["cls"][-1] <= 0.75 * a["cls"][0], a["cls"]
    assert a["moved"] > 0
    sel = np.asarray(a["sel"])
    assert np.all((sel >= 0) & (sel <= 1))
    assert not np.array_equal(sel[0], sel[1])


def test_cli_spawns_ranks_on_the_cpu(tmp_path):
    """train_unimodal with --multiprocessing-distributed and two --gpu ids
    on the CPU spawns two gloo ranks (torch.multiprocessing.spawn), which
    train and validate over 13 samples; both print the same Val line."""
    argv = ["--dataset", "synthetic", "--modality", "rgb", "--backbone_net",
            "resnet", "-d", "18", "--groups", "2", "-b", "8", "--epochs", "1",
            "--input_size", "16", "--synthetic_length", "13", "-j", "1",
            "--lr_scheduler", "multisteps", "--compute_dtype", "float32",
            "--multiprocessing-distributed", "--gpu", "0,1",
            "--logdir", str(tmp_path / "logs")]
    code = ("import sys, torch; torch.set_num_threads(1); "
            "from adamml_tpu_torch.parallel import mesh; "
            "mesh.DEFAULT_TIMEOUT_S = 60.0; "
            "from adamml_tpu_torch.cli import train_unimodal; "
            "sys.exit(train_unimodal.main(sys.argv[1:], device='cpu'))")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    p = subprocess.Popen([sys.executable, "-c", code, *argv], cwd=REPO,
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    try:
        out, err = p.communicate(timeout=TIMEOUT_S)
    finally:
        p.kill()
        p.wait()
    assert p.returncode == 0, (out + err)[-4000:]
    val = [ln for ln in out.splitlines() if ln.startswith("Val: ")]
    assert len(val) == 1
    assert f"[rank 1] {val[0]}" in out.splitlines()


# a module the spawned ranks import (spawn pickles ``run`` by name): each
# rank joins the group and reports what it runs with
_PROBE = r'''
import json, sys
import torch.distributed as dist
from adamml_tpu_torch.parallel import mesh


def run(cfg, device, backend=None):
    got = mesh.init_distributed(cfg, device, backend)
    store = dist.distributed_c10d._get_default_store()
    line = json.dumps({"rank": got.rank, "world": got.world,
                       "default_timeout_s": mesh.DEFAULT_TIMEOUT_S,
                       "store_timeout_s": store.timeout.total_seconds(),
                       "url": cfg.runtime.dist_url})
    sys.stdout.write(f"RESULT {line}\n")
    sys.stdout.flush()
    mesh.shutdown()
    return 0
'''


def test_spawned_ranks_get_the_parents_timeout(tmp_path):
    """``mesh.launch`` with spawn on one node: the parent sets a 60 s
    timeout, and every spawned rank runs with it (the module default and
    the process group's store, 60 s, where the default is 600 s); the
    ranks meet through a ``file://`` rendezvous, not a port picked and
    released by the parent."""
    (tmp_path / "rank_probe.py").write_text(_PROBE)
    code = ("import sys, torch; torch.set_num_threads(1); "
            "from adamml_tpu_torch.configs.config import ExperimentConfig; "
            "from adamml_tpu_torch.parallel import mesh; "
            "import rank_probe; "
            "mesh.DEFAULT_TIMEOUT_S = 60.0; "
            "sys.exit(mesh.launch(rank_probe.run, ExperimentConfig(), "
            "['cpu', 'cpu'], 'gloo', spawn=True))")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([REPO, str(tmp_path)])}
    p = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    try:
        out, err = p.communicate(timeout=TIMEOUT_S)
    finally:
        p.kill()
        p.wait()
    assert p.returncode == 0, (out + err)[-4000:]
    got = sorted((json.loads(ln[len("RESULT "):]) for ln in
                  out.splitlines() if ln.startswith("RESULT ")),
                 key=lambda r: r["rank"])
    assert [(r["rank"], r["world"]) for r in got] == [(0, 2), (1, 2)], out
    for r in got:
        assert r["default_timeout_s"] == r["store_timeout_s"] == 60.0, r
        assert r["url"].startswith("file://"), r


class _Writes:
    """A stdout that records each write call."""

    def __init__(self):
        self.calls = []

    def write(self, text):
        self.calls.append(text)
        return len(text)

    def flush(self):
        pass


@pytest.mark.parametrize("rank", [0, 1])
def test_logged_line_is_one_write(rank, monkeypatch):
    """A logged line and its newline go to stdout in one write call.
    ``print`` makes two under ``python -u`` or PYTHONUNBUFFERED, and the
    spawned ranks of test_cli_spawns_ranks_on_the_cpu, sharing the
    parent's pipe, then spliced a rank's Val line onto another's."""
    out = _Writes()
    monkeypatch.setattr(sys, "stdout", out)
    RankZeroLogger("", rank=rank).log("Val: x", every_rank=True)
    want = "Val: x\n" if rank == 0 else "[rank 1] Val: x\n"
    assert out.calls == [want]
