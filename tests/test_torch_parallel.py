"""PyTorch port, the data-parallel slice in one process, against the JAX
package: GroupedBatchNorm with R replica groups (the single-process
reference of an R-rank run), the tiny flagship main-phase step with
per-replica BN against the JAX step on a 2-way data mesh, the loader's
shards, the builder's resolvers at world size 2, and the helpers of
parallel/mesh.py in a process group of one (the identity, bit for bit).
Then eval-capacity packing across ranks: two gloo ranks whose packing
blocks span them, against the single process and the JAX package's row
set (tests/test_capacity_sharded.py).

The multi-process runs themselves: tests/test_torch_multiprocess.py.
"""

import numpy as np
import pytest
import torch

from adamml_tpu.configs import config as jconfig
from adamml_tpu.models import model_builder as jbuilder
from adamml_tpu_torch.configs import flagship_cfg
from adamml_tpu_torch.models import model_builder as tbuilder
from adamml_tpu_torch.parallel import mesh
from adamml_tpu_torch.train.optim import build_optimizer
from adamml_tpu_torch.train.steps import make_adamml_train_step
from adamml_tpu_torch.train.train_state import StageFlags, TrainState

from test_capacity_sharded import _executed_decisions
from test_torch_data import _loaders
from test_torch_multiprocess import HEADER, _launch
from test_torch_train import (check_bn_statistics, check_freezes,
                              check_gradients, check_grouped_batchnorm,
                              check_metrics, check_parameters,
                              run_alternating)
from torch_parity import one_torch_thread  # noqa: F401

# (R, S, seq_inner, rows): 2 and 4 replica groups, without and with
# segments (S = 2 and 3) and frames
BN_CASES = [(2, 1, 1, 8), (4, 1, 1, 8), (2, 2, 1, 8), (4, 2, 2, 32),
            (4, 3, 1, 24), (2, 3, 2, 24)]


@pytest.mark.parametrize("return_affine", [False, True],
                         ids=["apply", "affine"])
@pytest.mark.parametrize("r,s,si,n", BN_CASES,
                         ids=[f"R{c[0]}S{c[1]}i{c[2]}n{c[3]}"
                              for c in BN_CASES])
def test_replica_grouped_batchnorm(r, s, si, n, return_affine):
    """GroupedBatchNorm(groups=R) against the JAX GroupedBatchNorm with
    groups R: output (or the (R, S, C) affine), the input and affine
    gradients, and the running statistics (group 0's moments), within
    tests/test_torch_train.py's 1e-5 and 1e-6."""
    check_grouped_batchnorm(r, s, si, n, return_affine)


@pytest.fixture(scope="module")
def replica_step():
    # 16 clips: 8 a replica group, as many as the 8-clip global-moment
    # comparison of tests/test_torch_train.py has in its one group (at
    # fewer, float32 moments of the deep 1x1 layers part by 5e-4)
    return run_alternating(("main",), bn_groups=2, clips=16)[0]


def test_replica_bn_step_matches_jax_data_mesh(replica_step):
    """The tiny flagship main-phase step with per-replica BN: the port's
    one process at bn_groups 2 against the JAX step built with mesh_data 2
    and no --sync-bn (its _bn_groups is 2), zero-noise straight-through
    decisions, float32, 16 clips: metrics, the gradient, the updated
    parameters (each within 0.1 lr) and every BN statistic (rtol 1e-4,
    atol 2e-4), with tests/test_torch_train.py's checks; the fused epilogue
    runs its backward at both pooled stage boundaries with the (2, S, C)
    affine."""
    check_metrics(replica_step, True)
    check_gradients(replica_step)
    check_parameters(replica_step)
    check_bn_statistics(replica_step)
    check_freezes(replica_step)


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("shard", [0, 1])
def test_loader_shards_match_jax(shard, is_train):
    """HostDataLoader with num_shards 2 over 13 samples, 4 rows a batch
    (-b 8 over two ranks): the JAX loader's batches, byte for byte, and
    its global valid masks and row indices (the val tail's padded rows)."""
    jl, tl = _loaders(["rgb", "sound"], is_train=is_train, length=13,
                      num_clips=2, shards=2, shard=shard)
    # 7 rows a shard after the wrap padding: one full train batch; two val
    # batches, the second padded to 4
    assert len(tl) == len(jl) == (1 if is_train else 2)
    for b_j, b_t in zip(list(jl), list(tl)):
        assert sorted(b_t) == sorted(b_j)
        for k in b_j:
            assert b_t[k].dtype == b_j[k].dtype, k
            assert b_t[k].tobytes() == b_j[k].tobytes(), k
    for name in ("global_valid_masks", "global_row_indices"):
        want, got = getattr(jl, name)(), getattr(tl, name)()
        assert (got is None) == (want is None) == (is_train
                                                   and name.endswith("masks"))
        for g, w in zip(got or [], want or []):
            np.testing.assert_array_equal(g, w, err_msg=name)
    if not is_train:
        assert sum(int(m.sum()) for m in tl.global_valid_masks()) == 13


def _world2(sync_bn=False, capacity_groups=None):
    cfg = flagship_cfg(tiny=True)
    cfg.runtime.world_size = 2
    cfg.runtime.sync_bn = sync_bn
    cfg.model.capacity_groups = capacity_groups
    return cfg


@pytest.mark.parametrize("groups,want", [(None, 2), (2, 2), (4, 4)])
def test_capacity_groups_at_world_size_2(groups, want):
    """One packing group per rank by default (the JAX package's one per
    data shard, mesh_data 2); an explicit count as given. The model takes
    the global count and the two data shards (a multiple of them packs
    G / 2 blocks on each rank)."""
    cfg = _world2(capacity_groups=groups)
    jcfg = jconfig.ExperimentConfig()
    jcfg.runtime.mesh_data, jcfg.model.capacity_groups = 2, groups
    assert tbuilder._capacity_groups(cfg) == want
    assert jbuilder._capacity_groups(jcfg) == want
    cfg.model.eval_capacity = 0.5
    model, _ = tbuilder.build_model(cfg, device="cpu")
    assert (model.main_net.capacity_groups,
            model.main_net.data_shards) == (want, 2)


@pytest.mark.parametrize("groups", [3, 1, 5])
def test_capacity_groups_across_ranks_at_world_size_2(groups):
    """A count that is no multiple of the world size is the JAX package's
    count too (its blocks span data shards), where the port refused it
    before packing across ranks was ported."""
    jcfg = jconfig.ExperimentConfig()
    jcfg.runtime.mesh_data, jcfg.model.capacity_groups = 2, groups
    assert tbuilder._capacity_groups(_world2(capacity_groups=groups)) == \
        jbuilder._capacity_groups(jcfg) == groups


# the A.21 ranks: 10 global rows, 5 a rank, eval capacity 0.5
PACK_DEC = [1., 1., 1., 0., 1., 1., 0., 1., 1., 1.]
PACK_GROUPS = [1, 2, 4, 5, 10]

_PACKED = HEADER + r'''
from adamml_tpu_torch.models.joint_net import JointMainNet
from adamml_tpu_torch.models.model_builder import init_model
from adamml_tpu_torch.train.engine import capacity_dropped

join(flagship_cfg(tiny=True))
dec = torch.tensor(args["dec"])
rows = dec.numel()
x = torch.from_numpy(np.random.RandomState(5).randn(
    rows, 2, 32, 32, 3).astype(np.float32))


def packed(groups, shards, index):
    """(logits, global rows the backbone ran) of this rank's rows."""
    net = init_model(JointMainNet(("rgb",), depth=18, num_classes=5,
                                  dropout=0.0, eval_capacity=0.5,
                                  capacity_groups=groups,
                                  data_shards=shards), 0)
    n = rows // shards
    mine = x[index * n:(index + 1) * n]
    ran, real = [], net.net_rgb.forward
    net.net_rgb.forward = lambda xx, *a, **k: ran.append(xx) or real(
        xx, *a, **k)
    with torch.no_grad():
        logits = net([mine], dec[None, index * n:(index + 1) * n])
    got = [index * n + next(i for i in range(n) if torch.equal(r, mine[i]))
           for b in ran for r in b]
    return logits, got


shards, index = mesh.data_world()
res = {}
for g in args["groups"]:
    logits, ran = packed(g, shards, index)
    every = mesh.gather_rows(dec[index * 5:(index + 1) * 5])
    res[g] = {"logits": mesh.gather_rows(logits).tolist(), "ran": ran,
              "dropped": capacity_dropped(
                  [every.numpy().reshape(rows, 1, 1)], 1, 0.5, g).tolist()}
mesh.shutdown()
if rank == 0:
    for g in args["groups"]:
        logits, ran = packed(g, 1, 0)
        res[g]["single"] = {"logits": logits.tolist(), "ran": ran,
                            "dropped": capacity_dropped(
                                [dec.numpy().reshape(rows, 1, 1)], 1, 0.5,
                                g).tolist()}
report(**{str(g): v for g, v in res.items()})
'''


@pytest.fixture(scope="module")
def packed_ranks(tmp_path_factory):
    results, _ = _launch(tmp_path_factory.mktemp("packed"), "packed",
                         worker=_PACKED, dec=PACK_DEC, groups=PACK_GROUPS)
    return results


@pytest.mark.parametrize("groups", PACK_GROUPS)
def test_packing_across_ranks_matches_the_single_process(packed_ranks,
                                                         groups):
    """Two gloo ranks at (2, 1), 5 of the 10 global rows each, eval
    capacity 0.5 in G blocks: 1, 5 (blocks that span the ranks: the
    gathered decisions give every rank the global plan), 2, 10 (blocks
    within ranks: each packs its own rows) and 4, a multiple of the ranks
    that does not divide the 10 rows, so the JAX package packs one global
    block (the port packed one block a rank before). Both ranks gather the same
    logits, bit for bit; they equal the single process's at the same G
    within 1e-5 (a row's eval logits depend on that row alone, but a
    float32 convolution over another number of rows can sum in another
    order: 2.6e-6 relative at G = 1); the rows whose backbone ran are the
    global plan's, each on its own rank; the rows with logits are the executed
    set of tests/test_capacity_sharded.py; capacity_dropped is the single
    process's and the selections beyond cap."""
    a, b = (r[str(groups)] for r in packed_ranks)
    single = a["single"]
    got = np.asarray(a["logits"], np.float32)
    assert a["logits"] == b["logits"]
    np.testing.assert_allclose(got, single["logits"], rtol=1e-5, atol=1e-5)
    dec = np.asarray([PACK_DEC], np.float32)
    g = groups if 10 % groups == 0 else 1
    exe = _executed_decisions(dec, 0.5, g)
    np.testing.assert_array_equal(np.flatnonzero(np.abs(got).sum(1)),
                                  np.flatnonzero(exe[0]))
    ran = sorted(a["ran"] + b["ran"])
    assert ran == sorted(single["ran"])
    assert all(r < 5 for r in a["ran"]) and all(r >= 5 for r in b["ran"])
    bl = 10 // g
    assert len(ran) == g * max(1, int(round(0.5 * bl)))
    assert a["dropped"] == b["dropped"] == single["dropped"] == [
        int(dec.sum() - exe.sum())]


@pytest.mark.parametrize("sync_bn", [False, True])
def test_bn_groups_at_world_size_2(sync_bn):
    """Each rank's BN takes one moment group, its own rows: the JAX
    package's per-shard group (its _bn_groups is the shard count, 2) or,
    under --sync-bn, global moments through the all-reduce; only a process
    group marks them synchronized."""
    assert tbuilder._bn_groups(_world2(sync_bn)) == 1
    jcfg = jconfig.ExperimentConfig()
    jcfg.runtime.mesh_data, jcfg.runtime.sync_bn = 2, sync_bn
    assert jbuilder._bn_groups(jcfg) == (1 if sync_bn else 2)
    model, _ = tbuilder.build_model(_world2(sync_bn), device="cpu")
    bns = [m for m in model.modules() if hasattr(m, "running_mean")]
    assert bns and all(m.groups == 1 and not m.sync for m in bns)


@pytest.fixture
def group_of_one(tmp_path):
    """A gloo process group of one in this process, left at the end."""
    cfg = flagship_cfg(tiny=True)
    cfg.runtime.dist_url = mesh.file_url(tmp_path)
    got = mesh.init_distributed(cfg, "cpu", timeout_s=30)
    try:
        yield got
    finally:
        mesh.shutdown()
    assert not mesh.active()


def _tiny_step(phase):
    """One step of the tiny flagship (real noise) from the seeded init;
    returns (metrics, state dict)."""
    cfg = flagship_cfg(tiny=True)
    model, _ = tbuilder.build_model(cfg, device="cpu")
    rs = np.random.RandomState(2)
    x = [torch.from_numpy(rs.randn(*tbuilder.modality_input_shape(
        cfg, m, 4, cfg.model.num_segments)).astype(np.float32))
        for m in cfg.model.modality]
    target = torch.arange(4) % cfg.model.num_classes
    state = TrainState(
        build_optimizer("main", cfg.optim, model.main_net.parameters()),
        build_optimizer("policy", cfg.optim, model.policy_net.parameters()))
    flags = (StageFlags.main_phase() if phase == "main"
             else StageFlags.policy_phase())
    step = make_adamml_train_step(model, flags=flags,
                                  penalty_type="blockdrop", gammas=10.0,
                                  clip_gradient=None)
    m = step(state, x, target, 1e-3, 1e-2, [1.0, 0.05], seed=1)
    synced = [getattr(b, "sync", False) for b in model.modules()
              if hasattr(b, "running_mean")]
    return m, model.state_dict(), synced


@pytest.mark.parametrize("phase", ["main", "policy"])
def test_group_of_one_is_the_single_process(phase, group_of_one):
    """World size 1 in a process group: the gradient all-reduce, the
    synchronized BN moments (the flagship's --sync-bn), the metric average
    and the noise draws run, and the step is the one without a group, bit
    for bit (the CPU counterpart of tests/test_torch_gpu.py::
    test_nccl_group_of_one_is_the_single_process)."""
    assert (group_of_one.world, group_of_one.rank,
            group_of_one.backend) == (1, 0, "gloo")
    got_m, got, synced = _tiny_step(phase)
    assert synced and all(synced)
    mesh.shutdown()
    want_m, want, synced = _tiny_step(phase)
    assert not any(synced)
    for k in want_m:
        assert torch.equal(got_m[k], want_m[k]), k
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_helpers_without_a_group_launch_nothing():
    """No process group: every helper is the identity (the same tensor
    object where it returns one) and the noise is the plain draw."""
    assert not mesh.active() and mesh.world() == (1, 0)
    x = torch.randn(3, 2)
    assert mesh.all_reduce_mean(x) is x
    assert mesh.gather_rows(x) is x
    m = {"loss": x[0, 0]}
    assert mesh.average_metrics(m) is m
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.full((2,), 3.0)
    mesh.GradAllReduce([p])()
    assert torch.equal(p.grad, torch.full((2,), 3.0))
    mesh.broadcast_tensors([x])
    mesh.barrier()
    g = torch.Generator().manual_seed(4)
    got = mesh.local_noise(lambda s: torch.rand(s, generator=g), (2, 5), 1)
    assert torch.equal(got, torch.rand((2, 5),
                                       generator=torch.Generator().manual_seed(4)))


@pytest.mark.parametrize("setting,match", [
    (dict(world_size=2, rank=2, dist_url="tcp://127.0.0.1:1"), "--rank 2"),
    (dict(world_size=2, mesh_data=4, dist_url="tcp://127.0.0.1:1"),
     "--mesh_data 4"),
], ids=["rank", "mesh_data"])
def test_init_distributed_refuses_bad_layouts(setting, match):
    cfg = flagship_cfg(tiny=True)
    for k, v in setting.items():
        setattr(cfg.runtime, k, v)
    with pytest.raises(ValueError, match=match):
        mesh.init_distributed(cfg, "cpu", timeout_s=1)


@pytest.mark.parametrize("backend,match", [("nccl", "CUDA"),
                                           ("mpi", "nccl or gloo")])
def test_init_distributed_refuses_bad_backends(backend, match):
    """NCCL on the CPU and a backend the port does not run are refused
    before any rendezvous; nothing falls back to another backend."""
    cfg = flagship_cfg(tiny=True)
    cfg.runtime.dist_url = "tcp://127.0.0.1:1"
    with pytest.raises(ValueError, match=match):
        mesh.init_distributed(cfg, "cpu", backend=backend, timeout_s=1)
    assert not mesh.active()
