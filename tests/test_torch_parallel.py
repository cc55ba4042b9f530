"""PyTorch port, the data-parallel slice in one process, against the JAX
package: GroupedBatchNorm with R replica groups (the single-process
reference of an R-rank run), the tiny flagship main-phase step with
per-replica BN against the JAX step on a 2-way data mesh, the loader's
shards, the builder's resolvers at world size 2, and the helpers of
parallel/mesh.py in a process group of one (the identity, bit for bit).

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

from test_torch_data import _loaders
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
    data shard, mesh_data 2); an explicit count that is a multiple of the
    world size, G / W of them on each rank."""
    cfg = _world2(capacity_groups=groups)
    jcfg = jconfig.ExperimentConfig()
    jcfg.runtime.mesh_data, jcfg.model.capacity_groups = 2, groups
    assert tbuilder._capacity_groups(cfg) == want
    assert jbuilder._capacity_groups(jcfg) == want
    cfg.model.eval_capacity = 0.5
    model, _ = tbuilder.build_model(cfg, device="cpu")
    assert model.main_net.capacity_groups == want // 2


def test_capacity_groups_across_ranks_are_refused():
    """A group count that is not a multiple of the world size would pack
    across ranks, which is not ported: a ValueError naming ROADMAP A.21."""
    with pytest.raises(ValueError, match="A.21"):
        tbuilder._capacity_groups(_world2(capacity_groups=3))


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
def group_of_one():
    """A gloo process group of one in this process, left at the end."""
    cfg = flagship_cfg(tiny=True)
    cfg.runtime.dist_url = mesh.free_local_url()
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
    for bit (the CPU counterpart of chip_smoke.py's NCCL check)."""
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
