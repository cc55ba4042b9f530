"""Data- and tensor-parallel runs over processes: the counterpart of
``adamml_tpu/parallel/mesh.py`` and of the JAX CLI's ``init_distributed``.

The JAX package runs a W-way data mesh as one program: the global batch is
sharded in contiguous blocks, XLA inserts the gradient psum, BN takes its
moments per shard (or globally under --sync-bn) and the eval outputs are
gathered. The port runs one process per rank (the reference's layout,
reference train_adamml.py:54-63) and calls ``torch.distributed``
collectives from its own step, so that a W-rank step computes the
single-device step on the global batch with ``bn_groups = W`` (or 1 under
--sync-bn), as a W-way JAX mesh does:

  * ``GradAllReduce``: the live parameters' gradients averaged over the
    ranks through one flat buffer, between backward and the clip;
  * ``all_reduce_mean``: a differentiable mean over ranks (synchronized BN
    moments, models/norm.py);
  * ``average_metrics``: the step's metrics averaged over ranks (equal
    local batches, so the mean of means is the global mean);
  * ``broadcast_tensors``: rank 0's tensors to every rank (per-replica BN
    statistics after a step, as DDP's broadcast_buffers; the model after
    init);
  * ``gather_rows``: the counterpart of the JAX engine's ``_host_global``;
  * ``local_noise``: a draw for the global batch of which a rank keeps its
    own rows, so noise does not depend on the world size.

A run of W ranks at ``--mesh_model`` M is the JAX package's (W / M, M)
mesh: rank r has data index r // M and model index r % M (the row-major
reshape of ``make_mesh``). The D = W / M ranks of one model index form a
data group, the M ranks of one data index a model group; the helpers above
run over the data group (model peers hold the same rows). The wide Dense
weights that ``shards_param`` names (the JAX package's ``_spec_for_param``)
keep only their model index's rows on a rank, and ``column_parallel_linear``
computes their layer: the output columns of the rank's rows, gathered over
the model group. Under GSPMD such a mesh computes the (W / M, 1) mesh's
function, and so does the port. At M = 1 no group but the default one is
made, and the data group is the world.

The process group is ``torch.distributed``'s default group. Without one
every helper is the identity and launches nothing, so a run of one process
is the single-device step bit for bit. With a group, even of one, the
collectives run, except the data group's when it is one rank beside a
model axis (D = 1 at M > 1).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import platform
import tempfile
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

HOSTFILE_PORT = 10598  # reference train_adamml.py:40-50
DEFAULT_TIMEOUT_S = 600.0
BACKENDS = ("nccl", "gloo")


# module names whose Dense weight is column-sharded over the model group
# (adamml_tpu/parallel/mesh.py:65-70), matched exactly against the
# weight's parent module name
TP_MODULES = frozenset(
    {"joint_fc1", "joint_fc2", "fc", "classifier", "ih", "hh"})


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The run's layout: ``backend`` None means one process with no process
    group; ``data`` x ``model`` = ``world`` ranks, this one at
    (``data_index``, ``model_index``)."""

    world: int
    rank: int
    device: torch.device
    backend: Optional[str]
    data: int = 1
    model: int = 1
    data_index: int = 0
    model_index: int = 0


@dataclasses.dataclass(frozen=True)
class Shard:
    """A weight's share on this rank: rows [index * n / size, (index + 1) *
    n / size) of the full (out, in) weight, its layer's outputs gathered
    over ``group`` (the model group)."""

    size: int
    index: int
    group: object

    def rows(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a full tensor (dim 0)."""
        n = full.shape[0] // self.size
        return full.narrow(0, self.index * n, n)


# (mesh, data group, model group) of the joined run; None without one
_LAYOUT: Optional[Tuple[DataMesh, object, object]] = None


def parse_hostfile(lines, current_node: str):
    """Derive (coordinator_address, num_processes, process_id) from hostfile
    lines, mirroring the reference's rank derivation (reference
    train_adamml.py:40-50: line index = rank, first line's hostname = master,
    port 10598) with two hardenings: the hostname match is EXACT on the
    line's first whitespace token (the reference's `curr in node` substring
    test lets "node1" match "node10"), and an unmatched host is a loud error
    instead of a silent rank-0 fallback."""
    nodes = [x.strip() for x in lines if x.strip()]
    if not nodes:
        raise RuntimeError("hostfile is empty")
    hostnames = [n.split()[0].split(".")[0] for n in nodes]
    master = nodes[0].split()[0]
    curr = current_node.split(".")[0]
    matches = [i for i, h in enumerate(hostnames) if h == curr]
    if not matches:
        raise RuntimeError(
            f"current node {curr!r} not found in hostfile "
            f"(hosts: {hostnames}); refusing to guess a rank")
    if len(matches) > 1:
        raise RuntimeError(
            f"current node {curr!r} appears {len(matches)} times in the "
            f"hostfile; ranks would be ambiguous")
    return f"{master}:{HOSTFILE_PORT}", len(nodes), matches[0]


def coordinator(cfg) -> Optional[Tuple[str, int, int]]:
    """(init URL, world size, rank) of the run ``cfg`` asks for: from
    --hostfile, or from --dist-url with --world-size and --rank (a group of
    one at world size 1); None for one process without a group. A world
    size above 1 with neither raises."""
    r = cfg.runtime
    if r.hostfile:
        with open(r.hostfile) as f:
            coord, world, rank = parse_hostfile(f.readlines(),
                                                platform.node())
        return f"tcp://{coord}", world, rank
    if r.dist_url:
        if not 0 <= r.rank < r.world_size:
            raise ValueError(f"--rank {r.rank} is outside --world-size "
                             f"{r.world_size}")
        return r.dist_url, r.world_size, r.rank
    if r.world_size > 1:
        raise ValueError(
            f"--world-size {r.world_size} asks for a multi-process run, "
            f"which needs its coordinator: --dist-url tcp://HOST:PORT with "
            f"--rank, or --hostfile")
    return None


def init_distributed(cfg, device, backend: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> DataMesh:
    """Join the process group ``cfg`` asks for (``coordinator``) and write
    the world size and rank into ``cfg.runtime``. The backend is NCCL on
    CUDA and gloo on the CPU unless ``backend`` (--dist-backend) names one;
    a requested NCCL that is not available raises, and so does a
    coordinator that does not answer within ``timeout_s``
    (``DEFAULT_TIMEOUT_S``, which also bounds every collective)."""
    dev = torch.device(device)
    where = coordinator(cfg)
    if where is None:
        return DataMesh(1, 0, dev, None)
    url, world, rank = where
    r = cfg.runtime
    model = r.mesh_model
    if model < 1 or world % model:
        raise ValueError(f"--mesh_model {model} does not divide the world "
                         f"size {world}")
    if r.mesh_data not in (-1, world // model):
        raise ValueError(f"--mesh_data {r.mesh_data} must be -1 or the world "
                         f"size over --mesh_model ({world} / {model})")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"--dist-backend {backend!r}: the port runs "
                         f"{' or '.join(BACKENDS)}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, got "
                             f"{dev}")
        if not dist.is_nccl_available():
            raise RuntimeError("the nccl backend is not available in this "
                               "torch build")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s
    dist.init_process_group(
        backend, init_method=url, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout),
        # NCCL makes its communicator now, not at the first collective
        # (which a CUDA-graph capture must not be)
        device_id=dev if backend == "nccl" else None)
    r.world_size, r.rank = world, rank
    got = DataMesh(world, rank, dev, backend, world // model, model,
                   rank // model, rank % model)
    _set_layout(got, dev if backend == "nccl" else None)
    return got


def _set_layout(got: DataMesh, device_id) -> None:
    """Make the data and model groups (every rank makes every group, in the
    same order, as ``new_group`` asks) and keep this rank's."""
    global _LAYOUT
    data_group = model_group = None
    if got.model > 1:
        d, m = got.data, got.model
        for j in range(m):
            g = dist.new_group([i * m + j for i in range(d)],
                               device_id=device_id)
            if j == got.model_index:
                data_group = g
        for i in range(d):
            g = dist.new_group([i * m + j for j in range(m)],
                               device_id=device_id)
            if i == got.data_index:
                model_group = g
    _LAYOUT = (got, data_group, model_group)


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    global _LAYOUT
    _LAYOUT = None
    if active():
        dist.destroy_process_group()


def file_url(directory) -> str:
    """A ``file://`` rendezvous URL on a new file name in ``directory``
    (``init_process_group`` wants a file that does not exist or is empty,
    one a group, for gloo and NCCL alike): ranks on one host meet there
    without a port chosen and released first."""
    path = os.path.join(os.path.abspath(directory),
                        f"rendezvous-{uuid.uuid4().hex}")
    return f"file://{path}"


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(world size, rank) of the process group; (1, 0) without one."""
    if not active():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def layout() -> DataMesh:
    """The joined run's layout (a process without a group: 1 x 1)."""
    if _LAYOUT is None:
        return DataMesh(1, 0, torch.device("cpu"), None)
    return _LAYOUT[0]


def data_world() -> Tuple[int, int]:
    """(data shards D, this rank's data index); (1, 0) without a group."""
    got = layout()
    return got.data, got.data_index


def _data_group():
    """The data group (None: the default group, the world at M = 1)."""
    return _LAYOUT[1] if _LAYOUT is not None else None


def model_group():
    """This rank's model group; None unless --mesh_model is above 1."""
    return _LAYOUT[2] if _LAYOUT is not None else None


def _data_collectives() -> bool:
    """Whether the data group's collectives run: in a process group, but
    not over a data group of one beside a model axis (D = 1 at M > 1),
    where each would copy a tensor onto itself."""
    got = layout()
    return active() and not (got.model > 1 and got.data == 1)


def backend_name() -> Optional[str]:
    return dist.get_backend() if active() else None


def barrier() -> None:
    if not active():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the data group; the backward sums the cotangent over it."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y, group=_data_group())
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=_data_group())
        return g


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """Differentiable mean of ``x`` over the data group (x itself without a
    group; at one data shard the same bits, since x / 1 == x)."""
    if not _data_collectives():
        return x
    return _AllReduceSum.apply(x) / data_world()[0]


class GradAllReduce:
    """The average over the data group of ``params``' gradients (a sharded
    weight's data peers hold the same rows), through one flat
    float32 buffer made at the first call (before any CUDA-graph capture,
    which then reuses it): the gradients are copied in, reduced by one
    collective and copied back. A parameter without a gradient adds zeros
    and keeps none: which parameters take gradients is the same on every
    rank (the graph does not depend on the data)."""

    def __init__(self, params: Sequence[torch.nn.Parameter]):
        self.params = list(params)
        self.flat: Optional[torch.Tensor] = None
        self.views: List[torch.Tensor] = []

    def __call__(self) -> None:
        if not _data_collectives() or not self.params:
            return
        if self.flat is None:
            self.flat = torch.empty(sum(p.numel() for p in self.params),
                                    dtype=torch.float32,
                                    device=self.params[0].device)
            self.views = [v.view(p.shape) for v, p in zip(
                self.flat.split([p.numel() for p in self.params]),
                self.params)]
        have = [(v, p.grad) for v, p in zip(self.views, self.params)
                if p.grad is not None]
        if len(have) < len(self.params):
            self.flat.zero_()
        views, grads = [v for v, _ in have], [g for _, g in have]
        if grads:
            torch._foreach_copy_(views, grads)
        dist.all_reduce(self.flat, group=_data_group())
        self.flat.div_(data_world()[0])
        if grads:
            torch._foreach_copy_(grads, views)


def average_metrics(metrics: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Each metric's mean over the data group, by one collective."""
    if not _data_collectives():
        return metrics
    keys = list(metrics)
    flat = torch.cat([metrics[k].reshape(-1).float() for k in keys])
    dist.all_reduce(flat, group=_data_group())
    flat.div_(data_world()[0])
    out, at = {}, 0
    for k in keys:
        n = metrics[k].numel()
        out[k] = flat[at:at + n].reshape(metrics[k].shape).to(
            metrics[k].dtype)
        at += n
    return out


@torch.no_grad()
def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` on every rank with rank ``src``'s, by one
    collective per dtype."""
    if not active():
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src)
        torch._foreach_copy_(group, [v.view(t.shape) for v, t in zip(
            flat.split([t.numel() for t in group]), group)])


def bn_statistics(module: torch.nn.Module) -> List[torch.Tensor]:
    """The BN running statistics of ``module``, in a fixed order."""
    return [b for name, b in module.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's replicated parameters and its buffers to every rank (a
    sharded weight's rows differ from rank to rank)."""
    broadcast_tensors([p.data for p in module.parameters()
                       if param_shard(p) is None] + list(module.buffers()))


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` of every rank of ``group`` concatenated along ``dim`` in group
    order. Under NCCL the gather runs on the card; gloo cannot all-gather
    CUDA tensors, so there it gathers host copies and the result is on the
    CPU."""
    src = x.contiguous() if dist.get_backend(group) == "nccl" else x.cpu()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every data shard's ``x`` concatenated along ``dim`` in data-index
    order (``x`` itself without a group); on the CPU under gloo."""
    if not _data_collectives():
        return x
    return _all_gather(x, dim, _data_group())


def local_noise(draw: Callable[[Tuple[int, ...]], torch.Tensor],
                shape: Sequence[int], dim: int = 0) -> torch.Tensor:
    """A noise tensor for this rank's rows: ``draw`` makes the global
    batch's noise (``shape`` with ``dim`` times the data shards, their rows
    in data-index order) and the rank keeps its data index's block, so a
    W-rank step draws what the single process draws on the global batch,
    and model peers draw the same. Without a group, ``draw(shape)``."""
    w, r = data_world()
    shape = tuple(shape)
    if w == 1:
        return draw(shape)
    n = shape[dim]
    full = shape[:dim] + (n * w,) + shape[dim + 1:]
    return draw(full).narrow(dim, r * n, n)


def shards_param(name: str, tensor: torch.Tensor, model: int) -> bool:
    """Whether parameter ``name`` is column-sharded over a model axis of
    ``model``: the port's ``_spec_for_param``
    (adamml_tpu/parallel/mesh.py:77-83). A torch Dense ``weight`` is
    (out, in), so flax's column shard of the (in, out) kernel is its row
    shard; biases stay replicated."""
    names = name.split(".")
    return (model > 1 and tensor.dim() == 2 and len(names) >= 2
            and names[-1] == "weight" and names[-2] in TP_MODULES
            and tensor.shape[0] % model == 0)


def param_shard(p: torch.Tensor) -> Optional[Shard]:
    """The ``Shard`` of a sharded parameter, None for a replicated one."""
    return getattr(p, "model_shard", None)


def _model_gather(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The full tensor of every model peer's rows, on ``t``'s device."""
    return _all_gather(t.detach(), 0, shard.group).to(t.device)


def full_state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with each sharded weight gathered to its
    full rows (a collective over the model group: every rank calls it)."""
    sd = module.state_dict()
    for name, p in module.named_parameters():
        sh = param_shard(p)
        if sh is not None:
            sd[name] = _model_gather(p, sh)
    return sd


def shard_state_dict(module: torch.nn.Module,
                     sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A full state dict cut to ``module``'s shards: each sharded weight's
    entry keeps this rank's rows."""
    sd = dict(sd)
    for name, p in module.named_parameters():
        sh = param_shard(p)
        if sh is not None and name in sd:
            sd[name] = sh.rows(sd[name])
    return sd


def _optimizer_params(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    """The parameters in the order of the state dict's indices."""
    return [p for g in opt.param_groups for p in g["params"]]


def full_optimizer_state(opt: torch.optim.Optimizer) -> dict:
    """``opt.state_dict()`` with each sharded parameter's per-element state
    (SGD momentum, Adam moments) gathered to its full rows."""
    sd = opt.state_dict()
    params = _optimizer_params(opt)
    state = {}
    for i, st in sd["state"].items():
        sh = param_shard(params[i])
        state[i] = st if sh is None else {
            k: _model_gather(v, sh) if _per_element(v, params[i]) else v
            for k, v in st.items()}
    return {**sd, "state": state}


def shard_optimizer_state(opt: torch.optim.Optimizer, sd: dict) -> dict:
    """A full optimizer state dict cut to ``opt``'s parameters' shards."""
    params = _optimizer_params(opt)
    state = {}
    for i, st in sd["state"].items():
        p = params[int(i)]
        sh = param_shard(p)
        state[i] = st if sh is None else {
            k: sh.rows(v) if _per_element(v, p, sh.size) else v
            for k, v in st.items()}
    return {**sd, "state": state}


def _per_element(v, p: torch.Tensor, size: int = 1) -> bool:
    """Whether ``v`` is per-element state of ``p`` (or of ``p``'s full
    tensor of ``size`` shards)."""
    return (torch.is_tensor(v) and v.dim() == p.dim() and v.dim() > 0
            and v.shape[0] == size * p.shape[0]
            and v.shape[1:] == p.shape[1:])


class _CopyToModel(torch.autograd.Function):
    """The identity; the backward sums the cotangent over the model group
    (each model peer's share of the input gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = g.to(torch.float32, copy=True)
        dist.all_reduce(total, group=ctx.group)
        return total.to(g.dtype), None


class _GatherFromModel(torch.autograd.Function):
    """The model peers' output columns concatenated in model-index order;
    the backward keeps this rank's columns."""

    @staticmethod
    def forward(ctx, y, group, index):
        ctx.index, ctx.width = index, y.shape[-1]
        return _all_gather(y, y.dim() - 1, group).to(y.device)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.index * ctx.width,
                        ctx.width).contiguous(), None, None


def column_parallel_linear(x: torch.Tensor, weight: torch.Tensor,
                           bias: Optional[torch.Tensor],
                           shard: Shard) -> torch.Tensor:
    """``F.linear(x, full_weight, bias)`` from this rank's rows of the
    weight: the rank's output columns, gathered over the model group, then
    the replicated bias (as flax's Dense adds it after the product)."""
    x = _CopyToModel.apply(x, shard.group)
    y = _GatherFromModel.apply(torch.nn.functional.linear(x, weight),
                               shard.group, shard.index)
    return y if bias is None else y + bias


def launch(run: Callable, cfg, devices: Sequence[str],
           backend: Optional[str] = None, spawn: bool = False) -> int:
    """Run ``run(cfg, device, backend) -> int`` in this process on
    ``devices[0]``, or with ``spawn`` (--multiprocessing-distributed) in
    one process per device, as the reference does (reference
    train_adamml.py:54-63): --world-size counts nodes and --rank names this
    node, so rank = node * len(devices) + local index. One node without
    --dist-url or --hostfile rendezvouses through a file in a temporary
    directory that lives as long as the ranks. Every rank gets this
    process's ``DEFAULT_TIMEOUT_S`` (a spawned process imports this module
    afresh). A failing process makes this raise."""
    if not spawn:
        return run(cfg, devices[0], backend)
    where = coordinator(cfg)
    with tempfile.TemporaryDirectory(prefix="adamml_rendezvous_") as tmp:
        url, nodes, node = where if where else (file_url(tmp), 1, 0)
        torch.multiprocessing.spawn(
            _spawned, args=(run, cfg, list(devices), url, nodes, node,
                            backend, DEFAULT_TIMEOUT_S),
            nprocs=len(devices), join=True)
    return 0


def _spawned(i: int, run: Callable, cfg, devices: List[str], url: str,
             nodes: int, node: int, backend: Optional[str],
             timeout_s: float) -> None:
    global DEFAULT_TIMEOUT_S
    DEFAULT_TIMEOUT_S = timeout_s
    r = cfg.runtime
    r.hostfile, r.dist_url = "", url
    r.world_size, r.rank = nodes * len(devices), node * len(devices) + i
    rc = run(cfg, devices[i], backend)
    if rc:
        raise SystemExit(rc)
