"""Data-parallel runs over processes: the counterpart of
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

The process group is ``torch.distributed``'s default group. Without one
every helper is the identity and launches nothing, so a run of one process
is the single-device step bit for bit. With a group, even of one, the
collectives run.
"""

from __future__ import annotations

import dataclasses
import datetime
import platform
import socket
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

HOSTFILE_PORT = 10598  # reference train_adamml.py:40-50
DEFAULT_TIMEOUT_S = 600.0
BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The run's data-parallel layout: ``backend`` None means one process
    with no process group."""

    world: int
    rank: int
    device: torch.device
    backend: Optional[str]


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
    if r.mesh_data not in (-1, world):
        raise ValueError(f"--mesh_data {r.mesh_data} must be -1 or the world "
                         f"size {world}")
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
    return DataMesh(world, rank, dev, backend)


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if active():
        dist.destroy_process_group()


def free_local_url() -> str:
    """A ``tcp://127.0.0.1:PORT`` URL on a port free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> Tuple[int, int]:
    """(world size, rank) of the process group; (1, 0) without one."""
    if not active():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


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
    """Sum over ranks; the backward sums the cotangent over ranks."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """Differentiable mean of ``x`` over ranks (x itself without a group;
    at world size 1 the same bits, since x / 1 == x)."""
    if not active():
        return x
    return _AllReduceSum.apply(x) / dist.get_world_size()


class GradAllReduce:
    """The average over ranks of ``params``' gradients, through one flat
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
        if not active() or not self.params:
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
        dist.all_reduce(self.flat)
        self.flat.div_(dist.get_world_size())
        if grads:
            torch._foreach_copy_(grads, views)


def average_metrics(metrics: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Each metric's mean over ranks, by one collective."""
    if not active():
        return metrics
    keys = list(metrics)
    flat = torch.cat([metrics[k].reshape(-1).float() for k in keys])
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
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
    """Rank 0's parameters and buffers to every rank."""
    broadcast_tensors([p.data for p in module.parameters()]
                      + list(module.buffers()))


def gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (``x``
    itself without a group). Under NCCL the gather runs on the card; gloo
    cannot all-gather CUDA tensors, so there it gathers host copies and the
    result is on the CPU."""
    if not active():
        return x
    src = x.contiguous() if dist.get_backend() == "nccl" else x.cpu()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim=dim)


def local_noise(draw: Callable[[Tuple[int, ...]], torch.Tensor],
                shape: Sequence[int], dim: int = 0) -> torch.Tensor:
    """A noise tensor for this rank's rows: ``draw`` makes the global
    batch's noise (``shape`` with ``dim`` times the world size, ranks'
    rows in rank order) and the rank keeps its block, so a W-rank step
    draws what the single process draws on the global batch. Without a
    group, ``draw(shape)``."""
    w, r = world()
    shape = tuple(shape)
    if w == 1:
        return draw(shape)
    n = shape[dim]
    full = shape[:dim] + (n * w,) + shape[dim + 1:]
    return draw(full).narrow(dim, r * n, n)


def launch(run: Callable, cfg, devices: Sequence[str],
           backend: Optional[str] = None, spawn: bool = False) -> int:
    """Run ``run(cfg, device, backend) -> int`` in this process on
    ``devices[0]``, or with ``spawn`` (--multiprocessing-distributed) in
    one process per device, as the reference does (reference
    train_adamml.py:54-63): --world-size counts nodes and --rank names this
    node, so rank = node * len(devices) + local index. One node without
    --dist-url rendezvouses on a free local port. A failing process makes
    this raise."""
    if not spawn:
        return run(cfg, devices[0], backend)
    where = coordinator(cfg)
    url, nodes, node = where if where else (free_local_url(), 1, 0)
    torch.multiprocessing.spawn(
        _spawned, args=(run, cfg, list(devices), url, nodes, node, backend),
        nprocs=len(devices), join=True)
    return 0


def _spawned(i: int, run: Callable, cfg, devices: List[str], url: str,
             nodes: int, node: int, backend: Optional[str]) -> None:
    r = cfg.runtime
    r.hostfile, r.dist_url = "", url
    r.world_size, r.rank = nodes * len(devices), node * len(devices) + i
    rc = run(cfg, devices[i], backend)
    if rc:
        raise SystemExit(rc)
