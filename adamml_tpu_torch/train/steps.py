"""Train and eval steps (``adamml_tpu/train/steps.py``).

The AdaMML train step runs forward, loss, backward, clip, the update of the
live subnet and the metrics. Only the phase's live subnet takes gradients
(``requires_grad_`` per phase, the reference's freezing,
models/adamml.py:114-132); the whole model still runs with ``train=True``,
so the BN statistics of the frozen subnet update too (reference
utils/utils.py:335). Gumbel and dropout noise come from per-step
generators derived from (seed, step), the counterpart of ``_step_rngs``.
``make_adamml_multi_step`` runs K such steps a call; on the card they are
one captured CUDA graph, replayed (``_GraphedSteps``).

In a process group (parallel/mesh.py) a step is one rank's share of the
parallel step: the live gradients are averaged over the data group between
backward and the clip (the clip sees the global gradient, as JAX's psum
before ``clip_by_global_norm``), the metrics are averaged over it, and
with per-replica BN rank 0's BN statistics are broadcast after the update
(DDP's broadcast_buffers), so every rank ends the step with the same
replicated parameters, statistics and metrics (model peers hold their own
rows of the sharded weights). Without a group none of this runs.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..data.aug_params import OVERSAMPLE_CENTER
from ..parallel.mesh import (GradAllReduce, average_metrics, backend_name,
                             bn_statistics, broadcast_tensors)
from ..utils.profiling import capture_map, span
from .losses import compute_policy_loss, cross_entropy
from .optim import clip_by_global_norm, set_lr
from .train_state import EvalState, StageFlags, TrainState


def _topk_metrics(logits: torch.Tensor, targets: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """Mean top-1/top-5 in percent; multi-hot targets count top-1 hits on any
    positive class."""
    if targets.dim() > 1:
        top1 = logits.argmax(dim=-1)
        hit1 = targets.gather(1, top1[:, None])[:, 0] > 0
        return {"top1": 100.0 * hit1.float().mean(),
                "top5": torch.zeros((), device=logits.device)}
    k = min(5, logits.shape[-1])
    # a stable sort ranks tied logits by class index, as lax.top_k does
    # (torch.topk leaves their order open)
    pred = logits.sort(dim=-1, descending=True, stable=True).indices[:, :k]
    correct = pred == targets[:, None]
    return {"top1": 100.0 * correct[:, 0].float().mean(),
            "top5": 100.0 * correct.any(dim=1).float().mean()}


def step_seed(seed: int, step: int) -> int:
    """Per-step generator seed, the counterpart of fold_in(rng, step)."""
    return (seed * 1_000_003 + step) % (2 ** 63)


def step_generators(device: torch.device, seed: int, step: int
                    ) -> Tuple[torch.Generator, torch.Generator]:
    """(gumbel, dropout) generators of one step on ``device``."""
    base = step_seed(seed, step)
    return tuple(torch.Generator(device=device).manual_seed(step_seed(base, k))
                 for k in (0, 1))


def _adamml_step_body(model: nn.Module, *, flags: StageFlags,
                      penalty_type: str, gammas: float,
                      clip_gradient: Optional[float]
                      ) -> Tuple[Callable, Callable]:
    """(body, set_lrs). body(state, inputs, target, temperature,
    cost_weights, gumbel, dropout) -> metrics runs forward, loss, backward,
    clip and the update of the live subnet, with the learning rates
    already in the optimizers (``set_lrs(state, lr, p_lr)``). It reads no
    value back to the host, so a CUDA graph can capture it; the
    temperature and cost weights may be device tensors."""
    has_policy = model.policy_net is not None
    update_policy = flags.update_policy and has_policy
    live = ([model.main_net] if flags.update_main else []) + (
        [model.policy_net] if update_policy else [])
    params = [p for m in live for p in m.parameters()]
    reduce_grads = GradAllReduce(params)
    sync_stats = _replica_stats(model)

    def body(state: TrainState, inputs: Sequence[torch.Tensor],
             target: torch.Tensor, temperature, cost_weights,
             gumbel: torch.Generator, drop: torch.Generator):
        model.main_net.requires_grad_(flags.update_main)
        if has_policy:
            model.policy_net.requires_grad_(flags.update_policy)
        for opt in (state.main_opt, state.policy_opt):
            if opt is not None:
                opt.zero_grad(set_to_none=True)
        logits, decisions = model(inputs, temperature, train=True,
                                  generator=gumbel, dropout_generator=drop)
        cls_loss = cross_entropy(logits, target)
        policy_loss = compute_policy_loss(penalty_type, decisions,
                                          cost_weights, gammas, logits,
                                          target)
        # the policy loss enters the total only while the policy trains
        # (reference utils/utils.py:379-382)
        loss = cls_loss + policy_loss if flags.update_policy else cls_loss
        if params:
            loss.backward()
            reduce_grads()
            clip_by_global_norm(params, clip_gradient)
        if flags.update_main:
            state.main_opt.step()
        if update_policy:
            state.policy_opt.step()
        sync_stats()
        logits = logits.detach()
        return average_metrics({
            "loss": loss.detach(), "cls_loss": cls_loss.detach(),
            "policy_loss": policy_loss.detach(),
            "selection": decisions.detach().mean(dim=(0, 1)),
            **_topk_metrics(logits, target)})

    def set_lrs(state: TrainState, lr: float, p_lr: float) -> None:
        if flags.update_main:
            set_lr(state.main_opt, lr)
        if update_policy:
            set_lr(state.policy_opt, p_lr)

    return body, set_lrs


def _replica_stats(model: nn.Module) -> Callable[[], None]:
    """After a step: rank 0's BN statistics to every rank when the moments
    are per replica (a no-op under --sync-bn, whose statistics are global
    on every rank already, and without a process group)."""
    if any(getattr(m, "sync", False) for m in model.modules()):
        return lambda: None
    stats = bn_statistics(model)
    return lambda: broadcast_tensors(stats)


def make_adamml_train_step(model: nn.Module, *, flags: StageFlags,
                           penalty_type: str, gammas: float,
                           clip_gradient: Optional[float]) -> Callable:
    """Returns step(state, inputs, target, lr, p_lr, cost_weights, seed) ->
    metrics. The step updates the model's parameters and BN statistics and
    ``state`` (optimizers, step counter) in place. Metrics are tensors on
    the model's device: loss, cls_loss, policy_loss, selection (M,), top1,
    top5."""
    body, set_lrs = _adamml_step_body(
        model, flags=flags, penalty_type=penalty_type, gammas=gammas,
        clip_gradient=clip_gradient)
    return _single_step(next(model.parameters()).device, body, set_lrs)


def _single_step(device: torch.device, body: Callable,
                 set_lrs: Callable) -> Callable:
    """The single step around ``_adamml_step_body``'s body."""

    def step(state: TrainState, inputs: Sequence[torch.Tensor],
             target: torch.Tensor, lr: float, p_lr: float,
             cost_weights: Union[Sequence[float], torch.Tensor], seed: int):
        set_lrs(state, lr, p_lr)
        gumbel, drop = step_generators(device, seed, state.step)
        # the temperature as a 0-d device tensor, as a replayed graph reads
        # it: CUDA divides by a host number through its reciprocal, which
        # can differ from the quotient by an ulp (on the CPU the bits are
        # the same either way)
        temperature = torch.full((), float(state.temperature),
                                 dtype=torch.float32, device=device)
        metrics = body(state, inputs, target, temperature, cost_weights,
                       gumbel, drop)
        state.step += 1
        return metrics

    return step


def _single_steps(single: Callable, state: TrainState,
                  stacked_inputs: Sequence[torch.Tensor],
                  stacked_targets: torch.Tensor, lr: float, p_lr: float,
                  cost_weights, seed: int) -> Dict[str, torch.Tensor]:
    """K calls of the single step on the K batches, metrics stacked."""
    metrics = [single(state, [x[s] for x in stacked_inputs],
                      stacked_targets[s], lr, p_lr, cost_weights, seed)
               for s in range(stacked_targets.shape[0])]
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def make_adamml_multi_step(model: nn.Module, *, flags: StageFlags,
                           penalty_type: str, gammas: float,
                           clip_gradient: Optional[float]) -> Callable:
    """K real optimizer steps per dispatch (``adamml_tpu/train/steps.py``'s
    ``make_adamml_multi_step``, one ``lax.scan`` there): returns
    multi(state, stacked_inputs, stacked_targets, lr, p_lr, cost_weights,
    seed) -> metrics with a leading K axis, where ``stacked_inputs`` is the
    per-modality list with a leading K axis. The math is K single steps:
    step s draws its noise from ``step_generators(device, seed,
    state.step)`` as the single step does, and ``state.step`` advances by
    K.

    On the CPU it is K calls of the single step. On a CUDA model the K
    steps become one CUDA graph (``_GraphedSteps``): the first dispatch
    runs them as K single steps, the second captures the graph, and it and
    later ones replay it. In a process group the graph holds the step's
    collectives, so on CUDA the group must be NCCL's: gloo's run on the
    host, where no graph can hold them, and a CUDA model under gloo
    raises."""
    device = next(model.parameters()).device
    if device.type == "cuda" and backend_name() not in (None, "nccl"):
        raise ValueError(
            f"--steps_per_dispatch > 1 replays the steps as one CUDA graph, "
            f"which cannot hold the {backend_name()} backend's collectives "
            f"(they run on the host): use the nccl backend, or one step a "
            f"dispatch")
    body, set_lrs = _adamml_step_body(
        model, flags=flags, penalty_type=penalty_type, gammas=gammas,
        clip_gradient=clip_gradient)
    single = _single_step(device, body, set_lrs)
    if device.type == "cuda":
        return _GraphedSteps(model, body, set_lrs, single)
    return functools.partial(_single_steps, single)


class _GraphedSteps:
    """K train steps on a CUDA model as one replayed CUDA graph.

    The graph reads everything that changes from one dispatch to the next
    from tensors that stay where they are: the batches (static buffers the
    inputs are copied into), the learning rates (the optimizers' device
    tensors, ``optim.set_lr``), the temperature and the cost weights
    (device scalars), and the noise: 2K generators registered with the
    graph (``CUDAGraph.register_generator_state``), reseeded before each
    replay to the seeds of steps ``state.step .. state.step + K - 1``, so a
    replay draws what K single steps would. Capture records work without
    running it, so ``state.step`` advances here, once per real step.

    The first dispatch, and the first after the optimizers, their state,
    the parameters or the shapes change (the curriculum builds new
    optimizers between stages; a checkpoint loads new optimizer state), runs
    K single steps: that builds the kernels, makes the optimizers' state
    and the learning-rate tensors, and runs the kernels' one-time set-up,
    none of which a capture may do. The next dispatch captures the graph
    and replays it. A failed capture or replay raises; nothing falls back
    to single steps.

    The kernel wrappers count a launch when they enqueue it, so their
    counts see a captured launch once and no replay (a device trace counts
    the replayed kernels). The capture records the graph's capture map
    (utils/profiling.py: each kernel node's span, such as ``model.bn``),
    kept as ``capture``; a dispatch that replays runs its host work in
    two spans, ``step.stage`` (the copies and fills the graph reads) and
    ``step.replay``."""

    def __init__(self, model: nn.Module, body: Callable, set_lrs: Callable,
                 single: Callable):
        self.model, self.body, self.set_lrs = model, body, set_lrs
        self.single = single
        self.device = next(model.parameters()).device
        self.key = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.capture: Optional[dict] = None
        self.eager_dispatches = self.replays = 0

    def _key(self, state: TrainState, stacked_inputs, stacked_targets,
             cost_weights) -> tuple:
        """What a captured graph holds fixed: the optimizers (held, so their
        ids cannot be reused), the address of every parameter, buffer,
        optimizer state and learning-rate tensor, and the shapes."""
        tensors = list(self.model.parameters()) + list(self.model.buffers())
        opts = (state.main_opt, state.policy_opt)
        for opt in opts:
            if opt is not None:
                tensors += [v for st in opt.state.values()
                            for v in st.values()
                            if isinstance(v, torch.Tensor)]
                tensors += list(getattr(opt, "_lr_tensors", {}).values())
        return (opts,
                tuple(t.data_ptr() for t in tensors),
                tuple((tuple(x.shape), x.dtype) for x in stacked_inputs),
                (tuple(stacked_targets.shape), stacked_targets.dtype),
                len(cost_weights))

    def _capture(self, state: TrainState, stacked_inputs, stacked_targets,
                 cost_weights) -> None:
        """The static buffers, the 2K generators and the graph of K
        steps that read them."""
        k = int(stacked_targets.shape[0])
        self.inputs = [torch.empty_like(x) for x in stacked_inputs]
        self.targets = torch.empty_like(stacked_targets)
        self.temperature = torch.zeros((), dtype=torch.float32,
                                       device=self.device)
        self.cost_weights = torch.zeros(len(cost_weights),
                                        dtype=torch.float32,
                                        device=self.device)
        self.gens = [tuple(torch.Generator(device=self.device)
                           for _ in range(2)) for _ in range(k)]
        graph = torch.cuda.CUDAGraph()
        for pair in self.gens:
            for gen in pair:
                graph.register_generator_state(gen)
        try:
            with torch.cuda.graph(graph), capture_map(k) as spans:
                metrics = [self.body(state, [x[s] for x in self.inputs],
                                     self.targets[s], self.temperature,
                                     self.cost_weights, *self.gens[s])
                           for s in range(k)]
                self.out = {n: torch.stack([m[n] for m in metrics])
                            for n in metrics[0]}
        except Exception as e:
            raise RuntimeError(f"capturing {k} train steps as one CUDA "
                               f"graph failed: {e}") from e
        self.graph, self.capture = graph, spans.result

    def __call__(self, state: TrainState,
                 stacked_inputs: Sequence[torch.Tensor],
                 stacked_targets: torch.Tensor, lr: float, p_lr: float,
                 cost_weights, seed: int) -> Dict[str, torch.Tensor]:
        key = self._key(state, stacked_inputs, stacked_targets, cost_weights)
        if key != self.key:
            self.graph = self.out = None
            metrics = _single_steps(self.single, state, stacked_inputs,
                                    stacked_targets, lr, p_lr, cost_weights,
                                    seed)
            self.eager_dispatches += 1
            # the optimizers' state exists now: what the capture will hold
            self.key = self._key(state, stacked_inputs, stacked_targets,
                                 cost_weights)
            return metrics
        if self.graph is None:
            self._capture(state, stacked_inputs, stacked_targets,
                          cost_weights)
        with span("step.stage"):
            for buf, x in zip(self.inputs, stacked_inputs):
                buf.copy_(x, non_blocking=True)
            self.targets.copy_(stacked_targets, non_blocking=True)
            self.set_lrs(state, lr, p_lr)
            self.temperature.fill_(float(state.temperature))
            self.cost_weights.copy_(torch.as_tensor(cost_weights,
                                                    dtype=torch.float32))
            for s, pair in enumerate(self.gens):
                base = step_seed(seed, state.step + s)
                for j, gen in enumerate(pair):
                    gen.manual_seed(step_seed(base, j))
        with span("step.replay"):
            self.graph.replay()
        state.step += len(self.gens)
        self.replays += 1
        return {name: v.clone() for name, v in self.out.items()}


def _crop_mean(logits: torch.Tensor, num_crops: int) -> torch.Tensor:
    """Average logits over the crops that the device pipeline folded into
    the batch, crop-major per sample."""
    return logits.reshape((-1, num_crops) + tuple(logits.shape[1:])).mean(1)


def make_adamml_eval_step(model: nn.Module, num_crops: int = 1) -> Callable:
    """Returns step(state, inputs, target, seed) -> (logits, decisions,
    loss). Gumbel noise is still drawn at eval, as in the reference
    (F.gumbel_softmax samples under model.eval()), from a generator on the
    model's device seeded per step. Runs under torch.no_grad().

    num_crops > 1 (multi-crop oversample eval, reference GroupOverSample):
    inputs carry N*num_crops rows; logits average over the crops and the
    reported decisions are the canonical centre-unflipped crop's."""
    device = next(model.parameters()).device
    center = OVERSAMPLE_CENTER[num_crops]

    @torch.no_grad()
    def step(state: EvalState, inputs, target: torch.Tensor, seed: int):
        gumbel, _ = step_generators(device, seed, state.step)
        logits, decisions = model(inputs, state.temperature, train=False,
                                  generator=gumbel)
        if num_crops > 1:
            logits = _crop_mean(logits, num_crops)
            decisions = decisions.reshape(
                (-1, num_crops) + tuple(decisions.shape[1:]))[:, center]
        loss = cross_entropy(logits, target)
        return logits, decisions, loss

    return step


def make_unimodal_train_step(model: nn.Module, *,
                             clip_gradient: Optional[float]) -> Callable:
    """Single-backbone step of train_unimodal (reference
    utils/utils.py:187-265): returns step(state, inputs, target, lr, seed)
    -> metrics (loss, top1, top5 on the model's device). It updates the
    model and ``state.main_opt`` in place; ``state.policy_opt`` is None."""
    device = next(model.parameters()).device
    reduce_grads = GradAllReduce(list(model.parameters()))
    sync_stats = _replica_stats(model)

    def step(state: TrainState, inputs: torch.Tensor, target: torch.Tensor,
             lr: float, seed: int):
        state.main_opt.zero_grad(set_to_none=True)
        _, drop = step_generators(device, seed, state.step)
        logits = model(inputs, train=True, generator=drop)
        loss = cross_entropy(logits, target)
        loss.backward()
        reduce_grads()
        clip_by_global_norm(model.parameters(), clip_gradient)
        set_lr(state.main_opt, lr)
        state.main_opt.step()
        sync_stats()
        state.step += 1
        return average_metrics({"loss": loss.detach(),
                                **_topk_metrics(logits.detach(), target)})

    return step


def make_unimodal_eval_step(model: nn.Module, num_crops: int = 1
                            ) -> Callable:
    """Returns step(state, inputs, target, seed) -> (logits, loss), with
    logits averaged over folded crops. Runs under torch.no_grad()."""

    @torch.no_grad()
    def step(state: EvalState, inputs: torch.Tensor, target: torch.Tensor,
             seed: int):
        logits = model(inputs, train=False)
        if num_crops > 1:
            logits = _crop_mean(logits, num_crops)
        return logits, cross_entropy(logits, target)

    return step
