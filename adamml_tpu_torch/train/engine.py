"""Epoch engines (``adamml_tpu/train/engine.py``): the glue between the
loader, the preprocessing, the steps and the metrics.

Twins of the reference loops (reference utils/utils.py:187-265 train,
:268-317 validate, :319-424 train_adamml, :427-507 validate_adamml) minus
their per-iteration host syncs: the steps leave their metrics on the
device, the engine keeps them there and fetches them in bulk at display
points and at the end (a per-step ``.item()`` would wait for each step),
while the loader's threads prepare the next batches.

Eval accuracy follows the reference contract: the final numbers come from
the full gathered logits matrix via ``actnet_acc`` (reference
utils/utils.py:483-497), with selection rates and modeled GFLOPs
(utils/utils.py:502). Rows the loader padded onto the ragged last batch are
masked out; a batch with padded rows has its loss re-scored on the host
from its real rows.

In a data-parallel run the train metrics arrive averaged over the ranks
(train/steps.py) and rank 0 logs them; ``validate`` gathers every rank's
logits, targets, decisions and batch losses (parallel/mesh.py
``gather_rows``, the JAX engine's ``_host_global``) before the masks and
the row order, so every rank returns the same summary.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..parallel.mesh import data_world, gather_rows
from ..utils.flops import flops_computation
from ..utils.meters import AverageMeter
from ..utils.metrics import actnet_acc
from .steps import step_seed


def _host_cross_entropy(logits: np.ndarray, targets: np.ndarray) -> float:
    """numpy twin of losses.cross_entropy, for re-scoring masked eval rows
    on the host (padded tail rows must not contaminate the loss meter)."""
    logits = logits.astype(np.float64)
    lse = np.log(np.sum(np.exp(logits - logits.max(-1, keepdims=True)), -1))
    logp = logits - logits.max(-1, keepdims=True) - lse[:, None]
    if targets.ndim == 1:
        losses = -logp[np.arange(len(targets)), targets.astype(np.int64)]
    else:
        losses = -(targets * logp).sum(-1)
    return float(losses.mean())


def _fetch(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Device tensors to numpy with one transfer: flattened, concatenated
    and split back to their shapes."""
    if not tensors:
        return []
    flat = torch.cat([t.detach().reshape(-1).float()
                      if t.dtype == torch.bfloat16 else t.detach().reshape(-1)
                      for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


def _gathered(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each batch's rows from every data shard in data-index order, the
    layout of a batch-sharded output gathered over the processes
    (data/dataflow.py::global_valid_masks); per-batch scalars (the mean
    losses of equal local batches) become their mean over the shards."""
    if not tensors or data_world()[0] == 1:
        return tensors
    stacked = torch.stack(tensors)
    if stacked.dim() == 1:
        return list(gather_rows(stacked[:, None], dim=1).mean(1).unbind(0))
    return list(gather_rows(stacked, dim=1).unbind(0))


def train_epoch(loader, preprocess: Callable, step_fn: Callable, state,
                *, lr: float, p_lr: float = 0.0,
                cost_weights: Optional[Sequence[float]] = None,
                seed: int = 0, epoch: int = 0,
                modality: Optional[Sequence[str]] = None,
                adamml: bool = True, display: int = 100, rank: int = 0,
                logger=None, profiler=None,
                multi_step_fn: Optional[Callable] = None,
                steps_per_dispatch: int = 1):
    """One training epoch. Returns (state, summary dict). ``step_fn`` is
    step(state, inputs, target, lr, p_lr, cost_weights, seed) (AdaMML) or
    step(state, inputs, target, lr, seed) (unimodal) returning device
    metrics; it updates ``state`` in place.

    With ``multi_step_fn`` (steps.make_adamml_multi_step) and
    ``steps_per_dispatch`` K > 1, each batch is preprocessed on its own,
    K of them are stacked and dispatched as K real steps in one call; an
    epoch tail of fewer than K batches goes through ``step_fn``.
    ``profiler`` (utils/profiling.StepProfiler) sees every loader index."""
    batch_time, data_time = AverageMeter(), AverageMeter()
    losses, top1, top5 = AverageMeter(), AverageMeter(), AverageMeter()
    modality = list(modality or [])
    selection = {m: AverageMeter() for m in modality}
    loader.set_epoch(epoch)
    cw = list(cost_weights if cost_weights is not None
              else [0.0] * max(1, len(modality)))

    pending = []  # (batch size, device metrics, K: the metrics' steps)
    end = time.time()
    data_mark = end  # per loader index; `end` marks dispatches
    epoch_t0 = end
    num_batch = 0
    next_log = 0  # dispatched-step count at which the next line is due

    def drain():
        keys = ["loss", "top1", "top5"] + (
            ["selection"] if adamml and modality else [])
        got = _fetch([dm[k] for _, dm, _ in pending for k in keys])
        for j, (bn, _, k) in enumerate(pending):
            vals = dict(zip(keys, got[j * len(keys):(j + 1) * len(keys)]))
            for s in range(k):
                pick = ((lambda a: a[s]) if k > 1 else (lambda a: a))
                losses.update(float(pick(vals["loss"])), bn)
                top1.update(float(pick(vals["top1"])), bn)
                top5.update(float(pick(vals["top5"])), bn)
                if "selection" in vals:
                    sel = pick(vals["selection"])
                    for mi, m in enumerate(modality):
                        selection[m].update(float(sel[mi]))
        pending.clear()

    def maybe_log(i):
        # the cadence follows the count of dispatched steps, not the loader
        # index: with K > 1 a dispatch lands on i = K-1 (mod K)
        nonlocal next_log
        if num_batch < next_log or rank != 0 or logger is None:
            return
        next_log = num_batch - (num_batch % display) + display
        drain()  # a sync, once every `display` steps
        # `Time` is the host's dispatch time per step (the card may still
        # be running); `Wall` the drained wall clock per batch so far
        wall = (time.time() - epoch_t0) / max(1, num_batch)
        sel_msg = " ".join(f"{m}:{v.avg * 100:.2f}"
                           for m, v in selection.items())
        logger.log(
            f"Epoch: [{epoch}][{i}/{len(loader)}]\t"
            f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
            f"Wall {wall:.3f}\t"
            f"Data {data_time.val:.3f} ({data_time.avg:.3f})\t"
            f"Loss {losses.val:.4f} ({losses.avg:.4f})\t"
            f"Prec@1 {top1.val:.3f} ({top1.avg:.3f})\t"
            f"Prec@5 {top5.val:.3f} ({top5.avg:.3f})\t"
            + (f"Selection: {sel_msg}" if sel_msg else ""))

    use_multi = (adamml and multi_step_fn is not None
                 and steps_per_dispatch > 1)
    acc = []  # preprocessed (inputs, target) awaiting a full dispatch

    def flush():
        nonlocal num_batch, end
        if not acc:
            return
        if len(acc) == steps_per_dispatch:
            stacked = [torch.stack([a[0][mi] for a in acc])
                       for mi in range(len(acc[0][0]))]
            targets = torch.stack([a[1] for a in acc])
            metrics = multi_step_fn(state, stacked, targets, lr, p_lr, cw,
                                    seed)
            pending.append((int(acc[0][1].shape[0]), metrics, len(acc)))
        else:  # the epoch's tail: single steps
            for inputs, target in acc:
                metrics = step_fn(state, inputs, target, lr, p_lr, cw, seed)
                pending.append((int(target.shape[0]), metrics, 1))
        num_batch += len(acc)
        dt = (time.time() - end) / len(acc)
        for _ in acc:
            batch_time.update(dt)
        acc.clear()
        end = time.time()

    for i, host_batch in enumerate(loader):
        data_time.update(time.time() - data_mark)
        if profiler is not None:
            profiler.step(i)
        inputs, target = preprocess(host_batch)
        if use_multi:
            acc.append((inputs, target))
            if len(acc) == steps_per_dispatch:
                flush()
                maybe_log(i)
            data_mark = time.time()
            continue
        n = int(target.shape[0])
        if adamml:
            metrics = step_fn(state, inputs, target, lr, p_lr, cw, seed)
        else:
            metrics = step_fn(state, inputs, target, lr, seed)
        pending.append((n, metrics, 1))
        batch_time.update(time.time() - end)
        end = data_mark = time.time()
        num_batch += 1
        maybe_log(i)
    flush()
    drain()

    # wall_time is the drained per-batch time (dispatch + device completion
    # + data), batch_time the host's dispatch time alone
    wall_time = (time.time() - epoch_t0) / max(1, num_batch)
    summary = {"top1": top1.avg, "top5": top5.avg, "loss": losses.avg,
               "batch_time": batch_time.avg, "data_time": data_time.avg,
               "wall_time": wall_time, "num_batch": num_batch,
               "selection": {m: v.avg for m, v in selection.items()}}
    return state, summary


def capacity_dropped(selections: Sequence[np.ndarray], num_modality: int,
                     eval_capacity: float, capacity_groups: int
                     ) -> np.ndarray:
    """(M,) selected segments that eval-capacity packing did not run: per
    batch of raw (n, S, M) decisions, the blocks and the ``cap`` formula of
    models/joint_net.py (G contiguous blocks of the clip-major n*S rows,
    G = capacity_groups when it divides them, else 1; cap = max(1,
    round(c * rows per block))), and per block and modality the selections
    beyond cap. Exact for one crop; under multi-crop eval the stored
    decisions are the canonical crop's, so the count is that crop's."""
    dropped = np.zeros((num_modality,), np.int64)
    for dec in selections:
        rows = dec.shape[0] * dec.shape[1]
        if rows == 0:
            continue
        g = (capacity_groups if capacity_groups > 1
             and rows % capacity_groups == 0 else 1)
        rl = rows // g
        cap = max(1, int(round(eval_capacity * rl)))
        picked = np.asarray(dec).reshape(g, rl, -1).sum(axis=1)  # (G, M)
        dropped += np.maximum(0, picked - cap).sum(axis=0).astype(np.int64)
    return dropped


def validate(loader, preprocess: Callable, eval_step: Callable, state,
             *, seed: int = 1, modality: Optional[Sequence[str]] = None,
             adamml: bool = True, num_segments: int = 10,
             eval_capacity: Optional[float] = None,
             capacity_groups: int = 1):
    """Full validation pass. Returns a summary dict including the gathered
    outputs / selections (reference validate_adamml contract,
    utils/utils.py:427-507) and, with ``eval_capacity`` below 1, the
    selected segments that packing did not run (``capacity_dropped``, per
    modality)."""
    batch_time, losses = AverageMeter(), AverageMeter()
    modality = list(modality or [])
    selection = {m: AverageMeter() for m in modality}

    # left on the device until one bulk fetch after the last batch
    dev_logits: List[torch.Tensor] = []
    dev_targets: List[torch.Tensor] = []
    dev_selections: List[torch.Tensor] = []
    dev_losses: List[torch.Tensor] = []
    end = time.time()
    for bi, host_batch in enumerate(loader):
        inputs, target = preprocess(host_batch)
        # fresh Gumbel noise per batch: the reference samples new noise
        # every forward (F.gumbel_softmax under model.eval()); the step
        # counter is frozen during eval, so the batch index enters the seed
        bseed = step_seed(seed, bi)
        if adamml:
            logits, decisions, loss = eval_step(state, inputs, target, bseed)
            dev_selections.append(decisions)
        else:
            logits, loss = eval_step(state, inputs, target, bseed)
        dev_losses.append(loss)
        dev_logits.append(logits)
        dev_targets.append(target)
        batch_time.update(time.time() - end)
        end = time.time()

    all_logits = _fetch(_gathered(dev_logits))
    all_targets = _fetch(_gathered(dev_targets))
    all_selections = _fetch(_gathered(dev_selections))
    batch_losses = _fetch(_gathered(dev_losses))

    dropped = None
    if (adamml and eval_capacity is not None and eval_capacity < 1.0
            and all_selections):
        # counted on the raw decisions, padded tail rows included: the
        # model packs the rows it was given
        dropped = capacity_dropped(all_selections, len(modality),
                                   eval_capacity, capacity_groups)

    # Padded-tail masking: the loader pads the ragged final batch with
    # wrapped real samples so every eval batch has one shape; those rows
    # must not count.
    masks = getattr(loader, "global_valid_masks", lambda: None)()
    # dataset index of every batch row, to restore val-list row order (the
    # rows are shard-interleaved when the loader has several shards)
    row_idx = getattr(loader, "global_row_indices", lambda: None)()
    if row_idx is not None:
        row_idx = [np.asarray(ix)[: lg.shape[0]]
                   for ix, lg in zip(row_idx, all_logits)]
    if masks is not None:
        masks = [np.asarray(mk)[: lg.shape[0]]
                 for mk, lg in zip(masks, all_logits)]
        for lg, tg, mk, loss in zip(all_logits, all_targets, masks,
                                    batch_losses):
            if mk.all():  # the device's value when nothing was padded
                losses.update(float(loss), int(mk.sum()))
            elif mk.any():  # re-score the real rows only, on the host
                losses.update(_host_cross_entropy(lg[mk], tg[mk]),
                              int(mk.sum()))
        all_logits = [lg[mk] for lg, mk in zip(all_logits, masks)]
        all_targets = [tg[mk] for tg, mk in zip(all_targets, masks)]
        all_selections = [sl[mk] for sl, mk in zip(all_selections, masks)]
        if row_idx is not None:
            row_idx = [ix[mk] for ix, mk in zip(row_idx, masks)]
    else:
        for lg, loss in zip(all_logits, batch_losses):
            losses.update(float(loss), lg.shape[0])
    for dec in all_selections:
        if dec.shape[0] == 0:
            continue
        sel = dec.mean(axis=(0, 1))
        for mi, m in enumerate(modality):
            selection[m].update(float(sel[mi]))

    logits = np.concatenate(all_logits, axis=0)
    targets = np.concatenate(all_targets, axis=0)
    selections = (np.concatenate(all_selections, axis=0) if all_selections
                  else None)

    # restore val-list row order; metrics are order-invariant but the
    # returned and saved matrices are not
    if row_idx is not None and logits.shape[0]:
        idx_all = np.concatenate(row_idx, axis=0)
        if idx_all.shape[0] == logits.shape[0] and np.any(np.diff(idx_all) < 0):
            perm = np.argsort(idx_all, kind="stable")
            logits = logits[perm]
            targets = targets[perm]
            if selections is not None:
                selections = selections[perm]
    (t1, t5), mAP = actnet_acc(logits, targets)

    out = {"top1": t1, "top5": t5, "mAP": mAP, "loss": losses.avg,
           "batch_time": batch_time.avg, "outputs": logits,
           "selection": {m: v.avg for m, v in selection.items()}}
    if adamml:
        out["all_selections"] = selections
        out["flops"] = flops_computation(
            modality, {m: v.avg for m, v in selection.items()}, num_segments)
        if dropped is not None:
            out["capacity_dropped"] = {
                m: int(dropped[mi]) for mi, m in enumerate(modality)}
    return out
