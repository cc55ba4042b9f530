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
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

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
    """Device tensors to numpy with one transfer: concatenated along the
    first axis (0-d tensors as rows) and split back."""
    if not tensors:
        return []
    rows = [t.reshape((1,) + tuple(t.shape)) if t.dim() == 0 else t
            for t in tensors]
    flat = torch.cat([r.detach().float() if r.dtype == torch.bfloat16
                      else r.detach() for r in rows]).cpu().numpy()
    out, at = [], 0
    for t, r in zip(tensors, rows):
        piece = flat[at:at + r.shape[0]]
        out.append(piece[0] if t.dim() == 0 else piece)
        at += r.shape[0]
    return out


def train_epoch(loader, preprocess: Callable, step_fn: Callable, state,
                *, lr: float, p_lr: float = 0.0,
                cost_weights: Optional[Sequence[float]] = None,
                seed: int = 0, epoch: int = 0,
                modality: Optional[Sequence[str]] = None,
                adamml: bool = True, display: int = 100, rank: int = 0,
                logger=None):
    """One training epoch. Returns (state, summary dict). ``step_fn`` is
    step(state, inputs, target, lr, p_lr, cost_weights, seed) (AdaMML) or
    step(state, inputs, target, lr, seed) (unimodal) returning device
    metrics; it updates ``state`` in place."""
    batch_time, data_time = AverageMeter(), AverageMeter()
    losses, top1, top5 = AverageMeter(), AverageMeter(), AverageMeter()
    modality = list(modality or [])
    selection = {m: AverageMeter() for m in modality}
    loader.set_epoch(epoch)
    cw = list(cost_weights if cost_weights is not None
              else [0.0] * max(1, len(modality)))

    pending = []  # (batch size, device metrics)
    end = time.time()
    epoch_t0 = end
    num_batch = 0
    next_log = 0  # step count at which the next display line is due

    def drain():
        keys = ["loss", "top1", "top5"] + (
            ["selection"] if adamml and modality else [])
        got = _fetch([dm[k] for _, dm in pending for k in keys])
        for j, (bn, _) in enumerate(pending):
            vals = dict(zip(keys, got[j * len(keys):(j + 1) * len(keys)]))
            losses.update(float(vals["loss"]), bn)
            top1.update(float(vals["top1"]), bn)
            top5.update(float(vals["top5"]), bn)
            if "selection" in vals:
                for mi, m in enumerate(modality):
                    selection[m].update(float(vals["selection"][mi]))
        pending.clear()

    def maybe_log(i):
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

    for i, host_batch in enumerate(loader):
        data_time.update(time.time() - end)
        inputs, target = preprocess(host_batch)
        n = int(target.shape[0])
        if adamml:
            metrics = step_fn(state, inputs, target, lr, p_lr, cw, seed)
        else:
            metrics = step_fn(state, inputs, target, lr, seed)
        pending.append((n, metrics))
        batch_time.update(time.time() - end)
        end = time.time()
        num_batch += 1
        maybe_log(i)
    drain()

    # wall_time is the drained per-batch time (dispatch + device completion
    # + data), batch_time the host's dispatch time alone
    wall_time = (time.time() - epoch_t0) / max(1, num_batch)
    summary = {"top1": top1.avg, "top5": top5.avg, "loss": losses.avg,
               "batch_time": batch_time.avg, "data_time": data_time.avg,
               "wall_time": wall_time, "num_batch": num_batch,
               "selection": {m: v.avg for m, v in selection.items()}}
    return state, summary


def validate(loader, preprocess: Callable, eval_step: Callable, state,
             *, seed: int = 1, modality: Optional[Sequence[str]] = None,
             adamml: bool = True, num_segments: int = 10):
    """Full validation pass. Returns a summary dict including the gathered
    outputs / selections (reference validate_adamml contract,
    utils/utils.py:427-507)."""
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

    all_logits = _fetch(dev_logits)
    all_targets = _fetch(dev_targets)
    all_selections = _fetch(dev_selections)
    batch_losses = _fetch(dev_losses)

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
    return out
