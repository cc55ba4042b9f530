"""The numbers that decide ``correct``: each a gap between what the timed
path produced and what the plain reference works out from the same inputs,
held to a limit of its own (the traffic file's ``limits``; how each limit
was set is in PERF.md).

Gaps of norms are taken leaf by leaf, as the gap between the program's
norm and the reference's, over the reference's norm of that leaf or the
median leaf's, whichever is larger (some leaves are all but zero). A
``worst`` number is the largest such gap over the leaves, a ``median``
number their median, and a ``stage`` number the largest of the medians
over each ResNet stage's leaves and over the leaves of no stage: a fault
confined to one stage, as a wrong backward at one of the epilogue
kernels' stages, moves that stage's median where it moves no median over
all leaves.
"""

from __future__ import annotations

import re
import statistics
from typing import Dict, Iterable, List, Optional, Tuple

# a leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone (a BN bias that another train-mode BN follows)
ROUNDOFF_SHARE = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names: Optional[Iterable[str]] = None) -> List[float]:
    names = list(ref if names is None else names)
    med = statistics.median(ref[k] for k in names)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names]


# a ResNet stage's leaves: <net>.layer<stage>_<block>.<...>
STAGE = re.compile(r"^(.*\.layer\d+)_\d+\.")


def stage_of(name: str) -> str:
    m = STAGE.match(name)
    return m.group(1) if m else "other"


def stage_median(gaps: List[float], names: List[str]) -> float:
    """The largest median of the gaps over one stage's leaves."""
    by: Dict[str, List[float]] = {}
    for g, n in zip(gaps, names):
        by.setdefault(stage_of(n), []).append(g)
    return max(statistics.median(v) for v in by.values())


def counted_leaves(ref_grad: Dict[str, float]) -> List[str]:
    """Leaves whose change is compared: those with a reference gradient
    above ROUNDOFF_SHARE of the median leaf's."""
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= ROUNDOFF_SHARE * med]


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float],
                 names=None, k: int = 5) -> List[list]:
    """The k leaves with the largest gaps: [name, gap, program's norm,
    reference's norm], with the median leaf's reference norm first."""
    names = list(ref if names is None else names)
    gaps = leaf_gaps(prog, ref, names)
    top = sorted(zip(gaps, names), reverse=True)[:k]
    return [["median", statistics.median(ref[n] for n in names)]] + [
        [n, g, prog[n], ref[n]] for g, n in top]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog, ref: {"loss": [per step], "grad": {leaf: norm of the first
    gradient as the update takes it}, "update": {leaf: norm of the change
    after the compared steps}, "var": {BN running variance: norm of its
    change}}."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    counted = counted_leaves(ref["grad"])
    grad = leaf_gaps(prog["grad"], ref["grad"])
    upd = leaf_gaps(prog["update"], ref["update"], counted)
    var = leaf_gaps(prog["var"], ref["var"])
    return {"loss": max(losses), "loss_step1": losses[0],
            "grad_worst": max(grad), "grad_median": statistics.median(grad),
            "grad_stage": stage_median(grad, list(ref["grad"])),
            "update_worst": max(upd),
            "update_median": statistics.median(upd),
            "update_stage": stage_median(upd, counted),
            "var_worst": max(var), "var_median": statistics.median(var),
            "leaves_left_out": float(len(ref["grad"]) - len(counted))}


def serve_numbers(prog: List[Tuple], ref: List[Tuple]) -> Dict[str, float]:
    """prog, ref: per checked request (logits (N, K), decisions (N, S, M))
    as numpy arrays. ``decisions``: the share of decisions that differ;
    ``logits``: over the clips whose decisions all agree, the largest gap
    of a logit, over the request's largest reference logit."""
    differ = total = 0
    worst = 0.0
    for (lp, dp), (lr, dr) in zip(prog, ref):
        same = (dp == dr)
        differ += int((~same).sum())
        total += same.size
        agree = same.reshape(same.shape[0], -1).all(1)
        if agree.any():
            gap = abs(lp[agree] - lr[agree]).max()
            worst = max(worst, float(gap / max(abs(lr).max(), 1e-30)))
        else:
            worst = float("nan")     # a request with no clip to judge
    return {"decisions": differ / total, "logits": worst}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, list]]:
    """(every compared number within its limit, {name: [value, limit]})."""
    compared = {k: [numbers[k], lim] for k, lim in limits.items()}
    ok = all(v == v and v <= lim for v, lim in compared.values())
    return ok, compared
