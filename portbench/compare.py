"""The numbers that decide ``correct``: each a gap between what the port
produced and what the plain reference works out from the same inputs, held
against the limit the cell's ``workloads/<cell>.json`` gives it.

A training cell's readings (``TrainReadings``) are each step's losses, the
norm of every leaf's gradient at each compared step, as Adam got it, and
the norm of every leaf's change after the compared steps. Gaps of norms are taken leaf by leaf and the worst
leaf is reported, each measured against the larger of that leaf's reference
norm and the median leaf's (some gradients are all but zero).
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

GRAD_FLOOR = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's moves by round-off alone


@dataclasses.dataclass
class TrainReadings:
    losses: List[Tuple[float, float]]  # (g_loss, d_loss) of each compared step
    grads: List[Dict[str, float]]  # each compared step: leaf → norm of its gradient ("g." / "d." prefixed)
    changes: Dict[str, float]  # leaf → norm of its change over the compared steps
    step_changes: List[Dict[str, float]]  # each compared step after the first: leaf → norm of its change in it


def grads_from_moments(sums: Sequence[Dict[str, float]], beta2: float) -> List[Dict[str, float]]:
    """Each step's gradient norm of every leaf, from the sums of Adam's
    second moment after each step: v_t = β2·v_{t−1} + (1 − β2)·g_t², so
    ‖g_t‖² = (Σv_t − β2·Σv_{t−1}) / (1 − β2). A step that left the moment
    unchanged reads a gradient far from the one it was given."""
    out: List[Dict[str, float]] = []
    prev: Dict[str, float] = {}
    for s in sums:
        out.append({k: math.sqrt(max(v - beta2 * prev.get(k, 0.0), 0.0) / (1.0 - beta2)) for k, v in s.items()})
        prev = s
    return out


def loss_gap(prog: TrainReadings, ref: TrainReadings, steps: Optional[int] = None) -> float:
    """The widest relative gap of a G or D loss over the first ``steps``
    compared steps (all of them by default)."""
    pairs = list(zip(prog.losses, ref.losses))[:steps]
    gaps = [abs(p - r) / max(abs(r), 1e-12) for ps, rs in pairs for p, r in zip(ps, rs)]
    if len(prog.losses) != len(ref.losses) or not all(math.isfinite(g) for g in gaps):
        return math.inf
    return max(gaps)


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves: Sequence[str]) -> List[float]:
    """Each leaf's gap of norms, against the larger of its reference norm
    and the median leaf's."""
    median = statistics.median(ref[k] for k in leaves)
    gaps = [abs(prog.get(k, math.nan) - ref[k]) / max(ref[k], median, 1e-30) for k in leaves]
    return [g if math.isfinite(g) else math.inf for g in gaps]


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float], leaves: Sequence[str]) -> float:
    return max(_leaf_gaps(prog, ref, leaves)) if leaves else math.inf


def _median_leaf(prog: Dict[str, float], ref: Dict[str, float], leaves: Sequence[str]) -> float:
    return statistics.median(_leaf_gaps(prog, ref, leaves)) if leaves else math.inf


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float], leaves: Sequence[str], top: int = 3) -> List[tuple]:
    """The leaves with the widest gaps: (leaf, gap, program's norm, reference's norm)."""
    median = statistics.median(ref[k] for k in leaves) if leaves else 0.0
    rows = [(k, abs(prog.get(k, math.nan) - ref[k]) / max(ref[k], median, 1e-30), prog.get(k, math.nan), ref[k])
            for k in leaves]
    return sorted(rows, key=lambda row: -row[1] if math.isfinite(row[1]) else -math.inf)[:top]


def _nets(leaves) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for k in leaves:
        out.setdefault(k.split(".", 1)[0], []).append(k)
    return out


def grad_gap(prog: TrainReadings, ref: TrainReadings, pick=_worst_leaf, step: int = 0) -> float:
    """The worst (or, with ``pick=_median_leaf``, the median) leaf's gap of
    gradient norms at compared step ``step`` (the first by default), G's
    and D's leaves each against their own network's median, the wider of
    the two networks."""
    if len(prog.grads) != len(ref.grads):
        return math.inf
    return max(pick(prog.grads[step], ref.grads[step], ks) for ks in _nets(ref.grads[step]).values())


def later_grad_gap(prog: TrainReadings, ref: TrainReadings) -> float:
    """The median leaf's gap of gradient norms at each compared step after
    the first (every variant of the mix among them), the widest step."""
    if len(prog.grads) != len(ref.grads):
        return math.inf
    return max((grad_gap(prog, ref, _median_leaf, i) for i in range(1, len(ref.grads))), default=0.0)


def step_grad_gaps(prog: TrainReadings, ref: TrainReadings) -> List[float]:
    """The median leaf's gap of gradient norms at each compared step."""
    if len(prog.grads) != len(ref.grads):
        return [math.inf]
    return [grad_gap(prog, ref, _median_leaf, i) for i in range(len(ref.grads))]


def moving_leaves(ref: TrainReadings) -> List[str]:
    """The leaves whose change is compared: every parameter whose reference
    gradient is at least ``GRAD_FLOOR`` of its network's median leaf's, and
    every leaf without a gradient (the w averages, their EMA)."""
    keep = []
    first = ref.grads[0]
    medians = {net: statistics.median(first[k] for k in ks) for net, ks in _nets(first).items()}
    for k in ref.changes:
        if k in first:
            if first[k] >= GRAD_FLOOR * medians[k.split(".", 1)[0]]:
                keep.append(k)
        else:
            keep.append(k)
    return keep


def change_gap(prog: TrainReadings, ref: TrainReadings, pick=_worst_leaf) -> float:
    """The worst (or median) moving leaf's gap of change norms over the
    compared steps, against the median moving leaf of its network."""
    keep = moving_leaves(ref)
    return max(pick(prog.changes, ref.changes, ks) for ks in _nets(keep).values())


def step_change_gaps(prog: TrainReadings, ref: TrainReadings) -> List[float]:
    """The median moving leaf's gap of the change each compared step after
    the first made, G's and D's leaves apart, the wider network: a step
    that skips its update, or takes it at another rate, reads up to 1."""
    if len(prog.step_changes) != len(ref.step_changes):
        return [math.inf]
    keep = moving_leaves(ref)
    return [max((_median_leaf(p, r, ks) for ks in _nets([k for k in keep if k in r]).values()), default=0.0)
            for p, r in zip(prog.step_changes, ref.step_changes)]


def later_change_gap(prog: TrainReadings, ref: TrainReadings) -> float:
    """The widest of ``step_change_gaps`` (the first step moves every
    element by ±lr and is left to ``change_gap``)."""
    return max(step_change_gaps(prog, ref), default=0.0)


def train_gaps(prog: TrainReadings, ref: TrainReadings) -> Dict[str, float]:
    """Every number a training cell reads; its limits say which it compares."""
    return {"loss1_gap": loss_gap(prog, ref, 1), "loss_gap": loss_gap(prog, ref),
            "grad_gap": grad_gap(prog, ref), "grad_median_gap": grad_gap(prog, ref, _median_leaf),
            "later_grad_median_gap": later_grad_gap(prog, ref), "later_change_median_gap": later_change_gap(prog, ref),
            "change_gap": change_gap(prog, ref), "change_median_gap": change_gap(prog, ref, _median_leaf)}


def train_worst(prog: TrainReadings, ref: TrainReadings) -> Dict[str, list]:
    """The widest leaves of the gradient and change gaps, network by network."""
    out = {}
    for net, ks in _nets(ref.grads[0]).items():
        out[f"grad.{net}"] = worst_leaves(prog.grads[0], ref.grads[0], ks)
    for net, ks in _nets(moving_leaves(ref)).items():
        out[f"change.{net}"] = worst_leaves(prog.changes, ref.changes, ks)
    return out


def view_gap(prog: Sequence[Dict[str, np.ndarray]], ref: Sequence[Dict[str, np.ndarray]]) -> float:
    """The widest gap of a view's value ([-1, 1]) over the compared batches."""
    if len(prog) != len(ref):
        return math.inf
    worst = 0.0
    for p, r in zip(prog, ref):
        for k in r:
            if k not in p or p[k].shape != r[k].shape:
                return math.inf
            worst = max(worst, float(np.abs(p[k].astype(np.float64) - r[k]).max()))
    return worst


def image_gaps(prog: Sequence[np.ndarray], ref: Sequence[np.ndarray]) -> Dict[str, float]:
    """The widest gap of a generated pixel ([0, 1]) and the root mean square
    of the gaps, over the compared batches."""
    if not ref or len(prog) != len(ref) or any(p.shape != r.shape for p, r in zip(prog, ref)):
        return {"image_max_gap": math.inf, "image_rms_gap": math.inf}
    d = np.concatenate([(p.astype(np.float64) - r).reshape(-1) for p, r in zip(prog, ref)])
    if not np.isfinite(d).all():
        return {"image_max_gap": math.inf, "image_rms_gap": math.inf}
    return {"image_max_gap": float(np.abs(d).max()), "image_rms_gap": float(np.sqrt(np.mean(d * d)))}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(every limited value within its limit, {name: {"value", "limit"}}).
    A limit without a value fails; a value without a limit is read and not
    compared."""
    compared = {}
    ok = True
    for name in sorted(limits):
        v, lim = values.get(name, math.inf), limits[name]
        compared[name] = {"value": v, "limit": lim}
        ok = ok and math.isfinite(v) and v <= lim
    return ok, compared

