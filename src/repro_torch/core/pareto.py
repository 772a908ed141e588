"""Pareto utilities + hypervolume for the 2-objective (maximize throughput,
minimize power) setting. Internally we work in 'maximize both' space by
negating power.

The port's own copy of `repro.core.pareto`
(imports rewritten; the port imports nothing of `repro`).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def pareto_mask(points: np.ndarray) -> np.ndarray:
    """points (N, 2) in maximize-maximize space -> boolean mask of the front."""
    n = len(points)
    mask = np.ones(n, bool)
    for i in range(n):
        if not mask[i]:
            continue
        dominated = np.all(points >= points[i], axis=1) & np.any(
            points > points[i], axis=1)
        if dominated.any():
            mask[i] = False
            continue
        dominates = np.all(points[i] >= points, axis=1) & np.any(
            points[i] > points, axis=1)
        mask[dominates] = False
        mask[i] = True
    return mask


def pareto_front(points: np.ndarray) -> np.ndarray:
    pts = np.asarray(points, float)
    return pts[pareto_mask(pts)]


def hypervolume_2d(points: np.ndarray, ref: Sequence[float]) -> float:
    """Exact 2-D hypervolume wrt reference point (maximize-maximize).
    Paper §VII: ref = (throughput 0, -peak power)."""
    pts = np.asarray(points, float)
    if len(pts) == 0:
        return 0.0
    pts = pts[(pts[:, 0] > ref[0]) & (pts[:, 1] > ref[1])]
    if len(pts) == 0:
        return 0.0
    front = pareto_front(pts)
    order = np.argsort(-front[:, 0])
    front = front[order]
    hv = 0.0
    prev_y = ref[1]
    for x, y in front:
        if y > prev_y:
            hv += (x - ref[0]) * (y - prev_y)
            prev_y = y
    return float(hv)


def to_max_space(throughput: np.ndarray, power: np.ndarray) -> np.ndarray:
    return np.stack([np.asarray(throughput, float),
                     -np.asarray(power, float)], axis=1)
