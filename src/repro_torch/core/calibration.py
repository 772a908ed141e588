"""Online GNN calibration — active learning at the f1 -> f0 handover.

The paper trains the f0 congestion model offline on simulator traces
(§VI-C) and MFMOBO then trusts it for the bulk of the budget. A fixed
checkpoint is only as good as its training distribution, so this module
closes the loop: right before `run_mfmobo` evaluates its first GNN-fidelity
point (`on_handover` — fired ahead of the f0 prior batch, so no recorded
f0 objective ever comes from uncalibrated params), the calibrator

  1. picks the Pareto neighborhood of everything evaluated so far —
     the nondominated designs first, then the points closest to the front
     in (log throughput, -log power) space, which is exactly the region the
     remaining f0 evaluations will explore;
  2. compiles representative chunks for those designs, featurizes their
     transfers, and runs the cycle-approximate simulator for ground-truth
     per-link waiting times (`featurize_transfer(with_target=True)`);
  3. fine-tunes the current GNN parameters on those traces with a held-out
     validation split, early-stopping on validation loss (`train_gnn`'s
     patience machinery).

The calibrator's objective function reads `self.params` at call time, so
the fine-tuned parameters take effect for every f0 evaluation after the
handover — and the evaluator's params-version token gives the new pytree
its own cache namespace automatically.

The port's own copy of `repro.core.calibration` (imports rewritten). It
fine-tunes with the port's torch `train_gnn`, on the device the params live
on (the campaign's device), and its f0 objective scores on that device too.
CPU parity: tests/test_torch_gnn.py.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.compiler import compile_chunk
from repro_torch.core.design_space import WSCDesign
from repro_torch.core.noc_gnn import (
    LinkGraph,
    TrainHistory,
    featurize_transfer,
    params_device,
    train_gnn,
)
from repro_torch.core.pareto import pareto_front, to_max_space
from repro_torch.core.workload import LLMWorkload

# representative (tp, mb_tokens) compilations per selected design — the same
# operating points the offline corpus uses (benchmarks.common.trained_gnn),
# so fine-tuning shifts the design distribution, not the task
CALIBRATION_POINTS: Tuple[Tuple[int, int], ...] = ((16, 4096), (64, 1024))


def pareto_neighborhood(designs: Sequence[WSCDesign],
                        ys: Sequence[Tuple[float, float]],
                        k: int) -> List[WSCDesign]:
    """Up to k distinct designs: the nondominated set first, then the
    closest dominated points to the front (Euclidean, objectives
    standardized in max-space)."""
    if not designs:
        return []
    t = np.array([y[0] for y in ys], np.float64)
    p = np.array([y[1] for y in ys], np.float64)
    pts = to_max_space(t, p)
    scale = np.maximum(pts.max(axis=0) - pts.min(axis=0), 1e-9)
    norm = (pts - pts.min(axis=0)) / scale
    front = pareto_front(pts)
    on_front = np.array([any(np.allclose(pt, f) for f in front)
                         for pt in pts])
    if front.size:
        fnorm = (front - pts.min(axis=0)) / scale
        dist = np.min(np.linalg.norm(norm[:, None, :] - fnorm[None, :, :],
                                     axis=-1), axis=1)
    else:
        dist = np.zeros(len(pts))
    order = np.lexsort((dist, ~on_front))    # front members first, then near
    picked: List[WSCDesign] = []
    seen = set()
    for i in order:
        d = designs[i]
        if d in seen:
            continue
        seen.add(d)
        picked.append(d)
        if len(picked) >= k:
            break
    return picked


def build_calibration_set(designs: Sequence[WSCDesign], wl: LLMWorkload,
                          points: Sequence[Tuple[int, int]] =
                          CALIBRATION_POINTS,
                          cores_per_chunk: int = 64) -> List[LinkGraph]:
    """Simulator-labeled transfer graphs for the selected designs."""
    dataset: List[LinkGraph] = []
    for d in designs:
        for tp, mbt in points:
            g = compile_chunk(d, wl, tp=tp, mb_tokens=mbt,
                              cores_per_chunk=cores_per_chunk)
            for t in range(len(g.transfers)):
                if g.transfers[t].pairs:
                    dataset.append(
                        featurize_transfer(g, d, t, with_target=True))
    return dataset


@dataclasses.dataclass
class CalibrationRecord:
    n_designs: int
    n_graphs: int
    train_s: float
    history: TrainHistory


class GNNCalibrator:
    """Holds the live GNN parameters for the f0 objective and fine-tunes
    them at the fidelity handover. Use:

        cal = GNNCalibrator(params, wl)
        tr = run_mfmobo(cal.objectives(), f1, on_handover=cal.on_handover)
    """

    def __init__(self, params: Dict, wl: LLMWorkload, *,
                 n_designs: int = 6, epochs: int = 20, lr: float = 1e-3,
                 val_frac: float = 0.25, patience: Optional[int] = 5,
                 seed: int = 0):
        self.params = params
        self.wl = wl
        self.n_designs = n_designs
        self.epochs = epochs
        self.lr = lr
        self.val_frac = val_frac
        self.patience = patience
        self.seed = seed
        self.records: List[CalibrationRecord] = []

    def objectives(self):
        """Batch-aware f0 objective reading the latest calibrated params —
        an `EvaluatorObjective` whose `params_fn` dereferences this
        calibrator at call time, so post-handover evaluations automatically
        use the fine-tuned pytree (and its fresh cache namespace)."""
        from repro_torch.core.fidelity import GNNBackend
        from repro_torch.explore.objectives import EvaluatorObjective
        return EvaluatorObjective(
            self.wl, GNNBackend(device=params_device(self.params)),
            params_fn=lambda: self.params)

    def on_handover(self, designs: Sequence[WSCDesign],
                    ys: Sequence[Tuple[float, float]]) -> None:
        picked = pareto_neighborhood(designs, ys, self.n_designs)
        if not picked:
            return
        dataset = build_calibration_set(picked, self.wl)
        if not dataset:
            return
        t0 = time.time()
        self.params, hist = train_gnn(
            self.params, dataset, epochs=self.epochs, lr=self.lr,
            seed=self.seed, val_frac=self.val_frac, patience=self.patience)
        self.records.append(CalibrationRecord(
            n_designs=len(picked), n_graphs=len(dataset),
            train_s=time.time() - t0, history=hist))
