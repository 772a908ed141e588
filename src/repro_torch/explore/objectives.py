"""Objectives protocol for DSE campaigns (DESIGN.md §9).

A campaign's objective pair and constraint set are *data* — `ObjectiveSpec`
(metric name, direction, GP/HV-space transform) and `ConstraintSpec`
(metric, op, bound) serialize with the rest of a `CampaignSpec` — and the
`Objective` classes here are the batch-aware adapters that turn those specs
into the callable the exploration loop evaluates. They subsume the old
free-function objective builders (`evaluator.batched_objectives`,
`serving.serving_objectives`, `GNNCalibrator.objectives()`), which are now
thin constructors delegating here.

The exploration loop (repro_torch.explore.runner) operates on the `Objective`
protocol only: `eval_many(designs) -> [(y0, y1), ...]`. Legacy callables —
scalar ``f(design) -> (t, p)`` functions and ``.batched``-marked batch
functions — are coerced at the boundary by `as_objective`; the attribute
sniffing that used to live in `mfmobo._eval_many` is retired to that single
compat shim. Every `Objective` still *exposes* ``batched = True`` so older
external sniffers keep working.

Constraint semantics: a candidate whose metrics violate any constraint (or
whose evaluation is infeasible) maps to the penalty point — by default
``(0.0, WAFER_POWER_W)``, the same infeasibility point the evaluators
always used — so it can never enter the Pareto front, while still being
recorded in the trace. Violation/infeasibility counts are tracked on the
objective for campaign reporting.

The port's copy of `repro.explore.objectives`. The serving, hetero and
trace objectives score through the port's copies of `core.serving`,
`core.heterogeneity` and `core.traces`, on the device of the fidelity
backend they are given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import components as C
from repro_torch.core.design_space import WSCDesign
from repro_torch.core.fidelity import FidelityBackend, get_backend
from repro_torch.core.workload import LLMWorkload

DIRECTIONS = ("max", "min")
# GP/HV-space transforms the trace operates in (mfmobo.obj_space): the
# maximized objective is log1p-compressed, the minimized one is -log
# (paper: log throughput vs -log power). "identity" is accepted for
# synthetic objectives already living in max-space.
TRANSFORMS = ("log1p", "neg_log", "identity")


@dataclasses.dataclass(frozen=True)
class ObjectiveSpec:
    """One objective: which metric, which direction, which HV-space
    transform. A campaign's pair is conventionally (max, min) — throughput
    vs power, goodput vs power — matching the paper's hypervolume setup."""
    name: str
    direction: str = "max"
    transform: str = "log1p"

    def __post_init__(self):
        if self.direction not in DIRECTIONS:
            raise ValueError(f"objective direction {self.direction!r} "
                             f"not in {DIRECTIONS}")
        if self.transform not in TRANSFORMS:
            raise ValueError(f"objective transform {self.transform!r} "
                             f"not in {TRANSFORMS}")

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Union[Dict, Sequence]) -> "ObjectiveSpec":
        if isinstance(d, (list, tuple)):              # ["throughput", "max"]
            return cls(*d)
        return cls(**d)


_OPS: Dict[str, Callable[[float, float], bool]] = {
    "<=": lambda v, b: v <= b,
    ">=": lambda v, b: v >= b,
}


@dataclasses.dataclass(frozen=True)
class ConstraintSpec:
    """A hard constraint on an evaluation metric: SLO bound, power cap,
    area budget. Violating candidates are mapped to the penalty point so
    they are excluded from the Pareto front."""
    metric: str
    op: str
    bound: float

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"constraint op {self.op!r} not in "
                             f"{tuple(_OPS)}")

    def ok(self, metrics: Dict[str, float]) -> bool:
        v = metrics.get(self.metric)
        if v is None:
            raise KeyError(
                f"constraint metric {self.metric!r} not produced by this "
                f"objective; available: {sorted(metrics)}")
        return bool(_OPS[self.op](float(v), float(self.bound)))

    def describe(self) -> str:
        return f"{self.metric} {self.op} {self.bound:g}"

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Union[Dict, Sequence]) -> "ConstraintSpec":
        if isinstance(d, (list, tuple)):              # ["ttft", "<=", 5.0]
            m, op, b = d
            return cls(str(m), str(op), float(b))
        return cls(**d)


def default_objectives(scenario: str) -> Tuple[ObjectiveSpec, ObjectiveSpec]:
    if scenario == "trace_serving":
        # spike robustness: worst load window's interactive-tenant goodput
        y0 = "worst_window_goodput"
    elif scenario in ("serving", "hetero"):
        y0 = "goodput"
    else:
        y0 = "throughput"
    return (ObjectiveSpec(y0, "max", "log1p"),
            ObjectiveSpec("power_per_wafer", "min", "neg_log"))


# ---------------------------------------------------------------------------
# the Objective protocol + adapters
# ---------------------------------------------------------------------------


PENALTY: Tuple[float, float] = (0.0, C.WAFER_POWER_W)


class Objective:
    """Batch-aware campaign objective. Subclasses implement
    `metrics(designs) -> List[Dict[str, float]]`; this base maps metric
    dicts to the (y0, y1) pairs the exploration loop consumes, applying
    constraints and the infeasibility penalty, and keeps running counters
    for campaign reporting."""

    batched = True            # legacy marker (pre-protocol sniffers)
    fidelity: Optional[str] = None

    def __init__(self, objectives: Optional[Sequence[ObjectiveSpec]] = None,
                 constraints: Sequence[ConstraintSpec] = (),
                 penalty: Tuple[float, float] = PENALTY,
                 scenario: str = "train"):
        specs = tuple(objectives) if objectives else \
            default_objectives(scenario)
        if len(specs) != 2:
            raise ValueError("exactly two objectives required "
                             f"(got {len(specs)})")
        if (specs[0].direction, specs[1].direction) != ("max", "min"):
            raise ValueError(
                "objective pair must be (max, min) — e.g. maximize "
                "throughput/goodput against minimized power (got "
                f"{specs[0].direction}, {specs[1].direction})")
        self.specs = specs
        self.constraints = tuple(constraints)
        self.penalty = (float(penalty[0]), float(penalty[1]))
        self.n_calls = 0
        self.n_evals = 0
        self.n_infeasible = 0
        self.n_violations = 0

    # -- subclass surface --------------------------------------------------

    def metrics(self, designs: List[WSCDesign]) -> List[Dict[str, float]]:
        raise NotImplementedError

    # -- protocol ----------------------------------------------------------

    def eval_many(self, designs: Sequence[WSCDesign]
                  ) -> List[Tuple[float, float]]:
        return self.fold_metrics(self.metrics(list(designs)))

    def fold_metrics(self, metrics: Sequence[Dict[str, float]]
                     ) -> List[Tuple[float, float]]:
        """Map metric dicts to (y0, y1) pairs — constraints, penalty,
        counters. Shared by `eval_many` and the fused evaluation path
        (which produces metric dicts from compiled-evaluator results
        without going through `metrics()`)."""
        out: List[Tuple[float, float]] = []
        for m in metrics:
            feasible = bool(m.get("feasible", True))
            if not feasible:
                self.n_infeasible += 1
                out.append(self.penalty)
                continue
            if not all(c.ok(m) for c in self.constraints):
                self.n_violations += 1
                out.append(self.penalty)
                continue
            y = (float(m[self.specs[0].name]), float(m[self.specs[1].name]))
            if not (math.isfinite(y[0]) and math.isfinite(y[1])):
                self.n_infeasible += 1
                y = self.penalty
            out.append(y)
        self.n_calls += 1
        self.n_evals += len(out)
        return out

    def __call__(self, designs):
        """Legacy calling convention: a single design returns one pair, a
        sequence returns a list of pairs."""
        if isinstance(designs, WSCDesign):
            return self.eval_many([designs])[0]
        return self.eval_many(list(designs))

    def stats(self) -> Dict[str, int]:
        return {"n_calls": self.n_calls, "n_evals": self.n_evals,
                "n_infeasible": self.n_infeasible,
                "n_constraint_violations": self.n_violations}

    def load_stats(self, d: Dict[str, int]) -> None:
        """Restore counters from a checkpoint (campaign resume), so a
        resumed run reports the same cumulative stats as an uninterrupted
        one."""
        self.n_calls = int(d.get("n_calls", 0))
        self.n_evals = int(d.get("n_evals", 0))
        self.n_infeasible = int(d.get("n_infeasible", 0))
        self.n_violations = int(d.get("n_constraint_violations", 0))


class EvaluatorObjective(Objective):
    """Train / inference objective: registry-batched `evaluate_design_batch`
    over the candidate set. Subsumes `evaluator.batched_objectives` and —
    with `params_fn` reading live parameters at call time —
    `GNNCalibrator.objectives()`."""

    def __init__(self, wl: LLMWorkload,
                 fidelity: Union[str, FidelityBackend] = "analytical",
                 gnn_params: Optional[Dict] = None,
                 params_fn: Optional[Callable[[], Optional[Dict]]] = None,
                 objectives: Optional[Sequence[ObjectiveSpec]] = None,
                 constraints: Sequence[ConstraintSpec] = (),
                 max_strategies: int = 24,
                 n_wafers: Optional[int] = None,
                 penalty: Tuple[float, float] = PENALTY,
                 strategy_mode: str = "grid"):
        super().__init__(objectives, constraints, penalty, scenario="train")
        if strategy_mode not in ("grid", "joint"):
            raise ValueError(f"strategy_mode {strategy_mode!r} not in "
                             "('grid', 'joint')")
        self.wl = wl
        self.backend = get_backend(fidelity)
        self.fidelity = self.backend.name
        self._gnn_params = gnn_params
        self._params_fn = params_fn
        self.max_strategies = max_strategies
        self.n_wafers = n_wafers
        self.strategy_mode = strategy_mode

    def gnn_params(self) -> Optional[Dict]:
        return self._params_fn() if self._params_fn else self._gnn_params

    def metrics(self, designs: List[WSCDesign]) -> List[Dict[str, float]]:
        # joint mode: `designs` are JointDesign points — each is scored
        # under its pinned Strategy, no per-design grid argmin
        if self.strategy_mode == "joint":
            from repro_torch.core.evaluator import evaluate_joint_batch
            rs = evaluate_joint_batch(
                designs, self.wl, fidelity=self.backend,
                gnn_params=self.gnn_params(), n_wafers=self.n_wafers,
                max_strategies=self.max_strategies)
            return self.metrics_from_results(rs)
        from repro_torch.core.evaluator import evaluate_design_batch
        rs = evaluate_design_batch(
            designs, self.wl, fidelity=self.backend,
            gnn_params=self.gnn_params(), n_wafers=self.n_wafers,
            max_strategies=self.max_strategies)
        return self.metrics_from_results(rs)

    @staticmethod
    def metrics_from_results(rs) -> List[Dict[str, float]]:
        return [{
            "throughput": r.throughput,
            "power": r.power_w,
            "power_per_wafer": r.power_w / max(r.n_wafers, 1),
            "n_wafers": float(r.n_wafers),
            "feasible": r.feasible,
        } for r in rs]

    # -- fused analytical iteration (DESIGN.md §12) ------------------------

    def supports_fused(self) -> bool:
        """True when this objective can consume device-resident pick
        indices through the analytical evaluator's torch program (the
        analytical fidelity, which always runs that program). The fused
        evaluation runs on the device of the pick indices."""
        return self.backend.name == "analytical"

    def eval_many_fused(self, pool_designs: Sequence[WSCDesign], js_dev,
                        q_eff: int
                        ) -> Tuple[List[int], List[Tuple[float, float]]]:
        """Evaluate the pool rows named by the device index vector
        `js_dev` (the q-EHVI acquire's output) through the fused
        gather+evaluate program; returns (pick indices, folded ys) —
        bit-identical to `eval_many([pool_designs[j] for j in js])`."""
        if self.strategy_mode == "joint":
            from repro_torch.core.evaluator import evaluate_pool_fused_joint
            js, rs = evaluate_pool_fused_joint(
                list(pool_designs), self.wl, js_dev, q_eff,
                gnn_params=self.gnn_params(), n_wafers=self.n_wafers,
                max_strategies=self.max_strategies)
            return js, self.fold_metrics(self.metrics_from_results(rs))
        from repro_torch.core.evaluator import evaluate_pool_fused
        js, rs = evaluate_pool_fused(
            list(pool_designs), self.wl, js_dev, q_eff,
            gnn_params=self.gnn_params(), n_wafers=self.n_wafers,
            max_strategies=self.max_strategies)
        return js, self.fold_metrics(self.metrics_from_results(rs))


class ServingObjective(Objective):
    """Serving objective: request-level continuous-batching metrics (TTFT /
    TPOT / SLO goodput, DESIGN.md §8) through `evaluate_serving_batch`.
    Subsumes `serving.serving_objectives`; SLO constraints (`ttft`, `tpot`,
    `slo_attainment`) compose naturally."""

    def __init__(self, wl: LLMWorkload, mix, slo, *, slots: int = 8,
                 fidelity: Union[str, FidelityBackend] = "analytical",
                 gnn_params: Optional[Dict] = None,
                 params_fn: Optional[Callable[[], Optional[Dict]]] = None,
                 objectives: Optional[Sequence[ObjectiveSpec]] = None,
                 constraints: Sequence[ConstraintSpec] = (),
                 max_strategies: int = 24,
                 penalty: Tuple[float, float] = PENALTY):
        super().__init__(objectives, constraints, penalty,
                         scenario="serving")
        self.wl = wl
        self.mix = mix
        self.slo = slo
        self.slots = slots
        self.backend = get_backend(fidelity)
        self.fidelity = self.backend.name
        self._gnn_params = gnn_params
        self._params_fn = params_fn
        self.max_strategies = max_strategies

    def gnn_params(self) -> Optional[Dict]:
        return self._params_fn() if self._params_fn else self._gnn_params

    def metrics(self, designs: List[WSCDesign]) -> List[Dict[str, float]]:
        from repro_torch.core.serving import evaluate_serving_batch
        rs = evaluate_serving_batch(
            designs, self.wl, self.mix, self.slo, slots=self.slots,
            fidelity=self.backend, gnn_params=self.gnn_params(),
            max_strategies=self.max_strategies)
        return [{
            "goodput": r.goodput_tok_s,
            "throughput": r.throughput_tok_s,
            "ttft": r.ttft_s, "ttft_max": r.ttft_max_s,
            "tpot": r.tpot_s, "tpot_max": r.tpot_max_s,
            "slo_attainment": r.slo_attainment,
            "power": r.power_w,
            "power_per_wafer": r.power_w / max(r.n_wafers, 1),
            "n_wafers": float(r.n_wafers),
            "feasible": r.feasible and np.isfinite(r.power_w),
        } for r in rs]


class HeteroServingObjective(Objective):
    """Heterogeneous (prefill/decode disaggregation) serving objective: each
    candidate design is scored as both stages of a split at the configured
    granularity / prefill ratio, under the coupled request model
    (`heterogeneity.evaluate_hetero_serving`)."""

    def __init__(self, wl: LLMWorkload, mix, slo, *, granularity: str,
                 prefill_ratio: float = 0.5, slots: int = 8,
                 n_wafers: int = 8,
                 fidelity: Union[str, FidelityBackend] = "analytical",
                 gnn_params: Optional[Dict] = None,
                 params_fn: Optional[Callable[[], Optional[Dict]]] = None,
                 objectives: Optional[Sequence[ObjectiveSpec]] = None,
                 constraints: Sequence[ConstraintSpec] = (),
                 penalty: Tuple[float, float] = PENALTY):
        super().__init__(objectives, constraints, penalty, scenario="hetero")
        self.wl = wl
        self.mix = mix
        self.slo = slo
        self.granularity = granularity
        self.prefill_ratio = prefill_ratio
        self.slots = slots
        self.n_wafers = n_wafers
        self.backend = get_backend(fidelity)
        self.fidelity = self.backend.name
        self._gnn_params = gnn_params
        self._params_fn = params_fn

    def gnn_params(self) -> Optional[Dict]:
        return self._params_fn() if self._params_fn else self._gnn_params

    def metrics(self, designs: List[WSCDesign]) -> List[Dict[str, float]]:
        from repro_torch.core.heterogeneity import evaluate_hetero_serving
        out = []
        for d in designs:
            r = evaluate_hetero_serving(
                d, d, self.wl, self.granularity, self.prefill_ratio,
                self.mix, self.slo, slots=self.slots,
                n_wafers=self.n_wafers, fidelity=self.backend,
                gnn_params=self.gnn_params())
            out.append({
                "goodput": r.goodput_tok_s,
                "throughput": r.throughput_tok_s,
                "ttft": r.ttft_s, "tpot": r.tpot_s,
                "slo_attainment": r.slo_attainment,
                "power": r.power_w,
                "power_per_wafer": r.power_w / max(self.n_wafers, 1),
                "n_wafers": float(self.n_wafers),
                "kv_transfer_s": r.kv_transfer_s,
                "feasible": r.feasible and np.isfinite(r.power_w),
            })
        return out


class TraceServingObjective(Objective):
    """Trace-driven multi-tenant serving objective (DESIGN.md §14):
    candidates are scored by replaying a `RequestTrace` under an
    admission/routing policy through `traces.evaluate_trace_serving_batch`.
    The default objective pair is (worst-window interactive goodput,
    power-per-wafer) — which design keeps chat inside its tenant SLO
    through the worst load spike, at what power. Candidates may be
    `PolicyDesign`s (each carrying its own searched policy) or plain
    designs scored under `policy`; per-tenant goodput/attainment flow out
    as `tenant:<name>:*` metrics so constraints can pin a specific class."""

    def __init__(self, wl: LLMWorkload, trace, *, policy: str = "fifo",
                 slots: int = 8, window_steps: int = 64,
                 prefill_ratio: float = 0.5,
                 fidelity: Union[str, FidelityBackend] = "analytical",
                 gnn_params: Optional[Dict] = None,
                 params_fn: Optional[Callable[[], Optional[Dict]]] = None,
                 objectives: Optional[Sequence[ObjectiveSpec]] = None,
                 constraints: Sequence[ConstraintSpec] = (),
                 max_strategies: int = 24,
                 penalty: Tuple[float, float] = PENALTY):
        super().__init__(objectives, constraints, penalty,
                         scenario="trace_serving")
        self.wl = wl
        self.trace = trace
        self.policy = policy
        self.slots = slots
        self.window_steps = window_steps
        self.prefill_ratio = prefill_ratio
        self.backend = get_backend(fidelity)
        self.fidelity = self.backend.name
        self._gnn_params = gnn_params
        self._params_fn = params_fn
        self.max_strategies = max_strategies

    def gnn_params(self) -> Optional[Dict]:
        return self._params_fn() if self._params_fn else self._gnn_params

    def metrics(self, designs: List[WSCDesign]) -> List[Dict[str, float]]:
        from repro_torch.core.traces import evaluate_trace_serving_batch
        rs = evaluate_trace_serving_batch(
            designs, self.wl, self.trace, slots=self.slots,
            policy=self.policy, window_steps=self.window_steps,
            prefill_ratio=self.prefill_ratio, fidelity=self.backend,
            gnn_params=self.gnn_params(),
            max_strategies=self.max_strategies)
        out = []
        for r in rs:
            m = {
                "goodput": r.goodput_tok_s,
                "interactive_goodput": r.interactive_goodput_tok_s,
                "worst_window_goodput": r.worst_window_goodput_tok_s,
                "throughput": r.throughput_tok_s,
                "ttft": r.ttft_s, "ttft_max": r.ttft_max_s,
                "tpot": r.tpot_s, "tpot_max": r.tpot_max_s,
                "slo_attainment": r.slo_attainment,
                "n_preemptions": float(r.n_preemptions),
                "power": r.power_w,
                "power_per_wafer": r.power_w / max(r.n_wafers, 1),
                "n_wafers": float(r.n_wafers),
                "feasible": r.feasible and np.isfinite(r.power_w),
            }
            for name, tm in r.per_tenant.items():
                m[f"tenant:{name}:goodput"] = tm["goodput_tok_s"]
                m[f"tenant:{name}:slo_attainment"] = tm["slo_attainment"]
            out.append(m)
        return out


class CallableObjective(Objective):
    """Compat adapter for legacy objective callables: scalar
    ``f(design) -> (y0, y1)`` functions and ``.batched``-marked batch
    functions. This is the one place the old attribute sniff survives."""

    def __init__(self, fn: Callable):
        super().__init__(objectives=(ObjectiveSpec("y0", "max", "identity"),
                                     ObjectiveSpec("y1", "min", "identity")))
        self.fn = fn
        self.fidelity = getattr(fn, "fidelity", None)

    def eval_many(self, designs: Sequence[WSCDesign]
                  ) -> List[Tuple[float, float]]:
        designs = list(designs)
        if getattr(self.fn, "batched", False):
            ys = self.fn(designs)
        else:
            ys = [self.fn(d) for d in designs]
        self.n_calls += 1
        self.n_evals += len(designs)
        return [(float(y[0]), float(y[1])) for y in ys]


def as_objective(f) -> Objective:
    """Coerce anything objective-shaped to the `Objective` protocol."""
    if isinstance(f, Objective):
        return f
    if hasattr(f, "eval_many"):                      # duck-typed protocol
        return f
    if callable(f):
        return CallableObjective(f)
    raise TypeError(f"not an objective: {f!r}")


__all__ = [
    "CallableObjective", "ConstraintSpec", "EvaluatorObjective",
    "HeteroServingObjective", "Objective", "ObjectiveSpec", "PENALTY",
    "ServingObjective", "TraceServingObjective", "as_objective",
    "default_objectives",
]
