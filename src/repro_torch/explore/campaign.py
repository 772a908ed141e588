"""Declarative, serializable, resumable DSE campaigns (DESIGN.md §9).

The paper's headline results (§VII–§VIII) are *campaigns*: a workload, a
scenario, an objective pair, constraints, a fidelity schedule, a strategy
and a budget. `CampaignSpec` makes that configuration the artifact of
record — a frozen dataclass that round-trips to JSON and fully determines
a run (fixed seed ⇒ reproducible trace) — and `Campaign` executes it with
periodic checkpointing:

    spec = CampaignSpec.from_json("examples/campaigns/quick_train_mfmobo.json")
    result = Campaign(spec).run(checkpoint_path="run.ckpt")
    ...
    result = Campaign.resume("run.ckpt").run()     # bit-identical continuation

Scenarios wire the objective adapters (repro_torch.explore.objectives):
    train      evaluate_design_batch on the workload as-is (phase=train)
    inference  evaluate_design_batch on an isolated prefill/decode step
    serving    request-level continuous batching (TTFT/TPOT/SLO goodput)
    hetero     prefill/decode disaggregation under the coupled request model
    trace_serving  trace-driven multi-tenant serving: timed arrivals, per-
               tenant SLOs, searchable admission/routing policy (§14)

Workload refs resolve against `repro_torch.core.workload.GPT_BENCHMARKS` by name
("GPT-175B") or against the runtime configs as "arch_id@shape_id"
(repro_torch.configs.get_config / get_shape via `from_model_config`), so every
assigned architecture is a campaign target too.

The CLI lives in `repro_torch.explore.__main__`:
    python -m repro_torch.explore examples/campaigns/<spec>.json [--resume CKPT]

The port's copy of `repro.explore.campaign`. A campaign runs on a device
(`Campaign(spec, device=...)`, the card unless the caller passes "cpu"):
the GP, the acquire, the analytical evaluator and the GNN fidelity with its
calibration all run there; the device is not a field of the spec.
`params_path` pickles hold `repro`'s params tree with numpy leaves
(`noc_gnn.load_gnn_params`), and so do checkpoints. Every shipped spec
runs, joint strategy mode included (the pinned evaluator, the
shardability oracle).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.core.fidelity import AnalyticalBackend, GNNBackend
from repro_torch.core.mfmobo import Trace
from repro_torch.core.noc_gnn import (
    gnn_params_on,
    gnn_params_to_jax,
    load_gnn_params,
)
from repro_torch.core.pareto import pareto_mask, to_max_space
from repro_torch.core.workload import GPT_BENCHMARKS, LLMWorkload, RequestMix
from repro_torch.explore.objectives import (
    ConstraintSpec,
    EvaluatorObjective,
    HeteroServingObjective,
    Objective,
    ObjectiveSpec,
    ServingObjective,
    default_objectives,
)
from repro_torch.explore.runner import ExplorationLoop, LoopConfig, STRATEGIES
from repro_torch.device import resolve_device

SCENARIOS = ("train", "inference", "serving", "hetero", "trace_serving")
HETERO_GRANULARITIES = ("core", "reticle", "wafer")
#: trace_serving admission/routing policies a spec may pin — or "search"
#: to make the policy a candidate dimension next to the architecture dims
TRACE_POLICIES = ("fifo", "priority", "preempt", "disaggregated", "search")
SPEC_VERSION = 1


# ---------------------------------------------------------------------------
# spec dataclasses
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FidelitySchedule:
    """Which fidelity evaluates which part of the budget (paper Algorithm
    1): d1 f1-priors, then f1 proposals until N1 is spent, then f0 with the
    low-fidelity surrogate for k evaluations (the handover), then f0 with
    its own surrogate. `calibrate_on_handover` fine-tunes the f0 GNN on
    simulator traces from the current Pareto neighborhood right before the
    first f0 evaluation (repro_torch.core.calibration)."""
    f1: str = "analytical"
    f0: str = "analytical"
    d1: int = 3
    d0: int = 2
    k: int = 3
    calibrate_on_handover: bool = False
    params_path: Optional[str] = None      # pickled GNN params for f0/f1
    calibration: Optional[Dict] = None     # GNNCalibrator kwargs

    def needs_gnn_params(self) -> bool:
        return "gnn" in (self.f0, self.f1)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "FidelitySchedule":
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class ServingSpec:
    """Request mix + SLO for serving / hetero scenarios: one arrival batch
    of `n_requests`, uniform (prompt_len -> out_len), `slots` decode slots,
    and the TTFT/TPOT bounds a request must meet to count toward goodput."""
    n_requests: int = 32
    prompt_len: int = 2048
    out_len: int = 256
    slots: int = 8
    ttft_s: float = 5.0
    tpot_s: float = 0.05

    def mix(self) -> RequestMix:
        return RequestMix.uniform(self.n_requests, prompt_len=self.prompt_len,
                                  out_len=self.out_len)

    def slo(self):
        from repro_torch.core.serving import ServingSLO
        return ServingSLO(ttft_s=self.ttft_s, tpot_s=self.tpot_s)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "ServingSpec":
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Trace-driven multi-tenant serving scenario (DESIGN.md §14): a seeded
    synthetic arrival process (`kind`: poisson | spike | diurnal), the
    tenant classes sharing the wafer, and the admission/routing policy —
    pinned to one of `core.traces.POLICIES`, or ``"search"`` to expose the
    policy as a candidate axis next to the 13 architecture dims
    (`sample_policy_candidates`). Each tenant dict carries its own SLO and
    scheduling class: ``{"name", "ttft_s", "tpot_s", "priority",
    "interactive", "share", "prompt_range", "out_range"}``."""
    kind: str = "spike"
    n_requests: int = 64
    rate: float = 0.25
    seed: int = 0
    slots: int = 8
    window_steps: int = 64
    policy: str = "fifo"
    policies: Tuple[str, ...] = ()       # searched subset ("" = all four)
    prefill_ratio: float = 0.5           # disaggregated stage split
    # spike (Markov-modulated) process knobs
    spike_factor: float = 8.0
    spike_len: int = 32
    gap_len: int = 128
    # diurnal (sinusoidal-rate) process knobs
    period: int = 512
    amplitude: float = 0.9
    tenants: Tuple[Dict, ...] = ()

    def __post_init__(self):
        norm = []
        for t in self.tenants:
            t = dict(t)
            for k in ("prompt_range", "out_range"):
                if k in t and t[k] is not None:
                    t[k] = tuple(int(x) for x in t[k])
            norm.append(t)
        object.__setattr__(self, "tenants", tuple(norm))
        object.__setattr__(self, "policies",
                           tuple(str(p) for p in self.policies))

    def tenant_classes(self):
        from repro_torch.core.traces import DEFAULT_TENANT, TenantClass
        if not self.tenants:
            return (DEFAULT_TENANT,)
        return tuple(TenantClass(
            name=t["name"], ttft_s=float(t["ttft_s"]),
            tpot_s=float(t["tpot_s"]), priority=int(t.get("priority", 0)),
            interactive=bool(t.get("interactive", True)))
            for t in self.tenants)

    def trace(self):
        from repro_torch.core.traces import synth_trace
        kw: Dict = {"rate": self.rate}
        if self.kind == "spike":
            kw.update(spike_factor=self.spike_factor,
                      spike_len=self.spike_len, gap_len=self.gap_len)
        elif self.kind == "diurnal":
            kw.update(period=self.period, amplitude=self.amplitude)
        if self.tenants:
            kw.update(
                tenants=self.tenant_classes(),
                shares=tuple(float(t.get("share", 1.0))
                             for t in self.tenants),
                prompt_ranges=tuple(t.get("prompt_range", (256, 1024))
                                    for t in self.tenants),
                out_ranges=tuple(t.get("out_range", (32, 128))
                                 for t in self.tenants))
        return synth_trace(self.kind, self.n_requests, seed=self.seed, **kw)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "TraceSpec":
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class HeteroSpec:
    """Prefill/decode disaggregation knobs for the hetero scenario."""
    granularity: str = "reticle"
    prefill_ratio: float = 0.5
    n_wafers: int = 8

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "HeteroSpec":
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """One DSE campaign, fully determined: JSON round-trip preserves every
    field, and (spec, seed) fixes the trace bit-for-bit."""
    name: str
    workload: str                              # "GPT-175B" | "arch@shape"
    scenario: str = "train"
    strategy: str = "mfmobo"                   # mfmobo | mobo | random
    objectives: Tuple[ObjectiveSpec, ObjectiveSpec] = ()
    constraints: Tuple[ConstraintSpec, ...] = ()
    fidelity: FidelitySchedule = FidelitySchedule()
    n_evals_f0: int = 20                       # N0 (total budget for
    n_evals_f1: int = 30                       # mobo/random); N1 (mfmobo)
    q: int = 1
    seed: int = 0
    n_candidates: int = 256
    max_strategies: int = 24
    peak_power_w: float = 15000.0
    workload_overrides: Optional[Dict] = None  # batch / seq / phase
    serving: Optional[ServingSpec] = None
    hetero: Optional[HeteroSpec] = None
    trace: Optional[TraceSpec] = None          # trace_serving scenario
    checkpoint_every: int = 0                  # steps; 0 = final only
    checkpoint_keep: int = 3                   # retained ckpt generations
    async_depth: int = 0                       # in-flight eval batches;
                                               # 0 = synchronous loop
    # strategy-architecture co-exploration (DESIGN.md §13): "grid" keeps
    # the per-design strategy-grid argmin (historical behavior, trace
    # replay contract); "joint" appends the 7 strategy axes to the search
    # encoding and pins each candidate's Strategy
    strategy_mode: str = "grid"
    strategy_space: Optional[Dict] = None      # StrategySpace.to_json()
                                               # bounds; None = derived

    def __post_init__(self):
        if not self.objectives:
            object.__setattr__(self, "objectives",
                               default_objectives(self.scenario))
        object.__setattr__(self, "objectives", tuple(self.objectives))
        object.__setattr__(self, "constraints", tuple(self.constraints))

    # -- validation --------------------------------------------------------

    def validate(self) -> "CampaignSpec":
        if self.scenario not in SCENARIOS:
            raise ValueError(f"unknown scenario {self.scenario!r}; expected "
                             f"one of {SCENARIOS}")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; expected "
                             f"one of {STRATEGIES}")
        from repro_torch.core.fidelity import get_backend
        get_backend(self.fidelity.f0)
        if self.strategy == "mfmobo":
            get_backend(self.fidelity.f1)
        if self.scenario in ("serving", "hetero") and self.serving is None:
            raise ValueError(f"scenario {self.scenario!r} needs a `serving` "
                             "spec (request mix + SLO)")
        if self.scenario == "trace_serving":
            t = self.trace
            if t is None:
                raise ValueError("scenario 'trace_serving' needs a `trace` "
                                 "spec (arrival process + tenants + policy)")
            if t.policy not in TRACE_POLICIES:
                raise ValueError(f"trace policy {t.policy!r} not in "
                                 f"{TRACE_POLICIES}")
            from repro_torch.core.traces import POLICIES
            if t.policies and (t.policy != "search"
                               or any(p not in POLICIES
                                      for p in t.policies)):
                raise ValueError(
                    "trace.policies narrows the searched policy set — it "
                    "requires policy='search' and a subset of "
                    f"{POLICIES} (got policy={t.policy!r}, "
                    f"policies={t.policies})")
            if t.kind not in ("poisson", "spike", "diurnal"):
                raise ValueError(f"trace kind {t.kind!r} not in "
                                 "('poisson', 'spike', 'diurnal')")
            t.trace()        # generator kwargs / tenant dicts raise here
        if self.scenario == "hetero":
            h = self.hetero or HeteroSpec()
            if h.granularity not in HETERO_GRANULARITIES:
                raise ValueError(
                    f"hetero granularity {h.granularity!r} not in "
                    f"{HETERO_GRANULARITIES}")
        if self.fidelity.calibrate_on_handover and self.fidelity.f0 != "gnn":
            raise ValueError("calibrate_on_handover requires f0='gnn'")
        if self.strategy_mode not in ("grid", "joint"):
            raise ValueError(f"strategy_mode {self.strategy_mode!r} not in "
                             "('grid', 'joint')")
        if self.strategy_mode == "joint":
            if self.scenario not in ("train", "inference"):
                raise ValueError(
                    "strategy_mode='joint' supports the train/inference "
                    f"scenarios (got {self.scenario!r}); serving/hetero "
                    "objectives do not pin strategies yet")
            if self.strategy_space is not None:
                from repro_torch.core.design_space import StrategySpace
                StrategySpace.from_json(self.strategy_space)  # raises on bad
        self.loop_config().validate()
        resolve_workload(self)                       # raises on bad refs
        for c in self.constraints:
            if c.metric not in self.known_metrics():
                raise ValueError(
                    f"constraint metric {c.metric!r} not produced by the "
                    f"{self.scenario} scenario; known: "
                    f"{sorted(self.known_metrics())}")
        for o in self.objectives:
            if o.name not in self.known_metrics():
                raise ValueError(
                    f"objective metric {o.name!r} not produced by the "
                    f"{self.scenario} scenario; known: "
                    f"{sorted(self.known_metrics())}")
        dirs = tuple(o.direction for o in self.objectives)
        if dirs != ("max", "min"):
            raise ValueError(
                "objective pair must be (max, min) — maximize "
                "throughput/goodput against minimized power (got "
                f"{dirs}); swap the pair order")
        # the trace's hypervolume/acquisition space is fixed to the
        # canonical (log1p y0, -log y1) of mfmobo.obj_space; reject specs
        # declaring transforms the loop would silently not apply
        # ("identity" exists for CallableObjective's synthetic legacy fns,
        # which never come from specs)
        tfs = tuple(o.transform for o in self.objectives)
        if tfs != ("log1p", "neg_log"):
            raise ValueError(
                f"campaign objective transforms must be ('log1p', "
                f"'neg_log') — the trace HV space is fixed (got {tfs})")
        return self

    def known_metrics(self) -> Tuple[str, ...]:
        base = ("throughput", "power", "power_per_wafer", "n_wafers")
        if self.scenario == "serving":
            return base + ("goodput", "ttft", "tpot", "ttft_max",
                           "tpot_max", "slo_attainment")
        if self.scenario == "hetero":
            return base + ("goodput", "ttft", "tpot", "slo_attainment",
                           "kv_transfer_s")
        if self.scenario == "trace_serving":
            t = self.trace or TraceSpec()
            names = [d.get("name", "default") for d in t.tenants] \
                or ["default"]
            per_tenant = tuple(f"tenant:{n}:{m}" for n in names
                               for m in ("goodput", "slo_attainment"))
            return base + ("goodput", "interactive_goodput",
                           "worst_window_goodput", "ttft", "tpot",
                           "ttft_max", "tpot_max", "slo_attainment",
                           "n_preemptions") + per_tenant
        return base

    def loop_config(self) -> LoopConfig:
        f = self.fidelity
        return LoopConfig(
            strategy=self.strategy, N0=self.n_evals_f0, N1=self.n_evals_f1,
            d0=f.d0, d1=f.d1, k=f.k, q=self.q,
            n_candidates=self.n_candidates, peak_power=self.peak_power_w,
            seed=self.seed, async_depth=self.async_depth)

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> Dict:
        d = {
            "version": SPEC_VERSION,
            "name": self.name,
            "workload": self.workload,
            "scenario": self.scenario,
            "strategy": self.strategy,
            "objectives": [o.to_dict() for o in self.objectives],
            "constraints": [c.to_dict() for c in self.constraints],
            "fidelity": self.fidelity.to_dict(),
            "n_evals_f0": self.n_evals_f0,
            "n_evals_f1": self.n_evals_f1,
            "q": self.q,
            "seed": self.seed,
            "n_candidates": self.n_candidates,
            "max_strategies": self.max_strategies,
            "peak_power_w": self.peak_power_w,
            "checkpoint_every": self.checkpoint_every,
            "checkpoint_keep": self.checkpoint_keep,
            "async_depth": self.async_depth,
        }
        # emitted only when non-default, so pre-joint spec JSON (and the
        # fixtures diffing it) stays byte-identical
        if self.strategy_mode != "grid":
            d["strategy_mode"] = self.strategy_mode
        if self.strategy_space is not None:
            d["strategy_space"] = dict(self.strategy_space)
        if self.workload_overrides:
            d["workload_overrides"] = dict(self.workload_overrides)
        if self.serving is not None:
            d["serving"] = self.serving.to_dict()
        if self.hetero is not None:
            d["hetero"] = self.hetero.to_dict()
        if self.trace is not None:
            d["trace"] = self.trace.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "CampaignSpec":
        d = dict(d)
        v = d.pop("version", SPEC_VERSION)
        if v != SPEC_VERSION:
            raise ValueError(f"campaign spec version {v!r} unsupported "
                             f"(this build reads version {SPEC_VERSION})")
        if "objectives" in d:
            d["objectives"] = tuple(ObjectiveSpec.from_dict(o)
                                    for o in d["objectives"])
        if "constraints" in d:
            d["constraints"] = tuple(ConstraintSpec.from_dict(c)
                                     for c in d["constraints"])
        if "fidelity" in d:
            d["fidelity"] = FidelitySchedule.from_dict(d["fidelity"])
        if d.get("serving") is not None:
            d["serving"] = ServingSpec.from_dict(d["serving"])
        if d.get("hetero") is not None:
            d["hetero"] = HeteroSpec.from_dict(d["hetero"])
        if d.get("trace") is not None:
            d["trace"] = TraceSpec.from_dict(d["trace"])
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown campaign spec fields: "
                             f"{sorted(unknown)}")
        return cls(**d)

    def to_json(self, path: Optional[str] = None, indent: int = 1) -> str:
        s = json.dumps(self.to_dict(), indent=indent)
        if path:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s

    @classmethod
    def from_json(cls, path_or_str: str) -> "CampaignSpec":
        if path_or_str.lstrip().startswith("{"):
            return cls.from_dict(json.loads(path_or_str))
        with open(path_or_str) as f:
            return cls.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# workload resolution
# ---------------------------------------------------------------------------

_GPT_BY_NAME = {w.name: w for w in GPT_BENCHMARKS}


def resolve_workload(spec: CampaignSpec) -> LLMWorkload:
    """Resolve the spec's workload ref: a paper benchmark by name
    ("GPT-175B") or a runtime architecture as "arch_id@shape_id" (bridged
    through `from_model_config`). Overrides (batch/seq/phase) and the
    scenario's phase convention are applied on top."""
    ref = spec.workload
    if ref in _GPT_BY_NAME:
        wl = _GPT_BY_NAME[ref]
    elif "@" in ref:
        from repro_torch.configs import get_config, get_shape
        from repro_torch.core.workload import from_model_config
        arch, shape = ref.split("@", 1)
        wl = from_model_config(get_config(arch), get_shape(shape))
    else:
        raise ValueError(
            f"unknown workload ref {ref!r}: expected one of "
            f"{sorted(_GPT_BY_NAME)} or an 'arch_id@shape_id' config ref")
    ov = dict(spec.workload_overrides or {})
    if spec.scenario == "train":
        ov.setdefault("phase", "train")
    elif spec.scenario == "inference":
        ov.setdefault("phase", "decode")
        if ov["phase"] not in ("prefill", "decode"):
            raise ValueError("inference scenario phase must be "
                             f"prefill|decode (got {ov['phase']!r})")
    bad = set(ov) - {"batch", "seq", "phase"}
    if bad:
        raise ValueError(f"unsupported workload overrides: {sorted(bad)}")
    return dataclasses.replace(wl, **ov) if ov else wl


# the densest wafer in the design space (32x32 cores x 12x12 reticles
# ~ 1.5e5 cores) on a handful of area-matched wafers — the default system
# bound the derived strategy caps assume when a spec doesn't pin bounds
DEFAULT_JOINT_CORES = 1 << 19


def resolve_strategy_space(spec: CampaignSpec, wl: LLMWorkload):
    """The joint campaign's `StrategySpace`: explicit bounds from the spec
    when given, else derived from the workload and the largest system under
    search (`StrategySpace.for_workload`)."""
    from repro_torch.core.design_space import StrategySpace
    if spec.strategy_space is not None:
        return StrategySpace.from_json(spec.strategy_space)
    return StrategySpace.for_workload(wl, DEFAULT_JOINT_CORES)


# ---------------------------------------------------------------------------
# campaign runner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CampaignResult:
    spec: CampaignSpec
    trace: Trace
    finished: bool
    wall_s: float
    n_evals: int
    candidates_per_sec: float
    hv_final: float
    front: List[Dict]
    stage_cache: Dict[str, Dict]
    objective_stats: Dict
    calibration: List[Dict]

    def to_dict(self) -> Dict:
        return {
            "spec": self.spec.to_dict(),
            "finished": self.finished,
            "wall_s": self.wall_s,
            "n_evals": self.n_evals,
            "candidates_per_sec": self.candidates_per_sec,
            "hv": list(self.trace.hv),
            "hv_final": self.hv_final,
            "front": self.front,
            "stage_cache": self.stage_cache,
            "objective_stats": self.objective_stats,
            "calibration": self.calibration,
        }

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, default=float)
        return path


def _front_records(spec: CampaignSpec, trace: Trace) -> List[Dict]:
    """Nondominated trace points (penalty / zero-objective points never
    qualify: any feasible candidate dominates them)."""
    y0n, y1n = spec.objectives[0].name, spec.objectives[1].name
    rows = [(i, y) for i, y in enumerate(trace.ys) if y[0] > 0]
    if not rows:
        return []
    pts = to_max_space([y[0] for _, y in rows], [y[1] for _, y in rows])
    mask = pareto_mask(pts)
    out = []
    for (i, y), keep in zip(rows, mask):
        if keep:
            d = trace.designs[i]
            out.append({y0n: y[0], y1n: y[1],
                        "design": dataclasses.asdict(d),
                        "describe": d.describe()})
    return out


class Campaign:
    """Executes a `CampaignSpec`: builds the scenario's objectives, runs the
    resumable exploration loop, checkpoints periodically, and summarizes the
    outcome. `Campaign.resume(path)` reconstructs a mid-run campaign whose
    continuation is bit-identical to the uninterrupted run."""

    def __init__(self, spec: CampaignSpec, *,
                 gnn_params: Optional[Dict] = None, device="cuda",
                 _state=None, _calibration_records=None,
                 _objective_stats=None):
        self.spec = spec.validate()
        self.device = resolve_device(device)
        self.wl = resolve_workload(spec)
        self.gnn_params = self._load_params(gnn_params)
        self.calibrator = None
        on_handover = None
        if spec.fidelity.calibrate_on_handover:
            from repro_torch.core.calibration import GNNCalibrator
            kw = dict(spec.fidelity.calibration or {})
            kw.setdefault("seed", spec.seed)
            self.calibrator = GNNCalibrator(self.gnn_params, self.wl, **kw)
            if _calibration_records:
                self.calibrator.records = list(_calibration_records)
            on_handover = self.calibrator.on_handover
        self.f0 = self._build_objective(spec.fidelity.f0)
        self.f1 = (self._build_objective(spec.fidelity.f1)
                   if spec.strategy == "mfmobo" else None)
        if _objective_stats:                 # resume: cumulative counters
            self.f0.load_stats(_objective_stats.get("f0", {}))
            if self.f1 is not None:
                self.f1.load_stats(_objective_stats.get("f1", {}))
        candidate_fn = None
        if spec.strategy_mode == "joint":
            from repro_torch.core.mfmobo import _valid_candidates_joint
            space = resolve_strategy_space(spec, self.wl)
            wl = self.wl
            candidate_fn = (lambda rng, n:
                            _valid_candidates_joint(rng, n, space, wl))
        elif (spec.scenario == "trace_serving" and spec.trace is not None
                and spec.trace.policy == "search"):
            # the policy axis: 14-dim candidates, each a PolicyDesign
            from repro_torch.core.traces import POLICIES, sample_policy_candidates
            pols = spec.trace.policies or POLICIES
            candidate_fn = (lambda rng, n:
                            sample_policy_candidates(rng, n, policies=pols))
        self.loop = ExplorationLoop(spec.loop_config(), self.f0, f1=self.f1,
                                    on_handover=on_handover, state=_state,
                                    candidate_fn=candidate_fn,
                                    device=self.device)

    # -- construction helpers ----------------------------------------------

    def _load_params(self, gnn_params):
        spec = self.spec
        if gnn_params is not None:
            return gnn_params_on(gnn_params, self.device)
        if spec.fidelity.params_path:
            return load_gnn_params(spec.fidelity.params_path, self.device)
        if spec.fidelity.needs_gnn_params():
            raise ValueError(
                "the 'gnn' fidelity needs trained parameters: set "
                "fidelity.params_path in the spec or pass "
                "Campaign(spec, gnn_params=...)")
        return None

    def _params_fn(self):
        if self.calibrator is not None:
            cal = self.calibrator
            return lambda: cal.params
        if self.gnn_params is not None:
            params = self.gnn_params
            return lambda: params
        return None

    def _build_objective(self, fidelity: str) -> Objective:
        spec = self.spec
        kw = dict(objectives=spec.objectives, constraints=spec.constraints)
        # params only reach the fidelities that consume them, so e.g. the
        # analytical f1 stage's cache keys stay params-independent while
        # calibration swaps the f0 pytree mid-run
        params_fn = self._params_fn() if fidelity == "gnn" else None
        if fidelity == "analytical":
            fidelity = AnalyticalBackend(device=self.device)
        elif fidelity == "gnn":
            fidelity = GNNBackend(device=self.device)
        if spec.scenario in ("train", "inference"):
            return EvaluatorObjective(
                self.wl, fidelity, params_fn=params_fn,
                max_strategies=spec.max_strategies,
                strategy_mode=spec.strategy_mode, **kw)
        if spec.scenario == "trace_serving":
            from repro_torch.explore.objectives import TraceServingObjective
            t = spec.trace
            return TraceServingObjective(
                self.wl, t.trace(),
                policy="fifo" if t.policy == "search" else t.policy,
                slots=t.slots, window_steps=t.window_steps,
                prefill_ratio=t.prefill_ratio, fidelity=fidelity,
                params_fn=params_fn,
                max_strategies=spec.max_strategies, **kw)
        sv = spec.serving
        if spec.scenario == "serving":
            return ServingObjective(
                self.wl, sv.mix(), sv.slo(), slots=sv.slots,
                fidelity=fidelity, params_fn=params_fn,
                max_strategies=spec.max_strategies, **kw)
        h = spec.hetero or HeteroSpec()
        return HeteroServingObjective(
            self.wl, sv.mix(), sv.slo(), granularity=h.granularity,
            prefill_ratio=h.prefill_ratio, slots=sv.slots,
            n_wafers=h.n_wafers, fidelity=fidelity,
            params_fn=params_fn, **kw)

    # -- execution ---------------------------------------------------------

    def _checkpoint(self, path: str):
        extra = {"spec": self.spec.to_dict(),
                 "objective_stats": {"f0": self.f0.stats(),
                                     **({"f1": self.f1.stats()}
                                        if self.f1 is not None else {})}}
        # params as repro's tree with numpy leaves: exact, and readable on
        # any device
        if self.calibrator is not None:
            extra["gnn_params"] = gnn_params_to_jax(self.calibrator.params)
            extra["calibration_records"] = list(self.calibrator.records)
        elif self.gnn_params is not None:
            extra["gnn_params"] = gnn_params_to_jax(self.gnn_params)
        self.loop.save_state(path, extra=extra,
                             keep=self.spec.checkpoint_keep)

    def run(self, checkpoint_path: Optional[str] = None,
            checkpoint_every: Optional[int] = None,
            max_steps: Optional[int] = None) -> CampaignResult:
        every = (checkpoint_every if checkpoint_every is not None
                 else self.spec.checkpoint_every)
        cb = ((lambda: self._checkpoint(checkpoint_path))
              if checkpoint_path else None)
        self.loop.run(max_steps=max_steps, checkpoint_every=every,
                      checkpoint_cb=cb)
        return self.result()

    @classmethod
    def resume(cls, checkpoint_path: str, *,
               gnn_params: Optional[Dict] = None,
               device="cuda") -> "Campaign":
        """Load a checkpoint into a campaign primed to continue: call
        `.run(checkpoint_path=...)` to finish it. The continuation consumes
        the checkpointed rng stream, so the completed trace is bit-identical
        to an uninterrupted run of the same spec. An explicit `gnn_params`
        overrides the checkpointed pytree (e.g. to resume under retrained
        params — which forfeits the bit-identity guarantee). The checkpoint
        holds no device state, so `device` may differ from the run that
        wrote it."""
        cfg, state, extra = ExplorationLoop.load_state(checkpoint_path)
        spec = CampaignSpec.from_dict(extra["spec"])
        if spec.loop_config() != cfg:
            raise ValueError(
                f"checkpoint {checkpoint_path} was written by a different "
                "loop configuration than its embedded spec resolves to")
        if gnn_params is None:
            gnn_params = extra.get("gnn_params")
        return cls(spec,
                   gnn_params=gnn_params,
                   device=device,
                   _state=state,
                   _calibration_records=extra.get("calibration_records"),
                   _objective_stats=extra.get("objective_stats"))

    # -- reporting ---------------------------------------------------------

    def result(self) -> CampaignResult:
        tr = self.loop.state.trace
        wall = self.loop.state.wall_s
        stage_cache = {}
        for stage, sc in tr.stage_cache.items():
            n = sc.get("hits", 0) + sc.get("misses", 0)
            stage_cache[stage] = dict(
                sc, hit_rate=(sc.get("hits", 0) / n if n else 0.0))
        stats = {"f0": self.f0.stats()}
        if self.f1 is not None:
            stats["f1"] = self.f1.stats()
        calibration = []
        if self.calibrator is not None:
            calibration = [{
                "n_designs": r.n_designs, "n_graphs": r.n_graphs,
                "train_s": r.train_s,
                "val_kendall_tau": r.history.best_val_kendall_tau,
            } for r in self.calibrator.records]
        return CampaignResult(
            spec=self.spec, trace=tr, finished=self.loop.finished,
            wall_s=wall, n_evals=tr.n_evals,
            candidates_per_sec=tr.n_evals / max(wall, 1e-9),
            hv_final=tr.hv[-1] if tr.hv else 0.0,
            front=_front_records(self.spec, tr),
            stage_cache=stage_cache, objective_stats=stats,
            calibration=calibration)


def run_campaign(spec: CampaignSpec, device="cuda", **kw) -> CampaignResult:
    """One-shot convenience: `Campaign(spec, device=device).run(**kw)`."""
    return Campaign(spec, device=device).run(**kw)


__all__ = [
    "Campaign", "CampaignResult", "CampaignSpec", "FidelitySchedule",
    "HeteroSpec", "SCENARIOS", "ServingSpec", "TRACE_POLICIES",
    "TraceSpec", "resolve_strategy_space", "resolve_workload",
    "run_campaign",
]
