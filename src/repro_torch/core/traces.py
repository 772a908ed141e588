"""Trace-driven multi-tenant serving: arrivals, tenant SLOs, policies.

The one-batch serving model (repro_torch.core.serving) scores one arrival batch —
every request lands at t=0 under a single global `ServingSLO`. Real
serving at the ROADMAP's millions-of-users scale is bursty arrivals,
diurnal load, and *mixed tenants* (interactive chat + embeddings + batch
offline) sharing one wafer. This module makes that workload a first-class,
searchable object (DESIGN.md §14):

  * `RequestTrace` — a frozen, hashable, JSON-round-trippable trace: per
    request an arrival step, a tenant tag, and prompt/output lengths.
    `TenantClass` carries each tenant's own `ServingSLO`, priority and
    interactive/offline flag. Seeded synthetic generators produce Poisson
    (`poisson_trace`), Markov-modulated spike (`spike_trace`) and
    sinusoidal diurnal (`diurnal_trace`) arrival processes.

  * `trace_schedule(trace, slots, policy)` — the timed-arrival
    generalization of `serving.continuous_batch_schedule` (which is now
    its degenerate all-arrivals-at-t=0 FIFO case, property-tested
    bitwise-equal). Arrivals are indexed to the *decode-step clock*, so
    the discrete schedule — admission step, finish step, the ordered list
    of prefill events — depends only on (trace, slots, policy), never on
    the design; `trace_serving_metrics` then broadcasts wall-clock
    TTFT/TPOT/goodput over the candidate axis as pure array math, exactly
    core.serving's decomposition. Admission/routing policies are explicit:
    FIFO, strict priority, preempt-batch-for-interactive, and
    prefill/decode-disaggregated routing (scored through
    `heterogeneity.evaluate_hetero_trace_serving`'s coupled model).

  * `evaluate_trace_serving_batch` — registry-batched per-step evals
    (prefill, decode) composed with the shared schedule into per-tenant
    SLO goodput, plus *windowed* goodput: the trace's steps are cut into
    fixed windows and the worst window's interactive-tenant goodput is
    the spike-robustness objective campaigns search on
    (`explore.objectives.TraceServingObjective`, scenario
    ``"trace_serving"``). `PolicyDesign` pairs a design with a policy so
    the policy axis rides the search encoding next to the 13
    architecture dims.

The schedule semantics mirror `repro_torch.serve.engine.ServeEngine` with timed
submission (`submit_at`) and the same policies; `serve.engine.replay_trace`
replays a trace on a real engine and the admit/finish step counts are
cross-validated exactly in repro's tests/test_traces.py, as for t=0.

The port's own copy of `repro.core.traces` (imports rewritten; the port
imports nothing of `repro`). CPU parity against `repro`:
tests/test_torch_traces.py (the schedule, `replay_trace`) and
tests/test_torch_serving.py (the DSE half).
"""
from __future__ import annotations

import dataclasses
import heapq
import json
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.design_space import WSCDesign
from repro_torch.core.fidelity import FidelityBackend
from repro_torch.core.serving import ServingSLO
from repro_torch.core.workload import LLMWorkload, RequestMix

Fidelity = Union[str, FidelityBackend]

#: Admission/routing policies `trace_schedule` (and the campaign policy
#: axis) understand. "disaggregated" routes prefills to their own stage
#: (heterogeneity coupled model) instead of sharing the decode pool.
POLICIES = ("fifo", "priority", "preempt", "disaggregated")

#: The subset `trace_schedule` itself implements (shared decode pool).
POOL_POLICIES = ("fifo", "priority", "preempt")


# ---------------------------------------------------------------------------
# tenants + traces
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """One tenant sharing the wafer: its own SLO, an admission priority
    (higher wins under the priority/preempt policies) and whether it is
    interactive (chat-like; counts toward the worst-window objective and
    may preempt) or offline/batch (preemptible backfill)."""
    name: str
    ttft_s: float
    tpot_s: float
    priority: int = 0
    interactive: bool = True

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant needs a name")
        if self.ttft_s <= 0 or self.tpot_s <= 0:
            raise ValueError(f"tenant {self.name!r} SLO bounds must be > 0")

    def slo(self) -> ServingSLO:
        return ServingSLO(ttft_s=self.ttft_s, tpot_s=self.tpot_s)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d) -> "TenantClass":
        return cls(**dict(d))


DEFAULT_TENANT = TenantClass("default", ttft_s=5.0, tpot_s=0.05)


@dataclasses.dataclass(frozen=True)
class RequestTrace:
    """One replayable serving trace: per request an arrival step (on the
    decode-step clock — see `trace_schedule` for why that keeps the
    schedule design-independent), a tenant, and prompt/output lengths.

    Frozen + tuple fields: a trace is hashable (cache-keyable next to
    `LLMWorkload`) and round-trips through JSON. `arrival_steps` must be
    nondecreasing — request index order IS arrival order, which is what
    ties the FIFO policy, the engine replay and the t=0 degenerate case
    together.
    """
    arrival_steps: Tuple[int, ...]
    prompt_lens: Tuple[int, ...]
    out_lens: Tuple[int, ...]
    tenant_ids: Tuple[int, ...]
    tenants: Tuple[TenantClass, ...] = (DEFAULT_TENANT,)

    def __post_init__(self):
        object.__setattr__(self, "arrival_steps",
                           tuple(int(a) for a in self.arrival_steps))
        object.__setattr__(self, "prompt_lens",
                           tuple(int(p) for p in self.prompt_lens))
        object.__setattr__(self, "out_lens",
                           tuple(int(o) for o in self.out_lens))
        object.__setattr__(self, "tenant_ids",
                           tuple(int(t) for t in self.tenant_ids))
        object.__setattr__(self, "tenants", tuple(
            t if isinstance(t, TenantClass) else TenantClass.from_dict(t)
            for t in self.tenants))
        n = len(self.arrival_steps)
        if not n:
            raise ValueError("RequestTrace needs at least one request")
        if not (len(self.prompt_lens) == len(self.out_lens)
                == len(self.tenant_ids) == n):
            raise ValueError("trace fields must align "
                             f"(got {n}/{len(self.prompt_lens)}/"
                             f"{len(self.out_lens)}/{len(self.tenant_ids)})")
        if min(self.prompt_lens) < 1 or min(self.out_lens) < 1:
            raise ValueError("prompt/output lengths must be >= 1")
        if min(self.arrival_steps) < 0:
            raise ValueError("arrival steps must be >= 0")
        if any(a > b for a, b in zip(self.arrival_steps,
                                     self.arrival_steps[1:])):
            raise ValueError("arrival_steps must be nondecreasing "
                             "(request index order is arrival order)")
        if not self.tenants:
            raise ValueError("trace needs at least one tenant class")
        if min(self.tenant_ids) < 0 or \
                max(self.tenant_ids) >= len(self.tenants):
            raise ValueError(
                f"tenant_ids must index tenants (0..{len(self.tenants)-1})")

    # -- views -------------------------------------------------------------

    @property
    def n_requests(self) -> int:
        return len(self.arrival_steps)

    @property
    def mean_prompt(self) -> float:
        return float(np.mean(self.prompt_lens))

    @property
    def mean_out(self) -> float:
        return float(np.mean(self.out_lens))

    def total_out_tokens(self) -> int:
        return int(sum(self.out_lens))

    def context_len(self) -> int:
        """Representative mid-generation KV length (same convention as
        `RequestMix.context_len`)."""
        return max(1, int(round(self.mean_prompt + 0.5 * self.mean_out)))

    def tenant_of(self, r: int) -> TenantClass:
        return self.tenants[self.tenant_ids[r]]

    def priorities(self) -> np.ndarray:
        return np.array([t.priority for t in self.tenants],
                        np.int64)[np.array(self.tenant_ids, np.int64)]

    def interactive_mask(self) -> np.ndarray:
        """(R,) bool — requests from interactive tenants. Falls back to
        all-True when no tenant is marked interactive, so the windowed
        objective stays meaningful on single-class traces."""
        m = np.array([t.interactive for t in self.tenants],
                     bool)[np.array(self.tenant_ids, np.int64)]
        return m if m.any() else np.ones(self.n_requests, bool)

    def mix(self) -> RequestMix:
        """Drop arrival times/tenants: core.serving's one-batch view."""
        return RequestMix(self.prompt_lens, self.out_lens)

    @classmethod
    def from_mix(cls, mix: RequestMix,
                 tenant: TenantClass = DEFAULT_TENANT) -> "RequestTrace":
        """The degenerate trace: every request arrives at step 0 in queue
        order under one tenant — `continuous_batch_schedule`'s world."""
        n = mix.n_requests
        return cls((0,) * n, mix.prompt_lens, mix.out_lens, (0,) * n,
                   (tenant,))

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> Dict:
        return {
            "arrival_steps": list(self.arrival_steps),
            "prompt_lens": list(self.prompt_lens),
            "out_lens": list(self.out_lens),
            "tenant_ids": list(self.tenant_ids),
            "tenants": [t.to_dict() for t in self.tenants],
        }

    @classmethod
    def from_dict(cls, d) -> "RequestTrace":
        d = dict(d)
        d["tenants"] = tuple(TenantClass.from_dict(t)
                             for t in d.get("tenants", ()))
        return cls(**d)

    def to_json(self, path: Optional[str] = None, indent: int = 1) -> str:
        s = json.dumps(self.to_dict(), indent=indent)
        if path:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s

    @classmethod
    def from_json(cls, path_or_str: str) -> "RequestTrace":
        if path_or_str.lstrip().startswith("{"):
            return cls.from_dict(json.loads(path_or_str))
        with open(path_or_str) as f:
            return cls.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# seeded synthetic arrival-process generators
# ---------------------------------------------------------------------------


def _assemble(rng: np.random.Generator, steps: List[int],
              tenants: Sequence[TenantClass], shares: Sequence[float],
              prompt_ranges: Sequence[Tuple[int, int]],
              out_ranges: Sequence[Tuple[int, int]]) -> RequestTrace:
    tenants = tuple(tenants)
    n = len(steps)
    p = np.asarray(shares, np.float64)
    if len(p) != len(tenants) or (p <= 0).any():
        raise ValueError("tenant shares must be positive and align with "
                         "tenants")
    if not (len(prompt_ranges) == len(out_ranges) == len(tenants)):
        raise ValueError("prompt/out ranges must align with tenants")
    tid = rng.choice(len(tenants), size=n, p=p / p.sum())
    plen = np.empty(n, np.int64)
    olen = np.empty(n, np.int64)
    for k in range(len(tenants)):
        m = tid == k
        lo, hi = prompt_ranges[k]
        plen[m] = rng.integers(lo, hi + 1, int(m.sum()))
        lo, hi = out_ranges[k]
        olen[m] = rng.integers(lo, hi + 1, int(m.sum()))
    return RequestTrace(tuple(steps), tuple(int(x) for x in plen),
                        tuple(int(x) for x in olen),
                        tuple(int(x) for x in tid), tenants)


def _counts_to_steps(rng, n_requests: int, rate_at) -> List[int]:
    """Draw per-step Poisson arrival counts at `rate_at(step, state)` until
    n_requests have arrived; returns the per-request arrival steps."""
    steps: List[int] = []
    t = 0
    while len(steps) < n_requests:
        lam = max(float(rate_at(t)), 0.0)
        c = int(rng.poisson(lam)) if lam > 0 else 0
        steps.extend([t] * min(c, n_requests - len(steps)))
        t += 1
        if t > 100 * n_requests + 1_000_000:
            raise RuntimeError("arrival process generated (almost) no "
                               f"arrivals in {t} steps at rate {lam}")
    return steps


_ONE_TENANT = ((DEFAULT_TENANT,), (1.0,), ((256, 1024),), ((32, 128),))


def poisson_trace(n_requests: int, *, rate: float = 0.5,
                  tenants=None, shares=None, prompt_ranges=None,
                  out_ranges=None, seed: int = 0) -> RequestTrace:
    """Stationary Poisson arrivals at `rate` requests per decode step."""
    if rate <= 0:
        raise ValueError("rate must be > 0")
    rng = np.random.default_rng(seed)
    tn, sh, pr, orr = _tenant_defaults(tenants, shares, prompt_ranges,
                                       out_ranges)
    steps = _counts_to_steps(rng, n_requests, lambda t: rate)
    return _assemble(rng, steps, tn, sh, pr, orr)


def spike_trace(n_requests: int, *, rate: float = 0.25,
                spike_factor: float = 8.0, spike_len: int = 32,
                gap_len: int = 128, tenants=None, shares=None,
                prompt_ranges=None, out_ranges=None,
                seed: int = 0) -> RequestTrace:
    """Markov-modulated (bursty) arrivals: a two-state process alternates
    between a base rate and a `spike_factor`x spike rate, with expected
    spike/gap durations `spike_len`/`gap_len` steps — the 10x-load-spike
    scenario the worst-window objective is built for."""
    if rate <= 0 or spike_factor < 1 or spike_len < 1 or gap_len < 1:
        raise ValueError("spike trace needs rate>0, spike_factor>=1, "
                         "spike_len/gap_len >= 1")
    rng = np.random.default_rng(seed)
    tn, sh, pr, orr = _tenant_defaults(tenants, shares, prompt_ranges,
                                       out_ranges)
    state = {"spike": False}

    def rate_at(t):
        # transition first so the rng stream is one draw per step
        flip = rng.random() < (1.0 / spike_len if state["spike"]
                               else 1.0 / gap_len)
        if flip:
            state["spike"] = not state["spike"]
        return rate * (spike_factor if state["spike"] else 1.0)

    steps = _counts_to_steps(rng, n_requests, rate_at)
    return _assemble(rng, steps, tn, sh, pr, orr)


def diurnal_trace(n_requests: int, *, rate: float = 0.5,
                  period: int = 512, amplitude: float = 0.9,
                  tenants=None, shares=None, prompt_ranges=None,
                  out_ranges=None, seed: int = 0) -> RequestTrace:
    """Sinusoidal-rate arrivals: rate(t) = rate * (1 + amplitude *
    sin(2*pi*t/period)), clipped at 0 — long low-load troughs between
    peaks (the event-skip scheduler's fast path)."""
    if rate <= 0 or period < 2 or not (0.0 <= amplitude <= 1.0):
        raise ValueError("diurnal trace needs rate>0, period>=2, "
                         "0<=amplitude<=1")
    rng = np.random.default_rng(seed)
    tn, sh, pr, orr = _tenant_defaults(tenants, shares, prompt_ranges,
                                       out_ranges)
    w = 2.0 * np.pi / period
    steps = _counts_to_steps(
        rng, n_requests, lambda t: rate * (1.0 + amplitude * np.sin(w * t)))
    return _assemble(rng, steps, tn, sh, pr, orr)


def _tenant_defaults(tenants, shares, prompt_ranges, out_ranges):
    if tenants is None:
        return _ONE_TENANT
    tenants = tuple(tenants)
    if shares is None:
        shares = (1.0,) * len(tenants)
    if prompt_ranges is None:
        prompt_ranges = ((256, 1024),) * len(tenants)
    if out_ranges is None:
        out_ranges = ((32, 128),) * len(tenants)
    return tenants, tuple(shares), tuple(prompt_ranges), tuple(out_ranges)


_GENERATORS = {"poisson": poisson_trace, "spike": spike_trace,
               "diurnal": diurnal_trace}


def synth_trace(kind: str, n_requests: int, seed: int = 0,
                **kw) -> RequestTrace:
    """Dispatch on generator kind ("poisson" | "spike" | "diurnal")."""
    if kind not in _GENERATORS:
        raise ValueError(f"unknown trace kind {kind!r}; expected one of "
                         f"{tuple(_GENERATORS)}")
    return _GENERATORS[kind](n_requests, seed=seed, **kw)


# ---------------------------------------------------------------------------
# the timed, policy-aware discrete schedule
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TraceSchedule:
    """Design-independent discrete schedule of a trace under `slots` decode
    slots and an admission policy. Arrivals are indexed to the decode-step
    clock (request r becomes visible at the start of step
    ``arrival_steps[r]``), so which step each request is admitted/finishes
    at — and the ordered list of prefill events — is a pure function of
    (trace, slots, policy): the candidate axis only enters through step
    *times*, in `trace_serving_metrics`. Idle steps (no live slot) tick
    the clock but are counted separately (`n_steps` vs `n_decode_steps`)
    so they cost wall-clock, not decode energy."""
    slots: int
    policy: str
    n_steps: int                  # total clock ticks until the last finish
    n_decode_steps: int           # ticks with >= 1 live slot
    admit_step: np.ndarray        # (R,) step of FIRST admission
    finish_step: np.ndarray      # (R,) step at whose end r completes
    decode_tokens: np.ndarray     # (R,) decode ticks r occupies in total
    n_preemptions: int
    # prefill events in admission order (step nondecreasing): every
    # admission — fresh or post-preemption resume — prefills `event_ctx`
    # tokens (prompt, or prompt + generated-so-far on resume)
    event_step: np.ndarray        # (E,)
    event_req: np.ndarray         # (E,)
    event_ctx: np.ndarray         # (E,)
    first_event: np.ndarray       # (R,) index of r's first admission event


def _policy_key(policy: str, arrival, prio):
    if policy == "fifo":
        return lambda r: (arrival[r], r)
    return lambda r: (-prio[r], arrival[r], r)


def trace_schedule(trace: RequestTrace, slots: int,
                   policy: str = "fifo") -> TraceSchedule:
    """Event-skipping scheduler: between arrivals and slot completions the
    pool state only counts down, so whole quiescent stretches are jumped
    in O(1) instead of ticked O(steps x slots) — a 10k-request diurnal
    trace (long idle troughs) schedules in well under a second while
    staying bitwise-identical to the per-step reference loop
    (`_trace_schedule_ref`, property-tested).

    Per-step semantics (mirrored exactly by `ServeEngine` with timed
    submission): at the start of step t, requests with arrival <= t are
    eligible, ordered by the policy key (FIFO: arrival then index;
    priority/preempt: tenant priority desc, then arrival, then index).
    Eligible requests fill free slots in order; under "preempt" the
    remaining eligible may then evict the most-recently-admitted active
    offline (non-interactive) request of strictly lower priority — the
    victim keeps its generated tokens and re-prefills on re-admission.
    Each live slot then decodes one token; requests finish at the step
    where their decode-token budget is spent.
    """
    if slots < 1:
        raise ValueError("slots must be >= 1")
    if policy not in POOL_POLICIES:
        raise ValueError(f"trace_schedule policy {policy!r} not in "
                         f"{POOL_POLICIES} (use the heterogeneity path "
                         "for 'disaggregated')")
    R = trace.n_requests
    arrival = np.asarray(trace.arrival_steps, np.int64)
    out = np.asarray(trace.out_lens, np.int64)
    decode_tokens = np.maximum(out - 1, 1)
    prio = trace.priorities()
    inter = np.array([t.interactive for t in trace.tenants],
                     bool)[np.array(trace.tenant_ids, np.int64)]
    key = _policy_key(policy, arrival, prio)

    admit_step = np.full(R, -1, np.int64)
    finish_step = np.full(R, -1, np.int64)
    remaining = decode_tokens.copy()
    ev_step: List[int] = []
    ev_req: List[int] = []
    ev_ctx: List[int] = []
    first_event = np.full(R, -1, np.int64)

    heap: List[Tuple] = []            # (key, rid) of waiting requests
    active: Dict[int, int] = {}       # slot -> rid
    slot_event: Dict[int, int] = {}   # slot -> admission event index
    free = list(range(slots - 1, -1, -1))   # pop() yields lowest index
    nxt = 0                           # arrival pointer
    t = 0
    n_decode = 0
    n_preempt = 0
    n_done = 0

    def emit(rid: int) -> int:
        e = len(ev_step)
        ev_step.append(t)
        ev_req.append(rid)
        ctx = trace.prompt_lens[rid]
        if admit_step[rid] < 0:
            admit_step[rid] = t
            first_event[rid] = e
        else:
            # resume: re-prefill prompt + everything generated so far
            # (first token + survived decode ticks)
            ctx += 1 + int(decode_tokens[rid] - remaining[rid])
        ev_ctx.append(int(ctx))
        return e

    while n_done < R:
        while nxt < R and arrival[nxt] <= t:
            heapq.heappush(heap, (key(nxt), nxt))
            nxt += 1
        evicted_now: List[Tuple] = []
        while heap and free:
            _, rid = heapq.heappop(heap)
            s = free.pop()
            active[s] = rid
            slot_event[s] = emit(rid)
        if policy == "preempt":
            while heap:
                k, rid = heap[0]
                victims = [s for s, v in active.items()
                           if not inter[v] and prio[v] < prio[rid]]
                if not victims:
                    break
                heapq.heappop(heap)
                s = max(victims, key=lambda s: slot_event[s])
                # victim keeps progress, rejoins the waiting set — but not
                # before the next step (no same-step re-admission)
                evicted_now.append((key(active[s]), active[s]))
                n_preempt += 1
                active[s] = rid
                slot_event[s] = emit(rid)
        for item in evicted_now:
            heapq.heappush(heap, item)
        if active:
            n_decode += 1
            for s in list(active):
                rid = active[s]
                remaining[rid] -= 1
                if remaining[rid] == 0:
                    finish_step[rid] = t
                    n_done += 1
                    del active[s]
                    del slot_event[s]
                    free.append(s)
            free.sort(reverse=True)
        t += 1
        if n_done >= R:
            break
        # --- event skip: nothing can change until the next arrival or the
        # next slot completion, provided no admission/eviction is possible
        # right now (free slot + waiter, or — for preempt — a waiter that
        # can evict; evicted_now waiters only became eligible this tick,
        # so a nonempty eviction round never skips)
        can_admit = bool(heap) and (bool(free) or (
            policy == "preempt" and any(
                not inter[v] and prio[v] < -heap[0][0][0]
                for v in active.values())))
        if can_admit or evicted_now:
            continue
        horizon = []
        if nxt < R:
            horizon.append(int(arrival[nxt]))
        if active:
            horizon.append(t + int(min(remaining[r]
                                       for r in active.values()) - 1))
        if not horizon:
            continue
        jump = max(horizon[0] if nxt >= R or not active
                   else min(horizon), t)
        dt = jump - t
        if dt > 0 and active:
            # bulk decode: no slot finishes strictly before `jump`
            n_decode += dt
            for rid in active.values():
                remaining[rid] -= dt
        t = jump

    n_steps = int(finish_step.max()) + 1
    return TraceSchedule(
        slots=slots, policy=policy, n_steps=n_steps,
        n_decode_steps=n_decode, admit_step=admit_step,
        finish_step=finish_step, decode_tokens=decode_tokens,
        n_preemptions=n_preempt,
        event_step=np.asarray(ev_step, np.int64),
        event_req=np.asarray(ev_req, np.int64),
        event_ctx=np.asarray(ev_ctx, np.int64),
        first_event=first_event)


def _trace_schedule_ref(trace: RequestTrace, slots: int,
                        policy: str = "fifo") -> TraceSchedule:
    """Per-step reference loop — the semantic spec `trace_schedule` must
    reproduce bitwise (and the loop `ServeEngine._admit`/`step` mirror).
    O(steps x slots); kept for property tests."""
    if slots < 1:
        raise ValueError("slots must be >= 1")
    if policy not in POOL_POLICIES:
        raise ValueError(f"trace_schedule policy {policy!r} not in "
                         f"{POOL_POLICIES}")
    R = trace.n_requests
    arrival = np.asarray(trace.arrival_steps, np.int64)
    decode_tokens = np.maximum(np.asarray(trace.out_lens, np.int64) - 1, 1)
    prio = trace.priorities()
    inter = np.array([t.interactive for t in trace.tenants],
                     bool)[np.array(trace.tenant_ids, np.int64)]
    key = _policy_key(policy, arrival, prio)

    admit_step = np.full(R, -1, np.int64)
    finish_step = np.full(R, -1, np.int64)
    remaining = decode_tokens.copy()
    ev_step, ev_req, ev_ctx = [], [], []
    first_event = np.full(R, -1, np.int64)
    waiting: List[int] = []
    active: Dict[int, int] = {}
    slot_event: Dict[int, int] = {}
    nxt = 0
    t = 0
    n_decode = 0
    n_preempt = 0

    def emit(rid):
        e = len(ev_step)
        ev_step.append(t)
        ev_req.append(rid)
        ctx = trace.prompt_lens[rid]
        if admit_step[rid] < 0:
            admit_step[rid] = t
            first_event[rid] = e
        else:
            ctx += 1 + int(decode_tokens[rid] - remaining[rid])
        ev_ctx.append(int(ctx))
        return e

    while nxt < R or waiting or active:
        while nxt < R and arrival[nxt] <= t:
            waiting.append(nxt)
            nxt += 1
        elig = sorted(waiting, key=key)
        for rid in list(elig):
            s = next((s for s in range(slots) if s not in active), None)
            if s is None:
                break
            elig.remove(rid)
            waiting.remove(rid)
            active[s] = rid
            slot_event[s] = emit(rid)
        if policy == "preempt":
            for rid in elig:
                victims = [s for s, v in active.items()
                           if not inter[v] and prio[v] < prio[rid]]
                if not victims:
                    continue
                s = max(victims, key=lambda s: slot_event[s])
                waiting.append(active[s])
                n_preempt += 1
                waiting.remove(rid)
                active[s] = rid
                slot_event[s] = emit(rid)
        if active:
            n_decode += 1
            for s in list(active):
                rid = active[s]
                remaining[rid] -= 1
                if remaining[rid] == 0:
                    finish_step[rid] = t
                    del active[s]
                    del slot_event[s]
        t += 1

    return TraceSchedule(
        slots=slots, policy=policy, n_steps=int(finish_step.max()) + 1,
        n_decode_steps=n_decode, admit_step=admit_step,
        finish_step=finish_step, decode_tokens=decode_tokens,
        n_preemptions=n_preempt,
        event_step=np.asarray(ev_step, np.int64),
        event_req=np.asarray(ev_req, np.int64),
        event_ctx=np.asarray(ev_ctx, np.int64),
        first_event=first_event)


# ---------------------------------------------------------------------------
# wall-clock metrics: schedule x candidate-axis step times (array math)
# ---------------------------------------------------------------------------


def _prefill_before(cum_p: np.ndarray, event_step: np.ndarray,
                    steps: np.ndarray, inclusive: bool) -> np.ndarray:
    """(C, len(steps)) prefill seconds of events with step < k (or <= k
    when inclusive), for each queried step k."""
    side = "right" if inclusive else "left"
    idx = np.searchsorted(event_step, steps, side=side)
    padded = np.concatenate(
        [np.zeros((cum_p.shape[0], 1)), cum_p], axis=1)
    return padded[:, idx]


def trace_serving_metrics(sched: TraceSchedule, trace: RequestTrace,
                          t_prefill_ref: np.ndarray, prompt_ref: int,
                          t_decode: np.ndarray,
                          window_steps: int = 64) -> Dict[str, np.ndarray]:
    """Broadcast wall-clock metrics over the candidate axis, as core.serving does:
    the step clock is the time base (every tick — decode or idle — costs
    one decode-step time; admission prefills serialize at step starts), so
    everything is affine in the per-candidate (t_prefill_ref, t_decode)
    pair and evaluates as pure array math. Per-request SLOs come from each
    request's tenant; `window_steps`-wide windows over the step axis give
    the worst-window interactive goodput (spike robustness)."""
    if window_steps < 1:
        raise ValueError("window_steps must be >= 1")
    tp = np.asarray(t_prefill_ref, np.float64).reshape(-1, 1)
    td = np.asarray(t_decode, np.float64).reshape(-1, 1)
    C = tp.shape[0]
    R = trace.n_requests

    p_ev = tp * sched.event_ctx[None, :] / max(prompt_ref, 1)   # (C, E)
    cum_p = np.cumsum(p_ev, axis=1)

    arrival = np.asarray(trace.arrival_steps, np.int64)
    arr_wall = arrival[None, :] * td + _prefill_before(
        cum_p, sched.event_step, arrival, inclusive=False)
    e0 = sched.first_event
    first_token = sched.event_step[e0][None, :] * td + cum_p[:, e0]
    ttft = first_token - arr_wall

    fin = sched.finish_step
    completion = (fin[None, :] + 1) * td + _prefill_before(
        cum_p, sched.event_step, fin, inclusive=True)
    tpot = (completion - first_token) \
        / np.maximum(sched.decode_tokens[None, :], 1)

    total_time = sched.n_steps * td[:, 0] + cum_p[:, -1]
    out_toks = np.asarray(trace.out_lens, np.float64)[None, :]

    b_ttft = np.array([t.ttft_s for t in trace.tenants])[
        np.array(trace.tenant_ids, np.int64)][None, :]
    b_tpot = np.array([t.tpot_s for t in trace.tenants])[
        np.array(trace.tenant_ids, np.int64)][None, :]
    met = (ttft <= b_ttft) & (tpot <= b_tpot)

    inter = trace.interactive_mask()[None, :]
    goodput = (out_toks * met).sum(axis=1) / np.maximum(total_time, 1e-12)
    inter_good = (out_toks * met * inter).sum(axis=1) \
        / np.maximum(total_time, 1e-12)

    # windowed goodput: cut the step axis into fixed windows; a request's
    # tokens land in the window containing its finish step, the window's
    # wall duration is its ticks plus the prefill seconds inside it, and
    # only windows with interactive demand (an interactive request
    # arrived/unfinished in the window) count toward the worst-window min
    W = max(1, -(-sched.n_steps // window_steps))
    win_good = np.zeros((C, W))
    pending = np.zeros(W, bool)
    inter_r = trace.interactive_mask()
    for w in range(W):
        w0, w1 = w * window_steps, min((w + 1) * window_steps, sched.n_steps)
        dur = (w1 - w0) * td[:, 0] + (
            _prefill_before(cum_p, sched.event_step,
                            np.array([w1 - 1]), True)
            - _prefill_before(cum_p, sched.event_step,
                              np.array([w0]), False))[:, 0]
        in_w = (fin >= w0) & (fin < w1)
        win_good[:, w] = (out_toks * met * (inter_r & in_w)[None, :]) \
            .sum(axis=1) / np.maximum(dur, 1e-12)
        pending[w] = bool(np.any(inter_r & (arrival < w1) & (fin >= w0)))
    worst = (win_good[:, pending].min(axis=1) if pending.any()
             else inter_good)

    return {
        "ttft": ttft, "tpot": tpot, "met": met,
        "total_time": total_time,
        "throughput": out_toks.sum() / np.maximum(total_time, 1e-12),
        "goodput": goodput,
        "interactive_goodput": inter_good,
        "window_goodput": win_good,
        "window_pending": pending,
        "worst_window_goodput": worst,
        "slo_attainment": met.mean(axis=1),
    }


# ---------------------------------------------------------------------------
# disaggregated (prefill/decode split) coupled model with timed arrivals
# ---------------------------------------------------------------------------


def trace_disaggregated_metrics(trace: RequestTrace, slots: int,
                                t_prefill: np.ndarray, kv_s: np.ndarray,
                                t_decode: float,
                                window_steps: int = 64) -> Dict[str, float]:
    """Timed-arrival generalization of `serving.disaggregated_metrics`
    (one candidate at a time — the stage split makes the schedule
    design-dependent, so this is the coupled continuous-time model):
    prompts prefill serially on their own stage in priority-then-arrival
    order as they arrive (arrival r = ``arrival_steps[r] * t_decode`` on
    the shared step clock), the KV cache ships to the decode stage, and a
    request joins the decode pool when its KV has landed and a slot is
    free — decode never stalls for prefills. Per-tenant SLOs; windows are
    ``window_steps * t_decode`` seconds wide."""
    if slots < 1:
        raise ValueError("slots must be >= 1")
    R = trace.n_requests
    arrival_s = np.asarray(trace.arrival_steps, np.float64) * t_decode
    t_p = np.asarray(t_prefill, np.float64)
    kv = np.broadcast_to(np.asarray(kv_s, np.float64), (R,))
    prio = trace.priorities()

    # -- prefill stage: single server, priority-then-arrival order -------
    order = sorted(range(R), key=lambda r: (arrival_s[r],))
    done = np.zeros(R)
    clock = 0.0
    served = np.zeros(R, bool)
    pending: List[Tuple] = []
    i = 0
    for _ in range(R):
        while i < R and arrival_s[order[i]] <= clock + 1e-12:
            r = order[i]
            heapq.heappush(pending, ((-prio[r], arrival_s[r], r), r))
            i += 1
        if not pending:
            clock = arrival_s[order[i]]
            continue
        _, r = heapq.heappop(pending)
        clock = max(clock, arrival_s[r]) + t_p[r]
        done[r] = clock
        served[r] = True
    for _, r in pending:                     # drain any stragglers
        clock = max(clock, arrival_s[r]) + t_p[r]
        done[r] = clock
    ttft = done - arrival_s
    ready = done + kv

    # -- decode pool: admit by (priority, ready) when a slot frees -------
    dtoks = np.maximum(np.asarray(trace.out_lens, np.int64) - 1, 1)
    completion = np.zeros(R)
    active: Dict[int, List[int]] = {}
    admitted = np.zeros(R, bool)
    t = 0.0
    n_steps = 0
    n_fin = 0
    while n_fin < R:
        while len(active) < slots:
            cand = [r for r in range(R)
                    if not admitted[r] and ready[r] <= t + 1e-12]
            if not cand:
                break
            r = min(cand, key=lambda r: (-prio[r], ready[r], r))
            slot = next(s for s in range(slots) if s not in active)
            active[slot] = [r, int(dtoks[r])]
            admitted[r] = True
        if not active:
            t = float(min(ready[r] for r in range(R) if not admitted[r]))
            continue
        t += t_decode
        n_steps += 1
        for slot in list(active):
            active[slot][1] -= 1
            if active[slot][1] == 0:
                completion[active[slot][0]] = t
                n_fin += 1
                del active[slot]
    tpot = (completion - done) / dtoks
    total_time = float(max(completion.max(), done.max()))

    out_toks = np.asarray(trace.out_lens, np.float64)
    b_ttft = np.array([tc.ttft_s for tc in trace.tenants])[
        np.array(trace.tenant_ids, np.int64)]
    b_tpot = np.array([tc.tpot_s for tc in trace.tenants])[
        np.array(trace.tenant_ids, np.int64)]
    met = (ttft <= b_ttft) & (tpot <= b_tpot)
    inter = trace.interactive_mask()

    win_s = max(window_steps, 1) * t_decode
    W = max(1, int(np.ceil(total_time / max(win_s, 1e-12))))
    worst = None
    inter_good = float((out_toks * met * inter).sum()
                       / max(total_time, 1e-12))
    for w in range(W):
        w0, w1 = w * win_s, (w + 1) * win_s
        if not np.any(inter & (arrival_s < w1) & (completion >= w0)):
            continue
        g = float((out_toks * met * inter
                   * ((completion >= w0) & (completion < w1))).sum()
                  / max(w1 - w0, 1e-12))
        worst = g if worst is None else min(worst, g)
    if worst is None:
        worst = inter_good

    return {
        "ttft_s": float(ttft.mean()), "ttft_max_s": float(ttft.max()),
        "tpot_s": float(tpot.mean()), "tpot_max_s": float(tpot.max()),
        "total_time_s": total_time,
        "n_steps": n_steps, "n_decode_steps": n_steps,
        "throughput_tok_s": float(out_toks.sum() / max(total_time, 1e-12)),
        "goodput_tok_s": float((out_toks * met).sum()
                               / max(total_time, 1e-12)),
        "interactive_goodput_tok_s": inter_good,
        "worst_window_goodput_tok_s": float(worst),
        "slo_attainment": float(met.mean()),
        "met": met, "ttft": ttft, "tpot": tpot,
    }


# ---------------------------------------------------------------------------
# design evaluation: per-step evals (fidelity registry) -> trace metrics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PolicyDesign:
    """One (architecture, admission policy) search point — the policy axis
    of a ``"trace_serving"`` campaign, riding next to the 13 architecture
    dims the way `JointDesign` carries a pinned Strategy."""
    design: WSCDesign
    policy: str

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"policy {self.policy!r} not in {POLICIES}")

    def describe(self) -> str:
        return f"{self.design.describe()} | policy={self.policy}"


def sample_policy_candidates(rng: np.random.Generator, n: int,
                             policies: Sequence[str] = POLICIES,
                             max_tries: int = 8
                             ) -> Tuple[np.ndarray, List[PolicyDesign]]:
    """`mfmobo._valid_candidates` with one extra unit-cube column decoding
    to an admission policy: returns ((n, 14) encoded points, PolicyDesigns)
    — campaigns with a searched policy axis install this as the
    exploration loop's candidate_fn."""
    from repro_torch.core.design_space import decode_batch, sample
    from repro_torch.core.validator import validate_batch

    policies = tuple(policies)
    if not policies or any(p not in POLICIES for p in policies):
        raise ValueError(f"policies must be a nonempty subset of {POLICIES} "
                         f"(got {policies})")
    xs, ds = [], []
    n_drawn = 0
    for _ in range(max_tries):
        us = sample(rng, n)
        up = rng.random((n, 1))
        n_drawn += len(us)
        for u, p, r in zip(us, up[:, 0], validate_batch(decode_batch(us))):
            if r.ok:
                xs.append(np.concatenate([u, [p]]))
                k = min(int(p * len(policies)), len(policies) - 1)
                ds.append(PolicyDesign(r.design, policies[k]))
            if len(xs) >= n:
                return np.array(xs), ds
    rate = len(xs) / max(n_drawn, 1)
    raise RuntimeError(
        f"policy-space sampling produced only {len(xs)}/{n} valid "
        f"candidates after {max_tries} rounds (acceptance rate {rate:.1%})")


@dataclasses.dataclass
class TraceServingResult:
    feasible: bool
    policy: str
    goodput_tok_s: float
    interactive_goodput_tok_s: float
    worst_window_goodput_tok_s: float
    throughput_tok_s: float
    ttft_s: float                 # mean over requests
    ttft_max_s: float
    tpot_s: float
    tpot_max_s: float
    slo_attainment: float
    total_time_s: float
    n_steps: int
    n_decode_steps: int
    n_preemptions: int
    power_w: float
    energy_j: float
    n_wafers: int
    per_tenant: Dict[str, Dict[str, float]]
    reason: str = ""


def trace_serving_workloads(wl_base: LLMWorkload, trace: RequestTrace,
                            slots: int
                            ) -> Tuple[LLMWorkload, LLMWorkload, int]:
    """The two per-step workloads trace serving composes — identical
    convention to `serving.serving_workloads`, sized from the trace."""
    p_ref = max(1, int(round(trace.mean_prompt)))
    wl_p = dataclasses.replace(wl_base, phase="prefill", batch=1, seq=p_ref)
    wl_d = dataclasses.replace(wl_base, phase="decode", batch=slots,
                               seq=trace.context_len())
    return wl_p, wl_d, p_ref


def _infeasible(policy: str, nw: int, reason: str) -> TraceServingResult:
    return TraceServingResult(
        feasible=False, policy=policy, goodput_tok_s=0.0,
        interactive_goodput_tok_s=0.0, worst_window_goodput_tok_s=0.0,
        throughput_tok_s=0.0, ttft_s=float("inf"), ttft_max_s=float("inf"),
        tpot_s=float("inf"), tpot_max_s=float("inf"), slo_attainment=0.0,
        total_time_s=float("inf"), n_steps=0, n_decode_steps=0,
        n_preemptions=0, power_w=float("inf"), energy_j=0.0, n_wafers=nw,
        per_tenant={}, reason=reason)


def _per_tenant(trace: RequestTrace, met: np.ndarray, ttft: np.ndarray,
                tpot: np.ndarray, total_time: float) -> Dict[str, Dict]:
    out = {}
    tids = np.array(trace.tenant_ids, np.int64)
    toks = np.asarray(trace.out_lens, np.float64)
    for k, tc in enumerate(trace.tenants):
        m = tids == k
        if not m.any():
            continue
        out[tc.name] = {
            "n_requests": int(m.sum()),
            "goodput_tok_s": float((toks[m] * met[m]).sum()
                                   / max(total_time, 1e-12)),
            "slo_attainment": float(met[m].mean()),
            "ttft_s": float(ttft[m].mean()),
            "tpot_s": float(tpot[m].mean()),
        }
    return out


_SCHED_CACHE: Dict[Tuple, TraceSchedule] = {}


def _schedule_cached(trace: RequestTrace, slots: int,
                     policy: str) -> TraceSchedule:
    key = (trace, slots, policy)
    if key not in _SCHED_CACHE:
        if len(_SCHED_CACHE) > 64:
            _SCHED_CACHE.clear()
        _SCHED_CACHE[key] = trace_schedule(trace, slots, policy)
    return _SCHED_CACHE[key]


def evaluate_trace_serving_batch(
        designs: Sequence[Union[WSCDesign, PolicyDesign]],
        wl_base: LLMWorkload, trace: RequestTrace, *, slots: int = 8,
        policy: str = "fifo", window_steps: int = 64,
        prefill_ratio: float = 0.5, fidelity: Fidelity = "analytical",
        gnn_params: Optional[Dict] = None, n_wafers=None,
        max_strategies: int = 24) -> List[TraceServingResult]:
    """Trace-driven serving metrics for N candidates. Candidates are
    `WSCDesign`s (scored under `policy`) or `PolicyDesign`s (each scored
    under its own policy — the searched axis). Pool policies share one
    design-independent `trace_schedule` per policy and broadcast
    `trace_serving_metrics` over the candidate axis; "disaggregated"
    routes through `heterogeneity.evaluate_hetero_trace_serving`'s coupled
    prefill/decode-split model (reticle granularity, `prefill_ratio`)."""
    from repro_torch.core.evaluator import evaluate_design_batch
    from repro_torch.core.fidelity import get_backend

    backend = get_backend(fidelity)
    designs = list(designs)
    if not designs:
        return []
    raw: List[WSCDesign] = []
    pols: List[str] = []
    for d in designs:
        if isinstance(d, PolicyDesign):
            raw.append(d.design)
            pols.append(d.policy)
        else:
            raw.append(d)
            pols.append(policy)
    for p in pols:
        if p not in POLICIES:
            raise ValueError(f"policy {p!r} not in {POLICIES}")

    results: List[Optional[TraceServingResult]] = [None] * len(designs)

    # ---- disaggregated candidates: coupled split model, per design -----
    dis = [i for i, p in enumerate(pols) if p == "disaggregated"]
    if dis:
        from repro_torch.core.heterogeneity import evaluate_hetero_trace_serving
        for i in dis:
            results[i] = evaluate_hetero_trace_serving(
                raw[i], raw[i], wl_base, "reticle", prefill_ratio, trace,
                slots=slots, window_steps=window_steps, n_wafers=n_wafers,
                fidelity=backend, gnn_params=gnn_params)

    # ---- pool candidates: shared schedule per policy, broadcast math ---
    pool = [i for i, p in enumerate(pols) if p != "disaggregated"]
    if not pool:
        return results                      # type: ignore[return-value]
    wl_p, wl_d, p_ref = trace_serving_workloads(wl_base, trace, slots)
    rps = evaluate_design_batch([raw[i] for i in pool], wl_p,
                                fidelity=backend, gnn_params=gnn_params,
                                n_wafers=n_wafers,
                                max_strategies=max_strategies)
    rds = evaluate_design_batch([raw[i] for i in pool], wl_d,
                                fidelity=backend, gnn_params=gnn_params,
                                n_wafers=n_wafers,
                                max_strategies=max_strategies)
    for pol in sorted({pols[i] for i in pool}):
        grp = [j for j, i in enumerate(pool) if pols[i] == pol]
        feas = [j for j in grp if rps[j].feasible and rds[j].feasible]
        for j in grp:
            if j not in feas:
                reason = ("prefill_" if not rps[j].feasible else
                          "decode_") + "infeasible"
                results[pool[j]] = _infeasible(pol, rps[j].n_wafers, reason)
        if not feas:
            continue
        sched = _schedule_cached(trace, slots, pol)
        t_p = np.array([rps[j].step.step_time_s for j in feas])
        t_d = np.array([rds[j].step.step_time_s for j in feas])
        e_p = np.array([rps[j].step.energy_j for j in feas])
        e_d = np.array([rds[j].step.energy_j for j in feas])
        m = trace_serving_metrics(sched, trace, t_p, p_ref, t_d,
                                  window_steps=window_steps)
        # energy: each prefill event costs its context-scaled share of the
        # reference prefill step; each decode tick costs the batched
        # decode step (idle ticks cost wall-clock only)
        ctx_sum = float(np.sum(sched.event_ctx))
        energy = e_p * ctx_sum / p_ref + e_d * sched.n_decode_steps
        power = energy / np.maximum(m["total_time"], 1e-12)
        for c, j in enumerate(feas):
            results[pool[j]] = TraceServingResult(
                feasible=True, policy=pol,
                goodput_tok_s=float(m["goodput"][c]),
                interactive_goodput_tok_s=float(
                    m["interactive_goodput"][c]),
                worst_window_goodput_tok_s=float(
                    m["worst_window_goodput"][c]),
                throughput_tok_s=float(m["throughput"][c]),
                ttft_s=float(m["ttft"][c].mean()),
                ttft_max_s=float(m["ttft"][c].max()),
                tpot_s=float(m["tpot"][c].mean()),
                tpot_max_s=float(m["tpot"][c].max()),
                slo_attainment=float(m["slo_attainment"][c]),
                total_time_s=float(m["total_time"][c]),
                n_steps=sched.n_steps,
                n_decode_steps=sched.n_decode_steps,
                n_preemptions=sched.n_preemptions,
                power_w=float(power[c]), energy_j=float(energy[c]),
                n_wafers=rds[j].n_wafers,
                per_tenant=_per_tenant(trace, m["met"][c], m["ttft"][c],
                                       m["tpot"][c],
                                       float(m["total_time"][c])))
    return results                          # type: ignore[return-value]


def evaluate_trace_serving(design, wl_base: LLMWorkload,
                           trace: RequestTrace, **kw) -> TraceServingResult:
    """Scalar wrapper: `evaluate_trace_serving_batch` with a batch of
    one."""
    return evaluate_trace_serving_batch([design], wl_base, trace, **kw)[0]


__all__ = [
    "DEFAULT_TENANT", "POLICIES", "POOL_POLICIES", "PolicyDesign",
    "RequestTrace", "TenantClass", "TraceSchedule", "TraceServingResult",
    "diurnal_trace", "evaluate_trace_serving",
    "evaluate_trace_serving_batch", "poisson_trace",
    "sample_policy_candidates", "spike_trace", "synth_trace",
    "trace_disaggregated_metrics", "trace_schedule",
    "trace_serving_metrics", "trace_serving_workloads",
]
