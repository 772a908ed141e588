"""Trace-driven multi-tenant serving: the NumPy part that serving needs
(the port's own copy of `repro.core.traces`, which the port does not
import).

  * `RequestTrace` — a frozen, hashable, JSON-round-trippable trace: per
    request an arrival step, a tenant tag, and prompt/output lengths.
    `TenantClass` carries each tenant's SLO bounds, priority and
    interactive/offline flag. Seeded synthetic generators produce Poisson
    (`poisson_trace`), Markov-modulated spike (`spike_trace`) and
    sinusoidal diurnal (`diurnal_trace`) arrival processes; `synth_trace`
    dispatches on the kind.

  * `trace_schedule(trace, slots, policy)` — the design-independent
    discrete schedule of a trace on the decode-step clock (admission step,
    finish step, preemptions, the ordered prefill events) under FIFO,
    strict priority or preempt-batch-for-interactive admission.
    `serve.engine.replay_trace` replays a trace on a real engine, whose
    admit/finish steps equal this schedule's bit for bit.

`repro`'s trace-to-workload views (`TenantClass.slo`, `RequestTrace.mix`,
`RequestTrace.from_mix`, the length summaries `mean_prompt`, `mean_out`,
`total_out_tokens` and `context_len`) and its DSE scoring of a schedule
(`trace_serving_metrics`, the disaggregated model, `PolicyDesign`,
`evaluate_trace_serving*`) are not part of this copy: they need the
serving and workload models of the DSE loop.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

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
    (`repro.core.traces._trace_schedule_ref`, property-tested there).

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
