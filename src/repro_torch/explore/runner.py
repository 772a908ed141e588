"""Resumable exploration loop — the campaign-grade home of Algorithm 1.

The MFMOBO / MOBO / random-search loops that used to live inline in
`repro_torch.core.mfmobo.run_*` are restructured here as an explicit state
machine: `LoopConfig` (strategy + budgets + schedule, validated up front so
budget-overshooting configurations fail loudly) drives `step()` transitions
over a picklable `LoopState` (the rng generator, the GP training sets, the
trace, the schedule position). The optimizer hot path (GP refit, greedy
q-EHVI acquisition — DESIGN.md §10) is a pure function of
that host-side state: LoopState holds only NumPy arrays / Python scalars,
never device buffers or fitted GPs. Because the surrogates are *refit from
the training set every iteration* (deterministically — fixed init, one
Adam loop), the state is tiny and a checkpoint written at any step
boundary resumes bit-identically: the continuation consumes the identical
rng stream and refits the identical models, so a resumed trace equals the
uninterrupted one at a fixed seed (pinned by tests/test_torch_explore.py).

`repro_torch.core.mfmobo.run_mfmobo/run_mobo/run_random` are thin wrappers over
this loop (same signatures, same rng-consumption order, hence bit-identical
traces vs their pre-refactor selves). Objectives are `Objective` protocol
instances (repro_torch.explore.objectives); legacy callables are coerced at entry.

Per-evaluation bookkeeping: every batch evaluated at a fidelity stage
("f0"/"f1") runs under `attribute_cache_traffic`, so the trace records
eval-cache hit-rates per stage — the cost of the fidelity handover is
visible in campaign artifacts and BENCH_dse.json.

Async proposal mode (DESIGN.md §11): with `LoopConfig.async_depth > 0` the
mfmobo/mobo strategies dispatch evaluation batches to a thread pool and
propose the next batch while up to `async_depth` batches are in flight —
q-EHVI fantasizes over the in-flight candidates (rank-1 `GP.condition_on`
at their posterior means) so GP refits never block evaluation workers.
Determinism is preserved by construction: results are folded strictly in
dispatch order (FIFO), and every harvest point is a function of loop state
alone (pipeline depth, budget, fidelity boundaries) — never of executor
timing — so a fixed seed replays the same trace under any interleaving.
In-flight batches are part of `LoopState` (picklable, future-free); a
resumed checkpoint re-dispatches them, and deterministic objectives make
the resumed trace equal the uninterrupted one. `async_depth=0` (default)
is the synchronous loop, bit-identical to its pre-async self.

The port's copy of `repro.explore.runner`. The GP fits and the acquire run
in torch on the loop's `device` (the card unless the caller passes
"cpu"); the device is not part of `LoopConfig` or of a checkpoint, so a run
checkpointed on the card resumes on the CPU and the other way round.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import pickle
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.evalcache import attribute_cache_traffic
from repro_torch.core.mfmobo import (
    Trace,
    _acquire_batch,
    _acquire_batch_device,
    _fit_models,
    _valid_candidates,
    hv_ref,
    obj_space,
)
from repro_torch.core.design_space import WSCDesign
from repro_torch.core.pareto import hypervolume_2d
from repro_torch.explore.objectives import Objective, as_objective

STRATEGIES = ("mfmobo", "mobo", "random")

# v2: LoopState gained `inflight` + `dispatch_seq` (async proposal mode);
# v1 checkpoints still load (the new fields default to empty)
CHECKPOINT_VERSION = 2
_READABLE_VERSIONS = (1, CHECKPOINT_VERSION)


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Strategy + budgets + fidelity schedule. N0 is the f0 evaluation
    budget (for mobo/random: the total budget); N1/d1/k only apply to
    mfmobo. Validation guarantees the budgets are satisfiable exactly —
    priors never exceed their stage budget, so the clamped proposal loop
    honors N0/N1 to the evaluation."""
    strategy: str = "mfmobo"
    N0: int = 20
    N1: int = 30
    d0: int = 3
    d1: int = 3
    k: int = 5
    q: int = 1
    n_candidates: int = 256
    peak_power: float = 15000.0
    seed: int = 0
    async_depth: int = 0      # max in-flight eval batches; 0 = synchronous

    def validate(self) -> "LoopConfig":
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; "
                             f"expected one of {STRATEGIES}")
        if self.q < 1 or self.n_candidates < 1:
            raise ValueError("q and n_candidates must be >= 1")
        if self.async_depth < 0:
            raise ValueError("async_depth must be >= 0 (0 = synchronous)")
        if self.N0 < 1:
            raise ValueError("evaluation budget N0 must be >= 1")
        if self.strategy == "mfmobo":
            if not (0 <= self.d0 <= self.N0):
                raise ValueError(
                    f"f0 priors d0={self.d0} must fit the f0 budget "
                    f"N0={self.N0}")
            if not (0 < self.d1 <= self.N1):
                raise ValueError(
                    f"f1 priors d1={self.d1} must fit the f1 budget "
                    f"N1={self.N1}")
            if self.k < 0:
                raise ValueError("handover width k must be >= 0")
        elif self.strategy == "mobo":
            if not (2 <= self.d0 <= self.N0):
                raise ValueError(
                    f"priors d0={self.d0} must satisfy 2 <= d0 <= N0="
                    f"{self.N0} (the GP needs >= 2 points)")
        return self

    def total_evals(self) -> int:
        if self.strategy == "mfmobo":
            return self.N0 + self.N1
        return self.N0


@dataclasses.dataclass
class PendingBatch:
    """One dispatched-but-unfolded evaluation batch (async mode). Picklable
    and future-free: a checkpoint taken mid-flight stores the candidates,
    and the resumed loop re-dispatches them — the fantasy values q-EHVI
    conditions on are recomputed from the refit models, never stored, so
    they are a pure function of (evaluated data, inflight order)."""
    seq: int                          # dispatch order (FIFO fold key)
    xs: np.ndarray                    # (q_eff, d) encoded candidates
    designs: List[WSCDesign]
    stage: str                        # "f0" | "f1"


@dataclasses.dataclass
class LoopState:
    """Everything a checkpoint needs: picklable, GP-free (models are refit
    from X/Y each iteration)."""
    rng: np.random.Generator
    trace: Trace
    X0: List[np.ndarray]
    Y0: List[Tuple[float, float]]
    X1: List[np.ndarray]
    Y1: List[Tuple[float, float]]
    hist_d: List[WSCDesign]
    hist_y: List[Tuple[float, float]]
    done: int = 0                     # post-prior proposal evals dispatched
    steps: int = 0                    # completed step() transitions
    initialized: bool = False
    handover_fired: bool = False
    pending: Optional[List] = None    # random: sampled-but-unevaluated queue
    wall_s: float = 0.0               # accumulated across run() segments
    inflight: List[PendingBatch] = dataclasses.field(default_factory=list)
    dispatch_seq: int = 0             # next PendingBatch.seq


def _fresh_state(cfg: LoopConfig) -> LoopState:
    tr = Trace([], [], [], [], [])
    tr.stage_cache = {"f0": {"hits": 0, "misses": 0, "entries_added": 0},
                      "f1": {"hits": 0, "misses": 0, "entries_added": 0}}
    return LoopState(rng=np.random.default_rng(cfg.seed), trace=tr,
                     X0=[], Y0=[], X1=[], Y1=[], hist_d=[], hist_y=[])


def _eval_attributed(obj: Objective, designs):
    """Evaluate a batch with this thread's eval-cache traffic captured.
    Runs on the caller's thread in sync mode and on pool threads in async
    mode — thread-local attribution is what keeps concurrent batches from
    scribbling over each other's counters."""
    with attribute_cache_traffic() as acc:
        # host-side floats only: whatever array scalars the objective hands
        # back must not leak device buffers into the picklable LoopState
        ys = [(float(t), float(p))
              for t, p in obj.eval_many(list(designs))]
    return ys, acc


class ExplorationLoop:
    """Step-able exploration run. One `step()` = the prior batch (first
    call) or one proposal batch acquired + evaluated; checkpoints are legal
    at any step boundary."""

    def __init__(self, cfg: LoopConfig, f0, f1=None, *,
                 on_handover: Optional[Callable] = None,
                 state: Optional[LoopState] = None,
                 candidate_fn: Optional[Callable] = None,
                 device="cuda"):
        self.cfg = cfg.validate()
        self.device = device
        self.f0: Objective = as_objective(f0)
        self.f1: Optional[Objective] = (as_objective(f1)
                                        if f1 is not None else None)
        if cfg.strategy == "mfmobo" and self.f1 is None:
            raise ValueError("mfmobo needs a low-fidelity objective f1")
        self.on_handover = on_handover
        # joint mode (strategy-architecture co-exploration): campaigns
        # install a sampler producing (encoded xs, JointDesign) pairs; the
        # default None keeps the grid-mode `_valid_candidates` call (and
        # its rng stream) byte-for-byte
        self._candidate_fn = candidate_fn
        self.ref = hv_ref(cfg.peak_power)
        self.state = state if state is not None else _fresh_state(cfg)
        self._executor: Optional[ThreadPoolExecutor] = None
        self._futures: Dict[int, object] = {}   # PendingBatch.seq -> Future

    # -- bookkeeping -------------------------------------------------------

    def _fold_traffic(self, stage: str, acc: Dict[str, int]):
        sc = self.state.trace.stage_cache.setdefault(
            stage, {"hits": 0, "misses": 0, "entries_added": 0})
        for k in ("hits", "misses", "entries_added"):
            sc[k] += acc[k]

    def _eval(self, obj: Objective, designs, stage: str):
        """Evaluate a batch at a fidelity stage synchronously, attributing
        eval-cache traffic (hits/misses/entries added) to the stage."""
        ys, acc = _eval_attributed(obj, designs)
        self._fold_traffic(stage, acc)
        self.state.trace.n_evals += len(ys)
        return ys

    @staticmethod
    def _fused_ok(obj: Objective) -> bool:
        fn = getattr(obj, "supports_fused", None)
        return bool(fn()) if callable(fn) else False

    def _acquire_eval_fused(self, obj: Objective, models, cand_x, cand_d,
                            ev, q_eff: int, stage: str):
        """One fused synchronous iteration (DESIGN.md §12): the q-EHVI
        acquire's device-resident pick indices feed the torch analytical
        evaluator directly — propose → gather → evaluate in one
        dispatch chain on the device, one host extraction at the end. Returns
        (pick indices, ys) bit-identical to the unfused
        `_acquire_batch` + `_eval` pair."""
        js_dev = _acquire_batch_device(models, cand_x, ev, self.ref,
                                       q=q_eff)
        with attribute_cache_traffic() as acc:
            js, ys = obj.eval_many_fused(cand_d, js_dev, q_eff)
            ys = [(float(t), float(p)) for t, p in ys]
        self._fold_traffic(stage, acc)
        self.state.trace.n_evals += len(ys)
        return js, ys

    def _record(self, x, d, y):
        tr = self.state.trace
        tr.xs.append(x)
        tr.designs.append(d)
        tr.ys.append(y)
        tr.hv.append(hypervolume_2d(obj_space(tr.ys), self.ref))
        tr.wall_s.append(time.time())

    def _fire_handover(self):
        self.state.handover_fired = True
        if self.on_handover is not None:
            self.on_handover(list(self.state.hist_d),
                             list(self.state.hist_y))

    # -- async plumbing (DESIGN.md §11) ------------------------------------

    def _pool(self) -> ThreadPoolExecutor:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=max(1, self.cfg.async_depth),
                thread_name_prefix="eval")
        return self._executor

    def _objective(self, stage: str) -> Objective:
        return self.f0 if stage == "f0" else self.f1

    def _candidates(self, n: int):
        if self._candidate_fn is not None:
            return self._candidate_fn(self.state.rng, n)
        return _valid_candidates(self.state.rng, n)

    def _dispatch(self, xs, designs, stage: str) -> None:
        st = self.state
        pb = PendingBatch(seq=st.dispatch_seq, xs=np.asarray(xs),
                          designs=list(designs), stage=stage)
        st.dispatch_seq += 1
        st.inflight.append(pb)
        self._futures[pb.seq] = self._pool().submit(
            _eval_attributed, self._objective(stage), pb.designs)

    def _redispatch_orphans(self) -> None:
        """Resubmit inflight batches without a live future — the resume
        path: checkpoints pickle PendingBatches but not futures."""
        for pb in self.state.inflight:
            if pb.seq not in self._futures:
                self._futures[pb.seq] = self._pool().submit(
                    _eval_attributed, self._objective(pb.stage), pb.designs)

    def _harvest_one(self) -> None:
        """Block on the OLDEST inflight batch and fold its results into the
        trace/training sets. Strictly FIFO regardless of completion order —
        the fold sequence (hence the trace) is deterministic under any
        executor timing."""
        st, cfg = self.state, self.cfg
        pb = st.inflight.pop(0)
        fut = self._futures.pop(pb.seq, None)
        if fut is None:                  # resumed + never re-dispatched
            ys, acc = _eval_attributed(self._objective(pb.stage), pb.designs)
        else:
            ys, acc = fut.result()
        self._fold_traffic(pb.stage, acc)
        st.trace.n_evals += len(ys)
        for x, d, y in zip(np.asarray(pb.xs), pb.designs, ys):
            if cfg.strategy == "mfmobo":
                st.hist_d.append(d)
                st.hist_y.append(y)
            if pb.stage == "f0":
                st.X0.append(x)
                st.Y0.append(y)
                self._record(x, d, y)
            else:
                st.X1.append(x)
                st.Y1.append(y)

    def _fantasize_inflight(self, models):
        """Condition both GPs on every inflight candidate at its posterior
        mean (rank-1 appends, dispatch order) and return the conditioned
        models plus the fantasy objective rows to extend the EHVI front —
        the q-EHVI proposal accounts for work already in the pipeline."""
        g_t, g_p = models
        rows = []
        for pb in self.state.inflight:
            for x in np.asarray(pb.xs):
                mu_t, _ = g_t.predict(x[None])
                mu_p, _ = g_p.predict(x[None])
                g_t = g_t.condition_on(x, float(mu_t[0]))
                g_p = g_p.condition_on(x, float(mu_p[0]))
                rows.append((float(mu_t[0]), float(mu_p[0])))
        return (g_t, g_p), np.array(rows, float).reshape(-1, 2)

    # -- step machine ------------------------------------------------------

    @property
    def finished(self) -> bool:
        st, cfg = self.state, self.cfg
        if not st.initialized:
            return False
        if st.inflight:                  # async: dispatched != folded
            return False
        if cfg.strategy == "mfmobo":
            return st.done >= cfg.N0 + cfg.N1 - cfg.d0 - cfg.d1
        if cfg.strategy == "mobo":
            return st.done >= cfg.N0 - cfg.d0
        return not st.pending                         # random

    def step(self) -> bool:
        """Advance one batch; returns False once the budget is spent."""
        if self.finished:
            return False
        st, cfg = self.state, self.cfg
        use_async = cfg.async_depth > 0 and cfg.strategy in ("mfmobo",
                                                             "mobo")
        if not st.initialized:
            self._init_step()
        elif cfg.strategy == "mfmobo":
            self._mfmobo_step_async() if use_async else self._mfmobo_step()
        elif cfg.strategy == "mobo":
            self._mobo_step_async() if use_async else self._mobo_step()
        else:
            self._random_step()
        st.steps += 1
        return True

    def run(self, *, max_steps: Optional[int] = None,
            checkpoint_every: int = 0,
            checkpoint_cb: Optional[Callable[[], None]] = None) -> Trace:
        t0 = time.time()

        def flush_wall():
            # fold the running segment into state *before* any checkpoint
            # is pickled, so a crash-resume doesn't under-report wall time
            # (and overstate candidates/sec)
            nonlocal t0
            now = time.time()
            self.state.wall_s += now - t0
            t0 = now

        n = 0
        try:
            while (max_steps is None or n < max_steps) and self.step():
                n += 1
                if (checkpoint_cb is not None and checkpoint_every
                        and n % checkpoint_every == 0):
                    flush_wall()
                    checkpoint_cb()
        finally:
            flush_wall()
            if self._executor is not None and self.finished:
                self._executor.shutdown(wait=True)
                self._executor = None
        if checkpoint_cb is not None:
            checkpoint_cb()
        return self.state.trace

    # -- strategy bodies (rng-consumption order identical to the legacy
    #    repro_torch.core.mfmobo.run_* loops, so traces are bit-identical) -------

    def _init_step(self):
        st, cfg = self.state, self.cfg
        if cfg.strategy == "mfmobo":
            init_x, init_d = self._candidates(cfg.d0 + cfg.d1)
            ys1 = self._eval(self.f1, init_d[:cfg.d1], "f1")
            for x, d, y in zip(init_x[:cfg.d1], init_d[:cfg.d1], ys1):
                st.X1.append(x)
                st.Y1.append(y)
                st.hist_d.append(d)
                st.hist_y.append(y)
            if cfg.d0 > 0 and self.on_handover is not None:
                self._fire_handover()
            ys0 = self._eval(self.f0, init_d[cfg.d1:cfg.d1 + cfg.d0], "f0")
            for x, d, y in zip(init_x[cfg.d1:cfg.d1 + cfg.d0],
                               init_d[cfg.d1:cfg.d1 + cfg.d0], ys0):
                st.X0.append(x)
                st.Y0.append(y)
                st.hist_d.append(d)
                st.hist_y.append(y)
                self._record(x, d, y)
        elif cfg.strategy == "mobo":
            init_x, init_d = self._candidates(cfg.d0)
            for x, d, y in zip(init_x, init_d,
                               self._eval(self.f0, init_d, "f0")):
                st.X0.append(x)
                st.Y0.append(y)
                self._record(x, d, y)
        else:                                         # random
            xs, ds = self._candidates(cfg.N0)
            st.pending = [(x, d) for x, d in zip(xs, ds)]
        st.initialized = True

    def _mfmobo_step(self):
        st, cfg = self.state, self.cfg
        total = cfg.N0 + cfg.N1 - cfg.d0 - cfg.d1
        use_f0 = st.done >= cfg.N1 - cfg.d1
        use_m0 = st.done >= cfg.N1 - cfg.d1 + cfg.k
        if use_f0 and not st.handover_fired:
            self._fire_handover()
        # batch size: q, clipped to the remaining budget and to the next
        # fidelity-schedule boundary so every evaluation in the batch runs
        # at the fidelity the schedule assigns it — the final batch is
        # clamped so the trace honors the N0/N1 budget exactly
        boundaries = [b for b in (cfg.N1 - cfg.d1, cfg.N1 - cfg.d1 + cfg.k,
                                  total) if b > st.done]
        q_eff = max(1, min(cfg.q, min(boundaries) - st.done))

        cand_x, cand_d = self._candidates(cfg.n_candidates)
        if use_m0 and len(st.X0) >= 2:
            models = _fit_models(np.array(st.X0), np.array(st.Y0),
                                 device=self.device)
            ev = obj_space(st.Y0)
        else:
            models = _fit_models(np.array(st.X1), np.array(st.Y1),
                                 device=self.device)
            ev = (obj_space(st.Y1) if not use_f0 or not st.Y0
                  else obj_space(st.Y0))
        obj = self.f0 if use_f0 else self.f1
        stage = "f0" if use_f0 else "f1"
        if self._fused_ok(obj):
            js, ys = self._acquire_eval_fused(obj, models, cand_x, cand_d,
                                              ev, q_eff, stage)
        else:
            js = _acquire_batch(models, cand_x, ev, self.ref, q=q_eff)
            ys = self._eval(obj, [cand_d[j] for j in js], stage)
        for j, y in zip(js, ys):
            st.hist_d.append(cand_d[j])
            st.hist_y.append(y)
            if use_f0:
                st.X0.append(cand_x[j])
                st.Y0.append(y)
                self._record(cand_x[j], cand_d[j], y)
            else:
                st.X1.append(cand_x[j])
                st.Y1.append(y)
        st.done += len(js)

    def _mobo_step(self):
        st, cfg = self.state, self.cfg
        q_eff = max(1, min(cfg.q, cfg.N0 - cfg.d0 - st.done))
        models = _fit_models(np.array(st.X0), np.array(st.Y0),
                             device=self.device)
        cand_x, cand_d = self._candidates(cfg.n_candidates)
        ev = obj_space(st.Y0)
        if self._fused_ok(self.f0):
            js, ys = self._acquire_eval_fused(self.f0, models, cand_x,
                                              cand_d, ev, q_eff, "f0")
        else:
            js = _acquire_batch(models, cand_x, ev, self.ref, q=q_eff)
            ys = self._eval(self.f0, [cand_d[j] for j in js], "f0")
        for j, y in zip(js, ys):
            st.X0.append(cand_x[j])
            st.Y0.append(y)
            self._record(cand_x[j], cand_d[j], y)
        st.done += len(js)

    # -- async strategy bodies: propose with fantasized inflight batches,
    #    dispatch to the pool, fold strictly FIFO. `st.done` counts
    #    DISPATCHED proposal evals (folds lag by at most async_depth
    #    batches), so the q_eff boundary clamping is unchanged. ------------

    def _mfmobo_step_async(self):
        st, cfg = self.state, self.cfg
        self._redispatch_orphans()
        total = cfg.N0 + cfg.N1 - cfg.d0 - cfg.d1
        if st.done >= total:             # budget fully dispatched: drain
            self._harvest_one()
            return
        use_f0 = st.done >= cfg.N1 - cfg.d1
        use_m0 = st.done >= cfg.N1 - cfg.d1 + cfg.k
        if use_f0 and any(pb.stage == "f1" for pb in st.inflight):
            # fidelity boundary: every f1 result must be folded before the
            # first f0 dispatch — they train M1 and feed the handover hook
            self._harvest_one()
            return
        if use_f0 and not st.handover_fired:
            self._fire_handover()
        if len(st.inflight) >= cfg.async_depth:      # pipeline full
            self._harvest_one()
        boundaries = [b for b in (cfg.N1 - cfg.d1, cfg.N1 - cfg.d1 + cfg.k,
                                  total) if b > st.done]
        q_eff = max(1, min(cfg.q, min(boundaries) - st.done))
        cand_x, cand_d = self._candidates(cfg.n_candidates)
        if use_m0 and len(st.X0) >= 2:
            models = _fit_models(np.array(st.X0), np.array(st.Y0),
                                 device=self.device)
            ev = obj_space(st.Y0)
        else:
            models = _fit_models(np.array(st.X1), np.array(st.Y1),
                                 device=self.device)
            ev = (obj_space(st.Y1) if not use_f0 or not st.Y0
                  else obj_space(st.Y0))
        models, fant_rows = self._fantasize_inflight(models)
        ev = np.concatenate([ev, fant_rows], 0) if len(fant_rows) else ev
        js = _acquire_batch(models, cand_x, ev, self.ref, q=q_eff)
        self._dispatch(cand_x[js], [cand_d[j] for j in js],
                       "f0" if use_f0 else "f1")
        st.done += len(js)

    def _mobo_step_async(self):
        st, cfg = self.state, self.cfg
        self._redispatch_orphans()
        total = cfg.N0 - cfg.d0
        if st.done >= total:
            self._harvest_one()
            return
        if len(st.inflight) >= cfg.async_depth:
            self._harvest_one()
        q_eff = max(1, min(cfg.q, total - st.done))
        models = _fit_models(np.array(st.X0), np.array(st.Y0),
                             device=self.device)
        models, fant_rows = self._fantasize_inflight(models)
        ev = obj_space(st.Y0)
        ev = np.concatenate([ev, fant_rows], 0) if len(fant_rows) else ev
        cand_x, cand_d = self._candidates(cfg.n_candidates)
        js = _acquire_batch(models, cand_x, ev, self.ref, q=q_eff)
        self._dispatch(cand_x[js], [cand_d[j] for j in js], "f0")
        st.done += len(js)

    def _random_step(self):
        st, cfg = self.state, self.cfg
        batch = st.pending[:max(cfg.q, 1)]
        st.pending = st.pending[len(batch):]
        ys = self._eval(self.f0, [d for _, d in batch], "f0")
        for (x, d), y in zip(batch, ys):
            self._record(x, d, y)
        st.done += len(batch)

    # -- checkpointing -----------------------------------------------------

    def save_state(self, path: str, extra: Optional[Dict] = None,
                   keep: int = 3) -> str:
        """Atomically write the checkpoint head at `path`, retaining the
        newest `keep - 1` step-stamped history files alongside it
        (`<path>.step<NNNNNNNN>`) — `load_state` falls back to them when
        the head is corrupt (torn disk write, bad copy). keep <= 1 keeps
        the single-file behavior."""
        blob = pickle.dumps({"version": CHECKPOINT_VERSION,
                             "cfg": dataclasses.asdict(self.cfg),
                             "state": self.state,
                             "extra": extra or {}})
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        if keep > 1:
            hist = f"{path}.step{self.state.steps:08d}"
            try:
                os.link(tmp, hist)           # same bytes, no second write
            except OSError:                  # exists / fs without links
                with open(hist, "wb") as f:
                    f.write(blob)
            for old in sorted(glob.glob(path + ".step*"))[:-(keep - 1)]:
                try:
                    os.remove(old)
                except OSError:
                    pass
        os.replace(tmp, path)         # atomic: a crash mid-write can't
        return path                   # corrupt the last good checkpoint

    @staticmethod
    def _load_blob(path: str) -> Tuple[LoopConfig, LoopState, Dict]:
        with open(path, "rb") as f:
            blob = pickle.load(f)
        v = blob.get("version")
        if v not in _READABLE_VERSIONS:
            raise ValueError(f"checkpoint {path} has version {v!r}; this "
                             f"build reads versions {_READABLE_VERSIONS}")
        st = blob["state"]
        if not hasattr(st, "inflight"):      # v1 state: pre-async fields
            st.inflight = []
        if not hasattr(st, "dispatch_seq"):
            st.dispatch_seq = 0
        return (LoopConfig(**blob["cfg"]), st, blob.get("extra", {}))

    @staticmethod
    def load_state(path: str) -> Tuple[LoopConfig, LoopState, Dict]:
        """Load a checkpoint; if the head at `path` is unreadable (missing,
        truncated, unpicklable, wrong version), fall back to the newest
        loadable retained history file (`save_state(keep=...)`)."""
        try:
            return ExplorationLoop._load_blob(path)
        except Exception:
            for hist in sorted(glob.glob(path + ".step*"), reverse=True):
                try:
                    return ExplorationLoop._load_blob(hist)
                except Exception:
                    continue
            raise


__all__ = ["CHECKPOINT_VERSION", "ExplorationLoop", "LoopConfig",
           "LoopState", "PendingBatch", "STRATEGIES"]
