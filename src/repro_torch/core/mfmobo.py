"""Multi-Fidelity Multi-Objective Bayesian Optimization — paper Algorithm 1.

Two evaluation fidelities (f1 = analytical, f0 = GNN-based — paper §VII
notes CA simulation is kept out of the loop for cost), GP surrogates per
(fidelity x objective), EHVI acquisition with hypervolume reference
(throughput 0, peak power). The schedule:

    evaluations [0, N1-d1):           evaluate f1, acquire with M1
    evaluations [N1-d1, N1-d1+k):     evaluate f0, acquire with M1 (handover)
    evaluations [N1-d1+k, ...):       evaluate f0, acquire with M0

Each iteration proposes a batch of q candidates by greedy q-EHVI with
fantasized observations (DESIGN.md §5): pick the EHVI argmax, condition the
GPs on its posterior mean (GP.condition_on), extend the fantasy front, and
repeat — then evaluate the whole batch in one call. Objectives follow the
`repro_torch.explore.objectives.Objective` protocol (`eval_many(designs)`);
legacy callables — scalar (design -> (throughput, power)) functions or
batch-aware functions marked `.batched = True` — are coerced at entry by
`as_objective`. With q=1 the loop is the paper's serial Algorithm 1.

This module keeps the algorithmic primitives (Trace, GP fitting in the
log-objective space, greedy q-EHVI acquisition, valid-candidate sampling);
the loop itself lives in `repro_torch.explore.runner.ExplorationLoop` — a
resumable state machine that campaigns (repro_torch.explore.campaign) checkpoint
and resume. `run_mfmobo` / `run_mobo` / `run_random` are thin wrappers
over that loop with their historical signatures and rng-consumption order
(traces are bit-identical to the pre-campaign implementations).

Baselines for Fig. 8: random search and single-fidelity MOBO.

The port of `repro.core.mfmobo`: the GP fit and the greedy q-EHVI acquire
run in torch on the device the caller names (`_fit_models(device=...)`;
the acquire runs where the models live) and read nothing back until the
picks are needed. The rest is NumPy, copied, joint-mode sampling
(`_valid_candidates_joint`, with the port's shardability oracle) included.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.design_space import WSCDesign, decode_batch, sample
from repro_torch.core.ehvi import ehvi_padded
from repro_torch.core.gp import GP, _predict, _rank1, bucket_size
from repro_torch.core.pareto import pareto_front, to_max_space
from repro_torch.core.validator import validate_batch
from repro_torch.device import to_device

EvalFn = Callable[[WSCDesign], Tuple[float, float]]   # -> (throughput, power)


@dataclasses.dataclass
class Trace:
    xs: List[np.ndarray]
    designs: List[WSCDesign]
    ys: List[Tuple[float, float]]         # (throughput, power)
    hv: List[float]                       # hypervolume after each evaluation
    wall_s: List[float]
    n_evals: int = 0                      # total evals incl. f1-only points
    # per-fidelity-stage eval-cache traffic ({"f0"/"f1": {hits, misses,
    # entries_added}}), recorded by the exploration loop so the cost of the
    # fidelity handover is visible in campaign artifacts / BENCH_dse.json
    stage_cache: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    def points_max(self) -> np.ndarray:
        t = np.array([y[0] for y in self.ys])
        p = np.array([y[1] for y in self.ys])
        return to_max_space(t, p)

    def pareto(self) -> np.ndarray:
        return pareto_front(self.points_max())

    def cache_hit_rates(self) -> Dict[str, float]:
        out = {}
        for stage, sc in self.stage_cache.items():
            n = sc.get("hits", 0) + sc.get("misses", 0)
            out[stage] = sc.get("hits", 0) / n if n else 0.0
        return out


def _eval_many(f: EvalFn, designs: Sequence[WSCDesign]
               ) -> List[Tuple[float, float]]:
    """Legacy shim: objective coercion (including the old `.batched`
    attribute sniff) now lives in `repro_torch.explore.objectives.as_objective`;
    the exploration loop calls `Objective.eval_many` directly."""
    from repro_torch.explore.objectives import as_objective
    return as_objective(f).eval_many(list(designs))


def _valid_candidates(rng: np.random.Generator, n: int,
                      max_tries: int = 8) -> Tuple[np.ndarray, List[WSCDesign]]:
    """Sample until n validator-approved candidates are collected, topping
    up with fresh batches for up to `max_tries` rounds. Each round decodes
    and validates the whole draw at once (`validate_batch`); the rng stream,
    accepted set, and ordering are identical to the retired per-design
    loop. A design space whose acceptance rate is too low to fill the
    request raises — with the observed rate — instead of silently handing
    the acquisition a short (or empty) candidate set."""
    xs, ds = [], []
    n_drawn = 0
    for _ in range(max_tries):
        us = sample(rng, n)
        n_drawn += len(us)
        for u, r in zip(us, validate_batch(decode_batch(us))):
            if r.ok:
                xs.append(u)
                ds.append(r.design)
            if len(xs) >= n:
                return np.array(xs), ds
    rate = len(xs) / max(n_drawn, 1)
    raise RuntimeError(
        f"design-space sampling produced only {len(xs)}/{n} valid "
        f"candidates after {max_tries} rounds of {n} draws (acceptance "
        f"rate {rate:.1%}) — the validator is rejecting (nearly) "
        "everything; loosen the design-space bounds or raise max_tries")


def _grid_seed_strategies(designs, wl, space):
    """Heuristic strategy seeds for joint sampling: each design's
    first-feasible row of the sorted strategy grid (what grid-mode
    evaluation would try first), as (N, 7) encoded strategy columns plus a
    found-mask. Vectorized over the cached `_strategy_grid`, at the same
    area-matched system size the validator gates on (`wafers_for_budget`
    per design). Each seed is then re-checked under the v2 memory model
    (`strategy_memory_need`); a training seed that only fits with
    activation recompute carries recompute=True into the search — the
    validator would reject the plain row with "strategy_memory", so the
    fallback keeps the seed alive and hands q-EHVI a live recompute
    signal."""
    from repro_torch.core.compiler import (Strategy, _strategy_grid,
                                     strategy_memory_need)
    from repro_torch.core.design_space import DesignBatch
    from repro_torch.core.evaluator import wafers_for_budget

    g = _strategy_grid(wl)
    db = DesignBatch.from_designs(list(designs))
    nw = np.array([wafers_for_budget(d, wl) for d in designs], np.float64)
    tc = db.total_cores.astype(np.float64) * nw
    mem = (db.buffer_kb * 1024.0 * db.total_cores
           + db.dram_gb_per_reticle * 1e9 * db.n_reticles) * nw
    o = g["order"]
    m = ((g["chunks"][None, o] * g["tp"][None, o] <= tc[:, None])
         & (g["tp"][None, o] <= tc[:, None])
         & (g["need"][None, o] <= mem[:, None]))
    found = m.any(axis=1)
    idx = o[np.argmax(m, axis=1)]
    need_plain = strategy_memory_need(wl, g["tp"][idx], g["pp"][idx],
                                      g["dp"][idx], g["mb"][idx])
    need_rc = strategy_memory_need(wl, g["tp"][idx], g["pp"][idx],
                                   g["dp"][idx], g["mb"][idx],
                                   recompute=True)
    rc = ((wl.phase == "train") & (need_plain > mem) & (need_rc <= mem))
    enc = np.zeros((len(designs), space.n_dims))
    for i in np.flatnonzero(found):
        s = Strategy(int(g["tp"][idx[i]]), int(g["pp"][idx[i]]),
                     int(g["dp"][idx[i]]), int(g["mb"][idx[i]]),
                     recompute=bool(rc[i]))
        enc[i] = space.encode_strategy(s)
    return enc, found


def _valid_candidates_joint(rng: np.random.Generator, n: int, space, wl,
                            max_tries: int = 8
                            ) -> Tuple[np.ndarray, List]:
    """Joint-mode `_valid_candidates`: sample (13 + 7)-dim joint points,
    seed every other draw's strategy columns from the grid heuristic
    (`enumerate_strategies` demoted to seeding — the sorted grid's first
    feasible row), validate architecture + strategy together
    (`validate_joint_batch`, `repro_torch.dist` oracle included), and return
    (encoded points, JointDesigns with spares resolved)."""
    from repro_torch.core.design_space import (DIMS, JointDesign,
                                               decode_joint_batch,
                                               sample_joint)
    from repro_torch.core.validator import validate_joint_batch

    nd = len(DIMS)
    xs, pts = [], []
    n_drawn = 0
    for _ in range(max_tries):
        us = sample_joint(rng, n, space)
        n_drawn += len(us)
        batch = decode_joint_batch(us, space)
        seeded = list(range(0, len(batch), 2))
        enc, found = _grid_seed_strategies(
            [batch[i].design for i in seeded], wl, space)
        for j, i in enumerate(seeded):
            if found[j]:
                us[i, nd:] = enc[j]
                batch[i] = JointDesign(
                    batch[i].design, space.decode_strategy(us[i, nd:]))
        for u, p, r in zip(us, batch, validate_joint_batch(batch, wl)):
            if r.ok:
                xs.append(u)
                pts.append(JointDesign(r.design, p.strategy))
            if len(xs) >= n:
                return np.array(xs), pts
    rate = len(xs) / max(n_drawn, 1)
    raise RuntimeError(
        f"joint-space sampling produced only {len(xs)}/{n} valid "
        f"candidates after {max_tries} rounds of {n} draws (acceptance "
        f"rate {rate:.1%}) — loosen the strategy-space bounds or raise "
        "max_tries")


def _fit_models(X: np.ndarray, Y: np.ndarray, device="cuda"
                ) -> Tuple[GP, GP]:
    # one batched fit refits both objective surrogates on the shared X
    return GP.fit_pair(X, (np.log1p(np.maximum(Y[:, 0], 0.0)),
                           -np.log(np.maximum(Y[:, 1], 1.0))), device=device)


def _acquire_loop(g_t: GP, g_p: GP, cand, fant, fmask, nf0: int, ref,
                  q: int) -> torch.Tensor:
    """The greedy q-EHVI loop on the device: each pick predicts both
    objectives at every candidate, scores the padded EHVI over the fantasy
    front, takes the argmax and fantasizes it into both GPs (rank-1 append
    at its posterior mean) and into the front. The pick j stays on the
    device; the rows it is appended at (n, nf) are host integers, known
    without reading the device. Returns the (q,) index tensor."""
    X, mask, n = g_t.X, g_t.mask, g_t.n
    yt, Lt, at = g_t.y, g_t.chol, g_t.alpha
    yp, Lp, ap = g_p.y, g_p.chol, g_p.alpha
    pt, pp = g_t.params, g_p.params
    # divisors as device tensors: on CUDA, a division by a host scalar runs
    # as a multiply by its reciprocal
    std_t, std_p = (torch.full((), g.std, dtype=cand.dtype, device=cand.device)
                    for g in (g_t, g_p))
    chosen = torch.zeros(cand.shape[0], dtype=torch.bool, device=cand.device)
    cand_ids = torch.arange(cand.shape[0], device=cand.device)
    fant_ids = torch.arange(fant.shape[0], device=cand.device)
    js = []
    for i in range(q):
        mu_t, sd_t = _predict(cand, X, mask, Lt, at, pt["log_ls"],
                              pt["log_sf"], g_t.mean, g_t.std)
        mu_p, sd_p = _predict(cand, X, mask, Lp, ap, pp["log_ls"],
                              pp["log_sf"], g_p.mean, g_p.std)
        mu = torch.stack([mu_t, mu_p], 1)
        sg = torch.stack([sd_t, sd_p], 1)
        scores = ehvi_padded(mu, sg, fant, fmask, ref)
        scores = torch.where(chosen, -torch.inf, scores)
        j = torch.argmax(scores)
        js.append(j)
        if i == q - 1:
            break
        chosen = chosen | (cand_ids == j)
        jj = j.view(1)
        x_j = cand.index_select(0, jj)[0]
        mu_j = mu.index_select(0, jj)[0]
        # fantasize the observation at the posterior mean and condition
        X2, yt, mask2, Lt, at = _rank1(
            X, yt, mask, Lt, pt["log_ls"], pt["log_sf"], pt["log_noise"], n,
            x_j, (mu_j[0] - g_t.mean) / std_t)
        _, yp, _, Lp, ap = _rank1(
            X, yp, mask, Lp, pp["log_ls"], pp["log_sf"], pp["log_noise"], n,
            x_j, (mu_j[1] - g_p.mean) / std_p)
        X, mask, n = X2, mask2, n + 1
        hot = fant_ids == nf0 + i
        fant = torch.where(hot[:, None], mu_j[None, :], fant)
        fmask = torch.where(hot, torch.ones_like(fmask), fmask)
    return torch.stack(js)


def _acquire_batch_device(models: Tuple[GP, GP], cand_x: np.ndarray,
                          evaluated: np.ndarray, ref: np.ndarray,
                          q: int = 1) -> torch.Tensor:
    """`_acquire_batch` without the host sync: returns the (q,) index
    tensor on the models' device. The fused analytical evaluator
    (`repro_torch.core.eval_compiled.dispatch_fused_eval`) consumes it
    there, so a synchronous f1 iteration never waits on the proposal
    before dispatching the evaluation.

    The buffers keep the JAX version's pow2 capacities (room for a q
    padded to `bucket_size(q, minimum=4)`), so both frameworks factor the
    same shapes. The loop itself stops after q picks: JAX pads the scan to
    reuse one compiled program, and greedy picks are prefix-stable, so the
    first q picks are the same either way."""
    g_t, g_p = models
    if g_t.n != g_p.n:
        raise ValueError("objective GPs must share the training set")
    q = max(1, min(q, len(cand_x)))
    qpad = bucket_size(q, minimum=4)
    B = bucket_size(g_t.n + qpad)       # room for qpad rank-1 appends
    g_t = g_t.with_capacity(B)
    g_p = g_p.with_capacity(B)
    dt, dev = g_t.dtype, g_t.device
    fantasy = np.asarray(evaluated, float).reshape(-1, 2)
    Bf = bucket_size(len(fantasy) + qpad, minimum=4)
    fant = np.zeros((Bf, 2))
    fant[:len(fantasy)] = fantasy
    fmask = np.zeros(Bf)
    fmask[:len(fantasy)] = 1.0
    with torch.no_grad():
        return _acquire_loop(
            g_t, g_p, to_device(cand_x, dt, dev), to_device(fant, dt, dev),
            to_device(fmask, dt, dev), len(fantasy),
            to_device(ref, dt, dev), q)


def _acquire_batch(models: Tuple[GP, GP], cand_x: np.ndarray,
                   evaluated: np.ndarray, ref: np.ndarray,
                   q: int = 1) -> List[int]:
    """Greedy q-EHVI with fantasized observations. Returns q distinct
    candidate indices; q=1 reduces exactly to the scalar EHVI argmax.
    The NumPy reference loop is `repro.core.gp_ref.acquire_batch_ref`,
    which the tests hold this against."""
    return _acquire_batch_device(models, cand_x, evaluated, ref,
                                 q=q).tolist()


def _acquire(models: Tuple[GP, GP], cand_x: np.ndarray,
             evaluated: np.ndarray, ref: np.ndarray) -> int:
    return _acquire_batch(models, cand_x, evaluated, ref, q=1)[0]


# (device, candidate count, q) already warmed in THIS process
_WARMED: set = set()


def warm_optimizer_kernels(n_candidates: int = 256, q: int = 1,
                           force: bool = False, device="cuda") -> int:
    """Run one small pair fit and one acquire on `device`, so that what
    torch sets up on the first call (the cuBLAS and cuSOLVER handles, the
    first launch of each kernel) stays out of a timed region. Eager torch
    compiles nothing per shape, so one warm-up covers every bucket (the
    evaluator has its own, `eval_compiled.warm_evaluator_kernels`).
    Memoized per process; `force=True` runs it again. Returns the number of
    warm-ups run (0 or 1)."""
    from repro_torch.core.design_space import DIMS
    key = (str(device), n_candidates, q)
    if key in _WARMED and not force:
        return 0
    _WARMED.add(key)
    rng = np.random.default_rng(0)
    X = rng.random((6, len(DIMS)))
    Y = np.stack([1e3 * (1.0 + X[:, 0]), 1e3 * (2.0 - X[:, 1])], 1)
    models = _fit_models(X, Y, device=device)
    ev = obj_space([tuple(y) for y in Y])
    _acquire_batch(models, rng.random((n_candidates, len(DIMS))), ev,
                   hv_ref(1e4), q=q)
    return 1


def obj_space(ys: List[Tuple[float, float]]) -> np.ndarray:
    """(log throughput, -log power) — the space GPs and HV operate in."""
    t = np.log1p(np.maximum(np.array([y[0] for y in ys]), 0.0))
    p = -np.log(np.maximum(np.array([y[1] for y in ys]), 1.0))
    return np.stack([t, p], 1)


def hv_ref(peak_power: float) -> np.ndarray:
    """Hypervolume reference point (throughput 0, peak power)."""
    return np.array([0.0, -np.log(max(peak_power, 1.0))])


# legacy underscore aliases (pre-existing tests import these)
_obj_space = obj_space
_hv_ref = hv_ref


def run_mfmobo(f0: EvalFn, f1: EvalFn, *, d0: int = 3, d1: int = 3,
               k: int = 5, N0: int = 20, N1: int = 30,
               peak_power: float = 15000.0, n_candidates: int = 256,
               q: int = 1, seed: int = 0,
               on_handover: Optional[Callable[
                   [List[WSCDesign], List[Tuple[float, float]]], None]] = None,
               device="cuda") -> Trace:
    """Paper Algorithm 1 (+ q-batching, DESIGN.md §5). `on_handover`, if
    given, fires once immediately before the FIRST f0 evaluation (the d0
    prior batch), with every f1-evaluated design and its objectives — the
    hook the online GNN calibration loop (calibration.py) uses to fine-tune
    f0 on simulator traces from the current Pareto neighborhood, so every
    recorded f0 objective (priors included — they seed the trace, the front
    and M0's training set permanently) comes from calibrated params.

    Thin wrapper over `repro_torch.explore.runner.ExplorationLoop` (DESIGN.md
    §9); use a `repro_torch.explore.Campaign` instead when the run should be
    serializable / checkpointable / resumable."""
    from repro_torch.explore.runner import ExplorationLoop, LoopConfig
    cfg = LoopConfig(strategy="mfmobo", N0=N0, N1=N1, d0=d0, d1=d1, k=k,
                     q=q, n_candidates=n_candidates, peak_power=peak_power,
                     seed=seed)
    return ExplorationLoop(cfg, f0, f1=f1, on_handover=on_handover,
                           device=device).run()


def run_mobo(f0: EvalFn, *, d0: int = 6, N: int = 20,
             peak_power: float = 15000.0, n_candidates: int = 256,
             q: int = 1, seed: int = 0, device="cuda") -> Trace:
    """Single-fidelity MOBO baseline (paper Fig. 8)."""
    from repro_torch.explore.runner import ExplorationLoop, LoopConfig
    cfg = LoopConfig(strategy="mobo", N0=N, d0=d0, q=q,
                     n_candidates=n_candidates, peak_power=peak_power,
                     seed=seed)
    return ExplorationLoop(cfg, f0, device=device).run()


def run_random(f0: EvalFn, *, N: int = 20, peak_power: float = 15000.0,
               seed: int = 0, device="cuda") -> Trace:
    from repro_torch.explore.runner import ExplorationLoop, LoopConfig
    # q=N: evaluate the whole sampled pool in one batch call, exactly like
    # the pre-campaign implementation (campaigns chunk by q instead, for
    # checkpoint granularity)
    cfg = LoopConfig(strategy="random", N0=N, q=N, peak_power=peak_power,
                     seed=seed)
    return ExplorationLoop(cfg, f0, device=device).run()
