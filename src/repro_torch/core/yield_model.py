"""Defective-core + redundancy yield models (paper §V-C, §V-D).

    Yield_Murphy = [(1 - e^{-A D0}) / (A D0)]^2                        (Eq. 1)
    Yield_str    = (loss/d_max) d + 1 - loss   for d < d_max           (Eq. 2)
    Yield_core   = Murphy x stress x TSV                               (Eq. 3)
    Y_PS         = sum_{i=p}^{p+n} C(p+n, i) y^i (1-y)^{p+n-i}         (Eq. 4)

Per-position yields over the reticle core grid (screw holes at reticle
corners, TSV field at reticle centre) + exact Poisson-binomial
row-redundancy yield (Cerebras-style extra row connections, paper §VIII-A).
The Monte-Carlo estimator is retained as a cross-check oracle for tests.

The port's own copy of `repro.core.yield_model`
(imports rewritten; the port imports nothing of `repro`).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence, Tuple, Union

import numpy as np

D0_PER_CM2 = 0.1                 # paper §VIII-A (IRDS)
STRESS_LOSS = 0.1
STRESS_DMAX_MM = 1.0
TSV_LOSS = 0.1
TSV_DMAX_MM = 1.0
YIELD_TARGET = 0.9


def murphy_yield(area_mm2: float, d0: float = D0_PER_CM2) -> float:
    a_cm2 = area_mm2 / 100.0
    ad = a_cm2 * d0
    if ad < 1e-12:
        return 1.0
    return ((1.0 - math.exp(-ad)) / ad) ** 2


def stress_yield(dist_mm: float, loss: float = STRESS_LOSS,
                 dmax: float = STRESS_DMAX_MM) -> float:
    if dist_mm >= dmax:
        return 1.0
    return (loss / dmax) * dist_mm + 1.0 - loss


def core_yield_grid(core_h_mm: float, core_w_mm: float,
                    array: Tuple[int, int],
                    reticle_mm: Tuple[float, float],
                    tsv_region_mm2: float = 0.0) -> np.ndarray:
    """Per-position core yield over an (H, W) array on one reticle.
    Screw holes sit at the four reticle corners (intersections of reticles on
    the wafer); the TSV field sits at the reticle centre."""
    H, W = array
    area = core_h_mm * core_w_mm
    base = murphy_yield(area)
    ys = np.full((H, W), base)

    # nearest-vertex distances of each core to the four corners
    ci = (np.arange(H)[:, None] + 0.5) * core_h_mm
    cj = (np.arange(W)[None, :] + 0.5) * core_w_mm
    rh, rw = reticle_mm
    for hy, hx in ((0, 0), (0, rw), (rh, 0), (rh, rw)):
        d = np.sqrt((ci - hy) ** 2 + (cj - hx) ** 2)
        d = np.maximum(d - 0.5 * math.hypot(core_h_mm, core_w_mm), 0.0)
        ys = ys * np.where(d < STRESS_DMAX_MM,
                           (STRESS_LOSS / STRESS_DMAX_MM) * d + 1 - STRESS_LOSS,
                           1.0)

    if tsv_region_mm2 > 0.0:
        r_tsv = math.sqrt(tsv_region_mm2 / math.pi)
        d = np.sqrt((ci - rh / 2) ** 2 + (cj - rw / 2) ** 2)
        d = np.maximum(d - r_tsv, 0.0)
        ys = ys * np.where(d < TSV_DMAX_MM,
                           (TSV_LOSS / TSV_DMAX_MM) * d + 1 - TSV_LOSS,
                           1.0)
    return np.clip(ys, 0.0, 1.0)


def binomial_redundancy_yield(p_cores: int, n_spare: int, y_core: float
                              ) -> float:
    """Eq. 4: reticle works if >= p of (p+n) cores are good (uniform yield)."""
    total = p_cores + n_spare
    acc = 0.0
    for i in range(p_cores, total + 1):
        acc += math.comb(total, i) * (y_core ** i) * ((1 - y_core) ** (total - i))
    return acc


def mc_row_redundancy_yield(ys: np.ndarray, spares_per_row: int,
                            n_samples: int = 2000, seed: int = 0) -> float:
    """Monte-Carlo with position-dependent yields and Cerebras-style row
    repair: a reticle works iff every row has <= spares_per_row failures.
    Superseded by the exact `row_redundancy_yield`; kept as the statistical
    oracle the exact DP is property-tested against."""
    rng = np.random.default_rng(seed)
    H, W = ys.shape
    fails = rng.random((n_samples, H, W)) > ys[None]
    per_row = fails.sum(axis=2)
    ok = (per_row <= spares_per_row).all(axis=1)
    return float(ok.mean())


def row_fail_cdf(ys: np.ndarray, max_count: int) -> np.ndarray:
    """Exact Poisson-binomial CDF of per-row failure counts.

    `ys` (..., W) holds per-cell yields; returns (..., max_count + 1) with
    entry k = P(#failed cells in the row <= k). The polynomial-convolution
    DP is truncated at max_count + 1 coefficients: dropped mass only ever
    moves to *higher* counts, so the retained coefficients stay exact.
    Padding cells with yield 1.0 leaves the DP bitwise unchanged, which is
    what makes the batched grids below exact despite ragged row lengths.
    """
    q = 1.0 - np.asarray(ys, np.float64)
    pmf = np.zeros(q.shape[:-1] + (max_count + 1,))
    pmf[..., 0] = 1.0
    for i in range(q.shape[-1]):
        qi = q[..., i, None]
        shifted = np.zeros_like(pmf)
        shifted[..., 1:] = pmf[..., :-1]
        pmf = pmf * (1.0 - qi) + shifted * qi
    return np.cumsum(pmf, axis=-1)


def row_redundancy_yield(ys: np.ndarray, spares_per_row: int) -> float:
    """Exact replacement for `mc_row_redundancy_yield`: rows fail
    independently, so P(reticle works) = prod over rows of
    P(row failures <= spares)."""
    cdf = row_fail_cdf(np.asarray(ys, np.float64), spares_per_row)
    return float(np.prod(cdf[..., -1], axis=-1))


@lru_cache(maxsize=4096)
def reticle_yield(core_h_mm: float, core_w_mm: float, array: Tuple[int, int],
                  reticle_mm: Tuple[float, float], tsv_region_mm2: float,
                  spares_per_row: int) -> float:
    ys = core_yield_grid(core_h_mm, core_w_mm, array, reticle_mm,
                         tsv_region_mm2)
    return row_redundancy_yield(ys, spares_per_row)


# per-boundary yield of on-wafer field stitching (offset-exposure seams are
# fabricated blind — no KGD test before commit); InFO-SoW assembles tested
# dies on an RDL, so its assembly yield is near-unity
STITCH_BOUNDARY_YIELD = 0.9995


def core_yield_grids_batch(core_h_mm: np.ndarray, core_w_mm: np.ndarray,
                           arr_h: np.ndarray, arr_w: np.ndarray,
                           reticle_h_mm: np.ndarray,
                           reticle_w_mm: np.ndarray,
                           tsv_region_mm2: np.ndarray) -> np.ndarray:
    """`core_yield_grid` for N designs at once, padded to the batch max
    (H, W) with yield 1.0 (a perfect cell never fails, so padding is inert
    through the row-failure DP). Cell values match the scalar grid bitwise:
    the scalar helpers (`murphy_yield`, math.hypot/sqrt) compute the
    per-design bases, and the per-cell arithmetic broadcasts the identical
    IEEE operations."""
    N = len(core_h_mm)
    maxH = int(arr_h.max())
    maxW = int(arr_w.max())
    base = np.array([murphy_yield(float(h) * float(w))
                     for h, w in zip(core_h_mm, core_w_mm)])
    ys = np.broadcast_to(base[:, None, None], (N, maxH, maxW)).copy()

    ci = (np.arange(maxH)[None, :] + 0.5) * core_h_mm[:, None]   # (N, maxH)
    cj = (np.arange(maxW)[None, :] + 0.5) * core_w_mm[:, None]   # (N, maxW)
    half_diag = np.array([0.5 * math.hypot(float(h), float(w))
                          for h, w in zip(core_h_mm, core_w_mm)])
    zero = np.zeros(N)
    for hy, hx in ((zero, zero), (zero, reticle_w_mm),
                   (reticle_h_mm, zero), (reticle_h_mm, reticle_w_mm)):
        d = np.sqrt((ci - hy[:, None])[:, :, None] ** 2
                    + (cj - hx[:, None])[:, None, :] ** 2)
        d = np.maximum(d - half_diag[:, None, None], 0.0)
        ys = ys * np.where(d < STRESS_DMAX_MM,
                           (STRESS_LOSS / STRESS_DMAX_MM) * d + 1 - STRESS_LOSS,
                           1.0)

    has_tsv = tsv_region_mm2 > 0.0
    if has_tsv.any():
        r_tsv = np.array([math.sqrt(float(a) / math.pi) if a > 0.0 else 0.0
                          for a in tsv_region_mm2])
        d = np.sqrt((ci - reticle_h_mm[:, None] / 2)[:, :, None] ** 2
                    + (cj - reticle_w_mm[:, None] / 2)[:, None, :] ** 2)
        d = np.maximum(d - r_tsv[:, None, None], 0.0)
        tsv_factor = np.where(d < TSV_DMAX_MM,
                              (TSV_LOSS / TSV_DMAX_MM) * d + 1 - TSV_LOSS,
                              1.0)
        ys = np.where(has_tsv[:, None, None], ys * tsv_factor, ys)

    ys = np.clip(ys, 0.0, 1.0)
    # neutralize padding: cells outside each design's own (H, W) are perfect
    row_pad = np.arange(maxH)[None, :] >= arr_h[:, None]
    col_pad = np.arange(maxW)[None, :] >= arr_w[:, None]
    ys[np.broadcast_to(row_pad[:, :, None], ys.shape)] = 1.0
    ys[np.broadcast_to(col_pad[:, None, :], ys.shape)] = 1.0
    return ys


def min_spares_for_target_batch(core_h_mm: np.ndarray, core_w_mm: np.ndarray,
                                arr_h: np.ndarray, arr_w: np.ndarray,
                                reticle_h_mm: np.ndarray,
                                reticle_w_mm: np.ndarray,
                                tsv_region_mm2: np.ndarray,
                                n_reticles: np.ndarray,
                                is_infosow: np.ndarray,
                                target: float = YIELD_TARGET,
                                max_spares: int = 4
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized `min_spares_for_target`: one yield-grid build + one
    row-failure DP per batch resolves every spares level 0..max_spares for
    every design simultaneously. Returns (spares (N,) int64 with -1 = no
    level meets the target, wafer_yield (N,) float64)."""
    core_h_mm = np.asarray(core_h_mm, np.float64)
    core_w_mm = np.asarray(core_w_mm, np.float64)
    arr_h = np.asarray(arr_h, np.int64)
    arr_w = np.asarray(arr_w, np.int64)
    N = len(core_h_mm)
    if N == 0:
        return np.zeros(0, np.int64), np.zeros(0)
    ys = core_yield_grids_batch(core_h_mm, core_w_mm, arr_h, arr_w,
                                np.asarray(reticle_h_mm, np.float64),
                                np.asarray(reticle_w_mm, np.float64),
                                np.asarray(tsv_region_mm2, np.float64))
    cdf = row_fail_cdf(ys, max_spares)              # (N, maxH, S+1)
    rys = np.prod(cdf, axis=1)                      # (N, S+1) reticle yield
    n_ret = np.asarray(n_reticles, np.int64)
    n_seams = 2 * n_ret                 # ~2 shared boundaries per reticle
    stitched = (rys ** n_ret[:, None]) * \
        (STITCH_BOUNDARY_YIELD ** n_seams[:, None].astype(np.float64))
    wy = np.where(np.asarray(is_infosow, bool)[:, None], rys, stitched)
    meets = wy >= target
    spares = np.where(meets.any(axis=1), meets.argmax(axis=1), -1)
    wy_out = np.where(spares >= 0,
                      wy[np.arange(N), np.maximum(spares, 0)], 0.0)
    return spares.astype(np.int64), wy_out


def min_spares_for_target(core_h_mm: float, core_w_mm: float,
                          array: Tuple[int, int],
                          reticle_mm: Tuple[float, float],
                          tsv_region_mm2: float,
                          n_reticles: int,
                          integration: str,
                          target: float = YIELD_TARGET,
                          max_spares: int = 4) -> Tuple[int, float]:
    """Smallest spares-per-row meeting the wafer yield target.

    InFO-SoW uses known-good-die: wafer yield == reticle yield (paper §VIII-A).
    Die stitching cannot discard bad reticles: wafer yield = reticle^n x
    the stitched-seam yield.

    Delegates to the batch-of-1 path so the scalar and batched validators
    resolve spares bitwise identically."""
    spares, wy = min_spares_for_target_batch(
        np.array([core_h_mm]), np.array([core_w_mm]),
        np.array([array[0]]), np.array([array[1]]),
        np.array([reticle_mm[0]]), np.array([reticle_mm[1]]),
        np.array([tsv_region_mm2]), np.array([n_reticles]),
        np.array([integration == "infosow"]),
        target=target, max_spares=max_spares)
    return int(spares[0]), float(wy[0])
