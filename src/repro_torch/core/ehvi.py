"""Exact 2-objective Expected Hypervolume Improvement (paper §VII), in torch
(the port of `repro.core.ehvi`).

Derivation (max-max space, independent Gaussian posteriors):

    HVI(y) = integral_{a=ref1}^{y1} (y2 - U(a))^+ da,
    U(a)   = max(ref2, max{v_j : f_j >= a})     (front upper envelope)

so with y1 independent of y2:

    EHVI = sum_strips  [ integral_strip P(y1 > a) da ] x E[(y2 - b_s)^+]

where the front splits obj-1 into strips with constant envelope b_s.
Both factors are closed-form:
    integral_l^u (1 - Phi((a-mu)/s)) da = s [H(z_u) - H(z_l)],
        H(z) = z (1 - Phi(z)) - phi(z)
    E[(Y - b)^+] = (mu - b)(1 - Phi(z_b)) + s phi(z_b),  z_b = (b-mu)/s

Two implementations: `ehvi_padded` is the device version (candidates x
strips in one broadcast, the front padded to a pow2 bucket with
(+inf, -inf) sentinels that sort past the real points and collapse to
zero-width strips); `ehvi_2d_ref` is the NumPy reference, copied verbatim
from `repro.core.ehvi`, that the device version is tested against.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import erf as _erf

from repro_torch.core.gp import bucket_size
from repro_torch.device import to_device

_SQRT2 = math.sqrt(2.0)
_SQRT_2PI = math.sqrt(2.0 * math.pi)


# ---------------------------------------------------------------------------
# NumPy reference (property-test oracle)
# ---------------------------------------------------------------------------


def _phi(z):
    return np.exp(-0.5 * z * z) / _SQRT_2PI


def _Phi(z):
    return 0.5 * (1.0 + _erf(np.asarray(z, float) / _SQRT2))


def _H(z):
    return z * (1.0 - _Phi(z)) - _phi(z)


def _strip_mass(l, u, mu, s):
    """integral_l^u P(Y1 > a) da, broadcast over strips x candidates."""
    s = np.maximum(s, 1e-12)
    zl = (l - mu) / s
    hu = np.where(np.isinf(u), 0.0, _H(np.where(np.isinf(u), 0.0,
                                                (u - mu) / s)))
    return s * (hu - _H(zl))


def _excess(b, mu, s):
    """E[(Y2 - b)^+], broadcast over strips x candidates."""
    s = np.maximum(s, 1e-12)
    z = (b - mu) / s
    return (mu - b) * (1.0 - _Phi(z)) + s * _phi(z)


def ehvi_2d_ref(mu: np.ndarray, sigma: np.ndarray, front: np.ndarray,
                ref: np.ndarray) -> np.ndarray:
    """NumPy EHVI for N candidates. mu/sigma (N, 2); front (F, 2) current
    Pareto set (may be empty); ref (2,). Returns (N,)."""
    mu = np.atleast_2d(np.asarray(mu, float))
    sigma = np.atleast_2d(np.asarray(sigma, float))
    ref = np.asarray(ref, float)
    if len(front) == 0:
        edges = np.array([ref[0], np.inf])
        bs = np.array([ref[1]])
    else:
        fr = np.asarray(front, float)
        order = np.argsort(fr[:, 0])            # ascending in obj1
        f = fr[order, 0]
        v = fr[order, 1]
        # envelope per strip: strip k = (edge_k, edge_{k+1}] with
        # edges = [ref1, f_1, ..., f_F, inf); U on (f_k, f_{k+1}] = v_{k+1}
        edges = np.concatenate([[ref[0]], f, [np.inf]])
        # strip k = (edge_k, edge_{k+1}]: level to beat is v_{k+1} (v is
        # descending in obj2 as obj1 ascends -> suffix max = next v);
        # strip F (beyond the front) only needs ref2
        bs = np.maximum(np.concatenate([v, [ref[1]]]), ref[1])
    l = edges[:-1, None]                        # (S, 1)
    u = edges[1:, None]
    b = bs[:, None]
    keep = (u > l)                              # degenerate strips drop out
    mass = np.maximum(_strip_mass(l, u, mu[None, :, 0], sigma[None, :, 0]),
                      0.0)
    exc = np.maximum(_excess(b, mu[None, :, 1], sigma[None, :, 1]), 0.0)
    return np.where(keep, mass * exc, 0.0).sum(axis=0)


# ---------------------------------------------------------------------------
# device version
# ---------------------------------------------------------------------------


def _Phi_t(z):
    return 0.5 * (1.0 + torch.special.erf(z / _SQRT2))


def _phi_t(z):
    return torch.exp(-0.5 * z * z) / _SQRT_2PI


def _H_t(z):
    return z * (1.0 - _Phi_t(z)) - _phi_t(z)


def ehvi_padded(mu, sg, pts, pts_mask, ref):
    """EHVI of N candidates over a padded point buffer, on the device.

    `pts` (F, 2) with `pts_mask` flagging real rows; the Pareto filter runs
    inside (O(F^2) masked dominance), so callers can hand it the raw
    fantasy buffer. Masked/dominated rows become (+inf, -inf) sentinels:
    they sort after every real front point (a stable sort keeps equal
    points in order), form zero-width [inf, inf) strips that the `keep`
    mask drops, and leave the beyond-front strip's envelope at
    max(-inf, ref2) = ref2 — exactly the unpadded strip set.
    """
    valid = pts_mask > 0
    ge = (pts[:, None, :] >= pts[None, :, :]).all(-1)
    gt = (pts[:, None, :] > pts[None, :, :]).any(-1)
    dominated = (valid[:, None] & ge & gt).any(0)
    on_front = valid & ~dominated
    o1 = torch.where(on_front, pts[:, 0], torch.inf)
    o2 = torch.where(on_front, pts[:, 1], -torch.inf)
    order = torch.argsort(o1, stable=True)
    f = o1[order]
    v = o2[order]
    edges = torch.cat([ref[0:1], f, torch.full_like(ref[0:1], torch.inf)])
    bs = torch.maximum(torch.cat([v, ref[1:2]]), ref[1])
    l = edges[:-1, None]                        # (S, 1)
    u = edges[1:, None]
    b = bs[:, None]
    keep = u > l
    s1 = torch.clamp_min(sg[None, :, 0], 1e-12)
    inf_u = torch.isinf(u)
    hu = torch.where(inf_u, 0.0, _H_t(torch.where(
        inf_u, 0.0, (u - mu[None, :, 0]) / s1)))
    mass = torch.clamp_min(s1 * (hu - _H_t((l - mu[None, :, 0]) / s1)), 0.0)
    s2 = torch.clamp_min(sg[None, :, 1], 1e-12)
    z = (b - mu[None, :, 1]) / s2
    exc = torch.clamp_min((mu[None, :, 1] - b) * (1.0 - _Phi_t(z))
                          + s2 * _phi_t(z), 0.0)
    return torch.where(keep, mass * exc, 0.0).sum(dim=0)


def ehvi_2d(mu: np.ndarray, sigma: np.ndarray, front: np.ndarray,
            ref: np.ndarray, device="cuda") -> np.ndarray:
    """EHVI for N candidates on `device` in float32. Same contract as
    `ehvi_2d_ref`; the front is padded to a pow2 bucket."""
    mu = np.atleast_2d(np.asarray(mu, np.float32))
    sigma = np.atleast_2d(np.asarray(sigma, np.float32))
    F = len(front)
    Fb = bucket_size(max(F, 1), minimum=4)
    pts = np.zeros((Fb, 2), np.float32)
    mask = np.zeros(Fb, np.float32)
    if F:
        pts[:F] = np.asarray(front, np.float32)
        mask[:F] = 1.0
    f32 = torch.float32
    with torch.no_grad():
        out = ehvi_padded(*(to_device(a, f32, device)
                            for a in (mu, sigma, pts, mask, ref)))
    return out.cpu().numpy().astype(np.float64)
