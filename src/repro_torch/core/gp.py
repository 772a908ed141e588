"""Gaussian-process surrogate in torch (the port of `repro.core.gp`, paper
§VII: one GP per fidelity and objective). Matern-5/2 ARD kernel, Cholesky
posterior, marginal-likelihood fit of (lengthscales, signal, noise) by Adam.

Every GP lives in a padded buffer of pow2 capacity B >= n with a 0/1 row
mask. Padded rows are inert by the block-diagonal trick: their kernel rows
and columns are zero, their diagonal is one and their targets are zero, so
the Cholesky factor of the padded matrix is [[L, 0], [0, I]]. That keeps
`with_capacity` exact and lets `condition_on` append an observation as a
rank-1 update at row n, O(B^2) and without refactorizing.

What differs from the JAX module, and why:

  * The fit is an eager Python loop of `iters` Adam steps through
    `torch.autograd` (JAX scans one compiled program). `fit_pair` fits both
    objectives as one (2, B, B) batch with a per-objective `frozen` flag:
    once a GP's NLL is non-finite its parameters and moments stop moving,
    as the reference's eager loop `break`s, and the other GP goes on.
  * `torch.linalg.cholesky_ex` returns a finite partial factor with
    `info > 0` for a matrix that is not positive definite, where
    `jnp.linalg.cholesky` returns NaN. `_chol` sets the factor to NaN
    wherever `info > 0`, so the NLL goes non-finite in the same cases.
    (`torch.linalg.cholesky` would raise, and on CUDA it waits for the card
    to check.)
  * Nothing in fit, predict or the rank-1 update reads a device value on
    the host: the fitted hyperparameters stay on the device (`params`), and
    the row index of a rank-1 update is a host integer, a one-hot row mask
    on the device. Only `predict` hands numpy back.

Everything runs on an explicit device; the default is the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device, to_device

MIN_BUCKET = 8
_SQRT5 = math.sqrt(5.0)
_LOG_2PI = math.log(2 * math.pi)


def bucket_size(n: int, minimum: int = MIN_BUCKET) -> int:
    """Smallest power of two >= max(n, minimum): the buffer capacities."""
    return max(minimum, 1 << max(int(n) - 1, 0).bit_length())


def _matern52(x1, x2, ls, sf):
    """x1 (n1, d), x2 (n2, d); ls (..., d) and sf (...) may carry a leading
    batch of GPs. Returns (..., n1, n2)."""
    r = (x1[:, None, :] - x2[None, :, :]) / ls[..., None, None, :]
    d = torch.sqrt(torch.clamp_min(torch.sum(r ** 2, -1), 1e-12))
    s5 = _SQRT5 * d
    return sf[..., None, None] * (1 + s5 + 5.0 * d * d / 3.0) * torch.exp(-s5)


def _masked_kernel(X, mask, ls, sf, noise):
    """K over the padded buffer: the real block intact, padded rows and
    columns e_i (unit diagonal). Batched over the leading axis of ls/sf."""
    K = _matern52(X, X, ls, sf) * (mask[:, None] * mask[None, :])
    return K + torch.diag_embed(torch.where(mask > 0, noise[..., None], 1.0))


def _chol(K):
    """Lower Cholesky factor, NaN where K is not positive definite."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info > 0)[..., None, None], torch.nan, L)


def _cho_solve(L, y):
    z = torch.linalg.solve_triangular(L, y[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, z, upper=True)[..., 0]


def _hyper(log_ls, log_sf, log_noise):
    return torch.exp(log_ls), torch.exp(log_sf), torch.exp(log_noise) + 1e-6


def _nll_masked(log_ls, log_sf, log_noise, X, Y, mask, n_real):
    """Masked negative log marginal likelihood of each GP in the batch
    (P, d), (P,), (P,) over the shared padded inputs X and targets Y (P, B).
    Returns (P,)."""
    ls, sf, noise = _hyper(log_ls, log_sf, log_noise)
    L = _chol(_masked_kernel(X, mask, ls, sf, noise))
    a = _cho_solve(L, Y)
    return (0.5 * torch.sum(Y * a, -1)
            + torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), -1)
            + 0.5 * n_real * _LOG_2PI)


def _adam(X, Y, mask, n_real: int, lr: float, iters: int):
    """`iters` Adam steps on every GP of the batch at once. A GP whose NLL
    goes non-finite freezes: every later update of its parameters and
    moments is a no-op, which lands on the parameters the reference loop
    `break`s with."""
    P, d = Y.shape[0], X.shape[1]
    kw = dict(dtype=X.dtype, device=X.device)
    f32 = np.float32
    raw = [torch.full((P, d), float(np.log(f32(0.3))), **kw),
           torch.zeros(P, **kw),
           torch.full((P,), float(np.log(f32(0.05))), **kw)]
    m = [torch.zeros_like(p) for p in raw]
    v = [torch.zeros_like(p) for p in raw]
    frozen = torch.zeros(P, dtype=torch.bool, device=X.device)
    for t in range(1, iters + 1):
        ps = [p.requires_grad_(True) for p in raw]
        val = _nll_masked(*ps, X, Y, mask, n_real)
        grads = torch.autograd.grad(val.sum(), ps)
        frozen = frozen | ~torch.isfinite(val.detach())
        # bias corrections as the reference computes them, in float32
        bc1 = float(f32(1) - f32(0.9) ** f32(t))
        bc2 = float(f32(1) - f32(0.999) ** f32(t))
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(ps, grads)):
                m2 = 0.9 * m[i] + 0.1 * g
                v2 = 0.999 * v[i] + 0.001 * g * g
                p2 = p - lr * (m2 / bc1) / (torch.sqrt(v2 / bc2) + 1e-8)
                fz = frozen.view((P,) + (1,) * (p.dim() - 1))
                raw[i] = torch.where(fz, p.detach(), p2)
                m[i] = torch.where(fz, m[i], m2)
                v[i] = torch.where(fz, v[i], v2)
    return raw


def _posterior(log_ls, log_sf, log_noise, X, Y, mask):
    ls, sf, noise = _hyper(log_ls, log_sf, log_noise)
    L = _chol(_masked_kernel(X, mask, ls, sf, noise))
    return L, _cho_solve(L, Y)


def _predict(Xs, X, mask, L, alpha, log_ls, log_sf, mean, std):
    """Posterior mean and std (de-normalized) at Xs, on the device."""
    sf = torch.exp(log_sf)
    Ks = _matern52(Xs, X, torch.exp(log_ls), sf) * mask[None, :]
    mu = Ks @ alpha
    v = torch.linalg.solve_triangular(L, Ks.T, upper=False)
    var = torch.clamp_min(sf - torch.sum(v * v, 0), 1e-10)
    return mu * std + mean, torch.sqrt(var) * std


def _rank1(X, y, mask, L, log_ls, log_sf, log_noise, n: int, x_new, y_norm):
    """Append (x_new, y_norm) at row n of the padded buffer: one masked
    kernel row, one triangular solve for the new Cholesky row, one
    Cholesky solve for alpha. Row n of L is e_n before the update (padding
    identity), so overwriting it is exact."""
    ls, sf, noise = _hyper(log_ls, log_sf, log_noise)
    k = _matern52(x_new[None, :], X, ls, sf)[0] * mask
    c = torch.linalg.solve_triangular(L, k[:, None], upper=False)[:, 0]
    dd = torch.sqrt(torch.clamp_min(sf + noise - c @ c, 1e-10))
    hot = torch.arange(X.shape[0], device=X.device) == n
    L2 = torch.where(hot[:, None], c[None, :], L)
    L2 = torch.where(hot[:, None] & hot[None, :], dd, L2)
    X2 = torch.where(hot[:, None], x_new[None, :], X)
    y2 = torch.where(hot, y_norm, y)
    mask2 = torch.where(hot, torch.ones_like(mask), mask)
    return X2, y2, mask2, L2, _cho_solve(L2, y2)


@dataclasses.dataclass
class GP:
    """Fitted GP over a padded buffer of capacity B (pow2 bucket >= n).

    `X`, `y` (normalized), `chol`, `alpha` and `mask` are (B, ...) tensors on
    one device; `mask` flags the n real rows. `params` holds the fitted
    log-hyperparameters as device tensors, shared by every `condition_on`
    fantasy (no refit). `mean`/`std` are the host-side target statistics.
    """
    X: torch.Tensor             # (B, d)
    y: torch.Tensor             # (B,) normalized targets, 0 on padding
    params: Dict[str, torch.Tensor]
    mean: float
    std: float
    chol: torch.Tensor          # (B, B) lower; identity on padded rows
    alpha: torch.Tensor         # (B,)
    mask: torch.Tensor          # (B,) 1.0 = real row
    n: int                      # real observation count

    @staticmethod
    def _fit_batch(X, ys, iters, lr, dtype, device):
        dev = resolve_device(device)
        X = np.asarray(X, np.float64)
        n, d = X.shape
        B = bucket_size(n)
        stats = [(float(np.mean(y)), float(np.std(y) + 1e-9)) for y in ys]
        np_dt = torch.empty((), dtype=dtype).numpy().dtype
        Xp = np.zeros((B, d), np_dt)
        Xp[:n] = X
        Yp = np.zeros((len(ys), B), np_dt)
        for i, (y, (m, s)) in enumerate(zip(ys, stats)):
            Yp[i, :n] = ((np.asarray(y) - m) / s).astype(np_dt)
        mask = np.zeros(B, np_dt)
        mask[:n] = 1.0
        Xt, Yt, mt = (to_device(a, dtype, dev) for a in (Xp, Yp, mask))
        raw = _adam(Xt, Yt, mt, n, lr, iters)
        with torch.no_grad():
            L, alpha = _posterior(*raw, Xt, Yt, mt)
        return [GP(Xt, Yt[i], {"log_ls": raw[0][i], "log_sf": raw[1][i],
                               "log_noise": raw[2][i]},
                   m, s, L[i], alpha[i], mt, n)
                for i, (m, s) in enumerate(stats)]

    @staticmethod
    def fit(X: np.ndarray, y: np.ndarray, iters: int = 80, lr: float = 0.05,
            dtype: torch.dtype = torch.float32, device="cuda") -> "GP":
        """Adam over the masked marginal likelihood, then the posterior
        factorization; `dtype` is threaded through the whole fit."""
        return GP._fit_batch(X, [y], iters, lr, dtype, device)[0]

    @staticmethod
    def fit_pair(X: np.ndarray, ys: Tuple[np.ndarray, np.ndarray],
                 iters: int = 80, lr: float = 0.05,
                 dtype: torch.dtype = torch.float32, device="cuda"
                 ) -> Tuple["GP", "GP"]:
        """Fit the two GPs that share inputs X (the per-objective surrogate
        pair) as one batch, each with its own freeze flag."""
        g0, g1 = GP._fit_batch(X, list(ys), iters, lr, dtype, device)
        return g0, g1

    @property
    def capacity(self) -> int:
        return self.X.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.X.dtype

    @property
    def device(self) -> torch.device:
        return self.X.device

    def with_capacity(self, capacity: int) -> "GP":
        """Re-pad into a larger buffer. The padded kernel is block-diagonal
        [[K, 0], [0, I]], so the grown Cholesky factor and alpha are the old
        ones with identity/zero padding, no refactorization."""
        B0 = self.capacity
        if capacity <= B0:
            return self
        kw = dict(dtype=self.dtype, device=self.device)
        X2 = torch.zeros((capacity, self.X.shape[1]), **kw)
        X2[:B0] = self.X
        y2, m2, a2 = (torch.zeros(capacity, **kw) for _ in range(3))
        y2[:B0] = self.y
        m2[:B0] = self.mask
        a2[:B0] = self.alpha
        L2 = torch.eye(capacity, **kw)
        L2[:B0, :B0] = self.chol
        return GP(X2, y2, self.params, self.mean, self.std, L2, a2, m2,
                  self.n)

    def predict(self, Xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean/std at Xs (de-normalized) as float64 numpy."""
        with torch.no_grad():
            mu, sd = _predict(to_device(Xs, self.dtype, self.device), self.X,
                              self.mask, self.chol, self.alpha,
                              self.params["log_ls"], self.params["log_sf"],
                              self.mean, self.std)
        return (mu.cpu().numpy().astype(np.float64),
                sd.cpu().numpy().astype(np.float64))

    def condition_on(self, x: np.ndarray, y: float) -> "GP":
        """Posterior GP after observing (x, y): a rank-1 Cholesky append,
        no hyperparameter refit (the fantasy update of greedy q-EHVI)."""
        g = self.with_capacity(bucket_size(self.n + 1))
        yn = (float(y) - g.mean) / g.std
        x_dev = to_device(np.asarray(x).reshape(-1), g.dtype, g.device)
        with torch.no_grad():
            X2, y2, m2, L2, a2 = _rank1(
                g.X, g.y, g.mask, g.chol, g.params["log_ls"],
                g.params["log_sf"], g.params["log_noise"], g.n, x_dev,
                torch.full((), yn, dtype=g.dtype, device=g.device))
        return GP(X2, y2, g.params, g.mean, g.std, L2, a2, m2, g.n + 1)
