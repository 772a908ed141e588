"""The port's GP surrogate (`repro_torch.core.gp`) against `repro`'s jitted
GP (`repro.core.gp.GP`) and its eager NumPy oracle (`gp_ref.NumpyGP`), on
the CPU, at the inputs and tolerances of tests/test_compiled_optimizer.py:
fit + predict within 2e-3 (the fits are float32 along one Adam trajectory),
`fit_pair` against separate fits within 1e-5, chained `condition_on` within
5e-3, `with_capacity` exact in its buffers. The masked NLL is non-finite exactly where
`repro`'s is, and in a fitted pair a GP whose NLL is non-finite freezes at
its initial parameters while the other one fits as if alone."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import gp as jgp  # noqa: E402
from repro.core.gp_ref import NumpyGP  # noqa: E402
from repro_torch.core import gp as tgp  # noqa: E402
from repro_torch.core.gp import GP, bucket_size  # noqa: E402

CPU = "cpu"


def _toy(rng, n, d=4):
    X = rng.random((n, d))
    y = np.sin(3.0 * X[:, 0]) + 0.5 * X[:, 1] + 0.05 * rng.standard_normal(n)
    return X, y


def test_bucket_size_matches_repro():
    assert [bucket_size(n) for n in range(0, 300)] == \
        [jgp.bucket_size(n) for n in range(0, 300)]
    assert [bucket_size(n, minimum=4) for n in range(0, 40)] == \
        [jgp.bucket_size(n, minimum=4) for n in range(0, 40)]


@pytest.mark.parametrize("n", [3, 8, 13])
def test_fit_predict_matches_repro_and_reference(n):
    rng = np.random.default_rng({3: 0, 8: 10, 13: 20}[n])
    X, y = _toy(rng, n)
    Xs = rng.random((17, X.shape[1]))
    gp = GP.fit(X, y, device=CPU)
    assert gp.capacity == bucket_size(n) and gp.n == n
    assert gp.dtype == torch.float32 and gp.device.type == "cpu"
    mu, sd = gp.predict(Xs)
    assert mu.dtype == np.float64 and sd.dtype == np.float64
    for other in (NumpyGP.fit(X, y), jgp.GP.fit(X, y)):
        mu_r, sd_r = other.predict(Xs)
        np.testing.assert_allclose(mu, mu_r, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(sd, sd_r, rtol=2e-3, atol=2e-3)
    # the fitted hyperparameters follow the same Adam trajectory
    ref = jgp.GP.fit(X, y)
    for k in ("log_ls", "log_sf", "log_noise"):
        np.testing.assert_allclose(gp.params[k].numpy(), ref.params[k],
                                   rtol=2e-3, atol=2e-3)


def test_fit_pair_matches_separate_fits_and_repro():
    rng = np.random.default_rng(1)
    X, y1 = _toy(rng, 9)
    y2 = -y1 + 0.1 * rng.standard_normal(len(y1))
    g1, g2 = GP.fit_pair(X, (y1, y2), device=CPU)
    s1, s2 = GP.fit(X, y1, device=CPU), GP.fit(X, y2, device=CPU)
    j1, j2 = jgp.GP.fit_pair(X, (y1, y2))
    Xs = rng.random((11, X.shape[1]))
    for g, s, j in ((g1, s1, j1), (g2, s2, j2)):
        np.testing.assert_allclose(g.predict(Xs)[0], s.predict(Xs)[0],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.predict(Xs)[0], j.predict(Xs)[0],
                                   rtol=2e-3, atol=2e-3)
    assert g1.X is g2.X and g1.mask is g2.mask


def test_fit_pair_freezes_each_objective_on_its_own():
    """Objective 0's targets are NaN, so its NLL is non-finite from the
    first step: it must keep its initial parameters (the reference loop
    breaks at once) while objective 1 fits exactly as it does alone, as in
    `repro`'s vmapped pair fit."""
    rng = np.random.default_rng(2)
    X, y = _toy(rng, 7)
    bad = np.full_like(y, np.nan)
    g_bad, g_ok = GP.fit_pair(X, (bad, y), device=CPU)
    j_bad, j_ok = jgp.GP.fit_pair(X, (bad, y))
    alone = GP.fit(X, y, device=CPU)
    init = {"log_ls": np.full(X.shape[1], np.log(np.float32(0.3))),
            "log_sf": np.float32(0.0), "log_noise": np.log(np.float32(0.05))}
    for k, v in init.items():
        np.testing.assert_array_equal(g_bad.params[k].numpy(),
                                      np.asarray(v, np.float32))
        np.testing.assert_array_equal(np.asarray(j_bad.params[k]),
                                      np.asarray(v, np.float32))
        np.testing.assert_allclose(g_ok.params[k].numpy(),
                                   alone.params[k].numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g_ok.params[k].numpy(), j_ok.params[k],
                                   rtol=2e-3, atol=2e-3)


def _nll_pair(log_sf, log_noise, n=6, d=3, dup=True, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.random((n, d)).astype(np.float32)
    if dup:
        X[1::2] = X[0::2]                 # duplicated rows
    y = rng.standard_normal(n).astype(np.float32)
    B = bucket_size(n)
    Xp = np.zeros((B, d), np.float32)
    Xp[:n] = X
    yp = np.zeros(B, np.float32)
    yp[:n] = y
    mask = np.zeros(B, np.float32)
    mask[:n] = 1.0
    log_ls = np.full(d, 3.0, np.float32)   # long lengthscales: K ~ sf * 1
    raw = {"log_ls": log_ls, "log_sf": np.float32(log_sf),
           "log_noise": np.float32(log_noise)}
    j = float(jgp._nll_masked(raw, Xp, yp, mask, np.float32(n)))
    t = tgp._nll_masked(torch.tensor(log_ls)[None], torch.tensor([log_sf]),
                        torch.tensor([log_noise]), torch.tensor(Xp),
                        torch.tensor(yp)[None], torch.tensor(mask), n)
    return j, float(t[0])


@pytest.mark.parametrize("log_sf,log_noise,conditioned", [
    (0.0, np.log(0.05), True), (4.0, np.log(0.05), True),
    (0.0, -20.0, False), (12.0, -20.0, False), (16.0, -30.0, False)])
def test_masked_nll_is_non_finite_where_repro_is(log_sf, log_noise,
                                                 conditioned):
    """torch's cholesky_ex returns a finite partial factor for a matrix that
    is not positive definite (info > 0) where JAX returns NaN; the port
    masks it, so the NLL's finiteness matches case by case (duplicated
    rows with a tiny noise are singular, or nearly so, in float32). Where
    the matrix is well conditioned the values agree too."""
    j, t = _nll_pair(log_sf, log_noise)
    assert np.isfinite(j) == np.isfinite(t), (j, t)
    if conditioned:
        assert np.isfinite(t)
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


def test_masked_nll_pair_keeps_the_finite_gp():
    """A batch of two GPs, one not positive definite: the other's value and
    gradient are those it has alone."""
    rng = np.random.default_rng(4)
    X = rng.random((6, 3)).astype(np.float32)
    X[1::2] = X[0::2]
    Y = rng.standard_normal((2, 8)).astype(np.float32)
    Y[:, 6:] = 0
    mask = torch.tensor([1.0] * 6 + [0.0] * 2)
    Xp = torch.zeros(8, 3)
    Xp[:6] = torch.tensor(X)
    ls = torch.full((2, 3), 3.0, requires_grad=True)
    sf = torch.tensor([16.0, 0.0], requires_grad=True)
    nz = torch.tensor([-30.0, float(np.log(0.05))], requires_grad=True)
    val = tgp._nll_masked(ls, sf, nz, Xp, torch.tensor(Y), mask, 6)
    g = torch.autograd.grad(val.sum(), (ls, sf, nz))
    assert not torch.isfinite(val[0]) and torch.isfinite(val[1])
    ls1 = ls[1:].detach().clone().requires_grad_(True)
    sf1 = sf[1:].detach().clone().requires_grad_(True)
    nz1 = nz[1:].detach().clone().requires_grad_(True)
    val1 = tgp._nll_masked(ls1, sf1, nz1, Xp, torch.tensor(Y[1:]), mask, 6)
    g1 = torch.autograd.grad(val1.sum(), (ls1, sf1, nz1))
    # equal up to float32 rounding: a batch of two may take another
    # LAPACK/BLAS code path than a batch of one
    torch.testing.assert_close(val[1].detach(), val1[0].detach(),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(g, g1):
        assert torch.isfinite(a[1]).all()
        torch.testing.assert_close(a[1], b[0], rtol=1e-5, atol=1e-6)


def test_condition_on_matches_repro_and_reference():
    rng = np.random.default_rng(2)
    X, y = _toy(rng, 7)
    Xs = rng.random((9, X.shape[1]))
    gp, ref, jg = GP.fit(X, y, device=CPU), NumpyGP.fit(X, y), jgp.GP.fit(X, y)
    # chain several rank-1 updates across a bucket boundary (7 -> 12 obs)
    for _ in range(5):
        x_new = rng.random(X.shape[1])
        y_new = float(np.sin(3.0 * x_new[0]))
        gp = gp.condition_on(x_new, y_new)
        ref = ref.condition_on(x_new, y_new)
        jg = jg.condition_on(x_new, y_new)
        mu, sd = gp.predict(Xs)
        for other in (ref, jg):
            mu_r, sd_r = other.predict(Xs)
            np.testing.assert_allclose(mu, mu_r, rtol=5e-3, atol=5e-3)
            np.testing.assert_allclose(sd, sd_r, rtol=5e-3, atol=5e-3)
    assert gp.n == 12 and gp.capacity == 16
    np.testing.assert_allclose(gp.chol.numpy(), np.asarray(jg.chol),
                               rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("capacity", [16, 32, 64])
def test_with_capacity_is_exact(capacity):
    """The grown buffers are the old ones bit for bit, with identity/zero
    padding. Predictions then agree to float32 rounding (a longer matmul
    may sum in another order; they were bit-equal on the CPU this was
    written on)."""
    rng = np.random.default_rng(4)
    X, y = _toy(rng, 6)
    gp = GP.fit(X, y, device=CPU)
    big = gp.with_capacity(capacity)
    assert big.capacity == capacity and gp.with_capacity(4) is gp
    L = big.chol.numpy()
    np.testing.assert_array_equal(L[:8, :8], gp.chol.numpy())
    np.testing.assert_array_equal(L[8:, 8:], np.eye(capacity - 8))
    np.testing.assert_array_equal(L[:8, 8:], 0)
    np.testing.assert_array_equal(L[8:, :8], 0)
    for a, b in ((big.X, gp.X), (big.y, gp.y), (big.alpha, gp.alpha),
                 (big.mask, gp.mask)):
        np.testing.assert_array_equal(a.numpy()[:8], b.numpy())
        np.testing.assert_array_equal(a.numpy()[8:], 0)
    Xs = rng.random((5, X.shape[1]))
    np.testing.assert_allclose(np.asarray(big.predict(Xs)),
                               np.asarray(gp.predict(Xs)), rtol=1e-6,
                               atol=1e-7)


def test_gp_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _toy(np.random.default_rng(5), 4)
    with pytest.raises(RuntimeError, match="no CUDA"):
        GP.fit(X, y)
    with pytest.raises(RuntimeError, match="no CUDA"):
        GP.fit_pair(X, (y, y))
