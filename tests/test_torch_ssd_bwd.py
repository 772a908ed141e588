"""The SSD scan's backward on the CPU: `ssd_chunked_bwd_ref`, the plain
version the CUDA backward is held against, against torch autograd through
the plain forward in float64 and against `jax.vjp` of `repro`'s
`ssd_chunked_ref` in fp32; `SSDScanFn` under gradcheck; `ops.ssd` under
autograd. Inputs are made with numpy from a seed.

Tolerances: against autograd in float64, 1e-10 of each gradient's largest
magnitude (the two compute the same sums in other orders; measured
~6e-15). Against `jax.vjp` in fp32, 2e-5 of each gradient's largest
magnitude: both sum fp32 terms in other orders, and dA, a sum over every
(b, s) of a reverse cumsum, carries the most of it (measured <= ~4e-6).
`jax.vjp` is compared at chunk 16: at chunk 128 these inputs' |dt A| over a
chunk passes ~88, and `repro`'s exp over the whole Q x Q square overflows
in fp32, so its gradients are NaN there (a hazard of the reference, held
by its own test below; the port's backward masks first).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.ssd_scan.ref import ssd_chunked_ref as jax_ssd_chunked_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_scan, ssd_scan_bwd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked_bwd_ref,
    ssd_chunked_ref,
    ssd_ref,
)

NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")
CASES = [
    # (B, S, H, P, N, chunk)
    (1, 32, 2, 8, 16, 16),
    (2, 100, 3, 8, 16, 16),       # ragged S: 100 % 16 != 0
    (1, 300, 2, 4, 16, 128),      # chunk 128, ragged
    (2, 64, 1, 8, 128, 16),       # N 128, H = 1
    (1, 256, 4, 4, 128, 128),     # N 128, chunk 128, two chunks
]


def _inputs(case, seed=0, dt_scale=1.0):
    """numpy inputs in the distribution of the JAX kernel tests, and the
    output cotangents dy and dhT."""
    B, S, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = dt_scale * np.logaddexp(0.0, rng.standard_normal((B, S, H)))
    A = -np.exp(rng.standard_normal(H) * 0.5)
    Bm = rng.standard_normal((B, S, N))
    Cm = rng.standard_normal((B, S, N))
    D = np.linspace(0.2, 1.0, H)
    dy = rng.standard_normal((B, S, H, P))
    dhT = rng.standard_normal((B, H, P, N))
    return (x, dt, A, Bm, Cm, D), dy, dhT


def _t(arrays, dtype):
    return [torch.tensor(a, dtype=dtype) for a in arrays]


def _autograd(fwd, ins, dy, dhT):
    """Gradients of sum(y * dy) + sum(hT * dhT) through `fwd` by autograd."""
    ins = [t.clone().requires_grad_(True) for t in ins]
    y, h = fwd(*ins)[:2]
    loss = (y * dy).sum() + (h * dhT).sum()
    return torch.autograd.grad(loss, ins)


def _assert_close(got, want, tol):
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        scale = w.abs().max().item()
        err = (g.double() - w.double()).abs().max().item()
        assert err <= tol * scale, f"{name}: max|d| {err:.3g} against {tol:g} * {scale:.3g}"


@pytest.mark.parametrize("with_dhT", [False, True], ids=["dhT0", "dhT"])
@pytest.mark.parametrize("case", CASES)
def test_bwd_ref_matches_autograd_in_float64(case, with_dhT):
    arrays, dy, dhT = _inputs(case)
    ins = _t(arrays, torch.float64)
    dy, dhT = torch.tensor(dy), torch.tensor(dhT)
    if not with_dhT:
        dhT = torch.zeros_like(dhT)
    want = _autograd(lambda *a: ssd_chunked_ref(*a, chunk=case[-1]), ins, dy, dhT)
    _, _, h_prev = ssd_chunked_ref(*ins, chunk=case[-1], return_states=True)
    got = ssd_chunked_bwd_ref(*ins, h_prev, dy, dhT if with_dhT else None, chunk=case[-1])
    assert all(g.dtype == torch.float64 for g in got)
    _assert_close(got, want, 1e-10)


def test_bwd_ref_stays_finite_where_the_square_exponent_overflows():
    """dt ~ 50 against A ~ -1: |dt A| over a chunk of 16 passes 709, so the
    plain forward's exp over the whole Q x Q square overflows to inf above
    the diagonal even in float64 and autograd through it turns 0 * inf into
    NaN. The backward masks the exponent first: its gradients are finite and
    equal autograd through the token-by-token recurrence."""
    case = (1, 48, 2, 4, 16, 16)
    arrays, dy, dhT = _inputs(case, seed=2, dt_scale=50.0)
    ins = _t(arrays, torch.float64)
    dy, dhT = torch.tensor(dy), torch.tensor(dhT)
    x, dt, A = ins[:3]
    cum = torch.cumsum((dt * A).reshape(1, 3, 16, 2), 2)
    assert torch.isinf(torch.exp(cum[:, :, :, None] - cum[:, :, None])).any()
    square = _autograd(lambda *a: ssd_chunked_ref(*a, chunk=16), ins, dy, dhT)
    assert not all(torch.isfinite(g).all() for g in square)
    want = _autograd(ssd_ref, ins, dy, dhT)
    _, _, h_prev = ssd_chunked_ref(*ins, chunk=16, return_states=True)
    got = ssd_chunked_bwd_ref(*ins, h_prev, dy, dhT, chunk=16)
    _assert_close(got, want, 1e-10)
    # and in fp32, where the square overflows past ~88
    got32 = ssd_chunked_bwd_ref(*(t.float() for t in ins), h_prev.float(), dy.float(),
                                dhT.float(), chunk=16)
    assert all(torch.isfinite(g).all() for g in got32)


def _jax_and_ours(case, seed=1):
    """(jax.vjp of repro's ssd_chunked_ref, ssd_chunked_bwd_ref), fp32, on
    the same numpy inputs and cotangents."""
    arrays, dy, dhT = _inputs(case, seed)
    arrays = [a.astype(np.float32) for a in arrays]
    dy, dhT = dy.astype(np.float32), dhT.astype(np.float32)
    chunk = case[-1]
    _, vjp = jax.vjp(lambda *a: jax_ssd_chunked_ref(*a, chunk=chunk),
                     *(jnp.asarray(a) for a in arrays))
    want = [torch.tensor(np.asarray(g)) for g in vjp((jnp.asarray(dy), jnp.asarray(dhT)))]
    ins = _t(arrays, torch.float32)
    _, _, h_prev = ssd_chunked_ref(*ins, chunk=chunk, return_states=True)
    got = ssd_chunked_bwd_ref(*ins, h_prev, torch.from_numpy(dy), torch.from_numpy(dhT),
                              chunk=chunk)
    assert all(g.dtype == torch.float32 for g in got)
    return want, got, (arrays, dy, dhT)


@pytest.mark.parametrize("case", [c for c in CASES if c[-1] == 16])
def test_bwd_ref_matches_jax_vjp_of_repros_chunked_ref(case):
    want, got, _ = _jax_and_ours(case)
    _assert_close(got, want, 2e-5)


def test_repros_chunked_ref_vjp_overflows_at_chunk_128_and_ours_does_not():
    """At chunk 128 (the kernel's and the models' chunk) jax.vjp of repro's
    plain chunked forward gives NaN, the exp(seg) overflow above the
    diagonal; the port's backward gives autograd's float64 gradients through
    the token-by-token recurrence within chip_smoke.py's fp32 rule, 3e-4 of
    each gradient's largest magnitude: L spans ~90 over a chunk here, and
    the chunked form's fp32 differences L_t - L_s carry ~5e-6 relative
    error into every decay (measured: dA 1.1e-4, the others <= 8.5e-6;
    autograd through the recurrence in fp32: <= 1.3e-6)."""
    case = CASES[2]
    want, got, (arrays, dy, dhT) = _jax_and_ours(case)
    assert not all(torch.isfinite(g).all() for g in want)
    exact = _autograd(ssd_ref, _t(arrays, torch.float64), torch.tensor(dy, dtype=torch.float64),
                      torch.tensor(dhT, dtype=torch.float64))
    _assert_close(got, exact, 3e-4)


def test_ssd_scan_fn_passes_gradcheck_on_the_cpu():
    case = (2, 20, 2, 3, 4, 8)       # ragged: three chunks, the last of 4 rows
    arrays, _, _ = _inputs(case, seed=3)
    ins = [t.requires_grad_(True) for t in _t(arrays, torch.float64)]
    assert torch.autograd.gradcheck(lambda *a: ops.SSDScanFn.apply(*a, case[-1]), ins)


def test_ops_ssd_under_autograd_on_the_cpu():
    """With an input that needs a gradient, ops.ssd goes through SSDScanFn
    (the plain pair on the CPU, no kernel launch): the outputs carry its
    grad_fn, the values are ssd_chunked_ref's bit for bit, and an unused
    final state costs nothing (its gradient is None, not zeros)."""
    case = CASES[1]
    arrays, dy, _ = _inputs(case)
    ins = _t(arrays, torch.float32)
    ins[0].requires_grad_(True)
    before = (ssd_scan.launches, ssd_scan_bwd.launches)
    y, h = ops.ssd(*ins, chunk=case[-1])
    assert type(y.grad_fn).__name__ == "SSDScanFnBackward" and h.grad_fn is y.grad_fn
    y0, h0 = ssd_chunked_ref(*ins, chunk=case[-1])
    assert torch.equal(y, y0) and torch.equal(h, h0)
    (dx,) = torch.autograd.grad((y * torch.tensor(dy, dtype=torch.float32)).sum(), ins[0])
    _, _, h_prev = ssd_chunked_ref(*ins, chunk=case[-1], return_states=True)
    want = ssd_chunked_bwd_ref(*(t.detach() for t in ins), h_prev,
                               torch.tensor(dy, dtype=torch.float32), chunk=case[-1])[0]
    assert torch.equal(dx, want)
    assert (ssd_scan.launches, ssd_scan_bwd.launches) == before
    with torch.no_grad():
        assert ops.ssd(*ins, chunk=case[-1])[0].grad_fn is None


def test_backward_wrapper_refuses_cpu_tensors():
    case = CASES[0]
    arrays, dy, _ = _inputs(case)
    ins = _t(arrays, torch.float32)
    _, _, h_prev = ssd_chunked_ref(*ins, chunk=case[-1], return_states=True)
    before = ssd_scan_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_bwd(*ins, h_prev, torch.tensor(dy, dtype=torch.float32), chunk=case[-1])
    assert ssd_scan_bwd.launches == before
