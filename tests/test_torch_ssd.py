"""The port's SSD scan against the JAX package's: the plain PyTorch versions
(`ssd_chunked_ref`, `ssd_ref`, `ssd_decode_step_ref`) against `repro`'s
Pallas kernel in interpret mode and its sequential oracle, on the cases of
tests/test_kernels_ssd.py in fp32 and bf16. Inputs are made with numpy from
a seed and handed to both frameworks.

Tolerances: fp32 3e-4 and bf16 4e-2 (abs and rel), the JAX kernel tests'
own; decode-step consistency 2e-4 in fp32, as there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.ssd_scan.kernel import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked_ref,
    ssd_decode_step_ref,
    ssd_ref,
)

CASES = [
    # (B, S, H, P, N, chunk)
    (1, 32, 2, 8, 8, 8),
    (2, 64, 4, 16, 16, 16),
    (1, 100, 2, 16, 8, 32),      # padding path (100 % 32 != 0)
    (2, 128, 2, 32, 16, 128),    # single chunk
]
DTYPES = {"fp32": (torch.float32, jnp.float32, 3e-4),
          "bf16": (torch.bfloat16, jnp.bfloat16, 4e-2)}


def _inputs(case, seed=0):
    """fp32 numpy inputs in the distribution of the JAX kernel tests."""
    B, S, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, S, N), dtype=np.float32)
    Cm = rng.standard_normal((B, S, N), dtype=np.float32)
    D = np.linspace(0.2, 1.0, H, dtype=np.float32)
    return x, dt, A, Bm, Cm, D


def _both(case, dname, seed=0):
    """(torch tensors, jax arrays) holding identical values: x, dt, B, C are
    rounded to the dtype on both sides; dt goes in as fp32 after that."""
    tdt, jdt, _ = DTYPES[dname]
    x, dt, A, Bm, Cm, D = _inputs(case, seed)
    t = [torch.from_numpy(v) for v in (x, dt, A, Bm, Cm, D)]
    t[0], t[3], t[4] = t[0].to(tdt), t[3].to(tdt), t[4].to(tdt)
    t[1] = t[1].to(tdt).float()
    j = [jnp.asarray(x, jdt), jnp.asarray(t[1].numpy()), jnp.asarray(A),
         jnp.asarray(Bm, jdt), jnp.asarray(Cm, jdt), jnp.asarray(D)]
    return t, j


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_chunked_matches_jax_kernel_and_oracle(case, dname):
    tol = DTYPES[dname][2]
    t, j = _both(case, dname)
    y, h = ssd_chunked_ref(*t, chunk=case[-1])
    assert y.dtype == t[0].dtype and h.dtype == torch.float32
    yk, hk = jax_ssd_scan(*j, chunk=case[-1], interpret=True)
    y0, h0 = jax_ssd_ref(*j)
    _close(y.float(), yk.astype(jnp.float32), tol)
    _close(h, hk, tol)
    _close(y.float(), y0.astype(jnp.float32), tol)
    _close(h, h0, tol)


@pytest.mark.parametrize("case", CASES[:2])
def test_sequential_matches_jax_oracle(case):
    t, j = _both(case, "fp32")
    y, h = ssd_ref(*t)
    y0, h0 = jax_ssd_ref(*j)
    _close(y, y0, 3e-4)
    _close(h, h0, 3e-4)


def test_decode_step_consistency():
    """The recurrence one token at a time reproduces the scan, in the port
    and against the JAX oracle."""
    case = (2, 16, 2, 8, 8, 8)
    t, j = _both(case, "fp32", seed=3)
    x, dt, A, Bm, Cm, D = t
    y_full, h_full = ssd_chunked_ref(*t, chunk=8)
    B, S, H, P = x.shape
    h = torch.zeros(B, H, P, Bm.shape[-1])
    ys = []
    for i in range(S):
        y_i, h = ssd_decode_step_ref(h, x[:, i], dt[:, i], A, Bm[:, i], Cm[:, i], D)
        ys.append(y_i)
    y_steps = torch.stack(ys, 1)
    _close(y_steps, y_full, 2e-4)
    _close(h, h_full, 2e-4)
    y0, h0 = jax_ssd_ref(*j)
    _close(y_steps, y0, 2e-4)
    _close(h, h0, 2e-4)


def test_ops_on_cpu_uses_plain_version_without_launching():
    case = CASES[2]
    t, _ = _both(case, "fp32")
    before = ssd_scan.launches
    y, h = ops.ssd(*t, chunk=case[-1])
    y0, h0 = ssd_chunked_ref(*t, chunk=case[-1])
    assert ssd_scan.launches == before
    assert torch.equal(y, y0) and torch.equal(h, h0)
    assert ops.ssd_decode_step is ssd_decode_step_ref


def test_kernel_wrapper_refuses_cpu_tensors():
    t, _ = _both(CASES[0], "fp32")
    before = ssd_scan.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(*t, chunk=8)
    assert ssd_scan.launches == before



def _split(t, split):
    """fp32 t as bf16 hi + lo (`split`) or as one bf16 value (lo = 0)."""
    hi = t.bfloat16().float()
    return hi, ((t - hi).bfloat16().float() if split else torch.zeros_like(t))


def _emulate_mma_kernels(x, dt, A, Bm, Cm, D, chunk, *, split: bool):
    """The rounding points of the bf16 tensor-core kernels (chunk_state,
    state_pass, chunk_scan), in plain PyTorch on the CPU, for S a multiple
    of the chunk: bf16 x, B, C; fp32 cumsum, decays and sums; the fp32
    factor of each product (x', M, h_prev) cast to bf16 as hi + lo
    (`split`) or as one value; C B^T exact; D x in fp32; one cast of y."""
    Bsz, S, H, P = x.shape
    N, Q = Bm.shape[-1], chunk
    nc = S // Q
    xf = x.float().reshape(Bsz, nc, Q, H, P)
    Bf = Bm.float().reshape(Bsz, nc, Q, N)
    Cf = Cm.float().reshape(Bsz, nc, Q, N)
    dtf = dt.float().reshape(Bsz, nc, Q, H)
    cum = torch.cumsum(dtf * A, dim=2)                                  # (B,nc,Q,H)
    # chunk_state: S_c = x'^T B, x' = exp(L_Q - L_s) dt_s x_s
    xw = (torch.exp(cum[:, :, -1:] - cum) * dtf)[..., None] * xf
    states = sum(torch.einsum("bcqhp,bcqn->bchpn", t, Bf) for t in _split(xw, split))
    # state_pass
    h = torch.zeros(Bsz, H, P, N)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = torch.exp(cum[:, c, -1])[..., None, None] * h + states[:, c]
    h_prev = torch.stack(h_prev, 1)                                     # (B,nc,H,P,N)
    # chunk_scan: y = M x + exp(L_t) C h_prev^T + D x
    cb = torch.einsum("bctn,bcsn->bcts", Cf, Bf)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]                 # (B,nc,t,s,H)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[None, None, :, :, None]
    m = torch.where(tri, cb[..., None] * torch.exp(seg) * dtf[:, :, None], torch.zeros(()))
    y = sum(torch.einsum("bctsh,bcshp->bcthp", t, xf) for t in _split(m, split))
    inter = sum(torch.einsum("bctn,bchpn->bcthp", Cf, t) for t in _split(h_prev, split))
    y = y + torch.exp(cum)[..., None] * inter
    y = y.reshape(Bsz, S, H, P) + D[None, None, :, None] * x.float()
    return y.to(x.dtype), h


@pytest.mark.parametrize("split", [True, False], ids=["hi+lo", "one_bf16"])
def test_kernel_rounding_design_meets_the_bf16_rule(split):
    """At (1, 1024, 4, 64, 128, Q=128) the bf16 kernels' rounding, emulated,
    meets the rule chip_smoke.py holds the kernel to against
    `ssd_chunked_ref` (y within 1e-2 * |ref| + 3e-4 * max|y| per element,
    the state within 3e-4 * max|h|) with x', M and h_prev split into two
    bf16 terms, and misses it with each rounded to one bf16 value."""
    case = (1, 1024, 4, 64, 128, 128)
    t, _ = _both(case, "bf16")
    y0, h0 = ssd_chunked_ref(*t, chunk=case[-1])
    y, h = _emulate_mma_kernels(*t, case[-1], split=split)
    y0f = y0.float()
    ay = 3e-4 * max(1.0, y0f.abs().max().item())
    bad_y = int(((y.float() - y0f).abs() > 1e-2 * y0f.abs() + ay).sum())
    dh, th = (h - h0).abs().max().item(), 3e-4 * max(1.0, h0.abs().max().item())
    assert (bad_y == 0 and dh <= th) == split, f"{bad_y} elements of y outside the rule, " \
                                               f"max|dh| {dh:.3g} against {th:.3g}"


def test_ops_passes_strided_views_to_the_kernel_uncopied(monkeypatch):
    """ops.ssd hands x, B and C to the kernel wrapper as they come (the
    split views of the conv output, as models/mamba2.py passes them): no
    per-layer copy. Meta tensors stand in for CUDA ones (neither lies on
    the CPU), and a recorder stands in for the wrapper."""
    B, S, H, P, N = 1, 16, 2, 8, 8
    packed = torch.empty(B, S, H * P + 2 * N, dtype=torch.bfloat16, device="meta")
    xs, Bm, Cm = packed.split([H * P, N, N], -1)
    x = xs.unflatten(-1, (H, P))
    dt = torch.empty(B, S, H, device="meta")
    A, D = torch.empty(H, device="meta"), torch.empty(H, device="meta")
    seen = []
    monkeypatch.setattr(ops, "ssd_scan", lambda *a, **kw: seen.append(a) or (None, None))
    ops.ssd(x, dt, A, Bm, Cm, D, chunk=8)
    (args,) = seen
    assert args[0] is x and args[3] is Bm and args[4] is Cm
    assert not x.is_contiguous() and not Bm.is_contiguous()
