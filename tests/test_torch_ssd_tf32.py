"""The split-TF32 arithmetic of K2's fp32 forward and of its backward,
emulated on the CPU.

The CUDA kernels (src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu: the
forward's `chunk_state_tf32_kernel`, `state_pass_kernel` and
`chunk_scan_tf32_kernel`; the backward's `ssd_bwd_cbds_kernel`,
`chunk_state_tf32_kernel<true>`, `ssd_bwd_chunk_tf32_kernel`,
`ssd_bwd_bc_tf32_kernel` and `ssd_bwd_bc_sum_tf32_kernel`) take every
product of two fp32 operands on the tensor cores as three TF32 products
lo_a hi_b + hi_a lo_b + hi_a hi_b of the operands split into hi = tf32(v)
and lo = tf32(v - hi), into one fp32 accumulator; everything between the
products (the cumsum, the decays, the masks, the state passes, the row
dots) is fp32. Here that arithmetic is written in plain torch, product by
product as the kernels take them: TF32 rounding by integer bit operations
(`tf32`, `split` of tests/test_torch_flash_tf32.py), exact products and
sums in float64, each accumulator rounded to fp32 (an accumulator that
starts from an fp32 value, as y's and dB's and dC's do, adds it before the
one rounding). The model leaves out the tensor cores' own accumulation,
which rounds toward zero; the kernels add each k-step's products to their
running sum in IEEE fp32 to keep that error at fp32's.

The emulated forward (y, the final state, the states entering each chunk)
and backward (dx, ddt, dA, dB, dC, dD) are held against `ssd_chunked_ref`
and `ssd_chunked_bwd_ref` in float64 under chip_smoke.py phase 20 (a)'s
rule, |d| <= 3e-4 max|ref| for each output, at the training shapes cut in
batch and heads, (1, 256, 4, 64, 128) and (1, 256, 4, 64, 64) with Q = 128,
and a ragged S = 200. One TF32 product per fp32 one at the same inputs
lands at least 10x farther from float64, so the split cannot be dropped
quietly. The backward's Hopper route (fp32 at Q = 128, P = 64, N 64 or
128: `ssd_bwd_dx_kernel`, `ssd_bwd_dbc_kernel`, `ssd_bwd_dbc_sum_kernel`
after the three kernels it shares) has its own rounding points,
`emulated_hopper_backward`: its operands split once, each TF32 wgmma
product summed from zero and rounded toward zero as the tensor cores
round, the products joined and the heads summed in IEEE fp32; held to the
same rule at those cases and at (2, 300, 4, 64, 128), where a
round-toward-zero sum once cost dA its rule. Inputs are chip_smoke.py's distribution (x, B, C standard normal,
dt softplus of a normal, A = -exp(0.5 normal), D linspace(0.2, 1)), from
numpy with a seed.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd_ref, ssd_chunked_ref
from repro_torch.kernels.ssd_scan.kernel import backward_kernels, bwd_on_hopper
from test_torch_flash_tf32 import one_thread, rz, split, tf32  # noqa: F401 (one_thread: a fixture)

# (B, S, H, P, N, chunk): mamba2's and zamba2's training shapes cut to one
# sequence of 4 heads, and a ragged S
CASES = [(1, 256, 4, 64, 128, 128), (1, 256, 4, 64, 64, 128), (1, 200, 4, 64, 64, 128)]
FWD_NAMES = ("y", "final state", "states")
BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")


def _acc(eq, pairs, init=None):
    """One fp32 accumulator: `init` (fp32, or None) plus the einsums of the
    (a, b) pairs, exact in float64, rounded to fp32 once."""
    total = sum(torch.einsum(eq, a.double(), b.double()) for a, b in pairs)
    return (total if init is None else total + init.double()).float()


def mm3(eq, a, b, init=None):
    (ah, al), (bh, bl) = split(a), split(b)
    return _acc(eq, [(al, bh), (ah, bl), (ah, bh)], init)


def mm1(eq, a, b, init=None):
    return _acc(eq, [(tf32(a), tf32(b))], init)


def _inputs(case, seed=0):
    B, S, H, P, N, _ = case
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    x = f32(rng.standard_normal((B, S, H, P)))
    dt = F.softplus(f32(rng.standard_normal((B, S, H))))
    A = -torch.exp(f32(rng.standard_normal(H)) * 0.5)
    Bm, Cm = f32(rng.standard_normal((B, S, N))), f32(rng.standard_normal((B, S, N)))
    D = torch.linspace(0.2, 1.0, H)
    dy = f32(rng.standard_normal((B, S, H, P)))
    dhT = f32(rng.standard_normal((B, H, P, N)))
    return (x, dt, A, Bm, Cm, D), dy, dhT


def _chunked(t, Q):
    pad = (-t.shape[1]) % Q
    if pad:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape(t.shape[0], -1, Q, *t.shape[2:])


def _rows(t, S):
    return t.reshape(t.shape[0], -1, *t.shape[3:])[:, :S]


def _scan_terms(dt, A, Q):
    """L (B, nc, Q, H), L_Q, the masked decay exp(L_t - L_s) (B, nc, t, s, H)
    and exp(L_t), all fp32 (the exponent masked to s <= t before exp)."""
    dtf = _chunked(dt, Q)
    cum = torch.cumsum(dtf * A, dim=2)
    lq = cum[:, :, -1]
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[None, None, :, :, None]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    decay = torch.exp(torch.where(tri, seg, torch.tensor(-torch.inf)))
    return dtf, cum, lq, decay, torch.exp(cum)


def emulated_forward(args, chunk, mm=mm3):
    """The fp32 forward's three stages: S_c = x'^T B with x' = exp(L_Q - L)
    dt x, the state pass, then y = exp(L_t) C h_prev^T + M x + D x with
    M = (C B^T) o decay o dt_s. Returns (y, the final state, h_prev)."""
    x, dt, A, Bm, Cm, D = args
    Bsz, S, H, P = x.shape
    N, Q = Bm.shape[-1], min(chunk, S)
    xf, Bf, Cf = _chunked(x, Q), _chunked(Bm, Q), _chunked(Cm, Q)
    dtf, cum, lq, decay, el = _scan_terms(dt, A, Q)
    xp = (torch.exp(lq[:, :, None] - cum) * dtf)[..., None] * xf
    chunk_states = mm("bcqhp,bcqn->bchpn", xp, Bf)
    h, h_prev = torch.zeros(Bsz, H, P, N), []
    for c in range(xf.shape[1]):
        h_prev.append(h)
        h = torch.exp(lq[:, c])[..., None, None] * h + chunk_states[:, c]
    h_prev = torch.stack(h_prev, 1)
    cb = mm("bctn,bcsn->bcts", Cf, Bf)
    m = cb[..., None] * decay * dtf[:, :, None]
    yh = mm("bctn,bchpn->bcthp", Cf, h_prev) * el[..., None]
    y = mm("bctsh,bcshp->bcthp", m, xf, init=yh)
    return _rows(y, S) + D[:, None] * x, h, h_prev


def emulated_backward(args, h_prev, dy, dhT, chunk, mm=mm3):
    """The backward's products as the kernels take them: C B^T; each head's
    dy x^T decayed and summed over heads into dS; U = (exp(L) dy)^T C and
    the reverse state pass; y = exp(L_t) C h_prev^T + M' (dt x) for dL,
    dxs = B dH^T, dxi = M'^T dy; the state terms of dC and dB over (head,
    channel), then + dS B and + dS^T C into the same accumulators."""
    x, dt, A, Bm, Cm, D = args
    Bsz, S, H, P = x.shape
    N, Q = Bm.shape[-1], min(chunk, S)
    xf, Bf, Cf, dyf = (_chunked(t, Q) for t in (x, Bm, Cm, dy))
    dtf, cum, lq, decay, el = _scan_terms(dt, A, Q)
    tail = torch.exp(lq[:, :, None] - cum)
    w = tail * dtf
    cb = mm("bctn,bcsn->bcts", Cf, Bf)
    mprime = cb[..., None] * decay
    ds = (mm("bcthp,bcshp->bctsh", dyf, xf) * decay * dtf[:, :, None]).sum(-1)
    u = mm("bcthp,bctn->bchpn", el[..., None] * dyf, Cf)
    g, dh = (torch.zeros(Bsz, H, P, N) if dhT is None else dhT), []
    for c in reversed(range(xf.shape[1])):
        dh.append(g)
        g = torch.exp(lq[:, c])[..., None, None] * g + u[:, c]
    dh = torch.stack(dh[::-1], 1)
    yh = mm("bctn,bchpn->bcthp", Cf, h_prev) * el[..., None]
    y = mm("bctsh,bcshp->bcthp", mprime, dtf[..., None] * xf, init=yh)
    dxs = mm("bcsn,bchpn->bcshp", Bf, dh)
    dxi = mm("bctsh,bcthp->bcshp", mprime, dyf)
    dx = dtf[..., None] * dxi + w[..., None] * dxs + D[:, None] * dyf
    xds = (xf * dxs).sum(-1)
    direct = (xf * dxi).sum(-1) + tail * xds
    dL = (dyf * y).sum(-1) - dtf * direct
    dL[:, :, -1] += (w * xds).sum(2) + torch.exp(lq) * (h_prev * dh).sum((-2, -1))
    da = dL.flip(2).cumsum(2).flip(2)
    ddt = direct + A * da
    dA = (dtf * da).sum((0, 1, 2))
    dD = (dyf * xf).sum((0, 1, 2, 4))
    dC = mm("bcts,bcsn->bctn", ds, Bf,
            init=mm("bcthp,bchpn->bctn", el[..., None] * dyf, h_prev))
    dB = mm("bcts,bctn->bcsn", ds, Cf,
            init=mm("bcshp,bchpn->bcsn", w[..., None] * xf, dh))
    return _rows(dx, S), _rows(ddt, S), dA, _rows(dB, S), _rows(dC, S), dD


def _rel_errors(got, ref):
    """max|d| / max|ref| of each output."""
    return [((a.double() - r).abs().max() / r.abs().max()).item() for a, r in zip(got, ref)]


def _reference(case):
    args, dy, dhT = _inputs(case)
    args64 = [t.double() for t in args]
    y, h, hp = ssd_chunked_ref(*args64, chunk=case[-1], return_states=True)
    grads = ssd_chunked_bwd_ref(*args64, hp, dy.double(), dhT.double(), chunk=case[-1])
    return args, dy, dhT, (y, h, hp), grads


@pytest.mark.parametrize("case", CASES, ids=[str(c[:5]) for c in CASES])
def test_split_tf32_forward_passes_the_fp32_rule(case):
    args, _, _, ref, _ = _reference(case)
    split_err = _rel_errors(emulated_forward(args, case[-1]), ref)
    one_err = _rel_errors(emulated_forward(args, case[-1], mm=mm1), ref)
    for name, e3, e1 in zip(FWD_NAMES, split_err, one_err):
        assert e3 <= 3e-4, (name, e3)
        assert e1 >= 10 * e3, (name, e1, e3)


@pytest.mark.parametrize("case", CASES, ids=[str(c[:5]) for c in CASES])
def test_split_tf32_backward_passes_the_fp32_rule(case):
    args, dy, dhT, ref_fwd, ref = _reference(case)
    h_prev = emulated_forward(args, case[-1])[2]
    split_err = _rel_errors(emulated_backward(args, h_prev, dy, dhT, case[-1]), ref)
    h_prev1 = emulated_forward(args, case[-1], mm=mm1)[2]
    one_err = _rel_errors(emulated_backward(args, h_prev1, dy, dhT, case[-1], mm=mm1), ref)
    for name, e3, e1 in zip(BWD_NAMES, split_err, one_err):
        assert e3 <= 3e-4, (name, e3)
        if name != "dD":        # dy.x takes no tensor-core product: the same in both
            assert e1 >= 10 * e3, (name, e1, e3)


# --- the Hopper route (fp32 at Q = 128, P = 64, N in {64, 128}) -----------


def _rz(x):
    """float64 to fp32 rounded toward zero: the 29 low bits of the mantissa
    cleared (exact for the normal values here), as `rz` of
    tests/test_torch_flash_tf32.py rounds, in two integer operations."""
    return (x.view(torch.int64) & ~0x1FFFFFFF).view(torch.float64).float()


def _wgmma(eq, a, b, ka, kb):
    """A sum over one reduction axis (axis ka of a, kb of b) as TF32 wgmma
    takes it from a zeroed accumulator: both operands split once (hi, lo),
    k-steps of 8, three products per k-step (lo_a hi_b, hi_a lo_b, hi_a
    hi_b), each added to the accumulator exactly and rounded toward zero
    (`wgmma_sum`'s model)."""
    (ah, al), (bh, bl) = split(a), split(b)
    acc = None
    for k0 in range(0, a.shape[ka], 8):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            prod = torch.einsum(eq, x.narrow(ka, k0, 8).double(), y.narrow(kb, k0, 8).double())
            acc = _rz(prod if acc is None else acc.double() + prod)
    return acc


def emulated_hopper_backward(args, h_prev, dy, dhT, chunk):
    """The Hopper backward's rounding points. The kernels it keeps
    (`ssd_bwd_cbds_kernel`, `chunk_state_tf32_kernel<true>`,
    `state_pass_kernel<true>`) as `emulated_backward` has them. The dx
    kernel: C h_prev^T, M' (dt x), B dH^T and M'^T dy each one wgmma group
    from zero; y = exp(L_t) (C h_prev^T) + M' (dt x) and dx = dt dxi + w dxs
    + D dy in IEEE fp32. The dB/dC kernel: per head its state term, one
    group over the head's 64 channels, scaled by exp(L_t) (dC) or w_s (dB)
    and added to its group's sum in IEEE fp32; dS summed over the groups in
    order, then dS B and dS^T C one group each over the chunk; the sum
    kernel adds the groups' parts and the dS term in order."""
    x, dt, A, Bm, Cm, D = args
    Bsz, S, H, P = x.shape
    N, Q = Bm.shape[-1], min(chunk, S)
    G = min(H, 8)
    hg = -(-H // G)
    xf, Bf, Cf, dyf = (_chunked(t, Q) for t in (x, Bm, Cm, dy))
    dtf, cum, lq, decay, el = _scan_terms(dt, A, Q)
    tail = torch.exp(lq[:, :, None] - cum)
    w = tail * dtf
    cb = mm3("bctn,bcsn->bcts", Cf, Bf)
    mprime = cb[..., None] * decay
    dsh = mm3("bcthp,bcshp->bctsh", dyf, xf) * decay * dtf[:, :, None]
    ds = sum(dsh[..., g * hg:(g + 1) * hg].sum(-1) for g in range(G))
    u = mm3("bcthp,bctn->bchpn", el[..., None] * dyf, Cf)
    g_, dh = (torch.zeros(Bsz, H, P, N) if dhT is None else dhT), []
    for c in reversed(range(xf.shape[1])):
        dh.append(g_)
        g_ = torch.exp(lq[:, c])[..., None, None] * g_ + u[:, c]
    dh = torch.stack(dh[::-1], 1)
    yh = _wgmma("bctn,bchpn->bcthp", Cf, h_prev, 3, 4)
    ym = _wgmma("bctsh,bcshp->bcthp", mprime * dtf[:, :, None], xf, 3, 2)
    y = yh * el[..., None] + ym
    dxs = _wgmma("bcsn,bchpn->bcshp", Bf, dh, 3, 4)
    dxi = _wgmma("bctsh,bcthp->bcshp", mprime, dyf, 2, 2)
    dx = dtf[..., None] * dxi + w[..., None] * dxs + D[:, None] * dyf
    xds = (xf * dxs).sum(-1)
    direct = (xf * dxi).sum(-1) + tail * xds
    dL = (dyf * y).sum(-1) - dtf * direct
    dL[:, :, -1] += (w * xds).sum(2) + torch.exp(lq) * (h_prev * dh).sum((-2, -1))
    da = dL.flip(2).cumsum(2).flip(2)
    ddt = direct + A * da
    dA = (dtf * da).sum((0, 1, 2))
    dD = (dyf * xf).sum((0, 1, 2, 4))
    # per head (index h), transposed as the kernel takes them: (n, t)
    c_head = _wgmma("bchpn,bcthp->bchnt", h_prev, dyf, 3, 4) * el.permute(0, 1, 3, 2)[:, :, :, None]
    b_head = _wgmma("bchpn,bcshp->bchns", dh, xf, 3, 4) * w.permute(0, 1, 3, 2)[:, :, :, None]
    outs = []
    for heads, ds_term in ((c_head, _wgmma("bcsn,bcts->bcnt", Bf, ds, 2, 3)),
                           (b_head, _wgmma("bctn,bcts->bcns", Cf, ds, 2, 2))):
        total = None
        for g in range(G):
            part = None
            for h in range(g * hg, min(H, (g + 1) * hg)):
                part = heads[:, :, h] if part is None else part + heads[:, :, h]
            total = part if total is None else total + part
        outs.append((total + ds_term).transpose(-1, -2))
    dC, dB = outs
    return _rows(dx, S), _rows(ddt, S), dA, _rows(dB, S), _rows(dC, S), dD


# the four cases of the Hopper route: both training shapes cut to one
# sequence of 4 heads, a ragged S, and the long case where the tensor
# cores' round-toward-zero sum once put dA at 3.4e-4 of max|dA|
HOPPER_CASES = CASES + [(2, 300, 4, 64, 128, 128)]


@pytest.mark.parametrize("case", HOPPER_CASES, ids=[str(c[:5]) for c in HOPPER_CASES])
def test_hopper_backward_passes_the_fp32_rule(case, one_thread):
    """The Hopper route's rounding points (operands split once, each
    product's sum from zero rounded toward zero, IEEE fp32 between the
    products and over the heads) against float64 under phase 20 (a)'s rule,
    |d| <= 3e-4 max|ref| for each gradient."""
    args, dy, dhT, _, ref = _reference(case)
    h_prev = emulated_forward(args, case[-1])[2]
    errs = _rel_errors(emulated_hopper_backward(args, h_prev, dy, dhT, case[-1]), ref)
    for name, e in zip(BWD_NAMES, errs):
        assert e <= 3e-4, (name, e)


def test_rz_drops_the_low_bits_toward_zero():
    """`_rz` rounds float64 to fp32 toward zero as `rz` does."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096)) * 1e3
    assert torch.equal(_rz(x), rz(x))


def test_backward_route_rule():
    """The Python copy of ssd_scan.cu's rule: fp32 at chunks of 128, 64
    channels a head, 64 or 128 states and an aligned x takes the Hopper
    kernels; everything else, and bf16 at every shape, the mma.sync ones."""
    f32, bf16 = torch.float32, torch.bfloat16
    front = ("ssd_bwd_cbds_kernel<float>", "chunk_state_tf32_kernel<true, float>",
             "state_pass_kernel<true>")
    for case in [(8, 256, 32, 64, 128, 128), (8, 256, 64, 64, 64, 128), (1, 200, 4, 64, 64, 128),
                 (2, 300, 4, 64, 128, 128), (1, 128, 1, 64, 64, 128)]:
        assert bwd_on_hopper(case, f32)
        n = case[4]
        assert backward_kernels(case, f32) == front + (
            f"ssd_bwd_dx_kernel<{n}>", f"ssd_bwd_dbc_kernel<{n}>", "ssd_bwd_dbc_sum_kernel")
    old = front + ("ssd_bwd_chunk_tf32_kernel<float>", "ssd_bwd_bc_tf32_kernel<float>",
                   "ssd_bwd_bc_sum_tf32_kernel<float>")
    for case in [(1, 256, 4, 64, 32, 128),      # N outside {64, 128}
                 (1, 256, 4, 32, 64, 128),      # P != 64
                 (1, 256, 4, 64, 64, 64),       # chunks of 64
                 (1, 100, 4, 64, 64, 128),      # S < 128: one chunk of 100
                 (4, 256, 16, 128, 128, 128)]:  # P = 128
        assert not bwd_on_hopper(case, f32)
        assert backward_kernels(case, f32) == old
    assert not bwd_on_hopper((8, 256, 32, 64, 128, 128), f32, aligned=False)
    assert backward_kernels((8, 256, 32, 64, 128, 128), f32, aligned=False) == old
    for case in [(4, 256, 16, 64, 128, 128), (8, 256, 32, 64, 128, 128)]:
        assert not bwd_on_hopper(case, bf16)
        assert backward_kernels(case, bf16) == tuple(k.replace("float", "bf16") for k in old)
