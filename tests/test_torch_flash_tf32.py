"""The split-TF32 arithmetic of K1's fp32 kernels, emulated on the CPU.

The CUDA kernels (src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu: `flash_tf32_kernel`, `flash_tf32_bwd_dq_kernel`,
`flash_tf32_bwd_dkdv_kernel`, and at hd 64, 128 and 256 the backward's
`flash_wgmma_tf32_bwd_*`) round each fp32 operand to TF32 with
`cvt.rna.tf32.f32` (hi), round its residue again (lo), and take three
tensor-core products lo_a hi_b + hi_a lo_b + hi_a hi_b into one fp32
accumulator; the forward's P V splits V in three terms (four products).
Here that arithmetic is written in plain torch: TF32 rounding by int32 bit
operations, exact products and sums (float64), each product's result
rounded to fp32. The emulated forward and the backward's five products
(S, dP, dV, dK, dQ) are held against float64 (`attention_ref`,
`attention_bwd_ref`) under chip_smoke.py's fp32 rules: small cases
|d| <= 2e-5 (|ref| + max|ref|), long ones |d| <= 1e-4 max|ref|. A single
TF32 product at the same inputs misses the long rule, so the split cannot
be dropped quietly. The Hopper backward is emulated with its own rounding
points (`emulated_wgmma_backward`): the products' sums rounded toward zero
k-step by k-step, as the tensor cores' accumulation is modelled, and dK
and dV summed per item (query head, tile of query rows) in IEEE fp32, held
to float64 at the same cases and where dK/dV sum 2048 query rows. Inputs
are standard normal (the JAX flash tests' distribution), from numpy with
a seed.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

# (B, S, Hq, Hkv, hd, causal, window): three of chip_smoke.py phase 19 (a)'s
# small cases and one of its long ones
SMALL = [(1, 64, 4, 4, 16, True, None), (2, 128, 4, 2, 32, True, None),
         (1, 80, 3, 1, 16, True, 24)]
LONG = [(2, 200, 7, 1, 64, True, 50)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as cvt.rna.tf32.f32 does: to nearest on the 10
    mantissa bits, ties away from zero (add half of the dropped range to
    the bit pattern, then clear the 13 low bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def split3(x):
    hi = tf32(x)
    r = x - hi
    mid = tf32(r)
    return hi, mid, r - mid


def _mm(eq, pairs):
    """sum of einsum(eq, a, b) over (a, b) pairs, exact products and sum in
    float64, the result rounded to fp32 (one fp32 accumulator)."""
    return sum(torch.einsum(eq, a.double(), b.double()) for a, b in pairs).float()


def mm3(eq, a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return _mm(eq, [(al, bh), (ah, bl), (ah, bh)])


def mm1(eq, a, b):
    return _mm(eq, [(tf32(a), tf32(b))])


def mm_pv(eq, p, v):
    """the forward's P V: P in two terms, V in three (hi + mid + lo = v)."""
    (ph, pl), (vh, vm, vl) = split(p), split3(v)
    return _mm(eq, [(pl, vh), (ph, vl), (ph, vm), (ph, vh)])


def _inputs(case, seed=0):
    B, S, Hq, Hkv, hd, _, _ = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, S, h, hd), dtype=np.float32))
                   for h in (Hq, Hkv, Hkv, Hq))
    pos = torch.arange(S)[None].expand(B, S)
    return q, k, v, do, pos


def _mask(case):
    B, S, _, _, _, causal, window = case
    i = torch.arange(S)
    keep = torch.ones(S, S, dtype=torch.bool)
    if causal:
        keep &= i[None, :] <= i[:, None]
    if window is not None:
        keep &= i[None, :] > i[:, None] - window
    return keep                                          # (query, key)


def emulated_forward(case, q, k, v, mm=mm3, pv=mm_pv):
    """The kernel's forward in split TF32: S = Q K^T, scores scaled in fp32,
    masked, softmax in fp32, O = P V / l. Returns (o, lse)."""
    rep, hd = case[2] // case[3], case[4]
    kr, vr = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    s = mm("bqhd,bkhd->bhqk", q, kr) * hd ** -0.5
    s = torch.where(_mask(case), s, torch.tensor(-1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.where(_mask(case), torch.exp(s - m), torch.tensor(0.0))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = pv("bhqk,bkhd->bqhd", p, vr) / l.permute(0, 2, 1, 3)
    return o, (m + torch.log(l))[..., 0]


def emulated_backward(case, q, k, v, o, lse, do, mm=mm3):
    """The kernels' backward in split TF32: the five products S, dP, dV, dK,
    dQ; P = exp(scale S - lse) masked, delta = rowsum(dO O) in fp32."""
    B, S, Hq, Hkv, hd = case[:5]
    rep, scale = Hq // Hkv, hd ** -0.5
    kr, vr = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    s = mm("bqhd,bkhd->bhqk", q, kr)
    p = torch.where(_mask(case), torch.exp(s * scale - lse[..., None]), torch.tensor(0.0))
    dp = mm("bqhd,bkhd->bhqk", do, vr)
    delta = (do * o).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None])
    dv = mm("bhqk,bqhd->bkhd", p, do)
    dk = mm("bhqk,bqhd->bkhd", ds, q) * scale
    dq = mm("bhqk,bkhd->bqhd", ds, kr) * scale
    return (dq, dk.view(B, S, Hkv, rep, hd).sum(3), dv.view(B, S, Hkv, rep, hd).sum(3))


def rz(x):
    """float64 to fp32, rounded toward zero: the model of how the tensor
    cores round a product added to an fp32 accumulator."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def wgmma_sum(eq, a, b, ka, kb, acc=None):
    """acc + sum of einsum(eq, a, b) over the reduction axis (axis ka of a,
    kb of b) as TF32 wgmma takes it: k-steps of 8, each operand in two TF32
    terms (hi = tf32(x), lo = tf32(x - hi): what the pre-pass stores and
    what the registers hold), three products per k-step (lo_a hi_b, hi_a
    lo_b, hi_a hi_b), each added to the fp32 accumulator exactly and rounded
    toward zero. acc None: the first product starts from zero."""
    for k0 in range(0, a.shape[ka], 8):
        (ah, al), (bh, bl) = split(a.narrow(ka, k0, 8)), split(b.narrow(kb, k0, 8))
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            p = torch.einsum(eq, x.double(), y.double())
            acc = rz(p if acc is None else acc.double() + p)
    return acc


def emulated_wgmma_backward(case, q, k, v, o, lse, do, item_sum=True):
    """The Hopper fp32 backward (`flash_wgmma_tf32_bwd_*`) as its products
    round: S, dP over the head dim and dQ over the keys in tiles of 64, by
    wgmma_sum from zero; P = exp(scale S - lse) masked, delta = rowsum(dO O)
    and dS = P (dP - delta) in fp32. dK and dV sum over the items (query
    head of the KV head's rep, tile of BQ query rows; heads outermost): with
    `item_sum` each item's sum is taken from zero and added to dK or dV in
    IEEE fp32, as the kernel does; without it every k-step goes into the one
    accumulator."""
    B, S, Hq, Hkv, hd = case[:5]
    rep, scale, bq = Hq // Hkv, hd ** -0.5, 64 if hd <= 64 else 32
    kr, vr = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    s = wgmma_sum("bqhd,bkhd->bhqk", q, kr, 3, 3)
    p = torch.where(_mask(case), torch.exp(s * scale - lse[..., None]), torch.tensor(0.0))
    dp = wgmma_sum("bqhd,bkhd->bhqk", do, vr, 3, 3)
    delta = (do * o).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None])
    dq = wgmma_sum("bhqk,bkhd->bqhd", ds, kr, 3, 1) * scale
    # dV (index 0) and dK (1) together: A = P^T, dS^T; B = dO, Q, per item
    a = torch.stack([p, ds]).view(2, B, Hkv, rep, S, S)
    bt = torch.stack([do, q]).view(2, B, S, Hkv, rep, hd)
    acc = torch.zeros(2, B, S, Hkv, hd)
    for r in range(rep):
        for i0 in range(0, S, bq):
            n = min(bq, S - i0)
            part = wgmma_sum("xbhqk,xbqhd->xbkhd", a[:, :, :, r, i0:i0 + n],
                             bt[:, :, i0:i0 + n, :, r], 3, 2, None if item_sum else acc)
            acc = acc + part if item_sum else part
    return dq, acc[1] * scale, acc[0]


def _reference(case, q, k, v, do, pos):
    """float64 output, lse and gradients of the plain versions."""
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    o64, lse64 = attention_ref(q64, k64, v64, pos, pos, causal=case[5], window=case[6],
                               return_lse=True)
    grads = attention_bwd_ref(q64, k64, v64, o64, lse64, do64, causal=case[5],
                              window=case[6])
    return o64, grads


def _passes(got, ref, small):
    """chip_smoke.py's fp32 rule; also the largest |d| / max|ref|."""
    err = (got.double() - ref).abs()
    mref = ref.abs().max().item()
    ok = bool((err <= 2e-5 * (ref.abs() + mref)).all()) if small else err.max().item() <= 1e-4 * mref
    return ok, err.max().item() / mref


@pytest.mark.parametrize("case", SMALL + LONG)
def test_split_tf32_forward_passes_the_fp32_rule(case):
    q, k, v, do, pos = _inputs(case)
    o, lse = emulated_forward(case, q, k, v)
    o64, lse64 = attention_ref(q.double(), k.double(), v.double(), pos, pos, causal=case[5],
                               window=case[6], return_lse=True)
    ok, rel = _passes(o, o64, case in SMALL)
    assert ok and rel < 1e-6, rel
    assert (lse.double() - lse64).abs().max().item() <= 1e-5 * lse64.abs().max().item()


@pytest.mark.parametrize("case", SMALL + LONG)
def test_split_tf32_backward_passes_the_fp32_rule(case):
    q, k, v, do, pos = _inputs(case)
    o, lse = attention_ref(q, k, v, pos, pos, causal=case[5], window=case[6], return_lse=True)
    _, refs = _reference(case, q, k, v, do, pos)
    for name, g, r in zip(("dq", "dk", "dv"), emulated_backward(case, q, k, v, o, lse, do), refs):
        ok, rel = _passes(g, r, case in SMALL)
        assert ok and rel < 1e-6, (name, rel)


@pytest.mark.parametrize("case", LONG)
def test_one_tf32_product_misses_the_long_rule(case):
    """The design's reason: one TF32 product per fp32 product keeps 11 bits
    of each operand, ~5x outside |d| <= 1e-4 max|ref| on o and on every
    gradient."""
    q, k, v, do, pos = _inputs(case)
    o64, refs = _reference(case, q, k, v, do, pos)
    o, lse = emulated_forward(case, q, k, v, mm=mm1, pv=mm1)
    assert not _passes(o, o64, small=False)[0]
    o32, lse32 = attention_ref(q, k, v, pos, pos, causal=case[5], window=case[6],
                               return_lse=True)
    for g, r in zip(emulated_backward(case, q, k, v, o32, lse32, do, mm=mm1), refs):
        assert not _passes(g, r, small=False)[0]


def test_three_term_v_returns_each_rows_value_at_window_one():
    """window = 1: each row's only live key has p = 1, so O = V. With V in
    three TF32 terms (the forward's P V) that holds bit for bit, as in IEEE
    fp32 and chip_smoke.py phase 7's check; with two terms it does not."""
    case = (1, 64, 2, 2, 16, True, 1)
    q, k, v, _, _ = _inputs(case, seed=3)
    o, _ = emulated_forward(case, q, k, v)
    assert torch.equal(o, v)
    two = lambda eq, p, x: _mm(eq, [(split(p)[1], split(x)[0]), (split(p)[0], split(x)[1]),
                                     (split(p)[0], split(x)[0])])
    o2, _ = emulated_forward(case, q, k, v, pv=two)
    assert not torch.equal(o2, v)


def test_tf32_rounds_to_nearest_ties_away():
    one = torch.tensor([1.0, -1.0])
    ulp = 2.0 ** -10                                     # TF32's step at 1
    x = torch.cat([one * (1 + ulp / 2), one * (1 + ulp / 2 - 2.0 ** -20),
                   one * (1 + 3 * ulp / 4)])
    want = torch.cat([one * (1 + ulp), one, one * (1 + ulp)])
    assert torch.equal(tf32(x), want)
    assert (tf32(torch.randn(1000)).view(torch.int32) & 0x1FFF).eq(0).all()


def test_split_terms_carry_the_value():
    """hi + lo keeps ~22 bits (|x - hi - lo| <= 2^-22 |x|); hi + mid + lo of
    the three-term split is x exactly, each term a TF32 value."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096, dtype=np.float32))
    hi, lo = split(x)
    assert ((x.double() - hi.double() - lo.double()).abs() <= 2.0 ** -22 * x.double().abs()).all()
    h, m, lw = split3(x)
    assert torch.equal(h.double() + m.double() + lw.double(), x.double())
    for t in (h, m, lw):
        assert torch.equal(tf32(t), t)


# GQA 8 over one KV head: dK and dV sum 8 x 256 = 2048 query rows
GQA_LONG = (1, 256, 8, 1, 32, True, None)


@pytest.mark.parametrize("case", SMALL + LONG)
def test_wgmma_tf32_backward_passes_the_fp32_rule(case):
    """The Hopper fp32 backward's rounding (TF32 terms as stored, P and dS
    split in registers, accumulation rounded toward zero, each item's dK/dV
    sum added in IEEE fp32) against float64 under the fp32 rules."""
    q, k, v, do, pos = _inputs(case)
    o, lse = attention_ref(q, k, v, pos, pos, causal=case[5], window=case[6], return_lse=True)
    _, refs = _reference(case, q, k, v, do, pos)
    got = emulated_wgmma_backward(case, q, k, v, o, lse, do)
    for name, g, r in zip(("dq", "dk", "dv"), got, refs):
        ok, rel = _passes(g, r, case in SMALL)
        assert ok and rel < 1e-5, (name, rel)


def test_wgmma_tf32_dkdv_long_gqa_sums():
    """dQ, dK and dV within 2e-5 (|ref| + max|ref|) of float64 at every
    entry (the training cases' criterion) where dK and dV sum 2048 query
    rows of one KV head, with the per-item IEEE add. The design's reason:
    with every k-step rounded toward zero into one accumulator, dK and dV
    drift 5x or more as far (the bias grows with the sum's length, so at
    mixtral's 4 x 4096 rows it would miss)."""
    case = GQA_LONG
    q, k, v, do, pos = _inputs(case)
    o, lse = attention_ref(q, k, v, pos, pos, causal=case[5], window=case[6], return_lse=True)
    _, refs = _reference(case, q, k, v, do, pos)
    with_add = emulated_wgmma_backward(case, q, k, v, o, lse, do)
    without = emulated_wgmma_backward(case, q, k, v, o, lse, do, item_sum=False)
    for name, g, g0, r in zip(("dq", "dk", "dv"), with_add, without, refs):
        ok, rel = _passes(g, r, small=True)
        assert ok and rel < 5e-6, (name, rel)
        if name != "dq":
            assert _passes(g0, r, small=True)[1] >= 5 * rel, name


def emulated_wgmma_forward(case, q, k, v, tile_sum=None):
    """The Hopper fp32 forward (`flash_wgmma_tf32_kernel`) as its products
    round. S = Q K^T by wgmma_sum over the head dim (q split in registers,
    k's two terms as the pre-pass stores them), scaled by scale log2 e in
    fp32, masked to -1e30; then per tile of 8192 / hd keys the online
    softmax (running maximum m, rescale 2^(m_old - m), P = 2^(x - m) with
    masked entries 0) and P V with P in two terms and V in three (hi + mid +
    lo = v): per k-step of 8 keys the products hi_P lo_V, then hi_P mid_V,
    then lo_P hi_V and hi_P hi_V, each added to the accumulator exactly and
    rounded toward zero. With `tile_sum` (the kernel's choice up to hd 128)
    a tile's products go into a zeroed accumulator that joins O by one fused
    multiply-add, O alpha + tile; without it O is rescaled and takes them
    directly. o = O (1 / l), lse = m ln 2 + log l. q may hold the first
    rows of the case's queries only."""
    B, S, Hq, Hkv, hd = case[:5]
    rep, bk, sq = Hq // Hkv, 8192 // hd, q.shape[1]
    tile_sum = hd <= 128 if tile_sum is None else tile_sum
    kr, vr = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    keep = _mask(case)[:sq]
    scale_log2 = torch.tensor(hd ** -0.5 * 1.4426950408889634, dtype=torch.float32)
    x = torch.where(keep, wgmma_sum("bqhd,bkhd->bhqk", q, kr, 3, 3) * scale_log2,
                    torch.tensor(-1e30))
    vh, vm, vl = split3(vr)
    m = torch.full((B, Hq, sq, 1), -1e30)
    l, acc = torch.zeros(B, Hq, sq, 1), torch.zeros(B, Hq, sq, hd)
    for k0 in range(0, S, bk):
        xt, kt = x[..., k0:k0 + bk], keep[:, k0:k0 + bk]
        m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
        alpha, m = torch.exp2(m - m_new), m_new
        p = torch.where(kt, torch.exp2(xt - m), torch.tensor(0.0))
        l = l * alpha + p.sum(-1, keepdim=True)
        ph, pl = split(p)
        d = None if tile_sum else acc * alpha
        steps = range(0, p.shape[-1], 8)
        pairs = ([(ph, vl)] * len(steps), [(ph, vm)] * len(steps))
        order = [(a, b, j) for terms in pairs for (a, b), j in zip(terms, steps)]
        order += [(a, vh, j) for j in steps for a in (pl, ph)]
        for a, b, j in order:
            prod = torch.einsum("bhqk,bkhd->bhqd", a[..., j:j + 8].double(),
                                b[:, k0 + j:k0 + j + 8].double())
            d = rz(prod if d is None else d.double() + prod)
        acc = (acc.double() * alpha.double() + d.double()).float() if tile_sum else d
    o = acc * (1.0 / l.clamp_min(1e-30))
    return o.permute(0, 2, 1, 3), (m * math.log(2) + torch.log(l.clamp_min(1e-30)))[..., 0]


# reduced versions of the training cases' shape classes, (B, S, Hq, Hkv, hd,
# causal, window): whisper's encoder (hd 64, non-causal), mixtral's (hd 128,
# GQA, window), gemma3's (hd 256, causal); 2 to 4 key tiles each
WGMMA_FWD = [(1, 256, 2, 2, 64, False, None), (1, 256, 4, 2, 128, True, 40),
             (1, 128, 2, 1, 256, True, None)]


@pytest.fixture
def one_thread():
    """The emulation runs hundreds of small products: torch's thread pool
    costs more than it saves on them (10x here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", WGMMA_FWD)
def test_wgmma_tf32_forward_passes_the_fp32_rule(case, one_thread):
    """The Hopper fp32 forward's rounding against float64: every entry of o
    within 2e-5 (|ref| + max|ref|), lse within 1e-5 of max|lse|; with window
    1 each row returns its key's v bit for bit (V's three terms)."""
    q, k, v, _, pos = _inputs(case)
    o, lse = emulated_wgmma_forward(case, q, k, v)
    o64, lse64 = attention_ref(q.double(), k.double(), v.double(), pos, pos, causal=case[5],
                               window=case[6], return_lse=True)
    ok, rel = _passes(o, o64, small=True)
    assert ok and rel < 5e-6, rel
    assert (lse.double() - lse64).abs().max().item() <= 1e-5 * lse64.abs().max().item()
    one = case[:5] + (True, 1)
    o1, _ = emulated_wgmma_forward(one, q, k, v)
    assert torch.equal(o1, v.repeat_interleave(case[2] // case[3], 2))


def test_wgmma_tf32_forward_tile_sum_on_long_rows(one_thread):
    """The design's reason for the per-tile IEEE add (hd 64 and 128): over
    1536 keys of a non-causal row (whisper's encoder takes 1500) the tensor
    cores' round-toward-zero accumulation puts o 5x or more as far from
    float64 as with a zeroed accumulator per tile added in IEEE fp32, which
    keeps within 2e-5 (|ref| + max|ref|). The first 64 query rows."""
    case = (1, 1536, 1, 1, 64, False, None)
    q, k, v, _, pos = _inputs(case)
    q = q[:, :64]
    o64 = attention_ref(q.double(), k.double(), v.double(), pos[:, :64], pos, causal=False)
    with_add = _passes(emulated_wgmma_forward(case, q, k, v)[0], o64, small=True)
    without = _passes(emulated_wgmma_forward(case, q, k, v, tile_sum=False)[0], o64, small=True)
    assert with_add[0] and without[1] >= 5 * with_add[1], (with_add, without)
