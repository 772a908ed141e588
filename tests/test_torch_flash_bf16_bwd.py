"""The split-bf16 arithmetic of K1's bf16 backward, emulated on the CPU.

The CUDA kernels (src/repro_torch/kernels/flash_attention/csrc/
flash_attention.cu: `flash_wgmma_bwd_dq_kernel`, `flash_wgmma_bwd_dkdv_kernel`
at hd 64, 128 and 256, `flash_bf16_bwd_dq_kernel`, `flash_bf16_bwd_dkdv_kernel`
at the other head dims) take bf16 operands straight into the tensor cores'
products (wgmma; mma.sync m16n8k16) with fp32 accumulation: S = Q K^T and
dP = dO V^T are one product each, exact in fp32 up to the accumulator's
rounding. P = exp(scale S - lse) and
dS = P (dP - delta) are fp32 in registers; each feeds its next product
(dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K) as two bf16 terms,
hi = bf16(x) and lo = bf16(x - hi), two products into one fp32
accumulator. Here that arithmetic is written in plain torch: exact products
and sums (float64), each product's result rounded to fp32, the gradients
rounded to bf16 once, as the kernels store them. The result is held
against the plain version (`attention_bwd_ref` on the same bf16 inputs, the
forward's o and lse) under chip_smoke.py's long bf16 rule, |d| <= 1e-2 |ref|
+ 1e-4 max|ref|. P and dS rounded once to bf16 miss that rule at every
case, so the split cannot be dropped quietly. Inputs are standard normal
(the JAX flash tests' distribution), from numpy with a seed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

# (B, S, Hq, Hkv, hd, causal, window): a long causal GQA case at mixtral's
# head dim, and chip_smoke.py phase 19 (a)'s ragged windowed GQA case
LONG = (1, 1024, 4, 1, 128, True, None)
CASES = [LONG, (2, 200, 7, 1, 64, True, 50)]
# the other head-dim classes of the Hopper kernels (flash_wgmma_bwd_*): hd 256
# causal GQA (gemma3's global layers, cut) and hd 64 non-causal (whisper's
# encoder, cut)
HOPPER_CASES = [(1, 512, 4, 2, 256, True, None), (1, 500, 4, 4, 64, False, None)]


def bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to bf16 (to nearest, ties to even), back in fp32."""
    return x.to(torch.bfloat16).float()


def split(x):
    hi = bf16(x)
    return hi, bf16(x - hi)


def _mm(eq, a_terms, b):
    """einsum(eq, a, b) summed over the terms a of a_terms: products of bf16
    values and their sums are exact in float64 at these lengths, so the
    terms are added first; the result rounded to fp32 (one fp32
    accumulator)."""
    return torch.einsum(eq, sum(a.double() for a in a_terms), b.double()).float()


def _inputs(case, seed=0):
    """bf16 q, k, v, dO from numpy; the plain forward's o and lse."""
    B, S, Hq, Hkv, hd, causal, window = case
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, S, h, hd), dtype=np.float32))
                   .to(torch.bfloat16) for h in (Hq, Hkv, Hkv, Hq))
    pos = torch.arange(S)[None].expand(B, S)
    o, lse = attention_ref(q, k, v, pos, pos, causal=causal, window=window, return_lse=True)
    return q, k, v, o, lse, do


def _mask(case):
    S, causal, window = case[1], case[5], case[6]
    i = torch.arange(S)
    keep = torch.ones(S, S, dtype=torch.bool)
    if causal:
        keep &= i[None, :] <= i[:, None]
    if window is not None:
        keep &= i[None, :] > i[:, None] - window
    return keep                                          # (query, key)


def emulated_backward(case, q, k, v, o, lse, do, terms=split):
    """The kernels' backward: S and dP one bf16 product each, P and dS in
    fp32, then `terms(x)` (hi + lo by default) of P and dS into dV, dK and
    dQ; GQA's sums over the rep query heads inside dK's and dV's
    accumulators. Returns bf16 (dq, dk, dv)."""
    B, S, Hq, Hkv, hd = case[:5]
    rep, scale = Hq // Hkv, hd ** -0.5
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    kr, vr = kf.repeat_interleave(rep, 2), vf.repeat_interleave(rep, 2)
    s = _mm("bqhd,bkhd->bhqk", [qf], kr)
    p = torch.where(_mask(case), torch.exp(s * scale - lse[..., None]), torch.tensor(0.0))
    dp = _mm("bqhd,bkhd->bhqk", [dof], vr)
    delta = (dof * of).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None])
    # dK and dV: (B, Hkv, rep x Sq) against (B, Hkv, rep x Sq, hd)
    keys = lambda x: x.view(B, Hkv, rep, S, S).permute(0, 1, 4, 2, 3).reshape(  # noqa: E731
        B, Hkv, S, rep * S)
    rows = lambda x: x.view(B, S, Hkv, rep, hd).permute(0, 2, 3, 1, 4).reshape(  # noqa: E731
        B, Hkv, rep * S, hd)
    dv = _mm("bgkq,bgqd->bkgd", [keys(t) for t in terms(p)], rows(dof))
    dk = _mm("bgkq,bgqd->bkgd", [keys(t) for t in terms(ds)], rows(qf)) * scale
    dq = _mm("bhqk,bkhd->bqhd", terms(ds), kr) * scale
    return tuple(g.to(torch.bfloat16) for g in (dq, dk, dv))


def _misses(got, ref):
    """Entries outside |d| <= 1e-2 |ref| + 1e-4 max|ref| (chip_smoke.py's
    long bf16 rule), and max|d| / max|ref|."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    mref = ref.abs().max()
    return int((err > 1e-2 * ref.abs() + 1e-4 * mref).sum()), (err.max() / mref).item()


@pytest.mark.parametrize("case", CASES)
def test_split_bf16_backward_passes_the_long_bf16_rule(case):
    q, k, v, o, lse, do = _inputs(case)
    refs = attention_bwd_ref(q, k, v, o, lse, do, causal=case[5], window=case[6])
    for name, g, r in zip(("dq", "dk", "dv"), emulated_backward(case, q, k, v, o, lse, do),
                          refs):
        miss, rel = _misses(g, r)
        assert miss == 0 and rel < 2e-3, (name, miss, rel)


@pytest.mark.parametrize("case", HOPPER_CASES)
def test_split_bf16_backward_at_the_hopper_head_dims(case):
    """The same arithmetic at the Hopper kernels' other head-dim classes,
    under the long bf16 rule at every element. Both sides round to bf16 at
    the end, so an entry near max|ref| may sit one bf16 step from the
    reference (2.5e-3 of max|ref| at the hd 256 case): the per-element rule
    is what the card is held to."""
    q, k, v, o, lse, do = _inputs(case)
    refs = attention_bwd_ref(q, k, v, o, lse, do, causal=case[5], window=case[6])
    for name, g, r in zip(("dq", "dk", "dv"), emulated_backward(case, q, k, v, o, lse, do),
                          refs):
        assert _misses(g, r)[0] == 0, name


@pytest.mark.parametrize("case", CASES + HOPPER_CASES)
def test_single_rounded_p_and_ds_miss_the_long_rule(case):
    """The design's reason: P and dS rounded once to bf16 keep 8 bits, and
    every gradient then misses the long bf16 rule at hundreds of entries
    (413-6711 of them at these inputs)."""
    q, k, v, o, lse, do = _inputs(case)
    refs = attention_bwd_ref(q, k, v, o, lse, do, causal=case[5], window=case[6])
    grads = emulated_backward(case, q, k, v, o, lse, do, terms=lambda x: (bf16(x),))
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert _misses(g, r)[0] > 100, name


def test_split_terms_carry_the_value():
    """hi + lo keeps ~16 bits (|x - hi - lo| <= 2^-16 |x|), each term a
    bf16 value."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096, dtype=np.float32))
    hi, lo = split(x)
    assert ((x.double() - hi.double() - lo.double()).abs() <= 2.0 ** -16 * x.double().abs()).all()
    for t in (hi, lo):
        assert torch.equal(bf16(t), t)
