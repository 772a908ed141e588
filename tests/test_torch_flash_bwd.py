"""The plain version of K1's backward (`ref.attention_bwd_ref`, the
formulas the CUDA backward computes) against autograd, and against `repro`.

`repro`'s Pallas kernel has no backward (no `custom_vjp`, and `jax.grad`
through `pallas_call` raises on this JAX), so the reference is `jax.grad`
through its plain `attention_ref`. Inputs are made with numpy from a seed and
handed to both frameworks; the cases are tests/test_torch_flash.py's.

Tolerances: in float64, `attention_bwd_ref` equals torch autograd through
`attention_ref` within 1e-10 of the largest gradient (the same function
summed in another order); in fp32, it matches `jax.grad` within 1e-5 of the
largest gradient (fp32 sums of up to 256 terms in other orders). The row
log-sum-exp that the kernel's forward returns (`return_lse`) is held against
`jax.nn.logsumexp` of the masked scores within 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attention.ref import make_mask as jax_make_mask  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref  # noqa: E402

CASES = [
    # (B, S, Hq, Hkv, hd, causal, window)
    (1, 64, 4, 4, 16, True, None),
    (2, 128, 4, 2, 32, True, None),          # GQA 2x
    (1, 96, 8, 1, 16, True, None),           # MQA, ragged seq vs blocks
    (2, 128, 4, 4, 64, True, 32),            # sliding window
    (1, 256, 2, 2, 16, False, None),         # bidirectional
    (1, 80, 3, 1, 16, True, 24),             # non-pow2 heads + window
]


def _arrays(case, seed=0):
    """q, k, v, do as float64 numpy arrays and the aligned positions."""
    B, S, Hq, Hkv, hd, _, _ = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, h, hd)) for h in (Hq, Hkv, Hkv, Hq)]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return arrs, pos


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_is_autograd_of_the_plain_forward_in_float64(case):
    causal, window = case[5], case[6]
    arrs, pos = _arrays(case)
    q, k, v, do = (torch.from_numpy(a).requires_grad_(i < 3) for i, a in enumerate(arrs))
    pos = torch.from_numpy(pos)
    o, lse = attention_ref(q, k, v, pos, pos, causal=causal, window=window, return_lse=True)
    assert o.dtype == lse.dtype == torch.float64
    want = torch.autograd.grad(o, (q, k, v), do)
    got = attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(), do,
                            causal=causal, window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert _rel(g, w) <= 1e-10


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_grad_in_fp32(case):
    causal, window = case[5], case[6]
    arrs, pos = _arrays(case)
    arrs = [a.astype(np.float32) for a in arrs]
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    tpos = torch.from_numpy(pos)
    o, lse = attention_ref(q, k, v, tpos, tpos, causal=causal, window=window, return_lse=True)
    got = attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)

    def f(qj, kj, vj):
        out = jax_attention_ref(qj, kj, vj, jnp.asarray(pos), jnp.asarray(pos), causal=causal,
                                window=window)
        return jnp.sum(out * jnp.asarray(arrs[3]))
    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrs[:3]))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), np.asarray(w)) <= 1e-5
    # the same through ops.mha on CPU tensors, which autograd differentiates
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.mha(qg, kg, vg, tpos, tpos, causal=causal, window=window)
    for g, w in zip(torch.autograd.grad(out, (qg, kg, vg), do), want):
        assert _rel(g.numpy(), np.asarray(w)) <= 1e-5


@pytest.mark.parametrize("case", CASES)
def test_forward_lse_matches_jax_logsumexp(case):
    causal, window = case[5], case[6]
    arrs, pos = _arrays(case)
    q, k, v = (a.astype(np.float32) for a in arrs[:3])
    tpos = torch.from_numpy(pos)
    out, lse = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), tpos, tpos,
                             causal=causal, window=window, return_lse=True)
    assert lse.shape == (case[0], case[2], case[1]) and lse.dtype == torch.float32
    rep = case[2] // case[3]
    scores = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q) * case[4] ** -0.5,
                        jnp.repeat(jnp.asarray(k), rep, axis=2))
    mask = jax_make_mask(jnp.asarray(pos), jnp.asarray(pos), causal=causal, window=window)
    want = jax.nn.logsumexp(jnp.where(mask[:, None], scores, -1e30), axis=-1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # return_lse does not change the output
    assert torch.equal(out, attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), tpos,
                                          tpos, causal=causal, window=window))


def test_backward_kernel_takes_cuda_tensors_only():
    q = torch.zeros(1, 8, 2, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd(q, q, q, q, lse, q)
