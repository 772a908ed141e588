"""The port's flash attention against the JAX package's: the plain PyTorch
version (`attention_ref`, which is what `ops.mha` runs on a CPU tensor)
against `repro`'s Pallas kernel in interpret mode (32 x 32 blocks, as its
own tests run it) and its jnp oracle, on the cases of
tests/test_kernels_flash.py in fp32 and bf16. Inputs are made with numpy
from a seed, rounded to the dtype, and handed to both frameworks.

Tolerances: fp32 2e-5 and bf16 2e-2 (abs and rel), the JAX kernel tests'
own. The masks are compared exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.flash_attention.kernel import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.flash_attention.ref import make_mask as jax_make_mask  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref, make_mask  # noqa: E402

CASES = [
    # (B, S, Hq, Hkv, hd, causal, window)
    (1, 64, 4, 4, 16, True, None),
    (2, 128, 4, 2, 32, True, None),          # GQA 2x
    (1, 96, 8, 1, 16, True, None),           # MQA, ragged seq vs blocks
    (2, 128, 4, 4, 64, True, 32),            # sliding window
    (1, 256, 2, 2, 16, False, None),         # bidirectional
    (1, 80, 3, 1, 16, True, 24),             # non-pow2 heads + window
]
DTYPES = {"fp32": (torch.float32, jnp.float32, 2e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _both(case, dname, seed=0):
    """(torch q, k, v, positions), (jax q, k, v, positions): equal values,
    rounded to the dtype on both sides."""
    B, S, Hq, Hkv, hd, _, _ = case
    tdt, jdt, _ = DTYPES[dname]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, h, hd), dtype=np.float32) for h in (Hq, Hkv, Hkv)]
    t = [torch.from_numpy(a).to(tdt) for a in arrs]
    j = [jnp.asarray(x.float().numpy()).astype(jdt) for x in t]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    return (*t, torch.from_numpy(pos.copy())), (*j, jnp.asarray(pos))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_jax_kernel_and_oracle(case, dname):
    causal, window = case[5], case[6]
    tol = DTYPES[dname][2]
    (q, k, v, pos), (qj, kj, vj, posj) = _both(case, dname)
    out = ops.mha(q, k, v, pos, pos, causal=causal, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    kern = jax_flash(qj, kj, vj, causal=causal, window=window, block_q=32, block_k=32,
                     interpret=True)
    oracle = jax_attention_ref(qj, kj, vj, posj, posj, causal=causal, window=window)
    _close(out.float(), kern.astype(jnp.float32), tol)
    _close(out.float(), oracle.astype(jnp.float32), tol)


def test_window_one_rows_are_finite():
    """Window smaller than a block: each token attends only to itself."""
    (q, k, v, pos), (qj, kj, vj, _) = _both((1, 64, 2, 2, 16, True, 1), "fp32", seed=1)
    out = ops.mha(q, k, v, pos, pos, causal=True, window=1)
    assert torch.isfinite(out).all()
    _close(out, v, 2e-5)                     # softmax over one key returns its value
    _close(out, jax_flash(qj, kj, vj, causal=True, window=1, block_q=32, block_k=32,
                          interpret=True), 2e-5)


@pytest.mark.parametrize("causal,window,prefix_len",
                         [(True, None, 0), (False, None, 0), (True, 5, 0),
                          (True, None, 4), (True, 3, 4), (False, 6, 2)])
def test_make_mask_matches_jax(causal, window, prefix_len):
    """Cache-style positions: empty slots (-1) and out-of-order ring slots."""
    rng = np.random.default_rng(2)
    q_pos = rng.integers(0, 20, (2, 7)).astype(np.int32)
    kv_pos = rng.integers(-1, 20, (2, 11)).astype(np.int32)
    kv_pos[:, :2] = -1
    want = jax_make_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=causal,
                         window=window, prefix_len=prefix_len)
    got = make_mask(torch.from_numpy(q_pos), torch.from_numpy(kv_pos), causal=causal,
                    window=window, prefix_len=prefix_len)
    assert np.array_equal(got.numpy(), np.asarray(want))
    rng_v = np.random.default_rng(3)
    q, k, v = (rng_v.standard_normal((2, n, 2, 16), dtype=np.float32) for n in (7, 11, 11))
    _close(attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(q_pos), torch.from_numpy(kv_pos), causal=causal,
                         window=window, prefix_len=prefix_len),
           jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=causal,
                             window=window, prefix_len=prefix_len), 2e-5)


def test_mha_on_cpu_never_launches_the_kernel():
    (q, k, v, pos), _ = _both(CASES[1], "fp32")
    before = flash_attention.launches
    ops.mha(q, k, v, pos, pos, causal=True)
    assert flash_attention.launches == before


def test_the_wrapper_refuses_cpu_tensors():
    (q, k, v, _), _ = _both(CASES[0], "fp32")
    before = flash_attention.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, k, v)
    assert flash_attention.launches == before


def _emulate_mma_kernel(q, k, v, *, split: bool, block_k: int = 64):
    """The rounding points of the bf16 tensor-core kernel, in plain PyTorch
    on the CPU (non-causal, aligned): bf16 q, k, v; fp32 scores and softmax
    state, online over tiles of `block_k` keys; P cast to bf16 before P V,
    as p_hi + p_lo (`split`) or as one bf16 value; fp32 sums; one cast."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))   # (B, H, S, hd)
    m = torch.full(qf.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, kf.shape[2], block_k):
        s = qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        p_hi = p.bfloat16().float()
        p_lo = (p - p_hi).bfloat16().float() if split else torch.zeros_like(p)
        vt = vf[:, :, k0:k0 + block_k]
        acc = acc * alpha + p_hi @ vt + p_lo @ vt
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("split", [True, False], ids=["p_hi+p_lo", "one_bf16_p"])
def test_kernel_rounding_design_meets_the_bf16_rule(split):
    """At a whisper-encoder-like shape (1, 1500, 4 heads of 64, non-causal)
    the bf16 kernel's rounding, emulated, meets the rule chip_smoke.py holds
    the kernel to against `attention_ref` (each element within
    1e-2 * |ref| + 1e-4 * max|ref|) with P split into two bf16 terms, and
    misses it with P rounded to one bf16 value: the split is needed."""
    B, S, H, hd = 1, 1500, 4, 64
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, hd), dtype=np.float32))
               .bfloat16() for _ in range(3))
    pos = torch.arange(S)[None]
    ref = attention_ref(q, k, v, pos, pos, causal=False).float()
    out = _emulate_mma_kernel(q, k, v, split=split).float()
    bad = int(((out - ref).abs() > 1e-2 * ref.abs() + 1e-4 * ref.abs().max()).sum())
    assert (bad == 0) == split, f"{bad} of {ref.numel()} elements outside the rule"


@pytest.mark.parametrize("shape,block_k", [((1, 1500, 2, 64), 128), ((1, 1024, 1, 128), 128),
                                           ((1, 1024, 1, 256), 64)],
                         ids=["hd64-bk128", "hd128-bk128", "hd256-bk64"])
def test_wgmma_tile_widths_meet_the_bf16_rule(shape, block_k):
    """flash_wgmma_kernel's key tiles (128 keys at hd 64 and 128, 64 at hd
    256) move the online softmax's rescale points; with P split into two
    bf16 terms the emulated rounding still meets the long bf16 rule against
    `attention_ref` at every element."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16()
               for _ in range(3))
    pos = torch.arange(shape[1])[None]
    ref = attention_ref(q, k, v, pos, pos, causal=False).float()
    out = _emulate_mma_kernel(q, k, v, split=True, block_k=block_k).float()
    assert bool(((out - ref).abs() <= 1e-2 * ref.abs() + 1e-4 * ref.abs().max()).all())


def test_forward_kernel_rule():
    """bf16 at hd 64, 128 and 256 goes to flash_wgmma_kernel, bf16 at the
    other head dims to flash_mma_kernel; fp32 at hd 64, 128 and 256 with
    more than 512 keys to the Hopper pair (flash_wgmma_tf32_fwd_prep_kernel,
    then flash_wgmma_tf32_kernel), fp32 elsewhere (the other head dims, 512
    keys or fewer: whisper's decoder and smollm-135m's training shape) to
    flash_tf32_kernel; fp32 needs the shape."""
    from repro_torch.kernels.flash_attention.kernel import HD_MAX, forward_kernel, forward_kernels
    shapes = {(8, 448, 448, 12, 12): False, (8, 256, 256, 9, 3): False, (1, 1, 512, 2, 1): False,
              (1, 1, 513, 2, 1): True, (8, 1500, 1500, 12, 12): True,
              (1, 4096, 4096, 32, 8): True}
    for hd in range(16, HD_MAX + 1, 16):
        want = "flash_wgmma_kernel" if hd in (64, 128, 256) else "flash_mma_kernel"
        assert forward_kernel(hd, torch.bfloat16) == want
        assert forward_kernels(hd, torch.bfloat16, (8, 4096, 4096, 12, 12)) == (want,)
        for shape, hopper in shapes.items():
            want = (("flash_wgmma_tf32_fwd_prep_kernel", "flash_wgmma_tf32_kernel")
                    if hopper and hd in (64, 128, 256) else ("flash_tf32_kernel",))
            assert forward_kernels(hd, torch.float32, shape) == want
            assert forward_kernel(hd, torch.float32, shape) == want[-1]
    with pytest.raises(ValueError):
        forward_kernels(64, torch.float32)
    with pytest.raises(TypeError):
        forward_kernel(64, torch.float16)


def test_backward_kernel_rule():
    """bf16 at hd 64, 128 and 256 goes to the Hopper pair
    (flash_wgmma_bwd_dq_kernel, then flash_wgmma_bwd_dkdv_kernel), bf16 at
    the other head dims to the mma.sync pair; fp32 at hd 64, 128 and 256
    with more than 256 keys to the Hopper TF32 kernels (the pre-pass, then
    flash_wgmma_tf32_bwd_dq_kernel, then flash_wgmma_tf32_bwd_dkdv_kernel),
    fp32 elsewhere (the other head dims, 256 keys or fewer: smollm-135m's
    training shape) to the split-TF32 mma.sync pair; fp32 needs the shape."""
    from repro_torch.kernels.flash_attention.kernel import HD_MAX, backward_kernels
    shapes = {(8, 256, 256, 9, 3): False, (2, 200, 200, 7, 1): False, (1, 1, 257, 2, 1): True,
              (8, 448, 448, 12, 12): True, (1, 4096, 4096, 32, 8): True}
    for hd in range(16, HD_MAX + 1, 16):
        route = "wgmma" if hd in (64, 128, 256) else "bf16"
        assert backward_kernels(hd, torch.bfloat16) == (f"flash_{route}_bwd_dq_kernel",
                                                        f"flash_{route}_bwd_dkdv_kernel")
        for shape, hopper in shapes.items():
            if hopper and hd in (64, 128, 256):
                assert backward_kernels(hd, torch.float32, shape) == (
                    "flash_wgmma_tf32_bwd_prep_kernel", "flash_wgmma_tf32_bwd_dq_kernel",
                    "flash_wgmma_tf32_bwd_dkdv_kernel")
            else:
                assert backward_kernels(hd, torch.float32, shape) == (
                    "flash_tf32_bwd_dq_kernel", "flash_tf32_bwd_dkdv_kernel")
    with pytest.raises(ValueError):
        backward_kernels(64, torch.float32)
    with pytest.raises(TypeError):
        backward_kernels(64, torch.float16)
