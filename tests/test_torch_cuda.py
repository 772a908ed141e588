"""Tests of the port that need an NVIDIA card (marker `gpu`; each skips with
a reason where torch finds no CUDA device). They import no JAX, so they run
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

The CUDA SSD-scan kernel is held against its plain version on the card at
the JAX kernel tests' cases plus a short (Q = S < 128) and a ragged serving
shape, with those tests' tolerances (fp32 3e-4, bf16 4e-2, abs and rel).
The CUDA flash-attention kernel is held against its plain version at the
JAX flash tests' 6 cases (fp32 2e-5, bf16 2e-2, abs and rel) and at the
whisper encoder's serving shape (B=4, S=1500, 12 heads of 64), where fp32
is held to 1e-4 * max|ref| and bf16 element by element to
1e-2 * |ref| + 1e-4 * max|ref| (both sides round fp32 sums that differ in
order to bf16, which can land one bf16 step apart).

The bf16 tensor-core kernels get their own cases: K1 at every head dim
class (16 .. 256) with ragged Sq and Skv, GQA 7, causal plus window and
window=1, under the same per-element bf16 rule; K2 through strided views of
one packed (B, S, H*P + 2N) tensor at four alignments, equal bit for bit to
the contiguous call and within the JAX tests' tolerance of the plain
version; a misaligned bf16 K1 input raises before any launch. K1's bf16
forward at hd 64, 128 and 256 (`flash_wgmma_kernel`) is held at ragged,
GQA, windowed and one-row cases and at grids of one, two and three
consumer warpgroups a block, with its lse, two runs and strided views bit
for bit, at negative, zero and small softmax scales; the profiler names the
kernel `kernel.forward_kernel` names.

K1's fp32 kernels (split TF32 on the tensor cores): the forward at every
head-dim class under the long fp32 rule (|d| <= 1e-4 max|ref|), the
backward at every head-dim class in fp32 and bf16 (GQA 7, causal plus
window, two runs bit for bit), and a misaligned fp32 input raises before
any launch, forward and backward. K1's fp32 backward at hd 64, 128 and 256
(`flash_wgmma_tf32_bwd_*`, TF32 wgmma fed by TMA) is held under the long
fp32 rule at the bf16 backward's cases below, with two runs and strided
views bit for bit and the profiler's kernel names, and at mixtral-8x7b's
training case against float64, every entry within 2e-5 (|ref| + max|ref|).
K1's bf16 backward at hd 64, 128 and 256 (`flash_wgmma_bwd_*`) is held under the long bf16 rule at grids of one and
of the most consumer warpgroups a block, causal with a window, GQA, ragged
and non-causal Skv != Sq cases, two runs and strided views bit for bit,
and the profiler names the kernels `kernel.backward_kernels` names.

The decoder slice: K1 in bf16 at the full-sequence forward shapes of
gemma3-4b (S=4096, 8/4 heads of 256, window 1024) and mixtral-8x7b (S=4096,
32/8 heads of 128, window 4096) under the same per-element rule; reduced
gemma3 and mixtral served on the card and the CPU from the same weights
give the same greedy tokens, and the forward's logits agree within 1e-4.

The hybrid and VLM slice: K1 in bf16 at zamba2-1.2b's forward shape (S=4096,
32/32 heads of 64, causal) under the same rule; K2 at its prefill and
forward shapes (S=1024, 2048 and 4096; H=64, P=64, N=64), fp32 held to
3e-4 * max|ref| on y and the state, bf16 y element by element to
1e-2 * |ref| + 3e-4 * max|ref| (the serving shapes' rule of chip_smoke.py);
reduced zamba2 (engine) and paligemma (serve
steps, patches) on the card and the CPU give the same greedy tokens, and
the forward's logits agree within 1e-4.

The DSE slice: the GP pair fit, `condition_on` and the greedy q-EHVI
acquire run on the card with no host sync (`set_sync_debug_mode("error")`)
and pick the same candidates as on the CPU (predictions within
tests/test_compiled_optimizer.py's 2e-3 and 5e-3); the float64 analytical
evaluator on the card gives the NumPy pipeline's feasibility and strategy
rows, every float within 1e-12 relative, and the fused dispatch equals the
batch path; `quick_train_mfmobo` runs through the CLI on the card to its 14
evaluations over the CPU run's designs.

The serving and GNN slice: the GNN forward on the card against the same
params on the CPU (|Δ log1p(wait)| <= 1e-5 * max(1, log1p(wait))), twice
on the card bitwise equal; `train_gnn` on the card with its losses within
1e-4 relative of the CPU's and decreasing; the three serving specs on the
card and the CPU to the same designs and their budgets, the serving
workloads' float64 fields within 1e-12 relative of the NumPy pipeline; an
f0 = "gnn" campaign with calibration on the card to its budget with one
calibration record, resumed bit for bit.

The training slice: K1's backward (`FlashAttentionFn`, the output has a
grad_fn) against its plain version `attention_bwd_ref` on the kernel's own
o and lse, at the JAX flash tests' cases and the training shape (8, 256,
9/3 heads of 64, causal), fp32 within 2e-5 and bf16 within 2e-2 of the
largest reference gradient (the forward's small-case tolerances, scaled to
the gradients), two runs bit for bit; reduced smollm-135m trained 3 steps
on the card and the CPU from the same weights, losses within 1e-5 and grad
norms within 1e-4 relative; the launcher's injected-failure contract on the
card with a bit-equal uninterrupted rerun.

K2's backward (`SSDScanFn`: `ops.ssd`'s outputs have a grad_fn) against
`ssd_chunked_bwd_ref` on the forward's own states, at the cases above and
the two training shapes, fp32 and bf16, contiguous and through strided
views, with and without the final state's gradient: fp32 gradients within
3e-4 of the largest reference gradient, bf16 ones (dx, dB, dC) element by
element within 1e-2 * |ref| + 3e-4 * max|ref| (chip_smoke.py's rules), two
runs bit for bit; reduced mamba2-370m and zamba2-1.2b trained 3 steps on
the card and the CPU as smollm is. The fp32 backward's Hopper route
(`kernel.bwd_on_hopper`) is held at both training shapes, a ragged last
chunk and (2, 300, 4, 64, 128), contiguous and strided, with and without
the final state's gradient, under the same rule, two runs bit for bit,
with the profiler's kernel names those `kernel.backward_kernels` gives and
ssd_scan.cu's rule agreeing; an fp32 shape outside the rule and two bf16
shapes keep the six mma.sync kernels, and a misaligned x (pointer or row
stride) goes to them by the rule, with the right gradients.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.runtime import CPU_TEST, Runtime  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step  # noqa: E402

CASES = [
    # (B, S, H, P, N, chunk)
    (1, 32, 2, 8, 8, 8),
    (2, 64, 4, 16, 16, 16),
    (1, 100, 2, 16, 8, 32),
    (2, 128, 2, 32, 16, 128),
    (1, 37, 4, 64, 128, 128),     # Q = S = 37
    (2, 300, 4, 64, 128, 128),    # ragged over three chunks
]
DTYPES = {"fp32": (torch.float32, 3e-4), "bf16": (torch.bfloat16, 4e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, dtype, seed=0):
    B, S, H, P, N, _ = case
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, S, H, P), dtype=np.float32))
    dt = torch.from_numpy(np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(np.float32))
    A = torch.from_numpy(-np.exp(rng.standard_normal(H) * 0.5).astype(np.float32))
    Bm = torch.from_numpy(rng.standard_normal((B, S, N), dtype=np.float32))
    Cm = torch.from_numpy(rng.standard_normal((B, S, N), dtype=np.float32))
    D = torch.linspace(0.2, 1.0, H)
    return [x.to(dtype), dt.to(dtype).float(), A, Bm.to(dtype), Cm.to(dtype), D]


@pytest.mark.gpu
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_version(cuda, case, dname):
    dtype, tol = DTYPES[dname]
    args = [a.to(cuda) for a in _inputs(case, dtype)]
    before = ssd_scan.launches
    y, h = ops.ssd(*args, chunk=case[-1])
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    y0, h0 = ssd_chunked_ref(*args, chunk=case[-1])
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, h0, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 2, 4])
@pytest.mark.parametrize("case", CASES)
def test_bf16_kernel_reads_strided_views(cuda, case, offset):
    """x, B and C cut from one packed (B, S, H*P + 2N) bf16 tensor, starting
    `offset` elements into its storage (copies of 16, 8, 4 or 2 bytes):
    y and the state equal those of contiguous copies exactly, and the plain
    version's within the bf16 tolerance."""
    B, S, H, P, N, chunk = case
    x, dt, A, Bm, Cm, D = [a.to(cuda) for a in _inputs(case, torch.bfloat16)]
    width = H * P + 2 * N
    store = torch.zeros(B * S * width + offset, dtype=torch.bfloat16, device=cuda)
    packed = store[offset:].view(B, S, width)
    packed.copy_(torch.cat([x.flatten(-2), Bm, Cm], -1))
    xs, Bs, Cs = packed.split([H * P, N, N], -1)
    xs = xs.unflatten(-1, (H, P))
    before = ssd_scan.launches
    y, h = ops.ssd(xs, dt, A, Bs, Cs, D, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    yc, hc = ops.ssd(x, dt, A, Bm, Cm, D, chunk=chunk)
    assert torch.equal(y, yc) and torch.equal(h, hc)
    y0, h0 = ssd_chunked_ref(x, dt, A, Bm, Cm, D, chunk=chunk)
    tol = DTYPES["bf16"][1]
    torch.testing.assert_close(y.float(), y0.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, h0, rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("S", [1024, 2048, 4096])
def test_kernel_at_the_zamba2_prefill_shape(cuda, S, dname):
    """(B, S, H, P, N) = (1, S, 64, 64, 64): N = 64 pads to two 32-column
    tiles, the grid has 64 heads; S = 2048 is the longest prefill of the
    serving run, 4096 the forward's (32 chunks through state_pass)."""
    case = (1, S, 64, 64, 64, 128)
    args = [a.to(cuda) for a in _inputs(case, DTYPES[dname][0])]
    before = ssd_scan.launches
    y, h = ops.ssd(*args, chunk=128)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    y0, h0 = ssd_chunked_ref(*args, chunk=128)
    y, y0 = y.float(), y0.float()
    ay = 3e-4 * max(1.0, y0.abs().max().item())
    assert (h - h0).abs().max().item() <= 3e-4 * max(1.0, h0.abs().max().item())
    if dname == "fp32":
        assert (y - y0).abs().max().item() <= ay
    else:
        assert bool(((y - y0).abs() <= 1e-2 * y0.abs() + ay).all())


@pytest.mark.gpu
def test_engine_on_the_card_matches_cpu(cuda):
    """The same weights served on the card (fp32, the CUDA kernel) give the
    CPU's greedy tokens, with one kernel launch per layer per prefill."""
    cfg = reduced_config("mamba2-370m")
    rt = Runtime(device="cuda", compute_dtype=torch.float32, ssd_chunk=8)
    rt_cpu = Runtime(device="cpu", compute_dtype=torch.float32, ssd_chunk=8)
    assert rt_cpu.compute_dtype == CPU_TEST.compute_dtype
    cpu_model = Model(cfg, rt_cpu, seed=3)
    gpu_model = Model(cfg, rt, seed=None)
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 26, 11, 17)]

    def run(model, rtx):
        eng = ServeEngine(cfg, rtx, model, slots=2, max_len=64)
        return eng, eng.run([Request(rid=i, prompt=p, max_new_tokens=6)
                             for i, p in enumerate(prompts)])

    _, want = run(cpu_model, rt_cpu)
    before = ssd_scan.launches
    eng, got = run(gpu_model, rt)
    assert got == want
    assert ssd_scan.launches - before == cfg.num_layers * eng.n_admits


FLASH_CASES = [
    # (B, S, Hq, Hkv, hd, causal, window): tests/test_kernels_flash.py's
    (1, 64, 4, 4, 16, True, None),
    (2, 128, 4, 2, 32, True, None),
    (1, 96, 8, 1, 16, True, None),
    (2, 128, 4, 4, 64, True, 32),
    (1, 256, 2, 2, 16, False, None),
    (1, 80, 3, 1, 16, True, 24),
]
FLASH_SERVING = (4, 1500, 12, 12, 64, False, None)     # the whisper encoder
# the full-sequence forward of gemma3-4b (a local layer: window 1024; a global
# one: causal only; hd 256, GQA 8/4) and of mixtral-8x7b (hd 128, GQA 32/8,
# window 4096), bf16 only
FLASH_DECODER = [(1, 4096, 8, 4, 256, True, 1024), (1, 4096, 8, 4, 256, True, None),
                 (1, 4096, 32, 8, 128, True, 4096), (1, 4096, 32, 32, 64, True, None)]
FLASH_DTYPES = {"fp32": (torch.float32, 2e-5), "bf16": (torch.bfloat16, 2e-2)}


@pytest.mark.gpu
@pytest.mark.parametrize("dname", list(FLASH_DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES + [FLASH_SERVING])
def test_flash_kernel_matches_plain_version(cuda, case, dname):
    B, S, Hq, Hkv, hd, causal, window = case
    dtype, tol = FLASH_DTYPES[dname]
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, h, hd), dtype=np.float32))
               .to(dtype).to(cuda) for h in (Hq, Hkv, Hkv))
    pos = torch.arange(S, device=cuda)[None].expand(B, S)
    before = flash_attention.launches
    out = fa_ops.mha(q, k, v, pos, pos, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = attention_ref(q, k, v, pos, pos, causal=causal, window=window).float()
    if case != FLASH_SERVING:
        torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)
        return
    a = 1e-4 * ref.abs().max().item()
    err = (out.float() - ref).abs()
    assert bool((err <= (a if dname == "fp32" else 1e-2 * ref.abs() + a)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_DECODER,
                         ids=["gemma3", "gemma3_global", "mixtral", "zamba2"])
def test_flash_kernel_at_the_decoder_forward_shapes(cuda, case):
    """bf16, under the long shapes' rule: |d| <= 1e-2 |ref| + 1e-4 max|ref|."""
    B, S, Hq, Hkv, hd, causal, window = case
    q, k, v = _qkv(B, S, S, Hq, Hkv, hd, torch.bfloat16, cuda)
    pos = torch.arange(S, device=cuda)[None].expand(B, S)
    before = flash_attention.launches
    out = fa_ops.mha(q, k, v, pos, pos, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = attention_ref(q, k, v, pos, pos, causal=causal, window=window).float()
    err = (out.float() - ref).abs()
    assert torch.isfinite(out).all()
    assert bool((err <= 1e-2 * ref.abs() + 1e-4 * ref.abs().max()).all())


# bf16 tensor-core kernel: every head-dim class, ragged Sq (200) and Skv
# (200, or 137 without a causal mask), GQA 7 with causal plus window
MMA_HDS = [16, 48, 80, 128, 144, 256]
MMA_CASES = [
    # (B, Sq, Skv, Hq, Hkv, causal, window)
    (2, 200, 200, 7, 1, True, 50),
    (1, 200, 137, 2, 2, False, None),
    (1, 200, 200, 4, 2, True, None),
]


WGMMA_HDS = [64, 128, 256]


def _qkv(B, Sq, Skv, Hq, Hkv, hd, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, s, h, hd), dtype=np.float32))
            .to(dtype).to(device) for s, h in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv))]


@pytest.mark.gpu
@pytest.mark.parametrize("case", MMA_CASES)
@pytest.mark.parametrize("hd", MMA_HDS)
def test_bf16_kernel_at_every_head_dim(cuda, hd, case):
    B, Sq, Skv, Hq, Hkv, causal, window = case
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, hd, torch.bfloat16, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    qp = torch.arange(Sq, device=cuda)[None].expand(B, Sq)
    kp = torch.arange(Skv, device=cuda)[None].expand(B, Skv)
    ref = attention_ref(q, k, v, qp, kp, causal=causal, window=window).float()
    err = (out.float() - ref).abs()
    assert torch.isfinite(out).all()
    assert bool((err <= 1e-2 * ref.abs() + 1e-4 * ref.abs().max()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("hd", MMA_HDS)
def test_bf16_kernel_window_one_returns_each_rows_value(cuda, hd):
    q, k, v = _qkv(2, 200, 200, 7, 1, hd, torch.bfloat16, cuda, seed=1)
    out = flash_attention(q, k, v, causal=True, window=1)
    assert torch.equal(out, v.repeat_interleave(7, dim=2))


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["pointer", "row stride"])
def test_bf16_kernel_raises_on_misaligned_input(cuda, where):
    """cp.async moves 16 bytes: a bf16 q whose pointer or row stride is not
    16-byte aligned is refused before anything launches."""
    B, S, H, hd = 1, 64, 2, 16
    if where == "pointer":
        store = torch.randn(B * S * H * hd + 1, device=cuda).to(torch.bfloat16)
        q = store[1:].view(B, S, H, hd)
    else:
        q = torch.randn(B, S, H * hd + 4, device=cuda).to(torch.bfloat16)[..., :H * hd]
        q = q.unflatten(-1, (H, hd))
    k, v = (torch.randn(B, S, H, hd, device=cuda).to(torch.bfloat16) for _ in range(2))
    before = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, k, v)
    assert flash_attention.launches == before


# K1's bf16 forward at hd 64, 128 and 256 (flash_wgmma_kernel, wgmma fed by
# TMA): ragged Sq/Skv, GQA, causal plus window, and cases whose grids take
# one, two and three consumer warpgroups a block (132 SMs)
WGMMA_CASES = MMA_CASES + [
    (1, 1, 1, 2, 1, True, None),          # one query row
    (2, 1024, 1024, 70, 10, True, None),  # 8 x 140 blocks of 128 rows (of 192 at hd 64: 6 x 140)
]


def _profiled_kernels(fn, runs=1):
    """The CUDA kernels `fn` launches, by name without arguments. torch's
    profiler now and then records no device event at all for a call (seen
    on the H100 in this file's bf16 and fp32 kernel-name tests); a call it
    saw nothing of is profiled again, up to three times. It has also been
    seen to miss a session's first kernels (K1's fp32 backward at hd 256,
    K2's backward at its training shapes): `runs` calls a session."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        names = {e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
                 for e in prof.events() if e.device_type.name == "CUDA"}
        if names:
            break
    return {n.split("(")[0] for n in names}


@pytest.mark.gpu
@pytest.mark.parametrize("case", WGMMA_CASES)
@pytest.mark.parametrize("hd", WGMMA_HDS)
def test_wgmma_kernel_matches_plain_version(cuda, hd, case):
    """flash_wgmma_kernel against attention_ref under the long bf16 rule,
    its lse against the plain logsumexp, two runs and a call on strided
    views of one packed (B, S, Hq + 2 Hkv, hd) tensor bit for bit."""
    B, Sq, Skv, Hq, Hkv, causal, window = case
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, hd, torch.bfloat16, cuda)
    out, lse = flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    again = flash_attention(q, k, v, causal=causal, window=window)
    qp = torch.arange(Sq, device=cuda)[None].expand(B, Sq)
    kp = torch.arange(Skv, device=cuda)[None].expand(B, Skv)
    ref, lse_ref = attention_ref(q, k, v, qp, kp, causal=causal, window=window,
                                 return_lse=True)
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out).all()
    assert bool((err <= 1e-2 * ref.float().abs() + 1e-4 * ref.float().abs().max()).all())
    assert (lse - lse_ref).abs().max().item() <= 1e-5 * max(1.0, lse_ref.abs().max().item())
    assert torch.equal(out, again)
    if Sq == Skv:
        qs, ks, vs = torch.cat([q, k, v], 2).split([Hq, Hkv, Hkv], 2)
        assert torch.equal(flash_attention(qs, ks, vs, causal=causal, window=window), out)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", WGMMA_HDS + [80])
@pytest.mark.parametrize("case", [(1, 200, 2, 1), (2, 1024, 70, 10)], ids=["small", "wide"])
def test_bf16_forward_runs_the_kernel_its_rule_names(cuda, case, hd):
    """The profiler names the CUDA kernel `forward_kernel(hd, bf16)` names:
    flash_wgmma_kernel at hd 64, 128 and 256 (one, two or three consumer
    warpgroups by the grid), flash_mma_kernel at other head dims."""
    from repro_torch.kernels.flash_attention.kernel import forward_kernel
    B, S, Hq, Hkv = case
    q, k, v = _qkv(B, S, S, Hq, Hkv, hd, torch.bfloat16, cuda)
    ran = _profiled_kernels(lambda: flash_attention(q, k, v, causal=True))
    assert len(ran) == 1 and next(iter(ran)).startswith(forward_kernel(hd, torch.bfloat16))
    if hd in WGMMA_HDS:
        groups = 1 if case[0] == 1 else (3 if hd == 64 else 2)
        assert next(iter(ran)).endswith(f"<{hd}, {groups}>"), ran


@pytest.mark.gpu
@pytest.mark.parametrize("hd", WGMMA_HDS)
@pytest.mark.parametrize("scale", [-0.3, 0.0, 1e-3])
def test_wgmma_kernel_at_any_softmax_scale(cuda, scale, hd):
    """A negative scale (S taken with wgmma's negated A), a zero scale
    (every kept key weighs the same, masked ones still 0) and a small one,
    under a causal window, against attention_ref under the long bf16 rule."""
    q, k, v = _qkv(1, 200, 200, 4, 2, hd, torch.bfloat16, cuda, seed=2)
    out = flash_attention(q, k, v, causal=True, window=50, softmax_scale=scale)
    pos = torch.arange(200, device=cuda)[None]
    ref = attention_ref(q, k, v, pos, pos, causal=True, window=50, softmax_scale=scale).float()
    err = (out.float() - ref).abs()
    assert torch.isfinite(out).all()
    assert bool((err <= 1e-2 * ref.abs() + 1e-4 * ref.abs().max()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("hd", WGMMA_HDS)
def test_wgmma_kernel_raises_on_misaligned_input(cuda, hd):
    """TMA takes 16-byte aligned pointers and strides: a bf16 q whose row
    stride is not 16-byte aligned is refused before anything launches."""
    B, S, H = 1, 64, 2
    q = torch.randn(B, S, H * hd + 4, device=cuda).to(torch.bfloat16)[..., :H * hd]
    q = q.unflatten(-1, (H, hd))
    k, v = (torch.randn(B, S, H, hd, device=cuda).to(torch.bfloat16) for _ in range(2))
    before = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, k, v)
    assert flash_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", MMA_CASES)
@pytest.mark.parametrize("hd", MMA_HDS)
def test_fp32_kernel_at_every_head_dim(cuda, hd, case):
    """flash_tf32_kernel (split TF32) at every head-dim class (64-key tiles
    up to hd = 128, 32 above) with ragged Sq and Skv, under chip_smoke.py's
    long fp32 rule |d| <= 1e-4 max|ref|."""
    B, Sq, Skv, Hq, Hkv, causal, window = case
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, hd, torch.float32, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    qp = torch.arange(Sq, device=cuda)[None].expand(B, Sq)
    kp = torch.arange(Skv, device=cuda)[None].expand(B, Skv)
    ref = attention_ref(q, k, v, qp, kp, causal=causal, window=window)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["pointer", "row stride"])
def test_fp32_kernel_raises_on_misaligned_input(cuda, where):
    """The fp32 kernels stage by 16-byte cp.async too: an fp32 q whose
    pointer or row stride is not 16-byte aligned is refused before anything
    launches, forward and backward."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd
    B, S, H, hd = 1, 64, 2, 16
    if where == "pointer":
        q = torch.randn(B * S * H * hd + 1, device=cuda)[1:].view(B, S, H, hd)
    else:
        q = torch.randn(B, S, H * hd + 2, device=cuda)[..., :H * hd].unflatten(-1, (H, hd))
    k, v = (torch.randn(B, S, H, hd, device=cuda) for _ in range(2))
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, k, v)
    o, lse = flash_attention(q.clone(), k, v, return_lse=True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention_bwd(q, k, v, o, lse, torch.randn_like(o))
    assert (flash_attention.launches, flash_attention_bwd.launches) == (f0 + 1, b0)


# K1's fp32 forward on Hopper (flash_wgmma_tf32_fwd_prep_kernel, then
# flash_wgmma_tf32_kernel: TF32 wgmma fed by TMA) takes hd 64, 128, 256 with
# more than TF32_MMA_KEYS["forward"] (512) keys: test_fp32_kernel_at_every_
# head_dim's cases with their key counts raised past it, (B, Sq, Skv, Hq,
# Hkv, causal, window): GQA 7 with causal plus window, ragged non-causal
# Skv != Sq, GQA 2, empty rows (rows 619 .. 699 see no key under causal plus
# window 20 over 600 keys), and a grid of two consumer warpgroups a block
TF32_FWD_CASES = [
    (2, 600, 600, 7, 1, True, 50),
    (1, 600, 513, 2, 2, False, None),
    (1, 600, 600, 4, 2, True, None),
    (1, 700, 600, 2, 1, True, 20),
    (34, 600, 600, 14, 2, True, None),
]


def _fp32_route(B, Sq, Skv, Hq, Hkv, hd, backward=False):
    from repro_torch.kernels.flash_attention.kernel import fp32_on_hopper
    return fp32_on_hopper(hd, (B, Sq, Skv, Hq, Hkv), backward)


@pytest.mark.gpu
@pytest.mark.parametrize("case", TF32_FWD_CASES)
@pytest.mark.parametrize("hd", WGMMA_HDS)
def test_wgmma_tf32_forward_matches_plain_version(cuda, hd, case):
    """The Hopper fp32 forward against attention_ref under the long fp32 rule
    (|d| <= 1e-4 max|ref|) on every row that sees a key, exactly 0 on rows
    that see none; its lse within 1e-5 of the plain logsumexp; o the same
    bits with and without lse, two runs and a call on strided views of one
    packed (B, S, Hq + 2 Hkv, hd) tensor bit for bit; the profiler names
    exactly the kernels `forward_kernels(hd, fp32, shape)` names, with the
    consumer warpgroups a block that the grid rule gives."""
    from repro_torch.kernels.flash_attention.kernel import forward_kernels
    B, Sq, Skv, Hq, Hkv, causal, window = case
    assert _fp32_route(B, Sq, Skv, Hq, Hkv, hd)
    kw = {"causal": causal, "window": window}
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, hd, torch.float32, cuda)
    before = flash_attention.launches
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    plain_o = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, return_lse=True, **kw)
    ran = _profiled_kernels(lambda: flash_attention(q, k, v, **kw))
    torch.cuda.synchronize()
    assert flash_attention.launches >= before + 4
    prep, main = forward_kernels(hd, torch.float32, (B, Sq, Skv, Hq, Hkv))
    groups = 2 if B == 34 else 1
    assert ran == {f"{prep}<{hd}>", f"{main}<{hd}, {groups}>"}, ran
    qp = torch.arange(Sq, device=cuda)[None].expand(B, Sq)
    kp = torch.arange(Skv, device=cuda)[None].expand(B, Skv)
    ref, lse_ref = attention_ref(q, k, v, qp, kp, return_lse=True, **kw)
    seen = torch.ones(Sq, dtype=torch.bool, device=cuda)
    if window is not None:
        seen = torch.arange(Sq, device=cuda) - window + 1 < Skv
    assert torch.isfinite(out).all()
    assert (out - ref)[:, seen].abs().max() <= 1e-4 * ref[:, seen].abs().max()
    assert torch.equal(out[:, ~seen], torch.zeros_like(out[:, ~seen]))
    dlse = (lse - lse_ref)[:, :, seen].abs().max().item()
    assert dlse <= 1e-5 * max(1.0, lse_ref[:, :, seen].abs().max().item())
    assert torch.equal(out, plain_o) and torch.equal(out, again[0]) and torch.equal(lse, again[1])
    if Sq == Skv:
        qs, ks, vs = torch.cat([q, k, v], 2).split([Hq, Hkv, Hkv], 2)
        assert torch.equal(flash_attention(qs, ks, vs, **kw), out)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", WGMMA_HDS)
def test_wgmma_tf32_forward_window_one_and_any_scale(cuda, hd):
    """window = 1: each row's only live key has p = 1, and V's three TF32
    terms return that key's v bit for bit. A negative, a zero and a small
    softmax scale under a causal window against attention_ref under the long
    fp32 rule (the scale is folded into the fp32 scores, never into q)."""
    q, k, v = _qkv(2, 600, 600, 7, 1, hd, torch.float32, cuda, seed=1)
    assert torch.equal(flash_attention(q, k, v, causal=True, window=1),
                       v.repeat_interleave(7, dim=2))
    q, k, v = _qkv(1, 600, 600, 4, 2, hd, torch.float32, cuda, seed=2)
    pos = torch.arange(600, device=cuda)[None]
    for scale in (-0.3, 0.0, 1e-3):
        out = flash_attention(q, k, v, causal=True, window=50, softmax_scale=scale)
        ref = attention_ref(q, k, v, pos, pos, causal=True, window=50, softmax_scale=scale)
        assert torch.isfinite(out).all()
        assert (out - ref).abs().max() <= 1e-4 * ref.abs().max(), scale


@pytest.mark.gpu
@pytest.mark.parametrize("hd", WGMMA_HDS)
def test_wgmma_tf32_forward_raises_on_misaligned_input(cuda, hd):
    """TMA takes 16-byte aligned pointers and strides: an fp32 q whose row
    stride is not 16-byte aligned, at a shape the Hopper route takes, is
    refused before anything launches."""
    B, S, H = 1, 600, 2
    q = torch.randn(B, S, H * hd + 2, device=cuda)[..., :H * hd].unflatten(-1, (H, hd))
    k, v = (torch.randn(B, S, H, hd, device=cuda) for _ in range(2))
    assert _fp32_route(B, S, S, H, H, hd)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(q, k, v)
    assert flash_attention.launches == before


@pytest.mark.gpu
def test_tf32_forward_at_mixtrals_training_case(cuda):
    """mixtral-8x7b's training case (1, 4096, 32/8 heads of 128, causal,
    window 4096) in fp32, where O sums 4096 keys on the tensor cores: every
    entry of o within 2e-5 (|ref| + max|ref|) of the float64 function, its
    lse within 1e-5."""
    kw = {"causal": True, "window": 4096}
    q, k, v = _qkv(1, 4096, 4096, 32, 8, 128, torch.float32, cuda)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    pos = torch.arange(4096, device=cuda)[None]
    o64, lse64 = attention_ref(q.double(), k.double(), v.double(), pos, pos, return_lse=True, **kw)
    err = (out.double() - o64).abs()
    assert bool((err <= 2e-5 * (o64.abs() + o64.abs().max())).all()), err.max().item()
    assert (lse.double() - lse64).abs().max().item() <= 1e-5 * lse64.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dname", ["fp32", "bf16"])
@pytest.mark.parametrize("hd", MMA_HDS)
def test_flash_backward_at_every_head_dim(cuda, hd, dname):
    """The backward at every head-dim class (fp32: the split-TF32 kernels,
    on mma.sync with dK/dV columns split in two blocks above hd = 64, as the
    shape rule takes 200 keys at hd 128 and 256 too; bf16: the split-bf16 kernels, on mma.sync
    with dK/dV columns split in two blocks above hd = 128, on wgmma at hd
    128 and 256), ragged S, GQA
    7, causal plus window, against attention_bwd_ref on the kernel's own o
    and lse under chip_smoke.py's long rules (fp32 |d| <= 1e-4 max|ref|;
    bf16 |d| <= 1e-2 |ref| + 1e-4 max|ref|), two runs bit for bit. Two
    batch sizes: the mma.sync dK/dV kernel runs four groups over 32 keys
    where its 64-key blocks are fewer than the SMs (B = 2: 8 or 16 blocks)
    and two groups over 64 keys where they fill the card (B = 34: 136 or
    272 blocks)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    dtype = torch.float32 if dname == "fp32" else torch.bfloat16
    S, Hq, Hkv = 200, 7, 1
    for B in (2, 34):
        q, k, v = _qkv(B, S, S, Hq, Hkv, hd, dtype, cuda)
        do = _qkv(B, S, S, Hq, Hkv, hd, dtype, cuda, seed=1)[0]
        o, lse = flash_attention(q, k, v, causal=True, window=50, return_lse=True)
        grads = flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=50)
        again = flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=50)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(grads, again))
        want = attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=50)
        for g, w in zip(grads, want):
            w, err = w.float(), (g.float() - w.float()).abs()
            assert g.dtype == dtype and torch.isfinite(g).all()
            if dname == "fp32":
                assert err.max() <= 1e-4 * w.abs().max()
            else:
                assert bool((err <= 1e-2 * w.abs() + 1e-4 * w.abs().max()).all())


@pytest.mark.gpu
def test_bf16_backward_at_the_mixtral_mesh_shard(cuda):
    """The bf16 backward at mixtral-8x7b's shard of the 2x2 mesh (1, 4096,
    16/4 heads of 128, causal): the profiler names the two kernels
    `backward_kernels(128, bf16)` names (`flash_wgmma_bwd_dq_kernel`, then
    `flash_wgmma_bwd_dkdv_kernel`); 4096-long sums over the keys and, for dK
    and dV, over 4 x 4096 query rows, against attention_bwd_ref on the
    kernel's own o and lse under the long bf16 rule, two runs bit for
    bit."""
    from repro_torch.kernels.flash_attention.kernel import backward_kernels, flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    q, k, v = _qkv(1, 4096, 4096, 16, 4, 128, torch.bfloat16, cuda)
    do = _qkv(1, 4096, 4096, 16, 4, 128, torch.bfloat16, cuda, seed=1)[0]
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    b0 = flash_attention_bwd.launches
    grads = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    ran = _profiled_kernels(lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True))
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == b0 + 3
    assert {n.split("<")[0] for n in ran} == set(backward_kernels(128, torch.bfloat16)), ran
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    want = attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    for g, w in zip(grads, want):
        w, err = w.float(), (g.float() - w.float()).abs()
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
        assert bool((err <= 1e-2 * w.abs() + 1e-4 * w.abs().max()).all())


# K1's bf16 backward at hd 64, 128 and 256 (flash_wgmma_bwd_dq_kernel, then
# flash_wgmma_bwd_dkdv_kernel, wgmma fed by TMA), (B, Sq, Skv, Hq, Hkv,
# causal, window): grids of one consumer warpgroup a block (B = 2: under 132
# blocks) and of the most the grid rule takes (B = 34: dQ 3 at hd 64, 2 at
# 128; dK/dV 2 up to hd 128), causal with a window, GQA, ragged Sq,
# non-causal Skv != Sq both ways, keys no query reaches, one query row over
# 70 keys (one row over one key has dQ = dK = 0 exactly, and both sides
# return rounding noise there)
WGMMA_BWD_CASES = [
    (2, 200, 200, 7, 1, True, 50),
    (34, 200, 200, 14, 2, True, 50),
    (1, 200, 137, 2, 2, False, None),
    (2, 137, 300, 4, 2, False, None),
    (1, 130, 300, 4, 1, True, None),
    (1, 1, 70, 2, 1, False, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WGMMA_BWD_CASES)
@pytest.mark.parametrize("hd", WGMMA_HDS)
def test_wgmma_backward_matches_plain_version(cuda, hd, case):
    """The Hopper bf16 backward against attention_bwd_ref on the kernel's own
    o and lse under the long bf16 rule (|d| <= 1e-2 |ref| + 1e-4 max|ref|
    at every element), two runs and a call on strided views bit for bit;
    the profiler names the kernels `backward_kernels(hd, bf16)` names, with
    the warpgroups a block that the grid rule gives."""
    from repro_torch.kernels.flash_attention.kernel import backward_kernels, flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    B, Sq, Skv, Hq, Hkv, causal, window = case
    kw = {"causal": causal, "window": window}
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, hd, torch.bfloat16, cuda)
    do = _qkv(B, Sq, Sq, Hq, Hkv, hd, torch.bfloat16, cuda, seed=1)[0]
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    ran = _profiled_kernels(lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    dq_name, kv_name = backward_kernels(hd, torch.bfloat16)
    groups = ((3 if hd == 64 else 2 if hd == 128 else 1), (2 if hd <= 128 else 1)) if B == 34 \
        else (1, 1)
    assert ran == {f"{dq_name}<{hd}, {groups[0]}>", f"{kv_name}<{hd}, {groups[1]}>"}, ran
    want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(grads, want):
        w, err = w.float(), (g.float() - w.float()).abs()
        assert g.dtype == torch.bfloat16 and g.shape == w.shape and torch.isfinite(g).all()
        assert bool((err <= 1e-2 * w.abs() + 1e-4 * w.abs().max()).all())
    if Sq == Skv:
        qs, ks, vs = torch.cat([q, k, v], 2).split([Hq, Hkv, Hkv], 2)
        strided = flash_attention_bwd(qs, ks, vs, o, lse, do, **kw)
        assert all(torch.equal(a, b) for a, b in zip(strided, grads))


# K1's fp32 backward at hd 64, 128 and 256: the Hopper route (more than
# TF32_MMA_KEYS["backward"] (256) keys) at WGMMA_BWD_CASES with their key
# counts raised past it, then two cases the rule keeps on the mma.sync pair: smollm-135m's
# training shape and GQA 7 with causal plus window over 200 keys
TF32_BWD_CASES = [
    (2, 300, 300, 7, 1, True, 50),
    (34, 300, 300, 14, 2, True, 50),
    (1, 300, 257, 2, 2, False, None),
    (2, 137, 300, 4, 2, False, None),
    (1, 130, 300, 4, 1, True, None),
    (1, 1, 270, 2, 1, False, None),
    (8, 256, 256, 9, 3, True, None),
    (2, 200, 200, 7, 1, True, 50),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", TF32_BWD_CASES)
@pytest.mark.parametrize("hd", WGMMA_HDS)
def test_wgmma_tf32_backward_matches_plain_version(cuda, hd, case):
    """The fp32 backward at hd 64, 128 and 256 on the route its shape rule
    gives (the Hopper route: `flash_wgmma_tf32_bwd_prep_kernel`, then the
    TF32 wgmma dQ and dK/dV kernels; at TF32_MMA_KEYS["backward"] keys or
    fewer the mma.sync pair) against attention_bwd_ref on the kernel's own o and lse
    under the long fp32 rule (|d| <= 1e-4 max|ref|), two runs and a call on
    strided views bit for bit; the profiler names exactly the kernels
    `backward_kernels(hd, fp32, shape)` names, with the warpgroups a block
    that the grid rule gives."""
    from repro_torch.kernels.flash_attention.kernel import backward_kernels, flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    B, Sq, Skv, Hq, Hkv, causal, window = case
    kw = {"causal": causal, "window": window}
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, hd, torch.float32, cuda)
    do = _qkv(B, Sq, Sq, Hq, Hkv, hd, torch.float32, cuda, seed=1)[0]
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    ran = _profiled_kernels(lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw), runs=2)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    names = backward_kernels(hd, torch.float32, (B, Sq, Skv, Hq, Hkv))
    if _fp32_route(B, Sq, Skv, Hq, Hkv, hd, backward=True):
        prep, dq_name, kv_name = names
        groups = 2 if B == 34 and hd <= 128 else 1
        assert ran == {f"{prep}<{hd}>", f"{dq_name}<{hd}, {groups}>",
                       f"{kv_name}<{hd}, {groups}>"}, ran
    else:
        assert ran == {f"{n}<{hd}>" for n in names}, ran
    want = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(grads, want):
        assert g.dtype == torch.float32 and g.shape == w.shape and torch.isfinite(g).all()
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()
    if Sq == Skv:
        qs, ks, vs = torch.cat([q, k, v], 2).split([Hq, Hkv, Hkv], 2)
        strided = flash_attention_bwd(qs, ks, vs, o, lse, do, **kw)
        assert all(torch.equal(a, b) for a, b in zip(strided, grads))


@pytest.mark.gpu
def test_tf32_backward_at_mixtrals_training_case(cuda):
    """mixtral-8x7b's training case (1, 4096, 32/8 heads of 128, causal,
    window 4096) in fp32, where dK and dV sum 4 x 4096 query rows: every
    entry of dq, dk and dv within 2e-5 (|ref| + max|ref|) of the float64
    gradients of the function."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    kw = {"causal": True, "window": 4096}
    q, k, v = _qkv(1, 4096, 4096, 32, 8, 128, torch.float32, cuda)
    do = _qkv(1, 4096, 4096, 32, 8, 128, torch.float32, cuda, seed=1)[0]
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    del o, lse
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    pos = torch.arange(4096, device=cuda)[None]
    o64, lse64 = attention_ref(q64, k64, v64, pos, pos, return_lse=True, **kw)
    for g, w in zip(grads, attention_bwd_ref(q64, k64, v64, o64, lse64, do64, **kw)):
        err = (g.double() - w).abs()
        assert torch.isfinite(g).all()
        assert bool((err <= 2e-5 * (w.abs() + w.abs().max())).all()), err.max().item()


@pytest.mark.gpu
def test_whisper_on_the_card_matches_cpu(cuda):
    """The same weights (reduced whisper, fp32) on the card and the CPU give
    the same greedy tokens through the serve steps, logits within 1e-4, and
    the encoder launches the kernel once per layer per prefill; the
    teacher-forced forward launches it once per encoder and decoder layer."""
    cfg = reduced_config("whisper-small")
    rt = Runtime(device="cuda", compute_dtype=torch.float32)
    cpu_model = Model(cfg, CPU_TEST, seed=3)
    gpu_model = Model(cfg, rt, seed=None)
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(7)
    frames = torch.from_numpy(rng.standard_normal((2, cfg.encoder_len, cfg.d_model),
                                                  dtype=np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 5)))

    def run(model, rtx):
        dev = rtx.torch_device()
        prefill, decode = make_prefill_step(cfg, rtx, 32), make_decode_step(cfg, rtx)
        logits, cache = prefill(model, {"tokens": tokens.to(dev), "frames": frames.to(dev)})
        toks, all_logits = [], [logits.cpu()]
        for step in range(6):
            toks.append(logits.argmax(-1).tolist())
            logits, cache = decode(model, logits.argmax(-1)[:, None], 5 + step, cache)
            all_logits.append(logits.cpu())
        fwd = model(tokens.to(dev), frames=frames.to(dev)).cpu()
        return toks, torch.stack(all_logits), fwd

    want = run(cpu_model, CPU_TEST)
    before = flash_attention.launches
    got = run(gpu_model, rt)
    assert got[0] == want[0]
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-4)
    assert flash_attention.launches - before == 2 * cfg.encoder_layers + cfg.num_layers


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma3-4b", "mixtral-8x7b"])
def test_decoder_archs_on_the_card_match_cpu(cuda, arch):
    """The same weights (reduced, fp32) served on the card and the CPU give
    the same greedy tokens through the engine; the forward's logits agree
    within 1e-4 and launch the kernel once per layer, the engine never."""
    cfg = reduced_config(arch)
    rt = Runtime(device="cuda", compute_dtype=torch.float32)
    cpu_model = Model(cfg, CPU_TEST, seed=3)
    gpu_model = Model(cfg, rt, seed=None)
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 26, 11, 17)]
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))

    def run(model, rtx):
        eng = ServeEngine(cfg, rtx, model, slots=2, max_len=64)
        out = eng.run([Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)])
        served = flash_attention.launches
        return out, model(tokens.to(rtx.torch_device())).cpu(), served

    want = run(cpu_model, CPU_TEST)
    before = flash_attention.launches
    out, fwd, served = run(gpu_model, rt)
    assert out == want[0]
    assert served == before
    torch.testing.assert_close(fwd, want[1], rtol=1e-4, atol=1e-4)
    assert flash_attention.launches - served == cfg.num_layers


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "paligemma-3b"])
def test_hybrid_and_vlm_on_the_card_match_cpu(cuda, arch):
    """The same weights (reduced, fp32) on the card and the CPU: zamba2
    through the engine (K2 once per SSM layer per admission, no K1), and
    paligemma through the serve steps with patches (no kernel: its
    prefix-LM mask stays on the plain path) give the same greedy tokens;
    the forward's logits agree within 1e-4."""
    cfg = reduced_config(arch)
    rt = Runtime(device="cuda", compute_dtype=torch.float32, ssd_chunk=8)
    rt_cpu = Runtime(device="cpu", compute_dtype=torch.float32, ssd_chunk=8)
    cpu_model = Model(cfg, rt_cpu, seed=3)
    gpu_model = Model(cfg, rt, seed=None)
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 26, 11, 17)]
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))
    patches = torch.from_numpy(rng.standard_normal((2, cfg.prefix_len, cfg.d_model),
                                                   dtype=np.float32))
    extra = {"patches": patches} if cfg.prefix_len else {}

    def run(model, rtx):
        dev = rtx.torch_device()
        inputs = {k: v.to(dev) for k, v in extra.items()}
        if cfg.family == "vlm":
            prefill, decode = make_prefill_step(cfg, rtx, 64), make_decode_step(cfg, rtx)
            logits, cache = prefill(model, {"tokens": tokens.to(dev), **inputs})
            out = []
            for step in range(6):
                out.append(logits.argmax(-1).tolist())
                logits, cache = decode(model, logits.argmax(-1)[:, None],
                                       cfg.prefix_len + 24 + step, cache)
        else:
            eng = ServeEngine(cfg, rtx, model, slots=2, max_len=64)
            out = eng.run([Request(rid=i, prompt=p, max_new_tokens=6)
                           for i, p in enumerate(prompts)])
            out = (out, eng.n_admits)
        served = (flash_attention.launches, ssd_scan.launches)
        return out, model(tokens.to(dev), **inputs).cpu(), served

    want = run(cpu_model, rt_cpu)
    before = (flash_attention.launches, ssd_scan.launches)
    out, fwd, served = run(gpu_model, rt)
    assert out == want[0]
    torch.testing.assert_close(fwd, want[1], rtol=1e-4, atol=1e-4)
    n_admits = out[1] if cfg.family == "hybrid" else 0
    assert served == (before[0], before[1] + cfg.num_layers * n_admits)
    n_app = cfg.num_layers // cfg.shared_attn_every if cfg.family == "hybrid" else 0
    assert (flash_attention.launches, ssd_scan.launches) == (
        served[0] + n_app, served[1] + (cfg.num_layers if cfg.family == "hybrid" else 0))


def _dse_problem(n, seed=17):
    from repro_torch.core import mfmobo as M
    from repro_torch.core.design_space import DIMS
    rng = np.random.default_rng(seed + n)
    d = len(DIMS)
    X = rng.random((n, d))
    Y = np.stack([1e4 * (1 + rng.random(n)), 1e3 * (2 + rng.random(n))], 1)
    return X, Y, M.obj_space([tuple(y) for y in Y]), rng.random((32, d)), rng.random((3, d))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8, 11, 14])
def test_dse_gp_and_acquire_on_the_card_match_cpu(cuda, n):
    from repro_torch.core import mfmobo as M
    X, Y, ev, cand, xs_new = _dse_problem(n)
    ref = M.hv_ref(15000.0)
    got = {}
    for dev in ("cpu", "cuda"):
        if dev == "cuda":
            M.warm_optimizer_kernels(n_candidates=32, q=4, device=dev)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            models = M._fit_models(X, Y, device=dev)
            js = [M._acquire_batch_device(models, cand, ev, ref, q=q) for q in (1, 2, 4)]
            g = models[0]
            for x in xs_new:
                g = g.condition_on(x, 0.5)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        got[dev] = ([j.tolist() for j in js], [m.predict(cand) for m in models],
                    g.predict(cand))
    assert got["cuda"][0] == got["cpu"][0]
    for a, b in zip(got["cuda"][1], got["cpu"][1]):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got["cuda"][2], got["cpu"][2], rtol=5e-3, atol=5e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [8, 24])
@pytest.mark.parametrize("spec", ["quick_train_mfmobo", "gpt175b_train_dse",
                                  "smollm_inference_decode"])
def test_dse_evaluator_on_the_card(cuda, spec, cap):
    from pathlib import Path

    from repro_torch.core import eval_compiled
    from repro_torch.core.design_space import DesignBatch, decode_batch
    from repro_torch.core.evaluator import _wafers_for_budget_batch
    from repro_torch.core.fidelity import AnalyticalBackend
    from repro_torch.explore import CampaignSpec, resolve_workload
    root = Path(__file__).resolve().parents[1]
    wl = resolve_workload(CampaignSpec.from_json(
        str(root / "examples" / "campaigns" / f"{spec}.json")))
    designs = decode_batch(np.random.default_rng(23).random((256, 13)))
    geom = DesignBatch.from_designs(designs)
    nw = _wafers_for_budget_batch(geom, wl)
    nw[::3] = 1                        # small systems: infeasible designs too
    got = eval_compiled.evaluate_batch_compiled(geom, wl, nw, cap, device="cuda")
    want = AnalyticalBackend(device="cpu").evaluate_batch_ref(geom, wl, nw, cap)
    for g, w in zip(got, want):
        assert (g.feasible, g.reason, g.strategy) == (w.feasible, w.reason, w.strategy)
        if w.feasible:
            a = [g.throughput, g.power_w, g.step.step_time_s, g.step.energy_j,
                 *g.step.breakdown.values()]
            b = [w.throughput, w.power_w, w.step.step_time_s, w.step.energy_j,
                 *w.step.breakdown.values()]
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    js = torch.tensor([5, 200, 17, 5], device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pend = eval_compiled.dispatch_fused_eval(geom, wl, nw, js, cap)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    picks = [5, 200, 17, 5]
    fused = pend.finish(nw[picks], 4)
    direct = eval_compiled.evaluate_batch_compiled(
        DesignBatch.from_designs([designs[j] for j in picks]), wl, nw[picks], cap,
        device="cuda")
    assert [(f.feasible, f.strategy, f.throughput, f.power_w) for f in fused] == \
        [(f.feasible, f.strategy, f.throughput, f.power_w) for f in direct]


@pytest.mark.gpu
def test_dse_campaign_on_the_card(cuda):
    from pathlib import Path

    from repro_torch.core.evaluator import clear_eval_cache
    from repro_torch.explore import Campaign, CampaignSpec
    spec = CampaignSpec.from_json(str(Path(__file__).resolve().parents[1] / "examples"
                                      / "campaigns" / "quick_train_mfmobo.json"))
    runs = {}
    for dev in ("cuda", "cpu"):
        clear_eval_cache()
        runs[dev] = Campaign(spec, device=dev).run()
    assert runs["cuda"].n_evals == 14 and runs["cuda"].finished
    assert [str(d) for d in runs["cuda"].trace.designs] == \
        [str(d) for d in runs["cpu"].trace.designs]
    assert abs(runs["cuda"].hv_final - runs["cpu"].hv_final) <= 1e-9 * runs["cpu"].hv_final


def _gnn_dataset():
    from repro_torch.core.calibration import build_calibration_set
    from repro_torch.core.design_space import WSCDesign
    from repro_torch.core.validator import validate
    from repro_torch.core.workload import GPT_BENCHMARKS
    designs = [validate(WSCDesign()).design, validate(WSCDesign(mac_num=256)).design]
    return build_calibration_set(designs, GPT_BENCHMARKS[0])


@pytest.mark.gpu
def test_gnn_forward_on_the_card_matches_cpu_and_repeats_bitwise(cuda):
    from repro_torch.core import noc_gnn as P
    batch = P.pad_link_graphs(_gnn_dataset())
    cpu = P.init_gnn(0, device="cpu")
    card = P.gnn_params_on(cpu, "cuda")
    w_cpu, w1, w2 = (P.gnn_forward_batch(p, batch) for p in (cpu, card, card))
    real = batch.edge_mask > 0
    a, b = np.log1p(w1[real].astype(np.float64)), np.log1p(w_cpu[real].astype(np.float64))
    assert np.all(np.abs(a - b) <= 1e-5 * np.maximum(1.0, np.abs(b)))
    assert w1.tobytes() == w2.tobytes()


@pytest.mark.gpu
def test_gnn_training_on_the_card_matches_cpu(cuda):
    from repro_torch.core import noc_gnn as P
    ds = _gnn_dataset()
    runs = {dev: P.train_gnn(P.init_gnn(0, device=dev), ds, epochs=3, val_frac=0.25)
            for dev in ("cpu", "cuda")}
    again = P.train_gnn(P.init_gnn(0, device="cuda"), ds, epochs=3, val_frac=0.25)
    h, hc = runs["cuda"][1], runs["cpu"][1]
    np.testing.assert_allclose(h.train_loss, hc.train_loss, rtol=1e-4, atol=0)
    assert h.train_loss[-1] < h.train_loss[0]
    assert again[1].train_loss == h.train_loss
    assert all(torch.equal(a, b) for a, b in zip(P._flatten(again[0]), P._flatten(runs["cuda"][0])))


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["gpt175b_serving_slo", "gpt175b_hetero_serving",
                                  "gpt175b_trace_serving"])
def test_serving_campaigns_on_the_card(cuda, spec):
    from pathlib import Path

    from repro_torch.core.evaluator import clear_eval_cache
    from repro_torch.explore import Campaign, CampaignSpec
    want = {"gpt175b_serving_slo": 10, "gpt175b_hetero_serving": 6, "gpt175b_trace_serving": 8}
    s = CampaignSpec.from_json(str(Path(__file__).resolve().parents[1] / "examples"
                                   / "campaigns" / f"{spec}.json"))
    runs = {}
    for dev in ("cuda", "cpu"):
        clear_eval_cache()
        runs[dev] = Campaign(s, device=dev).run()
    assert runs["cuda"].finished and runs["cuda"].n_evals == want[spec]
    assert [str(d) for d in runs["cuda"].trace.designs] == \
        [str(d) for d in runs["cpu"].trace.designs]
    assert runs["cuda"].hv_final == runs["cpu"].hv_final


@pytest.mark.gpu
def test_serving_workloads_on_the_card(cuda):
    from repro_torch.core import eval_compiled
    from repro_torch.core.design_space import DesignBatch, decode_batch
    from repro_torch.core.evaluator import _wafers_for_budget_batch
    from repro_torch.core.fidelity import AnalyticalBackend
    from repro_torch.core.serving import serving_workloads
    from repro_torch.core.workload import GPT_BENCHMARKS, RequestMix
    geom = DesignBatch.from_designs(decode_batch(np.random.default_rng(29).random((256, 13))))
    for wl in serving_workloads(GPT_BENCHMARKS[7], RequestMix.uniform(16, 2048, 64), 8)[:2]:
        nw = _wafers_for_budget_batch(geom, wl)
        got = eval_compiled.evaluate_batch_compiled(geom, wl, nw, 8, device="cuda")
        want = AnalyticalBackend(device="cpu").evaluate_batch_ref(geom, wl, nw, 8)
        for g, w in zip(got, want):
            assert (g.feasible, g.strategy) == (w.feasible, w.strategy)
            if w.feasible:
                np.testing.assert_allclose([g.throughput, g.power_w, g.step.energy_j],
                                           [w.throughput, w.power_w, w.step.energy_j],
                                           rtol=1e-12, atol=0)


@pytest.mark.gpu
def test_calibrated_gnn_campaign_on_the_card(cuda, tmp_path):
    import json
    import pickle
    from pathlib import Path

    from repro_torch.core import noc_gnn as P
    from repro_torch.core.evaluator import clear_eval_cache
    from repro_torch.explore import Campaign, CampaignSpec
    with open(Path(__file__).resolve().parents[1] / "examples" / "campaigns"
              / "quick_train_mfmobo.json") as f:
        raw = json.load(f)
    path = str(tmp_path / "params.pkl")
    with open(path, "wb") as f:
        pickle.dump(P.gnn_params_to_jax(P.init_gnn(0, device="cpu")), f)
    raw["fidelity"].update({"f0": "gnn", "calibrate_on_handover": True, "params_path": path,
                            "calibration": {"n_designs": 1, "epochs": 2}})
    spec = CampaignSpec.from_dict(raw)
    clear_eval_cache()
    full = Campaign(spec, device="cuda").run()
    assert full.finished and full.n_evals == 14 and len(full.calibration) == 1
    ckpt = str(tmp_path / "run.ckpt")
    clear_eval_cache()
    Campaign(spec, device="cuda").run(checkpoint_path=ckpt, max_steps=3)
    clear_eval_cache()
    resumed = Campaign.resume(ckpt, device="cuda").run(checkpoint_path=ckpt)
    assert [float(h).hex() for h in resumed.trace.hv] == [float(h).hex() for h in full.trace.hv]
    assert [str(d) for d in resumed.trace.designs] == [str(d) for d in full.trace.designs]


FLASH_TRAIN = (8, 256, 9, 3, 64, True, None)      # smollm-135m's training shape
# gemma3-4b's global layers at its training length: hd 256, 4096 keys per query
FLASH_TRAIN_HD256 = (1, 4096, 8, 4, 256, True, None)


@pytest.mark.gpu
@pytest.mark.parametrize("dname", list(FLASH_DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES + [FLASH_TRAIN, FLASH_TRAIN_HD256])
def test_flash_backward_matches_plain_version(cuda, case, dname):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    B, S, Hq, Hkv, hd, causal, window = case
    dtype, tol = FLASH_DTYPES[dname]
    q, k, v = (t.requires_grad_() for t in _qkv(B, S, S, Hq, Hkv, hd, dtype, cuda))
    do = _qkv(B, S, S, Hq, Hkv, hd, dtype, cuda, seed=1)[0]
    pos = torch.arange(S, device=cuda)[None].expand(B, S)
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    out = fa_ops.mha(q, k, v, pos, pos, causal=causal, window=window)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), do)
    again = torch.autograd.grad(fa_ops.mha(q, k, v, pos, pos, causal=causal, window=window),
                                (q, k, v), do)
    torch.cuda.synchronize()
    assert (flash_attention.launches - f0, flash_attention_bwd.launches - b0) == (2, 2)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    o, lse = flash_attention(q.detach(), k.detach(), v.detach(), causal=causal, window=window,
                             return_lse=True)
    assert torch.equal(o, out.detach())
    want = attention_bwd_ref(q.detach(), k.detach(), v.detach(), o, lse, do, causal=causal,
                             window=window)
    for g, w in zip(grads, want):
        assert g.dtype == dtype and g.shape == w.shape and torch.isfinite(g).all()
        w = w.float()
        assert bool(((g.float() - w).abs() <= tol * w.abs().max()).all())


SSD_TRAIN = [(8, 256, 32, 64, 128, 128), (8, 256, 64, 64, 64, 128)]   # mamba2, zamba2


def _strided(args):
    """x, Bm, Cm of `args` as views cut from one packed (B, S, H*P + 2N)
    tensor, as models/mamba2.py passes the conv output."""
    x, dt, A, Bm, Cm, D = args
    H, P, N = x.shape[2], x.shape[3], Bm.shape[-1]
    xs, Bs, Cs = torch.cat([x.flatten(-2), Bm, Cm], -1).split([H * P, N, N], -1)
    return [xs.unflatten(-1, (H, P)), dt, A, Bs, Cs, D]


@pytest.mark.gpu
@pytest.mark.parametrize("final_state", [False, True], ids=["y", "y+state"])
@pytest.mark.parametrize("dname", ["fp32", "bf16", "fp32 strided", "bf16 strided"])
@pytest.mark.parametrize("case", CASES + SSD_TRAIN)
def test_ssd_backward_on_the_card_matches_plain_version(cuda, case, dname, final_state):
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd_ref
    dtype = DTYPES[dname.split()[0]][0]
    args = [a.to(cuda) for a in _inputs(case, dtype)]
    if dname.endswith("strided"):
        args = _strided(args)
    g = torch.Generator(cuda).manual_seed(1)
    dy = torch.randn(args[0].shape, generator=g, device=cuda).to(dtype)
    dhT = torch.randn(case[0], case[2], case[3], case[4], generator=g, device=cuda)
    leaves = [a.detach().requires_grad_() for a in args]
    f0, b0 = ssd_scan.launches, ssd_scan_bwd.launches
    runs = []
    for _ in range(2):
        y, h = ops.ssd(*leaves, chunk=case[-1])
        assert type(y.grad_fn).__name__ == "SSDScanFnBackward"
        runs.append(torch.autograd.grad((y, h) if final_state else (y,), leaves,
                                        (dy, dhT) if final_state else (dy,)))
    torch.cuda.synchronize()
    assert (ssd_scan.launches - f0, ssd_scan_bwd.launches - b0) == (2, 2)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    _, _, h_prev = ssd_chunked_ref(*args, chunk=case[-1], return_states=True)
    want = ssd_chunked_bwd_ref(*args, h_prev, dy, dhT if final_state else None, chunk=case[-1])
    for got, w, a in zip(runs[0], want, args):
        assert got.dtype == a.dtype and got.shape == a.shape and torch.isfinite(got).all()
        err, tol = (got.float() - w).abs(), 3e-4 * w.abs().max()
        if got.dtype == torch.bfloat16:
            tol = tol + 1e-2 * w.abs()
        assert bool((err <= tol).all())


def _three_steps_card_and_cpu(arch):
    """Reduced `arch` trained 3 steps (remat "block") on the CPU and on the
    card from the same weights: the losses within 1e-5 and grad norms within
    1e-4 relative. Returns the card's K1 and K2 calls over the 3 steps
    (forward, backward, forward, backward); the CPU makes none."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd
    from repro_torch.train.data import MarkovLMDataset
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    cfg = reduced_config(arch)
    opt = AdamWConfig(peak_lr=3e-3, warmup_steps=2, total_steps=3)
    ds = MarkovLMDataset(vocab=cfg.vocab, seq_len=64, batch=4, seed=0)
    cpu_model = Model(cfg, CPU_TEST, seed=3)
    runs, calls = {}, {}
    for dev in ("cpu", "cuda"):
        rt = Runtime(device=dev, compute_dtype=torch.float32, remat="block")
        model = Model(cfg, rt, seed=None)
        model.load_state_dict(cpu_model.state_dict())
        model.requires_grad_(True)
        st = init_opt_state(dict(model.named_parameters()))
        step = make_train_step(cfg, rt, opt)
        counters = (flash_attention, flash_attention_bwd, ssd_scan, ssd_scan_bwd)
        before = [c.launches for c in counters]
        out = []
        for s in range(3):
            batch = {k: torch.as_tensor(v).long().to(dev) for k, v in ds.batch_at(s).items()}
            model, st, m = step(model, st, batch)
            out.append((m["loss"].item(), m["grad_norm"].item()))
        runs[dev] = out
        calls[dev] = tuple(c.launches - b for c, b in zip(counters, before))
    for (lc, gc), (lg, gg) in zip(runs["cpu"], runs["cuda"]):
        assert abs(lg - lc) <= 1e-5 * abs(lc) and abs(gg - gc) <= 1e-4 * abs(gc)
    assert calls["cpu"] == (0, 0, 0, 0)
    return calls["cuda"]


@pytest.mark.gpu
def test_training_on_the_card_matches_cpu(cuda):
    L = reduced_config("smollm-135m").num_layers
    assert _three_steps_card_and_cpu("smollm-135m") == (6 * L, 3 * L, 0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_ssm_training_on_the_card_matches_cpu(cuda, arch):
    """Both kernels' backwards in one model (zamba2): per step, K2's forward
    twice per SSM layer (remat), its backward once; K1's forward and
    backward once per application of the shared block (not recomputed)."""
    from repro_torch.models.hybrid import n_applications
    cfg = reduced_config(arch)
    apps = n_applications(cfg) if cfg.family == "hybrid" else 0
    L = cfg.num_layers
    assert _three_steps_card_and_cpu(arch) == (3 * apps, 3 * apps, 6 * L, 3 * L)


@pytest.mark.gpu
def test_train_launcher_on_the_card_resumes_bit_for_bit(cuda, tmp_path):
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint as ckpt
    args = ["--arch", "smollm-135m", "--reduced", "--steps", "8", "--batch", "2", "--seq", "32",
            "--ckpt-every", "3", "--log-every", "100"]
    out = launch_train.main(args + ["--ckpt-dir", str(tmp_path / "a"), "--fail-at", "5"])
    assert out["restarts"] == 1 and [m["step"] for m in out["metrics"]] == list(range(8))
    assert ckpt.list_checkpoints(str(tmp_path / "a"))[-1] == 8
    clean = launch_train.main(args + ["--ckpt-dir", str(tmp_path / "b")])
    assert [m["loss"] for m in out["metrics"]] == [m["loss"] for m in clean["metrics"]]


# K2's fp32 backward on Hopper (ssd_bwd_dx_kernel, ssd_bwd_dbc_kernel,
# ssd_bwd_dbc_sum_kernel): both training shapes, a ragged last chunk and
# the long case where a round-toward-zero sum once cost dA its rule
SSD_HOPPER = SSD_TRAIN + [(1, 200, 4, 64, 64, 128), (2, 300, 4, 64, 128, 128)]


def _kernels_of(call, want):
    """The kernels the profiler sees `call` launch (bf16 spelled as the
    rule's names spell it), profiled until it sees all of `want` (at most
    three times)."""
    names = set()
    for _ in range(3):
        names = {n.replace("__nv_bfloat16", "bf16") for n in _profiled_kernels(call, runs=2)}
        if names >= want:
            break
    return names


def _ssd_bwd_call(case, args, final_state, cuda):
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd
    g = torch.Generator(cuda).manual_seed(1)
    dy = torch.randn(args[0].shape, generator=g, device=cuda).to(args[0].dtype)
    dhT = torch.randn(case[0], case[2], case[3], case[4], generator=g, device=cuda)
    dhT = dhT if final_state else None
    _, _, h_prev = ssd_scan(*args, chunk=case[-1], return_states=True)
    return (lambda: ssd_scan_bwd(*args, h_prev, dy, dhT, chunk=case[-1])), h_prev, dy, dhT


@pytest.mark.gpu
@pytest.mark.parametrize("final_state", [False, True], ids=["y", "y+state"])
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("case", SSD_HOPPER)
def test_ssd_backward_hopper_route(cuda, case, layout, final_state):
    """The route the rule names (`kernel.backward_kernels`, the kernels the
    profiler sees; ssd_scan.cu's own rule agrees), every gradient within
    3e-4 of the largest reference gradient (`ssd_chunked_bwd_ref` on the
    forward's states), and two runs bit for bit."""
    from repro_torch.kernels.ssd_scan import kernel as K
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd_ref
    args = [a.to(cuda) for a in _inputs(case, torch.float32)]
    if layout == "strided":
        args = _strided(args)
    assert K.tma_aligned(args[0]) and K.bwd_on_hopper(case, torch.float32)
    assert K.bwd_on_hopper_lib(args[0], case[4], case[-1])
    call, h_prev, dy, dhT = _ssd_bwd_call(case, args, final_state, cuda)
    got, again = call(), call()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ssd_chunked_bwd_ref(*args, h_prev, dy, dhT, chunk=case[-1])
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert torch.isfinite(g).all(), name
        assert (g - w).abs().max().item() <= 3e-4 * w.abs().max().item(), name
    want = set(K.backward_kernels(case, torch.float32))
    assert _kernels_of(call, want) == want


@pytest.mark.gpu
@pytest.mark.parametrize("dname, case", [
    ("fp32", (1, 256, 4, 64, 32, 128)),       # N = 32: outside the rule
    ("bf16", (4, 256, 16, 64, 128, 128)),     # the mesh's shard, bf16
    ("bf16", (8, 256, 32, 64, 128, 128)),     # mamba2's training shape, bf16
], ids=["fp32-N32", "bf16-mesh", "bf16-mamba2"])
def test_ssd_backward_old_route_by_the_rule(cuda, dname, case):
    """Shapes outside the rule, and bf16 at every shape, keep the six
    mma.sync kernels, by the rule's names."""
    from repro_torch.kernels.ssd_scan import kernel as K
    dtype = DTYPES[dname][0]
    args = [a.to(cuda) for a in _inputs(case, dtype)]
    assert not K.bwd_on_hopper_lib(args[0], case[4], case[-1])
    call, *_ = _ssd_bwd_call(case, args, False, cuda)
    names = set(K.backward_kernels(case, dtype))
    assert "ssd_bwd_chunk_tf32_kernel" in " ".join(names)
    assert _kernels_of(call, names) == names


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["pointer", "row stride"])
def test_ssd_backward_misaligned_view_takes_the_old_route(cuda, where):
    """An x whose pointer or row stride TMA cannot take goes to the
    mma.sync kernels by the rule (the same answer in Python and in
    ssd_scan.cu), with the right gradients: nothing crashes."""
    from repro_torch.kernels.ssd_scan import kernel as K
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd_ref
    case = SSD_TRAIN[0]
    B, S, H, P, N, chunk = case
    args = [a.to(cuda) for a in _inputs(case, torch.float32)]
    if where == "pointer":
        buf = torch.zeros(B * S * H * P + 1, device=cuda)
        x = buf[1:].view(B, S, H, P)
    else:                                       # rows of H P + 1 floats
        x = torch.zeros(B, S, H * P + 1, device=cuda)[..., :H * P].unflatten(-1, (H, P))
    x.copy_(args[0])
    args[0] = x
    assert not K.tma_aligned(x) and not K.bwd_on_hopper(case, torch.float32, K.tma_aligned(x))
    assert not K.bwd_on_hopper_lib(x, N, chunk)
    call, h_prev, dy, dhT = _ssd_bwd_call(case, args, False, cuda)
    got = call()
    want = ssd_chunked_bwd_ref(*args, h_prev, dy, None, chunk=chunk)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 3e-4 * w.abs().max().item()
    want = set(K.backward_kernels(case, torch.float32, aligned=False))
    assert _kernels_of(call, want) == want
