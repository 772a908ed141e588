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
version; a misaligned bf16 K1 input raises before any launch.

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
