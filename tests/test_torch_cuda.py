"""Tests of the port that need an NVIDIA card (marker `gpu`; each skips with
a reason where torch finds no CUDA device). They import no JAX, so they run
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

The CUDA SSD-scan kernel is held against its plain version on the card at
the JAX kernel tests' cases plus a short (Q = S < 128) and a ragged serving
shape, with those tests' tolerances (fp32 3e-4, bf16 4e-2, abs and rel).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.runtime import CPU_TEST, Runtime  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

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
