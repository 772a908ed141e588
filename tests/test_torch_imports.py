"""The port stands alone: no module of `repro_torch` (nor chip_smoke.py)
imports `jax` or the JAX package `repro`, checked by an AST scan and by
importing every module in a fresh interpreter. Its entry points default to
the card and raise where there is none."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.configs.base import _ARCH_MODULES, get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.runtime import CPU_TEST, Runtime  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.serve_step import make_prefill_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


# modules each slice added; the scans below must reach every one of them
SLICE_MODULES = (
    "models/transformer.py", "models/moe.py", "configs/smollm_135m.py",
    "configs/qwen2_05b.py", "configs/qwen15_32b.py", "configs/gemma3_4b.py",
    "configs/mixtral_8x7b.py", "configs/grok1_314b.py", "models/encdec.py",
    "models/mamba2.py", "kernels/flash_attention/kernel.py", "kernels/ssd_scan/kernel.py",
    "models/hybrid.py", "core/traces.py", "configs/zamba2_12b.py", "configs/paligemma_3b.py",
    "device.py", "configs/shapes.py", "core/gp.py", "core/ehvi.py", "core/mfmobo.py",
    "core/eval_compiled.py", "core/evaluator.py", "core/fidelity.py", "core/components.py",
    "core/design_space.py", "core/workload.py", "core/yield_model.py", "core/pareto.py",
    "core/validator.py", "core/compiler.py", "core/tile_eval.py", "core/chunk_eval.py",
    "core/noc_analytical.py", "core/noc_sim.py", "core/evalcache.py",
    "explore/__main__.py", "explore/campaign.py", "explore/objectives.py", "explore/runner.py",
    "core/serving.py", "core/heterogeneity.py", "core/noc_gnn.py", "core/calibration.py",
)


def test_no_module_of_the_port_imports_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    assert {PKG / m for m in SLICE_MODULES} <= set(files)
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imported(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_importing_the_whole_port_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "want = {'repro_torch.' + m[:-3].replace('/', '.') for m in %r}\n"
        "print(len(mods), bad, sorted(want - set(mods)))\n"
        "sys.exit(1 if bad or want - set(mods) else 0)\n" % (SLICE_MODULES,))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_runtime_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    assert Runtime().device == "cuda" and Runtime().compute_dtype == torch.bfloat16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("mamba2-370m")
    with pytest.raises(RuntimeError, match="no CUDA"):
        Model(cfg, Runtime())
    cpu_model = Model(cfg, CPU_TEST)
    with pytest.raises(RuntimeError, match="no CUDA"):
        ServeEngine(cfg, Runtime(), cpu_model)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA"):
        serve.main(["--reduced"])
    out = serve.main(["--reduced", "--device", "cpu", "--requests", "2", "--max-new", "3"])
    assert sorted(out) == [0, 1] and all(len(v) == 3 for v in out.values())
    assert all(0 <= t < cfg.vocab for v in out.values() for t in np.ravel(v))


@pytest.mark.parametrize("arch", sorted(_ARCH_MODULES))
def test_every_jax_arch_has_a_config(arch):
    """Every arch id of the JAX package has a config in the port, of the same
    family and widths; an unknown id raises."""
    from repro.configs import base as jax_base
    assert sorted(_ARCH_MODULES) == sorted(jax_base.ARCH_IDS)
    ours, theirs = get_config(arch), jax_base.get_config(arch)
    for field in ("family", "num_layers", "d_model", "vocab"):
        assert getattr(ours, field) == getattr(theirs, field), field
    with pytest.raises(KeyError, match="unknown arch"):
        get_config(arch + "-x")


@pytest.mark.parametrize("arch", ["gemma3-4b", "mixtral-8x7b", "zamba2-1.2b"])
def test_decoder_archs_need_a_card_unless_asked_for_the_cpu(monkeypatch, arch):
    assert get_config(arch).family in ("dense", "moe", "hybrid")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config(arch)
    with pytest.raises(RuntimeError, match="no CUDA"):
        Model(cfg, Runtime())
    model = Model(cfg, CPU_TEST)
    with pytest.raises(RuntimeError, match="no CUDA"):
        ServeEngine(cfg, Runtime(), model)
    logits, _ = make_prefill_step(cfg, CPU_TEST, 16)(model, {"tokens": torch.zeros((1, 3),
                                                                                 dtype=torch.long)})
    assert logits.shape == (1, cfg.vocab)


def test_whisper_is_ported_and_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    assert get_config("whisper-small").family == "encdec"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("whisper-small")
    with pytest.raises(RuntimeError, match="no CUDA"):
        Model(cfg, Runtime())
    model = Model(cfg, CPU_TEST)
    batch = {"tokens": torch.zeros((1, 3), dtype=torch.long),
             "frames": torch.zeros((1, cfg.encoder_len, cfg.d_model))}
    with pytest.raises(RuntimeError, match="no CUDA"):
        make_prefill_step(cfg, Runtime(), 16)(model, batch)
    logits, _ = make_prefill_step(cfg, CPU_TEST, 16)(model, batch)
    assert logits.shape == (1, cfg.vocab)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServeEngine(cfg, CPU_TEST, model)


def test_kernel_build_finds_every_source_and_needs_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    assert [p.name for p in _build.sources()] == ["flash_attention.cu", "ssd_scan.cu"]
    lib = _build._lib_path(_build.sources()[0])
    assert lib.parent == PKG / "kernels" / "_build" and lib.suffix == ".so"
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
