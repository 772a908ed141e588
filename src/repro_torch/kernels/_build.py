"""Build the port's CUDA sources at first use and load them with ctypes.

Each `csrc/*.cu` under `repro_torch/kernels/` is compiled by `nvcc` for
`sm_90a` into a shared library with a plain C interface (no PyTorch headers,
so a build takes seconds and needs no `ninja`). Libraries go to
`repro_torch/kernels/_build/` (listed in .gitignore), named by a hash of
every file in the source's `csrc/` directory (the headers it includes too),
of every file in `kernels/common/` (the headers all sources share) and of
the flags, so an edited source or header is rebuilt and an unchanged one
is reused. `build_all()` starts one `nvcc` per source, all at once.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
COMMON_DIR = KERNELS_DIR / "common"      # headers every source may include
# --split-compile=0: compile one source's kernels on all the CPUs (the flash
# attention source instantiates 32 kernels, one per head dim and dtype)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile=0", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def sources() -> List[Path]:
    return sorted(KERNELS_DIR.glob("*/csrc/*.cu"))


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def _lib_path(src: Path, common: Path = COMMON_DIR) -> Path:
    h = hashlib.sha1(src.name.encode())
    for d in (src.parent, common):
        for f in sorted(p for p in d.iterdir() if p.is_file()):
            h.update(f.name.encode() + b"\0" + f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def _start(src: Path):
    """Start nvcc for `src` unless its library exists; returns
    (process or None, temp output, final path)."""
    out = _lib_path(src)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(src: Path, proc, tmp, out) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
    os.replace(tmp, out)            # atomic: a concurrent build sees all or nothing
    return log


def build_all() -> Dict[str, str]:
    """Compile every source that has no library yet, in parallel. Returns
    {source name: nvcc's output} (ptxas register/shared-memory report)."""
    started = [(src, *_start(src)) for src in sources()]
    return {src.name: _finish(src, proc, tmp, out) for src, proc, tmp, out in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from `<name>.cu`, building it if needed."""
    if name not in _LOADED:
        src = next((s for s in sources() if s.stem == name), None)
        if src is None:
            raise FileNotFoundError(f"no CUDA source {name}.cu under {KERNELS_DIR}")
        _finish(src, *_start(src))
        _LOADED[name] = ctypes.CDLL(str(_lib_path(src)))
    return _LOADED[name]
