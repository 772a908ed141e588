#!/usr/bin/env python3
"""Phase 23's profiled mesh step (`chip_smoke.mesh_step_figures`: four
threaded ranks sharing one NVIDIA card, one step under torch.profiler
started and stopped from the main thread) N times in one process, at one of
`chip_smoke.MESH_PATHS`' runs.

    python3 scripts/mesh_figures_repeat.py ARCH N [--smoke FILE]

The kernels and the port come from this script's checkout; `--smoke` takes
`mesh_step_figures` from another `chip_smoke.py` (say, the parent's) to
compare two versions of the measuring code on the same card. Each repeat
prints one line; a crash of the process prints every thread's stack to
stderr (faulthandler) and ends the run early, so the number of "ok" lines
counts the repeats that got through.
"""
import faulthandler
import gc
import importlib.util
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_figures_repeat: torch finds no CUDA device", file=sys.stderr)
        return 1
    faulthandler.enable()
    arch, n = argv[0], int(argv[1])
    path = Path(argv[argv.index("--smoke") + 1]) if "--smoke" in argv else ROOT / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)
    import chip_smoke
    from repro_torch.kernels import _build
    _build.build_all()
    _, layers, B, S, flags = next(p for p in chip_smoke.MESH_PATHS if p[0] == arch)
    with tempfile.TemporaryDirectory() as tmp:
        argv_run = chip_smoke.mesh_argv(arch, layers, B, S, os.path.join(tmp, "ck"),
                                        "--ckpt-every", "0", *flags)
        for i in range(n):
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            fig = c.mesh_step_figures(torch, argv_run)
            p = fig["profiled_step"]
            print(f"ok {i + 1}/{n} ({path}): {time.perf_counter() - t0:.1f} s, device busy "
                  f"{p['device_busy_ms']:.1f} ms, {p['launches']} launches", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
