#!/usr/bin/env python3
"""Phase 20 of `chip_smoke.py` (SSM and hybrid training: K2's backward held
and timed, mamba2-370m through the launcher, zamba2-1.2b, card against CPU,
one step of each by kernel) for each tree given, in that order, each in a
fresh process on one NVIDIA card. Compares two checkouts on one host:

    python3 scripts/phase20_timing.py .archive/parent . . .archive/parent

Each process imports `chip_smoke` and `repro_torch` from its own tree,
builds that tree's kernels (`_build.build_all`, outside the time), then
runs `chip_smoke.ssm_train_path`. A tree's whole output goes to
chiprun_out/phase20_<i>.log; the summary prints each run's seconds and its
step lines (phase 20 (f): host ms, tokens/s, device busy, idle share).
"""
import subprocess
import sys
import time
from pathlib import Path

OUT = Path("chiprun_out")


def child(root: Path) -> int:
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    if Path(chip_smoke.__file__).resolve().parent != root:
        raise RuntimeError(f"chip_smoke came from {chip_smoke.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    chip_smoke.ssm_train_path(torch, np)
    print(f"phase 20: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        return child(Path(sys.argv[2]).resolve())
    OUT.mkdir(exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    rc = 0
    for i, tree in enumerate(sys.argv[1:]):
        root = Path(tree).resolve()
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", str(root)],
                             cwd=root, capture_output=True, text=True, timeout=900)
        (OUT / f"phase20_{i}.log").write_text(run.stdout + run.stderr)
        rc = rc or run.returncode
        lines = run.stdout.splitlines()
        print(f"run {i} ({tree}): exit {run.returncode}")
        for line in lines:
            if (line.startswith(("built in", "phase 20:")) or " host " in line
                    or "K2 backward (" in line):
                print("  " + line.strip())
        if run.returncode:
            print("\n".join(run.stderr.splitlines()[-15:]))
    return rc


if __name__ == "__main__":
    sys.exit(main())
