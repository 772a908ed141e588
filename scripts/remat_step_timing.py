#!/usr/bin/env python3
"""One full-width fp32 training step (8 x 256 tokens) per remat mode, on one
NVIDIA card: "none", "block" with `repro`'s policy (selective
checkpointing that keeps the weight GEMMs' outputs, the launcher's
setting) and "block" recomputing every op (plain non-reentrant
checkpointing, the port's remat before it took `repro`'s policy).

    python3 scripts/remat_step_timing.py smollm-135m mamba2-370m zamba2-1.2b

For each arch and mode: two warm-up steps, then the host time of five
steps (each ending in a synchronise: median and range), the device time
of one more under torch.profiler (all kernels, and the GEMMs among them),
its launches, and the peak device memory.
"""
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("remat_step_timing: torch finds no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import runtime
    from repro_torch.models.model import Model
    from repro_torch.models.runtime import Runtime
    from repro_torch.train.data import MarkovLMDataset
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    with_policy = runtime.checkpoint

    def without_policy(fn, *args, context_fn=None, **kwargs):
        return with_policy(fn, *args, **kwargs)
    for arch in sys.argv[1:] or ["smollm-135m"]:
        cfg = get_config(arch)
        ds = MarkovLMDataset(vocab=cfg.vocab, seq_len=256, batch=8, seed=0)
        batch = {k: torch.as_tensor(v).long().cuda() for k, v in ds.batch_at(0).items()}
        for mode in ("none", "block", "block, every op recomputed"):
            runtime.checkpoint = without_policy if "every" in mode else with_policy
            rt = Runtime(device="cuda", compute_dtype=torch.float32, remat=mode.split(",")[0])
            model = Model(cfg, rt, seed=0).requires_grad_(True)
            st = init_opt_state(dict(model.named_parameters()))
            step = make_train_step(cfg, rt, AdamWConfig(peak_lr=3e-3, warmup_steps=5,
                                                        total_steps=20))
            for _ in range(2):
                step(model, st, batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                step(model, st, batch)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 2**30
            _, by_name, counts = c.device_breakdown(torch, lambda: step(model, st, batch), reps=1)
            gemm = sum(v for k, v in by_name.items() if "gemm" in k.lower())
            print(f"  {arch}, remat {mode}: host median {statistics.median(walls):.2f} ms "
                  f"({min(walls):.2f}-{max(walls):.2f}), device busy "
                  f"{sum(by_name.values()):.2f} ms (GEMMs {gemm:.2f} ms), "
                  f"{sum(counts.values())} launches, peak {peak:.2f} GiB", flush=True)
            del model, st
            torch.cuda.empty_cache()
        runtime.checkpoint = with_policy
    return 0


if __name__ == "__main__":
    sys.exit(main())
