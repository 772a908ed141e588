"""Serving launcher of the port: builds a random-init model from a seed,
spins up the continuous-batching engine, runs a batch of synthetic requests
and reports throughput and latency.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --requests 8 --slots 4 --max-new 32           # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --reduced --device cpu                        # tiny, on the CPU

It serves the decoder-only archs: mamba2-370m, zamba2-1.2b, smollm-135m,
qwen2-0.5b, qwen1.5-32b, gemma3-4b, mixtral-8x7b, grok-1-314b (at full
width the last three need more than one card's memory in fp32: see PERF.md
for cut depths). On the card the runtime computes in bf16 with fp32
parameters; on the CPU in fp32. `--ckpt-dir` serves the newest valid
checkpoint there (`repro`'s format: `train/checkpoint.py`, written by
either package's trainer) instead of random weights. As in
`repro`, the launcher refuses encdec and vlm (whisper-small, paligemma-3b):
`serve.serve_step.make_prefill_step` / `make_decode_step` serve them.

`--max-len` is the KV cache's slots per sequence. The engine decodes with
per-slot positions, which never take the windowed decode branch; a decode
step with a scalar position does (`make_decode_step`), when the cache holds
at least 4x the window: gemma3-4b (window 1024) needs `--max-len` >= 4096
for that.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.models.runtime import Runtime
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import checkpoint as ckpt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore params from the latest checkpoint here")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128,
                    help="KV cache slots per sequence (gemma3-4b's windowed "
                         "decode branch needs >= 4096)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)

    # float32 products in full fp32 on the card, as in repro (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if get_config(args.arch).family in ("encdec", "vlm"):
        raise SystemExit("engine serves decoder-only families; use "
                         "serve_step.make_prefill_step/make_decode_step "
                         "directly for encdec/vlm")
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    on_cpu = torch.device(args.device).type == "cpu"
    rt = Runtime(device=args.device,
                 compute_dtype=torch.float32 if on_cpu else torch.bfloat16)
    if args.ckpt_dir:
        restored = ckpt.restore_latest(args.ckpt_dir)
        if restored is None:
            raise SystemExit(f"no checkpoint under {args.ckpt_dir}")
        params_np, _, meta = restored
        model = Model(cfg, rt, seed=None)
        model.load_state_dict(params_from_jax(params_np, cfg))
        print(f"[serve] {cfg.name} on {args.device}: restored step {meta['step']} "
              f"from {args.ckpt_dir}")
    else:
        model = Model(cfg, rt, seed=0)
        print(f"[serve] {cfg.name} on {args.device}: random-init params (seed 0; "
              "pass --ckpt-dir for trained)")

    engine = ServeEngine(cfg, rt, model, slots=args.slots, max_len=args.max_len)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, size=4 + (i % 5) * 3),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    outs = engine.run(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in outs.values())
    print(f"[serve] {len(reqs)} requests -> {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, {args.slots} slots)")
    print(f"[serve] prefill {1e3 * np.mean(engine.prefill_s):.2f} ms/request, "
          f"decode {1e3 * np.mean(engine.decode_s):.2f} ms/step")
    for rid in sorted(outs)[:4]:
        print(f"  req {rid}: {outs[rid][:10]}{'...' if len(outs[rid]) > 10 else ''}")
    return outs


if __name__ == "__main__":
    main()
