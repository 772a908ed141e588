"""Training launcher of the port: `repro.launch.train`'s flags and loop on
one device, with the fault-tolerant supervisor (`dist/fault.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 300 --batch 8 --seq 256 --ckpt-dir ckpt       # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
        --steps 300 --ckpt-dir ckpt_mamba2                    # SSM, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \
        --steps 300 --ckpt-dir ckpt_zamba2                    # hybrid, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 8 \
        --device cpu --ckpt-dir ckpt                          # tiny, on the CPU

The dense, MoE, SSM and hybrid families train (smollm-135m, qwen2-0.5b,
qwen1.5-32b, gemma3-4b, mixtral-8x7b, grok-1-314b, mamba2-370m,
zamba2-1.2b): on the card the attention layers run K1's forward and
backward kernels (`FlashAttentionFn`) and the SSM layers K2's
(`SSDScanFn`); on the CPU their plain versions. whisper-small (encdec) and
paligemma-3b (vlm) need frames or patches beside the tokens, which
`MarkovLMDataset` does not give, so `--arch` with either raises, as in
`repro`'s launcher. Random weights from seed 0, fp32 compute (`repro`'s
choice on one device), `remat` "block" at full width (each decoder or SSM
layer checkpointed under `repro`'s policy: its weight GEMMs keep their
outputs, the rest is recomputed in the backward; the hybrid's shared block
is not checkpointed) and "none" with `--reduced`, AdamW with `repro`'s
schedule, `MarkovLMDataset` batches (seed 0). Checkpoints are `repro`'s
format (`train/checkpoint.py`), so `repro` can restore them and
`launch/serve.py --ckpt-dir` serves them. `--fail-at` injects node failures
before the given steps: the supervisor rolls back to the newest checkpoint
and the metric log stays contiguous. torch's float32 matmuls run in IEEE
fp32 (TF32 off); K1's and K2's fp32 kernels take each product as three
TF32 products of split operands (split TF32, as close as IEEE fp32).
Returns the supervisor's dict ("params" is the model).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import to_device
from repro_torch.dist.fault import TrainSupervisor
from repro_torch.models.model import Model
from repro_torch.models.runtime import Runtime
from repro_torch.train.data import MarkovLMDataset
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CI/demo)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints; 0 writes none, not even "
                         "the final one (a failure then restarts from step 0)")
    ap.add_argument("--data", type=int, default=1,
                    help="mesh data axis (1: one device)")
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", default="",
                    help="comma-separated step indices at which to inject a "
                         "node failure (fault-tolerance demo/smoke test)")
    args = ap.parse_args(argv)
    try:
        fail_at = {int(s) for s in args.fail_at.split(",") if s.strip()}
    except ValueError:
        ap.error(f"--fail-at expects comma-separated step indices, "
                 f"got {args.fail_at!r}")
    bad = {s for s in fail_at if not 0 <= s < args.steps}
    if bad:
        ap.error(f"--fail-at steps {sorted(bad)} outside [0, {args.steps}): "
                 "the injected failure would never fire")
    if args.data * args.model > 1:
        raise SystemExit("--data/--model above 1 need the device mesh, which "
                         "is not ported yet (ROADMAP item 15): train on one "
                         "device")

    # torch's float32 products in IEEE fp32 on the card, as in repro (no TF32);
    # K1's and K2's fp32 kernels use split TF32 (three TF32 products per fp32 one)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    rt = Runtime(device=args.device, compute_dtype=torch.float32,
                 remat="none" if args.reduced else "block")
    dev = rt.torch_device()
    opt = AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps)
    ds = MarkovLMDataset(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                         seed=0)
    print(f"[train] {cfg.name} on {args.device}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.batch}x{args.seq}, "
          f"entropy floor ~{ds.conditional_entropy():.3f} nats")

    def init_fn():
        model = Model(cfg, rt, seed=0).requires_grad_(True)
        return model, init_opt_state(dict(model.named_parameters()))

    step_fn = make_train_step(cfg, rt, opt, microbatches=args.microbatches)
    t_start = time.time()
    last = {"t": t_start, "step": 0, "seen": 0}

    def batches(step):
        return {k: to_device(v, torch.int64, dev) for k, v in ds.batch_at(step).items()}

    def step_logged(model, opt_state, batch):
        t_before = time.time()
        model, opt_state, m = step_fn(model, opt_state, batch)
        s = int(opt_state["step"])
        if last["seen"] == 0:       # first step this process: the window
            # starts here, not at process start (restore time is not tok/s)
            last["t"], last["step"] = t_before, s - 1
        elif s <= last["seen"]:     # supervisor rolled back and re-ran: the
            # window restarts after this step
            last["t"], last["step"] = time.time(), s
        last["seen"] = s
        if s % args.log_every == 0:
            dt = time.time() - last["t"]
            tps = (s - last["step"]) * args.batch * args.seq / max(dt, 1e-9)
            print(f"  step {s:5d} loss {float(m['loss']):.4f} "
                  f"lr {float(m['lr']):.2e} gnorm "
                  f"{float(m['grad_norm']):.2f} tok/s {tps:.0f}", flush=True)
            last["t"], last["step"] = time.time(), s
        return model, opt_state, m

    def injector(step):
        if step in fail_at:
            fail_at.discard(step)
            print(f"  [fault] injected failure before step {step}; "
                  "rolling back to latest checkpoint (fresh init if none)",
                  flush=True)
            return True
        return False

    sup = TrainSupervisor(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                          run_tag=cfg.name, device=dev)
    out = sup.run(init_fn, step_logged, batches, total_steps=args.steps,
                  failure_injector=injector if fail_at else None)
    final = (f"final loss {out['metrics'][-1]['loss']:.4f}" if out["metrics"]
             else "already complete (resumed at final checkpoint)")
    print(f"[train] done in {time.time()-t_start:.0f}s; {final}; "
          f"restarts {out['restarts']}; slow steps {out['slow_steps']}")
    return out


if __name__ == "__main__":
    main()
