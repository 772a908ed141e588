"""Training launcher of the port: `repro.launch.train`'s flags and loop, with
the fault-tolerant supervisor (`dist/fault.py`), on one device or across a
(data, model) device mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 300 --batch 8 --seq 256 --ckpt-dir ckpt       # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
        --steps 300 --ckpt-dir ckpt_mamba2                    # SSM, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \
        --steps 300 --ckpt-dir ckpt_zamba2                    # hybrid, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 8 \
        --device cpu --ckpt-dir ckpt                          # tiny, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 8 \
        --data 2 --model 2 --device cpu --ckpt-dir ckpt       # 2x2 mesh, 4 gloo processes

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

`--data D --model M` with D*M > 1 trains across a ("data", "model")
`DeviceMesh` of D*M ranks (`launch/mesh.py`), one process each
(`torch.multiprocessing`, spawn; rank i on `cuda:{i % device_count}`, or on
the CPU with `--device cpu`), or one thread each with `--backend threaded`
(torch's in-process group: ranks that share one card). The backend is NCCL
on the card and gloo on the CPU unless `--backend` says otherwise; NCCL
with more ranks than cards is refused, and so is gloo on the card (its
functional all-gather on CUDA tensors crashes torch 2.11's gloo ranks). As in `repro`'s launcher the mesh
computes in bf16 and sets `mesh_axes` (and, as `repro`'s dry-run runtime,
the MoE dispatch buffer's capacity over the data axes); parameters, AdamW
state and batches
are DTensors laid out by `repro`'s rules (`param_specs`, `opt_state_specs`,
`batch_specs`), every rank builds the same global `MarkovLMDataset` batch
and keeps its shard, K1 and K2 run on each rank's local shard, and rank 0
logs and writes the checkpoints (every leaf gathered). Then main returns
rank 0's metrics, restarts and slow steps (no "params": they live in the
ranks; with `--backend threaded`, rank 0's whole dict). `--layers N` cuts
the arch to its first N layers at full width. A multi-host launch (a
`WORLD_SIZE` above 1 from an outside launcher) is refused, as `repro`
refuses more than one process.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import tempfile
import time

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import to_device
from repro_torch.dist import sharding as sh
from repro_torch.dist.fault import TrainSupervisor
from repro_torch.dist.oracle import param_shapes
from repro_torch.launch.mesh import make_mesh_shape, run_threaded
from repro_torch.models.model import Model
from repro_torch.models.runtime import Runtime
from repro_torch.train.data import MarkovLMDataset
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import make_train_step


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CI/demo)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch to its first N layers (full width; a smoke run "
                         "of an arch too deep for the card)")
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
                    help="mesh data axis (1 on one device)")
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--backend", choices=("nccl", "gloo", "threaded"), default=None,
                    help="process group of a mesh: nccl (default on the card, one card "
                         "per rank), gloo (default on the CPU) or threaded (one "
                         "process, a thread per rank)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", default="",
                    help="comma-separated step indices at which to inject a "
                         "node failure (fault-tolerance demo/smoke test)")
    return ap


def main(argv=None):
    ap = _parser()
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
    world = args.data * args.model
    if world == 1:
        return train_rank(args)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise SystemExit("multi-host launch is not supported yet: run one launcher, "
                         "which starts a process per rank of the mesh on this host")
    on_card = torch.device(args.device).type == "cuda"
    backend = args.backend or ("nccl" if on_card else "gloo")
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if world > cards:
            raise SystemExit(f"--backend nccl needs a card per rank: the mesh has "
                             f"{world} ranks and this host {cards} card(s); NCCL refuses "
                             "two ranks on one device. Use --backend threaded (threads) "
                             "to share a card")
    if backend == "gloo" and on_card:
        raise SystemExit("--backend gloo is refused on the card: gloo processes sharing "
                         "cuda:0 die with SIGSEGV in torch's functional all-gather "
                         "(torch.distributed._functional_collectives.all_gather_tensor, "
                         "then wait_tensor, the call DTensor makes; reproduced with no "
                         "code of this package by `python3 scripts/mesh_backend_probe.py "
                         "--functional` under torch 2.11.0+cu128). Use --backend threaded "
                         "(threads sharing a card) or nccl (a card per rank)")
    if backend == "threaded":
        threads = torch.get_num_threads()
        if not on_card:     # the host's cores shared out among the ranks
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        try:
            outs = run_threaded(world, lambda rank: _mesh_rank(args, rank, world, backend, None))
        finally:
            torch.set_num_threads(threads)
        return outs[0]
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    port = _free_port()
    mp.start_processes(_spawn_entry, args=(args, world, backend, port, queue),
                       nprocs=world, join=True, start_method="spawn")
    return queue.get()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_entry(rank, args, world, backend, port, queue):
    out = _mesh_rank(args, rank, world, backend, port)
    if rank == 0:
        queue.put({k: out[k] for k in ("metrics", "restarts", "slow_steps")})


def _mesh_rank(args, rank: int, world: int, backend: str, port):
    """One rank of a mesh run: its process group (unless threaded), its
    card, the mesh, then `train_rank`."""
    import torch.distributed as dist
    on_card = torch.device(args.device).type == "cuda"
    if on_card:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if backend != "threaded":
        if not on_card:     # the host's cores shared out, not each rank taking all
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
    try:
        mesh = make_mesh_shape((args.data, args.model), ("data", "model"),
                               "cuda" if on_card else "cpu")
        return train_rank(args, mesh)
    finally:
        if backend != "threaded":
            dist.destroy_process_group()


def mesh_runtime(cfg, args, mesh) -> Runtime:
    """The launcher's Runtime: fp32 on one device; on a mesh bf16 with
    `mesh_axes` set (`repro`'s launcher) and the MoE buffer's capacity over
    the data axes (`repro`'s dry-run runtime)."""
    rt = Runtime(device=args.device, compute_dtype=torch.float32,
                 remat="none" if args.reduced else "block")
    if mesh is None:
        return rt
    moe_spec = sh.PartitionSpec(None, sh.dp_axes(mesh), None) if cfg.family == "moe" else None
    return dataclasses.replace(rt, compute_dtype=torch.bfloat16, mesh=mesh,
                               mesh_axes=sh.mesh_axes(mesh), moe_buf_spec=moe_spec)


def train_rank(args, mesh=None, rt: Runtime = None):
    """The training loop of one rank (all of it on one device). `rt`
    overrides the launcher's Runtime (a one-device bf16 reference run)."""
    try:
        fail_at = {int(s) for s in args.fail_at.split(",") if s.strip()}
    except ValueError:
        raise SystemExit(f"--fail-at expects comma-separated step indices, got {args.fail_at!r}")
    # torch's float32 products in IEEE fp32 on the card, as in repro (no TF32);
    # K1's and K2's fp32 kernels use split TF32 (three TF32 products per fp32 one)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    rt = rt or mesh_runtime(cfg, args, mesh)
    dev = rt.torch_device()
    log = mesh is None or mesh.get_rank() == 0
    opt = AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps)
    ds = MarkovLMDataset(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                         seed=0)
    where = args.device if mesh is None else f"a {args.data}x{args.model} mesh on {args.device}"
    if log:
        print(f"[train] {cfg.name} on {where}: {cfg.param_count()/1e6:.1f}M params, "
              f"{args.steps} steps, batch {args.batch}x{args.seq}, "
              f"entropy floor ~{ds.conditional_entropy():.3f} nats", flush=True)

    shardings, b_specs = None, None
    if mesh is not None:
        p_spec = sh.param_specs(mesh, param_shapes(cfg))
        shardings = (sh.to_shardings(mesh, p_spec),
                     sh.to_shardings(mesh, sh.opt_state_specs(mesh, None, p_spec)))
        b_specs = sh.batch_specs(mesh, ds.batch_at(0))

    def init_fn():
        model = Model(cfg, rt, seed=0).requires_grad_(True)
        return model, init_opt_state(dict(model.named_parameters()))

    step_fn = make_train_step(cfg, rt, opt, microbatches=args.microbatches)
    t_start = time.time()
    last = {"t": t_start, "step": 0, "seen": 0}

    def batches(step):
        b = {k: to_device(v, torch.int64, dev) for k, v in ds.batch_at(step).items()}
        return b if mesh is None else sh.distribute_tree(mesh, b, b_specs)

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
        if s % args.log_every == 0 and log:
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
            if log:
                print(f"  [fault] injected failure before step {step}; "
                      "rolling back to latest checkpoint (fresh init if none)",
                      flush=True)
            return True
        return False

    tag = cfg.name if args.layers is None else f"{cfg.name}-{args.layers}-layers"
    sup = TrainSupervisor(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                          run_tag=tag, device=dev, shardings=shardings)
    out = sup.run(init_fn, step_logged, batches, total_steps=args.steps,
                  failure_injector=injector if fail_at else None)
    final = (f"final loss {out['metrics'][-1]['loss']:.4f}" if out["metrics"]
             else "already complete (resumed at final checkpoint)")
    if log:
        print(f"[train] done in {time.time()-t_start:.0f}s; {final}; "
              f"restarts {out['restarts']}; slow steps {out['slow_steps']}", flush=True)
    return out


if __name__ == "__main__":
    main()
