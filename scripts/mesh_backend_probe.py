"""Which process group carries DTensor's collectives for several ranks that
share one card (NCCL refuses two ranks on one device).

For each candidate, 4 ranks on cuda:0 run the four collectives DTensor
issues (`all_gather_into_tensor`, `reduce_scatter_tensor`, `all_reduce`,
`all_to_all_single`) on CUDA tensors and check the values:
  * gloo: 4 spawned processes;
  * threaded: 4 threads of this process on torch's threaded group
    (`launch.mesh.run_threaded`).
Then the launcher trains reduced smollm-135m, mamba2-370m and mixtral-8x7b
for 3 steps on a 2x2 mesh over each candidate that carried all four, and
counts K1's and K2's launches. Prints one JSON object.

`--functional` runs instead the calls DTensor itself makes, on four gloo
processes that share cuda:0, each variant in a subprocess of its own so
that a rank killed by a signal is reported and the next variant still
runs: the functional collectives of
`torch.distributed._functional_collectives` (`all_gather_tensor`,
`reduce_scatter_tensor`, `all_reduce`, each then `wait_tensor`) over the
world group and over one dim of a 2x2 DeviceMesh, then a DTensor
redistribution from Shard to Replicate as the launcher's first layer does
(the embedding table's gather over "data").

    python3 scripts/mesh_backend_probe.py          # on a machine with a card
    python3 scripts/mesh_backend_probe.py --functional
"""
from __future__ import annotations

import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

WORLD = 4
OPS = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce", "all_to_all_single")


def collectives(rank: int, world: int) -> dict:
    """Each collective on cuda:0 tensors: "ok", "wrong values" or the error."""
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    k = 4
    x = torch.arange(world * k, dtype=torch.float32, device=dev) + 100 * rank
    out = {}
    for name in OPS:
        try:
            if name == "all_gather_into_tensor":
                y = torch.empty(world * world * k, device=dev)
                dist.all_gather_into_tensor(y, x)
                want = torch.cat([torch.arange(world * k, device=dev) + 100 * r for r in range(world)])
            elif name == "reduce_scatter_tensor":
                y = torch.empty(k, device=dev)
                dist.reduce_scatter_tensor(y, x)
                want = sum(torch.arange(world * k, device=dev)[rank * k:(rank + 1) * k] + 100 * r
                           for r in range(world)).float()
            elif name == "all_reduce":
                y = x.clone()
                dist.all_reduce(y)
                want = sum(torch.arange(world * k, device=dev) + 100 * r for r in range(world)).float()
            else:
                y = torch.empty_like(x)
                dist.all_to_all_single(y, x)
                want = torch.cat([torch.arange(world * k, device=dev)[rank * k:(rank + 1) * k] + 100 * r
                                  for r in range(world)]).float()
            torch.cuda.synchronize()
            out[name] = "ok" if torch.equal(y, want) else "wrong values"
        except Exception as e:      # noqa: BLE001 - the probe reports every failure
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return out


def _gloo_rank(rank, port, queue):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    try:
        res = collectives(rank, WORLD)
    finally:
        dist.destroy_process_group()
    queue.put((rank, res))


def probe_gloo() -> dict:
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_gloo_rank, args=(port, queue), nprocs=WORLD, join=True,
                       start_method="spawn")
    return dict(sorted(queue.get() for _ in range(WORLD)))[0]


def probe_threaded() -> dict:
    from repro_torch.launch.mesh import run_threaded
    return run_threaded(WORLD, lambda rank: collectives(rank, WORLD))[0]


def train(backend: str, arch: str) -> dict:
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan, ssd_scan_bwd
    from repro_torch.launch import train as launch_train
    kernels = (flash_attention, flash_attention_bwd, ssd_scan, ssd_scan_bwd)
    for fn in kernels:
        fn.launches = 0
    ck = tempfile.mkdtemp(prefix="mesh_probe_")
    try:
        out = launch_train.main(["--arch", arch, "--reduced", "--data", "2", "--model", "2",
                                 "--backend", backend, "--steps", "3", "--batch", "4",
                                 "--seq", "64", "--ckpt-every", "0", "--ckpt-dir", ck,
                                 "--log-every", "1"])
        res = {"losses": [m["loss"] for m in out["metrics"]]}
    except BaseException as e:      # noqa: BLE001
        res = {"error": f"{type(e).__name__}: {str(e).splitlines()[0][:300] if str(e) else ''}",
               "trace": traceback.format_exc()[-1500:]}
    # launches in this process (the threaded ranks'); spawned ranks count in theirs
    res["launches_here"] = {fn.__name__: fn.launches for fn in kernels}
    return res


# (name, what it runs); every variant checks the values it gets back
FUNCTIONAL = (
    ("all_gather_tensor, world", "funcol.all_gather_tensor(x, 0, WORLD), wait_tensor"),
    ("reduce_scatter_tensor, world", "funcol.reduce_scatter_tensor(x, 'sum', 0, WORLD), wait"),
    ("all_reduce, world", "funcol.all_reduce(x, 'sum', WORLD), wait_tensor"),
    ("all_gather_tensor, world, bf16", "the first, x in bf16"),
    ("all_gather_tensor, mesh dim 0", "2x2 DeviceMesh on cuda, (mesh, 0), wait_tensor"),
    ("all_gather_tensor, mesh dim 1", "2x2 DeviceMesh on cuda, (mesh, 1), wait_tensor"),
    ("dtensor redistribute", "(Shard(1), Replicate()) -> (Replicate(), Replicate()) of a "
                             "(64, 32) bf16 table, to_local"),
    ("dtensor redistribute, smollm's table", "the same at smollm-135m's (49152, 576)"),
)


def functional_variant(name: str, rank: int) -> str:
    """One variant of FUNCTIONAL on this rank: "ok" or "wrong values"."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    dev = torch.device("cuda", 0)
    k = 4
    x = torch.arange(WORLD * k, dtype=torch.float32, device=dev) + 100 * rank
    world = dist.group.WORLD
    rows = lambda r: torch.arange(WORLD * k, device=dev) + 100 * r     # noqa: E731
    if name.startswith("all_gather_tensor, world"):
        dt = torch.bfloat16 if name.endswith("bf16") else torch.float32
        y = funcol.wait_tensor(funcol.all_gather_tensor(x.to(dt), 0, world))
        want = torch.cat([rows(r) for r in range(WORLD)]).to(dt)
    elif name == "reduce_scatter_tensor, world":
        y = funcol.wait_tensor(funcol.reduce_scatter_tensor(x, "sum", 0, world))
        want = sum(rows(r)[rank * k:(rank + 1) * k] for r in range(WORLD)).float()
    elif name == "all_reduce, world":
        y = funcol.wait_tensor(funcol.all_reduce(x, "sum", world))
        want = sum(rows(r) for r in range(WORLD)).float()
    elif name.startswith("all_gather_tensor, mesh dim"):
        dim = int(name[-1])
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
        y = funcol.wait_tensor(funcol.all_gather_tensor(x, 0, (mesh, dim)))
        coord = mesh.get_coordinate()
        peers = [r for r in range(WORLD)
                 if all((r // 2, r % 2)[d] == coord[d] for d in range(2) if d != dim)]
        want = torch.cat([rows(r) for r in peers]).float()
    else:
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
        shape = (49152, 576) if name.endswith("table") else (64, 32)
        table = torch.arange(shape[0] * shape[1], dtype=torch.float32, device=dev).view(shape)
        dt = distribute_tensor(table.to(torch.bfloat16), mesh, [Shard(1), Replicate()])
        y = dt.redistribute(mesh, [Replicate(), Replicate()]).to_local().float()
        want = table.to(torch.bfloat16).float()
    torch.cuda.synchronize()
    return "ok" if torch.equal(y, want) else "wrong values"


def _functional_rank(rank, name, port, queue):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=WORLD,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    try:
        res = functional_variant(name, rank)
    except Exception as e:      # noqa: BLE001 - the probe reports every failure
        res = f"{type(e).__name__}: {str(e).splitlines()[0][:200] if str(e) else ''}"
    finally:
        dist.destroy_process_group()
    queue.put((rank, res))


def _run_functional_variant(name: str) -> None:
    """Four spawned gloo ranks run one variant; prints their results."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(_functional_rank, args=(name, port, queue), nprocs=WORLD, join=True,
                       start_method="spawn")
    print(json.dumps(dict(sorted(queue.get() for _ in range(WORLD)))))


def probe_functional() -> dict:
    """{variant: {"calls": what it runs, "ranks": per-rank results} or
    {"calls", "exit": code, "stderr": its tail}}: each variant in a fresh
    interpreter, so a rank that dies (SIGSEGV: exit -11 of the rank, a
    ProcessExitedException in the parent) does not take the others with it."""
    import torch
    out = {"torch": torch.__version__}
    for name, calls in FUNCTIONAL:
        try:
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--variant", name],
                               capture_output=True, text=True, timeout=240)
            if p.returncode == 0:
                out[name] = {"calls": calls, "ranks": json.loads(p.stdout.strip().splitlines()[-1])}
            else:
                out[name] = {"calls": calls, "exit": p.returncode,
                             "stderr": p.stderr.strip()[-1200:]}
        except subprocess.TimeoutExpired:
            out[name] = {"calls": calls, "exit": "timed out after 240 s"}
    return out


def main():
    if "--variant" in sys.argv:
        _run_functional_variant(sys.argv[sys.argv.index("--variant") + 1])
        return
    if "--functional" in sys.argv:
        print(json.dumps(probe_functional(), indent=1))
        return
    import torch
    from repro_torch.kernels import _build
    _build.build_all()
    report = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__}
    for name, fn in (("threaded", probe_threaded), ("gloo", probe_gloo)):
        try:
            report[name] = fn()
        except BaseException as e:      # noqa: BLE001
            report[name] = {"error": f"{type(e).__name__}: {e}"}
    for backend in ("threaded", "gloo"):
        if all(report[backend].get(op) == "ok" for op in OPS):
            report[f"train_{backend}"] = {arch: train(backend, arch) for arch in
                                          ("smollm-135m", "mamba2-370m", "mixtral-8x7b")}
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
