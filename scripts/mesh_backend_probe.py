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

    python3 scripts/mesh_backend_probe.py          # on a machine with a card
"""
from __future__ import annotations

import datetime
import json
import os
import socket
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


def main():
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
