"""Device meshes of the port (`repro.launch.mesh`): torch `DeviceMesh`es with
named dims over the ranks of the default process group. Functions, not
module constants: importing this module never touches the process group.

Single pod:  (16, 16)      axes ("data", "model")           = 256 ranks
Multi-pod:   (2, 16, 16)   axes ("pod", "data", "model")    = 512 ranks

`repro` builds its mesh from the devices of one process; the port runs one
process (or thread) per rank, torch's idiom, so a mesh of n entries needs a
process group of n ranks (`launch/train.py` starts them). `run_threaded`
runs a function on each rank of a threaded process group inside this
process: torch's in-process group for tests, and for several ranks that
share one card.
"""
from __future__ import annotations

import math
import sys
import threading
import traceback
from typing import Callable, List, Optional, Tuple


def make_mesh_shape(shape: Tuple[int, ...], axes: Tuple[str, ...],
                    device_type: Optional[str] = None):
    """A `DeviceMesh` of `shape` named `axes` over the first prod(shape)
    ranks of the default group; `device_type` defaults to "cuda" when the
    card is there, else "cpu"."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {have} — the dry-run "
            "sets XLA_FLAGS=--xla_force_host_platform_device_count=512 before "
            "importing jax")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_shape(shape, axes, device_type)


def make_test_mesh(data: int = 1, model: int = 1, device_type: Optional[str] = None):
    """Small mesh for tests (1 rank by default)."""
    return make_mesh_shape((data, model), ("data", "model"), device_type)


class CollectiveCounter:
    """Counts the collectives DTensor issues in this thread, by kind (the
    `_c10d_functional` ops that `CommDebugMode` counts), as a
    TorchDispatchMode of this thread only: `CommDebugMode`'s module tracker
    is process-wide and breaks with several ranks as threads.

        with CollectiveCounter() as comm:
            step(...)
        comm.counts      # {"all_gather_into_tensor": n, ...}
    """

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counts = self.counts = {}

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = func.__name__.split(".")[0]
                if func.namespace == "_c10d_functional" and not name.startswith(("_", "wait")):
                    counts[name] = counts.get(name, 0) + 1
                return func(*args, **(kwargs or {}))
        self._mode = _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def run_threaded(world_size: int, fn: Callable[[int], object]) -> List[object]:
    """fn(rank) on `world_size` threads, each rank of torch's threaded
    process group (`multi_threaded_pg`, the group DTensor's own tests use),
    which runs the collectives in this process on tensors of any device.
    Returns each rank's result; the first rank's exception is raised after
    every thread has ended. The group is torn down before it returns."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed import multi_threaded_pg as mtpg

    world = mtpg._install_threaded_pg()
    store = dist.HashStore()
    results: List[object] = [None] * world_size
    errors: List[Tuple[int, BaseException, str]] = []

    def worker(rank):
        dist.init_process_group("threaded", rank=rank, world_size=world_size, store=store)
        try:
            results[rank] = fn(rank)
        except BaseException as e:      # wake the other ranks out of their collectives
            errors.append((rank, e, traceback.format_exc()))
            mtpg.ProcessLocalGroup.exception_handle(e)
        finally:
            if world == dist.distributed_c10d._world:
                try:
                    dist.destroy_process_group()
                except AttributeError:
                    # torch 2.11's threaded world lacks the `comms` list that
                    # destroy_process_group reads last; the thread's world
                    # goes with the thread
                    pass

    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    try:
        threads = [threading.Thread(target=worker, args=(r,)) for r in range(world_size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
        mtpg._uninstall_threaded_pg()
        mtpg.ProcessLocalGroup.reset()
    if errors:
        rank, err, trace = errors[0]    # the first to fail; the others were woken
        print(f"[mesh] rank {rank} failed:\n{trace}", file=sys.stderr)
        raise err
    return results
