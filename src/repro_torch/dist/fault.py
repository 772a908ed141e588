"""Fault tolerance: checkpoint-resume supervisor + straggler detection
(`repro.dist.fault` for the port).

`TrainSupervisor` owns the outer training loop: it restores the newest
valid checkpoint on start, runs the step function, checkpoints
every `ckpt_every` completed steps and after the last (never, when
`ckpt_every` is 0), and — on an (injected or real) failure
— rolls back to the latest checkpoint, trims the metric log to the resume
point, and re-runs, so the returned metric log is contiguous across any
number of restarts. Corrupted checkpoints are quarantined by
`checkpoint.restore_latest` and the supervisor falls back to the previous
one (or a fresh init when none survive).

`StragglerPolicy` flags slow steps against an EMA of healthy step times;
flagged steps never contaminate the baseline.

In the port the trained state is the model itself (its parameters, updated
in place by the step) and the optimizer state: checkpoints hold them as
`repro`'s trees (`train.checkpoint.state_trees`), and a restore copies a
checkpoint into a fresh `init_fn()` state (`checkpoint.load_state`), after
placing the trees on `device`. Under a device mesh `shardings` is
`repro`'s pair of `NamedSharding` trees (params, opt state, from
`dist.sharding.to_shardings`): a restore lays each checkpoint leaf out by
its spec (`distribute_tree`) before copying it into the live DTensors, and a
save gathers every leaf (all ranks) while the first rank writes, the others
waiting at a barrier. The step's metrics are read with `float()`, which
waits for the card.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.train import checkpoint as ckpt


class StragglerPolicy:
    """Tolerance-based slow-step detection. A step is a straggler when its
    duration exceeds `tolerance` x the EMA of previous healthy steps."""

    def __init__(self, tolerance: float = 3.0, ema_alpha: float = 0.2,
                 warmup_steps: int = 1, seed_steps: int = 3):
        self.tolerance = float(tolerance)
        self.ema_alpha = float(ema_alpha)
        self.warmup_steps = int(warmup_steps)
        self.seed_steps = max(int(seed_steps), 1)
        self.ema: Optional[float] = None
        self.slow_steps = 0
        self._seen = 0
        self._seed: list = []

    def observe(self, duration_s: float) -> bool:
        """Record one step duration; True when it is a straggler."""
        d = float(duration_s)
        self._seen += 1
        if self._seen <= self.warmup_steps:
            # warmup steps carry one-time costs (kernel builds, cuBLAS and
            # allocator warm-up); seeding the EMA with them would blind
            # detection for the early run
            return False
        if self.ema is None:
            # seed from the median of the first few steady steps so a
            # single transient stall cannot inflate the baseline
            self._seed.append(d)
            if len(self._seed) >= self.seed_steps:
                self.ema = float(np.median(self._seed))
            return False
        if d > self.tolerance * self.ema:
            self.slow_steps += 1
            return True
        self.ema = (1 - self.ema_alpha) * self.ema + self.ema_alpha * d
        return False


def _barrier():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def ckpt_mesh(shardings):
    """The mesh of a (params, opt) `NamedSharding` tree pair."""
    from repro_torch.dist.sharding import NamedSharding, tree_leaves
    return next(s for s in tree_leaves(shardings[1]) if isinstance(s, NamedSharding)).mesh


class TrainSupervisor:
    """Fault-tolerant outer loop around a pure train step.

    run(init_fn, step_fn, batches, total_steps, failure_injector=None):
      * init_fn() -> (model, opt_state)             fresh state
      * step_fn(model, opt_state, batch) -> (model, opt_state, metrics)
      * batches(step) -> batch pytree               deterministic per step
      * failure_injector(step) -> bool              True = crash before step
        (tests inject node failures; production wires real health checks)

    Returns {"params", "opt_state", "metrics", "restarts", "slow_steps"}.
    `metrics` is one dict per step, contiguous in `step` across restarts.
    """

    def __init__(self, ckpt_dir: str, ckpt_every: int = 50,
                 straggler: Optional[StragglerPolicy] = None,
                 max_restarts: int = 100, max_futile_restarts: int = 3,
                 run_tag: Optional[str] = None, device=None, shardings=None):
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = max(int(ckpt_every), 0)     # 0: no checkpoints
        self.straggler = straggler or StragglerPolicy()
        self.max_restarts = max_restarts
        # where restored numpy trees go before they are copied into the
        # live state (None: copied from the host)
        self.device = device
        # (param shardings, opt shardings) in repro's tree layout, under a mesh
        self.shardings = shardings
        # consecutive exception-restarts at the SAME step before giving up
        # (a deterministic bug should surface, not retry max_restarts times)
        self.max_futile_restarts = max(int(max_futile_restarts), 1)
        # identity stamped into checkpoint meta; resuming a dir written by a
        # different run_tag (e.g. another arch) fails loudly instead of
        # loading shape-mismatched state
        self.run_tag = run_tag

    # -- state (re)loading --------------------------------------------------

    def _resume_or_init(self, init_fn):
        _barrier()             # no rank reads while the writer writes
        restored = ckpt.restore_latest(self.ckpt_dir, quarantine=ckpt.is_writer())
        if restored is None:
            params, opt_state = init_fn()
            return params, opt_state, 0
        params_np, opt_np, meta = restored
        tag = meta.get("run_tag")
        if self.run_tag is not None and tag != self.run_tag:
            # a missing tag is a mismatch too: untagged state is exactly as
            # likely to be shape-incompatible as a wrongly-tagged one
            raise RuntimeError(
                f"checkpoint dir {self.ckpt_dir!r} belongs to run "
                f"{tag!r}, not {self.run_tag!r}; refusing to resume — "
                "use a fresh --ckpt-dir")
        if self.shardings is not None:
            from repro_torch.dist.sharding import distribute_tree
            mesh = ckpt_mesh(self.shardings)
            params_np = distribute_tree(mesh, params_np, self.shardings[0])
            opt_np = distribute_tree(mesh, opt_np, self.shardings[1])
        elif self.device is not None:
            params_np = ckpt.to_device(params_np, self.device)
            opt_np = ckpt.to_device(opt_np, self.device)
        params, opt_state = init_fn()
        ckpt.load_state(params, opt_state, params_np, opt_np)
        return params, opt_state, int(meta["step"])

    def _save(self, step, params, opt_state):
        extra = {"run_tag": self.run_tag} if self.run_tag else None
        trees = ckpt.state_trees(params, opt_state)
        if trees is not None:
            ckpt.save_checkpoint(self.ckpt_dir, step, *trees, extra=extra)
        _barrier()

    # -- main loop ----------------------------------------------------------

    def run(self, init_fn: Callable, step_fn: Callable,
            batches: Callable[[int], Dict], total_steps: int,
            failure_injector: Optional[Callable[[int], bool]] = None
            ) -> Dict:
        restarts = 0
        metrics: List[Dict] = []
        params, opt_state, step = self._resume_or_init(init_fn)
        last_saved = step
        last_fail_step, futile = -1, 0

        while step < total_steps:
            if failure_injector is not None and failure_injector(step):
                futile = futile + 1 if step == last_fail_step else 1
                last_fail_step = step
                restarts += 1
                if restarts > self.max_restarts or \
                        futile >= self.max_futile_restarts:
                    raise RuntimeError(
                        f"persistent failure at step {step} "
                        f"(restarts={restarts}, consecutive={futile})")
                params, opt_state, step = self._resume_or_init(init_fn)
                metrics = [m for m in metrics if m["step"] < step]
                continue

            t0 = time.time()
            try:
                params, opt_state, m = step_fn(params, opt_state,
                                               batches(step))
                entry = {"step": step}
                for k, v in m.items():
                    entry[k] = float(v)     # waits until the step is done
            except Exception as e:
                # real failure path (device fault, OOM, ...): same rollback
                # as an injected one, bounded by max_restarts; repeated
                # failure of the SAME step is deterministic, not transient —
                # surface it instead of burning max_restarts retries
                futile = futile + 1 if step == last_fail_step else 1
                last_fail_step = step
                restarts += 1
                if restarts > self.max_restarts or \
                        futile >= self.max_futile_restarts:
                    raise
                print(f"[supervisor] step {step} failed "
                      f"({type(e).__name__}: {e}); rolling back "
                      f"(restart {restarts}/{self.max_restarts})", flush=True)
                params, opt_state, step = self._resume_or_init(init_fn)
                metrics = [m_ for m_ in metrics if m_["step"] < step]
                continue
            metrics.append(entry)
            self.straggler.observe(time.time() - t0)

            step += 1
            if self.ckpt_every and step % self.ckpt_every == 0:
                self._save(step, params, opt_state)
                last_saved = step

        if self.ckpt_every and last_saved < total_steps:
            self._save(total_steps, params, opt_state)
        return {"params": params, "opt_state": opt_state, "metrics": metrics,
                "restarts": restarts,
                "slow_steps": self.straggler.slow_steps}
