"""Campaign fleets — parallel workers over a campaign grid (DESIGN.md §11;
the port of `repro.explore.fleet`).

Theseus-style studies are *grids* of campaigns (fig8 is method×seed; WATOS
co-exploration multiplies that further). `FleetSpec` names a grid of
`CampaignSpec`s plus the execution substrate, and `run_fleet` fans it
across spawned worker processes that share:

    - the persistent eval cache (`DiskSegmentEvalCache` on `cache_dir`,
      wired via `repro_torch.core.evaluator.configure_eval_cache`) —
      concurrent workers and successive campaigns reuse each other's
      evaluations;
    - a device each: `run_fleet(spec, device="cuda")` gives worker i
      `cuda:{i % device_count}` (so both workers of a two-worker fleet
      share one card), `device="cpu"` runs every worker on the CPU;
    - per-process memoized warm-ups (`mfmobo.warm_optimizer_kernels`,
      `eval_compiled.warm_evaluator_kernels`) when `warm_n_obs` is set.

Workers are plain `multiprocessing` *spawn* processes (fork would break
CUDA in the children) driven over pipes: the scheduler sends one campaign
at a time and requeues the in-flight campaign of any worker that dies, so a
crashed/preempted worker costs at most the work since the campaign's last
checkpoint — workers always try `Campaign.resume` from the fleet's
checkpoint directory before starting fresh.

What differs from `repro`: the port's evaluator runs one program on one
device and has no XLA host lanes, so `host_devices > 1` is refused
(`FleetSpec.validate`); `compile_cache_dir` is accepted, so that `repro`'s
fleet JSON parses and round-trips, and is unused (eager torch compiles no
program to cache). A campaign's `eval_lanes` keeps `repro`'s keys and
reports one lane.

CLI: ``python -m repro_torch.explore fleet grid.json [--workers N]
[--out F] [--device D]``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.explore.campaign import Campaign, CampaignSpec

FLEET_SPEC_VERSION = 1

# test hook: "<campaign-name>:<marker-path>" makes the worker that picks up
# that campaign checkpoint two steps and die hard (os._exit) — once, gated
# on the marker file — so tests can exercise the scheduler's crash-requeue
# + checkpoint-resume path with a real dead process.
_CRASH_ENV = "REPRO_FLEET_TEST_CRASH"


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """A named grid of campaigns plus the execution substrate. Campaign
    names must be unique — they key the per-campaign checkpoint files the
    crash-resume path depends on."""
    name: str
    campaigns: Tuple[CampaignSpec, ...]
    workers: int = 2
    cache_dir: Optional[str] = None          # shared persistent eval cache
    compile_cache_dir: Optional[str] = None  # accepted, unused (no XLA)
    checkpoint_dir: Optional[str] = None     # per-campaign ckpts (resume)
    checkpoint_every: int = 2                # steps between worker ckpts
    host_devices: int = 1                    # must be 1 (no XLA lanes)
    warm_n_obs: int = 0                      # 0 = skip kernel pre-warm
    max_cache_entries: int = 100_000

    def validate(self) -> "FleetSpec":
        if not self.campaigns:
            raise ValueError("fleet has no campaigns")
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        if self.host_devices < 1:
            raise ValueError("host_devices must be >= 1")
        if self.host_devices > 1:
            raise ValueError(
                f"host_devices={self.host_devices}: the port's evaluator "
                "runs one program on one device and has no XLA host lanes "
                "to shard the design axis over; use host_devices=1 (each "
                "worker gets a device of its own)")
        names = [c.name for c in self.campaigns]
        dupes = sorted({n for n in names if names.count(n) > 1})
        if dupes:
            raise ValueError(
                f"campaign names must be unique within a fleet (they key "
                f"checkpoint files); duplicated: {dupes}")
        for c in self.campaigns:
            c.validate()
        return self

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> Dict:
        d = {"version": FLEET_SPEC_VERSION, "name": self.name,
             "workers": self.workers, "checkpoint_every":
             self.checkpoint_every, "host_devices": self.host_devices,
             "warm_n_obs": self.warm_n_obs,
             "max_cache_entries": self.max_cache_entries,
             "campaigns": [c.to_dict() for c in self.campaigns]}
        for k in ("cache_dir", "compile_cache_dir", "checkpoint_dir"):
            if getattr(self, k) is not None:
                d[k] = getattr(self, k)
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "FleetSpec":
        d = dict(d)
        v = d.pop("version", FLEET_SPEC_VERSION)
        if v != FLEET_SPEC_VERSION:
            raise ValueError(f"fleet spec version {v!r} unsupported (this "
                             f"build reads version {FLEET_SPEC_VERSION})")
        grid = d.pop("grid", None)
        campaigns = [CampaignSpec.from_dict(c)
                     for c in d.pop("campaigns", [])]
        if grid is not None:
            campaigns.extend(expand_grid(grid))
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown fleet spec fields: {sorted(unknown)}")
        return cls(campaigns=tuple(campaigns), **d)

    def to_json(self, path: Optional[str] = None, indent: int = 1) -> str:
        s = json.dumps(self.to_dict(), indent=indent)
        if path:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s

    @classmethod
    def from_json(cls, path_or_str: str) -> "FleetSpec":
        if path_or_str.lstrip().startswith("{"):
            return cls.from_dict(json.loads(path_or_str))
        with open(path_or_str) as f:
            return cls.from_dict(json.load(f))


def expand_grid(grid: Mapping) -> List[CampaignSpec]:
    """Expand `{"base": <partial spec>, "strategies": [...], "seeds":
    [...], "workloads": [...]}` into the method×seed×workload product of
    CampaignSpecs. Each axis defaults to the base spec's own value; names
    are `<base-name>-<workload>-<strategy>-s<seed>`."""
    g = dict(grid)
    base = dict(g.pop("base"))
    base.setdefault("name", "grid")
    base_name = base["name"]
    strategies = g.pop("strategies", [base.get("strategy", "mfmobo")])
    seeds = g.pop("seeds", [base.get("seed", 0)])
    workloads = g.pop("workloads", [base["workload"]])
    if g:
        raise ValueError(f"unknown grid fields: {sorted(g)} (expected "
                         "base / strategies / seeds / workloads)")
    out = []
    for wl in workloads:
        for strat in strategies:
            for seed in seeds:
                d = dict(base, workload=wl, strategy=strat, seed=seed,
                         name=f"{base_name}-{wl}-{strat}-s{seed}")
                out.append(CampaignSpec.from_dict(d))
    return out


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------


def _worker_device(device: str, worker_id: int) -> str:
    """Worker `worker_id`'s device: `cuda:{i % device_count}` for a CUDA
    fleet, the fleet's device as it is otherwise."""
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return str(dev)
    return f"cuda:{worker_id % torch.cuda.device_count()}"


def _worker_setup(cfg: Dict) -> None:
    """Per-process substrate: the CPU threads and the shared eval cache.
    Runs once, before the first campaign (`compile_cache_dir` has nothing
    to set up: there is no XLA program to cache). A CPU fleet splits the
    host's cores among its workers: torch's default of every core per
    process makes the workers' (and an async campaign's two threads')
    thread pools fight over the same cores, which slows a campaign tens of
    times."""
    if cfg["device"] == "cpu":
        import torch
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // max(int(cfg["n_workers"]), 1)))
    if cfg.get("cache_dir"):
        from repro_torch.core.evaluator import configure_eval_cache
        configure_eval_cache(cache_dir=cfg["cache_dir"],
                             max_entries=cfg.get("max_cache_entries",
                                                 100_000))


def _campaign_ckpt(cfg: Dict, spec: CampaignSpec) -> Optional[str]:
    ckdir = cfg.get("checkpoint_dir")
    if not ckdir:
        return None
    os.makedirs(ckdir, exist_ok=True)
    slug = spec.name.replace(os.sep, "_").replace(" ", "-")
    return os.path.join(ckdir, f"{slug}.ckpt.pkl")


def _maybe_test_crash(cfg: Dict, spec: CampaignSpec, ck: Optional[str]):
    hook = os.environ.get(_CRASH_ENV, "")
    if not hook or ":" not in hook:
        return
    name, marker = hook.split(":", 1)
    if spec.name != name or os.path.exists(marker):
        return
    with open(marker, "w") as f:
        f.write(spec.name)
    Campaign(spec, device=cfg["device"]).run(
        checkpoint_path=ck, checkpoint_every=1, max_steps=2)
    os._exit(17)                     # die hard: no atexit, no cleanup


def _run_one(cfg: Dict, spec_dict: Dict) -> Dict:
    from repro_torch.core import eval_compiled
    from repro_torch.core.evaluator import eval_cache_stats
    from repro_torch.core.mfmobo import warm_optimizer_kernels

    spec = CampaignSpec.from_dict(spec_dict)
    dev = cfg["device"]
    warm_s = 0.0
    if cfg.get("warm_n_obs"):
        from repro_torch.explore.campaign import resolve_workload
        try:
            wl = resolve_workload(spec)
        except Exception:
            wl = None                # synthetic objective: no evaluator
        t0 = time.time()
        # memoized per process: only the first campaign warms anything
        warm_optimizer_kernels(n_candidates=spec.n_candidates, q=spec.q,
                               device=dev)
        if wl is not None:
            eval_compiled.warm_evaluator_kernels(
                wl, spec.max_strategies, device=dev)
        warm_s = time.time() - t0
    lanes0 = eval_compiled.lane_stats()
    ck = _campaign_ckpt(cfg, spec)
    _maybe_test_crash(cfg, spec, ck)
    campaign = None
    if ck and os.path.exists(ck):
        try:
            campaign = Campaign.resume(ck, device=dev)
        except Exception:
            campaign = None          # unreadable checkpoint: start fresh
    resumed = campaign is not None
    if campaign is None:
        campaign = Campaign(spec, device=dev)
    result = campaign.run(checkpoint_path=ck,
                          checkpoint_every=cfg.get("checkpoint_every", 2))
    out = result.to_dict()
    out["resumed"] = resumed
    out["warm_s"] = warm_s
    out["eval_cache"] = dict(eval_cache_stats())
    # lane counters are process-global; report this campaign's delta so
    # fleet aggregation over campaigns doesn't double-count
    lanes1 = eval_compiled.lane_stats()
    out["eval_lanes"] = {
        k: (lanes1[k] if k == "n_lanes" else lanes1[k] - lanes0.get(k, 0))
        for k in lanes1}
    return out


def _fleet_worker(worker_id: int, cfg: Dict, conn) -> None:
    """Worker loop: receive (idx, spec_dict) tasks over the pipe, run each
    campaign (resuming its checkpoint if one exists), send (idx, result)
    back. A `None` task shuts the worker down."""
    cfg = dict(cfg, device=_worker_device(cfg["device"], worker_id))
    _worker_setup(cfg)
    while True:
        task = conn.recv()
        if task is None:
            conn.close()
            return
        idx, spec_dict = task
        try:
            conn.send((idx, _run_one(cfg, spec_dict), None))
        except Exception as e:       # surface, don't kill the worker
            conn.send((idx, None, f"{type(e).__name__}: {e}"))


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetResult:
    spec: FleetSpec
    campaigns: List[Dict]            # per-campaign result dicts (spec order)
    wall_s: float
    n_evals: int
    fleet_candidates_per_sec: float
    crashes: int
    errors: List[str]

    def to_dict(self) -> Dict:
        return {"spec": self.spec.to_dict(), "campaigns": self.campaigns,
                "wall_s": self.wall_s, "n_evals": self.n_evals,
                "fleet_candidates_per_sec": self.fleet_candidates_per_sec,
                "workers": self.spec.workers, "crashes": self.crashes,
                "errors": self.errors}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, default=float)
        return path


class _Worker:
    """Scheduler-side handle: the spawned process, its pipe end, and the
    index of the campaign it is currently running (None = idle)."""

    def __init__(self, ctx, worker_id: int, cfg: Dict):
        self.id = worker_id
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_fleet_worker,
                                args=(worker_id, cfg, child), daemon=True)
        self.proc.start()
        child.close()                # parent keeps only its own end
        self.current: Optional[int] = None

    def stop(self):
        try:
            if self.current is None and self.proc.is_alive():
                self.conn.send(None)
        except (BrokenPipeError, OSError):
            pass
        self.proc.join(timeout=10)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=5)
        self.conn.close()


def run_fleet(spec: FleetSpec, *, device="cuda",
              verbose: bool = False) -> FleetResult:
    """Execute every campaign in the fleet across `spec.workers` spawned
    processes, worker i on `cuda:{i % device_count}` (or every worker on
    the CPU with `device="cpu"`). Campaigns are handed out one at a time;
    a worker death requeues its in-flight campaign (resumed from its last
    checkpoint by the replacement worker). Returns per-campaign results in
    spec order plus fleet-level throughput."""
    import multiprocessing as mp

    from repro_torch.device import resolve_device

    spec.validate()
    device = str(resolve_device(device))   # no card: raise here, not in a child
    ctx = mp.get_context("spawn")    # fork would break CUDA in the children
    cfg = {"device": device,
           "cache_dir": spec.cache_dir,
           "checkpoint_dir": spec.checkpoint_dir,
           "checkpoint_every": spec.checkpoint_every,
           "warm_n_obs": spec.warm_n_obs,
           "max_cache_entries": spec.max_cache_entries}
    for k in ("cache_dir", "checkpoint_dir"):
        if cfg[k]:
            os.makedirs(cfg[k], exist_ok=True)

    t0 = time.time()
    n_workers = min(spec.workers, len(spec.campaigns))
    cfg["n_workers"] = n_workers
    pending = deque(range(len(spec.campaigns)))
    results: Dict[int, Optional[Dict]] = {}
    errors: List[str] = []
    crashes = 0
    # a worker that dies at startup would otherwise respawn forever; a few
    # deaths per campaign is the honest preemption budget
    max_crashes = 3 * len(spec.campaigns) + n_workers
    workers: List[_Worker] = []
    try:
        workers = [_Worker(ctx, w, cfg) for w in range(n_workers)]
        while len(results) < len(spec.campaigns):
            for w in workers:
                if w.current is None and pending:
                    idx = pending.popleft()
                    try:
                        w.conn.send((idx, spec.campaigns[idx].to_dict()))
                        w.current = idx
                    except (BrokenPipeError, OSError):
                        pending.appendleft(idx)
            progressed = False
            for i, w in enumerate(workers):
                crashed = False
                try:
                    ready = w.conn.poll(0.05)
                except (BrokenPipeError, OSError):
                    ready = False
                    crashed = not w.proc.is_alive()
                if ready:
                    try:
                        idx, res, err = w.conn.recv()
                    except (EOFError, OSError):
                        # a dead child leaves the pipe permanently "ready"
                        # at EOF — this IS the crash signal, handle it now
                        # (skipping it would poll-EOF-spin forever)
                        crashed = True
                    else:
                        w.current = None
                        results[idx] = res
                        if err is not None:
                            errors.append(
                                f"{spec.campaigns[idx].name}: {err}")
                        if verbose:
                            name = spec.campaigns[idx].name
                            print(f"[fleet] worker {w.id} finished "
                                  f"{name!r} ({len(results)}/"
                                  f"{len(spec.campaigns)})"
                                  + (f" ERROR {err}" if err else ""))
                        progressed = True
                elif not w.proc.is_alive():
                    crashed = True
                if crashed:
                    # crashed/preempted: requeue its campaign (the fresh
                    # worker resumes from the campaign's last checkpoint)
                    crashes += 1
                    if crashes > max_crashes:
                        raise RuntimeError(
                            f"fleet workers died {crashes} times (last "
                            f"exit code {w.proc.exitcode}); giving up — "
                            "the campaign grid or environment is broken")
                    if w.current is not None:
                        pending.appendleft(w.current)
                    if verbose:
                        print(f"[fleet] worker {w.id} died "
                              f"(exit {w.proc.exitcode}); respawning")
                    w.proc.join(timeout=5)     # reap the zombie
                    w.conn.close()
                    workers[i] = _Worker(ctx, w.id, cfg)
                    progressed = True
            if not progressed:
                time.sleep(0.01)
    finally:
        for w in workers:
            w.stop()

    wall = time.time() - t0
    ordered = [results.get(i) for i in range(len(spec.campaigns))]
    n_evals = sum(r["n_evals"] for r in ordered if r)
    return FleetResult(
        spec=spec, campaigns=ordered, wall_s=wall, n_evals=n_evals,
        fleet_candidates_per_sec=n_evals / max(wall, 1e-9),
        crashes=crashes, errors=errors)


__all__ = ["FLEET_SPEC_VERSION", "FleetResult", "FleetSpec", "expand_grid",
           "run_fleet"]
