"""Campaign CLI of the port: run / resume / validate declarative DSE
campaigns on the card (or, with --device cpu, on the CPU).

    # run a campaign spec (writes campaign_<name>.result.json + checkpoint)
    python -m repro_torch.explore examples/campaigns/quick_train_mfmobo.json

    # the same on the CPU
    python -m repro_torch.explore examples/campaigns/quick_train_mfmobo.json \
        --device cpu

    # resume an interrupted run from its checkpoint (on any device)
    python -m repro_torch.explore --resume campaign_quick-train-mfmobo.ckpt.pkl

    # parse + validate shipped specs without running anything
    python -m repro_torch.explore --validate examples/campaigns/*.json

    # run a campaign FLEET (grid of specs across worker processes)
    python -m repro_torch.explore fleet examples/campaigns/fleet_quick_grid.json

The port's copy of `repro.explore.__main__`, with `--device` (default
cuda) for campaigns and fleets alike.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.explore.campaign import Campaign, CampaignSpec


def _default_paths(name: str, out: Optional[str], ckpt: Optional[str]):
    slug = name.replace(" ", "-")
    return (out or f"campaign_{slug}.result.json",
            ckpt or f"campaign_{slug}.ckpt.pkl")


def _summarize(result) -> None:
    spec = result.spec
    print(f"\n=== campaign {spec.name!r}: {spec.strategy} on "
          f"{spec.workload} [{spec.scenario}] ===")
    print(f"evaluations: {result.n_evals}  wall: {result.wall_s:.1f}s  "
          f"({result.candidates_per_sec:.2f} candidates/sec)  "
          f"finished: {result.finished}")
    print(f"hypervolume: {result.hv_final:.3f}  front: "
          f"{len(result.front)} nondominated designs")
    for stage, sc in sorted(result.stage_cache.items()):
        n = sc["hits"] + sc["misses"]
        if n:
            print(f"eval cache [{stage}]: {sc['hits']}/{n} hits "
                  f"({100 * sc['hit_rate']:.0f}%), "
                  f"{sc['entries_added']} entries added")
    for stage, st in sorted(result.objective_stats.items()):
        if st["n_constraint_violations"] or st["n_infeasible"]:
            print(f"objective [{stage}]: {st['n_infeasible']} infeasible, "
                  f"{st['n_constraint_violations']} constraint-violating "
                  "candidates mapped to the penalty point")
    y0 = spec.objectives[0].name
    for p in result.front[:5]:
        print(f"  front: {y0}={p[y0]:.1f}  "
              f"{spec.objectives[1].name}={p[spec.objectives[1].name]:.1f}  "
              f"{p['describe']}")


def _fleet_main(argv: List[str]) -> int:
    """`python -m repro_torch.explore fleet grid.json [...]` — run a
    FleetSpec across worker processes (repro_torch.explore.fleet)."""
    from repro_torch.explore.fleet import FleetSpec, run_fleet
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.explore fleet",
        description="Fan a grid of campaign specs across worker "
                    "processes sharing a persistent eval cache.")
    ap.add_argument("spec", help="fleet spec JSON path")
    ap.add_argument("--workers", type=int, default=None,
                    help="override the spec's worker count")
    ap.add_argument("--validate", action="store_true",
                    help="parse + validate the fleet spec, run nothing")
    ap.add_argument("--out", help="result JSON path "
                                  "(default fleet_<name>.result.json)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the workers: cuda gives worker i "
                         "cuda:{i %% device_count} (default; raises when "
                         "there is no card), cpu runs them on the CPU")
    args = ap.parse_args(argv)
    import dataclasses as _dc
    fspec = FleetSpec.from_json(args.spec)
    if args.workers is not None:
        fspec = _dc.replace(fspec, workers=args.workers)
    if args.validate:
        fspec.validate()
        print(f"OK {args.spec}: fleet {fspec.name!r} — "
              f"{len(fspec.campaigns)} campaigns x {fspec.workers} workers")
        return 0
    res = run_fleet(fspec, device=args.device, verbose=True)
    out = args.out or f"fleet_{fspec.name.replace(' ', '-')}.result.json"
    res.save(out)
    done = sum(1 for c in res.campaigns if c)
    print(f"\n=== fleet {fspec.name!r}: {done}/{len(res.campaigns)} "
          f"campaigns on {fspec.workers} workers ===")
    print(f"evaluations: {res.n_evals}  wall: {res.wall_s:.1f}s  "
          f"({res.fleet_candidates_per_sec:.2f} candidates/sec)  "
          f"crashes: {res.crashes}")
    for err in res.errors:
        print(f"ERROR {err}")
    print(f"result -> {out}")
    return 1 if res.errors else 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "fleet":
        return _fleet_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.explore",
        description="Run, resume, or validate DSE campaign specs "
                    "(DESIGN.md §9).")
    ap.add_argument("spec", nargs="*", help="campaign spec JSON path(s)")
    ap.add_argument("--validate", action="store_true",
                    help="parse + validate the specs, run nothing")
    ap.add_argument("--resume", metavar="CKPT",
                    help="resume a checkpointed campaign instead of "
                         "starting from a spec")
    ap.add_argument("--out", help="result JSON path "
                                  "(default campaign_<name>.result.json)")
    ap.add_argument("--checkpoint",
                    help="checkpoint path (default "
                         "campaign_<name>.ckpt.pkl)")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="checkpoint every N loop steps "
                         "(default: the spec's checkpoint_every)")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="stop after N loop steps (the checkpoint can be "
                         "resumed later)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the GP, acquire, analytical "
                         "evaluator and GNN fidelity (with its "
                         "calibration) run on (default: cuda; raises "
                         "when there is no card)")
    args = ap.parse_args(argv)

    if args.validate:
        if not args.spec:
            ap.error("--validate needs at least one spec path")
        import json
        for path in args.spec:
            with open(path) as f:
                raw = json.load(f)
            if "campaigns" in raw or "grid" in raw:  # fleet-shaped spec
                from repro_torch.explore.fleet import FleetSpec
                fspec = FleetSpec.from_json(path)
                fspec.validate()
                print(f"OK {path}: fleet {fspec.name!r} — "
                      f"{len(fspec.campaigns)} campaigns x "
                      f"{fspec.workers} workers")
                continue
            spec = CampaignSpec.from_json(path).validate()
            cfg = spec.loop_config()
            print(f"OK {path}: {spec.name!r} ({spec.strategy} on "
                  f"{spec.workload} [{spec.scenario}], "
                  f"{cfg.total_evals()} evals, q={spec.q})")
        return 0

    if args.resume:
        if args.spec:
            ap.error("--resume continues the checkpoint's embedded spec; "
                     "don't also pass a spec path")
        campaign = Campaign.resume(args.resume, device=args.device)
    elif len(args.spec) == 1:
        campaign = Campaign(CampaignSpec.from_json(args.spec[0]),
                            device=args.device)
    else:
        ap.error("pass exactly one spec path (or --resume CKPT / "
                 "--validate SPEC...)")
        return 2
    out, ckpt = _default_paths(campaign.spec.name, args.out,
                               args.resume or args.checkpoint)
    result = campaign.run(checkpoint_path=ckpt,
                          checkpoint_every=args.checkpoint_every,
                          max_steps=args.max_steps)
    result.save(out)
    _summarize(result)
    print(f"\nresult  -> {out}\ncheckpoint -> {ckpt}"
          + ("" if result.finished else
             f"\n(unfinished: resume with --resume {ckpt})"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
