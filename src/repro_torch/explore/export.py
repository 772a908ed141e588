"""Export a DSE strategy as a runnable `repro_torch.launch.train`
configuration (the port of `repro.explore.export`: the same JSON and
version, aimed at the port's launcher, oracle and configs).

Joint campaigns (strategy_mode="joint") end with a Pareto front of
(architecture, Strategy) points. `export_train_config` closes the loop
from exploration back to the training launcher: it projects a winning
`Strategy` onto the train CLI surface (`--data` = dp, `--model` = tp,
`--microbatches`), records the full strategy (pp/ep/recompute/schedule —
axes the single-pod launcher does not expose yet) alongside, and
round-trips through JSON.

`validate_train_config` is the acceptance gate: the argv must parse
against the real launcher surface (built by `train_argv`), the mesh must
be shardable by the `repro_torch.dist` rule engine (`oracle.check_strategy`:
`param_specs`/`batch_specs` instantiable on a ("data", "model") =
(dp, tp) shim mesh for the arch's actual parameter shapes), and the
batch/microbatch arithmetic must divide. A config that validates runs
under `repro_torch.launch.train.main(train_argv(cfg))` on a matching
device topology: dp x tp ranks of a ("data", "model") device mesh, one per
card (NCCL), or dp x tp processes on the CPU with `--device cpu` appended
(gloo; a CPU smoke with `reduced=True`). The argv is `repro`'s, `--data`
and `--model` above 1 included.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from repro_torch.configs import ARCH_IDS

EXPORT_VERSION = 1


def _strategy_of(point):
    return point.strategy if hasattr(point, "strategy") else point


def export_train_config(point, arch_id: str, *, steps: int = 300,
                        batch: Optional[int] = None,
                        seq: Optional[int] = None,
                        reduced: bool = False,
                        path: Optional[str] = None) -> Dict:
    """Map a `JointDesign` (or bare `Strategy`) onto the train launcher's
    configuration surface. `batch`/`seq` default to the launcher's own
    defaults when not given. Writes JSON to `path` when provided."""
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; known: "
                         f"{sorted(ARCH_IDS)}")
    s = _strategy_of(point)
    cfg = {
        "version": EXPORT_VERSION,
        "arch": arch_id,
        "reduced": bool(reduced),
        "steps": int(steps),
        "batch": int(batch) if batch is not None else 8,
        "seq": int(seq) if seq is not None else 256,
        # the runnable projection: the single-pod launcher exposes
        # (data, model, microbatches)
        "data": int(s.dp),
        "model": int(s.tp),
        "microbatches": int(s.microbatches),
        # the full strategy of record — pp/ep/recompute/schedule have no
        # launcher axis yet but stay attached to the artifact
        "strategy": {
            "tp": int(s.tp), "pp": int(s.pp), "dp": int(s.dp),
            "ep": int(s.ep), "microbatches": int(s.microbatches),
            "recompute": bool(s.recompute), "schedule": str(s.schedule),
        },
    }
    if path:
        with open(path, "w") as f:
            json.dump(cfg, f, indent=1)
            f.write("\n")
    return cfg


def train_argv(cfg: Dict) -> List[str]:
    """The exact `repro_torch.launch.train` argv a config maps to."""
    argv = [
        "--arch", str(cfg["arch"]),
        "--steps", str(int(cfg["steps"])),
        "--batch", str(int(cfg["batch"])),
        "--seq", str(int(cfg["seq"])),
        "--data", str(int(cfg["data"])),
        "--model", str(int(cfg["model"])),
        "--microbatches", str(int(cfg["microbatches"])),
    ]
    if cfg.get("reduced"):
        argv.append("--reduced")
    return argv


def load_train_config(path_or_str: str) -> Dict:
    if path_or_str.lstrip().startswith("{"):
        cfg = json.loads(path_or_str)
    else:
        with open(path_or_str) as f:
            cfg = json.load(f)
    v = cfg.get("version", EXPORT_VERSION)
    if v != EXPORT_VERSION:
        raise ValueError(f"train-config version {v!r} unsupported (this "
                         f"build reads version {EXPORT_VERSION})")
    return cfg


def validate_train_config(cfg: Dict, reduced: Optional[bool] = None
                          ) -> Tuple[bool, str]:
    """Acceptance gate for an exported config: (ok, reason).

    Checks, in order: the arch resolves; the batch arithmetic divides
    (dp | batch, microbatches | per-dp examples); and the
    `repro_torch.dist` rule engine can instantiate `param_specs`/`batch_specs` for the
    arch's real parameter shapes on the (dp, tp) mesh
    (`oracle.check_strategy` — reasons come back "dist_<verdict>").
    `reduced` overrides the config's flag (validate the CI-sized variant
    of a full-size export without re-exporting)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.dist import oracle

    arch = cfg.get("arch")
    if arch not in ARCH_IDS:
        return False, "unknown_arch"
    dp, tp, mb = int(cfg["data"]), int(cfg["model"]), int(cfg["microbatches"])
    batch, seq = int(cfg["batch"]), int(cfg["seq"])
    if min(dp, tp, mb, batch, seq, int(cfg["steps"])) < 1:
        return False, "non_positive_axis"
    if batch % dp:
        return False, "dp_batch_divide"
    if (batch // dp) % mb:
        return False, "microbatch_divide"
    use_reduced = cfg.get("reduced", False) if reduced is None else reduced
    mcfg = reduced_config(arch) if use_reduced else get_config(arch)
    ep = int(cfg.get("strategy", {}).get("ep", 1))
    ok, why = oracle.check_strategy(mcfg, tp, dp, ep, batch=batch, seq=seq)
    if not ok:
        return False, f"dist_{why}"
    return True, ""


__all__ = ["EXPORT_VERSION", "export_train_config", "load_train_config",
           "train_argv", "validate_train_config"]
