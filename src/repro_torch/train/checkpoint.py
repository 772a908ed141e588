"""Fault-tolerant checkpointing in `repro.train.checkpoint`'s format:
atomic write (tmp + rename), latest-valid resume, corrupted-checkpoint
quarantine. Nested-dict trees of arrays are stored as one .npz with
"\\x1f"-joined key paths, plus meta.json; no pickle.

The files hold `repro`'s trees, so each package restores the other's
checkpoints: `state_trees` turns the port's model and optimizer state into
`repro`'s param tree and opt state (`models.convert.params_to_jax`: layer
groups stacked on axis 0), and `load_state` copies such trees back into
them in place (`params_from_jax`).

Under a device mesh the live state is DTensors: `state_trees` gathers
each leaf (`full_tensor()`, a collective every rank joins in the same
order) and only the first rank keeps the host copies and writes;
`load_state` copies trees that `dist.sharding.distribute_tree` laid out by
`repro`'s specs into the live DTensors shard by shard.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.convert import params_from_jax, params_to_jax

_SEP = "\x1f"          # unit separator: never appears in our dict keys
_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree, prefix=()) -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
    elif isinstance(tree, torch.Tensor):
        out[_SEP.join(prefix)] = tree.detach().cpu().numpy()
    else:
        out[_SEP.join(prefix)] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    root: Dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state,
                    extra: Optional[Dict] = None) -> str:
    """Atomic: writes into step_<n>.tmp then renames to step_<n>. params and
    opt_state are trees (nested dicts) of numpy arrays or tensors."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "params.npz"), **_flatten(params))
    np.savez(os.path.join(tmp, "opt_state.npz"), **_flatten(opt_state))
    meta = {"step": step, "time": time.time(), **(extra or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def list_checkpoints(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.isdir(os.path.join(ckpt_dir, name)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def _load_dir(path: str) -> Tuple[Dict, Dict, Dict]:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "params.npz")) as z:
        params = _unflatten({k: z[k] for k in z.files})
    with np.load(os.path.join(path, "opt_state.npz")) as z:
        opt = _unflatten({k: z[k] for k in z.files})
    return params, opt, meta


def restore_latest(ckpt_dir: str, quarantine: bool = True
                   ) -> Optional[Tuple[Dict, Dict, Dict]]:
    """Restore the newest valid checkpoint as numpy trees (params, opt_state,
    meta); corrupted ones are renamed to *.corrupt and skipped
    (node-failure recovery path)."""
    for step in reversed(list_checkpoints(ckpt_dir)):
        path = os.path.join(ckpt_dir, f"step_{step}")
        try:
            return _load_dir(path)
        except Exception:
            if quarantine:
                dst = path + ".corrupt"
                if os.path.exists(dst):
                    shutil.rmtree(dst)
                os.replace(path, dst)
    return None


def to_device(tree, device) -> Dict:
    """numpy tree -> the same tree of tensors on `device` (dtypes kept)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree)).to(device)


def is_writer() -> bool:
    """True unless this is a rank other than 0 of a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _gathered(t: torch.Tensor) -> Optional[torch.Tensor]:
    """A DTensor leaf gathered whole (every rank takes part), on the host
    of the writing rank only; a plain leaf as it is."""
    if not isinstance(t, DTensor):
        return t
    full = t.full_tensor()
    return full.cpu() if is_writer() else None


def state_trees(model, opt_state: Dict) -> Optional[Tuple[Dict, Dict]]:
    """(params, opt_state) as `repro`'s trees with numpy leaves: the param
    tree, and {"step": int32, "m": tree, "v": tree}. DTensor state is
    gathered leaf by leaf; ranks other than the writer get None."""
    cfg = model.cfg
    sd = {n: _gathered(t) for n, t in model.state_dict().items()}
    m, v = ({n: _gathered(t) for n, t in opt_state[k].items()} for k in ("m", "v"))
    step = _gathered(opt_state["step"])
    if not is_writer():
        return None
    return params_to_jax(sd, cfg), {
        "step": step.detach().cpu().numpy(),
        "m": params_to_jax(m, cfg),
        "v": params_to_jax(v, cfg)}


@torch.no_grad()
def load_state(model, opt_state: Dict, params_tree: Dict, opt_tree: Dict) -> None:
    """Copy `repro`-structured trees (numpy or tensor leaves) into `model`
    and `opt_state` in place, on their own device."""
    cfg = model.cfg
    model.load_state_dict(params_from_jax(params_tree, cfg))
    for key in ("m", "v"):
        for name, t in params_from_jax(opt_tree[key], cfg).items():
            opt_state[key][name].copy_(t)
    step = torch.as_tensor(opt_tree["step"])
    if isinstance(step, DTensor) and not isinstance(opt_state["step"], DTensor):
        step = step.to_local()          # replicated: every rank's copy is whole
    opt_state["step"].copy_(step)
