"""Mesh-aware sharding rule engine (the port of `repro.dist.sharding`).

Produces `PartitionSpec` trees for params, optimizer state, KV/SSM caches
and input batches across every assigned arch, on both production mesh
geometries (single pod ("data", "model") and multi-pod ("pod", "data",
"model")). Rules are name-based (leaf key + path context), shape-agnostic
to leading stack dims, and *divisibility-guarded*: an axis is only ever
assigned to a dim it divides, so every emitted spec is legal by
construction. Documented fallbacks:

  * expert parallelism -> TP-within-expert when num_experts does not divide
    the model axis (E dim replicated, F sharded over "model", D over dp);
  * vocab dims stay replicated when the vocab does not divide "model"
    (whisper's 51865);
  * batch-1 long-context caches sequence-shard over every mesh axis
    (("data", "model") on a single pod) because neither batch nor the
    narrow-GQA head dim can take an axis.

The mesh argument of the rules is duck-typed: only `.shape` (a mapping axis
-> size) and `.axis_names` are read, so callers pass a shim
(`oracle.ShimMesh`) instead of building devices; a torch `DeviceMesh` with
named dims is read through `mesh_axes` as well. Leaves are anything with `.shape` and `.ndim`: meta
tensors, `ShapeStruct`, or another framework's shape structs. Trees are
`repro`'s layout: nested dicts (lists and tuples too), with each stacked
layer group's leaves carrying the layer axis first; the rules index dims
from the end, so they hold for stacked and unstacked leaves alike.

What differs from `repro`: `PartitionSpec` is the port's own immutable
tuple of per-dim entries (None, an axis name, or a tuple of names), equal
to the tuple of its entries. A spec becomes DTensor placements over a
`DeviceMesh` (`to_placements`: one placement per mesh dim, `Shard(d)` on
every mesh dim that an entry of dim d names, else `Replicate()`); an entry
naming several axes, such as ("pod", "data"), shards its dim over them in
mesh order, mesh dim 0 outermost, which is `NamedSharding`'s pod-major
order. `to_shardings` pairs each spec with the mesh (`NamedSharding`) and
`distribute_tree` lays a tree of tensors out by a spec tree. `repro`'s
trees stack each layer group on a leading axis that no rule shards; the
port's model holds one module per layer, so a layer's parameter takes its
stacked leaf's spec without the leading entry (`model_param_specs`).
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple, Union

# data-parallel mesh axes in mesh order (pod-major)
DP_AXES = ("pod", "data")

# column-parallel matmuls (..., D_in, D_out): out dim over "model", in over dp
_COL_PARALLEL = {"wq", "wk", "wv", "wi", "wg", "in_proj"}
# row-parallel matmuls (..., D_in, D_out): in dim over "model", out over dp
_ROW_PARALLEL = {"wo", "out_proj"}
# vectors whose last dim follows the "model" (TP) sharding of their matmul
_VEC_MODEL = {"bq", "bk", "bv", "conv_b", "A_log", "D", "dt_bias", "norm"}
# KV-cache-like leaves laid out (L, B, W, H_kv, hd)
_KV_LEAVES = {"k", "v", "cross_k", "cross_v"}


class PartitionSpec(tuple):
    """Per-dim mesh-axis assignment: each entry is None (replicated), an
    axis name, or a tuple of axis names. Immutable; equal to the tuple of
    its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


class ShapeStruct:
    """A leaf that has a shape and nothing else (no storage)."""

    __slots__ = ("shape",)

    def __init__(self, shape: Sequence[int]):
        self.shape = tuple(int(s) for s in shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self) -> str:
        return f"ShapeStruct({self.shape})"


def _map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()):
    """`jax.tree_util.tree_map_with_path` over dicts, lists and tuples:
    path entries are dict keys and sequence indices as strings; None is an
    empty subtree and stays None; anything else is a leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        out = [_map_with_path(fn, v, path + (str(i),))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(path, tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree (specs are leaves), dict keys in sorted order
    as `jax.tree_util.tree_leaves` gives them."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


class _Axes:
    """A mesh read by the rules: `.shape` maps axis -> size."""

    def __init__(self, sizes: Dict[str, int]):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis: size} of a torch `DeviceMesh` (named dims) or of a rule mesh."""
    if hasattr(mesh, "axis_names"):
        return {a: int(mesh.shape[a]) for a in mesh.axis_names}
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def data_axes(sizes: Dict[str, int]) -> Tuple[Tuple[str, ...], int]:
    """The data-parallel axes of {axis: size} in mesh order, and the
    product of their sizes."""
    dp = tuple(a for a in DP_AXES if a in sizes)
    n = 1
    for a in dp:
        n *= sizes[a]
    return dp, n


def batch_entry(sizes: Dict[str, int], B: int):
    """The activation rules' batch entry for a batch of B: the data axes
    when their product (above 1) divides B, else None (replicated)."""
    dp, n = data_axes(sizes)
    return dp if n > 1 and B % n == 0 else None


def _rules_mesh(mesh):
    return mesh if hasattr(mesh, "axis_names") else _Axes(mesh_axes(mesh))


def _mesh_dp(mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes, in mesh (pod-major) order."""
    return tuple(a for a in DP_AXES if a in mesh.axis_names)


def dp_axes(mesh) -> Union[str, Tuple[str, ...], None]:
    """The mesh's data-parallel axes ("data", or ("pod", "data"))."""
    axes = _mesh_dp(_rules_mesh(mesh))
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


class _SpecBuilder:
    """Accumulates per-dim axis assignments under the two legality rules:
    each mesh axis at most once per spec, axis product divides the dim."""

    def __init__(self, mesh, shape: Sequence[int]):
        self.mesh = _rules_mesh(mesh)
        self.shape = tuple(int(s) for s in shape)
        self.entries: list = [None] * len(self.shape)
        self.used: set = set()

    def assign(self, dim: int, axes) -> bool:
        if axes is None or not -len(self.shape) <= dim < len(self.shape):
            return False                # scalar leaves stay replicated
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in axes
                     if a in self.mesh.axis_names and a not in self.used)
        if not axes:
            return False
        size = 1
        for a in axes:
            size *= int(self.mesh.shape[a])
        if dim < 0:
            dim += len(self.shape)
        if self.entries[dim] is not None or self.shape[dim] % size != 0:
            return False
        self.entries[dim] = axes[0] if len(axes) == 1 else axes
        self.used.update(axes)
        return True

    def assign_dp(self, dim: int) -> bool:
        """Shard `dim` over the dp axes, widest divisible subset first."""
        dp = _mesh_dp(self.mesh)
        if self.assign(dim, dp):
            return True
        for a in reversed(dp):          # prefer the wider "data" axis
            if self.assign(dim, a):
                return True
        return False

    def assign_seq(self, dim: int) -> bool:
        """Spread `dim` over every remaining mesh axis (dp + model),
        shrinking the axis set until one divides."""
        dp = _mesh_dp(self.mesh)
        candidates = [dp + ("model",)]
        candidates += [dp, ("model",)]
        candidates += [(a,) for a in reversed(dp)]
        for axes in candidates:
            if axes and self.assign(dim, axes):
                return True
        return False

    def spec(self) -> PartitionSpec:
        return PartitionSpec(*self.entries)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _param_spec_one(mesh, path: Tuple[str, ...], sds) -> PartitionSpec:
    name = path[-1]
    b = _SpecBuilder(mesh, sds.shape)
    if name == "embed":                       # (V, D)
        b.assign(0, "model")                  # vocab TP; replicated if odd
        b.assign_dp(1)
    elif name == "unembed":                   # (D, V)
        b.assign(1, "model")
        b.assign_dp(0)
    elif "moe" in path:
        if name == "router":                  # (..., D, E)
            b.assign(-1, "model")             # only when E divides (rare)
            b.assign_dp(-2)
        elif name in ("wi", "wg"):            # (..., E, D, F)
            if b.assign(-3, "model"):         # expert parallelism
                b.assign_dp(-2)
            else:                             # EP illegal: TP-within-expert
                b.assign(-1, "model")
                b.assign_dp(-2)
        elif name == "wo":                    # (..., E, F, D)
            if b.assign(-3, "model"):
                b.assign_dp(-1)
            else:
                b.assign(-2, "model")
                b.assign_dp(-1)
    elif name in _COL_PARALLEL and sds.ndim >= 2:
        b.assign(-1, "model")
        b.assign_dp(-2)
    elif name in _ROW_PARALLEL and sds.ndim >= 2:
        b.assign(-2, "model")
        b.assign_dp(-1)
    elif name == "conv_w":                    # (..., K, ch)
        b.assign(-1, "model")
    elif name in _VEC_MODEL:
        b.assign(-1, "model")
    # everything else (norm gains, final_ln, ...) stays replicated
    return b.spec()


def param_specs(mesh, params_sds):
    """PartitionSpec tree matching the structure of a params tree in
    `repro`'s layout (shapes only: `oracle.param_shapes` builds one from
    the port's model on the meta device). The legacy-vs-head-TP SSM
    variants share this weight layout."""
    return _map_with_path(
        lambda path, sds: _param_spec_one(mesh, path, sds), params_sds)


def opt_state_specs(mesh, opt_sds, param_spec_tree):
    """Adam m/v mirror the param sharding; the step counter is replicated.
    `opt_sds` is accepted for signature symmetry and may be None."""
    del opt_sds
    return {"step": PartitionSpec(), "m": param_spec_tree,
            "v": param_spec_tree}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _cache_spec_one(mesh, path: Tuple[str, ...], sds) -> PartitionSpec:
    name = path[-1]
    b = _SpecBuilder(mesh, sds.shape)
    if name in _KV_LEAVES:                    # (L, B, W, H_kv, hd)
        batch_ok = b.assign_dp(1)
        head_ok = b.assign(3, "model")
        if not batch_ok and not head_ok:
            b.assign_seq(2)                   # B=1 long context: seq-shard
        elif not head_ok:
            b.assign(2, "model")              # narrow GQA: seq takes model
        elif not batch_ok:
            b.assign_seq(2)
    elif name == "kv_pos":                    # (L, B, W)
        # fallback only: cache_specs overwrites this with the sibling k's
        # (L, B, W) layout so mask reads never reshard against the cache
        if not b.assign_dp(1):
            b.assign_seq(2)
    elif name == "conv":                      # (L, B, K-1, ch)
        b.assign_dp(1)
        b.assign(-1, "model")
    elif name == "ssd":                       # (L, B, H, P, N)
        b.assign_dp(1)
        b.assign(2, "model")
    return b.spec()


def cache_specs(mesh, cache_sds):
    """PartitionSpec tree for a cache tree: batch over dp when divisible,
    KV heads over "model" when divisible, sequence over whatever is left
    (everything, for batch-1 long-context caches). `kv_pos` always mirrors
    its sibling `k`'s (L, B, W) layout — a divergent kv_pos would cost an
    all-gather per decode step when the mask meets the scores."""
    specs = _map_with_path(
        lambda path, sds: _cache_spec_one(mesh, path, sds), cache_sds)

    def align(node):
        if isinstance(node, dict):
            if _is_spec(node.get("kv_pos")) and _is_spec(node.get("k")):
                k = node["k"]
                node["kv_pos"] = PartitionSpec(k[0], k[1], k[2])
            for child in node.values():
                align(child)

    align(specs)
    return specs


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def batch_specs(mesh, batch_sds):
    """Inputs shard their leading batch dim over the dp axes (replicated
    when the batch is too small, e.g. batch-1 long-context decode)."""
    def one(_path, sds):
        b = _SpecBuilder(mesh, sds.shape)
        b.assign_dp(0)
        return b.spec()
    return _map_with_path(one, batch_sds)


# ---------------------------------------------------------------------------
# spec tree -> DTensor placements over a DeviceMesh
# ---------------------------------------------------------------------------


def to_placements(mesh, spec) -> tuple:
    """A spec -> the tuple of DTensor placements over `mesh` (a
    `DeviceMesh` with named dims), one per mesh dim. An entry that names
    several axes must name them in mesh order: DTensor nests repeated
    `Shard(d)` with mesh dim 0 outermost, as `NamedSharding` does."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in ((entry,) if isinstance(entry, str) else entry)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {entry} are not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


class NamedSharding:
    """A spec on a mesh (`jax.sharding.NamedSharding`'s pair), with the
    DTensor placements it stands for."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec
        self.placements = to_placements(mesh, spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec}, {self.placements})"


def to_shardings(mesh, spec_tree):
    """PartitionSpec tree (or single spec) -> `NamedSharding` tree."""
    if _is_spec(spec_tree):
        return NamedSharding(mesh, spec_tree)
    return _map_with_path(lambda _p, s: NamedSharding(mesh, s), spec_tree)


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(specs):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def distribute_tree(mesh, tree, spec_tree):
    """Each tensor (or numpy array) leaf of `tree` -> a DTensor laid out by
    its spec in `spec_tree` (specs or `NamedSharding`s); an `nn.Parameter`
    stays a parameter. Every rank holds the whole leaf (the same seed, the
    same checkpoint), so each keeps its own shard and nothing is sent."""
    import numpy as np
    import torch
    from torch import nn
    from torch.distributed.tensor import distribute_tensor

    def one(leaf, spec):
        pl = spec.placements if isinstance(spec, NamedSharding) else to_placements(mesh, spec)
        t = torch.as_tensor(np.asarray(leaf)) if not isinstance(leaf, torch.Tensor) else leaf
        out = distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)
        if isinstance(leaf, nn.Parameter):
            return nn.Parameter(out, requires_grad=leaf.requires_grad)
        return out
    return _zip_map(one, tree, spec_tree)


def layer_path(name: str) -> Tuple[str, ...]:
    """A port parameter name -> its leaf's path in `repro`'s tree: the layer
    index of a stacked group dropped ("layers.3.attn.wq" -> ("layers",
    "attn", "wq"), "layers.ssm_layers.0.in_proj" -> ("layers",
    "ssm_layers", "in_proj"))."""
    return tuple(part for part in name.split(".") if not part.isdigit())


def model_param_specs(mesh, model) -> Dict[str, PartitionSpec]:
    """{parameter name: spec} for the port's model (one module per layer):
    each layer's parameter gets its stacked leaf's spec less the layer
    axis, which the rules, indexing dims from the end, never shard."""
    return {name: _param_spec_one(mesh, layer_path(name), p)
            for name, p in model.named_parameters()}


def distribute_model(model, mesh):
    """Replace every parameter of `model` by a DTensor parameter laid out
    by `model_param_specs`, in place; returns the model."""
    specs = model_param_specs(mesh, model)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        setattr(mod, leaf, distribute_tree(mesh, p, specs[name]))
    return model


__all__ = ["DP_AXES", "NamedSharding", "PartitionSpec", "ShapeStruct",
           "batch_entry", "batch_specs", "cache_specs", "data_axes", "distribute_model",
           "distribute_tree", "dp_axes", "layer_path", "mesh_axes",
           "model_param_specs", "opt_state_specs", "param_specs",
           "to_placements", "to_shardings", "tree_leaves"]
