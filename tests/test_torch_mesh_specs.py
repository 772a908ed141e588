"""The port's device mesh against `repro`'s sharding, on torch's fake process
group (no processes, no collectives: rank 0 of a 512-rank world) and the
meta device (no storage).

For all ten archs on the (2, 2), (16, 16) and (2, 16, 16) meshes:
  * the parameter, optimizer-state, cache and batch trees laid out by
    `to_shardings` / `distribute_tree` carry DTensor placements that read
    back as `repro`'s PartitionSpec for the leaf, and each local shard's
    shape is the spec's per-device shape; an entry naming two axes,
    ("pod", "data"), nests pod-major, as `NamedSharding` does;
  * the port's model, one module per layer (`distribute_model`), gives
    each layer's parameter its stacked leaf's spec less the layer axis;
  * the activation constraints: the specs `repro`'s `_constrain_attn`,
    `_constrain_heads` and MoE buffer constraint impose (recorded by
    replacing `jax.lax.with_sharding_constraint` in this test), against
    the placements the port's `attn_spec`, `heads_spec` and launcher
    runtime choose, over every arch's shapes.

A spec reads back from placements as: dim d's entry is the mesh axes whose
placement is Shard(d), in mesh order (one axis as its name)."""
import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from torch.distributed.tensor import Shard  # noqa: E402
from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro.configs import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models import attention as j_attention  # noqa: E402
from repro.models import mamba2 as j_mamba2  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.runtime import Runtime as JRuntime  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import oracle  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.train import _parser, mesh_runtime  # noqa: E402
from repro_torch.models import attention, mamba2  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.runtime import Runtime  # noqa: E402

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def meshes():
    dist.init_process_group("fake", rank=0, world_size=512, store=FakeStore())
    try:
        yield {k: mesh_mod.make_mesh_shape(shape, axes, "cpu")
               for k, (shape, axes) in MESHES.items()}
    finally:
        dist.destroy_process_group()


def _read_spec(placements, mesh, ndim):
    """DTensor placements -> the PartitionSpec they stand for, as a tuple."""
    names = mesh.mesh_dim_names
    entries = [[] for _ in range(ndim)]
    for name, pl in zip(names, placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(name)
        else:
            assert pl.is_replicate(), pl
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e) for e in entries)


def _norm(spec, ndim):
    """A (repro or port) spec as a tuple of ndim entries."""
    t = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in t)


def _per_device(shape, spec, sizes):
    out = []
    for n, e in zip(shape, _norm(spec, len(shape))):
        for a in (() if e is None else (e,) if isinstance(e, str) else e):
            n //= sizes[a]
        out.append(n)
    return tuple(out)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


def _meta(tree):
    return {k: _meta(v) for k, v in tree.items()} if isinstance(tree, dict) else \
        torch.empty(tuple(tree.shape), device="meta")


def _check_tree(dtensors, repro_specs, mesh):
    """Each DTensor's placements read back as repro's spec; its local shard
    has the spec's per-device shape."""
    sizes = sh.mesh_axes(mesh)
    got, want = _flat(dtensors), _flat(repro_specs)
    assert got.keys() == want.keys()
    for path, dt in got.items():
        spec = _norm(want[path], dt.ndim)
        assert _read_spec(dt.placements, mesh, dt.ndim) == spec, path
        assert tuple(dt.to_local().shape) == _per_device(dt.shape, spec, sizes), path


def _j_params(arch):
    return jax.eval_shape(lambda k: JM.init_params(k, j_get_config(arch)), jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_placements_are_repros_specs(meshes, arch):
    t_sds = oracle.param_shapes(get_config(arch))
    j_sds = _j_params(arch)
    for mesh in meshes.values():
        shim = oracle.ShimMesh(sh.mesh_axes(mesh))
        want = jsh.param_specs(shim, j_sds)
        specs = sh.param_specs(mesh, t_sds)
        params = sh.distribute_tree(mesh, _meta(t_sds), sh.to_shardings(mesh, specs))
        _check_tree(params, jax.tree.map(tuple, want, is_leaf=lambda x: isinstance(x, JP)), mesh)
        opt = sh.distribute_tree(mesh, {"step": torch.empty((), device="meta"),
                                        "m": _meta(t_sds), "v": _meta(t_sds)},
                                 sh.to_shardings(mesh, sh.opt_state_specs(mesh, None, specs)))
        j_opt = jsh.opt_state_specs(shim, None, want)
        _check_tree(opt, jax.tree.map(tuple, j_opt, is_leaf=lambda x: isinstance(x, JP)), mesh)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_layers_take_the_stacked_spec_without_the_layer_axis(meshes, arch):
    cfg = get_config(arch)
    j_flat = _flat(jax.tree.map(tuple, jsh.param_specs(oracle.ShimMesh({"data": 2, "model": 2}),
                                                        _j_params(arch)),
                                is_leaf=lambda x: isinstance(x, JP)))
    mesh = meshes["2x2"]
    model = sh.distribute_model(Model(cfg, Runtime(device="meta")), mesh)
    for name, p in model.named_parameters():
        path = ".".join(sh.layer_path(name))
        stacked = path != name
        want = j_flat[path][1:] if stacked else j_flat[path]
        if stacked:
            assert j_flat[path][0] is None
        assert _read_spec(p.placements, mesh, p.ndim) == _norm(want, p.ndim), name


_CACHE_CELLS = [(a, s) for a in ARCH_IDS for s in ("decode_32k", "long_500k")
                if s == "decode_32k" or j_get_config(a).subquadratic]


@pytest.mark.parametrize("arch,shape_id", _CACHE_CELLS)
def test_cache_and_batch_placements_are_repros_specs(meshes, arch, shape_id):
    shape = SHAPES[shape_id]
    j_sds = jax.eval_shape(lambda: JM.init_cache(j_get_config(arch), JRuntime(),
                                                 shape.global_batch, shape.seq_len))
    t_sds = jax.tree.map(lambda s: sh.ShapeStruct(s.shape), j_sds)
    batch = {"tokens": sh.ShapeStruct((shape.global_batch, shape.seq_len)),
             "labels": sh.ShapeStruct((shape.global_batch, shape.seq_len))}
    for mesh in meshes.values():
        shim = oracle.ShimMesh(sh.mesh_axes(mesh))
        caches = sh.distribute_tree(mesh, _meta(t_sds), sh.cache_specs(mesh, t_sds))
        _check_tree(caches, jax.tree.map(tuple, jsh.cache_specs(shim, j_sds),
                                         is_leaf=lambda x: isinstance(x, JP)), mesh)
        b = sh.distribute_tree(mesh, _meta(batch), sh.batch_specs(mesh, batch))
        j_b = jsh.batch_specs(shim, {k: jax.ShapeDtypeStruct(v.shape, np.int32)
                                     for k, v in batch.items()})
        _check_tree(b, {k: tuple(v) for k, v in j_b.items()}, mesh)


def test_two_axes_on_one_dim_nest_pod_major(meshes):
    """("pod", "data") on dim 0 of a (64, 8) leaf: the rank at (pod p, data
    d, model m) holds rows [(16 p + d) * 2, +2), NamedSharding's order."""
    mesh = meshes["2x16x16"]
    pl = sh.to_placements(mesh, sh.PartitionSpec(("pod", "data"), None))
    assert pl == (Shard(0), Shard(0), pl[2]) and pl[2].is_replicate()
    for p in range(2):
        for d in range(16):
            shape, off = _compute_local_shape_and_global_offset((64, 8), (2, 16, 16), [p, d, 3], pl)
            assert shape == (2, 8) and off == ((16 * p + d) * 2, 0)
    with pytest.raises(ValueError):
        sh.to_placements(mesh, sh.PartitionSpec(("data", "pod"), None))


def test_make_mesh_shape_needs_enough_ranks(meshes):
    with pytest.raises(RuntimeError, match="needs 1024 devices, have 512"):
        mesh_mod.make_mesh_shape((2, 32, 16), ("pod", "data", "model"), "cpu")
    assert meshes["16x16"].mesh_dim_names == ("data", "model")
    assert tuple(meshes["2x16x16"].shape) == (2, 16, 16)


# ------------------------- activation constraints --------------------------


class _Recorder:
    """Stands in for jax.lax.with_sharding_constraint: records each call's
    caller, shape and spec and returns x."""

    def __init__(self):
        self.calls = []

    def __call__(self, x, spec):
        import sys
        self.calls.append((sys._getframe(1).f_code.co_name, tuple(x.shape), tuple(spec)))
        return x


def _attn_shapes(cfg):
    hd = cfg.hd()
    for shape in SHAPES.values():
        S = 1 if shape.kind == "decode" else shape.seq_len
        for B in (shape.global_batch, 1):
            yield (B, S, cfg.n_heads, hd), True
            yield (B, S, cfg.n_kv, hd), False


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_activation_constraints_are_repros(meshes, arch, monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", rec)
    jcfg, cfg = j_get_config(arch), get_config(arch)
    n = 0
    for mesh in meshes.values():
        axes = sh.mesh_axes(mesh)
        jrt = JRuntime(mesh_axes=axes)
        rt = Runtime(device="meta", mesh_axes=axes)
        cases = []
        if cfg.family != "ssm":
            cases += [("_constrain_attn", shape, lambda s, q=q: attention.attn_spec(s, rt, q),
                       lambda s, q=q: j_attention._constrain_attn(
                           jax.ShapeDtypeStruct(s, np.float32), jrt, q))
                      for shape, q in _attn_shapes(cfg)]
        if cfg.ssm is not None:
            s_cfg = cfg.ssm
            H, P = s_cfg.n_heads(cfg.d_model), s_cfg.head_dim
            for sc in SHAPES.values():
                for B in (sc.global_batch, 1):
                    for shape in ((B, sc.seq_len, H, P), (B, sc.seq_len, H)):
                        cases.append(("_constrain_heads", shape,
                                      lambda s: mamba2.heads_spec(s, rt),
                                      lambda s: j_mamba2._constrain_heads(
                                          jax.ShapeDtypeStruct(s, np.float32), jrt)))
        for name, shape, ours, theirs in cases:
            rec.calls.clear()
            theirs(shape)
            assert len(rec.calls) == 1 and rec.calls[0][:2] == (name, shape)
            spec = ours(shape)
            got = _read_spec(sh.to_placements(mesh, spec), mesh, len(shape))
            assert got == _norm(rec.calls[0][2], len(shape)), (name, shape, axes)
            n += 1
        if cfg.family == "moe":
            # repro's dry-run runtime puts the buffer's capacity over the
            # data axes (launch/dryrun.py build_runtime); the port's launcher
            # sets the same spec, and moe_mlp constrains the (E, C, D) slice
            shim = oracle.ShimMesh(axes)
            jrt_moe = JRuntime(compute_dtype=np.float32,
                               moe_buf_spec=JP(None, jsh.dp_axes(shim), None))
            T, D = 512, jcfg.d_model
            rec.calls.clear()
            jax.eval_shape(lambda h, p: j_moe.moe_mlp(h, p, jcfg, jrt_moe),
                           jax.ShapeDtypeStruct((1, T, D), np.float32),
                           jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape[1:], np.float32),
                                        _j_params(arch)["layers"]["moe"]))
            (where, buf_shape, spec), = rec.calls
            assert where == "moe_mlp" and buf_shape[0] == jcfg.moe.num_experts
            args = _parser().parse_args(["--arch", arch])
            ours = mesh_runtime(cfg, args, mesh).moe_buf_spec
            got = _read_spec(sh.to_placements(mesh, ours), mesh, 3)
            assert got == _norm(spec, 3)
            n += 1
    assert n > 0
