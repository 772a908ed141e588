"""The port's sharding rule engine (`repro_torch.dist.sharding`) against
`repro.dist.sharding` on the arch x mesh and arch x shape cells of
tests/test_sharding.py: `param_specs` on the port's own shape tree (the
model built on the meta device, `oracle.param_shapes`), which must equal
`jax.eval_shape(init_params)`'s, and `cache_specs` / `batch_specs` on
`repro`'s abstract shapes (the engine reads `.shape` and `.ndim` only).
Specs are compared as tuples. Plus the rule engine's three documented
fallbacks, and the spec type itself."""
import jax
import pytest
from jax.sharding import PartitionSpec as JP

pytest.importorskip("torch")

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_shape as j_get_shape  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.runtime import Runtime as JRuntime  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import oracle  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402

SINGLE = oracle.ShimMesh({"data": 16, "model": 16})
MULTI = oracle.ShimMesh({"pod": 2, "data": 16, "model": 16})


def _flat(tree, leaf):
    """{dotted path: leaf(x)} over a nested dict tree."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        else:
            out[prefix[:-1]] = leaf(node)

    walk(tree, "")
    return out


def _as_tuple(spec):
    assert isinstance(spec, (sh.PartitionSpec, JP)), spec
    return tuple(spec)


def _j_params(arch):
    return jax.eval_shape(lambda k: JM.init_params(k, j_get_config(arch)),
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh", [SINGLE, MULTI], ids=["pod1", "pod2"])
def test_param_specs_equal_repro(arch, mesh):
    j_sds = _j_params(arch)
    t_sds = oracle.param_shapes(get_config(arch))
    assert _flat(t_sds, lambda s: s.shape) == _flat(j_sds, lambda s: tuple(s.shape))
    got = _flat(sh.param_specs(mesh, t_sds), _as_tuple)
    want = _flat(jsh.param_specs(mesh, j_sds), _as_tuple)
    assert got == want
    assert any("model" in str(s) for s in got.values())
    opt = sh.opt_state_specs(mesh, None, sh.param_specs(mesh, t_sds))
    assert opt["step"] == () and _flat(opt["m"], _as_tuple) == want


_CACHE_CELLS = [(a, s) for a in ARCH_IDS for s in ("decode_32k", "long_500k")
                if s == "decode_32k" or j_get_config(a).subquadratic]


@pytest.mark.parametrize("arch,shape_id", _CACHE_CELLS)
def test_cache_and_batch_specs_equal_repro(arch, shape_id):
    """Every cell tests/test_sharding.py runs (long_500k only for the
    subquadratic archs); the batch of that shape on both meshes."""
    shape = j_get_shape(shape_id)
    j_sds = jax.eval_shape(lambda: JM.init_cache(
        j_get_config(arch), JRuntime(), shape.global_batch, shape.seq_len))
    for mesh in (SINGLE, MULTI):
        got = _flat(sh.cache_specs(mesh, j_sds), _as_tuple)
        assert got == _flat(jsh.cache_specs(mesh, j_sds), _as_tuple)
        batch = {"tokens": jax.ShapeDtypeStruct((shape.global_batch, shape.seq_len), "int32"),
                 "labels": sh.ShapeStruct((shape.global_batch, shape.seq_len))}
        got_b = _flat(sh.batch_specs(mesh, batch), _as_tuple)
        assert got_b == _flat(jsh.batch_specs(mesh, batch), _as_tuple)


def test_tp_within_expert_fallback():
    """8 experts cannot shard over a 16-wide model axis: EP falls back to
    TP-within-expert (F over model, D over data), as in `repro`."""
    specs = sh.param_specs(SINGLE, oracle.param_shapes(get_config("mixtral-8x7b")))
    wi = specs["layers"]["moe"]["wi"]           # (L, E, D, F)
    assert wi == (None, None, "data", "model")
    assert tuple(wi) == tuple(jsh.param_specs(SINGLE, _j_params("mixtral-8x7b"))
                              ["layers"]["moe"]["wi"])
    four = oracle.ShimMesh({"data": 2, "model": 4})   # 4 divides E = 8: EP
    assert sh.param_specs(four, oracle.param_shapes(get_config("mixtral-8x7b"))
                          )["layers"]["moe"]["wi"] == (None, "model", "data", None)


def test_seq_sharding_for_batch1_cache():
    """long_500k (B=1): the sequence dim spreads over data+model."""
    j_sds = jax.eval_shape(lambda: JM.init_cache(
        j_get_config("gemma3-4b"), JRuntime(), 1, 524288))
    specs = sh.cache_specs(SINGLE, j_sds)
    k = specs["attn"]["k"]                      # (L, B, W, Hkv, hd)
    assert k[1] is None and k[2] == ("data", "model")
    assert specs["attn"]["kv_pos"] == (k[0], k[1], k[2])


def test_vocab_not_divisible_falls_back():
    """whisper's vocab 51865 is odd: embed keeps the vocab dim whole."""
    specs = sh.param_specs(SINGLE, oracle.param_shapes(get_config("whisper-small")))
    assert specs["embed"] == (None, "data")
    smol = sh.param_specs(SINGLE, oracle.param_shapes(get_config("smollm-135m")))
    assert smol["embed"] == ("model", "data")


def test_spec_type_and_trees():
    p = sh.PartitionSpec(None, "data", ("pod", "data"))
    assert p == (None, "data", ("pod", "data")) and len(p) == 3
    assert repr(p).startswith("PartitionSpec(") and hash(p) == hash(tuple(p))
    s = sh.ShapeStruct([4, 6])
    assert s.shape == (4, 6) and s.ndim == 2
    tree = {"b": [s, None, (s,)], "a": s}
    specs = sh.batch_specs(oracle.ShimMesh({"data": 2, "model": 3}), tree)
    assert specs["b"][1] is None and isinstance(specs["b"][2], tuple)
    assert sh.tree_leaves(specs) == [("data", None)] * 3
    assert sh.dp_axes(MULTI) == ("pod", "data") and sh.dp_axes(SINGLE) == "data"
    assert sh.dp_axes(oracle.ShimMesh({"model": 2})) is None
