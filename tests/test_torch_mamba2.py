"""One Mamba-2 block of the port against `repro.models.mamba2` on the same
(converted) weights, in fp32 on the CPU, and the full-width mamba2-370m
built on the meta device against the JAX param tree's names and shapes.

Tolerance: 1e-4 abs and rel on fp32 activations of magnitude ~1 (the two
frameworks sum in different orders).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import mamba2 as jax_mamba2  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.runtime import CPU_TEST as JAX_CPU_TEST  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.mamba2 import SSMBlock  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.runtime import CPU_TEST, Runtime  # noqa: E402

TOL = 1e-4
CHUNK = 8
# the JAX block functions, jitted (cfg and rt static): eager dispatch of the
# reference on the CPU is slower than compiling it
_prefill_j = jax.jit(jax_mamba2.ssm_block_prefill, static_argnums=(2, 3))
_forward_j = jax.jit(jax_mamba2.ssm_block, static_argnums=(2, 3))
_decode_j = jax.jit(jax_mamba2.ssm_block_decode, static_argnums=(2, 3))


@pytest.fixture(scope="module")
def block():
    """(jax cfg, jax layer-0 params, port block with the same weights)."""
    jcfg = jax_reduced_config("mamba2-370m")
    params = jax.jit(jax_model.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    layers_np = {k: np.asarray(v) for k, v in params["layers"].items()}
    p0 = {k: v[0] for k, v in params["layers"].items()}
    blk = SSMBlock(reduced_config("mamba2-370m"), device="cpu").requires_grad_(False)
    blk.load_state_dict({k: torch.from_numpy(v[0].copy()) for k, v in layers_np.items()})
    return jcfg, p0, blk


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def test_reduced_and_full_configs_match_jax():
    for arch_cfg, jax_cfg in ((reduced_config("mamba2-370m"), jax_reduced_config("mamba2-370m")),
                              (get_config("mamba2-370m"), jax_get_config("mamba2-370m"))):
        for f in dataclasses.fields(arch_cfg):
            if f.name != "ssm":
                assert getattr(arch_cfg, f.name) == getattr(jax_cfg, f.name), f.name
        assert dataclasses.asdict(arch_cfg.ssm) == dataclasses.asdict(jax_cfg.ssm)


@pytest.mark.parametrize("S", [21, 2, 16])
def test_block_prefill_and_decode_match_jax(block, S):
    """S=21 is ragged over three chunks of 8; S=2 is shorter than the conv
    tail (K-1=3) and takes the cache-splice branch; S=16 divides evenly."""
    jcfg, p0, blk = block
    rt_j = dataclasses.replace(JAX_CPU_TEST, ssd_chunk=CHUNK)
    rt = dataclasses.replace(CPU_TEST, ssd_chunk=CHUNK)
    rng = np.random.default_rng(S)
    B, D = 2, jcfg.d_model
    K, C = jcfg.ssm.conv_width, jcfg.ssm.d_inner(D) + 2 * jcfg.ssm.state_dim
    H, P, N = jcfg.ssm.n_heads(D), jcfg.ssm.head_dim, jcfg.ssm.state_dim
    x = rng.standard_normal((B, S, D), dtype=np.float32)
    conv0 = rng.standard_normal((B, K - 1, C), dtype=np.float32)
    cache_j = {"conv": jax.numpy.asarray(conv0),
               "ssd": jax.numpy.zeros((B, H, P, N), jax.numpy.float32)}

    out_j, c_j = _prefill_j(jax.numpy.asarray(x), p0, jcfg, rt_j, cache_j)
    out, conv, ssd = blk.prefill(torch.from_numpy(x), rt, torch.from_numpy(conv0))
    _close(out, out_j)
    _close(conv, c_j["conv"])
    _close(ssd, c_j["ssd"])

    fwd_j = _forward_j(jax.numpy.asarray(x), p0, jcfg, rt_j)
    _close(blk(torch.from_numpy(x), rt), fwd_j)

    x1 = rng.standard_normal((B, 1, D), dtype=np.float32)
    dout_j, dc_j = _decode_j(jax.numpy.asarray(x1), p0, jcfg, rt_j, c_j)
    dout, dconv, dssd = blk.decode(torch.from_numpy(x1), rt, conv, ssd)
    _close(dout, dout_j)
    _close(dconv, dc_j["conv"])
    _close(dssd, dc_j["ssd"])


def test_full_width_meta_model_matches_jax_param_tree():
    """mamba2-370m at full width, without allocating: the port's names and
    shapes after params_from_jax equal jax.eval_shape(init_params)."""
    jcfg = jax_get_config("mamba2-370m")
    shapes = jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0), jcfg))
    # zero-stride stand-ins: no memory behind the full-size leaves
    stand_in = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    cfg = get_config("mamba2-370m")
    sd = params_from_jax(stand_in, cfg)
    model = Model(cfg, Runtime(device="meta"))
    assert all(p.is_meta for p in model.parameters())
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    L = cfg.num_layers
    for name, leaf in shapes["layers"].items():
        assert leaf.shape == (L, *want[f"layers.0.{name}"])
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    n_port = sum(p.numel() for p in model.parameters())
    assert n_jax == n_port == cfg.param_count() == 368_338_432
    model.load_state_dict(sd, strict=True, assign=True)
