"""Training across a 2x2 ("data", "model") device mesh against `repro`'s
unsharded train step, on torch's threaded process group (the group DTensor's
own tests use: four ranks as threads of this process, nothing spawned).

Five steps of reduced smollm-135m (9/3 heads do not divide "model" = 2 at
full width; reduced, 3/1: the sequence-parallel q and the replicated-K1
fallback) at fp32 compute (an explicit Runtime, for tight bounds): the
port's parameters, AdamW state and batches are DTensors laid out by
`repro`'s rules, and each step's loss, grad norm and lr, and the final
parameters, are held to `repro`'s jitted `make_train_step` without a mesh
at `tests/test_torch_train.py`'s tolerances (1e-5 relative; params rtol
2e-4, atol 2e-5 at `repro`'s own test's optimizer setting); every rank
issues the same collectives. mamba2-370m, mixtral-8x7b and zamba2-1.2b
take the same checks in `tests/test_torch_mesh_train_ssm.py`, `_moe.py`
and `_hybrid.py` (a file each keeps each file under a minute).

Also `_long_decode_attention` (one token against a W = 65536 cache that
is sharded on its sequence) against `repro`'s with its constraints
replaced by the identity, within 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import attention as j_attention  # noqa: E402
from repro.models.runtime import CPU_TEST as JAX_CPU_TEST  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import CollectiveCounter, make_mesh_shape, run_threaded  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.models.convert import params_to_jax  # noqa: E402
from repro_torch.models.runtime import CPU_TEST  # noqa: E402
from repro_torch.train import data  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from test_torch_train import OPT_REPRO_TEST, _close_trees, _model, _params_np  # noqa: E402


def mesh_runtime(mesh, cfg):
    rt = dataclasses.replace(CPU_TEST, mesh=mesh, mesh_axes=sh.mesh_axes(mesh))
    if cfg.family == "moe":
        rt = dataclasses.replace(rt, moe_buf_spec=sh.PartitionSpec(None, "data", None))
    return rt


def five_steps_on_a_mesh(arch, batch=4, seq=32):
    """repro's 5 unsharded steps and the port's on a 2x2 threaded mesh from
    the same weights and batches; every rank issues the same collectives
    (`CollectiveCounter`). Returns (repro's metrics per step and final
    params, the port's, the port's drops on the mesh and unsharded)."""
    jcfg, params = _params_np(arch)
    ds = data.MarkovLMDataset(vocab=jcfg.vocab, seq_len=seq, batch=batch, seed=0)
    opt = OPT_REPRO_TEST
    jstep = jax.jit(jax_make_train_step(jcfg, JAX_CPU_TEST, jax_opt.AdamWConfig(**opt)))
    jp, jst = jax.tree.map(jnp.asarray, params), jax_opt.init_opt_state(params)
    j_metrics = []
    for s in range(5):
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v) for k, v in ds.batch_at(s).items()})
        j_metrics.append({k: float(jm[k]) for k in ("loss", "grad_norm", "lr")})

    def port(mesh):
        model = _model(params, "none", arch)
        cfg = model.cfg
        if mesh is not None:
            model.rt = mesh_runtime(mesh, cfg)
            sh.distribute_model(model, mesh)
        step = make_train_step(cfg, model.rt, opt_mod.AdamWConfig(**opt))
        st = opt_mod.init_opt_state(dict(model.named_parameters()))
        metrics = []
        for s in range(5):
            b = {k: torch.from_numpy(v).long() for k, v in ds.batch_at(s).items()}
            if mesh is not None:
                b = sh.distribute_tree(mesh, b, sh.batch_specs(mesh, b))
            if s < 4:
                model, st, m = step(model, st, b)
            else:
                with CollectiveCounter() as comm:
                    model, st, m = step(model, st, b)
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
        sd = {n: p.full_tensor() if mesh is not None else p for n, p in model.state_dict().items()}
        return metrics, params_to_jax(sd, cfg), comm.counts

    moe.moe_mlp.dropped = 0
    port(None)
    plain_drops = int(moe.moe_mlp.dropped)
    moe.moe_mlp.dropped = 0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # four ranks of tiny ops: no intra-op pool each
    try:
        outs = run_threaded(4, lambda rank: port(make_mesh_shape((2, 2), ("data", "model"), "cpu")))
    finally:
        torch.set_num_threads(threads)
    mesh_drops = int(moe.moe_mlp.dropped)
    # every rank issues the same collectives (the last step's, by kind)
    assert all(o[2] == outs[0][2] for o in outs) and outs[0][2]
    return (j_metrics, jax.tree.map(np.asarray, jp)), outs[0][:2], (mesh_drops, plain_drops)


def check_five_steps(arch, batch=4, seq=32):
    """five_steps_on_a_mesh's run held to repro's: each step's loss, grad
    norm and lr within 1e-5 relative, the final params within rtol 2e-4,
    atol 2e-5; the mesh run's MoE drops equal the unsharded run's."""
    (j_metrics, j_params), (metrics, params), (mesh_drops, plain_drops) = \
        five_steps_on_a_mesh(arch, batch, seq)
    for s, (ours, theirs) in enumerate(zip(metrics, j_metrics)):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(ours[k] - theirs[k]) <= 1e-5 * abs(theirs[k]), (s, k)
    _close_trees(params, j_params, rtol=2e-4, atol=2e-5)
    assert mesh_drops == plain_drops
    return plain_drops


def test_mesh_training_matches_repro_over_five_steps():
    check_five_steps("smollm-135m")


@pytest.mark.parametrize("n_kv", [2, 1], ids=["kv-heads-over-model", "sequence-over-all"])
@pytest.mark.parametrize("window", [None, 40000])
def test_long_decode_attention_matches_repro(n_kv, window, monkeypatch):
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, spec: x)
    rng = np.random.default_rng(3)
    B, W, Hq, hd = 1, 65536, 4, 8
    q = rng.standard_normal((B, 1, Hq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, W, n_kv, hd)).astype(np.float32) for _ in range(2))
    pos = 50000
    kv_pos = np.where(np.arange(W) <= pos, np.arange(W), -1).astype(np.int32)[None]
    q_pos = np.full((B, 1), pos, np.int32)
    axes = {"data": 2, "model": 2}
    want = np.asarray(j_attention._long_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos), jnp.asarray(kv_pos),
        dataclasses.replace(JAX_CPU_TEST, mesh_axes=axes), window=window))

    def rank(_):
        mesh = make_mesh_shape((2, 2), ("data", "model"), "cpu")
        rt = dataclasses.replace(CPU_TEST, mesh=mesh, mesh_axes=axes)
        rep = sh.PartitionSpec()
        qd, kd, vd, qp, kp = (sh.distribute_tree(mesh, torch.from_numpy(a), rep)
                              for a in (q, k, v, q_pos, kv_pos))
        out = attention._long_decode_attention(qd, kd, vd, qp, kp, rt, window=window)
        return out.full_tensor().numpy()
    got = run_threaded(4, rank)
    for out in got:
        np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)
