"""The port's GPipe schedule (`repro_torch.train.pipeline`) against
`repro.train.pipeline` on the CPU, at tests/test_pipeline.py's cases and
tolerances: the same numpy draws through both packages' `pipeline_apply`
(outputs within 1e-5), the gradients by autograd against `jax.grad` and
against the sequential application (within rtol 1e-4, atol 1e-5), and
`split_stages`' shapes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.train import pipeline as jax_pipeline  # noqa: E402
from repro_torch.train.pipeline import gpipe, pipeline_apply, split_stages  # noqa: E402


def _block(p_l, x):
    return torch.tanh(x @ p_l["w"] + p_l["b"])


def _jblock(p_l, x):
    return jnp.tanh(x @ p_l["w"] + p_l["b"])


def _make(L=8, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (0.3 * rng.standard_normal((L, d, d))).astype(np.float32),
            "b": (0.1 * rng.standard_normal((L, d))).astype(np.float32)}


def _torch(tree, grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(grad) for k, v in tree.items()}


def _sequential(params, x):
    for layer in range(params["w"].shape[0]):
        x = _block({k: v[layer] for k, v in params.items()}, x)
    return x


@pytest.mark.parametrize("stages,mbs", [(2, 4), (4, 6), (8, 3), (1, 1), (4, 12)])
def test_pipeline_matches_repros_and_sequential(stages, mbs):
    L, d, B = 8, 16, 12
    params = _make(L, d)
    x = np.random.default_rng(1).standard_normal((B, d)).astype(np.float32)
    out = pipeline_apply(_torch(params), torch.from_numpy(x), _block, L, stages, mbs)
    ref = jax_pipeline.pipeline_apply({k: jnp.asarray(v) for k, v in params.items()},
                                      jnp.asarray(x), _jblock, L, stages, mbs)
    seq = _sequential(_torch(params), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), seq.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stages,mbs", [(2, 4), (4, 8)])
def test_pipeline_gradients_match_jax_grad(stages, mbs):
    L, d, B = 4 if stages == 2 else 8, 8, 8
    params = _make(L, d, seed=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, d)).astype(np.float32)
    tgt = rng.standard_normal((B, d)).astype(np.float32)

    def jloss(p):
        out = jax_pipeline.pipeline_apply(p, jnp.asarray(x), _jblock, L, stages, mbs)
        return jnp.mean((out - tgt) ** 2)
    g_jax = jax.grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})
    grads = {}
    for name, fn in (("pipe", lambda p, xt: pipeline_apply(p, xt, _block, L, stages, mbs)),
                     ("seq", _sequential)):
        p = _torch(params, grad=True)
        loss = ((fn(p, torch.from_numpy(x)) - torch.from_numpy(tgt)) ** 2).mean()
        grads[name] = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    for k in params:
        np.testing.assert_allclose(grads["pipe"][k].numpy(), np.asarray(g_jax[k]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(grads["pipe"][k].numpy(), grads["seq"][k].numpy(),
                                   rtol=1e-4, atol=1e-5)
        assert grads["pipe"][k].abs().max() > 0


def test_gpipe_drains_each_microbatch_in_order():
    """stage s adds 10^s: every microbatch leaves the last of 3 stages with
    111 added, in microbatch order."""
    x = torch.arange(5.0).reshape(5, 1, 1)
    stage = {"add": torch.tensor([[1.0], [10.0], [100.0]])}
    out = gpipe(stage, x, lambda p, xc: xc + p["add"][0], 3)
    assert out.flatten().tolist() == [111.0, 112.0, 113.0, 114.0, 115.0]


def test_split_stages_shapes():
    params = _torch(_make(8, 4))
    st = split_stages(params, 8, 4)
    assert st["w"].shape == (4, 2, 4, 4)
    assert st["b"].shape == (4, 2, 4)
    jst = jax_pipeline.split_stages({k: jnp.asarray(v.numpy()) for k, v in params.items()}, 8, 4)
    assert all(np.array_equal(st[k].numpy(), np.asarray(jst[k])) for k in st)
    with pytest.raises(ValueError):
        split_stages(params, 8, 3)
