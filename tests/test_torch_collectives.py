"""The port's int8 gradient compression (`repro_torch.dist.collectives`)
against `repro.dist.collectives` on the CPU: the same numpy draws, fp32 and
bf16 leaves, a leaf that turns non-finite, four rounds of error feedback.
q, the scale, the values sent and the residual are held equal bit for bit
(both sides divide by the scale in fp32, round half to even and clip).
Then the properties `repro`'s own tests check
(tests/test_train_substrate.py), and smollm-135m's five train steps with
`grad_transform=int8_compress_decompress` on both sides.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.dist import collectives as jax_col  # noqa: E402
from repro.models.runtime import CPU_TEST as JAX_CPU_TEST  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.dist import collectives as col  # noqa: E402
from repro_torch.models.convert import params_to_jax  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from test_torch_train import (  # noqa: E402
    OPT_REPRO_TEST,
    _five_steps,
    _markov_batches,
    _model,
    _params_np,
)

# name -> (shape, dtype, scale of the draw)
LEAVES = {"w": ((64, 48), "float32", 3.0), "b": ((48,), "float32", 1e-3),
          "h": ((32, 16), "bfloat16", 0.5), "tiny": ((5,), "float32", 1e-35),
          "zero": ((7,), "float32", 0.0)}


def _grads(seed, nonfinite=None):
    """numpy fp32 draws (bf16 leaves rounded to bf16 on both sides), as
    (repro's tree, the port's dict); `nonfinite` puts an inf into that leaf."""
    rng = np.random.default_rng(seed)
    j, t = {}, {}
    for name, (shape, dt, scale) in LEAVES.items():
        a = (scale * rng.standard_normal(shape)).astype(np.float32)
        if name == nonfinite:
            a.flat[3] = np.inf
        j[name] = jnp.asarray(a).astype(dt)
        t[name] = torch.from_numpy(a).to(getattr(torch, dt))
    return j, t


def _bits(x):
    """A tensor's or array's values as fp32 numpy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _same(a, b):
    a, b = _bits(a), _bits(b)
    assert a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("scale", [3.0, 1e-4, 1e4])
def test_quantize_int8_is_repros_bit_for_bit(scale):
    rng = np.random.default_rng(int(scale * 10) % 97)
    x = (scale * rng.standard_normal(4096)).astype(np.float32)
    x[:4] = [0.5, -0.5, 1.5, -2.5]               # halves of the largest's 1/127 steps below
    x[4] = scale * 127 / 2 * 5                   # then amax/127 is the step for them
    for xin, xj in ((torch.from_numpy(x), jnp.asarray(x)),
                    (torch.from_numpy(x).bfloat16(), jnp.asarray(x).astype(jnp.bfloat16))):
        q, s = col.quantize_int8(xin)
        qj, sj = jax_col.quantize_int8(xj)
        assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
        assert np.array_equal(q.numpy(), np.asarray(qj))
        _same(s, sj)
        _same(col.dequantize_int8(q, s), jax_col.dequantize_int8(qj, sj))


def test_round_half_to_even_as_jnp_round():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 127.0])
    q, s = col.quantize_int8(x)
    qj, _ = jax_col.quantize_int8(jnp.asarray(x.numpy()))
    # scale = 127 / 127 = 1 exactly, so x / scale are the halves themselves
    assert s.item() == 1.0
    assert q.tolist() == np.asarray(qj).tolist() == [0, 2, 2, 0, -2, 126, 127]


def test_compress_grads_four_rounds_of_error_feedback_bit_for_bit():
    err_t = err_j = None
    for rnd in range(4):
        gj, gt = _grads(10 + rnd, nonfinite="b" if rnd == 2 else None)
        sent_t, err_t2 = col.compress_grads(gt, err_t)
        sent_j, err_j = jax_col.compress_grads(gj, err_j)
        assert sent_t.keys() == err_t2.keys() == gt.keys()
        for k in gt:
            assert sent_t[k].dtype == gt[k].dtype and err_t2[k].dtype == torch.float32
            _same(sent_t[k], sent_j[k])
            _same(err_t2[k], err_j[k])
        if rnd == 2:
            # the non-finite leaf passes through and keeps its residual
            assert torch.equal(sent_t["b"], gt["b"]) and torch.equal(err_t2["b"], err_t["b"])
        err_t = err_t2
    assert any(err_t[k].abs().max() > 0 for k in err_t)


def test_compress_grads_refuses_another_parameter_sets_residual():
    _, gt = _grads(0)
    _, err = col.compress_grads(gt)
    with pytest.raises(ValueError, match="differ"):
        col.compress_grads({k: v for k, v in gt.items() if k != "w"}, err)


def test_int8_compress_decompress_and_bytes_are_repros():
    gj, gt = _grads(3)
    out_t, out_j = col.int8_compress_decompress(gt), jax_col.int8_compress_decompress(gj)
    for k in gt:
        _same(out_t[k], out_j[k])
    assert col.compressed_bytes(gt) == jax_col.compressed_bytes(gj) == sum(
        int(np.prod(s)) + 4 for s, _, _ in LEAVES.values())


# ---- the properties of tests/test_train_substrate.py, on the port ----------


def test_int8_quantization_roundtrip():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=512) * 3).float()
    q, s = col.quantize_int8(x)
    err = (col.dequantize_int8(q, s) - x).abs().max().item()
    assert err <= s.item() / 2 + 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compression_error_feedback_unbiased(dtype):
    """The sum of compressed gradients over 20 steps tracks the true sum;
    for bf16 gradients the cast's rounding is fed back too."""
    rng = np.random.default_rng(1)
    g_true = torch.from_numpy(rng.normal(size=256).astype(np.float32))
    err, acc, true_acc = None, torch.zeros(256, dtype=torch.float64), torch.zeros(256, dtype=torch.float64)
    for step in range(20):
        g = (g_true * (1 + 0.01 * step)).to(getattr(torch, dtype))
        cg, err = col.compress_grads({"w": g}, err)
        acc += cg["w"].double()
        true_acc += g.double()
    assert ((acc - true_acc).abs().max() / true_acc.abs().max()).item() < 0.02


# ---- the train step with int8 compression ----------------------------------


def test_train_step_with_int8_compression_matches_jax_over_five_steps():
    """smollm-135m reduced, remat "none", one microbatch, both steps with
    their package's int8_compress_decompress, five steps each from its own
    state. Rounding to int8 levels is discontinuous: the two programs' raw
    gradients differ by fp32 noise (2.6e-6 of a leaf's largest at the first
    step), which moves the few entries sitting at a half level to the
    neighbouring level (4 of 344,736 at the first step), and the params
    then differ, so a few hundred entries differ by a level at the later
    steps. Held: the loss and lr within 1e-5 relative at every step, the
    compressed gradients' norm within 1e-4, and no param apart by more than
    2 * sum(lr) (Adam moves an entry by at most about lr a step).
    `test_int8_train_step_from_repros_state_each_step` holds each step
    without that drift."""
    ours, theirs, lr_sum = _five_steps(
        "none", 1, OPT_REPRO_TEST, norm_rtol=1e-4,
        grad_transforms=(col.int8_compress_decompress, jax_col.int8_compress_decompress))
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert np.abs(a - b).max() <= 2 * lr_sum


def test_int8_train_step_from_repros_state_each_step():
    """The same five compressed steps, but before each the port's model and
    optimizer state are set to repro's (checkpoint.load_state): each step
    starts from the same state, so only that step's level flips differ.
    Loss and lr within 1e-5 relative, the grad norm within 1e-4 (one entry
    a level apart moves it by about |g| * scale / norm, up to 1e-4 of it
    here), the new params within rtol 2e-4 / atol 2e-5 but for fewer than
    1e-4 of the entries, none of them by more than 2 * lr."""
    jcfg, params = _params_np()
    model = _model(params)
    cfg = model.cfg
    step = make_train_step(cfg, model.rt, opt_mod.AdamWConfig(**OPT_REPRO_TEST), 1,
                           col.int8_compress_decompress)
    jstep = jax.jit(jax_make_train_step(jcfg, JAX_CPU_TEST,
                                        jax_opt.AdamWConfig(**OPT_REPRO_TEST), 1,
                                        jax_col.int8_compress_decompress))
    st = opt_mod.init_opt_state(dict(model.named_parameters()))
    jp, jst = jax.tree.map(jnp.asarray, params), jax_opt.init_opt_state(params)
    batch_at = _markov_batches(cfg)
    for s in range(5):
        with torch.no_grad():
            ckpt.load_state(model, st, jax.tree.map(np.array, jp),
                            jax.tree.map(np.array, jst))
        bj, bt = batch_at(s)
        model, st, m = step(model, st, bt)
        jp, jst, jm = jstep(jp, jst, bj)
        for k, rtol in (("loss", 1e-5), ("grad_norm", 1e-4), ("lr", 1e-5)):
            assert abs(m[k].item() - float(jm[k])) <= rtol * abs(float(jm[k])), (s, k)
        a = np.concatenate([x.ravel() for x in jax.tree.leaves(
            params_to_jax(model.state_dict(), cfg))])
        b = np.concatenate([np.asarray(x).ravel() for x in jax.tree.leaves(jp)])
        outside = np.abs(a - b) > 2e-5 + 2e-4 * np.abs(b)
        assert outside.mean() < 1e-4 and np.abs(a - b).max() <= 2 * float(jm["lr"]), s
