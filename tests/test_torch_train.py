"""The port's training stack against `repro`'s, on the CPU: optimizer,
data, the train step over reduced smollm-135m, mamba2-370m and zamba2-1.2b
(the SSD scan's backward is the plain `ssd_chunked_bwd_ref` through
`SSDScanFn`), remat of the decoder, SSM and hybrid stacks, checkpoints both
ways, the fault-tolerant launcher and serving from a checkpoint.

Inputs are numpy from a seed (weights drawn in `init_params`' tree and
carried over by `params_from_jax`; `MarkovLMDataset` batches), handed to
both packages. `repro`'s train step is jitted without a mesh (its launcher
raises `ShardingTypeError` on a 1-device mesh on this JAX, which is why
tests/test_launch_smoke.py fails; the port's launcher is held to that
test's contract instead).

Tolerances: the schedule, the norm and the lr within 1e-6 relative, and
clipped gradients, AdamW's params and moments within 1e-6 of each leaf's
largest magnitude (fp32 arithmetic in the same order; `pow`, `cos` and the
sums of squares may differ in the last bit, which `p - lr * u` carries to
entries near 0 as an absolute, not a relative, error). Over 5 train steps, loss and grad norm within 1e-5
relative, the final params within rtol 2e-4, atol 2e-5 at the optimizer
setting and tolerance of `repro`'s own
test_microbatch_accumulation_matches_full_batch (peak_lr 1e-3 behind 100
warmup steps, no clipping, no decay): the backward sums in other orders.
At the launcher's learning rate (3e-3 after 2 warmup steps) the same 5
steps hold loss and grad norm to 1e-5, but not every parameter to that
tolerance: an entry whose gradient is fp32 cancellation noise (~1e-6 of
the largest, so its value differs between the two programs) gets Adam's
normalised update of up to +-lr either way. There, fewer than 1e-4 of the
entries may leave the tolerance, and none by more than 2 * sum(lr). Data, checkpoint round trips and the launcher's resume: bit
for bit.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.dist.fault import StragglerPolicy as JaxStragglerPolicy  # noqa: E402
from repro.launch import serve as jax_launch_serve  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.runtime import CPU_TEST as JAX_CPU_TEST  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro.train import data as jax_data  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro.train.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.dist.fault import StragglerPolicy  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import hybrid, mamba2, transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.models.model import Model, loss_fn  # noqa: E402
from repro_torch.models.runtime import CPU_TEST  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import data  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train.train_step import make_eval_step, make_train_step  # noqa: E402

ARCH = "smollm-135m"
OPT = dict(peak_lr=3e-3, warmup_steps=2, total_steps=5)           # the launcher's shape
OPT_REPRO_TEST = dict(peak_lr=1e-3, clip_norm=1e9, weight_decay=0.0)   # repro's own test
SEQ, BATCH = 32, 4


def _params_np(arch=ARCH, seed=1):
    """`repro`'s param tree of the reduced arch, drawn with numpy: normal
    times the fan-in scale, 0.02 for the embeddings, 0.1 for the norms'
    gains (which init_params sets to zero) and for every other 1-D leaf
    (whisper's `enc_ln`), which has no fan-in."""
    jcfg = jax_reduced_config(arch)
    shapes = jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        scale = (0.1 if name.startswith(("ln", "b", "final_ln")) or len(s.shape) == 1
                 else 0.02 if name in ("embed", "unembed") else s.shape[-2] ** -0.5)
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)
    return jcfg, jax.tree_util.tree_map_with_path(draw, shapes)


def _model(params_np, remat="none", arch=ARCH):
    cfg = reduced_config(arch)
    model = Model(cfg, dataclasses.replace(CPU_TEST, remat=remat), seed=None)
    model.load_state_dict(params_from_jax(params_np, cfg))
    return model.requires_grad_(True)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _batch(ds, step):
    b = ds.batch_at(step)
    return {k: jnp.asarray(v) for k, v in b.items()}, {k: torch.from_numpy(v).long()
                                                       for k, v in b.items()}


def _close_trees(ours, theirs, rtol=None, atol=None, rel_to_max=None):
    """Leaf by leaf: allclose(rtol, atol), or |a - b| <= rel_to_max * max|b|."""
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert a.shape == b.shape and a.dtype == b.dtype
        if rel_to_max is None:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)
        else:
            assert _rel(a, b) <= rel_to_max


# --------------------------- optimizer ------------------------------------


def test_lr_schedule_matches_jax():
    for c in (dict(peak_lr=1e-3, warmup_steps=10, total_steps=100),
              dict(peak_lr=3e-3, warmup_steps=5, total_steps=40, min_lr_ratio=0.2)):
        ours = opt_mod.lr_schedule(opt_mod.AdamWConfig(**c))
        theirs = jax_opt.lr_schedule(jax_opt.AdamWConfig(**c))
        for s in range(c["total_steps"] + 3):
            got = ours(torch.tensor(s, dtype=torch.int32))
            want = theirs(jnp.int32(s))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=0)


def _grads_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)


def test_leaf_order_is_jax_tree_leaves_order():
    for arch in (ARCH, "zamba2-1.2b", "whisper-small"):
        cfg = reduced_config(arch)
        names = [n for n, _ in Model(cfg, CPU_TEST, seed=0).named_parameters()]
        groups = opt_mod.leaf_order(names)
        assert sorted(n for g in groups for n in g) == sorted(names)
        # each group, stacked, is one leaf of repro's tree, in its order
        jtree = jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0),
                                                             jax_reduced_config(arch)))
        paths = [".".join(p.key for p in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
        assert len(paths) == len(groups)
        for path, group in zip(paths, groups):
            assert all(n == path or ".".join(p for p in n.split(".") if not p.isdigit()) == path
                       for n in group), (path, group)


def test_clip_and_global_norm_match_jax():
    jcfg, params = _params_np()
    grads = _grads_like(params, 3)
    cfg = reduced_config(ARCH)
    ours = params_from_jax(grads, cfg)
    for max_norm in (1.0, 1e9):
        clipped, norm = opt_mod.clip_by_global_norm(ours, max_norm)
        jclipped, jnorm = jax_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), max_norm)
        np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
        _close_trees(params_to_jax(clipped, cfg), jax.tree.map(np.asarray, jclipped),
                     rel_to_max=1e-6)
    np.testing.assert_allclose(opt_mod.global_norm(ours).item(),
                               float(jax_opt.global_norm(grads)), rtol=1e-6)


def test_adamw_update_matches_jax():
    jcfg, params = _params_np()
    cfg = reduced_config(ARCH)
    c = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=5.0)
    ours = {k: v.clone() for k, v in params_from_jax(params, cfg).items()}
    st = opt_mod.init_opt_state(ours)
    jp, jst = jax.tree.map(jnp.asarray, params), jax_opt.init_opt_state(params)
    for i in range(3):
        grads = _grads_like(params, 10 + i)
        ours, st, m = opt_mod.adamw_update(ours, params_from_jax(grads, cfg), st,
                                           opt_mod.AdamWConfig(**c))
        jp, jst, jm = jax_opt.adamw_update(jp, jax.tree.map(jnp.asarray, grads), jst,
                                           jax_opt.AdamWConfig(**c))
        assert st["step"].dtype == torch.int32 and int(st["step"]) == int(jst["step"]) == i + 1
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-6)
        _close_trees(params_to_jax(ours, cfg), jax.tree.map(np.asarray, jp), rel_to_max=1e-6)
        for key in ("m", "v"):
            _close_trees(params_to_jax(st[key], cfg), jax.tree.map(np.asarray, jst[key]),
                         rel_to_max=1e-6)


def test_adamw_update_in_runs_is_bitwise_one_run(monkeypatch):
    """adamw_update forms its foreach temporaries over runs of at most
    GROUP_ENTRIES entries; runs of a few leaves each (and a leaf larger than
    a run) give the same params, moments and metrics bit for bit as one run
    over the whole tree, fp32 and bf16 gradients."""
    _, params = _params_np()
    cfg = reduced_config(ARCH)
    c = opt_mod.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
    out = {}
    for cap in (1 << 40, 3000):
        monkeypatch.setattr(opt_mod, "GROUP_ENTRIES", cap)
        ours = {k: v.clone() for k, v in params_from_jax(params, cfg).items()}
        st = opt_mod.init_opt_state(ours)
        for i in range(3):
            grads = params_from_jax(_grads_like(params, 20 + i), cfg)
            if i == 1:
                grads = {k: g.bfloat16() for k, g in grads.items()}
            ours, st, m = opt_mod.adamw_update(ours, grads, st, c)
        out[cap] = (ours, st, m)
    assert len(opt_mod._groups(list(ours), ours, 3000)) > 10
    (a, sa, ma), (b, sb, mb) = out.values()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(sa[key][k], sb[key][k]) for key in ("m", "v") for k in a)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


# --------------------------- data -----------------------------------------


def test_data_is_repros_bit_for_bit():
    for kw in (dict(vocab=512, seq_len=32, batch=4, seed=0),
               dict(vocab=64, seq_len=16, batch=3, seed=7, host_id=1, num_hosts=2)):
        ours, theirs = data.MarkovLMDataset(**kw), jax_data.MarkovLMDataset(**kw)
        assert ours.conditional_entropy() == theirs.conditional_entropy()
        for step in (0, 1, 17):
            a, b = ours.batch_at(step), theirs.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    for arch in (ARCH, "whisper-small", "paligemma-3b"):
        shape = ShapeConfig(name="t", seq_len=64, global_batch=2, kind="train")
        a = data.synthetic_batch(np.random.default_rng(5), reduced_config(arch), shape)
        b = jax_data.synthetic_batch(np.random.default_rng(5), jax_reduced_config(arch), shape)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


# --------------------------- the train step -------------------------------


def _markov_batches(cfg):
    ds = data.MarkovLMDataset(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH, seed=0)
    return lambda step: _batch(ds, step)


def _five_steps(remat, microbatches, opt, arch=ARCH, batches=_markov_batches,
                grad_transforms=(None, None), norm_rtol=1e-5):
    """The port's and repro's train steps side by side for 5 steps from the
    same weights and batches (`batches(cfg)(step)` gives repro's and the
    port's batch; MarkovLMDataset's tokens by default), each step with its
    package's `grad_transform` (the port's, repro's); loss and lr within
    1e-5 relative at every step, the grad norm within `norm_rtol`. Returns
    (the port's final params, repro's, the sum of the lr over the steps)."""
    jcfg, params = _params_np(arch)
    model = _model(params, remat, arch)
    cfg = model.cfg
    step = make_train_step(cfg, model.rt, opt_mod.AdamWConfig(**opt), microbatches,
                           grad_transforms[0])
    jstep = jax.jit(jax_make_train_step(jcfg, dataclasses.replace(JAX_CPU_TEST, remat=remat),
                                        jax_opt.AdamWConfig(**opt), microbatches,
                                        grad_transforms[1]))
    st = opt_mod.init_opt_state(dict(model.named_parameters()))
    jp, jst = jax.tree.map(jnp.asarray, params), jax_opt.init_opt_state(params)
    batch_at = batches(cfg)
    lrs = []
    for s in range(5):
        bj, bt = batch_at(s)
        model, st, m = step(model, st, bt)
        jp, jst, jm = jstep(jp, jst, bj)
        for k in ("loss", "grad_norm", "lr"):
            rtol = norm_rtol if k == "grad_norm" else 1e-5
            assert abs(m[k].item() - float(jm[k])) <= rtol * abs(float(jm[k])), (s, k)
        lrs.append(float(jm["lr"]))
    return params_to_jax(model.state_dict(), cfg), jax.tree.map(np.asarray, jp), sum(lrs)


# smollm's cases keep their ids ("none-1", ...); the SSM and hybrid cases
# carry the arch in theirs
FIVE_STEP_CASES = [
    pytest.param(arch, remat, mb, id=f"{remat}-{mb}" if arch == ARCH else f"{arch}-{remat}-{mb}")
    for arch in (ARCH, "mamba2-370m", "zamba2-1.2b")
    for remat in ("none", "block") for mb in (1, 2)]


@pytest.mark.parametrize("arch,remat,microbatches", FIVE_STEP_CASES)
def test_train_step_matches_jax_over_five_steps(arch, remat, microbatches):
    ours, theirs, _ = _five_steps(remat, microbatches, OPT_REPRO_TEST, arch)
    _close_trees(ours, theirs, rtol=2e-4, atol=2e-5)


def test_train_step_at_the_launchers_lr_matches_jax():
    ours, theirs, lr_sum = _five_steps("block", 2, OPT)
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    a = np.concatenate([x.ravel() for x in jax.tree.leaves(ours)])
    b = np.concatenate([x.ravel() for x in jax.tree.leaves(theirs)])
    outside = np.abs(a - b) > 2e-5 + 2e-4 * np.abs(b)
    assert outside.mean() < 1e-4 and np.abs(a - b).max() <= 2 * lr_sum


def test_remat_block_recomputes_each_layer_and_gives_the_same_gradients(monkeypatch):
    _, params = _params_np()
    calls = []
    block = transformer.decoder_block

    def counted(*a, **kw):
        calls.append(1)
        return block(*a, **kw)
    monkeypatch.setattr(transformer, "decoder_block", counted)
    ds = data.MarkovLMDataset(vocab=512, seq_len=SEQ, batch=BATCH, seed=0)
    batch = _batch(ds, 0)[1]
    grads = {}
    for remat in ("none", "block"):
        model = _model(params, remat)
        calls.clear()
        loss, _ = loss_fn(model, batch)
        grads[remat] = torch.autograd.grad(loss, list(model.parameters()))
        assert len(calls) == model.cfg.num_layers * (2 if remat == "block" else 1)
    for a, b in zip(grads["none"], grads["block"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_remat_block_recomputes_each_ssm_layer_not_the_shared_block(monkeypatch, arch):
    """remat "block" on the SSM and hybrid stacks: every SSMBlock runs twice
    (forward and recompute), the hybrid's shared attention block once per
    application (not recomputed, as in repro), and the gradients equal
    remat "none"'s."""
    _, params = _params_np(arch)
    ssm_calls, shared_calls = [], []
    block_forward, attention = mamba2.SSMBlock.forward, hybrid.self_attention

    def counted_block(self, *a, **kw):
        ssm_calls.append(1)
        return block_forward(self, *a, **kw)

    def counted_attention(*a, **kw):
        shared_calls.append(1)
        return attention(*a, **kw)
    monkeypatch.setattr(mamba2.SSMBlock, "forward", counted_block)
    monkeypatch.setattr(hybrid, "self_attention", counted_attention)
    batch = _batch(data.MarkovLMDataset(vocab=256, seq_len=SEQ, batch=BATCH, seed=0), 0)[1]
    grads = {}
    for remat in ("none", "block"):
        model = _model(params, remat, arch)
        ssm_calls.clear()
        shared_calls.clear()
        loss, _ = loss_fn(model, batch)
        grads[remat] = torch.autograd.grad(loss, list(model.parameters()))
        cfg = model.cfg
        assert len(ssm_calls) == cfg.num_layers * (2 if remat == "block" else 1)
        assert len(shared_calls) == (hybrid.n_applications(cfg) if arch == "zamba2-1.2b" else 0)
    for a, b in zip(grads["none"], grads["block"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_model_builds_a_graph_only_when_training():
    model = Model(reduced_config(ARCH), CPU_TEST, seed=0)
    assert not any(p.requires_grad for p in model.parameters())
    batch = _batch(data.MarkovLMDataset(vocab=512, seq_len=8, batch=2), 0)[1]
    assert loss_fn(model, batch)[0].grad_fn is None
    assert make_eval_step(model.cfg, model.rt)(model, batch)["loss"].grad_fn is None
    model.requires_grad_(True)
    assert loss_fn(model, batch)[0].grad_fn is not None
    from repro_torch.models.model import init_cache
    logits, _ = model.prefill(batch["tokens"], init_cache(model.cfg, model.rt, 2, 16))
    assert logits.grad_fn is None


# --------------------------- checkpoints ----------------------------------


def test_port_restores_repro_checkpoint_and_steps_as_repro(tmp_path):
    jcfg, params = _params_np()
    jstep = jax.jit(jax_make_train_step(jcfg, JAX_CPU_TEST, jax_opt.AdamWConfig(**OPT)))
    ds = data.MarkovLMDataset(vocab=jcfg.vocab, seq_len=SEQ, batch=BATCH, seed=0)
    jp, jst, _ = jstep(jax.tree.map(jnp.asarray, params), jax_opt.init_opt_state(params),
                       _batch(ds, 0)[0])
    jax_ckpt.save_checkpoint(str(tmp_path), 1, jp, jst, extra={"run_tag": jcfg.name})
    p_np, o_np, meta = ckpt.restore_latest(str(tmp_path))
    assert meta["step"] == 1
    model = Model(reduced_config(ARCH), CPU_TEST, seed=0).requires_grad_(True)
    st = opt_mod.init_opt_state(dict(model.named_parameters()))
    ckpt.load_state(model, st, p_np, o_np)
    assert int(st["step"]) == 1 and st["step"].dtype == torch.int32
    step = make_train_step(model.cfg, model.rt, opt_mod.AdamWConfig(**OPT))
    bj, bt = _batch(ds, 1)
    model, st, m = step(model, st, bt)
    jp, jst, jm = jstep(jp, jst, bj)
    for k in ("loss", "grad_norm", "lr"):
        assert abs(m[k].item() - float(jm[k])) <= 1e-5 * abs(float(jm[k]))
    _close_trees(params_to_jax(model.state_dict(), model.cfg), jax.tree.map(np.asarray, jp),
                 rtol=2e-4, atol=2e-5)


def test_repro_restores_port_checkpoint_into_its_trees(tmp_path):
    _, params = _params_np()
    model = _model(params)
    st = opt_mod.init_opt_state(dict(model.named_parameters()))
    ds = data.MarkovLMDataset(vocab=model.cfg.vocab, seq_len=SEQ, batch=BATCH, seed=0)
    model, st, _ = make_train_step(model.cfg, model.rt, opt_mod.AdamWConfig(**OPT))(
        model, st, _batch(ds, 0)[1])
    ckpt.save_checkpoint(str(tmp_path), 1, *ckpt.state_trees(model, st))
    p, o, meta = jax_ckpt.restore_latest(str(tmp_path))
    assert meta["step"] == 1
    want_p = jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0),
                                                          jax_reduced_config(ARCH)))
    want_o = jax.eval_shape(jax_opt.init_opt_state, want_p)
    for got, want in ((p, want_p), (o, want_o)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.shape == b.shape and a.dtype == b.dtype
    assert o["step"] == 1
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in params_from_jax(p, model.cfg).items())


@pytest.mark.parametrize("arch", [ARCH, "mixtral-8x7b", "zamba2-1.2b", "whisper-small",
                                  "mamba2-370m"])
def test_params_to_jax_inverts_params_from_jax(arch):
    cfg = reduced_config(arch)
    sd = Model(cfg, CPU_TEST, seed=3).state_dict()
    tree = params_to_jax(sd, cfg)
    want = jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0),
                                                        jax_reduced_config(arch)))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert all(a.shape == b.shape for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)))
    back = params_from_jax(tree, cfg)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)


def test_corrupted_newest_checkpoint_is_quarantined(tmp_path):
    _, params = _params_np()
    model = _model(params)
    st = opt_mod.init_opt_state(dict(model.named_parameters()))
    ckpt.save_checkpoint(str(tmp_path), 2, *ckpt.state_trees(model, st))
    with torch.no_grad():
        model.embed.add_(1.0)
    ckpt.save_checkpoint(str(tmp_path), 4, *ckpt.state_trees(model, st))
    with open(tmp_path / "step_4" / "params.npz", "wb") as f:
        f.write(b"not a zip")
    p, _, meta = ckpt.restore_latest(str(tmp_path))
    assert meta["step"] == 2 and np.array_equal(p["embed"], params["embed"])
    assert os.path.isdir(tmp_path / "step_4.corrupt") and ckpt.list_checkpoints(str(tmp_path)) == [2]


# --------------------------- supervisor and launcher ----------------------


def test_straggler_policy_is_repros():
    durations = [5.0, 1.0, 1.1, 0.9, 1.0, 4.0, 1.2, 3.5, 0.8, 10.0, 1.0]
    ours, theirs = StragglerPolicy(), JaxStragglerPolicy()
    assert [ours.observe(d) for d in durations] == [theirs.observe(d) for d in durations]
    assert ours.slow_steps == theirs.slow_steps > 0 and ours.ema == theirs.ema


LAUNCH = ["--arch", ARCH, "--reduced", "--steps", "8", "--batch", "2", "--seq", "32",
          "--ckpt-every", "3", "--log-every", "100", "--device", "cpu"]


def _resume_contract(tmp_path, launch):
    out = launch_train.main(launch + ["--ckpt-dir", str(tmp_path / "a"), "--fail-at", "5"])
    assert out["restarts"] == 1
    assert [m["step"] for m in out["metrics"]] == list(range(8)), "metric log must be contiguous"
    assert np.isfinite([m["loss"] for m in out["metrics"]]).all()
    assert ckpt.list_checkpoints(str(tmp_path / "a"))[-1] == 8
    clean = launch_train.main(launch + ["--ckpt-dir", str(tmp_path / "b")])
    assert clean["restarts"] == 0
    assert [m["loss"] for m in out["metrics"]] == [m["loss"] for m in clean["metrics"]]
    # a finished run resumes at its final checkpoint and does nothing
    again = launch_train.main(launch + ["--ckpt-dir", str(tmp_path / "b")])
    assert again["metrics"] == [] and again["restarts"] == 0


def test_train_launch_resumes_after_injected_failure(tmp_path):
    """tests/test_launch_smoke.py's contract, on the port; the resumed run's
    final loss equals an uninterrupted run's bit for bit."""
    _resume_contract(tmp_path, LAUNCH)


def test_ssm_train_launch_resumes_after_injected_failure(tmp_path):
    """The same contract for reduced mamba2-370m: the SSD scan's forward and
    backward (the plain pair on the CPU) rerun after the rollback give every
    loss of an uninterrupted run bit for bit; launch/serve.py serves the
    trained checkpoint."""
    _resume_contract(tmp_path, ["--arch", "mamba2-370m"] + LAUNCH[2:])
    served = launch_serve.main(["--arch", "mamba2-370m", "--reduced", "--device", "cpu",
                                "--ckpt-dir", str(tmp_path / "b"), "--requests", "2",
                                "--max-new", "3"])
    assert sorted(served) == [0, 1] and all(len(t) == 3 for t in served.values())


def test_train_launch_without_checkpoints_restarts_from_step_0(tmp_path):
    """`--ckpt-every 0` writes no checkpoint, the final one included; an
    injected failure then rolls back to a fresh init, and every loss still
    equals an uninterrupted run's."""
    launch = LAUNCH[:-6] + ["--ckpt-every", "0", "--log-every", "100", "--device", "cpu"]
    out = launch_train.main(launch + ["--ckpt-dir", str(tmp_path / "a"), "--fail-at", "5"])
    assert out["restarts"] == 1 and [m["step"] for m in out["metrics"]] == list(range(8))
    assert ckpt.list_checkpoints(str(tmp_path / "a")) == []
    clean = launch_train.main(launch + ["--ckpt-dir", str(tmp_path / "b")])
    assert [m["loss"] for m in out["metrics"]] == [m["loss"] for m in clean["metrics"]]
    assert ckpt.list_checkpoints(str(tmp_path / "b")) == []


def test_train_launch_needs_a_card_and_one_device(monkeypatch, tmp_path):
    # a mesh on the card takes NCCL and one card per rank (the mesh itself
    # is held by tests/test_torch_mesh_launch.py)
    with pytest.raises(SystemExit, match="needs a card per rank"):
        launch_train.main(LAUNCH[:-2] + ["--data", "2", "--ckpt-dir", str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        launch_train.main(LAUNCH[:-2] + ["--ckpt-dir", str(tmp_path)])


def test_serve_restores_a_repro_checkpoint_with_fallback(tmp_path):
    """repro's init_params saved by repro's save_checkpoint: the port's
    engine gives repro's engine's greedy tokens; a corrupted newer
    checkpoint is quarantined and the older one served."""
    jcfg = jax_reduced_config(ARCH)
    params = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    jax_ckpt.save_checkpoint(str(tmp_path), 5, params, jax_opt.init_opt_state(params))
    args = ["--arch", ARCH, "--reduced", "--ckpt-dir", str(tmp_path), "--requests", "3",
            "--max-new", "5"]
    want = jax_launch_serve.main(args)
    assert launch_serve.main(args + ["--device", "cpu"]) == want
    jax_ckpt.save_checkpoint(str(tmp_path), 7, jax.tree.map(jnp.zeros_like, params),
                             jax_opt.init_opt_state(params))
    with open(tmp_path / "step_7" / "opt_state.npz", "wb") as f:
        f.write(b"truncated")
    assert launch_serve.main(args + ["--device", "cpu"]) == want
    assert os.path.isdir(tmp_path / "step_7.corrupt")
