"""The port's GNN f0 fidelity on the CPU, against `repro`'s JAX `noc_gnn`.

Both sides run on the same weights: `repro`'s `init_gnn(PRNGKey(k))` with
numpy leaves, carried into the port by `gnn_params_from_jax` (`jax.random`
cannot be reproduced in torch). Held:
  * featurization (`build_calibration_set`, `pad_link_graphs`) equal to
    `repro`'s array for array;
  * the forward, single graph and batched: |Δ logits| <= 1e-5 *
    max(1, |logit|) per edge, and the waits the same in log1p space (the
    random-init logits reach ~150, where one fp32 step is 1.5e-5, and the
    two sides sum in different orders);
  * `train_gnn`: 10 steps on one graph with every loss within 1e-4
    relative of `repro`'s, and a held-out run with the same split, epochs,
    Kendall taus, best and stopped epochs;
  * `kendall_tau` equal, with and without its subsample;
  * `GNNBackend.evaluate_batch` and `chunk_latency` against `repro`'s
    (same feasibility, strategy and wafers; throughput and power within
    1e-5 relative, `tests/test_fidelity.py`'s tolerance);
  * without params, `GNNBackend` gives the analytical result, hex-equal to
    `repro`'s GNN backend without params (the port's counterpart of
    `tests/test_fidelity.py::test_gnn_without_params_degrades_to_analytical`);
  * the `GNNCalibrator` contract of `tests/test_fidelity.py`;
  * an f0 = "gnn" campaign with `calibrate_on_handover` against `repro`'s:
    the exact budget, the same f1 designs, hypervolume within 1e-4
    relative; its resume (before and after the handover) equals the
    uninterrupted run bit for bit;
  * `params_path` pickles: numpy leaves load; a pickle of JAX arrays is
    refused, saying so, without importing JAX.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import calibration as j_cal  # noqa: E402
from repro.core import evaluator as j_ev  # noqa: E402
from repro.core import noc_gnn as J  # noqa: E402
from repro.core.design_space import WSCDesign as JWSCDesign  # noqa: E402
from repro.core.design_space import decode as j_decode  # noqa: E402
from repro.core.validator import validate as j_validate  # noqa: E402
from repro.core.workload import GPT_BENCHMARKS as J_BENCH  # noqa: E402
from repro.explore import Campaign as JCampaign  # noqa: E402
from repro.explore import CampaignSpec as JSpec  # noqa: E402
from repro_torch.core import calibration as cal  # noqa: E402
from repro_torch.core import evaluator as ev  # noqa: E402
from repro_torch.core import noc_gnn as P  # noqa: E402
from repro_torch.core.design_space import WSCDesign, decode  # noqa: E402
from repro_torch.core.fidelity import AnalyticalBackend, GNNBackend  # noqa: E402
from repro_torch.core.validator import validate  # noqa: E402
from repro_torch.core.workload import GPT_BENCHMARKS  # noqa: E402
from repro_torch.explore import Campaign, CampaignSpec, ExplorationLoop  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
LOGIT_TOL = 1e-5            # |Δz| <= LOGIT_TOL * max(1, |z|)
LOSS_RTOL = 1e-4


def _jax_params(k=0):
    return jax.tree.map(np.asarray, J.init_gnn(jax.random.PRNGKey(k)))


@pytest.fixture(scope="module")
def graphs():
    """GPT-1.7B transfer graphs of two valid designs, labeled by the
    simulator: (repro's, the port's)."""
    jd = [j_validate(JWSCDesign()).design, j_validate(JWSCDesign(mac_num=256)).design]
    pd = [validate(WSCDesign()).design, validate(WSCDesign(mac_num=256)).design]
    return (j_cal.build_calibration_set(jd, J_BENCH[0]),
            cal.build_calibration_set(pd, GPT_BENCHMARKS[0]))


def _close_logits(z, zr):
    z, zr = np.asarray(z, np.float64), np.asarray(zr, np.float64)
    assert np.all(np.abs(z - zr) <= LOGIT_TOL * np.maximum(1.0, np.abs(zr)))


def test_featurization_equals_repro(graphs):
    jg, pg = graphs
    assert len(pg) == len(jg) == 20
    for a, b in zip(pg, jg):
        for f in ("node_x", "edge_x", "senders", "receivers", "target"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert a.links == b.links and a.n_nodes == b.n_nodes
    pb, jb = P.pad_link_graphs(pg, with_target=True), J.pad_link_graphs(jg, with_target=True)
    for f in ("node_x", "edge_x", "senders", "receivers", "edge_mask", "n_edges_real",
              "target"):
        assert np.array_equal(getattr(pb, f), getattr(jb, f)), f
    assert pb.n_nodes == jb.n_nodes and [P.next_pow2(n) for n in range(70)] == \
        [J.next_pow2(n) for n in range(70)]


@pytest.mark.parametrize("k", [0, 1, 2])
def test_forward_on_converted_weights_matches_repro(graphs, k):
    jg, pg = graphs
    tree = _jax_params(k)
    pj, pt = J.init_gnn(jax.random.PRNGKey(k)), P.gnn_params_from_jax(tree, device=CPU)
    for g in pg[:: 4]:
        args = (g.node_x, g.edge_x, g.senders, g.receivers)
        zr = J.gnn_logits(pj, *map(jnp.asarray, args), g.n_nodes)
        z = P.gnn_logits(pt, *map(torch.from_numpy, args), g.n_nodes)
        _close_logits(z.numpy(), zr)
        w = P.gnn_forward(pt, *map(torch.from_numpy, args), g.n_nodes).numpy()
        wr = np.asarray(J.gnn_forward(pj, *map(jnp.asarray, args), g.n_nodes))
        _close_logits(np.log1p(w), np.log1p(wr))
    batch = P.pad_link_graphs(pg)
    w, wr = P.gnn_forward_batch(pt, batch), J.gnn_forward_batch(pj, J.pad_link_graphs(jg))
    assert w.shape == wr.shape and w.dtype == np.float32
    real = batch.edge_mask > 0
    _close_logits(np.log1p(w[real]), np.log1p(wr[real]))


def test_params_convert_both_ways_and_share_repros_digest():
    tree = _jax_params(3)
    pt = P.gnn_params_from_jax(tree, device=CPU)
    back = P.gnn_params_to_jax(pt)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(np.array_equal(a, b) and a.dtype == np.float32
               for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)))
    assert ev.gnn_params_digest(pt) == j_ev.gnn_params_digest(tree)
    assert P.gnn_params_on(tree, CPU)["head"][1]["w"].shape == (32, 1)
    assert P.gnn_params_on(pt, CPU) is pt
    # the port's own init: He-normal from a seeded CPU generator
    a, b = P.init_gnn(7, device=CPU), P.init_gnn(7, device=CPU)
    assert all(torch.equal(x, y) for x, y in zip(P._flatten(a), P._flatten(b)))
    assert jax.tree.structure(P.gnn_params_to_jax(a)) == jax.tree.structure(tree)
    assert abs(float(a["update"][0]["w"].std()) - (2 / 96) ** 0.5) < 0.02
    bad = dict(tree, head=[{"w": np.zeros((96, 2), np.float32), "b": tree["head"][0]["b"]},
                           tree["head"][1]])
    with pytest.raises(ValueError, match="shape"):
        P.gnn_params_from_jax(bad, device=CPU)
    with pytest.raises(TypeError, match="numpy"):
        P.gnn_params_from_jax(J.init_gnn(jax.random.PRNGKey(0)), device=CPU)


def test_train_gnn_ten_steps_match_repro(graphs):
    jg, pg = graphs
    tree = _jax_params(0)
    pj, hj = J.train_gnn(J.init_gnn(jax.random.PRNGKey(0)), jg[:1], epochs=10, lr=3e-3)
    pt, ht = P.train_gnn(P.gnn_params_from_jax(tree, device=CPU), pg[:1], epochs=10,
                         lr=3e-3)
    # one graph per epoch: each epoch's loss is one step's
    np.testing.assert_allclose(ht.train_loss, hj.train_loss, rtol=LOSS_RTOL, atol=0)
    assert ht.train_loss[-1] < ht.train_loss[0] and ht.best_epoch == hj.best_epoch == 9
    for a, b in zip(P._flatten(pt), jax.tree.leaves(pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4)
    # the inputs are not modified
    assert all(np.array_equal(a.numpy(), b) for a, b in
               zip(P._flatten(P.gnn_params_from_jax(tree, device=CPU)), jax.tree.leaves(tree)))


def test_train_gnn_held_out_split_and_early_stop_match_repro(graphs):
    jg, pg = graphs
    tree = _jax_params(0)
    kw = dict(epochs=6, lr=3e-3, seed=4, val_frac=0.25, patience=1)
    _, hj = J.train_gnn(J.init_gnn(jax.random.PRNGKey(0)), jg, **kw)
    _, ht = P.train_gnn(P.gnn_params_from_jax(tree, device=CPU), pg, **kw)
    np.testing.assert_allclose(ht.train_loss, hj.train_loss, rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(ht.val_loss, hj.val_loss, rtol=LOSS_RTOL, atol=0)
    assert ht.val_kendall_tau == hj.val_kendall_tau
    assert (ht.best_epoch, ht.stopped_epoch) == (hj.best_epoch, hj.stopped_epoch)
    assert ht.best_val_loss == ht.val_loss[ht.best_epoch]


@pytest.mark.parametrize("n", [40, 3000])
def test_kendall_tau_equals_repro(n):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 12, n).astype(float)          # ties included
    b = a + rng.normal(0, 3, n)
    assert P.kendall_tau(a, b) == J.kendall_tau(a, b)
    assert P.kendall_tau(a[:1], b[:1]) == 0.0


def _designs(n, seed=0):
    rng = np.random.default_rng(seed)
    ours, theirs = [], []
    while len(ours) < n:
        u = rng.random(13)
        r, jr = validate(decode(u)), j_validate(j_decode(u))
        assert r.ok == jr.ok
        if r.ok:
            ours.append(r.design)
            theirs.append(jr.design)
    return ours, theirs


def test_gnn_backend_matches_repro():
    ours, theirs = _designs(4)
    tree = _jax_params(0)
    pt = P.gnn_params_from_jax(tree, device=CPU)
    ev.clear_eval_cache()
    j_ev.clear_eval_cache()
    gnn = GNNBackend(device=CPU)
    got = ev.evaluate_design_batch(ours, GPT_BENCHMARKS[0], fidelity=gnn, gnn_params=pt,
                                   max_strategies=6)
    want = j_ev.evaluate_design_batch(theirs, J_BENCH[0], fidelity="gnn",
                                      gnn_params=J.init_gnn(jax.random.PRNGKey(0)),
                                      max_strategies=6)
    serial = [ev.evaluate_design(d, GPT_BENCHMARKS[0], fidelity=gnn, gnn_params=tree,
                                 max_strategies=6) for d in ours]
    for g, s, w in zip(got, serial, want):
        assert (g.feasible, g.n_wafers, str(g.strategy)) == \
            (w.feasible, w.n_wafers, str(w.strategy))
        assert (s.feasible, str(s.strategy)) == (w.feasible, str(w.strategy))
        if w.feasible:
            for r in (g, s):
                assert np.isclose(r.throughput, w.throughput, rtol=1e-5, atol=0)
                assert np.isclose(r.power_w, w.power_w, rtol=1e-5, atol=0)
    assert any(w.feasible for w in want)


def test_gnn_without_params_is_the_analytical_result(monkeypatch):
    monkeypatch.setenv("REPRO_COMPILED_EVAL", "0")
    ours, theirs = _designs(5, seed=3)
    ev.clear_eval_cache()
    j_ev.clear_eval_cache()
    g = ev.evaluate_design_batch(ours, GPT_BENCHMARKS[0], fidelity=GNNBackend(device=CPU),
                                 max_strategies=6)
    a = ev.evaluate_design_batch(ours, GPT_BENCHMARKS[0],
                                 fidelity=AnalyticalBackend(device=CPU), max_strategies=6)
    jg = j_ev.evaluate_design_batch(theirs, J_BENCH[0], fidelity="gnn", max_strategies=6)

    def key(r):
        return (r.feasible, r.n_wafers, r.strategy and str(r.strategy), float(r.throughput).hex(),
                float(r.power_w).hex())
    assert [key(r) for r in g] == [key(r) for r in a] == [key(r) for r in jg]
    d = validate(WSCDesign()).design
    ev.clear_eval_cache()
    j_ev.clear_eval_cache()
    s = ev.evaluate_design(d, GPT_BENCHMARKS[0], fidelity=GNNBackend(device=CPU),
                           max_strategies=6)
    js = j_ev.evaluate_design(j_validate(JWSCDesign()).design, J_BENCH[0], fidelity="gnn",
                              max_strategies=6)
    assert float(s.throughput).hex() == float(js.throughput).hex()


def test_calibrator_on_handover_finetunes_params():
    wl = GPT_BENCHMARKS[0]
    designs = [validate(WSCDesign()).design, validate(WSCDesign(mac_num=256)).design]
    ys = [(100.0, 5000.0), (120.0, 6000.0)]
    p0 = P.gnn_params_from_jax(_jax_params(1), device=CPU)
    c = cal.GNNCalibrator(p0, wl, n_designs=1, epochs=2, patience=None)
    f0 = c.objectives()
    assert getattr(f0, "batched", False) and f0.fidelity == "gnn"
    c.on_handover(designs, ys)
    assert len(c.records) == 1
    rec = c.records[0]
    assert rec.n_graphs > 0 and len(rec.history.train_loss) > 0
    assert rec.history.val_loss and rec.history.val_kendall_tau
    assert c.params is not p0               # fine-tuned copy
    # fresh params => fresh cache namespace
    assert ev.gnn_params_token(c.params) != ev.gnn_params_token(p0)
    # the picks are repro's
    jd = [j_validate(JWSCDesign(mac_num=2 ** i)).design for i in (6, 7, 8, 9)]
    pd = [validate(WSCDesign(mac_num=2 ** i)).design for i in (6, 7, 8, 9)]
    ys = [(100.0, 5000.0), (200.0, 4000.0), (300.0, 6000.0), (50.0, 1000.0)]
    assert [str(d) for d in cal.pareto_neighborhood(pd, ys, 3)] == \
        [str(d) for d in j_cal.pareto_neighborhood(jd, ys, 3)]


def _gnn_spec(tmp_path):
    path = str(tmp_path / "params.pkl")
    with open(path, "wb") as f:
        pickle.dump(_jax_params(0), f)
    with open(os.path.join(ROOT, "examples", "campaigns", "quick_train_mfmobo.json")) as f:
        raw = json.load(f)
    raw["fidelity"].update({"f0": "gnn", "calibrate_on_handover": True, "params_path": path,
                            "calibration": {"n_designs": 1, "epochs": 2}})
    return raw


def _hex_trace(t):
    return ([[float(v).hex() for v in x] for x in t.xs],
            [[float(a).hex(), float(b).hex()] for a, b in t.ys],
            [float(h).hex() for h in t.hv], [str(d) for d in t.designs])


def test_calibrated_gnn_campaign_matches_repro(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_COMPILED_EVAL", "0")
    raw = _gnn_spec(tmp_path)
    j_ev.clear_eval_cache()
    jc = JCampaign(JSpec.from_dict(raw))
    want = jc.run()
    ev.clear_eval_cache()
    c = Campaign(CampaignSpec.from_dict(raw), device=CPU)
    got = c.run()
    assert got.finished and got.n_evals == want.n_evals == 14
    assert [x.tobytes() for x in c.loop.state.X1] == [x.tobytes() for x in jc.loop.state.X1]
    assert abs(got.hv_final - want.hv_final) <= 1e-4 * want.hv_final
    assert len(got.calibration) == len(want.calibration) == 1
    assert got.calibration[0]["n_graphs"] == want.calibration[0]["n_graphs"]
    assert P.params_device(c.calibrator.params).type == CPU


@pytest.mark.parametrize("stop", [0, 3])
def test_calibrated_gnn_campaign_resume_is_bit_identical(tmp_path, stop):
    spec = CampaignSpec.from_dict(_gnn_spec(tmp_path))
    ev.clear_eval_cache()
    full = Campaign(spec, device=CPU).run()
    ckpt = str(tmp_path / "run.ckpt")
    ev.clear_eval_cache()
    assert not Campaign(spec, device=CPU).run(checkpoint_path=ckpt, max_steps=stop).finished
    _, state, extra = ExplorationLoop.load_state(ckpt)
    # step 0 stops before the handover (the resumed run calibrates), step 3
    # after it (the resumed run reads the calibrated params)
    assert state.steps == stop and state.handover_fired == (stop > 0)
    assert len(extra.get("calibration_records", [])) == (stop > 0)
    assert all(isinstance(a, np.ndarray) for a in jax.tree.leaves(extra["gnn_params"]))
    ev.clear_eval_cache()
    resumed = Campaign.resume(ckpt, device=CPU).run(checkpoint_path=ckpt)
    assert resumed.finished and resumed.n_evals == full.n_evals == 14
    assert _hex_trace(resumed.trace) == _hex_trace(full.trace)
    assert [r["val_kendall_tau"] for r in resumed.calibration] == \
        [r["val_kendall_tau"] for r in full.calibration]


def test_params_path_reads_numpy_leaves_and_refuses_jax_arrays(tmp_path):
    ok, bad = str(tmp_path / "np.pkl"), str(tmp_path / "jax.pkl")
    with open(ok, "wb") as f:
        pickle.dump(_jax_params(0), f)
    with open(bad, "wb") as f:
        pickle.dump(J.init_gnn(jax.random.PRNGKey(0)), f)
    p = P.load_gnn_params(ok, device=CPU)
    assert all(np.array_equal(a.numpy(), b) for a, b in
               zip(P._flatten(p), jax.tree.leaves(_jax_params(0))))
    code = ("import sys\n"
            "from repro_torch.core.noc_gnn import load_gnn_params\n"
            "try:\n"
            f"    load_gnn_params({bad!r}, device='cpu')\n"
            "except TypeError as e:\n"
            "    print('refused:', e)\n"
            "print('jax imported:', any(m.split('.')[0] in ('jax', 'jaxlib') "
            "for m in sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert "refused: the GNN params pickle holds JAX objects" in r.stdout, r.stderr
    assert "numpy leaves only" in r.stdout and "jax imported: False" in r.stdout


def test_gnn_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        P.init_gnn(0)
    with pytest.raises(RuntimeError, match="no CUDA"):
        P.gnn_params_from_jax(_jax_params(0))
    d = validate(WSCDesign()).design
    with pytest.raises(RuntimeError, match="no CUDA"):
        ev.evaluate_design_batch([d], GPT_BENCHMARKS[0], fidelity="gnn",
                                 gnn_params=_jax_params(0), max_strategies=4)
