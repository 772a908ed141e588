"""The port's campaign CLI (`python -m repro_torch.explore`) and loop on the
CPU, against `repro`'s campaigns run on its NumPy evaluation pipeline
(REPRO_COMPILED_EVAL=0: `repro`'s compiled evaluator does not run on this
JAX). The three shipped specs that need no serving model run to their exact
budgets and evaluate the same designs in the same order with the same
objective values and hypervolume curve as `repro`, bit for bit. (The GP is
float32 in both frameworks; the specs' EHVI margins are wide enough that no
pick flips.) A run resumed from a mid-run checkpoint equals the
uninterrupted one bit for bit. Specs the port cannot run yet (joint mode)
fail at start with the ROADMAP item that brings them."""
import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.evaluator import clear_eval_cache as j_clear  # noqa: E402
from repro.explore import Campaign as JCampaign  # noqa: E402
from repro.explore import CampaignSpec as JSpec  # noqa: E402
from repro_torch.core.evaluator import clear_eval_cache  # noqa: E402
from repro_torch.explore import Campaign, CampaignSpec, ExplorationLoop, unported  # noqa: E402
from repro_torch.explore.__main__ import main  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = os.path.join(ROOT, "examples", "campaigns")
# the shipped specs this slice runs, with ROADMAP's baselines
# (evaluations, hypervolume to 3 decimals)
BASELINES = {"quick_train_mfmobo": (14, 64.819),
             "gpt175b_train_dse": (28, 86.410),
             "smollm_inference_decode": (8, 85.796)}


def _spec_path(name):
    return os.path.join(SPECS, f"{name}.json")


def _hex_trace(tr):
    return ([[float(v).hex() for v in x] for x in tr.xs],
            [[float(a).hex(), float(b).hex()] for a, b in tr.ys],
            [float(h).hex() for h in tr.hv], [str(d) for d in tr.designs])


@pytest.mark.parametrize("name", list(BASELINES))
def test_campaign_matches_repro(name, monkeypatch):
    monkeypatch.setenv("REPRO_COMPILED_EVAL", "0")
    j_clear()
    want = JCampaign(JSpec.from_json(_spec_path(name))).run()
    clear_eval_cache()
    got = Campaign(CampaignSpec.from_json(_spec_path(name)),
                   device="cpu").run()
    n_evals, hv = BASELINES[name]
    assert got.finished and got.n_evals == want.n_evals == n_evals
    assert round(got.hv_final, 3) == hv
    assert _hex_trace(got.trace) == _hex_trace(want.trace)
    assert got.front == want.front
    assert got.stage_cache == want.stage_cache
    assert got.objective_stats == want.objective_stats


@pytest.mark.parametrize("name", ["quick_train_mfmobo",
                                  "smollm_inference_decode"])
def test_resume_is_bit_identical(name, tmp_path):
    spec = CampaignSpec.from_json(_spec_path(name))
    clear_eval_cache()
    full = Campaign(spec, device="cpu").run()
    ckpt = str(tmp_path / "run.ckpt")
    clear_eval_cache()
    part = Campaign(spec, device="cpu").run(checkpoint_path=ckpt,
                                            max_steps=2)
    assert not part.finished
    _, state, _ = ExplorationLoop.load_state(ckpt)
    assert state.steps == 2
    clear_eval_cache()
    resumed = Campaign.resume(ckpt, device="cpu").run(checkpoint_path=ckpt)
    assert resumed.finished and resumed.n_evals == full.n_evals
    assert _hex_trace(resumed.trace) == _hex_trace(full.trace)
    assert resumed.objective_stats == full.objective_stats


def test_cli_runs_resumes_and_writes_results(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    spec = _spec_path("quick_train_mfmobo")
    assert main([spec, "--device", "cpu", "--max-steps", "3",
                 "--checkpoint", "q.ckpt", "--out", "q.json"]) == 0
    assert "unfinished" in capsys.readouterr().out
    with open("q.ckpt", "rb") as f:
        blob = pickle.load(f)
    assert blob["state"].steps == 3
    assert main(["--resume", "q.ckpt", "--device", "cpu",
                 "--out", "q.json"]) == 0
    out = capsys.readouterr().out
    assert "evaluations: 14" in out and "hypervolume: 64.819" in out
    with open("q.json") as f:
        res = json.load(f)
    assert res["finished"] and res["n_evals"] == 14
    assert main(["--validate", spec, os.path.join(
        SPECS, "fleet_quick_grid.json")]) == 0
    assert "SKIP" in capsys.readouterr().out
    assert main(["fleet", os.path.join(SPECS, "fleet_quick_grid.json")]) == 2
    assert "ROADMAP item 8" in capsys.readouterr().err


def test_cli_and_campaign_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        main([_spec_path("smollm_inference_decode")])
    with pytest.raises(RuntimeError, match="no CUDA"):
        Campaign(CampaignSpec.from_json(_spec_path("quick_train_mfmobo")))


@pytest.mark.parametrize("name,item", [
    ("gpt175b_serving_slo", "item 6"), ("gpt175b_hetero_serving", "item 6"),
    ("gpt175b_trace_serving", "item 6"), ("gpt175b_joint_dse", "item 13")])
def test_unported_shipped_specs_fail_at_start(name, item):
    """Only joint mode (ROADMAP item 13) still fails at start; the serving,
    hetero and trace specs (item 6, now ported) start, with their budgets.
    tests/test_torch_serving.py runs them against `repro`."""
    spec = CampaignSpec.from_json(_spec_path(name))
    if item == "item 13":
        assert "item 13" in unported(spec)
        with pytest.raises(NotImplementedError, match=item):
            Campaign(spec, device="cpu")
        return
    assert unported(spec) is None
    c = Campaign(spec, device="cpu")
    assert c.loop.cfg.total_evals() == spec.loop_config().total_evals()
    assert str(c.f0.backend.device) == "cpu" and c.f0.backend.name == "analytical"


@pytest.mark.parametrize("fidelity", [
    {"f0": "gnn", "params_path": "params.pkl"},
    {"f1": "gnn", "params_path": "params.pkl"},
    {"f0": "gnn", "calibrate_on_handover": True,
     "params_path": "params.pkl"}])
def test_gnn_specs_fail_at_start(fidelity, tmp_path, monkeypatch):
    """GNN specs (ROADMAP item 7, now ported) start when `params_path`
    holds `repro`'s params tree with numpy leaves, with the GNN on the
    campaign's device; they fail at start on a missing or non-numpy
    pickle. tests/test_torch_gnn.py runs one against `repro`."""
    from repro_torch.core import noc_gnn
    monkeypatch.chdir(tmp_path)
    with open(_spec_path("quick_train_mfmobo")) as f:
        raw = json.load(f)
    raw["fidelity"].update(fidelity)
    spec = CampaignSpec.from_dict(raw)
    assert unported(spec) is None
    with pytest.raises(FileNotFoundError):
        Campaign(spec, device="cpu")
    with open("params.pkl", "wb") as f:
        pickle.dump(noc_gnn.gnn_params_to_jax(noc_gnn.init_gnn(0, device="cpu")), f)
    c = Campaign(spec, device="cpu")
    gnn = c.f0 if raw["fidelity"]["f0"] == "gnn" else c.f1
    assert gnn.backend.name == "gnn" and str(gnn.backend.device) == "cpu"
    assert noc_gnn.params_device(gnn.gnn_params()).type == "cpu"
    assert (c.calibrator is not None) == bool(fidelity.get("calibrate_on_handover"))
    with open("params.pkl", "wb") as f:
        pickle.dump({"node_enc": []}, f)
    with pytest.raises(ValueError, match="GNN params"):
        Campaign(spec, device="cpu")
    with open("params.pkl", "wb") as f:
        pickle.dump({"node_enc": object()}, f)
    with pytest.raises(TypeError, match="numpy leaves only"):
        Campaign(spec, device="cpu")


def test_gnn_backend_and_serving_entry_points_name_their_items():
    """The GNN backend and the serving entry points run (ROADMAP items 7
    and 6); the joint entry points still name item 13."""
    from repro_torch.core import evaluator, fidelity
    from repro_torch.core.design_space import WSCDesign
    from repro_torch.core.validator import validate, validate_joint_batch
    from repro_torch.core.workload import GPT_BENCHMARKS
    d = validate(WSCDesign()).design
    clear_eval_cache()
    g = fidelity.GNNBackend(device="cpu").evaluate_batch(
        fidelity.DesignBatch.from_designs([d]), GPT_BENCHMARKS[0], np.ones(1, np.int64), 6)
    a = fidelity.AnalyticalBackend(device="cpu").evaluate_batch(
        fidelity.DesignBatch.from_designs([d]), GPT_BENCHMARKS[0], np.ones(1, np.int64), 6)
    assert (g[0].feasible, g[0].throughput) == (a[0].feasible, a[0].throughput)
    assert evaluator.evaluate_serving_batch([], None, None, None) == []
    assert evaluator.evaluate_trace_serving_batch([], None, None) == []
    with pytest.raises(NotImplementedError, match="item 13"):
        evaluator.evaluate_joint_batch([], None)
    assert validate_joint_batch([], None) == []
