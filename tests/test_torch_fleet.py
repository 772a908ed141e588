"""Campaign fleets in the port (`repro_torch.explore.fleet`) on the CPU: the
fleet JSON and grid expansion equal `repro`'s; each of the shipped quick
grid's six campaigns (mfmobo, mobo and random, async_depth 2) run alone
equals `repro`'s run of it on its NumPy evaluation pipeline
(REPRO_COMPILED_EVAL=0) bit for bit; the shipped quick grid
through `python -m repro_torch.explore fleet ... --device cpu` on two
spawned workers finishes 6/6 campaigns with 52 evaluations and no crash,
each front equal to a serial run of the same campaign; a worker killed
mid-campaign is replaced and the campaign resumes from its checkpoint to
the uninterrupted front; `host_devices > 1` is refused with its reason,
and a CUDA fleet gives worker i the card i % device_count."""
import dataclasses
import glob
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.core.evaluator import clear_eval_cache as j_clear  # noqa: E402
from repro.explore import Campaign as JCampaign  # noqa: E402
from repro.explore import CampaignSpec as JSpec  # noqa: E402
from repro.explore.fleet import FleetSpec as JFleetSpec  # noqa: E402
from repro.explore.fleet import expand_grid as j_expand_grid  # noqa: E402
from repro_torch.core.evaluator import clear_eval_cache  # noqa: E402
from repro_torch.explore import (  # noqa: E402
    Campaign, CampaignSpec, FidelitySchedule, FleetSpec, expand_grid, run_fleet)
from repro_torch.explore import fleet as fleet_mod  # noqa: E402
from repro_torch.explore.__main__ import main  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = os.path.join(ROOT, "examples", "campaigns", "fleet_quick_grid.json")


def quick_spec(**over) -> CampaignSpec:
    kw = dict(name="fleet-quick", workload="GPT-1.7B", scenario="train", strategy="mfmobo",
              fidelity=FidelitySchedule(f1="analytical", f0="analytical", d1=2, d0=2, k=2),
              n_evals_f0=5, n_evals_f1=6, q=2, n_candidates=16, max_strategies=6, seed=7)
    kw.update(over)
    return CampaignSpec(**kw)


def _front(res_dict):
    return ([(p["throughput"], p["power_per_wafer"]) for p in res_dict["front"]],
            [float(h).hex() for h in res_dict["hv"]], res_dict["n_evals"])


def _serial(spec):
    clear_eval_cache()
    return _front(Campaign(spec, device="cpu").run().to_dict())


def test_fleet_spec_and_grid_equal_repro(tmp_path):
    """The shipped grid parses to `repro`'s campaigns, round-trips through
    JSON, and `expand_grid` names and orders a workload x strategy x seed
    product as `repro` does; bad specs are refused as in `repro`."""
    fs = FleetSpec.from_json(GRID)
    assert fs.to_dict() == JFleetSpec.from_json(GRID).to_dict()
    assert len(fs.campaigns) == 6 and fs.workers == 2 and fs.compile_cache_dir
    assert FleetSpec.from_json(fs.to_json()) == fs
    path = str(tmp_path / "f.json")
    fs.to_json(path)
    assert FleetSpec.from_json(path) == fs
    grid = {"base": quick_spec().to_dict(), "strategies": ["mfmobo", "random"],
            "seeds": [0, 1], "workloads": ["GPT-1.7B", "GPT-3.6B"]}
    got = [c.to_dict() for c in expand_grid(grid)]
    assert got == [c.to_dict() for c in j_expand_grid(grid)]
    assert len(got) == 8 and len({c["name"] for c in got}) == 8
    with pytest.raises(ValueError, match="unique"):
        FleetSpec(name="d", campaigns=(quick_spec(), quick_spec())).validate()
    with pytest.raises(ValueError, match="no campaigns"):
        FleetSpec(name="e", campaigns=()).validate()
    with pytest.raises(ValueError, match="unknown fleet spec fields"):
        FleetSpec.from_dict({"name": "x", "campaigns": [], "bogus": 1})
    with pytest.raises(ValueError, match="unknown grid fields"):
        expand_grid(dict(grid, extra=1))
    assert JSpec.from_dict(got[0]).to_dict() == got[0]


def _hex_trace(tr):
    return ([[float(v).hex() for v in x] for x in tr.xs],
            [[float(a).hex(), float(b).hex()] for a, b in tr.ys],
            [float(h).hex() for h in tr.hv], [str(d) for d in tr.designs])


@pytest.mark.parametrize("spec", FleetSpec.from_json(GRID).campaigns, ids=lambda c: c.name)
def test_grid_campaign_matches_repro(spec, monkeypatch):
    """Each campaign of the shipped grid, run alone in the port, evaluates
    the same designs with the same objectives, hypervolume curve, front and
    stage cache as `repro`'s campaign of the same spec."""
    monkeypatch.setenv("REPRO_COMPILED_EVAL", "0")
    j_clear()
    want = JCampaign(JSpec.from_dict(spec.to_dict())).run()
    clear_eval_cache()
    got = Campaign(spec, device="cpu").run()
    assert got.finished and got.n_evals == want.n_evals
    assert _hex_trace(got.trace) == _hex_trace(want.trace)
    assert got.front == want.front
    assert got.stage_cache == want.stage_cache
    assert got.objective_stats == want.objective_stats


def test_quick_grid_on_two_workers_equals_serial_runs(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert main(["fleet", GRID, "--device", "cpu", "--out", "r.json"]) == 0
    out = capsys.readouterr().out
    assert "6/6 campaigns on 2 workers" in out and "evaluations: 52" in out
    assert "crashes: 0" in out
    with open("r.json") as f:
        res = json.load(f)
    assert res["n_evals"] == 52 and res["crashes"] == 0 and res["errors"] == []
    assert glob.glob(".fleet/evalcache/seg-*") and glob.glob(".fleet/checkpoints/*.ckpt.pkl")
    specs = FleetSpec.from_json(GRID).campaigns
    for spec, c in zip(specs, res["campaigns"]):
        assert c["spec"]["name"] == spec.name and c["resumed"] is False
        assert c["eval_lanes"]["n_lanes"] == 1 and c["eval_lanes"]["sharded_calls"] == 0
        assert _front(c) == _serial(spec)


def test_killed_worker_resumes_to_identical_front(tmp_path, monkeypatch):
    spec = quick_spec(name="fa", seed=0, async_depth=1)
    ref = _serial(spec)
    fs = FleetSpec(name="t-crash", campaigns=(spec,), workers=1,
                   checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    marker = str(tmp_path / "crashed.marker")
    monkeypatch.setenv(fleet_mod._CRASH_ENV, f"{spec.name}:{marker}")
    res = run_fleet(fs, device="cpu")
    assert os.path.exists(marker), "crash hook never fired"
    assert res.crashes == 1 and res.errors == []
    c = res.campaigns[0]
    assert c["resumed"] is True
    assert _front(c) == ref


def test_host_lanes_are_refused_and_devices_assigned(monkeypatch, tmp_path):
    fs = FleetSpec(name="h", campaigns=(quick_spec(),), host_devices=2)
    with pytest.raises(ValueError, match="one device and has no XLA host lanes"):
        fs.validate()
    with pytest.raises(ValueError, match="host_devices=2"):
        run_fleet(fs, device="cpu")
    ok = dataclasses.replace(fs, host_devices=1, compile_cache_dir=str(tmp_path / "x"))
    assert ok.validate() is ok
    assert fleet_mod._worker_device("cpu", 3) == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert [fleet_mod._worker_device("cuda", i) for i in range(2)] == ["cuda:0", "cuda:0"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [fleet_mod._worker_device("cuda", i) for i in range(3)] == [
        "cuda:0", "cuda:1", "cuda:0"]
    assert fleet_mod._worker_device("cuda:1", 0) == "cuda:1"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        run_fleet(ok)
