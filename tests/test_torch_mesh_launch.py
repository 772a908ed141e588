"""The training launcher across a 2x2 ("data", "model") mesh on the CPU:
`python -m repro_torch.launch.train --reduced --data 2 --model 2 --device
cpu` spawns four gloo processes (the only test of the mesh that spawns).

  * its bf16 losses stay within 2e-2 of the same run on one device in bf16
    (the launcher computes in bf16 on a mesh, as `repro`'s does);
  * with `--fail-at` it rolls back to its checkpoint and resumes bit for
    bit: every step's loss, grad norm and lr equal an uninterrupted run's;
  * its checkpoints (rank 0 writes every leaf gathered) are `repro`'s
    format: `repro`'s `restore_latest` reads them, with `repro`'s tree
    structure and shapes.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.runtime import Runtime  # noqa: E402

ARGS = ["--reduced", "--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "32",
        "--ckpt-every", "2", "--log-every", "1"]


def _series(out):
    return [(m["step"], m["loss"], m["grad_norm"], m["lr"]) for m in out["metrics"]]


def test_mesh_launcher_trains_resumes_and_writes_repros_checkpoints(tmp_path):
    failed = launch_train.main(ARGS + ["--data", "2", "--model", "2", "--fail-at", "3",
                                       "--ckpt-dir", str(tmp_path / "a")])
    clean = launch_train.main(ARGS + ["--data", "2", "--model", "2",
                                      "--ckpt-dir", str(tmp_path / "b")])
    assert failed["restarts"] == 1 and clean["restarts"] == 0
    assert [m["step"] for m in failed["metrics"]] == [0, 1, 2, 3]
    assert _series(failed) == _series(clean)                # bit for bit

    args = launch_train._parser().parse_args(ARGS + ["--ckpt-dir", str(tmp_path / "c"),
                                                     "--ckpt-every", "0"])
    one = launch_train.train_rank(args, rt=Runtime(device="cpu", compute_dtype=torch.bfloat16,
                                                   remat="none"))
    ours = np.array([m["loss"] for m in clean["metrics"]])
    ref = np.array([m["loss"] for m in one["metrics"]])
    assert np.abs(ours - ref).max() <= 2e-2

    restored = jax_ckpt.restore_latest(str(tmp_path / "a"))
    assert restored is not None
    params, opt, meta = restored
    assert meta["step"] == 4 and int(opt["step"]) == 4
    want = jax.eval_shape(lambda k: jax_model.init_params(k, jax_reduced_config("smollm-135m")),
                          jax.random.PRNGKey(0))
    assert jax.tree.structure(params) == jax.tree.structure(want)
    assert jax.tree.structure(opt["m"]) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == np.float32


def test_mesh_launcher_refuses_what_it_cannot_run(monkeypatch):
    with pytest.raises(SystemExit, match="NCCL refuses two ranks on one device"):
        launch_train.main(["--reduced", "--device", "cpu", "--data", "2", "--model", "2",
                           "--backend", "nccl"])
    monkeypatch.setenv("WORLD_SIZE", "8")
    with pytest.raises(SystemExit, match="multi-host launch is not supported"):
        launch_train.main(["--reduced", "--device", "cpu", "--data", "2", "--model", "2"])


def test_mesh_launcher_refuses_gloo_on_the_card():
    """Gloo processes sharing a card die with SIGSEGV in torch's functional
    all-gather (scripts/mesh_backend_probe.py --functional): the launcher
    refuses the pair before it starts a process or touches a card, and
    names the backend that works."""
    with pytest.raises(SystemExit, match=r"functional all-gather.*--backend threaded"):
        launch_train.main(["--reduced", "--device", "cuda", "--data", "2", "--model", "2",
                           "--backend", "gloo", "--steps", "1"])
