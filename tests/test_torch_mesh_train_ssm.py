"""Five steps of reduced mamba2-370m across a 2x2 ("data", "model") mesh on
torch's threaded process group against `repro`'s unsharded train step: SSD
heads over "model" (K2's plain pair on each rank's heads through
`local_map`), the packed in_proj gathered once per layer, the conv on each
rank's rows; the checks and tolerances of `tests/test_torch_mesh_train.py`,
whose harness this file uses.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_mesh_train import check_five_steps  # noqa: E402


def test_ssm_mesh_training_matches_repro():
    check_five_steps("mamba2-370m")
