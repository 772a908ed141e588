"""Five steps of reduced zamba2-1.2b across a 2x2 ("data", "model") mesh on
torch's threaded process group against `repro`'s unsharded train step: SSD
heads over "model" in the SSM layers, the shared attention block's heads
over "model"; the checks and tolerances of `tests/test_torch_mesh_train.py`,
whose harness this file uses.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_mesh_train import check_five_steps  # noqa: E402


def test_hybrid_mesh_training_matches_repro():
    check_five_steps("zamba2-1.2b")
