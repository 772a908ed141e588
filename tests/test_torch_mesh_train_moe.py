"""Five steps of reduced mixtral-8x7b across a 2x2 ("data", "model") mesh on
torch's threaded process group against `repro`'s unsharded train step:
attention heads and experts over "model", the MoE routing global on every
rank, the dispatch buffer's capacity over "data"; the checks and
tolerances of `tests/test_torch_mesh_train.py`, whose harness this file
uses. Its batches (4 x 128 tokens) pass the capacity, and the mesh run
drops the same (token, choice) pairs as the unsharded run.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_mesh_train import check_five_steps  # noqa: E402


def test_moe_mesh_training_matches_repro_with_the_same_drops():
    assert check_five_steps("mixtral-8x7b", batch=4, seq=128) > 0   # the capacity binds
