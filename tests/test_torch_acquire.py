"""The port's greedy q-EHVI acquire (`repro_torch.core.mfmobo`) against
`repro`'s NumPy oracle `gp_ref.acquire_batch_ref` and its scanned JAX
acquire, on the CPU: identical picks for q in {1, 2, 4} (as in
tests/test_compiled_optimizer.py), across training-set sizes on both sides
of a buffer bucket. The picks stay on the device until read, and a
checkpointed loop state holds no tensor."""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.mfmobo as JM  # noqa: E402
from repro.core.gp_ref import NumpyGP, acquire_batch_ref  # noqa: E402
import repro_torch.core.mfmobo as M  # noqa: E402
from repro_torch.core.design_space import DIMS  # noqa: E402
from repro_torch.explore.runner import ExplorationLoop, LoopConfig  # noqa: E402


def _problem(seed, n, c=40):
    rng = np.random.default_rng(seed)
    d = len(DIMS)
    X = rng.random((n, d))
    Y = np.stack([1e3 * (1 + rng.random(n)), 1e3 * (2 + rng.random(n))], 1)
    return X, Y, M.obj_space([tuple(y) for y in Y]), rng.random((c, d))


@pytest.mark.parametrize("n", [5, 9, 14])
@pytest.mark.parametrize("q", [1, 2, 4])
def test_acquire_batch_matches_reference(q, n):
    X, Y, ev, cand = _problem(7 + q + 100 * n, n)
    ref = M.hv_ref(15000.0)
    models = M._fit_models(X, Y, device="cpu")
    js = M._acquire_batch(models, cand, ev, ref, q=q)
    ref_models = [NumpyGP.fit(X, np.log1p(np.maximum(Y[:, 0], 0.0))),
                  NumpyGP.fit(X, -np.log(np.maximum(Y[:, 1], 1.0)))]
    assert js == acquire_batch_ref(ref_models, cand, ev, ref, q=q)
    assert js == JM._acquire_batch(JM._fit_models(X, Y), cand, ev, ref, q=q)
    assert len(set(js)) == q


def test_acquire_device_returns_q_picks_on_the_models_device():
    X, Y, ev, cand = _problem(3, 9)
    models = M._fit_models(X, Y, device="cpu")
    js = M._acquire_batch_device(models, cand, ev, M.hv_ref(15000.0), q=3)
    assert isinstance(js, torch.Tensor) and js.shape == (3,)
    assert js.dtype == torch.int64 and js.device.type == "cpu"
    assert js.tolist() == M._acquire_batch(models, cand, ev,
                                           M.hv_ref(15000.0), q=3)
    # q is clamped to the pool; q=1 is the scalar EHVI argmax
    assert len(M._acquire_batch(models, cand[:2], ev, M.hv_ref(15000.0),
                                q=5)) == 2
    assert M._acquire(models, cand, ev, M.hv_ref(15000.0)) == js[0].item()


def test_warm_optimizer_kernels_memoizes():
    assert M.warm_optimizer_kernels(n_candidates=16, q=2, device="cpu") == 1
    assert M.warm_optimizer_kernels(n_candidates=16, q=2, device="cpu") == 0
    assert M.warm_optimizer_kernels(n_candidates=16, q=2, device="cpu",
                                    force=True) == 1


def _walk(o, seen=None):
    seen = seen if seen is not None else set()
    if id(o) in seen:
        return
    seen.add(id(o))
    assert not isinstance(o, torch.Tensor), f"tensor in state: {o!r}"
    if isinstance(o, dict):
        for v in o.values():
            _walk(v, seen)
    elif isinstance(o, (list, tuple, set)):
        for v in o:
            _walk(v, seen)
    elif hasattr(o, "__dict__"):
        for v in vars(o).values():
            _walk(v, seen)


@pytest.mark.parametrize("strategy", ["mobo", "mfmobo"])
def test_loop_state_pickle_holds_no_tensor(strategy):
    def f(d):
        return (1e3 + d.mac_num, 5e2 + d.buffer_kb)

    cfg = LoopConfig(strategy=strategy, N0=6, N1=6, d0=3, d1=3, k=1, q=2,
                     n_candidates=12, seed=0)
    loop = ExplorationLoop(cfg, f, f1=f if strategy == "mfmobo" else None,
                           device="cpu")
    for _ in range(3):
        loop.step()
    _walk(pickle.loads(pickle.dumps(loop.state)))
    assert len(loop.state.Y0) + len(loop.state.Y1) > 0
