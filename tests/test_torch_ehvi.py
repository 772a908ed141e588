"""The port's EHVI (`repro_torch.core.ehvi`) against the NumPy reference
`ehvi_2d_ref` and `repro`'s jitted `ehvi_2d`, on the CPU: random fronts,
raw point sets that the device version Pareto-filters itself, and fronts
with duplicated and tied points (the stable sort keeps equal points in
order). Tolerance as in tests/test_compiled_optimizer.py: 5e-5 after
scaling by max(|ref|, 1)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ehvi as jehvi  # noqa: E402
from repro.core.pareto import pareto_front as j_pareto_front  # noqa: E402
from repro_torch.core.ehvi import ehvi_2d, ehvi_2d_ref, ehvi_padded  # noqa: E402
from repro_torch.core.pareto import pareto_front  # noqa: E402


def _close(got, want, atol=5e-5):
    scale = np.maximum(np.abs(want), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


@pytest.mark.parametrize("seed", range(6))
def test_ehvi_matches_reference_random_fronts(seed):
    rng = np.random.default_rng(5 + seed)
    for _ in range(4):
        n, f = int(rng.integers(1, 40)), int(rng.integers(0, 9))
        mu = rng.normal(0, 2, (n, 2))
        sg = rng.uniform(0.05, 1.5, (n, 2))
        front = rng.normal(0, 2, (f, 2))
        ref = np.array([-3.0, -3.0])
        got = ehvi_2d(mu, sg, front, ref, device="cpu")
        want = ehvi_2d_ref(mu, sg, pareto_front(front) if f else front, ref)
        _close(got, want)
        _close(got, jehvi.ehvi_2d(mu, sg, front, ref))
        assert (got >= 0).all()


def test_ehvi_pareto_filter_internal():
    """Feeding a raw (unfiltered) point set must equal feeding the
    reference the filtered front."""
    rng = np.random.default_rng(6)
    pts = rng.normal(0, 1, (12, 2))
    mu, sg = rng.normal(0, 1, (5, 2)), rng.uniform(0.1, 1.0, (5, 2))
    ref = np.array([-4.0, -4.0])
    np.testing.assert_allclose(ehvi_2d(mu, sg, pts, ref, device="cpu"),
                               ehvi_2d_ref(mu, sg, pareto_front(pts), ref),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["duplicates", "ties_obj1", "ties_obj2"])
def test_ehvi_duplicated_and_tied_points(kind):
    rng = np.random.default_rng({"duplicates": 7, "ties_obj1": 8,
                                 "ties_obj2": 9}[kind])
    base = rng.normal(0, 1, (6, 2))
    if kind == "duplicates":
        pts = np.concatenate([base, base[:3], base[:1]])
    elif kind == "ties_obj1":
        pts = base.copy()
        pts[1::2, 0] = pts[0::2, 0]      # equal obj1, different obj2
    else:
        pts = base.copy()
        pts[1::2, 1] = pts[0::2, 1]
    pts = pts[rng.permutation(len(pts))]
    mu, sg = rng.normal(0, 1, (9, 2)), rng.uniform(0.1, 1.0, (9, 2))
    ref = np.array([-4.0, -4.0])
    got = ehvi_2d(mu, sg, pts, ref, device="cpu")
    _close(got, ehvi_2d_ref(mu, sg, pareto_front(pts), ref))
    _close(got, jehvi.ehvi_2d(mu, sg, pts, ref))


def test_ehvi_padded_ignores_masked_rows():
    """Masked rows hold garbage that would dominate everything: they must
    not count."""
    rng = np.random.default_rng(10)
    front = rng.normal(0, 1, (5, 2)).astype(np.float32)
    pts = np.concatenate([front, np.full((3, 2), 50.0, np.float32)])
    mask = np.array([1] * 5 + [0] * 3, np.float32)
    mu = rng.normal(0, 1, (7, 2)).astype(np.float32)
    sg = rng.uniform(0.1, 1.0, (7, 2)).astype(np.float32)
    ref = np.array([-4.0, -4.0], np.float32)
    got = ehvi_padded(*(torch.tensor(a) for a in (mu, sg, pts, mask, ref)))
    _close(got.numpy().astype(np.float64),
           ehvi_2d_ref(mu, sg, pareto_front(front), ref))


def test_ehvi_output_is_writable_float64():
    out = ehvi_2d(np.zeros((2, 2)), np.ones((2, 2)), np.zeros((0, 2)),
                  np.array([-1.0, -1.0]), device="cpu")
    assert out.dtype == np.float64
    out[0] = -1.0   # the acquire's reference mutates scores in place


def test_reference_copy_equals_repro():
    """The NumPy oracle the port keeps is `repro`'s, bit for bit."""
    rng = np.random.default_rng(11)
    for _ in range(5):
        mu = rng.normal(0, 2, (20, 2))
        sg = rng.uniform(0.05, 1.5, (20, 2))
        front = j_pareto_front(rng.normal(0, 2, (6, 2)))
        ref = np.array([-3.0, -3.0])
        np.testing.assert_array_equal(ehvi_2d_ref(mu, sg, front, ref),
                                      jehvi.ehvi_2d_ref(mu, sg, front, ref))
