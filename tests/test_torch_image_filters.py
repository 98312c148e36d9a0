"""The port's image filters (dss_tpu_torch/utils/image_filters.py) against
dss_tpu's on the same numpy images: the box filter (rtol 1e-5, and
against a direct window sum), the guided filter (atol 5e-5: its 3×3
solves scale the box sums' rounding by up to 1/eps), L0
smoothing, SLIC and superpixel (bit-equal: the same numpy code).

L0's `zero` mask is a hard decision at lmd/β and torch's FFT (pocketfft
here, cuFFT on the card) rounds otherwise than XLA's, so a pixel near the
threshold may flip and carry the flip on.  The first few iterations are
held within atol 2e-6; the full 40 within atol 1e-4 on a smooth image,
and by a mean absolute difference below 1e-3 (max 1e-2) on uniform noise,
whose gradients crowd the threshold."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.utils import image_filters as J
from dss_tpu_torch.utils import image_filters as T

torch.set_num_threads(2)


def _smooth_image(s=48, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:s, 0:s] / s
    img = np.stack([0.5 + 0.3 * np.sin(6 * xx + c) * np.cos(4 * yy)
                    for c in range(3)], -1)
    disc = (((xx - 0.5) ** 2 + (yy - 0.5) ** 2) < 0.1) * 0.3
    return (img + disc[..., None]
            + rng.normal(0, 0.02, img.shape)).astype(np.float32)


def _direct_box(img, r):
    h, w = img.shape[:2]
    out = np.zeros_like(img, dtype=np.float64)
    for y in range(h):
        for x in range(w):
            out[y, x] = img[max(y - r, 0):y + r + 1,
                            max(x - r, 0):x + r + 1].sum(axis=(0, 1))
    return out


@pytest.mark.parametrize("r", [1, 3, 7])
def test_box_filter_matches_jax_and_window_sums(r):
    img = _smooth_image(40)
    got = T.box_filter(torch.tensor(img), r).numpy()
    want = np.asarray(J.box_filter(jnp.asarray(img), r))
    assert got.shape == img.shape
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, _direct_box(img, r), rtol=1e-5)


@pytest.mark.parametrize("r,eps", [(2, 1e-3), (4, 1e-2)])
def test_guided_filter_matches_jax(r, eps):
    img = _smooth_image(40, seed=1)
    src = img.mean(-1)
    got = T.guided_filter(torch.tensor(img), torch.tensor(src), r, eps).numpy()
    want = np.asarray(J.guided_filter(jnp.asarray(img), jnp.asarray(src), r,
                                      eps))
    assert got.shape == src.shape
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("num_iter", [1, 3, 5])
def test_l0_smooth_first_iterations_match_jax(num_iter):
    img = _smooth_image()
    got = T.l0_smooth(torch.tensor(img), 0.05, num_iter).numpy()
    want = np.asarray(J.l0_smooth(jnp.asarray(img), lmd=0.05,
                                  num_iter=num_iter))
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_l0_smooth_full_run_matches_jax():
    img = _smooth_image()
    got = T.l0_smooth(torch.tensor(img), 0.05).numpy()
    want = np.asarray(J.l0_smooth(jnp.asarray(img), lmd=0.05))
    np.testing.assert_allclose(got, want, atol=1e-4)
    tv = lambda x: np.abs(np.diff(x, axis=0)).sum() + np.abs(np.diff(x, axis=1)).sum()
    assert tv(got) < 0.5 * tv(img)


@pytest.mark.parametrize("gray", [False, True])
def test_l0_smooth_on_noise_by_mean_difference(gray):
    img = np.random.default_rng(2).uniform(0, 1, (32, 32, 3)).astype(np.float32)
    if gray:
        img = img.mean(-1)
    got = T.l0_smooth(torch.tensor(img), 0.03).numpy()
    want = np.asarray(J.l0_smooth(jnp.asarray(img), lmd=0.03))
    assert got.shape == img.shape
    diff = np.abs(got - want)
    assert diff.mean() < 1e-3 and diff.max() < 1e-2, (diff.mean(), diff.max())


def test_slic_and_superpixel_are_bit_equal():
    img = _smooth_image(40, seed=3)
    for kw in (dict(), dict(n_segments=40, compactness=10.0)):
        np.testing.assert_array_equal(T.slic_segments(img, **kw),
                                      J.slic_segments(img, **kw))
    got, want = T.superpixel(img, n_segments=60), J.superpixel(img, n_segments=60)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 20
    gray = img.mean(-1)
    np.testing.assert_array_equal(T.slic_segments(gray), J.slic_segments(gray))
