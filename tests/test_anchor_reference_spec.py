"""The benchmark's plain reference of the normal anchor
(`benchmark/reference/anchor_step.py`, plain float32 torch) against the
JAX package's spec on the CPU, on 300 points near an ellipsoid: its jet
target against `dss_tpu.geometry.normals.refine_normals`, its PCA target
against `estimate_normals`, and its median against `jnp.nanmedian`.  The
benchmark's own tests of the reference (benchmark/tests/test_bench_anchor.py)
import no JAX, so that they run where JAX is missing."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark import harness
from dss_tpu.geometry import normals as spec

ROOT = Path(__file__).resolve().parents[1]
REF = harness.load_module(ROOT / "benchmark" / "reference" / "anchor_step.py")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cloud(n=300, seed=5):
    """n points near an ellipsoid, their outward normals turned by up to
    ~40 degrees at random, all active."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    axes = np.array([0.5, 0.4, 0.3])
    pts = (d * axes + rng.normal(0, 0.002, (n, 3))).astype(np.float32)
    nrm = (d / axes) / np.linalg.norm(d / axes, axis=1, keepdims=True)
    nrm = (nrm + 0.35 * rng.standard_normal((n, 3))).astype(np.float32)
    return pts, nrm, np.ones(n, bool)


def test_anchor_reference_jet_target_matches_the_spec():
    """The reference's jet target (k 48, 2 jet passes, 2 bilateral passes
    over 16) against the spec's refine_normals on 300 points: cos at
    least 1 - 1e-5 (float32 in both, the kNN and the 6x6 solves in
    another order: 1.8e-7 here)."""
    pts, nrm, mask = _cloud()
    want = np.asarray(spec.refine_normals(jnp.asarray(pts), jnp.asarray(nrm),
                                          jnp.asarray(mask),
                                          neighborhood_size=48))
    got = REF.anchor_target(torch.tensor(pts), REF.normalize(torch.tensor(nrm)),
                            torch.tensor(mask),
                            REF.Anchor(weight=0.1, kind="jet", k=48)).numpy()
    cos = np.sum(got * want, axis=-1)
    assert cos.min() >= 1 - 1e-5, cos.min()
    # the refinement moved the normals: the check is not of the input
    assert np.mean(np.sum(got * nrm / np.linalg.norm(nrm, axis=1,
                                                     keepdims=True), -1)) < 0.97


def test_anchor_reference_pca_target_matches_the_spec():
    """The reference's PCA target (8 neighbours) against the spec's
    estimate_normals: |cos| at least 1 - 1e-5 (eigenvector signs are
    arbitrary in both)."""
    pts, _, mask = _cloud()
    want = np.asarray(spec.estimate_normals(jnp.asarray(pts),
                                            jnp.asarray(mask), 8))
    got = REF.pca_target(torch.tensor(pts), torch.tensor(mask), 8).numpy()
    cos = np.abs(np.sum(got * want, axis=-1))
    assert cos.min() >= 1 - 1e-5, cos.min()


@pytest.mark.parametrize("values", [[4.0, 1.0, 3.0, 2.0],
                                    [4.0, 1.0, 3.0, 2.0, 9.0],
                                    [5.0, float("nan"), 1.0, 2.0, 8.0]])
def test_anchor_reference_median_is_the_specs(values):
    """The reference's median is jnp.nanmedian's, the one refine_normals
    takes of the spacings: the mean of the two middle values of an even
    count, the NaNs left out."""
    got = float(REF.median_of(torch.tensor(values)))
    assert got == float(jnp.nanmedian(jnp.asarray(values)))
