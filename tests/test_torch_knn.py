"""The exact kNN of dss_tpu_torch (geometry/knn.py:knn_points, ops/kernels.py:
knn_topk) on the CPU, where it runs the plain version.

- `knn_topk_plain` against the body `knn_points` had before the fused
  kernel (kept below as `_former_knn_points`): bit for bit, distances and
  indices, on every case.
- `knn_points` on CPU tensors against dss_tpu's `knn_points`: distances
  within 1e-5 (XLA and torch round the matmul apart, and the expansion's
  rounding is relative to |q|² + |r|², up to ~12 on these clouds: 1.9e-6
  measured), indices equal on the clouds without ties.
- `knn_topk_grads`, the kernel's backward, against autograd through the
  plain version.

The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from dss_tpu.geometry.knn import knn_points as jax_knn_points
from dss_tpu_torch.geometry.knn import knn_points
from dss_tpu_torch.ops import kernels


def _former_knn_points(query, ref, query_mask=None, ref_mask=None, k=8,
                       exclude_self=False, query_chunk=4096):
    """geometry/knn.py:knn_points as it was before the fused kernel."""
    qn, pn = query.shape[0], ref.shape[0]
    dev = query.device
    if query_mask is None:
        query_mask = torch.ones((qn,), dtype=torch.bool, device=dev)
    if ref_mask is None:
        ref_mask = torch.ones((pn,), dtype=torch.bool, device=dev)
    k_eff = min(k + (1 if exclude_self else 0), pn)
    ref_ids = torch.arange(pn, device=dev)
    inf = float("inf")
    dists_out, idx_out = [], []
    for s in range(0, qn, query_chunk):
        q = query[s:s + query_chunk]
        qmask = query_mask[s:s + query_chunk]
        qq = torch.sum(q * q, dim=-1, keepdim=True)
        rr = torch.sum(ref * ref, dim=-1)[None, :]
        d = torch.clamp(qq + rr - 2.0 * (q @ ref.T), min=0.0)
        d = torch.where(ref_mask[None, :], d, inf)
        if exclude_self:
            qidx = torch.arange(s, s + q.shape[0], device=dev)
            d = torch.where(qidx[:, None] == ref_ids[None, :], inf, d)
        neg_top, idx = torch.topk(-d, k_eff, dim=1)
        dists = -neg_top
        idx = torch.where(torch.isinf(dists), -1, idx)
        if k_eff < k:
            pad = k - k_eff
            dists = torch.nn.functional.pad(dists, (0, pad), value=inf)
            idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
        else:
            dists, idx = dists[:, :k], idx[:, :k]
        dists_out.append(torch.where(qmask[:, None], dists, inf))
        idx_out.append(torch.where(qmask[:, None], idx, -1))
    return torch.cat(dists_out), torch.cat(idx_out)


def _case(name):
    """(query, ref, query_mask, ref_mask, kwargs) as numpy, by name."""
    rng = np.random.default_rng(sum(map(ord, name)))
    cloud = lambda n: rng.normal(size=(n, 3)).astype(np.float32)
    pts = cloud(300)
    if name == "k = 5":
        return pts, pts, None, None, dict(k=5)
    if name == "masked, exclude_self":
        m = rng.random(300) < 0.8
        return pts, pts, m, m, dict(k=4, exclude_self=True)
    if name == "chunked":
        return pts, pts, None, None, dict(k=3, query_chunk=64)
    if name == "Q != P, masked queries":
        return (cloud(120), cloud(400), rng.random(120) < 0.7, None,
                dict(k=7))
    if name == "fewer valid refs than k":
        m = np.zeros(50, bool)
        m[[3, 17, 18, 40, 49]] = True
        return pts[:50], pts[:50], None, m, dict(k=8, exclude_self=True)
    if name == "P < k":
        return pts, pts[:6], None, None, dict(k=10)
    if name == "k = 1":
        return cloud(200), pts, None, None, dict(k=1)
    if name == "k = 16, exclude_self":
        p = cloud(400)
        return p, p, None, None, dict(k=16, exclude_self=True)
    if name == "duplicates":
        p = np.repeat(cloud(100), 3, axis=0)
        return p, p, None, None, dict(k=5, exclude_self=True)
    raise KeyError(name)


CASES = ("k = 5", "masked, exclude_self", "chunked", "Q != P, masked queries",
         "fewer valid refs than k", "P < k", "k = 1", "k = 16, exclude_self",
         "duplicates")


def _torch_args(name):
    q, r, qm, rm, kw = _case(name)
    t = lambda a: None if a is None else torch.tensor(a)
    return (t(q), t(r), t(qm), t(rm)), kw


@pytest.mark.parametrize("name", CASES)
def test_knn_plain_matches_the_former_knn_points(name):
    args, kw = _torch_args(name)
    d, i = kernels.knn_topk_plain(*args, **kw)
    fd, fi = _former_knn_points(*args, **kw)
    assert d.dtype == torch.float32 and i.dtype == torch.int64
    assert torch.equal(d, fd) and torch.equal(i, fi)
    k = kw["k"]
    assert d.shape == (args[0].shape[0], k)
    # knn_points on CPU tensors is the plain version, with no launch
    kernels.reset_launch_counts()
    pd, pi = knn_points(*args, **kw)
    assert torch.equal(pd, d) and torch.equal(pi, i)
    assert kernels.launch_counts()["knn_topk"] == 0


@pytest.mark.parametrize("name", [c for c in CASES if c != "duplicates"])
def test_knn_points_matches_jax(name):
    """On clouds without ties; the duplicates' order at equal distances is
    each library's own."""
    q, r, qm, rm, kw = _case(name)
    (tq, tr, tqm, trm), _ = _torch_args(name)
    d, i = knn_points(tq, tr, tqm, trm, **kw)
    jd, ji = jax_knn_points(q, r, qm, rm, **kw)
    jd, ji = np.asarray(jd), np.asarray(ji).astype(np.int64)
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), ji)


@pytest.mark.parametrize("name", ["masked, exclude_self",
                                  "Q != P, masked queries"])
def test_knn_topk_grads_match_autograd_of_the_plain_version(name):
    (q, r, qm, rm), kw = _torch_args(name)
    same = name == "masked, exclude_self"
    q = q.double().requires_grad_()
    r = q if same else r.double().requires_grad_()
    d, i = kernels.knn_topk_plain(q, r, qm, rm, **kw)
    g = torch.tensor(np.random.default_rng(3).normal(size=d.shape))
    g = torch.where(torch.isfinite(d), g, 0.0)
    loss = torch.sum(torch.where(torch.isfinite(d), d, 0.0) * g)
    want = torch.autograd.grad(loss, [q] if same else [q, r])
    gq, gr = kernels.knn_topk_grads(q.detach(), r.detach(), d.detach(), i, g)
    got = [gq + gr] if same else [gq, gr]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)
