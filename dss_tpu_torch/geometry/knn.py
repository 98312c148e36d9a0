"""Exact k-nearest-neighbour search (counterpart of dss_tpu/geometry/knn.py).

Masked brute force, chunked over queries: the distance matrix is one
float32 matmul per chunk and the selection is `torch.topk`.  The JAX
package's TPU-only `approx` selection and its grid kNN are not ported
(see ROADMAP.md).  Invalid results are padded with idx=-1 and dist=inf.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

INF = float("inf")


def _sq_dists(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(Q, 3) × (P, 3) → (Q, P) squared distances via the matmul expansion
    (float32 matmul: TF32 is off, see the package __init__)."""
    qq = torch.sum(q * q, dim=-1, keepdim=True)
    rr = torch.sum(r * r, dim=-1)[None, :]
    d = qq + rr - 2.0 * (q @ r.T)
    return torch.clamp(d, min=0.0)


def knn_points(
    query: torch.Tensor,
    ref: torch.Tensor,
    query_mask: Optional[torch.Tensor] = None,
    ref_mask: Optional[torch.Tensor] = None,
    k: int = 8,
    exclude_self: bool = False,
    query_chunk: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked brute-force kNN.

    query (Q, 3), ref (P, 3); invalid refs are never matched;
    exclude_self drops the self match (ref is query).
    Returns (sq_dists (Q, k), idx (Q, k) int64), ascending; invalid slots
    inf / -1."""
    qn, pn = query.shape[0], ref.shape[0]
    dev = query.device
    if query_mask is None:
        query_mask = torch.ones((qn,), dtype=torch.bool, device=dev)
    if ref_mask is None:
        ref_mask = torch.ones((pn,), dtype=torch.bool, device=dev)
    k_eff = min(k + (1 if exclude_self else 0), pn)
    ref_ids = torch.arange(pn, device=dev)

    dists_out, idx_out = [], []
    for s in range(0, qn, query_chunk):
        q = query[s:s + query_chunk]
        qmask = query_mask[s:s + query_chunk]
        d = _sq_dists(q, ref)
        d = torch.where(ref_mask[None, :], d, INF)
        if exclude_self:
            qidx = torch.arange(s, s + q.shape[0], device=dev)
            d = torch.where(qidx[:, None] == ref_ids[None, :], INF, d)
        neg_top, idx = torch.topk(-d, k_eff, dim=1)
        dists = -neg_top
        idx = torch.where(torch.isinf(dists), -1, idx)
        if k_eff < k:
            pad = k - k_eff
            dists = torch.nn.functional.pad(dists, (0, pad), value=INF)
            idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
        else:
            dists, idx = dists[:, :k], idx[:, :k]
        dists_out.append(torch.where(qmask[:, None], dists, INF))
        idx_out.append(torch.where(qmask[:, None], idx, -1))
    return torch.cat(dists_out), torch.cat(idx_out)


def masked_gather(values: torch.Tensor, idx: torch.Tensor,
                  fill: float = 0.0) -> torch.Tensor:
    """Gather (P, C) rows by (..., K) indices; idx < 0 → fill."""
    out = values[torch.clamp(idx, min=0)]
    return torch.where((idx >= 0)[..., None], out, fill)
