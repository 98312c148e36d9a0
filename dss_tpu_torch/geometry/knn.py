"""Exact k-nearest-neighbour search (counterpart of dss_tpu/geometry/knn.py).

Two paths, as in the JAX package:

- `knn_points`: masked brute force.  On the card it is one kernel
  (ops/csrc/knn_topk.cu) that computes each distance in a register and
  selects the k best as it goes; on the CPU its plain version, chunked
  over queries: the distance matrix is one float32 matmul per chunk and
  the selection is `torch.topk`.  Both give the same distances, bit for
  bit.  The JAX package's TPU-only `approx` selection is not ported (see
  ROADMAP.md).
- `grid_knn_points`: a uniform grid: a stable sort by cell id, a table of
  at most `bucket_size` points per cell, and the 27-cell neighbourhood
  gathered per query.  Static shapes, nothing read on the host, so it
  runs inside a CUDA graph.

Invalid results are padded with idx=-1 and dist=inf.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from dss_tpu_torch.ops import kernels
from dss_tpu_torch.utils import spans

INF = float("inf")


def knn_points(
    query: torch.Tensor,
    ref: torch.Tensor,
    query_mask: Optional[torch.Tensor] = None,
    ref_mask: Optional[torch.Tensor] = None,
    k: int = 8,
    exclude_self: bool = False,
    query_chunk: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked brute-force kNN: ops.kernels.knn_topk, the fused kernel for
    CUDA tensors and its plain version (`knn_topk_plain`) for CPU tensors.

    query (Q, 3), ref (P, 3); invalid refs are never matched;
    exclude_self drops the self match (ref is query).
    Returns (sq_dists (Q, k), idx (Q, k) int64), ascending; invalid slots
    inf / -1."""
    with spans.span("geometry.knn"):
        return kernels.knn_topk(query, ref, query_mask, ref_mask, k,
                                exclude_self, query_chunk)


def masked_gather(values: torch.Tensor, idx: torch.Tensor,
                  fill: float = 0.0) -> torch.Tensor:
    """Gather (P, C) rows by (..., K) indices; idx < 0 → fill."""
    out = values[torch.clamp(idx, min=0)]
    return torch.where((idx >= 0)[..., None], out, fill)


def grid_knn_points(
    points: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    k: int = 8,
    exclude_self: bool = False,
    grid_res: int = 16,
    bucket_size: int = 64,
    query_chunk: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform-grid kNN of a cloud against itself (dss_tpu's
    grid_knn_points): the cells span the active points' bounding cube,
    `grid_res` per side; each query takes its k nearest among the points of
    its 3×3×3 cells, at most `bucket_size` per cell (the first in index
    order; the rest are dropped).  Exact where no cell holds more than
    `bucket_size` points and every k-th neighbour lies within one cell.
    Returns (sq_dists (P, k), idx (P, k) int64), ascending; invalid slots
    inf / -1."""
    with spans.span("geometry.knn"):
        p = points.shape[0]
        dev = points.device
        if mask is None:
            mask = torch.ones((p,), dtype=torch.bool, device=dev)
        big = 1e30
        lo = torch.amin(torch.where(mask[:, None], points, big), dim=0)
        hi = torch.amax(torch.where(mask[:, None], points, -big), dim=0)
        cell = torch.clamp(torch.amax(hi - lo), min=1e-6) / grid_res
        ijk = torch.clamp(((points - lo) / cell).to(torch.int32), 0,
                          grid_res - 1).to(torch.int64)
        n_cells = grid_res ** 3
        cell_id = (ijk[:, 0] * grid_res + ijk[:, 1]) * grid_res + ijk[:, 2]
        cell_id = torch.where(mask, cell_id, n_cells)  # invalid: a sentinel cell

        order = torch.argsort(cell_id, stable=True)
        starts = torch.searchsorted(cell_id[order],
                                    torch.arange(n_cells + 1, device=dev))
        slot = torch.arange(bucket_size, device=dev)
        src = torch.clamp(starts[:-1, None] + slot[None, :], max=p - 1)
        table = torch.where(slot[None, :] < (starts[1:] - starts[:-1])[:, None],
                            order[src], -1)  # (n_cells, bucket_size)

        r = torch.arange(-1, 2, device=dev)
        offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                           dim=-1).reshape(27, 3)
        n_cand = 27 * bucket_size
        k_eff = min(k, n_cand)
        dists_out, idx_out = [], []
        for s in range(0, p, query_chunk):
            q_idx = torch.arange(s, min(s + query_chunk, p), device=dev)
            nbr = ijk[q_idx, None, :] + offs[None]  # (C, 27, 3)
            inb = torch.all((nbr >= 0) & (nbr < grid_res), dim=-1)
            nbr_cid = ((nbr[..., 0] * grid_res + nbr[..., 1]) * grid_res
                       + nbr[..., 2])
            cand = table[torch.where(inb, nbr_cid, 0)]  # (C, 27, bucket)
            cand = torch.where(inb[..., None], cand, -1).reshape(-1, n_cand)
            safe = torch.clamp(cand, min=0)
            d = None
            for c in range(3):
                dc = points[safe, c] - points[q_idx, c][:, None]
                d = dc * dc if d is None else d + dc * dc
            d = torch.where(cand >= 0, d, INF)
            if exclude_self:
                d = torch.where(cand == q_idx[:, None], INF, d)
            neg_top, sel = torch.topk(-d, k_eff, dim=1)
            dists = -neg_top
            idx = torch.gather(cand, 1, sel)
            idx = torch.where(torch.isinf(dists), -1, idx)
            q_mask = mask[q_idx, None]
            dists_out.append(torch.where(q_mask, dists, INF))
            idx_out.append(torch.where(q_mask, idx, -1))
        dists, idx = torch.cat(dists_out), torch.cat(idx_out)
        if k_eff < k:
            dists = torch.nn.functional.pad(dists, (0, k - k_eff), value=INF)
            idx = torch.nn.functional.pad(idx, (0, k - k_eff), value=-1)
        return dists, idx
