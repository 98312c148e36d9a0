"""Fragment compositing (counterpart of dss_tpu/render/compositor.py): a
gather of per-point features by fragment id and a weighted sum over the K
fragments of each pixel, in plain PyTorch (autograd gives the feature
gradient).  The reference backend composites with these; the tile-binned
paths composite inside their kernels."""
from __future__ import annotations

import torch


def weighted_sum(idx: torch.Tensor, weights: torch.Tensor,
                 features: torch.Tensor) -> torch.Tensor:
    """out[v, ..., c] = Σ_k w_k · features[v, idx_k, c], skipping idx < 0.

    idx (V, ..., K) int fragment point ids, −1 padded; weights (V, ..., K);
    features (V, P, C).  Returns (V, ..., C)."""
    v = idx.shape[0]
    safe = torch.clamp(idx, min=0).to(torch.int64)
    vidx = torch.arange(v, device=idx.device).reshape((v,) + (1,) * (idx.ndim - 1))
    frag_feat = features[vidx, safe]  # (V, ..., K, C)
    w = torch.where(idx >= 0, weights, 0.0)
    return torch.einsum("...k,...kc->...c", w, frag_feat)


def norm_weighted_sum(idx: torch.Tensor, weights: torch.Tensor,
                      features: torch.Tensor,
                      eps: float = 1e-10) -> torch.Tensor:
    """Per-pixel normalized blending: weighted_sum / max(Σ_k w_k, eps)
    (the reference's default compositor)."""
    w = torch.where(idx >= 0, weights, 0.0)
    total = torch.sum(w, dim=-1, keepdim=True)
    return weighted_sum(idx, weights, features) / torch.clamp(total, min=eps)
