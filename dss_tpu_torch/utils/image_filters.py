"""Image-space filters for "geometry processing via image filters": box
filter, color guided filter, L0 gradient smoothing, SLIC superpixels
(counterpart of dss_tpu/utils/image_filters.py).

Reference: DSS/misc/imageFilters.py — box (13-36), gf (39-107),
SuperPixel (110-131), L0Smooth (134-181).  Box, guided and L0 are torch
ops on the image's device (cumsum, batched 3×3 solves, complex64 FFTs);
SLIC is the JAX package's host numpy code, copied (the reference calls
skimage, which neither package uses).
"""
from __future__ import annotations

import numpy as np
import torch


def box_filter(img: torch.Tensor, r: int) -> torch.Tensor:
    """O(1) sliding box sum of radius r over the first two axes, the
    window clipped at the borders (reference box)."""

    def one_axis(x, axis):
        n = x.shape[axis]
        cum = torch.cumsum(x, dim=axis)
        take = lambda a, b: cum.narrow(axis, a, b - a)
        head = take(r, 2 * r + 1)
        mid = take(2 * r + 1, n) - take(0, n - 2 * r - 1)
        reps = [1] * x.ndim
        reps[axis] = r
        tail = take(n - 1, n).repeat(reps) - take(n - 2 * r - 1, n - r - 1)
        return torch.cat([head, mid, tail], dim=axis)

    return one_axis(one_axis(img, 0), 1)


def guided_filter(guide: torch.Tensor, src: torch.Tensor, r: int,
                  eps: float) -> torch.Tensor:
    """Color guided filter (He et al.): guide (H, W, 3), src (H, W) →
    (H, W); the per-pixel 3×3 systems solved batched, made regular by the
    eps·I term (reference gf)."""
    h, w = src.shape[:2]
    n = box_filter(torch.ones((h, w), dtype=src.dtype, device=src.device), r)

    mean_i = box_filter(guide, r) / n[..., None]  # (H, W, 3)
    mean_p = box_filter(src, r) / n
    mean_ip = box_filter(guide * src[..., None], r) / n[..., None]
    cov_ip = mean_ip - mean_i * mean_p[..., None]  # (H, W, 3)

    # (H, W, 3, 3) covariance of the guide per window
    ii = box_filter(guide[..., :, None] * guide[..., None, :], r) / n[..., None, None]
    var_i = ii - mean_i[..., :, None] * mean_i[..., None, :]

    eye = torch.eye(3, dtype=src.dtype, device=src.device)
    a = torch.linalg.solve(var_i + eps * eye, cov_ip[..., None])[..., 0]
    b = mean_p - torch.sum(a * mean_i, dim=-1)
    mean_a = box_filter(a, r) / n[..., None]
    mean_b = box_filter(b, r) / n
    return torch.sum(mean_a * guide, dim=-1) + mean_b


def l0_smooth(img: torch.Tensor, lmd: float = 0.05,
              num_iter: int = 40) -> torch.Tensor:
    """L0 gradient minimisation (Xu et al. 2011) by the half-quadratic FFT
    solver (reference L0Smooth); img (H, W, C) or (H, W).

    β = 0.1·2^i for i < num_iter; the steps with β > 1e5 leave the image
    as it is (the JAX package's `where(active, ...)`), so they are not run.
    The L0 threshold lmd/β is taken in float32, as there."""
    h, w = img.shape[:2]
    img3 = img if img.ndim == 3 else img[..., None]
    dev = img.device

    fi = torch.fft.fft2(img3, dim=(0, 1))
    dx = torch.zeros((h, w), device=dev)
    dx[h // 2, w // 2 - 1], dx[h // 2, w // 2] = -1.0, 1.0
    dy = torch.zeros((h, w), device=dev)
    dy[h // 2 - 1, w // 2], dy[h // 2, w // 2] = -1.0, 1.0
    fdx, fdy = torch.fft.fft2(dx), torch.fft.fft2(dy)
    denom2 = (torch.conj(fdx) * fdx + torch.conj(fdy) * fdy).real[..., None]

    beta0, beta_rate, beta_max = 0.1, 2.0, 1e5
    s = img3
    for i in range(num_iter):
        beta = float(np.float32(beta0 * beta_rate ** i))
        if beta > beta_max:
            break
        thresh = float(np.float32(lmd) / np.float32(beta))
        hp = torch.roll(s, -1, dims=1) - s
        vp = torch.roll(s, -1, dims=0) - s
        zero = torch.sum(hp ** 2 + vp ** 2, dim=-1, keepdim=True) < thresh
        hp = torch.where(zero, 0.0, hp)
        vp = torch.where(zero, 0.0, vp)
        hv = torch.roll(hp, 1, dims=1) - hp + torch.roll(vp, 1, dims=0) - vp
        s = torch.fft.ifft2(
            (fi + beta * torch.fft.fft2(hv, dim=(0, 1))) / (1.0 + beta * denom2),
            dim=(0, 1)).real
    return s if img.ndim == 3 else s[..., 0]


def slic_segments(img: np.ndarray, n_segments: int = 150,
                  compactness: float = 20.0, n_iter: int = 5) -> np.ndarray:
    """SLIC superpixels (Achanta et al. 2012): local k-means in (colour,
    xy) with distance d_color + (m/S)²·d_xy, host numpy.  Returns (H, W)
    int32 labels."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    s = max(int(np.sqrt(h * w / n_segments)), 1)
    ys = np.arange(s // 2, h, s)
    xs = np.arange(s // 2, w, s)
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    cy = cy.reshape(-1).astype(np.float32)
    cx = cx.reshape(-1).astype(np.float32)
    k = len(cy)
    ccol = img[cy.astype(int), cx.astype(int)]  # (K, C)

    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    labels = np.zeros((h, w), np.int32)
    inv_s2 = (compactness / s) ** 2

    for _ in range(n_iter):
        best = np.full((h, w), np.inf, np.float32)
        for ki in range(k):
            y0 = max(int(cy[ki]) - 2 * s, 0)
            y1 = min(int(cy[ki]) + 2 * s, h)
            x0 = max(int(cx[ki]) - 2 * s, 0)
            x1 = min(int(cx[ki]) + 2 * s, w)
            patch = img[y0:y1, x0:x1]
            d_col = np.sum((patch - ccol[ki]) ** 2, axis=-1)
            d_xy = (yy[y0:y1, x0:x1] - cy[ki]) ** 2 + (xx[y0:y1, x0:x1] - cx[ki]) ** 2
            d = d_col + inv_s2 * d_xy
            better = d < best[y0:y1, x0:x1]
            best[y0:y1, x0:x1] = np.where(better, d, best[y0:y1, x0:x1])
            labels[y0:y1, x0:x1] = np.where(better, ki, labels[y0:y1, x0:x1])
        # update centres
        for ki in range(k):
            m = labels == ki
            if m.any():
                cy[ki] = yy[m].mean()
                cx[ki] = xx[m].mean()
                ccol[ki] = img[m].mean(axis=0)
    return labels


def superpixel(img: np.ndarray, compactness: float = 20.0,
               n_segments: int = 150) -> np.ndarray:
    """SLIC quantisation: each segment takes its mean colour (reference
    SuperPixel; label2rgb kind='avg'), host numpy."""
    img = np.asarray(img, np.float32)
    labels = slic_segments(img, n_segments=n_segments, compactness=compactness)
    out = np.zeros_like(img)
    for ki in np.unique(labels):
        m = labels == ki
        out[m] = img[m].mean(axis=0)
    return out.astype(np.float32)
