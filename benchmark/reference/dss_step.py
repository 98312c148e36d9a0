"""The plain reference of one DSS train step, in float32 PyTorch.

Every pixel is tested against every point of its row band (no tiles, no
binning budgets, no kernels), each pixel keeps its K nearest covering
splats by z, truncated at the first with z - z0 > depth_merging_threshold,
and the hand-defined DSS backward runs as written: the occupancy gradient
field (g * d / max(|d|^2, eps) over the support disc of radius
median(visible radii) * the annealed scaler), the z cotangent scattered
into the fragments' points, the per-point clip of the screen-space
gradient.  Then the losses (masked L1 rgb, silhouette, depth L1, the
kNN-based projection and repulsion regularisers) and an Adam update in
optax's order, skipped when a gradient is not finite.

This is a frozen copy of the plain formulation that dss_tpu_torch keeps as
its spec (its `backend="reference"` rasterizer, EWA set-up, shading,
losses and guarded Adam), cut to what a train step of the benchmark's
configurations runs, with one deliberate departure: the 3x3
eigendecompositions of the anisotropic Vrk go through
`torch.linalg.eigh`, not through the program's eigensolver.  It imports
nothing of the program, of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
import struct

import torch

DENOM_EPS = 1e-17
SQRT_EPS = 1e-17
_NO_HIT = torch.iinfo(torch.int64).max
# Rows of one raster block, and the bound on its (rows x S x band points)
# working set; neither changes the result.
ROW_CHUNK = 16
BLOCK_PAIRS = 1 << 26


# ---------------------------------------------------------------------------
# Math
# ---------------------------------------------------------------------------


def eps_denom(d: torch.Tensor, eps: float = DENOM_EPS) -> torch.Tensor:
    """Sign-preserving epsilon guard; zero maps to +eps."""
    sign = torch.sign(d) + (d == 0.0).to(d.dtype)
    return sign * torch.clamp(torch.abs(d), min=eps)


def eps_sqrt(x: torch.Tensor, eps: float = SQRT_EPS) -> torch.Tensor:
    return torch.clamp(x, min=eps)


def jax_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| whose derivative at 0 is 1."""
    return torch.where(x >= 0, x, -x)


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12):
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    return v / torch.clamp(n, min=eps)


def to_homogen(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def det2x2(m: torch.Tensor) -> torch.Tensor:
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def psd_regularized_det2x2(m: torch.Tensor, lam: float) -> torch.Tensor:
    """det(A + lam I) floored at lam * tr(m) - lam^2."""
    return torch.maximum(det2x2(m),
                         lam * (m[..., 0, 0] + m[..., 1, 1]) - lam * lam)


def tangent_frame(normals: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Orthonormal tangent basis (..., 2, 3) of unit normals (Duff et al.)."""
    n = normalize(normals, eps=eps)
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + z + torch.where(z >= 0, eps, -eps).to(n.dtype))
    b = x * y * a
    u0 = torch.stack([1.0 + sign * x * x * a, sign * b, -sign * x], dim=-1)
    u1 = torch.stack([b, sign + y * y * a, -y], dim=-1)
    return torch.stack([u0, u1], dim=-2)


def _f32(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits))[0]


_TAN_T = [_f32(b) for b in (
    0x3EAAAAAB, 0x3E088889, 0x3D5D0DD1, 0x3CB327A4, 0x3C11371F, 0x3B6B6916,
    0x3ABEDE48, 0x3A1A26C8, 0x398137B9, 0x38A3F445, 0x3895C07A, 0xB79BAE5F,
    0x37D95384)]
_PIO4, _PIO4LO = _f32(0x3F490FDA), _f32(0x33222168)
_HPI = float.fromhex("0x1.921fb54442d18p0")
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")


def _clear_low12(x: torch.Tensor) -> torch.Tensor:
    return (x.view(torch.int32) & -4096).view(torch.float32)


def tan_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 tan as the C library's tanf computes it (fdlibm's kernel
    after a double-precision reduction), in separate float32 operations,
    so that every device rounds it alike."""
    t = _TAN_T
    big_arg = x.abs() >= 120.0
    reduce = x.abs().view(torch.int32) > 0x3F490FDA
    n = (((x.double() * _HPI_INV).to(torch.int32) + 0x800000) >> 24)
    n = torch.where(reduce & ~big_arg, n, 0)
    r = x.double() - n.double() * _HPI
    y0 = r.float()
    y1 = (r - y0.double()).float()
    iy = 1.0 - 2.0 * (n & 1).float()
    neg = y0 < 0
    big = y0.abs() >= _f32(0x3F2CA140)
    sgn = torch.where(neg, -1.0, 1.0)
    xb = ((_PIO4 - torch.where(neg, -y0, y0))
          + (_PIO4LO - torch.where(neg, -y1, y1)))
    xx = torch.where(big, xb, y0)
    yy = torch.where(big, 0.0, y1)
    z = xx * xx
    w = z * z
    r = t[1] + w * (t[3] + w * (t[5] + w * (t[7] + w * (t[9] + w * t[11]))))
    v = z * (t[2] + w * (t[4] + w * (t[6] + w * (t[8] + w * (t[10]
                                                             + w * t[12])))))
    s = z * xx
    r = yy + z * (s * (r + v) + yy)
    r = r + t[0] * s
    w = xx + r
    out_big = sgn * (iy - 2.0 * (xx - (w * w / (w + iy) - r)))
    out_big = torch.where(xx.abs() < 2.0 ** -13,
                          sgn * iy * (1.0 - (2.0 * iy) * xx), out_big)
    zh = _clear_low12(w)
    a = -1.0 / w
    th = _clear_low12(a)
    out_inv = th + a * ((1.0 + th * zh) + th * (r - (zh - xx)))
    out = torch.where(big, out_big, torch.where(iy > 0, w, out_inv))
    tiny = y0.abs() < 2.0 ** -13
    out = torch.where(tiny & ~big, torch.where(iy > 0, y0, -1.0 / (y0 + y1)),
                      out)
    return torch.where(big_arg, torch.tan(x), out)


# ---------------------------------------------------------------------------
# Cameras and lights
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cameras:
    """V perspective cameras, row-vector convention: x_view = x @ R + T.
    R (V, 3, 3), T (V, 3), fov (degrees), znear, zfar (V,)."""

    R: torch.Tensor
    T: torch.Tensor
    fov: torch.Tensor
    znear: torch.Tensor
    zfar: torch.Tensor

    def take(self, idx) -> "Cameras":
        return Cameras(*(getattr(self, f.name)[idx]
                         for f in dataclasses.fields(self)))

    def world_to_view_matrix(self) -> torch.Tensor:
        n = self.R.shape[0]
        m = torch.zeros((n, 4, 4), dtype=torch.float32, device=self.R.device)
        m[:, :3, :3] = self.R
        m[:, 3, :3] = self.T
        m[:, 3, 3] = 1.0
        return m

    def projection_matrix(self) -> torch.Tensor:
        n = self.R.shape[0]
        tanhalf = tan_f32(torch.deg2rad(self.fov) / 2.0)
        s1 = 1.0 / (1.0 * tanhalf)
        s2 = 1.0 / tanhalf
        zr = eps_denom(self.zfar - self.znear)
        k = torch.zeros((n, 4, 4), dtype=torch.float32, device=self.R.device)
        k[:, 0, 0] = s1
        k[:, 1, 1] = s2
        k[:, 2, 2] = self.zfar / zr
        k[:, 3, 2] = -(self.zfar * self.znear) / zr
        k[:, 2, 3] = 1.0
        return k

    def full_projection_matrix(self) -> torch.Tensor:
        return self.world_to_view_matrix() @ self.projection_matrix()

    def to_view(self, points: torch.Tensor) -> torch.Tensor:
        if points.ndim == 2:
            points = points[None]
        return points @ self.R + self.T[:, None, :]

    def to_screen(self, points: torch.Tensor) -> torch.Tensor:
        """(V, P, 3) or (P, 3) world points -> (V, P, 3) NDC x, y, view z."""
        if points.ndim == 2:
            points = torch.broadcast_to(points[None],
                                        (self.R.shape[0],) + points.shape)
        pts_view = self.to_view(points)
        hom = to_homogen(points) @ self.full_projection_matrix()
        ndc_xy = hom[..., :2] / eps_denom(hom[..., 3:4])
        return torch.cat([ndc_xy, pts_view[..., 2:3]], dim=-1)

    def position(self) -> torch.Tensor:
        return -torch.einsum("nj,nij->ni", self.T, self.R)


@dataclasses.dataclass
class PointLights:
    """L point lights per view, each field (V, L, 3)."""

    ambient_color: torch.Tensor
    diffuse_color: torch.Tensor
    specular_color: torch.Tensor
    location: torch.Tensor

    def take(self, idx) -> "PointLights":
        return PointLights(*(getattr(self, f.name)[idx]
                             for f in dataclasses.fields(self)))


def shade_points(points, normals, rgb, lights: PointLights, camera_position,
                 shininess: float = 64.0) -> torch.Tensor:
    """rgb * (ambient + Lambert diffuse) + Phong specular, (V, P, 3)."""
    n = normalize(normals, eps=1e-6)
    d = normalize(lights.location[:, None, :, :] - points[None, :, None, :],
                  eps=1e-6)
    cos = torch.einsum("pi,vpli->vpl", n, d)
    zero = torch.zeros((), device=cos.device)
    diffuse = torch.einsum("vli,vpl->vpi", lights.diffuse_color,
                           torch.maximum(cos, zero))
    view_dir = normalize(camera_position[:, None, :] - points[None], eps=1e-6)
    reflect = -d + 2.0 * cos[..., None] * n[None, :, None, :]
    alpha = torch.maximum(torch.einsum("vpi,vpli->vpl", view_dir, reflect),
                          zero)
    alpha = alpha * (cos > 0.0)
    specular = torch.einsum("vli,vpl->vpi", lights.specular_color,
                            alpha ** shininess)
    ambient = torch.sum(lights.ambient_color, dim=1)
    return rgb[None] * (ambient[:, None, :] + diffuse) + specular


# ---------------------------------------------------------------------------
# Nearest neighbours
# ---------------------------------------------------------------------------


def knn_points(query, ref, query_mask=None, ref_mask=None, k: int = 8,
               exclude_self: bool = False, query_chunk: int = 4096):
    """Masked brute-force kNN: (sq dists (Q, k), idx (Q, k)), ascending,
    inf / -1 where invalid.  The distances come from the float32 matmul
    expansion |q|^2 + |r|^2 - 2 q.r."""
    qn, pn = query.shape[0], ref.shape[0]
    dev = query.device
    if query_mask is None:
        query_mask = torch.ones((qn,), dtype=torch.bool, device=dev)
    if ref_mask is None:
        ref_mask = torch.ones((pn,), dtype=torch.bool, device=dev)
    k_eff = min(k + (1 if exclude_self else 0), pn)
    ref_ids = torch.arange(pn, device=dev)
    rr = torch.sum(ref * ref, dim=-1)[None, :]
    d_out, i_out = [], []
    for s in range(0, qn, query_chunk):
        q = query[s:s + query_chunk]
        qmask = query_mask[s:s + query_chunk]
        qq = torch.sum(q * q, dim=-1, keepdim=True)
        d = torch.clamp(qq + rr - 2.0 * (q @ ref.T), min=0.0)
        d = torch.where(ref_mask[None, :], d, math.inf)
        if exclude_self:
            qidx = torch.arange(s, s + q.shape[0], device=dev)
            d = torch.where(qidx[:, None] == ref_ids[None, :], math.inf, d)
        neg_top, idx = torch.topk(-d, k_eff, dim=1)
        dists = -neg_top
        idx = torch.where(torch.isinf(dists), -1, idx)
        if k_eff < k:
            dists = torch.nn.functional.pad(dists, (0, k - k_eff),
                                            value=math.inf)
            idx = torch.nn.functional.pad(idx, (0, k - k_eff), value=-1)
        else:
            dists, idx = dists[:, :k], idx[:, :k]
        d_out.append(torch.where(qmask[:, None], dists, math.inf))
        i_out.append(torch.where(qmask[:, None], idx, -1))
    return torch.cat(d_out), torch.cat(i_out)


def masked_gather(values, idx, fill: float = 0.0):
    out = values[torch.clamp(idx, min=0)]
    return torch.where((idx >= 0)[..., None], out, fill)


# ---------------------------------------------------------------------------
# EWA set-up
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Raster:
    """What the reference reads of a configuration's raster parameters."""

    image_size: int
    points_per_pixel: int = 5
    cutoff_threshold: float = 1.0
    depth_merging_threshold: float = 0.05
    antialiasing_sigma: float = 1.0
    Vrk_invariant: bool = False
    Vrk_isotropic: bool = False
    backface_culling: bool = False
    clip_pts_grad: float = -1.0
    depth_from_fragments: bool = False


def _h_of(sq):
    sq = torch.where(torch.isfinite(sq), sq, 0.0)
    return 0.5 * torch.amax(sq[:, 1:], dim=-1)


def vrk_h_isotropic(points, mask):
    sq, _ = knn_points(points, points, mask, mask, k=7)
    return torch.clamp(_h_of(sq), 5e-5, 0.01)


def vrk_h_global(points, mask):
    """Mean over the cloud of half the largest 6-NN squared distance,
    clamped to [5e-5, 1e-3]; above 8192 points over a stride of 4096
    active query points."""
    p = points.shape[0]
    if p > 8192:
        order = torch.argsort(torch.logical_not(mask).to(torch.int32),
                              stable=True)
        n_active = torch.clamp(torch.sum(mask.to(torch.int64)), min=1)
        qi = order[torch.arange(4096, device=points.device) * n_active // 4096]
        sq, _ = knn_points(points[qi], points, mask[qi], mask, k=7)
        qmask = mask[qi]
    else:
        sq, _ = knn_points(points, points, mask, mask, k=7)
        qmask = mask
    w = qmask.to(points.dtype)
    h = torch.sum(_h_of(sq) * w) / eps_denom(torch.sum(w))
    return torch.clamp(h, 5e-5, 1e-3)


def local_frames(points, mask, k: int = 8):
    """Eigenvalues (P, 3) ascending and eigenvectors (P, 3, 3) as columns
    of each point's k-NN covariance (self included, divided by k)."""
    _, idx = knn_points(points, points, mask, mask, k=k)
    nn = masked_gather(points, idx)
    valid = (idx >= 0).to(points.dtype)[..., None]
    mean = torch.sum(nn * valid, dim=1) / eps_denom(torch.sum(valid, dim=1))
    centered = (nn - mean[:, None, :]) * valid
    cov = torch.einsum("pki,pkj->pij", centered, centered) / k
    return torch.linalg.eigh(cov, UPLO="L")


def compute_vrk(points, normals, mask, raster: Raster, vrk_h):
    """World-space splat covariance (P, 3, 3) and tangent frame (P, 2, 3)."""
    if raster.Vrk_invariant or raster.Vrk_isotropic:
        sk = tangent_frame(normals)
        h = torch.broadcast_to(vrk_h, points.shape[:1])
        return h[:, None, None] * torch.einsum("pia,pib->pab", sk, sk), sk
    curv, frames = local_frames(points, mask, 8)
    tangents = frames[:, :, 1:]
    vrk = torch.einsum("pik,pk,pjk->pij", tangents, curv[:, 1:], tangents)
    return vrk, tangents.transpose(1, 2)


def compute_wjk(points, cams: Cameras):
    """Jacobian (V, P, 3, 2) of the world -> NDC projection."""
    m44 = cams.full_projection_matrix()
    hom = to_homogen(points)
    t = (hom @ m44[:, :, 3].T).T
    xy_view = hom @ m44[:, :, :2]
    inv_t = 1.0 / eps_denom(t)
    inv_t2 = 1.0 / eps_denom(t * t)
    zero = torch.zeros_like(t)
    jk = torch.stack([
        torch.stack([inv_t, zero], dim=-1),
        torch.stack([zero, inv_t], dim=-1),
        torch.stack([zero, zero], dim=-1),
        torch.stack([-xy_view[..., 0] * inv_t2, -xy_view[..., 1] * inv_t2],
                    dim=-1),
    ], dim=-2)
    return torch.einsum("vij,vpjk->vpik", m44[:, :3, :], jk)


@dataclasses.dataclass
class Splats:
    pts_screen: torch.Tensor  # (V, P, 3)
    ellipse: torch.Tensor  # (V, P, 3)
    cutoff: torch.Tensor  # (V, P), -inf: culled
    radii: torch.Tensor  # (V, P, 2), 0: culled
    scaler: torch.Tensor  # (V, P)


def prepare_splats(points, normals, mask, cams: Cameras, raster: Raster,
                   vrk_h) -> Splats:
    """Culling, the projected points and the EWA conic, radii and scaler
    (detached; position gradients flow through pts_screen only)."""
    pts_view = cams.to_view(points)
    depth_ok = ((pts_view[..., 2] >= cams.znear[:, None])
                & (pts_view[..., 2] <= cams.zfar[:, None]))
    render_mask = mask[None] & depth_ok
    if raster.backface_culling:
        render_mask = render_mask & ((normals @ cams.R[:, :, 2].T).T < 0.0)
    dummy = (cams.position() + cams.R[:, :, 2]).detach()
    safe = torch.where(depth_ok[..., None], points[None], dummy[:, None, :])
    pts_screen = cams.to_screen(safe)
    with torch.no_grad():
        mk = compute_wjk(points, cams)
        vrk, sk = compute_vrk(points, normals, mask, raster, vrk_h)
        gv = mk.transpose(-1, -2) @ (vrk[None] @ mk)
        lam = raster.antialiasing_sigma * (2.0 / raster.image_size) ** 2
        gv = gv + lam * torch.eye(2, device=gv.device)
        det_mk = det2x2(sk[None] @ mk)
        det_gv = psd_regularized_det2x2(gv, lam)
        ellipse = torch.stack([gv[..., 1, 1], -(gv[..., 0, 1] + gv[..., 1, 0]),
                               gv[..., 0, 0]], dim=-1) / det_gv[..., None]
        cutoff = torch.full(det_gv.shape, raster.cutoff_threshold,
                            dtype=points.dtype, device=points.device)
        a, b, c = ellipse[..., 0], ellipse[..., 1], ellipse[..., 2]
        denom = eps_denom(4.0 * a * c - b * b)
        radii = torch.stack([torch.sqrt(eps_sqrt(4.0 * c * cutoff / denom)),
                             torch.sqrt(eps_sqrt(4.0 * a * cutoff / denom))],
                            dim=-1)
        scaler = torch.abs(det_mk) / eps_denom(
            torch.sqrt(eps_sqrt(det_gv * 4.0 * math.pi ** 2)))
        cutoff = torch.where(render_mask, cutoff, -math.inf)
        radii = radii * render_mask[..., None]
    return Splats(pts_screen, ellipse, cutoff, radii, scaler)


class _ClipGradNorm(torch.autograd.Function):
    """Identity whose backward clips each row's gradient norm."""

    @staticmethod
    def forward(ctx, x, max_norm):
        ctx.max_norm = max_norm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        n = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
        return g * (torch.clamp(n, 0.0, ctx.max_norm)
                    / torch.clamp(n, min=1e-12)), None


# ---------------------------------------------------------------------------
# Rasterization and its hand-defined backward
# ---------------------------------------------------------------------------


def pixel_ndc(image_size: int, device) -> torch.Tensor:
    """NDC centre of pixel column (= row) i: 1 - (2i + 1)/S."""
    i = torch.arange(image_size, dtype=torch.float32, device=device)
    return 1.0 - (2.0 * i + 1.0) / image_size


def masked_median(vals, mask):
    """Per-row median of vals[mask], (V, N) -> (V,); 0 for an empty row."""
    sv, _ = torch.sort(torch.where(mask, vals, torch.inf), dim=-1)
    n = torch.sum(mask.to(torch.int64), dim=-1)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = 0.5 * (torch.gather(sv, 1, lo[:, None])[:, 0]
                 + torch.gather(sv, 1, hi[:, None])[:, 0])
    return torch.where(n > 0, med, 0.0)


def _rows_per_block(s: int, p: int) -> int:
    r = max(1, min(ROW_CHUNK, BLOCK_PAIRS // max(s * p, 1)))
    while s % r:
        r -= 1
    return r


def rasterize_rows(pts, ellipse, cutoff, radii, dmt: float, s: int, k: int):
    """Per pixel the K smallest z among the covering splats (ties to the
    lower point id), truncated where z - z0 > dmt.  A block of rows tests
    only the points whose box reaches one of its rows.  Returns idx
    (V, S, S, K) int32 (-1 empty), zbuf, qvalue (-1 empty), occ (V, S, S)."""
    v, p = pts.shape[:2]
    dev = pts.device
    xf = pixel_ndc(s, dev)
    pix = 2.0 / s
    r = _rows_per_block(s, p)
    idx = torch.full((v, s, s, k), -1, dtype=torch.int32, device=dev)
    zbuf = torch.full((v, s, s, k), -1.0, device=dev)
    qv = torch.full((v, s, s, k), -1.0, device=dev)
    occ = torch.zeros((v, s, s), device=dev)
    for vi in range(v):
        px, py, pz = pts[vi, :, 0], pts[vi, :, 1], pts[vi, :, 2]
        ry = radii[vi, :, 1]
        zbits = (pz + 0.0).view(torch.int32).to(torch.int64)
        for r0 in range(0, s, r):
            ys = xf[r0:r0 + r]
            # rows run downward in NDC, ys[0] is the block's top; the band
            # is a pixel wider on each side than any accept can reach
            band = torch.nonzero((py - ry <= ys[0] + pix)
                                 & (py + ry >= ys[-1] - pix)
                                 & (pz >= 0.0)).squeeze(1)
            if band.numel() == 0:
                continue
            bx, by, bz = px[band], py[band], pz[band]
            a, b, c = (ellipse[vi, band, j] for j in range(3))
            dx = torch.broadcast_to(xf[None, :, None] - bx, (r, s, len(band)))
            dy = ys[:, None, None] - by
            q = a * dx * dx + b * dx * dy + c * dy * dy
            accept = ((bz >= 0.0) & (torch.abs(dx) <= radii[vi, band, 0])
                      & (torch.abs(dy) <= radii[vi, band, 1])
                      & (q <= cutoff[vi, band]))
            key = torch.where(accept, (zbits[band] << 32) | band, _NO_HIT)
            kk = min(k, len(band))
            top_key, top_pos = torch.topk(key, kk, dim=-1, largest=False,
                                          sorted=True)
            hit = top_key != _NO_HIT
            top_id = band[top_pos]
            topz = torch.where(hit, pz[top_id], torch.inf)
            top_q = torch.gather(q, -1, top_pos)
            keep = hit & (topz - topz[..., :1] <= dmt)
            rows = slice(r0, r0 + r)
            idx[vi, rows, :, :kk] = torch.where(keep, top_id, -1).to(
                torch.int32)
            zbuf[vi, rows, :, :kk] = torch.where(keep, topz, -1.0)
            qv[vi, rows, :, :kk] = torch.where(keep, top_q, -1.0)
            occ[vi, rows] = accept.any(dim=-1).to(torch.float32)
    return idx, zbuf, qv, occ


def visible_points(idx: torch.Tensor, p: int) -> torch.Tensor:
    """(V, P) True for the points in some pixel's fragments of the view."""
    v = idx.shape[0]
    flat = idx.reshape(v, -1).to(torch.int64)
    hits = torch.zeros((v, p + 1), dtype=torch.int64, device=idx.device)
    hits.scatter_add_(1, torch.where(flat >= 0, flat, p), torch.ones_like(flat))
    return hits[:, :p] > 0


def support_radius2(radii, visible, scaler):
    """(V,) squared support-disc radius: the median of the visible points'
    radii (both axes pooled) times the annealed scaler."""
    v = radii.shape[0]
    cur_r = masked_median(radii.reshape(v, -1),
                          visible.repeat_interleave(2, dim=1)) * scaler
    return cur_r * cur_r


def occ_backward(pts, radii, visible, grad_occ, scaler, s: int):
    """The DSS occupancy gradient (V, P, 2): each pixel spreads
    g * d / max(|d|^2, 1e-10) to the visible on-screen points whose centre
    lies within the support disc; a pixel with g > 0 pushes only points
    whose box covers it."""
    v, p = pts.shape[:2]
    dev = pts.device
    xf = pixel_ndc(s, dev)
    cur_r2 = support_radius2(radii, visible, scaler)
    r = _rows_per_block(s, p)
    out = torch.zeros((v, p, 2), device=dev)
    for vi in range(v):
        px, py, pz = pts[vi, :, 0], pts[vi, :, 1], pts[vi, :, 2]
        pt_ok = (visible[vi] & (pz >= 0.0) & (torch.abs(px) <= 1.0)
                 & (torch.abs(py) <= 1.0))
        for r0 in range(0, s, r):
            cols = torch.nonzero(
                (grad_occ[vi, r0:r0 + r] != 0.0).any(dim=0)).squeeze(1)
            dy = xf[r0:r0 + r, None, None] - py
            q = torch.nonzero(
                pt_ok & (dy * dy <= cur_r2[vi]).any(dim=0)[0]).squeeze(1)
            if cols.numel() == 0 or q.numel() == 0:
                continue
            dx = torch.broadcast_to(xf[cols, None] - px[q],
                                    (r, len(cols), len(q)))
            dy = dy[..., q]
            dist2 = dx * dx + dy * dy
            outside = ((torch.abs(dx) > radii[vi, q, 0])
                       | (torch.abs(dy) > radii[vi, q, 1]))
            g = grad_occ[vi, r0:r0 + r, cols, None]
            on = (dist2 <= cur_r2[vi]) & (g != 0.0) & ~((g > 0.0) & outside)
            w = torch.where(on, g / torch.clamp(dist2, min=1e-10), 0.0)
            out[vi, q, 0] += torch.einsum("rsp,rsp->p", w, dx)
            out[vi, q, 1] += torch.einsum("rsp,rsp->p", w, dy)
    return out


def zbuf_backward(idx, grad_zbuf, p: int):
    """(V, P): the zbuf cotangent summed into the fragments' points."""
    v = idx.shape[0]
    flat = idx.reshape(v, -1).to(torch.int64)
    out = torch.zeros((v, p + 1), dtype=grad_zbuf.dtype, device=idx.device)
    out.scatter_add_(1, torch.where(flat >= 0, flat, p),
                     torch.where(flat >= 0, grad_zbuf.reshape(v, -1), 0.0))
    return out[:, :p]


class _Rasterize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts_screen, ellipse, cutoff, radii, s, k, dmt, scaler):
        ctx.set_materialize_grads(False)
        idx, zbuf, qv, occ = rasterize_rows(pts_screen.detach(), ellipse,
                                            cutoff, radii, dmt, s, k)
        ctx.save_for_backward(pts_screen.detach(), radii, idx, scaler)
        ctx.s = s
        ctx.mark_non_differentiable(idx)
        return idx, zbuf, qv, occ

    @staticmethod
    def backward(ctx, _g_idx, g_zbuf, _g_q, g_occ):
        pts, radii, idx, scaler = ctx.saved_tensors
        v, p = pts.shape[:2]
        grad_xy = (torch.zeros((v, p, 2), device=pts.device) if g_occ is None
                   else occ_backward(pts, radii, visible_points(idx, p), g_occ,
                                     scaler, ctx.s))
        grad_z = (torch.zeros((v, p), device=pts.device) if g_zbuf is None
                  else zbuf_backward(idx, g_zbuf, p))
        return (torch.cat([grad_xy, grad_z[..., None]], dim=-1),
                None, None, None, None, None, None, None)


def _frag_scaler(scaler, idx):
    v = idx.shape[0]
    got = torch.gather(scaler, 1,
                       torch.clamp(idx, min=0).reshape(v, -1).to(torch.int64))
    return torch.where(idx >= 0, got.reshape(idx.shape), 0.0)


def render(points, normals, colors, mask, cams: Cameras, lights: PointLights,
           raster: Raster, vrk_h, scaler):
    """V views: (rgba (V, S, S, 4), depth (V, S, S) or None, visible (V, P)).
    Depth is the weighted mean of the fragments' z (-1 uncovered), or with
    `depth_from_fragments` the nearest fragment's z."""
    shaded = shade_points(points, normals, colors, lights, cams.position())
    spl = prepare_splats(points, normals, mask, cams, raster, vrk_h)
    pts_screen = spl.pts_screen
    if raster.clip_pts_grad > 0:
        pts_screen = _ClipGradNorm.apply(pts_screen, raster.clip_pts_grad)
    s, k = raster.image_size, raster.points_per_pixel
    idx, zbuf, qvalue, occ = _Rasterize.apply(
        pts_screen, spl.ellipse, spl.cutoff, spl.radii, s, k,
        raster.depth_merging_threshold, scaler)
    w = torch.where(idx >= 0, torch.exp(-0.5 * qvalue)
                    * _frag_scaler(spl.scaler, idx), 0.0)
    v = idx.shape[0]
    safe = torch.clamp(idx, min=0).to(torch.int64)
    feat = shaded[torch.arange(v, device=idx.device)[:, None, None, None], safe]
    total = torch.sum(w, dim=-1, keepdim=True)
    rgb = (torch.einsum("...k,...kc->...c", w, feat)
           / torch.clamp(total, min=1e-10))
    rgba = torch.cat([rgb, occ[..., None]], dim=-1)
    if raster.depth_from_fragments:
        depth = zbuf[..., 0]
    else:
        wsum = torch.sum(w, dim=-1)
        depth = torch.where(wsum > 0.0,
                            torch.sum(w * zbuf, dim=-1)
                            / torch.clamp(wsum, min=1e-10), -1.0)
    return rgba, depth, visible_points(idx, points.shape[0])


def sample_at_points(cams: Cameras, points, images):
    """(V, P) bilinear samples of (V, S, S) images at the projections,
    clamped onto the border."""
    p_ndc = torch.clamp(-cams.to_screen(points)[..., :2], -1.0, 1.0)
    v, h, w_ = images.shape
    x = (p_ndc[..., 0] + 1.0) * (w_ / 2.0) - 0.5
    y = (p_ndc[..., 1] + 1.0) * (h / 2.0) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    vidx = torch.arange(v, device=images.device)[:, None]

    def at(yy, xx):
        yy = torch.clamp(yy.to(torch.int64), 0, h - 1)
        xx = torch.clamp(xx.to(torch.int64), 0, w_ - 1)
        return images[vidx, yy, xx]

    return (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
            + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def masked_mean(x, mask):
    m = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return torch.sum(x * m) / eps_denom(torch.sum(m))


def dr_loss(img, img_pred, mask_img, mask_pred, l_rgb, l_sil):
    inter = (mask_img > 0.5) & (mask_pred > 0.5)
    loss_rgb = masked_mean(jax_abs(img - img_pred), inter[..., None]) * l_rgb
    m = mask_img.to(img.dtype)
    dims = tuple(range(1, m.ndim))
    inter_s = torch.sum(m * mask_pred, dim=dims)
    union = torch.sum(m + mask_pred - m * mask_pred, dim=dims)
    iou = torch.mean(1.0 - inter_s / eps_denom(union))
    loss_sil = (0.01 * iou + torch.mean(jax_abs(m - mask_pred))) * l_sil
    return loss_rgb, loss_sil


def depth_l1(depth, depth_pred, mask_img):
    valid = (mask_img > 0.5) & (depth_pred > 0.0)
    return masked_mean(jax_abs(depth - depth_pred), valid)


@dataclasses.dataclass
class Knn:
    dists: torch.Tensor
    idx: torch.Tensor
    nn: torch.Tensor
    valid: torch.Tensor


def build_knn(points, mask, knn_k: int) -> Knn:
    dists, idx = knn_points(points, points, mask, mask, k=knn_k - 1,
                            exclude_self=True)
    valid = idx >= 0
    return Knn(torch.where(valid, dists, 0.0), idx,
               masked_gather(points, idx), valid)


def get_phi(knn: Knn):
    vf = knn.valid.to(knn.dists.dtype)
    mean_sq = torch.sum(knn.dists * vf, dim=-1, keepdim=True) / eps_denom(
        torch.sum(vf, dim=-1, keepdim=True))
    w = torch.clamp(1.0 - knn.dists / eps_denom(mean_sq * 4.0), min=0.0)
    w = w * w
    return w * w * vf


def denoise_normals(normals, knn: Knn, weights, reliable):
    nb = masked_gather(normals, knn.idx)
    avg = (torch.sum(nb * weights[..., None], dim=-2)
           / eps_denom(torch.sum(weights, dim=-1, keepdim=True)))
    return torch.where(reliable[:, None], normals, avg)


def get_normal_w(normals, knn: Knn, sigma: float):
    n = normalize(normals)
    diff = normalize(masked_gather(normals, knn.idx)) - n[:, None, :]
    return (torch.exp(-torch.sum(diff * diff, dim=-1) / (sigma * sigma))
            * knn.valid)


def projection_loss(points, normals, mask, visibility, reliable, knn: Knn,
                    sigma: float):
    with torch.no_grad():
        phi = get_phi(knn)
        nd = denoise_normals(normals, knn, phi, reliable)
        vis_nb = masked_gather(visibility.to(points.dtype)[:, None],
                               knn.idx)[..., 0]
        weights = (phi * get_normal_w(nd, knn, sigma)
                   * torch.where(vis_nb > 0.5, 1.0, 0.1) * knn.valid)
        knn_normals = masked_gather(nd, knn.idx)
    sdf = torch.sum((knn.nn.detach() - points[:, None, :]) * knn_normals,
                    dim=-1)
    per_point = (torch.sum(weights * sdf * sdf, dim=-1)
                 / eps_denom(torch.sum(weights, dim=-1)))
    return masked_mean(per_point, mask)


def repulsion_loss(points, normals, mask, reliable, knn: Knn,
                   filter_scale: float, sigma: float):
    with torch.no_grad():
        phi = get_phi(knn)
        nd = denoise_normals(normals, knn, phi, reliable)
        knn_normals = masked_gather(nd, knn.idx)
        lo = torch.amin(torch.where(mask[:, None], points, torch.inf), dim=0)
        hi = torch.amax(torch.where(mask[:, None], points, -torch.inf), dim=0)
        diag2 = eps_denom(torch.sum((hi - lo) ** 2))
        n_valid = torch.sum(mask.to(points.dtype))
        spatial_w = (torch.exp(-knn.dists * (n_valid / diag2) * filter_scale)
                     * knn.valid)
        density_w = torch.sum(spatial_w, dim=-1, keepdim=True) + 1.0
        weights = spatial_w * get_normal_w(nd, knn, sigma)
    diff = points[:, None, :] - knn.nn.detach()
    proj = diff - torch.sum(diff * knn_normals, dim=-1, keepdim=True) * knn_normals
    repel = (torch.sum(proj * weights[..., None], dim=1)
             / eps_denom(torch.sum(weights, dim=1, keepdim=True))) * density_w
    return masked_mean(torch.exp(-jax_abs(repel)), mask[:, None])


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Recipe:
    """What the reference reads of a configuration's training section."""

    lambda_rgb: float
    lambda_silhouette: float
    lambda_proj: float
    lambda_repel: float
    lambda_depth: float
    knn_k: int
    filter_scale: float
    sharpness_sigma: float
    init_radii: float
    steps_radii: int
    gamma_radii: float
    limit_radii: float
    lr: tuple  # points, normals, colors
    milestones: tuple  # in applied updates
    lr_gamma: float
    betas: tuple = (0.5, 0.9)
    eps: float = 1e-8


def backward_scaler(recipe: Recipe, step: int, device) -> torch.Tensor:
    """The annealed support scale at `step`, float32."""
    if recipe.steps_radii <= 0:
        return torch.full((), recipe.init_radii, device=device)
    i = torch.full((), float(step // recipe.steps_radii), device=device)
    return torch.clamp(
        recipe.init_radii * torch.pow(
            torch.full((), recipe.gamma_radii, device=device), i),
        min=recipe.limit_radii)


class ReferenceTrainer:
    """Params, filters and Adam's state of one run, trained one step at a
    time on the views given.  Inputs are copied, never shared."""

    def __init__(self, raster: Raster, recipe: Recipe, points, normals,
                 colors, activation, step: int, moments=None, count: int = 0):
        """`moments`: Adam's (exp_avg, exp_avg_sq) per leaf after `count`
        applied updates; none: a fresh Adam."""
        self.raster, self.recipe = raster, recipe
        self.params = [t.detach().clone() for t in (points, normals, colors)]
        self.activation = activation.clone()
        self.visibility = activation.clone()
        self.inmask = activation.clone()
        self.step = int(step)
        self.count = float(count)
        if moments is None:
            moments = [(torch.zeros_like(t), torch.zeros_like(t))
                       for t in self.params]
        self.mu = [m.clone() for m, _ in moments]
        self.nu = [v.clone() for _, v in moments]
        self.grads = None

    @property
    def betas(self) -> tuple:
        """Adam's (b1, b2)."""
        return self.recipe.betas

    @property
    def lr(self) -> tuple:
        """The base learning rate per leaf (0: the leaf is frozen)."""
        return self.recipe.lr

    def loss(self, params, cams: Cameras, lights: PointLights, img, mask_img,
             depth_img):
        """(total, parts) of the step's loss, and the new filters."""
        raster, rc = self.raster, self.recipe
        points, normals_raw, colors = params
        normals = normalize(normals_raw)
        active = self.activation
        vrk_h = None
        if raster.Vrk_invariant:
            vrk_h = vrk_h_global(points.detach(), active)
        elif raster.Vrk_isotropic:
            vrk_h = vrk_h_isotropic(points.detach(), active)
        scaler = backward_scaler(rc, self.step, points.device)
        rgba, depth, visible = render(points, normals, colors, active, cams,
                                      lights, raster, vrk_h, scaler)
        visibility = torch.any(visible, dim=0) & active
        with torch.no_grad():
            inmask = torch.any(sample_at_points(cams, points, mask_img) > 0.5,
                               dim=0) & visibility
        l_rgb, l_sil = dr_loss(img, rgba[..., :3], mask_img, rgba[..., 3],
                               rc.lambda_rgb, rc.lambda_silhouette)
        parts = {"loss_dr_rgb": l_rgb, "loss_dr_silhouette": l_sil}
        total = l_rgb + l_sil
        if rc.lambda_depth > 0:
            parts["loss_dr_depth"] = (depth_l1(depth_img, depth, mask_img)
                                      * rc.lambda_depth)
            total = total + parts["loss_dr_depth"]
        if rc.lambda_proj > 0 or rc.lambda_repel > 0:
            reliable = visibility & inmask
            knn = build_knn(points.detach(), active, rc.knn_k)
            if rc.lambda_proj > 0:
                parts["loss_dr_proj"] = projection_loss(
                    points, normals, active, visibility, reliable, knn,
                    rc.sharpness_sigma) * rc.lambda_proj
                total = total + parts["loss_dr_proj"]
            if rc.lambda_repel > 0:
                parts["loss_dr_repel"] = repulsion_loss(
                    points, normals, active, reliable, knn, rc.filter_scale,
                    rc.sharpness_sigma) * rc.lambda_repel
                total = total + parts["loss_dr_repel"]
        return total, parts, visibility, inmask

    def train_step(self, cams, lights, img, mask_img, depth_img=None):
        """One step on these views; returns (loss, parts) as floats."""
        params = [t.clone().requires_grad_(True) for t in self.params]
        total, parts, visibility, inmask = self.loss(params, cams, lights,
                                                     img, mask_img, depth_img)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(params, grads)]
        self.grads = grads
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        if finite:
            self._adam(grads)
        self.visibility, self.inmask = visibility, inmask
        self.step += 1
        return float(total.detach()), {k: float(v.detach())
                                       for k, v in parts.items()}

    def _adam(self, grads):
        """Adam in optax's order; a group's lr is base * gamma per milestone
        reached by the applied-update count."""
        rc = self.recipe
        b1, b2 = rc.betas
        inc = self.count + 1.0
        with torch.no_grad():
            for i, g in enumerate(grads):
                mu = (1.0 - b1) * g + b1 * self.mu[i]
                nu = (1.0 - b2) * (g * g) + b2 * self.nu[i]
                mu_hat = mu / (1.0 - torch.pow(torch.tensor(b1), inc))
                nu_hat = nu / (1.0 - torch.pow(torch.tensor(b2), inc))
                lr = rc.lr[i] * rc.lr_gamma ** sum(
                    self.count >= m for m in rc.milestones)
                self.params[i] = self.params[i] + mu_hat / (
                    torch.sqrt(nu_hat) + rc.eps) * -lr
                self.mu[i], self.nu[i] = mu, nu
        self.count = inc
