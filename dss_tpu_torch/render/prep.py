"""The render's per-(view, point) set-up as two kernels: EWA set-up,
projection and shading forward (`kernels.prep_fwd`), and the gradient of
the projection and the shading backward (`kernels.prep_bwd`).

`prep_composite` is the set-up as a composite of stock ops (`shade_points`,
`prepare_splats`, `clip_grad_norm`): the spec, the forward's plain version
and what `render/renderer.py::_prep_view` runs on CPU tensors.  On the card
the forward kernel rounds as the composite rounds there, where its matmuls
and einsums are cuBLAS chains of fused multiply-adds (`ewa.compute_wjk`
writes the Jacobian out, since cuBLAS sums its einsum in another order at
some shapes): its outputs equal the composite's bit for bit, so no
splat's accept test moves.
`prep_bwd_plain` is the closed form of the composite's gradient, the
backward kernel's plain version, written out operation by operation in the
kernel's order (csrc/prep_splats.cu follows it line by line; `_fma`
emulates the kernel's `fmaf`).  `prep_splats` runs the two through
`_PrepSplats`: the kernels on CUDA tensors, the composite and the closed
form on CPU tensors (the tests hold the closed form to autograd through
the composite there).

What the composite fixes, and the kernels keep:
- the depth cull's NaN guard: a point outside [znear, zfar] in a view is
  projected as the dummy camera centre + view axis, and its gradient
  through the projection is zero;
- `clip_grad_norm`'s rule on the `pts_screen` cotangent of every row
  before the projection's Jacobian: g · min(|g|, clip) / max(|g|, 1e-12);
- the EWA outputs (conic, cutoff, radii, scaler, render mask) carry no
  gradient;
- the shading's ties: `torch.maximum(·, 0)` passes half the gradient at
  an exact 0 (of cos and of view·reflect), `(cos > 0)` gates the
  specular, `alpha ** shininess`, `normalize`'s eps 1e-6 (its gradient is
  the clamp's: none through the norm below eps).

Shading modes (`SHADE_*`): the raw colours (no lights), point lights,
directional lights, or none in the kernel (a texture shades outside it:
its colours come from its own autograd graph).  Frames: the normals'
tangent frame with a scalar or per-point kernel size h (`Vrk_invariant`,
`Vrk_isotropic`), or the anisotropic Vrk and tangents of
`ewa.compute_vrk`.  Cameras and lights are constants: no gradient reaches
them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.ops import kernels
from dss_tpu_torch.render.ewa import (
    RasterSettings,
    SplatInfo,
    compute_vrk,
    prepare_splats,
    vrk_kernel_size,
)
from dss_tpu_torch.render.lighting import (
    DirectionalLights,
    Lights,
    PointLights,
    shade_points,
)
from dss_tpu_torch.render.rasterizer import clip_grad_norm
from dss_tpu_torch.utils.mathutil import DENOM_EPS

SHADE_COPY, SHADE_POINT, SHADE_DIRECTIONAL, SHADE_NONE = range(4)
SHADE_EPS = 1e-6  # lighting.py's normalize
CLIP_EPS = 1e-12  # rasterizer._ClipGradNorm's


class PrepViews(NamedTuple):
    """The cameras as the kernels read them, each with a leading view axis:
    the full projection (V, 4, 4), R (V, 3, 3), T (V, 3), znear and zfar
    (V,)."""

    proj: torch.Tensor
    R: torch.Tensor
    T: torch.Tensor
    znear: torch.Tensor
    zfar: torch.Tensor


class PrepLights(NamedTuple):
    """L lights per view: the ambient colours (V, La, 3), summed over their
    own axis as the composite sums them, and the diffuse and specular
    colours and the location of a point light or the direction toward a
    directional one, each (V, L, 3) (broadcast there, as the composite's
    einsums broadcast them)."""

    ambient: torch.Tensor
    diffuse: torch.Tensor
    specular: torch.Tensor
    where: torch.Tensor


class PrepArgs(NamedTuple):
    """What the forward reads besides the points and the views: the shading
    mode and its shininess, the frame (h (1,) or (P,) for the normals'
    frame; else vrk (P, 3, 3) and sk (P, 2, 3)), the antialiasing λ and
    λ² (λ·λ in double, rounded once, as the composite's scalar), the
    cutoff, backface culling and the gradient clip (≤ 0: none)."""

    shade: int
    shininess: float
    h: Optional[torch.Tensor]
    vrk: Optional[torch.Tensor]
    sk: Optional[torch.Tensor]
    lam: float
    lam_sq: float
    cutoff: float
    backface: bool
    clip: float


def prep_composite(points, normals, colors, mask, cameras, lights,
                   settings, vrk_h, shininess, shade=True):
    """The set-up as a composite of stock ops, on every device: with
    `shade`, the lights' shading (the raw colours without lights), then
    the EWA set-up and the optional per-point gradient clip.  The spec of
    the two kernels, with prep_splats' signature and returns (shaded or
    None, splats, pts_screen)."""
    shaded = None
    if shade and lights is not None:
        shaded = shade_points(points, normals, colors, lights,
                              cameras.camera_position(), shininess)
    elif shade:
        shaded = torch.broadcast_to(colors[None],
                                    (len(cameras),) + colors.shape)
    splats = prepare_splats(points, normals, mask, cameras, settings, vrk_h)
    pts_screen = splats.pts_screen
    if settings.clip_pts_grad > 0:
        pts_screen = clip_grad_norm(pts_screen, settings.clip_pts_grad)
    return shaded, splats, pts_screen


# ---------------------------------------------------------------------------
# The backward's closed form: 3-vectors as lists of tensors
# ---------------------------------------------------------------------------


def _dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _fma(a, b, c):
    """fmaf(a, b, c) of float32 tensors: a·b + c rounded once.  The product
    is exact in double; a double sum that lands half-way between two floats
    is settled by the sign of its rounding error (TwoSum)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    r = s.float()
    nb = torch.nextafter(r, torch.where(s > r.double(), torch.inf, -torch.inf)
                         .float())
    mid = (s != r.double()) & (s == (r.double() + nb.double()) / 2) & (err != 0)
    hi, lo = torch.maximum(r, nb), torch.minimum(r, nb)
    return torch.where(mid, torch.where(err > 0, hi, lo), r)


def _gemm(pairs):
    """Σ a·b over the pairs as the card's GEMMs (and so the composite's
    matmuls and einsums there) sum them: an FMA chain, in order, from +0."""
    acc = torch.zeros((), device=pairs[0][0].device)
    for a, b in pairs:
        acc = _fma(a, b, acc)
    return acc


def _dot_pi(a, b):
    """The shading's 3-term einsums ('pi,vpli', 'vpi,vpli') as the card
    sums them: fma(a1, b1, a0·b0) + a2·b2."""
    return _fma(a[1], b[1], a[0] * b[0]) + a[2] * b[2]


def _norm(u):
    """torch.linalg.vector_norm of 3-vectors as the card sums it:
    √((u0² + u2²) + u1²)."""
    return torch.sqrt((u[0] * u[0] + u[2] * u[2]) + u[1] * u[1])


def _clamp_min(x, lo):
    return torch.clamp(x, min=lo)  # NaN stays NaN, as `x < lo ? lo : x`


def _eps_denom(x):
    """mathutil.eps_denom: ±max(|x|, 1e-17), + at 0."""
    return torch.where(x < 0, -1.0, 1.0) * _clamp_min(x.abs(), DENOM_EPS)


def _half_grad(x):
    """The gradient factor of torch.maximum(x, 0) in x: 1 above, ½ at 0, 0
    below (and 1 at NaN, as torch's mask does)."""
    return torch.where(x == 0, 0.5, torch.where(x < 0, 0.0, 1.0))


def _normalize(u, eps):
    """(u / max(|u|, eps), |u|)."""
    n = _norm(u)
    c = _clamp_min(n, eps)
    return [x / c for x in u], n


def _normalize_bwd(u, n, dy, eps):
    """The gradient in u of u / max(|u|, eps) under cotangent dy (|u| = n):
    dy / c + u · (−(dy·u) / c² / n) where n ≥ eps (the clamp passes, and
    the norm's gradient is masked at 0)."""
    c = _clamp_min(n, eps)
    gn = torch.where(n >= eps, -_dot(dy, u) / (c * c), 0.0)
    ratio = torch.where(n >= eps, gn / n, 0.0)
    return [dy[i] / c + u[i] * ratio for i in range(3)]


def _col(m, i, j):
    """Entry (i, j) of each view's matrix, as a (V, 1) column."""
    return m[:, i, j, None]


def _mat_row_dot(x, m, j):
    """Σ_i x_i · m[:, i, j] over i = 0..2, as a GEMM."""
    return _gemm([(x[i], _col(m, i, j)) for i in range(3)])


def _view_depth(x, views):
    """View-space z of world points x: x @ R[:, :, 2] + T_z."""
    return _mat_row_dot(x, views.R, 2) + views.T[:, 2, None]


def _hom(x, views, j):
    """Column j of [x, 1] @ proj."""
    return _mat_row_dot(x, views.proj, j) + _col(views.proj, 3, j)


def _camera_centre(views):
    """(V, 1) components of −T @ Rᵀ."""
    R, T = views.R, views.T
    return [-_gemm([(T[:, j, None], _col(R, i, j)) for j in range(3)])
            for i in range(3)]


def _light_dirs(lights, shade, l, p, pdim):
    """Unit direction toward light l, and for a point light (u, |u|) with
    u = location − p; directional: (d, None, None)."""
    w = [lights.where[:, l, i, None] for i in range(3)]
    if shade == SHADE_POINT:
        u = [w[i] - p[i] for i in range(3)]
        d, n = _normalize(u, SHADE_EPS)
        return d, u, n
    d, _ = _normalize(w, SHADE_EPS)
    return [x.expand(-1, pdim) for x in d], None, None


def _ambient(lights, like):
    """The ambient colours summed over their lights, in order: 3 (V, 1)
    components (zeros like `like`'s view axis without lights)."""
    amb = [torch.zeros_like(like[:, :1]) for _ in range(3)]
    for li in range(lights.ambient.shape[1]):
        amb = [amb[i] + lights.ambient[:, li, i, None] for i in range(3)]
    return amb


def prep_bwd_plain(points, normals, colors, views: PrepViews,
                   lights: Optional[PrepLights], args: PrepArgs,
                   g_shaded, g_screen, needs=(True, True, True)):
    """Plain version of kernels.prep_bwd: the closed form of the
    composite's gradient in points, normals and colours, under the
    cotangents g_shaded and g_screen (V, P, 3; None is zero).  Views are
    added in order, as the kernel's per-point loop adds them.  Returns
    (d_points, d_normals, d_colors), each (P, 3), None where `needs` says
    so or the mode gives that input no gradient."""
    V, pdim = views.R.shape[0], points.shape[0]
    p = [points[:, i] for i in range(3)]
    n = [normals[:, i] for i in range(3)]
    dp = [torch.zeros_like(z) for z in p]
    dnn = [torch.zeros_like(z) for z in p]
    drgb = [torch.zeros_like(z) for z in p]
    shading = g_shaded is not None and args.shade != SHADE_NONE
    if g_screen is not None:
        g = [g_screen[..., i] for i in range(3)]
        if args.clip > 0:
            gn = torch.sqrt(_dot(g, g))
            scale = torch.clamp(gn, 0.0, args.clip) / _clamp_min(gn, CLIP_EPS)
            g = [x * scale for x in g]
        z = _view_depth(p, views)
        depth_ok = (z >= views.znear[:, None]) & (z <= views.zfar[:, None])
        hx, hy, hw = (_hom(p, views, j) for j in (0, 1, 3))
        w = _eps_denom(hw)
        ww = w * w
        dhx, dhy = g[0] / w, g[1] / w
        dw = ((-g[0]) * hx) / ww + ((-g[1]) * hy) / ww
        dhw = torch.where(hw.abs() >= DENOM_EPS, dw, 0.0)
        M, R = views.proj, views.R
        # culled rows project a constant: no gradient
        dscr = [torch.where(depth_ok,
                            ((dhx * _col(M, i, 0) + dhy * _col(M, i, 1))
                             + dhw * _col(M, i, 3)) + g[2] * _col(R, i, 2),
                            0.0) for i in range(3)]
    if shading and args.shade != SHADE_COPY:
        G = [g_shaded[..., i] for i in range(3)]
        rgb = [colors[:, i] for i in range(3)]
        nn_, nlen = _normalize(n, SHADE_EPS)
        c = _camera_centre(views)
        uv = [c[i] - p[i] for i in range(3)]
        vd, vlen = _normalize(uv, SHADE_EPS)
        zero = torch.zeros((), dtype=points.dtype, device=points.device)
        n_lights = lights.where.shape[1]
        col = lambda t, li, i: t[:, li, i, None]
        amb = _ambient(lights, G[0])
        dif = [torch.zeros_like(G[0]) for _ in range(3)]
        for li in range(n_lights):
            d, _, _ = _light_dirs(lights, args.shade, li, p, pdim)
            angle = torch.maximum(_dot_pi(nn_, d), zero)
            dif = [_fma(col(lights.diffuse, li, i), angle, dif[i])
                   for i in range(3)]
        sh_rgb = [G[i] * (amb[i] + dif[i]) for i in range(3)]
        sh_p = [torch.zeros_like(G[0]) for _ in range(3)]
        sh_nn = [torch.zeros_like(G[0]) for _ in range(3)]
        dvd = [torch.zeros_like(G[0]) for _ in range(3)]
        for li in range(n_lights):
            d, u, ulen = _light_dirs(lights, args.shade, li, p, pdim)
            cos = _dot_pi(nn_, d)
            t = 2.0 * cos
            r = [-d[i] + t * nn_[i] for i in range(3)]
            vr = _dot_pi(vd, r)
            gate = (cos > 0.0).to(points.dtype)
            alpha = torch.maximum(vr, zero) * gate
            d_angle = _dot([G[i] * rgb[i] for i in range(3)],
                           [col(lights.diffuse, li, i) for i in range(3)])
            d_pw = _dot(G, [col(lights.specular, li, i) for i in range(3)])
            if args.shininess == 0:
                d_alpha = torch.zeros_like(alpha)
            else:
                d_alpha = d_pw * (args.shininess
                                  * alpha ** (args.shininess - 1.0))
            d_vr = (d_alpha * gate) * _half_grad(vr)
            dvd = [dvd[i] + d_vr * r[i] for i in range(3)]
            d_r = [d_vr * vd[i] for i in range(3)]
            d_cos = d_angle * _half_grad(cos) + 2.0 * _dot(d_r, nn_)
            sh_nn = [sh_nn[i] + (t * d_r[i] + d_cos * d[i]) for i in range(3)]
            if u is not None:
                d_d = [-d_r[i] + d_cos * nn_[i] for i in range(3)]
                du = _normalize_bwd(u, ulen, d_d, SHADE_EPS)
                sh_p = [sh_p[i] - du[i] for i in range(3)]
        dv = _normalize_bwd(uv, vlen, dvd, SHADE_EPS)
        sh_p = [sh_p[i] - dv[i] for i in range(3)]
    for v in range(V):
        if g_screen is not None:
            dp = [dp[i] + dscr[i][v] for i in range(3)]
        if shading and args.shade == SHADE_COPY:
            drgb = [drgb[i] + g_shaded[v, :, i] for i in range(3)]
        elif shading:
            dp = [dp[i] + sh_p[i][v] for i in range(3)]
            dnn = [dnn[i] + sh_nn[i][v] for i in range(3)]
            drgb = [drgb[i] + sh_rgb[i][v] for i in range(3)]
    out_p = torch.stack(dp, dim=-1) if needs[0] else None
    out_n = out_c = None
    if needs[1] and shading and args.shade != SHADE_COPY:
        out_n = torch.stack(_normalize_bwd(n, nlen, dnn, SHADE_EPS), dim=-1)
    if needs[2] and shading:
        out_c = torch.stack(drgb, dim=-1)
    return out_p, out_n, out_c


# ---------------------------------------------------------------------------
# The autograd Function and its entry point
# ---------------------------------------------------------------------------


class _PrepSplats(torch.autograd.Function):
    """The forward and backward kernels; with `spec` (CPU tensors), the
    composite's outputs as the forward and the closed form as the
    backward.  Outputs: pts_screen, conic, cutoff, radii, scaler, render
    mask and, unless SHADE_NONE, shaded; only pts_screen and shaded are
    differentiable."""

    @staticmethod
    def forward(ctx, points, normals, colors, mask, views, lights, args,
                spec):
        if spec is None:
            shaded, *out = kernels.prep_fwd(points, normals, colors, mask,
                                            views, lights, args)
        else:
            shaded, splats, _ = spec(points, normals, colors, mask)
            shaded = None if shaded is None else shaded.clone()
            out = [splats.pts_screen, splats.ellipse_params, splats.cutoff,
                   splats.radii, splats.scaler, splats.mask]
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*out[1:])
        ctx.save_for_backward(points, normals, colors)
        ctx.views, ctx.lights, ctx.args = views, lights, args
        return (*out, shaded) if shaded is not None else tuple(out)

    @staticmethod
    def backward(ctx, g_screen, *grads):
        needs = ctx.needs_input_grad[:3]
        g_shaded = grads[5] if len(grads) > 5 else None
        if not any(needs) or (g_screen is None and g_shaded is None):
            return (None,) * 8
        points, normals, colors = ctx.saved_tensors
        bwd = (prep_bwd_plain if points.device.type == "cpu"
               else kernels.prep_bwd)
        return (*bwd(points, normals, colors, ctx.views, ctx.lights, ctx.args,
                     g_shaded, g_screen, needs), None, None, None, None, None)


def _prep_lights(lights: Optional[Lights]):
    """(shading mode, PrepLights or None) of a light batch."""
    if lights is None:
        return SHADE_COPY, None
    if isinstance(lights, PointLights):
        mode, where = SHADE_POINT, lights.location
    elif isinstance(lights, DirectionalLights):
        mode, where = SHADE_DIRECTIONAL, lights.direction
    else:
        raise TypeError(f"unknown lights {type(lights).__name__}")
    per_light = (lights.diffuse_color, lights.specular_color, where)
    shape = torch.broadcast_shapes(*(t.shape for t in per_light))
    return mode, PrepLights(lights.ambient_color,
                            *(torch.broadcast_to(t, shape) for t in per_light))


def prep_inputs(points, normals, mask, cameras: FoVPerspectiveCameras,
                lights: Optional[Lights], settings: RasterSettings,
                vrk_h=None, shininess: float = 64.0, shade: bool = True):
    """(PrepViews, PrepLights or None, PrepArgs): what the kernels read of
    a render besides its points, normals, colours and mask.  The kernel
    size h (or, anisotropic, the Vrk and its frame) is computed here, as
    `ewa.compute_vrk` computes it, without a gradient."""
    mode, plights = _prep_lights(lights) if shade else (SHADE_NONE, None)
    views = PrepViews(cameras.full_projection_matrix(), cameras.R, cameras.T,
                      cameras.znear, cameras.zfar)
    for t in (*views, *(plights or ())):
        if t.requires_grad:
            raise ValueError("prep_splats: cameras and lights are constants "
                             "of the kernels; none may require a gradient")
    with torch.no_grad():
        h = vrk_kernel_size(points, mask, settings, vrk_h)
        vrk = sk = None
        if h is None:
            vrk, sk = compute_vrk(points, normals, mask, settings)
        else:
            h = torch.as_tensor(h, dtype=points.dtype,
                                device=points.device).reshape(-1)
    pixel_size = 2.0 / settings.image_size
    lam = settings.antialiasing_sigma * pixel_size ** 2
    args = PrepArgs(mode, float(shininess), h, vrk, sk, lam, lam * lam,
                    float(settings.cutoff_threshold),
                    bool(settings.backface_culling),
                    float(settings.clip_pts_grad))
    return views, plights, args


def prep_splats(points, normals, colors, mask,
                cameras: FoVPerspectiveCameras, lights: Optional[Lights],
                settings: RasterSettings, vrk_h=None, shininess: float = 64.0,
                shade: bool = True):
    """`_prep_view`'s shading (with `shade`: the lights, else the raw
    colours), EWA set-up and gradient clip through the two kernels (on
    CPU tensors, the composite and the closed-form backward).
    points/normals/colors (P, 3), mask (P,).  Returns (shaded (V, P, 3),
    or None without `shade`; SplatInfo; pts_screen (V, P, 3), whose
    backward clips each row's cotangent to settings.clip_pts_grad)."""
    views, plights, args = prep_inputs(points, normals, mask, cameras, lights,
                                       settings, vrk_h, shininess, shade)
    # inputs the mode does not read stay out of the graph, as in the
    # composite
    if args.shade in (SHADE_COPY, SHADE_NONE):
        normals = normals.detach()
    if args.shade == SHADE_NONE:
        colors = colors.detach()
    spec = None
    if points.device.type == "cpu":
        def spec(*pncm):
            return prep_composite(*pncm, cameras, lights, settings, vrk_h,
                                  shininess, shade)
    out = _PrepSplats.apply(points, normals, colors, mask, views, plights,
                            args, spec)
    pts_screen, ellipse, cutoff, radii, scaler, rmask = out[:6]
    shaded = out[6] if len(out) > 6 else None
    splats = SplatInfo(pts_screen=pts_screen, ellipse_params=ellipse,
                       cutoff=cutoff, radii=radii, scaler=scaler, mask=rmask)
    return shaded, splats, pts_screen
