"""The cases of render/prep.py's tests, shared by test_torch_prep.py (the
CPU) and test_torch_cuda.py (the card): a cloud of N points in V views in
each mode the set-up kernels adapt to, the cotangents, and the two routes
through the set-up (the composite, and `prep.prep_splats`)."""
import numpy as np
import torch

from dss_tpu_torch.geometry.cameras import (FoVPerspectiveCameras,
                                            look_at_view_transform)
from dss_tpu_torch.render import prep
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.render.lighting import DirectionalLights, PointLights

V, N = 3, 240
CASES = {
    # the flagship: point lights, Vrk_invariant, clip 0.05
    "flagship": dict(),
    # the default cell: the anisotropic Vrk and its PCA frame
    "anisotropic Vrk": dict(raster=dict(Vrk_invariant=False,
                                        Vrk_isotropic=False)),
    # the neural texture: a texture shades, the kernels do not
    "texture": dict(texture=True),
    "no lights": dict(lights=None),
    "directional lights": dict(lights="directional"),
    # one ambient, diffuse and specular colour for three point lights
    "shared light colours": dict(lights="shared"),
    "Vrk_isotropic": dict(raster=dict(Vrk_invariant=False)),
    "backface culling": dict(raster=dict(backface_culling=True)),
    # most points behind znear or beyond zfar in some view, half masked
    "depth-culled and masked": dict(znear=1.35, zfar=2.1, keep=0.5),
    # a normal at exactly 90° to a point light: cos = 0
    "cos = 0 tie": dict(tie=True),
}


def prep_scene(case, device="cpu"):
    """The case's cloud of N points in V views, on `device`."""
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(N, 3))
    pts = 0.5 * pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    nrm = nrm + rng.normal(scale=0.2, size=nrm.shape)
    nrm = nrm * rng.uniform(0.8, 1.2, (N, 1))  # not unit: normalize acts
    cols = rng.uniform(0.1, 0.9, (N, 3))
    r, t = look_at_view_transform(dist=torch.tensor([1.7, 2.0, 2.3]),
                                  elev=torch.tensor([10.0, 35.0, -25.0]),
                                  azim=torch.tensor([20.0, 130.0, 250.0]))
    cams = FoVPerspectiveCameras.create(
        r, t, fov=55.0, znear=case.get("znear", 0.1),
        zfar=case.get("zfar", 100.0), device=device)
    loc = rng.uniform(-2.0, 2.0, (V, 3, 3))
    if case.get("tie"):
        pts[:8] = [[0.5, 0.0, 0.0], [0.0, -0.5, 0.25], [0.25, 0.25, 0.0],
                   [-0.5, 0.0, 0.0], [0.0, 0.5, 0.0], [0.0, 0.0, 0.5],
                   [0.0, 0.0, -0.5], [0.125, 0.25, 0.375]]
        nrm[:8] = [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0],
                   [-1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                   [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]]
        # light 0 of every view straight "above" point v: n·(L − p) = 0
        for v in range(V):
            loc[v, 0] = pts[v] + [0.0, 2.0, 0.0]
    colors = dict(ambient_color=rng.uniform(0.1, 0.3, (V, 3, 3)),
                  diffuse_color=rng.uniform(0.2, 0.5, (V, 3, 3)),
                  specular_color=rng.uniform(0.1, 0.3, (V, 3, 3)))
    lights = case.get("lights", "point")
    if lights == "point":
        lights = PointLights.create(**colors, location=loc, n_views=V,
                                    device=device)
    elif lights == "shared":
        lights = PointLights.create(location=loc, n_views=V, device=device)
    elif lights == "directional":
        lights = DirectionalLights.create(**colors, direction=loc, n_views=V,
                                          device=device)
    raster = dict(image_size=32, backface_culling=False, Vrk_invariant=True,
                  Vrk_isotropic=True, clip_pts_grad=0.05)
    raster.update(case.get("raster", {}))
    mask = rng.uniform(size=N) < case.get("keep", 0.9)
    f = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                               device=device)
    return dict(points=f(pts), normals=f(nrm), colors=f(cols),
                mask=torch.tensor(mask, device=device), cameras=cams,
                lights=lights, settings=RasterSettings(**raster))


def _texture(points, normals, cameras):
    """A differentiable stand-in for a neural texture: (V, P, 3)."""
    pos = cameras.camera_position()
    return torch.sigmoid(points[None] * normals[None] + pos[:, None, :])


def run_prep(sc, fused, texture):
    """(shaded, splats, pts_screen) through the composite
    (`prep.prep_composite`) or through `prep.prep_splats` (the kernels on
    the card; on the CPU the composite's outputs and the closed-form
    backward), a texture shading beside it as `_prep_view` does."""
    args = (sc["points"], sc["normals"], sc["colors"], sc["mask"],
            sc["cameras"], sc["lights"], sc["settings"], None, 64.0)
    fn = prep.prep_splats if fused else prep.prep_composite
    shaded, splats, pts = fn(*args, shade=not texture)
    if texture:
        shaded = _texture(sc["points"], sc["normals"], sc["cameras"])
    return shaded, splats, pts


def prep_grads(sc, fused, texture, g_screen, g_shaded):
    """Gradients in points, normals and colours (zeros where none) of
    Σ pts_screen·g_screen + Σ shaded·g_shaded through `run_prep`."""
    leaves = [sc[k].clone().requires_grad_(True)
              for k in ("points", "normals", "colors")]
    run = dict(sc, points=leaves[0], normals=leaves[1], colors=leaves[2])
    shaded, _, pts = run_prep(run, fused, texture)
    loss = (pts * g_screen).sum() + (shaded * g_shaded).sum()
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(leaves, got)]


def prep_cotangents(device="cpu"):
    """Random cotangents (g_screen, g_shaded), each (V, N, 3); g_screen's
    rows straddle the 0.05 clip."""
    gen = torch.Generator().manual_seed(3)
    g_scr = torch.randn((V, N, 3), generator=gen) * 0.04
    g_sh = torch.randn((V, N, 3), generator=gen)
    return g_scr.to(device), g_sh.to(device)
