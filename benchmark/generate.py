"""The benchmark's data, made on the device from the seed.

One general generator reads a dataset file (`datasets/<name>.json`, named
by the cell's traffic), a configuration (`configs/<name>.json`) and the
cell's gradient scale, and makes, in a few large calls:

- a posed image set in the manner of `create_mvr_data --tri-color-lights
  --point-lights`: `n_views` look-at cameras at distances in
  [min_dist, max_dist] (a fixed, evenly spaced set, in an order drawn from
  the seed), directions and look-at jitter drawn from the seed, each view
  lit by three coloured point lights on a dome turned about the camera
  axis by a seeded angle;
- the ground truth: an ellipsoid whose axes are a seeded order of the
  dataset's fixed `gt_axes`, turned by a seeded rotation, scaled into the
  unit sphere as `create_mvr_data` normalises a mesh, and ray-cast in
  closed form for rgb (Lambert shading of albedo 1, clipped and quantised
  to 8 bits as a PNG holds it), mask and view-space depth (zfar on the
  background);
- the model's start, as named leaves in order: `points`,
  `n_points_per_cloud` of them uniform on a sphere of radius 0.5, with
  outward `normals` and `colors` 1, as the CLI's icosphere start;
- the epochs of a cycle: each a permutation of the views, `batch_size`
  per step;
- Adam's state at the start step, as a run that has trained that far
  holds it, for each leaf in that leaf's shape, at the cell's gradient
  scale s for the leaf (the root mean square of a step's gradient):
  exp_avg ~ N(0, (s/2)^2) and exp_avg_sq = exp_avg^2 + s^2 e^z / 2 with
  z ~ N(0, 1).  The first update then depends on both betas and on the
  gradient's size, as every later one does;
- where the configuration's adapter adds leaves (a decoder's weights,
  say): those leaves, which the adapter draws from the same generator,
  and their Adam state, after every other draw, so that all of the above
  is the same with them as without.

Every seed makes the same sizes: only orders, directions and rotations
change with it.

A configuration with `model.model_kwargs.n_scenes` = S trains S independent
scenes stacked along a leading scene axis (`make_scenes`): scene s is all
of the above made at the seed `scene_seed(seed, s)`, so scene 0 is the
single-scene data of the seed itself.
"""
from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def look_at(pos: torch.Tensor, at: torch.Tensor):
    """(R (V, 3, 3), T (V, 3)) with x_view = x @ R + T: the view axis z from
    the camera toward `at`, x = up x z (screen-left), y = z x x."""
    up = torch.tensor([0.0, 1.0, 0.0], device=pos.device).expand_as(pos)
    z = _unit(at - pos)
    x = _unit(torch.linalg.cross(up, z))
    alt = _unit(torch.linalg.cross(
        torch.tensor([0.0, 0.0, 1.0], device=pos.device).expand_as(z), z))
    bad = torch.linalg.vector_norm(x, dim=-1, keepdim=True) < 0.5
    x = torch.where(bad, alt, x)
    y = _unit(torch.linalg.cross(z, x))
    r = torch.stack([x, y, z], dim=-1)
    t = -torch.einsum("vi,vij->vj", pos, r)
    return r, t


def random_rotation(g: torch.Generator, device) -> torch.Tensor:
    """A uniform 3 x 3 rotation from a seeded quaternion."""
    q = _unit(torch.randn(4, generator=g, device=device))
    w, x, y, z = q
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)]),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)]),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)]),
    ])


def cameras(dataset: dict, g: torch.Generator, device):
    """R, T (V, ...), and fov, znear, zfar as floats."""
    n = dataset["n_views"]
    dist = torch.linspace(dataset["min_dist"], dataset["max_dist"], n,
                          device=device)
    dist = dist[torch.randperm(n, generator=g, device=device)]
    u = torch.rand((n, 2), generator=g, device=device)
    azim = torch.deg2rad(-180.0 + 360.0 * u[:, 0])
    elev = torch.deg2rad(-90.0 + 180.0 * u[:, 1])
    at = dataset["at_jitter"] * (
        2.0 * torch.rand((n, 3), generator=g, device=device) - 1.0)
    pos = dist[:, None] * torch.stack(
        [torch.cos(elev) * torch.sin(azim), torch.sin(elev),
         torch.cos(elev) * torch.cos(azim)], dim=-1) + at
    r, t = look_at(pos, at)
    return r, t, pos


def light_rigs(dataset: dict, cam_pos: torch.Tensor, g: torch.Generator):
    """Three point lights per view (create_mvr_data's tri-colour rig):
    ambient 0.2 grey each, diffuse 0.8 in one channel each, no specular,
    at 5 x the dome directions (elevation 30, azimuths -60, 60, 180
    degrees) in a frame whose up is the camera direction, turned about it
    by a seeded angle.  Returns a dict of (V, 3, 3) tensors."""
    dev = cam_pos.device
    n = cam_pos.shape[0]
    elev = torch.deg2rad(torch.full((3,), 30.0, device=dev))
    azim = torch.deg2rad(torch.tensor([-60.0, 60.0, 180.0], device=dev))
    dirs = torch.stack([torch.cos(elev) * torch.sin(azim), torch.sin(elev),
                        torch.cos(elev) * torch.cos(azim)], dim=-1)
    up = _unit(cam_pos)
    at = _unit(torch.linalg.cross(
        cam_pos, torch.randn((n, 3), generator=g, device=dev)))
    x = _unit(torch.linalg.cross(up, at))
    y = torch.linalg.cross(at, x)
    frame = torch.stack([x, y, at], dim=1)  # rows
    loc = dataset["light_distance"] * torch.einsum("li,vij->vlj", dirs, frame)
    diffuse = 0.8 * torch.eye(3, device=dev).flip(0)
    return {
        "ambient_color": torch.full((n, 3, 3), 0.2, device=dev),
        "diffuse_color": diffuse.expand(n, 3, 3).contiguous(),
        "specular_color": torch.zeros((n, 3, 3), device=dev),
        "location": loc.contiguous(),
    }


def ray_cast(r, t, fov, zfar, rot, axes, lights, image_size: int):
    """Ray-cast the ellipsoid {x : |(x @ rot) / axes| = 1} in every view:
    rgb (V, S, S, 3) in [0, 1] quantised to 8 bits, mask (V, S, S) in
    {0, 1}, view depth (V, S, S) with zfar off the object."""
    dev = r.device
    s = image_size
    i = torch.arange(s, dtype=torch.float32, device=dev)
    ndc = 1.0 - (2.0 * i + 1.0) / s
    tanhalf = math.tan(math.radians(fov) / 2.0)
    d_view = torch.stack(torch.broadcast_tensors(
        ndc[None, :] * tanhalf, ndc[:, None] * tanhalf,
        torch.ones((), device=dev)), dim=-1)  # (S rows, S cols, 3), z = 1
    rgb, mask, depth = [], [], []
    for v in range(r.shape[0]):
        c = -t[v] @ r[v].T
        d = d_view @ r[v].T
        c1, d1 = (c @ rot) / axes, (d @ rot) / axes
        qa = torch.sum(d1 * d1, dim=-1)
        qb = 2.0 * torch.sum(c1 * d1, dim=-1)
        qc = torch.sum(c1 * c1) - 1.0
        disc = qb * qb - 4.0 * qa * qc
        tt = (-qb - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * qa)
        hit = (disc >= 0.0) & (tt > 0.0)
        x = c + tt[..., None] * d
        n = _unit(((x @ rot) / (axes * axes)) @ rot.T)
        to_l = _unit(lights["location"][v][None, None] - x[..., None, :])
        cos = torch.clamp(torch.einsum("hwi,hwli->hwl", n, to_l), min=0.0)
        col = (lights["ambient_color"][v].sum(0)
               + torch.einsum("hwl,li->hwi", cos, lights["diffuse_color"][v]))
        col = torch.round(torch.clamp(col, 0.0, 1.0) * 255.0) / 255.0
        rgb.append(torch.where(hit[..., None], col, 0.0))
        mask.append(hit.to(torch.float32))
        depth.append(torch.where(hit, tt, zfar))
    return torch.stack(rgb), torch.stack(mask), torch.stack(depth)


def adam_state(shape, rms, g: torch.Generator, device):
    """(exp_avg, exp_avg_sq) of one leaf at gradient scale `rms`."""
    z = torch.randn((2, *shape), generator=g, device=device)
    m = 0.5 * rms * z[0]
    return m, m * m + 0.5 * rms * rms * torch.exp(z[1])


def _scale(grad_rms, i: int, name: str) -> float:
    """Leaf i's gradient scale: `grad_rms` is a list in leaf order or a
    dict by leaf name."""
    return float(grad_rms[name] if isinstance(grad_rms, dict)
                 else grad_rms[i])


def make(config: dict, dataset: dict, seed: int, device, n_epochs: int,
         grad_rms=None, extra_leaves=None) -> dict:
    """Everything a run trains on, from the seed, on `device`, with
    `n_epochs` epochs of view draws; `leaves`, the start state's leaves by
    name in order; with `grad_rms` (a scale per leaf: a list in leaf order
    or a dict by leaf name) Adam's state at the start step per leaf
    (`moments`).  `extra_leaves(config, generator, device)`, where given,
    returns further (name, tensor) leaves, drawn after all else."""
    g = generator(seed, device)
    rp = config["renderer"]["raster_params"]
    r, t, pos = cameras(dataset, g, device)
    lights = light_rigs(dataset, pos, g)
    axes = torch.tensor(dataset["gt_axes"], device=device)
    axes = axes[torch.randperm(3, generator=g, device=device)]
    axes = axes / axes.max()
    rot = random_rotation(g, device)
    img, mask, depth = ray_cast(r, t, dataset["fov"], dataset["zfar"], rot,
                                axes, lights, int(rp["image_size"]))
    n_pts = int(config["model"]["model_kwargs"]["n_points_per_cloud"])
    pts = 0.5 * _unit(torch.randn((n_pts, 3), generator=g, device=device))
    batch = int(config["training"]["batch_size"])
    n = dataset["n_views"]
    epochs = torch.stack([
        torch.randperm(n, generator=g, device=device)[: n // batch * batch]
        .reshape(n // batch, batch)
        for _ in range(n_epochs)])
    leaves = {"points": pts, "normals": pts / 0.5,
              "colors": torch.ones_like(pts)}
    moments = None
    if grad_rms is not None:
        moments = [adam_state(x.shape, _scale(grad_rms, i, name), g, device)
                   for i, (name, x) in enumerate(leaves.items())]
    if extra_leaves is not None:
        for name, x in extra_leaves(config, g, device):
            if name in leaves:
                raise ValueError(f"the leaf {name!r} is there already")
            leaves[name] = x
    if grad_rms is not None:
        if len(grad_rms) != len(leaves):
            raise ValueError(f"grad_rms gives {len(grad_rms)} scales for "
                             f"the leaves {list(leaves)}")
        moments += [adam_state(x.shape, _scale(grad_rms, i, name), g, device)
                    for i, (name, x) in enumerate(leaves.items())
                    if i >= len(moments)]
    return {
        "R": r, "T": t, "fov": float(dataset["fov"]),
        "znear": float(dataset["znear"]), "zfar": float(dataset["zfar"]),
        "lights": lights, "img": img, "mask": mask,
        "depth": depth if float(config["training"].get("lambda_dr_depth", 0))
        > 0 else None,
        "leaves": leaves, "epochs": epochs, "moments": moments,
    }


# Scene s > 0 draws from seed + s * SCENE_SEED_STRIDE (modulo 2**63, as
# `generator` takes a seed): an odd stride near 2**63 / golden ratio, so
# that the scenes of one seed and of nearby seeds draw from different
# streams.
SCENE_SEED_STRIDE = 0x9E3779B97F4A7C15


def scene_seed(seed: int, s: int) -> int:
    """The seed that scene s of a run at `seed` is made from."""
    return int(seed) + s * SCENE_SEED_STRIDE


def make_scenes(config: dict, dataset: dict, seed: int, device,
                n_epochs: int, grad_rms=None, n_scenes: int = 1) -> dict:
    """`n_scenes` independent scenes, each `make` at `scene_seed(seed, s)`,
    stacked along a leading scene axis: the leaves and each leaf's Adam
    state (S, P, 3), `R`, `T`, each light rig's field, `img`, `mask` and
    `depth` (or None) (S, N, ...); `fov`, `znear` and `zfar` stay floats.
    The epochs are scene 0's, shared by all scenes: at a step's view slot
    each scene renders its own camera of that index.  `n_scenes` is kept
    in the data, and marks it as stacked."""
    scenes = [make(config, dataset, scene_seed(seed, s), device, n_epochs,
                   grad_rms) for s in range(int(n_scenes))]
    first = scenes[0]
    stack = lambda get: torch.stack([get(d) for d in scenes])
    return {
        **{k: first[k] for k in ("fov", "znear", "zfar", "epochs")},
        "R": stack(lambda d: d["R"]), "T": stack(lambda d: d["T"]),
        "lights": {k: stack(lambda d: d["lights"][k])
                   for k in first["lights"]},
        "img": stack(lambda d: d["img"]), "mask": stack(lambda d: d["mask"]),
        "depth": None if first["depth"] is None
        else stack(lambda d: d["depth"]),
        "leaves": {k: stack(lambda d: d["leaves"][k])
                   for k in first["leaves"]},
        "moments": None if first["moments"] is None else [
            (stack(lambda d: d["moments"][i][0]),
             stack(lambda d: d["moments"][i][1]))
            for i in range(len(first["moments"]))],
        "n_scenes": int(n_scenes),
    }
