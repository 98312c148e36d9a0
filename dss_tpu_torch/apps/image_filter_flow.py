"""Image-filter-driven splat optimization, "geometry processing via image
filters" (counterpart of dss_tpu/apps/image_filter_flow.py).

Reference capability: learn_image_filter.py: render the cloud from fixed
views, filter the renders (L0 smoothing, guided filter, superpixels or the
pix2pix denoiser) into targets, then optimise the points, normals and
colours so that their renders match the targets, with the projection and
repulsion terms on the points the views see.  Every render and step goes
through the lean splat kernels (K1 forward; K2 and K3 backward).

    python3 -m dss_tpu_torch.apps.image_filter_flow --points cloud.ply \\
        --out <dir> --filter l0 [--iters 200] [--image-size 128] \\
        [--pix2pix-weights latest_net_G.pth] [--device cpu]

It runs on the CUDA card unless `--device` says otherwise.  The cameras
are `sample_random_cameras` drawn from a `torch.Generator` seeded with
`--seed` (other cameras than the JAX CLI's for the same seed).  The
pix2pix weights are the reference's pretrained resnet_9blocks generator
(norm 'pixel'), which the user supplies.  Writes initial.png, target.png,
final.png and filtered_points.ply into `--out`.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from dss_tpu_torch.data.io import read_ply, save_ply
from dss_tpu_torch.geometry.cameras import sample_random_cameras
from dss_tpu_torch.geometry.normals import estimate_normals
from dss_tpu_torch.models.point_model import PointModelParams
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.render.lighting import DirectionalLights
from dss_tpu_torch.render.renderer import render_views
from dss_tpu_torch.training.losses import projection_loss, repulsion_loss
from dss_tpu_torch.utils.device import resolve_device
from dss_tpu_torch.utils.image_filters import guided_filter, l0_smooth, superpixel
from dss_tpu_torch.utils.mathutil import jax_abs, normalize
from dss_tpu_torch.utils.visualize import save_image_grid

FILTERS = ("l0", "guided", "superpixel", "pix2pix", "none")


def filter_targets(renders: torch.Tensor, kind: str, l0_lambda: float = 0.05,
                   pix2pix_weights=None) -> torch.Tensor:
    """Renders (V, S, S, 3) in [0, 1] → the filtered targets, same shape
    and device.  l0, guided and pix2pix run on the renders' device,
    superpixel on the host."""
    if kind == "pix2pix":
        from dss_tpu_torch.models.pix2pix import (ResnetGenerator,
                                                  denoise_images,
                                                  load_generator_weights)

        gen = ResnetGenerator(norm="pixel", device=renders.device).eval()
        load_generator_weights(gen, pix2pix_weights)
        with torch.no_grad():
            return denoise_images(gen, renders)
    out = []
    for im in renders:
        if kind == "l0":
            out.append(l0_smooth(im, lmd=l0_lambda))
        elif kind == "guided":
            g = guided_filter(im, im.mean(-1), r=4, eps=1e-3)
            out.append(g[..., None].repeat(1, 1, 3))
        elif kind == "superpixel":
            out.append(torch.as_tensor(superpixel(im.cpu().numpy()),
                                       device=renders.device))
        elif kind == "none":
            out.append(im)
        else:
            raise ValueError(f"unknown filter {kind!r}: expected one of "
                             f"{FILTERS}")
    return torch.stack(out)


def main(argv=None):
    """Returns {"initial", "target", "final", "points"}: the paths written,
    with "losses" and "image_losses" (the total and its L1 image term, one
    per iteration, before its update) and "params"."""
    parser = argparse.ArgumentParser(
        description="Optimize a point cloud toward filtered renders")
    parser.add_argument("--points", required=True, help="input .ply point cloud")
    parser.add_argument("--out", required=True)
    parser.add_argument("--filter", choices=FILTERS, default="l0")
    parser.add_argument("--l0-lambda", type=float, default=0.05)
    parser.add_argument("--pix2pix-weights", type=str, default=None,
                        help="torch .pth state_dict of the reference "
                             "resnet_9blocks generator (norm='pixel'); used "
                             "with --filter pix2pix")
    parser.add_argument("--num-views", type=int, default=8)
    parser.add_argument("--image-size", type=int, default=128)
    parser.add_argument("--iters", type=int, default=200)
    parser.add_argument("--lr", type=float, default=0.002)
    parser.add_argument("--lambda-proj", type=float, default=0.02)
    parser.add_argument("--lambda-repel", type=float, default=0.02)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the CUDA card (cuda:0), "
                             "which must exist; 'cpu' runs on the CPU")
    args = parser.parse_args(argv)
    if args.filter == "pix2pix" and not args.pix2pix_weights:
        parser.error("--filter pix2pix requires --pix2pix-weights")
    device = resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    ply = read_ply(args.points)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    pts = f32(ply.points)
    p = pts.shape[0]
    mask = torch.ones((p,), dtype=torch.bool, device=device)
    if ply.normals is not None:
        normals = f32(ply.normals)
    else:
        with torch.no_grad():
            normals = estimate_normals(pts, mask, neighborhood_size=8)
    colors = f32(ply.colors) if ply.colors is not None else torch.full_like(pts, 0.8)

    # normalize to the unit sphere for stable camera sampling
    center = (pts.amax(0) + pts.amin(0)) / 2.0
    pts = pts - center
    pts = pts / torch.linalg.vector_norm(pts, dim=-1).max()

    cams = sample_random_cameras(
        args.num_views, 1.8, 2.2,
        generator=torch.Generator().manual_seed(args.seed), device=device)
    lights = DirectionalLights.create(
        ambient_color=(0.4, 0.4, 0.4), diffuse_color=(0.6, 0.6, 0.6),
        specular_color=(0.0, 0.0, 0.0), direction=(0.3, 1.0, -0.5),
        n_views=args.num_views, device=device)
    settings = RasterSettings(
        image_size=args.image_size, points_per_pixel=5, cutoff_threshold=1.0,
        Vrk_isotropic=True, backface_culling=True)

    def render(prm: PointModelParams):
        rgba, _, vis = render_views(prm.points, normalize(prm.normals, eps=1e-9),
                                    prm.colors, mask, cams, lights, settings)
        return rgba, vis

    params = PointModelParams.create(pts, normals, colors, device=device)
    with torch.no_grad():
        renders = render(params)[0][..., :3].contiguous()
    written = {"initial": save_image_grid(renders.cpu().numpy(),
                                          os.path.join(args.out, "initial.png"))}

    print("filtering %d renders with %s" % (len(renders), args.filter))
    targets = filter_targets(renders, args.filter, args.l0_lambda,
                             args.pix2pix_weights)
    written["target"] = save_image_grid(targets.cpu().numpy(),
                                        os.path.join(args.out, "target.png"))

    opt = torch.optim.Adam(params.tensors(), lr=args.lr, betas=(0.5, 0.9))
    losses, image_losses = [], []
    t0 = time.time()
    for it in range(args.iters):
        opt.zero_grad(set_to_none=True)
        rgba, vis = render(params)
        l_img = torch.mean(jax_abs(rgba[..., :3] - targets))
        loss = l_img
        n = normalize(params.normals, eps=1e-9)
        reliable = torch.any(vis, dim=0)
        if args.lambda_proj > 0:
            loss = loss + args.lambda_proj * projection_loss(
                params.points, n, mask, reliable=reliable)
        if args.lambda_repel > 0:
            loss = loss + args.lambda_repel * repulsion_loss(
                params.points, n, mask, reliable=reliable)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        image_losses.append(l_img.detach())
        if (it + 1) % 20 == 0:
            print("it %d loss %.5f (%.2fs)" % (it + 1, float(loss.detach()),
                                                time.time() - t0))

    with torch.no_grad():
        final = render(params)[0][..., :3]
    written["final"] = save_image_grid(final.cpu().numpy(),
                                       os.path.join(args.out, "final.png"))
    written["points"] = os.path.join(args.out, "filtered_points.ply")
    save_ply(written["points"], params.points.detach().cpu().numpy(),
             normals=params.normals.detach().cpu().numpy())
    print("wrote", args.out)
    return {**written,
            "losses": torch.stack(losses).tolist() if losses else [],
            "image_losses": (torch.stack(image_losses).tolist() if image_losses
                             else []),
            "params": params}


if __name__ == "__main__":
    main()
