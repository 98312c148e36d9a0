"""YAML configs and the factories that build the run from them (counterpart
of dss_tpu/config.py).

The same YAML shape and the same factory defaults as the JAX package, read
and written by `utils/yaml_lite.py` (no PyYAML).  The TPU knobs
`mxu_quadric` and `matmul_scatter` have no counterpart and are ignored;
`tiled_io: true`, which changes the image layouts, is refused.
"""
from __future__ import annotations

import copy
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from dss_tpu_torch.utils import yaml_lite

DEFAULT_CONFIG: Dict[str, Any] = {
    "name": "demo",
    "data": {
        "type": "MVR",
        "data_dir": "example_data",
        "data_dict": "data_dict.npz",
        "img_folder": "image",
        "mask_folder": "mask",
        "img_extension": "png",
        "mask_extension": "png",
        "n_imgs": None,
        "resolution": [512, 512],
    },
    "renderer": {
        "is_neural_texture": False,
        "raster_params": {
            "backface_culling": False,
            "Vrk_isotropic": False,
            "Vrk_invariant": False,
            "clip_pts_grad": 0.05,
            "cutoff_threshold": 0.5,
            "depth_merging_threshold": 0.05,
            "image_size": 512,
            "points_per_pixel": 5,
            "radii_backward_scaler": 5,
            "antialiasing_sigma": 1.0,
        },
        "compositor_type": "norm_weighted",
        "lighting": "from_data",
    },
    "model": {
        "type": "point",
        "model_kwargs": {
            "learn_points": True,
            "learn_normals": True,
            "learn_colors": False,
            "n_points_per_cloud": 8000,
        },
    },
    "training": {
        "out_dir": "exp",
        "lambda_dr_rgb": 1.0,
        "lambda_dr_silhouette": 1.0,
        "lambda_dr_proj": 0.1,
        "lambda_dr_repel": 0.1,
        "lambda_dr_normal": 0.0,
        "lambda_dr_depth": 0.0,
        "batch_size": 1,
        "print_every": 10,
        "checkpoint_every": 500,
        "visualize_every": 100,
        "validate_every": 500,
        "lr_points": 0.01,
        "lr_normals": 0.01,
        "lr_colors": 1.0,
        "scheduler_milestones": [500, 800],
        "scheduler_gamma": 0.5,
        "steps_dss_backward_radii": 200,
        "gamma_dss_backward_radii": 0.9,
        "limit_dss_backward_radii": 2.0,
        "steps_proj": -1,
        "gamma_proj": 5.0,
        "limit_proj": 1.0,
        "knn_k": 12,
        "filter_scale": 2.0,
        "sharpness_sigma": 0.75,
        "point_file": "shape_pts.ply",
        "resume_from": "model.npz",
    },
    "generation": {"with_colors": True, "with_normals": True},
}


def update_recursive(dict1: dict, dict2: dict) -> None:
    """In-place recursive merge of dict2 into dict1."""
    for k, v in dict2.items():
        if k not in dict1:
            dict1[k] = {} if isinstance(v, dict) else None
        if isinstance(v, dict):
            if not isinstance(dict1[k], dict):
                dict1[k] = {}
            update_recursive(dict1[k], v)
        else:
            dict1[k] = v


def load_config(path: Optional[str] = None, default: Optional[dict] = None) -> dict:
    """Load a YAML config, following recursive `inherit_from` chains
    (relative to the file that names them), merged over the defaults."""
    cfg = copy.deepcopy(default if default is not None else DEFAULT_CONFIG)
    if path is None:
        return cfg

    def load_chain(p):
        special = yaml_lite.load(p) or {}
        parent = special.get("inherit_from")
        if parent:
            base = load_chain(os.path.join(os.path.dirname(p), parent))
            update_recursive(base, special)
            return base
        return special

    update_recursive(cfg, load_chain(path))
    return cfg


def save_config(cfg: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    yaml_lite.dump(cfg, path)


# ---------------------------------------------------------------------------
# Factories
# ---------------------------------------------------------------------------


def create_raster_settings(cfg: dict):
    from dss_tpu_torch.render.ewa import RasterSettings

    rp = cfg["renderer"]["raster_params"]
    if rp.get("tiled_io", False):
        raise ValueError(
            "tiled_io: true is a TPU layout (tile-ordered images) that "
            "dss_tpu_torch does not have; remove it from the config")
    return RasterSettings(
        image_size=int(rp.get("image_size", 512)),
        points_per_pixel=int(rp.get("points_per_pixel", 5)),
        cutoff_threshold=float(rp.get("cutoff_threshold", 1.0)),
        depth_merging_threshold=float(rp.get("depth_merging_threshold", 0.05)),
        antialiasing_sigma=float(rp.get("antialiasing_sigma", 1.0)),
        radii_backward_scaler=float(rp.get("radii_backward_scaler", 10.0)),
        Vrk_invariant=bool(rp.get("Vrk_invariant", False)),
        Vrk_isotropic=bool(rp.get("Vrk_isotropic", True)),
        backface_culling=bool(rp.get("backface_culling", False)),
        clip_pts_grad=float(rp.get("clip_pts_grad", -1.0)),
        backend=str(rp.get("backend", "auto")),
        tile_size=int(rp.get("tile_size", 64)),
        bin_capacity=int(rp.get("bin_capacity", 512)),
        max_tiles_per_splat=int(rp.get("max_tiles_per_splat", -1)),
        pair_cap_scale_fwd=float(rp.get("pair_cap_scale_fwd", -1.0)),
        pair_cap_scale_bwd=float(rp.get("pair_cap_scale_bwd", -1.0)),
        lean_fragments=bool(rp.get("lean_fragments", True)),
        depth_channel=bool(rp.get("depth_channel", False)),
    )


def create_dataset(cfg: dict):
    from dss_tpu_torch.data.dataset import DTUDataset, MVRDataset

    d = cfg["data"]
    cls = {"MVR": MVRDataset, "DTU": DTUDataset}[d.get("type", "MVR")]
    return cls(
        d["data_dir"],
        img_folder=d.get("img_folder", "image"),
        mask_folder=d.get("mask_folder", "mask"),
        data_dict=d.get("data_dict", "data_dict.npz"),
        img_extension=d.get("img_extension", "png"),
        mask_extension=d.get("mask_extension", "png"),
        depth_folder=d.get("depth_folder", "depth"),
        depth_extension=d.get("depth_extension", "npy"),
        load_dense_depth=bool(d.get("load_dense_depth", False)),
        n_imgs=d.get("n_imgs"),
    )


def create_texture(cfg: dict, generator: Optional[torch.Generator] = None,
                   device=None):
    """Upstream's neural texture where `renderer.is_neural_texture` is
    true, else None: a NeuralTexture over IDR's RenderingNetwork, sized by
    `renderer.texture_kwargs` (`hidden_size`, `n_layers`, `view_freqs`,
    `view_dependent`; the input width follows: 6, or 33 at 4 view
    frequencies), its weights drawn from `generator` (torch's default one
    when None); on the card unless `device` says otherwise."""
    from dss_tpu_torch.models.decoders import RenderingNetwork
    from dss_tpu_torch.render.texture import NeuralTexture

    r = cfg["renderer"]
    if not r.get("is_neural_texture", False):
        return None
    tk = r.get("texture_kwargs") or {}
    view_dependent = bool(tk.get("view_dependent", True))
    view_freqs = int(tk.get("view_freqs", 4))
    in_dim = 6 + (3 * (2 * view_freqs + 1) if view_dependent else 0)
    decoder = RenderingNetwork(hidden_size=int(tk.get("hidden_size", 512)),
                               n_layers=int(tk.get("n_layers", 4)),
                               in_dim=in_dim, generator=generator,
                               device=device)
    return NeuralTexture(decoder, view_dependent, view_freqs)


def create_model_params(cfg: dict, rng: Optional[np.random.Generator] = None,
                        device=None):
    """Initial cloud: ico_sphere(4) scaled 0.5, sampled to n_points with
    normals, colours 1, and the neural texture where the config asks for
    one (`create_texture`, its weights seeded from `rng` after the cloud);
    on the card unless `device` says otherwise.  Returns (params,
    learn_flags); the flags name the texture's leaves `texture`."""
    from dss_tpu_torch.geometry.shapes import ico_sphere, sample_points_from_mesh
    from dss_tpu_torch.models.point_model import PointModelParams

    mk = cfg["model"]["model_kwargs"]
    n_points = int(mk.get("n_points_per_cloud", 8000))
    verts, faces = ico_sphere(level=4, radius=0.5)
    pts, normals = sample_points_from_mesh(verts, faces, n_points, rng=rng)
    generator = None
    if cfg["renderer"].get("is_neural_texture", False) and rng is not None:
        generator = torch.Generator().manual_seed(int(rng.integers(1 << 62)))
    params = PointModelParams.create(
        pts, normals, np.ones_like(pts), device=device,
        texture=create_texture(cfg, generator, device=device))
    learn = {
        "points": bool(mk.get("learn_points", True)),
        "normals": bool(mk.get("learn_normals", True)),
        "colors": bool(mk.get("learn_colors", False)),
    }
    if params.texture is not None:
        learn["texture"] = True
    return params, learn


def create_optimizer(cfg: dict, params, learn_flags: Optional[dict] = None,
                     steps_per_epoch: int = 1):
    """Per-group Adam over `params` (a neural texture's leaves at
    `training.lr_texture`), lr 0 for frozen groups, with the MultiStepLR
    milestones converted from epochs to steps (`scheduler_milestones` ×
    steps_per_epoch)."""
    from dss_tpu_torch.training.trainer import make_optimizer

    t = cfg["training"]
    learn_flags = learn_flags or {}

    def lr(name, default):
        if learn_flags and not learn_flags.get(name, True):
            return 0.0
        return float(t.get("lr_" + name, default))

    return make_optimizer(
        params,
        lr_points=lr("points", 0.01),
        lr_normals=lr("normals", 0.01),
        lr_colors=lr("colors", 1.0),
        lr_texture=lr("texture", 1e-4),
        milestones=tuple(
            int(m) * max(int(steps_per_epoch), 1)
            for m in t.get("scheduler_milestones", ())
        ),
        gamma=float(t.get("scheduler_gamma", 0.5)),
    )


def create_train_config(cfg: dict):
    """The port's TrainConfig, read from the config's training section as
    dss_tpu reads it."""
    from dss_tpu_torch.training.trainer import TrainConfig

    t = cfg["training"]
    return TrainConfig(
        lambda_rgb=float(t.get("lambda_dr_rgb", 1.0)),
        lambda_silhouette=float(t.get("lambda_dr_silhouette", 1.0)),
        lambda_proj=float(t.get("lambda_dr_proj", 0.0)),
        lambda_repel=float(t.get("lambda_dr_repel", 0.0)),
        lambda_normal=float(t.get("lambda_dr_normal", 0.0)),
        normal_anchor=str(t.get("normal_anchor", "pca")),
        normal_anchor_k=int(t.get("normal_anchor_k", 8)),
        lambda_depth=float(t.get("lambda_dr_depth", 0.0)),
        knn_k=int(t.get("knn_k", 12)),
        filter_scale=float(t.get("filter_scale", 2.0)),
        sharpness_sigma=float(t.get("sharpness_sigma", 0.75)),
    )


def create_anneal_schedule(cfg: dict):
    from dss_tpu_torch.training.trainer import AnnealSchedule

    t = cfg["training"]
    rp = cfg["renderer"]["raster_params"]
    return AnnealSchedule(
        init_backward_radii=float(rp.get("radii_backward_scaler", 10.0)),
        steps_backward_radii=int(t.get("steps_dss_backward_radii", -1)),
        gamma_backward_radii=float(t.get("gamma_dss_backward_radii", 0.99)),
        limit_backward_radii=float(t.get("limit_dss_backward_radii", 1.0)),
        steps_proj=int(t.get("steps_proj", -1)),
        gamma_proj=float(t.get("gamma_proj", 5.0)),
        limit_proj=float(t.get("limit_proj", 1.0)),
    )
