"""Multi-view inverse-rendering datasets, in memory (counterpart of
dss_tpu/data/dataset.py).

Layout on disk: an image folder and a mask folder of per-view PNGs, and
`data_dict.npz` holding `camera_mat (V, 4, 4)` row-major world-to-view
matrices, `cameras_params`, `lights_type` with per-view `lights_%d` dicts,
and a ground-truth cloud (points, normals, colors).  Optional dense depth
maps are `.npy` files in a depth folder.  PNGs are decoded by `png.py`
(numpy and zlib); other image formats raise.  Images and masks stay numpy;
cameras and lights are built on the device the caller names (the card
unless it says otherwise).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from dss_tpu_torch.data import png
from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.render.lighting import DirectionalLights, PointLights


def _check_png(ext: str, what: str) -> None:
    if ext.lower() != "png":
        raise ValueError(
            f"{what} extension {ext!r}: dss_tpu_torch has a codec for png "
            f"only (data/png.py); there is no {ext} decoder")


def _sorted_files(folder: str, ext: str) -> List[str]:
    files = [f for f in os.listdir(folder) if f.lower().endswith("." + ext)]
    return [os.path.join(folder, f) for f in sorted(files)]


class MVRDataset:
    """In-memory multi-view dataset.

    Attributes:
      images: (V, H, W, 3) float32 in [0, 1].
      masks: (V, H, W) float32 in {0, 1}.
      camera_mat: (V, 4, 4) float32 row-major world2view.
      points/normals/colors: GT sampled cloud (may be None).
      depths: (V, H, W) float32 dense depth, or None.
    """

    def __init__(
        self,
        data_dir: str,
        img_folder: str = "image",
        mask_folder: str = "mask",
        depth_folder: str = "depth",
        data_dict: str = "data_dict.npz",
        img_extension: str = "png",
        mask_extension: str = "png",
        depth_extension: str = "npy",
        load_dense_depth: bool = False,
        n_imgs: Optional[int] = None,
    ):
        _check_png(img_extension, "image")
        _check_png(mask_extension, "mask")
        self.data_dir = data_dir
        image_files = _sorted_files(os.path.join(data_dir, img_folder), img_extension)
        mask_files = _sorted_files(os.path.join(data_dir, mask_folder), mask_extension)
        # cameras_params and the lights are pickled dicts in this format
        dd = np.load(os.path.join(data_dir, data_dict), allow_pickle=True)
        self.data_dict = dd

        if "camera_mat" not in dd:
            raise ValueError("data_dict must contain camera_mat")
        cam = np.asarray(dd["camera_mat"], np.float32)
        n = min(len(image_files), len(mask_files), cam.shape[0])
        if n_imgs is not None:
            n = min(n, n_imgs)
        if len({len(image_files), len(mask_files), cam.shape[0]}) > 1:
            raise ValueError(
                "unequal numbers of images/masks/cameras: %d/%d/%d"
                % (len(image_files), len(mask_files), cam.shape[0])
            )

        self.images, self.masks = self._load_all(image_files[:n], mask_files[:n])
        self.camera_mat = cam[:n]

        self.points = np.asarray(dd["points"], np.float32) if "points" in dd else None
        self.normals = np.asarray(dd["normals"], np.float32) if "normals" in dd else None
        self.colors = np.asarray(dd["colors"], np.float32) if "colors" in dd else None

        self.depths: Optional[np.ndarray] = None
        if load_dense_depth:
            if depth_extension.lower() != "npy":
                _check_png(depth_extension, "depth")
            depth_files = _sorted_files(
                os.path.join(data_dir, depth_folder), depth_extension
            )
            if len(depth_files) < n:
                raise ValueError(
                    "found %d dense depth maps for %d views"
                    % (len(depth_files), n)
                )
            self.depths = np.stack(
                [self._load_depth(f) for f in depth_files[:n]]
            ).astype(np.float32)

        self.cameras_params = (
            dd["cameras_params"].item() if "cameras_params" in dd else {}
        )
        self.lights_type = str(dd["lights_type"]) if "lights_type" in dd else ""
        self._per_view_lights = self._load_lights(dd, n)

    @staticmethod
    def _load_all(image_files, mask_files):
        """Decode all views to RAM; the PNGs of one size are reconstructed
        together (png.read_pngs)."""
        images = np.stack(
            [im.astype(np.float32)[..., :3] / 255.0
             for im in png.read_pngs(image_files)]
        )
        masks = []
        for m in png.read_pngs(mask_files):
            if m.ndim == 3:
                m = m[..., 0]
            masks.append((m > 127).astype(np.float32))
        return images, np.stack(masks)

    @staticmethod
    def _load_depth(path: str) -> np.ndarray:
        if path.lower().endswith(".npy"):
            d = np.load(path)
        else:
            d = png.read_png(path)
        if d.ndim == 3:
            d = d[..., 0]
        return d.astype(np.float32)

    def _load_lights(self, dd, n) -> Optional[Dict[str, np.ndarray]]:
        keys = ["ambient_color", "diffuse_color", "specular_color", "direction", "location"]
        per_view = []
        for i in range(n):
            k = "lights_%d" % i
            if k not in dd:
                return None
            item = dd[k].item()
            per_view.append(
                {
                    kk: np.asarray(vv, np.float32)[0]
                    for kk, vv in item.items()
                    if kk in keys and isinstance(vv, (list, np.ndarray))
                }
            )
        if not per_view:
            return None
        return {k: np.stack([pv[k] for pv in per_view]) for k in per_view[0]}

    def __len__(self) -> int:
        return self.images.shape[0]

    @property
    def resolution(self) -> Tuple[int, int]:
        return self.images.shape[1:3]

    def get_cameras(self, indices=None, device=None) -> FoVPerspectiveCameras:
        """FoV cameras for the selected views: R = m[:3, :3], T = m[3, :3]
        of each camera_mat."""
        cam = self.camera_mat if indices is None else self.camera_mat[indices]
        params = dict(self.cameras_params)
        return FoVPerspectiveCameras.create(
            cam[:, :3, :3],
            cam[:, 3, :3],
            fov=float(params.get("fov", 60.0)),
            znear=float(params.get("znear", 0.1)),
            zfar=float(params.get("zfar", 100.0)),
            aspect_ratio=float(params.get("aspect_ratio", 1.0)),
            device=device,
        )

    def get_lights(self, indices=None, device=None):
        """Per-view lights ((V, L, 3) fields) or None."""
        lv = self._per_view_lights
        if lv is None:
            return None
        sel = (lambda x: x) if indices is None else (lambda x: x[indices])
        n = len(sel(lv["ambient_color"]))
        is_point = "PointLights" in self.lights_type or "location" in lv
        if is_point:
            return PointLights.create(
                ambient_color=sel(lv["ambient_color"]),
                diffuse_color=sel(lv["diffuse_color"]),
                specular_color=sel(lv["specular_color"]),
                location=sel(lv["location"]),
                n_views=n, device=device,
            )
        return DirectionalLights.create(
            ambient_color=sel(lv["ambient_color"]),
            diffuse_color=sel(lv["diffuse_color"]),
            specular_color=sel(lv["specular_color"]),
            direction=sel(lv["direction"]),
            n_views=n, device=device,
        )

    def get_batch(self, indices, device=None):
        """(images (B,H,W,3), masks (B,H,W) numpy, cameras, lights) for view
        ids."""
        indices = np.asarray(indices)
        return (
            self.images[indices],
            self.masks[indices],
            self.get_cameras(indices, device),
            self.get_lights(indices, device),
        )

    def get_depths(self, indices=None) -> Optional[np.ndarray]:
        """Dense GT depth (B, H, W) for the selected views, or None when the
        dataset was opened without load_dense_depth."""
        if self.depths is None:
            return None
        return self.depths if indices is None else self.depths[np.asarray(indices)]

    def get_pointclouds(self):
        """GT sampled cloud (points, normals, colors) or (None, None, None)."""
        return self.points, self.normals, self.colors


class DTUDataset(MVRDataset):
    """DTU variant: cameras.npz convention with per-view
    camera_mat = (scale_mat.T @ world_mat.T)."""

    def __init__(self, data_dir: str, cameras_file: str = "cameras.npz", **kwargs):
        cams = np.load(os.path.join(data_dir, cameras_file))
        n = len([k for k in cams.files if k.startswith("world_mat_")])
        mats = []
        for i in range(n):
            world = cams["world_mat_%d" % i]
            scale = cams.get("scale_mat_%d" % i, np.eye(4, dtype=world.dtype))
            mats.append((scale.T @ world.T).astype(np.float32))
        self._dtu_camera_mat = np.stack(mats)
        super().__init__(data_dir, **kwargs)
        self.camera_mat = self._dtu_camera_mat[: len(self)]


class ViewSampler:
    """Epoch-style random view batching with optional per-view weights; the
    same numpy RNG calls as dss_tpu's, so one seed gives the same batches in
    both packages."""

    def __init__(self, num_views: int, batch_size: int, seed: int = 0,
                 weights: Optional[np.ndarray] = None):
        self.num_views = num_views
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.weights = None
        if weights is not None:
            w = np.asarray(weights, np.float64)
            self.weights = w / w.sum()

    def epoch_batches(self) -> np.ndarray:
        """One epoch's batches as a (steps_per_epoch, batch_size) array."""
        if self.num_views < self.batch_size:
            # fewer views than the batch: one batch per epoch, sampled with
            # replacement
            return self.rng.choice(
                self.num_views, size=(1, self.batch_size), replace=True,
                p=self.weights,
            )
        if self.weights is None:
            order = self.rng.permutation(self.num_views)
        else:
            order = self.rng.choice(
                self.num_views, size=self.num_views, replace=True, p=self.weights
            )
        steps = self.num_views // self.batch_size
        return order[: steps * self.batch_size].reshape(
            steps, self.batch_size
        )
