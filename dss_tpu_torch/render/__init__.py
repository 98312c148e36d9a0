from dss_tpu_torch.render.ewa import RasterSettings, SplatInfo, prepare_splats
from dss_tpu_torch.render.rasterizer import (
    Fragments,
    clip_grad_norm,
    rasterize_points,
)
from dss_tpu_torch.render.compositor import norm_weighted_sum, weighted_sum
from dss_tpu_torch.render.lighting import (
    DirectionalLights,
    PointLights,
    shade_points,
)
from dss_tpu_torch.render.renderer import (
    render_single_view,
    render_views,
    render_views_stacked,
)
from dss_tpu_torch.render.mesh_raster import rasterize_mesh, render_mesh_flat

__all__ = [
    "RasterSettings",
    "SplatInfo",
    "prepare_splats",
    "Fragments",
    "rasterize_points",
    "clip_grad_norm",
    "weighted_sum",
    "norm_weighted_sum",
    "DirectionalLights",
    "PointLights",
    "shade_points",
    "render_single_view",
    "render_views",
    "render_views_stacked",
    "rasterize_mesh",
    "render_mesh_flat",
]
