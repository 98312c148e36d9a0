"""dss_tpu_torch — differentiable surface splatting in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The module layout and function names mirror `dss_tpu/` (the JAX reference
package), and every public function keeps the JAX package's array layouts
((V, P, 3) point batches, (V, S, S, C) images), so each counterpart can be
held against the reference on the same inputs.

Tensors on the CPU take the plain PyTorch version of each splat kernel;
tensors on a CUDA device launch the kernels in `ops/csrc/` (built with nvcc
at first use) or raise.  There is no fallback between the two.
"""
import torch

# Counterpart of the JAX package's Precision.HIGHEST rule (render/ewa.py,
# geometry/knn.py): geometry matmuls must stay exact float32.  TF32 keeps
# ~10 mantissa bits, enough to flip the sign of det(GV) — and with it the
# conic — on edge-on splats.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from dss_tpu_torch.geometry.cameras import (  # noqa: E402
    FoVPerspectiveCameras,
    look_at_view_transform,
)
from dss_tpu_torch.geometry.pointclouds import PointClouds, PointFilters  # noqa: E402

__all__ = [
    "PointClouds",
    "PointFilters",
    "FoVPerspectiveCameras",
    "look_at_view_transform",
]
