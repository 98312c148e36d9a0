"""K2, the occupancy backward (ops/csrc/occ_bwd.cu): 16 float operations
per (pixel, point) pair inside a visible on-screen point's support disc.
Bytes, each once: the occupancy cotangent per pixel, 5 floats per
visible on-screen (view, point) (position, radii), the squared disc
radius per view, and the x, y gradient per (view, point)."""
from benchmark.counts import view_points

KERNEL = "occ_bwd_kernel"
OPS_PER_PAIR = 16


def work(t):
    px = t["views"] * t["image_size"] ** 2
    return (t["disc_pairs"] * OPS_PER_PAIR,
            px * 4 + t["on_screen"] * 5 * 4 + t["views"] * 4
            + view_points(t) * 2 * 4)
