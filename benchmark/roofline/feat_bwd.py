"""K3, the feature backward (ops/csrc/feat_bwd.cu): 24 float operations
per (pixel, splat) pair inside the splat's box.  Bytes, each once: 14
floats per rasterized splat, the composite's cotangent per pixel (r, g,
b, weight, and z with the depth channel), 4 sums per (view, point)."""
from benchmark.counts import view_points

KERNEL = "feat_bwd_kernel"
OPS_PER_PAIR = 24


def work(t):
    px = t["views"] * t["image_size"] ** 2
    cols = 5 if t["depth_channel"] else 4
    return (t["box_pairs"] * OPS_PER_PAIR,
            t["rendered"] * 14 * 4 + px * cols * 4
            + view_points(t) * 4 * 4)
