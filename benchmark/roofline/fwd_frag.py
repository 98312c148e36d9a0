"""K5, the fragment forward (ops/csrc/fwd_frag.cu): 24 float operations
per (pixel, splat) pair inside the splat's box.  Bytes, each once: 14
floats per rasterized splat, K slots of z, conic value and id per pixel,
the count and weighted sums (r, g, b, 1) per pixel, a visibility flag per
(view, point)."""
from benchmark.counts import view_points

KERNEL = "fwd_frag_kernel"
OPS_PER_PAIR = 24


def work(t):
    if t["lean"]:
        return None
    px = t["views"] * t["image_size"] ** 2
    return (t["box_pairs"] * OPS_PER_PAIR,
            t["rendered"] * 14 * 4 + px * (3 * t["points_per_pixel"] + 5) * 4
            + view_points(t) * 4)
