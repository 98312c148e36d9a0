"""K1, the lean forward (ops/csrc/fwd_lean.cu): 26 float operations per
(pixel, splat) pair inside the splat's box.  Bytes, each once: 14 floats
per rasterized splat (position, conic, cutoff, radii, scaler, colour),
the per-pixel count and weighted sums (r, g, b, 1 and z with the depth
channel), a visibility flag per (view, point)."""
from benchmark.counts import view_points

KERNEL = "fwd_lean_kernel"
OPS_PER_PAIR = 26


def work(t):
    if not t["lean"]:
        return None
    px = t["views"] * t["image_size"] ** 2
    cols = 6 if t["depth_channel"] else 5
    return (t["box_pairs"] * OPS_PER_PAIR,
            t["rendered"] * 14 * 4 + px * cols * 4 + view_points(t) * 4)
