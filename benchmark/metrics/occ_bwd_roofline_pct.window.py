"""K2's share of its roofline: its least time (the larger of its counted
operations over the float32 peak and its counted bytes over the memory
peak, roofline/occ_bwd.py on the reference's tables of the traced steps)
over its profiled time per launch (one launch per step)."""
from benchmark import layer


def read(ctx):
    mod = layer.roofline(ctx, "occ_bwd")
    ms = layer.kernel_ms_per_launch(ctx, mod.KERNEL)
    w = layer.work(ctx, "occ_bwd")
    if ms is None or w is None or w[0] <= 0:
        return None
    return 100.0 * layer.bound_ms(ctx, *w) / ms
