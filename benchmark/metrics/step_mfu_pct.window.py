"""The whole step's share of the float32 peak: the float operations the
step needs (the splat kernels' pairs times operations per pair and the
kNNs' distance dot products, counted by the roofline files on the reference's
tables of the traced steps) over the run's measured train_step_ms times
67 TFLOP/s.  It counts the work, not the kernels that do it, so it stays
a bound when a kernel is fused away."""
from benchmark import layer

KERNELS = ("fwd_lean", "fwd_frag", "occ_bwd", "feat_bwd", "knn")


def read(ctx):
    ops = 0.0
    for k in KERNELS:
        w = layer.work(ctx, k)
        if w is not None:
            ops += w[0]
    if ops <= 0:
        return None
    return 100.0 * ops / (ctx["step_ms"] * 1e-3 * ctx["peak_f32"])
