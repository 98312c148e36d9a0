"""The whole step's share of the float32 peak in a cell with the jet
normal anchor: the float operations step_mfu_pct counts (the splat
kernels' pairs and the kNNs' distances) plus the anchor's
(roofline/jet_anchor.py: its kNN, the jet passes' Gram products and 6 x 6
solves), over the run's measured train_step_ms times 67 TFLOP/s.  It
counts the work, not the kernels that do it."""
from benchmark import layer
from benchmark.harness import load_module


def read(ctx):
    jet = layer.roofline(ctx, "jet_anchor").per_step(ctx)
    if jet is None:
        return None
    kernels = load_module(ctx["root"] / "metrics"
                          / "step_mfu_pct.window.py").KERNELS
    ops = jet[0]
    for k in kernels:
        w = layer.work(ctx, k)
        if w is not None:
            ops += w[0]
    return 100.0 * ops / (ctx["step_ms"] * 1e-3 * ctx["peak_f32"])
