"""The neural texture decoder's share of its roofline: its least time (the
larger of its counted operations over the float32 peak and its counted
bytes over the memory peak, roofline/texture_mlp.py with the cell's
widths on the traced steps' views and points) over its profiled time per
step (texture_gemm_ms)."""
from benchmark import layer
from benchmark.harness import load_module


def read(ctx):
    w = layer.roofline(ctx, "texture_mlp").per_step(ctx)
    ms = load_module(ctx["root"] / "metrics"
                     / "texture_gemm_ms.window.py").read(ctx)
    if w is None or ms is None or w[0] <= 0:
        return None
    return 100.0 * layer.bound_ms(ctx, *w) / ms
