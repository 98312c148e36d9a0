"""The step's exact kNNs' share of their roofline: their least time (the
larger of roofline/knn.py's operations over the float32 peak and its bytes
over the memory peak, for every kNN of the step, each scene's, on the
reference's tables of the traced steps) over the profiled device time per
step of the `knn_topk_kernel` rows (ops/csrc/knn_topk.cu, one launch per
kNN, a template: `knn_topk_kernel<slots>(...)`)."""
import re

from benchmark import layer


def read(ctx):
    s = ctx["summary"]
    if not s:
        return None
    kernel = layer.roofline(ctx, "knn").KERNEL
    pat = re.compile(rf"(^|::){re.escape(kernel)}[<(]")
    us = sum(v for k, v in s["name_us"].items() if pat.search(k))
    if us <= 0:
        return None
    w = layer.work(ctx, "knn")
    if w is None or w[0] <= 0:
        return None
    return 100.0 * layer.bound_ms(ctx, *w) / (us / 1e3 / s["steps"])
