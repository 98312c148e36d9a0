"""Device ms per step in the kNN's spans (every outermost geometry.knn span
whole: the fused knn_topk kernel and the wrapper's squared norms), from
the program's spans (benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    got = spans.collect(ctx)
    return None if got is None else got["geometry_knn_ms"]
