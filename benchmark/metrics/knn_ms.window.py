"""Device ms per step in the exact kNN's rows (the `knn` group of
kernel_groups.json): `knn_topk_kernel`, one launch per kNN, which
computes the distances, applies the masks and selects the top k
(ops/csrc/knn_topk.cu).  The wrapper's squared norms are elementwise
rows in `other`; `geometry_knn_ms` holds both."""
from benchmark import layer


def read(ctx):
    return layer.group_ms(ctx, "knn")
