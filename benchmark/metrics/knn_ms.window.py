"""Device ms per step in the exact kNN's top-k selection rows (the `knn`
group of kernel_groups.json).  Its distance matmul's cuBLAS rows carry
the same names as the camera and EWA matmuls, so they stay in `other`."""
from benchmark import layer


def read(ctx):
    return layer.group_ms(ctx, "knn")
