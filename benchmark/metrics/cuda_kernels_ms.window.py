"""Device ms per step in the port's own kernels (ops/csrc: K1-K5 and
symeig3), the `cuda_kernels` group of kernel_groups.json."""
from benchmark import layer


def read(ctx):
    return layer.group_ms(ctx, "cuda_kernels")
