"""Device operations per step in the rows no group claims."""
from benchmark import layer


def read(ctx):
    return layer.group_kernels(ctx, "other")
