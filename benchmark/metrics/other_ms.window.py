"""Device ms per step in every row no group of kernel_groups.json claims:
the elementwise kernels of the model, renderer, losses and update."""
from benchmark import layer


def read(ctx):
    return layer.group_ms(ctx, "other")
