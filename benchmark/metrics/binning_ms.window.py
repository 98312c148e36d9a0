"""Device ms per step in the binning's sort and searchsorted rows (the
`binning` group of kernel_groups.json)."""
from benchmark import layer


def read(ctx):
    return layer.group_ms(ctx, "binning")
