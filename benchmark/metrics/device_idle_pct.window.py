"""The device's idle share of the traced window: 100 * (1 - the union of
the device intervals / the window's wall time)."""
from benchmark import layer


def read(ctx):
    return layer.idle_pct(ctx)
