"""Device ms per step in the update span (the finite guard, the guarded
Adam, the filter copies and the window's metrics), from the program's
spans (benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    got = spans.collect(ctx)
    return None if got is None else got["update_ms"]
