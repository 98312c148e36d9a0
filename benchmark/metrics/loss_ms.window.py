"""Device ms per step in the losses' spans, the kNN excluded (self time of
loss.* and bwd.loss.*), from the program's spans (benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    got = spans.collect(ctx)
    return None if got is None else got["loss_ms"]
