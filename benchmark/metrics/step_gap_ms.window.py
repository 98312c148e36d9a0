"""Device ms from one step's end stamp to the next step's start stamp, the
mean over the traced steps' neighbours, dispatch boundaries included,
from the program's spans (benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    got = spans.collect(ctx)
    return None if got is None else got["step_gap_ms"]
