"""Device ms per step in the splat ops' spans (self time of splat.* and
bwd.splat: the binning, K1-K5 and their glue), from the program's spans
(benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    got = spans.collect(ctx)
    return None if got is None else got["splat_ms"]
