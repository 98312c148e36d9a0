"""Host ms per step inside CUDAGraph.replay() (the train window's
replay_host_ns over its replays, spans on), from the program's counter
(benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    got = spans.collect(ctx)
    return None if got is None else got["launch_host_ms"]
