"""Device ms per step in the model's and the renderer's own spans (self time of
model.*, render.* and bwd.render.*: the Vrk, shading and EWA set-up, the
composite and the filters, forward and backward), from the program's
spans (benchmark/spans.py)."""
from benchmark import spans


def read(ctx):
    got = spans.collect(ctx)
    return None if got is None else got["render_ms"]
