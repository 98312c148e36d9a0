"""The neural texture's decoder (`render.texture`: IDR's rendering network,
weight-normed layers of the widths the cell's configuration gives, over
one row per (view, point) of a step): its matrix products forward, for
the input gradients and for the weight gradients, 2 float operations per
multiply-add each, so 6 * rows * sum(in * out) per step.  Bytes, each
once per pass of each layer: its weights (in * out), the activations it
reads (rows * in) and those it writes (rows * out), three passes, 4 bytes
a float.  The weight norm, the biases and the ReLUs are left out of both:
they are elementwise work beside the products."""
from benchmark import layer, program
from benchmark.counts import view_points


def widths(config: dict):
    """Each layer's input width, then the output width (3), as the
    program's factory reads them; None without a neural texture."""
    r = config["renderer"]
    if not r.get("is_neural_texture", False):
        return None
    tk = r["texture_kwargs"]
    freqs = int(tk["view_freqs"])
    in_dim = 6 + (3 * (2 * freqs + 1) if tk["view_dependent"] else 0)
    return [in_dim] + [int(tk["hidden_size"])] * int(tk["n_layers"]) + [3]


def work(t):
    """(operations, bytes) of one step's table `t` with the decoder's
    widths under `texture_widths`; None without them."""
    w = t.get("texture_widths")
    if not w:
        return None
    rows = view_points(t)
    pairs = list(zip(w[:-1], w[1:]))
    return (6 * rows * sum(a * b for a, b in pairs),
            3 * 4 * sum(a * b + rows * (a + b) for a, b in pairs))


def per_step(ctx):
    """(operations, bytes) per step, the mean over the traced steps, with
    the cell's widths; None where the cell has no neural texture."""
    w = widths(program.run_config(ctx["cell"]))
    if w is None:
        return None
    got = [work({**t, "texture_widths": w}) for t in layer.tables(ctx)]
    if not got:
        return None
    return (sum(g[0] for g in got) / len(got),
            sum(g[1] for g in got) / len(got))
