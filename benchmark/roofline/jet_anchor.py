"""The jet normal anchor (`training.losses.normal_consistency_terms` with
anchor "jet": `geometry.normals.refine_normals` over K = min(max(
normal_anchor_k, 16), P) neighbours of P points), per step:

- operations: its kNN, 2 * P * P * 3 (the distances' dot products, as
  roofline/knn.py counts a kNN); per jet pass, P * K * (36 + 6)
  multiply-adds of the 6 x 6 Gram and its right side, 2 operations each,
  and per point the 6 x 6 LU, 2/3 * 6^3 = 144, and its two triangular
  solves, 2 * 6^2 = 72;
- bytes: each pass's (P, K, 6) design matrix read once, 4 bytes a float.

Left out of both: the projections onto the frame, the weights, the tilt,
the bilateral passes and the median's sort, elementwise work beside
these."""
from benchmark import layer, program

JET_PASSES = 2  # refine_normals' default, as the loss calls it
LU_OPS = 2 * 6 ** 3 // 3 + 2 * 6 ** 2


def anchor_k(config: dict):
    """The jet's neighbourhood size before the cut at P; None where the
    configuration runs no jet anchor."""
    t = config["training"]
    if (float(t.get("lambda_dr_normal", 0.0)) <= 0
            or t.get("normal_anchor", "pca") != "jet"):
        return None
    return max(int(t.get("normal_anchor_k", 8)), 16)


def work(t):
    """(operations, bytes) of one step's table `t` with the jet's
    neighbourhood size under `jet_k`; None without it.  With stacked
    scenes, each scene's anchor over its own points, times the scenes."""
    k0 = t.get("jet_k")
    if not k0:
        return None
    n = t.get("scenes", 1)
    p = t["points"] // n
    k = min(k0, p)
    ops = 2 * p * p * 3 + JET_PASSES * p * (2 * k * (36 + 6) + LU_OPS)
    return n * ops, n * JET_PASSES * p * k * 6 * 4


def per_step(ctx):
    """(operations, bytes) per step, the mean over the traced steps; None
    where the cell runs no jet anchor."""
    k = anchor_k(program.run_config(ctx["cell"]))
    if k is None:
        return None
    got = [work({**t, "jet_k": k}) for t in layer.tables(ctx)]
    if not got:
        return None
    return (sum(g[0] for g in got) / len(got),
            sum(g[1] for g in got) / len(got))
