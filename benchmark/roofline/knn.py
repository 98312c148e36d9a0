"""The exact kNN, one fused kernel per kNN of the step
(ops/csrc/knn_topk.cu: distances, masks and the top-k selection in
registers): 2 * Q * P * 3 float operations for Q queries against P
points, the distances' dot products.  Bytes, each once: of both point
sets, per point the 3 coordinates, the squared norm and the mask byte;
per query the k results, a float32 distance and an int64 index each.
No Q x P matrix is written."""
KERNEL = "knn_topk_kernel"
POINT_BYTES = 4 * 4 + 1
RESULT_BYTES = 4 + 8


def work(t):
    ops = sum(2 * q * p * 3 for q, p, _ in t["knn"])
    return ops, sum((q + p) * POINT_BYTES + q * k * RESULT_BYTES
                    for q, p, k in t["knn"])
