"""The exact kNN's distance matmul (geometry/knn.py): 2 * Q * P * 3 float
operations for Q queries against P points, once per kNN of the step.
Bytes: both point sets and the Q x P distance matrix written once."""
KERNEL = None


def work(t):
    ops = sum(2 * q * p * 3 for q, p in t["knn"])
    return ops, sum((q + p) * 3 * 4 + q * p * 4 for q, p in t["knn"])
