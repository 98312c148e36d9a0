"""Device ms per step in the rows that, in `dss_jet.window`, only the
normal anchor launches (`loss.anchor`: the jet target,
`geometry.normals.refine_normals`), read off this cell's and the
flagship's traces on the H100: the 64-key form of the fused kNN
(`knn_topk_kernel<2>`, the anchor's 48-NN; the step's other kNNs take
the 32-key form), cuBLAS's batched 6x6 LU and solve (`getrf_*`,
`laswp_kernel`, `trsm_batch_*`), the Gram's batched GEMM (the 32x32x8
tile; the flagship's only GEMMs take 64x32x8) and the strided-batched
GEMVs of the frame's projections, the right side and the bilateral
passes.  cuBLAS picks its kernels by shape: the same step without the
normal term launches none of these rows, but `dss_default.window` does
launch a 32x32x8 GEMM and `dss_neural.window` a strided-batched GEMV
(benchmark/tests/test_bench_anchor_card.py), so the metric holds for
`dss_jet.window` alone.  It leaves out the anchor's elementwise passes,
its concatenations and the median's sort, whose rows other layers launch
too: the `loss.anchor` span holds them all."""
import re

PATTERN = re.compile(
    r"knn_topk_kernel<2>|getrf_|laswp_kernel|trsm_batch_"
    r"|cublasGemvTensorStridedBatched|gemm\w*_tilesize32x32x8")


def read(ctx):
    s = ctx["summary"]
    if not s:
        return None
    us = sum(v for k, v in s["name_us"].items() if PATTERN.search(k))
    return us / 1e3 / s["steps"] if us > 0 else None
