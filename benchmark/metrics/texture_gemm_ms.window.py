"""Device ms per step in the neural texture decoder's matrix products: the
profiler rows of the float32 GEMMs that cuBLAS and CUTLASS run for the
decoder's 40,000-row products (forward, input and weight gradients: the
tile shapes below) with cuBLASLt's split-K reductions of the weight
gradients, and of any hand-written kernel named `texture_*`.  The pattern
was read off the flagship's and this cell's traces on the H100: the rows
only this cell launches, 15 GEMMs and 5 split-K reductions a step.  It
also takes one 64x64 GEMM and one split-K reduction a step that the
flagship's step runs too (about 12 us of some 4.3 ms), so the time is a
little long, never short."""
import re

PATTERN = re.compile(
    r"(^|::|\s)texture_\w*[<(]|splitKreduce"
    r"|gemm\w*_tilesize(64x64|64x128|128x32|128x128)x"
    r"|simt_sgemm_(64x128|128x32|128x256|256x128)_")


def read(ctx):
    s = ctx["summary"]
    if not s:
        return None
    us = sum(v for k, v in s["name_us"].items() if PATTERN.search(k))
    return us / 1e3 / s["steps"] if us > 0 else None
