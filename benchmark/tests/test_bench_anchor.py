"""The jet-anchored normal refine (`dss_jet`, adapter `anchor_point`,
reference `reference/anchor_step.py`) on the CPU at tiny sizes: the
reference's median's even count, the start normals, three steps of the
port's window against the reference through the harness's own
functions, the planted faults above the tolerances, and the anchor's
work count and readers by hand.  Nothing here imports JAX: the
reference's targets are tied to the JAX package's spec in
tests/test_anchor_reference_spec.py, and the card's test of the cell is
test_bench_anchor_card.py."""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import tiny
from benchmark import harness

SEED = 2 ** 31 + 4242
NAME = "tiny.jet"
AD = harness.load_adapter("anchor_point")
REF = AD.REF
# Three steps of the port's window against the reference on the CPU: both
# run float32 in a different order (the kNN's distances, einsum against
# matmul, the 6x6 solve's LU), so the gaps are round-off, 1e-9 to 1e-8 at
# this size; the limits leave 100x room below and lie 1000x under the
# faults' readings (a dropped anchor: 4e-2 and 1e-1, one jet pass: 1e-2)
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("values", [[4.0, 1.0, 3.0, 2.0],
                                    [4.0, 1.0, 3.0, 2.0, 9.0],
                                    [5.0, float("nan"), 1.0, 2.0, 8.0]])
def test_bench_median_takes_the_mean_of_the_two_middle_values(values):
    """The median as numpy takes it: the mean of the two middle values of
    an even count, the NaNs left out; "lower" takes torch.nanmedian's
    lower middle; NaN where every value is."""
    x = torch.tensor(values)
    want = float(np.nanmedian(values))
    assert float(REF.median_of(x)) == want
    assert float(REF.median_of(x, "lower")) == float(torch.nanmedian(x))
    if np.sum(~np.isnan(values)) % 2 == 0:
        assert float(REF.median_of(x, "lower")) < want
    assert math.isnan(float(REF.median_of(torch.full((3,), float("nan")))))


def test_bench_start_normals_are_tilted_smoothly_and_shared(jet_root):
    """The start normals on the generator's sphere: every tilt under 49.3
    degrees, 1 - cos to the radial normal 0.3 on average, a function of
    the point alone; the program's objects and the reference's trainer
    start from the same tensor, bit for bit, and the generator's data is
    not changed."""
    g = torch.Generator().manual_seed(3)
    p = torch.randn((20000, 3), generator=g)
    p = 0.5 * p / torch.linalg.vector_norm(p, dim=1, keepdim=True)
    radial = p / 0.5
    n = AD.tilt(p, radial)
    cos = torch.sum(n * radial, dim=-1)
    assert float(torch.rad2deg(torch.acos(cos.clamp(max=1))).max()) < 49.3
    assert 0.29 < float((1 - cos).mean()) < 0.32
    assert torch.equal(AD.tilt(p[:7], radial[:7]), n[:7])

    cell = harness.load_cell(NAME, jet_root)
    data = harness.make_data(cell, SEED, "cpu")
    radial = data["leaves"]["normals"].clone()
    state = AD.program_objects(cell, data, "cpu")[3]
    tr, _, _ = AD.reference_trainer(cell, data)
    assert torch.equal(state.params.normals.detach(), tr.params[1])
    assert torch.equal(data["leaves"]["normals"], radial)
    assert not torch.equal(tr.params[1], radial)


@pytest.fixture(scope="module")
def jet_root(tmp_path_factory):
    """A copy of the benchmark with a tiny jet cell, added as files only:
    dss_jet's configuration at 32^2 (tile 16), 300 points, 4 of 16 views
    per step, from its start step."""
    root = tiny.make_copy(tmp_path_factory.mktemp("bench_jet"), name=NAME)
    cfg = json.loads((root / "configs" / "dss_jet.json").read_text())
    cfg["renderer"]["raster_params"].update(image_size=32, tile_size=16)
    cfg["model"]["model_kwargs"]["n_points_per_cloud"] = 300
    cfg["training"]["batch_size"] = 4
    (root / "configs" / "tiny_jet.json").write_text(json.dumps(cfg))
    work = json.loads((root / "workloads" / f"{NAME}.json").read_text())
    work.update(config="tiny_jet", start_step=9600)
    (root / "workloads" / f"{NAME}.json").write_text(json.dumps(work))
    return root


@pytest.fixture(scope="module")
def first_steps(jet_root):
    """The tiny jet cell, its data, and the program's first three steps
    from its start (the window, eager on the CPU)."""
    cell = harness.load_cell(NAME, jet_root)
    data = harness.make_data(cell, SEED, "cpu")
    loop = harness.load_module(jet_root / "loops" / "window.py").Loop
    drv = loop(cell, data, torch.device("cpu"))
    return cell, data, drv.first_steps(3)


FAULTS = {"anchor dropped": dict(weight=0.0),
          "one jet pass": dict(jet_passes=1)}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_bench_window_matches_the_reference_and_faults_do_not(
        fault, first_steps, monkeypatch):
    """Three steps of the port's window with the jet anchor against the
    reference's from the same seeded state: loss within LOSS_TOL, the
    normals' first gradient within GRAD_TOL (the normals are the one
    trained leaf); with a fault planted in the reference's anchor both
    read above them."""
    cell, data, prog = first_steps
    ad = harness.adapter(cell)
    if fault is not None:
        base = ad.anchor_of
        monkeypatch.setattr(ad, "anchor_of", lambda c: dataclasses.replace(
            base(c), **FAULTS[fault]))
    ref = harness.reference_first_steps(cell, data, 3)
    assert [lr > 0 for lr in ref["lr"]] == [False, True, False]
    got = harness.compare(data, prog, ref)
    if fault is None:
        assert got["loss_gap"] <= LOSS_TOL and got["grad_gap"] <= GRAD_TOL, got
        assert ref["losses"][0] > 0
    else:
        assert (got["loss_gap"] > 1e3 * LOSS_TOL
                and got["grad_gap"] > 1e3 * GRAD_TOL), got


def test_bench_jet_work_and_readers_by_hand():
    """roofline/jet_anchor.py's count on hand-made tables; anchor_ms'
    pattern on hand-made rows; anchor_step_mfu_pct as step_mfu_pct's
    operations plus the anchor's; nothing to read in a cell without the
    jet anchor."""
    mod = harness.load_module(harness.ROOT / "roofline" / "jet_anchor.py")
    cfg = harness.load_cell("dss_jet.window").config
    assert mod.anchor_k(cfg) == 48
    assert mod.anchor_k(harness.load_cell("dss_depth.window").config) is None
    t = {"views": 2, "points": 10, "image_size": 4, "points_per_pixel": 5,
         "lean": True, "depth_channel": False, "rendered": 15,
         "box_pairs": 100, "disc_pairs": 300, "on_screen": 12,
         "knn": [(10, 10, 7), (10, 10, 11)]}
    assert mod.work(t) is None
    # k cut at P = 10: the kNN, then two passes of 10 points x 10
    # neighbours x 42 multiply-adds and 216 operations of the solve
    assert mod.work({**t, "jet_k": 48}) == (
        2 * 10 * 10 * 3 + 2 * 10 * (2 * 10 * 42 + 216), 2 * 10 * 10 * 6 * 4)
    # the cell's step: 5000 points, k 48
    ops = mod.work({**t, "points": 5000, "jet_k": 48})[0]
    assert ops == 2 * 5000 ** 2 * 3 + 2 * 5000 * (2 * 48 * 42 + 216)

    load = lambda n: harness.load_module(harness.ROOT / "metrics" / f"{n}.py")
    rows = {name: 100.0 for name in ANCHOR_ROWS}
    rows.update({name: 1000.0 for name in OTHER_ROWS})
    ctx = {"root": harness.ROOT, "cell": harness.load_cell("dss_jet.window"),
           "tables": [t, {**t, "views": 4}], "peak_f32": 1e9,
           "peak_bytes": 1e12, "step_ms": 2.0,
           "summary": {"name_us": rows, "name_n": {k: 1 for k in rows},
                       "steps": 2}}
    assert load("anchor_ms.window").read(ctx) == pytest.approx(
        100.0 * len(ANCHOR_ROWS) / 1e3 / 2)
    step = load("step_mfu_pct.window").read(ctx)
    jet = mod.work({**t, "jet_k": 48})[0]
    assert load("anchor_step_mfu_pct.window").read(ctx) == pytest.approx(
        step + 100.0 * jet / (2e-3 * 1e9))
    empty = {**ctx, "summary": {**ctx["summary"], "name_us": {
        k: v for k, v in rows.items() if k in OTHER_ROWS}}}
    assert load("anchor_ms.window").read(empty) is None
    plain = {**ctx, "cell": harness.load_cell("dss_depth.window")}
    assert load("anchor_step_mfu_pct.window").read(plain) is None


# Rows that only the anchor launches, and rows of the flagship's step, as
# the H100's profiler names them
GEMV = ("std::enable_if<true, void>::type internal::gemvx::kernel<int, int, "
        "float, float, float, float, true, true, true, false, 5, false, "
        "cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<float const>, "
        "cublasGemvTensorStridedBatched<float const>, "
        "cublasGemvTensorStridedBatched<float>, float> >(cublasGemvParamsEx")
KNN = ("void (anonymous namespace)::knn_topk_kernel<{}>(float const*, float "
       "const*, bool const*, float const*, float const*, bool const*, float*, "
       "long long*, int, int, int, int, int, int)")
GEMM = ("sm80_xmma_gemm_f32f32_f32f32_f32_{}_n_tilesize{}x8_stage3_warpsize1x"
        "2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas")
ANCHOR_ROWS = [
    KNN.format(2), GEMV, GEMM.format("nt", "32x32"),
    "void getrf_semiwarp<float, float, 3, 1, true>(int, float* const*, int, "
    "int*, int*, int)",
    "void laswp_kernel<float, false>(int, float* const*, int, int, int, int "
    "const*, int, int, int)",
    "void trsm_batch_left_lower_kernel<float>(cublasTrsmBatchParams<float>, "
    "float const* const*, float* const*, float const*, float)",
    "void trsm_batch_left_upper_kernel<float>(cublasTrsmBatchParams<float>, "
    "float const* const*, float* const*, float const*, float)",
]
OTHER_ROWS = [
    KNN.format(1), GEMM.format("nn", "64x32"),
    "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<float>(int)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "BinaryFunctor<float, float, float, at::native::binary_internal::"
    "MulFunctor<float> >, std::array<char*, 3ul> >(int)",
]
