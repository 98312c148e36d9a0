"""The benchmark's own work counts and trace reduction on hand-made
inputs."""
import re

import pytest
import torch

from benchmark import counts, harness, layer, trace

ref = harness.load_adapter("dss_point").REF

S = 16


def _pix(j):
    """NDC centre of pixel column (or row) j."""
    return 1.0 - (2.0 * j + 1.0) / S


def test_bench_box_pairs_count_the_pixel_centres_in_each_box():
    # a box of half-width 1.5 pixels centred on a pixel: 3 x 3 centres;
    # one reaching over the image's corner: 2 x 2; one culled; one behind
    # the camera
    half = 1.5 * 2.0 / S
    pts = torch.tensor([[[_pix(5), _pix(7), 1.0], [_pix(0), _pix(0), 1.0],
                         [_pix(9), _pix(9), 1.0], [_pix(3), _pix(3), -1.0]]])
    radii = torch.full((1, 4, 2), half)
    cutoff = torch.tensor([[1.0, 1.0, -float("inf"), 1.0]])
    spl = ref.Splats(pts, torch.zeros(1, 4, 3), cutoff, radii,
                     torch.ones(1, 4))
    assert counts.box_pairs(spl, S) == 9 + 4


def test_bench_disc_pairs_count_the_pixel_centres_in_each_disc():
    # radius 1.2 pixels around a pixel centre: the centre and its 4
    # neighbours (the diagonals lie at 1.41); radius 0 pixels: nothing
    pts = torch.tensor([[[_pix(6), _pix(6), 1.0], [_pix(2), _pix(9), 1.0]],
                        [[_pix(6), _pix(6), 1.0], [_pix(2), _pix(9), 1.0]]])
    ok = torch.tensor([[True, True], [True, False]])
    r = 1.2 * 2.0 / S
    r2 = torch.tensor([r * r, r * r])
    assert counts.disc_pairs(pts, ok, r2, S) == 5 + 5 + 5
    assert counts.disc_pairs(pts, ok, torch.zeros(2), S) == 0


def _table(**kw):
    t = {"views": 2, "points": 10, "image_size": 4, "points_per_pixel": 5,
         "lean": True, "depth_channel": True, "rendered": 15,
         "box_pairs": 100, "disc_pairs": 300, "on_screen": 12,
         "knn": [(10, 10, 7), (10, 10, 11)]}
    t.update(kw)
    return t


def _roof(name):
    return harness.load_module(harness.ROOT / "roofline" / f"{name}.py")


def test_bench_roofline_work_on_a_hand_made_table():
    t = _table()
    px = 2 * 16
    assert _roof("occ_bwd").work(t) == (300 * 16, px * 4 + 12 * 20 + 2 * 4
                                        + 2 * 10 * 8)
    assert _roof("fwd_lean").work(t) == (100 * 26, 15 * 56 + px * 24 + 80)
    assert _roof("feat_bwd").work(t) == (100 * 24, 15 * 56 + px * 20
                                         + 2 * 10 * 16)
    assert _roof("fwd_frag").work(t) is None
    assert _roof("fwd_lean").work(_table(lean=False)) is None
    assert _roof("fwd_frag").work(_table(lean=False))[0] == 100 * 24
    # the point sets' coordinates, squared norm and mask byte, and the k
    # results' float32 distance and int64 index: no 10 x 10 matrix
    assert _roof("knn").work(t) == (2 * (2 * 10 * 10 * 3),
                                    2 * 20 * 17 + 10 * (7 + 11) * 12)


def test_bench_step_mfu_and_roofline_read_the_tables():
    ctx = {"root": harness.ROOT, "tables": [_table(), _table(disc_pairs=500)],
           "peak_f32": 1e9, "peak_bytes": 1e12, "step_ms": 2.0,
           "summary": {"name_us": {"(anonymous namespace)::occ_bwd_kernel("
                                   "int const*)": 40.0,
                                   "other_occ_bwd_kernel(int)": 5.0},
                       "name_n": {"(anonymous namespace)::occ_bwd_kernel("
                                  "int const*)": 2,
                                  "other_occ_bwd_kernel(int)": 1},
                       "steps": 2}}
    ops = 100 * 26 + 400 * 16 + 100 * 24 + 2 * 600
    mfu = harness.load_module(harness.ROOT / "metrics" / "step_mfu_pct.window.py")
    assert mfu.read(ctx) == pytest.approx(100.0 * ops / (2e-3 * 1e9))
    roof = harness.load_module(
        harness.ROOT / "metrics" / "occ_bwd_roofline_pct.window.py")
    # bound 400 * 16 ops / 1e9 = 6.4 us over 20 us per launch
    assert roof.read(ctx) == pytest.approx(100.0 * 6.4 / 20.0)


def test_bench_trace_summary_groups_union_and_gaps():
    groups = [(re.compile("^occ_bwd_kernel"), "cuda_kernels"),
              (re.compile("TopK"), "knn")]
    dev = [("occ_bwd_kernel(x)", 0.0, 10.0), ("elementwise", 5.0, 20.0),
           ("gatherTopK", 50.0, 60.0), ("elementwise", 100.0, 110.0)]
    host = [("cudaGraphLaunch", 15.0, 55.0), ("aten::item", 58.0, 104.0)]
    s = trace.summarise(dev, host, 200.0, 2, groups)
    assert s["busy_us"] == 20.0 + 10.0 + 10.0
    assert s["group_us"] == {"cuda_kernels": 10.0, "other": 25.0, "knn": 10.0}
    assert s["group_n"]["other"] == 2
    gaps = s["breakdown"]["idle_gaps"]
    assert [g[0] for g in gaps] == ["aten::item", "cudaGraphLaunch"]
    assert [g[1] for g in gaps] == pytest.approx([40e-6, 30e-6])
    assert s["breakdown"]["device_ops"][0][0] == "elementwise"
    ctx = {"summary": s}
    assert layer.idle_pct(ctx) == pytest.approx(80.0)
    assert layer.group_ms(ctx, "knn") == pytest.approx(10.0 / 1e3 / 2)
    assert layer.group_ms(ctx, "binning") is None


def test_bench_kernel_groups_claim_the_ports_kernels():
    groups = trace.load_groups()
    for k in ("fwd_lean", "occ_bwd", "feat_bwd", "segment_sum", "fwd_frag",
              "symeig3"):
        assert trace.group_of(f"(anonymous namespace)::{k}_kernel(int "
                              "const*, float const*)", groups) == "cuda_kernels"
    for name, group in [
            ("void at::native::vectorized_elementwise_kernel<4>", "other"),
            ("void at::native::mbtopk::gatherTopK<float, unsigned int, 2>",
             "knn"),
            ("at::native::mbtopk::computeDigitCumSum(short*)", "knn"),
            ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8",
             "other"),
            ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<>",
             "binning"),
            ("void at::native::bitonicSortKVInPlace<2, -1, 16>", "binning"),
            ("void at::native::searchsorted_cuda_kernel<long, long>",
             "binning")]:
        assert trace.group_of(name, groups) == group, name
