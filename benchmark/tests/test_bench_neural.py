"""The neural-texture configuration (`dss_neural`, adapter `neural_point`,
reference `reference/neural_step.py`) on the CPU at a tiny size (64^2,
300 points, 4 of 16 views per step, a decoder of width 32), through the
harness's own functions: a run end to end reads correct and a fault
planted in a copy of its reference reads not correct; the data of the
point leaves is the point model's bit for bit; the decoder's work counts
and the three readers of render.texture on hand-made inputs.  On a card:
the cell's control and planted faults read not correct by its limits."""
import copy
import json

import pytest
import torch

import tiny
from benchmark import check, control, harness

SEED = 2 ** 31 + 12345
WIDTH = 32
NAME = "tiny.neural"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _neural_copy(dest):
    """A copy of the benchmark with the tiny cell and a tiny neural cell,
    added as files only: dss_neural's configuration at tiny.py's sizes and
    a decoder of width WIDTH."""
    root = tiny.make_copy(dest)
    tiny.make_copy(dest, name=NAME)
    cfg = json.loads((root / "configs" / "dss_neural.json").read_text())
    small = json.loads((root / "configs" / "tiny.json").read_text())
    cfg["renderer"]["raster_params"] = small["renderer"]["raster_params"]
    cfg["renderer"]["texture_kwargs"]["hidden_size"] = WIDTH
    cfg["model"] = small["model"]
    cfg["training"]["batch_size"] = small["training"]["batch_size"]
    (root / "configs" / "tiny_neural.json").write_text(json.dumps(cfg))
    work = json.loads((root / "workloads" / f"{NAME}.json").read_text())
    # the leaves' names from this benchmark's adapter: loading the copy's
    # would load its reference before a test plants a fault in it
    ad = harness.load_adapter("neural_point")
    rms = dict(zip(("points", "normals", "colors"), tiny.GRAD_RMS))
    rms.update({n: 3e-3 for n in ad.leaf_names(cfg)})
    work.update(config="tiny_neural", grad_rms=rms)
    (root / "workloads" / f"{NAME}.json").write_text(json.dumps(work))
    return root


@pytest.mark.parametrize("scale", [None, 1e-3])
def test_bench_tiny_neural_cell_runs_and_its_reference_decides(tmp_path,
                                                               scale):
    """The run end to end reads correct; with the copy's neural reference's
    loss scaled by (1 + scale) it reads not correct."""
    root = _neural_copy(tmp_path)
    ref_file = root / "reference" / "neural_step.py"
    if scale is not None:
        text = ref_file.read_text()
        old = "        return total, parts, visibility, inmask\n"
        assert text.count(old) == 1
        ref_file.write_text(text.replace(old, (
            f"        return total * (1.0 + {scale!r}), parts, visibility, "
            "inmask\n")))
    cell = harness.load_cell(NAME, root)
    ad = harness.adapter(cell)
    assert ad.REF.__file__ == str(ref_file.resolve())
    out = harness.run(NAME, SEED, 0.3, False, "cpu", root=root)
    assert out["correct"] is (scale is None), out["compared"]
    assert out["failed"] == 0 and out["attempted"] >= 4


def test_bench_neural_data_keeps_the_point_models_bit_for_bit(tmp_path):
    """The decoder's leaves and their Adam state are drawn after all else:
    the views, images, point leaves and their Adam state are the tiny
    point cell's, and the decoder's leaves have the program's names and
    shapes."""
    root = _neural_copy(tmp_path)
    plain = harness.make_data(harness.load_cell("tiny.window", root), SEED,
                              "cpu")
    cell = harness.load_cell(NAME, root)
    neural = harness.make_data(cell, SEED, "cpu")
    for key in ("R", "T", "img", "mask", "depth", "epochs"):
        assert torch.equal(plain[key], neural[key]), key
    for name, leaf in plain["leaves"].items():
        assert torch.equal(neural["leaves"][name], leaf), name
    for (m, v), (m2, v2) in zip(plain["moments"], neural["moments"]):
        assert torch.equal(m, m2) and torch.equal(v, v2)
    drv = harness.load_module(root / "loops" / "window.py").Loop(
        cell, neural, torch.device("cpu"))
    params = drv.state.params
    assert list(params.names()) == list(neural["leaves"])
    for t, (name, leaf), (m, _) in zip(params.tensors(),
                                       neural["leaves"].items(),
                                       neural["moments"]):
        assert torch.equal(t.detach(), leaf) and m.shape == leaf.shape, name
    assert [tuple(t.shape) for t in params.tensors()[3:6]] == [
        (WIDTH, 33), (WIDTH,), (WIDTH,)]


def _ctx(tables, name_us, steps=2, step_ms=2.0):
    return {"root": harness.ROOT, "cell": harness.load_cell("dss_neural.window"),
            "tables": tables, "peak_f32": 1e9, "peak_bytes": 1e12,
            "step_ms": step_ms,
            "summary": {"name_us": name_us,
                        "name_n": {k: 1 for k in name_us}, "steps": steps}}


def _table(**kw):
    t = {"views": 2, "points": 10, "image_size": 4, "points_per_pixel": 5,
         "lean": True, "depth_channel": True, "rendered": 15,
         "box_pairs": 100, "disc_pairs": 300, "on_screen": 12,
         "knn": [(10, 10, 7), (10, 10, 11)]}
    t.update(kw)
    return t


def test_bench_texture_work_and_readers_by_hand():
    mod = harness.load_module(harness.ROOT / "roofline" / "texture_mlp.py")
    cfg = harness.load_cell("dss_neural.window").config
    w = mod.widths(cfg)
    assert w == [33, 512, 512, 512, 512, 3]
    assert mod.widths(harness.load_cell("dss_depth.window").config) is None
    assert mod.work(_table()) is None
    macs = 33 * 512 + 3 * 512 * 512 + 512 * 3
    assert macs == 804_864
    rows = 2 * 10
    acts = (33 + 512) + 3 * 1024 + (512 + 3)
    assert mod.work(_table(texture_widths=w)) == (
        6 * rows * macs, 12 * (macs + rows * acts))
    # the flagship step: 40,000 rows, 1.93e11 operations
    assert mod.work(_table(views=8, points=5000, texture_widths=w))[0] == (
        6 * 40_000 * macs)

    rows_us = {
        "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>"
        "(cutlass_80_simt_sgemm_256x128_8x4_nn_align1::Params)": 300.0,
        "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_"
        "warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas": 100.0,
        "void cublasLt::splitKreduce_kernel<32, 16, int, float>(float)": 20.0,
        "void (anonymous namespace)::texture_bwd<4>(float*)": 10.0,
        # the step's small GEMMs and elementwise rows are not the decoder's
        "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3_"
        "warpsize1x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas": 70.0,
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "BinaryFunctor<float, float, float, at::native::(anonymous namespace)"
        "::threshold_kernel_impl<float>>(int)": 50.0,
    }
    tabs = [_table(), _table(views=4)]
    ctx = _ctx(tabs, rows_us)
    load = lambda n: harness.load_module(harness.ROOT / "metrics" / f"{n}.py")
    gemm_ms = load("texture_gemm_ms.window").read(ctx)
    assert gemm_ms == pytest.approx(430.0 / 1e3 / 2)
    ops = [6 * 10 * v * macs for v in (2, 4)]
    byts = [12 * (macs + 10 * v * acts) for v in (2, 4)]
    bound_ms = max(sum(ops) / 2 / 1e9, sum(byts) / 2 / 1e12) * 1e3
    assert load("texture_roofline_pct.window").read(ctx) == pytest.approx(
        100.0 * bound_ms / gemm_ms)
    step = load("step_mfu_pct.window").read(ctx)
    assert load("neural_step_mfu_pct.window").read(ctx) == pytest.approx(
        step + 100.0 * sum(ops) / 2 / (2e-3 * 1e9))
    # nothing to read: no rows, or a cell without the texture
    assert load("texture_gemm_ms.window").read(_ctx(tabs, {})) is None
    assert load("texture_roofline_pct.window").read(_ctx(tabs, {})) is None
    plain = {**ctx, "cell": harness.load_cell("dss_depth.window")}
    assert load("neural_step_mfu_pct.window").read(plain) is None
    assert load("texture_roofline_pct.window").read(copy.copy(plain)) is None


@pytest.mark.cuda
def test_bench_neural_control_and_faults_read_not_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    cell = harness.load_cell("dss_neural.window")
    row = control.readings_for(cell, 2 ** 31 + 99, torch.device("cuda:0"),
                               False, True)
    limits = cell.workload["limits"]
    for key in ["control_tf32", *control.FAULTS]:
        assert not check.verdict(row[key], limits), (key, row[key])
