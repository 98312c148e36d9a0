"""On a card: each cell's control (the reference computed with TF32
matmuls, put in the program's place) and each planted fault the cell can
have read not correct by the cell's own limits, at the cell's own size.
Skips where there is no card."""
import pytest
import torch

from benchmark import check, control, harness

CELLS = ["dss_depth.window", "dss_default.window",
         "dss_depth.window_frag"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_bench_control_and_faults_read_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    cell = harness.load_cell(name)
    row = control.readings_for(cell, 2 ** 31 + 99, torch.device("cuda:0"),
                               False, True)
    limits = cell.workload["limits"]
    keys = ["control_tf32", *control.FAULTS]
    if int(cell.config["training"]["batch_size"]) < 2:
        keys.remove("half_batch")  # one view has no half to leave out
    for key in keys:
        assert not check.verdict(row[key], limits), (key, row[key])
