"""A tiny cell in a copy of the benchmark, for the CPU tests: the
flagship's configuration at 64^2 (tile 16), 300 points, 16 views, 4 per
step, run through the harness's own functions on the CPU, where the
port's splat ops take their plain versions."""
import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
# the reference's gradient scale per leaf at this size (points, normals,
# colours), and limits for the CPU, where both sides run the same float32
# operations in a different order
GRAD_RMS = [9e-3, 4e-4, 6e-4]
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "sq_gap": 1e-3,
          "change_gap": 1e-2}


def make_copy(dest: Path, loop: str = "window", overrides=None,
              name: str = "tiny.window", limits=None,
              adapter: str = None) -> Path:
    """A copy of the benchmark under `dest` with one more cell, `name`,
    added as files only; returns the copy's root (`dest/benchmark`).
    With `adapter`, the cell's configuration names an adapter of that
    name, added as files too: `adapters/<adapter>.py`, the default
    adapter whose reference is `reference/<adapter>_step.py`, a verbatim
    copy of `reference/dss_step.py`."""
    root = dest / "benchmark"
    if not root.exists():
        shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
            "__pycache__", "tests"))
        shutil.copy(BENCH.parent / "BENCHMARK.json", dest / "BENCHMARK.json")
    cfg = json.loads((BENCH / "configs" / "dss_depth.json").read_text())
    if adapter is not None:
        default = (BENCH / "adapters" / "dss_point.py").read_text()
        assert default.count('"dss_step.py"') == 1
        (root / "adapters" / f"{adapter}.py").write_text(
            default.replace('"dss_step.py"', f'"{adapter}_step.py"'))
        shutil.copy(BENCH / "reference" / "dss_step.py",
                    root / "reference" / f"{adapter}_step.py")
        cfg["adapter"] = adapter
    cfg["renderer"]["raster_params"].update(image_size=64, tile_size=16)
    cfg["model"]["model_kwargs"]["n_points_per_cloud"] = 300
    cfg["training"]["batch_size"] = 4
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    dataset = json.loads((BENCH / "datasets" / "mvr128.json").read_text())
    dataset.update(n_views=16)
    (root / "datasets" / "tiny.json").write_text(json.dumps(dataset))
    traffic = json.loads((BENCH / "traffic" / f"{loop}.json").read_text())
    traffic.update(dataset="tiny", profile_steps=4)
    (root / "traffic" / f"tiny_{loop}.json").write_text(json.dumps(traffic))
    work = {"config": "tiny", "traffic": f"tiny_{loop}", "start_step": 3200,
            "cycle_steps": 4, "check_steps": 3, "why": "tiny",
            "raster_overrides": overrides or {}, "grad_rms": GRAD_RMS,
            "limits": limits or LIMITS}
    (root / "workloads" / f"{name}.json").write_text(json.dumps(work))
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    step = traffic["step_metric"]
    spec = copy.deepcopy(spec)
    for m in spec["end_to_end"]:
        if m["name"] == step:
            m["workloads"].append(name)
    spec["workloads"].append({"name": name, "config": "tiny",
                              "traffic": f"tiny_{loop}", "chips": 1,
                              "why": "tiny"})
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
