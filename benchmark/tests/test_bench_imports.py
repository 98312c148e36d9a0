"""What a run loads: no module of JAX or of the JAX package in the
process of a run, and nothing of the program in the reference's."""
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TOP = "sorted({m.split('.', 1)[0] for m in sys.modules})"


def _modules(code: str):
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_bench_a_run_loads_no_jax(tmp_path):
    mods = _modules(f"""
        import sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'benchmark' / 'tests')!r}]
        from pathlib import Path
        import torch
        torch.set_num_threads(2)
        import tiny
        from benchmark import harness
        import benchmark.run as run
        root = tiny.make_copy(Path({str(tmp_path)!r}))
        harness.run("tiny.window", 7, 0.2, False, "cpu", root=root)
        assert run.forbidden_modules() == [], run.forbidden_modules()
        print({TOP})
    """)
    assert "dss_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "dss_tpu"}


def test_bench_the_reference_loads_nothing_of_the_program(tmp_path):
    """The reference's first steps, with the data made as a run makes it."""
    mods = _modules(f"""
        import sys
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'benchmark' / 'tests')!r}]
        from pathlib import Path
        import torch
        torch.set_num_threads(2)
        import tiny
        from benchmark import harness
        root = tiny.make_copy(Path({str(tmp_path)!r}))
        cell = harness.load_cell("tiny.window", root)
        data = harness.make_data(cell, 5, "cpu")
        harness.reference_first_steps(cell, data, 2)
        print({TOP})
    """)
    assert not mods & {"dss_tpu_torch", "dss_tpu", "jax", "jaxlib", "flax"}
