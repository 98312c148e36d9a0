"""dss_tpu_torch stands alone: it imports neither jax nor dss_tpu, nor
PyYAML or imageio (the card's machine has neither; configs and PNGs are
read by utils/yaml_lite.py and data/png.py), and its CUDA branch can never
turn into the plain version — where the kernels cannot be built, the
loader raises."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dss_tpu_torch.ops import kernels

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "dss_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py"
)


def test_port_modules_import_without_jax():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in ["dss_tpu_torch", *MODULES])
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dss_tpu', 'flax', 'optax', 'yaml', "
        "'imageio'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_sources_name_no_jax():
    """No source of the package, and not chip_smoke.py (which runs on the
    card's machine), imports jax, dss_tpu, PyYAML or imageio."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|dss_tpu|yaml|"
                     r"imageio)(\.|\s|$)", re.M)
    sources = [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]
    hits = [str(p) for p in sources if pat.search(p.read_text())]
    assert not hits, hits
    assert len(MODULES) >= 15


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    monkeypatch.setattr(kernels, "_BUILD_ROOT", tmp_path)
    monkeypatch.setattr(kernels, "_loaded", {})
    with pytest.raises(kernels.KernelCompileError, match="nvcc not found"):
        kernels.load_library()


def _meta_args(name):
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    counts = m(2, 4, dt=torch.int32)
    if name == "fwd_lean":
        return (counts, m(2, 4, 14, 128), 100, 0.05, 32, 16, 5)
    if name == "occ_bwd":
        return (counts, m(2, 4, 5, 128), m(2, 4, 128, dt=torch.int32),
                m(2, 4, 256), m(2), 100, 32, 16)
    if name == "feat_bwd":
        return (counts, m(2, 4, 14, 128), m(2, 4, 256, 4), 100, 0.05, 32, 16,
                5)
    if name == "fwd_frag":
        return (counts, m(2, 4, 14, 128), 100, 0.05, 32, 16, 5)
    return (m(2, 2, 512), m(2, 512, dt=torch.int32), 100)


@pytest.mark.parametrize("name", ["fwd_lean", "occ_bwd", "feat_bwd",
                                  "segment_sum", "fwd_frag"])
def test_non_cpu_tensors_reach_the_kernel_branch(name, monkeypatch, tmp_path):
    """Tensors off the CPU take the CUDA branch; without a build it raises
    instead of computing the plain version, and counts no launch."""
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    monkeypatch.setattr(kernels, "_BUILD_ROOT", tmp_path)
    monkeypatch.setattr(kernels, "_loaded", {})
    fn = getattr(kernels, name)
    before = fn.launches
    with pytest.raises(kernels.KernelCompileError):
        fn(*_meta_args(name))
    assert fn.launches == before
