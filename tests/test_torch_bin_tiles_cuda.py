"""The binning kernels (ops/csrc/bin_tiles.cu) against the plain versions
on the card, bit for bit: bin_splats against bin_splats_plain,
bin_for_occ_backward against bin_for_occ_backward_plain (both on CUDA
tensors), masked_median against masked_median_plain.  Needs a CUDA device
and nvcc; skipped elsewhere.  Run it on the card with

    python -m pytest tests/test_torch_bin_tiles_cuda.py -m cuda -q --noconftest
"""
import numpy as np
import pytest
import torch

from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras, look_at_view_transform
from dss_tpu_torch.ops import kernels, splat
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.render.renderer import _prep_view, _tile_config
from test_torch_bin_tiles import _splats

pytestmark = pytest.mark.cuda

# The benchmarked tables: (label, views, points); both at 512², tile 64.
CELLS = [("flagship", 8, 5000), ("default", 1, 8000)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _equal(got, want):
    for field in splat.BinnedSplats._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert torch.equal(a, b), (field, int((a != b).sum()))


def _cloud(dev, v, p, image_size=512, tile=64):
    """The splats of a sphere of p points in v views, by the render's
    set-up, with per-point colours and a visibility mask."""
    i = np.arange(p, dtype=np.float64)
    phi = np.arccos(1 - 2 * (i + 0.5) / p)
    theta = np.pi * (1 + 5 ** 0.5) * i
    pts = 0.5 * np.stack([np.sin(phi) * np.cos(theta),
                          np.sin(phi) * np.sin(theta), np.cos(phi)], -1)
    pts = torch.tensor(pts, dtype=torch.float32, device=dev)
    r, t = look_at_view_transform(dist=torch.full((v,), 2.0),
                                  elev=torch.linspace(-30.0, 30.0, v),
                                  azim=torch.linspace(0.0, 315.0, v))
    cams = FoVPerspectiveCameras.create(r, t, fov=60.0, device=dev)
    st = RasterSettings(image_size=image_size, tile_size=tile,
                        backface_culling=False, Vrk_invariant=True,
                        Vrk_isotropic=False)
    with torch.no_grad():
        shaded, sp, pts_s = _prep_view(
            pts, pts / pts.norm(dim=-1, keepdim=True),
            torch.rand((p, 3), generator=torch.Generator(dev).manual_seed(1),
                       device=dev),
            torch.ones(p, dtype=torch.bool, device=dev), cams, None, st, None,
            64.0)
    vis = torch.rand((v, p), generator=torch.Generator(dev).manual_seed(0),
                     device=dev) < 0.8
    return sp, pts_s, shaded, vis, _tile_config(p, st)


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_benchmarked_tables_equal_plain(dev, cell):
    """The forward and the occupancy-backward tables of each cell's shape,
    and cur_r² (rbs a float and a 0-d device tensor, as the train step
    passes it); no long segment there."""
    _, v, p = cell
    sp, pts_s, shaded, vis, cfg = _cloud(dev, v, p)
    kernels.read_bin_long_tiles(dev)
    args = (pts_s, sp.ellipse_params, sp.cutoff, sp.radii, 512, cfg.tile,
            cfg.cap, cfg.max_tiles, cfg.max_tiles)
    kw = dict(scaler=sp.scaler, features=shaded)
    got = splat.bin_splats(*args, **kw)
    _equal(got, splat.bin_splats_plain(*args, **kw))
    assert int(got.tile_counts.sum()) > 1000 * v
    bt, bcap, bmt, bpc = splat._bwd_tile_budget(cfg, p)
    assert bcap == (2048 if p == 5000 else 6016)
    for rbs in (5.0, torch.full((), 3.5, device=dev)):
        bargs = (pts_s, sp.radii, vis, rbs, 512, bt, bcap, bmt, bpc)
        (gb, g2), (wb, w2) = (splat.bin_for_occ_backward(*bargs),
                              splat.bin_for_occ_backward_plain(*bargs))
        _equal(gb, wb)
        assert torch.equal(g2, w2) and float(g2.min()) > 0
    assert kernels.read_bin_long_tiles(dev) == 0


def _case_tables(dev, seed, s, t, m, mt, extra=0.0, depth=True,
                 backward=False, pair_cap=None, chans=True, **kw):
    sp = {k: x.to(dev) for k, x in _splats(seed, **kw).items()}
    args = (sp["pts"], sp["ellipse"], sp["cutoff"], sp["radii"], s, t, m, mt,
            mt, extra, depth, sp["scaler"] if chans else None,
            sp["features"] if chans else None, backward, pair_cap)
    got = splat.bin_splats(*args)
    _equal(got, splat.bin_splats_plain(*args))
    return got


# (label, seed, image size, tile, capacity, max tiles, kwargs)
EDGE_CASES = [
    ("pair cap", 4, 64, 16, 128, 4, dict(pair_cap=128)),
    ("tile capacity", 3, 64, 16, 8, 4, {}),
    ("span", 5, 64, 8, 128, 1, dict(extra=0.1)),
    ("depth ties", 2, 64, 16, 128, 4, dict(ties=True)),
    ("unsorted", 7, 64, 16, 128, 4, dict(depth=False)),
    ("unsorted support channels", 7, 64, 16, 128, 4,
     dict(depth=False, backward=True)),
    ("no scaler or features", 8, 64, 16, 128, 4, dict(chans=False)),
    ("one tile", 9, 64, 64, 512, 1, {}),
    ("many views, 1024 tiles", 10, 512, 16, 64, 4, dict(n=2000, v=9)),
]


@pytest.mark.parametrize("case", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_edge_tables_equal_plain(dev, case):
    """Truncation, capacity and span overflow, off-screen and
    behind-camera points (every case), equal quantized depths, the
    unsorted and the support channels, missing scaler and features."""
    label, seed, s, t, m, mt, kw = case
    got = _case_tables(dev, seed, s, t, m, mt, **kw)
    if label in ("pair cap", "tile capacity", "span"):
        assert int(got.overflow.min()) > 0


def test_per_view_extra_radius_and_an_empty_view(dev):
    """A (V,) extra radius; a view with every point behind the camera: its
    z range defaults to (0, 1) and its table is empty."""
    sp = {k: x.to(dev) for k, x in _splats(6).items()}
    sp["pts"][2, :, 2] = -1.0
    extra = torch.tensor([0.0, 0.05, 0.2], device=dev)
    args = (sp["pts"], sp["ellipse"], sp["cutoff"], sp["radii"], 64, 16, 128,
            4, 4, extra, True, sp["scaler"], sp["features"])
    got = splat.bin_splats(*args)
    _equal(got, splat.bin_splats_plain(*args))
    assert int(got.tile_counts[2].sum()) == 0 < int(got.tile_counts[1].sum())


@pytest.mark.parametrize("backward", [False, True])
def test_long_segments_equal_plain_and_count(dev, backward):
    """A concentrated cloud: every point in one of 4 tiles, more keys than
    shared memory holds (4096 forward, 8192 ids), a capacity above it (two
    selection rounds) and one below it (capacity overflow).  The counter
    reads the long tiles."""
    rng = np.random.default_rng(21)
    p = 12000
    f = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    pts = f(np.stack([rng.uniform(0.2, 0.8, (2, p)),
                      rng.uniform(0.2, 0.8, (2, p)),
                      rng.uniform(0.5, 2.0, (2, p))], -1))
    radii = f(rng.uniform(0.001, 0.01, (2, p, 2)))
    ell, cut = f(rng.uniform(1, 9, (2, p, 3))), f(rng.uniform(1, 4, (2, p)))
    for m in (2048, 12032):
        kernels.read_bin_long_tiles(dev)
        if backward:
            vis = torch.ones((2, p), dtype=torch.bool, device=dev)
            args = (pts, radii, vis, 1.0, 128, 64, m, 2)
            (got, g2), (want, w2) = (splat.bin_for_occ_backward(*args),
                                     splat.bin_for_occ_backward_plain(*args))
            assert torch.equal(g2, w2)
        else:
            args = (pts, ell, cut, radii, 128, 64, m, 2, 2)
            got, want = splat.bin_splats(*args), splat.bin_splats_plain(*args)
        _equal(got, want)
        assert int(got.tile_counts.max()) == min(m, p)
        assert kernels.read_bin_long_tiles(dev) >= 2
        assert (int(got.overflow.min()) > 0) == (m < p)


def test_median_equals_plain(dev):
    """Even, odd and zero masked counts, duplicates, +inf among the masked
    values, a per-point mask over both radii, the support radius."""
    rng = np.random.default_rng(13)
    vals = rng.uniform(0.0, 0.1, (6, 10001)).astype(np.float32)
    vals[1, ::3] = 0.05
    vals[2, :5] = np.inf
    mask = rng.random((6, 10001)) < np.array([[0.5], [0.7], [1.0], [0.3],
                                              [0.0], [1.0]])
    mask[5, 10000] = False
    v, m = torch.tensor(vals, device=dev), torch.tensor(mask, device=dev)
    assert torch.equal(splat.masked_median(v, m),
                       splat.masked_median_plain(v, m))
    assert {int(n) % 2 for n in mask.sum(1) if n} == {0, 1}
    radii = v[:, :10000].reshape(6, 5000, 2)
    per_point = m[:, :5000]
    want = splat.masked_median_plain(
        radii.reshape(6, -1), per_point[..., None].expand(6, 5000, 2)
        .reshape(6, -1))
    med, r, r2 = kernels.median_select(radii.reshape(6, -1), per_point,
                                       scale=5.0)
    assert torch.equal(med, want)
    rr = torch.where(torch.isfinite(want * 5.0), want * 5.0, 0.0)
    assert torch.equal(r, rr) and torch.equal(r2, rr * rr)


def test_graph_replay_equals_eager_and_launches_only_the_kernels(dev):
    """Both tables of the flagship's shape captured in a CUDA graph: the
    replay equals the eager call; the eager call launches the binning
    kernels, the median and the scratch fills, and nothing else."""
    sp, pts_s, shaded, vis, cfg = _cloud(dev, 8, 5000)
    bt, bcap, bmt, bpc = splat._bwd_tile_budget(cfg, 5000)
    rbs = torch.full((), 5.0, device=dev)

    def both():
        fwd = splat.bin_splats(pts_s, sp.ellipse_params, sp.cutoff, sp.radii,
                               512, cfg.tile, cfg.cap, cfg.max_tiles,
                               cfg.max_tiles, scaler=sp.scaler,
                               features=shaded)
        bwd, r2, total = splat._bin_support(pts_s, sp.radii, vis, rbs, 512,
                                            bt, bcap, bmt, bpc,
                                            overflow_base=fwd.overflow)
        return fwd, bwd, r2, total

    eager = both()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        both()
        torch.cuda.synchronize()
    launches = {k: n for k, n in kernels.launch_counts().items() if n}
    assert launches == {"bin_tiles": 2 * kernels.BIN_LAUNCHES,
                        "median_select": 1}
    names = {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    stray = {n for n in names if "sort" not in n and "Fill" not in n
             and "fill" not in n and "emset" not in n}
    assert not stray, stray
    # count, scan, two scatters, two tile kernels, the median
    assert sum("sort" in n for n in names) == 7, names

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = both()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out[:2], eager[:2]):
        _equal(a, b)
    assert torch.equal(out[2], eager[2]) and torch.equal(out[3], eager[3])
    assert torch.equal(eager[3], eager[0].overflow + eager[1].overflow)
