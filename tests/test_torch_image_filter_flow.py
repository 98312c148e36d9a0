"""The port's image_filter_flow CLI (dss_tpu_torch/apps/image_filter_flow.py)
at 32², 300 points, 4 views and 5 iterations on the CPU: for every
filter, the four files are written and the losses are finite; without the
projection and repulsion terms the loss (the image L1) falls.  With them,
at the reference's defaults (λ 0.02 each, Adam lr 0.002), the image L1
rises over the first iterations, in dss_tpu's CLI as in the port's: Adam
gives the regularisers' small point gradients full-size steps.  Given
the same renders, its targets are dss_tpu's filters' (l0 and superpixel
as tests/test_torch_image_filters.py holds them: l0 by its mean absolute
difference below 1e-3, superpixel bit-equal; guided atol 5e-5; pix2pix,
a seeded full-width generator carried into flax by dss_tpu's converter,
atol 2e-5), and `save_image_grid` tiles the views into one PNG."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.models import pix2pix as jp2p
from dss_tpu.utils import image_filters as J
from dss_tpu_torch import convert
from dss_tpu_torch.apps import image_filter_flow
from dss_tpu_torch.data.io import read_ply, save_ply
from dss_tpu_torch.data.png import read_png
from dss_tpu_torch.geometry.cameras import look_at_view_transform
from dss_tpu_torch.models.pix2pix import ResnetGenerator
from dss_tpu_torch.render import ewa as tewa
from dss_tpu_torch.render import render_views
from dss_tpu_torch.utils.visualize import save_image_grid
from tests.test_render import fibonacci_sphere

torch.set_num_threads(2)

DEV = "cpu"
S, N, V, ITERS = 32, 300, 4, 5


@pytest.fixture(scope="module")
def cloud(tmp_path_factory):
    d = tmp_path_factory.mktemp("flow")
    pts = fibonacci_sphere(N, 0.5) * np.float32([1.0, 0.8, 0.6]) + 0.2
    with_n = str(d / "cloud.ply")
    save_ply(with_n, pts, normals=pts / np.linalg.norm(pts, axis=-1,
                                                       keepdims=True))
    bare = str(d / "bare.ply")
    save_ply(bare, pts)
    weights = str(d / "latest_net_G.pth")
    gen = ResnetGenerator(norm="pixel", generator=torch.Generator().manual_seed(0),
                          device=DEV)
    torch.save(gen.state_dict(), weights)
    return dict(ply=with_n, bare=bare, weights=weights)


@pytest.fixture(scope="module")
def renders():
    """The port's lit renders of an ellipsoid cloud, 4 views at 32²."""
    pts = fibonacci_sphere(N, 0.5) * np.float32([1.0, 0.8, 0.6])
    r, t = look_at_view_transform(dist=2.0,
                                  elev=torch.tensor([0., 20., -20., 40.]),
                                  azim=torch.tensor([0., 90., 180., 270.]))
    cams = convert.cameras_from_numpy({"R": r.numpy(), "T": t.numpy()},
                                      device=DEV)
    lights = convert.lights_from_numpy(
        {"ambient_color": [0.4] * 3, "diffuse_color": [0.6] * 3,
         "specular_color": [0.0] * 3, "direction": [0.3, 1.0, -0.5]}, V,
        device=DEV)
    p = torch.tensor(pts)
    with torch.no_grad():
        rgba = render_views(p, p / p.norm(dim=-1, keepdim=True),
                            torch.full((N, 3), 0.8), torch.ones(N, dtype=torch.bool),
                            cams, lights, tewa.RasterSettings(image_size=S,
                                                              tile_size=16))[0]
    return rgba[..., :3].contiguous()


@pytest.mark.parametrize("kind", ["l0", "guided", "superpixel", "pix2pix",
                                  "none"])
def test_cli_writes_its_outputs_and_the_loss_falls(cloud, kind, tmp_path):
    out = str(tmp_path / kind)
    argv = ["--points", cloud["bare" if kind == "none" else "ply"], "--out", out,
            "--filter", kind, "--num-views", str(V), "--image-size", str(S),
            "--iters", str(ITERS), "--device", DEV]
    if kind == "pix2pix":
        argv += ["--pix2pix-weights", cloud["weights"]]
    res = image_filter_flow.main(argv)
    for key, name in (("initial", "initial.png"), ("target", "target.png"),
                      ("final", "final.png"),
                      ("points", "filtered_points.ply")):
        assert res[key] == f"{out}/{name}"
    for key in ("initial", "target", "final"):
        img = read_png(res[key])
        assert img.shape == (S, V * S, 3) and img.dtype == np.uint8
    ply = read_ply(res["points"])
    assert ply.points.shape == (N, 3) and ply.normals.shape == (N, 3)
    np.testing.assert_allclose(ply.points, res["params"].points.detach().numpy())
    losses = res["losses"]
    assert len(losses) == ITERS and np.all(np.isfinite(losses))
    assert np.all(np.isfinite(res["image_losses"]))
    if kind != "none":
        res = image_filter_flow.main(argv + ["--lambda-proj", "0",
                                             "--lambda-repel", "0"])
        assert res["losses"] == res["image_losses"]
        assert res["losses"][-1] < res["losses"][0], res["losses"]


def test_defaults_move_the_image_term_as_dss_tpu_does(cloud, tmp_path):
    """Both CLIs, l0 at the defaults for 10 iterations: the image L1 rises
    in both (dss_tpu's rebuilt from its returned params with its own
    cameras, lights and settings)."""
    from dss_tpu.apps import image_filter_flow as jflow
    from dss_tpu.data.io import read_ply as j_read_ply
    from dss_tpu.geometry.cameras import sample_random_cameras
    from dss_tpu.render import ewa as jewa
    from dss_tpu.render.lighting import DirectionalLights as JLights
    from dss_tpu.render.renderer import render_views as j_render_views

    argv = ["--points", cloud["ply"], "--filter", "l0", "--num-views", str(V),
            "--image-size", str(S), "--iters", "10"]
    jfinal = jflow.main(argv + ["--out", str(tmp_path / "jax"),
                                "--platform", "cpu"])
    ply = j_read_ply(cloud["ply"])
    pts = jnp.asarray(ply.points)
    pts = pts - (pts.max(0) + pts.min(0)) / 2.0
    pts = pts / jnp.linalg.norm(pts, axis=-1).max()
    cams = sample_random_cameras(jax.random.PRNGKey(0), V, 1.8, 2.2)
    lights = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (V,) + x.shape),
        JLights.create(ambient_color=(0.4,) * 3, diffuse_color=(0.6,) * 3,
                       specular_color=(0.0,) * 3, direction=(0.3, 1.0, -0.5)))
    st = jewa.RasterSettings(image_size=S, points_per_pixel=5,
                             cutoff_threshold=1.0, Vrk_isotropic=True,
                             backface_culling=True)
    mask = jnp.ones((N,), bool)

    def render(p, n, c):
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
        return j_render_views(p, n, c, mask, cams, lights, st)[0][..., :3]

    r0 = render(pts, jnp.asarray(ply.normals), jnp.full_like(pts, 0.8))
    targets = jnp.stack([J.l0_smooth(im, lmd=0.05) for im in r0])
    r1 = render(jfinal.points, jfinal.normals, jfinal.colors)
    j_before = float(jnp.mean(jnp.abs(r0 - targets)))
    j_after = float(jnp.mean(jnp.abs(r1 - targets)))

    res = image_filter_flow.main(argv + ["--out", str(tmp_path / "port"),
                                         "--device", DEV])
    t_before, t_after = res["image_losses"][0], res["image_losses"][-1]
    print(f"image L1 over 10 iterations: dss_tpu {j_before:.6f} -> "
          f"{j_after:.6f}, port {t_before:.6f} -> {t_after:.6f}")
    assert j_after > j_before and t_after > t_before, (
        j_before, j_after, t_before, t_after)


def test_cli_needs_weights_for_pix2pix(cloud, tmp_path):
    with pytest.raises(SystemExit):
        image_filter_flow.main(["--points", cloud["ply"], "--out",
                                str(tmp_path), "--filter", "pix2pix",
                                "--device", DEV])


def test_targets_match_dss_tpu_filters(renders, cloud):
    imgs = renders.numpy()
    got = image_filter_flow.filter_targets(renders, "l0", 0.05).numpy()
    want = np.stack([np.asarray(J.l0_smooth(jnp.asarray(im), lmd=0.05))
                     for im in imgs])
    assert np.abs(got - want).mean() < 1e-3

    got = image_filter_flow.filter_targets(renders, "guided").numpy()
    want = np.stack([np.asarray(J.guided_filter(
        jnp.asarray(im), jnp.asarray(im).mean(-1), r=4, eps=1e-3))[..., None]
        .repeat(3, -1) for im in imgs])
    np.testing.assert_allclose(got, want, atol=5e-5)

    got = image_filter_flow.filter_targets(renders, "superpixel").numpy()
    want = np.stack([J.superpixel(im) for im in imgs])
    np.testing.assert_array_equal(got, want)

    got = image_filter_flow.filter_targets(renders, "pix2pix",
                                           pix2pix_weights=cloud["weights"])
    jm = jp2p.ResnetGenerator(norm="pixel")
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    params = jp2p.load_torch_generator_weights(cloud["weights"], params)
    want = np.asarray(jp2p.denoise_images(jm.apply, params, jnp.asarray(imgs)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert torch.equal(image_filter_flow.filter_targets(renders, "none"),
                       renders)


def test_save_image_grid_tiles_the_views(tmp_path):
    imgs = np.random.default_rng(0).uniform(-0.2, 1.2, (5, 8, 6, 3))
    path = save_image_grid(imgs, str(tmp_path / "sub" / "grid.png"), ncols=2)
    grid = read_png(path)
    assert grid.shape == (24, 12, 3)
    want = np.round(np.clip(imgs, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(grid[8:16, 6:12], want[3])
    assert (grid[16:, 6:] == 255).all()
    gray = save_image_grid(imgs[:2, ..., :1], str(tmp_path / "g.png"))
    assert read_png(gray).shape == (8, 12, 3)
