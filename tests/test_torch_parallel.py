"""View-parallel training over torch.distributed (parallel/mesh.py,
parallel/dryrun.py) against dss_tpu's shard_map step on a 2-device slice
of the virtual CPU mesh, and against the port's single-process step.

One spawn serves the file: the dry run at world size 2 (gloo on the CPU,
a file rendezvous under tmp_path, a 240 s timeout on the spawn and join),
whose ranks check among themselves that the NaN guard skips a step with a
NaN in one rank's shard on both ranks and that the parameters, Adam state
and gradients are bitwise equal across ranks, and write their results
for the tests below.  Tolerances: the reduced gradients against the
single-process gradients rtol 1e-4, atol 1e-6 · max (a mean of per-rank
means reassociates the float32 sums); one SGD(0.1) step against dss_tpu's
shard_map step atol 5e-6 and the loss rtol 1e-4, as tests/test_parallel.py
holds dss_tpu's own; the row-sharded render atol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dss_tpu.training.trainer as jt
from dss_tpu.geometry.cameras import FoVPerspectiveCameras as JCameras
from dss_tpu.models.point_model import PointModelParams as JParams
from dss_tpu.parallel.mesh import make_mesh as jmake_mesh
from dss_tpu.parallel.mesh import make_shardmap_train_step as jshardmap_step
from dss_tpu.render.ewa import RasterSettings as JSettings
from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.geometry.pointclouds import PointFilters
from dss_tpu_torch.models.point_model import PointModelParams
from dss_tpu_torch.parallel import dryrun
from dss_tpu_torch.parallel.mesh import (
    ViewMesh,
    make_mesh,
    shard_by_view_count,
    shard_views,
)
from dss_tpu_torch.render.ewa import RasterSettings
from dss_tpu_torch.render.renderer import render_single_view
from dss_tpu_torch.training import trainer as tt

torch.set_num_threads(2)

DEV = "cpu"
LR = 0.1


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    return dryrun.dryrun_multichip(2, device=DEV, out_dir=str(out),
                                   timeout=240.0)


@pytest.fixture(scope="module")
def case():
    return dryrun.dryrun_case(**dryrun.CASE)


def test_dryrun_ranks_agree_bitwise(ranks):
    r0, r1 = ranks
    for k in ("grads", "total", "state", "visibility", "rgba", "visible",
              "losses"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def _single_process(c, views):
    """The port's single-process loss and gradients over `views`."""
    loss_fn = tt.make_loss_fn(
        RasterSettings(image_size=dryrun.CASE["image_size"], **dryrun.RASTER),
        tt.TrainConfig(**dryrun.TRAIN), tt.AnnealSchedule())
    params = PointModelParams.create(c["points"], c["normals"], c["colors"],
                                     device=DEV)
    cams = FoVPerspectiveCameras.create(c["R"][views], c["T"][views],
                                        fov=60.0, device=DEV)
    total, (parts, nf) = loss_fn(
        params, PointFilters.ones(len(c["points"]), device=DEV), cams, None,
        torch.tensor(c["img"][views]), torch.tensor(c["mask"][views]), 0)
    grads = torch.autograd.grad(total, params.tensors(), allow_unused=True)
    grads = np.stack([np.zeros_like(c["points"]) if g is None else g.numpy()
                      for g in grads])
    return float(total.detach()), parts, nf, grads


def test_grads_match_the_single_process_step(ranks, case):
    """The reduced gradients are the mean of the single-process gradients
    of each rank's views (rtol 1e-4, atol 1e-6 · max), as dss_tpu's
    shard_map step reduces them.  The single-process step over all views
    at once takes its masked means over all of them, which the mean of the
    ranks' masked means matches only where the ranks hold equally many
    masked pixels (in dss_tpu too): the loss within rtol 1e-4, the
    filters equal; its gradients are held to dss_tpu's single-device step
    in test_torch_train_step.py."""
    c, r0 = case, ranks[0]
    n_views = dryrun.CASE["n_views"]
    halves = [_single_process(c, slice(i * n_views // 2, (i + 1) * n_views // 2))
              for i in range(2)]
    want = (halves[0][3] + halves[1][3]) / 2
    np.testing.assert_allclose(r0["grads"], want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(r0["total"], (halves[0][0] + halves[1][0]) / 2,
                               rtol=1e-6)
    assert int(r0["bin_overflow"]) == sum(int(h[1]["bin_overflow"])
                                          for h in halves)
    total, parts, nf, grads = _single_process(c, slice(None))
    np.testing.assert_allclose(r0["total"], total, rtol=1e-4)
    np.testing.assert_array_equal(r0["visibility"], nf.visibility.numpy())
    np.testing.assert_array_equal(r0["inmask"], nf.inmask.numpy())
    assert np.abs(r0["grads"][0]).max() > 0


def test_sgd_step_matches_dss_tpu(ranks, case):
    """One SGD(0.1) step, so that the parameter change is the gradient:
    the port's distributed step against dss_tpu's shard_map step on a
    2-device mesh, atol 5e-6 and the loss rtol 1e-4.  (The port's
    single-process step is held to dss_tpu's single-device step in
    test_torch_train_step.py.)"""
    c, r0 = case, ranks[0]
    settings = JSettings(image_size=dryrun.CASE["image_size"], **dryrun.RASTER)
    cfg, sched = jt.TrainConfig(**dryrun.TRAIN), jt.AnnealSchedule()
    state = jt.create_train_state(
        JParams.create(c["points"], c["normals"], c["colors"]), optax.sgd(LR))
    s, m = jshardmap_step(optax.sgd(LR), settings, cfg, sched, jmake_mesh(2))(
        state, JCameras.create(c["R"], c["T"], fov=60.0), None,
        jnp.asarray(c["img"]), jnp.asarray(c["mask"]))
    np.testing.assert_allclose(float(m["loss"]), float(r0["total"]),
                               rtol=1e-4)
    for i, k in enumerate(("points", "normals", "colors")):
        np.testing.assert_allclose(c[k] - LR * r0["grads"][i],
                                   np.asarray(getattr(s.params, k)),
                                   atol=5e-6, err_msg=k)
    np.testing.assert_array_equal(r0["visibility"],
                                  np.asarray(s.filters.visibility))


def test_row_sharded_render_matches_single_view(ranks, case):
    c = case
    cam = FoVPerspectiveCameras.create(c["R"][:1], c["T"][:1], fov=60.0,
                                       device=DEV)
    st = RasterSettings(image_size=dryrun.CASE["image_size"], **dryrun.RASTER)
    with torch.no_grad():
        rgba, _, visible = render_single_view(
            torch.tensor(c["points"]), torch.tensor(c["normals"]),
            torch.tensor(c["colors"]), torch.ones(len(c["points"]), dtype=torch.bool),
            cam, None, st.replace(backend="reference"))
    np.testing.assert_allclose(ranks[0]["rgba"], rgba.numpy(), atol=1e-6)
    np.testing.assert_array_equal(ranks[0]["visible"], visible.numpy())
    assert visible.any() and (rgba[..., 3] > 0).any()


def test_placement_rules():
    """shard_views splits a leaf whose leading dimension the mesh size
    divides; the step's rule splits only a leaf whose leading dimension is
    the view count (tests/test_parallel.py:79 and mesh.py:156-166 of
    dss_tpu)."""
    x = torch.arange(8 * 4.0).reshape(8, 4)
    table = torch.arange(2 * 3.0).reshape(2, 3)
    odd = torch.arange(3.0)
    for i in range(2):
        mesh = ViewMesh(group=None, size=2, index=i)
        got = shard_views({"x": x, "table": table, "odd": odd, "s": 1.0}, mesh)
        assert torch.equal(got["x"], x[4 * i:4 * i + 4])
        assert torch.equal(got["table"], table[i:i + 1])
        assert got["odd"] is odd and got["s"] == 1.0
        got = shard_by_view_count({"x": x, "table": table}, mesh, n_views=8)
        assert torch.equal(got["x"], x[4 * i:4 * i + 4])
        assert got["table"] is table


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(2)
