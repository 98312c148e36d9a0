"""render/prep.py on the CPU: `prep_splats` (the autograd Function over
the composite `prep_composite`, the forward's plain version) against the
composite, and the closed-form backward `prep_bwd_plain` against
autograd through the composite, in every mode the kernels adapt to
(prep_cases.CASES).  The CUDA kernels themselves are held to the
composite and to the closed form on the card in test_torch_cuda.py.

Tolerances: the forward is the composite's, bit for bit.  Gradients:
rtol 1e-4 with atol 1e-5 of the largest entry, for sums of ~10 terms of
either sign rounded in another order."""
import pytest
import torch

from dss_tpu_torch.geometry.cameras import FoVPerspectiveCameras
from dss_tpu_torch.render import prep
from prep_cases import CASES, prep_cotangents, prep_grads, prep_scene

torch.set_num_threads(2)


def _close(got, want, rtol, atol_frac):
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=atol_frac * float(want.abs().max()),
                               equal_nan=True)


@pytest.mark.parametrize("name", list(CASES))
def test_prep_splats_forward_is_the_composite(name):
    """prep_splats' outputs on the CPU, through the autograd Function,
    bit-equal to the composite's, the render masks neither empty nor full;
    of them only shaded (the lights' or the raw colours', absent where a
    texture shades) and pts_screen carry a gradient."""
    case = CASES[name]
    sc = prep_scene(case)
    leaves = {k: sc[k].clone().requires_grad_(True)
              for k in ("points", "normals", "colors")}
    args = (leaves["points"], leaves["normals"], leaves["colors"],
            sc["mask"], sc["cameras"], sc["lights"], sc["settings"], None,
            64.0)
    shade = not case.get("texture")
    got = prep.prep_splats(*args, shade=shade)
    with torch.no_grad():
        want = prep.prep_composite(*args, shade=shade)
    assert (got[0] is None) == (want[0] is None) == (not shade)
    fields = ("ellipse_params", "cutoff", "radii", "scaler", "mask")
    pairs = [(getattr(got[1], f), getattr(want[1], f)) for f in fields]
    pairs += [(got[2], want[2]), (got[1].pts_screen, want[1].pts_screen)]
    if shade:
        pairs.append((got[0], want[0]))
        assert got[0].requires_grad
    for g, w in pairs:
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert 0 < int(want[1].mask.sum()) < want[1].mask.numel()
    assert got[2].requires_grad
    assert not any(getattr(got[1], f).requires_grad for f in fields)


@pytest.mark.parametrize("name", list(CASES))
def test_prep_bwd_closed_form_matches_autograd_of_the_composite(name):
    """prep_bwd_plain's gradients in points, normals and colours (through
    `_PrepSplats`) against autograd through the composite, under random
    cotangents of shaded and pts_screen large enough that the 0.05 clip
    acts on about half the rows."""
    case = CASES[name]
    sc = prep_scene(case)
    g_scr, g_sh = prep_cotangents()
    norms = torch.linalg.vector_norm(g_scr, dim=-1)
    assert 0.2 < float((norms > 0.05).float().mean()) < 0.8
    want, got = (prep_grads(sc, fused, case.get("texture"), g_scr, g_sh)
                 for fused in (False, True))
    for w, g in zip(want, got):
        if w.abs().max() == 0:
            assert g.abs().max() == 0
        else:
            _close(g, w, 1e-4, 1e-5)
    assert want[0].abs().max() > 0
    if case.get("tie"):
        # cos = 0 at the first points: their normals' gradient is live
        assert want[1][:3].abs().max() > 0


def test_take_views_gathers_the_projections():
    """A camera batch's views taken by trainer.take_views carry the batch's
    projection matrices, gathered: bit-equal to the ones the taken views
    would build themselves."""
    from dss_tpu_torch.training.trainer import take_views

    sc = prep_scene(CASES["flagship"])
    cams = sc["cameras"]
    idx = torch.tensor([2, 0])
    taken = take_views(cams, idx)
    fresh = FoVPerspectiveCameras(R=cams.R[idx], T=cams.T[idx],
                                  fov=cams.fov[idx], znear=cams.znear[idx],
                                  zfar=cams.zfar[idx],
                                  aspect_ratio=cams.aspect_ratio[idx])
    assert "_full_projection" in vars(cams)
    assert torch.equal(taken.projection_matrix(), fresh.projection_matrix())
    assert torch.equal(taken.full_projection_matrix(),
                       fresh.full_projection_matrix())
    assert torch.equal(taken.R, fresh.R) and len(taken) == 2
