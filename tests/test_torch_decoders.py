"""The port's decoders (dss_tpu_torch/models/decoders.py) against
dss_tpu's flax decoders on the same numpy inputs: flax weights carried
across by `convert.decoder_state_from_flax`, outputs and input gradients
within rtol 1e-5, atol 1e-6; the port's own initialisers (the SDF's
geometric init is spherical, the Sitzmann bounds, lecun-normal spread, the
zeroed ResNet layer); `approximate_gradient`, `positional_encoding` and
`neural_texture_features` (the view-batched form row by row against the
JAX per-view call)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.models import decoders as jdec
from dss_tpu_torch import convert
from dss_tpu_torch.models import decoders as tdec

torch.set_num_threads(2)

DEV = "cpu"
RTOL, ATOL = 1e-5, 1e-6

# name → (flax module, port module, input width, code width)
CASES = {
    "siren": (lambda: jdec.Siren(hidden_size=32, n_layers=2,
                                 out_dims=(("sdf", 1), ("rgb", 3))),
              lambda: tdec.Siren(hidden_size=32, n_layers=2,
                                 out_dims=(("sdf", 1), ("rgb", 3)), device=DEV),
              3, 0),
    "siren_sine_out": (
        lambda: jdec.Siren(hidden_size=16, n_layers=1, outermost_linear=False),
        lambda: tdec.Siren(hidden_size=16, n_layers=1, outermost_linear=False,
                           device=DEV), 3, 0),
    "sdf": (lambda: jdec.SDF(hidden_size=32, n_layers=4, skip_in=(2,),
                             num_frequencies=4),
            lambda: tdec.SDF(hidden_size=32, n_layers=4, skip_in=(2,),
                             num_frequencies=4, device=DEV), 3, 0),
    "sdf_rgb_code": (
        lambda: jdec.SDF(out_dims=(("sdf", 1), ("rgb", 3)), hidden_size=24,
                         n_layers=3, skip_in=(1, 7), num_frequencies=2),
        lambda: tdec.SDF(out_dims=(("sdf", 1), ("rgb", 3)), hidden_size=24,
                         n_layers=3, skip_in=(1, 7), num_frequencies=2,
                         c_dim=5, device=DEV), 3, 5),
    "sdf_no_pe": (lambda: jdec.SDF(hidden_size=16, n_layers=3, skip_in=(2,),
                                   num_frequencies=0),
                  lambda: tdec.SDF(hidden_size=16, n_layers=3, skip_in=(2,),
                                   num_frequencies=0, device=DEV), 3, 0),
    "rendering": (lambda: jdec.RenderingNetwork(hidden_size=32, n_layers=3),
                  lambda: tdec.RenderingNetwork(hidden_size=32, n_layers=3,
                                                device=DEV), 33, 0),
    "occupancy": (lambda: jdec.Occupancy(hidden_size=32, n_blocks=2),
                  lambda: tdec.Occupancy(hidden_size=32, n_blocks=2,
                                         device=DEV), 3, 0),
    "occupancy_code_leaky": (
        lambda: jdec.Occupancy(hidden_size=16, n_blocks=3, leaky=True),
        lambda: tdec.Occupancy(hidden_size=16, n_blocks=3, leaky=True,
                               c_dim=6, device=DEV), 3, 6),
    "residual_sdf": (
        lambda: jdec.ResidualSDF(hidden_size=24, n_layers=3,
                                 siren_hidden_size=16, siren_n_layers=1),
        lambda: tdec.ResidualSDF(hidden_size=24, n_layers=3,
                                 siren_hidden_size=16, siren_n_layers=1,
                                 device=DEV), 3, 0),
}


def _carried(name, seed=0):
    """(flax module, flax params, port module with the same weights)."""
    jmod, tmod, d_in, c_dim = CASES[name]
    jm = jmod()
    args = [jnp.zeros((1, d_in))] + ([jnp.zeros((1, c_dim))] if c_dim else [])
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(seed), *args))
    tm = tmod()
    tm.load_state_dict(convert.decoder_state_from_flax(tm, params), strict=True)
    return jm, params, tm


def _inputs(name, n=37, seed=1):
    _, _, d_in, c_dim = CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.9, 0.9, (n, d_in)).astype(np.float32)
    c = rng.standard_normal((n, c_dim)).astype(np.float32) if c_dim else None
    return x, c


@pytest.mark.parametrize("name", list(CASES))
def test_decoder_matches_flax(name):
    jm, params, tm = _carried(name)
    x, c = _inputs(name)
    jargs = [jnp.asarray(x)] + ([jnp.asarray(c)] if c is not None else [])
    want = jm.apply(params, *jargs)

    xt = torch.tensor(x, requires_grad=True)
    ct = None if c is None else torch.tensor(c, requires_grad=True)
    got = tm(xt, ct)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)

    # input gradients under a random cotangent on every output
    rng = np.random.default_rng(2)
    cot = {k: rng.standard_normal(np.asarray(v).shape).astype(np.float32)
           for k, v in want.items()}

    def jloss(*a):
        out = jm.apply(params, *a)
        return sum(jnp.sum(out[k] * cot[k]) for k in out)

    jg = jax.grad(jloss, argnums=tuple(range(len(jargs))))(*jargs)
    loss = sum((got[k] * torch.tensor(cot[k])).sum() for k in got)
    tg = torch.autograd.grad(loss, [t for t in (xt, ct) if t is not None])
    for a, b in zip(tg, jg):
        scale = float(np.abs(np.asarray(b)).max())
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL * max(scale, 1.0))


def test_residual_sdf_only_base_and_detached_gate():
    jm, params, tm = _carried("residual_sdf")
    x, _ = _inputs("residual_sdf")
    want = jm.apply(params, jnp.asarray(x), only_base=True)["sdf"]
    got = tm(torch.tensor(x), only_base=True)["sdf"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    # the base's parameters get the same gradient as in flax (the gate is
    # stop_gradient there, detached here)
    jg = jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x))["sdf"]))(params)
    tm.zero_grad()
    tm(torch.tensor(x))["sdf"].sum().backward()
    jv = np.asarray(jg["params"]["SDF_0"]["WNDense_0"]["v"]).T
    np.testing.assert_allclose(tm.base.layers[0].v.grad.numpy(), jv,
                               rtol=1e-4, atol=1e-6 * max(np.abs(jv).max(), 1))


def test_state_from_flax_refuses_a_mismatch():
    _, params, _ = _carried("sdf")
    other = tdec.SDF(hidden_size=40, n_layers=4, skip_in=(2,),
                     num_frequencies=4, device=DEV)
    with pytest.raises(ValueError, match="does not fit"):
        convert.decoder_state_from_flax(other, params)


def test_sdf_geometric_init_is_spherical():
    """The port's own init: SDF(x) ≈ ‖x‖ − bias, |∇f| ≈ 1 (as
    tests/test_decoders.py holds the flax init)."""
    gen = torch.Generator().manual_seed(0)
    model = tdec.SDF(hidden_size=128, n_layers=4, bias=0.6, num_frequencies=6,
                     skip_in=(2,), generator=gen, device=DEV)
    dirs = torch.randn(64, 3, generator=torch.Generator().manual_seed(1))
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    with torch.no_grad():
        inside = model(dirs * 0.1)["sdf"]
        outside = model(dirs * 1.2)["sdf"]
        at = model(dirs * 0.6)["sdf"]
    assert float(inside.mean()) < 0 < float(outside.mean())
    # near the sphere of radius bias, as flax's init (mean 0.114 at seed 0)
    assert float(inside.mean()) < float(at.mean()) < float(outside.mean())
    assert abs(float(at.mean())) < 0.25
    g = tdec.approximate_gradient(
        torch.tensor([[0.5, 0.1, -0.2], [0.0, 0.9, 0.0]]),
        lambda p: model(p)["sdf"][..., 0])
    np.testing.assert_allclose(g.norm(dim=-1).detach().numpy(), 1.0, atol=0.5)
    # the first layer sees xyz only; the skip layer's PE inputs start at 0
    w0 = model.layers[0].v.detach()
    assert torch.all(w0[:, 3:] == 0) and torch.all(w0[:, :3] != 0)
    d_in = tdec.embedding_dim(3, 6)
    w2 = model.layers[2].v.detach()
    assert w2.shape[1] == 128 and torch.all(w2[:, -(d_in - 3):] == 0)
    assert torch.all(model.layers[-1].bias == -0.6)


def test_sdf_init_draws_flax_distribution():
    """Layer by layer, the port's geometric init has flax's zero pattern,
    spread (std within 4 standard errors, 4/sqrt(2n) for n draws) and
    last-layer mean (within 1e-3)."""
    kw = dict(hidden_size=256, n_layers=8, skip_in=(4,), num_frequencies=6)
    jm = jdec.SDF(**kw)
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3)))["params"]
    tm = tdec.SDF(**kw, generator=torch.Generator().manual_seed(0), device=DEV)
    assert len(tm.layers) == len(jp) == 9
    for i, layer in enumerate(tm.layers):
        jv = np.asarray(jp[f"WNDense_{i}"]["v"]).T
        tv = layer.v.detach().numpy()
        assert tv.shape == jv.shape
        np.testing.assert_array_equal(tv == 0, jv == 0)
        n = int((tv != 0).sum())
        np.testing.assert_allclose(tv[tv != 0].std(), jv[jv != 0].std(),
                                   rtol=4 / np.sqrt(2 * n))
        np.testing.assert_array_equal(layer.bias.detach().numpy(),
                                      np.asarray(jp[f"WNDense_{i}"]["bias"]))
    np.testing.assert_allclose(tm.layers[-1].v.detach().numpy().mean(),
                               np.asarray(jp["WNDense_8"]["v"]).mean(),
                               atol=1e-3)


def test_port_init_follows_flax():
    """Sitzmann bounds, lecun-normal spread, g = ‖v‖ at init, the zeroed
    second ResNet layer, zero biases; a generator seed fixes the draw."""
    gen = lambda: torch.Generator().manual_seed(3)
    siren = tdec.Siren(hidden_size=64, n_layers=2, generator=gen(), device=DEV)
    w_first = siren.net[0].linear.weight
    assert float(w_first.abs().max()) <= 1.0 / 3
    bound = np.sqrt(6.0 / 64) / 30.0
    assert float(siren.net[1].linear.weight.abs().max()) <= bound
    assert float(siren.net[1].linear.weight.abs().max()) > 0.9 * bound
    assert float(siren.last.weight.abs().max()) <= bound
    assert torch.all(siren.net[0].linear.bias == 0)

    rn = tdec.RenderingNetwork(hidden_size=256, n_layers=2, generator=gen(),
                               device=DEV)
    v = rn.layers[1].v.detach()
    np.testing.assert_allclose(float(v.std()), np.sqrt(1 / 256), rtol=0.05)
    assert float(v.abs().max()) <= 2 * np.sqrt(1 / 256) / 0.87962566103423978
    np.testing.assert_allclose(rn.layers[1].g.detach().numpy(),
                               v.norm(dim=1).numpy() + 1e-12, rtol=1e-6)
    rn2 = tdec.RenderingNetwork(hidden_size=256, n_layers=2, generator=gen(),
                                device=DEV)
    assert torch.equal(rn.layers[0].v, rn2.layers[0].v)

    occ = tdec.Occupancy(hidden_size=32, n_blocks=2, generator=gen(), device=DEV)
    assert torch.all(occ.blocks[0].fc_1.weight == 0)
    assert torch.all(occ.fc_p.bias == 0) and occ.blocks[0].shortcut is None
    blk = tdec.ResnetBlockFC(8, 12, generator=gen())
    assert blk.shortcut.bias is None and blk(torch.ones(2, 8)).shape == (2, 12)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tdec.RenderingNetwork(hidden_size=8, n_layers=1)


def test_approximate_gradient_matches_jax():
    jm, params, tm = _carried("sdf")
    x, _ = _inputs("sdf", n=50, seed=4)
    want = jdec.approximate_gradient(
        jnp.asarray(x), lambda p: jm.apply(params, p)["sdf"][..., 0])
    with torch.no_grad():
        got = tdec.approximate_gradient(torch.tensor(x),
                                        lambda p: tm(p)["sdf"][..., 0])
    # a difference quotient over h = 1e-3 divides the outputs' rounding
    # (atol 1e-6 above) by h
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


def test_positional_encoding_matches_jax():
    x = np.random.default_rng(5).uniform(-1, 1, (4, 7, 3)).astype(np.float32)
    for nf, inc in ((0, True), (1, True), (4, True), (6, False)):
        want = jdec.positional_encoding(jnp.asarray(x), nf, inc)
        got = tdec.positional_encoding(torch.tensor(x), nf, inc)
        assert got.shape[-1] == tdec.embedding_dim(3, nf, inc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_neural_texture_features_match_jax():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-0.5, 0.5, (40, 3)).astype(np.float32)
    nrm = rng.standard_normal((40, 3)).astype(np.float32)
    cams = rng.uniform(-3, 3, (3, 3)).astype(np.float32)
    got = tdec.neural_texture_features(torch.tensor(pts), torch.tensor(nrm),
                                       torch.tensor(cams), view_freqs=4)
    assert got.shape == (3, 40, 33)
    for v in range(3):
        want = jdec.neural_texture_features(jnp.asarray(pts), jnp.asarray(nrm),
                                            jnp.asarray(cams[v]), 4)
        np.testing.assert_allclose(got[v].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        one = tdec.neural_texture_features(torch.tensor(pts), torch.tensor(nrm),
                                           torch.tensor(cams[v]), 4)
        assert torch.equal(one, got[v])
    want = jdec.neural_texture_features(jnp.asarray(pts), jnp.asarray(nrm))
    got = tdec.neural_texture_features(torch.tensor(pts), torch.tensor(nrm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
