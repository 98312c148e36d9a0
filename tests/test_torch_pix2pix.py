"""The port's pix2pix generator (dss_tpu_torch/models/pix2pix.py) against
dss_tpu's flax generator: at ngf 8, 2 residual blocks and 32², for both
norms, the port's `state_dict()` goes through dss_tpu's
`load_torch_generator_weights` into flax and both give the same images
within atol 2e-5 (tests/test_pix2pix.py's tolerance against the reference
networks.py); `denoise_images` likewise, and the `.pth` round trip
through `load_generator_weights` (strict, `module.` prefixes stripped)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dss_tpu.models import pix2pix as jp2p
from dss_tpu_torch.models import pix2pix as tp2p

torch.set_num_threads(2)

DEV = "cpu"
NGF, BLOCKS, S = 8, 2, 32


def _pair(norm, seed=0):
    gen = tp2p.ResnetGenerator(ngf=NGF, n_blocks=BLOCKS, norm=norm,
                               generator=torch.Generator().manual_seed(seed),
                               device=DEV).eval()
    jm = jp2p.ResnetGenerator(ngf=NGF, n_blocks=BLOCKS, norm=norm)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    params = jp2p.load_torch_generator_weights(gen.state_dict(), params)
    return gen, jm, params


@pytest.mark.parametrize("norm", ["pixel", "instance"])
def test_generator_matches_flax(norm):
    gen, jm, params = _pair(norm)
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (2, S, S, 3)).astype(np.float32)
    with torch.no_grad():
        got = gen(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want = jm.apply(params, jnp.asarray(x))
    assert got.shape == (2, S, S, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert float(got.abs().max()) > 0.01


@pytest.mark.parametrize("norm", ["pixel", "instance"])
def test_state_dict_has_the_reference_layout(norm):
    gen, _, _ = _pair(norm)
    sd = gen.state_dict()
    convs = [k for k, v in sd.items() if v.ndim == 4]
    assert convs[:3] == ["model.1.weight", "model.4.weight", "model.7.weight"]
    assert convs[3:3 + 2 * BLOCKS] == [
        f"model.{10 + b}.conv_block.{j}.weight" for b in range(BLOCKS)
        for j in (1, 5)]
    t = 10 + BLOCKS
    assert convs[-3:] == [f"model.{t}.weight", f"model.{t + 3}.weight",
                          f"model.{t + 7}.weight"]
    assert sd[f"model.{t}.weight"].shape == (4 * NGF, 2 * NGF, 3, 3)
    biases = [k for k in sd if k.endswith("bias")]
    if norm == "pixel":
        assert biases == [f"model.{t + 7}.bias"]
    else:
        assert len(biases) == len(convs)


def test_denoise_images_matches_flax():
    gen, jm, params = _pair("pixel", seed=3)
    imgs = np.random.default_rng(1).uniform(0.1, 0.8, (3, S, S, 3)).astype(np.float32)
    with torch.no_grad():
        got = tp2p.denoise_images(gen, torch.tensor(imgs)).numpy()
    want = np.asarray(jp2p.denoise_images(jm.apply, params, jnp.asarray(imgs)))
    np.testing.assert_allclose(got, want, atol=2e-5)
    lo = imgs.min(axis=(1, 2), keepdims=True)
    hi = imgs.max(axis=(1, 2), keepdims=True)
    assert np.all(got >= lo - 1e-6) and np.all(got <= hi + 1e-6)


def test_pth_round_trip(tmp_path):
    gen, _, _ = _pair("pixel", seed=5)
    path = str(tmp_path / "latest_net_G.pth")
    torch.save(gen.state_dict(), path)
    other = tp2p.ResnetGenerator(ngf=NGF, n_blocks=BLOCKS,
                                 generator=torch.Generator().manual_seed(6),
                                 device=DEV)
    assert not torch.equal(other.model[1].weight, gen.model[1].weight)
    tp2p.load_generator_weights(other, path)
    for k, v in gen.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    # a DataParallel checkpoint's prefixes are stripped
    wrapped = {"module." + k: v for k, v in gen.state_dict().items()}
    third = tp2p.ResnetGenerator(ngf=NGF, n_blocks=BLOCKS, device=DEV)
    tp2p.load_generator_weights(third, wrapped)
    assert torch.equal(third.model[1].weight, gen.model[1].weight)
    # strict: a missing layer raises
    del wrapped["module.model.1.weight"]
    with pytest.raises(RuntimeError, match="Missing key"):
        tp2p.load_generator_weights(third, wrapped)
    # dss_tpu's converter reads the same file
    jm = jp2p.ResnetGenerator(ngf=NGF, n_blocks=BLOCKS)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    params = jp2p.load_torch_generator_weights(path, params)
    x = np.random.default_rng(2).uniform(-0.5, 0.5, (1, S, S, 3)).astype(np.float32)
    with torch.no_grad():
        got = other(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(params, x)),
                               atol=2e-5)


def test_seeded_init_is_torch_default_spread():
    gen = tp2p.ResnetGenerator(ngf=NGF, n_blocks=BLOCKS,
                               generator=torch.Generator().manual_seed(0),
                               device=DEV)
    w = gen.model[1].weight
    bound = 1.0 / (3 * 7 * 7) ** 0.5
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    again = tp2p.ResnetGenerator(ngf=NGF, n_blocks=BLOCKS,
                                 generator=torch.Generator().manual_seed(0),
                                 device=DEV)
    assert all(torch.equal(a, b) for a, b in
               zip(gen.state_dict().values(), again.state_dict().values()))
