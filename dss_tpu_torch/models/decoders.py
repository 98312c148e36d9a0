"""Neural decoders as torch modules (counterpart of
dss_tpu/models/decoders.py): Siren, the DeepSDF/SAL-style SDF, the
view-dependent RenderingNetwork, the ONet-style Occupancy decoder,
ResidualSDF, positional encoding and central-difference gradients.

Reference: DSS/models/common.py — Siren (92-167), Embedder (173-219), SDF
(222-312, geometric init, skip connections, softplus β = 100),
RenderingNetwork (315-368), ResnetBlockFC (370-413), Occupancy (415-491),
approximate_gradient (494-535), ResidualSDF (538-594).

As in the JAX package:

- `out_dims` is a tuple of (name, width) pairs and a decoder returns a
  dict of (..., width) tensors, rgb squashed (sigmoid, or tanh scaled to
  [0, 1] in RenderingNetwork);
- `WNDense` writes the weight norm out, w = v / max(‖v‖, 1e-12) · g per
  output unit, with g initialised to ‖v‖ + 1e-12 (not torch's
  `weight_norm`);
- the initialisers are the flax ones: lecun-normal kernels and zero biases
  for a plain `Dense`, the Sitzmann uniforms, the SDF's geometric init.

flax infers input widths on the first call; these modules take them at
construction (`in_dim`, `c_dim` for a conditioning code).  Weights are
drawn on the CPU from `generator` (torch's default one when None) and then
moved to `device`: the card unless the caller names another (a seed gives
the same weights on every device).  A `Linear` weight is (out, in), the
flax kernel transposed; `convert.decoder_state_from_flax` carries flax
weights across.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dss_tpu_torch.utils.device import resolve_device

OutDims = Tuple[Tuple[str, int], ...]
# flax's lecun_normal: a normal truncated at ±2 σ, scaled so that its
# standard deviation is sqrt(1 / fan_in)
_TRUNC_STD = 0.87962566103423978


def positional_encoding(x: torch.Tensor, num_freqs: int,
                        include_input: bool = True) -> torch.Tensor:
    """NeRF positional encoding, frequencies 2^0..2^(n−1): per frequency
    sin of every input dim, then cos (reference Embedder)."""
    if num_freqs <= 0:
        return x
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]  # (..., F, D)
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)
    enc = enc.reshape(x.shape[:-1] + (2 * num_freqs * x.shape[-1],))
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def embedding_dim(input_dim: int, num_freqs: int,
                  include_input: bool = True) -> int:
    return input_dim * (2 * num_freqs + (1 if include_input else 0))


def _split_outputs(x: torch.Tensor, out_dims: OutDims) -> Dict[str, torch.Tensor]:
    out, ofs = {}, 0
    for k, d in out_dims:
        out[k] = x[..., ofs:ofs + d]
        ofs += d
    return out


# ---- initialisers: (in, out) kernels as flax draws them ------------------

KernelInit = Callable[[Tuple[int, int], Optional[torch.Generator]], torch.Tensor]


def lecun_normal(shape, gen):
    std = math.sqrt(1.0 / shape[0]) / _TRUNC_STD
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2.0 * std,
                                 b=2.0 * std, generator=gen)


def uniform_init(bound: float) -> KernelInit:
    return lambda shape, gen: nn.init.uniform_(torch.empty(shape), -bound,
                                               bound, generator=gen)


def zeros_init(shape, gen):
    return torch.zeros(shape)


def _normal(shape, gen):
    return nn.init.normal_(torch.empty(shape), generator=gen)


def _linear(in_dim: int, out_dim: int, kernel_init: KernelInit = lecun_normal,
            bias: bool = True, gen=None) -> nn.Linear:
    """A Linear whose weight is the flax kernel (in, out) transposed, with
    a zero bias (flax Dense)."""
    lin = nn.Linear(in_dim, out_dim, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(kernel_init((in_dim, out_dim), gen).t())
        if bias:
            lin.bias.zero_()
    return lin


def _on(module: nn.Module, device) -> nn.Module:
    return module.to(resolve_device(device))


class SineLayer(nn.Module):
    """sin(ω₀ · Dense(x)) with the Sitzmann init: U(−1/d, 1/d) for the
    first layer, U(±sqrt(6/d)/ω₀) after it."""

    def __init__(self, in_dim: int, features: int, is_first: bool = False,
                 omega_0: float = 30.0, generator=None):
        super().__init__()
        self.omega_0 = omega_0
        bound = 1.0 / in_dim if is_first else math.sqrt(6.0 / in_dim) / omega_0
        self.linear = _linear(in_dim, features, uniform_init(bound),
                              gen=generator)

    def forward(self, x):
        return torch.sin(self.omega_0 * self.linear(x))


class Siren(nn.Module):
    """Sine MLP (reference common.py:92-167)."""

    def __init__(self, hidden_size: int = 256, n_layers: int = 3,
                 out_dims: OutDims = (("sdf", 1),), outermost_linear: bool = True,
                 first_omega_0: float = 30.0, hidden_omega_0: float = 30.0,
                 in_dim: int = 3, c_dim: int = 0, generator=None, device=None):
        super().__init__()
        self.out_dims = tuple(out_dims)
        out_dim = sum(d for _, d in self.out_dims)
        self.net = nn.ModuleList(
            [SineLayer(in_dim + c_dim, hidden_size, True, first_omega_0,
                       generator)]
            + [SineLayer(hidden_size, hidden_size, False, hidden_omega_0,
                         generator) for _ in range(n_layers)])
        if outermost_linear:
            bound = math.sqrt(6.0 / hidden_size) / hidden_omega_0
            self.last = _linear(hidden_size, out_dim, uniform_init(bound),
                                gen=generator)
        else:
            self.last = SineLayer(hidden_size, out_dim, False, hidden_omega_0,
                                  generator)
        _on(self, device)

    def forward(self, coords, c: Optional[torch.Tensor] = None):
        x = coords if c is None else torch.cat([c, coords], dim=-1)
        for layer in self.net:
            x = layer(x)
        res = _split_outputs(self.last(x), self.out_dims)
        if "rgb" in res:
            res["rgb"] = torch.sigmoid(res["rgb"])
        return res


class WNDense(nn.Module):
    """Weight-normalised dense layer: w = v / max(‖v‖, 1e-12) · g, the norm
    over each output unit's inputs.  `v` is (out, in) like a Linear weight;
    g starts at ‖v‖ + 1e-12, so w ≈ v at init."""

    def __init__(self, in_dim: int, features: int,
                 kernel_init: KernelInit = lecun_normal, bias_value: float = 0.0,
                 generator=None):
        super().__init__()
        v = kernel_init((in_dim, features), generator).t().contiguous()
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(torch.linalg.vector_norm(v, dim=1) + 1e-12)
        self.bias = nn.Parameter(torch.full((features,), float(bias_value)))

    def forward(self, x):
        n = torch.clamp(torch.linalg.vector_norm(self.v, dim=1, keepdim=True),
                        min=1e-12)
        return F.linear(x, self.v / n * self.g[:, None], self.bias)


class SDF(nn.Module):
    """DeepSDF/SAL-style SDF MLP with positional encoding, skip connections
    (the concatenation divided by √2), softplus(100·h)/100 and the
    geometric init that makes it ≈ ‖x‖ − bias (reference
    common.py:222-312)."""

    def __init__(self, out_dims: OutDims = (("sdf", 1),), hidden_size: int = 512,
                 n_layers: int = 8, bias: float = 0.6,
                 skip_in: Tuple[int, ...] = (4,), num_frequencies: int = 6,
                 in_dim: int = 3, c_dim: int = 0, generator=None, device=None):
        super().__init__()
        self.out_dims = tuple(out_dims)
        self.num_frequencies = num_frequencies
        out_total = sum(d for _, d in self.out_dims)
        d_in = embedding_dim(in_dim, num_frequencies)
        dims = [d_in] + [hidden_size] * n_layers + [out_total]
        n_lin = len(dims) - 1
        # skip connections only into hidden layers (a skip index past the
        # last hidden layer would make the width negative)
        self.skip_in = tuple(s for s in skip_in if 0 < s <= n_layers)
        layers, width = [], d_in + c_dim
        for l in range(n_lin):
            out_d = dims[l + 1] - (d_in if (l + 1) in self.skip_in else 0)
            if l == n_lin - 1:
                # geometric init: mean sqrt(π)/sqrt(d), bias −b → sphere SDF
                def k_init(shape, gen, _d=dims[l]):
                    return _normal(shape, gen) * 1e-4 + math.sqrt(math.pi) / math.sqrt(_d)

                lin = WNDense(width, out_d, k_init, -bias, generator)
            elif num_frequencies > 0 and l == 0:
                def k_init0(shape, gen, _o=out_d):
                    w = torch.zeros(shape)
                    w[:3] = _normal((3, shape[1]), gen) * math.sqrt(2.0) / math.sqrt(_o)
                    return w

                lin = WNDense(width, out_d, k_init0, generator=generator)
            else:
                def k_initn(shape, gen, _o=out_d, _l=l):
                    w = _normal(shape, gen) * (math.sqrt(2.0) / math.sqrt(_o))
                    if num_frequencies > 0 and _l in self.skip_in:
                        w[-(d_in - 3):] = 0.0
                    return w

                lin = WNDense(width, out_d, k_initn, generator=generator)
            layers.append(lin)
            width = out_d + (d_in if (l + 1) in self.skip_in else 0)
        self.layers = nn.ModuleList(layers)
        _on(self, device)

    def forward(self, x, c: Optional[torch.Tensor] = None):
        inp = positional_encoding(x, self.num_frequencies)
        h = inp if c is None else torch.cat([c, inp], dim=-1)
        last = len(self.layers) - 1
        for l, lin in enumerate(self.layers):
            if l in self.skip_in:
                h = torch.cat([h, inp], dim=-1) / math.sqrt(2.0)
            h = lin(h)
            if l < last:
                h = F.softplus(100.0 * h) / 100.0  # softplus(β = 100)
        res = _split_outputs(h, self.out_dims)
        if "rgb" in res:
            res["rgb"] = torch.sigmoid(res["rgb"])
        return res


class RenderingNetwork(nn.Module):
    """View-dependent shading MLP (reference common.py:315-368) over
    (normals, points, encoded view dirs [, code]): `n_layers` ReLU
    WNDense layers, then tanh scaled to [0, 1].  `in_dim` 33 is
    `neural_texture_features` at view_freqs 4."""

    def __init__(self, out_dims: OutDims = (("rgb", 3),), hidden_size: int = 512,
                 n_layers: int = 4, in_dim: int = 33, c_dim: int = 0,
                 generator=None, device=None):
        super().__init__()
        self.out_dims = tuple(out_dims)
        out_total = sum(d for _, d in self.out_dims)
        widths = [in_dim + c_dim] + [hidden_size] * n_layers + [out_total]
        self.layers = nn.ModuleList(
            WNDense(a, b, generator=generator)
            for a, b in zip(widths[:-1], widths[1:]))
        _on(self, device)

    def forward(self, x, c: Optional[torch.Tensor] = None):
        h = x if c is None else torch.cat([c, x], dim=-1)
        for lin in self.layers[:-1]:
            h = torch.relu(lin(h))
        res = _split_outputs(torch.tanh(self.layers[-1](h)), self.out_dims)
        if "rgb" in res:
            res["rgb"] = res["rgb"] / 2.0 + 0.5  # scale_rgb
        return res


class ResnetBlockFC(nn.Module):
    """ONet fully-connected ResNet block (reference common.py:370-413); its
    second layer starts at zero."""

    def __init__(self, size_in: int, size_out: Optional[int] = None,
                 size_h: Optional[int] = None, generator=None):
        super().__init__()
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        self.fc_0 = _linear(size_in, size_h, gen=generator)
        self.fc_1 = _linear(size_h, size_out, zeros_init, gen=generator)
        self.shortcut = (None if size_in == size_out else
                         _linear(size_in, size_out, bias=False, gen=generator))

    def forward(self, x):
        dx = self.fc_1(torch.relu(self.fc_0(torch.relu(x))))
        xs = x if self.shortcut is None else self.shortcut(x)
        return xs + dx


class Occupancy(nn.Module):
    """ONet-style decoder: `n_blocks` FC ResNet blocks, the code (if
    c_dim > 0) added before each (reference common.py:415-491)."""

    def __init__(self, out_dims: OutDims = (("occupancy", 1), ("rgb", 3)),
                 hidden_size: int = 512, n_blocks: int = 5, leaky: bool = False,
                 in_dim: int = 3, c_dim: int = 0, generator=None, device=None):
        super().__init__()
        self.out_dims = tuple(out_dims)
        self.leaky = leaky
        out_total = sum(d for _, d in self.out_dims)
        self.fc_p = _linear(in_dim, hidden_size, gen=generator)
        fc_c, blocks = [], []
        for _ in range(n_blocks):  # flax's creation order: code, then block
            if c_dim > 0:
                fc_c.append(_linear(c_dim, hidden_size, gen=generator))
            blocks.append(ResnetBlockFC(hidden_size, generator=generator))
        self.fc_c = nn.ModuleList(fc_c)
        self.blocks = nn.ModuleList(blocks)
        self.fc_out = _linear(hidden_size, out_total, gen=generator)
        _on(self, device)

    def forward(self, p, c: Optional[torch.Tensor] = None):
        net = self.fc_p(p)
        for i, block in enumerate(self.blocks):
            if c is not None:
                net = net + self.fc_c[i](c)
            net = block(net)
        act = (lambda v: F.leaky_relu(v, 0.2)) if self.leaky else torch.relu
        res = _split_outputs(self.fc_out(act(net)), self.out_dims)
        if "rgb" in res:
            res["rgb"] = torch.sigmoid(res["rgb"])
        return res


class ResidualSDF(nn.Module):
    """Base SDF plus a gated Siren residual (reference common.py:538-594):
    sdf = base + g · residual, g = (1 + R)/(R + exp(base²/0.01)), R = 100,
    the gate detached."""

    def __init__(self, out_dims: OutDims = (("sdf", 1),), hidden_size: int = 512,
                 n_layers: int = 8, siren_hidden_size: int = 256,
                 siren_n_layers: int = 3, c_dim: int = 0, generator=None,
                 device=None):
        super().__init__()
        self.base = SDF(out_dims=out_dims, hidden_size=hidden_size,
                        n_layers=n_layers, c_dim=c_dim, generator=generator,
                        device="cpu")
        self.residual = Siren(hidden_size=siren_hidden_size,
                              n_layers=siren_n_layers, out_dims=out_dims,
                              generator=generator, device="cpu")
        _on(self, device)

    def forward(self, x, c=None, only_base: bool = False):
        base = self.base(x, c)
        if only_base:
            return base
        res = self.residual(x)
        r = 100.0
        gate = (1.0 + r) / (r + torch.exp(base["sdf"] ** 2 / 0.01))
        out = dict(base)
        out["sdf"] = base["sdf"] + gate.detach() * res["sdf"]
        return out


def approximate_gradient(points: torch.Tensor,
                         sdf_fn: Callable[[torch.Tensor], torch.Tensor],
                         h: float = 1e-3) -> torch.Tensor:
    """Central-difference SDF gradient (reference common.py:494-535):
    sdf_fn maps (N, 3) → (N,); one call over the 6 offsets of every point."""
    eye = torch.eye(3, dtype=points.dtype, device=points.device) * (h / 2.0)
    plus = points[:, None, :] + eye[None]
    minus = points[:, None, :] - eye[None]
    f = sdf_fn(torch.cat([plus, minus], dim=1).reshape(-1, 3)).reshape(
        points.shape[0], 6)
    return (f[:, :3] - f[:, 3:]) / h


def neural_texture_features(points: torch.Tensor, normals: torch.Tensor,
                            camera_position: Optional[torch.Tensor] = None,
                            view_freqs: int = 4) -> torch.Tensor:
    """A NeuralTexture decoder's input (reference DSS/core/texture.py:
    130-162): (normals, points [, encoded unit view dirs]).

    points/normals (P, 3).  camera_position None → (P, 6); (3,) → (P, F);
    (V, 3) → (V, P, F) for V views at once, F = 6 + 3·(2·view_freqs + 1)."""
    if camera_position is None:
        return torch.cat([normals, points], dim=-1)
    cam = camera_position
    batched = cam.ndim == 2
    if not batched:
        cam = cam[None]
    vd = points[None] - cam[:, None, :]
    vd = vd / torch.clamp(torch.linalg.vector_norm(vd, dim=-1, keepdim=True),
                          min=1e-12)
    shape = vd.shape
    feats = torch.cat([torch.broadcast_to(normals, shape),
                       torch.broadcast_to(points, shape),
                       positional_encoding(vd, view_freqs)], dim=-1)
    return feats if batched else feats[0]
