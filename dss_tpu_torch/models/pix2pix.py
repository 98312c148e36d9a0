"""Pix2pix ResNet generator for learned render denoising (counterpart of
dss_tpu/models/pix2pix.py).

Reference: DSS/misc/pix2pix/** vendors the junyanz pix2pix test path, and
DSS/misc/imageFilters.py:184-229 (`Pix2PixDenoising`) loads a pretrained
generator to denoise rendered images.  The deployed configuration
(imageFilters.py:202-204) is `norm='pixel'` with `netG='resnet_9blocks'`:
reflection-padded convs, pixel norm (networks.py:8-14), no conv bias
except the output conv's (networks.py:343-345, 374), 2× down and
upsampling, 9 residual blocks, tanh.

The original is torch, so the generator here is laid out exactly as
networks.py:322-381 builds it: one `nn.Sequential` named `model`, each
residual block's layers in a `conv_block` Sequential.  A reference
checkpoint (`model.<i>.weight`, `model.<i>.conv_block.<j>.weight`) loads
directly with `load_generator_weights`, and dss_tpu's
`load_torch_generator_weights` takes this module's `state_dict()`.  The
pretrained weights come with the reference's download script and are not
in this repository: a user supplies them.
"""
from __future__ import annotations

from typing import Mapping, Union

import torch
from torch import nn

from dss_tpu_torch.utils.device import resolve_device


class PixelNorm(nn.Module):
    """networks.py:8-14 PixelNormLayer: x / sqrt(mean_c(x²) + 1e-8) per
    pixel, across channels."""

    def forward(self, x):  # (N, C, H, W)
        return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + 1e-8)


class InstanceNorm(nn.Module):
    """Per-image, per-channel normalisation: biased variance, eps 1e-5, no
    affine parameters (InstanceNorm2d's defaults)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x):  # (N, C, H, W)
        mean = torch.mean(x, dim=(2, 3), keepdim=True)
        var = torch.var(x, dim=(2, 3), keepdim=True, correction=0)
        return (x - mean) * torch.rsqrt(var + self.eps)


def _make_norm(norm: str) -> nn.Module:
    if norm == "pixel":
        return PixelNorm()
    if norm == "instance":
        return InstanceNorm()
    raise ValueError(f"unsupported norm: {norm}")


class ResnetBlock(nn.Module):
    """x + [pad, conv3, norm, relu, pad, conv3, norm](x) (networks.py's
    ResnetBlock without dropout)."""

    def __init__(self, dim: int, norm: str = "pixel", use_bias: bool = False):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1),
            nn.Conv2d(dim, dim, 3, padding=0, bias=use_bias),
            _make_norm(norm), nn.ReLU(True),
            nn.ReflectionPad2d(1),
            nn.Conv2d(dim, dim, 3, padding=0, bias=use_bias),
            _make_norm(norm))

    def forward(self, x):
        return x + self.conv_block(x)


class ResnetGenerator(nn.Module):
    """resnet_9blocks: c7s1-ngf, d2·ngf, d4·ngf, n_blocks × R4·ngf,
    u2·ngf, u·ngf, c7s1-out, tanh; NCHW.  Biases: none except the output
    conv's with `norm="pixel"`, every conv's with `norm="instance"`.
    Weights are torch's default draws from `generator` on the CPU, then
    moved to `device` (the card unless named)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 ngf: int = 64, n_blocks: int = 9, norm: str = "pixel",
                 generator: torch.Generator = None, device=None):
        super().__init__()
        use_bias = norm == "instance"
        layers = [nn.ReflectionPad2d(3),
                  nn.Conv2d(in_channels, ngf, 7, padding=0, bias=use_bias),
                  _make_norm(norm), nn.ReLU(True)]
        for mult in (1, 2):
            layers += [nn.Conv2d(ngf * mult, ngf * mult * 2, 3, stride=2,
                                 padding=1, bias=use_bias),
                       _make_norm(norm), nn.ReLU(True)]
        layers += [ResnetBlock(ngf * 4, norm, use_bias)
                   for _ in range(n_blocks)]
        for mult in (4, 2):
            layers += [nn.ConvTranspose2d(ngf * mult, ngf * mult // 2, 3,
                                          stride=2, padding=1,
                                          output_padding=1, bias=use_bias),
                       _make_norm(norm), nn.ReLU(True)]
        layers += [nn.ReflectionPad2d(3),
                   nn.Conv2d(ngf, out_channels, 7, padding=0),  # keeps its bias
                   nn.Tanh()]
        self.model = nn.Sequential(*layers)
        if generator is not None:
            self._redraw(generator)
        self.to(resolve_device(device))

    def _redraw(self, gen: torch.Generator) -> None:
        """torch's default conv init (kaiming-uniform a = √5, bias
        U(±1/√fan_in)) drawn from `gen`, layer by layer."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    fan_in = nn.init._calculate_fan_in_and_fan_out(m.weight)[0]
                    bound = 1.0 / fan_in ** 0.5
                    m.weight.uniform_(-bound, bound, generator=gen)
                    if m.bias is not None:
                        m.bias.uniform_(-bound, bound, generator=gen)

    def forward(self, x):  # (N, C, H, W), already shifted to [-0.5, 0.5]
        return self.model(x)


def denoise_images(generator: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """[0, 1] images (N, H, W, 3) → denoised [0, 1] (N, H, W, 3).

    Pix2PixDenoising.forward (imageFilters.py:210-229): shift to
    [-0.5, 0.5], run the generator, clamp the output to the shifted
    input's per-image, per-channel min and max, shift back."""
    x = images - 0.5
    y = generator(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    lo = torch.amin(x, dim=(1, 2), keepdim=True)
    hi = torch.amax(x, dim=(1, 2), keepdim=True)
    return torch.minimum(torch.maximum(y, lo), hi) + 0.5


def load_generator_weights(
    generator: nn.Module,
    path_or_state_dict: Union[str, Mapping[str, torch.Tensor]],
) -> nn.Module:
    """Load a reference `.pth` (or an in-memory state dict) into
    `generator` with strict=True, after stripping DataParallel `module.`
    prefixes; returns the generator."""
    if isinstance(path_or_state_dict, Mapping):
        sd = path_or_state_dict
    else:
        sd = torch.load(path_or_state_dict, map_location="cpu",
                        weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    sd = {k.split("module.")[-1]: v for k, v in sd.items()}
    generator.load_state_dict(sd, strict=True)
    return generator
