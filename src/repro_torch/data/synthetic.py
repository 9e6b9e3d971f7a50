"""Synthetic EMNIST stand-in, drawn on the device from a torch.Generator.

Counterpart of `repro/data/synthetic.py` (`synthetic_emnist` and the
helpers it uses).  Same construction — smooth Fourier prototypes per
class plus a horizontal orientation ramp, per-sample smooth deformation
and pixel noise — but torch's generator does not reproduce JAX's
threefry bits, so the images differ from the reference's draw for draw.
Parity tests therefore feed the reference's arrays in through
`repro_torch.convert.fed_from_numpy`.
"""
from __future__ import annotations

from typing import Dict

import torch


def _smooth_noise(gen: torch.Generator, n: int, size: int, channels: int,
                  cutoff: int = 6) -> torch.Tensor:
    """Low-frequency random images via a truncated 2-D Fourier basis, NHWC."""
    dev = gen.device
    shape = (n, channels, cutoff, cutoff)
    coef = torch.complex(torch.randn(shape, generator=gen, device=dev),
                         torch.randn(shape, generator=gen, device=dev))
    full = torch.zeros((n, channels, size, size), dtype=torch.complex64,
                       device=dev)
    full[:, :, :cutoff, :cutoff] = coef
    img = torch.fft.ifft2(full).real
    img = img / (torch.std(img, dim=(-2, -1), correction=0, keepdim=True)
                 + 1e-6)
    return img.permute(0, 2, 3, 1).contiguous()


def make_class_prototypes(gen: torch.Generator, n_classes: int, size: int,
                          channels: int, *, separation: float = 1.0,
                          orientation_scale: float = 1.5) -> torch.Tensor:
    """Shared base + ``separation``-scaled class parts + orientation ramp."""
    base = _smooth_noise(gen, 1, size, channels)
    uniq = _smooth_noise(gen, n_classes, size, channels)
    ramp = torch.linspace(-1.0, 1.0, size, device=gen.device)[None, :, None]
    ramp = ramp.expand(size, size, channels)
    return base + separation * uniq + orientation_scale * ramp[None]


def sample_dataset(gen: torch.Generator, prototypes: torch.Tensor,
                   labels: torch.Tensor, *, deform_scale: float = 1.1,
                   noise_scale: float = 0.8) -> torch.Tensor:
    """x_i = prototype[y_i] + deform (smooth, per-sample) + white noise."""
    n = labels.shape[0]
    size, channels = prototypes.shape[1], prototypes.shape[3]
    deform = _smooth_noise(gen, n, size, channels) * deform_scale
    noise = torch.randn((n, size, size, channels), generator=gen,
                        device=gen.device) * noise_scale
    return prototypes[labels] + deform + noise


def synthetic_emnist(gen: torch.Generator, n: int,
                     n_classes: int = 47) -> Dict[str, torch.Tensor]:
    """EMNIST-like: 28x28x1, ``n_classes`` balanced classes, on
    ``gen.device``."""
    protos = make_class_prototypes(gen, n_classes, 28, 1, separation=1.2)
    labels = torch.randint(0, n_classes, (n,), generator=gen,
                           device=gen.device)
    x = sample_dataset(gen, protos, labels, deform_scale=0.5,
                       noise_scale=0.4)
    return {"x": x, "y": labels}
