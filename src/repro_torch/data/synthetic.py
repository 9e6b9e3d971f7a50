"""Synthetic EMNIST / CIFAR-10 stand-ins and LM token streams, drawn on
the device from a torch.Generator.

Counterpart of `repro/data/synthetic.py` (`synthetic_emnist`,
`synthetic_cifar`, `synthetic_lm_tokens` and the helpers they use).
Same construction — smooth Fourier prototypes per class plus a
horizontal orientation ramp, per-sample smooth deformation and pixel
noise; tokens from a noisy order-2 Markov rule — but torch's generator
does not reproduce JAX's threefry bits, so the draws differ from the
reference's draw for draw.  Parity tests therefore feed the reference's
arrays in (`repro_torch.convert.fed_from_numpy`, the scenarios' ``data``
argument), or its draws (`synthetic_lm_tokens`'s ``a``, ``start``,
``noise`` and ``rand``).
"""
from __future__ import annotations

from typing import Dict, Optional

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


def synthetic_cifar(gen: torch.Generator, n: int,
                    n_classes: int = 10) -> Dict[str, torch.Tensor]:
    """CIFAR-like: 32x32x3, ``n_classes`` balanced classes, on
    ``gen.device``."""
    protos = make_class_prototypes(gen, n_classes, 32, 3, separation=0.5)
    labels = torch.randint(0, n_classes, (n,), generator=gen,
                           device=gen.device)
    x = sample_dataset(gen, protos, labels)
    return {"x": x, "y": labels}


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 two's complement (the reference's
    int32 arithmetic overflows, as at vocab 50,304)."""
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def synthetic_lm_tokens(gen: Optional[torch.Generator], batch: int,
                        seq_len: int, vocab: int, *, order: int = 2,
                        a: Optional[torch.Tensor] = None,
                        start: Optional[torch.Tensor] = None,
                        noise: Optional[torch.Tensor] = None,
                        rand: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(batch, seq_len) int64 tokens: each is ``(Σ_j carry_j · a_j + 17)
    mod vocab`` of the previous ``order`` tokens (int32 arithmetic, as
    the reference's), replaced by a uniform token where ``noise`` (10 %).
    The draws — ``a`` (order,) in [1, vocab−1), ``start`` (batch, order),
    ``noise`` (batch, seq_len) bool, ``rand`` (batch, seq_len) — come
    from ``gen`` unless given (a parity test passes the reference's)."""
    dev = gen.device if gen is not None else next(
        t.device for t in (a, start, noise, rand) if t is not None)

    def draw(given, fn):
        return (fn() if given is None else given).to(dev)

    a = draw(a, lambda: torch.randint(1, vocab - 1, (order,), generator=gen,
                                      device=dev)).long()
    carry = draw(start, lambda: torch.randint(
        0, vocab, (batch, order), generator=gen, device=dev)).long()
    noise = draw(noise, lambda: torch.rand(
        (batch, seq_len), generator=gen, device=dev) < 0.1).bool()
    rand = draw(rand, lambda: torch.randint(
        0, vocab, (batch, seq_len), generator=gen, device=dev)).long()
    toks = []
    for t in range(seq_len):
        nxt = _wrap_int32((carry * a[None, :]).sum(dim=1) + 17) % vocab
        nxt = torch.where(noise[:, t], rand[:, t], nxt)
        carry = torch.cat([carry[:, 1:], nxt[:, None]], dim=1)
        toks.append(nxt)
    return torch.stack(toks, dim=1)
