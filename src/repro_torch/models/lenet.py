"""LeNet-5 as plain functions over a parameter dict.

Counterpart of `repro/models/lenet.py`, over the same dict and layouts so
the reference's ``params0`` loads unchanged: conv weights OIHW, FC
weights ``(din, dout)``, images NHWC at the surface.  Inside, the convs
run NCHW (``F.conv2d``'s layout); the pooled activation is permuted back
to NHWC before the flatten so ``fc1_w`` rows line up with the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class LeNetConfig:
    in_size: int = 28
    in_channels: int = 1
    n_classes: int = 47
    c1: int = 6
    c2: int = 16
    fc1: int = 120
    fc2: int = 84


def init_params(generator: torch.Generator, cfg: LeNetConfig,
                device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Fan-in scaled normal weights, zero biases, drawn from ``generator``
    (which lives on ``device``)."""
    dev = resolve_device(device)
    s = (cfg.in_size - 4) // 2
    s = (s - 4) // 2
    flat = cfg.c2 * s * s

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator, device=dev) \
            / math.sqrt(fan_in)

    zeros = lambda n: torch.zeros((n,), device=dev)
    return {
        "conv1_w": normal((cfg.c1, cfg.in_channels, 5, 5),
                          25 * cfg.in_channels),
        "conv1_b": zeros(cfg.c1),
        "conv2_w": normal((cfg.c2, cfg.c1, 5, 5), 25 * cfg.c1),
        "conv2_b": zeros(cfg.c2),
        "fc1_w": normal((flat, cfg.fc1), flat),
        "fc1_b": zeros(cfg.fc1),
        "fc2_w": normal((cfg.fc1, cfg.fc2), cfg.fc1),
        "fc2_b": zeros(cfg.fc2),
        "out_w": normal((cfg.fc2, cfg.n_classes), cfg.fc2),
        "out_b": zeros(cfg.n_classes),
    }


def apply(params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) float32 -> logits (B, n_classes)."""
    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(torch.tanh(F.conv2d(h, params["conv1_w"],
                                         params["conv1_b"])), 2, 2)
    h = F.max_pool2d(torch.tanh(F.conv2d(h, params["conv2_w"],
                                         params["conv2_b"])), 2, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC flatten
    h = torch.tanh(h @ params["fc1_w"] + params["fc1_b"])
    h = torch.tanh(h @ params["fc2_w"] + params["fc2_b"])
    return h @ params["out_w"] + params["out_b"]


def loss_fn(params, batch):
    """batch: {"x": (B,H,W,C), "y": (B,)} -> (mean CE, metrics)."""
    logits = apply(params, batch["x"])
    lps = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(lps, -1, batch["y"].long()[:, None])[:, 0]
    loss = nll.mean()
    acc = (logits.argmax(-1) == batch["y"]).float().mean()
    return loss, {"loss": loss, "acc": acc}


def accuracy(params, batch) -> torch.Tensor:
    logits = apply(params, batch["x"])
    return (logits.argmax(-1) == batch["y"]).float().mean()
