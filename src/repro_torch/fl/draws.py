"""The random draws of a run, behind one injectable object.

The reference derives every draw from a JAX key chain (`PRNGKey(seed)`,
split per round and per client, `fold_in` for the strategy).  torch
cannot reproduce threefry, so `run_federated` takes its draws from an
object with two methods instead:

    batch_indices(rnd, n, n_slots, batch_size, local_steps) -> (m, S, B)
        every client's minibatch slot indices for round ``rnd``, drawn as
        ``randint(0, 2**30) % max(n_i, 1) % n_slots`` (the reference's
        rule, `repro/fl/placement/host.py:35-37`);
    kmeans_first(m) -> int
        the first k-means centre of the UCFL stream plan.

`TorchDraws` is the default and draws from `torch.Generator`s.  A parity
test passes an object that replays the reference's key chain instead.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def split_seed(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds from one, like splitting a key."""
    kids = np.random.SeedSequence(int(seed)).spawn(n)
    return [int(k.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for k in kids]


def init_generator(seed: int, device: DeviceLike = "cuda") -> torch.Generator:
    """The generator `run_federated` hands to ``model_init``."""
    dev = resolve_device(device)
    return torch.Generator(device=dev).manual_seed(split_seed(seed, 3)[0])


class TorchDraws:
    """Default draws: batches from a generator on ``device``, the k-means
    start from a CPU generator; seeds split from ``seed`` so that neither
    stream repeats the model-init stream."""

    def __init__(self, seed: int = 0, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        _, s_batch, s_kmeans = split_seed(seed, 3)
        self._batch = torch.Generator(device=self.device).manual_seed(s_batch)
        self._kmeans_seed = s_kmeans

    def batch_indices(self, rnd: int, n: torch.Tensor, n_slots: int,
                      batch_size: int, local_steps: int) -> torch.Tensor:
        m = n.shape[0]
        r = torch.randint(0, 1 << 30, (m, local_steps, batch_size),
                          generator=self._batch, device=self.device)
        n_i = torch.clamp(n.to(self.device, torch.int64), min=1)
        return r % n_i[:, None, None] % n_slots

    def kmeans_first(self, m: int) -> int:
        gen = torch.Generator().manual_seed(self._kmeans_seed)
        return int(torch.randint(0, m, (), generator=gen))
