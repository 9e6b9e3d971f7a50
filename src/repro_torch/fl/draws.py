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
        the first k-means centre of the UCFL stream plan;
    permutation(rnd, m) -> (m,) int64 on the CPU
        a random order of the clients, drawn only for a sampler that
        needs one (``UniformFraction`` keeps its first k);
    codec_noise(rnd, shape) -> (m, D) float32 in [0, 1)
        the stochastic-rounding noise of a QSGD uplink (the reference's
        ``uniform(fold_in(kround, 2), shape)``), drawn only for a codec
        that needs noise.

`TorchDraws` is the default and draws from `torch.Generator`s.  A parity
test passes an object that replays the reference's key chain instead.

The fused superstep takes a chunk's draws before the chunk runs
(`chunk_draws`): round by round, in the eventful engine's call order
(the batch slots, the sampler's mask, the codec noise), from the same
object, stacked into (length, ...) tensors that the chunk reads by
round.  The two engines consume identical streams, and a captured graph
reads no generator.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

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
    """Default draws: batches and codec noise from generators on
    ``device``, the k-means start and the client permutations from CPU
    generators; seeds split from ``seed`` so that no stream repeats
    another or the model-init stream."""

    def __init__(self, seed: int = 0, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        _, s_batch, s_kmeans, s_perm, s_noise = split_seed(seed, 5)
        self._batch = torch.Generator(device=self.device).manual_seed(s_batch)
        self._kmeans_seed = s_kmeans
        self._perm = torch.Generator().manual_seed(s_perm)
        self._noise = torch.Generator(device=self.device).manual_seed(s_noise)

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

    def permutation(self, rnd: int, m: int) -> torch.Tensor:
        return torch.randperm(m, generator=self._perm)

    def codec_noise(self, rnd: int, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._noise,
                          device=self.device, dtype=torch.float32)


class ChunkDraws(NamedTuple):
    """One chunk's draws, a row per round."""
    slots: torch.Tensor               # (L, m, S, B) int64, on the device
    mask: Optional[torch.Tensor]      # (L, m) bool on the device; None
                                      # without a sampler
    mask_np: Optional[np.ndarray]     # the same rows on the host
    noise: Optional[torch.Tensor]     # (L, m, D) f32 on the device; None
                                      # without a noisy codec


def chunk_draws(draws: Any, rounds: range, *, n: torch.Tensor, n_slots: int,
                batch_size: int, local_steps: int, sampler: Any, m: int,
                noise_d: Optional[int], device: torch.device) -> ChunkDraws:
    """The draws of ``rounds``, taken per round as the eventful engine
    takes them: ``batch_indices``, then the sampler's mask
    (``sampler.sample_traced``: all-True where the eventful ``sample``
    gives None), then ``codec_noise`` of (m, ``noise_d``) when ``noise_d``
    is given."""
    slots, masks, noise = [], [], []
    for rnd in rounds:
        slots.append(draws.batch_indices(rnd, n, n_slots, batch_size,
                                         local_steps).to(device))
        if sampler is not None:
            masks.append(sampler.sample_traced(rnd, m, draws))
        if noise_d is not None:
            noise.append(draws.codec_noise(rnd, (m, noise_d)).to(device))
    mask_cpu = torch.stack(masks) if masks else None
    return ChunkDraws(
        slots=torch.stack(slots),
        mask=None if mask_cpu is None else mask_cpu.to(device),
        mask_np=None if mask_cpu is None else mask_cpu.numpy(),
        noise=torch.stack(noise) if noise else None)
