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
        that needs noise;
    fault_draws(rnd, m, d, cfg) -> FaultDraws
        a faulted run's per-round fault draws (the reference's
        ``fold_in(fold_in(kround, 3), i)`` for i = 0..4): the crash row,
        the NaN row, the bit-rot row, the bit-rot element mask (m, D) and
        the flipped bit's index (m, D), each drawn only when its axis of
        the `FaultConfig` ``cfg`` is on;
    device_batch_indices(rnd, n, n_slots, batch_size, local_steps)
        -> (m, d_max, S, B)
        a hierarchy run's per-device minibatch slots, ``n`` the (m, d_max)
        device sample counts (the reference's ``vmap(split(ckey_i,
        d_max))``, then each device's own ``split(·, S)`` and the slot
        rule);
    edge_noise(rnd, m, row, shape) -> (rows·d_max, F) float32 in [0, 1)
        the edge codec's stochastic-rounding noise of a fleet update whose
        first row is user ``row`` of m (the reference's
        ``uniform(fold_in(ckeys[row], 0x65646765), shape)``), drawn only
        for an edge codec that needs noise;
    device_dropout(rnd, m, row, shape, p) -> (rows, d_max) bool
        the edge's device-dropout coins of that update, True where the
        device's upload survives (the reference's ``bernoulli(fold_in(
        ekey, 1), 1 − p, shape)`` of that edge key), drawn only when ``p``
        > 0.

`TorchDraws` is the default and draws from `torch.Generator`s.  A parity
test passes an object that replays the reference's key chain instead.

The fused superstep takes a chunk's draws before the chunk runs
(`chunk_draws`): round by round, in the eventful engine's call order
(the batch slots, or a hierarchy run's `FleetDraws`, the sampler's
mask, the fault draws, the codec noise), from the same
object, stacked into (length, ...) tensors that the chunk reads by
round.  The two engines consume identical streams, and a captured graph
reads no generator.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl.placement.graphs import stack_rows, tree_map


def split_seed(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds from one, like splitting a key."""
    kids = np.random.SeedSequence(int(seed)).spawn(n)
    return [int(k.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for k in kids]


def init_generator(seed: int, device: DeviceLike = "cuda") -> torch.Generator:
    """The generator `run_federated` hands to ``model_init``."""
    dev = resolve_device(device)
    return torch.Generator(device=dev).manual_seed(split_seed(seed, 3)[0])


class FaultDraws(NamedTuple):
    """One round's fault draws (None where the axis is off), on the run's
    device, or a chunk's stacked (L, ...) rows of them."""
    crash: Optional[torch.Tensor]     # (m,) bool: the client crashes
    nan: Optional[torch.Tensor]       # (m,) bool: uploads NaN
    rot: Optional[torch.Tensor]       # (m,) bool: its upload bit-rots
    elem: Optional[torch.Tensor]      # (m, D) bool: this entry flips a bit
    bit: Optional[torch.Tensor]       # (m, D) int32 in [0, 32): which bit


class TorchDraws:
    """Default draws: batches, codec noise, fault draws and a hierarchy
    run's edge draws from generators on ``device``, the k-means start and
    the client permutations from CPU generators; seeds split from
    ``seed`` so that no stream repeats another or the model-init stream
    (`split_seed`'s children are fixed by index, so a new stream shifts
    none of the others)."""

    def __init__(self, seed: int = 0, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        (_, s_batch, s_kmeans, s_perm, s_noise, s_fault,
         s_edge) = split_seed(seed, 7)
        self._batch = torch.Generator(device=self.device).manual_seed(s_batch)
        self._kmeans_seed = s_kmeans
        self._perm = torch.Generator().manual_seed(s_perm)
        self._noise = torch.Generator(device=self.device).manual_seed(s_noise)
        self._fault = torch.Generator(device=self.device).manual_seed(s_fault)
        self._edge = torch.Generator(device=self.device).manual_seed(s_edge)

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

    def fault_draws(self, rnd: int, m: int, d: int, cfg: Any) -> FaultDraws:
        def coin(shape, p):
            return torch.rand(shape, generator=self._fault,
                              device=self.device) < p

        crash = coin((m,), cfg.crash) if cfg.crash > 0 else None
        nan = coin((m,), cfg.nan) if cfg.nan > 0 else None
        rot = elem = bit = None
        if cfg.bitrot > 0:
            rot = coin((m,), cfg.bitrot)
            elem = coin((m, d), cfg.bitrot_density)
            bit = torch.randint(0, 32, (m, d), generator=self._fault,
                                device=self.device, dtype=torch.int32)
        return FaultDraws(crash, nan, rot, elem, bit)

    def device_batch_indices(self, rnd: int, n: torch.Tensor, n_slots: int,
                             batch_size: int,
                             local_steps: int) -> torch.Tensor:
        m, d_max = n.shape
        r = torch.randint(0, 1 << 30, (m, d_max, local_steps, batch_size),
                          generator=self._edge, device=self.device)
        n_i = torch.clamp(n.to(self.device, torch.int64), min=1)
        return r % n_i[:, :, None, None] % n_slots

    def edge_noise(self, rnd: int, m: int, row: int, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._edge,
                          device=self.device, dtype=torch.float32)

    def device_dropout(self, rnd: int, m: int, row: int, shape,
                       p: float) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._edge,
                          device=self.device) < 1.0 - p

    def _generators(self) -> dict:
        return {"batch": self._batch, "perm": self._perm,
                "noise": self._noise, "fault": self._fault,
                "edge": self._edge}

    def state_dict(self) -> dict:
        """Where each stateful stream stands (its generator's
        ``get_state()``, a CPU uint8 tensor): the paging engine's
        checkpoints keep it where the reference keeps its key."""
        return {name: gen.get_state()
                for name, gen in self._generators().items()}

    def load_state_dict(self, state: dict) -> None:
        """Put every stream back where `state_dict` found it.  A stream
        that ``state`` lacks (a snapshot written before the stream
        existed: the edge stream, which no paged run draws from) is left
        where it stands."""
        for name, gen in self._generators().items():
            if name in state:
                gen.set_state(torch.as_tensor(state[name]).cpu())


class ChunkDraws(NamedTuple):
    """One chunk's draws, a row per round."""
    slots: Any                        # (L, m, S, B) int64, on the device;
                                      # a hierarchy run's `FleetDraws` of
                                      # (L, ...) rows
    mask: Optional[torch.Tensor]      # (L, m) bool on the device; None
                                      # without a sampler
    mask_np: Optional[np.ndarray]     # the same rows on the host
    noise: Optional[torch.Tensor]     # (L, m, D) f32 on the device; None
                                      # without a noisy codec
    faults: Optional[FaultDraws]      # (L, ...) rows on the device; None
                                      # without faults


def round_fault_draws(draws: Any, rnd: int, m: int, d: int, cfg: Any,
                      device: torch.device) -> FaultDraws:
    """``draws.fault_draws`` for round ``rnd``, moved to ``device``."""
    fd = draws.fault_draws(rnd, m, d, cfg)
    return FaultDraws(*(None if t is None else t.to(device) for t in fd))


def chunk_draws(draws: Any, rounds: range, *, step: Any, x: torch.Tensor,
                n: torch.Tensor, sampler: Any, m: int,
                noise_d: Optional[int], device: torch.device,
                fault_cfg: Any = None,
                fault_d: Optional[int] = None) -> ChunkDraws:
    """The draws of ``rounds``, taken per round as the eventful engine
    takes them: the update step's own (``step.draw(draws, rnd, x, n)``:
    the batch slots, or a hierarchy run's `FleetDraws`), then the
    sampler's mask (``sampler.sample_traced``: all-True where the
    eventful ``sample`` gives None), then ``fault_draws`` of (m,
    ``fault_d``) when ``fault_cfg`` is given, then ``codec_noise`` of (m,
    ``noise_d``) when ``noise_d`` is given."""
    slots, masks, faults, noise = [], [], [], []
    for rnd in rounds:
        slots.append(step.draw(draws, rnd, x, n))
        if sampler is not None:
            masks.append(sampler.sample_traced(rnd, m, draws))
        if fault_cfg is not None:
            faults.append(round_fault_draws(draws, rnd, m, fault_d,
                                            fault_cfg, device))
        if noise_d is not None:
            noise.append(draws.codec_noise(rnd, (m, noise_d)).to(device))
    mask_cpu = torch.stack(masks) if masks else None
    return ChunkDraws(
        slots=tree_map(lambda *rows: torch.stack(rows), *slots),
        mask=None if mask_cpu is None else mask_cpu.to(device),
        mask_np=None if mask_cpu is None else mask_cpu.numpy(),
        noise=torch.stack(noise) if noise else None,
        faults=FaultDraws(*stack_rows(faults)) if faults else None)
