"""Cohort schedules: which population rows each paged superstep trains.

Counterpart of `repro/fl/population/schedule.py`, copied as it is (pure
numpy): ``RandomCohorts`` seeds ``np.random.default_rng([seed, step])``,
so its cohorts and ``spec`` strings equal the reference's.  A schedule
is a PURE function of the superstep index, with no internal state, so a
checkpointed run resumed at chunk t re-derives exactly the cohort
sequence the interrupted run would have used (the resume contract).
"""
from __future__ import annotations

import abc
from typing import Sequence

import numpy as np


class CohortSchedule(abc.ABC):
    """Maps a superstep index to the sorted cohort row indices."""

    cohort: int

    @abc.abstractmethod
    def indices(self, step: int, n: int) -> np.ndarray:
        """The (cohort,) sorted int64 row indices for superstep ``step``
        of a population of ``n`` clients."""

    @property
    @abc.abstractmethod
    def spec(self) -> str:
        """Identity string recorded in checkpoints — a resumed run
        refuses a checkpoint written under a different schedule."""

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.spec!r})"


class SequentialSweep(CohortSchedule):
    """Round-robin over the population's n/cohort contiguous shards:
    superstep t trains shard ``t % (n // cohort)``.  Every client is
    visited once per sweep — the epoch-style default."""

    def __init__(self, cohort: int):
        if cohort < 1:
            raise ValueError(f"cohort must be >= 1, got {cohort}")
        self.cohort = cohort

    def indices(self, step: int, n: int) -> np.ndarray:
        if n % self.cohort:
            raise ValueError(
                f"SequentialSweep needs population {n} divisible by "
                f"cohort {self.cohort}")
        s = step % (n // self.cohort)
        return np.arange(s * self.cohort, (s + 1) * self.cohort,
                         dtype=np.int64)

    @property
    def spec(self) -> str:
        return f"sweep:{self.cohort}"


class RandomCohorts(CohortSchedule):
    """Uniform without-replacement cohort per superstep.  The draw is
    seeded by ``(seed, step)`` — a pure function of the step, never a
    stream — so resume replays the exact cohort sequence."""

    def __init__(self, cohort: int, seed: int = 0):
        if cohort < 1:
            raise ValueError(f"cohort must be >= 1, got {cohort}")
        self.cohort = cohort
        self.seed = seed

    def indices(self, step: int, n: int) -> np.ndarray:
        if self.cohort > n:
            raise ValueError(f"cohort {self.cohort} > population {n}")
        rng = np.random.default_rng([self.seed, step])
        return np.sort(rng.choice(n, self.cohort,
                                  replace=False)).astype(np.int64)

    @property
    def spec(self) -> str:
        return f"random:{self.cohort}:{self.seed}"


class FixedCohort(CohortSchedule):
    """The same explicit cohort every superstep — the paged-vs-resident
    bit-parity anchor's schedule (a resident run on the sub-population is
    then the exact reference)."""

    def __init__(self, idx: Sequence[int]):
        arr = np.sort(np.asarray(idx, dtype=np.int64))
        if arr.size == 0:
            raise ValueError("FixedCohort needs at least one client")
        if np.unique(arr).size != arr.size:
            raise ValueError("FixedCohort indices must be unique")
        self.idx = arr
        self.cohort = int(arr.size)

    def indices(self, step: int, n: int) -> np.ndarray:
        if self.idx[-1] >= n:
            raise ValueError(
                f"FixedCohort index {int(self.idx[-1])} out of range for "
                f"population {n}")
        return self.idx

    @property
    def spec(self) -> str:
        return "fixed:" + ",".join(str(int(i)) for i in self.idx)
