"""Host-backed client-state store.

Counterpart of `repro/fl/population/store.py`.  The paging engine keeps
the FULL per-client state population (model params, optimizer state
and, under a lossy channel, error-feedback residuals) in host memory,
optionally memory-mapped to disk, with every leaf laid out ``(n, ...)``
so a sampled cohort is one row gather.  Only the active cohort's rows
ever live on the card: device memory scales with the cohort size m,
host memory or disk with the population n.

The store is deliberately dumb: numpy rows in, numpy rows out, over the
port's nested dicts (`fl.placement.graphs.tree_map` / `leaves`, dict
keys sorted as the reference's pytree flattening sorts them).  Device
placement happens in the paging layer (`Placement.stage` for the H2D
leg, `Placement.fetch` for the D2H leg), and a device -> host -> device
round trip of the row dtypes is bitwise lossless, which is what makes
the paged engine's parity anchor against the resident engine possible.
"""
from __future__ import annotations

import itertools
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.fl.placement.graphs import leaves, tree_map


def _host(leaf: Any) -> np.ndarray:
    """A leaf (numpy array, or tensor on any device) as a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class ClientStateStore:
    """Population-sized per-client state, host-resident, row-gatherable.

    ``tree`` is a nested dict whose leaves are (n, ...) numpy arrays
    (plain, or ``np.memmap`` when ``directory`` is set); row i is client
    i's state.  Build one with `create` (broadcast a single-client
    template) or `from_state_dict` (checkpoint restore).
    """

    def __init__(self, tree: Any, n: int, directory: Optional[str] = None):
        for leaf in leaves(tree):
            if leaf.shape[0] != n:
                raise ValueError(
                    f"store leaf has leading dim {leaf.shape[0]}, "
                    f"expected population size {n}")
        self.tree = tree
        self.n = n
        self.directory = directory

    # ---- construction -----------------------------------------------------

    @classmethod
    def _build(cls, tree: Any, shape_of, directory: Optional[str]) -> Any:
        """Fresh writable leaves (RAM or ``directory``'s memmaps, one
        ``leaf_<i>.npy`` a leaf) filled by ``shape_of``'s ``(shape,
        source)`` for each leaf of ``tree``."""
        count = itertools.count()

        def alloc(leaf):
            src = _host(leaf)
            shape, fill = shape_of(src)
            arr = cls._alloc(directory, next(count), shape, src.dtype)
            arr[...] = fill
            return arr

        return tree_map(alloc, tree)

    @classmethod
    def create(cls, template: Any, n: int,
               directory: Optional[str] = None) -> "ClientStateStore":
        """Broadcast a single-client ``template`` (leaf shapes are the
        PER-CLIENT shapes, no leading dim) to all n rows.  With
        ``directory``, each leaf becomes a disk-backed ``.npy`` memmap:
        populations far beyond host RAM stay pageable."""
        tree = cls._build(template, lambda row: ((n,) + row.shape, row[None]),
                          directory)
        return cls(tree, n, directory)

    @classmethod
    def from_state_dict(cls, d: Any,
                        directory: Optional[str] = None) -> "ClientStateStore":
        """Rebuild from `state_dict` output (a restored checkpoint's leaves
        are tensors: copied into fresh writable host rows, or into
        ``directory``'s memmaps)."""
        tree = cls._build(d["tree"], lambda src: (src.shape, src), directory)
        return cls(tree, int(d["n"]), directory)

    @staticmethod
    def _alloc(directory: Optional[str], i: int, shape, dtype) -> np.ndarray:
        if directory is None:
            return np.empty(shape, dtype)
        os.makedirs(directory, exist_ok=True)
        return np.lib.format.open_memmap(
            os.path.join(directory, f"leaf_{i:04d}.npy"),
            mode="w+", dtype=dtype, shape=tuple(shape))

    # ---- the paging surface -----------------------------------------------

    def gather(self, idx: np.ndarray) -> Any:
        """Copy the cohort rows ``idx`` (k,) out as contiguous (k, ...)
        arrays: the H2D staging source."""
        idx = np.asarray(idx)
        return tree_map(lambda leaf: np.ascontiguousarray(leaf[idx]),
                        self.tree)

    def scatter(self, idx: np.ndarray, rows: Any) -> None:
        """Write updated cohort rows back.  ``rows`` are numpy arrays or
        tensors, which may be on the card (then copied to the host here,
        a blocking D2H copy a leaf)."""
        idx = np.asarray(idx)

        def put(leaf, r):
            leaf[idx] = _host(r).astype(leaf.dtype, copy=False)
            return leaf

        tree_map(put, self.tree, rows)

    # ---- bookkeeping ------------------------------------------------------

    @property
    def nbytes(self) -> int:
        return sum(leaf.nbytes for leaf in leaves(self.tree))

    @property
    def bytes_per_client(self) -> int:
        return self.nbytes // max(self.n, 1)

    def flush(self) -> None:
        for leaf in leaves(self.tree):
            if isinstance(leaf, np.memmap):
                leaf.flush()

    def state_dict(self) -> Any:
        """Checkpoint payload: the full population rows + size."""
        return {"n": self.n, "tree": self.tree}

    def __repr__(self) -> str:
        backing = "memmap" if self.directory else "ram"
        return (f"ClientStateStore(n={self.n}, {backing}, "
                f"{self.nbytes / 2**20:.1f} MiB)")
