"""Federated partitioning: the paper's label-shift protocol (§IV-A.1).

Counterpart of `repro/data/federated.py` (`FederatedData` and
`scenario_label_shift`).  The partitioners are numpy in the reference
and are copied here; they pick indices on the host, and the images are
gathered on the device.  Stacked client arrays are (m, n_max, ...) plus
the true per-client sizes; invalid tail slots repeat valid samples
(sampling is by index mod n_i, so padding is never drawn more often).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.data.synthetic import synthetic_emnist
from repro_torch.device import DeviceLike, resolve_device


class FederatedData(NamedTuple):
    x: torch.Tensor          # (m, n_max, H, W, C) float32
    y: torch.Tensor          # (m, n_max) int64
    n: torch.Tensor          # (m,) float32 true client dataset sizes
    x_val: torch.Tensor      # (m, n_val, H, W, C)
    y_val: torch.Tensor      # (m, n_val)
    group: torch.Tensor      # (m,) ground-truth cluster id (oracle baseline)

    @property
    def m(self) -> int:
        return self.x.shape[0]


def _dirichlet_partition(rng: np.random.Generator, labels: np.ndarray,
                         m: int, alpha: float, n_classes: int):
    """Class-wise proportional split: client weights ~ Dir(alpha) per class."""
    idx_by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    client_idx = [[] for _ in range(m)]
    for idxs in idx_by_class:
        rng.shuffle(idxs)
        w = rng.dirichlet([alpha] * m)
        cuts = (np.cumsum(w) * len(idxs)).astype(int)[:-1]
        for i, part in enumerate(np.split(idxs, cuts)):
            client_idx[i].extend(part.tolist())
    for ci in client_idx:
        rng.shuffle(ci)
    return client_idx


def _stack_clients(client_idx, val_frac: float):
    """The reference's padding rule as index arrays: (train (m, n_max),
    val (m, n_val), true train sizes (m,))."""
    # guarantee a minimum of 8 train + 4 val samples per client
    sizes = [max(len(ci), 12) for ci in client_idx]
    n_val = max(4, int(min(sizes) * val_frac))
    n_train = [max(s - n_val, 8) for s in sizes]
    n_max = max(n_train)
    tr_rows, va_rows, ns = [], [], []
    for ci, nt in zip(client_idx, n_train):
        ci = np.asarray(ci if len(ci) >= 12 else
                        np.resize(np.asarray(ci, int), 12), int)
        tr, va = ci[:nt], ci[nt:nt + n_val]
        if len(va) < n_val:
            va = np.resize(ci, n_val)
        tr_rows.append(np.resize(tr, n_max))    # repeat to n_max
        va_rows.append(va)
        ns.append(len(tr))
    return np.stack(tr_rows), np.stack(va_rows), np.array(ns, np.float32)


def scenario_label_shift(key: int = 0, *, n: int = 10000, m: int = 20,
                         alpha: float = 0.4, n_classes: int = 47,
                         val_frac: float = 0.15, seed: int = 0,
                         device: DeviceLike = "cuda") -> FederatedData:
    """EMNIST-like, Dirichlet(0.4) label shift across 20 users.  ``key``
    seeds the torch generator of the images (the reference's PRNG key),
    ``seed`` the numpy partition, as in the reference."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(key))
    data = synthetic_emnist(gen, n, n_classes)
    y_np = data["y"].cpu().numpy()
    rng = np.random.default_rng(seed)
    client_idx = _dirichlet_partition(rng, y_np, m, alpha, n_classes)
    tr, va, ns = _stack_clients(client_idx, val_frac)
    tr_t = torch.as_tensor(tr, device=dev)
    va_t = torch.as_tensor(va, device=dev)
    x, y = data["x"], data["y"]
    return FederatedData(x[tr_t], y[tr_t], torch.as_tensor(ns, device=dev),
                         x[va_t], y[va_t],
                         torch.zeros((m,), dtype=torch.int64, device=dev))
