"""Federated partitioning: the paper's three heterogeneity protocols
(§IV-A.1–3).

Counterpart of `repro/data/federated.py` (`FederatedData`,
`rotate_images`, `scenario_label_shift`, `scenario_covariate_shift`,
`scenario_concept_shift` and `SCENARIOS`).  The partitioners and the
label permutations are numpy in the reference (`default_rng(seed)`) and
are copied here; they pick indices on the host, and the images are
gathered on the device.  Stacked client arrays are (m, n_max, ...) plus
the true per-client sizes; invalid tail slots repeat valid samples
(sampling is by index mod n_i, so padding is never drawn more often).

Each scenario draws its base images from a `torch.Generator` seeded
with ``key``, or takes them given as ``data`` ({"x", "y"}: numpy arrays
or tensors, e.g. the reference's ``synthetic_*`` output), in which case
the result equals the reference's scenario on the same arrays.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.data.synthetic import synthetic_cifar, synthetic_emnist
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


def rotate_images(x: torch.Tensor, quarter_turns: int) -> torch.Tensor:
    """NHWC images (any leading dims) turned by ``quarter_turns`` · 90°
    in the (H, W) plane, as ``jnp.rot90(x, k, axes=(-3, -2))``."""
    return torch.rot90(x, quarter_turns, dims=(-3, -2))


def _base_data(data: Optional[Dict[str, Any]], draw, dev: torch.device
               ) -> Dict[str, torch.Tensor]:
    """The scenario's base {"x" f32, "y" int64} on ``dev``: ``data`` when
    given, else ``draw()``."""
    if data is None:
        return draw()
    as_t = lambda a, dt: torch.as_tensor(np.array(a) if not isinstance(
        a, torch.Tensor) else a).to(dev, dt)
    return {"x": as_t(data["x"], torch.float32),
            "y": as_t(data["y"], torch.int64)}


def _gather_clients(data: Dict[str, torch.Tensor], client_idx,
                    val_frac: float, dev: torch.device):
    """(x, y, n, x_val, y_val) of the padded client stack."""
    tr, va, ns = _stack_clients(client_idx, val_frac)
    tr_t = torch.as_tensor(tr, device=dev)
    va_t = torch.as_tensor(va, device=dev)
    x, y = data["x"], data["y"]
    return (x[tr_t], y[tr_t], torch.as_tensor(ns, device=dev), x[va_t],
            y[va_t])


def scenario_label_shift(key: int = 0, *, n: int = 10000, m: int = 20,
                         alpha: float = 0.4, n_classes: int = 47,
                         val_frac: float = 0.15, seed: int = 0,
                         data: Optional[Dict[str, Any]] = None,
                         device: DeviceLike = "cuda") -> FederatedData:
    """EMNIST-like, Dirichlet(0.4) label shift across 20 users.  ``key``
    seeds the torch generator of the images (the reference's PRNG key),
    ``seed`` the numpy partition, as in the reference."""
    dev = resolve_device(device)
    data = _base_data(data, lambda: synthetic_emnist(
        torch.Generator(device=dev).manual_seed(int(key)), n, n_classes),
        dev)
    rng = np.random.default_rng(seed)
    client_idx = _dirichlet_partition(rng, data["y"].cpu().numpy(), m,
                                      alpha, n_classes)
    x, y, ns, xv, yv = _gather_clients(data, client_idx, val_frac, dev)
    return FederatedData(x, y, ns, xv, yv,
                         torch.zeros((m,), dtype=torch.int64, device=dev))


def scenario_covariate_shift(key: int = 0, *, n: int = 20000, m: int = 40,
                             alpha: float = 0.4, n_classes: int = 47,
                             n_groups: int = 4, val_frac: float = 0.15,
                             seed: int = 1,
                             data: Optional[Dict[str, Any]] = None,
                             device: DeviceLike = "cuda") -> FederatedData:
    """EMNIST-like label shift + per-group rotations {0, 90, 180, 270}°
    (paper §IV-A.2; the paper uses n = 100k, m = 100, the reference
    scales it for the CPU with the same protocol)."""
    base = scenario_label_shift(key, n=n, m=m, alpha=alpha,
                                n_classes=n_classes, val_frac=val_frac,
                                seed=seed, data=data, device=device)
    turns = np.arange(m) % n_groups
    group = torch.as_tensor(turns, dtype=torch.int64, device=base.x.device)
    x = torch.stack([rotate_images(base.x[i], int(turns[i]))
                     for i in range(m)])
    xv = torch.stack([rotate_images(base.x_val[i], int(turns[i]))
                      for i in range(m)])
    return base._replace(x=x, x_val=xv, group=group)


def scenario_concept_shift(key: int = 0, *, n: int = 10000, m: int = 20,
                           n_classes: int = 10, n_groups: int = 4,
                           val_frac: float = 0.15, seed: int = 2,
                           data: Optional[Dict[str, Any]] = None,
                           device: DeviceLike = "cuda") -> FederatedData:
    """CIFAR-like, IID round-robin split, one random label permutation
    per group (paper §IV-A.3)."""
    dev = resolve_device(device)
    data = _base_data(data, lambda: synthetic_cifar(
        torch.Generator(device=dev).manual_seed(int(key)), n, n_classes),
        dev)
    rng = np.random.default_rng(seed)
    # IID split (concept shift only): round-robin
    order = rng.permutation(n)
    client_idx = [order[i::m].tolist() for i in range(m)]
    x, y, ns, xv, yv = _gather_clients(data, client_idx, val_frac, dev)
    groups = np.arange(m) % n_groups
    perms = np.stack([rng.permutation(n_classes) for _ in range(n_groups)])
    rows = torch.as_tensor(perms[groups], dtype=torch.int64, device=dev)
    y = torch.gather(rows, 1, y)
    yv = torch.gather(rows, 1, yv)
    return FederatedData(x, y, ns, xv, yv,
                         torch.as_tensor(groups, dtype=torch.int64,
                                         device=dev))


SCENARIOS = {
    "emnist_label_shift": scenario_label_shift,
    "emnist_covariate_shift": scenario_covariate_shift,
    "cifar_concept_shift": scenario_concept_shift,
}
