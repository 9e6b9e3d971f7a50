"""Personalized-stream reduction (paper §III-B).

Counterpart of `repro/core/streams.py` (`StreamPlan`, `kmeans`): k-means
over the rows of the mixing matrix W; the k centroids become the
personalized streams and each client is served its cluster's centroid
rule (group broadcast instead of unicast).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class StreamPlan(NamedTuple):
    centroids: torch.Tensor     # (k, m) — the Ŵ aggregation rules
    assignment: torch.Tensor    # (m,) int64 — client -> stream
    inertia: torch.Tensor       # scalar, final k-means objective


def _pairwise_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
            - 2.0 * a @ b.T)


def kmeans(rows: torch.Tensor, k: int, *, first: int, n_iter: int = 50,
           drop_diag: bool = True) -> StreamPlan:
    """Lloyd's algorithm with farthest-point seeding from row ``first``.

    ``first`` is the reference's ``jax.random.randint(key, (), 0, m)``
    draw, injected (see `fl.draws`).  With ``drop_diag`` the clustering
    runs on the off-diagonal collaboration profile (diagonal zeroed, rows
    renormalized); centroids are then re-fit as the mean of the ORIGINAL
    rows per cluster and renormalized to stay aggregation rules.  Ties
    break on the first index, as in the reference (`argmin`/`argmax`).
    """
    m = rows.shape[0]
    k = int(min(k, m))
    raw = rows.float()
    if drop_diag and m > 1 and rows.shape[0] == rows.shape[1]:
        x = raw * (1.0 - torch.eye(m, device=rows.device))
        x = x / torch.clamp(x.sum(1, keepdim=True), min=1e-9)
    else:
        x = raw

    centers = [x[int(first)]]
    for _ in range(1, k):
        d = _pairwise_sq(x, torch.stack(centers)).min(dim=1).values
        centers.append(x[torch.argmax(d)])     # farthest point
    cents = torch.stack(centers)

    for _ in range(n_iter):
        assign = torch.argmin(_pairwise_sq(x, cents), dim=1)
        oh = F.one_hot(assign, k).float()                  # (m, k)
        hits = oh.sum(0)
        new = (oh.T @ x) / torch.clamp(hits, min=1.0)[:, None]
        cents = torch.where((hits > 0)[:, None], new, cents)  # keep empties

    d = _pairwise_sq(x, cents)
    assign = torch.argmin(d, dim=1)
    inertia = d.min(dim=1).values.sum()
    oh = F.one_hot(assign, k).float()
    cents = (oh.T @ raw) / torch.clamp(oh.sum(0), min=1.0)[:, None]
    cents = cents / torch.clamp(cents.sum(1, keepdim=True), min=1e-9)
    return StreamPlan(cents, assign, inertia)
