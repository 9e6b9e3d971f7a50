"""Personalized-stream reduction (paper §III-B).

Counterpart of `repro/core/streams.py` (`StreamPlan`, `kmeans`,
`silhouette_score`, `select_num_streams`): k-means over the rows of the
mixing matrix W; the k centroids become the personalized streams and
each client is served its cluster's centroid rule (group broadcast
instead of unicast).  The silhouette score over the rows guides the
choice of k, per the paper.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

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


def silhouette_score(rows: torch.Tensor, assignment: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Mean silhouette over samples (euclidean).  A sample alone in its
    cluster scores 0; an empty cluster is at distance 0, as in the
    reference."""
    x = rows.float()
    a_idx = assignment.long()
    d = torch.sqrt(torch.clamp(_pairwise_sq(x, x), min=0.0))   # (m, m)
    oh = F.one_hot(a_idx, k).float()                            # (m, k)
    counts = oh.sum(0)                                          # (k,)
    sums = d @ oh                                               # (m, k)
    own = counts[a_idx]
    a = torch.where(own > 1, sums.gather(1, a_idx[:, None])[:, 0]
                    / torch.clamp(own - 1, min=1.0),
                    torch.zeros_like(own))
    other = torch.where(oh > 0, torch.full_like(sums, float("inf")),
                        sums / torch.clamp(counts[None, :], min=1.0))
    b = other.min(dim=1).values
    s = torch.where((own > 1) & torch.isfinite(b),
                    (b - a) / torch.clamp(torch.maximum(a, b), min=1e-9),
                    torch.zeros_like(own))
    return s.mean()


def select_num_streams(rows: torch.Tensor,
                       candidates: Optional[Sequence[int]] = None, *,
                       first: Union[Sequence[int], torch.Generator,
                                    None] = None
                       ) -> Tuple[int, Dict[int, float]]:
    """Silhouette-guided choice of k (paper: silhouette over the w_i's):
    `kmeans` at each candidate (default ``(2, 3, 4, 6, 8)`` below m), the
    best k the first maximum, as Python's ``max`` over the dict gives.

    ``first`` is each candidate's k-means first centre (`kmeans`'s
    ``first``), the reference's ``randint(key, (), 0, m)`` injected: a
    sequence of row indices, one per candidate, or a `torch.Generator`
    to draw them from (default: one seeded with 0)."""
    m = rows.shape[0]
    if candidates is None:
        candidates = [k for k in (2, 3, 4, 6, 8) if k < m]
    candidates = list(candidates)
    if first is None:
        first = torch.Generator().manual_seed(0)
    if isinstance(first, torch.Generator):
        first = [int(torch.randint(0, m, (), generator=first))
                 for _ in candidates]
    if len(first) != len(candidates):
        raise ValueError(f"{len(first)} first centres for "
                         f"{len(candidates)} candidates")
    scores = {}
    for k, f in zip(candidates, first):
        plan = kmeans(rows, k, first=int(f))
        scores[k] = float(silhouette_score(rows, plan.assignment, k))
    best = max(scores, key=scores.get)
    return best, scores
