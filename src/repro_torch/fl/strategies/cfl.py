"""Clustered FL (Sattler et al. 2020): per-cluster FedAvg plus a
hierarchical bipartition on the cosine similarity of client updates.

Counterpart of `repro/fl/strategies/cfl.py`.  The split decisions are
host-side numpy on the (m, D) client deltas, as in the reference: one
copy from the device a round, then the reference's arithmetic.  Its
state (the cluster assignment) changes between rounds, so it is not
traceable: the engine runs it on the eventful loop.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.mixing import groupwise_weights
from repro_torch.fl.channel.payload import stacked_ravel
from repro_torch.fl.strategies.base import (ClusterExtras, CommCost,
                                            RoundContext, Strategy)
from repro_torch.fl.strategies.registry import register


def _cosine_bipartition(d: np.ndarray) -> np.ndarray:
    norm = d / (np.linalg.norm(d, axis=1, keepdims=True) + 1e-9)
    sim = norm @ norm.T
    i, j = np.unravel_index(np.argmin(sim), sim.shape)
    return (sim[:, j] > sim[:, i]).astype(int)


@register
class CFL(Strategy):
    """State = the host-side (m,) cluster assignment, refined over rounds."""

    name = "cfl"
    reads_prev = True       # deltas = stacked − prev drive the bipartition

    def setup(self, ctx: RoundContext) -> np.ndarray:
        return np.zeros(ctx.fed.m, dtype=int)

    def aggregate(self, clusters: np.ndarray, stacked, prev,
                  ctx: RoundContext):
        fl = ctx.fl
        # the cluster statistics read every client's delta
        deltas = ctx.gather(stacked_ravel(
            {k: stacked[k] - prev[k] for k in stacked}))
        deltas = deltas.cpu().numpy()
        norms = np.linalg.norm(deltas, axis=1)
        # non-participants were rolled back to their pre-round params, so
        # their deltas are exactly zero: they must not vote on splits
        active = (np.ones(len(clusters), bool) if ctx.participation is None
                  else ctx.participation.cpu().numpy())
        new_clusters = clusters.copy()
        if ctx.rnd >= fl.cfl_min_rounds:
            for c in np.unique(clusters):
                idx = np.where((clusters == c) & active)[0]
                if len(idx) < 4:
                    continue
                mean_delta = deltas[idx].mean(0)
                if (np.linalg.norm(mean_delta)
                        < fl.cfl_eps1 * norms[idx].mean()
                        and norms[idx].max() > fl.cfl_eps2 * norms[idx].mean()):
                    sub = _cosine_bipartition(deltas[idx])
                    nxt = new_clusters.max() + 1
                    new_clusters[idx[sub == 1]] = nxt
        stacked = ctx.mix(stacked,
                          groupwise_weights(ctx.fed.n, new_clusters))
        return stacked, new_clusters

    def comm(self, clusters: np.ndarray) -> CommCost:
        return CommCost(int(clusters.max()) + 1, 0)

    def membership(self, clusters: np.ndarray) -> np.ndarray:
        return np.asarray(clusters, np.int64)

    def extras(self, clusters: np.ndarray) -> ClusterExtras:
        return ClusterExtras(clusters=clusters.copy())
