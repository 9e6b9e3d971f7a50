"""Client placement backends for the port's round engine.

`HostVmap` keeps every client stacked on one device; `MeshShardMap`
shards the clients over the ranks of a `torch.distributed` group and
mixes with collectives (`repro_torch.core.distributed`).
"""
from repro_torch.fl.placement.base import (Placement, resolve_placement,
                                           stack_params, where_clients)
from repro_torch.fl.placement.host import (ClientUpdate, HostVmap, evaluate,
                                           make_client_update, reduce_scores,
                                           score_stats)
from repro_torch.fl.placement.mesh import MeshShardMap

__all__ = ["ClientUpdate", "HostVmap", "MeshShardMap", "Placement",
           "evaluate", "make_client_update", "reduce_scores",
           "resolve_placement", "score_stats",
           "stack_params", "where_clients"]
