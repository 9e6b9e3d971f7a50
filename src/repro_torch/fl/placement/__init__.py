"""Client placement backends for the port's round engine.

`HostVmap` (all clients stacked on one device) is the one backend of this
slice; the mesh placement comes with its own slice.
"""
from repro_torch.fl.placement.base import (Placement, resolve_placement,
                                           stack_params, where_clients)
from repro_torch.fl.placement.host import (ClientUpdate, HostVmap, evaluate,
                                           reduce_scores, score_stats)

__all__ = ["ClientUpdate", "HostVmap", "Placement", "evaluate",
           "reduce_scores", "resolve_placement", "score_stats",
           "stack_params", "where_clients"]
