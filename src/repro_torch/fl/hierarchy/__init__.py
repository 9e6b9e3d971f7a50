"""Hierarchical edge-aggregation tier.

Counterpart of `repro/fl/hierarchy/`.  Each user owns a device fleet:
every engine round first runs an edge sub-round (per-device local
updates, device→user uplinks through the edge codec with error
feedback, `EdgeAggregator` weighting), and the resulting user
pseudo-update feeds the user→server round unchanged, so every registered
strategy runs two-level unmodified.

    run_federated("ucfl_k2", fed,
                  hierarchy=HierarchyConfig(devices_per_user="ragged:2-4",
                                            edge_link="tiered:4",
                                            edge_codec="qsgd:4"))

``hierarchy=HierarchyConfig(devices_per_user=1)`` (identity edge codec,
mean aggregator, zero latency) is bitwise the flat engine: the
flat-parity anchor.
"""
from repro_torch.fl.hierarchy.config import (HierarchyConfig,
                                             partition_fleet_data,
                                             resolve_fleet_spec,
                                             resolve_hierarchy)
from repro_torch.fl.hierarchy.edge import (EDGE_AGGREGATORS, DropStragglers,
                                           EdgeAggregator, EdgeState,
                                           FleetDraws, FleetUpdate, MeanEdge,
                                           build_fleet_update,
                                           cached_fleet_update,
                                           get_edge_aggregator,
                                           register_edge_aggregator)
from repro_torch.fl.hierarchy.meter import (EdgeMeter, FleetPlan, fleet_plan,
                                            init_fleet_run)

__all__ = [
    "EDGE_AGGREGATORS", "DropStragglers", "EdgeAggregator", "EdgeMeter",
    "EdgeState", "FleetDraws", "FleetPlan", "FleetUpdate", "HierarchyConfig",
    "MeanEdge", "build_fleet_update", "cached_fleet_update", "fleet_plan",
    "get_edge_aggregator", "init_fleet_run", "partition_fleet_data",
    "register_edge_aggregator", "resolve_fleet_spec", "resolve_hierarchy",
]
