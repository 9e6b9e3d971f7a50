"""The port's federated round engine (counterpart of `repro.fl`).

Exports every name of the reference's `repro.fl`, under the same name,
and the port's `TorchDraws` (the draws that stand for the reference's
key chain)."""
from repro_torch.fl.channel import (Channel, ChannelCost, Codec, LinkProfile,
                                    get_codec, get_link_profile, tree_bits)
from repro_torch.fl.comm import (SYSTEMS, WIRED, WIRELESS_FAST_UL,
                                 WIRELESS_SLOW_UL, SystemModel, downlink_cost,
                                 harmonic)
from repro_torch.fl.draws import TorchDraws
from repro_torch.fl.faults import (FaultConfig, FaultMeter, FaultPlan,
                                   RobustAggregator, get_robust_aggregator,
                                   parse_fault_spec, register_robust,
                                   resolve_fault_plan, resolve_faults)
from repro_torch.fl.hierarchy import (EdgeAggregator, EdgeMeter, EdgeState,
                                      HierarchyConfig, get_edge_aggregator,
                                      register_edge_aggregator,
                                      resolve_hierarchy)
from repro_torch.fl.placement import HostVmap, MeshShardMap, Placement
from repro_torch.fl.placement.host import evaluate
from repro_torch.fl.population import (ClientStateStore, CohortSchedule,
                                       FixedCohort, PagingConfig,
                                       RandomCohorts, SequentialSweep,
                                       run_async_paged, run_paged,
                                       sub_federated)
from repro_torch.fl.runtime import AsyncConfig, VirtualClock, run_async
from repro_torch.fl.serve import DeltaStore, ServeEngine, StoreBits, check_parity
from repro_torch.fl.simulator import (FLConfig, History, NonFiniteEvalWarning,
                                      run_federated, superstep_support)
from repro_torch.fl.stats import full_client_gradients, sigma2_estimates
from repro_torch.fl.strategies import (ClientSampler, ClusterExtras, CommCost,
                                       FullParticipation, MixingExtras,
                                       RoundContext, Strategy,
                                       StrategyExtras, UniformFraction,
                                       available_strategies, get_strategy,
                                       get_strategy_class, register)

__all__ = ["AsyncConfig", "available_strategies", "Channel", "ChannelCost",
           "check_parity", "ClientSampler", "ClientStateStore",
           "ClusterExtras", "Codec", "CohortSchedule", "CommCost",
           "DeltaStore", "downlink_cost", "EdgeAggregator", "EdgeMeter",
           "EdgeState", "evaluate", "FaultConfig", "FaultMeter", "FaultPlan",
           "FixedCohort", "FLConfig", "full_client_gradients",
           "FullParticipation", "get_codec", "get_edge_aggregator",
           "get_link_profile", "get_robust_aggregator", "get_strategy",
           "get_strategy_class", "harmonic", "HierarchyConfig", "History",
           "HostVmap", "LinkProfile", "MeshShardMap", "MixingExtras",
           "NonFiniteEvalWarning", "PagingConfig", "parse_fault_spec",
           "Placement", "RandomCohorts", "register",
           "register_edge_aggregator", "register_robust",
           "resolve_fault_plan", "resolve_faults", "resolve_hierarchy",
           "RobustAggregator", "RoundContext", "run_async",
           "run_async_paged", "run_federated", "run_paged",
           "SequentialSweep", "ServeEngine", "sigma2_estimates",
           "StoreBits", "Strategy", "StrategyExtras", "sub_federated",
           "superstep_support", "SystemModel", "SYSTEMS", "TorchDraws",
           "tree_bits", "UniformFraction", "VirtualClock", "WIRED",
           "WIRELESS_FAST_UL", "WIRELESS_SLOW_UL"]
