"""The port's federated round engine (counterpart of `repro.fl`)."""
from repro_torch.fl.channel import Channel, LinkProfile, get_codec
from repro_torch.fl.comm import SYSTEMS, SystemModel, harmonic
from repro_torch.fl.draws import TorchDraws
from repro_torch.fl.faults import (FaultConfig, FaultPlan,
                                   get_robust_aggregator, parse_fault_spec,
                                   resolve_fault_plan)
from repro_torch.fl.hierarchy import (EdgeAggregator, EdgeMeter, EdgeState,
                                      HierarchyConfig, get_edge_aggregator,
                                      register_edge_aggregator,
                                      resolve_hierarchy)
from repro_torch.fl.placement import HostVmap, MeshShardMap, Placement
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
from repro_torch.fl.strategies import (ClusterExtras, CommCost,
                                       FullParticipation, MixingExtras,
                                       RoundContext, Strategy,
                                       StrategyExtras, UniformFraction,
                                       available_strategies, get_strategy,
                                       register)

__all__ = ["AsyncConfig", "available_strategies", "Channel", "check_parity",
           "ClientStateStore", "ClusterExtras", "CohortSchedule",
           "CommCost", "DeltaStore", "EdgeAggregator", "EdgeMeter",
           "EdgeState", "FaultConfig", "FaultPlan", "FixedCohort",
           "FLConfig", "full_client_gradients", "FullParticipation",
           "get_codec", "get_edge_aggregator", "get_robust_aggregator",
           "get_strategy", "harmonic", "HierarchyConfig", "History",
           "HostVmap", "LinkProfile", "MeshShardMap", "MixingExtras",
           "NonFiniteEvalWarning", "PagingConfig", "parse_fault_spec",
           "Placement", "RandomCohorts", "register",
           "register_edge_aggregator", "resolve_fault_plan",
           "resolve_hierarchy", "RoundContext", "run_async",
           "run_async_paged", "run_federated", "run_paged",
           "SequentialSweep", "ServeEngine", "sigma2_estimates",
           "StoreBits", "Strategy", "StrategyExtras", "sub_federated",
           "superstep_support", "SystemModel", "SYSTEMS", "TorchDraws",
           "UniformFraction", "VirtualClock"]
