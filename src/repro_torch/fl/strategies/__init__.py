"""Server-side aggregation strategies of the port.

Counterpart of `repro/fl/strategies/__init__.py`.  Importing this package
registers the reference's seven algorithms:

    fedavg | local | oracle | ucfl | ucfl_k<k> | cfl | fedfomo

and exports the client samplers, the async runtime's staleness
reweighting and the quarantine reweighting of the defense layer.
"""
from repro_torch.fl.strategies.base import (ClusterExtras, CommCost,
                                            MixingExtras, RoundContext,
                                            Strategy, StrategyExtras,
                                            TracedMix, quarantine_reweight,
                                            staleness_factors,
                                            staleness_reweight)
from repro_torch.fl.strategies.registry import (STRATEGIES,
                                                available_strategies,
                                                get_strategy,
                                                get_strategy_class,
                                                parse_spec, register)
# importing the modules registers the algorithms
from repro_torch.fl.strategies.cfl import CFL
from repro_torch.fl.strategies.fedavg import FedAvg
from repro_torch.fl.strategies.fedfomo import FedFOMO
from repro_torch.fl.strategies.local import Local
from repro_torch.fl.strategies.oracle import Oracle
from repro_torch.fl.strategies.sampling import (ClientSampler,
                                                FullParticipation,
                                                UniformFraction)
from repro_torch.fl.strategies.ucfl import UCFL

__all__ = ["CFL", "ClientSampler", "ClusterExtras", "CommCost", "FedAvg",
           "FedFOMO", "FullParticipation", "Local", "MixingExtras", "Oracle",
           "RoundContext", "STRATEGIES", "Strategy", "StrategyExtras",
           "TracedMix", "UCFL", "UniformFraction",
           "available_strategies", "get_strategy", "get_strategy_class",
           "parse_spec", "quarantine_reweight", "register",
           "staleness_factors", "staleness_reweight"]
