"""Server-side aggregation strategies of the port.

Importing this package registers ``fedavg``, ``local``, ``oracle`` and
``ucfl`` / ``ucfl_k<k>``, and exports the client samplers; cfl and
fedfomo come with a later slice.
"""
from repro_torch.fl.strategies.base import (CommCost, MixingExtras,
                                            RoundContext, Strategy,
                                            StrategyExtras, TracedMix)
from repro_torch.fl.strategies.registry import (STRATEGIES,
                                                available_strategies,
                                                get_strategy,
                                                get_strategy_class,
                                                parse_spec, register)
# importing the modules registers the algorithms
from repro_torch.fl.strategies.fedavg import FedAvg
from repro_torch.fl.strategies.local import Local
from repro_torch.fl.strategies.oracle import Oracle
from repro_torch.fl.strategies.sampling import (ClientSampler,
                                                FullParticipation,
                                                UniformFraction)
from repro_torch.fl.strategies.ucfl import UCFL

__all__ = ["ClientSampler", "CommCost", "FedAvg", "FullParticipation",
           "Local", "MixingExtras", "Oracle", "RoundContext", "STRATEGIES",
           "Strategy", "StrategyExtras", "TracedMix", "UCFL",
           "UniformFraction",
           "available_strategies", "get_strategy", "get_strategy_class",
           "parse_spec", "register"]
