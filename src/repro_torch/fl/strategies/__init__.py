"""Server-side aggregation strategies of the port.

Importing this package registers ``fedavg`` and ``ucfl`` / ``ucfl_k<k>``;
local, oracle, cfl, fedfomo and the client samplers come with later
slices.
"""
from repro_torch.fl.strategies.base import (CommCost, MixingExtras,
                                            RoundContext, Strategy,
                                            StrategyExtras)
from repro_torch.fl.strategies.registry import (STRATEGIES,
                                                available_strategies,
                                                get_strategy,
                                                get_strategy_class,
                                                parse_spec, register)
# importing the modules registers the algorithms
from repro_torch.fl.strategies.fedavg import FedAvg
from repro_torch.fl.strategies.ucfl import UCFL

__all__ = ["CommCost", "FedAvg", "MixingExtras", "RoundContext",
           "STRATEGIES", "Strategy", "StrategyExtras", "UCFL",
           "available_strategies", "get_strategy", "get_strategy_class",
           "parse_spec", "register"]
