"""The port's federated round engine (counterpart of `repro.fl`)."""
from repro_torch.fl.comm import SYSTEMS, SystemModel, harmonic
from repro_torch.fl.draws import TorchDraws
from repro_torch.fl.placement import HostVmap, Placement
from repro_torch.fl.simulator import (FLConfig, History, NonFiniteEvalWarning,
                                      run_federated)
from repro_torch.fl.stats import full_client_gradients, sigma2_estimates
from repro_torch.fl.strategies import (CommCost, MixingExtras, RoundContext,
                                       Strategy, StrategyExtras,
                                       available_strategies, get_strategy,
                                       register)

__all__ = ["CommCost", "FLConfig", "History", "HostVmap", "MixingExtras",
           "NonFiniteEvalWarning", "Placement", "RoundContext", "SYSTEMS",
           "Strategy", "StrategyExtras", "SystemModel", "TorchDraws",
           "available_strategies", "full_client_gradients", "get_strategy",
           "harmonic", "register", "run_federated", "sigma2_estimates"]
