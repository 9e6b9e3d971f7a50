"""Fault injection and the resilient-runtime layer of the port.

Counterpart of `repro/fl/faults/__init__.py`: deterministic seeded
client failure models (crash, NaN, Byzantine scaling, bit-rot) injected
on the transmitted update; a screening + robust-aggregation defense
layer (`none | clip | trimmed_mean | median | krum`) routed through
quarantine reweighting so every strategy degrades gracefully; the async
retry/backoff loop; and run-level fault accounting in
``History.extra["faults"]``.  Everything is off by default.
"""
from repro_torch.fl.faults.config import (FaultConfig, FaultPlan,
                                          parse_fault_spec,
                                          resolve_fault_plan, resolve_faults)
from repro_torch.fl.faults.defense import (ROBUST_AGGS, RobustAggregator,
                                           get_robust_aggregator,
                                           register_robust,
                                           screen_and_defend)
from repro_torch.fl.faults.inject import crash_mask, inject_values
from repro_torch.fl.faults.runtime import FaultMeter, pop_with_retries

__all__ = ["FaultConfig", "FaultPlan", "parse_fault_spec",
           "resolve_fault_plan", "resolve_faults",
           "ROBUST_AGGS", "RobustAggregator", "get_robust_aggregator",
           "register_robust", "screen_and_defend",
           "crash_mask", "inject_values",
           "FaultMeter", "pop_with_retries"]
