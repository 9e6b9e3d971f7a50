"""Event-driven async federated runtime of the port.

Counterpart of `repro/fl/runtime/__init__.py`: `run_async` runs buffered
staleness-aware aggregation events over a `VirtualClock` instead of
bulk-synchronous rounds; `AsyncConfig` holds the buffer and staleness
knobs.  `run_federated(..., async_cfg=AsyncConfig(...))` delegates here,
so the sync and async engines share one call surface.
"""
from repro_torch.fl.runtime.clock import VirtualClock
from repro_torch.fl.runtime.engine import AsyncConfig, run_async

__all__ = ["AsyncConfig", "VirtualClock", "run_async"]
