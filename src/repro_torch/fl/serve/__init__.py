"""Personalised-model serving plane (counterpart of `repro.fl.serve`).

`run_federated(keep_state=True)` trains one personalised model per user;
this package serves them: `DeltaStore` holds the k stream base models
plus per-user codec-compressed deltas with exact bit accounting, and
`ServeEngine` batches concurrent requests into one gather + decode +
vmapped forward a batch.

    h = run_federated("ucfl_k2", fed, keep_state=True)
    store = DeltaStore.from_history(h, codec="qsgd:4")
    engine = ServeEngine(store, apply_fn)
    engine.submit(user=3, x=x3); engine.submit(user=0, x=x0)
    y3, y0 = engine.flush()
"""
from __future__ import annotations

from repro_torch.fl.serve.engine import ServeEngine, check_parity
from repro_torch.fl.serve.store import DeltaStore, StoreBits

__all__ = ["DeltaStore", "ServeEngine", "StoreBits", "check_parity"]
