"""Batched personalised-model serving engine.

Counterpart of `repro/fl/serve/engine.py`.  Request path, two stages a
batch:

  1. ``params_for(users)``: one gather of the users' base rows, encoded
     delta rows and fixup rows from the `DeltaStore` (`index_select`),
     decoded for just those B rows (`Codec.decode`: on the card the QSGD
     stream kernel for a qsgd store), re-added and unravelled to a
     (B, ...) stacked param dict;
  2. ``forward(params, xs)``: one ``torch.func.vmap(apply_fn)`` over the
     batch, shared by `serve` and `check_parity`.

``placement`` is where a batch runs: `HostVmap` (the default) on the
store's device; `MeshShardMap` hands each rank its rows of the batch
(`Placement.place_stack`), forwards them and all-gathers the outputs.
No jit cache and no CUDA graph: every stage runs eagerly.  The
micro-batcher (`submit`/`flush`) groups requests by the users' stream
assignment so a batch's base gather touches few distinct base models,
chunks to ``max_batch`` and returns outputs in submit order.  Its
contract, a request's output in a batch equal to it served alone, holds
bitwise on the CPU; on the card cuBLAS picks the forward's GEMM by the
batch count (a batch of one runs its unbatched GEMM), which sums in
another order: there a request's logits agree within an ulp or so of
the largest (on an H100), inside `check_parity`'s rtol 1e-5.

Parity anchor (`check_parity`): stage 2 is shared, so the served output
must equal a direct forward through `DeltaStore.params_flat`'s
(decode-everything-then-gather) reconstruction: bit-identical for the
``identity`` codec; for lossy codecs the reconstructed params of the two
paths within 8 ulps and the outputs within rtol 1e-5, the reference's
envelope for its two XLA fusion scopes.  Here both paths call the same
decode kernel, so they agree bitwise as a rule; the envelope is kept.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch.fl.channel import stacked_ravel
from repro_torch.fl.placement import resolve_placement
from repro_torch.fl.serve.store import DeltaStore


def _stack(xs: Sequence[Any], device: torch.device) -> torch.Tensor:
    """Request payloads (tensors or arrays) as one (B, ...) tensor."""
    if all(isinstance(x, torch.Tensor) for x in xs):
        return torch.stack([x.to(device) for x in xs])
    return torch.as_tensor(np.stack([np.asarray(x) for x in xs]),
                           device=device)


class ServeEngine:
    """Micro-batching request engine over one `DeltaStore`.

    ``apply_fn(params, x)`` -> output for ONE user's params and ONE
    request payload; the engine vmaps it over the batch.  Batches run on
    the store's device, on ``placement`` (`HostVmap` by default).
    """

    def __init__(self, store: DeltaStore, apply_fn: Callable, *,
                 placement=None, max_batch: int = 32):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.store = store
        self.apply_fn = apply_fn
        self.placement = resolve_placement(placement)
        self.max_batch = int(max_batch)
        self._forward = vmap(apply_fn)
        self._pending: List[Tuple[int, int, Any]] = []   # (ticket, user, x)
        self._tickets = 0
        self.last_stats: Dict[str, Any] = {}

    # ---- stage 1: batched gather + decode ----------------------------------

    def params_for(self, users: Sequence[int]) -> Dict[str, torch.Tensor]:
        """Personalised params for ``users`` as a (B, ...) stacked dict
        (the placement's rows of it): gather, then decode only the B
        requested delta rows."""
        store = self.store
        users_np = np.asarray(users, np.int64).ravel()
        # users and their base rows in one host-to-device copy
        idx = torch.as_tensor(
            np.stack([users_np, store.assignment[users_np]]),
            device=store.device)
        u, rows = idx[0], idx[1]
        base = store.base_flat.index_select(0, rows)            # (B, D)
        enc = {k: v.index_select(0, u) for k, v in store.payload.items()}
        flat = store.apply_fix(base + store.codec.decode(enc, d=store.d),
                               store.fix_values.index_select(0, u),
                               store.fix_indices.index_select(0, u))
        return self.placement.place_stack(store.unravel_batch(flat),
                                          users_np.shape[0])

    # ---- stage 2: one vmapped forward per batch -----------------------------

    @torch.no_grad()
    def forward(self, params: Dict[str, torch.Tensor], xs: torch.Tensor
                ) -> torch.Tensor:
        """``vmap(apply_fn)`` over the batch: the same function serves
        requests and the parity reference path."""
        return self._forward(params, xs)

    def _place_xs(self, xs: Any) -> torch.Tensor:
        return (xs.to(self.store.device) if isinstance(xs, torch.Tensor)
                else torch.as_tensor(np.asarray(xs), device=self.store.device))

    def run_batch(self, params: Dict[str, torch.Tensor], xs: Any,
                  b: int) -> torch.Tensor:
        """The forward of a batch of ``b`` whose params are already the
        placement's rows: this process's rows of ``xs``, the vmapped
        forward, every row's output gathered; a mesh rank that holds no
        rows of the batch receives rank 0's output."""
        pl = self.placement
        if not pl.holds_clients(b):
            return pl.share(None)
        out = self.forward(params, pl.place_stack(self._place_xs(xs), b))
        return pl.share(pl.gather(out))

    def serve(self, users: Sequence[int], xs: Any) -> torch.Tensor:
        """One batch end to end: params gather/decode + vmapped forward."""
        b = int(np.asarray(users).size)
        if not self.placement.holds_clients(b):
            return self.placement.share(None)
        return self.run_batch(self.params_for(users), xs, b)

    # ---- micro-batcher -----------------------------------------------------

    def submit(self, user: int, x: Any) -> int:
        """Queue one request; returns its ticket (its index in `flush`'s
        output list).  ``x`` may be a tensor (kept where it is) or an
        array."""
        t = self._tickets
        self._tickets += 1
        self._pending.append((t, int(user), x))
        return t

    def flush(self) -> List[np.ndarray]:
        """Serve every pending request: sort by (stream, user, ticket) so
        each batch gathers few distinct base rows, chunk to
        ``max_batch``, one gather + decode and one vmapped forward a
        chunk.  Returns numpy outputs in submit order; each chunk's wall
        latency (synchronised before it is read, as the reference's
        ``block_until_ready``) lands in `last_stats`."""
        pending, self._pending = self._pending, []
        self._tickets = 0
        if not pending:
            self.last_stats = {"requests": 0, "batches": 0, "latency_s": []}
            return []
        asn = self.store.assignment
        order = sorted(range(len(pending)),
                       key=lambda i: (asn[pending[i][1]], pending[i][1],
                                      pending[i][0]))
        outputs: List[Optional[np.ndarray]] = [None] * len(pending)
        latencies = []
        dev = self.store.device
        for lo in range(0, len(order), self.max_batch):
            chunk = [pending[i] for i in order[lo:lo + self.max_batch]]
            users = np.asarray([c[1] for c in chunk], np.int64)
            t0 = time.perf_counter()
            out = self.serve(users, _stack([c[2] for c in chunk], dev))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            latencies.append(time.perf_counter() - t0)
            out_np = out.cpu().numpy()
            for j, (ticket, _, _) in enumerate(chunk):
                outputs[ticket] = out_np[j]
        self.last_stats = {"requests": len(pending),
                           "batches": len(latencies),
                           "latency_s": latencies}
        return outputs                       # type: ignore[return-value]


# lossy codecs only: ulps of per-row param slack between the two decode
# paths, and the matching relative output tolerance (the reference's)
_PARITY_ULPS = 8.0
_PARITY_RTOL = 1e-5


def check_parity(engine: ServeEngine, users: Sequence[int], xs: Any,
                 served: Any = None) -> float:
    """The serving parity anchor: the engine's gather-then-decode output
    must equal a direct forward through the store's decode-everything
    reconstruction, bit-identical for the ``identity`` codec; for lossy
    codecs the two paths' reconstructed params within `_PARITY_ULPS` ulps
    and the outputs within `_PARITY_RTOL`.  Raises on divergence; returns
    max |served| as a liveness datum."""
    users_np = np.asarray(users, np.int64).ravel()
    b = users_np.shape[0]
    pl = engine.placement
    xs = engine._place_xs(xs)
    if served is None:
        served = engine.serve(users_np, xs)
    ref_flat = engine.store.params_flat(users_np)
    direct = engine.run_batch(
        pl.place_stack(engine.store.unravel_batch(ref_flat), b)
        if pl.holds_clients(b) else None, xs, b)
    served_np = (served.cpu().numpy() if isinstance(served, torch.Tensor)
                 else np.asarray(served))
    direct_np = direct.cpu().numpy()

    def fail(why: str):
        raise RuntimeError(
            "serving parity anchor violated: served output != direct "
            f"forward through reconstructed params ({why}; codec="
            f"{engine.store.codec.spec}, placement={pl!r})")

    if served_np.shape != direct_np.shape:
        fail(f"shape {served_np.shape} != {direct_np.shape}")
    exact = np.array_equal(served_np, direct_np)
    if engine.store.codec.is_identity:
        if not exact:
            bad = np.max(np.abs(served_np.astype(np.float64)
                                - direct_np.astype(np.float64)))
            fail(f"identity codec must be bit-identical, max|diff|={bad:.3e}")
    elif not exact:
        # both decode paths inside the same float-reassociation envelope?
        got = stacked_ravel(pl.gather(engine.params_for(users_np)))
        got = got.cpu().numpy()
        ref = ref_flat.cpu().numpy()
        # f32 ulps: one reassociated rounding moves a value by
        # spacing(max|row|) in f32 terms
        slack = _PARITY_ULPS * np.spacing(
            np.max(np.abs(ref), axis=1).astype(np.float32)).astype(np.float64)
        perr = np.max(np.abs(got.astype(np.float64)
                             - ref.astype(np.float64)), axis=1)
        if np.any(perr > slack):
            fail(f"two-path param divergence {perr.max():.3e} > "
                 f"{_PARITY_ULPS} ulp slack")
        oerr = np.max(np.abs(served_np.astype(np.float64)
                             - direct_np.astype(np.float64)))
        scale = max(float(np.max(np.abs(direct_np))), 1e-30)
        if oerr > _PARITY_RTOL * scale:
            fail(f"output divergence {oerr:.3e} > rtol {_PARITY_RTOL} "
                 f"of {scale:.3e}")
    return float(np.max(np.abs(served_np)))
