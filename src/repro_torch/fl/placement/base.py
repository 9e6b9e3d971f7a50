"""Placement protocol: where clients live and how their models move.

Counterpart of `repro/fl/placement/base.py`, with the hooks the round
engines use: build the local-update step, stack the common
initialization into the client-stacked dict, place the data, roll back
non-participants, run an async event's cohort update, pass the uplink
through the channel codec, apply a mixing matrix or a `StreamPlan`, and
evaluate the personalized models, move a paged cohort's rows between
host and card (`stage`, `fetch`), and place a hierarchy run's
device-partitioned data (`place_fleet`) or a stacked tree
(`place_stack`).  `rows` and `gather` move between every client's rows
and the rows this process holds: the identity on `HostVmap`, a rank's
shard and an all-gather on `MeshShardMap`.
Strategies route every mix through `RoundContext.mix` / `mix_plan`
(eventful) or `TracedMix` (fused), which dispatch here.

The fused superstep's hooks: `build_round` turns ``length`` rounds and
the chunk-end eval into one callable, a captured CUDA graph on the card
(`fl.placement.graphs`) and the same round function run eagerly in a
loop on the CPU; `run_supersteps` caches it by chunk length and input
shapes and runs one chunk.
"""
from __future__ import annotations

import abc
from typing import Any, Callable, ClassVar, Dict, Optional, Tuple

import torch
from torch.func import vmap

from repro_torch.core.streams import StreamPlan
from repro_torch.data.federated import FederatedData
from repro_torch.fl.placement.copies import (Fetched, Staged, fetch_tree,
                                             stage_tree)
from repro_torch.fl.placement.graphs import (CapturedChunk, StaticInputs,
                                             draw_row, leaves, stack_rows,
                                             tree_map, tree_spec)


def stack_params(params: Dict[str, torch.Tensor], m: int
                 ) -> Dict[str, torch.Tensor]:
    """Broadcast a single-model dict to the (m, ...) client stack."""
    return {k: v[None].expand((m,) + tuple(v.shape)).clone()
            for k, v in params.items()}


def where_clients(mask: torch.Tensor, new: Any, old: Any) -> Any:
    """Per-client select over stacked trees (leading dim m): nested dicts
    such as the optimizer state ``{"mu": {...} or None, "step": (m,)}``
    and tuples such as a hierarchy run's `EdgeState` keep their
    structure, None stays None."""
    if new is None:
        return None
    if isinstance(new, dict):
        return {k: where_clients(mask, a, old[k]) for k, a in new.items()}
    if isinstance(new, tuple):
        kids = [where_clients(mask, a, old[i]) for i, a in enumerate(new)]
        return type(new)(*kids) if hasattr(new, "_fields") else tuple(kids)
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new,
                       old)


@torch.no_grad()
def client_scores(acc_fn: Callable, stacked: Any, x_val: torch.Tensor,
                  y_val: torch.Tensor) -> torch.Tensor:
    """(m,) validation scores, client i's model on client i's data."""
    return vmap(lambda p, x, y: acc_fn(p, {"x": x, "y": y}))(
        stacked, x_val, y_val)


class Placement(abc.ABC):
    """One client-placement backend; see module docstring."""

    name: ClassVar[str]

    # the channel codecs' implementation on this backend: "pallas" (the
    # name the reference's files give its kernel path) runs the QSGD and
    # top-k threshold kernels, "jnp" the exact top-k mask of the
    # reference's mesh path (QSGD is the same kernels on both)
    codec_backend: ClassVar[str] = "pallas"

    @abc.abstractmethod
    def build_update(self, loss_fn: Callable, fl: Any) -> Tuple[Any, Callable]:
        """Returns ``(opt, update_fn)`` where ``update_fn(stacked, opt_state,
        x, y, n, idx) -> (stacked', opt_state')`` runs every client's local
        SGD on the minibatch slots ``idx`` (m, local_steps, batch_size),
        which ``update_fn.draw(draws, rnd, x, n)`` draws (`host.
        ClientUpdate`)."""

    @abc.abstractmethod
    def stack(self, params0: Dict[str, torch.Tensor], m: int) -> Any:
        """Place the common initialization as the (m, ...) client stack."""

    def init_opt(self, opt: Any, stacked: Any) -> Any:
        m = next(iter(stacked.values())).shape[0]
        return opt.init_stacked(stacked, m)

    def place_data(self, fed: FederatedData) -> Tuple[Any, Any, Any]:
        """Place the stacked client train arrays ``(x, y, n)``."""
        return fed.x, fed.y, fed.n

    def place_stack(self, tree: Any, m: int) -> Any:
        """Place an already-stacked (m, ...) tree on this backend (the
        serving plane's request batches and decoded stacks); `stack` is
        its broadcast-from-one-model sibling.  Default: the identity."""
        return tree

    # ---- the client axis: which rows this process holds --------------------

    def holds_clients(self, m: int) -> bool:
        """Whether this process holds any of ``m`` clients' rows (a mesh
        rank beyond the client axis holds none)."""
        return True

    def spans(self, m: int) -> bool:
        """Whether ``m`` clients' rows cover every process of the run,
        decided from what every process knows, without a collective (a
        mesh: whether its group for m is the whole world).  Default:
        True."""
        return True

    def share(self, value: Any) -> Any:
        """A result every holding process computed alike (a run's
        `History`, a served batch's output) on every process: a mesh rank
        that held no clients receives rank 0's.  Default: the
        identity."""
        return value

    def rows(self, tree: Any) -> Any:
        """This process's rows of a tree of (m·c, ...) leaves, every
        client's c rows together (a draw, a mask, the validation data).
        Default: all of them."""
        return tree

    def gather(self, tree: Any) -> Any:
        """Inverse of `rows`: every client's rows of a tree of this
        process's rows.  Default: the identity."""
        return tree

    def place_fleet(self, tree: Any, m: int, device: torch.device) -> Any:
        """Place device-partitioned (m, d_max, ...) fleet arrays (the
        hierarchy tier's nested device axis) on ``device``: dim 0 is the
        user axis.  Tensors already there pass through (the d_max = 1
        views of the flat data); numpy arrays are copied."""
        return tree_map(lambda a: torch.as_tensor(a).to(device), tree)

    def select(self, mask: torch.Tensor, new: Any, old: Any) -> Any:
        """Participation rollback: keep ``old`` where ``mask`` is False."""
        return where_clients(mask, new, old)

    def update_cohort(self, update_fn: Callable, idx: torch.Tensor,
                      keep: torch.Tensor, stacked: Any, opt_state: Any,
                      x: Any, y: Any, n: Any, batch_idx: torch.Tensor
                      ) -> Tuple[Any, Any]:
        """Run the local update for the cohort ``idx`` (k,) only, keeping
        the rows where ``keep`` (k,) is True; every other client row is
        untouched (the async runtime's per-event step).

        ``batch_idx`` is the step's draw for the event (``update_fn.
        draw``): every client's (m, S, B) minibatch slots, drawn for all m
        clients as a synchronous round draws them, where the reference
        takes the m per-client keys ``ckeys``, so a replayed run consumes
        the reference's ``ckeys[idx]`` exactly (a hierarchy run's
        `FleetDraws` likewise).  Default: run every slot of this
        process's rows and mask (the static-layout path; the mask and the
        draw are built for all m clients and cut by `rows`); `HostVmap`
        gathers the k rows instead."""
        m = leaves(batch_idx)[0].shape[0]
        mask = torch.zeros((m,), dtype=torch.bool, device=keep.device)
        mask[idx] = keep
        mask = self.rows(mask)
        upd, upd_opt = update_fn(stacked, opt_state, x, y, n,
                                 self.rows(batch_idx))
        return (self.select(mask, upd, stacked),
                self.select(mask, upd_opt, opt_state))

    def uplink(self, codec: Any, stacked: Any, prev: Any, ef: Any,
               noise: Optional[torch.Tensor],
               mask: Optional[torch.Tensor] = None) -> Tuple[Any, Any]:
        """Pass the participating clients' updates through the channel
        codec with error feedback: returns the server-side ``(stacked',
        ef')``.  Rows where ``mask`` is False are untouched; an identity
        codec returns the inputs unchanged."""
        from repro_torch.fl.channel import apply_uplink
        return apply_uplink(codec, stacked, prev, ef, noise, mask,
                            backend=self.codec_backend)

    @abc.abstractmethod
    def mix(self, stacked: Any, w: torch.Tensor) -> Any:
        """Apply a full per-client aggregation matrix ``w`` (m, m)."""

    @abc.abstractmethod
    def mix_plan(self, stacked: Any, plan: StreamPlan) -> Any:
        """Apply a k-stream `StreamPlan` (centroid mix + group broadcast)."""

    # ---- the paging engine's copy legs (`fl.placement.copies`) -------------

    def stage(self, tree: Any, m: int, device: torch.device) -> Staged:
        """Begin the host -> device copy of a gathered cohort tree of ``m``
        rows (numpy arrays or CPU tensors): the paging engine's H2D leg.
        Returns a `Staged`; its ``wait()`` gives the device tree, ordered
        after the copy on the current stream."""
        return stage_tree(tree, device)

    def fetch(self, tree: Any, device: torch.device) -> Fetched:
        """Snapshot a device tree (a captured chunk's static buffers
        included) and begin its copy to the host: the paging engine's D2H
        leg.  ``wait()`` gives the host tree."""
        return fetch_tree(tree, device)

    @abc.abstractmethod
    def evaluate(self, acc_fn: Callable, stacked: Any, fed: FederatedData
                 ) -> Tuple[float, float]:
        """(mean, worst) validation score across clients."""

    # ---- fused superstep --------------------------------------------------

    def mix_traced(self, stacked: Any, w: torch.Tensor) -> Any:
        """`mix` inside a fused round (default: `mix` itself, which reads
        nothing back to the host)."""
        return self.mix(stacked, w)

    def mix_plan_traced(self, stacked: Any, centroids: torch.Tensor,
                        assignment: torch.Tensor) -> Any:
        """`mix_plan` inside a fused round, the plan given as its two
        tensors."""
        return self.mix_plan(stacked, StreamPlan(centroids, assignment, None))

    def eval_traced(self, acc_fn: Callable, stacked: Any, x_val: Any,
                    y_val: Any) -> torch.Tensor:
        """Per-client validation scores (m,) on the device, the fused
        chunk-end eval: `client_scores`, as the eventful `evaluate`; the
        (mean, worst) reduction is the caller's (`host.score_stats`, on
        both engines, so they cannot drift)."""
        return client_scores(acc_fn, stacked, x_val, y_val)

    def build_round(self, round_fn: Callable, *, length: int,
                    eval_fn: Callable, inputs: Tuple,
                    cache: Dict) -> Callable:
        """``length`` consecutive rounds of ``round_fn(carry, data, consts,
        draw) -> (carry', outs)`` and ``eval_fn(carry'[0], eval_data)``,
        as ``fn(carry, data, consts, draws, eval_data) -> (carry', scores,
        outs)``, the rounds' ``outs`` stacked (`graphs.stack_rows`).
        On the card a `CapturedChunk` (its carry, data and consts buffers
        shared, through ``cache``, with the other chunk lengths of these
        shapes); on the CPU the same rounds run eagerly."""
        carry, data, consts, draws, eval_data = inputs
        if leaves(draws)[0].device.type == "cuda":
            key = ("statics", tree_spec((carry, data, consts, eval_data)))
            statics = cache.get(key)
            if statics is None:
                statics = cache[key] = StaticInputs(carry, data, consts,
                                                    eval_data)
            return CapturedChunk(round_fn, eval_fn, length, statics, inputs)

        def chunk(carry, data, consts, draws, eval_data):
            rows = []
            for i in range(length):
                carry, row = round_fn(carry, data, consts,
                                      draw_row(draws, i))
                rows.append(row)
            return carry, eval_fn(carry[0], eval_data), stack_rows(rows)

        return chunk

    def run_supersteps(self, round_fn: Callable, carry: Any, data: Any,
                       consts: Any, length: int, *, cache: Dict,
                       eval_fn: Callable, eval_data: Any,
                       draws: Any) -> Tuple[Any, torch.Tensor, Tuple]:
        """Run ``length`` fused rounds and the chunk-end eval, building
        (and caching in ``cache``, by length and input shapes) the chunk
        on first use.  ``draws`` holds the chunk's per-round draws stacked
        (length, ...).  Returns ``(carry', scores, outs)``; on the card
        all are the chunk's static buffers, overwritten by its next
        replay."""
        inputs = (carry, data, consts, draws, eval_data)
        key = (length, tree_spec(inputs))
        fn = cache.get(key)
        if fn is None:
            fn = cache[key] = self.build_round(
                round_fn, length=length, eval_fn=eval_fn, inputs=inputs,
                cache=cache)
        return fn(*inputs)

    def cache_key(self) -> Tuple:
        """Hashable identity for the superstep cache: two placements with
        equal keys build the same rounds."""
        return (type(self).__name__,)

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


def resolve_placement(placement: Optional[Placement]) -> Placement:
    """None -> the default `HostVmap` backend."""
    if placement is None:
        from repro_torch.fl.placement.host import HostVmap
        return HostVmap()
    return placement
