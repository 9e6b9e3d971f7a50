"""A fused superstep chunk as one CUDA graph.

The torch form of the reference's compiled superstep (`jax.jit` of a
`lax.scan` over ``length`` rounds plus the chunk-end eval, with the carry
donated; `repro/fl/placement/base.py:build_round`).  On the card,
`CapturedChunk` captures the chunk once, with every input in a static
buffer, and replays it; the host then enqueues nothing between two eval
boundaries.

    chunk = CapturedChunk(round_fn, eval_fn, length, statics, inputs)
    carry, accs, outs = chunk(carry, data, consts, draws, eval_data)

* ``inputs`` are ``(carry, data, consts, draws, eval_data)``, nested
  dicts / tuples of tensors (None where a part is absent).  ``draws``
  holds a (length, ...) row per round: batch slots, the sampler's masks,
  the fault draws and the codec noise, taken on the host before the
  replay (`repro_torch.fl.draws.chunk_draws`), so the graph reads no
  generator.
* ``round_fn`` returns ``(carry', outs)``, ``outs`` a tuple of per-round
  tensors or None (a faulted run's crash and quarantine rows); the chunk
  returns them stacked (length, ...), in the graph's own output buffers
  beside the scores.
* ``statics`` (`StaticInputs`) holds the carry, data, consts and eval
  buffers, shared by the graphs of every chunk length of one run
  configuration: the graph updates the carry in place with in-graph
  ``copy_``, so the carry stays on the card from chunk to chunk.
* Before the capture, one round and the eval run on a side stream (the
  warm-up of PyTorch's CUDA-graph notes): the kernels are built, their
  attributes set and cuBLAS's workspaces made there, never under
  capture, and its freed memory goes back to the card before the
  capture.  Its launches are not counted; the capture's counts are set
  aside and each replay adds them (`kernels.ops.launches_set_aside`).
* A run that reads its carry and draws no more donates them
  (``donate``): the first capture takes them as its static buffers
  instead of copying them.
* A host sync inside the round (``.item()``, a host copy, a CPU tensor
  fed to the card) makes the capture raise.  Nothing falls back to an
  eager run.
"""
from __future__ import annotations

import time
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` on every tensor (or numpy array) of a nested dict / tuple /
    list, with the matching leaves of the same-structured trees ``rest``;
    None stays."""
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        kids = [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        return (type(tree)(*kids) if hasattr(tree, "_fields")
                else type(tree)(kids))
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_spec(tree: Any) -> Any:
    """Hashable structure, shapes, dtypes and devices of a tree."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return tuple((k, tree_spec(tree[k])) for k in sorted(tree))
    return tuple(tree_spec(t) for t in tree)


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors (or numpy arrays) of a tree (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [t for v in tree for t in leaves(v)]


def copy_into(dst: Any, src: Any) -> None:
    """dst[...] = src leaf by leaf (trees of one structure); a leaf that is
    its own destination is left alone."""
    for d, s in zip(leaves(dst), leaves(src), strict=True):
        if d is not s:
            d.copy_(s)


def draw_row(draws: Any, i: int) -> Any:
    """Round ``i``'s draws from the chunk's (length, ...) stacks."""
    return tree_map(lambda t: t[i], draws)


def stack_rows(outs: List[Tuple]) -> Tuple:
    """The rounds' ``outs`` tuples stacked field by field into (length,
    ...) tensors; a field that is None stays None."""
    return tuple(None if rows[0] is None else torch.stack(rows)
                 for rows in zip(*outs))


def adoptable(tree: Any) -> bool:
    """Whether a donated tree's tensors can serve as static buffers
    themselves: each contiguous, no two sharing storage."""
    ts = leaves(tree)
    ptrs = {t.untyped_storage().data_ptr() for t in ts}
    return len(ptrs) == len(ts) and all(t.is_contiguous() for t in ts)


class StaticInputs:
    """The static buffers of a chunk's carry, data, consts and eval data:
    fresh tensors of the example's shapes, shared by every captured chunk
    whose inputs have them.  A donated carry (the caller reads it no
    more) becomes the carry's buffers itself where `adoptable`, as the
    reference's jitted superstep donates its carry: at LM widths a second
    copy of the clients' params, optimizer state and residuals does not
    fit beside the round."""

    def __init__(self, carry: Any, data: Any, consts: Any, eval_data: Any,
                 donated: bool = False):
        empty = lambda t: torch.empty_like(
            t, memory_format=torch.contiguous_format)
        self.carry = (carry if donated and adoptable(carry)
                      else tree_map(empty, carry))
        self.data = tree_map(empty, data)
        self.consts = tree_map(empty, consts)
        self.eval_data = tree_map(empty, eval_data)

    def load(self, carry: Any, data: Any, consts: Any,
             eval_data: Any) -> None:
        """Copy the call's tensors in (the carry only where it is not the
        static carry itself, as it is from the second chunk on)."""
        copy_into(self.carry, carry)
        copy_into(self.data, data)
        copy_into(self.consts, consts)
        copy_into(self.eval_data, eval_data)


class CapturedChunk:
    """``length`` rounds of ``round_fn(carry, data, consts, draw) ->
    (carry', outs)`` and ``eval_fn(carry'[0], eval_data) -> (m,)
    scores``, captured as one CUDA graph on first use; see the module
    docstring.
    ``capture_s`` is the wall time of the warm-up and the capture,
    ``launches`` the kernel counts one replay adds.  ``donate``: the
    caller reads the first call's draws no more, and they become the
    draws' static buffers where `adoptable`."""

    def __init__(self, round_fn: Callable, eval_fn: Callable, length: int,
                 statics: StaticInputs, inputs: Tuple,
                 donate: bool = False):
        carry, data, consts, draws, eval_data = inputs
        # the graph reads tensors the functions hold (a bound codec's
        # constants): they live as long as it does
        self.round_fn, self.eval_fn = round_fn, eval_fn
        self.statics = statics
        self.length = int(length)
        self.draws = (draws if donate and adoptable(draws)
                      else tree_map(torch.empty_like, draws))
        statics.load(carry, data, consts, eval_data)
        copy_into(self.draws, draws)
        st = statics
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device=leaves(draws)[0].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), ops.launches_set_aside():
            warm, _ = round_fn(st.carry, st.data, st.consts,
                               draw_row(self.draws, 0))
            eval_fn(warm[0], st.eval_data)
            del warm
        torch.cuda.current_stream().wait_stream(side)
        # the warm-up's freed blocks go back to the card: the capture
        # allocates from its own pool, which cannot reuse them
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        self.graph = torch.cuda.CUDAGraph()
        with ops.launches_set_aside() as self.launches:
            with torch.cuda.graph(self.graph):
                out, rows = st.carry, []
                for i in range(self.length):
                    out, row = round_fn(out, st.data, st.consts,
                                        draw_row(self.draws, i))
                    rows.append(row)
                self.accs = eval_fn(out[0], st.eval_data)
                self.outs = stack_rows(rows)
                copy_into(st.carry, out)
                del out
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0

    def __call__(self, carry: Any, data: Any, consts: Any, draws: Any,
                 eval_data: Any) -> Tuple[Any, torch.Tensor, Tuple]:
        """Load the inputs, replay; returns the static carry (updated in
        place), the static (m,) scores and the stacked ``outs``, valid
        until the next replay."""
        self.statics.load(carry, data, consts, eval_data)
        copy_into(self.draws, draws)
        self.graph.replay()
        ops.add_launches(self.launches)
        return self.statics.carry, self.accs, self.outs
