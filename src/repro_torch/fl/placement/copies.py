"""The paging engine's two copy legs between host and card.

The torch form of the reference's ``jax.device_put`` staging and
``jax.device_get`` writeback (`repro/fl/placement/base.py:stage`), which
rely on JAX's asynchronous dispatch.  Here both legs run on side CUDA
streams, so a cohort's rows cross the bus while the compute stream
replays a superstep:

    staged = stage_tree(rows, device)      # H2D begins on a side stream
    ...                                    # compute stream busy meanwhile
    rows = staged.wait()                   # compute stream waits its event
    fetched = fetch_tree(outs, device)     # D2D snapshot, D2H on a side stream
    host = fetched.wait()                  # host blocks on that copy alone

* `stage_tree` copies the host rows (numpy arrays or CPU tensors) into
  pinned host tensors and issues ``.to(device, non_blocking=True)`` on a
  side stream, recording an event.  `Staged.wait` makes the CURRENT
  stream wait on that event (the host does not block), clones the
  tensors there, and makes the side stream wait for the clones before
  the side stream's buffers are dropped: the caching allocator then
  hands that memory to no later side-stream copy before the compute
  stream has read it.  The `Staged` holds its pinned sources; once it
  is dropped, PyTorch's pinned-memory allocator, which records every
  non-blocking copy's event on the block, reuses them only after the
  copy is done.
* `fetch_tree` first clones its tensors on the current stream: a
  captured chunk returns its static buffers, which the next replay
  overwrites, so the snapshot is taken before anything else is enqueued
  there.  The clone's D2H copy into pinned buffers then runs on a second
  side stream behind an event; `Fetched.wait` blocks the host on that
  event only, so the writeback overlaps the next superstep.  The
  `Fetched` holds the snapshot until its `wait` has seen the copy end.

Neither leg calls ``record_stream``: a tensor it records is freed when
the allocator next finds its stream past the recorded point, so the
device memory in use at any moment would follow the streams' progress.
Without it every block is freed where the program drops it, and a run's
peak device memory is the same from one run to the next.

On the CPU both are plain: `stage_tree` wraps numpy rows with
``torch.from_numpy`` and `fetch_tree` hands its (fresh) tensors back.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.fl.placement.graphs import tree_map

# one H2D and one D2H side stream per device
_STREAMS: Dict[Tuple[int, str], torch.cuda.Stream] = {}


def _side_stream(device: torch.device, leg: str) -> torch.cuda.Stream:
    key = (torch.device(device).index or 0, leg)
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.Stream(device=device)
    return stream


def _host_tensor(a: Any) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


class Staged:
    """A tree on its way to the device; `wait` hands it to the current
    stream."""

    def __init__(self, tree: Any, event: Optional[torch.cuda.Event] = None,
                 device: Optional[torch.device] = None, source: Any = None,
                 side: Optional[torch.cuda.Stream] = None):
        self.tree, self.event, self.device = tree, event, device
        self.source = source        # the pinned host rows being copied
        self.side = side            # the stream that copied them

    def wait(self) -> Any:
        """The device tree, ordered after its copy on the current stream
        (no host block): the current stream's own clones of it."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.event)
            tree = tree_map(torch.clone, self.tree)
            done = torch.cuda.Event()
            done.record(stream)
            self.side.wait_event(done)
            self.tree, self.event = tree, None
        return self.tree


class Fetched:
    """A device tree's snapshot on its way to the host; `wait` blocks on
    that copy alone."""

    def __init__(self, tree: Any, event: Optional[torch.cuda.Event] = None,
                 snap: Any = None):
        self.tree, self.event = tree, event
        self.snap = snap            # the device snapshot being copied

    def wait(self) -> Any:
        """The host tree (pinned CPU tensors on the card's path)."""
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        self.snap = None
        return self.tree


def stage_tree(tree: Any, device: torch.device) -> Staged:
    """Begin the host -> ``device`` copy of ``tree`` (numpy arrays or CPU
    tensors); see the module docstring."""
    device = torch.device(device)
    if device.type != "cuda":
        return Staged(tree_map(lambda a: _host_tensor(a).to(device), tree))
    pinned = tree_map(lambda a: _host_tensor(a).pin_memory(), tree)
    side = _side_stream(device, "h2d")
    with torch.cuda.stream(side):
        out = tree_map(lambda t: t.to(device, non_blocking=True), pinned)
        event = torch.cuda.Event()
        event.record(side)
    return Staged(out, event, device, pinned, side)


def fetch_tree(tree: Any, device: torch.device) -> Fetched:
    """Snapshot ``tree`` (tensors on ``device``) and begin its copy to the
    host; see the module docstring."""
    device = torch.device(device)
    if device.type != "cuda":
        return Fetched(tree)
    compute = torch.cuda.current_stream(device)
    snap = tree_map(torch.clone, tree)
    side = _side_stream(device, "d2h")
    side.wait_stream(compute)
    with torch.cuda.stream(side):
        host = tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, pin_memory=True).copy_(
                t, non_blocking=True), snap)
        event = torch.cuda.Event()
        event.record(side)
    return Fetched(host, event, snap)
