"""msgpack checkpointing for nested dict/list trees of tensors and arrays.

Counterpart of `repro/checkpoint/checkpoint.py`, byte for byte: a file
either package writes, the other restores bitwise.  The port packs its
msgpack with its own `_msgpack` module (no `msgpack` package needed).

Arrays are encoded as ``{"__nd__": {dtype, shape, data}}`` with numpy's
dtype names and the array's C-order bytes; scalars and strings pass
through.  `save` takes torch tensors on any device (one ``.cpu()`` a
leaf) and numpy arrays; a bf16 tensor is written as ``"bfloat16"`` with
its raw 2-byte words, which the reference reads through ``ml_dtypes``.
`restore` returns torch tensors on ``device`` (``"bfloat16"`` read back
through an int16 view).  NamedTuple leaves are not checkpointable by
design: persist params, optimizer state and metadata only.

Writes are atomic and verified: the payload lands in a process-unique
temp file, is flushed and fsynced, then `os.replace`d into place,
wrapped in a crc32 envelope (``ckpt-crc32-v1``) checked on every load;
a truncated or bit-flipped file raises `CheckpointCorruptError` instead
of restoring garbage.  Pre-envelope (bare-tree) files still load.
"""
from __future__ import annotations

import os
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.device import DeviceLike, resolve_device

# outer envelope around the encoded tree: {format, crc32, payload}.  The
# envelope is itself msgpack, so legacy (bare-tree) files are told apart
# by the format marker, not by parse failure.
_CKPT_MAGIC = "ckpt-crc32-v1"


class CheckpointCorruptError(Exception):
    """A checkpoint file failed its integrity check (truncated, bit-rotted
    or not msgpack at all): callers fall back to an older snapshot."""


def _nd(dtype: str, shape, data: bytes) -> dict:
    return {"__nd__": {"dtype": dtype, "shape": list(shape), "data": data}}


def _encode(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            # numpy has no bf16 of its own: the raw words, under the name
            # ml_dtypes registers
            return _nd("bfloat16", t.shape,
                       t.view(torch.int16).numpy().tobytes())
        obj = t.numpy()
    if isinstance(obj, np.ndarray):
        return _nd(str(obj.dtype), obj.shape, obj.tobytes())
    if isinstance(obj, dict):
        # sorted keys, as the reference's `jax.device_get` (a tree_map)
        # hands them to its packer: the two files are then the same bytes
        return {str(k): _encode(obj[k]) for k in sorted(obj)}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    raise TypeError(f"cannot checkpoint leaf of type {type(obj)}")


def _decode(obj: Any, dev: torch.device) -> Any:
    if isinstance(obj, dict):
        if "__nd__" in obj and set(obj) == {"__nd__"}:
            nd = obj["__nd__"]
            if nd["dtype"] == "bfloat16":
                words = np.frombuffer(nd["data"], dtype=np.int16)
                t = torch.from_numpy(words.reshape(nd["shape"]).copy())
                return t.view(torch.bfloat16).to(dev)
            arr = np.frombuffer(nd["data"], dtype=np.dtype(nd["dtype"]))
            return torch.from_numpy(arr.reshape(nd["shape"]).copy()).to(dev)
        return {k: _decode(v, dev) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v, dev) for v in obj]
    return obj


def save(path: str, tree: Any) -> None:
    """Verified atomic write: crc32 envelope, process-unique temp file,
    flush + fsync, then `os.replace`; a crash mid-save leaves either the
    old intact file or the new intact file, never a torn one."""
    payload = _msgpack.packb(_encode(tree))
    blob = _msgpack.packb({"format": _CKPT_MAGIC,
                           "crc32": zlib.crc32(payload),
                           "payload": payload})
    tmp = f"{path}.tmp.{os.getpid()}"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def restore(path: str, device: DeviceLike = "cuda") -> Any:
    """Load and integrity-check a checkpoint; arrays come back as tensors
    on ``device``.  Raises `CheckpointCorruptError` on a truncated or
    bit-rotted file; decodes legacy pre-envelope files (no checksum
    recorded) as they are."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        blob = f.read()
    try:
        outer = _msgpack.unpackb(blob)
    except ValueError as e:
        raise CheckpointCorruptError(
            f"{path}: not a readable msgpack checkpoint (truncated?): "
            f"{e}") from e
    if (isinstance(outer, dict) and outer.get("format") == _CKPT_MAGIC):
        payload = outer.get("payload")
        if not isinstance(payload, bytes):
            raise CheckpointCorruptError(f"{path}: envelope has no payload")
        crc = zlib.crc32(payload)
        if crc != outer.get("crc32"):
            raise CheckpointCorruptError(
                f"{path}: checksum mismatch (stored {outer.get('crc32')}, "
                f"computed {crc}) — the file is corrupt")
        try:
            tree = _msgpack.unpackb(payload)
        except ValueError as e:     # crc passed but payload won't parse
            raise CheckpointCorruptError(
                f"{path}: payload failed to decode: {e}") from e
        return _decode(tree, dev)
    return _decode(outer, dev)      # legacy pre-envelope checkpoint


def save_train_state(path: str, step: int, params: Any, opt_state: Any,
                     extra: Any = None) -> None:
    save(path, {"step": step, "params": params, "opt_state": opt_state,
                "extra": extra})


def restore_train_state(path: str, device: DeviceLike = "cuda"):
    t = restore(path, device)
    return t["step"], t["params"], t["opt_state"], t.get("extra")


# ---------------------------------------------------------------------------
# paged-run superstep snapshots: the paging engine writes one file per
# checkpointed superstep boundary (client-state store rows, engine carry
# and the History so far), so a preempted paged run resumes mid-sweep.

_PAGED_FORMAT = "paged-v1"
_PAGED_PREFIX = "superstep_"


def save_paged_state(directory: str, chunk: int, state: dict) -> str:
    """Atomic snapshot at superstep boundary ``chunk``; returns the path.
    ``state`` is the paging engine's plain-dict payload, kept schema-free
    here so this module never imports the engine."""
    path = os.path.join(directory, f"{_PAGED_PREFIX}{chunk:06d}.msgpack")
    save(path, dict(state, chunk=int(chunk), format=_PAGED_FORMAT))
    return path


def restore_paged_state(path: str, device: DeviceLike = "cuda") -> dict:
    t = restore(path, device)
    if t.get("format") != _PAGED_FORMAT:
        raise ValueError(f"{path} is not a {_PAGED_FORMAT} checkpoint "
                         f"(format={t.get('format')!r})")
    return t


def paged_checkpoints(directory: str) -> list:
    """Every superstep snapshot in ``directory``, NEWEST FIRST: the resume
    fallback chain (callers try each in turn, skipping ones that raise
    `CheckpointCorruptError`)."""
    if not os.path.isdir(directory):
        return []
    found = []
    for name in os.listdir(directory):
        if name.startswith(_PAGED_PREFIX) and name.endswith(".msgpack"):
            try:
                chunk = int(name[len(_PAGED_PREFIX):-len(".msgpack")])
            except ValueError:
                continue
            found.append((chunk, os.path.join(directory, name)))
    return [path for _, path in sorted(found, reverse=True)]


def latest_paged_checkpoint(directory: str):
    """Path of the highest-superstep snapshot in ``directory`` (resume
    entry point), or None when there is nothing to resume from."""
    chain = paged_checkpoints(directory)
    return chain[0] if chain else None
