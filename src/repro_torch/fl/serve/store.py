"""Per-user personalised-model delta store.

Counterpart of `repro/fl/serve/store.py`.  `run_federated(keep_state=True)`
ends with an (m, ...) client-stacked param dict, one personalised model
per user.  The store keeps instead

  * the k stream/cluster BASE models (one representative per stream of
    the strategy's client->stream map: the `MixingExtras` assignment, the
    CFL clusters, or a byte-level dedup of identical rows), flat (k, D);
  * one personalisation DELTA per user against the user's base, encoded
    at rest by a channel `Codec` (``identity | qsgd:<bits> |
    topk:<frac>``) in its row-gatherable format (`Codec.encode` /
    `decode`);

so its size rides the same exact bit accounting as the uplink
(`channel/payload.py`).  Reconstruction contract, checked at build time:

  * ``identity``: bit-exact.  ``fl(base + fl(x − base)) != x`` in
    general, so the delta is refined, and a sparse per-user fixup
    (value, index) catches the elements no single f32 delta reaches:
    reconstruction is ``fl(fl(base + delta) + fix)``.  The fixup's 64
    bits an entry ride the accounting;
  * lossy codecs: each user's max-abs error within the codec's bound
    (`Codec.store_bound`) plus 4 ulp of re-add slack; no fixup.

Tensors live on the store's device (``"cuda"`` unless the caller asks
for the CPU); ``assignment``, ``recon_err`` and ``template`` stay on the
host, numpy as in the reference (a bf16 template leaf, which numpy
lacks, is a CPU tensor of zeros).  An LM store's template is the
engine's flat-key view of the reference's scanned layout
(`models.scan.flat_params`); its file holds it re-nested
(`models.scan.nest_params`), as the reference's does.  The build runs
on that device: the refinement's f32 adds and subtracts are correctly
rounded there as in numpy, so the store's bits are the reference's.
``backend`` is the label of the file's codec backend: ``"pallas"`` (the
codecs' kernel path) or ``"jnp"`` (the reference's mesh path); `build`
takes it as the reference does, the placement's ``codec_backend``.  The
two encode and decode alike (`fl.channel.codecs`), so either package's
file of either backend loads, and `save` writes the label back as it
was loaded.

`save`/`load` go through `repro_torch.checkpoint` with the reference's
keys and types, so both packages write the same file for the same store.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl.channel import get_codec, stacked_ravel, stacked_unravel
from repro_torch.fl.channel.codecs import BACKENDS
from repro_torch.fl.channel.payload import tree_bits
from repro_torch.models.scan import flat_params, nest_params

_REFINE_ITERS = 8
# float re-add slack on top of the codec's own bound: reconstruction does
# two f32 roundings an element (encode-side subtract, decode-side add)
_ULP_SLACK = 4.0


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _host_zeros(shape, dtype: torch.dtype):
    """A template leaf: numpy zeros, or a CPU tensor where numpy has no
    such dtype (bf16)."""
    if dtype == torch.bfloat16:
        return torch.zeros(shape, dtype=dtype)
    return torch.zeros(shape, dtype=dtype).numpy()


@dataclass(frozen=True)
class StoreBits:
    """Exact at-rest size: k base models + m encoded deltas."""
    base_bits: int
    delta_bits: np.ndarray              # (m,) per-user encoded delta bits

    @property
    def total_bits(self) -> int:
        return int(self.base_bits) + int(self.delta_bits.sum())

    @property
    def total_bytes(self) -> int:
        return (self.total_bits + 7) // 8


class DeltaStore:
    """k base models + per-user codec-encoded deltas; see module docstring.

    Construct with `from_history`, `build` or `load`; the raw constructor
    takes already-validated pieces (tensors or arrays).
    """

    def __init__(self, *, base_flat, assignment, codec, payload, template,
                 recon_err, delta_bits, fix_values, fix_indices,
                 seed: int = 0, backend: str = "pallas",
                 device: DeviceLike = "cuda"):
        self.device = dev = resolve_device(device)
        if backend not in BACKENDS:
            raise ValueError(f"unknown codec backend {backend!r}; one of "
                             f"{BACKENDS}")
        self.backend = backend
        tensor = lambda v, dt=None: torch.as_tensor(v, dtype=dt, device=dev)
        self.base_flat = tensor(base_flat, torch.float32)       # (k, D)
        self.assignment = np.asarray(assignment, np.int64)      # (m,)
        self.codec = get_codec(codec)
        self.payload = {k: tensor(v) for k, v in payload.items()}
        self.template = template      # one model's dict of numpy zeros
        # sparse two-term fixup, (m, K) value/index pairs (K may be 0),
        # added after the base + delta add (module docstring)
        self.fix_values = tensor(fix_values, torch.float32)
        self.fix_indices = tensor(fix_indices, torch.int32)
        self.recon_err = np.asarray(recon_err, np.float64)      # (m,)
        self.seed = int(seed)
        # the codec's own bits apart, so save/load counts the fixup once
        self._delta_bits_raw = np.asarray(delta_bits, np.int64)
        fix_bits = 64 * np.count_nonzero(self.fix_values.cpu().numpy(),
                                         axis=1)
        self.bits = StoreBits(
            base_bits=self.k * tree_bits(template),
            delta_bits=self._delta_bits_raw + fix_bits)
        self._asn_dev = tensor(self.assignment)
        self._like = {k: (tuple(v.shape), _torch_dtype(v.dtype))
                      for k, v in template.items()}

    # ---- shape facts -------------------------------------------------------

    @property
    def m(self) -> int:
        return int(self.assignment.shape[0])

    @property
    def k(self) -> int:
        return int(self.base_flat.shape[0])

    @property
    def d(self) -> int:
        return int(self.base_flat.shape[1])

    def summary(self) -> Dict[str, Any]:
        return {"codec": self.codec.spec, "m": self.m, "k": self.k,
                "d": self.d, "base_bits": int(self.bits.base_bits),
                "delta_bits": int(self.bits.delta_bits.sum()),
                "total_bytes": int(self.bits.total_bytes),
                "max_recon_err": float(self.recon_err.max())}

    def resident_bytes(self) -> int:
        """Bytes the store's tensors hold on its device (the int32 qsgd
        levels count 4 bytes an element, against the accounted b bits)."""
        ts = [self.base_flat, self.fix_values, self.fix_indices,
              *self.payload.values()]
        return sum(t.numel() * t.element_size() for t in ts)

    # ---- reconstruction ----------------------------------------------------

    def unravel_batch(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, D) flat rows -> stacked param dict with leading B (views
        of ``flat`` where the dtype is f32)."""
        b = flat.shape[0]
        like = {k: torch.empty((b,) + shape, dtype=dt, device="meta")
                for k, (shape, dt) in self._like.items()}
        return stacked_unravel(flat, like)

    @staticmethod
    def apply_fix(flat: torch.Tensor, fix_values: torch.Tensor,
                  fix_indices: torch.Tensor) -> torch.Tensor:
        """Second term of the error-free reconstruction: add the sparse
        per-row fixups onto the already-added (rows, D) flat params.
        Padding entries are (0.0, 0): adding 0 is exact."""
        if fix_values.shape[1] == 0:
            return flat
        return flat.scatter_add(1, fix_indices.long(), fix_values)

    def params_flat(self, users: Optional[Sequence[int]] = None
                    ) -> torch.Tensor:
        """Decode the WHOLE store, then gather ``users``' rows: the
        reference path the serving engine's gather-then-decode is held
        against (`check_parity`)."""
        dec = self.codec.decode(self.payload, d=self.d)
        flat = self.base_flat.index_select(0, self._asn_dev) + dec
        flat = self.apply_fix(flat, self.fix_values, self.fix_indices)
        if users is None:
            return flat
        rows = torch.as_tensor(np.asarray(users, np.int64).ravel(),
                               device=self.device)
        return flat.index_select(0, rows)

    def params(self, users: Optional[Sequence[int]] = None
               ) -> Dict[str, torch.Tensor]:
        """Reconstructed personalised params as a stacked dict."""
        return self.unravel_batch(self.params_flat(users))

    # ---- construction ------------------------------------------------------

    @classmethod
    def from_history(cls, history, *, codec="identity", assignment=None,
                     link=None, seed: int = 0, noise: Optional[Any] = None,
                     backend: str = "pallas",
                     device: DeviceLike = "cuda") -> "DeltaStore":
        """Ingest a `run_federated(keep_state=True)` History.  The base
        assignment: explicit ``assignment``, else the strategy's extras
        (`MixingExtras.assignment`, `ClusterExtras.clusters`), else a
        byte-level dedup of identical param rows (stream members end the
        run with identical params, so the dedup recovers the plan)."""
        if history.final_params is None:
            raise ValueError(
                "history has no final_params — run "
                "run_federated(..., keep_state=True) to serve from it")
        if assignment is None:
            ex = history.extras
            assignment = getattr(ex, "assignment", None)
            if assignment is None:
                assignment = getattr(ex, "clusters", None)
        return cls.build(history.final_params, assignment=assignment,
                         codec=codec, link=link, seed=seed, noise=noise,
                         backend=backend, device=device)

    @classmethod
    def build(cls, final_params: Dict[str, Any], *, assignment=None,
              codec="identity", link=None, seed: int = 0,
              noise: Optional[Any] = None, backend: str = "pallas",
              device: DeviceLike = "cuda") -> "DeltaStore":
        """The store of ``final_params`` (an (m, ...) stacked dict of
        tensors or arrays), built on ``device``.  A codec that reads
        stochastic-rounding noise takes ``noise`` (m, D), else U[0, 1)
        from a `torch.Generator` on ``device`` seeded with ``seed``."""
        dev = resolve_device(device)
        codec = get_codec(codec)
        params = {k: torch.as_tensor(v, device=dev)
                  for k, v in final_params.items()}
        flat = stacked_ravel(params)
        m, d = flat.shape
        template = {k: _host_zeros(tuple(v.shape[1:]), v.dtype)
                    for k, v in params.items()}
        if link is not None:
            codec = codec.bind_link(link, template)

        if assignment is None:
            # identical rows share a stream: the dedup recovers the plan
            # where the strategy recorded none (fedavg => k=1, per-user
            # personalisation => k=m)
            _, assignment = np.unique(flat.cpu().numpy(), axis=0,
                                      return_inverse=True)
        asn = np.asarray(assignment, np.int64).ravel()
        if asn.shape != (m,):
            raise ValueError(f"assignment must be (m,)=({m},), got "
                             f"{asn.shape}")
        _, asn = np.unique(asn, return_inverse=True)   # labels -> 0..k-1
        asn = asn.ravel()
        k = int(asn.max()) + 1
        first = np.asarray([int(np.argmax(asn == j)) for j in range(k)])
        base = flat[torch.as_tensor(first, device=dev)]       # (k, D)
        base_rows = base[torch.as_tensor(asn, device=dev)]    # (m, D)

        delta = refined_delta(flat, base_rows)
        if noise is None and getattr(codec, "needs_noise", False):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
            noise = torch.rand((m, d), generator=gen, device=dev)
        elif noise is not None:
            if not isinstance(noise, torch.Tensor):
                noise = torch.from_numpy(np.array(noise, np.float32))
            noise = noise.to(device=dev, dtype=torch.float32)
        payload = codec.encode(delta, noise)
        recon = base_rows + codec.decode(payload, d=d)

        # identity only: the sparse second term of the error-free
        # reconstruction, for elements whose magnitude mismatches the
        # base so badly that no single f32 delta lands on them
        fix_values = torch.zeros((m, 0), dtype=torch.float32, device=dev)
        fix_indices = torch.zeros((m, 0), dtype=torch.int32, device=dev)
        if codec.is_identity and not torch.equal(recon, flat):
            lo = torch.zeros_like(flat)
            for _ in range(_REFINE_ITERS):
                v = recon + lo
                if torch.equal(v, flat):
                    break
                lo = lo + (flat - v)
            else:
                raise RuntimeError(
                    "identity fixup refinement did not converge in "
                    f"{_REFINE_ITERS} iterations — lossless reconstruction "
                    "contract cannot hold")
            fix_values, fix_indices = _sparse_rows(lo)
            recon = cls.apply_fix(recon, fix_values, fix_indices)

        recon_err = _row_max_abs_diff(recon, flat)

        bound = codec.store_bound(payload, d)
        if bound is not None:
            slack = _ULP_SLACK * np.spacing(
                flat.abs().amax(dim=1).cpu().numpy().astype(np.float64))
            if np.any(recon_err > bound + slack):
                worst = int(np.argmax(recon_err - bound))
                raise RuntimeError(
                    f"store reconstruction violates the {codec.spec!r} "
                    f"error bound: user {worst} err={recon_err[worst]:.3e} "
                    f"> bound={float(bound[worst]):.3e}")

        return cls(base_flat=base, assignment=asn, codec=codec,
                   payload=payload, template=template, recon_err=recon_err,
                   delta_bits=codec.per_client_bits(template, m),
                   fix_values=fix_values, fix_indices=fix_indices,
                   seed=seed, backend=backend, device=dev)

    # ---- persistence (repro_torch.checkpoint msgpack) ----------------------

    def save(self, path: str) -> None:
        checkpoint.save(path, {
            "version": 1,
            "codec": self.codec.spec,
            "backend": self.backend,
            "seed": self.seed,
            "assignment": self.assignment,
            "base_flat": self.base_flat,
            "payload": dict(self.payload),
            "template": nest_params(self.template),
            "recon_err": self.recon_err,
            "delta_bits": self._delta_bits_raw,
            "fix_values": self.fix_values,
            "fix_indices": self.fix_indices,
        })

    @classmethod
    def load(cls, path: str, device: DeviceLike = "cuda") -> "DeltaStore":
        """A saved store (either package's file) onto ``device``."""
        dev = resolve_device(device)
        t = checkpoint.restore(path, device="cpu")
        if t.get("version") != 1:
            raise ValueError(f"unknown DeltaStore version {t.get('version')}"
                             f" in {path}")
        host = lambda v: v.numpy()
        template = {k: v if v.dtype == torch.bfloat16 else host(v)
                    for k, v in flat_params(t["template"]).items()}
        return cls(base_flat=t["base_flat"],
                   assignment=host(t["assignment"]),
                   codec=t["codec"], payload=t["payload"],
                   template=template,
                   recon_err=host(t["recon_err"]),
                   delta_bits=host(t["delta_bits"]),
                   fix_values=t["fix_values"],
                   fix_indices=t["fix_indices"],
                   seed=int(t["seed"]), backend=t["backend"], device=dev)


def refined_delta(flat: torch.Tensor, base_rows: torch.Tensor
                  ) -> torch.Tensor:
    """The delta a store encodes: iterative refinement drives
    ``fl(base_rows + delta)`` as close to ``flat`` as one f32 add can get
    (the plain subtract is not enough)."""
    delta = flat - base_rows
    for _ in range(_REFINE_ITERS):
        r = base_rows + delta
        if torch.equal(r, flat):
            break
        delta = delta + (flat - r)
    return delta


def _row_max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
    """Per-row max |a − b| of two (m, D) f32 tensors, exact in float64,
    over blocks of rows of at most 2^26 elements: at an LM's D the float64
    copies of the whole (m, D) would take 6× its f32 bytes at once."""
    step = max(1, (1 << 26) // max(a.shape[1], 1))
    return torch.cat([
        (a[i:i + step].double() - b[i:i + step].double()).abs().amax(dim=1)
        for i in range(0, a.shape[0], step)]).cpu().numpy()


def _sparse_rows(lo: torch.Tensor):
    """The nonzero entries of each row of ``lo`` as (m, K) value / int32
    index pairs, indices ascending, K the largest row count, padded with
    (0.0, 0), as the reference lays them out."""
    mask = lo != 0
    counts = mask.sum(dim=1)
    nnz = int(counts.max())
    rows, cols = mask.nonzero(as_tuple=True)
    pos = (torch.arange(rows.numel(), device=lo.device)
           - (torch.cumsum(counts, 0) - counts)[rows])
    m = lo.shape[0]
    values = torch.zeros((m, nnz), dtype=lo.dtype, device=lo.device)
    indices = torch.zeros((m, nnz), dtype=torch.int32, device=lo.device)
    values[rows, pos] = lo[rows, cols]
    indices[rows, pos] = cols.to(torch.int32)
    return values, indices
