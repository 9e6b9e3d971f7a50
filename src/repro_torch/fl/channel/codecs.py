"""Uplink compression codecs with error feedback.

Counterpart of `repro/fl/channel/codecs.py`.  A `Codec` is one lossy (or
identity) channel code for the client->server update payload; the
simulation never materializes packed bitstreams.  A codec exposes

  * ``roundtrip(flat, noise)`` — decode(encode(·)) on the (m, D)
    client-flat view: the values the SERVER sees.  Rows are independent
    clients.  ``noise`` is the (m, D) U[0, 1) stochastic-rounding noise,
    drawn by the caller (`fl.draws`) for a codec with ``needs_noise``,
    else None (the reference draws it from a key inside the codec).
  * ``payload_bits(tree)`` — exact wire bits for one client's payload of
    ``tree``'s size (per-element code bits + per-client side info).

Registered codecs (spec grammar ``<family>[:<param>[:<param>]]``):

  identity              lossless float passthrough (bit-parity anchor)
  qsgd:<bits>           signed stochastic uniform quantization, b ∈ [2, 8]:
                        d·b bits + one 32-bit per-client scale
  topk:<frac>           magnitude top-k, k = ⌈frac·d⌉: k · (32-bit value +
                        32-bit index)
  adaptive[:min[:max]]  per-client qsgd bits picked from the link profile
  adaptive_topk[:min[:max]]  per-client top-k counts from the link profile

`QSGD` and `TopK` run the channel kernels through `kernels.ops` (the
hand-written CUDA kernels on the card, their plain versions on the CPU),
as the reference's ``"pallas"`` backend does.  The reference's other
backend, ``"jnp"`` (`BACKENDS`; the mesh placement's), keeps its names
here: only top-k's ``roundtrip`` differs on it, keeping ``|x| >= kth``
with kth the exact k-th magnitude (``torch.topk``, the reference's
``topk_mask_ref``) instead of the threshold kernel's bisection.  QSGD
runs the same kernels on both (the reference states its jnp path is
bitwise its kernel path), and the at-rest encode and decode are one
path.  The bound adaptive codecs are plain torch on both devices,
as the reference's are on both of its backends.

At rest (the serving plane, `fl.serve`), a codec's payload is a dict of
row-aligned tensors (every value (m, ...)), so a store can gather a
request batch's rows and decode only those: ``encode(flat, noise)``,
``decode(payload, d)`` with ``decode(encode(x, u)) == roundtrip(x, u)``
bit for bit, and ``store_bound(payload, d)``, the per-row error bound
computed from the host-side payload.  QSGD keeps int32 levels and the
row absmax (one launch of the QSGD row pass to encode, one of the QSGD
stream to decode, on the card); top-k keeps the k largest-|x|
(value, index) pairs of a row in ``jax.lax.top_k``'s order.

Error feedback: the engine keeps a per-client residual stack e_i; each
round the codec transmits v = Δ + e and the new residual is
e' = v − decode(v), so everything the channel drops is retransmitted
later.  `uplink_roundtrip` owns that algebra.
"""
from __future__ import annotations

import abc
import math
from typing import Any, ClassVar, Dict, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.fl.channel.payload import (stacked_ravel, stacked_unravel,
                                            tree_bits, tree_size)
from repro_torch.fl.placement.base import where_clients
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flush_subnormal



def _host(v) -> np.ndarray:
    """A payload value (tensor or array) as a host numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class Codec(abc.ABC):
    """One uplink channel code; subclass + `@register_codec` to add."""

    name: ClassVar[str]
    is_identity: ClassVar[bool] = False
    # whether `roundtrip` reads stochastic-rounding noise (the engine
    # draws `draws.codec_noise` only then)
    needs_noise: ClassVar[bool] = False

    @property
    def spec(self) -> str:
        """Registry spec string that reconstructs this instance."""
        return self.name

    @abc.abstractmethod
    def payload_bits(self, tree: Any) -> int:
        """Exact uplink bits for ONE client's payload of ``tree``'s size."""

    @abc.abstractmethod
    def roundtrip(self, flat: torch.Tensor, noise: Optional[torch.Tensor],
                  *, backend: str = "pallas") -> torch.Tensor:
        """decode(encode(flat)) per row; (m, D) f32 -> (m, D) f32, on the
        codec ``backend`` (`BACKENDS`)."""

    # ---- at-rest format (the serving plane) -------------------------------
    # The default keeps the decoded dense values (identity, and any codec
    # without a compact residency).

    def encode(self, flat: torch.Tensor, noise: Optional[torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """(m, D) f32 -> payload dict of (m, ...) tensors."""
        return {"dense": self.roundtrip(flat, noise)}

    def decode(self, payload: Dict[str, torch.Tensor],
               d: Optional[int] = None) -> torch.Tensor:
        """Payload dict (rows possibly gathered) -> (m, D) f32 values.
        ``d`` is the dense width, needed by sparse payloads only."""
        return payload["dense"]

    def store_bound(self, payload: Dict[str, Any],
                    d: int) -> Optional[np.ndarray]:
        """(m,) float64 bound on each row's max |decode(encode(x)) − x|,
        from the payload alone (tensors or host arrays); None where the
        codec documents no bound."""
        return None

    def bind_link(self, link: Any, tree: Any) -> "Codec":
        """Specialize this codec to a resolved `LinkProfile` (the engine
        calls it from `init_channel`).  Fixed codecs return themselves;
        the adaptive ones return a bound instance with per-client
        parameters."""
        return self

    def per_client_bits(self, tree: Any, m: int) -> np.ndarray:
        """(m,) exact uplink bits per client (vector sibling of
        `payload_bits`; non-uniform only for link-bound adaptive codecs)."""
        return np.full(m, self.payload_bits(tree), dtype=np.int64)

    def __eq__(self, other) -> bool:
        return isinstance(other, Codec) and self.spec == other.spec

    def __hash__(self) -> int:
        return hash(self.spec)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.spec!r})"


CODECS: Dict[str, Type[Codec]] = {}
# the codec implementations, by the reference's names: "pallas" the
# kernels, "jnp" the mesh placement's (see the module docstring)
BACKENDS = ("pallas", "jnp")


def register_codec(cls: Type[Codec]) -> Type[Codec]:
    CODECS[cls.name] = cls
    return cls


@register_codec
class Identity(Codec):
    """Lossless passthrough: raw dtype bits; the engine skips the value
    path entirely (the bit-parity anchor)."""

    name = "identity"
    is_identity = True

    def payload_bits(self, tree: Any) -> int:
        return tree_bits(tree)

    def roundtrip(self, flat, noise, *, backend="pallas"):
        return flat

    def store_bound(self, payload, d):
        return np.zeros(payload["dense"].shape[0])    # lossless: exact


@register_codec
class QSGD(Codec):
    """Stochastic uniform quantization onto ``{-s..s}·scale`` per client,
    s = 2^(b−1) − 1, scale = max|x|/s.  Unbiased given the scale:
    E[roundtrip(x)] = x (stochastic rounding ``floor(y + u)``).  One
    kernel launch on the card: the QSGD row pass (absmax, levels, values)."""

    name = "qsgd"
    needs_noise = True

    def __init__(self, bits: int = 8):
        if not 2 <= int(bits) <= 8:
            raise ValueError(f"qsgd bits must be in [2, 8], got {bits}")
        self.bits = int(bits)

    @property
    def spec(self) -> str:
        return f"{self.name}:{self.bits}"

    def payload_bits(self, tree: Any) -> int:
        return tree_size(tree) * self.bits + 32     # + per-client scale

    def roundtrip(self, flat, noise, *, backend="pallas"):
        return ops.qsgd_roundtrip(flat, noise, bits=self.bits)

    def encode(self, flat, noise):
        """Int32 levels (m, D) and the row absmax (m, 1): the accounted b
        bits an element and 32-bit scale of `payload_bits`, kept resident
        as int32 (as the reference keeps them).  One row-pass launch on
        the card."""
        q, amax = ops.qsgd_quantize(flat, noise, bits=self.bits)
        return {"levels": q, "absmax": amax}

    def decode(self, payload, d=None):
        """One launch of the QSGD stream on the card."""
        return ops.qsgd_dequantize(payload["levels"], payload["absmax"],
                                   bits=self.bits)

    def store_bound(self, payload, d):
        # stochastic rounding moves an element at most one level:
        # |x − decode| <= scale_i = absmax_i / s
        s = float(2 ** (self.bits - 1) - 1)
        return _host(payload["absmax"])[:, 0].astype(np.float64) / s


@register_codec
class TopK(Codec):
    """Magnitude top-k sparsification: keep each client's coordinates at
    or above its k-th largest |x| (the threshold kernel's cutoff; ties
    all kept), zero the rest.  Biased — error feedback is what makes it
    converge (the residual carries the tail).  One kernel launch on the
    card."""

    name = "topk"

    def __init__(self, frac: float = 0.1):
        if not 0.0 < float(frac) <= 1.0:
            raise ValueError(f"topk frac must be in (0, 1], got {frac}")
        self.frac = float(frac)

    @property
    def spec(self) -> str:
        return f"{self.name}:{self.frac:g}"

    def k(self, d: int) -> int:
        return max(1, min(d, int(math.ceil(self.frac * d))))

    def payload_bits(self, tree: Any) -> int:
        return self.k(tree_size(tree)) * (32 + 32)  # (value, index) pairs

    def roundtrip(self, flat, noise, *, backend="pallas"):
        absx = flat.abs()
        k = self.k(flat.shape[1])
        if backend == "jnp":
            # the exact k-th magnitude (the reference's `topk_mask_ref`,
            # a `lax.top_k` outside any kernel); ties all kept
            thresh = torch.topk(absx, k, dim=1).values[:, -1:]
        else:
            thresh = ops.topk_threshold(absx, k=k)
        return torch.where(absx >= thresh, flat, torch.zeros_like(flat))

    def encode(self, flat, noise):
        """The k largest-|x| (value, index) pairs of each row, in
        ``jax.lax.top_k``'s order: descending magnitude, ties to the first
        index (a stable descending sort).  `roundtrip` keeps every tied
        coordinate; both drop nothing above the k-th magnitude, so they
        share the error bound."""
        k = self.k(flat.shape[1])
        idx = torch.sort(flat.abs(), dim=1, descending=True,
                         stable=True).indices[:, :k]
        return {"values": flat.gather(1, idx),
                "indices": idx.to(torch.int32)}

    def decode(self, payload, d=None):
        if d is None:
            raise ValueError("topk decode needs the dense width d")
        vals, idx = payload["values"], payload["indices"]
        # a row's indices are distinct, so the add is a set, but for a
        # -0.0 value (it lands as +0.0) and a subnormal one (0: the
        # reference's XLA scatter-add flushes it), as in the reference
        return torch.zeros((vals.shape[0], d), dtype=torch.float32,
                           device=vals.device).scatter_add_(
                               1, idx.long(), flush_subnormal(vals))

    def store_bound(self, payload, d):
        # every dropped coordinate is <= the k-th kept magnitude
        vals = np.abs(_host(payload["values"]).astype(np.float64))
        if vals.shape[1] >= d:
            return np.zeros(vals.shape[0])      # k == d keeps everything
        return np.min(vals, axis=1)


def _uplink_rate(link: Any) -> np.ndarray:
    """Uplink bits per T_dl of each client."""
    return np.asarray(link.dl_rate, np.float64) / np.asarray(link.ul_ratio,
                                                             np.float64)


@register_codec
class Adaptive(Codec):
    """Rate-adaptive uplink code: each client's qsgd bit width is picked
    from its `LinkProfile` so that EVERY upload fits the time budget of
    the slowest client sending the minimum spec.  Spec ``adaptive``
    (bits ∈ [2, 8]), ``adaptive:<min_bits>`` or
    ``adaptive:<min_bits>:<max_bits>``.  The engine runs the instance
    `bind_link` returns; an unbound adaptive codec's value path raises.
    On a uniform profile every client lands exactly on ``min_bits``."""

    name = "adaptive"

    def __init__(self, min_bits: int = 2, max_bits: int = 8):
        if not 2 <= int(min_bits) <= int(max_bits) <= 8:
            raise ValueError("adaptive bits must satisfy 2 <= min <= max "
                             f"<= 8, got [{min_bits}, {max_bits}]")
        self.min_bits = int(min_bits)
        self.max_bits = int(max_bits)

    @property
    def spec(self) -> str:
        if self.max_bits != 8:
            return f"{self.name}:{self.min_bits}:{self.max_bits}"
        if self.min_bits != 2:
            return f"{self.name}:{self.min_bits}"
        return self.name

    def payload_bits(self, tree: Any) -> int:
        raise RuntimeError("adaptive codec is link-dependent: the engine "
                           "binds it in init_channel; call "
                           "bind_link(link, tree) first")

    def roundtrip(self, flat, noise, *, backend="pallas"):
        raise RuntimeError("adaptive codec is link-dependent; "
                           "bind_link(link, tree) first")

    def bind_link(self, link: Any, tree: Any) -> "Codec":
        d = tree_size(tree)
        # the budget is the slowest client transmitting the minimum spec:
        # nobody is charged more than the fixed qsgd:<min_bits> round
        rate = _uplink_rate(link)
        budget = (d * self.min_bits + 32) / rate.min()
        bits = np.floor((budget * rate - 32.0) / d)
        bits = np.clip(bits, self.min_bits, self.max_bits).astype(np.int64)
        return BoundAdaptive(self.spec, bits, device=_tree_device(tree))


def _tree_device(tree: Any) -> torch.device:
    """The device of a model dict's leaves (where a bound codec keeps its
    per-client constants)."""
    return next(iter(tree.values())).device


class BoundAdaptive(Codec):
    """`Adaptive` specialized to one resolved link: a per-client qsgd bit
    vector, and its level counts as (m, 1) f32 constants on ``device``
    (made here, so a round copies nothing from the host).  Not registered
    — only `Adaptive.bind_link` constructs it."""

    name = "adaptive"
    needs_noise = True

    def __init__(self, spec: str, bits: np.ndarray, device="cpu"):
        self._spec = str(spec)
        self.bits = np.asarray(bits, np.int64)
        self._s = torch.tensor(2.0 ** (self.bits - 1) - 1.0,
                               dtype=torch.float32, device=device)[:, None]
        self._inv_s = self._s.reciprocal()

    @property
    def spec(self) -> str:
        return self._spec

    def payload_bits(self, tree: Any) -> int:
        """Scalar (downlink/broadcast) payload: the LARGEST assigned width;
        the per-client uplink truth is `per_client_bits`."""
        return tree_size(tree) * int(self.bits.max()) + 32

    def per_client_bits(self, tree: Any, m: int) -> np.ndarray:
        if m != self.bits.shape[0]:
            raise ValueError(f"bound for m={self.bits.shape[0]} clients, "
                             f"asked for {m}")
        return tree_size(tree) * self.bits + 32

    def roundtrip(self, flat, noise, *, backend="pallas"):
        """The plain QSGD arithmetic with the level count a per-row (m, 1)
        column (the kernels take one scalar level count), a subnormal
        element, absmax, scale or 1/scale flushed to 0 as in
        `ref.qsgd_quantize_ref`; rows whose width equals b match
        ``qsgd:<b>`` bit for bit."""
        s = self._s
        flat = flush_subnormal(flat)
        amax = flush_subnormal(flat.abs().amax(dim=1, keepdim=True))
        scale = flush_subnormal(amax * self._inv_s)
        inv = torch.where(scale > 0, flush_subnormal(scale.reciprocal()),
                          torch.zeros_like(scale))
        q = torch.minimum(torch.maximum(torch.floor(flat * inv + noise), -s),
                          s)
        return q * scale

    def __eq__(self, other) -> bool:
        return (isinstance(other, BoundAdaptive) and self._spec == other._spec
                and np.array_equal(self.bits, other.bits))

    def __hash__(self) -> int:
        return hash((self._spec, self.bits.tobytes()))

    def __repr__(self) -> str:
        return (f"BoundAdaptive({self._spec!r}, "
                f"bits=[{self.bits.min()}..{self.bits.max()}])")


@register_codec
class AdaptiveTopK(Codec):
    """Rate-adaptive top-k: each client's kept-coordinate count is picked
    from its `LinkProfile` so that every upload fits the time budget of
    the slowest client sending the minimum fraction.  Spec
    ``adaptive_topk`` (frac ∈ [0.05, 1]), ``adaptive_topk:<min_frac>`` or
    ``adaptive_topk:<min_frac>:<max_frac>``.  Run it with error feedback;
    the engine runs the instance `bind_link` returns."""

    name = "adaptive_topk"

    def __init__(self, min_frac: float = 0.05, max_frac: float = 1.0):
        if not 0.0 < float(min_frac) <= float(max_frac) <= 1.0:
            raise ValueError("adaptive_topk fracs must satisfy 0 < min <= "
                             f"max <= 1, got [{min_frac}, {max_frac}]")
        self.min_frac = float(min_frac)
        self.max_frac = float(max_frac)

    @property
    def spec(self) -> str:
        if self.max_frac != 1.0:
            return f"{self.name}:{self.min_frac:g}:{self.max_frac:g}"
        if self.min_frac != 0.05:
            return f"{self.name}:{self.min_frac:g}"
        return self.name

    def payload_bits(self, tree: Any) -> int:
        raise RuntimeError("adaptive_topk codec is link-dependent: the "
                           "engine binds it in init_channel; call "
                           "bind_link(link, tree) first")

    def roundtrip(self, flat, noise, *, backend="pallas"):
        raise RuntimeError("adaptive_topk codec is link-dependent; "
                           "bind_link(link, tree) first")

    def bind_link(self, link: Any, tree: Any) -> "Codec":
        d = tree_size(tree)
        k_of = lambda frac: max(1, min(d, int(math.ceil(frac * d))))
        k_min, k_max = k_of(self.min_frac), k_of(self.max_frac)
        rate = _uplink_rate(link)
        budget = (k_min * 64) / rate.min()
        ks = np.floor(budget * rate / 64.0)
        ks = np.clip(ks, k_min, k_max).astype(np.int64)
        return BoundAdaptiveTopK(self.spec, ks, device=_tree_device(tree))


class BoundAdaptiveTopK(Codec):
    """`AdaptiveTopK` specialized to one resolved link: a per-client
    kept-coordinate vector, with its sort positions (k − 1) as an (m, 1)
    int64 constant on ``device``.  Not registered."""

    name = "adaptive_topk"

    def __init__(self, spec: str, ks: np.ndarray, device="cpu"):
        self._spec = str(spec)
        self.ks = np.asarray(ks, np.int64)
        self._cols = torch.tensor(self.ks - 1, device=device)[:, None]

    @property
    def spec(self) -> str:
        return self._spec

    def payload_bits(self, tree: Any) -> int:
        """Scalar (downlink/broadcast) payload: the LARGEST assigned k."""
        return int(self.ks.max()) * (32 + 32)

    def per_client_bits(self, tree: Any, m: int) -> np.ndarray:
        if m != self.ks.shape[0]:
            raise ValueError(f"bound for m={self.ks.shape[0]} clients, "
                             f"asked for {m}")
        return self.ks * (32 + 32)

    def roundtrip(self, flat, noise, *, backend="pallas"):
        """Per-row k-th-magnitude threshold from a descending sort (ties at
        the threshold all kept), plain torch: the kernel takes one k."""
        a = flat.abs()
        srt = torch.sort(a, dim=1, descending=True).values
        thr = srt.gather(1, self._cols)
        return torch.where(a >= thr, flat, torch.zeros_like(flat))

    def __eq__(self, other) -> bool:
        return (isinstance(other, BoundAdaptiveTopK)
                and self._spec == other._spec
                and np.array_equal(self.ks, other.ks))

    def __hash__(self) -> int:
        return hash((self._spec, self.ks.tobytes()))

    def __repr__(self) -> str:
        return (f"BoundAdaptiveTopK({self._spec!r}, "
                f"ks=[{self.ks.min()}..{self.ks.max()}])")


def get_codec(spec) -> Codec:
    """``"identity" | "qsgd:<bits>" | "topk:<frac>" | "adaptive[:<min>
    [:<max>]]" | "adaptive_topk[:<min>[:<max>]]"`` -> Codec instance
    (instances pass through)."""
    if isinstance(spec, Codec):
        return spec
    family, _, param = str(spec).partition(":")
    cls = CODECS.get(family)
    if cls is None:
        raise ValueError(f"unknown codec {spec!r}; families: "
                         f"{sorted(CODECS)}")
    if not param:
        return cls()
    conv = int if family in ("qsgd", "adaptive") else float
    try:
        args = [conv(p) for p in param.split(":")]
    except ValueError:
        raise ValueError(f"bad codec parameter in {spec!r}") from None
    try:
        return cls(*args)
    except TypeError:
        raise ValueError(f"too many parameters in {spec!r}") from None


# ---------------------------------------------------------------------------
# error-feedback uplink (engine entry point)


def uplink_roundtrip(codec: Codec, stacked: Dict[str, torch.Tensor],
                     prev: Dict[str, torch.Tensor],
                     ef: Dict[str, torch.Tensor],
                     noise: Optional[torch.Tensor],
                     mask: Optional[torch.Tensor], *,
                     backend: str = "pallas") -> Tuple[Any, Any]:
    """The EF uplink algebra: transmit v = Δ + e, return
    ``(prev + decode(v), v − decode(v))`` with non-participant rows
    untouched.  ``noise`` (m, D) feeds the codec's stochastic rounding in
    the flat view's column order (sorted keys)."""
    v = {k: (stacked[k] - prev[k]) + ef[k] for k in stacked}
    dec = stacked_unravel(codec.roundtrip(stacked_ravel(v), noise,
                                          backend=backend), v)
    new_ef = {k: v[k] - dec[k] for k in v}
    # residuals ride in f32; the model stack keeps its own dtype
    new_stacked = {k: (p + dec[k]).to(p.dtype) for k, p in prev.items()}
    if mask is not None:
        # non-participants transmitted nothing: model and residual rows
        # stay exactly as they were
        new_stacked = where_clients(mask, new_stacked, stacked)
        new_ef = where_clients(mask, new_ef, ef)
    return new_stacked, new_ef


def apply_uplink(codec: Codec, stacked: Any, prev: Any, ef: Any,
                 noise: Optional[torch.Tensor],
                 mask: Optional[torch.Tensor] = None, *,
                 backend: str = "pallas") -> Tuple[Any, Any]:
    """One uplink crossing with error feedback: ``stacked``/``prev`` are
    the post-/pre-update client stacks, ``ef`` the residual stack; returns
    the server-side models and the carried-forward residuals.  Rows where
    ``mask`` is False are untouched; an identity codec returns its inputs
    unchanged.  ``backend`` is the placement's `codec_backend`."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown codec backend {backend!r}; one of "
                         f"{BACKENDS}")
    if codec.is_identity:
        return stacked, ef
    return uplink_roundtrip(codec, stacked, prev, ef, noise, mask,
                            backend=backend)


def zeros_like_stack(stacked: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Fresh all-zero error-feedback residual stack shaped like
    ``stacked`` (f32 whatever the model dtype)."""
    return {k: torch.zeros(l.shape, dtype=torch.float32, device=l.device)
            for k, l in stacked.items()}
