"""The uplink channel of the port's round engine.

Counterpart of `repro/fl/channel/__init__.py`: exact bit-level payload
accounting (`payload`), uplink compression codecs with error feedback
(`codecs`, whose QSGD and top-k run the channel's CUDA kernels on the
card) and per-client link profiles driving the clock (`link`).

    run_federated("ucfl_k2", fed, device="cuda",
                  channel=Channel(codec="qsgd:8", link="tiered:4"),
                  system=SYSTEMS["wireless_slow"])

With a `Channel` attached the engine also records `History.comm_bits`
(downlink/uplink bits per round) and, when a ``system`` is present,
drives the clock from the link profile instead of the homogeneous ρ/T_dl
constants.  ``Channel()`` — identity codec, uniform link — reproduces the
channel-less engine bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

from repro_torch.fl.channel.codecs import (BACKENDS, CODECS, Adaptive,
                                           AdaptiveTopK,
                                           BoundAdaptive, BoundAdaptiveTopK,
                                           Codec, Identity, QSGD, TopK,
                                           apply_uplink, get_codec,
                                           register_codec, uplink_roundtrip,
                                           zeros_like_stack)
from repro_torch.fl.channel.link import (LINK_FAMILIES, LinkProfile,
                                         get_link_profile,
                                         round_downlink_time)
from repro_torch.fl.channel.payload import (ChannelCost, dtype_bits,
                                            leaf_bits, stacked_ravel,
                                            stacked_unravel, tree_bits,
                                            tree_size)


@dataclass(frozen=True)
class Channel:
    """The engine-facing channel configuration.

    codec:           a `Codec` instance or spec string (``identity``,
                     ``qsgd:<bits>``, ``topk:<frac>``, ``adaptive...``).
    link:            a `LinkProfile`, a profile spec string (``uniform``,
                     ``tiered:<f>``, ``lognormal:<s>``), or None — None and
                     ``uniform`` both resolve to the `from_system` profile
                     that reproduces the channel-less clock exactly.
    error_feedback:  carry per-client EF residuals across rounds (exact
                     no-op under ``identity``).
    """
    codec: Union[str, Codec] = "identity"
    link: Union[str, LinkProfile, None] = None
    error_feedback: bool = True

    def __post_init__(self):
        object.__setattr__(self, "codec", get_codec(self.codec))
        if isinstance(self.link, str):
            # validate the family early; the profile itself needs (system,
            # ref_bits, m) and is resolved by the engine
            family = self.link.partition(":")[0]
            if family not in LINK_FAMILIES:
                raise ValueError(f"unknown link profile {self.link!r}; "
                                 f"families: {list(LINK_FAMILIES)}")

    def resolve_link(self, system, ref_bits: int, m: int) -> LinkProfile:
        spec = "uniform" if self.link is None else self.link
        return get_link_profile(spec, system, ref_bits, m)


def resolve_channel(channel: Union[str, Channel, None]
                    ) -> Optional[Channel]:
    """None -> None (no channel code path at all); a codec spec string ->
    ``Channel(codec=spec)``."""
    if channel is None or isinstance(channel, Channel):
        return channel
    return Channel(codec=channel)


__all__ = [
    "Adaptive", "AdaptiveTopK", "BoundAdaptive", "BoundAdaptiveTopK",
    "BACKENDS", "CODECS", "Channel", "ChannelCost", "Codec", "Identity",
    "LINK_FAMILIES", "LinkProfile", "QSGD", "TopK", "apply_uplink",
    "dtype_bits", "get_codec", "get_link_profile", "leaf_bits",
    "register_codec", "resolve_channel", "round_downlink_time",
    "stacked_ravel", "stacked_unravel", "tree_bits", "tree_size",
    "uplink_roundtrip", "zeros_like_stack",
]
