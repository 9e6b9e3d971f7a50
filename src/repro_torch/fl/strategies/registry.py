"""Strategy registry + spec grammar.

Counterpart of `repro/fl/strategies/registry.py`.  Specs are
``<family>[_k<INT>]``: a bare registered family name (``"fedavg"``,
``"ucfl"``) or a family with a stream-count parameter (``"ucfl_k3"`` ->
``UCFL(k=3)``).  Keyword overrides win over parsed parameters.
"""
from __future__ import annotations

import inspect
import re
from typing import Dict, Tuple, Type

from repro_torch.fl.strategies.base import Strategy

STRATEGIES: Dict[str, Type[Strategy]] = {}

_SPEC_RE = re.compile(r"^(?P<family>[a-z][a-z0-9_]*?)_k(?P<k>\d+)$")


def register(cls: Type[Strategy]) -> Type[Strategy]:
    """Class decorator: add a Strategy subclass under ``cls.name``."""
    if not issubclass(cls, Strategy):
        raise TypeError(f"{cls!r} is not a Strategy subclass")
    STRATEGIES[cls.name] = cls
    return cls


def parse_spec(spec: str) -> Tuple[str, dict]:
    """``spec -> (family, kwargs)``; raises ValueError on unknown specs."""
    if spec in STRATEGIES:
        return spec, {}
    mt = _SPEC_RE.match(spec)
    if mt and mt.group("family") in STRATEGIES:
        family = mt.group("family")
        params = inspect.signature(STRATEGIES[family].__init__).parameters
        if "k" not in params:
            raise ValueError(
                f"strategy family {family!r} takes no _k parameter "
                f"(spec {spec!r})")
        return family, {"k": int(mt.group("k"))}
    raise ValueError(
        f"unknown strategy spec {spec!r}; registered families: "
        f"{sorted(STRATEGIES)} (grammar: <family>[_k<INT>])")


def get_strategy_class(spec: str) -> Type[Strategy]:
    family, _ = parse_spec(spec)
    return STRATEGIES[family]


def get_strategy(spec: str, **kwargs) -> Strategy:
    """Instantiate a registered strategy from its spec string."""
    family, parsed = parse_spec(spec)
    parsed.update(kwargs)
    return STRATEGIES[family](**parsed)


def available_strategies() -> Tuple[str, ...]:
    return tuple(sorted(STRATEGIES))
