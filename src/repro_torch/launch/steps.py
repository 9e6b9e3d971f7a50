"""Step builders: the parts of the LM training path that `launch/train.py`
runs.

Counterpart of `repro/launch/steps.py`'s `_use_scan`, `_loss_fn`,
`init_model_params`, `init_stacked_params` and `make_optimizer`.  The
reference's mesh case builders
(`build_train_step`, `build_train_case`, `build_prefill_case`,
`build_decode_case`, `build_case`) lower one federated round or one
serving step onto a 256- or 512-chip TPU mesh through
`launch/{mesh,sharding}.py`; they raise here, naming ROADMAP.md Queue 1
item 18, the chip-planning modules.  The round engine runs the port's
federated training (`repro_torch.fl.run_federated`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import scan as scan_mod
from repro_torch.models import transformer as T
from repro_torch.optim import sgd

ITEM_18 = ("the mesh case builders need launch/{mesh,sharding}.py: not "
           "ported yet, ROADMAP.md Queue 1 item 18")


def _use_scan(cfg: ModelConfig) -> bool:
    return cfg.family != "audio"


def _loss_fn(cfg: ModelConfig, *, remat: bool) -> Callable:
    """(params, batch) -> (loss, metrics) over the layout
    `init_model_params` gives."""
    if _use_scan(cfg):
        return lambda p, b: scan_mod.loss_fn(p, cfg, b, remat=remat)
    return lambda p, b: T.loss_fn(p, cfg, b)


def init_model_params(gen: torch.Generator, cfg: ModelConfig
                      ) -> Dict[str, Any]:
    """Single-model params on ``gen.device``, in the scanned layout when
    applicable."""
    params = T.init_params(gen, cfg, device=gen.device)
    if _use_scan(cfg):
        params = scan_mod.stack_layer_params(params, cfg)
    return params


def _stack(tree: Any, m: int) -> Any:
    if isinstance(tree, dict):
        return {k: _stack(v, m) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stack(v, m) for v in tree)
    return tree[None].expand((m,) + tuple(tree.shape)).clone()


def init_stacked_params(gen: torch.Generator, cfg: ModelConfig, m: int
                        ) -> Dict[str, Any]:
    """Client-stacked params: every leaf gains a leading (m,) dim."""
    return _stack(init_model_params(gen, cfg), m)


def make_optimizer(cfg: ModelConfig):
    """The paper's optimizer (SGD η = 0.1, β = 0.9, momentum in the param
    dtype); a config whose clients span a pod drops momentum."""
    if cfg.fl_client_axis == "pod":
        return sgd(0.1, momentum=0.0)
    return sgd(0.1, momentum=0.9, state_dtype="param")


def build_train_step(*args, **kwargs):
    raise NotImplementedError(ITEM_18)


def build_train_case(*args, **kwargs):
    raise NotImplementedError(ITEM_18)


def build_prefill_case(*args, **kwargs):
    raise NotImplementedError(ITEM_18)


def build_decode_case(*args, **kwargs):
    raise NotImplementedError(ITEM_18)


def build_case(*args, **kwargs):
    raise NotImplementedError(ITEM_18)
