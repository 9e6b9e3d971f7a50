"""Serving driver: prefill, then batched greedy decode in lockstep.

Counterpart of `repro/launch/serve.py`'s `smoke_main` (and of the prefill
+ decode loop of its `build_decode_one`) for the dense family:

    python -m repro_torch.launch.serve --arch gemma2-27b [--device cpu]

It takes the reference CLI's defaults (batch 4, prompt 32, 16 tokens,
cache 128, the smoke config), draws params and prompt from
`torch.Generator`s seeded with ``--seed``, and prints the prefill time,
the decode rate and a sample, as the reference does.  `generate` also
takes injected params and tokens, so a test can hand it the reference's.
Caches are in the compute dtype.

``--federated`` refuses: the reference's ``--federated`` trains and
serves an LM population (`launch/train.py`'s ``_lm_fns`` and
``lm_federated_data``), which is LM training, ROADMAP.md Queue 1 item
16b.  Its other flags, ``--placement mesh`` among them, come with item
16b.  The personalised serving plane itself is ported
(`repro_torch.fl.serve`: `DeltaStore`, `ServeEngine`, on `HostVmap` or
`MeshShardMap`) and serves LeNet populations from
`run_federated(keep_state=True)`.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


class Generation(NamedTuple):
    tokens: torch.Tensor              # (B, n_tokens) int64, greedy
    logits: Optional[List[torch.Tensor]]   # per step (B, V) f32, if kept
    prefill_s: float                  # wall seconds, prefill + first argmax
    decode_s: float                   # wall seconds, the n_tokens-1 steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
             n_tokens: int, cache_len: int, *,
             return_logits: bool = False) -> Generation:
    """Greedy decode of ``n_tokens`` tokens after the prompt ``tokens``
    (B, P) on the prompt's device: one prefill, then ``n_tokens - 1``
    decode steps at positions P, P+1, ... for every row at once.  With
    ``return_logits`` the (B, V) f32 logits of each step are kept (the
    prefill's last position first)."""
    if n_tokens < 1:
        raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
    dev = tokens.device
    b, prompt_len = tokens.shape
    caches = T.make_caches(cfg, b, cache_len, cfg.cdtype, device=dev)
    kept = [] if return_logits else None
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = T.prefill(params, cfg, {"tokens": tokens}, caches)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    out = [tok]
    if kept is not None:
        kept.append(logits[:, -1])
    _sync(dev)
    t1 = time.perf_counter()
    for i in range(n_tokens - 1):
        logits, caches = T.decode_step(params, cfg, tok, caches,
                                       prompt_len + i)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        out.append(tok)
        if kept is not None:
            kept.append(logits[:, -1])
    _sync(dev)
    return Generation(torch.cat(out, dim=1), kept, t1 - t0,
                      time.perf_counter() - t1)


def smoke_main(args) -> torch.Tensor:
    """The smoke model through prefill and decode_step; returns tokens."""
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = T.init_params(torch.Generator(device=dev).manual_seed(args.seed),
                           cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    b = args.batch
    prompt = torch.randint(0, cfg.vocab_size, (b, args.prompt_len),
                           generator=gen, device=dev)
    res = generate(params, cfg, prompt, args.tokens, args.cache_len)
    print(f"prefill {args.prompt_len} tokens x{b}: {res.prefill_s:.2f}s")
    steps = args.tokens - 1
    print(f"decoded {steps} steps x{b} in {res.decode_s:.2f}s "
          f"({steps * b / max(res.decode_s, 1e-9):.1f} tok/s)")
    print("sample:", res.tokens[0][:16].tolist())
    return res.tokens


def federated_main():
    """The reference's train-then-serve LM population: not ported."""
    raise NotImplementedError(
        "--federated trains and serves a federated LM population (the "
        "reference's launch/train.py _lm_fns, lm_federated_data): LM "
        "training is not ported yet, ROADMAP.md Queue 1 item 16b, with "
        "its other flags (--placement mesh among them).  The serving "
        "plane itself is repro_torch.fl.serve (DeltaStore, ServeEngine, "
        "placement=HostVmap or MeshShardMap) over "
        "run_federated(keep_state=True).")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="gemma2-27b")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--tokens", type=int, default=16)
    p.add_argument("--cache-len", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--federated", action="store_true",
                   help="the reference's federated LM serving: not ported "
                        "yet (ROADMAP.md Queue 1 item 16b)")
    args = p.parse_args(argv)
    if args.federated:
        return federated_main()
    return smoke_main(args)


if __name__ == "__main__":
    main()
