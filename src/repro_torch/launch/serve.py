"""Serving driver: prefill, then batched greedy decode in lockstep; and
the personalised serving plane over a federated LM population.

Counterpart of `repro/launch/serve.py` for every family (``--arch``
defaults to mamba2-780m, as the reference's):

    python -m repro_torch.launch.serve [--arch gemma2-27b] [--device cpu]
    python -m repro_torch.launch.serve --federated --arch stablelm-3b \
        --rounds 2 --clients 4 --codec qsgd:4 [--device cpu]

`smoke_main` takes the reference CLI's defaults (batch 4, prompt 32, 16
tokens, cache 128, the smoke config), draws params, prompt and (whisper,
paligemma) the audio or vision embeddings from `torch.Generator`s of
their own seeded with ``--seed``, and prints the prefill time, the
decode rate and a sample, as the reference does.  `generate` also takes
injected params and tokens, so a test can hand it the reference's; a
vlm batch's image prefix shifts the decode positions by its length, as
the reference's smoke loop does.
Caches are in the compute dtype: an attention layer's ring, updated in
place, or an SSM layer's `SSMCache`, replaced each step (a bf16 config's
SSM state rounds to bf16 every token, as in the reference's step
builders).

``--federated`` (`federated_main`) trains a federated LM population with
`run_federated(keep_state=True)` (`launch.train`'s data, params and
loss: the engine's flat-key view of the reference's scanned layout), or
loads a saved store, ingests the per-user params into a codec-compressed
`DeltaStore`, and serves each user's greedy decode through that user's
own params: the `ServeEngine` vmaps `build_decode_one`'s function over a
batch of users, so a batch is one gather and decode of its users' rows,
one vmapped prefill and one vmapped decode step a token, each attention
product one flash launch for the whole batch (`kernels.ops`).  The
§3d parity anchor (`check_parity`) is checked on the served batch.  The
data, the initial params, the run's draws and the prompts come from host
generators seeded by ``--seed``, so a run on the card and one on the CPU
see the same bits (a qsgd store's rounding noise is drawn on the store's
device).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.train import host_generator
from repro_torch.models import scan as scan_mod
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
             extra: Optional[Dict[str, torch.Tensor]] = None,
             long_context: bool = False,
             return_logits: bool = False) -> Generation:
    """Greedy decode of ``n_tokens`` tokens after the prompt ``tokens``
    (B, P) on the prompt's device: one prefill, then ``n_tokens - 1``
    decode steps at positions n + P, n + P + 1, ... for every row at once,
    n the image prefix's length (a vlm batch's vision tokens, else 0).
    ``extra`` holds the batch's other inputs (``audio_embeds``,
    ``vision_embeds``); ``long_context`` is the reference's long_500k
    mode (`models.transformer`).  With ``return_logits`` the (B, V) f32
    logits of each step are kept (the prefill's last position first)."""
    if n_tokens < 1:
        raise ValueError(f"n_tokens must be >= 1, got {n_tokens}")
    dev = tokens.device
    b, prompt_len = tokens.shape
    batch = dict(extra or {}, tokens=tokens)
    if cfg.family == "vlm" and "vision_embeds" in batch:
        prompt_len += batch["vision_embeds"].shape[1]
    caches = T.make_caches(cfg, b, cache_len, cfg.cdtype,
                           long_context=long_context, device=dev)
    kept = [] if return_logits else None
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = T.prefill(params, cfg, batch, caches,
                               long_context=long_context)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    out = [tok]
    if kept is not None:
        kept.append(logits[:, -1])
    _sync(dev)
    t1 = time.perf_counter()
    for i in range(n_tokens - 1):
        logits, caches = T.decode_step(params, cfg, tok, caches,
                                       prompt_len + i,
                                       long_context=long_context)
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
    res = generate(params, cfg, prompt, args.tokens, args.cache_len,
                   extra=smoke_embeds(cfg, b, args.seed + 2, dev))
    print(f"prefill {args.prompt_len} tokens x{b}: {res.prefill_s:.2f}s")
    steps = args.tokens - 1
    print(f"decoded {steps} steps x{b} in {res.decode_s:.2f}s "
          f"({steps * b / max(res.decode_s, 1e-9):.1f} tok/s)")
    print("sample:", res.tokens[0][:16].tolist())
    return res.tokens


def smoke_embeds(cfg: ModelConfig, b: int, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """The stub frontends' inputs of a smoke batch, N(0, 1) f32 from a
    generator of their own: whisper's ``audio_embeds`` (B, n_ctx, d),
    paligemma's ``vision_embeds`` (B, n_tokens, embed_dim); none
    otherwise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if cfg.family == "audio":
        shape, key = (b, cfg.encoder.n_ctx, cfg.d_model), "audio_embeds"
    elif cfg.family == "vlm":
        shape = (b, cfg.vision.n_tokens, cfg.vision.embed_dim)
        key = "vision_embeds"
    else:
        return {}
    return {key: torch.randn(shape, generator=gen, device=device)}


def build_decode_one(cfg: ModelConfig, prompt_len: int, n_tokens: int,
                     cache_len: int):
    """Per-user greedy decode: ONE user's params (the flat-key view, as a
    `DeltaStore` unravels them) and ONE prompt (P,) -> (n_tokens,) int32
    token ids, the prefill's argmax first.  The `ServeEngine` vmaps it
    over a batch of users.  The reference makes f32 caches; the port's
    are in the compute dtype, as `generate`'s are, so the two agree at
    f32 configs and a bf16 config keeps bf16 rings."""
    def decode_one(params, tokens):
        p = scan_mod.unstack_layer_params(scan_mod.nest_params(params), cfg)
        caches = T.make_caches(cfg, 1, cache_len, cfg.cdtype,
                               device=tokens.device)
        logits, caches = T.prefill(p, cfg, {"tokens": tokens[None]}, caches)
        tok = logits[:, -1].argmax(dim=-1)
        out = [tok]
        for i in range(n_tokens - 1):
            logits, caches = T.decode_step(p, cfg, tok[:, None], caches,
                                           prompt_len + i)
            tok = logits[:, -1].argmax(dim=-1)
            out.append(tok)
        return torch.cat(out).to(torch.int32)

    return decode_one


def user_prompts(seed: int, users, prompt_len: int, vocab: int
                 ) -> Dict[int, torch.Tensor]:
    """One prompt (P,) per user, each from its own host generator."""
    return {u: torch.randint(0, vocab, (prompt_len,),
                             generator=host_generator(seed, 2, u))
            for u in sorted(set(users))}


def federated_main(args, prompts: Optional[Dict[int, Any]] = None
                   ) -> List[np.ndarray]:
    """Train-then-serve (or load a store): the §3d serving plane.
    ``prompts`` ({user: (P,) tokens}) replaces the drawn prompts, so a
    test can serve the reference's.  Returns the served tokens in
    request order."""
    from repro_torch.fl import (FLConfig, HostVmap, MeshShardMap,
                                TorchDraws, run_federated)
    from repro_torch.fl.serve import DeltaStore, ServeEngine, check_parity
    from repro_torch.launch.train import (_lm_fns, lm_federated_data,
                                          lm_model_init)

    dev = resolve_device(args.device)
    cfg, loss_fn, acc_fn = _lm_fns(args.arch, args.preset)
    placement = (MeshShardMap(schedule="shard_map_streams", device=dev)
                 if args.placement == "mesh" else HostVmap())
    if args.store:
        store = DeltaStore.load(args.store, device=dev)
        print(f"loaded store {args.store}: {store.summary()}")
    else:
        m = args.clients
        fed = lm_federated_data(args.seed, m, pool=args.pool, n_val=4,
                                seq=args.prompt_len, vocab=cfg.vocab_size,
                                device=dev)
        fl = FLConfig(rounds=args.rounds, local_steps=args.local_steps,
                      batch_size=4, eval_every=max(1, args.rounds // 2))
        t0 = time.time()
        h = run_federated(args.algorithm, fed, fl=fl, placement=placement,
                          model_init=lm_model_init(cfg, dev),
                          loss_fn=loss_fn, acc_fn=acc_fn, keep_state=True,
                          seed=args.seed, draws=TorchDraws(args.seed, "cpu"),
                          device=dev)
        print(f"trained {args.algorithm} m={m} rounds={args.rounds} "
              f"final -CE={h.mean_acc[-1]:.4f} ({time.time()-t0:.0f}s)")
        store = DeltaStore.from_history(h, codec=args.codec,
                                        backend=placement.codec_backend,
                                        device=dev)
        print(f"store[{args.codec}]: {store.summary()}")
    if args.save_store:
        store.save(args.save_store)
        print("store written:", args.save_store)

    decode_one = build_decode_one(cfg, args.prompt_len, args.tokens,
                                  max(args.cache_len, args.prompt_len
                                      + args.tokens))
    engine = ServeEngine(store, decode_one, placement=placement,
                         max_batch=args.max_batch)
    users = [int(u) for u in np.arange(args.requests) % store.m]
    if prompts is None:
        prompts = user_prompts(args.seed, users, args.prompt_len,
                               cfg.vocab_size)
    prompts = {u: torch.as_tensor(np.array(prompts[u]))
               for u in set(users)}
    for u in users:
        engine.submit(u, prompts[u])
    t0 = time.time()
    outs = engine.flush()
    dt = time.time() - t0
    # the §3d parity anchor on a served batch: gather-then-decode output
    # == direct forward through the reference reconstruction
    probe = sorted(set(users))[:args.max_batch]
    check_parity(engine, probe, torch.stack([prompts[u] for u in probe]))
    stats = engine.last_stats
    lat = stats["latency_s"]
    print(f"served {stats['requests']} requests in {stats['batches']} "
          f"batches, {dt:.2f}s ({stats['requests']/max(dt, 1e-9):.1f} "
          f"req/s), per-batch p50={np.percentile(lat, 50)*1e3:.0f}ms "
          f"max={max(lat)*1e3:.0f}ms — parity anchor OK")
    for u, o in list(zip(users, outs))[:4]:
        print(f"user {u}: {np.asarray(o)[:12]}")
    return outs


def main(argv=None, prompts: Optional[Dict[int, Any]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="mamba2-780m")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--tokens", type=int, default=16)
    p.add_argument("--cache-len", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    # ---- personalised serving plane (DESIGN.md §3d) ----
    p.add_argument("--federated", action="store_true",
                   help="serve per-user personalised models from a "
                        "DeltaStore (train first, or --store to load)")
    p.add_argument("--preset", default="cpu-small",
                   choices=("cpu-small", "lm-100m", "full"),
                   help="federated: LM preset (launch.train grammar)")
    p.add_argument("--algorithm", default="ucfl_k2",
                   help="federated: strategy registry spec")
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--local-steps", type=int, default=1)
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--pool", type=int, default=16,
                   help="federated: sequences per client dataset")
    p.add_argument("--codec", default="identity",
                   help="federated: at-rest delta codec — identity | "
                        "qsgd:<bits> | topk:<frac>")
    p.add_argument("--placement", default="host", choices=("host", "mesh"),
                   help="federated: where batches decode and land")
    p.add_argument("--store", default="",
                   help="federated: load a checkpointed DeltaStore instead "
                        "of training")
    p.add_argument("--save-store", default="",
                   help="federated: checkpoint the built DeltaStore here")
    p.add_argument("--requests", type=int, default=8,
                   help="federated: number of decode requests to serve")
    p.add_argument("--max-batch", type=int, default=4,
                   help="federated: micro-batcher chunk size")
    args = p.parse_args(argv)
    if args.federated:
        return federated_main(args, prompts)
    return smoke_main(args)


if __name__ == "__main__":
    main()
