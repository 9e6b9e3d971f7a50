#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device   — needs CUDA; prints the card's name and power limit, turns
                TF32 off for matmul and cuDNN;
  2. build    — compiles every ``src/repro_torch/kernels/csrc/*.cu`` with
                nvcc (all at once) and prints build time and ptxas output;
  3. kernels  — holds each CUDA kernel against its plain PyTorch version on
                the card (mix and Gram at tests/test_kernels.py's
                tolerances, outputs landing on a NaN fill; the mix of a
                ragged leaf set bitwise equal to one-leaf calls, the
                folded stream mix to the gather form; the Gram bitwise
                over 10 calls, Δ bitwise `ref.sqdist_from_gram` of its G;
                a round's mix at k = m = 20 and 100 beside per-leaf and
                flat `torch.matmul`, with its host µs; the channel
                kernels bitwise on every row (zero, NaN and inf rows
                included): the QSGD row pass's absmax, encode and
                roundtrip on both of its paths (row in registers,
                re-read) and the QSGD stream's quantize and dequantize,
                the top-k kernel on each of its three paths (registers,
                shared memory, global) and across calls; the flash
                kernels at bf16's 3e-2 / f32's 2e-5) and times kernel,
                plain version and one PyTorch library call with CUDA
                events, beside the byte/FLOP bound; the tensor-core flash
                kernel at every head_dim it takes (64, 80, 128 and 256
                on ragged shapes, 128 at [lm] (a)'s prefill, 256, 80 and
                128 at [lm] (c)'s); the three flash kernels at a value
                head dim apart from the query's (dk 24 / dv 16 and 192 /
                128 on ragged shapes, then MLA's prefill and decode step
                at its published heads, timed beside their bounds and
                SDPA, its backend named); the (192, 192) instance on the
                same ragged shapes and nemotron-4-340b's prefill and
                decode step (96 / 8 heads of 192), timed the same way,
                the prefill beside the CUDA-core kernel it replaces;
                the flash op under `torch.func.vmap`
                (the per-user decode's call) bitwise the per-user calls,
                one launch for all the users; `prefix_len` (a prefix-LM's
                bidirectional prefix) on all three kernels with a planted
                fault (the kernel without its prefix fails), non-causal
                Sq > Sk, and whisper-tiny's encoder and cross-attention
                step and paligemma-3b's prefix prefill timed beside
                their bounds and SDPA;
  4. agree    — a small label-shift run on the card against the same run
                on the CPU (same init, same draws; the CPU side on one
                intra-op thread, so its bits repeat); one uplink crossing
                bitwise across the devices; a small run with a sampler and
                a qsgd channel on both devices;
  5. main     — run_federated for ucfl, ucfl_k4 and fedavg on the paper's
                §IV-A.1 scenario (n=10000, m=20, LeNet-5, D=47,571), with
                launch counters showing every mix (one launch a round,
                all ten leaves) and the UCFL Δ (one launch a run, G and
                Δ) went through the kernels;
  6. channel  — the same scenario through the uplink channel: ucfl_k4
                with UniformFraction(0.5) and qsgd:8 over a tiered link
                (one QSGD row-pass launch a crossing), ucfl with
                topk:0.1, fedavg with the identity channel (its clock
                must equal phase 5's fedavg clock exactly), with launch
                counters and exact History.comm_bits.  Phases 5 and 6
                run every spec twice, fused (the default: one captured
                CUDA graph an eval-to-eval chunk) and eventful
                (superstep=False): histories equal line for line, final
                params and residuals bitwise, the same launch counts;
  7. faults   — phase 5's config through the last two strategies and the
                fault/defense layer: cfl (eventful only: its state
                changes between rounds), fedfomo, ucfl_k4 +
                byz:0.25:sign_flip + trimmed_mean:0.25, fedavg +
                crash:0.3,nan:0.2 + median, ucfl + crash:0.5 +
                min_quorum=12, and ucfl_k4 + UniformFraction(0.5) +
                qsgd:8 + bitrot:0.3,seed:2 + krum:0.25, each fused and
                eventful: histories, final params and
                ``extra["faults"]`` equal across engines, the stated
                launch counts of each engine (the fused round always
                mixes and gates the mix with a ``where``; the eventful
                loop skips the mix below quorum), wall s a round;
  8. superstep — ucfl_k4 at phase 5's config, the graphs captured anew:
                capture seconds and the graphs' pool memory apart, wall
                s a round of each engine (median of 3 after a warm run,
                with and without the setup), and one torch.profiler
                trace of a 5-round chunk under each engine (wall, device
                busy, idle share; the local update, mix and eval apart);
  9. async    — phase 5's config through the buffered-async runtime
                (`run_federated(async_cfg=...)`, 20 events): the cohort
                update against the masked full update (bitwise at
                k = 5 and 10); the lockstep anchor (ucfl_k4, `wired`,
                K = m) bitwise the sync run;
                ucfl_k4 K=5 (max_staleness 3, exp 0.8), fedavg K=5 (poly
                α 0.5), ucfl K=10 with qsgd:8 over tiered:4, fedavg +
                crash:0.3 + median + min_quorum=3 (max_retries 2), each
                with its stated launches (a mix an event that met its
                quorum, the Gram and Δ once a ucfl run, a QSGD row pass
                an event of the qsgd run), s/event of a first and a
                second run, the virtual clock against the sync run's,
                and one torch.profiler trace of a K=5 run (device busy,
                idle share);
 10. checkpoint — the K=5 ucfl_k4 run's final params and optimizer state
                (and a bf16 copy of the params) saved and restored on
                the card bitwise; one flipped byte must raise;
 10b. serve   — the personalised serving plane (`fl.serve`): identity,
                qsgd:4 and topk:0.25 `DeltaStore`s of phase 5's ucfl
                models (every user its own) keyed on ucfl_k4's streams,
                and ucfl_k4's own qsgd:4 store (`from_history`, zero
                deltas, its params back bitwise): the identity store
                gives the trained params and their logits back bitwise,
                the parity anchor (`check_parity`) over the 20 users,
                14 flushes of 128 requests at max_batch 16 (req/s, batch
                p50/p99/max over the 104 batches after the first flush,
                accounted and resident bytes, one QSGD stream launch a
                qsgd batch), the stream's decode of a batch's 16 rows
                bitwise its plain version, the micro-batcher's contract
                (a request alone or in a batch of 2 within rtol 1e-5 of
                it in a batch of 16), a profiled flush (device busy,
                against the untraced flushes' median wall);
                then a 2,048-user qsgd:4 store (ucfl's models plus
                seeded noise, the rounding noise given): build time, its
                levels and absmax (the row pass's encode at (2,048,
                47,571)) and the stream's decode of 64 and of 2,048 rows
                bitwise their plain versions, the anchor on 64 users,
                8 flushes of 1,024 requests at max_batch 64.  The qsgd
                builds run the QSGD row pass's encode, the decodes the
                QSGD stream;
 10c. paging  — the cohort paging engine (`run_federated(paging=...)`):
                [main]'s scenario widened to 1,000 clients over 100,000
                samples, data and client-state store (params, momentum,
                EF residuals) on the host, a cohort of 20 on the card,
                ucfl_k4 + qsgd:8 under wireless_slow, a round and its
                eval a superstep: (a) a `FixedCohort` of 20 rows bitwise
                the resident fused run on its sub-population; (b) a
                20-superstep sweep, prefetch on and off bitwise (history
                and every store row), s/superstep, and a profiler trace
                of three supersteps (device busy share, H2D and D2H copy
                time and how much of it lies under kernels); (c) random
                overlapping cohorts of a 40-client population, prefetch
                on and off bitwise; (d) the sweep's peak device memory
                (requested bytes) at 200 and 1,000 clients within 1 MiB;
                (e) a memmap-store
                run preempted and resumed bitwise, then resumed past a
                corrupt newest snapshot (a warning, the one before);
                (f) the async lockstep anchor (20 clients, K = 20)
                bitwise the resident `run_async`, then K = 5 over the
                1,000 clients: s/event.  Every run's launches stated;
 10d. hierarchy — the hierarchical edge tier at phase 5's scenario: (a)
                `HierarchyConfig(devices_per_user=1)` with ucfl_k4 on
                both engines bitwise phase 5's flat ucfl_k4 (history,
                clock, comm bits, final params, launches); (b) ucfl_k4
                two-level (ragged:2-4 devices, a qsgd:4 edge codec over
                a tiered:4 edge link, edge latency 0.5) fused bitwise
                eventful (history, edge books, final params and
                `EdgeState`), one QSGD row pass a round over the
                (m·d_max, F) device rows, s/round of each engine and a
                profiler trace of a 5-round chunk each (busy share);
                (c) a topk:0.1 edge codec, eventful: one top-k launch a
                round on the device rows; (d) drop_stragglers:0.4 with
                device dropout 0.25: finite, fewer edge uplink bits than
                the mean aggregator's; (e) the async engine two-level,
                K = 5, on a row-local plan and on a drop_stragglers plan
                (partial events full width): s/event, a row pass an
                event;
 10e. mesh    — `MeshShardMap` on a one-rank NCCL group (started in this
                process, no network) at phase 5's scenario: (a) ucfl_k4
                and fedavg under gspmd, shard_map_streams and
                shard_map_unicast on both engines, each bitwise phase 5's
                HostVmap run (history, clock, params; a mix launch a
                round), and for ucfl_k4 each schedule's fused s/round
                (less a setup-only run) and a profiler trace of a
                5-round chunk (busy share, the NCCL kernels' share, the
                device copies' ms; the flat HostVmap run in turn with
                them);
                (b) ucfl_k4 with qsgd:4 and topk:0.1 through the codecs'
                "jnp" backend, each bitwise the HostVmap run (top-k's
                exact k-th magnitude against the bisection, the masks'
                differing coordinates counted); (c) a
                `ServeEngine(placement=mesh)` batch of 16 on a qsgd:4
                store file labelled "jnp", bitwise the HostVmap batch;
                (d) the async lockstep anchor on the mesh bitwise its
                sync run, then K = 5 bitwise HostVmap's K = 5,
                s/event.  Phase 4 also
                holds a small mesh run on the card against the same run
                over a gloo group on the CPU.  The group is torn down
                before the last lines;
 10f. examples — the reference's examples as the port's entry points
                (`examples/*_torch.py`) at their defaults: the
                quickstart (5 clients, d 16, k 2), comm_tradeoff
                (covariate shift n 2,000, m 12, 12 rounds; fedavg,
                ucfl_k2, ucfl_k4, ucfl under the identity channel, then
                ucfl_k2 under qsgd:8, qsgd:4 and topk:0.25; silhouettes
                at k 2, 3, 4, 6) and personalization_emnist (local,
                fedavg, ucfl_k4, oracle; 18 rounds) on HostVmap and on
                `MeshShardMap` over the NCCL group: their tables, each
                run's wall, and the phase's launches of rows 1, 2, 3–5
                and 6.  It fails when an accuracy is not finite or not
                in [0, 1], a streams / time / DL-bits column differs
                from `downlink_cost`, `SYSTEMS[...].round_time` and the
                run's payload bits on its own `History.comm`, one of
                those four rows never launched, the mesh sweep differs
                from the host one, the ucfl_k2 run's W (the
                silhouettes') differs from the ucfl run's by more than
                1e-6, or the quickstart's W does not put 0.9 of every
                row on its true group, or its W or assignment differs
                from the CPU run's on the same data (W by more than
                1e-6).  Phase 3 holds the mix and the Gram kernel
                against their plain versions at the examples' shapes;
 11. lm       — dense-decoder serving at gemma2-27b's full width (depth
                cut to one local and one global layer) through
                `launch.serve.generate`: (a) bf16, B 2, a 4,608-token
                prompt (past the 4,096 window, so the local ring wraps
                every step), 32 greedy tokens, timed, with one
                flash-attention launch per layer per step (the two
                prefill calls on the tensor-core kernel, the 62 decode
                calls on the split-key decode kernel), then a
                torch.profiler trace of decode steps (device time by
                flash / GEMM / other, idle share); (b) the same in f32
                (prefill on the CUDA-core kernel, decode on the decode
                kernel), where one fresh prefill of prompt + generated
                tokens must reproduce the last decode step's logits;
                (c) bf16 serving of gemma-2b (hd 256, MQA; B 2, prompt
                8,160, cache 8,192), stablelm-3b (hd 80, MHA; B 2,
                prompt 4,064, cache 4,096) and olmoe-1b-7b (hd 128 with
                qk_norm, 64 experts of 1,024, top 8; B 2, prompt 4,064,
                cache 4,096) at their full widths, depth cut to 2, 32
                greedy tokens each: timed, peak MiB, with exactly 2
                prefill launches on the tensor-core kernel, 62 on the
                decode kernel and none on the CUDA-core kernel, and a
                torch.profiler trace of one prefill (device time by
                flash / GEMM / other; olmoe's by flash / the MoE
                einsums / the other GEMMs / the rest); and
                deepseek-v3-671b (MLA: q_lora 1,536, kv_lora 512, dk
                192, dv 128; 256 experts of 2,048 top 8 and a shared
                one; B 2, prompt 4,064, cache 4,096) at depth 61 -> 4
                (three dense-first layers, one MoE layer; 15.11 B
                params): 4 tensor-core, 124 decode and 0 CUDA-core
                launches, the latent rings' bytes beside the expanded
                K/V's, the same traces; mamba2-780m (48 SSD layers,
                d_state 128, chunk 256; B 2, prompt 8,160, cache 8,192)
                and zamba2-2.7b (54 layers, every 6th the one shared
                attention block at hd 80; B 2, prompt 4,064) uncut, and
                nemotron-4-340b (96 / 8 heads of 192, squared ReLU,
                untied 256,000 vocab) at depth 96 -> 2 (16.35 B params):
                one tensor-core launch an attention layer a prefill and
                one decode launch an attention layer a step (mamba2:
                none), prefill traces split flash / the SSD scans / the
                other GEMMs / the rest, and decode traces with the idle
                share; whisper-tiny uncut (B 8, 1,500 audio frames,
                prompt 32, 128 tokens: the encoder and the
                cross-attention through the flash kernels, non-causal),
                paligemma-3b uncut (256 image tokens before a 7,904-token
                prompt, a prefix prefill) and gemma-2b under
                ``long_context`` (a 32,768-token prefill into rings of
                8,192, then decode steps over the wrapped rings), each
                with its flash launches stated by `flash_calls`.  Before
                (c), one MLA layer at published widths: its flash path
                against its no-cache plain path, the absorbed path
                against the naive one.
 12. train    — federated LM training (`launch.train`, the reference's
                scanned layout as the engine's flat-key view) and the
                scenario generators: (a) `launch.train.main` at the
                lm-100m preset (8 layers, d_model 512, d_ff 2,048, vocab
                32,000), 4 clients, ucfl_k2, 3 rounds, pool 16 x 256
                tokens, batch 4, on the host placement, the default mesh,
                qsgd:8 over tiered:4, topk:0.1, async K = 2, a cohort of
                2, fleets of 2 devices, crash:0.2 + median, and
                olmoe-1b-7b, deepseek-v3-671b (the MoE family, MLA) and
                mamba2-780m (the SSM family) on the host: each run's
                final CE, s/round and launches; (d) the three scenarios
                drawn on the card at their default sizes (shapes, groups,
                the padding rule, the covariate rotations, one label
                permutation a group), then ucfl_k4 for 5 fused rounds on
                cifar_concept_shift (LeNet-5 at 32x32x3); (b), run
                right after phase 2 in a child process of this script
                (``--train-published``) that has the card to itself (its
                ~50 GB do not fit beside a second context and what the
                earlier phases hold), stablelm-3b at its published
                widths, depth 2 (0.416 B bf16 params),
                ucfl_k2 over 4 clients of pool 8 x 256 tokens: setup s,
                fused = eventful bitwise, s/round, peak MiB, launches (3
                mixes, 1 Gram a run; 3 QSGD row passes with qsgd:8), a
                profiler trace of a 5-round chunk, its capture inside
                (busy share), then the
                mix of the clients' bf16 leaves, G + Δ, one qsgd:8
                crossing, a qsgd:4 encode and a decode of a (4, 0.416 B)
                f32 matrix against their plain versions, timed beside
                their byte bounds; (e), in the same process, the trained
                population served per user (`launch.serve`'s
                `build_decode_one` under the `ServeEngine`'s vmap):
                identity and qsgd:4 `DeltaStore`s, each built (s, peak
                MiB), 3 flushes of 8 requests at max_batch 4 (prompt 32,
                16 tokens; the first warms up), `check_parity` after
                every flush: req/s, batch p50/max, peak MiB, launches;
                a batch's gather, prefill and decode steps timed apart
                (prefill ms, decode tok/s) and a batch traced.
 13. steps    — the mesh case builders (`launch/steps.py`), run second in a
                process of its own (``--steps``): (a) gemma2-27b at its
                published widths, bf16, depth 46 -> 4 (two groups of the
                (local, global) pattern): `build_prefill_case`'s function
                at prefill_32k cut to B 2 (the scanned `prefill`), then 16
                steps of `build_decode_case`'s (the scanned `decode_step`)
                on its caches, and long_500k (B 1, a 32,768-token prompt
                into the rings, 16 steps), each held against the unrolled
                `transformer.prefill` / `decode_step` on the same params
                (tokens equal, logits bitwise or within [agree]'s 1e-4):
                prefill ms, ms a step, peak MiB, and 4 tensor-core flash
                launches a prefill and 4 decode calls a step; the smoke
                stacks of mamba2-780m, zamba2-2.7b, deepseek-v3-671b and
                paligemma-3b at 4 layers through the scanned prefill and 8
                steps on the card against the CPU; (b) `build_train_case`'s
                step at stablelm-3b's published widths on
                `make_host_mesh()` (m = 1), train_4k cut to 2 x 4,096: at
                depth 4 remat on at microbatch 1 and 2 and remat off at
                microbatch 2 (loss bitwise across remat, params within
                1e-5; microbatch 2 against 1 at rtol 2e-4), then uncut
                (32 layers) with remat: step s, peak MiB, one
                row-1 launch a step; (c) `launch.dryrun --all` on
                `make_card_mesh()`, split over four processes
                (``--shard``) beside (a) and (b): a line a case (roofline
                terms, bottleneck, peak, fits), and the planner's FLOPs
                and peak beside (a)'s and (b)'s measurements, with its
                verdict on the runs not made (depth 4 without remat at
                microbatch 1, uncut without remat).
Phase 3 also holds the three flash-attention kernels at the [lm] shapes
and on ragged shapes, at two logit scales, one past the softcaps (where
the kernel run without its softcap must fail the check), the decode
kernel also bitwise against itself across calls; phase 4 the LM path on
the card against the CPU at nine smoke runs (olmoe's the MoE
family, deepseek's MLA, mamba2 and zamba2 the SSM and hybrid families,
whisper-tiny the audio family, paligemma-3b the vlm family, gemma2-27b
under ``long_context``) and ``seq_parallel=True`` bitwise the flag off,
`launch.serve.main --federated` at its smallest flags on stablelm-3b,
deepseek-v3-671b, mamba2-780m and paligemma-3b (the same served tokens),
`launch.train.main` at
cpu-small (host-drawn data and params, losses within rtol 1e-4), a buffered-async run on
the card against the CPU, without a channel and with qsgd:8, and a
two-level run (qsgd:8 edge codec) on the card against the CPU.
The last lines are the kernels JSON, the card line, and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.checkpoint import (CheckpointCorruptError,  # noqa: E402
                                    restore, restore_train_state, save,
                                    save_train_state)
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import StreamPlan, mix_pytree, stream_aggregate  # noqa: E402,E501
from repro_torch.convert import tree_from_numpy, tree_to_numpy  # noqa: E402
from repro_torch.data import FederatedData, scenario_label_shift  # noqa: E402
from repro_torch.fl import (AsyncConfig, Channel, FLConfig,  # noqa: E402
                            MeshShardMap, SYSTEMS, TorchDraws,
                            UniformFraction, run_federated)
from repro_torch.fl import DeltaStore, ServeEngine, check_parity  # noqa: E402
from repro_torch.fl import downlink_cost  # noqa: E402
from repro_torch.fl.serve.store import refined_delta  # noqa: E402
from repro_torch.fl.channel import (get_codec, stacked_ravel,  # noqa: E402
                                    uplink_roundtrip)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.pairwise_sqdist import card_plan  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    decode_splits, flash_attention_cuda, flash_attention_tc_cuda,
    flash_decode_cuda, flash_route)
from repro_torch.kernels import quantize as qsgd  # noqa: E402
from repro_torch.kernels.topk_threshold import (  # noqa: E402
    row_path, topk_threshold_cuda)
from repro_torch.launch.serve import (build_decode_one,  # noqa: E402
                                      generate, smoke_embeds, user_prompts)
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,  # noqa: E402
                                     PEAK_FLOPS_F32)
from repro_torch.models import lenet  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

# the H100 SXM datasheet's HBM3 rate and dense peaks (launch/mesh.py)
HBM_BYTES_PER_S = HBM_BW
FP32_FLOP_PER_S = PEAK_FLOPS_F32
BF16_FLOP_PER_S = PEAK_FLOPS_BF16
D_LENET = 47571                # LeNet-5 on 28x28x1 with 47 classes
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
MAIN = dict(n=10000, m=20, rounds=20, local_steps=10, batch_size=64,
            eval_every=5, leaves=10)
# the serving path's configuration: gemma2-27b at full width
# (src/repro_torch/configs/gemma2_27b.py), random weights from a seed
LM = dict(arch="gemma2-27b", batch=2, prompt=4608, tokens=32,
          cache_len=4640, seed=0,
          reduced={"n_layers": "46 -> 2 (one local, one global layer)"})
# [lm] (c): the other three served configurations (src/repro_torch/
# configs/) at their full published widths, bf16, random weights from a
# seed; the prompt fills the cache but for the generated tokens.  The
# widths are gemma-2b's from the Gemma report (arXiv:2403.08295, Table 1),
# stablelm-3b's from stabilityai/stablelm-3b-4e1t's model card and config
# (d_model 2,560, 32 heads of 80, d_ff 6,912, vocab 50,304, rotary on a
# quarter of each head, LayerNorm, 4,096 context)
LM_C = (
    dict(arch="gemma-2b", batch=2, prompt=8160, tokens=32, cache_len=8192,
         seed=0, n_layers=2, reduced={"n_layers": "18 -> 2"},
         flash_row=True),
    dict(arch="stablelm-3b", batch=2, prompt=4064, tokens=32,
         cache_len=4096, seed=0, n_layers=2,
         reduced={"n_layers": "32 -> 2"}, flash_row=True),
    # OLMoE-1B-7B (arXiv:2409.02060): d_model 2,048, 16 heads of 128 with
    # qk_norm, 64 experts of 1,024, top 8, vocab 50,304, untied, RMSNorm
    dict(arch="olmoe-1b-7b", batch=2, prompt=4064, tokens=32,
         cache_len=4096, seed=0, n_layers=2,
         reduced={"n_layers": "16 -> 2"}, flash_row=True),
    # DeepSeek-V3-671B (arXiv:2412.19437): d_model 7,168, 128 heads of MLA
    # (q_lora 1,536, kv_lora 512, qk_nope 128, rope 64, v 128), 256
    # routed experts of 2,048, top 8, one shared, 3 dense-first layers of
    # d_ff 18,432, vocab 129,280, untied, RMSNorm; depth 4 keeps the
    # three dense-first layers and one MoE layer (15.11 B params)
    dict(arch="deepseek-v3-671b", batch=2, prompt=4064, tokens=32,
         cache_len=4096, seed=0, n_layers=4,
         reduced={"n_layers": "61 -> 4"}, free_first=True),
    # Mamba2-780M (arXiv:2405.21060): 48 SSD layers of d_model 1,536
    # (d_inner 3,072, 48 heads of 64, d_state 128, one group, conv 4,
    # chunk 256), vocab 50,280, tied, no attention and no MLP; uncut
    dict(arch="mamba2-780m", batch=2, prompt=8160, tokens=32,
         cache_len=8192, seed=0, n_layers=48, reduced={}),
    # Zamba2-2.7B (arXiv:2411.15242): 54 layers of d_model 2,560, every
    # 6th the one shared attention block (32 heads of 80, GeGLU MLP of
    # 10,240), the others Mamba2 (80 heads of 64, d_state 64), vocab
    # 32,000, tied; uncut
    dict(arch="zamba2-2.7b", batch=2, prompt=4064, tokens=32,
         cache_len=4096, seed=0, n_layers=54, reduced={}),
    # Nemotron-4-340B (arXiv:2402.16819): d_model 18,432, 96 query heads
    # on 8 KV heads of 192, squared-ReLU MLP of 73,728, vocab 256,000,
    # untied, LayerNorm; depth 2: two layers of 3.45 B and the two
    # embeddings, 16.35 B params
    dict(arch="nemotron-4-340b", batch=2, prompt=4064, tokens=32,
         cache_len=4096, seed=0, n_layers=2,
         reduced={"n_layers": "96 -> 2"}, free_first=True),
    # Whisper-tiny (arXiv:2212.04356): d_model 384, 4 encoder and 4
    # decoder layers of 6 heads of 64, GELU MLP of 1,536, vocab 51,865,
    # tied, LayerNorm; the stub frontend's 1,500 audio frames a row
    # (`launch.serve.smoke_embeds`); uncut
    dict(arch="whisper-tiny", batch=8, prompt=32, tokens=128,
         cache_len=160, seed=0, n_layers=4, reduced={}),
    # PaliGemma-3B (arXiv:2407.07726): gemma-2b's 18 layers behind the
    # stub frontend's 256 SigLIP patch embeddings of 1,152, projected;
    # uncut; a 7,904-token text prompt after the image, 8,160 in all
    dict(arch="paligemma-3b", batch=2, prompt=7904, tokens=32,
         cache_len=8192, seed=0, n_layers=18, reduced={}),
    # gemma-2b in the reference's long_500k mode (``long_context``): every
    # ring long_context_window = 8,192 slots; prefill_32k's 32,768 tokens,
    # then decode steps over the wrapped rings
    dict(arch="gemma-2b", key="gemma-2b long_context", batch=1,
         prompt=32768, tokens=32, cache_len=32800, seed=0, n_layers=2,
         reduced={"n_layers": "18 -> 2"}, long_context=True),
)
# [lm]: one MLA layer of deepseek-v3-671b at its published widths, bf16:
# B 1, a 1,024-token prefill into a latent ring of 1,040, then a decode
# step; its flash path against its no-cache plain path, and the absorbed
# path against the naive one, at bf16's 3e-2
MLA_CHECK = dict(arch="deepseek-v3-671b", batch=1, prompt=1024,
                 cache_len=1040, seed=0)
# [kernels]: the flash op under vmap, (name, users, (H, Kh, Sq, Sk, hd),
# dtype): [train] (e)'s served prefill and decode step (stablelm-3b, one
# user a batch row), olmoe's prefill head dim, and a decode over a long
# cache, where one user's split count is not the batch's
FLASH_VMAP = (
    ("served prefill (7a)", 4, (32, 32, 32, 32, 80), torch.bfloat16),
    ("served decode (7c)", 4, (32, 32, 1, 48, 80), torch.bfloat16),
    ("prefill hd 128 (7a)", 2, (16, 16, 1024, 1024, 128), torch.bfloat16),
    ("decode over 4,096 keys (7c)", 4, (16, 16, 1, 4096, 128),
     torch.bfloat16),
)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # test_kernels.py
# flash inputs' scaled logits q·k/√hd: N(0, 0.25²), far inside the
# softcaps (30, 50), and N(0, 50²), where cap·tanh(x/cap) saturates
LOGIT_STD, CAP_LOGIT_STD = 0.25, 50.0
# f32 decode against a fresh prefill: the two paths sum in other orders
# (GEMV against GEMM, cache against in-flight keys) over reductions 18-72x
# longer than the smoke configs' that tests/test_models.py holds at 2e-4
LM_SELF_TOL = 1e-3


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, flops: float, peak: float = FP32_FLOP_PER_S):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


_FLUSH = None


def time_ms(fn, iters: int = 30) -> float:
    """Median device time of ``fn()`` over ``iters`` runs, CUDA events.
    Before each run a 128 MiB write evicts the 50 MB L2 (the kernel reads
    from HBM) and a spin kernel holds the stream, so the whole of ``fn``'s
    launches is queued before the start event runs."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        _FLUSH.zero_()
        torch.cuda._sleep(2_000_000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def check_close(name, got, want, rtol, atol) -> float:
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    if not bool(torch.all(err <= lim)):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, max |err| {float(err.max()):.3e}")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def lenet_leaf_sizes() -> list:
    p = lenet.init_params(torch.Generator(device="cuda").manual_seed(0),
                          lenet.LeNetConfig(), device="cuda")
    sizes = [v.numel() for v in p.values()]
    assert sum(sizes) == D_LENET and len(sizes) == MAIN["leaves"], sizes
    return sizes


def rand_rows(gen, k, m):
    w = torch.rand((k, m), generator=gen, device="cuda")
    return w / w.sum(1, keepdim=True)


def nan_landing(n: int, dtype) -> int:
    """Fill a fresh n-element block with NaN and free it, so the next op's
    first allocation (its output) lands on NaN: an element the kernel
    skips stays NaN.  Returns the block's address."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t = torch.full((n,), float("nan"), dtype=dtype, device="cuda")
    ptr = t.data_ptr()
    del t
    return ptr


def host_us(fn, iters: int = 200) -> float:
    """Median host µs of one ``fn()`` (perf_counter, no synchronize)."""
    for _ in range(5):
        fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(ts) * 1e6


def mix_round(gen, k: int, m: int, sizes: list, label: str) -> dict:
    """One round's mix of LeNet's leaves at (k, m), f32, in one launch,
    timed beside per-leaf ``torch.matmul`` (the library call), one matmul
    over a pre-stacked flat (m, ΣD) (a floor) and the bound."""
    w = rand_rows(gen, k, m)
    thetas = [torch.randn((m, d), generator=gen, device="cuda")
              for d in sizes]
    flat = torch.cat(thetas, dim=1)
    total = sum(-(-k * d // 4) * 4 for d in sizes)
    ptr = nan_landing(total, torch.float32)
    got = ops.mixing_aggregate_leaves(w, thetas)
    if got[0].data_ptr() != ptr:
        raise AssertionError("mixing_aggregate: output did not land on the "
                             "NaN fill")
    err = max(check_close(f"mixing_aggregate {label}", y,
                          ref.mixing_aggregate_ref(w, t), 1e-5, 1e-5)
              for y, t in zip(got, thetas))
    eye = ops.mixing_aggregate_leaves(torch.eye(m, device="cuda"), thetas)
    if not all(torch.equal(y, t) for y, t in zip(eye, thetas)):
        raise AssertionError(f"mixing_aggregate {label}: identity W does not "
                             "return Θ bitwise")
    d_all = sum(sizes)
    n_bytes = (m * d_all + k * d_all) * 4 + 4 * k * m
    b, by = bound_ms(n_bytes, 2.0 * k * m * d_all)
    row = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.mixing_aggregate_leaves(w, thetas)),
        plain_ms=time_ms(lambda: [ref.mixing_aggregate_ref(w, t)
                                  for t in thetas]),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: [torch.matmul(w, t) for t in thetas]))
    flat_ms = time_ms(lambda: torch.matmul(w, flat))
    tree_us = host_us(lambda: ops.mixing_aggregate_leaves(w, thetas))
    leaf_us = host_us(lambda: [ops.mixing_aggregate(w, t) for t in thetas])
    print(f"  mixing_aggregate round {label}: one launch {row['ms']:.4f} ms  "
          f"per-leaf matmul {row['library_ms']:.4f} ms  flat matmul (floor) "
          f"{flat_ms:.4f} ms  plain {row['plain_ms']:.4f} ms  bound "
          f"{b:.4f} ms ({by})  max|err| {err:.2e}  host {tree_us:.1f} µs a "
          f"call ({len(sizes)} one-leaf calls: {leaf_us:.1f} µs)",
          flush=True)
    return row


def ragged_leaves(gen, m, dtype, n_leaves) -> list:
    """n_leaves (m, d) leaves over ragged widths, every other one based one
    element past an aligned address (4- or 2-byte aligned rows)."""
    widths = (1, 6, 47, 127, 128, 129, 150, 4099)
    out = []
    for i in range(n_leaves):
        d = widths[i % len(widths)]
        base = torch.randn(m * d + 1, generator=gen, device="cuda").to(dtype)
        out.append(base[i % 2:i % 2 + m * d].view(m, d))
    return out


def check_mixing(gen) -> dict:
    # the examples' shapes too: the m = 12 sweeps at k = 1, 2, 4 and 12,
    # the quickstart's (5, 5) rule over its (5, 16) leaf
    shapes = [(1, 20, D_LENET), (4, 20, D_LENET), (20, 20, D_LENET),
              (100, 100, D_LENET), (1, 12, D_LENET), (2, 12, D_LENET),
              (4, 12, D_LENET), (12, 12, D_LENET), (5, 5, 16), (4, 20, 1),
              (4, 20, 127), (20, 20, 129), (7, 13, 4099), (130, 20, 4099)]
    for k, m, d in shapes:
        for dt in (torch.float32, torch.bfloat16):
            w = rand_rows(gen, k, m)
            theta = torch.randn((m, d), generator=gen, device="cuda").to(dt)
            ptr = nan_landing(k * d, dt)
            got = ops.mixing_aggregate(w, theta)
            if got.data_ptr() != ptr:
                raise AssertionError("mixing_aggregate: output did not land "
                                     "on the NaN fill")
            err = check_close(f"mixing_aggregate k={k} m={m} D={d} {dt}",
                              got, ref.mixing_aggregate_ref(w, theta),
                              TOL[dt], TOL[dt])
            print(f"  mixing_aggregate k={k:3d} m={m:3d} D={d:6d} "
                  f"{str(dt)[6:]:8s} max|err| {err:.2e}", flush=True)

    # ragged leaf sets, more than N_MAX leaves: one call against one-leaf
    # calls bit for bit, and against the plain version
    for dt in (torch.float32, torch.bfloat16):
        for k, m, n in ((20, 20, 10), (100, 100, 8), (5, 9, 41)):
            w = rand_rows(gen, k, m)
            thetas = ragged_leaves(gen, m, dt, n)
            before = ops.LAUNCHES["mixing_aggregate"]
            got = ops.mixing_aggregate_leaves(w, thetas)
            launched = ops.LAUNCHES["mixing_aggregate"] - before
            for y, t in zip(got, thetas):
                check_close(f"mixing_aggregate ragged k={k} m={m} {dt}", y,
                            ref.mixing_aggregate_ref(w, t), TOL[dt], TOL[dt])
                same(f"mixing_aggregate ragged k={k} m={m} {dt} vs one-leaf "
                     "call", y, ops.mixing_aggregate(w, t))
            print(f"  mixing_aggregate ragged {n} leaves (widths 1..4,099, "
                  f"misaligned bases) k={k} m={m} {str(dt)[6:]}: {launched} "
                  "launch(es), bitwise equal to one-leaf calls", flush=True)

    # the folded stream mix: centroids[assignment] in one launch equals
    # mixing to the centroids and gathering, bit for bit
    m = MAIN["m"]
    cents = rand_rows(gen, 4, m)
    assign = torch.randint(0, 4, (m,), generator=gen, device="cuda")
    stacked = {f"l{i}": t for i, t in enumerate(
        ragged_leaves(gen, m, torch.float32, 10))}
    folded = stream_aggregate(stacked, StreamPlan(cents, assign,
                                                  torch.tensor(0.0)))
    for name, v in mix_pytree(stacked, cents).items():
        same(f"stream_aggregate {name}", folded[name], v[assign])
    print("  stream_aggregate (k=4, m=20, one launch) bitwise equal to the "
          "mix-then-gather form", flush=True)

    # the main path's shapes: one ucfl round mixes the 10 LeNet leaves
    sizes = lenet_leaf_sizes()
    # and the examples': LeNet-47's ten leaves in one call at m = 12
    for k in (1, 2, 4, 12):
        w = rand_rows(gen, k, 12)
        thetas = [torch.randn((12, d), generator=gen, device="cuda")
                  for d in sizes]
        err = 0.0
        for y, t in zip(ops.mixing_aggregate_leaves(w, thetas), thetas):
            err = max(err, check_close(
                f"mixing_aggregate LeNet leaves k={k} m=12", y,
                ref.mixing_aggregate_ref(w, t), 1e-5, 1e-5))
            same(f"mixing_aggregate LeNet leaves k={k} m=12 vs one-leaf "
                 "call", y, ops.mixing_aggregate(w, t))
        print(f"  mixing_aggregate LeNet's {len(sizes)} leaves k={k:2d} m=12 "
              f"f32 max|err| {err:.2e}, bitwise equal to one-leaf calls",
              flush=True)
    row = mix_round(gen, MAIN["m"], MAIN["m"], sizes, "k=m=20 (LeNet, f32)")
    mix_round(gen, 100, 100, sizes, "k=m=100 (LeNet, f32)")
    row.update(name="mixing_aggregate", route="cuda",
               source="src/repro_torch/kernels/csrc/mixing_aggregate.cu",
               replaces="src/repro/kernels/mixing_aggregate.py:43")
    return row


def check_gram(gen) -> dict:
    row = None
    # (12, D_LENET) and (5, 16): the examples' sweeps and quickstart
    for m, d in ((20, D_LENET), (100, D_LENET), (12, D_LENET), (5, 16),
                 (17, 31), (1, 5), (33, 4099), (129, 4099)):
        g = torch.randn((m, d), generator=gen, device="cuda")
        ptr = nan_landing(2 * m * m, torch.float32)
        before = ops.LAUNCHES["gram_matrix"]
        gram = ops.gram_matrix(g)
        if gram.data_ptr() != ptr:
            raise AssertionError("gram_matrix: output did not land on the "
                                 "NaN fill")
        err = check_close(f"gram_matrix m={m} D={d}", gram, ref.gram_ref(g),
                          1e-4, 1e-2)
        if not torch.equal(gram, gram.T):
            raise AssertionError(f"gram_matrix m={m}: G not symmetric")
        for _ in range(10):
            same(f"gram_matrix m={m} D={d} repeated", ops.gram_matrix(g),
                 gram)
            delta = ops.pairwise_sqdist(g)
            # Δ from the same launch, bitwise the reference's assembly
            same(f"pairwise_sqdist m={m} D={d}", delta,
                 ref.sqdist_from_gram(gram))
        if ops.LAUNCHES["gram_matrix"] - before != 21:
            raise AssertionError("gram_matrix: not one launch a call")
        # and Δ against the plain Gram's (pairwise_sqdist_ref's separately
        # summed norms leave a cancellation residue of ~1e-2 on its diagonal
        # at this D)
        check_close(f"pairwise_sqdist m={m} D={d}", delta,
                    ref.sqdist_from_gram(ref.gram_ref(g)), 1e-4, 1e-2)
        if not torch.equal(delta, delta.T) or \
                bool(torch.any(torch.diagonal(delta) != 0)):
            raise AssertionError(f"pairwise_sqdist m={m}: Δ not symmetric "
                                 "with a zero diagonal")
        line = (f"  gram_matrix m={m:3d} D={d:6d} max|err| {err:.2e}, "
                "bitwise over 10 calls, symmetric, Δ bitwise "
                "sqdist_from_gram(G) with a zero diagonal")
        if d == D_LENET:
            b, by = bound_ms(4.0 * (m * d + 2 * m * m), m * (m + 1.0) * d)
            cur = dict(
                name="gram_matrix", route="cuda",
                source="src/repro_torch/kernels/csrc/gram.cu",
                replaces="src/repro/kernels/pairwise_sqdist.py:42",
                max_abs_err=err,
                ms=time_ms(lambda: ops.pairwise_sqdist(g)),
                plain_ms=time_ms(lambda: ref.sqdist_from_gram(
                    ref.gram_ref(g))),
                bound_ms=b, bound_by=by,
                library_ms=time_ms(lambda: torch.matmul(g, g.T)))
            plan, fit = card_plan(m, d, g.device)
            line += (f"\n    one launch G + Δ {cur['ms']:.4f} ms  plain "
                     f"{cur['plain_ms']:.4f} ms  matmul "
                     f"{cur['library_ms']:.4f} ms  bound {b:.4f} ms ({by}); "
                     f"grid {plan.blocks} blocks x {plan.threads} threads "
                     f"({fit} clusters of 8 fit at once)")
            if m == MAIN["m"]:
                row = cur
        print(line, flush=True)
    return row


def same(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Bitwise check (NaN where NaN, equal elsewhere); returns max |err|."""
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    if (got.shape != want.shape or got.dtype != want.dtype
            or not torch.equal(torch.isnan(got), nan)
            or not torch.equal(got[~nan], want[~nan])):
        raise AssertionError(f"{name}: kernel not bitwise equal to its plain "
                             "version")
    return 0.0


# the QSGD rows of [kernels]: the row pass's instances count the row
# pass's launches on the main paths, the stream's dequantize its own (the
# at-rest decode of [serve]).  The stream's quantize with absmax given
# has no caller on any path: its row counts nothing and is marked off
# the path.
ROW_PASS_COUNTERS = ("rowwise_absmax", "qsgd_quantize", "qsgd_roundtrip")


def check_channel_kernels(gen) -> list:
    """The QSGD kernels (the row pass's absmax, encode and roundtrip; the
    stream's quantize with absmax given and dequantize) and the top-k
    kernel bitwise against their plain versions on ragged shapes, bits
    2/4/8, top-k k in {1, 10, ceil(D/10), D-1, D, D+1}, an all-zero row,
    a row with one NaN, a row with an inf, rows whose scalars or
    midpoints are subnormal and rows of normal scale holding subnormal
    elements (levels compared on every row),
    each kernel on each of its paths (the QSGD row in registers or
    re-read; the top-k row in registers, shared memory or global) and at
    257 rows (clusters queue); then timed at the main path's (20, 47,571)
    with qsgd:8 and topk:0.1, the roundtrip and the top-k kernel also
    bitwise equal across calls."""
    shapes = [(MAIN["m"], D_LENET), (3, 1), (5, 1000), (7, 4099), (2, 70000),
              (257, 1000), (2, 600000), (4, 600000)]
    for m, d in shapes:
        x = torch.randn((m, d), generator=gen, device="cuda") * 3
        u = torch.rand((m, d), generator=gen, device="cuda")
        if m > 2:
            x[1] = 0.0                           # absmax 0: levels, values 0
            x[2, d // 2] = float("nan")          # absmax NaN: row all NaN
        if m > 3:
            x[3, d - 1] = float("inf")           # absmax inf: row all NaN
        if m > 7:
            # scalars below f32's normal range, flushed to 0: rows 4 and 7
            # (scale at bits 8, absmax) cross as zeros, row 5 at bits 2;
            # row 6's top-k midpoints near k = D flush to 0
            x[4] = torch.sign(x[4]) * 1e-37
            x[5] = torch.sign(x[5]) * 0.5
            x[5, d // 3] = 1.7e38
            x[6] *= 1e-37
            x[7] = 1e-40
        if m > 9:
            # subnormal elements of normal-scale rows, read as 0: row 8 is
            # 2e-36 with its odd elements 5e-39 at u = 0.9 (level 1 if they
            # were read as they are), row 9 random with every third
            # element about 1e-39
            x[8] = 2e-36
            x[8, 1::2] = 5e-39
            u[8] = 0.9
            x[9, ::3] = torch.sign(x[9, ::3]) * 1e-39
        amax = qsgd.rowwise_absmax_cuda(x)
        same(f"rowwise_absmax ({m}, {d})", amax, ref.rowwise_absmax_ref(x))
        for bits in (2, 4, 8):
            want_q, _ = ref.qsgd_quantize_ref(x, u, bits, absmax=amax)
            q = qsgd.qsgd_quantize_cuda(x, u, amax, bits)
            same(f"qsgd_quantize ({m}, {d}) bits={bits}", q, want_q)
            q_enc, amax_enc = qsgd.qsgd_encode_cuda(x, u, bits)
            same(f"qsgd_encode ({m}, {d}) bits={bits}", q_enc, want_q)
            same(f"qsgd_encode absmax ({m}, {d})", amax_enc, amax)
            deq = qsgd.qsgd_dequantize_cuda(q, amax, bits)
            same(f"qsgd_dequantize ({m}, {d}) bits={bits}", deq,
                 ref.qsgd_dequantize_ref(q, amax, bits))
            rt = qsgd.qsgd_roundtrip_cuda(x, u, bits)
            same(f"qsgd_roundtrip ({m}, {d}) bits={bits}", rt,
                 ref.qsgd_roundtrip_ref(x, u, bits))
            if m > 2 and not (bool(torch.all(q[1] == 0))
                              and bool(torch.all(rt[1] == 0))
                              and bool(torch.all(q[2] == 0))
                              and bool(torch.isnan(rt[2:4]).all())):
                raise AssertionError("qsgd: zero row not zero, or NaN / inf "
                                     "row not NaN with levels 0")
            flushed = [7] + ([4] if bits == 8 else []) + \
                ([5] if bits == 2 else [])
            if m > 7 and not bool(torch.all(rt[flushed] == 0)):
                raise AssertionError(f"qsgd bits={bits}: a row with a "
                                     "subnormal scalar did not cross as "
                                     "zeros")
            if m > 9 and not (bool(torch.all(q_enc[8, 1::2] == 0))
                              and bool(torch.all(q_enc[9, ::3] == 0))
                              and bool(torch.all(q[8:10][
                                  x[8:10].abs() < ref.FLT_MIN] == 0))):
                raise AssertionError(f"qsgd bits={bits}: a subnormal "
                                     "element of a normal row did not get "
                                     "level 0")
        absx = x.abs()
        if m > 2:
            absx[2, d // 2] = 0.0
        if m > 3:
            absx[3, d - 1] = 0.0
        for k in sorted({1, 10, -(-d // 10), max(1, d - 1), d, d + 1}):
            t = topk_threshold_cuda(absx, k)
            same(f"topk_threshold ({m}, {d}) k={k}", t,
                 ref.topk_threshold_ref(absx, k))
            if k <= d:
                kth = torch.kthvalue(absx, d - k + 1, dim=1,
                                     keepdim=True).values
                if not (bool(torch.all(t <= kth))
                        and bool(torch.all((absx >= t).sum(1) >= k))):
                    raise AssertionError(f"topk_threshold ({m}, {d}) k={k}: "
                                         "above the k-th value or < k kept")
            elif bool(torch.any(t != 0)):
                raise AssertionError(f"topk_threshold k={k} > D not 0")
        print(f"  channel kernels ({m:3d}, {d:6d}): qsgd absmax, encode, "
              f"roundtrip (row in {qsgd.row_path(d)}), quantize, dequantize "
              f"(bits 2/4/8), topk_threshold bitwise equal (top-k row in "
              f"{row_path(d)})", flush=True)
    paths = [row_path(d) for d in (D_LENET, 70000, 600000)]
    if paths != ["registers", "shared", "global"]:
        raise AssertionError(f"topk_threshold: unexpected paths {paths}")
    paths = [qsgd.row_path(d) for d in (D_LENET, 70000)]
    if paths != ["registers", "global"]:
        raise AssertionError(f"qsgd row pass: unexpected paths {paths}")

    m, d, bits = MAIN["m"], D_LENET, 8
    x = torch.randn((m, d), generator=gen, device="cuda") * 1e-2
    u = torch.rand((m, d), generator=gen, device="cuda")
    amax = qsgd.rowwise_absmax_cuda(x)
    q = qsgd.qsgd_quantize_cuda(x, u, amax, bits)
    scale = amax * ref.qsgd_levels(bits)[1].cuda()
    k = -(-d // 10)
    absx = x.abs()
    md, b4 = m * d, 4 * m
    rt_ref = ref.qsgd_roundtrip_ref(x, u, bits)
    # (name, source, TPU kernel, kernel, plain, library call or None,
    #  bytes, operations, check, counters of its launches)
    specs = [
        ("rowwise_absmax", "quantize.cu", "quantize.py:59",
         lambda: qsgd.rowwise_absmax_cuda(x),
         lambda: ref.rowwise_absmax_ref(x),
         lambda: torch.linalg.vector_norm(x, math.inf, dim=1),
         4 * md + b4, md,
         lambda: same("absmax", qsgd.rowwise_absmax_cuda(x),
                      ref.rowwise_absmax_ref(x)), ROW_PASS_COUNTERS),
        ("qsgd_quantize", "quantize.cu", "quantize.py:104",
         lambda: qsgd.qsgd_quantize_cuda(x, u, amax, bits),
         lambda: ref.qsgd_quantize_ref(x, u, bits, absmax=amax),
         None, 12 * md + b4, 5 * md,
         lambda: same("quantize", qsgd.qsgd_quantize_cuda(x, u, amax, bits),
                      ref.qsgd_quantize_ref(x, u, bits, absmax=amax)[0]),
         ()),
        ("qsgd_dequantize", "quantize.cu", "quantize.py:136",
         lambda: qsgd.qsgd_dequantize_cuda(q, amax, bits),
         lambda: ref.qsgd_dequantize_ref(q, amax, bits),
         lambda: torch.mul(q, scale), 8 * md + b4, 2 * md,
         lambda: same("dequantize", qsgd.qsgd_dequantize_cuda(q, amax, bits),
                      ref.qsgd_dequantize_ref(q, amax, bits)),
         ("qsgd_dequantize",)),
        ("qsgd_encode", "quantize.cu", "quantize.py:104",
         lambda: qsgd.qsgd_encode_cuda(x, u, bits),
         lambda: ref.qsgd_quantize_ref(x, u, bits),
         None, 12 * md + b4, 6 * md,
         lambda: same("encode", qsgd.qsgd_encode_cuda(x, u, bits)[0],
                      ref.qsgd_quantize_ref(x, u, bits)[0]),
         ROW_PASS_COUNTERS),
        ("qsgd_roundtrip", "quantize.cu", "quantize.py:136",
         lambda: qsgd.qsgd_roundtrip_cuda(x, u, bits),
         lambda: ref.qsgd_roundtrip_ref(x, u, bits),
         None, 12 * md, 8 * md,
         lambda: same("roundtrip", qsgd.qsgd_roundtrip_cuda(x, u, bits),
                      rt_ref)
         + same("roundtrip across calls", qsgd.qsgd_roundtrip_cuda(x, u, bits),
                qsgd.qsgd_roundtrip_cuda(x, u, bits)), ROW_PASS_COUNTERS),
        ("topk_threshold", "topk_threshold.cu", "topk_threshold.py:60",
         lambda: topk_threshold_cuda(absx, k),
         lambda: ref.topk_threshold_ref(absx, k),
         lambda: torch.kthvalue(absx, d - k + 1, dim=1),
         4 * md + b4, (ref.TOPK_ITERS + 1) * md,
         lambda: same("topk", topk_threshold_cuda(absx, k),
                      ref.topk_threshold_ref(absx, k))
         + same("topk across calls", topk_threshold_cuda(absx, k),
                topk_threshold_cuda(absx, k)), ("topk_threshold",)),
    ]
    rows = []
    for (name, src, tpu, kern, plain, lib, n_bytes, n_ops, check,
         counters) in specs:
        err = check()
        b, by = bound_ms(n_bytes, n_ops)
        row = dict(name=name, route="cuda",
                   source=f"src/repro_torch/kernels/csrc/{src}",
                   replaces=f"src/repro/kernels/{tpu}", max_abs_err=err,
                   ms=time_ms(kern), plain_ms=time_ms(plain), bound_ms=b,
                   bound_by=by,
                   library_ms=None if lib is None else time_ms(lib),
                   counters=counters, off_path=not counters)
        lib_s = ("none" if row["library_ms"] is None
                 else f"{row['library_ms']:.4f} ms")
        print(f"  {name} ({m}, {d}) f32: kernel {row['ms']:.4f} ms  plain "
              f"{row['plain_ms']:.4f} ms  library {lib_s}  bound {b:.4f} ms "
              f"({by})", flush=True)
        rows.append(row)
    # what these times stand on: the timer's floor (a kernel that does
    # nothing) and one PyTorch elementwise kernel over the roundtrip's
    # bytes (read x and u, write (m, D) f32), which computes another
    # function
    y = torch.empty_like(x)
    empty = time_ms(lambda: torch.cuda._sleep(0))
    add = time_ms(lambda: torch.add(x, u, out=y))
    print(f"  floors: an empty kernel {empty:.4f} ms; torch.add(x, u) over "
          f"the roundtrip's bytes {add:.4f} ms", flush=True)
    return rows


def flash_inputs(gen, b, h, kh, sq, sk, hd, dtype, cache_len=None,
                 logit_std=LOGIT_STD, dv=None):
    """q as the model hands it over, (B, Sq, H, hd) transposed; k, v the
    first Sk slots of a (B, C, Kh, hd) cache, transposed (strided views,
    as on the main path); v of head dim ``dv`` where given (default hd).
    q and k have variance ``logit_std``, so the scaled logits q·k/√hd
    have standard deviation ``logit_std``."""
    c = sk if cache_len is None else cache_len
    a = math.sqrt(logit_std)
    q = torch.randn((b, sq, h, hd), generator=gen, device="cuda") * a
    k = torch.randn((b, c, kh, hd), generator=gen, device="cuda") * a
    v = torch.randn((b, c, kh, hd if dv is None else dv), generator=gen,
                    device="cuda")
    return (q.to(dtype).transpose(1, 2), k[:, :sk].to(dtype).transpose(1, 2),
            v[:, :sk].to(dtype).transpose(1, 2))


def flash_bound(q, k, kw, v=None):
    """(bound ms, what bounds it, FLOP) of one call: each input read and
    the output written once; 2·(dk + dv) FLOP per kept pair (4·hd where
    v is k's width) at the inputs' peak (bf16 tensor cores, or f32
    outside them)."""
    b, h, sq, hd = q.shape
    dv = hd if v is None else v.shape[3]
    n_v = k.numel() if v is None else v.numel()
    n_bytes = (q.numel() + k.numel() + n_v + q.numel() // hd * dv) * \
        q.element_size()
    flops = 2.0 * (hd + dv) * b * h * ops.attn_pairs(
        sq, k.shape[2], kw["causal"], kw.get("window"),
        kw.get("prefix_len", 0))
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    return (*bound_ms(n_bytes, flops, peak), flops)


def sdpa_ms(q, k, v, causal: bool) -> float:
    """The yardstick the port never calls: one SDPA call on contiguous
    copies of the same inputs, without the softcap (SDPA has none).  Its
    causal mask is top-left aligned, so a decode step (Sq 1 over its
    valid keys) is timed with is_causal=False: the same keys."""
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    return time_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=causal, enable_gqa=True))


def row_rel_err(got, want) -> float:
    """max over output rows of ‖got − want‖ / ‖want‖: the error against
    the output's size."""
    g, w = got.float(), want.float()
    return float((torch.linalg.vector_norm(g - w, dim=-1) /
                  torch.linalg.vector_norm(w, dim=-1).clamp_min(1e-30)).max())


def flash_close(name, got, want) -> tuple:
    """check_close at FLASH_TOL of got's dtype, and each output row's
    error within the same tolerance relative to the row's norm (a
    near-uniform softmax gives entries smaller than the atol, which alone
    would pass them).  Returns (max |err|, max row-relative error)."""
    tol = FLASH_TOL[got.dtype]
    err = check_close(name, got, want, tol, tol)
    rel = row_rel_err(got, want)
    if not rel <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version, row-relative error {rel:.3e}")
    return err, rel


def route_kernel(q, v):
    """The wrapper of the kernel `flash_route` sends (q, v) to (no
    count)."""
    return ops.FLASH_KERNELS[flash_route(q.dtype, q.shape[2], q.shape[3],
                                         v.shape[3])][0]


def flash_planted_fault(name, q, k, v, kw, want) -> None:
    """The check must be able to fail: on logits past the cap, the route's
    kernel run without its softcap against the plain version with it
    passes neither flash_close's elementwise nor its row-relative test."""
    bad = route_kernel(q, v)(q, k, v, **dict(kw, softcap=None))
    torch.cuda.synchronize()
    tol = FLASH_TOL[q.dtype]
    d = (bad.float() - want.float()).abs()
    if bool(torch.all(d <= tol + tol * want.float().abs())) or \
            row_rel_err(bad, want) <= tol:
        raise AssertionError(f"{name}: the kernel without its softcap "
                             "passes the check; the inputs cannot tell")


def attention_f64(q, k, v, causal, window=None, softcap=None,
                  prefix_len=0):
    """Attention computed in float64 throughout: the yardstick of the f32
    ragged checks, since the plain version's own f32 rounding of large
    logits (q·k summed over up to 256 products) exceeds the f32
    tolerance now and then; rows with no valid key 0."""
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    qg = q.double().reshape(b, kh, h // kh, sq, hd)
    lg = torch.einsum("bkgqh,bksh->bkgqs", qg, k.double()) / hd ** 0.5
    if softcap:
        lg = softcap * torch.tanh(lg / softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=q.device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        valid &= (k_pos <= q_pos) | (k_pos < prefix_len)
    if window:
        valid &= k_pos > q_pos - window
    p = torch.softmax(lg.masked_fill(~valid, -1e300), -1)
    out = torch.einsum("bkgqs,bksh->bkgqh", p, v.double())
    return out.masked_fill(~valid.any(-1)[:, None], 0.0).reshape(
        b, h, sq, v.shape[3])


def ragged_yardstick(q, k, v, kw, tally: dict):
    """What a ragged check holds a flash call to: the plain version in
    bf16; in f32, attention in float64 at the same f32 tolerance, the
    plain version counted in ``tally`` (inputs, and those where the plain
    version itself lies outside that tolerance of float64)."""
    plain = ref.flash_attention_ref(q, k, v, **kw)
    if q.dtype != torch.float32:
        return plain
    exact = attention_f64(q, k, v, **kw)
    tol = FLASH_TOL[torch.float32]
    d = (plain.double() - exact).abs()
    tally["inputs"] += 1
    tally["plain outside"] += int(bool((d > tol + tol * exact.abs()).any())
                                  or row_rel_err(plain, exact) > tol)
    return exact


def check_flash(gen) -> list:
    """flash_attention against its plain version at the [lm] shapes
    (global and local prefill, decode over a cache slice and over a
    wrapped ring) in f32 and bf16, so every route of `flash_route` runs:
    decode steps on the split-key decode kernel, bf16 prefill on the
    tensor-core kernel, f32 prefill on the CUDA-core kernel; in bf16 also
    on inputs whose logits reach the softcap, where the route's kernel run
    without its softcap must fail the check; each call also through the
    route's own wrapper (the decode kernel bitwise equal to the op's
    call).  The same at [lm] (c)'s prefill shapes (gemma-2b: B 2, H 8,
    Kh 1, S 8,160, hd 256; stablelm-3b: B 2, H 32, Kh 32, S 4,064, hd 80;
    olmoe-1b-7b: B 2, H 16, Kh 16, S 4,064, hd 128; causal, slices of the
    serving cache) in bf16, without a softcap (none of them has one) at
    both logit scales and with softcap 50 at the capped one.  Then the
    tensor-core kernel on ragged
    bf16 shapes (hd 64/80/128/256, GQA group 1/2/8, Sq < Sk, windows
    1/63/4,096,
    softcap on and off, non-causal), the op on ragged shapes at hd
    40/64/80/136/256 in both dtypes, and the decode kernel on ragged decode
    shapes (hd 64/80/128/256, G 1/2/8, Sq 1/3/16, Sk 1/70/4,609, 1, 2 and
    Sk splits), each at both logit scales; the f32 ragged calls against
    attention in float64 (`ragged_yardstick`), the bf16 ones against the
    plain version.  Timed at the [lm] shapes in
    bf16, the main path's dtype, and at the global prefill in f32 too:
    the kernel each route takes, its plain version and SDPA, and the
    CUDA-core kernel at the same shape (the other routes' "before"); in
    f32 also at the local prefill (window 4,096), each with the CUDA-core
    kernel timed again without its softcap (the softcap's share), and the
    CUDA-core kernel bitwise equal across calls; the decode kernel at
    other split counts; and the two prefill kernels at
    short queries over the [lm] cache, either side of the route's
    threshold.  Returns the JSON rows of the kernels, each on its own
    route: the decode kernel at the bf16 global decode step, the
    tensor-core kernel at the bf16 global prefill and at [lm] (c)'s two
    prefills (their launches come from [lm] (c)), the CUDA-core kernel at
    the f32 global prefill ([lm] (b)'s)."""
    a = get_config(LM["arch"]).attn
    b, s, h, kh, hd = LM["batch"], LM["prompt"], a.n_heads, a.n_kv_heads, \
        a.head_dim
    cap, win = a.attn_logit_softcap, a.window
    scales = ((torch.float32, LOGIT_STD), (torch.bfloat16, LOGIT_STD),
              (torch.bfloat16, CAP_LOGIT_STD))

    def lm_runs(kw):
        return [(dt, std, kw) for dt, std in scales]

    # (name, (B, H, Kh, Sq, Sk, hd), cache length, runs of (dtype, logit
    # sd, kw), {route: JSON row}, the [lm] (c) config the row counts in)
    cases = [
        ("global prefill", (b, h, kh, s, s, hd), None,
         lm_runs(dict(causal=True, softcap=cap)),
         {"tc": "flash_attention_tc", "cuda_core": "flash_attention"}, None),
        ("local prefill", (b, h, kh, s, s, hd), None,
         lm_runs(dict(causal=True, window=win, softcap=cap)), {}, None),
        ("global decode", (b, h, kh, 1, s + 1, hd), LM["cache_len"],
         lm_runs(dict(causal=True, softcap=cap)),
         {"decode": "flash_attention_decode"}, None),
        ("local decode (wrapped ring)", (b, h, kh, 1, win, hd), None,
         lm_runs(dict(causal=True, window=win, softcap=cap)), {}, None),
    ]
    for c in LM_C:
        # MLA's pair: `check_flash_mla`; nemotron's heads:
        # `check_flash_nemotron`; zamba2's prefill is stablelm-3b's shape
        if not c.get("flash_row"):
            continue
        ac = get_config(c["arch"]).attn
        cases.append((
            f"{c['arch']} prefill", (c["batch"], ac.n_heads, ac.n_kv_heads,
                                     c["prompt"], c["prompt"], ac.head_dim),
            c["cache_len"],
            [(torch.bfloat16, LOGIT_STD, dict(causal=True)),
             (torch.bfloat16, CAP_LOGIT_STD, dict(causal=True)),
             (torch.bfloat16, CAP_LOGIT_STD, dict(causal=True, softcap=50.0))],
            {"tc": f"flash_attention_tc_hd{ac.head_dim}"}, c["arch"]))
    sources = {"decode": "flash_decode.cu", "tc": "flash_attention_tc.cu",
               "cuda_core": "flash_attention.cu"}
    rows = {}
    for name, shape, clen, runs, row_names, phase in cases:
        for dt, std, kw in runs:
            q, k, v = flash_inputs(gen, *shape, dt, cache_len=clen,
                                   logit_std=std)
            route = flash_route(dt, shape[3], shape[5])
            counter = ops.FLASH_COUNTERS[route]
            before = dict(ops.LAUNCHES)
            got = ops.flash_attention(q, k, v, **kw)
            launched = {c: ops.LAUNCHES[c] - before[c] for c in before
                        if ops.LAUNCHES[c] != before[c]}
            if launched != {counter: 1}:
                raise AssertionError(f"flash_attention {name} {dt}: "
                                     f"launches {launched}, want "
                                     f"{{{counter!r}: 1}}")
            want = ref.flash_attention_ref(q, k, v, **kw)
            tag = f"flash_attention {name} {dt} logit sd {std:g} {kw}"
            err, rel = flash_close(tag, got, want)
            line = (f"  flash_attention {name:27s} B={shape[0]} H={shape[1]} "
                    f"Kh={shape[2]} Sq={shape[3]:4d} Sk={shape[4]:4d} "
                    f"hd={shape[5]} {str(dt)[6:]:8s} logit sd {std:4g} "
                    f"softcap {kw.get('softcap')} route {route:9s} "
                    f"max|err| {err:.2e} row-rel {rel:.2e}")
            own = route_kernel(q, v)(q, k, v, **kw)
            if route in ("decode", "cuda_core"):
                if not torch.equal(got, own):
                    raise AssertionError(f"flash {route} {name} {dt}: two "
                                         "calls differ")
                line += "  bitwise equal across calls"
            else:
                err_o, rel_o = flash_close(tag + " (own wrapper)", own, want)
                line += (f"  own wrapper max|err| {err_o:.2e} row-rel "
                         f"{rel_o:.2e}")
            del got, own
            if route != "cuda_core":
                err13, _ = flash_close(tag + " (CUDA-core kernel)",
                                       flash_attention_cuda(q, k, v, **kw),
                                       want)
                line += f"  CUDA-core kernel max|err| {err13:.2e}"
            if std == CAP_LOGIT_STD:
                if kw.get("softcap"):
                    flash_planted_fault(tag, q, k, v, kw, want)
                    line += "  without its softcap: fails the check"
            elif dt == torch.bfloat16 or name in ("global prefill",
                                                  "local prefill"):
                # every bf16 shape, and f32 at the prefills: the CUDA-core
                # kernel's own route ([lm] (b))
                bnd, by, flops = flash_bound(q, k, kw)
                ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
                plain = time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                                 **kw),
                                iters=5)
                prefill = shape[3] > 1
                lib = sdpa_ms(q, k, v, causal=prefill)
                what = ("causal" if prefill else "over the valid keys") + \
                    ", no softcap" + (", no window" if "window" in kw else "")
                ms13 = ms if route == "cuda_core" else time_ms(
                    lambda: flash_attention_cuda(q, k, v, **kw))
                if route == "cuda_core":
                    nocap = time_ms(lambda: flash_attention_cuda(
                        q, k, v, **dict(kw, softcap=None)))
                    line += (f"  without its softcap {nocap:.4f} ms (the "
                             f"softcap's share {1 - nocap / ms:.1%})")
                line += (f"  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
                         f"bound {bnd:.4f} ms ({by}, {flops:.3e} FLOP, "
                         f"{flops / ms / 1e9:.1f} TFLOP/s, {bnd / ms:.1%} of "
                         f"it)  SDPA ({what}) {lib:.4f} ms  CUDA-core kernel "
                         f"{ms13:.4f} ms")
                if route == "decode":
                    ns = decode_splits(shape[0], shape[2], shape[4],
                                       torch.cuda.get_device_properties(0)
                                       .multi_processor_count)
                    line += f"  ({ns} splits; at " + ", ".join(
                        f"{n}: {time_ms(lambda: flash_decode_cuda(q, k, v, n_split=n, **kw)):.4f} ms"
                        for n in (1, 4, 9, 16, 24, 48)) + ")"
                    # the model's cache is (B, C, Kh, hd): a head's keys
                    # lie Kh·hd apart; SDPA above reads contiguous copies
                    qc, kc, vc = (t.contiguous() for t in (q, k, v))
                    line += ("  on contiguous copies "
                             f"{time_ms(lambda: flash_decode_cuda(qc, kc, vc, **kw)):.4f} ms")
                    del qc, kc, vc
                if route in row_names:
                    rows[row_names[route]] = dict(
                        name=row_names[route], route="cuda",
                        source="src/repro_torch/kernels/csrc/" +
                        sources[route],
                        replaces="src/repro/kernels/flash_attention.py:118",
                        counter=counter, max_abs_err=err, ms=ms,
                        plain_ms=plain, bound_ms=bnd, bound_by=by,
                        library_ms=lib,
                        **({"phase": phase} if phase else {}))
            del want
            print(line, flush=True)
            del q, k, v
        torch.cuda.empty_cache()
    # the route's Sq threshold: both kernels over the [lm] global layer's
    # cache at the shortest queries the tensor-core kernel takes and longer
    for sq in (17, 32, 64, 128):
        q, k, v = flash_inputs(gen, b, h, kh, sq, s, hd, torch.bfloat16,
                               cache_len=LM["cache_len"])
        kw = dict(causal=True, softcap=cap)
        print(f"  flash_attention route threshold: B={b} H={h} Kh={kh} "
              f"Sq={sq:3d} Sk={s} hd={hd} bf16: tensor-core kernel "
              f"{time_ms(lambda: flash_attention_tc_cuda(q, k, v, **kw)):.4f}"
              f" ms  CUDA-core kernel "
              f"{time_ms(lambda: flash_attention_cuda(q, k, v, **kw)):.4f} "
              "ms", flush=True)
        del q, k, v
    n_tc = ops.LAUNCHES["flash_attention_tc"]
    n_checks = n_faults = 0
    for hd in (64, 80, 128, 256):
        for group in (1, 2, 8):
            for sq, sk in ((37, 101), (77, 77), (130, 130), (200, 333),
                           (80, 64), (96, 40)):
                for std, kws in (
                        (LOGIT_STD, (dict(causal=False),
                                     dict(causal=True),
                                     dict(causal=True, window=1),
                                     dict(causal=True, window=63,
                                          softcap=30.0),
                                     dict(causal=True, window=4096,
                                          softcap=50.0))),
                        (CAP_LOGIT_STD, (dict(causal=False, softcap=50.0),
                                         dict(causal=True, softcap=50.0),
                                         dict(causal=True, window=63,
                                              softcap=30.0),
                                         dict(causal=True, window=4096,
                                              softcap=50.0)))):
                    q, k, v = flash_inputs(gen, 2, 2 * group, 2, sq, sk, hd,
                                           torch.bfloat16,
                                           cache_len=sk + 9, logit_std=std)
                    for kw in kws:
                        tag = (f"flash_attention (tc) hd={hd} G={group} "
                               f"Sq={sq} Sk={sk} logit sd {std:g} {kw}")
                        want = ref.flash_attention_ref(q, k, v, **kw)
                        flash_close(tag, ops.flash_attention(q, k, v, **kw),
                                    want)
                        n_checks += 1
                        if std == CAP_LOGIT_STD:
                            flash_planted_fault(tag, q, k, v, kw, want)
                            n_faults += 1
    if ops.LAUNCHES["flash_attention_tc"] - n_tc != n_checks:
        raise AssertionError("ragged bf16 prefill did not all take the "
                             "tensor-core route")
    print(f"  flash_attention (tensor cores) ragged: bf16, hd 64/80/128/256 "
          f"x GQA group 1/2/8 x (Sq, Sk) (37, 101), (77, 77), (130, 130), "
          f"(200, 333), (80, 64), (96, 40) (Sq > Sk: rows with no key), "
          f"cache slices transposed; logit sd {LOGIT_STD:g}: "
          f"non-causal, causal, window 1, window 63 + softcap 30, window "
          f"4096 + softcap 50; logit sd {CAP_LOGIT_STD:g}: the same with "
          f"softcaps, non-causal with softcap 50: {n_checks} checks within "
          f"tolerance, {n_faults} without the softcap fail it", flush=True)
    n_faults = 0
    tally = {"inputs": 0, "plain outside": 0}
    for hd in (40, 64, 80, 136, 256):
        for group in (1, 2, 8):
            for dt in (torch.float32, torch.bfloat16):
                for sq, sk in ((37, 101), (1, 70), (130, 130), (80, 64),
                               (96, 40)):
                    for std, kws in (
                            (LOGIT_STD, (dict(causal=False),
                                         dict(causal=True, window=48,
                                              softcap=30.0),
                                         dict(causal=True))),
                            (CAP_LOGIT_STD, (dict(causal=False,
                                                  softcap=50.0),
                                             dict(causal=True, window=48,
                                                  softcap=30.0)))):
                        q, k, v = flash_inputs(gen, 2, 2 * group, 2, sq, sk,
                                               hd, dt, logit_std=std)
                        for kw in kws:
                            tag = (f"flash_attention hd={hd} G={group} "
                                   f"Sq={sq} Sk={sk} logit sd {std:g} {kw} "
                                   f"{dt}")
                            want = ragged_yardstick(q, k, v, kw, tally)
                            flash_close(tag, ops.flash_attention(q, k, v,
                                                                 **kw), want)
                            flash_close(tag + " (CUDA-core kernel)",
                                        flash_attention_cuda(q, k, v, **kw),
                                        want)
                            if std == CAP_LOGIT_STD:
                                flash_planted_fault(tag, q, k, v, kw, want)
                                n_faults += 1
    print("  flash_attention ragged: hd 40/64/80/136/256 x GQA group 1/2/8 "
          "x f32/bf16 x (Sq, Sk) (37, 101), (1, 70), (130, 130), (80, 64), "
          "(96, 40), through the op (each on its route) and on the "
          "CUDA-core kernel; non-causal, causal + window 48 + softcap 30 "
          f"and causal at logit sd {LOGIT_STD:g}, non-causal + softcap 50 "
          f"and causal + window 48 + softcap 30 at logit sd "
          f"{CAP_LOGIT_STD:g}: all within tolerance (bf16 of the plain "
          f"version, f32 of float64 attention), {n_faults} without the "
          f"softcap fail it; the f32 plain version itself lies outside "
          f"the f32 tolerance of float64 on {tally['plain outside']} of "
          f"{tally['inputs']} f32 inputs", flush=True)
    n_dec = ops.LAUNCHES["flash_attention_decode"]
    n_checks = n_ops = n_faults = 0
    tally = {"inputs": 0, "plain outside": 0}
    for hd in (64, 80, 128, 256):
        for group in (1, 2, 8):
            for dt in (torch.float32, torch.bfloat16):
                for sq in (1, 3, 16):
                    for sk in (1, 70, 4609):
                        for std, kws in (
                                (LOGIT_STD, (dict(causal=False),
                                             dict(causal=True, window=48,
                                                  softcap=30.0))),
                                (CAP_LOGIT_STD, (dict(causal=False,
                                                      softcap=30.0),
                                                 dict(causal=True,
                                                      window=48,
                                                      softcap=30.0)))):
                            if std == CAP_LOGIT_STD and sk == 1:
                                continue    # one key: no softcap to tell
                            q, k, v = flash_inputs(gen, 2, 2 * group, 2, sq,
                                                   sk, hd, dt,
                                                   cache_len=sk + 5,
                                                   logit_std=std)
                            for kw in kws:
                                tag = (f"flash_decode hd={hd} G={group} "
                                       f"Sq={sq} Sk={sk} logit sd {std:g} "
                                       f"{kw} {dt}")
                                want = ragged_yardstick(q, k, v, kw, tally)
                                flash_close(tag, ops.flash_attention(
                                    q, k, v, **kw), want)
                                n_ops += 1
                                if std == CAP_LOGIT_STD:
                                    flash_planted_fault(tag, q, k, v, kw,
                                                        want)
                                    n_faults += 1
                                    continue
                                for ns in (1, 2, sk):
                                    flash_close(f"{tag} n_split={ns}",
                                                flash_decode_cuda(
                                                    q, k, v, n_split=ns,
                                                    **kw), want)
                                    n_checks += 1
                                if kw["causal"] and sq > sk and \
                                        bool(want[:, :, :sq - sk].any()):
                                    raise AssertionError(f"{tag}: rows with "
                                                         "no key are not 0")
    if ops.LAUNCHES["flash_attention_decode"] - n_dec != n_ops:
        raise AssertionError("ragged decode did not all take the decode "
                             "route")
    print(f"  flash_attention (decode kernel) ragged: hd 64/80/128/256 x GQA "
          f"group 1/2/8 x f32/bf16 x Sq 1/3/16 x Sk 1/70/4609 (Sk < Sq "
          f"included), cache slices transposed; logit sd {LOGIT_STD:g}: "
          f"non-causal and causal + window 48 + softcap 30, through the op "
          f"and at 1, 2 and Sk splits; logit sd {CAP_LOGIT_STD:g} (Sk > 1): "
          f"non-causal + softcap 30 and causal + window 48 + softcap 30: "
          f"{n_ops + n_checks} checks within tolerance (bf16 of the plain "
          f"version, f32 of float64 attention), {n_faults} without the "
          f"softcap fail it; the f32 plain version itself lies outside the "
          f"f32 tolerance of float64 on {tally['plain outside']} of "
          f"{tally['inputs']} f32 inputs", flush=True)
    order = ("flash_attention_decode", "flash_attention_tc",
             "flash_attention") + tuple(
        f"flash_attention_tc_hd{get_config(c['arch']).attn.head_dim}"
        for c in LM_C if c.get("flash_row"))
    return [rows[r] for r in order]


def check_flash_vmap(gen) -> None:
    """The flash op under `torch.func.vmap` (the per-user decode's call:
    each user's rows a batch row, with that user's own keys) at
    FLASH_VMAP's shapes: one launch for all the users, bitwise the
    per-user calls (the decode kernel's split count is one user's); its
    ms beside the per-user calls' sum.  These launches are the check's,
    not a path's."""
    from torch.func import vmap
    for name, u, (h, kh, sq, sk, hd), dt in FLASH_VMAP:
        q, k, v = (t.unsqueeze(1) for t in flash_inputs(
            gen, u, h, kh, sq, sk, hd, dt))
        kw = dict(causal=True)
        fn = vmap(lambda a, b, c: ops.flash_attention(a, b, c, **kw))
        with ops.launches_set_aside() as made:
            got = fn(q, k, v)
            torch.cuda.synchronize()
        counter = ops.FLASH_COUNTERS[flash_route(dt, sq, hd)]
        if made != {counter: 1}:
            raise AssertionError(f"flash vmap {name}: launches {made}, want "
                                 f"{{{counter!r}: 1}}")
        with ops.launches_set_aside():
            for i in range(u):
                one = ops.flash_attention(q[i], k[i], v[i], **kw)
                if not torch.equal(got[i], one):
                    raise AssertionError(f"flash vmap {name}: user {i} "
                                         "differs from its own call")
            ms = time_ms(lambda: fn(q, k, v))
            each = time_ms(lambda: [ops.flash_attention(q[i], k[i], v[i],
                                                        **kw)
                                    for i in range(u)])
        splits = ""
        if sq <= 16:
            n_sm = torch.cuda.get_device_properties(0).multi_processor_count
            splits = (f", decode splits {decode_splits(1, kh, sk, n_sm)} "
                      f"(a user's) where {u} rows would take "
                      f"{decode_splits(u, kh, sk, n_sm)}")
        print(f"  flash_attention under vmap, {name}: {u} users x (H={h} "
              f"Kh={kh} Sq={sq} Sk={sk} hd={hd}) {str(dt)[6:]}: one "
              f"{counter} launch, bitwise the per-user calls{splits}; "
              f"{ms:.4f} ms against {each:.4f} for {u} calls", flush=True)


def sdpa_backend_ms(q, k, v, causal: bool, attn_mask=None) -> tuple:
    """One SDPA call on contiguous copies of the same inputs, as
    `sdpa_ms` (or with a boolean ``attn_mask``, True where a key is
    seen): (ms, the backend that ran, named from its device kernels in a
    profiler trace), or (None, why) where SDPA refuses the shape."""
    qc, kc, vc = (t.contiguous() for t in (q, k, v))

    def call():
        return F.scaled_dot_product_attention(qc, kc, vc, attn_mask=attn_mask,
                                              is_causal=causal,
                                              enable_gqa=True)
    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, f"refused ({str(e).splitlines()[0][:100]})"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = [e.name.lower() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if any("fmha_cutlass" in n or "efficient" in n for n in names):
        backend = "efficient (CUTLASS fmha)"
    elif any("cudnn" in n for n in names):
        backend = "cuDNN"
    elif any("flash" in n for n in names):
        backend = "flash"
    elif names:
        backend = "math (unfused products and softmax)"
    else:
        backend = "not traced"
    return time_ms(call, iters=10), backend


def mla_flash_inputs(gen, b, h, sq, sk, dk, dv, dtype, logit_std=LOGIT_STD):
    """MLA's naive-path operands as `_mla_attention` hands them over: q
    (B, Sq, H, dk) and k (B, Sk, H, dk) transposed, v the tail of the
    (B, Sk, H, nope + dv) expansion (nope = dk − 64, rope 64), transposed;
    Kh = H."""
    a = math.sqrt(logit_std)
    q = torch.randn((b, sq, h, dk), generator=gen, device="cuda") * a
    k = torch.randn((b, sk, h, dk), generator=gen, device="cuda") * a
    kv = torch.randn((b, sk, h, dk - 64 + dv), generator=gen,
                     device="cuda")
    return (q.to(dtype).transpose(1, 2), k.to(dtype).transpose(1, 2),
            kv.to(dtype)[..., dk - 64:].transpose(1, 2))


def check_flash_mla(gen) -> list:
    """The three flash kernels at a value head dim dv apart from the
    query/key head dim dk (MLA's naive path): on ragged shapes at dk 24 /
    dv 16 (the smoke config's) and dk 192 / dv 128 (the published pair),
    and at nemotron-4-340b's dk = dv 192 (the tensor-core kernel's
    (192, 192) instance), f32 and bf16, Kh = H and GQA group 4, Sq 1/3/16 (decode) and
    17/77/130/96 (prefill, 96 over 40 keys), both logit scales, through
    the op (each on its route) and on every kernel that takes the shape
    (the CUDA-core kernel always, the decode kernel at 1, 2 and Sk
    splits, the tensor-core kernel at (192, 128) in bf16); f32 against
    float64 attention, bf16 against the plain version; past the softcap
    each route's kernel also fails without it.  Then MLA's two full
    shapes at its published heads (B 2, H = Kh = 128, dk 192, dv 128,
    bf16): the prefill of 4,064 on the tensor cores (held on the first 16
    heads at full S, where the plain version's f32 logits take 2 GB;
    timed at all 128, the plain version head-chunked by 16) and a decode
    step over 4,096 keys, each timed beside its bound and SDPA (its
    backend named).  Returns the two JSON rows, counted in [lm] (c)'s
    deepseek run."""
    n0 = dict(ops.LAUNCHES)
    n_ops = n_checks = n_faults = 0
    tally = {"inputs": 0, "plain outside": 0}
    for dk, dv in ((24, 16), (192, 128), (192, 192)):
        for dt in (torch.float32, torch.bfloat16):
            for h, kh in ((4, 4), (8, 2)):
                for sq, sk in ((1, 70), (3, 333), (16, 40), (17, 300),
                               (77, 77), (130, 130), (96, 40)):
                    for std, kws in (
                            (LOGIT_STD, (dict(causal=False),
                                         dict(causal=True),
                                         dict(causal=True, window=48,
                                              softcap=30.0))),
                            (CAP_LOGIT_STD, (dict(causal=True,
                                                  softcap=50.0),))):
                        q, k, v = flash_inputs(gen, 2, h, kh, sq, sk, dk,
                                               dt, cache_len=sk + 5,
                                               logit_std=std, dv=dv)
                        route = flash_route(dt, sq, dk, dv)
                        for kw in kws:
                            tag = (f"flash dk={dk} dv={dv} H={h} Kh={kh} "
                                   f"Sq={sq} Sk={sk} logit sd {std:g} "
                                   f"{kw} {dt}")
                            want = ragged_yardstick(q, k, v, kw, tally)
                            got = ops.flash_attention(q, k, v, **kw)
                            if got.shape != (2, h, sq, dv):
                                raise AssertionError(f"{tag}: shape "
                                                     f"{tuple(got.shape)}")
                            flash_close(tag, got, want)
                            n_ops += 1
                            flash_close(tag + " (CUDA-core kernel)",
                                        flash_attention_cuda(q, k, v, **kw),
                                        want)
                            n_checks += 1
                            if route == "decode":
                                for ns in (1, 2, sk):
                                    flash_close(f"{tag} n_split={ns}",
                                                flash_decode_cuda(
                                                    q, k, v, n_split=ns,
                                                    **kw), want)
                                    n_checks += 1
                            if route == "tc":
                                flash_close(tag + " (tensor-core kernel)",
                                            flash_attention_tc_cuda(
                                                q, k, v, **kw), want)
                                n_checks += 1
                            if std == CAP_LOGIT_STD:
                                flash_planted_fault(tag, q, k, v, kw, want)
                                n_faults += 1
    made = sum(ops.LAUNCHES[c] - n0[c] for c in ops.FLASH_COUNTERS.values())
    direct = ops.LAUNCHES["flash_attention"] - n0["flash_attention"]
    print(f"  flash_attention (dk, dv) ragged: (24, 16), (192, 128) and "
          f"(192, 192) x f32/bf16 x (H, Kh) (4, 4), (8, 2) x (Sq, Sk) (1, 70), "
          f"(3, 333), (16, 40), (17, 300), (77, 77), (130, 130), (96, 40); "
          f"logit sd {LOGIT_STD:g}: non-causal, causal, causal + window "
          f"48 + softcap 30; logit sd {CAP_LOGIT_STD:g}: causal + softcap "
          f"50: {n_ops} op calls ({made} counted launches, {direct} of "
          f"them on the CUDA-core kernel's counter) and {n_checks} direct "
          f"kernel calls within tolerance (bf16 of the plain version, f32 "
          f"of float64 attention), {n_faults} without the softcap fail "
          f"it; the f32 plain version itself lies outside the f32 "
          f"tolerance of float64 on {tally['plain outside']} of "
          f"{tally['inputs']} f32 inputs", flush=True)

    c = next(c for c in LM_C if c["arch"] == "deepseek-v3-671b")
    cfg = get_config(c["arch"])
    m, hh = cfg.attn.mla, cfg.attn.n_heads
    dk, dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    b, sp, clen = c["batch"], c["prompt"], c["cache_len"]
    rows = []
    for label, sq, sk, counter, name in (
            ("prefill (7a)", sp, sp, "flash_attention_tc",
             f"flash_attention_tc_dk{dk}_dv{dv}"),
            ("decode step (7c)", 1, clen, "flash_attention_decode",
             f"flash_attention_decode_dk{dk}_dv{dv}")):
        kw = dict(causal=True)
        q, k, v = mla_flash_inputs(gen, b, hh, sq, sk, dk, dv,
                                   torch.bfloat16)
        route = flash_route(q.dtype, sq, dk, dv)
        if ops.FLASH_COUNTERS[route] != counter:
            raise AssertionError(f"MLA {label}: route {route}")
        held = 16 if sq > 1 else hh         # heads held to the plain version
        errs = []
        for std, kws in ((LOGIT_STD, (kw,)),
                         (CAP_LOGIT_STD, (kw, dict(kw, softcap=50.0)))):
            qc, kc, vc = (t[:, :held] for t in mla_flash_inputs(
                gen, b, held, sq, sk, dk, dv, torch.bfloat16,
                logit_std=std)) if std != LOGIT_STD else \
                (q[:, :held], k[:, :held], v[:, :held])
            for kwc in kws:
                tag = f"MLA {label} H={held} logit sd {std:g} {kwc}"
                want = ref.flash_attention_ref(qc, kc, vc, **kwc)
                err, _ = flash_close(tag, ops.flash_attention(qc, kc, vc,
                                                              **kwc), want)
                errs.append(err)
                flash_close(tag + " (own wrapper)",
                            route_kernel(qc, vc)(qc, kc, vc, **kwc), want)
                flash_close(tag + " (CUDA-core kernel)",
                            flash_attention_cuda(qc, kc, vc, **kwc), want)
                if "softcap" in kwc:
                    flash_planted_fault(tag, qc, kc, vc, kwc, want)
                del want
            del qc, kc, vc
        bnd, by, flops = flash_bound(q, k, kw, v)
        ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
        chunks = range(0, hh, held)
        plain = time_ms(lambda: [ref.flash_attention_ref(
            q[:, i:i + held], k[:, i:i + held], v[:, i:i + held], **kw)
            for i in chunks], iters=3)
        lib, backend = sdpa_backend_ms(q, k, v, causal=sq > 1)
        line = (f"  flash_attention MLA {label}: B={b} H=Kh={hh} Sq={sq} "
                f"Sk={sk} dk={dk} dv={dv} bf16 route {route}: max|err| "
                f"{max(errs):.2e} on {held} heads (both logit scales, "
                f"softcap 50 with its planted fault); kernel {ms:.4f} ms  "
                f"plain {plain:.4f} ms ({len(chunks)} chunks of {held} "
                f"heads)  bound {bnd:.4f} ms ({by}, {flops:.3e} FLOP, "
                f"{bnd / ms:.1%} of it)  SDPA ")
        line += (f"{lib:.4f} ms (backend: {backend})" if lib is not None
                 else f"not timed: {backend}")
        if sq == 1:
            n_sm = torch.cuda.get_device_properties(0).multi_processor_count
            ns = decode_splits(b, hh, sk, n_sm)
            line += f"  ({ns} splits; at " + ", ".join(
                f"{n}: {time_ms(lambda: flash_decode_cuda(q, k, v, n_split=n, **kw)):.4f} ms"
                for n in (2, 4, 8)) + ")"
        else:
            line += (f"  CUDA-core kernel "
                     f"{time_ms(lambda: flash_attention_cuda(q, k, v, **kw), iters=3):.4f}"
                     " ms")
        print(line, flush=True)
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/" +
            {"tc": "flash_attention_tc.cu",
             "decode": "flash_decode.cu"}[route],
            replaces="src/repro/kernels/flash_attention.py:118",
            counter=counter, max_abs_err=max(errs), ms=ms, plain_ms=plain,
            bound_ms=bnd, bound_by=by, library_ms=lib, phase=c["arch"]))
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def check_flash_nemotron(gen) -> list:
    """nemotron-4-340b's two flash shapes at its published heads (B 2, 96
    query heads on 8 KV heads of 192, bf16): the prefill of 4,064 on the
    tensor-core kernel's (192, 192) instance and a decode step over 4,096
    keys on the decode kernel, q transposed from (B, S, H, hd), k and v
    slices of the serving cache.  Each is held against its plain version
    at bf16's 3e-2 on the first two KV heads and their 24 query heads
    (the full prefill's f32 logits would take 12.7 GB), at both logit
    scales, through the op and its route's own wrapper, and past softcap
    50 the route's kernel must fail without it; then timed at all 96
    heads beside its bound, the plain version (by two KV heads at a
    time), SDPA (its backend named) and, at the prefill, the CUDA-core
    kernel the call took before the (192, 192) instance.  Returns the two
    JSON rows, counted in [lm] (c)'s nemotron run."""
    c = next(c for c in LM_C if c["arch"] == "nemotron-4-340b")
    a = get_config(c["arch"]).attn
    h, kh, hd = a.n_heads, a.n_kv_heads, a.head_dim
    group = h // kh
    b, sp, clen = c["batch"], c["prompt"], c["cache_len"]
    held_kv = 2                 # KV heads held to the plain version
    rows = []
    for label, sq, sk, clen_in, counter in (
            ("prefill (7a)", sp, sp, clen, "flash_attention_tc"),
            ("decode step (7c)", 1, clen, None, "flash_attention_decode")):
        kw = dict(causal=True)
        q, k, v = flash_inputs(gen, b, h, kh, sq, sk, hd, torch.bfloat16,
                               cache_len=clen_in)
        route = flash_route(q.dtype, sq, hd)
        if ops.FLASH_COUNTERS[route] != counter:
            raise AssertionError(f"nemotron {label}: route {route}")
        errs = []
        for std, kws in ((LOGIT_STD, (kw,)),
                         (CAP_LOGIT_STD, (kw, dict(kw, softcap=50.0)))):
            qc, kc, vc = (q[:, :held_kv * group], k[:, :held_kv],
                          v[:, :held_kv]) if std == LOGIT_STD else \
                flash_inputs(gen, b, held_kv * group, held_kv, sq, sk, hd,
                             torch.bfloat16, cache_len=clen_in,
                             logit_std=std)
            for kwc in kws:
                tag = (f"nemotron {label} H={held_kv * group} "
                       f"Kh={held_kv} logit sd {std:g} {kwc}")
                want = ref.flash_attention_ref(qc, kc, vc, **kwc)
                err, _ = flash_close(tag, ops.flash_attention(qc, kc, vc,
                                                              **kwc), want)
                errs.append(err)
                flash_close(tag + " (own wrapper)",
                            route_kernel(qc, vc)(qc, kc, vc, **kwc), want)
                if "softcap" in kwc:
                    flash_planted_fault(tag, qc, kc, vc, kwc, want)
                del want
            del qc, kc, vc
        bnd, by, flops = flash_bound(q, k, kw)
        ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
        chunks = range(0, kh, held_kv)
        plain = time_ms(lambda: [ref.flash_attention_ref(
            q[:, i * group:(i + held_kv) * group], k[:, i:i + held_kv],
            v[:, i:i + held_kv], **kw) for i in chunks], iters=3)
        lib, backend = sdpa_backend_ms(q, k, v, causal=sq > 1)
        line = (f"  flash_attention nemotron {label}: B={b} H={h} Kh={kh} "
                f"Sq={sq} Sk={sk} hd={hd} bf16 route {route}: max|err| "
                f"{max(errs):.2e} on {held_kv * group} heads (both logit "
                f"scales, softcap 50 with its planted fault); kernel "
                f"{ms:.4f} ms  plain {plain:.4f} ms ({len(chunks)} chunks of "
                f"{held_kv} KV heads)  bound {bnd:.4f} ms ({by}, "
                f"{flops:.3e} FLOP, {bnd / ms:.1%} of it)  SDPA ")
        line += (f"{lib:.4f} ms (backend: {backend})" if lib is not None
                 else f"not timed: {backend}")
        if sq == 1:
            n_sm = torch.cuda.get_device_properties(0).multi_processor_count
            line += (f"  ({decode_splits(b, kh, sk, n_sm)} splits; at " +
                     ", ".join(f"{n}: {time_ms(lambda: flash_decode_cuda(q, k, v, n_split=n, **kw)):.4f} ms"
                               for n in (4, 8, 16)) + ")")
        else:
            line += (f"  CUDA-core kernel "
                     f"{time_ms(lambda: flash_attention_cuda(q, k, v, **kw), iters=3):.4f}"
                     " ms")
        print(line, flush=True)
        rows.append(dict(
            name=f"{counter}_hd{hd}", route="cuda",
            source="src/repro_torch/kernels/csrc/" +
            {"tc": "flash_attention_tc.cu",
             "decode": "flash_decode.cu"}[route],
            replaces="src/repro/kernels/flash_attention.py:118",
            counter=counter, max_abs_err=max(errs), ms=ms, plain_ms=plain,
            bound_ms=bnd, bound_by=by, library_ms=lib, phase=c["arch"]))
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def prefix_fault(name, kernel, q, k, v, kw, want) -> None:
    """The check must be able to fail: the kernel run without its prefix,
    where the yardstick has one, must fail flash_close's elementwise
    test (a row inside the prefix sees the later prefix keys)."""
    bad = kernel(q, k, v, **dict(kw, prefix_len=0))
    torch.cuda.synchronize()
    tol = FLASH_TOL[q.dtype]
    if bool(torch.all((bad.float() - want.float()).abs()
                      <= tol + tol * want.float().abs())):
        raise AssertionError(f"{name}: the kernel without its prefix "
                             "passes the check; the inputs cannot tell")


def prefix_mask(sq: int, sk: int, prefix: int) -> torch.Tensor:
    """SDPA's boolean mask (True: seen) of the causal prefix-LM mask, q
    aligned to the end of k."""
    q_pos = torch.arange(sq, device="cuda")[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device="cuda")[None, :]
    return (k_pos <= q_pos) | (k_pos < prefix)


def check_flash_slice(gen) -> list:
    """The flash kernels on what whisper-tiny and paligemma-3b add.
    First ``prefix_len`` (a prefix-LM's bidirectional prefix) on all
    three kernels, through the op on its route and the kernel's own
    wrapper: the tensor-core kernel in bf16 at (Sq, Sk) (256, 256) and
    (64, 64), hd 64 and 256, the CUDA-core kernel in f32 at hd 64 and 80,
    and the decode kernel at Sq 16 over 16 keys with a prefix of 8 (f32
    and bf16) and at Sq 3 over 70; prefixes 8, 100 and 256, alone and
    with window 48 + softcap 30; f32 against attention in float64, bf16
    against the plain version, at FLASH_TOL; run without its prefix each
    kernel must fail the check where the prefix reaches past the first
    query.  Then non-causal attention with more queries than keys (Sq
    2,048 over Sk 1,500: the offset Sk − Sq is negative) on the
    tensor-core and CUDA-core kernels, and Sq 16 over 5 keys on the
    decode kernel, with and without a window.  Then the slice's three
    shapes, each held to the plain version and timed beside its bound,
    the plain version and SDPA (non-causal, or with a boolean mask for
    the prefix; its backend named): whisper-tiny's encoder
    self-attention (B 8, H 6, S 1,500, hd 64, non-causal; tensor-core
    kernel), its cross-attention decode step (Sq 1 over the 1,500
    encoder positions; decode kernel) and paligemma-3b's prefix prefill
    (B 2, H 8, Kh 1, hd 256, S 8,160, prefix 256; tensor-core kernel).
    Returns their three JSON rows, counted in [lm] (c)'s whisper-tiny and
    paligemma-3b runs."""
    n_checks = n_faults = 0
    tally = {"inputs": 0, "plain outside": 0}
    kernels = {"tc": flash_attention_tc_cuda,
               "cuda_core": flash_attention_cuda,
               "decode": flash_decode_cuda}
    for route, dt, hd, sq, sk in (
            ("tc", torch.bfloat16, 64, 256, 256),
            ("tc", torch.bfloat16, 64, 64, 64),
            ("tc", torch.bfloat16, 256, 256, 256),
            ("tc", torch.bfloat16, 256, 64, 64),
            ("cuda_core", torch.float32, 64, 256, 256),
            ("cuda_core", torch.float32, 80, 130, 333),
            ("decode", torch.float32, 64, 16, 16),
            ("decode", torch.bfloat16, 64, 16, 16),
            ("decode", torch.bfloat16, 256, 3, 70)):
        q, k, v = flash_inputs(gen, 2, 8, 2, sq, sk, hd, dt,
                               cache_len=sk + 7)
        if flash_route(dt, sq, hd) != route:
            raise AssertionError(f"prefix check {route}: route "
                                 f"{flash_route(dt, sq, hd)}")
        for prefix in ((8,) if route == "decode" else (8, 100, 256)):
            for kw in (dict(causal=True, prefix_len=prefix),
                       dict(causal=True, prefix_len=prefix, window=48,
                            softcap=30.0)):
                tag = (f"flash prefix {route} hd={hd} Sq={sq} Sk={sk} "
                       f"{kw} {dt}")
                want = ragged_yardstick(q, k, v, kw, tally)
                flash_close(tag, ops.flash_attention(q, k, v, **kw), want)
                flash_close(tag + " (own wrapper)", kernels[route](
                    q, k, v, **kw), want)
                n_checks += 2
                if "window" not in kw and sk - sq < min(prefix, sk) - 1:
                    prefix_fault(tag, kernels[route], q, k, v, kw, want)
                    n_faults += 1
        del q, k, v
    print(f"  flash_attention prefix_len: the tensor-core kernel (bf16, hd "
          f"64 and 256, (Sq, Sk) (256, 256) and (64, 64)), the CUDA-core "
          f"kernel (f32, hd 64 at (256, 256), hd 80 at (130, 333)) at "
          f"prefixes 8, 100 and 256, the decode kernel at prefix 8 (Sq 16 "
          f"over 16 keys in f32 and bf16, Sq 3 over 70); each alone and "
          f"with window 48 + softcap 30, through the op and the kernel's "
          f"own wrapper: {n_checks} checks within tolerance (bf16 of the "
          f"plain version, f32 of float64 attention), {n_faults} runs "
          f"without the prefix fail it; the f32 plain version itself lies "
          f"outside the f32 tolerance of float64 on "
          f"{tally['plain outside']} of {tally['inputs']} f32 inputs",
          flush=True)
    n_checks = 0
    for route, dt, sq, sk in (("tc", torch.bfloat16, 2048, 1500),
                              ("cuda_core", torch.float32, 2048, 1500),
                              ("decode", torch.float32, 16, 5)):
        q, k, v = flash_inputs(gen, 2, 6, 6, sq, sk, 64, dt)
        for kw in (dict(causal=False), dict(causal=False, window=1000)):
            tag = f"flash non-causal {route} Sq={sq} Sk={sk} {kw} {dt}"
            want = ragged_yardstick(q, k, v, kw, tally)
            flash_close(tag, ops.flash_attention(q, k, v, **kw), want)
            flash_close(tag + " (own wrapper)", kernels[route](q, k, v, **kw),
                        want)
            n_checks += 2
        del q, k, v
    print(f"  flash_attention non-causal, Sq > Sk (a negative offset): "
          f"Sq 2,048 over 1,500 keys on the tensor-core (bf16) and "
          f"CUDA-core (f32) kernels, Sq 16 over 5 on the decode kernel, "
          f"hd 64, with and without window 1,000: {n_checks} checks within "
          f"tolerance", flush=True)
    w = get_config("whisper-tiny")
    wc = next(c for c in LM_C if c["arch"] == "whisper-tiny")
    p = get_config("paligemma-3b")
    pc = next(c for c in LM_C if c["arch"] == "paligemma-3b")
    n_ctx, n_vis = w.encoder.n_ctx, p.vision.n_tokens
    s_vlm = n_vis + pc["prompt"]
    rows = []
    for name, phase, shape, kw in (
            ("flash_attention_tc_whisper_encoder", "whisper-tiny",
             (wc["batch"], w.attn.n_heads, w.attn.n_kv_heads, n_ctx, n_ctx,
              w.attn.head_dim), dict(causal=False)),
            ("flash_attention_decode_whisper_cross", "whisper-tiny",
             (wc["batch"], w.attn.n_heads, w.attn.n_kv_heads, 1, n_ctx,
              w.attn.head_dim), dict(causal=False)),
            ("flash_attention_tc_paligemma_prefix", "paligemma-3b",
             (pc["batch"], p.attn.n_heads, p.attn.n_kv_heads, s_vlm, s_vlm,
              p.attn.head_dim), dict(causal=True, prefix_len=n_vis))):
        b, h, kh, sq, sk, hd = shape
        q, k, v = flash_inputs(gen, *shape, torch.bfloat16)
        route = flash_route(q.dtype, sq, hd)
        counter = ops.FLASH_COUNTERS[route]
        want = ref.flash_attention_ref(q, k, v, **kw)
        err, rel = flash_close(name, ops.flash_attention(q, k, v, **kw),
                               want)
        flash_close(name + " (own wrapper)", kernels[route](q, k, v, **kw),
                    want)
        if kw.get("prefix_len"):
            prefix_fault(name, kernels[route], q, k, v, kw, want)
        del want
        bnd, by, flops = flash_bound(q, k, kw)
        ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
        plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                        iters=3)
        mask = prefix_mask(sq, sk, kw["prefix_len"]) \
            if kw.get("prefix_len") else None
        lib, backend = sdpa_backend_ms(q, k, v, causal=False, attn_mask=mask)
        del mask
        print(f"  flash_attention {name}: B={b} H={h} Kh={kh} Sq={sq} "
              f"Sk={sk} hd={hd} bf16 {kw} route {route}: max|err| "
              f"{err:.2e} row-rel {rel:.2e}; kernel {ms:.4f} ms  plain "
              f"{plain:.4f} ms  bound {bnd:.4f} ms ({by}, {flops:.3e} FLOP, "
              f"{bnd / ms:.1%} of it)  SDPA ("
              + ("boolean prefix mask" if kw.get("prefix_len") else
                 "non-causal") + ") " +
              (f"{lib:.4f} ms (backend: {backend})" if lib is not None
               else f"not timed: {backend}"), flush=True)
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/" +
            {"tc": "flash_attention_tc.cu",
             "decode": "flash_decode.cu"}[route],
            replaces="src/repro/kernels/flash_attention.py:118",
            counter=counter, max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=bnd, bound_by=by, library_ms=lib, phase=phase))
        del q, k, v
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 4-6: the round engine


def small_agreement() -> None:
    """ucfl_k2 on a small scenario, on the card and on the CPU, from the
    same init and the same draws: histories agree, params within 1e-3."""
    fed_cpu = scenario_label_shift(3, n=600, m=6, device="cpu")
    fed_gpu = FederatedData(*(t.to("cuda") for t in fed_cpu))
    cfg = lenet.LeNetConfig()
    p0 = lenet.init_params(torch.Generator().manual_seed(5), cfg,
                           device="cpu")
    fl = FLConfig(rounds=3, local_steps=3, batch_size=16, eval_every=1)
    runs = {}
    for dev, fed in (("cpu", fed_cpu), ("cuda", fed_gpu)):
        runs[dev] = run_federated(
            "ucfl_k2", fed, fl=fl, system=SYSTEMS["wireless_slow"],
            model_init=lambda gen: {k: v.to(dev) for k, v in p0.items()},
            draws=TorchDraws(11, "cpu"), keep_state=True, device=dev)
    a, b = runs["cpu"], runs["cuda"]
    flip = 1.0 / (fed_cpu.m * fed_cpu.x_val.shape[1])
    if a.comm != b.comm or a.time != b.time:
        raise AssertionError("cuda and cpu runs disagree on comm/time")
    if list(a.extras.assignment) != list(b.extras.assignment):
        raise AssertionError("cuda and cpu runs disagree on the stream plan")
    acc_err = max(abs(x - y) for x, y in zip(a.mean_acc + a.worst_acc,
                                             b.mean_acc + b.worst_acc))
    if acc_err > 2 * flip + 1e-6:
        raise AssertionError(f"accuracies differ by {acc_err}")
    perr, bad = 0.0, []
    for k, v in a.final_params.items():
        got = b.final_params[k].cpu()
        perr = max(perr, float((got - v).abs().max()))
        if not torch.allclose(got, v, rtol=1e-3, atol=1e-4):
            excess = ((got - v).abs() / (1e-4 + 1e-3 * v.abs())).max()
            bad.append(f"{k} (max |Δ| {float((got - v).abs().max()):.3e}, "
                       f"{float(excess):.2f}x the tolerance)")
    if bad:
        raise AssertionError(f"final params differ cuda vs cpu: {bad}")
    print(f"  ucfl_k2 n=600 m=6: cuda agrees with cpu (max |Δparam| "
          f"{perr:.2e}, max |Δacc| {acc_err:.4f})", flush=True)


def async_agreement() -> None:
    """ucfl_k4 through the buffered-async runtime (K = 3 of m = 6,
    max_staleness 2) on the card and on the CPU, from the same init and
    the same draws, without a channel and with qsgd:8 over tiered:4:
    clock, comm, comm bits and ``extra["async"]`` equal, accuracies
    within two argmax flips.  Params: without the channel within 1e-3
    (as `small_agreement`); with qsgd:8, a last-bit difference in the
    local update moves a stochastic-rounding floor by one level
    (absmax/127) now and then, so at most 0.1 % of the elements may lie
    outside that tolerance, none by more than 1e-3 (two such levels;
    `tests/test_torch_gpu.py` holds the same)."""
    fed_cpu = scenario_label_shift(3, n=600, m=6, device="cpu")
    fed_gpu = FederatedData(*(t.to("cuda") for t in fed_cpu))
    p0 = lenet.init_params(torch.Generator().manual_seed(5),
                           lenet.LeNetConfig(), device="cpu")
    fl = FLConfig(rounds=4, local_steps=3, batch_size=16, eval_every=1)
    for codec in (None, "qsgd:8"):
        runs = {}
        for dev, fed in (("cpu", fed_cpu), ("cuda", fed_gpu)):
            runs[dev] = run_federated(
                "ucfl_k4", fed, fl=fl, system=SYSTEMS["wireless_slow"],
                async_cfg=AsyncConfig(buffer_k=3, max_staleness=2),
                channel=(None if codec is None
                         else Channel(codec=codec, link="tiered:4")),
                model_init=lambda gen: {k: v.to(dev) for k, v in p0.items()},
                draws=TorchDraws(11, "cpu"), keep_state=True, device=dev)
        a, b = runs["cpu"], runs["cuda"]
        if ((a.time, a.comm, a.comm_bits, a.extra["async"])
                != (b.time, b.comm, b.comm_bits, b.extra["async"])):
            raise AssertionError(f"async {codec}: cuda and cpu disagree on "
                                 "clock, comm, comm_bits or extra['async']")
        flip = 1.0 / (fed_cpu.m * fed_cpu.x_val.shape[1])
        acc_err = max(abs(x - y) for x, y in zip(a.mean_acc + a.worst_acc,
                                                 b.mean_acc + b.worst_acc))
        if acc_err > 2 * flip + 1e-6:
            raise AssertionError(f"async {codec}: accuracies differ by "
                                 f"{acc_err}")
        perr, outside, total = 0.0, 0, 0
        for k, v in a.final_params.items():
            d = (b.final_params[k].cpu() - v).abs()
            perr = max(perr, float(d.max()))
            outside += int((d > 1e-4 + 1e-3 * v.abs()).sum())
            total += v.numel()
        allowed = 0 if codec is None else total // 1000
        if outside > allowed or (codec is not None and perr > 1e-3):
            raise AssertionError(f"async {codec}: final params differ cuda "
                                 f"vs cpu: {outside} of {total} elements "
                                 f"outside rtol 1e-3 / atol 1e-4, max |Δ| "
                                 f"{perr:.3e}")
        print(f"  async ucfl_k4 K=3 n=600 m=6 {codec or 'no channel'}: cuda "
              f"agrees with cpu (clock {b.time[-1]:.4f}, max |Δparam| "
              f"{perr:.2e}, {outside} of {total} elements outside rtol "
              f"1e-3 / atol 1e-4, max |Δacc| {acc_err:.4f})", flush=True)


def hierarchy_agreement() -> None:
    """ucfl_k2 two-level (ragged:2-4 devices, a qsgd:8 edge codec over a
    tiered:4 edge link, edge latency 0.5) on a small scenario, on the card
    and on the CPU, from the same init and the same draws: clock, comm
    and the edge books equal, accuracies within two argmax flips; params
    within rtol 1e-3 / atol 1e-4 but for the edge codec's level flips (a
    last-bit difference in the local update moves a stochastic-rounding
    floor by one level now and then): at most 0.1 % of the elements
    outside, none by more than 1e-3, as `async_agreement` holds qsgd:8."""
    from repro_torch.fl import HierarchyConfig
    fed_cpu = scenario_label_shift(3, n=600, m=6, device="cpu")
    fed_gpu = FederatedData(*(t.to("cuda") for t in fed_cpu))
    p0 = lenet.init_params(torch.Generator().manual_seed(5),
                           lenet.LeNetConfig(), device="cpu")
    fl = FLConfig(rounds=3, local_steps=3, batch_size=16, eval_every=1)
    hc = HierarchyConfig(devices_per_user="ragged:2-4", edge_codec="qsgd:8",
                         edge_link="tiered:4", edge_latency=0.5)
    runs = {}
    for dev, fed in (("cpu", fed_cpu), ("cuda", fed_gpu)):
        runs[dev] = run_federated(
            "ucfl_k2", fed, fl=fl, system=SYSTEMS["wireless_slow"],
            hierarchy=hc,
            model_init=lambda gen: {k: v.to(dev) for k, v in p0.items()},
            draws=TorchDraws(11, "cpu"), keep_state=True, device=dev)
    a, b = runs["cpu"], runs["cuda"]
    if ((a.time, a.comm, a.extra["hierarchy"])
            != (b.time, b.comm, b.extra["hierarchy"])):
        raise AssertionError("hierarchy: cuda and cpu disagree on clock, "
                             "comm or extra['hierarchy']")
    flip = 1.0 / (fed_cpu.m * fed_cpu.x_val.shape[1])
    acc_err = max(abs(x - y) for x, y in zip(a.mean_acc + a.worst_acc,
                                             b.mean_acc + b.worst_acc))
    if acc_err > 2 * flip + 1e-6:
        raise AssertionError(f"hierarchy: accuracies differ by {acc_err}")
    perr, outside, total = 0.0, 0, 0
    for k, v in a.final_params.items():
        d = (b.final_params[k].cpu() - v).abs()
        perr = max(perr, float(d.max()))
        outside += int((d > 1e-4 + 1e-3 * v.abs()).sum())
        total += v.numel()
    if outside > total // 1000 or perr > 1e-3:
        raise AssertionError(f"hierarchy: final params differ cuda vs cpu: "
                             f"{outside} of {total} elements outside rtol "
                             f"1e-3 / atol 1e-4, max |Δ| {perr:.3e}")
    print(f"  hierarchy ucfl_k2 ragged:2-4 qsgd:8 n=600 m=6: cuda agrees "
          f"with cpu (clock {b.time[-1]:.4f}, edge ul bits "
          f"{b.extra['hierarchy']['edge_ul_bits_total']}, max |Δparam| "
          f"{perr:.2e}, {outside} of {total} elements outside rtol 1e-3 / "
          f"atol 1e-4, max |Δacc| {acc_err:.4f})", flush=True)


def mesh_agreement() -> None:
    """shard_map_streams ucfl_k2 on the one-rank NCCL group on the card
    against the same run over a one-rank gloo group on the CPU (same
    init, same draws; the CPU on one thread): histories agree, params
    within 1e-3, as `small_agreement` holds the HostVmap runs."""
    import torch.distributed as dist
    fed_cpu = scenario_label_shift(3, n=600, m=6, device="cpu")
    fed_gpu = FederatedData(*(t.to("cuda") for t in fed_cpu))
    p0 = lenet.init_params(torch.Generator().manual_seed(5),
                           lenet.LeNetConfig(), device="cpu")
    fl = FLConfig(rounds=3, local_steps=3, batch_size=16, eval_every=1)
    on_card = MeshShardMap(schedule="shard_map_streams")
    gloo = dist.new_group(backend="gloo")
    on_cpu = MeshShardMap(gloo, schedule="shard_map_streams", device="cpu")
    runs = {}
    for dev, fed, pl in (("cpu", fed_cpu, on_cpu), ("cuda", fed_gpu,
                                                    on_card)):
        runs[dev] = run_federated(
            "ucfl_k2", fed, fl=fl, system=SYSTEMS["wireless_slow"],
            model_init=lambda gen: {k: v.to(dev) for k, v in p0.items()},
            draws=TorchDraws(11, "cpu"), keep_state=True, device=dev,
            placement=pl)
    a, b = runs["cpu"], runs["cuda"]
    flip = 1.0 / (fed_cpu.m * fed_cpu.x_val.shape[1])
    if a.comm != b.comm or a.time != b.time:
        raise AssertionError("mesh: cuda and cpu runs disagree on comm/time")
    acc_err = max(abs(x - y) for x, y in zip(a.mean_acc + a.worst_acc,
                                             b.mean_acc + b.worst_acc))
    if acc_err > 2 * flip + 1e-6:
        raise AssertionError(f"mesh: accuracies differ by {acc_err}")
    perr = 0.0
    for k, v in a.final_params.items():
        got = b.final_params[k].cpu()
        perr = max(perr, float((got - v).abs().max()))
        if not torch.allclose(got, v, rtol=1e-3, atol=1e-4):
            raise AssertionError(f"mesh: final params {k} differ cuda vs "
                                 f"cpu (max |Δ| {perr:.3e})")
    print(f"  mesh ucfl_k2 shard_map_streams n=600 m=6: NCCL on the card "
          f"agrees with gloo on the cpu (max |Δparam| {perr:.2e}, max "
          f"|Δacc| {acc_err:.4f})", flush=True)


def uplink_agreement() -> None:
    """One uplink crossing (narrow LeNet, m=6, 3 participants, a non-zero
    residual) through uplink_roundtrip on the card and on the CPU: new
    params and residuals bitwise equal, for qsgd:4 and topk:0.25."""
    cfg = lenet.LeNetConfig(c1=2, c2=4, fc1=16, fc2=12)
    gen = torch.Generator().manual_seed(21)
    p0 = lenet.init_params(gen, cfg, device="cpu")
    m = 6
    prev = {k: v[None].repeat((m,) + (1,) * v.dim()) for k, v in p0.items()}
    stacked = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
               for k, v in prev.items()}
    ef = {k: 0.01 * torch.randn(v.shape, generator=gen)
          for k, v in prev.items()}
    mask = torch.tensor([True, False, True, False, False, True])
    d = sum(v.numel() for v in p0.values())
    noise = torch.rand((m, d), generator=gen)
    cuda = lambda t: {k: v.cuda() for k, v in t.items()}
    for spec in ("qsgd:4", "topk:0.25"):
        codec = get_codec(spec)
        before = dict(ops.LAUNCHES)
        want = uplink_roundtrip(codec, stacked, prev, ef, noise, mask)
        got = uplink_roundtrip(codec, cuda(stacked), cuda(prev), cuda(ef),
                               noise.cuda(), mask.cuda())
        torch.cuda.synchronize()
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before
                    if ops.LAUNCHES[k] != before[k]}
        for part, g, w in (("params", got[0], want[0]),
                           ("residuals", got[1], want[1])):
            for k in w:
                if not torch.equal(g[k].cpu(), w[k]):
                    raise AssertionError(f"uplink {spec}: {part} {k} differ "
                                         "cuda vs cpu")
        print(f"  uplink_roundtrip {spec} (m=6, 3 sending, D={d}): cuda "
              f"bitwise equal to cpu; launches {launched}", flush=True)


def channel_agreement() -> None:
    """ucfl_k2 with UniformFraction(0.5) and a qsgd:8 channel over a tiered
    link, on the card and on the CPU, from the same init and the same
    draws: comm, comm_bits, clock and stream plan equal, accuracies within
    two argmax flips.  Final params are not compared: a last-bit
    difference in the local update can move a stochastic-rounding floor
    by one level, and the next rounds carry that on."""
    fed_cpu = scenario_label_shift(3, n=600, m=6, device="cpu")
    fed_gpu = FederatedData(*(t.to("cuda") for t in fed_cpu))
    p0 = lenet.init_params(torch.Generator().manual_seed(5),
                           lenet.LeNetConfig(), device="cpu")
    fl = FLConfig(rounds=3, local_steps=3, batch_size=16, eval_every=1)
    runs = {}
    for dev, fed in (("cpu", fed_cpu), ("cuda", fed_gpu)):
        runs[dev] = run_federated(
            "ucfl_k2", fed, fl=fl, system=SYSTEMS["wireless_slow"],
            sampler=UniformFraction(0.5),
            channel=Channel(codec="qsgd:8", link="tiered:4"),
            model_init=lambda gen: {k: v.to(dev) for k, v in p0.items()},
            draws=TorchDraws(11, "cpu"), device=dev)
    a, b = runs["cpu"], runs["cuda"]
    if (a.comm != b.comm or a.comm_bits != b.comm_bits or a.time != b.time
            or list(a.extras.assignment) != list(b.extras.assignment)):
        raise AssertionError("cuda and cpu channel runs disagree on comm, "
                             "comm_bits, clock or stream plan")
    flip = 1.0 / (fed_cpu.m * fed_cpu.x_val.shape[1])
    acc_err = max(abs(x - y) for x, y in zip(a.mean_acc + a.worst_acc,
                                             b.mean_acc + b.worst_acc))
    if acc_err > 2 * flip + 1e-6:
        raise AssertionError(f"channel run accuracies differ by {acc_err}")
    print(f"  ucfl_k2 + UniformFraction(0.5) + qsgd:8/tiered:4 n=600 m=6: "
          f"cuda agrees with cpu (comm_bits {tuple(b.comm_bits[0])}, clock "
          f"{b.time[-1]:.4f}, max |Δacc| {acc_err:.4f})", flush=True)


# [agree]: the LM serving path on both devices, (arch, generate's
# keywords): the families, then whisper-tiny (encoder-decoder),
# paligemma-3b (8 vision tokens before the 96-token prompt) and
# gemma2-27b under long_context
AGREE_LM = (("gemma2-27b", {}), ("gemma-2b", {}), ("olmoe-1b-7b", {}),
            ("deepseek-v3-671b", {}), ("mamba2-780m", {}),
            ("zamba2-2.7b", {}), ("whisper-tiny", {}), ("paligemma-3b", {}),
            ("gemma2-27b", {"long_context": True}))


def lm_agreement() -> None:
    """The LM serving path on the card against the CPU, same params and
    prompt: gemma2-27b's smoke config (GQA group 1, window 64: a 96-token
    prompt takes the S > C prefill, and the local ring wraps on every
    decode step), gemma-2b's (group 4, head_dim 64) and olmoe-1b-7b's (4
    experts, top 2, qk_norm: a MoE layer a block) and deepseek-v3-671b's
    (MLA at dk 24 / dv 16, its prefill on the CUDA-core kernel; a
    dense-first layer and a MoE layer with a shared expert), and the SSM
    and hybrid families' (mamba2-780m: two SSD layers at chunk 32, the
    96-token prompt three chunks; zamba2-2.7b: an SSD layer, then the
    shared attention block at hd 64), whisper-tiny's (2 encoder layers
    over 32 audio frames, 2 decoder layers with cross-attention),
    paligemma-3b's (8 vision tokens, a bidirectional prefix) and
    gemma2-27b's under ``long_context`` (both rings 64 slots, the global
    one wrapping every step); prefill plus 8 decode steps, per-step
    logits within 1e-4 (f32, TF32 off) and equal tokens, one flash launch
    an attention product a step (`flash_calls`).  Then a
    ``seq_parallel=True`` copy of gemma2-27b's and deepseek-v3-671b's
    smoke configs on the card: tokens and logits bitwise the flag-off
    run's."""
    for arch, kw in AGREE_LM:
        cfg = get_smoke_config(arch)
        params = T.init_params(torch.Generator().manual_seed(3), cfg,
                               device="cpu")
        prompt = torch.randint(0, cfg.vocab_size, (2, 96),
                               generator=torch.Generator().manual_seed(4))
        extra = smoke_embeds(cfg, 2, 5, "cpu")
        flash = tuple(ops.FLASH_COUNTERS.values())
        before = sum(ops.LAUNCHES[c] for c in flash)
        a = generate(params, cfg, prompt, 9, 128, extra=extra,
                     return_logits=True, **kw)
        b = generate(tree_from_numpy(tree_to_numpy(params), "cuda"), cfg,
                     prompt.cuda(), 9, 128,
                     extra={k_: v.cuda() for k_, v in extra.items()},
                     return_logits=True, **kw)
        launched = sum(ops.LAUNCHES[c] for c in flash) - before
        n_pre, n_step = flash_calls(cfg)
        if launched != n_pre + 8 * n_step:
            raise AssertionError(f"{arch} {kw}: {launched} flash launches, "
                                 f"want {n_pre + 8 * n_step}")
        err = 0.0
        for i, (x, y) in enumerate(zip(a.logits, b.logits)):
            d = (y.cpu() - x).abs()
            err = max(err, float(d.max()))
            if not bool(torch.all(d <= 1e-4 + 1e-4 * x.abs())):
                raise AssertionError(f"{arch} {kw}: step {i} logits differ "
                                     f"cuda vs cpu by {float(d.max()):.3e}")
        if not torch.equal(a.tokens, b.tokens.cpu()):
            raise AssertionError(f"{arch} {kw}: tokens differ cuda vs cpu")
        what = (f", {cfg.encoder.n_ctx} audio frames" if cfg.encoder else
                f", {cfg.vision.n_tokens} vision tokens" if cfg.vision else
                "") + (", long_context" if kw else "")
        print(f"  {cfg.name} ({stack_dims(cfg)}{what}) prompt 96, 8 decode "
              f"steps: cuda agrees with cpu (max |Δlogit| {err:.2e}, tokens "
              f"equal, {launched} flash launches)", flush=True)
    for arch in ("gemma2-27b", "deepseek-v3-671b"):
        cfg = get_smoke_config(arch)
        sp = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, seq_parallel=True))
        params = T.init_params(torch.Generator(device="cuda").manual_seed(3),
                               cfg, device="cuda")
        prompt = torch.randint(0, cfg.vocab_size, (2, 96), device="cuda",
                               generator=torch.Generator(device="cuda")
                               .manual_seed(4))
        off, on = (generate(params, c, prompt, 9, 128, return_logits=True)
                   for c in (cfg, sp))
        if not torch.equal(off.tokens, on.tokens) or not all(
                torch.equal(x, y) for x, y in zip(off.logits, on.logits)):
            raise AssertionError(f"{arch}: seq_parallel=True differs from "
                                 "the flag off")
        print(f"  {cfg.name} seq_parallel=True on the card: tokens and "
              f"per-step logits bitwise the flag-off run's", flush=True)


def flash_calls(cfg) -> tuple:
    """(flash calls of a prefill, of a decode step) of `generate` on
    ``cfg``: one an attention layer, or for the audio family one an
    encoder layer at prefill and two a decoder layer (self and cross)."""
    if cfg.family == "audio":
        return cfg.encoder.n_layers + 2 * cfg.n_layers, 2 * cfg.n_layers
    return n_attn_layers(cfg), n_attn_layers(cfg)


def n_attn_layers(cfg) -> int:
    """The layers of ``cfg`` that run attention (each one flash launch a
    prefill or decode step)."""
    return sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))


def stack_dims(cfg) -> str:
    """The attention heads and the SSM widths of ``cfg``, for a printout."""
    out = []
    a = cfg.attn
    if a is not None:
        m = a.mla
        out.append(f"H={a.n_heads} Kh={a.n_kv_heads} " + (
            f"hd={a.head_dim}" if m is None else
            f"MLA dk={m.qk_nope_head_dim + m.qk_rope_head_dim} "
            f"dv={m.v_head_dim}"))
    if cfg.ssm is not None:
        s = cfg.ssm
        out.append(f"SSD d_inner={s.expand * cfg.d_model} "
                   f"head_dim={s.head_dim} d_state={s.d_state} "
                   f"chunk={s.chunk_size}")
    if cfg.hybrid is not None:
        out.append(f"attention every {cfg.hybrid.attn_every} layers, "
                   f"shared={cfg.hybrid.shared_block}")
    return "; ".join(out)


# [agree]: `launch.serve --federated` at its smallest flags, on a dense
# config, on deepseek's (MLA under the per-user vmap), on mamba2's (the
# SSM caches under the per-user vmap) and on paligemma's (a vlm trained
# and served on tokens alone)
FED_SMALL = ["--federated", "--rounds", "1", "--clients", "2", "--pool",
             "5", "--requests", "3", "--tokens", "3", "--prompt-len", "8",
             "--max-batch", "2"]
FED_ARCHS = ("stablelm-3b", "deepseek-v3-671b", "mamba2-780m",
             "paligemma-3b")


def federated_agreement() -> None:
    """`launch.serve.main --federated` on the card and on the CPU (the
    data, params, draws and prompts drawn on the host): the same served
    tokens, the parity anchor on both, the per-user decode's flash
    launches one a layer a step for each batch."""
    import io
    from repro_torch.launch import serve as serve_cli
    for arch in FED_ARCHS:
        outs = {}
        for dev in ("cpu", "cuda"):
            buf = io.StringIO()
            before = dict(ops.LAUNCHES)
            with contextlib.redirect_stdout(buf):
                outs[dev] = serve_cli.main(FED_SMALL + ["--arch", arch,
                                                        "--device", dev])
            launched = {c: ops.LAUNCHES[c] - before[c]
                        for c in ops.FLASH_COUNTERS.values()
                        if ops.LAUNCHES[c] != before[c]}
            if "parity anchor OK" not in buf.getvalue():
                raise AssertionError(f"--federated {arch} {dev}: "
                                     f"{buf.getvalue()}")
        if len(outs["cuda"]) != 3 or any(
                not np.array_equal(a, b) for a, b in zip(outs["cpu"],
                                                         outs["cuda"])):
            raise AssertionError(f"--federated {arch}: served tokens differ "
                                 f"cuda vs cpu: {outs}")
        print(f"  launch.serve --federated ({arch} cpu-small, 2 clients, 3 "
              f"requests of 3 tokens at max_batch 2): cuda serves the cpu's "
              f"tokens {[o.tolist() for o in outs['cuda']]}, parity anchor "
              f"on both; flash launches on the card {launched}", flush=True)


def kernel_kind(name: str) -> str:
    """flash (the three flash kernels), GEMM (cuBLAS's and CUTLASS's
    matrix products) or other, by a device kernel's name."""
    n = name.lower()
    if "decode_partials" in n or "decode_merge" in n or "flash" in n:
        return "flash"
    if any(w in n for w in ("gemm", "gemv", "xmma", "nvjet", "cutlass",
                            "cublas", "splitk")):
        return "GEMM"
    return "other"


def device_split(prof):
    """From a torch.profiler trace: (device-busy µs, the union of kernel
    spans; µs by flash / GEMM (cuBLAS) / other; µs by kernel name; the
    number of kernels), or None when the trace holds no device events.
    A `record_function` span's range on the device (`ssd_spans`') is no
    kernel and is left out."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and not
               (getattr(e, "is_user_annotation", False) or
                e.name in SSD_SPANS)]
    if not kernels:
        return None
    split = {"flash": 0.0, "GEMM": 0.0, "other": 0.0}
    by_name = {}
    spans = []
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        split[kernel_kind(e.name)] += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for st, en in spans[1:]:
        if st > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    busy += cur_e - cur_s
    return busy, split, by_name, len(kernels)


def kernels_under(prof, names) -> dict:
    """Device µs by kind (as `device_split` sorts them) of the kernels
    launched under a CPU op or span whose name is in ``names``: on the
    serving path ``aten::einsum`` is `models/moe.py`'s (its dispatch,
    expert and combine products, with their layout copies; the SSD's
    einsums run inside its spans), ``ssd_scan`` and ``ssd_decode_step``
    the spans `ssd_spans` opens around `models/ssm.py`'s SSD."""
    out = {"flash": 0.0, "GEMM": 0.0, "other": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        p = e
        while p is not None and p.name not in names:
            p = p.cpu_parent
        if p is not None:
            for k in e.kernels:
                out[kernel_kind(k.name)] += k.duration
    return out


SSD_SPANS = ("ssd_scan", "ssd_decode_step")


@contextlib.contextmanager
def ssd_spans():
    """For a profiler trace only: `models/ssm.py`'s ``ssd_scan`` (the
    chunked SSD: its einsums, the decay products and the recurrence over
    the chunks) and ``ssd_decode_step`` run inside `record_function`
    spans of their names, so `kernels_under` can split their kernels
    off.  `ssm_apply` looks both up in its module at each call."""
    from repro_torch.models import ssm

    def span(name, fn):
        def wrapped(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return wrapped

    orig = {n: getattr(ssm, n) for n in SSD_SPANS}
    for n, fn in orig.items():
        setattr(ssm, n, span(n, fn))
    try:
        yield
    finally:
        for n, fn in orig.items():
            setattr(ssm, n, fn)


def _leaves(tree):
    """The tensors of a nested dict / list of parameters."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [t for v in vals for t in _leaves(v)]


def profile_decode(params, cfg, prompt, clen: int, card: str,
                   step_ms: float, steps: int = 8, label: str = "(a)"
                   ) -> None:
    """One torch.profiler trace of ``steps`` decode steps after a prefill:
    the device-busy time a step, split into flash attention, GEMM (cuBLAS)
    and other kernels (a MoE config's einsums apart), and the device's
    idle share of ``step_ms``, the step's wall in the timed run without
    the profiler (the wall under the profiler, which slows the host, is
    printed beside it).  Its launches are not counted."""
    counts = dict(ops.LAUNCHES)
    b, plen = prompt.shape
    caches = T.make_caches(cfg, b, clen, cfg.cdtype, device="cuda")
    logits, caches = T.prefill(params, cfg, {"tokens": prompt}, caches)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    for i in range(2):                                   # warm-up steps
        logits, caches = T.decode_step(params, cfg, tok, caches, plen + i)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with ssd_spans(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, caches = T.decode_step(params, cfg, tok, caches,
                                           plen + 2 + i)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops.LAUNCHES.update(counts)
    split = device_split(prof)
    if split is None:
        print(f"  {label} profiler: no device events in the trace; device "
              f"split and idle share not measured ({card})", flush=True)
        return
    busy, split, by_name, n_kernels = split
    busy_ms = busy / 1e3 / steps
    moe = ""
    if cfg.moe:
        ein = kernels_under(prof, ("aten::einsum",))
        moe = (f" (the MoE einsums {sum(ein.values()) / 1e3 / steps:.3f} "
               "ms of it)")
    if cfg.ssm:
        ssd = kernels_under(prof, SSD_SPANS)
        moe = (f" (the SSD state updates {sum(ssd.values()) / 1e3 / steps:.3f}"
               " ms of it)")
    print(f"  {label} profiler, {steps} decode steps ({card}): device busy "
          f"{busy_ms:.3f} ms a step: flash {split['flash'] / 1e3 / steps:.3f}"
          f" ms, GEMM {split['GEMM'] / 1e3 / steps:.3f} ms, other "
          f"{split['other'] / 1e3 / steps:.3f} ms{moe}; "
          f"{n_kernels / steps:.0f} kernels a step; device idle "
          f"{1 - busy_ms / step_ms:.1%} of the timed step ({step_ms:.3f} "
          f"ms); under the profiler the step's wall is "
          f"{wall * 1e3 / steps:.3f} ms", flush=True)
    for name, us in sorted(by_name.items(), key=lambda x: -x[1])[:8]:
        print(f"      {us / 1e3 / steps:8.4f} ms a step  {name[:110]}",
              flush=True)


def lm_path(card: str) -> dict:
    """[lm] (a) bf16 timed, then a profiler trace of decode steps, and (b)
    f32 self-consistency; returns the flash launches of (a) plus those of
    (b), each counted from 0, by kernel counter."""
    full = get_config(LM["arch"])
    cfg = dataclasses.replace(full, n_layers=2)
    assert [cfg.attn_window(i) for i in range(2)] == [4096, None]
    b, plen, n, clen = LM["batch"], LM["prompt"], LM["tokens"], LM["cache_len"]
    prompt = torch.randint(0, cfg.vocab_size, (b, plen), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(LM["seed"] + 1))
    print(f"[lm] {cfg.name} d_model {cfg.d_model}, H {cfg.attn.n_heads}, Kh "
          f"{cfg.attn.n_kv_heads}, hd {cfg.attn.head_dim}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}; reduced {LM['reduced']}; B {b}, prompt "
          f"{plen}, {n} tokens, cache {clen} ({card})", flush=True)

    def init(c):
        return T.init_params(torch.Generator(device="cuda")
                             .manual_seed(LM["seed"]), c, device="cuda")

    counters = tuple(ops.FLASH_COUNTERS.values())
    params = init(cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    generate(params, cfg, prompt[:, :64], 2, 128)          # warm-up
    torch.cuda.synchronize()
    ops.reset_launches()           # counts from here on are [lm] (a)'s
    torch.cuda.reset_peak_memory_stats()
    res = generate(params, cfg, prompt, n, clen, return_logits=True)
    launches = {k: ops.LAUNCHES[k] for k in counters}
    peak = torch.cuda.max_memory_allocated()
    # one launch per layer per step: the bf16 prefill on the tensor cores,
    # the decode steps on the split-key decode kernel
    want = {"flash_attention_decode": (n - 1) * cfg.n_layers,
            "flash_attention_tc": cfg.n_layers, "flash_attention": 0}
    if launches != want or sum(launches.values()) != n * cfg.n_layers:
        raise AssertionError(f"[lm] flash launches {launches}, want {want}")
    if res.tokens.shape != (b, n) or not bool(
            ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"[lm] bad tokens {res.tokens}")
    if not all(bool(torch.isfinite(x).all()) for x in res.logits):
        raise AssertionError("[lm] non-finite logits")
    steps = n - 1
    print(f"  (a) bf16: {n_params / 1e9:.3f} B params; prefill "
          f"{res.prefill_s * 1e3:.2f} ms ({b}x{plen} tokens); decode "
          f"{res.decode_s * 1e3 / steps:.3f} ms/token-step, "
          f"{steps * b / res.decode_s:.1f} tok/s ({steps} steps x{b}); "
          f"flash launches {launches}; peak memory {peak / 2**30:.2f} GiB; "
          f"sample {res.tokens[0, :12].tolist()}", flush=True)
    step_ms = res.decode_s * 1e3 / steps
    del res
    profile_decode(params, cfg, prompt, clen, card, step_ms)
    del params
    torch.cuda.empty_cache()

    cfg32 = cfg.with_dtypes("float32", "float32")
    params = init(cfg32)
    ops.reset_launches()           # and from here on [lm] (b)'s
    res = generate(params, cfg32, prompt, n, clen, return_logits=True)
    tokens = torch.cat([prompt, res.tokens[:, :-1]], dim=1)
    logits, _ = T.prefill(params, cfg32, {"tokens": tokens},
                          T.make_caches(cfg32, b, clen, torch.float32,
                                        device="cuda"))
    launches_b = {k: ops.LAUNCHES[k] for k in counters}
    # f32: both prefills on the CUDA-core kernel, the decode steps on the
    # decode kernel
    want = {"flash_attention_decode": (n - 1) * cfg.n_layers,
            "flash_attention_tc": 0, "flash_attention": 2 * cfg.n_layers}
    if launches_b != want:
        raise AssertionError(f"[lm] (b) flash launches {launches_b}, want "
                             f"{want}")
    want = res.logits[-1]
    d = (logits[:, -1] - want).abs()
    if not bool(torch.all(d <= LM_SELF_TOL + LM_SELF_TOL * want.abs())):
        raise AssertionError(f"[lm] (b) fresh prefill differs from the last "
                             f"decode step by {float(d.max()):.3e}")
    print(f"  (b) f32: fresh prefill of {tokens.shape[1]} tokens (CUDA-core "
          f"kernel) reproduces the last decode step's logits (decode "
          f"kernel; max |Δ| {float(d.max()):.3e}, tolerance {LM_SELF_TOL}; "
          f"|logits| up to {float(want.abs().max()):.2f}); prefill "
          f"{res.prefill_s * 1e3:.2f} ms, decode "
          f"{res.decode_s * 1e3 / steps:.3f} ms/token-step; flash launches "
          f"{launches_b}", flush=True)
    del params, res, logits
    torch.cuda.empty_cache()
    return {k: launches[k] + launches_b[k] for k in counters}


def mla_layer_check(card: str) -> None:
    """One MLA layer of deepseek-v3-671b at its published widths in bf16
    (MLA_CHECK): a prefill into a latent ring on the naive path (its
    product on the tensor-core kernel at dk 192 / dv 128) against the
    layer's no-cache plain path (`_sdpa_chunked`), and the absorbed path
    (plain einsums in the latent space) against the naive one, on the
    prefill and on one decode step (the decode kernel), each at bf16's
    3e-2, elementwise and per output row.  Its launches are the check's,
    not a path's."""
    from repro_torch.models import attention as A
    c = MLA_CHECK
    cfg = get_config(c["arch"])
    absorbed = dataclasses.replace(cfg, attn=dataclasses.replace(
        cfg.attn, mla_absorb=True))
    b, s, clen = c["batch"], c["prompt"], c["cache_len"]
    gen = torch.Generator(device="cuda").manual_seed(c["seed"])
    params = A.attn_init(gen, cfg, device="cuda")
    x = torch.randn((b, s + 1, cfg.d_model), generator=gen,
                    device="cuda").to(cfg.cdtype)
    tol = FLASH_TOL[torch.bfloat16]

    def held(tag, got, want):
        err = check_close(tag, got, want, tol, tol)
        rel = row_rel_err(got, want)
        if not rel <= tol:
            raise AssertionError(f"{tag}: row-relative error {rel:.3e}")
        return err, rel

    with ops.launches_set_aside() as made:
        outs = {}
        for label, cf in (("naive", cfg), ("absorbed", absorbed)):
            cache = A.init_cache(cf, b, clen, cf.cdtype, "cuda")
            pre, cache = A.attention(params, cf, x[:, :s], 0, cache=cache)
            dec, cache = A.attention(params, cf, x[:, s:], s, cache=cache)
            outs[label] = (pre, dec)
        plain, _ = A.attention(params, cfg, x[:, :s], 0)
        torch.cuda.synchronize()
    want = {"flash_attention_tc": 1, "flash_attention_decode": 1}
    if made != want:
        raise AssertionError(f"[lm] MLA check: launches {made}, want {want}")
    e1 = held("MLA prefill: flash path vs no-cache plain path",
              outs["naive"][0], plain)
    e2 = held("MLA prefill: absorbed vs naive", outs["absorbed"][0],
              outs["naive"][0])
    e3 = held("MLA decode step: absorbed vs naive", outs["absorbed"][1],
              outs["naive"][1])
    print(f"[lm] MLA layer of {cfg.name} at published widths, bf16, B {b}, "
          f"prefill {s} into a latent ring of {clen}, then a decode step "
          f"({card}): the flash path (tensor-core kernel, dk 192 / dv "
          f"128) against the no-cache plain path max|err| {e1[0]:.2e} "
          f"row-rel {e1[1]:.2e}; absorbed against naive: prefill "
          f"{e2[0]:.2e} / {e2[1]:.2e}, decode step (decode kernel) "
          f"{e3[0]:.2e} / {e3[1]:.2e}; tolerance {tol}; launches {made}",
          flush=True)
    del params, x, outs, plain
    torch.cuda.empty_cache()


def lm_c_path(card: str) -> dict:
    """[lm] (c): bf16 `generate` of each LM_C configuration at its full
    width and LM_C's depth, after a warm-up at the full prompt: prefill
    ms, decode ms a step and tok/s, peak memory; exactly one tensor-core
    flash launch an attention layer for the prefill, one decode launch an
    attention layer a step and no CUDA-core launch (mamba2: none at all);
    finite logits and in-range tokens; then a profiler trace of one
    prefill (device time by flash / GEMM / other; a MoE config's einsums
    and an SSM config's SSD apart) and, for a MoE or SSM config or one of
    over 16 B params, of decode steps with the device's idle share.
    whisper-tiny's and paligemma-3b's batches carry the stub frontends'
    embeddings (`launch.serve.smoke_embeds`, drawn on the card); an entry
    with ``long_context`` runs the reference's long_500k mode.  Returns
    {arch, or the entry's key: flash launches by counter}, each
    configuration counted from 0."""
    counters = tuple(ops.FLASH_COUNTERS.values())
    out = {}
    for c in LM_C:
        cfg = dataclasses.replace(get_config(c["arch"]),
                                  n_layers=c["n_layers"])
        a = cfg.attn
        if c.get("free_first"):
            # tens of GB of bf16 params, drawn a tensor at a time in f32:
            # return what the earlier phases' captured graphs hold first
            _free_graphs()
        b, plen, n, clen = c["batch"], c["prompt"], c["tokens"], \
            c["cache_len"]
        gen = torch.Generator(device="cuda").manual_seed(c["seed"])
        params = T.init_params(gen, cfg, device="cuda")
        prompt = torch.randint(0, cfg.vocab_size, (b, plen), device="cuda",
                               generator=torch.Generator(device="cuda")
                               .manual_seed(c["seed"] + 1))
        extra = smoke_embeds(cfg, b, c["seed"] + 2, "cuda")
        lc = c.get("long_context", False)
        gkw = dict(extra=extra, long_context=lc)
        n_params = sum(t.numel() for t in _leaves(params))
        widths = [stack_dims(cfg)]
        if cfg.moe:
            widths.append(f"{cfg.moe.n_experts} experts of "
                          f"{cfg.moe.d_expert} top {cfg.moe.top_k}, qk_norm "
                          f"{a.qk_norm}")
            if cfg.moe.n_shared_experts:
                widths.append(f"{cfg.moe.n_shared_experts} shared, "
                              f"{cfg.moe.n_dense_layers} dense-first layers "
                              f"of d_ff {cfg.moe.dense_d_ff}")
        if cfg.encoder is not None:
            widths.append(f"{cfg.encoder.n_layers} encoder layers over "
                          f"{cfg.encoder.n_ctx} audio frames, learned "
                          "decoder positions")
        if cfg.vision is not None:
            widths.append(f"{cfg.vision.n_tokens} vision tokens of "
                          f"{cfg.vision.embed_dim}, a bidirectional prefix")
        if lc:
            widths.append(f"long_context: every ring and window "
                          f"{a.long_context_window}")
        if a is not None and a.mla is not None:
            widths.append(f"MLA q_lora {a.mla.q_lora_rank}, kv_lora "
                          f"{a.mla.kv_lora_rank}, qk_nope "
                          f"{a.mla.qk_nope_head_dim}, rope "
                          f"{a.mla.qk_rope_head_dim}, v {a.mla.v_head_dim}")
        print(f"[lm] (c) {cfg.name} d_model {cfg.d_model}, "
              f"{'; '.join(widths)}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}, {cfg.activation}, {cfg.norm}; "
              f"{cfg.n_layers} layers ({n_attn_layers(cfg)} attention), "
              f"reduced {c['reduced'] or 'nothing'}; {n_params / 1e9:.3f} B "
              f"params; B {b}, prompt {plen}, {n} tokens, cache {clen} "
              f"({card})", flush=True)
        # warm-up at the full prompt: the timed prefill finds the caching
        # allocator's blocks and cuBLAS's choices for its shapes in place,
        # as a serving process does after its first request
        generate(params, cfg, prompt, 2, clen, **gkw)
        torch.cuda.synchronize()
        ops.reset_launches()       # counts from here on are this config's
        torch.cuda.reset_peak_memory_stats()
        res = generate(params, cfg, prompt, n, clen, return_logits=True,
                       **gkw)
        launches = {k: ops.LAUNCHES[k] for k in counters}
        peak = torch.cuda.max_memory_allocated()
        n_pre, n_step = flash_calls(cfg)
        want = {"flash_attention_decode": (n - 1) * n_step,
                "flash_attention_tc": n_pre, "flash_attention": 0}
        if launches != want:
            raise AssertionError(f"[lm] (c) {cfg.name}: flash launches "
                                 f"{launches}, want {want}")
        if res.tokens.shape != (b, n) or not bool(
                ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()):
            raise AssertionError(f"[lm] (c) {cfg.name}: bad tokens "
                                 f"{res.tokens}")
        if not all(bool(torch.isfinite(x).all()) for x in res.logits):
            raise AssertionError(f"[lm] (c) {cfg.name}: non-finite logits")
        steps = n - 1
        prefill_ms = res.prefill_s * 1e3
        step_ms = res.decode_s * 1e3 / steps
        name = c.get("key", cfg.name)
        print(f"  (c) {name} bf16: prefill {prefill_ms:.2f} ms ({b}x"
              f"{plen} tokens); decode {step_ms:.3f} "
              f"ms/token-step, {steps * b / res.decode_s:.1f} tok/s ({steps} "
              f"steps x{b}); flash launches {launches}; peak memory "
              f"{peak / 2**30:.2f} GiB ({peak / 2**20:.0f} MiB); sample "
              f"{res.tokens[0, :12].tolist()}", flush=True)
        if a is not None and a.mla is not None:
            m, el = a.mla, torch.finfo(cfg.cdtype).bits // 8
            latent = cfg.n_layers * b * clen * (
                m.kv_lora_rank + m.qk_rope_head_dim) * el
            expanded = cfg.n_layers * b * clen * a.n_heads * (
                m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim) * el
            print(f"  (c) {cfg.name} cache: the latent rings (c_kv "
                  f"{m.kv_lora_rank} + k_rope {m.qk_rope_head_dim} a slot) "
                  f"hold {latent / 2**20:.1f} MiB over {cfg.n_layers} "
                  f"layers x B {b} x {clen} slots, where the expanded K "
                  f"({m.qk_nope_head_dim + m.qk_rope_head_dim}) and V "
                  f"({m.v_head_dim}) of {a.n_heads} heads would take "
                  f"{expanded / 2**20:.1f} MiB ({expanded / latent:.1f}x)",
                  flush=True)
        del res
        out[c.get("key", c["arch"])] = launches
        # one prefill under the profiler: where its device time goes
        caches = T.make_caches(cfg, b, clen, cfg.cdtype, long_context=lc,
                               device="cuda")
        counts = dict(ops.LAUNCHES)      # the traced run does not count
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with ssd_spans(), torch.profiler.profile(activities=acts) as prof:
            T.prefill(params, cfg, dict(extra, tokens=prompt), caches,
                      long_context=lc)
            torch.cuda.synchronize()
        ops.LAUNCHES.update(counts)
        del caches
        split = device_split(prof)
        if split is None:
            print(f"  (c) {name} profiler: no device events; prefill "
                  "split not measured", flush=True)
        else:
            busy, split, by_name, n_kernels = split
            part = ""
            for label, names, on in (
                    ("the MoE einsums", ("aten::einsum",), cfg.moe),
                    ("the SSD scans (einsums, decays, the recurrence)",
                     SSD_SPANS, cfg.ssm)):
                if not on:
                    continue
                # the part's kernels (GEMMs and the rest) apart from the
                # other GEMMs and the rest
                sub = kernels_under(prof, names)
                part = (f"; split four ways: flash "
                        f"{split['flash'] / 1e3:.3f} ms, {label} "
                        f"{sum(sub.values()) / 1e3:.3f} ms (GEMMs "
                        f"{sub['GEMM'] / 1e3:.3f}), the other GEMMs "
                        f"{(split['GEMM'] - sub['GEMM']) / 1e3:.3f} ms, "
                        f"the rest {(split['other'] - sub['other']) / 1e3:.3f}"
                        " ms")
            print(f"  (c) {name} profiler, one prefill: device busy "
                  f"{busy / 1e3:.3f} ms ({busy / 1e3 / prefill_ms:.1%} of "
                  f"the timed prefill): flash {split['flash'] / 1e3:.3f} "
                  f"ms, GEMM {split['GEMM'] / 1e3:.3f} ms, other "
                  f"{split['other'] / 1e3:.3f} ms{part}; {n_kernels} "
                  "kernels", flush=True)
            for name, us in sorted(by_name.items(), key=lambda x: -x[1])[:6]:
                print(f"      {us / 1e3:8.4f} ms  {name[:110]}", flush=True)
        if cfg.moe or cfg.ssm or n_params > 16e9:
            # where a decode step's wall goes: its kernels a step against
            # the device's busy time
            profile_decode(params, cfg, prompt, clen, card, step_ms,
                           label=f"(c) {cfg.name}")
        del params, prompt, extra
        torch.cuda.empty_cache()
    return out


def run_both(spec, fed, fl, engines=("fused", "eventful"), between=None,
             **kw):
    """``run_federated`` fused (the default: captured CUDA graphs) and then
    eventful (``superstep=False``), ``keep_state=True``: the two histories
    must be equal line for line (rounds, accuracies, clock, comm,
    comm_bits, the fault ledger and cluster assignment where the run has
    them) and the final params and residuals bitwise.  Returns
    ``[(engine, History, launches, wall s), ...]``, fused first;
    ``engines=("eventful",)`` runs the eventful loop alone.
    ``between(History)``, if given, runs on each History before the next
    run starts."""
    out = []
    for engine, superstep in (("fused", None), ("eventful", False)):
        if engine not in engines:
            continue
        if out and between is not None:
            between(out[-1][1])
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        h = run_federated(spec, fed, fl=fl, seed=0, keep_state=True,
                          device="cuda", superstep=superstep, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out.append((engine, h, {k: ops.LAUNCHES[k] - before[k]
                                for k in before}, wall))
    if len(out) == 1:
        return out
    a, b = out[0][1], out[1][1]
    for field in ("rounds", "mean_acc", "worst_acc", "time", "comm",
                  "comm_bits"):
        if getattr(a, field) != getattr(b, field):
            raise AssertionError(f"{spec}: fused and eventful {field} differ:"
                                 f" {getattr(a, field)} != "
                                 f"{getattr(b, field)}")
    for key in ("faults", "clusters"):
        va, vb = a.extra.get(key), b.extra.get(key)
        same = (va is None and vb is None) or (
            va is not None and vb is not None
            and (va == vb if key == "faults" else bool((va == vb).all())))
        if not same:
            raise AssertionError(f"{spec}: fused and eventful extra[{key!r}] "
                                 f"differ: {va} != {vb}")
    for part in ("final_params", "final_residual"):
        ta, tb = getattr(a, part), getattr(b, part)
        if (ta is None) != (tb is None):
            raise AssertionError(f"{spec}: {part} on one engine only")
        for k in (ta or {}):
            if not torch.equal(ta[k].view(torch.int32),
                               tb[k].view(torch.int32)):
                raise AssertionError(f"{spec}: fused and eventful {part} "
                                     f"{k} not bitwise equal")
    print(f"  {spec}: fused = eventful (history line for line, final "
          "params and residuals bitwise)", flush=True)
    return out


def main_path(fed, fl) -> dict:
    """The three channel-less runs, each fused and eventful; returns
    {spec: History} of the fused runs."""
    system = SYSTEMS["wireless_slow"]
    m, rounds = MAIN["m"], MAIN["rounds"]
    hists = {}
    runs = [(spec, *run) for spec in ("ucfl", "ucfl_k4", "fedavg")
            for run in run_both(spec, fed, fl, system=system)]
    for spec, engine, h, launched, wall in runs:
        streams = h.comm[0].n_streams
        if not all(math.isfinite(a) for a in h.mean_acc + h.worst_acc):
            raise AssertionError(f"{spec}: non-finite accuracy {h.mean_acc}")
        if not h.mean_acc[-1] > 2.0 / 47:
            raise AssertionError(f"{spec}: final mean_acc {h.mean_acc[-1]} "
                                 "not above 2/47")
        ok = {"ucfl": streams == m, "ucfl_k4": 1 <= streams <= 4,
              "fedavg": streams == 1}[spec]
        if not ok:
            raise AssertionError(f"{spec}: {streams} streams")
        if [tuple(c) for c in h.comm] != [(streams, 0)] * rounds:
            raise AssertionError(f"{spec}: comm {h.comm}")
        t, want_time = 0.0, []
        for rnd in range(rounds):
            t += system.round_time(m, n_streams=streams, n_unicasts=0)
            if rnd % fl.eval_every == 0 or rnd == rounds - 1:
                want_time.append(t)
        if h.time != want_time:
            raise AssertionError(f"{spec}: clock {h.time} != {want_time}")
        if launched["mixing_aggregate"] != rounds:
            raise AssertionError(f"{spec}: {launched} mixing launches, want "
                                 f"{rounds}, one a round")
        if launched["gram_matrix"] != (1 if spec.startswith("ucfl") else 0):
            raise AssertionError(f"{spec}: {launched} gram launches")
        print(f"  {spec:8s} {engine:8s} streams {streams:2d}  mean_acc "
              f"{[round(a, 4) for a in h.mean_acc]}  worst_acc "
              f"{h.worst_acc[-1]:.4f}  time {h.time[-1]:.4f}  launches "
              f"{ {k: v for k, v in launched.items() if v} }  wall "
              f"{wall:.2f} s ({wall / rounds * 1e3:.1f} ms/round incl. "
              f"setup)", flush=True)
        hists.setdefault(spec, h)
    return hists


def channel_path(fed, fl, base_clock: list) -> None:
    """The uplink channel at full width: ucfl_k4 + UniformFraction(0.5) +
    qsgd:8 over tiered:4, ucfl + topk:0.1, fedavg + the identity channel
    (whose clock must equal ``base_clock``, the channel-less fedavg's)."""
    system = SYSTEMS["wireless_slow"]
    m, rounds = MAIN["m"], MAIN["rounds"]
    d = D_LENET
    qsgd_bits, topk_bits = d * 8 + 32, -(-d // 10) * 64
    runs = [
        ("ucfl_k4", dict(sampler=UniformFraction(0.5),
                         channel=Channel(codec="qsgd:8", link="tiered:4")),
         dict(rowwise_absmax=0, qsgd_quantize=0, qsgd_dequantize=0,
              qsgd_roundtrip=rounds, topk_threshold=0, gram_matrix=1),
         lambda s: (s * qsgd_bits, (m // 2) * qsgd_bits)),
        ("ucfl", dict(channel=Channel(codec="topk:0.1")),
         dict(rowwise_absmax=0, qsgd_quantize=0, qsgd_dequantize=0,
              qsgd_roundtrip=0, topk_threshold=rounds, gram_matrix=1),
         lambda s: (s * topk_bits, m * topk_bits)),
        ("fedavg", dict(channel=Channel()),
         dict(rowwise_absmax=0, qsgd_quantize=0, qsgd_dequantize=0,
              qsgd_roundtrip=0, topk_threshold=0, gram_matrix=0),
         lambda s: (s * 32 * d, m * 32 * d)),
    ]
    runs = [(spec, kw, want_launch, want_bits, *run)
            for spec, kw, want_launch, want_bits in runs
            for run in run_both(spec, fed, fl, system=system, **kw)]
    for spec, kw, want_launch, want_bits, engine, h, launched, wall in runs:
        want_launch["mixing_aggregate"] = rounds     # the tree, one launch
        for c in ops.FLASH_COUNTERS.values():
            want_launch[c] = 0
        if launched != want_launch:
            raise AssertionError(f"{spec} {engine}: launches {launched}, "
                                 f"want {want_launch}")
        streams = h.comm[0].n_streams
        if [tuple(c) for c in h.comm_bits] != [want_bits(streams)] * rounds:
            raise AssertionError(f"{spec}: comm_bits {h.comm_bits[:2]}..., "
                                 f"want {want_bits(streams)} every round")
        if not all(math.isfinite(a) for a in h.mean_acc + h.worst_acc):
            raise AssertionError(f"{spec}: non-finite accuracy {h.mean_acc}")
        if not h.mean_acc[-1] > 2.0 / 47:
            raise AssertionError(f"{spec}: final mean_acc {h.mean_acc[-1]} "
                                 "not above 2/47")
        res, codec = h.final_residual, kw["channel"].codec
        up = ""
        if codec.is_identity:
            if res is not None or h.time != base_clock:
                raise AssertionError(f"{spec}: identity channel clock "
                                     f"{h.time} != channel-less {base_clock}")
        elif not all(bool(torch.isfinite(v).all()) for v in res.values()):
            raise AssertionError(f"{spec}: non-finite residual stack")
        elif engine == "eventful":
            # device time of one round's uplink crossing at this size: the
            # codec's kernels plus the ravel, unravel and EF elementwise ops
            st = h.final_params
            prev = {k: v * 0.5 for k, v in st.items()}
            noise = torch.rand((m, d), device="cuda")
            mask = (torch.arange(m, device="cuda") < m // 2
                    if "sampler" in kw else None)
            counts = dict(ops.LAUNCHES)       # timing launches do not count
            up_ms = time_ms(lambda: uplink_roundtrip(codec, st, prev, res,
                                                     noise, mask))
            ops.LAUNCHES.update(counts)
            up = f"  uplink {up_ms:.4f} ms/round (device)"
        print(f"  {spec:8s} {engine:8s} {h.extra['channel']['codec']:9s} "
              f"link {h.extra['channel']['link']:8s} streams {streams:2d}  "
              f"mean_acc {[round(a, 4) for a in h.mean_acc]}  worst_acc "
              f"{h.worst_acc[-1]:.4f}  time {h.time[-1]:.4f}  comm_bits "
              f"{tuple(h.comm_bits[0])}  launches "
              f"{ {k: v for k, v in launched.items() if v} }  wall "
              f"{wall:.2f} s ({wall / rounds * 1e3:.1f} ms/round incl. "
              f"setup){up}", flush=True)


# [faults]: (label, spec, run_federated options, engines).  cfl changes
# its state between rounds, so it has no fused run.
FAULT_RUNS = (
    ("cfl", "cfl", {}, ("eventful",)),
    ("fedfomo", "fedfomo", {}, ("fused", "eventful")),
    ("byz+trimmed", "ucfl_k4", dict(faults="byz:0.25:sign_flip",
                                    robust_agg="trimmed_mean:0.25"),
     ("fused", "eventful")),
    ("crash,nan+median", "fedavg", dict(faults="crash:0.3,nan:0.2",
                                        robust_agg="median"),
     ("fused", "eventful")),
    ("crash+quorum", "ucfl", dict(faults="crash:0.5", min_quorum=12),
     ("fused", "eventful")),
    ("qsgd8+bitrot+krum", "ucfl_k4",
     dict(sampler=UniformFraction(0.5),
          channel=Channel(codec="qsgd:8", link="tiered:4"),
          faults="bitrot:0.3,seed:2", robust_agg="krum:0.25"),
     ("fused", "eventful")),
)


def faults_path(fed, fl, card: str) -> None:
    """[faults]: `FAULT_RUNS` at [main]'s config.  Each engine's launches
    are stated before the run and must be met: a mix a round on the fused
    engine (it always mixes and gates the result with a ``where``), a mix
    a round that met the quorum on the eventful loop; the Gram and Δ once
    a ucfl run; a QSGD row pass a round of the qsgd run; nothing else.
    Prints each run's accuracies, streams, fault ledger and wall s a
    round beside the card: the first run's (the fused one capturing its
    graphs) and a second run's (the graphs cached; its launches are not
    counted)."""
    system = SYSTEMS["wireless_slow"]
    rounds = MAIN["rounds"]
    for label, spec, kw, engines in FAULT_RUNS:
        runs = run_both(spec, fed, fl, engines=engines, system=system, **kw)
        counts = dict(ops.LAUNCHES)
        again = {}
        for engine in engines:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_federated(spec, fed, fl=fl, seed=0, device="cuda",
                          superstep=None if engine == "fused" else False,
                          system=system, **kw)
            torch.cuda.synchronize()
            again[engine] = time.perf_counter() - t0
        ops.LAUNCHES.update(counts)
        for engine, h, launched, wall in runs:
            fx = h.extra.get("faults", {})
            skipped = fx.get("skipped_rounds", 0)
            want = {k: 0 for k in launched}
            want["mixing_aggregate"] = (rounds if engine == "fused"
                                        else rounds - skipped)
            want["gram_matrix"] = 1 if spec.startswith("ucfl") else 0
            if "channel" in kw:
                want["qsgd_roundtrip"] = rounds
            if launched != want:
                raise AssertionError(f"[faults] {label} {engine}: launches "
                                     f"{launched}, want {want}")
            if not all(math.isfinite(a) for a in h.mean_acc + h.worst_acc):
                raise AssertionError(f"[faults] {label} {engine}: "
                                     f"non-finite accuracy {h.mean_acc}")
            if "faults" in kw and fx.get("rounds") != rounds:
                raise AssertionError(f"[faults] {label}: ledger {fx}")
            if "min_quorum" in kw and not 0 < skipped < rounds:
                raise AssertionError(f"[faults] {label}: {skipped} skipped "
                                     "rounds, want some but not all")
            ledger = {k: fx[k] for k in ("byzantine_clients",
                                         "crashed_total",
                                         "quarantined_total",
                                         "skipped_rounds") if k in fx}
            clusters = h.extra.get("clusters")
            streams = sorted({c.n_streams for c in h.comm})
            print(f"  {label:18s} {spec:8s} {engine:8s} mean_acc "
                  f"{[round(a, 4) for a in h.mean_acc]}  streams {streams}"
                  + ("" if clusters is None else
                     f"  clusters {int(clusters.max()) + 1}")
                  + f"  {ledger}  launches "
                  f"{ {k: v for k, v in launched.items() if v} }  wall "
                  f"{wall:.2f} s ({wall / rounds:.4f} s/round incl. setup), "
                  f"again {again[engine]:.2f} s ({again[engine] / rounds:.4f}"
                  f" s/round; {card})", flush=True)


class WindowDraws(TorchDraws):
    """`TorchDraws` that opens a profiler range (``"window"``) when the
    engine takes round ``first``'s batch slots: both engines take them
    first thing in that round (the fused one first thing in its chunk),
    with the card idle after the previous eval's scores came back."""

    def __init__(self, seed, first):
        super().__init__(seed, "cuda")
        self.first, self.range, self.t0 = first, None, None

    def _open(self, rnd):
        if rnd == self.first and self.range is None:
            self.range = torch.profiler.record_function("window")
            self.range.__enter__()
            self.t0 = time.perf_counter()

    def batch_indices(self, rnd, *args):
        self._open(rnd)
        return super().batch_indices(rnd, *args)

    def device_batch_indices(self, rnd, *args):
        # a two-level run's first draw of a round
        self._open(rnd)
        return super().device_batch_indices(rnd, *args)


def chunk_trace(spec, fed, fl, system, superstep, **kw) -> tuple:
    """One torch.profiler trace of a 5-round chunk (rounds 1-5 and the
    eval ending them, of a 6-round run at eval_every 5) under one engine:
    (wall ms of the window, device-busy ms, {part: device ms}, kernels,
    {kernel name: device ms}), or None when the trace holds no device
    events in it.  The parts by
    the kernels' order and names: the mix (the mixing kernel), the eval
    (every kernel after the window's last mix) and the local update (the
    rest: update, rollback and the engine's draws)."""
    draws = WindowDraws(7, first=1)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run_federated(spec, fed, fl=dataclasses.replace(fl, rounds=6),
                      system=system, seed=0, draws=draws, device="cuda",
                      superstep=superstep, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - draws.t0
        draws.range.__exit__(None, None, None)
    start = min(e.time_range.start for e in prof.events()
                if e.name == "window")
    # the profiler mirrors the "window" range on the device timeline (a
    # user annotation spanning its kernels): not a kernel
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.name != "window"
                      and e.time_range.start >= start),
                     key=lambda e: e.time_range.start)
    if not kernels:
        return None
    mixes = [i for i, e in enumerate(kernels) if "mix" in e.name.lower()]
    last_mix = mixes[-1] if mixes else len(kernels)
    parts = {"local update": 0.0, "mix": 0.0, "eval": 0.0}
    spans, by_name = [], {}
    for i, e in enumerate(kernels):
        us = e.time_range.end - e.time_range.start
        part = ("mix" if i in mixes else "eval" if i > last_mix
                else "local update")
        parts[part] += us / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
        spans.append((e.time_range.start, e.time_range.end))
    return wall * 1e3, busy_us(spans) / 1e3, parts, len(kernels), by_name


def busy_us(spans) -> float:
    """µs of the union of the (start, end) spans, sorted by start."""
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for st, en in spans[1:]:
        if st > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = st, en
        else:
            cur_e = max(cur_e, en)
    return busy + cur_e - cur_s


def graph_pool_mib():
    """MiB of the card's memory held in CUDA graphs' private pools (the
    allocator's segments outside pool (0, 0)), or None where the memory
    snapshot does not say which pool a segment belongs to."""
    segments = torch.cuda.memory._snapshot()["segments"]
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    return sum(sg["total_size"] for sg in segments
               if tuple(sg["segment_pool_id"]) != (0, 0)) / 2 ** 20


def superstep_path(fed, fl, card: str) -> None:
    """[superstep]: ucfl_k4 at [main]'s config on both engines.  The graphs
    are built anew (the cache emptied), so the first fused run carries the
    captures, timed apart; then 3 runs of each engine, alternating, and 3
    setup-only runs (0 rounds), for wall s a round; peak memory of each
    engine's first run, and what the three graphs' pools hold; one
    profiler trace of a 5-round chunk each."""
    from repro_torch.fl import simulator
    from repro_torch.fl.placement.graphs import CapturedChunk
    system, rounds, spec = SYSTEMS["wireless_slow"], MAIN["rounds"], "ucfl_k4"
    kw = dict(fl=fl, system=system, seed=0, device="cuda")

    def timed(**extra):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_federated(spec, fed, **{**kw, **extra})
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    simulator._SUPERSTEP_FNS.clear()
    peak = {}
    for engine, superstep in (("fused", None), ("eventful", False)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        first = timed(superstep=superstep)
        peak[engine] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        if engine == "fused":
            chunks = [c for cache in simulator._SUPERSTEP_FNS.values()
                      for c in cache.values() if isinstance(c, CapturedChunk)]
            capture = sum(c.capture_s for c in chunks)
            pools = graph_pool_mib()
            pools = ("not measured" if pools is None
                     else f"{pools:.1f} MiB")
            print(f"  capture: {len(chunks)} graphs (chunks of "
                  f"{sorted(c.length for c in chunks)} rounds) in "
                  f"{capture:.3f} s; first fused run {first:.3f} s; the "
                  f"graphs' private pools hold {pools} ({card})",
                  flush=True)
            if len(chunks) != 3:
                raise AssertionError(f"{len(chunks)} graphs, want 3")
    walls = {"fused": [], "eventful": [], "setup": []}
    for _ in range(3):
        walls["eventful"].append(timed(superstep=False))
        walls["fused"].append(timed())
        walls["setup"].append(timed(fl=dataclasses.replace(fl, rounds=0)))
    setup = statistics.median(walls["setup"])
    for engine in ("fused", "eventful"):
        med = statistics.median(walls[engine])
        print(f"  {engine:8s}: {med / rounds:.5f} s/round incl. setup "
              f"({(med - setup) / rounds:.5f} s/round less the median "
              f"setup-only run, {setup:.3f} s); runs "
              f"{[round(w, 4) for w in walls[engine]]} s; peak memory of "
              f"the first run {peak[engine]:.1f} MiB ({card})", flush=True)
    for engine, superstep in (("fused", None), ("eventful", False)):
        got = chunk_trace(spec, fed, fl, system, superstep)
        if got is None:
            print(f"  {engine:8s} trace: no device events in the window; "
                  f"device split and idle share not measured ({card})",
                  flush=True)
            continue
        wall, busy, parts, n_kernels, by_name = got
        print(f"  {engine:8s} trace of a 5-round chunk: wall {wall:.3f} ms, "
              f"device busy {busy:.3f} ms, idle {1 - busy / wall:.1%}; "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
              + f"; {n_kernels} kernels ({card})", flush=True)
        if engine == "fused":
            for name, ms in sorted(by_name.items(), key=lambda x: -x[1])[:6]:
                print(f"      {ms:8.3f} ms  {name[:90]} ({card})",
                      flush=True)


# [async]: (label, spec, AsyncConfig, run_federated options); every run
# under wireless_slow, 20 events at [main]'s config
ASYNC_RUNS = (
    ("ucfl_k4 K=5 exp", "ucfl_k4",
     AsyncConfig(buffer_k=5, max_staleness=3, staleness_discount=0.8), {}),
    ("fedavg K=5 poly", "fedavg",
     AsyncConfig(buffer_k=5, staleness_schedule="poly", staleness_alpha=0.5),
     {}),
    ("ucfl K=10 qsgd:8", "ucfl", AsyncConfig(buffer_k=10),
     dict(channel=Channel(codec="qsgd:8", link="tiered:4"))),
    ("fedavg crash+median", "fedavg", AsyncConfig(buffer_k=5, max_retries=2),
     dict(faults="crash:0.3", robust_agg="median", min_quorum=3)),
)


def async_trace(spec, fed, fl, cfg, **kw):
    """One async run under torch.profiler (device activity only): (wall
    ms, device-busy ms, kernels), or None when the trace holds no device
    events."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_federated(spec, fed, fl=fl, seed=0, device="cuda",
                      async_cfg=cfg, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    return wall * 1e3, busy_us(spans) / 1e3, len(spans)


def cohort_check(fed, fl, card: str) -> None:
    """`HostVmap.update_cohort` (gather k of the 20 rows, update, scatter)
    against the run-every-row-and-mask default at [main]'s shapes: bitwise
    for the cohorts [async] runs (k = 5 and 10), and the max |Δ| at k = 1,
    where cuBLAS may pick another kernel for the convs' batched GEMM."""
    from repro_torch.fl import HostVmap, Placement
    from repro_torch.fl.simulator import default_model_init
    p = HostVmap()
    opt, update = p.build_update(lenet.loss_fn, fl)
    gen = torch.Generator(device="cuda").manual_seed(2)
    stacked = p.stack(default_model_init(fed)(gen), fed.m)
    opt_state = p.init_opt(opt, stacked)
    batch = TorchDraws(4, "cuda").batch_indices(
        0, fed.n, fed.x.shape[1], fl.batch_size, fl.local_steps)
    out = []
    for k in (5, 10, 1):
        idx = torch.arange(k, device="cuda") * (fed.m // k)
        keep = torch.ones(k, dtype=torch.bool, device="cuda")
        args = (update, idx, keep, stacked, opt_state, fed.x, fed.y, fed.n,
                batch)
        fast = p.update_cohort(*args)[0]
        slow = Placement.update_cohort(p, *args)[0]
        err = max(float((fast[n] - v).abs().max()) for n, v in slow.items())
        bitwise = all(torch.equal(fast[n].view(torch.int32),
                                  v.view(torch.int32))
                      for n, v in slow.items())
        if k > 1 and not bitwise:
            raise AssertionError(f"[async] cohort update k={k} is not "
                                 f"bitwise the masked full update ({err})")
        out.append(f"k={k} " + ("bitwise" if bitwise else
                                f"max |Δ| {err:.2e}"))
    print(f"  cohort update vs masked full update ({fl.local_steps} local "
          f"steps, batch {fl.batch_size}): {', '.join(out)} ({card})",
          flush=True)


def async_path(fed, fl, card: str, sync_clock: dict):
    """[async]: the lockstep anchor, then `ASYNC_RUNS`, each run twice
    (the second run's launches are not counted), with the launches each
    run must make stated first; then one profiler trace.  ``sync_clock``
    is {spec: final clock} of [main]'s sync runs.  Returns the first K=5
    ucfl_k4 History (``keep_state``) for [checkpoint]."""
    system, events = SYSTEMS["wireless_slow"], MAIN["rounds"]
    m = MAIN["m"]
    cohort_check(fed, fl, card)
    # the anchor: inv_mu = 0, K = m, no staleness bound is the sync
    # engine's run, bit for bit (the sync run replays [main]'s graphs)
    kw = dict(fl=fl, system=SYSTEMS["wired"], seed=0, keep_state=True,
              device="cuda")
    t0 = time.perf_counter()
    sync = run_federated("ucfl_k4", fed, **kw)
    torch.cuda.synchronize()
    sync_wall = time.perf_counter() - t0
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    anchor = run_federated("ucfl_k4", fed, async_cfg=AsyncConfig(buffer_k=m),
                           **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
    for field in ("rounds", "mean_acc", "worst_acc", "comm"):
        if getattr(anchor, field) != getattr(sync, field):
            raise AssertionError(f"[async] anchor {field} differs from the "
                                 f"sync run: {getattr(anchor, field)} != "
                                 f"{getattr(sync, field)}")
    if not all(math.isclose(a, b, rel_tol=1e-12)
               for a, b in zip(anchor.time, sync.time)):
        raise AssertionError(f"[async] anchor clock {anchor.time} != "
                             f"{sync.time}")
    for k, v in sync.final_params.items():
        if not torch.equal(anchor.final_params[k].view(torch.int32),
                           v.view(torch.int32)):
            raise AssertionError(f"[async] anchor params {k} not bitwise "
                                 "the sync run's")
    want = {k: 0 for k in launched}
    want.update(mixing_aggregate=events, gram_matrix=1)
    if launched != want:
        raise AssertionError(f"[async] anchor launches {launched}, want "
                             f"{want}")
    print(f"  anchor ucfl_k4 K={m} wired: bitwise the sync run (history, "
          f"params), clock {anchor.time[-1]:.4f}; launches "
          f"{ {k: v for k, v in launched.items() if v} }  wall {wall:.2f} s "
          f"({wall / events:.4f} s/event incl. setup; the sync run "
          f"{sync_wall:.2f} s; {card})", flush=True)
    keep = None
    for label, spec, cfg, opts in ASYNC_RUNS:
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        h = run_federated(spec, fed, fl=fl, system=system, seed=0,
                          keep_state=True, device="cuda", async_cfg=cfg,
                          **opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
        counts = dict(ops.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_federated(spec, fed, fl=fl, system=system, seed=0,
                      device="cuda", async_cfg=cfg, **opts)
        torch.cuda.synchronize()
        again = time.perf_counter() - t0
        ops.LAUNCHES.update(counts)       # the second run does not count
        fx = h.extra.get("faults", {})
        skipped = fx.get("skipped_rounds", 0)
        want = {k: 0 for k in launched}
        want.update(mixing_aggregate=events - skipped,
                    gram_matrix=1 if spec.startswith("ucfl") else 0)
        if "channel" in opts:
            want["qsgd_roundtrip"] = events
        if launched != want:
            raise AssertionError(f"[async] {label}: launches {launched}, "
                                 f"want {want}")
        if len(h.comm) != events or h.extra["async"]["events"] != events:
            raise AssertionError(f"[async] {label}: {len(h.comm)} events")
        if any(c.n_streams > cfg.buffer_k for c in h.comm):
            raise AssertionError(f"[async] {label}: more streams than the "
                                 f"cohort: {h.comm}")
        if h.time != sorted(h.time) or not h.time[-1] > 0:
            raise AssertionError(f"[async] {label}: clock {h.time}")
        if not all(math.isfinite(a) for a in h.mean_acc + h.worst_acc):
            raise AssertionError(f"[async] {label}: non-finite accuracy "
                                 f"{h.mean_acc}")
        if "faults" in opts and fx.get("rounds") != events:
            raise AssertionError(f"[async] {label}: ledger {fx}")
        if keep is None and spec == "ucfl_k4":
            keep = h
        sync = sync_clock.get(spec)
        vs = "" if sync is None else f" (sync run {sync:.4f})"
        ledger = {k: fx[k] for k in ("retries", "dead_clients",
                                     "skipped_rounds") if k in fx}
        print(f"  {label:20s} mean_acc {[round(a, 4) for a in h.mean_acc]}"
              f"  clock {h.time[-1]:.4f}{vs}  streams "
              f"{sorted({c.n_streams for c in h.comm})}"
              + (f"  {ledger}" if ledger else "")
              + f"  launches { {k: v for k, v in launched.items() if v} }"
              f"  wall {wall:.2f} s ({wall / events:.4f} s/event incl. "
              f"setup), again {again:.2f} s ({again / events:.4f} s/event; "
              f"{card})", flush=True)
    label, spec, cfg, opts = ASYNC_RUNS[0]
    counts = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    got = async_trace(spec, fed, fl, cfg, system=system, **opts)
    traced = time.perf_counter() - t0
    ops.LAUNCHES.update(counts)
    if got is None:
        print(f"  trace of {label}: no device events; busy share not "
              f"measured ({card})", flush=True)
    else:
        wall, busy, n_kernels = got
        print(f"  trace of {label} ({events} events, setup included): wall "
              f"{wall:.1f} ms, device busy {busy:.1f} ms, idle "
              f"{1 - busy / wall:.1%}; {n_kernels} kernels; the trace took "
              f"{traced:.1f} s ({card})", flush=True)
    return keep


def _tree_equal(a, b) -> bool:
    """Nested dicts of tensors (None kept) equal bit for bit."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_tree_equal(a[k], b[k]) for k in a))
    if a is None or b is None:
        return a is None and b is None
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.device == b.device
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8)))


def checkpoint_path(h, card: str) -> None:
    """[checkpoint]: the run's final params and optimizer state, and a
    bf16 copy of the params, saved from the card and restored onto it
    bitwise; the same file with one byte flipped must raise."""
    ckpt = Path(__file__).resolve().parent / "build" / "checkpoint"
    path = str(ckpt / "async.msgpack")
    params, opt = h.final_params, h.final_opt_state
    bf16 = {k: v.to(torch.bfloat16) for k, v in params.items()}
    t0 = time.perf_counter()
    save_train_state(path, MAIN["rounds"], params, opt,
                     extra={"bf16": bf16, "spec": "ucfl_k4"})
    saved = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, p, o, extra = restore_train_state(path, device="cuda")
    torch.cuda.synchronize()
    restored = time.perf_counter() - t0
    if (step != MAIN["rounds"] or extra["spec"] != "ucfl_k4"
            or not _tree_equal(p, params) or not _tree_equal(o, opt)
            or not _tree_equal(extra["bf16"], bf16)):
        raise AssertionError("[checkpoint] restored state differs")
    blob = bytearray(Path(path).read_bytes())
    blob[len(blob) // 2] ^= 0x04
    bad = ckpt / "flipped.msgpack"
    bad.write_bytes(bytes(blob))
    try:
        restore_train_state(str(bad), device="cuda")
    except CheckpointCorruptError as e:
        why = str(e).split(": ", 1)[1][:40]
    else:
        raise AssertionError("[checkpoint] a flipped byte restored")
    print(f"  params + opt state + bf16 params ({len(blob) / 2**20:.2f} "
          f"MiB): save {saved:.3f} s, restore {restored:.3f} s, bitwise on "
          f"the card; one flipped byte raises ({why}...) ({card})",
          flush=True)


# flushes: enough that the batches after the first flush (8 a flush of
# 128 at max_batch 16, 16 a flush of 1,024 at 64) number over 100, so
# their p99 is not their max
SERVE = dict(codecs=("identity", "qsgd:4", "topk:0.25"), requests=128,
             flushes=14, max_batch=16, users=2048, big_requests=1024,
             big_flushes=8, big_batch=64, big_parity=64)


def serve_apply(params, x):
    """One user's LeNet-5 params x one image -> logits (the engine vmaps
    it over the batch)."""
    return lenet.apply(params, x[None])[0]


def serve_flushes(engine, fed, n_users: int, n_req: int, flushes: int,
                  rng) -> tuple:
    """``flushes`` times: ``n_req`` requests of users drawn by ``rng``
    (each a validation image of user u mod m), submitted and flushed.
    Returns ([wall s a flush], [chunk latencies of every flush but the
    first], dequantize launches, batches) and checks every output is
    finite logits."""
    walls, lat, batches = [], [], 0
    m, n_val = fed.x_val.shape[:2]
    before = ops.LAUNCHES["qsgd_dequantize"]
    for f in range(flushes):
        users = rng.integers(0, n_users, n_req)
        j = torch.as_tensor(rng.integers(0, n_val, n_req), device="cuda")
        xs = fed.x_val[torch.as_tensor(users % m, device="cuda"), j]
        for u, x in zip(users.tolist(), xs):
            engine.submit(u, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = engine.flush()
        walls.append(time.perf_counter() - t0)
        if f:
            lat += engine.last_stats["latency_s"]
        batches += engine.last_stats["batches"]
        if len(outs) != n_req or not all(
                o.shape == (47,) and bool(np.isfinite(o).all())
                for o in outs):
            raise AssertionError("[serve] outputs not finite (47,) logits")
    return walls, lat, ops.LAUNCHES["qsgd_dequantize"] - before, batches


def serve_trace(engine, fed, n_req: int) -> tuple:
    """One torch.profiler trace of a flush of ``n_req`` requests: (wall
    ms under the profiler, device-busy ms, device events, batches)."""
    rng = np.random.default_rng(1)
    users = rng.integers(0, engine.store.m, n_req)
    xs = fed.x_val[torch.as_tensor(users % fed.x_val.shape[0],
                                   device="cuda"), 0]
    for u, x in zip(users.tolist(), xs):
        engine.submit(u, x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.flush()
        wall = time.perf_counter() - t0
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not events:
        return wall * 1e3, None, 0, engine.last_stats["batches"]
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    return (wall * 1e3, busy_us(spans) / 1e3, len(events),
            engine.last_stats["batches"])


def serve_report(label, store, engine, fed, n_users, n_req, flushes,
                 card) -> list:
    """Times ``flushes`` flushes of ``n_req`` requests and prints
    requests/s, batch p50 / p99 / max and the store's bytes; returns the
    flushes' walls (s)."""
    walls, lat, deq, batches = serve_flushes(
        engine, fed, n_users, n_req, flushes, np.random.default_rng(0))
    want_deq = batches if store.codec.spec.startswith("qsgd") else 0
    if deq != want_deq:
        raise AssertionError(f"[serve] {label}: {deq} dequantize launches "
                             f"for {batches} batches")
    lat_ms = sorted(x * 1e3 for x in lat)
    if len(lat_ms) < 100:
        raise AssertionError(f"[serve] {label}: {len(lat_ms)} batches are "
                             "too few for a p99")
    p50 = statistics.median(lat_ms)
    p99 = lat_ms[math.ceil(0.99 * len(lat_ms)) - 1]     # nearest rank
    rps = sorted(n_req / w for w in walls)
    print(f"  {label}: {n_req} requests x{flushes} at max_batch "
          f"{engine.max_batch}: req/s median {statistics.median(rps):.1f} "
          f"(min {rps[0]:.1f}, max {rps[-1]:.1f}); batch p50 {p50:.3f} ms "
          f"p99 {p99:.3f} ms max {lat_ms[-1]:.3f} ms (the {len(lat_ms)} "
          f"batches after the first flush); bytes accounted "
          f"{store.bits.total_bytes} resident {store.resident_bytes()} "
          f"({card})", flush=True)
    return walls


def serve_decode_check(label, store, users) -> None:
    """The QSGD stream at a served shape: the decode of ``users``' gathered
    payload rows (as `ServeEngine.params_for` decodes them) bitwise its
    plain version; launches set aside."""
    rows = torch.as_tensor(np.asarray(users, np.int64), device="cuda")
    lv = store.payload["levels"].index_select(0, rows)
    am = store.payload["absmax"].index_select(0, rows)
    with ops.launches_set_aside():
        got = store.codec.decode({"levels": lv, "absmax": am}, d=store.d)
    same(f"[serve] {label} decode of {rows.numel()} rows", got,
         ref.qsgd_dequantize_ref(lv, am, store.codec.bits))


def serve_path(hists, fed, card: str) -> None:
    """[serve]: stores from [main]'s ucfl run (every user its own model)
    keyed on ucfl_k4's streams, one a codec, and ucfl_k4's own store
    (`from_history`, zero deltas): reconstruction, the parity anchor over
    the 20 users, timed flushes; then a 2,048-user qsgd:4 store."""
    m = MAIN["m"]
    ucfl, k4 = hists["ucfl"], hists["ucfl_k4"]
    asn = np.asarray(k4.extras.assignment)
    trained = stacked_ravel(ucfl.final_params)
    users = list(range(m))
    xs = fed.x_val[:, 0]
    stores, walls = [], {}
    for codec in SERVE["codecs"]:
        t0 = time.perf_counter()
        store = DeltaStore.build(ucfl.final_params, assignment=asn,
                                 codec=codec, device="cuda")
        torch.cuda.synchronize()
        stores.append((f"ucfl {codec}", store, time.perf_counter() - t0))
    t0 = time.perf_counter()
    own = DeltaStore.from_history(k4, codec="qsgd:4", device="cuda")
    torch.cuda.synchronize()
    stores.append(("ucfl_k4 own qsgd:4", own, time.perf_counter() - t0))
    k4_flat = stacked_ravel(k4.final_params)
    if not (1 <= own.k <= 4 and torch.equal(own.params_flat(), k4_flat)):
        raise AssertionError(f"[serve] ucfl_k4's own store: k={own.k}, or "
                             "its zero deltas do not give the params back")
    for label, store, build_s in stores:
        eng = ServeEngine(store, serve_apply, max_batch=SERVE["max_batch"])
        if store.codec.is_identity:
            if not torch.equal(store.params_flat().view(torch.int32),
                               trained.view(torch.int32)):
                raise AssertionError("[serve] the identity store does not "
                                     "give the trained params back bitwise")
            served = eng.serve(users, xs)
            direct = eng.forward(store.unravel_batch(trained), xs)
            if not torch.equal(served, direct):
                raise AssertionError("[serve] identity: served logits != "
                                     "the trained models' logits")
        top = check_parity(eng, users, xs)
        print(f"  {label}: k={store.k}, build {build_s:.3f} s, max recon "
              f"err {store.recon_err.max():.3e}, fixup entries "
              f"{store.fix_values.shape[1]}/user, parity anchor over {m} "
              f"users OK (max|logit| {top:.3f})", flush=True)
        walls[label] = serve_report(label, store, eng, fed, m,
                                    SERVE["requests"], SERVE["flushes"],
                                    card)
    # the qsgd:4 decode of one big batch's rows, timed alone
    q = stores[1][1]
    serve_decode_check("ucfl qsgd:4", q, range(SERVE["max_batch"]))
    rows = torch.arange(SERVE["big_batch"], device="cuda") % m
    enc = {k: v.index_select(0, rows) for k, v in q.payload.items()}
    with ops.launches_set_aside():
        dec_ms = time_ms(lambda: q.codec.decode(enc, d=q.d))
    print(f"  qsgd:4 decode of {SERVE['big_batch']} rows: {dec_ms:.4f} ms "
          f"(bound {bound_ms(8 * SERVE['big_batch'] * q.d, 0)[0]:.4f} ms, "
          "bytes)", flush=True)
    # the micro-batcher's contract on the card: each request of a batch of
    # 16 against it alone and in a batch of 2 (cuBLAS picks its GEMM by
    # the batch count: within the parity anchor's rtol 1e-5 of the
    # batch's max |logit|, not bitwise)
    eng = ServeEngine(q, serve_apply, max_batch=SERVE["max_batch"])
    n16 = SERVE["max_batch"]
    batch = eng.serve(list(range(n16)), fed.x_val[:n16, 0])
    alone = max(float((eng.serve([u], fed.x_val[u:u + 1, 0])[0]
                       - batch[u]).abs().max()) for u in range(n16))
    pair = max(float((eng.serve([u, (u + 1) % n16],
                                fed.x_val[[u, (u + 1) % n16], 0])[0]
                      - batch[u]).abs().max()) for u in range(n16))
    tol = 1e-5 * float(batch.abs().max())
    if max(alone, pair) > tol:
        raise AssertionError(f"[serve] a request alone or in a batch of 2 "
                             f"differs by {max(alone, pair):.3e} > {tol:.3e}"
                             " from it in a batch")
    print(f"  micro-batcher contract: a request in a batch of {n16} against "
          f"it alone max |Δlogit| {alone:.3e}, in a batch of 2 "
          f"{pair:.3e} (bound {tol:.3e}: rtol 1e-5 of max |logit|)",
          flush=True)
    with ops.launches_set_aside():
        wall, busy, n_ev, nb = serve_trace(eng, fed, SERVE["requests"])
    # the busy share against this run's untraced flushes of the same
    # store and size (the profiler slows the host's side)
    plain = statistics.median(walls["ucfl qsgd:4"]) * 1e3
    busy_s = "not measured (no device events)" if busy is None else (
        f"device busy {busy:.3f} ms: {100 * busy / wall:.1f} % of it, "
        f"{100 * busy / plain:.1f} % of the median untraced flush of this "
        f"store ({plain:.3f} ms); {n_ev / nb:.1f} device events a batch")
    print(f"  ucfl qsgd:4 traced flush of {SERVE['requests']} requests "
          f"({nb} batches): wall {wall:.3f} ms under the profiler, "
          f"{busy_s} ({card})", flush=True)

    # (b) a 2,048-user population: user u is ucfl's model u mod m plus
    # Gaussian noise at 1e-2 of each leaf's std, on stream asn[u mod m]
    n = SERVE["users"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.arange(n, device="cuda") % m
    big = {k: v[idx] + 1e-2 * v.std() * torch.randn(
        (n,) + tuple(v.shape[1:]), generator=gen, device="cuda")
        for k, v in ucfl.final_params.items()}
    # the stochastic-rounding noise given, so that the encode can be held
    # to its plain version on the same inputs below
    noise = torch.rand((n, D_LENET), generator=gen, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = DeltaStore.build(big, assignment=asn[np.arange(n) % m],
                             codec="qsgd:4", noise=noise, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the row pass's encode at (2,048, 47,571): the store's levels and
    # absmax bitwise the plain version's of the same delta and noise
    flat = stacked_ravel(big)
    del big
    base_rows = store.base_flat.index_select(
        0, torch.as_tensor(store.assignment, device="cuda"))
    lv, am = ref.qsgd_quantize_ref(refined_delta(flat, base_rows), noise,
                                   store.codec.bits)
    same(f"[serve] {n}-user qsgd:4 levels", store.payload["levels"], lv)
    same(f"[serve] {n}-user qsgd:4 absmax", store.payload["absmax"], am)
    del flat, base_rows, noise, lv, am
    eng = ServeEngine(store, serve_apply, max_batch=SERVE["big_batch"])
    probe = np.random.default_rng(2).choice(n, SERVE["big_parity"],
                                            replace=False)
    # the stream at a served batch's shape and at the full decode's
    serve_decode_check(f"{n}-user qsgd:4", store, probe)
    serve_decode_check(f"{n}-user qsgd:4", store, range(n))
    top = check_parity(eng, probe, fed.x_val[torch.as_tensor(
        probe % m, device="cuda"), 0])
    print(f"  {n}-user qsgd:4 store: k={store.k}, build {build_s:.3f} s, "
          f"levels {store.payload['levels'].numel() * 4 / 2**20:.1f} MiB "
          f"resident, max recon err {store.recon_err.max():.3e}; encode "
          f"({n}, {store.d}) and decodes of {SERVE['big_parity']} and {n} "
          f"rows bitwise their plain versions; parity anchor on "
          f"{SERVE['big_parity']} users OK (max|logit| {top:.3f})",
          flush=True)
    serve_report(f"{n}-user qsgd:4", store, eng, fed, n,
                 SERVE["big_requests"], SERVE["big_flushes"], card)


# [paging]: the cohort paging engine.  [main]'s scenario widened to a
# population of 1,000 clients over 100,000 samples, its data and its
# client-state store on the host, one cohort of 20 on the card at a time;
# ucfl_k4 + qsgd:8 under wireless_slow, so the store carries
# error-feedback residuals and every round runs the QSGD row pass
PAGING = dict(n=100_000, population=1000, cohort=20, rounds=20,
              eval_every=1, spec="ucfl_k4", codec="qsgd:8", small=200,
              overlap=40, resume=100, resume_rounds=6, preempt=3,
              async_k=5)
MIB = 2 ** 20


def _host_rows(tree, idx=None):
    """A nested dict of tensors on the host, its rows ``idx`` if given."""
    if isinstance(tree, dict):
        return {k: _host_rows(v, idx) for k, v in tree.items()}
    if tree is None:
        return None
    return (tree if idx is None else tree[torch.as_tensor(idx)]).cpu()


def _same_paged(label: str, a, b, rows=None) -> None:
    """Two runs' histories equal and their final rows (params, optimizer
    state, residuals; ``a``'s rows ``rows`` when given) bitwise."""
    for field in ("rounds", "mean_acc", "worst_acc", "time", "comm",
                  "comm_bits"):
        if getattr(a, field) != getattr(b, field):
            raise AssertionError(f"[paging] {label}: {field} differs: "
                                 f"{getattr(a, field)} != "
                                 f"{getattr(b, field)}")
    for part in ("final_params", "final_opt_state", "final_residual"):
        if not _tree_equal(_host_rows(getattr(a, part), rows),
                           _host_rows(getattr(b, part))):
            raise AssertionError(f"[paging] {label}: {part} not bitwise")


def _overlap_us(spans, cover) -> float:
    """µs of the (start, end) ``spans`` that lie under the union of the
    sorted ``cover`` spans."""
    merged = []
    for st, en in cover:
        if merged and st <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], en)
        else:
            merged.append([st, en])
    total = 0.0
    for st, en in spans:
        for cs, ce in merged:
            total += max(0.0, min(en, ce) - max(st, cs))
    return total


def paging_trace(fed, kw: dict):
    """One torch.profiler trace of a 4-superstep sweep with prefetch on;
    the window runs from the host taking superstep 1's draws to the end
    of the run, so it holds supersteps 1-3 (their setups, copies,
    replays and writebacks).  Returns the window's wall, device busy (the
    union of every device span), kernel busy, and the H2D / D2H copy
    time with the part of it under kernel spans; None without device
    events."""
    from repro_torch.fl import PagingConfig
    draws = WindowDraws(11, first=1)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run_federated(PAGING["spec"], fed, draws=draws,
                      paging=PagingConfig(cohort=PAGING["cohort"]),
                      **{**kw, "fl": dataclasses.replace(kw["fl"],
                                                         rounds=4)})
        torch.cuda.synchronize()
        wall = time.perf_counter() - draws.t0
        draws.range.__exit__(None, None, None)
    start = min(e.time_range.start for e in prof.events()
                if e.name == "window")
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name != "window" and e.time_range.start >= start]
    if not dev:
        return None
    span = lambda e: (e.time_range.start, e.time_range.end)
    kernels = sorted(span(e) for e in dev
                     if not e.name.startswith(("Memcpy", "Memset")))
    h2d = [span(e) for e in dev if "HtoD" in e.name]
    d2h = [span(e) for e in dev if "DtoH" in e.name]
    out = {"wall": wall * 1e3,
           "busy": busy_us(sorted(span(e) for e in dev)) / 1e3,
           "kernels": busy_us(kernels) / 1e3 if kernels else 0.0,
           "n_kernels": len(kernels)}
    for name, spans in (("h2d", h2d), ("d2h", d2h)):
        out[name] = sum(en - st for st, en in spans) / 1e3
        out[name + "_n"] = len(spans)
        out[name + "_under"] = _overlap_us(spans, kernels) / 1e3
    return out


def paging_path(card: str) -> None:
    """[paging]: (a) a paged `FixedCohort` of 20 rows bitwise the resident
    fused run on its sub-population; (b) a 20-superstep sweep over the
    1,000 clients, prefetch on and off bitwise, s/superstep, and a
    profiler trace of three supersteps; (c) overlapping random cohorts
    (population 40) bitwise prefetch off; (d) peak device memory of the
    sweep at populations 200 and 1,000 within 1 MiB (the requested bytes,
    the allocated ones printed beside); (e) a memmap-store
    run preempted and resumed bitwise, then past a corrupt newest
    snapshot; (f) the async lockstep anchor bitwise the resident
    `run_async`, then K = 5 over the 1,000 clients.  Each run's launches
    are stated: a mix and a QSGD row pass a round, a Gram a cohort
    setup."""
    import gc
    import shutil
    from repro_torch.fl import (FixedCohort, PagingConfig, RandomCohorts,
                                run_async, sub_federated)
    from repro_torch.fl.simulator import default_model_init
    cfg, m_c, rounds = PAGING, PAGING["cohort"], PAGING["rounds"]
    t0 = time.perf_counter()
    dev_fed = scenario_label_shift(0, n=cfg["n"], m=cfg["population"],
                                   device="cuda")
    fed = FederatedData(*(t.cpu() for t in dev_fed))
    del dev_fed
    torch.cuda.empty_cache()
    data_mib = sum(t.numel() * t.element_size() for t in fed) / MIB
    fl = FLConfig(rounds=rounds, local_steps=MAIN["local_steps"],
                  batch_size=MAIN["batch_size"], eval_every=cfg["eval_every"])
    kw = dict(fl=fl, system=SYSTEMS["wireless_slow"],
              channel=Channel(codec=cfg["codec"]),
              model_init=default_model_init(fed), seed=0, device="cuda")
    print(f"  population {fed.m} clients over {cfg['n']} samples, x "
          f"{tuple(fed.x.shape)} on the host: data {data_mib:.1f} MiB, a "
          f"cohort's page {data_mib * m_c / fed.m:.1f} MiB; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def pop(k):
        """The first k clients (the population's padded shapes)."""
        return fed if k == fed.m else sub_federated(fed, np.arange(k))

    def run(f, spec=cfg["spec"], fn=run_federated, **extra):
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        h = fn(spec, f, **{**kw, **extra})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return h, wall, {k: ops.LAUNCHES[k] - before[k] for k in before
                         if ops.LAUNCHES[k] != before[k]}

    def want_launches(label, got, rounds_, setups):
        want = {"mixing_aggregate": rounds_, "qsgd_roundtrip": rounds_,
                "gram_matrix": setups}
        if got != want:
            raise AssertionError(f"[paging] {label}: launches {got}, want "
                                 f"{want}")

    # (a) the anchor: 20 rows spread over the population
    idx = np.arange(m_c) * (fed.m // m_c)
    h_pag, wall, got = run(fed, keep_state=True,
                           paging=PagingConfig(schedule=FixedCohort(idx)))
    want_launches("(a) paged", got, rounds, 1)
    sub = FederatedData(*(t.cuda() for t in sub_federated(fed, idx)))
    h_res, res_wall, got_res = run(sub, keep_state=True, superstep=True)
    if got_res != got:
        raise AssertionError(f"[paging] (a) resident launches {got_res}")
    _same_paged("(a) FixedCohort against resident", h_pag, h_res, rows=idx)
    del sub, h_pag, h_res
    print(f"  (a) FixedCohort {m_c} rows paged: bitwise the resident "
          f"fused run on the sub-population (history, params, optimizer "
          f"state, EF residuals); paged {wall:.2f} s (first run, the "
          f"graph's capture included), resident {res_wall:.2f} s; launches "
          f"{got} ({card})", flush=True)

    # (b) the sweep: 20 disjoint cohorts, prefetch on and off
    sweeps = {}
    for prefetch in (True, False):
        sweeps[prefetch] = run(fed, keep_state=True, paging=PagingConfig(
            cohort=m_c, prefetch=prefetch))
        want_launches(f"(b) prefetch {prefetch}", sweeps[prefetch][2],
                      rounds, rounds)
    _same_paged("(b) sweep prefetch on against off", sweeps[True][0],
                sweeps[False][0])
    h = sweeps[True][0]
    store_mb = h.extra["paging"]["store_bytes"] / 1e6
    accs = [round(a, 4) for a in h.mean_acc]
    print(f"  (b) sweep, {rounds} supersteps of one round and its eval, "
          f"cohort {m_c}: store {store_mb:.1f} MB on the host "
          f"({store_mb * 1e3 / fed.m:.1f} kB a client: params, momentum, "
          f"EF); prefetch on and off bitwise (history and every store "
          f"row); {sweeps[True][1] / rounds:.4f} s/superstep with "
          f"prefetch, {sweeps[False][1] / rounds:.4f} without (UCFL setup "
          f"of each new cohort included); mean_acc {accs[:3]}...{accs[-1]}"
          f"; launches {sweeps[True][2]} ({card})", flush=True)
    del sweeps, h
    tr = paging_trace(fed, kw)
    if tr is None:
        print(f"  (b) trace: no device events in the window; busy share "
              f"and copy overlap not measured ({card})", flush=True)
    else:
        print(f"  (b) trace of supersteps 1-3: wall {tr['wall']:.1f} ms, "
              f"device busy {tr['busy']:.1f} ms ({tr['busy'] / tr['wall']:.1%}"
              f"), kernels {tr['kernels']:.1f} ms ({tr['n_kernels']}); H2D "
              f"{tr['h2d']:.2f} ms in {tr['h2d_n']} copies, "
              f"{tr['h2d_under']:.2f} ms of it under kernels; D2H "
              f"{tr['d2h']:.2f} ms in {tr['d2h_n']} copies, "
              f"{tr['d2h_under']:.2f} ms under kernels: the copies overlap "
              f"the replay and the setups' kernels for "
              f"{(tr['h2d_under'] + tr['d2h_under']) / (tr['h2d'] + tr['d2h']):.0%}"
              f" of their time ({card})", flush=True)

    # (c) overlapping cohorts: the drain-before-gather path
    sched = RandomCohorts(m_c, seed=0)
    overlaps = sum(np.intersect1d(sched.indices(t, cfg["overlap"]),
                                  sched.indices(t + 1, cfg["overlap"])).size
                   > 0 for t in range(rounds - 1))
    if overlaps != rounds - 1:
        raise AssertionError(f"[paging] (c) {overlaps} overlapping steps")
    f40 = pop(cfg["overlap"])
    runs = [run(f40, keep_state=True, paging=PagingConfig(
        schedule=sched, prefetch=prefetch)) for prefetch in (True, False)]
    _same_paged("(c) random cohorts prefetch on against off", runs[0][0],
                runs[1][0])
    print(f"  (c) population {cfg['overlap']}, random cohorts of {m_c} "
          f"(every step overlaps the last): prefetch on and off bitwise; "
          f"{runs[0][1] / rounds:.4f} and {runs[1][1] / rounds:.4f} "
          f"s/superstep ({card})", flush=True)
    del runs, f40

    # (d) device memory follows the cohort, not the population: the peak
    # of the bytes the run's tensors asked for.  The allocator's
    # allocated bytes add the unsplit tail of whichever cached block a
    # request lands in (up to 1 MiB a large request), which follows the
    # blocks earlier phases left behind, not the run: printed beside it.
    # A keep_state run leaves reference cycles that hold tensors, freed
    # whenever the collector next runs (inside either sweep, or neither):
    # collected before each base read, so both peaks start from live
    # tensors only
    peaks = {}
    for n_pop in (cfg["small"], fed.m):
        f = pop(n_pop)
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_stats()["requested_bytes.all.current"]
        torch.cuda.reset_peak_memory_stats()
        h, wall, _ = run(f, paging=PagingConfig(cohort=m_c))
        peaks[n_pop] = (torch.cuda.memory_stats()["requested_bytes.all.peak"],
                        base, h.extra["paging"]["store_bytes"], wall,
                        torch.cuda.max_memory_allocated())
    (p_s, b_s, s_s, w_s, a_s), (p_l, b_l, s_l, w_l, a_l) = peaks.values()
    if abs(p_s - p_l) > MIB:
        raise AssertionError(f"[paging] (d) peak device memory {p_s} at "
                             f"{cfg['small']} clients, {p_l} at {fed.m}")
    print(f"  (d) peak device memory of the sweep (requested bytes): "
          f"{p_s / MIB:.2f} MiB at {cfg['small']} clients "
          f"({(p_s - b_s) / MIB:.2f} over the {b_s / MIB:.2f} MiB already "
          f"held; store {s_s / 1e6:.1f} MB), {p_l / MIB:.2f} MiB at {fed.m} "
          f"({(p_l - b_l) / MIB:.2f} over; store {s_l / 1e6:.1f} MB): "
          f"within {abs(p_s - p_l) / MIB:.3f} MiB (allocated bytes "
          f"{a_s / MIB:.2f} and {a_l / MIB:.2f} MiB); {w_l / rounds:.4f} "
          f"s/superstep without keep_state ({card})", flush=True)

    # (e) preempt and resume, memmap store, TorchDraws
    root = Path(__file__).resolve().parent / "build" / "paging"
    shutil.rmtree(root, ignore_errors=True)
    f100 = pop(cfg["resume"])
    fl_r = dataclasses.replace(fl, rounds=cfg["resume_rounds"])
    base = dict(cohort=m_c, store_dir=str(root / "store"),
                checkpoint_dir=str(root / "ck"))
    full, _, _ = run(f100, fl=fl_r, keep_state=True,
                     paging=PagingConfig(cohort=m_c))
    part, _, _ = run(f100, fl=fl_r, paging=PagingConfig(
        max_chunks=cfg["preempt"], **base))
    if part.rounds != full.rounds[:cfg["preempt"]]:
        raise AssertionError(f"[paging] (e) preempted run {part.rounds}")
    t0 = time.perf_counter()
    res, _, _ = run(f100, fl=fl_r, keep_state=True,
                    paging=PagingConfig(resume=True, **base))
    res_wall = time.perf_counter() - t0
    _same_paged("(e) resumed against uninterrupted", res, full)
    if res.extra["paging"]["resumed_at"] != cfg["preempt"]:
        raise AssertionError(f"[paging] (e) {res.extra['paging']}")
    snaps = sorted((root / "ck").iterdir())
    snap_mib = snaps[-1].stat().st_size / MIB
    blob = bytearray(snaps[-1].read_bytes())
    blob[len(blob) // 2] ^= 0x10
    snaps[-1].write_bytes(bytes(blob))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        again, _, _ = run(f100, fl=fl_r, keep_state=True,
                          paging=PagingConfig(resume=True, **base))
    warned = [str(w.message) for w in caught
              if "failed its integrity check" in str(w.message)]
    if (len(warned) != 1
            or again.extra["paging"]["resumed_at"] != len(snaps) - 1):
        raise AssertionError(f"[paging] (e) fallback: {warned}, "
                             f"{again.extra['paging']}")
    _same_paged("(e) resumed past a corrupt snapshot", again, full)
    shutil.rmtree(root, ignore_errors=True)
    print(f"  (e) population {cfg['resume']}, memmap store, "
          f"{cfg['resume_rounds']} supersteps: preempted after "
          f"{cfg['preempt']}, resumed bitwise the uninterrupted run (resume "
          f"{res_wall:.2f} s, snapshots {snap_mib:.1f} MiB each); with the "
          f"newest snapshot's byte flipped the resume warned, fell back to "
          f"the one before and ended bitwise again ({card})", flush=True)
    del full, part, res, again, f100

    # (f) the paged async engine
    f20 = pop(m_c)
    akw = dict(system=SYSTEMS["wired"], keep_state=True,
               async_cfg=AsyncConfig(buffer_k=m_c))
    res, res_wall, got_res = run(
        FederatedData(*(t.cuda() for t in f20)), fn=run_async, **akw)
    pag, wall, got = run(f20, fn=run_async, paging=PagingConfig(cohort=m_c),
                         **akw)
    if got != got_res:
        raise AssertionError(f"[paging] (f) launches {got} != {got_res}")
    _same_paged("(f) async lockstep against resident", pag, res)
    print(f"  (f) async lockstep, population {m_c}, K={m_c}, wired: paged "
          f"bitwise the resident run_async (history, params, optimizer "
          f"state, EF); {wall / rounds:.4f} s/event paged, "
          f"{res_wall / rounds:.4f} resident; launches {got} ({card})",
          flush=True)
    k = cfg["async_k"]
    h, wall, got = run(fed, fn=run_async,
                       async_cfg=AsyncConfig(buffer_k=k),
                       paging=PagingConfig(cohort=k))
    want_launches("(f) K=5", got, rounds, got.get("gram_matrix", 0))
    if not (1 <= got["gram_matrix"] <= rounds) or not all(
            math.isfinite(a) for a in h.mean_acc):
        raise AssertionError(f"[paging] (f) K={k}: {got}, {h.mean_acc}")
    print(f"  (f) async K={k} over {fed.m} clients, {rounds} events, "
          f"wireless_slow: {wall / rounds:.4f} s/event (a UCFL setup an "
          f"event whose cohort is new); clock {h.time[-1]:.2f}, streams "
          f"{sorted({c.n_streams for c in h.comm})}; launches {got} "
          f"({card})", flush=True)


# [hierarchy]: the edge tier at [main]'s scenario; the reference tests'
# two-level configuration
HIER_TWO = dict(devices_per_user="ragged:2-4", edge_codec="qsgd:4",
                edge_link="tiered:4", edge_latency=0.5)
HIER_ASYNC_K = 5


def _hier_launches(label: str, got: dict, want: dict) -> None:
    """Fail unless ``got`` holds each of ``want``'s counts exactly."""
    bad = {k: (got.get(k, 0), n) for k, n in want.items()
           if got.get(k, 0) != n}
    if bad:
        raise AssertionError(f"[hierarchy] {label}: launches (got, want) "
                             f"{bad}; all {got}")


def _hier_finite(label: str, h) -> None:
    if not all(math.isfinite(a) for a in h.mean_acc + h.worst_acc):
        raise AssertionError(f"[hierarchy] {label}: non-finite accuracy "
                             f"{h.mean_acc}")


def _mesh_same(label: str, a, b, parts=("final_params",)) -> None:
    """History line for line and ``parts`` bitwise, or raise."""
    for field in ("rounds", "mean_acc", "worst_acc", "time", "comm",
                  "comm_bits"):
        if getattr(a, field) != getattr(b, field):
            raise AssertionError(f"[mesh] {label}: {field} differs: "
                                 f"{getattr(a, field)} != "
                                 f"{getattr(b, field)}")
    for part in parts:
        for k, v in getattr(b, part).items():
            if not torch.equal(getattr(a, part)[k].view(torch.int32),
                               v.view(torch.int32)):
                raise AssertionError(f"[mesh] {label}: {part} {k} not "
                                     "bitwise")


def mesh_path(fed, fl, hists, card: str) -> None:
    """[mesh]: `MeshShardMap` on the one-rank NCCL group at [main]'s
    scenario; see the module docstring (phase 10e)."""
    from repro_torch.core import MIX_SCHEDULES
    system, rounds, m = SYSTEMS["wireless_slow"], MAIN["rounds"], MAIN["m"]
    kw = dict(fl=fl, system=system, seed=0, device="cuda")

    def timed(placement=None, **extra):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_federated("ucfl_k4", fed, placement=placement, **{**kw, **extra})
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # (a) every schedule on both engines, bitwise [main]'s HostVmap runs
    for spec in ("ucfl_k4", "fedavg"):
        for schedule in MIX_SCHEDULES:
            runs = run_both(spec, fed, fl, system=system,
                            placement=MeshShardMap(schedule=schedule))
            for engine, h, launched, wall in runs:
                _mesh_same(f"{spec} {schedule} {engine}", h, hists[spec])
                want = {"mixing_aggregate": rounds,
                        "gram_matrix": 1 if spec == "ucfl_k4" else 0}
                got = {k: launched[k] for k in want}
                if got != want:
                    raise AssertionError(f"[mesh] {spec} {schedule} "
                                         f"{engine}: launches {launched}")
            print(f"  (a) {spec} {schedule}: fused and eventful bitwise "
                  f"[main]'s HostVmap run (history, clock, params); "
                  f"launches {got} an engine; walls "
                  f"{runs[0][3]:.3f} / {runs[1][3]:.3f} s incl. setup and "
                  f"the first capture ({card})", flush=True)
    # s/round and a traced chunk of each schedule, the flat HostVmap run
    # first, in turns with them
    for schedule in (None,) + MIX_SCHEDULES:
        pl = None if schedule is None else MeshShardMap(schedule=schedule)
        walls = [timed(pl) for _ in range(2)]
        setup = timed(pl, fl=dataclasses.replace(fl, rounds=0))
        line = (f"  (a) fused ucfl_k4 {schedule or 'HostVmap (flat)'}: "
                f"{(walls[-1] - setup) / rounds:.5f} s/round less setup "
                f"({walls[-1] / rounds:.5f} with it)")
        got = chunk_trace("ucfl_k4", fed, fl, system, None, placement=pl)
        if got is None:
            line += "; trace: no device events, busy share not measured"
        else:
            wall, busy, parts, n_kernels, by_name = got
            # the collectives' share is their NCCL kernels'; the device
            # copies are printed beside them, and the flat run has its
            # own, so a one-rank collective that runs no kernel shows
            # only as copies above the flat run's
            coll = sum(ms for name, ms in by_name.items()
                       if "nccl" in name.lower())
            copies = sum(ms for name, ms in by_name.items()
                         if "memcpy" in name.lower())
            line += (f"; a traced 5-round chunk busy {busy:.3f} of "
                     f"{wall:.3f} ms ({busy / wall:.1%}), NCCL kernels "
                     f"{coll:.4f} ms ({coll / busy:.3%} of busy), device "
                     f"copies {copies:.4f} ms, mix {parts['mix']:.4f} ms, "
                     f"{n_kernels} kernels")
        print(line + f" ({card})", flush=True)

    # (b) the codecs on the mesh's "jnp" backend
    for codec in ("qsgd:4", "topk:0.1"):
        ch = dict(channel=Channel(codec=codec), keep_state=True)
        host = run_federated("ucfl_k4", fed, **kw, **ch)
        mesh = run_federated("ucfl_k4", fed, **kw, **ch,
                             placement=MeshShardMap(
                                 schedule="shard_map_streams"))
        if codec.startswith("qsgd"):
            _mesh_same(f"ucfl_k4 {codec}", mesh, host,
                       ("final_params", "final_residual"))
            print(f"  (b) ucfl_k4 {codec} on the \"jnp\" backend: bitwise "
                  f"the HostVmap run (history, params, residuals; "
                  f"{card})", flush=True)
            continue
        # the exact k-th magnitude against the bisection threshold: the
        # masks differ only where a row's cut falls between two floats
        # the bisection cannot split, which this run's rows never do
        # (0 differing coordinates in every run), so the runs are held
        # bitwise
        x = stacked_ravel(host.final_residual)
        k = get_codec(codec).k(x.shape[1])
        absx = x.abs()
        exact = absx >= torch.topk(absx, k, dim=1).values[:, -1:]
        bisect = absx >= ops.topk_threshold(absx, k=k)
        differ = int((exact != bisect).sum())
        _mesh_same(f"ucfl_k4 {codec}", mesh, host,
                   ("final_params", "final_residual"))
        print(f"  (b) ucfl_k4 {codec}: the exact k-th magnitude bitwise "
              f"the HostVmap run's bisection (history, params, "
              f"residuals); on the ({x.shape[0]}, {x.shape[1]}) final "
              f"residual rows, k = {k}, the two masks differ on {differ} "
              f"coordinates ({card})", flush=True)

    # (c) a served batch of 16 on a store file labelled with the
    # reference's "jnp" backend (the label its mesh runs write; both
    # backends decode alike)
    path = Path(__file__).resolve().parent / "build" / "mesh" / "jnp.msgpack"
    DeltaStore.from_history(hists["ucfl_k4"], codec="qsgd:4",
                            device="cuda").save(str(path))
    tree = restore(str(path), device="cpu")
    tree["backend"] = "jnp"
    save(str(path), tree)
    store = DeltaStore.load(str(path), device="cuda")
    if store.backend != "jnp":
        raise AssertionError("[mesh] serve: the store's label is lost")
    users = np.arange(16)
    xs = fed.x_val[torch.as_tensor(users % m, device=fed.x_val.device), 0]
    mesh_eng = ServeEngine(store, serve_apply,
                           placement=MeshShardMap(), max_batch=16)
    host_eng = ServeEngine(store, serve_apply, max_batch=16)
    n0 = ops.LAUNCHES["qsgd_dequantize"]
    got = mesh_eng.serve(users, xs)
    torch.cuda.synchronize()
    if ops.LAUNCHES["qsgd_dequantize"] - n0 != 1:
        raise AssertionError("[mesh] serve: one QSGD stream launch a batch")
    want = host_eng.serve(users, xs)
    if not torch.equal(got, want):
        raise AssertionError("[mesh] serve: the mesh batch is not the "
                             "HostVmap batch")
    check_parity(mesh_eng, users, xs)
    print(f"  (c) ServeEngine(placement=mesh) on a \"jnp\" qsgd:4 store: a "
          f"batch of 16 bitwise the HostVmap batch, check_parity ok, one "
          f"stream launch ({card})", flush=True)

    # (d) async on the mesh: the lockstep anchor, then K = 5
    pl = MeshShardMap(schedule="shard_map_streams")
    akw = dict(fl=fl, seed=0, keep_state=True, device="cuda", placement=pl)
    sync = run_federated("ucfl_k4", fed, system=SYSTEMS["wired"], **akw)
    anchor = run_federated("ucfl_k4", fed, system=SYSTEMS["wired"],
                           async_cfg=AsyncConfig(buffer_k=m), **akw)
    for field in ("rounds", "mean_acc", "worst_acc", "comm"):
        if getattr(anchor, field) != getattr(sync, field):
            raise AssertionError(f"[mesh] async anchor {field} differs")
    for k, v in sync.final_params.items():
        if not torch.equal(anchor.final_params[k].view(torch.int32),
                           v.view(torch.int32)):
            raise AssertionError(f"[mesh] async anchor params {k}")
    cfg = AsyncConfig(buffer_k=5, max_staleness=3, staleness_discount=0.8)
    out = {}
    for label, placement in (("mesh", pl), ("HostVmap", None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = run_federated("ucfl_k4", fed, fl=fl, system=system, seed=0,
                          keep_state=True, device="cuda", async_cfg=cfg,
                          placement=placement)
        torch.cuda.synchronize()
        out[label] = (h, time.perf_counter() - t0)
    (hm, wm), (hh, wh) = out["mesh"], out["HostVmap"]
    # the mesh updates all 20 rows and masks, HostVmap gathers the 5:
    # the update's GEMMs batch other counts of rows, and on this card
    # they read bitwise alike in every run, so they are held so
    _mesh_same("async K=5", hm, hh)
    print(f"  (d) async: the lockstep anchor (K={m}) bitwise the mesh sync "
          f"run; K=5 {wm / rounds:.4f} s/event on the mesh (full-width "
          f"cohort update) against {wh / rounds:.4f} on HostVmap (row "
          f"gather), incl. setup; bitwise (history, clock, params; "
          f"{card})", flush=True)


def _timed_runs(module, walls: list):
    """Wrap an example module's `run_federated` so each run's wall
    (card synced) lands in ``walls``; returns the unwrapping call."""
    inner = module.run_federated

    def timed(spec, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = inner(spec, *a, **kw)
        torch.cuda.synchronize()
        channel = kw.get("channel")
        walls.append((spec if channel is None
                      else f"{spec} {channel.codec.spec}",
                      time.perf_counter() - t0))
        return h

    module.run_federated = timed
    return lambda: setattr(module, "run_federated", inner)


def _check_columns(label: str, spec: str, row: dict, m: int,
                   streams: int) -> None:
    """A row's streams, unicasts and round times against the table and
    the system models; its DL bits against the run's own payload; every
    eval's accuracies finite and in [0, 1]."""
    h = row["history"]
    want = downlink_cost(spec, m, n_streams=streams)
    got = (row["n_streams"], row["n_unicasts"])
    if got != want or tuple(h.comm[-1]) != want:
        raise AssertionError(f"[examples] {label}: streams/unicasts {got} "
                             f"(History.comm {tuple(h.comm[-1])}), "
                             f"downlink_cost {want}")
    times = [s.round_time(m, n_streams=want[0], n_unicasts=want[1])
             for s in SYSTEMS.values()]
    if row["times"] != times:
        raise AssertionError(f"[examples] {label}: round times "
                             f"{row['times']} against {times}")
    if h.comm_bits:
        payload = h.extra["channel"]["payload_bits"]
        if (row["dl_round"] != sum(want) * payload
                or row["dl_total"] != sum(c.dl_bits for c in h.comm_bits)
                or any(c.dl_bits != sum(want) * payload
                       for c in h.comm_bits)):
            raise AssertionError(f"[examples] {label}: DL bits "
                                 f"{row['dl_round']} / {row['dl_total']}"
                                 f" against {sum(want)} x {payload}")
    accs = list(h.mean_acc) + list(h.worst_acc)
    if not accs or not all(math.isfinite(a) and 0.0 <= a <= 1.0
                           for a in accs):
        raise AssertionError(f"[examples] {label}: accuracies {accs}")


def examples_path(card: str) -> None:
    """[examples]: the reference's examples as the port's entry points at
    their defaults; see the module docstring (phase 10f)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
    import comm_tradeoff_torch as comm_ex
    import personalization_emnist_torch as pers_ex
    import quickstart_torch as quick_ex

    # the quickstart, and the same datasets on the CPU
    datasets = quick_ex.make_datasets("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = quick_ex.quickstart(datasets, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    quick_ex.print_report(r)
    cpu = quick_ex.quickstart([{k: v.cpu() for k, v in d.items()}
                               for d in datasets], device="cpu")
    groups = r["groups"]
    inside = (r["W"] * (groups[:, None] == groups[None, :])).sum(1)
    w_gap = float(np.abs(r["W"] - cpu["W"]).max())
    print(f"  quickstart: {wall:.3f} s ({card}); W's mass on the true "
          f"group {np.round(inside, 4).tolist()}; assignment "
          f"{r['assignment'].tolist()} (CPU {cpu['assignment'].tolist()});"
          f" W card - CPU {w_gap:.3g}", flush=True)
    # the tolerance the CPU test holds the port's W to the reference's
    if not w_gap <= 1e-6:
        raise AssertionError(f"[examples] quickstart: W card - CPU {w_gap}"
                             " > 1e-6")
    if not (inside >= 0.9).all():
        raise AssertionError("[examples] quickstart: W does not recover "
                             f"the true groups: {inside.tolist()}")
    if not np.array_equal(r["assignment"], cpu["assignment"]):
        raise AssertionError("[examples] quickstart: assignment "
                             f"{r['assignment']} on the card, "
                             f"{cpu['assignment']} on the CPU")
    if not all(math.isfinite(v) for v in r["mse_fedavg"] + r["mse_ucfl"]):
        raise AssertionError("[examples] quickstart: MSE not finite")

    # comm_tradeoff at its defaults
    walls = []
    undo = _timed_runs(comm_ex, walls)
    try:
        fed, fl = comm_ex.default_case("cuda")
        t0 = time.perf_counter()
        r = comm_ex.tradeoff(fed, fl, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        undo()
    comm_ex.print_report(r)
    m = r["m"]
    for spec, k in comm_ex.SPECS:
        _check_columns(f"comm_tradeoff {spec}", spec, r["streams"][spec], m,
                       m if k is None else k)
    for codec, row in r["codecs"].items():
        _check_columns(f"comm_tradeoff {comm_ex.CODEC_SPEC} {codec}",
                       comm_ex.CODEC_SPEC, row, m, 2)
    # the silhouettes read W off the CODEC_SPEC run; the reference reads
    # it off the ucfl run: the two setups must give the same W
    w_sil, w_ucfl = (r["streams"][s]["history"].extras.mixing_matrix
                     for s in (comm_ex.CODEC_SPEC, "ucfl"))
    w_gap = float(np.abs(w_sil - w_ucfl).max())
    print(f"  comm_tradeoff: W of {comm_ex.CODEC_SPEC} - W of ucfl "
          f"{w_gap:.3g}", flush=True)
    if not w_gap <= 1e-6:
        raise AssertionError(f"[examples] comm_tradeoff: W of "
                             f"{comm_ex.CODEC_SPEC} and of ucfl differ by "
                             f"{w_gap}")
    if sorted(r["silhouette"]) != list(comm_ex.KS) or not all(
            math.isfinite(s) and -1.0 <= s <= 1.0
            for s in r["silhouette"].values()):
        raise AssertionError(f"[examples] silhouettes {r['silhouette']}")
    print(f"  comm_tradeoff: {wall:.2f} s; runs "
          + ", ".join(f"{s} {w:.2f} s" for s, w in walls)
          + f" ({card})", flush=True)

    # personalization_emnist at its defaults, on HostVmap, then on the
    # mesh over the NCCL group [mesh] started
    fed, fl = pers_ex.default_case(device="cuda")
    n_groups = int(torch.unique(fed.group).numel())
    streams = {"local": 0, "fedavg": 1, "ucfl_k4": 4, "oracle": n_groups}
    sweeps = {}
    for name, placement in (("host", None),
                            ("mesh gspmd", MeshShardMap(schedule="gspmd"))):
        walls = []
        undo = _timed_runs(pers_ex, walls)
        try:
            t0 = time.perf_counter()
            res = pers_ex.personalization(fed, fl, placement=placement,
                                          device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            undo()
        print(f"  personalization_emnist ({name}):", flush=True)
        pers_ex.print_report(res)
        for spec, row in res.items():
            _check_columns(f"personalization {name} {spec}", spec, row,
                           fed.m, streams[spec])
        print(f"  personalization_emnist ({name}): {wall:.2f} s; runs "
              + ", ".join(f"{s} {w:.2f} s" for s, w in walls)
              + f" ({card})", flush=True)
        sweeps[name] = res
    for spec, row in sweeps["host"].items():
        other = sweeps["mesh gspmd"][spec]
        if (row["mean_acc"] != other["mean_acc"]
                or row["worst_acc"] != other["worst_acc"]
                or row["history"].comm != other["history"].comm):
            raise AssertionError(f"[examples] personalization {spec}: the "
                                 "mesh sweep differs from the host one")


def hierarchy_path(fed, fl, base, card: str) -> None:
    """[hierarchy]: (a) `HierarchyConfig(devices_per_user=1)` with ucfl_k4
    on both engines bitwise [main]'s flat ucfl_k4 (``base``: history,
    clock, comm bits, final params, launches); (b) ucfl_k4 two-level
    (ragged:2-4 devices, qsgd:4 edge codec over a tiered:4 edge link,
    edge latency 0.5) fused bitwise eventful (history, edge books, final
    params and `EdgeState`), one QSGD row pass a round over the
    (m·d_max, F) device rows, s/round of a second run of each engine and
    of a setup-only run, a profiler trace of a 5-round chunk each;
    (c) a topk:0.1 edge codec, eventful: one top-k launch a round on the
    device rows; (d) drop_stragglers:0.4 with device_dropout 0.25: finite,
    fewer edge uplink bits than the mean aggregator's; (e) `run_async`
    two-level, K = 5, on a row-local plan and on a drop_stragglers plan
    (full-width partial events): s/event and a row pass an event."""
    from repro_torch.fl import HierarchyConfig
    from repro_torch.fl.placement.graphs import leaves
    system, rounds, m = SYSTEMS["wireless_slow"], fl.rounds, fed.m
    kw = dict(fl=fl, system=system)

    # (a) the flat anchor
    flat = HierarchyConfig(devices_per_user=1)
    for engine, h, got, wall in run_both("ucfl_k4", fed, fl, system=system,
                                         hierarchy=flat):
        for f in ("rounds", "mean_acc", "worst_acc", "time", "comm",
                  "comm_bits"):
            if getattr(h, f) != getattr(base, f):
                raise AssertionError(f"[hierarchy] (a) {engine}: {f} "
                                     "differs from [main]'s flat ucfl_k4")
        for k, v in base.final_params.items():
            if not torch.equal(h.final_params[k].view(torch.int32),
                               v.view(torch.int32)):
                raise AssertionError(f"[hierarchy] (a) {engine}: final "
                                     f"params {k} not bitwise [main]'s")
        _hier_launches(f"(a) {engine}", got,
                       {"mixing_aggregate": rounds, "gram_matrix": 1,
                        "qsgd_roundtrip": 0})
        print(f"  (a) devices_per_user=1, ucfl_k4 {engine:8s}: bitwise "
              f"[main]'s flat run (history, clock, comm bits, final "
              f"params); d_max {h.extra['hierarchy']['d_max']}; launches "
              f"{ {k: v for k, v in got.items() if v} }; wall {wall:.2f} s "
              f"({card})", flush=True)

    # (b) two-level, both engines
    two = HierarchyConfig(**HIER_TWO)
    runs = run_both("ucfl_k4", fed, fl, system=system, hierarchy=two)
    (_, hf, _, _), (_, he, _, _) = runs
    if hf.extra["hierarchy"] != he.extra["hierarchy"]:
        raise AssertionError("[hierarchy] (b) fused and eventful edge books "
                             "differ")
    for a, b in zip(leaves(hf.final_opt_state), leaves(he.final_opt_state),
                    strict=True):
        if not torch.equal(a, b):
            raise AssertionError("[hierarchy] (b) fused and eventful final "
                                 "EdgeState not bitwise equal")
    if he.final_opt_state.edge_ef is None:
        raise AssertionError("[hierarchy] (b) no edge EF residuals")
    ex = he.extra["hierarchy"]
    d_max = ex["d_max"]
    setup_walls = []
    for engine, h, got, wall in runs:
        _hier_finite(f"(b) {engine}", h)
        _hier_launches(f"(b) {engine}", got,
                       {"mixing_aggregate": rounds, "gram_matrix": 1,
                        "qsgd_roundtrip": rounds, "topk_threshold": 0})
    timed = {}
    for engine, superstep in (("fused", None), ("eventful", False),
                              ("setup", False)):
        f = fl if engine != "setup" else dataclasses.replace(fl, rounds=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_federated("ucfl_k4", fed, fl=f, system=system, seed=0,
                      device="cuda", superstep=superstep, hierarchy=two)
        torch.cuda.synchronize()
        timed[engine] = time.perf_counter() - t0
    print(f"  (b) two-level ucfl_k4, devices {ex['devices_per_user']} "
          f"(d_max {d_max}, {m * d_max} device rows of {D_LENET}), qsgd:4 "
          f"over tiered:4, latency 0.5: fused = eventful (history, edge "
          f"books, final params, EdgeState bitwise); clock "
          f"{he.time[-1]:.4f}, edge bits dl {ex['edge_dl_bits_total']} ul "
          f"{ex['edge_ul_bits_total']}; mean_acc "
          f"{[round(a, 4) for a in he.mean_acc]} ({card})", flush=True)
    for engine, h, got, wall in runs:
        run_s = timed[engine]
        print(f"      {engine:8s}: {run_s / rounds:.5f} s/round incl. setup "
              f"({(run_s - timed['setup']) / rounds:.5f} less the "
              f"setup-only run, {timed['setup']:.3f} s; first run "
              f"{wall:.2f} s); QSGD row pass launches "
              f"{got['qsgd_roundtrip']} ({got['qsgd_roundtrip'] / rounds:g} "
              f"a round); launches { {k: v for k, v in got.items() if v} } "
              f"({card})", flush=True)
    for engine, superstep in (("fused", None), ("eventful", False)):
        got = chunk_trace("ucfl_k4", fed, fl, system, superstep,
                          hierarchy=two)
        if got is None:
            print(f"      {engine:8s} trace: no device events in the "
                  f"window; busy share not measured ({card})", flush=True)
            continue
        wall, busy, parts, n_kernels, by_name = got
        # the QSGD row pass is `row_kernel` (kernels/csrc/quantize.cu)
        row_ms = sum(v for k, v in by_name.items() if "row_kernel" in k)
        print(f"      {engine:8s} trace of a 5-round chunk: wall "
              f"{wall:.3f} ms, device busy {busy:.3f} ms ({busy / wall:.1%}"
              f"), idle {1 - busy / wall:.1%}; "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
              + f" (the row pass {row_ms:.4f} ms of the local update); "
              f"{n_kernels} kernels ({card})", flush=True)
    # the edge crossing's kernels alone at its (m·d_max, F) rows, through
    # the uncounted entry points (these launches are no path's)
    gen = torch.Generator(device="cuda").manual_seed(26)
    rows = m * d_max
    x = torch.randn((rows, D_LENET), generator=gen, device="cuda") * 1e-2
    u = torch.rand((rows, D_LENET), generator=gen, device="cuda")
    same(f"qsgd_roundtrip ({rows}, {D_LENET}) bits=4",
         qsgd.qsgd_roundtrip_cuda(x, u, 4), ref.qsgd_roundtrip_ref(x, u, 4))
    a, k = x.abs(), -(-D_LENET // 10)
    same(f"topk_threshold ({rows}, {D_LENET})", topk_threshold_cuda(a, k),
         ref.topk_threshold_ref(a, k))
    x_bytes = x.numel() * 4
    for name, fn, plain, n_bytes in (
            ("QSGD row pass qsgd:4",
             lambda: qsgd.qsgd_roundtrip_cuda(x, u, 4),
             lambda: ref.qsgd_roundtrip_ref(x, u, 4), 3 * x_bytes),
            ("top-k threshold k=4,758", lambda: topk_threshold_cuda(a, k),
             lambda: ref.topk_threshold_ref(a, k), x_bytes + rows * 4)):
        bound, by = bound_ms(n_bytes, 0.0)
        print(f"      {name} at the device rows ({rows}, {D_LENET}): "
              f"bitwise its plain version; kernel {time_ms(fn):.4f} ms, "
              f"plain {time_ms(plain, iters=10):.4f} ms, bound {bound:.4f} "
              f"ms ({by}) ({card})", flush=True)
    del x, u, a

    # (c) a top-k edge codec, eventful
    topk = HierarchyConfig(**dict(HIER_TWO, edge_codec="topk:0.1"))
    (_, h, got, wall), = run_both("ucfl_k4", fed, fl, engines=("eventful",),
                                  system=system, hierarchy=topk)
    _hier_finite("(c)", h)
    _hier_launches("(c)", got, {"topk_threshold": rounds,
                                "qsgd_roundtrip": 0,
                                "mixing_aggregate": rounds})
    print(f"  (c) topk:0.1 edge codec, eventful: {got['topk_threshold']} "
          f"top-k launches on the ({m * d_max}, {D_LENET}) device rows; "
          f"mean_acc {[round(a, 4) for a in h.mean_acc]}; "
          f"{wall / rounds:.4f} s/round incl. setup ({card})", flush=True)

    # (d) straggler dropping with device dropout
    dd = dict(devices_per_user="ragged:2-4", edge_link="tiered:4",
              device_dropout=0.25)
    books = {}
    for agg in ("drop_stragglers:0.4", "mean"):
        h = run_federated("ucfl_k4", fed, **kw, seed=0, device="cuda",
                          hierarchy=HierarchyConfig(edge_aggregator=agg,
                                                    **dd))
        _hier_finite(f"(d) {agg}", h)
        books[agg] = h.extra["hierarchy"]["edge_ul_bits_total"]
    if not books["drop_stragglers:0.4"] < books["mean"]:
        raise AssertionError(f"[hierarchy] (d) edge uplink bits {books}")
    print(f"  (d) drop_stragglers:0.4 + device_dropout 0.25: finite; edge "
          f"uplink bits {books['drop_stragglers:0.4']} < the mean "
          f"aggregator's {books['mean']} ({card})", flush=True)

    # (e) the async engine, a row-local and a full-width plan
    from repro_torch.fl.hierarchy import fleet_plan
    from repro_torch.fl.simulator import default_model_init
    p0 = default_model_init(fed)(torch.Generator(device=fed.x.device))
    drop = dict(HIER_TWO, edge_aggregator="drop_stragglers:0.4")
    for label, cfg in (("row-local", HIER_TWO),
                       ("drop_stragglers:0.4, full width", drop)):
        hc = HierarchyConfig(**cfg)
        if fleet_plan(hc, m, p0, system).row_local != (label == "row-local"):
            raise AssertionError(f"[hierarchy] (e) {label}: row_local")
        before = dict(ops.LAUNCHES)
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = run_federated("ucfl_k4", fed, **kw, seed=0, device="cuda",
                              async_cfg=AsyncConfig(buffer_k=HIER_ASYNC_K),
                              hierarchy=hc)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        got = {k: (ops.LAUNCHES[k] - before[k]) // 2 for k in before}
        _hier_finite(f"(e) {label}", h)
        if len(h.extra["hierarchy"]["comm_bits"]) != rounds:
            raise AssertionError(f"[hierarchy] (e) {label}: edge books")
        _hier_launches(f"(e) {label}", got, {"qsgd_roundtrip": rounds})
        print(f"  (e) async K={HIER_ASYNC_K} two-level, {label}: "
              f"{walls[0] / rounds:.4f} then {walls[1] / rounds:.4f} "
              f"s/event; clock {h.time[-1]:.4f}; launches a run "
              f"{ {k: v for k, v in got.items() if v} } ({card})",
              flush=True)


# ---------------------------------------------------------------------------
# phase 12: federated LM training (launch/train.py), the scenarios

# (a) the CLI at the reference's deliverable-scale preset (lm-100m: the
# stablelm-3b family at 8 layers, d_model 512, d_ff 2,048, vocab 32,000)
TRAIN_A = ["--preset", "lm-100m", "--clients", "4", "--algorithm", "ucfl_k2",
           "--steps", "3", "--eval-every", "1", "--pool", "16", "--seq",
           "256", "--batch", "4", "--device", "cuda"]
TRAIN_A_RUNS = (
    ("host", ["--placement", "host"]),
    ("mesh", []),
    ("qsgd:8 tiered:4", ["--codec", "qsgd:8", "--link-profile", "tiered:4"]),
    ("topk:0.1", ["--codec", "topk:0.1"]),
    ("async K=2", ["--async", "--buffer-k", "2"]),
    ("cohort 2", ["--cohort", "2"]),
    ("devices 2", ["--devices-per-user", "2"]),
    ("crash + median", ["--faults", "crash:0.2", "--robust-agg", "median"]),
    # the MoE family at the same preset (olmoe-1b-7b cut as lm-100m cuts
    # it: 8 layers, d_model 512, 4 experts of 1,024, top 2)
    ("olmoe-1b-7b", ["--arch", "olmoe-1b-7b", "--placement", "host"]),
    # deepseek-v3-671b cut the same way (MLA at dk 24 / dv 16, one
    # dense-first layer, 4 experts of 1,024 top 2 plus a shared one; the
    # "pod" client axis: no momentum)
    ("deepseek-v3-671b", ["--arch", "deepseek-v3-671b", "--placement",
                          "host"]),
    # mamba2-780m cut the same way (8 SSD layers of d_model 512, 32 heads
    # of 16, d_state 16, chunk 32: eight chunks of the 256-token
    # sequences)
    ("mamba2-780m", ["--arch", "mamba2-780m", "--placement", "host"]),
)
# (b) stablelm-3b at its published widths (src/repro_torch/configs/
# stablelm_3b.py: d_model 2,560, 32 heads of 80, rotary on a quarter of
# each head, d_ff 6,912, vocab 50,304, untied, LayerNorm, bf16), random
# weights from a seed, depth cut to 2 (0.416 B params)
TRAIN_B = dict(arch="stablelm-3b", m=4, pool=8, seq=256, batch=2, rounds=3,
               seed=0, reduced={"n_layers": "32 -> 2"})
# (e) per-user serving of (b)'s trained population: a store of each codec,
# 8 requests over the 4 users, prompt 32, 16 greedy tokens, batches of 4
TRAIN_E = dict(codecs=("identity", "qsgd:4"), requests=8, max_batch=4,
               prompt=32, tokens=16, flushes=3, seed=0)
# (c) cuda against cpu: the same main at cpu-small
TRAIN_C = ["--preset", "cpu-small", "--placement", "host", "--clients", "4",
           "--steps", "2", "--eval-every", "1", "--pool", "8", "--seq", "32",
           "--batch", "2", "--algorithm", "ucfl_k2"]
TRAIN_C_RTOL = 1e-4


def _free_graphs() -> None:
    """Drop the captured supersteps (the engine keeps each
    configuration's CUDA graphs and their memory pools for its next call)
    and return the freed blocks: at LM widths a few configurations' pools
    fill the card."""
    import gc
    from repro_torch.fl import simulator
    simulator._SUPERSTEP_FNS.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _cli(argv) -> tuple:
    """``launch.train.main(argv)`` with its printout kept: (its return,
    -CE of the last eval, the printout, wall s)."""
    import io
    from repro_torch.launch import train as train_cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        loss = train_cli.main(argv)
    torch.cuda.synchronize()
    return loss, buf.getvalue(), time.perf_counter() - t0


def _rounds_of(text: str) -> list:
    """The (round, loss/mean, loss/worst, t_sys) lines of main's printout."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("round "):
            parts = ln.split()
            out.append((int(parts[1]), float(parts[2].split("=")[1]),
                        float(parts[3].split("=")[1]),
                        float(parts[4].split("=")[1])))
    return out


def train_agreement() -> None:
    """`launch.train.main` at cpu-small on the card and on the CPU: the
    data and the initial params are drawn on the host from the seed, so
    both start from the same bits; losses within rtol 1e-4, clock and
    downlink lines equal."""
    runs = {}
    for dev in ("cpu", "cuda"):
        runs[dev] = _cli(TRAIN_C + ["--device", dev])
    (la, ta, _), (lb, tb, _) = runs["cpu"], runs["cuda"]
    ra, rb = _rounds_of(ta), _rounds_of(tb)
    if len(ra) != 2 or [r[::3] for r in ra] != [r[::3] for r in rb]:
        raise AssertionError(f"train: rounds or clock differ: {ra} {rb}")
    down = [[ln for ln in t.splitlines() if ln.startswith("downlink")]
            for t in (ta, tb)]
    if down[0] != down[1]:
        raise AssertionError(f"train: downlink lines differ: {down}")
    err = abs(la - lb) / abs(la)
    if err > TRAIN_C_RTOL or any(abs(x[i] - y[i]) > 2e-4 for x, y in
                                 zip(ra, rb) for i in (1, 2)):
        raise AssertionError(f"train: losses differ cuda vs cpu: {la} vs "
                             f"{lb} ({ra} vs {rb})")
    print(f"  launch.train.main cpu-small ucfl_k2 m=4, 2 rounds: cuda agrees "
          f"with cpu (final CE {lb:.6f} vs {la:.6f}, rel {err:.1e}; clock "
          f"and downlink equal)", flush=True)


def train_cli_runs(card: str) -> None:
    """(a): `launch.train.main` at lm-100m through each flag family."""
    for label, extra in TRAIN_A_RUNS:
        _free_graphs()
        before = dict(ops.LAUNCHES)
        loss, text, wall = _cli(TRAIN_A + extra)
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before
                    if ops.LAUNCHES[k] != before[k]}
        rounds = _rounds_of(text)
        params = [ln for ln in text.splitlines()
                  if ln.startswith("params/model")]
        if not math.isfinite(loss) or len(rounds) != 3:
            raise AssertionError(f"[train] (a) {label}: loss {loss}, "
                                 f"rounds {rounds}")
        if launched.get("mixing_aggregate", 0) < 1:
            raise AssertionError(f"[train] (a) {label}: no mix launched "
                                 f"({launched})")
        if "qsgd" in label and launched.get("qsgd_roundtrip", 0) != 3:
            raise AssertionError(f"[train] (a) {label}: {launched}")
        print(f"  (a) {label:16s} final CE {loss:.4f}  per round "
              f"{[r[1] for r in rounds]}  {wall / 3:.3f} s/round incl. "
              f"setup  {params[0] if params else ''}  launches {launched}",
              flush=True)


def _lm_row(name, ms, plain_ms, b, by, err, extra=""):
    print(f"  (b) {name}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
          f"bound {b:.4f} ms ({by}){extra}  max|err| {err:.2e}", flush=True)


def train_kernels(gen, leaves, d_total: int) -> None:
    """Rows 1, 2 and 3–5 at (b)'s shapes against their plain versions,
    timed beside their byte bounds: the mix of the clients' bf16 leaves,
    G + Δ of a (m, D) f32 gradient matrix, one qsgd:8 crossing of it."""
    m = TRAIN_B["m"]
    w = rand_rows(gen, m, m)
    thetas = [t.reshape(m, -1) for t in leaves]
    got = ops.mixing_aggregate_leaves(w, thetas)
    err = max(check_close("mixing_aggregate [train]", y,
                          ref.mixing_aggregate_ref(w, t), TOL[t.dtype],
                          TOL[t.dtype]) for y, t in zip(got, thetas))
    del got
    nbytes = sum(2 * t.numel() * t.element_size() for t in thetas)
    b, by = bound_ms(nbytes + 4 * m * m, 2.0 * m * d_total * m,
                     BF16_FLOP_PER_S)
    lib = time_ms(lambda: [torch.matmul(w.to(t.dtype), t)
                           for t in thetas], 5)
    _lm_row(f"mixing_aggregate {len(thetas)} {str(thetas[0].dtype)[6:]} "
            f"leaves k=m={m} ΣD={d_total}", time_ms(
                lambda: ops.mixing_aggregate_leaves(w, thetas), 10),
            time_ms(lambda: [ref.mixing_aggregate_ref(w, t) for t in thetas],
                    5), b, by, err,
            f"  library (per-leaf matmul) {lib:.4f} ms")
    g = torch.randn((m, d_total), generator=gen, device="cuda")
    delta = ops.pairwise_sqdist(g)
    gram = ops.gram_matrix(g)
    same("pairwise_sqdist [train]", delta, ref.sqdist_from_gram(gram))
    # each f32 sum runs over 416 M terms in its own order, so the kernel
    # and the plain version are held against a float64 G: the kernel's
    # error at most twice the plain version's (or 1e-6 of max |G|)
    g64 = g.double()
    want = g64 @ g64.T
    del g64
    plain = ref.gram_ref(g)
    for label, got, pl in (("G", gram, plain),
                           ("Δ", delta, ref.sqdist_from_gram(plain))):
        w64 = want if label == "G" else ref.sqdist_from_gram(want)
        e_k = float((got.double() - w64).abs().max())
        e_p = float((pl.double() - w64).abs().max())
        if e_k > max(2 * e_p, 1e-6 * float(w64.abs().max())):
            raise AssertionError(f"gram_matrix [train] {label}: kernel "
                                 f"error {e_k:.3e} against float64, the "
                                 f"plain version's {e_p:.3e}")
        print(f"  (b) gram_matrix {label} against float64: kernel max|err| "
              f"{e_k:.3e}, plain {e_p:.3e} (max |{label}| "
              f"{float(w64.abs().max()):.3e})", flush=True)
        if label == "G":
            err = e_k
    del plain
    b, by = bound_ms(4.0 * (m * d_total + 2 * m * m),
                     m * (m + 1.0) * d_total)
    _lm_row(f"gram_matrix G + Δ m={m} D={d_total}",
            time_ms(lambda: ops.pairwise_sqdist(g), 10),
            time_ms(lambda: ref.sqdist_from_gram(ref.gram_ref(g)), 5), b,
            by, err, "  library (g gᵀ) "
            f"{time_ms(lambda: torch.matmul(g, g.T), 5):.4f} ms")
    u = torch.rand((m, d_total), generator=gen, device="cuda")
    rt = qsgd.qsgd_roundtrip_cuda(g, u, 8)
    torch.cuda.synchronize()
    if not torch.equal(rt, ref.qsgd_roundtrip_ref(g, u, 8)):
        raise AssertionError("qsgd_roundtrip [train]: kernel not bitwise "
                             "equal to its plain version")
    del rt
    b, by = bound_ms(3 * 4.0 * m * d_total, 0.0)
    _lm_row(f"qsgd_roundtrip (rows 3–5) ({m}, {d_total}) bits=8",
            time_ms(lambda: qsgd.qsgd_roundtrip_cuda(g, u, 8), 10),
            time_ms(lambda: ref.qsgd_roundtrip_ref(g, u, 8), 3), b, by, 0.0,
            "  (bitwise)")
    # (e)'s qsgd:4 store at these shapes: its build's encode (rows 3+4,
    # the row pass: x and the noise in, the levels and absmax out) and a
    # decode of its rows (row 5, the stream: levels and absmax in, f32
    # out), each bitwise its plain version
    lv, am = qsgd.qsgd_encode_cuda(g, u, 4)
    torch.cuda.synchronize()
    want_lv, want_am = ref.qsgd_quantize_ref(g, u, 4)
    if not (torch.equal(lv, want_lv) and torch.equal(am, want_am)):
        raise AssertionError("qsgd_quantize [train]: kernel not bitwise "
                             "equal to its plain version")
    del want_lv, want_am
    b, by = bound_ms(4.0 * m * (3 * d_total + 1), 0.0)
    _lm_row(f"qsgd_quantize (rows 3+4) ({m}, {d_total}) bits=4",
            time_ms(lambda: qsgd.qsgd_encode_cuda(g, u, 4), 10),
            time_ms(lambda: ref.qsgd_quantize_ref(g, u, 4), 3), b, by, 0.0,
            "  (bitwise)")
    del g, u
    dq = qsgd.qsgd_dequantize_cuda(lv, am, 4)
    torch.cuda.synchronize()
    if not torch.equal(dq, ref.qsgd_dequantize_ref(lv, am, 4)):
        raise AssertionError("qsgd_dequantize [train]: kernel not bitwise "
                             "equal to its plain version")
    del dq
    b, by = bound_ms(4.0 * m * (2 * d_total + 1), 0.0)
    scale = am * ref.qsgd_levels(4)[1].to(am.device)
    _lm_row(f"qsgd_dequantize (row 5) ({m}, {d_total}) bits=4",
            time_ms(lambda: qsgd.qsgd_dequantize_cuda(lv, am, 4), 10),
            time_ms(lambda: ref.qsgd_dequantize_ref(lv, am, 4), 3), b, by,
            0.0, "  (bitwise)  library (torch.mul(levels, scale)) "
            f"{time_ms(lambda: torch.mul(lv, scale), 5):.4f} ms")


def train_published(card: str) -> dict:
    """(b): stablelm-3b at its published widths, depth 2, through
    `run_federated` on LM clients: ucfl_k2 fused and eventful (bitwise
    equal), (e) its trained population served per user (`train_serve`),
    then qsgd:8 fused; setup s, s/round, peak MiB, launches, a traced
    5-round chunk's busy share.  Returns the launches of the runs and of
    (e)."""
    from repro_torch.launch.steps import init_model_params
    from repro_torch.launch.train import lm_federated_data, lm_fns
    from repro_torch.models.scan import flat_params
    tb = TRAIN_B
    cfg = dataclasses.replace(get_config(tb["arch"]), n_layers=2)
    m, rounds = tb["m"], tb["rounds"]
    fed = lm_federated_data(tb["seed"], m, pool=tb["pool"], n_val=4,
                            seq=tb["seq"], vocab=cfg.vocab_size,
                            device="cuda")
    loss_fn, acc_fn = lm_fns(cfg)

    def init(gen):
        return flat_params(init_model_params(
            torch.Generator(device="cuda").manual_seed(tb["seed"]), cfg))

    p0 = init(None)
    n_params, n_leaves = sum(v.numel() for v in p0.values()), len(p0)
    del p0
    print(f"  (b) {cfg.name} published widths (d_model {cfg.d_model}, "
          f"{cfg.attn.n_heads} heads of {cfg.attn.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {str(cfg.pdtype)[6:]}), "
          f"depth {cfg.n_layers}: {n_params / 1e9:.3f} B params, "
          f"{n_leaves} leaves; m={m} pool {tb['pool']} x {tb['seq']} "
          f"tokens, batch {tb['batch']}", flush=True)
    fl = FLConfig(rounds=rounds, local_steps=1, batch_size=tb["batch"],
                  eval_every=1, momentum=0.9, opt_state_dtype="param")
    kw = dict(model_init=init, loss_fn=loss_fn, acc_fn=acc_fn,
              system=SYSTEMS["wireless_slow"])
    mib = 2 ** 20
    setup_only = dataclasses.replace(fl, rounds=0)
    # the first run pays the context's and cuBLAS's start; the second is
    # timed
    run_federated("ucfl_k2", fed, fl=setup_only, device="cuda", **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_federated("ucfl_k2", fed, fl=setup_only, device="cuda", **kw)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    print(f"  (b) setup-only run (UCFL's gradients, Δ, W, streams): "
          f"{setup:.3f} s, peak {torch.cuda.max_memory_allocated() / mib:.0f}"
          f" MiB", flush=True)
    def between(h):
        # the eventful run's setup beside the fused run's graphs and
        # optimizer state does not fit: only the params are compared
        h.final_opt_state = None
        _free_graphs()

    before = dict(ops.LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    runs = run_both("ucfl_k2", fed, fl, between=between, **kw)
    peak = torch.cuda.max_memory_allocated() / mib
    for engine, h, launched, wall in runs:
        if launched["mixing_aggregate"] != rounds or \
                launched["gram_matrix"] != 1:
            raise AssertionError(f"[train] (b) {engine}: {launched}")
        if not all(math.isfinite(a) for a in h.mean_acc):
            raise AssertionError(f"[train] (b) {engine}: {h.mean_acc}")
        print(f"  (b) ucfl_k2 {engine:8s} CE {[-a for a in h.mean_acc]}  "
              f"{wall:.3f} s ({(wall - setup) / rounds:.4f} s/round less "
              f"setup)  launches { {k: v for k, v in launched.items() if v} }",
              flush=True)
    print(f"  (b) peak device memory of the two runs {peak:.0f} MiB",
          flush=True)
    # (e): the trained population (the eventful run's; its params are the
    # fused run's bitwise) served per user, its optimizer state dropped
    keep = runs[-1][1]
    keep.final_opt_state = None
    del runs, h
    _free_graphs()
    t0 = time.perf_counter()
    train_serve(keep, cfg)
    print(f"  (e) {time.perf_counter() - t0:.1f} s", flush=True)
    del keep
    _free_graphs()
    torch.cuda.reset_peak_memory_stats()
    (engine, h, launched, wall), = run_both(
        "ucfl_k2", fed, fl, engines=("fused",),
        channel=Channel(codec="qsgd:8"), **kw)
    if launched["qsgd_roundtrip"] != rounds:
        raise AssertionError(f"[train] (b) qsgd:8: {launched}")
    print(f"  (b) ucfl_k2 + qsgd:8 fused CE {[-a for a in h.mean_acc]}  "
          f"{wall:.3f} s ({(wall - setup) / rounds:.4f} s/round less setup)"
          f"  peak {torch.cuda.max_memory_allocated() / mib:.0f} MiB  "
          f"launches { {k: v for k, v in launched.items() if v} }",
          flush=True)
    del h
    _free_graphs()
    launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
    # the graphs are captured inside the window (a warm second run's
    # setup does not fit beside two LM rounds' graph pools): it holds the
    # capture's warm-up round and eval beside the 5 replayed rounds
    tr = chunk_trace("ucfl_k2", fed, dataclasses.replace(fl, eval_every=5),
                     SYSTEMS["wireless_slow"], None, model_init=init,
                     loss_fn=loss_fn, acc_fn=acc_fn)
    if tr is None:
        print("  (b) traced chunk: the trace holds no device events",
              flush=True)
    else:
        wall_ms, busy_ms, parts, n_k, _ = tr
        print(f"  (b) traced 5-round fused chunk, its capture included: "
              f"wall {wall_ms:.1f} ms, "
              f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f} "
              f"%), {n_k} kernels; local update {parts['local update']:.1f}"
              f" ms, mix {parts['mix']:.2f} ms, eval {parts['eval']:.1f} ms",
              flush=True)
    _free_graphs()
    # the rows at these shapes: the clients' stacked bf16 leaves (the
    # initial params, m copies), a (m, ΣD) f32 matrix
    p0 = init(None)
    leaves = [p0[k][None].expand((m,) + tuple(p0[k].shape)).contiguous()
              for k in sorted(p0)]
    del p0
    train_kernels(torch.Generator(device="cuda").manual_seed(28), leaves,
                  n_params)
    return launches


def train_serve(h, cfg) -> None:
    """(e): (b)'s trained population served per user
    (`launch.serve.build_decode_one` under the `ServeEngine`'s vmap): an
    identity and a qsgd:4 `DeltaStore` of its final params, each built
    (timed, its peak), then TRAIN_E's flushes (the first warms up):
    req/s and batch p50/max over the later ones, `check_parity` after
    every flush, a user's requests served the same tokens, and the
    phase's launches (row 5 a served qsgd batch and a full decode, rows
    3+4 a qsgd build, the flash op one a layer a step for each batch);
    then a batch's stages timed apart (the gather and decode of its rows,
    the prefill, the decode steps: prefill ms, tok/s) and a batch under
    the profiler (device busy against its wall)."""
    te = TRAIN_E
    m = next(iter(h.final_params.values())).shape[0]
    users = [i % m for i in range(te["requests"])]
    prompts = user_prompts(te["seed"], users, te["prompt"], cfg.vocab_size)
    probe = sorted(set(users))[:te["max_batch"]]
    decode = build_decode_one(cfg, te["prompt"], te["tokens"],
                              te["prompt"] + te["tokens"])
    mib = 2 ** 20
    for codec in te["codecs"]:
        before = dict(ops.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        store = DeltaStore.from_history(h, codec=codec, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_peak = torch.cuda.max_memory_allocated() / mib
        engine = ServeEngine(store, decode, max_batch=te["max_batch"])
        torch.cuda.reset_peak_memory_stats()
        walls, lat = [], []
        for f in range(te["flushes"]):
            for u in users:
                engine.submit(u, prompts[u])
            t0 = time.perf_counter()
            outs = engine.flush()
            wall = time.perf_counter() - t0
            check_parity(engine, probe,
                         torch.stack([prompts[u] for u in probe]))
            if f:
                walls.append(wall)
                lat += engine.last_stats["latency_s"]
            for i, u in enumerate(users):
                o = outs[i]
                if o.shape != (te["tokens"],) or not (
                        (o >= 0) & (o < cfg.vocab_size)).all() or \
                        not np.array_equal(o, outs[users.index(u)]):
                    raise AssertionError(f"[train] (e) {codec}: user {u} "
                                         f"served {o}")
        serve_peak = torch.cuda.max_memory_allocated() / mib
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before
                    if ops.LAUNCHES[k] != before[k]}
        flash = sum(launched.get(c, 0) for c in ops.FLASH_COUNTERS.values())
        # a batch's prefill and its tokens-1 decode steps, one launch a
        # layer each; check_parity serves the probe twice a flush
        batches = te["flushes"] * (-(-len(users) // te["max_batch"]) + 2)
        if flash != batches * te["tokens"] * cfg.n_layers or (
                codec != "identity" and (launched.get("qsgd_quantize") != 1
                                         or not launched.get(
                                             "qsgd_dequantize"))):
            raise AssertionError(f"[train] (e) {codec}: launches {launched}")
        n_req = len(users) * len(walls)
        print(f"  (e) {codec} store of (b)'s {m} users: {store.summary()}; "
              f"build {build_s:.3f} s (peak {build_peak:.0f} MiB); "
              f"{n_req} requests in {len(walls)} timed flushes: "
              f"{n_req / sum(walls):.2f} req/s, batch p50 "
              f"{statistics.median(lat) * 1e3:.1f} ms, max "
              f"{max(lat) * 1e3:.1f} ms; serving peak {serve_peak:.0f} MiB;"
              f" check_parity after every flush; launches {launched}; "
              f"user 0: {outs[0][:8].tolist()}", flush=True)
        # a batch's stages timed apart (their launches not counted): the
        # gather and decode of its rows, the vmapped prefill alone (the
        # decode with 1 token), the whole decode; the steps are the rest
        xs = torch.stack([prompts[u] for u in probe])
        prefill = torch.func.vmap(build_decode_one(
            cfg, te["prompt"], 1, te["prompt"] + te["tokens"]))
        with ops.launches_set_aside(), torch.no_grad():
            stage = {"gather": [], "prefill": [], "whole": []}
            for _ in range(3):
                t0 = time.perf_counter()
                params = engine.params_for(probe)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                prefill(params, xs.cuda())
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                engine.forward(params, xs.cuda())
                torch.cuda.synchronize()
                t3 = time.perf_counter()
                stage["gather"].append(t1 - t0)
                stage["prefill"].append(t2 - t1)
                stage["whole"].append(t3 - t2)
                del params
        med = {k: statistics.median(v) for k, v in stage.items()}
        steps = te["tokens"] - 1
        step_s = (med["whole"] - med["prefill"]) / steps
        print(f"  (e) {codec} a batch of {len(probe)} apart (median of 3): "
              f"gather + decode of its rows {med['gather'] * 1e3:.1f} ms, "
              f"prefill ({te['prompt']} tokens a user) "
              f"{med['prefill'] * 1e3:.1f} ms, decode "
              f"{step_s * 1e3:.2f} ms a step, "
              f"{len(probe) / step_s:.1f} tok/s", flush=True)
        # one batch under the profiler (its launches not counted): the
        # device's busy share of a served batch's wall
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with ops.launches_set_aside(), \
                torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            engine.serve(probe, xs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        split = device_split(prof)
        if split is None:
            print(f"  (e) {codec} profiler: no device events; busy share "
                  "not measured", flush=True)
        else:
            busy, split, by_name, n_kernels = split
            print(f"  (e) {codec} profiler, one batch of {len(probe)}: wall "
                  f"{wall * 1e3:.1f} ms (untraced p50 "
                  f"{statistics.median(lat) * 1e3:.1f}), device busy "
                  f"{busy / 1e3:.1f} ms: flash {split['flash'] / 1e3:.2f}, "
                  f"GEMM {split['GEMM'] / 1e3:.1f}, other "
                  f"{split['other'] / 1e3:.1f} ms; {n_kernels} kernels",
                  flush=True)
            for name, us in sorted(by_name.items(), key=lambda x: -x[1])[:5]:
                print(f"      {us / 1e3:8.3f} ms  {name[:110]}", flush=True)
        del store, engine
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: [steps] the mesh case builders (launch/steps.py) on the scanned
# serving path, remat, and the planner (launch/dryrun.py)
#
# (a) gemma2-27b at its published widths (src/repro_torch/configs/
# gemma2_27b.py: d_model 4,608, 32 / 16 heads of 128, window 4,096,
# softcaps 50 / 30, bf16), random weights from a seed, depth 46 -> 4 (two
# groups of the (local, global) pattern): prefill_32k cut to B 2, then
# decode_32k's step on its caches; long_500k (B 1, a 32,768-token prompt
# into rings of long_context_window), then its steps.  (b) stablelm-3b at
# its published widths, train_4k cut to a global batch of 2 x 4,096 on
# make_host_mesh() (m = 1 client): (depth, remat, microbatch) below.  At
# depth 4 the run with remat off at microbatch 1 is not run: the planner
# puts it at 83,164 MiB, past the card, so remat on and off meet at
# microbatch 2 (48,478 MiB planned) and the planner's verdict stands for
# the other.
STEPS_GEMMA_LAYERS = 4
STEPS_PROMPT = 32768
STEPS_DECODE = 16
STEPS_TRAIN = ((4, True, 1), (4, True, 2), (4, False, 2), (32, True, 1))
# (a)'s scan layouts on the card against the CPU: period 1 SSM caches, a
# shared attention slot, dense prefix layers, an image prefix
STEPS_LAYOUTS = ("mamba2-780m", "zamba2-2.7b", "deepseek-v3-671b",
                 "paligemma-3b")
STEPS_MARK = "[steps] launches: "
# (c): `dryrun --all` split over this many processes (`--shard`)
STEPS_PLAN_PROCS = 4


def _flash_now() -> dict:
    return {c: ops.LAUNCHES[c] for c in ops.FLASH_COUNTERS.values()}


def _flash_since(before: dict) -> dict:
    return {c: ops.LAUNCHES[c] - n for c, n in before.items()}


def _agree(label: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want|, held to [agree]'s 1e-4 + 1e-4·|want|."""
    d = (got.float().cpu() - want.float().cpu()).abs()
    if not bool(torch.all(d <= 1e-4 + 1e-4 * want.float().cpu().abs())):
        raise AssertionError(f"{label}: logits differ by {float(d.max()):.3e}")
    return float(d.max())


def steps_serve(card: str) -> dict:
    """(a): gemma2-27b's scanned prefill and decode steps through
    `build_prefill_case` / `build_decode_case`'s functions, each held
    against the unrolled `transformer.prefill` / `decode_step` on the same
    params (the stack's views): tokens equal, logits bitwise or within
    [agree]'s tolerance.  Returns each shape's measurements."""
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import scan as scan_mod
    cfg = dataclasses.replace(get_config("gemma2-27b"),
                              n_layers=STEPS_GEMMA_LAYERS)
    mesh = make_host_mesh()
    params = S.init_model_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    loop = scan_mod.unstack_layer_params(params, cfg)
    n_params = sum(t.numel() for t in scan_mod.flat_params(params).values())
    n_attn = n_attn_layers(cfg)
    out = {}
    shapes = (
        ("prefill_32k", dataclasses.replace(S.INPUT_SHAPES["prefill_32k"],
                                            global_batch=2),
         dataclasses.replace(S.INPUT_SHAPES["decode_32k"], global_batch=2)),
        ("long_500k", S.INPUT_SHAPES["long_500k"],
         S.INPUT_SHAPES["long_500k"]))
    for label, pshape, dshape in shapes:
        lc = pshape.long_context
        pre = S.build_prefill_case(cfg, mesh, pshape).fn
        dec = S.build_decode_case(cfg, mesh, dshape).fn
        b = pshape.global_batch
        tokens = torch.randint(0, cfg.vocab_size, (b, STEPS_PROMPT),
                               dtype=torch.int32, device="cuda",
                               generator=torch.Generator(device="cuda")
                               .manual_seed(1))
        # warm: a short prompt and one step (kernel loads, cuBLAS handles)
        _, wc = pre(params, {"tokens": tokens[:, :1024]})
        dec(params, wc, tokens[:, :1], 1024)
        del wc
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        f0 = _flash_now()
        t0 = time.perf_counter()
        logits, caches = pre(params, {"tokens": tokens})
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        f_pre = _flash_since(f0)
        scanned = [logits]
        tok = logits.argmax(-1).to(torch.int32)
        step_ms = []
        f1 = _flash_now()
        for i in range(STEPS_DECODE):
            t0 = time.perf_counter()
            logits, caches = dec(params, caches, tok, STEPS_PROMPT + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            scanned.append(logits)
            tok = logits.argmax(-1).to(torch.int32)
        f_dec = _flash_since(f1)
        peak = torch.cuda.max_memory_allocated() / 2**20
        rings = sorted({c.k.shape[2] for c in caches["scan"]})
        del caches
        want_pre = {"flash_attention_tc": n_attn, "flash_attention": 0,
                    "flash_attention_decode": 0}
        want_dec = {"flash_attention_tc": 0, "flash_attention": 0,
                    "flash_attention_decode": n_attn * STEPS_DECODE}
        if f_pre != want_pre or f_dec != want_dec:
            raise AssertionError(f"[steps] (a) {label}: flash launches "
                                 f"{f_pre}, {f_dec}; want {want_pre}, "
                                 f"{want_dec}")
        # the unrolled path on the same params
        uc = T.make_caches(cfg, b, S._cache_len(cfg, pshape), cfg.cdtype,
                           long_context=lc, device="cuda")
        lu, uc = T.prefill(loop, cfg, {"tokens": tokens}, uc,
                           long_context=lc)
        errs = [_agree(f"[steps] (a) {label} prefill", scanned[0], lu)]
        for i in range(STEPS_DECODE):
            tu = lu.argmax(-1)
            if not torch.equal(tu, scanned[i].argmax(-1)):
                raise AssertionError(f"[steps] (a) {label}: step {i} "
                                     "tokens differ, scanned vs unrolled")
            lu, uc = T.decode_step(loop, cfg, tu, uc, STEPS_PROMPT + i,
                                   long_context=lc)
            errs.append(_agree(f"[steps] (a) {label} step {i}",
                               scanned[i + 1], lu))
        if not torch.equal(lu.argmax(-1), scanned[-1].argmax(-1)):
            raise AssertionError(f"[steps] (a) {label}: last tokens differ")
        del uc, lu
        held = "bitwise" if max(errs) == 0.0 else \
            f"max |dlogit| {max(errs):.3e} (within [agree]'s 1e-4)"
        step = statistics.median(step_ms)
        print(f"  (a) {label}: gemma2-27b depth {STEPS_GEMMA_LAYERS} "
              f"({n_params / 1e9:.3f} B bf16), B {b}, prompt "
              f"{STEPS_PROMPT}, rings {rings}: prefill {pre_ms:.2f} ms "
              f"({b * STEPS_PROMPT / pre_ms * 1e3:.0f} tok/s), decode "
              f"{step:.3f} ms a step (median of {STEPS_DECODE}; "
              f"{b / step * 1e3:.1f} tok/s), peak {peak:.0f} MiB; flash "
              f"{f_pre['flash_attention_tc']} tensor-core a prefill, "
              f"{f_dec['flash_attention_decode'] // STEPS_DECODE} decode "
              f"calls a step (2 launches each); scanned = unrolled: "
              f"tokens equal, logits {held} ({card})", flush=True)
        out[label] = {"prefill_ms": pre_ms, "step_ms": step,
                      "peak_mib": peak, "pshape": pshape, "dshape": dshape}
    del params, loop
    torch.cuda.empty_cache()
    return out


def steps_layouts() -> None:
    """(a): the scan layouts of four smoke stacks (4 layers) through the
    scanned prefill and 8 decode steps on the card against the CPU (one
    intra-op thread): [agree]'s tolerance, tokens equal."""
    from repro_torch.launch import steps as S
    from repro_torch.models import scan as scan_mod
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for arch in STEPS_LAYOUTS:
            cfg = dataclasses.replace(get_smoke_config(arch), n_layers=4)
            params = tree_to_numpy(S.init_model_params(
                torch.Generator().manual_seed(3), cfg))
            prompt = torch.randint(0, cfg.vocab_size, (2, 24),
                                   generator=torch.Generator().manual_seed(4))
            extra = smoke_embeds(cfg, 2, 5, "cpu")
            pos = 24 + (cfg.vision.n_tokens if cfg.family == "vlm" else 0)
            runs = {}
            for dev in ("cpu", "cuda"):
                p = tree_from_numpy(params, dev)
                batch = {"tokens": prompt.to(dev),
                         **{k: v.to(dev) for k, v in extra.items()}}
                caches = scan_mod.stack_caches(T.make_caches(
                    cfg, 2, 64, torch.float32, device=dev), cfg)
                logits, caches = scan_mod.prefill(p, cfg, batch, caches)
                outs = [logits]
                for i in range(8):
                    logits, caches = scan_mod.decode_step(
                        p, cfg, logits.argmax(-1), caches, pos + i)
                    outs.append(logits)
                runs[dev] = outs
            err = max(_agree(f"[steps] (a) {arch} call {i}", g, w)
                      for i, (g, w) in enumerate(zip(runs["cuda"],
                                                     runs["cpu"])))
            for g, w in zip(runs["cuda"], runs["cpu"]):
                if not torch.equal(g.argmax(-1).cpu(), w.argmax(-1)):
                    raise AssertionError(f"[steps] (a) {arch}: tokens "
                                         "differ cuda vs cpu")
            print(f"  (a) scanned {cfg.name} at 4 layers "
                  f"{scan_mod.layer_grouping(cfg)} (prefix, period, "
                  f"groups): cuda agrees with cpu over a prefill and 8 "
                  f"steps (max |dlogit| {err:.2e}, tokens equal)",
                  flush=True)
    finally:
        torch.set_num_threads(threads)


def _flat_f32(tree) -> torch.Tensor:
    from repro_torch.models import scan as scan_mod
    return torch.cat([t.float().reshape(-1) for _, t in
                      sorted(scan_mod.flat_params(tree).items())])


def steps_train(card: str) -> dict:
    """(b): `build_train_case`'s step at stablelm-3b's published widths:
    step s of a second step, the first step's peak MiB and its row-1
    launches (one mix a step).  At depth 4 the loss with remat on is
    bitwise the loss with it off (microbatch 2) and the updated params
    agree within 1e-5 relative (in norm over the tree); microbatch 2
    agrees with microbatch 1 (remat on) at the reference's test_scan.py
    tolerance (the loss at rtol 2e-4, the updated bf16 params at 2e-4
    relative in norm).  Returns each run's measurements."""
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    base = get_config("stablelm-3b")
    mesh = make_host_mesh()
    shape = dataclasses.replace(S.INPUT_SHAPES["train_4k"], global_batch=2)
    out, first = {}, {}
    for depth, remat, mb in STEPS_TRAIN:
        cfg = dataclasses.replace(base, n_layers=depth)
        case = S.build_train_case(cfg, mesh, shape, remat=remat,
                                  microbatch=mb)
        params = S.init_stacked_params(
            torch.Generator(device="cuda").manual_seed(0), cfg, 1)
        opt_state = S.init_opt_state(S.make_optimizer(cfg), params)
        batch = S.sample_batch(torch.Generator(device="cuda").manual_seed(1),
                               case.args[2], cfg.vocab_size)
        w = torch.ones((1, 1), device="cuda")
        assign = torch.zeros((1,), dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mixes = ops.LAUNCHES["mixing_aggregate"]
        t0 = time.perf_counter()
        p1, o1, m1 = case.fn(params, opt_state, batch, w, assign)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        loss = float(m1["loss"])
        if not math.isfinite(loss):
            raise AssertionError(f"[steps] (b) depth {depth}: loss {loss}")
        if depth == 4:
            first[(remat, mb)] = (m1["loss"].clone(), _flat_f32(p1))
        del params, opt_state
        t0 = time.perf_counter()
        p2, o2, m2 = case.fn(p1, o1, batch, w, assign)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        mixes = ops.LAUNCHES["mixing_aggregate"] - mixes
        if mixes != 2:
            raise AssertionError(f"[steps] (b): {mixes} mixes in 2 steps")
        n = sum(t.numel() for t in _leaves(p2))
        print(f"  (b) stablelm-3b depth {depth} ({n / 1e9:.3f} B bf16), "
              f"remat {remat}, microbatch {mb}: loss {loss:.6f} then "
              f"{float(m2['loss']):.6f}; step {step_s:.3f} s (first "
              f"{first_s:.3f} s), peak {peak:.0f} MiB (the first step), "
              f"{mixes} row-1 launches ({card})", flush=True)
        out[(depth, remat, mb)] = {"step_s": step_s, "peak_mib": peak,
                                   "cfg": cfg, "shape": shape}
        del p1, o1, p2, o2, m1, m2, batch
        torch.cuda.empty_cache()
    (l_on, p_on), (l_off, p_off) = first[(True, 2)], first[(False, 2)]
    rel = float((p_on - p_off).norm() / p_off.norm())
    if not torch.equal(l_on, l_off) or rel > 1e-5:
        raise AssertionError(f"[steps] (b): remat on against off: loss "
                             f"{float(l_on)} vs {float(l_off)}, params "
                             f"{rel:.3e} relative")
    (l_1, p_1) = first[(True, 1)]
    rel_mb = float((p_on - p_1).norm() / p_1.norm())
    if abs(float(l_on) - float(l_1)) > 2e-5 + 2e-4 * abs(float(l_1)) or \
            rel_mb > 2e-4:
        raise AssertionError(f"[steps] (b): microbatch 2 against 1: loss "
                             f"{float(l_on)} vs {float(l_1)}, params "
                             f"{rel_mb:.3e} relative")
    print(f"  (b) depth 4: remat on = off (microbatch 2): loss bitwise, "
          f"params {rel:.3e} relative (max |d| "
          f"{float((p_on - p_off).abs().max()):.3e}); microbatch 2 against 1 "
          f"(remat on): loss {float(l_on):.6f} vs {float(l_1):.6f}, params "
          f"{rel_mb:.3e} relative", flush=True)
    return out


def _plan_line(r: dict) -> str:
    return (f"compute {r['t_compute'] * 1e3:.3f} ms, memory "
            f"{r['t_memory'] * 1e3:.3f} ms, collective "
            f"{r['t_collective'] * 1e3:.3f} ms -> {r['bottleneck']}; "
            f"{r['flops_per_device']:.4g} FLOP, peak "
            f"{r['peak_memory_per_device'] / 2**30:.2f} GiB, fits "
            f"{r['fits']}")


def steps_planner(card: str, procs: list, out_dir: str, serve: dict,
                  train: dict) -> None:
    """(c): the planner beside (a)'s and (b)'s measurements, its verdict
    on the runs that were not made, then its line for every case of
    ``--all`` (its processes, started with the phase)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_card_mesh
    mesh = make_card_mesh()
    print(f"  (c) the planner on make_card_mesh() {mesh.shape}: counted on "
          f"meta tensors, no device run; against measurement ({card}):",
          flush=True)
    cfg_a = dataclasses.replace(get_config("gemma2-27b"),
                                n_layers=STEPS_GEMMA_LAYERS)
    for label in ("prefill_32k",):
        m = serve[label]
        for kind, shape, ms in (("prefill", m["pshape"], m["prefill_ms"]),
                                ("decode step", m["dshape"], m["step_ms"])):
            r = dryrun.run_case("gemma2-27b", shape, mesh=mesh, cfg=cfg_a,
                                out_dir=None, verbose=False)
            print(f"    (a) {kind} B {shape.global_batch}: planned "
                  f"{r['flops_per_device']:.4g} FLOP, compute bound "
                  f"{r['t_compute'] * 1e3:.3f} ms, peak "
                  f"{r['peak_memory_per_device'] / 2**20:.0f} MiB; "
                  f"measured {ms:.3f} ms ("
                  f"{r['flops_per_device'] / ms / 1e9:.1f} TFLOP/s)"
                  + (f", peak {m['peak_mib']:.0f} MiB (prefill and steps)"
                     if kind == "prefill" else ""), flush=True)
    runs = dict(train)
    runs[(4, False, 1)] = None
    runs[(32, False, 1)] = None
    for (depth, remat, mb), meas in runs.items():
        cfg = dataclasses.replace(get_config("stablelm-3b"), n_layers=depth)
        shape = (meas or next(iter(train.values())))["shape"]
        r = dryrun.run_case("stablelm-3b", shape, mesh=mesh, cfg=cfg,
                            remat=remat, microbatch=mb, out_dir=None,
                            verbose=False)
        what = (f"measured step {meas['step_s']:.3f} s "
                f"({r['flops_per_device'] / meas['step_s'] / 1e12:.1f} "
                f"TFLOP/s), peak {meas['peak_mib']:.0f} MiB") \
            if meas else "not run (the planner's verdict)"
        print(f"    (b) depth {depth}, remat {remat}, microbatch {mb}: "
              f"planned {r['flops_per_device']:.4g} FLOP, peak "
              f"{r['peak_memory_per_device'] / 2**20:.0f} MiB, fits "
              f"{r['fits']}; {what}", flush=True)
    for proc in procs:
        text, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            print(text)
            raise AssertionError(f"[steps] (c): dryrun --all exit "
                                 f"{proc.returncode}")
    arts = sorted(Path(out_dir).glob("*/*.json"))
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.steps import INPUT_SHAPES
    if len(arts) != len(ARCH_IDS) * len(INPUT_SHAPES):
        raise AssertionError(f"[steps] (c): {len(arts)} artifacts")
    secs = 0.0
    for a in arts:
        r = json.loads(a.read_text())
        secs += r["plan_seconds"]
        print(f"    {r['arch']} x {r['shape']}: {_plan_line(r)}",
              flush=True)
    print(f"  (c) dryrun --all: {len(arts)} cases planned in {secs:.1f} s "
          f"(summed over its {len(procs)} processes, beside (a) and (b))",
          flush=True)


def steps_path(card: str) -> dict:
    """Phase 13; returns its launches (rows 1, 7a and 7c)."""
    import tempfile
    ops.reset_launches()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parent / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--shard", f"{i}/{STEPS_PLAN_PROCS}", "--out", tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for i in range(STEPS_PLAN_PROCS)]
    try:
        t0 = time.perf_counter()
        serve = steps_serve(card)
        steps_layouts()
        print(f"  (a) {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        train = steps_train(card)
        print(f"  (b) {time.perf_counter() - t0:.1f} s", flush=True)
        launches = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        steps_planner(card, procs, tmp, serve, train)
        print(f"  (c) {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  [steps] phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def steps_isolated() -> dict:
    """[steps] in a process of its own (this script with ``--steps``), its
    lines passed through, started before this process holds a CUDA
    context: (b)'s uncut step takes ~40 GB.  Returns its launches."""
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--steps"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    launches = None
    for line in proc.stdout:
        if line.startswith(STEPS_MARK):
            launches = json.loads(line[len(STEPS_MARK):])
        else:
            print(line, end="", flush=True)
    if proc.wait() != 0 or launches is None:
        raise AssertionError(f"[steps] failed (exit {proc.returncode})")
    return launches


def _steps_child() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = steps_path(card_line())
    print(STEPS_MARK + json.dumps(launches), flush=True)
    return 0


TRAIN_B_MARK = "[train] (b) launches: "


def train_published_isolated() -> dict:
    """(b) in a process of its own (this script with
    ``--train-published``), its lines passed through, started before this
    process holds a CUDA context: its runs take ~50 GB of the card, and a
    second context with the earlier phases' leftovers beside them leaves
    too little (measured: out of memory by ~2 GB).  Returns the child's
    launch counts."""
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--train-published"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    launches = None
    for line in proc.stdout:
        if line.startswith(TRAIN_B_MARK):
            launches = json.loads(line[len(TRAIN_B_MARK):])
        else:
            print(line, end="", flush=True)
    if proc.wait() != 0 or launches is None:
        raise AssertionError(f"[train] (b) failed (exit {proc.returncode})")
    return launches


def _train_published_child() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = train_published(card_line())
    print(TRAIN_B_MARK + json.dumps(launches), flush=True)
    return 0


def scenarios_path(card: str) -> None:
    """(d): the three scenarios drawn on the card at their default sizes
    (shapes, groups, the padding rule, the rotations, one permutation a
    group), then ucfl_k4 for 5 fused rounds on cifar_concept_shift with
    LeNet-5 at 32x32x3."""
    from repro_torch.data import SCENARIOS, rotate_images
    feds = {}
    for name, fn in SCENARIOS.items():
        t0 = time.perf_counter()
        fed = fn(0, device="cuda")
        torch.cuda.synchronize()
        m, n_max = fed.y.shape
        hw = (32, 32, 3) if name.startswith("cifar") else (28, 28, 1)
        if tuple(fed.x.shape) != (m, n_max) + hw or \
                fed.x_val.shape[:2] != fed.y_val.shape:
            raise AssertionError(f"{name}: shapes {tuple(fed.x.shape)}")
        for i in range(m):          # padded slots repeat the valid samples
            ni = int(fed.n[i])
            reps = -(-n_max // ni)
            if not torch.equal(fed.y[i], fed.y[i, :ni].repeat(reps)[:n_max]):
                raise AssertionError(f"{name}: client {i} padding")
        groups = sorted(set(fed.group.tolist()))
        feds[name] = fed
        print(f"  (d) {name}: x {tuple(fed.x.shape)}, x_val "
              f"{tuple(fed.x_val.shape)}, groups {groups}, n "
              f"{int(fed.n.min())}..{int(fed.n.max())}, "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    cov, base = feds["emnist_covariate_shift"], SCENARIOS[
        "emnist_label_shift"](0, n=20000, m=40, seed=1, device="cuda")
    for i in range(cov.m):
        if not torch.equal(cov.x[i], rotate_images(base.x[i], i % 4)):
            raise AssertionError(f"covariate shift: client {i} not its "
                                 "label-shift images turned")
    # images that name their own index: one label permutation a group
    n = 10000
    idx = torch.arange(n, dtype=torch.float32, device="cuda")
    y = torch.randint(0, 10, (n,), device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(1))
    con = SCENARIOS["cifar_concept_shift"](data={
        "x": idx[:, None, None, None].expand(n, 2, 2, 3), "y": y},
        device="cuda")
    perms = {}
    for i in range(con.m):
        src = y[con.x[i, :, 0, 0, 0].long()].tolist()
        g = int(con.group[i])
        for a, b in zip(src, con.y[i].tolist()):
            if perms.setdefault((g, a), b) != b:
                raise AssertionError("concept shift: a label maps two ways "
                                     "within a group")
    maps = {g: tuple(perms.get((g, c)) for c in range(10)) for g in range(4)}
    if len(set(maps.values())) != 4 or any(
            sorted(p) != list(range(10)) for p in maps.values()):
        raise AssertionError(f"concept shift permutations {maps}")
    print("  (d) covariate shift: every client its label-shift images "
          "turned by group; concept shift: one permutation a group, four "
          "distinct", flush=True)
    fed = feds["cifar_concept_shift"]
    fl = FLConfig(rounds=5, local_steps=MAIN["local_steps"],
                  batch_size=MAIN["batch_size"], eval_every=5)
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    h = run_federated("ucfl_k4", fed, fl=fl, system=SYSTEMS["wireless_slow"],
                      device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: ops.LAUNCHES[k] - before[k] for k in before
                if ops.LAUNCHES[k] != before[k]}
    if launched.get("mixing_aggregate") != 5 or \
            launched.get("gram_matrix") != 1:
        raise AssertionError(f"concept shift ucfl_k4: {launched}")
    if not all(math.isfinite(a) for a in h.mean_acc):
        raise AssertionError(f"concept shift ucfl_k4: {h.mean_acc}")
    print(f"  (d) ucfl_k4 on cifar_concept_shift (LeNet-5 32x32x3, m="
          f"{fed.m}), 5 fused rounds: mean_acc {h.mean_acc}, "
          f"{wall / 5:.4f} s/round incl. setup, launches {launched}",
          flush=True)


def train_path(card: str, b_launches: dict) -> dict:
    """Phase 12 but (b), which ran first (``b_launches`` its runs'
    launches); returns the launches of the phase's runs (the kernel
    checks at (b)'s shapes excluded)."""
    ops.reset_launches()
    t0 = time.perf_counter()
    _free_graphs()
    train_cli_runs(card)
    print(f"  (a) {time.perf_counter() - t0:.1f} s", flush=True)
    launches = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    ops.reset_launches()
    scenarios_path(card)
    for name, n in ops.LAUNCHES.items():
        launches[name] += n
    print(f"  (d) {time.perf_counter() - t0:.1f} s", flush=True)
    for name, n in b_launches.items():
        launches[name] += n
    print(f"  (b) ran first, in a process of its own (above, after "
          f"[build]): launches {b_launches}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    print(f"[device] {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}  "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}  "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    print("[build]", flush=True)
    t0 = time.perf_counter()
    for name, res in _build.build_all().items():
        print(f"  {name}.cu: {res.seconds:.2f} s -> {res.path.name}")
        for ln in res.log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                print(f"    {ln.strip()}")
    print(f"  build wall {time.perf_counter() - t0:.2f} s", flush=True)

    # [train] (b) needs ~50 GB of the card: a child process runs it now,
    # before this process creates its own CUDA context
    print(f"[train] (b) stablelm-3b at its published widths, depth 2, in a "
          f"process of its own ({card})", flush=True)
    t0 = time.perf_counter()
    b_launches = train_published_isolated()
    print(f"  (b) {time.perf_counter() - t0:.1f} s", flush=True)

    # [steps] needs ~40 GB of the card for (b)'s uncut step: a child
    # process too, before this process creates its own CUDA context
    print(f"[steps] the case builders on the scanned serving path, remat, "
          f"and the planner, in a process of its own ({card})", flush=True)
    steps_launches = steps_isolated()

    print("[kernels] kernel vs plain version on the card "
          f"(median CUDA-event ms, L2 flushed; {card})", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [check_mixing(gen), check_gram(gen)] + \
        check_channel_kernels(gen) + check_flash(gen) + \
        check_flash_mla(gen) + check_flash_nemotron(gen) + \
        check_flash_slice(gen)
    check_flash_vmap(gen)
    print("kernels: " + ", ".join(f"{r['name']} ok" for r in rows),
          flush=True)

    print("[agree] small runs and one uplink crossing, cuda against cpu",
          flush=True)
    # the CPU side is the reference here: with one intra-op thread its
    # reductions run in one order, so its bits repeat from process to
    # process (with the host's cores they did not, now and then)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        small_agreement()
        async_agreement()
        hierarchy_agreement()
        mesh_agreement()
        uplink_agreement()
        channel_agreement()
        lm_agreement()
        federated_agreement()
        train_agreement()
    finally:
        torch.set_num_threads(threads)

    t0 = time.perf_counter()
    fed = scenario_label_shift(0, n=MAIN["n"], m=MAIN["m"], device="cuda")
    torch.cuda.synchronize()
    fl = FLConfig(rounds=MAIN["rounds"], local_steps=MAIN["local_steps"],
                  batch_size=MAIN["batch_size"], eval_every=MAIN["eval_every"])
    print(f"[main] run_federated n={MAIN['n']} m={MAIN['m']} LeNet-5 "
          f"D={D_LENET}  data: x {tuple(fed.x.shape)}  x_val "
          f"{tuple(fed.x_val.shape)}  {time.perf_counter() - t0:.2f} s",
          flush=True)
    ops.reset_launches()          # counts from here on are the main path's
    hists = main_path(fed, fl)
    launches = dict(ops.LAUNCHES)
    print(f"  [main] launches {launches}", flush=True)

    print(f"[channel] run_federated n={MAIN['n']} m={MAIN['m']} through the "
          f"uplink channel ({card})", flush=True)
    ops.reset_launches()          # and from here on the channel path's
    channel_path(fed, fl, hists["fedavg"].time)
    print(f"  [channel] launches {dict(ops.LAUNCHES)}", flush=True)
    for name, n in ops.LAUNCHES.items():
        launches[name] += n

    print(f"[faults] run_federated n={MAIN['n']} m={MAIN['m']}: cfl, "
          f"fedfomo and the fault/defense layer, fused and eventful "
          f"({card})", flush=True)
    ops.reset_launches()          # and from here on the faults path's
    faults_path(fed, fl, card)
    print(f"  [faults] launches {dict(ops.LAUNCHES)}", flush=True)
    for name, n in ops.LAUNCHES.items():
        launches[name] += n

    print(f"[superstep] {MAIN['rounds']} rounds of ucfl_k4, n={MAIN['n']} "
          f"m={MAIN['m']}: fused (CUDA graphs) against eventful ({card})",
          flush=True)
    superstep_path(fed, fl, card)

    print(f"[async] run_federated(async_cfg=...) n={MAIN['n']} m={MAIN['m']}, "
          f"{MAIN['rounds']} events ({card})", flush=True)
    ops.reset_launches()          # and from here on the async path's
    t0 = time.perf_counter()
    keep = async_path(fed, fl, card,
                      {spec: h.time[-1] for spec, h in hists.items()})
    print(f"  [async] launches {dict(ops.LAUNCHES)}; phase wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, n in ops.LAUNCHES.items():
        launches[name] += n
    print(f"[checkpoint] save and restore on the card ({card})", flush=True)
    checkpoint_path(keep, card)
    print(f"[serve] the personalised serving plane over [main]'s ucfl "
          f"models, n={MAIN['n']} m={MAIN['m']} ({card})", flush=True)
    ops.reset_launches()          # and from here on the serving path's
    t0 = time.perf_counter()
    serve_path(hists, fed, card)
    print(f"  [serve] launches {dict(ops.LAUNCHES)}; phase wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, n in ops.LAUNCHES.items():
        launches[name] += n
    print(f"[paging] the cohort paging engine: {PAGING['population']} "
          f"clients on the host, {PAGING['cohort']} on the card at a time "
          f"({card})", flush=True)
    ops.reset_launches()          # and from here on the paging path's
    t0 = time.perf_counter()
    paging_path(card)
    print(f"  [paging] launches {dict(ops.LAUNCHES)}; phase wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, n in ops.LAUNCHES.items():
        launches[name] += n
    print(f"[hierarchy] the edge tier: [main]'s scenario, each user a fleet "
          f"of devices ({card})", flush=True)
    ops.reset_launches()          # and from here on the hierarchy path's
    t0 = time.perf_counter()
    hierarchy_path(fed, fl, hists["ucfl_k4"], card)
    print(f"  [hierarchy] launches {dict(ops.LAUNCHES)}; phase wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, n in ops.LAUNCHES.items():
        launches[name] += n
    print(f"[mesh] MeshShardMap on a one-rank NCCL group: [main]'s "
          f"scenario under the three mixing schedules ({card})", flush=True)
    ops.reset_launches()          # and from here on the mesh path's
    t0 = time.perf_counter()
    mesh_path(fed, fl, hists, card)
    print(f"  [mesh] launches {dict(ops.LAUNCHES)}; phase wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, n in ops.LAUNCHES.items():
        launches[name] += n
    print(f"[examples] the examples as the port's entry points at the "
          f"reference's defaults ({card})", flush=True)
    ops.reset_launches()          # and from here on the examples' path's
    t0 = time.perf_counter()
    examples_path(card)
    print(f"  [examples] launches {dict(ops.LAUNCHES)}; phase wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for row in ("mixing_aggregate", "gram_matrix", "qsgd_roundtrip",
                "topk_threshold"):
        if ops.LAUNCHES[row] < 1:
            raise AssertionError(f"[examples] {row} never launched")
    for name, n in ops.LAUNCHES.items():
        launches[name] += n
    for name, n in lm_path(card).items():
        launches[name] += n
    mla_layer_check(card)
    # the tensor-core kernel's hd 256, hd 80 and (192, 128) instances run
    # in [lm] (c), one configuration each: their rows count that
    # configuration's run
    by_arch = lm_c_path(card)
    print(f"[train] federated LM training through launch/train.py, the "
          f"scenario generators ({card})", flush=True)
    t0 = time.perf_counter()
    train_launches = train_path(card, b_launches)
    print(f"  [train] launches {train_launches}; phase wall "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, n in train_launches.items():
        launches[name] += n
    print(f"  [steps] (ran second, in a process of its own) launches "
          f"{steps_launches}", flush=True)
    for name, n in steps_launches.items():
        launches[name] += n
    for r in rows:
        counts = by_arch[r["phase"]] if "phase" in r else launches
        r["launches"] = sum(counts[c] for c in
                            r.get("counters", (r.get("counter", r["name"]),)))
        if r.get("off_path"):
            print(f"  {r['name']}: {r['launches']} launches (the QSGD "
                  "stream's quantize with absmax given is on no ported "
                  "path)", flush=True)
        elif r["launches"] < 1:
            raise AssertionError(f"{r['name']} never launched on the main, "
                                 "channel, faults, async, serve, paging, "
                                 "hierarchy, mesh, examples, lm, train or "
                                 "steps path")
    print(f"  total wall {time.perf_counter() - t_start:.1f} s", flush=True)
    # the mesh's process group (NCCL, with its gloo subgroup) ends here
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--train-published"]:
        sys.exit(_train_published_child())
    if sys.argv[1:] == ["--steps"]:
        sys.exit(_steps_child())
    sys.exit(main())
