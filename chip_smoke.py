"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed as it ends:
  1. device  — asserts CUDA and prints ``nvidia-smi``'s name and power limit;
  2. build   — compiles the six hand-written kernels from
               ``src/repro_torch/kernels/csrc/`` with nvcc (all at once);
  3. kernels — holds each kernel against its plain torch version on the card
               at the main path's shapes (gram at the special round's
               slab-wide (100, 47,616) rows, at 512 and 50 clients (the
               tensor-core route) and at 4 (``gram_m4``, the few-row
               route), each row naming its route: exactly symmetric, two
               calls bit-equal, one launch and no synchronizing call a
               call, and Δ on clustered rows within 2x the error of
               ``g @ g.T`` in f32; gram past 2^31 columns on the few-row
               route within F64_GRAM_TOL of an f64 Gram, timed beside
               ``g @ g.T`` (or its refusal); mix_aggregate also at leaf widths,
               a second row tile, one rule and an offset view, with two calls
               bit-equal and 28 zero columns of W bit-invisible;
               mix_aggregate also at k = 1 (the FedAvg family's mean) and
               at the engine's shapes (k = 1 over the 109 buffer rows, the
               4 edge aggregates, ucfl_k4's 16 tiered partial rules and the
               tier-2 combine over 4 edges), each mix row naming its
               route (the few-row route at k, m <= 16, else the tiles) and
               a few-row call also timed on the tile route (``tiles_ms``)
               and held bit for bit to it; the few-row route also in f32 and
               bf16 at aligned and odd widths and on offset views;
               kmeans_assign also at k = 99 with a tie across lanes, timed;
               the cohort kernels also with pad
               slots, an all-pad cohort and an odd width, the gather also at
               SCAFFOLD's (100, 95,232) EF slab, the mix-scatter
               also at 64 and 100 slots and over the async buffer's 109
               rows (live ids in arrival order after a deduped overwrite,
               a sentinel tail: exact inputs bit for bit the plain
               version), its plan printed, both also timed after a read
               flush (``read_ms``); flash_attention in
               bf16 and f32 over head dims 32-256, GQA, window, softcap,
               ragged and one-query shapes up to 4,096 keys, from strided
               views, printing which of its three kernels each case took:
               the bf16 tensor-core tile, the split-KV decode kernel or the
               FMA kernel), and times kernel, plain version and one PyTorch
               library call with CUDA events (gram also after a read flush,
               beside its route's bound and the f32 CUDA cores' bound, with
               its ptxas registers and spills), beside a one-element zero_()
               (the launch floor); then the decode route's host
               cost against the FMA route's, its launches (one kernel a
               call) and that 28 decode calls make no synchronizing call;
  4. agree   — Algorithm 1 at a small size on the card (kernels) against the
               port's plain path on the CPU, from the same data, weights and
               batch orders: two dense rounds, then two cohort rounds;
  5. main    — ``ucfl`` and ``ucfl_k4`` through ``simulation.run`` on
               scenario 2 at its defaults (100 clients, 1000 samples each,
               28x28x1, 47 classes) with LeNet-5 at its published widths,
               counting each kernel's launches (the special round: one gram
               launch on rows read where they lie, no padded copy, and
               full_grads of (m, 47,571));
  6. cohort  — the same at partial participation: ``ucfl`` and ``ucfl_k4``
               with half the clients a round, and ``ucfl`` with 50-slot
               cohorts drawn from a diurnal availability trace (rounds with
               pad slots), counting launches again (the special round as
               in phase 5); one more cohort round
               must make no synchronizing CUDA call
               (``torch.cuda.set_sync_debug_mode``);
  7. baselines — the nine baselines (fedavg, fedprox, local, oracle,
               scaffold, ditto, pfedme, fedfomo, cfl) at their reference
               defaults on the same task, dense and at fraction 0.5, 2 timed
               rounds each (cfl 4, its fourth running the split check): each
               beats the untrained model and launches exactly its kernels
               (k = 1 mixes for the FedAvg family, the group rule's mix or
               mix-scatter, fedfomo's gram and mix, one cohort_gather a
               gathered slab a cohort round, no padded gram copy); one
               dense round of each profiled; then gram on fedfomo's trained
               slab (its Δ within the f32 product's error of an f64 Δ),
               timed as the row ``gram_trained``; cfl's copy of its update
               deltas to the host read from its profiled split round;
  8. transport — the quantized wire: its stage on the card against the same
               stage on the CPU, bit for bit, on a 50-slot cohort's
               (50, 47,616) single-stream and (50, 95,232) SCAFFOLD slabs in
               int8 and fp8, and a constant delta's 17-round applied sum
               within one quantization step of 17·delta in every stream;
               then ucfl, ucfl_k4 and the nine baselines at fraction 0.5 on
               the same task, each on the raw wire and with int8 (ucfl and
               fedavg also fp8), 2 timed rounds (cfl 4), from the same seeds:
               exact launches a round (one cohort_gather more for the EF
               slab; full ucfl mixes its cohort rows with mix_aggregate and
               scatters them, for its delta-coded downlink), a profiled
               cohort round of each, the stage's launches and device time,
               accuracies, max|ef| and max|ef_dl| (finite, nonzero, schema
               wide), and the bytes a round from ``comm_model`` raw and int8;
               fails if ucfl's or ucfl_k4's int8 accuracy falls more than
               0.05 below the raw wire's, or a delta uplink prices fewer
               than 3.5x fewer bytes;
  9. knobs  — the engine knobs on the same task: gram on the streaming
               refresh's slab-wide unit-direction rows (100, 47,616) within
               1e-5 of its largest entry and with no padded copy, and the
               mix-scatter with holes mid-cohort (sentinel and in-range ids)
               bit for bit the compacted cohort's; the refresh and one
               faulted round at a small size against the CPU (1e-4); then
               ucfl and ucfl_k4 with ``RefreshConfig()`` at fraction 0.5 (2
               rounds) and ucfl under availability cohorts with an
               all-offline round (staleness, W's row sums and distance from
               the special round's W); ucfl_parallel, one dense round and one
               at fraction 0.5, without and with the refresh (wall, device
               busy, peak memory, units trained); ucfl and the nine
               baselines at fraction 0.5 under sign flips and drops
               (``FaultConfig(byzantine_frac=0.1, attack="sign_flip",
               drop_rate=0.1)``) with ``RobustConfig("trimmed_mean",
               trim_k=5)``; ucfl under each of the five robust rules and
               under NaN uploads with the finite guard alone: each run's
               accuracy against the untrained model, exact launches, a
               profiled cohort round's host-counted launches and busy time,
               and the upload stage's launches and ms at (50, 47,616);
               ``knobs_path`` JSON line;
  10. engine — the last engine knobs on the same task: the buffered-async
               server (``AsyncConfig(flush_k=60, alpha=0.5)``, a 109-row
               buffer) on ucfl, ucfl_k4, fedavg and fedprox at fraction 0.5
               for 4 rounds, deposit-only and flush rounds in turn, printing
               each round's flushed, applied, buffer_fill, tau_max and
               tau_mean (ucfl's τ > 0, the FedAvg family's 0), exact
               launches, a profiled round and one more buffered round with
               no synchronizing call; ucfl with ``AsyncConfig(flush_k=1,
               alpha=0.0)``, 2 rounds bit for bit the barrier rounds; the
               two-tier ``Topology.contiguous(100, 4)`` on ucfl_k4, fedavg
               and fedprox, 2 rounds within 1e-4 of the flat runs from the
               same seeds; ucfl through ``run(selection=SelectionConfig(...))``
               for 3 rounds (every cohort holds the fairness lane's client
               and no battery-gated one); ucfl under the ``scaled_noise``
               and ``inf`` attacks with trimmed mean, 1 round, finite and
               above the untrained model; ``engine_path`` JSON line;
  10b. mesh  — the client mesh over torch.distributed on the same task:
               ucfl and ucfl_k4 over a one-rank NCCL group
               (``FedConfig(mesh="auto")``), with and without
               ``shard_state``, special round included, 3 cohort rounds at
               fraction 0.5, each bit for bit the run without a mesh; then
               2 and 4 gloo ranks spawned on the one card
               (``mesh.spawn``, the kernels built once before) running
               ucfl, ucfl_k4, fedavg, ditto, scaffold and buffered-async
               ucfl, replicated and row-sharded, from the same seeds: each
               rank's rows within rtol 1e-5, atol 1e-6 of the run without
               a mesh, row-sharded bit for bit replicated, rows outside the
               last cohort bit-identical through its round, m/s params rows
               a rank, accuracy above the untrained model; per rank the
               rounds' walls, a profiled round's busy time and launches,
               launches by kernel and the collectives' calls, bytes and ms.
               Every run records its kernel calls (``recorded_calls``; the
               ranks' through rank 0's copies): every shape each kernel got
               is held against its plain version, and each kernel's
               launches form a row, ``<kernel>_block`` for the row-sharded
               runs (``cohort_gather_block``, ``masked_mix_scatter_block``
               on a rank's block), ``<kernel>_mesh`` for the replicated runs
               and the runs without a mesh; the row-sharded ucfl state's
               checkpoint (``checkpoint.save`` on every rank: gathered, rank
               0 writes) byte for byte the replicated state's at s = 2 and
               4; ``mesh_path`` JSON line;
  11. serve-agree — reduced qwen2-7b and gemma2-9b in f32 for 2 clients: the
               federated prefill step (the FMA kernel) and teacher-forced
               decode steps (the decode kernel; gemma2 past its window-64
               wrap) on the card against the plain path on the CPU; then
               both in bf16, the prefill step through the tensor-core tile
               and 72 decode steps through the decode kernel, each against
               the same steps with the plain attention on the card;
  12. serve  — personalized serving of qwen2-7b at full width and depth
               (28 layers, bf16) for 2 clients x 2 requests: the federated
               prefill step over 1024 tokens, a profile of decode steps,
               a profile of one prefill step, then ``serve()`` (a 128-token
               teacher-forced prompt and 32 greedy tokens), counting the
               attention kernels' launches (28 of the tensor-core tile per
               prefill, 28 of the decode kernel per decode step, none of the
               FMA kernel);
  13. families-agree — reduced mixtral-8x7b, kimi-k2 (``first_dense``),
               mamba2-1.3b, zamba2-2.7b at 12 layers (two shared-attention
               groups), whisper-large-v3 (2 + 2 layers over 32 stub frames)
               and internvl2-1b (8 patch embeddings) in f32 for 2 clients:
               the federated prefill step over 64 tokens (the FMA kernel
               once an attention call: whisper's encoder, self and cross
               attention) and 72 teacher-forced decode steps (the decode
               kernel; whisper's cross K/V from its encoder) on the card
               against the plain path on the CPU, logits and every cache
               leaf (k, v, pos; the SSM's h and conv; cross_kv) within 1e-4;
               then each in bf16, the tile's prefill step and 72
               decode-kernel steps against the plain attention on the card
               (2^-5 of the largest logit; each attention call within one
               bf16 step); then one user-centric train step of reduced
               mixtral, whisper and internvl2 on the card against the CPU
               (``train_step_agree``'s rule);
  14. families — mixtral-8x7b at its published widths cut to 4 of 32
               layers, mamba2-1.3b (48 layers), zamba2-2.7b (54),
               whisper-large-v3 (32 encoder + 32 decoder layers),
               internvl2-1b (24), gemma2-9b (42) and phi3-medium-14b (40)
               at full width and depth, bf16, 2 personalized clients x 2
               requests: the
               federated prefill step over 1024 tokens (mixtral 4 tile
               launches a call, zamba2 9 at Dh 80, mamba2 none), whisper's
               over 1,500 stub frames and a 256-token prompt (96: 32
               encoder, 32 self, 32 cross over 1,500 keys), internvl2's over
               256 patches and 768 tokens (24, GQA 7 at Dh 64) and gemma2's
               over 4,096 tokens (42 at Dh 256, softcap 50, window 4096 on
               the local layers), phi3's over 1024 (40, GQA 4 at Dh 128); 16
               timed greedy decode steps on its caches
               from the prompt's end and 4 profiled ones (one decode-kernel
               launch an attention call a step: whisper 64, gemma2's local
               caches wrapping), each profiled; mixtral's dropped share at capacity factor 1.25;
               one mixtral MoE layer in f32 with a capacity that drops
               nothing against the O(E·N) oracle (1e-5 of the largest |y|)
               and one mamba2 SSD block in f32, its chunked forward over 512
               tokens against 512 decode steps (the reference's tolerances,
               y rtol 1e-3 atol 1e-5, h rtol 1e-4 atol 1e-5); ``families_path``
               JSON line;
  14b. ep    — expert parallelism (``moe.set_ep_mesh``, the rank mesh of
               ``repro_torch.launch.mesh``): kimi-k2-1t-a32b at its published
               widths cut to its dense first block and one MoE layer (19.9 B
               parameters, bf16), one model (the fedsgd_sharded regime), 2 x 2
               requests of 1,024 tokens: on one rank with the local sort
               dispatch (``sharding.rank_params`` with no mesh), a prefill
               step (one warm, 2 timed, 1 profiled: the tile twice a call)
               and 4 timed + 4 profiled greedy decode steps (the decode
               kernel twice a step), the dropped share, the routing's
               busiest experts and how much of each layer's activation all
               tokens share (``routing_probe``); then over a (data 2,
               model 2) mesh of gloo ranks sharing the card (``mesh.spawn``),
               each building only its block of the 384 experts (192
               experts' d_ff halves) and serving its data rank's 2 requests
               the same way: per rank init, prefill and decode walls, busy,
               peak GB, the drops at cap and at cap2, each collective's
               calls, bytes and ms; the EP layer on the one-rank run's layer
               input against its output on every token neither run dropped,
               and at capacity factor 8 on every token against the same
               arithmetic on one rank without capacities (``ep_plain``;
               both 2^-6 of the largest |y|), aux within 1e-6;
               ``serve(mesh=)``, the entry point, on a short prompt; the
               reduced f32 EP fedsgd step (capacity factor 8) against the
               one-rank step, each leaf within 1e-5 (L2); then
               ``build_train_step(mix_gather_shardings=)``: stablelm-1.6b as
               the train phase runs it, 4 clients over 2 gloo ranks, 2
               user-centric steps against the unsharded ones (bit for bit,
               or each leaf's change and the losses within STEP_DELTA_TOL;
               which holds is printed, with whether the mix's (2, 4) row
               block is the (4, 4) mix's rows bit for bit), the step walls and
               the all-gathered bytes; ``ep_path`` JSON line. Every kernel
               call of the phase is recorded (``recorded_calls``; a rank's
               inputs copied by rank 0) and each run gets its kernel rows
               (``recorded_rows``), every shape held against the plain
               version: ``flash_attention_{prefill,decode}_kimi`` (one
               rank), ``_kimi_rank`` (a data rank),
               ``flash_attention_decode_kimi_serve`` (``serve(mesh=)``),
               ``flash_attention_fma_kimi_train{,_rank}`` (the reduced EP
               step), ``{flash_attention_prefill,mix_aggregate}_gather`` and
               ``_gather_rank`` (the stablelm steps);
  15. train  — federated training of stablelm-1.6b at its published widths
               (d_model 2048, 32 x 64 MHA heads, d_ff 5632, vocab 100,352,
               bf16, remat), depth cut to 4 of 24 layers, 4 clients in 2
               groups, 4 x 256 tokens a client a step on chains over 512
               tokens: the tile at the train shape through
               ``FlashAttentionFn``, its q, k, v gradients against autograd
               through the plain version; the collaboration round on real
               LM gradients (K = 4 partitions raveled into one zero-tailed
               (4, 4, d_aligned) bf16 buffer, full gradients (4, d_aligned)
               f32, one gram launch on rows read where they lie, no padded
               copy, held against the plain gram as row ``gram_lm``; W
               finite and row-stochastic, its within- and cross-group
               mass); then 8 steps each of ``user_centric`` (W),
               ``clustered`` (K-means on W's rows, k = 2), ``fedavg`` and
               ``local`` from the same start and batches (one user-centric
               step first against the same step with the plain attention
               and mix on the card, held on each leaf's change, the plain
               side launching no kernel): every step's
               loss, the last below the first, exact launches a step (one
               mix a leaf for the mixing aggs, none for local; the tile
               twice a layer), the step's wall, tokens/s, a profiled step
               and peak memory; one user-centric mix against the plain mix
               on every leaf, and the mix for k = 4, 2 and 1 against the
               plain mix at every leaf width in the leaves' bf16 and in f32,
               each few-row call bit for bit the tile route's (f32) or its
               f32 output cast to bf16, timed at the widest (rows
               ``mix_aggregate_lm_k*`` and ``mix_aggregate_lm_k*_bf16``, the
               latter counting the steps' launches); then
               ``launch.train.main([--arch stablelm-1.6b --smoke --rounds
               20])``, its loss falling; then ``make_ucfl`` over reduced
               qwen2-7b's slab with last-token class logits, 3 cohort
               rounds, the loss below half its start. The k-means on W,
               the entry point and the ucfl run record their kernel calls
               (``recorded_calls``): every shape each kernel got is held
               against its plain version on the recorded inputs, and each
               kernel's launches there form a row (``kmeans_assign_lm``,
               ``<kernel>_smoke``, ``<kernel>_ucfl_lm``); ``train_path``
               JSON line;
  16. checkpoint — ``repro_torch.checkpoint`` save and restore, bit for
               bit on the card, of a LeNet ``ucfl`` state with
               ``RefreshConfig()`` and a buffered ``fedavg`` state
               (``AsyncConfig(flush_k=60)``), each after a cohort round on
               scenario 2, and one client's trained LM params (1.23 GB of
               bf16), with their times; ``checkpoint_path`` JSON line;
  16b. family_train — federated training of five more families at their
               published widths, bf16, remat on, seed 0, 2 groups, chains
               over 512 tokens (``FAMILY_TRAIN``): mamba2-1.3b at 32 of 48
               layers and zamba2-2.7b at 24 of 54 slots (4 clients x 2 x
               512 tokens, two SSD chunks), mixtral-8x7b at 1 of 32 layers
               under ``remat_policy="save_moe"`` (2 clients x 4 x 256),
               whisper-large-v3 (4 x 256 decoder tokens over 1,500 stub
               frames) and internvl2-1b (4 x 256 tokens after 256 patches)
               whole, 4 clients; each built, run and freed before the next
               (a counted or measured peak past 76 GB, or a refused
               allocation, fails the phase). Each cell:
               its user-centric step counted on meta (peak, kernel calls;
               mixtral's also at 4 clients, printed only);
               the collaboration round through ``launch.train.collaboration``
               (mamba2, zamba2, mixtral: one gram launch, no padded copy,
               W finite and row-stochastic with its within-group mass, the
               gram row held against an f64 Gram within F64_GRAM_TOL (the
               few-row route's, unscaled), the round's peak beside its 16
               bytes a parameter a client; the
               others take their groups' block W); K-means on W (51
               launches); one user-centric step with the kernels against
               the same step on the plain attention and mix
               (``train_step_agree``: each leaf within STEP_DELTA_TOL, or
               twice the bf16-P control's reading up to STEP_DELTA_CAP; a
               leaf the control reads at 1 or more, its plain change being
               rounding noise, by its size; its launches equal to the meta
               count's calls); 4 user_centric steps (losses finite
               and falling), one clustered and one fedavg step, one
               profiled user-centric step; exact launches a step (one mix a
               leaf, the tile twice an attention call, no FMA launch); the
               step's peak beside the count. The recorded step's attention
               calls are held with their q, k, v gradients against
               autograd through the plain version (``flash_grad_row``), the
               mixes at every leaf width for W, the centroid rules and the
               mean (``mix_lm_rows``, every width the step mixed), the
               K-means calls by ``recorded_rows``: rows ``gram_<family>``,
               ``mix_aggregate_<family>_k<k>`` and ``..._k<k>_bf16``,
               ``flash_attention_train_<family>`` (whisper's ``_encoder``,
               ``_self``, ``_cross``), ``kmeans_assign_family_train``; then
               ``launch.train.main`` on the reference's usage line (``--arch
               mamba2-1.3b --smoke --clients 4 --groups 2 --rounds 30``, at
               ``--lr 0.1``), its loss falling (rows
               ``<kernel>_smoke_mamba2``);
               ``family_train_path`` JSON line;
  17. dryrun   — three steps counted on the meta device
               (``repro_torch.launch.dryrun.make_step`` + ``count_step``):
               the train phase's stablelm-1.6b user-centric step, the serve
               phase's qwen2-7b prefill (2 x 2 x 1,024) and one decode step
               over those positions; then each run on the card with random
               arguments of the counted shapes: its kernel launches equal
               the counted calls, ``FlopCounterMode``'s FLOPs the counted
               aten FLOPs and the arguments' bytes the counted ones,
               exactly; the predicted peak over ``max_memory_allocated``'s
               in [0.8, 1.25]; the roofline's largest term at most the
               median wall, so each ``<kind>_mfu`` (counted FLOPs over the
               wall times each dtype's peak) at most 1; every kernel call
               recorded and held against its plain version (rows
               ``<kernel>_dry_<cell>``); ``dryrun_path`` JSON line.
Then one ``{"kernels": [...]}`` JSON line and, last, the ``{"ok": true, ...}``
line. Any failure raises: the script exits non-zero and prints no result.
Imports nothing of jax or of the reference package.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gc
import inspect
import io
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import checkpoint, configs  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core import REGISTRY, FedConfig, ParticipationConfig, clustering, flat, ucfl  # noqa: E402
from repro_torch.core import aggregation, comm_model, pytree  # noqa: E402
from repro_torch.core.pytree import leaves  # noqa: E402
from repro_torch.core.aggregation import RobustConfig  # noqa: E402
from repro_torch.core.similarity import RefreshConfig  # noqa: E402
from repro_torch.data import lm_synthetic, loader, synthetic  # noqa: E402
from repro_torch.federated import async_buffer, client, faults, participation  # noqa: E402
from repro_torch.federated import mesh as mesh_lib  # noqa: E402
from repro_torch.federated import simulation, transport  # noqa: E402
from repro_torch.federated.async_buffer import AsyncConfig  # noqa: E402
from repro_torch.federated.topology import Topology  # noqa: E402
from repro_torch.federated.transport import TransportConfig  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.cohort_gather import GATHER  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels.flash_attention import FLASH_DEC, FLASH_FMA, FLASH_TC  # noqa: E402
from repro_torch.kernels.flash_attention import flash_route  # noqa: E402
from repro_torch.kernels.kmeans_assign import ASSIGN  # noqa: E402
from repro_torch.kernels.masked_mix_scatter import MIX_SCATTER  # noqa: E402
from repro_torch.kernels.mix_aggregate import (MIX, MIX_TILES, mix_aggregate_cuda,  # noqa: E402
                                               mix_plan, tile_plan)
from repro_torch.kernels.pairwise_delta import GRAM, gram_plan  # noqa: E402
from repro_torch.launch import dryrun, op_analysis, roofline  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_lib  # noqa: E402
from repro_torch.models import lenet, registry, transformer, whisper  # noqa: E402
from repro_torch.optim import sgd_init  # noqa: E402

ROUNDS = 5
SEED = 0
# the baselines phase: the nine in Table 1's order, 2 timed rounds each
# (CFL 4, so that its fourth round runs the split check after its 3
# warm-up rounds); the cohort_gather launches of a cohort round, one for
# each slab it gathers
BASELINES = ["fedavg", "fedprox", "local", "oracle", "scaffold", "ditto", "pfedme", "fedfomo",
             "cfl"]
BASELINE_ROUNDS = {"cfl": 4}
GATHERS = {"scaffold": 3, "ditto": 2}
COUNTERS = {"gram": GRAM, "mix_aggregate": MIX, "kmeans_assign": ASSIGN,
            "cohort_gather": GATHER, "masked_mix_scatter": MIX_SCATTER,
            "flash_attention_prefill": FLASH_TC, "flash_attention_decode": FLASH_DEC,
            "flash_attention_fma": FLASH_FMA}
FLASH_ROUTES = {"tc": FLASH_TC, "decode": FLASH_DEC, "fma": FLASH_FMA}
# the serve phase: qwen2-7b at full width and depth, 2 clients x 2 requests
SERVE_ARCH = "qwen2-7b"
SERVE_CLIENTS, SERVE_BATCH = 2, 2
PREFILL_LEN, PREFILL_REPS = 1024, 3
PROMPT_LEN, DECODE_TOKENS = 128, 32
# (B, Hq, Hkv, Sq, Sk, Dh, causal, window, softcap) of the flash check
FLASH_CASES = [
    (4, 28, 4, 1024, 1024, 128, True, None, None),  # qwen2-7b's prefill (2 clients x 2)
    (4, 28, 4, 1, 160, 128, False, None, None),     # qwen2-7b's last decode step
    (2, 32, 32, 200, 200, 64, True, None, None),    # stablelm's heads, ragged
    (2, 4, 2, 100, 100, 80, False, None, None),     # Dh 80, bidirectional, ragged
    (2, 16, 8, 300, 300, 256, True, 128, 50.0),     # gemma2's heads, window, softcap
    (4, 14, 2, 1, 97, 256, False, None, 50.0),      # decode, group 7, Dh 256
    (1, 4, 2, 100, 260, 64, True, None, None),      # Sq < Sk: top-left causal
    (1, 2, 1, 40, 10, 32, True, 4, None),           # rows past Sk + window - 1: uniform
    (3, 4, 2, 65, 129, 32, True, 64, 30.0),         # reduced gemma2, one past the tiles
    # around the tensor-core tile (bf16, Sq >= 16, Dh % 8 == 0, aligned)
    (2, 8, 2, 15, 15, 64, True, None, None),        # Sq 15: the FMA kernel
    (2, 8, 2, 16, 16, 64, True, None, None),        # Sq 16: the tile's smallest q
    (2, 8, 4, 64, 200, 256, False, 48, 20.0),       # Dh 256, window + softcap, not causal
    (2, 4, 2, 70, 70, 36, True, None, None),        # Dh 36: the FMA kernel
    (1, 4, 2, 16, 300, 128, True, None, None),      # Sq < Sk at the tile's smallest q
    (1, 2, 1, 80, 20, 64, True, 8, 10.0),           # rows past Sk + window - 1, two q tiles
    # around the decode kernel (Sq = 1, f32 or bf16, Dh % 8 == 0, aligned)
    (4, 28, 4, 1, 4096, 128, False, None, None),    # qwen2-7b's decode over 4,096 keys
    (4, 16, 8, 1, 4096, 256, False, None, 50.0),    # gemma2-9b's decode over 4,096 keys
    (4, 32, 32, 1, 300, 64, False, None, None),     # stablelm's MHA (group 1)
    (4, 28, 4, 1, 600, 128, True, None, None),      # causal, several splits: out = v[:, :, 0]
    (2, 8, 2, 1, 20, 64, False, None, None),        # under one split's minimum keys: one split
    (2, 48, 2, 1, 333, 80, False, 7, 30.0),         # group 24: three row tiles a kv head, window
    (2, 12, 4, 1, 77, 40, False, None, None),       # Dh 40 below its padded width
    (2, 8, 2, 1, 50, 36, False, None, None),        # Dh 36: the FMA kernel
]
# the families phase's attention shapes (2 clients x 2 requests): mixtral-8x7b's
# GQA-4 at Dh 128 with window 4096, zamba2-2.7b's MHA at Dh 80 (the tile's
# 128-wide template, the decode kernel's at group 1); decode over the
# 1,024-token prefill's cache and 16 more tokens
MIXTRAL_PREFILL = (4, 32, 8, 1024, 1024, 128, True, 4096, None)
MIXTRAL_DECODE = (4, 32, 8, 1, 1040, 128, False, None, None)
ZAMBA2_PREFILL = (4, 32, 32, 1024, 1024, 80, True, None, None)
ZAMBA2_DECODE = (4, 32, 32, 1, 1040, 80, False, None, None)
FLASH_CASES += [MIXTRAL_PREFILL, MIXTRAL_DECODE, ZAMBA2_PREFILL, ZAMBA2_DECODE]
# the encoder-decoder and VLM families and gemma2-9b at full width, 2 clients
# x 2 requests: whisper-large-v3's MHA at Dh 64 over its 1,500 encoder frames
# (bidirectional, no multiple of the tile's 64 rows), its decoder's causal
# self-attention over the 256-token prompt and its cross-attention over the
# frames; internvl2-1b's GQA-7 at Dh 64 over 256 patches + 768 tokens;
# gemma2-9b's Dh 256 with softcap 50 over a 4,096-token prompt, causal on
# the global layers and within window 4096 on the local ones; decode from
# the prompt's end for 20 steps (whisper's self-attention over 257-276 keys)
WHISPER_ENCODER = (4, 20, 20, 1500, 1500, 64, False, None, None)
WHISPER_SELF = (4, 20, 20, 256, 256, 64, True, None, None)
WHISPER_CROSS = (4, 20, 20, 256, 1500, 64, False, None, None)
WHISPER_DECODE_SELF = (4, 20, 20, 1, 276, 64, False, None, None)
WHISPER_DECODE_CROSS = (4, 20, 20, 1, 1500, 64, False, None, None)
INTERNVL2_PREFILL = (4, 14, 2, 1024, 1024, 64, True, None, None)
INTERNVL2_DECODE = (4, 14, 2, 1, 1040, 64, False, None, None)
GEMMA2_PREFILL = (4, 16, 8, 4096, 4096, 256, True, None, 50.0)
GEMMA2_PREFILL_WINDOW = (4, 16, 8, 4096, 4096, 256, True, 4096, 50.0)
GEMMA2_DECODE = (4, 16, 8, 1, 4096, 256, False, None, 50.0)  # in the sweep already
FLASH_CASES += [WHISPER_ENCODER, WHISPER_SELF, WHISPER_CROSS, WHISPER_DECODE_SELF,
                WHISPER_DECODE_CROSS, INTERNVL2_PREFILL, INTERNVL2_DECODE, GEMMA2_PREFILL,
                GEMMA2_PREFILL_WINDOW]
# phi3-medium-14b whole at full width, 2 clients x 2 requests: GQA 4 (40
# query heads over 10) at Dh 128, causal over the 1,024-token prompt, then
# decode over 1,025-1,040 keys
PHI3_PREFILL = (4, 40, 10, 1024, 1024, 128, True, None, None)
PHI3_DECODE = (4, 40, 10, 1, 1040, 128, False, None, None)
FLASH_CASES += [PHI3_PREFILL, PHI3_DECODE]
# the FMA kernel's row: the reduced f32 prefill step of the serve-agree
# phase (2 clients x 2 requests x 40 tokens, reduced qwen2-7b's heads)
FMA_CASE = (4, 4, 2, 40, 40, 32, True, None, None)
# the decode route may cost the host at most this much more a call than the
# FMA route (the decode step is bound by the host's launches)
HOST_GATE_US = 5.0
# the knobs phase's small-size agreement: two attackers of eight, drops
AGREE_FAULTS = faults.FaultConfig(byzantine_frac=0.25, attack="sign_flip", drop_rate=0.2)
# the engine phase: a 60-upload flush over 50-slot cohorts, so deposit-only
# and flush rounds alternate; its buffer holds B = 60 - 1 + 50 rows; four
# contiguous edges for the two-tier runs
ENGINE_ASYNC = AsyncConfig(flush_k=60, alpha=0.5)
ENGINE_ROUNDS = 4
BUFFER_ROWS = ENGINE_ASYNC.capacity(50)
EDGES = 4
# the train phase: stablelm-1.6b at its published widths, depth cut to 4 of
# 24 layers; 4 clients in 2 groups, 4 x 256 tokens a client a step, chains
# over a 512-token vocabulary inside the 100,352-row table, 8 steps an agg
TRAIN_ARCH = "stablelm-1.6b"
TRAIN_LAYERS = 4
TRAIN_CLIENTS, TRAIN_GROUPS = 4, 2
TRAIN_BATCH, TRAIN_SEQ = 4, 256
TRAIN_CHAIN_VOCAB = 512
TRAIN_STEPS = 8
TRAIN_LR = 0.1
# gram_lm against an f64 Gram of its (4, 616.6 M) rows: 5e-4 of the largest
# entry, about 4.6 times the tensor-core route's error there (8.69e-4 of
# 8.06), where a block sums F64_GRAM_SPLIT columns (132 splits); on that
# route rows whose splits are longer get F64_GRAM_TOL x their split's
# columns / F64_GRAM_SPLIT, as an f32 sum's worst rounding grows with its
# length (mixtral-8x7b's 1,713 M columns: 12,980,448 a split, 1.39e-3; a
# split left out would err about 1/132 = 7.6e-3 of the largest entry).
# The few-row route, which takes every such shape (m <= M_ROWS), is
# held to F64_GRAM_TOL unscaled: a thread's f32 sums run over some
# d / 33,792 columns, not a block's split
F64_GRAM_TOL = 5e-4
F64_GRAM_SPLIT = 4_671_232
# a train step's change of a leaf, kernels against the plain attention and
# mix on the card, |Δ - Δ_plain| / |Δ_plain| in L2: twice the largest
# reading (0.125, the query projection's), or twice the reading of the
# bf16-P control on that leaf where larger (zamba2-2.7b's conv weights read
# 0.27 on an H100: their gradients are small sums of large terms), but
# never past STEP_DELTA_CAP (a lost gradient reads 1, two unrelated changes
# of one size about 1.41)
STEP_DELTA_TOL = 0.25
STEP_DELTA_CAP = 0.75
# the family_train phase: five more families trained at their published
# widths, bf16, remat on, 2 groups, chains over TRAIN_CHAIN_VOCAB tokens.
# Depth and clients are cut where one card forces it (the collaboration
# round holds about 16 bytes a parameter a client: the params, the (m, 4,
# d) bf16 partition gradients, the f32 full gradients, one partition's
# gradients): mamba2-1.3b at 32 of 48 layers and zamba2-2.7b at 24 of 54
# slots (4 of 9 hybrid groups), 4 clients x 2 x 512 tokens (two SSD chunks
# of 256, so the inter-chunk recurrence and its backward run);
# mixtral-8x7b at 1 of 32 layers under remat_policy="save_moe", 2 clients
# (its step at 4 counted 79.8 GB with the mixes' f32 copies; the phase
# prints today's count) x 4 x 256; whisper-large-v3 (4 x 256
# decoder tokens over 1,500 stub frames) and internvl2-1b (4 x 256 tokens
# after 256 patches) whole, 4 clients, with no collaboration round (the
# reference's launch/train.py takes token batches only): their W is the two
# groups' block, uniform within a group. A cell whose counted step or round
# reckoning passes FAMILY_TRAIN_PEAK_GB fails before it runs, and one whose
# measured peak passes it, or that the card refuses, fails the phase.
class TrainCell(NamedTuple):
    arch: str
    layers: int | None  # None: the published depth
    clients: int
    batch: int
    seq: int
    remat_policy: str = "full"
    collaborate: bool = True


FAMILY_TRAIN = (TrainCell("mamba2-1.3b", 32, 4, 2, 512),
                TrainCell("zamba2-2.7b", 24, 4, 2, 512),
                TrainCell("mixtral-8x7b", 1, 2, 4, 256, "save_moe"),
                TrainCell("whisper-large-v3", None, 4, 4, 256, collaborate=False),
                TrainCell("internvl2-1b", None, 4, 4, 256, collaborate=False))
FAMILY_TRAIN_STEPS = 4
FAMILY_TRAIN_PEAK_GB = 76.0
# the reference's usage line of its train entry point (src/repro/launch/
# train.py), at the paper's learning rate 0.1: at the entry point's default 0.3
# the reduced mamba2 spikes in both packages (the reference on a CPU: 0.86 at round 9,
# 3.10 at 15; the port on an H100: 0.53 at round 24, 5.48 at 30)
FAMILY_ENTRY = ("--arch", "mamba2-1.3b", "--smoke", "--clients", "4", "--groups", "2",
                "--rounds", "30", "--lr", "0.1")
# the families phases: reduced mixtral-8x7b, kimi-k2 (first_dense), mamba2-1.3b
# and zamba2-2.7b at 12 layers (two hybrid groups) held against the CPU;
# then mixtral-8x7b cut to 4 of 32 layers, mamba2-1.3b and zamba2-2.7b at
# full depth, served at full width: a 1,024-token prefill step, then
# FAMILY_DECODE timed greedy decode steps on its caches and 4 profiled ones
AGREE_FAMILIES = {"mixtral-8x7b": {}, "kimi-k2-1t-a32b": {}, "mamba2-1.3b": {},
                  "zamba2-2.7b": {"num_layers": 12}, "whisper-large-v3": {}, "internvl2-1b": {}}
AGREE_PREFILL = 64  # a multiple of the reduced SSD chunk (32)
# the reduced families whose f32 train step families-agree runs
AGREE_TRAIN = ("mixtral-8x7b", "whisper-large-v3", "internvl2-1b")
# reduced mixtral's f32 train step, card against CPU, |Δ_card - Δ_cpu| /
# |Δ_cpu| in L2 for each leaf: about 130 times the largest reading
# (7.647e-07 on an H100); a mix or a product in bf16 or TF32 reads 1e-3
# and more
FAMILY_STEP_TOL = 1e-4
FAMILY_LAYERS = {"mixtral-8x7b": 4, "mamba2-1.3b": None, "zamba2-2.7b": None,
                 "whisper-large-v3": None, "internvl2-1b": None, "gemma2-9b": None,
                 "phi3-medium-14b": None}
# the prompt's tokens where a family's is not PREFILL_LEN: whisper's decoder
# prompt (beside its 1,500 frames; the 20 decode steps stay inside its
# 448-position decoder), internvl2's tokens after its 256 patches (1,024
# positions), and gemma2's 4,096 tokens, which fill its local layers'
# 4,096-slot rolling caches, so the first decode step wraps them
FAMILY_PROMPT = {"whisper-large-v3": 256, "internvl2-1b": 768, "gemma2-9b": 4096}
FAMILY_DECODE, FAMILY_PROFILED = 16, 4
# the full-width layer checks: the SSD's chunked forward against its
# one-token recurrence over SSD_TOKENS tokens (the reference's own
# tolerances, tests/test_models.py), and the MoE layer against the O(E·N)
# oracle on MOE_TOKENS tokens in f32
SSD_TOKENS = 512
MOE_TOKENS = 1024
# the dryrun phase: three steps counted on the meta device
# (repro_torch.launch.dryrun), then run on the card and held against the
# counts: the train phase's stablelm-1.6b cell (4 of 24 layers, 4 clients,
# 4 x 256 tokens, user_centric), the serve phase's qwen2-7b prefill (2 x 2 x
# 1,024) and one decode step over those 1,024 positions. The predicted
# peak over the measured one must lie in DRY_PEAK_RATIO; walls: the median
# of DRY_WALLS synchronized calls after the counted ones
DRY_PEAK_RATIO = (0.8, 1.25)
DRY_WALLS = 3


def phase(name, t0, msg):
    print(f"[{name}] {msg} ({time.perf_counter() - t0:.1f} s)", flush=True)


def time_ms(fn, dev, reps=30, flush="write"):
    """Median CUDA-event time of ``fn`` on the device, with a cold L2.

    Before every sample a 256 MB write (``flush="write"``) evicts the 50 MB
    L2, and a ~1 ms device-side spin keeps the GPU busy while the host
    enqueues the timed call, so the events bracket device work only, not
    host dispatch. The write leaves the L2 full of dirty lines, which the
    timed call writes back; ``flush="read"`` evicts with a 256 MB ``sum()``
    instead, which leaves clean ones."""
    buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    fn()
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(reps):
        if flush == "write":
            buf.zero_()
        else:
            buf.sum()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_phase():
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", t0, f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return dev


def build_phase():
    t0 = time.perf_counter()
    libs = _build.build_all()
    for src, lib in libs.items():
        log = lib.with_suffix(".log")
        info = [ln.split("ptxas info    : ")[-1] for ln in
                (log.read_text().splitlines() if log.exists() else [])
                if "Used" in ln or "spill" in ln]
        print(f"  {src}: {' | '.join(info) or 'built earlier'}")
    phase("build", t0, f"{len(libs)} kernels built for sm_90a")


def check(name, got, want, tol):
    err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err:.3e} > tolerance {tol:.3e}")
    return err


def check_mix(name, got, want, chunk=2**24):
    """A mix's output against the plain version's, in θ's dtype: f32 within
    1e-5 of the largest output (f32 sums of m products in another order);
    bf16 each element within one bf16 step of itself (2^-7 of it) plus that
    allowance, since the two f32 sums may round to neighbouring bf16 values
    and, where the terms cancel, differ by more than a step of the small
    result (compared over column chunks: a leaf's f32 copies are large).
    Returns the largest |got - want|."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} against the plain "
                             f"version's {want.dtype} {tuple(want.shape)}")
    top = float(want.abs().max()) if want.numel() else 0.0
    if got.dtype == torch.float32:
        return check(name, got, want, 1e-5 * top)
    err = 0.0
    for c0 in range(0, got.shape[1], chunk):
        g, w = got[:, c0: c0 + chunk].float(), want[:, c0: c0 + chunk].float()
        diff = (g - w).abs()
        if not bool((diff <= 2.0 ** -7 * w.abs() + 1e-5 * top).all()):
            raise AssertionError(f"{name}: an element is more than one bf16 step of itself plus "
                                 f"1e-5 of the largest output off the plain version")
        err = max(err, float(diff.max()))
    return err


def mix_route(w, theta):
    """(route, detail) of the launch ``ops.mix_aggregate(w, theta)`` makes
    (``mix_plan``): "rows", the few-row route at k, m <= 16, or "tiles"."""
    (k, mm), d = w.shape, theta.shape[1]
    elem = theta.element_size()
    plan = mix_plan(k, mm, d, theta.data_ptr(), theta.data_ptr(), elem=elem,
                    sm_count=flash._sm_count(theta.device.index))
    if plan.route == "rows":
        return "rows", (f"few-row route, {str(theta.dtype)[6:]}: {plan.blocks} blocks of "
                        f"{plan.run} columns, {'16-byte packs' if plan.vec else 'scalar path'}")
    copy = "" if theta.dtype == torch.float32 else f", through an f32 copy of {theta.dtype}"
    return "tiles", (f"tile route: tile {plan.tile} ({MIX_TILES[plan.tile].rows} rows), "
                     f"{plan.blocks} blocks{copy}")


def hold_mix_bits(name, w, theta, got):
    """A few-row mix's output ``got`` bit for bit against the tile route:
    f32 its output, bf16 its f32 output on the widened θ cast to bf16 (the
    path before the few-row route). A tile-route call is not held. Returns
    whether the call was held."""
    if mix_route(w, theta)[0] != "rows":
        return False
    tiles = mix_aggregate_cuda(w, theta.float(), route="tiles")
    if not torch.equal(got, tiles.to(theta.dtype)):
        raise AssertionError(f"{name}: the few-row route's {theta.dtype} output differs from "
                             f"the tile route's f32 output cast to {theta.dtype}")
    return True


def mix_row(name, w, theta, dev, reps=30, work=None):
    """A kernel row of the mix on (w, θ): the kernel against the plain
    version (``check_mix``), a few-row call against the tile route
    (``hold_mix_bits``); timed beside the plain version, the library call
    ``w.to(θ.dtype) @ θ`` and, for a few-row call, the tile route
    (``tiles_ms``: for bf16 θ the f32 copy, the tile route and the cast
    back). ``work`` defaults to the call's own."""
    (k, mm), width = w.shape, theta.shape[1]
    got = ops.mix_aggregate(w, theta, impl="cuda")
    want = ref.mix_aggregate(w, theta)
    err = check_mix(name, got, want)
    del want
    route, detail = mix_route(w, theta)
    held = hold_mix_bits(name, w, theta, got)
    del got
    r = dict(source="src/repro_torch/kernels/csrc/mix_aggregate.cu",
             replaces="src/repro/kernels/mix_aggregate.py:40", max_abs_err=err,
             ms=time_ms(lambda: ops.mix_aggregate(w, theta, impl="cuda"), dev, reps),
             plain_ms=time_ms(lambda: ref.mix_aggregate(w, theta), dev, reps),
             library_ms=time_ms(lambda: w.to(theta.dtype) @ theta, dev, reps),
             mix_route=route, route_detail=detail, tile_bits=int(held),
             work=work or roofline.mix_aggregate_work(k, mm, width, theta.element_size()))
    if route == "rows":
        r["tiles_ms"] = time_ms(lambda: mix_aggregate_cuda(w, theta, route="tiles"), dev, reps)
    return r


def kernel_phase(dev):
    """Each kernel against its plain version at main-path shapes."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    m, d, d_al = 100, 47571, 47616
    rows = {}

    rows.update(gram_rows(gen, dev, m, d, d_al))

    # mix_aggregate over the slab: full ucfl (k = 100), ucfl_k4 (k = 4) and
    # the FedAvg family's mean (k = 1); over a 50-slot cohort's uploads,
    # FedFomo's mix (k = 50) and the FedAvg family's mean (k = 1)
    # the engine's shapes: the FedAvg family's flush over the B buffer rows,
    # tiered FedAvg's 4 edge aggregates and their combine, and ucfl_k4's
    # (E·k, c) tiered partial rules
    theta = 0.05 * torch.randn(BUFFER_ROWS, d_al, generator=gen, device=dev)
    theta[:, d:] = 0.0
    for name, k, mm in (("mix_aggregate_k100", 100, m), ("mix_aggregate_k4", 4, m),
                        ("mix_aggregate_k1", 1, m), ("mix_aggregate_k50", 50, 50),
                        ("mix_aggregate_k1_m50", 1, 50),
                        ("mix_aggregate_k1_b109", 1, BUFFER_ROWS),
                        ("mix_aggregate_k4_m50", EDGES, 50),
                        ("mix_aggregate_k16_m50", EDGES * 4, 50),
                        ("mix_aggregate_k1_m4", 1, EDGES)):
        w = torch.softmax(torch.randn(k, mm, generator=gen, device=dev), dim=1)
        rows[name] = mix_row(f"mix k={k} m={mm}", w, theta[:mm], dev)
    mix_sweep(gen, dev)

    # kmeans_assign: W's 100 rows against 4 centroids, plus an exact tie
    pts = torch.softmax(4.0 * torch.randn(m, m, generator=gen, device=dev), dim=1)
    cents = pts[torch.randperm(m, generator=gen, device=dev)[:4]].clone()
    gl, gd = ops.kmeans_assign(pts, cents, impl="cuda")
    wl, wd = ref.kmeans_assign(pts, cents)
    if not torch.equal(gl, wl):
        raise AssertionError("kmeans_assign: labels differ from the plain version")
    err = check("kmeans dist", gd, wd, 1e-5 * float(wd.abs().max()) + 1e-7)
    tied = torch.cat([cents[:2], cents[1:2], cents[2:]])  # rows 1 and 2 identical
    tl, _ = ops.kmeans_assign(pts, tied, impl="cuda")
    rl, _ = ref.kmeans_assign(pts, tied)
    if not torch.equal(tl, rl) or bool((tl == 2).any()):
        raise AssertionError("kmeans_assign: an exact tie did not go to the lower index")
    f, k = m, 4
    rows["kmeans_assign"] = dict(
        source="src/repro_torch/kernels/csrc/kmeans_assign.cu",
        replaces="src/repro/kernels/kmeans_assign.py:37", max_abs_err=err,
        ms=time_ms(lambda: ops.kmeans_assign(pts, cents, impl="cuda"), dev),
        plain_ms=time_ms(lambda: ref.kmeans_assign(pts, cents), dev),
        library_ms=time_ms(lambda: torch.cdist(pts, cents).argmin(dim=1), dev),
        work=roofline.kmeans_assign_work(m, k, f))
    rows["kmeans_assign"]["k99"] = kmeans_k99(gen, dev, pts)

    rows.update(cohort_kernel_rows(gen, dev, m, d_al))
    rows["masked_mix_scatter_b109"] = buffer_scatter_row(gen, dev, m, d_al)
    rows.update(flash_rows(dev))

    for name, r in rows.items():
        finish_row(name, r)
    decode = rows["flash_attention_decode"]
    print("flash_decode " + json.dumps({"long": decode.pop("long"), "host": decode.pop("host")}))
    print("kmeans_k99 " + json.dumps(rows["kmeans_assign"].pop("k99")))
    print("gram_delta " + json.dumps(rows["gram"].pop("delta")))
    floor = launch_floor(dev)
    print("launch_floor " + json.dumps({"zero_1_ms": floor}))
    print(f"  launch floor: a one-element zero_() times {floor:.4f} ms under time_ms")
    phase("kernels", t0, f"8 kernels agree with their plain versions ({len(rows)} rows)")
    return rows


def finish_row(name, r):
    """Turn a kernel row's work (``roofline``'s work function of its shape)
    into its bound, and print it."""
    r["bound_ms"], r["bound_by"] = r.pop("work").bound()
    extra = ((f"  read_ms {r['read_ms']:.4f} ms" if "read_ms" in r else "")
             + (f"  library read {r['library_read_ms']:.4f} ms"
                if "library_read_ms" in r else "")
             + (f"  f32 CUDA-core bound {r['bound_f32_ms']:.5f} ms"
                if "bound_f32_ms" in r else "")
             + (f"  tile route {r['tiles_ms']:.4f} ms" if "tiles_ms" in r else "")
             + (f"  [{r['plan']}]" if "plan" in r else "")
             + (f"  [{r['route_detail']}]" if "route_detail" in r else "")
             + (f"  [{r['shape']}]" if "shape" in r else ""))
    library = (f"library none ({r.get('library_none')})" if r["library_ms"] is None else
               f"library {r['library_ms']:.4f} ms  kernel/library {r['ms'] / r['library_ms']:.2f}")
    print(f"  {name}: max_abs_err {r['max_abs_err']:.3e}  kernel {r['ms']:.4f} ms  "
          f"plain {r['plain_ms']:.4f} ms  bound {r['bound_ms']:.5f} ms ({r['bound_by']})  "
          f"{library}{extra}")


def ptxas_info(source, entry=""):
    """(registers, spill store bytes) of ``source``'s kernels from its
    build log: the most over the entry functions whose mangled name holds
    ``entry`` (all of them by default)."""
    regs, spills, name = [], [], ""
    for line in _build.target(source).with_suffix(".log").read_text().splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties for) '?([\w.$]+)", line)
        if found:
            name = found.group(1)
        if entry not in name:
            continue
        regs += [int(x) for x in re.findall(r"Used (\d+) registers", line)]
        spills += [int(x) for x in re.findall(r"(\d+) bytes spill stores", line)]
    if not regs:
        raise AssertionError(f"{source}: no ptxas report of an entry function holding '{entry}'")
    return max(regs), max(spills)


def gram_rows(gen, dev, m, d, d_al):
    """gram at the special round's slab-wide rows (m, 47,616) with the 45
    columns past d zero, at 512 clients, at FedFomo's 50-slot cohort
    (``gram_m50``, the one-job tile) and at 4 rows (``gram_m4``, the
    few-row route at the slab's width): exactly symmetric, within
    1e-5 of the plain version's largest entry, two calls bit-equal, one
    launch and no synchronizing call a call, no padded copy; Δ on
    clustered rows (4 groups, each row its group's gradient plus noise at
    1e-3 of its norm) against Δ from an f64 Gram, within 2x the error of
    Δ from ``g @ g.T`` in full f32 and within 1e-5 of the largest
    diagonal. Timed after a write and a read flush, beside the plain
    version and ``g @ g.T``; bound_ms is the route's (bytes, or 3xTF32
    tensor work: 3 x FLOP at 495 TFLOP/s, or the few-row route's f32 FLOP
    at 67), bound_f32_ms the f32 CUDA cores' (FLOP at 67 TFLOP/s), FLOP
    counted as m(m+1)d."""
    rows = {}
    for name, mm in (("gram", m), ("gram_m512", 512), ("gram_m50", 50), ("gram_m4", 4)):
        g = torch.zeros(mm, d_al, device=dev)
        g[:, :d] = 1e-2 * torch.randn(mm, d, generator=gen, device=dev)
        rows[name] = gram_row(name, g, d, dev)
    rows["gram"]["delta"] = gram_delta_check(dev, m, d, d_al)
    rows["gram"]["wide"] = gram_wide_check(dev)
    return rows


def gram_f64(g, chunk=2**24):
    """G Gᵀ in f64, summed over column chunks of ``g``."""
    out = torch.zeros(g.shape[0], g.shape[0], dtype=torch.float64, device=g.device)
    for c0 in range(0, g.shape[1], chunk):
        x = g[:, c0: c0 + chunk].double()
        out += x @ x.T
    return out


def f64_gram_gate(m, d, dev):
    """(the share of the largest entry that gram on (m, d) rows may err
    against an f64 Gram, the columns a block of its plan sums): on the
    few-row route F64_GRAM_TOL; on the tensor-core route F64_GRAM_TOL
    times its longest split's columns over F64_GRAM_SPLIT where more."""
    plan = gram_plan(m, d, flash._sm_count(dev.index))
    if plan.route == "rows":
        return F64_GRAM_TOL, plan.run
    split = max(t.chunk for t in plan.tiles)
    return F64_GRAM_TOL * max(1.0, split / F64_GRAM_SPLIT), split


def gram_route(m, d, dev):
    """The route gram's plan takes on (m, d) rows and what it launches, for
    the kernel rows: the few-row route's blocks and runs and its
    instance's registers, or the tensor-core route's."""
    plan = gram_plan(m, d, flash._sm_count(dev.index))
    if plan.route == "rows":
        regs, spills = ptxas_info("gram.cu", f"gram_rows_kernelILi{m}E")
        return plan.route, (f"few-row route (CUDA cores, f32 sums), {plan.blocks} blocks of "
                            f"{plan.run} columns; {regs} registers, {spills} bytes spilled")
    regs, spills = ptxas_info("gram.cu", "gram_kernel")
    return plan.route, (f"tensor-core route (wgmma 3xTF32, TMA ring), {plan.blocks} blocks; "
                        f"{regs} registers, {spills} bytes spilled")


def gram_wide_check(dev, m=2, d=3 * 2**30 + 1_004):
    """gram on (m, d) rows past 2^31 columns on the few-row route (m <=
    M_ROWS), which addresses its blocks' runs with 64-bit offsets (132 runs
    of 24,403,232 columns here, 44 of them starting past 2^31, the last
    one shorter): one launch, no padded copy, exactly
    symmetric, within ``f64_gram_gate`` of an f64 Gram (F64_GRAM_TOL). The
    columns from 2^31 on are 4 times the others, so a run read at a
    wrapped 32-bit offset is off by a large share of the diagonal. Timed
    over 3 calls beside its bound and the library call ``g @ g.T`` (or the
    error with which the library refuses it)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    g = 1e-2 * torch.randn(m, d, generator=gen, device=dev)
    g[:, 2**31:] *= 4.0
    launches, copies = GRAM.launches, GRAM.padded
    got = ops.gram(g, impl="cuda")
    torch.cuda.synchronize()
    if GRAM.launches - launches != 1 or GRAM.padded != copies or not torch.equal(got, got.T):
        raise AssertionError(f"gram at {d} columns: {GRAM.launches - launches} launches, "
                             f"{GRAM.padded - copies} padded copies, symmetric "
                             f"{torch.equal(got, got.T)}")
    exact = gram_f64(g)
    err, largest = float((got.double() - exact).abs().max()), float(exact.abs().max())
    tol, split = f64_gram_gate(m, d, dev)
    if not err <= tol * largest:
        raise AssertionError(f"gram at {d} columns: error {err:.3e} against an f64 Gram is over "
                             f"{tol:.3e} of its largest entry {largest:.3e}")
    ms = time_ms(lambda: ops.gram(g, impl="cuda"), dev, 3)
    try:  # the library call at this shape: cuBLAS's product over 2^31-plus columns
        library = time_ms(lambda: g @ g.T, dev, 3)
        library_note = f"{library:.3f} ms"
    except RuntimeError as exc:  # a refusal is recorded, not a failure of the kernel's check
        library, library_note = None, f"refused ({str(exc).splitlines()[0][:160]})"
    bound = roofline.gram_work(m, d).bound()[0]
    route, detail = gram_route(m, d, dev)
    del g
    torch.cuda.empty_cache()
    print(f"  gram at ({m}, {d}) past 2^31 columns, {detail}: against an f64 Gram it errs "
          f"{err:.3e} = {err / largest:.2e} of the largest entry {largest:.4e} (gate {tol:.2e}, "
          f"{split} columns a block); {ms:.3f} ms a call (3 calls), bound {bound:.3f} ms; "
          f"g @ g.T {library_note}")
    return dict(m=m, d=d, err=err, largest=largest, tol=tol, ms=ms, bound_ms=bound, route=route,
                library_ms=library, library_note=library_note)


def gram_row(name, g, d, dev, *, against_f64=False, reps=30, reads=True):
    """gram on the (m, d_al) rows ``g`` (true width d): the checks and the
    times of :func:`gram_rows` (``reps`` timed calls; the times after a
    read flush only with ``reads``); returns the kernel row. With
    ``against_f64`` (rows far wider than the slab's 47,616, where f32 sums
    of d products in any order drift past 1e-5 of the largest entry) the
    kernel is held instead against an f64 Gram of the same rows, within
    F64_GRAM_TOL of its largest entry (``f64_gram_gate``: scaled on the
    tensor-core route by the columns a split of the launch's plan sums
    over F64_GRAM_SPLIT where that is more); the plain f32 version's
    (``g @ g.T``) error is printed beside the kernel's. The row names the
    route the plan took (``gram_route``)."""
    mm, d_al = g.shape
    route, detail = gram_route(mm, d_al, dev)
    want = ref.gram(g)
    launches, copies = GRAM.launches, GRAM.padded
    got = ops.gram(g, impl="cuda")
    if GRAM.launches - launches != 1 or GRAM.padded != copies:
        raise AssertionError(f"{name}: {GRAM.launches - launches} launches, "
                             f"{GRAM.padded - copies} padded copies in one call")
    torch.cuda.synchronize()
    if not torch.equal(got, got.T):
        raise AssertionError(f"{name}: kernel output is not exactly symmetric")
    if not torch.equal(got, ops.gram(g, impl="cuda")):
        raise AssertionError(f"{name}: two calls gave different bits")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.gram(g, impl="cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if against_f64:
        exact = gram_f64(g)
        mine = float((got.double() - exact).abs().max())
        plain = float((want.double() - exact).abs().max())
        largest = float(exact.abs().max())
        tol, split = f64_gram_gate(mm, d_al, dev)
        if not mine <= tol * largest:
            raise AssertionError(f"{name}: error {mine:.3e} against an f64 Gram is over "
                                 f"{tol:.3e} of its largest entry {largest:.3e} ({split} "
                                 f"columns a split)")
        err = float((got - want).abs().max())
        print(f"  {name}: against an f64 Gram the kernel errs {mine:.3e} = "
              f"{mine / largest:.2e} of the largest entry {largest:.4e} (gate {tol:.2e}, "
              f"{split} columns a block), the plain f32 version {plain:.3e}; kernel - plain "
              f"{err:.3e}")
    else:
        # f32 sums of 47,571 products in another order: 1e-5 of the largest entry
        err = check(name, got, want, 1e-5 * float(want.abs().max()))
    work = roofline.gram_work(mm, d_al, useful_width=d)
    row = dict(
        source="src/repro_torch/kernels/csrc/gram.cu",
        replaces="src/repro/kernels/pairwise_delta.py:41", max_abs_err=err,
        ms=time_ms(lambda: ops.gram(g, impl="cuda"), dev, reps),
        plain_ms=time_ms(lambda: ref.gram(g), dev, reps),
        library_ms=time_ms(lambda: g @ g.T, dev, reps),
        bound_f32_ms=roofline.Work(work.bytes, work.flops).bound()[0],
        route_detail=detail, gram_route=route, work=work)
    if reads:
        row.update(read_ms=time_ms(lambda: ops.gram(g, impl="cuda"), dev, reps, flush="read"),
                   library_read_ms=time_ms(lambda: g @ g.T, dev, reps, flush="read"))
    return row


def delta_errors(g):
    """The largest errors of Δ from the kernel and from ``g @ g.T`` (full
    f32) against Δ from an f64 Gram of the same f32 rows, and that Gram's
    largest diagonal."""
    g64 = g.double()
    gram64 = g64 @ g64.T
    exact = ref.delta_from_gram(gram64)
    return {"kernel_err": float((ref.delta_from_gram(ops.gram(g, impl="cuda").double())
                                 - exact).abs().max()),
            "f32_err": float((ref.delta_from_gram((g @ g.T).double()) - exact).abs().max()),
            "largest_diagonal": float(torch.diagonal(gram64).max())}


def gram_delta_check(dev, m, d, d_al, groups=4, noise=1e-3):
    """Δ from the kernel and from ``g @ g.T`` (full f32) against Δ from an
    f64 Gram of the same f32 rows; returns both errors and the bound."""
    gen64 = torch.Generator(device=dev)
    gen64.manual_seed(SEED + 7)
    common = torch.randn(groups, d, generator=gen64, device=dev, dtype=torch.float64)
    jitter = torch.randn(m, d, generator=gen64, device=dev, dtype=torch.float64)
    rows = common[torch.arange(m, device=dev) % groups]
    rows = rows + noise * rows.norm(dim=1, keepdim=True) * jitter / jitter.norm(dim=1, keepdim=True)
    g = torch.zeros(m, d_al, device=dev)
    g[:, :d] = rows.float()
    out = delta_errors(g)
    err, err_f32, diag = out["kernel_err"], out["f32_err"], out["largest_diagonal"]
    if not (err <= 2 * err_f32 and err <= 1e-5 * diag):
        raise AssertionError(f"gram: Δ on clustered rows off by {err:.3e}, g @ g.T in f32 by "
                             f"{err_f32:.3e}, largest diagonal {diag:.3e}")
    print(f"  gram Δ on clustered rows ({groups} groups, noise {noise} of the norm): kernel "
          f"{err:.3e}, g @ g.T f32 {err_f32:.3e}, largest diagonal {diag:.3e}")
    return out


def mix_sweep(gen, dev):
    """mix_aggregate beyond the main path's two shapes, each against the
    plain version within 1e-5 of the largest output: odd and narrow leaf
    widths (the scalar path), a second row tile over a 32-chunk ring, one
    rule over three clients, and θ one float into its buffer (the scalar
    path at d % 4 == 0). Then, at both main-path shapes and a two-row-tile
    one, the ordered sums: two calls give the same bits, and W with 28 zero
    columns appended (θ with 28 matching rows) gives the bits of the
    unpadded product."""
    m = 100
    for k, mm, width in ((100, m, 97), (4, m, 6), (100, m, 150), (150, 512, 1000), (1, 3, 5)):
        w = torch.softmax(torch.randn(k, mm, generator=gen, device=dev), dim=1)
        th = torch.randn(mm, width, generator=gen, device=dev)
        want = ref.mix_aggregate(w, th)
        check(f"mix k={k} m={mm} d={width}", ops.mix_aggregate(w, th, impl="cuda"), want,
              1e-5 * float(want.abs().max()))
    w = torch.softmax(torch.randn(m, m, generator=gen, device=dev), dim=1)
    view = torch.empty(m * 1000 + 1, device=dev)[1:].view(m, 1000)
    view.copy_(torch.randn(m, 1000, generator=gen, device=dev))
    want = ref.mix_aggregate(w, view)
    check("mix offset view", ops.mix_aggregate(w, view, impl="cuda"), want,
          1e-5 * float(want.abs().max()))
    for k, mm, width in ((100, m, 47616), (4, m, 47616), (150, 512, 1000)):
        w = torch.softmax(torch.randn(k, mm, generator=gen, device=dev), dim=1)
        th = torch.randn(mm, width, generator=gen, device=dev)
        first = ops.mix_aggregate(w, th, impl="cuda")
        if not torch.equal(first, ops.mix_aggregate(w, th, impl="cuda")):
            raise AssertionError(f"mix k={k} d={width}: two calls gave different bits")
        w_pad = torch.cat([w, torch.zeros(k, 28, device=dev)], dim=1)
        th_pad = torch.cat([th, torch.randn(28, width, generator=gen, device=dev)], dim=0)
        if not torch.equal(first, ops.mix_aggregate(w_pad, th_pad, impl="cuda")):
            raise AssertionError(f"mix k={k} d={width}: 28 zero columns changed the bits")
    # the few-row route (k, m <= 16) in f32 and bf16: aligned and odd widths,
    # narrower than a pack, θ one element into its buffer (the scalar path),
    # each against the plain version and bit for bit the tile route
    held = 0
    for k, mm, width in ((4, 4, 65_536), (2, 4, 4_099), (1, 2, 5), (16, 16, 1_000),
                         (3, 7, 2_056)):
        for dtype in (torch.float32, torch.bfloat16):
            w = torch.softmax(torch.randn(k, mm, generator=gen, device=dev), dim=1)
            th = torch.randn(mm, width, generator=gen, device=dev).to(dtype)
            buf = torch.empty(mm * width + 1, dtype=dtype, device=dev)
            view = buf[1:].view(mm, width)
            view.copy_(th)
            for label, x in (("", th), (" offset view", view)):
                name = f"mix k={k} m={mm} d={width} {dtype}{label}"
                got = ops.mix_aggregate(w, x, impl="cuda")
                check_mix(name, got, ref.mix_aggregate(w, x))
                held += hold_mix_bits(name, w, x, got)
    print(f"  mix: 6 more shapes within 1e-5 of the largest output; two calls equal and 28 "
          f"zero columns bit-invisible at 3 shapes; the few-row route at {held} calls (f32, "
          f"bf16, odd widths, offset views) bit for bit the tile route")


def kmeans_k99(gen, dev, pts):
    """kmeans_assign at Algorithm 2's largest k for m = 100 (k = 99 of W's
    rows), with identical centroids at 3 and 40 (lanes apart): the labels
    equal the plain version's and none is 40; then the kernel, the plain
    version and cdist + argmin timed beside the bound."""
    m, f, k = pts.shape[0], pts.shape[1], 99
    cents = pts[torch.randperm(m, generator=gen, device=dev)[:k]].clone()
    cents[40] = cents[3]
    gl, gd = ops.kmeans_assign(pts, cents, impl="cuda")
    wl, wd = ref.kmeans_assign(pts, cents)
    if not torch.equal(gl, wl) or bool((gl == 40).any()):
        raise AssertionError("kmeans_assign k=99: labels differ from the plain version")
    out = dict(max_abs_err=check("kmeans k=99 dist", gd, wd, 1e-5 * float(wd.abs().max()) + 1e-7),
               ms=time_ms(lambda: ops.kmeans_assign(pts, cents, impl="cuda"), dev),
               plain_ms=time_ms(lambda: ref.kmeans_assign(pts, cents), dev),
               library_ms=time_ms(lambda: torch.cdist(pts, cents).argmin(dim=1), dev))
    out["bound_ms"], out["bound_by"] = roofline.kmeans_assign_work(m, k, f).bound()
    print(f"  kmeans_assign k=99 (100 points of width 100): kernel {out['ms']:.4f} ms, plain "
          f"{out['plain_ms']:.4f} ms, cdist + argmin {out['library_ms']:.4f} ms, bound "
          f"{out['bound_ms']:.6f} ms ({out['bound_by']}); labels equal, tie at 3 and 40 to 3")
    return out


def launch_floor(dev):
    """time_ms of a one-element zero_(): what a latency-bound row pays for
    its launch and the events around it."""
    one = torch.empty(1, device=dev)
    return time_ms(lambda: one.zero_(), dev)


def padded_cohort(gen, dev, m, slots, real):
    """(idx int32, mask bool) on the card: ``real`` sorted members, then
    pad slots with the sentinel m."""
    members = torch.sort(torch.randperm(m, generator=gen, device=dev)[:real]).values
    idx = torch.full((slots,), m, dtype=torch.int32, device=dev)
    idx[:real] = members.to(torch.int32)
    mask = torch.arange(slots, device=dev) < real
    return idx, mask


def cohort_kernel_rows(gen, dev, m, d_al, c=50, real=42):
    """cohort_gather and masked_mix_scatter at the cohort phase's shapes: a
    50-slot cohort of the (100, 47,616) slab with 42 members and 8 pads;
    the gather also of SCAFFOLD's (100, 95,232) EF slab."""
    rows = {}
    full = torch.randn(m, d_al, generator=gen, device=dev)
    idx, mask = padded_cohort(gen, dev, m, c, real)

    # cohort_gather: a copy, so it must equal the plain version exactly
    for width in (d_al, 97):
        f = full[:, :width].contiguous()
        for index in (idx, torch.full_like(idx, m)):  # the padded and an all-pad cohort
            if not torch.equal(ops.cohort_gather(f, index, impl="cuda"),
                               ref.cohort_gather(f, index)):
                raise AssertionError(f"cohort_gather d={width}: differs from the plain version")
    safe = idx.long().clamp(max=m - 1)
    # and SCAFFOLD's EF slab under a quantized wire: two streams, (100, 95,232)
    wide = torch.randn(m, 2 * d_al, generator=gen, device=dev)
    for index in (idx, torch.full_like(idx, m)):
        if not torch.equal(ops.cohort_gather(wide, index, impl="cuda"),
                           ref.cohort_gather(wide, index)):
            raise AssertionError(f"cohort_gather d={2 * d_al}: differs from the plain version")
    for name, slab in (("cohort_gather", full), ("cohort_gather_w95232", wide)):
        rows[name] = dict(
            source="src/repro_torch/kernels/csrc/cohort_gather.cu",
            replaces="src/repro/kernels/masked_gather_mix_scatter.py:93", max_abs_err=0.0,
            ms=time_ms(lambda slab=slab: ops.cohort_gather(slab, idx, impl="cuda"), dev),
            read_ms=time_ms(lambda slab=slab: ops.cohort_gather(slab, idx, impl="cuda"), dev,
                            flush="read"),
            plain_ms=time_ms(lambda slab=slab: ref.cohort_gather(slab, idx), dev),
            library_ms=time_ms(lambda slab=slab: slab.index_select(0, safe), dev),
            work=roofline.cohort_gather_work(c, slab.shape[1]))

    # masked_mix_scatter: rules over the real columns only (pad columns 0)
    w, theta = scatter_rules(gen, dev, c, real, d_al)
    err = check_scatter(f"masked_mix_scatter c={c}", w, theta, idx, mask, full, real)
    check_scatter(f"masked_mix_scatter c={c} d=97", w, theta[:, :97].contiguous(), idx, mask,
                  full[:, :97].contiguous(), real)
    kept = full.clone()
    ops.masked_mix_scatter(w, theta, torch.full_like(idx, m), torch.zeros_like(mask), kept,
                           impl="cuda")
    torch.cuda.synchronize()
    if not torch.equal(kept, full):
        raise AssertionError("masked_mix_scatter: an all-pad cohort changed the state")
    # past the cohort's 50 slots: the 64-row tile's last c, and the 128-row tile
    for cc, rr in ((64, 56), (100, 90)):
        i2, m2 = padded_cohort(gen, dev, m, cc, rr)
        w2, th2 = scatter_rules(gen, dev, cc, rr, d_al)
        check_scatter(f"masked_mix_scatter c={cc}", w2, th2, i2, m2, full, rr)
        plan = tile_plan(cc, cc, d_al, th2.data_ptr(), full.data_ptr())
        print(f"  masked_mix_scatter c={cc} ({rr} members): within 1e-5, pads bit-invisible, "
              f"tile {plan.tile} ({MIX_TILES[plan.tile].rows} rows), {plan.blocks} blocks")
    scratch = full.clone()
    live = idx[:real].long()
    w_live = w[:real].contiguous()
    plan = tile_plan(c, c, d_al, theta.data_ptr(), scratch.data_ptr())
    rows["masked_mix_scatter"] = dict(
        source="src/repro_torch/kernels/csrc/masked_mix_scatter.cu",
        replaces="src/repro/kernels/masked_mix_scatter.py:132, "
                 "src/repro/kernels/masked_gather_mix_scatter.py:167", max_abs_err=err,
        ms=time_ms(lambda: ops.masked_mix_scatter(w, theta, idx, mask, scratch, impl="cuda"),
                   dev),
        read_ms=time_ms(lambda: ops.masked_mix_scatter(w, theta, idx, mask, scratch,
                                                       impl="cuda"), dev, flush="read"),
        plain_ms=time_ms(lambda: ref.masked_mix_scatter(w, theta, idx, mask, full), dev),
        # two library calls: the product of the live rules, then index_copy_
        library_ms=time_ms(lambda: scratch.index_copy_(0, live, w_live @ theta), dev),
        plan=f"tile {plan.tile} ({MIX_TILES[plan.tile].rows} rows), {plan.blocks} blocks of "
             f"{plan.threads} threads, {'16-byte' if plan.vec else 'scalar'} path",
        work=roofline.masked_mix_scatter_work(c, d_al, real))
    return rows


def scatter_rules(gen, dev, c, real, d):
    """A padded cohort's (c, c) rules, softmax over the ``real`` columns and
    0 in the pad columns, and its (c, d) uploads."""
    w = torch.zeros(c, c, device=dev)
    w[:, :real] = torch.softmax(torch.randn(c, real, generator=gen, device=dev), dim=1)
    return w, 0.05 * torch.randn(c, d, generator=gen, device=dev)


def check_scatter(name, w, theta, idx, mask, full, real):
    """masked_mix_scatter into a copy of ``full`` against the plain version:
    within 1e-5 of the largest output, every row outside the cohort as it
    was, and the bits of the unpadded cohort (the first ``real`` slots).
    Returns the largest error."""
    want = ref.masked_mix_scatter(w, theta, idx, mask, full)
    got = ops.masked_mix_scatter(w, theta, idx, mask, full.clone(), impl="cuda")
    err = check(name, got, want, 1e-5 * float(want.abs().max()))
    outside = torch.ones(full.shape[0], dtype=torch.bool, device=full.device)
    outside[idx[:real].long()] = False
    if not torch.equal(got[outside], full[outside]):
        raise AssertionError(f"{name}: a row outside the cohort moved")
    unpadded = ops.masked_mix_scatter(w[:real, :real].contiguous(), theta[:real].contiguous(),
                                      idx[:real], mask[:real], full.clone(), impl="cuda")
    if not torch.equal(unpadded, got):
        raise AssertionError(f"{name}: the padded cohort's rows are not bit-for-bit the "
                             "unpadded cohort's")
    return err


def buffer_scatter_row(gen, dev, m, d_al):
    """masked_mix_scatter over the async buffer's B = 109 rows, as ucfl's
    flush runs it: two 50-slot cohorts deposited on the card (the second
    overwriting some of the first's clients in place and appending the
    rest), so the live ids are in arrival order, not increasing, with the
    sentinel tail after them; the deposits equal the same deposits on the
    CPU. The flush rules of the live slots, weighted by staleness: within
    1e-5 of the plain version, and with exact inputs (rules in eighths,
    integer rows) bit for bit the plain version, whatever the order of the
    sums; a deposit-only flush (mask False) moves nothing. Timed like the
    cohort row; its bound counts the live rows and columns that this
    buffer's data needs."""
    cpu_gen = torch.Generator().manual_seed(SEED + 11)
    bufs = [async_buffer.init_buffer(ENGINE_ASYNC, m, 50, d_al, device=d) for d in ("cpu", dev)]
    for rnd, real in ((0, 44), (1, 42)):
        members = torch.sort(torch.randperm(m, generator=cpu_gen)[:real]).values
        idx = torch.full((50,), m, dtype=torch.int32)
        idx[:real] = members.to(torch.int32)
        mask = torch.arange(50) < real
        upload = torch.randn(50, d_al, generator=cpu_gen)
        base = torch.full((50,), rnd, dtype=torch.int32)
        args = (upload, idx, mask, base)
        bufs = [async_buffer.deposit(b, *(x.to(b["idx"].device) for x in args), m) for b in bufs]
    host, buf = bufs
    for k in ("idx", "ver", "count", "version", "last_sync"):
        if not torch.equal(buf[k].cpu(), host[k]):
            raise AssertionError(f"async deposit on the card: {k} differs from the CPU's")
    if not torch.equal(async_buffer.rows(buf).cpu(), async_buffer.rows(host)):
        raise AssertionError("async deposit on the card: the buffer rows differ from the CPU's")
    bidx = buf["idx"]
    valid = async_buffer.valid_mask(buf, m)
    count = int(buf["count"])
    ids = bidx[:count].cpu()
    if (bool((ids[1:] > ids[:-1]).all()) or bool(valid[count:].any())
            or not bool(valid[:count].all()) or not count < 44 + 42):
        raise AssertionError(f"the buffer's live ids are not deduped, unsorted and followed by "
                             f"the sentinel tail: {bidx.tolist()}")
    buf = dict(buf, version=torch.ones_like(buf["version"]))  # round 1's slots are 1 old
    weights = async_buffer.staleness_weights(buf, m, ENGINE_ASYNC.alpha)
    w_all = torch.softmax(torch.randn(m, m, generator=gen, device=dev), dim=1)
    rules = aggregation.masked_cohort_matrix(w_all, bidx, valid, weights)
    theta = async_buffer.rows(buf)
    full = torch.randn(m, d_al, generator=gen, device=dev)
    b = BUFFER_ROWS
    flush = torch.ones((), dtype=torch.bool, device=dev)
    err = check_scatter_unsorted("masked_mix_scatter b=109", rules, theta, bidx, valid & flush,
                                 full)
    # exact inputs: every sum is exact in f32, so any order gives the same bits
    exact_w = torch.randint(0, 9, (b, b), generator=gen, device=dev).float() / 8.0
    exact_w = exact_w * valid.float()[None, :]
    exact_t = torch.randint(-8, 9, (b, d_al), generator=gen, device=dev).float()
    want = ref.masked_mix_scatter(exact_w, exact_t, bidx, valid, full)
    got = ops.masked_mix_scatter(exact_w, exact_t, bidx, valid, full.clone(), impl="cuda")
    if not torch.equal(got, want):
        raise AssertionError("masked_mix_scatter b=109: exact inputs differ from the plain "
                             "version")
    idle = ops.masked_mix_scatter(rules, theta, bidx, valid & ~flush, full.clone(), impl="cuda")
    if not torch.equal(idle, full):
        raise AssertionError("masked_mix_scatter b=109: a deposit-only flush moved a row")
    live = torch.nonzero(valid).squeeze(1)
    rows_live = bidx[live].long()
    w_live = rules[live].contiguous()
    scratch = full.clone()
    nl = int(live.numel())
    print(f"  masked_mix_scatter over the {b}-row buffer ({nl} live ids in arrival order, "
          f"sentinel tail): within {err:.3e}, exact inputs bit for bit, deposit-only writes "
          "nothing, deposits as on the CPU")
    return dict(
        source="src/repro_torch/kernels/csrc/masked_mix_scatter.cu",
        replaces="src/repro/kernels/masked_mix_scatter.py:132, "
                 "src/repro/kernels/masked_gather_mix_scatter.py:167", max_abs_err=err,
        ms=time_ms(lambda: ops.masked_mix_scatter(rules, theta, bidx, valid, scratch,
                                                  impl="cuda"), dev),
        read_ms=time_ms(lambda: ops.masked_mix_scatter(rules, theta, bidx, valid, scratch,
                                                       impl="cuda"), dev, flush="read"),
        plain_ms=time_ms(lambda: ref.masked_mix_scatter(rules, theta, bidx, valid, full), dev),
        library_ms=time_ms(lambda: scratch.index_copy_(0, rows_live, w_live @ theta), dev),
        work=roofline.masked_mix_scatter_work(nl, d_al, nl))


def check_scatter_unsorted(name, w, theta, idx, mask, full):
    """masked_mix_scatter into a copy of ``full`` against the plain version
    with live ids in any order: within 1e-5 of the largest output, and no
    row outside the live ids moved. Returns the largest error."""
    want = ref.masked_mix_scatter(w, theta, idx, mask, full)
    got = ops.masked_mix_scatter(w, theta, idx, mask, full.clone(), impl="cuda")
    err = check(name, got, want, 1e-5 * float(want.abs().max()))
    outside = torch.ones(full.shape[0], dtype=torch.bool, device=full.device)
    outside[idx[mask].long()] = False
    if not torch.equal(got[outside], full[outside]):
        raise AssertionError(f"{name}: a row outside the live ids moved")
    return err


def flash_inputs(b, hq, hkv, sq, sk, dh, dtype, dev, seed=0):
    """q, k, v as the model passes them: ``.transpose(1, 2)`` views of
    (B, S, H, Dh) tensors, k and v a prefix of a longer cache."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(s, h):
        return torch.randn(b, s, h, dh, generator=gen, device=dev).to(dtype)

    q = draw(sq, hq).transpose(1, 2)
    k = draw(sk + 7, hkv)[:, :sk].transpose(1, 2)
    v = draw(sk + 7, hkv)[:, :sk].transpose(1, 2)
    return q, k, v


def flash_call(q, k, v, **kw):
    """ops.flash_attention on the card; returns (out, the route whose
    counter rose): each call launches exactly one of the three kernels."""
    before = {r: c.launches for r, c in FLASH_ROUTES.items()}
    out = ops.flash_attention(q, k, v, impl="cuda", **kw)
    rose = {r: c.launches - before[r] for r, c in FLASH_ROUTES.items()}
    took = [r for r, n in rose.items() if n]
    if len(took) != 1 or rose[took[0]] != 1 or took[0] != flash_route(q, k, v):
        raise AssertionError(f"flash_attention: launches {rose}, flash_route says "
                             f"{flash_route(q, k, v)}")
    return out, took[0]


def fma_direct(q, k, v):
    """The FMA kernel, unmasked, on inputs that flash_route sends elsewhere
    (the decode kernel's comparison with the kernel decode took before)."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(x for t in (q, k, v, out) for x in t.stride()[:3]))
    FLASH_FMA(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              ctypes.cast(strides, ctypes.c_void_p), 0 if q.dtype == torch.float32 else 1,
              b, hq, hkv, sq, sk, dh, 0, 0, 0.0, dh ** -0.5)
    return out


def check_each(name, got, want):
    """bf16, element by element: |got - want| <= 2^-7 |want| + 2^-7 of the
    median |want|. Both sides compute in f32 and round once, so an element
    may land one bf16 step away (at most 2^-7 of its magnitude); the
    floor covers outputs near 0, where f32 sums in another order can
    exceed a step of the value. Returns the largest |got - want| over its
    allowance (at most 1)."""
    g, w = got.float(), want.float()
    allowed = 2.0 ** -7 * (w.abs() + float(w.abs().median()))
    worst = float(((g - w).abs() / allowed).max())
    if not worst <= 1.0:
        raise AssertionError(f"{name}: an element is {worst:.2f}x its allowance of one bf16 "
                             "step of itself plus 2^-7 of the median output")
    return worst


def mean_err(got, want):
    return float((got.float() - want.float()).abs().mean())


def flash_work(case, dtype):
    """``roofline.flash_attention_work`` of a case: q, k, v read once, out
    written once, the FLOP of the (row, col) pairs the mask keeps (top-left
    causal keeps col <= row) at the dtype's peak."""
    b, hq, hkv, sq, sk, dh, causal, _, _ = case
    size = torch.tensor([], dtype=dtype).element_size()
    return roofline.flash_attention_work(b, hq, hkv, sq, sk, dh, causal, size)


def decode_splits_of(case, dev):
    b, hq, hkv, _, sk = case[:5]
    return flash.decode_splits(flash.decode_blocks(b, hq, hkv), sk, flash._sm_count(dev.index))


def flash_rows(dev):
    """flash_attention against its plain version on every FLASH_CASES
    shape, f32 and bf16, each case printing the kernel it took, then timed
    at qwen2-7b's prefill (the tensor-core tile) and decode (the decode
    kernel) shapes in bf16 and at the reduced f32 prefill (the FMA kernel).
    Tolerance: f32 atol 2e-5 (averages of unit-scale v, sums in another
    order); bf16 two bf16 steps of the largest output (2^-6 of it), and
    element by element one step of each output (``check_each``): both
    sides compute in f32 from the same inputs and round once. At the
    prefill case the tile must also keep within one bf16 step of the
    largest output (2^-7 of it). On the tile's cases the control is the
    plain version with P rounded to bf16 before P·V (a tile without the lo
    half of the split): the tile's mean error must stay at most half the
    control's, since with P at 16 bits it differs from the plain version
    only where an output's rounding flips. Every decode (Sq = 1) with
    Dh % 8 == 0 must take the decode kernel, and strided views must give
    the bits of contiguous inputs on every kernel (the decode kernel's
    splits merge in a fixed order)."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_CASES:
            b, hq, hkv, sq, sk, dh, causal, window, cap = case
            q, k, v = flash_inputs(b, hq, hkv, sq, sk, dh, dtype, dev, seed=sq + sk + dh)
            kw = dict(causal=causal, window=window, softcap=cap)
            want = ref.flash_attention(q, k, v, **kw)
            got, route = flash_call(q, k, v, **kw)
            if sq == 1 and (route == "decode") != (dh % 8 == 0):
                raise AssertionError(f"flash_attention {case} {dtype}: a decode took {route}")
            largest = float(want.float().abs().max())
            tol = 2e-5 if dtype == torch.float32 else largest * 2.0 ** -6
            errs[case, dtype] = err = check(f"flash_attention {case} {dtype}", got, want, tol)
            flat, flat_route = flash_call(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
            if flat_route != route or not torch.equal(flat, got):
                raise AssertionError(f"flash_attention {case} {dtype}: strided views and "
                                     "contiguous inputs differ")
            extra = f", {decode_splits_of(case, dev)} splits" if route == "decode" else ""
            if dtype == torch.bfloat16:
                worst = check_each(f"flash_attention {case} bf16", got, want)
                extra += f", element/allowance {worst:.2f}"
                if route == "tc":
                    control = ref.flash_attention(q, k, v, probs_dtype=torch.bfloat16, **kw)
                    mine, theirs = mean_err(got, want), mean_err(control, want)
                    if not mine <= 0.5 * theirs:
                        raise AssertionError(f"flash_attention {case} bf16: mean error {mine:.3e} "
                                             f"is over half the bf16-P control's {theirs:.3e}")
                    extra += f", mean err {mine:.3e} (bf16-P control {theirs:.3e})"
            print(f"  flash {case} {str(dtype)[6:]}: {route}, max_abs_err {err:.3e} "
                  f"(largest |out| {largest:.3f}){extra}")
            if case == FLASH_CASES[0] and dtype == torch.bfloat16:
                if route != "tc" or not err <= largest * 2.0 ** -7:
                    raise AssertionError(f"flash prefill: {route} error {err:.3e} is more than "
                                         f"one bf16 step (2^-7 of {largest:.3f})")
    # a q that starts one element into its buffer is not 16-byte aligned
    q, k, v = flash_inputs(2, 4, 2, 64, 64, 64, torch.bfloat16, dev, seed=5)
    odd = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(2, 64, 4, 64)
    odd.copy_(q.transpose(1, 2))
    got, route = flash_call(odd.transpose(1, 2), k, v)
    want = ref.flash_attention(q, k, v)
    err = check("flash_attention odd offset", got, want,
                float(want.float().abs().max()) * 2.0 ** -6)
    check_each("flash_attention odd offset", got, want)
    if route != "fma":
        raise AssertionError(f"flash_attention odd offset took {route}")
    print(f"  flash odd-offset q (2, 4, 64, 64) bfloat16: {route}, max_abs_err {err:.3e}")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    bf16 = torch.bfloat16
    for name, case, dtype, route in (
            ("flash_attention_prefill", FLASH_CASES[0], bf16, "tc"),
            ("flash_attention_decode", FLASH_CASES[1], bf16, "decode"),
            ("flash_attention_fma", FMA_CASE, torch.float32, "fma"),
            ("flash_attention_prefill_mixtral", MIXTRAL_PREFILL, bf16, "tc"),
            ("flash_attention_decode_mixtral", MIXTRAL_DECODE, bf16, "decode"),
            ("flash_attention_prefill_zamba2", ZAMBA2_PREFILL, bf16, "tc"),
            ("flash_attention_decode_zamba2", ZAMBA2_DECODE, bf16, "decode"),
            ("flash_attention_prefill_whisper_encoder", WHISPER_ENCODER, bf16, "tc"),
            ("flash_attention_prefill_whisper_self", WHISPER_SELF, bf16, "tc"),
            ("flash_attention_prefill_whisper_cross", WHISPER_CROSS, bf16, "tc"),
            ("flash_attention_decode_whisper_self", WHISPER_DECODE_SELF, bf16, "decode"),
            ("flash_attention_decode_whisper_cross", WHISPER_DECODE_CROSS, bf16, "decode"),
            ("flash_attention_prefill_internvl2", INTERNVL2_PREFILL, bf16, "tc"),
            ("flash_attention_decode_internvl2", INTERNVL2_DECODE, bf16, "decode"),
            ("flash_attention_prefill_gemma2", GEMMA2_PREFILL, bf16, "tc"),
            ("flash_attention_prefill_gemma2_window", GEMMA2_PREFILL_WINDOW, bf16, "tc"),
            ("flash_attention_decode_gemma2", GEMMA2_DECODE, bf16, "decode"),
            ("flash_attention_prefill_phi3", PHI3_PREFILL, bf16, "tc"),
            ("flash_attention_decode_phi3", PHI3_DECODE, bf16, "decode")):
        b, hq, hkv, sq, sk, dh, causal, window, cap = case
        q, k, v = flash_inputs(b, hq, hkv, sq, sk, dh, dtype, dev)
        kw = dict(causal=causal, window=window, softcap=cap)
        got, took = flash_call(q, k, v, **kw)
        if took != route:
            raise AssertionError(f"{name}: {case} {dtype} took {took}, not {route}")
        err = errs.get((case, dtype))
        if err is None:  # the FMA row's shape is not in the sweep
            err = check(name, got, ref.flash_attention(q, k, v, **kw), 2e-5)
        library = sdpa_library(name, q, k, v, **kw)
        rows[name] = dict(
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:88", max_abs_err=err,
            ms=time_ms(lambda q=q, k=k, v=v, kw=kw: ops.flash_attention(
                q, k, v, impl="cuda", **kw), dev),
            plain_ms=time_ms(lambda q=q, k=k, v=v, kw=kw: ref.flash_attention(q, k, v, **kw),
                             dev),
            library_ms=None if library is None else time_ms(library, dev),
            work=flash_work(case, dtype))
        if library is None:
            rows[name]["library_none"] = "SDPA takes no softcap"
        if route == "decode":
            rows[name]["route_detail"] = f"{decode_splits_of(case, dev)} splits"
    rows["flash_attention_decode"]["long"] = decode_long(dev, sdpa)
    rows["flash_attention_decode"]["host"] = decode_host(dev)
    return rows


def sdpa_library(name, q, k, v, *, causal, window, softcap):
    """One ``scaled_dot_product_attention`` call that computes
    flash_attention's function on (q, k, v), as a closure, or None under
    a softcap (SDPA takes none): ``is_causal`` for the top-left causal
    mask where the window cuts nothing (window >= Sq), else a boolean
    causal-and-window ``attn_mask`` (True: attend) built outside the
    call. Its output is held against the plain version within 2^-6 of
    the largest output (bf16) or 1e-4 (f32): a wrong mask moves whole
    rows."""
    if softcap is not None:
        return None
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sq, sk = q.shape[2], k.shape[2]
    if window is None or window >= sq:
        def call():
            return sdpa(q, k, v, is_causal=causal, enable_gqa=True)
    else:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        mask = cols > rows - window
        if causal:
            mask &= cols <= rows
        def call():
            return sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
    with torch.no_grad():
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        tol = 1e-4 if q.dtype == torch.float32 else 2.0 ** -6 * float(want.float().abs().max())
        check(f"{name}: SDPA against the plain version", call(), want, tol)
    return call


def decode_long(dev, sdpa):
    """qwen2-7b's decode over 4,096 keys in bf16: the decode kernel, the
    FMA kernel (which took decode before it) and SDPA, beside the bound."""
    case = (4, 28, 4, 1, 4096, 128, False, None, None)
    q, k, v = flash_inputs(*case[:6], torch.bfloat16, dev)
    dec = ops.flash_attention(q, k, v, causal=False, impl="cuda")
    check_each("flash decode over 4,096 keys, the FMA kernel against the decode kernel",
               fma_direct(q, k, v), dec)
    work = flash_work(case, torch.bfloat16)
    out = dict(ms=time_ms(lambda: ops.flash_attention(q, k, v, causal=False, impl="cuda"), dev),
               fma_ms=time_ms(lambda: fma_direct(q, k, v), dev),
               library_ms=time_ms(lambda: sdpa(q, k, v, enable_gqa=True), dev),
               splits=decode_splits_of(case, dev))
    out["bound_ms"], out["bound_by"] = work.bound()
    print(f"  flash decode (4, 28, 1, 128) over 4,096 keys, bf16, {out['splits']} splits: decode "
          f"kernel {out['ms']:.4f} ms, FMA kernel {out['fma_ms']:.4f} ms, SDPA "
          f"{out['library_ms']:.4f} ms, bound {out['bound_ms']:.5f} ms ({out['bound_by']}, "
          f"{work.bytes / 1e6:.1f} MB)")
    return out


def decode_host(dev, calls=200, turns=41):
    """The host's cost per call of the decode route and of the FMA route at
    qwen2-7b's decode shape (the FMA route by a q one element off 16-byte
    alignment): ``calls`` enqueues with no sync inside one device sleep, in
    ``turns`` turns of both routes (the host's speed drifts between turns),
    each route first in every other turn; the median of each route and of
    the turns' differences, which must be at most HOST_GATE_US. Then 28
    decode calls (one step's layers) must make no synchronizing CUDA call,
    raise the decode counter by 28 and no other, and a profile of them must
    show exactly 28 kernels, all the decode kernel."""
    q, k, v = flash_inputs(4, 28, 4, 1, 160, 128, torch.bfloat16, dev)
    odd = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)[1:].view(4, 1, 28, 128)
    odd.copy_(q.transpose(1, 2))
    routes = {"decode": q, "fma": odd.transpose(1, 2)}
    per_call = {name: [] for name in routes}
    for turn in range(turns):
        for name in ("decode", "fma") if turn % 2 == 0 else ("fma", "decode"):
            qq = routes[name]
            if flash_call(qq, k, v, causal=False)[1] != name:
                raise AssertionError(f"decode host cost: the {name} input took another route")
            torch.cuda.synchronize(dev)
            torch.cuda._sleep(100_000_000)  # ~0.05 s: the card waits while the host enqueues
            t = time.perf_counter()
            for _ in range(calls):
                ops.flash_attention(qq, k, v, causal=False, impl="cuda")
            per_call[name].append((time.perf_counter() - t) / calls * 1e6)
            torch.cuda.synchronize(dev)
    host = {f"{name}_us": statistics.median(ts) for name, ts in per_call.items()}
    host["diff_us"] = statistics.median(d - f for d, f in zip(per_call["decode"], per_call["fma"]))
    host["turns_us"] = per_call
    print(f"  flash decode host cost per call (medians of {turns} turns of {calls}, "
          f"order alternating): "
          f"decode route {host['decode_us']:.2f} us, FMA route {host['fma_us']:.2f} us, "
          f"difference {host['diff_us']:+.2f} us (turns {min(per_call['decode']):.1f}-"
          f"{max(per_call['decode']):.1f} and {min(per_call['fma']):.1f}-"
          f"{max(per_call['fma']):.1f} us)")
    if host["diff_us"] > HOST_GATE_US:
        raise AssertionError(f"decode route: {host['diff_us']:+.2f} us a call over the FMA route's "
                             f"host cost, past the {HOST_GATE_US} us gate")

    def step():
        for _ in range(28):
            ops.flash_attention(q, k, v, causal=False, impl="cuda")
    torch.cuda.synchronize(dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sorted({str(w.message).splitlines()[0] for w in caught
                    if "called a synchronizing" in str(w.message)})
    if syncs:
        raise AssertionError(f"decode route: 28 calls synchronized with the card: {syncs}")
    # a process's first traced session started the tracer and missed one of
    # the 28 kernels on the H100 once: trace a step untimed first
    profile(step, dev)
    before = {r: c.launches for r, c in FLASH_ROUTES.items()}
    kernels = profile(step, dev)["top"]
    rose = {r: c.launches - before[r] for r, c in FLASH_ROUTES.items()}
    if rose != {"tc": 0, "decode": 28, "fma": 0}:
        raise AssertionError(f"decode route: 28 calls moved the counters by {rose}")
    if len(kernels) != 1 or kernels[0]["calls"] != 28 or "flash_decode" not in kernels[0]["kernel"]:
        raise AssertionError(f"decode route: 28 calls ran {kernels}, not 28 decode kernels")
    print("  flash decode step: 28 calls, no sync, 28 decode kernels traced")
    return host


def agree_phase(dev):
    """Algorithm 1 at a small size: kernels on the card vs plain on the CPU."""
    t0 = time.perf_counter()
    kw = dict(m=8, n=80, n_test=20, num_classes=6, hw=(16, 16))
    cpu_data = synthetic.covariate_label_shift(SEED, device="cpu", **kw)
    gpu_data = synthetic.FederatedData(*(a.to(dev) for a in cpu_data))
    p0 = lenet.init(torch.Generator().manual_seed(SEED), input_hw=(16, 16), num_classes=6,
                    device="cpu")
    cfg = FedConfig(batch_size=20)
    # both sides start K-means from the same seeds, drawn from the CPU's W
    w_host = ucfl.compute_collaboration(lenet.apply_stacked, p0, cpu_data,
                                        var_batch_size=20)["W"]
    for ns in (None, 4):
        host = ucfl.make_ucfl(lenet.apply_stacked, p0, cfg, num_streams=ns,
                              var_batch_size=20, device="cpu")
        card = ucfl.make_ucfl(lenet.apply_stacked, p0, cfg, num_streams=ns,
                              var_batch_size=20, device=dev)
        seeds = None if ns is None else clustering._plusplus_init(
            torch.Generator().manual_seed(2), w_host, ns)
        hs = host.init(None, cpu_data, kmeans_init=seeds)
        cs = card.init(None, gpu_data, kmeans_init=None if seeds is None else seeds.to(dev))
        w_err = float((cs["W"].cpu() - hs["W"]).abs().max())
        if w_err > 1e-4:
            raise AssertionError(f"agree ns={ns}: W differs by {w_err:.3e}")
        if ns is not None and not torch.equal(cs["labels"].cpu(), hs["labels"]):
            raise AssertionError(f"agree ns={ns}: cluster labels differ")
        for r in range(2):
            perms = loader.draw_permutations(torch.Generator().manual_seed(10 + r), 8, 1, 80,
                                             device="cpu")
            hs, _ = host.round(hs, cpu_data, None, perms=perms)
            cs, _ = card.round(cs, gpu_data, None, perms=perms.to(dev))
        p_err = float((cs["params"].cpu() - hs["params"]).abs().max())
        if not p_err <= 1e-4:
            raise AssertionError(f"agree ns={ns}: params differ by {p_err:.3e}")
        # two cohort rounds: three members and two pad slots, then a uniform 4 of 8
        cohorts = [participation.pad_slots(participation.as_cohort([1, 3, 6], 8), 5, 8),
                   participation.sample_cohort(ParticipationConfig(cohort_size=4), 1, 8)]
        for r, cohort in enumerate(cohorts):
            perms = loader.draw_permutations(torch.Generator().manual_seed(20 + r), 8, 1, 80,
                                             device="cpu")
            before = cs["params"].clone()
            hs, hm = host.round(hs, cpu_data, None, cohort, perms=perms)
            cs, cm = card.round(cs, gpu_data, None, cohort, perms=perms.to(dev))
            if hm != cm:
                raise AssertionError(f"agree ns={ns}: cohort metrics {cm} != {hm}")
            outside = [i for i in range(8) if i not in set(cohort.members.tolist())]
            if not torch.equal(cs["params"][outside], before[outside]):
                raise AssertionError(f"agree ns={ns}: a row outside the cohort moved")
        c_err = float((cs["params"].cpu() - hs["params"]).abs().max())
        if not c_err <= 1e-4:
            raise AssertionError(f"agree ns={ns}: params after the cohort rounds differ by "
                                 f"{c_err:.3e}")
        print(f"  ns={ns}: W max_abs_err {w_err:.3e}, params after 2 dense rounds {p_err:.3e}, "
              f"after 2 more cohort rounds {c_err:.3e}")
    phase("agree", t0, "card kernels match the plain CPU path (W atol 1e-4, slab atol 1e-4, "
          "dense and cohort rounds)")


def union_length(intervals):
    """Length of the union of (start, end) intervals: overlapping spans
    (kernels on several streams) count once."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


class EmptyTrace(AssertionError):
    """A profile that traced no device activity; ``launches`` is the kernel
    launches the host made in it."""

    def __init__(self, launches, wall_ms):
        super().__init__(f"profile: no device activity was traced ({launches} kernel launches "
                         f"counted on the host, wall {wall_ms:.3f} ms)")
        self.launches, self.wall_ms = launches, wall_ms


def profile(fn, dev, top=8):
    """Run ``fn`` once under torch.profiler; returns the host wall time, the
    device's busy time (the union of its kernel, copy and set intervals),
    the device's idle share of the wall time, the count of those device
    operations, the kernel launches the host made, the top kernels by
    time, and the device time and count of its copies to the host.

    Annotation ranges that the profiler mirrors onto the device span other
    kernels and the gaps between them, so they are left out. The trace is
    read as the profiler's raw events (its ``kineto_results``): building
    its Python event tree takes about 1 ms a kernel launch, minutes for a
    round of ucfl_parallel. A trace with no device activity raises
    ``EmptyTrace``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize(dev)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t) * 1e3
    spans, launches = [], 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                start = e.start_ns() / 1e3
                spans.append((name, start, start + e.duration_ns() / 1e3))
        # kernel launches counted on the host (the runtime's launch calls),
        # which a trace of the device can miss where it starts
        elif name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            launches += 1
    if not spans:
        raise EmptyTrace(launches, wall_ms)
    busy_ms = union_length([(s, e) for _, s, e in spans]) / 1e3
    if not busy_ms <= wall_ms:
        raise AssertionError(f"profile: device busy {busy_ms:.3f} ms exceeds the wall "
                             f"time {wall_ms:.3f} ms")
    by_name = {}
    for name, s, e in spans:
        ms, calls = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (e - s) / 1e3, calls + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    to_host = [v for k, v in by_name.items() if "DtoH" in k]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "device_ops": len(spans),
            "launches": launches,
            "dtoh_ms": sum(ms for ms, _ in to_host), "dtoh_calls": sum(c for _, c in to_host),
            "top": [{"kernel": k[:90], "ms": ms, "calls": c} for k, (ms, c) in ranked[:top]]}


def full_size_task(dev):
    """Scenario 2 at its defaults, LeNet-5 weights from the seed, and the
    untrained model's average accuracy."""
    t0 = time.perf_counter()
    data = synthetic.covariate_label_shift(SEED, device=dev)  # m=100, n=1000, 47 classes
    torch.cuda.synchronize()
    phase("main", t0, f"data {tuple(data.x.shape)} on {data.x.device}")
    params0 = lenet.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    untrained = float(client.evaluate(lenet.apply_stacked,
                                      {k: v.expand((data.num_clients,) + tuple(v.shape))
                                       for k, v in params0.items()},
                                      data.x_test, data.y_test).mean())
    return data, params0, untrained


def print_profiles(name, prof):
    for what, p in prof.items():
        print(f"  {name} {what}: wall {p['wall_ms']:.2f} ms, device busy "
              f"{p['device_busy_ms']:.2f} ms, idle share {p['idle_share']:.3f}")
        for k in p["top"]:
            print(f"    {k['ms']:9.3f} ms {k['calls']:5d}x  {k['kernel']}")


def main_phase(dev, data, params0, untrained):
    """ucfl and ucfl_k4 on scenario 2 at full width; counts kernel launches."""
    t0 = time.perf_counter()
    launches = {}
    results = {}
    for ns in (None, 4):
        strat = ucfl.make_ucfl(lenet.apply_stacked, params0, FedConfig(), num_streams=ns,
                               var_batch_size=100, device=dev)
        zero_counters()
        t1 = time.perf_counter()
        hist = simulation.run(strat, lenet.apply_stacked, data, SEED, rounds=ROUNDS,
                              device=dev)
        total_s = time.perf_counter() - t1
        launches[strat.name] = {name: c.launches for name, c in COUNTERS.items()}
        state = hist.state
        rowsum = state["W"].sum(dim=1)
        if not (torch.allclose(rowsum, torch.ones_like(rowsum), atol=1e-5)
                and bool((state["W"] >= 0).all())):
            raise AssertionError(f"{strat.name}: W is not row-stochastic")
        if not bool(torch.isfinite(state["params"]).all()):
            raise AssertionError(f"{strat.name}: non-finite params")
        if not hist.avg_acc[-1] > untrained + 0.1:
            raise AssertionError(f"{strat.name}: avg accuracy {hist.avg_acc[-1]:.4f} does not "
                                 f"beat the untrained model's {untrained:.4f}")
        needed = ("gram", "mix_aggregate") + (("kmeans_assign",) if ns else ())
        idle = [k for k in needed if launches[strat.name][k] == 0]
        if idle:
            raise AssertionError(f"{strat.name}: kernels {idle} never launched on the main path")
        check_special_round(strat.name, launches[strat.name], state, params0)
        # one more steady round (on a copy) and, for ucfl, the special round,
        # under the profiler; the counters are read above, so these launches
        # do not count
        pgen = torch.Generator(device=dev)
        pgen.manual_seed(SEED + 1)
        prof = {"round": profile(lambda: strat.round(simulation.clone_state(state), data, pgen),
                                 dev)}
        if ns is None:
            prof["special_round"] = profile(lambda: strat.init(pgen, data), dev)
        print_profiles(strat.name, prof)
        avg, worst = hist.paired_best
        results[strat.name] = dict(
            special_round_s=hist.init_s, round_s=hist.wall_s / ROUNDS, eval_s=hist.eval_s / ROUNDS,
            total_s=total_s, avg_acc=hist.avg_acc[-1], worst_acc=hist.worst_acc[-1],
            paired_best=(avg, worst), streams=state["streams"], launches=launches[strat.name],
            profile=prof)
        print(f"  {strat.name}: special round {hist.init_s:.3f} s, steady round "
              f"{hist.wall_s / ROUNDS:.4f} s, eval {hist.eval_s / ROUNDS:.4f} s/round, "
              f"avg {hist.avg_acc[-1]:.4f} worst {hist.worst_acc[-1]:.4f} "
              f"(untrained {untrained:.4f}), launches {launches[strat.name]}", flush=True)
    phase("main", t0, f"{ROUNDS} rounds each of ucfl and ucfl_k4 at m=100, d=47,571")
    print("main_path " + json.dumps({"runs": results, "untrained_avg_acc": untrained}))
    return launches


def cohort_phase(dev, data, params0, untrained):
    """ucfl and ucfl_k4 at partial participation on the main task; counts
    the cohort kernels' launches."""
    t0 = time.perf_counter()
    m = data.num_clients
    runs = [("ucfl", None, ParticipationConfig(fraction=0.5)),
            ("ucfl_k4", 4, ParticipationConfig(fraction=0.5)),
            ("ucfl_availability", None,
             ParticipationConfig(cohort_size=50, sampler="availability",
                                 availability=participation.diurnal_trace(m)))]
    launches, results = {}, {}
    for name, ns, pcfg in runs:
        strat = ucfl.make_ucfl(lenet.apply_stacked, params0, FedConfig(), num_streams=ns,
                               var_batch_size=100, device=dev)
        zero_counters()
        t1 = time.perf_counter()
        hist = simulation.run(strat, lenet.apply_stacked, data, SEED, rounds=ROUNDS,
                              participation=pcfg, device=dev)
        total_s = time.perf_counter() - t1
        launches[name] = {k: c.launches for k, c in COUNTERS.items()}
        state = hist.state
        ran = sum(not mt.get("skipped", False) for mt in hist.metrics)
        sizes = [mt["cohort_size"] for mt in hist.metrics]
        if not bool(torch.isfinite(state["params"]).all()):
            raise AssertionError(f"{name}: non-finite params")
        if not hist.avg_acc[-1] > untrained + 0.1:
            raise AssertionError(f"{name}: avg accuracy {hist.avg_acc[-1]:.4f} does not beat "
                                 f"the untrained model's {untrained:.4f}")
        got = launches[name]
        # one gather and one mix-scatter per round that ran, plus the warm-up
        if not (got["cohort_gather"] == got["masked_mix_scatter"] == ran + 1
                and got["mix_aggregate"] == 0
                and (ns is None or got["kmeans_assign"] > 0)):
            raise AssertionError(f"{name}: launches {got} over {ran} cohort rounds")
        check_special_round(name, got, state, params0)
        if pcfg.sampler == "availability" and not any(0 < z < 50 for z in sizes):
            raise AssertionError(f"{name}: no round carried pad slots (cohort sizes {sizes})")
        # one more cohort round on a copy, under the profiler: it must leave
        # every row outside its cohort as it was (these launches do not count)
        cohort = next(c for c in participation.cohort_schedule(pcfg, ROUNDS + 24, m)[ROUNDS:]
                      if len(c))
        before = state["params"].clone()
        pgen = torch.Generator(device=dev)
        pgen.manual_seed(SEED + 1)
        out = {}
        prof = {"cohort_round": profile(
            lambda: out.update(state=strat.round(simulation.clone_state(state), data, pgen,
                                                 cohort)[0]), dev)}
        outside = torch.ones(m, dtype=torch.bool, device=dev)
        outside[torch.as_tensor(cohort.members, device=dev).long()] = False
        if not (torch.equal(out["state"]["params"][outside], before[outside])
                and torch.equal(state["params"], before)):
            raise AssertionError(f"{name}: the profiled cohort round moved a row outside "
                                 "its cohort")
        # and one more, unprofiled: queueing it must not wait for the card
        no_sync(name, lambda: strat.round(simulation.clone_state(state), data, pgen, cohort),
                dev)
        print_profiles(name, prof)
        avg, worst = hist.paired_best
        results[name] = dict(
            special_round_s=hist.init_s, round_s=hist.wall_s / ROUNDS,
            eval_s=hist.eval_s / ROUNDS, total_s=total_s, avg_acc=hist.avg_acc[-1],
            worst_acc=hist.worst_acc[-1], paired_best=(avg, worst), cohort_sizes=sizes,
            streams=[mt["streams"] for mt in hist.metrics], launches=got, profile=prof)
        print(f"  {name}: special round {hist.init_s:.3f} s, steady round "
              f"{hist.wall_s / ROUNDS:.4f} s, eval {hist.eval_s / ROUNDS:.4f} s/round, "
              f"avg {hist.avg_acc[-1]:.4f} worst {hist.worst_acc[-1]:.4f} "
              f"(untrained {untrained:.4f}), cohort sizes {sizes}, launches {got}", flush=True)
    phase("cohort", t0, f"{ROUNDS} cohort rounds each of ucfl (fraction 0.5), ucfl_k4 "
          "(fraction 0.5) and ucfl (50-slot availability cohorts) at m=100")
    print("cohort_path " + json.dumps({"runs": results, "untrained_avg_acc": untrained}))
    return launches


def no_sync(name, fn, dev):
    """Run ``fn`` (a cohort round) with ``torch.cuda.set_sync_debug_mode``
    on: it fails if queueing the round made a synchronizing CUDA call."""
    torch.cuda.synchronize(dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sorted({str(w.message).splitlines()[0] for w in caught
                    if "called a synchronizing" in str(w.message)})
    if syncs:
        raise AssertionError(f"{name}: the cohort round synchronized with the card: {syncs}")


def baseline_launches(name, masked):
    """The kernel launches of one round of baseline ``name``: dense, the
    fedavg family's mean (k = 1) or the group rule (k = m), FedFomo's gram
    and mix; a cohort round, one gather for each slab it gathers, then its
    mix (k = 1 over the uploads), the group rule's mix-scatter, or
    FedFomo's gram and mix over its slots; ``local`` mixes nothing."""
    if name == "fedfomo":
        out = {"gram": 1, "mix_aggregate": 1}
    elif name in ("oracle", "cfl") and masked:
        out = {"masked_mix_scatter": 1}
    else:
        out = {} if name == "local" else {"mix_aggregate": 1}
    if masked:
        out["cohort_gather"] = GATHERS.get(name, 1)
    return out


def baselines_phase(dev, data, params0, untrained):
    """The nine baselines at their reference defaults on the main task,
    dense and at fraction 0.5, through ``simulation.run``: each beats the
    untrained model, launches exactly its kernels (a warm-up round and the
    timed rounds), FedFomo's gram copies nothing; one dense round of each
    profiled (for CFL a split round, past its warm-up: its copy of the
    update deltas to the host is read from that profile). Then the gram row
    on FedFomo's trained slab."""
    t0 = time.perf_counter()
    m = data.num_clients
    results, launches, fomo_slab = {}, {}, None
    for name in BASELINES:
        for pcfg in (None, ParticipationConfig(fraction=0.5)):
            cell = name if pcfg is None else f"{name}_half"
            rounds = BASELINE_ROUNDS.get(name, 2)
            strat = REGISTRY[name](lenet.apply_stacked, params0, device=dev)
            zero_counters()
            torch.cuda.reset_peak_memory_stats(dev)
            hist = simulation.run(strat, lenet.apply_stacked, data, SEED, rounds=rounds,
                                  participation=pcfg, device=dev)
            peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
            per_round = baseline_launches(name, pcfg is not None)
            got = read_counters(cell, {k: v * (rounds + 1) for k, v in per_round.items()})
            if GRAM.padded:
                raise AssertionError(f"{cell}: gram made {GRAM.padded} padded copies")
            if not hist.avg_acc[-1] > untrained:
                raise AssertionError(f"{cell}: avg accuracy {hist.avg_acc[-1]:.4f} does not "
                                     f"beat the untrained model's {untrained:.4f}")
            state = hist.state
            slabs = [v for v in state.values() if isinstance(v, torch.Tensor)]
            if not all(bool(torch.isfinite(v).all()) for v in slabs):
                raise AssertionError(f"{cell}: non-finite state")
            launches[cell] = got
            res = dict(strategy=strat.name, rounds=rounds, init_s=hist.init_s,
                       round_s=hist.wall_s / rounds, eval_s=hist.eval_s / rounds,
                       avg_acc=hist.avg_acc[-1], worst_acc=hist.worst_acc[-1],
                       streams=[mt["streams"] for mt in hist.metrics],
                       launches_per_round=per_round, peak_gb=peak_gb)
            if pcfg is None:
                pgen = torch.Generator(device=dev)
                pgen.manual_seed(SEED + 1)
                res["profile"] = profile(
                    lambda: strat.round(simulation.clone_state(state), data, pgen), dev)
                print_profiles(cell, {"round": res["profile"]})
                if name == "fedfomo":
                    fomo_slab = state["params"]
                if name == "cfl":
                    prof = res["profile"]
                    if not prof["dtoh_calls"] >= 1:
                        raise AssertionError("cfl: the profiled split round copied nothing "
                                             "to the host")
                    results["cfl_delta_copy_ms"] = prof["dtoh_ms"]
                    print(f"  cfl: the split round's copy of its {m} update deltas to the host "
                          f"takes {prof['dtoh_ms']:.3f} ms of device time "
                          f"({prof['dtoh_calls']} copies)")
            else:
                sizes = {mt["cohort_size"] for mt in hist.metrics}
                if sizes != {m // 2}:
                    raise AssertionError(f"{cell}: cohort sizes {sizes}, not {m // 2} slots")
            if name == "cfl":
                res["assignment_sizes"] = np.bincount(state["assignment"]).tolist()
            results[cell] = res
            print(f"  {cell}: init {hist.init_s:.3f} s, steady round {res['round_s']:.4f} s over "
                  f"{rounds}, avg {res['avg_acc']:.4f} worst {res['worst_acc']:.4f} (untrained "
                  f"{untrained:.4f}), peak {peak_gb:.2f} GB, launches a round {per_round}",
                  flush=True)
    # gram on a slab after two FedFomo rounds: rows a few steps apart
    row = gram_row("gram_trained", fomo_slab, flat.LayoutTable.build(params0).dim, dev)
    row["delta"] = delta_errors(fomo_slab)
    if not row["delta"]["kernel_err"] <= row["delta"]["f32_err"]:
        raise AssertionError(f"gram_trained: Δ off by {row['delta']['kernel_err']:.3e} against "
                             f"an f64 Gram, g @ g.T in f32 by {row['delta']['f32_err']:.3e}")
    finish_row("gram_trained", row)
    print("gram_trained_delta " + json.dumps(row.pop("delta")))
    phase("baselines", t0, f"the nine baselines at m={m}, d=47,571, dense and at fraction 0.5")
    print("baselines_path " + json.dumps({"runs": results, "untrained_avg_acc": untrained}))
    return launches, row


def wire_strategy(name, params0, dev, kind):
    """``name`` at its reference defaults with ``FedConfig.transport`` of
    ``kind`` (None: the raw wire)."""
    return knob_strategy(name, params0, dev,
                         transport=None if kind is None else TransportConfig(kind))


def wire_launches(name, kind):
    """The kernel launches of one cohort round of ``name`` on the wire
    ``kind``: the raw wire's (``baseline_launches``; ucfl's gather and
    mix-scatter), and under transport one more gather, of the EF slab; full
    ucfl's delta-coded downlink also gathers its ``ef_dl`` rows and mixes
    the cohort rows with mix_aggregate in place of the mix-scatter."""
    if name in ("ucfl", "ucfl_k4"):
        out = {"cohort_gather": 1, "masked_mix_scatter": 1}
        if kind is not None and name == "ucfl":
            out = {"cohort_gather": 2, "mix_aggregate": 1}
    else:
        out = baseline_launches(name, True)
    if kind is not None:
        out["cohort_gather"] += 1
    return out


def stage_inputs(schema, rows, seed, direction="uplink"):
    """(pre, post) CPU rows of a wire slab: post − pre spans four decades
    across its chunks, and each stream's aligned tail is zero."""
    gen = torch.Generator().manual_seed(seed)
    width = schema.width_aligned(direction)
    pre = torch.randn(rows, width, generator=gen)
    decades = torch.logspace(-3, 1, rows * width // 128).repeat_interleave(128)
    post = pre + torch.randn(rows, width, generator=gen) * decades.view(rows, width)
    for s_, (lo, _hi) in zip(schema.streams(direction), schema.slices(direction)):
        pre[:, lo + s_.width:lo + s_.width_aligned] = 0.0
        post[:, lo + s_.width:lo + s_.width_aligned] = 0.0
    return pre, post


def wire_stage_check(dev, d):
    """The wire stage on the card against the same stage on the CPU, bit for
    bit, at a 50-slot cohort's single-stream (50, 47,616) and SCAFFOLD
    (50, 95,232) uplink slabs, int8 and fp8, two calls (the second carries
    the first's EF); a constant delta's 17-round applied sum on the card
    within one quantization step of 17·delta in every stream (int8:
    max|chunk|/127; fp8: the e4m3 step at the chunk's top, 32/448 of
    max|chunk|); and each stage's kernel launches (profiled, counted on
    the host) and time (``time_ms``) at the rounds' shapes (uplink 50 rows; downlink 50 rows
    for ucfl, 1 for a broadcast). Returns {(streams, direction, rows,
    kind): cost}."""
    schemas = {1: transport.single_delta_schema(
                   "fedavg", d, downlink=(transport.Stream("model", d),)),
               2: transport.WireSchema(
                   "scaffold", uplink=(transport.Stream("delta", d),
                                       transport.Stream("control_delta", d)),
                   downlink=(transport.Stream("model", d), transport.Stream("control", d)))}
    profiles = {}
    for (streams, schema), kind in itertools.product(schemas.items(), ("int8", "fp8")):
        cfg = TransportConfig(kind)
        stage = transport.make_wire_stage(schema, cfg, "uplink")
        pre, post = stage_inputs(schema, 50, SEED + streams)
        ef, ef_card = torch.zeros_like(pre), torch.zeros_like(pre, device=dev)
        for call in range(2):
            want, ef = stage(pre, post, ef)
            got, ef_card = stage(pre.to(dev), post.to(dev), ef_card)
            if not (torch.equal(got.cpu(), want) and torch.equal(ef_card.cpu(), ef)):
                raise AssertionError(f"wire stage {kind}, {streams} stream(s), call {call}: the "
                                     "card's bits differ from the CPU's")
        delta = (post - pre).to(dev)
        zero = torch.zeros_like(delta)
        ef_t, total = torch.zeros_like(delta), torch.zeros(delta.shape, dtype=torch.float64,
                                                           device=dev)
        for _ in range(17):
            out, ef_t = stage(zero, delta, ef_t)
            total += out.double()
        per_step = 127.0 if kind == "int8" else 448.0 / 32.0
        for s_, (lo, hi) in zip(schema.uplink, schema.slices("uplink")):
            dd = delta[:, lo:hi].double()
            peak = dd.abs().view(50, -1, 128).amax(dim=2).repeat_interleave(128, dim=1)
            err = (total[:, lo:hi] - 17 * dd).abs()
            if not bool((err <= peak / per_step + 1e-5 * peak).all()):
                raise AssertionError(f"wire stage {kind} stream {s_.name}: the 17-round applied "
                                     f"sum is {float((err / peak).max()):.3e} of max|chunk| "
                                     "from 17·delta, past one quantization step")
        for direction, rows in (("uplink", 50), ("downlink", 50), ("downlink", 1)):
            if direction == "downlink" and rows == 50 and streams == 2:
                continue  # SCAFFOLD's downlink is a broadcast row
            st = transport.make_wire_stage(schema, cfg, direction)
            p_, q_ = (a.to(dev) for a in stage_inputs(schema, rows, SEED, direction))
            e_ = torch.zeros_like(p_)
            call = functools.partial(st, p_, q_, e_)
            call()
            try:
                prof = profile(call, dev)
            except EmptyTrace as e:
                # one full run's trace of a 0.07 ms stage window came back
                # empty; the stage is pure, so its trace is taken once more,
                # and the line says so with what the host launched
                print(f"  wire stage {kind}, {streams} stream(s), {direction} ({rows}): the "
                      f"profile traced no device activity ({e.launches} kernel launches "
                      f"counted on the host, wall {e.wall_ms:.3f} ms); profiling it once more")
                prof = profile(call, dev)
                prof["empty_trace_launches"] = e.launches
            if not prof["launches"] > 0:
                raise AssertionError(f"wire stage {kind}: no kernel launch counted on the host "
                                     f"({prof['device_ops']} device ops traced)")
            cost = {"launches": prof["launches"], "ms": time_ms(call, dev),
                    "busy_ms": prof["device_busy_ms"]}
            if "empty_trace_launches" in prof:
                cost["empty_trace_launches"] = prof["empty_trace_launches"]
            profiles[(streams, direction, rows, kind)] = cost
            print(f"  wire stage {kind}, {streams} stream(s), {direction} ({rows}, "
                  f"{schema.width_aligned(direction)}): {cost['launches']} launches, "
                  f"{cost['ms']:.4f} ms (time_ms), {cost['busy_ms']:.4f} ms busy profiled "
                  f"({prof['device_ops']} device ops traced)")
    print("  wire stage: the card's bits equal the CPU's (int8, fp8; 1 and 2 streams), and "
          "EF telescopes within one step over 17 rounds in every stream")
    return profiles


def stage_cost(strat, profiles, kind):
    """(launches, device ms) of one round's wire stages of ``strat``."""
    schema = strat.wire_schema
    streams = len(schema.uplink)
    up = profiles[(streams, "uplink", 50, kind)]
    ops_, ms = up["launches"], up["ms"]
    down = transport.make_wire_stage(schema, TransportConfig(kind), "downlink")
    if down is not None:
        rows = 50 if schema.strategy == "ucfl" else 1
        dl = profiles[(streams, "downlink", rows, kind)]
        ops_, ms = ops_ + dl["launches"], ms + dl["ms"]
    return ops_, ms


def describe_wire_run(kind, r):
    out = (f"{kind} round {r['round_s']:.4f} s, busy {r['profile']['device_busy_ms']:.2f} ms "
           f"({r['profile']['launches']} launches), avg {r['avg_acc']:.4f} worst "
           f"{r['worst_acc']:.4f}")
    if kind != "raw":
        out += (f", stage {r['stage_launches']} launches {r['stage_ms']:.4f} ms, max|ef| "
                f"{r['max_abs_ef']:.3e}")
        if "max_abs_ef_dl" in r:
            out += f" max|ef_dl| {r['max_abs_ef_dl']:.3e}"
    return out


def transport_phase(dev, data, params0, untrained):
    """The quantized wire on the main task: the stage checks, then ucfl,
    ucfl_k4 and the nine baselines at fraction 0.5 on the raw wire and with
    int8 (ucfl and fedavg also fp8), through ``simulation.run`` from the
    same seeds: exact launches, EF slabs, a profiled cohort round of each,
    accuracies and the bytes a round from ``comm_model``."""
    t0 = time.perf_counter()
    m = data.num_clients
    d = flat.LayoutTable.build(params0).dim
    profiles = wire_stage_check(dev, d)
    pcfg = ParticipationConfig(fraction=0.5)
    int8 = TransportConfig("int8")
    results, launches = {}, {}
    for name in ["ucfl", "ucfl_k4"] + BASELINES:
        rounds = BASELINE_ROUNDS.get(name, 2)
        cohort = next(c for c in participation.cohort_schedule(pcfg, rounds + 24, m)[rounds:]
                      if len(c))
        runs = {}
        for kind in (None, "int8") + (("fp8",) if name in ("ucfl", "fedavg") else ()):
            cell = f"{name}_{kind or 'raw'}"
            strat = wire_strategy(name, params0, dev, kind)
            zero_counters()
            hist = simulation.run(strat, lenet.apply_stacked, data, SEED, rounds=rounds,
                                  participation=pcfg, device=dev)
            expect = {k: v * (rounds + 1) for k, v in wire_launches(name, kind).items()}
            if name in ("ucfl", "ucfl_k4"):
                expect["gram"] = 1  # the special round
                if name == "ucfl_k4":
                    if not ASSIGN.launches:
                        raise AssertionError(f"{cell}: K-means never launched kmeans_assign")
                    expect["kmeans_assign"] = ASSIGN.launches
            got = read_counters(cell, expect)
            if GRAM.padded:
                raise AssertionError(f"{cell}: gram made {GRAM.padded} padded copies")
            state = hist.state
            slabs = [v for v in state.values() if isinstance(v, torch.Tensor)]
            if not all(bool(torch.isfinite(v).all()) for v in slabs):
                raise AssertionError(f"{cell}: non-finite state")
            if not hist.avg_acc[-1] > untrained:
                raise AssertionError(f"{cell}: avg accuracy {hist.avg_acc[-1]:.4f} does not beat "
                                     f"the untrained model's {untrained:.4f}")
            res = dict(strategy=strat.name, rounds=rounds, round_s=hist.wall_s / rounds,
                       avg_acc=hist.avg_acc[-1], worst_acc=hist.worst_acc[-1],
                       launches_per_round=wire_launches(name, kind))
            if kind is not None:
                schema = strat.wire_schema
                want = {"ef": (m, schema.width_aligned("uplink"))}
                if transport.make_wire_stage(schema, TransportConfig(kind), "downlink"):
                    want["ef_dl"] = (m if name == "ucfl" else 1, schema.width_aligned("downlink"))
                if sorted(k for k in state if k.startswith("ef")) != sorted(want):
                    raise AssertionError(f"{cell}: EF slabs {sorted(state)}, want {want}")
                for k, shape in want.items():
                    ef = state[k]
                    if tuple(ef.shape) != shape or not bool(ef.abs().amax() > 0):
                        raise AssertionError(f"{cell}: {k} {tuple(ef.shape)} (want {shape}) "
                                             f"max|{k}| {float(ef.abs().amax()):.3e}")
                    res[f"max_abs_{k}"] = float(ef.abs().amax())
                res["stage_launches"], res["stage_ms"] = stage_cost(strat, profiles, kind)
            pgen = torch.Generator(device=dev)
            pgen.manual_seed(SEED + 1)
            res["profile"] = profile(
                lambda: strat.round(simulation.clone_state(state), data, pgen, cohort), dev)
            launches[cell] = got
            runs[kind or "raw"] = res
        raw, q = runs["raw"], runs["int8"]
        if name in ("ucfl", "ucfl_k4") and not q["avg_acc"] >= raw["avg_acc"] - 0.05:
            raise AssertionError(f"{name}: int8 avg accuracy {q['avg_acc']:.4f} is more than "
                                 f"0.05 below the raw wire's {raw['avg_acc']:.4f}")
        # the bytes a round at c = 50, priced on the strategy's own schema
        schema = strat.wire_schema
        scheme, mb = strat.comm_scheme, 4 * d
        k_streams = strat.num_streams or hist.metrics[-1]["streams"]
        priced = {}
        for tag, tr in (("raw", None), ("int8", int8)):
            priced[f"up_{tag}"] = comm_model.uplink_bytes_per_round(
                mb, scheme, m, m // 2, transport=tr, schema=schema)
            priced[f"down_{tag}"] = comm_model.downlink_bytes_per_round(
                mb, scheme, m, k_streams, m // 2, transport=tr, schema=schema)
        if not priced["up_raw"] >= 3.5 * priced["up_int8"]:
            raise AssertionError(f"{name}: int8 prices {priced['up_int8']} uplink bytes a round "
                                 f"against {priced['up_raw']} raw, under 3.5x fewer")
        results[name] = dict(runs=runs, bytes=priced)
        print(f"  {name}: " + "; ".join(describe_wire_run(k, r) for k, r in runs.items())
              + f"; bytes a round up {priced['up_raw']:,} -> {priced['up_int8']:,}, down "
              f"{priced['down_raw']:,} -> {priced['down_int8']:,}", flush=True)
    phase("transport", t0, f"ucfl, ucfl_k4 and the nine baselines at m={m}, d={d:,}, fraction "
          "0.5, raw wire against int8 (ucfl and fedavg also fp8)")
    print("transport_path " + json.dumps({"runs": results, "untrained_avg_acc": untrained}))
    return launches


# ------------------------------------------------------------------ knobs


def unit_gram_check(dev, ghat):
    """gram on the refresh's slab-wide unit-direction rows (one launch, no
    padded copy) against the plain Gram, within 1e-5 of its largest
    entry; returns the error."""
    padded = GRAM.padded
    got = ops.gram(ghat, impl="cuda")
    want = ref.gram(ghat)
    err = check("gram on unit rows", got, want, 1e-5 * float(want.abs().max()))
    if GRAM.padded != padded:
        raise AssertionError("gram on unit rows: the kernel copied its input to a padded scratch")
    print(f"  gram on the unit-direction rows {tuple(ghat.shape)}: max_abs_err {err:.3e} "
          "(tolerance 1e-5 of the largest entry), no padded copy")
    return err


def holed_scatter_check(dev, m, d_al):
    """masked_mix_scatter with a final mask that has holes mid-cohort (what
    drops, the finite guard, trimmed mean and Krum leave): demoted slots
    carry the sentinel (the reference's contract) or keep their in-range
    client id (the port's pre-stage slots), and W has zero columns there.
    The live rows within 1e-5 of the plain version and bit for bit those
    of the compacted cohort of the live slots; no other row moves."""
    c = m // 2
    real = c * 21 // 25  # 42 of 50 slots at m = 100
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    full = torch.randn(m, d_al, generator=gen, device=dev)
    idx, mask = padded_cohort(gen, dev, m, c, real)
    holes = torch.tensor(sorted({0, 3, real * 2 // 5, real * 5 // 7, real - 1}), device=dev)
    mask = mask.clone()
    mask[holes] = False
    w, theta = scatter_rules(gen, dev, c, real, d_al)
    w = w * mask.float()[None, :]
    w = w / w.sum(dim=1, keepdim=True)
    live = torch.nonzero(mask).squeeze(1)
    for name, index in (("sentinel", torch.where(mask, idx, torch.full_like(idx, m))),
                        ("in-range", idx)):
        want = ref.masked_mix_scatter(w, theta, index, mask, full)
        got = ops.masked_mix_scatter(w, theta, index, mask, full.clone(), impl="cuda")
        err = check(f"masked_mix_scatter holes ({name})", got, want,
                    1e-5 * float(want.abs().max()))
        compact = ops.masked_mix_scatter(w[live][:, live].contiguous(), theta[live].contiguous(),
                                         idx[live], mask[live], full.clone(), impl="cuda")
        if not torch.equal(got, compact):
            raise AssertionError(f"masked_mix_scatter holes ({name}): the live rows are not bit "
                                 "for bit the compacted cohort's")
        moved = torch.ones(m, dtype=torch.bool, device=dev)
        moved[idx[live].long()] = False
        if not torch.equal(got[moved], full[moved]):
            raise AssertionError(f"masked_mix_scatter holes ({name}): a demoted or absent row "
                                 "moved")
    print(f"  masked_mix_scatter, {int(mask.sum())} live of {c} slots with holes mid-cohort: "
          f"within {err:.3e} of the plain version, bit for bit the compacted cohort's, demoted "
          "rows untouched (sentinel and in-range ids)")
    return err


def knobs_agree(dev):
    """The refresh and the upload stage at a small size on the card against
    the plain path on the CPU, from the same data, weights, batch orders and
    fault draws: ucfl with RefreshConfig() over two cohort rounds (slab, W
    and buffers within 1e-4, staleness exact), and one faulted cohort round
    (sign flips and drops, trimmed mean) of ucfl and fedavg (slab within
    1e-4, the same final streams)."""
    kw = dict(m=8, n=80, n_test=20, num_classes=6, hw=(16, 16))
    cpu_data = synthetic.covariate_label_shift(SEED, device="cpu", **kw)
    gpu_data = synthetic.FederatedData(*(a.to(dev) for a in cpu_data))
    p0 = lenet.init(torch.Generator().manual_seed(SEED), input_hw=(16, 16), num_classes=6,
                    device="cpu")
    cohorts = [participation.pad_slots(participation.as_cohort([1, 3, 6], 8), 5, 8),
               participation.pad_slots(participation.as_cohort([0, 2, 3, 5, 7], 8), 6, 8)]
    errs = {}
    runs = [("ucfl_refresh", "ucfl", dict(w_refresh=RefreshConfig())),
            ("ucfl_faults", "ucfl", dict(faults=AGREE_FAULTS, robust=RobustConfig("trimmed_mean"))),
            ("fedavg_faults", "fedavg",
             dict(faults=AGREE_FAULTS, robust=RobustConfig("trimmed_mean")))]
    for cell, name, knobs in runs:
        cfg = FedConfig(batch_size=20, **knobs)
        extra = dict(var_batch_size=20) if name == "ucfl" else {}
        host = REGISTRY[name](lenet.apply_stacked, p0, cfg, device="cpu", **extra)
        card = REGISTRY[name](lenet.apply_stacked, p0, cfg, device=dev, **extra)
        hs, cs = host.init(None, cpu_data), card.init(None, gpu_data)
        worst = 0.0
        for r, cohort in enumerate(cohorts if "refresh" in cell else cohorts[1:]):
            perms = loader.draw_permutations(torch.Generator().manual_seed(30 + r), 8, 1, 80,
                                             device="cpu")
            hs, hm = host.round(hs, cpu_data, None, cohort, perms=perms)
            cs, cm = card.round(cs, gpu_data, None, cohort, perms=perms.to(dev))
            if int(hm["streams"]) != int(cm["streams"]):
                raise AssertionError(f"knobs agree {cell}: streams {cm} != {hm}")
            pairs = [("params", cs["params"], hs["params"])]
            if "refresh" in cs:
                pairs += [("W", cs["W"], hs["W"])] + [
                    (k, cs["refresh"][k], hs["refresh"][k]) for k in ("grads", "sigma_sq",
                                                                      "delta")]
                if not torch.equal(cs["refresh"]["staleness"].cpu(), hs["refresh"]["staleness"]):
                    raise AssertionError(f"knobs agree {cell}: staleness differs")
            for k, got, want in pairs:
                err = float((got.cpu() - want).abs().max())
                if not err <= 1e-4:
                    raise AssertionError(f"knobs agree {cell} round {r + 1}: {k} differs by "
                                         f"{err:.3e}")
                worst = max(worst, err)
        if not all(bool(torch.isfinite(v).all()) for v in (cs["params"],)):
            raise AssertionError(f"knobs agree {cell}: non-finite params")
        errs[cell] = worst
    print(f"  small size, card against the CPU (within 1e-4): {errs}")
    return errs


def stage_cost_at(dev, fcfg, rcfg, d_al, m):
    """The upload stage alone on an m/2-slot (50, 47,616 at m = 100) upload
    slab: its launches (host-counted, one profiled call) and CUDA-event ms."""
    c = real = m // 2
    stage = faults.upload_stage(fcfg, rcfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    pre = torch.randn(c, d_al, generator=gen, device=dev)
    post = pre + 0.01 * torch.randn(c, d_al, generator=gen, device=dev)
    idx, mask = padded_cohort(gen, dev, m, c, real)
    call = functools.partial(stage, pre, post, idx, mask, m, 0)
    call()
    # four calls a trace: the trace of one short call can miss all of its
    # device work where it starts; the launches are counted on the host
    prof = profile(lambda: [call() for _ in range(4)], dev)
    return {"launches": prof["launches"] / 4, "ms": time_ms(call, dev)}


def knob_rows(name, got):
    """A run's kernel launches under the rows of their shapes: FedFomo's
    gram and mix over its 50 slots, the FedAvg family's k = 1 mean over 50
    uploads, and the (100, 47,616) rows of everything else."""
    out = {}
    for kernel, count in got.items():
        if kernel == "gram":
            row = "gram_m50" if name == "fedfomo" else "gram"
        elif kernel == "mix_aggregate":
            row = "mix_aggregate_k50" if name == "fedfomo" else "mix_aggregate_k1_m50"
        else:
            row = kernel
        out[row] = out.get(row, 0) + count
    return out


def knob_strategy(name, params0, dev, **knobs):
    """``name`` at its reference defaults with the ``FedConfig`` knobs;
    ``ucfl_k4`` is ucfl with 4 streams."""
    if name in ("ucfl", "ucfl_k4"):
        return ucfl.make_ucfl(lenet.apply_stacked, params0, FedConfig(**knobs),
                              num_streams=None if name == "ucfl" else 4, var_batch_size=100,
                              device=dev)
    cfg = inspect.signature(REGISTRY[name]).parameters["cfg"].default
    return REGISTRY[name](lenet.apply_stacked, params0, dataclasses.replace(cfg, **knobs),
                          device=dev)


def knob_run(cell, name, strat, data, untrained, pcfg, rounds, per_round, once, rows,
             stage=None, selection=None):
    """``rounds`` rounds of ``strat`` through ``simulation.run`` (with
    ``selection``, if any) after its warm-up, then one more cohort round
    profiled: the accuracy against the untrained model's, exact launches
    (``per_round`` a cohort round that ran, the warm-up's included, and
    ``once`` for the special round; ucfl_k4's K-means iterations as they
    came), and a finite state. ``rows`` None leaves the launches to the
    caller. Returns the run's record, its last state and its history."""
    m = data.num_clients
    zero_counters()
    t = time.perf_counter()
    hist = simulation.run(strat, lenet.apply_stacked, data, SEED, rounds=rounds,
                          participation=pcfg, device=data.x.device, selection=selection)
    pcfg = participation.with_selection(pcfg, selection)
    total_s = time.perf_counter() - t
    ran = sum(not mt.get("skipped", False) for mt in hist.metrics) + 1
    expect = {k: v * ran for k, v in per_round.items()}
    for k, v in once.items():
        expect[k] = expect.get(k, 0) + v
    if name == "ucfl_k4":
        if not ASSIGN.launches:
            raise AssertionError(f"{cell}: K-means never launched kmeans_assign")
        expect["kmeans_assign"] = ASSIGN.launches
    got = read_counters(cell, expect)
    if GRAM.padded:
        raise AssertionError(f"{cell}: gram made {GRAM.padded} padded copies")
    for k, v in (knob_rows(name, got) if rows is not None else {}).items():
        rows[k] = rows.get(k, 0) + v
    state = hist.state
    slabs = [v for v in state.values() if isinstance(v, torch.Tensor)]
    if not all(bool(torch.isfinite(v).all()) for v in slabs):
        raise AssertionError(f"{cell}: non-finite state")
    if not hist.avg_acc[-1] > untrained:
        raise AssertionError(f"{cell}: avg accuracy {hist.avg_acc[-1]:.4f} does not beat the "
                             f"untrained model's {untrained:.4f}")
    cohort = next(c for c in participation.cohort_schedule(pcfg, rounds + 24, m)[rounds:]
                  if len(c))
    pgen = torch.Generator(device=data.x.device)
    pgen.manual_seed(SEED + 1)
    prof = profile(lambda: strat.round(simulation.clone_state(state), data, pgen, cohort),
                   data.x.device)
    res = dict(strategy=strat.name, rounds=rounds, round_s=hist.wall_s / rounds,
               total_s=total_s, avg_acc=hist.avg_acc[-1], worst_acc=hist.worst_acc[-1],
               launches=got, round_launches=prof["launches"],
               round_busy_ms=prof["device_busy_ms"], round_wall_ms=prof["wall_ms"],
               streams=[int(mt["streams"]) for mt in hist.metrics])
    if stage is not None:
        res["stage_launches"], res["stage_ms"] = stage["launches"], stage["ms"]
    return res, state, hist


def refresh_report(state):
    """Staleness and W of a refreshing run's last state."""
    stale = state["refresh"]["staleness"].float()
    w = state["W"]
    rowsum = w.sum(dim=1)
    if not (torch.allclose(rowsum, torch.ones_like(rowsum), atol=1e-5) and bool((w >= 0).all())):
        raise AssertionError("refresh: W is not row-stochastic")
    return dict(staleness_max=int(stale.max()), staleness_mean=float(stale.mean()),
                w_rowsum_err=float((rowsum - 1).abs().max()),
                w_dist_from_special=float((w - state["collab"]["W"]).abs().max()))


def parallel_runs(dev, data, params0, untrained, rows):
    """ucfl_parallel at full width: one dense round, then one round at
    fraction 0.5, without and with the refresh (the dense round never
    refreshes, so it runs once); each round once for its wall and peak
    memory, once more profiled for device busy and host-counted launches."""
    m = data.num_clients
    cohort = participation.sample_cohort(ParticipationConfig(fraction=0.5), 1, m)
    out = {}
    for tag, knobs in (("off", {}), ("refresh", dict(w_refresh=RefreshConfig()))):
        strat = REGISTRY["ucfl_parallel"](lenet.apply_stacked, params0, FedConfig(**knobs),
                                          device=dev)
        zero_counters()
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        state = strat.init(gen, data)
        for kind, c in ((("dense", None),) if tag == "off" else ()) + (("half", cohort),):
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t = time.perf_counter()
            new, met = strat.round(simulation.clone_state(state), data, gen, c)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            if not bool(torch.isfinite(new["params"]).all()) or met["streams"] != m:
                raise AssertionError(f"ucfl_parallel {tag} {kind}: non-finite params or "
                                     f"streams {met['streams']}")
            acc = float(client.evaluate(lenet.apply_stacked, strat.eval_params(new),
                                        data.x_test, data.y_test).mean())
            if not acc > untrained:
                raise AssertionError(f"ucfl_parallel {tag} {kind}: avg accuracy {acc:.4f} does "
                                     f"not beat the untrained model's {untrained:.4f}")
            tp = time.perf_counter()
            prof = profile(lambda: strat.round(simulation.clone_state(state), data, gen, c), dev)
            prof_s = time.perf_counter() - tp
            units = m * (m if c is None else len(c))
            cell = f"ucfl_parallel_{kind}" + ("_refresh" if tag == "refresh" else "")
            out[cell] = dict(wall_s=wall, busy_ms=prof["device_busy_ms"],
                             idle_share=prof["idle_share"], launches=prof["launches"],
                             peak_gb=peak, units=units, avg_acc=acc)
            if tag == "refresh":
                out[cell].update(refresh_report(dict(new, collab={"W": state["W"]})))
            print(f"  {cell}: {units} units in {wall:.3f} s (device busy {prof['device_busy_ms']:.1f}"
                  f" ms profiled, {prof['launches']} launches; the profiled call took "
                  f"{prof_s:.1f} s), peak {peak:.2f} GB, avg {acc:.4f}", flush=True)
        # the special round (and the refresh's unit-row Gram); a cohort_gather
        # of the refresh's round-start rows in each of its two cohort rounds
        expect = {"gram": 1 if tag == "off" else 2,
                  "cohort_gather": 0 if tag == "off" else 2}
        got = read_counters(f"ucfl_parallel_{tag}", expect)
        for k, v in knob_rows("ucfl_parallel", got).items():
            rows[k] = rows.get(k, 0) + v
    return out


def knobs_phase(dev, data, params0, untrained):
    """The engine knobs on the main task: gram on unit rows and the holed
    mix-scatter against their plain versions, the knobs at a small size
    against the CPU, then at m = 100, d = 47,571: ucfl and ucfl_k4 with the
    refresh (fraction 0.5, and availability cohorts with an all-offline
    round), ucfl_parallel, the ten fault-taking strategies under sign flips
    and drops with trimmed mean, and ucfl under each robust rule and under
    NaN uploads with the guard alone."""
    t0 = time.perf_counter()
    m = data.num_clients
    d_al = flat.LayoutTable.build(params0).dim_aligned
    rows, results = {}, {}
    checks = {"holed_scatter_err": holed_scatter_check(dev, m, d_al),
              "agree": knobs_agree(dev)}
    print(f"  kernel checks and the small-size agreement: {time.perf_counter() - t0:.1f} s")
    half = ParticipationConfig(fraction=0.5)
    trace = participation.diurnal_trace(m)
    trace[:, 1] = False  # round 2: nobody is online
    avail = ParticipationConfig(cohort_size=m // 2, sampler="availability", availability=trace)
    one_round = {"cohort_gather": 1, "masked_mix_scatter": 1}

    # the streaming W refresh: its special round's unit rows first
    probe = knob_strategy("ucfl", params0, dev, w_refresh=RefreshConfig())
    zero_counters()
    ghat = probe.init(None, data)["refresh"]["grads"]
    if tuple(ghat.shape) != (m, d_al) or GRAM.launches != 2 or GRAM.padded:
        raise AssertionError(f"refresh init: unit rows {tuple(ghat.shape)}, {GRAM.launches} gram "
                             f"launches and {GRAM.padded} padded copies (want ({m}, {d_al}), 2, 0)")
    checks["unit_gram_err"] = unit_gram_check(dev, ghat)
    del ghat, probe
    for cell, name, pcfg, rounds in (("ucfl_refresh", "ucfl", half, 2),
                                     ("ucfl_k4_refresh", "ucfl_k4", half, 2),
                                     ("ucfl_refresh_availability", "ucfl", avail, 3)):
        strat = knob_strategy(name, params0, dev, w_refresh=RefreshConfig())
        # the special round's gram and the unit rows' Δ̂
        res, state, hist = knob_run(cell, name, strat, data, untrained, pcfg, rounds, one_round,
                                    {"gram": 2}, rows)
        res.update(refresh_report(state))
        if pcfg is avail and not (any(mt.get("skipped") for mt in hist.metrics)
                                  and res["staleness_max"] >= 2):
            raise AssertionError(f"{cell}: no skipped round aged the staleness "
                                 f"({[mt.get('skipped', False) for mt in hist.metrics]}, max "
                                 f"{res['staleness_max']})")
        results[cell] = res
        print(f"  {cell} ({time.perf_counter() - t0:.1f} s): round {res['round_s']:.4f} s, busy "
              f"{res['round_busy_ms']:.2f} ms ({res['round_launches']} launches), avg "
              f"{res['avg_acc']:.4f}, staleness max "
              f"{res['staleness_max']} mean {res['staleness_mean']:.2f}, |W - W0| "
              f"{res['w_dist_from_special']:.3e}", flush=True)
    results.update(parallel_runs(dev, data, params0, untrained, rows))

    # faults and the robust rules
    fcfg = faults.FaultConfig(byzantine_frac=0.1, attack="sign_flip", drop_rate=0.1)
    trimmed = RobustConfig("trimmed_mean", trim_k=5)
    stage = stage_cost_at(dev, fcfg, trimmed, d_al, m)
    for name in ["ucfl"] + BASELINES:
        per_round = one_round if name == "ucfl" else baseline_launches(name, True)
        strat = knob_strategy(name, params0, dev, faults=fcfg, robust=trimmed)
        res, _, _ = knob_run(f"{name}_faults", name, strat, data, untrained, half, 1, per_round,
                             {"gram": 1} if name == "ucfl" else {}, rows, stage)
        results[f"{name}_faults"] = res
        print(f"  {name}_faults ({time.perf_counter() - t0:.1f} s): round {res['round_s']:.4f} s, "
              f"busy {res['round_busy_ms']:.2f} ms "
              f"({res['round_launches']} launches), avg {res['avg_acc']:.4f} worst "
              f"{res['worst_acc']:.4f}, stage {stage['launches']} launches {stage['ms']:.4f} ms",
              flush=True)
    rules = {"trimmed_mean": RobustConfig("trimmed_mean", trim_k=5),
             "median": RobustConfig("median"), "norm_clip": RobustConfig("norm_clip", clip=1.0),
             "krum": RobustConfig("krum", f=5), "multi_krum": RobustConfig("multi_krum", f=5)}
    nan = faults.FaultConfig(byzantine_frac=0.1, attack="nan")
    for tag, knobs in [(r, dict(robust=c)) for r, c in rules.items()] + [("nan", dict(faults=nan))]:
        st = stage_cost_at(dev, knobs.get("faults"), knobs.get("robust"), d_al, m)
        strat = knob_strategy("ucfl", params0, dev, **knobs)
        res, _, _ = knob_run(f"ucfl_{tag}", "ucfl", strat, data, untrained, half, 1, one_round,
                             {"gram": 1}, rows, st)
        results[f"ucfl_{tag}"] = res
        print(f"  ucfl_{tag} ({time.perf_counter() - t0:.1f} s): round {res['round_s']:.4f} s, "
              f"busy {res['round_busy_ms']:.2f} ms "
              f"({res['round_launches']} launches), avg {res['avg_acc']:.4f}, stage "
              f"{st['launches']} launches {st['ms']:.4f} ms", flush=True)
    phase("knobs", t0, f"the refresh, ucfl_parallel, faults and the robust rules at m={m}, "
          f"d={flat.LayoutTable.build(params0).dim:,}")
    print("knobs_path " + json.dumps({"runs": results, "checks": checks,
                                      "untrained_avg_acc": untrained}))
    return rows


def engine_rows(rows, got, ran, shapes):
    """Add a run's launches to the kernel rows of their shapes: ``shapes``
    maps a row to its launches a cohort round (``ran`` rounds, the
    warm-up's included); the special round's gram and K-means launches go
    under their own rows as they came."""
    for row, count in shapes.items():
        rows[row] = rows.get(row, 0) + count * ran
    for kernel in ("gram", "kmeans_assign"):
        rows[kernel] = rows.get(kernel, 0) + got[kernel]


def row_kernel(row):
    """The kernel counter a row's launches count on."""
    return next(k for k in ("mix_aggregate", "masked_mix_scatter", "cohort_gather", "gram",
                            "kmeans_assign") if row.startswith(k))


def engine_cell(cell, name, params0, data, untrained, pcfg, rounds, shapes, rows, *,
                selection=None, sync=False, **knobs):
    """One engine run through :func:`knob_run`, its launches under the rows
    of their shapes; with ``sync``, one more cohort round on a copy must
    make no synchronizing call. Returns its record, last state and history."""
    strat = knob_strategy(name, params0, data.x.device, **knobs)
    per_round = {}
    for row, count in shapes.items():
        per_round[row_kernel(row)] = per_round.get(row_kernel(row), 0) + count
    once = {"gram": 1} if name.startswith("ucfl") else {}
    res, state, hist = knob_run(cell, name, strat, data, untrained, pcfg, rounds, per_round,
                                once, None, selection=selection)
    ran = sum(not mt.get("skipped", False) for mt in hist.metrics) + 1
    engine_rows(rows, res["launches"], ran, shapes)
    if sync:
        pgen = torch.Generator(device=data.x.device)
        pgen.manual_seed(SEED + 2)
        cohort = participation.sample_cohort(participation.with_selection(pcfg, selection),
                                             rounds + 1, data.num_clients)
        no_sync(cell, lambda: strat.round(simulation.clone_state(state), data, pgen, cohort),
                data.x.device)
    return res, state, hist


def async_metrics(hist):
    """The buffered rounds' flush metrics, one dict a round."""
    keys = ("flushed", "applied", "buffer_fill", "tau_max", "tau_mean", "streams")
    return [{k: float(mt[k]) for k in keys} for mt in hist.metrics]


def flush1_check(dev, data, params0):
    """ucfl with ``AsyncConfig(flush_k=1, alpha=0.0)``: two cohort rounds at
    fraction 0.5 bit for bit the barrier rounds from the same state and
    batch orders (at α = 0.5 the second round would differ: a client no
    flush has rewritten since version 0 uploads with τ = 1). Returns the
    launches of the four rounds (one gather and one 50-row mix-scatter
    each)."""
    barrier = knob_strategy("ucfl", params0, dev)
    asy = knob_strategy("ucfl", params0, dev, async_buffer=AsyncConfig(flush_k=1, alpha=0.0))
    zero_counters()
    state = barrier.init(torch.Generator(device=dev).manual_seed(SEED), data)
    sb, sa = simulation.clone_state(state), simulation.clone_state(state)
    m, n = data.y.shape
    for rnd in (1, 2):
        cohort = participation.sample_cohort(ParticipationConfig(fraction=0.5), rnd, m)
        perms = loader.draw_permutations(torch.Generator(device=dev).manual_seed(SEED + rnd), m,
                                         1, n, device=dev)
        sb, mb = barrier.round(sb, data, None, cohort, perms=perms)
        sa, ma = asy.round(sa, data, None, cohort, perms=perms)
        if not (torch.equal(sa["params"], sb["params"]) and int(ma["flushed"]) == 1
                and int(ma["streams"]) == mb["streams"]):
            raise AssertionError(f"flush-1 round {rnd}: the buffered round is not bit for bit "
                                 f"the barrier round (max diff "
                                 f"{float((sa['params'] - sb['params']).abs().max()):.3e})")
    got = read_counters("flush1", {"gram": 1, "cohort_gather": 4, "masked_mix_scatter": 4})
    print("  ucfl flush_k=1 (alpha 0): 2 cohort rounds bit for bit the barrier rounds")
    return got


def engine_phase(dev, data, params0, untrained):
    """The last engine knobs on the main task: the buffered-async server on
    ucfl, ucfl_k4, fedavg and fedprox (4 rounds at fraction 0.5, flush_k
    60: deposit-only and flush rounds), ucfl's flush-1 rounds bit for bit
    the barrier's, the two-tier topology on ucfl_k4, fedavg and fedprox (2
    rounds, within 1e-4 of the flat runs), Pareto selection on ucfl (3
    rounds), and ucfl under the scaled_noise and inf attacks with trimmed
    mean (1 round). Returns the launches under the kernel rows."""
    t0 = time.perf_counter()
    m = data.num_clients
    d_al = flat.LayoutTable.build(params0).dim_aligned
    half = ParticipationConfig(fraction=0.5)
    rows, results = {}, {}

    # buffered-async: B = 109 buffer rows
    for name in ("ucfl", "ucfl_k4", "fedavg", "fedprox"):
        shapes = ({"cohort_gather": 1, "masked_mix_scatter_b109": 1} if name.startswith("ucfl")
                  else {"cohort_gather": 1, "mix_aggregate_k1_b109": 1})
        res, state, hist = engine_cell(f"{name}_async", name, params0, data, untrained, half,
                                       ENGINE_ROUNDS, shapes, rows, sync=True,
                                       async_buffer=ENGINE_ASYNC)
        res["rounds_metrics"] = per = async_metrics(hist)
        flushed = [int(r["flushed"]) for r in per]
        if not (0 in flushed and 1 in flushed):
            raise AssertionError(f"{name}_async: flushes {flushed}, want deposit-only and flush "
                                 "rounds")
        taus = max(r["tau_max"] for r in per)
        if (taus > 0) != name.startswith("ucfl"):
            raise AssertionError(f"{name}_async: tau_max {taus}; ucfl's must be > 0, the FedAvg "
                                 "family's 0")
        if tuple(state["abuf"]["upd"].shape) != (BUFFER_ROWS + 1, d_al):
            raise AssertionError(f"{name}_async: buffer {tuple(state['abuf']['upd'].shape)}")
        results[f"{name}_async"] = res
        print(f"  {name}_async ({time.perf_counter() - t0:.1f} s): round {res['round_s']:.4f} s, "
              f"busy {res['round_busy_ms']:.2f} ms ({res['round_launches']} launches), avg "
              f"{res['avg_acc']:.4f} (untrained {untrained:.4f}), launches {res['launches']}",
              flush=True)
        for r, mt in enumerate(per, start=1):
            print(f"    round {r}: flushed {int(mt['flushed'])} applied {int(mt['applied'])} "
                  f"buffer_fill {int(mt['buffer_fill'])} tau_max {int(mt['tau_max'])} "
                  f"tau_mean {mt['tau_mean']:.3f} streams {int(mt['streams'])}")
    got = flush1_check(dev, data, params0)
    rows["gram"] = rows.get("gram", 0) + got["gram"]
    for k in ("cohort_gather", "masked_mix_scatter"):
        rows[k] = rows.get(k, 0) + got[k]

    # two-tier: four contiguous edges, against the flat runs from the same seeds
    topo = Topology.contiguous(m, EDGES)
    for name in ("ucfl_k4", "fedavg", "fedprox"):
        if name == "ucfl_k4":
            tiered, flat_shapes = {"cohort_gather": 1, "mix_aggregate_k16_m50": 1}, {
                "cohort_gather": 1, "masked_mix_scatter": 1}
        else:
            tiered = {"cohort_gather": 1, "mix_aggregate_k4_m50": 1, "mix_aggregate_k1_m4": 1}
            flat_shapes = {"cohort_gather": 1, "mix_aggregate_k1_m50": 1}
        res, state, _ = engine_cell(f"{name}_tiered", name, params0, data, untrained, half, 2,
                                    tiered, rows, topology=topo)
        flat_res, flat_state, _ = engine_cell(f"{name}_flat", name, params0, data, untrained,
                                              half, 2, flat_shapes, rows)
        diff = float((state["params"] - flat_state["params"]).abs().max())
        if not diff <= 1e-4:
            raise AssertionError(f"{name}_tiered: {diff:.3e} from the flat run (tolerance 1e-4)")
        res["max_abs_diff_from_flat"] = diff
        results[f"{name}_tiered"], results[f"{name}_flat"] = res, flat_res
        print(f"  {name}_tiered ({time.perf_counter() - t0:.1f} s): round {res['round_s']:.4f} s, "
              f"busy {res['round_busy_ms']:.2f} ms ({res['round_launches']} launches), avg "
              f"{res['avg_acc']:.4f}, {diff:.3e} from the flat run (round "
              f"{flat_res['round_s']:.4f} s, busy {flat_res['round_busy_ms']:.2f} ms, "
              f"{flat_res['round_launches']} launches)", flush=True)

    # Pareto selection: every cohort holds the fairness lane's client and no gated one
    rng = np.random.default_rng(SEED)
    sel = participation.SelectionConfig(compute=rng.uniform(0.25, 4.0, m),
                                        link=rng.uniform(0.5, 2.0, m),
                                        battery=participation.battery_trace(m), bias=2.0)
    res, _, hist = engine_cell("ucfl_selection", "ucfl", params0, data, untrained, half, 3,
                               {"cohort_gather": 1, "masked_mix_scatter": 1}, rows, selection=sel)
    static = np.flatnonzero(sel.static_mass(m) > 0)
    cohorts = participation.cohort_schedule(participation.with_selection(half, sel), 3, m)
    lanes = []
    for rnd, co in enumerate(cohorts, start=1):
        up = sel.battery[:, (rnd - 1) % sel.battery.shape[1]]
        lane = int(static[(rnd - 1) % static.size])
        if bool((~up[co.members]).any()) or (up[lane] and lane not in co.members):
            raise AssertionError(f"ucfl_selection round {rnd}: cohort {co.members.tolist()}, "
                                 f"lane {lane} (up {bool(up[lane])})")
        lanes.append(dict(lane=lane, lane_up=bool(up[lane]), size=len(co), up=int(up.sum())))
    if [mt["cohort_size"] for mt in hist.metrics] != [c["size"] for c in lanes]:
        raise AssertionError("ucfl_selection: run drew other cohorts than the pareto sampler")
    res["cohorts"] = lanes
    results["ucfl_selection"] = res
    print(f"  ucfl_selection ({time.perf_counter() - t0:.1f} s): cohorts {lanes}, avg "
          f"{res['avg_acc']:.4f}, busy {res['round_busy_ms']:.2f} ms", flush=True)

    # the two attacks that the knobs phase does not run
    trimmed = RobustConfig("trimmed_mean", trim_k=5)
    for attack in ("scaled_noise", "inf"):
        fcfg = faults.FaultConfig(byzantine_frac=0.1, attack=attack)
        stage = stage_cost_at(dev, fcfg, trimmed, d_al, m)
        res, _, _ = engine_cell(f"ucfl_{attack}", "ucfl", params0, data, untrained, half, 1,
                                {"cohort_gather": 1, "masked_mix_scatter": 1}, rows,
                                faults=fcfg, robust=trimmed)
        res["stage_launches"], res["stage_ms"] = stage["launches"], stage["ms"]
        results[f"ucfl_{attack}"] = res
        print(f"  ucfl_{attack} ({time.perf_counter() - t0:.1f} s): avg {res['avg_acc']:.4f} "
              f"worst {res['worst_acc']:.4f} (untrained {untrained:.4f}), finite, stage "
              f"{stage['launches']} launches {stage['ms']:.4f} ms", flush=True)
    phase("engine", t0, f"the buffered-async server, the two-tier topology, Pareto selection "
          f"and the scaled_noise and inf attacks at m={m}, "
          f"d={flat.LayoutTable.build(params0).dim:,}")
    print("engine_path " + json.dumps({"runs": results, "untrained_avg_acc": untrained}))
    return rows


# ------------------------------------------------------------------ mesh

MESH_SHARDS = (2, 4)
MESH_ROUNDS = 3
MESH_RUNS = ("ucfl", "ucfl_k4", "fedavg", "ditto", "scaffold", "ucfl_async")
MESH_SLABS = ("params", "personal", "c_i", "c")
# the slabs whose rows only a cohort member's round moves
MESH_UNTOUCHED = {"ucfl": ("params",), "ucfl_k4": ("params",), "ditto": ("personal",),
                  "scaffold": ("c_i",)}
MESH_RTOL, MESH_ATOL = 1e-5, 1e-6


def mesh_strategy(name, params0, dev, mesh_knob, shard):
    """``name`` at its reference defaults over ``mesh_knob``; ``ucfl_async``
    is ucfl with the engine phase's buffer."""
    knobs = dict(mesh=mesh_knob, shard_state=shard)
    if name == "ucfl_async":
        return knob_strategy("ucfl", params0, dev, async_buffer=ENGINE_ASYNC, **knobs)
    return knob_strategy(name, params0, dev, **knobs)


def mesh_rounds(strat, data, dev, untouched=()):
    """Init and ``MESH_ROUNDS`` cohort rounds at fraction 0.5, every draw
    from a fixed seed (the same on every rank and without a mesh). Returns
    the state, each round's wall time, and whether the ``untouched`` slabs'
    rows outside the last cohort kept their bits through its round."""
    m = data.num_clients
    state = strat.init(torch.Generator(device=dev).manual_seed(SEED), data)
    walls, kept = [], True
    for rnd in range(1, MESH_ROUNDS + 1):
        cohort = participation.sample_cohort(ParticipationConfig(fraction=0.5), rnd, m)
        gen = torch.Generator(device=dev).manual_seed(SEED + 100 + rnd)
        last = rnd == MESH_ROUNDS
        before = {k: state[k].clone() for k in untouched} if last else {}
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        state, _ = strat.round(state, data, gen, cohort)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t)
        for k, old in before.items():
            rows = mesh_lib.row_mesh(state)
            lo, hi = (0, m) if rows is None else rows.block(m)
            outside = np.setdiff1d(np.arange(lo, hi), cohort.members) - lo
            out = torch.as_tensor(outside, device=dev)
            kept = kept and torch.equal(state[k][out], old[out])
    return state, walls, kept


def mesh_tag(shard):
    """The kernel-row tag of a mesh-phase run's calls: ``block`` for the
    row-sharded runs (the gather and the mix-scatter on a rank's block),
    ``mesh`` for the replicated runs and the runs without a mesh."""
    return "block" if shard else "mesh"


def call_launches(calls):
    """The launches of each kernel counter over a ``recorded_calls`` block."""
    out = {}
    for rec in calls.values():
        for k, n in rec["launches"].items():
            out[k] = out.get(k, 0) + n
    return out


def mesh_rank(rank, ref_path, calls_path, untrained, device, task_kw):
    """One gloo rank of the mesh phase on the card: every run of
    ``MESH_RUNS``, replicated and row-sharded, held against the
    single-process run in ``ref_path`` (rtol 1e-5, atol 1e-6) and against
    each other (bit for bit). Each run's kernel calls are recorded
    (``recorded_calls``); rank 0 saves a copy of each distinct call's
    inputs to ``calls_path``, for the parent to hold against the plain
    version. Returns the rank's report and {tag: {call: launches}}.
    ``task_kw`` sizes scenario 2 (empty: its defaults, m = 100)."""
    dev = torch.device(device)
    cm = mesh_lib.resolve("auto")
    data = synthetic.covariate_label_shift(SEED, device=dev, **task_kw)
    params0 = lenet.init(torch.Generator(device=dev).manual_seed(SEED), device=dev,
                         input_hw=task_kw.get("hw", (28, 28)),
                         num_classes=task_kw.get("num_classes", 47))
    m = data.num_clients
    lo, hi = cm.block(m)
    cohort = participation.sample_cohort(ParticipationConfig(fraction=0.5), 1, m)
    mesh_lib.check_spmd(cm, idx=torch.as_tensor(mesh_lib.pad_cohort(cohort, cm, m).indices),
                        perm=loader.draw_permutations(
                            torch.Generator(device=dev).manual_seed(SEED + 101), 1, 1,
                            data.y.shape[1], device=dev)[0, 0],
                        x_sum=data.x.sum().reshape(1))
    want_all = torch.load(ref_path, map_location=dev)
    ckpt_dir = os.path.dirname(calls_path)
    report, calls = {}, {"mesh": {}, "block": {}}
    mesh_lib.TIMING = True
    for name in MESH_RUNS:
        kept_rep = {}
        for shard in (False, True):
            key = f"{name}_{'sharded' if shard else 'replicated'}"
            strat = mesh_strategy(name, params0, dev, "auto", shard)
            mesh_lib.reset_stats()
            with recorded_calls(copy=rank == 0) as got:
                state, walls, kept = mesh_rounds(strat, data, dev,
                                                 MESH_UNTOUCHED.get(name, ()) if shard else ())
            merge_calls(calls[mesh_tag(shard)], got)
            stats = {k: dict(v) for k, v in mesh_lib.STATS.items()}
            if name == "ucfl":  # the gathered checkpoint: every rank saves a row-sharded state
                if shard or rank == 0:
                    checkpoint.save(f"{ckpt_dir}/ucfl_{'sharded' if shard else 'replicated'}"
                                    ".msgpack", state)
                if shard and rank == 0:
                    files = [open(f"{ckpt_dir}/ucfl_{lay}.msgpack", "rb").read()
                             for lay in ("replicated", "sharded")]
                    if files[0] != files[1]:
                        raise AssertionError(f"mesh s={cm.shards}: the row-sharded ucfl state's "
                                             "checkpoint differs from the replicated one's")
                    report["ucfl_checkpoint_bytes"] = len(files[0])
            if not kept:
                raise AssertionError(f"{key} rank {rank}: a row outside the cohort moved")
            rows = mesh_lib.row_mesh(state)
            if shard and (rows is None or state["params"].shape[0] != m // cm.shards):
                raise AssertionError(f"{key} rank {rank}: params block "
                                     f"{tuple(state['params'].shape)}, want {m // cm.shards} rows")
            diff = 0.0
            for k, want in want_all[name].items():
                got_k = state[k]
                want = want[lo:hi] if shard else want
                if not torch.allclose(got_k, want, rtol=MESH_RTOL, atol=MESH_ATOL):
                    raise AssertionError(f"{key} rank {rank} {k}: "
                                         f"{float((got_k - want).abs().max()):.3e} from the run "
                                         f"without a mesh (rtol {MESH_RTOL}, atol {MESH_ATOL})")
                diff = max(diff, float((got_k - want).abs().max()))
                if shard and not torch.equal(got_k, kept_rep[k]):
                    raise AssertionError(f"{key} rank {rank} {k}: the row-sharded block is not "
                                         "bit for bit the replicated run's rows")
                if not shard:
                    kept_rep[k] = got_k[lo:hi].clone()
            accs = client.evaluate(lenet.apply_stacked, strat.eval_params(state), data.x_test,
                                   data.y_test, mesh=rows if rows is not None else cm)
            avg = float(accs.mean())
            if not avg > untrained:
                raise AssertionError(f"{key}: avg accuracy {avg:.4f} does not beat the untrained "
                                     f"model's {untrained:.4f}")
            pgen = torch.Generator(device=dev).manual_seed(SEED + 1)
            pcohort = participation.sample_cohort(ParticipationConfig(fraction=0.5),
                                                  MESH_ROUNDS + 1, m)
            mesh_lib.TIMING = False
            prof = profile(lambda: strat.round(simulation.clone_state(state), data, pgen,
                                               pcohort), dev)
            mesh_lib.TIMING = True
            report[key] = dict(walls_s=walls, busy_ms=prof["device_busy_ms"],
                               profiled_wall_ms=prof["wall_ms"], host_launches=prof["launches"],
                               launches=call_launches(got), collectives=stats,
                               max_abs_vs_none=diff, rows=int(state["params"].shape[0]),
                               avg_acc=avg)
            del state
    if rank == 0:
        save_rank_calls(calls_path, calls)
    return report, rank_launches(calls)


def merge_rank_calls(into, per_rank, calls_path, dev):
    """Add the spawned ranks' recorded calls to ``into`` ({tag: calls}):
    the inputs rank 0 saved in ``calls_path``, the launches summed over
    the ranks. Every rank must have made the calls rank 0 made, at the
    same shapes and options, so rank 0's inputs hold every launch's
    shape."""
    saved = torch.load(calls_path, map_location=dev)
    for tag, recs in saved.items():
        for rank, (_, launched) in enumerate(per_rank):
            if set(launched[tag]) != set(recs):
                raise AssertionError(f"mesh {tag}: rank {rank} made calls "
                                     f"{sorted(set(launched[tag]) ^ set(recs))} that rank 0 did "
                                     "not, or the reverse")
        calls = {}
        for key, rec in recs.items():
            launches = {}
            for _, launched in per_rank:
                for k, n in launched[tag][key].items():
                    launches[k] = launches.get(k, 0) + n
            calls[key] = dict(rec, launches=launches)
        merge_calls(into[tag], calls)


def mesh_nccl_check(dev, data, params0, calls, backend="nccl"):
    """ucfl and ucfl_k4 over a one-rank NCCL group (``mesh="auto"``), with
    and without ``shard_state``, special round included: each bit for bit
    the run without a mesh. Every run's kernel calls join ``calls`` under
    their tag (``mesh_tag``). Returns the states of the runs without a
    mesh."""
    base = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            for name in ("ucfl", "ucfl_k4"):
                with recorded_calls() as got:
                    base[name], _, _ = mesh_rounds(mesh_strategy(name, params0, dev, None, False),
                                                   data, dev)
                merge_calls(calls[mesh_tag(False)], got)
                for shard in (False, True):
                    mesh_lib.reset_stats()
                    strat = mesh_strategy(name, params0, dev, "auto", shard)
                    with recorded_calls() as got:
                        state, walls, _ = mesh_rounds(strat, data, dev)
                    merge_calls(calls[mesh_tag(shard)], got)
                    same = [k for k in ("params", "W", "labels")
                            if state.get(k) is not None
                            and not torch.equal(state[k], base[name][k])]
                    if same or (shard and mesh_lib.row_mesh(state) is None):
                        raise AssertionError(f"{name} nccl shard_state={shard}: {same} differ "
                                             "from the run without a mesh")
                    stats = {k: (v["calls"], v["bytes"]) for k, v in mesh_lib.STATS.items()}
                    print(f"  {name} one-rank nccl, shard_state={shard}: bit for bit without a "
                          f"mesh; rounds {[f'{w:.4f}' for w in walls]} s, launches "
                          f"{call_launches(got)}, collectives (calls, bytes) {stats}", flush=True)
        finally:
            dist.destroy_process_group()
    return base


def mesh_phase(dev, data, params0, untrained, task_kw=None, backend="nccl"):
    """The client mesh on the card at full width: one-rank NCCL runs bit for
    bit the runs without a mesh, then 2 and 4 gloo ranks sharing the card
    on ucfl, ucfl_k4, fedavg, ditto, scaffold and buffered-async ucfl, each
    replicated and row-sharded. Every run records its kernel calls, and
    each kernel gets two rows (``recorded_rows``): ``<kernel>_block`` for
    the row-sharded runs and ``<kernel>_mesh`` for the replicated runs and
    the runs without a mesh, each shape they gave it held against the
    plain version, the launches of all ranks summed. Returns (launches
    under the kernel rows, the kernel rows). ``task_kw`` sizes the ranks'
    scenario 2 as ``data`` was made (empty: its defaults)."""
    t0 = time.perf_counter()
    m = data.num_clients
    calls = {"mesh": {}, "block": {}}
    base = mesh_nccl_check(dev, data, params0, calls, backend)
    for name in MESH_RUNS:
        if name not in base:
            with recorded_calls() as got:
                base[name], _, _ = mesh_rounds(mesh_strategy(name, params0, dev, None, False),
                                               data, dev)
            merge_calls(calls[mesh_tag(False)], got)
    reports = {}
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = f"{tmp}/none.pt"
        torch.save({n: {k: st[k].cpu() for k in MESH_SLABS if isinstance(st.get(k), torch.Tensor)}
                    for n, st in base.items()}, ref_path)
        del base
        for s in MESH_SHARDS:
            ts = time.perf_counter()
            device = "cuda:0" if dev.type == "cuda" else "cpu"
            calls_path = f"{tmp}/calls{s}.pt"
            per_rank = mesh_lib.spawn(mesh_rank, s, backend="gloo", device=device,
                                      store_path=f"{tmp}/store{s}", timeout=300,
                                      args=(ref_path, calls_path, untrained, device,
                                            task_kw or {}))
            merge_rank_calls(calls, per_rank, calls_path, dev)
            reports[s] = [rep for rep, _ in per_rank]
            ckpt_bytes = reports[s][0].pop("ucfl_checkpoint_bytes")
            print(f"  s = {s}: the row-sharded ucfl state's gathered checkpoint is the "
                  f"replicated one's, byte for byte ({ckpt_bytes:,} bytes)", flush=True)
            print(f"  s = {s} gloo ranks on one card: {time.perf_counter() - ts:.1f} s", flush=True)
    for s, per_rank in reports.items():
        for rank, rep in enumerate(per_rank):
            for key, r in rep.items():
                coll = {k: f"{v['calls']} calls {v['bytes'] / 1e6:.1f} MB {v['ms']:.1f} ms"
                        for k, v in r["collectives"].items()}
                print(f"  s={s} rank {rank} {key}: rounds "
                      f"{[f'{w:.4f}' for w in r['walls_s']]} s, profiled round wall "
                      f"{r['profiled_wall_ms']:.1f} ms busy {r['busy_ms']:.2f} ms "
                      f"({r['host_launches']} launches), launches {r['launches']}, "
                      f"collectives {coll}, {r['rows']} rows, avg {r['avg_acc']:.4f}, "
                      f"{r['max_abs_vs_none']:.3e} from the run without a mesh", flush=True)
    rows, counts = {}, {}
    for tag, tc in calls.items():
        got_rows, got_counts = recorded_rows(tag, tc, dev)
        rows.update(got_rows)
        counts.update(got_counts)
    for need in ("cohort_gather_block", "masked_mix_scatter_block"):
        if need not in rows:
            raise AssertionError(f"mesh: the row-sharded runs launched no {need[:-6]}")
    for name, r in rows.items():
        finish_row(name, r)
    summary = {str(s): {key: dict(
        round_s=[statistics.mean(r[key]["walls_s"]) for r in per_rank],
        busy_ms=[r[key]["busy_ms"] for r in per_rank],
        collective_ms=[sum(v["ms"] for v in r[key]["collectives"].values()) for r in per_rank],
        collective_bytes=[sum(v["bytes"] for v in r[key]["collectives"].values())
                          for r in per_rank],
        launches=per_rank[0][key]["launches"], rows=per_rank[0][key]["rows"],
        avg_acc=per_rank[0][key]["avg_acc"],
        max_abs_vs_none=max(r[key]["max_abs_vs_none"] for r in per_rank))
        for key in per_rank[0]} for s, per_rank in reports.items()}
    print("mesh_path " + json.dumps({"runs": summary, "row_launches": counts}))
    phase("mesh", t0, f"one-rank NCCL bit for bit, {len(MESH_RUNS)} strategies over "
          f"{' and '.join(map(str, MESH_SHARDS))} gloo ranks at m={m}, "
          f"d={flat.LayoutTable.build(params0).dim:,}")
    return counts, rows


@contextlib.contextmanager
def plain_attention():
    """The model's attention calls (``ops.flash_attention``) take the
    plain version, on whatever device their tensors are."""
    kernel = ops.flash_attention
    ops.flash_attention = functools.partial(kernel, impl="ref")
    try:
        yield
    finally:
        ops.flash_attention = kernel


def serve_agree_phase(dev):
    """Reduced qwen2-7b and gemma2-9b in f32, 2 clients x 2 requests: the
    federated prefill step (one FMA kernel launch a layer) and 72
    teacher-forced decode steps (one decode kernel launch a layer; gemma2's
    window-64 cache wraps) on the card, against the plain path on the CPU
    from the same weights. Logits atol 1e-4 (values up to ~5; f32 sums in
    another order). Then bf16 (which the f32 run never routes to the
    tensor-core tile): the prefill step over 96 tokens through the tile
    (``bf16_prefill_agree``) and 72 decode steps through the decode kernel
    (``bf16_decode_agree``), each against the same steps with the plain
    attention on the card. Returns the FMA kernel's launches here, its
    main path since decode left it."""
    t0 = time.perf_counter()
    fma_launches = 0
    for arch in ("qwen2-7b", "gemma2-9b"):
        cfg = configs.get(arch).reduced()
        host = serve_lib.personalized_params(cfg, 2, SEED, "cpu")
        card = transformer.tree_map(lambda x: x.to(dev), host)
        tok = torch.randint(0, cfg.vocab_size, (2, 2, 72),
                            generator=torch.Generator().manual_seed(SEED + 1))
        prefill = steps.build_prefill_step(cfg, federated=True)
        hl, hc = prefill(host, {"tokens": tok[:, :, :40]})
        zero_counters()
        cl, cc = prefill(card, {"tokens": tok[:, :, :40].to(dev)})
        got = read_counters(f"serve-agree {arch} f32 prefill",
                            {"flash_attention_fma": cfg.num_layers})
        fma_launches += got["flash_attention_fma"]
        errs = [check(f"serve-agree {arch} prefill", cl, hl.to(dev), 1e-4)]
        check(f"serve-agree {arch} prefill k cache", cc["blocks"]["l0"]["k"],
              hc["blocks"]["l0"]["k"].to(dev), 1e-4)
        step = steps.build_serve_step(cfg, federated=True)
        hcache = transformer.init_cache(cfg, 2, 2, 80, "cpu")
        ccache = transformer.init_cache(cfg, 2, 2, 80, dev)
        zero_counters()
        for pos in range(72):
            hl, hcache = step(host, hcache, tok[:, :, pos:pos + 1], pos)
            cl, ccache = step(card, ccache, tok[:, :, pos:pos + 1].to(dev), pos)
            errs.append(check(f"serve-agree {arch} decode step {pos}", cl, hl.to(dev), 1e-4))
        read_counters(f"serve-agree {arch} f32 decode",
                      {"flash_attention_decode": 72 * cfg.num_layers})
        print(f"  {cfg.name}: prefill logits max_abs_err {errs[0]:.3e} (FMA kernel), decode "
              f"steps {max(errs[1:]):.3e} (decode kernel, {72 * cfg.num_layers} launches; "
              f"largest |logit| {float(hl.abs().max()):.2f})")
    for arch in ("qwen2-7b", "gemma2-9b"):
        cfg = configs.get(arch).reduced(param_dtype="bfloat16", act_dtype="bfloat16")
        bf16_prefill_agree(dev, cfg)
        bf16_decode_agree(dev, cfg)
    phase("serve-agree", t0, "reduced qwen2-7b and gemma2-9b serve on the card as on the CPU "
          "(f32, logits atol 1e-4, 72 decode steps); in bf16 the tile's prefill step and the "
          "decode kernel's 72 decode steps match the plain attention's")
    return fma_launches


class PinnedRouting:
    """The MoE layers' expert choices of one run, replayed in another.

    A bf16 attention output one step off flips a token's top-k where two of
    its router probabilities are within that step, and through the
    capacity a flip also moves which later assignment drops: an MoE
    model's bf16 runs with the kernel and with the plain attention then
    differ by a whole expert's output, not by rounding. So the kernel run
    records each layer's choices (``record``) and the plain run takes
    them (``replay``: its own router probabilities, renormalized over the
    recorded experts), and ``flips`` counts the tokens whose own top-k
    differed. A model without MoE layers passes through unchanged."""

    def __init__(self):
        self.ids, self.flips, self.tokens = [], 0, 0

    @contextlib.contextmanager
    def run(self, mode):
        from repro_torch.models import moe

        real = moe._route
        recorded = iter(list(self.ids))

        def route(router, xt, mcfg):
            probs, top_w, top_ids = real(router, xt, mcfg)
            if mode == "record":
                self.ids.append(top_ids)
                return probs, top_w, top_ids
            ids = next(recorded)
            self.flips += int((ids != top_ids).any(-1).sum())
            self.tokens += ids.shape[0] * ids.shape[1]
            w = probs.gather(-1, ids)
            return probs, w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), ids
        moe._route = route
        try:
            yield
        finally:
            moe._route = real

    def report(self):
        return (f"; MoE routing pinned to the kernel run's, {self.flips} of {self.tokens} "
                "token routings of the plain run would have differed" if self.tokens else "")


def family_inputs(cfg, tokens, seed):
    """A forward's inputs: ``tokens`` (m, B, S), and whisper's stub frames
    (m, B, T_enc, D) or the VLM's patch embeddings (m, B, P, P_in),
    N(0, 1) from ``seed`` in the activation dtype, on the tokens' device."""
    out = {"tokens": tokens}
    lead = tuple(tokens.shape[:2])
    if cfg.family == "audio":
        key, shape = "frames", lead + (cfg.encoder_seq, cfg.d_model)
    elif cfg.family == "vlm":
        key, shape = "patch_embeds", lead + (cfg.num_patches, cfg.patch_embed_dim)
    else:
        return out
    extra = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    out[key] = extra.to(device=tokens.device, dtype=cfg.act_tdtype)
    return out


def prompt_positions(cfg, seq):
    """The positions a prefill of ``seq`` tokens fills: the VLM's patches
    come first; whisper's frames are the encoder's, not the decoder's."""
    return seq + (cfg.num_patches if cfg.family == "vlm" else 0)


def family_cache(cfg, params, inputs, clients, batch, max_len, dev):
    """The family's empty decode caches; whisper's with each decoder
    layer's cross K/V of the encoder's output on ``inputs["frames"]``
    (``init_cache(enc_out=, params=)``)."""
    if cfg.family != "audio":
        return registry.module(cfg).init_cache(cfg, clients, batch, max_len, dev)
    enc = whisper.encode(params, inputs["frames"], cfg)
    return whisper.init_cache(cfg, clients, batch, max_len, dev, enc_out=enc, params=params)


def hold_recorded(calls, dev):
    """Every recorded attention call's inputs through the kernel and the
    plain version (``hold_call``: bf16 element by element within one bf16
    step of each output); returns the number of shapes held."""
    for key, rec in calls.items():
        hold_call(key[0], rec["args"], rec["kw"], dev)
    return len(calls)


def bf16_prefill_agree(dev, cfg, seq=96):
    """A bf16 model's federated prefill step (2 clients x 2 requests x
    ``seq`` tokens, past gemma2's window 64; whisper's frames, the VLM's
    patches) through the tensor-core tile, as the model calls it
    (fused-projection views, GQA, window, softcap, whisper's encoder and
    cross-attention), against the same step with the plain attention on
    the card. Every attention call's output is held within one bf16 step
    of the plain version on its own inputs (``hold_recorded``). The two
    runs share every other kernel and all weights, so they differ only
    where an attention output rounds to the neighbouring bf16 value,
    carried through the later layers' bf16 products and norms: logits and
    every cache leaf within 4 bf16 steps of their largest magnitude (2^-5
    of it). An MoE model's plain run takes the kernel run's expert choices
    (``PinnedRouting``)."""
    params = serve_lib.personalized_params(cfg, 2, SEED, dev)
    tok = torch.randint(0, cfg.vocab_size, (2, 2, seq),
                        generator=torch.Generator().manual_seed(SEED + 2)).to(dev)
    inputs = family_inputs(cfg, tok, SEED + 2)
    prefill = steps.build_prefill_step(cfg, federated=True)
    pin = PinnedRouting()
    zero_counters()
    with pin.run("record"), recorded_calls() as calls:
        got, got_cache = prefill(params, inputs)
    layers = attention_calls(cfg)
    read_counters(f"serve-agree {cfg.name} bf16", {"flash_attention_prefill": layers})
    held = hold_recorded(calls, dev)
    zero_counters()
    with plain_attention(), pin.run("replay"):
        want, want_cache = prefill(params, inputs)
    read_counters(f"serve-agree {cfg.name} bf16 plain", {})
    largest = float(want.float().abs().max())
    err = check(f"serve-agree {cfg.name} bf16 prefill logits", got, want, 2.0 ** -5 * largest)
    cache_errs = [check(f"serve-agree {cfg.name} bf16 prefill cache", g, w,
                        2.0 ** -5 * float(w.float().abs().max()))
                  for g, w in zip(leaves(got_cache), leaves(want_cache))]
    print(f"  {cfg.name} bf16: prefill over {prompt_positions(cfg, seq)} positions on the tile, "
          f"{layers} launches, {held} shape(s) each within one bf16 step; logits max_abs_err "
          f"{err:.3e} against the plain attention (largest |logit| {largest:.3f}), cache leaves "
          f"{max(cache_errs):.3e}{pin.report()}")


def bf16_decode_agree(dev, cfg, steps_run=72):
    """A bf16 model's teacher-forced decode steps (2 clients x 2 requests,
    past gemma2's window 64; whisper over its encoder's cross K/V, shared
    by both runs) through the decode kernel, against the same steps with
    the plain attention on the card, each run on its own cache. Every
    attention call's output is held within one bf16 step of the plain
    version on its own inputs (``hold_recorded``). As in
    ``bf16_prefill_agree`` the runs differ only where an attention output
    rounds to the neighbouring bf16 value, carried through later layers and
    into the caches: every step's logits within 4 bf16 steps of that step's
    largest logit (2^-5 of it). An MoE model's plain run takes the kernel
    run's expert choices (``PinnedRouting``)."""
    params = serve_lib.personalized_params(cfg, 2, SEED, dev)
    tok = torch.randint(0, cfg.vocab_size, (2, 2, steps_run),
                        generator=torch.Generator().manual_seed(SEED + 4)).to(dev)
    step = steps.build_serve_step(cfg, federated=True)
    cross = None
    if cfg.family == "audio":
        cross = family_cache(cfg, params, family_inputs(cfg, tok, SEED + 4), 2, 2, 1,
                             dev)["cross_kv"]

    def run():
        cache = registry.module(cfg).init_cache(cfg, 2, 2, steps_run + 8, dev)
        if cross is not None:
            cache["cross_kv"] = cross
        logits = []
        for pos in range(steps_run):
            out, cache = step(params, cache, tok[:, :, pos:pos + 1], pos)
            logits.append(out)
        return logits

    layers = attention_calls(cfg, decode=True)
    pin = PinnedRouting()
    zero_counters()
    with pin.run("record"), recorded_calls() as calls:
        got = run()
    read_counters(f"serve-agree {cfg.name} bf16 decode",
                  {"flash_attention_decode": steps_run * layers})
    held = hold_recorded(calls, dev)
    zero_counters()
    with plain_attention(), pin.run("replay"):
        want = run()
    read_counters(f"serve-agree {cfg.name} bf16 decode plain", {})
    worst = 0.0
    for pos, (g, w) in enumerate(zip(got, want)):
        largest = float(w.float().abs().max())
        err = check(f"serve-agree {cfg.name} bf16 decode step {pos}", g, w, 2.0 ** -5 * largest)
        worst = max(worst, err / largest)
    print(f"  {cfg.name} bf16: {steps_run} decode steps on the decode kernel, "
          f"{steps_run * layers} launches, {held} shape(s) each within one bf16 step; logits "
          f"within {worst:.3e} of each step's largest |logit| against the plain attention "
          f"(gate 2^-5){pin.report()}")


def zero_counters():
    for c in COUNTERS.values():
        c.launches = 0
    GRAM.padded = 0


def check_special_round(name, launches, state, params0):
    """The run's one special round launched gram once, on rows it read
    where they lie (no padded copy), and kept full_grads at (m, dim)."""
    want = (state["params"].shape[0], flat.LayoutTable.build(params0).dim)
    shape = tuple(state["collab"]["full_grads"].shape)
    if launches["gram"] != 1 or GRAM.padded != 0 or shape != want:
        raise AssertionError(f"{name}: the special round made {launches['gram']} gram launches "
                             f"and {GRAM.padded} padded copies (want 1 and 0), full_grads "
                             f"{shape} (want {want})")


def read_counters(name, expect):
    """The launches since zero_counters(): exactly ``expect`` ({counter:
    launches}) and nothing of any other kernel."""
    got = {k: c.launches for k, c in COUNTERS.items()}
    if got != {k: expect.get(k, 0) for k in COUNTERS}:
        raise AssertionError(f"{name}: launches {got}, expected {expect} and no other kernel")
    return got


def check_logits(name, logits, cfg):
    if not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError(f"{name}: non-finite logits")
    diff = float((logits[0] - logits[1]).abs().max())
    if not diff > 0:
        raise AssertionError(f"{name}: the two clients' logits are identical")
    return diff


def prefill_run(dev, cfg, top=12, seq=PREFILL_LEN):
    """Personalized params for SERVE_CLIENTS clients, then the federated
    prefill step over ``seq`` tokens a request (whisper's encoder frames
    and the VLM's patches beside them, ``family_inputs``; one warm-up call
    and PREFILL_REPS timed ones, one tile launch an attention call, no
    other kernel), its logits checked, and a profile of one more call.
    Returns (out, params, the inputs, the last logits, the last caches,
    the counted calls' ``recorded_calls``)."""
    m, b = SERVE_CLIENTS, SERVE_BATCH
    t0 = time.perf_counter()
    params = serve_lib.personalized_params(cfg, m, SEED, dev)
    torch.cuda.synchronize(dev)
    out = dict(init_s=time.perf_counter() - t0,
               params_per_client=sum(x[0].numel() for x in leaves(params)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    tokens = torch.randint(0, cfg.vocab_size, (m, b, seq), generator=gen, device=dev)
    inputs = family_inputs(cfg, tokens, SEED + 8)
    prefill = steps.build_prefill_step(cfg, federated=True)
    zero_counters()
    times = []
    with recorded_calls(copy=False) as calls:
        for _ in range(1 + PREFILL_REPS):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            logits, caches = prefill(params, inputs)
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t)
    out["prefill_launches"] = read_counters(
        f"{cfg.name} prefill",
        {"flash_attention_prefill": attention_calls(cfg) * (1 + PREFILL_REPS)})
    if tuple(logits.shape) != (m, b, 1, cfg.padded_vocab):
        raise AssertionError(f"{cfg.name} prefill: logits {tuple(logits.shape)}")
    out["client_logit_diff"] = check_logits(f"{cfg.name} prefill", logits, cfg)
    out["prefill_times_s"] = times
    out["prefill_s"] = statistics.median(times[1:])
    out["prefill_tokens"] = seq
    out["prefill_tok_s"] = m * b * seq / out["prefill_s"]
    # every input position a request brings: the VLM's patches, whisper's frames
    extra = {"audio": cfg.encoder_seq, "vlm": cfg.num_patches}.get(cfg.family, 0)
    out["prefill_inputs_s"] = m * b * (seq + extra) / out["prefill_s"]
    out["prefill_profile"] = profile(lambda: prefill(params, inputs), dev, top=top)
    return out, params, inputs, logits, caches, calls


def serve_prefill(dev, cfg):
    """``prefill_run``, its k cache's shape checked, and a profile of
    decode steps at the serve run's positions."""
    m, b = SERVE_CLIENTS, SERVE_BATCH
    out, params, inputs, logits, caches, _ = prefill_run(dev, cfg)
    tokens = inputs["tokens"]
    k = caches["blocks"]["l0"]["k"]
    if tuple(k.shape) != (m, cfg.num_groups, b, PREFILL_LEN, cfg.num_kv_heads,
                          cfg.resolved_head_dim):
        raise AssertionError(f"prefill: k cache {tuple(k.shape)}")
    del logits, caches, k

    # decode steps at positions PROMPT_LEN.. of a serve-sized cache
    step = steps.build_serve_step(cfg, federated=True)
    cache = transformer.init_cache(cfg, m, b, PROMPT_LEN + DECODE_TOKENS, dev)
    cur = tokens[:, :, :1]
    step(params, cache, cur, 0)
    out["decode_profile_4_steps"] = profile(lambda: [step(params, cache, cur, pos)
                                                     for pos in range(PROMPT_LEN, PROMPT_LEN + 4)],
                                            dev)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def serve_phase(dev):
    """qwen2-7b at full width and depth, bf16, 2 personalized clients x 2
    requests: the prefill step, a decode profile, then ``serve()``."""
    t0 = time.perf_counter()
    cfg = configs.get(SERVE_ARCH)
    m, b = SERVE_CLIENTS, SERVE_BATCH
    torch.cuda.reset_peak_memory_stats(dev)
    out = serve_prefill(dev, cfg)
    torch.cuda.empty_cache()
    print(f"  {cfg.name}: {out['params_per_client'] / 1e9:.3f} B parameters per client, "
          f"{cfg.num_layers} layers, {cfg.param_dtype}; init + personalize {out['init_s']:.2f} s; "
          f"peak memory {out['peak_gb']:.2f} GB")
    print(f"  prefill: {m} clients x {b} requests x {PREFILL_LEN} tokens in "
          f"{out['prefill_s'] * 1e3:.1f} ms (median of {PREFILL_REPS}; first call "
          f"{out['prefill_times_s'][0] * 1e3:.1f} ms), {out['prefill_tok_s']:.0f} tokens/s; "
          f"tensor-core tile launches {out['prefill_launches']['flash_attention_prefill']} over "
          f"{1 + PREFILL_REPS} calls")
    print_profiles(cfg.name, {"prefill step": out["prefill_profile"],
                              "4 decode steps": out["decode_profile_4_steps"]})

    torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    res = serve_lib.serve(cfg, clients=m, batch=b, prompt_len=PROMPT_LEN,
                          decode_tokens=DECODE_TOKENS, seed=SEED, device=dev)
    steps_run = PROMPT_LEN + DECODE_TOKENS
    # every decode step on the decode kernel, none on the FMA kernel
    launches = read_counters("serve", {"flash_attention_decode": cfg.num_layers * steps_run})
    if tuple(res.tokens.shape) != (m, b, DECODE_TOKENS) or not bool(
            ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"serve: tokens {tuple(res.tokens.shape)} out of range")
    diff = check_logits("serve", res.logits, cfg)
    out.update(serve_peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               prompt_s=res.prefill_s, prompt_tok_s=m * b * PROMPT_LEN / res.prefill_s,
               decode_s=res.decode_s, decode_tok_s=m * b * DECODE_TOKENS / res.decode_s,
               decode_step_ms=res.decode_s / DECODE_TOKENS * 1e3, serve_launches=launches,
               serve_client_logit_diff=diff, sample=res.tokens[0, 0].tolist())
    print(f"  serve(): {PROMPT_LEN}-token teacher-forced prompt in {res.prefill_s:.3f} s "
          f"({out['prompt_tok_s']:.1f} tokens/s), {DECODE_TOKENS} greedy tokens in "
          f"{res.decode_s:.3f} s ({out['decode_tok_s']:.1f} tokens/s, "
          f"{out['decode_step_ms']:.2f} ms a step); decode kernel launches "
          f"{launches['flash_attention_decode']} over {steps_run} steps; peak memory "
          f"{out['serve_peak_gb']:.2f} GB; clients' last logits differ by up to {diff:.3f}")
    del res
    torch.cuda.empty_cache()
    phase("serve", t0, f"{cfg.name} at full width and depth served {m} clients x {b} requests")
    print("serve_path " + json.dumps(out))
    return out


def attention_calls(cfg, decode=False):
    """The attention kernel calls of one forward (or one decode step):
    none in an SSM, one shared layer a group in the hybrid; whisper's
    encoder layers (the forward only), then a self- and a cross-attention
    call a decoder layer; every layer (first_block's too) else."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_groups
    if cfg.family == "audio":
        return 2 * cfg.num_layers + (0 if decode else cfg.encoder_layers)
    return cfg.num_layers


def check_tree(name, got, want, tol):
    """Every leaf of ``got`` within ``tol`` of ``want``'s, or ``tol`` of
    its largest magnitude where that is over 1 (an SSM state grows with
    depth); returns the largest error."""
    return max(check(f"{name} {'/'.join(path)}", g, w,
                     tol * max(1.0, float(w.float().abs().max())))
               for path, g, w in zip(pytree.paths(want), leaves(got), leaves(want)))


def families_agree_phase(dev):
    """Reduced mixtral-8x7b, kimi-k2 (first_dense), mamba2-1.3b,
    zamba2-2.7b at 12 layers (two hybrid groups, so two shared-attention
    caches), whisper-large-v3 (2 encoder + 2 decoder layers, 32 stub
    frames) and internvl2-1b (8 patches) in f32, 2 clients x 2 requests,
    from the same weights and inputs: the federated prefill step over
    AGREE_PREFILL tokens (the FMA kernel once an attention call) and 72
    teacher-forced decode steps (the decode kernel once an attention call
    a step; whisper's cross K/V from its encoder, ``family_cache``) on the
    card against the plain path on the CPU, logits atol 1e-4 as in
    serve-agree and every cache leaf (k, v, pos; h, conv; cross_kv) within
    1e-4 (of its largest magnitude where that is over 1). Then each in
    bf16: the tile's prefill and 72 decode-kernel steps against the plain
    attention on the card, each attention call within one bf16 step
    (``bf16_prefill_agree``, ``bf16_decode_agree``); then one federated
    user-centric train step of reduced mixtral, whisper and internvl2
    (``family_train_agree``). The card's f32 prefills and the train steps
    run under ``recorded_calls``, so each of their kernels gets a row (tag
    ``families``) that holds every shape it was given against the plain
    version. Returns (rows, {row: launches})."""
    t0 = time.perf_counter()
    calls = {}
    for arch, over in AGREE_FAMILIES.items():
        cfg = configs.get(arch).reduced(**over)
        layers, decode_layers = attention_calls(cfg), attention_calls(cfg, decode=True)
        host = serve_lib.personalized_params(cfg, 2, SEED, "cpu")
        card = transformer.tree_map(lambda x: x.to(dev), host)
        tok = torch.randint(0, cfg.vocab_size, (2, 2, 72),
                            generator=torch.Generator().manual_seed(SEED + 1))
        hin = family_inputs(cfg, tok[:, :, :AGREE_PREFILL], SEED + 3)
        cin = {k: v.to(dev) for k, v in hin.items()}
        prefill = steps.build_prefill_step(cfg, federated=True)
        hl, hc = prefill(host, hin)
        zero_counters()
        with recorded_calls() as prefill_calls:
            cl, cc = prefill(card, cin)
        read_counters(f"families-agree {arch} f32 prefill", {"flash_attention_fma": layers})
        merge_calls(calls, prefill_calls)
        errs = [check(f"families-agree {arch} prefill", cl, hl.to(dev), 1e-4)]
        cache_err = check_tree(f"families-agree {arch} prefill cache", cc,
                               transformer.tree_map(lambda x: x.to(dev), hc), 1e-4)
        step = steps.build_serve_step(cfg, federated=True)
        hcache = family_cache(cfg, host, hin, 2, 2, 80, "cpu")
        ccache = family_cache(cfg, card, cin, 2, 2, 80, dev)
        zero_counters()
        for pos in range(72):
            hl, hcache = step(host, hcache, tok[:, :, pos:pos + 1], pos)
            cl, ccache = step(card, ccache, tok[:, :, pos:pos + 1].to(dev), pos)
            errs.append(check(f"families-agree {arch} decode step {pos}", cl, hl.to(dev), 1e-4))
        read_counters(f"families-agree {arch} f32 decode",
                      {"flash_attention_decode": 72 * decode_layers})
        cache_err = max(cache_err, check_tree(f"families-agree {arch} decode cache", ccache,
                                              transformer.tree_map(lambda x: x.to(dev), hcache),
                                              1e-4))
        print(f"  {cfg.name} ({cfg.family}, {cfg.num_layers} layers, {layers} attention calls): "
              f"prefill logits max_abs_err {errs[0]:.3e} ({layers} FMA launches), 72 decode "
              f"steps {max(errs[1:]):.3e} ({72 * decode_layers} decode launches), caches "
              f"{cache_err:.3e}; largest |logit| {float(hl.abs().max()):.2f}")
    for arch, over in AGREE_FAMILIES.items():
        cfg = configs.get(arch).reduced(param_dtype="bfloat16", act_dtype="bfloat16", **over)
        bf16_prefill_agree(dev, cfg)
        bf16_decode_agree(dev, cfg)
    for arch in AGREE_TRAIN:
        merge_calls(calls, family_train_agree(dev, arch))
    rows, launches = recorded_rows("families", calls, dev)
    for name, r in rows.items():
        finish_row(name, r)
    phase("families-agree", t0, "reduced mixtral-8x7b, kimi-k2, mamba2-1.3b, zamba2-2.7b, "
          "whisper-large-v3 and internvl2-1b serve on the card as on the CPU (f32, logits and "
          "caches within 1e-4, 72 decode steps); in bf16 the tile's prefill and 72 decode "
          "steps match the plain attention's; a train step of reduced mixtral, whisper and "
          "internvl2 matches the CPU's")
    return rows, launches


def merge_calls(into, calls):
    """Add one ``recorded_calls`` block's calls to ``into``, summing the
    launches of a call both hold; a live copy replaces one that is not."""
    for key, rec in calls.items():
        if key not in into:
            into[key] = rec
            continue
        if rec.get("live") and not into[key].get("live"):
            into[key].update(args=rec["args"], live=True)
        for k, n in rec["launches"].items():
            into[key]["launches"][k] = into[key]["launches"].get(k, 0) + n


def family_train_agree(dev, arch):
    """One federated user-centric train step of a reduced family (f32, 2
    clients, the FMA kernel under autograd once an attention call, the mix
    kernel once a leaf) on the card against the same step on the CPU, from
    the same params, W and batch (whisper's frames, the VLM's patches): the
    loss within 1e-3 of itself, each leaf's change within FAMILY_STEP_TOL
    of the CPU's change (L2). Returns the card step's recorded calls."""
    cfg = configs.get(arch).reduced()
    host = serve_lib.personalized_params(cfg, 2, SEED, "cpu")
    card = transformer.tree_map(lambda x: x.to(dev), host)
    toks = torch.randint(0, cfg.vocab_size, (2, 2, AGREE_PREFILL + 1),
                         generator=torch.Generator().manual_seed(SEED + 5))
    batch = dict(family_inputs(cfg, toks[..., :-1], SEED + 6), labels=toks[..., 1:])
    w = torch.tensor([[0.7, 0.3], [0.4, 0.6]])
    step = steps.build_train_step(cfg, n_clients=2, agg="user_centric", lr=TRAIN_LR,
                                  momentum=cfg.momentum)
    want, _, wm = step(host, sgd_init(host, momentum=cfg.momentum), w, batch)
    zero_counters()
    with recorded_calls() as calls:
        got, _, gm = step(card, sgd_init(card, momentum=cfg.momentum), w.to(dev),
                          {k: v.to(dev) for k, v in batch.items()})
    launches = read_counters(f"families-agree {arch} train step",
                             {"flash_attention_fma": attention_calls(cfg),
                              "mix_aggregate": len(leaves(card))})
    loss_err = abs(float(gm["loss"]) - float(wm["loss"]))
    if not loss_err <= 1e-3 * abs(float(wm["loss"])):
        raise AssertionError(f"families-agree {arch} train step: loss {float(gm['loss'])} "
                             f"against the CPU's {float(wm['loss'])}")
    worst = 0.0
    for name, a, b, p0 in zip(pytree.paths(got), leaves(got), leaves(want), leaves(host)):
        num, den = float((a.cpu() - b).norm()), float((b - p0).norm())
        rel = num / den if den else (0.0 if num == 0 else float("inf"))
        if not rel <= FAMILY_STEP_TOL:
            raise AssertionError(f"families-agree {arch} train step: {'/'.join(name)}'s change "
                                 f"is {rel:.3e} (L2) off the CPU's (gate {FAMILY_STEP_TOL})")
        worst = max(worst, rel)
    print(f"  {cfg.name} train step (user_centric, 2 clients, f32) on the card against the CPU: "
          f"loss {float(gm['loss']):.6f} / {float(wm['loss']):.6f}, the change of a leaf at most "
          f"{worst:.3e} (L2) off the CPU's (gate {FAMILY_STEP_TOL}); launches {launches}")
    return calls


def family_config(arch):
    """The configuration at its published widths, depth cut where
    FAMILY_LAYERS says."""
    cfg = configs.get(arch)
    layers = FAMILY_LAYERS[arch]
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def decode_cache(cfg, prefill_caches, clients, batch, max_len, dev):
    """A decode cache of ``max_len`` positions holding a prefill step's
    caches: each attention slot's k and v in its first S positions (pos
    0..S-1; a window layer's rolling cache holds at most its window), each
    mamba slot's h and conv; whisper's self caches so, and the prefill's
    cross K/V."""
    cache = registry.module(cfg).init_cache(cfg, clients, batch, max_len, dev)

    def fill(dst, src):
        if "k" in dst:
            s = src["k"].shape[-3]
            if s > dst["k"].shape[-3]:
                raise AssertionError(f"decode_cache: {s} prefill positions overflow a cache of "
                                     f"{dst['k'].shape[-3]}")
            dst["k"].narrow(-3, 0, s).copy_(src["k"])
            dst["v"].narrow(-3, 0, s).copy_(src["v"])
            dst["pos"].narrow(-1, 0, s).copy_(torch.arange(s, device=dev))
        else:
            dst["h"].copy_(src["h"])
            dst["conv"].copy_(src["conv"])

    if cfg.family == "audio":
        fill(cache["self"], prefill_caches["self"])
        cache["cross_kv"] = prefill_caches["cross_kv"]
        return cache
    for key, dst in cache["blocks"].items():
        fill(dst, prefill_caches["blocks"][key])
    if "first_block" in cache:
        fill(cache["first_block"], prefill_caches["first_block"])
    return cache


@contextlib.contextmanager
def moe_drops():
    """Every MoE layer the block runs reports its dropped assignments:
    yields a list of (dropped (a device scalar), assignments)."""
    from repro_torch.models import moe

    seen = []
    real = moe.apply_auto

    def counting(p, x, mcfg):
        seen.append((moe.dropped(p, x, mcfg).sum(), x.shape[0] * x.shape[1] * x.shape[2]
                     * mcfg.top_k))
        return real(p, x, mcfg)
    moe.apply_auto = counting
    try:
        yield seen
    finally:
        moe.apply_auto = real


def family_rows(cfg):
    """The kernel rows of a family's attention shapes at full width (named
    after the configuration's first word), each with the launches that the
    model's structure gives it a prefill call and a decode step: ({row:
    launches a prefill call}, {row: launches a decode step}), what
    ``family_row_launches`` must count."""
    tag, layers, calls = cfg.name.split("-")[0], cfg.num_layers, attention_calls(cfg)
    if cfg.family == "audio":
        return ({f"flash_attention_prefill_{tag}_encoder": cfg.encoder_layers,
                 f"flash_attention_prefill_{tag}_self": layers,
                 f"flash_attention_prefill_{tag}_cross": layers},
                {f"flash_attention_decode_{tag}_self": layers,
                 f"flash_attention_decode_{tag}_cross": layers})
    if not calls:
        return {}, {}
    prefill = {f"flash_attention_prefill_{tag}": calls}
    if len(set(cfg.attn_pattern)) > 1:  # gemma2: window layers beside global ones
        local = calls * cfg.attn_pattern.count("local") // len(cfg.attn_pattern)
        prefill = {f"flash_attention_prefill_{tag}": calls - local,
                   f"flash_attention_prefill_{tag}_window": local}
    return prefill, {f"flash_attention_decode_{tag}": calls}


def audio_part(cfg, q, k, opts):
    """Which of whisper's attentions a call of q, k shapes is: its
    encoder's (non-causal over the frames), its cross-attention's (fewer
    queries over the frames) or its decoder's self-attention."""
    over_frames = not opts["causal"] and k[2] == cfg.encoder_seq
    return "_self" if not over_frames else "_encoder" if q[2] == k[2] else "_cross"


def family_row_launches(cfg, *blocks):
    """The launches of a full-width family's recorded attention calls
    (``recorded_calls`` blocks), each under its kernel row (``family_rows``'
    names): the counter that rose says tile (prefill) or decode kernel.
    Whisper's encoder calls are non-causal with Sq = Sk = its frames, its
    cross-attention non-causal over its frames' keys from fewer queries,
    and its self-attention every other call (its decode steps attend over
    fewer keys than the frames: whisper's 448 positions against 1,500
    frames); where window layers sit beside global ones (gemma2), the
    window rows are the calls with a window."""
    tag = cfg.name.split("-")[0]
    rows = {}
    for calls in blocks:
        for key, rec in calls.items():
            (q, _), (k, _), opts = key[1], key[2], dict(key[4:])
            for counter, n in rec["launches"].items():
                row = f"{counter}_{tag}"
                if cfg.family == "audio":
                    row += audio_part(cfg, q, k, opts)
                elif opts.get("window") is not None and len(set(cfg.attn_pattern)) > 1:
                    row += "_window"
                rows[row] = rows.get(row, 0) + n
    return rows


def family_serve(dev, cfg):
    """A family at full width, bf16: ``prefill_run`` over its prompt
    (FAMILY_PROMPT tokens, PREFILL_LEN where it names none; whisper's 1,500
    frames and the VLM's 256 patches beside them), then FAMILY_DECODE timed
    greedy decode steps on the prefill's caches from the prompt's last
    position and FAMILY_PROFILED profiled ones (each attention call one
    decode-kernel launch a step, the FMA kernel never; a window layer's
    rolling cache, filled by the prompt, wraps); an MoE model's dropped
    share at its capacity factor from one more prefill call."""
    m, b = SERVE_CLIENTS, SERVE_BATCH
    seq = FAMILY_PROMPT.get(cfg.name, PREFILL_LEN)
    first = prompt_positions(cfg, seq)
    last = first + FAMILY_DECODE + FAMILY_PROFILED
    layers, decode_layers = attention_calls(cfg), attention_calls(cfg, decode=True)
    per_call, per_step = family_rows(cfg)
    if sum(per_call.values()) != layers or sum(per_step.values()) != decode_layers:
        raise AssertionError(f"{cfg.name}: kernel rows {per_call}, {per_step} against "
                             f"{layers} and {decode_layers} attention calls")
    if cfg.family == "audio" and last >= cfg.encoder_seq:
        raise AssertionError(f"{cfg.name}: decode to position {last} reaches the "
                             f"{cfg.encoder_seq} frames, so self and cross calls share shapes")
    torch.cuda.reset_peak_memory_stats(dev)
    out, params, inputs, logits, caches, prefill_calls = prefill_run(dev, cfg, top=10, seq=seq)
    out.update(layers=cfg.num_layers, attention_calls=layers, decode_from=first)
    if cfg.family == "moe":
        with moe_drops() as seen:
            steps.build_prefill_step(cfg, federated=True)(params, inputs)
        out["dropped_share"] = sum(int(d) for d, _ in seen) / sum(a for _, a in seen)
        out["dropped_share_by_layer"] = [int(d) / a for d, a in seen]

    step = steps.build_serve_step(cfg, federated=True)
    cache = decode_cache(cfg, caches, m, b, last, dev)
    del caches, inputs
    cur = torch.argmax(logits, dim=-1)
    zero_counters()
    with recorded_calls(copy=False) as decode_calls:
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        for pos in range(first, first + FAMILY_DECODE):
            logits, cache = step(params, cache, cur, pos)
            cur = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize(dev)
        out["decode_step_ms"] = (time.perf_counter() - t) / FAMILY_DECODE * 1e3
        start = first + FAMILY_DECODE
        out["decode_profile_4_steps"] = profile(
            lambda: [step(params, cache, cur, pos) for pos in range(start, last)], dev)
    out["decode_tok_s"] = m * b / out["decode_step_ms"] * 1e3
    out["decode_launches"] = read_counters(
        f"{cfg.name} decode",
        {"flash_attention_decode": decode_layers * (FAMILY_DECODE + FAMILY_PROFILED)})
    # each row's launches as the recorded calls counted them, held to the
    # model's structure
    out["row_launches"] = family_row_launches(cfg, prefill_calls, decode_calls)
    want = {r: n * (1 + PREFILL_REPS) for r, n in per_call.items()}
    want.update({r: n * (FAMILY_DECODE + FAMILY_PROFILED) for r, n in per_step.items()})
    if out["row_launches"] != want:
        raise AssertionError(f"{cfg.name}: the recorded calls launched {out['row_launches']} "
                             f"by row, the model's structure gives {want}")
    del prefill_calls, decode_calls
    if cfg.window and "local" in cfg.attn_pattern and cfg.window <= first:
        # the local layers' rolling caches hold the last `window` positions
        local = cache["blocks"][f"l{cfg.attn_pattern.index('local')}"]["pos"]
        if local.shape[-1] != cfg.window or int(local.max()) != last - 1 or int(
                local.min()) != last - cfg.window:
            raise AssertionError(f"{cfg.name}: the local cache holds positions "
                                 f"{int(local.min())}..{int(local.max())} in {local.shape[-1]} "
                                 f"slots, not the last {cfg.window} before {last}")
        out["local_cache"] = [int(local.min()), int(local.max()), local.shape[-1]]
    out["decode_client_logit_diff"] = check_logits(f"{cfg.name} decode", logits, cfg)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, cache, logits
    torch.cuda.empty_cache()
    by_layer = [round(x, 4) for x in out.get("dropped_share_by_layer", ())]
    drops = (f"; dropped {out['dropped_share']:.4f} of the assignments at capacity factor "
             f"{cfg.capacity_factor} (by layer {by_layer})" if "dropped_share" in out else "")
    kernels = (f"{layers} tile launches a prefill call, {decode_layers} decode-kernel "
               f"launches a step; recorded by row over {1 + PREFILL_REPS} prefill calls and "
               f"{FAMILY_DECODE + FAMILY_PROFILED} steps: {out['row_launches']}"
               if layers else "no attention layer: no attention kernel runs")
    wrap = (f"; local caches hold positions {out['local_cache'][0]}..{out['local_cache'][1]} "
            f"in {out['local_cache'][2]} slots" if "local_cache" in out else "")
    inputs_s = (f" ({out['prefill_inputs_s']:.0f} input positions/s with the "
                f"{'frames' if cfg.family == 'audio' else 'patches'})"
                if cfg.family in ("audio", "vlm") else "")
    print(f"  {cfg.name}: {out['params_per_client'] / 1e9:.3f} B parameters a client, "
          f"{cfg.num_layers} layers, {cfg.param_dtype}; init + personalize {out['init_s']:.2f} s; "
          f"peak memory {out['peak_gb']:.2f} GB; {kernels}{drops}")
    print(f"  {cfg.name} prefill: {m} clients x {b} requests x {seq} tokens in "
          f"{out['prefill_s'] * 1e3:.1f} ms (median of {PREFILL_REPS}; first call "
          f"{out['prefill_times_s'][0] * 1e3:.1f} ms), {out['prefill_tok_s']:.0f} tokens/s"
          f"{inputs_s}; decode {out['decode_step_ms']:.2f} ms a step ({FAMILY_DECODE} steps from "
          f"position {first}), {out['decode_tok_s']:.1f} tokens/s; clients' logits differ by up "
          f"to {out['client_logit_diff']:.3f} (prefill), {out['decode_client_logit_diff']:.3f} "
          f"(decode){wrap}")
    print_profiles(cfg.name, {"prefill step": out["prefill_profile"],
                              f"{FAMILY_PROFILED} decode steps": out["decode_profile_4_steps"]})
    return out


def moe_layer_check(dev, cfg):
    """One of the configuration's MoE layers at full width in f32 (one
    client, MOE_TOKENS tokens) with a capacity that drops nothing
    (capacity factor E / top_k), against ``apply_reference``, the O(E·N)
    oracle: within 1e-5 of the largest |y|, TF32 off. The layer is the
    second group's view of a two-group stack, as ``transformer._groups``
    hands a served model's layers to ``moe.apply``."""
    from repro_torch.models import moe

    mcfg = dataclasses.replace(transformer.moe_config(cfg),
                               capacity_factor=cfg.moe_num_experts / cfg.moe_top_k)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    stack = None
    for g in range(2):
        one = moe.init(gen, mcfg, torch.float32, dev)
        if stack is None:
            stack = {k: v.new_empty((1, 2) + v.shape) for k, v in one.items()}
        for k, v in one.items():
            stack[k][0, g].copy_(v)
        del one
    stacked_cfg = dataclasses.replace(cfg, num_layers=cfg.first_dense + 2 * cfg.pattern_len)
    p = list(transformer._groups(stack, stacked_cfg))[1]
    x = torch.randn(1, 1, MOE_TOKENS, cfg.d_model, generator=gen, device=dev)
    y, aux = moe.apply(p, x, mcfg)
    drops = int(moe.dropped(p, x, mcfg)[0])
    want = moe.apply_reference(p, x, mcfg)
    largest = float(want.abs().max())
    err = check("moe layer f32 against the oracle", y, want, 1e-5 * largest)
    if drops != 0:
        raise AssertionError(f"moe layer: {drops} assignments dropped at "
                             f"capacity factor {mcfg.capacity_factor}")
    if p["w_gate"].stride(0) != 2 * p["w_gate"].stride(1) * cfg.moe_num_experts:
        raise AssertionError("moe layer: the experts are not a group's view of the stack")
    weights_gb = sum(v.numel() * 4 for v in p.values()) / 1e9
    print(f"  {cfg.name} MoE layer, f32, {MOE_TOKENS} tokens, capacity "
          f"{moe.capacity(MOE_TOKENS, mcfg)} (nothing dropped), {weights_gb:.2f} GB of weights: "
          f"max_abs_err {err:.3e} against the O(E·N) oracle (largest |y| {largest:.3f}, gate "
          f"1e-5 of it); aux {float(aux[0]):.4f}")
    del p, stack
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, largest=largest, weights_gb=weights_gb)


def ssd_recurrence(xh, b, c, dt, a_log):
    """The SSD as its one-token recurrence, in f32: h_t = exp(dt_t·A)·h_{t-1}
    + dt_t·(x_t ⊗ B_t), y_t = C_t·h_t. Returns (y (R, S, H, P), h (R, H, P, N))."""
    r, s, nh, pdim = xh.shape
    a = torch.exp(dt * -torch.exp(a_log)[:, None, :])  # (R, S, H)
    h = torch.zeros((r, nh, pdim, b.shape[-1]), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(s):
        h = (h * a[:, t, :, None, None]
             + dt[:, t, :, None, None] * xh[:, t, :, :, None] * b[:, t, None, None, :])
        ys.append(torch.matmul(h, c[:, t, None, :, None])[..., 0])
    return torch.stack(ys, dim=1), h


def ssd_layer_check(dev, cfg):
    """One SSD block at the configuration's full width in f32, TF32 off,
    over SSD_TOKENS tokens (2 sequences), against its recurrence, at the
    reference's own tolerances for this identity (``tests/test_models.py``:
    y rtol 1e-3, atol 1e-5; the final h rtol 1e-4, atol 1e-5):
      * the SSD itself: ``_ssd_chunked`` against ``ssd_recurrence`` on the
        same inputs, held at those tolerances;
      * the block: the chunked ``forward`` against SSD_TOKENS ``decode``
        steps from an empty cache. Its h is held at those tolerances; its
        y is printed against them and held at atol 1e-4: both paths also
        run the block's projections, over K = 2,048 (in) and 4,096 (out)
        in f32 in other orders (a (1,024, K) GEMM against a (2, K) one),
        whose error near zero outputs passes 1e-5 at this width."""
    from repro_torch.models import ssm

    def over(got, want, rtol, atol):
        return float(((got - want).abs() / (atol + rtol * want.abs())).max())

    scfg = transformer.ssm_config(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    p = transformer.tree_map(lambda v: v[None], ssm.init(gen, scfg, torch.float32, dev))
    x = 0.5 * torch.randn(1, 2, SSD_TOKENS, cfg.d_model, generator=gen, device=dev)

    # the SSD alone, on the block's own inputs to it
    di, n = scfg.d_inner, scfg.state
    z, xc, b, c, dt = ssm._split_proj(p, x, scfg)
    xbc, _ = ssm._causal_conv(torch.cat([xc, b, c], dim=-1), p["conv_w"], p["conv_b"])
    xc, b, c = (t.flatten(0, 1) for t in torch.split(xbc, [di, n, n], dim=-1))
    xh = xc.unflatten(-1, (scfg.num_heads, scfg.headdim))
    a_log = p["A_log"].expand(2, -1)
    y_chunk, h_chunk = ssm._ssd_chunked(xh, b, c, dt.flatten(0, 1), a_log, scfg)
    y_seq, h_seq = ssd_recurrence(xh, b, c, dt.flatten(0, 1), a_log)
    core = dict(y_over=over(y_chunk, y_seq, 1e-3, 1e-5), h_over=over(h_chunk, h_seq, 1e-4, 1e-5),
                y_max_abs_err=float((y_chunk - y_seq).abs().max()),
                y_largest=float(y_seq.abs().max()))

    # the block: chunked forward against decode steps
    y, cache = ssm.forward(p, x, scfg)
    cc = ssm.init_cache(1, 2, scfg, torch.float32, dev)
    ys = []
    for s in range(SSD_TOKENS):
        yt, cc = ssm.decode(p, x[:, :, s:s + 1], cc, scfg)
        ys.append(yt)
    yd = torch.cat(ys, dim=2)
    block = dict(y_over_ref=over(yd, y, 1e-3, 1e-5), y_over=over(yd, y, 1e-3, 1e-4),
                 h_over=over(cc["h"], cache["h"], 1e-4, 1e-5),
                 y_max_abs_err=float((yd - y).abs().max()), y_largest=float(y.abs().max()))
    print(f"  {cfg.name} SSD, f32, {SSD_TOKENS} tokens in chunks of {scfg.chunk}: "
          f"_ssd_chunked against the recurrence y at {core['y_over']:.3f} of its allowance "
          f"(rtol 1e-3, atol 1e-5; max_abs_err {core['y_max_abs_err']:.3e}, largest |y| "
          f"{core['y_largest']:.3f}), h at {core['h_over']:.3f} (rtol 1e-4, atol 1e-5); the "
          f"block's forward against {SSD_TOKENS} decode steps y at {block['y_over_ref']:.3f} of "
          f"the reference's allowance, {block['y_over']:.3f} of atol 1e-4 (max_abs_err "
          f"{block['y_max_abs_err']:.3e}, largest |y| {block['y_largest']:.3f}), h at "
          f"{block['h_over']:.3f}")
    worst = max(core["y_over"], core["h_over"], block["y_over"], block["h_over"])
    if not worst <= 1.0:
        raise AssertionError(f"ssd: chunked against sequential, core {core}, block {block}")
    return dict(core=core, block=block)


def families_phase(dev):
    """mixtral-8x7b (4 of 32 layers), mamba2-1.3b, zamba2-2.7b,
    whisper-large-v3, internvl2-1b, gemma2-9b and phi3-medium-14b at full
    depth, all at full width in bf16, served to 2 clients x 2 requests (``family_serve``);
    mixtral's MoE layer and mamba2's SSD block also in f32 at full width
    against their plain forms."""
    t0 = time.perf_counter()
    out = {}
    for arch in FAMILY_LAYERS:
        cfg = family_config(arch)
        out[arch] = family_serve(dev, cfg)
        if cfg.family == "moe":
            out[arch]["moe_layer_f32"] = moe_layer_check(dev, cfg)
        if cfg.family == "ssm":
            out[arch]["ssd_layer_f32"] = ssd_layer_check(dev, cfg)
    phase("families", t0, "mixtral-8x7b (4 layers), mamba2-1.3b (48), zamba2-2.7b (54), "
          "whisper-large-v3 (32 + 32), internvl2-1b (24), gemma2-9b (42) and phi3-medium-14b "
          f"(40) served {SERVE_CLIENTS} clients x {SERVE_BATCH} requests at full width")
    print("families_path " + json.dumps(out))
    return out


# ------------------------------------------------------------------ ep
#
# kimi-k2-1t-a32b at its published widths cut to first_dense + 1 MoE layer
# (19.9 B parameters, 39.8 GB of bf16): served whole on one rank with the
# local sort dispatch, then over a (data 2, model 2) mesh of gloo ranks
# sharing the card with its 384 experts sharded (each rank 192 experts'
# d_ff halves: 14.4 GB); one model (the fedsgd_sharded regime), 2 x 2
# requests of 1,024 tokens, 2 a data rank. Then the reduced EP train step
# and the client-sharded stablelm step.
EP_ARCH = "kimi-k2-1t-a32b"
EP_LAYERS = 2
EP_MESH = (2, 2)
EP_REQUESTS = 4
EP_PREFILL_REPS = 2
EP_DECODE, EP_PROFILED = 4, 4
EP_SEED = SEED + 11
# the EP MoE layer against the one-rank local dispatch on the tokens that
# neither dropped, bf16: the local dispatch rounds the gate and up products
# to bf16 and adds the k outputs in bf16 (the reference's sort dispatch),
# the EP path keeps the products and the activation in f32 and adds the k
# outputs in f32 (the reference's shard_map path), and rounds each
# F-shard's partial row before their bf16 SUM. Then on every token at
# capacity factor 8 and cf2 8, over chunks of EP_NODROP_CHUNK positions
# where nothing drops (a chunk's 2 x 64 tokens a data rank put at most 256
# rows on an expert, under cap2 344), against ``ep_plain``, the same
# arithmetic on one rank without capacities. Both within 2^-6 of the
# largest |y| (four bf16 steps at the top of the range)
EP_Y_TOL = 2.0 ** -6
EP_NODROP_CHUNK = 64
EP_AUX_TOL = 1e-6
# the reduced f32 EP train step against the one-rank step, each leaf
# |a - b| / |b| in L2 (capacity factor 8: nothing drops on either side)
EP_STEP_TOL = 1e-5
EP_TRAIN_BATCH, EP_TRAIN_SEQ = 8, 12
# the client-sharded train step: stablelm-1.6b as the train phase runs it,
# 4 clients over 2 gloo ranks, 2 user-centric steps
GATHER_SHARDS, GATHER_STEPS = 2, 2


def ep_config():
    """kimi-k2 at its published widths, cut to its dense first block and
    one MoE layer."""
    return dataclasses.replace(configs.get(EP_ARCH), num_layers=EP_LAYERS)


def ep_train_config():
    """families-agree's reduced kimi-k2 in f32 at capacity factor 8."""
    return dataclasses.replace(configs.get(EP_ARCH).reduced(), capacity_factor=8.0)


def ep_tokens(cfg, dev):
    """The EP_REQUESTS prompts of PREFILL_LEN tokens, (1, R, S), the same in
    every process."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(EP_SEED + 1)
    return torch.randint(0, cfg.vocab_size, (1, EP_REQUESTS, PREFILL_LEN), generator=gen,
                         device=dev)


def ep_train_batch(cfg, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(EP_SEED + 2)
    toks = torch.randint(0, cfg.vocab_size, (EP_TRAIN_BATCH, EP_TRAIN_SEQ + 1), generator=gen,
                         device=dev)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def ep_train_step(cfg, params, batch):
    step = steps.build_train_step(cfg, n_clients=1, agg="local", lr=TRAIN_LR,
                                  momentum=cfg.momentum)
    return step(params, sgd_init(params, momentum=cfg.momentum), batch)


@contextlib.contextmanager
def moe_calls():
    """Every MoE layer call in the block (``moe.apply_auto``): yields a list
    of (dropped assignments, dropped at cap2 or None, assignments, the
    layer's input, output and aux). The drops are counted with the path's
    own rule: the local dispatch's capacity, or the EP path's cap and cap2
    on this rank (``moe.ep_dropped``)."""
    from repro_torch.models import moe

    seen = []
    real = moe.apply_auto

    def counting(p, x, mcfg):
        y, aux = real(p, x, mcfg)
        if moe.ep_mesh() is not None:
            at_cap, at_cap2, _ = moe.ep_dropped(p, x, mcfg)
            rec = [int(at_cap.sum()), int(at_cap2.sum())]
        else:
            rec = [int(moe.dropped(p, x, mcfg).sum()), None]
        rec += [x.shape[0] * x.shape[1] * x.shape[2] * mcfg.top_k, x.detach().clone(),
                y.detach().clone(), aux.detach().clone()]
        seen.append(rec)
        return y, aux
    moe.apply_auto = counting
    try:
        yield seen
    finally:
        moe.apply_auto = real


def common_share(t):
    """How much of a (m, B, S, D) activation all the first client's tokens
    share: |mean over tokens|² / mean over tokens of |token|², in f32 (1 /
    the tokens for independent ones, 1 for one vector repeated)."""
    f = t[0].detach().float().reshape(-1, t.shape[-1])
    return float(f.mean(dim=0).square().sum() / f.square().sum(dim=1).mean())


@contextlib.contextmanager
def routing_probe():
    """The common share (``common_share``) of what each attention + MLP
    layer adds in the block, in call order: yields a list of {"in": the
    residual entering the layer, "attn": the attention output, "mlp": the
    dense MLP's output, "out": the residual leaving it}; an MoE layer has
    no "mlp" (its input is the ``moe_calls`` record)."""
    from repro_torch.models import attention

    seen = []
    real_layer, real_attn, real_mlp = (transformer._apply_attn_layer, attention.forward,
                                       transformer.mlp_apply)

    def layer(p, h, *args, **kw):
        rec = {"in": common_share(h)}
        seen.append(rec)
        out = real_layer(p, h, *args, **kw)
        rec["out"] = common_share(out[0])
        return out

    def attn(*args, **kw):
        out = real_attn(*args, **kw)
        seen[-1]["attn"] = common_share(out[0])
        return out

    def mlp(*args, **kw):
        out = real_mlp(*args, **kw)
        seen[-1]["mlp"] = common_share(out)
        return out

    transformer._apply_attn_layer, attention.forward, transformer.mlp_apply = layer, attn, mlp
    try:
        yield seen
    finally:
        transformer._apply_attn_layer, attention.forward, transformer.mlp_apply = (
            real_layer, real_attn, real_mlp)


def router_common(router, x, k):
    """The router's logits over the first client's tokens of x: the share
    of their variance over the experts that the mean logit row carries, and
    the share of tokens whose k choices hold that row's first expert."""
    lg = x[0].float().reshape(-1, x.shape[-1]) @ router[0]
    mean = lg.mean(dim=0)
    common, own = float(mean.var()), float((lg - mean).var(dim=1).mean())
    top = torch.topk(lg, k, dim=-1).indices
    holds = float((top == torch.argmax(mean)).any(dim=-1).float().mean())
    return dict(logit_common_share=common / (common + own), hold_mean_top1=holds)


def ep_serve_run(dev, cfg, params, tokens, name, copy=True):
    """A prefill step over ``tokens`` (one warm call that also records the
    MoE layer's input, output and drops and the routing probe, then
    EP_PREFILL_REPS timed calls, one profiled), then EP_DECODE timed and
    EP_PROFILED profiled greedy decode steps on its caches from the
    prompt's end. Every attention call is one tile launch a prefill and
    one decode-kernel launch a step, each recorded (``recorded_calls``;
    inputs copied with ``copy``). Returns (out, the MoE layer's record of
    the warm call, the routing probe's, the recorded calls)."""
    prefill = steps.build_prefill_step(cfg, federated=True)
    out = {}
    zero_counters()
    with recorded_calls(copy=copy) as calls:
        with moe_calls() as seen, routing_probe() as probe:
            logits, caches = prefill(params, {"tokens": tokens})
        layer = seen[0]
        times = []
        for _ in range(EP_PREFILL_REPS):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            logits, caches = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t)
        out["prefill_profile"] = profile(lambda: prefill(params, {"tokens": tokens}), dev,
                                         top=10)
        n_calls = attention_calls(cfg)
        out["prefill_launches"] = read_counters(
            f"{name} prefill", {"flash_attention_prefill": n_calls * (2 + EP_PREFILL_REPS)})
        if not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
            raise AssertionError(f"{name} prefill: non-finite logits")
        b, s = tokens.shape[1], tokens.shape[2]
        out.update(prefill_times_s=times, prefill_s=statistics.median(times),
                   prefill_tok_s=b * s / statistics.median(times),
                   dropped=layer[0], dropped_cap2=layer[1], assignments=layer[2])
        first = s
        last = first + EP_DECODE + EP_PROFILED
        cache = decode_cache(cfg, caches, 1, b, last, dev)
        del caches
        step = steps.build_serve_step(cfg, federated=True)
        cur = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        for pos in range(first, first + EP_DECODE):
            logits, cache = step(params, cache, cur, pos)
            cur = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize(dev)
        out["decode_step_ms"] = (time.perf_counter() - t) / EP_DECODE * 1e3
        start = first + EP_DECODE
        out["decode_profile_4_steps"] = profile(
            lambda: [step(params, cache, cur, pos) for pos in range(start, last)], dev)
        decode = {"flash_attention_decode": n_calls * (EP_DECODE + EP_PROFILED)}
        read_counters(f"{name} decode", dict(out["prefill_launches"], **decode))
        out["decode_launches"] = decode
    if not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError(f"{name} decode: non-finite logits")
    return out, layer, probe, calls


def ep_plain(p, x, mcfg, ranks):
    """The EP layer's arithmetic with nothing dropped, on one rank, one
    expert at a time in plain torch (the reference's ``shard_map`` path
    without capacities, M = 1): the f32 router without softcap, each
    expert's gate and up products and the SwiGLU in f32, the activation
    cast to x's dtype and its down product in x's dtype (f32
    accumulation), each token's k outputs weighted and added in f32 and
    cast to x's dtype once. The tokens are routed as ``ranks`` data ranks
    route their slices of the batch in ``ep_nodrop``'s chunks: the
    router's f32 product at another shape may reorder two near-equal
    probabilities and so choose another expert. x (1, B, S, D); p one
    client's leaves."""
    from repro_torch.models import moe

    _, b, s, d = x.shape
    k, per = mcfg.top_k, b // ranks
    top_w = torch.empty((b, s, k), dtype=torch.float32, device=x.device)
    top_ids = torch.empty((b, s, k), dtype=torch.int64, device=x.device)
    for r in range(ranks):
        for c in range(0, s, EP_NODROP_CHUNK):
            xc = x[:, r * per:(r + 1) * per, c:c + EP_NODROP_CHUNK]
            _, w, ids = moe._route(p["router"], xc.reshape(1, -1, d), mcfg, softcap=False)
            top_w[r * per:(r + 1) * per, c:c + EP_NODROP_CHUNK] = w.view(per, -1, k)
            top_ids[r * per:(r + 1) * per, c:c + EP_NODROP_CHUNK] = ids.view(per, -1, k)
    top_w, top_ids = top_w.view(b * s, k), top_ids.view(b * s, k)
    xt = x.reshape(b * s, d)
    y = torch.zeros(b * s, d, dtype=torch.float32, device=x.device)
    with torch.no_grad():
        for e in range(mcfg.num_experts):
            tok, choice = (top_ids == e).nonzero(as_tuple=True)
            if tok.numel():
                h = xt[tok]
                g = torch.mm(h, p["w_gate"][0, e], out_dtype=torch.float32)
                u = torch.mm(h, p["w_up"][0, e], out_dtype=torch.float32)
                out = (torch.nn.functional.silu(g) * u).to(x.dtype) @ p["w_down"][0, e]
                y.index_add_(0, tok, out.float() * top_w[tok, choice, None])
    return y.to(x.dtype).view(1, b, s, d)


def ep_nodrop(apply, x):
    """An MoE layer over x (m, B, S, D) in chunks of EP_NODROP_CHUNK
    positions, no grad: ``apply(chunk)`` -> (y, assignments dropped)."""
    ys, dropped = [], 0
    with torch.no_grad():
        for c in range(0, x.shape[2], EP_NODROP_CHUNK):
            y, d = apply(x[:, :, c:c + EP_NODROP_CHUNK].contiguous())
            ys.append(y)
            dropped += d
    return torch.cat(ys, dim=2), dropped


def ep_one_rank(dev, tmp):
    """kimi-k2 whole on one rank, the local dispatch: ``ep_serve_run``;
    the MoE layer's input, output, aux and dropped tokens saved for the
    ranks, with its output where nothing drops (``ep_nodrop`` at capacity
    factor E / k: a chunk's every token fits each expert); the routing's
    common shares. Then the reduced f32 fedsgd step on one rank, its
    params saved. Returns (out, {tag: recorded calls})."""
    from repro_torch.models import moe

    cfg = ep_config()
    mcfg = transformer.moe_config(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    params = registry.one(sharding.rank_params(cfg, EP_SEED, None, dev))
    torch.cuda.synchronize(dev)
    out = dict(init_s=time.perf_counter() - t,
               params=sum(x.numel() for x in leaves(params)))
    tokens = ep_tokens(cfg, dev)
    run, layer, probe, calls = ep_serve_run(dev, cfg, params, tokens, f"{cfg.name} one rank")
    out.update(run)
    x, y, aux = layer[3:]
    p_moe = transformer.tree_map(lambda v: v[:, 0], params["blocks"]["l0"]["moe"])
    mask = moe.dropped_tokens(p_moe, x, mcfg)
    load = moe.expert_load(p_moe, x, mcfg)[0]
    out["busiest_experts"] = sorted(load.tolist(), reverse=True)[:8]
    out["experts_used"] = int((load > 0).sum())
    out["routing"] = dict(layers=probe, moe_input=common_share(x),
                          **router_common(p_moe["router"], x, mcfg.top_k))
    t = time.perf_counter()
    y_full = ep_plain(p_moe, x, mcfg, EP_MESH[0])
    out["plain_layer_s"] = time.perf_counter() - t
    torch.save({"x": x.cpu(), "y": y.cpu(), "aux": aux.cpu(), "dropped": mask.cpu(),
                "y_full": y_full.cpu()}, f"{tmp}/layer.pt")
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["dropped_tokens"] = int(mask.sum())
    del params, p_moe, x, y, y_full, layer
    torch.cuda.empty_cache()
    tcfg = ep_train_config()
    tparams = sharding.rank_params(tcfg, EP_SEED, None, dev)
    with recorded_calls() as train_calls:
        new, _, met = ep_train_step(tcfg, tparams, ep_train_batch(tcfg, dev))
    if not call_launches(train_calls).get("flash_attention_fma"):
        raise AssertionError("ep one rank: the reduced f32 train step launched no FMA kernel")
    torch.save({"params": transformer.tree_map(lambda v: v.cpu(), new),
                "loss": float(met["loss"])}, f"{tmp}/train.pt")
    return out, {"kimi": calls, "kimi_train": train_calls}


def save_rank_calls(path, calls):
    """Rank 0's copies of its recorded calls' inputs ({tag: calls}), on
    the host, for ``merge_rank_calls``."""
    torch.save({tag: {key: dict(args=[a.cpu() if isinstance(a, torch.Tensor) else a
                                      for a in rec["args"]], kw=rec["kw"], live=rec["live"])
                      for key, rec in tc.items()} for tag, tc in calls.items()}, path)


def rank_launches(calls):
    """{tag: {call: launches}} of a rank's recorded calls."""
    return {tag: {key: rec["launches"] for key, rec in tc.items()} for tag, tc in calls.items()}


def ep_rank(rank, tmp, device):
    """One gloo rank of the (data 2, model 2) mesh on the card: kimi-k2's
    experts sharded (its block built alone, ``sharding.rank_params``), its
    data rank's 2 requests through ``ep_serve_run``; the EP MoE layer on
    the one-rank run's layer input (its rows) against the one-rank output
    on the tokens neither run dropped (EP_Y_TOL) and aux (EP_AUX_TOL), and
    at capacity factor 8 and cf2 8 (``ep_nodrop``: a chunk's rows fit
    both capacities) against ``ep_plain`` on every token (EP_Y_TOL);
    ``serve(mesh=)``, the entry point, on a short prompt; then the reduced
    f32 fedsgd step on its block and batch rows against the one-rank step
    (EP_STEP_TOL). The serve run, ``serve`` and
    the train step are recorded under the tags ``kimi_rank``,
    ``kimi_serve`` and ``kimi_train_rank``; rank 0 saves its copies of
    their inputs to ``tmp``/ep_calls.pt. Returns (the rank's report,
    {tag: {call: launches}})."""
    from repro_torch.launch import mesh as rank_mesh
    from repro_torch.models import moe

    dev = torch.device(device)
    mesh = rank_mesh.make_mesh(EP_MESH, ("data", "model"))
    clients = mesh.clients()
    cfg = ep_config()
    mcfg = transformer.moe_config(cfg)
    mesh_lib.TIMING = True
    mesh_lib.reset_stats()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    params = registry.one(sharding.rank_params(cfg, EP_SEED, mesh, dev))
    torch.cuda.synchronize(dev)
    out = dict(coords=dict(mesh.coords), init_s=time.perf_counter() - t,
               params=sum(x.numel() for x in leaves(params)))
    lo, hi = clients.block(EP_REQUESTS)
    tokens = ep_tokens(cfg, dev)[:, lo:hi].contiguous()
    calls = {}
    moe.set_ep_mesh(mesh)
    try:
        t = time.perf_counter()
        run, _, _, calls["kimi_rank"] = ep_serve_run(dev, cfg, params, tokens,
                                                     f"{cfg.name} rank {rank}", copy=rank == 0)
        out["serve_wall_s"] = time.perf_counter() - t
        out.update(run)
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["collectives"] = {k: dict(v) for k, v in mesh_lib.STATS.items()}
        # the EP layer on the one-rank run's layer input; only the MoE
        # block's leaves stay on the card (its view keeps them)
        p_moe = transformer.tree_map(lambda v: v[:, 0], params["blocks"]["l0"]["moe"])
        del params
        torch.cuda.empty_cache()
        saved = torch.load(f"{tmp}/layer.pt", map_location=dev)
        x = saved["x"][:, lo:hi].contiguous()
        with torch.no_grad():
            y, aux = moe.apply_expert_parallel(p_moe, x, mcfg)
            at_cap, at_cap2, mine = moe.ep_dropped(p_moe, x, mcfg)
        want = saved["y"][:, lo:hi]
        held = ~(mine | saved["dropped"][:, lo:hi])
        diff = (y.float() - want.float()).abs()[held]
        largest = float(want.float().abs()[held].max())
        out["layer"] = dict(max_abs_err=float(diff.max()), largest=largest,
                            held=int(held.sum()), tokens=held.numel(),
                            aux_err=float((aux - saved["aux"]).abs().max()),
                            at_cap=int(at_cap.sum()), at_cap2=int(at_cap2.sum()))
        err = out["layer"]["max_abs_err"]
        if not err <= EP_Y_TOL * largest:
            raise AssertionError(f"ep rank {rank}: the EP layer is {err:.4e} from the local "
                                 f"dispatch on held tokens (gate {EP_Y_TOL} of {largest:.4f})")
        if not out["layer"]["aux_err"] <= EP_AUX_TOL:
            raise AssertionError(f"ep rank {rank}: aux {out['layer']['aux_err']:.3e} from the "
                                 f"local dispatch's (gate {EP_AUX_TOL})")
        del y, want, diff
        # every token, nothing dropped
        big = dataclasses.replace(mcfg, capacity_factor=8.0)

        def ep_chunk(xc):
            at_cap8, at_cap28, _ = moe.ep_dropped(p_moe, xc, big, cf2=8.0)
            return (moe.apply_expert_parallel(p_moe, xc, big, cf2=8.0)[0],
                    int(at_cap8.sum()) + int(at_cap28.sum()))

        y8, lost = ep_nodrop(ep_chunk, x)
        want8 = saved["y_full"][:, lo:hi].float()
        largest8 = float(want8.abs().max())
        err8 = (y8.float() - want8).abs()
        out["layer_nodrop"] = dict(max_abs_err=float(err8.max()), largest=largest8,
                                   tokens=x.shape[1] * x.shape[2], dropped=lost,
                                   over=int((err8 > EP_Y_TOL * largest8).any(dim=-1).sum()))
        if lost or not out["layer_nodrop"]["max_abs_err"] <= EP_Y_TOL * largest8:
            raise AssertionError(f"ep rank {rank}: at cf = cf2 = 8 the EP layer dropped {lost} "
                                 f"and is {out['layer_nodrop']['max_abs_err']:.4e} from its "
                                 f"plain version (gate {EP_Y_TOL} of {largest8:.4f}; "
                                 f"{out['layer_nodrop']['over']} tokens over it)")
        del p_moe, saved, x, y8, want8
        torch.cuda.empty_cache()
    finally:
        moe.set_ep_mesh(None)
    # the entry point: serve() on the mesh, a short prompt
    zero_counters()
    with recorded_calls(copy=rank == 0) as calls["kimi_serve"]:
        res = serve_lib.serve(cfg, clients=1, batch=EP_REQUESTS, prompt_len=8, decode_tokens=4,
                              seed=EP_SEED, device=dev, mesh=mesh)
    out["serve"] = dict(prefill_s=res.prefill_s, decode_s=res.decode_s,
                        tokens=res.tokens.cpu().tolist(),
                        launches={k: c.launches for k, c in COUNTERS.items() if c.launches})
    if moe.ep_mesh() is not None or not bool(torch.isfinite(res.logits).all()):
        raise AssertionError(f"ep rank {rank}: serve(mesh=) left the EP mesh set or gave "
                             "non-finite logits")
    del res
    torch.cuda.empty_cache()
    # the reduced EP train step against the one-rank step
    tcfg = ep_train_config()
    tparams = sharding.rank_params(tcfg, EP_SEED, mesh, dev)
    batch = ep_train_batch(tcfg, dev)
    rows = EP_TRAIN_BATCH // clients.shards
    mine = {k: v[clients.rank * rows:(clients.rank + 1) * rows] for k, v in batch.items()}
    moe.set_ep_mesh(mesh)
    try:
        with recorded_calls(copy=rank == 0) as calls["kimi_train_rank"]:
            new, _, met = ep_train_step(tcfg, tparams, mine)
    finally:
        moe.set_ep_mesh(None)
    one = torch.load(f"{tmp}/train.pt", map_location=dev)
    want = sharding.rank_block(one["params"], tcfg, mesh)
    rel = {"/".join(path): float((a - b).norm() / b.norm())
           for path, a, b in zip(pytree.paths(new), leaves(new), leaves(want))}
    out["train"] = dict(worst_rel=max(rel.values()), loss=float(met["loss"]),
                        one_rank_loss=one["loss"], leaves=len(rel))
    if not max(rel.values()) <= EP_STEP_TOL or not abs(float(met["loss"]) - one["loss"]) <= (
            EP_STEP_TOL * abs(one["loss"])):
        raise AssertionError(f"ep rank {rank}: the EP train step is {max(rel.values()):.3e} "
                             f"(L2) from the one-rank step, loss {float(met['loss'])} against "
                             f"{one['loss']} (gate {EP_STEP_TOL})")
    if rank == 0:
        save_rank_calls(f"{tmp}/ep_calls.pt", calls)
    return out, rank_launches(calls)


def gather_batches(cfg, dev):
    """params0 of TRAIN_CLIENTS clients, W (two groups of two) and
    GATHER_STEPS batches, from fixed seeds."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    params0 = train_lib.client_params(cfg, TRAIN_CLIENTS, gen, dev)
    chains = lm_synthetic.make_group_chains(gen, TRAIN_GROUPS, TRAIN_CHAIN_VOCAB)
    batches = [lm_synthetic.federated_lm_batch(gen, chains, TRAIN_CLIENTS, TRAIN_BATCH,
                                               TRAIN_SEQ) for _ in range(GATHER_STEPS)]
    group = torch.arange(TRAIN_CLIENTS, device=dev) % TRAIN_GROUPS
    w = (group[:, None] == group[None, :]).float() + 0.1
    return params0, w / w.sum(dim=1, keepdim=True), batches


def gather_launches(cfg, params):
    """A run's launches: one mix a leaf a step, the tile once a layer a
    step, twice under remat (it recomputes the forward)."""
    return {"flash_attention_prefill": GATHER_STEPS * cfg.num_layers * (2 if cfg.remat else 1),
            "mix_aggregate": GATHER_STEPS * len(leaves(params))}


def gather_run(dev, cfg, params, w, batches, placement=None):
    """GATHER_STEPS user-centric steps; each step's loss and wall."""
    step = steps.build_train_step(cfg, n_clients=TRAIN_CLIENTS, agg="user_centric", lr=TRAIN_LR,
                                  momentum=cfg.momentum, mix_gather_shardings=placement)
    opt = sgd_init(params, momentum=cfg.momentum)
    losses, walls = [], []
    for batch in batches:
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        params, opt, met = step(params, opt, w, batch)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t)
        losses.append(float(met["loss"]))
    return params, losses, walls


def gather_rank(rank, tmp, device):
    """One of GATHER_SHARDS gloo ranks: its clients' rows of the train
    phase's stablelm params and batches, GATHER_STEPS user-centric steps
    with the mix placed over the ranks (``mix_gather_shardings``), against
    the unsharded steps' rows: bit for bit, or each leaf's change within
    STEP_DELTA_TOL (L2) and the losses within it. The steps are recorded
    (tag ``gather_rank``; rank 0 saves its copies of their inputs to
    ``tmp``/gather_calls.pt). Returns (the report, {tag: {call:
    launches}})."""
    dev = torch.device(device)
    cm = mesh_lib.resolve("auto")
    cfg = train_config()
    params0, w, batches = gather_batches(cfg, dev)
    lo, hi = cm.block(TRAIN_CLIENTS)
    mine = transformer.tree_map(lambda x: x[lo:hi].clone(), params0)
    del params0
    batches = [{k: v[lo:hi] for k, v in b.items()} for b in batches]
    mesh_lib.reset_stats()
    zero_counters()
    with recorded_calls(copy=rank == 0) as calls:
        new, losses, walls = gather_run(dev, cfg, mine, w, batches, cm)
    launches = read_counters(f"gather rank {rank}", gather_launches(cfg, mine))
    if rank == 0:
        save_rank_calls(f"{tmp}/gather_calls.pt", {"gather_rank": calls})
    stats = {k: dict(v) for k, v in mesh_lib.STATS.items()}
    # does a row block of the mix give the whole mix's rows' bits (k = 2 against 4)?
    theta = torch.randn(TRAIN_CLIENTS, 1 << 20, generator=torch.Generator(device=dev).manual_seed(
        SEED), device=dev)
    mix_rows_equal = torch.equal(ops.mix_aggregate(w[lo:hi], theta),
                                 ops.mix_aggregate(w, theta)[lo:hi])
    zero_counters()
    want = torch.load(f"{tmp}/gather.pt", map_location="cpu", mmap=True)
    rows = [b[lo:hi].to(dev) for b in leaves(want["params"])]
    same = all(torch.equal(a, b) for a, b in zip(leaves(new), rows))
    rel = {}
    for path, a, b, p0 in zip(pytree.paths(new), leaves(new), rows, leaves(mine)):
        b = b.float()
        rel["/".join(path)] = float((a.float() - b).norm() / (b - p0.float()).norm())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want["losses"]))
    if not (max(rel.values()) <= STEP_DELTA_TOL and loss_rel <= STEP_DELTA_TOL):
        raise AssertionError(f"gather rank {rank}: a leaf's change is {max(rel.values()):.3e} "
                             f"(L2) from the unsharded step's, losses {losses} against "
                             f"{want['losses']} (gate {STEP_DELTA_TOL})")
    return dict(bit_for_bit=same, mix_rows_bit_equal=mix_rows_equal,
                worst_rel=max(rel.values()), loss_rel=loss_rel, losses=losses, walls_s=walls,
                launches=launches, collectives=stats), rank_launches({"gather_rank": calls})


def ep_phase(dev):
    """kimi-k2 served on one rank and under expert parallelism over (data
    2, model 2) gloo ranks sharing the card, the reduced EP train step, and
    the client-sharded stablelm step over 2 ranks; see the module
    docstring. Every kernel call of the phase is recorded, and each run
    gets its kernel rows (``recorded_rows``): tags ``kimi`` (one rank's
    serve run), ``kimi_rank`` (a data rank's), ``kimi_serve``
    (``serve(mesh=)``), ``kimi_train`` and ``kimi_train_rank`` (the reduced
    EP train step on one rank and on a rank), ``gather`` and
    ``gather_rank`` (the stablelm steps unsharded and on a rank), each
    shape held against the plain version, the launches of all ranks
    summed. Returns (the rows, {row: launches})."""
    t0 = time.perf_counter()
    cfg = ep_config()
    device = "cuda:0" if dev.type == "cuda" else "cpu"
    with tempfile.TemporaryDirectory() as tmp:
        one, calls = ep_one_rank(dev, tmp)
        rt = one["routing"]
        print(f"  {cfg.name} ({EP_LAYERS} layers) on one rank: {one['params'] / 1e9:.3f} B "
              f"parameters, init {one['init_s']:.2f} s, peak {one['peak_gb']:.2f} GB; prefill "
              f"{EP_REQUESTS} x {PREFILL_LEN} tokens {one['prefill_s'] * 1e3:.1f} ms (median of "
              f"{EP_PREFILL_REPS}), {one['prefill_tok_s']:.0f} tokens/s; decode "
              f"{one['decode_step_ms']:.2f} ms a step; dropped {one['dropped']} of "
              f"{one['assignments']} assignments ({one['dropped'] / one['assignments']:.4f}), "
              f"{one['dropped_tokens']} tokens (the busiest experts take "
              f"{one['busiest_experts']} of {EP_REQUESTS * PREFILL_LEN} tokens, "
              f"{one['experts_used']} experts get any)", flush=True)
        print(f"  routing: the share of a token's activation common to all tokens (1/N for "
              f"independent ones, N = {EP_REQUESTS * PREFILL_LEN}) by layer "
              f"{json.dumps([{k: round(v, 4) for k, v in r.items()} for r in rt['layers']])}; "
              f"the MoE layer's input {rt['moe_input']:.4f}; the mean logit row carries "
              f"{rt['logit_common_share']:.4f} of the logits' variance over the experts, and "
              f"{rt['hold_mean_top1']:.4f} of the tokens choose its first expert", flush=True)
        print_profiles(f"{cfg.name} one rank", {"prefill step": one["prefill_profile"],
                                                f"{EP_PROFILED} decode steps":
                                                one["decode_profile_4_steps"]})
        torch.cuda.empty_cache()
        ts = time.perf_counter()
        per_rank = mesh_lib.spawn(ep_rank, int(np.prod(EP_MESH)), backend="gloo",
                                  device=device, store_path=f"{tmp}/store_ep", timeout=600,
                                  args=(tmp, device))
        spawn_s = time.perf_counter() - ts
        calls.update(kimi_rank={}, kimi_serve={}, kimi_train_rank={})
        merge_rank_calls(calls, per_rank, f"{tmp}/ep_calls.pt", dev)
        ranks = [rep for rep, _ in per_rank]
        for rank, r in enumerate(ranks):
            coll = {k: f"{v['calls']} calls {v['bytes'] / 1e6:.1f} MB {v['ms']:.1f} ms"
                    for k, v in r["collectives"].items()}
            print(f"  rank {rank} {r['coords']}: {r['params'] / 1e9:.3f} B parameters, init "
                  f"{r['init_s']:.2f} s, peak {r['peak_gb']:.2f} GB; prefill 2 x "
                  f"{PREFILL_LEN} tokens {r['prefill_s'] * 1e3:.1f} ms (busy "
                  f"{r['prefill_profile']['device_busy_ms']:.1f} ms), decode "
                  f"{r['decode_step_ms']:.2f} ms a step (busy over {EP_PROFILED} "
                  f"{r['decode_profile_4_steps']['device_busy_ms']:.1f} ms); dropped at cap "
                  f"{r['dropped']}, at cap2 {r['dropped_cap2']} of {r['assignments']}; "
                  f"collectives {coll}", flush=True)
            ly, nd, tr, sv = r["layer"], r["layer_nodrop"], r["train"], r["serve"]
            print(f"    EP layer against the local dispatch: {ly['max_abs_err']:.4e} on "
                  f"{ly['held']} of {ly['tokens']} tokens held (largest |y| "
                  f"{ly['largest']:.4f}, gate {EP_Y_TOL}), aux {ly['aux_err']:.2e}; at cf = cf2 "
                  f"= 8 in chunks of {EP_NODROP_CHUNK} positions, nothing dropped "
                  f"({nd['dropped']}), {nd['max_abs_err']:.4e} from its plain version "
                  f"(ep_plain) on all {nd['tokens']} tokens (largest |y| "
                  f"{nd['largest']:.4f}); serve(mesh=) prefill "
                  f"{sv['prefill_s']:.2f} s decode {sv['decode_s']:.2f} s {sv['launches']}; "
                  f"reduced EP train step {tr['worst_rel']:.3e} (L2) from the one-rank step, "
                  f"loss {tr['loss']:.6f} / {tr['one_rank_loss']:.6f}", flush=True)
        # the client-sharded train step
        gcfg = train_config()
        params0, w, batches = gather_batches(gcfg, dev)
        zero_counters()
        with recorded_calls() as calls["gather"]:
            new, losses, walls = gather_run(dev, gcfg, params0, w, batches)
        read_counters("gather, unsharded", gather_launches(gcfg, params0))
        torch.save({"params": transformer.tree_map(lambda x: x.cpu(), new), "losses": losses},
                   f"{tmp}/gather.pt")
        del params0, new
        torch.cuda.empty_cache()
        ts = time.perf_counter()
        per_gather = mesh_lib.spawn(gather_rank, GATHER_SHARDS, backend="gloo", device=device,
                                    store_path=f"{tmp}/store_gather", timeout=600,
                                    args=(tmp, device))
        gather_s = time.perf_counter() - ts
        calls["gather_rank"] = {}
        merge_rank_calls(calls, per_gather, f"{tmp}/gather_calls.pt", dev)
        gathered = [rep for rep, _ in per_gather]
    for rank, g in enumerate(gathered):
        coll = {k: f"{v['calls']} calls {v['bytes'] / 1e9:.3f} GB" for k, v in
                g["collectives"].items()}
        print(f"  {gcfg.name} client-sharded, rank {rank}: steps "
              f"{[f'{x * 1e3:.1f}' for x in g['walls_s']]} ms (unsharded "
              f"{[f'{x * 1e3:.1f}' for x in walls]}), losses {g['losses']} / {losses}; "
              f"{'bit for bit' if g['bit_for_bit'] else 'not bit for bit'} the unsharded rows "
              f"(worst change {g['worst_rel']:.3e} L2, loss {g['loss_rel']:.2e}; the mix's "
              f"(2, 4) row block {'is' if g['mix_rows_bit_equal'] else 'is not'} bit for bit "
              f"the (4, 4) mix's rows); launches "
              f"{g['launches']}; collectives {coll}", flush=True)
    per_serve = attention_calls(cfg) * (8 + 4)
    if any(r["serve"]["launches"] != {"flash_attention_decode": per_serve} for r in ranks):
        raise AssertionError(f"ep: serve(mesh=) launched {[r['serve']['launches'] for r in ranks]}"
                             f", not {per_serve} decode-kernel launches a rank")
    rows, launches = {}, {}
    for tag, tc in calls.items():
        got_rows, got_launches = recorded_rows(tag, tc, dev)
        rows.update(got_rows)
        launches.update(got_launches)
    del calls
    for name, r in rows.items():
        finish_row(name, r)
    summary = dict(one_rank={k: v for k, v in one.items() if "profile" not in k},
                   ranks=[{k: v for k, v in r.items() if "profile" not in k and k != "serve"}
                          | {"prefill_busy_ms": r["prefill_profile"]["device_busy_ms"],
                             "decode_busy_ms": r["decode_profile_4_steps"]["device_busy_ms"]}
                          for r in ranks],
                   spawn_s=spawn_s, gather=dict(ranks=gathered, unsharded_losses=losses,
                                                unsharded_walls_s=walls, spawn_s=gather_s),
                   row_launches=launches)
    print("ep_path " + json.dumps(summary))
    phase("ep", t0, f"{cfg.name} ({EP_LAYERS} layers) whole on one rank and over "
          f"{EP_MESH} gloo ranks; the reduced EP train step; {gcfg.name} client-sharded; "
          f"{len(rows)} kernel rows held on the path's inputs")
    return rows, launches


RECORDED_OPS = ("gram", "mix_aggregate", "kmeans_assign", "cohort_gather", "masked_mix_scatter",
                "flash_attention")


def _signature(x):
    return (tuple(x.shape), str(x.dtype)) if isinstance(x, torch.Tensor) else x


@contextlib.contextmanager
def recorded_calls(copy=True):
    """Every call of a kernel op in the block (looked up as ``ops.<name>``
    by its callers) with its launches: yields {(op, shapes, options):
    {"args", "kw", "launches", "live"}}, where "args" are copies of the
    first such call's inputs, taken before the call (the mix-scatter writes
    into ``full``; None without ``copy``, for a run whose calls are only
    counted, and for the ops that ``copy`` does not name where it is a
    tuple of op names), and "launches" the launches of each counter over
    all such calls. A mix-scatter whose mask has no live slot (a buffered round
    that does not flush) writes nothing, so its copy ("live" False) gives
    way to the first later call of that shape with a live slot. On
    leaving, the launches summed over the calls must equal the counters'
    rise over the block: every launch came from a recorded call."""
    calls, ops_before = {}, {n: getattr(ops, n) for n in RECORDED_OPS}
    start = {k: c.launches for k, c in COUNTERS.items()}
    copied = copy if isinstance(copy, tuple) else RECORDED_OPS if copy else ()

    def wrap(name, fn):
        def call(*args, **kw):
            key = (name,) + tuple(_signature(a) for a in args) + tuple(sorted(kw.items()))
            rec = calls.get(key)
            if rec is None:
                rec = calls[key] = dict(args=None, kw=dict(kw), launches={}, live=False)
            if name in copied and not rec["live"]:
                live = name != "masked_mix_scatter" or bool(args[3].any())
                if rec["args"] is None or live:
                    rec["args"] = [a.detach().clone() if isinstance(a, torch.Tensor) else a
                                   for a in args]
                    rec["live"] = live
            before = {k: c.launches for k, c in COUNTERS.items()}
            out = fn(*args, **kw)
            for k, c in COUNTERS.items():
                if c.launches != before[k]:
                    rec["launches"][k] = rec["launches"].get(k, 0) + c.launches - before[k]
            return out
        return call

    for name, fn in ops_before.items():
        setattr(ops, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in ops_before.items():
            setattr(ops, name, fn)
    rose = {k: c.launches - start[k] for k, c in COUNTERS.items() if c.launches != start[k]}
    summed = {}
    for rec in calls.values():
        for k, n in rec["launches"].items():
            summed[k] = summed.get(k, 0) + n
    if summed != rose:
        raise AssertionError(f"recorded calls launched {summed}, the counters rose by {rose}")


def hold_call(name, args, kw, dev):
    """One recorded call's inputs through the kernel and through its plain
    version, each at the tolerance of the kernel phase's row of that
    kernel: a mix by ``check_mix`` (f32 within 1e-5 of the largest output,
    bf16 within a step of each output more), and a few-row mix bit for bit
    the tile route (``hold_mix_bits``); the gather bit for
    bit; k-means labels equal and distances within 1e-5 of the largest;
    attention f32 within 2e-5, bf16 within one bf16 step element by
    element (``check_each``). Returns the error, the kernel's, the plain
    version's and the library call's timing closures, and the call's work
    (``roofline``'s work function of its shape)."""
    label = f"{name} {[tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]}"
    size = args[0].element_size()
    if name == "mix_aggregate":
        w, theta = args
        (k, mm), width = w.shape, theta.shape[1]
        got = ops.mix_aggregate(w, theta, impl="cuda")
        err = check_mix(label, got, ref.mix_aggregate(w, theta))
        hold_mix_bits(label, w, theta, got)
        del got
        return (err, lambda: ops.mix_aggregate(w, theta, impl="cuda"),
                lambda: ref.mix_aggregate(w, theta), lambda: w.to(theta.dtype) @ theta,
                roofline.mix_aggregate_work(k, mm, width, theta.element_size()))
    if name == "masked_mix_scatter":
        w, theta, idx, mask, full = args
        c, width = theta.shape
        real = int(mask.sum())
        live, w_live = idx[mask].long(), w[mask].contiguous()
        want = ref.masked_mix_scatter(w, theta, idx, mask, full)
        err = check(label, ops.masked_mix_scatter(w, theta, idx, mask, full.clone(),
                                                  impl="cuda"), want,
                    1e-5 * float(want.abs().max()))
        scratch = full.clone()
        return (err, lambda: ops.masked_mix_scatter(w, theta, idx, mask, scratch, impl="cuda"),
                lambda: ref.masked_mix_scatter(w, theta, idx, mask, full),
                lambda: scratch.index_copy_(0, live, w_live @ theta),
                roofline.masked_mix_scatter_work(c, width, real, size))
    if name == "cohort_gather":
        full, idx = args
        safe = idx.long().clamp(max=full.shape[0] - 1)
        if not torch.equal(ops.cohort_gather(full, idx, impl="cuda"), ref.cohort_gather(full, idx)):
            raise AssertionError(f"{label}: differs from the plain version")
        return (0.0, lambda: ops.cohort_gather(full, idx, impl="cuda"),
                lambda: ref.cohort_gather(full, idx), lambda: full.index_select(0, safe),
                roofline.cohort_gather_work(idx.numel(), full.shape[1], size, idx.element_size()))
    if name == "gram":
        g, = args
        mm, width = g.shape
        want = ref.gram(g)
        err = check(label, ops.gram(g, impl="cuda"), want, 1e-5 * float(want.abs().max()))
        return (err, lambda: ops.gram(g, impl="cuda"), lambda: ref.gram(g), lambda: g @ g.T,
                roofline.gram_work(mm, width, size))
    if name == "kmeans_assign":
        pts, cents = args
        (mm, f), k = pts.shape, cents.shape[0]
        gl, gd = ops.kmeans_assign(pts, cents, impl="cuda")
        wl, wd = ref.kmeans_assign(pts, cents)
        if not torch.equal(gl, wl):
            raise AssertionError(f"{label}: labels differ from the plain version")
        err = check(label, gd, wd, 1e-5 * float(wd.abs().max()) + 1e-7)
        return (err, lambda: ops.kmeans_assign(pts, cents, impl="cuda"),
                lambda: ref.kmeans_assign(pts, cents),
                lambda: torch.cdist(pts, cents).argmin(dim=1),
                roofline.kmeans_assign_work(mm, k, f))
    if name == "flash_attention":
        q, k, v = args
        opts = {o: kw.get(o) for o in ("window", "softcap")} | {"causal": kw.get("causal", True)}
        with torch.no_grad():
            want = ref.flash_attention(q, k, v, **opts)
            got, _ = flash_call(q, k, v, **opts)
        if q.dtype == torch.float32:
            err = check(label, got, want, 2e-5)
        else:
            check_each(label, got, want)
            err = check(label, got, want, 2.0 ** -6 * float(want.float().abs().max()))
        case = tuple(q.shape[:2]) + (k.shape[1], q.shape[2], k.shape[2], q.shape[3],
                                     opts["causal"], opts["window"], opts["softcap"])
        library = sdpa_library(label, q, k, v, **opts)

        def kernel():
            with torch.no_grad():
                return ops.flash_attention(q, k, v, impl="cuda", **opts)
        return (err, kernel, lambda: ref.flash_attention(q, k, v, **opts), library,
                flash_work(case, q.dtype))
    raise ValueError(f"no plain version to hold {name} against")


SOURCES = {"gram": ("gram.cu", "pairwise_delta.py:41"),
           "mix_aggregate": ("mix_aggregate.cu", "mix_aggregate.py:40"),
           "kmeans_assign": ("kmeans_assign.cu", "kmeans_assign.py:37"),
           "cohort_gather": ("cohort_gather.cu", "masked_gather_mix_scatter.py:93"),
           "masked_mix_scatter": ("masked_mix_scatter.cu", "masked_mix_scatter.py:132, "
                                  "src/repro/kernels/masked_gather_mix_scatter.py:167"),
           "flash_attention": ("flash_attention.cu", "flash_attention.py:88")}


def recorded_rows(tag, calls, dev):
    """The kernel rows of a recorded run: one per kernel counter, named
    ``<counter>_<tag>``, holding every shape the run gave that kernel
    against its plain version on the recorded inputs (``hold_call``), timed
    at the shape that moves the most bytes, with the run's launches of that
    kernel summed over its shapes. Returns (rows, {row: launches})."""
    groups = {}
    for key, rec in calls.items():
        if len(rec["launches"]) != 1:
            raise AssertionError(f"{tag}: a call of {key[:2]} launched {rec['launches']}")
        (counter, n), = rec["launches"].items()
        groups.setdefault(counter, []).append((key[0], rec, n))
    rows, launches = {}, {}
    for counter, group in groups.items():
        held = [(name, rec) + hold_call(name, rec["args"], rec["kw"], dev)
                for name, rec, _ in group]
        name, rec, _, kernel, plain, library, work = max(held, key=lambda h: h[6].bytes)
        source, replaces = SOURCES[name]
        row = f"{counter}_{tag}"
        tensors = [a for a in rec["args"] if isinstance(a, torch.Tensor)]
        rows[row] = dict(
            source=f"src/repro_torch/kernels/csrc/{source}",
            replaces=f"src/repro/kernels/{replaces}", max_abs_err=max(h[2] for h in held),
            ms=time_ms(kernel, dev), plain_ms=time_ms(plain, dev),
            library_ms=None if library is None else time_ms(library, dev),
            # the dtype of the largest argument: the data the kernel streams (θ, not W)
            shape=f"{[list(a.shape) for a in tensors]} "
                  f"{max(tensors, key=lambda a: a.numel()).dtype}, {len(held)} shape(s) held",
            work=work)
        if library is None:
            rows[row]["library_none"] = "SDPA takes no softcap"
        if counter == "gram":
            rows[row]["gram_route"], rows[row]["route_detail"] = gram_route(
                *rec["args"][0].shape, dev)
        if counter == "mix_aggregate":  # every few-row shape was held to the tile route's bits
            rows[row]["mix_route"], rows[row]["route_detail"] = mix_route(*rec["args"])
            rows[row]["tile_bits"] = sum(mix_route(*r["args"])[0] == "rows" for _, r, _ in group)
        launches[row] = sum(n for _, _, n in group)
    return rows, launches


def train_config():
    """stablelm-1.6b at its published widths, cut to TRAIN_LAYERS layers."""
    return dataclasses.replace(configs.get(TRAIN_ARCH), num_layers=TRAIN_LAYERS)


def flash_train_check(dev, cfg):
    """The tile at the train step's shape through ``FlashAttentionFn`` on
    random inputs (:func:`flash_grad_row`). Returns the kernel row
    ``flash_attention_train``."""
    m, b, s = TRAIN_CLIENTS, TRAIN_BATCH, TRAIN_SEQ
    case = (m * b, cfg.num_heads, cfg.num_kv_heads, s, s, cfg.resolved_head_dim)
    q, k, v = flash_inputs(*case, torch.bfloat16, dev, seed=11)
    return flash_grad_row(dev, f"flash {tuple(q.shape)} bf16 causal", q, k, v, causal=True)


def flash_grad_row(dev, label, q, k, v, *, causal, window=None, softcap=None):
    """The tile on (q, k, v) through ``FlashAttentionFn`` (the path
    autograd records): one tile launch, the output within one bf16 step of
    the plain version's, element by element, and the gradients of q, k and
    v, from the Function's backward, against autograd through the plain
    version (P in f32) on the same inputs: bf16 gradients computed from
    the same f32 graph, so within 2^-7 of the largest of each (a rounding
    of the forward output may flip an input's gradient by a step). Timed
    beside the plain version and SDPA; returns the kernel row."""
    opts = dict(causal=causal, window=window, softcap=softcap)
    ins = [x.detach().requires_grad_(True) for x in (q, k, v)]
    before = FLASH_TC.launches
    out = ops.flash_attention(*ins, **opts)
    if FLASH_TC.launches - before != 1 or out.grad_fn is None:
        raise AssertionError(f"{label}: the tile did not run inside FlashAttentionFn")
    plain_in = [x.detach().requires_grad_(True) for x in (q, k, v)]
    want = ref.flash_attention(*plain_in, **opts)
    worst = check_each(f"{label} forward", out.detach(), want.detach())
    g = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(12),
                    device=dev).to(q.dtype)
    got = torch.autograd.grad(out, ins, g)
    exp = torch.autograd.grad(want, plain_in, g)
    errs = [check(f"{label} d{name}", a, e, 2.0 ** -7 * float(e.float().abs().max()))
            for name, a, e in zip("qkv", got, exp)]
    err = float((out.detach().float() - want.detach().float()).abs().max())
    del ins, plain_in, out, want, g, got, exp
    print(f"  {label} through FlashAttentionFn: forward element/allowance {worst:.2f}; grads "
          f"max_abs_err q {errs[0]:.3e}, k {errs[1]:.3e}, v {errs[2]:.3e} against autograd "
          f"through the plain version")
    case = tuple(q.shape[:2]) + (k.shape[1], q.shape[2], k.shape[2], q.shape[3], causal, window,
                                 softcap)
    library = sdpa_library(label, q, k, v, **opts)
    row = dict(source="src/repro_torch/kernels/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:88", max_abs_err=err,
               ms=time_ms(lambda: ops.flash_attention(q, k, v, impl="cuda", **opts), dev),
               plain_ms=time_ms(lambda: ref.flash_attention(q, k, v, **opts), dev),
               library_ms=None if library is None else time_ms(library, dev),
               work=flash_work(case, q.dtype), grad_max_abs_err=max(errs))
    if library is None:
        row["library_none"] = "SDPA takes no softcap"
    return row


def within_group_mass(w, groups):
    """The mean over rows of W's mass on the row's own group (client i in
    group i % groups), and on the others."""
    m = w.shape[0]
    same = torch.tensor([[i % groups == j % groups for j in range(m)] for i in range(m)],
                        device=w.device)
    within = float((w * same).sum(dim=1).mean())
    return within, 1.0 - within


def train_collaboration(dev, cfg, params, gen, chains, *, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                        row="gram_lm", reps=30, reads=True):
    """The collaboration round on real LM gradients at full width: the
    (m, K, d_aligned) bf16 gradients, full gradients (m, d_aligned) f32 and
    σ² in column chunks, Δ by one gram launch on the rows where they lie;
    the tile twice an attention call a partition (remat). Then the gram
    row ``row`` on those rows (``gram_row``: ``reps``, ``reads``)."""
    zero_counters()
    box = {}
    prof = profile(lambda: box.update(collab=train_lib.collaboration(
        cfg, params, gen, chains, batch=batch, seq=seq)), dev, top=10)
    collab, secs = box["collab"], prof["wall_ms"] / 1e3
    print_profiles(f"{cfg.name} collaboration round", {"(profiled)": prof})
    got = read_counters(f"{cfg.name} collaboration", {
        "gram": 1, "flash_attention_prefill": train_lib.PARTS * attention_calls(cfg) * 2})
    full, w = collab["full_grads"], collab["W"]
    m = w.shape[0]
    d = sum(x[0].numel() for x in leaves(params))
    if GRAM.padded != 0 or tuple(full.shape) != (m, ops.aligned_dim(d)) \
            or full.dtype != torch.float32:
        raise AssertionError(f"{cfg.name} collaboration: {GRAM.padded} padded copies, "
                             f"full_grads {tuple(full.shape)} {full.dtype}")
    if not (bool(torch.isfinite(w).all()) and float((w.sum(dim=1) - 1).abs().max()) < 1e-5
            and bool((w >= 0).all())):
        raise AssertionError(f"{cfg.name} collaboration: W is not finite and row-stochastic: {w}")
    within, cross = within_group_mass(w, TRAIN_GROUPS)
    print(f"  collaboration round: K = {train_lib.PARTS} partitions of {batch} x "
          f"{seq} tokens a client, {secs:.2f} s; full_grads {tuple(full.shape)} f32, "
          f"sigma^2 {[round(float(x), 4) for x in collab['sigma_sq']]}; gram launches "
          f"{got['gram']}, padded copies {GRAM.padded}; W within-group mass {within:.3f}, "
          f"cross-group {cross:.3f}")
    print("  W = " + json.dumps([[round(float(x), 4) for x in row] for row in w]))
    gram = gram_row(row, full, d, dev, against_f64=True, reps=reps, reads=reads)
    return collab, dict(seconds=secs, device_busy_ms=prof["device_busy_ms"],
                        idle_share=prof["idle_share"], within_group=within, cross_group=cross,
                        sigma_sq=collab["sigma_sq"].tolist(), W=w.tolist(),
                        launches=got), gram


def train_run(dev, cfg, agg, params, mix, batches):
    """A step of ``agg`` from ``params`` on each batch (the step writes none
    of its inputs, so ``params`` stays as it was), each step's wall time
    synchronized, with its exact launches: one mix a leaf for a mixing agg,
    none for local; the tile twice an attention call (remat recomputes the
    forward), no other kernel. Over more than one step the last loss must
    be below the first."""
    m = leaves(params)[0].shape[0]
    step = steps.build_train_step(cfg, n_clients=m, agg=agg, lr=TRAIN_LR,
                                  momentum=cfg.momentum)
    opt = sgd_init(params, momentum=cfg.momentum)
    nleaves = len(leaves(params))
    losses, walls = [], []
    zero_counters()
    for batch in batches:
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        params, opt, met = step(params, opt, mix, batch)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t)
        losses.append(float(met["loss"]))
    expect = {"flash_attention_prefill": len(batches) * attention_calls(cfg) * 2}
    if agg != "local":
        expect["mix_aggregate"] = len(batches) * nleaves
    got = read_counters(f"{cfg.name} train {agg}", expect)
    if not (all(np.isfinite(losses)) and (len(losses) == 1 or losses[-1] < losses[0])):
        raise AssertionError(f"{cfg.name} train {agg}: losses {losses} are not finite and "
                             f"falling")
    return params, opt, step, dict(losses=losses, step_walls_s=walls, launches=got)


def train_step_agree(dev, cfg, params0, w, batch, *, host=False):
    """One user-centric step with the kernels against the same step with
    the plain attention and the plain mix on the card, from the same
    params, W and batch; the plain step must launch no kernel. Both sides
    compute in bf16 with f32 sums, and an attention output that rounds to
    the neighbouring bf16 value perturbs every later activation and
    gradient, so the two differ by a few per cent of a gradient element
    and, where an update is a fraction of a bf16 step of its param, by a
    step. Held on what the step changed, Δ = params - params0: the loss
    within 1e-3 of itself, and each leaf's |Δ - Δ_plain| (L2) within
    STEP_DELTA_TOL of |Δ_plain| (a wrong rule, a leaf mixed with another's
    or a lost attention gradient is off by about 1), or within twice the
    control's reading on that leaf where that is larger, up to
    STEP_DELTA_CAP. The control is the plain step with P rounded to bf16
    before P·V (``probs_dtype``, the flash phase's control of the tile):
    another rounding of the attention outputs as legitimate as the tile's.
    Where a leaf's gradient is a small sum of large cancelling terms
    (zamba2's conv weights behind its shared attention) any such rounding
    moves it by tens of per cent, and the control's reading says how far.
    Where the control reads 1 or more, the plain change itself is rounding
    noise (whisper's key biases: with no rotary positions a key bias
    shifts all of a query's scores alike, which softmax ignores, so their
    gradient is zero but for rounding): there the kernel step's |Δ| is held
    within twice the larger of |Δ_plain| and the control's |Δ|. With
    ``host`` the kernel step's and the plain step's params wait on the host
    while the next step runs (a step whose peak leaves no room for a second
    set of params). Returns the
    readings, the kernel step's launches and its recorded calls
    (``recorded_calls``; the attention calls' inputs copied)."""
    step = steps.build_train_step(cfg, n_clients=w.shape[0], agg="user_centric", lr=TRAIN_LR,
                                  momentum=cfg.momentum)
    opt = sgd_init(params0, momentum=cfg.momentum)

    def park(tree):
        return transformer.tree_map(lambda x: x.to("cpu"), tree) if host else tree

    def changes(got, want, chunk=2**25):
        """Each leaf's |Δ_got - Δ_want| / |Δ_want| and (|Δ_got|, |Δ_want|)
        (L2), and the elements that differ, over f32 chunks of ``chunk``
        elements (a leaf's f32 copies would not fit beside a step's)."""
        rel, size, differ = {}, {}, 0
        for name, a, b, p0 in zip(pytree.paths(got), leaves(got), leaves(want), leaves(params0)):
            sums = torch.zeros(4, dtype=torch.float64, device=dev)
            a, b, p0 = a.reshape(-1), b.reshape(-1), p0.reshape(-1)
            for c0 in range(0, a.numel(), chunk):
                x, y, z = (t[c0: c0 + chunk].to(dev).float() for t in (a, b, p0))
                sums += torch.stack([(x - y).square().sum().double(),
                                     (y - z).square().sum().double(),
                                     (x - z).square().sum().double(), (x != y).sum().double()])
            num, den, mine, n = sums.tolist()
            num, den, mine = num ** 0.5, den ** 0.5, mine ** 0.5
            key = "/".join(name)
            rel[key] = num / den if den else (0.0 if num == 0 else float("inf"))
            size[key] = (mine, den)
            differ += int(n)
        return rel, size, differ

    zero_counters()
    with recorded_calls(copy=("flash_attention",)) as calls:
        got, _, gm = step(params0, opt, w, batch)
    del _
    launches = read_counters(f"{cfg.name} train step",
                             {"flash_attention_prefill": attention_calls(cfg) * 2,
                              "mix_aggregate": len(leaves(params0))})
    got = park(got)
    kernel = ops.flash_attention, ops.mix_aggregate
    plain_mix = functools.partial(kernel[1], impl="ref")
    sides = {"plain": functools.partial(kernel[0], impl="ref"),
             "control": functools.partial(ref.flash_attention, probs_dtype=torch.bfloat16)}
    want = None
    for side, attend in sides.items():
        torch.cuda.empty_cache()
        zero_counters()
        ops.flash_attention, ops.mix_aggregate = attend, plain_mix
        try:
            res, _, met = step(params0, opt, w, batch)
        finally:
            ops.flash_attention, ops.mix_aggregate = kernel
        del _
        read_counters(f"{cfg.name} train step, the {side} side", {})
        if side == "plain":
            want, wm = park(res), met
            loss_err = abs(float(gm["loss"]) - float(wm["loss"]))
            rel, size, differ = changes(got, want)
            del got
        else:
            control, control_size, _ = changes(res, want)
        del res
    del opt, want
    if not loss_err <= 1e-3 * abs(float(wm["loss"])):
        raise AssertionError(f"{cfg.name} train step: loss {float(gm['loss'])} against the "
                             f"plain path's {float(wm['loss'])}")
    total = sum(x.numel() for x in leaves(params0))
    print("  train step, kernels against the plain path: each leaf's change off the plain "
          "change (L2) " + json.dumps({k: float(f"{v:.3e}") for k, v in rel.items()}))
    print("  the control (the plain step, P rounded to bf16) against the plain path "
          + json.dumps({k: float(f"{v:.3e}") for k, v in control.items()}))
    noise = {k: size[k][0] / max(size[k][1], control_size[k][0])
             for k in rel if control[k] >= 1.0}
    gate = {k: min(max(STEP_DELTA_TOL, 2.0 * control[k]), STEP_DELTA_CAP)
            for k in rel if k not in noise}
    over = {k: (rel[k], g) for k, g in gate.items() if not rel[k] <= g}
    over |= {k: (v, 2.0) for k, v in noise.items() if not v <= 2.0}
    if over:
        raise AssertionError(f"{cfg.name} train step: leaves whose change is off the plain "
                             f"path's past their gate (reading, gate): {over}")
    worst = max(gate, key=lambda k: rel[k])
    print(f"  one user-centric step against the plain attention and mix (which launched no "
          f"kernel): loss {float(gm['loss']):.5f} / {float(wm['loss']):.5f}; the change of a "
          f"leaf at most {rel[worst]:.3e} (L2) off the plain change ({worst}: gate "
          f"{gate[worst]:.3e}, the control {control[worst]:.3e}; STEP_DELTA_TOL "
          f"{STEP_DELTA_TOL}, STEP_DELTA_CAP {STEP_DELTA_CAP}); {differ / total:.2e} of the "
          f"elements differ")
    if noise:
        print("  leaves whose plain change is rounding noise (the control reads 1 or more): "
              "|Δ| over the larger of |Δ_plain| and the control's |Δ|, gate 2: "
              + json.dumps({k: float(f"{v:.3e}") for k, v in noise.items()}))
    return dict(loss_err=loss_err, delta_rel=rel, control_rel=control, noise_leaves=noise,
                differ_share=differ / total), launches, calls


def mix_lm_rows(dev, params, w, centroid_w, *, tag="lm"):
    """The train step's mixes on every leaf width of the trained params, in
    the leaves' storage dtype (the step's own calls: bf16) and on each
    leaf's f32 widening: the kernel against the plain mix (``check_mix``)
    and each few-row call bit for bit against the tile route
    (``hold_mix_bits``), for W (k = m), the 2 centroid rules and the mean
    (k = 1), each W rounded to bf16 as the step rounds it; the rows
    ``mix_aggregate_<tag>_k<k>`` (f32) and ``..._k<k>_bf16`` (one row for
    W and the centroid rules where both have k = 2), each timed over 10
    calls at the widest leaf (stablelm's 205.5 M-wide embedding and head)
    by ``mix_row``. Also every leaf of one user-centric mix
    (``aggregation.user_centric``) against the plain mix rounded to bf16:
    equal or one bf16 step apart. Returns (rows, the leaf widths held)."""
    mm = w.shape[0]
    rules = [rule.to(torch.bfloat16).float() if rule.shape[0] > 1 else rule
             for rule in (w, centroid_w, torch.full((1, mm), 1.0 / mm, device=dev))]
    by_width = {x[0].numel(): x for x in leaves(params)}
    dtypes = list(dict.fromkeys((torch.float32, leaves(params)[0].dtype)))

    def row_name(k, dtype):
        return f"mix_aggregate_{tag}_k{k}" + ("" if dtype == torch.float32 else "_bf16")

    errs, held = {}, 0
    for width, x in sorted(by_width.items()):
        for dtype in dtypes:
            theta = x.reshape(mm, -1).to(dtype)
            for rule in rules:
                name = row_name(rule.shape[0], dtype)
                got = ops.mix_aggregate(rule, theta, impl="cuda")
                err = check_mix(f"{name} d={width}", got, ref.mix_aggregate(rule, theta))
                errs[name] = max(errs.get(name, 0.0), err)
                held += hold_mix_bits(f"{name} d={width}", rule, theta, got)
                del got
            del theta
    rows = {}
    for dtype in dtypes:
        theta = by_width[max(by_width)].reshape(mm, -1).to(dtype)
        for rule in rules:
            name = row_name(rule.shape[0], dtype)
            if name in rows:  # the centroid rules beside W at k = 2: held above, timed once
                continue
            rows[name] = mix_row(name, rule, theta, dev, reps=10)
            rows[name]["max_abs_err"] = errs[name]
            rows[name]["shape"] = (f"[[{rule.shape[0]}, {mm}], [{mm}, {theta.shape[1]}]] "
                                   f"{dtype}, {len(by_width)} leaf widths held")
        del theta
    print(f"  {tag} mixes: {held} few-row calls over {len(by_width)} leaf widths, "
          f"{', '.join(str(t)[6:] for t in dtypes)}, bit for bit the tile route")
    mixed = aggregation.user_centric(params, w.to(torch.bfloat16).float())
    worst = 0.0
    for got, x in zip(leaves(mixed), leaves(params)):
        plain = ref.mix_aggregate(w.to(torch.bfloat16).float(), x.reshape(mm, -1).float())
        plain = plain.to(torch.bfloat16).reshape(got.shape)
        step = 2.0 ** -7 * plain.float().abs()
        worst = max(worst, float(((got.float() - plain.float()).abs() - step).max()))
        del plain, step
    if worst > 0:
        raise AssertionError(f"{tag} mix: a leaf is more than one bf16 step off the plain mix "
                             f"({worst:.3e} past it)")
    print(f"  one user-centric mix: all {len(leaves(params))} leaves within one bf16 step of "
          f"the plain mix")
    return rows, set(by_width)


def mix_row_launches(launches, rows):
    """The train steps' mix launches by row (``mix_aggregate_<tag>_k<k>``):
    the step mixes its leaves in their storage dtype, so where the leaves
    are bf16 their row (``..._bf16``) counts the launches, and the f32 row
    of that k (the same route on the widened leaves, for comparison) none."""
    out = {}
    for name, n in launches.items():
        if f"{name}_bf16" in rows:
            out[f"{name}_bf16"], out[name] = n, 0
        else:
            out[name] = n
    return out


def entry_point_run(dev, argv=("--arch", TRAIN_ARCH, "--smoke", "--rounds", "20"), tag="smoke"):
    """``launch.train.main`` as a user calls it (by default the reduced
    stablelm smoke config, 20 rounds) on the card: its final loss below its
    first. Its kernel calls are recorded and held as rows
    ``<kernel>_<tag>``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), recorded_calls() as calls:
        final = train_lib.main(list(argv))
    text = buf.getvalue()
    first = float(re.search(r"round\s+1 loss=([0-9.]+)", text).group(1))
    if not (np.isfinite(final) and final < first):
        raise AssertionError(f"launch.train.main: final loss {final} is not below the first "
                             f"{first}:\n{text}")
    rows, launches = recorded_rows(tag, calls, dev)
    print(f"  launch.train.main([{' '.join(argv)}]): loss {first:.4f} -> {final:.4f}; launches "
          f"{launches}")
    return dict(first_loss=first, final_loss=final, launches=launches), rows


def ucfl_transformer_run(dev, classes=8, rounds=3):
    """``make_ucfl`` over reduced qwen2-7b with last-token class logits as
    its ``apply_stacked`` (the reference's test_transformer_federated run):
    m = 4, full cohorts; the mean training loss below half its start after
    3 rounds, one mix-scatter launch a round. The kernel calls of the
    whole run (init with its special round, the rounds, the two evals) are
    recorded and held as rows ``<kernel>_ucfl_lm``."""
    cfg = configs.get("qwen2-7b").reduced()

    def apply_stacked(params, x):
        return transformer.forward(params, {"tokens": x}, cfg)[..., -1, :classes]

    gen = torch.Generator(device=dev).manual_seed(SEED)
    params0 = transformer.init(gen, cfg, dev)
    m, nn, seq = 4, 24, 8
    toks = torch.randint(1, cfg.vocab_size, (m, nn + 8, seq), generator=gen, device=dev)
    y = toks[..., -1] % classes
    data = synthetic.FederatedData(toks[:, :nn], y[:, :nn], toks[:, nn:], y[:, nn:],
                                   torch.zeros(m, dtype=torch.int64, device=dev),
                                   torch.full((m,), nn, dtype=torch.int64, device=dev))
    strat = ucfl.make_ucfl(apply_stacked, params0, FedConfig(lr=0.05, momentum=0.9, epochs=1,
                                                             batch_size=12),
                           var_batch_size=12, device=dev)

    def loss_of(state):
        with torch.no_grad():
            logits = apply_stacked(strat.eval_params(state), data.x)
            return float(torch.nn.functional.cross_entropy(logits.reshape(-1, classes),
                                                           data.y.reshape(-1)))

    with recorded_calls() as calls:
        state = strat.init(gen, data)
        loss0 = loss_of(state)
        before = MIX_SCATTER.launches
        for _ in range(rounds):
            state, _ = strat.round(state, data, gen, np.arange(m, dtype=np.int32))
        scatters = MIX_SCATTER.launches - before
        loss1 = loss_of(state)
    if not (loss1 < 0.5 * loss0 and scatters == rounds):
        raise AssertionError(f"ucfl over a transformer slab: loss {loss0} -> {loss1}, "
                             f"{scatters} mix-scatter launches in {rounds} rounds")
    rows, launches = recorded_rows("ucfl_lm", calls, dev)
    print(f"  ucfl over reduced qwen2-7b's slab {tuple(state['params'].shape)}: loss "
          f"{loss0:.4f} -> {loss1:.4f} in {rounds} cohort rounds; launches {launches}")
    return dict(slab=list(state["params"].shape), loss0=loss0, loss1=loss1,
                launches=launches), rows


def train_phase(dev):
    """stablelm-1.6b training at its published widths (depth cut to
    TRAIN_LAYERS), m = 4 clients in 2 groups; see the module docstring."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = train_config()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params0 = train_lib.client_params(cfg, TRAIN_CLIENTS, gen, dev)
    per_client = sum(x[0].numel() for x in leaves(params0))
    chains = lm_synthetic.make_group_chains(gen, TRAIN_GROUPS, TRAIN_CHAIN_VOCAB)
    print(f"  {cfg.name}: {cfg.num_layers} of 24 layers at the published widths, "
          f"{per_client / 1e6:.1f} M parameters a client ({cfg.param_dtype}, remat "
          f"{cfg.remat}), {TRAIN_CLIENTS} clients in {TRAIN_GROUPS} groups, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a client a step, chains over "
          f"{TRAIN_CHAIN_VOCAB} of {cfg.vocab_size:,} tokens")
    rows = {"flash_attention_train": flash_train_check(dev, cfg)}
    collab, out, rows["gram_lm"] = train_collaboration(dev, cfg, params0, gen, chains)
    w = collab["W"]
    del collab
    torch.cuda.empty_cache()
    zero_counters()
    with recorded_calls() as calls:
        km = clustering.kmeans(gen, w, 2)  # 50 iterations and a last assignment
    kmeans = read_counters("train k-means", {"kmeans_assign": 51})["kmeans_assign"]
    km_rows, row_launches = recorded_rows("lm", calls, dev)
    rows.update(km_rows)
    centroid_w = aggregation.centroid_rules(w, km.labels, 2)
    mixes = {"user_centric": w, "clustered": (centroid_w, km.labels), "fedavg": (), "local": ()}
    batches = [lm_synthetic.federated_lm_batch(gen, chains, TRAIN_CLIENTS, TRAIN_BATCH,
                                               TRAIN_SEQ) for _ in range(TRAIN_STEPS)]
    out["kmeans"] = dict(labels=km.labels.tolist(), launches=kmeans)
    out["step_agree"], agree, _ = train_step_agree(dev, cfg, params0, w, batches[0])
    out["runs"] = {}
    flash_launches = out["launches"]["flash_attention_prefill"] + agree["flash_attention_prefill"]
    # every mix of an agg's steps, at every leaf width, counts under its k's row
    mix_launches = {"user_centric": agree["mix_aggregate"], "clustered": 0, "fedavg": 0}
    for agg, mix in mixes.items():
        params, opt, step, run = train_run(dev, cfg, agg, params0, mix, batches)
        flash_launches += run["launches"]["flash_attention_prefill"]
        if agg != "local":
            mix_launches[agg] += run["launches"]["mix_aggregate"]
        tokens = TRAIN_CLIENTS * TRAIN_BATCH * TRAIN_SEQ
        run["step_s"] = statistics.median(run["step_walls_s"][1:])
        run["tokens_per_s"] = tokens / run["step_s"]
        if agg == "user_centric":
            zero_counters()
            prof = profile(lambda: step(params, opt, mix, batches[0]), dev, top=10)
            flash_launches += FLASH_TC.launches
            mix_launches[agg] += MIX.launches
            run["profile"] = prof
            print_profiles(f"{cfg.name} train {agg}", {"step": prof})
            rows.update(mix_lm_rows(dev, params, w, centroid_w)[0])
            keep = transformer.tree_map(lambda x: x[0].clone(), params)
        del params, opt, step
        torch.cuda.empty_cache()
        out["runs"][agg] = run
        print(f"  {agg}: losses {' '.join(f'{x:.4f}' for x in run['losses'])}; step "
              f"{run['step_s'] * 1e3:.1f} ms (median of {TRAIN_STEPS - 1}), "
              f"{run['tokens_per_s']:.0f} tokens/s; launches a step: mix_aggregate "
              f"{run['launches'].get('mix_aggregate', 0) // TRAIN_STEPS}, tile "
              f"{run['launches']['flash_attention_prefill'] // TRAIN_STEPS}")
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"  peak memory {out['peak_gb']:.2f} GB")
    del params0
    torch.cuda.empty_cache()
    out["entry_point"], entry_rows = entry_point_run(dev)
    out["ucfl_transformer"], ucfl_rows = ucfl_transformer_run(dev)
    rows.update(entry_rows | ucfl_rows)
    row_launches.update(out["entry_point"]["launches"] | out["ucfl_transformer"]["launches"])
    for name, r in rows.items():
        finish_row(name, r)
    out["row_launches"] = row_launches | {
        "gram_lm": 1, "flash_attention_train": flash_launches} | mix_row_launches({
            "mix_aggregate_lm_k4": mix_launches["user_centric"],
            "mix_aggregate_lm_k2": mix_launches["clustered"],
            "mix_aggregate_lm_k1": mix_launches["fedavg"]}, rows)
    phase("train", t0, f"{cfg.name} at full width ({cfg.num_layers} layers): the collaboration "
          f"round and {TRAIN_STEPS} steps of each agg, losses falling")
    print("train_path " + json.dumps({k: v for k, v in out.items() if k != "runs"}
                                     | {"runs": {a: {k: v for k, v in r.items() if k != "profile"}
                                                 for a, r in out["runs"].items()}}))
    return out, rows, keep


def dry_cells():
    """(name, config, shape, clients) of the dryrun phase's three steps."""
    serve = configs.get(SERVE_ARCH)
    m, b = SERVE_CLIENTS, SERVE_BATCH
    return [("train", train_config(),
             InputShape("train_dry", TRAIN_SEQ, TRAIN_CLIENTS * TRAIN_BATCH, "train"),
             TRAIN_CLIENTS),
            ("prefill", serve, InputShape("prefill_dry", PREFILL_LEN, m * b, "prefill"), m),
            ("decode", serve, InputShape("decode_dry", PREFILL_LEN, m * b, "decode"), m)]


def dry_materialize(parts, args, dev, gen, vocab):
    """Real tensors on ``dev`` for the meta argument trees of
    ``dryrun.make_step``, each leaf a storage of its own: floats N(0, 0.02²)
    in the leaf's dtype, W softmax rows, momentum zeros, token ids below
    ``vocab``, a cache's positions 0..L−1. Returns (parts, args), the
    same objects where the meta ones were shared."""
    memo = {}

    def real(x, part, key=None):
        if not isinstance(x, torch.Tensor):
            return x
        if id(x) in memo:
            return memo[id(x)]
        if part == "mix" and x.dtype == torch.float32:
            t = torch.softmax(torch.randn(x.shape, generator=gen, device=dev), dim=-1)
        elif part == "opt":
            t = torch.zeros(x.shape, dtype=x.dtype, device=dev)
        elif key == "pos":
            t = torch.arange(x.shape[-1], dtype=x.dtype, device=dev).expand(x.shape).contiguous()
        elif x.dtype.is_floating_point:
            t = torch.empty(x.shape, dtype=x.dtype, device=dev).normal_(0.0, 0.02, generator=gen)
        else:
            t = torch.randint(0, vocab if part != "mix" else x.shape[0], x.shape, generator=gen,
                              device=dev, dtype=x.dtype)
        memo[id(x)] = t
        return t

    def walk(tree, part, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, part, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, part, key) for v in tree)
        return real(tree, part, key)

    real_parts = {name: walk(tree, name) for name, tree in parts.items()}
    real_args = tuple(walk(a, "args") if isinstance(a, (dict, tuple, list))
                      else real(a, "args") for a in args)
    return real_parts, real_args


def dry_cell(dev, name, cfg, shape, m):
    """One dryrun cell: the step counted on meta, then on the card: its
    kernel launches (a recorded run) equal to the counted calls, its aten
    matmul FLOPs under FlopCounterMode equal to the counted ones, the
    arguments' bytes equal, the predicted peak over the measured one in
    DRY_PEAK_RATIO, the roofline's largest term at most the wall, the
    counted FLOPs over the wall times each kind's peak (the mfu) at most 1.
    Returns (readings, the recorded calls)."""
    t = time.perf_counter()
    fn, parts, args = dryrun.make_step(cfg, shape, agg="user_centric", n_clients=m, rows=m)
    ana = dryrun.count_step(fn, parts, args)
    roof = roofline.analyze(ana, cfg, shape, mesh_name="card", chips=1, agg="user_centric",
                            abs_params_one=steps.abstract_params(cfg))
    count_s = time.perf_counter() - t
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    real_parts, real_args = dry_materialize(parts, args, dev, gen, cfg.vocab_size)
    del parts, args
    arg_bytes = sum(x.untyped_storage().nbytes() for x in {
        id(x.untyped_storage()): x for x in op_analysis.tensors(real_parts)}.values())
    if arg_bytes != ana.argument_bytes:
        raise AssertionError(f"dryrun {name}: the arguments hold {arg_bytes} bytes on the card, "
                             f"{ana.argument_bytes} counted")
    torch.cuda.synchronize(dev)
    zero_counters()
    with recorded_calls() as calls:
        out = fn(*real_args)
        torch.cuda.synchronize(dev)
    del out
    launches = {k: c.launches for k, c in COUNTERS.items() if c.launches}
    if launches != ana.kernel_calls:
        raise AssertionError(f"dryrun {name}: the card launched {launches}, the meta run "
                             f"counted {ana.kernel_calls}")
    with FlopCounterMode(display=False) as fc:
        out = fn(*real_args)
    del out
    card_flops = fc.get_total_flops()
    if card_flops != int(ana.aten_flops):
        raise AssertionError(f"dryrun {name}: FlopCounterMode counted {card_flops} FLOPs on the "
                             f"card, the meta run {int(ana.aten_flops)}")
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*real_args)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - before + arg_bytes
    del out
    ratio = ana.peak_bytes / peak
    walls = []
    for _ in range(DRY_WALLS):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = fn(*real_args)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t)
        del out
    wall = statistics.median(walls)
    mfu = roof.mfu(wall)
    r = dict(cell=name, arch=cfg.name, shape=[shape.global_batch, shape.seq_len],
             clients=m, count_s=count_s, dot_flops=ana.dot_flops, aten_flops=ana.aten_flops,
             card_aten_flops=card_flops, flops_by_kind=ana.flops_by_kind,
             hbm_bytes=ana.hbm_bytes, kernel_calls=ana.kernel_calls, launches=launches,
             argument_bytes=arg_bytes, predicted_peak_bytes=ana.peak_bytes,
             measured_peak_bytes=peak, peak_ratio=ratio, compute_s=roof.compute_s,
             memory_s=roof.memory_s, collective_s=roof.collective_s, dominant=roof.dominant,
             useful_flops_ratio=roof.useful_flops_ratio, walls_s=walls, wall_s=wall,
             **{f"{shape.kind}_mfu": mfu})
    print(f"  dryrun {name} ({cfg.name}, {m} clients, {shape.global_batch} x {shape.seq_len}): "
          f"counted {ana.dot_flops:.4e} FLOPs ({ana.aten_flops:.4e} aten, FlopCounterMode on the "
          f"card {card_flops:.4e}; kernels {ana.kernel_flops:.4e}), {ana.hbm_bytes:.4e} bytes "
          f"(unfused), kernel calls {ana.kernel_calls} = launches; arguments {arg_bytes} bytes; "
          f"peak predicted {ana.peak_bytes / 1e9:.3f} GB, measured {peak / 1e9:.3f} GB, ratio "
          f"{ratio:.4f}; compute {roof.compute_s * 1e3:.3f} ms, memory {roof.memory_s * 1e3:.3f} "
          f"ms, dominant {roof.dominant}, useful {roof.useful_flops_ratio:.4f}; wall "
          f"{wall * 1e3:.2f} ms (median of {DRY_WALLS}), {shape.kind}_mfu {mfu:.4f} "
          f"(counted in {count_s:.1f} s)")
    lo, hi = DRY_PEAK_RATIO
    if not lo <= ratio <= hi:
        raise AssertionError(f"dryrun {name}: predicted peak / measured peak {ratio:.4f} outside "
                             f"[{lo}, {hi}]")
    if not roof.bound_s <= wall:
        raise AssertionError(f"dryrun {name}: the roofline's largest term {roof.bound_s:.4e} s "
                             f"exceeds the wall {wall:.4e} s")
    if not mfu <= 1.0:
        raise AssertionError(f"dryrun {name}: {shape.kind}_mfu {mfu:.4f} over 1")
    del real_parts, real_args
    torch.cuda.empty_cache()
    return r, calls


def dryrun_phase(dev):
    """The three dryrun cells (:func:`dry_cell`); the kernel rows of their
    recorded card runs, ``<counter>_dry_<cell>``, each shape held against
    its plain version."""
    t0 = time.perf_counter()
    out, rows, row_launches = {}, {}, {}
    for name, cfg, shape, m in dry_cells():
        out[name], calls = dry_cell(dev, name, cfg, shape, m)
        got, launches = recorded_rows(f"dry_{name}", calls, dev)
        del calls
        rows.update(got)
        row_launches.update(launches)
    for row, r in rows.items():
        finish_row(row, r)
    phase("dryrun", t0, "the train, prefill and decode steps counted on the meta device: kernel "
          "calls, matmul FLOPs and argument bytes exact on the card, peaks within "
          f"{DRY_PEAK_RATIO}, every roofline bound under its wall")
    print("dryrun_path " + json.dumps(out))
    return rows, row_launches


def same_leaf(a, b):
    """Bit for bit: a tensor's values, dtype and device, or a host value."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.device == b.device and a.dtype == b.dtype
                and torch.equal(a, b))
    return type(a) is type(b) and np.array_equal(np.asarray(a), np.asarray(b))


def checkpoint_phase(dev, lm_params):
    """Save and restore, bit for bit, on the card: a LeNet ``ucfl`` state
    with ``RefreshConfig()`` and a buffered ``fedavg`` state
    (``AsyncConfig(flush_k=60)``), each after one cohort round at fraction
    0.5 on scenario 2, and one client's trained LM params; files in a
    temporary directory under build/, deleted afterwards."""
    t0 = time.perf_counter()
    data = synthetic.covariate_label_shift(SEED, device=dev)
    params0 = lenet.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    pcfg = ParticipationConfig(fraction=0.5)
    cohort = participation.sample_cohort(pcfg, 1, data.num_clients)
    trees = {}
    for name, knobs in (("ucfl_refresh", dict(w_refresh=RefreshConfig())),
                        ("fedavg_async", dict(async_buffer=AsyncConfig(flush_k=60)))):
        strat = REGISTRY[name.split("_")[0]](lenet.apply_stacked, params0, FedConfig(**knobs),
                                             device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        state = strat.init(gen, data)
        state, _ = strat.round(state, data, gen, cohort)
        trees[name] = state
    trees["lm_client0"] = lm_params
    out = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for name, tree in trees.items():
            path = os.path.join(tmp, f"{name}.msgpack")
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            checkpoint.save(path, tree)
            save_s = time.perf_counter() - t
            size = os.path.getsize(path)
            t = time.perf_counter()
            back = checkpoint.restore(path, tree)
            torch.cuda.synchronize(dev)
            restore_s = time.perf_counter() - t
            got, want = pytree.leaves(back), pytree.leaves(tree)
            if len(got) != len(want) or not all(same_leaf(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"checkpoint {name}: the restored tree differs")
            out[name] = dict(leaves=len(want), bytes=size, save_s=save_s, restore_s=restore_s)
            print(f"  {name}: {len(want)} leaves, {size / 1e9:.3f} GB, save {save_s:.2f} s, "
                  f"restore {restore_s:.2f} s, bit for bit")
    phase("checkpoint", t0, "three trees saved and restored bit for bit on the card")
    print("checkpoint_path " + json.dumps(out))
    return out


# ------------------------------------------------------------------ family_train
def train_cell_config(cell, layers):
    """The cell's configuration at its published widths, ``layers`` deep
    (None: the published depth; whisper's ``layers`` cuts its decoder and
    its encoder alike), remat on under the cell's policy."""
    cfg = configs.get(cell.arch)
    over = dict(remat=True, remat_policy=cell.remat_policy)
    if layers is not None:
        over["num_layers"] = layers
        if cfg.family == "audio":
            over["encoder_layers"] = layers
    return dataclasses.replace(cfg, **over)


def block_w(m, groups, dev):
    """The two groups' W of the cells without a collaboration round: client
    i in group i % groups, uniform within its group, zero across."""
    g = torch.arange(m, device=dev) % groups
    same = (g[:, None] == g[None, :]).float()
    return same / same.sum(dim=1, keepdim=True)


def train_count(cfg, cell):
    """The cell's user-centric step counted on the meta device
    (``dryrun.make_step`` + ``count_step``)."""
    shape = InputShape("family_train", cell.seq, cell.clients * cell.batch, "train")
    fn, parts, args = dryrun.make_step(cfg, shape, agg="user_centric", n_clients=cell.clients,
                                       rows=cell.clients)
    return dryrun.count_step(fn, parts, args)


def family_batch(cfg, gen, chains, cell, seed):
    """A step's batch: tokens and labels on the groups' chains
    (``lm_synthetic.federated_lm_batch``), with whisper's stub frames or
    the VLM's patch embeddings beside them (``family_inputs``)."""
    b = lm_synthetic.federated_lm_batch(gen, chains, cell.clients, cell.batch, cell.seq)
    return dict(family_inputs(cfg, b["tokens"], seed), labels=b["labels"])


def train_flash_row(cfg, key):
    """The kernel row of a recorded train-step attention call:
    ``flash_attention_train_<family>``, whisper's split by ``audio_part``."""
    (q, _), (k, _), opts = key[1], key[2], dict(key[4:])
    row = f"flash_attention_train_{cfg.name.split('-')[0]}"
    return row + audio_part(cfg, q, k, opts) if cfg.family == "audio" else row


def family_train_cell(dev, cfg, cell):
    """One family_train cell (see the module docstring, phase 16b). Returns
    (readings, kernel rows, {row: launches}, the K-means' recorded calls)."""
    tag = cfg.name.split("-")[0]
    m, b, s = cell.clients, cell.batch, cell.seq
    published = configs.get(cell.arch)
    t0 = time.perf_counter()
    count = train_count(cfg, cell)
    count_s = time.perf_counter() - t0
    param_gen = torch.Generator(device=dev)

    def fresh():  # the clients' start, one init copied to m clients, the same every call
        return train_lib.client_params(cfg, m, param_gen.manual_seed(SEED), dev)

    data = torch.Generator(device=dev).manual_seed(SEED + 1)
    chains = lm_synthetic.make_group_chains(data, TRAIN_GROUPS, TRAIN_CHAIN_VOCAB)
    per_client = sum(x.numel() for x in leaves(steps.abstract_params(cfg)))
    out = dict(arch=cfg.name, layers=cfg.num_layers, published_layers=published.num_layers,
               clients=m, batch=b, seq=s, params_per_client=per_client,
               remat_policy=cfg.remat_policy, counted_step_peak_gb=count.peak_bytes / 1e9,
               counted_kernel_calls=count.kernel_calls, count_s=count_s)
    reckoned = 16 * per_client * m if cell.collaborate else 0
    print(f"  {cfg.name}: {cfg.num_layers} of {published.num_layers} layers at the published "
          f"widths{' (encoder ' + str(cfg.encoder_layers) + ')' if cfg.family == 'audio' else ''}, "
          f"{per_client / 1e9:.3f} B parameters a client ({cfg.param_dtype}, remat "
          f"{cfg.remat_policy}), {m} clients in {TRAIN_GROUPS} groups, {b} x {s} tokens a client "
          f"a step; the step counted on meta: peak {count.peak_bytes / 1e9:.2f} GB, kernel calls "
          f"{count.kernel_calls} ({count_s:.1f} s)")
    if m < 4:  # the step the cell was cut from, counted only (mixtral-8x7b at 4 clients)
        full = train_count(cfg, cell._replace(clients=4))
        out["counted_step_peak_gb_4_clients"] = full.peak_bytes / 1e9
        print(f"  at 4 clients the step counts {full.peak_bytes / 1e9:.2f} GB on meta (not run)")
    if max(count.peak_bytes, reckoned) > FAMILY_TRAIN_PEAK_GB * 1e9:
        raise AssertionError(f"{cfg.name}: the counted step ({count.peak_bytes / 1e9:.2f} GB) or "
                             f"the round's reckoning ({reckoned / 1e9:.2f} GB) passes "
                             f"{FAMILY_TRAIN_PEAK_GB} GB at {cfg.num_layers} layers")
    rows, passes, tile = {}, 0, 0
    parts = out["seconds_by_part"] = {"count": count_s}
    t = time.perf_counter()
    if cell.collaborate:
        torch.cuda.reset_peak_memory_stats(dev)
        collab, out["collaboration"], rows[f"gram_{tag}"] = train_collaboration(
            dev, cfg, fresh(), data, chains, batch=b, seq=s, row=f"gram_{tag}", reps=10,
            reads=False)
        w = collab["W"]
        del collab
        torch.cuda.empty_cache()
        out["collaboration"]["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["collaboration"]["reckoned_gb"] = reckoned / 1e9
        print(f"  collaboration round peak {out['collaboration']['peak_gb']:.2f} GB (gram row "
              f"included), reckoned 16 bytes a parameter a client: "
              f"{out['collaboration']['reckoned_gb']:.2f} GB")
        passes += train_lib.PARTS
        tile += out["collaboration"]["launches"]["flash_attention_prefill"]
    else:
        w = block_w(m, TRAIN_GROUPS, dev)
        within, cross = within_group_mass(w, TRAIN_GROUPS)
        out["W"] = dict(W=w.tolist(), within_group=within, cross_group=cross)
        print(f"  no collaboration round (the reference's launch/train.py takes token batches "
              f"only): W is the groups' block, within-group mass {within:.3f}")
    zero_counters()
    with recorded_calls() as km_calls:
        km = clustering.kmeans(data, w, 2)  # 50 iterations and a last assignment
    out["kmeans"] = dict(labels=km.labels.tolist(), launches=read_counters(
        f"{cfg.name} k-means", {"kmeans_assign": 51})["kmeans_assign"])
    centroid_w = aggregation.centroid_rules(w, km.labels, 2)
    batches = [family_batch(cfg, data, chains, cell, SEED + 9 + i)
               for i in range(FAMILY_TRAIN_STEPS)]
    parts["round_kmeans_batches"], t = time.perf_counter() - t, time.perf_counter()

    # the kernels' step against the plain step; its attention calls recorded
    torch.cuda.reset_peak_memory_stats(dev)
    host = count.peak_bytes + 2 * per_client * m > FAMILY_TRAIN_PEAK_GB * 1e9
    out["step_agree"], agree, step_calls = train_step_agree(dev, cfg, fresh(), w, batches[0],
                                                            host=host)
    out["step_agree"]["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["step_agree"]["kernel_params_on_host"] = host
    if {k: n for k, n in agree.items() if n} != count.kernel_calls:
        raise AssertionError(f"{cfg.name}: the step launched {agree}, the meta count has "
                             f"{count.kernel_calls}")
    passes += 1
    tile += agree["flash_attention_prefill"]
    mix_launches = {f"mix_aggregate_{tag}_k{m}": agree["mix_aggregate"]}
    shapes = {key[2][0][1] for key in step_calls if key[0] == "mix_aggregate"}
    parts["step_agree"], t = time.perf_counter() - t, time.perf_counter()

    out["runs"] = {}
    tokens = m * b * s
    torch.cuda.reset_peak_memory_stats(dev)
    for agg, mix, n in (("user_centric", w, FAMILY_TRAIN_STEPS),
                        ("clustered", (centroid_w, km.labels), 1), ("fedavg", (), 1)):
        params, opt, step, run = train_run(dev, cfg, agg, fresh(), mix, batches[:n])
        k = {"user_centric": m, "clustered": 2, "fedavg": 1}[agg]
        row = f"mix_aggregate_{tag}_k{k}"
        mix_launches[row] = mix_launches.get(row, 0) + run["launches"]["mix_aggregate"]
        passes += n
        tile += run["launches"]["flash_attention_prefill"]
        run["step_s"] = statistics.median(run["step_walls_s"][1:] or run["step_walls_s"])
        run["tokens_per_s"] = tokens / run["step_s"]
        if agg == "user_centric":
            zero_counters()
            prof = profile(lambda: step(params, opt, mix, batches[0]), dev, top=10)
            mix_launches[row] += MIX.launches
            passes += 1
            tile += FLASH_TC.launches
            run["profile"] = prof
            out["step_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            print_profiles(f"{cfg.name} train {agg}", {"step": prof})
            mix_rows, widths = mix_lm_rows(dev, params, w, centroid_w, tag=tag)
            if widths != shapes:
                raise AssertionError(f"{cfg.name}: the step mixed widths {sorted(shapes)}, the "
                                     f"rows held {sorted(widths)}")
            rows.update(mix_rows)
        del params, opt, step
        torch.cuda.empty_cache()
        out["runs"][agg] = run
        print(f"  {agg}: losses {' '.join(f'{x:.4f}' for x in run['losses'])}; step "
              f"{run['step_s'] * 1e3:.1f} ms (median of {max(n - 1, 1)}), "
              f"{run['tokens_per_s']:.0f} tokens/s; launches a step: mix_aggregate "
              f"{run['launches']['mix_aggregate'] // n}, tile "
              f"{run['launches']['flash_attention_prefill'] // n}")
    parts["runs_mix_rows"], t = time.perf_counter() - t, time.perf_counter()
    out["cell_peak_gb"] = max(out["step_peak_gb"], out["step_agree"]["peak_gb"],
                              out.get("collaboration", {}).get("peak_gb", 0.0))
    print(f"  {cfg.name} peaks: step {out['step_peak_gb']:.2f} GB (counted on meta "
          f"{out['counted_step_peak_gb']:.2f} GB), agreement step "
          f"{out['step_agree']['peak_gb']:.2f} GB, cell {out['cell_peak_gb']:.2f} GB")
    if out["cell_peak_gb"] > FAMILY_TRAIN_PEAK_GB:
        raise AssertionError(f"{cfg.name}: the cell's peak {out['cell_peak_gb']:.2f} GB passed "
                             f"{FAMILY_TRAIN_PEAK_GB} GB")

    # the attention calls of the recorded step, each shape with its gradients
    per_pass = {}
    for key, rec in step_calls.items():
        if key[0] == "flash_attention":
            row = train_flash_row(cfg, key)
            per_pass[row] = per_pass.get(row, 0) + rec["launches"]["flash_attention_prefill"]
            q, k, v = rec["args"]
            opts = {o: dict(key[4:]).get(o) for o in ("causal", "window", "softcap")}
            rows[row] = flash_grad_row(dev, f"{row} {tuple(q.shape)} over {k.shape[2]} keys",
                                       q, k, v, **opts)
    parts["flash_rows"] = time.perf_counter() - t
    print(f"  {cfg.name} seconds by part: "
          + json.dumps({k: round(v, 1) for k, v in parts.items()}))
    launches = {row: n * passes for row, n in per_pass.items()}
    if sum(launches.values()) != tile:
        raise AssertionError(f"{cfg.name}: {tile} tile launches, the recorded step's "
                             f"{per_pass} a pass over {passes} passes give {launches}")
    launches.update(mix_row_launches(mix_launches, rows))
    if cell.collaborate:
        launches[f"gram_{tag}"] = 1
    out["row_launches"] = launches
    return out, rows, launches, km_calls


def family_train_phase(dev):
    """Federated training of mamba2-1.3b, zamba2-2.7b, mixtral-8x7b,
    whisper-large-v3 and internvl2-1b at their published widths
    (FAMILY_TRAIN), each built, run and freed before the next; then
    ``launch.train.main`` on the reference's usage line (FAMILY_ENTRY).
    Returns (rows, {row: launches})."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"  family_train starts with {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated")
    out, rows, launches, km_calls = {}, {}, {}, {}
    for cell in FAMILY_TRAIN:
        t = time.perf_counter()
        cfg = train_cell_config(cell, cell.layers)
        cell_out, cell_rows, cell_launches, calls = family_train_cell(dev, cfg, cell)
        gc.collect()
        torch.cuda.empty_cache()
        cell_out["seconds"] = time.perf_counter() - t
        out[cell.arch] = cell_out
        rows.update(cell_rows)
        launches.update(cell_launches)
        merge_calls(km_calls, calls)
        print(f"  {cfg.name} cell: {cell_out['seconds']:.1f} s")
    km_rows, km_launches = recorded_rows("family_train", km_calls, dev)
    rows.update(km_rows)
    launches.update(km_launches)
    out["entry_point"], entry_rows = entry_point_run(dev, FAMILY_ENTRY, "smoke_mamba2")
    rows.update(entry_rows)
    launches.update(out["entry_point"]["launches"])
    for name, r in rows.items():
        finish_row(name, r)
    phase("family_train", t0, "mamba2-1.3b, zamba2-2.7b, mixtral-8x7b, whisper-large-v3 and "
          "internvl2-1b trained at their published widths: collaboration rounds, K-means, "
          "losses falling, exact launches, the kernel step against the plain step")
    print("family_train_path " + json.dumps(
        {a: ({k: v for k, v in r.items() if k != "runs"}
             | {"runs": {g: {k: v for k, v in x.items() if k != "profile"}
                         for g, x in r["runs"].items()}}) if "runs" in r else r
         for a, r in out.items()}))
    return rows, launches


def main():
    dev = device_phase()
    build_phase()
    rows = kernel_phase(dev)
    agree_phase(dev)
    task = full_size_task(dev)
    launches = main_phase(dev, *task)
    cohort = cohort_phase(dev, *task)
    base, rows["gram_trained"] = baselines_phase(dev, *task)
    wire = transport_phase(dev, *task)
    knobs = knobs_phase(dev, *task)
    engine = engine_phase(dev, *task)
    mesh_counts, mesh_rows = mesh_phase(dev, *task)
    rows.update(mesh_rows)
    del task
    fma_launches = serve_agree_phase(dev)
    served = serve_phase(dev)
    family_rows, family_launches = families_agree_phase(dev)
    rows.update(family_rows)
    fam = families_phase(dev)
    ep_rows, ep_counts = ep_phase(dev)
    rows.update(ep_rows)
    trained, train_rows, lm_client = train_phase(dev)
    rows.update(train_rows)
    checkpoint_phase(dev, lm_client)
    del lm_client
    torch.cuda.empty_cache()
    ft_rows, ft_launches = family_train_phase(dev)
    rows.update(ft_rows)
    dry_rows, dry_launches = dryrun_phase(dev)
    rows.update(dry_rows)
    full, k4 = launches["ucfl"], launches["ucfl_k4"]
    # each launch counts under the row of its shape: a dense round mixes
    # over the 100-row slab, a cohort round over its 50 slots' uploads
    k1 = ("fedavg", "fedprox", "scaffold", "ditto", "pfedme")

    def wire_sum(kernel, names):
        return sum(r[kernel] for cell, r in wire.items() if cell.rsplit("_", 1)[0] in names)

    # the transport phase's scaffold gathers its (m, 95,232) EF slab once a round
    wide = wire["scaffold_int8"]["cohort_gather"] // (GATHERS["scaffold"] + 1)
    counts = {"gram": full["gram"] + k4["gram"] + wire_sum("gram", ("ucfl", "ucfl_k4")),
              "mix_aggregate_k100": full["mix_aggregate"] + sum(
                  base[c]["mix_aggregate"] for c in ("oracle", "cfl", "fedfomo")),
              "mix_aggregate_k4": k4["mix_aggregate"],
              "mix_aggregate_k1": sum(base[c]["mix_aggregate"] for c in k1),
              # FedFomo's mix over its 50 slots, and full ucfl's under a quantized wire
              "mix_aggregate_k50": base["fedfomo_half"]["mix_aggregate"]
              + wire_sum("mix_aggregate", ("fedfomo", "ucfl")),
              "mix_aggregate_k1_m50": sum(base[f"{c}_half"]["mix_aggregate"] for c in k1)
              + wire_sum("mix_aggregate", k1),
              "kmeans_assign": k4["kmeans_assign"] + wire_sum("kmeans_assign", ("ucfl_k4",)),
              "cohort_gather": sum(r["cohort_gather"] for r in cohort.values())
              + sum(r["cohort_gather"] for r in base.values())
              + sum(r["cohort_gather"] for r in wire.values()) - wide,
              "cohort_gather_w95232": wide,
              "masked_mix_scatter": sum(r["masked_mix_scatter"] for r in cohort.values())
              + sum(r["masked_mix_scatter"] for r in base.values())
              + sum(r["masked_mix_scatter"] for r in wire.values()),
              "gram_trained": base["fedfomo"]["gram"],
              "gram_m50": base["fedfomo_half"]["gram"] + wire_sum("gram", ("fedfomo",)),
              "flash_attention_prefill": served["prefill_launches"]["flash_attention_prefill"],
              "flash_attention_decode": served["serve_launches"]["flash_attention_decode"],
              "flash_attention_fma": fma_launches}
    # the knobs, engine, train and families phases' launches, each under the
    # row of its shape
    for phase_rows in (knobs, engine, mesh_counts, trained["row_launches"], family_launches,
                       ep_counts, dry_launches, ft_launches,
                       *(f["row_launches"] for f in fam.values())):
        for row, count in phase_rows.items():
            counts[row] = counts.get(row, 0) + count
    # one kernel for both gram rows: the main path runs it at m = 100
    counts["gram_m512"] = counts["gram"]
    # gram_m4 times the few-row route at the slab's width: it counts the
    # main path's launches of that route, those of every other gram row on it
    counts["gram_m4"] = sum(counts[name] for name, r in rows.items()
                            if r.get("gram_route") == "rows" and name != "gram_m4")
    # the cohort and gram rows also carry read_ms, their time after a read
    # flush; the gram rows library_read_ms, the f32 CUDA-core bound and the
    # route their plan took; the mix rows their route, the tile route's time
    # beside a few-row call's and the few-row shapes held to its bits; the
    # rows of a recorded run the shape they were timed at
    extras = ("read_ms", "library_read_ms", "bound_f32_ms", "shape", "library_none",
              "gram_route", "mix_route", "tiles_ms", "tile_bits")
    kernels = [{"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
                "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], **{k: r[k] for k in extras if k in r}}
               for name, r in rows.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
