#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --sweep    # also time other fused-kernel tilings

(``--shard-worker PATH`` is phase 9's two-rank child and ``--mesh-worker
TASK PATH`` phase 14's: the script starts each itself, twice, with the
rank in the environment.)

Phases (each prints its own lines; any failure exits non-zero and prints
no result line):

1. setup     the card's name and power limit; builds the CUDA kernels from
             ``src/repro_torch/csrc`` with nvcc (one process per source,
             all at once) and prints the build time, and the tensor-core
             instructions of the built ``am_matmul`` library
             (``cuobjdump -sass``: IGMMA / HGMMA are wgmma, IMMA / HMMA
             mma.sync; it must hold wgmma of both kinds and no mma.sync).
2. parity    each kernel against its plain torch version on the card, bit
             for bit, at the full width D = 40,960, n = 16: the encoder on
             256 windows of 8,192 tokens (one short, one with an even gram
             count, 40 whose gram counts m straddle the bit-sliced
             counters' plane boundaries 2^k - 1, 2^k, 2^k + 1) and on reads
             of lengths 0, 10, 150, 151 and 300; the fused kernel on 253
             reads (a partial tail tile, even and zero gram counts, m at
             plane boundaries) against 1,001 prototypes, at the default
             tiling, at bb 32 / cluster 2 and at bb 16 / cluster 8; the
             search kernels (``hamming_am``, ``am_matmul_packed``, the bf16
             ``am_matmul``) on 253 queries against the same 1,001
             prototypes, and at a ragged W = 1,001 (the packed entry's
             stages come by cp.async, not TMA), each with a query equal
             to a prototype and one equal to a complement, all equal to
             each other; and at dim != 32 W against their plain versions.
             Then the serving path's cohorts: 256 reads padded to 256 and
             to 2,048 tokens, 56 of them of length 0, through the encoder
             and through the fused kernel at every tiling that fits.
3. main path ``ProfilingSession(..., backend="cuda_fused")`` builds the
             RefDB of a 20 species x 4,000,000 bp synthetic community
             (~9.8k prototypes, ~50 MB) and profiles 32,768 reads of 150 bp,
             with every kernel launch counter set to 0 just before and read
             just after (``species_max`` must count one launch a batch),
             then times ``WARM_RUNS`` more profiles (their median
             is the end-to-end figure; the first run carries first-call
             costs); then each kernel (the species max on the fused
             kernel's agreement of a 256-read batch) is timed and held
             against its plain version at the shapes that run gave it,
             beside its
             bound (and, in the text line, its time before its current design, from PERF.md).
             Then the species max's time alone (``species_max_phase``) at
             the benchmark cells' shapes, 4,096 reads x 121,117 prototypes
             of 31 species and x 29,300 of 20, against its plain
             ``scatter_reduce_``,
             with its byte bound and its share of it.
   search    the same reads through ``cuda_packed`` and ``cuda_matmul``
             sessions against phase 3's RefDB, each with the counters set
             to 0 just before and read just after: the encoder and the
             backend's search kernel must launch, the fused kernel must
             not, and each report must equal phase 3's; ``cuda_matmul``
             must call ``ops.to_pm1`` no time (the rise of
             ``max_memory_allocated`` during each profile is printed); then
             ``WARM_RUNS`` more profiles each, as in phase 3.
             Then ``cuda_fused.agreement`` (``am_matmul_packed``) on 256
             reads against ``classify_batch``, and the search kernels
             timed at the main path's shapes beside ``to_pm1`` and the
             library calls on the pre-expanded +-1 operands (float32 and
             bf16 ``torch.mm``, ``torch._int_mm`` on int8 with S padded
             to a multiple of 8), with each search kernel's tiling (for
             ``am_matmul``'s two entries: M x N a block, ring stages,
             blocks against SMs, shared memory a block, the bytes a
             launch reads, and the packed entry's integer against tensor
             clocks a k32 column).
4. report    a 4 species x 200 kbp community, 2,048 reads: the cuda_fused,
             cuda_packed and cuda_matmul reports and prototypes equal the
             torch ``reference`` backend's on the card.
5. cli       ``python -m repro_torch.launch.profile_run --synthetic`` with
             ``--backend cuda_packed`` and ``--backend cuda_matmul``: both
             exit 0 and write equal report JSONs.
6. serving   at phase 3's width and genomes: ``RefDBRegistry.create``
             through the encoder kernel (its launches counted, prototypes
             equal to phase 3's); a ``ProfilingService`` on ``cuda_fused``
             under 16 requests of 2,048 reads (8 x 150 bp, 4 x 100 bp,
             4 x 1,500 bp: cohorts padded to 128, 256 and 2,048), each
             report equal to a sequential ``profile``, with reads/s and
             p50/p99 latency; a ``TenantRouter`` with two tenants and two
             pump threads, with an add-species delta published mid-traffic
             (each report equal to a sequential profile on the version
             that admitted it); the service load again with metrics on
             and off in turns; one service load and one phase 3 profile
             under ``torch.profiler`` (the device's busy share and its
             top kernels); the tile autotuner at the main path's shape, a tuned session
             against phase 3's report, and tuned cohorts at buckets 2,048
             and 4,096 (also from a cache whose 256-bucket pick is
             bb 32 / cluster 2); and ``serve_profiler --smoke`` on
             ``cuda_packed`` (two tenants, two workers) and ``cuda_matmul``
             in child processes.  Counters are set to 0 just before each
             of the create, service and router runs and read just after.
7. alphabet  alphabets above 4 (the encode kernels' wide path): at
             D = 40,960, n = 16 and A = 5, 8, 20, the encoder on 256
             windows of 8,192 symbols and the fused kernel on 256 reads of
             150 against 9,780 random prototypes (prototype 0 = read 0's
             vector, the last = read 1's complement), and at A = 300 with
             16 windows / 32 reads; each bit-exact against its plain
             version, its ms a launch beside the A = 4 times of phase 3,
             and where its tables sat (shared memory or L2).  Then a
             ``cuda_fused`` session at A = 20 (4 species x 200 kbp of
             symbols in [0, 20) from a seed, 2,048 reads of 150) against a
             torch ``reference`` session: equal prototypes and reports.
8. fleet     phase 3's config and genomes behind a source
             ``RefDBRegistry`` (its create counted: 40 encoder launches)
             and a ``FleetController`` of 3 hosts on the one card: 2
             tenants x 8 requests of 2,048 of phase 3's reads, the busiest
             host killed after a third of the submissions (its live
             requests rerouted), a one-genome add-species delta and a
             two-phase ``fleet_swap`` after two thirds, ``wait_retired``;
             every report (rerouted ones included) equal to a sequential
             ``cuda_fused`` profile on its admitted version, reads/s, p50 /
             p99, the launches (the encoder only for the delta: replication
             copies snapshots) and the ``host`` label on every per-host
             series of the merged metrics; then ``serve_fleet --smoke
             --check`` in a child process.
9. shard     the ``sharded`` backend: at world size 1 (NCCL, this process)
             over bases ``cuda_fused``, ``cuda_packed`` and
             ``cuda_matmul``, and at world size 2 on the one card (gloo
             over CUDA tensors, two ranks started as child processes, base
             ``cuda_fused``, each building the RefDB), phase 3's reads:
             every report equal to phase 3's, with the MB each rank holds
             and the profile time.
10. accel    the device model at phase 3's config, RefDB and reads: the
             Threefry kernel against its plain version in both modes on
             10 M draws and on one bank's full-width programming draws
             (408.9 M uniforms and normals; bits and uniforms bit-exact,
             normals within ``NORMAL_ULP``), and its full-width times
             beside ``torch.randn``; ``pcm_sim`` at preset ``ideal``
             (report equal to phase 3's); ``pcm_sim`` preset ``pcm`` and
             ``racetrack_sim`` preset ``racetrack`` (two profiles with one
             seed identical, another seed's agreement different; batch
             0's read noise held against the plain version at the main
             path's own inputs and timed; reads/s, ms a batch split into
             bmm / noise / rest, fault census, ADC clips, precision and
             recall; counters set to 0 just before each and read just
             after: the encoder and ``threefry`` must launch); a noisy
             session on the card against the CPU (full D, 2 species x
             200 kbp, 256 reads, within the near-exact tolerance);
             ``noise_aware_refdb`` on ``racetrack_sim`` (validated no
             worse than the naive build), and at full D on the small
             community with shift faults, where retraining must change a
             prototype and the card must equal the CPU; and a three-point
             ``noise_sweep`` over ``read_sigma`` on 2,048 reads.
11. baseline the baseline profilers (no kernel of their own): Kraken2-like
             (k = 21), MetaCache-like and CLARK-like (k = 21) built on
             phase 3's community and classifying its 32,768 reads on the
             card (build seconds, a cold and two warm classifies, reads/s,
             precision / recall through Bracken, ``memory_bytes`` beside
             phase 3's RefDB: the paper's ordering RefDB < MetaCache <
             Kraken2 must hold; no kernel may launch); then each built
             and run on the card and on the CPU over phase 4's community
             and reads: tables, hits and categories equal, Bracken
             abundances within ``BRACKEN_ATOL``.
12. lm        the LM stack's serving path: ``launch.serve.serve`` of
             ``stablelm-3b`` at full width (32 layers, d 2,560, MHA,
             2.8 B bf16 parameters drawn through the Threefry kernel,
             which must launch) with 8 prompts of 512 tokens and 32
             decode steps, twice (cold, warm: equal tokens; TF32, set
             on before, must be off after): prefill ms, decode tok/s,
             ``max_memory_allocated``; every Threefry launch of
             ``init_lm`` at its own keys and size, kernel against plain
             version bit for bit; the bf16 model's logits against a
             float32 copy of its weights (``LM_BF16_REL``,
             ``LM_BF16_TOP1``); ``cached_attention`` at the served cache
             and at 32,768 positions (ms, error, no copy of the cache);
             then every smoke architecture in float32 with one set of weights
             on the card and on the CPU: prefill and ``LM_SMOKE_STEPS``
             greedy decode steps, logits within ``LM_TOL``, tokens equal.
13. train    the LM stack's training path: ``launch.train.train`` of
             ``stablelm-3b`` at full width and depth (2.8 B bf16
             parameters drawn through the Threefry kernel, float32 AdamW
             moments) on ``LM_TRAIN_BATCH`` x ``LM_TRAIN_SEQ`` tokens for
             ``LM_TRAIN_STEPS`` steps, remat on: cold and warm step time,
             tokens/s, model FLOP/s (6 N tokens a step) and its share of
             the bf16 peak, ``max_memory_allocated``, every step's loss
             and grad norm (finite); the first step's loss within
             ``LM_TRAIN_BF16_REL`` of a float32 copy's forward loss on the
             same batch; every Threefry launch of its ``init_lm`` kernel
             against plain version bit for bit.  The run saves its
             full-depth state after its last step through its
             ``AsyncCheckpointer`` (a layer at a time to the host, under
             ``build/``, after a check of the free disk space): the rise of
             ``max_memory_allocated`` during the save must stay within twice
             the state's largest tensor; the live state then runs
             ``LM_TRAIN_FULL_MORE`` more steps, and a state restored from
             the files runs them again within ``LM_TRAIN_RESUME_RTOL``
             (seconds and GB on disk printed).  Then a restart at
             ``LM_TRAIN_RESTART_LAYERS`` layers of the same width: 4 steps
             with an ``AsyncCheckpointer`` save at step 2 (under
             ``build/``, deleted after), a fresh trainer restored from it
             reruns steps 2-3 within ``LM_TRAIN_RESUME_RTOL`` of the
             uninterrupted losses (save and restore seconds).  Then every
             smoke architecture in float32 (TF32 off), one set of weights
             through ``LM_TRAIN_SMOKE_STEPS`` train steps on the card and
             on the CPU: losses and grad norms within ``LM_TRAIN_TOL``.
14. mesh     training across ranks (DTensor placements from ``repro``'s
             rules).  14.0: two gloo ranks on the card probe the
             collectives that two-rank DTensor training needs on CUDA
             tensors (all-gather, reduce-scatter, all-to-all, send/recv).
             14.1: phase 13's run again through the mesh path, on a 1 x 1
             ``("data", "model")`` mesh over NCCL (``train(...,
             host_shape=(1, 1))``): its losses equal phase 13's within
             ``MESH_EQUAL_RTOL``; warm step, tokens/s and peak memory
             beside phase 13's (the DTensor path's cost).  14.2: two
             ranks (child processes over NCCL, one card each),
             ``stablelm-3b`` at full width cut to ``MESH_LAYERS`` layers
             on 1 x 2 and 2 x 1 meshes, losses within
             ``MESH_TRAIN_RTOL`` of the single-device run at that depth,
             step time and memory per rank.  14.3: in the same ranks,
             ``pipelined_apply`` over 2 pods against the sequential
             loop, and a checkpoint saved by the 1 x 2 run restored on
             one rank (this process): resumed losses within
             ``MESH_TRAIN_RTOL`` of the uninterrupted run's.  On a
             machine with one card 14.2 and 14.3 wait for two, and the
             line says so with 14.0's findings.  14.4: the dry
             runs, started as CPU children when the script starts
             (``launch.dryrun`` of ``stablelm-3b`` / ``train_4k`` on a
             fake 16 x 16 group at full depth, ``launch.dryrun_hdc`` on
             both meshes): both exit 0; per-device bytes, FLOPs and
             collectives by kind (counts of a fake group, not timings);
             and on this machine's own torch (printed), one after
             another: ``DRYRUN_ARCHS`` (the full configurations that pad
             heads, and mamba2's) at ``DRYRUN_LAYERS`` layers, each exiting
             0, and the SSD prefill under ``DECODE_RULES`` on a 2 x 2 gloo
             CPU mesh (four ranks, ``--prefill-worker``) against one device
             within ``PREFILL_RTOL``.
15. family   the SSD, hybrid and MLA + MoE families at their published
             full width and depth (``FAMILY_ARCHS``: mamba2-1.3b, hymba-1.5b,
             deepseek-v2-lite-16b): ``launch.serve.serve`` with phase 12's
             traffic, twice (equal tokens; prefill ms, decode ms a step,
             tok/s, ``max_memory_allocated``); every Threefry launch of
             ``init_lm`` kernel against plain version bit for bit; the bf16
             prompt logits against a float32 copy of the weights (for
             deepseek over its first ``FAMILY_F32_LAYERS`` layers, with the
             share of tokens each MoE layer routes to another expert set);
             and for the two that fit, ``launch.train.train`` with phase
             13's step (first-step loss against a float32 copy's, finite
             losses and grad norms, warm step, tokens/s, peak memory).

The last lines are the card's name and power limit, one JSON object per
kernel list, one ``[summary]`` line a phase with its headline numbers
(they survive a cut of the output's head), and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Peak rates for the bound.  NVIDIA H100 SXM data sheet (at 700 W): HBM3
#: bandwidth, 989 TFLOP/s dense bf16 (the bf16 am_matmul entry's +-1
#: products) and 1,979 TOP/s dense int8 (the packed am_matmul entry's: +-1
#: products are exact in int8, so bf16's rate is not the least time).  CUDA
#: C++ Programming Guide, arithmetic-instruction throughput table, compute
#: capability 9.0: 32-bit integer add and logic at 64 a clock per SM, for
#: the encode's integer work.  Rates given a clock are taken at the SM
#: clock nvidia-smi reports (clocks.max.sm) times the SM count.
HBM_BYTES_PER_S = 3.35e12
TENSOR_BF16_FLOP_PER_S = 989e12
TENSOR_INT8_OPS_PER_S = 1979e12
INT32_OPS_PER_SM_CLOCK = 64
#: The B x S x D bit agreements of fused_profile and hamming_am, counted
#: as 2 B S D operations (an AND and an add a bit), are priced at the
#: rate the card issues mma.sync m16n8k256 b1 .and.popc: 0.471 a clock
#: per SM, 16 x 8 x 256 bits each (tools/search_mma_probe.py on the
#: NVIDIA H100 80GB HBM3 at 700 W; PERF.md).  No b1 rate is published,
#: and this one is about 4x the 1,979 TOP/s int8 peak, so the int8 rate
#: would not be the least time.
B1_MMA_PER_SM_CLOCK = 0.471
B1_OPS_PER_MMA = 2 * 16 * 8 * 256
#: Integer operations per word-gram of the least encode formulation known:
#: one XOR of the rolling bind (a pair-table word) and one carry-save full
#: adder (two LOP3) of the bit-sliced counting.
ENCODE_OPS_PER_WORD_GRAM = 3
#: Each kernel's time a launch before its current design (chip_smoke,
#: NVIDIA H100 80GB HBM3, 700.00 W; PERF.md's kernel table), printed in the
#: [time] lines beside this run's.
PRIOR_MS = {"hdc_encoder": 1.201, "fused_profile": 0.240,
           "hamming_am": 0.934, "am_matmul_packed": 0.348,
           "am_matmul": 1.074}

#: Integer operations of one Threefry-2x32 pair: 20 rounds of add, rotate
#: (one funnel shift) and xor, and the six key injections (two adds each,
#: the round constant folded into the key word); and per output word the
#: xor of the pair and the shift and or of the float construction.
THREEFRY_OPS_PER_PAIR = 72
THREEFRY_OPS_PER_WORD = 3
#: The stated gap between the Threefry kernel's normals and its plain
#: version's: at most this many float32 ulp (both use the card's
#: ``log1pf``; the plain version's fused steps are emulated in float64).
NORMAL_ULP = 2
#: Near-exact parity of a noisy read between the card and the CPU: the
#: share of agreements that may differ, each by one count (the float32
#: sums of noisy weights run in another order; tests/test_torch_accel.py
#: measured 2.6e-5 of the CPU's against repro's).
NEAR_EXACT_SHARE = 1e-3

GENOME_LEN = 4_000_000
NUM_SPECIES = 20
NUM_READS = 32_768
#: ``profile`` runs timed after each backend's first (cold) one, which
#: carries first-call costs; their median is the end-to-end figure.
WARM_RUNS = 5
#: Phase 11: Bracken's float32 abundances, card against CPU (the sums run
#: in another order).
BRACKEN_ATOL = 1e-5
#: Phase 12: the full-width serve (stablelm-3b: 32 layers, d 2,560, MHA,
#: 2.8 B bf16 parameters) and the card-vs-CPU tolerance of the float32
#: smoke models' logits.
LM_ARCH = "stablelm-3b"
LM_REQUESTS = 8
LM_PROMPT = 512
LM_STEPS = 32
LM_SMOKE_STEPS = 4
LM_TOL = 1e-4
#: The served bf16 model against a float32 copy of its weights: the
#: relative L2 gap of the prompts' logits and the share of positions whose
#: top token agrees.  At smoke width on the CPU, bf16 rounding parts
#: ``repro``'s logits from its float32 copy's by 0.7-1.9 % (5-6 % with
#: MoE routing flips), the port's by as much, with 97-99 % top-1 agreement;
#: stablelm-3b at full width on an H100: 1.79 % and 94.9 %.
LM_BF16_REL = 0.05
LM_BF16_TOP1 = 0.9
#: cached_attention (bf16 out) against a float32 reference: two bf16 ulps
#: at magnitudes 1 to 2.
LM_ATTN_ATOL = 2 ** -6
#: Phase 13: launch.train at stablelm-3b's full width and depth: the
#: serve cell's model, its prompt length as the sequence and its cohort
#: as the batch (8 x 512 tokens a step, one loss chunk of 512); 8 steps,
#: the first carrying first-use costs.
LM_TRAIN_BATCH = 8
LM_TRAIN_SEQ = 512
LM_TRAIN_STEPS = 8
#: The first step's bf16 loss against a float32 copy of the same weights
#: on the same batch (forward only): bf16 rounding moves the loss by a
#: small fraction of its ~11 nats (phase 12: bf16 logits 1.8 % from the
#: float32 copy's in L2, the loss averages that noise out; measured
#: 1.4e-6 on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md).
LM_TRAIN_BF16_REL = 0.01
#: The restart check: stablelm-3b's width at 2 layers (~0.42 B
#: parameters, ~4.2 GB of state on disk) so a save and a restore stay
#: quick; a resumed run's losses against the uninterrupted run's (CUDA
#: reductions need not repeat bit for bit; the CPU test holds equality).
LM_TRAIN_RESTART_LAYERS = 2
LM_TRAIN_RESTART_STEPS = 4
LM_TRAIN_RESTART_AT = 2
LM_TRAIN_RESUME_RTOL = 1e-3
#: The full-depth checkpoint: bytes a parameter of the state on disk (bf16
#: weight, float32 m and v), and the steps run on after it, live and
#: restored.
LM_TRAIN_STATE_BYTES = 10
LM_TRAIN_FULL_MORE = 2
#: Every smoke architecture in float32, card against CPU over 3 train
#: steps: losses and grad norms, relative (float32 sums in another
#: order; phase 12's logits hold 1e-4).
LM_TRAIN_SMOKE_STEPS = 3
LM_TRAIN_TOL = 1e-4


#: Phase 14: training across ranks.  14.1 must repeat phase 13's losses
#: (the same local products on a 1 x 1 mesh; float32 reductions over one
#: rank).  14.2 / 14.3 run stablelm-3b's full width at MESH_LAYERS layers,
#: MESH_STEPS steps of phase 13's batch, two ranks against one device in
#: bf16: tensor-parallel partial sums round in bf16 before they add
#: (measured 5.7e-4 relative on a CPU 2 x 2 mesh at smoke width).
MESH_EQUAL_RTOL = 1e-5
MESH_LAYERS = 4
MESH_STEPS = 4
MESH_TRAIN_RTOL = 1e-3
#: 14.3's pipeline: 2 stages of tanh(x @ w) at stablelm-3b's width,
#: float32 (the same products in the same order: equal up to float32
#: rounding of the device's matmul).
MESH_PIPE_ATOL = 1e-5
#: The collectives two-rank DTensor training and the pipeline run (14.0
#: probes each on gloo over CUDA tensors: what two ranks on one card
#: would have to use, since NCCL takes one rank a card).
MESH_COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor",
                    "all_to_all_single", "send_recv")
#: 14.4 on the card machine's own torch: the full configurations that pad
#: heads to the model axis (starcoder2 36 / 4, hymba 25 / 5, whisper 6 / 6,
#: paligemma 8 / 1 on 16) and mamba2's SSD, each at full width cut to
#: DRYRUN_LAYERS layers (the faults are per layer), as CPU children on a
#: fake 16 x 16 group; and the SSD prefill under DECODE_RULES on a 2 x 2
#: gloo CPU mesh (four ranks) against one device, float32.
DRYRUN_ARCHS = ("starcoder2-7b", "hymba-1.5b", "whisper-tiny",
                "paligemma-3b", "mamba2-1.3b")
DRYRUN_LAYERS = 2
PREFILL_ARCHS = ("mamba2_1_3b", "hymba_1_5b")
PREFILL_RTOL = 1e-4
#: Phase 15: the SSD, hybrid and MLA + MoE families at their published
#: full width and depth, with phase 12's traffic and phase 13's step; the
#: flag says whether the model trains on one card (deepseek-v2-lite's
#: train state, ~12 B a parameter as phase 13 measures, is ~190 GB).
FAMILY_ARCHS = (("mamba2-1.3b", True), ("hymba-1.5b", True),
                ("deepseek-v2-lite-16b", False))
#: A model whose bf16 weights and a float32 copy (6 B a parameter) pass
#: this is compared with its copy over its first FAMILY_F32_LAYERS layers
#: at full width (deepseek-v2-lite: the dense layer and 3 MoE layers).
FAMILY_F32_FIT_BYTES = 60e9
FAMILY_F32_LAYERS = 4
#: The MoE model's bf16 logits against its float32 copy: phase 12's
#: bounds hold (deepseek-v2-lite over its first 4 layers on an NVIDIA H100
#: 80GB HBM3 at 700 W: 4.89 % and 91.1 %, with 5.7 / 9.9 / 13.6 % of the
#: tokens routed to another expert set in its three MoE layers, PERF.md);
#: the flips are printed beside them.
LM_MOE_BF16_REL = LM_BF16_REL
LM_MOE_BF16_TOP1 = LM_BF16_TOP1
#: The attention-free SSD model (mamba2-1.3b, 48 layers) against its
#: float32 copy.  Its gap grows with depth as rounding accumulates in
#: ``repro``'s own precision design (bf16 residual stream, bf16 C.B scores
#: and chunk states): over its first 1 / 4 / 12 / 24 / 48 layers 0.65 /
#: 1.30 / 2.37 / 3.49 / 5.15 % relative, top-1 98.1 / 96.4 / 94.1 / 92.5 /
#: 88.3 % (NVIDIA H100 80GB HBM3, 700 W; PERF.md), where the random
#: weights leave a median top-2 logit margin of 0.14 at a logit spread of
#: 0.9.  Hymba (32 layers, SSD heads beside attention: 3.16 %, 93.2 %)
#: and stablelm hold phase 12's bounds.
LM_SSM_BF16_REL = 0.08
LM_SSM_BF16_TOP1 = 0.85


def say(*parts) -> None:
    print(*parts, flush=True)


#: Each phase's headline numbers, printed together just before the result
#: line (a call keeps only the end of the output).
SUMMARY: dict[str, str] = {}


def note(phase: str, text: str) -> None:
    SUMMARY[phase] = f"{SUMMARY[phase]}; {text}" if phase in SUMMARY \
        else text


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call over ``reps`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def warm_profile(sess, sample, db, want: dict) -> tuple[float, list[float]]:
    """Median and list of ``WARM_RUNS`` back-to-back ``profile`` seconds
    (host clock, after ``synchronize``); each report must equal ``want``."""
    import torch

    secs = []
    for _ in range(WARM_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = sess.profile(sample, refdb=db)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if rep.to_dict() != want:
            fail(f"a warm {sess.config.backend} profile differs from the "
                 f"first")
    return statistics.median(secs), secs


def warm_line(med: float, secs: list[float]) -> str:
    return (f"warm median {med:.3f} s of {len(secs)} "
            f"({' '.join(f'{x:.3f}' for x in secs)}) | "
            f"{NUM_READS / med:.0f} reads/s")


def max_abs_err(got, want) -> int:
    diff = (got.to("cpu").long() - want.to("cpu").long()).abs()
    return int(diff.max()) if diff.numel() else 0


def expect_equal(name: str, got, want) -> int:
    import torch

    if got.shape != want.shape or not torch.equal(got.cpu(), want.cpu()):
        bad = (got.cpu() != want.cpu()).nonzero()
        fail(f"{name}: kernel and plain version differ "
             f"({len(bad)} elements, first at {bad[:1].tolist()})")
    return max_abs_err(got, want)


def encoder_ops(lengths, n: int, w: int) -> int:
    """Integer operations of the valid word-grams of these reads."""
    m = np.maximum(np.asarray(lengths, np.int64) - (n - 1), 0)
    return int(m.sum()) * w * ENCODE_OPS_PER_WORD_GRAM


def bound_ms(nbytes: int, int_ops: int = 0, tensor_ops: int = 0,
             tensor_rate: float = 0.0,
             int_rate: float = 0.0) -> tuple[float, str]:
    """The least time: the largest of the bytes over HBM bandwidth, the
    integer operations over the integer rate and the tensor-core
    operations over their rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(int_ops / int_rate if int_ops else 0.0,
                tensor_ops / tensor_rate if tensor_ops else 0.0)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ulp_gap(got, want, chunk: int = 1 << 26) -> tuple[int, int, float]:
    """``(max ulp, count differing, max absolute error)`` of two float32
    tensors of one shape, a chunk at a time (the int64 ulp distances of a
    full-width draw would take 3.3 GB each)."""
    import torch

    a_all, b_all = got.reshape(-1), want.reshape(-1)
    top = n_diff = 0
    err = 0.0
    for i in range(0, a_all.numel(), chunk):
        a, b = a_all[i:i + chunk], b_all[i:i + chunk]
        if not torch.isfinite(a).all():
            fail("threefry: non-finite draws")
        ulp = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
        top = max(top, int(ulp.max()))
        n_diff += int((ulp > 0).sum())
        err = max(err, float((a - b).abs().max()))
    return top, n_diff, err


def sass_line(lib: str) -> str:
    """The tensor-core instructions in a built library's SASS: wgmma
    (IGMMA integer, HGMMA floating point) against mma.sync (IMMA, HMMA).
    Fails if am_matmul's library lacks either wgmma or holds an mma.sync;
    says so, without failing, where cuobjdump is missing."""
    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return (f"am_matmul SASS: cuobjdump not found beside nvcc or on "
                f"PATH; instructions not counted")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass))
              for op in ("IGMMA", "HGMMA", "IMMA", "HMMA")}
    if min(counts["IGMMA"], counts["HGMMA"]) == 0 \
            or counts["IMMA"] + counts["HMMA"]:
        fail(f"am_matmul SASS holds {counts}: want wgmma (IGMMA, HGMMA) "
             f"and no mma.sync (IMMA, HMMA)")
    return (f"am_matmul SASS ({os.path.basename(lib)}, cuobjdump -sass): "
            f"IGMMA {counts['IGMMA']}, HGMMA {counts['HGMMA']} (wgmma) | "
            f"IMMA {counts['IMMA']}, HMMA {counts['HMMA']} (mma.sync)")


def search_parity(name, q, p, dim, errs) -> None:
    """The search kernels against their plain versions and, at
    dim = 32 W, against each other on packed ``q``/``p`` whose row 0
    equals prototype 0 and row 1 the complement of the last prototype."""
    from repro_torch.kernels import am_matmul, hamming_am, ops

    got_h = hamming_am.hamming_am(q, p, dim=dim)
    errs["hamming_am"] = max(errs["hamming_am"], expect_equal(
        f"hamming_am {name}", got_h, hamming_am.hamming_am_plain(q, p,
                                                                 dim=dim)))
    got_k = am_matmul.am_matmul_packed(q, p, dim=dim)
    errs["am_matmul_packed"] = max(errs["am_matmul_packed"], expect_equal(
        f"am_matmul_packed {name}", got_k,
        am_matmul.am_matmul_packed_plain(q, p, dim=dim)))
    q_pm, p_pm = ops.to_pm1(q), ops.to_pm1(p)
    got_m = am_matmul.am_matmul(q_pm, p_pm, dim=dim)
    errs["am_matmul"] = max(errs["am_matmul"], expect_equal(
        f"am_matmul {name}", got_m, am_matmul.am_matmul_plain(q_pm, p_pm,
                                                              dim=dim)))
    expect_equal(f"am_matmul_packed vs am_matmul {name}", got_k, got_m)
    if dim != 32 * q.shape[1]:
        say(f"[parity] hamming_am, am_matmul_packed and am_matmul == plain "
            f"on {q.shape[0]} queries x {p.shape[0]} prototypes, W = "
            f"{q.shape[1]}, dim = {dim} (bit-exact)")
        return
    expect_equal(f"am_matmul_packed vs hamming_am {name}", got_k, got_h)
    corners = (int(got_h[0, 0]), int(got_h[1, -1]))
    if corners != (dim, 0):
        fail(f"search {name}: equal / complement rows give {corners}, "
             f"want ({dim}, 0)")
    say(f"[parity] hamming_am == am_matmul_packed == am_matmul == plain on "
        f"{q.shape[0]} queries x {p.shape[0]} prototypes, W = {q.shape[1]} "
        f"(bit-exact; equal row {corners[0]}, complement row {corners[1]})")


def with_corner_rows(q, p):
    """``q`` with row 0 = prototype 0 and row 1 = ~(last prototype)."""
    q = q.clone()
    q[0], q[1] = p[0], ~p[-1]
    return q


def run_cli(backend: str, out_dir: str) -> dict:
    """``profile_run --synthetic`` on the card in a child process."""
    path = os.path.join(out_dir, f"profile_run_{backend}.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.profile_run",
           "--synthetic", "--backend", backend, "--json", path]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        fail(f"profile_run --backend {backend} exited {out.returncode}:\n"
             f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith(("backend ", "vs ground truth"))]
    say(f"[cli] {' | '.join(lines)} ({time.perf_counter() - t0:.1f} s "
        f"with start-up)")
    with open(path) as f:
        return json.load(f)


def run_serve_cli(args: list[str]) -> None:
    """``serve_profiler --smoke`` (which implies ``--check``) on the card
    in a child process; a mismatch exits non-zero."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_profiler",
           "--smoke", *args]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        fail(f"serve_profiler {' '.join(args)} exited {out.returncode}:\n"
             f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    lines = [ln.strip() for ln in out.stdout.splitlines()
             if ln.startswith(("backend ", "check OK", "fleet:"))
             or "requests x" in ln]
    say(f"[serve] serve_profiler --smoke {' '.join(args)}: "
        f"{' | '.join(lines)} ({time.perf_counter() - t0:.1f} s with "
        f"start-up)")


def traced_busy(label: str, fn, trace_dir: str, card: str) -> None:
    """Run ``fn`` under ``obs.torch_trace`` and print the device's busy
    share of the wall time (the sum of the trace's kernel events; one
    stream, so they do not overlap) and the kernels that took most of
    it."""
    import torch

    from repro_torch import obs

    torch.cuda.synchronize()
    with obs.torch_trace(trace_dir):
        t0 = time.perf_counter()           # the profiler's start and the
        fn()                               # trace's export stay outside
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f).get("traceEvents", [])
    busy: dict[str, float] = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        short = re.split(r"[<(]", e["name"].replace(
            "(anonymous namespace)::", "").removeprefix("void "))[0]
        short = short.rsplit("::", 1)[-1]
        busy[short] = busy.get(short, 0.0) + e["dur"] / 1e6
    if not busy:
        say(f"[trace] {label}: no kernel events in its torch.profiler "
            f"trace ({len(events)} events); device busy share not measured")
        return
    t_busy = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
    say(f"[trace] {label} under torch.profiler: {wall:.3f} s wall, device "
        f"busy {t_busy:.3f} s = {100 * t_busy / wall:.1f} % (idle "
        f"{100 - 100 * t_busy / wall:.1f} %) | "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in top) + f" | {card}")


def serving_phase(*, config, sample, db, session, main_report, card,
                  out_dir, zero_counts, read_counts) -> None:
    """Phase 6: the serving path at the main path's full width."""
    import dataclasses
    import shutil

    import torch

    from repro_torch import obs
    from repro_torch.core.assoc_memory import window_tokens
    from repro_torch.genomics import synth
    from repro_torch.kernels import autotune, fused_profile
    from repro_torch.pipeline import ArraySource, ProfilingSession
    from repro_torch.serve import (ProfilingService, RefDBRegistry,
                                   TenantRouter)

    # -- 6.1 registry create through the encoder kernel ------------------
    root = os.path.join(out_dir, "refdbs")
    shutil.rmtree(root, ignore_errors=True)
    registry = RefDBRegistry(root=root)
    batches = sum(-(-len(window_tokens(g, config.window,
                                       config.effective_stride)[0])
                    // config.batch_size) for g in sample.genomes.values())
    zero_counts()
    t0 = time.perf_counter()
    snap1 = registry.create("food", sample.genomes, config)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    runs = read_counts()
    say(f"[serve] registry create food:v1 {create_s:.3f} s (snapshot written "
        f"to {os.path.relpath(root, ROOT)}) | launches {json.dumps(runs)}")
    if runs["hdc_encoder"] != batches or runs["fused_profile"] != 0:
        fail(f"registry create launched {runs}, want hdc_encoder {batches} "
             f"(one a 256-window batch) and nothing else")
    if not (torch.equal(snap1.db.prototypes, db.prototypes)
            and torch.equal(snap1.db.proto_species, db.proto_species)):
        fail("registry create: prototypes differ from phase 3's build_refdb")
    say(f"[serve] registry v1 prototypes == phase 3's ({db.num_prototypes} "
        f"rows, bit-exact); {batches} encoder launches")

    # -- 6.2 the service under mixed read lengths ------------------------
    per_request = 2048
    mix = (150, 100, 150, 1500) * 4               # 8 x 150, 4 x 100, 4 x 1500
    t0 = time.perf_counter()
    pools = {}
    for n_len in sorted(set(mix)):
        spec = dataclasses.replace(sample.spec, read_len=n_len)
        _, toks, lens, _, _ = synth.make_sample(
            spec, num_reads=mix.count(n_len) * per_request)
        pools[n_len] = (toks, lens)
    taken = {n_len: 0 for n_len in pools}
    requests = []
    for n_len in mix:
        k = taken[n_len]
        toks, lens = pools[n_len]
        requests.append(ArraySource(toks[k:k + per_request],
                                    lens[k:k + per_request]))
        taken[n_len] = k + per_request
    total = per_request * len(mix)
    say(f"[serve] {len(mix)} requests x {per_request} reads ({total} reads: "
        f"8 x 150 bp, 4 x 100 bp, 4 x 1500 bp; made in "
        f"{time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    sequential = {1: [session.profile(src, refdb=db).to_dict()
                      for src in requests]}
    torch.cuda.synchronize()
    say(f"[serve] sequential profiles of the 16 requests: "
        f"{time.perf_counter() - t0:.3f} s")

    def serve_load(sess, metrics=None) -> tuple[list, ProfilingService,
                                                 float, dict]:
        service = ProfilingService(sess, max_active=8, metrics=metrics)
        zero_counts()
        t_0 = time.perf_counter()
        with service:                  # one background pump thread
            hs = [service.submit(src) for src in requests]
            reps = [h.result(timeout=600) for h in hs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_0
        counts = read_counts()
        if [r.to_dict() for r in reps] != sequential[1]:
            bad = [h.request_id for h, r, w in zip(hs, reps, sequential[1])
                   if r.to_dict() != w]
            fail(f"served reports differ from sequential profiles: {bad}")
        return hs, service, wall, counts

    hs, service, wall_serve, counts = serve_load(session)
    lat = sorted(h.latency_s for h in hs)
    fill = total / (service.cohorts_run * config.batch_size)
    say(f"[serve] ProfilingService cuda_fused, max_active 8: {total} reads "
        f"in {wall_serve:.3f} s | {total / wall_serve:.0f} reads/s | "
        f"latency p50 "
        f"{np.percentile(lat, 50) * 1e3:.1f} ms p99 "
        f"{np.percentile(lat, 99) * 1e3:.1f} ms | {service.cohorts_run} "
        f"cohorts, mean fill {fill:.3f} | launches {json.dumps(counts)} | "
        f"{card}")
    note("6 serving", f"service {total / wall_serve:.0f} reads/s, p50 {np.percentile(lat, 50) * 1e3:.1f} ms p99 {np.percentile(lat, 99) * 1e3:.1f} ms")
    if counts["fused_profile"] != service.cohorts_run \
            or counts["hdc_encoder"] != 0:
        fail(f"service: {counts} for {service.cohorts_run} cohorts, want "
             f"one fused_profile launch a cohort and nothing else")
    say(f"[serve] all {len(hs)} served reports == sequential "
        f"ProfilingSession.profile (bit-exact)")

    # -- 6.3 the router: two tenants, two pumps, a delta mid-traffic -----
    rng = np.random.default_rng(sample.spec.seed + 101)
    delta = {"species_new": rng.integers(0, 4, len(next(iter(
        sample.genomes.values()))), dtype=np.int32)}
    delta_batches = -(-len(window_tokens(
        delta["species_new"], config.window, config.effective_stride)[0])
        // config.batch_size)
    router = TenantRouter(registry)
    for tenant in ("a", "b"):
        router.add_tenant(tenant, database="food", max_active=4,
                          max_queue=16)
    routed = []
    zero_counts()
    t0 = time.perf_counter()
    router.start(workers=2)
    try:
        for i, src in enumerate(requests[:8]):
            routed.append((i, router.submit(src, tenant="ab"[i % 2])))
        deadline = time.monotonic() + 300
        while not any(h.done for _, h in routed):
            if time.monotonic() > deadline:
                fail("router: no request finished within 300 s")
            time.sleep(0.001)
        t_delta = time.perf_counter() - t0
        snap2 = registry.apply_delta("food", add=delta)
        for i, src in enumerate(requests[8:], start=8):
            routed.append((i, router.submit(src, tenant="ab"[i % 2])))
        reps = [(i, h, h.result(timeout=600)) for i, h in routed]
    finally:
        router.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    router.close()
    s2 = ProfilingSession(config)
    s2.adopt_refdb(snap2.db)
    sequential[2] = {}
    bad = []
    for i, h, rep in reps:
        if h.version == 2 and i not in sequential[2]:
            sequential[2][i] = s2.profile(requests[i]).to_dict()
        want = sequential[1][i] if h.version == 1 else sequential[2][i]
        if rep.to_dict() != want:
            bad.append(h.request_id)
    versions = sorted({h.version for _, h, _ in reps})
    say(f"[serve] TenantRouter tenants a, b, workers 2: {total} reads in "
        f"{wall:.3f} s | {total / wall:.0f} reads/s | delta "
        f"+species_new -> v{snap2.version} at t={t_delta:.3f} s "
        f"({router.swaps} swap, retired {router.retired}) | versions "
        f"{versions} | launches {json.dumps(counts)} (read after both "
        f"pumps stopped; the counters are locked) | {card}")
    note("6 serving", f"router {total / wall:.0f} reads/s")
    if bad:
        fail(f"routed reports differ from sequential profiles on their "
             f"admitted versions: {bad}")
    if versions != [1, 2]:
        fail(f"router requests ran on versions {versions}, want [1, 2]")
    if counts["hdc_encoder"] != delta_batches or counts["fused_profile"] < 1:
        fail(f"router phase launched {counts}, want hdc_encoder "
             f"{delta_batches} (the delta) and fused_profile")
    say(f"[serve] all {len(reps)} routed reports == sequential profiles on "
        f"their admitted version ({sum(h.version == 1 for _, h, _ in reps)} "
        f"on v1, {sum(h.version == 2 for _, h, _ in reps)} on v2; "
        f"bit-exact); the delta launched the encoder {delta_batches} times")

    # -- 6.4 metrics on against off, in turns: on, off, on ---------------
    walls = {"off": [wall_serve], "on": []}
    for mode in ("on", "off", "on"):
        if mode == "on":
            reg = obs.enable_metrics()
        try:
            s_obs = ProfilingSession(config)
            s_obs.adopt_refdb(db)
            walls[mode].append(serve_load(s_obs)[2])
        finally:
            obs.disable()
    names = ("serve_reads_classified_total",
             "serve_cohort_padding_rows_total",
             "session_classify_batches_total")
    vals = {k: reg.counter(k).total() for k in names}
    say(f"[serve] metrics on: reports == metrics off (bit-exact) | reads/s "
        f"off {' '.join(f'{total / x:.0f}' for x in walls['off'])}, on "
        f"{' '.join(f'{total / x:.0f}' for x in walls['on'])} | "
        + " | ".join(f"{k} {v:.0f}" for k, v in vals.items()))
    if vals["serve_reads_classified_total"] != total:
        fail(f"serve_reads_classified_total {vals} != {total}")

    # -- 6.4b where the time goes: a service load and a profile, traced ---
    traced_busy("one service load", lambda: serve_load(session),
                os.path.join(out_dir, "serve_trace"), card)
    traced_busy("one cuda_fused profile of the 32,768 150-bp reads",
                lambda: session.profile(sample, refdb=db),
                os.path.join(out_dir, "profile_trace"), card)

    # -- 6.5 the autotuner --------------------------------------------------
    cache = os.path.join(out_dir, "autotune.json")
    if os.path.exists(cache):
        os.unlink(cache)
    t0 = time.perf_counter()
    tiles, cached = autotune.tune(
        config.space, batch=config.batch_size, num_prototypes=db.num_prototypes,
        read_len=150, path=cache)
    key = autotune.cache_key(config.batch_size, config.space.num_words,
                             db.num_prototypes, config.space.dim, 150)
    entry = autotune.load_cache(cache)[key]
    say(f"[tune] {key}: {entry['swept']} feasible tilings timed in "
        f"{time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{k} {v * 1e3:.3f} ms"
                    for k, v in sorted(entry["times_s"].items()))
        + f" | pick bb {tiles['bb']} / cluster {tiles['cluster']} | {card}")
    if cached:
        fail("autotune: the fresh cache reported a hit")
    opts = {"autotune": True, "autotune_cache": cache}
    tuned = ProfilingSession(dataclasses.replace(
        config, backend_options=opts))
    if tuned.profile(sample, refdb=db).to_dict() != main_report:
        fail("the autotuned cuda_fused session's report differs from "
             "phase 3's")
    say(f"[tune] autotune=true session == phase 3's report (tiles "
        f"{tuned.backend.tiles})")
    # A pick cached for 150-token reads (bucket 256), here the widest one
    # that fits there (bb 32 / cluster 2), must not reach a 2,048 cohort.
    poisoned = os.path.join(out_dir, "autotune_poisoned.json")
    autotune.save_cache({key: {"tiles": {"bb": 32, "cluster": 2}}}, poisoned)
    spec = dataclasses.replace(sample.spec, read_len=3000)
    _, t3k, l3k, _, _ = synth.make_sample(spec, num_reads=512)
    long_reads = {1500: ArraySource(pools[1500][0][:512],
                                    pools[1500][1][:512]),
                  3000: ArraySource(t3k, l3k)}
    for cache_file in (cache, poisoned):
        sess = ProfilingSession(dataclasses.replace(
            config, backend_options={"autotune": True,
                                     "autotune_cache": cache_file}))
        sess.adopt_refdb(db)
        service = ProfilingService(sess, max_active=8)
        for n_len, src in long_reads.items():
            h = service.submit(src)
            service.run_until_idle()
            got = h.result(timeout=0).to_dict()
            if got != session.profile(src, refdb=db).to_dict():
                fail(f"autotuned service at {n_len} bp differs from the "
                     f"sequential profile")
        picks = {f"L{b}": t for (_, b), t in sess.backend.tuned.items()}
        for (_, b), t in sess.backend.tuned.items():
            smem = fused_profile.smem_bytes(
                t["bb"], t["cluster"], b, config.space.ngram,
                config.space.alphabet_size, config.space.num_words)
            if smem > fused_profile.MAX_SMEM_BYTES:
                fail(f"autotune picked {t} for bucket {b}: {smem} bytes")
        say(f"[tune] {os.path.basename(cache_file)}: cohorts of 1500 bp "
            f"(bucket 2048) and 3000 bp (bucket 4096) ran == sequential; "
            f"picks per bucket {json.dumps(picks)}")

    # -- 6.6 the serve_profiler CLI -------------------------------------------
    run_serve_cli(["--backend", "cuda_packed", "--tenants", "2",
                   "--workers", "2"])
    run_serve_cli(["--backend", "cuda_matmul"])


def alphabet_phase(*, space, rows, card, zero_counts, read_counts) -> None:
    """Phase 7: alphabets above 4 through both encode kernels, full width."""
    import dataclasses

    import torch

    from repro_torch import convert
    from repro_torch.core import item_memory
    from repro_torch.kernels import fused_profile, hdc_encoder
    from repro_torch.pipeline import (ArraySource, ProfilerConfig,
                                      ProfilingSession)

    dev = torch.device("cuda")
    n, w, dim = space.ngram, space.num_words, space.dim
    a4 = {r["name"]: r["ms"] for r in rows}
    rng = np.random.default_rng(2207)
    protos = convert.words_to_tensor(rng.integers(
        0, 2 ** 32, (9780, w), dtype=np.uint32), dev)
    bb, cl = fused_profile.DEFAULT_BB, fused_profile.DEFAULT_CLUSTER
    for alphabet, b_win, b_read in ((5, 256, 256), (8, 256, 256),
                                    (20, 256, 256), (300, 16, 32)):
        sp = dataclasses.replace(space, alphabet_size=alphabet)
        imr = item_memory.rolled(item_memory.make_item_memory(
            sp, device=dev), n).contiguous()
        tie = item_memory.make_tie_break(sp, device=dev)
        wins = torch.from_numpy(rng.integers(
            0, alphabet, (b_win, 8192)).astype(np.int32)).to(dev)
        wl = np.full(b_win, 8192, np.int32)
        wl[-2:] = [8191, 5000]                 # m = 8176 even; a short one
        wlen = torch.from_numpy(wl).to(dev)
        expect_equal(f"hdc_encoder A={alphabet}",
                     hdc_encoder.hdc_encode(wins, wlen, imr, tie),
                     hdc_encoder.hdc_encode_plain(wins, wlen, imr, tie))
        enc_ms = cuda_time_ms(
            lambda: hdc_encoder.hdc_encode(wins, wlen, imr, tie), reps=5)
        starts = rng.integers(0, 8192 - 150, b_read).tolist()
        qt = torch.stack([wins[i % b_win, s0:s0 + 150]
                          for i, s0 in enumerate(starts)]).contiguous()
        ql = np.full(b_read, 150, np.int32)
        ql[2:5] = [0, 10, 151 - 2]             # empty, m = 0, even m
        qlen = torch.from_numpy(ql).to(dev)
        pair = hdc_encoder.hdc_encode_plain(qt[:2], qlen[:2], imr, tie)
        protos[0], protos[-1] = pair[0], ~pair[1]
        got = fused_profile.fused_profile(qt, qlen, imr, tie, protos,
                                          dim=dim, bb=bb, cluster=cl)
        expect_equal(f"fused_profile A={alphabet}", got,
                     fused_profile.fused_profile_plain(qt, qlen, imr, tie,
                                                       protos, dim=dim))
        corners = (int(got[0, 0]), int(got[1, -1]))
        if corners != (dim, 0):
            fail(f"fused_profile A={alphabet}: equal / complement rows give "
                 f"{corners}, want ({dim}, 0)")
        f_ms = cuda_time_ms(lambda: fused_profile.fused_profile(
            qt, qlen, imr, tie, protos, dim=dim, bb=bb, cluster=cl), reps=10)
        where_e = ("shared memory" if hdc_encoder.shared_tables(8192, n,
                                                                alphabet)
                   else "L2 (global tables)")
        where_f = ("shared memory" if fused_profile.shared_tables(
            bb, cl, 150, n, alphabet, w) else "L2 (global tables)")
        say(f"[alphabet] A={alphabet}: hdc_encoder {b_win} x 8192 == plain, "
            f"{enc_ms:.3f} ms a launch (A = 4, 256 windows: "
            f"{a4['hdc_encoder']:.3f} ms), tables in {where_e} | "
            f"fused_profile {b_read} x 150 vs 9780 at bb {bb} / cluster "
            f"{cl} == plain (equal row {corners[0]}, complement row "
            f"{corners[1]}), {f_ms:.3f} ms a launch (A = 4, 256 reads: "
            f"{a4['fused_profile']:.3f} ms), tables in {where_f} | {card}")

    # A whole session at A = 20 against the torch reference on the card.
    sp20 = dataclasses.replace(space, alphabet_size=20)
    rng = np.random.default_rng(20)
    genomes = {f"species_{i:02d}": rng.integers(0, 20, 200_000).astype(
        np.int32) for i in range(4)}
    names = list(genomes)
    toks = np.zeros((2048, 150), np.int32)
    for r in range(len(toks)):
        g = genomes[names[r % 4]]
        s0 = int(rng.integers(0, len(g) - 150))
        toks[r] = g[s0:s0 + 150]
    lens = np.full(len(toks), 150, np.int32)
    reports, dbs = {}, {}
    for backend in ("cuda_fused", "reference"):
        sess = ProfilingSession(ProfilerConfig(
            space=sp20, window=8192, batch_size=256, backend=backend))
        zero_counts()
        t0 = time.perf_counter()
        dbs[backend] = sess.build_refdb(genomes)
        reports[backend] = sess.profile(ArraySource(toks, lens)).to_dict()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        runs = read_counts()
        if backend == "cuda_fused" and min(runs["hdc_encoder"],
                                           runs["fused_profile"]) < 1:
            fail(f"the A = 20 cuda_fused session skipped a kernel: {runs}")
        say(f"[alphabet] A=20 {backend} session: build + profile "
            f"{secs:.3f} s | launches {json.dumps(runs)}")
    if not torch.equal(dbs["cuda_fused"].prototypes,
                       dbs["reference"].prototypes):
        fail("A = 20: cuda_fused prototypes differ from the reference's")
    rep = reports["reference"]
    if reports["cuda_fused"] != rep:
        fail("A = 20: the cuda_fused report differs from the reference's")
    if rep["unmapped_reads"] >= rep["total_reads"]:
        fail("A = 20: no read mapped")
    say(f"[alphabet] A=20 cuda_fused == reference on the card: "
        f"{dbs['reference'].num_prototypes} prototypes, "
        f"{rep['total_reads']} reads, unmapped {rep['unmapped_reads']}, "
        f"multi {rep['multi_reads']}")
    note("7 alphabet", "A = 20 cuda_fused == reference")


def fleet_phase(*, config, sample, db, card, zero_counts,
                read_counts) -> None:
    """Phase 8: a fleet of 3 hosts on the one card, full width."""
    import torch

    from repro_torch.core.assoc_memory import window_tokens
    from repro_torch.pipeline import ArraySource, ProfilingSession
    from repro_torch.serve import FleetController, RefDBRegistry
    from repro_torch.serve.fleet import HostState

    def encoder_batches(genomes) -> int:
        return sum(-(-len(window_tokens(g, config.window,
                                        config.effective_stride)[0])
                     // config.batch_size) for g in genomes.values())

    source = RefDBRegistry(root=None)
    zero_counts()
    t0 = time.perf_counter()
    snap1 = source.create("food", sample.genomes, config)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    runs = read_counts()
    if runs["hdc_encoder"] != encoder_batches(sample.genomes) \
            or runs["fused_profile"] != 0:
        fail(f"source registry create launched {runs}")
    if not torch.equal(snap1.db.prototypes, db.prototypes):
        fail("source registry create: prototypes differ from phase 3's")
    say(f"[fleet] source registry create food:v1 {create_s:.3f} s | "
        f"launches {json.dumps(runs)} | prototypes == phase 3's")

    per_request, total = 2048, 16
    requests = [ArraySource(sample.tokens[i * per_request:
                                          (i + 1) * per_request],
                            sample.lengths[i * per_request:
                                           (i + 1) * per_request])
                for i in range(total)]
    rng = np.random.default_rng(sample.spec.seed + 202)
    delta = {"species_fleet": rng.integers(0, 4, GENOME_LEN, dtype=np.int32)}
    fleet = FleetController(source, hosts=3)
    for tenant in ("tenant0", "tenant1"):
        fleet.add_tenant(tenant, "food", max_active=2, max_queue=total)
    handles, killed, rerouted, snap2 = [], None, [], None
    zero_counts()
    t0 = time.perf_counter()
    with fleet:
        for i, src in enumerate(requests):
            if i == total // 3:                # kill the busiest host
                live: dict[str, int] = {}
                for h in handles:
                    if not h.done:
                        live[h.host] = live.get(h.host, 0) + 1
                healthy = [hid for hid in live
                           if fleet.host(hid).state is HostState.HEALTHY]
                killed = (max(healthy, key=live.get) if healthy
                          else fleet.healthy_hosts()[0])
                rerouted = fleet.kill_host(killed)
                say(f"[fleet] killed {killed} after {i} submissions (live "
                    f"{json.dumps(live)}); rerouted {len(rerouted)}: "
                    f"{' '.join(rerouted) or '(none in flight)'}")
            if i == 2 * total // 3:            # delta + two-phase swap
                snap2 = source.apply_delta("food", add=delta)
                fleet.fleet_swap("food", version=snap2.version)
                say(f"[fleet] fleet swap v1 -> v{snap2.version} after {i} "
                    f"submissions ({len(fleet.healthy_hosts())} healthy "
                    f"hosts)")
            handles.append(fleet.submit(src, tenant=f"tenant{i % 2}",
                                        request_id=f"req-{i}"))
        reports = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t_ret = time.perf_counter()
        fleet.wait_retired("food", 1, timeout=300)
        retire_s = time.perf_counter() - t_ret
        merged = fleet.metrics_snapshot().snapshot()
    counts = read_counts()
    fleet.close()
    sessions, bad = {}, []
    for h, src, rep in zip(handles, requests, reports):
        if h.version not in sessions:
            sess = ProfilingSession(config)
            sess.adopt_refdb(source.snapshot("food", h.version).db)
            sessions[h.version] = sess
        if rep.to_dict() != sessions[h.version].profile(src).to_dict():
            bad.append(h.request_id)
    if bad:
        fail(f"fleet reports differ from sequential cuda_fused profiles on "
             f"their admitted versions: {bad}")
    delta_batches = encoder_batches(delta)
    if counts["hdc_encoder"] != delta_batches or counts["fused_profile"] < 1:
        fail(f"fleet launched {counts}, want hdc_encoder {delta_batches} "
             f"(the delta alone: replication copies snapshots) and "
             f"fused_profile")
    unlabeled = [name for kind in ("counters", "gauges", "histograms")
                 for name, m in merged.get(kind, {}).items()
                 if not name.startswith("fleet_")
                 for series in m["series"] if "host" not in series["labels"]]
    if unlabeled:
        fail(f"merged fleet metrics: series without a host label in "
             f"{sorted(set(unlabeled))}")
    n_series = sum(len(m["series"]) for kind in ("counters", "gauges",
                                                 "histograms")
                   for name, m in merged.get(kind, {}).items()
                   if not name.startswith("fleet_"))
    lat = sorted(h._attempts[-1][1].latency_s for h in handles)
    reads = per_request * total
    by_host: dict[str, int] = {}
    for h in handles:
        by_host[h.host] = by_host.get(h.host, 0) + 1
    say(f"[fleet] 3 hosts, 2 tenants x 8 requests of {per_request} reads: "
        f"{reads} reads in {wall:.3f} s | {reads / wall:.0f} reads/s | "
        f"latency p50 {np.percentile(lat, 50) * 1e3:.1f} ms p99 "
        f"{np.percentile(lat, 99) * 1e3:.1f} ms | reroutes "
        f"{sum(h.rerouted for h in handles)} | placement "
        f"{json.dumps(dict(sorted(by_host.items())))} | versions "
        f"{sorted({h.version for h in handles})} | retire "
        f"{retire_s * 1e3:.1f} ms | launches {json.dumps(counts)} | {card}")
    note("8 fleet", f"{reads / wall:.0f} reads/s, p99 {np.percentile(lat, 99) * 1e3:.1f} ms, reroutes {sum(h.rerouted for h in handles)}")
    say(f"[fleet] all {total} reports (rerouted ones included) == "
        f"sequential cuda_fused profiles on their admitted versions; "
        f"encoder launched {delta_batches} times (the delta alone); "
        f"{n_series} per-host metric series, each with a host label")
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_fleet", "--smoke",
           "--check", "--backend", "cuda_fused"]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        fail(f"serve_fleet --smoke --check exited {out.returncode}:\n"
             f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    lines = [ln.strip() for ln in out.stdout.splitlines()
             if ln.startswith(("fleet:", "check OK", "killed"))]
    say(f"[fleet] serve_fleet --smoke --check --backend cuda_fused: "
        f"{' | '.join(lines)} ({time.perf_counter() - t0:.1f} s with "
        f"start-up)")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def shard_phase(*, config, sample, db, main_report, card, out_dir,
                zero_counts, read_counts) -> None:
    """Phase 9: the sharded backend at world sizes 1 and 2."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.pipeline import ProfilingSession, per_device_bytes

    kernels = {"cuda_fused": "fused_profile", "cuda_packed": "hamming_am",
               "cuda_matmul": "am_matmul_packed"}
    first = " (the group's first collective included)"
    for i, (base, kernel) in enumerate(kernels.items()):
        sess = ProfilingSession(dataclasses.replace(
            config, backend="sharded", backend_options={"base": base}))
        sess.adopt_refdb(db)
        zero_counts()
        t0 = time.perf_counter()
        rep = sess.profile(sample)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        runs = read_counts()
        if rep.to_dict() != main_report:
            fail(f"sharded (world size 1, base {base}) report differs from "
                 f"phase 3's")
        if runs[kernel] < 1:
            fail(f"sharded base {base} did not launch {kernel}: {runs}")
        med, warm = warm_profile(sess, sample, sess.refdb, main_report)
        say(f"[shard] world size 1 ({sess.backend.mesh.backend}), base "
            f"{base}: profile {secs:.3f} s cold{first if i == 0 else ''}, "
            f"{warm_line(med, warm)} | "
            f"{per_device_bytes(db, 1) / 1e6:.1f} MB per device | launches "
            f"{json.dumps(runs)} | report == phase 3's | {card}")
    if dist.is_initialized():
        dist.destroy_process_group()

    world = 2
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(world)}
    paths = [os.path.join(out_dir, f"shard_rank{r}.json")
             for r in range(world)]
    for path in paths:
        if os.path.exists(path):
            os.unlink(path)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard-worker",
         paths[r]], cwd=ROOT, env={**env, "RANK": str(r),
                                   "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"shard rank {r} exited {p.returncode}:\n{log[-3000:]}")
    outs = []
    for path in paths:
        with open(path) as f:
            outs.append(json.load(f))
    for out in outs:
        if out["report"] != main_report:
            fail(f"sharded rank {out['rank']} of {world} report differs from "
                 f"phase 3's")
    say(f"[shard] world size {world} on the one card ({outs[0]['backend']} "
        f"over CUDA tensors), base cuda_fused: "
        + " | ".join(f"rank {o['rank']}: {o['rows']} rows, {o['mb']:.1f} MB, "
                     f"build {o['build_s']:.3f} s, profile "
                     f"{o['profile_s']:.3f} s cold, warm median "
                     f"{o['warm_s']:.3f} s of {WARM_RUNS}, launches "
                     f"{json.dumps(o['launches'])}" for o in outs)
        + f" | both reports == phase 3's ({time.perf_counter() - t0:.1f} s "
        f"with start-up) | {card}")
    note("9 shard", f"world size {world}: reports == phase 3's")


def accel_phase(*, config, sample, db, main_report, card, int_rate,
                zero_counts, read_counts, rows) -> None:
    """Phase 10: the device model at phase 3's width, config and reads."""
    import torch

    from repro_torch.accel import codesign, crossbar, sweep
    from repro_torch.accel.device import DeviceConfig
    from repro_torch.accel.substrate import f32
    from repro_torch.core import bitops
    from repro_torch.eval import score_profile
    from repro_torch.genomics import synth
    from repro_torch.core import threefry as threefry_core
    from repro_torch.kernels import threefry
    from repro_torch.pipeline import (ArraySource, ProfilerConfig,
                                      ProfilingSession, SyntheticSource)

    dev = torch.device("cuda")
    space = config.space

    # -- 10.1 the Threefry kernel against its plain version ---------------
    # On 10 M draws a mode and epilogue, then at the main path's full width
    # in each mode: one bank's programming draws (one key, 408.9 M uniforms,
    # and 408.9 M normals scaled and added into the state as
    # program_conductances adds them).  A batch's read noise is held at the
    # main path's own inputs in 10.3.  Bits and uniforms must match
    # exactly, normals within NORMAL_ULP; the kernels line's max_abs_err is
    # the largest absolute gap of the normals held here and in 10.3.
    rng = np.random.default_rng(1701)
    n_draw = 10_000_000
    t_tiles = -(-space.dim // 256)
    s_pad = -(-db.num_prototypes // 256) * 256
    full = t_tiles * s_pad * 256
    key1 = threefry.keys_tensor(rng.integers(0, 2 ** 32, (1, 2),
                                             dtype=np.uint32), dev)
    keys_t = threefry.keys_tensor(rng.integers(0, 2 ** 32, (160, 2),
                                               dtype=np.uint32), dev)
    std = torch.rand(160, 250, device=dev) * 4
    base = torch.randint(0, 257, (160, 250 * 250), device=dev).float()
    pcm_dev = DeviceConfig.pcm()
    prog_scale = pcm_dev.prog_sigma * pcm_dev.level_spacing_us
    gaps = {}           # (mode, what) -> (max ulp, share differing, max abs)

    def exact(what, part, m):
        for epi in ("bits", "uniform"):
            got = threefry.threefry_draw(key1, m, epilogue=epi,
                                         partitionable=part)
            want = threefry.threefry_draw_plain(key1, m, epilogue=epi,
                                                partitionable=part)
            bad = int((got != want).sum())
            if bad:
                fail(f"threefry {epi} {what} (partitionable={part}): {bad} "
                     f"of {m:,} draws differ from the plain version")
            del got, want

    def hold(what, part, got, want):
        top, n_diff, err = ulp_gap(got, want)
        gaps[(part, what)] = (top, n_diff / got.numel(), err)
        if top > NORMAL_ULP:
            fail(f"threefry {what} (partitionable={part}): {top} ulp from "
                 f"the plain version (stated: {NORMAL_ULP})")

    def normal_into(k, m, acc, part, plain=False, **kw):
        fn = threefry.threefry_draw_plain if plain else threefry.threefry_draw
        return fn(k, m, epilogue="normal", partitionable=part, out=acc, **kw)

    for part in (True, False):
        exact("10 M", part, n_draw)
        hold("normal 10 M", part,
             threefry.threefry_draw(key1, n_draw, epilogue="normal",
                                    partitionable=part),
             threefry.threefry_draw_plain(key1, n_draw, epilogue="normal",
                                          partitionable=part))
        kw = {"scale": std, "inner": 250, "divisor": 19.9}
        hold("read noise 160 x 62,500", part,
             normal_into(keys_t, 250 * 250, base.clone(), part, **kw),
             normal_into(keys_t, 250 * 250, base.clone(), part, plain=True,
                         **kw))
        exact("408.9 M", part, full)
        g = (torch.randint(0, 2, (full,), device=dev, dtype=torch.float32)
             * f32(pcm_dev.g_window_us) + f32(pcm_dev.g_off_us))
        got = normal_into(key1, full, g.clone(), part, scale=prog_scale)
        hold("program normal 408.9 M", part, got,
             normal_into(key1, full, g, part, plain=True, scale=prog_scale))
        del g, got
        torch.cuda.empty_cache()
    say(f"[accel] threefry == plain, both modes: bits and uniforms 0 "
        f"mismatches on {n_draw:,} and on {full:,} draws (one bank's "
        f"programming); normals max ulp / share differing / max abs "
        + ", ".join(f"{'part' if p else 'orig'} {w} {g[0]} / {g[1]:.2e} / "
                    f"{g[2]:.3g}" for (p, w), g in gaps.items())
        + f" | {card}")
    del base, std

    times = {}
    for part in (True, False):
        times[part] = cuda_time_ms(lambda: threefry.threefry_draw(
            key1, full, epilogue="normal", partitionable=part), reps=5)
    randn_ms = cuda_time_ms(lambda: torch.randn(full, device=dev), reps=5)
    say(f"[accel] threefry normal, {full:,} draws (one program bank): "
        f"partitionable {times[True]:.3f} ms, original {times[False]:.3f} ms"
        f" | torch.randn {randn_ms:.3f} ms | {card}")
    b_rd = config.batch_size
    kernel_row = {"library_ms": randn_ms}

    # -- 10.2 pcm_sim at preset ideal == phase 3 --------------------------
    def substrate_session(backend, **options):
        # TF32 on before the backend is made: making it must turn TF32 off
        # for the float32 products of noisy weights.
        torch.backends.cuda.matmul.allow_tf32 = True
        sess = ProfilingSession(dataclasses.replace(
            config, backend=backend, backend_options=options))
        if torch.backends.cuda.matmul.allow_tf32:
            fail(f"{backend} left TF32 on for the device model's float32 "
                 f"products")
        return sess

    def timed_profile(sess, source):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = sess.profile(source, refdb=db)
        torch.cuda.synchronize()
        return rep, time.perf_counter() - t0

    def program(sess):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.backend.program(db.prototypes)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    ideal = substrate_session("pcm_sim")
    zero_counts()
    prog_s = program(ideal)
    rep, secs = timed_profile(ideal, sample)
    runs = read_counts()
    if rep.to_dict() != main_report:
        fail("pcm_sim at preset ideal: report differs from phase 3's")
    if runs["hdc_encoder"] < 1 or runs["threefry"] != 0:
        fail(f"pcm_sim ideal launched {runs}, want the encoder and no "
             f"threefry")
    say(f"[accel] pcm_sim ideal: report == phase 3's | banks "
        f"{ideal.backend.banks_bytes / 1e6:.1f} MB ({t_tiles} x {s_pad} x "
        f"256 a bank, read weights cached) | program {prog_s:.3f} s | "
        f"profile {secs:.3f} s, {NUM_READS / secs:.0f} reads/s | launches "
        f"{json.dumps(runs)} | {card}")
    del ideal

    # -- 10.3 the noisy presets: determinism, seeds, reads/s --------------
    q_first = None
    noisy_runs = {}
    for backend, preset in (("pcm_sim", "pcm"),
                            ("racetrack_sim", "racetrack")):
        sess = substrate_session(backend, preset=preset)
        be = sess.backend
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        prog_s = program(sess)
        rep1, secs = timed_profile(sess, sample)
        runs = read_counts()
        peak = torch.cuda.max_memory_allocated()
        noisy_runs[backend] = runs
        if runs["hdc_encoder"] < 1 or runs["threefry"] < 1:
            fail(f"{backend} {preset} did not run the encoder and threefry "
                 f"kernels: {runs}")
        rep2, secs2 = timed_profile(sess, sample)
        if rep2.to_dict() != rep1.to_dict():
            fail(f"{backend} {preset}: two profiles with one seed differ")
        if q_first is None:
            q_first = sess.encode_reads(sample.tokens[:b_rd],
                                        sample.lengths[:b_rd])
        other = substrate_session(backend, preset=preset, seed=0xACC_DE + 1)
        a_seed = be.agreement(q_first, db.prototypes)
        a_other = other.backend.agreement(q_first, db.prototypes)
        if torch.equal(a_seed, a_other):
            fail(f"{backend} {preset}: another seed read the same agreement")
        del other
        # ms a batch: the whole read, its two bank products, its two noise
        # draws, and the rest (unpack, ADC, sums).
        _, w_pos, w_neg = be._programmed
        xcfg, sub = be.crossbar_config, be.substrate
        read_ms = cuda_time_ms(lambda: crossbar.read_banks(
            q_first, w_pos, w_neg, space.dim, xcfg, sub), reps=5)
        qbits = bitops.unpack_bits(q_first).to(torch.float32)
        q_pos = crossbar._to_row_tiles(qbits, 256)
        q_neg = crossbar._to_row_tiles(1.0 - qbits, 256)
        bmm_ms = cuda_time_ms(lambda: (torch.bmm(q_pos, w_pos.transpose(1, 2)),
                                       torch.bmm(q_neg, w_neg.transpose(1, 2))),
                              reps=5)
        # Batch 0's read noise on the positive bank at the main path's own
        # inputs (its partial counts, row-tile keys and active rows): the
        # kernel against its plain version, then each timed.
        cnt = torch.bmm(q_pos, w_pos.transpose(1, 2))
        keys = threefry_core.split(
            sub.read_event_key(0, crossbar.batch_digest(q_first)), t_tiles,
            partitionable=sub.partitionable)
        act = q_pos.sum(dim=-1)
        noise_std, divisor = sub.read_noise_scale(act)
        ktens = threefry.keys_tensor(keys, dev)
        words = b_rd * s_pad
        kw = {"epilogue": "normal", "partitionable": sub.partitionable,
              "scale": noise_std, "inner": s_pad, "divisor": divisor}
        got = sub.add_read_noise(keys, cnt.clone(), act)
        if not torch.equal(got, threefry.threefry_draw(
                ktens, words, out=cnt.clone(), **kw)):
            fail(f"{backend}: the read-noise call held here is not the main "
                 f"path's")
        want = cnt.clone()
        torch.cuda.empty_cache()
        plain_ms = cuda_time_ms(lambda: threefry.threefry_draw_plain(
            ktens, words, out=want, **kw), reps=1, warmup=0)
        what = f"{backend} read noise {t_tiles} x {b_rd} x {s_pad}"
        hold(what, sub.partitionable, got, want)
        del want
        torch.cuda.empty_cache()
        ms = cuda_time_ms(lambda: threefry.threefry_draw(
            ktens, words, out=got, **kw), reps=10)
        del got
        pairs = t_tiles * (words if sub.partitionable else -(-words // 2))
        nbytes = (2 * t_tiles * words * 4 + noise_std.numel() * 4
                  + ktens.numel() * 4)
        t_bound = bound_ms(nbytes, pairs * THREEFRY_OPS_PER_PAIR
                           + t_tiles * words * THREEFRY_OPS_PER_WORD,
                           int_rate=int_rate)
        if backend == "pcm_sim":             # the kernels line's times
            kernel_row.update(ms=ms, plain_ms=plain_ms, bound=t_bound)
        say(f"[time] threefry read-noise epilogue, {backend} {preset} batch "
            f"0, {t_tiles} keys x {b_rd} x {s_pad} (one bank): {ms:.3f} "
            f"ms/launch (plain {plain_ms:.1f} ms, bound {t_bound[0]:.4f} ms "
            f"by {t_bound[1]}; torch.randn of {full:,}: {randn_ms:.3f} ms) | "
            f"held against plain: max ulp / share differing / max abs "
            f"{' / '.join(f'{x:.3g}' for x in gaps[(sub.partitionable, what)])}"
            f" | {card}")
        noise_ms = cuda_time_ms(lambda: [sub.add_read_noise(keys, cnt, act)
                                         for _ in range(2)], reps=5)
        del cnt, q_pos, q_neg, qbits
        _, clips = crossbar.read_banks(q_first, w_pos, w_neg, space.dim,
                                       xcfg, sub, with_stats=True)
        census = {bank: sub.fault_census(tuple(w_pos.shape), stream=st,
                                         device=dev)
                  for st, bank in ((0, "pos"), (1, "neg"))}
        m = score_profile(rep1.abundance, sample.true_abundance)
        say(f"[accel] {backend} {preset}: program {prog_s:.3f} s | profile "
            f"{secs:.3f} s ({NUM_READS / secs:.0f} reads/s), again "
            f"{secs2:.3f} s, report identical | a batch {read_ms:.2f} ms = "
            f"bmm {bmm_ms:.2f} + noise {noise_ms:.2f} + rest "
            f"{read_ms - bmm_ms - noise_ms:.2f} | max_memory_allocated "
            f"{peak / 1e9:.2f} GB | {card}")
        note("10 accel", f"{backend} {preset} {secs:.3f} s, a batch {read_ms:.2f} ms")
        say(f"[accel] {backend} {preset}: another seed's agreement differs "
            f"in {float((a_seed != a_other).float().mean()):.4f} of "
            f"{a_seed.numel()} | fault census {json.dumps(census)} | ADC "
            f"clips in batch 0: {clips} | precision {m.precision:.3f} "
            f"recall {m.recall:.3f} l1 {m.l1_error:.3f} | unmapped "
            f"{rep1.unmapped_reads} multi {rep1.multi_reads} of "
            f"{rep1.total_reads} | launches {json.dumps(runs)} | {card}")
        del sess, be, w_pos, w_neg
        torch.cuda.empty_cache()

    # -- 10.4 noisy card against CPU --------------------------------------
    small = SyntheticSource(synth.CommunitySpec(
        num_species=2, genome_len=200_000, seed=5), num_reads=256)
    pcm_cfg = dataclasses.replace(config, backend="pcm_sim",
                                  backend_options={"preset": "pcm"})
    card_sess = ProfilingSession(pcm_cfg)
    db_small = card_sess.build_refdb(small.genomes)
    cpu_sess = ProfilingSession(pcm_cfg, device="cpu")
    db_cpu = cpu_sess.adopt_refdb(db_small.to("cpu"))
    t0 = time.perf_counter()
    q_cpu = cpu_sess.encode_reads(small.tokens, small.lengths)
    a_cpu = cpu_sess.backend.agreement(q_cpu, db_cpu.prototypes)
    cpu_s = time.perf_counter() - t0
    q_card = card_sess.encode_reads(small.tokens, small.lengths)
    if not torch.equal(q_card.cpu(), q_cpu):
        fail("pcm_sim encode differs between the card and the CPU")
    a_card = card_sess.backend.agreement(q_card, db_small.prototypes).cpu()
    diff = (a_card.long() - a_cpu.long()).abs()
    share = float((diff > 0).float().mean())
    if int(diff.max()) > 1 or share > NEAR_EXACT_SHARE:
        fail(f"pcm_sim card vs CPU: {share:.2e} of the agreements differ, "
             f"max by {int(diff.max())} (tolerance {NEAR_EXACT_SHARE:g}, "
             f"one count)")
    same_report = (card_sess.profile(small).to_dict()
                   == cpu_sess.profile(small).to_dict())
    say(f"[accel] pcm_sim pcm, card vs CPU at D = {space.dim}, "
        f"{db_small.num_prototypes} prototypes, 256 reads: {share:.2e} of "
        f"{a_card.numel()} agreements differ (max {int(diff.max())}; "
        f"tolerance {NEAR_EXACT_SHARE:g}, one count) | reports "
        f"{'equal' if same_report else 'differ'} | CPU read {cpu_s:.1f} s "
        f"| {card}")
    del card_sess, cpu_sess, db_small, db_cpu

    # -- 10.5 the noise-aware build at full width --------------------------
    rt_cfg = dataclasses.replace(config, backend="racetrack_sim",
                                 backend_options={"preset": "racetrack"})
    stats = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined = codesign.noise_aware_refdb(db, sample.genomes, rt_cfg,
                                         iterations=2, stats=stats)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if stats["best"] < stats["naive"]:
        fail(f"noise_aware_refdb validated {stats['best']} below the naive "
             f"build's {stats['naive']}")
    changed = int((refined.prototypes != db.prototypes).any(dim=1).sum())
    say(f"[accel] noise_aware_refdb racetrack (iterations 2): build "
        f"{build_s:.2f} s | max_memory_allocated {peak / 1e9:.2f} GB | "
        f"validation (hit rate, -false hits) naive {stats['naive']} -> "
        f"refined {stats['best']} over {stats['candidates']} candidates | "
        f"{stats['flagged']} training reads flagged, the last retraining "
        f"changed {stats['changed']} prototypes | {changed} of "
        f"{refined.num_prototypes} prototypes changed | {card}")
    del refined

    # The retraining steps on the card (flagged reads bundled with
    # index_add_, rebinarize_counters, the candidates validated), held
    # against the CPU on the same inputs: full D on 10.4's community, with
    # half the racetrack's tracks misaligned (repro's sweep point).  The
    # device transfer stays in {0, 1}, so the two runs must agree exactly.
    sh_cfg = dataclasses.replace(config, backend="racetrack_sim",
                                 backend_options={"shift_fault_rate": 0.5,
                                                  "seed": 3})
    builds = {}
    for where in ("cuda", "cpu"):
        sess = ProfilingSession(sh_cfg, device=where)
        db_sh = sess.build_refdb(small.genomes)
        st = {}
        t0 = time.perf_counter()
        out = codesign.noise_aware_refdb(db_sh, small.genomes, sh_cfg,
                                         iterations=2, stats=st)
        if where == "cuda":
            torch.cuda.synchronize()
        builds[where] = (db_sh.prototypes.cpu(), out.prototypes.cpu(), st,
                         time.perf_counter() - t0)
        del sess, db_sh, out
    naive_c, out_c, st_c, card_s = builds["cuda"]
    naive_h, out_h, st_h, host_s = builds["cpu"]
    if st_c["candidates"] < 3 or st_c["flagged"] < 1 or st_c["changed"] < 1:
        fail(f"noise_aware_refdb shift faults: no retraining step changed a "
             f"prototype on the card ({st_c})")
    if st_c["best"] < st_c["naive"]:
        fail(f"noise_aware_refdb shift faults validated {st_c['best']} below "
             f"the naive build's {st_c['naive']}")
    if (not torch.equal(naive_c, naive_h) or not torch.equal(out_c, out_h)
            or st_c != st_h):
        fail(f"noise_aware_refdb shift faults: the card's build differs from "
             f"the CPU's (card {st_c}, CPU {st_h})")
    say(f"[accel] noise_aware_refdb racetrack shift_fault_rate 0.5 at D = "
        f"{space.dim}, {naive_c.shape[0]} prototypes (iterations 2): "
        f"{st_c['candidates']} candidates, {st_c['flagged']} training reads "
        f"flagged, the last retraining changed {st_c['changed']} "
        f"prototypes, validation {st_c['naive']} -> {st_c['best']} | card "
        f"== CPU (prototypes and stats) | build {card_s:.2f} s on the card, "
        f"{host_s:.1f} s on the CPU | {card}")
    del builds

    # -- 10.6 a three-point noise sweep ------------------------------------
    n_sw = 2048
    toks, lens = sample.tokens[:n_sw], sample.lengths[:n_sw]
    t0 = time.perf_counter()
    points = sweep.noise_sweep(
        sample.genomes, toks, lens, sample.true_abundance,
        config=dataclasses.replace(config, backend="pcm_sim"),
        knob="read_sigma", levels=(0.0, 0.05, 0.2), refdb=db)
    sweep_s = time.perf_counter() - t0
    want = ProfilingSession(config).profile(ArraySource(toks, lens),
                                            refdb=db).to_dict()
    if points[0].report.to_dict() != want:
        fail("noise_sweep at read_sigma 0: report differs from cuda_fused's")
    say(f"[accel] noise_sweep read_sigma at D = {space.dim}, {n_sw} reads "
        f"({sweep_s:.1f} s; level 0 == cuda_fused): "
        + " | ".join(p.row() for p in points) + f" | {card}")

    runs = noisy_runs["pcm_sim"]
    b_ms, b_by = kernel_row["bound"]
    row = {"name": "threefry", "route": "cuda",
           "source": "src/repro_torch/csrc/threefry.cu",
           "replaces": "src/repro/accel/crossbar.py:142",
           "launches": runs["threefry"],
           "max_abs_err": max(g[2] for g in gaps.values()),
           "ms": kernel_row["ms"], "plain_ms": kernel_row["plain_ms"],
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": kernel_row["library_ms"]}
    rows.append(row)
    say(f"[accel] threefry launches, program + profile of {NUM_READS} "
        f"reads: pcm_sim pcm {runs['threefry']}, racetrack_sim racetrack "
        f"{noisy_runs['racetrack_sim']['threefry']} | {card}")


def baselines_phase(*, sample, small, db, card, zero_counts,
                    read_counts) -> None:
    """Phase 11: the baseline profilers at phase 3's width, and card ==
    CPU on phase 4's community."""
    import torch

    from repro_torch.baselines import (ClarkLike, Kraken2Like, MetaCacheLike,
                                       bracken_like)
    from repro_torch.eval import score_profile

    makers = {"kraken2-like": lambda dev: Kraken2Like(k=21, device=dev),
              "metacache-like": lambda dev: MetaCacheLike(device=dev),
              "clark-like": lambda dev: ClarkLike(k=21, device=dev)}
    glens = np.array([len(g) for g in sample.genomes.values()])
    mem = {}
    for name, make in makers.items():
        prof = make("cuda")
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof.build(sample.genomes)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        secs = []
        for _ in range(3):                 # a cold classify and two warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hits, cat = prof.classify_reads(sample.tokens, sample.lengths)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        counts = read_counts()
        if any(counts.values()):
            fail(f"{name}: the baselines are plain torch, yet kernels "
                 f"launched: {counts}")
        res = bracken_like.estimate_abundance(hits, cat, glens)
        m = score_profile(res.abundance.cpu().numpy(),
                          sample.true_abundance)
        if hits.shape != (NUM_READS, NUM_SPECIES) or \
                not torch.isfinite(res.abundance).all():
            fail(f"{name}: hits {tuple(hits.shape)} or abundance not finite")
        mem[name] = prof.memory_bytes()
        warm = statistics.median(secs[1:])
        say(f"[baseline] {name}: build {build_s:.3f} s | classify "
            f"{NUM_READS} reads cold {secs[0]:.3f} s, warm {warm:.4f} s "
            f"({NUM_READS / warm:.0f} reads/s) | memory "
            f"{mem[name] / 1e6:.1f} MB | unmapped "
            f"{int((cat == 0).sum())} multi {int((cat == 2).sum())} | "
            f"precision {m.precision:.3f} recall {m.recall:.3f} | {card}")
        del prof, hits, cat
    demeter = db.memory_bytes()
    say(f"[baseline] memory: demeter RefDB {demeter / 1e6:.1f} MB < "
        f"metacache-like {mem['metacache-like'] / 1e6:.1f} MB < "
        f"kraken2-like {mem['kraken2-like'] / 1e6:.1f} MB "
        f"({mem['kraken2-like'] / demeter:.1f}x demeter); clark-like "
        f"{mem['clark-like'] / 1e6:.1f} MB")
    note("11 baseline", f"memory RefDB {demeter / 1e6:.1f} < MetaCache {mem['metacache-like'] / 1e6:.1f} < Kraken2 {mem['kraken2-like'] / 1e6:.1f} MB")
    if not demeter < mem["metacache-like"] < mem["kraken2-like"]:
        fail(f"the paper's memory ordering does not hold: {mem}, "
             f"demeter {demeter}")

    # Card against the port's CPU path on phase 4's community.
    sglens = np.array([len(g) for g in small.genomes.values()])
    for name, make in makers.items():
        out = {}
        for dev in ("cuda", "cpu"):
            prof = make(dev).build(small.genomes)
            hits, cat = prof.classify_reads(small.tokens, small.lengths)
            res = bracken_like.estimate_abundance(hits, cat, sglens)
            out[dev] = (prof.table, hits.cpu(), cat.cpu(), res)
        (tg, hg, cg, rg), (tc, hc, cc, rc) = out["cuda"], out["cpu"]
        if not (torch.equal(tg.keys.cpu(), tc.keys)
                and torch.equal(tg.masks.cpu(), tc.masks)):
            fail(f"{name}: the card's table differs from the CPU's")
        if not (torch.equal(hg, hc) and torch.equal(cg, cc)):
            fail(f"{name}: the card's hits or categories differ from the "
                 f"CPU's")
        if not torch.equal(rg.unique_counts.cpu(), rc.unique_counts):
            fail(f"{name}: Bracken unique counts differ card vs CPU")
        gap = max(float((getattr(rg, f).cpu() - getattr(rc, f)).abs().max())
                  for f in ("abundance", "multi_counts"))
        if gap > BRACKEN_ATOL:
            fail(f"{name}: Bracken abundance card vs CPU {gap:.2e} > "
                 f"{BRACKEN_ATOL:.0e}")
        say(f"[baseline] {name} card == CPU ({len(small.lengths)} reads, "
            f"{tc.keys.numel()} table entries): table, hits, category "
            f"equal; Bracken abundance within {gap:.2e} (atol "
            f"{BRACKEN_ATOL:.0e})")


class InitDraws:
    """Records the keys and size of each ``Keys.normal`` draw (one
    Threefry launch each) while active, and holds every recorded launch
    against the plain version afterwards."""

    def __init__(self):
        self.drawn = []

    def __enter__(self):
        from repro_torch.models.layers import Keys

        self._keys, self._normal = Keys, Keys.normal

        def recording_normal(keys, shape):
            self.drawn.append((keys.words.copy(), keys.partitionable,
                               int(np.prod(shape))))
            return self._normal(keys, shape)
        Keys.normal = recording_normal
        return self

    def __exit__(self, *exc):
        self._keys.normal = self._normal

    def hold(self, label: str) -> str:
        """Each recorded launch at its own keys and size (a stacked weight:
        one key a layer), kernel against plain version, bit for bit;
        returns a description of the draws."""
        import torch

        from repro_torch.kernels import threefry

        total = 0
        for words, partitionable, m in self.drawn:
            keys = threefry.keys_tensor(words, "cuda")
            got = threefry.threefry_draw(keys, m, epilogue="normal",
                                         partitionable=partitionable)
            want = threefry.threefry_draw_plain(keys, m, epilogue="normal",
                                                partitionable=partitionable)
            ulps, nbad, _ = ulp_gap(got, want)
            if nbad:
                fail(f"{label} init draw of {len(words)} keys x {m}: kernel "
                     f"and plain version differ in {nbad} ({ulps} ulp)")
            total += got.numel()
            del got, want
            torch.cuda.empty_cache()
        import collections

        # a stacked bf16 leaf is drawn a layer (one key) at a time
        runs = collections.Counter((len(w), m) for w, _, m in self.drawn)
        shapes = ", ".join(f"{c} x ({k} x {m})" if c > 1 else f"{k} x {m}"
                           for (k, m), c in runs.items())
        return (f"{len(self.drawn)} threefry launches (keys x draws a key: "
                f"{shapes}; {total} draws)")


def lm_phase(*, card, zero_counts, read_counts) -> None:
    """Phase 12: the LM stack's serving path."""
    import dataclasses as dc

    import torch

    from repro_torch.configs import all_archs, get_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import blocks, lm
    from repro_torch.serve import serve_step

    # The port, not this script, must turn TF32 off: a caller's setting
    # would otherwise round the float32 models' products.
    torch.backends.cuda.matmul.allow_tf32 = True
    # -- 12.1 stablelm-3b at full width ------------------------------------
    # Twice: the first call carries first-use costs (cuBLAS handles,
    # allocator growth); the second is the figure to compare.  The first
    # also records the keys and size of each of init_lm's draws (one
    # Threefry launch each), to hold every launch against the plain
    # version after the timed runs.
    cfg = get_config(LM_ARCH)
    draws = InitDraws()
    for run in ("cold", "warm"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        with draws if run == "cold" else contextlib.nullcontext():
            out = lm_serve.serve(LM_ARCH, smoke=False,
                                 num_requests=LM_REQUESTS,
                                 prompt_len=LM_PROMPT, decode_steps=LM_STEPS)
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        toks = out["tokens"]
        if toks.shape != (LM_REQUESTS, LM_STEPS + 1) or toks.min() < 0 \
                or toks.max() >= cfg.vocab:
            fail(f"{LM_ARCH}: served tokens {toks.shape} out of range")
        if counts["threefry"] < 1:
            fail(f"{LM_ARCH}: init_lm drew no weights through the Threefry "
                 f"kernel: {counts}")
        if run == "warm" and not np.array_equal(toks, first):
            fail(f"{LM_ARCH}: two serves of one seed gave other tokens")
        first = toks
        say(f"[lm] {LM_ARCH} full width, {run} ({cfg.n_layers} layers, d "
            f"{cfg.d_model}, {out['num_params'] / 1e9:.3f} B "
            f"{cfg.param_dtype} parameters): {LM_REQUESTS} requests x "
            f"{LM_PROMPT} prompt tokens, {LM_STEPS} decode steps | prefill "
            f"{out['prefill_s'] * 1e3:.1f} ms | decode "
            f"{out['decode_s'] * 1e3:.1f} ms, "
            f"{LM_REQUESTS * LM_STEPS / out['decode_s']:.0f} tok/s | "
            f"max_memory_allocated {peak / 1e9:.2f} GB | serve() "
            f"{wall:.1f} s with init | launches {json.dumps(counts)} | "
            f"{card}")
        if run == "warm":
            note("12 lm", f"{LM_ARCH} prefill {out['prefill_s'] * 1e3:.1f} ms, decode {LM_REQUESTS * LM_STEPS / out['decode_s']:.0f} tok/s, peak {peak / 1e9:.2f} GB")
    if torch.backends.cuda.matmul.allow_tf32:
        fail(f"{LM_ARCH}: serve() left TF32 on for CUDA matmuls")
    if len(draws.drawn) != counts["threefry"]:
        fail(f"{LM_ARCH}: recorded {len(draws.drawn)} Threefry launches, "
             f"the wrapper counted {counts['threefry']}")

    # Every init_lm launch at its own keys and size: the kernel against its
    # plain version, bit for bit.
    say(f"[lm] init_lm's {draws.hold(LM_ARCH)}: kernel == plain version "
        f"bit for bit")

    # The served bf16 model against a float32 copy of its weights, on the
    # serve's prompts: only bf16 rounding parts them (the float32 smoke
    # models below hold the port to the CPU at 1e-4).
    model = lm.init_lm(0, cfg, device="cuda")
    cfg32 = dc.replace(cfg, param_dtype="float32")
    model32 = lm.LM(cfg32, lm.tree_map(lambda t: t.float(), model.tree()))
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_REQUESTS, LM_PROMPT)).astype(np.int32)).cuda()
    with torch.inference_mode():
        lb = lm.forward(model, prompts, cfg)[0].float()
        lf = lm.forward(model32, prompts, cfg32)[0]
    rel = float((lb - lf).norm() / lf.norm())
    top1 = float((lb.argmax(-1) == lf.argmax(-1)).float().mean())
    gap = float((lb - lf).abs().max())
    if not torch.isfinite(lb).all() or rel > LM_BF16_REL or \
            top1 < LM_BF16_TOP1:
        fail(f"{LM_ARCH}: bf16 logits part from the float32 copy's: "
             f"relative {rel:.4f} (limit {LM_BF16_REL}), top-1 agreement "
             f"{top1:.4f} (limit {LM_BF16_TOP1})")
    say(f"[lm] {LM_ARCH} bf16 against its float32 copy, forward over the "
        f"{LM_REQUESTS} x {LM_PROMPT} prompts: logits relative gap "
        f"{rel:.4f} (limit {LM_BF16_REL}), max {gap:.3f} at a scale of "
        f"{float(lf.abs().max()):.2f}, top-1 agreement {top1:.4f} (limit "
        f"{LM_BF16_TOP1}) | {card}")
    del model, model32, lb, lf
    torch.cuda.empty_cache()

    # The decode step's attention over a cache of the served shape and of
    # a 32k context: its products read the cache where it lies, so it
    # allocates no copy of K or V.
    attn = cfg.attn
    for s_len in (LM_PROMPT + LM_STEPS + 1, 32_768):
        shape = (LM_REQUESTS, s_len, attn.num_kv_heads, attn.head_dim)
        gen = torch.Generator(device="cuda").manual_seed(s_len)
        cache = {"k": torch.randn(shape, generator=gen, device="cuda"
                                  ).to(torch.bfloat16),
                 "v": torch.randn(shape, generator=gen, device="cuda"
                                  ).to(torch.bfloat16),
                 "kpos": torch.arange(s_len, device="cuda", dtype=torch.int32
                                      ).expand(LM_REQUESTS, s_len)}
        q = torch.randn((LM_REQUESTS, attn.num_heads, attn.head_dim),
                        generator=gen, device="cuda").to(torch.bfloat16)
        kv_bytes = 2 * cache["k"].numel() * 2
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = blocks.cached_attention(q, cache, s_len - 1, None)
        extra = torch.cuda.max_memory_allocated() - base
        k32, v32 = cache["k"].float(), cache["v"].float()
        want = torch.softmax(torch.einsum(
            "bhd,bshd->bhs", q.float(), k32) * attn.head_dim ** -0.5, -1)
        want = torch.einsum("bhs,bshd->bhd", want.to(torch.bfloat16).float(),
                            v32)
        err = float((got.float() - want).abs().max())
        # What it may allocate: a few float32 score tensors (B, H, S), the
        # block-diagonal q and the all-heads output (B, H, KV dh) bf16; one
        # layer's K, upcast or copied, is several times larger.
        room = 4 * LM_REQUESTS * attn.num_heads * (
            s_len * 4 + attn.num_kv_heads * attn.head_dim * 2)
        if err > LM_ATTN_ATOL or extra > room:
            fail(f"cached_attention at S={s_len}: max error {err:.2e} "
                 f"(limit {LM_ATTN_ATOL}), {extra} bytes allocated beside "
                 f"the {kv_bytes}-byte cache (room {room})")
        del k32, v32, want
        ms = cuda_time_ms(lambda: blocks.cached_attention(
            q, cache, s_len - 1, None), reps=20)
        say(f"[lm] cached_attention, {LM_REQUESTS} requests x {s_len} "
            f"positions x {attn.num_kv_heads} heads x {attn.head_dim} "
            f"(K + V {kv_bytes / 1e6:.1f} MB bf16): {ms:.3f} ms a layer, "
            f"{kv_bytes / ms / 1e6:.0f} GB/s of K + V; "
            f"{extra / 1e6:.1f} MB allocated besides; error against a "
            f"float32 reference {err:.1e} | {card}")
        del cache, q, got
        torch.cuda.empty_cache()

    # -- 12.2 every SMOKE architecture, float32, card against CPU ----------
    rng = np.random.default_rng(12)
    for arch in all_archs():
        scfg = dc.replace(get_config(arch, smoke=True), param_dtype="float32")
        cpu_model = lm.init_lm(0, scfg, device="cpu")
        gpu_model = lm.LM(scfg, lm.tree_map(lambda t: t.to("cuda"),
                                            cpu_model.tree()))
        b, s, steps = 2, 12, LM_SMOKE_STEPS
        toks = rng.integers(0, scfg.vocab, (b, s)).astype(np.int32)
        kw = {}
        if scfg.family == "audio":
            kw["enc_embeds"] = rng.normal(size=(b, 16, scfg.d_model))
        if scfg.family == "vlm":
            kw["prefix_embeds"] = rng.normal(
                size=(b, scfg.vlm_prefix, scfg.d_model))
        res = {}
        for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
            fkw = {k: torch.tensor(v, dtype=torch.float32, device=dev)
                   for k, v in kw.items()}
            with torch.inference_mode():
                pre = serve_step.make_prefill_step(
                    scfg, s + scfg.vlm_prefix + steps + 1, q_chunk=8,
                    kv_chunk=8)
                logits, caches = pre(model, torch.from_numpy(toks).to(dev),
                                     **fkw)
                seen, tok = [logits.cpu()], torch.argmax(logits, -1)
                greedy = [tok.cpu()]
                pos0 = s + (scfg.vlm_prefix if "prefix_embeds" in kw else 0)
                for i in range(steps):
                    logits, caches = lm.decode_step(model, tok, caches,
                                                    pos0 + i, scfg)
                    tok = torch.argmax(logits, -1)
                    seen.append(logits.cpu())
                    greedy.append(tok.cpu())
            res[dev] = (torch.stack(seen, 1), torch.stack(greedy, 1))
        (lg, tg), (lc, tc) = res["cuda"], res["cpu"]
        gap = float((lg - lc).abs().max())
        if not torch.allclose(lg, lc, atol=LM_TOL, rtol=LM_TOL) or \
                not torch.isfinite(lg).all():
            fail(f"{arch}: card vs CPU logits differ by {gap:.2e} "
                 f"(tolerance {LM_TOL:.0e})")
        if not torch.equal(tg, tc):
            fail(f"{arch}: card vs CPU greedy tokens differ")
        say(f"[lm] {arch} smoke float32: prefill + {steps} decode steps, "
            f"card vs CPU logits max gap {gap:.2e} (atol = rtol = "
            f"{LM_TOL:.0e}), greedy tokens equal")


def train_phase(*, card, zero_counts, read_counts) -> None:
    """Phase 13: the LM stack's training path."""
    import dataclasses as dc
    import shutil

    import torch

    from repro_torch.checkpoint import checkpointer as ck
    from repro_torch.configs import all_archs, get_config
    from repro_torch.data import lm_data
    from repro_torch.launch import train as lm_train
    from repro_torch.models import lm
    from repro_torch.train import train_step as ts

    # -- 13.1 stablelm-3b at full width and depth --------------------------
    cfg = get_config(LM_ARCH)
    dcfg = lm_data.DataConfig(vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ,
                              global_batch=LM_TRAIN_BATCH)
    batch0 = {k: torch.from_numpy(v).cuda()
              for k, v in lm_data.batch_at(dcfg, 0).items()}
    # The loss of the weights train() starts from (init_lm's seed 0) on its
    # first batch, in bf16 and in a float32 copy, forward only: the first
    # step's bf16 loss must sit near the float32 one.
    tc = ts.TrainConfig(loss_chunk=LM_TRAIN_SEQ, q_chunk=LM_TRAIN_SEQ,
                        kv_chunk=LM_TRAIN_SEQ)
    model = lm.init_lm(0, cfg, device="cuda")
    cfg32 = dc.replace(cfg, param_dtype="float32")
    model32 = lm.LM(cfg32, lm.tree_map(lambda t: t.float(), model.tree()))
    with torch.no_grad():
        loss_bf16 = float(ts.make_loss_fn(cfg, tc)(model, batch0)[0])
        loss_f32 = float(ts.make_loss_fn(cfg32, tc)(model32, batch0)[0])
    del model, model32
    torch.cuda.empty_cache()

    # The run saves its full-depth state after its last step (a layer at a
    # time to the host): room on the disk first, and the rise of the
    # card's memory during each save recorded.
    full_ckpt = os.path.join(ROOT, "build", "chip_smoke", "train_ckpt_full")
    shutil.rmtree(full_ckpt, ignore_errors=True)
    os.makedirs(full_ckpt)
    n_params = sum(p.numel() for p in lm.init_lm(
        0, cfg, device="meta").parameters())
    need = n_params * LM_TRAIN_STATE_BYTES
    free = shutil.disk_usage(full_ckpt).free
    if free < need * 1.1:
        fail(f"full-depth checkpoint: {free / 1e9:.1f} GB free under "
             f"{full_ckpt}, the state needs {need / 1e9:.1f} GB "
             f"({n_params} parameters x {LM_TRAIN_STATE_BYTES} B) and a "
             f"tenth more")
    saves = []
    real_save = ck.AsyncCheckpointer.save

    def measured_save(self, state, step):
        torch.cuda.synchronize()
        before = torch.cuda.max_memory_allocated()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        real_save(self, state, step)
        torch.cuda.synchronize()
        saves.append({"step": step, "rise": torch.cuda.max_memory_allocated()
                      - base, "snapshot_s": time.perf_counter() - t0,
                      "peak_before": before})
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    draws = InitDraws()
    t0 = time.perf_counter()
    ck.AsyncCheckpointer.save = measured_save
    try:
        with draws:
            out = lm_train.train(LM_ARCH, smoke=False, steps=LM_TRAIN_STEPS,
                                 global_batch=LM_TRAIN_BATCH,
                                 seq_len=LM_TRAIN_SEQ, log_every=1,
                                 ckpt_dir=full_ckpt,
                                 ckpt_every=LM_TRAIN_STEPS,
                                 return_state=True)
    finally:
        ck.AsyncCheckpointer.save = real_save
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = max([torch.cuda.max_memory_allocated()]
               + [x["peak_before"] for x in saves])
    if counts["threefry"] < 1 or counts["threefry"] != len(draws.drawn):
        fail(f"{LM_ARCH} train: init_lm's Threefry launches {counts}, "
             f"{len(draws.drawn)} recorded")
    losses, norms, secs = out["losses"], out["grad_norms"], out["step_s"]
    p13_save_s = out["save_s"]
    if len(losses) != LM_TRAIN_STEPS or not np.isfinite(losses).all() \
            or not np.isfinite(norms).all():
        fail(f"{LM_ARCH} train: losses {losses}, grad norms {norms}")
    gap = abs(losses[0] - loss_f32) / abs(loss_f32)
    if gap > LM_TRAIN_BF16_REL:
        fail(f"{LM_ARCH} train: first-step bf16 loss {losses[0]:.5f} is "
             f"{gap:.4f} from the float32 copy's {loss_f32:.5f} (limit "
             f"{LM_TRAIN_BF16_REL})")
    n = out["num_params"]
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    warm = statistics.median(secs[1:])
    flops = 6 * n * tokens / warm
    say(f"[train] {LM_ARCH} full width ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {n / 1e9:.3f} B {cfg.param_dtype} parameters, "
        f"float32 AdamW moments, remat on): {LM_TRAIN_BATCH} x "
        f"{LM_TRAIN_SEQ} tokens a step | cold step {secs[0] * 1e3:.1f} ms, "
        f"warm median {warm * 1e3:.1f} ms over {len(secs) - 1} steps "
        f"(each: {' '.join(f'{x * 1e3:.1f}' for x in secs[1:])}) | "
        f"{tokens / warm:.0f} tokens/s | model FLOP/s (6 N tokens) "
        f"{flops / 1e12:.1f} T, {100 * flops / TENSOR_BF16_FLOP_PER_S:.1f} % "
        f"of {TENSOR_BF16_FLOP_PER_S / 1e12:.0f} T bf16 | "
        f"max_memory_allocated {peak / 1e9:.2f} GB | train() {wall:.1f} s "
        f"with init | launches {json.dumps(counts)} | {card}")
    say(f"[train] {LM_ARCH} losses "
        f"{' '.join(f'{x:.5f}' for x in losses)} | grad norms "
        f"{' '.join(f'{x:.4f}' for x in norms)} | first-step loss bf16 "
        f"{losses[0]:.5f} (forward alone {loss_bf16:.5f}) against the "
        f"float32 copy's {loss_f32:.5f}: {gap:.2e} apart (limit "
        f"{LM_TRAIN_BF16_REL}) | {card}")
    say(f"[train] train()'s init_lm: {draws.hold(LM_ARCH)}: kernel == "
        f"plain version bit for bit")
    p13 = {"losses": losses, "warm_s": warm, "tokens_s": tokens / warm,
           "peak": peak}

    # -- 13.2 the full-depth checkpoint of step 8, restored -----------------
    # The live state goes on for LM_TRAIN_FULL_MORE steps (the
    # uninterrupted losses); a fresh state restored from the files runs the
    # same steps.
    state = out.pop("state")
    del out
    if [x["step"] for x in saves] != [LM_TRAIN_STEPS]:
        fail(f"{LM_ARCH} train: saves at steps {[x['step'] for x in saves]}, "
             f"expected one at {LM_TRAIN_STEPS}")
    # the largest tensor of the state: a float32 moment of the largest
    # parameter (the embedding's, 50,304 x 2,560)
    largest = max(p.numel() * 4 for p in state.params.parameters())
    rise = saves[0]["rise"]
    step_dir = os.path.join(full_ckpt, f"step_{LM_TRAIN_STEPS:08d}")
    disk = sum(os.path.getsize(os.path.join(step_dir, f))
               for f in os.listdir(step_dir))
    tc_run = lm_train.train_config(LM_TRAIN_STEPS, LM_TRAIN_SEQ)
    step = ts.make_train_step(cfg, tc_run)
    batch_at = lm_train.make_batch_fn(cfg, dcfg, torch.device("cuda"))
    more = range(LM_TRAIN_STEPS, LM_TRAIN_STEPS + LM_TRAIN_FULL_MORE)
    want = []
    for i in more:
        state, m = step(state, batch_at(i))
        want.append(float(m["loss"]))
    del state, m
    torch.cuda.empty_cache()
    try:
        t0 = time.perf_counter()
        target = ts.init_train_state(0, cfg, tc_run, device="meta").tree()
        tree, start = ck.restore(full_ckpt, target, device="cuda")
        state = ts.TrainState.from_tree(tree, cfg, tc_run)
        del tree
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(full_ckpt, ignore_errors=True)
    got = []
    for i in more:
        state, m = step(state, batch_at(i))
        got.append(float(m["loss"]))
    del state, m
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if start != LM_TRAIN_STEPS or rel > LM_TRAIN_RESUME_RTOL:
        fail(f"{LM_ARCH} full-depth restore: from step {start}, losses "
             f"{got} against the live state's {want} ({rel:.2e} apart)")
    if rise > 2 * largest:
        fail(f"{LM_ARCH} full-depth save: max_memory_allocated rose "
             f"{rise / 1e9:.3f} GB, above twice the largest tensor "
             f"({2 * largest / 1e9:.3f} GB)")
    say(f"[train] {LM_ARCH} full-depth checkpoint of step {LM_TRAIN_STEPS} "
        f"(AsyncCheckpointer, a layer at a time to the host): "
        f"{disk / 1e9:.2f} GB on disk ({free / 1e9:.0f} GB were free) | "
        f"snapshot {saves[0]['snapshot_s']:.2f} s, save + write "
        f"{p13_save_s:.2f} s | max_memory_allocated rose {rise / 1e6:.1f} MB "
        f"during the save (limit twice the state's largest tensor, "
        f"{2 * largest / 1e6:.1f} MB) | restored in {restore_s:.2f} s; "
        f"steps {more.start}-{more.stop - 1} from it: losses "
        f"{' '.join(f'{x:.6f}' for x in got)} against the live state's "
        f"{' '.join(f'{x:.6f}' for x in want)} ({rel:.1e} apart, rtol "
        f"{LM_TRAIN_RESUME_RTOL}) | {card}")
    p13.update(save_gb=disk / 1e9, save_s=p13_save_s, restore_s=restore_s,
               rise=rise)
    note("13 train", f"{LM_ARCH} warm step {warm * 1e3:.1f} ms, "
         f"{tokens / warm:.0f} tokens/s, peak {peak / 1e9:.2f} GB; "
         f"full-depth save {disk / 1e9:.2f} GB in {p13_save_s:.2f} s (memory "
         f"rise {rise / 1e6:.1f} MB), restore {restore_s:.2f} s, resumed "
         f"losses within {rel:.1e}")

    # Where a warm step's time goes: the forward (with its checkpoints),
    # the backward (recomputing each layer and loss chunk) and the AdamW
    # update, by CUDA events around each on batch 0 (three steps; the
    # last one's split).
    state = ts.init_train_state(0, cfg, tc, device="cuda")
    loss_fn = ts.make_loss_fn(cfg, tc)
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        state.opt.zero_grad(set_to_none=True)
        ev[0].record()
        loss, _ = loss_fn(state.params, batch0)
        ev[1].record()
        loss.backward()
        ev[2].record()
        state.opt.step()
        ev[3].record()
        torch.cuda.synchronize()
    parts = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    say(f"[train] {LM_ARCH} a warm step's parts (CUDA events): forward "
        f"{parts[0]:.1f} ms, backward with recompute {parts[1]:.1f} ms, "
        f"AdamW {parts[2]:.1f} ms ({len(state.opt.leaves)} leaves, "
        f"{sum(len(g['params']) for g in state.opt.param_groups)} "
        f"tensors) | {card}")
    del state, loss, loss_fn
    torch.cuda.empty_cache()

    # -- 13.3 a restart from an async checkpoint ---------------------------
    ckpt = os.path.join(ROOT, "build", "chip_smoke", "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(smoke=False, steps=LM_TRAIN_RESTART_STEPS,
              global_batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
              n_layers=LM_TRAIN_RESTART_LAYERS, log_every=1)
    try:
        full = lm_train.train(LM_ARCH, ckpt_dir=ckpt,
                              ckpt_every=LM_TRAIN_RESTART_AT, **kw)
        shutil.rmtree(os.path.join(
            ckpt, f"step_{LM_TRAIN_RESTART_STEPS:08d}"))
        mb = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(ckpt) for f in fs) / 1e6
        resumed = lm_train.train(LM_ARCH, ckpt_dir=ckpt, **kw)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    want = full["losses"][LM_TRAIN_RESTART_AT:]
    if resumed["resumed_from"] != LM_TRAIN_RESTART_AT or not np.allclose(
            resumed["losses"], want, rtol=LM_TRAIN_RESUME_RTOL, atol=0):
        fail(f"{LM_ARCH} restart: resumed from {resumed['resumed_from']} "
             f"with losses {resumed['losses']}, uninterrupted {want}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed["losses"], want))
    say(f"[train] restart at {LM_TRAIN_RESTART_LAYERS} layers "
        f"({full['num_params'] / 1e9:.3f} B parameters; {mb:.0f} MB on disk "
        f"at step {LM_TRAIN_RESTART_AT}): {LM_TRAIN_RESTART_STEPS} steps "
        f"saving at {LM_TRAIN_RESTART_AT} ({full['save_s']:.2f} s in "
        f"checkpoint calls), a fresh trainer restored in "
        f"{resumed['restore_s']:.2f} s reran steps {LM_TRAIN_RESTART_AT}-"
        f"{LM_TRAIN_RESTART_STEPS - 1}: losses "
        f"{' '.join(f'{x:.6f}' for x in resumed['losses'])} against "
        f"{' '.join(f'{x:.6f}' for x in want)} ({rel:.1e} apart, rtol "
        f"{LM_TRAIN_RESUME_RTOL}) | {card}")

    # -- 13.4 every SMOKE architecture, float32, card against CPU ----------
    for arch in all_archs():
        scfg = dc.replace(get_config(arch, smoke=True), param_dtype="float32")
        stc = ts.TrainConfig(loss_chunk=8, q_chunk=8, kv_chunk=8)
        cpu_state = ts.init_train_state(0, scfg, stc, device="cpu")
        gpu_state = ts.TrainState.from_tree(lm.tree_map(
            lambda t: t.to("cuda"), cpu_state.tree()), scfg, stc)
        if torch.backends.cuda.matmul.allow_tf32:
            fail(f"{arch}: TF32 is on for a float32 model on the card")
        sdc = lm_data.DataConfig(vocab=scfg.vocab, seq_len=16,
                                 global_batch=2)
        step = ts.make_train_step(scfg, stc)
        res = {}
        for dev, state in (("cuda", gpu_state), ("cpu", cpu_state)):
            rng = np.random.default_rng(13)
            seen = []
            for i in range(LM_TRAIN_SMOKE_STEPS):
                batch = lm_data.batch_at(sdc, i)
                if scfg.family == "audio":
                    batch["enc_embeds"] = rng.normal(
                        size=(2, 16, scfg.d_model)).astype(np.float32)
                if scfg.family == "vlm":
                    batch["prefix_embeds"] = rng.normal(
                        size=(2, scfg.vlm_prefix, scfg.d_model)).astype(
                        np.float32)
                state, m = step(state, {k: torch.from_numpy(v).to(dev)
                                        for k, v in batch.items()})
                seen.append((float(m["loss"]), float(m["grad_norm"])))
            res[dev] = np.array(seen)
        g, c = res["cuda"], res["cpu"]
        rel = float((np.abs(g - c) / np.abs(c)).max())
        if not np.isfinite(g).all() or rel > LM_TRAIN_TOL:
            fail(f"{arch}: card vs CPU train losses / grad norms {g.tolist()}"
                 f" against {c.tolist()} ({rel:.2e} apart)")
        say(f"[train] {arch} smoke float32: {LM_TRAIN_SMOKE_STEPS} train "
            f"steps, card vs CPU losses and grad norms max relative gap "
            f"{rel:.2e} (tolerance {LM_TRAIN_TOL:.0e}) | {card}")
    return p13


def first_layers(model, cfg, n: int):
    """The first ``n`` layers of ``model`` (an ``lm.LM``) as a tree of
    copies in ``repro``'s layout, and the config of that depth: the
    embedding and final norm as they are, each segment cut where the
    ``n`` layers end."""
    import dataclasses as dc

    import torch

    from repro_torch import tree as tm
    from repro_torch.models import lm

    cut = dc.replace(cfg, n_layers=n)
    counts = [c for _, c in lm.segments(cut)]
    pairs = []
    for leaf in lm.stacked_leaves(model):
        if leaf.stacked:
            keep = counts[leaf.path[1]]
            pairs.append((leaf.path, torch.stack(
                [p.detach().clone() for p in leaf.params[:keep]])))
        else:
            pairs.append((leaf.path, leaf.params[0].detach().clone()))
    return tm.nest(pairs), cut


def family_phase(*, card, zero_counts, read_counts) -> dict:
    """Phase 15: the SSD, hybrid and MLA + MoE families at their published
    full width and depth, through ``launch.serve.serve`` with phase 12's
    traffic and ``launch.train.train`` with phase 13's step."""
    import dataclasses as dc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import lm_data
    from repro_torch.launch import serve as lm_serve
    from repro_torch.launch import train as lm_train
    from repro_torch.models import lm, moe
    from repro_torch.train import train_step as ts

    heads = {}
    rng_prompts = np.random.default_rng(0)
    for arch, trains in FAMILY_ARCHS:
        cfg = get_config(arch)
        t_arch = time.perf_counter()
        # -- serve: twice, the first recording init_lm's draws -------------
        torch.backends.cuda.matmul.allow_tf32 = True
        draws = InitDraws()
        for run in ("cold", "warm"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            with draws if run == "cold" else contextlib.nullcontext():
                out = lm_serve.serve(arch, smoke=False,
                                     num_requests=LM_REQUESTS,
                                     prompt_len=LM_PROMPT,
                                     decode_steps=LM_STEPS)
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated()
            toks = out["tokens"]
            if toks.shape != (LM_REQUESTS, LM_STEPS + 1) or toks.min() < 0 \
                    or toks.max() >= cfg.vocab:
                fail(f"{arch}: served tokens {toks.shape} out of range")
            if counts["threefry"] < 1:
                fail(f"{arch}: init_lm drew no weights through the "
                     f"Threefry kernel: {counts}")
            if run == "warm" and not np.array_equal(toks, first):
                fail(f"{arch}: two serves of one seed gave other tokens")
            first = toks
        if torch.backends.cuda.matmul.allow_tf32:
            fail(f"{arch}: serve() left TF32 on for CUDA matmuls")
        if len(draws.drawn) != counts["threefry"]:
            fail(f"{arch}: recorded {len(draws.drawn)} Threefry launches, "
                 f"the wrapper counted {counts['threefry']}")
        n = out["num_params"]
        decode_ms = out["decode_s"] * 1e3 / LM_STEPS
        tok_s = LM_REQUESTS * LM_STEPS / out["decode_s"]
        say(f"[family] {arch} serve, full width and depth ({cfg.n_layers} "
            f"layers, d {cfg.d_model}, {n / 1e9:.3f} B {cfg.param_dtype} "
            f"parameters): {LM_REQUESTS} requests x {LM_PROMPT} prompt "
            f"tokens, {LM_STEPS} greedy steps, warm | prefill "
            f"{out['prefill_s'] * 1e3:.1f} ms | decode {decode_ms:.2f} ms a "
            f"step, {tok_s:.0f} tok/s | max_memory_allocated "
            f"{peak / 1e9:.2f} GB | tokens of the two serves equal | "
            f"launches {json.dumps(counts)} | {card}")
        say(f"[family] {arch} init_lm's {draws.hold(arch)}: kernel == "
            f"plain version bit for bit")
        head = {"prefill_ms": out["prefill_s"] * 1e3,
                "decode_ms": decode_ms, "tok_s": tok_s,
                "serve_peak_gb": peak / 1e9, "params_b": n / 1e9}
        del out
        torch.cuda.empty_cache()

        # -- bf16 logits against a float32 copy of the weights ---------------
        model = lm.init_lm(0, cfg, device="cuda")
        depth = cfg.n_layers
        if 6 * n > FAMILY_F32_FIT_BYTES:    # bf16 + float32 beside it
            tree, cfg_cmp = first_layers(model, cfg, FAMILY_F32_LAYERS)
            del model
            torch.cuda.empty_cache()
            model = lm.LM(cfg_cmp, tree)
            depth = FAMILY_F32_LAYERS
        else:
            cfg_cmp = cfg
        cfg32 = dc.replace(cfg_cmp, param_dtype="float32")
        model32 = lm.LM(cfg32, lm.tree_map(lambda t: t.float(),
                                           model.tree()))
        prompts = torch.from_numpy(rng_prompts.integers(
            0, cfg.vocab, (LM_REQUESTS, LM_PROMPT)).astype(np.int32)).cuda()
        routes = []
        real_top_k = moe.top_k

        def recording_top_k(x, k):
            vals, idx = real_top_k(x, k)
            routes.append(torch.sort(idx, dim=-1).values)
            return vals, idx
        moe.top_k = recording_top_k
        try:
            with torch.inference_mode():
                lb = lm.forward(model, prompts, cfg_cmp)[0].float()
                lf = lm.forward(model32, prompts, cfg32)[0]
        finally:
            moe.top_k = real_top_k
        rel = float((lb - lf).norm() / lf.norm())
        top1 = float((lb.argmax(-1) == lf.argmax(-1)).float().mean())
        flips = ""
        if routes:
            half = len(routes) // 2
            moved = [float((a != b).any(-1).float().mean())
                     for a, b in zip(routes[:half], routes[half:])]
            flips = (f" | routing: tokens whose expert set differs, by MoE "
                     f"layer {' '.join(f'{x:.4f}' for x in moved)}")
            head["route_flips"] = max(moved)
        lim_rel, lim_top1 = (
            (LM_MOE_BF16_REL, LM_MOE_BF16_TOP1) if cfg.moe is not None else
            (LM_SSM_BF16_REL, LM_SSM_BF16_TOP1) if cfg.family == "ssm" else
            (LM_BF16_REL, LM_BF16_TOP1))
        if not torch.isfinite(lb).all() or rel > lim_rel or top1 < lim_top1:
            fail(f"{arch}: bf16 logits part from the float32 copy's: "
                 f"relative {rel:.4f} (limit {lim_rel}), top-1 agreement "
                 f"{top1:.4f} (limit {lim_top1}){flips}")
        cut = "" if depth == cfg.n_layers else (
            f" (its first {depth} layers at full width: the float32 copy of "
            f"all {cfg.n_layers} does not fit beside the bf16 model)")
        say(f"[family] {arch} bf16 against its float32 copy{cut}, forward "
            f"over {LM_REQUESTS} x {LM_PROMPT} prompts: logits relative gap "
            f"{rel:.4f} (limit {lim_rel}), top-1 agreement {top1:.4f} "
            f"(limit {lim_top1}){flips} | {card}")
        head.update(rel=rel, top1=top1)
        del model, model32, lb, lf, routes
        torch.cuda.empty_cache()

        # -- train: phase 13's step, 8 steps --------------------------------
        if not trains:
            say(f"[family] {arch} training not run: its train state (bf16 "
                f"weights, float32 AdamW moments and gradients, ~12 B a "
                f"parameter: ~{12 * n / 1e9:.0f} GB) does not fit one "
                f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.0f}"
                f" GiB card | {card}")
            heads[arch] = head
            say(f"[family] {arch} {time.perf_counter() - t_arch:.1f} s")
            continue
        dcfg = lm_data.DataConfig(vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ,
                                  global_batch=LM_TRAIN_BATCH)
        batch0 = {k: torch.from_numpy(v).cuda()
                  for k, v in lm_data.batch_at(dcfg, 0).items()}
        tc = ts.TrainConfig(loss_chunk=LM_TRAIN_SEQ, q_chunk=LM_TRAIN_SEQ,
                            kv_chunk=LM_TRAIN_SEQ)
        model = lm.init_lm(0, cfg, device="cuda")
        cfg32 = dc.replace(cfg, param_dtype="float32")
        model32 = lm.LM(cfg32, lm.tree_map(lambda t: t.float(),
                                           model.tree()))
        with torch.no_grad():
            loss_f32 = float(ts.make_loss_fn(cfg32, tc)(model32, batch0)[0])
        del model, model32
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        draws = InitDraws()
        with draws:
            out = lm_train.train(arch, smoke=False, steps=LM_TRAIN_STEPS,
                                 global_batch=LM_TRAIN_BATCH,
                                 seq_len=LM_TRAIN_SEQ, log_every=100)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        if counts["threefry"] < 1 or counts["threefry"] != len(draws.drawn):
            fail(f"{arch} train: init_lm's Threefry launches {counts}, "
                 f"{len(draws.drawn)} recorded")
        losses, norms, secs = out["losses"], out["grad_norms"], out["step_s"]
        if len(losses) != LM_TRAIN_STEPS or not np.isfinite(losses).all() \
                or not np.isfinite(norms).all():
            fail(f"{arch} train: losses {losses}, grad norms {norms}")
        gap = abs(losses[0] - loss_f32) / abs(loss_f32)
        if gap > LM_TRAIN_BF16_REL:
            fail(f"{arch} train: first-step bf16 loss {losses[0]:.5f} is "
                 f"{gap:.4f} from the float32 copy's {loss_f32:.5f} (limit "
                 f"{LM_TRAIN_BF16_REL})")
        warm = statistics.median(secs[1:])
        tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
        flops = 6 * n * tokens / warm
        say(f"[family] {arch} train, full width and depth, {LM_TRAIN_BATCH} "
            f"x {LM_TRAIN_SEQ} tokens a step, remat on: cold step "
            f"{secs[0] * 1e3:.1f} ms, warm median {warm * 1e3:.1f} ms | "
            f"{tokens / warm:.0f} tokens/s | 6 N tokens "
            f"{flops / 1e12:.1f} TFLOP/s, "
            f"{100 * flops / TENSOR_BF16_FLOP_PER_S:.1f} % of bf16 peak | "
            f"max_memory_allocated {peak / 1e9:.2f} GB | losses "
            f"{' '.join(f'{x:.4f}' for x in losses)} | grad norms "
            f"{' '.join(f'{x:.3f}' for x in norms)} | first-step loss "
            f"{gap:.2e} from the float32 copy's {loss_f32:.5f} (limit "
            f"{LM_TRAIN_BF16_REL}) | {card}")
        say(f"[family] {arch} train()'s init_lm: {draws.hold(arch)}: "
            f"kernel == plain version bit for bit")
        head.update(step_ms=warm * 1e3, train_tok_s=tokens / warm,
                    train_peak_gb=peak / 1e9, loss_gap=gap)
        heads[arch] = head
        del out
        torch.cuda.empty_cache()
        say(f"[family] {arch} {time.perf_counter() - t_arch:.1f} s")
    return heads


class DryRuns:
    """Phase 14.4's CPU children, started when the script starts (they
    need no card and overlap the card's phases) and stopped at exit
    whatever happens: the full-depth dry run and ``dryrun_hdc`` at once,
    and on a thread, one after another, the ``DRYRUN_ARCHS`` dry runs at
    ``DRYRUN_LAYERS`` layers and the four ranks of the SSD prefill under
    ``DECODE_RULES`` (``--prefill-worker``)."""

    def __init__(self):
        self.out = os.path.join(ROOT, "build", "chip_smoke", "dryrun_torch")
        self.procs = {}
        self.chain_out = {}
        self.t0 = time.perf_counter()
        self.env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
                    "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}

    def start(self) -> None:
        import atexit
        import shutil
        import threading

        shutil.rmtree(self.out, ignore_errors=True)
        os.makedirs(self.out)
        cmds = {"dryrun": ["-m", "repro_torch.launch.dryrun", "--arch",
                           LM_ARCH, "--shape", "train_4k"],
                "dryrun_hdc": ["-m", "repro_torch.launch.dryrun_hdc",
                               "--both-meshes"]}
        for name, cmd in cmds.items():
            self.procs[name] = subprocess.Popen(
                [sys.executable, *cmd, "--out", self.out], cwd=ROOT,
                env=self.env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        atexit.register(self.stop)
        self.chain = threading.Thread(target=self._chain, daemon=True)
        self.chain.start()

    def _run(self, name: str, procs: list) -> None:
        self.procs[name] = procs
        logs = [p.communicate()[0] for p in procs]
        self.chain_out[name] = ([p.returncode for p in procs], logs)

    def _chain(self) -> None:
        try:
            for arch in DRYRUN_ARCHS:
                self._run(f"dryrun {arch}", [subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", "train_4k", "--layers",
                     str(DRYRUN_LAYERS), "--out",
                     os.path.join(self.out, "layers")], cwd=ROOT,
                    env=self.env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)])
            path = os.path.join(self.out, "prefill.json")
            self._run("prefill", _start_ranks(
                ["--prefill-worker", path], 4,
                {"OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}))
        except Exception as e:              # reported by finish()
            self.chain_out["chain"] = ([1], [f"{type(e).__name__}: {e}"])

    def stop(self) -> None:
        for p in self.procs.values():
            for q in p if isinstance(p, list) else [p]:
                if q.poll() is None:
                    q.kill()
                    q.wait()

    def finish(self, timeout: float) -> dict:
        """Each child's output once it exits 0 (a failure fails)."""
        logs = {}
        t_end = time.perf_counter() + timeout
        for name, p in list(self.procs.items()):
            if isinstance(p, list):
                continue
            try:
                logs[name] = p.communicate(
                    timeout=max(t_end - time.perf_counter(), 1))[0]
            except subprocess.TimeoutExpired:
                self.stop()
                fail(f"{name} did not finish in {timeout:.0f} s more")
            if p.returncode != 0:
                fail(f"{name} exited {p.returncode}:\n{logs[name][-3000:]}")
        self.chain.join(max(t_end - time.perf_counter(), 1))
        if self.chain.is_alive():
            self.stop()
            fail(f"14.4's chained children did not finish in {timeout:.0f} "
                 f"s more (done: {', '.join(self.chain_out) or 'none'})")
        for name, (codes, out) in self.chain_out.items():
            if any(codes):
                fail(f"{name} exited {codes}:\n{out[0][-3000:]}")
            logs[name] = out[0]
        return logs


def prefill_worker(out_path: str) -> int:
    """One of 14.4's four gloo CPU ranks: each smoke architecture of
    ``PREFILL_ARCHS`` (float32, SSD heads) prefilled on a 2 x 2
    ``("data", "model")`` mesh under ``DECODE_RULES`` and on one device
    (this process), logits and every decode cache leaf compared; rank 0
    writes ``{arch: {"gap": .., "scale": ..}}`` or ``{arch: {"error":
    ..}}`` (the first failing op's message and the port's frames)."""
    import dataclasses as dc
    import traceback

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import tree as tm
    from repro_torch.configs import get_config
    from repro_torch.distributed import param_specs as ps, sharding
    from repro_torch.models import lm
    from repro_torch.train.optimizer import full

    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = sharding.DECODE_RULES
    out = {}
    for arch in PREFILL_ARCHS:
        cfg = dc.replace(get_config(arch, smoke=True), param_dtype="float32")
        tok = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (4, 12)).astype(np.int64))
        with torch.no_grad():
            want_logits, want_caches, _ = lm.prefill(
                lm.init_lm(0, cfg, device="cpu"), tok, cfg, 32, q_chunk=8,
                kv_chunk=8)
        try:
            model = ps.distribute_lm(lm.init_lm(0, cfg, device="cpu"), mesh,
                                     rules)
            with torch.no_grad(), sharding.use_rules(mesh, rules):
                got_logits, got_caches, _ = lm.prefill(
                    model, ps.distribute(tok, mesh, ps.resolve_leaf(
                        tuple(tok.shape), ("batch", None), mesh, rules)),
                    cfg, 32, q_chunk=8, kv_chunk=8)
            pairs = [("logits", full(got_logits), want_logits)] + [
                ("/".join(map(str, p)), full(g), w) for (p, g), (_, w) in
                zip(tm.flatten(got_caches), tm.flatten(want_caches))]
            worst = {}
            for name, g, w in pairs:
                if g.shape != w.shape:
                    raise ValueError(f"{name}: shape {tuple(g.shape)} != "
                                     f"{tuple(w.shape)}")
                scale = float(w.abs().max()) if w.numel() else 0.0
                gap = float((g.float() - w.float()).abs().max()) \
                    if w.numel() else 0.0
                if not worst or gap / max(scale, 1e-30) > \
                        worst["gap"] / max(worst["scale"], 1e-30):
                    worst = {"leaf": name, "gap": gap, "scale": scale}
            out[arch] = dict(worst, leaves=len(pairs))
        except Exception as e:              # recorded, failed by the parent
            frames = [f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                      for f in traceback.extract_tb(e.__traceback__)
                      if "repro_torch" in f.filename]
            out[arch] = {"error": f"{type(e).__name__}: {str(e)[:400]}",
                         "frames": frames[-4:]}
    if dist.get_rank() == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _start_ranks(args: list[str], world: int, env: dict) -> list:
    """``world`` ranks of ``chip_smoke.py *args`` (the group from the
    environment, as torchrun makes it)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(world), **env}
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *args], cwd=ROOT,
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _start_pair(task: str, paths: list[str]) -> list:
    """Two ranks of ``--mesh-worker task`` (the group from the
    environment, as torchrun makes it)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": "2", "OMP_NUM_THREADS": "4"}
    for path in paths:
        if os.path.exists(path):
            os.unlink(path)
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-worker", task,
         paths[r]], cwd=ROOT, env={**env, "RANK": str(r),
                                   "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]


def _finish_pair(procs, timeout: float) -> list[tuple[int, str]]:
    """Each rank's exit code and log; a rank still running at
    ``timeout`` is killed (its code then says so)."""
    out = []
    try:
        for p in procs:
            try:
                log = p.communicate(timeout=timeout)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                log = p.communicate()[0] + "\n(killed: timed out)"
            out.append((p.returncode, log))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def mesh_worker(task: str, out_path: str) -> int:
    """One rank of phase 14's two-rank runs.  ``probe``: each collective
    of ``MESH_COLLECTIVES`` on gloo over CUDA tensors on the one card,
    recorded as it went (the probe's job is to find what raises).
    A collective gloo cannot run on CUDA tensors may abort the process
    (gloo's transport throws from a C++ thread), so each is probed in a
    pair of its own (``probe:NAME``).  ``train``: 14.2 and 14.3 (NCCL,
    a card a rank)."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    rank = int(os.environ["RANK"])
    out: dict = {"rank": rank}
    if task.startswith("probe:"):
        name = task.split(":", 1)[1]
        dist.init_process_group("gloo")
        dev = torch.device("cuda", 0)
        x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
        checks = {
            "all_gather_into_tensor": lambda: _probe_gather(dist, x),
            "reduce_scatter_tensor": lambda: _probe_scatter(dist, x),
            "all_to_all_single": lambda: _probe_a2a(dist, x),
            "send_recv": lambda: _probe_p2p(dist, x, rank)}
        try:
            out[name] = "ok" if checks[name]() else "wrong values"
        except Exception as e:              # what the probe is for
            out[name] = f"{type(e).__name__}: {str(e)[:200]}"
    else:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.distributed import pipeline
        from repro_torch.launch import train as lm_train

        torch.cuda.set_device(rank)
        dist.init_process_group("nccl")
        out["backend"] = str(dist.get_backend())
        kw = dict(smoke=False, global_batch=LM_TRAIN_BATCH,
                  seq_len=LM_TRAIN_SEQ, n_layers=MESH_LAYERS,
                  log_every=100)
        # the 1 x 2 run saves steps 2 and 4 for 14.3's one-rank restore
        ckpt = os.path.join(ROOT, "build", "chip_smoke", "mesh_ckpt")
        for shape in ((1, 2), (2, 1)):
            torch.cuda.reset_peak_memory_stats()
            got = lm_train.train(
                LM_ARCH, steps=MESH_STEPS, host_shape=shape,
                **(dict(ckpt_dir=ckpt, ckpt_every=2) if shape == (1, 2)
                   else {}), **kw)
            out["x".join(map(str, shape))] = {
                "losses": got["losses"], "step_s": got["step_s"],
                "peak": torch.cuda.max_memory_allocated()}
        # 14.3: GPipe over the two ranks as pods, float32
        pods = init_device_mesh("cuda", (2,), mesh_dim_names=("pod",))
        gen = torch.Generator().manual_seed(14)
        d = 2560
        w = (torch.randn(2, d, d, generator=gen) * d ** -0.5).cuda()
        x = torch.randn(64, d, generator=gen).cuda()
        t0 = time.perf_counter()
        y = pipeline.pipelined_apply(w, x, lambda p, xb: torch.tanh(xb @ p),
                                     mesh=pods, axis="pod",
                                     num_microbatches=4)
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        want = x
        for stage in range(2):
            want = torch.tanh(want @ w[stage])
        out["pipe"] = {"gap": float((y - want).abs().max()),
                       "s": pipe_s}
    with open(out_path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _probe_gather(dist, x) -> bool:
    import torch
    got = torch.empty(2 * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(got, x)
    want = torch.cat([torch.arange(4, dtype=x.dtype, device=x.device) + 10 * r
                      for r in range(2)])
    return bool(torch.equal(got, want))


def _probe_scatter(dist, x) -> bool:
    import torch
    got = torch.empty(2, dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(got, x)
    base = torch.arange(4, dtype=x.dtype, device=x.device)
    want = (2 * base + 10)[2 * dist.get_rank():2 * dist.get_rank() + 2]
    return bool(torch.equal(got, want))


def _probe_a2a(dist, x) -> bool:
    import torch
    got = torch.empty_like(x)
    dist.all_to_all_single(got, x)
    r = dist.get_rank()
    base = torch.arange(4, dtype=x.dtype, device=x.device)
    want = torch.cat([base[2 * r:2 * r + 2] + 10 * k for k in range(2)])
    return bool(torch.equal(got, want))


def _probe_p2p(dist, x, rank: int) -> bool:
    import torch
    got = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, 1 - rank),
           dist.P2POp(dist.irecv, got, 1 - rank)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return bool(torch.equal(got, x - 10 * rank + 10 * (1 - rank)))


def mesh_phase(*, card, zero_counts, read_counts, p13, dry) -> None:
    """Phase 14: training across ranks and the dry runs."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.launch import train as lm_train

    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    # -- 14.0 the collectives gloo runs on CUDA tensors --------------------
    t0 = time.perf_counter()
    pairs = {}
    for c in MESH_COLLECTIVES:
        paths = [os.path.join(out_dir, f"mesh_probe_{c}{r}.json")
                 for r in range(2)]
        pairs[c] = (paths, _start_pair(f"probe:{c}", paths))
    found = {}
    for c, (paths, procs) in pairs.items():
        ends = _finish_pair(procs, timeout=120)
        said = []
        for (code, log), path in zip(ends, paths):
            if code == 0:
                with open(path) as f:
                    said.append(json.load(f)[c])
            else:
                last = [ln for ln in log.splitlines() if ln.strip()]
                said.append(f"rank exited {code}: "
                            f"{(last[-1] if last else '')[:160]}")
        found[c] = said[0] if all(x == "ok" for x in said) else \
            next(x for x in said if x != "ok")
    missing = [c for c in MESH_COLLECTIVES if found[c] != "ok"]
    say(f"[mesh] 14.0 gloo over CUDA tensors, two ranks on the one card, "
        f"a pair a collective: "
        + "; ".join(f"{c}: {found[c]}" for c in MESH_COLLECTIVES)
        + f" | missing: {', '.join(missing) or 'none'} "
        f"({time.perf_counter() - t0:.1f} s with start-up) | {card}")

    # -- 14.1 one rank over NCCL, full depth, through the mesh path --------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out = lm_train.train(LM_ARCH, smoke=False, steps=LM_TRAIN_STEPS,
                         global_batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
                         log_every=100, host_shape=(1, 1))
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    backend = str(dist.get_backend())
    dist.destroy_process_group()
    if counts["threefry"] < 1:
        fail(f"14.1: init_lm's Threefry kernel did not launch: {counts}")
    if out["mesh"] != (1, 1) or backend != "nccl":
        fail(f"14.1 ran on mesh {out['mesh']} over {backend}")
    losses = out["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, p13["losses"]))
    if len(losses) != LM_TRAIN_STEPS or rel > MESH_EQUAL_RTOL:
        fail(f"14.1: mesh-path losses {losses} against phase 13's "
             f"{p13['losses']} ({rel:.2e} apart, rtol {MESH_EQUAL_RTOL})")
    secs = out["step_s"]
    warm = statistics.median(secs[1:])
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    say(f"[mesh] 14.1 {LM_ARCH} full width and depth on a 1 x 1 mesh "
        f"over {backend} (DTensor parameters, moments and batches): cold "
        f"step {secs[0] * 1e3:.1f} ms, warm median {warm * 1e3:.1f} ms "
        f"(phase 13: {p13['warm_s'] * 1e3:.1f} ms, x"
        f"{warm / p13['warm_s']:.2f}) | {tokens / warm:.0f} tokens/s "
        f"(phase 13: {p13['tokens_s']:.0f}) | max_memory_allocated "
        f"{peak / 1e9:.2f} GB (phase 13: {p13['peak'] / 1e9:.2f} GB) | "
        f"losses equal phase 13's within {rel:.1e} (rtol "
        f"{MESH_EQUAL_RTOL:.0e}) | train() {wall:.1f} s with init | "
        f"launches {json.dumps(counts)} | {card}")
    note("14 mesh", f"14.1 warm {warm * 1e3:.1f} ms (x{warm / p13['warm_s']:.2f}), losses equal phase 13's")
    del out
    torch.cuda.empty_cache()

    # -- 14.2 / 14.3 two ranks ------------------------------------------------
    cards = torch.cuda.device_count()
    if cards < 2:
        say(f"[mesh] 14.2 / 14.3 wait for a machine with two cards: this "
            f"one has {cards}, NCCL takes one rank a card, and gloo over "
            f"CUDA tensors lacks {', '.join(missing) or 'nothing probed'} "
            f"(and two-rank DTensor training over gloo on one card "
            f"crashed, PERF.md §6) | {card}")
    else:
        t0 = time.perf_counter()
        ref = lm_train.train(LM_ARCH, smoke=False, steps=MESH_STEPS,
                             global_batch=LM_TRAIN_BATCH,
                             seq_len=LM_TRAIN_SEQ, n_layers=MESH_LAYERS,
                             log_every=100, mesh_kind="none")
        ref_s = statistics.median(ref["step_s"][1:])
        paths = [os.path.join(out_dir, f"mesh_train{r}.json")
                 for r in range(2)]
        ckpt = os.path.join(out_dir, "mesh_ckpt")
        shutil.rmtree(ckpt, ignore_errors=True)
        try:
            for r, (code, log) in enumerate(_finish_pair(
                    _start_pair("train", paths), timeout=900)):
                if code != 0:
                    fail(f"14.2 rank {r} exited {code}:\n{log[-3000:]}")
            ranks = []
            for path in paths:
                with open(path) as f:
                    ranks.append(json.load(f))
            for shape in ("1x2", "2x1"):
                got = ranks[0][shape]["losses"]
                rel = max(abs(a - b) / abs(b)
                          for a, b in zip(got, ref["losses"]))
                if rel > MESH_TRAIN_RTOL or any(
                        r[shape]["losses"] != got for r in ranks):
                    fail(f"14.2 {shape}: losses {got} against one "
                         f"device's {ref['losses']} ({rel:.2e} apart)")
                say(f"[mesh] 14.2 {LM_ARCH} width {MESH_LAYERS} layers on "
                    f"{shape} over {ranks[0]['backend']} ({cards} card(s)): "
                    f"losses {' '.join(f'{x:.5f}' for x in got)} vs one "
                    f"device {' '.join(f'{x:.5f}' for x in ref['losses'])} "
                    f"({rel:.1e} apart, rtol {MESH_TRAIN_RTOL:.0e}) | warm "
                    f"step per rank "
                    + ", ".join(f"{statistics.median(r[shape]['step_s'][1:]) * 1e3:.1f} ms"
                                for r in ranks)
                    + f" (one device {ref_s * 1e3:.1f} ms) | "
                    f"max_memory_allocated per rank "
                    + ", ".join(f"{r[shape]['peak'] / 1e9:.2f} GB"
                                for r in ranks)
                    + f" | {card}")
            if max(r["pipe"]["gap"] for r in ranks) > MESH_PIPE_ATOL:
                fail(f"14.3 pipelined_apply: {[r['pipe'] for r in ranks]}")
            kept = ranks[0]["1x2"]["losses"]
            shutil.rmtree(os.path.join(ckpt, f"step_{MESH_STEPS:08d}"))
            resumed = lm_train.train(
                LM_ARCH, smoke=False, steps=MESH_STEPS,
                global_batch=LM_TRAIN_BATCH,
                seq_len=LM_TRAIN_SEQ, n_layers=MESH_LAYERS, log_every=100,
                mesh_kind="none", ckpt_dir=ckpt)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        want = kept[2:]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(resumed["losses"], want))
        if resumed["resumed_from"] != 2 or rel > MESH_TRAIN_RTOL:
            fail(f"14.3 restore: from {resumed['resumed_from']}, losses "
                 f"{resumed['losses']} against the 2-rank run's {want}")
        p = ranks[0]["pipe"]
        say(f"[mesh] 14.3 pipelined_apply over 2 pods (tanh(x @ w), 64 x "
            f"2,560 float32, 4 microbatches): max gap to the sequential "
            f"loop {p['gap']:.1e} (atol {MESH_PIPE_ATOL:.0e}), "
            f"{p['s'] * 1e3:.1f} ms | a 1 x 2 checkpoint of step 2 "
            f"restored on one rank: losses "
            f"{' '.join(f'{x:.5f}' for x in resumed['losses'])} vs the "
            f"2-rank run's {' '.join(f'{x:.5f}' for x in want)} "
            f"({rel:.1e} apart, rtol {MESH_TRAIN_RTOL:.0e}) | "
            f"{time.perf_counter() - t0:.1f} s with start-up | {card}")

    # -- 14.4 the dry runs (CPU children, counts of a fake group) -------------
    dry_phase(dry)


def dry_phase(dry) -> None:
    """Phase 14.4: the CPU children's results (counts of a fake group;
    parity of the decode-rules prefill)."""
    import torch

    t0 = time.perf_counter()
    logs = dry.finish(timeout=600)
    waited = time.perf_counter() - t0
    cell = json.load(open(os.path.join(
        dry.out, f"{LM_ARCH}.train_4k.16x16.json")))
    if not cell["ok"]:
        fail(f"dry run {LM_ARCH} train_4k: {cell['error'][:2000]}")
    coll = cell["collectives"]
    kinds = ", ".join(f"{k} {coll[k]['count']} ({coll[k]['result_bytes'] / 1e9:.2f} GB)"
                      for k in ("all-gather", "all-reduce", "reduce-scatter",
                                "all-to-all", "collective-permute")
                      if coll[k]["count"])
    say(f"[mesh] 14.4 dryrun {LM_ARCH} train_4k on a fake 16 x 16 group "
        f"({cell['extra']['n_layers']} layers, CPU child, "
        f"{cell['seconds']:.1f} s): per device arguments "
        f"{cell['memory']['argument_size_in_bytes'] / 1e9:.3f} GB, outputs "
        f"{cell['memory']['output_size_in_bytes'] / 1e9:.3f} GB, FLOPs "
        f"{cell['cost']['flops']:.3e} (6ND / 256: "
        f"{cell['extra']['model_flops_6nd'] / 256:.3e}), collectives "
        f"{kinds}, link bytes {coll['total_link_bytes'] / 1e9:.2f} GB "
        f"(waited {waited:.1f} s at 14.4; started "
        f"{time.perf_counter() - dry.t0:.0f} s ago)")
    hdc = [ln for ln in logs["dryrun_hdc"].splitlines()
           if ln.startswith("[demeter_hdc")]
    if len(hdc) != 6:
        fail(f"dryrun_hdc: {logs['dryrun_hdc'][-2000:]}")
    for ln in hdc:
        say(f"[mesh] 14.4 {ln}")
    # on this machine's own torch: the full configurations that pad heads
    # and mamba2's, at DRYRUN_LAYERS layers, and the SSD prefill under
    # DECODE_RULES on a 2 x 2 gloo CPU mesh
    parts = []
    for arch in DRYRUN_ARCHS:
        c = json.load(open(os.path.join(
            dry.out, "layers", f"{arch}.train_4k.16x16.json")))
        if not c["ok"]:
            fail(f"dry run {arch} train_4k at {DRYRUN_LAYERS} layers: "
                 f"{c['error'][:2000]}")
        parts.append(f"{arch} OK ({c['seconds']:.1f} s, FLOPs "
                     f"{c['cost']['flops']:.3e}, arguments "
                     f"{c['memory']['argument_size_in_bytes'] / 1e9:.3f} GB)")
    pre = json.load(open(os.path.join(dry.out, "prefill.json")))
    for arch in PREFILL_ARCHS:
        r = pre[arch]
        if "error" in r or r["gap"] > PREFILL_RTOL * r["scale"]:
            fail(f"SSD prefill of {arch} under DECODE_RULES on 2 x 2 against "
                 f"one device: {r}")
    say(f"[mesh] 14.4 torch {torch.__version__}: train_4k on a fake 16 x 16 "
        f"group at full width, {DRYRUN_LAYERS} layers: " + "; ".join(parts)
        + " | SSD prefill under DECODE_RULES, 2 x 2 gloo CPU mesh (4 ranks) "
        "against one device, float32: " + "; ".join(
            f"{a} worst {pre[a]['leaf']} {pre[a]['gap']:.1e} at a scale of "
            f"{pre[a]['scale']:.2e} ({pre[a]['leaves']} leaves)"
            for a in PREFILL_ARCHS) + f" (rtol {PREFILL_RTOL:.0e})")
    note("14 mesh", f"14.4 on torch {torch.__version__}: {len(parts)} "
         f"{DRYRUN_LAYERS}-layer dry runs OK, SSD decode-rules prefill "
         f"within {max(pre[a]['gap'] / pre[a]['scale'] for a in PREFILL_ARCHS):.1e}")


def shard_worker(out_path: str) -> int:
    """One rank of phase 9's two-rank run (rank and world size from the
    environment): builds phase 3's RefDB through ``sharded`` over
    ``cuda_fused``, profiles phase 3's reads, writes its result."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.hd_space import HDSpace
    from repro_torch.genomics import synth
    from repro_torch.kernels import am_matmul, fused_profile, hamming_am
    from repro_torch.kernels import hdc_encoder
    from repro_torch.pipeline import (ProfilerConfig, ProfilingSession,
                                      SyntheticSource)

    counters = {"hdc_encoder": hdc_encoder.hdc_encode,
                "fused_profile": fused_profile.fused_profile,
                "hamming_am": hamming_am.hamming_am,
                "am_matmul_packed": am_matmul.am_matmul_packed}
    sample = SyntheticSource(synth.CommunitySpec(
        num_species=NUM_SPECIES, genome_len=GENOME_LEN, seed=7),
        num_reads=NUM_READS)
    world = int(os.environ["WORLD_SIZE"])
    sess = ProfilingSession(ProfilerConfig(
        space=HDSpace(), window=8192, batch_size=256, backend="sharded",
        backend_options={"base": "cuda_fused", "shards": world}))
    t0 = time.perf_counter()
    db = sess.build_refdb(sample.genomes)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for fn in counters.values():
        fn.launches = 0
    dist.barrier()
    t0 = time.perf_counter()
    rep = sess.profile(sample)
    torch.cuda.synchronize()
    profile_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    warm = []
    for _ in range(WARM_RUNS):
        dist.barrier()
        t0 = time.perf_counter()
        again = sess.profile(sample)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        if again.to_dict() != rep.to_dict():
            return 1
    out = {"rank": sess.backend.mesh.rank, "backend": sess.backend.mesh.backend,
           "rows": db.num_prototypes, "mb": db.memory_bytes() / 1e6,
           "build_s": build_s, "profile_s": profile_s,
           "warm_s": statistics.median(warm), "launches": launches,
           "report": rep.to_dict()}
    with open(out_path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


T_START = time.perf_counter()


def species_max_phase(card: str) -> list[dict]:
    """Time the species max at the benchmark cells' shapes: 4,096 reads
    against 121,117 prototypes of 31 species (afs31) and 29,300 of 20
    (afs20), the ids in runs as the RefDB builder makes them.  Holds the
    kernel against its plain version bit for bit; prints ms a launch, the
    byte bound (4 B P + 4 B S at HBM bandwidth), the share of it and the
    plain ``scatter_reduce_``'s time.  The kernel's launch count and its
    row of the ``kernels`` line come from the main path (``time_row``)."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import species_max as sm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(26)
    out = []
    for cell, b, p, s in (("afs31", 4096, 121_117, 31),
                          ("afs20", 4096, 29_300, 20)):
        agree = torch.randint(0, 40_001, (b, p), generator=g, device=dev,
                              dtype=torch.int32)
        ids = (torch.arange(p, device=dev) * s // p).to(torch.int32)
        err = expect_equal(f"species_max {cell}",
                           sm.species_max(agree, ids, s),
                           sm.species_max_plain(agree, ids, s))
        ms = cuda_time_ms(lambda: sm.species_max(agree, ids, s), reps=20)
        plain_ms = cuda_time_ms(lambda: sm.species_max_plain(agree, ids, s),
                                reps=2)
        b_ms, _ = bound_ms(4 * b * p + 4 * b * s)
        row = {"name": f"species_max.{cell}", "ms": ms, "bound_ms": b_ms,
               "share_pct": 100 * b_ms / ms, "plain_ms": plain_ms,
               "max_abs_err": err}
        say(f"[time] species_max at {cell}'s shape (B={b}, P={p}, S={s}): "
            f"{ms:.4f} ms/launch, bound {b_ms:.4f} ms by bytes "
            f"({row['share_pct']:.1f} % of it); plain scatter_reduce_ "
            f"{plain_ms:.2f} ms | {card}")
        out.append(row)
        del agree
    return out


def main() -> int:
    sweep = "--sweep" in sys.argv[1:]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import convert
    from repro_torch.core import item_memory
    from repro_torch.core.assoc_memory import window_tokens
    from repro_torch.core.hd_space import HDSpace
    from repro_torch.eval import score_profile
    from repro_torch.genomics import synth
    from repro_torch.kernels import (_build, _search, am_matmul,
                                     fused_profile, hamming_am, hdc_encoder,
                                     ops, species_max, threefry)
    from repro_torch.pipeline import (ProfilerConfig, ProfilingSession,
                                      SyntheticSource)

    dry = DryRuns()             # phase 14.4's CPU children, from the start
    dry.start()
    dev = torch.device("cuda")
    card = card_line()
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_rate = INT32_OPS_PER_SM_CLOCK * sms * clock
    b1_rate = B1_MMA_PER_SM_CLOCK * B1_OPS_PER_MMA * sms * clock
    counters = {"hdc_encoder": hdc_encoder.hdc_encode,
                "fused_profile": fused_profile.fused_profile,
                "hamming_am": hamming_am.hamming_am,
                "am_matmul_packed": am_matmul.am_matmul_packed,
                "am_matmul": am_matmul.am_matmul,
                "threefry": threefry.threefry_draw,
                "species_max": species_max.species_max}

    def zero_counts() -> None:
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0

    def read_counts() -> dict:
        torch.cuda.synchronize()
        return {k: fn.launches for k, fn in counters.items()}

    # -- 1. setup --------------------------------------------------------
    say(f"[setup] card: {card} | {sms} SMs at {clock / 1e6:.0f} MHz: "
        f"32-bit integer rate {int_rate / 1e12:.2f} T/s, b1 mma search "
        f"rate {b1_rate / 1e12:.0f} TOP/s")
    say(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    say(f"[setup] built {', '.join(_build.SOURCES)} with nvcc in "
        f"{time.perf_counter() - t0:.1f} s")
    say(f"[setup] {sass_line(_build.library_path('am_matmul'))}")
    note("1 setup", f"kernels built in {time.perf_counter() - t0:.1f} s; {card}")

    space = HDSpace()                          # D = 40,960, n = 16
    n, w, alphabet = space.ngram, space.num_words, space.alphabet_size
    im = item_memory.make_item_memory(space, device=dev)
    tie = item_memory.make_tie_break(space, device=dev)
    imr = item_memory.rolled(im, n).contiguous()
    errs = {name: 0 for name in counters}

    # -- 2. kernel parity at full width ----------------------------------
    rng = np.random.default_rng(2206)
    wins = rng.integers(0, 4, (256, 8192)).astype(np.int32)
    wlens = np.full(256, 8192, np.int32)
    wlens[-1], wlens[-2] = 5000, 8191          # short tail; m = 8176 even
    plane_ms = [v for k in range(1, 14) for v in (2 ** k - 1, 2 ** k,
                                                  2 ** k + 1) if v <= 8177]
    wlens[:len(plane_ms)] = np.array(plane_ms) + (n - 1)
    t_w, l_w = (torch.from_numpy(wins).to(dev), torch.from_numpy(wlens).to(dev))
    enc = hdc_encoder.hdc_encode(t_w, l_w, imr, tie)
    enc_plain = hdc_encoder.hdc_encode_plain(t_w, l_w, imr, tie)
    errs["hdc_encoder"] = max(errs["hdc_encoder"],
                              expect_equal("hdc_encoder windows", enc, enc_plain))
    rlens = np.array([0, 10, 150, 151, 300], np.int32)
    reads = rng.integers(0, 4, (5, 300)).astype(np.int32)
    t_r, l_r = torch.from_numpy(reads).to(dev), torch.from_numpy(rlens).to(dev)
    errs["hdc_encoder"] = max(errs["hdc_encoder"], expect_equal(
        "hdc_encoder reads", hdc_encoder.hdc_encode(t_r, l_r, imr, tie),
        hdc_encoder.hdc_encode_plain(t_r, l_r, imr, tie)))
    say(f"[parity] hdc_encoder == plain on 256 x 8192 windows ({len(plane_ms)} "
        f"with m at plane boundaries 1 .. 8193) and reads of lengths "
        f"0/10/150/151/300 (bit-exact)")

    protos = torch.cat([enc, convert.words_to_tensor(rng.integers(
        0, 2 ** 32, (745, w), dtype=np.uint32), dev)]).contiguous()
    starts = rng.integers(0, 8192 - 151, 253)
    qtoks = np.stack([wins[i % 256, s:s + 151] for i, s in enumerate(starts)])
    qlens = np.full(253, 150, np.int32)
    qlens[:4] = [151, 0, 10, 15]               # even m, empty, short, m = 0
    read_ms = [v for k in range(1, 8) for v in (2 ** k - 1, 2 ** k,
                                                2 ** k + 1) if v <= 136]
    qlens[4:4 + len(read_ms)] = np.array(read_ms) + (n - 1)
    t_q, l_q = torch.from_numpy(qtoks).to(dev), torch.from_numpy(qlens).to(dev)
    agree_plain = fused_profile.fused_profile_plain(t_q, l_q, imr, tie, protos,
                                                    dim=space.dim)
    for bb_p, cl_p in ((fused_profile.DEFAULT_BB,
                        fused_profile.DEFAULT_CLUSTER), (32, 2), (16, 8)):
        agree = fused_profile.fused_profile(t_q, l_q, imr, tie, protos,
                                            dim=space.dim, bb=bb_p,
                                            cluster=cl_p)
        errs["fused_profile"] = max(errs["fused_profile"], expect_equal(
            f"fused_profile bb={bb_p} cluster={cl_p}", agree, agree_plain))
    if int(agree.max()) <= space.threshold_bits:
        fail("fused_profile: no read reaches the threshold of its window")
    say(f"[parity] fused_profile == plain on 253 reads ({len(read_ms)} with "
        f"m at plane boundaries) x 1001 prototypes at bb/cluster "
        f"{fused_profile.DEFAULT_BB}/{fused_profile.DEFAULT_CLUSTER}, 32/2 "
        f"and 16/8 (bit-exact; max agreement {int(agree.max())} of "
        f"{space.dim})")
    # The serving path's cohorts: reads padded to a bucket width, rows of
    # length 0 past the live reads, at every tiling that fits the width.
    for width, live in ((256, (150, 100, 256, 17)), (2048, (1500, 100,
                                                            2048, 150))):
        b_tok = np.zeros((256, width), np.int32)
        b_len = np.zeros(256, np.int32)
        for i in range(200):
            n_i = live[i % len(live)]
            s_i = int(rng.integers(0, 8192 - n_i))
            b_tok[i, :n_i] = wins[i % 256, s_i:s_i + n_i]
            b_len[i] = n_i
        t_b, l_b = torch.from_numpy(b_tok).to(dev), torch.from_numpy(b_len).to(dev)
        errs["hdc_encoder"] = max(errs["hdc_encoder"], expect_equal(
            f"hdc_encoder cohort L={width}",
            hdc_encoder.hdc_encode(t_b, l_b, imr, tie),
            hdc_encoder.hdc_encode_plain(t_b, l_b, imr, tie)))
        want_b = fused_profile.fused_profile_plain(t_b, l_b, imr, tie,
                                                   protos, dim=space.dim)
        fit = [(bb_p, cl_p) for bb_p in fused_profile.BATCH_TILES
               for cl_p in fused_profile.CLUSTER_SIZES
               if fused_profile.smem_bytes(bb_p, cl_p, width, n, alphabet, w)
               <= fused_profile.MAX_SMEM_BYTES]
        for bb_p, cl_p in fit:
            errs["fused_profile"] = max(errs["fused_profile"], expect_equal(
                f"fused_profile cohort L={width} bb={bb_p} cluster={cl_p}",
                fused_profile.fused_profile(t_b, l_b, imr, tie, protos,
                                            dim=space.dim, bb=bb_p,
                                            cluster=cl_p), want_b))
        say(f"[parity] serving cohort L = {width} (200 reads of lengths "
            f"{'/'.join(map(str, live))}, 56 rows of length 0): hdc_encoder "
            f"== plain, fused_profile == plain at the {len(fit)} tilings "
            f"that fit ({' '.join(f'{a}/{c}' for a, c in fit)}) (bit-exact)")
        note("2 parity", f"cohort L = {width} bit-exact")

    # The search kernels: the encoded windows plus random rows against the
    # same 1,001 prototypes, then a ragged W = 1,001 (a word tail in the
    # last 32-word step, rows not 16-byte aligned; a K tail for the bf16
    # entry's 64-wide tiles), then that W at an odd dim below 32 W.
    q_search = with_corner_rows(torch.cat([enc[:200], convert.words_to_tensor(
        rng.integers(0, 2 ** 32, (53, w), dtype=np.uint32), dev)]), protos)
    search_parity("D=40960", q_search.contiguous(), protos, space.dim, errs)
    p_rag = convert.words_to_tensor(rng.integers(
        0, 2 ** 32, (1001, 1001), dtype=np.uint32), dev)
    q_rag = with_corner_rows(convert.words_to_tensor(rng.integers(
        0, 2 ** 32, (253, 1001), dtype=np.uint32), dev), p_rag)
    search_parity("ragged W", q_rag.contiguous(), p_rag, 32 * 1001, errs)
    rag = am_matmul.plan(253, 1001, 1001)
    if rag["tma"]:
        fail(f"am_matmul_packed at W = 1,001 would stage by TMA: {rag}")
    say(f"[parity] am_matmul_packed at W = 1,001 staged its words by "
        f"cp.async (no TMA: W % 4 != 0), {rag['rows']} x {rag['protos']} a "
        f"block, {rag['blocks']} blocks")
    search_parity("dim != 32 W", q_rag.contiguous(), p_rag, 32 * 1001 - 7,
                  errs)

    # -- 3. main path at full width --------------------------------------
    config = ProfilerConfig(space=space, window=8192, batch_size=256,
                            backend="cuda_fused")
    t0 = time.perf_counter()
    sample = SyntheticSource(synth.CommunitySpec(
        num_species=NUM_SPECIES, genome_len=GENOME_LEN, seed=7),
        num_reads=NUM_READS)
    say(f"[main] community {NUM_SPECIES} species x {GENOME_LEN} bp, "
        f"{NUM_READS} reads of 150 bp (made in "
        f"{time.perf_counter() - t0:.1f} s)")
    session = ProfilingSession(config)
    zero_counts()
    t0 = time.perf_counter()
    db = session.build_refdb(sample.genomes)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches_run = []
    report = session.profile(
        sample, on_batch=lambda res: batches_run.append(res.index))
    torch.cuda.synchronize()
    profile_s = time.perf_counter() - t0
    launches = read_counts()
    say(f"[main] build {build_s:.3f} s ({db.num_prototypes} prototypes, "
        f"{db.memory_bytes() / 1e6:.1f} MB AM) | profile {profile_s:.3f} s | "
        f"{NUM_READS / profile_s:.0f} reads/s")
    say(f"[main] launches {json.dumps(launches)}")
    if min(launches["hdc_encoder"], launches["fused_profile"]) < 1:
        fail(f"main path skipped a kernel: {launches}")
    if launches["species_max"] != len(batches_run):
        fail(f"main path launched species_max {launches['species_max']} "
             f"times for {len(batches_run)} batches: {launches}")
    m = score_profile(report.abundance, sample.true_abundance)
    say(f"[main] precision {m.precision:.3f} recall {m.recall:.3f} | "
        f"unmapped {report.unmapped_reads} multi {report.multi_reads} of "
        f"{report.total_reads} | top {report.top(3)}")
    if report.total_reads != NUM_READS or report.mapped_reads == 0 \
            or not np.isfinite(report.abundance).all():
        fail("main path report is empty or not finite")
    main_report = report.to_dict()
    med, secs = warm_profile(session, sample, db, main_report)
    say(f"[main] cuda_fused profile {warm_line(med, secs)} | {card}")
    note("3 main", f"cuda_fused profile warm median {med:.3f} s ({NUM_READS / med:.0f} reads/s)")

    # Kernel times and parity at the shapes the main path gave them:
    # a full 256-window build batch and a 256-read query batch.
    first = next(iter(sample.genomes.values()))
    bw, bl = window_tokens(first, 8192, 8192)
    t_bw = torch.from_numpy(bw[:256]).to(dev)
    l_bw = torch.from_numpy(bl[:256]).to(dev)
    t_rd = torch.from_numpy(sample.tokens[:256]).to(dev)
    l_rd = torch.from_numpy(sample.lengths[:256]).to(dev)
    kern = {
        "hdc_encoder": (lambda: hdc_encoder.hdc_encode(t_bw, l_bw, imr, tie),
                        lambda: hdc_encoder.hdc_encode_plain(t_bw, l_bw, imr,
                                                             tie)),
        "fused_profile": (
            lambda: fused_profile.fused_profile(
                t_rd, l_rd, imr, tie, db.prototypes, dim=space.dim,
                **session.backend.tiles),
            lambda: fused_profile.fused_profile_plain(
                t_rd, l_rd, imr, tie, db.prototypes, dim=space.dim)),
    }
    agree_rd = fused_profile.fused_profile(
        t_rd, l_rd, imr, tie, db.prototypes, dim=space.dim,
        **session.backend.tiles)
    kern["species_max"] = (
        lambda: species_max.species_max(agree_rd, db.proto_species,
                                        db.num_species),
        lambda: species_max.species_max_plain(agree_rd, db.proto_species,
                                              db.num_species))
    s, b_rd = db.num_prototypes, t_rd.shape[0]
    work = {
        "hdc_encoder": bound_ms(
            t_bw.numel() * 4 + l_bw.numel() * 4 + imr.numel() * 4 + w * 4
            + t_bw.shape[0] * w * 4, encoder_ops(bl[:256], n, w),
            int_rate=int_rate),
        "fused_profile": bound_ms(
            t_rd.numel() * 4 + b_rd * 4 + imr.numel() * 4 + w * 4
            + s * w * 4 + b_rd * s * 4,
            encoder_ops(sample.lengths[:256], n, w), 2 * b_rd * s * space.dim,
            tensor_rate=b1_rate, int_rate=int_rate),
        "species_max": bound_ms(4 * b_rd * s + 4 * b_rd * db.num_species),
    }
    rows = []
    sources = {"hdc_encoder": ("src/repro_torch/csrc/hdc_encoder.cu",
                               "src/repro/kernels/hdc_encoder.py:50"),
               "fused_profile": ("src/repro_torch/csrc/fused_profile.cu",
                                 "src/repro/kernels/fused_profile.py:148"),
               "hamming_am": ("src/repro_torch/csrc/hamming_am.cu",
                              "src/repro/kernels/hamming_am.py:24"),
               "am_matmul_packed": ("src/repro_torch/csrc/am_matmul.cu",
                                    "src/repro/kernels/am_matmul.py:31"),
               "am_matmul": ("src/repro_torch/csrc/am_matmul.cu",
                             "src/repro/kernels/am_matmul.py:31"),
               "species_max": ("src/repro_torch/csrc/species_max.cu",
                               "src/repro/core/assoc_memory.py:288 (XLA "
                               "segment_max, no Pallas kernel)")}

    def time_row(name, kfn, pfn, bound, runs, library_ms=None) -> dict:
        errs[name] = max(errs[name], expect_equal(f"{name} main-path shape",
                                                  kfn(), pfn()))
        ms = cuda_time_ms(kfn, reps=10)
        plain_ms = cuda_time_ms(pfn, reps=1)
        b_ms, b_by = bound
        row = {"name": name, "route": "cuda", "source": sources[name][0],
               "replaces": sources[name][1], "launches": runs[name],
               "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
        lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
        before = (f"before: {PRIOR_MS[name]:.3f} ms, PERF.md"
                  if name in PRIOR_MS else "a new entry")
        say(f"[time] {name}: {ms:.3f} ms/launch ({before}; plain "
            f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms by {b_by}{lib}) | "
            f"{card}")
        rows.append(row)
        return row

    for name, (kfn, pfn) in kern.items():
        time_row(name, kfn, pfn, work[name], launches)
    one = db.prototypes[:1].contiguous()
    enc_ms = cuda_time_ms(lambda: fused_profile.fused_profile(
        t_rd, l_rd, imr, tie, one, dim=space.dim, **session.backend.tiles),
        reps=10)
    say(f"[time] fused_profile split at B=256, L=150, S={s}: encode "
        f"{enc_ms:.3f} ms (S=1) + search {rows[1]['ms'] - enc_ms:.3f} ms")
    if sweep:
        for bb in fused_profile.BATCH_TILES:
            for cl in fused_profile.CLUSTER_SIZES:
                if fused_profile.smem_bytes(bb, cl, 150, n, alphabet, w) > \
                        fused_profile.MAX_SMEM_BYTES:
                    continue
                ms = cuda_time_ms(lambda: fused_profile.fused_profile(
                    t_rd, l_rd, imr, tie, db.prototypes, dim=space.dim,
                    bb=bb, cluster=cl), reps=5)
                plan = ops.fused_tile_plan(b_rd, s, w, bb=bb, cluster=cl,
                                           read_len=150, sms=sms)
                active = fused_profile.max_active_clusters(bb, cl, 150, n, w)
                say(f"[sweep] fused_profile bb={bb} cluster={cl}: "
                    f"{ms:.3f} ms | {plan['tiles']} tiles x {plan['splits']} "
                    f"splits = {plan['tiles'] * plan['splits']} clusters, "
                    f"{active} fit at once")

    sm_rows = species_max_phase(card)
    note("3 species_max", ", ".join(
        f"{r['name']} {r['ms']:.3f} ms ({r['share_pct']:.0f} % of its bound)"
        for r in sm_rows))

    # -- 3b. the unfused search paths at full width -----------------------
    pm1_calls = [0]
    real_to_pm1 = ops.to_pm1

    def counted_to_pm1(packed):
        pm1_calls[0] += 1
        return real_to_pm1(packed)

    search_runs = {}
    for backend, kernel in (("cuda_packed", "hamming_am"),
                            ("cuda_matmul", "am_matmul_packed")):
        sess = ProfilingSession(ProfilerConfig(
            space=space, window=8192, batch_size=256, backend=backend))
        zero_counts()
        pm1_calls[0] = 0
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        ops.to_pm1 = counted_to_pm1
        try:
            t0 = time.perf_counter()
            rep = sess.profile(sample, refdb=db)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            ops.to_pm1 = real_to_pm1
        rise = torch.cuda.max_memory_allocated() - mem0
        runs = read_counts()
        search_runs[backend] = runs
        say(f"[search] {backend}: profile {secs:.3f} s | "
            f"{NUM_READS / secs:.0f} reads/s | launches {json.dumps(runs)} | "
            f"to_pm1 calls {pm1_calls[0]} | max_memory_allocated rise "
            f"{rise / 1e6:.1f} MB")
        if runs["hdc_encoder"] < 1 or runs[kernel] < 1 \
                or runs["fused_profile"] != 0 or runs["am_matmul"] != 0:
            fail(f"{backend} path did not run encoder + {kernel} alone: "
                 f"{runs}")
        if pm1_calls[0]:
            fail(f"{backend} profile expanded to +-1 with ops.to_pm1 "
                 f"{pm1_calls[0]} times")
        if rep.to_dict() != main_report:
            fail(f"{backend} report differs from cuda_fused's")
        med, secs = warm_profile(sess, sample, db, main_report)
        say(f"[search] {backend} profile {warm_line(med, secs)} | {card}")
        note("3 search", f"{backend} warm median {med:.3f} s")
    say("[search] cuda_packed and cuda_matmul reports == cuda_fused's "
        f"({NUM_READS} reads, {db.num_prototypes} prototypes)")

    zero_counts()
    res = session.classify_queries(session.encode_reads(t_rd, l_rd), db)
    runs = read_counts()
    fused_res = session.classify_batch(t_rd, l_rd, refdb=db).classification
    if runs["am_matmul_packed"] < 1:
        fail(f"cuda_fused.agreement did not launch am_matmul_packed: {runs}")
    if not (torch.equal(res.hits, fused_res.hits)
            and torch.equal(res.category, fused_res.category)):
        fail("cuda_fused.agreement hits differ from classify_batch's")
    say(f"[search] cuda_fused.agreement (am_matmul_packed) == classify_batch "
        f"on {b_rd} reads | launches {json.dumps(runs)}")

    q_rd = hdc_encoder.hdc_encode(t_rd, l_rd, imr, tie)
    protos_main = db.prototypes
    dim = space.dim
    slab = hamming_am.slab_protos(b_rd, s)
    if slab <= 0:
        fail(f"search slab: hamming_am_slab_protos returned {slab}")
    slabs, rows_b = -(-s // slab), _search.BLOCK_B
    say(f"[time] hamming_am tiling at B={b_rd}, S={s}: {rows_b} reads x "
        f"{slab} prototypes a block, {slabs * -(-b_rd // rows_b)} blocks on "
        f"{sms} SMs; a launch reads the AM ({s * w * 4 / 1e6:.1f} MB) once "
        f"and the packed reads {slabs * b_rd * w * 4 / 1e6:.1f} MB (once a "
        f"block, mostly L2)")
    pk = am_matmul.plan(b_rd, s, w)
    bk = am_matmul.plan(b_rd, s, space.dim, packed=False)
    if pk["protos"] != slab or bk["protos"] != slab or not pk["tma"] \
            or not bk["tma"]:
        fail(f"am_matmul tiling at the main path's shapes: {pk}, {bk}")
    m_, n_ = pk["rows"], pk["protos"]
    say(f"[time] am_matmul_packed tiling at B={b_rd}, S={s}, W={w}: "
        f"{m_} x {n_} (queries x prototypes) a block, {pk['stages']} stages "
        f"of {pk['step']} words by TMA, {pk['blocks']} blocks on "
        f"{pk['sms']} SMs, "
        f"{pk['smem']} bytes of shared memory a block; a launch reads "
        f"{(s + b_rd) * w * 4 / 1e6:.1f} MB from device memory (the AM and "
        f"the packed reads once; the reads again in every block, "
        f"{pk['blocks'] * b_rd * w * 4 / 1e6:.1f} MB, mostly L2); a k32 "
        f"column: (M + N) x 24 / 64 = {(m_ + n_) * 24 / 64:.0f} integer "
        f"clocks of +-1 expansion against M N 64 / 8,192 = "
        f"{m_ * n_ * 64 / 8192:.0f} tensor clocks")
    say(f"[time] am_matmul (bf16) tiling at B={b_rd}, S={s}, "
        f"K={space.dim}: {bk['rows']} x {bk['protos']} a block, "
        f"{bk['stages']} stages of {bk['step']} elements by TMA (128-byte "
        f"swizzle), "
        f"{bk['blocks']} blocks on {bk['sms']} SMs, {bk['smem']} bytes of "
        f"shared memory a block; a launch reads "
        f"{(s + b_rd) * space.dim * 2 / 1e6:.1f} MB from device memory "
        f"(the bf16 AM once; the query tile again in every block, "
        f"{bk['blocks'] * b_rd * space.dim * 2 / 1e9:.2f} GB, mostly L2)")

    # Library yardsticks on the pre-expanded +-1 operands (they do not pay
    # for the expansion; no path calls them).
    pm1_ms = cuda_time_ms(lambda: ops.to_pm1(protos_main), reps=3)
    q_pm, p_pm = ops.to_pm1(q_rd), ops.to_pm1(protos_main)
    k = q_pm.shape[1]
    say(f"[time] to_pm1 of the AM ({s} x {w} words -> {s} x {k} bf16, "
        f"{p_pm.numel() * 2 / 1e6:.1f} MB; off every path): {pm1_ms:.3f} ms "
        f"| {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    qf, pf = q_pm.float(), p_pm.float()
    f32_ms = cuda_time_ms(lambda: torch.matmul(qf, pf.T), reps=3)
    del qf, pf
    dots = 2 * am_matmul.am_matmul(q_pm, p_pm, dim=k) - k  # exact +-1 dots
    try:                               # exact: sums of +-1 below 2^24
        bf16_mm = torch.mm(q_pm, p_pm.T, out_dtype=torch.float32)
        if not torch.equal(bf16_mm.to(torch.int32), dots):
            fail("torch.mm bf16 -> float32 on the +-1 operands disagrees")
        bf16_ms = cuda_time_ms(lambda: torch.mm(
            q_pm, p_pm.T, out_dtype=torch.float32), reps=10)
        bf16_line = f"{bf16_ms:.3f} ms"
    except (RuntimeError, TypeError) as e:   # the library call refused
        bf16_ms = None
        bf16_line = f"refused ({str(e).splitlines()[0][:120]})"
    s8 = -(-s // 8) * 8                # _int_mm wants N a multiple of 8
    qi = q_pm.to(torch.int8)
    pi = torch.zeros((s8, k), dtype=torch.int8, device=dev)
    pi[:s] = p_pm.to(torch.int8)
    try:
        int_mm = torch._int_mm(qi, pi.T)
        if not torch.equal(int_mm[:, :s], dots):
            fail("torch._int_mm on the +-1 operands disagrees")
        i8_ms = cuda_time_ms(lambda: torch._int_mm(qi, pi.T), reps=10)
        i8_line = f"{i8_ms:.3f} ms"
    except RuntimeError as e:          # the library call refused the shape
        i8_ms = None
        i8_line = f"refused ({str(e).splitlines()[0][:120]})"
    del qi, pi, dots
    say(f"[time] library on the pre-expanded +-1 operands: torch.matmul "
        f"float32 (TF32 off) {f32_ms:.3f} ms | torch.mm bf16 -> float32 "
        f"{bf16_line} (the bf16 entry's yardstick) | torch._int_mm int8, S "
        f"padded to {s8}: {i8_line} (the yardstick of hamming_am and "
        f"am_matmul_packed) | {card}")

    search_bound = bound_ms((b_rd + s) * w * 4 + b_rd * s * 4,
                            tensor_ops=2 * b_rd * s * space.dim,
                            tensor_rate=b1_rate)
    time_row("hamming_am",
             lambda: hamming_am.hamming_am(q_rd, protos_main, dim=dim),
             lambda: hamming_am.hamming_am_plain(q_rd, protos_main, dim=dim),
             search_bound, search_runs["cuda_packed"], library_ms=i8_ms)
    packed_bound = bound_ms((b_rd + s) * w * 4 + b_rd * s * 4,
                            tensor_ops=2 * b_rd * s * space.dim,
                            tensor_rate=TENSOR_INT8_OPS_PER_S)
    time_row("am_matmul_packed",
             lambda: am_matmul.am_matmul_packed(q_rd, protos_main, dim=dim),
             lambda: am_matmul.am_matmul_packed_plain(q_rd, protos_main,
                                                      dim=dim),
             packed_bound, search_runs["cuda_matmul"], library_ms=i8_ms)
    say(f"[time] am_matmul_packed bound {packed_bound[0]:.4f} ms (2 B S D at "
        f"the 1,979 TOP/s int8 peak); the same function in hamming_am's b1 "
        f"formulation: {search_bound[0]:.4f} ms")
    time_row("am_matmul",
             lambda: am_matmul.am_matmul(q_pm, p_pm, dim=dim),
             lambda: am_matmul.am_matmul_plain(q_pm, p_pm, dim=dim),
             bound_ms((b_rd + s) * k * 2 + b_rd * s * 4,
                      tensor_ops=2 * b_rd * s * k,
                      tensor_rate=TENSOR_BF16_FLOP_PER_S),
             search_runs["cuda_matmul"],     # 0: no path calls the bf16 entry
             library_ms=bf16_ms if bf16_ms is not None else f32_ms)
    del q_pm, p_pm
    batch_ms = cuda_time_ms(lambda: ops.am_agreement(
        q_rd, protos_main, dim, "matmul"), reps=10)
    say(f"[time] one cuda_matmul search step (am_matmul_packed on the packed "
        f"words, no to_pm1) at B={b_rd}, S={s}: {batch_ms:.3f} ms | {card}")

    # -- 4. whole-report parity on the card ------------------------------
    small = SyntheticSource(synth.CommunitySpec(
        num_species=4, genome_len=200_000, seed=5), num_reads=2048)
    reports, dbs = {}, {}
    for backend in ("cuda_fused", "cuda_packed", "cuda_matmul", "reference"):
        sess = ProfilingSession(ProfilerConfig(
            space=space, window=8192, batch_size=256, backend=backend))
        dbs[backend] = sess.build_refdb(small.genomes)
        reports[backend] = sess.profile(small).to_dict()
    for backend in ("cuda_fused", "cuda_packed", "cuda_matmul"):
        if not torch.equal(dbs[backend].prototypes,
                           dbs["reference"].prototypes):
            fail(f"{backend} prototypes differ from the torch reference's")
        if reports[backend] != reports["reference"]:
            fail(f"{backend} report differs from the torch reference's")
        if not torch.equal(dbs[backend].proto_species,
                           dbs["reference"].proto_species):
            fail(f"{backend} species tags differ")
    r = reports["reference"]
    say(f"[report] cuda_fused == cuda_packed == cuda_matmul == reference on "
        f"the card: {dbs['reference'].num_prototypes} prototypes, "
        f"{r['total_reads']} reads, unmapped {r['unmapped_reads']}, multi "
        f"{r['multi_reads']}")
    note("4 report", "cuda_fused == cuda_packed == cuda_matmul == reference")

    # -- 5. the profile_run CLI on the card ------------------------------
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    driven = {b: run_cli(b, out_dir) for b in ("cuda_packed",
                                                  "cuda_matmul")}
    if driven["cuda_packed"] != driven["cuda_matmul"]:
        fail("profile_run reports differ between cuda_packed and cuda_matmul")
    say("[cli] profile_run --synthetic: cuda_packed and cuda_matmul "
        "report JSONs are equal")
    note("5 cli", "profile_run reports equal")

    # -- 6. the serving path at full width --------------------------------
    t0 = time.perf_counter()
    serving_phase(config=config, sample=sample, db=db, session=session,
                  main_report=main_report, card=card, out_dir=out_dir,
                  zero_counts=zero_counts, read_counts=read_counts)
    say(f"[serve] serving phase {time.perf_counter() - t0:.1f} s")

    # -- 7. alphabets above 4 ----------------------------------------------
    t0 = time.perf_counter()
    alphabet_phase(space=space, rows=rows, card=card,
                   zero_counts=zero_counts, read_counts=read_counts)
    say(f"[alphabet] alphabet phase {time.perf_counter() - t0:.1f} s")

    # -- 8. the serving fleet -------------------------------------------------
    t0 = time.perf_counter()
    fleet_phase(config=config, sample=sample, db=db, card=card,
                zero_counts=zero_counts, read_counts=read_counts)
    say(f"[fleet] fleet phase {time.perf_counter() - t0:.1f} s")

    # -- 9. the sharded backend ---------------------------------------------
    t0 = time.perf_counter()
    shard_phase(config=config, sample=sample, db=db, main_report=main_report,
                card=card, out_dir=out_dir, zero_counts=zero_counts,
                read_counts=read_counts)
    say(f"[shard] shard phase {time.perf_counter() - t0:.1f} s")

    # -- 10. the device model -------------------------------------------------
    t0 = time.perf_counter()
    accel_phase(config=config, sample=sample, db=db, main_report=main_report,
                card=card, int_rate=int_rate, zero_counts=zero_counts,
                read_counts=read_counts, rows=rows)
    say(f"[accel] device-model phase {time.perf_counter() - t0:.1f} s | "
        f"{card}")

    # -- 11. the baseline profilers -------------------------------------------
    t0 = time.perf_counter()
    baselines_phase(sample=sample, small=small, db=db, card=card,
                    zero_counts=zero_counts, read_counts=read_counts)
    say(f"[baseline] baselines phase {time.perf_counter() - t0:.1f} s")

    # -- 12. the LM stack's serving path ---------------------------------------
    t0 = time.perf_counter()
    lm_phase(card=card, zero_counts=zero_counts, read_counts=read_counts)
    say(f"[lm] LM serving phase {time.perf_counter() - t0:.1f} s")

    # -- 13. the LM stack's training path ---------------------------------------
    t0 = time.perf_counter()
    p13 = train_phase(card=card, zero_counts=zero_counts,
                      read_counts=read_counts)
    say(f"[train] LM training phase {time.perf_counter() - t0:.1f} s | "
        f"{card}")

    # -- 14. training across ranks and the dry runs ------------------------------
    t0 = time.perf_counter()
    mesh_phase(card=card, zero_counts=zero_counts, read_counts=read_counts,
               p13=p13, dry=dry)
    say(f"[mesh] mesh phase {time.perf_counter() - t0:.1f} s | {card}")

    # -- 15. the SSD, hybrid and MLA + MoE families at full width -------------
    t0 = time.perf_counter()
    heads = family_phase(card=card, zero_counts=zero_counts,
                         read_counts=read_counts)
    for arch, h in heads.items():
        note("15 family", f"{arch} prefill {h['prefill_ms']:.1f} ms, decode "
             f"{h['tok_s']:.0f} tok/s, bf16 gap {h['rel']:.4f}"
             + (f", train step {h['step_ms']:.1f} ms, "
                f"{h['train_peak_gb']:.2f} GB" if "step_ms" in h else ""))
    say(f"[family] families phase {time.perf_counter() - t0:.1f} s | {card}")
    note("total", f"{time.perf_counter() - T_START:.1f} s")

    say(card)
    say(json.dumps({"kernels": rows}))
    for phase, text in SUMMARY.items():
        say(f"[summary] {phase}: {text}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-worker"]:
        sys.exit(shard_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-worker"]:
        sys.exit(mesh_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--prefill-worker"]:
        sys.exit(prefill_worker(sys.argv[2]))
    sys.exit(main())
