#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Print the card's name and power limit (nvidia-smi), build every CUDA
   kernel of the port from the sources in this checkout (``nvcc -Xptxas
   -v``), print the build time and each kernel's registers and spills.
2. Hold each kernel against its plain PyTorch version on the card, float32
   at 2e-4 and bfloat16 at 2e-2.  Flash attention runs two tensor-core
   kernels, chosen by dtype and each checked to be the one launched: bf16
   goes to flash_fwd_sm90.cu, float32 to flash_fwd_tf32_sm90.cu (split-TF32
   products; the registers, shared memory and spills of both are printed
   here); both run the sweep of the JAX package's kernel tests (MHA, GQA
   2:1 and 4:1, MQA; windows 32/96/1024; blocks 128/32; S = 12) plus head
   dim 80 and the serve-like cases of tests/test_torch_cuda.py, and bf16
   also head dim 192.  Then the
   SSD sweep of the same tests on the tensor-core SSD kernel
   (ssd_fwd_sm90.cu, whose registers, shared memory and spills are printed
   here), the RWKV6 sweep and RWKV6's strong-decay case on the tensor-core
   RWKV6 kernel (rwkv6_fwd_sm90.cu, whose registers, spills, shared memory
   and blocks per SM are printed here).
   Flash attention is also checked at the shapes the MoE and modality
   configs give it: internvl2-1b's GQA 7:1 at hd 64 and S = 768,
   musicgen-large's MHA at hd 64, and mixtral's window of 4096 at S = 512.
   Each kernel is checked and timed at the shape its serve path gives it
   (granite-3-8b and zamba2-2.7b attention, zamba2's SSD, rwkv6-3b's WKV;
   flash also at internvl2's and musicgen's shapes, and the float32 flash
   kernel at mixtral's, where phase 3's float32 MoE serving runs it, also
   against the plain version in float64), beside its plain version,
   PyTorch's fused attention for flash, and its bound; every kernel and PyTorch's attention both eagerly (CUDA events
   over 20 calls) and by replaying a CUDA graph of 20 captured calls, which
   leaves out the host's cost of each call; the RWKV6 kernel with float32
   and with the bfloat16 r, k, v the model feeds.  The float32 flash, SSD and
   RWKV6 kernels' bounds are
   at the TF32 tensor-core rate with three split-TF32 products per product,
   where the kernels do their products; the bound at the float32 rate
   outside the tensor cores is printed beside it.  At their serve shapes
   the scans are held elementwise against their plain version run in
   float64, with the float32 plain version's own error printed beside
   them.
3. Serve granite-3-8b, zamba2-2.7b and rwkv6-3b at full width and depth,
   and mixtral-8x7b and phi3.5-moe-42b-a6.6b at full width with 8 of their
   32 layers in float32 (MOE_SERVE says why), with random weights (seeded
   on the card): 8 requests, 512-token prompts, 32 generated tokens each.
   Every launch count is set to 0 before each run and must be exact after
   it (flash once per attention block, SSD once per Mamba2 layer, RWKV6
   once per layer; every bf16 flash launch on the bf16 kernel, every
   float32 one on the split-TF32 kernel), the prompt forward and the
   teacher-forced decode must agree (an MoE's prompt forward at its no-drop
   capacity, as the launcher runs it: the (token, layer) pairs the two
   paths route differently are counted, and in float32 the forward takes
   decode's experts at ties, a router-probability gap of at most
   serve.ROUTING_TIE_GAP, at most serve.ROUTING_MAX_TIES of them, while a
   flip beyond a tie fails), and every generated id must lie below the
   vocabulary size.
4. Profile each served family's prompt forward through the kernels and its
   serving loop (teacher-forced prefill and greedy decode) at full width
   with torch.profiler: device busy time, the device's idle share and the
   kernels that take the most time.  The MoE configs are profiled in bf16
   with 16 of their 32 layers (``tools/moe_routing_probe.py`` runs their
   serve check's two paths there without the gate).
5. Training.  (a) Two train steps of the reduced float32 granite-3-8b,
   zamba2-2.7b, rwkv6-3b, mixtral-8x7b, internvl2-1b and musicgen-large on
   the card and on the CPU from the same parameters (rwkv6 and musicgen in
   two microbatches): loss, grad norm and every parameter leaf within
   2e-4 + 2e-4 * |want|.  (b) Full width, 8 x 512 tokens, 4 steps: rwkv6-3b
   (2 microbatches), zamba2-2.7b, internvl2-1b and musicgen-large (1)
   through the trainer's CLI (``repro_torch.launch.train.main``), and
   granite-3-8b with 8 of its 40 layers and mixtral-8x7b with 2 of its 32
   through ``make_train_step`` (all the layers cannot fit: granite's 40
   need 16.3 GB of bf16 parameters and 65.4 GB of float32 moments,
   mixtral's 2 already 3.16 B parameter elements); each prints ms per step
   after step 0, tokens/s, mfu_6nt (6 N T over the step time and 989
   TFLOP/s; remat's recompute not counted; for mixtral also over the
   parameters active per token), peak memory and its losses, which must be
   finite.  (c) The eval step through the kernels at full width against
   the torch paths' eval loss, within 2e-2 + 2e-2 * |want|, with exact
   launch counts (granite 8 layers: flash 8; zamba2: ssd 54 + flash 9;
   rwkv6: 32; internvl2: 24; musicgen: 48; mixtral, bf16, 16 layers at its
   configured capacity: 16, with its aux loss and drop rate).  (d) A
   checkpoint round trip of (params, optimizer state) on the card, reduced
   zamba2-2.7b, exact.  (e) Where a full-width step's time goes, for
   rwkv6, zamba2 and granite: the gradient pass and the AdamW update timed
   apart, the forward alone, and under torch.profiler the device's busy
   time, idle share and top kernels.
6. The network engines (``repro_torch.network``, the port of the JAX
   package's compiled ``xla`` passes; no kernel of their own), each on the
   card and through the port's CPU path on the same seeded inputs: (a) DOR
   link loads of the bisection pairing on Mira's (16, 16, 12, 8, 2) and
   JUQUEEN's (28, 8, 8, 8, 2) node tori and of 2^20 random messages on
   Mira, exactly equal; (b) the paper's Table 1, Mira's current and
   proposed partitions of 4, 8, 16 and 24 midplanes, and both whole
   machines, pairing drained by ``simulate_flows`` (makespans, steps,
   subflows, incidence entries; completions within 1e-9 relative and equal
   steps; the ratios 2, 2, 2 and 4/3, and the whole machines' makespans 4
   and 7 of the JAX package's NumPy engine); (c) ``drain_batch`` at
   benchmarks/bench_backend.py's size, 2048 pairing scenarios on the 32^3
   torus, 16 sampled lanes per job geometry against the CPU path and one
   lane against ``drain`` bit for bit; (d) ``score_candidates`` on 4096
   mappings of 24 ranks on Mira's midplane torus and 1024 of 2048 ranks on
   the 4-midplane partition, row-exact; (e) the contention field of a
   512-node job among 8 placed ones on Mira's node torus, within 1e-9 x
   max(1, max|field|) and the same best offset; (f) ``cut_table`` on the
   Mira, JUQUEEN and Sequoia midplane tori and Mira's node torus at every
   size of Mira's scheduler, int64 identical, with Mira's min-cut geometry
   per midplane count from the card.  Every pass must have been dispatched
   on the card (``repro_torch.obs.DISPATCHES``); the card and CPU wall
   times are printed in a ``network`` JSON line.
7. The allocation engines (``repro_torch.network``'s advisor, placement
   search, allocator, scheduler and rank mapping; no kernel of their own),
   each case on the card and through the port's CPU path, any difference
   failing the run: (a) the partition advisor over Mira's scheduler table
   and JUQUEEN's worst geometries at node level, both node tori of every
   size up to ``ADVISOR_SIMULATE_NODES`` drained (predicted speedup equal
   to the drained one), Mira's 4/8/16/24 midplanes at 2, 2, 2 and 4/3, and
   the avoidable-contention ratio per size; (b) the 120-job scenario on
   the 32^3 torus of ``BENCH_scheduler.json`` under the contention-scored
   policy with backfill, the card's event log equal to the CPU path's
   record for record, events/s on both and the card's idle share under
   torch.profiler; (c) ``simulate_queue`` on Mira's midplanes with a
   seeded stream, simulated contention and halo rank mapping, under Mira's
   list, the isoperimetric and the contention-scored policies (the
   paper's comparison: mean simulated slowdown, bisection efficiency,
   makespan), the same schedules on both; (d) ``map_ranks`` of an
   (8, 8, 8, 8, 2) halo job on Mira's node torus, its 3,841 strategies
   scored in chunks on the card, its winner and identity mapping
   re-scored on the CPU path, and the whole catalogue of an (8, 8, 4, 4,
   2) job on both, the same strategy and score.
   Every allocation pass must have been dispatched on the card, and an
   ``allocation`` JSON line holds the numbers.
8. The fleet planner (``repro_torch.launch.planner``; no kernel of its
   own): mixtral-8x7b, qwen1.5-110b and nemotron-4-340b planned on Mira at
   16 midplanes (train_4k, torus mode, 2 GB/s links) under the H100
   profile, on the card and through the CPU path, the ranked rows bit-equal
   and each plan's (geometry, rule, bisection efficiency, rows) as
   ``H100_MIRA_PLANS`` pins them; fsdp over all 16 midplanes must rank
   ``advise_partition``'s certified (2, 2, 2, 2) first, and the worst row
   must cost at least 1.3x the best.  It prints each table, wall times on
   both, the card's idle share and the ``planner.price`` span count, runs
   ``--plan-chips 16 --plan-pod mira`` through ``serve.main`` and
   ``train.main``, and writes a ``planner`` JSON line.

9. The distributed layer (no kernel of its own): (a) Strassen-Winograd,
   the paper's Experiment B kernel, at n = 16384 in float32 without TF32,
   depths 0, 1 and 2 each within 1e-4 of a float64 product relative to its
   largest entry, timed beside ``torch.matmul`` with its FLOPs and its
   bound at the float32 rate, and the CAPS model on Mira's four cells (the
   x2-bisection cells' comm ratio in [1.37, 1.52], wallclock in [1.08,
   1.22]); (b) both collective-matmul rings on a one-rank NCCL group
   against ``x @ w`` within 1e-5, with no gather or scatter traced; (c) the
   dry-run CLI, each cell in a child process on a fake process group:
   granite-3-8b x train_4k on the (16, 16) mesh and x decode_32k on the
   (2, 16, 16) mesh, calibrated; zamba2-2.7b x train_4k on the (16, 16)
   mesh (the SSD scan on its head shards), rwkv6-3b x long_500k on the
   (2, 16, 16) mesh (the WKV scan at batch 1) and mixtral-8x7b x train_4k
   on the (16, 16) mesh (the MoE dispatch on its batch shards), their
   collectives from the production run, and llama3-70b x train_4k on the
   (16, 16) mesh, calibrated (one microbatch of 16 rows a rank: block
   remat keeps each layer's input as its 1/16 sequence slice over
   "model", without which it runs out of memory); each record's state bytes equal
   the specs' and the local shards built, its peak memory fits the card
   (the cells run in two lanes of child processes, ``DRYRUN_LANES``),
   and its roofline terms, per-axis collective bytes, view replications,
   "model" bytes and times are printed, then a ``distributed`` JSON line.
10. The rest of the network engines (no kernel of their own), each
   sub-phase on the card and through the port's CPU path, any difference
   failing the run: (a) ``compare_routing`` (DOR against the
   minimal-adaptive router) on Mira's current and proposed partitions of
   8 and 16 midplanes at node level, bisection pairing (recovered fraction
   0.0, the paper's argument) and a hotspot line (recovered > 0), the
   adaptive paths equal on both; (b) the utilization timeline of phase
   6b's Mira 8-midplane pairing drain and of the hotspot line's adaptive
   drain (equal steps and active counts, samples within 1e-9 relative);
   (c) contention attribution and its dashboard on the 32^3 torus holding
   spilling jobs (cross traffic > 0), and ``scheduler_metrics`` of phase
   7b's card log equal to the CPU log's and to the card's replay's; (d)
   HyperX: minimal and DAL routing of all-to-all on H(16, 16, 4)
   (1,047,552 messages), ``compare_fabric_routing`` on H(16, 4) and H(8,
   8), the advisor and bisection tables on H(16, 4), a seeded queue there
   (the same log on both) and ``plan_model`` of mixtral on it (rows
   bit-equal).  Each sub-phase prints its wall time and, for one card call
   of it under torch.profiler, the device's idle share; every new pass
   must have been dispatched on the card; an ``engines`` JSON line holds
   the numbers.
11. The port's eight examples (``repro_torch.examples``), each through its
   ``main`` at its defaults on the card (``partition_analysis`` at
   ``EXAMPLE_REPLAY_JOBS`` jobs, a quarter of the JAX example's 400, to keep
   the script inside its time limit), in a thread while phase 9c's cells
   run in their child processes: every assert of each must hold; each
   example's wall time is printed, then an ``examples`` JSON line.

Each phase prints its wall time.  The line before the last is a JSON object with each kernel's launches on the
main path, error, times and bound; the last line names the device.  With no
CUDA card, or run outside a checkout of the repository, it prints no result
and exits non-zero.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense, no sparsity) for the bound.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
TF32_FLOPS = 495e12  # the tensor cores in TF32

FLASH_SWEEP = [  # (B, S, H, K, hd, blk_q, blk_k, window), tests/test_kernels.py
    (1, 128, 4, 4, 32, 64, 64, None),  # MHA
    (2, 256, 4, 2, 64, 64, 64, None),  # GQA 2:1
    (1, 256, 8, 2, 16, 128, 128, None),  # GQA 4:1, small head dim
    (1, 64, 2, 1, 128, 32, 32, None),  # MQA
]
FLASH_WINDOWS = [(1, 256, 4, 2, 32, 64, 64, w) for w in (32, 96, 1024)]
FLASH_ASYMMETRIC = [(1, 256, 2, 2, 32, 128, 32, None)]
FLASH_RAGGED = [(2, 12, 4, 2, 64, 128, 128, None)]  # blk = S = 12, not a multiple of 8
FLASH_HD80 = [(1, 128, 4, 4, 80, 64, 64, None), (2, 256, 8, 8, 80, 128, 128, None)]
FLASH_HD192 = [(1, 256, 8, 2, 192, 128, 128, None), (1, 384, 4, 2, 192, 128, 128, 100)]  # bf16 only
FLASH_SERVE_LIKE = [  # tests/test_torch_cuda.py's serve-like cases, in both dtypes
    (2, 512, 8, 2, 128, 128, 128, None),  # granite's head dim, S = 512
    (2, 512, 8, 8, 80, 128, 128, None),  # zamba2's head dim, S = 512
    (1, 512, 4, 2, 128, 128, 128, 200),  # a window at S = 512
    (1, 512, 4, 2, 128, 256, 64, None),  # blk_q above 128
]
GRANITE_ATTN = (8, 512, 32, 8, 128, 128, 128, None)  # prefill of the serve phase
ZAMBA_ATTN = (8, 512, 32, 32, 80, 128, 128, None)  # zamba2's shared block
MIXTRAL_ATTN = (8, 512, 32, 8, 128, 128, 128, 4096)  # mixtral's (and phi's) shape, window 4096 >= S
INTERNVL2_ATTN = (8, 768, 14, 2, 64, 128, 128, None)  # GQA 7:1, 256 patches + 512 tokens
MUSICGEN_ATTN = (8, 512, 32, 32, 64, 128, 128, None)  # MHA at hd 64

SSD_SWEEP = [  # (B, S, H, P, G, N, chunk), tests/test_kernels.py:110-118
    (1, 64, 2, 16, 1, 8, 16),
    (2, 128, 4, 16, 2, 8, 32),
    (1, 128, 4, 32, 1, 16, 64),
    (1, 256, 8, 16, 4, 8, 32),
]
ZAMBA_SSD = (8, 512, 80, 64, 1, 64, 128)  # zamba2-2.7b's prompt forward, per layer
RWKV6_SWEEP = [  # (B, S, H, P, chunk), tests/test_kernels.py:74-77
    (1, 64, 2, 16, 16), (2, 128, 3, 16, 32), (1, 96, 1, 32, 32), (1, 32, 2, 8, 32),
]
RWKV6_STRONG = (1, 128, 2, 16, 32)  # with logw = -5, tests/test_kernels.py:92-104
RWKV6_STRONG_WIDE = (1, 512, 2, 64, 64)  # logw = -5 at rwkv6's widths, eight 64-step chunks
RWKV6_SERVE = (8, 512, 40, 64, 32)  # rwkv6-3b's prompt forward, per layer

SERVE_ARCHS = ["granite-3-8b", "zamba2-2.7b", "rwkv6-3b"]
# The MoE configs do not fit one 80 GB card whole (93.4 / 83.7 GB of bf16
# parameters), so each runs at full width with part of its 32 layers.  Phase
# 3 serves them in float32 with 8 layers (47.5 / 42.7 GB): in bf16 the prompt
# forward and the teacher-forced decode route near-tied tokens to different
# experts, the flips compound over layers, and the served check fails
# (PERF.md; tools/moe_routing_probe.py measures it); float32 is the JAX
# invariant's own dtype.  Phase 4 profiles them in bf16 with 16 layers
# (47.0 / 42.1 GB), and phase 5c evaluates mixtral so.
MOE_SERVE_ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"]
MOE_SERVE = (8, "float32")  # (layers, dtype) of phase 3
MOE_PROFILE = (16, "bfloat16")  # (layers, dtype) of phase 4
# Phase 4's serving loop: PROFILE_PROMPT teacher-forced steps, then 8
# generated; short, for the script's time limit.
PROFILE_PROMPT = 32

TRAIN_CPU_CHECK = [("granite-3-8b", 1), ("zamba2-2.7b", 1), ("rwkv6-3b", 2),  # (arch, microbatches)
                   ("mixtral-8x7b", 1), ("internvl2-1b", 1), ("musicgen-large", 2)]
TRAIN_FULL_CLI = [("rwkv6-3b", 2), ("zamba2-2.7b", 1),  # full width through launch.train.main
                  ("internvl2-1b", 1), ("musicgen-large", 1)]
# Depth cuts for make_train_step at full width: the most layers that fit with
# float32 moments on one 80 GB card.
TRAIN_LAYERS = {"granite-3-8b": 8, "mixtral-8x7b": 2}
EVAL_LAYERS = {"mixtral-8x7b": 16}  # the eval step holds no moments: as served
PROFILE_TRAIN = ["rwkv6-3b", "zamba2-2.7b", "granite-3-8b"]  # phase 5e
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 4

# Phase 6: the network engines (repro_torch.network) at the sizes of the
# paper's machines (src/repro/core/bgq.py).  A BG/Q midplane is 4 x 4 x 4 x 4
# x 2 nodes, so a partition of (m0, m1, m2, m3) midplanes is the node torus
# (4 m0, 4 m1, 4 m2, 4 m3, 2).
MIDPLANE_TORI = {"Mira": (4, 4, 3, 2), "JUQUEEN": (7, 2, 2, 2), "Sequoia": (4, 4, 4, 3)}
# Mira's scheduler partitions by midplane count (the paper's Table 6,
# current geometry) and the geometries it proposes where they do better
# (Table 1), with the ratio of their pairing makespans.
MIRA_SCHEDULER_PARTITIONS = {
    1: (1, 1, 1, 1), 2: (2, 1, 1, 1), 4: (4, 1, 1, 1), 8: (4, 2, 1, 1), 16: (4, 4, 1, 1),
    24: (4, 3, 2, 1), 32: (4, 4, 2, 1), 48: (4, 4, 3, 1), 64: (4, 4, 2, 2), 96: (4, 4, 3, 2),
}
MIRA_PROPOSED_PARTITIONS = {4: (2, 2, 1, 1), 8: (2, 2, 2, 1), 16: (2, 2, 2, 2), 24: (3, 2, 2, 2)}
TABLE1_RATIOS = {4: 2.0, 8: 2.0, 16: 2.0, 24: 4.0 / 3.0}
# The whole machines' pairing makespans from the JAX package's NumPy
# simulate_flows (one step each).
FULL_MACHINE_PAIRING = {"Mira": 4.0, "JUQUEEN": 7.0}
NET_RANDOM_MESSAGES = 1 << 20  # (a): random messages on Mira's node torus, volumes 1-4
NET_BENCH_MACHINE = (32, 32, 32)  # (c): benchmarks/bench_backend.py's batched drain
NET_BENCH_GEOMETRIES = ((8, 8, 8), (16, 8, 4), (4, 16, 8), (8, 4, 16))
NET_BENCH_LANES, NET_BENCH_SAMPLED = 512, 16
NET_SCORER = [  # (d): (machine, the pairing job's logical grid, candidate mappings)
    ((4, 4, 3, 2), (4, 3, 2), 4096),  # the bench's scorer case: 24 ranks on Mira's midplanes
    ((16, 4, 4, 4, 2), (16, 4, 4, 4, 2), 1024),  # 2048 ranks on the 4-midplane partition
]
NET_PLACED_JOBS, NET_JOB = 8, (8, 4, 4, 4, 2)  # (e): jobs of 512 nodes on Mira's node torus

# Phase 7: the allocation engines.  A BG/Q midplane is MIDPLANE_NODES nodes;
# the advisor drains both node tori of a size up to ADVISOR_SIMULATE_NODES
# nodes: phase 6b drains the largest of them, (16, 16, 4, 4, 2), in about a
# second on the card, under the 2 s a size may take.
MIDPLANE_NODES = (4, 4, 4, 4, 2)
ADVISOR_SIMULATE_NODES = 8192
# (b): BENCH_scheduler.json's largest grid, its job count, seed and stream
# (benchmarks/bench_scheduler.py::_service_throughput).
SCHEDULER_SCENARIO = dict(machine=(32, 32, 32), jobs=120, seed=2, burst_gap=30.0, mean_duration=80.0,
                          failure_rate=0.002, repair_delay=150.0)
# (c): a seeded stream of midplane jobs on Mira, sizes from its scheduler table.
QUEUE_JOBS, QUEUE_SIZES, QUEUE_SEED = 24, (1, 2, 4, 8, 16, 24, 32), 7
MAP_JOB = ((16, 16, 12, 8, 2), (8, 8, 8, 8, 2))  # (d): (machine, oriented job), halo traffic
# (d)'s check against the CPU path runs this job's whole catalogue on both:
# MAP_JOB's takes the CPU path 26-63 s (PERF.md §5), the script's time limit.
MAP_JOB_CPU = (8, 8, 4, 4, 2)

# Phase 8: the fleet planner on Mira at 16 midplanes (train_4k, torus mode,
# 2 GB/s links, the H100 profile), tests/test_golden_tables.py's models.
PLAN_ARCHS = ["mixtral-8x7b", "qwen1.5-110b", "nemotron-4-340b"]
PLAN_MIDPLANES = 16
# What the H100 profile gives there, arch -> (best geometry, best (d, f, t,
# e), bisection efficiency, table rows): the port's CPU path, pinned by
# tests/test_torch_planner.py::H100_MIRA_PLANS.  80 GB admits mixtral's and
# qwen's data 4 x fsdp 4 rule, which wins on the (4, 4, 1, 1) partition.
H100_MIRA_PLANS = {
    "mixtral-8x7b": ((4, 4, 1, 1), (4, 4, 1, 1), 0.5, 73),
    "qwen1.5-110b": ((4, 4, 1, 1), (4, 4, 1, 1), 0.5, 29),
    "nemotron-4-340b": ((2, 2, 2, 2), (1, 16, 1, 1), 1.0, 13),
}
# Phase 9.  Strassen at a size the paper's per-node kernel sees; times over
# STRASSEN_ITERS calls after one warm-up (one n = 16384 float32 product is
# about 0.2 s).
STRASSEN_N = 16384
STRASSEN_DEPTHS = (0, 1, 2)
STRASSEN_ITERS = 3
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
RING_SHAPE = (4096, 4096, 4096)  # (m, k, n) of the one-rank rings
DRYRUN_CELLS = [("granite-3-8b", "train_4k", "single"), ("granite-3-8b", "decode_32k", "multi"),
                # the SSD scan on its head shards (80 heads over 16), the WKV scan at
                # batch 1 on 512 fake ranks, the MoE dispatch on its batch shards
                ("zamba2-2.7b", "train_4k", "single"), ("rwkv6-3b", "long_500k", "multi"),
                ("mixtral-8x7b", "train_4k", "single"),
                # one microbatch of 16 rows a rank: the layer inputs kept as
                # their slices over "model" (whole, 86 GB a rank)
                ("llama3-70b", "train_4k", "single")]
# The cells run in two lanes of child processes at once, each lane's in
# order; their peak allocated bytes on an H100 (GB) keep any two that
# overlap on the card below its 80 GB: zamba2 46.2 then llama3-70b 38.6 in
# one lane, granite train 8.9, granite decode 2.0, rwkv6 0.1, mixtral 24.8
# in the other.
DRYRUN_LANES = [[2, 5], [0, 1, 3, 4]]
# Cells run without the collective calibration (their collectives are the
# production run's, every layer traced), to keep the script inside its
# time limit; the CLI's --all runs every cell calibrated.
DRYRUN_UNCALIBRATED = {("zamba2-2.7b", "train_4k", "single"), ("rwkv6-3b", "long_500k", "multi"),
                       ("mixtral-8x7b", "train_4k", "single")}
# The collective term's link rate: one 400 Gb/s NDR InfiniBand port per
# H100, the per-GPU rate between the nodes of a DGX H100 cluster.
DRYRUN_LINK_BW = 50e9
AVOIDABLE_FLOOR = 1.3  # the paper's avoidable-contention floor: worst / best step time

# Phase 10: the rest of the network engines.  (a) Mira's current and
# proposed partitions by midplane count (node level), routed by DOR and the
# minimal-adaptive router; (c) jobs on the 32^3 torus, (job, oriented,
# offset), four of them spilling (a span w with 2 w - 2 >= 32 routes around
# the ring through foreign cells) and one not; (d) the HyperX cases.
ROUTING_MIDPLANES = (8, 16)
SPILL_MACHINE = (32, 32, 32)
SPILL_JOBS = [(0, (24, 8, 4), (0, 0, 0)), (1, (8, 8, 4), (24, 0, 0)), (2, (4, 20, 4), (0, 8, 0)),
              (3, (8, 8, 8), (16, 16, 16)), (4, (4, 4, 18), (8, 8, 8)), (5, (18, 2, 2), (8, 28, 28))]
HX_ROUTE = (16, 16, 4)  # all-to-all, 1,047,552 messages, minimal and DAL
HX_PODS = [(16, 4), (8, 8)]  # compare_fabric_routing (examples/hyperx_analysis.py's pod first)
HX_QUEUE = dict(jobs=40, sizes=(2, 4, 8, 16, 32), seed=5)  # a seeded stream on the (16, 4) pod
HX_PLAN = ("mixtral-8x7b", 16, "decode_32k")  # (arch, chips, shape) planned on the (16, 4) pod


def serve_args(arch: str):
    return [
        "--arch", arch, "--no-reduced", "--requests", "8",
        "--prompt-len", "512", "--gen-len", "32", "--seed", "0", "--device", "cuda",
    ]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n: int = 20, replays: int = 10) -> float:
    """Time per call of ``fn`` from replaying a CUDA graph of ``n`` captured
    calls: the host's cost of each call (argument checks, ctypes, tensor-map
    encoding) is left out, as a serving loop under a graph would leave it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays)


def kernel_name(mangled: str) -> str:
    """``flash_fwd_sm90_kernel<128>``, ``rwkv6_fwd_kernel<float>``,
    ``ssd_fwd_sm90_kernel`` and the like from a mangled kernel name (a
    length-prefixed name ending in ``_kernel``, then its template arguments
    up to ``EE``, or ``E`` where it has none)."""
    for m in re.finditer(r"\d+", mangled):
        for start in range(m.start(), m.end()):  # a hash's digits may run into the prefix
            name = mangled[m.end():m.end() + int(mangled[start:m.end()])]
            if name.endswith("_kernel") and mangled[m.end() + len(name):][:1] in ("I", "E"):
                break
        else:
            continue
        if mangled[m.end() + len(name)] == "E":
            return name
        args = mangled[m.end() + len(name) + 1:].split("EE", 1)[0]
        args = re.sub(r"Li(\d+)E?", r",\1", args).replace("13__nv_bfloat16", ",bf16")
        args = re.sub(r"(^|,)f(?=,|$)", r"\1float", args)
        return f"{name}<{args.strip(',')}>"
    return mangled


def ptxas_summary(log: str):
    """Per kernel of an ``nvcc -Xptxas -v`` log: (kernel, registers, spill
    stores, spill loads, static shared memory bytes)."""
    rows, fn, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and fn:
            rows.append((fn, int(m.group(1)), *spills, int(m.group(2) or 0)))
            fn, spills = None, (0, 0)
    return rows


def flash_inputs(case, dtype, gen):
    import torch

    B, S, H, K, hd = case[:5]
    mk = lambda heads: torch.randn(B, S, heads, hd, generator=gen, device="cuda").to(dtype)
    return mk(H), mk(K), mk(K)


def check_flash(case, dtype, gen, tol, float64=False):
    """Kernel vs plain version on one case, and that the dtype's own kernel
    ran (bf16: flash_fwd_sm90.cu, float32: flash_fwd_tf32_sm90.cu); with
    ``float64`` against the plain version in float64, the float32 plain
    version's own error printed beside it.  Returns (max |err|, inputs)."""
    import torch
    from repro_torch.kernels.attention import ops, ref

    _, _, _, _, _, blk_q, blk_k, window = case
    q, k, v = flash_inputs(case, dtype, gen)
    before = (ops.tensor_core_launches, ops.tf32_launches)
    out = ops.flash_attention(q, k, v, causal=True, window=window, blk_q=blk_q, blk_k=blk_k)
    launched = (ops.tensor_core_launches - before[0], ops.tf32_launches - before[1])
    if launched != ((1, 0) if dtype == torch.bfloat16 else (0, 1)):
        raise RuntimeError(f"flash {case} {dtype}: launched the wrong kernel for its dtype "
                           f"(bf16, float32 kernel launches: {launched})")
    plain = lambda *t: ref.attention_reference(
        *(x.transpose(1, 2) for x in t), causal=True, window=window).transpose(1, 2)
    label = f"flash {case[:5]} blk {blk_q}/{blk_k} window {window} {str(dtype)[6:]}"
    if not float64:
        return check_close(label, out, plain(q, k, v), tol), (q, k, v)
    want = plain(q.double(), k.double(), v.double())
    err = check_close(label + " vs float64", out, want, tol)
    print(f"    float32 plain version vs float64: max |err| "
          f"{float((plain(q, k, v).double() - want).abs().max()):.3g}")
    return err, (q, k, v)


def flash_bound_ms(case, dtype_bytes: int, rate: str = "tensor cores"):
    """Least time for the function at a causal case whose window masks no
    key: bytes of q, k, v, o once over HBM rate vs 4*hd flops per unmasked
    (q, k) pair over the peak where they run.  On the tensor cores (the
    kernels line's ``bound_ms``) that is the bf16 peak for bf16 inputs and,
    for float32 ones, three split-TF32 products (hi.hi + hi.lo + lo.hi) per
    product over the TF32 peak; ``rate="float32"`` takes the float32 peak
    outside the tensor cores (the float32 kernel's ``bound_f32_ms``).
    Returns (ms, "bytes" | "operations")."""
    B, S, H, K, hd = case[:5]
    nbytes = dtype_bytes * B * S * hd * (2 * H + 2 * K)
    pairs = S * (S + 1) // 2
    flops = 4 * hd * B * H * pairs
    if rate == "float32":
        t_ops = flops / F32_FLOPS
    else:
        t_ops = flops / BF16_FLOPS if dtype_bytes == 2 else 3 * flops / TF32_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_close(label, got, want, tol):
    """Raise unless ``got`` is finite and within tol + tol * |want| of
    ``want`` in every element (the JAX kernel tests' assert_allclose);
    returns max |err|."""
    import torch

    want = want.double()
    err = (got.double() - want).abs()
    max_err = float(err.max())
    bad = int((err > tol + tol * want.abs()).sum())
    print(f"  {label}: max |err| {max_err:.3g}, max |want| {float(want.abs().max()):.3g}, "
          f"mean |want| {float(want.abs().mean()):.3g} (tol {tol:g})")
    if bad or not torch.isfinite(got.float()).all():
        raise RuntimeError(f"{label}: kernel disagrees with the plain version: {bad} elements "
                           f"out of tolerance, max |err| {max_err}")
    return max_err


def ssd_inputs(case, dtype, gen):
    import torch

    B, S, H, P, G, N = case[:6]
    rn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    xh, bm, cm = rn(B, S, H, P).to(dtype), rn(B, S, G, N).to(dtype), rn(B, S, G, N).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, S, H))
    A = -torch.exp(rn(H))
    return xh, dt, A, bm, cm


def as_float64(args):
    return [a.double() for a in args]


def ssd_plain(xh, dt, A, bm, cm):
    """The plain version on the kernel's inputs, in the model layout, in
    float32 (float64 for float64 inputs)."""
    from repro_torch.kernels.ssd import ref

    xw = (xh.to(dt.dtype) * dt[..., None]).transpose(1, 2)
    la = (dt * A).transpose(1, 2)[..., None]
    y, st = ref.ssd_reference(xw, la, bm.transpose(1, 2), cm.transpose(1, 2))
    return y.transpose(1, 2), st


def check_against(label, got, plain, args, tol, float64=False):
    """Hold the kernel's outputs ``got`` against the plain version on the
    same inputs, in float32, or with ``float64`` in float64, beside which the
    float32 plain version's own error is printed: at a serve shape an output
    sums hundreds of terms, and float64 shows which of the two float32
    evaluations rounds further.  Returns max |err|."""
    wants = plain(*(as_float64(args) if float64 else args))
    err = 0.0
    for name, g, w in zip(("out", "state"), got, wants):
        err = max(err, check_close(f"{label} {name}", g, w, tol))
    if float64:
        for name, p, w in zip(("out", "state"), plain(*args), wants):
            print(f"    float32 plain version {name} vs float64: max |err| "
                  f"{float((p.double() - w).abs().max()):.3g}")
    return err


def check_ssd(case, dtype, gen, tol, float64=False):
    from repro_torch.kernels.ssd import ops

    args = ssd_inputs(case, dtype, gen)
    got = ops.ssd_scan(*args, chunk=case[6])
    label = f"ssd {case} {str(dtype)[6:]}"
    return check_against(label, got, ssd_plain, args, tol, float64), args


def least_flops_per_step(per_chunk, S: int) -> float:
    """The least operations per step and head over the chunk lengths Q = 1..S
    of a chunked scan whose chunk of Q steps costs ``per_chunk(Q)``.  The
    output does not depend on Q; Q = 1 is the step-by-step recurrence."""
    return min(per_chunk(Q) / Q for Q in range(1, S + 1))


def ssd_work(case, in_bytes: int):
    """The bytes the SSD function moves (x, B, C at their size, dt, A, y and
    the state once) and its least operations over the chunk lengths.  A
    chunk of Q steps costs 2 per multiply-add of the causal halves of C B^T
    and of the score product, of C S and of the state update, and 1 per
    element of the state's decay (exponentials not counted); at Q = 1 that is
    the recurrence's 5 N P + 2 (N + P) per step."""
    B, S, H, P, G, N, _ = case
    nbytes = (in_bytes * (B * S * H * P + 2 * B * S * G * N) + 4 * (B * S * H + H)
              + 4 * (B * S * H * P + B * H * N * P))
    per_chunk = lambda Q: 2 * (Q * (Q + 1) // 2 * (N + P) + 2 * Q * N * P) + N * P
    return nbytes, least_flops_per_step(per_chunk, S) * B * S * H


def ssd_bound_ms(case, in_bytes: int):
    """Least time for the SSD function outside the tensor cores (the kernels
    line's ``bound_f32_ms``): its bytes over HBM rate vs its least operations
    over the peak for the inputs' type there.  Returns (ms, "bytes" |
    "operations")."""
    nbytes, flops = ssd_work(case, in_bytes)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (F32_FLOPS if in_bytes == 4 else BF16_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ssd_tc_bound_ms(case, in_bytes: int):
    """The SSD bound on the tensor cores, where the kernel does its products
    (the kernels line's ``bound_ms``): the same bytes vs three times the least
    operations (split TF32: hi.hi + hi.lo + lo.hi) over the TF32 peak.
    Returns (ms, "bytes" | "operations")."""
    nbytes, flops = ssd_work(case, in_bytes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rwkv6_inputs(case, dtype, gen, logw=None):
    import torch

    B, S, H, P = case[:4]
    rn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    r, k, v = (rn(B, S, H, P).to(dtype) for _ in range(3))
    if logw is None:
        lw = -torch.exp(rn(B, S, H, P) - 1.0)
    else:
        lw = torch.full((B, S, H, P), logw, device="cuda")
    return r, k, v, lw, rn(H, P) * 0.1


def rwkv6_plain(r, k, v, lw, u):
    """The plain version in the model layout, in float32 (float64 for
    float64 inputs)."""
    from repro_torch.kernels.rwkv6 import ref

    hm = lambda t: t.transpose(1, 2)
    out, st = ref.rwkv6_reference(hm(r), hm(k), hm(v), hm(lw), u)
    return hm(out), st


def check_rwkv6(case, dtype, gen, tol, logw=None, float64=False):
    from repro_torch.kernels.rwkv6 import ops

    args = rwkv6_inputs(case, dtype, gen, logw)
    got = ops.rwkv6_mix(*args, chunk=case[4])
    label = f"rwkv6 {case} {str(dtype)[6:]}" + ("" if logw is None else f" logw {logw}")
    return check_against(label, got, rwkv6_plain, args, tol, float64), args


def rwkv6_work(case, in_bytes: int):
    """The bytes the WKV function moves (r, k, v at their size, logw, u, the
    output and the state once) and its least operations over the chunk
    lengths.  A chunk of Q steps costs 2 per multiply-add of the two
    (Q,P)x(P,P) products and of the causal output term, 3 per element of
    the causal score sum and 1 per element of the state's decay
    (exponentials not counted); at Q = 1 that is the recurrence's
    5 P^2 + 2 P per step."""
    B, S, H, P, _ = case
    nbytes = in_bytes * 3 * B * S * H * P + 4 * (2 * B * S * H * P + H * P + B * H * P * P)
    per_chunk = lambda Q: (2 * (2 * Q * P * P + Q * (Q + 1) // 2 * P)
                           + 3 * (Q * (Q - 1) // 2) * P + P * P)
    return nbytes, least_flops_per_step(per_chunk, S) * B * S * H


def rwkv6_bound_ms(case, in_bytes: int):
    """Least time for the WKV function outside the tensor cores (the kernels
    line's ``bound_f32_ms``): its bytes over HBM rate vs its least
    operations over the float32 peak there (the scan computes in float32
    whatever the type of r, k, v).  Returns (ms, "bytes" | "operations")."""
    nbytes, flops = rwkv6_work(case, in_bytes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rwkv6_tc_bound_ms(case, in_bytes: int):
    """The WKV bound on the tensor cores, where the kernel does its products
    (the kernels line's ``bound_ms``): the same bytes vs three times the
    least operations (split TF32: hi.hi + hi.lo + lo.hi) over the TF32 peak.
    Returns (ms, "bytes" | "operations")."""
    nbytes, flops = rwkv6_work(case, in_bytes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 3 * flops / TF32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def device_time_by_kernel(prof) -> dict:
    """Summed device time (us) per kernel name of a torch.profiler run."""
    import torch

    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return by_name


def profile_prompt_forward(model, params, prompts) -> dict:
    """Device busy share of one prompt forward through the kernels, after a
    warm-up forward; the idle share divides by an untraced forward's wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import make_prefill_step

    prefill = make_prefill_step(model)
    prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
    by_name = device_time_by_kernel(prof)
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "top_kernels_ms": [(name[:60], us / 1e3) for name, us in top],
    }


def profile_serving_loop(model, params, prompts, n_gen: int = 8) -> dict:
    """Device busy share of the serving loop (teacher-forced prefill, then
    greedy decode) at full width.  The loop runs untraced twice (the first
    run, at the same shapes, absorbs lazy set-up, the second gives the wall
    time), then once under torch.profiler, whose kernel intervals give the
    device's busy time; the tracer slows the host, so the idle share
    divides by the untraced wall.  Kernels run on one stream, so their
    intervals do not overlap."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve

    batch, n_prompt = prompts.shape

    def loop():
        cache = model.init_cache(batch, n_prompt + n_gen, device="cuda")
        logits, cache = serve.prefill_by_decode(model, params, cache, prompts)
        serve.greedy_decode(model, params, cache, logits, n_prompt, n_gen)
        torch.cuda.synchronize()

    with torch.inference_mode():
        loop()
        t0 = time.perf_counter()
        loop()
        wall_us = (time.perf_counter() - t0) * 1e6
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loop()
            traced_wall_us = (time.perf_counter() - t0) * 1e6
    by_name = device_time_by_kernel(prof)
    busy_us = sum(by_name.values())
    steps = n_prompt + n_gen
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "steps": steps,
        "wall_ms_per_step": wall_us / steps / 1e3,
        "traced_wall_ms_per_step": traced_wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "top_kernels_ms_per_step": [(name[:60], us / steps / 1e3) for name, us in top],
    }


def phase2_kernels(torch, gen, build_logs: dict) -> dict:
    """Phase 2: every kernel against its plain version, then timed at its
    serve shape.  ``build_logs`` is phase 1's compiler output by source.
    Returns the per-kernel numbers of the JSON line."""
    from repro_torch.kernels.attention import ops as flash_ops
    from repro_torch.kernels.attention import ref as flash_ref
    from repro_torch.kernels.rwkv6 import ops as rwkv6_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    out = {}
    for stem, dtype, regs_note in (
            ("flash_fwd_sm90", "bf16", "232 per consumer thread, 40 per producer thread"),
            ("flash_fwd_tf32_sm90", "float32 (split TF32)",
             "224 per consumer thread, 56 per producer thread")):
        print(f"phase 2: flash attention, {dtype} tensor-core kernel ({stem}.cu): nvcc -Xptxas -v")
        smem_bytes = getattr(flash_ops._kernel(stem), f"{stem}_smem_bytes")
        smem_bytes.argtypes, smem_bytes.restype = [ctypes.c_int], ctypes.c_int
        summary = ptxas_summary(build_logs.get(stem, ""))
        if not summary:
            print("  (no compiler output: the library was built before this run)")
        for fn, regs, spill_st, spill_ld, smem in summary:
            hd = int(fn.rsplit("<", 1)[1][:-1])
            print(f"  {fn}: {regs} registers at launch (setmaxnreg: {regs_note}), {spill_st} / "
                  f"{spill_ld} bytes spill stores / loads, {smem} B static + {smem_bytes(hd)} B "
                  "dynamic shared memory")
            if spill_st or spill_ld:
                raise RuntimeError(f"{fn} spills registers")
        for line in build_logs.get(stem, "").splitlines():
            if "Performance Loss" in line:
                print("  ptxas:", line.strip()[:160])
    print("phase 2: flash attention kernels vs plain version (bf16: flash_fwd_sm90.cu, "
          "float32: flash_fwd_tf32_sm90.cu)")
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
        for case in (FLASH_SWEEP + FLASH_WINDOWS + FLASH_ASYMMETRIC + FLASH_RAGGED + FLASH_HD80
                     + FLASH_SERVE_LIKE):
            check_flash(case, dtype, gen, tol)
    for case in FLASH_HD192:
        check_flash(case, torch.bfloat16, gen, 2e-2)
    print("phase 2: flash attention at the shapes the MoE and modality configs give it")
    for case in (INTERNVL2_ATTN, MUSICGEN_ATTN):  # GQA 7:1 and MHA at hd 64
        check_flash(case, torch.float32, gen, 2e-4)
    check_flash(MIXTRAL_ATTN, torch.bfloat16, gen, 2e-2)  # window 4096 >= S: masks no key
    # Timed at each serve path's shape; phase 3 serves the MoE configs in
    # float32, so their prompt forwards run the split-TF32 kernel at
    # mixtral's shape (phi's is the same without the window, which masks no
    # key here), checked there against float64 as well.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, case, dtype, tol in (("flash_fwd", GRANITE_ATTN, torch.bfloat16, 2e-2),
                                   ("flash_fwd hd80", ZAMBA_ATTN, torch.bfloat16, 2e-2),
                                   ("flash_fwd gqa7 hd64", INTERNVL2_ATTN, torch.bfloat16, 2e-2),
                                   ("flash_fwd mha hd64", MUSICGEN_ATTN, torch.bfloat16, 2e-2),
                                   ("flash_fwd f32 moe", MIXTRAL_ATTN, torch.float32, 2e-4)):
        float32 = dtype == torch.float32
        err, (q, k, v) = check_flash(case, dtype, gen, tol, float64=float32)
        window = case[7]
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        kernel = lambda: flash_ops.flash_attention(q, k, v, window=window)
        library = lambda: sdpa(qh, kh, vh, is_causal=True, enable_gqa=True)  # window None or >= S
        out[name] = dict(
            max_abs_err=err,
            ms=graph_ms(kernel),
            ms_eager=cuda_ms(kernel),
            plain_ms=cuda_ms(lambda: flash_ref.attention_reference(qh, kh, vh, causal=True,
                                                                    window=window)),
            library_ms=graph_ms(library),
            library_ms_eager=cuda_ms(library),
        )
        out[name]["bound_ms"], out[name]["bound_by"] = flash_bound_ms(case, q.element_size())
        if float32:
            out[name]["bound_f32_ms"], out[name]["bound_f32_by"] = \
                flash_bound_ms(case, 4, rate="float32")
        del q, k, v, qh, kh, vh
    out["flash_fwd"]["at_zamba2_hd80"] = out["flash_fwd hd80"]
    out["flash_fwd"]["at_internvl2_gqa7_hd64"] = out["flash_fwd gqa7 hd64"]
    out["flash_fwd"]["at_musicgen_mha_hd64"] = out["flash_fwd mha hd64"]
    out["flash_fwd"]["at_moe_serve_f32"] = out["flash_fwd f32 moe"]

    print("phase 2: SSD, tensor-core kernel (ssd_fwd_sm90.cu): nvcc -Xptxas -v")
    ssd_smem = ssd_ops._kernel().ssd_fwd_sm90_smem_bytes()
    summary = ptxas_summary(build_logs.get("ssd_fwd_sm90", ""))
    if not summary:
        print("  (no compiler output: the library was built before this run)")
    for fn, regs, spill_st, spill_ld, smem in summary:
        print(f"  {fn}: {regs} registers at launch (setmaxnreg: 240 per consumer thread, 24 per "
              f"producer thread), {spill_st} / {spill_ld} bytes spill stores / loads, "
              f"{smem} B static + {ssd_smem} B dynamic shared memory")
        if spill_st or spill_ld:
            raise RuntimeError(f"{fn} spills registers")
    for line in build_logs.get("ssd_fwd_sm90", "").splitlines():
        if "Performance Loss" in line:
            print("  ptxas:", line.strip()[:160])
    print("phase 2: SSD kernel vs plain version")
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
        for case in SSD_SWEEP:
            check_ssd(case, dtype, gen, tol)
    err, args = check_ssd(ZAMBA_SSD, torch.float32, gen, 2e-4, float64=True)
    kernel = lambda: ssd_ops.ssd_scan(*args, chunk=ZAMBA_SSD[6])
    out["ssd_fwd"] = dict(
        max_abs_err=err,
        ms=graph_ms(kernel),
        ms_eager=cuda_ms(kernel),
        plain_ms=cuda_ms(lambda: ssd_plain(*args), iters=5, warmup=1),
        library_ms=None,
    )
    out["ssd_fwd"]["bound_ms"], out["ssd_fwd"]["bound_by"] = ssd_tc_bound_ms(ZAMBA_SSD, 4)
    out["ssd_fwd"]["bound_f32_ms"], out["ssd_fwd"]["bound_f32_by"] = ssd_bound_ms(ZAMBA_SSD, 4)
    del args

    print("phase 2: RWKV6, tensor-core kernel (rwkv6_fwd_sm90.cu): nvcc -Xptxas -v")
    rwkv6_lib = rwkv6_ops._kernel()
    summary = ptxas_summary(build_logs.get("rwkv6_fwd_sm90", ""))
    if not summary:
        print("  (no compiler output: the library was built before this run)")
    for fn, regs, spill_st, spill_ld, smem in summary:
        code = int(fn.endswith("<bf16>"))
        print(f"  {fn}: {regs} registers, {spill_st} / {spill_ld} bytes spill stores / loads, "
              f"{smem} B static + {rwkv6_lib.rwkv6_fwd_sm90_smem_bytes(code)} B dynamic shared "
              f"memory, {rwkv6_lib.rwkv6_fwd_sm90_blocks_per_sm(code)} block(s) per SM")
        if spill_st or spill_ld:
            raise RuntimeError(f"{fn} spills registers")
    for line in build_logs.get("rwkv6_fwd_sm90", "").splitlines():
        if "Performance Loss" in line:
            print("  ptxas:", line.strip()[:160])
    print("phase 2: RWKV6 kernel vs plain version")
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
        for case in RWKV6_SWEEP:
            check_rwkv6(case, dtype, gen, tol)
    check_rwkv6(RWKV6_STRONG, torch.float32, gen, 2e-4, logw=-5.0)
    for dtype in (torch.float32, torch.bfloat16):
        check_rwkv6(RWKV6_STRONG_WIDE, dtype, gen, 2e-4, logw=-5.0, float64=True)
    # At the serve shape, both dtypes against float64 at 2e-4: bfloat16
    # inputs are exact in float32, so the kernel's arithmetic is the same.
    rwkv6 = {}
    for dtype in (torch.float32, torch.bfloat16):
        err, args = check_rwkv6(RWKV6_SERVE, dtype, gen, 2e-4, float64=True)
        kernel = lambda: rwkv6_ops.rwkv6_mix(*args, chunk=RWKV6_SERVE[4])
        rwkv6[dtype] = dict(max_abs_err=err, ms=graph_ms(kernel), ms_eager=cuda_ms(kernel))
        if dtype == torch.bfloat16:
            rwkv6[dtype]["plain_ms"] = cuda_ms(lambda: rwkv6_plain(*args), iters=5, warmup=1)
        del args
    f32, bf16 = rwkv6[torch.float32], rwkv6[torch.bfloat16]
    out["rwkv6_fwd"] = dict(
        max_abs_err=max(f32["max_abs_err"], bf16["max_abs_err"]),
        ms=bf16["ms"],
        ms_eager=bf16["ms_eager"],
        ms_f32=f32["ms"],
        ms_eager_f32=f32["ms_eager"],
        plain_ms=bf16["plain_ms"],
        library_ms=None,
    )
    m = out["rwkv6_fwd"]
    m["bound_ms"], m["bound_by"] = rwkv6_tc_bound_ms(RWKV6_SERVE, 2)
    m["bound_f32_inputs_ms"], _ = rwkv6_tc_bound_ms(RWKV6_SERVE, 4)
    m["bound_f32_ms"], m["bound_f32_by"] = rwkv6_bound_ms(RWKV6_SERVE, 2)
    print(f"  rwkv6_fwd at {RWKV6_SERVE} with float32 r, k, v: kernel {f32['ms']:.4f} ms "
          f"graph-replayed / {f32['ms_eager']:.4f} ms eager, tensor-core bound "
          f"{m['bound_f32_inputs_ms']:.4f} ms", flush=True)

    for label, name, shape in (("flash_fwd", "flash_fwd", GRANITE_ATTN[:5]),
                               ("flash_fwd hd80", "flash_fwd hd80", ZAMBA_ATTN[:5]),
                               ("flash_fwd GQA 7:1 hd64", "flash_fwd gqa7 hd64", INTERNVL2_ATTN[:5]),
                               ("flash_fwd MHA hd64", "flash_fwd mha hd64", MUSICGEN_ATTN[:5]),
                               ("flash_fwd float32 (flash_fwd_tf32_sm90.cu), window 4096",
                                "flash_fwd f32 moe", MIXTRAL_ATTN[:5]),
                               ("ssd_fwd", "ssd_fwd", ZAMBA_SSD),
                               ("rwkv6_fwd bf16 r, k, v", "rwkv6_fwd", RWKV6_SERVE)):
        m = out[name]
        kernel = f"kernel {m['ms']:.4f} ms"
        if "ms_eager" in m:
            kernel += f" graph-replayed / {m['ms_eager']:.4f} ms eager"
        library = "none" if m["library_ms"] is None else f"{m['library_ms']:.4f} ms"
        if "library_ms_eager" in m:
            library += f" graph-replayed / {m['library_ms_eager']:.4f} ms eager"
        bound = f"bound {m['bound_ms']:.4f} ms ({m['bound_by']})"
        if "bound_f32_ms" in m:
            bound += (f" on the tensor cores in split TF32, {m['bound_f32_ms']:.4f} ms "
                      f"({m['bound_f32_by']}) at the float32 rate")
        print(f"  {label} at {shape}: {kernel}, plain {m['plain_ms']:.4f} ms, library {library}, "
              f"{bound}", flush=True)
    return out


def expected_launches(cfg) -> dict:
    """Kernel launches of one prompt forward through the kernels (of at most
    a sliding window's length: every transformer layer launches flash)."""
    if cfg.family == "hybrid":
        return {"flash_fwd": cfg.n_layers // cfg.shared_attn_every, "ssd_fwd": cfg.n_layers,
                "rwkv6_fwd": 0}
    if cfg.rwkv is not None:
        return {"flash_fwd": 0, "ssd_fwd": 0, "rwkv6_fwd": cfg.n_layers}
    return {"flash_fwd": cfg.n_layers, "ssd_fwd": 0, "rwkv6_fwd": 0}


def moe_config(arch: str, layers_dtype):
    """An MoE config at full width with ``layers`` of its layers and
    ``dtype`` parameters and activations."""
    import dataclasses

    from repro_torch.configs import get_arch

    layers, dtype = layers_dtype
    return dataclasses.replace(get_arch(arch), n_layers=layers, param_dtype=dtype,
                               activation_dtype=dtype)


def depth_label(cfg) -> str:
    from repro_torch.configs import get_arch

    full = get_arch(cfg.name)
    label = cfg.name if cfg.n_layers == full.n_layers else \
        f"{cfg.name} ({cfg.n_layers} of {full.n_layers} layers)"
    return label if cfg.param_dtype == full.param_dtype else f"{label} {cfg.param_dtype}"


def flash_launches_by_kernel(flash_ops, n: int, dtype: str, label: str) -> dict:
    """Raise unless all ``n`` flash launches of a run went to the kernel of
    its activation dtype (bf16: flash_fwd_sm90.cu, float32:
    flash_fwd_tf32_sm90.cu); returns them by kernel."""
    got = {"flash_fwd_tensor_core": flash_ops.tensor_core_launches,
           "flash_fwd_tf32": flash_ops.tf32_launches}
    want = {"flash_fwd_tensor_core": n if dtype == "bfloat16" else 0,
            "flash_fwd_tf32": n if dtype == "float32" else 0}
    if got != want:
        raise RuntimeError(f"{label}: flash launches by kernel {got}, expected {want} for {dtype}")
    return got


def phase3_serve(torch, cfg, counters: dict) -> dict:
    """Serve one configuration at full width through the launcher's
    ``serve_config`` with its CLI's arguments (``serve.main`` is that call on
    a registered config; a depth-cut one needs it); returns its launch
    counts."""
    from repro_torch.launch import serve

    label = depth_label(cfg)
    print(f"phase 3: serve {label} at full width: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, hd {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff}" + (f", {cfg.moe.num_experts} experts top-{cfg.moe.top_k}"
                                if cfg.moe else "")
          + f", {cfg.param_dtype}, {cfg.param_count() / 1e9:.2f} B parameters", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for mod in counters.values():
        mod.launches = 0
    counters["flash_fwd"].tensor_core_launches = counters["flash_fwd"].tf32_launches = 0
    args = serve.build_parser().parse_args(serve_args(cfg.name))
    result = serve.serve_config(cfg, args, torch.device("cuda"))
    if cfg.moe:
        print(f"  {label}: routing, prompt forward (no-drop capacity) against teacher-forced "
              f"decode: {result['routing']}", flush=True)
    launches = {name: mod.launches for name, mod in counters.items()}
    want = expected_launches(cfg)
    if launches != want:
        raise RuntimeError(f"{label}: kernel launches {launches} in the serve run, expected {want}")
    launches.update(flash_launches_by_kernel(counters["flash_fwd"], launches["flash_fwd"],
                                             cfg.activation_dtype, label))
    gen_ids = result["tokens"]
    if gen_ids.shape != (8, 32) or int(gen_ids.max()) >= cfg.vocab_size or int(gen_ids.min()) < 0:
        raise RuntimeError(f"{label}: generated ids out of range: shape {gen_ids.shape}")
    print(f"  {label}: launches {launches}; prompt forward (kernels) "
          f"{result['prompt_forward_s'] * 1e3:.1f} ms; teacher-forced prefill "
          f"{result['prefill_s'] * 1e3:.1f} ms; decode {result['decode_s'] * 1e3:.1f} ms; "
          f"{result['tokens_per_s']:.1f} tok/s; prefill/decode max |diff| "
          f"{result['prefill_decode_max_abs_diff']:.4g} (tol {result['prefill_decode_tol']:.4g}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return launches


class Tee:
    """A text stream that writes through to ``out`` and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text: str) -> int:
        self.parts.append(text)
        return self.out.write(text)

    def flush(self) -> None:
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def train_numbers(step_ms, losses, n_params: int, peak_bytes: int) -> dict:
    """ms per step after step 0, tokens/s and mfu_6nt (6 N T over the step
    time and the bf16 peak; remat's recomputed forward is not counted) of a
    full-width run of TRAIN_BATCH x TRAIN_SEQ tokens per step."""
    import math

    if len(step_ms) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"training run: {len(step_ms)} steps timed, losses {losses}")
    ms = sum(step_ms[1:]) / len(step_ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return {
        "ms_per_step": ms,
        "step_ms": step_ms,
        "tokens_per_s": tokens / (ms / 1e3),
        "mfu_6nt": 6 * n_params * tokens / (ms / 1e3) / BF16_FLOPS,
        "peak_gib": peak_bytes / 2**30,
        "params": n_params,
        "losses": losses,
    }


def phase5a_card_against_cpu(torch) -> None:
    """Two train steps of each reduced float32 config on the card and on the
    CPU from the same parameters and batches."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, synthetic_batch
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    for arch, microbatches in TRAIN_CPU_CHECK:
        cfg = dataclasses.replace(get_arch(arch).reduced(), param_dtype="float32",
                                  activation_dtype="float32")
        start = build_model(cfg).init(0, device="cpu")
        if cfg.frontend == "none":
            tokens = torch.randint(0, cfg.vocab_size, (2, 4, 64), generator=torch.Generator().manual_seed(3))
            batches = [{"tokens": tokens[i]} for i in range(2)]
        else:  # frame or patch embeddings beside (or in place of) the tokens
            batches = [synthetic_batch(cfg, 4, 64, seed=3 + i, device="cpu") for i in range(2)]
        out = {}
        for device in ("cpu", "cuda"):
            params = tree.tree_map(lambda p: p.to(device, copy=True), start)
            state = adamw.init(params)
            step = make_train_step(build_model(cfg), adamw.AdamWConfig(lr=1e-3, warmup_steps=1),
                                   microbatches)
            for batch in batches:
                params, state, metrics = step(params, state, tree.tree_map(lambda t: t.to(device), batch))
            out[device] = (metrics, params)
        (m_cpu, p_cpu), (m_gpu, p_gpu) = out["cpu"], out["cuda"]
        label = f"phase 5a: {cfg.name} f32, {microbatches} microbatch(es), 2 steps, card vs CPU"
        err = 0.0
        for key in ("loss", "grad_norm"):
            err = max(err, check_close(f"{label} {key}", m_gpu[key].cpu(), m_cpu[key], 2e-4))
        worst = 0.0
        for (path, a), b in zip(tree.leaves_with_path(p_gpu), tree.leaves(p_cpu)):
            want = b.double()
            diff = (a.cpu().double() - want).abs()
            worst = max(worst, float(diff.max()))
            if bool((diff > 2e-4 + 2e-4 * want.abs()).any()):
                raise RuntimeError(f"{label}: parameter {path} differs by {float(diff.max())}")
        print(f"  {label}: every parameter leaf within 2e-4 + 2e-4 * |want|, max |err| {worst:.3g}",
              flush=True)


def phase5b_train_cli(torch, arch: str, microbatches: int) -> dict:
    """Full-width training through the trainer's CLI, as a user runs it."""
    import contextlib

    from repro_torch.launch import train

    argv = ["--arch", arch, "--full", "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(TRAIN_STEPS), "--microbatches", str(microbatches), "--device", "cuda",
            "--log-every", "1"]
    print(f"phase 5b: python -m repro_torch.launch.train {' '.join(argv)}", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        first, last = train.main(argv)
    text = tee.text()
    steps = re.findall(r"^step\s+\d+ loss (\S+) gnorm \S+ lr \S+ (\S+) ms$", text, re.M)
    n_params = round(float(re.search(r"params=(\S+)M", text).group(1)) * 1e6)
    numbers = train_numbers([float(ms) for _, ms in steps], [float(l) for l, _ in steps] + [first, last],
                            n_params, torch.cuda.max_memory_allocated())
    numbers["microbatches"] = microbatches
    return numbers


def train_layers_config(arch: str):
    """``arch`` at full width with TRAIN_LAYERS[arch] of its layers."""
    import dataclasses

    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(arch), n_layers=TRAIN_LAYERS[arch])


def phase5b_layers(torch, arch: str) -> dict:
    """``arch`` at full width with TRAIN_LAYERS[arch] layers through
    make_train_step, on the trainer's data and optimizer settings.  For an
    MoE also mfu_6nt over the parameters active per token (top-k experts)."""
    from repro_torch import tree
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import make_train_step

    cfg = train_layers_config(arch)
    print(f"phase 5b: {depth_label(cfg)} at full width, make_train_step", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    state = adamw.init(params)
    step = make_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=TRAIN_STEPS,
                                              weight_decay=0.01))
    data = DataConfig(seed=0, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    step_ms, losses = [], []
    for i in range(TRAIN_STEPS):
        tokens = torch.from_numpy(make_batch(cfg, data, i)["tokens"]).long().cuda()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, {"tokens": tokens})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        moe = (f" moe_aux_loss {float(metrics['moe_aux_loss']):.6f} moe_drop_rate "
               f"{float(metrics['moe_drop_rate']):.6f}" if cfg.moe else "")
        print(f"  step {i} loss {losses[-1]:.6f} gnorm {float(metrics['grad_norm']):.6f}{moe} "
              f"{step_ms[-1]:.3f} ms", flush=True)
    n_params = sum(p.numel() for p in tree.leaves(params))
    numbers = train_numbers(step_ms, losses, n_params, torch.cuda.max_memory_allocated())
    numbers["microbatches"] = 1
    if cfg.moe:
        glu = 3 if cfg.mlp_act.endswith("_glu") else 2
        inactive = cfg.n_layers * (cfg.moe.num_experts - cfg.moe.top_k) * glu * cfg.d_model * cfg.d_ff
        numbers["active_params"] = n_params - inactive
        numbers["mfu_6nt_active"] = numbers["mfu_6nt"] * (n_params - inactive) / n_params
    del params, state
    return numbers


def profile_train_step(torch, cfg, microbatches: int) -> dict:
    """Where one full-width train step's time goes: the step's wall time
    (warm, after synchronize), its gradient pass (forward, remat recompute
    and backward, every microbatch) and its AdamW update timed apart, the
    torch-path forward alone (the eval step), and under torch.profiler the
    device's busy time, idle share and the kernels that take the most."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree
    from repro_torch.data import DataConfig, make_batch
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import make_eval_step, make_train_step
    from repro_torch.train import steps as train_steps

    torch.cuda.empty_cache()
    model = build_model(cfg)
    params = model.init(3, device="cuda")
    state = adamw.init(params)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS, weight_decay=0.01)
    step = make_train_step(model, opt_cfg, microbatches)
    batch = {"tokens": torch.from_numpy(
        make_batch(cfg, DataConfig(seed=3, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ), 0)["tokens"]
    ).long().cuda()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    params, state, _ = step(params, state, batch)  # warm-up
    step_ms, (params, state, _) = timed(lambda: step(params, state, batch))

    def grads_pass():
        if microbatches == 1:
            return train_steps._grads(model, params, batch)[2]
        acc = [torch.zeros(p.shape, dtype=torch.float32, device="cuda") for p in tree.leaves(params)]
        for i in range(microbatches):
            for a, g in zip(acc, train_steps._grads(
                    model, params, train_steps._microbatch(batch, microbatches, i))[2]):
                a.add_(g)
        return [a.div_(microbatches) for a in acc]

    grads_ms, grads = timed(grads_pass)
    update_ms, _ = timed(lambda: adamw.update(opt_cfg, tree.unflatten(params, grads), state, params))
    del grads
    forward_ms, _ = timed(lambda: make_eval_step(model)(params, batch))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
    by_name = device_time_by_kernel(prof)
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    del params, state
    return {
        "step_ms": step_ms,
        "grads_ms": grads_ms,
        "update_ms": update_ms,
        "forward_ms": forward_ms,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / step_ms,
        "kernel_launches": sum(1 for e in prof.events()
                               if e.device_type == torch.autograd.DeviceType.CUDA),
        "top_kernels_ms": [(name[:60], us / 1e3) for name, us in top],
    }


def pipeline_batch(torch, cfg, seed: int) -> dict:
    """Step 0's batch of the trainer's data pipeline (TRAIN_BATCH x
    TRAIN_SEQ) on the card: token ids as int64; frame or patch embeddings
    as float32, as ``launch/train.py`` moves them."""
    from repro_torch.data import DataConfig, make_batch

    out = {}
    data = DataConfig(seed=seed, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    for k, v in make_batch(cfg, data, 0).items():
        t = torch.from_numpy(v)
        out[k] = (t if t.is_floating_point() else t.long()).cuda()
    return out


def phase5c_eval(torch, cfg, counters: dict) -> dict:
    """The eval step through the kernels at full width against the torch
    paths' eval loss; returns the kernels' launch counts."""
    from repro_torch.models import build_model
    from repro_torch.train import make_eval_step

    torch.cuda.empty_cache()
    params = build_model(cfg).init(1, device="cuda")
    batch = pipeline_batch(torch, cfg, seed=1)
    for mod in counters.values():
        mod.launches = 0
    counters["flash_fwd"].tensor_core_launches = counters["flash_fwd"].tf32_launches = 0
    fast = make_eval_step(build_model(cfg, impl="kernel"))(params, batch)
    launches = {name: mod.launches for name, mod in counters.items()}
    want = expected_launches(cfg)
    if launches != want:
        raise RuntimeError(f"{cfg.name} eval: kernel launches {launches}, expected {want}")
    launches.update(flash_launches_by_kernel(counters["flash_fwd"], launches["flash_fwd"],
                                             cfg.activation_dtype, f"{cfg.name} eval"))
    plain = make_eval_step(build_model(cfg))(params, batch)
    err = check_close(f"phase 5c: {cfg.name} ({cfg.n_layers} layers) eval loss, kernels vs torch "
                      f"paths, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, launches {launches}",
                      fast["loss"].cpu().reshape(1), plain["loss"].cpu().reshape(1), 2e-2)
    print(f"    kernel eval loss {float(fast['loss']):.6f}, torch-path eval loss "
          f"{float(plain['loss']):.6f}, |diff| {err:.3g}", flush=True)
    if cfg.moe:
        print("    " + ", ".join(f"{k}: kernels {float(fast[k]):.6f} / torch paths {float(plain[k]):.6f}"
                                 for k in ("moe_aux_loss", "moe_drop_rate")), flush=True)
    del params
    return launches


def phase5d_checkpoint(torch) -> None:
    """A CheckpointManager round trip of (params, optimizer state) after one
    train step, on the card, reduced zamba2-2.7b (bf16): exact."""
    import tempfile

    from repro_torch import tree
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, synthetic_batch
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    cfg = get_arch("zamba2-2.7b").reduced()
    params = build_model(cfg).init(2, device="cuda")
    state = adamw.init(params)
    step = make_train_step(build_model(cfg), adamw.AdamWConfig(warmup_steps=1))
    params, state, _ = step(params, state, synthetic_batch(cfg, 4, 32, seed=2, device="cuda"))
    with tempfile.TemporaryDirectory() as root:
        mgr = CheckpointManager(root)
        mgr.save_async(1, (params, state)).result()
        mgr.close()
        restored_step, restored = mgr.restore(tree.tree_map(torch.zeros_like, (params, state)))
    n = 0
    for (path, a), b in zip(tree.leaves_with_path(restored), tree.leaves((params, state))):
        if a.device != b.device or a.dtype != b.dtype or not torch.equal(a, b):
            raise RuntimeError(f"phase 5d: checkpoint leaf {path} did not round-trip exactly")
        n += 1
    if restored_step != 1:
        raise RuntimeError(f"phase 5d: restored step {restored_step}")
    print(f"phase 5d: checkpoint round trip of {cfg.name} (params, AdamW state) on the card: "
          f"{n} leaves exact (dtype, device, values)", flush=True)


def phase4_profile(torch, cfg) -> None:
    """Phase 4 for one served configuration: its prompt forward through the
    kernels (as the launcher runs it: an MoE at its no-drop capacity) and
    its serving loop, under torch.profiler."""
    from repro_torch.launch.serve import no_drop_config
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    label = depth_label(cfg)
    params = build_model(cfg).init(1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = lambda n: torch.randint(0, cfg.vocab_size, (8, n), device="cuda", generator=gen)
    fwd = profile_prompt_forward(build_model(no_drop_config(cfg), impl="kernel"), params, prompt(512))
    prof = profile_serving_loop(build_model(cfg), params, prompt(PROFILE_PROMPT))
    del params
    print(f"phase 4: {label} prompt forward (kernels, 8 x 512 tokens): {fwd['wall_ms']:.3f} ms "
          f"wall, {fwd['device_busy_ms']:.3f} ms device busy, device idle share "
          f"{fwd['device_idle_share']:.3f}")
    for name, ms in fwd["top_kernels_ms"]:
        print(f"  {ms:8.4f} ms  {name}")
    print(f"phase 4: {label} serving loop, {prof['steps']} decode steps of 8 requests: "
          f"{prof['wall_ms_per_step']:.3f} ms/step wall ({prof['traced_wall_ms_per_step']:.3f} "
          f"traced), {prof['device_busy_ms_per_step']:.3f} ms/step device busy, device idle "
          f"share {prof['device_idle_share']:.3f}")
    for name, ms in prof["top_kernels_ms_per_step"]:
        print(f"  {ms:8.4f} ms/step  {name}")
    print(f"phase 4: {label}: {time.perf_counter() - t0:.1f} s wall (init, both profiles)", flush=True)


def train_label(arch: str) -> str:
    return f"{arch} ({TRAIN_LAYERS[arch]} layers)" if arch in TRAIN_LAYERS else arch


def phase5_training(torch, smi: str, counters: dict) -> dict:
    """Phase 5 (a)-(e); returns the eval steps' launch counts by path."""
    import dataclasses

    from repro_torch.configs import get_arch

    phase5a_card_against_cpu(torch)
    training = {arch: phase5b_train_cli(torch, arch, mb) for arch, mb in TRAIN_FULL_CLI}
    for arch in TRAIN_LAYERS:
        training[train_label(arch)] = phase5b_layers(torch, arch)
    print(f"phase 5b: training at full width, {TRAIN_BATCH} x {TRAIN_SEQ} tokens per step, "
          f"{TRAIN_STEPS} steps, on {smi}:")
    for name, m in training.items():
        active = (f" (mfu_6nt {m['mfu_6nt_active']:.4f} over the {m['active_params'] / 1e9:.3f} B "
                  f"parameters active per token)" if "mfu_6nt_active" in m else "")
        print(f"  {name}: {m['params'] / 1e9:.3f} B parameters, {m['microbatches']} microbatch(es): "
              f"{m['ms_per_step']:.3f} ms/step after step 0 (steps {[round(x, 3) for x in m['step_ms']]}), "
              f"{m['tokens_per_s']:.1f} tokens/s, mfu_6nt {m['mfu_6nt']:.4f}{active}, peak memory "
              f"{m['peak_gib']:.2f} GiB, losses {[round(x, 4) for x in m['losses']]}", flush=True)
    eval_cfgs = [get_arch(a) for a, _ in TRAIN_FULL_CLI] + [
        dataclasses.replace(get_arch(a), n_layers=EVAL_LAYERS.get(a, n)) for a, n in TRAIN_LAYERS.items()]
    by_path = {f"train-eval {cfg.name} ({cfg.n_layers} layers)": phase5c_eval(torch, cfg, counters)
               for cfg in eval_cfgs}
    phase5d_checkpoint(torch)
    for arch in PROFILE_TRAIN:
        name = train_label(arch)
        cfg = train_layers_config(arch) if arch in TRAIN_LAYERS else get_arch(arch)
        p = training[name]["profile"] = profile_train_step(torch, cfg, training[name]["microbatches"])
        print(f"phase 5e: {name} train step, {training[name]['microbatches']} microbatch(es), on "
              f"{smi}: {p['step_ms']:.3f} ms wall; gradient pass {p['grads_ms']:.3f} ms, AdamW "
              f"update {p['update_ms']:.3f} ms, torch-path forward alone {p['forward_ms']:.3f} ms; "
              f"device busy {p['device_busy_ms']:.3f} ms, idle share {p['device_idle_share']:.3f}, "
              f"{p['kernel_launches']} kernels", flush=True)
        for kernel, ms in p["top_kernels_ms"]:
            print(f"  {ms:10.3f} ms  {kernel}")
    print(json.dumps({"training": training, "card": smi}))
    return by_path


def node_dims(midplanes) -> tuple:
    """The node torus of a BG/Q partition of ``midplanes`` midplanes."""
    return tuple(4 * m for m in midplanes) + (2,)


def wall_s(fn):
    """(fn(), seconds on the host clock).  The network entry points return
    NumPy, so the card's work is done when ``fn`` returns."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def check_drain(label: str, card, cpu) -> float:
    """Hold a drain on the card against the CPU path: completions within
    1e-9 relative, the same steps.  Returns the largest relative gap."""
    import numpy as np

    scale = max(cpu.makespan, 1.0)
    gap = float(np.abs(card.flow_completion - cpu.flow_completion).max(initial=0.0)) / scale
    if gap > 1e-9 or card.steps != cpu.steps:
        raise RuntimeError(f"phase 6: {label}: card drain {card.makespan!r} in {card.steps} steps, "
                           f"CPU {cpu.makespan!r} in {cpu.steps} (relative gap {gap:.3e})")
    return gap


def phase6_network(smi: str, card: str = "cuda") -> dict:
    """Phase 6: the network engines' passes on ``card``, each held against
    the port's CPU path on the same inputs (seeded NumPy).  Returns the
    numbers of the ``network`` line."""
    import numpy as np

    from repro_torch import network as net
    from repro_torch.obs import DISPATCHES

    DISPATCHES.clear()
    rng = np.random.default_rng(0)
    mira = node_dims(MIDPLANE_TORI["Mira"])
    juqueen = node_dims(MIDPLANE_TORI["JUQUEEN"])
    out = {}

    # (a) DOR link loads, exact.
    def random_messages(dims, m):
        src = np.stack([rng.integers(0, a, m) for a in dims], axis=1)
        dst = np.stack([rng.integers(0, a, m) for a in dims], axis=1)
        return src, dst, rng.integers(1, 5, m).astype(np.float64)

    net.route_dor((4, 4), [[0, 0]], [[2, 1]], 1.0, device=card)  # the first call's set-up
    out["route_loads"] = []
    for label, dims, traffic in (
        ("Mira pairing", mira, net.bisection_pairing(mira)),
        ("JUQUEEN pairing", juqueen, net.bisection_pairing(juqueen)),
        ("Mira random messages", mira, random_messages(mira, NET_RANDOM_MESSAGES)),
    ):
        loads, t_card = wall_s(lambda: net.route_dor(dims, *traffic, device=card))
        ref, t_cpu = wall_s(lambda: net.route_dor(dims, *traffic, device="cpu"))
        if not np.array_equal(loads, ref):
            raise RuntimeError(f"phase 6a: {label}: link loads on the card differ from the CPU path's")
        row = {"case": label, "dims": list(dims), "messages": int(traffic[0].shape[0]),
               "max_link_load": net.max_link_load(dims, loads), "card_ms": t_card * 1e3, "cpu_ms": t_cpu * 1e3}
        out["route_loads"].append(row)
        print(f"phase 6a: route_dor {label} {dims}, {row['messages']} messages: max link load "
              f"{row['max_link_load']}, equal to the CPU path's loads; card {row['card_ms']:.3f} ms, "
              f"CPU {row['cpu_ms']:.3f} ms", flush=True)

    # (b) The paper's Table 1 and the whole machines, pairing drained.
    def pairing_drain(label, dims):
        src, dst, vol = net.bisection_pairing(dims)
        paths, t_paths = wall_s(lambda: net.dor_paths(dims, src, dst, vol))
        _, t_prep = wall_s(lambda: net.prepare_drain(paths, device=card))  # its host part, timed alone
        res, t_card = wall_s(lambda: net.simulate_flows(paths, device=card))
        ref, t_cpu = wall_s(lambda: net.simulate_flows(paths, device="cpu"))
        gap = check_drain(label, res, ref)
        row = {"case": label, "dims": list(dims), "makespan": res.makespan, "steps": res.steps,
               "subflows": paths.n_flows, "entries": int(paths.link_ids.shape[0]),
               "max_rel_gap": gap, "paths_ms": t_paths * 1e3, "prepare_drain_ms": t_prep * 1e3,
               "card_ms": t_card * 1e3, "cpu_ms": t_cpu * 1e3}
        print(f"phase 6b: {label} {dims}: makespan {res.makespan!r}, {res.steps} step(s), "
              f"{paths.n_flows} subflows, {row['entries']} entries; simulate_flows on the card "
              f"{row['card_ms']:.3f} ms (prepare_drain alone {row['prepare_drain_ms']:.3f} ms), on the "
              f"CPU {row['cpu_ms']:.3f} ms; paths on the host {row['paths_ms']:.3f} ms", flush=True)
        return row

    warm = net.dor_paths((4, 4), *net.bisection_pairing((4, 4)))
    for dev in (card, "cpu"):  # the first call's set-up
        net.simulate_flows(warm, device=dev)
    out["table1"] = []
    for mp, proposed in sorted(MIRA_PROPOSED_PARTITIONS.items()):
        current = MIRA_SCHEDULER_PARTITIONS[mp]
        cur = pairing_drain(f"Mira {mp} midplanes, current {current}", node_dims(current))
        new = pairing_drain(f"Mira {mp} midplanes, proposed {proposed}", node_dims(proposed))
        ratio = cur["makespan"] / new["makespan"]
        if abs(ratio - TABLE1_RATIOS[mp]) > 1e-9:
            raise RuntimeError(f"phase 6b: Mira {mp} midplanes: makespan ratio {ratio!r}, "
                               f"the paper's {TABLE1_RATIOS[mp]!r}")
        out["table1"].append({"midplanes": mp, "current": cur, "proposed": new, "ratio": ratio})
        print(f"phase 6b: Mira {mp} midplanes: current / proposed makespan {ratio!r}", flush=True)
    out["full_machine"] = []
    for name, dims in (("Mira", mira), ("JUQUEEN", juqueen)):
        row = pairing_drain(f"{name}, whole machine", dims)
        if abs(row["makespan"] - FULL_MACHINE_PAIRING[name]) > 1e-9 * FULL_MACHINE_PAIRING[name]:
            raise RuntimeError(f"phase 6b: {name}: makespan {row['makespan']!r}, the JAX "
                               f"package's NumPy engine {FULL_MACHINE_PAIRING[name]!r}")
        out["full_machine"].append(row)

    # (c) drain_batch at benchmarks/bench_backend.py's size.
    t_card = t_cpu = gap = 0.0
    subflows = 0
    for i, geom in enumerate(NET_BENCH_GEOMETRIES):
        src, dst, _ = net.bisection_pairing(geom)
        paths = net.dor_paths(NET_BENCH_MACHINE, src, dst, np.ones(src.shape[0]))
        vols = rng.integers(1, 3, size=(NET_BENCH_LANES, paths.n_flows)).astype(np.float64)
        subflows += paths.n_flows * NET_BENCH_LANES
        if i == 0:
            net.drain_batch(net.prepare_drain(paths, device=card), vols[:2])  # the first call's set-up
        (fc, steps), t = wall_s(lambda: net.drain_batch(net.prepare_drain(paths, device=card), vols))
        t_card += t
        lanes = np.sort(rng.choice(NET_BENCH_LANES, NET_BENCH_SAMPLED, replace=False))
        (fc_cpu, steps_cpu), t = wall_s(lambda: net.drain_batch(net.prepare_drain(paths, device="cpu"), vols[lanes]))
        t_cpu += t
        scale = np.maximum(fc_cpu.max(axis=1, keepdims=True), 1.0)
        gap = max(gap, float((np.abs(fc[lanes] - fc_cpu) / scale).max()))
        if gap > 1e-9 or not np.array_equal(steps[lanes], steps_cpu):
            raise RuntimeError(f"phase 6c: {geom}: sampled lanes on the card differ from the CPU path "
                               f"(relative gap {gap:.3e}, steps {steps[lanes]} / {steps_cpu})")
        one, one_steps = net.drain(net.prepare_drain(paths, device=card), vols[lanes[0]])
        if not np.array_equal(one, fc[lanes[0]]) or one_steps != steps[lanes[0]]:
            raise RuntimeError(f"phase 6c: {geom}: drain of lane {lanes[0]} differs from its drain_batch lane")
    scenarios = len(NET_BENCH_GEOMETRIES) * NET_BENCH_LANES
    out["drain_batch"] = {"machine": list(NET_BENCH_MACHINE), "scenarios": scenarios, "subflows": subflows,
                          "card_s": t_card, "scenarios_per_s": scenarios / t_card,
                          "cpu_sampled_lanes": len(NET_BENCH_GEOMETRIES) * NET_BENCH_SAMPLED,
                          "cpu_sampled_s": t_cpu, "max_rel_gap": gap}
    print(f"phase 6c: drain_batch, {scenarios} pairing scenarios on {NET_BENCH_MACHINE} ({subflows} "
          f"subflows): card {t_card:.3f} s, {scenarios / t_card:.1f} scenarios/s; the CPU path "
          f"{t_cpu:.3f} s for {out['drain_batch']['cpu_sampled_lanes']} sampled lanes, relative gap "
          f"{gap:.3e}, the same steps", flush=True)

    # (d) Batched candidate scoring, row-exact.
    out["score_candidates"] = []
    for dims, logical, batch in NET_SCORER:
        traffic = net.pattern_traffic(logical, "pairing")
        n_cells, n_ranks = net.volume(dims), net.volume(logical)
        cells = np.stack([rng.choice(n_cells, n_ranks, replace=False) for _ in range(batch)])
        coords = np.stack(np.unravel_index(cells, dims), axis=-1).astype(np.int64)
        net.score_candidates(dims, coords[:2], traffic, device=card)  # the first call's set-up
        (cong, dil), t_card = wall_s(lambda: net.score_candidates(dims, coords, traffic, device=card))
        (cong_c, dil_c), t_cpu = wall_s(lambda: net.score_candidates(dims, coords, traffic, device="cpu"))
        if not (np.array_equal(cong, cong_c) and np.array_equal(dil, dil_c)):
            raise RuntimeError(f"phase 6d: {dims}: candidate scores on the card differ from the CPU path's")
        row = {"dims": list(dims), "ranks": n_ranks, "messages": int(traffic[0].shape[0]),
               "candidates": batch, "congestion_range": [float(cong.min()), float(cong.max())],
               "card_ms": t_card * 1e3, "cpu_ms": t_cpu * 1e3}
        drained = [r[side] for r in out["table1"] for side in ("current", "proposed")
                   if r[side]["dims"] == list(dims)]
        if tuple(logical) == tuple(dims) and drained:
            # The identity mapping is the pairing (b) drained on this
            # partition: its congestion is the predicted makespan.
            ident = np.stack(np.unravel_index(np.arange(n_ranks), dims), axis=-1)
            row["identity_congestion"] = net.score_mapping(dims, ident, traffic, device=card).congestion
            if row["identity_congestion"] != drained[0]["makespan"]:
                raise RuntimeError(f"phase 6d: {dims}: identity mapping's congestion "
                                   f"{row['identity_congestion']!r}, drained makespan {drained[0]['makespan']!r}")
        out["score_candidates"].append(row)
        print(f"phase 6d: score_candidates, {batch} random mappings of a {n_ranks}-rank pairing job on "
              f"{dims}: congestion {row['congestion_range']}, row-exact against the CPU path; card "
              f"{row['card_ms']:.3f} ms, CPU {row['cpu_ms']:.3f} ms"
              + (f"; identity mapping {row['identity_congestion']!r}" if "identity_congestion" in row else ""),
              flush=True)

    # (e) The contention field of a 512-node job among 8 placed ones.
    tiles = tuple(a // w for a, w in zip(mira, NET_JOB))
    grid = np.zeros(mira, dtype=bool)
    for tile in rng.choice(net.volume(tiles), NET_PLACED_JOBS, replace=False):
        corner = np.unravel_index(tile, tiles)
        grid[tuple(slice(c * w, (c + 1) * w) for c, w in zip(corner, NET_JOB))] = True
    mask = net.interference_mask(grid)
    net.contention_field((4, 4), (2, 2), net.interference_mask(np.eye(4, dtype=bool)), device=card)
    field, t_card = wall_s(lambda: net.contention_field(mira, NET_JOB, mask, device=card))
    ref, t_cpu = wall_s(lambda: net.contention_field(mira, NET_JOB, mask, device="cpu"))
    err = float(np.abs(field - ref).max())
    best = [tuple(int(x) for x in np.unravel_index(np.argmin(np.round(f, 9)), mira)) for f in (field, ref)]
    if err > 1e-9 * max(1.0, float(np.abs(ref).max())) or best[0] != best[1]:
        raise RuntimeError(f"phase 6e: contention field on the card: error {err:.3e}, best offset "
                           f"{best[0]} against the CPU path's {best[1]}")
    out["contention_field"] = {"dims": list(mira), "job": list(NET_JOB), "placed_jobs": NET_PLACED_JOBS,
                               "max_field": float(ref.max()), "max_abs_err": err, "best_offset": list(best[0]),
                               "card_ms": t_card * 1e3, "cpu_ms": t_cpu * 1e3}
    print(f"phase 6e: contention_field of {NET_JOB} among {NET_PLACED_JOBS} placed jobs on {mira}: "
          f"max {float(ref.max())!r}, card against CPU {err:.3e}, best offset {best[0]} on both; card "
          f"{t_card * 1e3:.3f} ms, CPU {t_cpu * 1e3:.3f} ms", flush=True)

    # (f) Cut tables, int64 identical.
    out["cut_table"] = []
    for name, torus, unit in [(n, t, 1) for n, t in MIDPLANE_TORI.items()] + [("Mira nodes", mira, 512)]:
        t_card = t_cpu = 0.0
        rows = 0
        for mp in MIRA_SCHEDULER_PARTITIONS:
            table, t = wall_s(lambda: net.cut_table(torus, mp * unit, device=card))
            t_card += t
            ref, t = wall_s(lambda: net.cut_table(torus, mp * unit, device="cpu"))
            t_cpu += t
            if table.items() != ref.items() or table.cuts.dtype != np.int64:
                raise RuntimeError(f"phase 6f: {name} {torus}, t = {mp * unit}: cut table differs")
            rows += len(table)
            if name == "Mira":
                geom, cut = table.min_cut_geometry()
                print(f"phase 6f: Mira, {mp} midplanes: min-cut geometry {geom}, cut {cut} links "
                      f"(card)", flush=True)
        out["cut_table"].append({"torus": name, "dims": list(torus), "geometries": rows,
                                 "card_ms": t_card * 1e3, "cpu_ms": t_cpu * 1e3})
        print(f"phase 6f: cut_table on {name} {torus} at each of Mira's scheduler sizes: {rows} "
              f"geometries, int64 identical; card {t_card * 1e3:.3f} ms, CPU {t_cpu * 1e3:.3f} ms", flush=True)

    out["dispatches"] = {f"{name}/{dev}": n for (name, dev), n in sorted(DISPATCHES.items())}
    missing = [name for name in ("route_loads", "drain", "drain_batch", "score_candidates",
                                 "contention_field", "cut_scores") if not DISPATCHES[(name, card)]]
    if missing:
        raise RuntimeError(f"phase 6: no dispatch on the card of {missing}")
    print(f"phase 6: dispatches {out['dispatches']} on {smi}", flush=True)
    return out


def check_logs(label: str, card, cpu) -> None:
    """Two scheduler logs, record for record, every field."""
    import dataclasses

    def record(e):
        return (e.time, e.kind, e.seq, e.job_id, e.cells,
                None if e.request is None else dataclasses.astuple(e.request),
                None if e.placement is None else dataclasses.astuple(e.placement),
                e.priority, e.reason, e.source)

    got, want = [record(e) for e in card], [record(e) for e in cpu]
    if got != want:
        first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))
        raise RuntimeError(f"phase 7: {label}: the card's log differs from the CPU path's at record {first} "
                           f"({len(got)} / {len(want)} records)")


def queue_jobs(net) -> list:
    """(c)'s seeded stream of midplane jobs."""
    import numpy as np

    rng = np.random.default_rng(QUEUE_SEED)
    jobs, t = [], 0.0
    for i in range(QUEUE_JOBS):
        t += float(rng.exponential(2.0))
        jobs.append(net.JobRequest(i, int(rng.choice(QUEUE_SIZES)), duration=float(rng.uniform(4.0, 16.0)),
                                   arrival=t))
    return jobs


def profile_idle_share(fn) -> tuple:
    """``fn()`` (card work ending in host synchronisations) run untraced,
    then once under torch.profiler, whose kernel intervals give the
    device's busy time; the idle share divides by the untraced wall, since
    the tracer slows the host.  Returns (untraced result, numbers)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    out = fn()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    by_name = device_time_by_kernel(prof)
    busy_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return out, {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                 "device_idle_share": 1.0 - busy_us / wall_us, "kernels": len(by_name),
                 "top_kernels_ms": [(name[:60], us / 1e3) for name, us in top]}


def phase7_allocation(smi: str, card: str = "cuda") -> dict:
    """Phase 7: the allocation engines on ``card``, each case held against
    the port's CPU path on the same inputs.  Returns the numbers of the
    ``allocation`` line."""
    import numpy as np

    from repro_torch import network as net
    from repro_torch.core import bgq
    from repro_torch.network import backend
    from repro_torch.obs import DISPATCHES

    DISPATCHES.clear()
    out = {}

    # (a) The partition advisor, Mira's scheduler table and JUQUEEN's worst geometries.
    juqueen = bgq.JUQUEEN
    tables = {"Mira": (MIDPLANE_TORI["Mira"], MIRA_SCHEDULER_PARTITIONS),
              "JUQUEEN": (MIDPLANE_TORI["JUQUEEN"],
                          {mp: juqueen.worst_partition(mp)[0] for mp in juqueen.partition_sizes()})}
    out["advisor"] = []
    for name, (dims, table) in tables.items():
        small = [s for s in sorted(table) if s * net.volume(MIDPLANE_NODES) <= ADVISOR_SIMULATE_NODES]
        rows = {}
        for simulate, sizes in ((True, small), (False, [s for s in sorted(table) if s not in small])):
            got, t_card = wall_s(lambda: net.advise_policy_table(
                dims, table, unit_node_dims=MIDPLANE_NODES, simulate=simulate, sizes=sizes, device=card))
            want, t_cpu = wall_s(lambda: net.advise_policy_table(
                dims, table, unit_node_dims=MIDPLANE_NODES, simulate=simulate, sizes=sizes, device="cpu"))
            for a, b in zip(got, want):
                if a != b:
                    raise RuntimeError(f"phase 7a: {name} {a.units} midplanes: card {a} against CPU {b}")
                if simulate and a.simulated_speedup != a.predicted_speedup:
                    raise RuntimeError(f"phase 7a: {name} {a.units} midplanes: drained {a.simulated_speedup!r}, "
                                       f"predicted {a.predicted_speedup!r}")
                rows[a.units] = {"midplanes": a.units, "current": list(a.current_geometry),
                                 "optimal": list(a.optimal_geometry), "predicted_speedup": a.predicted_speedup,
                                 "simulated_speedup": a.simulated_speedup, "certified": a.certified}
            out.setdefault("advisor_s", {})[f"{name} simulate={simulate}"] = {"card_s": t_card, "cpu_s": t_cpu}
        for s, row in sorted(rows.items()):
            ratio, t_card = wall_s(lambda: net.avoidable_contention_ratio(dims, s, MIDPLANE_NODES, device=card))
            if ratio != net.avoidable_contention_ratio(dims, s, MIDPLANE_NODES, device="cpu"):
                raise RuntimeError(f"phase 7a: {name} {s} midplanes: avoidable contention differs")
            row["avoidable_contention_ratio"] = ratio
            print(f"phase 7a: {name} {s} midplanes: current {tuple(row['current'])} -> optimal "
                  f"{tuple(row['optimal'])}, predicted speedup {row['predicted_speedup']!r}"
                  + (f", drained {row['simulated_speedup']!r}" if row["simulated_speedup"] is not None else "")
                  + f"; avoidable contention ratio {ratio!r}", flush=True)
        if name == "Mira":
            for mp, want in TABLE1_RATIOS.items():
                if rows[mp]["predicted_speedup"] != want:
                    raise RuntimeError(f"phase 7a: Mira {mp} midplanes: speedup {rows[mp]['predicted_speedup']!r}, "
                                       f"the paper's {want!r}")
        out["advisor"].append({"machine": name, "dims": list(dims), "rows": list(rows.values())})
    print(f"phase 7a: advisor wall times (card / CPU): {out['advisor_s']}", flush=True)

    # (b) The 32^3 scenario under the contention-scored policy.
    sc = SCHEDULER_SCENARIO
    scenario = net.generate_scenario(sc["machine"], sc["jobs"], seed=sc["seed"], burst_gap=sc["burst_gap"],
                                     mean_duration=sc["mean_duration"], failure_rate=sc["failure_rate"],
                                     repair_delay=sc["repair_delay"])

    def scenario_run(dev):
        return net.scheduler_throughput(scenario, net.ContentionScoredPolicy(), backfill=True, device=dev)

    svc, eps_card_cold = scenario_run(card)  # the first run fills the per-device caches
    (svc_warm, eps_card), prof = profile_idle_share(lambda: scenario_run(card))
    svc_cpu, eps_cpu = scenario_run("cpu")
    out["services"] = (svc, svc_cpu)  # phase 10c derives their metrics; main drops them from the JSON
    check_logs("the 32^3 scenario", svc.log, svc_cpu.log)
    check_logs("the 32^3 scenario, warm", svc_warm.log, svc_cpu.log)
    jobs = svc.result().jobs
    out["scenario"] = {"machine": list(sc["machine"]), "jobs": sc["jobs"], "events": svc.events_processed,
                       "scheduled": len(jobs), "rejected": len(svc.rejected),
                       "mean_contention": svc.result().mean_contention,
                       "events_per_s_card_cold": eps_card_cold, "events_per_s_card": eps_card,
                       "events_per_s_cpu": eps_cpu, "profile": prof}
    print(f"phase 7b: {sc['jobs']} jobs on {sc['machine']}, contention-scored with backfill: "
          f"{svc.events_processed} events, {len(jobs)} scheduled, the card's log equal to the CPU path's; "
          f"events/s card {eps_card:.1f} (first run {eps_card_cold:.1f}), CPU {eps_cpu:.1f}; device busy "
          f"{prof['device_busy_ms']:.3f} of {prof['wall_ms']:.3f} ms, idle share "
          f"{prof['device_idle_share']:.4f}; top {prof['top_kernels_ms'][:3]}", flush=True)

    # (c) The paper's comparison: three policies on Mira with simulated contention.
    out["queue"] = []
    policies = [("list", lambda: net.ListPolicy(MIRA_SCHEDULER_PARTITIONS)),
                ("isoperimetric", net.IsoperimetricPolicy), ("contention-scored", net.ContentionScoredPolicy)]
    for label, make in policies:
        runs = {}
        for dev in (card, "cpu"):
            runs[dev] = wall_s(lambda: net.simulate_queue(
                MIDPLANE_TORI["Mira"], queue_jobs(net), make(), MIDPLANE_NODES,
                contention="simulated", mapping_pattern="halo", device=dev))
        (res, t_card), (ref, t_cpu) = runs[card], runs["cpu"]
        for a, b in zip(res.jobs, ref.jobs):
            same = (a.placement == b.placement and (a.start, a.end) == (b.start, b.end)
                    and a.comm_lower_bound == b.comm_lower_bound and a.mapping.strategy == b.mapping.strategy
                    and abs(a.simulated_comm_time - b.simulated_comm_time) <= 1e-9 * max(1.0, b.simulated_comm_time))
            if not same:
                raise RuntimeError(f"phase 7c: {label}: job {a.request.job_id} differs on the card: {a} / {b}")
        if len(res.jobs) != len(ref.jobs) or res.rejected != ref.rejected:
            raise RuntimeError(f"phase 7c: {label}: the card scheduled {len(res.jobs)}, the CPU {len(ref.jobs)}")
        row = {"policy": label, "jobs": len(res.jobs), "rejected": len(res.rejected),
               "mean_simulated_slowdown": res.mean_simulated_slowdown,
               "mean_bisection_efficiency": res.mean_bisection_efficiency, "makespan": res.makespan,
               "mean_wait": res.mean_wait, "mean_contention": res.mean_contention,
               "card_s": t_card, "cpu_s": t_cpu}
        out["queue"].append(row)
        print(f"phase 7c: Mira {MIDPLANE_TORI['Mira']}, {QUEUE_JOBS} jobs, {label}: mean simulated slowdown "
              f"{row['mean_simulated_slowdown']!r}, mean bisection efficiency {row['mean_bisection_efficiency']!r}, "
              f"makespan {row['makespan']!r}, rejected {row['rejected']}; the same schedule on both; card "
              f"{t_card:.3f} s, CPU {t_cpu:.3f} s", flush=True)

    # (d) The mapping catalogue of a 8192-rank halo job, chunked on the card.
    # The CPU path re-scores the card's winner and identity mapping there,
    # and runs the whole catalogue of the smaller MAP_JOB_CPU on both.
    dims, job = MAP_JOB
    mapped, t_card = wall_s(lambda: net.map_ranks(dims, job, (0,) * len(dims), pattern="halo", device=card))
    rescored = [net.score_mapping(dims, coords, mapped.rank_traffic, device="cpu")
                for coords in (mapped.coords, net.identity_mapping(dims, job, (0,) * len(dims)))]
    if rescored != [mapped.score, mapped.identity_score]:
        raise RuntimeError(f"phase 7d: card {mapped.score} / {mapped.identity_score}, CPU re-scored {rescored}")
    small = {dev: wall_s(lambda: net.map_ranks(dims, MAP_JOB_CPU, (0,) * len(dims), pattern="halo", device=dev))
             for dev in (card, "cpu")}
    (got, t_small), (ref, t_cpu) = small[card], small["cpu"]
    if (got.strategy, got.score) != (ref.strategy, ref.score) or not np.array_equal(got.coords, ref.coords):
        raise RuntimeError(f"phase 7d: {MAP_JOB_CPU}: card {got.strategy} {got.score}, CPU {ref.strategy} {ref.score}")
    messages = int(mapped.rank_traffic[0].shape[0])
    catalogue = sum(1 for _ in net.axis_permutation_orders(job)) + 1  # the orders (identity among them), the snake
    chunk = backend.score_chunk(dims, messages)
    out["map_ranks"] = {"dims": list(dims), "job": list(job), "ranks": mapped.num_ranks, "messages": messages,
                        "candidates": catalogue, "chunk": chunk, "strategy": mapped.strategy,
                        "congestion": mapped.score.congestion, "dilation": mapped.score.dilation,
                        "identity_congestion": mapped.identity_score.congestion, "card_s": t_card,
                        "cpu_check_job": list(MAP_JOB_CPU), "cpu_check_card_s": t_small, "cpu_s": t_cpu}
    print(f"phase 7d: map_ranks of a {job} halo job ({mapped.num_ranks} ranks, {messages} messages) on {dims}: "
          f"{catalogue} candidates in chunks of {chunk}; {mapped.strategy}, congestion {mapped.score.congestion!r}, "
          f"dilation {mapped.score.dilation!r}, re-scored on the CPU path; card {t_card:.3f} s.  The {MAP_JOB_CPU} "
          f"job's whole catalogue: {got.strategy} {got.score}, the same on both; card {t_small:.3f} s, CPU "
          f"{t_cpu:.3f} s", flush=True)

    out["dispatches"] = {f"{name}/{dev}": n for (name, dev), n in sorted(DISPATCHES.items())}
    missing = [name for name in ("cut_scores", "first_fit", "placement_search", "contention_field",
                                 "score_candidates", "route_loads", "drain") if not DISPATCHES[(name, card)]]
    if missing:
        raise RuntimeError(f"phase 7: no dispatch on the card of {missing}")
    print(f"phase 7: dispatches {out['dispatches']} on {smi}", flush=True)
    return out


def plan_rows(plan) -> list:
    """A plan's ranked rows, each ``PlanCandidate.row()`` with its drained
    slowdown."""
    return [c.row() + (c.simulated_slowdown,) for c in plan.table]


def phase8_planner(smi: str, card: str = "cuda") -> dict:
    """Phase 8: the fleet planner on ``card`` against the port's CPU path,
    and ``--plan-chips`` through both launchers.  Returns the numbers of
    the ``planner`` line."""
    from repro_torch.core import bgq
    from repro_torch.launch import planner, serve, train
    from repro_torch.network import advise_partition
    from repro_torch.obs import DISPATCHES, TRACER

    DISPATCHES.clear()
    kw = dict(pod=planner.bgq_pod("mira"), shape="train_4k", wrap_mode="torus", unit_node_dims=bgq.MIDPLANE_DIMS)
    advice = advise_partition(MIDPLANE_TORI["Mira"], PLAN_MIDPLANES, (2, 2, 2, 2), unit_node_dims=MIDPLANE_NODES,
                              device=card)
    if advice.optimal_geometry != (2, 2, 2, 2) or advice.current_bisection != advice.optimal_bisection:
        raise RuntimeError(f"phase 8: advise_partition's optimum on Mira at 16 midplanes is {advice}")
    out = {"pod": "mira", "midplanes": PLAN_MIDPLANES, "shape": "train_4k", "plans": []}
    for arch in PLAN_ARCHS:
        def plan(dev):
            return planner.plan_model(arch, PLAN_MIDPLANES, device=dev, **kw)

        got, prof = profile_idle_share(lambda: plan(card))
        want, t_cpu = wall_s(lambda: plan("cpu"))
        TRACER.enable(clear=True)
        try:
            traced = plan(card)
            spans = sum(1 for e in TRACER.events() if e["name"] == "planner.price")
        finally:
            TRACER.disable()
            TRACER.clear()
        if plan_rows(got) != plan_rows(want) or plan_rows(traced) != plan_rows(want):
            raise RuntimeError(f"phase 8: {arch}: the card's rows differ from the CPU path's")
        best, worst = got.table[0], got.table[-1]
        ratio = worst.step_time / best.step_time
        summary = (got.geometry, best.axis_sizes, got.bisection_efficiency, len(got.table))
        if summary != H100_MIRA_PLANS[arch]:
            raise RuntimeError(f"phase 8: {arch}: (geometry, axes, bisection efficiency, rows) {summary}, "
                               f"expected {H100_MIRA_PLANS[arch]}")
        fsdp16 = next(c for c in got.table if c.axis_sizes == (1, 16, 1, 1))
        if fsdp16.geometry != advice.optimal_geometry or fsdp16.bisection_efficiency != 1.0:
            raise RuntimeError(f"phase 8: {arch}: fsdp over 16 midplanes ranks {fsdp16.geometry} first")
        if ratio < AVOIDABLE_FLOOR:
            raise RuntimeError(f"phase 8: {arch}: worst / best step time {ratio!r} < {AVOIDABLE_FLOOR}")
        row = {"arch": arch, "geometry": list(got.geometry), "axes": list(best.axis_sizes),
               "mapping": best.mapping_strategy, "bisection_efficiency": got.bisection_efficiency,
               "rows": len(got.table), "step_s": best.step_time, "comm_s": best.comm_time,
               "compute_s": best.compute_time, "memory_s": best.memory_time, "worst_over_best": ratio,
               "fsdp16_step_s": fsdp16.step_time, "price_spans": spans, "card_s": prof["wall_ms"] / 1e3,
               "cpu_s": t_cpu, "profile": prof}
        out["plans"].append(row)
        print(planner.format_table(got))
        print(f"phase 8: {arch} on Mira, {PLAN_MIDPLANES} midplanes, train_4k, H100 profile: {got.geometry} "
              f"{best.axis_sizes} {best.mapping_strategy}, bisection efficiency {got.bisection_efficiency!r}, "
              f"step {best.step_time!r} s, comm {best.comm_time!r} s, worst / best {ratio!r}, {len(got.table)} "
              f"rows equal on the card and the CPU; fsdp 16 ranks {fsdp16.geometry} first at "
              f"{fsdp16.step_time!r} s; {spans} planner.price spans; card {prof['wall_ms'] / 1e3:.3f} s "
              f"(device busy {prof['device_busy_ms']:.3f} ms, idle share {prof['device_idle_share']:.4f}, "
              f"{prof['kernels']} kernel names), CPU {t_cpu:.3f} s", flush=True)

    # the launchers: --plan-chips prints the table and returns the plan, building no model
    out["cli"] = {}
    for name, module, shape in (("serve", serve, "decode_32k"), ("train", train, "train_4k")):
        argv = ["--arch", PLAN_ARCHS[0], "--plan-chips", str(PLAN_MIDPLANES), "--plan-pod", "mira"]
        plan, t_card = wall_s(lambda: module.main(argv + ["--device", card]))
        ref = planner.plan_model(PLAN_ARCHS[0], PLAN_MIDPLANES, simulate_top_k=1, device="cpu",
                                 **dict(kw, shape=shape))
        drained, want = plan.best.simulated_slowdown, ref.best.simulated_slowdown
        if (plan.shape != shape or [c.row() for c in plan.table] != [c.row() for c in ref.table]
                or drained < 1.0 or abs(drained - want) > 1e-9 * want):
            raise RuntimeError(f"phase 8: {name} --plan-chips: {plan.shape} plan differs from the CPU path's")
        out["cli"][name] = {"shape": shape, "geometry": list(plan.geometry), "axes": list(plan.best.axis_sizes),
                            "step_s": plan.step_time, "simulated_slowdown": plan.best.simulated_slowdown,
                            "card_s": t_card}
        print(f"phase 8: {name}.main --plan-chips {PLAN_MIDPLANES} --plan-pod mira: {shape} {plan.geometry} "
              f"{plan.best.axis_sizes}, drained slowdown {plan.best.simulated_slowdown!r}, {t_card:.3f} s",
              flush=True)

    out["dispatches"] = {f"{name}/{dev}": n for (name, dev), n in sorted(DISPATCHES.items())}
    missing = [name for name in ("cut_scores", "score_candidates", "drain") if not DISPATCHES[(name, card)]]
    if missing:
        raise RuntimeError(f"phase 8: no dispatch on the card of {missing}")
    print(f"phase 8: dispatches {out['dispatches']} on {smi}", flush=True)
    return out


def phase9a_strassen(torch, smi: str) -> dict:
    """Phase 9a: Strassen-Winograd (the paper's Experiment B kernel) at
    ``STRASSEN_N`` in float32 without TF32, each depth against a float64
    product on the card and timed beside ``torch.matmul``; then the CAPS
    model on Mira's four cells."""
    from repro_torch.core.strassen import caps_comm_model, mira_caps_cells, strassen_flops, strassen_winograd

    n = STRASSEN_N
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(n, n, generator=gen, device="cuda")
    b = torch.randn(n, n, generator=gen, device="cuda")
    ref = a.double() @ b.double()
    scale = float(ref.abs().max())
    matmul_ms = cuda_ms(lambda: a @ b, iters=STRASSEN_ITERS, warmup=1)
    io_bytes = 3 * n * n * 4  # a, b read once, c written once
    out = {"n": n, "dtype": "float32", "tf32": False, "matmul_ms": matmul_ms, "depths": []}
    for depth in STRASSEN_DEPTHS:
        got = strassen_winograd(a, b, depth)
        err = float((got.double() - ref).abs().max()) / scale
        del got
        if not err < 1e-4:
            raise RuntimeError(f"phase 9a: Strassen depth {depth}: relative error {err:.3e} >= 1e-4")
        ms = cuda_ms(lambda: strassen_winograd(a, b, depth), iters=STRASSEN_ITERS, warmup=1)
        flops = strassen_flops(n, depth)
        bound_ms = max(flops / F32_FLOPS_PER_S, io_bytes / HBM_BYTES_PER_S) * 1e3
        row = {"depth": depth, "rel_err": err, "ms": ms, "flops": flops, "bound_ms": bound_ms,
               "bound_by": "operations" if flops / F32_FLOPS_PER_S > io_bytes / HBM_BYTES_PER_S else "bytes"}
        out["depths"].append(row)
        print(f"phase 9a: Strassen-Winograd n={n} depth {depth}: {ms:.3f} ms (torch.matmul {matmul_ms:.3f} ms), "
              f"{flops:.4e} FLOPs, bound {bound_ms:.3f} ms at the float32 rate, rel err {err:.3e} on {smi}",
              flush=True)
    del ref, a, b
    torch.cuda.empty_cache()
    preds = caps_comm_model(mira_caps_cells(), phi=0.45, comm_over_comp=0.5)
    for p in preds[:3]:  # the x2-bisection cells
        if not (1.37 <= p.comm_ratio <= 1.52 and 1.08 <= p.wallclock_ratio <= 1.22):
            raise RuntimeError(f"phase 9a: CAPS prediction {p} outside the paper's bands")
    out["caps"] = [dataclasses.asdict(p) for p in preds]
    for p in preds:
        print(f"phase 9a: CAPS on Mira, {p.midplanes} midplanes: bisection x{p.bisection_ratio:.3f}, "
              f"comm x{p.comm_ratio:.3f}, wallclock x{p.wallclock_ratio:.3f}", flush=True)
    return out


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase9b_ring(torch) -> dict:
    """Phase 9b: the collective-matmul rings on a one-rank NCCL group,
    against ``x @ w``, with no gather or scatter traced."""
    import torch.distributed as dist

    from repro_torch.analysis.roofline import CollectiveTrace
    from repro_torch.distributed.collective_matmul import allgather_matmul, matmul_reducescatter

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        gen = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(RING_SHAPE[0], RING_SHAPE[1], generator=gen, device="cuda")
        w = torch.randn(RING_SHAPE[1], RING_SHAPE[2], generator=gen, device="cuda")
        want = x @ w
        with CollectiveTrace() as trace:
            gathered = allgather_matmul(x, w)
            scattered = matmul_reducescatter(x, w)
        out = {"shape": RING_SHAPE, "backend": dist.get_backend(), "ranks": dist.get_world_size()}
        for label, got in (("allgather_matmul", gathered), ("matmul_reducescatter", scattered)):
            rel = float((got - want).abs().max() / want.abs().max())
            if got.shape != want.shape or not rel < 1e-5:
                raise RuntimeError(f"phase 9b: {label}: shape {tuple(got.shape)}, relative error {rel:.3e}")
            out[label] = {"rel_err": rel}
        stats = trace.stats()
        if stats["all-gather"]["count"] or stats["reduce-scatter"]["count"]:
            raise RuntimeError(f"phase 9b: the ring traced a gather or scatter: {stats}")
        out["traced"] = stats
    finally:
        dist.destroy_process_group()
    print(f"phase 9b: rings on a one-rank {out['backend']} group at {RING_SHAPE}: "
          f"allgather_matmul {out['allgather_matmul']['rel_err']:.3e}, "
          f"matmul_reducescatter {out['matmul_reducescatter']['rel_err']:.3e}; traced {out['traced']}", flush=True)
    return out


def phase9c_dryrun(torch, smi: str) -> dict:
    """Phase 9c: the dry-run CLI in a child process per cell (a process
    holds one fake process group); the CLI fails a cell whose local shards
    do not hold its specs' state bytes or whose peak does not fit the
    card, and each record is held to the specs' bytes again here."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.dryrun import RESULTS_DIR, cell_state_bytes
    from repro_torch.launch.mesh import production_mesh_shape

    env = {**__import__("os").environ, "PYTHONPATH": str(REPO / "src")}
    torch.cuda.empty_cache()  # the card's memory to the children

    def run(cell):
        arch_name, shape_name, mesh_kind = cell
        t0 = time.perf_counter()
        uncalibrated = (arch_name, shape_name, mesh_kind) in DRYRUN_UNCALIBRATED
        subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch_name,
                        "--shape", shape_name, "--mesh", mesh_kind, "--link-bw", repr(DRYRUN_LINK_BW),
                        "--force", "--device", "cuda"] + ["--skip-calibration"] * uncalibrated,
                       check=True, env=env, cwd=REPO)
        wall = time.perf_counter() - t0
        rec = json.loads((RESULTS_DIR / f"{arch_name}__{shape_name}__{mesh_kind}.json").read_text())
        rules = ShardingRules(get_arch(arch_name), production_mesh_shape(mesh_kind == "multi"))
        want, _ = cell_state_bytes(get_arch(arch_name), SHAPES[shape_name], rules)
        peak = rec["memory_analysis"]["peak_allocated_bytes"]
        built = rec["memory_analysis"]["shard_bytes_allocated"]
        if not rec["ok"] or rec["bytes_per_device"] != want or built != want:
            raise RuntimeError(f"phase 9c: {arch_name} x {shape_name} x {mesh_kind}: state bytes "
                               f"{rec['bytes_per_device']}, local shards built {built}, specs {want}; "
                               f"checks {rec['checks']}")
        row = {key: rec[key] for key in ("arch", "shape", "mesh", "chips", "compute_term", "memory_term",
                                         "collective_term", "bottleneck", "collective_bytes",
                                         "per_axis_collectives", "lower_seconds", "compile_seconds",
                                         "memory_analysis", "view_replications", "link_bw")}
        row["wall_s"] = wall
        print(f"phase 9c: {arch_name} x {shape_name} x {mesh_kind} ({rec['chips']} fake ranks): "
              f"compute {rec['compute_term']:.4e} s, memory {rec['memory_term']:.4e} s, collective "
              f"{rec['collective_term']:.4e} s at {DRYRUN_LINK_BW:.3e} B/s, bottleneck {rec['bottleneck']}; "
              f"per axis {json.dumps(rec['per_axis_collectives'])}; run {rec['lower_seconds']} s, "
              f"calibration {rec['compile_seconds']} s, child {wall:.1f} s; state {want:.0f} B, "
              f"peak allocated {peak} B on {smi}; view replications {json.dumps(rec['view_replications'])}, "
              f"\"model\" bytes {rec['per_axis_collectives'].get('model', {}).get('bytes', 0.0):.4e}", flush=True)
        return row

    rows = {}
    with ThreadPoolExecutor(max_workers=len(DRYRUN_LANES)) as pool:
        for lane, done in zip(DRYRUN_LANES, pool.map(lambda lane: [run(DRYRUN_CELLS[i]) for i in lane],
                                                     DRYRUN_LANES)):
            rows.update(zip(lane, done))
    assert sorted(rows) == list(range(len(DRYRUN_CELLS)))
    return {"cells": [rows[i] for i in range(len(DRYRUN_CELLS))]}


def phase9_distributed(torch, smi: str) -> dict:
    """Phase 9: Strassen-Winograd and CAPS, the collective-matmul rings, and
    the dry-run of the production meshes."""
    return {"strassen": phase9a_strassen(torch, smi), "ring": phase9b_ring(torch),
            "dryrun": phase9c_dryrun(torch, smi)}


def phase10_routing(card: str = "cuda") -> dict:
    """Phase 10a: compare_routing on Mira's current and proposed partitions
    at node level, pairing and a hotspot line, on the card and the CPU path:
    equal adaptive paths, drained makespans within 1e-9 relative."""
    import numpy as np

    from repro_torch import network as net

    rows = []
    for mp in ROUTING_MIDPLANES:
        for side, geom in (("current", MIRA_SCHEDULER_PARTITIONS[mp]), ("proposed", MIRA_PROPOSED_PARTITIONS[mp])):
            dims = node_dims(geom)
            for pattern, traffic in (("pairing", net.bisection_pairing(dims)), ("hotspot_line", net.hotspot_line(dims))):
                cmp, t_card = wall_s(lambda: net.compare_routing(dims, traffic, device=card))
                ref, t_cpu = wall_s(lambda: net.compare_routing(dims, traffic, device="cpu"))
                a = net.adaptive_paths(dims, *traffic, device=card)
                b = net.adaptive_paths(dims, *traffic, device="cpu")
                if not (np.array_equal(a.link_ids, b.link_ids) and np.array_equal(a.flow_ids, b.flow_ids)):
                    raise RuntimeError(f"phase 10a: {dims} {pattern}: adaptive paths on the card differ")
                for x, y in ((cmp.dor_makespan, ref.dor_makespan), (cmp.adaptive_makespan, ref.adaptive_makespan)):
                    if abs(x - y) > 1e-9 * max(1.0, y):
                        raise RuntimeError(f"phase 10a: {dims} {pattern}: card {cmp}, CPU {ref}")
                if pattern == "pairing" and cmp.recovered_fraction != 0.0:
                    raise RuntimeError(f"phase 10a: {dims}: pairing recovered {cmp.recovered_fraction!r}, not 0.0")
                if pattern == "hotspot_line" and not cmp.recovered_fraction > 0.0:
                    raise RuntimeError(f"phase 10a: {dims}: the hotspot line recovered nothing")
                row = {"midplanes": mp, "side": side, "dims": list(dims), "pattern": pattern,
                       "subflows": a.n_flows, "entries": int(a.link_ids.shape[0]),
                       "dor_makespan": cmp.dor_makespan, "adaptive_makespan": cmp.adaptive_makespan,
                       "recovered_fraction": cmp.recovered_fraction, "card_s": t_card, "cpu_s": t_cpu}
                rows.append(row)
                print(f"phase 10a: Mira {mp} midplanes, {side} {dims}, {pattern}: DOR {cmp.dor_makespan!r}, "
                      f"adaptive {cmp.adaptive_makespan!r}, recovered fraction {cmp.recovered_fraction!r}; "
                      f"{a.n_flows} subflows, paths equal on both; compare_routing card {t_card:.3f} s, "
                      f"CPU {t_cpu:.3f} s", flush=True)
    return {"compare_routing": rows}


def phase10_timeline(card: str = "cuda") -> dict:
    """Phase 10b: the utilization timeline of phase 6b's Mira 8-midplane
    pairing drain and of its hotspot line under the adaptive router."""
    import numpy as np

    from repro_torch import network as net

    dims = node_dims(MIRA_SCHEDULER_PARTITIONS[8])
    rows = []
    for label, paths in (("pairing, DOR", net.dor_paths(dims, *net.bisection_pairing(dims))),
                         ("hotspot line, adaptive", net.adaptive_paths(dims, *net.hotspot_line(dims), device="cpu"))):
        res, t_card = wall_s(lambda: net.simulate_flows(paths, record_utilization=True, device=card))
        ref, t_cpu = wall_s(lambda: net.simulate_flows(paths, record_utilization=True, device="cpu"))
        if res.steps != ref.steps or len(res.timeline) != res.steps or \
                [u.active_flows for u in res.timeline] != [u.active_flows for u in ref.timeline]:
            raise RuntimeError(f"phase 10b: {label}: {res.steps} / {ref.steps} steps or active counts differ")
        gap = 0.0
        for u, v in zip(res.timeline, ref.timeline):
            got = np.concatenate([[u.start, u.end, u.max_utilization, u.mean_utilization], u.utilization.ravel()])
            want = np.concatenate([[v.start, v.end, v.max_utilization, v.mean_utilization], v.utilization.ravel()])
            gap = max(gap, float((np.abs(got - want) / np.maximum(np.abs(want), 1e-300)).max(initial=0.0)))
        if gap > 1e-9:
            raise RuntimeError(f"phase 10b: {label}: timeline samples differ by {gap:.3e} relative")
        row = {"case": label, "dims": list(dims), "steps": res.steps, "makespan": res.makespan,
               "max_utilization": [u.max_utilization for u in res.timeline],
               "mean_utilization": [u.mean_utilization for u in res.timeline],
               "active_flows": [u.active_flows for u in res.timeline], "max_rel_gap": gap,
               "card_s": t_card, "cpu_s": t_cpu}
        rows.append(row)
        print(f"phase 10b: timeline of {label} on {dims}: {res.steps} step(s), max utilization "
              f"{row['max_utilization']}, active flows {row['active_flows']}, card against CPU {gap:.3e}; "
              f"card {t_card:.3f} s, CPU {t_cpu:.3f} s", flush=True)
    return {"timeline": rows}


def spill_report(dev: str):
    """The contention report of SPILL_JOBS on SPILL_MACHINE, on ``dev``."""
    from repro_torch import network as net
    from repro_torch import obs

    m = net.MachineState(SPILL_MACHINE, device=dev)
    for jid, oriented, offset in SPILL_JOBS:
        m.commit(jid, tuple(sorted(oriented, reverse=True)), oriented, offset)
    return obs.attribute_contention(m, top_hotspots=8)


def phase10_telemetry(card: str = "cuda", scenario_runs=None) -> dict:
    """Phase 10c: contention attribution and its dashboard on a 32^3
    machine holding spilling jobs, and ``scheduler_metrics`` of phase 7b's
    card log against the CPU log's and a replay's (``scenario_runs``; run
    here when phase 7 did not)."""
    from repro_torch import network as net
    from repro_torch import obs

    reports = {}
    times = {}
    for dev in (card, "cpu"):
        reports[dev], times[dev] = wall_s(lambda: spill_report(dev))
    rep, ref = reports[card], reports["cpu"]
    same = ([dataclasses.astuple(j) for j in rep.jobs] == [dataclasses.astuple(j) for j in ref.jobs]
            and rep.max_link_load == ref.max_link_load and rep.cross_load == ref.cross_load
            and [(h.dim, h.direction, h.cell, h.load) for h in rep.hotspots]
            == [(h.dim, h.direction, h.cell, h.load) for h in ref.hotspots]
            and abs(rep.total_load - ref.total_load) <= 1e-12 * ref.total_load)
    if not same:
        raise RuntimeError("phase 10c: the attribution on the card differs from the CPU path's")
    spilling = [j.job_id for j in rep.jobs if j.cross_load > 0.0]
    if rep.cross_load <= 0.0 or not spilling:
        raise RuntimeError("phase 10c: no cross traffic on the 32^3 machine")
    print(obs.render_dashboard(rep), flush=True)
    if obs.render_dashboard(rep) != obs.render_dashboard(ref):
        raise RuntimeError("phase 10c: the dashboards differ")
    print(f"phase 10c: attribution of {len(rep.jobs)} jobs on {SPILL_MACHINE}: cross load {rep.cross_load!r} "
          f"(jobs {spilling}), total {rep.total_load!r}, peak {rep.max_link_load!r}, the same on both; card "
          f"{times[card]:.3f} s, CPU {times['cpu']:.3f} s", flush=True)

    if scenario_runs is None:
        sc = SCHEDULER_SCENARIO
        scenario = net.generate_scenario(sc["machine"], sc["jobs"], seed=sc["seed"], burst_gap=sc["burst_gap"],
                                         mean_duration=sc["mean_duration"], failure_rate=sc["failure_rate"],
                                         repair_delay=sc["repair_delay"])
        scenario_runs = tuple(net.run_scenario(scenario, net.ContentionScoredPolicy(), backfill=True, device=dev)
                              for dev in (card, "cpu"))
    svc, svc_cpu = scenario_runs
    replayed, t_replay = wall_s(lambda: net.replay_events(svc.machine.dims, net.ContentionScoredPolicy(), svc.log,
                                                          backfill=True, device=card))
    snaps = [obs.scheduler_metrics(s).snapshot() for s in (svc, svc_cpu, replayed)]
    if not snaps[0] == snaps[1] == snaps[2]:
        raise RuntimeError("phase 10c: scheduler_metrics of the card's log, the CPU's and the replay differ")
    gauges = snaps[0]["gauges"]
    print(f"phase 10c: scheduler_metrics of phase 7b's log ({len(svc.log)} records): utilization "
          f"{gauges['scheduler.utilization']!r}, queue depth max {gauges['scheduler.queue_depth_max']!r}; equal "
          f"on the card, the CPU path and the card's replay ({t_replay:.3f} s)", flush=True)
    return {"attribution": rep.to_dict(), "spilling_jobs": spilling, "card_s": times[card],
            "cpu_s": times["cpu"], "metrics_records": len(svc.log), "replay_s": t_replay,
            "utilization": gauges["scheduler.utilization"]}


def phase10_hyperx(card: str = "cuda") -> dict:
    """Phase 10d: HyperX routing, routing comparison, the advisor, a queue
    and the planner on the card against the CPU path."""
    import numpy as np

    from repro_torch import network as net
    from repro_torch.launch import planner

    out = {}
    hx = net.HyperXFabric(HX_ROUTE, link_bw=1.0)
    a2a = net.all_to_all(HX_ROUTE)
    out["route_hyperx"] = []
    for mode in ("minimal", "dal"):
        loads, t_card = wall_s(lambda: net.route_hyperx(hx, *a2a, mode=mode, device=card))
        ref, t_cpu = wall_s(lambda: net.route_hyperx(hx, *a2a, mode=mode, device="cpu"))
        gap = float((np.abs(loads - ref) / np.maximum(ref, 1e-300)).max())
        if (mode == "minimal" and not np.array_equal(loads, ref)) or gap > 1e-12:
            raise RuntimeError(f"phase 10d: route_hyperx {mode}: card against CPU {gap:.3e}")
        peak = net.hyperx_max_link_load(hx, loads)
        if mode == "minimal" and peak != net.hyperx_all_to_all_max_load(hx):
            raise RuntimeError(f"phase 10d: minimal all-to-all peak {peak!r}, closed form "
                               f"{net.hyperx_all_to_all_max_load(hx)!r}")
        out["route_hyperx"].append({"mode": mode, "messages": int(a2a[0].shape[0]), "max_link_load": peak,
                                    "max_rel_gap": gap, "card_s": t_card, "cpu_s": t_cpu})
        print(f"phase 10d: route_hyperx {mode} of all-to-all on H{HX_ROUTE} ({a2a[0].shape[0]} messages): "
              f"max link load {peak!r}, card against CPU {gap:.3e}; card {t_card:.3f} s, CPU {t_cpu:.3f} s",
              flush=True)
    from repro_torch.network import hamming

    half = hamming.lex_cells(HX_ROUTE, net.volume(HX_ROUTE) // 2)
    cut = net.hamming_cut_of_set(HX_ROUTE, half, device=card)
    if cut != hx.bisection_links():
        raise RuntimeError(f"phase 10d: the half-set's cut on the card {cut}, the bisection {hx.bisection_links()}")

    out["compare_fabric_routing"] = []
    for dims in HX_PODS:
        pod = net.HyperXFabric(dims, link_bw=1.0)
        for pattern, traffic in (("all_to_all", net.all_to_all(dims)), ("hotspot_line", net.hotspot_line(dims))):
            cmp, t_card = wall_s(lambda: net.compare_fabric_routing(pod, traffic, device=card))
            ref, t_cpu = wall_s(lambda: net.compare_fabric_routing(pod, traffic, device="cpu"))
            for x, y in ((cmp.dor_makespan, ref.dor_makespan), (cmp.adaptive_makespan, ref.adaptive_makespan)):
                if abs(x - y) > 1e-9 * max(1.0, y):
                    raise RuntimeError(f"phase 10d: H{dims} {pattern}: card {cmp}, CPU {ref}")
            out["compare_fabric_routing"].append({"dims": list(dims), "pattern": pattern,
                                                  "minimal_makespan": cmp.dor_makespan,
                                                  "dal_makespan": cmp.adaptive_makespan,
                                                  "recovered_fraction": cmp.recovered_fraction,
                                                  "card_s": t_card, "cpu_s": t_cpu})
            print(f"phase 10d: compare_fabric_routing H{dims} {pattern}: minimal {cmp.dor_makespan!r}, DAL "
                  f"{cmp.adaptive_makespan!r}, recovered {cmp.recovered_fraction!r}; card {t_card:.3f} s, "
                  f"CPU {t_cpu:.3f} s", flush=True)

    pod = net.HyperXFabric(HX_PODS[0], link_bw=1.0)
    adv = {dev: [dataclasses.astuple(net.advise_partition(pod, u, simulate=True, device=dev)) for u in (8, 16, 32)]
           for dev in (card, "cpu")}
    tables = {dev: [net.bisection_table(pod, u, device=dev).ranked() for u in (8, 16, 32)] for dev in (card, "cpu")}
    if adv[card] != adv["cpu"] or tables[card] != tables["cpu"]:
        raise RuntimeError("phase 10d: the HyperX advisor or bisection tables differ on the card")
    out["advise_partition"] = [{"units": a[0], "current": list(a[1]), "optimal": list(a[3]),
                                "predicted_speedup": a[6], "simulated_speedup": a[7]} for a in adv[card]]
    print(f"phase 10d: advise_partition on H{HX_PODS[0]} at 8, 16, 32 cells: optimal "
          f"{[a[3] for a in adv[card]]}, predicted {[a[6] for a in adv[card]]}, drained "
          f"{[a[7] for a in adv[card]]}; bisection tables {tables[card]}; the same on both", flush=True)

    def queue(dev):
        rng = np.random.default_rng(HX_QUEUE["seed"])
        jobs, t = [], 0.0
        for i in range(HX_QUEUE["jobs"]):
            t += float(rng.exponential(1.0))
            jobs.append(net.JobRequest(i, int(rng.choice(HX_QUEUE["sizes"])), duration=float(rng.uniform(2.0, 8.0)),
                                       arrival=t))
        svc = net.SchedulerService(pod, net.IsoperimetricPolicy(), backfill=True, device=dev)
        for req in jobs:
            svc.submit(req)
        return svc.run()

    (svc, t_card), (svc_cpu, t_cpu) = wall_s(lambda: queue(card)), wall_s(lambda: queue("cpu"))
    check_logs("the HyperX queue", svc.log, svc_cpu.log)
    res = svc.result()
    out["queue"] = {"pod": list(HX_PODS[0]), "jobs": len(res.jobs), "makespan": res.makespan,
                    "mean_bisection_efficiency": res.mean_bisection_efficiency, "card_s": t_card, "cpu_s": t_cpu}
    print(f"phase 10d: a {HX_QUEUE['jobs']}-job queue on H{HX_PODS[0]}: makespan {res.makespan!r}, mean "
          f"bisection efficiency {res.mean_bisection_efficiency!r}, the same log on both; card {t_card:.3f} s, "
          f"CPU {t_cpu:.3f} s", flush=True)

    arch, chips, shape = HX_PLAN
    plans = {dev: wall_s(lambda: planner.plan_model(arch, chips, pod=net.HyperXFabric(HX_PODS[0], link_bw=50e9),
                                                    shape=shape, simulate_top_k=1, device=dev))
             for dev in (card, "cpu")}
    (plan, t_card), (plan_cpu, t_cpu) = plans[card], plans["cpu"]
    if plan_rows(plan) != plan_rows(plan_cpu):
        raise RuntimeError("phase 10d: the HyperX plan's rows differ on the card")
    print(planner.format_table(plan), flush=True)
    out["plan"] = {"arch": arch, "chips": chips, "shape": shape, "geometry": list(plan.geometry),
                   "axis_sizes": list(plan.best.axis_sizes), "rows": len(plan.table),
                   "step_s": plan.step_time, "card_s": t_card, "cpu_s": t_cpu}
    print(f"phase 10d: plan_model {arch} at {chips} cells of H{HX_PODS[0]}: {plan.geometry} "
          f"{plan.best.axis_sizes}, {len(plan.table)} rows, bit-equal on both; card {t_card:.3f} s, "
          f"CPU {t_cpu:.3f} s", flush=True)
    return out


def phase10_engines(smi: str, card: str = "cuda", scenario_runs=None) -> dict:
    """Phase 10: the rest of the network engines, each sub-phase on the card
    and through the CPU path, with its wall time, the device's idle share
    over its card work and the dispatch counts."""
    from repro_torch.obs import DISPATCHES

    from repro_torch import network as net

    DISPATCHES.clear()
    dims = node_dims(MIRA_SCHEDULER_PARTITIONS[8])
    pairing = net.bisection_pairing(dims)
    hx = net.HyperXFabric(HX_ROUTE, link_bw=1.0)
    a2a = net.all_to_all(HX_ROUTE)
    phases = [  # (sub-phase, its run, one card call of it timed under torch.profiler)
        ("10a", lambda: phase10_routing(card), lambda: net.compare_routing(dims, pairing, device=card)),
        ("10b", lambda: phase10_timeline(card),
         lambda: net.simulate_flows(net.dor_paths(dims, *pairing), record_utilization=True, device=card)),
        ("10c", lambda: phase10_telemetry(card, scenario_runs), lambda: spill_report(card)),
        ("10d", lambda: phase10_hyperx(card), lambda: net.route_hyperx(hx, *a2a, mode="dal", device=card)),
    ]
    out = {}
    for key, run, probe in phases:
        t0 = time.perf_counter()
        out[key] = run()
        out[key]["wall_s"] = time.perf_counter() - t0
        _, out[key]["idle"] = profile_idle_share(probe)
        print(f"phase {key}: wall {out[key]['wall_s']:.1f} s; its probe under torch.profiler: wall "
              f"{out[key]['idle']['wall_ms']:.1f} ms, device busy {out[key]['idle']['device_busy_ms']:.1f} ms, "
              f"idle share {out[key]['idle']['device_idle_share']:.4f}", flush=True)
    out["dispatches"] = {f"{name}/{dev}": n for (name, dev), n in sorted(DISPATCHES.items())}
    missing = [name for name in ("adaptive_links", "drain", "attribute_contention", "hyperx_flows",
                                 "hamming_cut_of_set", "hamming_cut_scores") if not DISPATCHES[(name, card)]]
    if missing:
        raise RuntimeError(f"phase 10: no dispatch on the card of {missing}")
    print(f"phase 10: dispatches {out['dispatches']} on {smi}", flush=True)
    return out


# The port's examples, run by phase 11 in this order, and partition
# analysis's replay size: 100 jobs, where the JAX example's default is 400,
# since at 400 (65.6 s alone, 138.6 s beside phase 9c) the whole script took
# 1176.8 s of its 1200 on an H100.
EXAMPLES = ["quickstart", "serve_batched", "fault_tolerant_training", "streaming_scheduler",
            "telemetry_dashboard", "hyperx_analysis", "fleet_planner", "partition_analysis"]
EXAMPLE_REPLAY_JOBS = 100


def phase11_examples() -> dict:
    """Each of the port's examples through its ``main`` on the card, its
    asserts holding; the wall seconds of each."""
    import importlib
    import tempfile

    import torch

    seconds, t_phase = {}, time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        for name in EXAMPLES:
            argv = {"telemetry_dashboard": ["--out-dir", out_dir],
                    "partition_analysis": ["--jobs", str(EXAMPLE_REPLAY_JOBS)]}.get(name, [])
            t0 = time.perf_counter()
            importlib.import_module(f"repro_torch.examples.{name}").main(argv)
            torch.cuda.synchronize()
            seconds[name] = round(time.perf_counter() - t0, 3)
            print(f"  [example] {name}: {seconds[name]} s", flush=True)
    return {"seconds": seconds, "wall_s": round(time.perf_counter() - t_phase, 3),
            "replay_jobs": EXAMPLE_REPLAY_JOBS}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    if not (REPO / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import ops as flash_ops
    from repro_torch.kernels.rwkv6 import ops as rwkv6_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    # -- phase 1: card and build ---------------------------------------------
    t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    build_s, build_logs = _build.build_all(verbose=True)
    for stem, log in sorted(build_logs.items()):
        for fn, regs, spill_st, spill_ld, smem in ptxas_summary(log):
            print(f"  [nvcc {stem}.cu] {fn}: {regs} registers, {spill_st} / {spill_ld} bytes "
                  f"spill stores / loads, {smem} B static shared memory")
    print(f"phase 1: built {len(_build.sources())} kernel source(s) in {build_s:.1f} s; "
          f"phase wall {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- phase 2: kernels vs plain versions ------------------------------------
    t_phase = time.perf_counter()
    numbers = phase2_kernels(torch, torch.Generator(device="cuda").manual_seed(0), build_logs)
    print(f"phase 2: wall {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- phase 3: full-width serving ---------------------------------------------
    t_phase = time.perf_counter()
    counters = {"flash_fwd": flash_ops, "ssd_fwd": ssd_ops, "rwkv6_fwd": rwkv6_ops}
    serve_cfgs = [get_arch(a) for a in SERVE_ARCHS] + [moe_config(a, MOE_SERVE) for a in MOE_SERVE_ARCHS]
    by_path = {depth_label(cfg): phase3_serve(torch, cfg, counters) for cfg in serve_cfgs}
    print(f"phase 3: wall {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- phase 4: where the time goes --------------------------------------------
    t_phase = time.perf_counter()
    for cfg in serve_cfgs[:len(SERVE_ARCHS)] + [moe_config(a, MOE_PROFILE) for a in MOE_SERVE_ARCHS]:
        phase4_profile(torch, cfg)
    print(f"phase 4: wall {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- phase 5: training ------------------------------------------------------
    t_phase = time.perf_counter()
    by_path.update(phase5_training(torch, smi, counters))
    print(f"phase 5: wall {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -- phase 6: the network engines --------------------------------------------
    t_phase = time.perf_counter()
    network = phase6_network(smi)
    print(f"phase 6: wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    print(json.dumps({"network": network, "card": smi}))

    # -- phase 7: the allocation engines -------------------------------------------
    t_phase = time.perf_counter()
    allocation = phase7_allocation(smi)
    scenario_runs = allocation.pop("services")
    print(f"phase 7: wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    print(json.dumps({"allocation": allocation, "card": smi}))

    # -- phase 8: the fleet planner ----------------------------------------------
    t_phase = time.perf_counter()
    planner = phase8_planner(smi)
    print(f"phase 8: wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    print(json.dumps({"planner": planner, "card": smi}))

    # -- phase 9: the dry-run and the distributed layer, phase 11 beside 9c --------
    # Phase 9c's cells run in child processes and keep the host busy, not
    # the card: the examples (phase 11) run in a thread of this process
    # meanwhile, and are joined before phase 10 profiles the card.
    t_phase = time.perf_counter()
    distributed = {"strassen": phase9a_strassen(torch, smi), "ring": phase9b_ring(torch)}
    with ThreadPoolExecutor(max_workers=1) as pool:
        examples_run = pool.submit(phase11_examples)
        distributed["dryrun"] = phase9c_dryrun(torch, smi)
        print(f"phase 9: wall {time.perf_counter() - t_phase:.1f} s", flush=True)
        examples = examples_run.result()
    print(f"phase 11: wall {examples['wall_s']:.1f} s, beside phase 9c; phases 9 and 11 together "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    print(json.dumps({"distributed": distributed, "card": smi}))
    print(json.dumps({"examples": examples, "card": smi}))

    # -- phase 10: the rest of the network engines --------------------------------
    t_phase = time.perf_counter()
    engines = phase10_engines(smi, scenario_runs=scenario_runs)
    print(f"phase 10: wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    print(json.dumps({"engines": engines, "card": smi}))

    sources = {
        "flash_fwd": ("src/repro_torch/kernels/attention/csrc/flash_fwd_sm90.cu",
                      "src/repro/kernels/attention/flash.py:33"),
        "ssd_fwd": ("src/repro_torch/kernels/ssd/csrc/ssd_fwd_sm90.cu",
                    "src/repro/kernels/ssd/chunked.py:30"),
        "rwkv6_fwd": ("src/repro_torch/kernels/rwkv6/csrc/rwkv6_fwd_sm90.cu",
                      "src/repro/kernels/rwkv6/chunked.py:34"),
    }
    tensor_core = sum(c["flash_fwd_tensor_core"] for c in by_path.values())
    tf32 = sum(c["flash_fwd_tf32"] for c in by_path.values())
    numbers["flash_fwd"]["at_moe_serve_f32"]["launches"] = tf32
    kernels = []
    for name, (source, replaces) in sources.items():
        m = numbers[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(counts[name] for counts in by_path.values()),
            "launches_by_path": {arch: counts[name] for arch, counts in by_path.items()
                                 if counts[name]},
            "max_abs_err": m["max_abs_err"],
            "ms": m["ms"],
            "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
            **({"tensor_core_launches": tensor_core, "tf32_launches": tf32,
                "float32_source": "src/repro_torch/kernels/attention/csrc/flash_fwd_tf32_sm90.cu"}
               if name == "flash_fwd" else {}),
            **{key: m[key] for key in ("ms_eager", "library_ms_eager", "at_zamba2_hd80",
                                       "at_internvl2_gqa7_hd64", "at_musicgen_mha_hd64",
                                       "at_moe_serve_f32",
                                       "bound_f32_ms", "bound_f32_by", "ms_f32", "ms_eager_f32",
                                       "bound_f32_inputs_ms") if key in m},
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
