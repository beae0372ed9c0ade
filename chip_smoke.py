"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, is right, and serves.

    python3 chip_smoke.py

Phases, one JSON line each (every line also kept whole in
``chiprun_out/chip_smoke.jsonl`` under the working directory); any
failure exits nonzero without the final line:

1. environment: the card, its power limit, torch/CUDA versions, and the
   build of every CUDA source of the port with ``nvcc`` (one ``nvcc`` per
   source, all started together, each build timed), beside ptxas's
   registers and spill bytes for every kernel and its warnings and
   performance notes (``-Xptxas -v``); a spill fails the run;
2. ``gemm_int8`` against its plain version on the card, bit for bit, on
   a row-major ``w`` (the ``dp4a`` kernel) and on its K-major copy (the
   ``wgmma`` kernels): the reference's shape sweep, ``emit_int32``/ReLU,
   biases near +-2^30, every shift in -31..31 with accumulators at the
   int32 rails, the ``wgmma`` paths' edges (N across the small-N limit,
   ragged K and M, a deep K over few tiles), and every AlexNet, VGG16
   and ResNet-50 batch-16 shape (generated from ``core/workload.py``;
   ResNet-50's bottlenecks add an int8 skip in the epilogue, aligned by
   left and right shifts), each timed on
   the main path's layouts (kernel, the ``dp4a`` kernel on the same
   operands, plain version, one library call) beside its bound, with a
   per-batch line for each model; at each of those shapes every
   ``wgmma`` tiling the kernels are built for (``kernel.plans``) is
   forced in turn, checked bit for bit and timed beside the wrapper's
   choice (``gemm_int8_tilings`` lines);
3. full-width AlexNet served through ``serve`` on the default (kernel)
   route, with the kernels' launches counted by path (8 ``large_n`` and
   3 ``small_n`` a batch, no ``dp4a``); every served frame's logits
   equal the oracle route's on the same frames; on one batch the raw
   int32 accumulators of the kernel, oracle and f32 routes are identical
   on the card and equal the plain integer oracle run on the CPU; a
   breakdown of one batch's time (host enqueue, wall, device by kernel,
   the host cost of one ``gemm_int8`` call on either path); then one
   batch of full-width VGG16 through the kernel (13 + 3 launches),
   oracle and f32 routes, identical int32, with its chain's wall time,
   device time by kernel and idle share; then one batch of full-width
   ResNet-50 v1.5 through the kernel (53 ``large_n``, 16 of them adding
   the skip, + 1 ``small_n``), oracle and f32 routes, identical int32 and
   equal on two frames to the kernel route's plain version on the CPU,
   with the same times; then the layer-pipelined serving
   path (phase ``pipeline``): full-width AlexNet through ``serve_async``
   at K = 1, 2 and 4 stages and through the replica pool at R = 2, K = 2
   on the one card, each with its partition, steady fps beside the single
   executor's in the same run, open-loop p50/p95/p99, launches by path
   (8 ``large_n`` + 3 ``small_n`` a batch summed over the stages, no
   ``dp4a``), every frame's top-1 (on one pass its logits) identical to
   the single executor's and the oracle route's; closed-loop fps of the
   single executor and each config measured in turns, with the device's
   idle share; full-width VGG16 through ``PipelineExecutor`` at K = 2 and
   4 with int32 identical to the whole chain and the oracle route (13 + 3
   launches a batch); ``simulate()``
   for the four paper models beside the modeled fps; then phase
   ``bits16``: full-width AlexNet at bits=16 (its one route, the exact
   integer oracle) with every step's int16 output and the int64
   accumulators of the runner, ``EngineExecutor`` and a K = 2
   ``PipelineExecutor`` equal to the same program run on the CPU, bit for
   bit, the kernel and f32 routes refused, no ``gemm_int8`` launch, wall
   and device busy ms a batch; phase ``chaos_elastic`` (lines ``chaos``
   and ``knee_rescale``): AlexNet at bits=8 through two K = 2 replicas,
   one killed mid-stream by ``ChaosExecutor`` (every request completed
   or failed, none hung, ``recovery_report``), then
   ``serve_knee_rescale`` (a live rescale R 1 -> 2, ``hung == 0``,
   whether it was forced), every served frame's top-1 equal to the
   single executor's and the launches 8 ``large_n`` + 3 ``small_n`` a
   batch; phase ``import``: ``examples/lenet.json`` through
   ``launch/import_model.py`` (import, golden, a serve through
   ``Server``), its launches by path (2 ``large_n`` + 1 ``small_n`` + 2
   ``dp4a`` a batch, as the wrapper's rule predicts for fc2 and fc3,
   whose rows are off 16-byte strides) and its golden held on the f32,
   oracle and kernel routes on the card and on the CPU;
4. ``flash_attention`` against its plain version on the card: the
   reference's test shapes (2e-5 in float32, 3e-2 in bfloat16, and each
   output row within a fraction of its own RMS), a query
   block shorter than the keys, GQA, the wgmma kernel's edges in bf16
   at d 64, 128 and 256 (lengths that fill no 128-row tile, Sq < Skv,
   causal Sq > Skv, windows across a tile edge, GQA 8:1, MQA 10:1,
   strided views), and the Yi-6B shape, which is timed (kernel, plain
   version, one library call) beside its bound and the previous design's
   recorded time;
5. Yi-6B at full width (seed 0, bf16, weights drawn on the card): the
   cache-less forward on 2 x 2048 tokens on the kernel impl, with its
   ``flash_attention`` launches counted (one per layer), held against the
   torch impl and both against a float32 forward of the same weights;
   the forward's wall time, device time by kernel and idle share;
6. Yi-6B served through ``repro_torch.launch.serve.main`` (batch 4,
   prompt 512, 32 generated), and a teacher-forced decode over the cache
   held against the kernel forward's logits at the same positions;
7. ``linear_scan`` against its plain version on the card (2e-5, and
   bit for bit): the reference's test shapes, a ragged S, the h0 fold's
   S + 1, a long S with a near 1, the chunked kernel's edges (S 1, less
   than a chunk, a chunk + 1, S 4097, S 16384, B 4 with D 100), every
   fp32/bf16 pairing of a and b, two launches back to back, and the
   RecurrentGemma-2B forward's shape, which is timed (kernel, plain
   version) beside its bound and the previous design's recorded time;
8. ``flash_attention`` at head dim 256 against its plain version: MQA
   10:1 with window 2048 at S 4096 and a ragged S, in float32 and bf16,
   and the RecurrentGemma-2B shape timed (kernel, plain version, one
   masked ``scaled_dot_product_attention`` call) beside its bound;
9. RecurrentGemma-2B at full width (seed 0, bf16, weights drawn on the
   card): the cache-less forward on 2 x 4096 tokens (longer than the
   window) with its launches counted (8 ``flash_attention``, 18
   ``linear_scan``), held against the kernel-free forward (torch
   attention, the plain scan) and both against a float32 forward of the
   same weights; wall time, device time by kernel, idle share, memory;
10. RecurrentGemma-2B served through ``launch.serve.main`` (batch 4,
   prompt 512, 32 generated: prefill launches ``linear_scan`` 18 times),
   and a teacher-forced decode over the ring cache and the RG-LRU state,
   past the window, held against the kernel forward's logits;
11. ``autotune`` (right after phase 2, no device work): the static
   ranker's pick at every AlexNet and VGG16 batch-16 shape beside
   ``plan_for``'s choice and the fastest tiling phase 2 measured, and its
   attention tiles beside those ``flash_attention.cu`` is built with;
   recorded, not gated;
12. ``vlm``: Qwen2-VL-2B at full width (bf16, seed 0): the cache-less
   forward on 2 x 2048 patch embeddings with M-RoPE positions whose three
   components differ (28 ``flash_attention`` launches at GQA 12:2, d
   128), held against the kernel-free and float32 forwards as Yi-6B's; a
   teacher-forced decode with the true positions; ``launch.serve.main``
   (0 launches; the reference's decode positions of 0); the kernel at the
   path's shape against plain, SDPA and the bound;
13. ``encdec``: SeamlessM4T-medium at full width: the forward with frames
   and tokens of 2 x 2048 (36 launches at d 64: 12 non-causal encoder, 12
   causal decoder, 12 non-causal cross-attention), held as above; a
   teacher-forced decode passing the frames at every step; served (24
   launches in prefill, 0 in decode, whose steps skip cross-attention as
   the reference's do); the kernel at the encoder shape (non-causal)
   against plain and SDPA;
14. ``mla_moe``: DeepSeek-V2-236B at full width, depth cut to 3 layers
   (one dense MLA, two MLA + MoE with 160 routed experts, top-6, 2
   shared): the forward on 2 x 1024 tokens (0 launches: MLA's q and v
   head dims differ), its aux loss and each MoE layer's kept share; a
   teacher-forced decode through the absorbed path at a capacity factor
   that drops nothing, in bf16 (positions whose routing flipped between
   near-tied gates counted and set aside) and in float32; served at the
   published capacity factor;
15. ``rwkv``: RWKV6-7B at full width, depth cut to 8 layers: the forward
   on 2 x 1024 tokens (no
   kernel), the sequential WKV loop's time, the bf16 forward's drift from
   a float32 forward, teacher-forced decodes over the shifts and the WKV
   state in float32 and bf16, served;
16. ``train`` (phase 17 in the code's headings): ``linear_scan``'s
   gradient (the forward and the reversed backward launch) against
   autograd through its plain version on the card at a ragged S, S 1, a
   chunk + 1 and the training shape (2, 1024, 2560), both directions
   timed beside the plain version and their bounds; one
   ``make_train_step`` of every reduced config in float32 on the card
   against the CPU (every gradient leaf, loss, grad norm, the updated
   params; the reduced RecurrentGemma's 3 + 3 ``linear_scan`` launches, no
   ``flash_attention``); full-width RecurrentGemma-2B, depth cut to 13
   layers, trained for 5 steps at 2 x 1024 (bf16, float32 AdamW
   moments): steps 1-4 through ``launch/train.py::main`` with its one
   checkpoint, step 4's, in a temporary directory (a checkpoint of the
   cut model is 21.3 GB: the run writes one), step 5 carrying the
   run's state on; the state held equal to its checkpoint; finite losses
   and grad norms, exactly 9 + 9 ``linear_scan`` launches (one per RG-LRU
   layer) and no ``flash_attention`` a step, step wall
   ms, tokens/s, MFU, peak memory; every floating parameter's gradient
   nonzero; step 5 replayed from step 4's checkpoint equal to the run's
   step 5 bit for bit; one warm step profiled (device busy by kind, idle
   share against the unprofiled steps' wall) and one timed by parts;
17. ``int8`` (phase 18 in the code's headings): full-width Yi-6B (seed
   0, bf16) quantized on the card by ``quantize_params_int8``: every
   int8 code and float32 scale of layers 0 and 31 and the head, and the
   bf16 weight ``apply_dense`` multiplies, equal to the same on the CPU
   bit for bit; the int8 cache-less forward on 2 x 2048 tokens with its
   32 ``flash_attention`` launches counted, within ``LM_ROUTE_TOL`` of
   the int8 forward on the plain attention, its distance and top-1
   agreement from the bf16 forward, its time; bf16 and int8 served in
   turns (bf16, int8, int8, bf16) through ``make_prefill_step`` and
   ``make_serve_step`` at batch 4, prompt 512, 32 tokens (time to first
   token, tokens/s, no launch), each decode step broken down (wall,
   busy, idle, kernels), the greedy tokens' agreement, the params' bytes
   and ``memory_allocated``; DeepSeek-V2 cut to 3 layers, int8: the
   forward beside bf16 with the routing flips counted, and the absorbed
   decode teacher-forced by phase ``mla_moe``'s rules in bf16 and
   float32;
18. ``mesh``: the mesh runtime on the card. (a) Full-width Yi-6B placed
   by ``param_shardings`` on a one-rank NCCL mesh (1, 1): its forward on
   2 x 2048 tokens under DTensor with 32 ``flash_attention`` launches
   (through the wrapper's DTensor rule), logits equal to the unplaced
   forward's (within ``LM_ROUTE_TOL`` at most), wall and idle share of
   both; (b) one full-width DeepSeek-V2 MoE layer (160 experts, top-6, 2
   shared, capacity factor 8) on 2 x 1024 tokens through ``moe_apply``
   under a (1, 2) mesh of two gloo processes, both on cuda:0 (80 experts
   each), in float32 and bf16: routing identical to ``_moe_local``'s, the
   float32 output within the CPU tests' bound of it, the all-reduce count
   (``CommDebugMode``), the layer's and the all-reduce's wall ms; a
   failed child fails the run;
19. ``pipeline_lm``: the flexible layer pipeline (``core/pipeline.py``):
   full-width Yi-6B (seed 0, bf16, each rank drawing only its own part)
   over a (data 1, stage 2, tp 2) mesh of four gloo processes, all on
   cuda:0: the pipelined prefill on 2 x 2048 tokens at K 2, exactly
   (K + S - 1) x 16 = 48 ``flash_attention`` launches on each rank, its
   last-token logits within ``LM_ROUTE_TOL`` of the sequential kernel
   forward of the same weights (top-1 agreement recorded); one pipelined
   loss and its backward on 2 x 1024 tokens (no launch: the plain
   attention under autograd), the same loss on every rank within
   ``PIPE_LOSS_TOL`` of the sequential one, every gradient leaf finite
   and nonzero, a few within ``PIPE_GRAD_TOL`` of the sequential
   gradient's slice; each rank's wall, device busy and idle share, peak
   memory, its collectives' calls and bytes, the ms it spends in them,
   and one tp all-reduce and one hand-off timed alone; a failed child
   fails the run;
20. ``int8_moments``: AdamW's int8 moments on placed leaves. (a)
   Full-width RecurrentGemma-2B with int8 moments placed on a one-rank
   NCCL mesh (1, 1): three placed ``make_train_step`` calls on 2 x 1024
   tokens in turns with three unplaced ones of the same seed and batch,
   every param, code and scale equal after each step, exactly 18 + 18
   ``linear_scan`` launches a placed step, finite losses, the steps' wall
   ms, peak memory with both states on the card and one profiled step's
   idle share; (b) DeepSeek-V2 at full width cut to 2 layers (one dense
   MLA layer, one MLA + MoE layer with 160 experts), its own int8 moments,
   on a (data 1, model 2) mesh of two gloo processes on cuda:0: three
   ``adamw_update`` calls with seeded gradients bit for bit against the
   unplaced port (leaf by leaf, one rank at a time), then one
   ``apply_grads`` within the gloo tests' bounds, each leaf's layout case,
   the transfer's calls, bytes and ms per update, and the case-1 leaves
   (the expert stacks and the embedding) updated again with no collective;
   a failed child fails the run;
21. ``dryrun`` (phase 19): ``python -m repro_torch.launch.dryrun --all
   --mesh pod`` in spawned processes that see no card (each cell's
   status, seconds, bytes per device, FLOPs, and the collectives of the
   step traced placed in a fake process group, counted by kind), every
   runnable cell ok with collectives and the rest skipped; at the same
   time the sweep with ``--dist pipeline``: the reference's status for
   each cell
   (decode shapes, DeepSeek's train plans and the VLM's prefill errors,
   RecurrentGemma-2B "ok", C9), every traced cell's plan and its stage
   hand-off counted;
   RecurrentGemma-2B's ``abstract_state`` bytes (at phase ``train``'s
   depth) equal to the state phase ``train`` held, the int8 Yi-6B params'
   bytes equal
   to phase ``int8``'s, and the meta FLOPs of the 2 x 1024 train step
   beside phase ``train``'s ``model_flops``;
22. the ``kernels`` line (with a ``flash_attention`` entry for each of
   Yi-6B, RecurrentGemma-2B, Qwen2-VL-2B and SeamlessM4T-medium, and
   ``linear_scan`` entries for the forward, and for training's forward
   and backward; the Yi-6B entry's ``launches_on`` holds the int8
   forward's, the placed forward's and the pipelined prefill's summed
   over its four ranks, the training entries' the int8-moment steps of
   phase ``int8_moments``), the card's ``nvidia-smi`` name
   and power limit, and
   last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
from concurrent.futures import ThreadPoolExecutor
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from torch.distributed.tensor.debug import CommDebugMode  # noqa: E402

from repro_torch import checkpointing as ckpt  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.core import pipeline as PL  # noqa: E402
from repro_torch.core.executor import EngineExecutor  # noqa: E402
from repro_torch.core.program import ROUTES  # noqa: E402
from repro_torch.core.workload import CNN_MODELS  # noqa: E402
from repro_torch.kernels import _build, autotune  # noqa: E402
from repro_torch.kernels.conv2d_int8 import kernel as gemm_kernel  # noqa
from repro_torch.kernels.conv2d_int8.kernel import (  # noqa: E402
    gemm_int8, k_major_view, plan_for, plans)
from repro_torch.kernels.conv2d_int8.ref import (  # noqa: E402
    bias_relu_ref, gemm_int8_ref, requantize_ref)
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa
from repro_torch.kernels.rglru_scan import kernel as scan_kernel  # noqa
from repro_torch.kernels.rglru_scan.kernel import linear_scan  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import linear_scan_ref  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_stream  # noqa
from repro_torch.launch import dryrun as lm_dryrun  # noqa: E402
from repro_torch.launch import steps as lm_steps  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.launch import mesh as lm_mesh  # noqa: E402
from repro_torch.launch.mesh import production_mesh_shape  # noqa: E402
from repro_torch.runtime import sharding as SH  # noqa: E402
from repro_torch.launch.shapes import (SHAPES, ShapeCase,  # noqa: E402
                                       cell_is_runnable)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import recurrent as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.core.program import compile_model  # noqa: E402
from repro_torch.core.simulator import simulate  # noqa: E402
from repro_torch.serving import (AsyncFrontend,  # noqa: E402
                                 ChaosExecutor, FaultPlan,
                                 PipelineExecutor, ProgramRegistry,
                                 ReplicaPool, TrafficClass,
                                 make_scenario_schedule, recovery_report,
                                 replay)
from repro_torch.serving.server import (compile_for_serving,  # noqa: E402
                                        make_executor, serve, serve_async,
                                        serve_knee_rescale,
                                        synthetic_stream)

# Published dense peaks (NVIDIA data sheets), at the card's full power
# limit: int8 and bf16 tensor-core op/s, device-memory bytes/s.
PEAKS = {"H100 SXM": (1979e12, 989e12, 3.35e12),
         "H100 PCIe": (1513e12, 756e12, 2.0e12),
         "H200": (1979e12, 989e12, 4.8e12)}
# float32 FMA op/s outside the tensor cores (the same data sheets).
F32_PEAKS = {"H100 SXM": 67e12, "H100 PCIe": 51e12, "H200": 67e12}



def gemm_shapes(model_name: str, batch: int) -> list:
    """The ``gemm_int8`` launches of one batch of ``model_name`` on the
    main path, from ``core/workload.py``: (engine, N, K, M, launches per
    batch, groups, emits int32, adds a skip), one row per distinct (N, K,
    M, skip), named by its first engine. A grouped engine launches once
    per group on M / groups of its output channels; the last engine emits
    int32; a bottleneck's last conv adds its skip in the epilogue."""
    model = CNN_MODELS[model_name]()
    compute = [l for l in model.layers if l.computes]
    rows: dict = {}
    for lyr, hw in zip(model.layers, model.in_sizes()):
        if not lyr.computes:
            continue
        if lyr.kind == "fc":
            n, k = batch, lyr.in_ch
        else:
            n = batch * lyr.out_hw(hw) ** 2
            k = lyr.kernel * lyr.kernel * lyr.in_ch // lyr.groups
        key = (n, k, lyr.out_ch // lyr.groups, lyr is compute[-1],
               lyr.residual is not None)
        if key in rows:
            rows[key][4] += lyr.groups
        else:
            rows[key] = [lyr.name, n, k, key[2], lyr.groups, lyr.groups,
                         key[3], key[4]]
    return [tuple(r) for r in rows.values()]


SERVE_FRAMES, SERVE_BATCH = 64, 16
# The pipeline phase: AlexNet served through serve_async at each (K
# stages, R replicas) on the one card, 8 batches a stream; VGG16 through
# PipelineExecutor at each K, 2 batches a pass.
PIPE_FRAMES = 128
# The closed-loop comparison in turns: a longer stream (32 batches) per
# pass, PIPE_ROUNDS passes per executor, order reversed every other round.
PIPE_TURN_FRAMES, PIPE_ROUNDS = 512, 5
PIPE_CONFIGS = ((1, 1), (2, 1), (4, 1), (2, 2))
PIPE_LOGITS = (2, 1)            # the config whose logits are compared
VGG_PIPE_STAGES = (2, 4)
VGG_PIPE_BATCHES = 2
# The bits16 phase: AlexNet at bits=16, batches of SERVE_BATCH.
BITS16_FRAMES = 32
# The chaos_elastic phase: the stream with one replica of two killed at
# its CHAOS_KILL_AT-th batch, paced at CHAOS_LOAD x one replica's rate, so
# that the survivor carries twice its rate after the kill; the router
# prices the survivor out until the victim is quarantined, so the victim
# is sure to receive its kill batch (priced on measured times, the
# least-wait router may send it fewer); the stream of the elastic knee
# ramp.
CHAOS_FRAMES, CHAOS_KILL_AT, CHAOS_LOAD = 384, 3, 2.0
KNEE_FRAMES = 96
# The import phase: frames served by the imported LeNet (batch 4).
IMPORT_FRAMES = 16
GEMM_MODELS = ("alexnet", "vgg16", "resnet50")
# The first design's per-shape times at AlexNet batch 16 (__dp4a, 64 x 64
# tiles; cold L2, median of 10), recorded by this script on an NVIDIA
# H100 80GB HBM3 at 700 W when that design was new (PERF.md), not measured
# in this run; the same kernel is timed again in this run as `dp4a_ms`.
PR11_MS = {"conv1": 0.0821, "conv2": 0.0606, "conv3": 0.0857,
           "conv4": 0.0596, "conv5": 0.0600, "fc6": 0.2860, "fc7": 0.1325,
           "fc8": 0.1302}
# The wgmma paths' edges: (label, N, K, M). N across the small-N limit (1,
# 16, 17 and 64 on the swapped kernel, 65 on the large-N one), K not a
# multiple of a stage, M narrower than any tile, ragged, and 1000 (fc8)
# and 96 (conv1); two deep K over few tiles (one block streams the
# whole K of a tile; so does the rails case).
GEMM_EDGES = [
    ("N 1 fc8", 1, 4096, 1000),
    ("N 16 K 4000", 16, 4000, 1000),
    ("N 17 K 4100 M 96", 17, 4100, 96),
    ("N 64 K 1000", 64, 1000, 1000),
    ("N 65 K 1000", 65, 1000, 1000),
    ("N 300 M 8", 300, 200, 8),
    ("N 2704 K 1700 M 384", 2704, 1700, 384),
    ("N 1000 K 27 M 64", 1000, 27, 64),
    ("N 5000 K 3000 M 130", 5000, 3000, 130),
    ("N 16 K 20000 M 96", 16, 20000, 96),
    ("N 300 K 10000 M 64", 300, 10000, 64),
]
GEMM_SOURCE = "src/repro_torch/kernels/conv2d_int8/csrc/gemm_int8.cu"
GEMM_REPLACES = "src/repro/kernels/conv2d_int8/kernel.py:61"
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention.cu")
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:67"
# flash_attention against its plain version: (label, B, Sq, Skv, H, KV, d,
# dtype, causal, window). The first four are the reference's test cases
# (tests/test_kernels.py); the tolerances are the ones it states.
FLASH_CASES = [
    ("reference f32", 1, 64, 64, 1, 1, 32, torch.float32, False, 0),
    ("reference f32 causal", 2, 128, 128, 2, 2, 64, torch.float32, True, 0),
    ("reference f32 window 64", 1, 256, 256, 2, 2, 64, torch.float32, True,
     64),
    ("reference bf16 window 64", 1, 256, 256, 2, 2, 64, torch.bfloat16,
     True, 64),
    ("Sq < Skv", 2, 64, 192, 4, 2, 64, torch.float32, True, 0),
    ("GQA 8:2, ragged S", 2, 300, 300, 8, 2, 128, torch.bfloat16, True, 0),
    # The wgmma kernel's 128-row query tiles, bf16 at d 64, 128 and 256:
    # lengths that fill no tile, Sq < Skv, causal Sq > Skv (rows with no
    # valid key average every value), window edges that cross a 128-row
    # tile, GQA 8:1 and MQA 10:1.
    ("d 64 ragged S 300", 1, 300, 300, 8, 1, 64, torch.bfloat16, True, 0),
    ("d 128 GQA 8:1 S 1000", 2, 1000, 1000, 8, 1, 128, torch.bfloat16,
     True, 0),
    ("d 256 MQA 10:1 S 2049 window 300", 1, 2049, 2049, 10, 1, 256,
     torch.bfloat16, True, 300),
    ("d 128 Sq 300 < Skv 1000", 1, 300, 1000, 4, 2, 128, torch.bfloat16,
     True, 0),
    ("d 64 causal Sq 1000 > Skv 300", 1, 1000, 300, 4, 4, 64,
     torch.bfloat16, True, 0),
    ("d 256 causal Sq 1000 > Skv 300", 1, 1000, 300, 10, 1, 256,
     torch.bfloat16, True, 0),
    ("d 64 non-causal window 200 S 2049", 1, 2049, 2049, 8, 1, 64,
     torch.bfloat16, False, 200),
    ("d 256 window 130 S 1000", 1, 1000, 1000, 10, 1, 256, torch.bfloat16,
     True, 130),
    ("d 128 Sq 1000 < Skv 2049 window 1000", 2, 1000, 2049, 8, 1, 128,
     torch.bfloat16, True, 1000),
    # A tp rank's shard of Yi-6B in phase pipeline_lm: one microbatch row,
    # 16 query and 2 KV heads.
    ("d 128 GQA 16:2 S 2048 (Yi-6B's tp shard)", 1, 2048, 2048, 16, 2, 128,
     torch.bfloat16, True, 0),
]
# q/k/v as strided views into one fused [B, S, 3, H, d] projection: (S, d).
FLASH_STRIDED = [(128, 64), (300, 128), (1000, 256)]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# A check that scales with the output. On these randn inputs a row that
# averages n keys has an RMS of about 1/sqrt(n), 0.02-0.05 on the long
# cases: the size of the absolute 3e-2 itself. So each output row's largest
# error must also stay under this fraction of the row's RMS. Dropping or
# repeating one 128-key tile moves a row of 1000-2049 keys by a quarter to
# a third of its RMS; rounding p and the output to bf16 moves it by about
# 2^-9 of its largest element, a few thousandths of its RMS.
FLASH_ROW_REL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
# Yi-6B at full width: the forward's batch and length (the flash kernel's
# timed shape), the float32 reference's slice, the served batch.
LM_ARCH = "yi-6b"
LM_B, LM_S = 2, 2048
F32_S, F32_LAST = 512, 64
SERVE_ARGS = ["--arch", LM_ARCH, "--batch", "4", "--prompt-len", "512",
              "--gen", "32", "--seed", "0"]
TF_PROMPT, TF_STEPS = 504, 8
# Tolerances of the full-width Yi-6B checks, on bf16 logits whose largest
# magnitude is about 5 (the float32 forward's, measured by this script on
# an NVIDIA H100 80GB HBM3 at 700 W). Both attention impls round every matmul output, norm
# and residual add to bf16 over 32 layers; they differ only in where the
# attention logits are rounded (the kernel keeps QK^T in fp32, the torch
# impl rounds it to bf16 first), so that rounding noise, not the kernel,
# sets how far apart they land. Measured: kernel vs torch impl 0.121 max
# |diff| over all 2 x 2048 x 64000 logits; kernel vs float32 0.092 and
# torch impl vs float32 0.099 on the compared slice; the cache's
# teacher-forced logits vs the kernel forward 0.109.
# * LM_ROUTE_TOL bounds |kernel - torch impl| and |teacher-forced -
#   kernel forward|: twice the largest measured spread.
# * The kernel impl's error against float32 may exceed the torch impl's
#   by at most one bf16 ulp at the float32 logits' largest magnitude
#   (2^-5 for magnitudes in [4, 8)): the kernel may not make the model
#   measurably worse than the plain attention does.
LM_ROUTE_TOL = 0.25
SCAN_SOURCE = "src/repro_torch/kernels/rglru_scan/csrc/linear_scan.cu"
SCAN_REPLACES = "src/repro/kernels/rglru_scan/kernel.py:50"
SCAN_TOL = 2e-5       # the reference's (tests/test_kernels.py)
# linear_scan against its plain version: (label, B, S, D, a's range). The
# first four are the reference's test shapes; then a ragged S, the S + 1
# of the RG-LRU's h0 fold at the served prefill, a long S with a near 1,
# and the RecurrentGemma-2B forward's shape (the timed one).
SCAN_CASES = [
    ("reference 1x64x8", 1, 64, 8, (0.7, 0.999)),
    ("reference 2x128x32", 2, 128, 32, (0.7, 0.999)),
    ("reference 3x96x16", 3, 96, 16, (0.7, 0.999)),
    ("reference 1x256x128", 1, 256, 128, (0.7, 0.999)),
    ("ragged S", 2, 77, 100, (0.7, 0.999)),
    ("h0 fold, served prefill", 4, 513, 2560, (0.7, 0.999)),
    ("near-1 decay, long S", 2, 4096, 2560, (0.99, 0.9999)),
    # The chunked kernel's edges (chunks of 256 steps, tiles of 32
    # channels): one step, less than a chunk, a chunk and one step, the
    # h0 fold of the forward, a long chain of 64 chunks, a ragged D.
    ("S 1", 2, 1, 2560, (0.7, 0.999)),
    ("S below a chunk", 2, 100, 2560, (0.7, 0.999)),
    ("one chunk + 1", 2, 257, 2560, (0.7, 0.999)),
    ("S 4097 (h0 fold of the forward)", 2, 4097, 2560, (0.7, 0.999)),
    ("S 16384, near-1 decay", 1, 16384, 512, (0.99, 0.9999)),
    ("B 4, D 100", 4, 300, 100, (0.7, 0.999)),
    ("RecurrentGemma-2B forward", 2, 4096, 2560, (0.7, 0.999)),
]
# The times of the previous designs at the timed shapes (the mma.sync
# flash kernel with 64-row tiles; the scan with one thread per channel),
# recorded from an earlier run of this script on an NVIDIA H100 80GB HBM3
# at 700 W (PERF.md), not measured in this run: the yardstick the
# redesigned kernels are read against, printed beside this run's time.
PREVIOUS_MS = {"flash_attention_yi6b": 0.561,
               "flash_attention_recurrentgemma": 0.903,
               "linear_scan_recurrentgemma": 0.458}
# RecurrentGemma-2B at full width: the forward's batch and length (twice
# the window: the flash kernel's timed shape), the float32 reference's
# slice (longer than the window), the served batch, the teacher-forced
# decode (a ring of 2048 slots that wraps after the prefill).
RG_ARCH = "recurrentgemma-2b"
RG_B, RG_S = 2, 4096
RG_F32_S, RG_F32_LAST = 3072, 64
RG_SERVE_ARGS = ["--arch", RG_ARCH, "--batch", "4", "--prompt-len", "512",
                 "--gen", "32", "--seed", "0"]
RG_TF_PROMPT, RG_TF_STEPS = 2040, 16
# flash_attention at head dim 256 against its plain version: MQA 10:1,
# causal with RecurrentGemma's window; the first is the timed shape.
FLASH_RG_CASES = [
    ("RecurrentGemma-2B bf16", 2, 4096, 10, 1, torch.bfloat16, 2048),
    ("RecurrentGemma-2B f32", 2, 4096, 10, 1, torch.float32, 2048),
    ("d 256 ragged S bf16", 2, 1000, 10, 1, torch.bfloat16, 300),
    ("d 256 ragged S f32", 1, 1000, 10, 1, torch.float32, 300),
    ("d 256 S 2049 bf16", 1, 2049, 10, 1, torch.bfloat16, 2048),
    ("d 256 S 300 window 100 bf16", 2, 300, 10, 1, torch.bfloat16, 100),
]
# Tolerance of the full-width RecurrentGemma-2B checks, on bf16 logits
# whose largest magnitude is about 5.5 (the float32 forward's, measured by
# this script on an NVIDIA H100 80GB HBM3 at 700 W). `linear_scan` equals
# its plain version bit for bit, so the kernel and kernel-free forwards
# differ only where attention rounds (the kernel keeps QK^T in fp32, the
# torch impl rounds it to bf16 first), and that rounding noise, carried
# through 26 bf16 layers, sets how far apart they land. Measured: kernel
# vs kernel-free forward 0.193 max |diff| over all 2 x 4096 x 256000
# logits; the teacher-forced decode over the ring cache and the RG-LRU
# state vs the kernel forward 0.180; kernel vs float32 0.323 and
# kernel-free vs float32 0.299 on the compared slice.
# * RG_ROUTE_TOL bounds |kernel - kernel-free| and |teacher-forced -
#   kernel forward|: twice the largest measured spread.
# * The kernel forward's error against float32 may exceed the kernel-free
#   forward's by at most one bf16 ulp at the float32 logits' largest
#   magnitude, as for Yi-6B.
RG_ROUTE_TOL = 0.4
# autotune's attention picks at the LM paths' shapes: (label, S, d, B, H,
# causal, window).
AUTOTUNE_ATTN_SHAPES = [
    ("Yi-6B", 2048, 128, 2, 32, True, 0),
    ("RecurrentGemma-2B", 4096, 256, 2, 10, True, 2048),
    ("Qwen2-VL-2B", 2048, 128, 2, 12, True, 0),
    ("SeamlessM4T-medium encoder, cross", 2048, 64, 2, 16, False, 0),
    ("SeamlessM4T-medium decoder", 2048, 64, 2, 16, True, 0),
]
# The other LM families at full width (seed 0, bf16): the forward's batch
# and length (the flash kernel's timed shape), the teacher-forced decode,
# the served batch. DeepSeek-V2's depth is cut to 3 layers (one dense MLA
# layer, two MLA + MoE with all 160 routed experts), about 19 GB of bf16
# weights.
VLM_ARCH, ED_ARCH = "qwen2-vl-2b", "seamless-m4t-medium"
MLA_ARCH, RWKV_ARCH = "deepseek-v2-236b", "rwkv6-7b"
VLM_B, VLM_S = 2, 2048
VLM_TF_PROMPT, VLM_TF_STEPS = 504, 8
VLM_SERVE_ARGS = ["--arch", VLM_ARCH, "--batch", "4", "--prompt-len", "512",
                  "--gen", "32", "--seed", "0"]
ED_B, ED_S = 2, 2048
ED_TF_PROMPT, ED_TF_STEPS = 504, 8
ED_SERVE_ARGS = ["--arch", ED_ARCH, "--batch", "4", "--prompt-len", "512",
                 "--gen", "32", "--seed", "0"]
MLA_LAYERS = 3
MLA_B, MLA_S = 2, 1024
MLA_TF_PROMPT, MLA_TF_STEPS = 256, 16
MLA_SERVE_ARGS = ["--arch", MLA_ARCH, "--n-layers", str(MLA_LAYERS),
                  "--batch", "4", "--prompt-len", "256", "--gen", "16",
                  "--seed", "0"]
RWKV_B, RWKV_S = 2, 1024
# Depth cut 32 -> 8: the forward is host-bound by the WKV loop over tokens
# in every layer; the cut keeps the whole run within half its time limit.
RWKV_LAYERS = 8
RWKV_PROFILE_S = 128
RWKV_TF_PROMPT, RWKV_TF_STEPS = 256, 16
RWKV_SERVE_ARGS = ["--arch", RWKV_ARCH, "--batch", "4", "--prompt-len", "256",
                   "--gen", "16", "--seed", "0",
                   "--n-layers", str(RWKV_LAYERS)]
# Their tolerances, on bf16 logits, by the Yi-6B rules (LM_ROUTE_TOL).
VLM_ROUTE_TOL = ED_ROUTE_TOL = LM_ROUTE_TOL
MLA_TF_TOL = RWKV_TF_TOL = LM_ROUTE_TOL
RWKV_F32_MEAN_TOL = 0.3
RWKV_F32_TF_TOL = 1e-2
# DeepSeek-V2's teacher-forced decode in float32: the absorbed and the
# decompressed paths contract in other orders, ~1e-6 relative on logits of
# about 5; a hundredth catches any wrong term, far below a routing flip.
MLA_F32_TF_TOL = 1e-2


class SmokeFailure(Exception):
    pass


# Every line the run prints, also kept whole in the working directory's
# chiprun_out/ (a caller that keeps only the end of the output keeps this).
RUN_LOG = Path("chiprun_out") / "chip_smoke.jsonl"


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    RUN_LOG.parent.mkdir(exist_ok=True)
    with open(RUN_LOG, "a") as f:
        f.write(line + "\n")


def card_peaks(name: str) -> tuple[str, float, float, float]:
    """(table key, int8 op/s, bf16 op/s, bytes/s) for the card ``name``."""
    key = ("H200" if "H200" in name else
           "H100 PCIe" if "H100" in name and "PCIe" in name else "H100 SXM")
    return (key, *PEAKS[key])


def reset_launches() -> None:
    gemm_kernel.reset_launches()
    flash_attention.launches = 0
    _build.reset_count(linear_scan, ("forward", "backward"))


def launches() -> dict:
    return {"gemm_int8": gemm_int8.launches,
            "flash_attention": flash_attention.launches,
            "linear_scan": linear_scan.launches}


# ---------------------------------------------------------------------------
# Phase 1: environment and build
# ---------------------------------------------------------------------------


def _kernel_name(mangled: str) -> str:
    """A readable name for a mangled kernel of the port: its base name and
    template arguments (Li256E: 256; f: float; 13__nv_bfloat16 or S1_,
    its repeat: bf16)."""
    m = re.search(r"(flash_fwd_wgmma|flash_fwd_bf16|flash_fwd_f32|"
                  r"linear_scan_kernel|gemm_int8_kernel|gemm_wgmma)(I.*?EE)?",
                  mangled)
    if not m:
        return mangled
    args = [t.group(1) or {"f": "float", "Lb0E": "false",
                           "Lb1E": "true"}.get(t.group(0), "bf16")
            for t in re.finditer(r"Li(\d+)E|Lb[01]E|13__nv_bfloat16|S\d*_|f",
                                 m.group(2) or "")]
    return f"{m.group(1)}<{', '.join(args)}>" if args else m.group(1)


def ptxas_report(source: Path) -> list:
    """Registers and spill bytes of every kernel in ``source``, from
    ``nvcc -Xptxas -v`` with the build's own flags (device code only)."""
    out = Path(_build.BUILD_DIR) / f"{source.stem}.ptxas.cubin"
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run([_build._nvcc(), *flags, "-cubin", "-Xptxas", "-v",
                           "-o", str(out), str(source)], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise SmokeFailure(f"nvcc -Xptxas -v failed on {source.name}: "
                           f"{proc.stderr[-2000:]}")
    rows, name = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "warning" in line.lower() or "Performance Loss" in line:
            rows.append({"source": source.name, "note": line.strip()[:300]})
            continue
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            rows.append({"kernel": _kernel_name(name), "source": source.name,
                         "spill_stores": int(m.group(1)),
                         "spill_loads": int(m.group(2))})
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            for r in rows:
                if r.get("kernel") == _kernel_name(name):
                    r["registers"] = int(m.group(1))
    return rows


def phase_environment() -> dict:
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "test needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    # Full float32 matmuls everywhere (the float32 references below).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def timed_build(source):
        t0 = time.perf_counter()
        _build.load(source)
        return round(time.perf_counter() - t0, 3)

    sources = [gemm_kernel.SOURCE, flash_kernel.SOURCE, scan_kernel.SOURCE]
    # One nvcc per source for the build and one per source for ptxas's
    # report, all started together.
    with ThreadPoolExecutor(2 * len(sources)) as pool:
        builds = [pool.submit(timed_build, src) for src in sources]
        reports = [pool.submit(ptxas_report, src) for src in sources]
        build_s = {src.name: f.result() for src, f in zip(sources, builds)}
        ptxas = [row for f in reports for row in f.result()]
    kernels = [r for r in ptxas if "kernel" in r]
    env = {"phase": "environment", "device": name, "nvidia_smi": smi_line,
           "peaks_of": card_peaks(name)[0], "torch": torch.__version__,
           "cuda": torch.version.cuda, "python": sys.version.split()[0],
           "kernel_build_s": build_s, "ptxas": kernels,
           "ptxas_notes": [r for r in ptxas if "note" in r],
           "spill_bytes": sum(r["spill_stores"] + r["spill_loads"]
                              for r in kernels)}
    emit(env)
    if env["spill_bytes"]:
        raise SmokeFailure(f"ptxas spills registers: {kernels}")
    return env


# ---------------------------------------------------------------------------
# Phase 2: gemm_int8 against its plain version
# ---------------------------------------------------------------------------


def _rand_int8(gen, shape, lo=-128, hi=128):
    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int8,
                         device="cuda")


def _compare(cases: list, max_err: list, label: str, x, w, shift, bias,
             relu, emit_int32, w_k=None, **skip) -> str:
    """The kernel against its plain version, bit for bit, on ``w`` as given
    (row-major: the dp4a path) and on its K-major copy ``w_k`` (by default
    made here: a wgmma path), with the ``residual`` and ``res_shift`` in
    ``skip`` where given. Returns the path the K-major copy took."""
    want = gemm_int8_ref(x, w, shift, bias, relu=relu, emit_int32=emit_int32,
                         **skip)
    w_k = k_major_view(w) if w_k is None else w_k
    path = None
    for layout, ww in (("row-major", w), ("K-major", w_k)):
        before = dict(gemm_int8.launches_by_path)
        got = gemm_int8(x, ww, shift, bias, relu=relu, emit_int32=emit_int32,
                        **skip)
        torch.cuda.synchronize()
        path = next(p for p, n in gemm_int8.launches_by_path.items()
                    if n != before[p])
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        max_err[0] = max(max_err[0], err)
        exact = torch.equal(got, want)
        cases.append({"case": label, "layout": layout, "path": path,
                      "exact": exact, "max_abs_err": err})
        if not exact:
            raise SmokeFailure(f"gemm_int8 ({path}) disagrees with its plain "
                               f"version on {label}: max |err| {err}")
    return path


def _rails_case():
    """Accumulators exactly at the int32 rails, every shift in -31..31.

    K = 65536 and all-equal rows/columns give acc = (-128)(-128)K = 2^30
    and (-128)(127)K = -2^30 + 2^23; the biases put the first exactly on
    INT32_MAX and the second exactly on INT32_MIN, with no overflow."""
    K = 65536
    rows = torch.tensor([-128, 127, 0, 1, -1], dtype=torch.int8)
    x = rows[:, None].expand(5, K).contiguous()
    w = torch.cat([torch.full((K, 63), -128, dtype=torch.int8),
                   torch.full((K, 63), 127, dtype=torch.int8)], dim=1)
    shift = torch.cat([torch.arange(-31, 32), torch.arange(-31, 32)]).to(
        torch.int32)
    i32 = torch.iinfo(torch.int32)
    bias = torch.cat([torch.full((63,), i32.max - 2 ** 30),
                      torch.full((63,), i32.min + 2 ** 30 - 2 ** 23)]).to(
        torch.int32)
    return [t.cuda() for t in (x, w, shift, bias)]


def _time_cold_ms(fn, flush: torch.Tensor, iters: int = 10) -> float:
    """Median device time of ``fn`` over ``iters`` launches, each after a
    write of a buffer larger than L2, so every launch reads its operands
    from device memory as the main path's weights mostly do. A spin of
    about half a millisecond keeps the card busy while the host enqueues
    the flush and ``fn``, so host time never shows up as device time."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        torch.cuda._sleep(1_000_000)
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def _library_call(x, w, shift, bias, relu, emit_int32, **skip):
    """One PyTorch int8 GEMM (``torch._int_mm``, cuBLASLt) with the plain
    epilogue (the skip's add too, where ``skip`` holds ``residual`` and
    ``res_shift``) on the same inputs, or None where ``_int_mm``'s shape rules
    (more than 16 rows, K and M multiples of 8) exclude them. A K that is
    not a multiple of 8 is zero-padded (the zeros add nothing to the
    product), and N = 16 runs as the transposed product; both operand
    layouts are prepared outside the timed call."""
    N, K = x.shape
    M = w.shape[1]
    if M % 8:
        return None
    if K % 8:
        Kp = -(-K // 8) * 8
        x = torch.nn.functional.pad(x, (0, Kp - K))
        w = torch.nn.functional.pad(w, (0, 0, 0, Kp - K))
    if N > 16:
        a, b, transposed = x.contiguous(), w.contiguous(), False
    elif M > 16 and N % 8 == 0:
        a, b, transposed = w.t().contiguous(), x.t().contiguous(), True
    else:
        return None

    def run():
        acc = torch._int_mm(a, b)
        acc = acc.t() if transposed else acc
        if emit_int32:
            return bias_relu_ref(acc, bias, relu, **skip)
        return requantize_ref(acc, shift, bias, relu, **skip)
    return run


def _bound_ms(N, K, M, emit_int32, peak_ops, peak_bytes, skip=False):
    ops = 2 * N * K * M
    nbytes = N * K + K * M + 8 * M + N * M * (4 if emit_int32 else 1)
    if skip:                        # the int8 skip and its [M] shifts
        nbytes += N * M + 4 * M
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / peak_bytes * 1e3
    return ops, nbytes, max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def _patch_rows(gen, N: int, K: int) -> torch.Tensor:
    """Random int8 x [N, K] as the kernel route hands it over: a view into
    rows of a multiple of 16 bytes, whose padding bytes hold 127."""
    rows = torch.full((N, -(-K // 16) * 16), 127, dtype=torch.int8,
                      device="cuda")
    rows[:, :K] = _rand_int8(gen, (N, K))
    return rows[:, :K]


def _plan_label(plan) -> str:
    return f"{plan.path} {plan.width}x{64 * plan.warpgroups}"


def _gemm_tilings(model, name, N, K, M, call, want, flush, cases) -> dict:
    """Every ``wgmma`` tiling the kernels are built for that can take N
    rows (``plans``), forced in place of ``plan_for``'s choice, checked bit
    for bit against ``want`` (the wrapper's own result, already held to the
    plain version) and timed cold: whether the wrapper's rule picks the
    fastest. Labels are "path width x rows" of a tile."""
    chosen = plan_for(N, K, M, torch.cuda.get_device_properties(
        0).multi_processor_count)
    times = {}
    try:
        for plan in plans(N):
            gemm_kernel.plan_for = lambda *shape, plan=plan: plan
            if not torch.equal(call(), want):
                raise SmokeFailure(f"gemm_int8 tiling {_plan_label(plan)} "
                                   f"disagrees on {model} {name}")
            cases.append({"case": f"{model} {name} {N}x{K}x{M} forced "
                          f"{_plan_label(plan)}", "layout": "K-major",
                          "path": plan.path, "exact": True,
                          "max_abs_err": 0})
            times[_plan_label(plan)] = _time_cold_ms(call, flush)
    finally:
        gemm_kernel.plan_for = plan_for
    fastest = min(times, key=times.get)
    row = {"phase": "gemm_int8_tilings", "model": model, "engine": name,
           "N": N, "K": K, "M": M, "ms": times,
           "chosen": _plan_label(chosen), "fastest": fastest,
           "chosen_over_fastest": times[_plan_label(chosen)] / times[fastest]}
    emit(row)
    return row


def _gemm_model_shapes(model: str, gen, peaks, flush, cases,
                       max_err) -> dict:
    """Every gemm_int8 shape of one batch of ``model``, bit for bit on both
    layouts, then timed: the kernel on the main path's layouts (patch rows
    of 16-byte multiples, K-major weights: a wgmma path), the first design
    on the same operands with a row-major w (``dp4a_ms``), the plain
    version, one library call, the bound. A bottleneck's last conv adds
    an int8 skip [N, M] whose alignment shifts take both signs (left and
    right shifts onto the accumulators). Returns the per-batch sums, and
    those of the launches that add a skip under ``residual``."""
    _, peak_ops, _, peak_bytes = peaks
    shapes, tilings = [], []
    for name, N, K, M, launches, groups, emit_int32, has_skip in \
            gemm_shapes(model, SERVE_BATCH):
        x = _patch_rows(gen, N, K)
        w_full = _rand_int8(gen, (K, M * groups))
        w = w_full[:, :M]                      # row-major, ld = groups * M
        w_k = k_major_view(w_full)[:, :M]      # group 0 of the K-major copy
        shift = torch.randint(-2, 20, (M,), generator=gen, device="cuda",
                              dtype=torch.int32)
        bias = torch.randint(-2 ** 24, 2 ** 24, (M,), generator=gen,
                             device="cuda", dtype=torch.int32)
        relu = not emit_int32
        skip = {}
        if has_skip:
            res_shift = torch.randint(-8, 12, (M,), generator=gen,
                                      device="cuda", dtype=torch.int32)
            res_shift[:2] = torch.tensor([-8, 11], dtype=torch.int32)
            skip = {"residual": _rand_int8(gen, (N, M)),
                    "res_shift": res_shift}
        path = _compare(cases, max_err, f"{model} {name} {N}x{K}x{M}"
                        + (" skip" if has_skip else ""), x, w, shift, bias,
                        relu, emit_int32, w_k=w_k, **skip)

        def call(ww):
            return lambda: gemm_int8(x, ww, shift, bias, relu=relu,
                                     emit_int32=emit_int32, **skip)
        ms = _time_cold_ms(call(w_k), flush)
        dp4a_ms = _time_cold_ms(call(w), flush)
        plain_ms = _time_cold_ms(lambda: gemm_int8_ref(
            x, w, shift, bias, relu=relu, emit_int32=emit_int32, **skip),
            flush)
        lib = _library_call(x, w, shift, bias, relu, emit_int32, **skip)
        library_ms, library_note = None, None
        if lib is None:
            library_note = "torch._int_mm shape rules exclude this shape"
        else:
            try:
                same = torch.equal(lib(), call(w_k)())
                library_ms = _time_cold_ms(lib, flush)
                library_note = "exact" if same else "differs from kernel"
                if K % 8:
                    library_note += f", K zero-padded to {-(-K // 8) * 8}"
            except RuntimeError as e:       # a yardstick, not the port
                library_note = f"torch._int_mm refused: {e}"[:200]
        ops, nbytes, bound_ms, bound_by = _bound_ms(N, K, M, emit_int32,
                                                    peak_ops, peak_bytes,
                                                    has_skip)
        plan = plan_for(N, K, M, torch.cuda.get_device_properties(
            0).multi_processor_count)
        row = {"phase": "gemm_int8_shape", "model": model, "engine": name,
               "N": N, "K": K, "M": M, "ld_x": x.stride(0),
               "ld_w_k": w_k.stride(1), "launches_per_batch": launches,
               "emit_int32": emit_int32, "skip": has_skip, "path": path,
               "plan": dataclasses.asdict(plan), "ops": ops, "bytes": nbytes,
               "ms": ms, "dp4a_ms": dp4a_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "library": library_note,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "ops_per_s": ops / (ms * 1e-3),
               "bound_share": bound_ms / ms, "exact": True}
        if model == "alexnet":
            row["pr11_ms_recorded"] = PR11_MS[name]
        shapes.append(row)
        emit(row)
        if path == "dp4a":
            raise SmokeFailure(f"{model} {name} took the dp4a path")
        tilings.append(_gemm_tilings(model, name, N, K, M, call(w_k),
                                     call(w_k)(), flush, cases))

    # Per batch: the sum over the model's launches, which run one after
    # another, so the batch's bound is the sum of theirs; it is bound by
    # what bounds the larger part of that sum.
    def per(key, rows=shapes):
        return sum(r[key] * r["launches_per_batch"] for r in rows)
    by_ops = per("bound_ms", [r for r in shapes
                              if r["bound_by"] == "operations"])
    have_lib = all(r["library_ms"] is not None for r in shapes)
    batch = {"launches": sum(r["launches_per_batch"] for r in shapes),
             "ms": per("ms"), "dp4a_ms": per("dp4a_ms"),
             "plain_ms": per("plain_ms"), "bound_ms": per("bound_ms"),
             "bound_by": "operations" if 2 * by_ops >= per("bound_ms")
             else "bytes",
             "library_ms": per("library_ms") if have_lib else None,
             "ops": per("ops"), "tilings": tilings}
    res = [r for r in shapes if r["skip"]]
    if res:
        have_lib = all(r["library_ms"] is not None for r in res)
        batch["residual"] = {
            "launches": sum(r["launches_per_batch"] for r in res),
            **{k: per(k, res) for k in ("ms", "dp4a_ms", "plain_ms",
                                        "bound_ms", "ops")},
            "library_ms": per("library_ms", res) if have_lib else None}
    emit({"phase": "gemm_int8_batch", "model": model, "batch": SERVE_BATCH,
          **{k: v for k, v in batch.items() if k != "tilings"},
          "ops_per_s": batch["ops"] / (batch["ms"] * 1e-3),
          "bound_share": batch["bound_ms"] / batch["ms"]})
    return batch


def phase_gemm(env: dict) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases: list = []
    max_err = [0]
    # The reference's shape sweep (tests/test_kernels.py), plain epilogue.
    for n, k, m in [(17, 40, 33), (128, 128, 128), (300, 100, 260),
                    (1, 9, 1)]:
        x, w = _rand_int8(gen, (n, k)), _rand_int8(gen, (k, m), -50, 50)
        shift = torch.randint(0, 12, (m,), generator=gen, device="cuda",
                              dtype=torch.int32)
        _compare(cases, max_err, f"sweep {n}x{k}x{m}", x, w, shift, None,
                 False, False)
    # emit_int32 / ReLU / biases near +-2^30 / every shift in -31..31.
    x, w = _rand_int8(gen, (70, 333)), _rand_int8(gen, (333, 63))
    shift = torch.arange(-31, 32, dtype=torch.int32, device="cuda")
    bias = torch.randint(-2 ** 30, 2 ** 30, (63,), generator=gen,
                         device="cuda", dtype=torch.int32)
    bias[:8] = torch.tensor([2 ** 30, -(2 ** 30), 2 ** 30 - 1,
                             -(2 ** 30) + 1, 0, 1, -1, 2 ** 29],
                            dtype=torch.int32)
    for relu in (False, True):
        for emit_int32 in (False, True):
            _compare(cases, max_err, f"epilogue relu={relu} "
                     f"emit_int32={emit_int32}", x, w, shift, bias, relu,
                     emit_int32)
    rx, rw, rshift, rbias = _rails_case()
    for relu in (False, True):
        for emit_int32 in (False, True):
            _compare(cases, max_err, f"int32 rails relu={relu} "
                     f"emit_int32={emit_int32}", rx, rw, rshift, rbias,
                     relu, emit_int32)
    for ww in (rw, k_major_view(rw)):
        rails = gemm_int8(rx, ww, rshift, rbias, emit_int32=True)
        i32 = torch.iinfo(torch.int32)
        if int(rails[0, 0]) != i32.max or int(rails[0, 63]) != i32.min:
            raise SmokeFailure("the rails case does not reach INT32_MAX/MIN")
    # The wgmma paths' edges, on patch rows of 16-byte multiples.
    for label, n, k, m in GEMM_EDGES:
        x, w = _patch_rows(gen, n, k), _rand_int8(gen, (k, m))
        shift = torch.randint(-4, 16, (m,), generator=gen, device="cuda",
                              dtype=torch.int32)
        bias = torch.randint(-2 ** 24, 2 ** 24, (m,), generator=gen,
                             device="cuda", dtype=torch.int32)
        for relu, emit_int32 in ((True, False), (False, True)):
            _compare(cases, max_err, f"edge {label} relu={relu} "
                     f"emit_int32={emit_int32}", x, w, shift, bias, relu,
                     emit_int32)

    # Every shape of one batch of AlexNet, VGG16 and ResNet-50, checked
    # and timed.
    peaks = card_peaks(env["device"])
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    batches = {model: _gemm_model_shapes(model, gen, peaks, flush, cases,
                                         max_err)
               for model in GEMM_MODELS}
    del flush
    emit({"phase": "gemm_int8_vs_plain", "cases": len(cases),
          "all_exact": all(c["exact"] for c in cases),
          "max_abs_err": max_err[0],
          "paths": {p: sum(c["path"] == p for c in cases) for p in
                    gemm_kernel.PATHS},
          "failed": [c["case"] for c in cases if not c["exact"]]})
    for b in batches.values():
        b["max_abs_err"] = max_err[0]
    return batches


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------


def _program_on_cpu(prog):
    steps = [dataclasses.replace(
        s, wq=None if s.wq is None else s.wq.cpu(),
        wk=None if s.wk is None else s.wk.cpu(),
        bias_q=None if s.bias_q is None else s.bias_q.cpu(),
        shift=None if s.shift is None else s.shift.cpu(),
        skip_shift=None if s.skip_shift is None else s.skip_shift.cpu())
        for s in prog.steps]
    return dataclasses.replace(prog, steps=steps, device=torch.device("cpu"))


def phase_main_path() -> dict:
    reset_launches()
    result = serve("alexnet", frames=SERVE_FRAMES, batch=SERVE_BATCH,
                   output="logits", device="cuda", verbose=False,
                   return_outputs=True)
    torch.cuda.synchronize()
    launches = gemm_int8.launches
    by_path = dict(gemm_int8.launches_by_path)
    if flash_attention.launches:
        raise SmokeFailure("the AlexNet path launched flash_attention")
    served = result.pop("outputs")
    expect = 11 * result["batches"]
    # Per batch: conv1-conv5 (8 launches, two groups on conv2, 4, 5) on
    # the large-N kernels, fc6-fc8 on the small-N one, none on dp4a.
    expect_paths = {"large_n": 8 * result["batches"],
                    "small_n": 3 * result["batches"], "dp4a": 0}
    emit({"phase": "serve", **result, "gemm_int8_launches": launches,
          "launches_by_path": by_path, "expected_launches": expect,
          "expected_by_path": expect_paths})
    if result["route"] != "kernel" or launches != expect \
            or by_path != expect_paths:
        raise SmokeFailure(f"the served path ran route {result['route']} "
                           f"with {launches} gemm_int8 launches "
                           f"({by_path}), expected the kernel route with "
                           f"{expect} ({expect_paths})")

    # Every served frame against the oracle route of the same seeded
    # program on the same frames. The logits of distinct frames differ,
    # so a batch staged, ordered or padded wrongly shows here even where
    # the random model gives most frames one top-1 class.
    prog = compile_for_serving("alexnet", seed=0, device="cuda")
    stream = synthetic_stream("alexnet", SERVE_FRAMES, 0)
    oracle = prog.compile_runner(route="oracle")
    want = np.concatenate([oracle.logits(stream[i:i + SERVE_BATCH])
                           for i in range(0, SERVE_FRAMES, SERVE_BATCH)])
    served_check = {
        "phase": "served_vs_oracle", "frames": len(served),
        "shape": list(served.shape),
        "exact": served.shape == want.shape and bool(
            np.array_equal(served, want)),
        "max_abs_err": float(np.abs(served - want).max())
        if served.shape == want.shape else None,
        "finite": bool(np.isfinite(served).all()),
        "distinct_frames": len(np.unique(served, axis=0)),
        "distinct_top1": len(np.unique(served.argmax(-1)))}
    emit(served_check)
    if not (served_check["exact"] and served_check["finite"]
            and served_check["distinct_frames"] == SERVE_FRAMES):
        raise SmokeFailure(f"served outputs check failed: {served_check}")

    # One batch through every route on the card.
    frames = stream[:SERVE_BATCH]
    accs, top1 = {}, {}
    for route in ROUTES:
        runner = prog.compile_runner(route=route)
        acc = runner(runner.quantize(frames))
        torch.cuda.synchronize()
        accs[route] = acc
        top1[route] = np.argmax(runner.dequantize(acc), axis=-1)
    kernel_acc = accs["kernel"]
    logits = prog.compile_runner().dequantize(kernel_acc)
    routes_identical = all(torch.equal(kernel_acc, accs[r]) for r in ROUTES)
    top1_identical = all(np.array_equal(top1["kernel"], top1[r])
                         for r in ROUTES)
    # The plain integer oracle on the CPU, on two frames of the same batch.
    cpu_prog = _program_on_cpu(prog)
    cpu_runner = cpu_prog.compile_runner(route="oracle")
    cpu_acc = cpu_runner(cpu_runner.quantize(frames[:2]))
    matches_cpu = torch.equal(cpu_acc, kernel_acc[:2].cpu())
    served_top1 = [int(t) for t in top1["kernel"][:4]]
    check = {"phase": "routes", "batch": SERVE_BATCH,
             "acc_shape": list(kernel_acc.shape),
             "acc_dtype": str(kernel_acc.dtype),
             "routes_identical_int32": routes_identical,
             "top1_identical": top1_identical,
             "kernel_matches_cpu_oracle": matches_cpu,
             "logits_finite": bool(np.isfinite(logits).all()),
             "top1_matches_served": served_top1 == result["sample_top1"],
             "top1": [int(t) for t in top1["kernel"]]}
    emit(check)
    ok = (routes_identical and top1_identical and matches_cpu
          and check["logits_finite"] and check["top1_matches_served"]
          and check["acc_shape"] == [SERVE_BATCH, 1000]
          and kernel_acc.dtype == torch.int32)
    if not ok:
        raise SmokeFailure(f"route check failed: {check}")
    phase_breakdown(prog, frames)
    return {"launches": launches}


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


PROFILE_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]


def _device_ops(fn) -> list:
    """(kernel name, device µs, launches) of one profiled, synchronised
    call of ``fn``, largest first. Kernels only: an aten op's own row
    repeats the device time of the kernels it launched, so summing every
    row would count them twice."""
    with torch.profiler.profile(activities=PROFILE_ACTIVITIES) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(((e.key, _device_us(e), e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and _device_us(e) > 0
                   and not e.key.startswith("Activity Buffer")),
                  key=lambda kv: -kv[1])


def _is_gemm_int8(kernel_name: str) -> bool:
    """Whether a profiled kernel is one of gemm_int8's."""
    return "gemm_wgmma" in kernel_name or "gemm_int8_kernel" in kernel_name


def phase_breakdown(prog, frames) -> None:
    """Where one batch's time goes on the default route: a warm
    ``EngineExecutor``'s time per batch over 16 batches, beside the host's
    batch assembly (``np.stack``), quantize-in and dequantize/argmax, the
    host enqueue time and wall time of the chain alone, and the device
    time by kernel from ``torch.profiler`` (one profiled chain; its idle
    share is taken against the unprofiled wall time). What the parts do
    not cover of the executor's batch is reported as unattributed."""
    runner = prog.compile_runner()
    stream = synthetic_stream("alexnet", 16 * len(frames), 1)
    ex = EngineExecutor(prog, batch_size=len(frames))
    ex.serve(stream)
    executor_ms = 1e3 * len(frames) / ex.stats.steady_fps
    n = 20
    rows = list(frames)
    t0 = time.perf_counter()
    for _ in range(n):
        np.stack(rows)
    stack_ms = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        xq_host = runner.quantize(frames)
    quantize_ms = (time.perf_counter() - t0) / n * 1e3
    xq = torch.as_tensor(xq_host, device="cuda")
    acc = runner(xq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        np.argmax(runner.dequantize(acc), axis=-1)
    decode_ms = (time.perf_counter() - t0) / n * 1e3
    for _ in range(3):
        runner(xq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        runner(xq)
    enqueue_ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    # Host time of one gemm_int8 call (checks, plan, allocation, tensor
    # maps, ctypes launch), at fc8's shape, without waiting for the card:
    # on the main path's K-major weights (the small-N kernel) and
    # on the reference layout (the dp4a kernel), in turns.
    fc8 = prog.steps[-1]
    x8 = torch.zeros((len(frames), fc8.wq.shape[0]), dtype=torch.int8,
                     device="cuda")
    host_us: dict = {"small_n": [], "dp4a": []}
    calls = 100
    for _ in range(5):
        for path, w8 in (("small_n", fc8.wk), ("dp4a", fc8.wq)):
            gemm_int8(x8, w8, fc8.shift, fc8.bias_q, emit_int32=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                gemm_int8(x8, w8, fc8.shift, fc8.bias_q, emit_int32=True)
            host_us[path].append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    gemm_host_us = float(np.median(host_us["small_n"]))
    dp4a_host_us = float(np.median(host_us["dp4a"]))
    ops = _device_ops(lambda: runner(xq))
    device_ms = sum(us for _, us, _ in ops) / 1e3
    gemm_ms = sum(us for k, us, _ in ops if _is_gemm_int8(k)) / 1e3
    emit({"phase": "breakdown", "route": runner.route, "batch": len(frames),
          "executor_ms_per_batch": executor_ms,
          "executor_steady_fps": ex.stats.steady_fps,
          "executor_batches": ex.stats.batches,
          "unattributed_ms": executor_ms - (stack_ms + quantize_ms
                                            + wall_ms + decode_ms),
          "host_stack_ms": stack_ms,
          "host_quantize_ms": quantize_ms, "host_decode_ms": decode_ms,
          "host_enqueue_ms": enqueue_ms, "wall_ms": wall_ms,
          "gemm_int8_host_us_per_call": gemm_host_us,
          "gemm_int8_host_us_per_call_dp4a": dp4a_host_us,
          "gemm_int8_host_us_over_dp4a": gemm_host_us - dp4a_host_us,
          "device_busy_ms": device_ms, "gemm_int8_ms": gemm_ms,
          "other_device_ms": device_ms - gemm_ms,
          "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
          "top_device_ops_us": [[k[:60], round(us, 1)]
                                for k, us, _ in ops[:6]]})


def phase_vgg16() -> dict:
    """Full-width VGG16 (seed 0) on one batch of 16 frames: the kernel
    route with its launches counted (13 convs on the large-N kernels, the
    3 fc layers on the small-N one, none on dp4a) and its int32
    accumulators equal to the oracle and f32 routes'; the chain's wall
    time, device time by kernel and idle share."""
    prog = compile_for_serving("vgg16", seed=0, device="cuda")
    frames = synthetic_stream("vgg16", SERVE_BATCH, 0)
    kernel = prog.compile_runner(route="kernel")
    xq = torch.as_tensor(kernel.quantize(frames), device="cuda")
    reset_launches()
    acc = kernel(xq)
    torch.cuda.synchronize()
    launches, by_path = gemm_int8.launches, dict(gemm_int8.launches_by_path)
    expect = {"large_n": 13, "small_n": 3, "dp4a": 0}
    accs = {"kernel": acc}
    for route in ("oracle", "f32"):
        accs[route] = prog.compile_runner(route=route)(xq)
        torch.cuda.synchronize()
    identical = all(torch.equal(acc, a) for a in accs.values())
    logits = kernel.dequantize(acc)
    n = 5
    for _ in range(2):
        kernel(xq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        kernel(xq)
    enqueue_ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    ops = _device_ops(lambda: kernel(xq))
    device_ms = sum(us for _, us, _ in ops) / 1e3
    gemm_ms = sum(us for k, us, _ in ops if _is_gemm_int8(k)) / 1e3
    row = {"phase": "vgg16", "batch": SERVE_BATCH,
           "acc_shape": list(acc.shape), "acc_dtype": str(acc.dtype),
           "routes_identical_int32": identical,
           "logits_finite": bool(np.isfinite(logits).all()),
           "distinct_top1": len(np.unique(logits.argmax(-1))),
           "gemm_int8_launches": launches, "launches_by_path": by_path,
           "expected_by_path": expect, "host_enqueue_ms": enqueue_ms,
           "wall_ms": wall_ms, "device_busy_ms": device_ms,
           "gemm_int8_ms": gemm_ms, "other_device_ms": device_ms - gemm_ms,
           "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
           "top_device_ops_us": [[k[:60], round(us, 1)]
                                 for k, us, _ in ops[:6]]}
    emit(row)
    if not (identical and row["logits_finite"] and by_path == expect
            and launches == 16 and row["acc_shape"] == [SERVE_BATCH, 1000]
            and acc.dtype == torch.int32):
        raise SmokeFailure(f"VGG16 check failed: {row}")
    return {"launches": launches}


# ResNet-50 v1.5 a batch: 53 convs on the large-N kernels (16 of them
# adding their bottleneck's skip), the fc on the small-N one.
RESNET_PATHS = {"large_n": 53, "small_n": 1, "dp4a": 0}
RESNET_SKIPS = 16
# Frames of the batch the plain version runs on the CPU.
RESNET_CPU_FRAMES = 2


def phase_resnet50(gemm: dict) -> dict:
    """Full-width ResNet-50 v1.5 (seed 0) on one batch of 16 frames: the
    kernel route with its launches counted (``RESNET_PATHS``, and 16 that
    add the skip: ``residual_launches``), its int32 accumulators equal to
    the oracle and f32 routes' on the card and, on two frames, to the
    kernel route's plain version (``gemm_int8_ref``) run on the CPU; the
    chain's wall time, device time by kernel and idle share, beside the
    skip-adding launches' kernel, plain, library and bound times from
    phase 2's ``gemm_int8_shape`` lines."""
    prog = compile_for_serving("resnet50", seed=0, device="cuda")
    frames = synthetic_stream("resnet50", SERVE_BATCH, 0)
    kernel = prog.compile_runner(route="kernel")
    xq = torch.as_tensor(kernel.quantize(frames), device="cuda")
    reset_launches()
    acc = kernel(xq)
    torch.cuda.synchronize()
    launches, by_path = gemm_int8.launches, dict(gemm_int8.launches_by_path)
    skips = gemm_int8.residual_launches
    accs = {"kernel": acc}
    for route in ("oracle", "f32"):
        accs[route] = prog.compile_runner(route=route)(xq)
        torch.cuda.synchronize()
    identical = all(torch.equal(acc, a) for a in accs.values())
    cpu = _program_on_cpu(prog).compile_runner(route="kernel")
    plain = cpu(xq[:RESNET_CPU_FRAMES].cpu())
    matches_plain = torch.equal(plain, acc[:RESNET_CPU_FRAMES].cpu())
    logits = kernel.dequantize(acc)
    n = 5
    for _ in range(2):
        kernel(xq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        kernel(xq)
    enqueue_ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    ops = _device_ops(lambda: kernel(xq))
    device_ms = sum(us for _, us, _ in ops) / 1e3
    gemm_ms = sum(us for k, us, _ in ops if _is_gemm_int8(k)) / 1e3
    row = {"phase": "resnet50", "batch": SERVE_BATCH,
           "acc_shape": list(acc.shape), "acc_dtype": str(acc.dtype),
           "routes_identical_int32": identical,
           "kernel_matches_cpu_plain": matches_plain,
           "cpu_plain_frames": RESNET_CPU_FRAMES,
           "logits_finite": bool(np.isfinite(logits).all()),
           "distinct_top1": len(np.unique(logits.argmax(-1))),
           "gemm_int8_launches": launches, "launches_by_path": by_path,
           "expected_by_path": RESNET_PATHS, "residual_launches": skips,
           "expected_residual_launches": RESNET_SKIPS,
           "host_enqueue_ms": enqueue_ms, "wall_ms": wall_ms,
           "device_busy_ms": device_ms, "gemm_int8_ms": gemm_ms,
           "other_device_ms": device_ms - gemm_ms,
           "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
           "top_device_ops_us": [[k[:60], round(us, 1)]
                                 for k, us, _ in ops[:6]],
           "gemm_int8_batch_cold": {k: gemm["resnet50"][k] for k in (
               "launches", "ms", "plain_ms", "library_ms", "bound_ms")},
           "gemm_int8_skip_launches_cold": gemm["resnet50"]["residual"]}
    emit(row)
    if not (identical and matches_plain and row["logits_finite"]
            and by_path == RESNET_PATHS and skips == RESNET_SKIPS
            and launches == sum(RESNET_PATHS.values())
            and gemm["resnet50"]["residual"]["launches"] == RESNET_SKIPS
            and row["acc_shape"] == [SERVE_BATCH, 1000]
            and acc.dtype == torch.int32):
        raise SmokeFailure(f"ResNet-50 check failed: {row}")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Phase 3b: the layer-pipelined serving path (stage partition, stage
# workers, async frontend, replica pool)
# ---------------------------------------------------------------------------


def _paths_per_batch(by_path: dict, batches: int) -> dict:
    return {p: n / batches for p, n in by_path.items()} if batches else {}


def _stage_ms_per_batch(ex) -> list | None:
    """Each stage's busy time per batch over the turns (its launches plus
    the wait on its event; a pool's replicas summed by stage), or None
    for the single executor."""
    reps = getattr(ex, "replicas", [ex])
    if not hasattr(reps[0], "stage_busy_s"):
        return None
    batches = sum(r.stats.batches for r in reps)
    busy = [sum(r.stage_busy_s[i] for r in reps)
            for i in range(len(reps[0].stage_busy_s))]
    return [1e3 * b / batches for b in busy]


def _pipeline_turns(prog, stream) -> dict:
    """Closed-loop fps of the single executor and of every pipelined
    config, measured in turns on the same warm executors: ``PIPE_ROUNDS``
    rounds, each timing one pass over ``stream`` per executor (host
    clock around ``serve``, which returns once every output is on the
    host), the order reversed every other round. Then one pass each
    under ``torch.profiler`` for the device's busy time, against the
    median unprofiled wall: the idle share. Each pipelined config also
    reports its stages' busy time per batch over the turns. Launches made
    here are not counted (the counts were read before)."""
    from statistics import median
    frames = list(stream)
    exs = {"single": EngineExecutor(prog, batch_size=SERVE_BATCH)}
    try:
        for k, r in PIPE_CONFIGS:
            exs[f"K{k}R{r}"] = ex = make_executor(
                prog, stages=k, batch=SERVE_BATCH, route=None,
                output="top1", replicas=r)
            ex.start()
        walls = {name: [] for name in exs}
        for ex in exs.values():
            ex.serve(frames[:2 * SERVE_BATCH])           # warm every stage
            ex.reset_stats()
        for rnd in range(PIPE_ROUNDS):
            order = list(exs) if rnd % 2 == 0 else list(exs)[::-1]
            for name in order:
                t0 = time.perf_counter()
                exs[name].serve(frames)
                walls[name].append(time.perf_counter() - t0)
        rows = {}
        for name, ex in exs.items():
            stage_ms = _stage_ms_per_batch(ex)
            ops = _device_ops(lambda: ex.serve(frames))
            busy_ms = sum(us for _, us, _ in ops) / 1e3
            wall_ms = 1e3 * median(walls[name])
            fps = sorted(len(frames) / w for w in walls[name])
            rows[name] = {"fps_median": median(fps), "fps_min": fps[0],
                          "fps_max": fps[-1], "fps": fps,
                          "device_busy_ms_per_batch":
                              busy_ms * SERVE_BATCH / len(frames),
                          "device_idle_share": max(0.0,
                                                   1.0 - busy_ms / wall_ms),
                          "stage_ms_per_batch": stage_ms}
    finally:
        for ex in exs.values():
            close = getattr(ex, "close", None)
            if close is not None:
                close()
    return rows


class _CaptureAcc:
    """A last-stage runner that keeps the raw int32 accumulators the
    collector receives before dequantizing them (in batch order: the
    collector is FIFO)."""

    def __init__(self, runner):
        self.runner = runner
        self.accs: list = []

    def __call__(self, x):
        return self.runner(x)

    def __getattr__(self, attr):
        return getattr(self.runner, attr)

    def dequantize(self, acc):
        self.accs.append(acc.clone())
        return self.runner.dequantize(acc)


def _vgg16_pipeline() -> list:
    """Full-width VGG16 through ``PipelineExecutor`` at each K of
    ``VGG_PIPE_STAGES``: the int32 accumulators every batch reaches the
    collector with equal the whole chain's (``compile_runner``) and the
    oracle route's on the same frames, and each batch launches 13
    ``large_n`` + 3 ``small_n`` kernels summed over the stages."""
    prog = compile_for_serving("vgg16", seed=0, device="cuda")
    n = VGG_PIPE_BATCHES * SERVE_BATCH
    frames = synthetic_stream("vgg16", n, 0)
    whole = prog.compile_runner(route="kernel")
    oracle = prog.compile_runner(route="oracle")
    batches = [frames[i:i + SERVE_BATCH] for i in range(0, n, SERVE_BATCH)]
    want = [whole(whole.quantize(b)) for b in batches]
    want_oracle = [oracle(oracle.quantize(b)) for b in batches]
    torch.cuda.synchronize()
    if not all(torch.equal(w, o) for w, o in zip(want, want_oracle)):
        raise SmokeFailure("VGG16's whole chain disagrees with the oracle "
                           "route on the pipeline's frames")
    del want_oracle
    rows = []
    for k in VGG_PIPE_STAGES:
        px = PipelineExecutor(prog, stages=k, batch_size=SERVE_BATCH,
                              output="logits")
        cap = px.runners[-1] = _CaptureAcc(px.runners[-1])
        try:
            reset_launches()
            px.serve(list(frames))
            torch.cuda.synchronize()
            by_path = dict(gemm_int8.launches_by_path)
        finally:
            px.close()
        expect = {"large_n": 13 * VGG_PIPE_BATCHES,
                  "small_n": 3 * VGG_PIPE_BATCHES, "dp4a": 0}
        identical = len(cap.accs) == len(want) and all(
            a.dtype == torch.int32 and torch.equal(a, w)
            for a, w in zip(cap.accs, want))
        row = {"phase": "pipeline_vgg16", "stages": k,
               "boundaries": list(px.partition.boundaries),
               "stage_cycles": list(px.partition.stage_cycles),
               "stage_balance": px.partition.balance, "route": px.route,
               "batches": len(cap.accs), "launches_by_path": by_path,
               "expected_by_path": expect,
               "int32_identical_to_whole_chain": identical,
               "whole_chain_identical_to_oracle": True,
               "stage_busy_ms": [1e3 * t for t in px.stage_busy_s]}
        emit(row)
        if not (identical and by_path == expect and px.route == "kernel"):
            raise SmokeFailure(f"VGG16 pipeline check failed: {row}")
        rows.append(row)
    return rows


def phase_pipeline() -> dict:
    """Full-width AlexNet (batch 16, seed 0, the default route) served
    through ``serve_async`` at K = 1, 2 and 4 stages and through the
    replica pool at R = 2, K = 2, on the one card: partition, steady fps
    beside the single executor's in the same run, the open-loop p50, p95
    and p99, launches by path (8 ``large_n`` + 3 ``small_n`` a batch
    summed over the stages, no ``dp4a``), every served frame's top-1
    (and on one pass its logits) identical to the single executor's and
    the oracle route's; then
    the closed-loop fps of the single executor and every config in turns
    on one warm set of executors, with the device's idle share (line
    ``pipeline_turns``). Then full-width VGG16
    through ``PipelineExecutor`` at K = 2 and 4 (int32 identical to the
    whole chain), and ``simulate()`` for the four paper models beside
    ``program.fps()`` (no device work)."""
    single = serve("alexnet", frames=PIPE_FRAMES, batch=SERVE_BATCH,
                   output="logits", device="cuda", verbose=False,
                   return_outputs=True)
    base = single.pop("outputs")
    base_top1 = base.argmax(-1)
    # The oracle route of the same seeded program on the same frames: the
    # single executor and every pipelined config are held against it too.
    prog = compile_for_serving("alexnet", seed=0, device="cuda")
    stream = synthetic_stream("alexnet", PIPE_FRAMES, 0)
    oracle = prog.compile_runner(route="oracle")
    want = np.concatenate([oracle.logits(stream[i:i + SERVE_BATCH])
                           for i in range(0, PIPE_FRAMES, SERVE_BATCH)])
    single_row = {"phase": "pipeline_single_executor",
                  "measured_steady_fps": single["measured_steady_fps"],
                  "frames": single["frames"], "batches": single["batches"],
                  "logits_identical_to_oracle": bool(
                      np.array_equal(base, want))}
    emit(single_row)
    if not single_row["logits_identical_to_oracle"]:
        raise SmokeFailure(f"single executor disagrees with the oracle "
                           f"route: {single_row}")
    launches, rows = 0, []
    for k, r in PIPE_CONFIGS:
        logits = (k, r) == PIPE_LOGITS
        reset_launches()
        res = serve_async("alexnet", frames=PIPE_FRAMES, batch=SERVE_BATCH,
                          stages=k, replicas=r, program=prog,
                          output="logits" if logits else "top1",
                          verbose=False, return_outputs=True)
        torch.cuda.synchronize()
        by_path = dict(gemm_int8.launches_by_path)
        count = gemm_int8.launches
        outs = res.pop("outputs")
        res.pop("replica_rows", None)
        n = res["batches_run"]
        expect = {"large_n": 8 * n, "small_n": 3 * n, "dp4a": 0}
        top1 = outs.argmax(-1) if logits else outs
        row = {"phase": "pipeline", "config": f"K{k}R{r}", **res,
               "single_executor_steady_fps":
                   single["measured_steady_fps"],
               "gemm_int8_launches": count,
               "launches_by_path": by_path, "expected_by_path": expect,
               "launches_per_batch": _paths_per_batch(by_path, n),
               "top1_identical": bool(np.array_equal(top1, base_top1)),
               "top1_identical_to_oracle": bool(
                   np.array_equal(top1, want.argmax(-1))),
               "logits_identical": (bool(np.array_equal(outs, base))
                                    if logits else None),
               "logits_identical_to_oracle": (
                   bool(np.array_equal(outs, want)) if logits else None)}
        emit(row)
        ok = (res["route"] == "kernel" and by_path == expect
              and row["top1_identical"]
              and row["top1_identical_to_oracle"]
              and row["logits_identical"] is not False
              and row["logits_identical_to_oracle"] is not False
              and res["stages"] == k and res["replicas"] == r
              and len(outs) == PIPE_FRAMES)
        if not ok:
            raise SmokeFailure(f"pipelined AlexNet check failed: {row}")
        launches += count
        rows.append(row)
    turns = _pipeline_turns(
        prog, synthetic_stream("alexnet", PIPE_TURN_FRAMES, 1))
    emit({"phase": "pipeline_turns", "frames": PIPE_TURN_FRAMES,
          "rounds": PIPE_ROUNDS, "configs": turns})
    del prog
    torch.cuda.empty_cache()
    vgg = _vgg16_pipeline()
    sims = []
    for name in ("alexnet", "vgg16", "zf", "yolo"):
        m = CNN_MODELS[name]()
        plan = compile_model(m, theta=2 * 900 - len(m.layers),
                             bram_total=None, device="cpu")
        sim = simulate(plan, n_frames=3)
        sims.append({"model": name, "gop": plan.gop,
                     "modeled_fps_alg1": plan.fps(),
                     "simulated_fps": plan.freq_hz / sim.steady_cycles,
                     "simulated_frame_cycles": sim.frame_cycles,
                     "simulated_steady_cycles": sim.steady_cycles,
                     "dsp_efficiency": sim.dsp_efficiency})
    emit({"phase": "pipeline_simulator", "models": sims})
    return {"launches": launches, "rows": rows, "turns": turns,
            "vgg16": vgg, "batches": sum(r["batches_run"] for r in rows),
            "vgg16_launches": sum(sum(r["launches_by_path"].values())
                                  for r in vgg)}


# ---------------------------------------------------------------------------
# Phase 3c: bits=16, the exact integer engine on the card
# ---------------------------------------------------------------------------


def _steps_through(prog, xq) -> list:
    """One batch through each step of ``prog`` in turn (a stage runner a
    step), every step's output kept: the int16 activations and the last
    engine's int64 accumulators."""
    outs, x = [], xq
    for i in range(len(prog.steps)):
        x = prog.compile_stage_runner(i, i + 1)(x)
        outs.append(x)
    return outs


def phase_bits16() -> dict:
    """Full-width AlexNet at bits=16 (seed 0, batch 16) on the card, on its
    one route (the exact integer oracle: int16 activations, int64
    accumulators from float64 GEMMs over int16 patches): every step's
    output of one batch, and the final accumulators of every batch through
    ``EngineExecutor`` and a K = 2 ``PipelineExecutor``, equal the same
    program run on the CPU in this process, bit for bit (the host-to-card
    staging rings carry int16). The kernel and f32 routes raise
    ``NotImplementedError``; no ``gemm_int8`` launches. Wall and device
    busy ms per batch."""
    t_phase = time.perf_counter()
    prog = compile_for_serving("alexnet", bits=16, seed=0, device="cuda")
    cpu = _program_on_cpu(prog)
    frames = synthetic_stream("alexnet", BITS16_FRAMES, 0)
    batches = [frames[i:i + SERVE_BATCH]
               for i in range(0, BITS16_FRAMES, SERVE_BATCH)]
    runner, runner_cpu = prog.compile_runner(), cpu.compile_runner()
    refused = {}
    for route in ("kernel", "f32"):
        try:
            prog.compile_runner(route=route)
            refused[route] = False
        except NotImplementedError:
            refused[route] = True
    reset_launches()
    xq = runner.quantize(batches[0])
    steps_card = [t.cpu() for t in _steps_through(
        prog, torch.as_tensor(xq, device="cuda"))]
    steps_cpu = _steps_through(cpu, torch.from_numpy(xq))
    steps_equal = [bool(torch.equal(a, b))
                   for a, b in zip(steps_card, steps_cpu)]
    want = [runner_cpu(runner_cpu.quantize(b)) for b in batches]
    ex = EngineExecutor(prog, batch_size=SERVE_BATCH, output="logits")
    ex.runner = cap_ex = _CaptureAcc(ex.runner)
    ex_logits = np.stack(ex.serve(list(frames)))
    px = PipelineExecutor(prog, stages=2, batch_size=SERVE_BATCH,
                          output="logits")
    px.runners[-1] = cap_px = _CaptureAcc(px.runners[-1])
    try:
        px_logits = np.stack(px.serve(list(frames)))
    finally:
        px.close()
    torch.cuda.synchronize()
    launched = gemm_int8.launches

    def same(accs) -> bool:
        return len(accs) == len(want) and all(
            a.dtype == torch.int64 and torch.equal(a.cpu(), w)
            for a, w in zip(accs, want))
    want_logits = np.concatenate([runner_cpu.dequantize(w) for w in want])
    # Time: a warm executor's batch (host included), the chain's wall,
    # and the device's busy time under the profiler.
    served = serve("alexnet", frames=4 * BITS16_FRAMES, batch=SERVE_BATCH,
                   bits=16, output="logits", device="cuda", verbose=False)
    xq_dev = torch.as_tensor(xq, device="cuda")
    runner(xq_dev)
    torch.cuda.synchronize()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        runner(xq_dev)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    ops = _device_ops(lambda: runner(xq_dev))
    busy_ms = sum(us for _, us, _ in ops) / 1e3
    row = {"phase": "bits16", "model": "alexnet", "batch": SERVE_BATCH,
           "frames": BITS16_FRAMES, "route": runner.route,
           "refused_routes": refused,
           "step_dtypes": [str(t.dtype) for t in steps_card],
           "steps_identical_to_cpu": steps_equal,
           "runner_acc_identical_to_cpu": bool(
               torch.equal(steps_card[-1], want[0])),
           "executor_acc_identical_to_cpu": same(cap_ex.accs),
           "pipeline_k2_acc_identical_to_cpu": same(cap_px.accs),
           "executor_logits_identical": bool(
               np.array_equal(ex_logits, want_logits)),
           "pipeline_logits_identical": bool(
               np.array_equal(px_logits, want_logits)),
           "pipeline_boundaries": list(px.partition.boundaries),
           "gemm_int8_launches": launched,
           "logits_finite": bool(np.isfinite(want_logits).all()),
           "max_abs_acc": int(max(int(w.abs().max()) for w in want)),
           "serve_route": served["route"],
           "serve_steady_fps": served["measured_steady_fps"],
           "executor_wall_ms_per_batch":
               1e3 * SERVE_BATCH / served["measured_steady_fps"],
           "chain_wall_ms_per_batch": wall_ms,
           "device_busy_ms_per_batch": busy_ms,
           "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
           "top_device_ops_us": [[k[:60], round(us, 1)]
                                 for k, us, _ in ops[:6]],
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    ok = (all(refused.values()) and all(steps_equal)
          and row["runner_acc_identical_to_cpu"]
          and row["executor_acc_identical_to_cpu"]
          and row["pipeline_k2_acc_identical_to_cpu"]
          and row["executor_logits_identical"]
          and row["pipeline_logits_identical"] and launched == 0
          and row["logits_finite"] and runner.route == "oracle"
          and served["route"] == "oracle"
          and row["step_dtypes"][-1] == "torch.int64"
          and set(row["step_dtypes"][:-1]) == {"torch.int16"})
    if not ok:
        raise SmokeFailure(f"bits=16 check failed: {row}")
    return row


# ---------------------------------------------------------------------------
# Phase 3d: chaos and the elastic runtime (bits=8, the kernel route)
# ---------------------------------------------------------------------------


def phase_chaos_elastic() -> dict:
    """Full-width AlexNet (bits=8, seed 0, batch 16, the kernel route):
    two K = 2 pipeline replicas behind the frontend at twice one
    replica's rate, one killed mid-stream by ``ChaosExecutor`` (every
    request resolves completed or failed, none hangs, the survivor
    carries the stream, ``recovery_report``); then
    ``serve_knee_rescale`` (a load ramp while the elastic controller
    watches, a live drain-swap-resume to R = 2; ``hung == 0``). Every
    served frame's top-1 equals the single executor's on that frame. The
    ``gemm_int8`` launches of both runs are counted by path (counts set
    to 0 just before, read just after; the single executor's reference
    run is outside)."""
    t_phase = time.perf_counter()
    prog = compile_for_serving("alexnet", seed=0, device="cuda")
    stream = synthetic_stream("alexnet", CHAOS_FRAMES, 0)
    single = EngineExecutor(prog, batch_size=SERVE_BATCH)
    base_top1 = np.asarray(single.serve(list(stream)))
    knee_stream = synthetic_stream("alexnet", KNEE_FRAMES, 0)
    knee_top1 = np.asarray(single.serve(list(knee_stream)))
    torch.cuda.synchronize()

    reset_launches()
    reps = [PipelineExecutor(prog, stages=2, batch_size=SERVE_BATCH)
            for _ in range(2)]
    for r in reps:
        r.serve(list(stream[:2 * SERVE_BATCH]))     # build and warm
    # One warm replica's closed-loop batch time, which sets the pace.
    t0 = time.perf_counter()
    reps[1].serve(list(stream[:4 * SERVE_BATCH]))
    svc = (time.perf_counter() - t0) / 4
    victim = ChaosExecutor(reps[0], FaultPlan(kill_at_batch=CHAOS_KILL_AT))
    pool = ReplicaPool(executors=[victim, reps[1]], router_seed=0,
                       quarantine_after=2, probe_every=4)
    pool.router.warm_start(svc, 2.0 * svc)
    # An hour a batch for the survivor until it has served one: every
    # batch goes to the victim until the victim's kill and quarantine.
    pool.router.estimators[1].warm_start(pool.router.batch_key, 3600.0)
    fe = AsyncFrontend(pool, max_wait_ms=20.0, max_queue=4096)
    mix = (TrafficClass("rt", priority=1, deadline_ms=5000.0),)
    rate = CHAOS_LOAD * SERVE_BATCH / svc
    sched, _ = make_scenario_schedule("uniform", CHAOS_FRAMES, rate, mix,
                                      seed=5)
    t0 = time.perf_counter()
    reqs = replay(fe, list(stream), sched, raise_failed=False)
    chaos_s = time.perf_counter() - t0
    fe.close()
    pool.close()
    st = fe.stats
    ok_top1 = all(int(r.result(timeout=0)) == int(base_top1[a.frame_idx])
                  for a, r in zip(sched, reqs) if r.outcome == "completed")
    rec = recovery_report(reqs, fault_t0=victim.t_first_fault,
                          window_s=0.05, miss_target=0.1)
    counts = pool.replica_counts()
    chaos_row = {"phase": "chaos", "model": "alexnet", "replicas": 2,
                 "stages": 2, "kill_at_batch": CHAOS_KILL_AT,
                 "replica_batch_ms": 1e3 * svc,
                 "arrival_fps": rate, "seconds": chaos_s,
                 "submitted": st.submitted, "completed": st.completed,
                 "failed": st.failed, "expired": st.expired,
                 "resolved": st.resolved, "hung": st.hung,
                 "injected_failures": victim.injected_failures,
                 "quarantine_events": pool.router.quarantine_events,
                 "replica_counts": counts,
                 "completed_top1_identical_to_single": ok_top1,
                 "recovery_report": rec}
    emit(chaos_row)
    if not (st.hung == 0 and st.resolved == CHAOS_FRAMES
            and st.completed + st.failed == CHAOS_FRAMES
            and st.failed > 0 and st.completed > 0 and ok_top1
            and counts[1]["failed_batches"] == 0):
        raise SmokeFailure(f"chaos check failed: {chaos_row}")

    res = serve_knee_rescale("alexnet", program=prog, frames=KNEE_FRAMES,
                             batch=SERVE_BATCH, stages=2, seed=0,
                             max_segments=4, refine_iters=1,
                             verbose=False, return_outputs=True)
    torch.cuda.synchronize()
    by_path = dict(gemm_int8.launches_by_path)
    launched = gemm_int8.launches
    served = res.pop("outputs")
    knee = res.pop("knee")
    top1_ok = bool(np.array_equal(served["outputs"],
                                  knee_top1[served["frame_idx"]]))
    knee_row = {"phase": "knee_rescale", "model": "alexnet",
                **{k: res[k] for k in (
                    "batch", "stages", "slo_ms", "miss_target",
                    "measured_steady_fps_r1", "anchor_qps", "segments",
                    "rescale_events", "n_rescales", "forced",
                    "replicas_before", "replicas_after",
                    "armed_miss_at_trigger", "armed_miss_after_rescale",
                    "miss_recovered", "hung")},
                "knee_qps_after": knee["knee_qps"],
                "knee_replicas": knee["replicas"],
                "served_frames": int(len(served["frame_idx"])),
                "top1_identical_to_single": top1_ok,
                "gemm_int8_launches": launched,
                "launches_by_path": by_path,
                "phase_s": time.perf_counter() - t_phase}
    emit(knee_row)
    ok = (res["hung"] == 0 and res["n_rescales"] >= 1
          and res["replicas_after"] == 2 and top1_ok
          and len(served["frame_idx"]) > 0 and by_path["dp4a"] == 0
          and by_path["small_n"] > 0
          and 3 * by_path["large_n"] == 8 * by_path["small_n"])
    if not ok:
        raise SmokeFailure(f"elastic check failed: {knee_row}")
    return {"launches": launched, "by_path": by_path,
            "batches": by_path["small_n"] // 3}


# ---------------------------------------------------------------------------
# Phase 3e: the compiler front end, an imported LeNet on the card
# ---------------------------------------------------------------------------


def phase_import() -> dict:
    """``examples/lenet.json`` through ``launch/import_model.py`` on the
    card (import, lower, quantize, the f32 golden checked on the oracle
    route, a serve smoke through ``Server``), its ``gemm_int8`` launches
    counted by path: per batch conv1 (K 25) and conv2 (K 150) on
    ``large_n``, fc1 (K 400) on ``small_n``, fc2 and fc3 (rows of 120 and
    84 bytes, off 16-byte strides) on ``dp4a``, as the wrapper's rule
    predicts. Then the golden of a fresh registration holds on the f32,
    oracle and kernel routes on the card and on the CPU, and equals the
    launcher's."""
    from repro_torch import compiler
    from repro_torch.launch import import_model
    t_phase = time.perf_counter()
    spec = str(ROOT / "examples" / "lenet.json")
    reset_launches()
    res = import_model.import_and_serve(
        spec, device="cuda", serve_frames=IMPORT_FRAMES, batch=4,
        stages=1, verbose=False)
    torch.cuda.synchronize()
    by_path = dict(gemm_int8.launches_by_path)
    launched = gemm_int8.launches
    reg = ProgramRegistry()
    name, golden = reg.register_imported(spec, seed=0, device="cuda")
    prog = reg.get(name)
    routes = {}
    for route in ("f32", "oracle", "kernel"):
        before = dict(gemm_int8.launches_by_path)
        for where, p in (("cuda", prog), ("cpu", _program_on_cpu(prog))):
            try:
                compiler.check_golden(p, golden, seed=0, route=route)
                routes[f"{route}_{where}"] = True
            except compiler.GoldenMismatch as e:
                routes[f"{route}_{where}"] = str(e)
        torch.cuda.synchronize()
        ran = {k: n - before[k] for k, n in
               gemm_int8.launches_by_path.items()}
        if route == "kernel":
            kernel_paths = ran
    serve = res["serve"]
    row = {"phase": "import", "model": res["model"], "device": res["device"],
           "layers": [l["name"] for l in res["layers"]],
           "golden_acc_crc": res["golden"]["acc_crc"],
           "golden_top1": res["golden"]["top1"],
           "golden_equal_to_launcher": int(golden["acc_crc"])
           == res["golden"]["acc_crc"],
           "golden_routes": routes,
           "kernel_route_launches_by_path": kernel_paths,
           "serve": serve, "gemm_int8_launches": launched,
           "launches_by_path": by_path, "import_s": res["import_s"],
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    small = by_path["small_n"]
    ok = (all(v is True for v in routes.values())
          and row["golden_equal_to_launcher"]
          and serve["completed"] == IMPORT_FRAMES
          and serve["outcomes"] == ["completed"]
          and serve["route"] == "kernel" and small > 0
          and by_path["large_n"] == 2 * small
          and by_path["dp4a"] == 2 * small
          and kernel_paths == {"large_n": 2, "small_n": 1, "dp4a": 2})
    if not ok:
        raise SmokeFailure(f"import check failed: {row}")
    return {"launches": launched, "by_path": by_path, "batches": small}


# ---------------------------------------------------------------------------
# Phase 4: flash_attention against its plain version
# ---------------------------------------------------------------------------


def _check_flash(label, q, k, v, causal, window) -> float:
    """The kernel against the plain version on the same input values
    (upcast to float32, as the reference's tests hold bf16 against a
    float32 ``attention_ref``): within the reference's tolerances, and
    each row within ``FLASH_ROW_REL`` of its own RMS."""
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         window=window)
    torch.cuda.synchronize()
    tol, rel = FLASH_TOL[q.dtype], FLASH_ROW_REL[q.dtype]
    diff = (got.float() - want).abs()
    err = float(diff.max())
    row_rms = want.square().mean(-1).sqrt()
    row_rel = float((diff.amax(-1) / row_rms.clamp_min(1e-30)).max())
    ok = got.dtype == q.dtype and got.shape == q.shape and bool(
        torch.allclose(got.float(), want, rtol=tol, atol=tol)) \
        and row_rel <= rel
    emit({"phase": "flash_attention_case", "case": label,
          "q": list(q.shape), "k": list(k.shape), "dtype": str(q.dtype),
          "causal": causal, "window": window, "tol": tol,
          "max_abs_err": err, "max_abs_want": float(want.abs().max()),
          "rms_want": float(want.square().mean().sqrt()),
          "min_row_rms_want": float(row_rms.min()),
          "max_row_err_over_rms": row_rel, "row_rel_tol": rel, "ok": ok})
    if not ok:
        raise SmokeFailure(f"flash_attention disagrees with its plain "
                           f"version on {label}: max |err| {err}, largest "
                           f"row error {row_rel} of the row's RMS")
    return err


def phase_flash(env: dict) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    max_err = 0.0
    for label, B, Sq, Skv, H, KV, d, dtype, causal, window in FLASH_CASES:
        q, k, v = (rand((B, Sq, H, d), dtype), rand((B, Skv, KV, d), dtype),
                   rand((B, Skv, KV, d), dtype))
        max_err = max(max_err, _check_flash(label, q, k, v, causal, window))
    for S, d in FLASH_STRIDED:
        q, k, v = rand((2, S, 3, 4, d), torch.bfloat16).unbind(2)
        max_err = max(max_err, _check_flash(f"strided views S {S} d {d}", q,
                                            k, v, True, 0))

    cfg = ARCHS[LM_ARCH]
    B, S, H, KV, d = LM_B, LM_S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = rand((B, S, H, d), torch.bfloat16)
    k, v = rand((B, S, KV, d), torch.bfloat16), rand((B, S, KV, d),
                                                     torch.bfloat16)
    max_err = max(max_err, _check_flash("Yi-6B", q, k, v, True, 0))
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    ms = _time_cold_ms(lambda: flash_attention(q, k, v, causal=True), flush)
    plain_ms = _time_cold_ms(lambda: attention_ref(q, k, v, causal=True),
                             flush)
    # The yardstick: one PyTorch call of the same function, K/V heads
    # repeated and every operand permuted to [B,H,S,d] outside the timed
    # call. The port never calls it.
    qh = q.permute(0, 2, 1, 3)
    kh, vh = (t.repeat_interleave(H // KV, dim=2).permute(0, 2, 1, 3)
              for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms, library_note = None, None
    try:
        lib_out = sdpa(qh, kh, vh, is_causal=True).permute(0, 2, 1, 3)
        library_note = "max |diff| vs kernel %.3g" % float(
            (lib_out.float() - flash_attention(q, k, v).float()).abs().max())
        library_ms = _time_cold_ms(lambda: sdpa(qh, kh, vh, is_causal=True),
                                   flush)
    except RuntimeError as e:           # a yardstick, not the port
        library_note = f"scaled_dot_product_attention refused: {e}"[:200]
    del flush
    _, _, peak_bf16, peak_bytes = card_peaks(env["device"])
    flops = 4 * B * H * S * S * d // 2           # causal: half of QK^T + PV
    nbytes = 2 * B * S * d * (2 * H + 2 * KV)    # q, k, v, o once, bf16
    t_ops, t_bytes = flops / peak_bf16 * 1e3, nbytes / peak_bytes * 1e3
    row = {"phase": "flash_attention_yi6b", "shape": [B, S, H, KV, d],
           "dtype": "bfloat16", "causal": True, "flops": flops,
           "bytes": nbytes, "ms": ms, "plain_ms": plain_ms,
           "previous_ms": PREVIOUS_MS["flash_attention_yi6b"],
           "previous_ms_is": "recorded earlier, not measured in this run",
           "library_ms": library_ms, "library": library_note,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "tflops": flops / ms / 1e9}
    emit(row)
    return {"max_abs_err": max_err, **{k: row[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by")}}


# ---------------------------------------------------------------------------
# Phase 5: Yi-6B at full width, the cache-less forward
# ---------------------------------------------------------------------------


def _to(node, dtype):
    """The tree's floating leaves cast to ``dtype``; int8 weights and
    their float32 scales' neighbours keep their codes."""
    if isinstance(node, dict):
        return {k: _to(v, dtype) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, dtype) for v in node]
    return node.to(dtype) if node.is_floating_point() else node


def _forward(params, cfg, batch, impl):
    """The logits of ``T.forward`` on the attention impl ``impl``."""
    L.set_attention_impl(impl)
    try:
        return T.forward(params, cfg, batch)[0]
    finally:
        L.set_attention_impl(None)


def _close(a, b) -> dict:
    """How far bf16 logits ``a`` are from ``b``: max and mean |diff|, and
    whether they meet the reference's model tolerance (rtol 6e-2, atol
    8e-2)."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    return {"max_abs_diff": float(diff.max()),
            "mean_abs_diff": float(diff.mean()),
            "allclose_6e-2_8e-2": bool(torch.allclose(a, b, rtol=6e-2,
                                                      atol=8e-2))}


def _is_matmul(kernel_name: str) -> bool:
    """cuBLAS's and CUTLASS's GEMM kernels, by name."""
    return any(tag in kernel_name.lower()
               for tag in ("gemm", "nvjet", "cutlass", "xmma"))


def phase_lm_forward(env: dict) -> dict:
    cfg = ARCHS[LM_ARCH]
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (LM_B, LM_S), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens}

    # The main path: counts at 0 just before, read just after.
    reset_launches()
    logits_k = _forward(params, cfg, batch, "kernel")
    torch.cuda.synchronize()
    launches = flash_attention.launches
    emit({"phase": "lm_forward", "arch": LM_ARCH,
          "params": T.param_count(cfg), "init_s": init_s,
          "tokens": [LM_B, LM_S], "impl": "kernel",
          "flash_attention_launches": launches,
          "expected_launches": cfg.n_layers,
          "gemm_int8_launches": gemm_int8.launches,
          "logits_shape": list(logits_k.shape),
          "finite": bool(torch.isfinite(logits_k).all())})
    if launches != cfg.n_layers or gemm_int8.launches:
        raise SmokeFailure(f"the Yi-6B forward launched flash_attention "
                           f"{launches} times, expected {cfg.n_layers}")
    if not torch.isfinite(logits_k).all():
        raise SmokeFailure("the Yi-6B forward gave non-finite logits")
    _forward_time(env, "lm_forward",
                  lambda: _forward(params, cfg, batch, "kernel"))

    # The torch impl on the same tokens, and both against float32 on the
    # last positions of a 512-token slice of the first sequence (causal,
    # so the bf16 logits there are those of the same 512 tokens).
    logits_t = _forward(params, cfg, batch, "torch")
    p32 = _to(params, torch.float32)
    logits_32 = _forward(p32, cfg, {"tokens": tokens[:1, :F32_S]},
                         "torch")[:, F32_S - F32_LAST:].clone()
    del p32
    torch.cuda.empty_cache()
    _routes_check("lm", logits_k, logits_t, logits_32,
                  (slice(0, 1), slice(F32_S - F32_LAST, F32_S)),
                  LM_ROUTE_TOL)
    return {"params": params, "tokens": tokens, "logits_k": logits_k,
            "launches": launches}


# ---------------------------------------------------------------------------
# Phase 6: Yi-6B served, and the cache against the kernel forward
# ---------------------------------------------------------------------------


def phase_lm_serve(lm: dict) -> None:
    cfg = ARCHS[LM_ARCH]
    # Prefill and decode attend through the plain core: the kernel's path
    # is the cache-less forward.
    _serve("lm", SERVE_ARGS, 0, {})
    # Teacher-forced: prefill TF_PROMPT tokens, decode the next TF_STEPS
    # over the cache, and hold the logits of positions TF_PROMPT - 1 ..
    # TF_PROMPT + TF_STEPS - 1 against the kernel forward's.
    params, tokens = lm["params"], lm["tokens"]
    steps = [{"tokens": tokens[:, :TF_PROMPT]}] + [
        {"tokens": tokens[:, t:t + 1]}
        for t in range(TF_PROMPT, TF_PROMPT + TF_STEPS)]
    cache = _teacher_forced("lm", params, cfg, steps, lm["logits_k"][
        :, TF_PROMPT - 1:TF_PROMPT + TF_STEPS], LM_ROUTE_TOL)
    phase_decode_breakdown(cfg, params, cache, tokens[:, :1])


def phase_decode_breakdown(cfg, params, cache, tok,
                           weights: str = "bf16") -> dict:
    """Where a warm decode step's time goes at full width: wall time of
    single synchronised steps, the host's enqueue time of a run of steps,
    and one profiled step's device time by kernel. Every step is given
    the same cache, so each writes the same slot and attends over the
    same length. ``weights`` names the params' form in the row."""
    decode = lm_steps.make_serve_step(cfg)
    pos = cache["_pos"]

    def step():
        decode(params, cache, {"tokens": tok})

    n = 8
    step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    enqueue_ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    ops = _device_ops(step)
    device_ms = sum(us for _, us, _ in ops) / 1e3
    wall_ms = float(np.median(walls))
    param_bytes = _tree_bytes(params)
    _, _, _, peak_bytes = card_peaks(torch.cuda.get_device_name(0))
    row = {"phase": "lm_decode_breakdown", "arch": cfg.name,
           "weights": weights, "batch": tok.shape[0],
           "cache_len": pos, "wall_ms_median": wall_ms,
           "wall_ms_min": min(walls), "host_enqueue_ms": enqueue_ms,
           "device_busy_ms": device_ms,
           "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
           "weight_read_bound_ms": param_bytes / peak_bytes * 1e3,
           "kernels": sum(c for _, _, c in ops),
           "top_device_ops_us_count": [[k[:60], round(us, 1), c]
                                       for k, us, c in ops[:8]]}
    emit(row)
    return row


def _tree_bytes(tree) -> int:
    """Bytes of a tree's tensors (dicts, lists, named tuples), each
    storage counted once: what was allocated for them, before the caching
    allocator's rounding."""
    seen = {}

    def walk(node):
        if isinstance(node, dict):
            node = list(node.values())
        if isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, torch.Tensor):
            st = node.untyped_storage()
            seen[(st.data_ptr(), str(st.device))] = st.nbytes()

    walk(tree)
    return sum(seen.values())


# ---------------------------------------------------------------------------
# Phase 7: linear_scan against its plain version
# ---------------------------------------------------------------------------


def _plain_scan(a, b):
    """``linear_scan``'s plain version with the kernel's output dtype."""
    return linear_scan_ref(a, b).to(b.dtype)


def _check_scan(label, a, b, a_range) -> float:
    """The kernel against its plain version on the same inputs: within
    2e-5 and, since both round each step after the product and after the
    sum in the same order, equal bit for bit (float32 h; a bf16 h is the
    same rounding of it)."""
    got = linear_scan(a, b)
    want = _plain_scan(a, b)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    exact = torch.equal(got, want)
    ok = got.dtype == b.dtype and got.shape == b.shape and exact and bool(
        torch.allclose(got.float(), want.float(), rtol=SCAN_TOL,
                       atol=SCAN_TOL))
    emit({"phase": "linear_scan_case", "case": label,
          "shape": list(a.shape), "a_dtype": str(a.dtype),
          "b_dtype": str(b.dtype), "a_range": a_range, "tol": SCAN_TOL,
          "max_abs_err": err, "exact": exact,
          "max_abs_h": float(want.float().abs().max()), "ok": ok})
    if not ok:
        raise SmokeFailure(f"linear_scan disagrees with its plain version "
                           f"on {label}: max |err| {err}, exact {exact}")
    return err


def phase_scan(env: dict) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    for label, B, S, D, (lo, hi) in SCAN_CASES:
        a = torch.rand((B, S, D), generator=gen, device="cuda") * (hi - lo) \
            + lo
        b = torch.randn((B, S, D), generator=gen, device="cuda")
        max_err = max(max_err, _check_scan(label, a, b, [lo, hi]))
    # Every fp32/bf16 pairing of a and b, and a D that is no multiple of 8
    # (the kernel's element-wise tile loads), at the forward's B and D.
    a32, b32 = a[:, :1000].contiguous(), b[:, :1000].contiguous()
    a16, b16 = a32.bfloat16(), b32.bfloat16()
    for label, x, y in [("bf16 a, fp32 b", a16, b32),
                        ("fp32 a, bf16 b", a32, b16),
                        ("bf16 a, bf16 b", a16, b16),
                        ("D 2557", a[:, :1000, :2557].contiguous(),
                         b[:, :1000, :2557].contiguous())]:
        max_err = max(max_err, _check_scan(label, x, y, [0.7, 0.999]))
    # Two launches back to back on one stream: each zeroes its own ticket
    # and hand-off words before it runs, so they agree bit for bit.
    first, second = linear_scan(a, b), linear_scan(a, b)
    torch.cuda.synchronize()
    emit({"phase": "linear_scan_back_to_back", "shape": list(a.shape),
          "equal": torch.equal(first, second)})
    if not torch.equal(first, second):
        raise SmokeFailure("two linear_scan launches in a row disagree")
    del first, second
    # The last case is the forward's shape: timed.
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    ms = _time_cold_ms(lambda: linear_scan(a, b), flush)
    plain_ms = _time_cold_ms(lambda: linear_scan_ref(a, b), flush, iters=3)
    del flush
    key, _, _, peak_bytes = card_peaks(env["device"])
    flops = 2 * B * S * D
    nbytes = 3 * 4 * B * S * D                 # a, b read, h written, fp32
    t_ops, t_bytes = flops / F32_PEAKS[key] * 1e3, nbytes / peak_bytes * 1e3
    row = {"phase": "linear_scan_recurrentgemma", "shape": [B, S, D],
           "dtype": "float32", "flops": flops, "bytes": nbytes, "ms": ms,
           "plain_ms": plain_ms,
           "previous_ms": PREVIOUS_MS["linear_scan_recurrentgemma"],
           "previous_ms_is": "recorded earlier, not measured in this run",
           "library_ms": None,
           "library": "none: no single PyTorch call computes h_t = a_t "
                      "h_{t-1} + b_t; a cumprod/cumsum form under- or "
                      "overflows once prod(a) leaves float32's range",
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "gb_per_s": nbytes / ms / 1e6}
    emit(row)
    return {"max_abs_err": max_err, **{k: row[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by")}}


# ---------------------------------------------------------------------------
# Phase 8: flash_attention at head dim 256
# ---------------------------------------------------------------------------


def _window_pairs(S: int, window: int) -> int:
    """Query-key pairs a causal, windowed attention over S tokens computes
    (each query sees min(i + 1, window) keys)."""
    return sum(min(i + 1, window) for i in range(S))


def _sdpa_backend(fn) -> str:
    """The name of the device kernel that takes most of one call of
    ``fn``: which backend PyTorch's dispatcher picked. A CUDA-only
    profile, every row kept: ``_device_ops`` (CPU and CUDA activity,
    CUDA-typed rows only) found no row for cuDNN's attention kernel."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, _device_us(e)) for e in prof.key_averages()
                   if _device_us(e) > 0), key=lambda kv: -kv[1])
    return rows[0][0][:100] if rows else "unknown"


def phase_flash_rg(env: dict) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)
    d = ARCHS[RG_ARCH].head_dim
    max_err = 0.0
    timed = None
    for label, B, S, H, KV, dtype, window in FLASH_RG_CASES:
        q = torch.randn((B, S, H, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, S, KV, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, S, KV, d), generator=gen, device="cuda").to(dtype)
        max_err = max(max_err, _check_flash(label, q, k, v, True, window))
        if timed is None:
            timed = (q, k, v, window)
    q, k, v, window = timed
    B, S, H, _ = q.shape
    KV = k.shape[2]
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    ms = _time_cold_ms(lambda: flash_attention(q, k, v, causal=True,
                                               window=window), flush)
    plain_ms = _time_cold_ms(lambda: attention_ref(q, k, v, causal=True,
                                                   window=window), flush)
    # The yardstick: one PyTorch call of the same function with the
    # equivalent boolean mask (True = attend), K/V heads repeated and every
    # operand permuted to [B,H,S,d] outside the timed call.
    i = torch.arange(S, device="cuda")
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    qh = q.permute(0, 2, 1, 3)
    kh, vh = (t.repeat_interleave(H // KV, dim=2).permute(0, 2, 1, 3)
              for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms, library_note, backend = None, None, None
    try:
        library_note = "max |diff| vs kernel %.3g" % float(
            (sdpa(qh, kh, vh, attn_mask=mask).permute(0, 2, 1, 3).float()
             - flash_attention(q, k, v, causal=True,
                               window=window).float()).abs().max())
        library_ms = _time_cold_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask),
                                   flush)
        backend = _sdpa_backend(lambda: sdpa(qh, kh, vh, attn_mask=mask))
    except RuntimeError as e:           # a yardstick, not the port
        library_note = f"scaled_dot_product_attention refused: {e}"[:200]
    del flush
    _, _, peak_bf16, peak_bytes = card_peaks(env["device"])
    pairs = _window_pairs(S, window)
    flops = 4 * d * pairs * B * H                # QK^T and PV
    nbytes = 2 * B * S * d * (2 * H + 2 * KV)    # q, k, v, o once, bf16
    t_ops, t_bytes = flops / peak_bf16 * 1e3, nbytes / peak_bytes * 1e3
    row = {"phase": "flash_attention_recurrentgemma",
           "shape": [B, S, H, KV, d], "dtype": "bfloat16", "causal": True,
           "window": window, "pairs_per_head": pairs, "flops": flops,
           "bytes": nbytes, "ms": ms, "plain_ms": plain_ms,
           "previous_ms": PREVIOUS_MS["flash_attention_recurrentgemma"],
           "previous_ms_is": "recorded earlier, not measured in this run",
           "library_ms": library_ms, "library": library_note,
           "library_backend": backend, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "tflops": flops / ms / 1e9}
    emit(row)
    return {"max_abs_err": max_err, **{k: row[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by")}}


# ---------------------------------------------------------------------------
# Phase 9: RecurrentGemma-2B at full width, the cache-less forward
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _kernel_free():
    """For this block only: the torch attention impl and the plain scan in
    ``models.recurrent`` (the package has no public switch for the scan,
    as the reference has none)."""
    L.set_attention_impl("torch")
    R.linear_scan = _plain_scan
    try:
        yield
    finally:
        R.linear_scan = linear_scan
        L.set_attention_impl(None)


def _close_chunked(a, b, chunk: int = 512) -> dict:
    """``_close`` over sequence chunks of [B,S,V] logits, so no float32
    copy of the whole tensor is made."""
    diff, total, ok = 0.0, 0.0, True
    for s in range(0, a.shape[1], chunk):
        c = _close(a[:, s:s + chunk], b[:, s:s + chunk])
        diff = max(diff, c["max_abs_diff"])
        total += c["mean_abs_diff"] * a[:, s:s + chunk].numel()
        ok = ok and c["allclose_6e-2_8e-2"]
    return {"max_abs_diff": diff, "mean_abs_diff": total / a.numel(),
            "allclose_6e-2_8e-2": ok}


def _top1_agreement(a, b, chunk: int = 512) -> float:
    same = sum(int((a[:, s:s + chunk].argmax(-1)
                    == b[:, s:s + chunk].argmax(-1)).sum())
               for s in range(0, a.shape[1], chunk))
    return same / (a.shape[0] * a.shape[1])


def _finite(x, chunk: int = 512) -> bool:
    return all(bool(torch.isfinite(x[:, s:s + chunk]).all())
               for s in range(0, x.shape[1], chunk))


def phase_rg_forward(env: dict) -> dict:
    cfg = ARCHS[RG_ARCH]
    kinds = cfg.layer_kinds()
    n_attn, n_rec = kinds.count("attn_local"), kinds.count("rglru")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (RG_B, RG_S), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens}

    # The main path: counts at 0 just before, read just after.
    reset_launches()
    logits_k = _forward(params, cfg, batch, "kernel")
    torch.cuda.synchronize()
    counts = launches()
    row = {"phase": "rg_forward", "arch": RG_ARCH,
           "params": T.param_count(cfg), "init_s": init_s,
           "tokens": [RG_B, RG_S], "window": cfg.window, "impl": "kernel",
           "launches": counts,
           "expected": {"flash_attention": n_attn, "linear_scan": n_rec},
           "logits_shape": list(logits_k.shape), "finite": _finite(logits_k)}
    emit(row)
    if counts != {"gemm_int8": 0, "flash_attention": n_attn,
                  "linear_scan": n_rec}:
        raise SmokeFailure(f"the RecurrentGemma-2B forward launched "
                           f"{counts}, expected {n_attn} flash_attention "
                           f"and {n_rec} linear_scan")
    if not row["finite"]:
        raise SmokeFailure("the RecurrentGemma-2B forward gave non-finite "
                           "logits")

    _forward_time(env, "rg_forward",
                  lambda: _forward(params, cfg, batch, "kernel"))

    # The kernel-free forward on the same tokens, and both against float32
    # (kernel-free too) on the last positions of a slice of the first
    # sequence longer than the window (causal, so the bf16 logits there
    # are those of the same tokens).
    reset_launches()
    with _kernel_free():
        logits_t = _forward(params, cfg, batch, "torch")
        torch.cuda.synchronize()
        plain_counts = launches()
        p32 = _to(params, torch.float32)
        logits_32 = _forward(p32, cfg, {"tokens": tokens[:1, :RG_F32_S]},
                             "torch")[:, RG_F32_S - RG_F32_LAST:].clone()
        del p32
    torch.cuda.empty_cache()
    if any(plain_counts.values()):
        raise SmokeFailure(f"the kernel-free forward launched {plain_counts}")
    _routes_check("rg", logits_k, logits_t, logits_32,
                  (slice(0, 1), slice(RG_F32_S - RG_F32_LAST, RG_F32_S)),
                  RG_ROUTE_TOL)
    del logits_t
    torch.cuda.empty_cache()
    return {"params": params, "tokens": tokens, "logits_k": logits_k,
            "launches": counts}


# ---------------------------------------------------------------------------
# Phase 10: RecurrentGemma-2B served, and the ring cache and the RG-LRU
# state against the kernel forward
# ---------------------------------------------------------------------------


def phase_rg_serve(rg: dict) -> dict:
    cfg = ARCHS[RG_ARCH]
    n_rec = cfg.layer_kinds().count("rglru")
    # Prefill runs each RG-LRU layer's scan once; decode steps take
    # rglru_step and the ring cache's direct core, and no kernel.
    counts = _serve("rg", RG_SERVE_ARGS, 0, {"linear_scan": n_rec})[
        "launches"]

    # Teacher-forced: prefill RG_TF_PROMPT tokens into a ring of the
    # window's 2048 slots, decode the next RG_TF_STEPS (the ring wraps
    # and the window cuts), and hold the logits of positions
    # RG_TF_PROMPT - 1 .. RG_TF_PROMPT + RG_TF_STEPS - 1 against the
    # kernel forward's.
    params, tokens = rg["params"], rg["tokens"]
    cache = T.init_cache(cfg, RG_B, RG_TF_PROMPT + RG_TF_STEPS + 1,
                         device="cuda")
    ring = min(cfg.window, RG_TF_PROMPT + RG_TF_STEPS + 1)
    reset_launches()
    logits_p, cache, _ = T.forward(params, cfg,
                                   {"tokens": tokens[:, :RG_TF_PROMPT]},
                                   cache=cache)
    prefill_counts = launches()
    outs = [logits_p[:, -1]]
    for t in range(RG_TF_PROMPT, RG_TF_PROMPT + RG_TF_STEPS):
        lg, cache, _ = T.forward(params, cfg,
                                 {"tokens": tokens[:, t:t + 1]}, cache=cache)
        outs.append(lg[:, 0])
    got = torch.stack(outs, 1)
    want = rg["logits_k"][:, RG_TF_PROMPT - 1:RG_TF_PROMPT + RG_TF_STEPS]
    check = {"phase": "rg_teacher_forced", "prompt": RG_TF_PROMPT,
             "steps": RG_TF_STEPS, "ring_slots": ring,
             "wrapped": RG_TF_PROMPT + RG_TF_STEPS > ring,
             "prefill_launches": prefill_counts,
             "vs_kernel_forward": _close(got, want),
             "top1_agreement": float((got.argmax(-1) == want.argmax(-1))
                                     .float().mean()),
             "finite": bool(torch.isfinite(got).all()),
             "route_tol": RG_ROUTE_TOL}
    emit(check)
    if not (check["finite"] and check["wrapped"]
            and prefill_counts["linear_scan"] == n_rec
            and check["vs_kernel_forward"]["max_abs_diff"] <= RG_ROUTE_TOL):
        raise SmokeFailure(f"teacher-forced decode over the ring cache "
                           f"disagrees with the kernel forward: {check}")
    phase_decode_breakdown(cfg, params, cache, tokens[:, :1])
    return {"launches": counts}

# ---------------------------------------------------------------------------
# Phase: autotune, the static tiling ranker beside the measured tilings
# ---------------------------------------------------------------------------


def phase_autotune(env: dict, gemm: dict) -> dict:
    """``kernels/autotune.py``'s pick at every AlexNet and VGG16 batch-16
    shape beside ``plan_for``'s choice and the fastest tiling the
    ``gemm_int8_tilings`` lines measured (the pick's time over the
    fastest), and its attention tiles beside the ones ``flash_attention.cu``
    is built with. No device work; recorded, not gated."""
    rows = []
    for model in GEMM_MODELS:
        for t in gemm[model]["tilings"]:
            pick = autotune.pick_gemm_blocks(t["N"], t["K"], t["M"])
            label = _plan_label(pick.plan)
            row = {"phase": "autotune_gemm", "model": model,
                   "engine": t["engine"], "N": t["N"], "K": t["K"],
                   "M": t["M"], "autotune": label, "plan_for": t["chosen"],
                   "fastest": t["fastest"],
                   "autotune_over_fastest": t["ms"][label]
                   / t["ms"][t["fastest"]],
                   "plan_for_over_fastest": t["chosen_over_fastest"],
                   "mxu_occupancy": pick.mxu_occupancy,
                   "sm_fill": pick.sm_fill, "smem_bytes": pick.smem_bytes,
                   "card": env["nvidia_smi"]}
            rows.append(row)
            emit(row)
    for label, S, d, B, H, causal, window in AUTOTUNE_ATTN_SHAPES:
        pick = autotune.pick_attention_blocks(S, d, batch=B, heads=H,
                                              causal=causal, window=window)
        emit({"phase": "autotune_attention", "shape": label, "S": S, "d": d,
              "B": B, "H": H, "causal": causal, "window": window,
              "autotune": [pick.bq, pick.bkv],
              "built": list(autotune.built_attention_blocks(d)),
              "mxu_occupancy": pick.mxu_occupancy, "sm_fill": pick.sm_fill,
              "smem_bytes": pick.smem_bytes, "regs": pick.regs})
    summary = {"phase": "autotune", "shapes": len(rows),
               "autotune_is_fastest": sum(r["autotune"] == r["fastest"]
                                          for r in rows),
               "plan_for_is_fastest": sum(r["plan_for"] == r["fastest"]
                                          for r in rows),
               "autotune_is_plan_for": sum(r["autotune"] == r["plan_for"]
                                           for r in rows),
               "autotune_worst_over_fastest": max(
                   r["autotune_over_fastest"] for r in rows),
               "plan_for_worst_over_fastest": max(
                   r["plan_for_over_fastest"] for r in rows)}
    emit(summary)
    return summary


# ---------------------------------------------------------------------------
# The other LM families at full width: shared checks
# ---------------------------------------------------------------------------


def _flash_at_path(env: dict, label: str, B: int, S: int, H: int, KV: int,
                   d: int, causal: bool, seed: int) -> dict:
    """``flash_attention`` at a model path's shape (bf16): held against its
    plain version (``_check_flash``), then timed cold beside the plain
    version, one ``scaled_dot_product_attention`` call (K/V heads repeated
    and every operand permuted outside the timed call; the port never
    calls it) and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((B, S, H, d), (B, S, KV, d),
                                      (B, S, KV, d)))
    err = _check_flash(label, q, k, v, causal, 0)
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    ms = _time_cold_ms(lambda: flash_attention(q, k, v, causal=causal),
                       flush)
    plain_ms = _time_cold_ms(lambda: attention_ref(q, k, v, causal=causal),
                             flush)
    qh = q.permute(0, 2, 1, 3)
    kh, vh = (t.repeat_interleave(H // KV, dim=2).permute(0, 2, 1, 3)
              for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms, library_note, backend = None, None, None
    try:
        library_note = "max |diff| vs kernel %.3g" % float(
            (sdpa(qh, kh, vh, is_causal=causal).permute(0, 2, 1, 3).float()
             - flash_attention(q, k, v, causal=causal).float()).abs().max())
        library_ms = _time_cold_ms(
            lambda: sdpa(qh, kh, vh, is_causal=causal), flush)
        backend = _sdpa_backend(lambda: sdpa(qh, kh, vh, is_causal=causal))
    except RuntimeError as e:           # a yardstick, not the port
        library_note = f"scaled_dot_product_attention refused: {e}"[:200]
    del flush
    _, _, peak_bf16, peak_bytes = card_peaks(env["device"])
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * d * pairs * B * H                # QK^T and PV
    nbytes = 2 * B * S * d * (2 * H + 2 * KV)    # q, k, v, o once, bf16
    t_ops, t_bytes = flops / peak_bf16 * 1e3, nbytes / peak_bytes * 1e3
    row = {"phase": "flash_attention_path", "path": label,
           "shape": [B, S, H, KV, d], "dtype": "bfloat16", "causal": causal,
           "flops": flops, "bytes": nbytes, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library": library_note,
           "library_backend": backend, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "tflops": flops / ms / 1e9, "max_abs_err": err,
           "card": env["nvidia_smi"]}
    emit(row)
    return row


def _wall_ms(fn, reps: int) -> float:
    """The median wall time of ``reps`` synchronised calls of ``fn``."""
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def _forward_time(env: dict, label: str, fn, profile=None,
                  reps: int = 3) -> dict:
    """Wall time of warm calls of ``fn`` (the median of ``reps``); device
    busy time by kernel from one profiled call of ``profile`` (``fn`` by
    default), and the idle share against unprofiled calls of the same
    (the host's speed moves the wall time between runs)."""
    wall_ms = _wall_ms(fn, reps)
    profile_wall_ms = wall_ms if profile is None else _wall_ms(profile, reps)
    ops = _device_ops(profile or fn)
    device_ms = sum(us for _, us, _ in ops) / 1e3
    flash_ms = sum(us for k, us, _ in ops if "flash_fwd" in k) / 1e3
    scan_ms = sum(us for k, us, _ in ops if "linear_scan" in k) / 1e3
    matmul_ms = sum(us for k, us, _ in ops if _is_matmul(k)) / 1e3
    row = {"phase": f"{label}_time", "wall_ms_median": wall_ms,
           "reps": reps,
           "profiled_call_wall_ms": profile_wall_ms,
           "device_busy_ms": device_ms, "flash_attention_ms": flash_ms,
           "linear_scan_ms": scan_ms, "matmul_ms": matmul_ms,
           "matmul_launches": sum(n for k, _, n in ops if _is_matmul(k)),
           "other_ms": device_ms - flash_ms - scan_ms - matmul_ms,
           "device_idle_share": max(0.0, 1.0 - device_ms / profile_wall_ms),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "top_device_ops_us_count": [[k[:60], round(us, 1), n]
                                       for k, us, n in ops[:10]],
           "card": env["nvidia_smi"]}
    emit(row)
    return row


def _routes_check(label, logits_k, logits_t, logits_32, sl, route_tol):
    """The Yi-6B rules: the kernel forward within ``route_tol`` of the
    kernel-free one, and its error against float32 (on the slice ``sl``
    the float32 forward computed) at most the kernel-free one's plus one
    bf16 ulp at the float32 logits' largest magnitude."""
    kernel_vs_f32 = _close(logits_k[sl], logits_32)
    free_vs_f32 = _close(logits_t[sl], logits_32)
    routes = _close_chunked(logits_k, logits_t)
    f32_max = float(logits_32.abs().max())
    margin = 2.0 ** (math.floor(math.log2(f32_max)) - 7)   # one bf16 ulp
    check = {"phase": f"{label}_routes", "kernel_vs_kernel_free": routes,
             "top1_agreement": _top1_agreement(logits_k, logits_t),
             "f32_logits_max_abs": f32_max, "kernel_vs_f32": kernel_vs_f32,
             "kernel_free_vs_f32": free_vs_f32,
             "kernel_minus_kernel_free_err_vs_f32":
                 kernel_vs_f32["max_abs_diff"] - free_vs_f32["max_abs_diff"],
             "finite": _finite(logits_t) and bool(
                 torch.isfinite(logits_32).all()),
             "route_tol": route_tol, "f32_margin": margin}
    emit(check)
    if not (check["finite"] and routes["max_abs_diff"] <= route_tol
            and kernel_vs_f32["max_abs_diff"]
            <= free_vs_f32["max_abs_diff"] + margin):
        raise SmokeFailure(f"{label} logits out of tolerance: {check}")
    return check


def _teacher_forced(label, params, cfg, steps_in, want, tol, extra=None,
                    dtype=None):
    """Prefill ``steps_in[0]`` into a cache, decode each later batch of
    ``steps_in`` one token at a time, and hold the last prefill logits and
    each step's against ``want`` [B, steps, V]."""
    prompt = steps_in[0]
    first = next(iter(prompt.values()))
    B, P = first.shape[:2]
    cache = T.init_cache(cfg, B, P + len(steps_in), dtype=dtype,
                         device="cuda")
    reset_launches()
    logits_p, cache, _ = T.forward(params, cfg, prompt, cache=cache)
    outs = [logits_p[:, -1]]
    for step in steps_in[1:]:
        lg, cache, _ = T.forward(params, cfg, step, cache=cache)
        outs.append(lg[:, 0])
    got = torch.stack(outs, 1)
    torch.cuda.synchronize()
    check = {"phase": f"{label}_teacher_forced", "dtype": str(want.dtype),
             "prompt": P,
             "steps": len(steps_in) - 1, "launches": launches(),
             "vs_forward": _close(got, want),
             "top1_agreement": float((got.argmax(-1) == want.argmax(-1))
                                     .float().mean()),
             "want_max_abs": float(want.abs().max()),
             "finite": bool(torch.isfinite(got).all()), "tol": tol,
             **(extra or {})}
    emit(check)
    if not (check["finite"] and check["vs_forward"]["max_abs_diff"] <= tol):
        raise SmokeFailure(f"{label}: teacher-forced decode disagrees with "
                           f"the forward: {check}")
    return cache


def _serve(label, args, expect_prefill, expect) -> dict:
    """``launch.serve.main`` with its launches counted: ``flash_attention``
    in the prefill (``main``'s own count) and every kernel in the whole
    run, against ``expect`` (a kernel it leaves out must launch 0 times)."""
    reset_launches()
    result = lm_serve.main(args)
    torch.cuda.synchronize()
    counts = launches()
    ids = np.asarray(result.pop("ids"))
    vocab = ARCHS[result["arch"]].vocab
    row = {"phase": f"{label}_serve", **result, "launches": counts,
           "expected_prefill_flash_attention": expect_prefill,
           "ids_shape": list(ids.shape),
           "ids_in_vocab": bool(((ids >= 0) & (ids < vocab)).all()),
           "sample_ids": ids[0, :8].tolist()}
    emit(row)
    want_shape = (int(args[args.index("--batch") + 1]),
                  int(args[args.index("--gen") + 1]))
    if ids.shape != want_shape or not row["ids_in_vocab"]:
        raise SmokeFailure(f"{label} serve gave ids of shape {ids.shape}")
    if result["prefill_flash_attention_launches"] != expect_prefill or \
            counts != {k: expect.get(k, 0) for k in counts}:
        raise SmokeFailure(f"{label} serve launched {counts} (prefill "
                           f"{result['prefill_flash_attention_launches']}), "
                           f"expected {expect} ({expect_prefill} "
                           f"flash_attention in prefill)")
    return row


def _init(cfg) -> tuple:
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Phase vlm: Qwen2-VL-2B (M-RoPE, GQA 12:2, d 128)
# ---------------------------------------------------------------------------


def _vlm_positions(B: int, S: int) -> torch.Tensor:
    """M-RoPE positions whose three components differ, as an image's
    patches have them: a temporal index and the row and column of a
    64-wide grid."""
    i = torch.arange(S, device="cuda", dtype=torch.int32)
    return torch.stack([i, i // 64, i % 64], -1)[None].expand(B, S, 3)


def phase_vlm(env: dict) -> dict:
    cfg = ARCHS[VLM_ARCH]
    params, init_s = _init(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    embeds = torch.randn((VLM_B, VLM_S, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
    positions = _vlm_positions(VLM_B, VLM_S)
    batch = {"embeds": embeds, "positions": positions}

    # The main path: counts at 0 just before, read just after.
    reset_launches()
    logits_k = _forward(params, cfg, batch, "kernel")
    torch.cuda.synchronize()
    counts = launches()
    row = {"phase": "vlm_forward", "arch": VLM_ARCH,
           "params": T.param_count(cfg), "init_s": init_s,
           "embeds": [VLM_B, VLM_S, cfg.d_model],
           "mrope_sections": list(cfg.mrope_sections), "launches": counts,
           "expected_flash_attention": cfg.n_layers,
           "logits_shape": list(logits_k.shape), "finite": _finite(logits_k)}
    emit(row)
    if counts != {"gemm_int8": 0, "flash_attention": cfg.n_layers,
                  "linear_scan": 0} or not row["finite"]:
        raise SmokeFailure(f"the Qwen2-VL-2B forward launched {counts}, "
                           f"expected {cfg.n_layers} flash_attention; "
                           f"finite {row['finite']}")
    _forward_time(env, "vlm_forward",
                  lambda: _forward(params, cfg, batch, "kernel"))

    logits_t = _forward(params, cfg, batch, "torch")
    p32 = _to(params, torch.float32)
    logits_32 = _forward(p32, cfg, {
        "embeds": embeds[:1, :F32_S].float(),
        "positions": positions[:1, :F32_S]}, "torch")[
        :, F32_S - F32_LAST:].clone()
    del p32
    torch.cuda.empty_cache()
    _routes_check("vlm", logits_k, logits_t, logits_32,
                  (slice(0, 1), slice(F32_S - F32_LAST, F32_S)),
                  VLM_ROUTE_TOL)
    del logits_t

    # Teacher-forced with the true positions, against the kernel forward.
    P, n = VLM_TF_PROMPT, VLM_TF_STEPS
    steps = [{"embeds": embeds[:, :P], "positions": positions[:, :P]}] + [
        {"embeds": embeds[:, t:t + 1], "positions": positions[:, t:t + 1]}
        for t in range(P, P + n)]
    cache = _teacher_forced("vlm", params, cfg, steps,
                            logits_k[:, P - 1:P + n], VLM_ROUTE_TOL)
    phase_decode_breakdown(cfg, params, cache, torch.ones(
        (VLM_B, 1), dtype=torch.long, device="cuda"))
    del params, logits_k, cache
    torch.cuda.empty_cache()

    # Served: the reference's decode inputs, M-RoPE position 0 at every
    # step (ROADMAP C5); prefill and decode attend through the plain core.
    serve_row = _serve("vlm", VLM_SERVE_ARGS, 0, {})
    flash = _flash_at_path(env, "Qwen2-VL-2B", VLM_B, VLM_S, cfg.n_heads,
                           cfg.n_kv_heads, cfg.head_dim, True, seed=3)
    torch.cuda.empty_cache()
    return {"launches": counts, "flash": flash, "serve": serve_row}


# ---------------------------------------------------------------------------
# Phase encdec: SeamlessM4T-medium (non-causal encoder and cross-attention
# at d 64)
# ---------------------------------------------------------------------------


def phase_encdec(env: dict) -> dict:
    cfg = ARCHS[ED_ARCH]
    params, init_s = _init(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (ED_B, ED_S), generator=gen,
                           device="cuda")
    frames = torch.randn((ED_B, ED_S, cfg.d_model), generator=gen,
                         device="cuda").to(torch.bfloat16)
    batch = {"tokens": tokens, "enc_embeds": frames}
    expected = cfg.n_enc_layers + 2 * cfg.n_layers

    reset_launches()
    logits_k = _forward(params, cfg, batch, "kernel")
    torch.cuda.synchronize()
    counts = launches()
    row = {"phase": "encdec_forward", "arch": ED_ARCH,
           "params": T.param_count(cfg), "init_s": init_s,
           "tokens": [ED_B, ED_S], "enc_embeds": [ED_B, ED_S, cfg.d_model],
           "launches": counts, "expected_flash_attention": expected,
           "logits_shape": list(logits_k.shape), "finite": _finite(logits_k)}
    emit(row)
    if counts != {"gemm_int8": 0, "flash_attention": expected,
                  "linear_scan": 0} or not row["finite"]:
        raise SmokeFailure(f"the Seamless forward launched {counts}, "
                           f"expected {expected} flash_attention "
                           f"(encoder, decoder, cross); finite "
                           f"{row['finite']}")
    _forward_time(env, "encdec_forward",
                  lambda: _forward(params, cfg, batch, "kernel"))

    # The encoder is bidirectional, so the float32 forward runs the first
    # sequence whole (a slice of the frames would encode other frames).
    logits_t = _forward(params, cfg, batch, "torch")
    p32 = _to(params, torch.float32)
    logits_32 = _forward(p32, cfg, {
        "tokens": tokens[:1], "enc_embeds": frames[:1].float()}, "torch")[
        :, ED_S - F32_LAST:].clone()
    del p32
    torch.cuda.empty_cache()
    _routes_check("encdec", logits_k, logits_t, logits_32,
                  (slice(0, 1), slice(ED_S - F32_LAST, ED_S)), ED_ROUTE_TOL)
    del logits_t

    # Teacher-forced, the frames passed at every step (the decoder then
    # cross-attends as the forward does), against the kernel forward.
    P, n = ED_TF_PROMPT, ED_TF_STEPS
    steps = [{"tokens": tokens[:, :P], "enc_embeds": frames}] + [
        {"tokens": tokens[:, t:t + 1], "enc_embeds": frames}
        for t in range(P, P + n)]
    cache = _teacher_forced("encdec", params, cfg, steps,
                            logits_k[:, P - 1:P + n], ED_ROUTE_TOL)
    # A step as served: tokens only (ROADMAP C6).
    phase_decode_breakdown(cfg, params, cache, tokens[:, :1])
    del params, logits_k, cache
    torch.cuda.empty_cache()

    # Served: prefill encodes (12 launches) and cross-attends over frames
    # of the prompt's length (12); decode steps pass tokens only and skip
    # cross-attention, as the reference's do (ROADMAP C6).
    n = cfg.n_enc_layers + cfg.n_layers
    serve_row = _serve("encdec", ED_SERVE_ARGS, n, {"flash_attention": n})
    flash = _flash_at_path(env, "SeamlessM4T-medium", ED_B, ED_S,
                           cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, False,
                           seed=4)
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((ED_B, 1000, cfg.n_heads, cfg.head_dim),
                           generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    flash["max_abs_err"] = max(flash["max_abs_err"], _check_flash(
        "Seamless decoder, causal, ragged S", q, k, v, True, 0))
    torch.cuda.empty_cache()
    return {"launches": counts, "flash": flash, "serve": serve_row}


# ---------------------------------------------------------------------------
# Phase mla_moe: DeepSeek-V2-236B at full width, depth cut to 3 layers
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _recorded_routes():
    """Every ``moe_route`` call of the block's MoE layers, in call order."""
    calls, route = [], L.moe_route

    def recording(p, c, xt):
        calls.append(route(p, c, xt))
        return calls[-1]

    L.moe_route = recording
    try:
        yield calls
    finally:
        L.moe_route = route


def _topk_sets(calls, B: int, lengths: list, last: list) -> torch.Tensor:
    """Each MoE layer's top-k ids as sorted sets [layers, B, positions, k]
    from calls made layer by layer over chunks of ``lengths`` tokens a
    sequence, keeping the last ``last[i]`` positions of chunk i."""
    n_moe = len(calls) // len(lengths)
    per_layer = [[] for _ in range(n_moe)]
    for i, (S, keep) in enumerate(zip(lengths, last)):
        for j in range(n_moe):
            topi = calls[i * n_moe + j]["topi"]
            per_layer[j].append(topi.reshape(B, S, -1)[:, S - keep:])
    return torch.stack([torch.cat(c, 1) for c in per_layer]).sort(-1).values


def _mla_teacher_forced(label, params, cfg, tokens, tol) -> dict:
    """Prefill MLA_TF_PROMPT tokens, decode MLA_TF_STEPS through the
    absorbed path, and hold the logits against a forward of the same
    tokens, position by position where every MoE layer routed the token
    to the same experts in both. A routing flip between near-tied gates
    (the bf16 rounding of the two paths differs) sends the token to
    another expert: a different function, not an error of the path; the
    flips are counted."""
    B = tokens.shape[0]
    P, n = MLA_TF_PROMPT, MLA_TF_STEPS
    with _recorded_routes() as calls:
        want = T.forward(params, cfg, {"tokens": tokens[:, :P + n]})[0][
            :, P - 1:P + n]
    routes_fwd = _topk_sets(calls, B, [P + n], [n + 1])
    # One slot more than the check needs: the decode breakdown's step.
    cache = T.init_cache(cfg, B, P + n + 1, dtype=want.dtype, device="cuda")
    with _recorded_routes() as calls:
        logits_p, cache, _ = T.forward(params, cfg, {"tokens": tokens[:, :P]},
                                       cache=cache)
        outs = [logits_p[:, -1]]
        for t in range(P, P + n):
            lg, cache, _ = T.forward(params, cfg,
                                     {"tokens": tokens[:, t:t + 1]},
                                     cache=cache)
            outs.append(lg[:, 0])
    got = torch.stack(outs, 1)
    routes_dec = _topk_sets(calls, B, [P] + [1] * n, [1] * (n + 1))
    same = (routes_fwd == routes_dec).all(-1).all(0)       # [B, n + 1]
    diff = (got.float() - want.float()).abs().amax(-1)     # [B, n + 1]
    check = {"phase": f"{label}_teacher_forced", "dtype": str(want.dtype),
             "prompt": P, "steps": n,
             "capacity_factor": cfg.moe_capacity_factor,
             "positions": same.numel(),
             "positions_with_a_routing_flip": int((~same).sum()),
             "max_abs_diff_same_routing": float(diff[same].max())
             if same.any() else None,
             "max_abs_diff_all": float(diff.max()),
             "top1_agreement": float((got.argmax(-1) == want.argmax(-1))
                                     .float().mean()),
             "want_max_abs": float(want.abs().max()),
             "finite": bool(torch.isfinite(got).all()), "tol": tol}
    emit(check)
    if not (check["finite"] and 2 * int(same.sum()) >= same.numel()
            and check["max_abs_diff_same_routing"] <= tol):
        raise SmokeFailure(f"{label}: the absorbed decode disagrees with the "
                           f"forward: {check}")
    return cache


def phase_mla_moe(env: dict) -> dict:
    cfg = ARCHS[MLA_ARCH].scaled(n_layers=MLA_LAYERS)
    kinds = cfg.layer_kinds()
    params, init_s = _init(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (MLA_B, MLA_S), generator=gen,
                           device="cuda")
    reset_launches()
    with _recorded_routes() as calls:
        logits, _, aux = T.forward(params, cfg, {"tokens": tokens})
    torch.cuda.synchronize()
    counts = launches()
    row = {"phase": "mla_moe_forward", "arch": MLA_ARCH,
           "reduced": f"n_layers {ARCHS[MLA_ARCH].n_layers} -> {MLA_LAYERS}",
           "layer_kinds": kinds, "params": T.param_count(cfg),
           "init_s": init_s, "tokens": [MLA_B, MLA_S], "launches": counts,
           "aux_loss": float(aux),
           "capacity_factor": cfg.moe_capacity_factor,
           "moe_capacity_and_kept_share": [
               (r["C"], float(r["kept"].float().mean())) for r in calls],
           "logits_shape": list(logits.shape), "finite": _finite(logits),
           "logits_max_abs": float(logits.abs().max())}
    emit(row)
    del calls
    if any(counts.values()) or not row["finite"] \
            or not math.isfinite(row["aux_loss"]):
        raise SmokeFailure(f"the DeepSeek-V2 forward launched {counts} "
                           f"(MLA's q and v dims differ: no kernel), finite "
                           f"{row['finite']}, aux {row['aux_loss']}")
    del logits
    _forward_time(env, "mla_moe_forward",
                  lambda: T.forward(params, cfg, {"tokens": tokens}))

    # Teacher-forced through the absorbed path, at a capacity factor at
    # which no token is dropped (C >= T at every step, factor >= E / k): a
    # full pass and a token-by-token decode drop differently at 1.25, as
    # the reference's own test says. In bf16, and in float32, where the
    # two paths round alike to ~1e-6 and no gate flips.
    cfg_tf = cfg.scaled(moe_capacity_factor=float(math.ceil(
        cfg.moe_n_experts / cfg.moe_top_k)))
    cache = _mla_teacher_forced("mla_moe", params, cfg_tf, tokens,
                                MLA_TF_TOL)
    phase_decode_breakdown(cfg, params, cache, tokens[:, :1])
    del cache
    p32 = _to(params, torch.float32)
    del params
    torch.cuda.empty_cache()
    _mla_teacher_forced("mla_moe_f32", p32, cfg_tf, tokens, MLA_F32_TF_TOL)
    del p32
    torch.cuda.empty_cache()
    serve_row = _serve("mla_moe", MLA_SERVE_ARGS, 0, {})
    torch.cuda.empty_cache()
    return {"launches": counts, "serve": serve_row}


# ---------------------------------------------------------------------------
# Phase rwkv: RWKV6-7B (the sequential WKV loop, no kernel)
# ---------------------------------------------------------------------------


def phase_rwkv(env: dict) -> dict:
    cfg = ARCHS[RWKV_ARCH].scaled(n_layers=RWKV_LAYERS)
    params, init_s = _init(cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (RWKV_B, RWKV_S), generator=gen,
                           device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    logits = T.forward(params, cfg, {"tokens": tokens})[0]
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = launches()
    row = {"phase": "rwkv_forward", "arch": RWKV_ARCH,
           "reduced": f"n_layers {ARCHS[RWKV_ARCH].n_layers} -> "
                      f"{RWKV_LAYERS}",
           "params": T.param_count(cfg), "init_s": init_s,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "tokens": [RWKV_B, RWKV_S], "launches": counts,
           "first_call_ms": first_ms, "logits_shape": list(logits.shape),
           "finite": _finite(logits)}
    emit(row)
    if any(counts.values()) or not row["finite"]:
        raise SmokeFailure(f"the RWKV6 forward launched {counts}; finite "
                           f"{row['finite']}")
    # The profile covers a forward of 2 x RWKV_PROFILE_S tokens: a whole
    # one makes ~10 launches per token per layer, too many events to sum.
    _forward_time(env, "rwkv_forward",
                  lambda: T.forward(params, cfg, {"tokens": tokens}),
                  profile=lambda: T.forward(params, cfg, {
                      "tokens": tokens[:, :RWKV_PROFILE_S]}), reps=1)

    # The sequential WKV loop alone, at one layer's shape.
    nh, hd = cfg.d_model // cfg.head_dim, cfg.head_dim
    lp = params["seg0"][0]["rwkv"]
    r, k, v = (torch.randn((RWKV_B, RWKV_S, nh, hd), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    w = torch.rand((RWKV_B, RWKV_S, nh, hd), generator=gen, device="cuda")
    s0 = torch.zeros((RWKV_B, nh, hd, hd), device="cuda")
    R.rwkv6_wkv_scan(lp, r, k, v, w, s0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    R.rwkv6_wkv_scan(lp, r, k, v, w, s0)
    torch.cuda.synchronize()
    scan_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "rwkv_wkv_loop", "shape": [RWKV_B, RWKV_S, nh, hd],
          "ms": scan_ms, "us_per_step": scan_ms * 1e3 / RWKV_S,
          "layers": cfg.n_layers,
          "ms_per_forward": scan_ms * cfg.n_layers,
          "card": env["nvidia_smi"]})

    # A float32 forward of the first sequence, all of it. RWKV6 at these
    # random weights drifts far in bf16 from float32 (the reference does
    # too: tests/test_torch_family_layers.py holds the port's drift to the
    # reference's), so the bf16 forward is held to the drift's mean.
    p32 = _to(params, torch.float32)
    logits_32 = T.forward(p32, cfg, {"tokens": tokens[:1]})[0]
    check = {"phase": "rwkv_vs_f32", "bf16_vs_f32": _close_chunked(
                 logits[:1], logits_32),
             "top1_agreement": _top1_agreement(logits[:1], logits_32),
             "f32_logits_max_abs": float(logits_32.abs().max()),
             "finite": _finite(logits_32), "mean_tol": RWKV_F32_MEAN_TOL}
    emit(check)
    if not (check["finite"] and check["bf16_vs_f32"]["mean_abs_diff"]
            <= RWKV_F32_MEAN_TOL):
        raise SmokeFailure(f"RWKV6 bf16 logits drift from float32 past the "
                           f"bound: {check}")

    # Teacher-forced over the two token shifts and the WKV state, against
    # the forward, in float32 and in bf16. At these random weights the
    # recurrence magnifies rounding: two forwards that differ only in how
    # many tokens their matmuls take at once (the prefill's 256, a step's
    # 1, the forward's 1024) land apart by more than rounding. So each
    # dtype's control is a forward over just the compared tokens against
    # the long forward, and the decode may differ by twice the control's
    # spread (or the tolerance, if larger); a wrong state carried between
    # steps moves logits by their own size.
    P, n = RWKV_TF_PROMPT, RWKV_TF_STEPS
    for label, prm, lg, tol, b in (
            ("rwkv_f32", p32, logits_32, RWKV_F32_TF_TOL, 1),
            ("rwkv", params, logits, RWKV_TF_TOL, RWKV_B)):
        want = lg[:b, P - 1:P + n]
        control = T.forward(prm, cfg, {"tokens": tokens[:b, :P + n]})[0][
            :, P - 1:P + n]
        spread = _close(control, want)["max_abs_diff"]
        steps = [{"tokens": tokens[:b, :P]}] + [
            {"tokens": tokens[:b, t:t + 1]} for t in range(P, P + n)]
        cache = _teacher_forced(label, prm, cfg, steps, want,
                                max(tol, 2 * spread),
                                {"control_max_abs_diff": spread,
                                 "tol_rule": f"max({tol}, 2 x control)"},
                                dtype=lg.dtype)
    phase_decode_breakdown(cfg, params, cache, tokens[:, :1])
    del p32, logits_32, cache
    del params, logits
    torch.cuda.empty_cache()
    serve_row = _serve("rwkv", RWKV_SERVE_ARGS, 0, {})
    torch.cuda.empty_cache()
    return {"launches": counts, "serve": serve_row, "wkv_loop_ms": scan_ms}


LM_FAMILY_PHASES = {"vlm": phase_vlm, "encdec": phase_encdec,
                    "mla_moe": phase_mla_moe, "rwkv": phase_rwkv}


# ---------------------------------------------------------------------------
# Phase 17: training (the RG-LRU's forward and backward through linear_scan)
# ---------------------------------------------------------------------------


# linear_scan's gradient against autograd through its plain version on the
# card: (label, B, S, D). A ragged S, one step, a chunk and one step, and
# the RecurrentGemma-2B training shape (batch 2 x 1024 tokens, D 2560).
SCAN_GRAD_CASES = [("ragged S", 2, 77, 100), ("S 1", 2, 1, 2560),
                   ("one chunk + 1", 2, 257, 2560),
                   ("RecurrentGemma-2B training", 2, 1024, 2560)]
TRAIN_ARCH = "recurrentgemma-2b"
# Depth cut 26 -> 13 (9 RG-LRU and 4 local-attention layers) to keep the
# whole run within half its time limit: the checkpoint's write and
# restore scale with it. Full depth trains in phase int8_moments (a).
TRAIN_LAYERS = 13
# Five steps: launch/train.py's main runs steps 1-4 and writes its one
# checkpoint, step 4's (the loop saves its last step); step 5 carries the
# run's state on, then is replayed from step 4's checkpoint. The state is
# 12 bytes a parameter on disk (bf16 params widened to float32, float32
# moments), 34.7 GB at full depth: the run writes it once (a call may
# write 45 GiB).
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 1024, 5
# Reduced configs, card against CPU, float32: each gradient leaf within
# 1e-4 of its largest |g| (the CPU tests' tolerance against the
# reference), the loss and grad norm at rtol 1e-5 / 1e-4; the params after
# one step within 1e-5, but for at most 0.1% of the elements within 2 lr
# (Adam's step-1 move of g / (|g| + eps) where |g| is near rounding noise).
TRAIN_GRAD_TOL, TRAIN_PARAM_TOL, TRAIN_FLIP_SHARE, TRAIN_LR = \
    1e-4, 1e-5, 1e-3, 1e-3
TRAIN_RB, TRAIN_RS = 2, 16


def _scan_grads(scan, a, b, dh):
    a = a.clone().requires_grad_()
    b = b.clone().requires_grad_()
    h = scan(a, b)
    return (h.detach(), *torch.autograd.grad(h, (a, b), dh))


def _check_scan_grad(label, B, S, D, gen) -> float:
    """The kernel's gradient (the forward and the reversed backward scan,
    one launch each) against autograd through ``linear_scan_ref`` on the
    card: h, da and db within 2e-5 and each row within 2e-5 of its RMS;
    whether they are equal bit for bit (both round each step's product,
    then its sum) is printed."""
    a = torch.rand((B, S, D), generator=gen, device="cuda") * 0.299 + 0.7
    b = torch.randn((B, S, D), generator=gen, device="cuda")
    dh = torch.randn((B, S, D), generator=gen, device="cuda")
    before = dict(linear_scan.launches_by_path)
    got = _scan_grads(linear_scan, a, b, dh)
    torch.cuda.synchronize()
    ran = {k: linear_scan.launches_by_path[k] - before[k] for k in before}
    want = _scan_grads(linear_scan_ref, a, b, dh)
    err, exact, ok = 0.0, True, ran == {"forward": 1, "backward": 1}
    for g, w in zip(got, want):
        diff = (g - w).abs()
        err = max(err, float(diff.max()))
        exact = exact and torch.equal(g, w)
        rms = w.square().mean(-1, keepdim=True).sqrt()
        ok = ok and bool((diff <= SCAN_TOL * rms).all()) and bool(
            torch.allclose(g, w, rtol=SCAN_TOL, atol=SCAN_TOL))
    emit({"phase": "linear_scan_grad_case", "case": label,
          "shape": [B, S, D], "launches": ran, "max_abs_err": err,
          "exact": exact, "tol": SCAN_TOL, "ok": ok})
    if not ok:
        raise SmokeFailure(f"linear_scan's gradient disagrees with autograd "
                           f"through its plain version on {label}: max "
                           f"|err| {err}, launches {ran}")
    return err


def _scan_grad_times(env, B, S, D) -> dict:
    """Forward launch, backward launch and the whole backward (flips, the
    launch, da = g * h_prev) at the training shape, fp32, beside the plain
    version and the bounds, 4 bytes an element: forward a, b read and h
    written; the whole backward a, h and dL/dh read, da and db written;
    the backward launch alone its a and dL/dh read and g written."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    a = torch.rand((B, S, D), generator=gen, device="cuda") * 0.299 + 0.7
    b = torch.randn((B, S, D), generator=gen, device="cuda")
    dh = torch.randn((B, S, D), generator=gen, device="cuda")
    a_rev = torch.cat([torch.zeros_like(a[:, :1]), a.flip(1)[:, :S - 1]], 1)
    dh_rev = dh.flip(1).contiguous()
    ar, br = a.clone().requires_grad_(), b.clone().requires_grad_()
    h_k = linear_scan(ar, br)
    h_p = linear_scan_ref(ar, br)
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    row = {"phase": "linear_scan_grad_times", "shape": [B, S, D],
           "dtype": "float32",
           "forward_ms": _time_cold_ms(lambda: linear_scan(a, b), flush),
           "backward_launch_ms": _time_cold_ms(
               lambda: scan_kernel._scan(a_rev, dh_rev, "backward"), flush),
           "backward_ms": _time_cold_ms(lambda: torch.autograd.grad(
               h_k, (ar, br), dh, retain_graph=True), flush),
           "plain_forward_ms": _time_cold_ms(
               lambda: linear_scan_ref(a, b), flush, iters=3),
           "plain_backward_ms": _time_cold_ms(lambda: torch.autograd.grad(
               h_p, (ar, br), dh, retain_graph=True), flush, iters=3)}
    del flush
    key, _, _, peak_bytes = card_peaks(env["device"])
    n = B * S * D
    for d, nbytes, flops in (("forward", 3 * 4 * n, 2 * n),
                             ("backward", 5 * 4 * n, 3 * n),
                             ("backward_launch", 3 * 4 * n, 2 * n)):
        t_ops = flops / F32_PEAKS[key] * 1e3
        t_bytes = nbytes / peak_bytes * 1e3
        row[f"{d}_bytes"], row[f"{d}_flops"] = nbytes, flops
        row[f"{d}_bound_ms"] = max(t_ops, t_bytes)
        row[f"{d}_bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    row["card"] = env["nvidia_smi"]
    emit(row)
    return row


def _batch_np(cfg, seed=1) -> dict:
    """numpy inputs and labels for a reduced ``cfg`` (the CPU tests')."""
    rng = np.random.default_rng(seed)
    B, S = TRAIN_RB, TRAIN_RS
    batch = {"labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend_stub and cfg.family != "enc_dec":
        batch["embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
        batch["positions"] = np.broadcast_to(
            np.arange(S)[None, :, None] + np.array([0, 3, 7]),
            (B, S, 3)).astype(np.int32).copy()
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.family == "enc_dec":
        batch["enc_embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    return batch


def _grads(params, cfg, batch) -> list:
    """Every leaf's gradient of ``loss_fn``, as ``make_train_step`` takes
    them."""
    return optim.adamw.tree_leaves(
        lm_steps.value_and_grad(params, cfg, batch)[1])


def _reduced_card_vs_cpu() -> dict:
    """Every reduced config at float32: one ``make_train_step`` on the card
    (kernels) and on the CPU (plain versions) from the same weights and
    batch; each gradient leaf, the loss, the grad norm and the updated
    params compared."""
    out = {}
    for arch in sorted(ARCHS):
        cfg = reduced(ARCHS[arch])
        batch = _batch_np(cfg)
        runs = {}
        for device in ("cpu", "cuda"):
            params = T.init_params(cfg, seed=0, device="cpu",
                                   dtype=torch.float32)
            params = optim.adamw.tree_map(lambda t: t.to(device), params)
            bt = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            grads = _grads(params, cfg, bt)
            step = lm_steps.make_train_step(cfg, lr=TRAIN_LR, remat=False)
            reset_launches()
            params, _, m = step(params, optim.adamw_init(
                params, cfg.opt_moment_dtype), bt)
            if device == "cuda":
                torch.cuda.synchronize()
            runs[device] = (grads, params, m, dict(
                linear_scan.launches_by_path,
                flash_attention=flash_attention.launches))
        (g_c, p_c, m_c, _), (g_k, p_k, m_k, counts) = runs["cpu"], \
            runs["cuda"]
        grad_rel = max(float((a.cpu() - b).abs().max())
                       / max(float(b.abs().max()), 1e-30)
                       for a, b in zip(g_k, g_c))
        off = n = 0
        worst = 0.0
        for a, b in zip(optim.adamw.tree_leaves(p_k),
                        optim.adamw.tree_leaves(p_c)):
            d = (a.detach().cpu() - b.detach()).abs()
            off += int((d > TRAIN_PARAM_TOL).sum())
            n += d.numel()
            worst = max(worst, float(d.max()))
        n_rec = cfg.layer_kinds().count("rglru")
        row = {"phase": "train_reduced", "arch": arch,
               "loss": float(m_k["loss"]), "loss_cpu": float(m_c["loss"]),
               "grad_norm": float(m_k["grad_norm"]),
               "grad_norm_cpu": float(m_c["grad_norm"]),
               "grad_rel_max": grad_rel, "param_off_share": off / n,
               "param_max_diff": worst, "launches": counts,
               "expected": {"forward": n_rec, "backward": n_rec,
                            "flash_attention": 0}}
        row["ok"] = (
            math.isclose(row["loss"], row["loss_cpu"], rel_tol=1e-5)
            and math.isclose(row["grad_norm"], row["grad_norm_cpu"],
                             rel_tol=TRAIN_GRAD_TOL)
            and grad_rel <= TRAIN_GRAD_TOL
            and row["param_off_share"] <= TRAIN_FLIP_SHARE
            and worst <= 2 * TRAIN_LR + TRAIN_PARAM_TOL
            and counts == row["expected"])
        emit(row)
        if not row["ok"]:
            raise SmokeFailure(f"the reduced {arch} train step on the card "
                               f"disagrees with the CPU: {row}")
        out[arch] = row
    return out


def _restore_state(ckpt_dir, step, cfg):
    """The train state of ``step`` restored onto the card (the structure
    built on the meta device, nothing allocated twice)."""
    meta = T.init_params(cfg, device="meta")
    like = (meta, optim.adamw_init(meta, cfg.opt_moment_dtype))
    return ckpt.restore(ckpt_dir, step, like, device="cuda")


def _equal_to_checkpoint(state, ckpt_dir, step) -> dict:
    """Whether every leaf of ``state`` (params, AdamW state) equals the
    checkpoint of ``step`` bit for bit (bf16 widened to float32 in the
    file, exactly)."""
    path = Path(ckpt_dir) / f"step_{step}" / "shard_0.npz"
    differ, n = [], 0
    with np.load(path) as z:
        for p, leaf in ckpt.checkpoint._items(state):
            key = ckpt.checkpoint._key(p)
            want = torch.from_numpy(z[key]).to("cuda")
            n += 1
            if not torch.equal(leaf.detach().to(want.dtype), want):
                differ.append(key)
    return {"leaves": n, "differ": differ[:10], "n_differ": len(differ)}


def _step_phase_ms(params, opt, cfg, batch, lr) -> dict:
    """One more step timed with CUDA events by the two parts
    ``make_train_step`` runs: ``value_and_grad`` (the forward with the
    loss, then the backward) and ``apply_grads`` (the clip in place, then
    AdamW), at their defaults; and, between them, the in-place clip alone
    on the same gradients (``apply_grads`` then clips them again; the
    state is not used after)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    _, grads = lm_steps.value_and_grad(params, cfg, batch)
    ev[1].record()
    optim.clip_by_global_norm_(grads)
    ev[2].record()
    lm_steps.apply_grads(params, grads, opt, lr=lr,
                         moment_dtype=cfg.opt_moment_dtype)
    ev[3].record()
    torch.cuda.synchronize()
    return {name: ev[i].elapsed_time(ev[i + 1]) for i, name in enumerate(
        ("value_and_grad_ms", "clip_ms", "apply_grads_ms"))}


def _profiled_step(env, step, state, batch, warm_ms) -> dict:
    """One train step under the profiler: device busy time by kind
    (GEMMs, linear_scan forward and backward split by launch order, the
    head's log-softmax, everything else) and the idle share, against the
    profiled call's own wall (the profiler's overhead included) and
    against ``warm_ms``, the unprofiled steps' median wall."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = step(*state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and _device_us(e) > 0
                      and not e.key.startswith("Activity Buffer")),
                     key=lambda e: e.time_range.start)
    busy = sum(_device_us(e) for e in kernels) / 1e3
    scans = [e for e in kernels if "linear_scan" in e.key]
    half = len(scans) // 2
    split = {
        "matmul_ms": sum(_device_us(e) for e in kernels
                         if _is_matmul(e.key)) / 1e3,
        "linear_scan_forward_ms": sum(_device_us(e) for e in scans[:half])
        / 1e3,
        "linear_scan_backward_ms": sum(_device_us(e) for e in scans[half:])
        / 1e3,
        "log_softmax_ms": sum(_device_us(e) for e in kernels
                              if "softmax" in e.key.lower()) / 1e3}
    split["other_ms"] = busy - sum(split.values())
    by_kernel: dict = {}
    for e in kernels:
        us, n = by_kernel.get(e.key, (0.0, 0))
        by_kernel[e.key] = (us + _device_us(e), n + 1)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    row = {"phase": "train_profiled_step", "profiled_wall_ms": wall_ms,
           "device_busy_ms": busy, "kernels": len(kernels),
           "device_idle_share": max(0.0, 1.0 - busy / warm_ms),
           "warm_step_wall_ms": warm_ms,
           "device_idle_share_of_profiled_call": max(0.0,
                                                     1.0 - busy / wall_ms),
           "linear_scan_launches": len(scans),
           "linear_scan_share": (split["linear_scan_forward_ms"]
                                 + split["linear_scan_backward_ms"])
           / max(busy, 1e-9),
           **split,
           "top_device_ops_us_count": [[k[:60], round(us, 1), n]
                                       for k, (us, n) in top],
           "card": env["nvidia_smi"]}
    emit(row)
    return out, row


def _train_cfg():
    return ARCHS[TRAIN_ARCH].scaled(n_layers=TRAIN_LAYERS)


def phase_train(env: dict) -> dict:
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(3)
    max_err = max(_check_scan_grad(label, B, S, D, gen)
                  for label, B, S, D in SCAN_GRAD_CASES)
    times = _scan_grad_times(env, *SCAN_GRAD_CASES[-1][1:])
    _reduced_card_vs_cpu()
    torch.cuda.empty_cache()

    # Full width through launch/train.py: the main path, counts at 0 just
    # before, read just after.
    cfg = _train_cfg()
    n_rec = cfg.layer_kinds().count("rglru")
    per_step = {"linear_scan_forward": n_rec, "linear_scan_backward": n_rec,
                "flash_attention": 0}
    main_steps = TRAIN_STEPS - 1
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as ckpt_dir:
        state_gb = 12 * T.param_count(cfg) / 1e9      # 4 + 4 + 4 bytes
        free_gb = shutil.disk_usage(ckpt_dir).free / 1e9
        if free_gb < state_gb + 2:
            raise SmokeFailure(f"{free_gb:.1f} GB free under {ckpt_dir}: "
                               f"a {state_gb:.1f} GB checkpoint does not "
                               f"fit")
        args = ["--arch", TRAIN_ARCH, "--n-layers", str(TRAIN_LAYERS),
                "--steps", str(main_steps),
                "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
                "--ckpt", ckpt_dir, "--ckpt-every", str(main_steps),
                "--log-every", "1"]
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        res = lm_train.main(args)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        counts = {"linear_scan": linear_scan.launches,
                  "linear_scan_by_path": dict(linear_scan.launches_by_path),
                  "flash_attention": flash_attention.launches,
                  "gemm_int8": gemm_int8.launches}
        params, opt = res.pop("state")
        # The bytes of the state the run holds (phase dryrun holds them
        # against abstract_state's).
        state_bytes = _tree_bytes((params, opt))
        # The state the run holds equals its checkpoint, leaf for leaf.
        saved = _equal_to_checkpoint((params, opt), ckpt_dir, main_steps)
        stream = make_stream(cfg, DataConfig(global_batch=TRAIN_B,
                                             seq_len=TRAIN_S,
                                             vocab=cfg.vocab),
                             device="cuda")
        stream.seek(main_steps)
        batch = next(stream)

        # Every floating leaf gets a nonzero gradient on step 5's batch (a
        # gradient cut by a kernel would leave the RG-LRU's gates, lam, wx
        # and conv at 0).
        reset_launches()
        grads = _grads(params, cfg, batch)
        torch.cuda.synchronize()
        grad_counts = dict(linear_scan.launches_by_path,
                           flash_attention=flash_attention.launches)
        zero = [ckpt.checkpoint._key(p) for (p, _), g in zip(
            ckpt.checkpoint._items(params), grads) if not bool(g.any())]
        n_leaves = len(grads)
        del grads

        # Step 5, the run's state carried on (the schedule of a 5-step
        # run), counted and timed as main's steps are.
        lr = optim.wsd_schedule(3e-4, warmup=min(100, TRAIN_STEPS // 10 + 1),
                                total=TRAIN_STEPS)
        step = lm_steps.make_train_step(cfg, lr=lr, remat=False)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m5 = step(params, opt, batch)
        torch.cuda.synchronize()
        step5_ms = (time.perf_counter() - t0) * 1e3
        step5_counts = {"linear_scan_forward":
                        linear_scan.launches_by_path["forward"],
                        "linear_scan_backward":
                        linear_scan.launches_by_path["backward"],
                        "flash_attention": flash_attention.launches}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        p5 = [t.detach().to("cpu", copy=True)
              for t in optim.adamw.tree_leaves(params)]
        del params, opt
        torch.cuda.empty_cache()

        losses = res["losses"] + [float(m5["loss"])]
        gnorms = res["grad_norms"] + [float(m5["grad_norm"])]
        step_list = res["step_ms"] + [step5_ms]
        per_step_counts = res["launches"] + [step5_counts]
        finite = all(math.isfinite(x) for x in losses + gnorms)
        step_ms = float(np.median(step_list[1:]))
        tokens = TRAIN_B * TRAIN_S
        n_params = res["params"]
        n_attn = cfg.layer_kinds().count("attn_local")
        ctx = min(TRAIN_S, cfg.window or TRAIN_S)
        # Causal attention within the window: QK^T and PV, 2 flops a MAC,
        # x3 for forward and backward.
        attn_flops = 3 * 2 * 2 * TRAIN_B * sum(
            min(i + 1, ctx) for i in range(TRAIN_S)) * cfg.n_heads \
            * cfg.head_dim * n_attn
        flops = 6 * n_params * tokens + attn_flops
        _, _, peak_bf16, _ = card_peaks(env["device"])
        row = {"phase": "train_full_width", "arch": TRAIN_ARCH,
               "reduced": f"n_layers {ARCHS[TRAIN_ARCH].n_layers} -> "
                          f"{TRAIN_LAYERS}",
               "params": n_params, "batch": TRAIN_B, "seq": TRAIN_S,
               "steps": TRAIN_STEPS, "main_steps": main_steps,
               "dtype": cfg.dtype, "moments": cfg.opt_moment_dtype,
               "main_s": main_s, "losses": losses, "grad_norms": gnorms,
               "finite": finite, "restarts": res["restarts"],
               "step_ms": step_list, "step_ms_median_warm": step_ms,
               "tokens_per_s": tokens / step_ms * 1e3,
               "model_flops": flops, "mfu": flops / (step_ms * 1e-3)
               / peak_bf16, "peak_memory_gb": peak_gb,
               "launches": counts, "launches_per_step": per_step_counts,
               "expected_per_step": per_step,
               "checkpoints": sorted(os.listdir(ckpt_dir)),
               "state_equals_checkpoint": saved,
               "disk_free_gb_before": free_gb, "state_gb": state_gb,
               "state_bytes": state_bytes, "card": env["nvidia_smi"]}
        emit(row)
        if not finite or res["restarts"]:
            raise SmokeFailure(f"full-width training: losses {losses}, "
                               f"grad norms {gnorms}, restarts "
                               f"{res['restarts']}")
        if any(n != per_step for n in per_step_counts) or \
                counts["gemm_int8"]:
            raise SmokeFailure(f"full-width training launched "
                               f"{per_step_counts} a step, expected "
                               f"{per_step}")
        del res

        # Step 5 replayed from step 4's checkpoint: the run's step 5 bit
        # for bit (two runs of one step from one state), and the params
        # moved. Then one warm step profiled, and one timed by parts.
        t0 = time.perf_counter()
        params, opt = _restore_state(ckpt_dir, main_steps, cfg)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        p4 = [t.detach().to("cpu", copy=True)
              for t in optim.adamw.tree_leaves(params)]
        params, opt, _ = step(params, opt, batch)
        replay = [ckpt.checkpoint._key(p) for (p, t), want in zip(
            ckpt.checkpoint._items(params), p5)
            if not torch.equal(t.detach().cpu(), want)]
        moved = [sum(int((a != b).sum()) for a, b in zip(p4, p5)),
                 sum(a.numel() for a in p4)]
        unmoved = [ckpt.checkpoint._key(p) for (p, _), a, b in zip(
            ckpt.checkpoint._items(params), p4, p5) if torch.equal(a, b)]
        del p4, p5
        (params, opt, _), prof_row = _profiled_step(
            env, step, (params, opt), next(stream), step_ms)
        parts = _step_phase_ms(params, opt, cfg, next(stream), lr)
        del params, opt
        torch.cuda.empty_cache()
    det = {"phase": "train_checks", "grad_launches": grad_counts,
           "leaves": n_leaves, "zero_grad_leaves": zero,
           "state_equals_checkpoint": saved["n_differ"] == 0,
           "replay_differs": replay, "elements_moved_by_step_5": moved,
           "leaves_unmoved_by_step_5": unmoved, "restore_s": restore_s,
           "step_parts_ms": parts, "phase_s": time.perf_counter() - t_phase}
    emit(det)
    if grad_counts != {"forward": n_rec, "backward": n_rec,
                       "flash_attention": 0}:
        raise SmokeFailure(f"the full-width loss and gradients launched "
                           f"{grad_counts}")
    if zero:
        raise SmokeFailure(f"floating leaves with an all-zero gradient: "
                           f"{zero}")
    if saved["n_differ"] or replay or not moved[0]:
        raise SmokeFailure(f"the state differs from its checkpoint, or step "
                           f"5 replayed from step 4's checkpoint is not the "
                           f"run's step 5, or the params did not move: "
                           f"{det}")
    return {"max_abs_err": max_err, "times": times, "full": row,
            "profile": prof_row, "launches": per_step}


# ---------------------------------------------------------------------------
# Phase 18: int8 weight-only serving (quantize_params_int8 on the card)
# ---------------------------------------------------------------------------


# Yi-6B served from int8 weights through the port's steps, as
# examples/serve_batched.py serves, beside bf16 in the same run: batch,
# prompt, tokens generated (the launcher's SERVE_ARGS).
INT8_SERVE_B, INT8_SERVE_P, INT8_SERVE_GEN = 4, 512, 32


def _tree_cpu(node):
    if isinstance(node, dict):
        return {k: _tree_cpu(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_cpu(v) for v in node]
    return node.to("cpu")


def _paths(node, path=""):
    """(path, leaf) pairs of a tree of dicts and lists."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _paths(v, f"{path}/{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from _paths(v, f"{path}/{i}")
    else:
        yield path, node


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _int8_exact(params, qparams) -> dict:
    """Layer 0, the last layer and the head, quantized on the card, against
    the same bf16 leaves quantized on the CPU: every int8 code and float32
    scale, and the bf16 weight ``apply_dense`` multiplies, bit for bit."""
    def pick(tree):
        return {"seg0": [tree["seg0"][0], tree["seg0"][-1]],
                "lm_head": tree["lm_head"]}

    want = L.quantize_params_int8(_tree_cpu(pick(params)))
    got = pick(qparams)
    leaves_w, leaves_g = dict(_paths(want)), dict(_paths(got))
    differ = [p for p, w in leaves_w.items()
              if p not in leaves_g or leaves_g[p].dtype != w.dtype
              or not torch.equal(_bits(leaves_g[p].cpu()), _bits(w))]
    dense = [p.rsplit("/", 1)[0] for p in leaves_w if p.endswith("/w_scale")]

    def node(tree, path):
        for key in path.strip("/").split("/"):
            tree = tree[int(key)] if isinstance(tree, list) else tree[key]
        return tree

    dequant_differ = [
        p for p in dense if not torch.equal(
            _bits(L.apply_dense_weight(node(got, p), torch.bfloat16).cpu()),
            _bits(L.apply_dense_weight(node(want, p), torch.bfloat16)))]
    return {"leaves": len(leaves_w), "leaves_differ": differ,
            "int8_leaves": sum(t.dtype == torch.int8
                               for t in leaves_w.values()),
            "dense_layers": len(dense), "dequantized_differ": dequant_differ}


def _serve_steps(cfg, params, seed: int = 1) -> dict:
    """Prefill and greedy decode through ``make_prefill_step`` and
    ``make_serve_step`` at INT8_SERVE_B x INT8_SERVE_P, INT8_SERVE_GEN
    tokens: time to first token (the prefill and its argmax, synchronised),
    decode tokens/s over the INT8_SERVE_GEN - 1 steps, the launches, the
    ids, and the cache and last token (one slot to spare, for the decode
    breakdown's step)."""
    B, P, n = INT8_SERVE_B, INT8_SERVE_P, INT8_SERVE_GEN
    prefill = lm_steps.make_prefill_step(cfg)
    decode = lm_steps.make_serve_step(cfg)
    g = torch.Generator(device="cuda").manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=g, device="cuda")
    cache = T.init_cache(cfg, B, P + n + 1, device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    last, cache = prefill(params, cache, {"tokens": prompt})
    tok = last.float().argmax(-1)[:, None]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs = [tok]
    for _ in range(n - 1):
        nxt, cache = decode(params, cache, {"tokens": tok})
        tok = nxt[:, None]
        outs.append(tok)
    ids = torch.cat(outs, 1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"ttft_ms": (t1 - t0) * 1e3, "decode_s": t2 - t1,
            "decode_tok_s": (n - 1) * B / (t2 - t1),
            "end_to_end_tok_s": n * B / (t2 - t0), "launches": launches(),
            "ids": ids, "cache": cache, "tok": tok}


def _int8_deepseek() -> dict:
    """DeepSeek-V2 cut to MLA_LAYERS layers, int8 (MLA's projections and
    ``wkv_b``, the router and the routed and shared experts): the int8
    forward against the bf16 one with the routing flips quantization
    causes counted, then the absorbed decode teacher-forced against the
    int8 forward by phase mla_moe's rules, in bf16 and in float32."""
    cfg = ARCHS[MLA_ARCH].scaled(n_layers=MLA_LAYERS)
    params, _ = _init(cfg)
    qparams = L.quantize_params_int8(params)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (MLA_B, MLA_S), generator=gen,
                           device="cuda")
    with _recorded_routes() as calls:
        logits_b = T.forward(params, cfg, {"tokens": tokens})[0]
    routes_b = _topk_sets(calls, MLA_B, [MLA_S], [MLA_S])
    del params
    torch.cuda.empty_cache()
    reset_launches()
    with _recorded_routes() as calls:
        logits_q, _, aux = T.forward(qparams, cfg, {"tokens": tokens})
    torch.cuda.synchronize()
    counts = launches()
    routes_q = _topk_sets(calls, MLA_B, [MLA_S], [MLA_S])
    same_set = (routes_b == routes_q).all(-1)              # [layers, B, S]
    row = {"phase": "int8_mla_moe_forward", "arch": MLA_ARCH,
           "reduced": f"n_layers {ARCHS[MLA_ARCH].n_layers} -> {MLA_LAYERS}",
           "tokens": [MLA_B, MLA_S], "launches": counts,
           "aux_loss": float(aux), "finite": _finite(logits_q),
           "int8_vs_bf16": _close_chunked(logits_q, logits_b),
           "top1_agreement_vs_bf16": _top1_agreement(logits_q, logits_b),
           "moe_layers": same_set.shape[0],
           "positions": same_set[0].numel(),
           "positions_with_a_routing_flip": int((~same_set.all(0)).sum()),
           "flip_share_by_layer": [float((~s).float().mean())
                                   for s in same_set]}
    emit(row)
    del logits_b, logits_q, calls
    if any(counts.values()) or not row["finite"]:
        raise SmokeFailure(f"the int8 DeepSeek-V2 forward launched {counts} "
                           f"or gave non-finite logits: {row}")
    cfg_tf = cfg.scaled(moe_capacity_factor=float(math.ceil(
        cfg.moe_n_experts / cfg.moe_top_k)))
    _mla_teacher_forced("int8_mla_moe", qparams, cfg_tf, tokens, MLA_TF_TOL)
    q32 = _to(qparams, torch.float32)
    del qparams
    torch.cuda.empty_cache()
    _mla_teacher_forced("int8_mla_moe_f32", q32, cfg_tf, tokens,
                        MLA_F32_TF_TOL)
    del q32
    torch.cuda.empty_cache()
    return row


def phase_int8(env: dict) -> dict:
    t_phase = time.perf_counter()
    cfg = ARCHS[LM_ARCH]
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (LM_B, LM_S), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens}
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params, init_s = _init(cfg)
    alloc_bf16 = torch.cuda.memory_allocated() - base
    t0 = time.perf_counter()
    qparams = L.quantize_params_int8(params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    # What the int8 tree allocated: its new codes and scales (the
    # quantization's temporaries are freed by now) and the leaves it
    # shares with the bf16 tree (the embedding, the norms).
    alloc_int8 = torch.cuda.memory_allocated() - base - alloc_bf16 + (
        _tree_bytes(params) + _tree_bytes(qparams)
        - _tree_bytes((params, qparams)))
    exact = _int8_exact(params, qparams)
    emit({"phase": "int8_quantize", "arch": LM_ARCH,
          "params": T.param_count(cfg), "init_s": init_s,
          "quantize_s": quant_s, **exact})
    if exact["leaves_differ"] or exact["dequantized_differ"]:
        raise SmokeFailure(f"quantize_params_int8 on the card differs from "
                           f"the CPU: {exact}")

    # The main path: the int8 forward, counts at 0 just before, read just
    # after; then the same int8 weights on the plain attention, and the
    # bf16 forward of the weights they came from.
    reset_launches()
    logits_q = _forward(qparams, cfg, batch, "kernel")
    torch.cuda.synchronize()
    counts = launches()
    logits_t = _forward(qparams, cfg, batch, "torch")
    routes = _close_chunked(logits_q, logits_t)
    del logits_t
    logits_b = _forward(params, cfg, batch, "kernel")
    row = {"phase": "int8_forward", "arch": LM_ARCH,
           "tokens": [LM_B, LM_S], "launches": counts,
           "expected_flash_attention": cfg.n_layers,
           "kernel_vs_kernel_free": routes, "route_tol": LM_ROUTE_TOL,
           "int8_vs_bf16": _close_chunked(logits_q, logits_b),
           "top1_agreement_vs_bf16": _top1_agreement(logits_q, logits_b),
           "finite": _finite(logits_q),
           "logits_max_abs": float(logits_q.abs().max())}
    emit(row)
    del logits_q, logits_b
    if counts != {"gemm_int8": 0, "flash_attention": cfg.n_layers,
                  "linear_scan": 0} or not row["finite"] \
            or routes["max_abs_diff"] > LM_ROUTE_TOL:
        raise SmokeFailure(f"the int8 Yi-6B forward: {row}")
    _forward_time(env, "int8_forward",
                  lambda: _forward(qparams, cfg, batch, "kernel"))

    # Served from bf16 and int8 in turns (bf16, int8, int8, bf16), the
    # same prompt; each decode step's time broken down once.
    runs = {}
    for weights in ("bf16", "int8", "int8", "bf16"):
        r = _serve_steps(cfg, qparams if weights == "int8" else params)
        runs.setdefault(weights, []).append(r)
    for weights, rs in runs.items():
        r = rs[0]
        emit({"phase": "int8_serve", "arch": LM_ARCH, "weights": weights,
              "batch": INT8_SERVE_B, "prompt_len": INT8_SERVE_P,
              "gen": INT8_SERVE_GEN,
              **{k: [x[k] for x in rs] for k in (
                  "ttft_ms", "decode_s", "decode_tok_s",
                  "end_to_end_tok_s")},
              "launches": [x["launches"] for x in rs],
              "ids_repeat": torch.equal(rs[0]["ids"], rs[1]["ids"]),
              "sample_ids": r["ids"][0, :8].tolist()})
        if any(v for x in rs for v in x["launches"].values()):
            raise SmokeFailure(f"the {weights} prefill and decode launched "
                               f"{[x['launches'] for x in rs]} (the plain "
                               f"attention core: none expected)")
    ids_b, ids_q = runs["bf16"][0]["ids"], runs["int8"][0]["ids"]
    breakdown = {w: phase_decode_breakdown(
        cfg, qparams if w == "int8" else params, runs[w][0]["cache"],
        runs[w][0]["tok"], w) for w in ("bf16", "int8")}
    agree = float((ids_b == ids_q).float().mean())
    first = [int(row.nonzero()[0]) if bool(row.any()) else None
             for row in (ids_b != ids_q)]
    del runs, ids_b, ids_q
    torch.cuda.empty_cache()

    bytes_bf16, bytes_int8 = _tree_bytes(params), _tree_bytes(qparams)
    del params
    summary = {"phase": "int8_summary", "arch": LM_ARCH,
               "greedy_token_agreement_vs_bf16": agree,
               "first_differing_step_per_sequence": first,
               "param_bytes": {"bf16": bytes_bf16, "int8": bytes_int8},
               "memory_allocated": {"bf16": alloc_bf16, "int8": alloc_int8},
               "decode_step": {w: {k: b[k] for k in (
                   "wall_ms_median", "device_busy_ms", "device_idle_share",
                   "host_enqueue_ms", "kernels", "weight_read_bound_ms")}
                   for w, b in breakdown.items()},
               "card": env["nvidia_smi"]}
    emit(summary)
    del qparams
    torch.cuda.empty_cache()
    deepseek = _int8_deepseek()
    emit({"phase": "int8_done", "phase_s": time.perf_counter() - t_phase})
    return {"launches": counts["flash_attention"],
            "param_bytes": summary["param_bytes"], "deepseek": deepseek}


# ---------------------------------------------------------------------------
# Phase 19: the dry run on the meta device, and its numbers against the card
# ---------------------------------------------------------------------------


# The two sweeps run at once over the machine's 8 cores, one process a
# cell: the pjit sweep's two longest cells (DeepSeek-V2/V3's train_4k,
# about 85 s each, the whole step traced twice) hold two of its five while
# the other three take its other cells (about 290 s of work), and the
# pipeline sweep's cells (about 200 s) share three.
DRYRUN_JOBS = {"pjit": 5, "pipeline": 3}


# ---------------------------------------------------------------------------
# Phase mesh: the mesh runtime on the card
# ---------------------------------------------------------------------------

# (b): one DeepSeek-V2 MoE layer at full width on two gloo ranks, at a
# capacity factor that drops nothing; its float32 output held to the CPU
# tests' bound (tests/test_torch_moe_parallel.py Y_REL_TOL: measured there
# 4.4e-7 of the largest |y| from the reference, 1.0e-7 from _moe_local at
# top-6), over the largest |y|.
MESH_MOE_ARCH, MESH_MOE_B, MESH_MOE_S, MESH_MOE_CF = MLA_ARCH, 2, 1024, 8.0
MESH_MOE_TOL = 1e-6
MESH_MOE_REPS = 3
MESH_JOIN_S = 600


def _mesh_group(root: str, world: int, rank: int, backend: str) -> None:
    """The default group through a ``FileStore`` under ``root``: no port,
    nothing but this run's ranks."""
    import datetime
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(root, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=300))


def _placed_forward(params, cfg, batch, mesh):
    with lm_mesh.set_mesh(mesh):
        return _forward(params, cfg, batch, "kernel")


def _mesh_one_rank(env: dict) -> dict:
    """(a) Full-width Yi-6B placed by ``param_shardings`` on a one-rank
    NCCL mesh (1, 1) on cuda:0: its forward on LM_B x LM_S tokens under
    DTensor, 32 ``flash_attention`` launches through the wrapper's rule,
    logits against the same params' unplaced forward; wall and idle share
    of both."""
    cfg = ARCHS[LM_ARCH]
    with tempfile.TemporaryDirectory(prefix="mesh_a_") as root:
        _mesh_group(root, 1, 0, "nccl")
        try:
            mesh = lm_mesh.make_debug_mesh(1, 1)
            params = T.init_params(cfg, seed=0, device="cuda")
            gen = torch.Generator(device="cuda").manual_seed(1)
            batch = {"tokens": torch.randint(0, cfg.vocab, (LM_B, LM_S),
                                             generator=gen, device="cuda")}
            logits_u = _forward(params, cfg, batch, "kernel")
            t0 = time.perf_counter()
            placed = SH.place(params, SH.param_shardings(cfg, mesh, params))
            pbatch = SH.place(batch, SH.batch_shardings(mesh, batch))
            torch.cuda.synchronize()
            place_s = time.perf_counter() - t0
            reset_launches()
            logits_p = _placed_forward(placed, cfg, pbatch, mesh)
            torch.cuda.synchronize()
            got = launches()
            local = logits_p.to_local()
            row = {"phase": "mesh_one_rank", "arch": LM_ARCH,
                   "mesh": lm_mesh.mesh_shape(mesh), "backend": "nccl",
                   "tokens": [LM_B, LM_S], "place_s": place_s,
                   "placements": sorted({str(t.placements) for t in
                                         optim.adamw.tree_leaves(placed)}),
                   "logits_placements": str(logits_p.placements),
                   "launches": got, "expected_flash_attention": cfg.n_layers,
                   "bit_for_bit": bool(torch.equal(local, logits_u)),
                   **_close(local, logits_u), "card": env["nvidia_smi"]}
            emit(row)
            if got["flash_attention"] != cfg.n_layers or \
                    got["gemm_int8"] or got["linear_scan"]:
                raise SmokeFailure(f"the placed Yi-6B forward launched "
                                   f"{got}, expected {cfg.n_layers} "
                                   f"flash_attention")
            if row["max_abs_diff"] > LM_ROUTE_TOL or \
                    not torch.isfinite(local).all():
                raise SmokeFailure(f"the placed forward's logits are "
                                   f"{row['max_abs_diff']} from the "
                                   f"unplaced one's")
            del local, logits_p, logits_u
            times = {
                "unplaced": _forward_time(env, "mesh_forward_unplaced",
                                          lambda: _forward(params, cfg, batch,
                                                           "kernel")),
                "placed": _forward_time(env, "mesh_forward_placed",
                                        lambda: _placed_forward(
                                            placed, cfg, pbatch, mesh))}
            return {"launches": got["flash_attention"],
                    "bit_for_bit": row["bit_for_bit"],
                    "max_abs_diff": row["max_abs_diff"],
                    **{f"{k}_wall_ms": v["wall_ms_median"]
                       for k, v in times.items()},
                    **{f"{k}_idle_share": v["device_idle_share"]
                       for k, v in times.items()}}
        finally:
            dist.destroy_process_group()


def _mesh_moe_rank(rank: int, root: str) -> None:
    """(b) One rank of two (gloo, both on cuda:0): one DeepSeek-V2 MoE
    layer at full width through ``moe_apply`` under a (1, 2) mesh, each
    rank holding 80 of the 160 experts; rank 0 also runs ``_moe_local`` on
    the same card. Writes ``rank<r>.json`` under ``root``."""
    torch.cuda.set_device(0)
    _mesh_group(root, 2, rank, "gloo")
    out: dict = {}
    try:
        mesh = lm_mesh.make_debug_mesh(1, 2)
        cfg = ARCHS[MESH_MOE_ARCH].scaled(moe_capacity_factor=MESH_MOE_CF)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            gen = torch.Generator(device="cuda").manual_seed(0)
            p = L.moe_init(gen, cfg, dtype, "cuda")
            x = torch.randn((MESH_MOE_B, MESH_MOE_S, cfg.d_model),
                            generator=gen, device="cuda").to(dtype)
            xt = x.reshape(-1, cfg.d_model)
            whole = L.moe_route(p, cfg, xt)
            mine = L.moe_route_shard(p, cfg, xt, rank, 2)
            E_loc = cfg.moe_n_experts // 2
            rows = slice(rank * E_loc, (rank + 1) * E_loc)
            valid = whole["valid"][rows]
            routing = bool(
                torch.equal(mine["topi"], whole["topi"])
                and torch.equal(mine["valid"], valid)
                and torch.equal(mine["tok_idx"][valid],
                                whole["tok_idx"][rows][valid]))
            want = L._moe_local(p, cfg, x) if rank == 0 else None
            # The experts split over model as param_shardings splits them,
            # the rest replicated as _moe_sharded takes it: gloo gathers
            # no CUDA tensor, so nothing may need an all-gather here.
            placed = SH.place(p, SH.map_with_path(
                lambda path, _: SH.named_sharding(
                    mesh, ("model",) if path in ("wi", "wg", "wo") else ()),
                p))
            expert_bytes = sum(placed[k].to_local().numel()
                               * placed[k].to_local().element_size()
                               for k in ("wi", "wg", "wo"))
            del p
            torch.cuda.empty_cache()
            px = SH.place(x, SH.named_sharding(mesh, ()))
            L.moe_apply.calls_by_path = {"local": 0, "expert_parallel": 0}
            walls = []
            for i in range(MESH_MOE_REPS + 1):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with lm_mesh.set_mesh(mesh), CommDebugMode() as cm:
                    y, aux = L.moe_apply(placed, cfg, px)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            counts = {str(k): v for k, v in cm.get_comm_counts().items()}
            y_loc = y.to_local()
            # The combine's all-reduce alone, on a tensor of y's size.
            buf = torch.empty_like(y_loc)
            ar = []
            for _ in range(MESH_MOE_REPS + 1):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dist.all_reduce(buf, group=mesh.get_group("model"))
                torch.cuda.synchronize()
                ar.append((time.perf_counter() - t0) * 1e3)
            row = {"dtype": name, "routing_identical": routing,
                   "paths": dict(L.moe_apply.calls_by_path),
                   "collectives": counts,
                   "wall_ms_median": float(np.median(walls[1:])),
                   "first_call_ms": walls[0],
                   "all_reduce_ms_median": float(np.median(ar[1:])),
                   "all_reduce_bytes": buf.numel() * buf.element_size(),
                   "expert_bytes_on_rank": expert_bytes,
                   "y_finite": bool(torch.isfinite(y_loc).all()),
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
            if want is not None:
                wy, waux = want
                row.update(
                    y_rel_vs_local=float((y_loc.float() - wy.float()).abs()
                                         .max() / wy.float().abs().max()),
                    aux=float(aux.to_local()), aux_local=float(waux))
            out[name] = row
            del placed, px, y, aux, y_loc, buf, want
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _mesh_two_ranks(env: dict) -> dict:
    """(b) Two gloo processes on cuda:0 (the machine has one card, and NCCL
    puts no two ranks on one GPU); a failed child fails the run."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mesh_b_") as root:
        procs = [ctx.Process(target=_mesh_moe_rank, args=(r, root))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=max(1.0, MESH_JOIN_S - (time.perf_counter() - t0)))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            raise SmokeFailure(f"the two gloo ranks exited {codes}")
        ranks = [json.loads(Path(root, f"rank{r}.json").read_text())
                 for r in range(2)]
    rows = {}
    for name in ranks[0]:
        row = {"phase": "mesh_moe", "arch": MESH_MOE_ARCH, "mesh": [1, 2],
               "backend": "gloo", "device": "cuda:0 for both ranks",
               "tokens": [MESH_MOE_B, MESH_MOE_S],
               "capacity_factor": MESH_MOE_CF, "ranks": [r[name] for r in
                                                          ranks],
               "tolerance_rel": MESH_MOE_TOL, "seconds":
               time.perf_counter() - t0, "card": env["nvidia_smi"]}
        emit(row)
        r0 = ranks[0][name]
        ok = all(r[name]["routing_identical"] and r[name]["y_finite"]
                 and r[name]["paths"] == {"local": 0,
                                          "expert_parallel": MESH_MOE_REPS + 1}
                 for r in ranks)
        if name == "float32":
            ok = ok and r0["y_rel_vs_local"] <= MESH_MOE_TOL
        if not ok:
            raise SmokeFailure(f"the expert-parallel MoE layer failed: {row}")
        rows[name] = r0
    return rows


def phase_mesh(env: dict) -> dict:
    """(a) and (b); (c), the dry run's collectives, is phase dryrun's."""
    t_phase = time.perf_counter()
    one = _mesh_one_rank(env)
    torch.cuda.empty_cache()
    two = _mesh_two_ranks(env)
    row = {"phase": "mesh", "one_rank": one, "two_ranks": {
        k: {f: v.get(f) for f in ("wall_ms_median", "all_reduce_ms_median",
                                  "y_rel_vs_local", "collectives")}
        for k, v in two.items()},
        "phase_s": time.perf_counter() - t_phase, "card": env["nvidia_smi"]}
    emit(row)
    return {"launches": one["launches"], **row}


# ---------------------------------------------------------------------------
# Phase pipeline_lm: the flexible layer pipeline (core/pipeline.py)
# ---------------------------------------------------------------------------

# Full-width Yi-6B over a (data 1, stage 2, tp 2) mesh of four gloo
# processes, all on cuda:0 (the machine has one card, and NCCL puts no two
# ranks on one GPU): the prefill on PIPE_B x PIPE_S tokens, then one loss
# and its backward on PIPE_B x PIPE_LOSS_S, K microbatches each.
PIPE_MESH = (1, 2, 2)
PIPE_WORLD = math.prod(PIPE_MESH)
PIPE_B, PIPE_S, PIPE_LOSS_S, PIPE_K = 2, 2048, 1024, 2
PIPE_REPS = 2
PIPE_JOIN_S = 420
# Tolerances of the pipelined loss and gradient against the sequential
# ones of the same bf16 weights, each twice the largest spread measured by
# this script on an NVIDIA H100 80GB HBM3 at 700 W. The two compute the
# same function in another order (each block's products split over tp and
# summed in bf16, microbatches of one row, the vocab-parallel log-sum-exp),
# so the bf16 rounding of 32 layers, not the pipeline, sets their distance,
# as it sets LM_ROUTE_TOL's (the logits are held to that). Measured: the
# loss (11.556) 2.4e-4 from the sequential one, every rank the same; the
# compared gradient leaves at most 0.0343 in relative L2 (the first
# layer's wq shard; the final norm 0.0163).
PIPE_LOSS_TOL = 5e-4
PIPE_GRAD_TOL = 0.07     # relative L2 of a compared leaf
# (name, stage, slot, path) of the gradient leaves held against the
# sequential gradient: tp-replicated, column- and row-split unit leaves of
# both stages, and the vocab-split tables.
PIPE_GRAD_LEAVES = [("final_norm", None, None, "final_norm/scale"),
                    ("embed", None, None, "embed"),
                    ("lm_head", None, None, "lm_head/w"),
                    ("ln1 first", 0, 0, "ln1/scale"),
                    ("wq first", 0, 0, "attn/wq/w"),
                    ("wo last", 1, -1, "mlp/wo/w")]


def _pipe_batch(cfg, S: int, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (PIPE_B, S), generator=gen,
                           device="cuda")
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}


def _pipe_leaf(params: dict, stage, slot, path: str, pm=None):
    """A leaf of the whole params (``pm`` None) or of one rank's, by
    ``PIPE_GRAD_LEAVES``' address."""
    if slot is None:
        node = params
    else:
        node = params["units"][stage][slot] if pm is None else \
            params["units"][slot]
    for k in path.split("/"):
        node = node[k]
    return node


def _pipe_timed_comm(fn, calls: dict):
    """``fn`` wrapped to add its wall ms (synchronised on both sides, so the
    device work before it is not counted) to ``calls``."""
    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        calls["ms"] += (time.perf_counter() - t0) * 1e3
        calls["calls"] += 1
        return out
    return timed


def _pipe_run(fn, reps: int) -> tuple:
    """(result of the first call, the median wall ms of ``reps`` later
    synchronised calls; every rank starts each call together)."""
    walls, out = [], None
    for i in range(reps + 1):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        out = got if out is None else out
    return out, float(np.median(walls[1:])), walls[0]


def _pipe_instrumented(fn) -> dict:
    """One more call of ``fn`` with each collective of the pipeline module
    timed: the ms each rank spends in its all-reduces and in the stage
    hand-off, waiting for its peers included."""
    stats = {"all_reduce": {"ms": 0.0, "calls": 0},
             "handoff": {"ms": 0.0, "calls": 0}}
    saved = PL._all_reduce, PL._send_recv
    PL._all_reduce = _pipe_timed_comm(saved[0], stats["all_reduce"])
    PL._send_recv = _pipe_timed_comm(saved[1], stats["handoff"])
    try:
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        stats["wall_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        PL._all_reduce, PL._send_recv = saved
    return stats


def _pipe_comm_alone(pm, like: torch.Tensor) -> dict:
    """The wall ms of one tp all-reduce and one stage hand-off of a
    microbatch's activations (``like``) alone, the medians of a few."""
    y = like.clone()
    ar, ho = [], []
    for _ in range(PIPE_REPS + 2):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        PL._all_reduce(y, pm.axes("tp"))
        torch.cuda.synchronize()
        ar.append((time.perf_counter() - t0) * 1e3)
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        PL._send_recv(y if pm.stage == 0 else None, 1 if pm.stage == 0
                      else None, y, 0 if pm.stage == 1 else None,
                      pm.groups["stage"][0])
        torch.cuda.synchronize()
        ho.append((time.perf_counter() - t0) * 1e3)
    return {"all_reduce_ms": float(np.median(ar[1:])),
            "handoff_ms": float(np.median(ho[1:])),
            "bytes": like.numel() * like.element_size()}


def _pipe_rank(rank: int, root: str) -> None:
    """One rank of phase pipeline_lm: its stage's units and tp slices drawn
    on cuda:0 (seed 0), the pipelined prefill (kernel attention) and the
    pipelined loss with its backward (plain attention). Writes
    ``rank<r>.json`` and its tensors (``rank<r>.pt``) under ``root``."""
    torch.cuda.set_device(0)
    _mesh_group(root, PIPE_WORLD, rank, "gloo")
    out: dict = {}
    try:
        cfg = ARCHS[LM_ARCH]
        mesh = PL.make_pipeline_mesh(*PIPE_MESH)
        pm = PL.PipelineCoords.of(mesh)
        out["coords"] = {"stage": pm.stage, "tp": pm.tp}
        t0 = time.perf_counter()
        params, kind = PL.build_pipeline_params(cfg, PIPE_MESH[1], seed=0,
                                                device="cuda", coords=pm)
        torch.cuda.synchronize()
        out["build_s"] = time.perf_counter() - t0
        leaves = [t for t in T._leaves({k: v for k, v in params.items()
                                        if k != "unit_mask"})
                  if t.is_floating_point()]
        leaves = list({id(t): t for t in leaves}.values())
        out["param_bytes"] = sum(t.numel() * t.element_size()
                                 for t in leaves)
        ctx = PL.PipelineContext(cfg=cfg, unit_kind=kind, S=PIPE_MESH[1],
                                 T=PIPE_MESH[2], n_micro=PIPE_K)
        batch = _pipe_batch(cfg, PIPE_S, seed=1)
        prefill = PL.pipeline_prefill_fn(ctx, mesh)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        PL.reset_comm_counts()
        dist.barrier()
        logits = prefill(params, {"tokens": batch["tokens"]})
        torch.cuda.synchronize()
        out["prefill"] = {
            "launches": launches(),
            "comm": {k: dict(v) for k, v in PL.comm_counts.items()},
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        _, wall, first = _pipe_run(
            lambda: prefill(params, {"tokens": batch["tokens"]}), PIPE_REPS)
        ops = _device_ops(lambda: prefill(params,
                                          {"tokens": batch["tokens"]}))
        busy = sum(us for _, us, _ in ops) / 1e3
        out["prefill"].update(
            wall_ms_median=wall, first_call_ms=first, device_busy_ms=busy,
            flash_attention_ms=sum(us for k, us, _ in ops
                                   if "flash_fwd" in k) / 1e3,
            idle_share=max(0.0, 1.0 - busy / wall),
            comm_in_path=_pipe_instrumented(
                lambda: prefill(params, {"tokens": batch["tokens"]})))
        # The loss and its backward: params marked trainable, attention on
        # the plain path (the kernel has no gradient).
        loss_batch = _pipe_batch(cfg, PIPE_LOSS_S, seed=2)
        loss_fn = PL.pipeline_loss_fn(ctx, mesh)
        mine = {name: _pipe_leaf(params, stage, slot, path, pm)
                for name, stage, slot, path in PIPE_GRAD_LEAVES
                if stage is None or stage == pm.stage}
        for t in leaves:
            t.requires_grad_(True)

        def step():
            """The loss, the compared leaves' gradients (on the host) and
            whether every leaf's gradient is finite, and how many are 0:
            one gradient tree alive at a time."""
            loss = loss_fn(params, loss_batch)
            grads = torch.autograd.grad(loss, leaves)
            by_id = {id(t): g for t, g in zip(leaves, grads)}
            return (float(loss.detach()),
                    {k: by_id[id(t)].float().cpu() for k, t in mine.items()},
                    all(bool(torch.isfinite(g).all()) for g in grads),
                    sum(not bool(g.any()) for g in grads))

        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        PL.reset_comm_counts()
        (loss, got, finite, zeros), wall, first = _pipe_run(step, 1)
        out["loss"] = {
            "value": loss, "wall_ms_median": wall, "first_call_ms": first,
            "launches": launches(),
            "comm": {k: {n: v // 2 for n, v in row.items()}
                     for k, row in PL.comm_counts.items()},
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "grad_leaves": len(leaves), "grad_finite": finite,
            "grad_zero_leaves": zeros}
        ops = _device_ops(step)
        busy = sum(us for _, us, _ in ops) / 1e3
        out["loss"].update(device_busy_ms=busy,
                           idle_share=max(0.0, 1.0 - busy / wall),
                           comm_in_path=_pipe_instrumented(step))
        tensors = {"grads": got}
        if rank == 0:
            tensors["logits"] = logits.cpu()
        for t in leaves:
            t.requires_grad_(False)
        out["comm_alone"] = _pipe_comm_alone(pm, torch.zeros(
            (PIPE_B // PIPE_K, PIPE_S, cfg.d_model), dtype=torch.bfloat16,
            device="cuda"))
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.save(tensors, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _pipe_spawn(root: str) -> list:
    """The four ranks; a failed or hung child fails the run."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_pipe_rank, args=(r, root))
             for r in range(PIPE_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=max(1.0, PIPE_JOIN_S - (time.perf_counter() - t0)))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * PIPE_WORLD:
        raise SmokeFailure(f"the {PIPE_WORLD} pipeline ranks exited {codes}")
    return [json.loads(Path(root, f"rank{r}.json").read_text())
            for r in range(PIPE_WORLD)]


def phase_pipeline_lm(env: dict) -> dict:
    """Full-width Yi-6B pipelined over (data 1, stage 2, tp 2), four gloo
    ranks on cuda:0: the prefill's last-token logits against the sequential
    kernel forward of the same weights (drawn here from the same per-unit
    generators), exactly (K + S - 1) x 16 ``flash_attention`` launches a
    rank; the loss against the sequential loss, every gradient leaf finite
    and nonzero, a few against the sequential gradient; wall, collectives,
    memory and idle share a rank."""
    t_phase = time.perf_counter()
    cfg = ARCHS[LM_ARCH]
    S, K = PIPE_MESH[1], PIPE_K
    with tempfile.TemporaryDirectory(prefix="pipeline_lm_") as root:
        ranks = _pipe_spawn(root)
        tensors = [torch.load(os.path.join(root, f"rank{r}.pt"))
                   for r in range(PIPE_WORLD)]
    spawn_s = time.perf_counter() - t_phase
    want_launches = (K + S - 1) * cfg.n_layers // S
    # The sequential reference, the whole params on this process.
    full, kind = PL.build_pipeline_params(cfg, S, seed=0, device="cuda")
    batch = _pipe_batch(cfg, PIPE_S, seed=1)
    reset_launches()
    t0 = time.perf_counter()
    want_logits = PL.sequential_prefill(full, cfg, kind,
                                        {"tokens": batch["tokens"]})
    torch.cuda.synchronize()
    seq_prefill_ms = (time.perf_counter() - t0) * 1e3
    seq_launches = launches()["flash_attention"]
    got_logits = tensors[0]["logits"].cuda()
    logits_check = {**_close(got_logits, want_logits),
                    "top1_agreement": float((got_logits.argmax(-1)
                                             == want_logits.argmax(-1))
                                            .float().mean()),
                    "finite": bool(torch.isfinite(got_logits).all())}
    loss_batch = _pipe_batch(cfg, PIPE_LOSS_S, seed=2)
    compared = {name: _pipe_leaf(full, stage, slot, path)
                for name, stage, slot, path in PIPE_GRAD_LEAVES}
    wanted = list({id(t): t for t in compared.values()}.values())
    for t in wanted:
        t.requires_grad_(True)
    try:
        t0 = time.perf_counter()
        seq_loss = PL.sequential_loss(full, cfg, kind, loss_batch,
                                      remat=True)
        seq_grads = torch.autograd.grad(seq_loss, wanted)
        seq_loss = float(seq_loss.detach())
        torch.cuda.synchronize()
        seq_loss_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for t in wanted:
            t.requires_grad_(False)
    by_id = {id(t): g.float() for t, g in zip(wanted, seq_grads)}
    del seq_grads
    grad_rows = []
    for r, (row, ten) in enumerate(zip(ranks, tensors)):
        pm = PL.PipelineCoords(stage=row["coords"]["stage"], S=S,
                               tp=row["coords"]["tp"], T=PIPE_MESH[2])
        lo, hi = PL._vocab_range(cfg.vocab, S * PIPE_MESH[2], pm.vp)
        for name, stage, slot, path in PIPE_GRAD_LEAVES:
            if name not in ten["grads"]:
                continue
            want = by_id[id(compared[name])]
            if name == "embed":
                sl = (slice(lo, hi),)
            elif name == "lm_head":
                sl = (slice(None), slice(lo, hi))
            elif slot is None:
                sl = ()
            else:
                unit = full["units"][pm.stage][slot]
                d = PL.unit_tp_dims(cfg, pm.T, unit)[path]
                n = None if d is None else want.shape[d] // pm.T
                sl = () if d is None else (slice(None),) * d + (
                    slice(pm.tp * n, (pm.tp + 1) * n),)
            got = ten["grads"][name].cuda()
            ref = want[sl]
            grad_rows.append({
                "rank": r, "leaf": name, "shape": list(got.shape),
                "rel_l2": float((got - ref).norm() / ref.norm()),
                "max_abs_diff_over_max": float((got - ref).abs().max()
                                               / ref.abs().max())})
    del full, by_id, compared, wanted
    torch.cuda.empty_cache()
    losses = [r["loss"]["value"] for r in ranks]
    row = {"phase": "pipeline_lm", "arch": LM_ARCH,
           "mesh": dict(zip(("data", "stage", "tp"), PIPE_MESH)),
           "backend": "gloo", "device": "cuda:0 for all four ranks",
           "microbatches": K, "prefill_tokens": [PIPE_B, PIPE_S],
           "loss_tokens": [PIPE_B, PIPE_LOSS_S],
           "handoff_transport": "pinned host buffers (gloo sends no CUDA "
                                "tensor)",
           "ranks": ranks, "spawn_and_ranks_s": spawn_s,
           "expected_flash_attention_per_rank": want_launches,
           "sequential": {"prefill_ms": seq_prefill_ms,
                          "prefill_flash_attention": seq_launches,
                          "loss": float(seq_loss), "loss_ms": seq_loss_ms},
           "logits_vs_sequential": logits_check,
           "loss_vs_sequential": [v - float(seq_loss) for v in losses],
           "grads_vs_sequential": grad_rows,
           "route_tol": LM_ROUTE_TOL, "loss_tol": PIPE_LOSS_TOL,
           "grad_rel_l2_tol": PIPE_GRAD_TOL,
           "phase_s": time.perf_counter() - t_phase,
           "card": env["nvidia_smi"]}
    emit(row)
    bad = [r for r in ranks if r["prefill"]["launches"] != {
        "gemm_int8": 0, "flash_attention": want_launches, "linear_scan": 0}
        or r["loss"]["launches"]["flash_attention"]]
    if bad:
        raise SmokeFailure(f"pipelined launches: {[r['prefill']['launches'] for r in ranks]}, "
                           f"expected {want_launches} flash_attention a "
                           f"rank in the prefill and none in the loss")
    if not (logits_check["finite"]
            and logits_check["max_abs_diff"] <= LM_ROUTE_TOL):
        raise SmokeFailure(f"pipelined logits off the sequential forward's: "
                           f"{logits_check}")
    if max(losses) - min(losses) > 0 or \
            max(abs(d) for d in row["loss_vs_sequential"]) > PIPE_LOSS_TOL:
        raise SmokeFailure(f"pipelined loss {losses} against the "
                           f"sequential {float(seq_loss)}")
    if not all(r["loss"]["grad_finite"] and r["loss"]["grad_zero_leaves"]
               == 0 for r in ranks):
        raise SmokeFailure("a pipelined gradient leaf is not finite or is "
                           "zero")
    if max(g["rel_l2"] for g in grad_rows) > PIPE_GRAD_TOL:
        raise SmokeFailure(f"pipelined gradient leaves off the sequential "
                           f"gradient: {grad_rows}")
    return {"launches_per_rank": want_launches,
            "launches": sum(r["prefill"]["launches"]["flash_attention"]
                            for r in ranks), **row}


# ---------------------------------------------------------------------------
# Phase int8_moments: AdamW's int8 moments on placed leaves
# ---------------------------------------------------------------------------

# (a): full-width RecurrentGemma-2B (depth whole) with int8 moments, the
# config field both packages have, placed on a one-rank NCCL mesh (1, 1):
# Q8_STEPS placed make_train_step calls against the unplaced steps of the
# same seed and batch, in turns, both states on the card.
Q8_ARCH, Q8_B, Q8_S, Q8_STEPS, Q8_LR = TRAIN_ARCH, 2, 1024, 3, 3e-4
# (b): DeepSeek-V2 at full width cut to Q8_LAYERS layers (one dense MLA
# layer, one MLA + MoE layer of 160 experts: every kind of leaf), its own
# int8 moments, on a (data 1, model 2) mesh of two gloo processes on
# cuda:0: Q8_UPDATES adamw_update calls with seeded gradients, then one
# apply_grads, against the unplaced port, leaf by leaf, one rank at a time
# (the unplaced update of a 1.26 B-element expert stack takes about 40 GB).
# apply_grads clips by a norm summed over the shards: it is held to the
# gloo tests' bounds (params within Q8_PARAM_TOL but for Q8_FLIP_SHARE of
# them, and those within 2 lr; codes equal but for Q8_CODE_OFF_SHARE one
# apart), the updates bit for bit.
Q8_LAYERS, Q8_UPDATES, Q8_MOE_LR = 2, 3, 1e-3
Q8_PARAM_TOL, Q8_FLIP_SHARE, Q8_CODE_OFF_SHARE = 1e-5, 1e-3, 1e-3
Q8_JOIN_S = 420
Q8_ALONE = 1 << 30     # elements of a leaf whose unplaced update runs alone


def _q8_leaves(params, opt) -> list:
    """(key, param, mu code, nu code) of every leaf, in tree order."""
    keys = [ckpt.checkpoint._key(k) for k, _ in
            ckpt.checkpoint._items(params)]
    return list(zip(keys, optim.adamw.tree_leaves(params),
                    _codes_of(opt.mu), _codes_of(opt.nu)))


def _codes_of(tree) -> list:
    if SH.is_q8(tree):
        return [tree]
    nodes = tree.values() if isinstance(tree, dict) else tree
    return [c for v in nodes for c in _codes_of(v)]


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _q8_first_difference(want: list, got: list) -> str | None:
    """The first tensor (params, then each leaf's codes) of ``got`` (a
    placed state) that differs from ``want``'s, or None."""
    for (key, p, mu, nu), (_, pp, pmu, pnu) in zip(want, got):
        for name, a, b in ((key, p, pp),
                           *((f"{key}/{m}/{f}", c[f], pc[f])
                             for m, c, pc in (("mu", mu, pmu),
                                              ("nu", nu, pnu))
                             for f in ("q", "scale"))):
            if not torch.equal(a, _local(b)):
                return name
    return None


def _q8_one_rank(env: dict) -> dict:
    """(a) Q8_STEPS placed and unplaced steps of full-width
    RecurrentGemma-2B with int8 moments, in turns: every param, code and
    scale equal after each step, 18 + 18 linear_scan launches a placed
    step, finite losses, wall ms, peak memory, and the idle share of the
    last placed step (profiled) against the warm steps' wall."""
    cfg = ARCHS[Q8_ARCH].scaled(opt_moment_dtype="int8")
    n_rec = cfg.layer_kinds().count("rglru")
    with tempfile.TemporaryDirectory(prefix="q8_a_") as root:
        _mesh_group(root, 1, 0, "nccl")
        try:
            mesh = lm_mesh.make_debug_mesh(1, 1)
            torch.cuda.reset_peak_memory_stats()
            params = T.init_params(cfg, seed=0, device="cuda")
            placed = SH.place(params, SH.param_shardings(cfg, mesh, params))
            opt = optim.adamw_init(params, "int8")
            opt_p = optim.adamw_init(placed, "int8")
            state_bytes = _tree_bytes([optim.adamw.tree_map(_local, m)
                                       for m in (opt_p.mu, opt_p.nu)])
            gen = torch.Generator(device="cuda").manual_seed(1)
            tokens = torch.randint(0, cfg.vocab, (Q8_B, Q8_S),
                                   generator=gen, device="cuda")
            batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
            pbatch = SH.place(batch, SH.batch_shardings(mesh, batch))
            step = lm_steps.make_train_step(cfg, lr=Q8_LR, remat=False)
            rows = []
            for i in range(Q8_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, batch)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                reset_launches()
                last = i == Q8_STEPS - 1
                with lm_mesh.set_mesh(mesh), (torch.profiler.profile(
                        activities=PROFILE_ACTIVITIES) if last
                        else contextlib.nullcontext()) as prof:
                    placed, opt_p, m_p = step(placed, opt_p, pbatch)
                    torch.cuda.synchronize()
                t2 = time.perf_counter()
                got = dict(linear_scan.launches_by_path,
                           flash_attention=flash_attention.launches)
                first = _q8_first_difference(_q8_leaves(params, opt),
                                             _q8_leaves(placed, opt_p))
                rows.append({
                    "step": i + 1, "loss": float(m["loss"]),
                    "loss_placed": float(_local(m_p["loss"])),
                    "grad_norm": float(m["grad_norm"]),
                    "grad_norm_placed": float(_local(m_p["grad_norm"])),
                    "unplaced_ms": (t1 - t0) * 1e3,
                    "placed_ms": (t2 - t1) * 1e3, "launches": got,
                    "first_difference": first})
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            warm = float(np.median([r["placed_ms"] for r in rows[1:-1]]))
            busy = sum(_device_us(e) for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.key.startswith("Activity Buffer")) / 1e3
            row = {"phase": "int8_moments_one_rank", "arch": Q8_ARCH,
                   "mesh": lm_mesh.mesh_shape(mesh), "backend": "nccl",
                   "tokens": [Q8_B, Q8_S], "moments": "int8",
                   "steps": rows, "placed_step_ms_median_warm": warm,
                   "warm_steps": f"2 to {Q8_STEPS - 1} (the last is "
                                 f"profiled)",
                   "unplaced_step_ms_median_warm": float(np.median(
                       [r["unplaced_ms"] for r in rows[1:]])),
                   "profiled_step_device_busy_ms": busy,
                   "device_idle_share": max(0.0, 1.0 - busy / warm),
                   "peak_memory_gb_both_states": peak_gb,
                   "int8_moment_bytes": state_bytes,
                   "float32_moment_bytes": 8 * T.param_count(cfg),
                   "placements": sorted({str(c["q"].placements)
                                         for c in _codes_of(opt_p.mu)}),
                   "card": env["nvidia_smi"]}
            emit(row)
        finally:
            dist.destroy_process_group()
    want = {"forward": n_rec, "backward": n_rec, "flash_attention": 0}
    if any(r["launches"] != want for r in rows):
        raise SmokeFailure(f"the placed int8 steps launched "
                           f"{[r['launches'] for r in rows]}, expected "
                           f"{want} a step")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["loss_placed"])
               for r in rows):
        raise SmokeFailure(f"int8-moment losses not finite: {rows}")
    if any(r["first_difference"] for r in rows):
        raise SmokeFailure(f"the placed int8 steps differ from the unplaced "
                           f"ones: {[r['first_difference'] for r in rows]}")
    return {"launches": want, "launches_total": {
        k: sum(r["launches"][k] for r in rows) for k in ("forward",
                                                         "backward")},
        "placed_step_ms": warm, "peak_memory_gb": peak_gb,
        "device_idle_share": row["device_idle_share"]}


def _q8_grad(shape, dtype, update: int, leaf: int) -> torch.Tensor:
    """The seeded gradient of leaf ``leaf`` at update ``update``, the same
    on every rank."""
    gen = torch.Generator(device="cuda").manual_seed(1000 * update + leaf)
    return (torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.bfloat16) * 1e-2).to(dtype)


def _q8_box(t) -> tuple:
    """The slices of a whole leaf that the placed ``t`` holds on this
    rank."""
    mesh = t.device_mesh
    box = optim.adamw._box(tuple(t.shape),
                           optim.adamw._shard_dims(t.placements),
                           tuple(mesh.mesh.shape),
                           tuple(mesh.get_coordinate()))
    return tuple(slice(a, b) for a, b in box)


def _q8_snapshot(leaves: list) -> list:
    """This rank's shards of every leaf (param, then each moment's q and
    scale) on the host, each with the slices of the whole leaf it holds."""
    return [[(_local(t).to("cpu", copy=True), _q8_box(t))
             for t in (p, mu["q"], mu["scale"], nu["q"], nu["scale"])]
            for _, p, mu, nu in leaves]


def _q8_compare(snap: list, ref) -> dict:
    """One leaf's shards (``_q8_snapshot``) against the unplaced port's
    whole leaf ``ref`` (p, mu, nu), on ``ref``'s device."""
    rp, rmu, rnu = ref
    whole = (rp, rmu["q"], rmu["scale"], rnu["q"], rnu["scale"])
    (p, box), *codes = snap
    p, want = p.to(rp.device), rp[box]
    d = (p.float() - want.float()).abs()
    out = {"param_equal": bool(torch.equal(p, want)),
           "param_max_err": float(d.max()),
           "param_over_tol": int((d > Q8_PARAM_TOL).sum()),
           "elements": d.numel(), "codes_equal": True, "code_off": 0,
           "code_max_diff": 0, "codes": 0}
    for (got, box), w in zip(codes, whole[1:]):
        got, w = got.to(rp.device), w[box]
        out["codes_equal"] &= bool(torch.equal(got, w))
        if got.dtype == torch.int8:
            dq = (got.int() - w.int()).abs()
            out["code_off"] += int((dq > 0).sum())
            out["code_max_diff"] = max(out["code_max_diff"], int(dq.max()))
            out["codes"] += dq.numel()
    return out


def _q8_moe_rank(rank: int, root: str) -> None:
    """(b) One rank of two (gloo, both on cuda:0) on a (1, 2) mesh: the
    placed updates, then (the placed state's shards on the host, the card
    free) the unplaced port leaf by leaf from the same seeded params, the
    expert stacks one rank at a time. Writes ``rank<r>.json`` under
    ``root``."""
    torch.cuda.set_device(0)
    _mesh_group(root, 2, rank, "gloo")
    out: dict = {"rank": rank}
    try:
        mesh = lm_mesh.make_debug_mesh(1, 2)
        cfg = ARCHS[MLA_ARCH].scaled(n_layers=Q8_LAYERS)
        t0 = time.perf_counter()
        full = T.init_params(cfg, seed=0, device="cuda")
        sh = SH.param_shardings(cfg, mesh, full)
        placed = SH.place(full, sh)
        del full
        torch.cuda.empty_cache()
        opt = optim.adamw_init(placed, "int8")
        leaves = _q8_leaves(placed, opt)
        out["build_s"] = time.perf_counter() - t0
        out["cases"] = {}
        for key, p, mu, _ in leaves:
            case = optim.adamw.layout_case(p, mu["q"])
            out["cases"].setdefault(str(case), []).append(key)
        shard_list = optim.adamw.tree_leaves(sh)
        updates, snaps, snap_s = [], [], 0.0
        for u in range(Q8_UPDATES + 1):
            # The seeded gradients, placed as the params (each rank keeps
            # its own shard of the same values).
            flat = [SH.place(_q8_grad(t.shape, t.dtype, u, i), s)
                    for i, (t, s) in enumerate(zip(
                        optim.adamw.tree_leaves(placed), shard_list))]
            it = iter(flat)
            g_tree = optim.adamw.tree_map(lambda _: next(it), placed)
            optim.adamw.reset_transfer_counts()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if u < Q8_UPDATES:
                placed, opt = optim.adamw_update(
                    placed, g_tree, opt, lr=Q8_MOE_LR, moment_dtype="int8")
            else:
                placed, opt, gn = lm_steps.apply_grads(
                    placed, g_tree, opt, lr=Q8_MOE_LR, moment_dtype="int8")
                out["grad_norm_placed"] = float(_local(gn))
            torch.cuda.synchronize()
            updates.append({"wall_ms": (time.perf_counter() - t0) * 1e3,
                            **optim.adamw.transfer_counts})
            del g_tree, flat, it
            if u >= Q8_UPDATES - 1:
                t0 = time.perf_counter()
                snaps.append(_q8_snapshot(leaves))
                snap_s += time.perf_counter() - t0
        out["updates"], out["snapshot_s"] = updates, snap_s
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        # Case 1 leaves alone through one more update: no collective, no
        # byte moved.
        ones = [(k, p, mu, nu) for k, p, mu, nu in leaves
                if optim.adamw.layout_case(p, mu["q"]) == 1]
        sub = {str(i): p for i, (_, p, _, _) in enumerate(ones)}
        sub_opt = optim.AdamWState(
            opt.step, {str(i): mu for i, (_, _, mu, _) in enumerate(ones)},
            {str(i): nu for i, (_, _, _, nu) in enumerate(ones)}, None)
        optim.adamw.reset_transfer_counts()
        with CommDebugMode() as cm:
            optim.adamw_update(sub, {k: torch.zeros_like(v)
                                     for k, v in sub.items()},
                               sub_opt, lr=Q8_MOE_LR, moment_dtype="int8")
        out["case1"] = {"leaves": [k for k, _, _, _ in ones],
                        "collectives": {str(k): v for k, v in
                                        cm.get_comm_counts().items()},
                        **optim.adamw.transfer_counts}
        n_leaves = len(leaves)
        del placed, opt, leaves, ones, sub, sub_opt
        torch.cuda.empty_cache()
        # The unplaced port, leaf by leaf, each rank against its own
        # shards: Q8_UPDATES updates (bit for bit), then the clipped
        # gradient's update as apply_grads makes it. A leaf of a billion
        # elements or more (an expert stack: the unplaced update peaks
        # near 40 GB) one rank at a time, the rest at once.
        t0 = time.perf_counter()
        # The same seeded params again, whole, on the card (now free).
        init = optim.adamw.tree_leaves(T.init_params(cfg, seed=0,
                                                     device="cuda"))
        norm = torch.sqrt(sum(
            torch.sum(torch.square(_q8_grad(
                h.shape, h.dtype, Q8_UPDATES, i).float()))
            for i, h in enumerate(init)))
        scale = torch.clamp(1.0 / torch.clamp(norm, min=1e-12), max=1.0)
        out["grad_norm"] = float(norm)
        out["update_rows"], out["apply_rows"] = [], []
        for i in range(n_leaves):
            turns = range(2) if init[i].numel() >= Q8_ALONE else [rank]
            for turn in turns:
                if len(turns) > 1:
                    dist.barrier()
                if turn != rank:
                    continue
                p = {"w": init[i].clone()}
                ref = optim.adamw_init(p, "int8")
                for u in range(Q8_UPDATES + 1):
                    g = _q8_grad(p["w"].shape, p["w"].dtype, u, i)
                    if u == Q8_UPDATES:
                        out["update_rows"].append(_q8_compare(
                            snaps[0][i], (p["w"], ref.mu["w"],
                                          ref.nu["w"])))
                        g.copy_((g.float() * scale).to(g.dtype))
                    p, ref = optim.adamw_update(p, {"w": g}, ref,
                                                lr=Q8_MOE_LR,
                                                moment_dtype="int8")
                    del g
                out["apply_rows"].append(_q8_compare(
                    snaps[1][i], (p["w"], ref.mu["w"], ref.nu["w"])))
                del p, ref
                torch.cuda.empty_cache()
            if len(turns) > 1:
                dist.barrier()
        del init
        torch.cuda.empty_cache()
        out["reference_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _q8_two_ranks(env: dict) -> dict:
    """(b) Two gloo processes on cuda:0; a failed child fails the run."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="q8_b_") as root:
        procs = [ctx.Process(target=_q8_moe_rank, args=(r, root))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=max(1.0, Q8_JOIN_S - (time.perf_counter() - t0)))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            raise SmokeFailure(f"the two int8-moment ranks exited {codes}")
        ranks = [json.loads(Path(root, f"rank{r}.json").read_text())
                 for r in range(2)]
    seconds = time.perf_counter() - t0
    upd_ok = all(row["param_equal"] and row["codes_equal"]
                 for r in ranks for row in r["update_rows"])
    apply = [row for r in ranks for row in r["apply_rows"]]
    over = sum(row["param_over_tol"] for row in apply) / sum(
        row["elements"] for row in apply)
    code_off = sum(row["code_off"] for row in apply) / sum(
        row["codes"] for row in apply)
    row = {"phase": "int8_moments_two_ranks", "arch": MLA_ARCH,
           "layers": Q8_LAYERS, "mesh": [1, 2], "backend": "gloo",
           "device": "cuda:0 for both ranks", "lr": Q8_MOE_LR,
           "cases": {c: len(v) for c, v in ranks[0]["cases"].items()},
           "case1_leaves": ranks[0]["cases"].get("1", []),
           "updates_bit_for_bit": upd_ok,
           "update_leaves": len(ranks[0]["update_rows"]),
           "updates": [r["updates"] for r in ranks],
           "apply_grads": {"grad_norm": ranks[0]["grad_norm"],
                           "grad_norm_placed": [r["grad_norm_placed"]
                                                for r in ranks],
                           "param_max_err": max(r["param_max_err"]
                                                for r in apply),
                           "param_over_tol_share": over,
                           "code_off_share": code_off,
                           "code_max_diff": max(r["code_max_diff"]
                                                for r in apply)},
           "case1_update": [r["case1"] for r in ranks],
           "build_s": [r["build_s"] for r in ranks],
           "snapshot_s": [r["snapshot_s"] for r in ranks],
           "reference_s": [r["reference_s"] for r in ranks],
           "peak_memory_gb": [r["peak_memory_gb"] for r in ranks],
           "seconds": seconds, "card": env["nvidia_smi"]}
    emit(row)
    if not upd_ok:
        bad = [(r["rank"], i) for r in ranks for i, x in
               enumerate(r["update_rows"])
               if not (x["param_equal"] and x["codes_equal"])]
        raise SmokeFailure(f"placed adamw_update differs from the unplaced "
                           f"one at (rank, leaf) {bad[:10]}")
    a = row["apply_grads"]
    if a["param_max_err"] > 2 * Q8_MOE_LR or over > Q8_FLIP_SHARE or \
            code_off > Q8_CODE_OFF_SHARE or a["code_max_diff"] > 1:
        raise SmokeFailure(f"placed apply_grads off the unplaced one: {a}")
    if not ranks[0]["cases"].get("1") or any(
            r["case1"]["calls"] or r["case1"]["collectives"]
            for r in ranks):
        raise SmokeFailure(f"case 1 leaves moved data: "
                           f"{row['case1_update']}")
    return row


def phase_int8_moments(env: dict) -> dict:
    """(a) and (b)."""
    t_phase = time.perf_counter()
    one = _q8_one_rank(env)
    torch.cuda.empty_cache()
    two = _q8_two_ranks(env)
    row = {"phase": "int8_moments", "one_rank": one,
           "two_ranks": {k: two[k] for k in ("updates_bit_for_bit",
                                             "apply_grads", "seconds")},
           "phase_s": time.perf_counter() - t_phase,
           "card": env["nvidia_smi"]}
    emit(row)
    return one


def _meta_bytes(tree) -> int:
    """Bytes of a tree's tensors from their shapes and dtypes (the meta
    device has no storage to ask)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_meta_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


# The reference's statuses under --dist pipeline (tests/test_torch_dryrun.py
# holds the port's to them): a decode shape raises; DeepSeek-V2/V3's train
# plans fit no HBM (plan_pipeline raises); the VLM's prefill batch holds no
# tokens, which the reference's prefill reads; RecurrentGemma-2B's
# unsupported kind comes back "ok" (ROADMAP C9).
PIPE_DRYRUN_ERRORS = {("deepseek-v3-671b", "train_4k"),
                      ("deepseek-v2-236b", "train_4k"),
                      ("qwen2-vl-2b", "prefill_32k")}


def _dryrun_sweeps() -> dict:
    """``launch/dryrun.py --all --mesh pod --dist <dist>`` for each dist of
    DRYRUN_JOBS, at once, in spawned processes that see no card: {dist:
    (exit code, its stdout and stderr, cells by tag, s)}."""
    with tempfile.TemporaryDirectory(prefix="dryrun_") as root:
        # The sweeps run on the meta device: no process of them sees the
        # card.
        penv = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                    CUDA_VISIBLE_DEVICES="")
        t0 = time.perf_counter()
        procs = {dist_: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--mesh", "pod", "--dist", dist_, "--jobs", str(jobs),
             "--out", os.path.join(root, dist_)], cwd=ROOT, env=penv,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for dist_, jobs in DRYRUN_JOBS.items()}
        out = {}
        while len(out) < len(procs):
            for dist_, proc in procs.items():
                if dist_ not in out and proc.poll() is not None:
                    out[dist_] = [proc.returncode,
                                  *proc.communicate(),
                                  time.perf_counter() - t0]
            if time.perf_counter() - t0 > 900:
                for proc in procs.values():
                    proc.kill()
                raise SmokeFailure(f"the dry-run sweeps took over 900 s: "
                                   f"{sorted(out)} finished")
            time.sleep(0.5)
        result = {}
        for dist_, (code, stdout, stderr, sweep_s) in out.items():
            cells = {p.stem: json.loads(p.read_text()) for p in sorted(
                Path(root, dist_).glob("*.json"))}
            emit({"phase": f"dryrun_cells_{dist_}", "sweep_s": sweep_s,
                  "jobs": DRYRUN_JOBS[dist_], "exit_code": code,
                  "columns": ["cell", "status", "compile_s",
                              "argument_bytes_per_device",
                              "output_bytes_per_device", "flops",
                              "flops_over_n_devices",
                              "collectives_count_per_kind",
                              "collectives_total_bytes", "plan"],
                  "cells": [[tag, c["status"], c.get("compile_s"),
                             c.get("memory", {}).get("argument_size_in_bytes"),
                             c.get("memory", {}).get("output_size_in_bytes"),
                             c.get("cost", {}).get("flops"),
                             c.get("cost", {}).get("flops_over_n_devices"),
                             (c.get("collectives") or {}).get(
                                 "count_per_kind"),
                             (c.get("collectives") or {}).get("total_bytes"),
                             c.get("plan")]
                            for tag, c in cells.items()]})
            result[dist_] = (code, stdout, stderr, cells, sweep_s)
    return result


def _pipeline_status(arch: str, cfg, shape: str) -> str:
    if not cell_is_runnable(cfg, shape)[0]:
        return "skipped"
    if SHAPES[shape].mode == "decode" or (arch, shape) in PIPE_DRYRUN_ERRORS:
        return "error"
    return "ok"


def phase_dryrun(env: dict, train: dict, int8: dict) -> dict:
    t_phase = time.perf_counter()
    sweeps = _dryrun_sweeps()
    code, stdout, stderr, cells, sweep_s = sweeps["pjit"]
    if code != 0:
        raise SmokeFailure(f"the dry run exited {code}: "
                           f"{stdout[-2000:]} {stderr[-2000:]}")
    want = {f"{arch}_{shape}_pod_pjit":
            "ok" if cell_is_runnable(cfg, shape)[0] else "skipped"
            for arch, cfg in ARCHS.items() for shape in SHAPES}
    got = {tag: c["status"] for tag, c in cells.items()}
    if got != want:
        raise SmokeFailure(f"the dry run's cells {got}, expected {want}")
    counted = [tag for tag, c in cells.items() if c["status"] == "ok"
               and sum(c["collectives"]["count_per_kind"].values()) > 0]
    if len(counted) != sum(s == "ok" for s in got.values()):
        raise SmokeFailure(f"cells without collectives: "
                           f"{sorted(set(got) - set(counted))}")
    # --dist pipeline: the reference's statuses (its errors make the sweep
    # exit 1, as the reference's does), every traced cell with its plan and
    # the stage hand-off counted.
    pcode, _, pstderr, pcells, pipe_sweep_s = sweeps["pipeline"]
    pwant = {f"{arch}_{shape}_pod_pipeline": _pipeline_status(arch, cfg,
                                                              shape)
             for arch, cfg in ARCHS.items() for shape in SHAPES}
    pgot = {tag: c["status"] for tag, c in pcells.items()}
    if pgot != pwant or pcode != 1:
        raise SmokeFailure(f"the pipeline dry run exited {pcode} with cells "
                           f"{pgot}, expected 1 and {pwant}: "
                           f"{pstderr[-2000:]}")
    # Every "ok" cell but RecurrentGemma-2B's two (C9's) was traced.
    traced = [c for c in pcells.values() if "plan" in c]
    untraced_ok = sum(c["status"] == "ok" and c.get("reason") == "unit kind"
                      for c in pcells.values())
    if len(traced) != sum(s == "ok" for s in pgot.values()) - untraced_ok \
            or untraced_ok != 2 or any(
            c["collectives"]["count_per_kind"].get("collective-permute", 0)
            < 1 for c in traced):
        raise SmokeFailure("a traced pipeline cell has no plan or no "
                           "hand-off counted")

    # The dry run against the card: the training state phase train held,
    # the int8 params phase int8 held, and the FLOPs of the training step.
    rg = _train_cfg()
    state_meta = _meta_bytes(lm_steps.abstract_state(rg))
    yi_meta = T.init_params(ARCHS[LM_ARCH], device="meta")
    param_meta = {"bf16": _meta_bytes(yi_meta),
                  "int8": _meta_bytes(L.quantize_params_int8(yi_meta))}
    case = ShapeCase(f"train_{TRAIN_B}x{TRAIN_S}", TRAIN_S, TRAIN_B, "train")
    t0 = time.perf_counter()
    traced = lm_dryrun.trace_cell(rg, case, production_mesh_shape())
    trace_s = time.perf_counter() - t0
    flops = traced["cost"]["flops"]
    model_flops = train["full"]["model_flops"]
    n_attn = rg.layer_kinds().count("attn_local")
    # Attention as the meta trace counts it: the plain core's every
    # (query, key) pair (S <= window: no ring), QK^T and PV, x3 for
    # forward and backward; the phase's count takes the causal half.
    attn_dense = 3 * 2 * 2 * TRAIN_B * TRAIN_S * TRAIN_S * rg.n_heads \
        * rg.head_dim * n_attn
    attn_model = model_flops - 6 * train["full"]["params"] * TRAIN_B \
        * TRAIN_S
    row = {"phase": "dryrun", "cells": len(cells),
           "ok": sum(s == "ok" for s in got.values()),
           "skipped": sum(s == "skipped" for s in got.values()),
           "sweep_s": sweep_s,
           "pipeline": {status: sum(s == status for s in pgot.values())
                        for status in ("ok", "error", "skipped")},
           "pipeline_sweep_s": pipe_sweep_s,
           "rg_state_bytes": {"abstract_state": state_meta,
                              "card": train["full"]["state_bytes"]},
           "yi6b_param_bytes": {"dry_run": param_meta,
                                "card": int8["param_bytes"]},
           "rg_train_step_flops": {
               "case": case.name, "dry_run": flops,
               "model_flops": model_flops,
               "ratio": flops / model_flops,
               "attention_dry_run": attn_dense,
               "attention_model_flops": attn_model,
               "rest_dry_run": flops - attn_dense,
               "rest_model_flops_6NT": model_flops - attn_model,
               "trace_s": trace_s},
           "phase_s": time.perf_counter() - t_phase}
    emit(row)
    if state_meta != train["full"]["state_bytes"] or \
            param_meta != int8["param_bytes"]:
        raise SmokeFailure(f"the dry run's bytes differ from the card's: "
                           f"{row}")
    return row


def main() -> int:
    t_start = time.perf_counter()
    RUN_LOG.unlink(missing_ok=True)
    try:
        env = phase_environment()
        gemm = phase_gemm(env)
        phase_autotune(env, gemm)
        main_path = phase_main_path()
        vgg = phase_vgg16()
        resnet = phase_resnet50(gemm)
        torch.cuda.empty_cache()
        pipeline = phase_pipeline()
        torch.cuda.empty_cache()
        phase_bits16()
        torch.cuda.empty_cache()
        elastic = phase_chaos_elastic()
        lenet = phase_import()
        torch.cuda.empty_cache()
        flash = phase_flash(env)
        lm = phase_lm_forward(env)
        phase_lm_serve(lm)
        yi_launches = lm["launches"]
        del lm
        torch.cuda.empty_cache()
        scan = phase_scan(env)
        flash_rg = phase_flash_rg(env)
        rg = phase_rg_forward(env)
        phase_rg_serve(rg)
        rg_launches = rg["launches"]
        del rg
        torch.cuda.empty_cache()
        family = {}
        for name, phase in LM_FAMILY_PHASES.items():
            t0 = time.perf_counter()
            family[name] = phase(env)
            emit({"phase": f"{name}_done",
                  "phase_s": time.perf_counter() - t0})
            torch.cuda.empty_cache()
        train = phase_train(env)
        torch.cuda.empty_cache()
        int8 = phase_int8(env)
        torch.cuda.empty_cache()
        mesh = phase_mesh(env)
        torch.cuda.empty_cache()
        pipe = phase_pipeline_lm(env)
        torch.cuda.empty_cache()
        q8 = phase_int8_moments(env)
        torch.cuda.empty_cache()
        phase_dryrun(env, train, int8)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    rg_cfg = ARCHS[RG_ARCH]
    # Each gemm_int8 entry's "launches" is its own path's run (counts set
    # to 0 just before it). The pipeline phase's launches (counts set to
    # 0 before each config, summed over its stage threads) stand beside
    # them under "launches_on", keyed by their own path.
    pipe_configs = ", ".join(f"K{k}R{r}" for k, r in PIPE_CONFIGS)
    launches_on = {
        "alexnet": {"alexnet": main_path["launches"],
                    "alexnet-pipeline": pipeline["launches"],
                    "alexnet-elastic": elastic["launches"],
                    "lenet": lenet["launches"]},
        "vgg16": {"vgg16": vgg["launches"],
                  "vgg16-pipeline": pipeline["vgg16_launches"]},
        "resnet50": {"resnet50": resnet["launches"]}}
    launches_per = {
        "alexnet": {
            "alexnet-pipeline": f"serve_async at {pipe_configs}: "
                                f"{pipeline['batches']} batches of "
                                f"{SERVE_BATCH} (calibration and open "
                                f"loop), 11 launches each",
            "alexnet-elastic": f"two K2 replicas, one killed, then "
                               f"serve_knee_rescale R1 -> R2: "
                               f"{elastic['batches']} batches of "
                               f"{SERVE_BATCH}, 8 large_n + 3 small_n "
                               f"each",
            "lenet": f"examples/lenet.json through import_model "
                     f"(calibration and serve): {lenet['batches']} "
                     f"batches of 4, 2 large_n + 1 small_n + 2 dp4a "
                     f"each"},
        "vgg16": {
            "vgg16-pipeline": f"PipelineExecutor at K "
                              f"{', '.join(map(str, VGG_PIPE_STAGES))}: "
                              f"{VGG_PIPE_BATCHES} batches of "
                              f"{SERVE_BATCH} each, 16 launches a batch"},
        "resnet50": {}}
    by_path_on = {"alexnet": {"alexnet-elastic": elastic["by_path"],
                              "lenet": lenet["by_path"]}, "vgg16": {},
                  "resnet50": {}}
    kernels = [{
        "name": "gemm_int8", "route": "cuda", "source": GEMM_SOURCE,
        "replaces": GEMM_REPLACES,
        "launches": launches_on[model][model],
        "launches_on": launches_on[model],
        "launches_on_per": launches_per[model],
        "launches_on_by_path": by_path_on[model],
        **{k: gemm[model][k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
        **({"skip_launches": gemm[model]["residual"]}
           if "residual" in gemm[model] else {}),
        "path": model,
        "per": f"one {model} batch of {SERVE_BATCH}: the sum over its "
               f"{gemm[model]['launches']} launches"}
        for model in GEMM_MODELS] + [{
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": yi_launches,
        "max_abs_err": flash["max_abs_err"], "ms": flash["ms"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
        "launches_on": {"yi-6b-int8": int8["launches"],
                        "yi-6b-mesh": mesh["launches"],
                        "yi-6b-pipeline": pipe["launches"]},
        "launches_on_per": {"yi-6b-int8": f"the int8 weight-only forward "
                                          f"on {LM_B} x {LM_S} tokens, one "
                                          f"per layer",
                            "yi-6b-mesh": f"the forward placed on a one-rank "
                                          f"(1, 1) mesh on {LM_B} x {LM_S} "
                                          f"tokens (DTensor), one per "
                                          f"layer",
                            "yi-6b-pipeline": f"the pipelined prefill on "
                                              f"{PIPE_B} x {PIPE_S} tokens "
                                              f"over (data, stage, tp) = "
                                              f"{PIPE_MESH}, K {PIPE_K}, "
                                              f"summed over the "
                                              f"{PIPE_WORLD} ranks: "
                                              f"{pipe['launches_per_rank']} "
                                              f"a rank ((K + S - 1) x 16 "
                                              f"layers, at the tp shard's "
                                              f"16 q and 2 KV heads, B 1)"},
        "path": LM_ARCH,
        "per": f"one launch at the Yi-6B shape (B {LM_B}, S {LM_S}, H 32, "
               f"KV 4, d 128, bf16, causal); one per layer of a forward"}, {
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": rg_launches["flash_attention"],
        "max_abs_err": flash_rg["max_abs_err"], "ms": flash_rg["ms"],
        "plain_ms": flash_rg["plain_ms"], "bound_ms": flash_rg["bound_ms"],
        "bound_by": flash_rg["bound_by"],
        "library_ms": flash_rg["library_ms"],
        "path": RG_ARCH,
        "per": f"one launch at the RecurrentGemma-2B shape (B {RG_B}, "
               f"S {RG_S}, H 10, KV 1, d 256, bf16, causal, window "
               f"{rg_cfg.window}); one per attn_local layer of a forward"}, {
        "name": "linear_scan", "route": "cuda", "source": SCAN_SOURCE,
        "replaces": SCAN_REPLACES, "launches": rg_launches["linear_scan"],
        "max_abs_err": scan["max_abs_err"], "ms": scan["ms"],
        "plain_ms": scan["plain_ms"], "bound_ms": scan["bound_ms"],
        "bound_by": scan["bound_by"], "library_ms": scan["library_ms"],
        "library_note": "null: no single PyTorch call computes the "
                        "recurrence",
        "path": RG_ARCH,
        "per": f"one launch at the RecurrentGemma-2B forward's shape "
               f"(B {RG_B}, S {RG_S}, D {rg_cfg.lru_width}, fp32); one per "
               f"RG-LRU layer of a forward or a prefill"}] + [{
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": family[name]["launches"]["flash_attention"],
        **{k: family[name]["flash"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "launches_on": {f"{arch}-serve": family[name]["serve"]["launches"][
            "flash_attention"]},
        "path": arch, "per": per}
        for name, arch, per in (
            ("vlm", VLM_ARCH,
             f"one launch at the Qwen2-VL-2B shape (B {VLM_B}, S {VLM_S}, "
             f"H 12, KV 2, d 128, bf16, causal); one per layer of a forward "
             f"(M-RoPE positions)"),
            ("encdec", ED_ARCH,
             f"one launch at the SeamlessM4T-medium encoder and "
             f"cross-attention shape (B {ED_B}, S {ED_S}, H 16, KV 16, d 64, "
             f"bf16, non-causal); a forward launches one per encoder layer, "
             f"decoder layer and cross-attention, a prefill one per encoder "
             f"layer and cross-attention"))] + [{
        "name": "linear_scan", "route": "cuda", "source": SCAN_SOURCE,
        "replaces": SCAN_REPLACES, "direction": d,
        "launches": train["full"]["launches"]["linear_scan_by_path"][d],
        "max_abs_err": train["max_abs_err"],
        "ms": train["times"][ms], "plain_ms": train["times"][f"plain_{d}_ms"],
        "bound_ms": train["times"][f"{d}_bound_ms"],
        "bound_by": train["times"][f"{d}_bound_by"], "library_ms": None,
        "library_note": "null: no single PyTorch call computes the "
                        "recurrence or its gradient",
        "launches_on": {f"{TRAIN_ARCH}-int8-moments":
                        q8["launches_total"][d]},
        "launches_on_per": {f"{TRAIN_ARCH}-int8-moments":
                            f"{Q8_STEPS} training steps placed on a "
                            f"one-rank (1, 1) mesh with int8 AdamW "
                            f"moments, {q8['launches'][d]} a step"},
        "path": f"{TRAIN_ARCH}-train",
        "per": f"one launch at the training shape (B {TRAIN_B}, S "
               f"{TRAIN_S}, D {rg_cfg.lru_width}, fp32); {per}"}
        for d, ms, per in (
            ("forward", "forward_ms",
             f"one per RG-LRU layer of a training step's forward "
             f"({TRAIN_STEPS - 1} steps of launch/train.py)"),
            ("backward", "backward_ms",
             "one per RG-LRU layer of a training step's backward (the "
             "same kernel over reversed time); ms is the whole backward "
             "(the flips, the launch, da = g * h_prev), as its bound and "
             "plain_ms (autograd through the plain version) are"))]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(env["nvidia_smi"], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
