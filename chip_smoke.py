#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of the gradient pipeline on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA GPU

Phases (any failure exits non-zero; nothing is caught):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernel library from ``src/repro_torch/kernels/csrc``;
     print each kernel's registers and spills (ptxas), the bf16 attention
     kernels' shared memory, the tensor-core (HGMMA, HMMA), TMA and FFMA
     instructions in the attention kernels' SASS (the backward's also its
     local loads and stores, LDL / STL) and the async copies
     (LDGSTS, UBLKCP, UTMALDG) and local loads (LDL) in the region
     kernels' SASS (cuobjdump), the row-cluster kernel's multicast bulk
     copies among them;
  3. every kernel against its plain PyTorch version on the card, at the
     main path's shapes: fused_chain (every op, broadcast operands, 16
     extras, a ragged [13,255] and views off 16-byte alignment, <= 1e-5
     scaled; the wrapper's checks on CUDA operands; device and host time of
     the path's chains with 1, 5 and 0 extras at [8,256] beside an empty
     kernel on its grid, the floor under a launch; the host time of the
     5 extras' strides, their own against ``expand``'s),
     stream_matmul / siren_layer (<= 1e-4 scaled), region on every fused
     region the port plans for the full-width SIREN at orders 1-3 plus a
     column-tiled one, at R = 8 and R = 512 rows (<= 1e-4 scaled); ms per
     launch of each, the cluster width C each region launch took, and C
     with the card's max active clusters per launch shape;
  4. the main path: ``compile_gradient`` -> ``apply_batched`` on the
     full-width SIREN (random weights from a seeded generator) at orders
     1-3, fused on a 256 x 256 grid and unfused on a 64 x 64 grid, every
     output held to a float64 torch.autograd oracle (<= 1e-4 of
     max|oracle|), one 512-row chunk launching each unit of the plan once;
     then, uncounted, two chunks, all 4,096 rows and every unit alone held
     torch.equal to the per-block walk (``apply_block`` on every 8-row
     block), µs per row and busy share of both on 4,096 rows, and one
     reading of the fused path with the 65,536-row grid as one chunk;
  5. multi-INR serving at full width with K = 8 SIRENs (lane 0 is phase
     4's weights): region_call_stacked on the real regions of orders 1-2
     against its plain version (<= 1e-4 scaled) and, with torch.equal,
     against K single-lane region launches and each lane's first tile
     against an 8-row launch (another design), with the launch's row-
     cluster design and the weight bytes it reads from L2; a ragged
     stacked launch (R = 8,189 per lane) against its plain version and,
     lane by lane, region_call; one region_call of 65,536 rows against its
     plain version; MultiINRArtifact's
     stacked path (orders 1-2, broadcast and per-lane coordinates, N =
     8,192 rows per lane and a ragged N) and per-lane path (order 3, N =
     1,024, one chunk launching each unit once per lane), every lane held
     to its float64 oracle; the ServingEngine
     (order 2: grouping, a zero-row request, a K = 1 non-base weight id,
     stats) and a fresh engine restored from an ArtifactStore by
     signature alone (no tracer call, outputs torch.equal); then,
     uncounted, the per-lane lanes torch.equal to its per-block walk,
     both timed;
  6. streamed fitting at full width (phase 4's weights): region_bwd on the
     real regions of orders 1-2 and a column-tiled one, at the fit path's
     R = 8 and at R = 1,000 (many CTAs, a ragged tile, the partial
     reduction), against its plain version (<= 1e-4 scaled); compile_fit
     -> value_and_grad at order 1 (GradMSE) and 2 (LaplacianMSE) on N =
     4,096 rows against a float64 whole-grid torch.autograd oracle (loss
     and every leaf gradient <= 1e-4 scaled), one chunk launching one
     region and one region_bwd a region unit; fit at order 2 (3 steps of
     1,024-row chunks) -> ArtifactStore -> a fresh ServingEngine, within
     1e-4 of compile_gradient of the fitted weights; fit_many with K = 2
     lanes, each torch.equal to fit; then, uncounted, µs per fitted row and
     busy share beside the per-block fit (chunk_blocks = 1);
  7. LM serving: flash_attention against its plain version and a float64
     evaluation (sliced over heads) at the qwen3-8b prefill shape (bf16,
     causal), a gemma3-4b local layer (bf16, window 1,024, ragged length),
     musicgen-medium (bf16, D = 64), phi3 (bf16, D = 96) and the reduced
     configs' D = 16 (bf16, window 8), so that every head dim of the bf16
     tensor-core kernel runs, then q shorter than k
     (fp32) and a phi3-like MHA (fp32, D = 96) on the split-TF32 kernel:
     fp32 within 1e-5 of max|oracle|, bf16 at most twice the plain
     version's error; the host time of encoding the bf16 kernel's TMA
     tensor maps; the fp32 kernel (HMMA and LDGSTS in its SASS) at every
     head dim (``FP32_FWD_CASES``) within 1e-5 of max|oracle| and at most
     ``SPLIT_OVER_SIMT`` times the SIMT kernel's error on the same inputs
     (``SIMT_FP32_ERRS``), then timed at the prefill shape beside SDPA's
     fp32 forward and its split-TF32 bound (495 TFLOP/s for three
     products);
     ssd_scan against its plain version (<= 1e-6 scaled) at the mamba2-2.7b
     and jamba-v0.1-52b prefill shapes and a ragged one, with device ms and
     bound at each, then through ``kernels/ops.py``; qwen3-8b at
     full width: 4 layers in fp32, the kernel prefill against the "flash"
     prefill (last logits and caches <= 1e-4 scaled) and one decode step
     against the kernel forward's argmax; then all 36 layers served in
     bf16 (B = 2, S = 4,096): prefill through the kernel (36 launches per
     prefill), 16 greedy decode steps (no launch), the "flash" prefill's
     logits beside the kernel's;
  7e. the SSM, MoE and hybrid families: one mamba layer's ssd_chunked at
     mamba2-2.7b's widths (B = 1, S = 1,024, fp32) against a float64
     step-by-step recurrence (<= 1e-4 scaled, one ssd_scan launch);
     mamba2-2.7b (4 layers) and deepseek-moe-16b (2 layers) at full width
     in fp32 (B = 1, S = 512): the prefill on the card against the same
     weights and tokens through the same entry points on the CPU (last
     logits and every cache leaf <= 1e-4 scaled), one decode step against
     the forward's argmax where it leads by 1e-3 (the MoE model with a
     capacity that drops nothing, since its capacity follows the token
     count); then, counted, mamba2-2.7b (64 layers), deepseek-moe-16b (28)
     and one period of jamba-v0.1-52b (8 of 32 layers) served in bf16 (B =
     2, S = 4,096; weights drawn in bf16, one model at a time): prefill ms,
     tokens/s, 16 greedy decode steps, busy share, device time by kernel
     class, GB of weights, launches per prefill (ssd_scan 64 / 0 / 7,
     flash_attention 0 / 28 / 1; none in decode), the "flash" prefill's
     logits beside the kernel's for the two with attention; the VLM
     llama-3.2-vision-90b: one period (5 layers) in fp32 (B = 1, S = 512,
     1,600 image embeddings, the cross gates opened to 0.5), the kernel
     prefill against the "flash" prefill (last logits and every cache leaf
     <= 1e-4 scaled) and a decode step against the forward's argmax, then
     4 of its 20 periods served in bf16 like the others (B = 2, S = 4,096,
     1,600 seeded image embeddings; flash_attention 16 per prefill, 0 in
     decode; the cross layers run the blockwise plain attention);
  8. the paper's compiler half on phase 4's SIREN: ``compile_gradient(...,
     config="auto")`` at orders 1-2 with the measure hook (each candidate's
     real ``apply_batched`` timed on the card; the analytic winner, every
     timed candidate, the chosen config, both searches' seconds and
     ``describe()``); the auto artifact on the 256 x 256 grid against the
     float64 oracle, one chunk launching its plan's units, µs per row and
     busy share beside the default artifact; blocks 16, 32 and 64 at
     orders 1-2 against the float64 oracle; ``dataflow_summary`` at orders
     1-3, fused and unfused (paper Table IV: sums of FIFO depths and
     latencies before and after, model outputs) with the byte accounting
     beside ``torch.cuda.max_memory_allocated`` of one 4,096-row call; an
     auto request persisted and restored from an ArtifactStore with no
     trace and no search;
  9. filter banks and INR editing (the paper's benchmark) on phase 4's
     SIREN at order 2: ``compile_bank`` with four INSP heads of the paper's
     width (64 x 3 layers, seeded generator) and its BankReport (1
     dispatch against 4); the merged region against its plain version at
     R = 8 and 512 (<= 1e-4 scaled) with its cluster width C, shared
     memory per CTA and device ms per launch; the 256 x 256 grid against a float64 evaluation of
     each head over phase 4's float64 features (<= 1e-4 of max|oracle|),
     every output torch.equal to its head's single-head bank, one 512-row
     chunk launching each unit once; µs per row and busy share of the
     bank beside the four single-head banks; the five-filter library bank
     on the grid against float64; ``ServingEngine.register_bank`` with
     bank and plain requests mixed (one bank group), and a fresh engine
     restoring the bank from an ArtifactStore by signature (no tracer
     call, outputs torch.equal);
  10. the async serving engine, drift telemetry and codegen on phase 4's
     SIREN, phase 5's K = 8 fleet and phase 9's INSP bank: a mixed stream
     of 80 requests (1-3,000 rows, 120,697 in all, seeded numpy; the
     fleet at order 2, the SIREN at orders 1 and 3, the four filters)
     through ``AsyncServingEngine.serve_async`` with
     ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), every
     output torch.equal to sync ``serve`` and within 1e-4 of float64; µs
     per row and busy share of both; half the stream submitted before the
     drain (chunks dispatched early), torch.equal again; max_inflight,
     host_unpad_s and the queue-wait and request-latency percentiles; the
     stream's wall with the tracer on and off, min of 30 interleaved
     pairs (each pair's order alternated), within 5% + 5 ms;
     ``drift_report`` at orders 1-2 fused and order 1 unfused, with the
     analytic row costs and with ``results/torch_op_row_cost.json``
     (per-unit device ms and drift, min FIFO headroom >= 0); codegen's
     exec-loaded module at orders 1-2 within 1e-5 of the executor; the
     row-cost calibration at rows=4096;
  11. LM training: the attention backward (bf16:
     ``csrc/flash_attention_bwd_tc.cu``, wgmma; fp32:
     ``csrc/flash_attention_bwd.cu``, split TF32) against its plain
     version (the port of flash_cvjp._bwd_impl) and a float64 dense
     torch.autograd oracle at qwen3-8b's training shape (q [1, 4,096, 32,
     128], bf16; fp32 at 1,024), a gemma3-4b local layer (D = 256,
     window, bf16 and fp32), musicgen-medium (D = 64, bf16), phi3 (D =
     96, bf16 and fp32) and the reduced configs' D = 16 (bf16 and fp32,
     window 8), so that every head
     dim runs on both routes (fp32 within 1e-4 of max|oracle|, bf16 at most
     1.5x the plain version's error; each call one launch counted; bf16:
     two runs torch.equal, the tensor-core kernels' SASS with HGMMA and
     UTMALDG), the forward kernels' log-sum-exp against the plain one, the
     backward's device ms by kernel (preprocess, pass 1, pass 2) beside
     SDPA's autograd backward; the fp32 route (HMMA and LDGSTS in both
     passes' SASS) at every head dim (``FP32_BWD_CASES``, on the float64
     forward's output and log-sum-exp) within 1e-4 of max|oracle| and at
     most ``SPLIT_OVER_SIMT`` times the SIMT kernels' error per gradient,
     then timed beside SDPA's fp32 autograd backward; the ssd_scan backward at
     mamba2-2.7b's
     training shape [80, 32, 64, 128] and a ragged one (dstates
     torch.equal to plain, <= 1e-5 of float64); then, counted, 5 AdamW
     steps through ``launch/train.py::train_loop`` at full width (qwen3-8b
     cut to 4 layers, mamba2-2.7b to 8; B = 1, S = 4,096, remat "dots",
     cast_once, the zipf pipeline): ms, tokens/s, loss and grad norm per
     step (finite), peak memory, launches per step (at least one forward
     and one backward launch per attention or mamba layer); then fp32
     gradients, every leaf within 1e-4 scaled: qwen3-8b (1 layer, S =
     1,024) kernel path against the blockwise "flash" autodiff on the
     card, mamba2-2.7b (2 layers, S = 512) card against the CPU;
  12. sharding on a 1 x 1 mesh (the card is one rank): a one-rank NCCL
     group on a file store and ``make_mesh((1, 1), ("data", "model"))``;
     phase 5's K = 8 fleet at order 2 through ``MultiINRArtifact(...,
     sharding=policy)`` (``k_sharded``, the stacked kernel, outputs
     torch.equal to the unsharded stack), N = 65,536 rows at orders 1-3
     through ``ServingEngine(sharding=policy, shard_chunking=True)`` and
     ``AsyncServingEngine(sharding=policy)`` (torch.equal to the unsharded
     engine), and one ``build_train_step(cfg, hp, policy)`` step of
     qwen3-8b cut to 4 layers at phase 11's shape with the state placed at
     ``state_specs`` (flash_attention and its backward launched; loss
     within rtol 1e-5 and grad norm within rtol 1e-4 of the unsharded
     step), and phase 7's served model cut to 4 layers: a sharded prefill
     into a cache at ``cache_specs`` and 4 greedy decode steps, logits,
     tokens and cache torch.equal to the unsharded steps; the group is
     then destroyed;
  13. the dry run (``launch/dryrun.py``) on fake tensors, which launches
     nothing and allocates nothing on the card: phase 11's qwen3-8b step
     traced unsharded and on a 1 x 1 mesh of a one-rank fake process group
     (predicted peak within 15% of phase 11's ``max_memory_allocated``,
     predicted kernel calls equal to its launches per step, FLOPs beside
     the closed form), then the CLI, one subprocess a cell, all at once,
     on qwen3-8b x train_4k, the reference's test cell deepseek-moe-16b x
     decode_32k (remat full) and deepseek-moe-16b x train_4k over 256
     fake ranks: per-rank arguments, temporaries, peak, FLOPs and
     collective bytes by kind beside the parent commit's (before the
     "model" axis split the head, the cross entropy and the experts; for
     the decode cell its parent commit's, whose decode gathered every
     layer's parameter blocks), the fit in 80 GB, the dominant roofline
     term, and the collectives that carry a parameter block; it fails
     unless qwen3's training peak is at most 100 GB, the decode cell fits
     80 GB with arguments within 1.05x the reference's, all-gathers at
     most the reference's bytes, moves at most the reference's
     collective bytes in all, peaks no higher than its parent and moves
     no parameter block (weight-stationary), and deepseek's training
     cell fits 80 GB; qwen3-8b x train_4k
     with ``--seq-parallel`` (the sequence split over "model" between
     the blocks) must come within 2% of the same run's FLOPs without the
     flag at no higher a peak, and gemma3-4b x train_4k (8 heads, which
     16 does not divide: attention whole, MLPs split) below its parent's
     peak and FLOPs (the MLPs whole on every "model" rank);
  14. the launches of every kernel on each path, counted from 0 just before
     the path and read just after it: phase 4 must launch region,
     fused_chain, stream_matmul and siren_layer, phase 5 region_stacked
     (stacked path) and region and fused_chain (per-lane path), phase 6
     region and region_bwd, phase 7 flash_attention (LM serving) and
     ssd_scan (the kernel library's entry point), phase 7e ssd_scan and
     flash_attention (``lm_families``), phase 8 region, phase 9
     region and fused_chain (the bank path), phase 10 region,
     region_stacked and fused_chain (``async_serve``: the counted
     ``serve_async``) and region, fused_chain, stream_matmul and
     siren_layer (``drift``), phase 11 flash_attention,
     flash_attention_bwd, ssd_scan and ssd_scan_bwd (``train``), phase 12
     region_stacked, region, flash_attention and flash_attention_bwd
     (``sharded``), phase 13 none (``dryrun``); one JSON line of
     per-kernel numbers (a kernel's fp32 route, where it has one, under
     ``routes``);
  15. the last line: {"ok": true, "device": {...}}.

Times: ``ms`` is the device time of one call (torch.profiler, the sum of
the kernel records per call; for a plain version, every kernel it
launches), ``call_ms`` the time per call of back-to-back calls on the
stream (CUDA events; includes the host's launch path, so a plain version
of many small launches reads host time).  ``bound_ms`` is the larger
of bytes / 3.35 TB/s and flops / the card's peak rate for the inputs'
type, each input and output counted once: 67 TFLOP/s for fp32 (H100 SXM
without tensor cores) and 989 TFLOP/s for bf16 (dense tensor cores),
whichever units a kernel actually uses.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
SEED = 0
# on/off pairs of the phase-10 telemetry overhead check: the min of 30
# rounds a setting, with no overhead in the rounds' medians, still crossed
# the bound on a noisy host (one run in tens); 90 keep each min near its floor
TELEMETRY_PAIRS = 90
# phase 7: attention checks (label, (B, Sq, H, KH, D), Sk, dtype, window),
# the first at the served model's prefill shape; ssd_scan shapes [BH, NC, P,
# N], mamba2-2.7b's and jamba's (B = 2, S = 4,096, chunk 128); the served
# model, its fp32 check's depth and length, its length, its decode steps
ATTN_CASES = [("qwen3-8b prefill", (2, 4096, 32, 8, 128), 4096, "bfloat16", 0),
              ("gemma3-4b local layer", (1, 3000, 8, 4, 256), 3000,
               "bfloat16", 1024),
              ("musicgen-medium MHA", (2, 2048, 24, 24, 64), 2048,
               "bfloat16", 0),
              ("phi3 MHA", (1, 2048, 32, 32, 96), 2048, "bfloat16", 0),
              ("reduced configs' D = 16", (2, 300, 4, 2, 16), 300,
               "bfloat16", 8),
              ("q shorter than k", (2, 100, 32, 8, 128), 1000, "float32", 0),
              ("phi3-like MHA", (1, 2048, 32, 32, 96), 2048, "float32", 0)]
SCAN_SHAPES = [(160, 32, 64, 128), (256, 32, 64, 16), (3, 5, 7, 9)]
LM_ARCH, LM_F32_LAYERS, LM_F32_SEQ, LM_SEQ, LM_STEPS = \
    "qwen3-8b", 4, 1024, 4096, 16
# phase 7e, the SSM, MoE and hybrid families: the full-width ssd_chunked
# check's (B, S); the fp32 card-against-CPU models (arch, layers), their
# batch and length; the served bf16 models (arch, layers), their batch,
# length and decode steps (jamba: one period of its 32 layers)
FAM_SSD = (1, 1024)
FAM_F32 = [("mamba2-2.7b", 4), ("deepseek-moe-16b", 2)]
FAM_F32_BATCH, FAM_F32_SEQ = 1, 512
FAM_SERVED = [("mamba2-2.7b", 64), ("deepseek-moe-16b", 28),
              ("jamba-v0.1-52b", 8), ("llama-3.2-vision-90b", 20)]
FAM_BATCH, FAM_SEQ, FAM_STEPS = 2, 4096, 16
# the VLM's fp32 kernel-against-flash check: its layers (one period), batch
# and length
VLM_F32_LAYERS, VLM_F32_BATCH, VLM_F32_SEQ = 5, 1, 512
# phase 11, training: the attention backward's checks (label, (B, Sq, H, KH,
# D), dtype, window), the first at qwen3-8b's training shape; ssd_scan's
# backward at mamba2-2.7b's training shape (B = 1, S = 4,096) and a ragged
# one; the models trained through train_loop (arch, layers), their batch,
# length and steps; the fp32 gradient checks (arch, layers, length)
TRAIN_ATTN_CASES = [("qwen3-8b train", (1, 4096, 32, 8, 128), "bfloat16", 0),
                    ("qwen3-8b train fp32", (1, 1024, 32, 8, 128), "float32",
                     0),
                    ("gemma3-4b local layer", (1, 3000, 8, 4, 256),
                     "bfloat16", 1024),
                    ("gemma3-4b local layer fp32", (1, 1000, 8, 4, 256),
                     "float32", 256),
                    ("musicgen-medium MHA", (1, 1024, 24, 24, 64),
                     "bfloat16", 0),
                    ("phi3 MHA", (1, 1024, 32, 32, 96), "bfloat16", 0),
                    ("phi3 MHA fp32", (1, 512, 32, 32, 96), "float32", 0),
                    ("reduced configs' D = 16", (2, 300, 4, 2, 16),
                     "bfloat16", 8),
                    ("reduced configs' D = 16 fp32", (2, 300, 4, 2, 16),
                     "float32", 8)]
TRAIN_SCAN_SHAPES = [(80, 32, 64, 128), (3, 5, 7, 9)]
TRAIN_MODELS = [("qwen3-8b", 4), ("mamba2-2.7b", 8)]
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 1, 4096, 5
TRAIN_GRAD_CHECKS = [("qwen3-8b", 1, 1024), ("mamba2-2.7b", 2, 512)]
# the fp32 attention routes (split TF32 on the tensor cores) against
# float64 at every head dim they take, windowed and causal GQA, MHA and q
# shorter than k: (label, (B, Sq, H, KH, D), Sk, window), forward (phase
# 7a) and backward (phase 11a); fp32_case makes each case's inputs from
# its own seed
FP32_FWD_CASES = [("D = 16 window 8", (2, 300, 4, 2, 16), 300, 8),
                  ("D = 64 GQA", (2, 1000, 8, 2, 64), 1000, 0),
                  ("D = 96 MHA", (1, 2048, 32, 32, 96), 2048, 0),
                  ("D = 128 q shorter than k", (2, 100, 32, 8, 128), 1000,
                   0),
                  ("D = 128 window 130", (1, 390, 8, 2, 128), 390, 130),
                  ("D = 256 window 1024", (1, 3000, 8, 4, 256), 3000,
                   1024)]
FP32_BWD_CASES = [("D = 16 window 8", (2, 300, 4, 2, 16), 300, 8),
                  ("D = 64 q shorter than k window 100",
                   (1, 257, 8, 2, 64), 400, 100),
                  ("D = 96 MHA", (1, 512, 32, 32, 96), 512, 0),
                  ("D = 128 GQA", (1, 1024, 32, 8, 128), 1024, 0),
                  ("D = 256 window 256", (1, 1000, 8, 4, 256), 1000, 256)]
# max abs errors against float64 of the SIMT fp32 kernels (PR 14 / PR 24,
# unchanged through PR 32) on those inputs, by
# scripts/torch_attention_fp32_check.py --src on that tree (NVIDIA H100
# 80GB HBM3, 700 W); the split-TF32 kernels may err at most SPLIT_OVER_SIMT
# times as much on every output
SIMT_FP32_ERRS = {
    "forward": {
        "D = 16 window 8": {"out": 4.5151197403114907e-07},
        "D = 64 GQA": {"out": 9.246361997727881e-07},
        "D = 96 MHA": {"out": 8.448340079736383e-07},
        "D = 128 q shorter than k": {"out": 6.6933669018443e-07},
        "D = 128 window 130": {"out": 9.966899381375072e-07},
        "D = 256 window 1024": {"out": 2.023353911195791e-06}},
    "backward": {
        "D = 16 window 8": {
            "dq": 1.0438005286772523e-06, "dk": 9.77226289222699e-07,
            "dv": 1.2853823987413193e-06},
        "D = 64 q shorter than k window 100": {
            "dq": 2.4689782807119087e-06, "dk": 1.6544092245052155e-06,
            "dv": 1.646283481981925e-06},
        "D = 96 MHA": {
            "dq": 3.3992869248322677e-06, "dk": 5.160064240783413e-06,
            "dv": 6.927275328916238e-06},
        "D = 128 GQA": {
            "dq": 3.6139194095063942e-06, "dk": 1.1250925513017762e-05,
            "dv": 2.4742794778376265e-05},
        "D = 256 window 256": {
            "dq": 2.73995794031201e-06, "dk": 3.896431292282898e-06,
            "dv": 7.415675245425746e-06}}}
SPLIT_OVER_SIMT = 1.5
# phase 12d: phase 7's served model cut to these layers, its prompt length
# and decode steps on the 1 x 1 mesh
SHARD_LM_LAYERS, SHARD_LM_SEQ, SHARD_LM_STEPS = 4, 1024, 4


def log(*a):
    print(*a, flush=True)


def fp32_case(torch, dev, i, shape, Sk, with_dout=False):
    """fp32 (q, k, v[, dout]) of an fp32 route's check: standard normal
    from a generator on ``dev`` seeded with SEED + 1000 + i, so that any
    tree makes the same inputs on the same card."""
    B, Sq, H, KH, D = shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 1000 + i)
    shapes = [(B, Sq, H, D), (B, Sk, KH, D), (B, Sk, KH, D)]
    if with_dout:
        shapes.append((B, Sq, H, D))
    return [torch.randn(s, generator=gen, device=dev) for s in shapes]


def attention64(torch, q, k, v, causal, window):
    """float64 attention on the (rounded) inputs, one q head at a time:
    the output [B, Sq, H, D] and each row's log-sum-exp [B, Sq, H]."""
    import math
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    dev = q.device
    q_pos = (Sk - Sq) + torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    out = torch.empty((B, Sq, H, D), dtype=torch.float64, device=dev)
    lse = torch.empty((B, Sq, H), dtype=torch.float64, device=dev)
    for h in range(H):
        s = q[:, :, h].double() @ k[:, :, h // G].double().transpose(1, 2)
        s = torch.where(mask, s / math.sqrt(D), -math.inf)
        out[:, :, h] = torch.softmax(s, -1) @ v[:, :, h // G].double()
        lse[:, :, h] = torch.logsumexp(s, -1)
    return out, lse


def bound_ms(nbytes: float, flops: float, peak_flops_per_s: float):
    """The least time the card could take: bytes at the memory rate or
    flops at ``peak_flops_per_s``, the peak of the inputs' type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# SASS instruction counts by demangled kernel name, filled by build_report
# (empty where the toolkit has no cuobjdump)
SASS_COUNTS = {}


def build_report(log, common):
    """The [build] lines: ptxas's registers, spills and warnings for every
    kernel, the dynamic shared memory of the bf16 attention kernels, and
    the tensor-core instructions in the attention kernels' SASS (cuobjdump),
    or "not available" where the toolkit has no cuobjdump."""
    cxxfilt = shutil.which("c++filt")

    def demangle(names):
        if not cxxfilt or not names:
            return {n: n for n in names}
        out = subprocess.run([cxxfilt], input="\n".join(names),
                             capture_output=True, text=True).stdout
        return dict(zip(names, out.splitlines()))

    lines, names = [], []
    for src, text in common.build_logs().items():
        fn = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
                names.append(fn)
            elif fn and ("registers" in line or "spill" in line):
                lines.append((src, fn, line.strip()))
            elif "warning" in line:
                lines.append((src, None, line.strip()))
    pretty = demangle(names)
    for src, fn, line in lines:
        log(f"[build] {src}: {pretty.get(fn, '') + ': ' if fn else ''}"
            f"{line}")
    lib = common.load_library()
    log("[build] flash_attention_tc dynamic shared memory (bytes) by head "
        "dim: " + ", ".join(f"{d}: {lib.rt_flash_attention_tc_smem(d)}"
                            for d in (16, 64, 96, 128, 256)))
    log("[build] flash_attention_bwd_tc dynamic shared memory (bytes) by "
        "head dim, pass 1 / pass 2: " + ", ".join(
            f"{d}: {lib.rt_flash_attention_bwd_tc_smem(1, d)} / "
            f"{lib.rt_flash_attention_bwd_tc_smem(2, d)}"
            for d in (16, 64, 96, 128, 256)))
    cuobjdump = Path(common._nvcc()).with_name("cuobjdump")
    if not cuobjdump.exists():
        log("[build] SASS tensor-core instruction counts: not available "
            "(no cuobjdump)")
        return
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(common.build_library())],
                          capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
        elif fn:
            for op in ("HGMMA", "HMMA", "UTMALDG", "FFMA", "LDGSTS", "UBLKCP",
                       "LDL", "STL"):
                if re.search(rf"\b{op}\b", line):
                    counts[fn][op] += 1
    pretty = demangle(list(counts))
    SASS_COUNTS.update({pretty[fn]: c for fn, c in counts.items()})
    for fn, c in counts.items():
        if "fa_tc_kernel" in fn or "fa_fwd_kernel" in fn:
            log(f"[build] SASS {pretty[fn]}: HGMMA {c['HGMMA']}, HMMA "
                f"{c['HMMA']}, UTMALDG {c['UTMALDG']}, LDGSTS "
                f"{c['LDGSTS']}, FFMA {c['FFMA']}, LDL {c['LDL']}")
        elif fn.startswith(("_Z13region_kernel", "_Z17region_bwd_kernel",
                            "_Z18region_rows_kernel")):
            # the weight ring's async copies (cp.async: LDGSTS; bulk or
            # tensor copies, the row clusters' multicast: UBLKCP / UTMALDG)
            # and local-memory loads
            log(f"[build] SASS {pretty[fn]}: LDGSTS {c['LDGSTS']}, UBLKCP "
                f"{c['UBLKCP']}, UTMALDG {c['UTMALDG']}, LDL {c['LDL']}, "
                f"FFMA {c['FFMA']}")
        elif "fa_bwd_" in fn:
            # the attention backward: wgmma and TMA loads (the bf16
            # tensor-core kernels), mma.sync and cp.async (the fp32 split-
            # TF32 kernels), and any local-memory traffic
            log(f"[build] SASS {pretty[fn]}: HGMMA {c['HGMMA']}, UTMALDG "
                f"{c['UTMALDG']}, UBLKCP {c['UBLKCP']}, HMMA {c['HMMA']}, "
                f"LDGSTS {c['LDGSTS']}, FFMA {c['FFMA']}, LDL {c['LDL']}, "
                f"STL {c['STL']}")
        elif "ssd_scan_bwd_kernel" in fn:
            # the scan backward: SIMT FMAs, and any local-memory traffic
            log(f"[build] SASS {pretty[fn]}: FFMA {c['FFMA']}, LDL "
                f"{c['LDL']}, STL {c['STL']}")
        elif fn.startswith("_Z18fused_chain_kernel"):
            # the tile's cp.async staging and any local-memory traffic
            log(f"[build] SASS {pretty[fn]}: LDGSTS {c['LDGSTS']}, LDL "
                f"{c['LDL']}, STL {c['STL']}")


def plan_launches(cg):
    """Launches of one pass of ``cg`` over any rows: one per execution
    unit, by the kernel its dispatch names."""
    return collections.Counter("region" if k.startswith("region") else k
                               for _, _, k in cg.dispatch if k != "interpret")


def launched_by(launches, fn):
    """The launches ``fn()`` makes, by kernel (``launches``: the wrappers'
    counter, ``common.LAUNCHES``)."""
    before = collections.Counter(launches)
    fn()
    return collections.Counter(launches) - before


def scaled_err(got, want):
    got, want = got.double(), want.double()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    return err, err / max(scale, 1e-30)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.configs.siren import SirenConfig
    from repro_torch.core.config import HardwareConfig
    from repro_torch.core.executor import (_run_region, _run_segment,
                                           region_operands)
    from repro_torch.core.pipeline import compile_gradient
    from repro_torch.inr.siren import siren_fn, siren_init
    from repro_torch.kernels import common
    from repro_torch.kernels.fused_chain import (BINARY, chain_program,
                                                 eval_chain, fused_chain,
                                                 launch_floor)
    from repro_torch.kernels.region import (RegionKernelSpec, lower,
                                           plan_region, plan_region_bwd,
                                           region_call, region_call_plain,
                                           region_call_stacked,
                                           region_call_stacked_plain,
                                           sm_count)
    from repro_torch.kernels.siren_layer import siren_layer, siren_layer_plain
    from repro_torch.kernels.stream_matmul import (stream_matmul,
                                                   stream_matmul_plain)

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    common.fp32_strict()
    dev = torch.device("cuda")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    common.load_library()
    log(f"[build] kernel library ready in {time.perf_counter() - t0:.1f} s")
    build_report(log, common)

    gen = torch.Generator().manual_seed(SEED)

    def rand(*shape, lo=-1.0, hi=1.0):
        return (torch.rand(*shape, generator=gen) * (hi - lo) + lo).to(dev)

    def call_ms(fn, iters=200, warmup=10):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / iters

    def device_ms(fn, iters=50, by_kernel=False):
        """Kernel time per call from torch.profiler; None if it saw none.
        ``by_kernel``: a dict of it by kernel name instead of the sum.

        Once many launches have run unprofiled, the profiler leaves out the
        first few kernel records of a session (on the H100, a stacked
        kernel read far below its CUDA-event time).  Each session starts
        with spin kernels that take that loss and are not counted; a
        session that kept none of them may have lost a measured record and
        is run again, with 16 times the spin kernels (late in a run the
        profiler has lost more than 16 leading records)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        for attempt in range(3):
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(16 ** (attempt + 1)):
                        torch.cuda._sleep(1000)
                    for _ in range(iters):
                        fn()
                    torch.cuda.synchronize()
            except RuntimeError as exc:  # no CUPTI: fall back to events
                log(f"[timing] torch.profiler unavailable: {exc}")
                return None
            recs = [ev for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA]
            if any("spin_kernel" in ev.key for ev in recs):
                break
        else:
            log("[timing] the profiler lost the leading records 3 times")
            return None
        times = {}
        for ev in recs:
            if "spin_kernel" not in ev.key:
                t = getattr(ev, "self_device_time_total", None) \
                    or getattr(ev, "self_cuda_time_total", 0.0)
                times[ev.key] = times.get(ev.key, 0.0) + t / iters / 1e3
        total = sum(times.values())
        if total <= 0:
            return None
        return times if by_kernel else total

    def timing(fn, iters=50, call_iters=200):
        dms, cms = device_ms(fn, iters), call_ms(fn, call_iters)
        return (dms if dms is not None else cms), cms

    kernels = {}

    def region_cluster(spec, stream, rows, res):
        """The cluster width region_call takes for these operands."""
        return plan_region(spec, tuple(a.shape[1] for a in stream),
                           tuple(a.shape[1] for a in rows),
                           tuple(tuple(a.shape) for a in res),
                           stream[0].shape[0], 1, sm_count(0)).cluster

    def cluster_report(spec, stream, rows, res):
        """C and the card's max active clusters of the forward at R = 8,
        R = 512 and the stacked K = 8, R = 8,192 launch, and of region_bwd
        at R = 8 and R = 1,000 (the lowering's choice; nothing launched)."""
        widths = (tuple(a.shape[1] for a in stream),
                  tuple(a.shape[1] for a in rows),
                  tuple(tuple(a.shape) for a in res))
        lib = common.load_library()
        out = []
        for label, R, lanes in [("region R=8", 8, 1),
                                ("region R=512", 512, 1),
                                ("region_stacked K=8 R=8192", 8192, 8)]:
            prog = plan_region(spec, *widths, R, lanes, sm_count(0))
            occ = lib.rt_region_max_clusters(prog.cluster, prog.rows,
                                             prog.row_cluster,
                                             prog.smem_bytes)
            out.append(f"{label}: {prog.describe()}, {occ} clusters")
        for label, tiles in [("region_bwd R=8", 1), ("region_bwd R=1000", 125)]:
            prog = plan_region_bwd(spec, *widths, tiles, sm_count(0))
            occ = lib.rt_region_bwd_max_clusters(prog.cluster, prog.smem_bytes)
            out.append(f"{label}: C={prog.cluster}, {prog.smem_bytes} B/CTA, "
                       f"{occ} clusters")
        return "; ".join(out)

    def record(name, source, replaces, errs, t_k, t_p, nbytes, flops,
               library_ms=None, peak_flops_per_s=FP32_FLOPS_PER_S,
               pallas=True, route=None):
        """``pallas=False``: a kernel with no Pallas counterpart, whose
        ``replaces`` names the reference's XLA code it stands for.
        ``route``: the figures of a second route of a kernel already
        recorded (its fp32 source beside the bf16 one), kept under the
        record's ``routes``."""
        b, by = bound_ms(nbytes, flops, peak_flops_per_s)
        if route is not None:
            kernels[name].setdefault("routes", {})[route] = {
                "source": source, "shape": replaces,
                "max_abs_err": max(e for e, _ in errs),
                "ms": t_k[0], "plain_ms": t_p[0], "bound_ms": b,
                "bound_by": by, "library_ms": library_ms,
                "call_ms": t_k[1], "plain_call_ms": t_p[1]}
            log(f"[kernel] {name} {route} route ({source}) at {replaces}: "
                f"{t_k[0]:.5f} ms/launch on the device ({t_k[1]:.5f} "
                f"ms/call), plain {t_p[0]:.5f} ms ({t_p[1]:.5f} ms/call), "
                f"bound {b:.6f} ms by {by} at {peak_flops_per_s / 1e12:.0f} "
                f"TFLOP/s, library {library_ms:.5f} ms; {card}")
            return
        kernels[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "pallas_counterpart": pallas,
            "launches": 0,
            "max_abs_err": max(e for e, _ in errs),
            "ms": t_k[0], "plain_ms": t_p[0], "bound_ms": b, "bound_by": by,
            "library_ms": library_ms,
            "call_ms": t_k[1], "plain_call_ms": t_p[1],
            "max_scaled_err": max(s for _, s in errs)}
        log(f"[kernel] {name}: max err {kernels[name]['max_abs_err']:.3e} "
            f"(scaled {kernels[name]['max_scaled_err']:.3e}); "
            f"{t_k[0]:.5f} ms/launch on the device ({t_k[1]:.5f} ms/call), "
            f"plain {t_p[0]:.5f} ms ({t_p[1]:.5f} ms/call), "
            f"bound {b:.6f} ms by {by}"
            + (f", library {library_ms:.5f} ms" if library_ms else ""))

    # -- 3a. fused_chain -----------------------------------------------------
    chains = [[(op, None) for op in ("sin", "cos", "exp", "tanh", "neg",
                                      "abs", "relu", "sigmoid", "silu",
                                      "square")],
              [("scale", 0.5), ("mul", None), ("offset", -0.25),
               ("add", None), ("sub", None), ("div", None)],
              [("max", None), ("cos", None), ("min", None), ("scale", 30.0),
               ("sin", None)]]
    # 16 binary steps (every binary op) between unary ones: the most
    # extras a launch takes
    chain16 = [(op, None) for op in ("mul", "add", "sub", "max", "min", "div")
               * 3][:16]
    chain16[4:4] = [("sin", None)]
    chain16[10:10] = [("scale", 0.5), ("tanh", None)]
    errs = []

    def check(x, chain, ex):
        got = fused_chain(x, chain, ex)
        torch.cuda.synchronize()
        errs.append(scaled_err(got, eval_chain(x, chain, ex)))

    for shape in [(8, 256), (8, 2), (8, 1), (13, 256), (13, 255)]:
        for chain in chains:
            check(rand(*shape), chain, [rand(*shape, lo=0.5, hi=1.5)
                                        for op, _ in chain if op in BINARY])
        # broadcast operands, as the executor passes row-constant extras
        x, row, col = rand(*shape), rand(1, shape[1]), rand(shape[0], 1)
        got = fused_chain(x, [("mul", None), ("add", None)], [row, col])
        errs.append(scaled_err(got, x * row + col))
        # 16 extras: full, row- and column-broadcast ones
        check(rand(*shape), chain16,
              [rand(*((1, shape[1]), (shape[0], 1), shape)[k % 3],
                    lo=0.5, hi=1.5) for k in range(16)])
    # views 4 bytes off 16-byte alignment: x contiguous, extras with an odd
    # row stride, a row- and a column-broadcast one from strided storage
    x = rand(8 * 256 + 1)[1:].view(8, 256)
    check(x, [("mul", None), ("add", None), ("sub", None), ("div", None)],
          [rand(8, 257)[:, 1:], rand(257)[1:], rand(8, 3)[:, 1:2],
           rand(8, 257, lo=0.5, hi=1.5)[:, 1:]])
    worst = max(s for _, s in errs)
    log(f"[kernel] fused_chain exactness: {len(errs)} checks ([8,256], "
        f"[8,2], [8,1], [13,256], [13,255], broadcast and 16 extras, "
        f"unaligned views): largest scaled err {worst:.3e}")
    if worst > 1e-5:
        raise AssertionError(f"fused_chain disagrees: scaled err {worst:.3e}")
    # the wrapper's checks on CUDA operands
    x = rand(8, 256)
    for exc, bad in [(ValueError, lambda: fused_chain(x, [("mul", None)])),
                     (ValueError, lambda: fused_chain(x[None], [("sin", None)])),
                     (ValueError, lambda: fused_chain(
                         x, [("mul", None)] * 17, [x] * 17)),
                     (TypeError, lambda: fused_chain(x.double(),
                                                     [("sin", None)])),
                     (ValueError, lambda: fused_chain(x.t(), [("sin", None)])),
                     (TypeError, lambda: fused_chain(x, [("mul", None)],
                                                     [x.cpu()]))]:
        try:
            bad()
        except exc:
            continue
        raise AssertionError(f"fused_chain did not raise {exc.__name__}")
    # device time and host time per call at [8,256], the path's chains with
    # 1, 5 and 0 extras beside the floor under any launch on this grid: an
    # empty kernel on the same grid and block
    floor = timing(lambda: launch_floor(x))
    log(f"[kernel] launch floor: an empty kernel on fused_chain's grid for "
        f"[8,256]: {floor[0]:.5f} ms/launch on the device ({floor[1]:.5f} "
        f"ms/call)")
    by_chain, timed = {}, {}
    for label, chain in [
            ("cos·mul·scale", (("cos", None), ("mul", None), ("scale", 30.0))),
            ("mul·mul·add·add·add·scale",
             (("mul", None), ("mul", None), ("add", None), ("add", None),
              ("add", None), ("scale", 0.5))),
            ("scale", (("scale", 30.0),))]:
        # full [8,256] extras, as the SIREN plans pass every extra; the
        # chain encoded once, as the executor passes ChainSpec.program
        ex = [rand(8, 256) for op, _ in chain if op in BINARY]
        prog = chain_program(chain)
        t = timing(lambda: fused_chain(x, prog, ex))
        timed[label] = chain, ex, t
        by_chain[label] = {"extras": len(ex), "ms": t[0], "call_ms": t[1],
                           "own_ms": t[0] - floor[0]}
        log(f"[kernel] fused_chain {label} at [8,256] ({len(ex)} extras): "
            f"{t[0]:.5f} ms/launch on the device, own {t[0] - floor[0]:.5f} "
            f"ms above the floor ({t[1]:.5f} ms/call)")
    chain, ex, t = timed["cos·mul·scale"]                 # the path's
    record("fused_chain", "src/repro_torch/kernels/csrc/fused_chain.cu",
           "src/repro/kernels/fused_chain.py:81", errs, t,
           timing(lambda: eval_chain(x, chain, ex)),
           4 * 8 * 256 * 3, 3 * 8 * 256)
    # host time of the broadcast strides launch_args packs for the 5
    # extras: their own strides (an extra of x's shape) against expand's
    ex = timed["mul·mul·add·add·add·scale"][1]
    strides_us = {}
    for label, fn in [("stride", lambda: [e.stride() for e in ex]),
                      ("expand", lambda: [e.expand(x.shape).stride()
                                          for e in ex])]:
        fn()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        strides_us[label] = (time.perf_counter() - t0) / 2000 * 1e6
    log(f"[host] strides of 5 [8,256] extras: own {strides_us['stride']:.3f} "
        f"us, by expand {strides_us['expand']:.3f} us")
    kernels["fused_chain"].update(launch_floor_ms=floor[0],
                                  launch_floor_call_ms=floor[1],
                                  chains=by_chain, strides_us=strides_us)

    # -- 3b. stream_matmul / siren_layer -------------------------------------
    mm_errs = {"stream_matmul": [], "siren_layer": []}
    for m, k, n in [(8, 256, 256), (8, 2, 256), (8, 1, 256), (8, 256, 2),
                    (8, 256, 1), (13, 37, 5), (20, 600, 70)]:
        a, w = rand(m, k), rand(k, n) / k ** 0.5
        b = rand(n)
        got = stream_matmul(a, w, mm_parallel=16)
        mm_errs["stream_matmul"].append(scaled_err(got,
                                                   stream_matmul_plain(a, w)))
        for sin in (True, False):
            got = siren_layer(a, w, b, w0=30.0, apply_sin=sin, mm_parallel=16)
            mm_errs["siren_layer"].append(scaled_err(
                got, siren_layer_plain(a, w, b, w0=30.0, apply_sin=sin)))
    torch.cuda.synchronize()
    for name, e in mm_errs.items():
        worst = max(s for _, s in e)
        if worst > 1e-4:
            raise AssertionError(f"{name} disagrees: scaled err {worst:.3e}")
    a, w, b = rand(8, 256), rand(256, 256) / 16.0, rand(256)
    mm_bytes = 4 * (8 * 256 + 256 * 256 + 8 * 256)
    lib_ms = timing(lambda: torch.mm(a, w))[0]
    record("stream_matmul", "src/repro_torch/kernels/csrc/matmul.cu",
           "src/repro/kernels/stream_matmul.py:46", mm_errs["stream_matmul"],
           timing(lambda: stream_matmul(a, w, mm_parallel=16)),
           timing(lambda: stream_matmul_plain(a, w)),
           mm_bytes, 2 * 8 * 256 * 256, library_ms=lib_ms)
    record("siren_layer", "src/repro_torch/kernels/csrc/matmul.cu",
           "src/repro/kernels/siren_layer.py:38", mm_errs["siren_layer"],
           timing(lambda: siren_layer(a, w, b, w0=30.0, mm_parallel=16)),
           timing(lambda: siren_layer_plain(a, w, b, w0=30.0)),
           mm_bytes + 4 * 256, 2 * 8 * 256 * 256 + 3 * 8 * 256)
    log("[kernel] stream_matmul / siren_layer at [8,256]@[256,256]: "
        "32 x 1 = 32 CTAs of 8 x 8 outputs (csrc/matmul.cu's grid)")

    # -- 3c. region, on the operands the main path hands it ------------------
    cfg = SirenConfig()
    params = siren_init(cfg, gen, device=dev)
    f = siren_fn(cfg, params)
    grid = torch.linspace(-1, 1, 256)
    coords = torch.stack(torch.meshgrid(grid, grid, indexing="ij"),
                         -1).reshape(-1, 2).to(dev)
    small = torch.linspace(-1, 1, 64)
    coords_small = torch.stack(torch.meshgrid(small, small, indexing="ij"),
                               -1).reshape(-1, 2).to(dev)
    fused_cfg = HardwareConfig(use_pallas=True)
    unfused_cfg = HardwareConfig(use_pallas=True, fuse_regions=False)
    tiled_cfg = HardwareConfig(use_pallas=True, bn=64, vmem_budget=1 << 20)

    def walk_block(cg, xblk, on_region):
        """Run one block unit by unit, calling on_region before each region."""
        plan, block, B = cg.plan, cg.config.block, cg.plan.batch
        env = {plan.inputs[0]: xblk}
        for kind, u in cg.region_plan.units():
            if kind == "region":
                on_region(u, region_operands(plan, u, env, cg.residents,
                                             block, B))
                _run_region(plan, u, env, cg.residents, block, B)
            else:
                env[u.output] = _run_segment(plan, u, cg._decisions[u.id],
                                             env, cg.residents, block, B)

    region_errs, region_shapes = [], []
    timed_region = None
    for order, conf in [(1, fused_cfg), (2, fused_cfg), (3, fused_cfg),
                        (1, tiled_cfg)]:
        t0 = time.perf_counter()
        cg = compile_gradient(f, order, coords[:cfg.batch], config=conf,
                              device="cuda")
        log(f"[compile] order {order} {conf.describe()}: "
            f"{time.perf_counter() - t0:.2f} s, {len(cg.graph.nodes)} nodes, "
            f"{len(cg.plan.segments)} segments, {cg.region_plan.counts()}")
        if conf is tiled_cfg and not any(r.spec.tile_groups for r in
                                         cg.region_plan.fused_regions()):
            raise AssertionError("the tight budget planned no tile group")

        def check(region, ops, order=order, conf=conf):
            """The region at one block's R = 8 and at R = 512 (the
            main path's chunk-wide launch), each against
            its plain version, and the device time of one launch."""
            nonlocal timed_region
            stream, rows, res, out_info = ops
            big = [rand(512, a.shape[1]) for a in stream]
            times = []
            for R, st in ((8, stream), (512, big)):
                got = region_call(region.spec, st, rows, res, out_info)
                want = region_call_plain(region.spec, st, rows, res,
                                         out_info)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    region_errs.append(scaled_err(a, b))
                C = region_cluster(region.spec, st, rows, res)
                t = device_ms(lambda: region_call(region.spec, st, rows, res,
                                                  out_info), 20)
                times.append(f"R={R} C={C}: {t} ms/launch")
            region_shapes.append((order, len(region.spec.steps),
                                  len(region.spec.tile_groups)))
            kinds = [st[0] for st in region.spec.steps]
            log(f"[region] order {order} bn={conf.bn}: {len(kinds)} steps "
                f"({kinds.count('mm')} mm, {kinds.count('chain')} chain), "
                f"{len(region.spec.tile_groups)} tile groups: "
                f"{'; '.join(times)} on the device")
            if order == 2 and conf is fused_cfg and timed_region is None:
                timed_region = (region.spec, ops)

        walk_block(cg, coords[1000:1000 + cg.config.block], check)
    worst = max(s for _, s in region_errs)
    log(f"[region] {len(region_shapes)} regions checked "
        f"(order, steps, tile groups): {region_shapes}")
    if worst > 1e-4:
        raise AssertionError(f"region disagrees: scaled err {worst:.3e}")
    # the cost of one step inside a launch: 16 chained mm steps
    # ([8,256]@[256,256]) and 16 chained cos-mul-scale chain steps ([8,256])
    x, w, e1 = rand(8, 256), rand(256, 256) / 16.0, rand(8, 256)
    for label, steps, stream, res in [
            ("mm", tuple(("mm", i + 1, i, 100, None, 1.0, False)
                         for i in range(16)), [x], [w]),
            ("chain", tuple(("chain", i + 1, i, tuple(chain), (101,))
                            for i in range(16)), [x, e1], [])]:
        one = RegionKernelSpec(steps=steps[:1],
                               stream_inputs=(0, 101)[:len(stream)],
                               residents=(100,)[:len(res)], outputs=(1,))
        many = dataclasses.replace(one, steps=steps, outputs=(16,))
        t1 = device_ms(lambda: region_call(one, stream, [], res,
                                           ((256, "float32"),)), 20)
        t16 = device_ms(lambda: region_call(many, stream, [], res,
                                            ((256, "float32"),)), 20)
        log(f"[region] one {label} step [8,256]: {t1} ms/launch; 16 steps: "
            f"{t16} ms/launch")
    spec, ops = timed_region
    stream, rows, res, out_info = ops
    log("[region] clusters of the order-2 region by shape (C, then "
        "cudaOccupancyMaxActiveClusters at the launch's shared memory): "
        + cluster_report(spec, stream, rows, res))
    elems = sum(t.numel() for t in (*stream, *rows, *res)) \
        + sum(8 * c for c, _ in out_info)
    flops = lower(spec, tuple(t.shape[1] for t in stream),
                  tuple(t.shape[1] for t in rows),
                  tuple(tuple(t.shape) for t in res)).flops(8)
    record("region", "src/repro_torch/kernels/csrc/region.cu",
           "src/repro/kernels/region.py:241", region_errs,
           timing(lambda: region_call(spec, *ops)),
           timing(lambda: region_call_plain(spec, *ops)),
           4 * elems, flops)

    # -- 4. the main path ----------------------------------------------------
    def oracle(x, order, weights=params, chunk=4096):
        """float64 nth-order input gradients by nested torch.autograd."""
        p64 = [{k: v.double() for k, v in p.items()} for p in weights]
        cols = None
        for i in range(0, x.shape[0], chunk):
            xx = x[i:i + chunk].double().clone().requires_grad_(True)
            y = xx
            for li, p in enumerate(p64):
                y = y @ p["w"] + p["b"]
                if li < len(p64) - 1:
                    y = torch.sin(cfg.w0 * y)
            outs = [y]
            level = [y[:, c].sum() for c in range(y.shape[1])]
            for _ in range(order):
                grads = [torch.autograd.grad(s, xx, create_graph=True)[0]
                         for s in level]
                outs += grads
                level = [gr[:, j].sum() for gr in grads
                         for j in range(xx.shape[1])]
            outs = [o.detach() for o in outs]
            cols = [[o] for o in outs] if cols is None else \
                [c + [o] for c, o in zip(cols, outs)]
        return [torch.cat(c) for c in cols]

    # the main path, counted: each order's apply_batched and one chunk
    paths = [(fused_cfg, coords, "fused"), (unfused_cfg, coords_small,
                                             "unfused")]
    want_main = {}
    common.reset_launches()
    for conf, xs, label in paths:
        for order in (1, 2, 3):
            cg = compile_gradient(f, order, xs[:cfg.batch], config=conf,
                                  device="cuda")
            before = dict(common.LAUNCHES)
            cg.apply_batched(xs[:cg.config.block])          # warm-up block
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = cg.apply_batched(xs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            want = want_main[label, order] = oracle(xs, order)
            if len(outs) != len(want):
                raise AssertionError(f"{len(outs)} outputs, want {len(want)}")
            errs = []
            for o, w in zip(outs, want):
                if tuple(o.shape) != tuple(w.shape) or \
                        not bool(torch.isfinite(o).all()):
                    raise AssertionError(f"bad output {tuple(o.shape)}")
                errs.append(scaled_err(o, w)[1])
            # one chunk launches each unit of the plan once
            rows = cg.config.chunk_blocks * cg.config.block
            xc = xs[:rows].reshape(cg.config.chunk_blocks, cg.config.block,
                                   -1)
            per_chunk = launched_by(common.LAUNCHES,
                                    lambda: cg.apply_chunk(xc))
            launches = {k: v - before.get(k, 0)
                        for k, v in common.LAUNCHES.items()
                        if v - before.get(k, 0)}
            rp = cg.region_plan
            log(f"[main] {label} order {order}: N={xs.shape[0]} "
                f"nodes={len(cg.graph.nodes)} "
                f"segments={len(cg.plan.segments)} "
                f"regions={len(rp.regions) if rp else 0} "
                f"fused={len(rp.fused_regions()) if rp else 0} "
                f"wall={wall * 1e3:.1f} ms "
                f"us_per_row={wall * 1e6 / xs.shape[0]:.3f} "
                f"max_scaled_err={max(errs):.3e} launches={launches} "
                f"per {rows}-row chunk={dict(per_chunk)}")
            if max(errs) > 1e-4:
                raise AssertionError(f"{label} order {order}: scaled err "
                                     f"{max(errs):.3e} > 1e-4")
            if per_chunk != plan_launches(cg):
                raise AssertionError(f"{label} order {order}: one chunk "
                                     f"launched {dict(per_chunk)}, the plan's "
                                     f"units {dict(plan_launches(cg))}")
            need = (["region"] + (["fused_chain"] if order == 3 else [])
                    if conf is fused_cfg else
                    ["fused_chain", "siren_layer", "stream_matmul"])
            if not all(launches.get(k) for k in need):
                raise AssertionError(f"{label} order {order} launched "
                                     f"{launches}, needs {need}")
    launches_main = dict(common.LAUNCHES)
    log(f"[launches] phase 4 (compile_gradient -> apply_batched): "
        f"{launches_main}")

    # chunk-wide against the per-block walk (apply_block on every 8-row
    # block, as the port served before chunks) on the same 4,096 rows:
    # bit for bit, unit by unit, and µs per row with the busy share
    def per_block(cg, x):
        b = cg.config.block
        outs = [cg.apply_block(x[i:i + b]) for i in range(0, x.shape[0], b)]
        return tuple(torch.cat(col) for col in zip(*outs))

    def unit_equality(cg, x):
        """Each execution unit on x's rows in one launch against the same
        unit launched block by block on the same inputs: [units equal,
        units] by kernel."""
        plan, B, b = cg.plan, cg.plan.batch, cg.config.block
        units = (cg.region_plan.units() if cg.region_plan is not None
                 else [("seg", s) for s in plan.segments])
        env = {plan.inputs[0]: x}
        tally = collections.defaultdict(lambda: [0, 0])
        for (kind, u), (_, _, kernel) in zip(units, cg.dispatch):
            def run(e, rows):
                if kind == "region":
                    _run_region(plan, u, e, cg.residents, rows, B)
                    return [e[o] for o in u.outputs]
                return [_run_segment(plan, u, cg._decisions[u.id], e,
                                     cg.residents, rows, B)]
            wide = run(dict(env), x.shape[0])
            blocks = [run({k: env[k][i:i + b] for k in u.stream_inputs}, b)
                      for i in range(0, x.shape[0], b)]
            name = "region" if kernel.startswith("region") else kernel
            tally[name][0] += all(torch.equal(w, torch.cat(col))
                                  for w, col in zip(wide, zip(*blocks)))
            tally[name][1] += 1
            outs = u.outputs if kind == "region" else (u.output,)
            env.update(zip(outs, wide))
        return dict(tally)

    def reading(fn, rows):
        """µs per row and busy share of fn() over ``rows`` rows: wall of
        one call after a warm-up, device time of another."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dms = device_ms(fn, 1)
        busy = (f"{dms / (wall * 1e3):.3f}" if dms is not None
                else "not measured")
        return f"{wall * 1e6 / rows:.3f} us/row, busy {busy}"

    for conf, xs, label in paths:
        for order in (1, 2, 3):
            cg = compile_gradient(f, order, xs[:cfg.batch], config=conf,
                                  device="cuda")
            x = xs[:4096]
            rows = cg.config.chunk_blocks * cg.config.block
            xc = x[:2 * rows].reshape(2, cg.config.chunk_blocks,
                                      cg.config.block, -1)
            chunks = [cg.apply_chunk(xc[c]) for c in range(2)]
            walk = per_block(cg, x)
            same = all(torch.equal(o.reshape(-1, *o.shape[2:]),
                                   w[c * rows:(c + 1) * rows])
                       for c in range(2) for o, w in zip(chunks[c], walk))
            whole = all(torch.equal(a, b) for a, b in
                        zip(cg.apply_batched(x), walk))
            units = unit_equality(cg, x[:rows])
            log(f"[main] {label} order {order}: two {rows}-row chunks "
                f"torch.equal to the per-block walk: {same}, all 4096 rows: "
                f"{whole}; units equal by kernel (equal, units): {units}")
            log(f"[main] {label} order {order} on 4096 rows: chunk-wide "
                f"{reading(lambda: cg.apply_batched(x), 4096)}; per-block "
                f"walk {reading(lambda: per_block(cg, x), 4096)}")
            if not (same and whole) or any(e != n for e, n in
                                           units.values()):
                raise AssertionError(f"{label} order {order}: chunk-wide "
                                     f"differs from the per-block walk "
                                     f"(units {units})")
    # one launch per unit for the whole 65,536-row grid (chunk_blocks =
    # 8,192), a reading for the dataflow model's choice of the chunk
    wide_cfg = dataclasses.replace(fused_cfg, chunk_blocks=8192)
    for order in (1, 2, 3):
        cg = compile_gradient(f, order, coords[:cfg.batch], config=wide_cfg,
                              device="cuda")
        cg.apply_batched(coords)
        got = launched_by(common.LAUNCHES, lambda: cg.apply_batched(coords))
        errs = [scaled_err(o, w)[1] for o, w in
                zip(cg.apply_batched(coords), want_main["fused", order])]
        log(f"[main] fused order {order}, chunk_blocks=8192 (one chunk of "
            f"{coords.shape[0]} rows): "
            f"{reading(lambda: cg.apply_batched(coords), coords.shape[0])}; "
            f"launches {dict(got)}; max_scaled_err {max(errs):.3e}")
        if max(errs) > 1e-4 or got != plan_launches(cg):
            raise AssertionError(f"chunk_blocks=8192 order {order}: err "
                                 f"{max(errs):.3e}, launches {dict(got)}")

    # -- 5. multi-INR serving ------------------------------------------------
    launches_multi, fleet = multi_inr_phase(
        log, torch, dev, cfg, f, params, coords, fused_cfg, oracle,
        scaled_err, device_ms, timing, record, reading)

    # -- 6. streamed fitting -------------------------------------------------
    launches_fit = fit_phase(
        log, torch, dev, cfg, f, params, coords_small, fused_cfg, tiled_cfg,
        walk_block, scaled_err, device_ms, timing, record, reading)

    # -- 7. LM serving --------------------------------------------------------
    launches_ops, launches_lm = lm_phase(log, torch, dev, scaled_err,
                                         device_ms, timing, record)
    launches_families = lm_families_phase(log, torch, dev, scaled_err,
                                          device_ms)

    # -- 8. the compiler half: config="auto", the dataflow model -------------
    launches_auto = autoconfig_phase(log, torch, cfg, f, coords, fused_cfg,
                                     unfused_cfg, want_main, scaled_err,
                                     reading)

    # -- 9. filter banks and INR editing --------------------------------------
    launches_bank, bank, psis = bank_phase(
        log, torch, dev, cfg, f, coords, fused_cfg, want_main["fused", 2],
        scaled_err, device_ms, reading)

    # -- 10. async serving, drift telemetry, codegen --------------------------
    launches_async, launches_drift = async_phase(
        log, torch, dev, cfg, f, params, fleet, bank, psis, coords,
        fused_cfg, unfused_cfg, oracle, scaled_err, reading)

    # -- 11. LM training ------------------------------------------------------
    launches_train, trained = train_phase(log, torch, dev, scaled_err,
                                          device_ms, timing, record)

    # -- 12. sharding on a 1 x 1 mesh -----------------------------------------
    launches_sharded = sharding_phase(log, torch, dev, cfg, f, params, fleet,
                                      coords, fused_cfg, card)

    # -- 13. the dry run on fake tensors --------------------------------------
    launches_dryrun = dryrun_phase(log, torch, dev, trained, card)

    # -- 14. launches --------------------------------------------------------
    # ``launches`` counts the path a kernel was ported for (phase 4's for
    # PR 11's kernels, phase 5's for region_stacked, phase 6's for
    # region_bwd, phase 7's qwen3 serving for flash_attention, phase 7e's
    # SSM / MoE / hybrid / VLM serving for ssd_scan, phase 11's training for
    # the two backward kernels); ``launches_by_path`` gives every path's own
    # count.
    paths = {"compile_gradient": launches_main, "multi_inr": launches_multi,
             "fit": launches_fit, "lm_serve": launches_lm,
             "lm_families": launches_families,
             "kernel_ops": launches_ops, "compile_auto": launches_auto,
             "bank": launches_bank, "async_serve": launches_async,
             "drift": launches_drift, "train": launches_train,
             "sharded": launches_sharded, "dryrun": launches_dryrun}
    home = {"region_stacked": "multi_inr", "region_bwd": "fit",
            "flash_attention": "lm_serve", "ssd_scan": "lm_families",
            "flash_attention_bwd": "train", "ssd_scan_bwd": "train"}
    for name, rec in kernels.items():
        rec["launches_by_path"] = {p: c.get(name, 0) for p, c in paths.items()}
        rec["launches"] = rec["launches_by_path"][
            home.get(name, "compile_gradient")]
    log(f"[launches] by path: "
        f"{ {k: kernels[k]['launches_by_path'] for k in kernels} }")
    missing = [k for k in kernels if kernels[k]["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their path: "
                             f"{missing}")
    log(json.dumps({"kernels": list(kernels.values())}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def multi_inr_phase(log, torch, dev, cfg, f, params, coords, fused_cfg,
                    oracle, scaled_err, device_ms, timing, record, reading):
    """Phase 5; returns the launches made while it drove the multi-INR
    paths (the kernel checks before it are not counted) and the K weight
    sets of its fleet (lane 0 is ``params``)."""
    from repro_torch.core import trace
    from repro_torch.core.pipeline import compile_gradient
    from repro_torch.inr.siren import siren_fn, siren_init
    from repro_torch.kernels import common
    from repro_torch.kernels.region import (lower, plan_region, region_call,
                                           region_call_plain,
                                           region_call_stacked,
                                           region_call_stacked_plain,
                                           sm_count)
    from repro_torch.serve import (ArtifactStore, MultiINRArtifact,
                                   ServingEngine, bind_weights)

    K, N, N_LANE3 = 8, 8192, 1024
    weights = [params] + [siren_init(cfg, torch.Generator().manual_seed(k),
                                     device=dev) for k in range(1, K)]
    fns = [f] + [siren_fn(cfg, w) for w in weights[1:]]
    gen = torch.Generator().manual_seed(K)
    lane_coords = (torch.rand(K, N, 2, generator=gen) * 2 - 1).to(dev)
    shared = coords[:N]
    ragged = N - 3

    def artifact(order):
        base = compile_gradient(f, order, coords[:cfg.batch],
                                config=fused_cfg, device="cuda")
        payloads = [bind_weights(base, params, w) for w in weights]
        return MultiINRArtifact(base, payloads)

    # -- 5a. the stacked kernel on the real regions' operands ---------------
    stacked_errs = []
    timed = None
    for order in (1, 2):
        m = artifact(order)
        (region, rows, res, out_info), = m.stacked_calls
        if tuple(region.stream_inputs) != (m.base.plan.inputs[0],):
            raise AssertionError(f"order {order}: region streams "
                                 f"{region.stream_inputs}")
        ops = ([lane_coords], rows, res, out_info)
        got = region_call_stacked(region.spec, *ops)
        want = region_call_stacked_plain(region.spec, *ops)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            stacked_errs.append(scaled_err(a, b))
        for k in range(K):
            lane = region_call(region.spec, [lane_coords[k]],
                               [r[k] for r in rows], [r[k] for r in res],
                               out_info)
            if not all(torch.equal(a[k], b) for a, b in zip(got, lane)):
                raise AssertionError(f"order {order}: stacked lane {k} != "
                                     f"region_call on its operands")
            # one 8-row tile alone runs on a 16-CTA cluster, the stacked
            # launch on one CTA per tile: the summation order must not
            # depend on the cluster width
            tile = region_call(region.spec, [lane_coords[k][:8]],
                               [r[k] for r in rows], [r[k] for r in res],
                               out_info)
            if not all(torch.equal(a[k][:8], b) for a, b in zip(got, tile)):
                raise AssertionError(f"order {order}: lane {k}'s first tile "
                                     f"differs between cluster widths")
        t = device_ms(lambda: region_call_stacked(region.spec, *ops), 5)
        widths = (tuple(a.shape[2] for a in ops[0]),
                  tuple(r.shape[2] for r in rows),
                  tuple(tuple(r.shape[1:]) for r in res))
        prog = plan_region(region.spec, *widths, N, K, sm_count(0))
        one = lower(region.spec, *widths)      # 8-row tiles, one CTA each
        occ = common.load_library().rt_region_max_clusters(
            prog.cluster, prog.rows, prog.row_cluster, prog.smem_bytes)
        nbytes = 4 * (sum(a.numel() for a in (*ops[0], *rows, *res))
                      + sum(K * N * c for c, _ in out_info))
        bound, by = bound_ms(nbytes, K * prog.flops(N), FP32_FLOPS_PER_S)
        log(f"[multi] kernel order {order}: K={K} R={N} "
            f"{len(region.spec.steps)} steps, {prog.flops(1)} flops/row, "
            f"{sum(r[0].numel() * 4 for r in res)} resident bytes/lane, "
            f"{prog.describe()}, {occ} clusters at once "
            f"(cudaOccupancyMaxActiveClusters), weights read from L2 "
            f"{prog.l2_weight_bytes(N, K) / 1e9:.3f} GB/launch (8-row "
            f"one-CTA tiles: {one.l2_weight_bytes(N, K) / 1e9:.3f} GB): "
            f"{t} ms/launch on the device, bound {bound:.6f} ms by {by}; "
            f"lanes bit-equal to {K} region_call launches and their first "
            f"tiles to 8-row launches on 16-CTA clusters; scaled err "
            f"{max(s for _, s in stacked_errs[-len(got):]):.3e}")
        if order == 2:
            timed = (region.spec, ops)
    # a ragged stacked launch: the last tile of every lane 13 rows, the last
    # cluster's second CTA short
    spec, (_, rows, res, out_info) = timed
    rag = lane_coords[:, :N - 3].contiguous()
    got = region_call_stacked(spec, [rag], rows, res, out_info)
    want = region_call_stacked_plain(spec, [rag], rows, res, out_info)
    torch.cuda.synchronize()
    rag_errs = [scaled_err(a, b) for a, b in zip(got, want)]
    stacked_errs += rag_errs
    for k in range(K):
        lane = region_call(spec, [rag[k]], [r[k] for r in rows],
                           [r[k] for r in res], out_info)
        if not all(torch.equal(a[k], b) for a, b in zip(got, lane)):
            raise AssertionError(f"ragged stacked lane {k} != region_call")
    log(f"[multi] kernel order 2 ragged: K={K} R={N - 3}: scaled err "
        f"{max(e for _, e in rag_errs):.3e} against the plain version, "
        f"lanes bit-equal to {K} region_call launches")
    # one lane of 65,536 rows through region_call: the many-tile shape of
    # one chunk of 8,192 blocks
    big = coords[:65536].contiguous()
    lane0 = ([r[0] for r in rows], [r[0] for r in res])
    got = region_call(spec, [big], *lane0, out_info)
    want = region_call_plain(spec, [big], *lane0, out_info)
    torch.cuda.synchronize()
    big_errs = [scaled_err(a, b) for a, b in zip(got, want)]
    worst = max(e for _, e in big_errs)
    if worst > 1e-4:
        raise AssertionError(f"region R=65536 disagrees: {worst:.3e}")
    t = device_ms(lambda: region_call(spec, [big], *lane0, out_info), 5)
    prog = plan_region(spec, (2,), tuple(r.shape[2] for r in rows),
                       tuple(tuple(r.shape[1:]) for r in res), 65536, 1,
                       sm_count(0))
    log(f"[multi] region_call K=1 R=65536 order 2: {prog.describe()}: "
        f"{t} ms/launch on the device, scaled err {worst:.3e}")
    worst = max(s for _, s in stacked_errs)
    if worst > 1e-4:
        raise AssertionError(f"region_stacked disagrees: scaled err "
                             f"{worst:.3e}")
    spec, ops = timed
    stream, rows, res, out_info = ops
    elems = sum(t.numel() for t in (*stream, *rows, *res)) \
        + sum(K * N * c for c, _ in out_info)
    flops = K * lower(spec, tuple(t.shape[2] for t in stream),
                      tuple(t.shape[2] for t in rows),
                      tuple(tuple(t.shape[1:]) for t in res)).flops(N)
    record("region_stacked", "src/repro_torch/kernels/csrc/region.cu",
           "src/repro/kernels/region.py:290", stacked_errs,
           timing(lambda: region_call_stacked(spec, *ops), 10, 10),
           timing(lambda: region_call_stacked_plain(spec, *ops), 10, 10),
           4 * elems, flops)

    # -- 5b. the multi-INR paths, counted ------------------------------------
    common.reset_launches()

    def serve_check(m, order, x, label):
        """Serve x ([N, 2] broadcast or [K, N, 2]) through m; every lane
        against its float64 oracle."""
        m.apply_batched(x[..., :m.base.config.block, :])     # warm-up
        torch.cuda.synchronize()
        before = dict(common.LAUNCHES)
        t0 = time.perf_counter()
        outs = m.apply_batched(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v - before.get(k, 0)
                    for k, v in common.LAUNCHES.items()
                    if v - before.get(k, 0)}
        n = x.shape[-2]
        errs = []
        for k in range(K):
            xk = x if x.dim() == 2 else x[k]
            want = oracle(xk, order, weights[k])
            if len(outs) != len(want):
                raise AssertionError(f"{len(outs)} outputs, want "
                                     f"{len(want)}")
            for o, w in zip(outs, want):
                if tuple(o[k].shape) != tuple(w.shape) or \
                        not bool(torch.isfinite(o[k]).all()):
                    raise AssertionError(f"bad output {tuple(o.shape)}")
                errs.append(scaled_err(o[k], w)[1])
        # device busy share: profiler kernel time of the whole call over
        # the wall
        busy_ms = device_ms(lambda: m.apply_batched(x), 2)
        busy = (f"{busy_ms / (wall * 1e3):.3f}" if busy_ms is not None
                else "not measured")
        path = "stacked" if m.double_buffered else "per-lane"
        log(f"[multi] K={K} order {order} path={path} {label} "
            f"N={n} per lane: wall={wall * 1e3:.1f} ms "
            f"us_per_row={wall * 1e6 / (K * n):.4f} "
            f"device_busy_share={busy} max_scaled_err={max(errs):.3e} "
            f"launches={launches}")
        if max(errs) > 1e-4:
            raise AssertionError(f"multi order {order} {label}: scaled err "
                                 f"{max(errs):.3e} > 1e-4")
        need = (["region_stacked"] if m.double_buffered
                else ["region", "fused_chain"])
        if not all(launches.get(k) for k in need) or (
                m.double_buffered and set(launches) != {"region_stacked"}):
            raise AssertionError(f"multi order {order} {label} ({path}) "
                                 f"launched {launches}, needs {need}")
        return outs

    for order in (1, 2):
        m = artifact(order)
        if not m.double_buffered:
            raise AssertionError(f"order {order}: stacked path not taken")
        serve_check(m, order, shared, "broadcast")
        serve_check(m, order, lane_coords, "per-lane")
        serve_check(m, order, lane_coords[:, :ragged], "per-lane ragged")
    m3 = artifact(3)
    if m3.double_buffered:
        raise AssertionError("order 3: the plan has non-region units, the "
                             "stacked path must not be taken")
    x3 = lane_coords[:, :N_LANE3]
    per_lane = serve_check(m3, 3, x3, "per-lane")
    # one chunk: each unit once per lane, at the chunk's rows
    cb, block = m3.base.config.chunk_blocks, m3.base.config.block
    xb = x3[:, :cb * block].reshape(K, cb, block, 2).movedim(1, 0)
    per_chunk = launched_by(common.LAUNCHES, lambda: m3.apply_chunk(xb))
    want = collections.Counter({k: K * v for k, v in
                                plan_launches(m3.base).items()})
    log(f"[multi] per-lane order 3: one {cb * block}-row chunk of K={K} "
        f"lanes launched {dict(per_chunk)} (the plan's units x K: "
        f"{dict(want)})")
    if per_chunk != want:
        raise AssertionError(f"per-lane chunk launched {dict(per_chunk)}, "
                             f"want {dict(want)}")

    # the engine: one signature group of 3 INRs (one named twice), a
    # zero-row request, then a K = 1 group with a non-base weight id
    store_dir = ROOT / "build" / "chip_smoke_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    engine = ServingEngine(store_dir)
    cgs = [compile_gradient(fns[k], 2, coords[:cfg.batch], config=fused_cfg,
                            device="cuda") for k in range(3)]
    for k in range(3):
        engine.register(f"inr{k}", cgs[k])
    q = lane_coords[0, :1000]
    reqs = [("inr1", q[:300]), ("inr0", q), ("inr2", q[:0]),
            ("inr1", q[300:777]), ("inr2", q[:333])]
    t0 = time.perf_counter()
    results = engine.serve(reqs) + engine.serve([("inr2", q[:101])])
    wall = time.perf_counter() - t0
    reqs.append(("inr2", q[:101]))
    for (inr_id, c), out in zip(reqs, results):
        want = cgs[int(inr_id[3:])].apply_batched(c)
        for a, b in zip(want, out):
            err = scaled_err(b, a)[1] if a.numel() else 0.0
            if tuple(a.shape) != tuple(b.shape) or err > 1e-5:
                raise AssertionError(f"engine {inr_id}: {tuple(b.shape)} "
                                     f"vs {tuple(a.shape)}, err {err:.3e}")
    st = engine.stats
    want_st = {"groups": 2, "multi_groups": 1, "requests": 6,
               "rows": 300 + 1000 + 0 + 477 + 333 + 101,
               "padded_rows": 3 * 1000 - (300 + 477 + 1000 + 333) + 3}
    got_st = {k: st[k] for k in want_st}
    if got_st != want_st:
        raise AssertionError(f"engine stats {got_st} != {want_st}")
    log(f"[multi] engine order 2: {len(reqs)} requests, 2 serve calls in "
        f"{wall * 1e3:.1f} ms; stats {got_st}; outputs match per-INR "
        f"apply_batched")
    # a fresh engine restores from the store by signature alone
    sig = cgs[0].signature
    traces = trace.TRACE_CALLS
    fresh = ServingEngine(ArtifactStore(store_dir))
    for k in range(3):
        fresh.register(f"inr{k}", signature=sig, weight_id=f"inr{k}")
    again = fresh.serve(reqs[:-1]) + fresh.serve(reqs[-1:])
    if trace.TRACE_CALLS != traces:
        raise AssertionError("the store restore called the tracer")
    for a, b in zip(results, again):
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise AssertionError("restored engine outputs differ")
    log(f"[multi] store: fresh engine restored {sig} with 0 tracer calls, "
        f"{fresh.stats['restores']} restore, outputs torch.equal")
    shutil.rmtree(store_dir, ignore_errors=True)
    launches = dict(common.LAUNCHES)
    log(f"[launches] phase 5 (multi-INR serving): {launches}")

    # the per-lane path as it served before chunks (8-row blocks, lane by
    # lane) on the same rows: bit for bit, µs per row over K·N, busy share
    block_fn = m3.base.resident_block_fn()

    def per_block(x):
        lanes = []
        for k, res in enumerate(m3._lane_res):
            outs = [block_fn(res, x[k, i:i + block])
                    for i in range(0, x.shape[1], block)]
            lanes.append([torch.cat(col) for col in zip(*outs)])
        return tuple(torch.stack(col) for col in zip(*lanes))

    walk = per_block(x3)
    if not all(torch.equal(a, b) for a, b in zip(per_lane, walk)):
        raise AssertionError("per-lane chunks differ from the per-block "
                             "walk")
    for label, fn in [("chunk-wide", lambda: m3.apply_batched(x3)),
                      ("per-block walk", lambda: per_block(x3))]:
        log(f"[multi] per-lane order 3 {label}, K={K} x N={N_LANE3}: "
            f"{reading(fn, K * N_LANE3)} (over K·N rows)")
    log("[multi] per-lane order 3: chunk-wide lanes torch.equal to the "
        "per-block walk")
    return launches, weights


def fit_phase(log, torch, dev, cfg, f, params, coords, fused_cfg, tiled_cfg,
              walk_block, scaled_err, device_ms, timing, record, reading):
    """Phase 6; returns the launches made while it drove the fit path (the
    kernel checks before it are not counted)."""
    import dataclasses

    import numpy as np

    from repro_torch.core.pipeline import compile_gradient
    from repro_torch.fit import (GradMSE, LaplacianMSE, compile_fit, fit,
                                 fit_many)
    from repro_torch.fit.compile import _fit_units
    from repro_torch.inr.siren import siren_fn, siren_init
    from repro_torch.kernels import common
    from repro_torch.kernels.region import (RegionKernelSpec,
                                           plan_region_bwd, region_bwd_call,
                                           region_bwd_plain, sm_count)
    from repro_torch.serve import ArtifactStore, ServingEngine

    gen = torch.Generator().manual_seed(SEED + 6)
    N = coords.shape[0]

    # -- 6a. region_bwd against its plain version ----------------------------
    def regions(order, conf):
        """(region, (stream, rows, residents, out_info)) of every fused
        region of one 8-row block, as the fit path hands them over."""
        cg = compile_gradient(f, order, coords[:cfg.batch], config=conf,
                              device="cuda")
        out = []
        walk_block(cg, coords[1000:1000 + cg.config.block],
                   lambda u, ops: out.append((u, ops)))
        return out

    bwd_errs, timed = [], None
    for order, conf, label in [(1, fused_cfg, "fused"), (2, fused_cfg, "fused"),
                               (1, tiled_cfg, f"bn={tiled_cfg.bn}")]:
        for region, (stream, rows, res, out_info) in regions(order, conf):
            spec = region.spec
            for R in (8, 1000):
                st = stream if R == 8 else [
                    (torch.rand(R, a.shape[1], generator=gen) * 2 - 1).to(dev)
                    for a in stream]
                cots = [torch.randn(R, c, generator=gen).to(dev)
                        for c, _ in out_info]
                got = region_bwd_call(spec, st, rows, res, cots)
                want = region_bwd_plain(spec, st, rows, res, cots)
                torch.cuda.synchronize()
                errs = [scaled_err(a, b) for gs, ws in zip(got, want)
                        for a, b in zip(gs, ws)]
                bwd_errs += errs
                t = device_ms(lambda: region_bwd_call(spec, st, rows, res,
                                                      cots), 10)
                prog = plan_region_bwd(spec, tuple(a.shape[1] for a in st),
                                       tuple(a.shape[1] for a in rows),
                                       tuple(tuple(a.shape) for a in res),
                                       common.cdiv(R, 8), sm_count(0))
                log(f"[fit] region_bwd order {order} {label}: "
                    f"{len(spec.steps)} steps, {len(spec.tile_groups)} tile "
                    f"groups, R={R}: {t} ms per call on the device, C="
                    f"{prog.cluster}, {4 * prog.ws_floats} workspace "
                    f"bytes/CTA ({'shared' if prog.in_smem else 'global'}), "
                    f"scaled err {max(s for _, s in errs):.3e}")
                if order == 2 and R == 8 and timed is None:
                    timed = (spec, (st, rows, res, cots), prog)
    worst = max(s for _, s in bwd_errs)
    if worst > 1e-4:
        raise AssertionError(f"region_bwd disagrees: scaled err {worst:.3e}")
    # the cost of one backward step: 1 and 16 chained mm steps
    # ([8,256]@[256,256] + bias, sin(1 .)) and cos-mul-scale chain steps
    x, e1 = [(torch.rand(8, 256, generator=gen) * 2 - 1).to(dev)
             for _ in range(2)]
    w = ((torch.rand(256, 256, generator=gen) * 2 - 1) / 16.0).to(dev)
    b = (torch.rand(256, generator=gen) * 2 - 1).to(dev)
    cot = [torch.randn(8, 256, generator=gen).to(dev)]
    chain = (("cos", None), ("mul", None), ("scale", 30.0))
    for label, steps, stream, res in [
            ("mm", tuple(("mm", i + 1, i, 100, 101, 1.0, True)
                         for i in range(16)), [x], [w, b]),
            ("chain", tuple(("chain", i + 1, i, chain, (102,))
                            for i in range(16)), [x, e1], [])]:
        one = RegionKernelSpec(steps=steps[:1],
                               stream_inputs=(0, 102)[:len(stream)],
                               residents=(100, 101)[:len(res)], outputs=(1,))
        many = dataclasses.replace(one, steps=steps, outputs=(16,))
        t1 = device_ms(lambda: region_bwd_call(one, stream, [], res, cot), 10)
        t16 = device_ms(lambda: region_bwd_call(many, stream, [], res, cot),
                        10)
        log(f"[fit] region_bwd one {label} step [8,256]: {t1} ms/launch; "
            f"16 steps: {t16} ms/launch")
    spec, ops, prog = timed
    st, rows, res, cots = ops
    elems = 2 * sum(t.numel() for t in (*st, *rows, *res)) \
        + sum(c.numel() for c in cots)
    record("region_bwd", "src/repro_torch/kernels/csrc/region_bwd.cu",
           "src/repro/kernels/region.py:393", bwd_errs,
           timing(lambda: region_bwd_call(spec, *ops), 20, 50),
           timing(lambda: region_bwd_plain(spec, *ops), 20, 50),
           4 * elems, prog.flops(8))

    # -- 6b. the fit path, counted -------------------------------------------
    def oracle_vg(loss, order, x, target, weights):
        """Mean loss and its gradient per leaf, in float64 over the whole
        grid: nested torch.autograd through the SIREN, no streaming."""
        leaves = [[p[k].double().requires_grad_(True) for k in sorted(p)]
                  for p in weights]                      # (b, w) per layer
        xx = x.double().clone().requires_grad_(True)
        y = xx
        for li, (b, w) in enumerate(leaves):
            y = y @ w + b
            if li < len(leaves) - 1:
                y = torch.sin(cfg.w0 * y)
        outs = [y]
        level = [y[:, c].sum() for c in range(y.shape[1])]
        for _ in range(order):
            grads = [torch.autograd.grad(s, xx, create_graph=True)[0]
                     for s in level]
            outs += grads
            level = [gr[:, j].sum() for gr in grads
                     for j in range(xx.shape[1])]
        val = torch.mean(loss.row_loss(outs, target.double(), y.shape[1],
                                       xx.shape[1]))
        flat = [t for pair in leaves for t in pair]
        grads = torch.autograd.grad(val, flat, allow_unused=True)
        return val.detach(), [torch.zeros_like(t) if gr is None else gr
                              for gr, t in zip(grads, flat)]

    common.reset_launches()
    rng = np.random.default_rng(SEED)
    fitted = []
    for order, loss in [(1, GradMSE()), (2, LaplacianMSE())]:
        target = torch.from_numpy(rng.standard_normal(
            (N, loss.target_cols(cfg.out_features, cfg.in_features))
        ).astype(np.float32)).to(dev)
        cf = compile_fit(f, loss, order, coords[:cfg.batch], params=params,
                         config=fused_cfg, device="cuda")
        cf.value_and_grad(params, coords[:cf.config.block],
                          target[:cf.config.block])             # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val, grads = cf.value_and_grad(params, coords, target)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want_val, want = oracle_vg(loss, order, coords, target, params)
        got = [p[k] for p in grads for k in sorted(p)]
        errs = [scaled_err(a, b)[1] for a, b in zip(got, want)]
        val_err = scaled_err(val.reshape(1), want_val.reshape(1))[1]
        # one chunk: each region unit once forward and once backward
        rows = cf.config.chunk_blocks * cf.config.block
        per_chunk = launched_by(common.LAUNCHES, lambda: cf.value_and_grad(
            params, coords[:rows], target[:rows]))
        regions = sum(k == "region" for k, _ in _fit_units(cf.cg))
        log(f"[fit] value_and_grad order {order} {type(loss).__name__}: "
            f"N={N} {cf.describe()} loss={float(val):.6f} "
            f"(scaled err {val_err:.3e}) leaf grad scaled errs "
            f"{[f'{e:.2e}' for e in errs]} wall={wall * 1e3:.1f} ms "
            f"us_per_row={wall * 1e6 / N:.3f}; one {rows}-row chunk "
            f"launched {dict(per_chunk)}")
        if max(errs + [val_err]) > 1e-4:
            raise AssertionError(f"fit order {order}: scaled err "
                                 f"{max(errs + [val_err]):.3e} > 1e-4")
        if not (regions and per_chunk["region"] == regions
                and per_chunk["region_bwd"] == regions):
            raise AssertionError(f"fit order {order}: one chunk launched "
                                 f"{dict(per_chunk)} for {regions} regions")
        fitted.append((order, loss, target))

    # fit -> store -> a fresh engine serves the fitted weights
    store_dir = ROOT / "build" / "chip_smoke_fit_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    store = ArtifactStore(store_dir)
    loss = LaplacianMSE()
    target = torch.from_numpy(rng.standard_normal((N, 1)).astype(
        np.float32)).to(dev)
    cf = compile_fit(f, loss, 2, coords[:cfg.batch], params=params,
                     config=fused_cfg, store=store, device="cuda")
    t0 = time.perf_counter()
    r = fit(cf, coords, target, steps=3, batch_rows=1024, key=SEED,
            store=store, inr_id="fitted")
    wall = time.perf_counter() - t0
    if not all(np.isfinite(r.losses)):
        raise AssertionError(f"fit losses {r.losses}")
    engine = ServingEngine(store_dir)
    engine.register("fitted", signature=cf.signature, weight_id="fitted")
    (served,) = engine.serve([("fitted", coords)])
    fitted_cg = compile_gradient(siren_fn(cfg, r.params), 2,
                                 coords[:cfg.batch], config=fused_cfg,
                                 device="cuda")
    want = fitted_cg.apply_batched(coords)
    serve_err = max(scaled_err(a, b)[1] for a, b in zip(served, want))
    log(f"[fit] fit order 2 LaplacianMSE: 3 steps of 1,024 rows in "
        f"{wall * 1e3:.1f} ms, losses {r.losses}; served from a fresh "
        f"engine after put_weights: scaled err {serve_err:.3e} against "
        f"compile_gradient of the fitted weights")
    if serve_err > 1e-4:
        raise AssertionError(f"fitted weights serve with err {serve_err:.3e}")
    shutil.rmtree(store_dir, ignore_errors=True)

    # fit_many: K = 2 lanes, each lane equal to fit with its weights
    lanes = [params, siren_init(cfg, torch.Generator().manual_seed(SEED + 1),
                                device=dev)]
    targets = [torch.from_numpy(rng.standard_normal((N, 2)).astype(
        np.float32)).to(dev) for _ in lanes]
    cf = compile_fit(f, GradMSE(), 1, coords[:cfg.batch], params=params,
                     config=fused_cfg, device="cuda")
    t0 = time.perf_counter()
    many = fit_many(cf, lanes, coords, targets, steps=2, batch_rows=1024,
                    key=SEED)
    wall = time.perf_counter() - t0
    for k, (w, t) in enumerate(zip(lanes, targets)):
        solo = fit(cf, coords, t, steps=2, params=w, batch_rows=1024,
                   key=SEED)
        same = solo.losses == many[k].losses and all(
            torch.equal(a[key], b[key]) for a, b in zip(solo.params,
                                                        many[k].params)
            for key in a)
        if not same:
            raise AssertionError(f"fit_many lane {k} differs from fit")
    log(f"[fit] fit_many K=2 order 1: 2 steps of 1,024 rows per lane in "
        f"{wall * 1e3:.1f} ms; each lane torch.equal to fit")
    launches = dict(common.LAUNCHES)
    log(f"[launches] phase 6 (streamed fitting): {launches}")
    if not (launches.get("region") and launches.get("region_bwd")):
        raise AssertionError(f"the fit path launched {launches}, needs "
                             f"region and region_bwd")

    # µs per fitted row, chunk-wide beside per-block (chunk_blocks = 1:
    # one autograd pass, region and region_bwd per 8-row block, as the
    # port fitted before chunks), on the same rows
    for order, loss, target in fitted:
        for label, conf in [("chunk-wide", fused_cfg),
                            ("per-block", dataclasses.replace(
                                fused_cfg, chunk_blocks=1))]:
            cf = compile_fit(f, loss, order, coords[:cfg.batch],
                             params=params, config=conf, device="cuda")
            read = reading(lambda: cf.value_and_grad(params, coords, target),
                           N)
            log(f"[fit] value_and_grad order {order} {label} on {N} rows: "
                f"{read}")
    return launches



def attention_flops(B, Sq, Sk, H, D, *, causal, window):
    """Operations of one attention call on these masks
    (``kernels/flash_attention.py::attention_flops``, the custom op's flop
    formula): 4 D for each visible (query, key) pair, for every batch and
    q head."""
    from repro_torch.kernels.flash_attention import attention_flops as count
    return count(B, Sq, Sk, H, D, causal=causal, window=window)


def kernel_classes(times):
    """Device ms by class of kernel name: the port's attention kernels
    (fa_tc_kernel for bf16, fa_fwd_kernel for fp32; the backward's fa_bwd_*:
    fa_bwd_prep_kernel, fa_bwd_dq_tc_kernel and fa_bwd_dkv_tc_kernel for
    bf16, fa_bwd_dq_kernel and fa_bwd_dkv_kernel for fp32), its scan kernels
    (ssd_scan_kernel, ssd_scan_bwd_kernel), library GEMMs (cuBLAS
    names them gemm*, gemv* or nvjet*), and everything else (norms, rope,
    casts, copies)."""
    out = {"flash_attention": 0.0, "flash_attention_bwd": 0.0,
           "ssd_scan": 0.0, "ssd_scan_bwd": 0.0, "gemm": 0.0, "other": 0.0}
    for key, ms in times.items():
        low = key.lower()
        if "fa_tc_kernel" in key or "fa_fwd_kernel" in key:
            out["flash_attention"] += ms
        elif "fa_bwd_" in key:
            out["flash_attention_bwd"] += ms
        elif "ssd_scan_bwd_kernel" in key:
            out["ssd_scan_bwd"] += ms
        elif "ssd_scan_kernel" in key:
            out["ssd_scan"] += ms
        elif any(w in low for w in ("gemm", "gemv", "nvjet", "cutlass",
                                    "xmma", "sm90_")):
            out["gemm"] += ms
        else:
            out["other"] += ms
    total = sum(out.values())
    return {k: f"{v:.3f} ms ({v / total:.3f})" for k, v in out.items()}


def lm_phase(log, torch, dev, scaled_err, device_ms, timing, record):
    """Phase 7; returns the launches of the kernel library's entry point
    (``kernels/ops.py``) and of LM serving, each counted from 0 just before
    it (the kernel checks before them are not counted)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import common, ops
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     flash_attention,
                                                     flash_attention_plain,
                                                     tensor_map_encode_ns)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    from repro_torch.launch.steps import (HParams, build_prefill_step,
                                          build_serve_step, serving_params)
    from repro_torch.models import zoo
    from repro_torch.models.template import init_params, tree_leaves

    t_phase = time.perf_counter()
    # XLA accumulates bf16 products in fp32: so must every reference here
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    # -- 7a. flash_attention at the path's shapes ---------------------------
    fa_errs, timed = [], None
    for label, (B, Sq, H, KH, D), Sk, dt, window in ATTN_CASES:
        dt = getattr(torch, dt)
        q = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dt)
        k = torch.randn((B, Sk, KH, D), generator=gen, device=dev).to(dt)
        v = torch.randn((B, Sk, KH, D), generator=gen, device=dev).to(dt)
        got = flash_attention(q, k, v, causal=True, window=window)
        plain = flash_attention_plain(q, k, v, causal=True, window=window)
        exact = attention64(torch, q, k, v, True, window)[0]
        torch.cuda.synchronize()
        if got.dtype != dt or tuple(got.shape) != (B, Sq, H, D) or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {label}: bad output "
                                 f"{got.dtype} {tuple(got.shape)}")
        k_err, k_scaled = scaled_err(got, exact)
        p_err, p_scaled = scaled_err(plain, exact)
        vs_plain = scaled_err(got, plain)
        fa_errs.append(vs_plain)
        if dt == torch.float32:
            ok = k_scaled <= 1e-5 and vs_plain[1] <= 1e-5
            rule = "fp32: <= 1e-5 of max|oracle|"
        else:
            ok = k_err <= 2 * p_err
            rule = "bf16: at most 2x the plain version's error"
        t = device_ms(lambda: flash_attention(q, k, v, causal=True,
                                              window=window), 5)
        log(f"[lm] flash_attention {label}: q {tuple(q.shape)} k "
            f"{tuple(k.shape)} {str(dt)[6:]} window {window}: err against "
            f"float64 {k_err:.3e} (scaled {k_scaled:.3e}), plain "
            f"{p_err:.3e} (scaled {p_scaled:.3e}), against plain "
            f"{vs_plain[0]:.3e}; {t} ms/launch on the device; {rule}")
        if not ok:
            raise AssertionError(f"flash_attention {label} disagrees ({rule})")
        if timed is None:
            timed = (q, k, v, window)
        del got, plain, exact
    q, k, v, window = timed
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    log(f"[lm] flash_attention bf16: host time to encode the 3 TMA tensor "
        f"maps of one launch {tensor_map_encode_ns(q, k, v) / 1e3:.3f} us "
        f"(mean of 1,000)")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = timing(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 10, 20)[0]
    record("flash_attention",
           "src/repro_torch/kernels/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention.py:68", fa_errs,
           timing(lambda: flash_attention(q, k, v, causal=True), 10, 20),
           timing(lambda: flash_attention_plain(q, k, v, causal=True), 3, 3),
           q.element_size() * (2 * q.numel() + k.numel() + v.numel()),
           attention_flops(B, Sq, Sk, H, D, causal=True, window=0),
           library_ms=lib_ms, peak_flops_per_s=BF16_FLOPS_PER_S)
    del q, k, v, qt, kt, vt, timed
    # the fp32 route (csrc/flash_attention.cu, split TF32 on the tensor
    # cores: mma.sync, HMMA in its SASS, K / V tiles by cp.async, LDGSTS)
    # against float64 at every head dim: at most SPLIT_OVER_SIMT times the
    # SIMT kernels' error on the same inputs
    f32_sass = {fn: c for fn, c in SASS_COUNTS.items()
                if "fa_fwd_kernel" in fn}
    if SASS_COUNTS and (len(f32_sass) != len(HEAD_DIMS) or not all(
            c["HMMA"] > 0 and c["LDGSTS"] > 0 for c in f32_sass.values())):
        raise AssertionError(f"flash_attention fp32 kernels' SASS: "
                             f"{f32_sass}")
    errs32 = []
    for i, (label, shape, sk, win) in enumerate(FP32_FWD_CASES):
        q, k, v = fp32_case(torch, dev, i, shape, sk)
        got = flash_attention(q, k, v, causal=True, window=win)
        plain = flash_attention_plain(q, k, v, causal=True, window=win)
        exact = attention64(torch, q, k, v, True, win)[0]
        torch.cuda.synchronize()
        k_err, k_scaled = scaled_err(got, exact)
        p_err = scaled_err(plain, exact)[0]
        vs_plain = scaled_err(got, plain)
        errs32.append(vs_plain)
        simt = SIMT_FP32_ERRS["forward"][label]["out"]
        ok = bool(torch.isfinite(got).all()) and k_scaled <= 1e-5 and \
            vs_plain[1] <= 1e-5 and k_err <= SPLIT_OVER_SIMT * simt
        log(f"[lm] flash_attention fp32 {label}: q {tuple(q.shape)} k "
            f"{tuple(k.shape)} window {win}: err against float64 "
            f"{k_err:.4e} (scaled {k_scaled:.3e}), {k_err / simt:.3f}x the "
            f"SIMT kernel's {simt:.4e}; plain {p_err:.4e}; against plain "
            f"{vs_plain[0]:.4e}; rule: <= 1e-5 of max|oracle| and <= "
            f"{SPLIT_OVER_SIMT}x the SIMT kernel's error")
        if not ok:
            raise AssertionError(f"flash_attention fp32 {label} disagrees")
        del q, k, v, got, plain, exact
    # ... and at the prefill shape, timed beside SDPA's fp32 forward
    gen32 = torch.Generator(device=dev).manual_seed(SEED)
    qf = torch.randn((B, Sq, H, D), generator=gen32, device=dev)
    kf, vf = (torch.randn((B, Sk, KH, D), generator=gen32, device=dev)
              for _ in range(2))
    ok = scaled_err(flash_attention(qf, kf, vf, causal=True),
                    flash_attention_plain(qf, kf, vf, causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (qf, kf, vf))
    record("flash_attention", "src/repro_torch/kernels/csrc/"
           "flash_attention.cu", f"q {tuple(qf.shape)} k {tuple(kf.shape)} "
           f"float32 causal", [ok] + errs32,
           timing(lambda: flash_attention(qf, kf, vf, causal=True), 3, 3),
           timing(lambda: flash_attention_plain(qf, kf, vf, causal=True), 2,
                  2),
           4 * (2 * qf.numel() + kf.numel() + vf.numel()),
           3 * attention_flops(B, Sq, Sk, H, D, causal=True, window=0),
           library_ms=timing(
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True), 5, 5)[0],
           peak_flops_per_s=TF32_FLOPS_PER_S, route="float32")
    if ok[1] > 1e-5:
        raise AssertionError(f"flash_attention fp32 at the prefill shape: "
                             f"scaled err against plain {ok[1]:.3e}")
    del qf, kf, vf, qt, kt, vt
    torch.cuda.empty_cache()

    # -- 7b. ssd_scan ---------------------------------------------------------
    scan_errs = []
    inputs = []
    for shape in SCAN_SHAPES:
        st = torch.randn(shape, generator=gen, device=dev)
        dec = 1.0 - torch.rand(shape[:2], generator=gen, device=dev)  # (0, 1]
        got, want = ssd_scan(st, dec), ssd_scan_plain(st, dec)
        torch.cuda.synchronize()
        scan_errs.append(scaled_err(got, want))
        b_ms, b_by = bound_ms(4 * (2 * st.numel() + dec.numel()),
                              2 * st.numel(), FP32_FLOPS_PER_S)
        log(f"[lm] ssd_scan {shape}: scaled err {scan_errs[-1][1]:.3e}, "
            f"torch.equal {torch.equal(got, want)}; "
            f"{device_ms(lambda: ssd_scan(st, dec))} ms/launch on the "
            f"device, bound {b_ms:.6f} ms by {b_by}")
        if scan_errs[-1][1] > 1e-6:
            raise AssertionError(f"ssd_scan {shape} disagrees")
        inputs.append((st, dec))
    st, dec = inputs[0]
    record("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "src/repro/kernels/ssd_scan.py:36", scan_errs,
           timing(lambda: ssd_scan(st, dec)), timing(lambda: ssd_scan_plain(
               st, dec), 10, 20),
           4 * (2 * st.numel() + dec.numel()), 2 * st.numel())

    # -- 7c. the kernel library's entry point, counted -----------------------
    common.reset_launches()
    for st, dec in inputs:
        if not torch.equal(ops.ssd_scan(st, dec), ops.ref.ssd_scan(st, dec)):
            raise AssertionError("ops.ssd_scan != ops.ref.ssd_scan")
    launches_ops = dict(common.LAUNCHES)
    log(f"[launches] phase 7 (kernels/ops.py): {launches_ops}")
    if launches_ops.get("ssd_scan") != len(inputs):
        raise AssertionError(f"ops.ssd_scan launched {launches_ops}")
    del inputs, st, dec
    torch.cuda.empty_cache()

    # -- 7d. LM serving, counted ----------------------------------------------
    common.reset_launches()
    base = get_config(LM_ARCH)
    rng = np.random.default_rng(SEED)

    def fa_launches():
        return common.LAUNCHES["flash_attention"]

    def pad(cache, n):
        return {"layers": {k: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, n))
                           for k, a in cache["layers"].items()}}

    # fp32, full width, 4 layers: the kernel path against the "flash" path
    cfg = dataclasses.replace(base, n_layers=LM_F32_LAYERS,
                              compute_dtype="float32")
    S = LM_F32_SEQ
    params = init_params(zoo.model_template(cfg), SEED, device=dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (2, S + 1))).to(dev)
    batch = {"tokens": toks[:, :S]}
    logits_k, cache_k = build_prefill_step(cfg, HParams("pallas"))(params,
                                                                   batch)
    logits_f, cache_f = build_prefill_step(cfg, HParams("flash"))(params,
                                                                  batch)
    errs = [scaled_err(logits_k, logits_f)[1]] + [
        scaled_err(cache_k["layers"][n], cache_f["layers"][n])[1]
        for n in "kv"]
    with torch.no_grad():
        full, _ = zoo.forward(cfg, params, {"tokens": toks},
                              attn_impl="pallas")
    tok, _ = build_serve_step(cfg, HParams())(params, pad(cache_k, 8),
                                              toks[:, S], S)
    last = full[:, -1].float()
    top = last.topk(2, dim=-1).values
    lead = (top[:, 0] - top[:, 1]) / last.abs().max()
    rows = lead > 1e-3
    match = bool((tok.long() == last.argmax(-1))[rows].all())
    log(f"[lm] {cfg.name} fp32, {cfg.n_layers} layers, B=2 S={S}: kernel "
        f"prefill against flash prefill: logits scaled err {errs[0]:.3e}, "
        f"cache k "
        f"{errs[1]:.3e} v {errs[2]:.3e}; decode at pos {S}: token "
        f"{tok.tolist()} vs forward argmax {last.argmax(-1).tolist()}, "
        f"{int(rows.sum())} of 2 rows compared (lead > 1e-3 scaled)")
    if max(errs) > 1e-4 or not match:
        raise AssertionError(f"{cfg.name} fp32: the kernel path disagrees")
    del params, logits_k, logits_f, cache_k, cache_f, full, last
    torch.cuda.empty_cache()

    # bf16, full width and depth: the served path
    cfg = base
    S, STEPS = LM_SEQ, LM_STEPS
    hp = HParams()
    params = serving_params(cfg, hp, init_params(zoo.model_template(cfg),
                                                 SEED, device=dev))
    torch.cuda.empty_cache()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, S))).to(dev)}
    prefill = build_prefill_step(cfg, hp)
    walls = []
    for _ in range(2):                          # the first call warms up
        before = fa_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if fa_launches() - before != cfg.n_layers:
            raise AssertionError(f"bf16 prefill launched flash_attention "
                                 f"{fa_launches() - before} times, want "
                                 f"{cfg.n_layers}")
    pre_kernels = device_ms(lambda: prefill(params, batch), 1, by_kernel=True)
    pre_dev = sum(pre_kernels.values()) if pre_kernels else None
    shape = (cfg.n_layers, 2, S, cfg.n_kv_heads, cfg.head_dim)
    if not bool(torch.isfinite(logits).all()) or any(
            tuple(cache["layers"][n].shape) != shape for n in "kv"):
        raise AssertionError("bf16 prefill: non-finite logits or a cache "
                             "of the wrong shape")
    serve = build_serve_step(cfg, hp)
    dcache = pad(cache, STEPS)
    tok = logits.argmax(-1)
    before = fa_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = []
    for i in range(STEPS):
        tok, dcache = serve(params, dcache, tok, S + i)
        out.append(tok)
    torch.cuda.synchronize()
    dec_wall = time.perf_counter() - t0
    if fa_launches() != before:
        raise AssertionError("decode launched flash_attention")
    toks_out = torch.stack(out, 1)
    if not bool(((toks_out >= 0) & (toks_out < cfg.vocab_size)).all()):
        raise AssertionError(f"decode tokens out of range: {toks_out}")
    # one more step, rewriting the last position, under the profiler
    step_kernels = device_ms(lambda: serve(params, dcache, tok,
                                           S + STEPS - 1), 1, by_kernel=True)
    step_dev = sum(step_kernels.values()) if step_kernels else None
    logits_f, cache_f = build_prefill_step(cfg, HParams("flash"))(params,
                                                                  batch)
    diff = scaled_err(logits, logits_f)[1]
    if not bool(torch.isfinite(logits_f).all()) or any(
            tuple(cache_f["layers"][n].shape) != shape for n in "kv"):
        raise AssertionError("bf16 flash prefill: bad logits or cache")
    pre_ms, dec_ms = walls[-1] * 1e3, dec_wall * 1e3 / STEPS

    def busy(dev_ms, wall_ms):
        return f"{dev_ms / wall_ms:.3f}" if dev_ms else "not measured"
    log(f"[lm] {cfg.name} bf16, {cfg.n_layers} layers, B=2 S={S}, "
        f"{nbytes / 1e9:.2f} GB of weights: prefill {pre_ms:.1f} ms "
        f"({2 * S / walls[-1]:.0f} "
        f"tokens/s; first call {walls[0] * 1e3:.1f} ms), device "
        f"{pre_dev} ms (busy {busy(pre_dev, pre_ms)}); decode {STEPS} steps "
        f"{dec_ms:.2f} ms/step, device {step_dev} ms/step (busy "
        f"{busy(step_dev, dec_ms)}); "
        f"flash_attention launches {cfg.n_layers} per prefill, 0 in "
        f"decode; kernel against flash prefill: last logits scaled diff "
        f"{diff:.3e}; tokens {toks_out[:, :8].tolist()}")
    for label, times in (("prefill", pre_kernels), ("decode step",
                                                    step_kernels)):
        if times:
            top = sorted(times.items(), key=lambda kv: -kv[1])[:4]
            log(f"[lm] device time of one {label} by kernel class: "
                f"{kernel_classes(times)}; top kernels "
                f"{[(k[:60], round(v, 3)) for k, v in top]}")
    del params, cache, dcache, logits, logits_f, cache_f
    torch.cuda.empty_cache()
    launches_lm = dict(common.LAUNCHES)
    log(f"[launches] phase 7 (LM serving): {launches_lm}")
    log(f"[lm] phase 7 took {time.perf_counter() - t_phase:.1f} s")
    if not launches_lm.get("flash_attention"):
        raise AssertionError(f"LM serving launched {launches_lm}")
    return launches_ops, launches_lm


def lm_families_phase(log, torch, dev, scaled_err, device_ms):
    """Phase 7e, the SSM, MoE and hybrid families; returns the launches of
    their bf16 serving, counted from 0 just before it (the checks before
    it are not counted)."""
    import dataclasses
    import functools
    import math

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.launch.steps import (HParams, build_prefill_step,
                                          build_serve_step)
    from repro_torch.models import layers, zoo
    from repro_torch.models.template import (count_template_params,
                                             init_params, tree_leaves,
                                             tree_map)

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    rng = np.random.default_rng(SEED + 11)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in flat(sub, f"{prefix}{key}/").items()}
        return {prefix[:-1]: tree}

    def pad(cache, n):
        """The attention caches (k, v leaves) padded by n positions."""
        return {g: {k: (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, n))
                        if k in ("k", "v") else a) for k, a in sub.items()}
                for g, sub in cache.items()}

    def mixers(cfg):
        """(self-attention layers, mamba layers) of a config; a VLM's
        cross layers run the blockwise plain attention."""
        if cfg.family == "ssm":
            return 0, cfg.n_layers
        if cfg.family == "hybrid":
            n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
            return n_attn, cfg.n_layers - n_attn
        if cfg.family == "vlm":
            return cfg.n_layers - cfg.n_layers // cfg.cross_attn_period, 0
        return cfg.n_layers, 0

    def images(cfg, B, gen_dtype):
        """Seeded image embeddings [B, n_image_tokens, d_model]."""
        return torch.randn((B, cfg.n_image_tokens, cfg.d_model),
                           generator=gen, device=dev).to(gen_dtype)

    # -- 7e-1. a full-width mamba layer's ssd_chunked against float64 -------
    cfg = get_config("mamba2-2.7b")
    (b, s), h, p, n = FAM_SSD, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xh = torch.randn((b, s, h, p), generator=gen, device=dev)
    # dt log-uniform in [1e-3, 1e-2] and A from the ssm_a rule: a chunk's
    # decay exp(128 dt a) spans e^-20 to e^-0.13, so the inter-chunk term
    # carries weight
    dt = torch.exp(math.log(1e-3) + math.log(10.0) * torch.rand(
        (b, s, h), generator=gen, device=dev))
    a_log = torch.log(1.0 + 15.0 * torch.rand((h,), generator=gen,
                                              device=dev))
    Bm = torch.randn((b, s, n), generator=gen, device=dev)
    Cm = torch.randn((b, s, n), generator=gen, device=dev)
    got = launched_by(common.LAUNCHES, lambda: layers.ssd_chunked(
        xh, dt, a_log, Bm, Cm, cfg.ssm_chunk))
    y = layers.ssd_chunked(xh, dt, a_log, Bm, Cm, cfg.ssm_chunk)
    a = -torch.exp(a_log.double())
    state = torch.zeros((b, h, p, n), dtype=torch.float64, device=dev)
    want = torch.empty((b, s, h, p), dtype=torch.float64, device=dev)
    for t in range(s):
        dt_t = dt[:, t].double()
        state = state * torch.exp(dt_t * a)[..., None, None] + (
            dt_t[..., None, None] * xh[:, t, :, :, None].double()
            * Bm[:, t, None, None, :].double())
        want[:, t] = torch.einsum("bhpn,bn->bhp", state, Cm[:, t].double())
    err = scaled_err(y, want)
    log(f"[lm] ssd_chunked at mamba2-2.7b's widths (h {h}, p {p}, n {n}, "
        f"chunk {cfg.ssm_chunk}), B={b} S={s}, fp32 on the card: scaled err "
        f"against a float64 step-by-step recurrence {err[1]:.3e} (<= 1e-4); "
        f"launches {dict(got)}")
    if err[1] > 1e-4 or got != collections.Counter(ssd_scan=1):
        raise AssertionError(f"ssd_chunked: err {err[1]:.3e}, launches "
                             f"{dict(got)}")
    del xh, dt, Bm, Cm, y, want, state

    # -- 7e-2. fp32, full width, reduced depth: the card against the CPU ----
    B, S = FAM_F32_BATCH, FAM_F32_SEQ
    for arch, depth in FAM_F32:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=depth,
                                  compute_dtype="float32")
        params = init_params(zoo.model_template(cfg), SEED, device=dev)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (B, S + 1))).to(dev)
        hp = HParams()
        logits, cache = build_prefill_step(cfg, hp)(params,
                                                    {"tokens": toks[:, :S]})
        cpu = tree_map(lambda t: t.cpu(), params)
        logits_c, cache_c = build_prefill_step(cfg, hp)(
            cpu, {"tokens": toks[:, :S].cpu()})
        errs = {"logits": scaled_err(logits.cpu(), logits_c)[1]}
        cache_c = flat(cache_c)
        for k, t in flat(cache).items():
            errs[k] = scaled_err(t.cpu(), cache_c[k])[1]
        del cpu, cache_c, logits_c
        # an MoE layer's capacity follows its token count, so the forward
        # over S + 1 may drop pairs that prefill and decode keep: the MoE
        # model's decode check runs all three with a capacity that drops
        # nothing
        moe_ffn = layers.moe_ffn
        if cfg.n_experts:
            layers.moe_ffn = functools.partial(moe_ffn, capacity_factor=100.0)
        try:
            with torch.no_grad():
                full, _ = zoo.forward(cfg, params, {"tokens": toks},
                                      attn_impl="pallas")
                if cfg.n_experts:
                    _, cache = zoo.prefill(cfg, params,
                                           {"tokens": toks[:, :S]},
                                           attn_impl="pallas")
            tok, _ = build_serve_step(cfg, hp)(params, pad(cache, 8),
                                               toks[:, S], S)
        finally:
            layers.moe_ffn = moe_ffn
        last = full[:, -1].float()
        top = last.topk(2, dim=-1).values
        rows = (top[:, 0] - top[:, 1]) / last.abs().max() > 1e-3
        match = bool((tok.long() == last.argmax(-1))[rows].all())
        log(f"[lm] {arch} fp32, full width, {depth} layers, B={B} S={S}: "
            f"prefill on the card against the CPU (plain versions), scaled "
            f"err {', '.join(f'{k} {v:.3e}' for k, v in errs.items())}; "
            f"decode at pos {S}: token {tok.tolist()} vs forward argmax "
            f"{last.argmax(-1).tolist()}, {int(rows.sum())} of {B} rows "
            f"compared (lead > 1e-3 scaled)"
            + (", capacity_factor 100 for the decode check"
               if cfg.n_experts else "")
            + f"; {time.perf_counter() - t0:.1f} s")
        if max(errs.values()) > 1e-4 or not match:
            raise AssertionError(f"{arch} fp32: the card disagrees")
        del params, logits, cache, full, last
        torch.cuda.empty_cache()

    # -- 7e-2b. the VLM, one period in fp32: kernel against "flash" --------
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("llama-3.2-vision-90b"),
                              n_layers=VLM_F32_LAYERS,
                              compute_dtype="float32")
    B, S = VLM_F32_BATCH, VLM_F32_SEQ
    params = init_params(zoo.model_template(cfg), SEED, device=dev)
    # the cross layers' tanh gate starts at 0; open it so the image counts
    params["periods"]["cross"]["gate"].fill_(0.5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (B, S + 1))).to(dev)
    image = images(cfg, B, torch.float32)
    batch = {"tokens": toks[:, :S], "image_embeds": image}
    logits, cache = build_prefill_step(cfg, HParams())(params, batch)
    logits_f, cache_f = build_prefill_step(cfg, HParams("flash"))(params,
                                                                  batch)
    errs = {"logits": scaled_err(logits, logits_f)[1]}
    cache_f = flat(cache_f)
    for k, t in flat(cache).items():
        errs[k] = scaled_err(t, cache_f[k])[1]
    del cache_f, logits_f
    with torch.no_grad():
        full, _ = zoo.forward(cfg, params, {"tokens": toks,
                                            "image_embeds": image},
                              attn_impl="pallas")
    tok, _ = build_serve_step(cfg, HParams())(params, pad(cache, 8),
                                              toks[:, S], S)
    last = full[:, -1].float()
    top = last.topk(2, dim=-1).values
    rows = (top[:, 0] - top[:, 1]) / last.abs().max() > 1e-3
    match = bool((tok.long() == last.argmax(-1))[rows].all())
    log(f"[lm] llama-3.2-vision-90b fp32, full width, {cfg.n_layers} layers "
        f"(one period, gate 0.5), B={B} S={S}, {cfg.n_image_tokens} image "
        f"embeddings: kernel prefill against flash prefill, scaled err "
        f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())}; decode at "
        f"pos {S}: token {tok.tolist()} vs forward argmax "
        f"{last.argmax(-1).tolist()}, {int(rows.sum())} of {B} rows "
        f"compared (lead > 1e-3 scaled); {time.perf_counter() - t0:.1f} s")
    if max(errs.values()) > 1e-4 or not match:
        raise AssertionError("llama-3.2-vision-90b fp32: the kernel path "
                             "disagrees")
    del params, logits, cache, full, last, image, batch
    torch.cuda.empty_cache()

    # -- 7e-3. bf16 served at full width, counted ---------------------------
    common.reset_launches()
    hp = HParams()
    B, S, STEPS = FAM_BATCH, FAM_SEQ, FAM_STEPS
    for arch, depth in FAM_SERVED:
        t0 = time.perf_counter()
        full_cfg = get_config(arch)
        cfg = dataclasses.replace(full_cfg, n_layers=depth)
        n_attn, n_mamba = mixers(cfg)
        params = init_params(zoo.model_template(cfg), SEED, device=dev,
                             dtype=hp.serve_dtype)
        torch.cuda.empty_cache()
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        size = f"{nbytes / 1e9:.2f} GB of weights"
        if depth != full_cfg.n_layers:
            full_bytes = 2 * count_template_params(
                zoo.model_template(full_cfg))
            size += (f" ({depth} of {full_cfg.n_layers} layers: the whole "
                     f"model's {full_bytes / 1e9:.1f} GB of bf16 weights do "
                     f"not fit one 80 GB card)")
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S))).to(dev)}
        if cfg.family == "vlm":
            batch["image_embeds"] = images(cfg, B, torch.bfloat16)
        prefill = build_prefill_step(cfg, hp)
        walls = []
        want = +collections.Counter(flash_attention=n_attn, ssd_scan=n_mamba)
        for _ in range(2):                      # the first call warms up
            before = collections.Counter(common.LAUNCHES)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, cache = prefill(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            got = collections.Counter(common.LAUNCHES) - before
            if got != want:
                raise AssertionError(f"{arch} bf16 prefill launched "
                                     f"{dict(got)}, want {dict(want)}")
        pre_kernels = device_ms(lambda: prefill(params, batch), 1,
                                by_kernel=True)
        pre_dev = sum(pre_kernels.values()) if pre_kernels else None
        shapes = {k: tuple(t.shape) for k, t in flat(
            zoo.init_cache(cfg, B, S, abstract=True)).items()}
        if not bool(torch.isfinite(logits).all()) or {
                k: tuple(t.shape) for k, t in flat(cache).items()} != shapes:
            raise AssertionError(f"{arch} bf16 prefill: non-finite logits "
                                 f"or a cache of the wrong layout")
        serve = build_serve_step(cfg, hp)
        dcache = pad(cache, STEPS)
        del cache
        tok = logits.argmax(-1)
        out = []
        before = collections.Counter(common.LAUNCHES)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(STEPS):
            tok, _ = serve(params, dcache, tok, S + i)
            out.append(tok)
        torch.cuda.synchronize()
        dec_wall = time.perf_counter() - t1
        if collections.Counter(common.LAUNCHES) != before:
            raise AssertionError(f"{arch} decode launched a kernel")
        toks_out = torch.stack(out, 1)
        if not bool(((toks_out >= 0) & (toks_out < cfg.vocab_size)).all()):
            raise AssertionError(f"{arch} decode tokens out of range: "
                                 f"{toks_out}")
        step_kernels = device_ms(lambda: serve(params, dcache, tok,
                                               S + STEPS - 1), 1,
                                 by_kernel=True)
        step_dev = sum(step_kernels.values()) if step_kernels else None
        del dcache
        flash = ""
        if n_attn:
            logits_f, _ = build_prefill_step(cfg, HParams("flash"))(params,
                                                                    batch)
            if not bool(torch.isfinite(logits_f).all()):
                raise AssertionError(f"{arch} bf16 flash prefill: non-finite "
                                     f"logits")
            flash = (f"; kernel against flash prefill: last logits scaled "
                     f"diff {scaled_err(logits, logits_f)[1]:.3e}")
            del logits_f
        pre_ms, dec_ms = walls[-1] * 1e3, dec_wall * 1e3 / STEPS

        def busy(dev_ms, wall_ms):
            return f"{dev_ms / wall_ms:.3f}" if dev_ms else "not measured"
        log(f"[lm] {arch} bf16, {depth} layers, B={B} S={S}, {size}: "
            f"prefill {pre_ms:.1f} ms ({B * S / walls[-1]:.0f} tokens/s; "
            f"first call {walls[0] * 1e3:.1f} ms), device {pre_dev} ms (busy "
            f"{busy(pre_dev, pre_ms)}); decode {STEPS} steps {dec_ms:.2f} "
            f"ms/step, device {step_dev} ms/step (busy "
            f"{busy(step_dev, dec_ms)}); launches per prefill: "
            f"flash_attention {n_attn}, ssd_scan {n_mamba}, 0 in decode"
            f"{flash}; tokens {toks_out[:, :8].tolist()}; "
            f"{time.perf_counter() - t0:.1f} s")
        for label, times in (("prefill", pre_kernels), ("decode step",
                                                        step_kernels)):
            if times:
                top = sorted(times.items(), key=lambda kv: -kv[1])[:4]
                log(f"[lm] {arch}: device time of one {label} by kernel "
                    f"class: {kernel_classes(times)}; top kernels "
                    f"{[(k[:60], round(v, 3)) for k, v in top]}")
        del params, logits, batch
        torch.cuda.empty_cache()
    launches = dict(common.LAUNCHES)
    log(f"[launches] phase 7e (SSM, MoE, hybrid and VLM serving): "
        f"{launches}")
    log(f"[lm] phase 7e took {time.perf_counter() - t_phase:.1f} s")
    if not launches.get("ssd_scan") or not launches.get("flash_attention"):
        raise AssertionError(f"SSM / MoE / hybrid serving launched "
                             f"{launches}")
    return launches


def attention_grad64(torch, q, k, v, dout, causal, window):
    """float64 (dq, dk, dv) of attention on the (rounded) inputs by dense
    torch.autograd, one q head at a time (an [Sq, Sk] float64 score matrix
    at once)."""
    import math
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    dev = q.device
    q_pos = (Sk - Sq) + torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    dq = torch.empty(q.shape, dtype=torch.float64, device=dev)
    dk = torch.zeros(k.shape, dtype=torch.float64, device=dev)
    dv = torch.zeros(v.shape, dtype=torch.float64, device=dev)
    for h in range(H):
        qh = q[:, :, h].double().requires_grad_()
        kh = k[:, :, h // G].double().requires_grad_()
        vh = v[:, :, h // G].double().requires_grad_()
        s = torch.where(mask, qh @ kh.transpose(1, 2) / math.sqrt(D),
                        -math.inf)
        o = torch.softmax(s, -1) @ vh
        gq, gk, gv = torch.autograd.grad(o, (qh, kh, vh),
                                         dout[:, :, h].double())
        dq[:, :, h] = gq
        dk[:, :, h // G] += gk
        dv[:, :, h // G] += gv
    return dq, dk, dv


def train_phase(log, torch, dev, scaled_err, device_ms, timing, record):
    """Phase 11, LM training; returns the launches of the steps through
    ``train_loop``, counted from 0 just before them (the kernel checks
    before them and the gradient checks after are not counted), and per
    trained arch its peak ``max_memory_allocated`` (bytes) and launches
    per step, which phase 13's dry run predicts."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import common
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as scan
    from repro_torch.launch import steps
    from repro_torch.launch.train import train_loop
    from repro_torch.models import zoo
    from repro_torch.models.template import (count_template_params,
                                             init_params, tree_map)
    from repro_torch.optim import adam

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)

    # -- 11a. the attention backward against plain and float64 -------------
    # bf16 runs the tensor-core kernels: every head dim's pass 1 and pass 2
    # must hold wgmma (HGMMA) and TMA loads (UTMALDG)
    tc_sass = {fn: c for fn, c in SASS_COUNTS.items()
               if "fa_bwd_dq_tc_kernel" in fn or "fa_bwd_dkv_tc_kernel" in fn}
    if SASS_COUNTS:
        if len(tc_sass) != 2 * len(fa.HEAD_DIMS) or not all(
                c["HGMMA"] > 0 and c["UTMALDG"] > 0
                for c in tc_sass.values()):
            raise AssertionError(f"flash_attention_bwd tensor-core kernels' "
                                 f"SASS: {tc_sass}")
        log(f"[train] flash_attention_bwd bf16: {len(tc_sass)} tensor-core "
            f"kernels (pass 1 and 2 at D = {fa.HEAD_DIMS}), HGMMA "
            f"{sorted(c['HGMMA'] for c in tc_sass.values())}, UTMALDG "
            f"{sorted(c['UTMALDG'] for c in tc_sass.values())}")
    errs, timed, timed32 = [], None, None
    for label, (B, Sq, H, KH, D), dt, window in TRAIN_ATTN_CASES:
        dt = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for shape in ((B, Sq, H, D), (B, Sq, KH, D),
                                 (B, Sq, KH, D)))
        dout = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dt)
        out, lse = fa._forward(q, k, v, True, window, True)
        _, lse_p = fa.flash_attention_plain(q, k, v, window=window,
                                            return_lse=True)
        before = common.LAUNCHES["flash_attention_bwd"]
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, window=window)
        counted = common.LAUNCHES["flash_attention_bwd"] - before
        # bf16: the result does not depend on the launch
        again = fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                       window=window) \
            if dt == torch.bfloat16 else None
        plain = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                             window=window)
        exact = attention_grad64(torch, q, k, v, dout, True, window)
        torch.cuda.synchronize()
        equal = None if again is None else all(
            torch.equal(a, b) for a, b in zip(got, again))
        del again
        lse_err = float((lse - lse_p.float()).abs().max())
        parts = []
        ok = lse_err <= 1e-3 and counted == 1 and equal is not False
        for name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
            if g.dtype != dt or g.shape != e.shape or \
                    not bool(torch.isfinite(g).all()):
                raise AssertionError(f"flash_attention_bwd {label}: bad "
                                     f"{name} {g.dtype} {tuple(g.shape)}")
            k_err, k_scaled = scaled_err(g, e)
            p_err, p_scaled = scaled_err(p, e)
            vs_plain = scaled_err(g, p)
            errs.append(vs_plain)
            parts.append(f"{name} against float64 {k_err:.3e} (scaled "
                         f"{k_scaled:.3e}), plain {p_err:.3e} (scaled "
                         f"{p_scaled:.3e}), against plain {vs_plain[0]:.3e}")
            if dt == torch.float32:
                ok = ok and k_scaled <= 1e-4 and vs_plain[1] <= 1e-4
            else:
                ok = ok and k_err <= 1.5 * p_err
        rule = ("fp32: <= 1e-4 of max|oracle|" if dt == torch.float32 else
                "bf16: at most 1.5x the plain version's error, two runs "
                "torch.equal")
        by_kernel = device_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, dout, window=window), 3, by_kernel=True)
        if by_kernel is not None:
            # the route the dtype takes: the tensor-core kernels for bf16
            tc_ran = any("_tc_kernel" in n for n in by_kernel)
            ok = ok and tc_ran == (dt == torch.bfloat16)
        t = "not measured" if by_kernel is None else (
            f"{sum(by_kernel.values()):.5f} ms/launch on the device ("
            + ", ".join(f"{n.split('(')[0].replace('void ', '')} {ms:.5f}"
                        for n, ms in by_kernel.items()) + ")")
        log(f"[train] flash_attention_bwd {label}: q {tuple(q.shape)} k "
            f"{tuple(k.shape)} {str(dt)[6:]} window {window}: lse against "
            f"plain {lse_err:.3e}; {'; '.join(parts)}; launches counted "
            f"{counted}; two runs torch.equal {equal}; {t}; {rule}")
        if not ok:
            raise AssertionError(f"flash_attention_bwd {label} disagrees "
                                 f"({rule})")
        if timed is None:
            timed = (q, k, v, out, lse, dout, window)
        if timed32 is None and dt == torch.float32:
            timed32 = (label, q, k, v, out, lse, dout, window,
                       errs[-3:])
        del got, plain, exact
    q, k, v, out, lse, dout, window = timed
    B, Sq, H, D = q.shape
    # SDPA's autograd backward at the same shape: the library yardstick
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    ot = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    dt_ = dout.transpose(1, 2)
    lib_ms = timing(lambda: torch.autograd.grad(ot, (qt, kt, vt), dt_,
                                                retain_graph=True), 5, 10)[0]
    nbytes = q.element_size() * 2 * (2 * q.numel() + 2 * k.numel()
                                     + dout.numel()) + 4 * lse.numel()
    flops = 2.5 * attention_flops(B, Sq, Sq, H, D, causal=True, window=0)
    by_pass = device_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse,
                                                       dout), 10,
                        by_kernel=True)
    if by_pass is not None:
        log(f"[train] flash_attention_bwd {TRAIN_ATTN_CASES[0][0]} by pass "
            f"(10 calls): " + ", ".join(
                f"{n.split('(')[0].replace('void ', '')} {ms:.5f} ms"
                for n, ms in by_pass.items())
            + f"; total {sum(by_pass.values()):.5f} ms; SDPA's autograd "
            f"backward {lib_ms:.5f} ms; bound "
            f"{bound_ms(nbytes, flops, BF16_FLOPS_PER_S)[0]:.6f} ms")
    record("flash_attention_bwd",
           "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu",
           "src/repro/models/flash_cvjp.py:98", errs,
           timing(lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout),
                  20, 20),
           timing(lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse,
                                                       dout), 2, 2),
           nbytes, flops, library_ms=lib_ms,
           peak_flops_per_s=BF16_FLOPS_PER_S, pallas=False)
    del q, k, v, out, lse, dout, timed, qt, kt, vt, ot, dt_
    # the fp32 route (csrc/flash_attention_bwd.cu) at its first fp32 case,
    # with SDPA's fp32 autograd backward at the same shape
    # The fp32 route (csrc/flash_attention_bwd.cu, split TF32 on the
    # tensor cores: HMMA and LDGSTS in the SASS of both passes) against
    # float64 at every head dim, on the float64 forward's output and
    # log-sum-exp rounded to fp32: each gradient at most SPLIT_OVER_SIMT
    # times the SIMT kernels' error on the same inputs
    f32_sass = {fn: c for fn, c in SASS_COUNTS.items()
                if "fa_bwd_dq_kernel" in fn or "fa_bwd_dkv_kernel" in fn}
    if SASS_COUNTS and (len(f32_sass) != 2 * len(fa.HEAD_DIMS) or not all(
            c["HMMA"] > 0 and c["LDGSTS"] > 0 for c in f32_sass.values())):
        raise AssertionError(f"flash_attention_bwd fp32 kernels' SASS: "
                             f"{f32_sass}")
    label, q, k, v, out, lse, dout, window, errs32 = timed32
    for i, (name32, shape, sk, win) in enumerate(FP32_BWD_CASES):
        q3, k3, v3, g3 = fp32_case(torch, dev, 100 + i, shape, sk,
                                   with_dout=True)
        o64, l64 = attention64(torch, q3, k3, v3, True, win)
        o3, l3 = o64.float(), l64.float()
        got = fa.flash_attention_bwd(q3, k3, v3, o3, l3, g3, window=win)
        plain = fa.flash_attention_bwd_plain(q3, k3, v3, o3, l3, g3,
                                             window=win)
        exact = attention_grad64(torch, q3, k3, v3, g3, True, win)
        torch.cuda.synchronize()
        parts, ok = [], True
        for name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
            k_err, k_scaled = scaled_err(g, e)
            vs_plain = scaled_err(g, p)
            errs32.append(vs_plain)
            simt = SIMT_FP32_ERRS["backward"][name32][name]
            ok = ok and bool(torch.isfinite(g).all()) and \
                k_scaled <= 1e-4 and vs_plain[1] <= 1e-4 and \
                k_err <= SPLIT_OVER_SIMT * simt
            parts.append(f"{name} {k_err:.4e} (scaled {k_scaled:.3e}), "
                         f"{k_err / simt:.3f}x the SIMT kernel's "
                         f"{simt:.4e}, plain {scaled_err(p, e)[0]:.4e}")
        log(f"[train] flash_attention_bwd fp32 {name32}: q "
            f"{tuple(q3.shape)} k {tuple(k3.shape)} window {win}: against "
            f"float64 {'; '.join(parts)}; rule: <= 1e-4 of max|oracle| and "
            f"<= {SPLIT_OVER_SIMT}x the SIMT kernel's error")
        if not ok:
            raise AssertionError(f"flash_attention_bwd fp32 {name32} "
                                 f"disagrees")
        del q3, k3, v3, g3, o64, l64, o3, l3, got, plain, exact
    # ... and its time at its first fp32 case, with SDPA's fp32 autograd
    # backward at the same shape
    B, Sq, H, D = q.shape
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    ot = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    dt_ = dout.transpose(1, 2)
    record("flash_attention_bwd",
           "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           f"{label}: q {tuple(q.shape)} k {tuple(k.shape)} float32 causal",
           errs32,
           timing(lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout),
                  10, 10),
           timing(lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse,
                                                       dout), 3, 3),
           q.element_size() * 2 * (2 * q.numel() + 2 * k.numel()
                                   + dout.numel()) + 4 * lse.numel(),
           3 * 2.5 * attention_flops(B, Sq, Sq, H, D, causal=True,
                                     window=0),
           library_ms=timing(lambda: torch.autograd.grad(
               ot, (qt, kt, vt), dt_, retain_graph=True), 5, 10)[0],
           peak_flops_per_s=TF32_FLOPS_PER_S, route="float32")
    del q, k, v, out, lse, dout, timed32, qt, kt, vt, ot, dt_
    torch.cuda.empty_cache()

    # -- 11b. the ssd_scan backward against plain and float64 --------------
    scan_errs, first = [], None
    for shape in TRAIN_SCAN_SHAPES:
        st = torch.randn(shape, generator=gen, device=dev)
        dec = 1.0 - torch.rand(shape[:2], generator=gen, device=dev)
        dprev = torch.randn(shape, generator=gen, device=dev)
        prev = scan.ssd_scan(st, dec)
        got = scan.ssd_scan_bwd(dprev, prev, dec)
        plain = scan.ssd_scan_bwd_plain(dprev, prev, dec)
        # float64: the reverse recurrence on the same inputs
        g = torch.zeros((shape[0], *shape[2:]), dtype=torch.float64,
                        device=dev)
        want_s = torch.empty(shape, dtype=torch.float64, device=dev)
        want_d = torch.empty(shape[:2], dtype=torch.float64, device=dev)
        for c in reversed(range(shape[1])):
            if c + 1 < shape[1]:
                g = dprev[:, c + 1].double() + dec[:, c + 1, None,
                                                   None].double() * g
            want_s[:, c] = g
            want_d[:, c] = (g * prev[:, c].double()).sum((1, 2))
        torch.cuda.synchronize()
        e = [scaled_err(got[0], want_s), scaled_err(got[1], want_d)]
        scan_errs += [scaled_err(got[0], plain[0]),
                      scaled_err(got[1], plain[1])]
        b_ms, b_by = bound_ms(4 * (3 * st.numel() + 2 * dec.numel()),
                              4 * st.numel(), FP32_FLOPS_PER_S)
        log(f"[train] ssd_scan_bwd {shape}: dstates torch.equal to plain "
            f"{torch.equal(got[0], plain[0])}, ddecay against plain "
            f"{scan_errs[-1][1]:.3e} (scaled); against float64 dstates "
            f"{e[0][1]:.3e}, ddecay {e[1][1]:.3e} (scaled, <= 1e-5); "
            f"{device_ms(lambda: scan.ssd_scan_bwd(dprev, prev, dec))} "
            f"ms/launch on the device, bound {b_ms:.6f} ms by {b_by}")
        if max(x[1] for x in e) > 1e-5 or scan_errs[-1][1] > 1e-5 or \
                not torch.equal(got[0], plain[0]):
            raise AssertionError(f"ssd_scan_bwd {shape} disagrees")
        if first is None:
            first = (st, dec, dprev, prev)
    st, dec, dprev, prev = first
    record("ssd_scan_bwd", "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "src/repro/models/layers.py:370", scan_errs,
           timing(lambda: scan.ssd_scan_bwd(dprev, prev, dec)),
           timing(lambda: scan.ssd_scan_bwd_plain(dprev, prev, dec), 5, 10),
           4 * (3 * st.numel() + 2 * dec.numel()), 4 * st.numel(),
           pallas=False)
    del st, dec, dprev, prev, first
    torch.cuda.empty_cache()

    # -- 11c. train_loop at full width, counted -----------------------------
    common.reset_launches()
    hp = steps.HParams(remat="dots", cast_once=True,
                       optimizer=adam.AdamWConfig(
                           lr=1e-4, warmup_steps=2,
                           total_steps=TRAIN_STEPS))
    shape = ShapeConfig("chip", "train", TRAIN_SEQ, TRAIN_BATCH)
    measured = {}
    for arch, depth in TRAIN_MODELS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=depth)
        n_attn = 0 if cfg.family == "ssm" else depth
        n_mamba = depth if cfg.family == "ssm" else 0
        n_params = count_template_params(zoo.model_template(cfg))
        per_step = []
        before = collections.Counter(common.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        state, _ = train_loop(
            cfg, shape, hp, steps=TRAIN_STEPS, log_every=0, seed=SEED,
            device=dev, on_step=lambda s, m, sec: per_step.append((m, sec)))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        got = collections.Counter(common.LAUNCHES) - before
        tokens = TRAIN_BATCH * TRAIN_SEQ
        rows = "; ".join(
            f"step {i}: {sec * 1e3:.1f} ms, {tokens / sec:.0f} tokens/s, "
            f"loss {m['loss']:.4f}, grad norm {m['grad_norm']:.4f}"
            for i, (m, sec) in enumerate(per_step))
        log(f"[train] {arch}, full width, {depth} layers "
            f"({n_params / 1e9:.2f} B parameters), B={TRAIN_BATCH} "
            f"S={TRAIN_SEQ}, remat dots, cast_once, {TRAIN_STEPS} AdamW "
            f"steps on the zipf pipeline through train_loop: {rows}; peak "
            f"torch.cuda.max_memory_allocated {peak:.2f} GB; launches "
            f"{dict(got)} ({ {k: v / TRAIN_STEPS for k, v in got.items()} } "
            f"per step); {time.perf_counter() - t0:.1f} s")
        finite = all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                     for m, _ in per_step)
        want = {"flash_attention": n_attn, "flash_attention_bwd": n_attn,
                "ssd_scan": n_mamba, "ssd_scan_bwd": n_mamba}
        short = {k: (got[k], n * TRAIN_STEPS) for k, n in want.items()
                 if got[k] < n * TRAIN_STEPS}
        if not finite or len(per_step) != TRAIN_STEPS or short:
            raise AssertionError(f"{arch} training: finite {finite}, "
                                 f"{len(per_step)} steps, launches short "
                                 f"of one per layer and step: {short}")
        measured[arch] = {"peak": peak * 1e9, "per_step": {
            k: v / TRAIN_STEPS for k, v in got.items()}}
        del state, per_step
        torch.cuda.empty_cache()
    launches = dict(common.LAUNCHES)
    log(f"[launches] phase 11 (training through train_loop): {launches}")

    # -- 11d. fp32 gradients: kernels against flash, card against CPU ------
    rng = np.random.default_rng(SEED + 13)
    for arch, depth, seq in TRAIN_GRAD_CHECKS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=depth,
                                  compute_dtype="float32")
        params = init_params(zoo.model_template(cfg), SEED, device=dev)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                  (1, seq))).to(dev)
                 for k in ("tokens", "labels")}
        hp = steps.HParams(remat="dots")
        loss, grads = steps.loss_and_grads(cfg, hp, params, batch)
        if cfg.family == "ssm":
            label = "card against the CPU (plain versions)"
            cpu = tree_map(lambda t: t.cpu(), params)
            want_loss, want = steps.loss_and_grads(
                cfg, hp, cpu, {k: t.cpu() for k, t in batch.items()})
            del cpu
        else:
            label = "kernel path against the blockwise flash autodiff"
            want_loss, want = steps.loss_and_grads(
                cfg, steps.HParams("flash", remat="dots"), params, batch)
        errs = {}
        for (key, g), (_, w) in zip(flat_items(grads), flat_items(want)):
            errs[key] = scaled_err(g.cpu(), w.cpu())[1]
        worst = max(errs, key=errs.get)
        log(f"[train] {arch} fp32 gradients, full width, {depth} layers, "
            f"B=1 S={seq}: {label}: loss {float(loss):.6f} vs "
            f"{float(want_loss):.6f}, {len(errs)} leaves, largest scaled "
            f"err {errs[worst]:.3e} ({worst}) (<= 1e-4); "
            f"{time.perf_counter() - t0:.1f} s")
        if errs[worst] > 1e-4 or abs(float(loss) - float(want_loss)) > \
                1e-5 * abs(float(want_loss)):
            raise AssertionError(f"{arch} fp32 gradients disagree")
        del params, grads, want, batch
        torch.cuda.empty_cache()
    log(f"[train] phase 11 took {time.perf_counter() - t_phase:.1f} s")
    if not all(launches.get(k) for k in ("flash_attention",
                                         "flash_attention_bwd", "ssd_scan",
                                         "ssd_scan_bwd")):
        raise AssertionError(f"training launched {launches}")
    return launches, measured


def sharding_phase(log, torch, dev, cfg, f, params, fleet, coords, fused_cfg,
                   card):
    """Phase 12, sharding on a 1 x 1 mesh; returns the launches of the
    sharded paths, counted from 0 just before them (the unsharded runs they
    are compared with are not counted)."""
    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.pipeline import compile_gradient
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed.sharding import ShardingPolicy, make_mesh
    from repro_torch.kernels import common
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import init_process_group
    from repro_torch.models import zoo
    from repro_torch.models.template import init_params
    from repro_torch.optim import adam
    from repro_torch.serve import (AsyncServingEngine, MultiINRArtifact,
                                   ServingEngine, bind_weights)

    t_phase = time.perf_counter()
    pg_dir = ROOT / "build" / "chip_smoke_pg"
    shutil.rmtree(pg_dir, ignore_errors=True)
    pg_dir.mkdir(parents=True)
    init_process_group(str(pg_dir / "store"), 0, 1, timeout_s=300)
    counted = collections.Counter()

    def count(fn):
        """fn() with the launches it made added to ``counted``."""
        common.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counted.update(common.LAUNCHES)
        return out, dict(common.LAUNCHES)

    def same(want, got):
        return len(want) == len(got) and all(
            len(w) == len(g) and all(torch.equal(a, b) for a, b in zip(w, g))
            for w, g in zip(want, got))

    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        policy = ShardingPolicy(mesh)
        log(f"[shard] mesh {mesh} over a one-rank {dist.get_backend()} "
            f"group; {card}")

        # -- 12a. phase 5's K = 8 fleet, K-sharded --------------------------
        K, N = len(fleet), 8192
        gen = torch.Generator().manual_seed(K)
        lane_coords = (torch.rand(K, N, 2, generator=gen) * 2 - 1).to(dev)
        base = compile_gradient(f, 2, coords[:cfg.batch], config=fused_cfg,
                                device=dev)
        payloads = [bind_weights(base, params, w) for w in fleet]
        want = MultiINRArtifact(base, payloads).apply_batched(lane_coords)
        m = MultiINRArtifact(base, payloads, sharding=policy)
        got, launched = count(lambda: m.apply_batched(lane_coords))
        ok = m.k_sharded and m.double_buffered and same([want], [got]) \
            and launched.get("region_stacked", 0) > 0
        log(f"[shard] K-sharded fleet, K={K} order 2 N={N} per lane: "
            f"k_sharded {m.k_sharded}, stacked path {m.double_buffered}, "
            f"outputs torch.equal to the unsharded stack "
            f"{same([want], [got])}; launches {launched}; {card}")
        if not ok:
            raise AssertionError("the K-sharded fleet disagrees")
        del want, got, m, lane_coords

        # -- 12b. row-sharded sync and async engines at orders 1-3 ---------
        for order in (1, 2, 3):
            cg = compile_gradient(f, order, coords[:cfg.batch],
                                  config=fused_cfg, device=dev)
            reqs = [(f"siren{order}", coords)]
            plain = ServingEngine(device=dev)
            sync = ServingEngine(sharding=policy, shard_chunking=True,
                                 device=dev)
            asyn = AsyncServingEngine(sharding=policy, device=dev)
            for e in (plain, sync, asyn):
                e.register(f"siren{order}", cg)
            want = plain.serve(reqs)
            got_s, l_s = count(lambda: sync.serve(reqs))
            got_a, l_a = count(lambda: asyn.serve_async(reqs))
            log(f"[shard] order {order}, N={coords.shape[0]} rows: "
                f"ServingEngine(sharding, shard_chunking) torch.equal "
                f"{same(want, got_s)} (launches {l_s}), "
                f"AsyncServingEngine(sharding) torch.equal "
                f"{same(want, got_a)} (launches {l_a}); {card}")
            if not (same(want, got_s) and same(want, got_a)):
                raise AssertionError(f"sharded engines at order {order} "
                                     f"disagree")
            del want, got_s, got_a, plain, sync, asyn, cg

        # -- 12c. one sharded train step of qwen3-8b, 4 layers --------------
        arch, depth = TRAIN_MODELS[0]
        lm = dataclasses.replace(get_config(arch), n_layers=depth)
        hp = steps.HParams(remat="dots", cast_once=True,
                           optimizer=adam.AdamWConfig(
                               lr=1e-4, warmup_steps=2,
                               total_steps=TRAIN_STEPS))
        shape = ShapeConfig("chip", "train", TRAIN_SEQ, TRAIN_BATCH)
        pipe = TokenPipeline(DataConfig(lm.vocab_size, shape.seq_len,
                                        shape.global_batch, seed=SEED))
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch_at(0).items()}
        results = {}
        for label, pol in (("unsharded", None), ("sharded", policy)):
            state = steps.init_state(lm, SEED, device=dev)
            if pol is not None:
                state = steps.place_state(state, lm, pol)
            step = steps.build_train_step(lm, hp, pol)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if pol is None:
                _, metrics = step(state, batch)
                torch.cuda.synchronize()
                launched = None
            else:
                (_, metrics), launched = count(lambda: step(state, batch))
            results[label] = ({k: float(v) for k, v in metrics.items()},
                              time.perf_counter() - t0, launched)
            del state, step, metrics
            torch.cuda.empty_cache()
        (m1, t1, _), (m2, t2, launched) = (results["unsharded"],
                                           results["sharded"])
        loss_ok = abs(m2["loss"] - m1["loss"]) <= 1e-5 * abs(m1["loss"])
        gn_ok = abs(m2["grad_norm"] - m1["grad_norm"]) <= \
            1e-4 * abs(m1["grad_norm"])
        log(f"[shard] {arch}, full width, {depth} layers, B={TRAIN_BATCH} "
            f"S={TRAIN_SEQ}, remat dots, cast_once, one step with the state "
            f"at state_specs: loss {m2['loss']:.6f} vs {m1['loss']:.6f} "
            f"unsharded (rtol 1e-5: {loss_ok}), grad norm "
            f"{m2['grad_norm']:.6f} vs {m1['grad_norm']:.6f} (rtol 1e-4: "
            f"{gn_ok}); first-step wall {t2 * 1e3:.1f} ms vs "
            f"{t1 * 1e3:.1f} ms; launches {launched}; {card}")
        finite = np.isfinite(m2["loss"]) and np.isfinite(m2["grad_norm"])
        if not (loss_ok and gn_ok and finite
                and launched.get("flash_attention", 0) > 0
                and launched.get("flash_attention_bwd", 0) > 0):
            raise AssertionError("the sharded train step disagrees")
        del batch, pipe
        torch.cuda.empty_cache()

        # -- 12d. sharded prefill and decode of phase 7's served model ------
        lm = dataclasses.replace(get_config(LM_ARCH),
                                 n_layers=SHARD_LM_LAYERS)
        hp = steps.HParams()
        params = steps.serving_params(lm, hp, init_params(
            zoo.model_template(lm), SEED, device=dev))
        placed = steps.place(params, steps.param_specs(lm, policy),
                             policy.mesh)
        gen = np.random.default_rng(SEED)
        prompt = {"tokens": torch.from_numpy(gen.integers(
            0, lm.vocab_size, (2, SHARD_LM_SEQ))).to(dev)}
        length = SHARD_LM_SEQ + SHARD_LM_STEPS
        want_l, want_c = steps.build_prefill_step(lm, hp)(
            params, prompt, cache_len=length)
        (got_l, got_c), l_pre = count(lambda: steps.build_prefill_step(
            lm, hp, policy)(placed, prompt, cache_len=length))
        leaves = lambda c: [t for _, t in flat_items(c)]
        equal = torch.equal(want_l, got_l) and all(
            torch.equal(a, b.to_local())
            for a, b in zip(leaves(want_c), leaves(got_c)))
        one = steps.build_serve_step(lm, hp)
        sharded = steps.build_serve_step(lm, hp, policy)
        t1 = t2 = want_l.argmax(-1).to(torch.int32)
        l_dec = collections.Counter()
        for pos in range(SHARD_LM_SEQ, length):
            t1, _ = one(params, want_c, t1, pos)
            (t2, _), l = count(lambda: sharded(placed, got_c, t2, pos))
            l_dec.update(l)
            equal = equal and torch.equal(t1, t2)
        equal = equal and all(torch.equal(a, b.to_local()) for a, b in zip(
            leaves(want_c), leaves(got_c)))
        log(f"[shard] {LM_ARCH}, full width, {SHARD_LM_LAYERS} layers, "
            f"bf16: sharded prefill of B=2 S={SHARD_LM_SEQ} into a cache of "
            f"{length} at cache_specs, then {SHARD_LM_STEPS} greedy decode "
            f"steps: logits, tokens and cache torch.equal to the unsharded "
            f"steps {equal}; launches prefill {l_pre}, decode "
            f"{dict(l_dec)}; {card}")
        if not equal or l_pre.get("flash_attention", 0) != SHARD_LM_LAYERS:
            raise AssertionError("the sharded prefill / decode disagrees")
        del params, placed, want_c, got_c
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(pg_dir, ignore_errors=True)
    launches = dict(counted)
    log(f"[launches] phase 12 (sharding on a 1 x 1 mesh): {launches}; "
        f"{card}")
    log(f"[shard] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# phase 13: the reference's own record of its dry-run test cell
# (deepseek-moe-16b x decode_32k x single pod, remat full; written by its
# system test, ``results/dryrun_testcell.json``): bytes of arguments per
# device, the KV cache split 256 ways plus a parameter shard; its
# all-gather operand bytes, and the operand bytes of all its collectives
# (all-gather 14,233,192, all-reduce 38,313,984, all-to-all 3,735,552,
# collective-permute 917,536)
REFERENCE_TESTCELL_ARG_BYTES = 3_890_630_692
REFERENCE_TESTCELL_ALL_GATHER_BYTES = 14_233_192
REFERENCE_TESTCELL_COLLECTIVE_BYTES = 57_200_264
DRYRUN_CELLS = [["--arch", "qwen3-8b", "--shape", "train_4k"],
                ["--arch", "deepseek-moe-16b", "--shape", "decode_32k",
                 "--remat", "full"],
                ["--arch", "deepseek-moe-16b", "--shape", "train_4k"],
                ["--arch", "mamba2-2.7b", "--shape", "train_4k"],
                ["--arch", "jamba-v0.1-52b", "--shape", "train_4k"],
                ["--arch", "qwen3-8b", "--shape", "train_4k",
                 "--seq-parallel"],
                ["--arch", "gemma3-4b", "--shape", "train_4k"]]
DRYRUN_TIMEOUT_S = 300
# the same cells at commit 359ecfb, when the head, the logits and the
# experts were whole over "model" on every rank (per-rank bytes and FLOPs,
# chip_smoke.py phase 13 and ``python -m repro_torch.launch.dryrun --all
# --mesh single`` on fake CUDA tensors, NVIDIA H100 80GB HBM3, 700 W)
PARENT_DRYRUN = {
    ("qwen3-8b", "train_4k"): {
        "arguments": 0.388e9, "peak": 171.537e9, "flops": 4.4608e14,
        "all-gather": 6.9866e8, "all-reduce": 9.6638e10,
        "reduce-scatter": 3.2556e9},
    # at commit 6f8bc65, whose decode gathered every layer's parameter
    # blocks over "data" (the same CLI on fake CUDA tensors, NVIDIA H100
    # 80GB HBM3, 700.00 W)
    ("deepseek-moe-16b", "decode_32k"): {
        "arguments": 3.890631168e9, "peak": 4.102126592e9,
        "flops": 3.6107e10, "all-gather": 1.32311648e8,
        "all-reduce": 2.78528e6, "reduce-scatter": 0.0},
    ("deepseek-moe-16b", "train_4k"): {
        "arguments": 0.796e9, "peak": 114.764e9, "flops": 1.2485e15,
        "all-gather": 8.6208e9, "all-reduce": 2.2549e10,
        "reduce-scatter": 4.2336e9},
    # at commit a935b21, the mamba layers whole on every "model" rank (the
    # same CLI on fake CUDA tensors, NVIDIA H100 80GB HBM3, 700.00 W)
    ("mamba2-2.7b", "train_4k"): {
        "arguments": 0.351e9, "peak": 166.906e9, "flops": 1.1337e15,
        "all-gather": 1.4299e9, "all-reduce": 2.3819e6,
        "reduce-scatter": 1.8299e9},
    ("jamba-v0.1-52b", "train_4k"): {
        "arguments": 2.423e9, "peak": 161.105e9, "flops": 1.4533e15,
        "all-gather": 3.0358e9, "all-reduce": 5.0477e10,
        "reduce-scatter": 1.3016e10},
    # at commit 1afcfe7, where a head count the axis does not divide left
    # the MLPs whole on every "model" rank, and ``--seq-parallel`` ran each
    # rank's sequence block as whole sequences (not the step; its gate is
    # the same run's cell without the flag) (the same CLI on fake CUDA
    # tensors, NVIDIA H100 80GB HBM3, 700.00 W)
    ("gemma3-4b", "train_4k"): {
        "arguments": 0.216e9, "peak": 156.463e9, "flops": 1.3668e15,
        "all-gather": 1.7256e9, "all-reduce": 6.7265e8,
        "reduce-scatter": 1.1377e9},
    ("qwen3-8b", "train_4k", "seq_parallel"): {
        "arguments": 0.388e9, "peak": 5.250e9, "flops": 1.2229e13,
        "all-gather": 3.8750e8, "all-reduce": 6.1082e9,
        "reduce-scatter": 3.2556e9}}
# the gates of steps that keep the vocab and the experts split over
# "model": the decode cell within 80 GB and within 1.05x the reference's
# arguments; of the weight-stationary decode, its all-gather and its
# collective bytes at most the reference's (REFERENCE_TESTCELL_*), its
# peak at most its parent's and no collective on a parameter block;
# qwen3's training peak at most 100 GB
# (171.537 GB at 359ecfb, the head whole); deepseek's training cell
# within 80 GB (114.764 GB at 359ecfb).  Of steps that split the mamba
# heads over "model": mamba2's training peak at most 100 GB and its FLOPs
# at most half its parent's (the mamba layers whole on every rank at
# a935b21); jamba's training peak and FLOPs below its parent's; and
# every ``ssd_scan`` call of both on the rank's rows and nh/16 heads
DECODE_ARGS_OVER_REFERENCE = 1.05
TRAIN_PEAK_BYTES = 100e9
MAMBA_FLOPS_OVER_PARENT = 0.5
# of the sequence split: qwen3's ``--seq-parallel`` cell within 2% of the
# FLOPs of the same run's cell without the flag, at no higher a peak
SEQ_PARALLEL_FLOPS_TOL = 0.02


def _dryrun_key(rec) -> tuple:
    """A dry-run record's key in ``PARENT_DRYRUN``: (arch, shape), and
    "seq_parallel" under ``--seq-parallel``."""
    return (rec["arch"], rec["shape"]) + (
        ("seq_parallel",) if rec["hp"]["seq_parallel"] else ())


def dryrun_phase(log, torch, dev, trained, card):
    """Phase 13, the dry run on fake tensors (``launch/dryrun.py``);
    returns the launches made while it ran, which must be none, and
    checks that it allocated nothing on the card.

    13a: phase 11's qwen3-8b step (``TRAIN_MODELS``' depth, B, S, remat
    "dots", cast_once) traced on fake tensors on ``dev``, unsharded and on
    a 1 x 1 mesh of a one-rank fake group: the predicted peak beside phase
    11's measured ``max_memory_allocated`` (within 15%), the custom ops'
    calls beside phase 11's launches per step (equal), the FLOPs beside
    the closed form.  13b: the CLI in a subprocess a cell, all at once,
    on ``DRYRUN_CELLS`` over the single pod's 256 ranks: per-rank peak,
    whether it fits, the dominant roofline term, FLOPs and collectives
    beside the parent's, for the reference's test cell the argument bytes
    against the reference's, for the mamba cells ``ssd_scan``'s call
    shapes (the rank's rows and heads), and for qwen3's ``--seq-parallel``
    cell the FLOPs and peak beside the same run's cell without the flag
    and the attention's call shapes (the whole sequence)."""
    import dataclasses
    import os
    import tempfile

    from repro_torch.configs import SHAPES, ShapeConfig, get_config
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import visible_pairs
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import zoo
    from repro_torch.models.template import count_template_params
    from repro_torch.optim import adam

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    common.reset_launches()
    allocated = torch.cuda.memory_allocated()

    # -- 13a. phase 11's step, predicted ----------------------------------
    arch, depth = TRAIN_MODELS[0]
    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    hp = steps.HParams(remat="dots", cast_once=True,
                       optimizer=adam.AdamWConfig(
                           lr=1e-4, warmup_steps=2,
                           total_steps=TRAIN_STEPS))
    shape = ShapeConfig("chip", "train", TRAIN_SEQ, TRAIN_BATCH)
    want = trained[arch]
    calls_want = {"flash_attention_fwd": want["per_step"].get(
        "flash_attention", 0), "flash_attention_bwd": want["per_step"].get(
        "flash_attention_bwd", 0)}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_mat = count_template_params(zoo.model_template(cfg)) \
        - cfg.vocab_size * cfg.d_model          # the embedding is a lookup
    closed = 6 * n_mat * tokens + (4 + 4 + 10) * cfg.head_dim * \
        visible_pairs(TRAIN_SEQ, TRAIN_SEQ, True, 0) * TRAIN_BATCH * \
        cfg.n_heads * depth
    for label in ("unsharded", "1 x 1 mesh"):
        if label == "unsharded":
            rec = dryrun.lower_cell(arch, "chip", None, hp, device=dev,
                                    cfg=cfg, shape=shape)
        else:
            with dryrun.fake_process_group(1):
                mesh = make_mesh((1, 1), ("data", "model"),
                                 device_type=dev.type)
                rec = dryrun.lower_cell(arch, "chip", mesh, hp, device=dev,
                                        cfg=cfg, shape=shape)
        mem, cost = rec["memory"], rec["hlo_cost"]
        peak = mem["peak_memory_in_bytes"]
        ratio = peak / want["peak"]
        log(f"[dryrun] {arch} train step ({depth} layers, B={TRAIN_BATCH} "
            f"S={TRAIN_SEQ}, remat dots, cast_once) on fake {dev.type} "
            f"tensors, {label}: traced in {rec['lower_s']} s; predicted peak "
            f"{peak / 1e9:.3f} GB (arguments "
            f"{mem['argument_size_in_bytes'] / 1e9:.3f}, temporaries "
            f"{mem['temp_size_in_bytes'] / 1e9:.3f}) against phase 11's "
            f"measured max_memory_allocated {want['peak'] / 1e9:.3f} GB: "
            f"{ratio:.4f} (within 15%); kernel calls {rec['kernel_calls']} "
            f"against phase 11's launches per step {calls_want}; FLOPs "
            f"{cost['flops']:.6e} (matrix products and kernels "
            f"{rec['dot_flops']:.6e}) against the closed form 6 N T + 18 D "
            f"pairs H L {closed:.6e}: {rec['dot_flops'] / closed:.4f}; "
            f"bytes streamed {cost['bytes_streamed']:.6e}, collectives "
            f"{cost['collective_bytes']:.6e} B; {card}")
        if abs(ratio - 1) > 0.15 or rec["kernel_calls"] != calls_want:
            raise AssertionError(f"dry run of phase 11's step, {label}: "
                                 f"peak ratio {ratio:.4f}, calls "
                                 f"{rec['kernel_calls']} vs {calls_want}")

    # -- 13b. production cells through the CLI, one process a cell -------
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_LOG_LEVEL="info")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = []
        try:
            for i, cell in enumerate(DRYRUN_CELLS):
                out = Path(tmp) / f"cell{i}.json"
                procs.append((cell, out, subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     *cell, "--mesh", "single", "--device", dev.type,
                     "--out", str(out)], stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)))
            done = [(cell, out, p, *p.communicate(
                timeout=max(1.0, DRYRUN_TIMEOUT_S
                            - (time.perf_counter() - t0))))
                for cell, out, p in procs]
        finally:
            for _, _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        by_key = {}
        for cell, out, p, stdout, stderr in done:
            recs = json.loads(out.read_text()) if out.exists() else []
            if p.returncode != 0 or len(recs) != 1 or "error" in recs[0]:
                raise AssertionError(f"dry run {cell}: rc {p.returncode}\n"
                                     f"{stdout[-3000:]}{stderr[-3000:]}")
            rec = recs[0]
            mem, roof, cost = rec["memory"], rec["roofline"], rec["hlo_cost"]
            args, peak = (mem["argument_size_in_bytes"],
                          mem["peak_memory_in_bytes"])
            by_key[_dryrun_key(rec)] = rec
            was = PARENT_DRYRUN[_dryrun_key(rec)]
            colls = {k: f"{int(v['count'])} ops {v['bytes']:.4e} B "
                     f"(parent {was.get(k, 0.0):.4e})"
                     for k, v in cost["collectives"].items()
                     if v["count"] or was.get(k)}
            vs_ref = ""
            if rec["shape"] == "decode_32k":
                ref = REFERENCE_TESTCELL_ARG_BYTES
                ag = cost["collectives"]["all-gather"]["bytes"] \
                    / REFERENCE_TESTCELL_ALL_GATHER_BYTES
                every = cost["collective_bytes"] \
                    / REFERENCE_TESTCELL_COLLECTIVE_BYTES
                vs_ref = (f"; arguments over the reference's "
                          f"{ref / 1e9:.4f} GB: {args / ref:.4f}x; "
                          f"all-gather and all collectives over the "
                          f"reference's {REFERENCE_TESTCELL_ALL_GATHER_BYTES}"
                          f" / {REFERENCE_TESTCELL_COLLECTIVE_BYTES} B: "
                          f"{ag:.4f}x / {every:.4f}x")
            log(f"[dryrun] {rec['arch']} x {rec['shape']} x single pod "
                f"({rec['n_devices']} fake ranks, mesh {rec['mesh']}, remat "
                f"{rec['hp']['remat']}, seq_parallel "
                f"{rec['hp']['seq_parallel']}, attn "
                f"{rec['hp']['attn_impl']}): "
                f"{len(DRYRUN_CELLS)} cells at once in {wall:.1f} s (traced "
                f"in {rec['lower_s']} s); per rank: arguments "
                f"{args / 1e9:.3f} GB (parent "
                f"{was['arguments'] / 1e9:.3f}), temporaries "
                f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB, peak "
                f"{peak / 1e9:.3f} GB (parent {was['peak'] / 1e9:.3f}), fits "
                f"80 GB {rec['fits_hbm']}; collectives by kind {colls}; "
                f"flops {cost['flops']:.4e} (parent {was['flops']:.4e}), "
                f"bytes streamed {cost['bytes_streamed']:.4e}, collectives "
                f"{cost['collective_bytes']:.4e} B; roofline "
                f"compute {roof['t_compute']:.4f} s, memory "
                f"{roof['t_memory']:.4f} s, collective "
                f"{roof['t_collective']:.4f} s: dominant {roof['dominant']}"
                f"{vs_ref}; collectives carrying a parameter block "
                f"{int(rec['param_collectives']['count'])} ops "
                f"{rec['param_collectives']['bytes']:.4e} B; kernel calls "
                f"{rec['kernel_calls']}")
            gathered = cost["collectives"]["all-gather"]["bytes"]
            if rec["n_devices"] != 256:
                raise AssertionError(f"dry run {cell}: {rec['n_devices']}")
            if rec["shape"] == "decode_32k" and not (
                    rec["fits_hbm"] and args <= DECODE_ARGS_OVER_REFERENCE
                    * REFERENCE_TESTCELL_ARG_BYTES
                    and gathered <= REFERENCE_TESTCELL_ALL_GATHER_BYTES
                    and cost["collective_bytes"]
                    <= REFERENCE_TESTCELL_COLLECTIVE_BYTES
                    and peak <= was["peak"]
                    and rec["param_collectives"]["count"] == 0):
                raise AssertionError(
                    f"dry run {cell}: arguments {args} B (the reference's "
                    f"{REFERENCE_TESTCELL_ARG_BYTES}), peak {peak} B (the "
                    f"parent's {was['peak']:.0f}), fits 80 GB "
                    f"{rec['fits_hbm']}, all-gather {gathered} B and "
                    f"collectives {cost['collective_bytes']} B (the "
                    f"reference's {REFERENCE_TESTCELL_ALL_GATHER_BYTES} and "
                    f"{REFERENCE_TESTCELL_COLLECTIVE_BYTES}), parameter "
                    f"collectives {rec['param_collectives']}")
            if rec["arch"] == "qwen3-8b" and peak > TRAIN_PEAK_BYTES:
                raise AssertionError(f"dry run {cell}: peak {peak} B over "
                                     f"{TRAIN_PEAK_BYTES:.0f}")
            if rec["arch"] == "deepseek-moe-16b" and rec["shape"] == \
                    "train_4k" and not rec["fits_hbm"]:
                raise AssertionError(f"dry run {cell}: peak {peak} B does "
                                     f"not fit 80 GB")
            mcfg = get_config(rec["arch"])
            if mcfg.ssm_state:
                # ssd_scan on [rows x heads, chunks, p, n] of the rank's
                # rows and its nh / model heads, forward and backward
                rows = SHAPES[rec["shape"]].global_batch // rec["mesh"][
                    "data"]
                heads = mcfg.ssm_heads // rec["mesh"]["model"]
                scans = {k: rec["kernel_shapes"].get(k, []) for k in
                         ("ssd_scan", "ssd_scan_bwd")}
                log(f"[dryrun] {rec['arch']} x {rec['shape']}: ssd_scan "
                    f"call shapes {scans} (want {rows} rows x {heads} of "
                    f"{mcfg.ssm_heads} heads = {rows * heads})")
                if not all(v and {s[0] for s in v} == {rows * heads}
                           for v in scans.values()):
                    raise AssertionError(f"dry run {cell}: ssd_scan shapes "
                                         f"{scans}, want {rows * heads} "
                                         f"rows x heads")
                flops = cost["flops"]
                if rec["arch"] == "mamba2-2.7b" and (
                        peak > TRAIN_PEAK_BYTES or flops
                        > MAMBA_FLOPS_OVER_PARENT * was["flops"]):
                    raise AssertionError(
                        f"dry run {cell}: peak {peak} B (at most "
                        f"{TRAIN_PEAK_BYTES:.0f}), flops {flops:.4e} (at "
                        f"most {MAMBA_FLOPS_OVER_PARENT} x the parent's "
                        f"{was['flops']:.4e})")
                if rec["arch"] == "jamba-v0.1-52b" and not (
                        peak < was["peak"] and flops < was["flops"]):
                    raise AssertionError(
                        f"dry run {cell}: peak {peak} B, flops "
                        f"{flops:.4e}, not below the parent's "
                        f"{was['peak']:.0f} B, {was['flops']:.4e}")
            if rec["arch"] == "gemma3-4b" and not (
                    peak < was["peak"] and cost["flops"] < was["flops"]):
                raise AssertionError(
                    f"dry run {cell}: peak {peak} B, flops "
                    f"{cost['flops']:.4e}, not below the parent's "
                    f"{was['peak']:.0f} B, {was['flops']:.4e} (its MLPs "
                    f"whole on every rank)")
        # the sequence split against the same run's cell without it
        sp = by_key[("qwen3-8b", "train_4k", "seq_parallel")]
        flat = by_key[("qwen3-8b", "train_4k")]
        flops = [r["hlo_cost"]["flops"] for r in (sp, flat)]
        peaks = [r["memory"]["peak_memory_in_bytes"] for r in (sp, flat)]
        seqs = {tuple(s[:2]) for s in sp["kernel_shapes"].get(
            "flash_attention_fwd", [])}
        rows = SHAPES["train_4k"].global_batch // sp["mesh"]["data"]
        log(f"[dryrun] qwen3-8b x train_4k with --seq-parallel against "
            f"without: flops {flops[0]:.4e} / {flops[1]:.4e} = "
            f"{flops[0] / flops[1]:.4f} (within "
            f"{SEQ_PARALLEL_FLOPS_TOL}), peak {peaks[0] / 1e9:.3f} / "
            f"{peaks[1] / 1e9:.3f} GB; attention calls on [rows, seq] "
            f"{sorted(seqs)} (want [{rows}, {SHAPES['train_4k'].seq_len}]: "
            f"the whole sequence)")
        if abs(flops[0] / flops[1] - 1) > SEQ_PARALLEL_FLOPS_TOL or \
                peaks[0] > peaks[1] or \
                seqs != {(rows, SHAPES["train_4k"].seq_len)}:
            raise AssertionError(f"dry run of --seq-parallel: flops "
                                 f"{flops}, peaks {peaks}, attention "
                                 f"shapes {seqs}")

    torch.cuda.synchronize()
    launches = dict(common.LAUNCHES)
    grew = torch.cuda.memory_allocated() - allocated
    log(f"[launches] phase 13 (the dry run): {launches}; device memory "
        f"allocated during it {grew} B")
    log(f"[dryrun] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    if launches or grew:
        raise AssertionError(f"the dry run launched {launches} and "
                             f"allocated {grew} B on the card")
    return launches


def flat_items(tree, prefix=""):
    """(path, leaf) of a nested dict in sorted key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from flat_items(tree[key], f"{prefix}{key}/")
    else:
        yield prefix[:-1], tree


def autoconfig_phase(log, torch, cfg, f, coords, fused_cfg, unfused_cfg,
                     want_main, scaled_err, reading):
    """Phase 8, the paper's compiler half on the card; returns the launches
    of its auto path alone (each order's auto compile with its measure hook
    and the auto artifact's serving).  ``config="auto"`` at orders 1-2 (the measure hook
    times each candidate's real ``apply_batched``), the auto artifact served
    on the 256 x 256 grid beside the default one, the dataflow model's
    Table IV rows and byte accounting at orders 1-3 beside the card's peak
    memory of one served call, and a store round trip of an auto request."""
    from repro_torch.core import pipeline as P
    from repro_torch.core import trace
    from repro_torch.core.autoconfig import resolve_config, result_as_dict
    from repro_torch.core.config import DEFAULT_CONFIG
    from repro_torch.core.executor import (buffered_peak_bytes,
                                           buffered_total_bytes,
                                           streaming_peak_bytes)
    from repro_torch.core.regions import (region_hbm_bytes_per_block,
                                          segment_hbm_bytes_per_block)
    from repro_torch.kernels import common
    from repro_torch.obs.metrics import counter
    from repro_torch.obs.tracing import TRACER

    t_phase = time.perf_counter()
    base = DEFAULT_CONFIG.resolved()
    x64 = coords[:cfg.batch]
    # the auto path's own launches: each order's counts run from just before
    # the auto compile (with its measure hook) to just after the auto
    # artifact has served the grid and one chunk; the default artifact,
    # the timings and everything after are outside these windows
    launches = collections.Counter()
    for order in (1, 2):
        # the analytic search alone (the default compile before it is not
        # timed), then the front door with the hook
        default = P.compile_gradient(f, order, x64, device="cuda")
        t0 = time.perf_counter()
        analytic = resolve_config(default.graph, base=base)
        t_analytic = time.perf_counter() - t0
        log(f"[auto] order {order} analytic winner: "
            f"{analytic.config.describe()}; {analytic.evaluated} candidates, "
            f"{analytic.rejected} deadlock-rejected, predicted "
            f"{analytic.predicted_row_cycles} row-cycles against the "
            f"default's {analytic.baseline_row_cycles} (dataflow model); "
            f"search {t_analytic:.2f} s")
        TRACER.clear()
        common.reset_launches()
        with TRACER.enabled_scope():
            cg = P.compile_gradient(f, order, x64, config="auto",
                                    device="cuda")
        outs = cg.apply_batched(coords)
        rows = cg.config.chunk_blocks * cg.config.block
        xc = coords[:rows].reshape(cg.config.chunk_blocks, cg.config.block,
                                   -1)
        per_chunk = launched_by(common.LAUNCHES, lambda: cg.apply_chunk(xc))
        torch.cuda.synchronize()
        window = collections.Counter(common.LAUNCHES)
        launches += window
        events = list(TRACER.events)
        TRACER.clear()
        search = [e for e in events if e.name == "compile.autoconfig"]
        timed = [e for e in events
                 if e.name == "compile.autoconfig.measure"]
        for e in timed:
            log(f"[auto] order {order} timed {e.args['config']}: "
                f"{e.args['ms']:.4f} ms per {cfg.batch}-row apply_batched")
        res = cg.autoconfig
        if res is None or len(search) != 1 or not timed:
            raise AssertionError(f"order {order}: the auto compile ran "
                                 f"{len(search)} searches, timed "
                                 f"{len(timed)} candidates")
        if any(c.deadlocked for c in res.candidates if c.accepted):
            raise AssertionError("autoconfig accepted a deadlocked config")
        log(f"[auto] order {order} chosen: {res.config.describe()}; "
            f"{res.evaluated} candidates, {res.rejected} deadlock-rejected, "
            f"{len(timed)} timed; search with the measure hook "
            f"{search[0].dur_ns / 1e9:.2f} s (timed part "
            f"{sum(e.dur_ns for e in timed) / 1e9:.2f} s)")
        for line in cg.describe().splitlines():
            log(f"[auto] order {order} describe: {line}")

        # the auto artifact served on the grid, beside the default
        log(f"[launches] order {order} config='auto' (search with the "
            f"measure hook, N={coords.shape[0]} served, one chunk): "
            f"{dict(window)}")
        errs = []
        for o, w in zip(outs, want_main["fused", order]):
            if tuple(o.shape) != tuple(w.shape) or \
                    not bool(torch.isfinite(o).all()):
                raise AssertionError(f"bad output {tuple(o.shape)}")
            errs.append(scaled_err(o, w)[1])
        same = all(torch.equal(a, b) for a, b in
                   zip(outs, default.apply_batched(coords)))
        log(f"[auto] order {order} served N={coords.shape[0]}: "
            f"max_scaled_err {max(errs):.3e}; per {rows}-row chunk "
            f"{dict(per_chunk)} (plan {dict(plan_launches(cg))}); "
            f"torch.equal to the default artifact: {same}")
        if max(errs) > 1e-4 or per_chunk != plan_launches(cg):
            raise AssertionError(f"auto order {order}: err {max(errs):.3e}, "
                                 f"launches {dict(per_chunk)}")
        for label, art in (("auto", cg), ("default", default)):
            log(f"[auto] order {order} {label} "
                f"(block={art.config.block} "
                f"chunk_blocks={art.config.chunk_blocks}): 4096 rows "
                f"{reading(lambda: art.apply_batched(coords[:4096]), 4096)}"
                f"; N={coords.shape[0]} "
                + reading(lambda: art.apply_batched(coords),
                          coords.shape[0]))

    # blocks other than 8 on the serving path, against float64: every
    # block the search may choose, at orders 1-2
    for order in (1, 2):
        for blk in (16, 32, 64):
            art = P.compile_gradient(f, order, x64, device="cuda",
                                     config=fused_cfg.replace(block=blk))
            errs = [scaled_err(o, w)[1] for o, w in
                    zip(art.apply_batched(coords), want_main["fused", order])]
            log(f"[auto] order {order} block={blk}: max_scaled_err "
                f"{max(errs):.3e}; N={coords.shape[0]} "
                + reading(lambda: art.apply_batched(coords),
                          coords.shape[0]))
            if max(errs) > 1e-4:
                raise AssertionError(f"block {blk} order {order}: err "
                                     f"{max(errs):.3e}")

    # paper Table IV (FIFO depths before / after the optimisation, in
    # blocks of the dataflow model) and the memory accounting, beside the
    # card's peak memory of one served 4,096-row call
    for order in (1, 2, 3):
        for label, conf in (("fused", fused_cfg), ("unfused", unfused_cfg)):
            cg = P.compile_gradient(f, order, x64, config=conf,
                                    device="cuda")
            t0 = time.perf_counter()
            s = cg.dataflow_summary()
            t_sum = time.perf_counter() - t0
            design = s["design"]
            streamed = streaming_peak_bytes(cg.graph, design,
                                            s["fifo"].depths_after,
                                            plan=cg.plan)
            rows = cg.config.chunk_blocks * cg.config.block
            hbm = (region_hbm_bytes_per_block(cg.plan, cg.region_plan, rows)
                   if cg.region_plan is not None else
                   segment_hbm_bytes_per_block(cg.plan, rows))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            cg.apply_batched(coords[:4096])
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            log(f"[table4] order {order} {label}: {len(design.streams)} "
                f"streams, sum of depths {s['sum_depths_before']} -> "
                f"{s['sum_depths_after']} "
                f"({s['depth_reduction'] * 100:.1f}% less), latency peak "
                f"{s['latency_peak']}, before {s['latency_before']}, after "
                f"{s['latency_after']} (dataflow model, block "
                f"{cg.config.dataflow_block}); summary {t_sum:.2f} s")
            log(f"[memory] order {order} {label}: model bytes at the trace "
                f"batch of {cg.plan.batch} rows: buffered_total "
                f"{buffered_total_bytes(cg.graph)}, buffered_peak "
                f"{buffered_peak_bytes(cg.graph)}, streaming_peak "
                f"{streamed}; modelled HBM traffic of one {rows}-row chunk "
                f"{hbm}; "
                f"the card, one 4096-row apply_batched: peak "
                f"{peak} B allocated, {peak - held} B above the "
                f"{held} B held before it")

    # a store round trip of an auto request: no trace, no search
    store_dir = ROOT / "build" / "chip_smoke_auto_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    try:
        P.clear_compile_cache()
        put = P.compile_gradient(f, 1, x64, config="auto", store=store_dir,
                                 device="cuda")
        P.clear_compile_cache()
        t0 = trace.TRACE_CALLS
        s0 = counter("autoconfig_searches").value()
        back = P.compile_gradient(f, 1, x64, config="auto", store=store_dir,
                                  device="cuda")
        traces = trace.TRACE_CALLS - t0
        searches = counter("autoconfig_searches").value() - s0
        same_record = result_as_dict(back.autoconfig) == \
            result_as_dict(put.autoconfig)
        same_out = all(torch.equal(a, b) for a, b in zip(
            back.apply_batched(coords[:4096]),
            put.apply_batched(coords[:4096])))
        log(f"[auto] store round trip (order 1): provenance "
            f"{back.provenance}, {traces} traces, {searches:.0f} searches, "
            f"same result_as_dict: {same_record}, outputs torch.equal: "
            f"{same_out}")
        if traces or searches or not (same_record and same_out) or \
                back.provenance != "store":
            raise AssertionError("the auto store round trip re-traced, "
                                 "re-searched or differs")
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    launches = dict(launches)
    log(f"[launches] phase 8 (config='auto' at orders 1-2: the search with "
        f"its measure hook and the auto artifact's serving): {launches}")
    log(f"[auto] phase 8 took {time.perf_counter() - t_phase:.1f} s")
    if not launches.get("region"):
        raise AssertionError(f"phase 8 launched {launches}")
    return launches


def bank_phase(log, torch, dev, cfg, f, coords, fused_cfg, want, scaled_err,
               device_ms, reading):
    """Phase 9, filter banks and INR editing (the paper's benchmark) on the
    card; returns the launches of the bank path (the INSP bank compiled,
    served on the grid and on one chunk, then the filter library's bank
    compiled and served), the INSP bank and its four heads' weights.  ``want`` is phase 4's float64 order-2 oracle on
    ``coords``: the feature matrix every head reads."""
    from repro_torch.configs.siren import InspConfig
    from repro_torch.core import pipeline as P
    from repro_torch.core import trace
    from repro_torch.core.executor import region_operands
    from repro_torch.inr.filters import filter_bank, filter_head
    from repro_torch.inr.gradnet import num_features
    from repro_torch.inr.insp import insp_apply, insp_head, insp_init
    from repro_torch.kernels import common
    from repro_torch.kernels.region import (plan_region, region_call,
                                           region_call_plain, sm_count)
    from repro_torch.serve import ArtifactStore, BankArtifact, ServingEngine

    t_phase = time.perf_counter()
    order, n = 2, coords.shape[0]
    x64 = coords[:cfg.batch]
    icfg = InspConfig()
    nf = num_features(cfg.in_features, cfg.out_features, order)
    gen = torch.Generator().manual_seed(SEED + 9)
    psis = [insp_init(icfg, nf, cfg.out_features, gen, device=dev)
            for _ in range(4)]
    heads = [insp_head(p) for p in psis]
    feats64 = torch.cat([o.reshape(n, -1) for o in want], -1)
    names = ["identity", "blur", "edge", "laplacian", "sharpen"]

    def held(outs, oracle, label):
        errs = []
        for o, w in zip(outs, oracle):
            if tuple(o.shape) != tuple(w.shape) or \
                    not bool(torch.isfinite(o).all()):
                raise AssertionError(f"{label}: bad output {tuple(o.shape)}")
            errs.append(scaled_err(o, w)[1])
        if max(errs) > 1e-4:
            raise AssertionError(f"{label}: scaled err {max(errs):.3e}")
        return max(errs)

    # the bank path, counted: the INSP bank compiled, the grid and one
    # chunk served, then the filter library compiled and the grid served
    common.reset_launches()
    t0 = time.perf_counter()
    bank = P.compile_bank(f, heads, order, x64, config=fused_cfg,
                          device=dev)
    t_compile = time.perf_counter() - t0
    outs = bank.apply_batched(coords)
    rows = bank.config.chunk_blocks * bank.config.block
    xc = coords[:rows].reshape(bank.config.chunk_blocks, bank.config.block,
                               -1)
    per_chunk = launched_by(common.LAUNCHES,
                            lambda: bank.cg.apply_chunk(xc))
    library = filter_bank(f, names, x64, config=fused_cfg, device=dev)
    lib_outs = library.apply_batched(coords)
    torch.cuda.synchronize()
    launches = dict(common.LAUNCHES)

    r = bank.report
    log(f"[bank] INSP bank (SIREN {cfg.hidden_features} x "
        f"{cfg.hidden_layers}, 4 heads {icfg.hidden} x {icfg.layers}, order "
        f"{order}): compiled in {t_compile:.2f} s; {r.describe()}")
    log(f"[bank] {bank.cg.region_plan.describe().splitlines()[0]}; "
        f"dispatch {[k for _, _, k in bank.dispatch]}")
    if (r.dispatches_bank, r.dispatches_loop) != (1, 4) or \
            not r.nodes_bank < r.nodes_loop:
        raise AssertionError(f"bank report {r}")

    # the merged region against its plain version at R = 8 and 512
    plan = bank.plan
    (kind, region), = bank.cg.region_plan.units()
    errs = []
    for R in (8, 512):
        st, rws, res, out_info = region_operands(
            plan, region, {plan.inputs[0]: coords[3000:3000 + R]},
            bank.cg.residents, R, plan.batch)
        got = region_call(region.spec, st, rws, res, out_info)
        ref = region_call_plain(region.spec, st, rws, res, out_info)
        torch.cuda.synchronize()
        errs += [scaled_err(a, b)[1] for a, b in zip(got, ref)]
        prog = plan_region(region.spec, tuple(a.shape[1] for a in st),
                           tuple(a.shape[1] for a in rws),
                           tuple(tuple(a.shape) for a in res), R, 1,
                           sm_count(0))
        t = device_ms(lambda: region_call(region.spec, st, rws, res,
                                          out_info), 20)
        log(f"[bank] merged region R={R}: {len(region.spec.steps)} steps, "
            f"{len(region.outputs)} outputs, C={prog.cluster}, "
            f"{prog.smem_bytes} B of shared memory per CTA "
            f"({prog.describe()}); {t} ms/launch on the device; scaled err "
            f"against region_call_plain {max(errs):.3e}")
    if max(errs) > 1e-4:
        raise AssertionError(f"merged region: scaled err {max(errs):.3e}")

    # the grid against float64, head by head, and bit for bit against each
    # head's single-head bank
    oracle = [insp_apply([{k: v.double() for k, v in p.items()}
                          for p in psi], feats64) for psi in psis]
    err = held(outs, oracle, "INSP bank")
    solos = [P.compile_bank(f, [h], order, x64, config=fused_cfg,
                            device=dev) for h in heads]
    same = [torch.equal(o, s.apply_batched(coords)[0])
            for o, s in zip(outs, solos)]
    log(f"[bank] grid {n} rows: max scaled err {err:.3e} against float64; "
        f"outputs torch.equal to the single-head banks: {same}; one "
        f"{rows}-row chunk launched {dict(per_chunk)} (the plan's units "
        f"{dict(plan_launches(bank.cg))})")
    if not all(same) or per_chunk != plan_launches(bank.cg):
        raise AssertionError("the bank differs from its single-head banks "
                             "or a chunk launched other than its units")
    log(f"[bank] {n} rows: bank {reading(lambda: bank.apply_batched(coords), n)}; "
        f"four single-head banks "
        f"{reading(lambda: [s.apply_batched(coords) for s in solos], n)}")

    # the filter library against float64 of its closed forms
    lib_oracle = [filter_head(nm, cfg.in_features, cfg.out_features)(feats64)
                  for nm in names]
    err = held(lib_outs, lib_oracle, "filter library")
    log(f"[bank] filter library {names}: units "
        f"{[k for _, _, k in library.cg.dispatch]}; grid max scaled err "
        f"{err:.3e} against float64; "
        f"{reading(lambda: library.apply_batched(coords), n)}")

    # the engine: bank and plain requests mixed (one bank group), then a
    # fresh engine restoring the bank from a store by signature
    store_dir = ROOT / "build" / "chip_smoke_bank_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    try:
        ids = [f"insp{j}" for j in range(4)]
        eng = ServingEngine(ArtifactStore(str(store_dir)), device=dev)
        sig = eng.register_bank(ids, BankArtifact(bank, ids))
        plain = P.compile_gradient(f, order, x64, config=fused_cfg,
                                   device=dev)
        eng.register("siren", plain)
        parts = [coords[:1000], coords[1000:1500], coords[2000:2700],
                 coords[5000:5013]]
        res = eng.serve([("insp1", parts[0]), ("siren", parts[1]),
                         ("insp0", parts[2]), ("insp1", parts[3])])
        full = bank.apply_batched(torch.cat([parts[0], parts[2], parts[3]]))
        ok = (torch.equal(res[0][0], full[1][:1000])
              and torch.equal(res[2][0], full[0][1000:1700])
              and torch.equal(res[3][0], full[1][1700:1713])
              and all(torch.equal(a, b) for a, b in
                      zip(res[1], plain.apply_batched(parts[1]))))
        log(f"[bank] engine: 4 requests (3 bank, 1 plain), stats groups "
            f"{eng.stats['groups']}, bank_groups "
            f"{eng.stats['bank_groups']}; outputs torch.equal: {ok}")
        if not ok or eng.stats["bank_groups"] != 1:
            raise AssertionError("the engine's bank routing differs")
        traces = trace.TRACE_CALLS
        eng2 = ServingEngine(ArtifactStore(str(store_dir)), device=dev)
        eng2.register_bank(ids, signature=sig)
        back = eng2.serve([(i, coords[:4096]) for i in ids])
        ok = all(torch.equal(b[0], o[:4096]) for b, o in zip(back, outs))
        log(f"[bank] store restore by signature: {trace.TRACE_CALLS - traces} "
            f"traces, {eng2.stats['restores']} restores, outputs "
            f"torch.equal: {ok}")
        if trace.TRACE_CALLS != traces or not ok or \
                eng2.stats["restores"] != 1:
            raise AssertionError("the bank's store restore re-traced or "
                                 "differs")
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    log(f"[launches] phase 9 (compile_bank -> apply_batched, the filter "
        f"library's bank): {launches}")
    log(f"[bank] phase 9 took {time.perf_counter() - t_phase:.1f} s")
    if not (launches.get("region") and launches.get("fused_chain")):
        raise AssertionError(f"phase 9 launched {launches}")
    return launches, bank, psis


def async_phase(log, torch, dev, cfg, f, params, fleet, bank, psis, coords,
                fused_cfg, unfused_cfg, oracle, scaled_err, reading):
    """Phase 10: the async serving engine, drift telemetry and codegen on
    phase 4's SIREN, phase 5's fleet (``fleet``: its K weight sets, lane 0
    ``params``) and phase 9's INSP bank (``bank``, its heads' ``psis``).
    Returns the launches of the async engine's counted run and of the drift
    reports."""
    import copy
    import gc
    import importlib.util

    import numpy as np

    from repro_torch.core import codegen, dataflow
    from repro_torch.core.pipeline import compile_gradient
    from repro_torch.inr.insp import insp_apply
    from repro_torch.kernels import common
    from repro_torch.obs import TRACER, REGISTRY, build_perf_model, \
        drift_report
    from repro_torch.serve import (ArtifactStore, AsyncServingEngine,
                                   BankArtifact, ServingEngine, bind_weights)

    t_phase = time.perf_counter()
    x64 = coords[:cfg.batch]
    cgs = {o: compile_gradient(f, o, x64, config=fused_cfg, device=dev)
           for o in (1, 2, 3)}
    fleet_ids = [f"fleet{k}" for k in range(len(fleet))]
    bank_ids = [f"insp{j}" for j in range(len(psis))]
    targets = fleet_ids + ["siren1", "siren3"] + bank_ids

    # the stream: ~10^5 rows in requests of 1-3,000 rows, every target at
    # least once, made from a seed; the coordinates live on the card
    rng = np.random.default_rng(SEED + 10)
    n_req = 80
    sizes = rng.integers(1, 3001, n_req)
    who = np.concatenate([rng.permutation(len(targets)),
                          rng.integers(0, len(targets),
                                       n_req - len(targets))])
    gen = torch.Generator().manual_seed(SEED + 10)
    rows = (torch.rand(int(sizes.sum()), 2, generator=gen) * 2 - 1).to(dev)
    stream, at = [], 0
    for n, t in zip(sizes.tolist(), who.tolist()):
        stream.append((targets[t], rows[at:at + n]))
        at += n
    total = at

    store_dir = ROOT / "build" / "chip_smoke_async_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    try:
        store = ArtifactStore(str(store_dir))
        base = cgs[2]

        def build(engine):
            engine.register(fleet_ids[0], base)
            for k in range(1, len(fleet)):
                if not store.has(base.signature, fleet_ids[k]):
                    store.put_weights(base.signature, fleet_ids[k],
                                      bind_weights(base, params, fleet[k]))
                engine.register(fleet_ids[k], signature=base.signature,
                                weight_id=fleet_ids[k])
            engine.register("siren1", cgs[1])
            engine.register("siren3", cgs[3])
            engine.register_bank(bank_ids, BankArtifact(bank, bank_ids))
            return engine

        sync = build(ServingEngine(store, device=dev))
        asyn = build(AsyncServingEngine(store, device=dev))
        # a first pass of each uploads every launch shape's program and
        # builds the resident row blocks (one-time host copies)
        want = sync.serve(stream)
        asyn.serve_async(stream)
        torch.cuda.synchronize()

        # the async path, counted, with any host sync raising
        common.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = asyn.serve_async(stream)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        launches = dict(common.LAUNCHES)
        same = all(len(w) == len(g) and all(torch.equal(a, b)
                                            for a, b in zip(w, g))
                   for w, g in zip(want, got))
        log(f"[async] stream: {n_req} requests, {total} rows over "
            f"{len(targets)} targets (fleet K={len(fleet)} order 2, SIREN "
            f"orders 1 and 3, {len(bank_ids)} bank filters); serve_async "
            f"under set_sync_debug_mode('error'): no host sync; outputs "
            f"torch.equal to sync serve: {same}; launches {launches}")
        if not same:
            raise AssertionError("serve_async differs from sync serve")
        need = ["region", "region_stacked", "fused_chain"]
        if not all(launches.get(k) for k in need):
            raise AssertionError(f"async path launched {launches}, needs "
                                 f"{need}")

        # every target's rows against its float64 oracle
        by_target = collections.defaultdict(list)
        for i, (t, _) in enumerate(stream):
            by_target[t].append(i)
        worst = {}
        for t, idx in by_target.items():
            x = torch.cat([stream[i][1] for i in idx])
            outs = [torch.cat(col) for col in zip(*(got[i] for i in idx))]
            if t.startswith("fleet"):
                ref = oracle(x, 2, weights=fleet[int(t[5:])])
            elif t.startswith("siren"):
                ref = oracle(x, int(t[5:]))
            else:
                feats = torch.cat([o.reshape(x.shape[0], -1)
                                   for o in oracle(x, 2)], -1)
                psi = [{k: v.double() for k, v in p.items()}
                       for p in psis[int(t[4:])]]
                ref = [insp_apply(psi, feats)]
            if [tuple(o.shape) for o in outs] != \
                    [tuple(r.shape) for r in ref]:
                raise AssertionError(f"{t}: output shapes differ")
            worst[t] = max(scaled_err(o, r)[1] for o, r in zip(outs, ref))
        log(f"[async] max scaled err against float64 by target: "
            + ", ".join(f"{t} {e:.2e}" for t, e in worst.items()))
        if max(worst.values()) > 1e-4:
            raise AssertionError(f"async outputs: scaled err "
                                 f"{max(worst.values()):.3e} > 1e-4")

        log(f"[async] {total} rows: sync serve "
            f"{reading(lambda: sync.serve(stream), total)}; serve_async "
            f"{reading(lambda: asyn.serve_async(stream), total)}")

        # part of the stream submitted, full chunks dispatched before the
        # drain, then the rest
        def dispatched():
            st = asyn.stats
            return (st["async_chunks"] + st["async_multi_chunks"]
                    + st["bank_groups"])
        half = len(stream) // 2
        d0 = dispatched()
        for t, x in stream[:half]:
            asyn.submit(t, x)
        early = dispatched() - d0
        for t, x in stream[half:]:
            asyn.submit(t, x)
        late = asyn.drain()
        same = all(all(torch.equal(a, b) for a, b in zip(w, g))
                   for w, g in zip(want, late))
        log(f"[async] submit/drain: {early} chunks dispatched before the "
            f"drain from the first {half} requests; outputs torch.equal to "
            f"sync serve: {same}")
        if not (same and early):
            raise AssertionError("submit/drain differs or dispatched "
                                 "nothing before the drain")

        st, label = asyn.stats, asyn.stats.labels["engine"]
        lat = {name: REGISTRY.get(name).summary(engine=label)
               for name in ("serve_queue_wait_latency_s",
                            "serve_request_latency_s")}
        log(f"[async] engine: max_inflight {st['max_inflight']} (inflight "
            f"{asyn.inflight}), host_unpad_s {st['host_unpad_s']:.4f}, "
            f"chunks {st['async_chunks']}, blocks {st['async_blocks']}, "
            f"multi-chunks {st['async_multi_chunks']}, bank groups "
            f"{st['bank_groups']}, admissions {st['admissions']}, evictions "
            f"{st['evictions']}; "
            + "; ".join(f"{n} p50 {v['p50'] * 1e3:.3f} ms p95 "
                        f"{v['p95'] * 1e3:.3f} ms p99 {v['p99'] * 1e3:.3f} "
                        f"ms over {v['count']}" for n, v in lat.items()))
        if not 1 <= st["max_inflight"] <= asyn.inflight:
            raise AssertionError(f"max_inflight {st['max_inflight']}")

        # telemetry overhead: serve_async with the tracer on and off, each
        # round timed with the garbage collector off after a collection
        # (as timeit does), so a collection lands in neither. A round's
        # host wall on a shared host drifts by 10-20% for seconds at a
        # time, more than the bound, so the min is taken over
        # TELEMETRY_PAIRS pairs and each pair alternates which setting runs
        # first. The heap is frozen after one full collection, so each
        # round's collection scans only what the rounds made
        on, off = [], []
        gc.collect()
        gc.freeze()
        for r in range(TELEMETRY_PAIRS):
            pair = ((False, off), (True, on))
            for enabled, acc in (pair if r % 2 == 0 else pair[::-1]):
                TRACER.enable() if enabled else TRACER.disable()
                gc.collect()
                gc.disable()
                try:
                    t0 = time.perf_counter()
                    asyn.serve_async(stream)
                    acc.append(time.perf_counter() - t0)
                finally:
                    gc.enable()
        gc.unfreeze()
        spans = len(TRACER.events)
        TRACER.disable()
        TRACER.clear()
        t_on, t_off = min(on), min(off)
        log(f"[async] telemetry: serve_async wall {t_on * 1e3:.2f} ms with "
            f"the tracer on ({spans} spans in {TELEMETRY_PAIRS} rounds) vs "
            f"{t_off * 1e3:.2f} ms off, min of {TELEMETRY_PAIRS} interleaved "
            f"pairs (bound: 5% + 5 ms); medians "
            f"{sorted(on)[len(on) // 2] * 1e3:.2f} ms on, "
            f"{sorted(off)[len(off) // 2] * 1e3:.2f} ms off; rounds on "
            + " ".join(f"{t * 1e3:.1f}" for t in on) + " ms, off "
            + " ".join(f"{t * 1e3:.1f}" for t in off) + " ms")
        if t_on > t_off * 1.05 + 0.005:
            raise AssertionError(f"telemetry overhead {t_on / t_off:.3f}x")
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)

    # drift: each unit of one block timed with CUDA events, analytic row
    # costs, then the card's calibrated ones (results/torch_op_row_cost.json)
    arts = [("fused order 1", cgs[1]), ("fused order 2", cgs[2]),
            ("unfused order 1", compile_gradient(f, 1, x64,
                                                 config=unfused_cfg,
                                                 device=dev))]
    xblk = coords[3000:3000 + fused_cfg.block]
    common.reset_launches()

    def report(label, cg, costs):
        rep = drift_report(cg, xblk, iters=7, warmup=2)
        units = ", ".join(f"{u.name} {u.measured_s * 1e3:.4f} ms drift "
                          f"{u.drift:.2f}" for u in rep.units)
        log(f"[drift] {label} ({costs} row costs): {len(rep.units)} units "
            f"on {rep.meta['backend']}: {units}; max drift "
            f"{rep.max_drift:.2f}, min FIFO headroom {rep.min_headroom}")
        if rep.min_headroom < 0:
            raise AssertionError(f"{label}: FIFO headroom "
                                 f"{rep.min_headroom}")

    for label, cg in arts:
        report(label, cg, "analytic")
    try:
        table = dataflow.load_op_row_cost(ROOT / "results" /
                                          "torch_op_row_cost.json")
        mm_per_k = dataflow.MM_ROW_COST_PER_K
        for label, cg in arts:
            cal = copy.copy(cg)
            cal.perf_model = build_perf_model(cg.plan, cg.region_plan,
                                              cg.config)
            report(label, cal, "calibrated")
    finally:
        dataflow.reset_op_row_cost()
    torch.cuda.synchronize()
    launches_drift = dict(common.LAUNCHES)
    log(f"[drift] calibrated table {table}, mm per K {mm_per_k:.4g}; "
        f"launches {launches_drift}")
    if not all(launches_drift.get(k) for k in
               ("region", "fused_chain", "stream_matmul", "siren_layer")):
        raise AssertionError(f"drift launched {launches_drift}")

    # codegen: the emitted torch module on the card against the executor
    for order in (1, 2):
        cg = cgs[order]
        run, _ = codegen.load_generated(cg.source)
        x = coords[:cg.plan.batch]
        out = run(codegen.graph_consts(cg.graph, cg.plan, device=dev), x)
        err = max(scaled_err(a, b)[1] for a, b in zip(out, cg.apply(x)))
        log(f"[codegen] order {order}: {len(cg.source.splitlines())} lines, "
            f"exec-loaded on the card, {len(out)} outputs within "
            f"{err:.2e} (scaled) of the executor")
        if err > 1e-5:
            raise AssertionError(f"codegen order {order}: scaled err "
                                 f"{err:.3e}")

    # the calibration itself, as scripts/torch_row_cost_calibrate.py runs it
    spec = importlib.util.spec_from_file_location(
        "torch_row_cost_calibrate",
        ROOT / "scripts" / "torch_row_cost_calibrate.py")
    calib = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(calib)
    res = calib.calibrate(rows=4096)
    log(f"[calibrate] rows=4096: {res['op_row_cost']}, mm per K "
        f"{res['mm_row_cost_per_k']:.4g}, host-to-device "
        f"{res['xshard_row_cost']} (Add {res['meta']['unit_s_per_row'] * 1e9:.3f} "
        f"ns/row); analytic {dataflow._ANALYTIC_OP_ROW_COST}")
    log(f"[async] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return launches, launches_drift


if __name__ == "__main__":
    sys.exit(main())
