#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --rmsnorm-sweep [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --rmsnorm-bwd-sweep [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --rmsnorm-bwd-profile
    python3 chip_smoke.py --decode-sweep
    python3 chip_smoke.py --decode-profile ARCH [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --sharded

Phases, each of which must pass or the script exits non-zero:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build of every kernel in src/repro_torch/csrc/ with nvcc (sm_90a): the
     registers of each rmsnorm instantiation and which spill (ptxas -v), and
     from `cuobjdump -sass` the count of HGMMA (wgmma), UTMALDG (TMA load)
     and LDGSTS (cp.async) instructions per kernel; the bf16 and f16 flash
     kernels must hold HGMMA and UTMALDG at every head dim (16, 32, 64, 112
     and 128); for each instantiation of rmsnorm's backward its registers,
     spills (none may spill) and F2F.F64 (f32 to f64 conversion) count, and
     every vector instantiation must hold UBLKCP (the TMA bulk copy of its
     ring);
  3. each kernel against its plain PyTorch version on the card, f32 (2e-5)
     and bf16 (2e-2), at the CPU tests' shapes and the main paths' (for
     rmsnorm also both sides of each regime of `rmsnorm_plan`, wider rows
     up to nemotron-4-15b's d = 6144 and zamba2-7b's Mamba2 d_inner 7168,
     phase 7's training steps at 2048 rows of d = 1024, 2048, 3584, 4096
     and 7168,
     and the scalar instantiation: a misaligned gamma, rows d + 1 apart,
     d = 37; for decode G = 1 to 24, head groups, splits, dh = 112 and
     enc-dec cross decode over a padded cross cache; for flash G = 16,
     windows, dh = 112, non-causal, Sq != Sk, and one rank's block of
     query rows at its `q_offset`: 128 rows of a 2048-token prefill at
     offsets 0, 896 and 1920, llama2-7b's and glm4-9b's heads and a window
     of 512); then a timer-floor line
     (the timer around a launch that does no work), and at the main paths'
     shapes (llama2-7b, glm4-9b, d = 6144, the moe paths': mixtral-8x22b's
     G = 6 with window 4096, llama4-scout's G = 5 and d = 5120; zamba2-7b's
     dh = 112 and d = 3584 / 7168, xlstm-1.3b's d = 2048, seamless-m4t's
     encoder, cross attention and cross decode; the last of 16 ranks' rows
     of llama2-7b's 2048-token prefill, against SDPA with a boolean mask for
     the same rows) the kernel's time
     (with the plan rmsnorm_plan chose), the plain version's, one PyTorch
     library call's (yardstick only) and the least time the card could take
     (bytes at 3.35 TB/s or flops at the dtype's dense peak); and rmsnorm's
     backward kernel (`rmsnorm_bwd`: dx and dgamma) against `ref.rmsnorm_bwd`
     in f32, bf16 and f16 at the CPU tests' shapes, the training step's
     (2048, 4096), rows around its grid, the trained widths (d = 1024 to
     12288: 1024, 2048, 3584 and 7168 are phase 7's seamless-m4t, xlstm
     and zamba2 widths), 8192 rows, d = 16384 (one ring stage in f32), d =
     37 and the scalar path, two launches bit-equal, one device kernel a
     call (the profiler's count), timed at (2048, d) bf16 for d = 1024 to
     12288,
     (8192, 4096) bf16 and (64, 4096) f32 beside the forward plus backward
     of `F.rms_norm` through autograd less its forward. Times are medians
     of 20 calls, printed with their min and max;
  4. models on the card (kernels) against the same weights on the CPU (plain
     path), f32, logits within 2e-3 and greedy tokens equal: the smoke size
     of every dense and vlm arch (seeded non-zero QKV biases and gammas),
     tied embeddings, iRoPE, a ring cache under `window_override`, the moe
     smoke archs (mixtral-8x22b top-2 with a window, llama4-scout top-1 with
     iRoPE, mixtral at capacity factor 0.5, which drops picks, and under
     einsum dispatch), the hybrid, ssm and enc-dec smoke archs (zamba2-7b,
     zamba2 with a remainder group, zamba2 at dh = 112, xlstm-1.3b, xlstm
     with two groups, seamless-m4t with shorter encoder prompts than
     enc_len),
     glm4-9b at full width cut to 2 layers (G = 16, vocab 151552),
     mixtral-8x22b at full width cut to 1 layer (capacity factor 1.25),
     zamba2-7b at full width cut to 7 layers (dh = 112 in the f32 kernels)
     and seamless-m4t at full width cut to 2 + 2 layers; where a pick of the
     router differs between card and CPU, the check names the token and the
     experts; then one f32 train step, remat on, the same weights on the
     card and the CPU, of each of llama2-7b (2 layers, batch 2 x 64),
     zamba2-7b (7 layers: one group of 6 and a remainder layer, 256 tokens
     in one chunk of the default mamba_chunk 256, where the decay's
     exponent overflows above the diagonal), xlstm-1.3b (one group of 7
     mLSTM + 1 sLSTM, 64 tokens) and seamless-m4t (2 + 2 layers, batch 2 x
     64), all at full width: the rmsnorm and rmsnorm_bwd launches
     `train_step_launches` derives and no attention kernel, the loss within
     2e-3, every gradient leaf finite and within 2e-4 of its largest
     magnitude, and the losses of the AdamW steps (3 for llama2-7b, 1 for
     the others) within 2e-3;
  5. the main paths at full width and depth (glm4-9b at 10 of 40 layers),
     bf16, random weights from a seed, each with the launch counts set to 0
     just before it: llama2-7b
     and glm4-9b calibrated with `measure_service_time` (15/15 and 512/64),
     then served through `InferenceEngine` under `ICCServer` (priority and
     fifo) over a Poisson trace, then a profile of a batch-8 decode step and
     of a batch-1 step over a ~560-slot cache (device-busy and kernel ms per
     step, and for moe the routing's: router product, softmax, top-k,
     cumsum, scatter and gather); nemotron-4-15b calibrated at 15/15;
     mixtral-8x22b (8 of its 56 layers: all 56 need ~282 GB) served and
     profiled as glm4-9b, with a 576-slot cache under its 4096 window;
     llama4-scout (8 of 48 layers) calibrated at 15/15; zamba2-7b (13 of
     81 layers: 2 groups and a remainder layer) served and profiled as
     llama2-7b; xlstm-1.3b (24 of 48 layers)
     calibrated at 15/15 and profiled; seamless-m4t (24 + 24 layers)
     through `InferenceEngine(enc_len=15)` at batch 1 and 8, and profiled.
     Every kernel's launch count must be what the prefills and decode
     steps the path ran predict for its family (`per_forward`: 2L + 1
     rmsnorm and L attention a forward for dense and moe, 2L + 2 ng + 1 and
     ng for zamba2's ng shared-block applications, 2L + 1 and none for
     xlstm, 2 Le + 3 L + 2 and Le + 2 L flash a prefill, 3 L + 1 and 2 L
     decode a step for enc-dec);
  6. the paper's Fig. 6 on the port's slot simulator (`core`, host code):
     `sweep` + `capacity_from_sweep` for the three schemes (ICC,
     disjoint_ran, disjoint_mec), serially, under the analytic H100 service
     time at b_total = 80 ms, then under llama2-7b's measured service time
     (`MeasuredService` on phase 5's 15/15 calibration, whose kernel
     launches phase 5 counts) at 80 ms and at the budget scaled by k =
     service / the paper's 11.43 ms, each at Fig. 6's sim_time of 30 s and
     3 seeds. It prints each run's service time per job, satisfaction
     curves with the jobs scored at each rate and the spread across seeds,
     capacities (interpolated across one UE of 1 prompt/s) and ICC/MEC
     beside the card line, and checks that every sweep point scored a job,
     every satisfaction lies in [0, 1], every capacity is finite and no
     larger than the largest rate swept, and that the measured callable
     gives prefill + decode at 15/15. Capacities are findings, not checks.
     Then ICC on the measured service at the scaled budget, at the whole-UE
     rate nearest its capacity there, 3 seeds (`faults_and_controllers`):
     fault-free, an empty `FaultSpec()`, three one-second node outages and
     a brownout with the lost jobs redispatched and dropped, and each
     controller preset (static, reactive, slack_aware_joint), printing
     satisfaction and drops by reason; it checks that the static preset
     and the empty spec leave every field of the result as the plain run's,
     every satisfaction in [0, 1], and that with redispatch off the crashes
     drop at least one job with reason node_failure;
  7. training at full width, bf16, batch 4 x 512, remat on, AdamW at lr
     3e-4 from `Model.init(seed=0)`, on `SyntheticLM` through `train_loop`
     with the launch counts set to 0 just before each run: llama2-7b, 16 of
     its 32 layers (3.50 B parameters, 42 GB of weights, gradients and
     moments), 10 steps; zamba2-7b, 39 of its 81 layers (6 groups of 6
     Mamba2 layers and the shared block, 3 remainder layers; ~3.47 B),
     xlstm-1.3b, 16 of its 48 layers, and seamless-m4t, 24 + 24 layers
     (~2.0 B, vocab 256206), 5 steps each, each model freed before the
     next: wall time a step (synchronised) split into forward + backward
     and the optimizer beside its bound (model flops at 989 TFLOP/s plus
     AdamW's 22 bytes a parameter at 3.35 TB/s), tokens/s, the model-flop
     share of 989 TFLOP/s, peak device memory, and a profiled step's
     device-busy share by kernel group. Before each run the first batch's
     bf16 loss and gradient against f32's on the same weights on the card
     (`bf16_against_f32`: the loss within 0.05 and, for the attention
     stacks llama2-7b and seamless-m4t, each part's cosine >= 0.99 and the
     norm within 5%; the recurrent stacks' cosines are printed). It checks
     every loss and gradient norm finite, the last loss below the first,
     the launches a step (`train_step_launches`, from
     `model.rmsnorm_calls`: the forward's norms, again those remat
     recomputes, one rmsnorm_bwd a forward norm; no attention kernel:
     training takes naive attention, neither package has a flash
     backward), and a checkpoint round trip on the card (llama2-7b smoke,
     bf16, through `train_loop`: the restored state bit-equal to the saved
     one, the resumed run's losses and weights equal to a straight run's);
  8. the dry run (`launch.dryrun`, host only: meta tensors, nothing
     computed, nothing on the card) of every assigned arch and llama2-7b x
     train_4k, prefill_32k, decode_32k and long_500k in a spawned pool, one
     line a case (peak memory and its parts, whether it fits one card, dot
     flops, the roofline terms under `launch.roofline.H100`; every
     prefill_32k and xlstm-1.3b's train_4k at a quarter depth, `grid_cut`):
     every case ok but seamless-m4t x long_500k, the documented skip; and in the same
     pool steps on the 16 x 16 production mesh, each run as DTensors on
     meta tensors over a fake process group of 256 ranks and counted on
     one device (`DRYRUN_MESH_CASES`: one arch a family x train_4k,
     prefill_32k and decode_32k at full width, the depth cut where a case
     would take minutes; `DRYRUN_MESH_FLAGS`: each of the reference's nine
     `--rules` overrides and both `--moe-dispatch` values once on a
     full-size case, context-parallel sets with `--attn-seq-shard`, and
     llama4-scout-17b-a16e's train_4k under `train_ep_cp`, whose 40 heads
     divide no 16-way "model") and on
     the 2 x 16 x 16 one over 512 ranks (`DRYRUN_MULTI_CASES`: every
     assigned arch's decode_32k, one step a family at cut depth, one
     long_500k), one line a case with the peak and its parts, dot flops, the collective
     bytes by class and the dominant term, every case ok (`--all --mesh
     both` runs in a call of its own). Then it holds the dry run against
     the card: each of phase 7's four configs counted the same way, its
     peak within 10% of the run's measured `max_memory_allocated` and,
     for llama2-7b and seamless-m4t, its dot flops within 2% of
     `train_reckoning`'s issued flops (zamba2 and xlstm printed: the
     counter also sees the recurrences' own products); each of phase 10's
     six sharded training steps counted on the card's (1, 1) mesh, its
     peak within 10% of phase 10's measured `max_memory_allocated`; and
     `H100.hbm_bytes` within 1% of the card's `total_memory`;
  9. the experiments layer (`experiments/`, `telemetry/report.py`; host
     code, numpy) over the multi-cell network and the batched fleet
     (`network/`, `batching/`), run after phase 5 while phase 6 runs in the
     script's own process (no phase on the card runs meanwhile). In one
     spawned child, so that no forked worker inherits a CUDA context,
     `run_suite("bench_all")` (what `python -m repro_torch.experiments
     suite run bench_all` runs) regenerates the four tracked studies at
     their own sizes into a temporary root with a fresh result cache, in a
     pool of one process a core but one and one shard a point: 652 points,
     BENCH_network.json (4 policies x 17 rates x 3 seeds, 6 s),
     BENCH_batching.json (a100, h100 and l4 x max_batch 1/4/8/16 on
     `BatchedComputeNode`, 30 s), BENCH_control.json (ten arms) and
     BENCH_resilience.json (6 arms x 9 rates x 2 seeds, 8 s). Its runlog
     must show every shard end in a pool worker, never in the child (a pool
     that cannot start runs serially there, which fails the phase). Each
     document must equal the tracked file in every key but the headline's
     wall clocks and the result's timing fields (`to_canonical_dict`)
     within 1e-12; each mobility run must hand a UE over. The suite again
     from the same cache: every point a hit, the same bytes. Then
     `validate_bench` on the regenerated files (no problem) and
     `generate_report` of each against its tracked file (every capacity
     delta +0.00, every satisfaction delta +0.000); the points, pool and
     seconds of each study are printed. Then faults and controllers on the
     network at 148 jobs/s, run in a second spawned child while the suite
     runs (fast=False, an empty `FaultSpec()` and the
     static preset must equal the plain run field for field, a MEC
     backhaul outage plus a RAN node crash must drop or redispatch a job;
     route shares, epochs, rejections and drops by reason printed for each
     preset). Last, the network's analytic H100 tier (`LatencyModel(H100,
     LLAMA2_7B, "extended")`) against phase 5's llama2-7b on the card: its
     decode step at batch 1 and 8 and its 15-token prefill, and the KV
     budget for rag_doc_qa jobs against what the card has free once the
     bf16 weights are on it (printed; finite and positive are the checks);
 10. sharded serving, run after phase 5 (`phase_sharded`): first every op
     of the sharded paths (DTENSOR_OPS) must have a DTensor sharding rule
     in this torch; then llama2-7b at full width and depth (15 greedy
     steps), mixtral-8x22b (8 of 56 layers), zamba2-7b, xlstm-1.3b and
     seamless-m4t-large-v2 (4 steps each) at full width, bf16, seed 0,
     each unsharded and then under `sharding.use_mesh` on a (1, 1)
     ("data", "model") mesh over an NCCL process group of one rank on a
     local HashStore: the parameters distributed once as DTensors, prefill
     of a 15-token prompt (seamless: and 15 encoder frames) at batch 8
     (twice: cold, then warm) under PREFILL_RULES, the greedy decode steps
     under DECODE_RULES, each kernel on its local shards through
     `local_map`, the recurrences and moe routing each in one `run_local`.
     Greedy tokens must equal the unsharded run's on the same weights and
     so must every logit (SHARDED_LOGIT_TOL = 0: on one rank each shard is
     the whole tensor), rmsnorm, flash and decode must launch what each run
     predicts under the mesh (counts set to 0 just before it); the largest
     logit difference and the sharded and unsharded prefill and
     decode-step walls are printed for each arch. Then sharded training
     (`sharded_train_run`): llama2-7b (4 layers), qwen2-vl-72b (1 layer,
     embeds in), mixtral-8x22b (1 layer, all 8 experts, aux losses),
     zamba2-7b (7: a Mamba2 group, the shared block, a remainder layer),
     xlstm-1.3b (8: one group) and seamless-m4t (2 + 2) at full width,
     bf16, remat, the stream's first batch of 2 x 256 tokens: the loss and
     gradients and one AdamW step (`make_train_step`) from
     `Model.init(seed=0)` unsharded, then the same from the weights drawn
     again under TRAIN_RULES on the same mesh (`Model.distribute_params` of
     parameters that require grad): the loss, every gradient leaf and every updated
     parameter must equal the unsharded step's (SHARDED_TRAIN_TOL = 0; a
     leaf that differs is named and held to SHARDED_TRAIN_BAR, 2e-2 of its
     largest value), the sharded step's rmsnorm and rmsnorm_bwd launches
     must be `train_step_launches`'s, and the two step walls are printed.
     Last, context parallelism under TRAIN_RULES_EP_CP with `attn_seq_shard`
     (`cp_prefill_run`, CP_TRAIN): llama2-7b's prefill (8 layers, 2 x 512
     tokens), its logits and every kernel's launches equal to the unsharded
     run's, and one AdamW step of llama4-scout-17b-a16e (1 layer: 40 heads,
     16 experts) held as the steps above.

With --rmsnorm-sweep it only builds the kernels and times rmsnorm's CTA
shapes against `F.rms_norm` (`rmsnorm_sweep`), where the regimes' threshold
in `kernels/rmsnorm.py` comes from; --src times another checkout's package
with the same timer, such as the parent commit unpacked by `git archive`.
With --rmsnorm-bwd-sweep it only builds the kernels, prints each backward
instantiation's F2F.F64 conversions from the SASS, and times the backward's
plans (threads per CTA and ring stages) against `F.rms_norm`'s backward
(`rmsnorm_bwd_sweep`), where `rmsnorm_bwd_plan`'s caps come from; --src
times another checkout's wrapper with the same timer. With
--rmsnorm-bwd-profile it builds a copy of the backward with clock reads at
its phase boundaries and prints where a call's time goes
(`rmsnorm_bwd_profile`).
With --sharded it only builds the kernels and runs phase 10 (sharded serving,
training and context parallelism).
With --decode-sweep it only builds the kernels and times decode_attention at
each head-group size against SDPA (`decode_sweep`), where `head_groups`'s
rule in `kernels/decode_attention.py` comes from. With --decode-profile ARCH
it only builds the kernels and profiles ARCH's decode steps at full width and
depth, bf16, seed 0 (`profile_decode`, as phase 5); --src profiles another
checkout's package, for before/after rows in one call.

Before the last line it prints the card line and one JSON line
{"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the card's peaks: `repro_torch.launch.roofline.H100`, read in main() once the
# package is importable (3.35 TB/s; dense tensor-core bf16, f32 FMA)
HBM_BYTES_PER_S = None
PEAK_FLOPS = {}
TOLS = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-2}  # f16: bf16's bound
# rmsnorm: the CPU tests' shapes, the main path's, rows around 132 SMs and
# around rmsnorm_plan's regime threshold (4 rows per SM), wider rows (d_model
# of 13B- and 70B-class models), and phase 7's training steps (2048 rows, the
# many-rows plan) at every trained width
RMSNORM_SHAPES = [(8, 128), (3, 37, 64), (1, 256), (15, 4096), (512, 4096), (8, 4096),
                  (1, 4096), (131, 4096), (132, 4096), (133, 4096), (528, 4096), (529, 4096),
                  (8192, 4096), (8, 5120), (600, 5120), (8, 8192), (600, 8192),
                  (8, 6144), (15, 6144), (8192, 6144),  # nemotron-4-15b's d_model
                  # zamba2-7b's blocks and Mamba2 inner norm, xlstm-1.3b's blocks and
                  # mLSTM inner norm, seamless-m4t's d_model
                  (8, 3584), (512, 3584), (8, 7168), (512, 7168), (8, 2048), (15, 4096),
                  (8, 1024), (512, 1024),
                  (2048, 1024), (2048, 2048), (2048, 3584), (2048, 4096), (2048, 7168)]
# rmsnorm's backward: the CPU tests' shapes, the training step's (2048, 4096)
# and (64, 4096), rows around its grid (one and two CTAs per SM: 132 and 264
# on 132 SMs) and around the forward plan's regime threshold (528), d = 37,
# nemotron-4-15b's d = 6144, the trained widths (llama4-scout's 5120,
# qwen's 8192, mistral-large-123b's 12288; phase 7's seamless-m4t 1024,
# xlstm-1.3b 2048, zamba2-7b 3584 and its Mamba2 inner 7168), 8192 rows, and
# d = 16384 (one ring stage in f32)
RMSNORM_BWD_SHAPES = [(8, 128), (3, 37, 64), (1, 256), (15, 4096), (64, 4096), (2048, 4096),
                      (131, 4096), (132, 4096), (133, 4096), (263, 4096), (264, 4096),
                      (265, 4096), (528, 4096), (529, 4096), (15, 37), (8, 6144), (600, 6144),
                      (2048, 5120), (2048, 6144), (2048, 8192), (2048, 12288), (8192, 4096),
                      (8, 16384), (64, 16384), (2048, 1024), (2048, 2048), (2048, 3584),
                      (2048, 7168)]
# where the backward is timed: the trained widths at 2048 rows (bf16), 8192
# rows, and the 64 f32 rows of phase 4's step; then phase 7's hybrid, ssm and
# enc-dec widths at 2048 rows (bf16)
RMSNORM_BWD_TIMED = [(2048, 4096, "bfloat16"), (2048, 5120, "bfloat16"),
                     (2048, 6144, "bfloat16"), (2048, 8192, "bfloat16"),
                     (2048, 12288, "bfloat16"), (8192, 4096, "bfloat16"), (64, 4096, "float32"),
                     (2048, 1024, "bfloat16"), (2048, 2048, "bfloat16"),
                     (2048, 3584, "bfloat16"), (2048, 7168, "bfloat16")]
# phase 3's context-parallel flash checks: one of 16 ranks' query rows of a
# 2048-token prefill, at the first, a middle and the last rank's offset;
# (H, K, window): llama2-7b, glm4-9b's GQA, and a window below Sk
CP_SEQ, CP_ROWS, CP_OFFSETS = 2048, 128, (0, 896, 1920)
CP_FLASH_CASES = ((32, 32, 0), (32, 2, 0), (32, 32, 512))
MODEL_TOL = 2e-3
GRAD_TOL = 2e-4  # each gradient leaf, against its largest magnitude
ENC_FRAMES = 10  # encoder frames of the enc-dec card-vs-CPU checks
TPU_KERNELS = {  # the Pallas function each kernel replaces
    "rmsnorm": "src/repro/kernels/rmsnorm.py:27",
    # no Pallas backward: the reference differentiates its plain rms_norm, whose
    # forward on the TPU is the rmsnorm kernel
    "rmsnorm_bwd": "src/repro/kernels/rmsnorm.py:27",
    "flash_attention": "src/repro/kernels/flash_attention.py:94",
    "decode_attention": "src/repro/kernels/decode_attention.py:86",
    # its lse mode: the same kernel, over one rank's slots of a sharded cache
    "decode_attention_lse": "src/repro/kernels/decode_attention.py:86",
}
SOURCES = {"rmsnorm_bwd": "rmsnorm", "decode_attention_lse": "decode_attention"}


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# ---------------------------------------------------------------------------
# phase 1: the card
# ---------------------------------------------------------------------------


def phase_card(torch):
    from repro_torch.launch.capacity import card_line

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    card = card_line()  # raises where nvidia-smi fails
    say(f"card: {card}")
    say(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


SASS_TYPES = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32"}
# rmsnorm's backward kernels by (x dtype, gamma dtype, vectors per thread,
# path): rmsnorm_bwd_kernel<T, G, VPT, kVec> (and the two stage kernels of
# older trees, rmsnorm_bwd_rows<T, G, kVec>)
BWD_NAME = re.compile(r"(rmsnorm_bwd_[a-z]+)I(13__nv_bfloat16|6__half|f)(S\d*_|13__nv_bfloat16|"
                      r"6__half|f)(?:Li(\d+)E)?Lb([01])E")


def bwd_label(mangled: str):
    """`rmsnorm_bwd_kernel<bf16,bf16,2,vec>` for a backward kernel's mangled
    name, else None."""
    m = BWD_NAME.search(mangled)
    if not m:
        return None
    t = SASS_TYPES[m.group(2)]
    g = SASS_TYPES.get(m.group(3), t)  # a substitution (S1_) repeats x's type
    return (f"{m.group(1)}<{t},{g}," + (f"{m.group(4)}," if m.group(4) else "")
            + ("vec>" if m.group(5) == "1" else "scalar>"))


SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS", "UBLKCP", "F2F.F64")


def sass_counts(lib_path):
    """{kernel label: {op: count}} from `cuobjdump -sass` of the library, for
    each op of SASS_OPS: the instructions whose opcode starts with it."""
    ops = SASS_OPS
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    counts, label = {}, None
    pattern = re.compile(r"\b(?:" + "|".join(re.escape(op) for op in ops) + r")\b")
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:  # ..._kernelI13__nv_bfloat16Li128ELi4EEv... -> kernel<bf16,128,4>
            t = re.search(r"([a-z_]+_kernel)I(13__nv_bfloat16|6__half|f)L[ij](\d+)E"
                          r"(?:L[ij](\d+)E)?", m.group(1))
            label = bwd_label(m.group(1)) or ((
                f"{t.group(1)}<{SASS_TYPES[t.group(2)]},{t.group(3)}"
                + (f",{t.group(4)}>" if t.group(4) else ">")) if t else m.group(1))
            counts[label] = dict.fromkeys(ops, 0)
        elif label is not None and pattern.search(line):
            for op in ops:
                if re.search(rf"\b{re.escape(op)}", line):
                    counts[label][op] += 1
    return counts


def rmsnorm_registers(log: str):
    """{(x dtype, gamma dtype, vectors per thread, vector path): (registers,
    spill-store bytes)} of the rmsnorm kernels, from ptxas -v in build.log."""
    types = SASS_TYPES
    out, key, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*rmsnorm_kernelI(13__nv_bfloat16|6__half|f)"
                      r"(S1_|f)Li(\d+)ELb([01])E", line)
        if m:
            t = types[m.group(1)]
            key = (t, t if m.group(2) == "S1_" else "f32", int(m.group(3)), m.group(4) == "1")
            continue
        if "Compiling entry function" in line:
            key = None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and key is not None:
            out[key] = (int(m.group(1)), spill)
    return out


def bwd_registers(log: str):
    """{backward kernel label: (registers, spill-store bytes)}, from ptxas -v
    in build.log."""
    out, label, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            label = bwd_label(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and label is not None:
            out[label] = (int(m.group(1)), spill)
    return out


def bwd_elems(label: str) -> int:
    """Elements a thread takes of a row in one unrolled pass body of the
    backward kernel labelled `label`: vectors per thread (one where the
    label has none: the stage kernels of older trees loop over vectors)
    times elements a vector."""
    fields = label[label.index("<") + 1:-1].split(",")
    vpt = int(fields[2]) if len(fields) == 4 else 1
    return vpt * ((16 // (4 if fields[0] == "f32" else 2)) if fields[-1] == "vec" else 1)


def report_bwd(log, counts):
    """Phase 2's lines for rmsnorm's backward: per instantiation its
    registers, spills, F2F.F64 conversions (static count in the SASS, with
    the elements a thread covers in one unrolled pass body; the passes
    appear several times, `csrc/rmsnorm.cu`) and TMA bulk copies; fails on a
    spill or a vector instantiation without UBLKCP."""
    regs = bwd_registers(log) if log else {}
    bwd = {label: c for label, c in counts.items() if label.startswith("rmsnorm_bwd_kernel<")}
    check(bwd, "no rmsnorm_bwd_kernel in the library")
    for label, c in sorted(bwd.items()):
        r = regs.get(label)
        say(f"rmsnorm_bwd {label[len('rmsnorm_bwd_kernel'):]}: "
            + (f"{r[0]} registers, {r[1]} bytes spilled, " if r else "")
            + f"F2F.F64 {c['F2F.F64']} ({bwd_elems(label)} elements a pass body), "
            f"UBLKCP {c['UBLKCP']}")
    spilled = {label: r for label, r in regs.items() if r[1]}
    check(not spilled, f"rmsnorm_bwd instantiations spill: {spilled}")
    no_tma = [label for label, c in bwd.items() if label.endswith("vec>") and not c["UBLKCP"]]
    check(not no_tma, f"vector rmsnorm_bwd kernels without the TMA bulk copy: {no_tma}")


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    say(f"build: {time.perf_counter() - t0:.1f} s (nvcc, all csrc/*.cu) into "
        f"{_build.BUILD_ROOT.relative_to(ROOT)}")
    log = _build.library_path().parent / "build.log"
    if log.is_file():  # absent when an earlier run built the library
        text = log.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", text)]
        say(f"ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{sum(1 for b in spills if b)} with spill stores (max {max(spills)} bytes)")
        rms = rmsnorm_registers(text)
        for vec in (True, False):
            per = ["x {} gamma {} ".format(t, g)
                   + "/".join(str(rms[t, g, v, vec][0]) for v in (1, 2, 4, 8, 16))
                   for t, g in sorted({k[:2] for k in rms})]
            say(f"ptxas rmsnorm, {'vector' if vec else 'scalar'} path, registers at 1/2/4/8/16 "
                "vectors per thread: " + "; ".join(per))
        say(f"ptxas rmsnorm: {sum(1 for r in rms.values() if r[1])} of {len(rms)} kernels "
            "spill")
    counts = sass_counts(_build.library_path())
    for label, c in sorted(counts.items()):
        if "attention" in label:
            say(f"sass {label}: " + ", ".join(f"{op} {c[op]}" for op in
                                               ("HGMMA", "UTMALDG", "LDGSTS")))
    report_bwd(log.read_text() if log.is_file() else None, counts)
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    for t in ("bf16", "f16"):  # every width, dh = 112 (zamba2-7b) included
        tc = {label: c for label, c in counts.items()
              if label.startswith(f"flash_attention_tc_kernel<{t},")}
        check(sorted(int(label[:-1].split(",")[1]) for label in tc) == sorted(HEAD_DIMS)
              and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 for c in tc.values()),
              f"the {t} flash kernels at dh {HEAD_DIMS} must hold HGMMA and UTMALDG: {tc}")
    fma = [label for label in counts if label.startswith("flash_attention_kernel<")]
    check(fma and all("<f32," in label for label in fma),
          f"only f32 may reach the FMA flash kernel: {fma}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions; timing
# ---------------------------------------------------------------------------


class Timer:
    """Median device ms of one call over `iters` calls (one slow call moves a
    mean, not the median): CUDA events around each call, the 50 MB L2
    flushed before each (the main path streams ~0.4 GB of weights between
    two calls of a kernel, so its caller finds L2 cold). A ~1 ms device spin
    before each timed call lets the host enqueue the whole call before the
    card reaches it, so host overhead never shows as device time. `spread`
    holds the last call's (min, max)."""

    def __init__(self, torch, iters=20):
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")  # 256 MB
        self.spread = (math.nan, math.nan)

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.iters):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)  # ~1 ms at the H100's clock
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        self.spread = (min(times), max(times))
        return statistics.median(times)


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def assert_close(torch, out, want, dtype, what):
    tol = TOLS[dtype]
    ok = torch.allclose(out.float(), want.float(), rtol=tol, atol=tol)
    err = max_err(out, want)
    check(ok and math.isfinite(err), f"{what}: kernel disagrees with plain, max|err| {err:.3g}")
    return err


def launch_counts(**counts):
    """A launch count for every kernel of `ops.LAUNCHES`, 0 where not given."""
    from repro_torch.kernels import ops

    return dict(dict.fromkeys(ops.LAUNCHES, 0), **counts)


def lse_close(torch, got, want, dtype, what):
    """decode_attention's lse mode against its plain version: the f32
    outputs within TOLS[dtype], lse -inf on the same rows (those with no
    valid slot) and within TOLS[dtype] on the others. -> the larger max|err|."""
    (o, lse), (o_p, lse_p) = got, want
    check(o.dtype == lse.dtype == torch.float32 and lse.shape == lse_p.shape,
          f"{what}: the lse mode returns f32 (B, H, dh) and (B, H)")
    err = assert_close(torch, o, o_p, dtype, f"{what} output")
    dead = torch.isneginf(lse_p)
    check(torch.equal(torch.isneginf(lse), dead) and not torch.isnan(lse).any(),
          f"{what}: lse is -inf on other rows than the plain version's")
    if (~dead).any():
        err = max(err, assert_close(torch, lse[~dead], lse_p[~dead], dtype, f"{what} lse"))
    return err


def device_kernels(torch, fn):
    """Names of the device kernels (and copies, sets) one call of fn runs,
    from torch.profiler, after one warm call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def decode_positions(torch, B, Sc, lengths):
    """kv_pos (B, Sc) with rows filled 0..len-1 then empty, pos = len - 1."""
    kv_pos = torch.full((B, Sc), -1, dtype=torch.int32)
    for b, n in enumerate(lengths):
        kv_pos[b, :n] = torch.arange(n, dtype=torch.int32)
    pos = torch.tensor([max(n - 1, 0) for n in lengths], dtype=torch.int32)
    return kv_pos.cuda(), pos.cuda()


def phase_kernels(torch, timer):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention, decode_splits
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd, rmsnorm_bwd_plan, rmsnorm_plan,
                                             vector_path)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dtype))

    worst = {"rmsnorm": 0.0, "rmsnorm_bwd": 0.0, "flash_attention": 0.0,
             "decode_attention": 0.0, "decode_attention_lse": 0.0}
    n_checks = 0

    def bwd_checks(dtype):
        """rmsnorm_bwd against ref.rmsnorm_bwd: dx and dgamma with both gamma
        dtypes at RMSNORM_BWD_SHAPES, two launches bit-equal; the scalar
        instantiation (a gamma 2 or 4 bytes off 16-byte alignment, rows d + 1
        apart, d = 37) and x[:, -1] of (B, S, d) on the vector path."""
        nonlocal n_checks
        cases = [(f"{shape}", randn(shape, dtype), g_dtype, 0, None)
                 for shape in RMSNORM_BWD_SHAPES for g_dtype in ("float32", dtype)]
        d = 4096
        cases += [("gamma misaligned", randn((8, d), dtype), "float32", 1, False),
                  ("gamma misaligned", randn((8, d), dtype), dtype, 1, False),
                  ("rows d + 1 apart", randn((8, d + 1), dtype)[:, :d], dtype, 0, False),
                  ("d = 37", randn((15, 37), dtype), dtype, 0, False),
                  ("x[:, -1] of (4, 15, d)", randn((4, 15, d), dtype)[:, -1], dtype, 0, True)]
        for what, x, gdt, g_off, vec in cases:
            n_g = x.shape[-1]
            g = torch.empty(n_g + g_off, device="cuda", dtype=getattr(torch, gdt))[g_off:]
            g.copy_(1.0 + 0.1 * randn((n_g,), "float32"))
            dy = randn(tuple(x.shape), dtype)
            out = rmsnorm_bwd(x, g, dy)
            if vec is not None:
                check(vector_path(x.view(-1, n_g), g, out[0].view(-1, n_g)) == vec,
                      f"rmsnorm_bwd {what}: expected the {'vector' if vec else 'scalar'} path")
            for got, want, part in zip(out, ref.rmsnorm_bwd(x, g, dy), ("dx", "dgamma")):
                err = assert_close(torch, got, want, dtype,
                                   f"rmsnorm_bwd {part} {what} {dtype} gamma {g.dtype}")
                worst["rmsnorm_bwd"] = max(worst["rmsnorm_bwd"], err)
                n_checks += 1
            again = rmsnorm_bwd(x, g, dy)  # no atomics: the same bits
            check(all(torch.equal(a, b) for a, b in zip(out, again)),
                  f"rmsnorm_bwd {what} {dtype} gamma {g.dtype}: two launches differ")

    # --- correctness sweep: the CPU tests' shapes plus the main path's ----
    for dtype in ("float32", "bfloat16", "float16"):
        bwd_checks(dtype)
    for dtype in ("float32", "bfloat16"):
        for shape in RMSNORM_SHAPES:
            x = randn(shape, dtype)
            for g in (1.0 + 0.1 * randn(shape[-1:], "float32"),
                      1.0 + 0.1 * randn(shape[-1:], dtype)):
                err = assert_close(torch, rmsnorm(x, g), ref.rmsnorm(x, g), dtype,
                                   f"rmsnorm {shape} {dtype} gamma {g.dtype}")
                worst["rmsnorm"] = max(worst["rmsnorm"], err)
                n_checks += 1
        # the scalar instantiation and strided rows: a gamma 2 or 4 bytes off
        # 16-byte alignment, rows d + 1 elements apart, d = 37; and x[:, -1] of
        # (B, S, d), the final norm's strided rows, on the vector path
        d = 4096
        for what, x, gdt, g_off, vec in [
            ("gamma misaligned", randn((8, d), dtype), "float32", 1, False),
            ("gamma misaligned", randn((8, d), dtype), dtype, 1, False),
            ("rows d + 1 apart", randn((8, d + 1), dtype)[:, :d], dtype, 0, False),
            ("d = 37", randn((15, 37), dtype), dtype, 0, False),
            ("x[:, -1] of (4, 15, d)", randn((4, 15, d), dtype)[:, -1], dtype, 0, True),
        ]:
            n_g = x.shape[-1]
            g = torch.empty(n_g + g_off, device="cuda", dtype=getattr(torch, gdt))[g_off:]
            g.copy_(1.0 + 0.1 * randn((n_g,), "float32"))
            out = rmsnorm(x, g)
            check(vector_path(x.view(-1, x.shape[-1]), g, out) == vec,
                  f"rmsnorm {what}: expected the {'vector' if vec else 'scalar'} path")
            err = assert_close(torch, out, ref.rmsnorm(x, g), dtype,
                               f"rmsnorm {what} {dtype} gamma {g.dtype}")
            worst["rmsnorm"] = max(worst["rmsnorm"], err)
            n_checks += 1
        for B, H, K, Sq, Sk, dh in [(1, 4, 4, 32, 32, 16), (2, 8, 2, 48, 48, 32),
                                     (1, 4, 1, 40, 72, 16), (1, 2, 2, 17, 33, 16),
                                     (1, 32, 32, 15, 15, 128), (1, 32, 32, 512, 512, 128),
                                     (1, 32, 32, 1000, 1000, 128),  # ragged 64-row tiles
                                     (1, 32, 8, 200, 200, 128), (1, 32, 8, 200, 200, 64),
                                     # glm4-9b (G = 16) prefills, nemotron-4-15b and
                                     # mixtral-8x22b (G = 6), llama4-scout (G = 5)
                                     (1, 32, 2, 15, 15, 128), (1, 32, 2, 512, 512, 128),
                                     (1, 48, 8, 200, 200, 128), (1, 40, 8, 200, 200, 128),
                                     # zamba2-7b (dh = 112: a 64 + 48 column row), ragged
                                     # tiles, Sq != Sk; seamless-m4t's encoder and cross
                                     (1, 32, 32, 15, 15, 112), (1, 32, 32, 512, 512, 112),
                                     (2, 8, 8, 130, 77, 112), (1, 16, 16, 512, 512, 64),
                                     (1, 16, 16, 15, 512, 64), (2, 16, 16, 15, 7, 64)]:
            q, k, v = randn((B, Sq, H, dh), dtype), randn((B, Sk, K, dh), dtype), \
                randn((B, Sk, K, dh), dtype)
            for causal, window, kv_len in [(True, 0, None), (True, 8, None),
                                           (True, 4096, None),  # mixtral's, wider than S
                                           (False, 0, None), (False, 0, Sk - 5)]:
                if causal and Sq > Sk:
                    continue
                err = assert_close(
                    torch, flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len),
                    ref.flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len),
                    dtype, f"flash_attention {(B, H, K, Sq, Sk, dh)} causal={causal} "
                    f"window={window} kv_len={kv_len} {dtype}")
                worst["flash_attention"] = max(worst["flash_attention"], err)
                n_checks += 1
        # context parallelism: one rank's block of query rows at its offset
        # (`q_offset`), a 16-way row shard of a 2048-token prefill: llama2-7b
        # (H = K = 32) and glm4-9b (K = 2) causal, and llama2-7b under a window
        # below Sk; offsets of the first, a middle and the last rank
        for H, K, window in CP_FLASH_CASES:
            q = randn((1, CP_ROWS, H, 128), dtype)
            k, v = randn((1, CP_SEQ, K, 128), dtype), randn((1, CP_SEQ, K, 128), dtype)
            for off in CP_OFFSETS:
                err = assert_close(
                    torch, flash_attention(q, k, v, window=window, q_offset=off),
                    ref.flash_attention(q, k, v, window=window, q_offset=off), dtype,
                    f"flash_attention rows {off}..{off + CP_ROWS} of {CP_SEQ} H={H} K={K} "
                    f"causal window={window} {dtype}")
                worst["flash_attention"] = max(worst["flash_attention"], err)
                n_checks += 1
        for B, H, K, Sc, dh, lengths in [
            (2, 4, 2, 64, 16, [57, 0]),  # second row all empty: emits 0
            (1, 8, 8, 70, 32, [63]),
            (8, 32, 32, 576, 128, [16 + 2 * b for b in range(8)]),
            (1, 32, 32, 576, 128, [576]),
            (2, 8, 2, 1000, 64, [1000, 0]),  # splits > 1 and an all-empty row
            (1, 32, 32, 576, 128, [40]),  # most splits empty
            (2, 48, 8, 200, 128, [200, 0]),  # G = 6 (nemotron-4-15b)
            (1, 96, 8, 576, 128, [560]),  # G = 12 (mistral-large-123b), split
            (8, 32, 2, 576, 128, [16 + 2 * b for b in range(8)]),  # G = 16 (glm4-9b)
            (1, 32, 2, 576, 128, [560]),  # G = 16, batch 1, split
            (2, 16, 1, 130, 16, [130, 0]),  # G = 16 at dh 16
            (2, 48, 2, 300, 64, [300, 100]),  # G = 24: six head groups of 4
            (2, 40, 8, 200, 64, [200, 0]),  # G = 5: five head groups of 1
            (8, 48, 8, 576, 128, [16 + 2 * b for b in range(8)]),  # mixtral-8x22b, G = 6
            (1, 40, 8, 576, 128, [560]),  # llama4-scout, G = 5, batch 1
            (8, 32, 32, 576, 112, [16 + 2 * b for b in range(8)]),  # zamba2-7b, dh = 112
            (1, 32, 32, 576, 112, [560]),  # zamba2-7b batch 1, split
            (2, 4, 4, 130, 112, [130, 0]),  # dh = 112, an all-empty row
            (8, 16, 16, 576, 64, [16 + 2 * b for b in range(8)]),  # seamless-m4t self
        ]:
            q = randn((B, H, dh), dtype)
            k, v = randn((B, Sc, K, dh), dtype), randn((B, Sc, K, dh), dtype)
            kv_pos, pos = decode_positions(torch, B, Sc, lengths)
            for window in (0, 16, 4096):
                out = decode_attention(q, k, v, kv_pos, pos, window=window)
                err = assert_close(
                    torch, out, ref.decode_attention(q, k, v, kv_pos, pos, window=window),
                    dtype, f"decode_attention {(B, H, K, Sc, dh)} window={window} {dtype}")
                worst["decode_attention"] = max(worst["decode_attention"], err)
                err = lse_close(
                    torch, decode_attention(q, k, v, kv_pos, pos, window=window, return_lse=True),
                    ref.decode_attention(q, k, v, kv_pos, pos, window=window, return_lse=True),
                    dtype, f"decode_attention lse mode {(B, H, K, Sc, dh)} window={window} "
                    f"{dtype}")
                worst["decode_attention_lse"] = max(worst["decode_attention_lse"], err)
                n_checks += 2
                if 0 in lengths:
                    check(float(out[lengths.index(0)].abs().max()) == 0.0,
                          "decode_attention: an all-empty row must emit 0")
        # ring caches: out-of-order absolute positions with a window; the
        # second (positions 0..700 at slot p % 576, window 200) crosses a
        # split boundary at batch 1
        ring = torch.full((1, 576), -1, dtype=torch.int32)
        ring[0, torch.arange(701) % 576] = torch.arange(701, dtype=torch.int32)
        for H, Sc, dh, kv_pos, p, window in [
            (2, 16, 16, torch.tensor([[16, 17, 18, 19] + list(range(4, 16))]), 19, 8),
            (32, 576, 128, ring, 700, 200),
        ]:
            q, k, v = randn((1, H, dh), dtype), randn((1, Sc, H, dh), dtype), \
                randn((1, Sc, H, dh), dtype)
            kv_pos = kv_pos.to(torch.int32).cuda()
            pos = torch.tensor([p], dtype=torch.int32).cuda()
            out = decode_attention(q, k, v, kv_pos, pos, window=window)
            err = assert_close(torch, out, ref.decode_attention(q, k, v, kv_pos, pos, window=window),
                               dtype, f"decode_attention ring cache Sc={Sc} {dtype}")
            worst["decode_attention"] = max(worst["decode_attention"], err)
            n_checks += 1
        # enc-dec cross decode (seamless-m4t): a static cross cache of Se frames, a
        # shorter encoder prompt's frames padded with -1, the query position past
        # every frame and no window, so only kv_pos >= 0 masks
        for B, Se, lengths in [(8, 15, [15] * 7 + [9]), (2, 600, [600, 37])]:
            q = randn((B, 16, 64), dtype)
            k, v = randn((B, Se, 16, 64), dtype), randn((B, Se, 16, 64), dtype)
            kv_pos, _ = decode_positions(torch, B, Se, lengths)
            beyond = torch.full((B,), Se, dtype=torch.int32, device="cuda")
            err = assert_close(torch, decode_attention(q, k, v, kv_pos, beyond),
                               ref.decode_attention(q, k, v, kv_pos, beyond), dtype,
                               f"decode_attention cross B={B} Se={Se} {dtype}")
            worst["decode_attention"] = max(worst["decode_attention"], err)
            n_checks += 1
        # splits > 1: the merge runs in a fixed order, so two calls agree bit for bit
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        for K in (32, 2):  # llama2-7b (G = 1) and glm4-9b (G = 16)
            check(decode_splits(1, K, 576, n_sm) > 1, "batch 1 over 576 slots should split")
            q, k, v = randn((1, 32, 128), dtype), randn((1, 576, K, 128), dtype), \
                randn((1, 576, K, 128), dtype)
            kv_pos, pos = decode_positions(torch, 1, 576, [576])
            check(torch.equal(decode_attention(q, k, v, kv_pos, pos),
                              decode_attention(q, k, v, kv_pos, pos)),
                  f"decode_attention at splits > 1, K = {K} is not bit-identical between "
                  f"calls ({dtype})")
            n_checks += 1
        # the lse mode over two halves of a cache, merged as the sharded decode merges
        # two ranks' parts (`ops._merge_over`, `ref.merge_decode_parts`), against the
        # kernel over the whole cache: llama2-7b's ICC batch at a serving cache, and
        # glm4-9b decode_32k's shard on 16 x 16 (8 rows, 2048 slots, G = 16), all
        # slots valid but row 0's (valid in the second half only) and row 1's (none)
        for B, H, K, Sc, dh in [(8, 32, 32, 576, 128), (8, 32, 2, 2048, 128)]:
            q = randn((B, H, dh), dtype)
            k, v = randn((B, Sc, K, dh), dtype), randn((B, Sc, K, dh), dtype)
            kv_pos, pos = decode_positions(torch, B, Sc, [Sc] * B)
            half = Sc // 2
            kv_pos[0] = -1
            kv_pos[0, half:] = torch.arange(half, dtype=torch.int32, device="cuda")
            pos[0] = half - 1
            kv_pos[1] = -1
            what = f"decode_attention lse mode {(B, H, K, Sc, dh)} {dtype}"
            err = lse_close(torch, decode_attention(q, k, v, kv_pos, pos, return_lse=True),
                            ref.decode_attention(q, k, v, kv_pos, pos, return_lse=True),
                            dtype, what)
            parts = [decode_attention(q, k[:, sl], v[:, sl], kv_pos[:, sl], pos, return_lse=True)
                     for sl in (slice(0, half), slice(half, Sc))]
            check(torch.isneginf(parts[0][1][0]).all() and torch.isneginf(parts[0][1][1]).all()
                  and torch.isneginf(parts[1][1][1]).all(),
                  f"{what}: a half with no valid slot of a row must give lse -inf")
            merged = ref.merge_decode_parts([o for o, _ in parts], [lse for _, lse in parts])
            whole = decode_attention(q, k, v, kv_pos, pos)
            err = max(err, assert_close(torch, merged, whole, dtype,
                                        f"{what}: two halves merged against the whole cache"))
            check(not torch.isnan(merged).any() and float(merged[1].abs().max()) == 0.0,
                  f"{what}: a row with no valid slot must merge to 0")
            worst["decode_attention_lse"] = max(worst["decode_attention_lse"], err)
            n_checks += 2
    torch.cuda.synchronize()
    say(f"kernels: {n_checks} kernel-vs-plain checks passed; worst max|err| "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    # one device kernel a backward call: the cooperative launch, nothing else
    x, dy = randn((2048, 4096), "bfloat16"), randn((2048, 4096), "bfloat16")
    g = 1.0 + 0.1 * randn((4096,), "bfloat16")
    names = device_kernels(torch, lambda: rmsnorm_bwd(x, g, dy))
    check(len(names) == 1 and "rmsnorm_bwd_kernel" in names[0],
          f"rmsnorm_bwd at (2048, 4096) ran {len(names)} device kernels: {names}")
    say(f"rmsnorm_bwd (2048, 4096) bf16: {len(names)} device kernel a call ({names[0][:70]})")

    # --- timing at the main path's shapes (bf16) ---------------------------
    rows = []

    def row(name, shape, fn, plain, library, nbytes, flops, errfn, dtype="bfloat16",
            peak="bfloat16"):
        """`library` is a callable, or a float already measured; `peak`: the
        dtype whose peak rate bounds the operations."""
        b_ms, b_by = bound(nbytes, flops, peak)
        r = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{SOURCES.get(name, name)}.cu",
            "replaces": TPU_KERNELS[name], "shape": shape, "dtype": dtype,
            "ms": timer(fn)}
        spread = timer.spread
        r.update({
            "plain_ms": timer(plain),
            "library_ms": (library if isinstance(library, float) else
                           timer(library) if library else None),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": errfn(),
        })
        rows.append(r)
        lo, hi = spread
        say(f"time {name} {shape}: kernel {r['ms']:.4f} ms (min {lo:.4f}, max {hi:.4f}), "
            f"plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
            f" ms, bound {b_ms:.3g} ms ({b_by}), max|err| {r['max_abs_err']:.3g}")
        return r

    floor = timer(lambda: torch.cuda._sleep(0))
    say(f"timer floor: {floor:.4f} ms (the same timer around a launch that does no work)")
    rms_lib = getattr(F, "rms_norm", None)  # torch >= 2.4
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    # decode step (max_batch 8), Table-I prompt, long prompt, bytes-bound; then
    # nemotron-4-15b's and mixtral-8x22b's d_model at a decode step and
    # bytes-bound; llama4-scout's at a decode step
    # zamba2-7b's blocks at a decode step, its Mamba2 inner norm (d_inner 7168) at a
    # decode step and a 512-token prefill; xlstm-1.3b's blocks (its mLSTM inner norm
    # is (8, 4096)); seamless-m4t's d_model
    for n, d in ((8, 4096), (15, 4096), (512, 4096), (8192, 4096), (8, 6144), (8192, 6144),
                 (8, 5120), (8, 3584), (8, 7168), (512, 7168), (8, 2048), (8, 1024)):
        x = randn((n, d), "bfloat16")
        g = 1.0 + 0.1 * randn((d,), "bfloat16")
        say(f"rmsnorm plan ({n}, {d}) bf16: (rows per CTA, threads per row, vectors per "
            f"thread) = {rmsnorm_plan(n, d, 2, n_sm)}")
        row("rmsnorm", f"({n}, {d})", lambda: rmsnorm(x, g), lambda: ref.rmsnorm(x, g),
            rms_lib and (lambda: rms_lib(x, (d,), g, 1e-5)), 2 * (2 * n * d) + 2 * d, 4.0 * n * d,
            lambda: max_err(rmsnorm(x, g), ref.rmsnorm(x, g)))

    # rmsnorm's backward at the training step's rows: llama2-7b's 4 x 512 tokens
    # in bf16 (the full-width run), the other trained widths, 8192 rows, and 64
    # rows in f32. Bound: x and dy read, dx written, gamma read and dgamma
    # written once (the f64 workspace is the kernel's own traffic, not the
    # function's); ~12 f32 operations an element at the f32 peak. Library:
    # F.rms_norm's forward and backward through autograd, less its forward.
    for n, d, dtype in RMSNORM_BWD_TIMED:
        x, dy = randn((n, d), dtype), randn((n, d), dtype)
        g = 1.0 + 0.1 * randn((d,), dtype)
        lib = None
        if rms_lib:
            xr, gr = x.clone().requires_grad_(), g.clone().requires_grad_()
            fwd_bwd = timer(lambda: torch.autograd.grad(rms_lib(xr, (d,), gr, 1e-5), (xr, gr), dy))
            lib = fwd_bwd - timer(lambda: rms_lib(x, (d,), g, 1e-5))
        itemsize = x.element_size()
        say(f"rmsnorm_bwd plan ({n}, {d}) {dtype}: (threads, vectors per thread, stages, CTAs) "
            f"= {rmsnorm_bwd_plan(n, d, itemsize, n_sm, gamma_itemsize=itemsize)}")
        row("rmsnorm_bwd", f"({n}, {d}) {dtype}", lambda: rmsnorm_bwd(x, g, dy),
            lambda: ref.rmsnorm_bwd(x, g, dy), lib, 3 * n * d * itemsize + 2 * d * itemsize,
            12.0 * n * d, lambda: max(max_err(a, b) for a, b in zip(
                rmsnorm_bwd(x, g, dy), ref.rmsnorm_bwd(x, g, dy))), dtype=dtype, peak="float32")

    dh = 128
    # llama2-7b (K = H): Table-I prompt, calibration prompt, operations-bound;
    # glm4-9b (K = 2, G = 16), mixtral-8x22b (G = 6, its window of 4096, wider
    # than S, so SDPA's causal mask is the same function) and llama4-scout
    # (G = 5): Table-I and calibration prompts
    for S, H, K, window in ((15, 32, 32, 0), (512, 32, 32, 0), (2048, 32, 32, 0),
                            (15, 32, 2, 0), (512, 32, 2, 0), (15, 48, 8, 4096),
                            (512, 48, 8, 4096), (15, 40, 8, 0), (512, 40, 8, 0)):
        q = randn((1, S, H, dh), "bfloat16")
        k, v = randn((1, S, K, dh), "bfloat16"), randn((1, S, K, dh), "bfloat16")
        pairs = S * (S + 1) // 2  # causal (q, k) pairs each head computes
        heads = f"H=K={H}" if K == H else f"H={H} K={K}"
        row("flash_attention",
            f"B=1 S={S} {heads} dh={dh} causal" + (f" window={window}" if window else ""),
            lambda: flash_attention(q, k, v, window=window),
            lambda: ref.flash_attention(q, k, v, window=window),
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
                enable_gqa=K != H),
            2 * S * (H + K) * dh * 2, 4.0 * pairs * dh * H,
            lambda: max_err(flash_attention(q, k, v, window=window),
                            ref.flash_attention(q, k, v, window=window)))

    # context parallelism: the last of 16 ranks' 128 query rows of llama2-7b's
    # 2048-token prefill (q_offset 1920, every key of the sequence before them).
    # Library: SDPA over the same rows with a boolean mask (key <= the row's
    # position). Bound: q read and o written, K and V read once; the (q, k)
    # pairs of the rows' causal triangle
    H, K, off = 32, 32, CP_OFFSETS[-1]
    q = randn((1, CP_ROWS, H, dh), "bfloat16")
    k, v = randn((1, CP_SEQ, K, dh), "bfloat16"), randn((1, CP_SEQ, K, dh), "bfloat16")
    rows_pos = torch.arange(off, off + CP_ROWS, device="cuda")
    cp_mask = torch.arange(CP_SEQ, device="cuda")[None, :] <= rows_pos[:, None]
    pairs = CP_ROWS * off + CP_ROWS * (CP_ROWS + 1) // 2
    row("flash_attention",
        f"B=1 Sq={CP_ROWS} Sk={CP_SEQ} H=K={H} dh={dh} causal q_offset={off} (the last rank's "
        f"rows of a 16-way row shard)",
        lambda: flash_attention(q, k, v, q_offset=off),
        lambda: ref.flash_attention(q, k, v, q_offset=off),
        lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                               v.transpose(1, 2), attn_mask=cp_mask),
        2 * (CP_ROWS * H + CP_SEQ * K) * dh * 2, 4.0 * pairs * dh * H,
        lambda: max_err(flash_attention(q, k, v, q_offset=off),
                        ref.flash_attention(q, k, v, q_offset=off)))

    # zamba2-7b (dh = 112, causal), seamless-m4t's encoder (non-causal, Sq = Sk)
    # and its cross attention (15 decoder rows over 512 encoder frames)
    for Sq, Sk, H, dh, causal, label in (
            (15, 15, 32, 112, True, "zamba2-7b"), (512, 512, 32, 112, True, "zamba2-7b"),
            (15, 15, 16, 64, False, "seamless encoder"),
            (512, 512, 16, 64, False, "seamless encoder"),
            (15, 512, 16, 64, False, "seamless cross")):
        q = randn((1, Sq, H, dh), "bfloat16")
        k, v = randn((1, Sk, H, dh), "bfloat16"), randn((1, Sk, H, dh), "bfloat16")
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
        row("flash_attention",
            f"{label}: B=1 Sq={Sq} Sk={Sk} H=K={H} dh={dh} "
            + ("causal" if causal else "non-causal"),
            lambda: flash_attention(q, k, v, causal=causal),
            lambda: ref.flash_attention(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal),
            2 * (Sq + Sk) * H * dh * 2, 4.0 * pairs * dh * H,
            lambda: max_err(flash_attention(q, k, v, causal=causal),
                            ref.flash_attention(q, k, v, causal=causal)))

    Sc = 576
    icc = [16 + 2 * b for b in range(8)]
    for B, H, K, lengths, label, dh in [(b, h, k_, n, lab, 128) for b, h, k_, n, lab in [
        (8, 32, 32, icc, "ICC batch, 16-30 valid"),
        (1, 32, 32, [576], "calibration 512+64, 576 valid"),
        (8, 32, 2, icc, "ICC batch, 16-30 valid"),
        (1, 32, 2, [560], "batch 1, 560 valid"),
        (8, 48, 8, icc, "mixtral ICC batch, 16-30 valid"),
        (1, 48, 8, [560], "mixtral batch 1, 560 valid"),
        (8, 40, 8, icc, "llama4-scout ICC batch, 16-30 valid"),
        (1, 40, 8, [560], "llama4-scout batch 1, 560 valid"),
    ]] + [
        (8, 32, 32, icc, "zamba2-7b ICC batch, 16-30 valid", 112),
        (1, 32, 32, [560], "zamba2-7b batch 1, 560 valid", 112),
        (8, 16, 16, icc, "seamless self, ICC batch, 16-30 valid", 64),
    ]:
        q = randn((B, H, dh), "bfloat16")
        k, v = randn((B, Sc, K, dh), "bfloat16"), randn((B, Sc, K, dh), "bfloat16")
        kv_pos, pos = decode_positions(torch, B, Sc, lengths)
        mask = ((kv_pos >= 0) & (kv_pos <= pos[:, None]))[:, None, None, :]
        n_valid = sum(lengths)
        heads = f"H=K={H}" if K == H else f"H={H} K={K}"
        row("decode_attention", f"B={B} Sc={Sc} {heads} dh={dh} ({label})",
            lambda: decode_attention(q, k, v, kv_pos, pos),
            lambda: ref.decode_attention(q, k, v, kv_pos, pos),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
                enable_gqa=K != H),
            2 * n_valid * K * dh * 2 + B * Sc * 4 + B * 4 + 2 * B * H * dh * 2,
            4.0 * n_valid * H * dh,
            lambda: max_err(decode_attention(q, k, v, kv_pos, pos),
                            ref.decode_attention(q, k, v, kv_pos, pos)))

    # the lse mode (f32 output and lse, the sharded decode's parts): phase 10's llama2-7b
    # cache on the (1, 1) mesh (15 prompt and 15 decode slots, all valid), and glm4-9b
    # decode_32k's shard on 16 x 16 (8 rows, 2048 slots, G = 16, all valid). Bound: K
    # and V's valid rows, positions, q read; the f32 output and lse written
    for B, H, K, Sc, dh, label in [(8, 32, 32, 30, 128, "llama2-7b on the (1, 1) mesh"),
                                   (8, 32, 2, 2048, 128, "glm4-9b decode_32k's 16 x 16 shard")]:
        q = randn((B, H, dh), "bfloat16")
        k, v = randn((B, Sc, K, dh), "bfloat16"), randn((B, Sc, K, dh), "bfloat16")
        kv_pos, pos = decode_positions(torch, B, Sc, [Sc] * B)
        mask = ((kv_pos >= 0) & (kv_pos <= pos[:, None]))[:, None, None, :]
        heads = f"H=K={H}" if K == H else f"H={H} K={K}"

        def lse_err():
            got = decode_attention(q, k, v, kv_pos, pos, return_lse=True)
            want = ref.decode_attention(q, k, v, kv_pos, pos, return_lse=True)
            return max(max_err(a, b) for a, b in zip(got, want))

        row("decode_attention_lse", f"B={B} Sc={Sc} {heads} dh={dh} ({label}), all valid",
            lambda: decode_attention(q, k, v, kv_pos, pos, return_lse=True),
            lambda: ref.decode_attention(q, k, v, kv_pos, pos, return_lse=True),
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
                enable_gqa=K != H),
            2 * B * Sc * K * dh * 2 + B * Sc * 4 + B * 4 + B * H * dh * 2 + B * H * (dh + 1) * 4,
            4.0 * B * Sc * H * dh, lse_err)

    # seamless-m4t's cross decode: the static cross cache of 15 encoder frames
    # (Table I's N_input), every frame valid, the query position past them all
    for B in (8, 1):
        Se, H, dh = 15, 16, 64
        q = randn((B, H, dh), "bfloat16")
        k, v = randn((B, Se, H, dh), "bfloat16"), randn((B, Se, H, dh), "bfloat16")
        kv_pos, _ = decode_positions(torch, B, Se, [Se] * B)
        beyond = torch.full((B,), Se, dtype=torch.int32, device="cuda")
        row("decode_attention", f"seamless cross: B={B} Se={Se} H=K={H} dh={dh}, all valid",
            lambda: decode_attention(q, k, v, kv_pos, beyond),
            lambda: ref.decode_attention(q, k, v, kv_pos, beyond),
            lambda: F.scaled_dot_product_attention(q[:, :, None], k.transpose(1, 2),
                                                   v.transpose(1, 2)),
            2 * B * Se * H * dh * 2 + B * Se * 4 + B * 4 + 2 * B * H * dh * 2,
            4.0 * B * Se * H * dh,
            lambda: max_err(decode_attention(q, k, v, kv_pos, beyond),
                            ref.decode_attention(q, k, v, kv_pos, beyond)))
    return rows


# ---------------------------------------------------------------------------
# phase 4: smoke model, card against CPU
# ---------------------------------------------------------------------------


SMOKE_CASES = [  # (label, arch, fields replaced on its smoke config, RuntimeFlags fields,
    #               seeded biases/gammas)
    ("llama2-7b smoke", "llama2-7b", {}, {}, False),
    ("glm4-9b smoke", "glm4-9b", {}, {}, True),  # QKV bias, G = 4
    ("nemotron-4-15b smoke", "nemotron-4-15b", {}, {}, True),  # relu2
    ("qwen1.5-110b smoke", "qwen1.5-110b", {}, {}, True),
    ("mistral-large-123b smoke", "mistral-large-123b", {}, {}, True),
    ("qwen2-vl-72b smoke", "qwen2-vl-72b", {}, {}, True),  # embeds, M-RoPE
    ("tied embeddings", "glm4-9b", {"tie_embeddings": True}, {}, True),
    ("iRoPE", "mistral-large-123b", {"nope_interval": 2}, {}, True),
    ("mixtral-8x22b smoke", "mixtral-8x22b", {}, {}, True),  # top-2, window 64, scatter
    ("llama4-scout smoke", "llama4-scout-17b-a16e", {}, {}, True),  # top-1, iRoPE
    ("mixtral capacity 0.5", "mixtral-8x22b", {"capacity_factor": 0.5}, {}, True),  # drops
    ("mixtral einsum dispatch", "mixtral-8x22b", {}, {"moe_dispatch": "einsum"}, True),
    ("zamba2-7b smoke", "zamba2-7b", {}, {}, True),  # 2 layers, a shared block every 2
    # a remainder group: 2 groups of 2 Mamba2 layers and 1 more; chunks of 4 in the scan
    ("zamba2 remainder", "zamba2-7b", {"n_layers": 5}, {"mamba_chunk": 4}, True),
    ("zamba2 dh = 112", "zamba2-7b", {"d_model": 448, "n_heads": 4, "n_kv_heads": 4}, {},
     True),
    ("xlstm-1.3b smoke", "xlstm-1.3b", {}, {}, True),  # one mLSTM and one sLSTM block
    ("xlstm two groups", "xlstm-1.3b", {"n_layers": 4}, {"mlstm_chunk": 5}, True),
    ("seamless-m4t smoke", "seamless-m4t-large-v2", {}, {}, True),  # enc-dec, cross attention
]


def perturb(torch, params, seed):
    """Seeded non-zero QKV biases and norm gammas (the init leaves them 0 and
    1), and likewise the recurrent blocks' biases, A_log, D and skip."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in params.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("bq", "bk", "bv", "dt_bias", "A_log", "b_if", "b_gates"):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
            elif leaf.endswith("norm") or leaf in ("D", "skip"):
                t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=gen))


@contextlib.contextmanager
def recorded_picks(log):
    """Append (gate_idx, keep_k) of every moe routing call, on the host, to
    `log` while inside: one entry per layer of a forward."""
    from repro_torch.models import moe

    route = moe._route

    def recording(*args, **kwargs):
        out = route(*args, **kwargs)
        log.append((out[1].cpu(), out[3].cpu()))
        return out

    moe._route = recording
    try:
        yield log
    finally:
        moe._route = route


def pick_flips(cpu, card, limit=5):
    """Where the card's router picks differ from the CPU's: 'layer l, row b,
    token t, pick j: CPU expert e (kept), card expert e' (dropped)'."""
    flips = []
    for layer, ((gc, kc), (gg, kg)) in enumerate(zip(cpu, card)):
        for b, t, j in zip(*((gc != gg) | (kc != kg)).nonzero(as_tuple=True)):
            flips.append(f"layer {layer}, row {int(b)}, token {int(t)}, pick {int(j)}: CPU "
                         f"expert {int(gc[b, t, j])} ({'kept' if kc[b, t, j] else 'dropped'}), "
                         f"card expert {int(gg[b, t, j])} "
                         f"({'kept' if kg[b, t, j] else 'dropped'})")
    return flips[:limit] + ([f"... {len(flips) - limit} more"] if len(flips) > limit else [])


def card_vs_cpu(torch, label, cfg, nudge, n_reqs=4, new=8, flags=None):
    """One model on the card (kernels) against the same weights on the CPU
    (plain path), f32: forward, prefill of 12 and 3 decode steps (logits
    within MODEL_TOL), and the engine's greedy tokens over n_reqs requests.
    The decode steps are also held against the forward's logits unless moe
    capacity may drop picks in the 15-token forward (a decode row never
    drops). For moe the forward's router picks are compared too, and named
    in any failure; a capacity factor below 1 must drop some. Enc-dec
    archs take ENC_FRAMES encoder frames beside the decoder tokens, and the
    engine an enc_len of ENC_FRAMES."""
    from repro_torch.models import RuntimeFlags, build_model
    from repro_torch.models.moe import expert_capacity
    from repro_torch.serving import GenRequest, InferenceEngine

    model = build_model(cfg, RuntimeFlags(**(flags or {})))
    p_cpu = model.init(seed=0, device="cpu")
    if nudge:
        perturb(torch, p_cpu, seed=5)
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    gen = torch.Generator().manual_seed(1)

    encdec = bool(cfg.n_encoder_layers)

    def make(shape):  # tokens, or frontend embeds for vlm
        if cfg.embeds_input and not encdec:
            return 0.02 * torch.randn(*shape, cfg.d_model, generator=gen)
        return torch.randint(0, cfg.vocab_size, shape, generator=gen)

    def frames(*shape):
        return 0.5 * torch.randn(*shape, cfg.d_model, generator=gen)

    enc = frames(2, ENC_FRAMES) if encdec else None

    def inputs(dec, dev="cpu"):  # the model's input: tokens/embeds, or enc-dec's dict
        if not encdec:
            return dec.to(dev)
        return {"enc_embeds": enc.to(dev), "dec_tokens": dec.to(dev)}

    x = make((2, 15))
    worst = 0.0
    dropless = not cfg.n_experts or expert_capacity(cfg, 15) >= 15 * cfg.top_k
    with recorded_picks([]) as picks_cpu:
        lc, aux_c = model.forward(p_cpu, inputs(x))
    with recorded_picks([]) as picks_card:
        lg, aux_g = model.forward(p_gpu, inputs(x, "cuda"))
    flips = pick_flips(picks_cpu, picks_card)
    dropped = sum(int((~keep).sum()) for _, keep in picks_cpu)
    check(cfg.capacity_factor >= 1 or dropped > 0, f"{label}: the forward dropped no pick")
    worst = max(worst, max_err(lg.cpu(), lc))
    aux_err = max((abs(float(aux_g[k]) - float(aux_c[k])) / abs(float(aux_c[k])) for k in aux_c),
                  default=0.0)
    check(aux_err <= MODEL_TOL, f"{label}: card vs CPU aux losses differ by {aux_err:.3g} "
          f"(relative) > {MODEL_TOL}")
    _, cc = model.prefill(p_cpu, inputs(x[:, :12]))
    _, cg = model.prefill(p_gpu, inputs(x[:, :12], "cuda"))
    for c in (cc, cg):
        if "k" not in c:  # ssm: recurrent states only
            continue
        for key in ("k", "v"):
            c[key] = torch.nn.functional.pad(c[key], (0, 0, 0, 0, 0, 3))
        c["pos"] = torch.nn.functional.pad(c["pos"], (0, 3), value=-1)
    for i in range(3):
        pos = torch.full((2,), 12 + i, dtype=torch.int32)
        dc, cc = model.decode(p_cpu, cc, x[:, 12 + i], pos)
        dg, cg = model.decode(p_gpu, cg, x[:, 12 + i].cuda(), pos.cuda())
        worst = max(worst, max_err(dg.cpu(), dc))
        if dropless:
            worst = max(worst, max_err(dg.cpu(), lc[:, 12 + i]))
    check(worst <= MODEL_TOL, f"{label}: card vs CPU max|err| {worst:.3g} > {MODEL_TOL}"
          + (f"; router picks that differ: {flips}" if flips else ""))

    reqs = [GenRequest(uid=i, prompt=make((6 + 3 * i,)), max_new_tokens=new)
            for i in range(n_reqs)]
    if encdec:  # encoder prompts of ENC_FRAMES and fewer frames
        reqs = [dataclasses.replace(r, prompt={"enc_embeds": frames(ENC_FRAMES - 2 * i),
                                               "dec_tokens": r.prompt})
                for i, r in enumerate(reqs)]
    toks = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        out = InferenceEngine(model, p, max_batch=3, max_seq=48, device=dev,
                              enc_len=ENC_FRAMES if encdec else 0).generate(reqs)
        toks[dev] = [out[r.uid].tokens for r in reqs]
    check(toks["cpu"] == toks["cuda"], f"{label} engine: greedy tokens differ {toks}"
          + (f"; router picks that differ: {flips}" if flips else ""))
    moe_note = (f"; router picks of {len(picks_cpu)} layers "
                + (f"differ at {flips}" if flips else "equal")
                + f", {dropped} of {picks_cpu[0][1].numel() * len(picks_cpu)} picks dropped"
                + ("" if dropless else " (capacity may drop: decode not held to the forward)")
                if cfg.n_experts else "")
    say(f"{label} (f32): card vs CPU logits max|err| {worst:.3g} (<= {MODEL_TOL})"
        + (f", aux losses {aux_err:.3g} relative" if aux_c else "")
        + f", greedy tokens equal over {len(reqs)} requests{moe_note}")
    del p_gpu
    torch.cuda.empty_cache()


def ring_card_vs_cpu(torch, W=8, T=20):
    """glm4-9b smoke under `window_override=W`: decode only, through a ring of W
    slots, card against CPU at every step; the windowed forward too."""
    from repro_torch.configs import get_config
    from repro_torch.models import RuntimeFlags, build_model

    cfg = dataclasses.replace(get_config("glm4-9b", smoke=True), dtype="float32")
    model = build_model(cfg, RuntimeFlags(window_override=W))
    p_cpu = model.init(seed=0, device="cpu")
    perturb(torch, p_cpu, seed=6)
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, T), generator=torch.Generator().manual_seed(9))
    lc, _ = model.forward(p_cpu, toks)
    lg, _ = model.forward(p_gpu, toks.cuda())
    worst = max_err(lg.cpu(), lc)
    cc, cg = model.init_cache(2, W, device="cpu"), model.init_cache(2, W, device="cuda")
    for t in range(T):
        pos = torch.full((2,), t, dtype=torch.int32)
        dc, cc = model.decode(p_cpu, cc, toks[:, t], pos)
        dg, cg = model.decode(p_gpu, cg, toks[:, t].cuda(), pos.cuda())
        worst = max(worst, max_err(dg.cpu(), dc))
    check(worst <= MODEL_TOL, f"ring cache: card vs CPU max|err| {worst:.3g} > {MODEL_TOL}")
    check(torch.equal(cg["pos"].cpu(), cc["pos"]), "ring cache: slot positions differ")
    say(f"ring cache (glm4-9b smoke, window {W}, {W} slots, {T} tokens, f32): card vs CPU "
        f"logits max|err| {worst:.3g} (<= {MODEL_TOL})")


def grads_of(torch, model, params, batch):
    """(loss, {name: gradient}) of one batch, parameters requiring grad; a
    leaf the loss never reads (xlstm's sLSTM `ffn_norm`, also unread in the
    reference) gets zeros, as in `make_train_step`. Under a mesh the loss
    is a replicated DTensor and the gradients DTensors."""
    from repro_torch.sharding import whole

    loss, _ = model.loss(params, batch)
    names, leaves = zip(*params.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    return float(whole(loss.detach())), dict(zip(names, grads))


def train_step_launches(cfg):
    """(rmsnorm, rmsnorm_bwd) launches of one train step under remat, from
    `model.rmsnorm_calls`: the forward's norms and again those of every
    checkpointed block, group or layer, and one backward a forward norm."""
    from repro_torch.models.model import rmsnorm_calls

    n, again = rmsnorm_calls(cfg)
    return n + again, n


# phase 4's train steps: (arch, fields replaced on the full config, batch, tokens, AdamW
# steps). Full widths, depth cut, f32, remat on, card against CPU.
TRAIN_CHECKS = [
    ("llama2-7b", {"n_layers": 2}, 2, 64, 3),
    # one group of 6 Mamba2 layers and the shared block, then a remainder layer;
    # 256 tokens in one chunk of the default mamba_chunk = 256: the decay whose
    # exponent overflows above the diagonal (masked before exp)
    ("zamba2-7b", {"n_layers": 7}, 1, 256, 1),
    ("xlstm-1.3b", {"n_layers": 8}, 1, 64, 1),  # one group: 7 mLSTM blocks + the sLSTM
    ("seamless-m4t-large-v2", {"n_layers": 2, "n_encoder_layers": 2}, 2, 64, 1),
]


def train_card_vs_cpu(torch, arch, cut, B, S, steps):
    """One train step of `arch` at full width, depth cut to `cut`, f32,
    remat on, the same weights (norm gammas seeded off 1) on the card
    (kernels: rmsnorm and its backward) and on the CPU (plain): the launches
    `train_step_launches` derives (no attention kernel), the loss within
    MODEL_TOL, every gradient leaf finite and within GRAD_TOL of its largest
    magnitude, then `steps` AdamW steps on both with their losses within
    MODEL_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import RuntimeFlags, build_model
    from repro_torch.training import (AdamWConfig, DataConfig, SyntheticLM, adamw_init,
                                      make_train_step, model_batch)

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **cut)
    model = build_model(cfg, RuntimeFlags(remat=True))
    p_cpu = model.init(seed=0, device="cpu")
    perturb(torch, p_cpu, seed=8)
    p_gpu = copy.deepcopy(p_cpu).to("cuda")
    for p in (p_cpu, p_gpu):
        p.requires_grad_(True)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B, seed=4))
    batches = [model_batch(model, {k: torch.from_numpy(v) for k, v in data.batch(i).items()},
                           torch.float32) for i in range(steps)]
    batch, gpu_batch = batches[0], {k: v.cuda() for k, v in batches[0].items()}
    ops.reset_launches()
    loss_g, grads_g = grads_of(torch, model, p_gpu, gpu_batch)
    torch.cuda.synchronize()
    launched = dict(ops.LAUNCHES)
    loss_c, grads_c = grads_of(torch, model, p_cpu, batch)
    n_fwd, n_bwd = train_step_launches(cfg)
    want = launch_counts(rmsnorm=n_fwd, rmsnorm_bwd=n_bwd)
    check(launched == want, f"{arch} train step launches {launched} != {want}")
    check(abs(loss_g - loss_c) <= MODEL_TOL, f"{arch} train step: loss card {loss_g} vs CPU "
          f"{loss_c}")
    worst, worst_name = 0.0, ""
    for name, gc in grads_c.items():
        gg = grads_g[name].cpu()
        check(bool(torch.isfinite(gg).all()), f"{arch} train step: gradient {name} not finite")
        err = max_err(gg, gc) / max(float(gc.abs().max()), 1e-30)
        if err > worst:
            worst, worst_name = err, name
    check(worst <= GRAD_TOL, f"{arch} train step: gradient {worst_name} differs by {worst:.3g} "
          f"of its largest magnitude > {GRAD_TOL}")
    del grads_g, grads_c
    opt = AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=steps)
    step = make_train_step(model, opt)
    states = [adamw_init(p_cpu), adamw_init(p_gpu)]
    losses = []
    for b in batches:  # a new batch of the synthetic stream each step
        _, states[0], m_c = step(p_cpu, states[0], b)
        _, states[1], m_g = step(p_gpu, states[1], {k: v.cuda() for k, v in b.items()})
        losses.append((float(m_c["loss"]), float(m_g["loss"])))
    diff = max(abs(a - b) for a, b in losses)
    check(diff <= MODEL_TOL, f"{arch} train steps: losses card vs CPU {losses}")
    layers = ", ".join(f"{k}={v}" for k, v in cut.items())
    say(f"train step, {arch} full width, {layers}, f32, batch {B} x {S}, remat: loss card "
        f"{loss_g:.6f} vs CPU {loss_c:.6f}; worst gradient leaf {worst_name} {worst:.3g} of its "
        f"largest magnitude (<= {GRAD_TOL}); launches a step {launched}; {steps} AdamW steps, "
        f"losses (CPU, card) {losses}, max diff {diff:.3g} (<= {MODEL_TOL}); "
        f"{time.perf_counter() - t0:.1f} s")
    del p_gpu, states
    torch.cuda.empty_cache()


def phase_smoke_model(torch):
    from repro_torch.configs import get_config

    for label, arch, kw, flags, nudge in SMOKE_CASES:
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **kw)
        card_vs_cpu(torch, label, cfg, nudge, flags=flags)
    ring_card_vs_cpu(torch)
    # the real widths against the plain path, depth cut: glm4-9b (G = 16,
    # vocab 151552) to 2 layers; mixtral-8x22b (8 experts of d_ff 16384, G = 6,
    # its own capacity factor 1.25) to 1 layer, 2.9 B parameters, 11.6 GB in f32;
    # zamba2-7b to 7 layers (one group of 6 and a remainder of 1; dh = 112 in the
    # f32 FMA flash kernel and in decode); seamless-m4t to 2 + 2 layers (vocab 256206)
    for arch, cut in (("glm4-9b", {"n_layers": 2}), ("mixtral-8x22b", {"n_layers": 1}),
                      ("zamba2-7b", {"n_layers": 7}),
                      ("seamless-m4t-large-v2", {"n_layers": 2, "n_encoder_layers": 2})):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **cut)
        label = f"{arch} full width, " + ", ".join(f"{k}={n}" for k, n in cut.items())
        card_vs_cpu(torch, label, cfg, True, n_reqs=3, new=4)
        say(f"{label}: {time.perf_counter() - t0:.1f} s")
    for arch, cut, B, S, steps in TRAIN_CHECKS:
        train_card_vs_cpu(torch, arch, cut, B, S, steps)


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------


def poisson_trace(cfg, n, rate, n_input, n_output, b_total, seed=0):
    import numpy as np
    import torch

    from repro_torch.serving import GenRequest, ICCRequest

    rng = np.random.default_rng(seed)
    t, reqs = 0.0, []
    for uid in range(n):
        t += rng.exponential(1.0 / rate)
        gen = torch.Generator().manual_seed(uid)
        prompt = torch.randint(0, cfg.vocab_size, (n_input,), generator=gen)
        reqs.append(ICCRequest(GenRequest(uid=uid, prompt=prompt, max_new_tokens=n_output),
                               t_gen=t, t_comm=float(rng.uniform(0.008, 0.03)),
                               b_total=b_total))
    return reqs


FULL_WIDTH = [  # (arch, what runs, layers kept of the full depth, None: all). "serve":
    #               15/15 and 512/64 calibration, ICCServer priority and fifo, decode
    #               profiles; "profile": 15/15 calibration and decode profiles;
    #               "calibrate": 15/15 only; "encdec": requests through the engine
    #               with enc_len (batch 1 and 8) and decode profiles
    ("llama2-7b", "serve", None),  # the paper's serving model
    # glm4-9b and zamba2-7b at half depth since phase 10 took in sharded training,
    # zamba2-7b at a quarter since phase 8 counts the mesh steps, at 13 layers since
    # it counts them on 2 x 16 x 16 too, glm4-9b at a quarter since phase 10 runs
    # context parallelism (the script's 1200 s): per-layer cost, G = 16 and the
    # hybrid groups are as at full depth
    ("glm4-9b", "serve", 10),  # G = 16, QKV bias, vocab 151552; 10 of 40 layers
    ("nemotron-4-15b", "calibrate", None),  # relu2, d_model 6144, G = 6
    # moe: the whole depth does not fit one 80 GB card (~282 and ~217 GB in bf16)
    ("mixtral-8x22b", "serve", 8),  # 8 experts top-2, window 4096 over 576 slots, G = 6
    ("llama4-scout-17b-a16e", "calibrate", 8),  # 16 experts top-1, iRoPE, G = 5
    ("zamba2-7b", "serve", 13),  # hybrid: 13 of 81 Mamba2 layers (2 groups of 6, each with
    #                              the shared block, and a remainder layer), dh 112
    # ssm: 24 of 48 layers, 21 mLSTM + 3 sLSTM blocks, no attention (the script's 1200 s)
    ("xlstm-1.3b", "profile", 24),
    ("seamless-m4t-large-v2", "encdec", None),  # 24 encoder + 24 decoder layers
]
ENC_LEN = 15  # seamless-m4t's encoder frames: Table I's N_input


def phase_full_width(torch):
    """Each full-width path with the launch counts set to 0 just before it
    and read just after; returns their sum over the paths, each arch's
    15/15 calibration (None for enc-dec) and each arch's card memory and
    decode-step walls (`full_width`'s `mem`)."""
    total, cal, mem = {}, {}, {}
    for arch, mode, layers in FULL_WIDTH:
        n, cal[arch], mem[arch] = full_width(torch, arch, mode, layers)
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
    say(f"launches on the main paths, summed: {total}")
    return total, cal, mem


def per_forward(cfg):
    """Kernel launches of one prefill and of one decode step, from the
    reference's code: ((rmsnorm, flash_attention), (rmsnorm, decode_attention))."""
    from repro_torch.models.model import rmsnorm_calls
    from repro_torch.models.transformer import group_shape

    L, norms = cfg.n_layers, rmsnorm_calls(cfg)[0]  # a prefill runs the forward's norms
    if cfg.n_encoder_layers:  # decode: 3 norms a decoder layer + the final norm;
        # encoder, self and cross attention at prefill, self and cross at decode
        return (norms, cfg.n_encoder_layers + 2 * L), (3 * L + 1, 2 * L)
    # attention: every layer of dense and moe, each shared-block application of
    # zamba2's ng, none in xlstm
    attn = {"hybrid": group_shape(cfg)[0], "ssm": 0}.get(cfg.family, L)
    return (norms, attn), (norms, attn)


@contextlib.contextmanager
def counted_forwards(counts):
    """While inside, counts["prefill"] and counts["decode"] grow by one per
    `Model.prefill` and `Model.decode` call, of any family."""
    from repro_torch.models import encdec, transformer

    saved = [(transformer, "decoder_prefill", "prefill"), (transformer, "decoder_decode", "decode"),
             (encdec, "encdec_prefill", "prefill"), (encdec, "encdec_decode", "decode")]
    fns = [getattr(mod, name) for mod, name, _ in saved]

    def counted(fn, key):
        def call(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)
        return call

    for (mod, name, key), fn in zip(saved, fns):
        setattr(mod, name, counted(fn, key))
    try:
        yield counts
    finally:
        for (mod, name, _), fn in zip(saved, fns):
            setattr(mod, name, fn)


def check_launch_identity(arch, cfg, n, fwd):
    """Every kernel's launch count is what fwd["prefill"] prefills and
    fwd["decode"] decode steps of this family predict, and each kernel the
    family runs launched at least once."""
    (r_p, a_p), (r_d, a_d) = per_forward(cfg)
    P, D = fwd["prefill"], fwd["decode"]
    want = launch_counts(rmsnorm=r_p * P + r_d * D,  # serving builds no graph
                         flash_attention=a_p * P, decode_attention=a_d * D)
    check(n == want, f"{arch}: launches {n} != {want} predicted for {P} prefills and {D} "
          f"decode steps ({r_p} rmsnorm + {a_p} flash per prefill, {r_d} rmsnorm + {a_d} "
          "decode_attention per step)")
    ran = {k for k, v in want.items() if v}
    check(all(n[k] > 0 for k in ran) and ran >= {"rmsnorm"},
          f"a kernel of the {arch} path never launched: {n}")
    say(f"{arch}: launch identity holds over {P} prefills and {D} decode steps: "
        f"{r_p} rmsnorm + {a_p} flash_attention per prefill, {r_d} rmsnorm + {a_d} "
        "decode_attention per decode step")


def full_width(torch, arch, mode, layers=None):
    """`arch` in bf16 at full width and depth (or the first `layers`), random
    weights from seed 0, driven as `mode` says (FULL_WIDTH): the launch
    counts are set to 0 just before and read just after, and must be what
    the prefills and decode steps run predict (`per_forward`). The model is
    freed before the next one loads. Returns the launch counts, the 15/15
    calibration (None for enc-dec) and `mem`: the bytes allocated and free
    on the card once the weights are on it, its total, and the profiled
    decode steps' walls (`profile_decode`; empty for "calibrate")."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving import ICCServer, InferenceEngine, measure_service_time

    cfg = get_config(arch)
    depth = f"{cfg.n_layers} layers"
    if cfg.n_encoder_layers:
        depth = f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers"
    if layers:
        depth = f"{layers} of its {cfg.n_layers} layers"
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg)
    t0 = t_path = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    free, total = torch.cuda.mem_get_info()
    mem = {"weights_bytes": torch.cuda.memory_allocated(), "free_bytes": free,
           "total_bytes": total, "step_s": {}}
    moe = (f" experts={cfg.n_experts} top_k={cfg.top_k} capacity_factor={cfg.capacity_factor}"
           if cfg.n_experts else "")
    rec = (f" d_inner={cfg.d_inner} ssm_state={cfg.ssm_state} ssm_head_dim={cfg.ssm_head_dim}"
           f" shared_attn_every={cfg.shared_attn_every}" if cfg.family == "hybrid" else
           f" d_inner={cfg.d_inner} slstm_every={cfg.slstm_every}" if cfg.family == "ssm"
           else "")
    say(f"{arch} full width: {cfg.family}, {depth} d={cfg.d_model} H={cfg.n_heads} "
        f"K={cfg.n_kv_heads} dh={cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"{cfg.activation}{' qkv_bias' if cfg.qkv_bias else ''}{moe}{rec}"
        f"{f' window={cfg.window}' if cfg.window else ''} {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    M, Sc = 8, 576
    fwd = {"prefill": 0, "decode": 0}
    ops.reset_launches()  # this path's run starts here
    with counted_forwards(fwd):
        if mode == "encdec":
            cal15 = None
            encdec_requests(torch, model, params, cfg, M, Sc)
        else:
            cal = {}
            for n_in, n_out, max_seq in ((15, 15, 256), (512, 64, 576))[:2 if mode == "serve"
                                                                         else 1]:
                t = measure_service_time(model, params, n_in, n_out, max_seq=max_seq, repeats=3)
                cal[(n_in, n_out)] = t
                say(f"{arch} measure_service_time {n_in}-in/{n_out}-out (batch 1): prefill "
                    f"{t['prefill_s'] * 1e3:.3f} ms, decode {t['decode_s'] * 1e3:.3f} ms "
                    f"({t['decode_s'] / (n_out - 1) * 1e3:.3f} ms/step), total "
                    f"{t['total_s'] * 1e3:.3f} ms")
            cal15 = cal[(15, 15)]
            svc = cal15["total_s"]
            rate = M / svc  # offered load: what 8 slots serve at batch-1 speed
            b_total = 3.0 * svc
            for policy in ("priority", "fifo") if mode == "serve" else ():
                trace = poisson_trace(cfg, 32, rate, 15, 15, b_total)
                eng = InferenceEngine(model, params, max_batch=M, max_seq=Sc, device="cuda")
                eng.warmup(trace[0].req.prompt)
                srv = ICCServer(eng, policy=policy, est_latency=svc)
                t0 = time.perf_counter()
                st = srv.run(trace)
                wall = time.perf_counter() - t0
                res = list(eng.results.values())
                check(all(1 <= r.n_tokens <= 15 for r in res), "served requests have 1..15 tokens")
                check(all(0 <= tok < cfg.padded_vocab for r in res for tok in r.tokens),
                      "generated token ids out of range")
                e2e = np.array(st.e2e) if st.e2e else np.array([np.nan])
                pre = np.mean([r.prefill_s for r in res]) * 1e3 if res else float("nan")
                steps = [r.decode_s / (r.n_tokens - 1) for r in res if r.n_tokens > 1]
                say(f"{arch} ICCServer {policy}: {st.n_total} requests (rate {rate:.2f}/s, "
                    f"b_total {b_total * 1e3:.1f} ms), served {len(res)}, satisfied "
                    f"{st.n_satisfied}, satisfaction {st.satisfaction:.3f}, dropped "
                    f"{st.n_dropped}, e2e p50 {np.nanpercentile(e2e, 50) * 1e3:.1f} ms p95 "
                    f"{np.nanpercentile(e2e, 95) * 1e3:.1f} ms, prefill mean {pre:.3f} ms, "
                    f"decode step mean {np.mean(steps) * 1e3 if steps else float('nan'):.3f} "
                    f"ms, wall {wall:.1f} s")
                check(st.n_total == 32 and st.n_dropped + len(res) == 32,
                      f"{policy}: every request is served or dropped")
        torch.cuda.synchronize()

    n = dict(ops.LAUNCHES)
    say(f"launches on the {arch} path: {n}")
    check_launch_identity(arch, cfg, n, fwd)
    if mode != "calibrate":
        mem["step_s"] = profile_decode(torch, model, params, cfg, M, Sc)
    del params, model
    torch.cuda.empty_cache()
    say(f"{arch} path: {time.perf_counter() - t_path:.1f} s")
    return n, cal15, mem


def prompt_maker(torch, cfg, gen):
    """prompt(n): n random tokens, or for enc-dec ENC_LEN encoder frames
    (bf16) and n decoder tokens."""
    def prompt(n):
        toks = torch.randint(0, cfg.vocab_size, (n,), generator=gen)
        if not cfg.n_encoder_layers:
            return toks
        frames = 0.5 * torch.randn(ENC_LEN, cfg.d_model, generator=gen)
        return {"enc_embeds": frames.to(torch.bfloat16), "dec_tokens": toks}
    return prompt


def encdec_requests(torch, model, params, cfg, M, Sc, new=15):
    """Enc-dec serving through `InferenceEngine(enc_len=ENC_LEN)`: ENC_LEN
    encoder frames and a 1-token decoder prompt per request, `new` tokens
    each, at batch 1 (3 requests in turn) and batch M (M requests at once);
    prefill and decode-step times are the engine's (device synchronised)."""
    import numpy as np

    from repro_torch.serving import GenRequest, InferenceEngine

    prompt = prompt_maker(torch, cfg, torch.Generator().manual_seed(3))
    for batch, n_req in ((1, 3), (M, M)):
        eng = InferenceEngine(model, params, max_batch=batch, max_seq=Sc, enc_len=ENC_LEN,
                              device="cuda")
        eng.warmup(prompt(1))
        reqs = [GenRequest(uid=i, prompt=prompt(1), max_new_tokens=new) for i in range(n_req)]
        t0 = time.perf_counter()
        res = list(eng.generate(reqs).values())
        wall = time.perf_counter() - t0
        check(all(r.n_tokens == new for r in res), f"enc-dec requests give {new} tokens each")
        check(all(0 <= tok < cfg.padded_vocab for r in res for tok in r.tokens),
              "generated token ids out of range")
        steps = [r.decode_s / (r.n_tokens - 1) for r in res]
        say(f"{cfg.name} engine enc_len={ENC_LEN}, batch {batch}: {n_req} requests of "
            f"{ENC_LEN} frames + 1 token -> {new} tokens, prefill mean "
            f"{np.mean([r.prefill_s for r in res]) * 1e3:.3f} ms, decode step mean "
            f"{np.mean(steps) * 1e3:.3f} ms, wall {wall:.2f} s")


# ---------------------------------------------------------------------------
# phase 6: service capacity on measured compute
# ---------------------------------------------------------------------------

CAPACITY_SIM_TIME, CAPACITY_SEEDS = 30.0, 3  # Fig. 6's


def phase_capacity(cal, card):
    """Fig. 6 on the port's simulator: the analytic H100 service time at the
    paper's 80 ms budget, then llama2-7b's measured one (phase 5's 15/15
    calibration) at 80 ms and at the scaled budget (`launch.capacity.run`,
    serial sweeps); then faults and controllers near the scaled budget's ICC
    capacity (`faults_and_controllers`)."""
    from repro_torch.core.latency_model import H100, LLAMA2_7B, ModelService
    from repro_torch.core.scheduler import Job
    from repro_torch.launch.capacity import run
    from repro_torch.serving import MeasuredService

    t0 = time.perf_counter()
    measured = MeasuredService(cal["prefill_s"], cal["decode_s"], 15, 15)
    want = cal["prefill_s"] + cal["decode_s"]
    got = measured(Job(-1, -1, 0.0, 15, 15, 0.08))
    check(abs(got - want) <= 1e-12 * want,
          f"measured service at 15/15 {got!r} != prefill + decode {want!r}")
    calib = (f"llama2-7b 15/15 calibration: prefill {cal['prefill_s'] * 1e3:.3f} ms, "
             f"decode {cal['decode_s'] * 1e3:.3f} ms")
    for label, svc, budget in (("h100 analytic", ModelService(H100, LLAMA2_7B), "paper"),
                               ("measured", measured, "paper"),
                               ("measured", measured, "scaled")):
        r = run(svc, budget=budget, sim_time=CAPACITY_SIM_TIME, n_seeds=CAPACITY_SEEDS, log=say)
        scaled_icc = r["schemes"]["icc"]["capacity"]
        name = f"{label}, budget {budget}"
        for scheme, s in r["schemes"].items():
            check(all(n >= 1 for n in s["n_jobs"]),
                  f"{name} {scheme}: a sweep point scored no job: {s['n_jobs']}")
            check(all(0.0 <= x <= 1.0 for x in s["satisfaction"]),
                  f"{name} {scheme}: satisfaction outside [0, 1]: {s['satisfaction']}")
            check(math.isfinite(s["capacity"]) and 0.0 <= s["capacity"] <= max(r["rates"]),
                  f"{name} {scheme}: capacity {s['capacity']} not in [0, {max(r['rates'])}]")
        caps = {k: s["capacity"] for k, s in r["schemes"].items()}
        mec = caps["disjoint_mec"]
        ratio = f"{caps['icc'] / mec:.3f}" if mec else ("inf" if caps["icc"] else "n/a (both 0)")
        say(f"capacity ({name}): service {r['service_ms']:.3f} ms per 15/15 job, k "
            f"{r['k']:.4f}, b_total {r['b_total_ms']:.2f} ms, rates {r['rates']}; ICC "
            f"{caps['icc']:.3f}, disjoint_ran {caps['disjoint_ran']:.3f}, disjoint_mec "
            f"{mec:.3f} prompts/s; ICC/MEC {ratio}; {calib}; card {card}")
    faults_and_controllers(measured, scaled_icc, calib, card)
    say(f"phase 6 (capacity, {CAPACITY_SEEDS} seeds, sim_time {CAPACITY_SIM_TIME:g} s at 80 ms) took "
        f"{time.perf_counter() - t0:.1f} s")


# phase 6's fault runs: three one-second outages of the node and a brownout
# (service twice as long) inside the scored span of Fig. 6's 30 s
FAULT_OUTAGES = ((8.0, 9.0), (15.0, 16.0), (22.0, 23.0))
FAULT_BROWNOUT = (11.0, 14.0, 2.0)  # start, end, slow factor


def faults_and_controllers(measured, capacity, calib, card):
    """ICC on llama2-7b's measured service at the scaled budget, at the
    whole-UE rate nearest ICC's capacity there, CAPACITY_SEEDS seeds (those
    of the sweep): fault-free; an empty FaultSpec; FAULT_OUTAGES and
    FAULT_BROWNOUT with the lost jobs redispatched and dropped; each
    controller preset. Checks that the static preset and the empty spec
    leave every field of every result as the plain run's, that every
    satisfaction lies in [0, 1] and that with redispatch off the crashes
    drop at least one job with reason node_failure."""
    from repro_torch.core.simulator import simulate
    from repro_torch.faults import Brownout, FaultSpec, NodeOutage
    from repro_torch.launch.capacity import budgeted

    t0 = time.perf_counter()
    service_s, k, schemes, base = budgeted(measured, "scaled", CAPACITY_SIM_TIME)
    n_ues = max(1, int(round(capacity)))
    spec = FaultSpec(node_outages=tuple(NodeOutage("node", a, b) for a, b in FAULT_OUTAGES),
                     brownouts=(Brownout("node", *FAULT_BROWNOUT),))
    runs = {"no faults, no controller": {}, "FaultSpec()": {"faults": FaultSpec()},
            "faults, redispatch": {"faults": spec},
            "faults, no redispatch": {"faults": dataclasses.replace(spec, redispatch=False)},
            "controller static": {"controller": "static"},
            "controller reactive": {"controller": "reactive"},
            "controller slack_aware_joint": {"controller": "slack_aware_joint"}}
    res = {name: [simulate(schemes["icc"], dataclasses.replace(base, n_ues=n_ues,
                                                               seed=base.seed + 1000 * i),
                           measured, **kw) for i in range(CAPACITY_SEEDS)]
           for name, kw in runs.items()}

    def fields(r):
        return repr({f: v for f, v in dataclasses.asdict(r).items() if f != "profile"})

    plain = [fields(r) for r in res["no faults, no controller"]]
    for name in ("FaultSpec()", "controller static"):
        check([fields(r) for r in res[name]] == plain,
              f"{name}: a result differs from the plain run's")
    for name, rs in res.items():
        sats = [r.satisfaction for r in rs]
        check(all(0.0 <= x <= 1.0 for x in sats), f"{name}: satisfaction outside [0, 1]: {sats}")
        drops = {}
        for r in rs:
            for why, n in (r.drop_reasons or {}).items():
                drops[why] = drops.get(why, 0) + n
        say(f"faults/controllers ({name}): ICC at {n_ues} UEs, scaled budget (k {k:.4f}, "
            f"b_total {base.b_total * 1e3:.2f} ms, service {service_s * 1e3:.3f} ms), "
            f"satisfaction {statistics.mean(sats):.4f} (seeds {[round(x, 4) for x in sats]}), "
            f"jobs {sum(r.n_jobs for r in rs)}, drops by reason {drops}")
    lost = sum((r.drop_reasons or {}).get("node_failure", 0) for r in res["faults, no redispatch"])
    check(lost >= 1, "with redispatch off the crashes dropped no job with reason node_failure")
    say(f"faults/controllers: outages {FAULT_OUTAGES} s, brownout {FAULT_BROWNOUT} (start, end, "
        f"factor); static preset and FaultSpec() equal the plain run field for field; {calib}; "
        f"card {card}; {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 7: training at full width
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 4, 512
# (arch, fields replaced on the full config, steps, whether the first batch's bf16
# gradient is held to f32's (`bf16_against_f32`) or only printed): full widths,
# bf16, remat on. The recurrent stacks amplify bf16's rounding at random init, so
# there a correct bf16 gradient points away from f32's, further with depth: the
# reference's own zamba2-7b at smoke width, 13 layers, has cosines of 0.98 between
# the two, and the port's drift is held to the reference's on the CPU
# (tests/test_torch_training_families.py::TestBf16Drift)
TRAIN_RUNS = [
    ("llama2-7b", {"n_layers": 16}, 10, True),  # 16 of 32 layers: 3.50 B parameters, 42 GB
    # 39 of 81 layers: 6 groups of 6 Mamba2 layers (each followed by the shared
    # block) and 3 remainder layers, ~3.47 B parameters, ~41.6 GB; all 81 need ~81 GB
    ("zamba2-7b", {"n_layers": 39}, 5, False),
    # 16 of 48 layers (2 groups of 7 mLSTM + 1 sLSTM; cut for the script's 1200 s:
    # its host-bound steps took ~15 s each on a slow host at 48 layers, 7.1 s at 24)
    ("xlstm-1.3b", {"n_layers": 16}, 5, False),
    ("seamless-m4t-large-v2", {}, 5, True),  # 24 + 24 layers, vocab 256206: ~2.0 B, ~24.5 GB
]


def attention_squares(cfg, B, S):
    """[(forward flops of QK^T and PV over the full square, causal)] for each
    attention a forward runs at S tokens (S encoder frames for enc-dec: the
    loop hashes the stream's tokens into them)."""
    full = 2 * 2 * B * cfg.n_heads * S * S * cfg.head_dim
    if cfg.n_encoder_layers:  # encoder (full), decoder self (causal), cross (full)
        return ([(full, False)] * cfg.n_encoder_layers + [(full, True)] * cfg.n_layers
                + [(full, False)] * cfg.n_layers)
    if cfg.family == "hybrid":  # the shared block, once a group
        return [(full, True)] * (cfg.n_layers // cfg.shared_attn_every)
    if cfg.family == "ssm":
        return []
    return [(full, True)] * cfg.n_layers


def train_reckoning(cfg, params, B, S):
    """The step's work from its shapes: model flops (6 N T for the matmul
    parameters as the forward applies them: every one but the embedding, a
    gather, and zamba2's shared block once a group; attention's forward and
    backward (3x) over the causal half, or the whole square where it is not
    causal; the recurrent scans' own products, Mamba2's intra-chunk form and
    mLSTM's, are not counted), the flops issued (remat runs the checkpointed
    blocks' or groups' forward again, 2 N_ckpt T, less each one's last
    product: PyTorch's non-reentrant checkpoint stops recomputing once the
    tensors the backward needs are back, and the final MLP projection's
    output, w2 or the sLSTM's ffn_w2, is not among them; naive attention
    computes the full square, 4 times), and the bytes the AdamW pass must
    move (22 a parameter: bf16 p and g read, p written, f32 mu and nu read
    and written)."""
    T = B * S
    n = sum(p.numel() for p in params.parameters())
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    n_mm = n - params.embed.numel()
    if cfg.n_encoder_layers:
        n_ckpt = count(params.enc_layers) + count(params.dec_layers) - sum(
            lp.mlp.w2.numel() for lp in (*params.enc_layers, *params.dec_layers))
    elif cfg.family == "hybrid":
        ng = cfg.n_layers // cfg.shared_attn_every
        n_mm += (ng - 1) * count(params.shared)
        n_ckpt = count(params.mamba_groups) + ng * (count(params.shared)
                                                    - params.shared.mlp.w2.numel())
    elif cfg.family == "ssm":
        n_ckpt = count(params.mlstm_groups) + count(params.slstm_blocks) - sum(
            b.slstm.ffn_w2.numel() for b in params.slstm_blocks)
    else:
        n_ckpt = count(params.layers) - sum(lp.mlp.w2.numel() for lp in params.layers)
    squares = attention_squares(cfg, B, S)
    return {
        "params": n,
        "model_flops": 6 * n_mm * T + sum(3 * a * (0.5 if c else 1.0) for a, c in squares),
        "issued_flops": 6 * n_mm * T + 2 * n_ckpt * T + sum(4 * a for a, _ in squares),
        "adamw_bytes": 22 * n,
    }


@contextlib.contextmanager
def timed_updates(torch, marks):
    """While inside, every `adamw_update` of a train step appends its
    (start, end) host times, the device synchronised at both."""
    from repro_torch.training import loop

    update = loop.adamw_update

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = update(*args, **kwargs)
        torch.cuda.synchronize()
        marks.append((t0, time.perf_counter()))
        return out

    loop.adamw_update = timed
    try:
        yield marks
    finally:
        loop.adamw_update = update


def phase_training(torch, card):
    """Each config of TRAIN_RUNS at full width (`train_full_width`), then a
    checkpoint round trip. Returns the train_loop runs' launch counts,
    summed, and each run's peak device memory (bytes) by arch."""
    t_phase = time.perf_counter()
    launches, peaks = {}, {}
    for arch, cut, steps, hold in TRAIN_RUNS:
        counts, peaks[arch] = train_full_width(torch, card, arch, cut, steps, hold)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    checkpoint_round_trip(torch)
    say(f"phase 7 (training) took {time.perf_counter() - t_phase:.1f} s")
    return launches, peaks


# the bf16 gradient of phase 7's first batch against the f32 gradient of the same
# weights and batch: each part of the tree (a stack, the embedding, a final norm)
# and the whole, and the loss. bf16 rounds each activation to 2^-9, so through
# the attention stacks the gradient misses f32's by well under a percent; a
# wrong gradient (a sign, a dropped term, another layer's input) points elsewhere.
BF16_GRAD_COS = 0.99  # cosine of each part's gradient with f32's, at least
BF16_GRAD_NORM = 0.05  # |the global norm's ratio to f32's - 1|, at most
BF16_LOSS = 0.05  # |loss - f32's loss|, at most


def bf16_against_f32(torch, cfg, rt, model, params, batch, hold):
    """The loss and gradient of `batch` under the bf16 `params` on the card
    against the same weights widened to f32 (an f32 model of `cfg`, the
    same RuntimeFlags): the loss within BF16_LOSS and, with `hold`, each
    part's cosine at least BF16_GRAD_COS (a part whose f32 gradient is
    zero, as xlstm's unread sLSTM ffn_norm, must be zero in bf16 too) and
    the global norm within BF16_GRAD_NORM of f32's. Returns the line of
    numbers it compared."""
    import gc

    from repro_torch.models import build_model
    from repro_torch.training import model_batch

    model32 = build_model(dataclasses.replace(cfg, dtype="float32"), rt)
    params32 = model32.init(seed=0, device="cuda")
    with torch.no_grad():
        for p32, p in zip(params32.parameters(), params.parameters()):
            p32.copy_(p)
    params32.requires_grad_(True)
    loss32, g32 = grads_of(torch, model32, params32, model_batch(model32, batch, torch.float32))
    del params32
    gc.collect()
    params.requires_grad_(True)
    loss16, g16 = grads_of(torch, model, params, model_batch(model, batch, params.embed.dtype))
    parts = {}  # part: [<g16, g32>, |g16|^2, |g32|^2]
    for name, a in g16.items():
        b, acc = g32[name], parts.setdefault(name.split(".")[0], [0.0, 0.0, 0.0])
        a = a.float()
        acc[0] += float((a * b).sum())
        acc[1] += float(a.square().sum())
        acc[2] += float(b.square().sum())
    del g16, g32
    gc.collect()
    torch.cuda.empty_cache()
    cos = {k: (dot / math.sqrt(n16 * n32) if n32 else float(n16 == 0))
           for k, (dot, n16, n32) in parts.items()}
    ratio = math.sqrt(sum(v[1] for v in parts.values()) / sum(v[2] for v in parts.values()))
    line = (f"loss bf16 {loss16:.5f} vs f32 {loss32:.5f}; gradient norm ratio {ratio:.5f}; "
            "cosine by part " + ", ".join(f"{k} {v:.5f}" for k, v in cos.items()))
    check(abs(loss16 - loss32) <= BF16_LOSS, f"{cfg.name}: the bf16 loss is not f32's "
          f"(within {BF16_LOSS}): {line}")
    check(not hold or (abs(ratio - 1) <= BF16_GRAD_NORM and min(cos.values()) >= BF16_GRAD_COS),
          f"{cfg.name}: the bf16 gradient is not f32's (norm within {BF16_GRAD_NORM}, each "
          f"part's cosine >= {BF16_GRAD_COS}): {line}")
    return line + ("" if hold else " (gradient printed, not held: a recurrent stack)")


def train_full_width(torch, card, arch, cut, steps, hold):
    """`arch` at full width, bf16, depth cut to `cut`, batch TRAIN_BATCH x
    TRAIN_SEQ, remat on, AdamW at lr 3e-4 from `Model.init(seed=0)`: `steps`
    steps of `train_loop` on `SyntheticLM` with the launch counts set to 0
    just before and read just after (`train_step_launches` a step, no
    attention kernel), every loss and gradient norm finite and the last
    loss below the first; before it the first batch's bf16 loss and, with
    `hold`, gradient held against f32's (`bf16_against_f32`), after it one
    profiled step.
    Returns the train_loop run's launch counts and its peak device memory
    (`max_memory_allocated`, bytes)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import RuntimeFlags, build_model
    from repro_torch.training import (AdamWConfig, DataConfig, SyntheticLM, adamw_init,
                                      adamw_update, make_train_step, model_batch, train_loop)

    t_run = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, **cut)
    L, B, S = cfg.n_layers, TRAIN_BATCH, TRAIN_SEQ
    rt = RuntimeFlags(remat=True)
    model = build_model(cfg, rt)
    params = model.init(seed=0, device="cuda")
    work = train_reckoning(cfg, params, B, S)
    peak = PEAK_FLOPS["bfloat16"]
    depth = (f"{L} of its {full.n_layers} layers" if not cfg.n_encoder_layers else
             f"{cfg.n_encoder_layers} + {L} of its {full.n_encoder_layers} + {full.n_layers} "
             f"layers")
    fb_bound, opt_bound = work["model_flops"] / peak * 1e3, work["adamw_bytes"] / HBM_BYTES_PER_S * 1e3
    say(f"training {arch} full width: {depth}, d={cfg.d_model} H={cfg.n_heads} "
        f"d_ff={cfg.d_ff} vocab {cfg.vocab_size} (padded {cfg.padded_vocab}), {cfg.dtype}, "
        f"{work['params'] / 1e9:.3f} B params, batch {B} x {S}, remat; reckoning: model "
        f"{work['model_flops'] / 1e12:.2f} TFLOP (6 N T for the matmul parameters as applied, "
        f"plus attention; recurrent scans not counted), issued "
        f"{work['issued_flops'] / 1e12:.2f} TFLOP ({work['issued_flops'] / peak * 1e3:.1f} ms at "
        f"{peak / 1e12:g} TFLOP/s), AdamW {work['adamw_bytes'] / 1e9:.1f} GB; bound "
        f"{fb_bound:.1f} ms (model flops at {peak / 1e12:g} TFLOP/s) + {opt_bound:.1f} ms (AdamW "
        f"at {HBM_BYTES_PER_S / 1e12:g} TB/s)")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B)
    # 3e-4 held (the cosine runs over 1000 steps): at llama2-7b's width 1e-3 and
    # 3e-3 made the loss rise within 10 steps (PERF.md §6)
    oc = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=1000)
    first = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(dc).batch(0).items()}
    t_check = time.perf_counter()
    say(f"{arch} first batch, bf16 against f32 on the card: "
        f"{bf16_against_f32(torch, cfg, rt, model, params, first, hold)}; "
        f"{time.perf_counter() - t_check:.1f} s")
    del first
    marks = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()  # this path's run starts here
    t0 = time.perf_counter()
    with timed_updates(torch, marks):
        params, hist = train_loop(model, dc, oc, n_steps=steps, log_every=1, log_fn=say,
                                  params=params)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    mem = torch.cuda.max_memory_allocated()
    n_fwd, n_bwd = train_step_launches(cfg)
    say(f"launches on the {arch} training path: {launches}")
    want = launch_counts(rmsnorm=steps * n_fwd, rmsnorm_bwd=steps * n_bwd)
    check(launches == want, f"{arch} training launches {launches} != {want} ({steps} steps of "
          f"{n_fwd} rmsnorm (forward, remat) and {n_bwd} rmsnorm_bwd, no attention kernel)")
    check(len(hist) == steps and all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                                     for h in hist), f"{arch}: non-finite loss or grad norm: {hist}")
    check(hist[-1]["loss"] < hist[0]["loss"],
          f"{arch}: loss did not fall: {hist[0]['loss']} -> {hist[-1]['loss']}")
    ends = [t0] + [e for _, e in marks]
    step_s = [b - a for a, b in zip(ends, ends[1:])]
    opt_s = [e - b for b, e in marks]
    steady = step_s[1:]
    mean_step = sum(steady) / len(steady)
    mean_opt = sum(opt_s[1:]) / len(steady)
    say(f"{arch} training steps (wall, synchronised): step 0 {step_s[0] * 1e3:.3f} ms (first), "
        f"steps 1-{steps - 1} mean {mean_step * 1e3:.3f} ms (min {min(steady) * 1e3:.3f}, max "
        f"{max(steady) * 1e3:.3f}) = forward + backward {(mean_step - mean_opt) * 1e3:.3f} ms + "
        f"optimizer {mean_opt * 1e3:.3f} ms (bound {fb_bound:.1f} + {opt_bound:.1f}); "
        f"{B * S / mean_step:.1f} tokens/s; model-flop share "
        f"{work['model_flops'] / mean_step / peak:.4f} and issued-flop share "
        f"{work['issued_flops'] / mean_step / peak:.4f} of {peak / 1e12:g} TFLOP/s; optimizer "
        f"{work['adamw_bytes'] / mean_opt / 1e12:.3f} TB/s of {HBM_BYTES_PER_S / 1e12:g}; peak "
        f"device memory "
        f"{mem / 2**30:.2f} GiB; loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} (ln V "
        f"{math.log(cfg.vocab_size):.4f}, stream floor {dc.loss_floor:.4f}); card {card}")

    # one more step under the profiler, with fresh moments (train_loop's are
    # freed): the loss and gradients profiled apart from the optimizer
    state = adamw_init(params)
    batch = model_batch(model, {k: torch.from_numpy(v).cuda()
                                for k, v in SyntheticLM(dc).batch(steps).items()},
                        params.embed.dtype)
    grads = {}
    make_train_step(model, oc)(params, state, batch)  # warm both paths
    torch.cuda.synchronize()
    ops.reset_launches()
    groups, n_fb, by_name = _device_time(
        torch, lambda: grads.update(grads_of(torch, model, params, batch)[1]), ranges=False)
    one = dict(ops.LAUNCHES)
    check(one == launch_counts(rmsnorm=n_fwd, rmsnorm_bwd=n_bwd),
          f"{arch}: one train step's launches {one}")
    opt, n_opt, opt_names = _device_time(torch, lambda: adamw_update(oc, params, grads, state),
                                         ranges=False)
    fb_ms, opt_ms = sum(groups.values()) / 1e3, sum(opt.values()) / 1e3
    for k, v in opt_names.items():
        by_name[k] = by_name.get(k, 0.0) + v
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    say(f"{arch} training step profile: device busy {fb_ms + opt_ms:.3f} ms "
        f"({100 * (fb_ms + opt_ms) / (mean_step * 1e3):.1f}% of the {mean_step * 1e3:.3f} ms step): "
        f"forward + backward {fb_ms:.3f} ms in {n_fb} kernels ("
        + ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in groups.items()
                    if k not in (ROUTING, RECURRENT, "decode_attention"))
        + f"), optimizer {opt_ms:.3f} ms in {n_opt} kernels; top kernels "
        + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top))
    say(f"{arch}: one train step's launches: {one} ({n_fwd} rmsnorm, {n_bwd} rmsnorm_bwd); "
        f"{time.perf_counter() - t_run:.1f} s")
    del params, state, batch, grads, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, mem


def checkpoint_round_trip(torch):
    """llama2-7b smoke, bf16, on the card through `train_loop`: a straight
    8-step run; a 4-step run that checkpoints; the checkpoint restored into
    fresh parameters and moments (bit-equal to the run's parameters, and
    written again, entry for entry the same bytes); and a run resumed from
    it to 8 steps, whose losses and weights equal the straight run's."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, DataConfig, adamw_init, restore_checkpoint,
                                      save_checkpoint, train_loop)

    cfg = get_config("llama2-7b", smoke=True)  # bf16
    model = build_model(cfg)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=4)
    oc = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    quiet = lambda msg: None  # noqa: E731
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build", prefix="ckpt_"))
    try:
        p_a, h_a = train_loop(model, dc, oc, 8, log_every=1, log_fn=quiet,
                              params=model.init(seed=0))
        p_b, _ = train_loop(model, dc, oc, 4, ckpt_dir=str(tmp / "run"), ckpt_every=4,
                            log_fn=quiet, params=model.init(seed=0))
        fresh = model.init(seed=1)
        state = adamw_init(fresh)
        _, step = restore_checkpoint(str(tmp / "run"), (fresh, state))
        check(step == 4 and int(state["step"]) == 4, f"restored step {step}")
        check(all(torch.equal(a, b) for a, b in zip(fresh.parameters(), p_b.parameters())),
              "checkpoint round trip: restored weights differ from the saved run's")
        save_checkpoint(str(tmp / "again"), 4, (fresh, state))
        with np.load(tmp / "run" / "ckpt_00000004.npz") as x, \
                np.load(tmp / "again" / "ckpt_00000004.npz") as y:
            check(x.files == y.files and all(x[k].tobytes() == y[k].tobytes() for k in x.files),
                  "checkpoint round trip: the restored state writes other bytes")
            n_entries = len(x.files)
        p_c, h_c = train_loop(model, dc, oc, 8, ckpt_dir=str(tmp / "run"), log_every=1,
                              log_fn=quiet, params=model.init(seed=2))
        resumed = [h["loss"] for h in h_c]
        straight = [h["loss"] for h in h_a[4:]]
        check(resumed == straight, f"resumed losses {resumed} != straight {straight}")
        check(all(torch.equal(a, b) for a, b in zip(p_c.parameters(), p_a.parameters())),
              "resumed weights differ from the straight run's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"checkpoint round trip on the card (llama2-7b smoke, bf16): {n_entries} entries "
        f"restored bit-equal and written again byte-equal; steps 4-7 resumed equal the "
        f"straight run's losses {straight} and weights, bit for bit")


# ---------------------------------------------------------------------------
# phase 8: the dry run (meta device, host only) held against the card
# ---------------------------------------------------------------------------

# phase 10: each run at full width, bf16, seed 0, a prompt of SHARDED_PROMPT
# tokens (seamless-m4t: ENC_LEN encoder frames and SHARDED_PROMPT decoder
# tokens) at batch SHARDED_BATCH, then its greedy steps: (arch, layers (None:
# the config's), decode steps). mixtral-8x22b keeps phase 5's 8 of 56 layers
SHARDED_BATCH, SHARDED_PROMPT = 8, 15
SHARDED_RUNS = (
    ("llama2-7b", None, 15),
    ("mixtral-8x22b", 8, 4),
    ("zamba2-7b", None, 4),
    ("xlstm-1.3b", None, 4),
    ("seamless-m4t-large-v2", None, 4),
)
# on a one-rank mesh every local shard is the whole tensor and the same
# kernels and ops run in the same order on the same storage (the recurrences
# and moe routing inside `run_local` run the unsharded code on it), so the
# logits must be bit for bit the unsharded run's, every family's
SHARDED_LOGIT_TOL = 0.0
# The aten ops that reach DTensor's dispatcher on the sharded paths of every
# family (outside `local_map`), as the CPU rehearsal of this phase's runs at
# smoke size recorded them (less aten.max and aten._local_scalar_dense: the
# ring cache's wrap check reads positions that are on the host only); each
# must have a sharding rule in the card's torch (2.11 has none for aten.roll,
# which `rope.rotate` therefore avoids), checked before any sharded run so
# that a missing one names itself
DTENSOR_OPS = (
    "aten._to_copy.default", "aten._unsafe_view.default", "aten.add.Tensor",
    "aten.bmm.default", "aten.cat.default", "aten.clone.default", "aten.copy_.default",
    "aten.cos.default", "aten.detach.default", "aten.div.Tensor", "aten.full_like.default",
    "aten.gelu.default", "aten.mm.default", "aten.mul.Tensor", "aten.neg.default",
    "aten.new_zeros.default", "aten.select.int", "aten.silu.default", "aten.sin.default",
    "aten.slice.Tensor", "aten.stack.default", "aten.transpose.int", "aten.unsqueeze.default",
    "aten.view.default",
    # the training paths' (tests/test_torch_sharded_training.py records them): the
    # backward's and the optimizer's
    "aten.add_.Tensor", "aten.addcmul_.default", "aten.div_.Tensor", "aten.expand.default",
    "aten.gelu_backward.default", "aten.gt.Scalar", "aten.mul_.Tensor",
    "aten.ones_like.default", "aten.permute.default", "aten.pow.Tensor_Scalar",
    "aten.select_backward.default", "aten.silu_backward.default", "aten.slice_backward.default",
    "aten.sqrt.default", "aten.squeeze.dim", "aten.sub_.Tensor", "aten.sum.default",
    "aten.sum.dim_IntList", "aten.t.default", "aten.zeros_like.default",
)


def dtensor_op_probe(torch):
    """The ops of DTENSOR_OPS that the running torch's DTensor has no
    sharding rule or handler for (empty when every one is covered)."""
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    prop = disp.sharding_propagator
    known = {str(op) for table in (prop.op_strategy_funcs, getattr(prop, "op_to_rules", {}),
                                   getattr(prop, "op_single_dim_strategy_funcs", {}),
                                   getattr(disp, "_custom_op_handlers", {}))
             for op in table}
    return [op for op in DTENSOR_OPS if op not in known]


def greedy_run(torch, model, params, prompt, steps, mesh=None):
    """Prefill (twice: the first call pays what a cold path pays, the
    second is timed warm and kept), then `steps` greedy decode steps over a
    cache of prompt + steps slots, unsharded or under `mesh` (prefill under
    PREFILL_RULES, decode under DECODE_RULES, the parameters distributed
    once). `prompt` is tokens (B, S) or enc-dec's {"enc_embeds",
    "dec_tokens"}; only the self-attention leaves (k, v, pos) get the empty
    slots, the cross and recurrent ones are kept as prefill left them. ->
    (every step's logits, prefill's first, (steps + 1, B, V) f32; the tokens
    fed (steps, B); the two prefills' walls s; each decode step's wall s),
    each wall synchronised."""
    from repro_torch import sharding as sh

    full = (lambda t: t.full_tensor()) if mesh else (lambda t: t)
    use = ((lambda rules: sh.use_mesh(mesh, rules)) if mesh
           else (lambda rules: contextlib.nullcontext()))

    def tree(t):
        return {k: tree(v) for k, v in t.items()} if isinstance(t, dict) else full(t)

    toks0 = prompt["dec_tokens"] if isinstance(prompt, dict) else prompt
    B, S = toks0.shape
    with torch.no_grad():
        with use(sh.PREFILL_RULES):
            p = model.distribute_params(params) if mesh else params
            prefill_s = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = model.prefill(p, prompt)
                logits = full(logits)
                torch.cuda.synchronize()
                prefill_s.append(time.perf_counter() - t0)
        cache = tree(cache)
        for k in ("k", "v"):  # room for the steps: empty slots after the prompt's
            if k in cache:
                cache[k] = torch.nn.functional.pad(cache[k], (0, 0, 0, 0, 0, steps))
        if "pos" in cache:
            cache["pos"] = torch.nn.functional.pad(cache["pos"], (0, steps), value=-1)
        out, toks, walls = [logits.float()], [], []
        with use(sh.DECODE_RULES):
            for i in range(steps):
                tok = out[-1].argmax(-1).to(torch.int32)
                pos = torch.full((B,), S + i, dtype=torch.int32, device=toks0.device)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = model.decode(p, cache, tok, pos)
                logits = full(logits)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                toks.append(tok)
                out.append(logits.float())
    return torch.stack(out), torch.stack(toks), prefill_s, walls


def sharded_run(torch, card, mesh, arch, layers, steps):
    """One arch of phase 10: unsharded, then under `mesh`, on the same
    weights -> its launch counts under the mesh."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    t_run = time.perf_counter()
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (SHARDED_BATCH, SHARDED_PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    if cfg.n_encoder_layers:
        frames = 0.5 * torch.randn(SHARDED_BATCH, ENC_LEN, cfg.d_model, generator=gen,
                                   device="cuda")
        prompt = {"enc_embeds": frames.to(torch.bfloat16), "dec_tokens": prompt}
    ref, ref_toks, ref_pre, ref_walls = greedy_run(torch, model, params, prompt, steps)
    ops.reset_launches()  # the sharded path's run starts here
    got, toks, pre, walls = greedy_run(torch, model, params, prompt, steps, mesh)
    torch.cuda.synchronize()
    n = dict(ops.LAUNCHES)
    (r_p, a_p), (r_d, a_d) = per_forward(cfg)
    # every decode call's cache (self and cross) has its slots on "model", of size 1: the
    # kernel's lse mode on the rank's slots, the parts merged (`ops._decode_over_slots`)
    want = launch_counts(rmsnorm=2 * r_p + r_d * steps, flash_attention=2 * a_p,
                         decode_attention_lse=a_d * steps)
    diff = float((got - ref).abs().max())
    med = statistics.median
    depth = (f"{cfg.n_encoder_layers} + {cfg.n_layers} layers" if cfg.n_encoder_layers
             else f"{cfg.n_layers}{'' if layers is None else ' of ' + str(get_config(arch).n_layers)}"
             f" layers")
    prompt_s = (f"{ENC_LEN} encoder frames and {SHARDED_PROMPT} decoder tokens"
                if cfg.n_encoder_layers else f"{SHARDED_PROMPT} tokens")
    say(f"sharded serving {arch} full width ({cfg.family}): {depth} d={cfg.d_model} "
        f"H={cfg.n_heads} K={cfg.n_kv_heads} {cfg.dtype}, mesh (1, 1) ('data', 'model') over "
        f"NCCL, 1 rank; prefill {prompt_s} at batch {SHARDED_BATCH} under PREFILL_RULES, "
        f"{steps} greedy decode steps under DECODE_RULES")
    say(f"sharded serving {arch}: greedy tokens identical to the unsharded run: "
        f"{bool(torch.equal(toks, ref_toks))}; largest |logit difference| {diff:.6g} "
        f"over {tuple(got.shape)}")
    say(f"sharded serving {arch} walls: prefill {pre[1] * 1e3:.3f} ms sharded vs "
        f"{ref_pre[1] * 1e3:.3f} ms unsharded (first call {pre[0] * 1e3:.3f} vs "
        f"{ref_pre[0] * 1e3:.3f} ms); decode step median {med(walls[1:]) * 1e3:.3f} ms sharded "
        f"vs {med(ref_walls[1:]) * 1e3:.3f} ms unsharded (first step {walls[0] * 1e3:.3f} vs "
        f"{ref_walls[0] * 1e3:.3f} ms; ratio {med(walls[1:]) / med(ref_walls[1:]):.3f}); "
        f"card {card}")
    say(f"sharded serving {arch} launches under the mesh: {n} (predicted {want}: {r_p} rmsnorm "
        f"+ {a_p} flash a prefill, two prefills, {r_d} rmsnorm + {a_d} decode_attention a "
        f"step, every decode launch in the lse mode over the rank's slots: "
        f"{n['decode_attention_lse']})")
    check(torch.equal(toks, ref_toks), f"{arch}: sharded greedy tokens differ from the "
          f"unsharded run's")
    check(diff <= SHARDED_LOGIT_TOL, f"{arch}: sharded logits differ from the unsharded run's "
          f"by {diff:.6g} (> {SHARDED_LOGIT_TOL})")
    check(bool(torch.isfinite(got).all()), f"{arch}: sharded logits are not finite")
    check(n == want, f"{arch}: launches under the mesh {n} != {want}")
    del params, model, ref, got
    torch.cuda.empty_cache()
    say(f"sharded serving {arch}: {time.perf_counter() - t_run:.1f} s")
    return n


# phase 10's sharded training: one AdamW step a family at full width, bf16, remat on,
# weights from seed 0, depth cut so that ~16 bytes a parameter (bf16 weights and
# gradients, f32 moments, the update's temporaries) fit the card with room for the
# largest leaf's temporaries: (arch, config fields replaced, batch, tokens)
SHARDED_TRAIN_RUNS = (
    ("llama2-7b", {"n_layers": 4}, 2, 256),  # ~1.07 B parameters
    ("qwen2-vl-72b", {"n_layers": 1}, 2, 256),  # ~3.36 B: two 1.25 B vocab tables; embeds in
    ("mixtral-8x22b", {"n_layers": 1}, 2, 256),  # ~2.9 B: all 8 experts, top-2, aux losses
    ("zamba2-7b", {"n_layers": 7}, 2, 256),  # a group of 6 Mamba2 layers, the shared block,
    #                                          a remainder layer; one chunk of 256
    ("xlstm-1.3b", {"n_layers": 8}, 2, 256),  # one group: 7 mLSTM blocks and the sLSTM
    ("seamless-m4t-large-v2", {"n_layers": 2, "n_encoder_layers": 2}, 2, 256),
)
# as SHARDED_LOGIT_TOL: the loss, every gradient leaf and every updated parameter of
# the sharded step must be the unsharded step's bit for bit on the one-rank mesh
SHARDED_TRAIN_TOL = 0.0
# a difference that is not 0 is a finding, named leaf by leaf; it must stay within
# this share of the leaf's largest value (bf16's TOLS) or the phase fails
SHARDED_TRAIN_BAR = TOLS["bfloat16"]


def first_batch(torch, model, cfg, B, S):
    """The training stream's first batch (`SyntheticLM`, seed 0) as `model.loss`
    takes it (`model_batch`: one-hot embeds for the frontend-stub archs), on the card."""
    from repro_torch.training import DataConfig, SyntheticLM, model_batch

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B, seed=0))
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch(0).items()}
    return model_batch(model, batch, torch.bfloat16)


def sharded_train_run(torch, card, mesh, arch, cut, B, S, rules="TRAIN_RULES", flags=None):
    """One arch of phase 10's training: from `Model.init(seed=0)`, the first
    batch's loss and gradients (`grads_of`) and one AdamW step
    (`make_train_step`) unsharded; then the same from weights drawn again
    from seed 0 (the step updates them in place) under
    `sharding.use_mesh(mesh, rules)` (the rule set named; `flags`: the
    model's RuntimeFlags fields besides remat), the parameters distributed as
    DTensors that require grad. The unsharded gradients and updated parameters wait
    on the host. The loss, every gradient leaf and every updated parameter
    are held to SHARDED_TRAIN_TOL (a leaf past it is named, and must stay
    within SHARDED_TRAIN_BAR of its largest value); the sharded step's
    rmsnorm and rmsnorm_bwd launches (counts set to 0 just before it) to
    `train_step_launches`. -> (those launches, the sharded run's
    `max_memory_allocated`, which phase 8's (1, 1)-mesh count is held to)."""
    from repro_torch import sharding as sh
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import RuntimeFlags, build_model
    from repro_torch.training import AdamWConfig, adamw_init, make_train_step

    t_run = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), **cut)
    model = build_model(cfg, RuntimeFlags(remat=True, **(flags or {})))
    batch = first_batch(torch, model, cfg, B, S)
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=10)

    def one_step(params):
        """-> (loss, gradients (whole, on the host), updated parameters, step
        wall s, launches, the step's loss)."""
        loss, grads = grads_of(torch, model, params, batch)
        grads = {n: sh.whole(g).cpu() for n, g in grads.items()}
        step, state = make_train_step(model, opt), adamw_init(params)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        torch.cuda.synchronize()
        wall, launched = time.perf_counter() - t0, dict(ops.LAUNCHES)
        del state
        return loss, grads, params, wall, launched, float(metrics["loss"])

    params = model.init(seed=0, device="cuda").requires_grad_(True)
    n_params = sum(p.numel() for p in params.parameters())
    loss_u, host_g, params, wall_u, _, step_loss_u = one_step(params)
    host_p = {n: p.detach().cpu() for n, p in params.named_parameters()}
    del params
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    with sh.use_mesh(mesh, getattr(sh, rules)):
        dparams = model.distribute_params(
            model.init(seed=0, device="cuda").requires_grad_(True))
        loss_s, grads_s, dparams, wall_s, launched, step_loss_s = one_step(dparams)
    peak = torch.cuda.max_memory_allocated()

    def differences(got, want):  # {name: (max |difference|, the leaf's largest |value|)}
        out = {}
        for n, g in got.items():
            w, g = want[n].cuda(), sh.whole(g).cuda()
            out[n] = (float((g.float() - w.float()).abs().max()), float(w.float().abs().max()))
        return out

    d_grad = differences(grads_s, host_g)
    d_param = differences({n: p.detach() for n, p in dparams.named_parameters()}, host_p)
    n_fwd, n_bwd = train_step_launches(cfg)
    want = launch_counts(rmsnorm=n_fwd, rmsnorm_bwd=n_bwd)
    layers = ", ".join(f"{k}={v}" for k, v in cut.items())
    say(f"sharded training {arch} full width ({cfg.family}): {layers}, d={cfg.d_model} "
        f"{n_params / 1e9:.3f} B parameters, {cfg.dtype}, remat, batch {B} x {S}, mesh (1, 1) "
        f"('data', 'model') over NCCL, 1 rank, {rules}{' ' + str(flags) if flags else ''}; "
        f"peak {peak / 2**30:.2f} GiB")
    for what, diffs in (("gradient", d_grad), ("updated parameter", d_param)):
        worst = max(diffs, key=lambda n: diffs[n][0])
        off = {n: d for n, d in diffs.items() if d[0] > SHARDED_TRAIN_TOL}
        say(f"sharded training {arch}: {len(diffs)} {what} leaves, {len(off)} differ from the "
            f"unsharded step's; largest |difference| {diffs[worst][0]:.6g} ({worst}, largest "
            f"value {diffs[worst][1]:.6g})"
            + "".join(f"; {n} {d[0]:.6g} of {d[1]:.6g}" for n, d in list(off.items())[:8]))
        bad = [n for n, (d, m) in off.items() if d > SHARDED_TRAIN_BAR * max(m, 1e-30)]
        check(not bad, f"{arch}: sharded {what}s {bad[:5]} differ by more than "
              f"{SHARDED_TRAIN_BAR} of their largest value")
    say(f"sharded training {arch}: loss {loss_s:.9g} sharded vs {loss_u:.9g} unsharded "
        f"(difference {abs(loss_s - loss_u):.6g}; the steps' {step_loss_s:.9g} vs "
        f"{step_loss_u:.9g}); step walls {wall_s * 1e3:.3f} ms sharded vs {wall_u * 1e3:.3f} ms "
        f"unsharded (ratio {wall_s / wall_u:.3f}); card {card}")
    say(f"sharded training {arch} launches of the step under the mesh: {launched} "
        f"(predicted {want}: train_step_launches)")
    check(abs(loss_s - loss_u) <= SHARDED_TRAIN_BAR * abs(loss_u),
          f"{arch}: sharded loss {loss_s} vs unsharded {loss_u}")
    check(math.isfinite(loss_s) and math.isfinite(step_loss_s), f"{arch}: sharded loss not finite")
    check(launched == want, f"{arch}: sharded train step launches {launched} != {want}")
    del dparams, grads_s, model, batch, host_g, host_p
    torch.cuda.empty_cache()
    say(f"sharded training {arch}: {time.perf_counter() - t_run:.1f} s")
    return launched, peak


# phase 10's context parallelism (TRAIN_RULES_EP_CP with `attn_seq_shard`, as the
# reference pairs them; on the (1, 1) mesh "model" is of size 1, so each core takes
# every query row at offset 0, through the same kernels in the same order): a
# prefill, (arch, layers kept, batch, tokens), and one AdamW step, (arch, config
# fields replaced, batch, tokens): llama4-scout's 40 heads, which divide no 16-way
# "model", are what EP_CP is for; one layer of ~4.1 B parameters (two 1.03 B vocab
# tables, 16 experts) fits 16 bytes a parameter
CP_PREFILL = ("llama2-7b", 8, 2, 512)
CP_TRAIN = ("llama4-scout-17b-a16e", {"n_layers": 1}, 2, 256)
CP_RULES, CP_FLAGS = "TRAIN_RULES_EP_CP", {"attn_seq_shard": True}


def cp_prefill_run(torch, card, mesh):
    """CP_PREFILL's prefill unsharded, then under `sharding.use_mesh(mesh,
    TRAIN_RULES_EP_CP)` with `attn_seq_shard` from the same weights, the
    launch counts set to 0 just before each and read just after: the logits
    must be the unsharded run's (SHARDED_LOGIT_TOL) and so must every
    kernel's launches, one flash call a layer. -> the launches under the
    mesh."""
    from repro_torch import sharding as sh
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import RuntimeFlags, build_model

    t_run = time.perf_counter()
    arch, layers, B, S = CP_PREFILL
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model = build_model(cfg, RuntimeFlags(**CP_FLAGS))
    params = model.init(seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda",
                           dtype=torch.int32)

    def run(mesh=None):
        with torch.no_grad(), (sh.use_mesh(mesh, getattr(sh, CP_RULES)) if mesh
                               else contextlib.nullcontext()):
            p = model.distribute_params(params) if mesh else params
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            logits, _ = model.prefill(p, prompt)
            logits = sh.whole(logits)
            torch.cuda.synchronize()
            return logits.float(), time.perf_counter() - t0, dict(ops.LAUNCHES)

    ref, ref_s, want = run()
    got, got_s, n = run(mesh)
    diff = float((got - ref).abs().max())
    say(f"context-parallel prefill {arch} full width: {layers} of {get_config(arch).n_layers} "
        f"layers, {B} x {S} tokens, mesh (1, 1) ('data', 'model') over NCCL, 1 rank, "
        f"{CP_RULES} {CP_FLAGS}: largest |logit difference| {diff:.6g} over "
        f"{tuple(got.shape)}; prefill {got_s * 1e3:.3f} ms sharded vs {ref_s * 1e3:.3f} ms "
        f"unsharded (first calls); launches {n} (unsharded {want}); card {card}")
    check(diff <= SHARDED_LOGIT_TOL, f"{arch}: context-parallel logits differ from the "
          f"unsharded run's by {diff:.6g} (> {SHARDED_LOGIT_TOL})")
    check(bool(torch.isfinite(got).all()), f"{arch}: context-parallel logits are not finite")
    check(n == want and n["flash_attention"] == layers,
          f"{arch}: context-parallel prefill launches {n} != the unsharded run's {want}")
    del params, model
    torch.cuda.empty_cache()
    say(f"context-parallel prefill {arch}: {time.perf_counter() - t_run:.1f} s")
    return n


def phase_sharded(torch, card):
    """The sharded serving path of every family, SHARDED_RUNS in turn: each
    arch at full width (mixtral-8x22b at 8 of 56 layers), bf16, random
    weights from seed 0, run unsharded, then under `sharding.use_mesh` on a
    (1, 1) ("data", "model") mesh (`launch.mesh.make_smoke_mesh`) over an
    NCCL process group of one rank on a local HashStore (no network): the
    parameters distributed once as DTensors, prefill (twice: cold, then
    warm and kept) of a SHARDED_PROMPT-token prompt (seamless-m4t: ENC_LEN
    encoder frames too) at batch SHARDED_BATCH under PREFILL_RULES, then
    the run's greedy decode steps under DECODE_RULES, every kernel on its
    local shards through `local_map`, the recurrences and moe routing each
    in one `run_local`. First every op of DTENSOR_OPS must have a sharding
    rule in this torch. For each run the launch counts are set to 0 just
    before the sharded run and read just after; each kernel must launch
    what the run predicts (`per_forward`), greedy tokens must equal the
    unsharded run's on the same weights, and so must the logits
    (SHARDED_LOGIT_TOL); the largest difference is printed with the
    sharded and unsharded prefill and decode-step walls (host-bound:
    DTensor's sharding propagation runs on the host at every op). Then the
    sharded training of every family, SHARDED_TRAIN_RUNS in turn
    (`sharded_train_run`): one AdamW step unsharded and one under
    TRAIN_RULES from the same weights, the loss, every gradient leaf and
    every updated parameter held to SHARDED_TRAIN_TOL, the step's rmsnorm
    and rmsnorm_bwd launches to `train_step_launches`. Returns the launch
    counts summed over the runs and each training run's peak by arch."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    t_phase = time.perf_counter()
    missing = dtensor_op_probe(torch)
    say(f"DTensor op coverage (torch {torch.__version__}): {len(DTENSOR_OPS) - len(missing)} "
        f"of the {len(DTENSOR_OPS)} ops of the sharded paths have a sharding rule; missing: "
        f"{missing or 'none'}")
    check(not missing, f"DTensor has no sharding rule for {missing}")
    total, peaks = {}, {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_smoke_mesh("cuda")
        for arch, layers, steps in SHARDED_RUNS:
            for k, v in sharded_run(torch, card, mesh, arch, layers, steps).items():
                total[k] = total.get(k, 0) + v
        t_train = time.perf_counter()
        for arch, cut, B, S in SHARDED_TRAIN_RUNS:
            launched, peaks[arch] = sharded_train_run(torch, card, mesh, arch, cut, B, S)
            for k, v in launched.items():
                total[k] = total.get(k, 0) + v
        t_cp = time.perf_counter()
        arch, cut, B, S = CP_TRAIN
        for n in (cp_prefill_run(torch, card, mesh),
                  sharded_train_run(torch, card, mesh, arch, cut, B, S, CP_RULES, CP_FLAGS)[0]):
            for k, v in n.items():
                total[k] = total.get(k, 0) + v
    finally:
        dist.destroy_process_group()
    now = time.perf_counter()
    say(f"phase 10 (sharded serving {t_train - t_phase:.1f} s, sharded training "
        f"{t_cp - t_train:.1f} s, context parallelism {now - t_cp:.1f} s) took "
        f"{now - t_phase:.1f} s")
    return total, peaks


DRYRUN_MEMORY_TOL = 0.10  # |dry-run peak / max_memory_allocated - 1|, at most
DRYRUN_FLOPS_TOL = 0.02  # |counted flops / train_reckoning's issued - 1|, at most
DRYRUN_HBM_TOL = 0.01  # |H100.hbm_bytes / total_memory - 1|, at most
# phase 8's one-card grid at a quarter of the depth (whole sLSTM groups) where a case's
# analysis takes minutes of host time: every prefill_32k (its 32k-token attention chunk
# loops) and xlstm-1.3b's train_4k (its sLSTM time loop); a layer's work is as at full
# depth, and `launch.dryrun --all` counts every case whole
DRYRUN_GRID_CUT = 4
DRYRUN_GRID_CUT_CASES = ("prefill_32k", ("xlstm-1.3b", "train_4k"))


def grid_cut(arch, shape):
    """The depth phase 8's one-card grid runs `arch` x `shape` at (None: all)."""
    from repro_torch.configs import get_config

    if shape not in DRYRUN_GRID_CUT_CASES and (arch, shape) not in DRYRUN_GRID_CUT_CASES:
        return None
    cfg = get_config(arch)
    group = cfg.slstm_every or 1
    cut = {"n_layers": max(group, cfg.n_layers // DRYRUN_GRID_CUT // group * group)}
    if cfg.n_encoder_layers:
        cut["n_encoder_layers"] = max(1, cfg.n_encoder_layers // DRYRUN_GRID_CUT)
    return cut


DRYRUN_FLOPS_HELD = ("llama2-7b", "seamless-m4t-large-v2")  # no recurrent products
# phase 8's steps on the single production mesh (16 x 16, a fake process group of
# 256 ranks), one arch a family and step kind at full width: (arch, shape, the depth
# where the whole stack would take minutes of host time; None: all). A layer's work
# and collectives are those of full depth; `launch.dryrun --all --mesh both` counts
# every case at full depth in a call of its own
DRYRUN_MESH_CASES = [
    ("glm4-9b", "train_4k", None), ("glm4-9b", "prefill_32k", {"n_layers": 10}),
    ("glm4-9b", "decode_32k", None), ("llama2-7b", "decode_32k", None),
    ("qwen2-vl-72b", "train_4k", {"n_layers": 20}),
    ("qwen2-vl-72b", "prefill_32k", {"n_layers": 10}), ("qwen2-vl-72b", "decode_32k", None),
    ("mixtral-8x22b", "train_4k", None), ("mixtral-8x22b", "prefill_32k", {"n_layers": 8}),
    ("mixtral-8x22b", "decode_32k", None),
    ("zamba2-7b", "train_4k", None), ("zamba2-7b", "prefill_32k", {"n_layers": 39}),
    ("zamba2-7b", "decode_32k", None),
    ("xlstm-1.3b", "train_4k", {"n_layers": 8}), ("xlstm-1.3b", "prefill_32k", {"n_layers": 8}),
    ("xlstm-1.3b", "decode_32k", None),
    ("seamless-m4t-large-v2", "train_4k", None),
    ("seamless-m4t-large-v2", "prefill_32k", {"n_layers": 4, "n_encoder_layers": 4}),
    ("seamless-m4t-large-v2", "decode_32k", None),
]
# phase 8's steps on the multi-pod mesh (2 x 16 x 16, 512 ranks: "batch" joins "pod" and
# "data" where the rules resolve so): every assigned arch's decode_32k, one step a
# family at cut depth, and one long_500k decode
DRYRUN_MULTI_CASES = (
    [(a, "decode_32k", None) for a in ("glm4-9b", "nemotron-4-15b", "qwen1.5-110b",
                                       "mistral-large-123b", "qwen2-vl-72b", "mixtral-8x22b",
                                       "llama4-scout-17b-a16e", "zamba2-7b", "xlstm-1.3b",
                                       "seamless-m4t-large-v2")]
    + [("glm4-9b", "train_4k", {"n_layers": 10}), ("qwen2-vl-72b", "train_4k", {"n_layers": 20}),
       ("mixtral-8x22b", "train_4k", {"n_layers": 14}),
       ("zamba2-7b", "prefill_32k", {"n_layers": 13}), ("xlstm-1.3b", "train_4k", {"n_layers": 8}),
       ("seamless-m4t-large-v2", "train_4k", {"n_layers": 6, "n_encoder_layers": 6}),
       ("glm4-9b", "long_500k", None)])
# the reference's dry-run flags (`--rules` over its nine overrides, `--moe-dispatch`,
# `--attn-seq-shard`), each once on a full-size case on the single mesh: (arch,
# shape, run_case's options)
DRYRUN_MESH_FLAGS = [
    ("glm4-9b", "train_4k", {"rules": "train_sp"}),
    ("glm4-9b", "train_4k", {"rules": "train_attnsp", "rt_kwargs": {"attn_seq_shard": True}}),
    ("glm4-9b", "train_4k", {"rules": "train_cp_sp", "rt_kwargs": {"attn_seq_shard": True}}),
    ("glm4-9b", "train_4k", {"rules": "train_fsdp"}),
    ("mixtral-8x22b", "train_4k", {"rules": "train_ep_cp",
                                   "rt_kwargs": {"attn_seq_shard": True}}),
    ("mixtral-8x22b", "train_4k", {"rules": "train_ep_cp_sp",
                                   "rt_kwargs": {"attn_seq_shard": True}}),
    # context parallelism where the 40 heads divide no 16-way "model"
    ("llama4-scout-17b-a16e", "train_4k", {"rules": "train_ep_cp",
                                           "rt_kwargs": {"attn_seq_shard": True}}),
    ("glm4-9b", "decode_32k", {"rules": "decode_v2"}),
    ("glm4-9b", "decode_32k", {"rules": "decode_v3"}),
    ("mixtral-8x22b", "decode_32k", {"rules": "decode_v3_ep"}),
    ("mixtral-8x22b", "decode_32k", {"rt_kwargs": {"moe_dispatch": "einsum"}}),
    ("mixtral-8x22b", "decode_32k", {"rt_kwargs": {"moe_dispatch": "scatter"}}),
]


# (case, class, bytes a device a step it must stay under): glm4-9b's 2 KV heads cannot
# shard 16 ways, so a decode that took the cache's slots whole gathered every layer's
# slots (11.20 GB a device on 16 x 16, 183.4-183.7 GB under DECODE_RULES_V2/V3; PERF.md)
DRYRUN_DECODE_BOUNDS = [
    ("glm4-9b__decode_32k__single", "all-gather", 0.6e9),
    ("glm4-9b__decode_32k__single__decode_v2", "all-gather", 1e9),
    ("glm4-9b__decode_32k__single__decode_v3", "all-gather", 1e9),
]


def flag_tag(opts):
    """A record's variant tag from its flags, as `--tag` names one."""
    parts = [opts.get("rules") or ""] + [f"{k}_{v}" for k, v in opts.get("rt_kwargs", {}).items()]
    return "_".join(p for p in parts if p)


def check_mesh_records(recs, card):
    """The mesh records of phase 8: every case ok, each with one device's
    peak and its parts, `fits_h100` on the peak, dot FLOPs, the collective
    bytes by the reference's five classes and the three roofline terms
    (the collective one over `H100.link_bw`), and no flag saying something
    was not counted. Every decode_32k step of an arch with attention keeps
    its cache in place (`kernels/ops.py`): the class that moved the cache
    while the decode kernel took its slots whole holds less than that
    movement alone, the device's cache shard where "model" divides the KV
    heads (an all-to-all to a head sharding) and "model" times it where it
    does not (a gather of the slots); and DRYRUN_DECODE_BOUNDS hold."""
    from repro_torch.configs import get_config
    from repro_torch.launch.cost_analysis import COLLECTIVES, PARTS
    from repro_torch.launch.roofline import H100

    bad = [r["case"] for r in recs if r["status"] != "ok"]
    check(not bad, f"dry-run mesh cases not ok: {bad}")
    for r in recs:
        m, c, t = r["memory"], r["cost"], r["roofline"]
        total = sum(c["collective_bytes"].values())
        check(r["chips"] in (1, 256, 512) and set(c["collective_bytes"]) == set(COLLECTIVES)
              and abs(m["peak_gb"] - sum(m[k + "_gb"] for k in PARTS)) <= 1e-9 * m["peak_gb"]
              and m["fits_h100"] == (m["peak_gb"] * 1e9 <= H100.hbm_bytes)
              and c["flops"] > 0 and c["link_bw"] == H100.link_bw
              and abs(t["collective_s"] - total / H100.link_bw) <= 1e-9 * max(t["collective_s"], 1)
              and "peak_counted" not in m and "collective_counted" not in r,
              f"{r['case']}: a mesh record lacks a counted quantity")
    by_case = {r["case"]: r for r in recs}
    for r in recs:
        arch = r["case"].split("__")[0]
        if "decode_32k" not in r["case"] or get_config(arch).family == "ssm":
            continue
        model, cache = r["mesh"]["model"], r["memory"]["cache_gb"] * 1e9
        cls, most = (("all-to-all", cache) if get_config(arch).n_kv_heads % model == 0
                     else ("all-gather", model * cache))
        got = r["cost"]["collective_bytes"][cls]
        say(f"decode keeps its cache in place, {r['case']}: {cls} {got:.6g} B a device a step, "
            f"against the cache's own movement {most:.6g} B (counted, not measured); card {card}")
        check(got < most, f"{r['case']}: {cls} {got:.6g} B a device a step holds the cache "
              f"({most:.6g} B)")
    for case, cls, most in DRYRUN_DECODE_BOUNDS:
        got = by_case[case]["cost"]["collective_bytes"][cls]
        check(got < most, f"{case}: {cls} {got:.6g} B a device a step, not under {most:.6g}")


def phase_dryrun(torch, peaks, sharded_peaks, card):
    """`launch.dryrun` on every assigned arch and llama2-7b x the four
    shapes on one card (a spawned pool, one process a core: nothing
    computed, nothing on the card), one line a case: every case ok but
    seamless-m4t x long_500k, the documented skip. In the same pool the
    mesh counts: DRYRUN_MESH_CASES and DRYRUN_MESH_FLAGS on the single
    production mesh, DRYRUN_MULTI_CASES on the multi-pod one (each device's
    step run as DTensors on meta tensors over a fake process group of 256
    or 512 ranks: its peak and parts, dot FLOPs,
    collective bytes by class, the dominant term; `check_mesh_records`),
    and each of phase 10's six sharded training steps on the card's (1, 1)
    mesh, its counted peak within DRYRUN_MEMORY_TOL of phase 10's measured
    `max_memory_allocated` (`sharded_peaks`). Then the same counting of each
    TRAIN_RUNS config's phase-7 step (4 x 512, bf16, remat, AdamW) held
    against the card: its peak within DRYRUN_MEMORY_TOL of phase 7's
    measured `max_memory_allocated` (`peaks`, bytes by arch), its dot flops
    within DRYRUN_FLOPS_TOL of `train_reckoning`'s issued flops for the
    attention stacks (zamba2 and xlstm printed: the reckoning leaves out
    the recurrences' own products, which the counter sees), and
    `H100.hbm_bytes` within DRYRUN_HBM_TOL of the card's `total_memory`."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import H100
    from repro_torch.launch.specs import SHAPES, ShapeSpec, build_case

    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    say(f"H100.hbm_bytes {H100.hbm_bytes:.0f} against the card's total_memory {total} "
        f"(ratio {H100.hbm_bytes / total:.5f}); card {card}")
    check(abs(H100.hbm_bytes / total - 1) <= DRYRUN_HBM_TOL,
          f"H100.hbm_bytes {H100.hbm_bytes} is not the card's {total} (within {DRYRUN_HBM_TOL})")
    train = ShapeSpec(f"train_{TRAIN_BATCH}x{TRAIN_SEQ}", "train", TRAIN_SEQ, TRAIN_BATCH)
    grid = [(a, s, grid_cut(a, s)) for a in dryrun.ASSIGNED + ["llama2-7b"] for s in SHAPES]
    held = [(arch, train, cut) for arch, cut, _, _ in TRAIN_RUNS]
    meshed = ([(a, s, cut, "single") for a, s, cut in DRYRUN_MESH_CASES]
              + [(a, s, cut, "multi") for a, s, cut in DRYRUN_MULTI_CASES]
              + [(a, s, None, "single", dict(opts, tag=flag_tag(opts)))
                 for a, s, opts in DRYRUN_MESH_FLAGS])
    one = [(arch, ShapeSpec(f"train_{B}x{S}", "train", S, B), cut, "card")
           for arch, cut, B, S in SHARDED_TRAIN_RUNS]
    recs = dryrun.run_cases(grid + held + meshed + one, str(ROOT / dryrun.OUT))
    n = len(grid) + len(held)
    recs, mrecs, orecs = recs[:n], recs[n:n + len(meshed)], recs[n + len(meshed):]
    for r in recs + mrecs + orecs:
        say(f"dryrun {dryrun.case_line(r)}")
    check_mesh_records(mrecs + orecs, card)
    status = {st: [r["case"] for r in recs[:len(grid)] if r["status"] == st]
              for st in ("ok", "skipped", "error")}
    check(not status["error"] and all(r["status"] == "ok" for r in recs[len(grid):]),
          f"dry-run cases failed: {[r['case'] for r in recs if r['status'] == 'error']}")
    check(status["skipped"] == ["seamless-m4t-large-v2__long_500k__h100"],
          f"skipped: {status['skipped']} (only seamless-m4t x long_500k may be)")
    fits = [r["case"] for (_, _, cut), r in zip(grid, recs) if r["status"] == "ok"
            and cut is None and r["memory"]["fits_h100"]]
    say(f"dry run: {len(status['ok'])} ok, {len(status['skipped'])} skipped, 0 errors "
        f"({sum(cut is not None for _, _, cut in grid)} at 1/{DRYRUN_GRID_CUT} depth, "
        f"`grid_cut`); {len(fits)} whole cases fit one card: {fits}; on the production meshes: {len(mrecs)} steps ok "
        f"({len(DRYRUN_MULTI_CASES)} of them on 2x16x16), "
        f"{sum(r['memory']['fits_h100'] for r in mrecs)} fit one card a device")
    for (arch, cut, B, S), r in zip(SHARDED_TRAIN_RUNS, orecs):
        peak = r["memory"]["peak_gb"] * 1e9
        ratio = peak / sharded_peaks[arch]
        say(f"dry run on the (1, 1) mesh against phase 10, {arch} {cut} at {B} x {S} under "
            f"TRAIN_RULES: counted peak {peak / 2**30:.2f} GiB against max_memory_allocated "
            f"{sharded_peaks[arch] / 2**30:.2f} GiB (ratio {ratio:.4f}; parts GiB "
            + ", ".join(f"{k} {r['memory'][k + '_gb'] * 1e9 / 2**30:.2f}"
                        for k in ("params", "grads", "moments", "inputs", "other"))
            + f"); card {card}")
        check(abs(ratio - 1) <= DRYRUN_MEMORY_TOL, f"{arch}: (1, 1)-mesh peak {peak:.0f} B is "
              f"not phase 10's {sharded_peaks[arch]} B (within {DRYRUN_MEMORY_TOL})")
    for (arch, _, cut), r in zip(held, recs[len(grid):]):
        peak = r["memory"]["peak_gb"] * 1e9
        ratio = peak / peaks[arch]
        case = build_case(arch, train, cfg_kwargs=cut)
        issued = train_reckoning(case.cfg, case.args[0], TRAIN_BATCH, TRAIN_SEQ)["issued_flops"]
        f_ratio = r["cost"]["flops"] / issued
        say(f"dry run against phase 7, {arch} {cut or 'all layers'} at {TRAIN_BATCH} x "
            f"{TRAIN_SEQ}: peak {peak / 2**30:.2f} GiB against max_memory_allocated "
            f"{peaks[arch] / 2**30:.2f} GiB (ratio {ratio:.4f}; parts GiB "
            + ", ".join(f"{k} {r['memory'][k + '_gb'] * 1e9 / 2**30:.2f}"
                        for k in ("params", "grads", "moments", "inputs", "other"))
            + f"); dot flops {r['cost']['flops']:.6g} against train_reckoning's issued "
            f"{issued:.6g} (ratio {f_ratio:.5f}"
            + ("" if arch in DRYRUN_FLOPS_HELD else ", printed: the counter also sees the "
               "recurrences' own products") + f"); card {card}")
        check(abs(ratio - 1) <= DRYRUN_MEMORY_TOL, f"{arch}: dry-run peak {peak:.0f} B is not "
              f"phase 7's {peaks[arch]} B (within {DRYRUN_MEMORY_TOL})")
        check(arch not in DRYRUN_FLOPS_HELD or abs(f_ratio - 1) <= DRYRUN_FLOPS_TOL,
              f"{arch}: dry-run flops {r['cost']['flops']} are not train_reckoning's {issued} "
              f"(within {DRYRUN_FLOPS_TOL})")
    say(f"phase 8 (dry run, {len(recs)} cases on one card, {len(mrecs) - len(DRYRUN_MULTI_CASES)}"
        f" steps on 16x16, {len(DRYRUN_MULTI_CASES)} on 2x16x16 and "
        f"{len(orecs)} on the (1, 1) mesh in a pool of {len(os.sched_getaffinity(0))}) "
        f"took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 9: the experiments layer (host only) regenerates the reference's
# tracked studies
# ---------------------------------------------------------------------------

BENCH_TOL = 1e-12  # |port - BENCH_*.json| of each number of a regenerated document
# a BENCH document's timing keys: the headline's wall clocks (the result's are
# zeroed by `ExperimentResult.to_canonical_dict`); nothing else is left out
BENCH_TIMING = ("wall_clock_s", "sweep_wall_clock_s")
# `run_suite`'s shards an experiment (it clamps them to the points): one a
# point, so the pool hands out work as workers free up and a study's tail is
# one point, where a shard a worker leaves the pool idle behind its slowest
SUITE_SHARDS = 10_000
NET_LOAD = 148.0  # jobs/s: slack_aware's capacity on three_cell_hetero (BENCH_network.json)
NET_SIM = dict(sim_time=6.0, warmup=1.0, seed=0)  # BENCH_network.json's sweep
# (e)'s faults: the MEC's backhaul down for a second and cell0's RAN node
# crashed for a second, both inside the scored span
NET_LINK_OUTAGE = (2.0, 3.0)
NET_NODE_OUTAGE = ("ran:cell0", 3.5, 4.5)
ITER_CTX = 22  # mean context of a 15/15 job's decode steps: 15 prompt tokens + 7
RAG_JOB = (2048, 32)  # rag_doc_qa's (n_input, n_output): BENCH_batching.json's scenario


def suite_run(tmp, workers):
    """In a spawned child (no CUDA context for its forked pool to inherit):
    `run_suite("bench_all")` cold into `tmp`/cold and again from the same
    cache into `tmp`/warm, each with a runlog. Returns what the parent
    checks: each run's summary rows, cache totals, seconds and runlog
    events, this process's pid and the mobility arms' handovers."""
    import multiprocessing

    from repro_torch.experiments import run_suite
    from repro_torch.experiments.runlog import read_runlog

    # a spawned process starts its own pools by spawn too (the method rides
    # in spawn's start-up data), and each spawned worker imports torch again:
    # seconds for every study's pool. This process has no CUDA context, so
    # its pools fork, as under `python -m repro_torch.experiments suite run`
    multiprocessing.set_start_method("fork", force=True)
    out = {"pid": os.getpid()}
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        summary = run_suite("bench_all", cache=os.path.join(tmp, "cache"),
                            shards=SUITE_SHARDS, root=os.path.join(tmp, run), workers=workers,
                            runlog=os.path.join(tmp, f"{run}.jsonl"))
        out[run] = {"seconds": time.perf_counter() - t0, "entries": summary["entries"],
                    "cache": summary["cache"],
                    "events": read_runlog(os.path.join(tmp, f"{run}.jsonl"))}
        if run == "cold":
            control = summary["results"]["control_capacity"]
            out["handovers"] = {a.name: [s.extras["n_handovers"] for p in a.points
                                         for s in p.seeds]
                                for a in control.arms if a.name.startswith("mobility/")}
    return out


def cases_run():
    """(e)'s network runs, one after another, by name (a spawned child's
    work while the suite's pool runs)."""
    return {name: fn(*args) for name, (fn, args) in network_cases()}


def doc_diff(got, want, path=""):
    """(largest |got - want| over the numbers, [paths where anything else
    differs]) of two JSON trees."""
    if isinstance(want, dict) and isinstance(got, dict):
        worst, bad = 0.0, [f"{path}/{k}" for k in sorted(set(got) ^ set(want))]
        for k in sorted(set(got) & set(want)):
            w, b = doc_diff(got[k], want[k], f"{path}/{k}")
            worst, bad = max(worst, w), bad + b
        return worst, bad
    if isinstance(want, list) and isinstance(got, list) and len(got) == len(want):
        worst, bad = 0.0, []
        for i, (g, w) in enumerate(zip(got, want)):
            w_, b = doc_diff(g, w, f"{path}[{i}]")
            worst, bad = max(worst, w_), bad + b
        return worst, bad
    num = (int, float)
    if (isinstance(got, num) and isinstance(want, num) and not isinstance(got, bool)
            and not isinstance(want, bool)):
        if math.isnan(got) and math.isnan(want):
            return 0.0, []
        return abs(got - want), []
    return 0.0, ([] if got == want else [path])


def bench_physics(doc):
    """A BENCH document less its timing keys: the headline without
    BENCH_TIMING, the result in `to_canonical_dict` form."""
    from repro_torch.experiments import ExperimentResult

    return dict(doc, headline={k: v for k, v in doc["headline"].items()
                               if k not in BENCH_TIMING},
                result=ExperimentResult.from_dict(doc["result"]).to_canonical_dict(
                    points="none"))


def report_deltas(md):
    """The cells of the md report's "Delta vs reference" tables: the
    capacity deltas and the per-rate satisfaction deltas."""
    sec = md.split("## Delta vs reference", 1)[1].split("\n## ", 1)[0]
    cap_part, _, sat_part = sec.partition("### Satisfaction delta per rate")
    rows = lambda part: [[c.strip() for c in ln.strip("|").split("|")]
                         for ln in part.splitlines()
                         if ln.startswith("| ") and "---" not in ln][1:]
    return [r[-1] for r in rows(cap_part)], [c for r in rows(sat_part) for c in r[1:]]


def phase_network(card, cal, card_mem, workers=None, meanwhile=None):
    """The port's experiments layer (host code, numpy) at the tracked
    studies' own sizes. In one spawned child: (a) `run_suite("bench_all")`
    with a fresh cache into a temporary root, in a pool of `workers`
    processes (default: one a core this process may run on), whose runlog
    must show every shard run in a pool worker, never in the child itself;
    each of the four documents held to the tracked BENCH_*.json in every
    key but the timing ones within BENCH_TOL; (b) the suite again from the
    cache: all hits, the same bytes. In a second spawned child meanwhile,
    the network cases of (e). Here:
    (c) `validate_bench` on the regenerated files, (d) `generate_report`
    of each against the tracked file, every delta 0, (e) faults and
    controllers on the network at NET_LOAD, (f) the network's analytic H100
    tier against phase 5's llama2-7b on the card (`cal`: its 15/15
    calibration; `card_mem`: its decode-step walls and the card's free
    memory once its weights were on it), printed. `meanwhile()` runs in
    this process while the child works."""
    import concurrent.futures
    import multiprocessing
    import tempfile

    from repro_torch.experiments import get_experiment, get_suite, validate_bench
    from repro_torch.telemetry.report import generate_report

    t0 = time.perf_counter()
    workers = workers or len(os.sched_getaffinity(0))
    suite = get_suite("bench_all")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_suite_") as tmp:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(2, mp_context=ctx) as child:
            fut, fut_net = child.submit(suite_run, tmp, workers), child.submit(cases_run)
            if meanwhile is not None:
                meanwhile()
            out, net = fut.result(), fut_net.result()
        cold, warm = out["cold"], out["warm"]
        # (a) the pool's workers ran every shard: a pool that could not start
        # falls back to a serial run in the child itself, which fails here
        ends = [e for e in cold["events"] if e["event"] == "task_end"]
        pids = {e["pid"] for e in ends}
        n_shards = sum(e.get("n_shards") or 0 for e in cold["events"]
                       if e["event"] == "run_start")
        check(len(ends) == n_shards and n_shards > 0 and out["pid"] not in pids
              and len(pids) >= min(2, workers),
              f"bench_all's pool: {len(ends)} of {n_shards} shards ended in worker processes "
              f"{sorted(pids)} (the suite's own process {out['pid']}); it went serial")
        starts = {e["experiment"]: e["ts"] for e in cold["events"] if e["event"] == "run_start"}
        stops = {e["experiment"]: e["ts"] for e in cold["events"] if e["event"] == "run_end"}
        n_points = 0
        for entry, row, wrow in zip(suite.entries, cold["entries"], warm["entries"]):
            name = entry.experiment
            got = json.loads(Path(tmp, "cold", entry.bench_path).read_text())
            want = json.loads((ROOT / entry.bench_path).read_text())
            err, bad = doc_diff(bench_physics(got), bench_physics(want))
            n_points += row["n_points"]
            arms = get_experiment(name).resolve_arms()
            say(f"{entry.bench_path} ({name}) through run_suite: {len(arms)} arms, "
                f"{row['n_points']} points in a pool of {workers}, "
                f"{stops[name] - starts[name]:.1f} s ({row['task_seconds']:.1f} task-s); "
                f"cache {row['cache']}; largest |port - file| {err:.3g}, other keys that "
                f"differ {bad}; capacities {[a['curve']['capacity'] for a in got['result']['arms']]}")
            check(err <= BENCH_TOL and not bad,
                  f"{entry.bench_path}: the port's document misses the tracked file by {err:.3g} "
                  f"(held within {BENCH_TOL}); keys that differ {bad}")
            check(row["cache"]["misses"] == row["n_points"] and row["cache"]["hits"] == 0,
                  f"{name}: the cold run read {row['cache']} from a fresh cache")
            # (b) warm: every point a hit and the same bytes
            check(wrow["cache"]["hits"] == row["n_points"] and wrow["cache"]["misses"] == 0
                  and wrow["cache"]["stale"] == 0,
                  f"{name}: the warm run read {wrow['cache']}, not {row['n_points']} hits")
            check(Path(tmp, "warm", entry.bench_path).read_bytes()
                  == Path(tmp, "cold", entry.bench_path).read_bytes(),
                  f"{entry.bench_path}: the warm run wrote other bytes than the cold run")
        handovers = [n for ns in out["handovers"].values() for n in ns]
        check(handovers and min(handovers) >= 1, f"a mobility run handed no UE over: "
              f"{out['handovers']}")
        say(f"bench_all cold: {n_points} points, {len(ends)} shards in {len(pids)} pool worker "
            f"processes, {cold['seconds']:.1f} s; warm: every point a hit "
            f"({warm['cache']}), {warm['seconds']:.1f} s, the same bytes; mobility handovers "
            f"{out['handovers']}; every number equal to the reference's tracked BENCH_*.json "
            f"(simulation results of the reference, no chip involved) within {BENCH_TOL}; "
            f"card {card}")
        # (c) the regenerated files parse against the result schema
        problems = validate_bench(root=os.path.join(tmp, "cold"))
        check(not problems, f"validate_bench on the regenerated files: {problems}")
        # (d) a report of each against the tracked file
        for entry in suite.entries:
            md = generate_report(os.path.join(tmp, "cold", entry.bench_path),
                                 ref_path=str(ROOT / entry.bench_path))
            caps, sats = report_deltas(md)
            check(caps and all(c == "+0.00" for c in caps)
                  and all(c in ("+0.000", "-") for c in sats),
                  f"{entry.bench_path}: report deltas {caps} {sorted(set(sats))}")
            say(f"report {entry.bench_path} against the tracked file: {len(md)} characters of "
                f"md, {len(caps)} capacity deltas all +0.00, {len(sats)} satisfaction deltas "
                f"{sorted(set(sats))}")
        say("validate_bench on the regenerated files: no problem")
    network_faults(net, card)
    analytic_against_card(cal, card_mem, json.loads((ROOT / "BENCH_batching.json").read_text()),
                          card)
    say(f"phase 9 (experiments layer, bench_all {n_points} points twice in a spawned child "
        f"with a pool of {workers}, {len(net)} network cases in another"
        f"{', phase 6 meanwhile' if meanwhile else ''}) took {time.perf_counter() - t0:.1f} s; "
        f"card {card}")


def network_cases():
    """(e)'s runs at NET_LOAD on three_cell_hetero with ar_translation: the
    plain run (fast and slow engines), an empty FaultSpec, the link and
    node outages, and each controller preset (static under slack_aware, as
    the plain run; each preset again under the `controlled` policy, whose
    routing reads the controller's retargets)."""
    from repro_torch.core.capacity import network_point
    from repro_torch.faults import FaultSpec, LinkOutage, NodeOutage
    from repro_torch.network import SCENARIOS, three_cell_hetero

    faults = FaultSpec(link_outages=(LinkOutage(*NET_LINK_OUTAGE, node="mec"),),
                       node_outages=(NodeOutage(*NET_NODE_OUTAGE),))
    runs = {"plain": ("slack_aware", True, {}), "plain, fast=False": ("slack_aware", False, {}),
            "FaultSpec()": ("slack_aware", True, {"faults": FaultSpec()}),
            "link + node outage": ("slack_aware", True, {"faults": faults}),
            "static": ("slack_aware", True, {"controller": "static"})}
    for preset in ("static", "reactive", "slack_aware_joint"):
        runs[f"controlled + {preset}"] = ("controlled", True, {"controller": preset})
    return [(name, (network_point, (three_cell_hetero(), SCENARIOS["ar_translation"], pol,
                                    NET_SIM["sim_time"], NET_SIM["warmup"], NET_SIM["seed"],
                                    fast, NET_LOAD, 0, extra)))
            for name, (pol, fast, extra) in runs.items()]


def net_fields(r, skip=()):
    """A NetResult's fields but the host wall-clock profiles and `skip`, as
    a repr."""
    d = {k: v for k, v in dataclasses.asdict(r).items() if k not in skip}
    d["total"].pop("profile")
    for c in d["per_cell"].values():
        c.pop("profile")
    return repr(d)


def network_faults(res, card):
    for name in ("plain, fast=False", "FaultSpec()", "static"):
        skip = ("controller", "n_epochs") if name == "static" else ()  # the preset's name and
        # its epochs: what a control loop that never acts still reports
        check(net_fields(res[name], skip) == net_fields(res["plain"], skip),
              f"network {name}: a field differs from the plain run's")
    check(res["static"].n_epochs > 0 and res["static"].n_rejected == 0,
          "the static preset ran no epoch or rejected a job")
    hit = res["link + node outage"]
    check(hit.n_redispatched + hit.n_fault_drops >= 1,
          "the link and node outages neither dropped nor redispatched a job")
    for name, r in res.items():
        share = {k: round(v, 4) for k, v in sorted(r.route_share.items())}
        say(f"network ({name}) at {NET_LOAD:g} jobs/s, ar_translation, seed {NET_SIM['seed']}: "
            f"satisfaction {r.satisfaction:.6f}, jobs {r.n_jobs}, route_share {share}, "
            f"controller {r.controller}, epochs {r.n_epochs}, rejected {r.n_rejected}, "
            f"node failures {r.n_node_failures}, redispatched {r.n_redispatched}, fault drops "
            f"{r.n_fault_drops}, drops by reason {r.total.drop_reasons}")
    say(f"network faults/controllers: fast=False, FaultSpec() and the static preset equal the "
        f"plain run field for field (the preset's name and epochs aside); link outage "
        f"{NET_LINK_OUTAGE} s at the MEC, node outage {NET_NODE_OUTAGE}; card {card}")


def analytic_against_card(cal, card_mem, batching, card):
    """The network's analytic H100 tier (a batched fleet node's extended
    LatencyModel) against phase 5's llama2-7b in bf16 on the card: decode
    steps at batch 1 and 8, the 15-token prefill, and the KV budget a
    rag_doc_qa job meets, printed; the checks are finite positive numbers
    and the tier's job capacity equal to BENCH_batching.json's."""
    from repro_torch.batching import KVCache
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import Job
    from repro_torch.launch.roofline import H100 as ROOF_H100
    from repro_torch.network import build_fleet_node

    lm = build_fleet_node("ran:h100", "ran", "h100", node_kind="batched").lm
    pairs = [("decode step, batch 1", lm.iteration_latency(0, 1, ITER_CTX),
              cal["decode_s"] / 14),
             ("decode step, batch 8", lm.iteration_latency(0, 8, 8 * ITER_CTX),
              card_mem["step_s"]["ICC batch"]),
             ("prefill, 15 tokens", lm.iteration_latency(15, 0, 0), cal["prefill_s"])]
    for what, model_s, card_s in pairs:
        check(all(math.isfinite(x) and x > 0 for x in (model_s, card_s)),
              f"{what}: analytic {model_s} or card {card_s} is not finite and positive")
        say(f"analytic H100 tier vs card, llama2-7b {what}: model {model_s * 1e3:.4f} ms, card "
            f"{card_s * 1e3:.4f} ms, card / model {card_s / model_s:.3f}; card {card}")
    kv = KVCache(lm.hw, lm.model)
    job = Job(0, 0, 0.0, *RAG_JOB, 4.0)
    cap = kv.jobs_capacity(job)
    want = batching["headline"]["cache_job_cap"]["h100"]
    check(cap == want, f"the H100 tier holds {cap} rag_doc_qa jobs, BENCH_batching.json {want}")
    cfg = get_config("llama2-7b")
    kv_token = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2  # bf16 k and v
    free, total = card_mem["free_bytes"], card_mem["total_bytes"]
    job_bytes = sum(RAG_JOB) * kv_token
    check(free > 0 and kv_token == lm.model.kv_bytes_per_token,
          f"free {free} B, KV {kv_token} B a token (model {lm.model.kv_bytes_per_token})")
    say(f"KV budget: the H100 tier's KVCache {kv.capacity_bytes / 1e9:.3f} GB (hbm_bytes "
        f"{lm.hw.hbm_bytes / 1e9:.1f} GB - weights {lm.model.model_bytes / 1e9:.1f} GB) holds "
        f"{cap} rag_doc_qa jobs of {kv.job_bytes(job) / 1e9:.4f} GB; the card, llama2-7b bf16 "
        f"weights on it ({card_mem['weights_bytes'] / 1e9:.3f} GB allocated), has "
        f"{free / 1e9:.3f} GB free of {total / 1e9:.3f} GB (launch.roofline.H100.hbm_bytes "
        f"{ROOF_H100.hbm_bytes / 1e9:.3f} GB): {free // job_bytes} such jobs at "
        f"{kv_token} B of KV a token; card {card}")


def profile_decode(torch, model, params, cfg, M, Sc, steps=5):
    """Where a decode step's time goes, for the ICC batch (M slots, 15-token
    prompts) and for one sequence over a nearly full cache (a 552-token
    prompt in Sc slots, so the steps attend over ~553-558 valid slots); an
    enc-dec prompt adds ENC_LEN encoder frames: wall per step without the
    profiler, then device busy time per step by kernel group under it (for
    moe, its routing apart from the expert GEMMs; for hybrid and ssm, the
    recurrent blocks' elementwise work apart from their GEMMs and rmsnorm).
    Returns the unprofiled wall (s) a step by label."""
    from repro_torch.serving import GenRequest, InferenceEngine

    prompt = prompt_maker(torch, cfg, torch.Generator().manual_seed(7))
    shown = {ROUTING: bool(cfg.n_experts), RECURRENT: cfg.family in ("hybrid", "ssm"),
             "rmsnorm_bwd": False}
    walls = {}
    for batch, plen, label in ((M, 15, "ICC batch"), (1, 552, "one long sequence")):
        eng = InferenceEngine(model, params, max_batch=batch, max_seq=Sc, device="cuda",
                              enc_len=ENC_LEN if cfg.n_encoder_layers else 0)
        for uid in range(batch):
            eng.submit(GenRequest(uid=uid, prompt=prompt(plen), max_new_tokens=2 * steps + 3))
        eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        wall = (time.perf_counter() - t0) / steps * 1e3
        walls[label] = wall / 1e3
        groups, launches, _ = _device_time(torch, lambda: [eng.step() for _ in range(steps)])
        for rng, want in shown.items():
            check(not want or groups[rng] > 0, f"{cfg.name}: the profile holds no {rng} kernels")
        busy = sum(groups.values()) / steps / 1e3
        enc = f" + {ENC_LEN} encoder frames" if cfg.n_encoder_layers else ""
        say(f"{cfg.name} decode step profile ({label}: batch {batch}, {plen}-token prompts{enc}, "
            f"Sc {Sc}, {steps} steps): wall {wall:.3f} ms/step unprofiled; device busy {busy:.3f} "
            f"ms/step ({100 * busy / wall:.1f}% of wall), "
            + ", ".join(f"{k} {v / steps / 1e3:.3f} ms" for k, v in groups.items()
                        if shown.get(k, True))
            + f"; {launches / steps:.0f} kernel launches/step")
    return walls


ROUTING = "moe routing"  # the profiler range around moe's _route, _dispatch and _combine
RECURRENT = "recurrent"  # the range around the Mamba2, mLSTM and sLSTM decode steps
# range: (module path, functions wrapped, whether every kernel inside moves to the
# range's group or only those that fall in "other")
RANGES = {
    ROUTING: ("repro_torch.models.moe", ("_route", "_dispatch", "_combine"), True),
    RECURRENT: ("repro_torch.models.transformer",
                ("mamba2_decode_step", "mlstm_decode_step", "slstm_decode_step"), False),
}


@contextlib.contextmanager
def profiler_ranges(torch):
    """While inside, each function of RANGES runs in a profiler range of its
    name: moe's routing (router product, softmax, top-k, one-hot, cumsum:
    `_route`; scatter: `_dispatch`; gather and weighted sum: `_combine`) and
    the recurrent blocks' decode steps (as the stack calls them)."""
    import importlib

    saved = []
    for rng, (path, names, _) in RANGES.items():
        mod = importlib.import_module(path)
        for name in names:
            fn = getattr(mod, name)
            saved.append((mod, name, fn))

            def call(*args, _fn=fn, _rng=rng, **kwargs):
                with torch.profiler.record_function(_rng):
                    return _fn(*args, **kwargs)

            setattr(mod, name, call)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _kernel_group(name: str) -> str:
    name = name.lower()
    if "decode_attention" in name:
        return "decode_attention"
    if "rmsnorm_bwd" in name:
        return "rmsnorm_bwd"
    if "rmsnorm" in name:
        return "rmsnorm"
    if any(t in name for t in ("gemm", "nvjet", "cutlass", "sm90_xmma", "gemv")):
        return "gemm"
    return "other"


def _range_kernels(e):
    """The device kernels launched by a CPU event and its children."""
    yield from e.kernels
    for child in e.cpu_children:
        yield from _range_kernels(child)


def _device_time(torch, fn, ranges=True):
    """Device time (us) by kernel group, the kernel count of fn() and the
    device time (us) by kernel name, from torch.profiler; with `ranges`, the
    kernels launched inside a range of RANGES form its group, taken out of
    the groups their names fall in (for RECURRENT only those of "other": its
    GEMMs and rmsnorm stay where they are). Without, only device activity
    is recorded and no event tree is walked (an xlstm training step
    launches ~10^5 kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * ranges + [ProfilerActivity.CUDA]
    with (profiler_ranges(torch) if ranges else contextlib.nullcontext()), \
            profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    groups = {"gemm": 0.0, "decode_attention": 0.0, "rmsnorm": 0.0, "rmsnorm_bwd": 0.0,
              ROUTING: 0.0, RECURRENT: 0.0, "other": 0.0}
    launches, by_name = 0, {}
    for e in prof.key_averages():
        # a range's own span on the device timeline is not a kernel
        if e.device_type != DeviceType.CUDA or e.key in RANGES:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        launches += e.count
        groups[_kernel_group(e.key)] += us
        by_name[e.key] = by_name.get(e.key, 0.0) + us
    for e in prof.events() if ranges else ():
        if e.name in RANGES and e.device_type == DeviceType.CPU:
            move_all = RANGES[e.name][2]
            for k in _range_kernels(e):
                g = _kernel_group(k.name)
                if move_all or g == "other":
                    groups[g] -= k.duration
                    groups[e.name] += k.duration
    return groups, launches, by_name


def rmsnorm_sweep(torch, timer):
    """rmsnorm's time by CTA shape, bf16 with a bf16 gamma: for each (n, d),
    the wrapper as it stands (its own plan), every plan of 32-512 threads per
    row and 1-8 rows per CTA that covers d and fits the kernel's launch
    bounds, `F.rms_norm`, and `copy_` of x (the same bytes less gamma's).
    Each plan is checked against the plain version before it is timed. Where
    the package has no `rmsnorm_plan` (an older tree, given with --src), only
    the wrapper and the yardsticks are timed."""
    import importlib

    import torch.nn.functional as F

    from repro_torch.kernels import ref

    mod = importlib.import_module("repro_torch.kernels.rmsnorm")  # the module, not the function
    gen = torch.Generator(device="cuda").manual_seed(0)
    plan_fn = getattr(mod, "rmsnorm_plan", None)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"timer floor: {timer(lambda: torch.cuda._sleep(0)):.4f} ms")
    grid = [(4096, n) for n in (1, 8, 15, 64, 132, 264, 396, 528, 529, 660, 1056, 2048, 8192)]
    grid += [(d, n) for d in (5120, 8192) for n in (8, 512, 8192)]
    for d, n in grid:
        x = torch.randn((n, d), generator=gen, device="cuda").bfloat16()
        g = (1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).bfloat16()
        b_ms, _ = bound(2 * (2 * n * d) + 2 * d, 4.0 * n * d, "bfloat16")
        ms = timer(lambda: mod.rmsnorm(x, g))
        lib = timer(lambda: F.rms_norm(x, (d,), g, 1e-5))
        y = torch.empty_like(x)
        copy = timer(lambda: y.copy_(x))  # the same bytes less gamma: the rate one can reach
        line = f"sweep rmsnorm ({n}, {d}) bf16: wrapper {ms:.4f} ms"
        if plan_fn is not None:
            line += f" at plan {plan_fn(n, d, 2, n_sm)}"
        line += (f", F.rms_norm {lib:.4f} ms, copy_ {copy:.4f} ms, bound {b_ms:.5f} ms; "
                 "plans")
        if plan_fn is not None:
            want = ref.rmsnorm(x, g)
            nvec = d // 8
            for tpr in (32, 64, 128, 256, 512):
                vpt = next((v for v in mod.VPTS if tpr * v >= nvec), None)
                for rows in (1, 2, 4, 8):
                    if vpt is None or tpr > nvec or rows * tpr > mod.max_threads(vpt):
                        continue
                    out = torch.empty_like(x)
                    plan = (rows, tpr, vpt)
                    mod.launch(x, g, out, 1e-5, plan, True)
                    assert_close(torch, out, want, "bfloat16", f"rmsnorm plan {plan} ({n}, {d})")
                    t = timer(lambda: mod.launch(x, g, out, 1e-5, plan, True))
                    line += f" {rows}/{tpr}/{vpt}={t:.4f}"
        say(line)


def rmsnorm_bwd_sweep(torch, timer):
    """rmsnorm's backward by plan at RMSNORM_BWD_TIMED: the wrapper as it
    stands (its own plan), `F.rms_norm`'s forward and backward less its
    forward, the bytes bound, and every plan that caps of 128-1024 threads
    and 1-8 ring stages give (threads/vectors per thread/stages/CTAs=ms),
    each checked against the plain version before it is timed; first, each
    backward kernel's F2F.F64 conversions per element from the SASS. Where
    the package has no `rmsnorm_bwd_plan` (an older tree, given with --src),
    only the wrapper and the yardstick are timed."""
    import importlib

    import torch.nn.functional as F

    from repro_torch.kernels import _build, ref

    mod = importlib.import_module("repro_torch.kernels.rmsnorm")  # the module, not the function
    plan_fn = getattr(mod, "rmsnorm_bwd_plan", None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"timer floor: {timer(lambda: torch.cuda._sleep(0)):.4f} ms")
    for label, c in sorted(sass_counts(_build.library_path()).items()):
        if label.startswith("rmsnorm_bwd_"):
            say(f"sass {label}: F2F.F64 {c['F2F.F64']} ({bwd_elems(label)} elements a pass "
                f"body), UBLKCP {c['UBLKCP']}")
    for n, d, dtype in RMSNORM_BWD_TIMED:
        t = getattr(torch, dtype)
        x = torch.randn((n, d), generator=gen, device="cuda").to(t)
        dy = torch.randn((n, d), generator=gen, device="cuda").to(t)
        g = (1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).to(t)
        itemsize = x.element_size()
        b_ms, _ = bound(3 * n * d * itemsize + 2 * d * itemsize, 12.0 * n * d, "float32")
        ms = timer(lambda: mod.rmsnorm_bwd(x, g, dy))
        lo, hi = timer.spread
        xr, gr = x.clone().requires_grad_(), g.clone().requires_grad_()
        lib = (timer(lambda: torch.autograd.grad(F.rms_norm(xr, (d,), gr, 1e-5), (xr, gr), dy))
               - timer(lambda: F.rms_norm(x, (d,), g, 1e-5)))
        line = (f"sweep rmsnorm_bwd ({n}, {d}) {dtype}: wrapper {ms:.4f} ms (min {lo:.4f}, "
                f"max {hi:.4f})")
        if plan_fn is not None:
            line += f" at plan {plan_fn(n, d, itemsize, n_sm, gamma_itemsize=itemsize)}"
        line += f", F.rms_norm backward {lib:.4f} ms, bound {b_ms:.5f} ms; plans"
        if plan_fn is not None:
            want = ref.rmsnorm_bwd(x, g, dy)
            seen = set()
            for cap in (128, 256, 512, 1024):
                for stages in (1, 2, 3, 4, 5, 6, 8):
                    plan = plan_fn(n, d, itemsize, n_sm, gamma_itemsize=itemsize,
                                   max_threads=cap, max_stages=stages)
                    if plan in seen:
                        continue
                    seen.add(plan)
                    dx, dgamma = torch.empty_like(x), torch.empty_like(g)
                    mod.launch_bwd(x, g, dy, dx, dgamma, 1e-5, plan, True)
                    for got, ok, part in zip((dx, dgamma), want, ("dx", "dgamma")):
                        assert_close(torch, got, ok, dtype, f"rmsnorm_bwd plan {plan} {part}")
                    t_ms = timer(lambda: mod.launch_bwd(x, g, dy, dx, dgamma, 1e-5, plan, True))
                    line += f" {'/'.join(str(p) for p in plan)}={t_ms:.4f}"
        say(line)


# --rmsnorm-bwd-profile: clock reads put into a copy of csrc/rmsnorm.cu at its
# phase boundaries: (text in the source, code put before it). Each text must
# occur once, so a changed source fails the profile, never the kernel.
PROFILE_PROBES = [
    ("  const double dd = (double)d;\n", "  long long P[12] = {gtime()}, P_c = 0;\n"),
    ("  {\n    double ss = 0.0, sgx = 0.0;\n", "  P[1] = gtime();\n"),  # row 0 is in
    ("    if (kVec && ring > 1 && next) {\n", "    P_c = clock64();\n"),
    ("#pragma unroll\n      for (int j = 0; j < VPT; ++j) {\n        each(",
     "      P[6] += clock64() - P_c; P_c = clock64();\n"),  # the ring's wait
    ("    } else {\n#pragma unroll\n      for (int j = 0; j < VPT; ++j)\n        each(",
     "      P[7] += clock64() - P_c;\n"),  # the fused sweep
    ("    if (next) reduce(i + 1, ss, sgx);\n", "    P_c = clock64();\n"),
    ("    // the reduction's barrier is the proof",
     "    P[8] += clock64() - P_c; P_c = clock64();\n"),  # the reduction
    ("    s = s1;\n", "    P[9] += clock64() - P_c;\n"),  # the refill
    ("  // this CTA's partial of dgamma", "  P[2] = gtime();\n"),
    ("  cooperative_groups::this_grid().sync();\n", "  P[3] = gtime();\n"),
    ("  // CTA b sums its slice of columns", "  P[4] = gtime();\n"),
]
PROFILE_GLOBALS = (
    "__device__ long long g_prof[4096 * 12];\n"
    "__device__ __forceinline__ long long gtime() {\n"
    '  long long v;\n  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));\n  return v;\n}\n'
    'extern "C" int get_prof(void* h, long long n) {\n'
    "  return (int)cudaMemcpyFromSymbol(h, g_prof, n);\n}\n")
PROFILE_STORE = (  # thread 0's record, before the kernel's closing brace
    "  if (t == 0) {\n    long long* o = g_prof + b * 12;\n"
    "    for (int k = 0; k < 10; ++k) o[k] = P[k];\n    o[5] = gtime();\n    o[10] = cnt;\n  }\n")


def rmsnorm_bwd_profile(torch):
    """Where a backward call's device time goes, at llama2-7b's training
    rows (2048, 4096) and at (8192, 4096) bf16, the wrapper's plan: a copy of
    csrc/rmsnorm.cu with PROFILE_PROBES (globaltimer at the phase
    boundaries of thread 0 of every CTA, clock64 around its per-row steps) is
    built apart into build/profile/ and called once, L2 flushed, after a
    device spin. Prints per CTA (median [min, max]): row 0 in (incl. gamma),
    the rows, the partial's write, the wait at the grid barrier and the
    column sums; per row thread 0's cycles waiting on the ring, in the fused
    sweep, in the reduction (its __syncthreads included) and issuing the
    refill; and the rows phase's achieved bandwidth (x, dy, dx bytes over
    the first CTA's start to the last CTA's last row)."""
    import ctypes
    import importlib

    import numpy as np

    from repro_torch.kernels import _build

    mod = importlib.import_module("repro_torch.kernels.rmsnorm")
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    for marker, code in PROFILE_PROBES:
        check(src.count(marker) == 1, f"profile marker not found once: {marker!r}")
        src = src.replace(marker, code + marker)
    src = src.replace('#include "common.cuh"\n', '#include "common.cuh"\n' + PROFILE_GLOBALS)
    close = src.rindex("}\n", 0, src.index("int launch_bwd("))
    src = src[:close] + PROFILE_STORE + src[close:]
    out = ROOT / "build" / "profile"
    out.mkdir(parents=True, exist_ok=True)
    (out / "rmsnorm.cu").write_text(src)
    (out / "common.cuh").write_text((_build.CSRC / "common.cuh").read_text())
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                            str(out / "libprofile.so"), str(out / "rmsnorm.cu")],
                           capture_output=True, text=True)
    check(built.returncode == 0,
          f"profile build failed: {built.stdout[-3000:]}{built.stderr[-3000:]}")
    lib = ctypes.CDLL(str(out / "libprofile.so"))
    lib.rmsnorm_bwd.argtypes = _build._SIGNATURES["rmsnorm_bwd"]
    lib.get_prof.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)

    def med(a):
        return f"{np.median(a):.2f} [{a.min():.2f}, {a.max():.2f}]"

    for n, d in ((2048, 4096), (8192, 4096)):
        x = torch.randn((n, d), generator=gen, device="cuda").bfloat16()
        dy = torch.randn((n, d), generator=gen, device="cuda").bfloat16()
        g = (1.0 + 0.1 * torch.randn((d,), generator=gen, device="cuda")).bfloat16()
        plan = mod.rmsnorm_bwd_plan(n, d, 2, n_sm, gamma_itemsize=2)
        dx, dgamma = torch.empty_like(x), torch.empty_like(g)
        ws = torch.empty((plan[3], d), dtype=torch.float64, device="cuda")
        args = (x.data_ptr(), g.data_ptr(), dy.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
                ws.data_ptr(), n, d, d, d, 1e-5, 1, 1, *plan, 1, _build.stream_of(x))
        for _ in range(3):
            _build.check(lib.rmsnorm_bwd(*args), "rmsnorm_bwd (profile)")
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        _build.check(lib.rmsnorm_bwd(*args), "rmsnorm_bwd (profile)")
        torch.cuda.synchronize()
        h = np.zeros(4096 * 12, dtype=np.int64)
        _build.check(lib.get_prof(h.ctypes.data, h.nbytes), "get_prof")
        h = h.reshape(4096, 12)[:plan[3]]
        us = (h[:, :6] - h[:, 0].min()) / 1e3
        rows = max(h[:, 10].max(), 1)
        bw = 3 * n * d * 2 / ((h[:, 2].max() - h[:, 0].min()) * 1e-9) / 1e12
        c = np.maximum(h[:, 10] - 1, 1)  # rows after row 0 (the per-row sums)
        say(f"profile rmsnorm_bwd ({n}, {d}) bf16 plan {plan} ({rows} rows a CTA at most): CTA "
            f"start {med(us[:, 0])} us, row 0 in {med(us[:, 1] - us[:, 0])}, rows "
            f"{med(us[:, 2] - us[:, 1])} (last ends at {us[:, 2].max():.2f}), partial "
            f"{med(us[:, 3] - us[:, 2])}, grid barrier {med(us[:, 4] - us[:, 3])}, columns "
            f"{med(us[:, 5] - us[:, 4])}, end {us[:, 5].max():.2f} us; thread 0 cycles a row: "
            f"ring wait {med(h[:, 6] / c)}, fused sweep {med(h[:, 7] / c)}, reduction "
            f"{med(h[:, 8] / c)}, refill {med(h[:, 9] / c)}; rows phase {bw:.2f} TB/s of "
            f"{HBM_BYTES_PER_S / 1e12:.2f}")


def decode_sweep(torch, timer):
    """decode_attention's time by head-group size, bf16, dh 128: at each
    shape (the ICC batch of 8 rows with 16-30 valid slots, one row of ~560
    valid slots, and full 8192-slot caches) the kernel with every group size
    the kernel takes (1, 2 or 4 heads a CTA) that divides G, and SDPA on the
    same inputs. Each size is checked against the plain version first."""
    import importlib

    import torch.nn.functional as F

    from repro_torch.kernels import ref

    mod = importlib.import_module("repro_torch.kernels.decode_attention")
    gen = torch.Generator(device="cuda").manual_seed(0)
    say(f"timer floor: {timer(lambda: torch.cuda._sleep(0)):.4f} ms")
    icc = [16 + 2 * b for b in range(8)]
    rule = mod.head_groups
    for B, H, K, Sc, lengths in [
        (8, 32, 2, 576, icc), (1, 32, 2, 576, [560]),  # glm4-9b, G = 16
        (8, 96, 8, 576, icc), (1, 96, 8, 576, [560]),  # mistral-large-123b, G = 12
        (8, 64, 8, 576, icc),  # qwen1.5-110b / qwen2-vl-72b, G = 8
        (8, 48, 8, 576, icc), (1, 48, 8, 576, [560]),  # nemotron-4-15b, G = 6
        (8, 32, 32, 576, icc), (1, 32, 32, 576, [576]),  # llama2-7b, G = 1
        (8, 32, 2, 8192, [8192] * 8), (1, 32, 2, 8192, [8192]),  # long caches, G = 16
    ]:
        q = torch.randn((B, H, 128), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((B, Sc, K, 128), generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        kv_pos, pos = decode_positions(torch, B, Sc, lengths)
        mask = ((kv_pos >= 0) & (kv_pos <= pos[:, None]))[:, None, None, :]
        want = ref.decode_attention(q, k, v, kv_pos, pos)
        G = H // K
        lib = timer(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=K != H))
        line = (f"sweep decode_attention B={B} H={H} K={K} G={G} Sc={Sc} valid {sum(lengths)}: "
                f"SDPA {lib:.4f} ms, rule {G // rule(G)} heads/CTA; heads/CTA")
        try:
            for gc in (gc for gc in (4, 2, 1) if G % gc == 0):
                mod.head_groups = lambda G, gc=gc: G // gc
                assert_close(torch, mod.decode_attention(q, k, v, kv_pos, pos), want,
                             "bfloat16", f"decode_attention {gc} heads/CTA B={B} H={H} K={K}")
                line += f" {gc}={timer(lambda: mod.decode_attention(q, k, v, kv_pos, pos)):.4f}"
        finally:
            mod.head_groups = rule
        say(line)


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rmsnorm-sweep", action="store_true",
                    help="only build and time rmsnorm's CTA shapes (rmsnorm_sweep)")
    ap.add_argument("--rmsnorm-bwd-sweep", action="store_true",
                    help="only build and time rmsnorm_bwd's plans (rmsnorm_bwd_sweep)")
    ap.add_argument("--rmsnorm-bwd-profile", action="store_true",
                    help="only build an instrumented copy of rmsnorm_bwd and print where a "
                         "call's time goes (rmsnorm_bwd_profile)")
    ap.add_argument("--decode-sweep", action="store_true",
                    help="only build and time decode_attention's head groups (decode_sweep)")
    ap.add_argument("--decode-profile", metavar="ARCH",
                    help="only build and profile ARCH's decode steps at full width "
                         "(profile_decode)")
    ap.add_argument("--sharded", action="store_true",
                    help="only build the kernels and run the sharded phase, serving and "
                         "training (phase_sharded)")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the src/ directory whose repro_torch to drive (default: beside "
                         "this script)")
    args = ap.parse_args()
    src = args.src.resolve()
    if not (src / "repro_torch" / "__init__.py").is_file():
        say(f"FAIL: {src}/repro_torch is not there (it belongs beside chip_smoke.py)")
        return 2
    sys.path.insert(0, str(src))
    import torch

    from repro_torch.launch.roofline import H100

    global HBM_BYTES_PER_S
    HBM_BYTES_PER_S = H100.hbm_bw
    PEAK_FLOPS.update(bfloat16=H100.flops, float32=H100.flops_f32)

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is False; this script needs a CUDA card")
        return 2
    card = phase_card(torch)
    if args.rmsnorm_sweep:
        from repro_torch.kernels import _build

        _build.library()
        rmsnorm_sweep(torch, Timer(torch))
        say(f"rmsnorm sweep done in {time.perf_counter() - t_start:.1f} s on {card}")
        return 0
    if args.rmsnorm_bwd_sweep:
        from repro_torch.kernels import _build

        _build.library()
        rmsnorm_bwd_sweep(torch, Timer(torch))
        say(f"rmsnorm_bwd sweep done in {time.perf_counter() - t_start:.1f} s on {card}")
        return 0
    if args.rmsnorm_bwd_profile:
        rmsnorm_bwd_profile(torch)
        say(f"rmsnorm_bwd profile done in {time.perf_counter() - t_start:.1f} s on {card}")
        return 0
    if args.decode_sweep:
        from repro_torch.kernels import _build

        _build.library()
        decode_sweep(torch, Timer(torch))
        say(f"decode sweep done in {time.perf_counter() - t_start:.1f} s on {card}")
        return 0
    if args.sharded:
        from repro_torch.kernels import _build

        _build.library()
        phase_sharded(torch, card)  # its peaks are held in phase 8, which this skips
        say(f"sharded serving and training done in {time.perf_counter() - t_start:.1f} s on "
            f"{card}")
        return 0
    if args.decode_profile:
        from repro_torch.configs import get_config
        from repro_torch.kernels import _build
        from repro_torch.models import build_model

        _build.library()
        cfg = get_config(args.decode_profile)
        model = build_model(cfg)
        say(f"{cfg.name} full width, {cfg.n_layers} layers, {cfg.dtype}, package {src}")
        profile_decode(torch, model, model.init(seed=0, device="cuda"), cfg, 8, 576)
        say(f"decode profile done in {time.perf_counter() - t_start:.1f} s on {card}")
        return 0
    lap = [time.perf_counter()]

    def took(phase):  # phases 6-9 print their own time too
        now = time.perf_counter()
        say(f"phase {phase} took {now - lap[0]:.1f} s")
        lap[0] = now

    phase_build()
    took(2)
    rows = phase_kernels(torch, Timer(torch))
    took(3)
    phase_smoke_model(torch)
    took(4)
    launches, cal, mem = phase_full_width(torch)
    took(5)
    sharded, sharded_peaks = phase_sharded(torch, card)
    for k, v in sharded.items():
        launches[k] = launches.get(k, 0) + v
    took(10)
    # phase 9 is host code in a pool of processes; phase 6, one host process,
    # runs beside it, and no phase on the card runs while they do
    phase_network(card, cal["llama2-7b"], mem["llama2-7b"],
                  workers=max(1, len(os.sched_getaffinity(0)) - 1),
                  meanwhile=lambda: phase_capacity(cal["llama2-7b"], card))
    took("6 + 9")
    trained, peaks = phase_training(torch, card)
    for k, v in trained.items():
        launches[k] = launches.get(k, 0) + v
    phase_dryrun(torch, peaks, sharded_peaks, card)

    seen = set()
    kernels = []
    for r in rows:  # the first row of each kernel is llama2-7b's ICC shape
        if r["name"] not in seen:
            seen.add(r["name"])
            kernels.append(dict(r, launches=launches[r["name"]]))
    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
