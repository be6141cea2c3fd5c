#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubeflow_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

(``python3 chip_smoke.py --worker ARGS`` is phase 9's child: the worker
CLI with the transformer workload at the default LM's widths.)

Phases, each of which fails the run (nonzero exit, no result line):

1. device  - the card's name and power limit; build every kernel in
             kubeflow_tpu_torch/csrc/ with nvcc, one process per source,
             all started together (ptxas report printed for each).
2. kernels - each kernel against its plain PyTorch version on the card,
             and timed with CUDA events beside its bound and one PyTorch
             call computing the same function (timed here only; the port
             never calls it):
             K1, the flash-attention forward: bf16 at the serving shape
             (batch 1 and 8, S 2048, 12 heads x 64, causal), non-causal,
             a ragged S 1000, f32, and with_lse; then bf16 cases that
             stress the tensor-core kernel (D 32, 128 and 40, S 1 and 65,
             causal with Sq != Sk both ways, the fused-qkv slices), and
             f32 with 65,537 (batch, head) pairs; yardstick sdpa.
             K2a/K2b, the backward (dq; dk and dv), both bf16 kernels on
             the tensor cores: bf16 at the training shape [8, 2048, 12,
             64] causal, non-causal, ragged S 1000, f32 S 333, and bf16 at
             D 32, 128 and 40, S 65, S 1 and one q row over 65 keys, and
             65,537 (batch, head) pairs in bf16 and f32, on strided
             slices of a fused qkv tensor; yardstick sdpa's backward
             through torch.autograd.grad.
             Each case prints the largest share of its bar that any value
             uses; each timing its TFLOP/s and its share of the bound.
             K1, K2a and K2b on their FMA kernels at the head dims the
             tensor-core kernels do not take (256 in f32 and bf16, causal
             and not; bf16 36 and 200; 320 and 512, which run in chunks of
             256 columns) and on a bf16 view at D 64 that the 16-byte
             copies cannot read (the counted unaligned route) against
             their plain versions, and timed at [8, 2048, 12, 256] bf16
             causal beside sdpa's forward and backward.
             K3, the fused Adam update with optax's clip folded in, one
             launch a step: the LM's 101 parameter tensors for 3 steps
             with weight decay on the rank > 1 ones, the clip on both
             branches and one tensor without a gradient, then ragged and
             unaligned lengths; yardstick torch.optim.Adam(fused=True),
             and for the whole update (global norm, clip, K3)
             clip_grad_norm_(foreach=True) + Adam(fused=True).
3. serving - the Transformer LM at its default widths (12 layers, embed
             768, 12 x 64 heads, MLP 3072, vocab 32000, S 2048, bf16,
             random weights from a seed) served with attention="flash"
             through the model server's own MicroBatcher (continuous
             batching, max_batch 8) under 6 concurrent requests of 1-3
             rows. Every launch count starts at 0 just before and is read
             just after: K1 must have run 12 times (one per layer) per
             forward. Predictions are held against an einsum-attention
             servable on the same weights.
4. rest    - a ModelServer on a local port (same widths, max_seq_len 128)
             answers 3 :predict requests through the port's REST client;
             /healthz and /metrics answer.
5. train   - the same LM at full width trained through the worker's
             train() with kernel_attention="flash" and
             kernel_optimizer="fused_adam" (adam, global batch 8, 6 steps,
             sync_every 2). Every launch count starts at 0 just before and
             is read just after: per step K1, K2a and K2b 12 times each and
             K3 once (over all 101 parameter tensors). Losses finite and
             falling; then two 3-step runs at batch 2 from the same seed,
             flash + fused_adam against einsum + stock, must agree within
             the stated tolerance.
6. resnet  - ResNet-50 at full width (224 px, 1000 classes, batch 64,
             random weights from a seed) trained through train() with the
             worker's default recipe (momentum, lr 0.1, 6 steps, sync_every
             2): the exact-BN default path (with its eval pass), then
             fused: True. Every K4/K5 count starts at 0 just before each run
             and is read just after: the default path launches none, each
             fused step K4 7 + 7 and K5 6 + 6 (forward + backward), the
             routing equals the JAX package's fused_block_routing(50, 224),
             losses are finite, and at init the fused loss lies within 0.5
             of the default path's on the same weights and batch.
6b. records - ResNet-50 fused at full width trained by train() from
             record shards that the port's write_shards puts in a temp dir
             (640 records of 224 px in 4 shards, 96.3 MB, and a holdout of
             100; about 111 MB) and that the native pipeline, built by make
             into kubeflow_tpu_torch/_build/native, reads: LARS, lr 0.1,
             cosine with 2 warmup steps under the runtime schedule, 12
             steps, sync_every 3, the whole holdout evaluated at the end,
             with input_workers 0 and 2 by device_prefetch 0 and 2, then on
             the synthetic pool with the same recipe: each timed, then
             each again with a profile (after a capture this process's
             steps stay slower, so every timed run comes first; the
             synthetic run is timed once more after the captures). Each
             run serves its /metrics port, which a poller reads
             (/flightrecorder, /metrics; every 0.25 s in a timed run,
             every 20 ms in a profiled one) and, in a profiled run, arms
             (POST /profile?steps=3 once the first window closed). Every
             K4/K5 count starts at 0 just before each run and is read just
             after: K4 7 + 7 and K5 6 + 6 a step. Fails unless the window
             losses are finite, the eval counted exactly 100 records (64,
             then 36 padded and masked), the native pipeline and augment
             made every batch, the capture holds a trace, the TensorBoard
             dir an events file, /flightrecorder the windows with their
             stage split and /metrics both input stages. Prints each
             run's step ms and images/s, the recorder's stages and the
             profiled device-idle share, and the device's busy time a step
             over the timed step. Then
             DevicePrefetcher over 20 batches while the consumer runs a K5
             backward between batches, byte for byte against the host
             batches and at most depth batches on the card;
             device_normalize on the card against the CPU (<= 1e-6); LARS
             and RMSProp, baked and under the runtime schedule, 5 steps
             over ResNet-50's parameters on the card against the CPU
             (<= 1e-5 relative).
7. resnet-serve - ResNet-50 inference at full width (224 px, 1000
             classes, bf16, seeded variables whose BatchNorms all act:
             scales 1 + N(0, 0.1), shifts and running means N(0, 0.1),
             variances U(0.5, 1.5)) loaded through ModelRepository on the
             card, max_batch 64, every bucket warmed: 6 concurrent
             requests of 1-8 rows through the server's MicroBatcher, two
             REST :predict requests of 1-2 rows, and run_batch_predict over
             an .npy of 130 images at batch size 64 (two full batches and
             a padded tail), each against a direct predict. The served path
             runs ResNet.apply (cuDNN convs) and launches no K6. Then
             fused_eval_apply on the same variables and 64 images: the K6
             count starts at 0 just before and is read just after, 13
             launches a forward; logits within 5e-2 of the largest served
             logit and classes agreeing on >= 98% of rows, each other row's
             top-2 margin below the measured max|d logit|. Images/s and
             peak memory of both forwards (CUDA events).
8. dp      - data parallel across processes. (a) initialize() on a
             one-process contract env joins an NCCL group (the default
             backend on the card) and the port's all_reduce,
             reduce_scatter_tensor and all_gather_into_tensor return the
             expected values on CUDA tensors, none staged through host
             memory. (b) One process trains the full-width LM (flash,
             fused_adam, clip 1.0, batch 8, 4 steps) with the replicated
             update, then fused ResNet-50 (224 px, batch 64, 3 steps)
             through a loss that takes the mean of the two 32-row halves
             (what two ranks compute); the card is freed. Then two
             worker processes, spawned with the topology-contract env
             (and a pod identity), share the card in one gloo group (NCCL
             refuses two ranks on one card), and each trains both through
             train() with the sharded update (ZeRO-2) on its rows: per
             rank per step K1, K2a, K2b 12 launches each and K3 one; K4 7
             + 7 and K5 6 + 6. Each rank's losses within 1e-3 and grad
             norms within 1e-2 of the one process, relative, per step;
             the LM's param_sqnorm_replicas equal on both ranks; each
             rank's Adam moments at most half the one process's plus the
             replicated leaves; ResNet's batch_stats equal on both ranks
             and within 1e-2 of each tensor's largest value of the one
             process's. (d) A local HTTP server plays the apiserver: both
             pods receive heartbeat PATCHes carrying step, lastLoss and
             lastGradNorm. (e) Per rank: step time, the collectives'
             device time a step (CUDA events around each call, host
             staging included), the calls staged through host memory,
             peak memory, each line with the card's name and power
             limit. Two ranks on one card check numerics, launches and
             memory; none of these times is a scaling figure.
9. ckpt    - fault-tolerant training at full width, checkpoints in a temp
             dir removed afterwards. (a) The LM of phase 5 (flash,
             fused_adam, clip 1.0, batch 8) trains 6 steps through
             train() with checkpoint_every 2; the worker CLI in a
             subprocess (this script with --worker: the CLI's transformer
             at the default widths) gets a real SIGTERM from a local stub
             apiserver while its heartbeat reports step 2, and must exit
             75 with step 3 committed and verified; train() resumes it to
             step 6: 3 steps executed, K1, K2a, K2b 12 launches each and
             K3 one a step, and the params within 1e-6 of the largest
             |param| of the uninterrupted run's (0 expected). Prints each
             save's synchronous and to-committed ms, the payload bytes a
             step and the restore ms. (b) The worker CLI child again,
             with the sentinel (check_every 1) and
             KFTPU_CHAOS_NUMERIC=nan:5, must exit 76 with its evidence
             posted to the stub (nan-loss or nan-grad at step 5 or 6, LKG
             4), LKG 4 in the marker and nothing newer than 4 on disk;
             train() rerun with KFTPU_RESUME_STEP=4 (the mark file says the
             fault fired) executes 2 steps and ends within the same bar of
             the uninterrupted run. (c)
             ModelRepository.load(checkpoint_dir=...) serves version 6
             through K1 (12 launches a forward), its logits within 5e-2 of
             the largest logit of an einsum forward of final_params and
             next_token equal; train() saves step 8 and reload() serves
             it. (d) Across a change of degree: two gloo ranks sharing the
             card train the LM sharded for 2 steps (run block
             {replicaDegree 2, globalBatch 8}) and one process resumes it
             for steps 3-4; one process trains fused ResNet-50 (batch 64,
             momentum) 2 steps and two sharded ranks resume it for step 3.
             Each against one process without a restore (phase 8's LM;
             for ResNet the same process with the two halves' loss at
             step 3), phase 8's bars; every segment's launches per
             executed step checked; a global batch of 16 refuses the
             resume with ElasticContractError. The kernels at these
             shapes are held to their plain versions in phases 2 and 8.

Phase 2 also holds K4 and K5 (the fused ghost-BN bottleneck, batch-tiled
and spatial, csrc/fused_block_train.cu) against their plain versions at
the five stride-1 geometries of ResNet-50 at 224 px, batch 64, bf16, with
the JAX package's tiles: out and the 8 statistics, the per-ghost
statistics the forward saves against ghost_stats_plain, dx and every
weight gradient of the backward from those saved statistics (as the
training step runs it) against torch.autograd.grad of the plain version,
a second call of that backward equal to the first bit for bit, and K5's
seam rows of dx in norm against the backward's own formula in
plain PyTorch (backward_plain, which rounds where the kernel rounds);
each geometry prints the largest share of a bar it uses; timed beside
the bound, the plain version and a cuDNN + batch-BN yardstick (not the
same function: library_ms is null, the yardstick's time is
yardstick_ms), and each geometry's forward workspace. And K6 (the fused
inference bottleneck, csrc/fused_block.cu, phase_k6) against its plain
version at the same five geometries with seeded folded-BN weights, timed
beside its bound, the plain version and the same block through cuDNN
convs and folded affines (_xla_block_eval's ops at stride 1: the same
function up to where the products round, so a true library_ms); before
it, cuobjdump's SASS of both fused-block builds must show HGMMA (`wgmma`)
in every warpgroup-product kernel (csrc/wgmma_gemm.cuh), the products of
K6 and of the K4/K5 forward.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import replace

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

# H100 SXM published peaks (dense): bf16 tensor-core rate and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

SERVE_LAYERS = 12
SERVE_HEADS, SERVE_HEAD_DIM, SERVE_SEQ = 12, 64, 2048
SERVE_VOCAB = 32000
REST_SEQ = 128
MAX_BATCH = 8
TRAIN_BATCH, TRAIN_STEPS, TRAIN_SYNC = 8, 6, 2
TRAIN_LR = 6e-4
COMPARE_BATCH, COMPARE_STEPS = 2, 3
# bf16 output of two f32 computations that sum in another order: at most
# one bf16 rounding step apart (2^-7 of the value), plus a floor for
# values near 0
BF16_ATOL, BF16_RTOL = 1e-2, 2.0 ** -7
F32_ATOL = 1e-4
LSE_ATOL = 1e-3
# K2 (gradients): one bf16 step of each value, plus half a step at the
# largest value for f32 sums of up to S terms taken in another order
# before the rounding; f32 within 1e-4 of the largest value
K2_BF16_RTOL, K2_BF16_FLOOR = 2.0 ** -7, 2.0 ** -8
K2_F32_TOL = 1e-4
# K3: the kernel and the plain version round every operation on its own,
# in one order; they may differ only where sqrt or a division do
K3_ATOL = 1e-6
# flash + fused_adam against einsum + stock on the same weights and
# batches: bf16 activations through 12 layers, rounded at other places on
# the two attention paths (q scaled in bf16 vs in f32 inside the kernel;
# softmax probabilities stored in bf16 vs recomputed in f32). The loss
# averages 4094 x 2 per-token errors, so it agrees closely; the gradient
# norm sums the squares of every element's rounding difference.
LOSS_RTOL, GNORM_RTOL = 1e-2, 5e-2

# ResNet-50 at its full width: 224 px, 1000 classes, batch 64
IMAGE, CLASSES, RESNET_BATCH = 224, 1000, 64
# the JAX package's (route, tile_bt, tile_h) for each stride-1 geometry at
# 224 px and batch 64 (kubeflow_tpu/models/resnet.py _fused_route over
# stride1_geometries(50, 224)): the ghost batch, so part of the function
EXPECTED_TILES = {
    "56x56_64_64_256": ("spatial", 1, 14),
    "56x56_256_64_256": ("spatial", 1, 14),
    "28x28_512_128_512": ("spatial", 1, 14),
    "14x14_1024_256_1024": ("batch", 1, None),
    "7x7_2048_512_2048": ("batch", 2, None),
}
# and kubeflow_tpu's fused_block_routing(50, 224), verbatim
EXPECTED_ROUTING = {
    **{f"stage1_block{j}": "fused-spatial(th=14)" for j in (1, 2, 3)},
    "stage2_block1": "xla-strided",
    **{f"stage2_block{j}": "fused-spatial(th=14)" for j in (2, 3, 4)},
    "stage3_block1": "xla-strided",
    **{f"stage3_block{j}": "fused-batch" for j in (2, 3, 4, 5, 6)},
    "stage4_block1": "xla-strided",
    **{f"stage4_block{j}": "fused-batch" for j in (2, 3)},
}
# K4/K5 against their plain versions on the same bf16 inputs.
# - out: both compute the same f32 arithmetic and round h1, h2 and out to
#   bf16; sums taken in another order can move an f32 value across a
#   bf16 rounding boundary, so an element may land one or two bf16 steps
#   apart: |d| <= 2^-6 (|ref| + 1).
# - statistics: f32 means over 98-896 samples of f32 products summed in
#   another order: within 1e-3 of the largest value (+ 1e-5).
# - dx and weight gradients: the plain version's autograd rounds the
#   gradients of its bf16 tensors (dh1, dh2) to bf16 and keeps da in f32;
#   the kernel, as the TPU kernel, keeps dh in f32 and rounds da to bf16
#   before its products: each placement moves values by up to 2^-8 of
#   themselves, so the gradients agree to about 2^-7 in norm. And the
#   kernel recomputes the interior, so where a pre-activation lies within
#   f32 noise of 0 the two sides take the other branch of a relu: that
#   element's gradient changes by the full upstream value (measured on
#   the H100: about 5 elements in 10^5, each up to 47% of the largest
#   dx where the residual passes gz straight to dx). So the bar is in
#   norm, ||d|| <= 2^-5 ||ref||, and elementwise for all but 10^-3 of
#   the elements, |d| <= 2^-5 max|ref|.
# - out, likewise: the elementwise bar above for all but 10^-4 of the
#   elements (a relu flip in h1 or h2 moves a few outputs further).
# - K5's seam rows of dx (the rows either side of a strip boundary, 2 in
#   14, where the halo terms of BN1's backward land), against the
#   backward kernels' own formula in plain PyTorch
#   (fused_block_train_spatial.backward_plain, which rounds where the
#   kernel rounds): ||d|| <= 2^-6 ||ref|| over those rows. A fault in the
#   halo terms moves a few % of 2 rows in 14, under the whole-dx bar. On
#   the H100 the kernel reads 3.0e-3 to 5.5e-3 there (the relu flips
#   above dominate), and a build that applies BN1's correction to the
#   halo rows too reads 3.2e-2 to 4.6e-2 while passing every other bar.
K45_OUT_TOL, K45_STAT_TOL, K45_GRAD_FRAC = 2.0 ** -6, 1e-3, 2.0 ** -5
K45_OUT_OUTLIERS, K45_GRAD_OUTLIERS = 1e-4, 1e-3
K45_SEAM_TOL = 2.0 ** -6
# K6 against its plain version on the same bf16 inputs: both round h1, h2,
# h3, the projection and the residual sum to bf16 at the same points, from
# f32 sums taken in another order, so an element may land one or two bf16
# steps apart, and a little further where a rounding flip in h3 or the
# projection meets a residual that cancels it: phase_k45's forward bar,
# |d| <= 2^-6 (|ref| + 1) for all but 10^-4 of the elements.
K6_TOL, K6_OUTLIERS = 2.0 ** -6, 1e-4
# ... and that bar cannot see a rounding point: a build that skips h3's
# rounding to bf16 moves elements by half a step of h3 and passes it. But
# the kernel and its plain version round at the same points, so they
# differ at all only where an f32 sum taken in another order crosses a
# bf16 rounding boundary. Measured on the H100, the kernel differs from
# its plain version in 0.03% (56x56x64) to 1.7% (7x7x2048) of the
# elements, more where the sums are longer; the build that leaves h3
# unrounded in 12.5%. Bar: <= 4%.
K6_DIFFER = 0.04
# ResNet-50 inference: the served path (ResNet.apply) against
# fused_eval_apply on the same weights and images; they round at other
# places (folded affines, the pool in f32) through 50 bf16 layers
SERVE_BATCH, PREDICT_ROWS = 64, 130
FUSED_LOGIT_TOL, FUSED_AGREE = 5e-2, 0.98


def fail(msg: str) -> None:
    raise AssertionError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs,
    between two CUDA events, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(flops, nbytes, flops_peak) -> tuple:
    """The larger of the operations over the peak rate for their type and
    the bytes over the memory rate, and which of the two it is."""
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def attention_work(b, s, h, d, causal, itemsize, products=2, tensors_in=3,
                   tensors_out=1, rows_f32=1) -> tuple:
    """(FLOPs, bytes) of an attention function: ``products`` S x S x D
    matmuls over the unmasked (row, col) pairs, against ``tensors_in``
    [B, S, H, D] inputs read once and ``tensors_out`` written once in the
    input type, plus ``rows_f32`` f32 [B, H, S] rows (lse, delta). The
    forward is 2 products (3 in, 1 out, lse); K2a 3 (s, dp, dq; q k v do
    in, dq out, lse and delta); K2b 4 (s, dp, dv, dk; dk dv out); the
    whole backward 5 (s, dp, dq, dk, dv)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2 * products * b * h * d * pairs
    nbytes = (tensors_in + tensors_out) * b * s * h * d * itemsize + \
        rows_f32 * b * h * s * 4
    return flops, nbytes


def attention_bound_ms(b, s, h, d, causal, itemsize, **work) -> tuple:
    """Least time for an attention function on the card (attention_work
    at the peak rate for the input type and the memory rate)."""
    flops, nbytes = attention_work(b, s, h, d, causal, itemsize, **work)
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    return bound_ms(flops, nbytes, peak)


def tflops(b, s, h, d, causal, itemsize, ms, **work) -> float:
    """The rate a kernel reached: attention_work's FLOPs over its time."""
    return attention_work(b, s, h, d, causal, itemsize, **work)[0] / \
        (ms * 1e-3) / 1e12


# -- phase 1 ----------------------------------------------------------------


def phase_device(build) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {name} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = build.build_all(verbose=True)
    log(f"[device] built {sorted(built)} in "
        f"{time.perf_counter() - t0:.2f}s")
    for kernel, rec in built.items():
        log(f"[device] nvcc -Xptxas -v for csrc/{kernel}.cu:\n"
            f"{rec['log'].strip()}")
    return {"card": card, "kind": name}


# -- phase 2 ----------------------------------------------------------------


def phase_kernels(fa) -> dict:
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    h, d = SERVE_HEADS, SERVE_HEAD_DIM

    def qkv(b, sq, sk, h, d, dtype, fused):
        if fused:   # the model's slices of one fused qkv tensor
            x = torch.randn((b, sq, 3, h, d), generator=gen, device=dev,
                            dtype=torch.float32).to(dtype)
            return x[:, :, 0], x[:, :, 1], x[:, :, 2]
        return tuple(torch.randn((b, s, h, d), generator=gen, device=dev,
                                 dtype=torch.float32).to(dtype)
                     for s in (sq, sk, sk))

    bf = torch.bfloat16
    cases = [  # (label, b, sq, sk, h, d, causal, dtype, fused)
        ("serving b=1", 1, SERVE_SEQ, SERVE_SEQ, h, d, True, bf, False),
        ("serving b=8", MAX_BATCH, SERVE_SEQ, SERVE_SEQ, h, d, True, bf,
         False),
        ("non-causal b=2", 2, SERVE_SEQ, SERVE_SEQ, h, d, False, bf, False),
        ("ragged S=1000", 2, 1000, 1000, h, d, True, bf, False),
        ("f32 S=333", 2, 333, 333, h, d, True, torch.float32, False),
        # the bf16 kernel's templates (D 32, 64, 128), a padded D, S = 1,
        # a ragged tile, causal with Sq != Sk, and the fused-qkv slices
        ("D=32 S=300", 2, 300, 300, 4, 32, True, bf, False),
        ("D=128 S=257", 2, 257, 257, 4, 128, True, bf, False),
        ("D=40 S=190", 2, 190, 190, 3, 40, True, bf, False),
        ("S=1", 3, 1, 1, h, d, True, bf, False),
        ("S=65", 2, 65, 65, h, d, True, bf, False),
        ("causal Sq=300 Sk=1000", 2, 300, 1000, h, d, True, bf, False),
        ("causal Sq=1000 Sk=300", 2, 1000, 300, h, d, True, bf, False),
        ("fused qkv b=2", 2, SERVE_SEQ, SERVE_SEQ, h, d, True, bf, True),
        # one rank's rows of phase 8's LM (the training shape over DP_RANKS)
        (f"DP rank b={TRAIN_BATCH // DP_RANKS}", TRAIN_BATCH // DP_RANKS,
         SERVE_SEQ, SERVE_SEQ, h, d, True, bf, True),
        # the f32 kernel's flat grid: more (batch, head) pairs than
        # gridDim.y takes
        ("f32 b*h=65537", 1, 16, 16, 65537, 8, True, torch.float32, False),
    ]
    err_at_serving, err_dp, margins = 0.0, 0.0, {}
    for label, b, sq, sk, hh, dd, causal, dtype, fused in cases:
        q, k, v = qkv(b, sq, sk, hh, dd, dtype, fused)
        o, lse = fa.flash_attention(q, k, v, causal=causal, with_lse=True)
        torch.cuda.synchronize()
        p_o, p_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
        if o.shape != p_o.shape or o.dtype != dtype or \
                lse.shape != (b, hh, sq):
            fail(f"{label}: shapes {tuple(o.shape)} {tuple(lse.shape)}")
        if not (torch.isfinite(o.float()).all() and
                torch.isfinite(lse).all()):
            fail(f"{label}: non-finite output")
        d_o = (o.float() - p_o.float()).abs()
        d_lse = (lse - p_lse).abs().max().item()
        if dtype == torch.bfloat16:
            limit = BF16_ATOL + BF16_RTOL * p_o.float().abs()
            tol = f"|d| <= {BF16_ATOL} + 2^-7|o|"
        else:
            limit = torch.full_like(d_o, F32_ATOL)
            tol = f"|d| <= {F32_ATOL}"
        # the largest share of its bar that any value uses (<= 1 passes)
        margin = max((d_o / limit).max().item(), d_lse / LSE_ATOL)
        margins[label] = margin
        ok = bool((d_o <= limit).all()) and d_lse <= LSE_ATOL
        log(f"[kernels] K1 {label}: max|d o| {d_o.max().item():.3e} "
            f"({tol}), max|d lse| {d_lse:.3e} (<= {LSE_ATOL}), "
            f"{margin:.3f} of the bar {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K1 disagrees with its plain version at {label}")
        if label == f"serving b={MAX_BATCH}":
            err_at_serving = d_o.max().item()
        if label.startswith("DP rank"):
            err_dp = d_o.max().item()
        del q, k, v, o, lse, p_o, p_lse, d_o

    timings = {}
    for b in (1, MAX_BATCH):
        q, k, v = qkv(b, SERVE_SEQ, SERVE_SEQ, h, d, bf, False)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        # inputs of 3 x b x 3 MB: at b=8 (75 MB) they exceed the 50 MB L2
        ms = cuda_time_ms(lambda: fa.flash_attention_fwd_cuda(
            q, k, v, causal=True))
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_fwd_plain(
            q, k, v, causal=True), iters=5)
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        shape = (b, SERVE_SEQ, h, d, True, 2)
        bound, by = attention_bound_ms(*shape)
        rate = tflops(*shape, ms)
        timings[b] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound, "bound_by": by, "tflops": rate}
        log(f"[kernels] K1 time b={b} S={SERVE_SEQ} H={h} D={d} bf16 "
            f"causal: kernel {ms:.4f} ms ({rate:.1f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms "
            f"({tflops(*shape, lib_ms):.1f} TFLOP/s), bound {bound:.4f} "
            f"ms ({by}), kernel at {bound / ms:.2%} of bound")
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return {"err": err_at_serving, "err_dp": err_dp, "timings": timings,
            "margins": margins}


def _k2_close(got, ref, dtype) -> tuple[bool, float, float]:
    """(within the bar, max|d|, the largest share of its bar that any
    value uses)."""
    d = (got.float() - ref.float()).abs()
    r = ref.float().abs()
    if dtype == torch.bfloat16:
        limit = K2_BF16_RTOL * r + K2_BF16_FLOOR * r.max()
        margin = (d / limit.clamp_min(1e-30)).max().item()
        ok = bool((d <= limit).all())
    else:
        limit = K2_F32_TOL * max(1.0, r.max().item())
        margin = d.max().item() / limit
        ok = d.max().item() <= limit
    return ok, d.max().item(), margin


def phase_k2(fa) -> dict:
    """K2a and K2b against their plain versions on the same inputs (o and
    lse from the plain forward, delta from attention_delta), q, k, v as
    strided slices of one fused qkv tensor, as the model feeds them; times
    at the training shape beside the bounds, the plain versions and sdpa's
    backward."""
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    h, d = SERVE_HEADS, SERVE_HEAD_DIM

    def inputs(b, s, causal, dtype, h=h, d=d, sq=None):
        qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev).to(
            dtype)
        q, k, v = qkv[:, :sq, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        o, lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
        return q, k, v, do, lse, fa.attention_delta(o, do)

    bf = torch.bfloat16
    cases = [  # (label, b, s (keys), causal, dtype, h, d, q rows)
        (f"train b={TRAIN_BATCH}", TRAIN_BATCH, SERVE_SEQ, True, bf, h, d,
         None),
        (f"DP rank b={TRAIN_BATCH // DP_RANKS}", TRAIN_BATCH // DP_RANKS,
         SERVE_SEQ, True, bf, h, d, None),
        ("non-causal b=2", 2, SERVE_SEQ, False, bf, h, d, None),
        ("ragged S=1000", 2, 1000, True, bf, h, d, None),
        ("f32 S=333", 2, 333, True, torch.float32, h, d, None),
        # the bf16 K2b's templates (D 32, 64, 128), a padded D, a ragged
        # tile, one key (a k tile with 127 of its 128 rows past Sk) and one
        # q row over 65 keys
        ("D=32 S=300", 2, 300, True, bf, 4, 32, None),
        ("D=128 S=257", 2, 257, True, bf, 4, 128, None),
        ("D=40 S=190", 2, 190, True, bf, 3, 40, None),
        ("S=65", 2, 65, True, bf, h, d, None),
        ("S=1", 3, 1, True, bf, 2, d, None),
        ("Sq=1 Sk=65 non-causal", 3, 65, False, bf, h, d, 1),
        # the flat grids: more (batch, head) pairs than gridDim.y takes
        ("b*h=65537", 1, 40, True, bf, 65537, 8, None),
        ("f32 b*h=65537", 1, 40, True, torch.float32, 65537, 8, None),
    ]
    errs, errs_dp, margins = {}, {}, {}
    for label, b, s, causal, dtype, hh, dd, sq in cases:
        q, k, v, do, lse, delta = inputs(b, s, causal, dtype, hh, dd, sq)
        assert not q.is_contiguous()
        dq = fa.flash_attention_bwd_dq_cuda(q, k, v, do, lse, delta,
                                            causal=causal)
        dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                 causal=causal)
        torch.cuda.synchronize()
        p_dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                               causal=causal)
        p_dk, p_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse,
                                                      delta, causal=causal)
        results = {n: _k2_close(g, r, dtype) for n, g, r in
                   (("dq", dq, p_dq), ("dk", dk, p_dk), ("dv", dv, p_dv))}
        for n, g in (("dq", dq), ("dk", dk), ("dv", dv)):
            if g.shape != (q if n == "dq" else k).shape or \
                    g.dtype != dtype or \
                    not torch.isfinite(g.float()).all():
                fail(f"K2 {label}: {n} {tuple(g.shape)} {g.dtype} or "
                     f"non-finite")
        tol = (f"|d| <= 2^-7|ref| + 2^-8 max|ref|"
               if dtype == torch.bfloat16 else
               f"|d| <= {K2_F32_TOL} max(1, max|ref|)")
        # with one key p = 1 and ds = p (dp - delta) = 0, so dq and dk are
        # 0 up to rounding noise, which no relative bar holds; dv (the sum
        # of do over the q rows) is held to the bar as everywhere
        held = ("dv",) if s == 1 else ("dq", "dk", "dv")
        ok = all(results[n][0] for n in held)
        margins[label] = {n: results[n][2] for n in held}
        log(f"[kernels] K2 {label}: " + ", ".join(
            f"max|d {n}| {r[1]:.3e} "
            + (f"({r[2]:.3f} of the bar)" if n in held else "(not held)")
            for n, r in results.items())
            + f" ({tol}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K2 disagrees with its plain version at {label}")
        if label.startswith(("train", "DP rank")):
            (errs if label.startswith("train") else errs_dp).update(
                dq=results["dq"][1],
                dkv=max(results["dk"][1], results["dv"][1]))
        del q, k, v, do, lse, delta, dq, dk, dv, p_dq, p_dk, p_dv

    # time at the training shape; the inputs (4 x 25 MB) exceed the L2
    b = TRAIN_BATCH
    q, k, v, do, lse, delta = inputs(b, SERVE_SEQ, True, torch.bfloat16)
    t = {}
    t["dq_ms"] = cuda_time_ms(lambda: fa.flash_attention_bwd_dq_cuda(
        q, k, v, do, lse, delta), iters=10)
    t["dkv_ms"] = cuda_time_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
        q, k, v, do, lse, delta), iters=10)
    t["dq_plain_ms"] = cuda_time_ms(lambda: fa.flash_attention_bwd_dq_plain(
        q, k, v, do, lse, delta), iters=3, warmup=1)
    t["dkv_plain_ms"] = cuda_time_ms(
        lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta),
        iters=3, warmup=1)
    # yardstick: sdpa's backward (dq, dk, dv in one call), its forward
    # outside the timed region
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    t["library_ms"] = cuda_time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters=10)
    args = (b, SERVE_SEQ, SERVE_HEADS, SERVE_HEAD_DIM, True, 2)
    dq_work = dict(products=3, tensors_in=4, tensors_out=1, rows_f32=2)
    dkv_work = dict(products=4, tensors_in=4, tensors_out=2, rows_f32=2)
    t["dq_bound"] = attention_bound_ms(*args, **dq_work)
    t["dkv_bound"] = attention_bound_ms(*args, **dkv_work)
    t["dq_tflops"] = tflops(*args, t["dq_ms"], **dq_work)
    t["dkv_tflops"] = tflops(*args, t["dkv_ms"], **dkv_work)
    whole, _ = attention_bound_ms(*args, products=5, tensors_in=5,
                                  tensors_out=3, rows_f32=1)
    log(f"[kernels] K2 time b={b} S={SERVE_SEQ} H={SERVE_HEADS} "
        f"D={SERVE_HEAD_DIM} bf16 causal: K2a (dq) {t['dq_ms']:.4f} ms "
        f"({t['dq_tflops']:.1f} TFLOP/s; plain {t['dq_plain_ms']:.4f}, "
        f"bound {t['dq_bound'][0]:.4f} ms {t['dq_bound'][1]}, "
        f"{t['dq_bound'][0] / t['dq_ms']:.2%} of it); K2b (dk, dv) "
        f"{t['dkv_ms']:.4f} ms ({t['dkv_tflops']:.1f} TFLOP/s; plain "
        f"{t['dkv_plain_ms']:.4f}, bound {t['dkv_bound'][0]:.4f} ms "
        f"{t['dkv_bound'][1]}, {t['dkv_bound'][0] / t['dkv_ms']:.2%} of "
        f"it); K2a+K2b {t['dq_ms'] + t['dkv_ms']:.4f} ms "
        f"({tflops(*args, t['dq_ms'] + t['dkv_ms'], products=5):.1f} "
        f"TFLOP/s) against the whole backward's bound {whole:.4f} ms; sdpa "
        f"backward {t['library_ms']:.4f} ms (dq, dk and dv: "
        f"{tflops(*args, t['library_ms'], products=5):.1f} TFLOP/s)")
    del q, k, v, do, lse, delta, qt, kt, vt, out, dot
    torch.cuda.empty_cache()
    return {"err": errs, "err_dp": errs_dp, "timings": t,
            "margins": margins}


# K1, K2a and K2b at head dims the tensor-core kernels do not take, which
# their FMA kernels take: (label, b, s, h, d, causal, dtype)
HEAD_DIM_CASES = [
    ("f32 D=256 causal", 2, 300, 3, 256, True, torch.float32),
    ("f32 D=256", 1, 129, 2, 256, False, torch.float32),
    ("bf16 D=256 causal", 2, 300, 3, 256, True, torch.bfloat16),
    ("bf16 D=256", 1, 129, 2, 256, False, torch.bfloat16),
    ("bf16 D=36 causal", 2, 100, 3, 36, True, torch.bfloat16),
    ("bf16 D=36", 1, 77, 2, 36, False, torch.bfloat16),
    ("bf16 D=200 causal", 1, 65, 2, 200, True, torch.bfloat16),
    ("f32 D=512 causal", 1, 130, 2, 512, True, torch.float32),
    ("bf16 D=512", 1, 100, 2, 512, False, torch.bfloat16),
    ("bf16 D=320 causal", 2, 65, 2, 320, True, torch.bfloat16),
    # one element in: the 16-byte copies cannot read it, the FMA kernels can
    ("bf16 D=64 misaligned causal", 2, 129, 3, 64, True, torch.bfloat16),
]
HEAD_DIM_TIMED = 256


def phase_head_dims(fa) -> dict:
    """K1, K2a and K2b on the FMA kernels at the head dims the tensor-core
    kernels do not take (HEAD_DIM_CASES), each against its plain version
    under phase_kernels' and phase_k2's bars; then timed at [8, 2048, 12,
    256] bf16 causal beside sdpa's forward and backward (timed here
    only)."""
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(5)
    margins = {}
    counts = (fa.flash_attention, fa.flash_attention_bwd_dq,
              fa.flash_attention_bwd_dkv)
    for label, b, s, h, d, causal, dtype in HEAD_DIM_CASES:
        misaligned = "misaligned" in label
        n = b * s * h * d
        q, k, v, do = (torch.randn((n + 1,), generator=gen, device=dev).to(
            dtype)[int(misaligned):][:n].view(b, s, h, d) for _ in range(4))
        want = "fma_unaligned" if misaligned else "fma"
        if fa.kernel_route(q, k, v, do) != want:
            fail(f"head dims {label}: routed to "
                 f"{fa.kernel_route(q, k, v, do)}, not {want}")
        unaligned = [c.unaligned_launches for c in counts]
        o, lse = fa.flash_attention_fwd_cuda(q, k, v, causal=causal)
        p_o, p_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
        delta = fa.attention_delta(p_o, do)
        dq = fa.flash_attention_bwd_dq_cuda(q, k, v, do, p_lse, delta,
                                            causal=causal)
        dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, do, p_lse, delta,
                                                 causal=causal)
        torch.cuda.synchronize()
        if [c.unaligned_launches - u for c, u in zip(counts, unaligned)] != \
                [int(misaligned)] * 3:
            fail(f"head dims {label}: unaligned-route counts "
                 f"{[c.unaligned_launches for c in counts]} from {unaligned}")
        d_o = (o.float() - p_o.float()).abs()
        if dtype == torch.bfloat16:
            o_share = (d_o / (BF16_ATOL + BF16_RTOL * p_o.float().abs())
                       ).max().item()
        else:
            o_share = d_o.max().item() / F32_ATOL
        lse_share = (lse - p_lse).abs().max().item() / LSE_ATOL
        p_dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, p_lse, delta,
                                               causal=causal)
        p_dk, p_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, p_lse,
                                                      delta, causal=causal)
        grads = [_k2_close(g, r, dtype) for g, r in
                 ((dq, p_dq), (dk, p_dk), (dv, p_dv))]
        share = max([o_share, lse_share] + [g[2] for g in grads])
        ok = o_share <= 1 and lse_share <= 1 and all(g[0] for g in grads)
        margins[label] = share
        log(f"[kernels] K1/K2 head dims {label} [{b}, {s}, {h}, {d}]: o "
            f"{o_share:.3f}, lse {lse_share:.3f}, dq {grads[0][2]:.3f}, dk "
            f"{grads[1][2]:.3f}, dv {grads[2][2]:.3f} of their bars "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"the FMA flash kernels disagree with their plain versions "
                 f"at {label}")
    b, s, h, d = TRAIN_BATCH, SERVE_SEQ, SERVE_HEADS, HEAD_DIM_TIMED
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, causal=True)
    delta = fa.attention_delta(o, do)
    t = {"fwd_ms": cuda_time_ms(lambda: fa.flash_attention_fwd_cuda(
        q, k, v, causal=True), iters=3, warmup=1)}
    t["dq_ms"] = cuda_time_ms(lambda: fa.flash_attention_bwd_dq_cuda(
        q, k, v, do, lse, delta), iters=3, warmup=1)
    t["dkv_ms"] = cuda_time_ms(lambda: fa.flash_attention_bwd_dkv_cuda(
        q, k, v, do, lse, delta), iters=3, warmup=1)
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v))
    t["sdpa_fwd_ms"] = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), iters=5)
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    t["sdpa_bwd_ms"] = cuda_time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), iters=5)
    shape = (b, s, h, d, True, 2)
    t["fwd_bound"] = attention_bound_ms(*shape)
    t["bwd_bound"] = attention_bound_ms(*shape, products=5, tensors_in=5,
                                        tensors_out=3, rows_f32=1)
    log(f"[kernels] K1/K2 FMA time [{b}, {s}, {h}, {d}] bf16 causal: K1 "
        f"{t['fwd_ms']:.4f} ms ({tflops(*shape, t['fwd_ms']):.1f} TFLOP/s; "
        f"bound {t['fwd_bound'][0]:.4f} ms {t['fwd_bound'][1]}), sdpa "
        f"{t['sdpa_fwd_ms']:.4f} ms; K2a {t['dq_ms']:.4f} + K2b "
        f"{t['dkv_ms']:.4f} ms (bound of the whole backward "
        f"{t['bwd_bound'][0]:.4f} ms), sdpa backward "
        f"{t['sdpa_bwd_ms']:.4f} ms")
    del q, k, v, do, o, lse, delta, qt, kt, vt, out
    torch.cuda.empty_cache()
    return {"margins": margins, "timings": t}


def _k3_err(opt, kernel, plain) -> float:
    """max|d| over p, m and v between the kernel's params (with the
    optimizer's state) and the plain version's (p, m, v) triples."""
    err = 0.0
    for p, (q, m, v) in zip(kernel, plain):
        st = opt.state[p]
        for a, b in ((p, q), (st["mu"], m), (st["nu"], v)):
            err = max(err, (a - b).abs().max().item())
    return err


def phase_k3(fo, recipe, lm_shapes, timed: bool = True,
             label: str = "") -> dict:
    """K3 over the LM's parameter tensors for 3 steps, one launch each,
    against the plain version updating its own copies with the same
    gradients: the clip on both branches (global norm ~1.2e4, then ~0.12,
    then ~1.2e4 against max_norm 1.0), and the second step with one tensor
    that has no gradient. Then a table of ragged lengths (1, 5, 1,000,003,
    and 1,000,003 read through a pointer 4 bytes past 16-byte alignment).
    Times one step against its bound and Adam(fused=True), and the whole
    update (global norm, clip and K3, as the train step runs it) against
    clip_grad_norm_(foreach=True) + Adam(fused=True). ``timed`` False
    runs the 3 steps alone (phase 8's table of one rank's shards)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)
    shapes = list(lm_shapes.values())
    lr, wd, max_norm = 1e-3, 1e-4, 1.0
    kernel_p = [torch.randn(sh, generator=gen, device=dev) for sh in shapes]
    plain = [(p.clone(), torch.zeros_like(p), torch.zeros_like(p))
             for p in kernel_p]
    opt = fo.FusedAdam(recipe.decay_groups(kernel_p, wd), lr=lr)
    wds = [float(np.float32(wd)) if p.dim() > 1 else 0.0 for p in kernel_p]
    skipped = len(shapes) - 1          # a bias: no gradient at step 2
    norms = []
    for count, scale in enumerate((1.0, 1e-5, 1.0)):
        grads = [scale * torch.randn(sh, generator=gen, device=dev)
                 for sh in shapes]
        if count == 1:
            grads[skipped] = None
        for p, g in zip(kernel_p, grads):
            p.grad = g
        live = [i for i, g in enumerate(grads) if g is not None]
        norm = recipe.global_norm([grads[i] for i in live])
        before = fo.fused_adam.launches
        opt.step(norm=norm, max_norm=max_norm)
        if fo.fused_adam.launches != before + 1:
            fail(f"K3 launched {fo.fused_adam.launches - before} times for "
                 f"one step over {len(live)} tensors")
        bc1, bc2 = fo.bias_corrections(opt.b1, opt.b2, count)
        for i in live:
            q, m, v = plain[i]
            fo.fused_adam_plain(q, grads[i], m, v, lr=opt.current_lr(),
                                wd=wds[i], bc1=bc1, bc2=bc2, b1=opt.b1,
                                b2=opt.b2, eps=opt.eps, norm=norm,
                                max_norm=max_norm)
        norms.append(norm.item())
    torch.cuda.synchronize()
    err = _k3_err(opt, kernel_p, plain)
    n = sum(p.numel() for p in kernel_p)
    ok = err <= K3_ATOL
    log(f"[kernels] K3{label} {len(shapes)} tensors ({n} elements) x 3 "
        f"steps, one "
        f"launch each, wd {wd} on rank > 1, clip at {max_norm} with global "
        f"norms {', '.join(f'{x:.4g}' for x in norms)}, step 2 without the "
        f"gradient of tensor {skipped}: max|d| over p, m, v {err:.3e} (<= "
        f"{K3_ATOL}, {err / K3_ATOL:.3f} of the bar) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"K3{label} disagrees with its plain version")
    if not timed:
        return {"err": err, "elements": n}

    # ragged lengths, one tensor unaligned (4-byte accesses), both branches
    buf = torch.randn(1_000_003 + 1, generator=gen, device=dev)
    ragged = [torch.randn(k, generator=gen, device=dev)
              for k in (1, 5, 1_000_003)] + [buf[1:]]
    r_opt = fo.FusedAdam([{"params": ragged, "weight_decay": wd}], lr=lr)
    r_plain = [(p.clone(), torch.zeros_like(p), torch.zeros_like(p))
               for p in ragged]
    for count, scale in enumerate((1e-5, 1.0)):
        grads = [scale * torch.randn(p.shape, generator=gen, device=dev)
                 for p in ragged]
        for p, g in zip(ragged, grads):
            p.grad = g
        norm = recipe.global_norm(grads)
        r_opt.step(norm=norm, max_norm=max_norm)
        bc1, bc2 = fo.bias_corrections(r_opt.b1, r_opt.b2, count)
        for (q, m, v), g in zip(r_plain, grads):
            fo.fused_adam_plain(q, g, m, v, lr=lr, wd=float(np.float32(wd)),
                                bc1=bc1, bc2=bc2, b1=r_opt.b1, b2=r_opt.b2,
                                eps=r_opt.eps, norm=norm, max_norm=max_norm)
    torch.cuda.synchronize()
    r_err = _k3_err(r_opt, ragged, r_plain)
    log(f"[kernels] K3 ragged lengths 1, 5, 1000003 and 1000003 unaligned, "
        f"2 steps (clip off, on): max|d| {r_err:.3e} (<= {K3_ATOL}) "
        f"{'ok' if r_err <= K3_ATOL else 'MISMATCH'}")
    if not r_err <= K3_ATOL:
        fail("K3 disagrees with its plain version at ragged lengths")
    del ragged, r_plain, r_opt, buf

    # times: every tensor has a gradient, the clip branch taken
    for p in kernel_p:
        if p.grad is None:
            p.grad = torch.randn(p.shape, generator=gen, device=dev)
    grads = [p.grad for p in kernel_p]
    norm = recipe.global_norm(grads)
    ms = cuda_time_ms(lambda: opt.step(norm=norm, max_norm=max_norm),
                      iters=10)
    # the same step replayed from a CUDA graph: the launch without the
    # host's table building, so the device time alone
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        opt.step(norm=norm, max_norm=max_norm)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        opt.step(norm=norm, max_norm=max_norm)
    device_ms = cuda_time_ms(graph.replay, iters=10)
    plain_p = [q for q, _, _ in plain]
    plain_ms = cuda_time_ms(lambda: [
        fo.fused_adam_plain(q, g, m, v, lr=lr, wd=w, bc1=0.1, bc2=0.001,
                            b1=0.9, b2=0.999, eps=1e-8, norm=norm,
                            max_norm=max_norm)
        for (q, m, v), g, w in zip(plain, grads, wds)], iters=3, warmup=1)
    for q, g in zip(plain_p, grads):
        q.grad = g.clone()
    library = torch.optim.Adam(recipe.decay_groups(plain_p, wd), lr=lr,
                               fused=True)
    library_ms = cuda_time_ms(library.step, iters=10)

    def update():               # as the train step runs it
        g = [p.grad for p in kernel_p if p.grad is not None]
        opt.step(norm=recipe.global_norm(g), max_norm=max_norm)

    def yardstick():
        torch.nn.utils.clip_grad_norm_(plain_p, max_norm, foreach=True)
        library.step()

    update_ms = cuda_time_ms(update, iters=10)
    yardstick_ms = cuda_time_ms(yardstick, iters=10)
    # read p, g, m, v once and write p, m, v once, in f32; ~17 FLOPs each
    bound = bound_ms(17 * n, 28 * n, PEAK_F32_FLOPS)
    log(f"[kernels] K3 time, one step over {len(shapes)} tensors: kernel "
        f"{ms:.4f} ms (1 launch, clip on; replayed from a CUDA graph "
        f"{device_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"torch.optim.Adam(fused=True) {library_ms:.4f} ms (no clip), bound "
        f"{bound[0]:.4f} ms ({bound[1]}: {28 * n / 1e9:.2f} GB), kernel at "
        f"{bound[0] / ms:.2%} of bound; the whole update (global norm, "
        f"clip, K3) {update_ms:.4f} ms against clip_grad_norm_(foreach=True)"
        f" + Adam(fused=True) {yardstick_ms:.4f} ms")
    del kernel_p, plain, plain_p, opt, library, grads, graph
    torch.cuda.empty_cache()
    return {"err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound": bound, "elements": n,
            "update_ms": update_ms, "yardstick_ms": yardstick_ms}


def _block_weights(gen, cin, cmid, cout, proj):
    """Random block weights as tests/test_ops.py makes them (N(0, 0.1),
    BN scales near 1), on the card: the model's zero init of BatchNorm_2
    would make the block relu(residual) and hide conv1 to conv3."""
    dev = torch.device(DEVICE)

    def arr(*s):
        return 0.1 * torch.randn(s, generator=gen, device=dev)

    w = (arr(cin, cmid), arr(cmid) + 1, arr(cmid), arr(3, 3, cmid, cmid),
         arr(cmid) + 1, arr(cmid), arr(cmid, cout), arr(cout) + 1, arr(cout))
    if proj:
        w += (arr(cin, cout), arr(cout) + 1, arr(cout))
    return w


def _block_flops(m, cin, cmid, cout, proj) -> int:
    """2 x samples x (the block's four products): one forward."""
    return 2 * m * (cin * cmid + 9 * cmid * cmid + cmid * cout
                    + (cin * cout if proj else 0))


def _yardstick_block(x, w, eps=1e-5):
    """The same block through cuDNN convs and exact batch BN
    (F.batch_norm over the whole batch): not the same function, a
    yardstick of what one library call a layer costs."""
    F = torch.nn.functional
    xc = x.permute(0, 3, 1, 2)                   # channels_last NCHW view

    def conv_bn(h, k, g, b, pad=0, relu=True):
        y = F.conv2d(h, k.to(h.dtype).permute(3, 2, 0, 1), padding=pad)
        y = F.batch_norm(y, None, None, g, b, training=True, eps=eps)
        return F.relu(y) if relu else y

    y = conv_bn(xc, w[0][None, None], w[1], w[2])
    y = conv_bn(y, w[3], w[4], w[5], pad=1)
    y = conv_bn(y, w[6][None, None], w[7], w[8], relu=False)
    r = conv_bn(xc, w[9][None, None], w[10], w[11], relu=False) \
        if len(w) == 12 else xc
    return F.relu(y + r).permute(0, 2, 3, 1)


def _grad_agree(got, ref) -> tuple[bool, float, float, float]:
    """(ok, max|d|, ||d|| / ||ref||, share of elements beyond 2^-5
    max|ref|) against the K4/K5 gradient bars above."""
    d = (got.float() - ref.float()).abs()
    r = ref.float()
    norm = (d.norm() / r.norm().clamp_min(1e-30)).item()
    share = (d > K45_GRAD_FRAC * r.abs().max()).float().mean().item()
    ok = norm <= K45_GRAD_FRAC and share <= K45_GRAD_OUTLIERS and \
        bool(torch.isfinite(got.float()).all())
    return ok, d.max().item(), norm, share


def _ghost_err(got, ref, proj, ghosts, cmid, cout) -> float:
    """The largest share of the statistics bar (|d| <= 1e-3 max|ref| +
    1e-5 per BatchNorm's per-ghost mean or rsqrt) that the forward's saved
    statistics use against their plain version; mp and rsp are not
    written without a projection."""
    sizes = [ghosts * cmid] * 4 + [ghosts * cout] * 4
    share = 0.0
    for i, (a, b) in enumerate(zip(got.split(sizes), ref.split(sizes))):
        if i >= 6 and not proj:
            continue
        bar = 1e-3 * b.abs().max().item() + 1e-5
        share = max(share, (a - b).abs().max().item() / bar)
    return share


def fwd_workspace_bytes(fbt, n, h, cin, cmid, cout, bt, th, proj) -> int:
    """Bytes of device scratch one K4/K5 forward call takes."""
    a = fbt.BlockArgs(N=n, H=h, W=h, Cin=cin, Cmid=cmid, Cout=cout, bt=bt,
                      th=th, hal=int(h // th > 1), proj=int(proj), eps=1e-5)
    return int(fbt._library().kftpu_block_train_workspace(ctypes.byref(a),
                                                           0))


def phase_k45(fbt, fbts, R, batch: int = RESNET_BATCH,
              timed: bool = True) -> dict:
    """K4 and K5 at the five stride-1 geometries of ResNet-50 at 224 px,
    batch 64 (or ``batch``), bf16, each with the JAX package's (tile_bt,
    tile_h) at batch 64: forward
    (out and the 8 statistics) against the plain version, backward (dx and
    every weight gradient) against torch.autograd.grad of the plain
    version, K5's seam rows of dx also against the backward's own formula
    (backward_plain); times beside the bound, the plain version and the
    cuDNN + batch-BN yardstick (``timed`` False: the checks alone)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4)
    results = []
    for geo in R.stride1_geometries(50, IMAGE):
        key, h = geo["key"], geo["h"]
        cin, cmid, cout, proj = geo["cin"], geo["cmid"], geo["cout"], \
            geo["proj"]
        kind, th = R._fused_route(h, h, cin, cmid, cout)
        bt = fbt.default_tile_bt(batch, h, h, cin, cmid, cout) \
            if kind == "batch" else 1
        if (kind, bt, th) != EXPECTED_TILES[key]:
            fail(f"{key}: route {(kind, bt, th)}, the JAX package's is "
                 f"{EXPECTED_TILES[key]}")
        spatial = kind == "spatial"
        mod = fbts if spatial else fbt
        name = "fused_block_train_spatial" if spatial else \
            "fused_block_train"
        fwd_k = getattr(mod, f"{name}_fwd")
        bwd_k = getattr(mod, f"{name}_bwd")
        tiles = (bt, th) if spatial else (bt,)

        def ref_fwd(x, w):
            if spatial:
                return fbts.reference_bottleneck_train_spatial(
                    x, w, tile_bt=bt, tile_h=th)
            return fbt.reference_bottleneck_train(x, w, tile_bt=bt)

        def ref_bwd(x, g, w):
            return fbt.autograd_backward(
                fbts.reference_bottleneck_train_spatial if spatial else
                fbt.reference_bottleneck_train, x, g, w,
                **({"tile_bt": bt, "tile_h": th} if spatial else
                   {"tile_bt": bt}))

        w = _block_weights(gen, cin, cmid, cout, proj)
        x = torch.randn((batch, h, h, cin), generator=gen,
                        device=dev).to(torch.bfloat16)
        g = torch.randn((batch, h, h, cout), generator=gen,
                        device=dev).to(torch.bfloat16)
        out, stats, ghost = fwd_k(x, w, *tiles)
        dx, grads = bwd_k(x, g, w, *tiles, ghost=ghost)
        # a second call gives the same bits (fixed-order reductions)
        r_dx, r_grads = bwd_k(x, g, w, *tiles, ghost=ghost)
        torch.cuda.synchronize()
        same_bits = torch.equal(dx, r_dx) and all(
            torch.equal(a, b) for a, b in zip(grads, r_grads))
        del r_dx, r_grads
        p_out, p_stats = ref_fwd(x, w)
        p_dx, p_grads = ref_bwd(x, g, w)
        d_out = (out.float() - p_out.float()).abs()
        out_share = (d_out > K45_OUT_TOL * (p_out.float().abs() + 1)) \
            .float().mean().item()
        ok_out = out_share <= K45_OUT_OUTLIERS and \
            torch.isfinite(out.float()).all().item()
        stat_err = stat_share = 0.0
        for a, b in zip(stats, p_stats):
            e = (a - b).abs().max().item()
            stat_err = max(stat_err, e)
            stat_share = max(stat_share, e / (K45_STAT_TOL *
                                              b.abs().max().item() + 1e-5))
        ok_stats = stat_share <= 1.0
        ghost_err = _ghost_err(ghost, fbts.ghost_stats_plain(
            x, w, tile_bt=bt, tile_h=th or h), proj,
            (batch // bt) * (h // (th or h)), cmid, cout)
        dx_ok, dx_err, dx_norm, dx_share = _grad_agree(dx, p_dx)
        grad_errs = [_grad_agree(a, b) for a, b in zip(grads, p_grads)]
        seam_err, seam_note = 0.0, ""
        if spatial:
            f_dx, _ = fbts.backward_plain(x, g, w, tile_bt=bt, tile_h=th)
            seams = [r for s in range(1, h // th) for r in
                     (s * th - 1, s * th)]
            seam_err = _grad_agree(dx[:, seams], f_dx[:, seams])[2]
            seam_note = (f"; seam rows of dx against backward_plain "
                         f"||d||/||ref|| {seam_err:.2e} (<= 2^-6)")
            del f_dx
        ok = ok_out and ok_stats and dx_ok and seam_err <= K45_SEAM_TOL \
            and all(e[0] for e in grad_errs) and same_bits and \
            ghost_err <= 1.0
        # the largest share of a bar that this geometry uses, and which
        shares = {
            "out": out_share / K45_OUT_OUTLIERS, "stats": stat_share,
            "saved stats": ghost_err, "dx norm": dx_norm / K45_GRAD_FRAC,
            "dx share": dx_share / K45_GRAD_OUTLIERS,
            "grad norm": max(e[2] for e in grad_errs) / K45_GRAD_FRAC,
            "grad share": max(e[3] for e in grad_errs) / K45_GRAD_OUTLIERS,
            "seam": seam_err / K45_SEAM_TOL,
            "bits": 0.0 if same_bits else float("inf")}
        worst = max(shares, key=shares.get)
        log(f"[k45] {name} {key} batch {batch} (tile_bt {bt}, tile_h "
            f"{th or h}, proj {proj}): out max|d| "
            f"{d_out.max().item():.3e}, share beyond "
            f"2^-6 (|ref| + 1) {out_share:.2e} (<= {K45_OUT_OUTLIERS}); "
            f"stats max|d| {stat_err:.3e} (<= 1e-3 max|ref| + 1e-5); saved "
            f"per-ghost statistics {ghost_err:.3f} of that bar; backward "
            f"from them {'gives' if same_bits else 'DOES NOT GIVE'} the "
            f"same bits twice; dx "
            f"max|d| {dx_err:.3e} of max|ref| "
            f"{p_dx.float().abs().max().item():.3e}, ||d||/||ref|| "
            f"{dx_norm:.2e}, share beyond 2^-5 max|ref| {dx_share:.2e}; "
            f"weight grads ||d||/||ref|| " + ", ".join(
                f"{e[2]:.2e}" for e in grad_errs) + ", shares " + ", ".join(
                f"{e[3]:.1e}" for e in grad_errs)
            + f" (norm <= 2^-5, share <= {K45_GRAD_OUTLIERS}){seam_note}; "
            f"largest share of a bar {shares[worst]:.3f} ({worst}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{name} disagrees with its plain version at {key}")
        del out, stats, dx, grads, p_out, p_stats, p_dx, p_grads
        if not timed:
            results.append({"key": key, "name": name,
                            "out_err": d_out.max().item(), "dx_err": dx_err})
            del x, g, w, ghost
            torch.cuda.empty_cache()
            continue

        t = {"key": key, "name": name, "count": geo["count"],
             "tile_bt": bt, "tile_h": th or h, "proj": proj,
             "out_err": d_out.max().item(), "dx_err": dx_err,
             "fwd_workspace_bytes": fwd_workspace_bytes(
                 fbt, batch, h, cin, cmid, cout, bt, th or h, proj)}
        t["fwd_ms"] = cuda_time_ms(lambda: fwd_k(x, w, *tiles), iters=5,
                                   warmup=1)
        # the backward as the training step runs it: from the forward's
        # saved statistics
        t["bwd_ms"] = cuda_time_ms(
            lambda: bwd_k(x, g, w, *tiles, ghost=ghost), iters=5, warmup=1)
        t["fwd_plain_ms"] = cuda_time_ms(lambda: ref_fwd(x, w), iters=2,
                                         warmup=1)
        t["bwd_plain_ms"] = cuda_time_ms(lambda: ref_bwd(x, g, w), iters=2,
                                         warmup=1)
        xs = x.detach().requires_grad_(True)
        ws = [wi.detach().requires_grad_(True) for wi in w]
        t["fwd_yardstick_ms"] = cuda_time_ms(
            lambda: _yardstick_block(x, w), iters=5, warmup=1)
        y_out = _yardstick_block(xs, ws)
        t["bwd_yardstick_ms"] = cuda_time_ms(lambda: torch.autograd.grad(
            y_out, [xs, *ws], g, retain_graph=True), iters=5, warmup=1)
        m = batch * h * h
        flops = _block_flops(m, cin, cmid, cout, proj)
        wbytes = 2 * (cin * cmid + 9 * cmid * cmid + cmid * cout
                      + (cin * cout if proj else 0))
        # forward: x and the weights read once, out written once; backward
        # (the forward recomputed, then the dgrad and wgrad products): x,
        # g and the weights read once, dx and the f32 weight grads written
        t["fwd_bound"] = bound_ms(flops, 2 * m * (cin + cout) + wbytes,
                                  PEAK_BF16_FLOPS)
        t["bwd_bound"] = bound_ms(3 * flops, 2 * m * (2 * cin + cout)
                                  + 3 * wbytes, PEAK_BF16_FLOPS)
        log(f"[k45] {name} {key} x {geo['count']} a step: forward kernel "
            f"{t['fwd_ms']:.4f} ms (bound {t['fwd_bound'][0]:.4f} ms "
            f"{t['fwd_bound'][1]}, plain {t['fwd_plain_ms']:.4f} ms, "
            f"yardstick cuDNN + batch BN {t['fwd_yardstick_ms']:.4f} ms); "
            f"backward kernel {t['bwd_ms']:.4f} ms (bound "
            f"{t['bwd_bound'][0]:.4f} ms {t['bwd_bound'][1]}, plain "
            f"{t['bwd_plain_ms']:.4f} ms, yardstick "
            f"{t['bwd_yardstick_ms']:.4f} ms); forward workspace "
            f"{t['fwd_workspace_bytes'] / 2 ** 20:.1f} MiB")
        results.append(t)
        del x, g, w, xs, ws, y_out, ghost
        torch.cuda.empty_cache()
    return {"geoms": results}


def nontrivial_variables(model, seed: int) -> dict:
    """Seeded ResNet variables on the CPU whose every BatchNorm acts: the
    model's own kernel init, then BN scales 1 + N(0, 0.1), BN shifts,
    running means and the head bias N(0, 0.1), running variances U(0.5,
    1.5). At init the last BN of every block has scale 0, which would hide
    conv3 and w3 from any check."""
    gen = torch.Generator().manual_seed(seed)
    params, variables = model.init(gen)
    stats = variables["batch_stats"]
    for name, p in params.items():
        if name.endswith(".scale"):
            params[name] = 1 + 0.1 * torch.randn(p.shape, generator=gen)
        elif name.endswith(".bias"):
            params[name] = 0.1 * torch.randn(p.shape, generator=gen)
    for name, v in stats.items():
        stats[name] = 0.1 * torch.randn(v.shape, generator=gen) \
            if name.endswith(".mean") else \
            0.5 + torch.rand(v.shape, generator=gen)
    return {"params": params, "batch_stats": stats}


def _on_device(tree: dict) -> dict:
    return {k: v.to(DEVICE) for k, v in tree.items()}


def hgmma_counts(build, name: str) -> dict:
    """{kernel: HGMMA instructions} of the warpgroup-product kernels
    (wgmma_gemm.cuh's wg_gemm_kernel instances) in csrc/<name>.cu's build,
    from cuobjdump's SASS."""
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build.library_path(name)],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass on {name}: {sass.stderr.strip()}")
    counts, fn = {}, None
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return {f: n for f, n in counts.items() if "wg_gemm_kernel" in f}


def phase_k6(fb, R) -> dict:
    """K6 at the five stride-1 geometries of ResNet-50 at 224 px, batch 64,
    bf16, on the folded weights of the first block of each geometry in the
    seeded model: against its plain version, timed beside the bound, the
    plain version and the same block through cuDNN (_xla_block_eval at
    stride 1). First, every warpgroup-product kernel of K6's and K4/K5's
    builds must issue `wgmma` (HGMMA in its SASS)."""
    build = importlib.import_module("kubeflow_tpu_torch.ops._build")
    hgmma = {}
    for lib in ("fused_block", "fused_block_train"):
        c = hgmma_counts(build, lib)
        if not c or min(c.values()) == 0:
            fail(f"{lib}: warpgroup-product kernels without HGMMA: {c}")
        hgmma[lib] = {"kernels": len(c), "min": min(c.values()),
                      "max": max(c.values()), "total": sum(c.values())}
        log(f"[k6] csrc/{lib}.cu: {len(c)} warpgroup-product kernels, "
            f"{min(c.values())} to {max(c.values())} HGMMA instructions "
            f"each ({sum(c.values())} in all)")
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(6)
    v = nontrivial_variables(R.resnet50(num_classes=CLASSES), seed=7)
    walk = list(R._block_walk(50, IMAGE))
    results = []
    for geo in R.stride1_geometries(50, IMAGE):
        key, h = geo["key"], geo["h"]
        cin, cmid, cout, proj = geo["cin"], geo["cmid"], geo["cout"], \
            geo["proj"]
        block = next(b["name"] for b in walk if b["strides"] == 1 and
                     R.geometry_key(b["h"], b["h"], b["cin"], b["cmid"],
                                    b["cout"]) == key)
        bp = _on_device(R._block_params(v["params"], block))
        bs = _on_device(R._block_params(v["batch_stats"], block))
        w = fb.fold_block(bp, bs)
        x = torch.randn((RESNET_BATCH, h, h, cin), generator=gen,
                        device=dev).to(torch.bfloat16)
        out = fb.fused_bottleneck_eval(x, w)
        torch.cuda.synchronize()
        ref = fb.fused_bottleneck_eval_plain(x, w)
        lib = R._xla_block_eval(x, bp, bs, 1)
        d = (out.float() - ref.float()).abs()
        share = (d > K6_TOL * (ref.float().abs() + 1)).float().mean().item()
        differ = (d > 0).float().mean().item()
        lib_err = (lib.float() - ref.float()).abs().max().item()
        ok = share <= K6_OUTLIERS and differ <= K6_DIFFER and \
            torch.isfinite(out.float()).all().item()
        log(f"[k6] fused_block_eval {key} ({block}, proj {proj}): out "
            f"max|d| {d.max().item():.3e} of max|ref| "
            f"{ref.float().abs().max().item():.3e}, share beyond 2^-6 (|ref|"
            f" + 1) {share:.2e} (<= {K6_OUTLIERS}), share that differs "
            f"{differ:.2e} (<= {K6_DIFFER}); the cuDNN block against the "
            f"plain version max|d| {lib_err:.3e} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"fused_block_eval disagrees with its plain version at "
                 f"{key}")
        t = {"key": key, "block": block, "count": geo["count"],
             "proj": proj, "err": d.max().item(), "share": share,
             "differ": differ}
        t["ms"] = cuda_time_ms(lambda: fb.fused_bottleneck_eval(x, w),
                               iters=10, warmup=2)
        t["plain_ms"] = cuda_time_ms(
            lambda: fb.fused_bottleneck_eval_plain(x, w), iters=3, warmup=1)
        t["library_ms"] = cuda_time_ms(
            lambda: R._xla_block_eval(x, bp, bs, 1), iters=10, warmup=2)
        m = RESNET_BATCH * h * h
        wbytes = 2 * (cin * cmid + 9 * cmid * cmid + cmid * cout
                      + (cin * cout if proj else 0)) \
            + 4 * 2 * (2 * cmid + cout + (cout if proj else 0))
        # x and the weights read once, out written once
        t["bound"] = bound_ms(_block_flops(m, cin, cmid, cout, proj),
                              2 * m * (cin + cout) + wbytes,
                              PEAK_BF16_FLOPS)
        log(f"[k6] fused_block_eval {key} x {geo['count']} a forward: kernel "
            f"{t['ms']:.4f} ms (bound {t['bound'][0]:.4f} ms "
            f"{t['bound'][1]}, {t['bound'][0] / t['ms']:.1%}; plain "
            f"{t['plain_ms']:.4f} ms; cuDNN convs + folded affines "
            f"{t['library_ms']:.4f} ms)")
        results.append(t)
        del x, out, ref, lib
        torch.cuda.empty_cache()
    return {"geoms": results, "hgmma": hgmma}


# -- phase 3 ----------------------------------------------------------------


def phase_serving(fa, server, repo, k1_timings) -> dict:
    flash = repo.get("lm")
    einsum = repo.get("lm_einsum")
    batcher = server.batcher("lm")       # the server's own MicroBatcher
    rng = np.random.default_rng(1)
    rows = [1, 3, 2, 1, 3, 2]
    requests = [rng.integers(0, SERVE_VOCAB, (n, SERVE_SEQ)).astype(np.int32)
                for n in rows]
    results, host_s, errors = {}, {}, []

    def send(i):
        t0 = time.perf_counter()
        try:
            results[i] = batcher.predict(requests[i], timeout=300.0)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"request {i}: {type(e).__name__}: {e}")
        host_s[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(requests))]
    torch.cuda.reset_peak_memory_stats()
    forwards0 = flash.metadata()["stats"]["request_count"]
    fa.flash_attention.launches = 0      # the main path's count starts
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention.launches   # ... and is read here
    forwards = flash.metadata()["stats"]["request_count"] - forwards0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if errors or any(t.is_alive() for t in threads):
        fail(f"serving requests failed: {errors}")
    log(f"[serving] {len(requests)} requests ({sum(rows)} rows) in "
        f"{forwards} forwards, wall {wall:.3f}s; K1 launches {launches}; "
        f"peak device memory {peak_gib:.2f} GiB")
    for i in range(len(requests)):
        log(f"[serving] request {i}: {rows[i]} rows, host "
            f"{host_s[i] * 1e3:.1f} ms (ends in synchronize)")
    if forwards < 1 or launches != SERVE_LAYERS * forwards:
        fail(f"K1 launched {launches} times for {forwards} forwards; "
             f"expected {SERVE_LAYERS} per forward")

    worst_rel, flips = 0.0, []
    for i, x in enumerate(requests):
        got = results[i]
        ref = einsum.predict(x)
        lg = got["logits"]
        if lg.shape != (rows[i], SERVE_SEQ, SERVE_VOCAB) or \
                not np.isfinite(lg).all():
            fail(f"request {i}: logits {lg.shape} or non-finite")
        rel = float(np.max(np.abs(lg - ref["logits"])) /
                    np.max(np.abs(ref["logits"])))
        worst_rel = max(worst_rel, rel)
        if not np.array_equal(got["next_token"], ref["next_token"]):
            flips.append(i)
    log(f"[serving] flash vs einsum servable: max|d logits| / max|logit| "
        f"{worst_rel:.3e} (<= 5e-2), next_token equal in "
        f"{len(requests) - len(flips)}/{len(requests)} requests")
    # 12 bf16 layers, rounded at other places on the two attention paths
    # (q scaled in bf16 vs in f32 inside the kernel)
    if worst_rel > 5e-2 or flips:
        fail(f"flash servable disagrees with einsum: rel {worst_rel}, "
             f"next_token differs in requests {flips}")

    # where a request's time goes: the servable's own stage split
    for x in (requests[0], requests[1]):
        _, st = flash.predict_with_stages(x)
        log(f"[serving] stages, {st['rows']} rows in bucket "
            f"{st['bucket']}: h2d {st['h2d_s'] * 1e3:.3f} ms, device "
            f"{st['device_s'] * 1e3:.3f} ms, drain (logits to host) "
            f"{st['drain_s'] * 1e3:.3f} ms")
    # the forward alone on the device, flash against einsum attention
    forward_ms = {}
    with torch.inference_mode():
        for b in (1, MAX_BATCH):
            x = torch.from_numpy(rng.integers(
                0, SERVE_VOCAB, (b, SERVE_SEQ)).astype(np.int32)).cuda()
            f_ms = cuda_time_ms(lambda: flash.predict_fn(flash.params, x),
                                iters=5, warmup=1)
            e_ms = cuda_time_ms(lambda: einsum.predict_fn(einsum.params, x),
                                iters=5, warmup=1)
            k1_ms = SERVE_LAYERS * k1_timings[b]["ms"]
            forward_ms[b] = {"flash": f_ms, "einsum": e_ms, "k1": k1_ms}
            log(f"[serving] forward on the device, bucket {b}: flash "
                f"{f_ms:.3f} ms (K1 {SERVE_LAYERS} x "
                f"{k1_timings[b]['ms']:.3f} = {k1_ms:.3f} ms, "
                f"{k1_ms / f_ms:.1%}), einsum {e_ms:.3f} ms")
    return {"launches": launches, "forwards": forwards, "wall_s": wall,
            "host_ms": [host_s[i] * 1e3 for i in range(len(requests))],
            "rows": rows, "peak_gib": peak_gib, "forward_ms": forward_ms}


# -- phase 4 ----------------------------------------------------------------


def phase_rest(fa, server, repo, client) -> dict:
    import urllib.request
    lm128 = repo.get("lm128")
    addr = f"127.0.0.1:{server.port}"
    rng = np.random.default_rng(2)
    launches0 = fa.flash_attention.launches
    forwards0 = lm128.metadata()["stats"]["request_count"]
    times = []
    sent = []
    for i in range(3):
        x = rng.integers(0, SERVE_VOCAB, (1, REST_SEQ)).astype(np.int32)
        t0 = time.perf_counter()
        resp = client.predict(addr, "lm128", x, dtype="int32",
                              timeout_s=300.0, retries=0)
        times.append(time.perf_counter() - t0)
        sent.append((x, resp))
    forwards = lm128.metadata()["stats"]["request_count"] - forwards0
    launches = fa.flash_attention.launches - launches0
    for i, (x, resp) in enumerate(sent):
        direct = lm128.predict(x)
        got = np.asarray(resp["predictions"]["next_token"])
        if not np.array_equal(got, direct["next_token"]):
            fail(f"REST request {i}: next_token {got} != direct "
                 f"{direct['next_token']}")
        shape = np.asarray(resp["predictions"]["logits"]).shape
        if shape != (1, REST_SEQ, SERVE_VOCAB):
            fail(f"REST request {i}: logits shape {shape}")
    with urllib.request.urlopen(f"http://{addr}/healthz?verbose=1",
                                timeout=30) as r:
        health = json.loads(r.read())
    with urllib.request.urlopen(f"http://{addr}/metrics", timeout=30) as r:
        metrics = r.read().decode()
    row = next(m for m in health["models"] if m["model"] == "lm128")
    if row["requests"] != 3 or \
            'kubeflow_model_request_count{model="lm128"}' not in metrics:
        fail(f"/healthz or /metrics missing the REST requests: {row}")
    if launches != SERVE_LAYERS * forwards:
        fail(f"REST: K1 launched {launches} times for {forwards} forwards")
    log(f"[rest] 3 :predict answered 200 with next_token equal to a "
        f"direct predict; host {', '.join(f'{t:.3f}s' for t in times)} "
        f"(JSON of {REST_SEQ * SERVE_VOCAB} logits each); K1 launches {launches} for "
        f"{forwards} forwards; /healthz p50 {row['p50Ms']} ms, /metrics "
        f"{len(metrics)} bytes")
    return {"rest_s": times}


# -- phase 5 ----------------------------------------------------------------


def _train(worker, cfg, path, **kw):
    return worker.train(workload="transformer", workload_kwargs={"cfg": cfg},
                        optimizer="adam", learning_rate=TRAIN_LR,
                        lr_schedule="constant", seed=0, metrics_path=path,
                        handle_sigterm=False, device=DEVICE, **kw)


def _windows(path) -> list[dict]:
    with open(path) as f:
        return [r for r in map(json.loads, f) if not r.get("event")]


def phase_train(counters, T, worker, recipe, trainstep, k_ms) -> dict:
    """The LM at full width through train(): the launch counts of every
    kernel per step, finite and falling losses, and agreement with the
    einsum + stock path at batch 2."""
    import tempfile
    cfg = T.TransformerConfig()
    per_step = {"flash_attention_fwd": cfg.num_layers,
                "flash_attention_bwd_dq": cfg.num_layers,
                "flash_attention_bwd_dkv": cfg.num_layers,
                "fused_adam": 1}      # over all 101 parameter tensors
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "main.jsonl")
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0           # the main path's counts start ...
        t0 = time.perf_counter()
        result = _train(worker, cfg, path, kernel_attention="flash",
                        kernel_optimizer="fused_adam",
                        global_batch=TRAIN_BATCH, steps=TRAIN_STEPS,
                        sync_every=TRAIN_SYNC)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counters.items()}  # ... here
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        windows = _windows(path)

        compare = {}
        for arm, ka, ko in (("flash+fused_adam", "flash", "fused_adam"),
                            ("einsum+stock", "einsum", "stock")):
            cpath = os.path.join(tmp, f"{ka}.jsonl")
            _train(worker, cfg, cpath, kernel_attention=ka,
                   kernel_optimizer=ko, global_batch=COMPARE_BATCH,
                   steps=COMPARE_STEPS, sync_every=1)
            compare[arm] = _windows(cpath)

    expected = {n: k * TRAIN_STEPS for n, k in per_step.items()}
    losses = [w["loss"] for w in windows]
    log(f"[train] {TRAIN_STEPS} steps of the full-width LM at batch "
        f"{TRAIN_BATCH} x S {SERVE_SEQ} through train() in {wall:.1f}s "
        f"(init and the first step's sync included); launches {launches} "
        f"(expected {expected}); window losses {losses}; peak device "
        f"memory {peak_gib:.2f} GiB")
    if launches != expected:
        fail(f"train: launches {launches}, expected {expected}")
    if len(windows) != TRAIN_STEPS // TRAIN_SYNC or \
            not all(np.isfinite([w["loss"], w["grad_norm"]]).all()
                    for w in windows):
        fail(f"train: windows {windows}")
    if not losses[-1] < losses[0]:
        fail(f"train: the last window's loss {losses[-1]} is not below "
             f"the first's {losses[0]}")
    tokens = TRAIN_BATCH * SERVE_SEQ
    step_s = result.mean_step_time_s
    log(f"[train] step time {step_s * 1e3:.1f} ms (host clock over the "
        f"windows after the first), {tokens / step_s:.0f} tokens/s; time "
        f"to first step {result.time_to_first_step_s:.2f}s")

    a, b = compare["flash+fused_adam"], compare["einsum+stock"]
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for i, (x, y) in enumerate(zip(a, b)):
        for key in ("loss", "grad_norm") if i == 0 else ("loss",):
            worst[key] = max(worst[key], abs(x[key] - y[key]) / abs(y[key]))
    log(f"[train] batch {COMPARE_BATCH}, {COMPARE_STEPS} steps, same seed, "
        f"weights and batches: flash+fused_adam losses "
        f"{[w['loss'] for w in a]} grad_norm@1 {a[0]['grad_norm']:.5f}; "
        f"einsum+stock losses {[w['loss'] for w in b]} grad_norm@1 "
        f"{b[0]['grad_norm']:.5f}; worst relative loss difference "
        f"{worst['loss']:.3e} (<= {LOSS_RTOL}), step-1 grad_norm "
        f"{worst['grad_norm']:.3e} (<= {GNORM_RTOL})")
    if len(a) != COMPARE_STEPS or len(b) != COMPARE_STEPS or \
            worst["loss"] > LOSS_RTOL or worst["grad_norm"] > GNORM_RTOL:
        fail("train: flash+fused_adam disagrees with einsum+stock")

    # the step's device time, split: forward+backward, then clip+update
    spec = T.workload_spec(replace(cfg, attention="flash"))
    builder = trainstep.TrainStepBuilder(
        loss_fn=spec.loss_fn, device=DEVICE,
        optimizer=lambda p: recipe.make_optimizer(
            p, "adam", TRAIN_LR, kernels="fused_adam")[0])
    gen = torch.Generator().manual_seed(3)
    state = builder.init(spec.init_fn, gen)
    batch = builder.place_batch(spec.batch_fn(gen, TRAIN_BATCH))
    opt = state.opt_state

    def fwd_bwd():
        opt.zero_grad(set_to_none=True)
        loss, _ = spec.loss_fn(state.params, {}, batch, None)
        loss.backward()

    def update():               # as the train step runs it
        opt.step(grad_norm=recipe.global_norm(
            [p.grad for p in state.params.values()]))

    fb_ms = cuda_time_ms(fwd_bwd, iters=5, warmup=1)
    up_ms = cuda_time_ms(update, iters=5, warmup=1)
    dev_ms = fb_ms + up_ms
    shares = {n: per_step[n] * k_ms[n] for n in per_step}
    log(f"[train] device time per step (CUDA events, batch {TRAIN_BATCH}): "
        f"forward+backward {fb_ms:.3f} ms, grad norm + clip + update "
        f"{up_ms:.3f} ms, sum {dev_ms:.3f} ms; kernel shares (launches x "
        f"phase-2 time): " + ", ".join(
            f"{n} {per_step[n]} x {k_ms[n]:.4f} = {v:.3f} ms "
            f"({v / dev_ms:.1%})" for n, v in shares.items()))
    del state, builder, batch, opt
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_s * 1e3,
            "tokens_per_s": tokens / step_s, "fwd_bwd_ms": fb_ms,
            "update_ms": up_ms, "peak_gib": peak_gib, "losses": losses,
            "compare": worst}


# -- phase 6 ----------------------------------------------------------------


def _train_resnet(worker, path, fused, **kw):
    return worker.train(
        workload="resnet50", workload_kwargs={
            "image_size": IMAGE, "num_classes": CLASSES, "fused": fused},
        global_batch=RESNET_BATCH, steps=TRAIN_STEPS, sync_every=TRAIN_SYNC,
        seed=0, metrics_path=path, handle_sigterm=False, device=DEVICE, **kw)


def phase_resnet(counters, R, worker, trainstep, recipe, k45) -> dict:
    """ResNet-50 at full width through train(): the exact-BN default path,
    then --fused-blocks; launch counts per fused step, the routing against
    the JAX package's, finite losses, and the fused loss at init within
    0.5 of the default path's on the same weights and batch."""
    import tempfile
    routing = R.fused_block_routing(50, IMAGE)
    if routing != EXPECTED_ROUTING:
        fail(f"routing {routing} != the JAX package's {EXPECTED_ROUTING}")
    per_step = {"fused_block_train_fwd": 0, "fused_block_train_bwd": 0,
                "fused_block_train_spatial_fwd": 0,
                "fused_block_train_spatial_bwd": 0}
    for route in routing.values():
        if route.startswith("fused-"):
            name = "fused_block_train" + (
                "_spatial" if route.startswith("fused-spatial") else "")
            per_step[f"{name}_fwd"] += 1
            per_step[f"{name}_bwd"] += 1
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for arm, fused in (("default", False), ("fused", True)):
            path = os.path.join(tmp, f"{arm}.jsonl")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for fn in counters.values():
                fn.launches = 0       # the main path's counts start ...
            t0 = time.perf_counter()
            result = _train_resnet(
                worker, path, fused,
                **({} if fused else {"eval_every": TRAIN_STEPS,
                                     "eval_batches": 2}))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {n: fn.launches for n, fn in counters.items()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            windows = _windows(path)
            losses = [w["loss"] for w in windows]
            step_s = result.mean_step_time_s
            runs[arm] = {"launches": launches, "losses": losses,
                         "step_ms": step_s * 1e3,
                         "images_per_s": RESNET_BATCH / step_s,
                         "peak_gib": peak, "wall_s": wall,
                         "eval": {k: result.final_metrics.get(k) for k in
                                  ("eval_loss", "top1", "top5")}}
            log(f"[resnet] {arm}: {TRAIN_STEPS} steps of ResNet-50 at "
                f"{IMAGE} px, {CLASSES} classes, batch {RESNET_BATCH} "
                f"(momentum, lr 0.1) through train() in {wall:.1f}s; window "
                f"losses {losses}; step {step_s * 1e3:.1f} ms, "
                f"{RESNET_BATCH / step_s:.1f} images/s (host clock over the "
                f"windows after the first); peak device memory {peak:.2f} "
                f"GiB; launches {launches}")
            if len(windows) != TRAIN_STEPS // TRAIN_SYNC or \
                    not np.isfinite(losses).all():
                fail(f"resnet {arm}: windows {windows}")
    if runs["default"]["launches"] != {n: 0 for n in per_step} or \
            runs["default"]["eval"]["top1"] is None:
        fail(f"the default path launched {runs['default']['launches']} or "
             f"ran no eval ({runs['default']['eval']})")
    expected = {n: k * TRAIN_STEPS for n, k in per_step.items()}
    if runs["fused"]["launches"] != expected:
        fail(f"fused launches {runs['fused']['launches']}, expected "
             f"{expected}: a stride-1 block did not run K4 or K5")
    log(f"[resnet] routing equals the JAX package's fused_block_routing(50, "
        f"{IMAGE}); per fused step K4 {per_step['fused_block_train_fwd']} + "
        f"{per_step['fused_block_train_bwd']}, K5 "
        f"{per_step['fused_block_train_spatial_fwd']} + "
        f"{per_step['fused_block_train_spatial_bwd']} launches; default-path "
        f"eval {runs['default']['eval']}")

    # the fused loss at init against the default path's, and the fused
    # step's device time split between K4/K5 and the rest
    gen = torch.Generator().manual_seed(5)
    specs = {arm: R.workload_spec(IMAGE, CLASSES, fused=fused)
             for arm, fused in (("default", False), ("fused", True))}
    builder = trainstep.TrainStepBuilder(
        loss_fn=specs["fused"].loss_fn, device=DEVICE,
        optimizer=lambda p: recipe.make_optimizer(p, "momentum", 0.1)[0])
    state = builder.init(specs["fused"].init_fn, gen)
    batch = builder.place_batch(specs["fused"].batch_fn(gen, RESNET_BATCH))
    with torch.no_grad():
        init_loss = {arm: float(s.loss_fn(state.params, state.variables,
                                          batch, None)[0])
                     for arm, s in specs.items()}
    gap = abs(init_loss["fused"] - init_loss["default"])
    log(f"[resnet] loss at init, same weights and batch: fused "
        f"{init_loss['fused']:.5f}, default {init_loss['default']:.5f}, "
        f"|d| {gap:.5f} (<= 0.5)")
    if not gap <= 0.5:
        fail("fused loss at init is not within 0.5 of the default path's")

    def fwd_bwd(arm):
        def run():
            for p in state.params.values():
                p.grad = None
            loss, _ = specs[arm].loss_fn(state.params, state.variables,
                                         batch, None)
            loss.backward()
        return run

    dev_ms = {arm: cuda_time_ms(fwd_bwd(arm), iters=3, warmup=1)
              for arm in specs}
    kernel_ms = sum(g["count"] * (g["fwd_ms"] + g["bwd_ms"])
                    for g in k45["geoms"])
    log(f"[resnet] device time of forward+backward at batch {RESNET_BATCH} "
        f"(CUDA events): fused {dev_ms['fused']:.3f} ms, of which K4/K5 "
        f"{kernel_ms:.3f} ms ({kernel_ms / dev_ms['fused']:.1%}; 13 blocks x "
        f"(forward + backward) at their phase-2 times) and the rest "
        f"{dev_ms['fused'] - kernel_ms:.3f} ms; default (cuDNN, exact BN) "
        f"{dev_ms['default']:.3f} ms")
    del state, builder, batch
    torch.cuda.empty_cache()
    return {"runs": runs, "per_step": per_step, "init_loss": init_loss,
            "dev_ms": dev_ms, "kernel_ms": kernel_ms}



# -- phase 6b: ResNet-50 from record shards -----------------------------------

# records at ImageNet's geometry: a train set of 640 in 4 shards and a
# holdout of 100 (one batch of 64 and a short one of 36, padded and masked)
RECORDS_TRAIN, RECORDS_SHARDS, RECORDS_HOLDOUT = 640, 4, 100
RECORDS_STEPS, RECORDS_SYNC, RECORDS_PROFILE_STEPS = 12, 3, 3
RECORDS_ARMS = ((0, 0), (2, 0), (0, 2), (2, 2))   # (input_workers, prefetch)
PREFETCH_CHECK_BATCHES, PREFETCH_DEPTH = 20, 2
# device_normalize on the card against the CPU: the same f32 multiply and
# subtract on each element
NORMALIZE_TOL = 1e-6
# LARS / RMSProp on the card against the CPU: the same f32 arithmetic;
# the tensor norms and the rounding of fused multiply-adds differ, each by
# an ulp or two of a step that is itself a small part of a parameter
CHAIN_RTOL = 1e-5


class ObsPoller(threading.Thread):
    """The worker's /metrics port from outside: read /flightrecorder and
    /metrics every ``interval`` seconds until the port closes, keeping the
    last answers; with ``profile_steps``, once the flight recorder holds a
    window (so the capture covers steady steps), POST /profile?steps=N.
    Each read takes the worker's interpreter lock from its host-bound
    loop: at 20 ms the step slows measurably (tools/step_overheads.py),
    so a timed run reads every 0.25 s."""

    def __init__(self, port: int, profile_steps: int, interval: float):
        super().__init__(daemon=True, name="obs-poller")
        self.base = f"http://127.0.0.1:{port}"
        self.profile_steps = profile_steps
        self.interval = interval
        self.armed = self.flight = self.metrics = None
        self._halt = threading.Event()

    def _get(self, path: str):
        import urllib.request
        with urllib.request.urlopen(self.base + path, timeout=5) as r:
            return r.read().decode()

    def run(self) -> None:
        import urllib.request
        while not self._halt.is_set():
            try:
                self.flight = json.loads(self._get("/flightrecorder"))
                self.metrics = self._get("/metrics")
                if self.armed is None and self.flight["records"]:
                    req = urllib.request.Request(
                        f"{self.base}/profile?steps={self.profile_steps}",
                        data=b"", method="POST")
                    with urllib.request.urlopen(req, timeout=5) as r:
                        self.armed = json.loads(r.read())
            except (OSError, ValueError):
                pass        # not up yet, or already closed
            self._halt.wait(self.interval)

    def halt(self) -> None:
        self._halt.set()
        self.join(10)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def trace_idle(trace_dir: str) -> dict:
    """Device busy time and idle share of a torch.profiler Chrome trace:
    the union of the device's kernel, copy and memset intervals over the
    span of every timed event in the capture."""
    import glob
    paths = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(paths) != 1:
        fail(f"{trace_dir}: {len(paths)} traces")
    with open(paths[0]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events if e.get("cat") in
                    ("kernel", "gpu_memcpy", "gpu_memset"))
    if not device:
        fail(f"{paths[0]}: the capture holds no device events")
    busy, end = 0.0, -1.0
    for a, b in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    return {"trace": paths[0], "busy_ms": busy / 1e3,
            "span_ms": (t1 - t0) / 1e3,
            "idle_share": 1.0 - busy / (t1 - t0),
            "kernels": sum(1 for e in events if e.get("cat") == "kernel")}


def _records_run(worker, counters, tmp, label, data=None, holdout=None,
                 profile=False, **kw) -> dict:
    """One fused ResNet-50 train() with the LARS runtime-schedule recipe,
    the /metrics port, TensorBoard events and, with ``profile``, a
    capture armed over steady steps (its stop writes a trace inside the
    timed windows, so a profiled run's step time is not reported); the
    counts start at 0 just before and are read just after."""
    from kubeflow_tpu_torch.data.imagenet import IMPL_COUNTER
    from kubeflow_tpu_torch.obs import registry as obsreg
    impl = obsreg.counter(IMPL_COUNTER, "", labels=("stage", "impl"))
    impl_before = {(s, i): impl.labels(stage=s, impl=i).value
                   for s in ("records", "augment") for i in ("native", "py")}
    port = _free_port()
    poller = ObsPoller(port, RECORDS_PROFILE_STEPS if profile else 0,
                       0.02 if profile else 0.25)
    path = os.path.join(tmp, f"{label}.jsonl")
    tb = os.path.join(tmp, f"tb-{label}")
    profiles = os.path.join(tmp, f"profiles-{label}")
    os.environ["KFTPU_PROFILE_DIR"] = profiles
    poller.start()
    for fn in counters.values():
        fn.launches = 0               # the main path's counts start ...
    t0 = time.perf_counter()
    try:
        result = worker.train(
            workload="resnet50", workload_kwargs={"fused": True},
            global_batch=RESNET_BATCH, steps=RECORDS_STEPS,
            sync_every=RECORDS_SYNC, seed=0, optimizer="lars",
            learning_rate=0.1, lr_schedule="cosine", warmup_steps=2,
            runtime_schedule=True, data_dir=data, eval_data_dir=holdout,
            eval_every=RECORDS_STEPS if holdout else 0, eval_batches=0,
            metrics_path=path, tensorboard_dir=tb, obs_metrics_port=port,
            handle_sigterm=False, device=DEVICE, **kw)
        torch.cuda.synchronize()
    finally:
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counters.items()}  # ... end
        poller.halt()
        del os.environ["KFTPU_PROFILE_DIR"]
    impl_delta = {k: impl.labels(stage=k[0], impl=k[1]).value - v
                  for k, v in impl_before.items()}
    windows = _windows(path)
    losses = [w["loss"] for w in windows]
    if len(windows) != RECORDS_STEPS // RECORDS_SYNC or \
            not np.isfinite(losses).all():
        fail(f"{label}: windows {windows}")
    if not any(f.startswith("events.out.tfevents.")
               for f in os.listdir(tb)):
        fail(f"{label}: no TensorBoard events file in {tb}")
    idle = None
    if profile:
        if poller.armed is None or not poller.armed.get("armed") or \
                not poller.armed["dir"].startswith(profiles):
            fail(f"{label}: POST /profile answered {poller.armed}")
        idle = trace_idle(poller.armed["dir"])
    records = (poller.flight or {}).get("records", [])
    split = ("data_s", "h2d_s", "dispatch_s", "drain_s", "device_wait_s")
    if not all(set(split) <= set(r) for r in records) or (
            profile and len(records) < 2):
        fail(f"{label}: /flightrecorder answered {poller.flight}")
    steady = records[1:]
    stage_ms = {k: 1e3 * sum(r[k] for r in steady) / sum(
        r["steps"] for r in steady) for k in split} if steady else None
    step_s = result.mean_step_time_s
    return {"label": label, "result": result, "launches": launches,
            "losses": losses, "wall_s": wall, "impl": impl_delta,
            "step_ms": step_s * 1e3, "images_per_s": RESNET_BATCH / step_s,
            "idle": idle, "stage_ms": stage_ms, "windows_seen": len(records),
            "metrics": poller.metrics or "", "armed": poller.armed}


def _prefetch_check(fbts, R, train_dir) -> dict:
    """DevicePrefetcher over 20 ImageNetSource batches while the consumer
    runs a K5 backward at 56x56_256_64_256 between batches: every device
    batch copied back equals its host batch, kept aside, byte for byte,
    and the card holds at most `depth` batches after each hand-out."""
    from kubeflow_tpu_torch.data.device_prefetch import DevicePrefetcher
    from kubeflow_tpu_torch.data.imagenet import ImageNetSource
    dev = torch.device(DEVICE)
    geo = next(g for g in R.stride1_geometries(50, IMAGE)
               if g["key"] == "56x56_256_64_256")
    gen = torch.Generator(device=dev).manual_seed(9)
    w = _block_weights(gen, geo["cin"], geo["cmid"], geo["cout"],
                       geo["proj"])
    x = torch.randn((RESNET_BATCH, geo["h"], geo["h"], geo["cin"]),
                    generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn((RESNET_BATCH, geo["h"], geo["h"], geo["cout"]),
                    generator=gen, device=dev).to(torch.bfloat16)
    tiles = EXPECTED_TILES[geo["key"]][1:]
    _, _, ghost = fbts.fused_block_train_spatial_fwd(x, w, *tiles)

    def heavy():
        return fbts.fused_block_train_spatial_bwd(x, g, w, *tiles,
                                                  ghost=ghost)

    heavy()                      # workspaces the wrapper keeps
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    src = ImageNetSource(train_dir, RESNET_BATCH, output="uint8")
    host = []

    def kept():
        it = src.batches(seed=5)
        for _ in range(PREFETCH_CHECK_BATCHES):
            b = next(it)
            host.append({k: v.copy() for k, v in b.items()})
            yield b

    def place(b):
        return {k: torch.as_tensor(v).to(dev, non_blocking=True)
                for k, v in b.items()}

    pf = DevicePrefetcher(kept(), place, depth=PREFETCH_DEPTH, device=dev)
    worst, n, bad = 0, 0, []
    t0 = time.perf_counter()
    try:
        for i, batch in enumerate(pf):
            nbytes = sum(-(-v.numel() * v.element_size() // 512) * 512
                         for v in batch.values())
            worst = max(worst, torch.cuda.memory_allocated() - base)
            # depth batches and small allocations of the consumer's work
            # (a few hundred bytes); one batch more would add nbytes
            if worst > PREFETCH_DEPTH * nbytes + nbytes // 2:
                fail(f"prefetch: {worst} bytes on the card after batch {i}, "
                     f"more than {PREFETCH_DEPTH} x {nbytes}")
            out = heavy()
            for k, v in batch.items():
                if v.cpu().numpy().tobytes() != host[i][k].tobytes():
                    bad.append((i, k))
            del batch, out
            n += 1
    finally:
        pf.close()
        src.close()
    wall = time.perf_counter() - t0
    if bad or n != PREFETCH_CHECK_BATCHES:
        fail(f"prefetch: {n} batches, differing {bad}")
    log(f"[records] prefetcher: {n} batches of {RESNET_BATCH} x {IMAGE}^2 "
        f"uint8 staged {PREFETCH_DEPTH} ahead on a side stream while the "
        f"consumer ran a K5 backward ({geo['key']}) between batches: every "
        f"batch equal to its host copy byte for byte; at most {worst} bytes "
        f"on the card after a hand-out ({PREFETCH_DEPTH} batches: "
        f"{PREFETCH_DEPTH * nbytes}); {wall:.2f}s")
    return {"batches": n, "worst_bytes": worst}


def _chain_check(R, recipe) -> dict:
    """LARS and RMSProp, baked and under the runtime schedule, 5 steps
    over ResNet-50's parameter tensors on the card against the same steps
    on the CPU, without the clip: its f32 global norm over 25.6M elements
    sums in another order on each side (the CPU's reduction moves it by
    more than this bar), and LARS hands a gradient's scale straight on
    wherever its trust ratio is 1 (the zero-init BN scales), so the clip
    would be measured instead of the chain."""
    model = R.resnet50(num_classes=CLASSES)
    params, _ = model.init(torch.Generator().manual_seed(0))
    names = sorted(params)
    gen = torch.Generator().manual_seed(1)
    grads = [[torch.randn(params[k].shape, generator=gen) * 0.01
              for k in names] for _ in range(5)]
    kw = dict(learning_rate=0.1, schedule="cosine", total_steps=5,
              warmup_steps=2, weight_decay=1e-4)
    worst = {}
    for name in ("lars", "rmsprop"):
        for runtime in (False, True):
            sides = []
            for dev in ("cpu", DEVICE):
                ps = [params[k].clone().to(dev) for k in names]
                opt = recipe.make_optimizer(ps, name, grad_clip=None,
                                            runtime_schedule=runtime, **kw)[0]
                for step in range(5):
                    for p, gr in zip(ps, grads[step]):
                        p.grad = gr.clone().to(dev)
                    opt.step()
                sides.append(ps)
            share = max((a.cpu() - b).abs().max().item() /
                        (CHAIN_RTOL * max(b.abs().max().item(), 1e-30))
                        for b, a in zip(*sides))
            worst[(name, runtime)] = share
            if not share <= 1.0:
                fail(f"{name} (runtime schedule {runtime}) on the card: "
                     f"{share:.3f} of the bar")
    log(f"[records] LARS and RMSProp, 5 steps over ResNet-50's "
        f"{len(names)} parameter tensors, card against CPU, baked / "
        f"runtime schedule: largest share of the 1e-5 relative bar "
        + ", ".join(f"{n} {'runtime' if r else 'baked'} {s:.3f}"
                    for (n, r), s in worst.items()))
    return worst


def phase_resnet_records(counters, R, worker, recipe, fbts, per_step,
                         card) -> dict:
    """ResNet-50 at full width trained by train() from record shards at
    224 px: LARS, lr 0.1, cosine with 2 warmup steps under the runtime
    schedule, the holdout evaluated once at the end; input_workers 0 and
    2 by device_prefetch 0 and 2, then the synthetic pool with the same
    recipe; the prefetcher's bytes, device_normalize, LARS and RMSProp on
    the card."""
    import tempfile
    from kubeflow_tpu_torch.data import native
    from kubeflow_tpu_torch.data.imagenet import device_normalize, \
        write_shards
    if not native.native_available():
        fail(f"the native record pipeline did not build into "
             f"{native.BUILD_DIR} (g++ and make are needed)")
    expected = {n: k * RECORDS_STEPS for n, k in per_step.items()}
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(17)
        train_dir = os.path.join(tmp, "train")
        holdout = os.path.join(tmp, "holdout")
        t0 = time.perf_counter()
        for d, n, per_shard in (
                (train_dir, RECORDS_TRAIN, RECORDS_TRAIN // RECORDS_SHARDS),
                (holdout, RECORDS_HOLDOUT, RECORDS_HOLDOUT)):
            write_shards(d, rng.integers(0, 256, (n, IMAGE, IMAGE, 3),
                                         dtype=np.uint8),
                         rng.integers(0, CLASSES, n),
                         shard_records=per_shard, num_classes=CLASSES)
        size = sum(os.path.getsize(os.path.join(d, f))
                   for d in (train_dir, holdout) for f in os.listdir(d))
        log(f"[records] wrote {RECORDS_TRAIN} + {RECORDS_HOLDOUT} records "
            f"of {IMAGE} px in {RECORDS_SHARDS} + 1 shards ({size / 1e6:.1f} "
            f"MB) in {time.perf_counter() - t0:.1f}s; native pipeline "
            f"{native.BUILD_DIR}")

        def checked(label, **kw):
            run = _records_run(worker, counters, tmp, label, **kw)
            if run["launches"] != expected:
                fail(f"{label}: launches {run['launches']}, expected "
                     f"{expected}")
            if "data" not in kw:
                return run
            fm = run["result"].final_metrics
            if fm.get("eval_examples") != float(RECORDS_HOLDOUT) or \
                    not np.isfinite(fm.get("eval_loss", np.nan)):
                fail(f"{label}: the eval counted "
                     f"{fm.get('eval_examples')} records, not "
                     f"{RECORDS_HOLDOUT} ({fm})")
            imp = run["impl"]
            if imp[("records", "py")] or imp[("augment", "py")] or \
                    imp[("records", "native")] < RECORDS_STEPS or \
                    imp[("augment", "native")] < RECORDS_STEPS:
                fail(f"{label}: batches by implementation {imp}: the run "
                     f"did not use the native core")
            return run

        # each arm twice: timed without a capture, then profiled. Every
        # timed run comes first: after a torch.profiler capture this
        # process's steps stay slower (PERF.md §7)
        arms = {f"w{w}p{p}": dict(data=train_dir, holdout=holdout,
                                  input_workers=w, device_prefetch=p)
                for w, p in RECORDS_ARMS}
        for label, kw in arms.items():
            torch.cuda.empty_cache()
            runs.append(checked(label, **kw))
            runs[-1].update(workers=kw["input_workers"],
                            prefetch=kw["device_prefetch"])
        text = runs[-1]["metrics"]
        for stage in ("augment", "device_put"):
            if f'kftpu_input_batches_total{{stage="{stage}"}}' not in text:
                fail(f"GET /metrics lacks the {stage} stage:\n{text}")
        synthetic = checked("synthetic")
        for run, kw in zip(runs + [synthetic], [*arms.values(), {}]):
            run["idle"] = checked(run["label"] + "-profiled", profile=True,
                                  **kw)["idle"]
        # the synthetic run again, timed, after the five captures
        after = checked("synthetic-after-captures")
        for run in runs + [synthetic]:
            s, i = run["stage_ms"], run["idle"]
            # the device's busy time a step from the capture, over the
            # un-profiled run's step: the idle share without the
            # profiler's own host cost
            run["idle_unprofiled"] = 1.0 - i["busy_ms"] / (
                RECORDS_PROFILE_STEPS * run["step_ms"])
            log(f"[records] {run['label']}: ResNet-50 fused, LARS runtime "
                f"schedule, {RECORDS_STEPS} steps "
                + (f"from records (input_workers {run['workers']}, "
                   f"device_prefetch {run['prefetch']})"
                   if "workers" in run else "on the synthetic pool")
                + f": step {run['step_ms']:.3f} ms, "
                f"{run['images_per_s']:.1f} images/s (host clock over the "
                f"windows after the first); "
                + (f"flight recorder per step over {run['windows_seen'] - 1}"
                   f" windows: data {s['data_s']:.3f}, h2d {s['h2d_s']:.3f},"
                   f" dispatch {s['dispatch_s']:.3f}, drain "
                   f"{s['drain_s']:.3f}, device wait "
                   f"{s['device_wait_s']:.3f} ms" if s else
                   "the flight recorder was read before its second window")
                + "; a second run profiled "
                f"{RECORDS_PROFILE_STEPS} steps: device busy "
                f"{i['busy_ms']:.3f} of {i['span_ms']:.3f} ms, idle share "
                f"{i['idle_share']:.3f} ({i['kernels']} kernels), busy a "
                f"step over the un-profiled step: idle "
                f"{run['idle_unprofiled']:.3f}; window "
                f"losses {[round(x, 4) for x in run['losses']]}; eval "
                + (f"{run['result'].final_metrics['eval_examples']:.0f} "
                   f"records" if "workers" in run else "none")
                + f"; wall {run['wall_s']:.1f}s | {card}")
        change = after["step_ms"] / synthetic["step_ms"] - 1
        log(f"[records] the synthetic run again after the five captures: "
            f"step {after['step_ms']:.3f} ms ({change:+.1%} against before "
            f"them) | {card}")
        log(f"[records] per step K4 {per_step['fused_block_train_fwd']} + "
            f"{per_step['fused_block_train_bwd']}, K5 "
            f"{per_step['fused_block_train_spatial_fwd']} + "
            f"{per_step['fused_block_train_spatial_bwd']} in every run; the "
            f"native pipeline and augment made every batch; /metrics shows "
            f"both input stages")

        prefetch = _prefetch_check(fbts, R, train_dir)
        x = torch.from_numpy(rng.integers(0, 256, (RESNET_BATCH, IMAGE,
                                                   IMAGE, 3), dtype=np.uint8))
        norm_err = (device_normalize(x.to(DEVICE)).cpu()
                    - device_normalize(x)).abs().max().item()
        log(f"[records] device_normalize on the card against the CPU, "
            f"{RESNET_BATCH} x {IMAGE}^2 x 3: max|d| {norm_err:.3e} "
            f"(<= {NORMALIZE_TOL})")
        if not norm_err <= NORMALIZE_TOL:
            fail("device_normalize differs on the card")
    chain = _chain_check(R, recipe)
    return {"runs": runs, "synthetic": synthetic, "after": after,
            "prefetch": prefetch,
            "normalize_err": norm_err, "chain": chain}


# -- phase 7 ----------------------------------------------------------------


def _margin_rule(got: np.ndarray, ref: np.ndarray) -> tuple:
    """(max|d logit|, rows whose classes differ, of those the rows whose
    top-2 margin in ``ref`` is not below max|d|): a class may differ only
    where the reference's top two lie closer than the two paths differ."""
    err = float(np.abs(got - ref).max())
    top2 = np.sort(ref, axis=-1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    differ = np.nonzero(got.argmax(-1) != ref.argmax(-1))[0]
    return err, differ, [int(i) for i in differ if margin[i] >= err]


def phase_resnet_serve(fb, R, ModelRepository, ModelServer, client,
                       run_batch_predict, k6) -> dict:
    """ResNet-50 inference at full width: served through the MicroBatcher,
    REST and the batch-predict job, then fused_eval_apply (13 K6 launches)
    on the same variables, held to the served logits."""
    import tempfile
    repo = ModelRepository()
    t0 = time.perf_counter()
    serv = repo.load("resnet50", "resnet50", image_size=IMAGE,
                     num_classes=CLASSES, device=DEVICE)
    serv.max_batch = SERVE_BATCH
    variables = nontrivial_variables(R.resnet50(num_classes=CLASSES), seed=8)
    serv.swap(variables, 2)
    variables = serv.params                     # on the card
    buckets = serv.warmup()
    log(f"[resnet-serve] loaded resnet50 ({IMAGE} px, {CLASSES} classes) on the "
        f"card, swapped in the seeded variables, warmed buckets {buckets} "
        f"in {time.perf_counter() - t0:.1f}s")
    server = ModelServer(repo, host="127.0.0.1", port=0,
                         max_batch=SERVE_BATCH, batching="continuous",
                         sample_every=0)
    server.start()
    rng = np.random.default_rng(9)
    try:
        batcher = server.batcher("resnet50")
        rows = [1, 3, 8, 2, 5, 4]
        requests = [rng.standard_normal((n, IMAGE, IMAGE, 3)).astype(
            np.float32) for n in rows]
        results, host_s, errors = {}, {}, []

        def send(i):
            t = time.perf_counter()
            try:
                results[i] = batcher.predict(requests[i], timeout=300.0)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(f"request {i}: {type(e).__name__}: {e}")
            host_s[i] = time.perf_counter() - t

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(rows))]
        forwards0 = serv.metadata()["stats"]["request_count"]
        fb.fused_bottleneck_eval.launches = 0   # the served path's count
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        served_k6 = fb.fused_bottleneck_eval.launches
        forwards = serv.metadata()["stats"]["request_count"] - forwards0
        if errors or any(t.is_alive() for t in threads):
            fail(f"resnet serving requests failed: {errors}")
        worst = 0.0
        for i, x in enumerate(requests):
            got, ref = results[i], serv.predict(x)
            lg = got["logits"]
            if lg.shape != (rows[i], CLASSES) or not np.isfinite(lg).all():
                fail(f"request {i}: logits {lg.shape} or non-finite")
            err, differ, bad = _margin_rule(lg, ref["logits"])
            worst = max(worst, err)
            if bad or not np.array_equal(got["classes"], lg.argmax(-1)):
                fail(f"request {i}: classes differ from a direct predict in "
                     f"rows {list(differ)} beyond the margin rule")
        log(f"[resnet-serve] {len(rows)} concurrent requests ({sum(rows)} "
            f"rows) in {forwards} forwards, wall {wall:.3f}s; against a "
            f"direct predict max|d logit| {worst:.3e}; K6 launches on the "
            f"served path {served_k6} (it runs ResNet.apply)")
        for i in range(len(rows)):
            log(f"[resnet-serve] request {i}: {rows[i]} rows, host "
                f"{host_s[i] * 1e3:.1f} ms (ends in synchronize)")
        if served_k6 != 0:
            fail(f"the served path launched K6 {served_k6} times")

        addr = f"127.0.0.1:{server.port}"
        rest_s = []
        for n in (1, 2):
            x = rng.standard_normal((n, IMAGE, IMAGE, 3)).astype(np.float32)
            t = time.perf_counter()
            resp = client.predict(addr, "resnet50", x, timeout_s=300.0,
                                  retries=0)
            rest_s.append(time.perf_counter() - t)
            direct = serv.predict(x)
            got = np.asarray(resp["predictions"]["classes"])
            lg = np.asarray(resp["predictions"]["logits"], np.float32)
            if not np.array_equal(got, direct["classes"]) or \
                    np.abs(lg - direct["logits"]).max() > 1e-6:
                fail(f"REST resnet50 ({n} rows) differs from a direct "
                     f"predict")
        log(f"[resnet-serve] 2 REST :predict (1 and 2 rows of {IMAGE}^2 "
            f"f32 as JSON) equal to a direct predict; host "
            f"{', '.join(f'{t:.3f}s' for t in rest_s)}")
    finally:
        server.stop()

    images = rng.standard_normal((PREDICT_ROWS, IMAGE, IMAGE, 3)).astype(
        np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "images.npy"), images)
        out = os.path.join(tmp, "preds.jsonl")
        t = time.perf_counter()
        summary = run_batch_predict(serv, [os.path.join(tmp, "*.npy")], out,
                                    batch_size=SERVE_BATCH)
        job_s = time.perf_counter() - t
        with open(out) as f:
            lines = [json.loads(line) for line in f]
    records = [r for r in lines if "prediction" in r]
    if len(records) != PREDICT_ROWS or summary["instances"] != PREDICT_ROWS:
        fail(f"batch predict wrote {len(records)} records, summary "
             f"{summary}")
    direct = serv.predict(images)
    job_logits = np.array([r["prediction"]["logits"] for r in records],
                          np.float32)
    err, differ, bad = _margin_rule(job_logits, direct["logits"])
    if bad or [r["index"] for r in records] != list(range(PREDICT_ROWS)):
        fail(f"batch predict classes differ from the served path's in rows "
             f"{list(differ)} beyond the margin rule")
    log(f"[resnet-serve] run_batch_predict: {PREDICT_ROWS} images at batch "
        f"size {SERVE_BATCH} (tail padded) -> {len(records)} records + "
        f"summary in {job_s:.2f}s; classes equal to the served path's in "
        f"{PREDICT_ROWS - len(differ)}/{PREDICT_ROWS} rows, max|d logit| "
        f"{err:.3e}")

    x = torch.from_numpy(images[:SERVE_BATCH]).to(DEVICE)
    served = direct["logits"][:SERVE_BATCH]
    with torch.inference_mode():
        fb.fused_bottleneck_eval.launches = 0    # the K6 path's count ...
        fused = R.fused_eval_apply(variables, x)
        torch.cuda.synchronize()
        launches = fb.fused_bottleneck_eval.launches   # ... read here
        fused = fused.float().cpu().numpy()
    per_forward = sum(g["count"] for g in k6["geoms"])
    if launches != per_forward or per_forward != 13:
        fail(f"fused_eval_apply launched K6 {launches} times, expected 13")
    if fused.shape != served.shape or not np.isfinite(fused).all():
        fail(f"fused logits {fused.shape} or non-finite")
    err, differ, bad = _margin_rule(fused, served)
    scale = float(np.abs(served).max())
    agree = 1 - len(differ) / SERVE_BATCH
    log(f"[resnet-serve] fused_eval_apply on the same variables and "
        f"{SERVE_BATCH} images: K6 launches {launches}; against the served "
        f"logits max|d| {err:.3e} of max|logit| {scale:.3e} (<= "
        f"{FUSED_LOGIT_TOL}), classes agree on {agree:.1%} (>= "
        f"{FUSED_AGREE:.0%}); rows that differ {list(differ)}, beyond the "
        f"margin rule {bad}")
    if err > FUSED_LOGIT_TOL * scale or agree < FUSED_AGREE or bad:
        fail("fused_eval_apply disagrees with the served path")

    forwards = {}
    for arm, fn in (("served", lambda: serv.predict_fn(variables, x)),
                    ("fused", lambda: R.fused_eval_apply(variables, x))):
        with torch.inference_mode():
            ms = cuda_time_ms(fn, iters=5, warmup=1)
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        forwards[arm] = {"ms": ms, "images_per_s": SERVE_BATCH / ms * 1e3,
                         "peak_gib": peak}
    k6_ms = sum(g["count"] * g["ms"] for g in k6["geoms"])
    log(f"[resnet-serve] forward at batch {SERVE_BATCH} (CUDA events): "
        f"served (ResNet.apply, cuDNN) {forwards['served']['ms']:.3f} ms, "
        f"{forwards['served']['images_per_s']:.1f} images/s, peak "
        f"{forwards['served']['peak_gib']:.3f} GiB above the weights; fused "
        f"{forwards['fused']['ms']:.3f} ms, "
        f"{forwards['fused']['images_per_s']:.1f} images/s, peak "
        f"{forwards['fused']['peak_gib']:.3f} GiB, of which K6 {k6_ms:.3f} ms "
        f"({k6_ms / forwards['fused']['ms']:.1%}; 13 launches at phase-2 "
        f"times)")
    return {"launches": launches, "served_k6": served_k6, "wall_s": wall,
            "host_ms": [host_s[i] * 1e3 for i in range(len(rows))],
            "rest_s": rest_s, "job_s": job_s, "forwards": forwards,
            "k6_ms": k6_ms, "fused_err": err, "agree": agree}


# -- phase 8: data parallel -------------------------------------------------

DP_RANKS = 2
DP_LM_STEPS, DP_RESNET_STEPS = 4, 3
# two ranks of the global batch against one process on all of it: the
# same kernels on the same rows (flash attention and K4/K5 work per row or
# per ghost tile), the gradients reduced in another order and cuBLAS free
# to pick other algorithms for another row count: within 1e-3 of the
# loss and 1e-2 of the grad norm, relative, at every step; the running
# statistics within 1e-2 of each tensor's largest value. (The clip
# rescales by a global norm summed in another order, and lr 0.1 with
# momentum carries that through ghost BN: at 32 px on the CPU, 4 rows a
# half, ResNet's losses part by 4.5e-3 by step 3; at full size on an
# NVIDIA H100 80GB HBM3 at 700.00 W by 2.8e-6, the LM's by 5.5e-6 and
# its grad norm by 5.3e-4, and the statistics by 4.8e-5.)
DP_LOSS_RTOL, DP_GNORM_RTOL, DP_STATS_TOL = 1e-3, 1e-2, 1e-2
DP_TIMEOUT_S = 600


class _Apiserver(threading.Thread):
    """An HTTP server that plays the apiserver for the heartbeat: records
    each PATCH's path and annotations, calls ``on_patch(path,
    annotations)`` before it answers, answers 200."""

    def __init__(self, on_patch=None):
        super().__init__(daemon=True)
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        patches = self.patches = []

        class Handler(BaseHTTPRequestHandler):
            def do_PATCH(self):
                body = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", 0))) or b"{}")
                patches.append((self.path, body.get("metadata", {}).get(
                    "annotations", {})))
                if on_patch is not None:
                    on_patch(*patches[-1])
                data = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def run(self):
        self.server.serve_forever()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


def _capture_states(worker, trainstep) -> dict:
    """Make train() hand its builder and last state out (the runs of this
    phase read the optimizer's shards and the batch statistics)."""
    seen = {}

    class Capture(trainstep.TrainStepBuilder):
        def build(self):
            step = super().build()
            seen["builder"] = self

            def run(state, batch):
                state, m = step(state, batch)
                seen["state"] = state
                return state, m
            return run

    worker.TrainStepBuilder = Capture
    return seen


def _moment_bytes(opt) -> int:
    inner = getattr(opt, "inner", opt)
    return sum(t.numel() * t.element_size() for st in inner.state.values()
               if isinstance(st, dict) for t in st.values()
               if isinstance(t, torch.Tensor) and t.dim() > 0)


def _dp_runs(T) -> dict:
    """The two training runs of phase 8, as train() arguments."""
    return {
        "lm": dict(workload="transformer",
                   workload_kwargs={"cfg": T.TransformerConfig()},
                   kernel_attention="flash", kernel_optimizer="fused_adam",
                   optimizer="adam", learning_rate=TRAIN_LR,
                   global_batch=TRAIN_BATCH, steps=DP_LM_STEPS),
        "resnet": dict(workload="resnet50", workload_kwargs={
            "image_size": IMAGE, "num_classes": CLASSES, "fused": True},
            global_batch=RESNET_BATCH, steps=DP_RESNET_STEPS),
    }


def _dp_train(worker, seen, run: dict, path: str, **kw) -> dict:
    """One run through train(): per-step losses and grad norms (sync_every
    1), the step time, the optimizer's moment bytes, the peak memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    result = worker.train(seed=0, sync_every=1, metrics_path=path,
                          handle_sigterm=False, **run, **kw)
    torch.cuda.synchronize()
    ctx = kw.get("ctx")
    # process k > 0 of a gang writes <stem>.p<k>.jsonl beside the path
    windows = _windows(worker._process_metrics_path(
        path, ctx.process_id if ctx else 0))
    state, builder = seen["state"], seen["builder"]
    stats = state.variables.get("batch_stats", {})
    return {
        "loss": [w["loss"] for w in windows],
        "grad_norm": [w["grad_norm"] for w in windows],
        "step_ms": result.mean_step_time_s * 1e3,
        # over every step, the first included: the window the collectives'
        # events cover
        "step_ms_all": 1e3 * float(np.mean([w["step_time_s"]
                                            for w in windows])),
        "moment_bytes": _moment_bytes(state.opt_state),
        "replicated_bytes": sum(
            state.params[n].numel() * 4 for n, d in builder.layout.items()
            if d is None),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "probe": result.final_metrics.get("param_sqnorm_replicas"),
        "stats": {k: v.cpu().numpy() for k, v in stats.items()},
        "strategy": builder.strategy,
    }


def _dp_rank(rank: int, env: dict, queue) -> None:
    """One rank of phase 8 (a spawned process): the contract env, a gloo
    group on the shared card, the LM and fused ResNet-50 runs through
    train() with the sharded update; launch counts, collective counts and
    device time, per rank."""
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sys.path.insert(0, HERE)
        os.environ.update(env)
        from kubeflow_tpu_torch.models import transformer as T
        from kubeflow_tpu_torch.parallel import collectives
        from kubeflow_tpu_torch.runtime import bootstrap, trainstep, worker
        counters = _all_counters()
        # a beat at every window edge (the reporter's default rate limit
        # is 10 s)
        from_env = worker.HeartbeatReporter.from_env.__func__
        worker.HeartbeatReporter.from_env = classmethod(
            lambda cls, **kw: from_env(cls, interval_s=0.0, **kw))
        seen = _capture_states(worker, trainstep)
        ctx = bootstrap.initialize(device=DEVICE, backend="gloo")
        out = {"device": str(ctx.device), "world": ctx.mesh.size()}
        import tempfile
        try:
            with tempfile.TemporaryDirectory() as tmp:
                for name, run in _dp_runs(T).items():
                    for fn in counters.values():
                        fn.launches = 0
                    collectives.reset_counts()
                    collectives.record_events(True)
                    rec = _dp_train(worker, seen, run,
                                    os.path.join(tmp, f"{name}.jsonl"),
                                    ctx=ctx, weight_update="sharded")
                    collectives.record_events(False)
                    rec["launches"] = {n: fn.launches
                                       for n, fn in counters.items()
                                       if fn.launches}
                    rec["collective_ms"] = collectives.events_ms()
                    rec["calls"] = dict(collectives.calls)
                    rec["host_staged"] = dict(collectives.host_staged)
                    out[name] = rec
        finally:
            bootstrap.shutdown(ctx)
        queue.put((rank, out, None))
    except BaseException:  # noqa: BLE001 - reported to the parent
        queue.put((rank, None, traceback.format_exc()))


def _halves(R, **kw):
    """The fused ResNet-50 spec whose loss is the mean of the two halves'
    (each half its own ghost tiles, stem and strided-block statistics, the
    running statistics the mean of the halves' EMAs): what two ranks of 32
    rows compute, in one process. It runs K4/K5 at 32 rows as the ranks
    do, so it holds the data-parallel step, not the kernels: those are
    held against their plain versions at 32 rows by phase_dp_kernels."""
    spec = R.workload_spec(**kw)
    inner = spec.loss_fn

    def loss_fn(params, variables, batch, rng):
        n = batch["images"].shape[0] // DP_RANKS
        outs = [inner(params, variables,
                      {k: v[i * n:(i + 1) * n] for k, v in batch.items()},
                      rng) for i in range(DP_RANKS)]
        loss = sum(o[0] for o in outs) / DP_RANKS
        aux = {k: sum(o[1][k] for o in outs) / DP_RANKS
               for k in outs[0][1] if k != "variables"}
        stats = [o[1]["variables"]["batch_stats"] for o in outs]
        aux["variables"] = {"batch_stats": {
            k: sum(s[k] for s in stats) / DP_RANKS for k in stats[0]}}
        return loss, aux

    return replace(spec, loss_fn=loss_fn)


def phase_dp_kernels(fo, fbt, fbts, R, recipe, lm_shapes) -> dict:
    """Phase 8's kernels at the shapes one rank gives them, against their
    plain versions: K3 over one rank's table (each LM leaf's block along
    the dimension the sharded update picks, the leaves it cannot split
    whole) and K4/K5 at the five geometries on 32 rows. (K1, K2a and K2b
    at one rank's 4 rows are cases of phase_kernels and phase_k2.)"""
    from kubeflow_tpu_torch.parallel.sharding_rules import weight_update_dim
    shards = {}
    for name, shape in lm_shapes.items():
        d = weight_update_dim(shape, DP_RANKS)
        shards[name] = shape if d is None else \
            shape[:d] + (shape[d] // DP_RANKS,) + shape[d + 1:]
    k3 = phase_k3(fo, recipe, shards, timed=False,
                  label=f" (one rank's shards of {DP_RANKS})")
    k45 = phase_k45(fbt, fbts, R, batch=RESNET_BATCH // DP_RANKS,
                    timed=False)
    return {"k3": k3, "k45": k45["geoms"]}


def phase_nccl(bootstrap, collectives) -> dict:
    """Phase 8a: one rank brought up by initialize() from a one-process
    contract env on the default backend, and the three collectives of
    the sharded step on CUDA tensors through the port's wrappers."""
    import torch.distributed as dist
    env = {"KFTPU_TOPOLOGY": "v5e-1", "KFTPU_NUM_PROCESSES": "1",
           "KFTPU_PROCESS_ID": "0",
           "KFTPU_COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}"}
    ctx = bootstrap.initialize(env)
    try:
        backend = dist.get_backend()
        group = dist.group.WORLD
        collectives.reset_counts()
        x = torch.arange(1024, dtype=torch.float32, device=DEVICE)
        got = {"all_reduce": collectives.all_reduce_(x.clone(), group),
               "reduce_scatter": collectives.reduce_scatter(x, group),
               "all_gather": collectives.all_gather(x, group)}
        torch.cuda.synchronize()
        staged = dict(collectives.host_staged)
    finally:
        bootstrap.shutdown(ctx)
    log(f"[dp] NCCL bring-up: initialize() on a one-process contract -> "
        f"backend {backend}, world 1, device {ctx.device}; all_reduce, "
        f"reduce_scatter_tensor and all_gather_into_tensor on CUDA "
        f"tensors; host-staged calls {staged}")
    if backend != "nccl" or any(staged.values()):
        fail(f"dp: backend {backend}, staged {staged}")
    for op, t in got.items():
        if not t.is_cuda or not torch.equal(t, x):
            fail(f"dp: NCCL {op} at world 1 returned {t[:4]}")
    return {"backend": backend}


def phase_dp(T, R, worker, trainstep, bootstrap, collectives, card,
             per_step_k45) -> dict:
    """Phase 8: the data-parallel path. (a) NCCL at world 1; (b) the
    full-width LM over two ranks that share the card in one gloo group,
    sharded, against one process on the same global batch; (c) fused
    ResNet-50 over two ranks x 32 against one process computing the two
    halves; (d) both ranks' heartbeats PATCHed to a local apiserver; (e)
    per-rank step time, collective device time and peak memory."""
    import tempfile
    nccl = phase_nccl(bootstrap, collectives)
    runs = _dp_runs(T)
    seen = _capture_states(worker, trainstep)
    real_resnet = worker.WORKLOADS["resnet50"]
    ref = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ref["lm"] = _dp_train(worker, seen, runs["lm"],
                                  os.path.join(tmp, "lm.jsonl"),
                                  device=DEVICE, weight_update="replicated")
            worker.WORKLOADS["resnet50"] = lambda **kw: _halves(
                R, depth=50, **kw)
            ref["resnet"] = _dp_train(worker, seen, runs["resnet"],
                                      os.path.join(tmp, "resnet.jsonl"),
                                      device=DEVICE)
    finally:
        worker.WORKLOADS["resnet50"] = real_resnet
        worker.TrainStepBuilder = trainstep.TrainStepBuilder
    seen.clear()
    torch.cuda.empty_cache()
    log(f"[dp] one process (replicated, global batches {TRAIN_BATCH} and "
        f"{RESNET_BATCH}): LM losses {ref['lm']['loss']}, peak "
        f"{ref['lm']['peak_gib']:.2f} GiB; ResNet-50 two halves losses "
        f"{ref['resnet']['loss']}")

    import torch.multiprocessing as mp
    server = _Apiserver()
    server.start()
    port = _free_port()
    spawn = mp.get_context("spawn")
    queue = spawn.Queue()
    procs = [spawn.Process(target=_dp_rank, args=(r, {
        "KFTPU_TOPOLOGY": f"v5e-{DP_RANKS}",
        "KFTPU_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
        "KFTPU_NUM_PROCESSES": str(DP_RANKS), "KFTPU_PROCESS_ID": str(r),
        "KFTPU_POD_NAME": f"dp-worker-{r}", "KFTPU_POD_NAMESPACE": "smoke",
        "KFTPU_APISERVER": server.url}, queue)) for r in range(DP_RANKS)]
    t0 = time.perf_counter()
    ranks, errors = {}, []
    try:
        for p in procs:
            p.start()
        for _ in procs:
            r, out, err = queue.get(timeout=DP_TIMEOUT_S)
            ranks[r] = out
            if err:
                errors.append(f"rank {r}:\n{err}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        server.stop()
    wall = time.perf_counter() - t0
    if errors:
        fail("dp: " + "\n".join(errors))
    log(f"[dp] {DP_RANKS} ranks spawned, brought up from the contract env "
        f"(gloo on {ranks[0]['device']}), both runs done in {wall:.1f}s")

    per_step = {
        "lm": {"flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
               "flash_attention_bwd_dkv": 12, "fused_adam": 1},
        "resnet": per_step_k45}
    steps = {"lm": DP_LM_STEPS, "resnet": DP_RESNET_STEPS}
    result = {"nccl": nccl, "ranks": {}}
    for name in ("lm", "resnet"):
        want = {k: v * steps[name] for k, v in per_step[name].items()}
        for r in range(DP_RANKS):
            rec = ranks[r][name]
            if rec["launches"] != want:
                fail(f"dp {name} rank {r}: launches {rec['launches']}, "
                     f"expected {want}")
            if rec["strategy"] != ("zero2-explicit" if name == "lm"
                                   else "zero2-gspmd"):
                fail(f"dp {name}: strategy {rec['strategy']}")
            worst = {}
            for key, tol in (("loss", DP_LOSS_RTOL),
                             ("grad_norm", DP_GNORM_RTOL)):
                got, exp = np.array(rec[key]), np.array(ref[name][key])
                if got.shape != exp.shape or not np.isfinite(got).all():
                    fail(f"dp {name} rank {r}: {key} {got} vs {exp}")
                worst[key] = float(np.max(np.abs(got - exp) / np.abs(exp))
                                   / tol)
                if worst[key] > 1.0:
                    fail(f"dp {name} rank {r}: {key} {got.tolist()} vs one "
                         f"process {exp.tolist()} (bar {tol} relative)")
            limit = ref[name]["moment_bytes"] // DP_RANKS + \
                2 * rec["replicated_bytes"] if name == "lm" else None
            if limit is not None and rec["moment_bytes"] > limit:
                fail(f"dp lm rank {r}: Adam moments {rec['moment_bytes']} "
                     f"bytes > half of {ref[name]['moment_bytes']} plus the "
                     f"replicated leaves")
            # over every step, as step_ms_all (the init's broadcast apart)
            coll = {k: v / steps[name] for k, v in
                    rec["collective_ms"].items() if k != "broadcast"}
            log(f"[dp] {name} rank {r} | {card} | launches {rec['launches']}"
                f" ({per_step[name]} a step); losses {rec['loss']} (one "
                f"process {ref[name]['loss']}), grad norms "
                f"{rec['grad_norm']} (one process "
                f"{ref[name]['grad_norm']}); largest share of a bar: loss "
                f"{worst['loss']:.3f}, grad norm {worst['grad_norm']:.3f}; "
                f"step "
                f"{rec['step_ms_all']:.1f} ms over all {steps[name]} steps "
                f"({rec['step_ms']:.1f} ms without the first; host clock, "
                f"two ranks sharing one card over gloo: not a scaling "
                f"figure); collectives a step over the same "
                f"{steps[name]} steps {sum(coll.values()):.1f} ms "
                f"({', '.join(f'{k} {v:.1f}' for k, v in coll.items())}; "
                f"CUDA events around each call: the host staging and the "
                f"wait for the other rank included); calls "
                f"{rec['calls']}, host-staged {rec['host_staged']}; "
                f"optimizer moments {rec['moment_bytes']} bytes (one "
                f"process {ref[name]['moment_bytes']}, replicated leaves "
                f"{rec['replicated_bytes']}); peak {rec['peak_gib']:.2f} "
                f"GiB (one process {ref[name]['peak_gib']:.2f})")
            result["ranks"].setdefault(name, []).append(
                {**{k: rec[k] for k in ("loss", "grad_norm", "step_ms",
                                        "step_ms_all", "moment_bytes",
                                        "peak_gib",
                                        "launches", "host_staged")},
                 "collective_ms_per_step": coll, "worst": worst})
    probes = [ranks[r]["lm"]["probe"] for r in range(DP_RANKS)]
    flat = np.array(probes, dtype=np.float64)
    if flat.shape != (DP_RANKS, DP_RANKS) or \
            not np.all(flat == flat[0, 0]):
        fail(f"dp lm: param_sqnorm_replicas disagree: {probes}")
    log(f"[dp] lm param_sqnorm_replicas after the last step, per rank: "
        f"{probes}")
    stats = [ranks[r]["resnet"]["stats"] for r in range(DP_RANKS)]
    worst_stat = 0.0
    for k, v in ref["resnet"]["stats"].items():
        if not np.array_equal(stats[0][k], stats[1][k]):
            fail(f"dp resnet: batch_stats {k} differ across ranks")
        worst_stat = max(worst_stat, float(
            np.abs(stats[0][k] - v).max() / max(np.abs(v).max(), 1e-30)))
    log(f"[dp] resnet batch_stats equal on both ranks; against the one "
        f"process worst {worst_stat:.3e} of a tensor's largest value "
        f"(<= {DP_STATS_TOL})")
    if worst_stat > DP_STATS_TOL:
        fail("dp resnet: batch_stats disagree with one process")

    beats = {}
    for path, ann in server.patches:
        raw = ann.get("kubeflow.org/worker-heartbeat")
        if raw:
            beats.setdefault(path.rsplit("/", 1)[-1], []).append(
                json.loads(raw))
    for r in range(DP_RANKS):
        got = beats.get(f"dp-worker-{r}", [])
        full = [b for b in got if {"step", "lastLoss", "lastGradNorm"}
                <= set(b) and np.isfinite(float(b["lastLoss"]))]
        log(f"[dp] heartbeat dp-worker-{r}: {len(got)} PATCHes, "
            f"{len(full)} with step, lastLoss and lastGradNorm; last "
            f"{got[-1] if got else None}")
        if not full:
            fail(f"dp: no heartbeat with loss from dp-worker-{r}")
    result["heartbeats"] = {k: len(v) for k, v in beats.items()}
    result["wall_s"] = wall
    result["ref_lm"] = {k: ref["lm"][k] for k in ("loss", "grad_norm")}
    return result


# -- phase 9: fault-tolerant training -----------------------------------------

CKPT_STEPS, CKPT_EVERY = 6, 2
# SIGTERM reaches the worker CLI child while it reports step 2, so the
# stop flag is read at the end of step 3: the forced save is step 3
SIGTERM_AT_BEAT = 2
FAULT_STEP, LKG_STEP = 5, 4
SERVE_NEXT_STEP = 8
# a resume (and the rollback) against the uninterrupted run: the same
# kernels on the same data from the same state, so 0 is expected; held to
# 1e-6 of the largest |param|
RESUME_REL_TOL = 1e-6
CKPT_TIMEOUT_S = 600
LM_PER_STEP = {"flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
               "flash_attention_bwd_dkv": 12, "fused_adam": 1}


def worker_cli(argv: list) -> int:
    """Phase 9a's child: the worker CLI (``runtime/worker.py main``) with
    the transformer workload at the default LM's widths (the CLI's
    transformer is the tiny config) and a heartbeat at every window edge
    (its rate limit is 10 s), so the parent's stub apiserver sees each
    step and sends SIGTERM while step 2 is reported."""
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.runtime import worker
    T.TransformerConfig.tiny = classmethod(lambda cls: cls())
    from_env = worker.HeartbeatReporter.from_env.__func__
    worker.HeartbeatReporter.from_env = classmethod(
        lambda cls, **kw: from_env(cls, interval_s=0.0, **kw))
    return worker.main(argv)


def _capture_managers(worker) -> list:
    """Make train() hand out every CheckpointManager it makes (their save
    and restore times)."""
    made = []
    real = worker.CheckpointManager

    class Capture(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    worker.CheckpointManager = Capture
    return made


def _worker_child(ckpt_dir: str, tmp: str, name: str, on_patch=None,
                  extra_args: tuple = (), extra_env=None) -> tuple:
    """Run the worker CLI at full LM width in a subprocess (this script
    with --worker) as pod ``name`` under a local stub apiserver that
    calls ``on_patch(pid, path, annotations)`` on each PATCH; (exit code,
    seconds, the PATCHes). Its output goes to ``<tmp>/<name>.log``."""
    holder = {}
    server = _Apiserver(on_patch=None if on_patch is None else
                        lambda *a: on_patch(holder["pid"], *a))
    server.start()
    env = {**os.environ, **(extra_env or {}), "KFTPU_POD_NAME": name,
           "KFTPU_POD_NAMESPACE": "smoke", "KFTPU_APISERVER": server.url}
    argv = [sys.executable, os.path.join(HERE, "chip_smoke.py"),
            "--worker", "--workload", "transformer", "--device", DEVICE,
            "--steps", str(CKPT_STEPS), "--global-batch", str(TRAIN_BATCH),
            "--learning-rate", str(TRAIN_LR), "--optimizer", "adam",
            "--kernel-attention", "flash", "--kernel-optimizer",
            "fused_adam", "--sync-every", "1", "--checkpoint-dir", ckpt_dir,
            "--checkpoint-every", str(CKPT_EVERY), *extra_args]
    t0 = time.perf_counter()
    try:
        with open(os.path.join(tmp, f"{name}.log"), "w") as f:
            proc = subprocess.Popen(argv, env=env, stdout=f,
                                    stderr=subprocess.STDOUT)
            holder["pid"] = proc.pid
            try:
                rc = proc.wait(timeout=CKPT_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                raise
    finally:
        server.stop()
    return rc, time.perf_counter() - t0, server.patches


def _child_tail(tmp: str, name: str) -> str:
    with open(os.path.join(tmp, f"{name}.log")) as f:
        return f.read()[-4000:]


def _lm_ckpt_run(T) -> dict:
    """The LM of phases 5 and 8 through train(), with checkpoints."""
    return dict(workload="transformer",
                workload_kwargs={"cfg": T.TransformerConfig()},
                kernel_attention="flash", kernel_optimizer="fused_adam",
                optimizer="adam", learning_rate=TRAIN_LR,
                global_batch=TRAIN_BATCH, seed=0, sync_every=1,
                checkpoint_every=CKPT_EVERY, handle_sigterm=False)


def _counted(counters, fn):
    """(fn(), launches of each kernel during it)."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {n: c.launches for n, c in counters.items() if c.launches}


def _expect(launches: dict, per_step: dict, steps: int, what: str) -> None:
    want = {k: v * steps for k, v in per_step.items()}
    if launches != want:
        fail(f"ckpt {what}: launches {launches}, expected {want} "
             f"({steps} steps)")


def _param_delta(chaos, a_dir: str, b_dir: str) -> tuple:
    """(max |Δparam|, max |param|) between the newest intact steps of two
    directories, on the card."""
    a = chaos.final_params(a_dir, device=DEVICE)
    b = chaos.final_params(b_dir, device=DEVICE)
    delta = max(float((a[k] - b[k]).abs().max()) for k in a)
    scale = max(float(v.abs().max()) for v in a.values())
    return delta, scale


def phase_ckpt(counters, T, worker, ckpt_mod, chaos, sentinel,
               ModelRepository, fa, card, tmp) -> dict:
    """Phase 9a-c: preemption, anomaly rollback and serving from the
    trainer's checkpoints, the LM at full width."""
    import signal
    run = _lm_ckpt_run(T)
    made = _capture_managers(worker)
    clean, pre = os.path.join(tmp, "clean"), os.path.join(tmp, "preempted")
    out = {"launches": {}}
    try:
        # -- 9a: the uninterrupted run, then SIGTERM and resume -------------
        res, launches = _counted(counters, lambda: worker.train(
            steps=CKPT_STEPS, checkpoint_dir=clean, device=DEVICE, **run))
        _expect(launches, LM_PER_STEP, CKPT_STEPS, "uninterrupted")
        out["launches"]["uninterrupted"] = launches
        stats = made[-1].save_stats
        out["save"] = {"steps": [st["step"] for st in stats],
                       "bytes": stats[-1]["bytes"]}
        # per save: synchronous (of it, waiting for the previous write),
        # then on the writer thread the host copies landing, the payload
        # write with its fsync, the commit with the manifest; and from
        # the call to committed
        for key in ("sync", "wait", "copy", "write", "commit", "total"):
            out["save"][f"{key}_ms"] = [st[f"{key}_s"] * 1e3 for st in stats]
        step_dir = os.path.join(clean, str(CKPT_STEPS))
        out["save"]["dir_bytes"] = sum(
            os.path.getsize(os.path.join(r, f))
            for r, _d, fs in os.walk(step_dir) for f in fs)
        log(f"[ckpt] {card} | uninterrupted run: {CKPT_STEPS} steps, saves "
            f"at {out['save']['steps']}, ms per save: " + "; ".join(
                f"{k} {[round(v, 1) for v in out['save'][f'{k}_ms']]}"
                for k in ("sync", "wait", "copy", "write", "commit",
                          "total")) +
            f"; {out['save']['bytes']:,} bytes of payload a step "
            f"({out['save']['dir_bytes']:,} in the step directory); "
            f"launches {launches}")

        sent = []

        def sigterm_at_step(pid, path, annotations):
            raw = annotations.get("kubeflow.org/worker-heartbeat")
            if raw and json.loads(raw).get("step") == SIGTERM_AT_BEAT and \
                    not sent:
                sent.append(time.time())
                os.kill(pid, signal.SIGTERM)

        rc, child_s, _patches = _worker_child(pre, tmp, "ckpt-worker-0",
                                              on_patch=sigterm_at_step)
        mgr = ckpt_mod.CheckpointManager(pre)
        latest = mgr.latest_step()
        # a fresh manager reads every payload byte: the verification a
        # resumed worker pays before its restore
        t0 = time.perf_counter()
        verdict = ckpt_mod.CheckpointManager(pre).verify_step(
            latest if latest is not None else -1)
        out["verify_ms"] = (time.perf_counter() - t0) * 1e3
        log(f"[ckpt] {card} | worker CLI child: SIGTERM while it reported "
            f"step "
            f"{SIGTERM_AT_BEAT}, exit {rc} in {child_s:.1f}s; steps on "
            f"disk {mgr.all_steps()}, newest intact {latest} {verdict} "
            f"(the manifest's crc32 pass over the step by a fresh manager "
            f"{out['verify_ms']:.1f} ms)")
        if rc != worker.PREEMPTED_EXIT_CODE or latest != 3 or \
                verdict != (True, "verified"):
            fail(f"ckpt: SIGTERM run exit {rc}, newest step {latest} "
                 f"{verdict} (expected {worker.PREEMPTED_EXIT_CODE}, 3):\n"
                 f"{_child_tail(tmp, 'ckpt-worker-0')}")
        res, launches = _counted(counters, lambda: worker.train(
            steps=CKPT_STEPS, checkpoint_dir=pre, device=DEVICE, **run))
        if res.steps != CKPT_STEPS - 3:
            fail(f"ckpt: the resume executed {res.steps} steps")
        _expect(launches, LM_PER_STEP, res.steps, "resumed")
        out["launches"]["resumed"] = launches
        out["restore_ms"] = made[-1].restore_stats[0]["s"] * 1e3
        delta, scale = _param_delta(chaos, clean, pre)
        out["resume"] = {"delta": delta, "scale": scale}
        log(f"[ckpt] {card} | resumed at step 3 (restore "
            f"{out['restore_ms']:.1f} ms: the payload read memory-mapped "
            f"and copied into the state on the card, after latest_step's "
            f"verification), "
            f"{res.steps} steps executed, launches {launches}; largest "
            f"|dparam| against the uninterrupted run {delta:.3e} (largest "
            f"|param| {scale:.4f}; bar {RESUME_REL_TOL} of it)")
        if not delta <= RESUME_REL_TOL * scale:
            fail("ckpt: the resumed run left the uninterrupted one")
        shutil.rmtree(pre, ignore_errors=True)

        # -- 9b: the numeric anomaly and the LKG rollback -------------------
        anom = os.path.join(tmp, "anomaly")
        fault = {sentinel.NUMERIC_FAULT_ENV: f"nan:{FAULT_STEP}",
                 sentinel.NUMERIC_FAULT_MARK_ENV: os.path.join(tmp, "mark")}
        rc, child_s, patches = _worker_child(
            anom, tmp, "ckpt-worker-1", extra_env=fault,
            extra_args=("--integrity", "--integrity-check-every", "1"))
        posted = [json.loads(a["kubeflow.org/numeric-anomaly"])
                  for _p, a in patches
                  if "kubeflow.org/numeric-anomaly" in a]
        ev = posted[0] if posted else {}
        try:
            with open(os.path.join(anom, ckpt_mod.LKG_MARKER)) as f:
                lkg_marker = json.load(f)["step"]
        except OSError:
            lkg_marker = None
        on_disk = ckpt_mod.CheckpointManager(anom).all_steps()
        log(f"[ckpt] {card} | anomaly run (the worker CLI child): exit {rc} "
            f"in {child_s:.1f}s, evidence posted {posted}, LKG marker "
            f"{lkg_marker}, steps on disk {on_disk}")
        if rc != sentinel.ANOMALY_EXIT_CODE or len(posted) != 1 or \
                ev.get("kind") not in (sentinel.KIND_NAN_LOSS,
                                       sentinel.KIND_NAN_GRAD) or \
                ev.get("step") not in (FAULT_STEP, FAULT_STEP + 1) or \
                ev.get("lkg") != LKG_STEP or lkg_marker != LKG_STEP or \
                max(on_disk) > LKG_STEP:
            fail(f"ckpt: the anomaly run did not trip as expected:\n"
                 f"{_child_tail(tmp, 'ckpt-worker-1')}")
        os.environ.update(fault)
        os.environ[sentinel.RESUME_STEP_ENV] = str(LKG_STEP)
        try:
            back, launches = _counted(counters, lambda: worker.train(
                steps=CKPT_STEPS, checkpoint_dir=anom, device=DEVICE,
                integrity=True, integrity_check_every=1, **run))
        finally:
            for k in (sentinel.RESUME_STEP_ENV, sentinel.NUMERIC_FAULT_ENV,
                      sentinel.NUMERIC_FAULT_MARK_ENV):
                os.environ.pop(k)
        if back.anomaly is not None or back.steps != CKPT_STEPS - LKG_STEP:
            fail(f"ckpt: the rollback run: {back.steps} steps, anomaly "
                 f"{back.anomaly}")
        _expect(launches, LM_PER_STEP, back.steps, "rollback")
        out["launches"]["rollback"] = launches
        delta, scale = _param_delta(chaos, clean, anom)
        out["rollback"] = {"delta": delta, "scale": scale,
                           "evidence": ev}
        log(f"[ckpt] {card} | rollback from LKG {LKG_STEP} (the fault "
            f"has fired, the mark file says): {back.steps} steps, "
            f"launches {launches}; largest |dparam| against the "
            f"uninterrupted run {delta:.3e} (bar {RESUME_REL_TOL} of "
            f"{scale:.4f})")
        if not delta <= RESUME_REL_TOL * scale:
            fail("ckpt: the rolled-back run left the uninterrupted one")
        shutil.rmtree(anom, ignore_errors=True)

        # -- 9c: serving the trainer's checkpoints --------------------------
        repo = ModelRepository()
        served = repo.load("lm", "transformer_lm", checkpoint_dir=clean,
                           attention="flash", device=DEVICE)
        ref = repo.load("lm_ref", "transformer_lm", attention="einsum",
                        device=DEVICE)
        ref.swap(chaos.final_params(clean, device=DEVICE), CKPT_STEPS)
        x = np.random.default_rng(9).integers(
            0, SERVE_VOCAB, (1, SERVE_SEQ)).astype(np.int32)
        fa.flash_attention.launches = 0
        got = served.predict(x)
        k1 = fa.flash_attention.launches
        want = ref.predict(x)
        err = float(np.abs(got["logits"].astype(np.float32) -
                           want["logits"].astype(np.float32)).max())
        top = float(np.abs(want["logits"]).max())
        same = bool(np.array_equal(got["next_token"], want["next_token"]))
        log(f"[ckpt] {card} | served version {served.version} from the "
            f"trainer's "
            f"directory: K1 {k1} launches a forward; logits against an "
            f"einsum forward of final_params max|d| {err:.4f} of max "
            f"{top:.3f} (bar 5e-2 of it), next_token equal {same}")
        if served.version != CKPT_STEPS or k1 != SERVE_LAYERS or \
                err > 5e-2 * top or not same:
            fail("ckpt: serving from the checkpoint directory")
        res, launches = _counted(counters, lambda: worker.train(
            steps=SERVE_NEXT_STEP, checkpoint_dir=clean, device=DEVICE,
            **run))
        _expect(launches, LM_PER_STEP, SERVE_NEXT_STEP - CKPT_STEPS,
                "serving's trainer")
        reloaded = repo.reload("lm")
        log(f"[ckpt] {card} | the trainer saved step {SERVE_NEXT_STEP}: "
            f"reload "
            f"{reloaded}, version {served.version}")
        if not reloaded or served.version != SERVE_NEXT_STEP:
            fail("ckpt: reload did not pick up the newer step")
        out["serve"] = {"k1": k1, "err": err, "top": top,
                        "version": served.version}
        del repo, served, ref
    finally:
        worker.CheckpointManager = ckpt_mod.CheckpointManager
        torch.cuda.empty_cache()
    return out


def _switching(R, after: int, **kw):
    """The fused ResNet-50 spec whose loss is the plain one for ``after``
    steps and then the mean of the two 32-row halves' (_halves): one
    process computing what one process and then two ranks compute."""
    plain, halves = R.workload_spec(**kw), _halves(R, **kw)
    calls = [0]

    def loss_fn(*args):
        calls[0] += 1
        return (plain if calls[0] <= after else halves).loss_fn(*args)

    return replace(plain, loss_fn=loss_fn)


def _ckpt_rank(rank: int, env: dict, lm_dir: str, rn_dir: str,
               queue) -> None:
    """One rank of phase 9d (a spawned process): the LM sharded for 2
    steps, saving at step 2; then fused ResNet-50 resumed from the one
    process's step 2 at degree 2 for step 3."""
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sys.path.insert(0, HERE)
        os.environ.update(env)
        from kubeflow_tpu_torch.models import transformer as T
        from kubeflow_tpu_torch.runtime import bootstrap, worker
        counters = _all_counters()
        ctx = bootstrap.initialize(device=DEVICE, backend="gloo")
        out = {}
        import tempfile
        try:
            with tempfile.TemporaryDirectory() as tmp:
                runs = {"lm": dict(_lm_ckpt_run(T), steps=2,
                                   checkpoint_dir=lm_dir),
                        "resnet": dict(_dp_runs(T)["resnet"], seed=0,
                                       sync_every=1, handle_sigterm=False,
                                       checkpoint_every=CKPT_EVERY,
                                       checkpoint_dir=rn_dir)}
                for name, run in runs.items():
                    path = os.path.join(tmp, f"{name}.jsonl")
                    res, launches = _counted(counters, lambda: worker.train(
                        ctx=ctx, weight_update="sharded", metrics_path=path,
                        **run))
                    windows = _windows(worker._process_metrics_path(
                        path, ctx.process_id))
                    out[name] = {"steps": res.steps, "launches": launches,
                                 "loss": [w["loss"] for w in windows],
                                 "grad_norm": [w["grad_norm"]
                                               for w in windows]}
        finally:
            bootstrap.shutdown(ctx)
        queue.put((rank, out, None))
    except BaseException:  # noqa: BLE001 - reported to the parent
        queue.put((rank, None, traceback.format_exc()))


def _all_counters() -> dict:
    """Every training kernel's wrapper, by name."""
    fa, fo, fbt, fbts = (importlib.import_module(
        f"kubeflow_tpu_torch.ops.{m}") for m in (
            "flash_attention", "fused_adam", "fused_block_train",
            "fused_block_train_spatial"))
    return {"flash_attention_fwd": fa.flash_attention,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "fused_adam": fo.fused_adam,
            "fused_block_train_fwd": fbt.fused_block_train_fwd,
            "fused_block_train_bwd": fbt.fused_block_train_bwd,
            "fused_block_train_spatial_fwd":
                fbts.fused_block_train_spatial_fwd,
            "fused_block_train_spatial_bwd":
                fbts.fused_block_train_spatial_bwd}


def _within(name: str, got: list, ref: list) -> dict:
    """Each step's loss and grad norm against the one-process run, as a
    share of phase 8's bars; fails past one."""
    worst = {}
    for key, tol in (("loss", DP_LOSS_RTOL), ("grad_norm", DP_GNORM_RTOL)):
        g, e = np.array(got[key]), np.array(ref[key])
        if g.shape != e.shape or not np.isfinite(g).all():
            fail(f"ckpt {name}: {key} {g} vs {e}")
        worst[key] = float(np.max(np.abs(g - e) / np.abs(e)) / tol)
        if worst[key] > 1.0:
            fail(f"ckpt {name}: {key} {g.tolist()} vs one process "
                 f"{e.tolist()} (bar {tol} relative)")
    return worst


def phase_ckpt_degree(T, R, worker, ckpt_mod, card, ref_lm, per_step_k45,
                      tmp) -> dict:
    """Phase 9d: restore across a change of degree. The LM from two
    sharded gloo ranks (step 2) to one process (steps 3-4) against phase
    8's one-process run; fused ResNet-50 from one process (steps 1-2) to
    two sharded ranks (step 3) against one process computing the same
    (_switching). A changed global batch refuses the resume."""
    import torch.multiprocessing as mp
    counters = _all_counters()
    lm_dir = os.path.join(tmp, "lm_degree")
    rn_dir = os.path.join(tmp, "resnet_degree")
    runs = _dp_runs(T)
    rn_run = dict(runs["resnet"], seed=0, sync_every=1,
                  handle_sigterm=False)
    out = {}
    # ResNet: the one-process reference, then the degree-1 segment
    real = worker.WORKLOADS["resnet50"]
    path = os.path.join(tmp, "rn_ref.jsonl")
    worker.WORKLOADS["resnet50"] = lambda **kw: _switching(
        R, CKPT_EVERY, depth=50, **kw)
    try:
        worker.train(device=DEVICE, metrics_path=path, **rn_run)
    finally:
        worker.WORKLOADS["resnet50"] = real
    ref_rn = {k: [w[k] for w in _windows(path)]
              for k in ("loss", "grad_norm")}
    path = os.path.join(tmp, "rn_first.jsonl")
    res, rn_launches = _counted(counters, lambda: worker.train(
        device=DEVICE, metrics_path=path, checkpoint_dir=rn_dir,
        checkpoint_every=CKPT_EVERY, **dict(rn_run, steps=CKPT_EVERY)))
    _expect(rn_launches, per_step_k45, CKPT_EVERY, "ResNet degree 1")
    first = {k: [w[k] for w in _windows(path)]
             for k in ("loss", "grad_norm")}
    torch.cuda.empty_cache()

    server_port = _free_port()
    spawn = mp.get_context("spawn")
    queue = spawn.Queue()
    procs = [spawn.Process(target=_ckpt_rank, args=(r, {
        "KFTPU_TOPOLOGY": f"v5e-{DP_RANKS}",
        "KFTPU_COORDINATOR_ADDRESS": f"127.0.0.1:{server_port}",
        "KFTPU_NUM_PROCESSES": str(DP_RANKS), "KFTPU_PROCESS_ID": str(r)},
        lm_dir, rn_dir, queue)) for r in range(DP_RANKS)]
    ranks, errors = {}, []
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        for _ in procs:
            r, got, err = queue.get(timeout=DP_TIMEOUT_S)
            ranks[r] = got
            if err:
                errors.append(f"rank {r}:\n{err}")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        fail("ckpt degree: " + "\n".join(errors))
    wall = time.perf_counter() - t0
    for r in range(DP_RANKS):
        _expect(ranks[r]["lm"]["launches"], LM_PER_STEP, 2,
                f"LM rank {r}")
        _expect(ranks[r]["resnet"]["launches"], per_step_k45, 1,
                f"ResNet rank {r}")
        if ranks[r]["resnet"]["steps"] != 1:
            fail(f"ckpt degree: ResNet rank {r} executed "
                 f"{ranks[r]['resnet']['steps']} steps")
    meta = ckpt_mod.CheckpointManager(lm_dir).run_meta_of(2)
    if meta != {"replicaDegree": DP_RANKS, "globalBatch": TRAIN_BATCH}:
        fail(f"ckpt degree: the ranks' run metadata {meta}")
    lm_run = dict(_lm_ckpt_run(T), checkpoint_dir=lm_dir)
    try:
        worker.train(steps=4, device=DEVICE,
                     **dict(lm_run, global_batch=2 * TRAIN_BATCH))
        fail("ckpt degree: a changed global batch resumed")
    except ckpt_mod.ElasticContractError as e:
        refused = str(e)
    path = os.path.join(tmp, "lm_resumed.jsonl")
    res, launches = _counted(counters, lambda: worker.train(
        steps=4, device=DEVICE, metrics_path=path, **lm_run))
    if res.steps != 2:
        fail(f"ckpt degree: the LM resumed {res.steps} steps")
    _expect(launches, LM_PER_STEP, 2, "LM degree 1")
    lm_after = {k: [w[k] for w in _windows(path)]
                for k in ("loss", "grad_norm")}
    out["launches"] = {"lm_ranks": [ranks[r]["lm"]["launches"]
                                    for r in range(DP_RANKS)],
                       "lm_degree1": launches,
                       "resnet_degree1": rn_launches,
                       "resnet_ranks": [ranks[r]["resnet"]["launches"]
                                        for r in range(DP_RANKS)]}
    out["worst"] = {}
    for r in range(DP_RANKS):
        lm = {k: ranks[r]["lm"][k] + lm_after[k]
              for k in ("loss", "grad_norm")}
        rn = {k: first[k] + ranks[r]["resnet"][k]
              for k in ("loss", "grad_norm")}
        out["worst"][r] = {"lm": _within(f"LM rank {r}", lm, ref_lm),
                           "resnet": _within(f"ResNet rank {r}", rn,
                                             ref_rn)}
        log(f"[ckpt] {card} | degree 2 -> 1 LM (rank {r}'s steps 1-2, then "
            f"one process): losses {lm['loss']} (one process "
            f"{ref_lm['loss']}), grad norms {lm['grad_norm']}; degree 1 -> "
            f"2 ResNet-50 (one process's steps 1-2, then rank {r}): losses "
            f"{rn['loss']} (one process {ref_rn['loss']}); largest share "
            f"of a bar {out['worst'][r]}")
    log(f"[ckpt] {card} | degree change: ranks done in {wall:.1f}s, "
        f"launches "
        f"{out['launches']}; the kernels at these shapes were held to "
        f"their plain versions in phase 2 (K1/K2a/K2b at 8 and 4 rows, K3 "
        f"over the LM's table, K4/K5 at 64 rows) and phase 8 (K3 over one "
        f"rank's shards, K4/K5 at 32 rows); a global batch of "
        f"{2 * TRAIN_BATCH} refused: {refused[:90]}...")
    return out


def _dp_launches(dp: dict, run: str, kernel: str) -> list:
    """Phase 8's launches of ``kernel`` in ``run``, one count per rank."""
    return [r["launches"].get(kernel, 0) for r in dp["ranks"][run]]


def _ckpt_launches(ckpt: dict, degree: dict, kernel: str) -> dict:
    """Phase 9's launches of ``kernel`` by run (0 where it does not run):
    a's uninterrupted and resumed runs, b's rollback run, c's served
    forward (K1), d's two ranks and one process across degrees."""
    runs = {**{k: v.get(kernel, 0) for k, v in ckpt["launches"].items()},
            "lm_ranks": [r.get(kernel, 0)
                         for r in degree["launches"]["lm_ranks"]],
            "lm_degree1": degree["launches"]["lm_degree1"].get(kernel, 0),
            "resnet_degree1":
                degree["launches"]["resnet_degree1"].get(kernel, 0),
            "resnet_ranks": [r.get(kernel, 0)
                             for r in degree["launches"]["resnet_ranks"]]}
    if kernel == "flash_attention_fwd":
        runs["serve"] = ckpt["serve"]["k1"]
    return runs


def _launch_mean(geoms: list, field: str) -> float:
    """A per-geometry time averaged over the launches of one training step
    or one forward (each geometry weighted by its launch count)."""
    return sum(g["count"] * g[field] for g in geoms) / \
        sum(g["count"] for g in geoms)


def main() -> int:
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["--worker"]:
        return worker_cli(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the card only", file=sys.stderr)
        return 2
    try:
        import kubeflow_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    pkg = os.path.dirname(os.path.abspath(kubeflow_tpu_torch.__file__))
    if pkg != os.path.join(HERE, "kubeflow_tpu_torch"):
        print(f"chip_smoke: imported {pkg}, not the checkout's package",
              file=sys.stderr)
        return 2
    import importlib
    build = importlib.import_module("kubeflow_tpu_torch.ops._build")
    fa = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")
    fo = importlib.import_module("kubeflow_tpu_torch.ops.fused_adam")
    fbt = importlib.import_module("kubeflow_tpu_torch.ops.fused_block_train")
    fbts = importlib.import_module(
        "kubeflow_tpu_torch.ops.fused_block_train_spatial")
    fb = importlib.import_module("kubeflow_tpu_torch.ops.fused_block")
    from kubeflow_tpu_torch.models import resnet as R
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.parallel import collectives
    from kubeflow_tpu_torch.runtime import bootstrap, recipe, trainstep, worker
    from kubeflow_tpu_torch.serving import client
    from kubeflow_tpu_torch.serving.batch_predict import run_batch_predict
    from kubeflow_tpu_torch.serving.http_server import ModelServer
    from kubeflow_tpu_torch.serving.servable import ModelRepository

    # the plain versions' f32 matmuls in full f32, as stated tolerances
    # assume (these are PyTorch's defaults, set here explicitly)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    server = None
    try:
        dev = phase_device(build)
        k1 = phase_kernels(fa)
        k2 = phase_k2(fa)
        with torch.device("meta"):
            lm_shapes = {n: p.shape for n, p in T.TransformerLM(
                T.TransformerConfig()).state_dict().items()}
        k3 = phase_k3(fo, recipe, lm_shapes)
        phase_head_dims(fa)
        k45 = phase_k45(fbt, fbts, R)
        k6 = phase_k6(fb, R)

        repo = ModelRepository()
        t0 = time.perf_counter()
        flash = repo.load("lm", "transformer_lm", attention="flash",
                          device=DEVICE)
        flash.max_batch = MAX_BATCH
        einsum = repo.load("lm_einsum", "transformer_lm",
                           attention="einsum", device=DEVICE)
        einsum.max_batch = MAX_BATCH
        einsum.swap(flash.params, 1)          # the same weights
        lm128 = repo.load("lm128", "transformer_lm", attention="flash",
                          max_seq_len=REST_SEQ, device=DEVICE)
        lm128.max_batch = MAX_BATCH
        for s in (flash, einsum, lm128):
            s.warmup([1, 2, 4, 8])
        n_params = sum(p.numel() for p in flash.params.values())
        log(f"[serving] loaded + warmed 3 servables ({n_params / 1e6:.1f}M "
            f"params each) in {time.perf_counter() - t0:.1f}s")
        server = ModelServer(repo, host="127.0.0.1", port=0,
                             max_batch=MAX_BATCH, batching="continuous",
                             sample_every=0)
        server.start()
        serving = phase_serving(fa, server, repo, k1["timings"])
        phase_rest(fa, server, repo, client)
        server.stop()
        server = None
        del repo, flash, einsum, lm128
        torch.cuda.empty_cache()

        counters = {"flash_attention_fwd": fa.flash_attention,
                    "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                    "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
                    "fused_adam": fo.fused_adam}
        per_launch_ms = {
            "flash_attention_fwd": k1["timings"][MAX_BATCH]["ms"],
            "flash_attention_bwd_dq": k2["timings"]["dq_ms"],
            "flash_attention_bwd_dkv": k2["timings"]["dkv_ms"],
            "fused_adam": k3["ms"]}
        train = phase_train(counters, T, worker, recipe, trainstep,
                            per_launch_ms)
        k45_counters = {
            "fused_block_train_fwd": fbt.fused_block_train_fwd,
            "fused_block_train_bwd": fbt.fused_block_train_bwd,
            "fused_block_train_spatial_fwd":
                fbts.fused_block_train_spatial_fwd,
            "fused_block_train_spatial_bwd":
                fbts.fused_block_train_spatial_bwd}
        resnet = phase_resnet(k45_counters, R, worker, trainstep, recipe,
                              k45)
        records = phase_resnet_records(k45_counters, R, worker, recipe,
                                       fbts, resnet["per_step"], dev["card"])
        serve = phase_resnet_serve(fb, R, ModelRepository, ModelServer,
                                   client, run_batch_predict, k6)
        dp_kernels = phase_dp_kernels(fo, fbt, fbts, R, recipe, lm_shapes)
        dp = phase_dp(T, R, worker, trainstep, bootstrap, collectives,
                      dev["card"], resnet["per_step"])
        ckpt_mod = importlib.import_module(
            "kubeflow_tpu_torch.runtime.checkpoint")
        chaos = importlib.import_module("kubeflow_tpu_torch.cluster.chaos")
        sentinel = importlib.import_module(
            "kubeflow_tpu_torch.runtime.sentinel")
        import tempfile
        with tempfile.TemporaryDirectory(prefix="kftpu-ckpt-") as tmp:
            ckpt = phase_ckpt(counters, T, worker, ckpt_mod, chaos,
                              sentinel, ModelRepository, fa, dev["card"],
                              tmp)
            degree = phase_ckpt_degree(T, R, worker, ckpt_mod, dev["card"],
                                       dp["ref_lm"], resnet["per_step"],
                                       tmp)
    except Exception:  # noqa: BLE001 - any phase failure fails the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        if server is not None:
            server.stop()

    t = k1["timings"][MAX_BATCH]
    k2t = k2["timings"]
    train_shape = (f"[{TRAIN_BATCH}, {SERVE_SEQ}, {SERVE_HEADS}, "
                   f"{SERVE_HEAD_DIM}] bf16 causal")
    bwd_src = "kubeflow_tpu_torch/csrc/flash_attention_bwd.cu"
    record = {"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "kubeflow_tpu/ops/flash_attention.py:112",
        "launches": serving["launches"],
        "launches_train": train["launches"]["flash_attention_fwd"],
        "launches_dp": _dp_launches(dp, "lm", "flash_attention_fwd"),
        "launches_ckpt": _ckpt_launches(ckpt, degree, "flash_attention_fwd"),
        "max_abs_err": k1["err"],
        "max_abs_err_dp": k1["err_dp"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "tflops": t["tflops"],
        "shape": f"[{MAX_BATCH}, {SERVE_SEQ}, {SERVE_HEADS}, "
                 f"{SERVE_HEAD_DIM}] bf16 causal",
    }, {
        "name": "flash_attention_bwd_dq",
        "route": "cuda",
        "source": bwd_src,
        "replaces": "kubeflow_tpu/ops/flash_attention.py:196",
        "launches": train["launches"]["flash_attention_bwd_dq"],
        "launches_dp": _dp_launches(dp, "lm", "flash_attention_bwd_dq"),
        "launches_ckpt": _ckpt_launches(ckpt, degree, "flash_attention_bwd_dq"),
        "max_abs_err": k2["err"]["dq"],
        "max_abs_err_dp": k2["err_dp"]["dq"],
        "ms": k2t["dq_ms"],
        "plain_ms": k2t["dq_plain_ms"],
        "bound_ms": k2t["dq_bound"][0],
        "bound_by": k2t["dq_bound"][1],
        "library_ms": k2t["library_ms"],
        "tflops": k2t["dq_tflops"],
        "shape": train_shape,
    }, {
        "name": "flash_attention_bwd_dkv",
        "route": "cuda",
        "source": bwd_src,
        "replaces": "kubeflow_tpu/ops/flash_attention.py:231",
        "launches": train["launches"]["flash_attention_bwd_dkv"],
        "launches_dp": _dp_launches(dp, "lm", "flash_attention_bwd_dkv"),
        "launches_ckpt": _ckpt_launches(ckpt, degree, "flash_attention_bwd_dkv"),
        "max_abs_err": k2["err"]["dkv"],
        "max_abs_err_dp": k2["err_dp"]["dkv"],
        "ms": k2t["dkv_ms"],
        "plain_ms": k2t["dkv_plain_ms"],
        "bound_ms": k2t["dkv_bound"][0],
        "bound_by": k2t["dkv_bound"][1],
        "library_ms": k2t["library_ms"],
        "tflops": k2t["dkv_tflops"],
        "shape": train_shape,
    }, {
        "name": "fused_adam",
        "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/fused_adam.cu",
        "replaces": "kubeflow_tpu/ops/fused_adam.py:62",
        "launches": train["launches"]["fused_adam"],
        "launches_dp": _dp_launches(dp, "lm", "fused_adam"),
        "launches_ckpt": _ckpt_launches(ckpt, degree, "fused_adam"),
        "max_abs_err": k3["err"],
        "max_abs_err_dp": dp_kernels["k3"]["err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound"][0],
        "bound_by": k3["bound"][1],
        "library_ms": k3["library_ms"],
        "graph_ms": k3["device_ms"],
        "update_ms": k3["update_ms"],
        "update_yardstick_ms": k3["yardstick_ms"],
        "shape": f"{len(lm_shapes)} LM parameter tensors, "
                 f"{k3['elements']} f32 elements, one optimizer step "
                 f"with the clip, one launch",
    }]}
    for name, replaces in (
            ("fused_block_train", "kubeflow_tpu/ops/fused_block_train.py"),
            ("fused_block_train_spatial",
             "kubeflow_tpu/ops/fused_block_train_spatial.py")):
        geoms = [g for g in k45["geoms"] if g["name"] == name]
        count = sum(g["count"] for g in geoms)
        for way, line in (("fwd", 207 if "spatial" not in name else 189),
                          ("bwd", 277 if "spatial" not in name else 278)):
            weighted = [(g["count"] * g[f"{way}_bound"][0],
                         g[f"{way}_bound"][1]) for g in geoms]
            record["kernels"].append({
                "name": f"{name}_{way}",
                "route": "cuda",
                "source": "kubeflow_tpu_torch/csrc/fused_block_train.cu",
                "replaces": f"{replaces}:{line}",
                "launches": resnet["runs"]["fused"]["launches"][
                    f"{name}_{way}"],
                # the same count in each run from record shards
                "launches_records": [r["launches"][f"{name}_{way}"]
                                     for r in records["runs"]],
                "launches_dp": _dp_launches(dp, "resnet", f"{name}_{way}"),
                "launches_ckpt": _ckpt_launches(ckpt, degree,
                                                f"{name}_{way}"),
                "max_abs_err": max(g["out_err" if way == "fwd" else "dx_err"]
                                   for g in geoms),
                # one rank's 32 rows (phase 8)
                "max_abs_err_dp": max(
                    g["out_err" if way == "fwd" else "dx_err"]
                    for g in dp_kernels["k45"] if g["name"] == name),
                "ms": _launch_mean(geoms, f"{way}_ms"),
                "plain_ms": _launch_mean(geoms, f"{way}_plain_ms"),
                "bound_ms": sum(w for w, _ in weighted) / count,
                "bound_by": max(weighted)[1],
                # no PyTorch call computes a ghost-BN block
                "library_ms": None,
                "yardstick_ms": _launch_mean(geoms, f"{way}_yardstick_ms"),
                "yardstick": "cuDNN convs + exact batch BN, not the same "
                             "function",
                "shape": "ResNet-50 224 px batch 64 bf16, per launch "
                         "averaged over a step's " + ", ".join(
                             f"{g['count']} x {g['key']}" for g in geoms),
            })
    geoms = k6["geoms"]
    count = sum(g["count"] for g in geoms)
    weighted = [(g["count"] * g["bound"][0], g["bound"][1]) for g in geoms]

    record["kernels"].append({
        "name": "fused_block_eval",
        "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/fused_block.cu",
        "replaces": "kubeflow_tpu/ops/fused_block.py:124",
        "launches": serve["launches"],
        "max_abs_err": max(g["err"] for g in geoms),
        "ms": _launch_mean(geoms, "ms"),
        "plain_ms": _launch_mean(geoms, "plain_ms"),
        "bound_ms": sum(w for w, _ in weighted) / count,
        "bound_by": max(weighted)[1],
        "library_ms": _launch_mean(geoms, "library_ms"),
        "library": "the same block through cuDNN convs and folded affines "
                   "(_xla_block_eval at stride 1)",
        "hgmma": k6["hgmma"],
        "shape": "ResNet-50 224 px batch 64 bf16, per launch averaged over "
                 "a forward's " + ", ".join(
                     f"{g['count']} x {g['key']}" for g in geoms),
    })
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(dev["card"])
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
