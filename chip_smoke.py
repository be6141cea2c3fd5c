#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubeflow_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

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
             a ragged S 1000, f32, and with_lse; yardstick sdpa.
             K2a/K2b, the backward (dq; dk and dv): bf16 at the training
             shape [8, 2048, 12, 64] causal, non-causal, ragged S 1000 and
             f32 S 333, on strided slices of a fused qkv tensor;
             yardstick sdpa's backward through torch.autograd.grad.
             K3, the fused Adam update: the LM's 101 parameter tensors for
             3 steps with weight decay on the rank > 1 ones; yardstick
             torch.optim.Adam(fused=True).step().
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
             K3 101 times. Losses finite and falling; then two 3-step runs
             at batch 2 from the same seed, flash + fused_adam against
             einsum + stock, must agree within the stated tolerance.
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

Phase 2 also holds K4 and K5 (the fused ghost-BN bottleneck, batch-tiled
and spatial, csrc/fused_block_train.cu) against their plain versions at
the five stride-1 geometries of ResNet-50 at 224 px, batch 64, bf16, with
the JAX package's tiles: out and the 8 statistics, dx and every weight
gradient against torch.autograd.grad of the plain version, and K5's
seam rows of dx in norm against the backward's own formula in plain
PyTorch (backward_plain, which rounds where the kernel rounds); timed
beside the bound, the plain version and a cuDNN + batch-BN
yardstick (not the same function: library_ms is null, the yardstick's
time is yardstick_ms).
"""

from __future__ import annotations

import json
import os
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


def attention_bound_ms(b, s, h, d, causal, itemsize, products=2,
                       tensors_in=3, tensors_out=1, rows_f32=1) -> tuple:
    """Least time for an attention function on the card: ``products``
    S x S x D matmuls over the unmasked (row, col) pairs at the peak rate
    for the input type, against ``tensors_in`` [B, S, H, D] inputs read
    once and ``tensors_out`` written once in the input type, plus
    ``rows_f32`` f32 [B, H, S] rows (lse, delta). The forward is 2
    products (3 in, 1 out, lse); K2a 3 (s, dp, dq; q k v do in, dq out,
    lse and delta); K2b 4 (s, dp, dv, dk; dk dv out); the whole backward
    5 (s, dp, dq, dk, dv)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2 * products * b * h * d * pairs
    nbytes = (tensors_in + tensors_out) * b * s * h * d * itemsize + \
        rows_f32 * b * h * s * 4
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    return bound_ms(flops, nbytes, peak)


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

    def qkv(b, s, h, d, dtype):
        return tuple(torch.randn((b, s, h, d), generator=gen, device=dev,
                                 dtype=torch.float32).to(dtype)
                     for _ in range(3))

    cases = [  # (label, b, s, causal, dtype)
        ("serving b=1", 1, SERVE_SEQ, True, torch.bfloat16),
        ("serving b=8", MAX_BATCH, SERVE_SEQ, True, torch.bfloat16),
        ("non-causal b=2", 2, SERVE_SEQ, False, torch.bfloat16),
        ("ragged S=1000", 2, 1000, True, torch.bfloat16),
        ("f32 S=333", 2, 333, True, torch.float32),
    ]
    err_at_serving = 0.0
    for label, b, s, causal, dtype in cases:
        q, k, v = qkv(b, s, SERVE_HEADS, SERVE_HEAD_DIM, dtype)
        o, lse = fa.flash_attention(q, k, v, causal=causal, with_lse=True)
        torch.cuda.synchronize()
        p_o, p_lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
        if o.shape != p_o.shape or o.dtype != dtype or \
                lse.shape != (b, SERVE_HEADS, s):
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
        ok = bool((d_o <= limit).all()) and d_lse <= LSE_ATOL
        log(f"[kernels] K1 {label}: max|d o| {d_o.max().item():.3e} "
            f"({tol}), max|d lse| {d_lse:.3e} (<= {LSE_ATOL}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K1 disagrees with its plain version at {label}")
        if label == f"serving b={MAX_BATCH}":
            err_at_serving = d_o.max().item()
        del q, k, v, o, lse, p_o, p_lse, d_o

    timings = {}
    for b in (1, MAX_BATCH):
        q, k, v = qkv(b, SERVE_SEQ, SERVE_HEADS, SERVE_HEAD_DIM,
                      torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        # inputs of 3 x b x 3 MB: at b=8 (75 MB) they exceed the 50 MB L2
        ms = cuda_time_ms(lambda: fa.flash_attention_fwd_cuda(
            q, k, v, causal=True))
        plain_ms = cuda_time_ms(lambda: fa.flash_attention_fwd_plain(
            q, k, v, causal=True), iters=5)
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        bound, by = attention_bound_ms(b, SERVE_SEQ, SERVE_HEADS,
                                       SERVE_HEAD_DIM, True, 2)
        timings[b] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound, "bound_by": by}
        log(f"[kernels] K1 time b={b} S={SERVE_SEQ} H={SERVE_HEADS} "
            f"D={SERVE_HEAD_DIM} bf16 causal: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound:.4f} "
            f"ms ({by}), kernel at {bound / ms:.2%} of bound")
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return {"err": err_at_serving, "timings": timings}


def _k2_close(got, ref, dtype) -> tuple[bool, float]:
    d = (got.float() - ref.float()).abs()
    r = ref.float().abs()
    if dtype == torch.bfloat16:
        ok = bool((d <= K2_BF16_RTOL * r + K2_BF16_FLOOR * r.max()).all())
    else:
        ok = d.max().item() <= K2_F32_TOL * max(1.0, r.max().item())
    return ok, d.max().item()


def phase_k2(fa) -> dict:
    """K2a and K2b against their plain versions on the same inputs (o and
    lse from the plain forward, delta from attention_delta), q, k, v as
    strided slices of one fused qkv tensor, as the model feeds them."""
    F = torch.nn.functional
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    h, d = SERVE_HEADS, SERVE_HEAD_DIM

    def inputs(b, s, causal, dtype):
        qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev).to(
            dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
        o, lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
        return q, k, v, do, lse, fa.attention_delta(o, do)

    cases = [  # (label, b, s, causal, dtype)
        (f"train b={TRAIN_BATCH}", TRAIN_BATCH, SERVE_SEQ, True,
         torch.bfloat16),
        ("non-causal b=2", 2, SERVE_SEQ, False, torch.bfloat16),
        ("ragged S=1000", 2, 1000, True, torch.bfloat16),
        ("f32 S=333", 2, 333, True, torch.float32),
    ]
    errs = {}
    for label, b, s, causal, dtype in cases:
        q, k, v, do, lse, delta = inputs(b, s, causal, dtype)
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
            if g.shape != q.shape or g.dtype != dtype or \
                    not torch.isfinite(g.float()).all():
                fail(f"K2 {label}: {n} {tuple(g.shape)} {g.dtype} or "
                     f"non-finite")
        tol = (f"|d| <= 2^-7|ref| + 2^-8 max|ref|"
               if dtype == torch.bfloat16 else
               f"|d| <= {K2_F32_TOL} max(1, max|ref|)")
        ok = all(r[0] for r in results.values())
        log(f"[kernels] K2 {label}: " + ", ".join(
            f"max|d {n}| {r[1]:.3e}" for n, r in results.items())
            + f" ({tol}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K2 disagrees with its plain version at {label}")
        if label.startswith("train"):
            errs = {"dq": results["dq"][1],
                    "dkv": max(results["dk"][1], results["dv"][1])}
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
    t["dq_bound"] = attention_bound_ms(*args, products=3, tensors_in=4,
                                       tensors_out=1, rows_f32=2)
    t["dkv_bound"] = attention_bound_ms(*args, products=4, tensors_in=4,
                                        tensors_out=2, rows_f32=2)
    whole, _ = attention_bound_ms(*args, products=5, tensors_in=5,
                                  tensors_out=3, rows_f32=1)
    log(f"[kernels] K2 time b={b} S={SERVE_SEQ} H={SERVE_HEADS} "
        f"D={SERVE_HEAD_DIM} bf16 causal: K2a (dq) {t['dq_ms']:.4f} ms "
        f"(plain {t['dq_plain_ms']:.4f}, bound {t['dq_bound'][0]:.4f} ms "
        f"{t['dq_bound'][1]}, {t['dq_bound'][0] / t['dq_ms']:.2%} of it); "
        f"K2b (dk, dv) {t['dkv_ms']:.4f} ms (plain {t['dkv_plain_ms']:.4f}, "
        f"bound {t['dkv_bound'][0]:.4f} ms {t['dkv_bound'][1]}, "
        f"{t['dkv_bound'][0] / t['dkv_ms']:.2%} of it); K2a+K2b "
        f"{t['dq_ms'] + t['dkv_ms']:.4f} ms against the whole backward's "
        f"bound {whole:.4f} ms; sdpa backward {t['library_ms']:.4f} ms")
    del q, k, v, do, lse, delta, qt, kt, vt, out, dot
    torch.cuda.empty_cache()
    return {"err": errs, "timings": t}


def phase_k3(fo, recipe, lm_shapes) -> dict:
    """K3 over the LM's parameter tensors for 3 steps, against the plain
    version updating its own copies with the same gradients."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)
    shapes = list(lm_shapes.values())
    kernel_p = [torch.randn(sh, generator=gen, device=dev) for sh in shapes]
    plain_p = [p.clone() for p in kernel_p]
    plain_mv = [(torch.zeros_like(p), torch.zeros_like(p)) for p in plain_p]

    lr = 1e-3
    opt = fo.FusedAdam(recipe.decay_groups(kernel_p, 1e-4), lr=lr)
    for count in range(3):
        grads = [torch.randn(sh, generator=gen, device=dev) for sh in shapes]
        for p, g in zip(kernel_p, grads):
            p.grad = g
        opt.step()
        bc1, bc2 = fo.bias_corrections(opt.b1, opt.b2, count)
        for p, g, (m, v) in zip(plain_p, grads, plain_mv):
            fo.fused_adam_plain(p, g, m, v, lr=opt.current_lr(),
                                wd=float(np.float32(1e-4)) if p.dim() > 1
                                else 0.0, bc1=bc1, bc2=bc2, b1=opt.b1,
                                b2=opt.b2, eps=opt.eps)
    torch.cuda.synchronize()
    err = 0.0
    for p, q, (m, v) in zip(kernel_p, plain_p, plain_mv):
        st = opt.state[p]
        for a, b in ((p, q), (st["mu"], m), (st["nu"], v)):
            err = max(err, (a - b).abs().max().item())
    n = sum(p.numel() for p in kernel_p)
    ok = err <= K3_ATOL
    log(f"[kernels] K3 {len(shapes)} tensors ({n} elements) x 3 steps, wd "
        f"1e-4 on rank > 1: max|d| over p, m, v {err:.3e} (<= {K3_ATOL}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("K3 disagrees with its plain version")

    ms = cuda_time_ms(opt.step, iters=10)

    def plain_step():
        for p, (m, v) in zip(plain_p, plain_mv):
            fo.fused_adam_plain(p, p.grad, m, v, lr=lr, wd=0.0, bc1=0.1,
                                bc2=0.001, b1=0.9, b2=0.999, eps=1e-8)

    for p, q in zip(plain_p, kernel_p):
        p.grad = q.grad
    plain_ms = cuda_time_ms(plain_step, iters=3, warmup=1)
    library = torch.optim.Adam(recipe.decay_groups(plain_p, 1e-4), lr=lr,
                               fused=True)
    library_ms = cuda_time_ms(library.step, iters=10)
    # read p, g, m, v once and write p, m, v once, in f32; ~15 FLOPs each
    bound = bound_ms(15 * n, 28 * n, PEAK_F32_FLOPS)
    log(f"[kernels] K3 time, one step over {len(shapes)} tensors: kernel "
        f"{ms:.4f} ms ({len(shapes)} launches), plain {plain_ms:.4f} ms, "
        f"torch.optim.Adam(fused=True) {library_ms:.4f} ms, bound "
        f"{bound[0]:.4f} ms ({bound[1]}: {28 * n / 1e9:.2f} GB), kernel at "
        f"{bound[0] / ms:.2%} of bound")
    del kernel_p, plain_p, plain_mv, opt, library
    torch.cuda.empty_cache()
    return {"err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound": bound, "elements": n}


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


def phase_k45(fbt, fbts, R) -> dict:
    """K4 and K5 at the five stride-1 geometries of ResNet-50 at 224 px,
    batch 64, bf16, each with the JAX package's (tile_bt, tile_h): forward
    (out and the 8 statistics) against the plain version, backward (dx and
    every weight gradient) against torch.autograd.grad of the plain
    version, K5's seam rows of dx also against the backward's own formula
    (backward_plain); times beside the bound, the plain version and the
    cuDNN + batch-BN yardstick."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(4)
    results = []
    for geo in R.stride1_geometries(50, IMAGE):
        key, h = geo["key"], geo["h"]
        cin, cmid, cout, proj = geo["cin"], geo["cmid"], geo["cout"], \
            geo["proj"]
        kind, th = R._fused_route(h, h, cin, cmid, cout)
        bt = fbt.default_tile_bt(RESNET_BATCH, h, h, cin, cmid, cout) \
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
        x = torch.randn((RESNET_BATCH, h, h, cin), generator=gen,
                        device=dev).to(torch.bfloat16)
        g = torch.randn((RESNET_BATCH, h, h, cout), generator=gen,
                        device=dev).to(torch.bfloat16)
        out, stats = fwd_k(x, w, *tiles)
        dx, grads = bwd_k(x, g, w, *tiles)
        torch.cuda.synchronize()
        p_out, p_stats = ref_fwd(x, w)
        p_dx, p_grads = ref_bwd(x, g, w)
        d_out = (out.float() - p_out.float()).abs()
        out_share = (d_out > K45_OUT_TOL * (p_out.float().abs() + 1)) \
            .float().mean().item()
        ok_out = out_share <= K45_OUT_OUTLIERS and \
            torch.isfinite(out.float()).all().item()
        stat_err = 0.0
        ok_stats = True
        for a, b in zip(stats, p_stats):
            e = (a - b).abs().max().item()
            stat_err = max(stat_err, e)
            ok_stats &= e <= K45_STAT_TOL * b.abs().max().item() + 1e-5
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
            and all(e[0] for e in grad_errs)
        log(f"[k45] {name} {key} (tile_bt {bt}, tile_h {th or h}, proj "
            f"{proj}): out max|d| {d_out.max().item():.3e}, share beyond "
            f"2^-6 (|ref| + 1) {out_share:.2e} (<= {K45_OUT_OUTLIERS}); "
            f"stats max|d| {stat_err:.3e} (<= 1e-3 max|ref| + 1e-5); dx "
            f"max|d| {dx_err:.3e} of max|ref| "
            f"{p_dx.float().abs().max().item():.3e}, ||d||/||ref|| "
            f"{dx_norm:.2e}, share beyond 2^-5 max|ref| {dx_share:.2e}; "
            f"weight grads ||d||/||ref|| " + ", ".join(
                f"{e[2]:.2e}" for e in grad_errs) + ", shares " + ", ".join(
                f"{e[3]:.1e}" for e in grad_errs)
            + f" (norm <= 2^-5, share <= {K45_GRAD_OUTLIERS}){seam_note} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{name} disagrees with its plain version at {key}")
        del out, stats, dx, grads, p_out, p_stats, p_dx, p_grads

        t = {"key": key, "name": name, "count": geo["count"],
             "tile_bt": bt, "tile_h": th or h, "proj": proj,
             "out_err": d_out.max().item(), "dx_err": dx_err}
        t["fwd_ms"] = cuda_time_ms(lambda: fwd_k(x, w, *tiles), iters=5,
                                   warmup=1)
        t["bwd_ms"] = cuda_time_ms(lambda: bwd_k(x, g, w, *tiles), iters=5,
                                   warmup=1)
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
        m = RESNET_BATCH * h * h
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
            f"{t['bwd_yardstick_ms']:.4f} ms)")
        results.append(t)
        del x, g, w, xs, ws, y_out
        torch.cuda.empty_cache()
    return {"geoms": results}


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
                "fused_adam": None}   # one per parameter tensor
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

    with torch.device("meta"):
        n_tensors = len(T.TransformerLM(cfg).state_dict())
    per_step["fused_adam"] = n_tensors
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

    def update():
        recipe.global_norm([p.grad for p in state.params.values()])
        opt.step()

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


def main() -> int:
    sys.path.insert(0, HERE)
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
    from kubeflow_tpu_torch.models import resnet as R
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.runtime import recipe, trainstep, worker
    from kubeflow_tpu_torch.serving import client
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
        k45 = phase_k45(fbt, fbts, R)

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
            "fused_adam": k3["ms"] / len(lm_shapes)}
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
        "max_abs_err": k1["err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "shape": f"[{MAX_BATCH}, {SERVE_SEQ}, {SERVE_HEADS}, "
                 f"{SERVE_HEAD_DIM}] bf16 causal",
    }, {
        "name": "flash_attention_bwd_dq",
        "route": "cuda",
        "source": bwd_src,
        "replaces": "kubeflow_tpu/ops/flash_attention.py:196",
        "launches": train["launches"]["flash_attention_bwd_dq"],
        "max_abs_err": k2["err"]["dq"],
        "ms": k2t["dq_ms"],
        "plain_ms": k2t["dq_plain_ms"],
        "bound_ms": k2t["dq_bound"][0],
        "bound_by": k2t["dq_bound"][1],
        "library_ms": k2t["library_ms"],
        "shape": train_shape,
    }, {
        "name": "flash_attention_bwd_dkv",
        "route": "cuda",
        "source": bwd_src,
        "replaces": "kubeflow_tpu/ops/flash_attention.py:231",
        "launches": train["launches"]["flash_attention_bwd_dkv"],
        "max_abs_err": k2["err"]["dkv"],
        "ms": k2t["dkv_ms"],
        "plain_ms": k2t["dkv_plain_ms"],
        "bound_ms": k2t["dkv_bound"][0],
        "bound_by": k2t["dkv_bound"][1],
        "library_ms": k2t["library_ms"],
        "shape": train_shape,
    }, {
        "name": "fused_adam",
        "route": "cuda",
        "source": "kubeflow_tpu_torch/csrc/fused_adam.cu",
        "replaces": "kubeflow_tpu/ops/fused_adam.py:62",
        "launches": train["launches"]["fused_adam"],
        "max_abs_err": k3["err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound"][0],
        "bound_by": k3["bound"][1],
        "library_ms": k3["library_ms"],
        "shape": f"{len(lm_shapes)} LM parameter tensors, "
                 f"{k3['elements']} f32 elements, one optimizer step",
    }]}
    for name, replaces in (
            ("fused_block_train", "kubeflow_tpu/ops/fused_block_train.py"),
            ("fused_block_train_spatial",
             "kubeflow_tpu/ops/fused_block_train_spatial.py")):
        geoms = [g for g in k45["geoms"] if g["name"] == name]
        count = sum(g["count"] for g in geoms)

        def per_launch(field, geoms=geoms, count=count):
            # averaged over one training step's launches of this kernel
            return sum(g["count"] * g[field] for g in geoms) / count

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
                "max_abs_err": max(g["out_err" if way == "fwd" else "dx_err"]
                                   for g in geoms),
                "ms": per_launch(f"{way}_ms"),
                "plain_ms": per_launch(f"{way}_plain_ms"),
                "bound_ms": sum(w for w, _ in weighted) / count,
                "bound_by": max(weighted)[1],
                # no PyTorch call computes a ghost-BN block
                "library_ms": None,
                "yardstick_ms": per_launch(f"{way}_yardstick_ms"),
                "yardstick": "cuDNN convs + exact batch BN, not the same "
                             "function",
                "shape": "ResNet-50 224 px batch 64 bf16, per launch "
                         "averaged over a step's " + ", ".join(
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
