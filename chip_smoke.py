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
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(dev["card"])
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
