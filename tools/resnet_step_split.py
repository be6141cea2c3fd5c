#!/usr/bin/env python3
"""Split fused ResNet-50 training steps (or inference forwards) by kernel
family on one card.

    python3 tools/resnet_step_split.py [--root DIR] [--label NAME]
                                       [--steps N] [--batch B] [--eval]

Builds the port's fused ResNet-50 train step (224 px, 1000 classes,
momentum, lr 0.1, seeded weights and batch, as ``chip_smoke.py`` phase 6
trains it), runs two steps to warm up, then traces ``--steps`` steps with
``torch.profiler`` and prints, per step: the wall time (host clock, ending
in a synchronize), the device's busy time (the sum of its kernels' device
time; one stream, so they do not overlap) and its idle share, and the busy
time by family: the fused-block forward and backward kernels (K4/K5 and
their reduces and elementwise passes), the optimizer update, and the rest
(cuDNN convolutions of the stem and the strided blocks, pooling, the head,
copies). ``--root`` imports ``kubeflow_tpu_torch`` from another checkout
(the parent commit unpacked under a gitignored directory), so one call can
split both trees. ``--eval`` traces ``fused_eval_apply`` forwards instead
(224 px, bf16, the model's seeded variables; the fused-block family is
then K6's kernels). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (family, substrings of the demangled kernel name), first match wins
FAMILIES = (
    ("fused blocks", ("wg_gemm_kernel", "tc_gemm_kernel", "ghost_reduce",
                      "stats_finalize", "grad_finalize", "colsum2",
                      "norm_kernel", "_da_kernel", "seam_add",
                      "reduce_splits", "out_kernel", "block_out")),
    ("update", ("multi_tensor", "foreach", "fused_adam", "momentum")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "rest"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--eval", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("resnet_step_split: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models import resnet as R
    from kubeflow_tpu_torch.runtime.recipe import make_optimizer
    from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder
    if not R.__file__.startswith(root):
        print(f"resnet_step_split: imported {R.__file__}, not {root}",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda")
    if args.eval:
        model = R.resnet50(num_classes=1000)
        params, variables = model.init(torch.Generator().manual_seed(0))
        tree = {"params": {k: v.to(dev) for k, v in params.items()},
                "batch_stats": {k: v.to(dev) for k, v in
                                variables["batch_stats"].items()}}
        images = torch.randn((args.batch, 224, 224, 3), generator=torch.
                             Generator().manual_seed(1)).to(dev)

        def run():
            with torch.inference_mode():
                R.fused_eval_apply(tree, images)
    else:
        spec = R.workload_spec(224, 1000, fused=True)
        builder = TrainStepBuilder(
            loss_fn=spec.loss_fn, device=dev,
            optimizer=lambda p: make_optimizer(p, "momentum", 0.1)[0])
        holder = {"state": builder.init(spec.init_fn,
                                        torch.Generator().manual_seed(0))}
        batch = builder.place_batch(spec.batch_fn(
            torch.Generator().manual_seed(1), args.batch))
        step = builder.build()

        def run():
            holder["state"], _ = step(holder["state"], batch)
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    busy, names = {}, {}
    for e in prof.key_averages():
        us = float(getattr(e, "device_time_total", 0.0) or
                   getattr(e, "cuda_time_total", 0.0) or 0.0)
        if us <= 0:
            continue
        fam = family(e.key)
        busy[fam] = busy.get(fam, 0.0) + us / 1e3 / args.steps
        names[e.key[:120]] = round(us / 1e3 / args.steps, 4)
    total = sum(busy.values())
    row = {"label": args.label, "card": card, "batch": args.batch,
           "mode": "fused_eval_apply" if args.eval else "train step",
           "steps": args.steps, "wall_ms": wall_ms, "busy_ms": total,
           "idle_share": 1.0 - total / wall_ms if wall_ms > 0 else None,
           "busy_by_family_ms": busy,
           "top_kernels_ms": dict(sorted(names.items(),
                                         key=lambda kv: -kv[1])[:25])}
    if not busy:
        row["note"] = ("torch.profiler recorded no device time; only the "
                       "wall time is measured")
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
