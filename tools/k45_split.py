#!/usr/bin/env python3
"""Split the fused ghost-BN bottleneck's backward (K4/K5) by launch kind on
one card.

    python3 tools/k45_split.py [--root DIR] [--label NAME] [--reps N]

For each stride-1 geometry of ResNet-50 at 224 px, batch 64, with the JAX
package's tiles (as ``chip_smoke.phase_k45`` runs them), times one
backward call and one forward call with CUDA events, then traces ``--reps``
backward calls, and as many forward calls, with ``torch.profiler`` and sums
the device time of their CUDA kernels by kind:

- products: the tensor-core products that write an interior, dx or dres;
- wgrad: the weight-gradient products' split-K partials and their reduce;
- sums: per-ghost sums, their ordered reduces and the finalize kernels;
- elementwise: the da passes, the normalising passes and the output pass;
- seams: the bf16 adds of K5's seam rows into dx.

Where the backward takes the forward's per-ghost statistics (a ``ghost``
keyword), it is given them; a tree without them recomputes. ``--root``
imports ``kubeflow_tpu_torch`` and ``chip_smoke.py`` from another checkout
(for example the parent commit unpacked under a gitignored directory), so
the same script splits both trees. Prints one JSON line per geometry and
writes them all to ``chiprun_out/k45_split_<label>.json``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (kind, substrings of the demangled kernel name), first match wins
KINDS = (
    ("wgrad", ("EpPartial", "reduce_splits")),
    ("sums", ("ghost_sums", "ghost_reduce", "stats_finalize",
              "grad_finalize", "colsum2")),
    ("seams", ("seam_add",)),
    ("elementwise", ("_da_kernel", "out_kernel", "norm_kernel")),
    ("products", ("gemm",)),
)


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def trace(fn, reps: int) -> tuple[dict, dict, dict]:
    """Device ms a call by kind, launches a call by kind, and device ms a
    call by kernel name, over ``reps`` traced calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split, launches, names = {}, {}, {}
    for e in prof.key_averages():
        us = device_us(e)
        if us <= 0:
            continue
        k = kind_of(e.key)
        split[k] = split.get(k, 0.0) + us / 1e3 / reps
        launches[k] = launches.get(k, 0) + e.count // reps
        names[e.key[:160]] = round(us / 1e3 / reps, 4)
    return split, launches, names


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("k45_split: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from kubeflow_tpu_torch.models import resnet as R
    from kubeflow_tpu_torch.ops import fused_block_train as fbt
    from kubeflow_tpu_torch.ops import fused_block_train_spatial as fbts
    if not fbt.__file__.startswith(root):
        print(f"k45_split: imported {fbt.__file__}, not {root}",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for geo in R.stride1_geometries(50, cs.IMAGE):
        h, cin, cmid, cout, proj = (geo[k] for k in
                                    ("h", "cin", "cmid", "cout", "proj"))
        kind, th = R._fused_route(h, h, cin, cmid, cout)
        spatial = kind == "spatial"
        bt = 1 if spatial else fbt.default_tile_bt(cs.RESNET_BATCH, h, h,
                                                   cin, cmid, cout)
        mod, name = (fbts, "fused_block_train_spatial") if spatial else \
            (fbt, "fused_block_train")
        fwd, bwd = getattr(mod, f"{name}_fwd"), getattr(mod, f"{name}_bwd")
        tiles = (bt, th) if spatial else (bt,)
        w = cs._block_weights(gen, cin, cmid, cout, proj)
        x = torch.randn((cs.RESNET_BATCH, h, h, cin), generator=gen,
                        device=dev).to(torch.bfloat16)
        g = torch.randn((cs.RESNET_BATCH, h, h, cout), generator=gen,
                        device=dev).to(torch.bfloat16)
        kw = {}
        if "ghost" in inspect.signature(bwd).parameters:
            kw["ghost"] = fwd(x, w, *tiles)[2]
        fwd_ms = cs.cuda_time_ms(lambda: fwd(x, w, *tiles), iters=5,
                                 warmup=1)
        bwd_ms = cs.cuda_time_ms(lambda: bwd(x, g, w, *tiles, **kw),
                                 iters=5, warmup=1)
        torch.cuda.synchronize()
        split, launches, names = trace(lambda: bwd(x, g, w, *tiles, **kw),
                                       args.reps)
        fsplit, flaunches, fnames = trace(lambda: fwd(x, w, *tiles),
                                          args.reps)
        row = {"label": args.label, "card": card, "key": geo["key"],
               "kernel": name, "count": geo["count"], "tile_bt": bt,
               "tile_h": th or h, "proj": proj, "saved_stats": bool(kw),
               "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
               "traced_ms": sum(split.values()),
               "split_ms": split, "launches": launches, "by_name": names,
               "fwd_split_ms": fsplit, "fwd_launches": flaunches,
               "fwd_by_name": fnames}
        if not split:
            row["note"] = ("torch.profiler recorded no device time; only "
                           "the CUDA-event totals are measured")
        print(json.dumps(row), flush=True)
        rows.append(row)
        del x, g, w, kw
        torch.cuda.empty_cache()
    out = os.path.join(HERE, "chiprun_out", f"k45_split_{args.label}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
