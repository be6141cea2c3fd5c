#!/usr/bin/env python3
"""Mutation check of the fused ghost-BN bottleneck (K4/K5) and the fused
inference bottleneck (K6) on one card.

    python3 tools/k45_mutants.py OUT_DIR

Makes one copy of ``kubeflow_tpu_torch/`` and ``chip_smoke.py`` per
mutant under OUT_DIR (a directory that
``.gitignore`` lists, so no mutant is ever committed), each with one fault
written into a CUDA source, builds every copy's ``fused_block_train.cu``
and ``fused_block.cu`` at once, and runs ``chip_smoke.phase_k45`` and
``chip_smoke.phase_k6`` (the five stride-1 geometries of ResNet-50 at
224 px, batch 64) from each copy in its own process. A mutant is caught
when a phase fails a bar; the phases print, for each geometry, the share
of their bars that it uses, and this script prints the line of the first
geometry that fails. Prints one JSON line per mutant and exits nonzero if
a mutant passes.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEMM = "kubeflow_tpu_torch/csrc/tc_gemm.cuh"
WGMMA = "kubeflow_tpu_torch/csrc/wgmma_gemm.cuh"
BLOCK = "kubeflow_tpu_torch/csrc/fused_block_train.cu"
EVAL = "kubeflow_tpu_torch/csrc/fused_block.cu"

# name: (source, text in the tree's source, its faulty replacement)
MUTANTS = {
    # the epilogue's per-(tile, ghost segment) partials cut one row late:
    # the first row of each segment that starts inside a tile is summed
    # into the segment before it
    "segment-boundary-off-by-one": (
        GEMM, "int slot = 0, next = (m0 / seg.L + 1) * seg.L - m0;",
        "int slot = 0, next = (m0 / seg.L + 1) * seg.L - m0 + 1;"),
    # BN1's statistic correction applied to the halo rows of da1 too
    "halo-row-interior-correction": (
        BLOCK, "const bool interior = jr >= geo.hal && jr < geo.th + geo.hal;",
        "const bool interior = true;"),
    # the backward's recomputed h1 and h2 normalised with the saved
    # statistics of the neighbouring ghost (g ^ 1)
    "saved-stats-wrong-ghost": (
        BLOCK, "    return stat_row(geo, m, C, haloed);\n",
        "    StatRow r = stat_row(geo, m, C, haloed);\n"
        "    r.so = ((r.so / C) ^ 1) * C;\n"
        "    return r;\n"),
    # the warpgroup product (the forward's and K6's): a gathered row
    # written with the swizzle of its neighbour row, so wgmma reads its
    # chunks from the wrong places
    "gathered-row-neighbour-swizzle": (
        WGMMA, "cp_async16(A + r * 128 + ((c8 ^ (r & 7)) << 4),",
        "cp_async16(A + r * 128 + ((c8 ^ ((r + 1) & 7)) << 4),"),
    # a ring stage handed to the consumers one step early: the gathering
    # producer arrives on a stage's full barrier having waited only for the
    # copies of the step before it
    "ring-stage-released-early": (
        WGMMA, "cp_async_wait<LAG - 1>();", "cp_async_wait<LAG>();"),
    # the forward's output product applies the neighbouring ghost's BN3
    # statistics (g ^ 1)
    "output-neighbour-ghost-bn3": (
        BLOCK, "    ldg8(m3 + key, km3);\n    ldg8(rs3 + key, krs3);\n",
        "    const int64_t nb = ((r.so / C) ^ 1) * C + n;\n"
        "    ldg8(m3 + nb, km3);\n    ldg8(rs3 + nb, krs3);\n"),
    # K6's 3x3 conv reads the row below an image's last row (the next
    # image's first) instead of zero
    "k6-halo-row-not-zeroed": (
        EVAL, "ok = ys >= 0 && ys < H && xs >= 0 && xs < W;",
        "ok = ys >= 0 && ys <= H && xs >= 0 && xs < W;"),
}

RUN = """
import importlib, json, sys, traceback
import torch
import chip_smoke as cs
from kubeflow_tpu_torch.models import resnet as R
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
fbt = importlib.import_module("kubeflow_tpu_torch.ops.fused_block_train")
fbts = importlib.import_module(
    "kubeflow_tpu_torch.ops.fused_block_train_spatial")
fb = importlib.import_module("kubeflow_tpu_torch.ops.fused_block")
out = {}
for name, run in (("phase_k45", lambda: cs.phase_k45(fbt, fbts, R)),
                  ("phase_k6", lambda: cs.phase_k6(fb, R))):
    try:
        run()
        out[name] = "passed"
    except AssertionError as e:
        out[name] = f"failed: {e}"
    except Exception as e:
        traceback.print_exc()
        out[name] = f"error: {type(e).__name__}: {e}"
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out), flush=True)
"""


def make(out_dir: str, name: str) -> str:
    src, old, new = MUTANTS[name]
    d = os.path.join(out_dir, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "kubeflow_tpu_torch"),
                    os.path.join(d, "kubeflow_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), d)
    path = os.path.join(d, src)
    with open(path, encoding="utf-8") as f:
        text = f.read()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: expected one '{old}' in {src}, found "
                         f"{text.count(old)}")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text.replace(old, new))
    return d


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir = os.path.abspath(sys.argv[1])
    dirs = {n: make(out_dir, n) for n in MUTANTS}
    # build every copy's kernel sources at once, then run one at a time
    build = ("import importlib; b = importlib.import_module("
             "'kubeflow_tpu_torch.ops._build'); "
             "b.build_all(['fused_block_train', 'fused_block'])")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=d)
             for d in dirs.values()]
    if any(p.wait() for p in procs):
        print("a mutant failed to build", file=sys.stderr)
        return 1
    escaped = []
    for name, d in dirs.items():
        try:
            proc = subprocess.run([sys.executable, "-c", RUN], cwd=d,
                                  capture_output=True, text=True,
                                  timeout=900)
        except subprocess.TimeoutExpired:
            print(json.dumps({"mutant": name, "caught": False,
                              "error": "timed out"}), flush=True)
            escaped.append(name)
            continue
        lines = proc.stdout.splitlines()
        first = next((x for x in lines if x.startswith(("[k45]", "[k6]"))
                      and "MISMATCH" in x), None)
        share = None
        if first is not None:
            print(f"  {name} {first}")
            if "largest share of a bar " in first:
                tail = first.split("largest share of a bar ")[-1]
                share = tail.split(" MISMATCH")[0]
            else:  # phase_k6: the share beyond its bar
                share = first.split("(|ref| + 1) ")[-1].split(" (<=")[0]
        result = next((json.loads(x[7:]) for x in lines
                       if x.startswith("RESULT ")), {"error": proc.stderr})
        caught = any(str(v).startswith("failed") for v in result.values())
        print(json.dumps({"mutant": name, "caught": caught,
                          "first_failing_share_of_bar": share, **result}),
              flush=True)
        if not caught:
            escaped.append(name)
    return 1 if escaped else 0


if __name__ == "__main__":
    sys.exit(main())
