#!/usr/bin/env python3
"""Mutation check of the fused ghost-BN bottleneck's backward (K4/K5) on one
card.

    python3 tools/k45_mutants.py OUT_DIR

Makes one copy of ``kubeflow_tpu_torch/`` and ``chip_smoke.py`` per
mutant under OUT_DIR (a directory that ``.gitignore`` lists, so no mutant
is ever committed), each with one fault written into a CUDA source, builds
every copy's ``fused_block_train.cu`` at once, and runs
``chip_smoke.phase_k45`` (the five stride-1 geometries of ResNet-50 at
224 px, batch 64) from each copy in its own process. A mutant is caught
when the phase fails a bar; the phase prints, for each geometry, the
largest share of a bar that it uses and which bar, and this script prints
that share at the first geometry that fails. Prints one JSON line per
mutant and exits nonzero if a mutant passes.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEMM = "kubeflow_tpu_torch/csrc/tc_gemm.cuh"
BLOCK = "kubeflow_tpu_torch/csrc/fused_block_train.cu"

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
try:
    cs.phase_k45(fbt, fbts, R)
    out = {"phase_k45": "passed"}
except AssertionError as e:
    out = {"phase_k45": f"failed: {e}"}
except Exception as e:
    traceback.print_exc()
    out = {"phase_k45": f"error: {type(e).__name__}: {e}"}
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
    # build every copy's kernel source at once, then run one at a time
    build = ("import importlib; b = importlib.import_module("
             "'kubeflow_tpu_torch.ops._build'); "
             "b.build_all(['fused_block_train'])")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=d)
             for d in dirs.values()]
    if any(p.wait() for p in procs):
        print("a mutant failed to build", file=sys.stderr)
        return 1
    escaped = []
    for name, d in dirs.items():
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=d,
                              capture_output=True, text=True, timeout=900)
        lines = proc.stdout.splitlines()
        first = next((x for x in lines if x.startswith("[k45]")
                      and "MISMATCH" in x), None)
        share = None
        if first is not None:
            print(f"  {name} {first}")
            tail = first.split("largest share of a bar ")[-1]
            share = tail.split(" MISMATCH")[0]
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
