#!/usr/bin/env python3
"""Mutation check of the bf16 flash-attention kernels (K1, K2a, K2b) and
the fused Adam kernel (K3) on one card.

    python3 tools/flash_mutants.py OUT_DIR

Makes one copy of ``kubeflow_tpu_torch/`` and ``chip_smoke.py`` per
mutant under OUT_DIR (a directory that ``.gitignore`` lists, so no mutant
is ever committed), each with one fault written into a CUDA source, and
runs the phases of ``chip_smoke.py`` that hold that kernel from each copy
in its own process, all copies building at once: ``phase_kernels`` (K1)
and ``phase_k2`` (K2a, K2b) for a flash mutant, ``phase_k3`` for a K3
mutant. A mutant is caught when a phase fails its bar; the phases print,
for each case, the largest share of its bar that any value uses. Prints
one JSON line per mutant and exits nonzero if a mutant passes.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = "kubeflow_tpu_torch/csrc/flash_attention_fwd.cu"
BWD = "kubeflow_tpu_torch/csrc/flash_attention_bwd.cu"
ADAM = "kubeflow_tpu_torch/csrc/fused_adam.cu"

# name: (source, text in the bf16 kernel, its faulty replacement)
MUTANTS = {
    # K1: the diagonal tile keeps one key past each row
    "causal-off-by-one": (
        FWD, "else if (causal && col > row)\n                x = NEG_INF;",
        "else if (causal && col > row + 1)\n                x = NEG_INF;"),
    # K1: columns 0 and 1 of the first n8 tile of P swapped in the A
    # fragment of P.V
    "p-columns-swapped": (
        FWD, "pf[n / 2][(n & 1) * 2] = pack2(p0, p1);",
        "pf[n / 2][(n & 1) * 2] = n == 0 ? pack2(p1, p0) : pack2(p0, p1);"),
    # K1: the running-max rescale of O skipped at one softmax step (the
    # first of the second key tile)
    "alpha-skipped-once": (
        FWD, "for (int n = 0; n < NO; ++n) {\n          acc[n][0] *= a_lo;",
        "for (int n = 0; n < NO && (j != 1 || c0 != 0); ++n) {\n"
        "          acc[n][0] *= a_lo;"),
    # K2b: lse read per row of S^T (a key row) instead of per column
    "lse-per-row": (
        BWD, "lse_s[sx][qc] * LOG2E",
        "lse_s[sx][(warp * 16 + g + (e >> 1) * 8) % QB] * LOG2E"),
    # K2a: the diagonal step keeps one key past each row
    "dq-causal-off-by-one": (
        BWD, "if (col >= Sk || (causal && col > row)) p = 0.f;",
        "if (col >= Sk || (causal && col > row + 1)) p = 0.f;"),
    # K2a: delta of the lo rows read from the next row
    "dq-delta-next-row": (
        BWD, "const float dl_lo = r_lo < Sq ? delta[row_at + r_lo] : 0.f;",
        "const float dl_lo = r_lo < Sq ? delta[row_at + r_lo + 1] : 0.f;"),
    # K2a: columns 0 and 1 of the first n8 tile of dS swapped in the A
    # fragment of dS.K
    "dq-ds-columns-swapped": (
        BWD, "dsf[n / 2][(n & 1) * 2] = pack2(d[0], d[1]);",
        "dsf[n / 2][(n & 1) * 2] = n == 0 ? pack2(d[1], d[0]) : "
        "pack2(d[0], d[1]);"),
    # K3: optax's clip trigger inverted (clips below max_norm, not above)
    "k3-clip-trigger-inverted": (
        ADAM, "const bool clip = norm_ptr != nullptr && !(norm < h.max_norm);",
        "const bool clip = norm_ptr != nullptr && (norm < h.max_norm);"),
}

RUN = """
import importlib, json, sys, traceback
import torch
import chip_smoke as cs
from kubeflow_tpu_torch.models import transformer as T
from kubeflow_tpu_torch.runtime import recipe
torch.backends.cuda.matmul.allow_tf32 = False
fa = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")
fo = importlib.import_module("kubeflow_tpu_torch.ops.fused_adam")
with torch.device("meta"):
    shapes = {n: p.shape for n, p in T.TransformerLM(
        T.TransformerConfig()).state_dict().items()}
phases = {"phase_kernels": lambda: cs.phase_kernels(fa),
          "phase_k2": lambda: cs.phase_k2(fa),
          "phase_k3": lambda: cs.phase_k3(fo, recipe, shapes)}
out = {}
for name in sys.argv[1].split(","):
    try:
        phases[name]()
        out[name] = "passed"
    except AssertionError as e:
        out[name] = f"failed: {e}"
    except Exception as e:
        traceback.print_exc()
        out[name] = f"error: {type(e).__name__}: {e}"
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
             "'kubeflow_tpu_torch.ops._build'); b.build_all(["
             "'flash_attention_fwd', 'flash_attention_bwd', 'fused_adam'])")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=d)
             for d in dirs.values()]
    if any(p.wait() for p in procs):
        print("a mutant failed to build", file=sys.stderr)
        return 1
    escaped = []
    for name, d in dirs.items():
        phases = "phase_k3" if MUTANTS[name][0] == ADAM else \
            "phase_kernels,phase_k2"
        proc = subprocess.run([sys.executable, "-c", RUN, phases], cwd=d,
                              capture_output=True, text=True, timeout=900)
        lines = proc.stdout.splitlines()
        for line in lines:
            if line.startswith("[kernels]") and (
                    "MISMATCH" in line or "time" not in line):
                print(f"  {name} {line}")
        result = next((json.loads(x[7:]) for x in lines
                       if x.startswith("RESULT ")), {"error": proc.stderr})
        caught = any(str(v).startswith("failed") for v in result.values())
        print(json.dumps({"mutant": name, "caught": caught, **result}),
              flush=True)
        if not caught:
            escaped.append(name)
    return 1 if escaped else 0


if __name__ == "__main__":
    sys.exit(main())
