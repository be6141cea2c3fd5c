#!/usr/bin/env python3
"""Time variants of the fused Adam kernel (K3) against the tree's on one card.

    python3 tools/k3_variants.py OUT_DIR

Makes one copy of ``kubeflow_tpu_torch/`` and ``chip_smoke.py`` per
variant under OUT_DIR (a directory that ``.gitignore`` lists), each with
``csrc/fused_adam.cu`` patched, builds them all at once, counts the
local-memory loads and stores (LDL, STL) in each build's SASS, and times
one K3 step over the LM's 101 parameter tensors (clip on) from each copy
in its own process, in turns: the tree, then every variant, then the same
in reverse. Each time is the step replayed from a CUDA graph (the device
alone) and through ``FusedAdam.step`` (the host's table building
included), beside ``torch.optim.Adam(fused=True)``. Prints one JSON line
per run.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "kubeflow_tpu_torch/csrc/fused_adam.cu"
PASS = "THREADS * VEC * PER_THREAD"
CHUNK = f"constexpr int CHUNK = {PASS};"
LOOP = "  for (int64_t base = start; base < end; base += CHUNK) {"


def chunks(k: int) -> list:
    """Each block takes k chunks, one pass each."""
    return [(CHUNK, f"constexpr int CHUNK = {PASS} * {k};"),
            (LOOP, LOOP.replace("base += CHUNK", f"base += {PASS}"))]


# name: [(text in the tree's source, its replacement)]
VARIANTS = {
    "tree": [],
    # the same single pass written without a loop
    "no-loop": [(LOOP, "  {\n    const int64_t base = start;")],
    "4-chunks": chunks(4),
    "32-chunks": chunks(32),
    # streaming (evict-first) loads and stores
    "streaming": [
        (f"{x}[u] = *reinterpret_cast<const float4*>(e.{x} + i);",
         f"{x}[u] = __ldcs(reinterpret_cast<const float4*>(e.{x} + i));")
        for x in "pgmv"] + [
        (f"*reinterpret_cast<float4*>(e.{x} + i) = {x}[u];",
         f"__stcs(reinterpret_cast<float4*>(e.{x} + i), {x}[u]);")
        for x in "pmv"],
}

RUN = r"""
import importlib, json, sys, time
import torch
import chip_smoke as cs
from kubeflow_tpu_torch.models import transformer as T
from kubeflow_tpu_torch.runtime import recipe
fo = importlib.import_module("kubeflow_tpu_torch.ops.fused_adam")
with torch.device("meta"):
    shapes = [p.shape for p in T.TransformerLM(
        T.TransformerConfig()).state_dict().values()]
gen = torch.Generator(device="cuda").manual_seed(0)
params = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
for p in params:
    p.grad = torch.randn(p.shape, generator=gen, device="cuda")
opt = fo.FusedAdam(recipe.decay_groups(params, 1e-4), lr=1e-3)
norm = recipe.global_norm([p.grad for p in params])
step = lambda: opt.step(norm=norm, max_norm=1.0)
step_ms = cs.cuda_time_ms(step, iters=20)
torch.cuda.synchronize()
t = time.perf_counter()
for _ in range(20):
    step()
host_ms = (time.perf_counter() - t) / 20 * 1e3
torch.cuda.synchronize()
side = torch.cuda.Stream()
side.wait_stream(torch.cuda.current_stream())
with torch.cuda.stream(side):
    step()
torch.cuda.current_stream().wait_stream(side)
graph = torch.cuda.CUDAGraph()
with torch.cuda.graph(graph):
    step()
graph_ms = cs.cuda_time_ms(graph.replay, iters=20)
copies = [p.detach().clone() for p in params]
for c, p in zip(copies, params):
    c.grad = p.grad
library = torch.optim.Adam(recipe.decay_groups(copies, 1e-4), lr=1e-3,
                           fused=True)
print("RESULT " + json.dumps({
    "graph_ms": graph_ms, "step_ms": step_ms, "host_ms": host_ms,
    "library_ms": cs.cuda_time_ms(library.step, iters=20)}), flush=True)
"""

SASS = r"""
import collections, importlib, json, subprocess
b = importlib.import_module("kubeflow_tpu_torch.ops._build")
lib = b.build_all(["fused_adam"])["fused_adam"]["path"]
tool = b.find_nvcc().replace("nvcc", "cuobjdump")
sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                      text=True).stdout
ops = collections.Counter(
    next(w for w in line.split("*/")[1].split() if not w.startswith("@"))
    .split(".")[0] for line in sass.splitlines()
    if "*/" in line and ";" in line)
print("SASS " + json.dumps({op: ops[op] for op in ("LDL", "STL")}))
"""


def make(out_dir: str, name: str) -> str:
    d = os.path.join(out_dir, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "kubeflow_tpu_torch"),
                    os.path.join(d, "kubeflow_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), d)
    path = os.path.join(d, SRC)
    with open(path, encoding="utf-8") as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: expected one '{old}' in {SRC}")
        text = text.replace(old, new)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return d


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    out_dir = os.path.abspath(sys.argv[1])
    dirs = {n: make(out_dir, n) for n in VARIANTS}
    procs = {n: subprocess.Popen([sys.executable, "-c", SASS], cwd=d,
                                 stdout=subprocess.PIPE, text=True)
             for n, d in dirs.items()}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            print(f"{name} failed to build", file=sys.stderr)
            return 1
        sass = next(json.loads(x[5:]) for x in out.splitlines()
                    if x.startswith("SASS "))
        print(json.dumps({"variant": name, "sass": sass}), flush=True)
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=dirs[name],
                              capture_output=True, text=True, timeout=600)
        result = next((json.loads(x[7:]) for x in proc.stdout.splitlines()
                       if x.startswith("RESULT ")), {"error": proc.stderr[-800:]})
        print(json.dumps({"variant": name, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
