#!/usr/bin/env python3
"""What the record phase's extras cost the fused ResNet-50 step, on one
card.

    python3 tools/step_overheads.py [--steps N] [--repeats R]

Trains fused ResNet-50 (224 px, 1000 classes, batch 64, the synthetic
pool) through the worker's ``train()`` for ``--steps`` steps at
``sync_every`` 3, once per variant, ``--repeats`` times in turns:

- ``momentum``: ``chip_smoke.py`` phase 6's recipe (lr 0.1);
- ``lars``: phase 6b's (LARS, lr 0.1, cosine with 2 warmup steps, the
  runtime schedule);
- ``lars+tb+port``: with TensorBoard events and the ``/metrics`` port;
- ``lars+tb+port+poll20ms`` and ``+poll250ms``: and a client reading
  ``/flightrecorder`` and ``/metrics`` every 20 ms (phase 6b's profiled
  runs) or 0.25 s (its timed runs).

Then the same ``lars`` run before and after one ``torch.profiler``
capture of 3 steps armed through ``POST /profile``, in this process.
Step times are the worker's (host clock over the windows after the
first). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("step_overheads: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from kubeflow_tpu_torch.runtime import worker
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    tmp = tempfile.mkdtemp()
    lars = dict(optimizer="lars", learning_rate=0.1, lr_schedule="cosine",
                warmup_steps=2, runtime_schedule=True)

    def run(label, steps=args.steps, poll=None, profile=False, **kw):
        poller = None
        if poll or profile:
            kw["obs_metrics_port"] = C._free_port()
            poller = C.ObsPoller(kw["obs_metrics_port"],
                                 C.RECORDS_PROFILE_STEPS if profile else 0,
                                 poll or 0.02)
            os.environ["KFTPU_PROFILE_DIR"] = os.path.join(tmp, label)
            poller.start()
        try:
            r = worker.train(
                workload="resnet50", workload_kwargs={"fused": True},
                global_batch=64, steps=steps, sync_every=3, seed=0,
                handle_sigterm=False, device="cuda", **kw)
        finally:
            if poller is not None:
                poller.halt()
        return r.mean_step_time_s * 1e3

    variants = {
        "momentum": {},
        "lars": lars,
        "lars+tb+port": dict(lars, tensorboard_dir=os.path.join(tmp, "tb"),
                             obs_metrics_port=C._free_port()),
        "lars+tb+port+poll20ms": dict(
            lars, poll=0.02, tensorboard_dir=os.path.join(tmp, "tb")),
        "lars+tb+port+poll250ms": dict(
            lars, poll=0.25, tensorboard_dir=os.path.join(tmp, "tb")),
    }
    step_ms = {name: [] for name in variants}
    for _ in range(args.repeats):
        for name, kw in variants.items():
            step_ms[name].append(run(name, **kw))
    before = run("before", **lars)
    run("capture", steps=12, profile=True, **lars)
    after = run("after", **lars)
    print(json.dumps({"card": card, "steps": args.steps,
                      "step_ms": step_ms,
                      "lars_before_capture_ms": before,
                      "lars_after_capture_ms": after}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
