"""The kubebench reporter, configurator and runner on the port.

The port of the reporter half of ``kubeflow_tpu/workflows/kubebench.py``,
the logic of the kubebench Workflow's containers (kubeflow/kubebench's
configurator → job → csv reporter): the ``KUBEBENCH_*`` env contract,
``configure`` (the experiment directory), ``write_csv_report`` and
``report_from_metrics`` (the finished job's metrics stream, read from
process 0's file, folded into one row), and the in-process runner:
``run_benchmark``, the Katib study over training trials and the
BASELINE config matrix (``CONFIG_MATRIX``, ``benchmark_matrix``), each
through the port's ``runtime/worker.py`` ``train()``. Run as:

    python -m kubeflow_tpu_torch.workflows.kubebench configure
    python -m kubeflow_tpu_torch.workflows.kubebench report --job-kind TFJob
    python -m kubeflow_tpu_torch.workflows.kubebench report --local
    python -m kubeflow_tpu_torch.workflows.kubebench matrix --steps 4 \\
        --global-batch 64

Training runs on ``cuda`` unless asked for the CPU (``device="cpu"``,
``--device cpu``); with no card it raises. A row says which card made it
(``device_kind``, ``chips``) and, for ResNet-50, where its per-card rate
sits against the card's spec sheet and the port's first light
(``utils/chips.py``: ``mfu``, ``vs_baseline``).

``KubebenchJobReconciler`` and ``build_kubebench_workflow`` stay in the
control plane: they expand a KubebenchJob CR into a Workflow through
``controllers/runtime.py`` and ``workflows/engine.py``, the operator loop
that this port of the compute half does not carry. The Workflow's steps
run this module's ``configure`` and ``report``.
"""

from __future__ import annotations

import contextlib
import csv
import gc
import json
import logging
import os
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..runtime.metrics import METRICS_PATH_ENV
from ..utils.chips import BASELINE_IMG_S, device_kind, resnet50_train_mfu

log = logging.getLogger(__name__)

# the reference's env contract, preserved verbatim
ENV_CONFIG_ROOT = "KUBEBENCH_CONFIG_ROOT"
ENV_DATA_ROOT = "KUBEBENCH_DATA_ROOT"
ENV_EXP_ROOT = "KUBEBENCH_EXP_ROOT"
ENV_EXP_ID = "KUBEBENCH_EXP_ID"
ENV_EXP_PATH = "KUBEBENCH_EXP_PATH"


def experiment_paths(env: Optional[dict] = None) -> dict[str, str]:
    env = env if env is not None else dict(os.environ)
    exp_path = env.get(ENV_EXP_PATH) or os.path.join(
        env.get(ENV_EXP_ROOT, "/kubebench/experiments"),
        env.get(ENV_EXP_ID, "exp"))
    return {"exp_path": exp_path,
            "config": env.get(ENV_CONFIG_ROOT, "/kubebench/config"),
            "data": env.get(ENV_DATA_ROOT, "/kubebench/data"),
            "exp_id": env.get(ENV_EXP_ID, "exp")}


def configure(env: Optional[dict] = None) -> str:
    """Configurator step: materialize the experiment directory skeleton
    (the job itself is rendered by the operator, so configure just
    prepares the roots)."""
    paths = experiment_paths(env)
    os.makedirs(paths["exp_path"], exist_ok=True)
    marker = os.path.join(paths["exp_path"], "experiment.json")
    with open(marker, "w") as f:
        json.dump({"id": paths["exp_id"], "created": time.time()}, f)
    return paths["exp_path"]


def write_csv_report(path: str, rows: list[dict[str, Any]]) -> str:
    """The csv-reporter: one row per run, stable header union."""
    if not rows:
        raise ValueError("no rows to report")
    fieldnames: list[str] = []
    for r in rows:
        for k in r:
            if k not in fieldnames:
                fieldnames.append(k)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        for r in rows:
            w.writerow(r)
    return path


def report_from_metrics(metrics_path: str, *, job_kind: str = "TPUJob",
                        warmup: int = 1,
                        env: Optional[dict] = None) -> dict[str, Any]:
    """Aggregate the benchmarked job's metrics JSONL (the worker's
    ``MetricsLogger`` stream, ``runtime/metrics.py`` ``StepStats`` rows and
    event records) into the reporter row: the run that happened, not a
    rerun. A gang's process 0 writes ``metrics_path``, process k
    ``<stem>.p<k><ext>``; the reporter reads process 0's."""
    rows = []
    with open(metrics_path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    if not rows:
        raise ValueError(f"no step records in {metrics_path}")
    # out-of-band event records (eval passes) carry no timing; fold their
    # metrics into the nearest preceding step record and drop the row
    events = [r for r in rows if r.get("event")]
    rows = [r for r in rows if not r.get("event")]
    if not rows:
        raise ValueError(f"no timed step records in {metrics_path}")
    for ev in events:
        # an event earlier than every timed record folds into the FIRST
        # record (nearest by step), not the last
        tgt = max((r for r in rows if r["step"] <= ev.get("step", 0)),
                  key=lambda r: r["step"], default=rows[0])
        tgt.setdefault("metrics", {}).update(ev.get("metrics") or {})
    steady = rows[warmup:] if len(rows) > warmup else rows
    # records may be multi-step windows (worker sync_every): weight by the
    # number of device steps each record covers
    weights = [int(r.get("window", 1)) for r in steady]
    total_w = sum(weights) or 1
    mean_t = sum(r["step_time_s"] * w
                 for r, w in zip(steady, weights)) / total_w
    ex_s = sum(r.get("examples_per_sec", 0.0) * w
               for r, w in zip(steady, weights)) / total_w
    last = rows[-1]
    envd = env if env is not None else dict(os.environ)
    # StepStats.to_dict flattens model metrics alongside the timing fields
    timing_keys = {"step", "step_time_s", "examples_per_sec", "window"}
    model_metrics = dict(last.get("metrics") or {})
    model_metrics.update({k: v for k, v in last.items()
                          if k not in timing_keys and k != "metrics"
                          and isinstance(v, (int, float))})
    return {
        "experiment": envd.get(ENV_EXP_ID, "exp"),
        "job_kind": job_kind,
        "steps": last.get("step", len(rows)),
        "examples_per_sec": round(ex_s, 2),
        "mean_step_time_s": round(mean_t, 6),
        **{f"metric_{k}": round(float(v), 6)
           for k, v in sorted(model_metrics.items())},
    }


def _device_columns(examples_per_sec: float, workload: str, device,
                    chips: int) -> dict[str, Any]:
    """The card that made a matrix row, and for ResNet-50 its per-card
    rate against the spec sheet (MFU) and the port's first light
    (``vs_baseline``). ``examples_per_sec`` is the gang's rate (the
    worker times the global batch), so a card's share is 1/``chips`` of
    it, as the JAX package divides by its device count."""
    per_chip = examples_per_sec / chips
    cols: dict[str, Any] = {"device_kind": device_kind(device),
                            "chips": chips}
    if workload.startswith("resnet50"):
        mfu = resnet50_train_mfu(per_chip, device)
        cols["mfu"] = round(mfu, 4) if mfu is not None else ""
        cols["vs_baseline"] = round(per_chip / BASELINE_IMG_S, 3)
    return cols


def _train(device, **train_kwargs):
    """One ``train()`` and the cards it trained on: the process group's
    world size while the run's context lives, else 1. A ``ctx`` the
    caller passes stays the caller's; otherwise the context comes up here
    from the env contract and goes down after the run, as ``train()``
    would do it itself. The run's memory goes back to the allocator
    before the next run in this process (the matrix and the study run
    one model after another)."""
    from ..runtime import bootstrap, worker
    ctx = train_kwargs.pop("ctx", None)
    owned = ctx is None
    ctx = ctx or bootstrap.initialize(device=device)
    try:
        result = worker.train(ctx=ctx, device=device, **train_kwargs)
        chips = dist.get_world_size() if dist.is_initialized() else 1
    finally:
        if owned:
            bootstrap.shutdown(ctx)
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return result, chips


def run_benchmark(workload: str = "resnet50", steps: int = 10,
                  global_batch: int = 32, report_path: Optional[str] = None,
                  device: str = "cuda", **train_kwargs) -> dict[str, Any]:
    """In-process benchmark: run the real training loop and produce the
    reporter row (the tf-cnn-equivalent vehicle)."""
    result, chips = _train(device, workload=workload, steps=steps,
                           global_batch=global_batch, **train_kwargs)
    label = workload + ("-fused" if (train_kwargs.get("workload_kwargs")
                                     or {}).get("fused") else "")
    row = {
        "experiment": os.environ.get(ENV_EXP_ID, "local"),
        "workload": label,
        "steps": result.steps,
        "global_batch": global_batch,
        "examples_per_sec": round(result.examples_per_sec, 2),
        "mean_step_time_s": round(result.mean_step_time_s, 6),
        "first_window_s": round(result.first_window_s, 3),
        **_device_columns(result.examples_per_sec, label, device, chips),
        **{f"metric_{k}": round(float(v), 6)
           for k, v in result.final_metrics.items()},
    }
    if report_path:
        write_csv_report(report_path, [row])
    return row


def _katib_study_benchmark(steps: int = 3, global_batch: int = 8,
                           trials: int = 2, device: str = "cuda",
                           **train_kwargs) -> dict[str, Any]:
    """In-process Katib study over training trials: the 'StudyJob search
    over TFJob trials' BASELINE config, the random suggestion engine
    drawing each trial's learning rate and the real train loop running
    it (the default workload)."""
    from ..katib.suggestion import ParameterConfig, make_suggestion

    params = [ParameterConfig(name="learning_rate", parametertype="double",
                              min=0.01, max=0.3)]
    sugg = make_suggestion("random", params, seed=0)
    best = None
    for _ in range(trials):
        assignment = sugg.suggest(1)[0]
        lr = float(assignment["learning_rate"])
        result, chips = _train(device, steps=steps,
                               global_batch=global_batch, learning_rate=lr,
                               **train_kwargs)
        loss = result.final_metrics.get("loss", float("inf"))
        sugg.observe(assignment, -loss)  # engine maximizes
        if best is None or loss < best["metric_loss"]:
            best = {"metric_loss": loss, "learning_rate": lr,
                    "examples_per_sec": result.examples_per_sec,
                    "chips": chips}
    return {
        "experiment": os.environ.get(ENV_EXP_ID, "local"),
        "workload": "katib-study/resnet50",
        "steps": steps * trials,
        "global_batch": global_batch,
        "examples_per_sec": round(best["examples_per_sec"], 2),
        "mean_step_time_s": 0.0,
        **_device_columns(best["examples_per_sec"], "katib-study", device,
                          best["chips"]),
        "metric_loss": round(best["metric_loss"], 6),
        "metric_best_learning_rate": round(best["learning_rate"], 6),
    }


# The BASELINE.json config matrix (BASELINE.md "Config matrix to cover").
# Each entry = (job_kind the reference ran it as, runner kwargs); the
# runner is run_benchmark unless the entry names its own callable. Dims
# are the caller's (full size on the card, tiny on the CPU in tests).
CONFIG_MATRIX: dict[str, dict[str, Any]] = {
    # TFJob tf-cnn ResNet-50 (1 chief + 1 worker, CPU — tf_job_simple)
    "tf_job_simple": {"job_kind": "TFJob", "workload": "resnet50"},
    # TFJob data-parallel allreduce (ResNet-50, 8-worker): the worker's
    # data parallelism over every rank of the gang
    "tf_job_dp_allreduce": {"job_kind": "TFJob", "workload": "resnet50"},
    # PyTorchJob DDP equivalent — DDP's allreduce IS the DP update here
    "pytorch_ddp": {"job_kind": "PyTorchJob", "workload": "resnet50"},
    # MPIJob Horovod equivalent — the ring allreduce is the gang's
    "mpi_horovod": {"job_kind": "MPIJob", "workload": "resnet50"},
    # the opt-in ghost-BN fused-block variant (K4/K5): same model FLOPs,
    # fewer HBM bytes
    "tf_job_fused_blocks": {"job_kind": "TFJob", "workload": "resnet50",
                            "workload_kwargs": {"fused": True}},
    # Katib StudyJob search over trials
    "katib_study": {"job_kind": "StudyJob", "runner": "katib"},
}

# the backend switches one config could set and the next would inherit
_BACKEND_FLAGS = ((torch.backends.cudnn, "benchmark"),
                  (torch.backends.cudnn, "deterministic"),
                  (torch.backends.cudnn, "allow_tf32"),
                  (torch.backends.cuda.matmul, "allow_tf32"))


@contextlib.contextmanager
def _switches_kept():
    """One config of the matrix: the backend switches as they were
    before it, whatever it set."""
    saved = [getattr(mod, name) for mod, name in _BACKEND_FLAGS]
    try:
        yield
    finally:
        for (mod, name), value in zip(_BACKEND_FLAGS, saved):
            setattr(mod, name, value)


def benchmark_matrix(out_dir: str, *, steps: int = 5, global_batch: int = 16,
                     configs: Optional[list[str]] = None,
                     device: str = "cuda",
                     **train_kwargs) -> dict[str, dict]:
    """Drive the BASELINE config matrix; one CSV per config (the kubebench
    'one workflow per benchmark' shape). The kernels build once per
    process (``ops/_build.py``), so only the first config that reaches
    one pays for ``nvcc``."""
    os.makedirs(out_dir, exist_ok=True)
    rows = {}
    for name in (configs or list(CONFIG_MATRIX)):
        cfg = dict(CONFIG_MATRIX[name])
        job_kind = cfg.pop("job_kind")
        report = os.path.join(out_dir, f"{name}.csv")
        # a config's workload_kwargs (e.g. fused) merge UNDER the
        # caller's dims (image_size on the CPU) instead of clashing
        kwargs = dict(train_kwargs)
        cfg_wk = cfg.pop("workload_kwargs", None)
        if cfg_wk:
            kwargs["workload_kwargs"] = {**cfg_wk,
                                         **kwargs.get("workload_kwargs", {})}
        with _switches_kept():
            if cfg.pop("runner", None) == "katib":
                row = _katib_study_benchmark(steps=steps,
                                             global_batch=global_batch,
                                             device=device, **kwargs)
            else:
                row = run_benchmark(steps=steps, global_batch=global_batch,
                                    device=device, **cfg, **kwargs)
        row["job_kind"] = job_kind
        write_csv_report(report, [row])
        rows[name] = row
        log.info("config %s (%s): %s", name, job_kind, row)
    return rows


def main(argv: Optional[list[str]] = None) -> int:
    import argparse
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(description="kubebench step entrypoint")
    p.add_argument("step", choices=["configure", "report", "matrix"])
    p.add_argument("--out-dir", default="bench-matrix-torch",
                   help="matrix: directory receiving one CSV per config")
    p.add_argument("--report-type", default="csv")
    p.add_argument("--job-kind", default="TPUJob")
    p.add_argument("--local", action="store_true",
                   help="run the workload in-process instead of reporting "
                        "on a finished job's metrics (dev benchmarking)")
    p.add_argument("--workload", default="resnet50")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--global-batch", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; raises "
                        "where no card is present)")
    args = p.parse_args(argv)
    if args.step == "configure":
        path = configure()
        log.info("experiment configured at %s", path)
        return 0
    if args.step == "matrix":
        rows = benchmark_matrix(args.out_dir, steps=args.steps,
                                global_batch=args.global_batch,
                                device=args.device)
        log.info("matrix complete: %d configs -> %s", len(rows), args.out_dir)
        return 0
    paths = experiment_paths()
    report = os.path.join(paths["exp_path"], "report.csv")
    if args.local:
        row = run_benchmark(workload=args.workload, steps=args.steps,
                            global_batch=args.global_batch,
                            report_path=report, device=args.device)
    else:
        metrics_path = os.path.join(paths["exp_path"], "metrics.jsonl")
        if not os.path.exists(metrics_path):
            log.error("no metrics at %s — did the job run with %s set? "
                      "(use --local for an in-process benchmark)",
                      metrics_path, METRICS_PATH_ENV)
            return 1
        row = report_from_metrics(metrics_path, job_kind=args.job_kind)
        write_csv_report(report, [row])
    log.info("report written to %s: %s", report, row)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
