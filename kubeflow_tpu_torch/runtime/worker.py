"""The worker main: bootstrap → train loop → metrics.

The port of ``kubeflow_tpu/runtime/worker.py`` for one process on one
device. Run as:

    python -m kubeflow_tpu_torch.runtime.worker --workload transformer \\
        --optimizer adam --learning-rate 1e-3 --kernel-attention flash \\
        --kernel-optimizer fused_adam --steps 100

It keeps the JAX worker's flag names and defaults, its ``KFTPU_*`` env
contract and the order in which they resolve (CLI flag, then env, then
the default), the synthetic pool of 4 placed batches and the
``sync_every`` window loop with the lagged metric fetch. It runs on
``cuda`` unless asked for the CPU (``device="cpu"``, ``--device cpu``);
with no card it raises.

Ported workloads: ``transformer`` and ``resnet18`` … ``resnet152``
(``--fused-blocks`` trains a bottleneck ResNet through the ghost-BN
kernels). ``transformer-pipelined``, and the flags of features
not ported yet (checkpoints, AOT warm start, real data, held-out eval
data, the numeric sentinel, multi-slice, the profiler, the worker's
metrics port, TensorBoard), raise "not yet ported" when set — on the CLI,
as a ``train()`` argument or in the operator-rendered env — naming the
ROADMAP item, rather than training without them.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
import uuid
from dataclasses import dataclass, replace
from functools import partial
from typing import Callable, Optional

import torch

from ..api.trainingjob import (ATTENTION_KERNELS, OPTIMIZER_KERNELS,
                               SERVING_KERNELS, WEIGHT_UPDATE_MODES,
                               validate_weight_update)
from ..models import RESNET_DEPTHS
from . import recipe
from .bootstrap import WorkerContext, initialize
from .metrics import METRICS_PATH_ENV, AsyncWindowFetch, MetricsLogger
from .trainstep import TrainStepBuilder

log = logging.getLogger(__name__)

# worker exit status after SIGTERM (EX_TEMPFAIL): restart-eligible, and
# distinguishable from a crash
PREEMPTED_EXIT_CODE = 75


@dataclass
class WorkloadSpec:
    """Everything the loop needs, supplied per-model by the registry."""

    name: str
    init_fn: Callable                      # rng -> (params, variables)
    loss_fn: Callable                      # (params, vars, batch, rng) -> (loss, aux)
    batch_fn: Callable                     # (rng, batch_size) -> batch dict
    rules: Optional[object] = None         # sharding rules: not yet ported
    param_logical_axes: Optional[object] = None
    eval_fn: Optional[Callable] = None     # (params, vars, batch) -> metrics


def _resnet_spec(**kw) -> WorkloadSpec:
    from ..models import resnet as R
    return R.workload_spec(**kw)


def _transformer_spec(**kw) -> WorkloadSpec:
    from ..models import transformer as T
    return T.workload_spec(**kw)


def _not_ported(name: str, item: str, **kw) -> WorkloadSpec:
    raise NotImplementedError(
        f"workload {name!r} is not yet ported (ROADMAP Queue 1 {item})")


WORKLOADS: dict[str, Callable[..., WorkloadSpec]] = {
    # the tf_cnn_benchmarks --model family
    **{f"resnet{d}": partial(_resnet_spec, depth=d) for d in RESNET_DEPTHS},
    "transformer": _transformer_spec,
    "transformer-pipelined": partial(_not_ported, "transformer-pipelined",
                                     "item 11"),
}

# workloads whose spec factory takes a TransformerConfig (cfg=) — the
# kernels.attention tier rewrites cfg.attention for these
_TRANSFORMER_WORKLOADS = {"transformer", "transformer-pipelined"}
# workloads that take image_size / num_classes / label_smoothing
_IMAGE_WORKLOADS = {f"resnet{d}" for d in RESNET_DEPTHS}

# train() arguments of features not ported yet: (its env var, ROADMAP item)
_UNPORTED = {
    "checkpoint_dir": ("KFTPU_CHECKPOINT_DIR", "Queue 1 item 5"),
    "resume_from": ("KFTPU_RESUME_FROM", "Queue 1 item 5"),
    "aot": ("KFTPU_AOT", "Queue 1 item 10"),
    "aot_dir": ("KFTPU_AOT_DIR", "Queue 1 item 10"),
    "data_dir": ("KFTPU_DATA_DIR", "Queue 1 item 8"),
    "eval_data_dir": ("KFTPU_EVAL_DATA_DIR", "Queue 1 item 8"),
    "integrity": ("KFTPU_INTEGRITY", "Queue 1 item 9"),
    "integrity_spike_z": ("KFTPU_INTEGRITY_SPIKE_Z", "Queue 1 item 9"),
    "integrity_window": ("KFTPU_INTEGRITY_WINDOW", "Queue 1 item 9"),
    "integrity_check_every": ("KFTPU_INTEGRITY_CHECK_EVERY",
                              "Queue 1 item 9"),
    "multislice_pipeline": ("KFTPU_MULTISLICE_PIPELINE", "Queue 1 item 11"),
    "multislice_microbatches": ("KFTPU_MULTISLICE_MICROBATCHES",
                                "Queue 1 item 11"),
    "profile_dir": ("KFTPU_PROFILE_DIR", "Queue 1 item 4"),
    "obs_metrics_port": ("KFTPU_OBS_METRICS_PORT", "Queue 1 item 4"),
    "tensorboard_dir": ("KFTPU_TB_DIR", "Queue 1 item 4"),
}


def _refuse_unported(args: dict) -> None:
    """Raise for the first feature that is set (to anything but off) as an
    argument or in the env."""
    for arg, (env, item) in _UNPORTED.items():
        value = args[arg]
        env_value = os.environ.get(env, "")
        if value not in (None, False, 0, "") or env_value not in ("", "0"):
            raise NotImplementedError(
                f"{arg} ({env}) is not yet ported (ROADMAP {item})")


def _env_int(name: str, default: int) -> int:
    """Integer knob from the env, with a loud failure on garbage."""
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {v!r}") from None


@dataclass
class TrainResult:
    steps: int
    examples_per_sec: float
    mean_step_time_s: float
    final_metrics: dict
    preempted: bool = False
    first_window_s: float = 0.0   # the first window: builds + first launches
    # train() entry → first completed step (ends in a device sync); the
    # port has no compile cache or AOT executable, so every start is cold
    time_to_first_step_s: float = 0.0
    start_kind: str = "cold"
    anomaly: Optional[dict] = None   # the sentinel is not yet ported


class PreemptionGuard:
    """SIGTERM-aware stop flag: the loop checks ``stop`` at step
    boundaries, closes its window and exits cleanly."""

    def __init__(self, install: bool = True):
        self.stop = False
        self._prev = None
        if install:
            import signal
            import threading
            if threading.current_thread() is threading.main_thread():
                self._prev = signal.signal(signal.SIGTERM, self._on_term)

    def _on_term(self, signum, frame):
        log.warning("SIGTERM: finishing the step and exiting")
        self.stop = True

    def uninstall(self) -> None:
        if self._prev is not None:
            import signal
            signal.signal(signal.SIGTERM, self._prev)
            self._prev = None


def train(
    workload: str = "resnet50",
    steps: int = 20,
    global_batch: int = 64,
    learning_rate: float = 0.1,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    resume: bool = True,
    resume_from: Optional[str] = None,
    metrics_path: Optional[str] = None,
    profile_dir: Optional[str] = None,
    ctx: Optional[WorkerContext] = None,
    workload_kwargs: Optional[dict] = None,
    seed: int = 0,
    sync_every: int = 10,
    data_dir: Optional[str] = None,
    optimizer: str = "momentum",
    lr_schedule: str = "constant",
    warmup_steps: int = 0,
    weight_decay: float = 0.0,
    momentum: float = 0.9,
    label_smoothing: float = 0.0,
    scale_lr_by_batch: bool = False,
    eval_every: int = 0,
    eval_batches: int = 8,
    eval_data_dir: Optional[str] = None,
    handle_sigterm: bool = True,
    tensorboard_dir: Optional[str] = None,
    weight_update: Optional[str] = None,
    input_workers: Optional[int] = None,
    device_prefetch: Optional[int] = None,
    span_path: Optional[str] = None,
    obs_metrics_port: Optional[int] = None,
    aot: Optional[bool] = None,
    aot_dir: Optional[str] = None,
    multislice_pipeline: Optional[bool] = None,
    multislice_microbatches: Optional[int] = None,
    kernel_attention: Optional[str] = None,
    kernel_optimizer: Optional[str] = None,
    kernel_serving: Optional[str] = None,
    integrity: Optional[bool] = None,
    integrity_spike_z: Optional[float] = None,
    integrity_window: Optional[int] = None,
    integrity_check_every: Optional[int] = None,
    runtime_schedule: Optional[bool] = None,
    device: str = "cuda",
) -> TrainResult:
    t_train_start = time.perf_counter()
    _refuse_unported(locals())
    ctx = ctx or initialize(device=device)
    workload_kwargs = dict(workload_kwargs or {})
    if label_smoothing and workload in _IMAGE_WORKLOADS:
        workload_kwargs.setdefault("label_smoothing", label_smoothing)
    # the input-pipeline knobs drive the real-data feed, which raises
    # above; with the synthetic pool they only need to be valid
    for knob in (input_workers, device_prefetch):
        if knob is not None and knob < 0:
            raise ValueError(f"input_workers ({input_workers}) and "
                             f"device_prefetch ({device_prefetch}) must "
                             f"be >= 0")

    # kernel tier: CLI flag wins, then the operator-rendered env
    # (KFTPU_KERNEL_*), then stock
    ka_set = kernel_attention or os.environ.get("KFTPU_KERNEL_ATTENTION")
    kernel_attention = ka_set or "einsum"
    kernel_optimizer = kernel_optimizer or \
        os.environ.get("KFTPU_KERNEL_OPTIMIZER") or "stock"
    kernel_serving = kernel_serving or \
        os.environ.get("KFTPU_KERNEL_SERVING") or "stock"
    for seg, val, vocab in (
            ("attention", kernel_attention, ATTENTION_KERNELS),
            ("optimizer", kernel_optimizer, OPTIMIZER_KERNELS),
            ("serving", kernel_serving, SERVING_KERNELS)):
        if val not in vocab:
            raise ValueError(f"kernels.{seg} {val!r} not one of {vocab}")
    if ka_set:
        # on any other workload the attention tier would be a silent
        # no-op the user mistakes for a speedup
        if workload not in _TRANSFORMER_WORKLOADS:
            raise ValueError(
                f"kernels.attention applies to transformer workloads, "
                f"not {workload!r}")
        from ..models import transformer as T
        cfg = workload_kwargs.get("cfg") or T.TransformerConfig.tiny()
        workload_kwargs["cfg"] = replace(cfg, attention=kernel_attention)
    log.info("kernel tier: attention=%s optimizer=%s serving=%s",
             kernel_attention, kernel_optimizer, kernel_serving)

    spec = WORKLOADS[workload](**workload_kwargs)
    log.info("worker %d/%d device=%s workload=%s", ctx.process_id,
             ctx.num_processes, ctx.device, spec.name)

    base_lr = recipe.scale_lr(learning_rate, global_batch) \
        if scale_lr_by_batch else learning_rate
    if runtime_schedule is None:
        runtime_schedule = bool(_env_int("KFTPU_RUNTIME_SCHEDULE", 0))
    weight_update = validate_weight_update(
        weight_update or os.environ.get("KFTPU_WEIGHT_UPDATE")
        or "replicated")
    lr_fn = recipe.lr_schedule(lr_schedule, base_lr, steps, warmup_steps)
    builder = TrainStepBuilder(
        loss_fn=spec.loss_fn, device=ctx.device, weight_update=weight_update,
        optimizer=lambda params: recipe.make_optimizer(
            params, optimizer, base_lr, schedule=lr_schedule,
            total_steps=steps, warmup_steps=warmup_steps,
            weight_decay=weight_decay, momentum=momentum,
            kernels=kernel_optimizer, runtime_schedule=runtime_schedule)[0])
    state = builder.init(spec.init_fn, torch.Generator().manual_seed(seed))
    step_fn = builder.build()

    eval_step = builder.build_eval(spec.eval_fn) \
        if eval_every and spec.eval_fn is not None else None

    def run_eval(state) -> dict:
        """Average spec.eval_fn over synthetic held-out batches."""
        gen = torch.Generator().manual_seed(seed + 2)
        n_batches = eval_batches if eval_batches > 0 else 8
        totals: dict = {}
        for _ in range(n_batches):
            em = eval_step(state, builder.place_batch(
                spec.batch_fn(gen, global_batch)))
            for k, v in em.items():
                totals[k] = totals.get(k, 0.0) + float(v)
        out = {k: v / n_batches for k, v in totals.items()}
        if "eval_perplexity" in out and "eval_loss" in out:
            # perplexity = exp(mean loss), not the mean of exp(loss)
            import math
            out["eval_perplexity"] = math.exp(out["eval_loss"])
        return out

    metrics_path = metrics_path or os.environ.get(METRICS_PATH_ENV)
    if metrics_path:
        os.makedirs(os.path.dirname(metrics_path) or ".", exist_ok=True)
    mlog = MetricsLogger(metrics_path, batch_size=global_batch)

    # the synthetic pool: 4 batches placed once and cycled, so batch
    # generation never shares the device with the step
    data_rng = torch.Generator().manual_seed(seed + 1)
    batch_pool = [builder.place_batch(spec.batch_fn(data_rng, global_batch))
                  for _ in range(4)]

    from ..obs.trace import SPAN_PATH_ENV, SpanWriter
    span_path = span_path or os.environ.get(SPAN_PATH_ENV)
    tracer = trace_id = None
    if span_path:
        trace_id = os.environ.get("KFTPU_TRACE_ID") or uuid.uuid4().hex
        tracer = SpanWriter(span_path, "worker")
        tracer.emit("train-start", start=time.time(), trace_id=trace_id,
                    workload=spec.name, steps=steps,
                    process=ctx.process_id)

    start_step = state.step
    last_metrics: dict = {}
    first_step_s = 0.0
    guard = PreemptionGuard(install=handle_sigterm)
    preempted = False
    # the host reads metrics only at window edges, and a window's values
    # a window later (AsyncWindowFetch), so the launch queue never empties
    sync_every = max(1, int(sync_every))
    afetch = AsyncWindowFetch(lag=1)
    try:
        window = 0
        win_t0 = time.perf_counter()
        for step in range(start_step, steps):
            batch = batch_pool[step % len(batch_pool)]
            state, metrics = step_fn(state, batch)
            if step == start_step:
                # one hard sync, once: the startup cost this measures
                if ctx.device.type == "cuda":
                    torch.cuda.synchronize(ctx.device)
                first_step_s = time.perf_counter() - t_train_start
            window += 1
            stopping = guard.stop
            final = step + 1 == steps
            will_eval = eval_step is not None and (
                (step + 1) % eval_every == 0 or final)
            closed = window >= sync_every or final or will_eval or stopping
            if closed:
                t_now = time.perf_counter()
                afetch.submit(step + 1, window, t_now - win_t0,
                              {**metrics, "learning_rate": lr_fn(step)})
                if tracer is not None:
                    now_w = time.time()
                    tracer.emit("window", start=now_w - (t_now - win_t0),
                                end=now_w, trace_id=trace_id,
                                step=step + 1, steps=window)
                for s, w, wall, vals in afetch.drain(
                        force=final or will_eval or stopping):
                    last_metrics = vals
                    mlog.record_window(s, w, wall, vals)
                window = 0
            if stopping:
                preempted = True
                break
            if will_eval:
                em = run_eval(state)
                last_metrics.update(em)
                mlog.event(step + 1, em)
                log.info("eval @%d: %s", step + 1,
                         {k: round(v, 4) for k, v in em.items()})
            if closed:
                win_t0 = time.perf_counter()
    finally:
        guard.uninstall()
        if tracer is not None:
            tracer.emit("train-done", start=time.time(), trace_id=trace_id,
                        step=state.step, preempted=preempted)
            tracer.close()
        mlog.close()
    summary = mlog.summary(warmup=1)
    if preempted:
        log.warning("preempted at step %d; exiting", state.step)
    return TrainResult(
        steps=summary["steps"],
        examples_per_sec=summary["examples_per_sec"],
        mean_step_time_s=summary["mean_step_time_s"],
        final_metrics=last_metrics,
        preempted=preempted,
        first_window_s=summary.get("first_window_s", 0.0),
        time_to_first_step_s=first_step_s,
    )


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, force=True)
    p = argparse.ArgumentParser(description="kubeflow-tpu training worker "
                                            "(PyTorch/CUDA)")
    p.add_argument("--workload", default="resnet50", choices=sorted(WORKLOADS))
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; raises "
                        "without a card)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--global-batch", type=int, default=64)
    p.add_argument("--learning-rate", type=float, default=0.1)
    p.add_argument("--checkpoint-dir")
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--resume-from")
    p.add_argument("--metrics-path")
    p.add_argument("--tensorboard-dir")
    p.add_argument("--profile-dir")
    p.add_argument("--span-path", default=None,
                   help="JSONL sink for trace spans (defaults to "
                        "$KFTPU_SPAN_PATH)")
    p.add_argument("--obs-metrics-port", type=int, default=None)
    p.add_argument("--aot", default=None,
                   action=argparse.BooleanOptionalAction)
    p.add_argument("--aot-dir", default=None)
    p.add_argument("--sync-every", type=int, default=10,
                   help="host-sync (and metric-fetch) interval in steps")
    p.add_argument("--data-dir")
    p.add_argument("--input-workers", type=int, default=None)
    p.add_argument("--device-prefetch", type=int, default=None)
    p.add_argument("--num-microbatches", type=int, default=4,
                   help="GPipe microbatches (pipelined workloads)")
    p.add_argument("--multislice-pipeline", default=None,
                   action=argparse.BooleanOptionalAction)
    p.add_argument("--multislice-microbatches", type=int, default=None)
    p.add_argument("--weight-update", default=None,
                   choices=WEIGHT_UPDATE_MODES,
                   help="optimizer-update layout; defaults to "
                        "$KFTPU_WEIGHT_UPDATE or 'replicated' ('sharded' "
                        "is not yet ported)")
    p.add_argument("--optimizer", default="momentum",
                   choices=recipe.OPTIMIZERS)
    p.add_argument("--lr-schedule", default="constant",
                   choices=recipe.SCHEDULES)
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--scale-lr-by-batch", action="store_true",
                   help="linear-scaling rule: lr *= global_batch/256")
    p.add_argument("--eval-every", type=int, default=0,
                   help="run the eval pass every N steps (0 = off)")
    p.add_argument("--eval-batches", type=int, default=8)
    p.add_argument("--eval-data-dir")
    p.add_argument("--fused-blocks", action="store_true")
    p.add_argument("--fused-tile-bt", type=int, default=0)
    p.add_argument("--kernel-attention", default=None,
                   choices=list(ATTENTION_KERNELS),
                   help="attention kernel tier for transformer workloads "
                        "(default $KFTPU_KERNEL_ATTENTION or einsum)")
    p.add_argument("--kernel-optimizer", default=None,
                   choices=list(OPTIMIZER_KERNELS),
                   help="optimizer kernel tier: fused_adam runs the fused "
                        "CUDA update (requires --optimizer adam; default "
                        "$KFTPU_KERNEL_OPTIMIZER or stock)")
    p.add_argument("--kernel-serving", default=None,
                   choices=list(SERVING_KERNELS))
    p.add_argument("--integrity", default=None,
                   action=argparse.BooleanOptionalAction)
    p.add_argument("--integrity-spike-z", type=float, default=None)
    p.add_argument("--integrity-window", type=int, default=None)
    p.add_argument("--integrity-check-every", type=int, default=None)
    p.add_argument("--runtime-schedule", default=None,
                   action=argparse.BooleanOptionalAction)
    args = p.parse_args(argv)
    workload_kwargs = {}
    if args.workload == "transformer-pipelined":
        workload_kwargs["num_microbatches"] = args.num_microbatches
    if args.fused_blocks:
        if args.workload not in _IMAGE_WORKLOADS or \
                int(args.workload.removeprefix("resnet")) < 50:
            p.error("--fused-blocks applies to bottleneck resnets "
                    "(depth >= 50) only")
        workload_kwargs["fused"] = True
        if args.fused_tile_bt:
            workload_kwargs["fused_tile_bt"] = args.fused_tile_bt
    result = train(
        workload=args.workload, steps=args.steps,
        global_batch=args.global_batch, learning_rate=args.learning_rate,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, resume=not args.no_resume,
        resume_from=args.resume_from,
        metrics_path=args.metrics_path, profile_dir=args.profile_dir,
        span_path=args.span_path, obs_metrics_port=args.obs_metrics_port,
        tensorboard_dir=args.tensorboard_dir,
        workload_kwargs=workload_kwargs, sync_every=args.sync_every,
        data_dir=args.data_dir, input_workers=args.input_workers,
        device_prefetch=args.device_prefetch,
        optimizer=args.optimizer, lr_schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps, weight_decay=args.weight_decay,
        momentum=args.momentum, label_smoothing=args.label_smoothing,
        scale_lr_by_batch=args.scale_lr_by_batch,
        eval_every=args.eval_every, eval_batches=args.eval_batches,
        eval_data_dir=args.eval_data_dir, weight_update=args.weight_update,
        aot=args.aot, aot_dir=args.aot_dir,
        multislice_pipeline=args.multislice_pipeline,
        multislice_microbatches=args.multislice_microbatches,
        kernel_attention=args.kernel_attention,
        kernel_optimizer=args.kernel_optimizer,
        kernel_serving=args.kernel_serving,
        integrity=args.integrity,
        integrity_spike_z=args.integrity_spike_z,
        integrity_window=args.integrity_window,
        integrity_check_every=args.integrity_check_every,
        runtime_schedule=args.runtime_schedule, device=args.device)
    log.info("done: %d steps, %.1f examples/sec", result.steps,
             result.examples_per_sec)
    return PREEMPTED_EXIT_CODE if result.preempted else 0


if __name__ == "__main__":
    raise SystemExit(main())
