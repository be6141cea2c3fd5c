"""The worker main: bootstrap → train loop → metrics.

The port of ``kubeflow_tpu/runtime/worker.py``: one process, or one rank
of a data-parallel gang that the ``KFTPU_*`` topology contract in the env
describes (``runtime/bootstrap.py``: the process group, the mesh, this
rank's card). Run as:

    python -m kubeflow_tpu_torch.runtime.worker --workload transformer \\
        --optimizer adam --learning-rate 1e-3 --kernel-attention flash \\
        --kernel-optimizer fused_adam --steps 100

(add ``--weight-update sharded`` for the ZeRO-2 update across the gang)
or, for ResNet-50 from ImageNet-format record shards:

    python -m kubeflow_tpu_torch.runtime.worker --workload resnet50 \\
        --fused-blocks --data-dir D --eval-data-dir E --eval-every 100 \\
        --eval-batches 0 --optimizer lars --runtime-schedule \\
        --input-workers 2 --device-prefetch 2 --tensorboard-dir T \\
        --obs-metrics-port 9100

It keeps the JAX worker's flag names and defaults, its ``KFTPU_*`` env
contract and the order in which they resolve (CLI flag, then env, then
the default), the synthetic pool of 4 placed batches and the
``sync_every`` window loop with the lagged metric fetch. It runs on
``cuda`` unless asked for the CPU (``device="cpu"``, ``--device cpu``);
with no card it raises.

- Real data: ``data_dir`` streams uint8 records through
  ``data/imagenet.py`` (``input_workers`` spawned augment processes or
  the in-process native augment), stages them on the device through
  ``data/device_prefetch.py`` (``device_prefetch`` batches ahead) and
  normalizes on the device inside the loss. ``eval_data_dir`` evaluates
  over a holdout, padding and masking its short last batch.
- Run records: the flight recorder's per-window host stages, a
  ``torch.profiler`` trace of the run (``profile_dir``) or of the next N
  steps (``POST /profile?steps=N``), TensorBoard scalars
  (``tensorboard_dir``) and ``/metrics`` (``obs_metrics_port``).
- Data parallel: every rank reads the same seeded global batch stream
  (``global_batch`` rows) and copies only its block of rows to its card,
  so a gang sees exactly the samples of one process. TensorBoard events
  come from process 0 only; process k > 0 writes its metrics JSONL
  beside process 0's (``metrics.p<k>.jsonl``), and on a gang whose
  coordinator is this host (one network namespace) serves ``/metrics``
  on the port + k.
- Heartbeat: inside a pod (``KFTPU_POD_NAME``, ``KFTPU_APISERVER``) the
  worker patches its pod's heartbeat annotation at the start and at
  every window edge, with the last window's loss and grad norm.
- Checkpoints (``checkpoint_dir``, ``KFTPU_CHECKPOINT_DIR``;
  runtime/checkpoint.py): resume from the newest intact step (at most
  ``KFTPU_RESUME_STEP``, the LKG, after an anomaly; its newer steps are
  discarded), else from ``resume_from``, checking the elastic contract
  (the global batch fixed across a change of degree); the data stream
  resumes at batch ``state.step``. A save every ``checkpoint_every``
  steps, and a forced one at the final step and under SIGTERM, in the
  same iteration, so a resume loses no step; SIGTERM exits 75.
- Numeric sentinel (``integrity``, ``KFTPU_INTEGRITY*``;
  runtime/sentinel.py): each drained window's loss, grad norm and
  ``param_sqnorm_replicas``; a clean window promotes the newest earlier
  saved step to last-known-good; a trip dumps the flight recorder,
  emits the ``anomaly`` span, posts the evidence to the pod's
  ``ANOMALY_ANNOTATION`` and exits 76 without saving.
- Katib: under ``KFTPU_STUDY`` / ``KFTPU_TRIAL`` / ``KFTPU_VIZIER_URL``
  process 0 reports every final metric and ``examples_per_sec``.

Ported workloads: ``transformer`` and ``resnet18`` … ``resnet152``
(``--fused-blocks`` trains a bottleneck ResNet through the ghost-BN
kernels). ``transformer-pipelined``, and the flags of features
not ported yet (AOT warm start, multi-slice), raise "not yet ported"
when set — on the CLI, as a ``train()`` argument or in the
operator-rendered env — naming the ROADMAP item, rather than training
without them.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time
import uuid
from dataclasses import dataclass, replace
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from ..api.trainingjob import (ATTENTION_KERNELS, OPTIMIZER_KERNELS,
                               SERVING_KERNELS, WEIGHT_UPDATE_MODES,
                               validate_weight_update)
from ..data.imagenet import ImageNetSource, device_normalize, read_meta
from ..models import RESNET_DEPTHS
from ..parallel.mesh import local_batch_size
from . import recipe
from . import sentinel as sentinel_mod
from .bootstrap import WorkerContext, initialize, shutdown
from .checkpoint import CheckpointManager
from .metrics import (FLIGHT_WINDOWS_ENV, METRICS_PATH_ENV, AsyncWindowFetch,
                      FlightRecorder, HeartbeatReporter, MetricsLogger,
                      ProfileArm, profile_trace)
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
    "aot": ("KFTPU_AOT", "Queue 1 item 10"),
    "aot_dir": ("KFTPU_AOT_DIR", "Queue 1 item 10"),
    "multislice_pipeline": ("KFTPU_MULTISLICE_PIPELINE", "Queue 1 item 11"),
    "multislice_microbatches": ("KFTPU_MULTISLICE_MICROBATCHES",
                                "Queue 1 item 11"),
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


def _process_metrics_path(path: str, process_id: int) -> str:
    """Process 0 writes ``path``; process k > 0 ``<stem>.p<k><ext>``."""
    if process_id == 0:
        return path
    stem, ext = os.path.splitext(path)
    return f"{stem}.p{process_id}{ext}"


def _process_port(port: int, ctx: WorkerContext) -> int:
    """The ``/metrics`` port of this process: the given one, or port + k
    for process k of a gang whose coordinator is this host (its ranks
    share one network namespace; pods each have their own)."""
    if ctx.contract is None or port == 0:
        return port
    host = ctx.contract.coordinator_address.rsplit(":", 1)[0]
    local = host in ("localhost", "127.0.0.1", "::1", "[::1]")
    return port + ctx.process_id if local else port


def _env_int(name: str, default: int) -> int:
    """Integer knob from the env, with a loud failure on garbage."""
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {v!r}") from None


def _env_float(name: str, default: float) -> float:
    """Float knob from the env, with a loud failure on garbage."""
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {v!r}") from None


def _emit_ckpt_spans(ckpt, tracer, trace_id) -> None:
    """The checkpoint manager's op log as ckpt-save / ckpt-restore
    spans."""
    if ckpt is None or tracer is None:
        return
    for op, t0, t1, step in ckpt.drain_op_log():
        tracer.emit(op, start=t0, end=t1, trace_id=trace_id, step=step)


def _report_observations(metrics: dict, examples_per_sec: float,
                         steps: int) -> None:
    """Under a Katib study, report every final scalar metric and
    ``examples_per_sec`` as the trial's observations; a failure warns and
    never fails the run."""
    from ..katib.vizier import STUDY_ENV, report_observation
    if not os.environ.get(STUDY_ENV):
        return
    try:
        for name, value in {**metrics,
                            "examples_per_sec": examples_per_sec}.items():
            if isinstance(value, (int, float)):
                report_observation(name, float(value), step=steps)
    except Exception as e:  # noqa: BLE001 - reporting must not fail runs
        log.warning("observation report failed: %s", e)


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
    anomaly: Optional[dict] = None   # the tripped sentinel's evidence


class PreemptionGuard:
    """SIGTERM-aware stop flag: the loop checks ``stop`` at step
    boundaries, closes its window and exits cleanly. ``on_term`` runs
    inside the handler (the flight recorder's dump: a worker wedged in a
    step never reaches the next boundary)."""

    def __init__(self, install: bool = True, on_term=None):
        self.stop = False
        self._prev = None
        self._on_term_cb = on_term
        if install:
            import signal
            import threading
            if threading.current_thread() is threading.main_thread():
                self._prev = signal.signal(signal.SIGTERM, self._on_term)

    def _on_term(self, signum, frame):
        log.warning("SIGTERM: finishing the step and exiting")
        self.stop = True
        if self._on_term_cb is not None:
            try:
                self._on_term_cb()
            except Exception:  # noqa: BLE001 — evidence must not break
                pass           # the graceful-stop path

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
    # the process group lives as long as this call when the call made it
    # (from the contract env); a caller's context stays the caller's
    owns_ctx = ctx is None
    ctx = ctx or initialize(device=device)
    # everything that holds a thread, a process, a port, a file or the
    # process group is created inside the try, so the finally closes
    # whatever exists
    data_source = eval_source = dev_iter = obs_server = tracer = None
    mlog = None
    guard = None
    ckpt = None
    anomaly = None
    trace_id = None
    preempted = False
    loop_error: Optional[BaseException] = None
    recorder = FlightRecorder(windows=_env_int(FLIGHT_WINDOWS_ENV, 64))
    try:
        workload_kwargs = dict(workload_kwargs or {})
        # the global batch splits over the data-parallel ranks (raises when
        # it does not divide)
        local_batch_size(global_batch, ctx.mesh)
        if workload in _IMAGE_WORKLOADS:
            workload_kwargs.setdefault("mesh", ctx.mesh)

        # real-data path: shard dirs are self-describing, so the dataset's
        # geometry configures the model (the tf_cnn_benchmarks --data_dir
        # analog)
        data_dir = data_dir or os.environ.get("KFTPU_DATA_DIR")
        eval_explicit = eval_data_dir is not None
        eval_data_dir = eval_data_dir or os.environ.get("KFTPU_EVAL_DATA_DIR")
        if eval_data_dir and workload not in _IMAGE_WORKLOADS:
            if eval_explicit or eval_every > 0:
                raise ValueError(
                    f"workload {workload!r} does not consume --eval-data-dir")
            # a gang-wide env var meant for the image workers: warn only
            log.warning("ignoring KFTPU_EVAL_DATA_DIR for workload %r "
                        "(eval disabled)", workload)
            eval_data_dir = None
        # input-pipeline knobs: CLI flag wins, then the operator-rendered env,
        # then in-process augment and double-buffered device staging
        if input_workers is None:
            input_workers = _env_int("KFTPU_INPUT_WORKERS", 0)
        if device_prefetch is None:
            device_prefetch = _env_int("KFTPU_DEVICE_PREFETCH", 2)
        if input_workers < 0 or device_prefetch < 0:
            raise ValueError(f"input_workers ({input_workers}) and "
                             f"device_prefetch ({device_prefetch}) must be "
                             f">= 0")
        if data_dir and workload not in _IMAGE_WORKLOADS:
            raise ValueError(
                f"workload {workload!r} does not consume --data-dir")
        if label_smoothing and workload in _IMAGE_WORKLOADS:
            workload_kwargs.setdefault("label_smoothing", label_smoothing)

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

        base_lr = recipe.scale_lr(learning_rate, global_batch) \
            if scale_lr_by_batch else learning_rate
        if runtime_schedule is None:
            runtime_schedule = bool(_env_int("KFTPU_RUNTIME_SCHEDULE", 0))
        weight_update = validate_weight_update(
            weight_update or os.environ.get("KFTPU_WEIGHT_UPDATE")
            or "replicated")
        lr_fn = recipe.lr_schedule(lr_schedule, base_lr, steps, warmup_steps)

        if data_dir:
            # uint8 records host→device (1/4 the bytes of f32); the loss
            # wrapper below normalizes on the card; input_workers > 0 fans
            # decode+augment out over spawned processes
            data_source = ImageNetSource(data_dir, batch_size=global_batch,
                                         output="uint8",
                                         workers=input_workers)
            workload_kwargs.setdefault("image_size", data_source.image_size)
            workload_kwargs.setdefault("num_classes",
                                       data_source.num_classes)
        spec = WORKLOADS[workload](**workload_kwargs)
        if data_source is not None:
            inner_loss = spec.loss_fn

            def loss_fn_u8(params, variables, batch, rng,
                           _inner=inner_loss):
                batch = dict(batch, images=device_normalize(batch["images"]))
                return _inner(params, variables, batch, rng)

            spec = replace(spec, loss_fn=loss_fn_u8)
        log.info("worker %d/%d device=%s mesh=%s workload=%s",
                 ctx.process_id, ctx.num_processes, ctx.device,
                 {a: n for a, n in ctx.mesh.shape.items() if n > 1},
                 spec.name)

        builder = TrainStepBuilder(
            loss_fn=spec.loss_fn, device=ctx.device,
            weight_update=weight_update, mesh=ctx.mesh,
            optimizer=lambda params: recipe.make_optimizer(
                params, optimizer, base_lr, schedule=lr_schedule,
                total_steps=steps, warmup_steps=warmup_steps,
                weight_decay=weight_decay, momentum=momentum,
                kernels=kernel_optimizer,
                runtime_schedule=runtime_schedule)[0])
        state = builder.init(spec.init_fn, torch.Generator().manual_seed(seed))

        # the numeric sentinel: CLI flag, then the operator-rendered env,
        # then off (it changes no math)
        if integrity is None:
            integrity = bool(_env_int("KFTPU_INTEGRITY", 0))
        if integrity_spike_z is None:
            integrity_spike_z = _env_float("KFTPU_INTEGRITY_SPIKE_Z",
                                           sentinel_mod.DEFAULT_SPIKE_Z)
        if integrity_window is None:
            integrity_window = _env_int("KFTPU_INTEGRITY_WINDOW",
                                        sentinel_mod.DEFAULT_WINDOW_STEPS)
        if integrity_check_every is None:
            integrity_check_every = _env_int(
                "KFTPU_INTEGRITY_CHECK_EVERY",
                sentinel_mod.DEFAULT_CHECK_EVERY)
        sentinel = sentinel_mod.NumericSentinel(
            spike_z=float(integrity_spike_z),
            window_steps=int(integrity_window)) if integrity else None
        # the operator's anomaly-rollback contract: resume from the
        # newest intact step <= the LKG; the replay range arms the
        # bisection verdict
        resume_step = _env_int(sentinel_mod.RESUME_STEP_ENV, 0) or None
        replay = sentinel_mod.parse_replay_range(
            os.environ.get(sentinel_mod.REPLAY_RANGE_ENV))
        replay_done = False
        # the chaos numeric fault: poisons the state at an armed step
        fault_hook = sentinel_mod.NumericFaultHook.from_env()

        # checkpoints: the operator renders spec.checkpointDir/resumeFrom
        # as these env vars; every save stamps the writer's replica
        # degree and global batch (the elastic contract)
        checkpoint_dir = checkpoint_dir or \
            os.environ.get("KFTPU_CHECKPOINT_DIR")
        resume_from = resume_from or os.environ.get("KFTPU_RESUME_FROM")
        degree = builder.n_rep
        run_meta = {"replicaDegree": degree, "globalBatch": global_batch}
        gang = dict(process_index=ctx.process_id,
                    process_count=ctx.num_processes, group=ctx.mesh.group)
        early_ckpt_ops: list = []
        if checkpoint_dir:
            ckpt = CheckpointManager(checkpoint_dir,
                                     save_interval_steps=checkpoint_every,
                                     run_meta=run_meta, **gang)
            if resume and ckpt.latest_step() is not None:
                # the elastic contract is checked against the step the
                # walk actually restores; max_step caps the walk at the
                # LKG after an anomaly
                state = ckpt.restore(state,
                                     expect_run=(degree, global_batch),
                                     max_step=resume_step)
                log.info("resumed from step %d", state.step)
                if resume_step is not None:
                    # the steps after the LKG are tainted by the trip
                    ckpt.discard_steps_after(state.step)
        if resume_from and state.step == 0:
            # warm start or gang restart: only when checkpoint_dir had
            # nothing newer
            src = ckpt if ckpt is not None and os.path.abspath(
                resume_from) == ckpt.directory else \
                CheckpointManager(resume_from, run_meta=run_meta, **gang)
            if src.latest_step() is not None:
                state = src.restore(state,
                                    expect_run=(degree, global_batch))
                log.info("resumed from %s at step %d", resume_from,
                         state.step)
            if src is not ckpt:
                early_ckpt_ops = src.drain_op_log()
                src.close()
        # steps with a checkpoint on disk, promoted to last-known-good
        # once a later window drains clean through the sentinel
        latest = ckpt.latest_step() if ckpt is not None else None
        saved_steps: list = [] if latest is None else [latest]

        step_fn = builder.build()

        eval_step = builder.build_eval(spec.eval_fn) \
            if eval_every and spec.eval_fn is not None else None
        eval_bs = global_batch
        if eval_step is not None and eval_data_dir:
            # validation reads: no augmentation, normalized on the host;
            # the eval batch is clamped to the holdout, and the short last
            # batch comes through (drop_remainder=False) to be padded and
            # masked, so a full pass counts every record once
            # rounded down to a multiple of the data-parallel degree
            # (place_batch splits the rows over the ranks)
            dp = global_batch // local_batch_size(global_batch, ctx.mesh)
            n_rec = int(read_meta(eval_data_dir)["num_records"])
            eval_bs = (min(global_batch, n_rec) // dp) * dp
            if eval_bs == 0:
                log.warning("eval disabled: holdout %s has %d records, "
                            "fewer than the %d data-parallel ranks",
                            eval_data_dir, n_rec, dp)
                eval_step = None
            else:
                eval_source = ImageNetSource(eval_data_dir,
                                             batch_size=eval_bs,
                                             augment=False,
                                             drop_remainder=False)

        def pad_mask(batch) -> tuple[dict, float]:
            """Pad a (possibly short) holdout batch to the eval batch,
            0/1-weighting the rows so eval_fn masks the padding out of
            every metric. Returns (batch, real-record count)."""
            n = int(batch["labels"].shape[0])
            w = np.ones((n,), np.float32)
            if n < eval_bs:
                pad = eval_bs - n
                batch = {
                    "images": np.concatenate(
                        [batch["images"],
                         np.zeros((pad,) + batch["images"].shape[1:],
                                  batch["images"].dtype)]),
                    "labels": np.concatenate(
                        [batch["labels"], np.zeros((pad,), np.int32)]),
                }
                w = np.concatenate([w, np.zeros((pad,), np.float32)])
            return dict(batch, weight=w), float(n)

        def run_eval(state) -> dict:
            """Average spec.eval_fn over at most ONE pass of the held-out
            shards (eval_batches caps it; 0 is the full holdout, every
            record counted once), or over synthetic batches. Over the
            holdout, the count of records averaged over is reported as
            ``eval_examples``."""
            if eval_source is not None:
                eval_iter = eval_source.epoch(0, seed + 2)
                n_batches = eval_source.num_batches if eval_batches <= 0 \
                    else min(eval_batches, eval_source.num_batches)
            else:
                gen = torch.Generator().manual_seed(seed + 2)
                n_batches = eval_batches if eval_batches > 0 else 8
            totals: dict = {}
            denom = 0.0
            for _ in range(n_batches):
                if eval_source is not None:
                    b, bw = pad_mask(next(eval_iter))
                else:
                    b, bw = spec.batch_fn(gen, global_batch), 1.0
                em = eval_step(state, builder.place_batch(b))
                for k, v in em.items():
                    totals[k] = totals.get(k, 0.0) + float(v) * bw
                denom += bw
            if not denom:
                return {}
            out = {k: v / denom for k, v in totals.items()}
            if "eval_perplexity" in out and "eval_loss" in out:
                # perplexity = exp(mean loss), not the mean of exp(loss)
                import math
                out["eval_perplexity"] = math.exp(out["eval_loss"])
            if eval_source is not None:
                out["eval_examples"] = denom
            return out

        metrics_path = metrics_path or os.environ.get(METRICS_PATH_ENV)
        if metrics_path:
            metrics_path = _process_metrics_path(metrics_path,
                                                 ctx.process_id)
            os.makedirs(os.path.dirname(metrics_path) or ".", exist_ok=True)
        tensorboard_dir = tensorboard_dir or os.environ.get("KFTPU_TB_DIR")
        # TB events come from process 0 only: one curve per run
        mlog = MetricsLogger(metrics_path, batch_size=global_batch,
                             tensorboard_dir=(tensorboard_dir
                                              if ctx.process_id == 0
                                              else None))
        # liveness for the stall watchdog: None outside a pod. The first,
        # forced beat sets the baseline, so a worker that wedges inside
        # its first window (the first collective) is still caught.
        heartbeat = HeartbeatReporter.from_env()
        if heartbeat is not None:
            heartbeat.beat(state.step, force=True)

        # host batches come from the augment pipeline (in-process or
        # spawned workers); the device prefetcher stages them on the card
        # `device_prefetch` batches ahead of the running step
        data_iter = data_source.batches(seed, start_batch=state.step) \
            if data_source is not None else None
        if data_iter is not None and device_prefetch > 0:
            from ..data.device_prefetch import DevicePrefetcher
            # only this rank's rows are pinned and copied
            dev_iter = DevicePrefetcher(map(builder.local_rows, data_iter),
                                        builder.place_local,
                                        depth=device_prefetch,
                                        device=ctx.device)
        # the synthetic pool: 4 batches placed once and cycled, so batch
        # generation never shares the device with the step
        batch_pool = []
        if data_iter is None:
            data_rng = torch.Generator().manual_seed(seed + 1)
            batch_pool = [builder.place_batch(spec.batch_fn(data_rng,
                                                            global_batch))
                          for _ in range(4)]

        from ..obs.trace import SPAN_PATH_ENV, SpanWriter
        span_path = span_path or os.environ.get(SPAN_PATH_ENV)
        if span_path:
            trace_id = os.environ.get("KFTPU_TRACE_ID") or uuid.uuid4().hex
            tracer = SpanWriter(span_path, "worker")
            tracer.emit("train-start", start=time.time(), trace_id=trace_id,
                        workload=spec.name, start_step=state.step,
                        steps=steps, process=ctx.process_id)
            # the restores made before the tracer existed
            for op, t0w, t1w, st in early_ckpt_ops:
                tracer.emit(op, start=t0w, end=t1w, trace_id=trace_id,
                            step=st)
            _emit_ckpt_spans(ckpt, tracer, trace_id)
        # the on-demand profiler: POST /profile?steps=N captures the next
        # N steps under the base dir
        profile_arm = ProfileArm(
            base_dir=profile_dir or os.environ.get("KFTPU_PROFILE_DIR")
            or os.path.join(tempfile.gettempdir(), "kftpu-profiles"),
            tracer=tracer)
        # the worker's scrape surface: /metrics over the process registry
        # (step times, input-stage rates), the profiler trigger and the
        # flight-recorder peek
        if obs_metrics_port is None:
            obs_metrics_port = _env_int("KFTPU_OBS_METRICS_PORT", 0)
        obs_metrics_port = _process_port(obs_metrics_port, ctx)
        if obs_metrics_port:
            from ..obs.http import ObsServer
            try:
                obs_server = ObsServer(port=obs_metrics_port, handlers={
                    ("POST", "/profile"):
                        lambda q: profile_arm.request(q.get("steps", 0)),
                    ("GET", "/flightrecorder"):
                        lambda q: (200, recorder.snapshot()),
                })
                obs_server.start()
            except (OSError, OverflowError) as e:
                # a taken port costs the scrape surface, not the run
                log.warning("obs metrics server on :%d failed: %s",
                            obs_metrics_port, e)
                obs_server = None

        start_step = state.step
        last_metrics: dict = {}
        first_step_s = 0.0
        guard = PreemptionGuard(
            install=handle_sigterm,
            on_term=lambda: recorder.dump(tracer, "sigterm"))
        # the host reads metrics only at window edges, and a window's
        # values a window later (AsyncWindowFetch), so the launch queue
        # never empties
        sync_every = max(1, int(sync_every))
        if sentinel is not None:
            # the sentinel reads drained windows: the window edge bounds
            # detection latency
            sync_every = min(sync_every, max(1, int(integrity_check_every)))
        afetch = AsyncWindowFetch(lag=1)
        cuda = ctx.device.type == "cuda"
        with profile_trace(profile_dir, enabled=profile_dir is not None,
                           tracer=tracer):
            window = 0
            win_t0 = time.perf_counter()
            step = start_step
            for step in range(start_step, steps):
                profile_arm.on_step_start()
                recorder.mark("data", step)
                t_a = time.perf_counter()
                if dev_iter is not None:
                    batch = next(dev_iter)
                    t_h = t_b = time.perf_counter()
                elif data_iter is not None:
                    host_batch = next(data_iter)
                    t_h = time.perf_counter()
                    batch = builder.place_batch(host_batch)
                    t_b = time.perf_counter()
                else:
                    batch = batch_pool[step % len(batch_pool)]
                    t_h = t_b = time.perf_counter()
                recorder.mark("first-step" if step == start_step
                              else "step", step)
                state, metrics = step_fn(state, batch)
                if step == start_step:
                    # one hard sync, once: the startup cost this measures
                    if cuda:
                        torch.cuda.synchronize(ctx.device)
                    first_step_s = time.perf_counter() - t_train_start
                step_cost = time.perf_counter() - t_b
                recorder.note_step(
                    data_s=t_h - t_a, h2d_s=t_b - t_h,
                    dispatch_s=0.0 if step == start_step else step_cost,
                    first_step_s=step_cost if step == start_step else 0.0)
                profile_arm.on_step_end(step + 1)
                if fault_hook is not None and \
                        fault_hook.should_fire(step + 1):
                    # the chaos numeric fault: corrupt the state after the
                    # step, so the damage shows in the next window
                    state = fault_hook.poison(state, step + 1)
                window += 1
                # read once: SIGTERM between the save's force and the
                # break must not exit without the forced checkpoint
                stopping = guard.stop
                final = step + 1 == steps
                will_ckpt = ckpt is not None and ckpt.should_save(step + 1)
                will_eval = eval_step is not None and (
                    (step + 1) % eval_every == 0 or final)
                closed = window >= sync_every or final or will_ckpt or \
                    will_eval or stopping
                if closed:
                    t_now = time.perf_counter()
                    afetch.submit(step + 1, window, t_now - win_t0,
                                  {**metrics, "learning_rate": lr_fn(step)})
                    if tracer is not None:
                        now_w = time.time()
                        tracer.emit("window", start=now_w - (t_now - win_t0),
                                    end=now_w, trace_id=trace_id,
                                    step=step + 1, steps=window)
                    recorder.mark("drain", step + 1)
                    t_drain0 = time.perf_counter()
                    for s, w, wall, vals in afetch.drain(
                            force=final or will_ckpt or will_eval
                            or stopping):
                        last_metrics = vals
                        mlog.record_window(s, w, wall, vals)
                        if sentinel is not None and anomaly is None:
                            rep_sq = vals.get("param_sqnorm_replicas")
                            anomaly = sentinel.observe(
                                s, loss=vals.get("loss"),
                                grad_norm=vals.get("grad_norm"),
                                replica_sqnorms=rep_sq,
                                lkg=ckpt.lkg_step()
                                if ckpt is not None else None)
                            if anomaly is None and ckpt is not None:
                                # the window ending at s drained clean:
                                # the newest step saved before it is
                                # last-known-good
                                cleared = [n for n in saved_steps if n < s]
                                if cleared:
                                    ckpt.tag_lkg(cleared[-1])
                            if anomaly is None and replay is not None \
                                    and not replay_done and s >= replay[1]:
                                # the suspect range replayed clean
                                replay_done = True
                                if tracer is not None:
                                    tracer.emit(
                                        "anomaly-bisection",
                                        start=time.time(),
                                        trace_id=trace_id, lo=replay[0],
                                        hi=replay[1], verdict="clean",
                                        step=s)
                    recorder.close_window(
                        step + 1, window, t_now - win_t0,
                        drain_s=time.perf_counter() - t_drain0)
                    if heartbeat is not None:
                        # every window edge: the step needs no device
                        # fetch, so a loop that stops closing windows
                        # stops beating, the watchdog's signal
                        heartbeat.beat(
                            step + 1, loss=last_metrics.get("loss"),
                            grad_norm=last_metrics.get("grad_norm"))
                    window = 0
                if anomaly is not None:
                    # a tripped detector: dump the flight record, post
                    # the evidence and exit without saving (the state is
                    # tainted; the operator rolls back to the LKG)
                    log.error("numeric anomaly %s at step %d (value %s, "
                              "lkg %s): exiting for LKG rollback",
                              anomaly.kind, anomaly.step,
                              anomaly.to_dict()["value"], anomaly.lkg)
                    from ..obs.goodput import SPAN_ANOMALY
                    recorder.dump(tracer, SPAN_ANOMALY,
                                  error=f"{anomaly.kind}@{anomaly.step}")
                    if tracer is not None:
                        tracer.emit(SPAN_ANOMALY, start=time.time(),
                                    trace_id=trace_id, step=anomaly.step,
                                    kind=anomaly.kind,
                                    value=anomaly.to_dict()["value"],
                                    lkg=anomaly.lkg,
                                    **({"replay": list(replay)}
                                       if replay is not None else {}))
                    if heartbeat is not None:
                        from ..api.trainingjob import ANOMALY_ANNOTATION
                        heartbeat.annotate(ANOMALY_ANNOTATION,
                                           anomaly.to_json())
                    break
                if ckpt is not None:
                    # the final step and preemption force the save, in
                    # this iteration: a resume loses no step
                    recorder.mark("ckpt-save", step + 1)
                    if ckpt.save(step + 1, state, force=stopping or final):
                        saved_steps.append(step + 1)
                    _emit_ckpt_spans(ckpt, tracer, trace_id)
                if stopping:
                    preempted = True
                    break
                if will_eval:
                    # the window closed above, so eval wall time is never
                    # charged to throughput
                    recorder.mark("eval", step + 1)
                    em = run_eval(state)
                    if em:
                        last_metrics.update(em)
                        mlog.event(step + 1, em)
                        log.info("eval @%d: %s", step + 1,
                                 {k: round(v, 4) for k, v in em.items()})
                if closed:
                    win_t0 = time.perf_counter()
            # a capture still armed at the end stops with the loop
            profile_arm.on_step_end(step + 1, force=True)
    except BaseException as e:
        loop_error = e
        raise
    finally:
        # a failure must not leak the prefetch threads, the augment
        # worker processes, the shard files, the port or the event files
        # (train is called repeatedly in one process by sweeps and tests)
        if dev_iter is not None:
            dev_iter.close()    # release the staged device batches first
        if data_source is not None:
            data_source.close()
        if eval_source is not None:
            eval_source.close()
        if guard is not None:
            guard.uninstall()
        save_error: Optional[BaseException] = None
        if ckpt is not None:
            # the final and the SIGTERM saves land before the process
            # exits, and a failed background write fails the run; after
            # a loop error the gang's commit barrier is skipped (a dead
            # rank would hold it)
            if loop_error is None:
                try:
                    ckpt.wait()
                except Exception as e:  # noqa: BLE001
                    save_error = e
            ckpt.close(wait=False)
        if loop_error is not None:
            # the crash dump: the ring's last records and the stage in
            # progress say where the loop died
            recorder.dump(tracer, "crash",
                          error=f"{type(loop_error).__name__}: {loop_error}")
        if tracer is not None:
            _emit_ckpt_spans(ckpt, tracer, trace_id)
            attrs = {"preempted": preempted}
            if anomaly is not None:
                attrs["anomaly"] = anomaly.kind
            if loop_error is not None:
                attrs["error"] = f"{type(loop_error).__name__}: {loop_error}"
            tracer.emit("train-done", start=time.time(), trace_id=trace_id,
                        step=state.step if loop_error is None else None,
                        **attrs)
            tracer.close()
        if obs_server is not None:
            obs_server.stop()
        if mlog is not None:
            mlog.close()
        if owns_ctx:
            shutdown(ctx)
        if save_error is not None:
            # a run that reports success has its final checkpoint
            raise save_error
    summary = mlog.summary(warmup=1)
    if ctx.process_id == 0:
        _report_observations(last_metrics, summary["examples_per_sec"],
                             summary["steps"])
    if preempted:
        log.warning("preempted at step %d; checkpoint saved, exiting for "
                    "the gang-restart resume", state.step)
    return TrainResult(
        steps=summary["steps"],
        examples_per_sec=summary["examples_per_sec"],
        mean_step_time_s=summary["mean_step_time_s"],
        final_metrics=last_metrics,
        preempted=preempted,
        first_window_s=summary.get("first_window_s", 0.0),
        time_to_first_step_s=first_step_s,
        anomaly=anomaly.to_dict() if anomaly is not None else None,
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
                   help="optimizer-update layout across the data-"
                        "parallel ranks: 'sharded' is ZeRO-2 (gradients "
                        "reduce-scattered, each rank updates its shard, "
                        "params all-gathered); defaults to "
                        "$KFTPU_WEIGHT_UPDATE or 'replicated'")
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
    if result.anomaly:
        return sentinel_mod.ANOMALY_EXIT_CODE
    return PREEMPTED_EXIT_CODE if result.preempted else 0


if __name__ == "__main__":
    raise SystemExit(main())
