"""MPMD pipeline over slices: one program per stage, explicit transfers.

The port of ``kubeflow_tpu/parallel/multislice.py``. Pipeline stages run
as separate programs, one per slice, and activations and gradients cross
the boundary between slices only by explicit transfers that the schedule
makes and counts, never by a collective inside a stage's program.

- **Stages** split the stacked ``[L, ...]`` block params into ``S``
  contiguous chunks (:func:`partition_stacked`); stage 0 also owns the
  embedding, stage S-1 the head and the loss.
- **Stage devices**: one process drives every stage, as the JAX engine
  does on one host. A stage is one torch device (:func:`stage_devices`):
  stage s takes card ``s % torch.cuda.device_count()``, so on one card
  every stage shares it, or the CPU when asked. A slice of more than one
  card (data parallelism inside a stage) is not ported.
- **Programs** per stage: forward (``FWD``), the last stage's fused
  forward + head + loss + backward (``FWDBWD``), and the backward of the
  others with the stage forward recomputed from the saved input
  (``BWD``; the kernels of the forward launch again), then the stage's
  own optimizer update over its params.
- **Schedule**: microbatched 1F1B (:func:`stage_op_order`) run as a
  dependency-driven round-robin over the stages, a valid linearization
  on one host. Each op is timed on the host clock after
  ``torch.cuda.synchronize()``; the times feed :func:`model_schedule`,
  whose bubble the step reports (``pipeline_bubble_s``,
  ``bubble_fraction``) and the worker charges to the
  ``pipeline-bubble`` span.
- **Accounting**: every cross-stage transfer is a real copy
  (``.to(device, copy=True)``) counted by its bytes: the forward
  activations, the last stage's tokens (int32, as the JAX package sends
  them) and the cotangents. Copying a stage's saved input back for its
  recompute is placed, not counted (on hardware the stage keeps its
  own input).

Gradient semantics (the JAX engine's): microbatch losses are per-
microbatch means, each stage accumulates its microbatch gradients, and
the step's update takes their mean, clipped by the global norm across
every stage. The 1/M is folded into each microbatch's loss before its
backward, so a stage accumulates the mean directly; the stages' square
sums are summed on the host into ``gnorm``, the norm of the averaged
gradient, and each stage's optimizer (the recipe's, with its clip)
takes ``gnorm`` as a 0-d tensor on the stage's device as its pre-clip
global norm: with ``fused_adam`` the clip runs inside the stage's one
K3 launch. The math is the single-program clip + per-leaf optimizer's.
"""

from __future__ import annotations

import logging
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from .pipeline import apply_layers

# program kinds in the schedule
FWD = "fwd"
BWD = "bwd"
FWDBWD = "fwdbwd"   # the last stage's fused forward+loss+backward

# the schedule model's DCN rate (the JAX package's obs/collectives.py
# defaults): the emulation's copies cross no DCN link, so a transfer is
# modeled as its bytes over this rate
DCN_GBPS_ENV = "KFTPU_COMM_DCN_GBPS"
DEFAULT_DCN_GBPS = 6.25


def _bw(env: str, default: float) -> float:
    """A positive finite rate from the env, else the default (warned)."""
    raw = os.environ.get(env)
    if not raw:
        return default
    try:
        v = float(raw)
        if v > 0 and math.isfinite(v):
            return v
    except ValueError:
        pass
    logging.getLogger(__name__).warning(
        "%s=%r is not a positive bandwidth; using %s GB/s", env, raw,
        default)
    return default


def stage_devices(num_slices: int, device: Any = "cuda") -> list:
    """One torch device per stage: the CPU for each when ``device`` is
    the CPU; else card ``s % torch.cuda.device_count()`` for stage s. A
    slice of more than one card (cards a multiple of the slices, above
    them) raises: data parallelism inside a stage is not ported."""
    device = torch.device(device)
    if num_slices < 1:
        raise ValueError(f"num_slices {num_slices} < 1")
    if device.type == "cpu":
        return [device] * num_slices
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device")
    n = torch.cuda.device_count()
    if n > num_slices and n % num_slices == 0:
        raise NotImplementedError(
            f"{n} cards over {num_slices} slices is a slice of "
            f"{n // num_slices} cards: data parallelism inside a stage is "
            f"not yet ported (ROADMAP Queue 1 item 11)")
    return [torch.device("cuda", s % n) for s in range(num_slices)]


def partition_stacked(params: dict, num_stages: int) -> list[dict]:
    """Split stacked block params (name -> leaf with a leading ``layers``
    dimension, parallel/pipeline.py convention) into ``num_stages``
    contiguous per-stage chunks (views)."""
    if not params:
        raise ValueError("no stacked block params to partition")
    num_layers = next(iter(params.values())).shape[0]
    if num_layers % num_stages:
        raise ValueError(
            f"{num_layers} layers not divisible by {num_stages} stages")
    per = num_layers // num_stages
    return [{n: v[s * per:(s + 1) * per] for n, v in params.items()}
            for s in range(num_stages)]


# --------------------------------------------------------------------------
# 1F1B schedule: per-stage op order + the measured-duration timeline model


def stage_op_order(stage: int, num_stages: int,
                   num_micro: int) -> list[tuple[str, int]]:
    """The 1F1B op sequence for one stage: warmup forwards, steady
    one-backward-one-forward, drain backwards. The last stage runs the
    fused forward+backward per microbatch (zero warmup)."""
    if num_stages == 1:
        return [(FWDBWD, m) for m in range(num_micro)]
    if stage == num_stages - 1:
        return [(FWDBWD, m) for m in range(num_micro)]
    warmup = min(num_micro, num_stages - 1 - stage)
    ops: list[tuple[str, int]] = [(FWD, m) for m in range(warmup)]
    nf, nb = warmup, 0
    # steady state is forward-FIRST (fwd k+warmup, then bwd k): the
    # stage keeps S-1-stage activations in flight, so its forward for
    # the NEXT microbatch overlaps downstream stages' work — ordering
    # the backward first would serialize the whole pipeline
    while nf < num_micro:
        ops.append((FWD, nf))
        nf += 1
        ops.append((BWD, nb))
        nb += 1
    while nb < num_micro:
        ops.append((BWD, nb))
        nb += 1
    return ops


def _deps(kind: str, stage: int, micro: int,
          num_stages: int) -> list[tuple[str, int, int]]:
    """Cross-stage dependencies of one schedule op (intra-stage order is
    the stage's own op list)."""
    deps = []
    if kind in (FWD, FWDBWD) and stage > 0:
        deps.append((FWD, stage - 1, micro))
    if kind == BWD and stage < num_stages - 1:
        prev = FWDBWD if stage + 1 == num_stages - 1 else BWD
        deps.append((prev, stage + 1, micro))
    return deps


@dataclass
class ScheduleReport:
    """The modeled parallel timeline of one executed step, from measured
    per-op durations + modeled transfer latency. On a real multi-slice
    deployment every stage is its own hardware and the makespan is the
    wall clock; on an emulation whose stages share a device or host,
    stages run serially, so the model (not the serial wall) is the
    honest bubble number — stated wherever it is reported (PERF.md)."""

    num_stages: int
    num_microbatches: int
    makespan_s: float           # modeled parallel wall of one step
    stage_busy_s: list          # per-stage sum of op durations
    bubble_s: float             # sum over stages of (makespan - busy)
    bubble_fraction: float      # bubble_s / (num_stages * makespan)
    serial_wall_s: float        # measured host wall (serial)
    dcn_bytes: int              # explicit cross-stage transfer bytes
    dcn_transfers: int

    def to_dict(self) -> dict:
        return {
            "numStages": self.num_stages,
            "numMicrobatches": self.num_microbatches,
            "makespanS": round(self.makespan_s, 6),
            "stageBusyS": [round(b, 6) for b in self.stage_busy_s],
            "bubbleS": round(self.bubble_s, 6),
            "bubbleFraction": round(self.bubble_fraction, 6),
            "serialWallS": round(self.serial_wall_s, 6),
            "dcnBytesPerStep": int(self.dcn_bytes),
            "dcnTransfersPerStep": int(self.dcn_transfers),
            # the analytic GPipe bound for reference: (S-1)/(M+S-1)
            "idealBubbleFraction": round(
                (self.num_stages - 1) /
                (self.num_microbatches + self.num_stages - 1), 6),
        }


def model_schedule(durations: dict, num_stages: int, num_micro: int,
                   transfer_s: float = 0.0,
                   serial_wall_s: float = 0.0,
                   dcn_bytes: int = 0,
                   dcn_transfers: int = 0) -> ScheduleReport:
    """List-schedule the 1F1B grid with measured op durations:
    each stage is a serial resource executing its op order; an op starts
    at max(stage free, deps done + transfer). Returns the makespan /
    per-stage busy / bubble decomposition."""
    finish: dict = {}
    free = [0.0] * num_stages
    busy = [0.0] * num_stages
    orders = [stage_op_order(s, num_stages, num_micro)
              for s in range(num_stages)]
    cursor = [0] * num_stages
    remaining = sum(len(o) for o in orders)
    while remaining:
        progressed = False
        for s in range(num_stages):
            if cursor[s] >= len(orders[s]):
                continue
            kind, m = orders[s][cursor[s]]
            deps = _deps(kind, s, m, num_stages)
            if any(d not in finish for d in deps):
                continue
            ready = max([finish[d] + transfer_s for d in deps],
                        default=0.0)
            start = max(free[s], ready)
            dur = float(durations.get((kind, s, m), 0.0))
            finish[(kind, s, m)] = start + dur
            free[s] = start + dur
            busy[s] += dur
            cursor[s] += 1
            remaining -= 1
            progressed = True
        if not progressed:   # defensive: a dep cycle would spin forever
            raise RuntimeError("1F1B schedule deadlocked (bad deps)")
    makespan = max(free) if num_stages else 0.0
    bubble = sum(max(0.0, makespan - b) for b in busy)
    return ScheduleReport(
        num_stages=num_stages, num_microbatches=num_micro,
        makespan_s=makespan, stage_busy_s=busy, bubble_s=bubble,
        bubble_fraction=(bubble / (num_stages * makespan)
                         if makespan > 0 else 0.0),
        serial_wall_s=serial_wall_s, dcn_bytes=dcn_bytes,
        dcn_transfers=dcn_transfers)


# --------------------------------------------------------------------------
# the engine


@dataclass
class MultisliceState:
    """Per-stage training state: each stage's params (name -> f32 leaf
    tensor on its device, the names of the whole pipelined tree) and its
    optimizer, which owns the stage's optimizer state."""

    step: int
    params: list
    opt_state: list


def _sub(params: dict, prefix: str) -> dict:
    """The entries under ``prefix`` (``embed.``, ``blocks.``, ``head.``),
    the prefix dropped."""
    return {n[len(prefix):]: v for n, v in params.items()
            if n.startswith(prefix)}


@dataclass
class MPMDPipeline:
    """The per-slice-program train step (see the module docstring).

    Stage functions (models/transformer.py ``multislice_stage_fns``):

    - ``embed_fn(embed_params, tokens) -> h``        (stage 0 prologue)
    - ``block_fn(layer_params, h) -> h``             (one block; each
      stage runs its chunk's layers in order)
    - ``head_loss_fn(head_params, h, tokens) -> (loss, aux)``
                                                      (stage S-1)

    ``optimizer`` is a factory ``params -> optimizer`` built over each
    stage's params (runtime/recipe.py ``make_optimizer``): a per-leaf
    update whose ``step(grad_norm=...)`` clips by the cross-stage global
    norm the engine hands it."""

    devices: list                  # one torch device per stage
    embed_fn: Callable
    block_fn: Callable
    head_loss_fn: Callable
    optimizer: Callable[[dict], Any]
    num_microbatches: int
    last_report: Optional[ScheduleReport] = field(default=None,
                                                  init=False)

    def __post_init__(self):
        if self.num_microbatches < 1:
            raise ValueError("num_microbatches must be >= 1")
        if not self.devices:
            raise ValueError("need at least one stage device")
        self.devices = [torch.device(d) for d in self.devices]

    @property
    def num_stages(self) -> int:
        return len(self.devices)

    def place_batch(self, batch: dict) -> dict:
        """Host placement, deliberately: the schedule feeds one
        microbatch at a time to stage 0 (and its tokens to the last
        stage), each an explicit copy; the batch stays as CPU tensors."""
        return {k: torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v).cpu() for k, v in batch.items()}

    def init(self, full_init_fn: Callable, rng) -> MultisliceState:
        """Initialize from the whole pipelined state dict
        (``embed.*``, ``blocks.*`` [L, ...], ``head.*``), so the MPMD and
        single-program arms start from the same weights, then partition:
        stage 0 owns the embedding and its chunk of the blocks, stage S-1
        its chunk and the head. Each stage's params are f32 leaf tensors
        on its device, its optimizer built over them."""
        full = full_init_fn(rng)
        blocks = {n: v for n, v in full.items() if n.startswith("blocks.")}
        chunks = partition_stacked(blocks, self.num_stages)
        params = []
        for s, dev in enumerate(self.devices):
            p = dict(chunks[s])
            if s == 0:
                p.update({n: v for n, v in full.items()
                          if n.startswith("embed.")})
            if s == self.num_stages - 1:
                p.update({n: v for n, v in full.items()
                          if n.startswith("head.")})
            params.append({n: torch.as_tensor(np.asarray(v) if not
                                              isinstance(v, torch.Tensor)
                                              else v).detach().to(
                dev, torch.float32, copy=True).contiguous().requires_grad_()
                for n, v in p.items()})
        return MultisliceState(step=0, params=params,
                               opt_state=[self.optimizer(p) for p in params])

    # -- per-stage programs --------------------------------------------------

    def _stage_fwd(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """One stage's forward: the embedding (stage 0), then its chunk
        of the blocks; the head is the last stage's FWDBWD."""
        embed = _sub(params, "embed.")
        if embed:
            x = self.embed_fn(embed, x)
        return apply_layers(self.block_fn, _sub(params, "blocks."), x)

    def _sync(self, stage: int) -> None:
        if self.devices[stage].type == "cuda":
            torch.cuda.synchronize(self.devices[stage])

    def _transfer(self, x: torch.Tensor, stage: int, record: list
                  ) -> torch.Tensor:
        """Explicit cross-stage transfer, counted by its bytes: a real
        copy onto the stage's device."""
        y = x.detach().to(self.devices[stage], copy=True)
        record.append(x.numel() * x.element_size())
        return y

    def step(self, state: MultisliceState,
             batch: dict) -> tuple[MultisliceState, dict]:
        S = self.num_stages
        M = self.num_microbatches
        tokens = torch.as_tensor(batch["tokens"])
        B = tokens.shape[0]
        if B % M:
            raise ValueError(
                f"global batch {B} not divisible by {M} microbatches")
        mb = B // M
        t_wall0 = time.perf_counter()
        transfers: list[int] = []
        durations: dict = {}
        fwd_out: dict = {}      # (stage, micro) -> activation (on stage)
        cot_in: dict = {}       # (stage, micro) -> incoming cotangent
        losses: list = []
        auxes: list = []
        # the host split, each microbatch placed on stage 0
        micro_tok = [tokens[m * mb:(m + 1) * mb].to(self.devices[0])
                     for m in range(M)]

        def run_op(kind, s, m):
            t0 = time.perf_counter()
            params = state.params[s]
            if kind == FWD:
                x = micro_tok[m] if s == 0 else \
                    self._transfer(fwd_out[(s - 1, m)], s, transfers)
                with torch.no_grad():
                    fwd_out[(s, m)] = self._stage_fwd(params, x)
            elif kind == FWDBWD:
                if S == 1:
                    x = tok = micro_tok[m]
                else:
                    x = self._transfer(fwd_out.pop((s - 1, m)), s,
                                       transfers).requires_grad_()
                    tok = self._transfer(micro_tok[m], s, transfers)
                with torch.enable_grad():
                    h = self._stage_fwd(
                        {n: v for n, v in params.items()
                         if not n.startswith("head.")}, x)
                    loss, aux = self.head_loss_fn(_sub(params, "head."), h,
                                                  tok)
                    # the 1/M of the step's mean, on every stage's grads
                    (loss / M).backward()
                losses.append(loss.detach())
                auxes.append({k: v.detach() for k, v in aux.items()})
                if S > 1:
                    cot_in[(s - 1, m)] = x.grad
            else:  # BWD: the stage forward recomputed from its input
                g = self._transfer(cot_in.pop((s, m)), s, transfers)
                x = micro_tok[m] if s == 0 else fwd_out[(s - 1, m)]
                if s > 0:
                    # the saved input lives on the previous stage's
                    # device: placed, not counted
                    x = x.to(self.devices[s], copy=True).requires_grad_()
                with torch.enable_grad():
                    self._stage_fwd(params, x).backward(g)
                if s > 0:
                    cot_in[(s - 1, m)] = x.grad
                fwd_out.pop((s - 1, m), None)
            self._sync(s)
            durations[(kind, s, m)] = time.perf_counter() - t0

        # dependency-driven round-robin over the per-stage 1F1B orders —
        # a valid linearization of the parallel schedule on one host
        orders = [stage_op_order(s, S, M) for s in range(S)]
        cursor = [0] * S
        done: set = set()
        remaining = sum(len(o) for o in orders)
        while remaining:
            progressed = False
            for s in range(S):
                if cursor[s] >= len(orders[s]):
                    continue
                kind, m = orders[s][cursor[s]]
                if any(d not in done for d in _deps(kind, s, m, S)):
                    continue
                run_op(kind, s, m)
                done.add((kind, s, m))
                cursor[s] += 1
                remaining -= 1
                progressed = True
            if not progressed:
                raise RuntimeError("1F1B execution deadlocked")

        # the cross-stage global norm of the averaged grads, then each
        # stage's update, clipped by it
        sq = [float(torch.stack([p.grad.float().square().sum()
                                 for p in state.params[s].values()
                                 if p.grad is not None]).sum())
              for s in range(S)]
        gnorm = float(np.sqrt(sum(sq)))
        for s in range(S):
            opt = state.opt_state[s]
            opt.step(grad_norm=torch.tensor(
                gnorm, dtype=torch.float32, device=self.devices[s]))
            opt.zero_grad(set_to_none=True)
        for s in range(S):
            self._sync(s)
        serial_wall = time.perf_counter() - t_wall0

        dcn_bytes = sum(transfers)
        per = (dcn_bytes / len(transfers)) if transfers else 0
        xfer_s = per / (_bw(DCN_GBPS_ENV, DEFAULT_DCN_GBPS) * 1e9)
        self.last_report = model_schedule(
            durations, S, M, transfer_s=xfer_s,
            serial_wall_s=serial_wall, dcn_bytes=dcn_bytes,
            dcn_transfers=len(transfers))

        loss = float(np.mean([float(v) for v in losses]))
        # pipeline_bubble_s is the wall-clock-equivalent idle: bubble_s
        # is stage-seconds (summed over S stages), so the per-step wall
        # share is bubble_s / S = bubble_fraction x makespan
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "pipeline_bubble_s":
                       float(self.last_report.bubble_s / max(1, S)),
                   "bubble_fraction":
                       float(self.last_report.bubble_fraction)}
        for k in (auxes[0] if auxes else {}):
            metrics.setdefault(
                k, float(np.mean([float(a[k]) for a in auxes])))
        state.step += 1
        return state, metrics
