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
  card (data parallelism inside a stage, the JAX package's pure-data
  stage mesh over a slice's chips) is not ported, and neither is a
  sequence axis, which on those meshes is the same data parallelism
  (ROADMAP Queue 1 item 11).
- **Programs** per stage: forward (``FWD``), the last stage's fused
  forward + head + loss + backward (``FWDBWD``), and the backward of the
  others with the stage forward recomputed from the saved input
  (``BWD``; the kernels of the forward launch again), then the stage's
  own optimizer update over its params.
- **Captured programs** (the AOT warm start, :meth:`MPMDPipeline.
  export_stages` / :meth:`MPMDPipeline.load_stages`): each of the 2S−1
  programs captured once as a CUDA graph on its stage's device over
  static buffers (:class:`StageProgram`) and replayed M times a step; a
  program not captured runs its op eagerly. Either way the microbatch
  gradients accumulate into the stage's gradient storage, which the
  update reads as ``.grad``; the update (one K3 a stage with
  fused_adam) stays eager.
- **Schedule**: microbatched 1F1B (:func:`stage_op_order`) run as a
  dependency-driven round-robin over the stages, a valid linearization
  on one host. Each op is timed on the host clock after
  ``torch.cuda.synchronize()``; the times feed :func:`model_schedule`,
  whose bubble the step reports (``pipeline_bubble_s``,
  ``bubble_fraction``) and the worker charges to the
  ``pipeline-bubble`` span. A transfer is modeled as its bytes over
  obs/collectives.py's cross-slice rate (the H100's 400 Gb/s NDR port,
  ``KFTPU_COMM_DCN_GBPS`` to override).
- **Accounting**: every cross-stage transfer is a real copy
  (``.to(device, copy=True)``, or into a captured program's static
  input) counted by its bytes: the forward
  activations, the last stage's tokens (int32, as the JAX package sends
  them) and the cotangents. Copying a stage's saved input back for its
  recompute is placed, not counted (on hardware the stage keeps its
  own input).

Gradient semantics (the JAX engine's): microbatch losses are per-
microbatch means, each stage accumulates its microbatch gradients
(``torch.autograd.grad`` added into its storage, the same sums as
``.backward()``'s accumulation), and
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
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

# the schedule model's cross-slice rate, as the JAX engine takes it from
# its comm profiler: the emulation's copies cross no network link, so a
# transfer is modeled as its bytes over this rate
from ..obs.collectives import DCN_GBPS_ENV, DEFAULT_DCN_GBPS, _bw
from .pipeline import apply_layers

log = logging.getLogger(__name__)

# program kinds in the schedule
FWD = "fwd"
BWD = "bwd"
FWDBWD = "fwdbwd"   # the last stage's fused forward+loss+backward


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
            f"{n // num_slices} cards: data parallelism inside a stage "
            f"(the JAX package's pure-data stage mesh) is not yet ported "
            f"(ROADMAP Queue 1 item 11)")
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
        # (kind, stage) -> StageProgram; empty: every op runs eagerly
        self._programs: dict = {}
        self._programs_state: Optional[MultisliceState] = None
        self._failed: set = set()       # programs that did not capture
        # stage -> {name: f32 gradient storage}, made once a state
        self._accs: list = [{} for _ in self.devices]

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

    def _acc(self, state: MultisliceState, s: int) -> dict:
        """Stage s's gradient storage: one f32 zeros tensor a param, made
        once (a captured program adds into it at every replay), that the
        microbatches accumulate into and the update reads as ``.grad``."""
        accs = self._accs[s]
        for n, p in state.params[s].items():
            a = accs.get(n)
            if a is None or a.shape != p.shape or a.device != p.device:
                accs[n] = torch.zeros_like(
                    p, memory_format=torch.contiguous_format)
        return accs

    def _fwd(self, params: dict, x: torch.Tensor) -> dict:
        with torch.no_grad():
            return {"h": self._stage_fwd(params, x)}

    def _bwd(self, s: int, params: dict, accs: dict, x: torch.Tensor,
             g: torch.Tensor) -> dict:
        """The stage forward recomputed from its input, its gradients
        added into ``accs``; the input's cotangent (stage > 0)."""
        names = list(params)
        ins = ([x] if s > 0 else []) + [params[n] for n in names]
        with torch.enable_grad():
            grads = torch.autograd.grad(self._stage_fwd(params, x), ins, g)
        with torch.no_grad():
            torch._foreach_add_([accs[n] for n in names],
                                list(grads[len(ins) - len(names):]))
        return {"cot": grads[0]} if s > 0 else {}

    def _fwdbwd(self, params: dict, accs: dict, x: torch.Tensor,
                tok: torch.Tensor) -> dict:
        """The last stage: forward, head, loss and backward, with the 1/M
        of the step's mean on every gradient; loss, aux (``aux/<key>``)
        and, after a first stage, the input's cotangent."""
        names = list(params)
        cot = self.num_stages > 1
        ins = ([x] if cot else []) + [params[n] for n in names]
        with torch.enable_grad():
            h = self._stage_fwd({n: v for n, v in params.items()
                                 if not n.startswith("head.")}, x)
            loss, aux = self.head_loss_fn(_sub(params, "head."), h, tok)
            grads = torch.autograd.grad(loss / self.num_microbatches, ins)
        with torch.no_grad():
            torch._foreach_add_([accs[n] for n in names],
                                list(grads[len(ins) - len(names):]))
        out = {"loss": loss.detach(),
               **{f"aux/{k}": v.detach() for k, v in aux.items()}}
        if cot:
            out["cot"] = grads[0]
        return out

    def _sync(self, stage: int) -> None:
        if self.devices[stage].type == "cuda":
            torch.cuda.synchronize(self.devices[stage])

    def _transfer(self, x: torch.Tensor, stage: int, record: list,
                  into: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Explicit cross-stage transfer, counted by its bytes: a real
        copy onto the stage's device, or into a program's static input
        ``into``."""
        if into is None:
            y = x.detach().to(self.devices[stage], copy=True)
        elif into.shape != x.shape or into.dtype != x.dtype:
            raise ValueError(f"a {x.dtype} {tuple(x.shape)} transfer into "
                             f"a program built for {into.dtype} "
                             f"{tuple(into.shape)}")
        else:
            with torch.no_grad():
                y = into.copy_(x)
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
        progs = self._programs
        if progs and state is not self._programs_state:
            raise ValueError("the captured stage programs run the state "
                             "they were built for")
        mb = B // M
        t_wall0 = time.perf_counter()
        transfers: list[int] = []
        durations: dict = {}
        fwd_out: dict = {}      # (stage, micro) -> activation (on stage)
        cot_in: dict = {}       # (stage, micro) -> incoming cotangent
        losses: list = []
        auxes: list = []
        accs = [self._acc(state, s) for s in range(S)]
        # the host split, each microbatch placed on stage 0
        micro_tok = [tokens[m * mb:(m + 1) * mb].to(self.devices[0])
                     for m in range(M)]

        def run_op(kind, s, m):
            t0 = time.perf_counter()
            params = state.params[s]
            prog = progs.get((kind, s))
            if prog is not None:
                run_program(prog, kind, s, m)
            elif kind == FWD:
                x = micro_tok[m] if s == 0 else \
                    self._transfer(fwd_out[(s - 1, m)], s, transfers)
                fwd_out[(s, m)] = self._fwd(params, x)["h"]
            elif kind == FWDBWD:
                if S == 1:
                    x = tok = micro_tok[m]
                else:
                    x = self._transfer(fwd_out.pop((s - 1, m)), s,
                                       transfers).requires_grad_()
                    tok = self._transfer(micro_tok[m], s, transfers)
                out = self._fwdbwd(params, accs[s], x, tok)
                keep_last(out, s, m)
            else:  # BWD: the stage forward recomputed from its input
                g = self._transfer(cot_in.pop((s, m)), s, transfers)
                x = micro_tok[m] if s == 0 else fwd_out[(s - 1, m)]
                if s > 0:
                    # the saved input lives on the previous stage's
                    # device: placed, not counted
                    x = x.to(self.devices[s], copy=True).requires_grad_()
                out = self._bwd(s, params, accs[s], x, g)
                if s > 0:
                    cot_in[(s - 1, m)] = out["cot"]
                fwd_out.pop((s - 1, m), None)
            self._sync(s)
            durations[(kind, s, m)] = time.perf_counter() - t0

        def keep_last(out, s, m):
            losses.append(out["loss"])
            auxes.append({k[4:]: v for k, v in out.items()
                          if k.startswith("aux/")})
            if S > 1:
                cot_in[(s - 1, m)] = out["cot"]

        def run_program(prog, kind, s, m):
            # the same op through the program's static buffers; what the
            # schedule keeps past this op is copied out of them before the
            # program replays again
            inp = prog.inputs
            if kind == FWD:
                if s == 0:
                    prog.place("x", micro_tok[m])
                else:
                    self._transfer(fwd_out[(s - 1, m)], s, transfers,
                                   into=inp["x"])
                fwd_out[(s, m)] = prog.run()["h"].clone()
            elif kind == FWDBWD:
                if S == 1:
                    prog.place("tok", micro_tok[m])
                else:
                    self._transfer(fwd_out.pop((s - 1, m)), s, transfers,
                                   into=inp["x"])
                    self._transfer(micro_tok[m], s, transfers,
                                   into=inp["tok"])
                keep_last({k: v.clone() for k, v in prog.run().items()},
                          s, m)
            else:
                self._transfer(cot_in.pop((s, m)), s, transfers,
                               into=inp["g"])
                prog.place("x", micro_tok[m] if s == 0
                           else fwd_out[(s - 1, m)])
                out = prog.run()
                if s > 0:
                    cot_in[(s - 1, m)] = out["cot"].clone()
                fwd_out.pop((s - 1, m), None)

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
        # stage's update (eager: one K3 launch a stage with fused_adam),
        # clipped by it; the gradient storage is zeroed in place
        for s in range(S):
            for n, p in state.params[s].items():
                p.grad = accs[s][n]
        sq = [float(torch.stack([a.float().square().sum()
                                 for a in accs[s].values()]).sum())
              for s in range(S)]
        gnorm = float(np.sqrt(sum(sq)))
        for s in range(S):
            state.opt_state[s].step(grad_norm=torch.tensor(
                gnorm, dtype=torch.float32, device=self.devices[s]))
            torch._foreach_zero_(list(accs[s].values()))
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

    # -- the captured stage programs (the AOT warm start) --------------------

    @property
    def num_programs(self) -> int:
        """Schedule-facing programs: FWD + BWD per non-last stage, one
        fused FWDBWD on the last — 2S-1 (1 when S == 1)."""
        return max(1, 2 * self.num_stages - 1)

    @property
    def programs(self) -> dict:
        """The captured programs, ``(kind, stage) -> StageProgram``."""
        return self._programs

    def reset_programs(self) -> None:
        """Drop every captured program and zero the gradient storage: the
        last rung of the AOT fallback ladder (a program that fails at its
        first replay leaves the step to the eager ops)."""
        self._programs.clear()
        self._programs_state = None
        self._failed.clear()
        with torch.no_grad():
            for accs in self._accs:
                for a in accs.values():
                    a.zero_()

    def program_inputs(self, state: MultisliceState, batch: dict):
        """(stage, program kind, example inputs) for every schedule-facing
        program: each input a tensor of the shape and dtype the schedule
        feeds, on the stage's device — the microbatch's tokens (stage 0's
        ``x``, the last stage's ``tok``), the incoming activation ``x``
        and the cotangent ``g`` (zeros: a capture reads them at replay).
        The activation is shaped as the embedding's output, which every
        block keeps."""
        tokens = torch.as_tensor(batch["tokens"])
        mb = tokens.shape[0] // self.num_microbatches
        tok = tokens[:mb]
        with torch.no_grad():
            h = self.embed_fn(_sub(state.params[0], "embed."),
                              tok.to(self.devices[0]))
        for s, dev in enumerate(self.devices):
            tok_s = tok.to(dev, copy=True)
            act = torch.zeros(h.shape, dtype=h.dtype, device=dev)
            if s == self.num_stages - 1:
                yield s, FWDBWD, ({"tok": tok_s} if s == 0 else
                                  {"x": act, "tok": tok_s})
                continue
            x = tok_s if s == 0 else act
            yield s, FWD, {"x": x}
            yield s, BWD, {"x": x, "g": torch.zeros_like(act)}

    def _capture(self, state: MultisliceState, kind: str, s: int,
                 example: dict) -> "StageProgram":
        if self._programs_state not in (None, state):
            raise ValueError("the stage programs run one state")
        prog = StageProgram(self, state, kind, s, example)
        self._programs_state = state
        return prog

    def export_stages(self, aot_dir: str, state: MultisliceState,
                      batch: dict,
                      key_fn: Callable[[int, str], str]) -> list[str]:
        """Capture every program not captured yet and write its record
        (runtime/aot.py) under ``key_fn(stage, kind)``; returns the keys
        written. A program that does not capture counts
        ``export-failed`` and runs eagerly: the job trains."""
        from ..runtime import aot as aot_mod
        written = []
        for s, kind, example in self.program_inputs(state, batch):
            if (kind, s) in self._programs or (kind, s) in self._failed:
                continue
            try:
                prog = self._capture(state, kind, s, example)
            except Exception as e:  # noqa: BLE001 - an optimization only
                log.warning("AOT: stage %d %s did not capture (%s); it "
                            "runs eagerly", s, kind, e)
                aot_mod._count("export-failed")
                self._failed.add((kind, s))
                continue
            self._programs[(kind, s)] = prog
            key = key_fn(s, kind)
            if aot_mod.export_step(aot_dir, key, prog,
                                   aot_mod.program_signature(
                                       state.params[s], example)):
                written.append(key)
        return written

    def load_stages(self, aot_dir: str, state: MultisliceState,
                    batch: dict,
                    key_fn: Callable[[int, str], str]) -> int:
        """The warm-start rung: each program whose record verifies (its
        kernel libraries loaded from the build cache, no ``nvcc``) is
        captured now. A record that fails its checks is counted under the
        reference's outcome names and left to :meth:`export_stages`; one
        that verifies but whose program does not capture counts
        ``deserialize-failed`` and runs eagerly. Returns how many
        programs loaded."""
        from ..runtime import aot as aot_mod
        loaded = 0
        for s, kind, example in self.program_inputs(state, batch):
            record = aot_mod.load_step(
                aot_dir, key_fn(s, kind),
                aot_mod.program_signature(state.params[s], example))
            if record is None:
                continue
            try:
                prog = self._capture(state, kind, s, example)
                if prog.static_inputs != record["static_inputs"]:
                    raise ValueError("the captured program reads other "
                                     "inputs than the record names")
            except Exception as e:  # noqa: BLE001 - an optimization only
                log.warning("AOT: stage %d %s did not capture from its "
                            "record (%s); it runs eagerly", s, kind, e)
                aot_mod._count("deserialize-failed")
                self._failed.add((kind, s))
                continue
            self._programs[(kind, s)] = prog
            loaded += 1
        return loaded


class StageProgram:
    """One stage program — FWD, BWD or FWDBWD of stage ``s`` — captured
    as a CUDA graph on the stage's device over static buffers, and
    replayed M times a step:

    - ``inputs``: the static input buffers (``x``, ``tok``, ``g``); the
      engine copies each microbatch's tensors in (a counted transfer or a
      placement) before :meth:`run`;
    - ``outputs``: the static outputs (``h``; ``cot``; ``loss``,
      ``aux/<key>``), overwritten by the next replay: the engine copies
      out whatever the schedule keeps;
    - the gradients are added into the stage's gradient storage (the
      engine's, read by the update as ``.grad``) inside the graph.

    Capturing warms the program up once on a side stream (kernels
    loaded) and restores the gradient storage, then captures. A replay
    does not pass through the kernel wrappers' counters: the launches of
    the capture (:attr:`launches`) are added at every replay, and the
    capture's own are not counted. On the CPU there is no graph: each run
    executes the body eagerly through the same static buffers."""

    def __init__(self, engine: MPMDPipeline, state: MultisliceState,
                 kind: str, s: int, example: dict):
        self.engine, self.kind, self.stage = engine, kind, s
        self.device = engine.devices[s]
        self.params = state.params[s]
        self.accs = engine._acc(state, s)
        self.inputs = {k: torch.empty_like(v, device=self.device)
                       for k, v in example.items()}
        if kind != FWD and s > 0:
            self.inputs["x"].requires_grad_()
        self.static_inputs = sorted(f"params/{n}" for n in self.params) + \
            [f"input/{k}" for k in sorted(self.inputs)]
        self.outputs: dict = {}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: dict = {}
        self.replays = 0
        for k, v in example.items():
            self.place(k, v)
        if self.device.type == "cuda":
            from ..runtime.trainstep import kernel_counters
            self._counters = kernel_counters()
            with torch.cuda.device(self.device):
                self._capture()

    def place(self, name: str, value: torch.Tensor) -> None:
        """Copy ``value`` into the static input ``name`` (not counted as
        a transfer: the caller counts what crosses stages)."""
        with torch.no_grad():
            self.inputs[name].copy_(value)

    def _body(self) -> dict:
        e, inp = self.engine, self.inputs
        if self.kind == FWD:
            return e._fwd(self.params, inp["x"])
        if self.kind == BWD:
            return e._bwd(self.stage, self.params, self.accs, inp["x"],
                          inp["g"])
        return e._fwdbwd(self.params, self.accs, inp.get("x", inp["tok"]),
                         inp["tok"])

    def _capture(self) -> None:
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        snap = [a.clone() for a in self.accs.values()]
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            # the warm-up: one run, then the gradient storage restored
            self._body()
            with torch.no_grad():
                for a, b in zip(self.accs.values(), snap):
                    a.copy_(b)
        cur.wait_stream(side)
        del snap
        counters = self._counters
        at = {n: getattr(f, a) for n, (f, a) in counters.items()}
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side):
                out = self._body()
            self.launches = {n: getattr(f, a) - at[n]
                             for n, (f, a) in counters.items()
                             if getattr(f, a) != at[n]}
        finally:
            for n, (f, a) in counters.items():
                setattr(f, a, at[n])
        self.graph = graph
        self.outputs = out

    def run(self) -> dict:
        """One replay (the CPU: the body through the static outputs);
        returns :attr:`outputs`."""
        if self.graph is None:
            with torch.no_grad():
                for k, v in self._body().items():
                    self.outputs.setdefault(k, torch.empty_like(v))
                    self.outputs[k].copy_(v)
        else:
            self.graph.replay()
            for n, k in self.launches.items():
                f, a = self._counters[n]
                setattr(f, a, getattr(f, a) + k)
        self.replays += 1
        return self.outputs
