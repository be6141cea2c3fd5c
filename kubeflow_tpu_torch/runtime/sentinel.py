"""Numeric integrity sentinel: in-step anomaly detection.

The port of ``kubeflow_tpu/runtime/sentinel.py``. A card computing wrong
numbers (silent data corruption, a NaN-producing kernel, a loss blowup
after a bad batch) crashes nothing; the sentinel rides the worker's
window drain (runtime/worker.py), where the loss and the global grad
norm are already host floats, so detection costs one host compare per
closed window. Detectors, in the order they run:

- NaN/Inf on the global grad norm (``nan-grad``);
- cross-replica agreement on the post-update param square norm that
  every replica of the sharded update recomputes
  (``param_sqnorm_replicas``, runtime/trainstep.py): disagreement beyond
  ``AGREEMENT_RTOL`` names a replica (``replica-skew``);
- NaN/Inf on the loss (``nan-loss``);
- a rolling z-score spike on the loss (``loss-spike``: EWMA mean and
  variance over ``window_steps``; armed once the window has filled, and
  only upward).

A trip produces an :class:`AnomalyEvidence` that the worker posts to its
pod's ``ANOMALY_ANNOTATION`` before exiting ``ANOMALY_EXIT_CODE``; the
operator rolls the job back to the last-known-good (LKG) checkpoint.
The names, defaults, exit code and wire format are the JAX package's.

:class:`NumericFaultHook` is the chaos tier's injection contract: at an
armed step it corrupts the train state in place the way the named fault
would. Torch is imported only where the state is touched.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..obs import registry as obsreg

# worker exit status after a tripped detector: distinct from a clean exit
# and from the preemption code 75 (EX_PROTOCOL: the numbers broke the
# contract)
ANOMALY_EXIT_CODE = 76

# operator → worker rollback contract: restore the newest intact step <=
# KFTPU_RESUME_STEP (the LKG), then discard the tainted newer steps;
# KFTPU_REPLAY_RANGE ("lkg:trip") arms the replay bisection verdict
RESUME_STEP_ENV = "KFTPU_RESUME_STEP"
REPLAY_RANGE_ENV = "KFTPU_REPLAY_RANGE"

# detector kinds (the kftpu_anomaly_total{kind} label vocabulary;
# "heartbeat-nan" is the operator's flag for workers whose own sentinel
# is off)
KIND_NAN_LOSS = "nan-loss"
KIND_NAN_GRAD = "nan-grad"
KIND_LOSS_SPIKE = "loss-spike"
KIND_REPLICA_SKEW = "replica-skew"
KIND_HEARTBEAT_NAN = "heartbeat-nan"
ANOMALY_KINDS = (KIND_NAN_LOSS, KIND_NAN_GRAD, KIND_LOSS_SPIKE,
                 KIND_REPLICA_SKEW, KIND_HEARTBEAT_NAN)

# defaults of the spec.integrity knobs: spikeZ 8 is deliberately wide
# (a spurious trip costs a gang restart; a real blowup clears z = 8 by
# orders of magnitude)
DEFAULT_SPIKE_Z = 8.0
DEFAULT_WINDOW_STEPS = 32
DEFAULT_CHECK_EVERY = 10
# the compared quantity is the same replicated math on every replica, so
# the tolerance only absorbs nondeterministic reduction orders
AGREEMENT_RTOL = 1e-3


def anomaly_counter():
    """The shared kftpu_anomaly_total{kind} counter."""
    return obsreg.counter(
        "kftpu_anomaly_total",
        "numeric anomalies detected, by detector kind",
        labels=("kind",))


def lkg_gauge():
    """kftpu_lkg_step: the newest last-known-good checkpoint step."""
    return obsreg.default_registry().gauge(
        "kftpu_lkg_step",
        "newest last-known-good checkpoint step (sentinel-cleared)")


@dataclass
class AnomalyEvidence:
    """One tripped detector, in the wire format the pod annotation
    carries. ``lkg`` is the rollback target the worker knew at trip time
    (None when no checkpoint had been cleared yet)."""

    kind: str
    step: int
    value: float
    lkg: Optional[int] = None
    detail: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "step": int(self.step),
             # NaN/Inf must survive strict-JSON consumers: stringify
             "value": repr(float(self.value)),
             "lkg": self.lkg if self.lkg is None else int(self.lkg)}
        if self.detail:
            d["detail"] = self.detail
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, raw: str) -> Optional["AnomalyEvidence"]:
        """Parse the annotation payload; None on garbage."""
        try:
            d = json.loads(raw)
            return cls(kind=str(d["kind"]), step=int(d["step"]),
                       value=float(d.get("value", "nan")),
                       lkg=None if d.get("lkg") is None
                       else int(d["lkg"]),
                       detail=dict(d.get("detail") or {}))
        except (KeyError, TypeError, ValueError):
            return None


def _bad(x: float) -> bool:
    return not math.isfinite(x)


class NumericSentinel:
    """Stateful per-worker detector bank over the window-drained host
    floats. ``observe`` returns evidence on a trip, None on a clean
    window."""

    def __init__(self, spike_z: float = DEFAULT_SPIKE_Z,
                 window_steps: int = DEFAULT_WINDOW_STEPS,
                 agreement_rtol: float = AGREEMENT_RTOL):
        if spike_z <= 0:
            raise ValueError(f"spike_z must be > 0, got {spike_z}")
        if window_steps < 2:
            raise ValueError(
                f"window_steps must be >= 2, got {window_steps}")
        self.spike_z = float(spike_z)
        self.window_steps = int(window_steps)
        self.agreement_rtol = float(agreement_rtol)
        # EWMA mean/variance of the loss, alpha = 2/(window+1); updated
        # only on accepted samples, so an anomaly never enters the
        # baseline
        self._alpha = 2.0 / (self.window_steps + 1.0)
        self._n = 0
        self._mean = 0.0
        self._var = 0.0
        self.trips = 0

    def _trip(self, kind: str, step: int, value: float,
              lkg: Optional[int], **detail) -> AnomalyEvidence:
        self.trips += 1
        anomaly_counter().labels(kind=kind).inc()
        return AnomalyEvidence(kind=kind, step=int(step),
                               value=float(value), lkg=lkg,
                               detail=detail)

    def observe(self, step: int, loss: Optional[float] = None,
                grad_norm: Optional[float] = None,
                replica_sqnorms: Optional[Sequence[float]] = None,
                lkg: Optional[int] = None) -> Optional[AnomalyEvidence]:
        """Feed one drained window's host floats; evidence on a trip."""
        if grad_norm is not None:
            g = float(grad_norm)
            if _bad(g):
                return self._trip(KIND_NAN_GRAD, step, g, lkg)
        if replica_sqnorms is not None:
            ev = self._check_agreement(step, replica_sqnorms, lkg)
            if ev is not None:
                return ev
        if loss is None:
            return None
        x = float(loss)
        if _bad(x):
            return self._trip(KIND_NAN_LOSS, step, x, lkg)
        # the first window_steps samples set the baseline (a fresh
        # model's loss cliff is not an anomaly)
        if self._n >= self.window_steps:
            sd = math.sqrt(max(self._var, 0.0))
            if sd > 0.0:
                z = (x - self._mean) / sd
                if z > self.spike_z:
                    return self._trip(KIND_LOSS_SPIKE, step, x, lkg,
                                      z=round(z, 2),
                                      mean=round(self._mean, 6),
                                      sd=round(sd, 6))
        delta = x - self._mean
        self._mean += self._alpha * delta
        self._var = (1.0 - self._alpha) * \
            (self._var + self._alpha * delta * delta)
        self._n += 1
        return None

    def _check_agreement(self, step: int, sqnorms: Sequence[float],
                         lkg: Optional[int]) -> Optional[AnomalyEvidence]:
        vals = [float(v) for v in sqnorms]
        if len(vals) < 2:
            return None
        for i, v in enumerate(vals):
            if _bad(v):
                return self._trip(KIND_REPLICA_SKEW, step, v, lkg,
                                  replica=i)
        med = sorted(vals)[len(vals) // 2]
        scale = max(abs(med), 1e-12)
        worst_i = max(range(len(vals)),
                      key=lambda i: abs(vals[i] - med))
        rel = abs(vals[worst_i] - med) / scale
        if rel > self.agreement_rtol:
            return self._trip(KIND_REPLICA_SKEW, step, vals[worst_i],
                              lkg, replica=worst_i,
                              rel=repr(rel), median=repr(med))
        return None


def parse_replay_range(raw: Optional[str]) -> Optional[tuple]:
    """Parse ``KFTPU_REPLAY_RANGE`` ("lkg:trip"); None when absent or
    malformed."""
    if not raw:
        return None
    try:
        lo, hi = raw.split(":", 1)
        lo_i, hi_i = int(lo), int(hi)
    except ValueError:
        return None
    return (lo_i, hi_i) if hi_i > lo_i >= 0 else None


# The chaos injection contract:
#   KFTPU_CHAOS_NUMERIC = "<kind>:<step>[:<scale>]"
#   KFTPU_CHAOS_NUMERIC_MARK = the fire-count file (it persists across
#       restarts, so a rolled-back segment does not poison itself again)
#   KFTPU_CHAOS_NUMERIC_FIRES = the fire budget (default 1)
NUMERIC_FAULT_ENV = "KFTPU_CHAOS_NUMERIC"
NUMERIC_FAULT_MARK_ENV = "KFTPU_CHAOS_NUMERIC_MARK"
NUMERIC_FAULT_FIRES_ENV = "KFTPU_CHAOS_NUMERIC_FIRES"
NUMERIC_FAULT_KINDS = ("nan", "spike", "bitflip")


class NumericFaultHook:
    """Worker-side poisoner: at the armed step, scale the params the way
    the named fault would. None from :meth:`from_env` unless the chaos
    env contract is present."""

    def __init__(self, kind: str, at_step: int, scale: float,
                 mark_path: Optional[str], max_fires: int = 1):
        if kind not in NUMERIC_FAULT_KINDS:
            raise ValueError(f"unknown numeric fault kind {kind!r} "
                             f"(choose from {NUMERIC_FAULT_KINDS})")
        self.kind = kind
        self.at_step = int(at_step)
        self.scale = float(scale)
        self.mark_path = mark_path
        self.max_fires = int(max_fires)

    @classmethod
    def from_env(cls, env=None) -> Optional["NumericFaultHook"]:
        env = os.environ if env is None else env
        raw = env.get(NUMERIC_FAULT_ENV)
        if not raw:
            return None
        parts = raw.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"{NUMERIC_FAULT_ENV} must be kind:step[:scale], "
                f"got {raw!r}")
        kind, at_step = parts[0], int(parts[1])
        scale = float(parts[2]) if len(parts) > 2 else \
            {"nan": float("nan"), "spike": 8.0, "bitflip": 1.25}[kind]
        fires = int(env.get(NUMERIC_FAULT_FIRES_ENV) or 1)
        return cls(kind, at_step, scale,
                   env.get(NUMERIC_FAULT_MARK_ENV), max_fires=fires)

    def _fires(self) -> int:
        if not self.mark_path:
            return 0
        try:
            with open(self.mark_path, encoding="utf-8") as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def should_fire(self, step: int) -> bool:
        return step == self.at_step and self._fires() < self.max_fires

    def _record_fire(self) -> None:
        if not self.mark_path:
            return
        n = self._fires() + 1
        tmp = f"{self.mark_path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(str(n))
        os.replace(tmp, self.mark_path)

    def poison(self, state, step: int):
        """At the armed step, multiply every param of ``state`` (a
        ``TrainState``) in place by the fault's factor, rounded to the
        param's dtype (NaN for ``nan``, the scale for ``spike`` and
        ``bitflip``), and record the fire. Under the sharded update the
        optimizer's blocks (``update_params``) are poisoned too, or the
        next all-gather would write the clean blocks back. Returns the
        state."""
        if not self.should_fire(step):
            return state
        import torch
        factor = float("nan") if self.kind == "nan" else self.scale
        leaves = {id(p): p for p in state.params.values()}
        for u in (state.update_params or {}).values():
            leaves.setdefault(id(u), u)
        with torch.no_grad():
            for t in leaves.values():
                t.mul_(factor)
        self._record_fire()
        return state
