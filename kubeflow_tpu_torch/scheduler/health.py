"""The exponential-decay failure score: fold one event into a record.

The part of ``kubeflow_tpu/scheduler/health.py`` the serving fleet uses.
A record carries ``(score, time)``, so any writer can decay the stored
score to now and add an event's weight without a shared clock; the decay
is the forgiveness — a member that stops failing earns its way back. The
JAX package folds node evidence into a host's health annotation with it;
the fleet router (serving/fleet.py) folds per-replica serving evidence
into each replica's circuit breaker with its own kinds and weights.
Stdlib only.
"""

from __future__ import annotations

from typing import Optional

# Event kinds and their score weights (the node-health vocabulary; the
# writer applies them at fold time). A pod crash or a stalled worker is
# hard evidence; a step-time skew observation is soft and accumulates; a
# numeric-integrity anomaly weighs above a crash.
EVENT_POD_CRASH = "pod-crash"
EVENT_STALL = "stall"
EVENT_WORKER_STALL = "worker-stall"
EVENT_NOT_READY = "not-ready"
EVENT_STEP_SKEW = "step-skew"
EVENT_NUMERIC_ANOMALY = "numeric-anomaly"

EVENT_WEIGHTS = {
    EVENT_POD_CRASH: 1.0,
    EVENT_STALL: 1.0,
    EVENT_WORKER_STALL: 1.0,
    EVENT_NOT_READY: 1.0,
    EVENT_STEP_SKEW: 0.25,
    EVENT_NUMERIC_ANOMALY: 2.0,
}


def fold_event(rec: dict, kind: str, now: float,
               half_life_s: float = 600.0,
               weight: Optional[float] = None) -> dict:
    """Pure fold: decay the stored score to ``now``, add the event's
    weight. ``weight`` overrides the EVENT_WEIGHTS lookup — other
    evidence vocabularies (the fleet's per-replica circuit breakers)
    reuse this exact scoring shape with their own kinds and weights."""
    age = max(0.0, now - rec.get("time", 0.0))
    decayed = float(rec.get("score", 0.0)) * \
        0.5 ** (age / max(half_life_s, 1e-9))
    w = EVENT_WEIGHTS.get(kind, 1.0) if weight is None else float(weight)
    return {"score": round(decayed + w, 6),
            "time": now, "events": int(rec.get("events", 0)) + 1,
            "last": kind}
