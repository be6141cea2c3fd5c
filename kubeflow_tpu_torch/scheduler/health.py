"""Node-health scoring, quarantine and suspect-host contracts.

The parts of ``kubeflow_tpu/scheduler/health.py`` the operator loop and
the serving fleet use, copied:

- **The exponential-decay failure score.** A record carries ``(score,
  time)``, so any writer can decay the stored score to now and add an
  event's weight without a shared clock (``fold_event``); the decay is
  the forgiveness — a member that stops failing earns its way back. The
  operator (``controllers/tpujob.py``) folds pod crashes, stalled
  workers, step-time skew and numeric anomalies into the
  ``kubeflow.org/health`` annotation of the node they ran on
  (``record_host_event``); the fleet router (``serving/fleet.py``) folds
  per-replica serving evidence into each replica's circuit breaker with
  its own kinds and weights.
- **Quarantine.** When a host's decayed score crosses
  ``HealthConfig.quarantine_threshold`` the slice scheduler
  (``scheduler/core.py``) writes the ``kubeflow.org/quarantine``
  annotation (``quarantine_record``); ``SliceInventory.from_nodes``
  carves quarantined nodes out of placement. Release is probational
  (``release_eligible``): expiry passed AND score decayed below
  ``release_threshold``; ``reason: "manual"`` never auto-releases.
- **Suspect rebind.** The operator records the node a gang teardown is
  attributable to in the job's suspect-host annotation; the scheduler
  replans the binding EXCLUDING that node's cells and clears the
  annotation on the rebind.
- **Host ↔ cell mapping.** A host is a node, and node row ``i`` of a
  pool is its ``host_cells``: one cell a GPU.

The annotation names live in ``api/trainingjob.py``. Stdlib only.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass
from typing import Iterable, Optional

from ..api import k8s
from ..api.trainingjob import (HEALTH_ANNOTATION, QUARANTINE_ANNOTATION,
                               SUSPECT_ANNOTATION)

log = logging.getLogger(__name__)

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


# quarantine reason a human writes; never auto-released
MANUAL_REASON = "manual"

# Step-skew detection (the straggler signal: healthy chief, one slow
# worker). A worker whose heartbeat step trails the chief's by at least
# STEP_SKEW_MIN_STEPS on STEP_SKEW_STREAK consecutive reconciles is a
# straggler — the operator folds one step-skew event per full streak
# (controllers/tpujob.py), so a single slow window never scores but a
# persistently slow host accumulates toward quarantine. BOTH heartbeats
# must be FRESH (beat age under the job's stall timeout, or
# STEP_SKEW_FRESH_S when no watchdog is configured): a frozen heartbeat
# is a hung WORKER, not a slow host — without the freshness gate a
# wedged pod on a watchdog-less job would slowly quarantine a healthy
# host on step-skew evidence alone.
STEP_SKEW_MIN_STEPS = 4
STEP_SKEW_STREAK = 3
STEP_SKEW_FRESH_S = 300.0


@dataclass
class HealthConfig:
    """The scheduler's health policy surface (the ``health`` key of the
    tpu-scheduler ConfigMap; scheduler/queue.py SchedulerConfig carries
    one).
    ``enabled=False`` is the placement-blind baseline: no scoring, no
    quarantine writes, no suspect evacuation."""

    enabled: bool = True
    # score half-life: a weight-1 event reads as 0.5 after this long
    half_life_s: float = 600.0
    # decayed score at/above which a host is quarantined
    quarantine_threshold: float = 3.0
    # score at/below which an EXPIRED quarantine releases (probation:
    # expiry alone is not enough — a still-failing host stays out)
    release_threshold: float = 1.0
    # quarantine duration per grant (extended while the score stays hot)
    quarantine_s: float = 900.0

    KEYS = ("enabled", "halfLifeSeconds", "quarantineThreshold",
            "releaseThreshold", "quarantineSeconds")

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "HealthConfig":
        d = dict(d or {})
        unknown = set(d) - set(cls.KEYS)
        if unknown:
            # a typo'd knob must fail loudly at render/parse time, not
            # silently run with the default it meant to override
            raise ValueError(
                f"unknown health config keys {sorted(unknown)}; "
                f"valid: {list(cls.KEYS)}")
        return cls(
            enabled=bool(d.get("enabled", True)),
            half_life_s=float(d.get("halfLifeSeconds", 600.0)),
            quarantine_threshold=float(d.get("quarantineThreshold", 3.0)),
            release_threshold=float(d.get("releaseThreshold", 1.0)),
            quarantine_s=float(d.get("quarantineSeconds", 900.0)))

    def to_dict(self) -> dict:
        return {"enabled": self.enabled,
                "halfLifeSeconds": self.half_life_s,
                "quarantineThreshold": self.quarantine_threshold,
                "releaseThreshold": self.release_threshold,
                "quarantineSeconds": self.quarantine_s}


# ---------------------------------------------------------- health score


def health_of(node: dict) -> dict:
    """The raw health record off a node's annotation: ``{"score": s,
    "time": t, "events": n, "last": kind}``; zeros when absent or
    malformed (garbage degrades to healthy, never crashes a pass)."""
    raw = k8s.annotations_of(node).get(HEALTH_ANNOTATION)
    if not raw:
        return {"score": 0.0, "time": 0.0, "events": 0, "last": ""}
    try:
        d = json.loads(raw)
        return {"score": float(d.get("score", 0.0)),
                "time": float(d.get("time", 0.0)),
                "events": int(d.get("events", 0)),
                "last": str(d.get("last", ""))}
    except (AttributeError, TypeError, ValueError):
        return {"score": 0.0, "time": 0.0, "events": 0, "last": ""}


def decayed_score(node: dict, now: Optional[float] = None,
                  half_life_s: float = 600.0) -> float:
    """The host's CURRENT score: the stored score decayed from its
    stored timestamp to ``now``. A future-stamped record (writer clock
    skew) decays from now — clamped, never infinitely fresh."""
    now = time.time() if now is None else now
    rec = health_of(node)
    if rec["score"] <= 0.0:
        return 0.0
    age = max(0.0, now - rec["time"])
    return rec["score"] * 0.5 ** (age / max(half_life_s, 1e-9))


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


def record_host_event(client, node_name: str, kind: str,
                      job_key: str = "", now: Optional[float] = None,
                      half_life_s: float = 600.0) -> Optional[dict]:
    """Fold one failure event into a node's health annotation —
    conflict-safe (cluster/client.py update_with_conflict_retry): the
    fold recomputes off the FRESH record per attempt and the write
    carries the read's resourceVersion, so two writers folding the
    same instant (operator recording a crash while the scheduler folds
    a flap) both land — the blind-patch version of this RMW could lose
    one. Still best-effort by contract: evidence recording must never
    block a recovery path — any error logs and returns None."""
    from ..cluster.client import apply_annotations, update_with_conflict_retry
    now = time.time() if now is None else now
    out: dict = {}

    def _mutate(obj: dict) -> dict:
        rec = fold_event(health_of(obj), kind, now,
                         half_life_s=half_life_s)
        out.clear()
        out.update(rec)
        return apply_annotations(obj, {HEALTH_ANNOTATION:
                                       json.dumps(rec)})

    try:
        update_with_conflict_retry(client, "v1", "Node", "", node_name,
                                   _mutate)
        log.info("health: %s on %s (job %s) -> score %.2f",
                 kind, node_name, job_key or "?", out["score"])
        return dict(out)
    except Exception as e:  # noqa: BLE001 — evidence must not kill recovery
        log.warning("health: recording %s on %s failed: %s",
                    kind, node_name, e)
        return None


# ------------------------------------------------------------ quarantine


def quarantine_of(node: dict) -> Optional[dict]:
    """The node's quarantine record ``{"reason": r, "score": s,
    "since": t, "until": t|None, "cordoned": bool}``, or None when
    absent/malformed. ``cordoned`` marks that the SCHEDULER cordoned
    the node alongside the quarantine (so release knows to uncordon —
    it must never uncordon a human's cordon). THE one parse of the
    quarantine wire contract — inventory, scheduler, operator tooling,
    and dashboard all read through here."""
    raw = k8s.annotations_of(node).get(QUARANTINE_ANNOTATION)
    if not raw:
        return None
    try:
        d = json.loads(raw)
        until = d.get("until")
        return {"reason": str(d.get("reason", "")),
                "score": float(d.get("score", 0.0)),
                "since": float(d.get("since", 0.0)),
                "until": float(until) if until is not None else None,
                "cordoned": bool(d.get("cordoned", False))}
    except (AttributeError, TypeError, ValueError):
        # unparseable quarantine reads as quarantined-forever-manual:
        # fail SAFE (keep the host out) and let a human fix the JSON
        return {"reason": MANUAL_REASON, "score": 0.0, "since": 0.0,
                "until": None, "cordoned": False}


def quarantine_record(reason: str, score: float, now: float,
                      duration_s: Optional[float],
                      cordoned: bool = False) -> str:
    """Serialize a quarantine annotation value; ``duration_s=None``
    means no expiry (manual release only). ``cordoned=True`` records
    that the writer also cordoned the node (``spec.unschedulable``) —
    cell carving alone cannot stop the kube scheduler from placing a
    gang's pods back onto the node by its pool label; the cordon closes
    that hole."""
    return json.dumps({
        "reason": reason, "score": round(score, 6), "since": now,
        "until": (now + duration_s) if duration_s is not None else None,
        "cordoned": cordoned})


def is_quarantined(node: dict) -> bool:
    """Whether placement must keep off this host NOW. An expired
    quarantine still counts until the scheduler's release pass clears
    the annotation — release is a policy decision (the score must have
    decayed too), not a timer."""
    return quarantine_of(node) is not None


def release_eligible(node: dict, cfg: HealthConfig,
                     now: Optional[float] = None) -> bool:
    """Probational auto-release: expiry passed AND the decayed score is
    back under the release threshold. Manual quarantines (or records
    without an expiry) never auto-release."""
    now = time.time() if now is None else now
    q = quarantine_of(node)
    if q is None or q["reason"] == MANUAL_REASON or q["until"] is None:
        return False
    if now < q["until"]:
        return False
    return decayed_score(node, now, cfg.half_life_s) <= \
        cfg.release_threshold


# --------------------------------------------------------- suspect hosts


def suspect_of(manifest: dict) -> Optional[str]:
    """The node name the operator attributed this job's last gang
    teardown to, or None. Consumed by the scheduler's replan pass
    (exclude the suspect's cells) and cleared on the rebind."""
    raw = k8s.annotations_of(manifest).get(SUSPECT_ANNOTATION)
    return raw or None


# ------------------------------------------------- host <-> cell mapping


def host_cells(pool: str, topology,
               host_index: int) -> Iterable[tuple[str, int, int]]:
    """The inventory cells one host contributes. A host is a node, and
    node row ``host_index`` of its pool holds one cell a GPU of the
    node's ``topology`` (the whole node's slice, ``h100-8``)."""
    for j in range(topology.num_gpus):
        yield (pool, host_index, j)


def host_sort_key(name: str) -> tuple:
    """Natural order for node names: the trailing integer sorts
    numerically ("pool-h100-8-10" after "pool-h100-8-9"), so node rows
    are stable however many nodes a pool has."""
    import re
    m = re.search(r"(\d+)$", name)
    return (name[:m.start()], int(m.group(1))) if m else (name, -1)


def host_name_index(name: str) -> Optional[int]:
    """The node row a node's NAME claims (its trailing integer — the
    shape cluster/fake.py add_gpu_nodes produces), or None for
    unnumbered names. Used by inventory.from_nodes so a DELETED middle
    node keeps every other node's row fixed: positional assignment would
    shift every later node one row over and invalidate its bindings."""
    import re
    m = re.search(r"(\d+)$", name)
    return int(m.group(1)) if m else None
