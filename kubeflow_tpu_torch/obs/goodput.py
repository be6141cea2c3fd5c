"""The goodput ledgers: where a training job's and a request's
wall-clock went.

The port of ``kubeflow_tpu/obs/goodput.py``, stdlib only.

- **The training ledger** folds one job's span stream (the worker's
  ``first-step``, ``window``, checkpoint, ``pipeline-bubble`` and
  ``anomaly`` spans, and the control plane's queue, bind, restart and
  resize transitions) into goodput (productive, never re-executed train
  steps) and named badput categories. It partitions the job's wall
  interval [first span start, last span end]: each elementary interval
  between span boundaries goes to exactly one category, by priority, so
  the categories sum to wall-clock by construction; time nothing claims
  is ``other``. :func:`decompose`, :func:`ledger_for`,
  :func:`categories_sum_ok`, :func:`annotation_payload`, the exported
  ``kftpu_job_*`` series and :func:`cluster_rollup` are the reference's,
  line for line, so the same span file gives the same ledger in both
  packages.
- **The serving ledger**: of one request's wall-clock, the device time
  spent on its real rows is goodput; the rest is named badput (queue,
  batch forming, pad rows, host→device copy, respond), the residual
  ``other``. One layer up, the fleet router's ledger splits a routed
  request's client wall-clock into the winning upstream attempt, retries
  and other, with a lost hedge's duplicated work named ``hedge_waste``.

The vocabulary is defined once, here; the worker (runtime/worker.py),
the request tracer (serving/request_trace.py), the replica registry
(serving/replica_state.py) and the fleet router (serving/fleet.py)
import it.
"""

from __future__ import annotations

import json
import math
from typing import Optional

from . import registry as obsreg
from .trace import load_spans

GOODPUT = "goodput"
BADPUT_QUEUE_WAIT = "queue_wait"          # admission → slice binding
BADPUT_STARTUP = "startup"                # bind → worker first activity
BADPUT_COMPILE = "compile"                # train() entry → first step,
#                                           split cold/warm/aot
BADPUT_CHECKPOINT = "checkpoint"          # save submission + restore
BADPUT_RECOMPUTE = "restart_recompute"    # steps re-executed after resume
BADPUT_ROLLBACK = "rollback_recompute"    # steps replayed LKG → trip after
#                                           an anomaly rollback
BADPUT_RESIZE = "resize"                  # resize/migration downtime
BADPUT_STALL = "stall"                    # wedged → watchdog teardown
# the MPMD pipeline's schedule idle (parallel/multislice.py's schedule
# model; the worker emits per-window pipeline-bubble spans)
BADPUT_PIPELINE_BUBBLE = "pipeline_bubble"
BADPUT_OTHER = "other"                    # unattributed residual

BADPUT_CATEGORIES = (BADPUT_QUEUE_WAIT, BADPUT_STARTUP, BADPUT_COMPILE,
                     BADPUT_CHECKPOINT, BADPUT_RECOMPUTE, BADPUT_ROLLBACK,
                     BADPUT_RESIZE, BADPUT_STALL, BADPUT_PIPELINE_BUBBLE,
                     BADPUT_OTHER)

# the operator stamps a job's final ledger here on completion
GOODPUT_ANNOTATION = "observability.kubeflow.org/goodput"

SERVING_QUEUE = "queue"                 # accept → pulled into a batch
SERVING_BATCH_FORM = "batch_form"       # cohort grouping + concat + pad
SERVING_PAD_WASTE = "pad_waste"         # device time spent on pad rows
SERVING_H2D = "h2d"                     # host → device transfer
SERVING_DEVICE = "device"               # device compute (real-row share
#                                         reported as goodput)
SERVING_RESPOND = "respond"             # drain + fan-out + serialization

SERVING_BADPUT_CATEGORIES = (SERVING_QUEUE, SERVING_BATCH_FORM,
                             SERVING_PAD_WASTE, SERVING_H2D,
                             SERVING_RESPOND, BADPUT_OTHER)

# the one summary span every request emits (stage spans are sampled;
# the ledger always lands) — serving_rollup() reads it
SERVING_REQUEST_SPAN = "serving-request"

# the training worker's span names (runtime/worker.py emits them from the
# checkpoint manager's op log and on a tripped numeric sentinel), which
# the training ledger reads
SPAN_CKPT_SAVE = "ckpt-save"
SPAN_CKPT_RESTORE = "ckpt-restore"
SPAN_ANOMALY = "anomaly"
# the per-window span the worker sizes to the MPMD engine's modeled
# bubble seconds, anchored at the window's tail
SPAN_PIPELINE_BUBBLE = "pipeline-bubble"

# stage spans a sampled request emits, in request order
SERVING_STAGE_SPANS = ("accept", "queue", "batch-form", "h2d", "device",
                       "drain", "respond")


# --------------------------------------------- the FLEET request vocabulary
# The fleet router (serving/fleet.py) applies the same accounting
# discipline one layer up: of one ROUTED request's client wall-clock,
# how much was the winning upstream attempt — and where did the rest
# go? Failed attempts and their backoff sleeps are `retry` badput; a
# lost tail-hedge's duplicated upstream work is `hedge_waste`. Defined
# once here; the fleet router (serving/fleet.py) and the serving soak
# (cluster/chaos.py) import these.
SERVING_RETRY = "retry"                 # failed attempts + backoff sleeps
SERVING_HEDGE_WASTE = "hedge_waste"     # lost-hedge duplicated upstream work

FLEET_BADPUT_CATEGORIES = (SERVING_RETRY, SERVING_HEDGE_WASTE,
                           BADPUT_OTHER)

# the one summary span the fleet router emits per routed request
FLEET_REQUEST_SPAN = "fleet-request"
# fleet event spans (retry/hedge/breaker/drain transitions), stamped
# with the request id where one applies
FLEET_EVENT_SPANS = ("fleet-retry", "fleet-hedge", "fleet-eject",
                     "fleet-admit", "fleet-drain")


def decompose_fleet_request(wall_seconds: float, upstream_seconds: float,
                            retry_seconds: float,
                            hedge_waste_seconds: float = 0.0) -> dict:
    """Fold one routed request's measured attempt seconds into its
    fleet ledger. The client wall-clock partitions as upstream (the
    winning attempt) + retry (failed attempts and backoff sleeps,
    sequential on the wall) + other (client-side routing overhead —
    reported honestly, never absorbed). ``hedge_waste`` is the lost
    hedge's duplicated upstream work: it OVERLAPS the winner on the
    wall, so it is named badput (chip time wasted) outside the wall
    partition — ``fleet_sum_ok`` checks upstream + retry + other
    against wallSeconds and deliberately excludes it."""
    wall = max(0.0, float(wall_seconds))
    upstream = max(0.0, float(upstream_seconds))
    retry = max(0.0, float(retry_seconds))
    other = max(0.0, wall - upstream - retry)
    return {
        "wallSeconds": round(wall, 6),
        "upstreamSeconds": round(upstream, 6),
        "upstreamRatio": round(upstream / wall, 6) if wall else 0.0,
        "badputSeconds": {
            SERVING_RETRY: round(retry, 6),
            SERVING_HEDGE_WASTE: round(
                max(0.0, float(hedge_waste_seconds)), 6),
            BADPUT_OTHER: round(other, 6),
        },
    }


def fleet_sum_ok(ledger: dict, tol: float = 0.02) -> bool:
    """Whether a fleet ledger's wall partition holds: upstream + retry
    + other re-adds to wallSeconds within ``tol`` (hedge_waste overlaps
    the winner and is excluded by contract — see
    decompose_fleet_request)."""
    wall = float(ledger.get("wallSeconds", 0.0))
    bad = ledger.get("badputSeconds") or {}
    total = float(ledger.get("upstreamSeconds", 0.0)) + \
        float(bad.get(SERVING_RETRY, 0.0)) + \
        float(bad.get(BADPUT_OTHER, 0.0))
    return abs(total - wall) <= max(tol * wall, 1e-6)


def fleet_rollup(path: str) -> dict:
    """The fleet rollup off the span sink: every ``fleet-request``
    summary span folded into one table — request/outcome counts,
    attempt/retry/hedge totals, p50/p99/p99.9 client latency, summed
    fleet badput, and per-replica win counts."""
    lat: list = []
    outcomes: dict = {}
    per_replica: dict = {}
    bad = {c: 0.0 for c in FLEET_BADPUT_CATEGORIES}
    wall_s = upstream_s = 0.0
    attempts = retries = hedges = 0
    for rec in load_spans(path):
        if rec.get("name") != FLEET_REQUEST_SPAN:
            continue
        a = _attrs(rec)
        ledger = a.get("ledger")
        ledger = ledger if isinstance(ledger, dict) else {}
        wall = float(ledger.get("wallSeconds", 0.0) or 0.0)
        lat.append(wall)
        wall_s += wall
        upstream_s += float(ledger.get("upstreamSeconds", 0.0) or 0.0)
        for c, v in (ledger.get("badputSeconds") or {}).items():
            if c in bad:
                bad[c] += float(v or 0.0)
        outcome = str(a.get("outcome", "ok"))
        outcomes[outcome] = outcomes.get(outcome, 0) + 1
        attempts += int(a.get("attempts", 1) or 1)
        retries += int(a.get("retries", 0) or 0)
        if a.get("hedged"):
            hedges += 1
        replica = str(a.get("replica", ""))
        if replica:
            per_replica[replica] = per_replica.get(replica, 0) + 1
    lat.sort()
    n = len(lat)
    return {
        "requests": n,
        "outcomes": outcomes,
        "attempts": attempts,
        "retries": retries,
        "hedged": hedges,
        "p50Ms": round(_percentile(lat, 0.50) * 1e3, 3),
        "p99Ms": round(_percentile(lat, 0.99) * 1e3, 3),
        "p999Ms": round(_percentile(lat, 0.999) * 1e3, 3),
        "upstreamRatio": round(upstream_s / wall_s, 6) if wall_s else 0.0,
        "badputSeconds": {c: round(v, 6) for c, v in bad.items()},
        "replicas": dict(sorted(per_replica.items())),
    }


def decompose_request(wall_seconds: float, stages: dict) -> dict:
    """Fold one request's measured stage seconds into its ledger.
    ``stages`` maps category names (plus SERVING_DEVICE for the real-work
    device share) to seconds; the residual nothing claims is ``other``.
    Categories plus goodput sum to wallSeconds exactly whenever the
    stages fit inside the wall."""
    wall = max(0.0, float(wall_seconds))
    goodput = max(0.0, float(stages.get(SERVING_DEVICE, 0.0)))
    bad = {c: max(0.0, float(stages.get(c, 0.0)))
           for c in SERVING_BADPUT_CATEGORIES if c != BADPUT_OTHER}
    total = goodput + sum(bad.values())
    bad[BADPUT_OTHER] = max(0.0, wall - total)
    return {
        "wallSeconds": round(wall, 6),
        "goodputSeconds": round(goodput, 6),
        "goodputRatio": round(goodput / wall, 6) if wall else 0.0,
        "badputSeconds": {c: round(bad[c], 6)
                          for c in SERVING_BADPUT_CATEGORIES},
    }


def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(len(sorted_vals) * q))]


def _attrs(rec: dict) -> dict:
    a = rec.get("attrs")
    return a if isinstance(a, dict) else {}


def _num(value, default: float = 0.0) -> float:
    try:
        return float(value)
    except (TypeError, ValueError):
        return default


def serving_rollup(path: str) -> dict:
    """The per-model serving rollup off the span sink: every
    ``serving-request`` summary span folded into per-(model, role) rows —
    request/error/shed counts, p50/p99/p99.9, mean batch fill, goodput
    ratio, summed badput per category, the SLO over-target fraction when
    the span carries a target, and the slowest request ids."""
    groups: dict[tuple, list] = {}
    for rec in load_spans(path):
        if rec.get("name") != SERVING_REQUEST_SPAN:
            continue
        a = _attrs(rec)
        key = (str(a.get("model", "")), str(a.get("role", "primary")))
        groups.setdefault(key, []).append((rec, a))
    rows = []
    total = 0
    for (model, role), recs in sorted(groups.items()):
        lat, fills, slowest = [], [], []
        goodput_s = wall_s = 0.0
        bad = {c: 0.0 for c in SERVING_BADPUT_CATEGORIES}
        errors = shed = over_slo = 0
        slo_target_ms = quant_delta = None
        for rec, a in recs:
            ledger = a.get("ledger")
            ledger = ledger if isinstance(ledger, dict) else {}
            wall = _num(ledger.get("wallSeconds"))
            lat.append(wall)
            wall_s += wall
            goodput_s += _num(ledger.get("goodputSeconds"))
            for c, v in (ledger.get("badputSeconds") or {}).items():
                if c in bad:
                    bad[c] += _num(v)
            outcome = a.get("outcome", "ok")
            if outcome == "shed":
                shed += 1
            elif outcome != "ok":
                errors += 1
            if a.get("fill") is not None:
                fills.append(_num(a["fill"]))
            if a.get("slo_p99_ms") is not None:
                slo_target_ms = _num(a["slo_p99_ms"])
                if wall * 1e3 > slo_target_ms:
                    over_slo += 1
            if a.get("quant_delta") is not None:
                quant_delta = _num(a["quant_delta"])
            slowest.append((wall, str(rec.get("trace_id", ""))))
        lat.sort()
        slowest.sort(reverse=True)
        n = len(recs)
        total += n
        row = {
            "model": model, "role": role, "requests": n,
            "errors": errors, "shed": shed,
            "p50Ms": round(_percentile(lat, 0.50) * 1e3, 3),
            "p99Ms": round(_percentile(lat, 0.99) * 1e3, 3),
            "p999Ms": round(_percentile(lat, 0.999) * 1e3, 3),
            "meanFill": round(sum(fills) / len(fills), 4) if fills
            else None,
            "goodputRatio": round(goodput_s / wall_s, 6) if wall_s
            else 0.0,
            "badputSeconds": {c: round(v, 6) for c, v in bad.items()},
            "slowest": [{"requestId": rid, "wallMs": round(w * 1e3, 3)}
                        for w, rid in slowest[:3]],
        }
        if quant_delta is not None:
            row["quantDelta"] = round(quant_delta, 6)
        if slo_target_ms is not None:
            row["slo"] = {
                "targetP99Ms": slo_target_ms,
                "overTargetRatio": round(over_slo / n, 6) if n else 0.0,
                "compliant": bool(n and over_slo / n <= 0.01),
            }
        rows.append(row)
    return {"models": rows, "requests": total}


# ------------------------------------------------------ the training ledger

# overlap resolution: when two attributed intervals claim the same time,
# the LOWEST number wins. Compile outranks the windows (the first window
# span CONTAINS the first step's compile — that stretch is startup cost,
# not training); recompute outranks goodput (a replayed window is waste
# even though it looks like training); measured worker spans outrank
# inferred control-plane intervals; everything outranks the residual.
_PRIORITY = {
    BADPUT_COMPILE: 0,
    BADPUT_ROLLBACK: 1,
    BADPUT_RECOMPUTE: 2,
    # above goodput: a bubble span carves schedule-idle time OUT of the
    # window interval it overlaps (the worker sizes it to the measured
    # bubble seconds of that window's steps)
    BADPUT_PIPELINE_BUBBLE: 3,
    GOODPUT: 4,
    BADPUT_CHECKPOINT: 5,
    BADPUT_STALL: 6,
    BADPUT_RESIZE: 7,
    BADPUT_QUEUE_WAIT: 8,
    BADPUT_STARTUP: 9,
}

# the operator's restart reasons that read as a stall
_STALL_REASONS = ("StallTimeout", "WorkerStallTimeout")

# worker activity that ends a startup/resize-downtime interval
_WORKER_ACTIVITY = ("train-start", "first-step", "window", SPAN_CKPT_SAVE,
                    SPAN_CKPT_RESTORE)


def _next_activity(spans: list[dict], after: float,
                   names: tuple = _WORKER_ACTIVITY) -> Optional[float]:
    """Start time of the first worker-activity span after ``after``."""
    best = None
    for s in spans:
        if s.get("name") in names and s.get("start", 0.0) > after:
            if best is None or s["start"] < best:
                best = s["start"]
    return best


def _last_activity_end(spans: list[dict], before: float) -> Optional[float]:
    """End of the last worker-activity span before ``before`` — where a
    stalled worker last showed signs of life."""
    best = None
    for s in spans:
        end = s.get("end", s.get("start", 0.0))
        if s.get("name") in _WORKER_ACTIVITY and end < before:
            if best is None or end > best:
                best = end
    return best


def _window_segments(spans: list[dict],
                     rollback_ranges: tuple = ()) -> tuple:
    """Split every ``window`` span into goodput vs recompute via a
    step high-water walk: a window re-covering steps already banked
    before a restart is replay, charged to ``restart_recompute``
    proportionally (the replayed steps run FIRST chronologically).
    ``rollback_ranges`` — (anomaly_time, lkg, trip) per anomaly span —
    reclassifies the replayed steps inside a rollback's (lkg, trip]
    range as ``rollback_recompute``, but only for windows AFTER the
    trip: the original run of those steps was goodput at the time.
    Returns (segments, steps_new, steps_recomputed, steps_rolled_back,
    n_windows)."""
    segments: list[tuple] = []
    high_water = 0
    steps_new = 0
    steps_re = 0
    steps_rb = 0
    windows = 0
    for s in spans:
        if s.get("name") != "window":
            continue
        a = _attrs(s)
        try:
            s1 = int(a.get("step", 0))
            n = int(a.get("steps", 0))
        except (TypeError, ValueError):
            continue
        start = float(s.get("start", 0.0))
        end = float(s.get("end", start))
        if n <= 0 or end <= start:
            continue
        windows += 1
        s0 = s1 - n
        re = min(n, max(0, min(s1, high_water) - s0))
        new = n - re
        re_rb = 0
        if re:
            for at, lkg, trip in rollback_ranges:
                if start >= at:
                    overlap = min(s0 + re, trip) - max(s0, lkg)
                    if overlap > 0:
                        re_rb = max(re_rb, min(re, overlap))
        # chronological order inside the window: the replayed steps run
        # first (rollback replay before restart replay before new work)
        split_rb = start + (end - start) * (re_rb / n)
        split = start + (end - start) * (re / n)
        if re_rb:
            segments.append((start, split_rb, BADPUT_ROLLBACK))
        if re - re_rb:
            segments.append((split_rb, split, BADPUT_RECOMPUTE))
        if new:
            segments.append((split, end, GOODPUT))
        high_water = max(high_water, s1)
        steps_new += new
        steps_re += re
        steps_rb += re_rb
    return segments, steps_new, steps_re, steps_rb, windows


def decompose(spans: list[dict]) -> dict:
    """Fold ONE trace's span records (load_spans order) into the ledger:

    ``{"wallSeconds", "goodputSeconds", "goodputRatio",
    "badputSeconds": {category: seconds — every BADPUT_CATEGORIES key},
    "compileByStartKind": {...}, "steps", "stepsRecomputed",
    "stepsRolledBack", "windows", "chips"}``

    The categories plus goodput sum to wallSeconds exactly (partition by
    construction); ``categories_sum_ok`` is the tolerance check
    against independent wall measurements.
    """
    empty = {
        "wallSeconds": 0.0, "goodputSeconds": 0.0, "goodputRatio": 0.0,
        "badputSeconds": {c: 0.0 for c in BADPUT_CATEGORIES},
        "compileByStartKind": {}, "steps": 0, "stepsRecomputed": 0,
        "stepsRolledBack": 0, "windows": 0, "chips": 0,
    }
    if not spans:
        return empty
    t0 = min(float(s.get("start", 0.0)) for s in spans)
    t1 = max(float(s.get("end", s.get("start", 0.0))) for s in spans)
    if t1 <= t0:
        return empty

    # anomaly-rollback evidence pre-pass: each anomaly span's
    # (lkg, trip] range marks the steps whose replay is the sentinel's
    # recovery cost, not generic restart recompute
    rollback_ranges = []
    for s in spans:
        if s.get("name") != SPAN_ANOMALY:
            continue
        a = _attrs(s)
        try:
            trip = int(a.get("step", 0))
            lkg = int(a.get("lkg") or 0)
        except (TypeError, ValueError):
            continue
        if trip > lkg >= 0:
            rollback_ranges.append(
                (float(s.get("start", 0.0)), lkg, trip))

    segments, steps_new, steps_re, steps_rb, windows = \
        _window_segments(spans, tuple(rollback_ranges))
    compile_by_kind: dict[str, float] = {}
    chips = 0

    open_queue: Optional[float] = None
    for s in spans:
        name = s.get("name")
        start = float(s.get("start", 0.0))
        end = float(s.get("end", start))
        a = _attrs(s)
        if name == "queued":
            if open_queue is None:
                open_queue = start
        elif name == "bound":
            if open_queue is not None:
                segments.append((open_queue, start, BADPUT_QUEUE_WAIT))
                open_queue = None
            try:
                chips = int(a.get("chips", chips)) or chips
            except (TypeError, ValueError):
                pass
            # pod create → worker first activity: the startup stretch
            # (low priority — measured worker spans carve their own time
            # out of it)
            until = _next_activity(spans, start)
            segments.append((start, until if until is not None else t1,
                             BADPUT_STARTUP))
        elif name == "first-step":
            # train() entry → first completed step; dominated by the
            # compile/cache-load/AOT-load rung recorded in start_kind
            try:
                secs = float(a.get("seconds", 0.0))
            except (TypeError, ValueError):
                secs = 0.0
            if secs > 0:
                lo = max(t0, start - secs)
                segments.append((lo, start, BADPUT_COMPILE))
                kind = str(a.get("start_kind", "cold"))
                # clipped to the stream: the attr measures from train()
                # entry, which can predate the job's first span
                compile_by_kind[kind] = \
                    compile_by_kind.get(kind, 0.0) + (start - lo)
        elif name in (SPAN_CKPT_SAVE, SPAN_CKPT_RESTORE):
            if end > start:
                segments.append((start, end, BADPUT_CHECKPOINT))
        elif name == SPAN_PIPELINE_BUBBLE:
            if end > start:
                segments.append((start, end, BADPUT_PIPELINE_BUBBLE))
        elif name == "resized":
            # binding rewritten → gang restarts at the new shape; the
            # downtime runs to the worker's next sign of life
            until = _next_activity(spans, start)
            segments.append((start, until if until is not None else t1,
                             BADPUT_RESIZE))
        elif name == "restarting":
            # restart downtime (teardown → the recreated gang's first
            # sign of life) is startup badput; for a watchdog-triggered
            # restart the wedged stretch BEFORE the teardown — last
            # worker activity → the restarting transition — is stall
            # (the flight recorder's dump covers the same stretch from
            # inside the worker)
            until = _next_activity(spans, start)
            segments.append((start, until if until is not None else t1,
                             BADPUT_STARTUP))
            if a.get("reason") in _STALL_REASONS:
                last = _last_activity_end(spans, start)
                if last is not None and start > last:
                    segments.append((last, start, BADPUT_STALL))
    if open_queue is not None:
        # still waiting at the end of the stream (never bound)
        segments.append((open_queue, t1, BADPUT_QUEUE_WAIT))

    # ---- the sweep: partition [t0, t1] by priority ----------------------
    # Two-pointer event sweep, O(n log n) in span count: this runs
    # inside the operator's reconcile (_finalize_ledger) and on every
    # dashboard request, so a multi-day job's thousands of window spans
    # must not turn one decompose into a quadratic scan.
    totals = {c: 0.0 for c in BADPUT_CATEGORIES}
    totals[GOODPUT] = 0.0
    segments = [(max(t0, a), min(t1, b), cat) for a, b, cat in segments
                if min(t1, b) > max(t0, a)]
    bounds = sorted({t0, t1, *(a for a, _b, _c in segments),
                     *(b for _a, b, _c in segments)})
    starts = sorted(segments, key=lambda s: s[0])
    ends = sorted(segments, key=lambda s: s[1])
    by_priority = sorted(_PRIORITY, key=_PRIORITY.__getitem__)
    active = {c: 0 for c in _PRIORITY}
    si = ei = 0
    for lo, hi in zip(bounds, bounds[1:]):
        # a segment [a, b] covers [lo, hi) iff a <= lo and b > lo
        # (every b is itself a boundary, so b > lo equals b >= hi)
        while si < len(starts) and starts[si][0] <= lo:
            active[starts[si][2]] += 1
            si += 1
        while ei < len(ends) and ends[ei][1] <= lo:
            active[ends[ei][2]] -= 1
            ei += 1
        cat = next((c for c in by_priority if active[c] > 0),
                   BADPUT_OTHER)
        totals[cat] += hi - lo

    wall = t1 - t0
    goodput = totals.pop(GOODPUT)
    return {
        "wallSeconds": round(wall, 6),
        "goodputSeconds": round(goodput, 6),
        "goodputRatio": round(goodput / wall, 6) if wall else 0.0,
        "badputSeconds": {c: round(v, 6) for c, v in totals.items()},
        "compileByStartKind": {k: round(v, 6)
                               for k, v in sorted(compile_by_kind.items())},
        "steps": steps_new,
        "stepsRecomputed": steps_re,
        "stepsRolledBack": steps_rb,
        "windows": windows,
        "chips": chips,
    }


def ledger_for(path: str, trace_id: str) -> dict:
    """One job's ledger straight from the span sink."""
    return decompose(load_spans(path, trace_id=trace_id))


def categories_sum_ok(ledger: dict, tolerance: float = 0.02) -> bool:
    """goodput + every badput category must re-add to wall-clock within
    ``tolerance`` (fractional). Exact by construction today; the check
    guards the partition invariant against future category edits."""
    wall = ledger.get("wallSeconds", 0.0)
    total = ledger.get("goodputSeconds", 0.0) + \
        sum(ledger.get("badputSeconds", {}).values())
    if wall <= 0:
        return total == 0
    return math.isclose(total, wall, rel_tol=tolerance, abs_tol=1e-6)


def annotation_payload(ledger: dict) -> str:
    """The compact final-ledger JSON the operator stamps on completion."""
    return json.dumps({
        "goodputRatio": ledger["goodputRatio"],
        "wallSeconds": round(ledger["wallSeconds"], 3),
        "goodputSeconds": round(ledger["goodputSeconds"], 3),
        "badputSeconds": {c: round(v, 3)
                          for c, v in ledger["badputSeconds"].items()},
        "stepsRecomputed": ledger["stepsRecomputed"],
    }, sort_keys=True)


def _ledger_families(reg) -> tuple:
    ratio = reg.gauge(
        "kftpu_job_goodput_ratio",
        "fraction of the job's wall clock spent on productive (never "
        "re-executed) train steps", labels=("namespace", "name"))
    # a counter via the registry's snapshot bridge (set() for sources
    # that keep their own monotonic totals — the ledger IS the
    # bookkeeper): keeps the Prometheus _total-means-counter convention
    # while exporting the final cumulative seconds in one shot
    seconds = reg.counter(
        "kftpu_job_badput_seconds_total",
        "job wall-clock seconds lost per badput category",
        labels=("namespace", "name", "category"))
    return ratio, seconds


def export_job_ledger(namespace: str, name: str, ledger: dict,
                      registry=None) -> None:
    """Export one job's ledger as the scrape-surface series:
    ``kftpu_job_goodput_ratio{namespace,name}`` and
    ``kftpu_job_badput_seconds_total{namespace,name,category}``."""
    reg = registry if registry is not None else obsreg.default_registry()
    ratio, seconds = _ledger_families(reg)
    ratio.labels(namespace=namespace, name=name).set(
        ledger["goodputRatio"])
    for cat in BADPUT_CATEGORIES:
        seconds.labels(namespace=namespace, name=name, category=cat).set(
            ledger["badputSeconds"].get(cat, 0.0))


def remove_job_ledger(namespace: str, name: str, registry=None) -> None:
    """Drop a deleted job's ledger series — a long-lived operator must
    not export every finished job's decomposition forever (the
    kftpu_job_phase pruning rule)."""
    reg = registry if registry is not None else obsreg.default_registry()
    ratio, seconds = _ledger_families(reg)
    ratio.remove(namespace=namespace, name=name)
    for cat in BADPUT_CATEGORIES:
        seconds.remove(namespace=namespace, name=name, category=cat)


def cluster_rollup(path: str) -> dict:
    """The cluster-level chip-hour rollup: every trace in the sink,
    weighted by its bound gang width. ``chipHours`` decomposes the
    fleet's chip-time the way a single job's ledger decomposes its
    wall clock (jobs that never bound contribute wait with zero chips —
    reported in ``jobsNeverBound``, not silently dropped)."""
    by_trace: dict[str, list] = {}
    for rec in load_spans(path):
        tid = rec.get("trace_id")
        if tid:
            by_trace.setdefault(tid, []).append(rec)
    chip_sec = {c: 0.0 for c in BADPUT_CATEGORIES}
    goodput_sec = 0.0
    wall_sec = 0.0
    never_bound = 0
    jobs = []
    for tid, spans in sorted(by_trace.items()):
        ledger = decompose(spans)
        chips = ledger["chips"]
        if not chips:
            never_bound += 1
        goodput_sec += ledger["goodputSeconds"] * chips
        wall_sec += ledger["wallSeconds"] * chips
        for c, v in ledger["badputSeconds"].items():
            chip_sec[c] += v * chips
        jobs.append({"traceId": tid, "chips": chips,
                     "goodputRatio": ledger["goodputRatio"],
                     "wallSeconds": ledger["wallSeconds"]})
    return {
        "jobs": jobs,
        "jobsNeverBound": never_bound,
        "chipHours": {
            "total": round(wall_sec / 3600.0, 6),
            GOODPUT: round(goodput_sec / 3600.0, 6),
            "badput": {c: round(v / 3600.0, 6)
                       for c, v in chip_sec.items()},
        },
        "goodputRatio": round(goodput_sec / wall_sec, 6)
        if wall_sec else 0.0,
    }
