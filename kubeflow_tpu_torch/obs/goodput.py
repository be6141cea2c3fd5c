"""The serving request ledger: where one request's wall-clock went.

The serving part of ``kubeflow_tpu/obs/goodput.py``. Of one request's
wall-clock, the device time spent on its real rows is goodput; the rest
is named badput (queue, batch forming, pad rows, host→device copy,
respond), and the residual nothing claims is reported as ``other``,
never absorbed. The vocabulary is defined once, here; the request tracer
(serving/request_trace.py) and the replica registry
(serving/replica_state.py) import it. Stdlib only.
"""

from __future__ import annotations

from .trace import load_spans

GOODPUT = "goodput"
BADPUT_OTHER = "other"                  # unattributed residual

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
# checkpoint manager's op log and on a tripped numeric sentinel); the
# JAX package's ledger reads them under these names
SPAN_CKPT_SAVE = "ckpt-save"
SPAN_CKPT_RESTORE = "ckpt-restore"
SPAN_ANOMALY = "anomaly"

# stage spans a sampled request emits, in request order
SERVING_STAGE_SPANS = ("accept", "queue", "batch-form", "h2d", "device",
                       "drain", "respond")


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
