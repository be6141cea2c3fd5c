"""Health-routed replica fleet: the serving tier past one replica.

The port of ``kubeflow_tpu/serving/fleet.py`` (stdlib only; it speaks
HTTP to replicas, so a port FleetRouter routes to JAX replicas and the
reverse). Each replica's verbose healthz (``/healthz?verbose=1``,
serving/replica_state.py) is the interface it polls. A FleetRouter
load-balances :predict traffic across N model-server replicas and keeps
the fleet available through the failures one replica WILL have:

- **Health-routed picks.** A background poller reads each replica's
  verbose healthz (queue depth, rolling p99, in-flight, ``draining``,
  ``uptimeSeconds``); requests go to the least-loaded live replica —
  the pick score weighs queue depth and rolling p99, never a draining
  or breaker-open replica.
- **Per-replica circuit breakers.** Failure evidence (connect
  failures, timeouts, 5xx, polled burn rates) folds through the
  exponential-decay score of scheduler/health.py ``fold_event``: at the
  trip threshold the replica is ejected; after a cooldown it goes
  **half-open** and one probe request at a time is admitted;
  consecutive probe successes (with the score decayed below the release
  threshold) close it again, a probe failure re-opens it with the
  cooldown extended. A manual ejection (``eject(manual=True)``) is
  never auto-released.
- **Failover retries under a deadline budget.** Connect failures,
  timeouts and 5xx re-route to a DIFFERENT replica with jittered
  exponential backoff (Retry-After honored), all inside one per-request
  deadline propagated downstream as the ``x-request-deadline`` header:
  retrying can never spend longer than the client asked for. 4xx is
  meaning, not weather — surfaced, never retried.
- **Tail hedging** (optional). When the first attempt outlives a
  p99-derived delay, a duplicate fires at a second replica; the first
  response wins and the loser's duplicated upstream work is ledgered
  as ``hedge_waste`` badput (obs/goodput.py).
- **Drain awareness.** A replica advertising ``draining`` stops
  receiving new work before its process dies (http_server.py drain()).

Every retry/hedge/ejection/drain lands a span event on the request
trace (one ``fleet-request`` summary per routed request, carrying the
fleet ledger) and a ``kftpu_fleet_*`` metric; per-replica series are
pruned on remove_replica. The router runs beside the client, in a
gateway process, or in-process with the soak (cluster/chaos.py
ServingSoak).
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import Optional

from ..cluster.http_client import jittered_backoff, retry_after_s
from ..obs import goodput as gp
from ..obs import trace as obstrace
from ..obs.registry import Registry
from ..scheduler.health import fold_event
from .request_trace import (DEADLINE_HEADER, REQUEST_ID_HEADER,
                            mint_request_id)

log = logging.getLogger(__name__)

# breaker evidence kinds and weights: the scheduler/health.py
# EVENT_WEIGHTS shape with the serving failure vocabulary. Hard
# transport evidence (a connection that died, a replica that never
# answered) weighs full; a 5xx is weaker (could be one bad request),
# a shed 429 and a polled burn-rate breach weaker still (load, not
# sickness — the breaker must not eject a merely-busy replica).
EVIDENCE_CONNECT = "connect-failure"
EVIDENCE_TIMEOUT = "timeout"
EVIDENCE_5XX = "5xx"
EVIDENCE_SHED = "shed"
EVIDENCE_BURN = "burn-rate"

FLEET_EVIDENCE_WEIGHTS = {
    EVIDENCE_CONNECT: 1.0,
    EVIDENCE_TIMEOUT: 1.0,
    EVIDENCE_5XX: 0.5,
    EVIDENCE_SHED: 0.25,
    EVIDENCE_BURN: 0.25,
}

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"
_BREAKER_STATE_CODE = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1,
                       BREAKER_OPEN: 2}


class FleetError(RuntimeError):
    """Base class for fleet routing failures."""


class NoReplicaAvailableError(FleetError):
    """Every replica is draining, ejected, or removed."""


class DeadlineExceededError(FleetError):
    """The request's deadline budget ran out before a success."""


class RetriesExhaustedError(FleetError):
    """The retry budget ran out; carries the last upstream error."""


class RequestRejectedError(FleetError):
    """A 4xx from the replica: meaning, not weather — never retried."""

    def __init__(self, code: int, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code


class _Retryable(Exception):
    """Internal: one failed attempt that may re-route."""

    def __init__(self, kind: str, detail: str,
                 retry_after: Optional[float] = None):
        super().__init__(detail)
        self.kind = kind
        self.retry_after = retry_after
        # True when breaker evidence + the retry metric were already
        # charged to the failing replica (the hedged path does its own
        # per-replica accounting)
        self.recorded = False


@dataclass
class BreakerConfig:
    """Per-replica breaker policy. The defaults suit second-scale
    serving failures — far faster than the node quarantine's minutes,
    same shape."""

    half_life_s: float = 30.0       # evidence decay half-life
    trip_threshold: float = 3.0     # decayed score that ejects
    release_threshold: float = 1.0  # probation: score must decay here
    open_s: float = 5.0             # cooldown before the first probe
    open_max_s: float = 60.0        # cap on the extended cooldown
    probe_successes: int = 2        # consecutive probe oks to close

    KEYS = ("halfLifeSeconds", "tripThreshold", "releaseThreshold",
            "openSeconds", "openMaxSeconds", "probeSuccesses")

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "BreakerConfig":
        d = dict(d or {})
        unknown = set(d) - set(cls.KEYS)
        if unknown:
            # a typo'd knob must fail loudly, not silently default
            raise ValueError(
                f"unknown breaker config keys {sorted(unknown)}; "
                f"valid: {list(cls.KEYS)}")
        return cls(
            half_life_s=float(d.get("halfLifeSeconds", 30.0)),
            trip_threshold=float(d.get("tripThreshold", 3.0)),
            release_threshold=float(d.get("releaseThreshold", 1.0)),
            open_s=float(d.get("openSeconds", 5.0)),
            open_max_s=float(d.get("openMaxSeconds", 60.0)),
            probe_successes=int(d.get("probeSuccesses", 2)))

    def to_dict(self) -> dict:
        return {"halfLifeSeconds": self.half_life_s,
                "tripThreshold": self.trip_threshold,
                "releaseThreshold": self.release_threshold,
                "openSeconds": self.open_s,
                "openMaxSeconds": self.open_max_s,
                "probeSuccesses": self.probe_successes}


class CircuitBreaker:
    """One replica's breaker: evidence-decay scoring with probational
    half-open re-admission — the node quarantine's state machine per
    serving replica. Thread-safe; the router records evidence from
    request threads and reads state from the pick path."""

    def __init__(self, cfg: Optional[BreakerConfig] = None,
                 clock=time.monotonic):
        self.cfg = cfg or BreakerConfig()
        self.clock = clock
        self._lock = threading.Lock()
        self._rec = {"score": 0.0, "time": clock(), "events": 0,
                     "last": ""}
        self._state = BREAKER_CLOSED
        self._opened_at = 0.0
        self._open_for = self.cfg.open_s
        self._probe_inflight = False
        self._probe_oks = 0
        self._manual = False
        self.trips = 0

    # ------------------------------------------------------------ evidence

    def score(self, now: Optional[float] = None) -> float:
        now = self.clock() if now is None else now
        with self._lock:
            rec = dict(self._rec)
        age = max(0.0, now - rec["time"])
        return rec["score"] * 0.5 ** (
            age / max(self.cfg.half_life_s, 1e-9))

    def record_failure(self, kind: str,
                       weight: Optional[float] = None) -> bool:
        """Fold one failure event; returns True when this event TRIPS
        the breaker (closed → open, or a half-open probe failing)."""
        w = FLEET_EVIDENCE_WEIGHTS.get(kind, 1.0) \
            if weight is None else weight
        now = self.clock()
        with self._lock:
            self._rec = fold_event(self._rec, kind, now,
                                   half_life_s=self.cfg.half_life_s,
                                   weight=w)
            if self._state == BREAKER_HALF_OPEN:
                # a failed probe re-opens with the cooldown extended:
                # a still-failing replica earns a longer bench
                self._probe_inflight = False
                self._probe_oks = 0
                self._state = BREAKER_OPEN
                self._opened_at = now
                self._open_for = min(self.cfg.open_max_s,
                                     self._open_for * 2)
                self.trips += 1
                return True
            if self._state == BREAKER_CLOSED and \
                    self._rec["score"] >= self.cfg.trip_threshold:
                self._state = BREAKER_OPEN
                self._opened_at = now
                self._open_for = self.cfg.open_s
                self.trips += 1
                return True
        return False

    def record_success(self) -> bool:
        """One successful request; returns True when this CLOSES a
        half-open breaker (probation served)."""
        now = self.clock()
        with self._lock:
            if self._state != BREAKER_HALF_OPEN:
                return False
            self._probe_inflight = False
            self._probe_oks += 1
            if self._probe_oks < self.cfg.probe_successes:
                return False
        # probation needs BOTH: enough probe successes AND the decayed
        # score back under the release threshold (the node quarantine's
        # expiry-plus-decay rule)
        if self.score(now) > self.cfg.release_threshold:
            return False
        with self._lock:
            # re-check under the lock: a concurrent failure (poll
            # evidence) may have re-opened the breaker between the
            # score read and here — fresh failure evidence wins,
            # closing over it would re-admit a failing replica
            if self._state != BREAKER_HALF_OPEN:
                return False
            self._state = BREAKER_CLOSED
            self._probe_oks = 0
        return True

    # --------------------------------------------------------------- state

    def state(self, now: Optional[float] = None) -> str:
        now = self.clock() if now is None else now
        with self._lock:
            if self._state == BREAKER_OPEN and not self._manual and \
                    now - self._opened_at >= self._open_for:
                self._state = BREAKER_HALF_OPEN
                self._probe_oks = 0
                self._probe_inflight = False
            return self._state

    def allow_request(self, now: Optional[float] = None) -> bool:
        """Whether the pick path may route here NOW. Open: no.
        Half-open: one probe in flight at a time — probational
        re-admission, not a floodgate. Claims the probe slot when it
        grants one (try_probe); callers that merely INSPECT must use
        state()."""
        state = self.state(now)
        if state == BREAKER_CLOSED:
            return True
        if state == BREAKER_HALF_OPEN:
            return self.try_probe()
        return False

    def try_probe(self) -> bool:
        """Atomically claim the half-open probe slot (released by the
        probe's record_success/record_failure)."""
        state = self.state()   # open→half-open transition included
        with self._lock:
            if state != BREAKER_HALF_OPEN or \
                    self._state != BREAKER_HALF_OPEN or \
                    self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def release_probe(self) -> None:
        """Free the probe slot WITHOUT evidence — for a probe attempt
        abandoned unobserved (a hedge winner elsewhere). The next pick
        may probe again; a leaked slot would bench the replica
        forever."""
        with self._lock:
            self._probe_inflight = False

    def eject(self, manual: bool = False,
              reason: str = "ejected") -> None:
        """Force the breaker open. ``manual=True`` is a human's call —
        NEVER auto-released; release needs an explicit release()."""
        now = self.clock()
        with self._lock:
            self._state = BREAKER_OPEN
            self._opened_at = now
            self._manual = self._manual or manual
            self._rec["last"] = reason
            self.trips += 1

    def release(self) -> None:
        """Explicit (human) release: back to closed, evidence cleared."""
        with self._lock:
            self._state = BREAKER_CLOSED
            self._manual = False
            self._probe_oks = 0
            self._probe_inflight = False
            self._rec = {"score": 0.0, "time": self.clock(),
                         "events": 0, "last": ""}

    @property
    def manual(self) -> bool:
        with self._lock:
            return self._manual

    def to_dict(self) -> dict:
        now = self.clock()
        with self._lock:
            rec = dict(self._rec)
            state = self._state
        return {"state": state, "score": round(self.score(now), 4),
                "events": rec["events"], "last": rec["last"],
                "trips": self.trips, "manual": self.manual}


class _Replica:
    """One fleet member: address, breaker, last polled health."""

    __slots__ = ("name", "base_url", "breaker", "health", "draining",
                 "uptime_s", "last_poll", "poll_ok")

    def __init__(self, name: str, base_url: str,
                 breaker: CircuitBreaker):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.breaker = breaker
        self.health: dict = {}
        self.draining = False
        self.uptime_s: Optional[float] = None
        self.last_poll = 0.0
        self.poll_ok = False


@dataclass
class FleetConfig:
    """The router's policy surface. ``hedge_delay_ms=None`` derives the
    hedge trigger from the replica's rolling p99 (fire only into the
    tail); a fixed value pins it."""

    max_retries: int = 2
    backoff_s: float = 0.05
    default_deadline_s: float = 30.0
    attempt_timeout_s: float = 10.0      # per-attempt cap: a wedged
    #                                      replica can't eat the budget
    poll_interval_s: float = 1.0
    poll_timeout_s: float = 2.0
    hedge: bool = False
    hedge_delay_ms: Optional[float] = None
    hedge_min_delay_ms: float = 5.0
    burn_evidence_threshold: float = 2.0  # fold burn evidence past this


class FleetRouter:
    """Load-balancing, health-polling, breaker-guarded request router
    over N model-server replicas (the module docstring's contract)."""

    def __init__(self, replicas: Optional[dict] = None,
                 config: Optional[FleetConfig] = None,
                 breaker_config: Optional[BreakerConfig] = None,
                 registry: Optional[Registry] = None,
                 span_path: Optional[str] = None,
                 clock=time.monotonic, rng: Optional[random.Random] = None):
        self.config = config or FleetConfig()
        self.breaker_config = breaker_config or BreakerConfig()
        self.clock = clock
        self.rng = rng or random.Random()
        self.registry = registry or Registry()
        self._lock = threading.Lock()
        self._replicas: dict[str, _Replica] = {}
        self._poll_thread: Optional[threading.Thread] = None
        self._poll_stop = threading.Event()
        # hedge attempts run on their own pool; bounded so a storm of
        # wedged hedges can't grow threads without limit
        self._hedge_pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="fleet-hedge")
        self._poll_pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="fleet-poll")
        if span_path:
            self.writer = obstrace.SpanWriter(span_path, "fleet")
            self._own_writer = True
        else:
            self.writer = obstrace.default_tracer("fleet")
            self._own_writer = False
        r = self.registry
        self._m_requests = r.counter(
            "kftpu_fleet_requests_total",
            "routed requests per outcome", labels=("outcome",))
        self._m_attempts = r.counter(
            "kftpu_fleet_attempts_total",
            "upstream attempts per replica", labels=("replica",))
        self._m_retries = r.counter(
            "kftpu_fleet_retries_total",
            "failover retries per replica and evidence kind",
            labels=("replica", "reason"))
        self._m_hedges = r.counter(
            "kftpu_fleet_hedges_total",
            "tail hedges fired, by what the duplicate did",
            labels=("outcome",))
        self._m_hedge_waste = r.counter(
            "kftpu_fleet_hedge_waste_seconds_total",
            "duplicated upstream seconds from lost hedges "
            "(the hedge_waste badput category)")
        self._m_breaker = r.gauge(
            "kftpu_fleet_breaker_state",
            "per-replica breaker state (0 closed, 1 half-open, 2 open)",
            labels=("replica",))
        self._m_breaker_score = r.gauge(
            "kftpu_fleet_breaker_score",
            "per-replica decayed failure-evidence score",
            labels=("replica",))
        self._m_ejections = r.counter(
            "kftpu_fleet_ejections_total",
            "breaker trips per replica", labels=("replica",))
        self._m_admissions = r.counter(
            "kftpu_fleet_admissions_total",
            "probational re-admissions (half-open → closed) per replica",
            labels=("replica",))
        self._m_draining = r.gauge(
            "kftpu_fleet_replica_draining",
            "1 while the replica advertises draining",
            labels=("replica",))
        self._m_drains = r.counter(
            "kftpu_fleet_drains_total",
            "drain transitions observed per replica",
            labels=("replica",))
        self._m_replicas = r.gauge(
            "kftpu_fleet_replicas", "replicas currently registered")
        for name, url in (replicas or {}).items():
            self.add_replica(name, url)

    # ---------------------------------------------------------- membership

    def add_replica(self, name: str, base_url: str) -> None:
        with self._lock:
            self._replicas[name] = _Replica(
                name, base_url,
                CircuitBreaker(self.breaker_config, clock=self.clock))
            self._m_replicas.set(len(self._replicas))
        self._m_breaker.labels(replica=name).set(0)

    def remove_replica(self, name: str) -> None:
        """Drop a replica AND its per-replica series — a dashboard
        reading frozen breaker state for a gone replica would read it
        as live (the model-unload prune rule, replica_state.prune)."""
        with self._lock:
            self._replicas.pop(name, None)
            self._m_replicas.set(len(self._replicas))
        for fam in (self._m_breaker, self._m_breaker_score,
                    self._m_draining, self._m_attempts,
                    self._m_ejections, self._m_admissions,
                    self._m_drains):
            fam.remove(replica=name)
        for reason in FLEET_EVIDENCE_WEIGHTS:
            self._m_retries.remove(replica=name, reason=reason)

    def set_replica_url(self, name: str, base_url: str) -> None:
        """A replica came back at a new address (process restarted):
        same identity, same breaker history."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is not None:
                rep.base_url = base_url.rstrip("/")

    def replica(self, name: str) -> Optional[_Replica]:
        with self._lock:
            return self._replicas.get(name)

    def replicas(self) -> list:
        with self._lock:
            return list(self._replicas.values())

    # -------------------------------------------------------------- polling

    def poll_once(self) -> dict:
        """One health sweep: GET every replica's verbose healthz
        CONCURRENTLY (one blackholed host must not stall detection for
        the rest of the fleet by poll_timeout_s), update draining/
        uptime/queue state, fold burn-rate evidence. Returns
        {replica: ok} for tests and the soak."""
        reps = self.replicas()
        if len(reps) <= 1:
            results = {rep.name: self._poll_replica(rep)
                       for rep in reps}
        else:
            futures = {rep.name: self._poll_pool.submit(
                self._poll_replica, rep) for rep in reps}
            results = {name: f.result() for name, f in futures.items()}
        self._refresh_breaker_gauges()
        return results

    def _poll_replica(self, rep: _Replica) -> bool:
        url = f"{rep.base_url}/healthz?verbose=1"
        try:
            with urllib.request.urlopen(
                    url, timeout=self.config.poll_timeout_s) as resp:
                snap = json.loads(resp.read())
        except Exception as e:  # noqa: BLE001 — poll failure is evidence
            rep.poll_ok = False
            rep.last_poll = self.clock()
            # an unpollable replica is suspect, but weigh it lightly —
            # the request path's own failures carry the hard evidence
            if self._record_failure(rep, EVIDENCE_CONNECT, weight=0.25):
                self._on_trip(rep, f"health poll failed: {e}")
            return False
        rep.poll_ok = True
        rep.last_poll = self.clock()
        rep.health = snap
        rep.uptime_s = snap.get("uptimeSeconds")
        draining = bool(snap.get("draining"))
        if draining and not rep.draining:
            self._m_drains.labels(replica=rep.name).inc()
            self._emit_event("fleet-drain", replica=rep.name)
            log.info("fleet: replica %s is draining — routing away",
                     rep.name)
        rep.draining = draining
        self._m_draining.labels(replica=rep.name).set(
            1 if draining else 0)
        # burn-rate evidence: a replica burning its availability budget
        # fast is failing-in-place even when requests still connect
        for model in snap.get("models", []):
            burns = (model.get("burnRates") or {})
            fast = burns.get("60s") or {}
            if float(fast.get("availability", 0.0) or 0.0) >= \
                    self.config.burn_evidence_threshold:
                if self._record_failure(rep, EVIDENCE_BURN):
                    self._on_trip(rep, "availability burn rate")
                break
        return True

    def start_polling(self) -> None:
        if self._poll_thread is not None:
            return
        self._poll_stop.clear()

        def loop():
            while not self._poll_stop.wait(self.config.poll_interval_s):
                try:
                    self.poll_once()
                except Exception:  # noqa: BLE001 — the poller survives
                    log.exception("fleet poll failed")

        self._poll_thread = threading.Thread(
            target=loop, daemon=True, name="fleet-poll")
        self._poll_thread.start()

    def close(self) -> None:
        self._poll_stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=2)
            self._poll_thread = None
        self._hedge_pool.shutdown(wait=False)
        self._poll_pool.shutdown(wait=False)
        if self._own_writer and self.writer is not None:
            self.writer.close()

    # ----------------------------------------------------------- the pick

    def _score(self, rep: _Replica, model: str) -> float:
        """Lower is better: queue depth + in-flight (work already
        committed there) weighted with the rolling p99 in ms (how
        slowly that work drains). An unpolled replica scores neutral —
        new members must receive traffic to produce evidence."""
        if not rep.poll_ok or not rep.health:
            return 1.0
        depth = inflight = 0.0
        p99_ms = 0.0
        for m in rep.health.get("models", []):
            if model and m.get("model") not in ("", model):
                continue
            depth += float(m.get("queueDepth", 0) or 0)
            inflight += float(m.get("inFlight", 0) or 0)
            p99_ms = max(p99_ms, float(m.get("p99Ms", 0.0) or 0.0))
        return depth + inflight + p99_ms / 10.0

    def pick(self, model: str = "", exclude: Optional[set] = None,
             probe_ok: bool = True) -> _Replica:
        """The least-loaded routable replica outside ``exclude``.
        A half-open replica with a free probe slot takes priority —
        probation needs traffic to serve, and one probe at a time is
        the bounded risk. ``probe_ok=False`` skips half-open replicas
        entirely (hedge twins: a latency rescue must not go to a
        suspect replica, and an abandoned twin would leak the claimed
        probe slot). Raises NoReplicaAvailableError when every replica
        is draining or breaker-blocked."""
        exclude = exclude or set()
        now = self.clock()
        closed, half = [], []
        for rep in self.replicas():
            if rep.name in exclude or rep.draining:
                continue
            state = rep.breaker.state(now)
            if state == BREAKER_CLOSED:
                closed.append(rep)
            elif state == BREAKER_HALF_OPEN and probe_ok:
                half.append(rep)
        for rep in sorted(half, key=lambda r: r.name):
            if rep.breaker.try_probe():
                return rep
        if not closed:
            raise NoReplicaAvailableError(
                f"no routable replica (of {len(self.replicas())}, "
                f"excluding {sorted(exclude)})")
        # tiny jitter decorrelates equal-score picks across router
        # instances without disturbing a real load signal
        return min(closed,
                   key=lambda r: (self._score(r, model),
                                  self.rng.random()))

    # --------------------------------------------------------- the request

    def request(self, model: str, body: bytes,
                request_id: Optional[str] = None,
                deadline_s: Optional[float] = None,
                hedge: Optional[bool] = None) -> dict:
        """Route one :predict request: pick → attempt → (failover
        retries | tail hedge) → respond, all inside the deadline
        budget. Returns the decoded response dict; raises a FleetError
        subclass otherwise. Emits one ``fleet-request`` summary span
        with the fleet ledger (client wall = upstream + retry + other;
        a lost hedge's duplicated work ledgered as hedge_waste)."""
        rid = request_id or mint_request_id()
        hedge = self.config.hedge if hedge is None else hedge
        budget = self.config.default_deadline_s \
            if deadline_s is None else float(deadline_s)
        t0_wall = time.time()
        t0 = time.monotonic()
        deadline = t0 + budget
        tried: set = set()
        retry_s = 0.0
        hedge_waste_s = 0.0
        hedged = False
        attempts = retries = 0
        delay = self.config.backoff_s
        last_err: Optional[Exception] = None
        outcome = "error"
        winner = ""
        upstream_s = 0.0
        try:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    outcome = "deadline"
                    raise DeadlineExceededError(
                        f"deadline budget ({budget:.2f}s) exhausted "
                        f"after {attempts} attempt(s): {last_err}")
                try:
                    rep = self.pick(model, exclude=tried)
                except NoReplicaAvailableError:
                    outcome = "no_replica"
                    if not tried:
                        raise
                    # every replica tried once: failover prefers a
                    # DIFFERENT replica but a small fleet may have to
                    # come back around rather than fail the client
                    tried = set()
                    rep = self.pick(model)
                    outcome = "error"
                attempts += 1
                self._m_attempts.labels(replica=rep.name).inc()
                t_attempt = time.monotonic()
                try:
                    out, win_rep, waste = self._attempt_maybe_hedged(
                        rep, model, body, rid, deadline, hedge, tried)
                    upstream_s = time.monotonic() - t_attempt
                    if waste > 0:
                        hedged = True
                        hedge_waste_s += waste
                    winner = win_rep.name
                    outcome = "ok"
                    # success evidence goes to the replica that ANSWERED
                    # (a winning hedge twin may be serving its probation)
                    if win_rep.breaker.record_success():
                        self._m_admissions.labels(
                            replica=win_rep.name).inc()
                        self._emit_event("fleet-admit",
                                         replica=win_rep.name)
                        log.info("fleet: replica %s re-admitted "
                                 "(probation served)", win_rep.name)
                    return out
                except RequestRejectedError:
                    # 4xx is MEANING: the replica answered, transport
                    # is healthy — success evidence for the breaker
                    # (frees a probe slot), the error surfaces
                    rep.breaker.record_success()
                    raise
                except _Retryable as e:
                    attempt_s = time.monotonic() - t_attempt
                    retry_s += attempt_s
                    retries += 1
                    last_err = e
                    tried.add(rep.name)
                    # the hedged path already folded evidence + the
                    # retry metric per failing replica — don't double-
                    # charge the primary with (possibly the twin's)
                    # failure kind
                    if not getattr(e, "recorded", False):
                        self._m_retries.labels(replica=rep.name,
                                               reason=e.kind).inc()
                        if rep.breaker.record_failure(e.kind):
                            self._on_trip(rep, str(e))
                    self._emit_event("fleet-retry", trace_id=rid,
                                     replica=rep.name, reason=e.kind,
                                     attempt=attempts)
                    if retries > self.config.max_retries:
                        outcome = "retries_exhausted"
                        raise RetriesExhaustedError(
                            f"{retries - 1} retries exhausted; "
                            f"last: {e}") from e
                    # jittered backoff; a server-sent Retry-After wins;
                    # both bounded by what's left of the budget
                    sleep = max(jittered_backoff(delay, self.rng),
                                e.retry_after or 0.0)
                    sleep = min(sleep,
                                max(0.0, deadline - time.monotonic()))
                    if sleep > 0:
                        time.sleep(sleep)
                        retry_s += sleep
                    delay *= 2
        except RequestRejectedError:
            outcome = "rejected"
            raise
        finally:
            wall = time.monotonic() - t0
            ledger = gp.decompose_fleet_request(
                wall, upstream_s, retry_s, hedge_waste_s)
            self._m_requests.labels(outcome=outcome).inc()
            if self.writer is not None:
                self.writer.emit(
                    gp.FLEET_REQUEST_SPAN, start=t0_wall,
                    end=t0_wall + wall, trace_id=rid, model=model,
                    outcome=outcome, replica=winner,
                    attempts=attempts, retries=retries, hedged=hedged,
                    ledger=ledger)

    def _attempt_maybe_hedged(self, rep: _Replica, model: str,
                              body: bytes, rid: str, deadline: float,
                              hedge: bool, tried: set):
        """One attempt, optionally shadowed by tail hedges. Each time
        every in-flight attempt outlives the hedge delay, one more
        duplicate fires at a replica not yet holding this request —
        bounded by the fleet size; the first response wins. (A single
        twin is not enough when IT lands on a replica just entering
        its own pause — the bounded series guarantees reaching a live
        one.) Returns (response, winning_replica, hedge_waste_s); a
        raised _Retryable from the hedged path carries
        ``recorded=True`` — its breaker evidence and retry metric were
        already charged to the replica that actually failed."""
        remaining = deadline - time.monotonic()
        timeout = min(remaining, self.config.attempt_timeout_s)
        if not hedge:
            return self._send(rep, model, body, rid, timeout), rep, 0.0
        hedge_delay = self._hedge_delay_s(rep, model)
        primary = self._hedge_pool.submit(
            self._send, rep, model, body, rid, timeout)
        fired = {primary: rep}
        fired_at: dict = {}   # hedge future → fire time (waste calc)
        used = set(tried) | {rep.name}
        t_first_hedge: Optional[float] = None
        more_replicas = True
        while fired:
            budget = deadline - time.monotonic()
            if budget <= 0:
                # unrecorded: the outer handler charges the primary's
                # breaker once (the twins' own timeouts fire later,
                # unobserved)
                raise _Retryable(EVIDENCE_TIMEOUT,
                                 "hedged attempts timed out")
            done, _ = wait(list(fired),
                           timeout=min(hedge_delay, budget)
                           if more_replicas else budget,
                           return_when=FIRST_COMPLETED)
            if not done:
                if not more_replicas:
                    raise _Retryable(EVIDENCE_TIMEOUT,
                                     "hedged attempts timed out")
                # everyone in flight outlived the delay: fire one more
                # duplicate at a replica not yet holding this request
                # (probe_ok=False: a hedge may be abandoned unobserved,
                # which would leak a claimed half-open probe slot)
                try:
                    twin_rep = self.pick(model, exclude=used,
                                         probe_ok=False)
                except NoReplicaAvailableError:
                    more_replicas = False
                    continue
                used.add(twin_rep.name)
                if t_first_hedge is None:
                    t_first_hedge = time.monotonic()
                self._m_hedges.labels(outcome="fired").inc()
                self._emit_event("fleet-hedge", trace_id=rid,
                                 replica=twin_rep.name,
                                 primary=rep.name)
                twin = self._hedge_pool.submit(
                    self._send, twin_rep, model, body, rid,
                    min(max(0.001, deadline - time.monotonic()),
                        self.config.attempt_timeout_s))
                fired[twin] = twin_rep
                fired_at[twin] = time.monotonic()
                continue
            fut = done.pop()
            src = fired.pop(fut)
            try:
                out = fut.result()
            except _Retryable as e:
                # one attempt failed; breaker evidence for ITS
                # replica, keep waiting on the rest
                if src.breaker.record_failure(e.kind):
                    self._on_trip(src, str(e))
                self._m_retries.labels(replica=src.name,
                                       reason=e.kind).inc()
                if not fired:
                    e.recorded = True  # outer handler must not
                    raise              # re-charge the primary
                continue
            # winner: every still-running attempt's overlap-with-
            # hedging is duplicated upstream work — "cancelled" by
            # abandonment (urllib has no mid-flight abort; the
            # duplicated seconds are what we ledger either way)
            now = time.monotonic()
            waste = 0.0
            for leftover, leftover_rep in fired.items():
                leftover.cancel()
                # an abandoned attempt completes unobserved: free any
                # probe slot it held so the replica stays probe-able
                leftover_rep.breaker.release_probe()
                if t_first_hedge is not None:
                    # a loser's duplicated stretch starts when IT (or,
                    # for the primary, the first hedge) created the
                    # duplication
                    waste += now - fired_at.get(leftover,
                                                t_first_hedge)
            self._m_hedges.labels(
                outcome="lost" if src is rep else "won").inc()
            if waste > 0:
                self._m_hedge_waste.inc(round(waste, 6))
            return out, src, waste
        raise _Retryable(EVIDENCE_TIMEOUT, "hedge bookkeeping")

    def _hedge_delay_s(self, rep: _Replica, model: str) -> float:
        """The tail-hedge trigger: the replica's rolling p99 (fire only
        into the tail), floored at hedge_min_delay_ms; a configured
        hedge_delay_ms pins it."""
        if self.config.hedge_delay_ms is not None:
            return self.config.hedge_delay_ms / 1e3
        p99_ms = 0.0
        for m in (rep.health or {}).get("models", []):
            if model and m.get("model") not in ("", model):
                continue
            p99_ms = max(p99_ms, float(m.get("p99Ms", 0.0) or 0.0))
        return max(self.config.hedge_min_delay_ms, p99_ms) / 1e3

    # ------------------------------------------------------------ transport

    def _send(self, rep: _Replica, model: str, body: bytes, rid: str,
              timeout_s: float) -> dict:
        """One upstream attempt. Classifies failures: connect/timeout/
        5xx/429/503 raise _Retryable (weather — evidence + failover),
        other 4xx raise RequestRejectedError (meaning — surfaced)."""
        url = f"{rep.base_url}/v1/models/{model}:predict"
        req = urllib.request.Request(
            url, data=body, method="POST",
            headers={"Content-Type": "application/json",
                     REQUEST_ID_HEADER: rid,
                     DEADLINE_HEADER: f"{max(0.001, timeout_s):.3f}"})
        try:
            with urllib.request.urlopen(
                    req, timeout=max(0.001, timeout_s)) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            e.read()
            if e.code == 429:
                raise _Retryable(EVIDENCE_SHED, f"429: {e.reason}",
                                 retry_after=retry_after_s(e.headers))
            if e.code >= 500:
                raise _Retryable(EVIDENCE_5XX, f"{e.code}: {e.reason}",
                                 retry_after=retry_after_s(e.headers))
            raise RequestRejectedError(e.code, str(e.reason))
        except urllib.error.URLError as e:
            reason = getattr(e, "reason", e)
            if isinstance(reason, (TimeoutError,)) or \
                    "timed out" in str(reason):
                raise _Retryable(EVIDENCE_TIMEOUT, f"timeout: {reason}")
            raise _Retryable(EVIDENCE_CONNECT,
                             f"connect failure: {reason}")
        except (TimeoutError, ConnectionError, OSError) as e:
            kind = EVIDENCE_TIMEOUT if isinstance(e, TimeoutError) \
                else EVIDENCE_CONNECT
            raise _Retryable(kind, f"{type(e).__name__}: {e}")
        except json.JSONDecodeError as e:
            # a killed replica can tear the response mid-body
            raise _Retryable(EVIDENCE_CONNECT, f"torn response: {e}")

    # ------------------------------------------------------------- plumbing

    def _record_failure(self, rep: _Replica, kind: str,
                        weight: Optional[float] = None) -> bool:
        return rep.breaker.record_failure(kind, weight=weight)

    def _on_trip(self, rep: _Replica, detail: str) -> None:
        self._m_ejections.labels(replica=rep.name).inc()
        self._emit_event("fleet-eject", replica=rep.name,
                         detail=detail[:200])
        log.warning("fleet: replica %s ejected (breaker open): %s",
                    rep.name, detail)
        self._refresh_breaker_gauges()

    def _refresh_breaker_gauges(self) -> None:
        now = self.clock()
        for rep in self.replicas():
            self._m_breaker.labels(replica=rep.name).set(
                _BREAKER_STATE_CODE[rep.breaker.state(now)])
            self._m_breaker_score.labels(replica=rep.name).set(
                round(rep.breaker.score(now), 4))

    def _emit_event(self, name: str, trace_id: Optional[str] = None,
                    **attrs) -> None:
        if self.writer is not None:
            now = time.time()
            self.writer.emit(name, start=now, end=now,
                             trace_id=trace_id or "", **attrs)

    # -------------------------------------------------------------- status

    def snapshot(self) -> dict:
        """The fleet's own health view (dashboard / soak report)."""
        now = self.clock()
        reps = []
        for rep in self.replicas():
            reps.append({
                "name": rep.name, "baseUrl": rep.base_url,
                "draining": rep.draining,
                "uptimeSeconds": rep.uptime_s,
                "pollOk": rep.poll_ok,
                "breaker": rep.breaker.to_dict(),
                "score": round(self._score(rep, ""), 4),
            })
        return {"replicas": sorted(reps, key=lambda r: r["name"]),
                "config": {
                    "maxRetries": self.config.max_retries,
                    "defaultDeadlineSeconds":
                        self.config.default_deadline_s,
                    "hedge": self.config.hedge,
                },
                "breakerConfig": self.breaker_config.to_dict(),
                "time": now}

    def metrics_text(self) -> str:
        self._refresh_breaker_gauges()
        return self.registry.render()
