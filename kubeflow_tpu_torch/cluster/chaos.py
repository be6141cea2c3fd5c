"""Chaos drills: checkpoint faults and the serving fleet's fault menu.

The parts of ``kubeflow_tpu/cluster/chaos.py`` the port needs:

- the corruptors a chaos drill applies to a checkpoint directory between
  training segments (a truncated payload file under a committed step, a
  step whose commit marker is gone) and ``final_params``, which restores
  the newest intact step's params the way a resumed worker would;
- the serving arm: ``ChaosServable`` (scriptable serving faults),
  ``ServingReplicaHarness`` (one restartable in-process replica, over a
  ChaosServable or a real servable such as the LM on the card) and
  ``ServingSoak`` (the kill, drain, wedge and hedge scenarios behind a
  FleetRouter, and ``audit()``).
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..runtime.checkpoint import (MANIFEST_NAME, ORBAX_COMMIT_MARKER,
                                  CheckpointManager)

log = logging.getLogger(__name__)


def latest_step_dir(directory: str) -> Optional[str]:
    """The newest integer-named step directory, committed or not: the raw
    view a corruptor targets (restore never uses it)."""
    try:
        steps = sorted(int(n) for n in os.listdir(directory)
                       if n.isdigit()
                       and os.path.isdir(os.path.join(directory, n)))
    except OSError:
        return None
    return os.path.join(directory, str(steps[-1])) if steps else None


def truncate_checkpoint_payload(step_dir: str, keep_frac: float = 0.5
                                ) -> str:
    """Truncate the largest payload file of a committed step (a node that
    died mid-write). The commit marker stays, so only the manifest can
    catch it. Returns the truncated path."""
    candidates = []
    for root, _dirs, files in os.walk(step_dir):
        for fname in files:
            if fname in (MANIFEST_NAME, ORBAX_COMMIT_MARKER):
                continue
            path = os.path.join(root, fname)
            candidates.append((os.path.getsize(path), path))
    if not candidates:
        raise FileNotFoundError(f"no payload files under {step_dir}")
    size, path = max(candidates)
    with open(path, "r+b") as f:
        f.truncate(max(1, int(size * keep_frac)))
    log.info("chaos: truncated %s to %d/%d bytes", path,
             max(1, int(size * keep_frac)), size)
    return path


def uncommit_checkpoint(step_dir: str) -> None:
    """Remove the commit marker (a writer that died before finalizing):
    ``latest_step()`` must skip the step."""
    marker = os.path.join(step_dir, ORBAX_COMMIT_MARKER)
    if os.path.exists(marker):
        os.remove(marker)


def final_params(checkpoint_dir: str, device="cuda") -> dict:
    """The params of the newest intact step, on ``device`` (cuda unless
    the caller asks for the CPU): corrupted steps fall back."""
    mgr = CheckpointManager(checkpoint_dir)
    try:
        return mgr.restore_params(device=device)
    finally:
        mgr.close()


# ------------------------------------------------- serving-plane faults
# The serving fleet's fault menu: the failure classes one replica of a
# fleet WILL have, injectable against a real in-process ModelServer. The
# ChaosServable is a duck-typed servable (no device, host sleeps), so the
# whole ServingSoak runs without a card; a harness over a real servable
# (the LM on the card) takes the replica-crash fault.

SERVING_FAULT_KINDS = ("replica-crash", "wedge", "5xx-burst",
                       "cold-slow-start")


class ChaosServable:
    """Duck-typed servable with scriptable serving faults:

    - ``wedge()`` — accepts work, never answers (the hung-but-not-dead
      replica; only a client-side attempt timeout sees it) until
      ``unwedge()``;
    - ``fail_next(n, status)`` — the next n predicts raise with an
      ``http_status`` the server maps through (5xx burst);
    - ``slow_start(n, extra_s)`` — the next n predicts pay extra
      latency (a freshly-restarted cold replica warming its buckets);
    - ``tail_p``/``tail_s`` — seeded heavy-tail latency;
    - ``pause_every_s``/``pause_s``/``pause_phase_s`` — periodic
      whole-replica stalls (the GC-pause / compaction class the tail-
      at-scale hedging literature targets): a predict landing in a
      pause window waits it out, and its co-queued cohort piles up
      behind it. Replicas get offset phases, so a hedge to a DIFFERENT
      replica always finds one that is not pausing — the hedging A/B's
      workload.

    predict() echoes its instances after ``predict_s`` of host sleep —
    no numpy, no torch; the HTTP layer serializes whatever comes back.
    """

    def __init__(self, name: str = "chaos", predict_s: float = 0.004,
                 seed: int = 0, tail_p: float = 0.0,
                 tail_s: float = 0.0, pause_every_s: float = 0.0,
                 pause_s: float = 0.0, pause_phase_s: float = 0.0):
        self.name = name
        self.version = 1
        self.start_kind = "warm"
        self.predict_s = predict_s
        self.tail_p, self.tail_s = tail_p, tail_s
        self.pause_every_s = pause_every_s
        self.pause_s = pause_s
        self.pause_phase_s = pause_phase_s
        self._rng = random.Random(seed)
        self._proceed = threading.Event()
        self._proceed.set()
        self._lock = threading.Lock()
        self._fail_budget = 0
        self._fail_status = 500
        self._slow_left = 0
        self._slow_extra_s = 0.0
        self.predictions = 0

    # -------------------------------------------------------- fault knobs

    def wedge(self) -> None:
        """Accepts-never-responds: predicts block until unwedge()."""
        self._proceed.clear()

    def unwedge(self) -> None:
        self._proceed.set()

    @property
    def wedged(self) -> bool:
        return not self._proceed.is_set()

    def fail_next(self, n: int, status: int = 500) -> None:
        with self._lock:
            self._fail_budget += int(n)
            self._fail_status = int(status)

    def slow_start(self, n: int, extra_s: float) -> None:
        with self._lock:
            self._slow_left = int(n)
            self._slow_extra_s = float(extra_s)

    # ---------------------------------------------------- servable surface

    def predict(self, instances):
        self._proceed.wait()
        extra = 0.0
        with self._lock:
            if self._fail_budget > 0:
                self._fail_budget -= 1
                err = RuntimeError(
                    f"chaos: injected {self._fail_status}")
                err.http_status = self._fail_status
                raise err
            if self._slow_left > 0:
                self._slow_left -= 1
                extra += self._slow_extra_s
            if self.tail_p and self._rng.random() < self.tail_p:
                extra += self.tail_s
            self.predictions += 1
        if self.pause_every_s > 0:
            # a predict landing inside this replica's pause window
            # waits the pause out (and the queue behind it piles up)
            pos = (time.monotonic() + self.pause_phase_s) \
                % self.pause_every_s
            if pos < self.pause_s:
                extra += self.pause_s - pos
        time.sleep(self.predict_s + extra)
        return instances

    def metadata(self) -> dict:
        return {"model_spec": {"name": self.name},
                "stats": {"request_count": self.predictions,
                          "predict_seconds": 0.0}}

    def status(self) -> dict:
        return {"model_version_status": [
            {"version": self.version, "state": "AVAILABLE"}]}


class ServingReplicaHarness:
    """One in-process fleet member: a real ModelServer over a
    ChaosServable, or over ``servable`` when one is given (a real port
    servable, e.g. the LM on the card: only the replica-crash fault
    applies to it), restartable (the replacement-pod analog: same name,
    fresh server state, new port; a given servable is served again, its
    weights stay where they are)."""

    def __init__(self, name: str, span_path: Optional[str] = None,
                 model: str = "chaos", predict_s: float = 0.004,
                 seed: int = 0, tail_p: float = 0.0, tail_s: float = 0.0,
                 pause_every_s: float = 0.0, pause_s: float = 0.0,
                 pause_phase_s: float = 0.0,
                 max_batch: int = 8, max_latency_ms: float = 0.5,
                 servable=None):
        self.name = name
        self.span_path = span_path
        self._given = servable
        self.model = servable.name if servable is not None else model
        self._servable_kw = dict(name=model, predict_s=predict_s,
                                 seed=seed, tail_p=tail_p, tail_s=tail_s,
                                 pause_every_s=pause_every_s,
                                 pause_s=pause_s,
                                 pause_phase_s=pause_phase_s)
        self._server_kw = dict(max_batch=max_batch,
                               max_latency_ms=max_latency_ms)
        self.servable = None
        self.server = None
        self.url = ""

    def start(self) -> str:
        from ..serving.http_server import ModelServer
        self.servable = self._given if self._given is not None \
            else ChaosServable(**self._servable_kw)
        self.server = ModelServer(host="127.0.0.1", port=0,
                                  sample_every=0,
                                  span_path=self.span_path,
                                  **self._server_kw)
        self.server.repository.add(self.servable)
        port = self.server.start()
        self.url = f"http://127.0.0.1:{port}"
        return self.url

    def inject(self, kind: str, **kw) -> None:
        """The serving fault menu, by kind (SERVING_FAULT_KINDS)."""
        if kind not in SERVING_FAULT_KINDS:
            raise ValueError(f"unknown serving fault {kind!r} "
                             f"(choose from {SERVING_FAULT_KINDS})")
        if kind != "replica-crash" and \
                not isinstance(self.servable, ChaosServable):
            raise ValueError(f"serving fault {kind!r} needs a "
                             f"ChaosServable; {self.name} serves "
                             f"{type(self.servable).__name__}")
        if kind == "replica-crash":
            self.kill()
        elif kind == "wedge":
            self.servable.wedge()
        elif kind == "5xx-burst":
            self.servable.fail_next(kw.get("n", 10),
                                    kw.get("status", 500))
        else:   # cold-slow-start
            self.servable.slow_start(kw.get("n", 20),
                                     kw.get("extra_s", 0.03))
        log.info("chaos: serving fault %s on %s", kind, self.name)

    def kill(self) -> None:
        """SIGKILL-class crash: listener + live connections die,
        in-flight clients see a reset, nothing drains."""
        if self.server is not None:
            self.server.kill()

    def drain(self, timeout_s: float = 5.0) -> dict:
        return self.server.drain(timeout_s=timeout_s)

    def restart(self, slow_start_n: int = 0,
                slow_start_extra_s: float = 0.0) -> str:
        """The replacement pod: fresh server, same identity. A nonzero
        ``slow_start_n`` makes it a cold replica (the fourth fault
        kind) — its first n predicts pay ``slow_start_extra_s``."""
        self.stop()
        url = self.start()
        if slow_start_n and isinstance(self.servable, ChaosServable):
            self.servable.slow_start(slow_start_n, slow_start_extra_s)
        return url

    def stop(self) -> None:
        if self.server is not None:
            if isinstance(self.servable, ChaosServable):
                self.servable.unwedge()  # free any stuck batcher thread
            try:
                self.server.stop()
            except Exception:  # noqa: BLE001 — a killed server may throw
                pass
            self.server = None


@dataclass
class ServingSoak:
    """The kill-one-of-N availability soak: a real in-process N-replica
    fleet (ModelServers over ChaosServables, or over the ``servables``
    given, one per replica) behind a FleetRouter, driven by a
    closed-loop multi-threaded client while scripted serving faults
    land. Four scenarios:

    - **kill**: SIGKILL one replica mid-load (plus, over
      ChaosServables, a 5xx burst on a survivor and the victim's
      cold-slow-start restart — breaker probation re-admits it);
      asserts client success and zero duplicate deliveries.
    - **drain**: gracefully drain one replica mid-load; zero in-flight
      requests lost.
    - **wedge**: one replica accepts-and-never-responds; its breaker
      must eject it and, after recovery, probationally re-admit it.
    - **hedge A/B**: heavy-tail latency, hedging off vs on — the p99.9
      cut, and hedge_waste as the honest price.

    The wedge and hedge scenarios need ChaosServables. Requests carry
    ``bodies`` in turn (default: one 3-float instance); the first
    ``keep_responses`` answers of a load run come back in its report
    under ``samples`` as ``(body index, response)``. Every router span
    lands in ``span_path``; ``audit()`` re-reads the sink and checks the
    fleet ledgers sum to wall-clock (≤2% residual) with retries/hedges
    attributed, and that no request id was ever answered twice.
    """

    span_path: str = ""
    replicas: int = 3
    model: str = "chaos"
    predict_s: float = 0.004
    seconds: float = 3.0
    threads: int = 6
    seed: int = 0
    attempt_timeout_s: float = 0.5
    max_retries: int = 3
    hedge_requests: int = 240
    # the hedge A/B's heavy tail: per-replica periodic pauses (GC /
    # compaction class), phases offset so no two replicas pause at once
    pause_every_s: float = 1.2
    pause_s: float = 0.08
    hedge_delay_ms: float = 15.0
    servables: Optional[list] = None
    bodies: Optional[list] = None
    keep_responses: int = 0

    def __post_init__(self):
        if self.servables:
            if len(self.servables) != self.replicas:
                raise ValueError(f"{len(self.servables)} servables for "
                                 f"{self.replicas} replicas")
            self.model = self.servables[0].name

    # ------------------------------------------------------------ plumbing

    def _bodies(self) -> list:
        return self.bodies or [b'{"instances": [[1.0, 2.0, 3.0]]}']

    def _harnesses(self, prefix: str, **kw) -> list:
        out = []
        for i in range(self.replicas):
            h = ServingReplicaHarness(
                f"{prefix}{i}", span_path=self.span_path,
                model=self.model, predict_s=self.predict_s,
                seed=self.seed * 1000 + i,
                servable=self.servables[i] if self.servables else None,
                **kw)
            h.start()
            out.append(h)
        return out

    def _router(self, harnesses, hedge: bool = False):
        from ..serving.fleet import (BreakerConfig, FleetConfig,
                                     FleetRouter)
        cfg = FleetConfig(
            max_retries=self.max_retries, backoff_s=0.01,
            default_deadline_s=max(5.0, 6 * self.attempt_timeout_s),
            attempt_timeout_s=self.attempt_timeout_s,
            poll_interval_s=0.1, poll_timeout_s=1.0,
            hedge=hedge, hedge_delay_ms=self.hedge_delay_ms)
        bcfg = BreakerConfig(half_life_s=2.0, trip_threshold=2.0,
                             release_threshold=1.0, open_s=0.5,
                             open_max_s=5.0, probe_successes=2)
        router = FleetRouter(
            replicas={h.name: h.url for h in harnesses},
            config=cfg, breaker_config=bcfg,
            span_path=self.span_path,
            rng=random.Random(self.seed))
        router.poll_once()
        router.start_polling()
        return router

    def _load(self, router, prefix: str, seconds: float,
              faults: Optional[list] = None) -> dict:
        """Closed-loop load from ``threads`` workers for ``seconds``;
        ``faults`` is [(at_frac, fn)] fired once by the driver thread.
        Returns the outcome counts (and the kept samples)."""
        bodies = self._bodies()
        samples: list = []
        results: dict = {}
        res_lock = threading.Lock()
        counter = iter(range(10 ** 9))
        count_lock = threading.Lock()
        stop_at = time.monotonic() + seconds

        def worker():
            while time.monotonic() < stop_at:
                with count_lock:
                    n = next(counter)
                rid = f"{prefix}{n:05d}"
                try:
                    out = router.request(self.model,
                                         bodies[n % len(bodies)],
                                         request_id=rid)
                    ok, err = True, ""
                except Exception as e:  # noqa: BLE001 — the soak counts
                    ok, err = False, f"{type(e).__name__}: {e}"
                with res_lock:
                    results[rid] = (ok, err)
                    if ok and len(samples) < self.keep_responses:
                        samples.append((n % len(bodies), out))

        workers = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.threads)]
        t0 = time.monotonic()
        for w in workers:
            w.start()
        pending = sorted(faults or [], key=lambda f: f[0])
        while pending and time.monotonic() < stop_at:
            frac = (time.monotonic() - t0) / max(seconds, 1e-9)
            if frac >= pending[0][0]:
                _, fn = pending.pop(0)
                fn()
            else:
                time.sleep(0.01)
        for w in workers:
            w.join(timeout=seconds + 10)
        ok = sum(1 for o, _ in results.values() if o)
        errs = sorted({e for o, e in results.values() if not o})
        return {"requests": len(results), "ok": ok,
                "success_pct": round(100.0 * ok / len(results), 3)
                if results else 0.0,
                "errors": errs[:5], "samples": samples}

    # ----------------------------------------------------------- scenarios

    def run_kill(self) -> dict:
        """SIGKILL one of N mid-load; a survivor takes a 5xx burst (over
        ChaosServables); the victim restarts (cold, over ChaosServables)
        and earns probational re-admission."""
        harnesses = self._harnesses("kill-r")
        router = self._router(harnesses)
        victim, bursty = harnesses[0], harnesses[-1]

        def crash():
            victim.inject("replica-crash")

        def burst():
            bursty.inject("5xx-burst", n=8, status=500)

        def resurrect():
            url = victim.restart(slow_start_n=10,
                                 slow_start_extra_s=0.02)
            router.set_replica_url(victim.name, url)

        faults = [(0.25, crash), (0.6, resurrect)]
        if isinstance(bursty.servable, ChaosServable):
            faults.append((0.45, burst))
        try:
            report = self._load(router, "kill-", self.seconds,
                                faults=faults)
            # the resurrected victim must be earning its way back:
            # half-open probes → closed (probation served)
            deadline = time.monotonic() + 10.0
            state = ""
            while time.monotonic() < deadline:
                state = router.replica(victim.name).breaker.state()
                if state == "closed":
                    break
                try:
                    router.request(self.model, self._bodies()[0])
                except Exception:  # noqa: BLE001
                    pass
                time.sleep(0.05)
            report["victim_readmitted"] = state == "closed"
            report["victim_breaker"] = \
                router.replica(victim.name).breaker.to_dict()
            report["fleet"] = router.snapshot()
            return report
        finally:
            router.close()
            for h in harnesses:
                h.stop()

    def run_drain(self) -> dict:
        """Gracefully drain one replica mid-load: readiness flips, the
        router routes away, in-flight work finishes — zero loss."""
        harnesses = self._harnesses("drain-r")
        router = self._router(harnesses)
        drained = harnesses[1]
        drain_report: dict = {}

        def drain():
            drain_report.update(drained.drain(timeout_s=5.0))

        try:
            report = self._load(router, "drain-", self.seconds,
                                faults=[(0.4, drain)])
            router.poll_once()
            rep = router.replica(drained.name)
            report["drain"] = drain_report
            report["router_saw_draining"] = bool(rep and rep.draining)
            report["in_flight_lost"] = \
                int(drain_report.get("inFlightRemaining", -1))
            return report
        finally:
            router.close()
            for h in harnesses:
                h.stop()

    def run_wedge(self) -> dict:
        """One replica wedges (accepts, never responds): its breaker
        must eject it; after recovery it is probationally re-admitted."""
        harnesses = self._harnesses("wedge-r")
        router = self._router(harnesses)
        victim = harnesses[-1]
        events: dict = {}

        def wedge():
            victim.inject("wedge")

        def spot_ejection():
            events["ejected_during_load"] = \
                router.replica(victim.name).breaker.state() == "open"

        def recover():
            victim.servable.unwedge()

        try:
            report = self._load(
                router, "wedge-", self.seconds,
                faults=[(0.15, wedge), (0.55, spot_ejection),
                        (0.6, recover)])
            report.update(events)
            # keep trickling until probation completes
            deadline = time.monotonic() + 10.0
            state = ""
            while time.monotonic() < deadline:
                state = router.replica(victim.name).breaker.state()
                if state == "closed":
                    break
                try:
                    router.request(self.model, self._bodies()[0])
                except Exception:  # noqa: BLE001
                    pass
                time.sleep(0.05)
            report["ejected"] = bool(events.get("ejected_during_load")
                                     or router.replica(
                                         victim.name).breaker.trips)
            report["readmitted"] = state == "closed"
            report["victim_breaker"] = \
                router.replica(victim.name).breaker.to_dict()
            return report
        finally:
            router.close()
            for h in harnesses:
                h.stop()

    def run_hedge_ab(self) -> dict:
        """Heavy-tail latency, hedging off vs on: the tail (p99.9) must
        come down, and the duplicated work must land as hedge_waste —
        the honest price, never silent. The tail comes from per-replica
        periodic pauses with offset phases (no two replicas pause
        together), so a hedge to a different replica always finds a
        live one — the exact failure shape tail hedging exists for."""
        body = self._bodies()[0]
        arms = {}
        phase_step = self.pause_every_s / max(1, self.replicas)
        for arm, hedge in (("off", False), ("on", True)):
            harnesses = []
            for i in range(self.replicas):
                h = ServingReplicaHarness(
                    f"hedge{arm}-r{i}", span_path=self.span_path,
                    model=self.model, predict_s=self.predict_s,
                    seed=self.seed * 1000 + i,
                    pause_every_s=self.pause_every_s,
                    pause_s=self.pause_s,
                    pause_phase_s=i * phase_step)
                h.start()
                harnesses.append(h)
            router = self._router(harnesses, hedge=hedge)
            lats: list = []
            lat_lock = threading.Lock()
            counter = iter(range(10 ** 9))
            count_lock = threading.Lock()
            per_thread = max(1, self.hedge_requests // self.threads)

            def worker():
                for _ in range(per_thread):
                    with count_lock:
                        rid = f"hedge{arm}-{next(counter):05d}"
                    t0 = time.monotonic()
                    try:
                        router.request(self.model, body,
                                       request_id=rid)
                        with lat_lock:
                            lats.append(time.monotonic() - t0)
                    except Exception:  # noqa: BLE001
                        pass

            try:
                workers = [threading.Thread(target=worker,
                                             daemon=True)
                           for _ in range(self.threads)]
                for w in workers:
                    w.start()
                for w in workers:
                    w.join(timeout=120)
            finally:
                router.close()
                for h in harnesses:
                    h.stop()
            lats.sort()

            def pct(q):
                return lats[min(len(lats) - 1, int(len(lats) * q))] \
                    if lats else 0.0

            arms[arm] = {
                "requests": len(lats),
                "p50_ms": round(pct(0.50) * 1e3, 2),
                "p99_ms": round(pct(0.99) * 1e3, 2),
                "p999_ms": round(pct(0.999) * 1e3, 2),
            }
        off, on = arms["off"], arms["on"]
        return {
            "off": off, "on": on,
            "p999_cut_pct": round(
                100.0 * (off["p999_ms"] - on["p999_ms"]) /
                off["p999_ms"], 1) if off["p999_ms"] else 0.0,
            "hedging_cuts_p999": on["p999_ms"] < off["p999_ms"],
        }

    # -------------------------------------------------------------- audit

    def audit(self) -> dict:
        """Re-read the span sink: (1) every fleet ledger's wall
        partition holds (upstream + retry + other ≈ wall, ≤2%
        residual) with retries/hedges as NAMED badput; (2) zero
        duplicate side effects — per request id, at most ONE server
        replica completed it ok, audited on the kill- and drain-
        scenario ids where at-most-once matters (a crashed attempt
        must read error, its failover ok). Hedge ids duplicate
        server-side BY DESIGN (that is hedge_waste); wedge ids may
        late-complete into a closed connection — both excluded, and
        the exclusion stated here rather than hidden."""
        from ..obs import goodput as gp
        from ..obs.trace import load_spans
        spans = load_spans(self.span_path)
        fleet = [s for s in spans
                 if s.get("name") == gp.FLEET_REQUEST_SPAN]
        sum_ok = 0
        wall_s = other_s = hedge_waste_s = retry_s = 0.0
        worst_resid = 0.0
        for s in fleet:
            ledger = (s.get("attrs") or {}).get("ledger") or {}
            if gp.fleet_sum_ok(ledger):
                sum_ok += 1
            wall = float(ledger.get("wallSeconds", 0.0))
            bad = ledger.get("badputSeconds") or {}
            wall_s += wall
            other_s += float(bad.get(gp.BADPUT_OTHER, 0.0))
            hedge_waste_s += float(bad.get(gp.SERVING_HEDGE_WASTE, 0.0))
            retry_s += float(bad.get(gp.SERVING_RETRY, 0.0))
            if wall:
                total = float(ledger.get("upstreamSeconds", 0.0)) + \
                    float(bad.get(gp.SERVING_RETRY, 0.0)) + \
                    float(bad.get(gp.BADPUT_OTHER, 0.0))
                worst_resid = max(worst_resid,
                                  abs(total - wall) / wall)
        # server-side at-most-once for the kill/drain ids: a crashed
        # or drained-away attempt's server span must not read ok
        # alongside its failover's
        audited_prefixes = ("kill-", "drain-")
        served: dict = {}
        audited = 0
        for s in spans:
            if s.get("name") != gp.SERVING_REQUEST_SPAN:
                continue
            rid = str(s.get("trace_id", ""))
            if not rid.startswith(audited_prefixes):
                continue
            audited += 1
            if (s.get("attrs") or {}).get("outcome") == "ok":
                served[rid] = served.get(rid, 0) + 1
        dup_served = sum(1 for c in served.values() if c > 1)
        return {
            "fleet_requests": len(fleet),
            "ledger_sum_ok": bool(fleet) and sum_ok == len(fleet),
            "other_residual_pct": round(
                100.0 * other_s / wall_s, 3) if wall_s else 0.0,
            "worst_request_residual_pct": round(
                100.0 * worst_resid, 3),
            "retry_badput_s": round(retry_s, 4),
            "hedge_waste_s": round(hedge_waste_s, 4),
            "audited_server_completions": audited,
            "duplicate_side_effects": dup_served,
            "duplicate_audit_scope": list(audited_prefixes),
        }

    def run(self) -> dict:
        report = {"kill": self.run_kill(),
                  "drain": self.run_drain(),
                  "wedge": self.run_wedge(),
                  "hedge_ab": self.run_hedge_ab()}
        report["audit"] = self.audit()
        return report
