"""The port's serving fleet against the JAX package's, on the CPU.

- ``CircuitBreaker``: one event script on a fake clock gives the same
  state, score and return value after every event in both packages;
  ``fold_event``, the fleet ledger, its rollup, the pick and the retry
  helpers agree exactly.
- A mixed fleet: a FleetRouter of either package over one JAX replica
  and one port replica, each serving the small LM (2 layers, embed 64,
  4 heads x 16, S 32, vocab 256, f32; weights made with numpy from a
  seed and carried across by ``models/convert.py``), fails over when
  either replica is killed; every answer's ``next_token`` equals a
  direct forward's.
- ``ServingSoak``: the kill, drain and wedge scenarios over
  ChaosServables at 1 s of load each, then ``audit()``: 100% client
  success, zero duplicate deliveries, fleet ledgers that sum.
"""

import json
import random
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from kubeflow_tpu.cluster import chaos as JC
from kubeflow_tpu.cluster import http_client as JHC
from kubeflow_tpu.obs import goodput as JGP
from kubeflow_tpu.obs.trace import SpanWriter
from kubeflow_tpu.scheduler import health as JHE
from kubeflow_tpu.serving import fleet as JF
from kubeflow_tpu.serving import http_server as JH
from kubeflow_tpu_torch.cluster import chaos as TC
from kubeflow_tpu_torch.cluster import http_client as THC
from kubeflow_tpu_torch.obs import goodput as TGP
from kubeflow_tpu_torch.obs.trace import load_spans
from kubeflow_tpu_torch.scheduler import health as THE
from kubeflow_tpu_torch.serving import fleet as TF
from kubeflow_tpu_torch.serving import http_server as TH

from test_torch_serving import (jax_servable, params,  # noqa: F401
                                tokens, torch_servable)

FLEETS = {"jax": JF, "torch": TF}
BODY = json.dumps({"instances": [[1.0, 2.0, 3.0]]}).encode()


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# the breaker scripts: (advance seconds, op, argument)
SCRIPTS = {
    "trip-decay-probe-close": [
        (0, "fail", "5xx"), (0.5, "fail", "timeout"),
        (0.1, "fail", "connect-failure"), (0.2, "fail", "timeout"),
        (1.0, "allow", None), (5.1, "state", None), (0, "probe", None),
        (0, "probe", None), (10.0, "ok", None), (0, "probe", None),
        (0, "ok", None), (0, "state", None)],
    "probe-failure-extends-cooldown": [
        (0, "fail", "timeout"), (0, "fail", "timeout"),
        (0, "fail", "timeout"), (5.1, "probe", None),
        (0, "fail", "timeout"), (5.1, "state", None),
        (5.0, "state", None), (0, "allow", None), (0, "release_probe", None),
        (0, "probe", None), (0, "fail", "shed"), (60.0, "state", None)],
    "manual-eject-and-release": [
        (0, "fail", "burn-rate"), (0, "eject", True), (1e4, "state", None),
        (0, "allow", None), (0, "release", None), (0, "state", None),
        (0, "fail", "5xx"), (3.0, "fail", "5xx"), (0, "ok", None)],
    "hot-score-keeps-half-open": [
        (0, "fail", "timeout"), (0, "fail", "timeout"),
        (0, "fail", "timeout"), (0, "fail", "timeout"), (5.1, "probe", None),
        (0, "ok", None), (0, "probe", None), (0, "ok", None),
        (0, "probe", None), (0, "ok", None), (0, "state", None)],
}


def _run_script(F, script, cfg_kw) -> list:
    clk = FakeClock()
    b = F.CircuitBreaker(F.BreakerConfig(**cfg_kw), clock=clk)
    trace = []
    for dt, op, arg in script:
        clk.t += dt
        if op == "fail":
            out = b.record_failure(arg)
        elif op == "ok":
            out = b.record_success()
        elif op == "probe":
            out = b.try_probe()
        elif op == "allow":
            out = b.allow_request()
        elif op == "eject":
            out = b.eject(manual=arg)
        else:
            out = getattr(b, op)()
        trace.append((op, out, b.state(), round(b.score(), 9),
                      b.to_dict()))
    return trace


@pytest.mark.parametrize("name", sorted(SCRIPTS))
@pytest.mark.parametrize("cfg_kw", [
    dict(half_life_s=10.0, trip_threshold=3.0, release_threshold=1.0,
         open_s=5.0, open_max_s=60.0, probe_successes=2),
    dict(half_life_s=1000.0, trip_threshold=2.0, release_threshold=1.0,
         open_s=5.0, open_max_s=9.0, probe_successes=3)],
    ids=["default", "slow-decay"])
def test_breaker_trace_equals_the_reference(name, cfg_kw):
    assert _run_script(TF, SCRIPTS[name], cfg_kw) == \
        _run_script(JF, SCRIPTS[name], cfg_kw)


def test_breaker_config_and_evidence_vocabulary():
    assert TF.FLEET_EVIDENCE_WEIGHTS == JF.FLEET_EVIDENCE_WEIGHTS
    assert TF.BreakerConfig.KEYS == JF.BreakerConfig.KEYS
    with pytest.raises(ValueError, match="unknown breaker config"):
        TF.BreakerConfig.from_dict({"tripThreshold": 2, "typo": 1})
    cfg = TF.BreakerConfig.from_dict({"tripThreshold": 2.5})
    assert cfg.to_dict() == \
        JF.BreakerConfig.from_dict({"tripThreshold": 2.5}).to_dict()


def test_fold_event_and_retry_helpers_equal_the_reference():
    rng = np.random.default_rng(0)
    kinds = list(JHE.EVENT_WEIGHTS) + ["unknown", "5xx"]
    j = t = {}
    now = 0.0
    for i in range(200):
        now += float(rng.exponential(30.0))
        kind = kinds[int(rng.integers(len(kinds)))]
        weight = None if i % 3 else float(rng.uniform(0.1, 2.0))
        j = JHE.fold_event(j, kind, now, half_life_s=60.0, weight=weight)
        t = THE.fold_event(t, kind, now, half_life_s=60.0, weight=weight)
        assert t == j
    assert THE.EVENT_WEIGHTS == JHE.EVENT_WEIGHTS
    for headers in ({"Retry-After": "2.5"}, {"Retry-After": "soon"},
                    {"Retry-After": "-1"}, {}, None):
        assert THC.retry_after_s(headers) == JHC.retry_after_s(headers)
    a, b = random.Random(4), random.Random(4)
    assert [THC.jittered_backoff(0.1 * k, a) for k in range(1, 20)] == \
        [JHC.jittered_backoff(0.1 * k, b) for k in range(1, 20)]


def test_fleet_ledger_and_rollup_equal_the_reference(tmp_path):
    for args in ((1.0, 0.7, 0.2, 0.5), (0.3, 0.31, 0.0, 0.0),
                 (2.0, 0.1, 1.5, 0.0)):
        t = TGP.decompose_fleet_request(*args)
        assert t == JGP.decompose_fleet_request(*args)
        assert TGP.fleet_sum_ok(t) == JGP.fleet_sum_ok(t)
    leak = TGP.decompose_fleet_request(1.0, 0.7, 0.2)
    leak["badputSeconds"][TGP.BADPUT_OTHER] = 0.0
    assert not TGP.fleet_sum_ok(leak) and not JGP.fleet_sum_ok(leak)
    assert (TGP.FLEET_BADPUT_CATEGORIES, TGP.FLEET_REQUEST_SPAN,
            TGP.FLEET_EVENT_SPANS) == (JGP.FLEET_BADPUT_CATEGORIES,
                                       JGP.FLEET_REQUEST_SPAN,
                                       JGP.FLEET_EVENT_SPANS)
    sink = str(tmp_path / "f.jsonl")
    w = SpanWriter(sink, "fleet")
    for i, (outcome, retries) in enumerate(
            [("ok", 0), ("ok", 2), ("deadline", 3), ("ok", 1)]):
        w.emit(JGP.FLEET_REQUEST_SPAN, start=float(i), end=i + 0.01,
               trace_id=f"r{i}", outcome=outcome, replica="ab"[i % 2],
               attempts=retries + 1, retries=retries, hedged=i == 1,
               ledger=JGP.decompose_fleet_request(
                   0.01 * (i + 1), 0.008, 0.001, 0.002 * (i == 1)))
    w.close()
    assert TGP.fleet_rollup(sink) == JGP.fleet_rollup(sink)


def test_pick_equals_the_reference():
    """Seeded rngs over the same polled health: the same replica every
    time, draining and ejected replicas skipped alike."""
    rng = np.random.default_rng(1)
    routers = {}
    for pkg, F in FLEETS.items():
        r = F.FleetRouter(rng=random.Random(9))
        for name in "abcde":
            r.add_replica(name, f"http://127.0.0.1:{ord(name)}")
        routers[pkg] = r
    try:
        for _ in range(50):
            health = {n: {"models": [{
                "model": "m", "queueDepth": int(rng.integers(0, 4)),
                "inFlight": int(rng.integers(0, 3)),
                "p99Ms": float(rng.integers(0, 50))}]} for n in "abcde"}
            drain = "abcde"[int(rng.integers(5))]
            picks = {}
            for pkg, r in routers.items():
                for rep in r.replicas():
                    rep.poll_ok, rep.health = True, health[rep.name]
                    rep.draining = rep.name == drain
                picks[pkg] = [r.pick("m", exclude={"e"}).name
                              for _ in range(3)]
            assert picks["torch"] == picks["jax"]
        for r in routers.values():
            r.replica("a").breaker.eject()
        assert {routers["torch"].pick("m").name for _ in range(10)} <= \
            set("bcde")
    finally:
        for r in routers.values():
            r.close()


def test_metrics_pruned_on_replica_removal():
    r = TF.FleetRouter()
    r.add_replica("x", "http://127.0.0.1:1")
    r.replica("x").breaker.record_failure("timeout")
    text = r.metrics_text()
    assert 'kftpu_fleet_breaker_state{replica="x"}' in text
    assert "kftpu_fleet_replicas 1" in text
    r.remove_replica("x")
    text = r.metrics_text()
    assert 'replica="x"' not in text and "kftpu_fleet_replicas 0" in text
    assert r.snapshot()["replicas"] == []
    r.close()


# ------------------------------------------------------ the mixed fleet


def _lm_replica(pkg: str, servable):
    H = JH if pkg == "jax" else TH
    srv = H.ModelServer(host="127.0.0.1", port=0, sample_every=0)
    srv.repository.add(servable)
    srv.start()
    return srv


@pytest.fixture(scope="module")
def lm_pair(params):
    return {"jax": jax_servable(params), "torch": torch_servable(params)}


@pytest.mark.parametrize("victim", ["jax", "torch"])
@pytest.mark.parametrize("router_pkg", ["torch", "jax"])
def test_mixed_fleet_fails_over_on_kill(lm_pair, router_pkg, victim,
                                        tmp_path):
    servers = {pkg: _lm_replica(pkg, s) for pkg, s in lm_pair.items()}
    F = FLEETS[router_pkg]
    sink = str(tmp_path / "fleet.jsonl")
    router = F.FleetRouter(
        replicas={p: f"http://127.0.0.1:{s.port}"
                  for p, s in servers.items()},
        config=F.FleetConfig(max_retries=2, backoff_s=0.01,
                             attempt_timeout_s=10.0,
                             default_deadline_s=30.0),
        span_path=sink, rng=random.Random(0))
    direct = lm_pair["torch"]
    try:
        router.poll_once()
        x = tokens(2, seed=5)
        body = json.dumps({"instances": x.tolist(),
                           "dtype": "int32"}).encode()
        want = direct.predict(x)["next_token"]
        for i in range(2):   # both replicas answer alike
            out = router.request("lm", body, request_id=f"pre{i}")
            np.testing.assert_array_equal(
                out["predictions"]["next_token"], want)
        servers[victim].kill()
        for i in range(12):
            out = router.request("lm", body, request_id=f"post{i}")
            np.testing.assert_array_equal(
                out["predictions"]["next_token"], want)
            if router.replica(victim).breaker.trips:
                break
    finally:
        router.close()
        for s in servers.values():
            try:
                s.stop()
            except Exception:  # noqa: BLE001 - the killed one may throw
                pass
    spans = [s for s in load_spans(sink)
             if s["name"] == TGP.FLEET_REQUEST_SPAN]
    assert all(s["attrs"]["outcome"] == "ok" for s in spans)
    post = [s for s in spans if s["trace_id"].startswith("post")]
    assert post[-1]["attrs"]["replica"] != victim
    retried = [s for s in post if s["attrs"]["retries"] > 0]
    assert retried, "no request was routed to the killed replica"
    for s in retried:
        assert TGP.fleet_sum_ok(s["attrs"]["ledger"])
        assert s["attrs"]["replica"] != victim


def test_killed_server_answers_nobody():
    h = TC.ServingReplicaHarness("k0", predict_s=0.3)
    h.start()
    errors = []

    def call():
        req = urllib.request.Request(f"{h.url}/v1/models/chaos:predict",
                                     data=BODY, method="POST")
        try:
            urllib.request.urlopen(req, timeout=5).read()
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            errors.append(type(e).__name__)

    t = threading.Thread(target=call)
    t.start()
    time.sleep(0.1)
    h.kill()
    t.join(timeout=10)
    h.stop()
    assert errors, "an in-flight request got an answer from a killed server"


def test_real_servable_takes_only_the_crash_fault():
    class Real:
        name = "real"

    h = TC.ServingReplicaHarness("k1", servable=Real())
    assert h.model == "real"
    h.servable = h._given
    for kind in ("wedge", "5xx-burst", "cold-slow-start"):
        with pytest.raises(ValueError, match="needs a ChaosServable"):
            h.inject(kind)
    with pytest.raises(ValueError, match="unknown serving fault"):
        h.inject("meteor")


# ------------------------------------------------------------ the soak


@pytest.mark.parametrize("scenario", ["kill", "drain", "wedge"])
def test_soak_scenario_and_audit(tmp_path, scenario):
    soak = TC.ServingSoak(span_path=str(tmp_path / "spans.jsonl"),
                          seconds=1.0, threads=4,
                          attempt_timeout_s=0.2)
    report = getattr(soak, f"run_{scenario}")()
    assert report["requests"] > 0
    assert report["success_pct"] == 100.0, report["errors"]
    if scenario == "kill":
        assert report["victim_readmitted"], report["victim_breaker"]
    elif scenario == "drain":
        assert report["router_saw_draining"]
        assert report["in_flight_lost"] == 0
    else:
        # whether the breaker trips depends on how many requests the pick
        # sent to the replica while it was wedged (the polled in-flight
        # count steers traffic away after the first timeout); the client
        # never sees the wedge either way, and the replica ends admitted
        assert report["readmitted"], report["victim_breaker"]
    audit = soak.audit()
    assert audit["fleet_requests"] >= report["requests"]
    assert audit["ledger_sum_ok"]
    assert audit["worst_request_residual_pct"] <= 2.0
    assert audit["duplicate_side_effects"] == 0
    if scenario == "kill":
        assert audit["retry_badput_s"] > 0


def test_soak_over_given_servables_keeps_samples(tmp_path):
    """The harness serves a given servable (the chip runs the LM this
    way); the soak cycles its bodies and keeps the first answers."""
    servables = [JC.ChaosServable(name="echo", predict_s=0.001)
                 for _ in range(3)]
    bodies = [json.dumps({"instances": [[float(i)] * 3]}).encode()
              for i in range(4)]
    soak = TC.ServingSoak(span_path=str(tmp_path / "spans.jsonl"),
                          seconds=0.5, threads=2, servables=servables,
                          bodies=bodies, keep_responses=8)
    assert soak.model == "echo"
    report = soak.run_drain()
    assert report["success_pct"] == 100.0
    assert len(report["samples"]) == 8
    for i, out in report["samples"]:
        assert out["predictions"] == [[float(i)] * 3]
    with pytest.raises(ValueError, match="2 servables for 3"):
        TC.ServingSoak(servables=servables[:2])


def test_soak_hedge_ab_ledgers_the_duplicated_work(tmp_path):
    """The hedge A/B over ChaosServables with offset pauses: both arms
    answer every request, hedged requests are ledgered, and the ledgers
    still sum (hedge_waste stands outside the wall partition)."""
    soak = TC.ServingSoak(span_path=str(tmp_path / "spans.jsonl"),
                          threads=4, hedge_requests=48, pause_every_s=0.4,
                          pause_s=0.08, hedge_delay_ms=15.0)
    ab = soak.run_hedge_ab()
    assert ab["off"]["requests"] == ab["on"]["requests"] == 48
    spans = [s for s in load_spans(str(tmp_path / "spans.jsonl"))
             if s["name"] == TGP.FLEET_REQUEST_SPAN]
    hedged = [s for s in spans if s["attrs"]["hedged"]]
    assert hedged and all(s["trace_id"].startswith("hedgeon-")
                          for s in hedged)
    assert soak.audit()["ledger_sum_ok"]
