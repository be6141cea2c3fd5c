"""A replica never answers ok after its caller's deadline has passed.

The fleet router (``serving/fleet.py``) gives each attempt a deadline,
sends it in ``x-request-deadline`` and stops waiting when it passes; it
then retries the request on another replica. A replica that commits its
answer after that point records a second ok for a request another
replica answers: a duplicate side effect, which ``ServingSoak.audit()``
counts (phase 10c of ``chip_smoke.py``). The server therefore refuses to
commit an answer once the caller's budget, counted from the request's
arrival, is spent: the request reads as an error (504), never as an ok.

The handlers here are held past the deadline by a sleep in their first
request's parse, three times the attempt's deadline, so the outcome
does not depend on the machine's speed.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

from kubeflow_tpu_torch.cluster.chaos import ServingSoak
from kubeflow_tpu_torch.obs import goodput as gp
from kubeflow_tpu_torch.obs.trace import load_spans
from kubeflow_tpu_torch.serving.request_trace import (DEADLINE_HEADER,
                                                      REQUEST_ID_HEADER)

ATTEMPT_S = 0.3
HOLD_S = 3 * ATTEMPT_S
BODY = b'{"instances": [[1.0, 2.0, 3.0]]}'


def _hold_first_request(harness) -> None:
    """The harness's server sleeps HOLD_S in its first request's parse."""
    handler = harness.server._httpd.RequestHandlerClass
    real = handler._parse_instances
    held = []

    def parse(self, req):
        if not held:
            held.append(True)
            time.sleep(HOLD_S)
        return real(self, req)

    handler._parse_instances = parse


def _server_outcomes(path: str, rid: str) -> list:
    return sorted((s.get("attrs") or {}).get("outcome")
                  for s in load_spans(path)
                  if s.get("name") == gp.SERVING_REQUEST_SPAN
                  and str(s.get("trace_id")) == rid)


def test_an_answer_past_the_callers_deadline_is_not_committed(tmp_path):
    spans = str(tmp_path / "spans.jsonl")
    soak = ServingSoak(span_path=spans, replicas=1)
    (h,) = soak._harnesses("kill-r")
    try:
        _hold_first_request(h)
        req = urllib.request.Request(
            f"{h.url}/v1/models/{soak.model}:predict", data=BODY,
            method="POST", headers={"Content-Type": "application/json",
                                    REQUEST_ID_HEADER: "kill-late",
                                    DEADLINE_HEADER: f"{ATTEMPT_S:.3f}"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30).read()
        assert e.value.code == 504
        # a request within its deadline is answered
        req = urllib.request.Request(
            req.full_url, data=BODY, method="POST",
            headers={"Content-Type": "application/json",
                     REQUEST_ID_HEADER: "kill-ontime",
                     DEADLINE_HEADER: f"{ATTEMPT_S * 10:.3f}"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert "predictions" in json.loads(r.read())
    finally:
        h.stop()
    assert _server_outcomes(spans, "kill-late") == ["error"]
    assert _server_outcomes(spans, "kill-ontime") == ["ok"]


def test_a_retried_request_is_answered_ok_once(tmp_path):
    """Both replicas hold their first request past the attempt's
    deadline: the router times out on each and comes back around to the
    first, now quick. Exactly one server span of the request reads ok,
    and the soak's audit counts no duplicate."""
    spans = str(tmp_path / "spans.jsonl")
    soak = ServingSoak(span_path=spans, replicas=2,
                       attempt_timeout_s=ATTEMPT_S, max_retries=3)
    harnesses = soak._harnesses("kill-r")
    router = soak._router(harnesses)
    try:
        for h in harnesses:
            _hold_first_request(h)
        out = router.request(soak.model, BODY, request_id="kill-00000")
        assert "predictions" in out
        time.sleep(HOLD_S + 0.5)   # the held handlers finish
    finally:
        router.close()
        for h in harnesses:
            h.stop()
    outcomes = _server_outcomes(spans, "kill-00000")
    assert outcomes.count("ok") == 1, outcomes
    assert outcomes.count("error") == 2, outcomes
    retries = [(s.get("attrs") or {}).get("reason")
               for s in load_spans(spans) if s.get("name") == "fleet-retry"]
    assert retries == ["timeout", "timeout"]
    assert soak.audit()["duplicate_side_effects"] == 0
