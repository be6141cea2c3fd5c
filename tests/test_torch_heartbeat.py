"""The worker's liveness heartbeat and the cluster client it patches with.

- ``HeartbeatReporter`` against a fake client, the three cases of
  ``tests/test_chaos.py``'s ``TestHeartbeatReporter``: a beat patches the
  pod's heartbeat annotation and is rate-limited unless forced; a flaky
  apiserver never raises into the loop; ``from_env`` needs the pod
  identity. Plus the two gauges, ``lastLoss``/``lastGradNorm`` as
  ``repr()`` (NaN survives) and ``annotate``.
- ``HttpKubeClient.patch`` against a local HTTP server: the REST path, the
  method, the JSON body; a 404 raises at once, a 500 is retried.
- ``train()`` inside a pod's env patches its pod at the start and at
  every window edge with the step and the last drained window's loss and
  grad norm.
"""

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from kubeflow_tpu_torch.api.trainingjob import (ANOMALY_ANNOTATION,
                                                HEARTBEAT_ANNOTATION)
from kubeflow_tpu_torch.cluster.http_client import (HttpKubeClient,
                                                    KubeError, object_path)
from kubeflow_tpu_torch.obs import registry as obsreg
from kubeflow_tpu_torch.runtime import metrics, worker
from kubeflow_tpu_torch.runtime.metrics import HeartbeatReporter


class FakeClient:
    """Pods as {(namespace, name): annotations}; ``fail_next`` makes the
    next patches raise."""

    def __init__(self):
        self.pods: dict = {}
        self.failures = 0

    def fail_next(self, n: int) -> None:
        self.failures = n

    def patch(self, api_version, kind, namespace, name, patch):
        if self.failures:
            self.failures -= 1
            raise KubeError("InternalError: injected")
        assert (api_version, kind) == ("v1", "Pod")
        ann = self.pods.setdefault((namespace, name), {})
        ann.update(patch["metadata"]["annotations"])
        return {"metadata": {"annotations": dict(ann)}}


def test_beat_patches_own_pod_and_rate_limits():
    client = FakeClient()
    hb = HeartbeatReporter(client, "kubeflow", "hb-pod", interval_s=60)
    assert hb.beat(5)
    payload = json.loads(client.pods[("kubeflow", "hb-pod")]
                         [HEARTBEAT_ANNOTATION])
    assert payload["step"] == 5 and payload["time"] > 0
    assert not hb.beat(6)                  # rate-limited
    assert hb.beat(7, force=True)          # ...unless forced
    text = obsreg.default_registry().render()
    assert "kftpu_heartbeat_last_step 7" in text
    assert "kftpu_heartbeat_last_time_seconds" in text


def test_flaky_apiserver_never_raises():
    client = FakeClient()
    client.fail_next(1)
    hb = HeartbeatReporter(client, "kubeflow", "hb-pod", interval_s=0)
    assert not hb.beat(1)                  # swallowed, reported False
    assert hb.beat(2)                      # next beat lands
    client.fail_next(1)
    assert not hb.annotate(ANOMALY_ANNOTATION, "{}")
    assert hb.annotate(ANOMALY_ANNOTATION, '{"kind": "nan"}')
    assert client.pods[("kubeflow", "hb-pod")][ANOMALY_ANNOTATION] == \
        '{"kind": "nan"}'


def test_from_env_requires_pod_identity():
    assert HeartbeatReporter.from_env(env={}) is None
    assert HeartbeatReporter.from_env(env={"KFTPU_POD_NAME": "p"}) is None
    hb = HeartbeatReporter.from_env(client=FakeClient(),
                                    env={"KFTPU_POD_NAME": "p",
                                         "KFTPU_POD_NAMESPACE": "ns"})
    assert hb is not None and hb.pod == "p" and hb.namespace == "ns"
    hb = HeartbeatReporter.from_env(env={"KFTPU_POD_NAME": "p",
                                         "KFTPU_APISERVER": "http://x:1"})
    assert isinstance(hb.client, HttpKubeClient)
    assert (hb.client.timeout, hb.client.retries) == (5.0, 0)
    assert hb.namespace == "default"


def test_loss_and_grad_norm_ride_along_as_repr():
    client = FakeClient()
    hb = HeartbeatReporter(client, "ns", "p", interval_s=0)
    assert hb.beat(3, loss=float("nan"), grad_norm=torch.tensor(2.5))
    payload = json.loads(client.pods[("ns", "p")][HEARTBEAT_ANNOTATION])
    assert payload["lastLoss"] == "nan" and math.isnan(
        float(payload["lastLoss"]))
    assert payload["lastGradNorm"] == "2.5"


# -- the REST client against a local server -------------------------------------

class _Apiserver(ThreadingHTTPServer):
    """Records every request; answers from ``script`` (code, body), then
    200 with the echoed patch."""

    def __init__(self):
        self.requests: list = []
        self.script: list = []
        self.lock = threading.Lock()
        super().__init__(("127.0.0.1", 0), _Handler)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.server_address[1]}"


class _Handler(BaseHTTPRequestHandler):
    def do_PATCH(self):
        body = json.loads(self.rfile.read(
            int(self.headers.get("Content-Length", 0))) or b"{}")
        with self.server.lock:
            self.server.requests.append((self.command, self.path, body,
                                         self.headers.get("Authorization")))
            code, reply = self.server.script.pop(0) if self.server.script \
                else (200, {"metadata": body.get("metadata", {})})
        data = json.dumps(reply).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *args):
        pass


@pytest.fixture
def apiserver():
    srv = _Apiserver()
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()


def test_patch_against_a_local_server(apiserver):
    c = HttpKubeClient(apiserver.url, token="tok", timeout=5.0, retries=1,
                       retry_backoff_s=0.01)
    patch = {"metadata": {"annotations": {"a": "1"}}}
    assert c.patch("v1", "Pod", "ns", "pod-0", patch) == patch
    method, path, body, auth = apiserver.requests[-1]
    assert (method, path, body, auth) == (
        "PATCH", "/api/v1/namespaces/ns/pods/pod-0", patch, "Bearer tok")
    # a 500 is weather: retried once, then the 200 lands
    apiserver.script = [(500, {"code": 500, "reason": "InternalError"})]
    assert c.patch("v1", "Pod", "ns", "pod-0", patch) == patch
    assert len(apiserver.requests) == 3
    # a 404 is meaning: raised at once, never retried
    apiserver.script = [(404, {"code": 404, "reason": "NotFound",
                               "message": "pods \"x\" not found"})]
    with pytest.raises(KubeError, match="NotFound"):
        c.patch("v1", "Pod", "ns", "x", patch)
    assert len(apiserver.requests) == 4
    assert object_path("kubeflow.org/v1", "TPUJob", "ns", "j") == \
        "/apis/kubeflow.org/v1/namespaces/ns/tpujobs/j"


def test_unreachable_apiserver_raises_kube_error():
    c = HttpKubeClient("http://127.0.0.1:1", timeout=1.0, retries=0)
    with pytest.raises(KubeError, match="Unreachable"):
        c.patch("v1", "Pod", "ns", "p", {})


def test_worker_beats_at_start_and_every_window(apiserver, monkeypatch):
    monkeypatch.setenv("KFTPU_POD_NAME", "job-worker-0")
    monkeypatch.setenv("KFTPU_POD_NAMESPACE", "team")
    monkeypatch.setenv("KFTPU_APISERVER", apiserver.url)
    from_env = metrics.HeartbeatReporter.from_env.__func__
    monkeypatch.setattr(
        worker.HeartbeatReporter, "from_env",
        classmethod(lambda cls, **kw: from_env(cls, interval_s=0.0, **kw)))
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    cfg = TransformerConfig(vocab_size=64, num_layers=1, embed_dim=16,
                            num_heads=2, head_dim=8, mlp_dim=32,
                            max_seq_len=16, dtype=torch.float32)
    worker.train(workload="transformer", workload_kwargs={"cfg": cfg},
                 optimizer="adam", learning_rate=1e-2, global_batch=2,
                 steps=4, sync_every=2, device="cpu", handle_sigterm=False)
    beats = [json.loads(b["metadata"]["annotations"][HEARTBEAT_ANNOTATION])
             for _, path, b, _ in apiserver.requests
             if path == "/api/v1/namespaces/team/pods/job-worker-0"]
    assert [b["step"] for b in beats] == [0, 2, 4]
    # the values are the last drained window's: none at the start, none
    # at step 2 (its window drains a window later), step 2's at the end
    assert "lastLoss" not in beats[0] and "lastLoss" not in beats[1]
    assert math.isfinite(float(beats[2]["lastLoss"]))
    assert float(beats[2]["lastGradNorm"]) > 0
