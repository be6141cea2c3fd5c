"""The port's manager process, ``python -m kubeflow_tpu_torch.controllers``,
as deployed: lease-elected replicas over the port's apiserver.

``cluster/apiserver.py`` serves an audit ``FakeCluster`` (the
control-plane soak's, which counts pod creates that hit AlreadyExists)
with one ``h100-8`` node; the test holds the cluster's hand (``tick``
schedules and runs pods) and starts manager processes with
``--leader-elect`` against it through a kubeconfig. Outcomes only, each
waited for under a deadline:

- the first replica leads and creates the ``GPU: h100-2`` gang; the
  standby creates nothing;
- SIGKILL of the leader: the standby steals the lease once it expires,
  recreates the failed pod, and no pod is created twice;
- SIGTERM of the leader: it releases the lease, and a standby leads in
  less than one lease duration;
- a controller the port has not ported is refused with its ROADMAP item.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from kubeflow_tpu_torch.cluster import lease as L
from kubeflow_tpu_torch.cluster.apiserver import ClusterAPIServer
from kubeflow_tpu_torch.controllers.tpujob import RESTART_COUNT_ANNOTATION
from kubeflow_tpu_torch.scheduler.soak import _make_audit_cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_AV = "tpu.kubeflow.org/v1alpha1"
LEASE_S = 10.0         # the replicas' lease duration
DEADLINE_S = 60.0      # any one outcome, under the suite's load


@pytest.fixture
def cluster(tmp_path):
    backend = _make_audit_cluster()
    backend.add_gpu_nodes("h100-8")
    server = ClusterAPIServer(backend, port=0)
    port = server.start()
    kubeconfig = tmp_path / "kubeconfig"
    kubeconfig.write_text(f"""apiVersion: v1
kind: Config
current-context: sim
clusters: [{{name: sim, cluster: {{server: "http://127.0.0.1:{port}"}}}}]
users: [{{name: sim, user: {{token: t}}}}]
contexts: [{{name: sim, context: {{cluster: sim, user: sim}}}}]
""")
    stop = threading.Event()

    def hand():
        # the kubelet's and scheduler's hand: bind and run pods
        while not stop.is_set():
            backend.tick()
            time.sleep(0.05)

    t = threading.Thread(target=hand, daemon=True)
    t.start()
    procs = []

    def manager(identity: str):
        log = open(tmp_path / f"manager-{identity}.log", "w")
        p = subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.controllers",
             "--kubeconfig", str(kubeconfig), "--controllers", "tpujob",
             "--leader-elect", "--lease-name", "op",
             "--lease-namespace", "kubeflow",
             "--lease-duration", str(LEASE_S), "--identity", identity],
            cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
            stdout=log, stderr=subprocess.STDOUT)
        log.close()
        p.log = tmp_path / f"manager-{identity}.log"
        procs.append(p)
        return p

    yield backend, manager
    stop.set()
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=30)
    server.stop()


def _holder(backend) -> str:
    obj = backend.get_or_none(L.LEASE_API_VERSION, L.LEASE_KIND,
                              "kubeflow", "op")
    return L.lease_record(obj).holder if obj else ""


def _wait(cond, what: str, timeout: float = DEADLINE_S) -> float:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return time.monotonic() - t0
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _running(backend) -> list:
    return sorted(p["metadata"]["name"]
                  for p in backend.list("v1", "Pod", "kubeflow")
                  if p.get("status", {}).get("phase") == "Running")


def _job():
    return {"apiVersion": TPU_AV, "kind": "TPUJob",
            "metadata": {"name": "train", "namespace": "kubeflow"},
            "spec": {"replicaSpecs": {"GPU": {
                "gpuTopology": "h100-2",
                "template": {"spec": {"containers": [
                    {"name": "trainer", "image": "trainer:v1"}]}}}},
                "runPolicy": {"backoffLimit": 5}}}


def test_a_killed_leader_is_replaced_and_a_terminated_one_hands_over(
        cluster):
    backend, manager = cluster
    procs = {"a": manager("a")}
    _wait(lambda: _holder(backend) == "a", "a to lead")
    procs["b"] = manager("b")
    backend.create(_job())
    gang = ["train-worker-0-0", "train-worker-0-1"]
    _wait(lambda: _running(backend) == gang, "the gang to run")

    # SIGKILL of the leader: no release; the other steals at expiry and
    # heals the gang
    leader = _holder(backend)
    (standby,) = set(procs) - {leader}
    procs[leader].send_signal(signal.SIGKILL)
    procs[leader].wait(timeout=30)
    backend.fail_pod("kubeflow", "train-worker-0-1", "chaos: died")
    _wait(lambda: _holder(backend) == standby, "the standby to steal")
    _wait(lambda: _running(backend) == gang, "the gang to run again")
    job = backend.get(TPU_AV, "TPUJob", "kubeflow", "train")
    assert job["metadata"]["annotations"][RESTART_COUNT_ANNOTATION] == "1"
    assert backend.duplicate_pod_creates == 0

    # SIGTERM of the leader: it releases, and the standby c leads within
    # one lease duration
    procs["c"] = manager("c")
    _wait(lambda: "manager running" in procs["c"].log.read_text(),
          "c to follow")
    leader = _holder(backend)
    (successor,) = {standby, "c"} - {leader}
    t0 = time.monotonic()
    procs[leader].send_signal(signal.SIGTERM)
    _wait(lambda: _holder(backend) == successor, "the standby to lead")
    handover = time.monotonic() - t0
    assert handover < LEASE_S, handover
    assert procs[leader].wait(timeout=30) == 0
    assert backend.duplicate_pod_creates == 0


def test_an_unported_controller_is_refused_with_its_roadmap_item():
    out = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.controllers", "--fake",
         "--controllers", "tpujob,notebook"],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=60)
    assert out.returncode != 0
    assert "'notebook' is not ported" in out.stderr
    assert "ROADMAP Queue 1, item 20" in out.stderr
