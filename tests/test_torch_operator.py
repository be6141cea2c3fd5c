"""The port's training-job operator against the JAX package's
(``kubeflow_tpu/controllers/tpujob.py`` on its own ``FakeCluster`` and
``Manager``).

- Scripted scenarios run through both reconcilers: the JAX one with a
  ``TPU: v5e-32`` replica (8 hosts, 8 pods) on a v5e-32 pool, the port's
  with ``GPU: h100-8`` (8 GPUs, 8 pods) on one 8-GPU node. Create →
  Running; a failed pod → GangRestart and the resume env; a deleted pod →
  GangPodsVanished; a stale chief heartbeat → StallTimeout; backoffLimit
  spent → Failed; anomaly evidence → the LKG rollback, then
  maxAnomalyRollbacks spent → Failed; chief success → Succeeded and
  cleanPodPolicy. The condition histories (type, status, reason,
  message), the restart and rollback counts, the job's annotations and
  the chief's resume env are equal; only the accelerator keys differ
  (the gang-shape annotation; the trace id, minted from the cluster's
  uid counter, which the node pools advance differently).
- The legacy kinds' env is equal between the two packages: TFJob
  TF_CONFIG, PyTorchJob MASTER_ADDR/PORT/RANK/WORLD_SIZE, the MPIJob
  hostlist (worker replicas and the accelerator shorthand), MXJob's DMLC
  and PaddleJob's PADDLE env.
- The GPU pod: one ``nvidia.com/gpu``, the product selector, the gang
  label and min-member, ``KFTPU_SHARDING`` resolved over 16 GPUs, each
  pod's env read back through the port's ``TopologyContract`` and
  ``bootstrap.sharding_from_env``, the torch.distributed env consistent
  with ``KFTPU_*``, the contract the JAX package renders for v5e-32.
- Gang placement: 16 pods stay Pending on one 8-GPU node and bind 8 + 8
  on two. A TPU replica is refused at admission. (A job with
  ``schedulingPolicy`` waits for the slice scheduler's binding:
  ``tests/test_torch_sched_operator.py``.)
"""

import json

import pytest

from kubeflow_tpu_torch.api import trainingjob as TJ
from kubeflow_tpu_torch.api.topology import TopologyContract
from kubeflow_tpu_torch.cluster import fake as F
from kubeflow_tpu_torch.controllers import runtime as R
from kubeflow_tpu_torch.controllers import tpujob as OP
from kubeflow_tpu_torch.obs import trace as TT
from kubeflow_tpu_torch.runtime import bootstrap

NS, NAME, CKPT = "team", "job", "/ckpt/job"
AV = "tpu.kubeflow.org/v1alpha1"
TEMPLATE = {"spec": {"containers": [{"name": "trainer", "image": "t:1"}]}}
CHIEF, LAST = f"{NAME}-worker-0-0", f"{NAME}-worker-0-7"
# the chief's env the restart paths write
RESUME_ENV = ("KFTPU_CHECKPOINT_DIR", "KFTPU_RESUME_FROM",
              "KFTPU_RESUME_STEP", "KFTPU_REPLAY_RANGE",
              "KFTPU_COMPILE_CACHE_DIR")


def _package(which: str) -> dict:
    if which == "jax":
        from kubeflow_tpu.cluster import fake
        from kubeflow_tpu.controllers import runtime, tpujob
        from kubeflow_tpu.obs import trace
        return dict(fake=fake, runtime=runtime, op=tpujob,
                    replica=("TPU", {"tpuTopology": "v5e-32"}),
                    nodes=lambda c: c.add_tpu_slice_nodes("v5e-32"),
                    trace=trace.TRACE_ID_ANNOTATION)
    return dict(fake=F, runtime=R, op=OP,
                replica=("GPU", {"gpuTopology": "h100-8"}),
                nodes=lambda c: c.add_gpu_nodes("h100-8"),
                trace=TT.TRACE_ID_ANNOTATION)


class Run:
    """One job on one package's cluster and manager; records every
    distinct condition state the job passes through."""

    def __init__(self, which: str, run_policy: dict):
        self.pkg = p = _package(which)
        self.cluster = p["fake"].FakeCluster()
        p["nodes"](self.cluster)
        self.mgr = p["runtime"].Manager(self.cluster)
        self.mgr.add(p["op"].TrainingJobReconciler("TPUJob"))
        self.watch = self.cluster.watch(AV, "TPUJob")
        rtype, topo = p["replica"]
        self.cluster.create({
            "apiVersion": AV, "kind": "TPUJob",
            "metadata": {"name": NAME, "namespace": NS},
            "spec": {"checkpointDir": CKPT,
                     "replicaSpecs": {rtype: {**topo,
                                              "template": TEMPLATE}},
                     "runPolicy": run_policy}})
        self.history: list = []
        self.settle()

    def _drain(self) -> None:
        while (ev := self.watch.get(timeout=0)) is not None:
            state = sorted(
                (c["type"], c["status"], c["reason"], c["message"])
                for c in ev.obj.get("status", {}).get("conditions", []))
            if state and (not self.history or self.history[-1] != state):
                self.history.append(state)

    def settle(self) -> None:
        for _ in range(3):
            self.mgr.run_pending()
            self._drain()
            self.cluster.tick()
            self.mgr.run_pending()
            self._drain()

    def job(self) -> dict:
        return self.cluster.get(AV, "TPUJob", NS, NAME)

    def annotations(self) -> dict:
        anns = dict(self.job()["metadata"].get("annotations", {}))
        anns.pop(self.pkg["trace"])
        anns.pop(self.pkg["op"].GANG_SHAPE_ANNOTATION)
        return anns

    def pods(self) -> dict:
        return {p["metadata"]["name"]: p.get("status", {}).get("phase")
                for p in self.cluster.list("v1", "Pod", NS)}

    def env(self, pod: str) -> dict:
        obj = self.cluster.get("v1", "Pod", NS, pod)
        return {e["name"]: e["value"]
                for e in obj["spec"]["containers"][0]["env"]}

    def heartbeat(self, step: int, age_s: float = 0.0) -> None:
        import time
        self.cluster.patch("v1", "Pod", NS, CHIEF, {"metadata": {
            "annotations": {TJ.HEARTBEAT_ANNOTATION: json.dumps(
                {"step": step, "time": time.time() - age_s})}}})

    def anomaly(self, pod: str, step: int, lkg: int) -> None:
        self.cluster.patch("v1", "Pod", NS, pod, {"metadata": {
            "annotations": {TJ.ANOMALY_ANNOTATION: json.dumps(
                {"kind": "nan-loss", "step": step, "value": "nan",
                 "lkg": lkg, "detail": {}})}}})
        self.cluster.fail_pod(NS, pod, "sentinel: nan-loss")


STALL_S = 30


def _create(r):
    pass


def _pod_fail(r):
    r.cluster.fail_pod(NS, LAST, "worker died")


def _pod_delete(r):
    r.cluster.delete("v1", "Pod", NS, LAST)


def _stale_heartbeat(r):
    r.heartbeat(3)
    r.settle()
    r.heartbeat(3, age_s=STALL_S + 5)


def _backoff(r):
    r.cluster.fail_pod(NS, LAST, "worker died")
    r.settle()
    r.cluster.fail_pod(NS, CHIEF, "worker died again")


def _anomaly(r):
    r.anomaly(LAST, step=6, lkg=4)
    r.settle()
    r.anomaly(CHIEF, step=6, lkg=4)


def _success(r):
    r.cluster.fail_pod(NS, LAST, "worker exits nonzero at shutdown")
    r.cluster.set_pod_phase(NS, CHIEF, "Succeeded")


SCENARIOS = {
    # name: (run policy, action, the chief's last Restarting reason or
    # the terminal condition the job ends in)
    "create": ({}, _create, ("Running", "JobRunning")),
    "pod-fail": ({}, _pod_fail, ("Restarting", "GangRestart")),
    "pod-delete": ({}, _pod_delete, ("Restarting", "GangPodsVanished")),
    "stale-heartbeat": ({"stallTimeoutSeconds": STALL_S},
                        _stale_heartbeat, ("Restarting", "StallTimeout")),
    "backoff": ({"backoffLimit": 1}, _backoff,
                ("Failed", "BackoffLimitExceeded")),
    "anomaly": ({"maxAnomalyRollbacks": 1}, _anomaly,
                ("Failed", "AnomalyBudgetExceeded")),
    "success": ({"cleanPodPolicy": "Running"}, _success,
                ("Succeeded", "JobSucceeded")),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_scenario_matches_the_jax_reconciler(scenario):
    policy, action, (ctype, reason) = SCENARIOS[scenario]
    runs = {}
    for which in ("jax", "port"):
        r = Run(which, policy)
        action(r)
        r.settle()
        runs[which] = r
    jax, port = runs["jax"], runs["port"]
    assert port.history == jax.history
    assert (ctype, "True", reason) in {
        s[:3] for state in port.history for s in state}
    assert port.annotations() == jax.annotations()
    assert port.pods() == jax.pods()
    if CHIEF in port.pods():
        assert {k: v for k, v in port.env(CHIEF).items() if k in RESUME_ENV} \
            == {k: v for k, v in jax.env(CHIEF).items() if k in RESUME_ENV}
    anns = port.annotations()
    counts = (anns.get(OP.RESTART_COUNT_ANNOTATION),
              anns.get(TJ.ANOMALY_COUNT_ANNOTATION))
    assert counts == {"create": (None, None), "pod-fail": ("1", None),
                      "pod-delete": ("1", None),
                      "stale-heartbeat": ("1", None),
                      "backoff": ("1", None), "anomaly": (None, "1"),
                      "success": (None, None)}[scenario]
    shape = port.job()["metadata"]["annotations"][OP.GANG_SHAPE_ANNOTATION]
    assert shape == "GPU:h100-8x1"
    if scenario in ("pod-fail", "pod-delete", "stale-heartbeat"):
        assert port.env(CHIEF)["KFTPU_RESUME_FROM"] == CKPT
    if scenario == "success":
        # cleanPodPolicy Running: the finished pods stay for debugging
        assert port.pods() == {CHIEF: "Succeeded", LAST: "Failed"}


def test_anomaly_rollback_pins_the_lkg_step():
    runs = {}
    for which in ("jax", "port"):
        r = Run(which, {"maxAnomalyRollbacks": 2})
        r.anomaly(LAST, step=6, lkg=4)
        r.settle()
        runs[which] = r
    jax, port = runs["jax"], runs["port"]
    assert port.history == jax.history
    assert port.env(CHIEF)["KFTPU_RESUME_STEP"] == "4"
    directive = json.loads(port.annotations()[TJ.ANOMALY_ROLLBACK_ANNOTATION])
    assert directive == {"lkgStep": 4, "tripStep": 6, "kind": "nan-loss",
                         "count": 1}
    assert port.annotations() == jax.annotations()


def _legacy_job(kind: str, which: str) -> dict:
    accel = {"jax": {"tpuTopology": "v5e-32"},
             "port": {"gpuTopology": "h100-8"}}[which]
    rs = lambda n: {"replicas": n, "template": TEMPLATE}  # noqa: E731
    av = TJ.API_VERSIONS[kind.split("-")[0]]
    spec = {
        "TFJob": {"tfReplicaSpecs": {"Chief": rs(1), "Worker": rs(2),
                                     "PS": rs(1)}},
        "PyTorchJob": {"pytorchReplicaSpecs": {"Master": rs(1),
                                               "Worker": rs(3)}},
        "MPIJob": {"replicas": 3, "template": TEMPLATE},
        "MPIJob-accel": {**accel, "template": TEMPLATE},
        "MXJob": {"mxReplicaSpecs": {"Scheduler": rs(1), "Server": rs(2),
                                     "Worker": rs(2)}},
        "PaddleJob": {"paddleReplicaSpecs": {"Pserver": rs(2),
                                             "Trainer": rs(3)}},
    }[kind]
    return {"apiVersion": av, "kind": kind.split("-")[0],
            "metadata": {"name": NAME, "namespace": NS}, "spec": spec}


LEGACY_ENV = ("TF_CONFIG", "MASTER_ADDR", "MASTER_PORT", "RANK",
              "WORLD_SIZE", "KFTPU_MPI_HOSTS", "KFTPU_MPI_NUM_HOSTS",
              "DMLC_PS_ROOT_URI", "DMLC_PS_ROOT_PORT", "DMLC_ROLE",
              "DMLC_NUM_SERVER", "DMLC_NUM_WORKER", "PADDLE_PSERVERS",
              "PADDLE_PSERVER_PORT", "PADDLE_TRAINERS",
              "PADDLE_TRAINING_ROLE", "PADDLE_TRAINER_ID")


@pytest.mark.parametrize("kind", ["TFJob", "PyTorchJob", "MPIJob",
                                  "MPIJob-accel", "MXJob", "PaddleJob"])
def test_legacy_kinds_render_the_jax_packages_env(kind):
    # the accelerator pods' own torch env is the GPU contract's (tested
    # below); the legacy contract on them is the hostlist
    keys = LEGACY_ENV if kind != "MPIJob-accel" else \
        ("KFTPU_MPI_HOSTS", "KFTPU_MPI_NUM_HOSTS")
    envs = {}
    for which in ("jax", "port"):
        p = _package(which)
        cluster = p["fake"].FakeCluster()
        mgr = p["runtime"].Manager(cluster)
        mgr.add(p["op"].TrainingJobReconciler(kind.split("-")[0]))
        cluster.create(_legacy_job(kind, which))
        mgr.run_pending()
        envs[which] = {
            pod["metadata"]["name"]: {
                e["name"]: e["value"]
                for e in pod["spec"]["containers"][0]["env"]
                if e["name"] in keys}
            for pod in cluster.list("v1", "Pod", NS)}
    assert envs["port"] and envs["port"] == envs["jax"]
    if kind == "MPIJob-accel":
        hosts = envs["port"][CHIEF]["KFTPU_MPI_HOSTS"].split(",")
        assert len(hosts) == 8 and hosts[0].startswith(CHIEF + ".")


def _gpu_gang(nodes: int, sharding: dict = None) -> tuple:
    cluster = F.FakeCluster()
    for n in range(nodes):
        cluster.add_gpu_nodes("h100-8", pool=f"pool-{n}")
    mgr = R.Manager(cluster)
    mgr.add(OP.TrainingJobReconciler("TPUJob"))
    cluster.create({
        "apiVersion": AV, "kind": "TPUJob",
        "metadata": {"name": NAME, "namespace": NS},
        "spec": {"replicaSpecs": {"GPU": {"gpuTopology": "h100-8",
                                          "numSlices": 2,
                                          "template": TEMPLATE}},
                 "sharding": sharding or {}}})
    mgr.run_pending()
    return cluster, mgr


def test_gpu_pods_carry_the_contract_and_the_torch_env():
    from kubeflow_tpu.api.topology import parse_topology, render_contracts
    cluster, _ = _gpu_gang(2, sharding={"fsdp": 8})
    pods = cluster.list("v1", "Pod", NS)
    assert len(pods) == 16
    jax_env = {f"{NAME}-worker-{c.slice_id}-{c.process_id % 8}": c.to_env()
               for c in render_contracts(NAME, NS, parse_topology("v5e-32"),
                                         num_slices=2)}
    seen = set()
    for pod in pods:
        name = pod["metadata"]["name"]
        (c,) = pod["spec"]["containers"]
        assert c["resources"]["limits"] == {"nvidia.com/gpu": 1}
        assert pod["spec"]["nodeSelector"] == {
            "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}
        assert pod["metadata"]["labels"][F.POD_GROUP_LABEL] == f"{NS}.{NAME}"
        assert pod["metadata"]["annotations"][
            "scheduling.kubeflow.org/min-member"] == "16"
        env = {e["name"]: e["value"] for e in c["env"]}
        contract = TopologyContract.from_env(env)
        assert contract.num_devices == 16 and contract.topology == "h100-8"
        assert name == (f"{NAME}-worker-{contract.slice_id}-"
                        f"{contract.process_id % 8}")
        assert contract.process_id == 8 * contract.slice_id + \
            int(name.rsplit("-", 1)[1])
        seen.add(contract.process_id)
        assert bootstrap.sharding_from_env(env).resolve(16) == \
            json.loads(env["KFTPU_SHARDING"]) == \
            {"data": 2, "fsdp": 8, "expert": 1, "pipeline": 1,
             "sequence": 1, "tensor": 1}
        assert f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}" == \
            env["KFTPU_COORDINATOR_ADDRESS"]
        assert env["RANK"] == env["KFTPU_PROCESS_ID"]
        assert env["WORLD_SIZE"] == env["KFTPU_NUM_PROCESSES"] == "16"
        assert "LOCAL_RANK" not in env
        assert {k: v for k, v in env.items() if k in jax_env[name]
                and k != "KFTPU_TOPOLOGY"} == \
            {k: v for k, v in jax_env[name].items() if k != "KFTPU_TOPOLOGY"}
    assert seen == set(range(16))


def test_a_16_gpu_gang_binds_all_or_nothing():
    cluster, mgr = _gpu_gang(1)
    for _ in range(2):
        cluster.tick()
        mgr.run_pending()
    pods = cluster.list("v1", "Pod", NS)
    assert len(pods) == 16
    assert all(not p["spec"].get("nodeName") for p in pods)
    cluster.add_gpu_nodes("h100-8", pool="pool-1")
    cluster.tick()
    by_node: dict = {}
    for p in cluster.list("v1", "Pod", NS):
        by_node.setdefault(p["spec"]["nodeName"], []).append(
            p["metadata"]["name"])
    assert sorted(len(v) for v in by_node.values()) == [8, 8]
    assert sorted(by_node) == ["pool-0-h100-8-0", "pool-1-h100-8-0"]


@pytest.mark.parametrize("spec", [
    {"replicaSpecs": {"TPU": {"tpuTopology": "v5e-8"}}},
    {"replicaSpecs": {"GPU": {"tpuTopology": "v5e-8"}}},
    {"replicaSpecs": {"GPU": {"gpuTopology": "v5e-8"}}},
    {"replicaSpecs": {"GPU": {}}}])
def test_a_tpu_replica_is_refused_naming_gpu(spec):
    with pytest.raises(ValueError, match="GPU|h100-N"):
        TJ.TrainingJob.from_manifest({
            "apiVersion": AV, "kind": "TPUJob",
            "metadata": {"name": NAME, "namespace": NS}, "spec": spec})
    with pytest.raises(ValueError, match="gpuTopology"):
        TJ.TrainingJob.from_manifest({
            "apiVersion": TJ.API_VERSIONS["MPIJob"], "kind": "MPIJob",
            "metadata": {"name": NAME, "namespace": NS},
            "spec": {"tpuTopology": "v5e-8"}})


def test_gpu_manifest_round_trips():
    job = TJ.TrainingJob.from_manifest({
        "apiVersion": TJ.API_VERSIONS["MPIJob"], "kind": "MPIJob",
        "metadata": {"name": NAME, "namespace": NS},
        "spec": {"gpuTopology": "h100-4", "numSlices": 2}})
    gpu = job.gpu_spec
    assert (gpu.topology.name, gpu.num_slices, gpu.pod_count) == \
        ("h100-4", 2, 8)
    back = TJ.TrainingJob.from_manifest(job.to_manifest())
    assert back.gpu_spec.to_dict() == gpu.to_dict()
    assert gpu.to_dict()["gpuTopology"] == "h100-4"
