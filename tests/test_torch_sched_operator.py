"""The port's slice scheduler and training-job reconciler against the JAX
pair (``kubeflow_tpu/scheduler/core.py`` ``SliceScheduler`` with
``kubeflow_tpu/controllers/tpujob.py`` on their own ``FakeCluster``).

Each scenario runs through both pairs, the JAX one with ``TPU: v5e-8``
jobs on ``v5e-8`` pools (two hosts of four chips), the port's with
``GPU: h100-8`` jobs on one ``h100-8`` node a pool, each package on its
own ``FakeClock`` (``test_torch_sched_soak.SCHED_CLOCKED``; ``settle``
moves it a second a round, so restart backoffs and resize times read the
same in both):

- a job waits Queued (AwaitingBinding, no pods) while no scheduler runs,
  then binds and runs; a second job waits Queued for capacity until the
  first succeeds;
- a preemptible job with a checkpoint dir is preempted by a
  higher-priority one: torn down, Queued (Preempted), ``resumeFrom`` set;
  it re-binds once the winner succeeds and its chief resumes;
- an elastic job (minChips 4) loses half of its capacity (the JAX
  package deletes host 1; the port's device plugin reports 4 of 8 GPUs
  and the pods on the lost ones fail), re-binds degraded at 4, and grows
  back to 8 when the capacity returns;
- a crash on pool-a quarantines the node it ran on (health threshold
  0.9) and the gang is evacuated to pool-b within one rebind;
- with ``warmPods: 1`` the idle pool's first host is warmed, and a job
  bound over it adopts the slot.

The jobs' condition histories (type, status, reason, message), their
annotations and the chiefs' resume env are equal; the accelerator keys
are left out (the gang shape, the binding's topology and rects, the
suspect node's name, the trace id minted from the cluster's uid counter,
the pod counts and pod lists in condition messages), and the pod counts
are each package's own (a ``v5e-8`` gang is two pods,
an ``h100-8`` gang eight; one warm pod a host against one a GPU).
"""

import importlib
import json
import re

import pytest

from test_torch_chaos_soak import use_fake_clock
from test_torch_sched_soak import SCHED_CLOCKED

NS, AV = "team", "tpu.kubeflow.org/v1alpha1"
CKPT = "/ckpt"
TEMPLATE = {"spec": {"containers": [{"name": "trainer", "image": "t:1"}]}}


@pytest.fixture(autouse=True)
def fake_clocks(monkeypatch):
    use_fake_clock(monkeypatch, SCHED_CLOCKED)


def _gang(message: str) -> str:
    """A condition message less its pod count and pod list (a gang of 2
    TPU hosts against 8 GPUs)."""
    return re.sub(r"pods \[[^\]]*\]", "pods [...]",
                  re.sub(r"\d+ pods", "N pods", message))


class Pair:
    """One package's cluster, slice scheduler and reconciler; records the
    distinct condition states of every job."""

    def __init__(self, which: str, pools=("pool-a",), config=None,
                 health=None, scheduler=True):
        pkg = "kubeflow_tpu" if which == "jax" else "kubeflow_tpu_torch"
        mod = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
        self.which, self.mod = which, mod
        self.cluster = mod("cluster.fake").FakeCluster()
        for pool in pools:
            if which == "jax":
                self.cluster.add_tpu_slice_nodes("v5e-8", pool=pool)
            else:
                self.cluster.add_gpu_nodes("h100-8", pool=pool)
        # ``config``: SchedulerConfig's fields, ``health``: HealthConfig's,
        # as both packages name them
        queue, health_mod = mod("scheduler.queue"), mod("scheduler.health")
        self.config = queue.SchedulerConfig(
            health=health_mod.HealthConfig(**(health or {})),
            **(config or {}))
        self.mgr = mod("controllers.runtime").Manager(self.cluster)
        if scheduler:
            self.add_scheduler()
        self.mgr.add(mod("controllers.tpujob").TrainingJobReconciler(
            "TPUJob"))
        self.watch = self.cluster.watch(AV, "TPUJob")
        self.history: dict = {}

    def add_scheduler(self) -> None:
        self.mgr.add(self.mod("scheduler.core").SliceScheduler(self.config))

    def create(self, name: str, policy: dict, ckpt: str = "",
               run_policy: dict = None) -> None:
        replica = ("TPU", {"tpuTopology": "v5e-8"}) if self.which == "jax" \
            else ("GPU", {"gpuTopology": "h100-8"})
        spec = {"schedulingPolicy": {"queue": "research", **policy},
                "replicaSpecs": {replica[0]: {**replica[1],
                                              "template": TEMPLATE}},
                "runPolicy": {"backoffLimit": 3, **(run_policy or {})}}
        if ckpt:
            spec["checkpointDir"] = ckpt
        self.cluster.create({"apiVersion": AV, "kind": "TPUJob",
                             "metadata": {"name": name, "namespace": NS},
                             "spec": spec})

    def _drain(self) -> None:
        while (ev := self.watch.get(timeout=0)) is not None:
            name = ev.obj["metadata"]["name"]
            state = sorted(
                (c["type"], c["status"], c["reason"], _gang(c["message"]))
                for c in ev.obj.get("status", {}).get("conditions", []))
            h = self.history.setdefault(name, [])
            if state and (not h or h[-1] != state):
                h.append(state)

    def settle(self, rounds: int = 4) -> None:
        clock = self.mod("controllers.runtime").time
        for _ in range(rounds):
            self.mgr.run_pending()
            self._drain()
            self.cluster.tick()
            self.mgr.run_pending()
            self._drain()
            clock.sleep(1.0)

    def job(self, name: str) -> dict:
        return self.cluster.get(AV, "TPUJob", NS, name)

    def annotations(self, name: str) -> dict:
        """The job's annotations less the accelerator's: the binding keeps
        its slice count, GPU/chip count and warm hosts."""
        anns = dict(self.job(name)["metadata"].get("annotations", {}))
        anns.pop(self.mod("obs.trace").TRACE_ID_ANNOTATION)
        anns.pop(self.mod("controllers.tpujob").GANG_SHAPE_ANNOTATION, None)
        anns.pop("scheduling.kubeflow.org/suspect-host", None)
        raw = anns.pop("scheduling.kubeflow.org/binding", None)
        if raw:
            b = json.loads(raw)
            anns["binding"] = {k: b.get(k) for k in ("numSlices", "chips",
                                                     "warmHosts")}
        return anns

    def pods(self, name: str) -> list:
        return [p for p in self.cluster.list("v1", "Pod", NS)
                if p["metadata"]["labels"].get(
                    "kubeflow.org/job-name") == name]

    def running(self, name: str) -> int:
        return sum(p.get("status", {}).get("phase") == "Running"
                   for p in self.pods(name))

    def chief_env(self, name: str) -> dict:
        pod = self.cluster.get("v1", "Pod", NS, f"{name}-worker-0-0")
        return {e["name"]: e["value"]
                for e in pod["spec"]["containers"][0]["env"]}

    def succeed(self, name: str) -> None:
        self.cluster.set_pod_phase(NS, f"{name}-worker-0-0", "Succeeded")


def both(**kw) -> tuple:
    return Pair("jax", **kw), Pair("port", **kw)


def same(jax: Pair, port: Pair, *jobs) -> None:
    for name in jobs:
        assert port.history[name] == jax.history[name], name
        assert port.annotations(name) == jax.annotations(name), name


GANG = {"jax": 2, "port": 8}


def test_a_job_is_queued_until_the_scheduler_binds_it():
    pairs = both(scheduler=False)
    for p in pairs:
        p.create("first", {"priority": 0})
        p.settle()
        # no scheduler: Queued, nothing created
        (cond,) = p.job("first")["status"]["conditions"]
        assert (cond["type"], cond["status"], cond["reason"]) == \
            ("Queued", "True", "AwaitingBinding")
        assert p.pods("first") == []
        p.add_scheduler()
        p.settle()
        assert p.running("first") == GANG[p.which]
        p.create("second", {"priority": 0})
        p.settle()
        assert p.pods("second") == []
        p.succeed("first")
        p.settle()
        assert p.running("second") == GANG[p.which]
    jax, port = pairs
    same(jax, port, "first", "second")
    states = [{(t, s, r) for t, s, r, _m in st}
              for st in port.history["second"]]
    assert ("Queued", "True", "AwaitingBinding") in states[0]
    assert any(("Queued", "False", "Bound") in st and
               ("Running", "True", "JobRunning") in st for st in states)
    anns = port.annotations("second")
    assert anns["scheduling.kubeflow.org/state"] == "bound"
    # the bound gang's pods: the product selector, the pool and the node
    # of the binding's row, the run as the slice annotation, the queue env
    pod = port.cluster.get("v1", "Pod", NS, "second-worker-0-3")
    assert pod["spec"]["nodeSelector"] == {
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
        "kubeflow.org/pool": "pool-a",
        "kubernetes.io/hostname": "pool-a-h100-8-0"}
    assert json.loads(pod["metadata"]["annotations"][
        "scheduling.kubeflow.org/slice"]) == \
        {"pool": "pool-a", "x": 0, "y": 0, "h": 1, "w": 8}
    env = port.chief_env("second")
    assert (env["KFTPU_SCHED_QUEUE"], env["KFTPU_SCHED_PRIORITY"],
            env["KFTPU_SCHED_PREEMPTIBLE"]) == ("research", "0", "0")


def test_a_preempted_job_is_torn_down_and_resumes_on_rebind():
    pairs = both()
    for p in pairs:
        p.create("victim", {"priority": 0, "preemptible": True},
                 ckpt=CKPT)
        p.settle()
        assert p.running("victim") == GANG[p.which]
        p.create("winner", {"priority": 10})
        p.settle()
        assert p.pods("victim") == []
        assert p.running("winner") == GANG[p.which]
        assert p.job("victim")["spec"]["resumeFrom"] == CKPT
        p.succeed("winner")
        p.settle()
        assert p.running("victim") == GANG[p.which]
    jax, port = pairs
    same(jax, port, "victim", "winner")
    assert port.annotations("victim")[
        "scheduling.kubeflow.org/preempted-count"] == "1"
    assert any(("Queued", "True", "Preempted") in {s[:3] for s in st}
               for st in port.history["victim"])
    keys = ("KFTPU_CHECKPOINT_DIR", "KFTPU_RESUME_FROM")
    assert {k: port.chief_env("victim")[k] for k in keys} == \
        {k: jax.chief_env("victim")[k] for k in keys} == \
        {k: CKPT for k in keys}


def test_an_elastic_job_shrinks_on_lost_capacity_and_grows_back():
    pairs = both(config={"grow_cooldown_s": 0.0})
    for p in pairs:
        chaos = p.mod("cluster.chaos")
        p.create("el", {"priority": 0, "minChips": 4, "maxChips": 8},
                 ckpt=CKPT)
        p.settle()
        if p.which == "jax":
            fault = chaos.CapacityLoss(node="pool-a-v5e-8-1")
            fault.fire(p.cluster)
        else:
            fault = chaos.CapacityLoss(node="pool-a-h100-8-0")
            assert fault.fire(p.cluster, NS) == [
                f"el-worker-0-{g}" for g in range(4, 8)]
        p.settle()
        assert p.running("el") == GANG[p.which] // 2
        assert p.chief_env("el")["KFTPU_TOPOLOGY"] == \
            {"jax": "v5e-4", "port": "h100-4"}[p.which]
        fault.restore(p.cluster)
        p.settle()
        assert p.running("el") == GANG[p.which]
    jax, port = pairs
    same(jax, port, "el")
    history = json.loads(port.annotations("el")[
        "scheduling.kubeflow.org/resize-history"])
    assert [(h["fromChips"], h["toChips"]) for h in history] == \
        [(8, 4), (4, 8)]
    reasons = {s[2] for st in port.history["el"] for s in st
               if s[:2] == ("Restarting", "True")}
    assert reasons == {"GangResized"}
    assert port.chief_env("el")["KFTPU_RESUME_FROM"] == CKPT


def test_a_flaky_node_is_quarantined_and_the_gang_evacuated():
    pairs = both(pools=("pool-a", "pool-b"), health={
        "quarantine_threshold": 0.9, "release_threshold": 0.5,
        "quarantine_s": 300.0})
    flaky = {"jax": "pool-a-v5e-8-1", "port": "pool-a-h100-8-0"}
    for p in pairs:
        p.create("job", {"priority": 0}, ckpt=CKPT)
        p.settle()
        victim = p.cluster.get("v1", "Pod", NS, "job-worker-0-1")
        assert victim["spec"]["nodeName"] == flaky[p.which]
        p.cluster.fail_pod(NS, "job-worker-0-1", "flaky")
        p.settle()
        assert p.running("job") == GANG[p.which]
        assert {pod["spec"]["nodeSelector"]["kubeflow.org/pool"]
                for pod in p.pods("job")} == {"pool-b"}
        node = p.cluster.get("v1", "Node", "", flaky[p.which])
        assert json.loads(node["metadata"]["annotations"][
            "kubeflow.org/quarantine"])["cordoned"] is True
        assert node["spec"]["unschedulable"] is True
    jax, port = pairs
    same(jax, port, "job")
    assert port.annotations("job")[
        "kubeflow.org/gang-restart-count"] == "1"


def test_a_job_bound_over_a_warm_slot_adopts_it():
    pairs = both(pools=("pool-a", "pool-b"), config={"warm_pods": 1})
    warm_ns = "kubeflow"
    slots = {}
    for p in pairs:
        wp = p.mod("scheduler.warmpool")
        # a node event runs a scheduling pass with no job yet
        node = p.cluster.list("v1", "Node")[0]["metadata"]["name"]
        p.cluster.patch("v1", "Node", "", node,
                        {"metadata": {"labels": {"team": "ml"}}})
        p.settle()
        warm = wp.list_warm_pods(p.cluster)
        assert len(warm) == {"jax": 1, "port": 8}[p.which]
        assert {wp.slot_of(w)[:2] if p.which == "port" else
                (json.loads(w["metadata"]["annotations"][
                    wp.WARM_HOST_ANNOTATION])["pool"], 0)
                for w in warm} == {("pool-a", 0)}
        p.create("job", {"priority": 0})
        p.settle()
        assert p.running("job") == GANG[p.which]
        chief = p.cluster.get("v1", "Pod", NS, "job-worker-0-0")
        assert json.loads(chief["metadata"]["annotations"][
            wp.ADOPTED_ANNOTATION]) == [{"pool": "pool-a", "host": 0}]
        assert p.chief_env("job")[wp.WARM_START_ENV] == "1"
        cm = p.cluster.get("v1", "ConfigMap", warm_ns, wp.SLOTS_CONFIG_MAP)
        slots[p.which] = json.loads(cm["data"][wp.SLOTS_KEY])
    jax, port = pairs
    same(jax, port, "job")
    assert port.annotations("job")["binding"]["warmHosts"] == \
        [{"pool": "pool-a", "host": 0}]
    # the slot moved to the idle pool: one warm pod a GPU of its node
    assert slots["port"] == slots["jax"] == [{"pool": "pool-b", "host": 0}]
    pods = port.mod("scheduler.warmpool").list_warm_pods(port.cluster)
    assert sorted(p["metadata"]["name"] for p in pods) == \
        [f"warm-pool-b-h0-g{g}" for g in range(8)]
    assert all(p["spec"]["nodeName"] == "pool-b-h100-8-0" and
               p["spec"]["containers"][0]["resources"]["limits"] ==
               {"nvidia.com/gpu": 1} for p in pods)
