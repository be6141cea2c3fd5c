"""The port's manifests and the slice scheduler's ConfigMap reader, held to
the JAX package's.

Every component of ``kubeflow_tpu_torch/manifests/`` renders what the
JAX package's component of the same name renders, under the stated
mapping: the accelerator replica ``TPU`` → ``GPU``, ``tpuTopology`` →
``gpuTopology`` with the pattern ``^h100-\\d+$``, a ``v5e-N`` topology →
``h100-N``, and the worker module ``kubeflow_tpu.runtime.worker`` →
``kubeflow_tpu_torch.runtime.worker``. The operator's and scheduler's
Deployments render ``--leader-elect`` and the Lease names of the port's
``cluster/lease.py``; the scheduler's ConfigMap is the port's
``SchedulerConfig``/``HealthConfig``. The CRD schema names every spec
field the port's ``TrainingJob`` parses (the port's counterpart of
``tests/test_lint.py::test_step_engine_knobs_cover_the_operator_surface``).

``SliceScheduler()`` with no config reads the ``tpu-scheduler-config``
ConfigMap each pass: the live policy, the resourceVersion cache, a
malformed ConfigMap, no ConfigMap, an explicit config — against the JAX
scheduler on the same ConfigMap.
"""

import dataclasses
import json
import logging

import pytest

from kubeflow_tpu_torch import manifests as M
from kubeflow_tpu_torch.manifests import training

TPU_AV = "tpu.kubeflow.org/v1alpha1"


def gpu_mapped(objs: list) -> list:
    """The JAX manifests under the TPU→GPU mapping."""
    s = json.dumps(objs, sort_keys=True)
    for a, b in (('"TPU"', '"GPU"'), ("tpuTopology", "gpuTopology"),
                 (json.dumps(r"^v\d+[a-z]*-\d+$"), json.dumps(r"^h100-\d+$")),
                 ('"v5e-', '"h100-'),
                 ("kubeflow_tpu.runtime.worker",
                  "kubeflow_tpu_torch.runtime.worker")):
        s = s.replace(a, b)
    return json.loads(s)


#: (component, params): every port component, and the knobs each takes
CASES = [(name, {}) for name in M.component_names()] + [
    ("tpu-job-operator", {"leader_elect": False}),
    ("tpu-job-operator", {"replicas": 3, "gang_scheduling": False,
                          "shared_cache_root": "/mnt/cache",
                          "span_max_bytes": 1 << 20}),
    ("tpu-scheduler", {"leader_elect": False}),
    ("tpu-scheduler", {"backfill": False, "preemption": False,
                       "queues": {"research": {"quotaChips": {"*": 16}}},
                       "health": {"quarantineThreshold": 2.5},
                       "grow": False, "warm_pods": 2, "replicas": 3}),
    ("tpu-job-simple", {"topology": "h100-4", "weight_update": "sharded",
                        "input_workers": 2, "device_prefetch": 2,
                        "integrity": True, "integrity_spike_z": 5.0,
                        "queue": "research", "priority": 1,
                        "preemptible": True, "min_chips": 2,
                        "max_chips": 4, "span_path": "/spans.jsonl",
                        "obs_metrics_port": 9090, "aot": True,
                        "num_slices": 2, "multislice_pipeline": True,
                        "multislice_microbatches": 4,
                        "stall_timeout_seconds": 60}),
    ("tpu-job-simple", {"fused_blocks": True,
                        "fused_routing": {"stage1": "spatial"}}),
    ("tpu-compile-cache", {"size": "10Gi", "storage_class": "fast"}),
]


@pytest.mark.parametrize("name,params", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_component_equals_the_jax_one_under_the_gpu_mapping(name, params):
    from kubeflow_tpu.manifests import build_component as jax_build
    jax_params = dict(params)
    if "topology" in jax_params:
        jax_params["topology"] = jax_params["topology"].replace("h100-",
                                                                "v5e-")
    assert M.build_component(name, params) == \
        gpu_mapped(jax_build(name, jax_params))


def test_the_registry_is_the_jax_training_package():
    from kubeflow_tpu.manifests import REGISTRY as JAX
    from kubeflow_tpu.manifests import training as jax_training
    jax_names = {n for n, c in JAX.items()
                 if c.builder.__module__ == jax_training.__name__}
    assert set(M.component_names()) == jax_names
    for name in jax_names:
        assert M.REGISTRY[name].params == gpu_mapped(JAX[name].params)
    with pytest.raises(KeyError):
        M.build_component("tpu-serving")
    with pytest.raises(ValueError, match="unknown params"):
        M.build_component("tpu-scheduler", {"chips": 8})


def test_the_deployments_run_the_leader_elected_manager():
    from kubeflow_tpu_torch.cluster.lease import (OPERATOR_LEASE,
                                                  SCHEDULER_LEASE)
    from kubeflow_tpu_torch.manifests.observability import METRICS_PORT
    for comp, lease, ctrl in (
            ("tpu-job-operator", OPERATOR_LEASE, "--controller=trainingjobs"),
            ("tpu-scheduler", SCHEDULER_LEASE, "--controllers=scheduler")):
        objs = M.build_component(comp, {"namespace": "team"})
        dep = next(o for o in objs if o["kind"] == "Deployment")
        assert dep["spec"]["replicas"] == 2
        pod = dep["spec"]["template"]
        args = pod["spec"]["containers"][0]["args"]
        assert args[:2] == [ctrl, f"--metrics-port={METRICS_PORT}"]
        assert args[-3:] == ["--leader-elect", f"--lease-name={lease}",
                             "--lease-namespace=team"]
        assert pod["metadata"]["annotations"]["prometheus.io/port"] == \
            str(METRICS_PORT)
        role = next(o for o in objs if o["kind"] == "Role"
                    and o["metadata"]["name"].endswith("-leases"))
        assert role["metadata"]["namespace"] == "team"
        assert role["rules"][0]["resources"] == ["leases"]
        single = M.build_component(comp, {"leader_elect": False})
        dep = next(o for o in single if o["kind"] == "Deployment")
        assert dep["spec"]["replicas"] == 1
        assert "--leader-elect" not in \
            dep["spec"]["template"]["spec"]["containers"][0]["args"]


def test_the_example_job_is_a_gpu_job_the_port_admits():
    from kubeflow_tpu_torch.api.trainingjob import TrainingJob
    (job,) = M.build_component("tpu-job-simple", {"topology": "h100-8"})
    tj = TrainingJob.from_manifest(job)
    tj.validate()
    assert tj.replica_specs["GPU"].topology.name == "h100-8"
    assert job["spec"]["replicaSpecs"]["GPU"]["template"]["spec"][
        "containers"][0]["command"][:3] == \
        ["python", "-m", "kubeflow_tpu_torch.runtime.worker"]


def test_the_crd_schema_names_every_spec_field_the_operator_parses():
    """Every knob the port's TrainingJob reads from a job's spec has its
    schema entry at its full path, so no operator knob bypasses the
    CRD."""
    from kubeflow_tpu_torch.api import trainingjob as T
    (crd, *_rest) = M.build_component("tpu-job-operator")
    props = crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"][
        "properties"]["spec"]["properties"]
    blocks = {"input": T.InputSpec, "observability": T.ObsSpec,
              "warmStart": T.WarmStartSpec, "multislice": T.MultisliceSpec,
              "kernels": T.KernelSpec, "integrity": T.IntegritySpec}
    for block, cls in blocks.items():
        names = [f.metadata["spec_field"] for f in dataclasses.fields(cls)]
        assert names
        for name in names:
            assert name in props[block]["properties"], (block, name)
    policy = T.SchedulingPolicy(queue="q", priority=1, preemptible=True,
                                min_chips=1, max_chips=2).to_dict()
    assert set(policy) == set(props["schedulingPolicy"]["properties"])
    for top in ("weightUpdate", "compileCacheDir"):
        assert top in props
    assert props["weightUpdate"]["enum"] == list(T.WEIGHT_UPDATE_MODES)
    assert props["kernels"]["properties"]["attention"]["enum"] == \
        list(T.ATTENTION_KERNELS)
    replica = props["replicaSpecs"]["properties"]["GPU"]["properties"]
    assert replica["gpuTopology"]["pattern"] == r"^h100-\d+$"
    assert set(props["replicaSpecs"]["properties"]) >= \
        {t for types in T.REPLICA_TYPES.values() for t in types}


# ------------------------------------------------- the ConfigMap reader


def _cm(pkg_manifests, **params) -> dict:
    return next(o for o in pkg_manifests.build_component(
        "tpu-scheduler", params) if o["kind"] == "ConfigMap")


def _pkgs():
    """(FakeCluster, SliceScheduler, manifests, node adder, job) per
    package."""
    from kubeflow_tpu import manifests as JM
    from kubeflow_tpu.cluster.fake import FakeCluster as JF
    from kubeflow_tpu.scheduler.core import SliceScheduler as JS

    from kubeflow_tpu_torch.cluster.fake import FakeCluster as PF
    from kubeflow_tpu_torch.scheduler.core import SliceScheduler as PS

    def job(accel, topo):
        return {"apiVersion": TPU_AV, "kind": "TPUJob",
                "metadata": {"name": "train", "namespace": "kubeflow"},
                "spec": {"schedulingPolicy": {"queue": "research"},
                         "replicaSpecs": {accel: {
                             "tpuTopology" if accel == "TPU"
                             else "gpuTopology": topo,
                             "template": {"spec": {"containers": [
                                 {"name": "t", "image": "t:v1"}]}}}}}}
    return [(JF, JS, JM, lambda c: c.add_tpu_slice_nodes("v5e-8"),
             job("TPU", "v5e-8")),
            (PF, PS, M, lambda c: c.add_gpu_nodes("h100-8"),
             job("GPU", "h100-8"))]


def _bound(cluster) -> bool:
    job = cluster.get(TPU_AV, "TPUJob", "kubeflow", "train")
    return "scheduling.kubeflow.org/binding" in \
        (job["metadata"].get("annotations") or {})


def test_the_configmap_policy_is_live():
    """A quota of 0 in the rendered ConfigMap keeps the job queued; the
    ConfigMap updated without it, the next pass binds — in both
    packages."""
    out = []
    for fake, sched_cls, mani, add_nodes, job in _pkgs():
        cluster = fake()
        add_nodes(cluster)
        cluster.create(_cm(mani, queues={
            "research": {"quotaChips": {"*": 0}}}))
        cluster.create(job)
        sched = sched_cls()
        sched.reconcile(cluster, ("", "#cluster-pass"))
        steps = [(_bound(cluster), sched.config.queue("research")
                  .quota_for("kubeflow"))]
        cm = cluster.get("v1", "ConfigMap", "kubeflow",
                         "tpu-scheduler-config")
        cm["data"] = _cm(mani)["data"]
        cluster.update(cm)
        sched.reconcile(cluster, ("", "#cluster-pass"))
        steps.append((_bound(cluster), sched.config.queue("research")
                      .quota_for("kubeflow")))
        out.append((steps, dataclasses.asdict(sched.config)))
    assert out[1] == out[0]
    assert out[1][0] == [(False, 0), (True, None)]


def test_an_unchanged_configmap_keeps_the_parsed_config():
    from kubeflow_tpu_torch.cluster.fake import FakeCluster
    from kubeflow_tpu_torch.scheduler.core import SliceScheduler
    cluster = FakeCluster()
    cluster.create(_cm(M, backfill=False, health={"enabled": False}))
    sched = SliceScheduler()
    sched._refresh_config(cluster)
    first = sched.config
    assert (first.backfill, first.health.enabled) == (False, False)
    sched._refresh_config(cluster)
    assert sched.config is first            # the rv cache: not re-parsed
    cm = cluster.get("v1", "ConfigMap", "kubeflow", "tpu-scheduler-config")
    cluster.update(cm)                      # a new rv, the same data
    sched._refresh_config(cluster)
    assert sched.config is not first and sched.config == first
    cluster.delete("v1", "ConfigMap", "kubeflow", "tpu-scheduler-config")
    sched._refresh_config(cluster)          # gone: the defaults
    assert sched.config.backfill and sched.config.health.enabled


@pytest.mark.parametrize("data", ["{not json", json.dumps({"health": {
    "quarantineTreshold": 1.0}}), json.dumps({"growCooldownSeconds": "x"})],
    ids=["json", "health-key", "type"])
def test_a_malformed_configmap_logs_and_falls_back_to_defaults(data,
                                                              caplog):
    from kubeflow_tpu.cluster.fake import FakeCluster as JF
    from kubeflow_tpu.scheduler.core import SliceScheduler as JS

    from kubeflow_tpu_torch.cluster.fake import FakeCluster
    from kubeflow_tpu_torch.scheduler.core import SliceScheduler
    from kubeflow_tpu_torch.scheduler.queue import SchedulerConfig
    configs = []
    for fake, cls in ((JF, JS), (FakeCluster, SliceScheduler)):
        cluster = fake()
        cm = _cm(M)
        cm["data"]["config.json"] = data
        cluster.create(cm)
        sched = cls()
        with caplog.at_level(logging.WARNING):
            sched._refresh_config(cluster)
        configs.append(dataclasses.asdict(sched.config))
    assert configs[1] == configs[0] == dataclasses.asdict(SchedulerConfig())
    assert "using defaults" in caplog.text


def test_an_explicit_config_wins_over_the_configmap():
    from kubeflow_tpu_torch.cluster.fake import FakeCluster
    from kubeflow_tpu_torch.scheduler.core import SliceScheduler
    from kubeflow_tpu_torch.scheduler.queue import SchedulerConfig
    cluster = FakeCluster()
    cluster.create(_cm(M, backfill=False))
    explicit = SchedulerConfig(warm_pods=3)
    sched = SliceScheduler(explicit)
    sched._refresh_config(cluster)
    assert sched.config is explicit and sched.config.backfill


def test_the_rendered_configmap_round_trips_through_the_config():
    from kubeflow_tpu_torch.scheduler.health import HealthConfig
    from kubeflow_tpu_torch.scheduler.queue import SchedulerConfig
    data = json.loads(_cm(M, grow_cooldown_seconds=12.0, warm_pods=1,
                          health={"halfLifeSeconds": 60})["data"][
                              "config.json"])
    cfg = SchedulerConfig.from_dict(data)
    assert (cfg.grow_cooldown_s, cfg.warm_pods,
            cfg.health.half_life_s) == (12.0, 1, 60.0)
    assert HealthConfig.from_dict(data["health"]).to_dict() == \
        data["health"]
    with pytest.raises(ValueError, match="unknown health config keys"):
        training.tpu_scheduler(health={"typo": 1})
