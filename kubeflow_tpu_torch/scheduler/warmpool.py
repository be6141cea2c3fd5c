"""Warm-pod pools: pre-initialized pods on idle nodes.

The port's copy of ``kubeflow_tpu/scheduler/warmpool.py``. Even a restart
that loads its kernels from the build cache pays pod scheduling, image
pull and CUDA context bring-up before its first step. The scheduler
therefore advertises up to ``SchedulerConfig.warm_pods`` idle NODES (free
of any binding after each planning pass) as warm slots, and keeps
pre-initialized pods on each — one warm pod a GPU, each holding one
``nvidia.com/gpu`` with the build cache mounted. A bind whose placement
covers a warm slot ADOPTS it: the binding records the covered slots
(``warmHosts`` on the Placement wire format), the operator retires the
slot's warm pods and stamps the gang's pods with the adoption annotation
+ ``KFTPU_WARM_START`` env. Preemption re-binds, elastic resizes, and
quarantine migrations all ride the same path.

This module is the CONTRACT between the two processes (the binding_of
pattern): slot wire format, warm-pod naming/labels, and the parse
helpers both sides consume. The scheduler maintains the pods
(scheduler/core.py warm pass); the operator adopts them
(controllers/tpujob.py). Stdlib only.
"""

from __future__ import annotations

import json
from typing import Optional

from ..api import k8s
from ..cluster.fake import GPU_RESOURCE
from .inventory import POOL_LABEL, Placement, SliceInventory
from . import health

# label carried by every warm pod (the operator's adoption lookup and
# kubectl's view of the pool)
WARM_POD_LABEL = "kubeflow.org/warm-pod"
# the warm pod's slot, as a JSON {"pool": p, "host": i, "gpu": g}
# annotation
WARM_HOST_ANNOTATION = "scheduling.kubeflow.org/warm-host"
# stamped on every gang pod created over an adopted slot (audit +
# dashboards); value = JSON list of adopted {"pool","host"} slots
ADOPTED_ANNOTATION = "scheduling.kubeflow.org/adopted-warm-pods"
# rendered into adopted gangs' workers: the host is pre-initialized, so
# the AOT/compile-cache rungs see a warm filesystem (informational —
# the worker's start_kind histogram still measures what actually ran)
WARM_START_ENV = "KFTPU_WARM_START"

# where warm pods and the slots ConfigMap live (the scheduler's own
# namespace — warm pods are cluster infrastructure, not job children)
WARM_POOL_NAMESPACE = "kubeflow"
SLOTS_CONFIG_MAP = "gpu-warm-pool"
SLOTS_KEY = "slots.json"


def warm_pod_name(pool: str, host: int, gpu: int) -> str:
    return f"warm-{pool}-h{host}-g{gpu}"


def slot_of(pod: dict) -> Optional[tuple]:
    """(pool, host, gpu) of a warm pod's annotation, or None when it is
    missing or malformed."""
    try:
        meta = json.loads(k8s.annotations_of(pod).get(
            WARM_HOST_ANNOTATION, "") or "{}")
        return (str(meta["pool"]), int(meta["host"]), int(meta["gpu"]))
    except (KeyError, TypeError, ValueError):
        return None


def slots_of(client) -> list[dict]:
    """Parse the advertised warm slots; [] when absent/malformed (a
    corrupt advertisement only costs warmth, never a pass)."""
    cm = client.get_or_none("v1", "ConfigMap", WARM_POOL_NAMESPACE,
                            SLOTS_CONFIG_MAP)
    if cm is None:
        return []
    try:
        slots = json.loads((cm.get("data") or {}).get(SLOTS_KEY, "") or
                           "[]")
    except ValueError:
        return []
    out = []
    for s in slots if isinstance(slots, list) else []:
        try:
            out.append({"pool": str(s["pool"]), "host": int(s["host"])})
        except (KeyError, TypeError, ValueError):
            continue   # one malformed slot must not cost the pass
    return out


def slot_cells(slots: list[dict], inventory: SliceInventory) -> set:
    """Every cell the advertised slots cover — the placement-preference
    set plan() nudges binds toward (adoption beats a cold run)."""
    cells: set = set()
    for s in slots:
        pool = inventory.pools.get(s["pool"])
        if pool is None:
            continue
        cells |= set(health.host_cells(s["pool"], pool.topology,
                                       s["host"]))
    return cells


def covered_slots(placement: Placement, slots: list[dict],
                  inventory: SliceInventory) -> list[dict]:
    """The advertised slots a placement's runs overlap — what the
    scheduler stamps into the binding's ``warmHosts`` so the operator
    knows exactly which warm pods this gang adopts."""
    placed = {c for r in placement.slices for c in r.cells()}
    out = []
    for s in slots:
        pool = inventory.pools.get(s["pool"])
        if pool is None:
            continue
        cells = set(health.host_cells(s["pool"], pool.topology,
                                      s["host"]))
        if cells & placed:
            out.append(dict(s))
    return out


def build_warm_pod(pool: str, host: int, gpu: int, topology_name: str,
                   image: str = "ghcr.io/kubeflow-tpu/worker:v0.1.0",
                   cache_dir: str = "",
                   node_name: str = "") -> dict:
    """The pre-initialized pod for one GPU of a slot: pinned to the
    slot's pool AND (when the inventory can name it) the slot's node —
    the pool selector alone would let kube park the pod on another
    node, making the advertised slot a fiction — requesting one GPU
    (the bring-up needs real device access, and a zero-resource pod
    would double-book a GPU a gang occupies), running the prewarm
    entrypoint (CUDA context up, build cache mounted), carrying the slot
    annotation the adoption path reads. With a shared cache root the
    compile-cache claim is mounted there so the prewarm touches the
    volume a landing gang will read."""
    container: dict = {
        "name": "prewarm",
        "image": image,
        "command": ["python", "-m", "kubeflow_tpu_torch.runtime.bootstrap",
                    "--prewarm"],
        "env": ([{"name": "KFTPU_COMPILE_CACHE_DIR",
                  "value": cache_dir}] if cache_dir else []),
        "resources": {"limits": {GPU_RESOURCE: 1}},
    }
    spec: dict = {
        "restartPolicy": "Never",
        "nodeSelector": {POOL_LABEL: pool},
        "containers": [container],
    }
    if node_name:
        spec["nodeName"] = node_name
    if cache_dir and "://" not in cache_dir:
        container["volumeMounts"] = [{"name": "kftpu-cache",
                                      "mountPath": cache_dir}]
        spec["volumes"] = [{"name": "kftpu-cache",
                            "persistentVolumeClaim":
                            {"claimName": "gpu-compile-cache"}}]
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {
            "name": warm_pod_name(pool, host, gpu),
            "namespace": WARM_POOL_NAMESPACE,
            "labels": {WARM_POD_LABEL: "true"},
            "annotations": {WARM_HOST_ANNOTATION: json.dumps(
                {"pool": pool, "host": host, "gpu": gpu,
                 "topology": topology_name})},
        },
        "spec": spec,
    }


def node_for_slot(inventory: SliceInventory, pool: str,
                  host: int) -> str:
    """The node name of the slot's row, or "" when the inventory cannot
    say — the warm pods then degrade to the pool selector alone."""
    return inventory.node_at.get((pool, host), "")


def list_warm_pods(client) -> list[dict]:
    return client.list("v1", "Pod", WARM_POOL_NAMESPACE,
                       selector={WARM_POD_LABEL: "true"})


def reconcile_warm_pods(client, slots: list[dict],
                        inventory: SliceInventory,
                        cache_dir: str = "",
                        keep: Optional[set] = None) -> tuple[int, int]:
    """Make the live warm pods match the advertised slots: create the
    pod of every GPU of every slot that lacks one, delete pods whose
    slot is no longer advertised (the node got bound, went down, or the
    knob shrank). ``keep`` is the set of (pool, host) slots named by a
    live binding's warmHosts — those pods are PENDING ADOPTION by the
    operator, which runs after this pass; retiring them here would race
    the adoption into a cold create. Write-on-change; returns (created,
    deleted)."""
    from ..cluster.client import NotFoundError
    keep = keep or set()
    wanted: dict[tuple, dict] = {}
    for s in slots:
        pool = inventory.pools.get(s["pool"])
        gpus = pool.topology.num_gpus if pool is not None else 0
        for g in range(gpus):
            wanted[(s["pool"], s["host"], g)] = s
    have: dict[tuple, dict] = {}
    deleted = 0
    for pod in list_warm_pods(client):
        key = slot_of(pod)
        # a DEAD prewarm (image pull crash, bring-up failure —
        # restartPolicy Never) must not satisfy its slot: retire it so
        # the create loop below brings a live one back
        dead = pod.get("status", {}).get("phase") in ("Failed",
                                                      "Succeeded")
        if not dead and key is not None and key[:2] in keep \
                and key not in wanted:
            continue   # pending adoption: the operator retires it
        if dead or key is None or key not in wanted or key in have:
            # unparseable, stale, or duplicate: retire it
            try:
                client.delete("v1", "Pod", WARM_POOL_NAMESPACE,
                              k8s.name_of(pod))
                deleted += 1
            except NotFoundError:
                pass
            continue
        have[key] = pod
    created = 0
    for key, slot in wanted.items():
        if key in have:
            continue
        pool = inventory.pools[slot["pool"]]
        client.create(build_warm_pod(
            slot["pool"], slot["host"], key[2], pool.topology.name,
            cache_dir=cache_dir,
            node_name=node_for_slot(inventory, slot["pool"],
                                    slot["host"])))
        created += 1
    return created, deleted


def write_slots(client, slots: list[dict]) -> None:
    """Persist the advertised slots (write-on-change: a steady-state
    pass writes nothing)."""
    body = json.dumps(sorted(slots, key=lambda s: (s["pool"],
                                                   s["host"])))
    cm = client.get_or_none("v1", "ConfigMap", WARM_POOL_NAMESPACE,
                            SLOTS_CONFIG_MAP)
    if cm is not None and (cm.get("data") or {}).get(SLOTS_KEY) == body:
        return
    if cm is None:
        if not slots:
            return   # feature off and never on: no empty CM litter
        obj = k8s.make("v1", "ConfigMap", SLOTS_CONFIG_MAP,
                       WARM_POOL_NAMESPACE)
        obj["data"] = {SLOTS_KEY: body}
        client.create(obj)
    else:
        client.patch("v1", "ConfigMap", WARM_POOL_NAMESPACE,
                     SLOTS_CONFIG_MAP, {"data": {SLOTS_KEY: body}})


def free_hosts(inventory: SliceInventory) -> list[dict]:
    """Nodes whose every GPU is free (no binding, not down) — the
    candidate warm slots, deterministically ordered (sorted pools,
    ascending row) so repeated passes advertise the same slots and warm
    pods never churn while the cluster is steady."""
    out = []
    for pname in sorted(inventory.pools):
        pool = inventory.pools[pname]
        for host in range(pool.rows):
            if not any(pool.grid[host]):
                out.append({"pool": pname, "host": host})
    return out
