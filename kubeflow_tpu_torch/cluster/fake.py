"""In-memory apiserver + scheduler: the envtest analog.

The port's copy of ``kubeflow_tpu/cluster/fake.py`` with GPU nodes. It
models the scheduler too, because gang scheduling of a GPU slice is the
core semantic the operator must get right.

Modeled behavior:
- CRUD with uid + monotonically increasing resourceVersion, conflict detection
  on update, namespaced + cluster-scoped objects.
- Watches (queue-based), delivered synchronously on mutation.
- Owner-reference cascade deletion (background GC semantics).
- Nodes with allocatable resources, incl. the GPU extended resource
  ``nvidia.com/gpu``, the ``nvidia.com/gpu.product`` label NVIDIA's
  GPU feature discovery writes and ``kubernetes.io/hostname``
  (``add_gpu_nodes``); ``set_node_gpus`` lowers and restores a node's
  allocatable GPUs, as a device plugin does when GPUs drop off the bus.
- A scheduler that binds Pending pods to nodes; pods labeled with a pod-group
  (``scheduling.kubeflow.org/pod-group``) bind **all-or-nothing**: no pod of
  the group binds until every pod of the group fits simultaneously (the
  kube-batch PodGroup semantic tf-operator opts into via
  --enable-gang-scheduling, tf-job-operator.libsonnet:107-109,298-307).
- Deterministic time: `tick()` advances scheduling + pod phase transitions;
  tests drive transitions explicitly (`set_pod_phase`, `fail_pod`).
"""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import Optional

from ..api import k8s
from ..obs import controlplane as ctrlobs
from .client import (ADDED, AlreadyExistsError, ConflictError, DELETED,
                     KubeClient, MODIFIED, NotFoundError, Watch, WatchEvent)

POD_GROUP_LABEL = "scheduling.kubeflow.org/pod-group"
GPU_RESOURCE = "nvidia.com/gpu"
# the node label GPU feature discovery writes: the product name, spaces
# as dashes (``NVIDIA H100 80GB HBM3`` -> ``NVIDIA-H100-80GB-HBM3``)
GPU_PRODUCT_LABEL = "nvidia.com/gpu.product"

# scope table lives in the shared API layer; re-exported for compatibility
CLUSTER_SCOPED_KINDS = k8s.CLUSTER_SCOPED_KINDS


def _resources_of(pod: dict) -> dict[str, float]:
    """Sum container resource requests (limits as fallback, the
    extended-resource idiom)."""
    total: dict[str, float] = {}
    for c in pod.get("spec", {}).get("containers", []) or []:
        res = c.get("resources", {}) or {}
        req = res.get("requests") or res.get("limits") or {}
        for k, v in req.items():
            total[k] = total.get(k, 0.0) + k8s.parse_quantity(v)
    return total


class FakeCluster(KubeClient):
    def __init__(self, auto_schedule: bool = True, auto_run: bool = True):
        self._objects: dict[tuple, dict] = {}
        self._watches: list[Watch] = []
        self._uid_n = 0
        self._rv_n = 0
        self._lock = threading.RLock()
        # auto_schedule: run the scheduler inside tick(); auto_run: scheduled
        # pods transition to Running on the next tick (tests can disable both).
        self.auto_schedule = auto_schedule
        self.auto_run = auto_run
        # server-side request ledger (obs/controlplane.py): every
        # TOP-LEVEL request is accounted per (component, verb, kind);
        # internal reentry (patch reads before merging, cascade GC
        # deletes, set_pod_phase's read-modify-write) stays one request
        # — that depth guard is what lets client-side audits reconcile
        # EXACTLY against this ledger
        self.audit = ctrlobs.ServerAudit()
        self._audit_local = threading.local()

    @contextlib.contextmanager
    def _audited(self, verb: str, kind: str):
        """Account one apiserver request at the outermost entry only.
        Failures count too (the server processed the request); list
        extras (object count/bytes) are filled into the yielded dict by
        the caller on success."""
        tl = self._audit_local
        depth = getattr(tl, "depth", 0)
        tl.depth = depth + 1
        info: dict = {}
        try:
            yield info
        finally:
            tl.depth = depth
            if depth == 0:
                self.audit.record(verb, kind, **info)

    def _next_uid(self) -> str:
        self._uid_n += 1
        return f"uid-{self._uid_n}"

    def _next_rv(self) -> str:
        self._rv_n += 1
        return str(self._rv_n)

    # ------------------------------------------------------------------ CRUD

    def _key(self, obj: dict) -> tuple:
        av, kind = k8s.gvk(obj)
        ns = "" if kind in CLUSTER_SCOPED_KINDS else k8s.namespace_of(obj, "default")
        return av, kind, ns, k8s.name_of(obj)

    def create(self, obj: dict) -> dict:
        with self._audited(ctrlobs.VERB_CREATE, str(obj.get("kind", ""))), \
                self._lock:
            obj = copy.deepcopy(obj)
            key = self._key(obj)
            if not key[3]:
                raise ValueError(f"object has no name: {obj}")
            if key in self._objects:
                raise AlreadyExistsError(f"{key[1]} {key[2]}/{key[3]} already exists")
            meta = obj.setdefault("metadata", {})
            if key[1] not in CLUSTER_SCOPED_KINDS:
                meta.setdefault("namespace", "default")
            meta["uid"] = self._next_uid()
            meta["resourceVersion"] = self._next_rv()
            self._objects[key] = obj
            self._broadcast(WatchEvent(ADDED, copy.deepcopy(obj)))
            return copy.deepcopy(obj)

    def get(self, api_version: str, kind: str, namespace: str, name: str) -> dict:
        with self._audited(ctrlobs.VERB_GET, kind), self._lock:
            ns = "" if kind in CLUSTER_SCOPED_KINDS else (namespace or "default")
            obj = self._objects.get((api_version, kind, ns, name))
            if obj is None:
                raise NotFoundError(f"{kind} {ns}/{name} not found")
            return copy.deepcopy(obj)

    def list(self, api_version: str, kind: str, namespace: Optional[str] = None,
             selector: Optional[dict] = None) -> list[dict]:
        with self._audited(ctrlobs.VERB_LIST, kind) as info, self._lock:
            out = []
            for (av, k, ns, _), obj in self._objects.items():
                if av != api_version or k != kind:
                    continue
                if namespace and ns != namespace:
                    continue
                if selector and not k8s.matches_selector(obj, selector):
                    continue
                out.append(copy.deepcopy(obj))
            out.sort(key=lambda o: (k8s.namespace_of(o), k8s.name_of(o)))
            # estimated on the SORTED payload: the client estimates on
            # the same first object, so byte totals reconcile exactly
            info["objects"] = len(out)
            info["nbytes"] = ctrlobs.payload_bytes(out)
            return out

    def _store_update(self, obj: dict, *, check_rv: bool = True) -> dict:
        key = self._key(obj)
        existing = self._objects.get(key)
        if existing is None:
            raise NotFoundError(f"{key[1]} {key[2]}/{key[3]} not found")
        if check_rv:
            rv = obj.get("metadata", {}).get("resourceVersion")
            if rv is not None and rv != existing["metadata"]["resourceVersion"]:
                raise ConflictError(
                    f"{key[1]} {key[3]}: resourceVersion conflict ({rv} != "
                    f"{existing['metadata']['resourceVersion']})"
                )
        obj = copy.deepcopy(obj)
        obj.setdefault("metadata", {})["uid"] = existing["metadata"]["uid"]
        obj["metadata"]["resourceVersion"] = self._next_rv()
        self._objects[key] = obj
        self._broadcast(WatchEvent(MODIFIED, copy.deepcopy(obj)))
        return copy.deepcopy(obj)

    def update(self, obj: dict) -> dict:
        with self._audited(ctrlobs.VERB_UPDATE, str(obj.get("kind", ""))), \
                self._lock:
            return self._store_update(obj)

    def update_status(self, obj: dict) -> dict:
        """Status-subresource update: merges only .status onto the stored spec."""
        with self._audited(ctrlobs.VERB_UPDATE_STATUS,
                           str(obj.get("kind", ""))), self._lock:
            key = self._key(obj)
            existing = self._objects.get(key)
            if existing is None:
                raise NotFoundError(f"{key[1]} {key[2]}/{key[3]} not found")
            merged = copy.deepcopy(existing)
            merged["status"] = copy.deepcopy(obj.get("status", {}))
            return self._store_update(merged, check_rv=False)

    def patch(self, api_version: str, kind: str, namespace: str, name: str,
              patch: dict) -> dict:
        with self._audited(ctrlobs.VERB_PATCH, kind), self._lock:
            existing = self.get(api_version, kind, namespace, name)
            merged = k8s.deep_merge(existing, patch)
            merged["metadata"]["resourceVersion"] = \
                existing["metadata"]["resourceVersion"]
            return self._store_update(merged)

    def delete(self, api_version: str, kind: str, namespace: str, name: str,
               cascade: bool = True) -> None:
        with self._audited(ctrlobs.VERB_DELETE, kind), self._lock:
            ns = "" if kind in CLUSTER_SCOPED_KINDS else (namespace or "default")
            key = (api_version, kind, ns, name)
            obj = self._objects.pop(key, None)
            if obj is None:
                raise NotFoundError(f"{kind} {ns}/{name} not found")
            # the DELETED event carries a fresh rv (kube semantics) so
            # watch streams can measure catch-up past deletions
            obj["metadata"]["resourceVersion"] = self._next_rv()
            self._broadcast(WatchEvent(DELETED, copy.deepcopy(obj)))
            if cascade:
                self._gc(obj)

    def _gc(self, owner: dict) -> None:
        children = [o for o in self._objects.values() if k8s.is_owned_by(o, owner)]
        for child in children:
            av, kind, ns, name = self._key(child)
            try:
                self.delete(av, kind, ns, name, cascade=True)
            except NotFoundError:
                pass

    # ----------------------------------------------------------------- watch

    def watch(self, api_version: Optional[str] = None,
              kind: Optional[str] = None) -> Watch:
        with self._audited(ctrlobs.VERB_WATCH, kind or ctrlobs.KIND_ANY), \
                self._lock:
            w = Watch(api_version, kind)
            self._watches.append(w)
            return w

    def _broadcast(self, event: WatchEvent) -> None:
        self._watches = [w for w in self._watches if not w.closed]
        delivered = 0
        for w in self._watches:
            if w.matches(event.obj):
                delivered += 1
            w.deliver(event)
        # fan-out = delivered copies per broadcast event; counted even
        # at zero watchers (the broadcast happened, nobody listened)
        self.audit.record_broadcast(str(event.obj.get("kind", "")),
                                    delivered)

    # ------------------------------------------------------------- node pool

    def add_node(self, name: str, allocatable: dict[str, float],
                 labels: Optional[dict] = None) -> dict:
        node = k8s.make("v1", "Node", name, labels=labels or {})
        node["status"] = {"allocatable": dict(allocatable),
                          "conditions": [{"type": "Ready", "status": "True"}]}
        return self.create(node)

    def add_gpu_nodes(self, topology_name: str, pool: str = "gpu-pool",
                      product: Optional[str] = None) -> list[dict]:
        """Provision the node of one GPU slice (a slice is the GPUs of one
        node), ``<pool>-<topology>-0``: ``nvidia.com/gpu`` allocatable,
        the product label GPU feature discovery writes, the pool label
        and ``kubernetes.io/hostname``. ``product`` defaults to the
        generation's; a device name (``NVIDIA H100 80GB HBM3``) is
        labeled the way discovery labels it, spaces as dashes."""
        from ..api.topology import parse_topology
        topo = parse_topology(topology_name)
        label = (product or topo.generation.product).strip().replace(" ", "-")
        name = f"{pool}-{topo.name}-0"
        return [self.add_node(
            name,
            {GPU_RESOURCE: topo.num_gpus, "cpu": 96, "memory": 2 ** 40},
            labels={GPU_PRODUCT_LABEL: label, "kubeflow.org/pool": pool,
                    "kubernetes.io/hostname": name})]

    def set_node_gpus(self, name: str, gpus: int) -> dict:
        """Set a node's allocatable ``nvidia.com/gpu`` (the device plugin
        reporting fewer GPUs, or all of them again)."""
        node = self.get("v1", "Node", "", name)
        node.setdefault("status", {}).setdefault(
            "allocatable", {})[GPU_RESOURCE] = gpus
        return self.update_status(node)

    # ------------------------------------------------------------- scheduler

    def _node_free(self) -> dict[str, dict[str, float]]:
        free = {}
        for (_, kind, _, name), node in list(self._objects.items()):
            if kind != "Node":
                continue
            free[name] = {
                r: k8s.parse_quantity(v)
                for r, v in (node.get("status", {})
                             .get("allocatable", {}) or {}).items()}
        for (_, kind, _, _), pod in list(self._objects.items()):
            if kind != "Pod":
                continue
            node_name = pod.get("spec", {}).get("nodeName")
            phase = pod.get("status", {}).get("phase")
            if node_name in free and phase in (None, "Pending", "Running"):
                for r, v in _resources_of(pod).items():
                    free[node_name][r] = free[node_name].get(r, 0.0) - v
        return free

    def _fits(self, pod: dict, free: dict[str, float], node: dict) -> bool:
        # cordoned nodes take no new pods (kubectl cordon /
        # spec.unschedulable — the quarantine path relies on this to
        # keep sub-slice gang pods off a bad host within a pool)
        if node.get("spec", {}).get("unschedulable"):
            return False
        sel = pod.get("spec", {}).get("nodeSelector") or {}
        if not all(k8s.labels_of(node).get(a) == b for a, b in sel.items()):
            return False
        return all(free.get(r, 0.0) >= v for r, v in _resources_of(pod).items())

    def _try_place(self, pods: list[dict], free: dict[str, dict[str, float]]
                   ) -> Optional[dict[str, str]]:
        """First-fit placement of a pod set onto the free map; returns
        pod-name → node-name or None if the whole set does not fit."""
        placement: dict[str, str] = {}
        free = {n: dict(f) for n, f in free.items()}
        nodes = {key[3]: obj for key, obj in self._objects.items()
                 if key[1] == "Node"}
        for pod in pods:
            placed = False
            for node_name in sorted(free):
                if self._fits(pod, free[node_name], nodes[node_name]):
                    placement[k8s.name_of(pod)] = node_name
                    for r, v in _resources_of(pod).items():
                        free[node_name][r] -= v
                    placed = True
                    break
            if not placed:
                return None
        return placement

    def schedule(self) -> int:
        """One scheduler pass. Gang groups bind all-or-nothing. Returns the
        number of pods bound."""
        with self._lock:
            pending = [o for o in self._objects.values()
                       if o.get("kind") == "Pod"
                       and not o.get("spec", {}).get("nodeName")
                       and o.get("status", {}).get("phase", "Pending") == "Pending"]
            if not pending:
                return 0
            bound = 0
            free = self._node_free()
            groups: dict[str, list[dict]] = {}
            singles: list[dict] = []
            for pod in pending:
                g = k8s.labels_of(pod).get(POD_GROUP_LABEL)
                (groups.setdefault(g, []) if g else singles).append(pod)

            def bind(pod: dict, node_name: str) -> None:
                nonlocal bound
                stored = self._objects[self._key(pod)]
                stored.setdefault("spec", {})["nodeName"] = node_name
                stored.setdefault("status", {}).setdefault("phase", "Pending")
                stored["metadata"]["resourceVersion"] = self._next_rv()
                self._broadcast(WatchEvent(MODIFIED, copy.deepcopy(stored)))
                for r, v in _resources_of(pod).items():
                    free[node_name][r] = free[node_name].get(r, 0.0) - v
                bound += 1

            for g, pods in groups.items():
                # all-or-nothing: the group's min-member annotation (set by the
                # operator) must be present before any member binds
                min_member = max(
                    int(k8s.annotations_of(p).get(
                        "scheduling.kubeflow.org/min-member", len(pods)))
                    for p in pods)
                if len(pods) < min_member:
                    continue
                placement = self._try_place(pods, free)
                if placement is None:
                    continue
                for pod in pods:
                    bind(pod, placement[k8s.name_of(pod)])
            for pod in singles:
                placement = self._try_place([pod], free)
                if placement:
                    bind(pod, placement[k8s.name_of(pod)])
            return bound

    # ------------------------------------------------------- pod lifecycle

    def set_pod_phase(self, namespace: str, name: str, phase: str,
                      message: str = "") -> dict:
        pod = self.get("v1", "Pod", namespace, name)
        pod.setdefault("status", {})["phase"] = phase
        if message:
            pod["status"]["message"] = message
        return self.update(pod)

    def fail_pod(self, namespace: str, name: str, message: str = "worker died") -> dict:
        return self.set_pod_phase(namespace, name, "Failed", message)

    def tick(self) -> None:
        """Advance one scheduling/run step: schedule pending pods, then start
        bound Pending pods (if auto_run)."""
        if self.auto_schedule:
            self.schedule()
        if self.auto_run:
            with self._lock:
                to_run = [
                    (k8s.namespace_of(o, "default"), k8s.name_of(o))
                    for o in self._objects.values()
                    if o.get("kind") == "Pod"
                    and o.get("spec", {}).get("nodeName")
                    and o.get("status", {}).get("phase", "Pending") == "Pending"
                ]
            for ns, name in to_run:
                self.set_pod_phase(ns, name, "Running")
