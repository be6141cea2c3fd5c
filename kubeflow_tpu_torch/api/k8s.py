"""Lightweight Kubernetes object model.

The port's copy of ``kubeflow_tpu/api/k8s.py``, verbatim below this
docstring: the operator loop manipulates manifests as plain dicts, with
typed helpers on top. This module is the one place that knows manifest
structure: GVK access, metadata, labels/selectors, owner references, and
conditions. Stdlib only.
"""

from __future__ import annotations

import copy
import re
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

GROUP = "kubeflow.org"
TPU_GROUP = "tpu.kubeflow.org"

# Kinds that are not namespaced (shared by every KubeClient implementation).
CLUSTER_SCOPED_KINDS = {
    "Namespace", "Node", "CustomResourceDefinition", "ClusterRole",
    "ClusterRoleBinding", "MutatingWebhookConfiguration",
    "ValidatingWebhookConfiguration", "PersistentVolume", "Profile",
}

# ---------------------------------------------------------------------------
# GVK / naming helpers
# ---------------------------------------------------------------------------


def snapshot(obj) -> str:
    """Stable serialization for write-on-change guards (apply no-ops,
    status-update no-ops). One definition so the two layers never diverge."""
    import json
    return json.dumps(obj, sort_keys=True, default=str)


_QUANTITY_SUFFIXES = {
    "Ki": 2 ** 10, "Mi": 2 ** 20, "Gi": 2 ** 30, "Ti": 2 ** 40,
    "Pi": 2 ** 50, "k": 10 ** 3, "M": 10 ** 6, "G": 10 ** 9, "T": 10 ** 12,
    "m": 1e-3,  # millicores
}


def parse_quantity(value) -> float:
    """Kubernetes resource quantity → float ("8Gi", "500m", 4, "2")."""
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip()
    for suffix in sorted(_QUANTITY_SUFFIXES, key=len, reverse=True):
        if s.endswith(suffix):
            return float(s[:-len(suffix)]) * _QUANTITY_SUFFIXES[suffix]
    return float(s)


def gvk(obj: dict) -> tuple[str, str]:
    """(apiVersion, kind) of a manifest."""
    return obj.get("apiVersion", ""), obj.get("kind", "")


def name_of(obj: dict) -> str:
    return obj.get("metadata", {}).get("name", "")


def namespace_of(obj: dict, default: str = "") -> str:
    return obj.get("metadata", {}).get("namespace", default)


def key_of(obj: dict) -> tuple[str, str, str, str]:
    """Unique store key: (apiVersion, kind, namespace, name)."""
    av, kind = gvk(obj)
    return av, kind, namespace_of(obj), name_of(obj)


def set_namespace(obj: dict, namespace: str) -> dict:
    obj.setdefault("metadata", {})["namespace"] = namespace
    return obj


def labels_of(obj: dict) -> dict[str, str]:
    return obj.get("metadata", {}).get("labels", {}) or {}


def annotations_of(obj: dict) -> dict[str, str]:
    return obj.get("metadata", {}).get("annotations", {}) or {}


_DNS1123 = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")


def validate_name(name: str, max_len: int = 63) -> None:
    """RFC-1123 DNS label check (63 chars — pod hostnames and service DNS
    labels derived from this name must each fit a DNS label)."""
    if not name or len(name) > max_len or not _DNS1123.match(name):
        raise ValueError(f"invalid kubernetes object name: {name!r}")


# ---------------------------------------------------------------------------
# Label selection (the subset controllers use: matchLabels + set-based equality)
# ---------------------------------------------------------------------------


def matches_selector(obj: dict, selector: dict[str, str]) -> bool:
    """True iff every selector k=v appears in the object's labels."""
    lbl = labels_of(obj)
    return all(lbl.get(k) == v for k, v in selector.items())


def selector_from(spec_selector: Optional[dict]) -> dict[str, str]:
    """Normalize a LabelSelector ({matchLabels: ...} or flat map) to a flat map."""
    if not spec_selector:
        return {}
    if "matchLabels" in spec_selector:
        return dict(spec_selector.get("matchLabels") or {})
    return dict(spec_selector)


# ---------------------------------------------------------------------------
# Owner references (controllers set these; the fake apiserver GCs on them)
# ---------------------------------------------------------------------------


def owner_reference(owner: dict, *, controller: bool = True) -> dict:
    av, kind = gvk(owner)
    return {
        "apiVersion": av,
        "kind": kind,
        "name": name_of(owner),
        "uid": owner.get("metadata", {}).get("uid", ""),
        "controller": controller,
        "blockOwnerDeletion": True,
    }


def set_owner(obj: dict, owner: dict) -> dict:
    refs = obj.setdefault("metadata", {}).setdefault("ownerReferences", [])
    ref = owner_reference(owner)
    if not any(r.get("uid") == ref["uid"] and r.get("name") == ref["name"] for r in refs):
        refs.append(ref)
    return obj


def is_owned_by(obj: dict, owner: dict) -> bool:
    ouid = owner.get("metadata", {}).get("uid")
    for ref in obj.get("metadata", {}).get("ownerReferences", []) or []:
        if ref.get("uid") == ouid and ref.get("name") == name_of(owner):
            return True
    return False


# ---------------------------------------------------------------------------
# Conditions (the status idiom every reconciler uses, reference:
# notebook_types.go conditions, application_types.go:142-157 KfDefCondition)
# ---------------------------------------------------------------------------


@dataclass
class Condition:
    type: str
    status: str  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: float = field(default_factory=time.time)

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "status": self.status,
            "reason": self.reason,
            "message": self.message,
            "lastTransitionTime": self.last_transition_time,
        }


def set_condition(obj: dict, cond: Condition) -> None:
    """Upsert a condition by type; preserves transition time if status unchanged.
    Does not mutate the passed Condition."""
    conds = obj.setdefault("status", {}).setdefault("conditions", [])
    d = cond.to_dict()
    for existing in conds:
        if existing.get("type") == cond.type:
            if existing.get("status") == cond.status:
                d["lastTransitionTime"] = existing.get(
                    "lastTransitionTime", d["lastTransitionTime"])
            existing.update(d)
            return
    conds.append(d)


def get_condition(obj: dict, ctype: str) -> Optional[dict]:
    for c in obj.get("status", {}).get("conditions", []) or []:
        if c.get("type") == ctype:
            return c
    return None


def condition_true(obj: dict, ctype: str) -> bool:
    c = get_condition(obj, ctype)
    return bool(c and c.get("status") == "True")


# ---------------------------------------------------------------------------
# Manifest constructors used across the manifest registry
# ---------------------------------------------------------------------------


def make(api_version: str, kind: str, name: str, namespace: str = "",
         labels: Optional[dict] = None, spec: Optional[dict] = None) -> dict:
    meta: dict[str, Any] = {"name": name}
    if namespace:
        meta["namespace"] = namespace
    if labels:
        meta["labels"] = dict(labels)
    obj: dict[str, Any] = {"apiVersion": api_version, "kind": kind, "metadata": meta}
    if spec is not None:
        obj["spec"] = spec
    return obj


def deep_merge(base: dict, overlay: dict) -> dict:
    """Strategic-merge-lite: dicts merge recursively, everything else replaces.

    The analog of the reference's kustomize overlay merge
    (bootstrap/v2/pkg/kfapp/kustomize/kustomize.go MergeKustomization).
    """
    out = copy.deepcopy(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def walk_strings(obj: Any, fn: Callable[[str], str]) -> Any:
    """Apply fn to every string leaf (param substitution in manifests)."""
    if isinstance(obj, str):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: walk_strings(v, fn) for k, v in obj.items()}
    if isinstance(obj, list):
        return [walk_strings(v, fn) for v in obj]
    return obj


def substitute_params(obj: Any, params: dict[str, Any]) -> Any:
    """Replace ``$(name)`` placeholders with param values, preserving type when
    a string is exactly one placeholder (so replica counts stay ints)."""
    def sub(s: str) -> Any:
        m = re.fullmatch(r"\$\(([\w.-]+)\)", s)
        if m and m.group(1) in params:
            return params[m.group(1)]
        return re.sub(
            r"\$\(([\w.-]+)\)",
            lambda mm: str(params.get(mm.group(1), mm.group(0))),
            s,
        )
    return walk_strings(obj, sub)


def sort_for_apply(objs: Iterable[dict]) -> list[dict]:
    """Dependency-ordered apply: namespaces and CRDs first, webhooks last.

    Mirrors the reference's apply ordering concerns (ksonnet.go applies
    namespace before components; kustomize.go deployResources).
    """
    order = {
        "Namespace": 0,
        "CustomResourceDefinition": 1,
        "ServiceAccount": 2,
        "ClusterRole": 3,
        "Role": 3,
        "ClusterRoleBinding": 4,
        "RoleBinding": 4,
        "ConfigMap": 5,
        "Secret": 5,
        "Service": 6,
        "PersistentVolume": 6,
        "PersistentVolumeClaim": 7,
        "Deployment": 8,
        "StatefulSet": 8,
        "DaemonSet": 8,
        "Job": 9,
        "CronJob": 9,
        "MutatingWebhookConfiguration": 20,
        "ValidatingWebhookConfiguration": 20,
    }
    return sorted(objs, key=lambda o: (order.get(o.get("kind", ""), 10), name_of(o)))
