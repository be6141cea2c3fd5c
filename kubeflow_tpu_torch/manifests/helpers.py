"""Shared manifest constructors (the util.libsonnet / common idioms).

The port's copy of ``kubeflow_tpu/manifests/helpers.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..api import k8s

APP_LABEL = "app.kubernetes.io/name"
PART_OF = "app.kubernetes.io/part-of"


def std_labels(name: str) -> dict:
    return {APP_LABEL: name, PART_OF: "kubeflow"}


def deployment(name: str, namespace: str, image: str, *,
               args: Optional[list] = None, env: Optional[dict] = None,
               port: Optional[int] = None, replicas: int = 1,
               service_account: Optional[str] = None,
               resources: Optional[dict] = None,
               labels: Optional[dict] = None,
               pod_annotations: Optional[dict] = None) -> dict:
    lbl = {**std_labels(name), **(labels or {})}
    container: dict = {"name": name, "image": image}
    if args:
        container["args"] = list(args)
    if env:
        container["env"] = [{"name": k, "value": str(v)} for k, v in env.items()]
    if port:
        container["ports"] = [{"containerPort": port}]
    if resources:
        container["resources"] = resources
    template_meta: dict = {"labels": lbl}
    if pod_annotations:
        # pod-template annotations (prometheus.io/scrape et al. —
        # annotation-based discovery reads the POD, not the Deployment)
        template_meta["annotations"] = dict(pod_annotations)
    spec: dict = {
        "replicas": replicas,
        "selector": {"matchLabels": {APP_LABEL: name}},
        "template": {
            "metadata": template_meta,
            "spec": {"containers": [container]},
        },
    }
    if service_account:
        spec["template"]["spec"]["serviceAccountName"] = service_account
    return k8s.make("apps/v1", "Deployment", name, namespace, labels=lbl,
                    spec=spec)


def service(name: str, namespace: str, port: int, target_port: Optional[int] = None,
            selector_name: Optional[str] = None, headless: bool = False) -> dict:
    spec: dict = {
        "selector": {APP_LABEL: selector_name or name},
        "ports": [{"port": port, "targetPort": target_port or port,
                   "name": "http"}],
    }
    if headless:
        spec["clusterIP"] = "None"
    return k8s.make("v1", "Service", name, namespace,
                    labels=std_labels(name), spec=spec)


def service_account(name: str, namespace: str) -> dict:
    return k8s.make("v1", "ServiceAccount", name, namespace,
                    labels=std_labels(name))


def cluster_role(name: str, rules: Sequence[dict]) -> dict:
    obj = k8s.make("rbac.authorization.k8s.io/v1", "ClusterRole", name,
                   labels=std_labels(name))
    obj["rules"] = list(rules)
    return obj


def cluster_role_binding(name: str, role: str, sa: str, namespace: str) -> dict:
    obj = k8s.make("rbac.authorization.k8s.io/v1", "ClusterRoleBinding", name,
                   labels=std_labels(name))
    obj["roleRef"] = {"apiGroup": "rbac.authorization.k8s.io",
                      "kind": "ClusterRole", "name": role}
    obj["subjects"] = [{"kind": "ServiceAccount", "name": sa,
                        "namespace": namespace}]
    return obj


def role(name: str, namespace: str, rules: Sequence[dict]) -> dict:
    """Namespaced Role: write verbs a component needs in ONE namespace
    must not ride a ClusterRole (blast-radius minimization — the
    warm-pod pool's pod/ConfigMap writes are the motivating case)."""
    obj = k8s.make("rbac.authorization.k8s.io/v1", "Role", name, namespace,
                   labels=std_labels(name))
    obj["rules"] = list(rules)
    return obj


def role_binding(name: str, namespace: str, role_name: str,
                 sa: str, sa_namespace: str) -> dict:
    obj = k8s.make("rbac.authorization.k8s.io/v1", "RoleBinding", name,
                   namespace, labels=std_labels(name))
    obj["roleRef"] = {"apiGroup": "rbac.authorization.k8s.io",
                      "kind": "Role", "name": role_name}
    obj["subjects"] = [{"kind": "ServiceAccount", "name": sa,
                        "namespace": sa_namespace}]
    return obj


def config_map(name: str, namespace: str, data: dict) -> dict:
    obj = k8s.make("v1", "ConfigMap", name, namespace, labels=std_labels(name))
    obj["data"] = {k: str(v) for k, v in data.items()}
    return obj


def crd(plural: str, kind: str, group: str, versions: Sequence[str],
        scope: str = "Namespaced",
        schema: Optional[dict] = None) -> dict:
    obj = k8s.make("apiextensions.k8s.io/v1", "CustomResourceDefinition",
                   f"{plural}.{group}")
    obj["spec"] = {
        "group": group,
        "names": {"kind": kind, "plural": plural,
                  "singular": kind.lower(), "listKind": f"{kind}List"},
        "scope": scope,
        "versions": [
            {"name": v, "served": True, "storage": i == 0,
             **({"schema": {"openAPIV3Schema": schema}} if schema else {})}
            for i, v in enumerate(versions)
        ],
    }
    return obj


def virtual_service(name: str, namespace: str, prefix: str, svc: str,
                    port: int, gateway: str = "kubeflow-gateway") -> dict:
    """Istio route — the idiom most reference packages emit
    (e.g. tf-job-operator.libsonnet:401-446)."""
    obj = k8s.make("networking.istio.io/v1alpha3", "VirtualService", name,
                   namespace, labels=std_labels(name))
    obj["spec"] = {
        "hosts": ["*"],
        "gateways": [gateway],
        "http": [{
            "match": [{"uri": {"prefix": prefix}}],
            "rewrite": {"uri": "/"},
            "route": [{"destination": {
                "host": f"{svc}.{namespace}.svc.cluster.local",
                "port": {"number": port}}}],
        }],
    }
    return obj
