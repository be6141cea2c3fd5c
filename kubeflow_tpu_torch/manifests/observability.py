"""The scrape contract of the platform's manifests.

The part of ``kubeflow_tpu/manifests/observability.py`` the operator and
scheduler manifests use (``manifests/training.py``): the port every
controller manager serves ``/metrics`` on and the annotation-based
Prometheus discovery keys. The monitoring stack's own manifests are not
here (ROADMAP Queue 1).
"""

from __future__ import annotations

# the controller manager's and the scheduler's /metrics port (their
# Deployments pass it as --metrics-port)
METRICS_PORT = 8080


def scrape_annotations(port: int, path: str = "/metrics") -> dict:
    """The annotation-based Prometheus discovery contract every scrape
    surface in the platform advertises (controller manager, scheduler,
    model server, probers, workers via spec.observability.metricsPort) —
    one helper so the keys cannot drift between components."""
    return {
        "prometheus.io/scrape": "true",
        "prometheus.io/port": str(port),
        "prometheus.io/path": path,
    }
