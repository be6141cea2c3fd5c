"""The manifest registry: programmatic builders replacing ksonnet.

The port's copy of ``kubeflow_tpu/manifests/``, the packages the port's
control plane runs: ``training`` (the job operator's and the slice
scheduler's manifests, the legacy-kind CRDs and example jobs), with the
shared ``helpers``, the ``registry`` and the scrape contract of
``observability``. Each package is a typed builder ``build(params) ->
[manifests]`` registered by name, under the JAX package's names. The
other packages of the JAX catalog are not ported (ROADMAP Queue 1).
"""

from .registry import REGISTRY, build_component, component_names, register

__all__ = ["REGISTRY", "register", "build_component", "component_names"]

# Importing the package modules populates the registry.
from . import training  # noqa: F401,E402
