"""Component registry: name → builder(params) → [manifests].

The port's copy of ``kubeflow_tpu/manifests/registry.py``.

The prototype+params surface of the reference's ksonnet registry
(kubeflow/<pkg>/prototypes/*.jsonnet with @optionalParam headers), kept so
KfDef.components / componentParams drive generation the same way
`ks generate <prototype> --param` did.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

Builder = Callable[..., list[dict]]


@dataclass
class Component:
    name: str
    builder: Builder
    description: str = ""
    # param name -> default (introspected from the builder signature)
    params: dict[str, Any] = field(default_factory=dict)


REGISTRY: dict[str, Component] = {}


def register(name: str, description: str = "") -> Callable[[Builder], Builder]:
    def deco(fn: Builder) -> Builder:
        sig = inspect.signature(fn)
        params = {
            p.name: (p.default if p.default is not inspect.Parameter.empty
                     else None)
            for p in sig.parameters.values()
        }
        REGISTRY[name] = Component(name=name, builder=fn,
                                   description=description, params=params)
        return fn

    return deco


def component_names() -> list[str]:
    return sorted(REGISTRY)


def build_component(name: str, params: Optional[dict] = None) -> list[dict]:
    if name not in REGISTRY:
        raise KeyError(
            f"unknown component {name!r}; known: {component_names()}")
    comp = REGISTRY[name]
    params = params or {}
    sig = inspect.signature(comp.builder)
    unknown = set(params) - set(sig.parameters)
    if unknown:
        raise ValueError(
            f"component {name}: unknown params {sorted(unknown)}; "
            f"valid: {sorted(sig.parameters)}")
    return comp.builder(**params)
