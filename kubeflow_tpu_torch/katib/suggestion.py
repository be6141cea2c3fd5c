"""The random suggestion engine that kubebench's in-process study uses.

The port of the part of ``kubeflow_tpu/katib/suggestion.py`` that
``workflows/kubebench.py``'s Katib study reaches: ``ParameterConfig``
(StudyJob ``parameterconfigs``: ``{name, parametertype: double|int|
discrete|categorical, feasible: {min, max, list}}``), the ``Suggestion``
interface and ``RandomSuggestion``. Its draws are the JAX module's:
``random.Random(seed)``, one ``sample`` a parameter in order. Grid,
hyperband and Bayesian optimization run beside the Vizier store in the
StudyJob controller, which stays in the control plane;
``make_suggestion`` names them when asked for one.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Optional

DOUBLE = "double"
INT = "int"
DISCRETE = "discrete"
CATEGORICAL = "categorical"


@dataclass
class ParameterConfig:
    name: str
    parametertype: str = DOUBLE
    min: Optional[float] = None
    max: Optional[float] = None
    list: Optional[list] = None  # discrete / categorical values

    @classmethod
    def from_dict(cls, d: dict) -> "ParameterConfig":
        feasible = d.get("feasible", {}) or {}
        ptype = d.get("parametertype", DOUBLE).lower()
        lo = feasible.get("min")
        hi = feasible.get("max")
        return cls(
            name=d["name"], parametertype=ptype,
            min=float(lo) if lo is not None else None,
            max=float(hi) if hi is not None else None,
            list=feasible.get("list"),
        )

    def validate(self) -> None:
        if self.parametertype in (DOUBLE, INT):
            if self.min is None or self.max is None or self.min > self.max:
                raise ValueError(
                    f"parameter {self.name}: {self.parametertype} needs "
                    f"feasible min <= max, got [{self.min}, {self.max}]")
        elif self.parametertype in (DISCRETE, CATEGORICAL):
            if not self.list:
                raise ValueError(
                    f"parameter {self.name}: {self.parametertype} needs a "
                    f"non-empty feasible list")
        else:
            raise ValueError(f"parameter {self.name}: unknown parametertype "
                             f"{self.parametertype!r}")

    def sample(self, rng: random.Random) -> Any:
        if self.parametertype == DOUBLE:
            return rng.uniform(self.min, self.max)
        if self.parametertype == INT:
            return rng.randint(int(self.min), int(self.max))
        return rng.choice(self.list)


def parse_parameter_configs(raw: list[dict]) -> list[ParameterConfig]:
    configs = [ParameterConfig.from_dict(d) for d in raw or []]
    for c in configs:
        c.validate()
    return configs


class Suggestion:
    """One study's suggestion engine.

    ``suggest(n)`` returns up to n parameter assignments;
    ``observe(params, value)`` feeds back a completed trial's objective,
    already sign-normalized so that HIGHER is always better (the caller
    negates for minimize studies).
    """

    def __init__(self, params: list[ParameterConfig], seed: int = 0,
                 settings: Optional[dict] = None):
        self.params = params
        self.rng = random.Random(seed)
        self.settings = settings or {}
        self.observations: list[tuple[dict, float]] = []

    def suggest(self, n: int) -> list[dict[str, Any]]:
        raise NotImplementedError

    def observe(self, trial_params: dict, value: float) -> None:
        self.observations.append((dict(trial_params), value))


class RandomSuggestion(Suggestion):
    def suggest(self, n: int) -> list[dict[str, Any]]:
        return [{p.name: p.sample(self.rng) for p in self.params}
                for _ in range(n)]


_ALGORITHMS = {"random": RandomSuggestion}
# the JAX package's other engines, which stay with the StudyJob controller
_CONTROL_PLANE = ("grid", "hyperband", "bayesianoptimization")


def make_suggestion(algorithm: str, params: list[ParameterConfig],
                    seed: int = 0,
                    settings: Optional[dict] = None) -> Suggestion:
    algo = (algorithm or "random").lower().replace("-", "").replace("_", "")
    if algo in _CONTROL_PLANE:
        raise ValueError(
            f"suggestion algorithm {algorithm!r} runs in the StudyJob "
            f"controller (kubeflow_tpu/katib), not in the port; the port "
            f"carries {sorted(_ALGORITHMS)}")
    if algo not in _ALGORITHMS:
        raise ValueError(
            f"unknown suggestion algorithm {algorithm!r}; "
            f"supported: {sorted(_ALGORITHMS)}")
    return _ALGORITHMS[algo](params, seed=seed, settings=settings)
