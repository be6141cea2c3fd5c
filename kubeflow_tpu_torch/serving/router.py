"""Experiment routing: A/B splits, shadow traffic, and bandit routing.

The port of ``kubeflow_tpu/serving/router.py`` (stdlib and numpy only):
routers in front of Servables — a router picks the backend per request,
records outcomes and exposes per-arm stats. Used standalone or mounted on
the ModelServer at ``/v1/routers/<name>`` (``ModelServer.add_router``),
where its arms predict through the server's MicroBatchers. The random
streams are the JAX package's (``random.Random(seed)``, drawn in the same
order), so a seed gives the same arm sequence in both packages.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class ArmStats:
    name: str
    requests: int = 0        # routing decisions
    reward_sum: float = 0.0  # accumulated reward signal
    reward_count: int = 0    # reward observations (implicit or feedback)
    failures: int = 0

    @property
    def mean_reward(self) -> float:
        return self.reward_sum / self.reward_count if self.reward_count \
            else 0.0

    def to_dict(self) -> dict:
        return {"name": self.name, "requests": self.requests,
                "meanReward": round(self.mean_reward, 6),
                "rewardCount": self.reward_count,
                "failures": self.failures}


class Router:
    """Base: pick an arm (model name) per request, record outcomes."""

    def __init__(self, arms: list[str], seed: Optional[int] = None):
        if not arms:
            raise ValueError("router needs at least one arm")
        self.arms = list(arms)
        self.rng = random.Random(seed)
        self._lock = threading.Lock()
        self.stats = {a: ArmStats(a) for a in self.arms}

    def route(self) -> str:
        raise NotImplementedError

    def record_request(self, arm: str, failed: bool = False) -> None:
        """One routing decision served (or failed) by the arm."""
        with self._lock:
            s = self.stats[arm]
            s.requests += 1
            if failed:
                s.failures += 1

    def record_reward(self, arm: str, reward: float) -> None:
        """One reward observation — implicit (serving outcome) or
        explicit feedback. Deliberately does NOT count a request, so a
        :feedback call can't double-count traffic."""
        with self._lock:
            s = self.stats[arm]
            s.reward_sum += reward
            s.reward_count += 1

    def record(self, arm: str, reward: float = 0.0,
               failed: bool = False) -> None:
        """Convenience: one request + its reward in one call."""
        self.record_request(arm, failed=failed)
        self.record_reward(arm, reward)

    def stats_dict(self) -> list[dict]:
        with self._lock:
            return [self.stats[a].to_dict() for a in self.arms]


class ABTestRouter(Router):
    """Random split by traffic weights (the seldon abtest prototype:
    ``traffic`` percentage between two predictors; generalized to N)."""

    def __init__(self, arms: list[str],
                 weights: Optional[list[float]] = None,
                 seed: Optional[int] = None):
        super().__init__(arms, seed)
        if weights is None:
            weights = [1.0] * len(arms)
        if len(weights) != len(arms) or any(w < 0 for w in weights) or \
                sum(weights) <= 0:
            raise ValueError(f"bad weights {weights} for arms {arms}")
        total = sum(weights)
        self.weights = [w / total for w in weights]

    def route(self) -> str:
        r = self.rng.random()
        acc = 0.0
        for arm, w in zip(self.arms, self.weights):
            acc += w
            if r < acc:
                return arm
        return self.arms[-1]


class EpsilonGreedyRouter(Router):
    """Multi-armed bandit (the seldon mab prototype): explore with
    probability epsilon, otherwise exploit the best mean reward."""

    def __init__(self, arms: list[str], epsilon: float = 0.1,
                 seed: Optional[int] = None):
        super().__init__(arms, seed)
        if not 0.0 <= epsilon <= 1.0:
            raise ValueError(f"epsilon must be in [0,1], got {epsilon}")
        self.epsilon = epsilon

    def route(self) -> str:
        with self._lock:
            unexplored = [a for a in self.arms
                          if self.stats[a].requests == 0]
            if unexplored:
                return self.rng.choice(unexplored)
            if self.rng.random() < self.epsilon:
                return self.rng.choice(self.arms)
            return max(self.arms, key=lambda a: self.stats[a].mean_reward)


class ShadowRouter(Router):
    """All traffic to the primary; the shadow arm receives a copy whose
    result is discarded (the canary-validation pattern)."""

    def __init__(self, primary: str, shadow: str,
                 seed: Optional[int] = None):
        super().__init__([primary, shadow], seed)
        self.primary = primary
        self.shadow = shadow

    def route(self) -> str:
        return self.primary


@dataclass
class RoutedModel:
    """A router mounted over a ModelRepository: predict() routes to the
    chosen arm's servable. With ``implicit_reward`` (default) the serving
    outcome is the reward signal (success=1, failure=0); experiments with
    task-level feedback set it False and send rewards via
    ``record_feedback`` (the seldon /send-feedback analog) so availability
    doesn't pollute the quality signal."""

    router: Router
    repository: object  # ModelRepository (duck-typed to avoid the import)
    name: str = "router"
    implicit_reward: bool = True
    # override to route arms through a shared execution path (the model
    # server sets this to its MicroBatcher so routed and direct traffic
    # batch together); default is the servable's raw predict
    predict_resolver: Optional[object] = None
    # request observability (serving/request_trace.py ServingObs):
    # adopted from the ModelServer in add_router(). Shadow copies get
    # their OWN request trace + latency series labeled role=shadow, so
    # a shadow's cold kernel build is attributable and never pollutes the
    # primary's SLO series.
    request_obs: Optional[object] = None
    # shadow copies run here so shadow latency (e.g. a cold kernel build)
    # never adds to the primary response — seldon mirrored-traffic
    # semantics. Failures and stats are recorded from the worker thread.
    _shadow_pool: object = field(default=None, repr=False)

    def _arm_predict(self, arm: str, ctx=None):
        if self.predict_resolver is not None:
            fn = self.predict_resolver(arm)
        else:
            fn = self.repository.get(arm).predict
        if ctx is None:
            return fn
        # batcher.predict threads the request ctx through; a bare
        # servable/fake predict doesn't take it. Decide by signature
        # up front — a retry-on-TypeError fallback would re-execute
        # the prediction when the predict BODY raises its own
        # TypeError (double device work, double stats).
        import inspect
        try:
            accepts_ctx = "ctx" in inspect.signature(fn).parameters
        except (TypeError, ValueError):
            accepts_ctx = False
        if not accepts_ctx:
            return fn
        return lambda instances: fn(instances, ctx=ctx)

    def _record(self, arm: str, ok: bool) -> None:
        self.router.record_request(arm, failed=not ok)
        if self.implicit_reward:
            self.router.record_reward(arm, 1.0 if ok else 0.0)

    def predict(self, instances: np.ndarray, ctx=None):
        arm = self.router.route()
        if ctx is not None:
            # the span's model is the chosen ARM (per-arm latency
            # series); the router identity rides the attrs
            ctx.model = arm
            ctx.note(router=self.name)
        try:
            result = self._arm_predict(arm, ctx=ctx)(instances)
        except Exception:
            self._record(arm, ok=False)
            raise
        self._record(arm, ok=True)
        if isinstance(self.router, ShadowRouter):
            self._shadow_submit(self.router.shadow, instances,
                                parent_ctx=ctx)
        return result

    def _shadow_submit(self, shadow: str, instances: np.ndarray,
                       parent_ctx=None) -> None:
        if self._shadow_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            object.__setattr__(self, "_shadow_pool",
                               ThreadPoolExecutor(max_workers=1,
                                                  thread_name_prefix="shadow"))
        # the shadow copy's own request trace: derived id (so the
        # primary's timeline links to it), role=shadow throughout
        shadow_ctx = None
        if self.request_obs is not None:
            rid = (parent_ctx.request_id + "-shadow") \
                if parent_ctx is not None else None
            shadow_ctx = self.request_obs.begin(
                shadow, request_id=rid, role="shadow",
                force_sample=bool(parent_ctx is not None
                                  and parent_ctx.sampled))
            shadow_ctx.note(router=self.name, shadow_of=self.router.primary)

        def run():
            try:
                self._arm_predict(shadow, ctx=shadow_ctx)(instances)
                self._record(shadow, ok=True)
                if shadow_ctx is not None:
                    shadow_ctx.finish("ok")
            except Exception as e:  # noqa: BLE001 - shadow must never break serving
                self._record(shadow, ok=False)
                if shadow_ctx is not None:
                    shadow_ctx.finish("error",
                                      error=f"{type(e).__name__}: {e}")

        self._shadow_pool.submit(run)

    def drain_shadow(self, timeout: float = 10.0) -> None:
        """Wait for in-flight shadow copies (tests / shutdown)."""
        if self._shadow_pool is not None:
            from concurrent.futures import ThreadPoolExecutor
            pool: ThreadPoolExecutor = self._shadow_pool
            pool.shutdown(wait=True)
            object.__setattr__(self, "_shadow_pool", None)

    def record_feedback(self, arm: str, reward: float) -> None:
        self.router.record_reward(arm, reward)

    def status(self) -> dict:
        return {"name": self.name,
                "routerType": type(self.router).__name__,
                "arms": self.router.stats_dict()}
