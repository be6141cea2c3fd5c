"""The port's experiment routers against the JAX package's, on the CPU.

- For one seed, ABTestRouter, EpsilonGreedyRouter (with a scripted
  reward) and ShadowRouter pick the same arm sequence in both packages.
- RoutedModel's shadow and failure semantics match.
- Over REST: both packages' ModelServers mount an A/B router over two
  versions of the small LM (2 layers, embed 64, 4 heads x 16, S 32,
  vocab 256, f32; seeds 7 and 8, carried across by ``models/convert.py``)
  and a shadow router; the same requests choose the same arms and answer
  within 1e-4 of each other's logits (the same arithmetic summed in
  another order) with ``next_token`` equal; the shadow's copies trace as
  ``<rid>-shadow`` with role=shadow, and a failing shadow never fails the
  primary.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from kubeflow_tpu.serving import http_server as JH
from kubeflow_tpu.serving import router as JR
from kubeflow_tpu_torch.obs.trace import load_spans
from kubeflow_tpu_torch.serving import http_server as TH
from kubeflow_tpu_torch.serving import router as TR
from kubeflow_tpu_torch.serving import servable as TS

from test_torch_serving import ATOL, jax_servable, tokens, torch_servable
from test_torch_transformer import numpy_params

PACKAGES = {"jax": JR, "torch": TR}


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_ab_sequence_equals_the_reference(seed):
    arms, weights = ["a", "b", "c"], [0.5, 0.3, 0.2]
    j = JR.ABTestRouter(arms, weights=weights, seed=seed)
    t = TR.ABTestRouter(arms, weights=weights, seed=seed)
    assert [t.route() for _ in range(500)] == \
        [j.route() for _ in range(500)]
    assert t.weights == j.weights


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("epsilon", [0.0, 0.1, 1.0])
def test_epsilon_greedy_sequence_equals_the_reference(seed, epsilon):
    """The same arms under the same scripted reward: identical choices
    and identical per-arm stats."""
    reward = {"bad": 0.1, "mid": 0.5, "good": 0.9}
    seqs, stats = {}, {}
    for pkg, R in PACKAGES.items():
        r = R.EpsilonGreedyRouter(list(reward), epsilon=epsilon, seed=seed)
        seq = []
        for _ in range(300):
            arm = r.route()
            r.record(arm, reward=reward[arm])
            seq.append(arm)
        seqs[pkg], stats[pkg] = seq, r.stats_dict()
    assert seqs["torch"] == seqs["jax"]
    assert stats["torch"] == stats["jax"]


def test_shadow_and_validation_match_the_reference():
    for R in PACKAGES.values():
        r = R.ShadowRouter("prod", "canary", seed=0)
        assert {r.route() for _ in range(20)} == {"prod"}
        with pytest.raises(ValueError):
            R.ABTestRouter([])
        with pytest.raises(ValueError):
            R.ABTestRouter(["a", "b"], weights=[-1, 2])
        with pytest.raises(ValueError):
            R.EpsilonGreedyRouter(["a"], epsilon=1.5)


class FakeRepo:
    def __init__(self, outputs, fail=()):
        self.outputs = outputs
        self.fail = set(fail)
        self.calls = []

    def get(self, name):
        repo = self

        class S:
            def predict(self, x):
                repo.calls.append(name)
                if name in repo.fail:
                    raise RuntimeError(f"{name} down")
                return np.full(len(x), repo.outputs[name])

        return S()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("fail", [(), ("canary",), ("prod",)])
def test_routed_model_shadow_and_failures(pkg, fail):
    R = PACKAGES[pkg]
    repo = FakeRepo({"prod": 1.0, "canary": 2.0}, fail=fail)
    routed = R.RoutedModel(R.ShadowRouter("prod", "canary"), repo)
    if "prod" in fail:
        with pytest.raises(RuntimeError, match="prod down"):
            routed.predict(np.zeros(4))
        assert repo.calls == ["prod"]
    else:
        assert (routed.predict(np.zeros(4)) == 1.0).all()
        routed.drain_shadow()
        assert repo.calls == ["prod", "canary"]
    arms = {a["name"]: a for a in routed.status()["arms"]}
    assert arms["prod"]["failures"] == (1 if "prod" in fail else 0)
    assert arms["canary"]["failures"] == (1 if "canary" in fail else 0)
    assert routed.status()["routerType"] == "ShadowRouter"


# -------------------------------------------------------------- over REST


@pytest.fixture(scope="module")
def versions():
    return {0: numpy_params(seed=7), 1: numpy_params(seed=8)}


def _server(pkg, versions, span_path, shadow_fails=False):
    """One package's ModelServer with lm_v0, lm_v1 and a shadow copy of
    v1 (failing when asked), an A/B router over v0/v1 (seed 3) and a
    shadow router v0 → shadow."""
    H, R = (JH, JR) if pkg == "jax" else (TH, TR)
    make = jax_servable if pkg == "jax" else torch_servable
    srv = H.ModelServer(host="127.0.0.1", port=0, sample_every=1,
                        span_path=span_path)
    for name, v in (("lm_v0", 0), ("lm_v1", 1), ("shadow", 1)):
        s = make(versions[v])
        s.name = name
        if name == "shadow" and shadow_fails:
            def boom(*a, **k):
                raise RuntimeError("shadow down")
            s.predict = boom
            s.predict_with_stages = boom
        srv.repository.add(s)
    srv.add_router(R.RoutedModel(
        R.ABTestRouter(["lm_v0", "lm_v1"], weights=[0.5, 0.5], seed=3),
        srv.repository, name="ab"))
    srv.add_router(R.RoutedModel(R.ShadowRouter("lm_v0", "shadow"),
                                 srv.repository, name="sh"))
    srv.start()
    return srv


def _post(port, path, body, rid=None):
    headers = {"Content-Type": "application/json"}
    if rid:
        headers["x-request-id"] = rid
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def test_ab_router_over_rest_matches_the_reference(versions, tmp_path):
    n = 6
    xs = [tokens(1, seed=100 + i) for i in range(n)]
    expected = TR.ABTestRouter(["lm_v0", "lm_v1"], weights=[0.5, 0.5],
                               seed=3)
    arms = [expected.route() for _ in range(n)]
    assert set(arms) == {"lm_v0", "lm_v1"}     # the seed splits both ways
    direct = {v: torch_servable(versions[v]) for v in (0, 1)}
    answers = {}
    for pkg in ("jax", "torch"):
        srv = _server(pkg, versions, str(tmp_path / f"{pkg}.jsonl"))
        try:
            answers[pkg] = [_post(srv.port, "/v1/routers/ab:predict",
                                  {"instances": x.tolist(),
                                   "dtype": "int32"})["predictions"]
                            for x in xs]
            status = _get(srv.port, "/v1/routers/ab")
            fb = _post(srv.port, "/v1/routers/ab:feedback",
                       {"arm": "lm_v1", "reward": 0.25})
        finally:
            srv.stop()
        counts = {a["name"]: a["requests"] for a in status["arms"]}
        assert counts == {a: arms.count(a) for a in ("lm_v0", "lm_v1")}
        assert status["routerType"] == "ABTestRouter"
        # feedback adds a reward observation, never a request
        fb_arms = {a["name"]: a for a in fb["arms"]}
        assert fb_arms["lm_v1"]["requests"] == counts["lm_v1"]
        assert fb_arms["lm_v1"]["rewardCount"] == counts["lm_v1"] + 1
    for i, (x, arm) in enumerate(zip(xs, arms)):
        ref = direct[int(arm[-1])].predict(x)
        for pkg in ("torch", "jax"):
            got = answers[pkg][i]
            np.testing.assert_allclose(np.asarray(got["logits"]),
                                       ref["logits"], atol=ATOL, rtol=0)
            np.testing.assert_array_equal(got["next_token"],
                                          ref["next_token"])


@pytest.mark.parametrize("shadow_fails", [False, True])
def test_shadow_router_over_rest(versions, tmp_path, shadow_fails):
    sink = tmp_path / "spans.jsonl"
    srv = _server("torch", versions, str(sink), shadow_fails=shadow_fails)
    direct = torch_servable(versions[0])
    try:
        for i in range(3):
            x = tokens(1, seed=200 + i)
            got = _post(srv.port, "/v1/routers/sh:predict",
                        {"instances": x.tolist(), "dtype": "int32"},
                        rid=f"req{i}")["predictions"]
            np.testing.assert_array_equal(got["next_token"],
                                          direct.predict(x)["next_token"])
        srv.routers["sh"].drain_shadow()
        status = _get(srv.port, "/v1/routers/sh")
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(srv.port, "/v1/routers/ghost")
        assert err.value.code == 404
    finally:
        srv.stop()
    arms = {a["name"]: a for a in status["arms"]}
    assert arms["lm_v0"]["requests"] == 3 and arms["lm_v0"]["failures"] == 0
    assert arms["shadow"]["requests"] == 3
    assert arms["shadow"]["failures"] == (3 if shadow_fails else 0)
    summaries = [s for s in load_spans(str(sink))
                 if s["name"] == "serving-request"]
    shadows = {s["trace_id"]: s for s in summaries
               if s["attrs"].get("role") == "shadow"}
    assert set(shadows) == {f"req{i}-shadow" for i in range(3)}
    for s in shadows.values():
        assert s["attrs"]["model"] == "shadow"
        assert s["attrs"]["outcome"] == ("error" if shadow_fails else "ok")
    primaries = [s for s in summaries if s["trace_id"] in
                 {f"req{i}" for i in range(3)}]
    assert [s["attrs"]["outcome"] for s in primaries] == ["ok"] * 3
    assert {s["attrs"]["model"] for s in primaries} == {"lm_v0"}


def test_router_mounted_over_a_foreign_repository_keeps_its_resolver():
    srv = TH.ModelServer(host="127.0.0.1", port=0)
    other = TS.ModelRepository()
    routed = TR.RoutedModel(TR.ABTestRouter(["x"]), other, name="r")
    srv.add_router(routed)
    assert routed.predict_resolver is None
    assert routed.request_obs is srv.obs
    assert srv.routers["r"] is routed
