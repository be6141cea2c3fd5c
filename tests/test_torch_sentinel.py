"""The port's numeric sentinel against the JAX package's, and the
worker's trip and LKG rollback.

- Detectors: the same seeded stream of (loss, grad norm, replica square
  norms), with NaN, Inf, a loss spike and a replica skew injected, goes
  through both packages' ``NumericSentinel`` (each detector's
  ``tests/test_sentinel.py`` case as a stream too): the trips (kind,
  step, replica) must be identical and the ``AnomalyEvidence`` JSON equal
  byte for byte. The wire format, ``parse_replay_range`` and the chaos
  hook's env contract likewise.
- ``NumericFaultHook.poison`` on the same numpy params gives the same
  numpy params in both packages for ``nan``, ``spike`` and ``bitflip``
  (NaN where NaN); under the sharded update the port poisons the
  optimizer's blocks too, and a replicated leaf once.
- ``train()``: poisoned after step 5, the trip at step 6 names LKG 4,
  nothing newer than 4 is committed and ``main()`` exits 76; rerun with
  ``KFTPU_RESUME_STEP=4`` (the fault has fired) the run finishes equal to
  an untouched one, bit for bit on the CPU.

JAX is imported inside the test functions.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.runtime import sentinel as TS
from kubeflow_tpu_torch.runtime import worker
from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
from kubeflow_tpu_torch.runtime.trainstep import TrainState


def _jax_sentinel():
    from kubeflow_tpu.runtime import sentinel
    return sentinel


def _stream(seed: int, n: int = 60) -> list:
    """A converging loss with noise; grad norms; 4 replica sqnorms that
    agree to 1e-7. Then the faults, at fixed steps."""
    rng = np.random.default_rng(seed)
    out = []
    for step in range(1, n + 1):
        loss = 5.0 / (1.0 + 0.05 * step) + 0.01 * rng.standard_normal()
        sq = 100.0 + rng.standard_normal()
        out.append({"step": step, "loss": float(loss),
                    "grad_norm": float(abs(rng.standard_normal()) + 0.5),
                    "replica_sqnorms": [sq * (1 + 1e-7 * rng.standard_normal())
                                        for _ in range(4)]})
    return out


def _inject(stream: list, fault: str) -> list:
    s = [dict(r) for r in stream]
    if fault == "nan-loss":
        s[40]["loss"] = float("nan")
    elif fault == "inf-loss":
        s[40]["loss"] = float("inf")
    elif fault == "nan-grad":
        s[40]["grad_norm"] = float("nan")
        s[40]["loss"] = float("nan")
    elif fault == "inf-grad":
        s[40]["grad_norm"] = float("-inf")
    elif fault == "spike":
        s[45]["loss"] = s[44]["loss"] * 40.0
    elif fault == "skew":
        s[50]["replica_sqnorms"] = list(s[50]["replica_sqnorms"])
        s[50]["replica_sqnorms"][2] *= 1.01
    elif fault == "nan-replica":
        s[50]["replica_sqnorms"] = [1.0, float("nan"), 1.0, 1.0]
    elif fault == "early-spike":
        s[3]["loss"] = 500.0       # inside the warm-up: no trip
    return s


def _run(pkg, stream: list, keep_going: bool, **kw) -> list:
    s = pkg.NumericSentinel(**kw)
    trips = []
    for r in stream:
        ev = s.observe(r["step"], loss=r["loss"], grad_norm=r["grad_norm"],
                       replica_sqnorms=r["replica_sqnorms"],
                       lkg=r["step"] - 2 if r["step"] > 2 else None)
        if ev is not None:
            trips.append(ev.to_json())
            if not keep_going:
                break
    return trips + [s.trips]


FAULTS = ("none", "nan-loss", "inf-loss", "nan-grad", "inf-grad", "spike",
          "skew", "nan-replica", "early-spike")


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_detector_stream_matches_jax(fault, seed):
    stream = _inject(_stream(seed), fault)
    kw = dict(spike_z=6.0, window_steps=16)
    got = _run(TS, stream, keep_going=True, **kw)
    want = _run(_jax_sentinel(), stream, keep_going=True, **kw)
    assert got == want            # kinds, steps, replicas, JSON bytes
    if fault not in ("none", "early-spike"):
        assert len(got) > 1, fault


def test_detector_cases_match_jax():
    """The detector cases of tests/test_sentinel.py, on both packages."""
    J = _jax_sentinel()
    for pkg in (TS, J):
        s = pkg.NumericSentinel(spike_z=3.0, window_steps=4)
        assert s.observe(1, loss=1.0) is None
        assert s.observe(2, loss=50.0) is None      # warm-up
    cases = [
        [(3, dict(loss=float("nan"), lkg=2))],
        [(1, dict(loss=1.0, grad_norm=float("inf")))],
        [(i, dict(loss=x)) for i, x in enumerate((1.0, 1.1, 0.9, 1.05, 50.0,
                                                  50.0), start=1)],
        [(7, dict(replica_sqnorms=[1.0, 1.0, 1.002, 1.0], lkg=4))],
        [(7, dict(replica_sqnorms=[1.0, float("nan")]))],
        [(1, dict(replica_sqnorms=[1.0, 1.0 + 1e-7])),
         (2, dict(replica_sqnorms=[1.0]))],
        [(i, dict(loss=10.0 / (1.0 + 0.1 * i))) for i in range(1, 41)],
    ]
    for case in cases:
        out = {}
        for name, pkg in (("torch", TS), ("jax", J)):
            s = pkg.NumericSentinel(spike_z=3.0, window_steps=4)
            evs = [s.observe(step, **kw) for step, kw in case]
            out[name] = [None if e is None else e.to_json() for e in evs]
        assert out["torch"] == out["jax"], case
    for pkg in (TS, J):
        with pytest.raises(ValueError, match="spike_z"):
            pkg.NumericSentinel(spike_z=0)
        with pytest.raises(ValueError, match="window_steps"):
            pkg.NumericSentinel(window_steps=1)


def test_names_and_wire_format_match_jax():
    J = _jax_sentinel()
    for name in ("ANOMALY_EXIT_CODE", "RESUME_STEP_ENV", "REPLAY_RANGE_ENV",
                 "KIND_NAN_LOSS", "KIND_NAN_GRAD", "KIND_LOSS_SPIKE",
                 "KIND_REPLICA_SKEW", "KIND_HEARTBEAT_NAN", "ANOMALY_KINDS",
                 "DEFAULT_SPIKE_Z", "DEFAULT_WINDOW_STEPS",
                 "DEFAULT_CHECK_EVERY", "AGREEMENT_RTOL",
                 "NUMERIC_FAULT_ENV", "NUMERIC_FAULT_MARK_ENV",
                 "NUMERIC_FAULT_FIRES_ENV", "NUMERIC_FAULT_KINDS"):
        assert getattr(TS, name) == getattr(J, name), name
    assert TS.ANOMALY_EXIT_CODE == 76
    for pkg_from, pkg_to in ((TS, J), (J, TS)):
        ev = pkg_from.AnomalyEvidence(kind=TS.KIND_NAN_LOSS, step=12,
                                      value=float("nan"), lkg=8,
                                      detail={"z": 9.1})
        raw = ev.to_json()
        json.loads(raw)
        back = pkg_to.AnomalyEvidence.from_json(raw)
        assert math.isnan(back.value) and back.detail == {"z": 9.1}
        assert (back.kind, back.step, back.lkg) == (ev.kind, 12, 8)
        assert back.to_json() == raw
    for raw in ("not json", "{}", json.dumps({"kind": "x"}),
                json.dumps({"step": "NaN", "kind": "x"})):
        assert TS.AnomalyEvidence.from_json(raw) is None
        assert J.AnomalyEvidence.from_json(raw) is None
    for raw in (None, "", "garbage", "6:4", "4:4", "-1:2", "a:b", "4:6",
                "0:3"):
        assert TS.parse_replay_range(raw) == J.parse_replay_range(raw), raw


def test_fault_hook_env_contract_matches_jax(tmp_path):
    J = _jax_sentinel()
    envs = [{}, {TS.NUMERIC_FAULT_ENV: "spike:7:16.0",
                 TS.NUMERIC_FAULT_MARK_ENV: str(tmp_path / "m"),
                 TS.NUMERIC_FAULT_FIRES_ENV: "2"},
            {TS.NUMERIC_FAULT_ENV: "nan:5"},
            {TS.NUMERIC_FAULT_ENV: "bitflip:3"}]
    for env in envs:
        a, b = TS.NumericFaultHook.from_env(env=env), \
            J.NumericFaultHook.from_env(env=env)
        assert (a is None) == (b is None)
        if a is not None:
            fields = ("kind", "at_step", "mark_path", "max_fires")
            assert [getattr(a, f) for f in fields] == \
                [getattr(b, f) for f in fields]
            assert a.scale == b.scale or (math.isnan(a.scale) and
                                          math.isnan(b.scale))
    for pkg in (TS, J):
        with pytest.raises(ValueError, match="kind:step"):
            pkg.NumericFaultHook.from_env(env={TS.NUMERIC_FAULT_ENV: "nan"})
        with pytest.raises(ValueError, match="unknown numeric fault"):
            pkg.NumericFaultHook("rowhammer", 1, 1.0, None)
    # the fire budget persists in the mark file, across processes
    mark = str(tmp_path / "mark")
    hook = TS.NumericFaultHook("nan", 5, float("nan"), mark, max_fires=2)
    assert not hook.should_fire(4) and hook.should_fire(5)
    hook._record_fire()
    assert hook.should_fire(5)
    hook._record_fire()
    assert not hook.should_fire(5)
    assert not J.NumericFaultHook("nan", 5, float("nan"), mark,
                                  max_fires=2).should_fire(5)


def _params(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 8)).astype(np.float32),
            "b": rng.standard_normal((8,)).astype(np.float32),
            "s": np.float32(rng.standard_normal()).reshape(())}


@pytest.mark.parametrize("kind", TS.NUMERIC_FAULT_KINDS)
def test_poison_matches_jax(tmp_path, kind):
    import jax.numpy as jnp
    J = _jax_sentinel()

    @dataclasses.dataclass
    class _State:
        params: dict

    scale = {"nan": float("nan"), "spike": 8.0, "bitflip": 1.25}[kind]
    params = _params()
    jstate = _State(params={k: jnp.asarray(v) for k, v in params.items()})
    jout = J.NumericFaultHook(kind, 3, scale,
                              str(tmp_path / "j")).poison(jstate, 3)
    tstate = TrainState(step=3, opt_state=None, params={
        k: torch.tensor(v, requires_grad=True) for k, v in params.items()})
    hook = TS.NumericFaultHook(kind, 3, scale, str(tmp_path / "t"))
    assert hook.poison(tstate, 2) is tstate      # not armed
    out = hook.poison(tstate, 3)
    for k in params:
        np.testing.assert_array_equal(out.params[k].detach().numpy(),
                                      np.asarray(jout.params[k]))
    before = {k: v.detach().clone() for k, v in out.params.items()}
    assert hook.poison(out, 3) is out            # the budget is spent
    for k in params:
        assert torch.equal(out.params[k], before[k]) or kind == "nan"


def test_poison_under_the_sharded_update(tmp_path):
    """The optimizer's blocks are poisoned too (or the next all-gather
    would write the clean blocks back); a replicated leaf, held by both
    dicts, is scaled once."""
    params = {k: torch.tensor(v) for k, v in _params().items()}
    update = {"w": params["w"][:3].clone(), "b": params["b"][:4].clone(),
              "s": params["s"]}
    state = TrainState(step=5, opt_state=None, params=params,
                       update_params=update,
                       update_blocks={"w": ((0, 0), (2, 1), True),
                                      "b": ((0,), (2,), True)})
    ref = {k: v.clone() for k, v in update.items()}
    TS.NumericFaultHook("spike", 5, 8.0, str(tmp_path / "m")).poison(
        state, 5)
    for k in ("w", "b"):
        assert torch.equal(update[k], ref[k] * 8.0)
    assert torch.equal(params["s"], ref["s"] * 8.0)   # once, not 64x


# -- the worker's trip and rollback -----------------------------------------

def _kw():
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    cfg = TransformerConfig(vocab_size=64, num_layers=1, embed_dim=16,
                            num_heads=2, head_dim=8, mlp_dim=32,
                            max_seq_len=16, dtype=torch.float32)
    return dict(workload="transformer", workload_kwargs={"cfg": cfg},
                optimizer="adam", learning_rate=1e-2, global_batch=2,
                device="cpu", handle_sigterm=False, sync_every=1,
                checkpoint_every=2, seed=0)


@pytest.fixture
def _numeric_env(monkeypatch, tmp_path):
    for name in (TS.NUMERIC_FAULT_ENV, TS.NUMERIC_FAULT_MARK_ENV,
                 TS.NUMERIC_FAULT_FIRES_ENV, TS.RESUME_STEP_ENV,
                 TS.REPLAY_RANGE_ENV, "KFTPU_CHECKPOINT_DIR",
                 "KFTPU_RESUME_FROM", "KFTPU_INTEGRITY",
                 "KFTPU_INTEGRITY_CHECK_EVERY", "KFTPU_SPAN_PATH",
                 "KFTPU_STUDY", "KFTPU_POD_NAME"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(TS.NUMERIC_FAULT_ENV, "nan:5")
    monkeypatch.setenv(TS.NUMERIC_FAULT_MARK_ENV, str(tmp_path / "mark"))
    return monkeypatch


def test_trip_exits_with_evidence_and_untainted_lkg(tmp_path, _numeric_env):
    """tests/test_sentinel.py TestWorkerTrip: poison after step 5, the
    trip at step 6 names LKG 4, nothing newer than 4 committed; the span
    sink has the flight record and the anomaly span."""
    ckpt = str(tmp_path / "ckpt")
    spans = tmp_path / "spans.jsonl"
    res = worker.train(steps=16, checkpoint_dir=ckpt, integrity=True,
                       integrity_check_every=1, integrity_window=4,
                       span_path=str(spans), **_kw())
    assert res.anomaly is not None
    assert res.anomaly["kind"] in (TS.KIND_NAN_GRAD, TS.KIND_NAN_LOSS)
    assert res.anomaly["step"] == 6 and res.anomaly["lkg"] == 4
    m = CheckpointManager(ckpt)
    assert m.lkg_step() == 4 and max(m.all_steps()) <= 4
    names = [json.loads(line)["name"] for line in
             spans.read_text().splitlines()]
    assert "flight-record" in names and "anomaly" in names
    assert names.count("ckpt-save") == len(m.all_steps())


def test_rollback_resumes_from_lkg_and_matches_clean(tmp_path,
                                                     _numeric_env):
    from kubeflow_tpu_torch.cluster.chaos import final_params
    ckpt = str(tmp_path / "ckpt")
    rc = worker.main(["--workload", "transformer", "--device", "cpu",
                      "--steps", "6", "--global-batch", "2",
                      "--optimizer", "adam", "--learning-rate", "1e-2",
                      "--sync-every", "1", "--checkpoint-dir", ckpt,
                      "--checkpoint-every", "2", "--integrity",
                      "--integrity-check-every", "1"])
    assert rc == TS.ANOMALY_EXIT_CODE
    _numeric_env.setenv(TS.RESUME_STEP_ENV, "4")
    kw = {**_kw(), "workload_kwargs": {}}
    res = worker.train(steps=6, checkpoint_dir=ckpt, integrity=True,
                       integrity_check_every=1, **kw)
    assert res.anomaly is None and res.steps == 2
    _numeric_env.delenv(TS.NUMERIC_FAULT_ENV)
    _numeric_env.delenv(TS.RESUME_STEP_ENV)
    clean = str(tmp_path / "clean")
    worker.train(steps=6, checkpoint_dir=clean, **kw)
    a, b = final_params(ckpt, device="cpu"), final_params(clean, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
