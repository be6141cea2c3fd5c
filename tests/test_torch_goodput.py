"""The port's training goodput ledger (obs/goodput.py) against the JAX
package's (``kubeflow_tpu/obs/goodput.py``, ``tests/test_goodput.py``):
on the same span streams, ``decompose``, ``ledger_for``,
``categories_sum_ok``, ``annotation_payload`` and ``cluster_rollup``
give the same answers, and the exported ``kftpu_job_*`` series carry
them.

- The streams of the reference's fixtures (queue and bind, replayed
  windows, compile by start kind and clipped, checkpoints, stall and
  restart, resize, the residual, a rich partition, an anomaly rollback,
  a pipeline bubble).
- Span files the port's worker writes on the CPU: a preempted run's
  forced save and its resume, a sentinel trip and the LKG rollback (the
  replayed steps counted as rolled back), the tiny MPMD run (nonzero
  ``pipeline_bubble``) and an AOT rebind (``compileByStartKind`` holds
  ``aot``); each ledger sums to its wall-clock.
"""

import json

import pytest
import torch

from kubeflow_tpu.obs import goodput as J
from kubeflow_tpu_torch.models import transformer as T
from kubeflow_tpu_torch.obs import goodput as G
from kubeflow_tpu_torch.obs.registry import Registry
from kubeflow_tpu_torch.runtime import sentinel as TS
from kubeflow_tpu_torch.runtime import worker

TRACE = "gp-trace"


def _span(name, start, end=None, trace_id="t", **attrs):
    rec = {"trace_id": trace_id, "span_id": "s", "parent_id": "",
           "name": name, "component": "test", "start": float(start),
           "end": float(end if end is not None else start)}
    if attrs:
        rec["attrs"] = attrs
    return rec


STREAMS = {
    "empty": [],
    "queue": [_span("queued", 0.0, chips=8), _span("bound", 10.0, chips=8),
              _span("window", 10.0, 20.0, step=10, steps=10)],
    "never-bound": [_span("queued", 0.0, chips=4),
                    _span("queued-heartbeat", 30.0)],
    "replay": [_span("window", 0.0, 4.0, step=4, steps=4),
               _span("window", 10.0, 14.0, step=6, steps=4)],
    "compile": [_span("train-start", 0.0),
                _span("window", 0.0, 5.0, step=1, steps=1),
                _span("first-step", 4.0, start_kind="warm", seconds=4.0,
                      step=1)],
    "compile-clipped": [_span("train-start", 0.0),
                        _span("first-step", 2.0, start_kind="cold",
                              seconds=10.0),
                        _span("window", 2.0, 3.0, step=1, steps=1)],
    "checkpoint": [_span("window", 0.0, 4.0, step=4, steps=4),
                   _span("ckpt-save", 4.0, 5.5, step=4),
                   _span("ckpt-restore", 6.0, 6.5, step=4),
                   _span("window", 6.5, 8.5, step=6, steps=2)],
    "stall": [_span("window", 0.0, 4.0, step=4, steps=4),
              _span("restarting", 34.0, reason="StallTimeout"),
              _span("train-start", 40.0),
              _span("window", 40.0, 42.0, step=6, steps=2)],
    "resize": [_span("window", 0.0, 4.0, step=4, steps=4),
               _span("resized", 4.0, direction="shrink"),
               _span("train-start", 9.0),
               _span("window", 9.0, 10.0, step=5, steps=1)],
    "other": [_span("window", 0.0, 1.0, step=1, steps=1),
              _span("train-done", 11.0)],
    "rich": [_span("queued", 0.0, chips=8), _span("bound", 5.0, chips=8),
             _span("train-start", 7.0),
             _span("window", 7.0, 12.0, step=2, steps=2),
             _span("first-step", 11.0, start_kind="cold", seconds=4.0,
                   step=1),
             _span("ckpt-save", 12.0, 12.5, step=2),
             _span("preempted", 13.0), _span("queued", 13.0, chips=8),
             _span("bound", 20.0, chips=8),
             _span("window", 22.0, 24.0, step=4, steps=2),
             _span("succeeded", 24.5)],
    "rollback": [_span("window", 0.0, 6.0, step=6, steps=6),
                 _span("anomaly", 6.0, step=6, lkg=4, kind="nan_grad"),
                 _span("ckpt-restore", 8.0, 8.5, step=4),
                 _span("window", 8.5, 12.5, step=8, steps=4)],
    "bubble": [_span("window", 0.0, 4.0, step=2, steps=2),
               _span("pipeline-bubble", 3.0, 4.0, step=2),
               _span("first-step", 1.0, start_kind="aot", seconds=1.0)],
}


def test_vocabulary_is_the_references():
    assert G.BADPUT_CATEGORIES == J.BADPUT_CATEGORIES
    assert G.GOODPUT_ANNOTATION == J.GOODPUT_ANNOTATION
    assert G._PRIORITY == J._PRIORITY
    for name in ("GOODPUT", "BADPUT_QUEUE_WAIT", "BADPUT_STARTUP",
                 "BADPUT_COMPILE", "BADPUT_CHECKPOINT", "BADPUT_RECOMPUTE",
                 "BADPUT_ROLLBACK", "BADPUT_RESIZE", "BADPUT_STALL",
                 "BADPUT_PIPELINE_BUBBLE", "BADPUT_OTHER", "SPAN_CKPT_SAVE",
                 "SPAN_CKPT_RESTORE", "SPAN_ANOMALY", "SPAN_PIPELINE_BUBBLE"):
        assert getattr(G, name) == getattr(J, name), name


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decompose_equals_the_references(name):
    spans = STREAMS[name]
    got, want = G.decompose(spans), J.decompose(spans)
    assert got == want
    assert G.categories_sum_ok(got) == J.categories_sum_ok(want) is True
    if got["wallSeconds"]:
        assert G.annotation_payload(got) == J.annotation_payload(want)
    assert G._window_segments(spans) == J._window_segments(spans)


def test_export_remove_and_cluster_rollup(tmp_path):
    reg = Registry()
    led = G.decompose(STREAMS["rich"])
    G.export_job_ledger("ns", "job", led, registry=reg)
    text = reg.render()
    assert 'kftpu_job_goodput_ratio{namespace="ns",name="job"} ' \
        f'{led["goodputRatio"]}' in text
    assert 'category="queue_wait"} 12' in text
    G.remove_job_ledger("ns", "job", registry=reg)
    assert 'name="job"' not in reg.render()
    sink = tmp_path / "spans.jsonl"
    with open(sink, "w") as f:
        for tid, name in (("a", "rich"), ("b", "queue"),
                          ("c", "never-bound")):
            for s in STREAMS[name]:
                f.write(json.dumps(dict(s, trace_id=tid)) + "\n")
    assert G.cluster_rollup(str(sink)) == J.cluster_rollup(str(sink))
    assert G.ledger_for(str(sink), "a") == J.ledger_for(str(sink), "a")
    assert G.ledger_for(str(tmp_path / "none"), "a") == \
        J.ledger_for(str(tmp_path / "none"), "a")


# -- span files of the port's worker ---------------------------------------------

TINY = dict(vocab_size=64, num_layers=1, embed_dim=16, num_heads=2,
            head_dim=8, mlp_dim=32, max_seq_len=16)


@pytest.fixture
def env(monkeypatch):
    for name in (TS.NUMERIC_FAULT_ENV, TS.NUMERIC_FAULT_MARK_ENV,
                 TS.NUMERIC_FAULT_FIRES_ENV, TS.RESUME_STEP_ENV,
                 TS.REPLAY_RANGE_ENV, "KFTPU_CHECKPOINT_DIR",
                 "KFTPU_RESUME_FROM", "KFTPU_INTEGRITY", "KFTPU_SPAN_PATH",
                 "KFTPU_AOT", "KFTPU_AOT_DIR", "KFTPU_NUM_SLICES",
                 "KFTPU_MULTISLICE_PIPELINE", "KFTPU_COMPILE_CACHE_DIR"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("KFTPU_TRACE_ID", TRACE)
    return monkeypatch


def _kw(**kw):
    return dict(workload="transformer", workload_kwargs={
        "cfg": T.TransformerConfig(dtype=torch.float32, **TINY)},
        optimizer="adam", learning_rate=1e-2, global_batch=2, device="cpu",
        handle_sigterm=False, sync_every=1, seed=0, **kw)


def _both(path) -> dict:
    got, want = G.ledger_for(path, TRACE), J.ledger_for(path, TRACE)
    assert got == want
    assert G.categories_sum_ok(got)
    return got


class _StopAtStep3:
    """A preemption guard whose stop flag turns True during step 3."""

    def __init__(self, install=True, on_term=None):
        self.reads = 0

    @property
    def stop(self):
        self.reads += 1
        return self.reads > 2

    def uninstall(self):
        pass


def test_preempted_save_and_resume(tmp_path, env):
    sink = str(tmp_path / "spans.jsonl")
    kw = _kw(checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=1000,
             span_path=sink)
    env.setattr(worker, "PreemptionGuard", _StopAtStep3)
    assert worker.train(steps=200, **kw).preempted
    env.undo()
    env.setenv("KFTPU_TRACE_ID", TRACE)
    assert worker.train(steps=5, **kw).steps == 2
    led = _both(sink)
    assert led["badputSeconds"][G.BADPUT_CHECKPOINT] > 0
    assert (led["steps"], led["stepsRecomputed"]) == (5, 0)


def test_sentinel_trip_and_rollback(tmp_path, env):
    env.setenv(TS.NUMERIC_FAULT_ENV, "nan:5")
    env.setenv(TS.NUMERIC_FAULT_MARK_ENV, str(tmp_path / "mark"))
    sink = str(tmp_path / "spans.jsonl")
    kw = _kw(checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=2,
             integrity=True, integrity_check_every=1, span_path=sink)
    res = worker.train(steps=8, **kw)
    assert res.anomaly is not None and res.anomaly["lkg"] == 4
    env.setenv(TS.RESUME_STEP_ENV, "4")
    assert worker.train(steps=8, **kw).anomaly is None
    led = _both(sink)
    # steps 5 and 6 ran, tripped, and ran again from the LKG
    assert led["stepsRolledBack"] == led["stepsRecomputed"] == 2
    assert led["badputSeconds"][G.BADPUT_ROLLBACK] > 0
    assert led["badputSeconds"][G.BADPUT_CHECKPOINT] > 0


def test_mpmd_run_and_aot_start(tmp_path, env):
    env.setenv("KFTPU_NUM_SLICES", "2")
    sink = str(tmp_path / "spans.jsonl")
    kw = dict(_kw(span_path=sink, aot=True, aot_dir=str(tmp_path / "aot")),
              workload="transformer-pipelined", global_batch=8,
              multislice_pipeline=True, workload_kwargs={
                  "cfg": T.TransformerConfig(dtype=torch.float32,
                                             **dict(TINY, num_layers=2))})
    worker.train(steps=3, **kw)
    assert worker.train(steps=3, **kw).start_kind == "aot"
    led = _both(sink)
    assert led["badputSeconds"][G.BADPUT_PIPELINE_BUBBLE] > 0
    assert set(led["compileByStartKind"]) == {"cold", "aot"}
    # the rebind starts from step 0 again: its 3 steps are replayed
    assert (led["steps"], led["stepsRecomputed"]) == (3, 3)
