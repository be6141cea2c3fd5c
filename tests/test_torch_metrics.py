"""The port's run records against the JAX package's, on the CPU.

- ``FlightRecorder``: the bounded ring, the per-window stage split and
  the dump span; its records equal ``kubeflow_tpu``'s for the same
  stage times.
- ``ProfileArm``: 200 / 409 / 400, the capture started and stopped on
  step boundaries with injected functions, a failed start disarming;
  with no injected functions, a ``torch.profiler`` Chrome trace in the
  armed directory. ``profile_trace`` writes one on the CPU.
- TensorBoard: the port's ``EventWriter`` writes the same bytes as
  ``kubeflow_tpu.utils.tbevents.EventWriter`` for the same tags, values,
  steps and wall times; ``MetricsLogger(tensorboard_dir=...)`` writes
  its window and eval scalars.
- ``ObsServer`` serves ``/metrics`` of a registry, and the mounted
  ``/profile`` and ``/flightrecorder`` handlers.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import urllib.error
import urllib.request

import pytest
import torch

from kubeflow_tpu.runtime import metrics as JM
from kubeflow_tpu.utils import tbevents as JT
from kubeflow_tpu_torch.obs.http import ObsServer
from kubeflow_tpu_torch.obs.registry import Registry
from kubeflow_tpu_torch.obs.trace import SpanWriter
from kubeflow_tpu_torch.runtime import metrics as TM
from kubeflow_tpu_torch.utils import tbevents as TT


# -- FlightRecorder -------------------------------------------------------------

def test_recorder_ring_is_bounded():
    rec = TM.FlightRecorder(windows=3)
    for i in range(6):
        rec.note_step(data_s=0.01, dispatch_s=0.02)
        rec.close_window(i + 1, 1, 0.05)
    assert [r["step"] for r in rec.snapshot()["records"]] == [4, 5, 6]


def test_recorder_stage_split_equals_jax():
    """The same stage times through both recorders give the same
    records: the split, the residual and the first step's own key."""
    recs = []
    for cls in (TM.FlightRecorder, JM.FlightRecorder):
        rec = cls(windows=4)
        rec.note_step(data_s=0.001, first_step_s=3.0)
        rec.note_step(data_s=0.01, h2d_s=0.005, dispatch_s=0.002)
        rec.close_window(2, 2, 3.1, drain_s=0.01)
        rec.note_step(data_s=0.01, h2d_s=0.005, dispatch_s=0.002)
        rec.close_window(3, 1, 0.05)
        recs.append(rec.snapshot()["records"])
    assert recs[0] == recs[1]
    r = recs[0][0]
    assert r["dispatch_s"] == pytest.approx(0.002)
    assert r["first_step_s"] == pytest.approx(3.0)
    assert r["device_wait_s"] == pytest.approx(3.11 - 3.018)
    assert set(r["input_batches"]) == {"augment", "device_put"}


def test_recorder_counts_input_batches():
    from kubeflow_tpu_torch.obs import registry as obsreg
    fam = obsreg.counter("kftpu_input_batches_total", "",
                         labels=("stage",))
    rec = TM.FlightRecorder(windows=4)
    rec.close_window(1, 1, 0.1)
    fam.labels(stage="device_put").inc(3)
    fam.labels(stage="augment").inc(2)
    rec.close_window(2, 1, 0.1)
    assert rec.snapshot()["records"][1]["input_batches"] == {
        "augment": 2, "device_put": 3}


def test_recorder_dump_emits_span(tmp_path):
    rec = TM.FlightRecorder(windows=4)
    rec.note_step(data_s=0.01)
    rec.close_window(1, 1, 0.05)
    rec.mark("step", 2)
    w = SpanWriter(str(tmp_path / "s.jsonl"), "worker")
    assert rec.dump(w, "crash", error="boom") is not None
    w.close()
    (span,) = [json.loads(line) for line in open(tmp_path / "s.jsonl")]
    assert span["name"] == TM.FLIGHT_RECORD_SPAN == JM.FLIGHT_RECORD_SPAN
    assert span["attrs"]["reason"] == "crash"
    assert span["attrs"]["inProgress"]["stage"] == "step"
    assert span["attrs"]["inProgress"]["step"] == 2
    assert len(span["attrs"]["records"]) == 1
    assert rec.dump(None, "crash") is None
    assert TM.FlightRecorder(windows=0).dump(w, "crash") is None


# -- ProfileArm and profile_trace ---------------------------------------------

def _arm(tmp_path, calls, **kw):
    return TM.ProfileArm(
        base_dir=str(tmp_path),
        start_fn=lambda d: calls.append(("start", d)),
        stop_fn=lambda: calls.append(("stop",)), **kw)


def test_arm_capture_stop_cycle(tmp_path):
    calls = []
    arm = _arm(tmp_path, calls)
    code, body = arm.request(2)
    assert code == 200 and body["armed"] and body["steps"] == 2
    assert arm.request(1)[0] == 409          # armed: a second is refused
    arm.on_step_start()
    assert calls == [("start", body["dir"])]
    assert os.path.isdir(body["dir"])
    code, busy = arm.request(1)
    assert code == 409 and busy["dir"] == body["dir"]   # active
    arm.on_step_end(1)
    assert len(calls) == 1                   # one step to go
    arm.on_step_start()                      # no second start while active
    arm.on_step_end(2)
    assert calls[-1] == ("stop",) and len(calls) == 2
    assert arm.request(1)[0] == 200          # re-armed after it finished
    arm.on_step_start()
    arm.on_step_end(3, force=True)           # the loop ended early
    assert calls[-2][0] == "start" and calls[-1] == ("stop",)
    arm.on_step_end(4, force=True)           # nothing active: no stop
    assert len(calls) == 4


@pytest.mark.parametrize("steps", ["nope", 0, -2, None])
def test_arm_rejects_bad_steps(tmp_path, steps):
    assert _arm(tmp_path, []).request(steps)[0] == 400


def test_arm_failed_start_disarms_with_a_warning(tmp_path, caplog):
    def boom(d):
        raise RuntimeError("profiler busy")

    stops = []
    arm = TM.ProfileArm(str(tmp_path), start_fn=boom,
                        stop_fn=lambda: stops.append(1))
    arm.request(2)
    with caplog.at_level(logging.WARNING, logger=TM.log.name):
        arm.on_step_start()
    assert "profile start failed" in caplog.text
    arm.on_step_end(1)
    arm.on_step_end(2)
    assert not stops and arm.request(1)[0] == 200


def _trace_events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_arm_writes_a_torch_profiler_trace(tmp_path):
    spans = tmp_path / "spans.jsonl"
    tracer = SpanWriter(str(spans), "worker")
    arm = TM.ProfileArm(str(tmp_path / "profiles"), tracer=tracer)
    _, body = arm.request(1)
    x = torch.randn(64, 64)
    arm.on_step_start()
    (x @ x).sum()
    arm.on_step_end(1)
    tracer.close()
    (path,) = glob.glob(os.path.join(body["dir"], "*.pt.trace.json"))
    names = {e.get("name") for e in _trace_events(path)}
    assert "aten::mm" in names
    (span,) = [json.loads(line) for line in open(spans)]
    assert span["name"] == "profile" and span["attrs"]["on_demand"]


def test_profile_trace_writes_a_trace(tmp_path):
    out = tmp_path / "prof"
    with TM.profile_trace(str(out)):
        torch.relu(torch.randn(32)).sum()
    (path,) = glob.glob(str(out / "*.pt.trace.json"))
    assert any(e.get("name") == "aten::relu" for e in _trace_events(path))
    with TM.profile_trace(None):            # off: nothing written
        pass
    with TM.profile_trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()


# -- TensorBoard ----------------------------------------------------------------

def test_event_writer_bytes_equal_jax(tmp_path):
    def clock():
        return 1_700_000_000.25

    files = []
    for mod, name in ((TT, "t"), (JT, "j")):
        with mod.EventWriter(str(tmp_path / name), clock=clock) as w:
            w.add_scalar("loss", 2.5, 1)
            w.add_scalars({"throughput/examples_per_sec": 1234.5,
                           "timing/step_time_s": 0.042, "lr": 1e-3}, 10,
                          wall_time=1_700_000_001.5)
            w.add_scalars({}, 11)
            w.add_scalar("eval/top1", float("nan"), 2 ** 40)
        files.append(w.path)
    assert os.path.basename(files[0]) == os.path.basename(files[1])
    with open(files[0], "rb") as a, open(files[1], "rb") as b:
        assert a.read() == b.read()
    assert TT._masked_crc(b"kubeflow") == JT._masked_crc(b"kubeflow")


def test_metrics_logger_writes_tensorboard_events(tmp_path):
    tb = tmp_path / "tb"
    mlog = TM.MetricsLogger(batch_size=8, tensorboard_dir=str(tb))
    mlog.record_window(2, 2, 0.5, {"loss": torch.tensor(1.5)})
    mlog.event(2, {"eval_loss": 1.25, "top1": 0.5})
    mlog.close()
    (path,) = glob.glob(str(tb / "events.out.tfevents.*"))
    data = open(path, "rb").read()
    for tag in (b"throughput/examples_per_sec", b"timing/step_time_s",
                b"loss", b"eval/loss", b"eval/top1"):
        assert tag in data, tag
    assert mlog.summary()["steps"] == 2


# -- ObsServer ------------------------------------------------------------------

def test_obs_server_serves_metrics_profile_and_flightrecorder(tmp_path):
    reg = Registry()
    reg.counter("kftpu_input_batches_total", "batches",
                labels=("stage",)).labels(stage="device_put").inc(4)
    calls = []
    arm = _arm(tmp_path, calls)
    rec = TM.FlightRecorder(windows=2)
    rec.close_window(1, 1, 0.1)
    srv = ObsServer(reg, host="127.0.0.1", handlers={
        ("POST", "/profile"): lambda q: arm.request(q.get("steps", 0)),
        ("GET", "/flightrecorder"): lambda q: (200, rec.snapshot()),
    })
    port = srv.start()
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(base + "/metrics") as resp:
            text = resp.read().decode()
        assert 'kftpu_input_batches_total{stage="device_put"} 4' in text
        req = urllib.request.Request(base + "/profile?steps=3", data=b"",
                                     method="POST")
        with urllib.request.urlopen(req) as resp:
            body = json.loads(resp.read())
        assert body["armed"] and body["steps"] == 3
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(
                base + "/profile?steps=1", data=b"", method="POST"))
        assert err.value.code == 409
        with urllib.request.urlopen(base + "/flightrecorder") as resp:
            assert len(json.loads(resp.read())["records"]) == 1
        with urllib.request.urlopen(base + "/healthz") as resp:
            assert json.loads(resp.read()) == {"ok": True}
    finally:
        srv.stop()
