"""The worker trained from record shards through ``train()``
(tests/test_torch_worker.py holds the rest of the worker, the shards'
fixture and the step against the JAX package's;
tests/test_torch_worker_resume.py the record-fed resume): a resnet18
run with a holdout (``eval_data_dir``), TensorBoard events, a profile
and the flight recorder; the worker's ``/metrics`` port with ``POST
/profile`` and ``GET /flightrecorder`` while it trains.
"""

import glob
import json
import os
import urllib.request

import numpy as np

from kubeflow_tpu_torch.data import imagenet as TI
from kubeflow_tpu_torch.obs import registry as obsreg
from kubeflow_tpu_torch.runtime import worker
from tests.test_torch_worker import records  # noqa: F401 - the fixture


def _counter(name, **labels):
    fam = obsreg.counter(name, "", labels=tuple(labels))
    return fam.labels(**labels).value


def test_train_from_records_with_holdout_on_cpu(records, tmp_path):
    """resnet18 at 32 px from records (in-process native augment,
    prefetch 2), LARS under the runtime schedule, the full holdout of 10
    records at batch 8 (8 + 2 padded to 8) evaluated once at the end;
    windows, TensorBoard events, a whole-run profile, spans."""
    train_dir, holdout = records
    staged = _counter("kftpu_input_batches_total", stage="device_put")
    native = _counter(TI.IMPL_COUNTER, stage="augment", impl="native")
    path, spans = tmp_path / "m.jsonl", tmp_path / "spans.jsonl"
    r = worker.train(
        workload="resnet18", device="cpu", steps=4, global_batch=8,
        sync_every=2, data_dir=train_dir, eval_data_dir=holdout,
        eval_every=4, eval_batches=0, optimizer="lars", learning_rate=0.1,
        lr_schedule="cosine", warmup_steps=1, runtime_schedule=True,
        device_prefetch=2, tensorboard_dir=str(tmp_path / "tb"),
        profile_dir=str(tmp_path / "prof"), metrics_path=str(path),
        span_path=str(spans), handle_sigterm=False)
    assert r.steps == 4
    records_ = [json.loads(line) for line in path.read_text().splitlines()]
    windows = [w for w in records_ if not w.get("event")]
    assert [w["step"] for w in windows] == [2, 4]
    assert all(np.isfinite(w["loss"]) for w in windows)
    (ev,) = [w for w in records_ if w.get("event")]
    assert ev["metrics"]["eval_examples"] == 10.0
    assert r.final_metrics["eval_examples"] == 10.0
    assert 0.0 <= r.final_metrics["top1"] <= 1.0
    assert _counter("kftpu_input_batches_total",
                    stage="device_put") - staged >= 4
    assert _counter(TI.IMPL_COUNTER, stage="augment",
                    impl="native") - native >= 4
    assert glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    (trace,) = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    with open(trace) as f:
        assert json.load(f)["traceEvents"]
    names = [json.loads(line)["name"] for line in
             spans.read_text().splitlines()]
    assert names[0] == "train-start" and names[-1] == "train-done"
    assert names.count("window") == 2 and "profile" in names


def test_obs_metrics_port_profiles_and_records_while_training(
        records, tmp_path, monkeypatch):
    """KFTPU_OBS_METRICS_PORT starts /metrics; from inside the loop (the
    second step) a client arms POST /profile?steps=2 and reads
    /flightrecorder and /metrics; the capture lands under
    KFTPU_PROFILE_DIR. Spawned augment workers, no device prefetch."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    monkeypatch.setenv("KFTPU_OBS_METRICS_PORT", str(port))
    monkeypatch.setenv("KFTPU_PROFILE_DIR", str(tmp_path / "profiles"))
    seen = {}
    base = f"http://127.0.0.1:{port}"

    class Arm(worker.ProfileArm):
        def on_step_start(self):
            if "armed" not in seen:
                fr = json.loads(urllib.request.urlopen(
                    base + "/flightrecorder").read())
                if fr["records"]:       # the first window has closed
                    seen["fr"] = fr
                    req = urllib.request.Request(
                        base + "/profile?steps=2", data=b"", method="POST")
                    seen["armed"] = json.loads(
                        urllib.request.urlopen(req).read())
                    seen["metrics"] = urllib.request.urlopen(
                        base + "/metrics").read().decode()
            super().on_step_start()

    monkeypatch.setattr(worker, "ProfileArm", Arm)
    r = worker.train(
        workload="resnet18", device="cpu", steps=6, global_batch=8,
        sync_every=1, data_dir=records[0], input_workers=2,
        device_prefetch=0, handle_sigterm=False)
    assert r.steps == 6
    fr = seen["fr"]["records"]
    assert {"data_s", "h2d_s", "dispatch_s", "drain_s", "device_wait_s",
            "input_batches"} <= set(fr[0])
    assert fr[0]["first_step_s"] > 0
    armed = seen["armed"]
    assert armed["armed"] and armed["steps"] == 2
    assert armed["dir"].startswith(str(tmp_path / "profiles"))
    assert glob.glob(os.path.join(armed["dir"], "*.pt.trace.json"))
    text = seen["metrics"]
    assert 'kftpu_input_batches_total{stage="augment"}' in text
    assert "kftpu_step_seconds" in text
