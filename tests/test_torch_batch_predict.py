"""The port's batch-predict job against the JAX package's, on the CPU.

- The counterpart of tests/test_serving.py's batch-predict cases over a
  servable that doubles its input: JSONL and .npy inputs, a padded tail,
  one record per row, the summary line, and FileNotFoundError when no
  input matches.
- ``run_batch_predict`` over the resnet servable (resnet50, 10 classes,
  32 px, the variables of tests/test_torch_serving_resnet.py) against the
  JAX job over the JAX servable: the same records (source, index,
  requestId, prediction keys), ``classes`` equal and logits within 3e-2 of
  the largest logit (that file's bar).
- ``main`` end to end on the CPU over a 2-row .npy, and the compile-cache
  variable giving a warning, not a failure.
"""

import json
import logging

import numpy as np
import pytest
import torch

from kubeflow_tpu.serving import batch_predict as JB
from kubeflow_tpu_torch.serving import batch_predict as TB
from kubeflow_tpu_torch.serving import run_batch_predict
from kubeflow_tpu_torch.serving import servable as TS
from tests.test_torch_serving_resnet import (LOGIT_TOL, images,  # noqa: F401
                                             servables, variables)


def _double() -> TS.Servable:
    return TS.Servable(
        name="double", predict_fn=lambda p, x: {"y": x * p["w"]},
        params={"w": torch.full((4,), 2.0)},
        input_signature={"inputs": {"shape": [-1, 4], "dtype": "float32"}},
        device="cpu")


def _records(path) -> tuple[list, dict]:
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    return [r for r in lines if "prediction" in r], lines[-1]["summary"]


def test_batch_predict_jsonl_and_npy(tmp_path):
    jsonl = tmp_path / "in.jsonl"
    with jsonl.open("w") as f:
        for i in range(5):
            f.write(json.dumps({"instance": [float(i)] * 4}) + "\n")
    np.save(tmp_path / "in.npy", np.ones((3, 4), np.float32))
    out = tmp_path / "preds.jsonl"
    summary = run_batch_predict(
        _double(), [str(jsonl), str(tmp_path / "in.npy")], str(out),
        batch_size=4, input_dtype="float32", request_id="rid")
    assert summary["instances"] == 8 and summary["files"] == 2
    preds, last = _records(out)
    assert len(preds) == 8 and last == summary
    np.testing.assert_allclose(preds[1]["prediction"]["y"], [2.0] * 4)
    assert [p["index"] for p in preds] == list(range(8))
    assert {p["requestId"] for p in preds} == {"rid"}
    assert [p["source"] for p in preds] == [str(jsonl)] * 5 + [
        str(tmp_path / "in.npy")] * 3


def test_batch_predict_no_inputs(tmp_path):
    with pytest.raises(FileNotFoundError):
        run_batch_predict(_double(), [str(tmp_path / "*.npy")],
                          str(tmp_path / "o"))


def test_resnet_batch_predict_matches_jax(tmp_path, servables):
    """7 rows at batch size 4 (one full batch and a padded tail) from an
    .npz, through both jobs."""
    js, ts = servables
    np.savez(tmp_path / "in.npz", images=images(7, seed=30))
    pattern = [str(tmp_path / "*.npz")]
    j_sum = JB.run_batch_predict(js, pattern, str(tmp_path / "j.jsonl"),
                                 batch_size=4, request_id="r")
    t_sum = TB.run_batch_predict(ts, pattern, str(tmp_path / "t.jsonl"),
                                 batch_size=4, request_id="r")
    for k in ("instances", "files", "model", "version", "requestId"):
        assert t_sum[k] == j_sum[k], k
    j_recs, _ = _records(tmp_path / "j.jsonl")
    t_recs, _ = _records(tmp_path / "t.jsonl")
    assert len(t_recs) == len(j_recs) == 7
    lj = np.array([r["prediction"]["logits"] for r in j_recs])
    lt = np.array([r["prediction"]["logits"] for r in t_recs])
    assert np.abs(lt - lj).max() <= LOGIT_TOL * np.abs(lj).max()
    for a, b in zip(t_recs, j_recs):
        assert a["prediction"]["classes"] == b["prediction"]["classes"]
        assert {k: a[k] for k in ("source", "index", "requestId")} == \
            {k: b[k] for k in ("source", "index", "requestId")}
        assert set(a["prediction"]) == set(b["prediction"])


def test_main_on_the_cpu(tmp_path, capsys):
    np.save(tmp_path / "x.npy", np.random.default_rng(0).standard_normal(
        (2, 224, 224, 3)).astype(np.float32))
    out = tmp_path / "out.jsonl"
    assert TB.main(["--model-type", "resnet18", "--device", "cpu",
                    "--batch-size", "2", "--input-file-patterns",
                    str(tmp_path / "*.npy"), "--output-result-file",
                    str(out)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["instances"] == 2 and summary["model"] == "model"
    preds, last = _records(out)
    assert last == summary
    assert [len(p["prediction"]["logits"]) for p in preds] == [1000, 1000]
    assert all(0 <= p["prediction"]["classes"] < 1000 for p in preds)


def test_main_refuses_a_model_path(tmp_path):
    """``--model-path`` no longer refuses: the job predicts with the
    params and batch statistics of the directory's newest intact step
    (here seeded ResNet-18 variables saved as a trainer's tree at step
    3), as a direct predict with the same variables does."""
    from kubeflow_tpu_torch.models import resnet as TR
    from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
    params, variables = TR.make_resnet(18).init(
        torch.Generator().manual_seed(3))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, {"step": 3, "params": params, "variables": variables},
             force=True)
    mgr.close()
    x = np.random.default_rng(0).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    out = tmp_path / "o.jsonl"
    assert TB.main(["--model-type", "resnet18", "--device", "cpu",
                    "--model-path", str(tmp_path / "ckpt"),
                    "--batch-size", "2", "--input-file-patterns",
                    str(tmp_path / "x.npy"), "--output-result-file",
                    str(out)]) == 0
    preds, summary = _records(out)
    ref = TS.ModelRepository().load("r", "resnet18", device="cpu")
    ref.swap({"params": params, **variables}, 3)
    want = ref.predict(x)
    np.testing.assert_allclose(
        [p["prediction"]["logits"] for p in preds], want["logits"],
        rtol=1e-5, atol=1e-5)
    assert summary["instances"] == 2 and summary["version"] == 3


def test_compile_cache_env_warns_and_goes_on(tmp_path, monkeypatch,
                                             caplog):
    """The job enables the kernel build cache at $KFTPU_COMPILE_CACHE_DIR;
    a cache volume it cannot use (here a path under a regular file) only
    warns, and the job goes on."""
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.runtime import compile_cache as CC
    monkeypatch.setattr(_build, "_cache_dir", None)
    monkeypatch.setattr(CC, "_active", None)
    (tmp_path / "file").write_text("")
    monkeypatch.setenv("KFTPU_COMPILE_CACHE_DIR",
                       str(tmp_path / "file" / "cache"))
    np.save(tmp_path / "x.npy", np.zeros((1, 224, 224, 3), np.float32))
    with caplog.at_level(logging.WARNING,
                         logger="kubeflow_tpu_torch.runtime.compile_cache"):
        assert TB.main(["--model-type", "resnet18", "--device", "cpu",
                        "--batch-size", "1", "--input-file-patterns",
                        str(tmp_path / "x.npy"), "--output-result-file",
                        str(tmp_path / "o.jsonl")]) == 0
    assert "compilation cache disabled" in caplog.text and \
        str(tmp_path / "file" / "cache") in caplog.text
    assert _build.build_dir() == _build.BUILD_DIR
    preds, summary = _records(tmp_path / "o.jsonl")
    assert len(preds) == 1 and summary["instances"] == 1
