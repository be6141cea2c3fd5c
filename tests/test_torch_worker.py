"""The port's worker: ``train()`` and the CLI, on the CPU at tiny width.

- ``train(device="cpu")`` runs N steps through the ``sync_every`` window
  loop, writes the JSONL windows and the trace spans, runs the eval pass
  and returns a ``TrainResult``. (Its step against the JAX one on the
  same weights is tests/test_torch_trainstep.py.)
- The kernel tier resolves as in the JAX worker: CLI flag, then
  ``KFTPU_KERNEL_*`` env, then stock; ``kernel_attention`` on a
  non-transformer workload raises.
- ``train()`` and ``main()`` default to cuda and raise without a card;
  features not ported yet raise "not yet ported" when set.
"""

import json
import logging

import pytest
import torch

from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.runtime import bootstrap, worker

TINY = TransformerConfig(vocab_size=64, num_layers=1, embed_dim=16,
                         num_heads=2, head_dim=8, mlp_dim=32, max_seq_len=16,
                         dtype=torch.float32)
KW = dict(workload="transformer", workload_kwargs={"cfg": TINY},
          optimizer="adam", learning_rate=1e-2, global_batch=2,
          device="cpu", handle_sigterm=False)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ("KFTPU_KERNEL_ATTENTION", "KFTPU_KERNEL_OPTIMIZER",
                 "KFTPU_KERNEL_SERVING", "KFTPU_WEIGHT_UPDATE",
                 "KFTPU_METRICS_PATH", "KFTPU_SPAN_PATH",
                 "KFTPU_RUNTIME_SCHEDULE", "KFTPU_TOPOLOGY",
                 *(env for env, _ in worker._UNPORTED.values())):
        monkeypatch.delenv(name, raising=False)


def _tier(caplog) -> str:
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("kernel tier:")]
    assert len(lines) == 1, lines
    return lines[0]


def test_train_on_cpu_writes_windows(tmp_path):
    path = tmp_path / "m" / "metrics.jsonl"
    spans = tmp_path / "spans.jsonl"
    r = worker.train(steps=5, sync_every=2, metrics_path=str(path),
                     span_path=str(spans), eval_every=5, eval_batches=2,
                     **KW)
    assert isinstance(r, worker.TrainResult)
    assert r.steps == 5 and not r.preempted and r.start_kind == "cold"
    assert r.time_to_first_step_s > 0 and r.mean_step_time_s > 0
    records = [json.loads(line) for line in path.read_text().splitlines()]
    windows = [rec for rec in records if not rec.get("event")]
    assert [w["step"] for w in windows] == [2, 4, 5]
    assert [w.get("window", 1) for w in windows] == [2, 2, 1]
    for w in windows:
        assert {"loss", "grad_norm", "perplexity", "learning_rate",
                "step_time_s", "examples_per_sec"} <= set(w)
    assert windows[-1]["loss"] < windows[0]["loss"]
    assert records[-1]["event"] and "eval_loss" in records[-1]["metrics"]
    assert r.final_metrics["loss"] == windows[-1]["loss"]
    assert "eval_token_accuracy" in r.final_metrics
    names = [json.loads(line)["name"] for line in
             spans.read_text().splitlines()]
    assert names[0] == "train-start" and names[-1] == "train-done"
    assert names.count("window") == 3


def test_kernel_tier_env_and_flag(monkeypatch, caplog):
    caplog.set_level(logging.INFO, logger=worker.log.name)
    monkeypatch.setenv("KFTPU_KERNEL_ATTENTION", "flash")
    monkeypatch.setenv("KFTPU_KERNEL_OPTIMIZER", "fused_adam")
    worker.train(steps=1, **KW)
    assert _tier(caplog) == ("kernel tier: attention=flash "
                             "optimizer=fused_adam serving=stock")
    caplog.clear()
    worker.train(steps=1, kernel_attention="einsum",
                 kernel_optimizer="stock", **KW)   # the flag wins
    assert _tier(caplog) == ("kernel tier: attention=einsum "
                             "optimizer=stock serving=stock")
    monkeypatch.setenv("KFTPU_KERNEL_OPTIMIZER", "fused")
    with pytest.raises(ValueError, match="kernels.optimizer"):
        worker.train(steps=1, **KW)


def test_fused_tier_requires_adam():
    with pytest.raises(ValueError, match="requires optimizer"):
        worker.train(steps=1, **{**KW, "optimizer": "momentum"},
                     kernel_optimizer="fused_adam")


def test_kernel_attention_on_other_workloads_raises():
    with pytest.raises(ValueError, match="transformer workloads"):
        worker.train(workload="resnet50", kernel_attention="flash",
                     device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        worker.train(workload="resnet50", device="cpu")


def test_main_runs_on_cpu(tmp_path):
    path = tmp_path / "metrics.jsonl"
    rc = worker.main(["--workload", "transformer", "--device", "cpu",
                      "--steps", "2", "--global-batch", "2",
                      "--optimizer", "adam", "--learning-rate", "1e-3",
                      "--kernel-attention", "flash", "--sync-every", "1",
                      "--metrics-path", str(path)])
    assert rc == 0
    assert len(path.read_text().splitlines()) == 2


def test_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.train(workload="transformer", steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        worker.main(["--workload", "transformer", "--steps", "1"])


@pytest.mark.parametrize("kwargs,env", [
    ({"checkpoint_dir": "/nonexistent"}, None),
    ({"aot": True}, None),
    ({"integrity": True}, None),
    ({"data_dir": "/nonexistent"}, None),
    ({"profile_dir": "/nonexistent"}, None),
    ({"multislice_pipeline": True}, None),
    ({}, ("KFTPU_CHECKPOINT_DIR", "/nonexistent")),
    ({}, ("KFTPU_OBS_METRICS_PORT", "9100")),
])
def test_unported_features_raise(monkeypatch, kwargs, env):
    if env is not None:
        monkeypatch.setenv(*env)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        worker.train(steps=1, **KW, **kwargs)


def test_unported_layouts_and_schedules_raise(monkeypatch):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        worker.train(steps=1, weight_update="sharded", **KW)
    monkeypatch.setenv("KFTPU_RUNTIME_SCHEDULE", "1")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        worker.train(steps=1, **KW)


def test_bootstrap_refuses_a_multi_process_contract():
    env = {"KFTPU_TOPOLOGY": "v5e-8", "KFTPU_NUM_PROCESSES": "2",
           "KFTPU_PROCESS_ID": "1"}
    with pytest.raises(NotImplementedError, match="not yet ported"):
        bootstrap.initialize(env, device="cpu")
    ctx = bootstrap.initialize({**env, "KFTPU_NUM_PROCESSES": "1",
                                "KFTPU_PROCESS_ID": "0"}, device="cpu")
    assert (ctx.process_id, ctx.num_processes) == (0, 1)
    assert bootstrap.initialize({}, device="cpu").process_id == 0
