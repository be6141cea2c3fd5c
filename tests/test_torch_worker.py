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
- From record shards (``data_dir``, at 32 px): one LARS step under the
  runtime schedule of the port's train step against the JAX package's on
  the same record batch, each through its own pipeline and
  ``device_normalize``, from converted weights; a resnet18 run through
  ``train()`` with a holdout (``eval_data_dir``), TensorBoard events, a
  profile and the flight recorder; the worker's ``/metrics`` port with
  ``POST /profile`` and ``GET /flightrecorder`` while it trains.
"""

import glob
import json
import logging
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.data import imagenet as JI
from kubeflow_tpu.models import resnet as JR
from kubeflow_tpu.parallel.mesh import build_mesh
from kubeflow_tpu.runtime.recipe import make_optimizer as j_make_optimizer
from kubeflow_tpu.runtime.trainstep import TrainStepBuilder as JBuilder
from kubeflow_tpu_torch.data import imagenet as TI
from kubeflow_tpu_torch.models import resnet as TR
from kubeflow_tpu_torch.models.convert import resnet_variables_from_jax
from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.obs import registry as obsreg
from kubeflow_tpu_torch.runtime import bootstrap, recipe, worker
from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder

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
                 "KFTPU_DATA_DIR", "KFTPU_EVAL_DATA_DIR", "KFTPU_PROFILE_DIR",
                 "KFTPU_OBS_METRICS_PORT", "KFTPU_TB_DIR",
                 "KFTPU_INPUT_WORKERS", "KFTPU_DEVICE_PREFETCH",
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
        worker.train(workload="transformer-pipelined", device="cpu")


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
    ({"multislice_pipeline": True}, None),
    ({}, ("KFTPU_CHECKPOINT_DIR", "/nonexistent")),
])
def test_unported_features_raise(monkeypatch, kwargs, env):
    if env is not None:
        monkeypatch.setenv(*env)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        worker.train(steps=1, **KW, **kwargs)


def test_unported_layouts_and_schedules_raise(monkeypatch):
    """The sharded layout still raises; the runtime schedule, from the
    env, now trains (lr from the optimizer's state, on its device)."""
    with pytest.raises(NotImplementedError, match="not yet ported"):
        worker.train(steps=1, weight_update="sharded", **KW)
    made = []
    real = recipe.make_optimizer

    def spy(*a, **kw):
        made.append(real(*a, **kw)[0])
        return made[-1], None

    monkeypatch.setattr(recipe, "make_optimizer", spy)
    monkeypatch.setenv("KFTPU_RUNTIME_SCHEDULE", "1")
    r = worker.train(steps=2, **{**KW, "optimizer": "rmsprop"},
                     lr_schedule="cosine", warmup_steps=1)
    assert r.steps == 2 and np.isfinite(r.final_metrics["loss"])
    (opt,) = made
    assert isinstance(opt.inner, recipe.ChainOptimizer)
    assert int(opt.inner.state["runtime_lr"]["count"]) == 2


def test_bootstrap_refuses_a_multi_process_contract():
    env = {"KFTPU_TOPOLOGY": "v5e-8", "KFTPU_NUM_PROCESSES": "2",
           "KFTPU_PROCESS_ID": "1"}
    with pytest.raises(NotImplementedError, match="not yet ported"):
        bootstrap.initialize(env, device="cpu")
    ctx = bootstrap.initialize({**env, "KFTPU_NUM_PROCESSES": "1",
                                "KFTPU_PROCESS_ID": "0"}, device="cpu")
    assert (ctx.process_id, ctx.num_processes) == (0, 1)
    assert bootstrap.initialize({}, device="cpu").process_id == 0


# -- real data: record shards --------------------------------------------------

SIZE, CLASSES = 32, 10


def _write(d, n, seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    labels = rng.integers(0, CLASSES, n)
    TI.write_shards(str(d), images, labels, shard_records=16,
                    num_classes=CLASSES)
    return str(d)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return (_write(tmp_path_factory.mktemp("train"), 40, 31),
            _write(tmp_path_factory.mktemp("holdout"), 10, 32))


def _numpy_variables(depth: int, seed: int):
    """A flax-shaped (params, batch_stats) of numpy arrays from a seed."""
    model = JR.make_resnet(depth, num_classes=CLASSES, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if name.endswith("kernel"):
            a = rng.standard_normal(leaf.shape) / np.sqrt(
                int(np.prod(leaf.shape[:-1])))
        elif name.endswith("scale"):
            a = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif name.endswith("var"):
            a = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            a = 0.1 * rng.standard_normal(leaf.shape)
        return a.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return v["params"], v["batch_stats"]


def test_record_step_with_runtime_lars_matches_jax(records):
    """Two steps of resnet18 from the same record batches, each package's
    uint8 pipeline and device_normalize in its loss, LARS under a cosine
    runtime schedule with warmup: the losses within rtol 1e-4 (the bar
    of tests/test_torch_trainstep.py), the second after LARS's update."""
    train_dir, _ = records
    params, stats = _numpy_variables(18, seed=6)
    opt = dict(learning_rate=0.1, schedule="cosine", total_steps=4,
               warmup_steps=1, weight_decay=1e-4, runtime_schedule=True)

    def take(cls):
        src = cls(train_dir, batch_size=8, output="uint8")
        try:
            it = src.batches(seed=2)
            return [next(it) for _ in range(2)]
        finally:
            src.close()

    j_batches, t_batches = take(JI.ImageNetSource), take(TI.ImageNetSource)
    for a, b in zip(j_batches, t_batches):
        assert a["images"].tobytes() == b["images"].tobytes()
        assert a["images"].dtype == np.uint8

    jm = JR.make_resnet(18, num_classes=CLASSES, dtype=jnp.float32)
    j_inner = JR.make_loss_fn(jm)

    def j_loss(p, v, batch, rng):
        batch = dict(batch, images=JI.device_normalize(batch["images"]))
        return j_inner(p, v, batch, rng)

    jb = JBuilder(mesh=build_mesh(devices=jax.devices()[:1]),
                  loss_fn=j_loss, optimizer=j_make_optimizer("lars", **opt)[0])
    js = jb.init(lambda rng: (params, {"batch_stats": stats}),
                 jax.random.PRNGKey(0))
    j_step = jb.build()

    tm = TR.make_resnet(18, num_classes=CLASSES, dtype=torch.float32)
    t_inner = TR.make_loss_fn(tm)

    def t_loss(p, v, batch, rng):
        batch = dict(batch, images=TI.device_normalize(batch["images"]))
        return t_inner(p, v, batch, rng)

    tb = TrainStepBuilder(
        loss_fn=t_loss, device="cpu",
        optimizer=lambda p: recipe.make_optimizer(p, "lars", **opt)[0])
    tp, ts = resnet_variables_from_jax(params, stats)
    t_state = tb.init(lambda rng: (tp, {"batch_stats": ts}), None)
    t_step = tb.build()
    for step, (jbat, tbat) in enumerate(zip(j_batches, t_batches)):
        js, jmet = j_step(js, jb.place_batch(jbat))
        t_state, tmet = t_step(t_state, tb.place_batch(tbat))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-4, err_msg=f"{k} {step}")


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
