"""The port's worker: ``train()`` and the CLI, on the CPU at tiny width.

- ``train(device="cpu")`` runs N steps through the ``sync_every`` window
  loop, writes the JSONL windows and the trace spans, runs the eval pass
  and returns a ``TrainResult``. (Its step against the JAX one on the
  same weights is tests/test_torch_trainstep.py.)
- The kernel tier resolves as in the JAX worker: CLI flag, then
  ``KFTPU_KERNEL_*`` env, then stock; ``kernel_attention`` on a
  non-transformer workload raises.
- ``train()`` and ``main()`` default to cuda and raise without a card;
  features not ported yet (AOT, multi-slice) raise "not yet ported" when
  set.
- Katib: under ``KFTPU_STUDY`` / ``KFTPU_TRIAL`` / ``KFTPU_VIZIER_URL``
  a port ``train()`` reports to a local ``VizierService`` the metric
  names a JAX ``train()`` of the same workload reports.
- Data parallel: two worker CLI processes given only the topology-
  contract env train resnet18 on CPU gloo with the sharded update and
  match the JAX package's step on a data = 2 mesh.
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
import socket
import subprocess
import sys
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
from kubeflow_tpu_torch.parallel.mesh import MESH_AXES, Mesh
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
                 "KFTPU_CHECKPOINT_DIR", "KFTPU_RESUME_FROM",
                 "KFTPU_INTEGRITY", "KFTPU_RESUME_STEP",
                 "KFTPU_CHAOS_NUMERIC", "KFTPU_STUDY", "KFTPU_POD_NAME",
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
    ({"aot": True}, None),
    ({"multislice_pipeline": True}, None),
])
def test_unported_features_raise(monkeypatch, kwargs, env):
    if env is not None:
        monkeypatch.setenv(*env)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        worker.train(steps=1, **KW, **kwargs)


def test_unported_layouts_and_schedules_raise(monkeypatch):
    """The sharded layout trains (on one replica it is the replicated
    update: the same losses); a global batch the data-parallel ranks do
    not divide raises before anything runs; the runtime schedule, from
    the env, trains (lr from the optimizer's state, on its device)."""
    sharded = worker.train(steps=2, weight_update="sharded", **KW)
    replicated = worker.train(steps=2, **KW)
    assert sharded.final_metrics["loss"] == \
        replicated.final_metrics["loss"]
    two = Mesh(shape={**dict.fromkeys(MESH_AXES, 1), "data": 2})
    ctx = bootstrap.WorkerContext(device=torch.device("cpu"), mesh=two)
    with pytest.raises(ValueError, match="not divisible"):
        worker.train(steps=1, ctx=ctx, **{**KW, "global_batch": 3})
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
    """A multi-process contract now brings up the gang
    (tests/test_torch_bootstrap.py); what it refuses is a sharding axis
    that is not ported, on every rank, citing the ROADMAP item. One
    process: the contract's ids, or this process alone without one."""
    from test_torch_bootstrap import _free_port as free_port
    from test_torch_bootstrap import _unported_axes, spawn_contract
    for msgs, left in spawn_contract(_unported_axes, 2, free_port()):
        assert not left and "item 6" in msgs[0], msgs
    env = {"KFTPU_TOPOLOGY": "v5e-1", "KFTPU_NUM_PROCESSES": "1",
           "KFTPU_PROCESS_ID": "0",
           "KFTPU_COORDINATOR_ADDRESS": f"localhost:{free_port()}"}
    ctx = bootstrap.initialize(env, device="cpu")
    try:
        assert (ctx.process_id, ctx.num_processes) == (0, 1)
    finally:
        bootstrap.shutdown(ctx)
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


# -- two worker processes from the contract env ---------------------------------

def _cli(args: list, env: dict) -> subprocess.Popen:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.runtime.worker", *args],
        cwd=repo, env={**env, "PYTHONPATH": repo, "OMP_NUM_THREADS": "2"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _losses(path: str) -> list:
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f
                if '"loss"' in line]


def _flax_tree(flat: dict) -> dict:
    """The port's dotted names back into flax's nested dict."""
    out: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.numpy()
    return out


def test_two_workers_from_the_contract_env_match_the_jax_worker(
        records, tmp_path):
    """Two ``python -m kubeflow_tpu_torch.runtime.worker`` processes,
    started with only the contract env, train resnet18 (the default exact-
    BN path, bf16 activations) at 32 px from the record shards on CPU gloo,
    sharded, 3 steps of a global batch of 8 (4 rows each, BatchNorm over
    all 8). Both write the same per-step losses (process 1 to
    ``m.p1.jsonl``), and they match the JAX package's sharded step on a
    data = 2 mesh on the same record batches from the port's seed-0 init
    (converted to flax), within rtol 3e-2, the bf16 bar of
    tests/test_torch_trainstep.py; and one worker process on the same
    flags within rtol 1e-2 (the same arithmetic in bf16, the BN sums and
    the gradients summed in another order)."""
    train_dir, _ = records
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KFTPU_")}
    port = _free_port()
    flags = ["--workload", "resnet18", "--device", "cpu", "--steps", "3",
             "--global-batch", "8", "--sync-every", "1", "--data-dir",
             train_dir, "--weight-update", "sharded", "--device-prefetch",
             "0"]
    ranks = [_cli(flags + ["--metrics-path", str(tmp_path / "m.jsonl")],
                  {**env, "KFTPU_TOPOLOGY": "v5e-2",
                   "KFTPU_COORDINATOR_ADDRESS": f"localhost:{port}",
                   "KFTPU_NUM_PROCESSES": "2", "KFTPU_PROCESS_ID": str(r)})
             for r in range(2)]
    one = _cli(flags + ["--metrics-path", str(tmp_path / "one.jsonl")], env)
    for p in ranks + [one]:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out[-3000:]
    got = _losses(str(tmp_path / "m.jsonl"))
    assert len(got) == 3 and got == _losses(str(tmp_path / "m.p1.jsonl"))
    np.testing.assert_allclose(got, _losses(str(tmp_path / "one.jsonl")),
                               rtol=1e-2)

    params, variables = TR.make_resnet(18, num_classes=CLASSES).init(
        torch.Generator().manual_seed(0))
    src = JI.ImageNetSource(train_dir, batch_size=8, output="uint8")
    try:
        it = src.batches(seed=0)
        batches = [next(it) for _ in range(3)]
    finally:
        src.close()
    inner = JR.make_loss_fn(JR.make_resnet(18, num_classes=CLASSES))

    def j_loss(p, v, batch, rng):
        batch = dict(batch, images=JI.device_normalize(batch["images"]))
        return inner(p, v, batch, rng)

    from kubeflow_tpu.api.trainingjob import ShardingSpec as JSpec
    jb = JBuilder(mesh=build_mesh(JSpec(data=2), jax.devices()[:2]),
                  loss_fn=j_loss, weight_update="sharded",
                  optimizer=j_make_optimizer("momentum", learning_rate=0.1,
                                             total_steps=3)[0])
    js = jb.init(lambda rng: (_flax_tree(params), {
        "batch_stats": _flax_tree(variables["batch_stats"])}),
        jax.random.PRNGKey(0))
    step = jb.build()
    want = []
    for b in batches:
        js, m = step(js, jb.place_batch(b))
        want.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=3e-2)


def _observed(svc, study: str, trial: str) -> dict:
    """metric → value of the observations a trial reported."""
    return svc.db.trial_metrics(study, trial)


def test_katib_observations_match_jax(monkeypatch):
    from kubeflow_tpu.katib.vizier import VizierService
    from kubeflow_tpu.runtime import worker as jworker
    from kubeflow_tpu_torch.katib import vizier as TV
    svc = VizierService()
    svc.db.create_study("s", objective_name="loss")
    port = svc.start()
    try:
        monkeypatch.setenv(TV.VIZIER_URL_ENV, f"http://127.0.0.1:{port}")
        monkeypatch.setenv(TV.STUDY_ENV, "s")
        monkeypatch.setenv(TV.TRIAL_ENV, "torch")
        r = worker.train(steps=2, sync_every=1, **KW)
        monkeypatch.setenv(TV.TRIAL_ENV, "jax")
        jworker.train(workload="transformer", steps=2, global_batch=8,
                      sync_every=1, optimizer="adam", learning_rate=1e-2,
                      handle_sigterm=False, workload_kwargs={})
        got, want = _observed(svc, "s", "torch"), _observed(svc, "s", "jax")
        assert set(got) == set(want)
        assert {"loss", "grad_norm", "examples_per_sec"} <= set(got)
        assert got["loss"] == pytest.approx(r.final_metrics["loss"])
        # a dead service warns and never fails the run
        svc.stop()
        monkeypatch.setenv(TV.TRIAL_ENV, "torch2")
        assert worker.train(steps=1, **KW).steps == 1
    finally:
        svc.stop()


class _StopAtStep2:
    """A guard whose stop flag turns True at its second read: SIGTERM
    arriving during step 2."""

    def __init__(self, install=True, on_term=None):
        self.reads = 0

    @property
    def stop(self):
        self.reads += 1
        return self.reads >= 2

    def uninstall(self):
        pass


@pytest.mark.parametrize("prefetch", [0, 2])
def test_record_fed_resume_continues_the_stream(records, tmp_path,
                                                monkeypatch, prefetch):
    """A run from record shards (LARS under the runtime cosine schedule)
    preempted at step 2 and resumed to step 5 reads batches 2, 3 and 4 of
    the seeded stream (no replay, no skip) with the schedule's state
    restored: its params equal an uninterrupted run's, bit for bit on the
    CPU."""
    from kubeflow_tpu_torch.cluster.chaos import final_params
    kw = dict(workload="resnet18", device="cpu", data_dir=records[0],
              global_batch=4, optimizer="lars", runtime_schedule=True,
              lr_schedule="cosine", warmup_steps=1, sync_every=1,
              checkpoint_every=100, device_prefetch=prefetch, seed=0,
              handle_sigterm=False, steps=5)
    clean, cut = str(tmp_path / "clean"), str(tmp_path / "cut")
    assert worker.train(checkpoint_dir=clean, **kw).steps == 5
    monkeypatch.setattr(worker, "PreemptionGuard", _StopAtStep2)
    first = worker.train(checkpoint_dir=cut, **kw)
    assert first.preempted and first.steps == 2
    monkeypatch.undo()
    assert worker.train(checkpoint_dir=cut, **kw).steps == 3
    a, b = final_params(clean, device="cpu"), final_params(cut, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
