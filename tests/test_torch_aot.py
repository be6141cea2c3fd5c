"""The port's AOT warm start on the CPU: the keyed step record, the step
object of ``TrainStepBuilder.build_compiled`` and the worker's ladder.

- The record (runtime/aot.py): a round trip; every fallback counted
  under the reference's outcome names (absent ``miss``; unreadable or
  truncated ``corrupt``; another key ``key-mismatch``; another signature
  ``signature-mismatch``; a named kernel library missing, of another
  digest or of other sources ``deserialize-failed``); a failed export
  downgrades (``export-failed``) and leaves no tmp file; the record
  carries its key, signature, libraries and static inputs. These mirror
  tests/test_warmstart.py's TestAotLadder.
- ``step_key``: deterministic, sensitive to each field, with the
  reference's field names except the framework's versions.
- The worker's ladder on a tiny LM: cold exports, the next run hits
  ("aot"), a corrupt or mismatched record falls back and trains, no
  directory warns, lr-variant trials under the runtime schedule share one
  record, a changed shape misses, SGD momentum under a host schedule
  captures, an optimizer without a device-side update counts
  ``export-failed`` and trains eagerly. These mirror
  tests/test_warmstart.py's TestWorkerWarmStart.
- Parity: the port's aot-resumed run equals its cold run exactly, and
  both match the JAX package's ``train()`` (aot off) over 3 steps from
  converted weights on the same tokens, losses within rtol 1e-4 (the bar
  of tests/test_torch_worker.py's parity tests).
- The step object's plumbing on the CPU (where it runs its body eagerly
  through the same static buffers and copy-backs as a replay): a tiny
  BatchNorm ResNet equals the eager step over 4 steps with every variable
  kept in its own storage (the fixed point); a ``load_state_tree``
  restore into the state it holds trains from the restored values, in
  the same storage; the lagged window fetch keeps each window's values;
  an async checkpoint save taken between two steps holds the saved
  step's values.
"""

import dataclasses
import json
import os
import pickle
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import transformer as J
from kubeflow_tpu.runtime import worker as jworker
from kubeflow_tpu_torch.models import resnet as TR
from kubeflow_tpu_torch.models import transformer as T
from kubeflow_tpu_torch.models.convert import transformer_params_from_jax
from kubeflow_tpu_torch.obs import registry as obsreg
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.runtime import aot, recipe, trainstep, worker
from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
from kubeflow_tpu_torch.runtime.metrics import AsyncWindowFetch

TINY = T.TransformerConfig(vocab_size=64, num_layers=2, embed_dim=16,
                           num_heads=2, head_dim=8, mlp_dim=32,
                           max_seq_len=16, dtype=torch.float32)
KW = dict(workload="transformer", workload_kwargs={"cfg": TINY},
          optimizer="adam", learning_rate=1e-2, global_batch=2,
          sync_every=2, seed=0, device="cpu", handle_sigterm=False)
OUTCOMES = ("miss", "corrupt", "key-mismatch", "signature-mismatch",
            "deserialize-failed", "hit", "export", "export-failed")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in (aot.AOT_ENABLE_ENV, aot.AOT_DIR_ENV, "KFTPU_CHECKPOINT_DIR",
                 "KFTPU_COMPILE_CACHE_DIR", "KFTPU_RUNTIME_SCHEDULE",
                 "KFTPU_KERNEL_ATTENTION", "KFTPU_KERNEL_OPTIMIZER",
                 "KFTPU_TOPOLOGY", "KFTPU_METRICS_PATH", "KFTPU_SPAN_PATH"):
        monkeypatch.delenv(name, raising=False)


def outcomes() -> dict:
    fam = obsreg.counter("kftpu_aot_executable_total", "",
                         labels=("outcome",))
    return {o: fam.labels(outcome=o).value for o in OUTCOMES}


def counted(before: dict) -> dict:
    """The outcomes counted since ``before``."""
    return {o: n - before[o] for o, n in outcomes().items() if n != before[o]}


def _builder(opt="adam", **kw):
    spec = T.workload_spec(cfg=TINY)
    b = trainstep.TrainStepBuilder(
        loss_fn=spec.loss_fn, device="cpu",
        optimizer=lambda p: recipe.make_optimizer(
            p, opt, 1e-2, total_steps=8, **kw)[0])
    return spec, b


@pytest.fixture
def compiled():
    spec, b = _builder()
    state = b.init(spec.init_fn, torch.Generator().manual_seed(0))
    batch = b.place_batch(spec.batch_fn(torch.Generator().manual_seed(1), 2))
    step = b.build_compiled(state, batch)
    return step, aot.abstract_signature(state, batch), state, batch


# -- the record ---------------------------------------------------------------

class TestRecord:
    def test_roundtrip(self, tmp_path, compiled):
        step, sig, state, batch = compiled
        before = outcomes()
        path = aot.export_step(str(tmp_path), "k" * 24, step, sig)
        assert path and os.path.exists(path)
        record = aot.load_step(str(tmp_path), "k" * 24, sig)
        assert record is not None
        assert record["static_inputs"] == step.static_inputs
        assert counted(before) == {"export": 1, "hit": 1}
        state, m = step(state, batch)     # the step it exported runs
        assert torch.isfinite(m["loss"])

    def test_absent_file_is_a_miss(self, tmp_path, compiled):
        _, sig, _, _ = compiled
        before = outcomes()
        assert aot.load_step(str(tmp_path), "nope" * 6, sig) is None
        assert counted(before) == {"miss": 1}

    @pytest.mark.parametrize("damage", ["garbage", "truncated"])
    def test_unreadable_record_is_corrupt(self, tmp_path, compiled, damage):
        step, sig, _, _ = compiled
        path = aot.export_step(str(tmp_path), "c" * 24, step, sig)
        blob = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(b"\x00garbage, not a pickle" if damage == "garbage"
                    else blob[:len(blob) // 2])
        before = outcomes()
        assert aot.load_step(str(tmp_path), "c" * 24, sig) is None
        assert counted(before) == {"corrupt": 1}

    def test_key_mismatch_falls_back(self, tmp_path, compiled):
        step, sig, _, _ = compiled
        aot.export_step(str(tmp_path), "a" * 24, step, sig)
        os.rename(aot._path(str(tmp_path), "a" * 24),
                  aot._path(str(tmp_path), "b" * 24))
        before = outcomes()
        assert aot.load_step(str(tmp_path), "b" * 24, sig) is None
        assert counted(before) == {"key-mismatch": 1}

    def test_format_mismatch_falls_back(self, tmp_path, compiled,
                                        monkeypatch):
        step, sig, _, _ = compiled
        monkeypatch.setattr(aot, "_FORMAT", 0)
        aot.export_step(str(tmp_path), "o" * 24, step, sig)
        monkeypatch.undo()
        before = outcomes()
        assert aot.load_step(str(tmp_path), "o" * 24, sig) is None
        assert counted(before) == {"key-mismatch": 1}

    def test_signature_mismatch_falls_back(self, tmp_path, compiled):
        step, sig, state, batch = compiled
        aot.export_step(str(tmp_path), "s" * 24, step, sig)
        other = aot.abstract_signature(
            state, {"tokens": batch["tokens"][:1]})
        assert other != sig
        before = outcomes()
        assert aot.load_step(str(tmp_path), "s" * 24, other) is None
        assert counted(before) == {"signature-mismatch": 1}

    @pytest.mark.parametrize("fault", [None, "missing", "digest",
                                       "sources"])
    def test_recorded_libraries(self, tmp_path, compiled, monkeypatch,
                                fault):
        """The record's kernel libraries load from the build cache by
        name and digest (here a stand-in file, ctypes faked); a library
        that is missing, of another digest or not the build of this
        checkout's sources would need nvcc: deserialize-failed."""
        step, sig, _, _ = compiled
        cache = tmp_path / "cache"
        cache.mkdir()
        monkeypatch.setattr(_build, "_cache_dir", str(cache))
        monkeypatch.setattr(_build, "_loaded", {})
        monkeypatch.setattr(_build, "_loaded_paths", {})
        loads = []
        monkeypatch.setattr(_build.ctypes, "CDLL",
                            lambda p: loads.append(p) or object())
        lib = _build.library_path("fused_adam")
        with open(lib, "wb") as f:
            f.write(b"a shared library")
        _build.load_library("fused_adam")       # a hit: in the record
        aot.export_step(str(tmp_path), "l" * 24, step, sig)
        record = pickle.load(open(aot._path(str(tmp_path), "l" * 24), "rb"))
        name, file_name, digest = record["libraries"][0]
        assert (name, file_name) == ("fused_adam", os.path.basename(lib))
        assert digest == _build.file_digest(lib)
        _build.set_cache_dir(str(cache))        # a new process's cache
        if fault == "missing":
            os.remove(lib)
        elif fault == "digest":
            with open(lib, "ab") as f:
                f.write(b", rebuilt")
        elif fault == "sources":
            record["libraries"] = [(name, "fused_adam-0000.so", digest)]
            with open(aot._path(str(tmp_path), "l" * 24), "wb") as f:
                pickle.dump(record, f)
        before = outcomes()
        got = aot.load_step(str(tmp_path), "l" * 24, sig)
        if fault is None:
            assert got is not None and counted(before) == {"hit": 1}
            assert loads[-1] == lib and _build._loaded_paths == \
                {"fused_adam": lib}
        else:
            assert got is None
            assert counted(before) == {"deserialize-failed": 1}
        _build.set_cache_dir(None)

    def test_export_failure_downgrades(self, tmp_path, compiled):
        step, sig, _, _ = compiled
        blocker = tmp_path / "blocked"
        blocker.write_text("x")
        before = outcomes()
        assert aot.export_step(str(blocker / "aot"), "e" * 24, step,
                               sig) is None
        assert counted(before) == {"export-failed": 1}

    def test_atomic_export_leaves_no_tmp(self, tmp_path, compiled):
        step, sig, _, _ = compiled
        aot.export_step(str(tmp_path), "f" * 24, step, sig)
        assert os.listdir(tmp_path) == [f"step-{'f' * 24}.aotx"]

    def test_record_carries_key_and_signature(self, tmp_path, compiled):
        step, sig, state, batch = compiled
        path = aot.export_step(str(tmp_path), "r" * 24, step, sig)
        with open(path, "rb") as f:
            record = pickle.load(f)
        assert record["key"] == "r" * 24 and record["signature"] == sig
        assert record["libraries"] == []       # none load on the CPU
        assert record["static_inputs"] == trainstep.static_input_names(
            state, batch)
        leaves = [name for name, _, _ in sig["args"][0]["leaves"]]
        assert "params/head.kernel" in leaves and "step" in leaves


# -- step_key -------------------------------------------------------------------

class TestStepKey:
    BASE = dict(topology="h100-8", num_slices=1, model_fingerprint="m1",
                weight_update="replicated", sharding={"data": 8},
                global_batch=64, kernels={"attention": "flash"})

    def test_deterministic_and_sensitive(self):
        k = aot.step_key(**self.BASE)
        assert k == aot.step_key(**self.BASE) and len(k) == 24
        for field, value in (("topology", "h100-4"), ("num_slices", 2),
                             ("model_fingerprint", "m2"),
                             ("weight_update", "sharded"),
                             ("sharding", {"data": 4, "fsdp": 2}),
                             ("global_batch", 128),
                             ("kernels", {"attention": "einsum"}),
                             ("extra", {"stage": 1})):
            assert aot.step_key(**{**self.BASE, field: value}) != k, field

    def test_framework_versions_rotate_the_key(self, monkeypatch):
        k = aot.step_key(**self.BASE)
        for target, name, value in (
                (torch, "__version__", "0.0"),
                (torch.version, "cuda", "0.0"),
                (aot._build, "nvcc_release", lambda: "release 0.0"),
                (aot, "_device_kind", lambda device=None: "another card")):
            with monkeypatch.context() as m:
                m.setattr(target, name, value)
                assert aot.step_key(**self.BASE) != k, name

    def test_field_names_are_the_references(self):
        parts = aot.step_key_parts(**self.BASE)
        reference = {"topology", "numSlices", "model", "weightUpdate",
                     "sharding", "globalBatch", "kernels", "format",
                     "jax", "jaxlib", "platform", "deviceKind"}
        assert set(parts) == (reference - {"jax", "jaxlib", "platform"}) \
            | {"torch", "cuda", "nvcc"}
        assert parts["deviceKind"] in ("cpu",) or torch.cuda.is_available()

    def test_default_aot_dir(self):
        assert aot.default_aot_dir("/ckpt/") == "/ckpt/.jax-aot-executables"
        assert aot.AOT_SUBDIR == ".jax-aot-executables"


# -- the worker's ladder --------------------------------------------------------

def _files(d) -> list:
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


class TestWorkerLadder:
    def test_cold_exports_then_aot_hits(self, tmp_path):
        d = str(tmp_path / "aot")
        before = outcomes()
        r1 = worker.train(steps=3, aot=True, aot_dir=d, **KW)
        assert r1.start_kind == "cold" and r1.steps == 3
        assert counted(before) == {"miss": 1, "export": 1}
        assert len(_files(d)) == 1
        before = outcomes()
        r2 = worker.train(steps=3, aot=True, aot_dir=d, **KW)
        assert r2.start_kind == "aot" and counted(before) == {"hit": 1}
        assert r2.final_metrics["loss"] == r1.final_metrics["loss"]
        r3 = worker.train(steps=3, **KW)          # eager: the same numbers
        assert r3.start_kind == "cold"
        assert r3.final_metrics["loss"] == r1.final_metrics["loss"]

    def test_env_and_default_dir_beside_the_checkpoints(self, tmp_path,
                                                        monkeypatch):
        monkeypatch.setenv(aot.AOT_ENABLE_ENV, "1")
        ck = tmp_path / "ck"
        r = worker.train(steps=2, checkpoint_dir=str(ck), **KW)
        assert r.start_kind == "cold"
        assert len(_files(aot.default_aot_dir(str(ck)))) == 1

    @pytest.mark.parametrize("damage", ["corrupt", "key-mismatch"])
    def test_bad_record_falls_back_and_trains(self, tmp_path, damage):
        d = tmp_path / "aot"
        worker.train(steps=2, aot=True, aot_dir=str(d), **KW)
        (path,) = list(d.iterdir())
        if damage == "corrupt":
            path.write_bytes(path.read_bytes()[:40])
        else:
            record = pickle.loads(path.read_bytes())
            record["key"] = "x" * 24
            path.write_bytes(pickle.dumps(record))
        before = outcomes()
        r = worker.train(steps=2, aot=True, aot_dir=str(d), **KW)
        assert r.steps == 2 and r.start_kind == "cold"   # no cache: cold
        # the record is replaced by this run's capture
        assert counted(before) == {damage: 1, "export": 1}

    @pytest.mark.parametrize("where", ["capture", "first replay"])
    def test_a_loaded_record_that_fails_runs_eager(self, tmp_path,
                                                   monkeypatch, where):
        """The last rungs: a record that passed its checks but whose step
        does not capture, or fails at its first replay, is logged,
        counted (deserialize-failed) and the eager step trains."""
        d = str(tmp_path / "aot")
        ref = worker.train(steps=3, aot=True, aot_dir=d, **KW)

        def broken(*args, **kwargs):
            raise RuntimeError("a stale artifact")

        monkeypatch.setattr(
            trainstep.TrainStepBuilder if where == "capture"
            else trainstep.CompiledStep,
            "build_compiled" if where == "capture" else "__call__", broken)
        before = outcomes()
        r = worker.train(steps=3, aot=True, aot_dir=d, **KW)
        assert r.steps == 3 and r.start_kind == "cold"
        assert counted(before) == {"hit": 1, "deserialize-failed": 1}
        assert r.final_metrics["loss"] == ref.final_metrics["loss"]

    def test_changed_batch_misses(self, tmp_path):
        d = str(tmp_path / "aot")
        worker.train(steps=2, aot=True, aot_dir=d, **KW)
        before = outcomes()
        r = worker.train(steps=2, aot=True, aot_dir=d,
                         **{**KW, "global_batch": 4})
        assert r.start_kind != "aot" and len(_files(d)) == 2
        assert counted(before) == {"miss": 1, "export": 1}

    def test_aot_without_dir_degrades_with_warning(self, caplog):
        with caplog.at_level("WARNING", logger=worker.log.name):
            r = worker.train(steps=2, aot=True, **KW)
        assert r.steps == 2 and r.start_kind == "cold"
        assert any("no --aot-dir" in rec.getMessage()
                   for rec in caplog.records)

    def test_lr_variant_trials_share_one_record(self, tmp_path):
        d = tmp_path / "aot"
        kw = {**KW, "optimizer": "momentum", "lr_schedule": "cosine",
              "runtime_schedule": True}
        r1 = worker.train(steps=4, aot=True, aot_dir=str(d),
                          **{**kw, "learning_rate": 0.1})
        assert r1.start_kind == "cold" and len(_files(d)) == 1
        r2 = worker.train(steps=6, aot=True, aot_dir=str(d),
                          **{**kw, "learning_rate": 0.37})
        assert r2.start_kind == "aot" and len(_files(d)) == 1
        # the runtime schedule is a program of its own: never aliased
        worker.train(steps=4, aot=True, aot_dir=str(d),
                     **{**kw, "runtime_schedule": False,
                        "lr_schedule": "constant"})
        assert len(_files(d)) == 2

    def test_experts_and_remat_rekey_the_record(self, tmp_path):
        """``num_experts`` and ``remat`` are in the workload kwargs the
        key hashes: each makes a record of its own, and the MoE + remat
        step (a CompiledStep; captured on the card,
        tests/test_torch_gpu.py) trains to the eager step's loss."""
        d = tmp_path / "aot"
        worker.train(steps=2, aot=True, aot_dir=str(d), **KW)
        moe = replace(TINY, num_experts=2)
        runs = []
        for cfg in (moe, replace(moe, remat=True)):
            kw = {**KW, "workload_kwargs": {"cfg": cfg}}
            before = outcomes()
            r = worker.train(steps=2, aot=True, aot_dir=str(d), **kw)
            assert counted(before) == {"miss": 1, "export": 1}
            assert r.final_metrics["loss"] == worker.train(
                steps=2, **kw).final_metrics["loss"]
            runs.append(r.final_metrics["loss"])
        assert len(_files(d)) == 3
        assert runs[0] == runs[1]      # remat: the same function

    def test_uncapturable_family_counts_export_failed(self, tmp_path):
        """SGD momentum under a host cosine schedule, once the family no
        capture could hold, captures: its lr is a device buffer that
        ``runtime/recipe.py`` ``SGD`` reads on a card (the CPU
        keeps the host lr, as for Adam). The cold run exports, the rebind
        reads "aot", and both equal the eager run."""
        d = tmp_path / "aot"
        kw = {**KW, "optimizer": "momentum", "lr_schedule": "cosine"}
        before = outcomes()
        cold = worker.train(steps=3, aot=True, aot_dir=str(d), **kw)
        assert cold.start_kind == "cold"
        assert counted(before) == {"miss": 1, "export": 1}
        before = outcomes()
        r = worker.train(steps=3, aot=True, aot_dir=str(d), **kw)
        assert r.steps == 3 and r.start_kind == "aot"
        assert counted(before) == {"hit": 1}
        assert len(_files(d)) == 1
        assert r.final_metrics["loss"] == cold.final_metrics["loss"] == \
            worker.train(steps=3, **kw).final_metrics["loss"]

    def test_step_without_device_update_counts_export_failed(
            self, tmp_path, caplog, monkeypatch):
        """An optimizer without the recipe's device-side update cannot be
        captured (runtime/trainstep.py ``CompiledStep``): the ladder
        counts ``export-failed``, writes nothing and trains eagerly."""
        d = tmp_path / "aot"
        eager = worker.train(steps=3, **KW).final_metrics["loss"]
        monkeypatch.delattr(recipe.RecipeOptimizer, "prepare_capture")
        before = outcomes()
        with caplog.at_level("WARNING", logger=worker.log.name):
            r = worker.train(steps=3, aot=True, aot_dir=str(d), **KW)
        assert r.steps == 3 and r.start_kind == "cold"
        assert counted(before) == {"miss": 1, "export-failed": 1}
        assert _files(d) == []
        assert "did not capture" in caplog.text
        assert r.final_metrics["loss"] == eager

    def test_first_step_metric_and_span(self, tmp_path):
        d = str(tmp_path / "aot")
        worker.train(steps=2, aot=True, aot_dir=d, **KW)
        spans = tmp_path / "spans.jsonl"
        worker.train(steps=2, aot=True, aot_dir=d, span_path=str(spans),
                     **KW)
        events = [json.loads(line) for line in spans.read_text().splitlines()]
        first = [e for e in events if e["name"] == "first-step"]
        assert len(first) == 1 and first[0]["attrs"]["start_kind"] == "aot"
        hist = obsreg.default_registry().histogram(
            "kftpu_time_to_first_step_seconds", "", labels=("start",))
        assert hist.labels(start="aot")._count >= 1


# -- parity with the JAX package ----------------------------------------------

JCFG = dict(vocab_size=64, num_layers=2, embed_dim=16, num_heads=2,
            head_dim=8, mlp_dim=32, max_seq_len=16)


def _numpy_lm(seed: int) -> dict:
    model = J.TransformerLM(J.TransformerConfig(dtype=jnp.float32, **JCFG))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16), jnp.int32))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda leaf: (0.2 * rng.standard_normal(leaf.shape)).astype(
            np.float32), shapes)


def _fixed_spec(factory, init, tokens):
    """A workload factory whose spec starts from ``init`` and whose batch
    pool is ``tokens``, one batch per draw."""
    def make(**kw):
        it = iter(tokens)
        return dataclasses.replace(
            factory(**kw), init_fn=lambda rng: (init, {}),
            batch_fn=lambda rng, bs: {"tokens": next(it)})
    return make


def _losses(path) -> list:
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f if '"loss"' in line]


def test_aot_resumed_equals_cold_and_both_match_jax(tmp_path, monkeypatch):
    params = _numpy_lm(seed=4)
    rng = np.random.default_rng(5)
    tokens = [rng.integers(0, 64, (8, 16)).astype(np.int32)
              for _ in range(4)]
    monkeypatch.setitem(jworker.WORKLOADS, "transformer", _fixed_spec(
        jworker.WORKLOADS["transformer"], params, tokens))
    monkeypatch.setitem(worker.WORKLOADS, "transformer", _fixed_spec(
        worker.WORKLOADS["transformer"],
        transformer_params_from_jax(params), tokens))
    # 8 rows: the JAX worker's mesh takes the conftest's 8 CPU devices
    common = dict(workload="transformer", optimizer="adam",
                  learning_rate=1e-2, global_batch=8, sync_every=1,
                  seed=0, handle_sigterm=False)
    jworker.train(steps=3, workload_kwargs={"cfg": J.TransformerConfig(
        dtype=jnp.float32, **JCFG)}, metrics_path=str(tmp_path / "j.jsonl"),
        **common)
    port = dict(common, device="cpu", workload_kwargs={
        "cfg": T.TransformerConfig(dtype=torch.float32, **JCFG)})
    d = str(tmp_path / "aot")
    ref = worker.train(steps=3, aot=True, aot_dir=d,
                       checkpoint_dir=str(tmp_path / "ck-ref"),
                       checkpoint_every=3,
                       metrics_path=str(tmp_path / "ref.jsonl"), **port)
    assert ref.start_kind == "cold"
    worker.train(steps=1, checkpoint_dir=str(tmp_path / "ck-seg"),
                 checkpoint_every=1, **port)
    resumed = worker.train(steps=3, aot=True, aot_dir=d,
                           resume_from=str(tmp_path / "ck-seg"),
                           checkpoint_dir=str(tmp_path / "ck-aot"),
                           checkpoint_every=3,
                           metrics_path=str(tmp_path / "aot.jsonl"), **port)
    assert resumed.start_kind == "aot" and resumed.steps == 2
    want = _losses(tmp_path / "j.jsonl")
    got = _losses(tmp_path / "ref.jsonl")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert _losses(tmp_path / "aot.jsonl") == got[1:]
    a = CheckpointManager(str(tmp_path / "ck-aot")).read_tree(3)
    b = CheckpointManager(str(tmp_path / "ck-ref")).read_tree(3)
    for name, v in b["params"].items():
        assert torch.equal(a["params"][name], v), name
    for slot, leaves in b["opt"]["slots"].items():
        for name, v in leaves.items():
            assert torch.equal(a["opt"]["slots"][slot][name], v), (slot, name)


# -- the step object's plumbing -------------------------------------------------

def _resnet(steps=4):
    spec = TR.workload_spec(depth=18, image_size=16, num_classes=4)
    b = trainstep.TrainStepBuilder(
        loss_fn=spec.loss_fn, device="cpu",
        optimizer=lambda p: recipe.make_optimizer(
            p, "lars", 0.1, schedule="cosine", total_steps=steps,
            warmup_steps=1, runtime_schedule=True)[0])
    gen = torch.Generator().manual_seed(3)
    batches = [b.place_batch(spec.batch_fn(gen, 4)) for _ in range(steps)]
    return spec, b, batches


def test_batchnorm_step_is_a_fixed_point():
    spec, b, batches = _resnet()
    eager = b.init(spec.init_fn, torch.Generator().manual_seed(0))
    step = b.build()
    state = b.init(spec.init_fn, torch.Generator().manual_seed(0))
    cstep = b.build_compiled(state, batches[0])
    held = {(c, n): t for c, vs in state.variables.items()
            for n, t in vs.items()}
    assert held
    for i, batch in enumerate(batches):
        eager, em = step(eager, batch)
        state, cm = cstep(state, batch)
        assert float(cm["loss"]) == float(em["loss"]), i
        for (c, n), t in held.items():
            # the step wrote the new statistics into the same storage
            assert state.variables[c][n] is t, (i, c, n)
            assert torch.equal(t, eager.variables[c][n]), (i, c, n)
    for n, p in eager.params.items():
        assert torch.equal(state.params[n], p), n
    assert state.step == eager.step == len(batches)


def test_restore_into_held_storage_trains_from_restored_values():
    spec, b, batches = _resnet(steps=3)
    state = b.init(spec.init_fn, torch.Generator().manual_seed(0))
    cstep = b.build_compiled(state, batches[0])
    for batch in batches[:2]:
        state, _ = cstep(state, batch)
    saved = json_free_copy(trainstep.state_tree(state))
    state, m = cstep(state, batches[2])
    storage = {path: t.data_ptr()
               for path, t in trainstep._tensors(state).items()}
    trainstep.load_state_tree(state, saved)
    assert state.step == 2
    assert {path: t.data_ptr() for path, t in
            trainstep._tensors(state).items()} == storage
    state, again = cstep(state, batches[2])
    assert float(again["loss"]) == float(m["loss"])
    for c, vs in saved["variables"].items():
        for n, v in vs.items():
            assert not torch.equal(state.variables[c][n], v), (c, n)


def json_free_copy(tree):
    """A checkpoint tree as runtime/checkpoint.py reads it back: CPU
    copies of every tensor."""
    if isinstance(tree, dict):
        return {k: json_free_copy(v) for k, v in tree.items()}
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def test_lagged_window_fetch_keeps_each_windows_values():
    """A window's metrics are submitted and read a window later: each
    call's metrics are copies of the step's outputs, so the next step
    does not overwrite the values in flight."""
    spec, b = _builder()
    state = b.init(spec.init_fn, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batches = [b.place_batch(spec.batch_fn(gen, 2)) for _ in range(4)]
    cstep = b.build_compiled(state, batches[0])
    fetch = AsyncWindowFetch(lag=1)
    want = []
    for i, batch in enumerate(batches):
        state, m = cstep(state, batch)
        want.append(float(m["loss"]))
        fetch.submit(i + 1, 1, m)
    got = [vals["loss"] for _, _, vals in fetch.drain(force=True)]
    assert got == want and len(set(got)) == len(got)


def test_async_save_between_steps_holds_the_saved_step(tmp_path):
    spec, b = _builder()
    state = b.init(spec.init_fn, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batches = [b.place_batch(spec.batch_fn(gen, 2)) for _ in range(3)]
    cstep = b.build_compiled(state, batches[0])
    state, _ = cstep(state, batches[0])
    state, _ = cstep(state, batches[1])
    want = {n: p.detach().clone() for n, p in state.params.items()}
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=1)
    assert mgr.save(2, state)
    state, _ = cstep(state, batches[2])          # the next step, at once
    mgr.wait()
    got = mgr.read_tree(2)["params"]
    mgr.close()
    assert any(not torch.equal(state.params[n], want[n]) for n in want)
    for n, v in want.items():
        assert torch.equal(got[n], v), n


@pytest.mark.parametrize("name", ["sgd", "momentum", "nesterov"])
def test_sgd_step_with_a_device_lr_matches_torch_sgd(name):
    """``recipe.SGD``, the update of every sgd, momentum and nesterov
    step, against ``torch.optim.SGD``'s own step over 4 steps of a cosine
    schedule with weight decay on the rank > 1 tensors: the same
    arithmetic but for the rounding of lr·u before the add, and the same
    momentum buffers. Its lr as a host float (an eager step) and as a
    0-d tensor (a captured step's device buffer) give the same params
    and buffers bit for bit."""
    rng = np.random.default_rng(3)
    shapes = ((4, 5), (5,), (3, 2, 2))
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[torch.tensor(rng.standard_normal(s).astype(np.float32))
              for s in shapes] for _ in range(4)]
    runs = []
    for way in ("torch", "host", "tensor"):
        ps = [torch.tensor(a, requires_grad=True) for a in init]
        opt, _ = recipe.make_optimizer(
            ps, name, 0.1, schedule="cosine", total_steps=4,
            weight_decay=1e-2, grad_clip=None)
        assert isinstance(opt.inner, recipe.SGD)
        if way == "tensor":         # what prepare_capture does on a card
            opt.lr_buffer = torch.zeros(())
            for group in opt.param_groups:
                group["lr"] = opt.lr_buffer
        for step_grads in grads:
            for p, g in zip(ps, step_grads):
                p.grad = g.clone()
            opt.stage()
            if way == "torch":
                torch.optim.SGD.step(opt.inner)
            else:
                opt.apply()
            opt.advance()
        runs.append(([p.detach() for p in ps],
                     [opt.inner.state[p].get("momentum_buffer")
                      for p in ps]))
    (want, wbuf), (got, gbuf), (dev, dbuf) = runs
    for w, g, d in zip(want, got, dev):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
        assert torch.equal(d, g)
    for w, g, d in zip(wbuf, gbuf, dbuf):
        assert (w is None) == (g is None) == (d is None) == (name == "sgd")
        if w is not None:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
            assert torch.equal(d, g)
