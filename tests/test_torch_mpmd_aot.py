"""The MPMD multislice path's AOT records on the CPU: one record per stage
program (parallel/multislice.py ``StageProgram``, runtime/aot.py
``program_signature``) and the worker's per-program ladder, against the
JAX package's ``tests/test_multislice.py`` engine export/load and its
worker's MPMD branch.

- A cold run exports 2S−1 records (stage 0's FWD and BWD, stage 1's
  FWDBWD); a rebind loads them all, captures every program before its
  first step and reads "aot"; its losses equal the cold run's exactly,
  and both match the JAX worker's MPMD ``train()`` (aot off) over 3
  steps on converted weights and the same tokens, rtol 1e-4.
- The static buffers at M 4 equal the eager engine bit for bit: a
  program's outputs are overwritten by its next replay, so what the
  schedule keeps (activations, cotangents, losses) is copied out first.
- One truncated record falls back alone (``corrupt``; the others hit;
  that program is captured and exported again); a program that does not
  capture runs eagerly alone, counted ``export-failed``; a changed
  microbatch count is another key and misses.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import transformer as J
from kubeflow_tpu.runtime import worker as jworker
from kubeflow_tpu_torch.models import transformer as T
from kubeflow_tpu_torch.models.convert import transformer_params_from_jax
from kubeflow_tpu_torch.obs import registry as obsreg
from kubeflow_tpu_torch.parallel import multislice as MS
from kubeflow_tpu_torch.runtime import aot, recipe, worker

CFG = dict(vocab_size=64, num_layers=2, embed_dim=32, num_heads=2,
           head_dim=16, mlp_dim=64, max_seq_len=16)
OUTCOMES = ("miss", "corrupt", "key-mismatch", "signature-mismatch",
            "deserialize-failed", "hit", "export", "export-failed")
KW = dict(workload="transformer-pipelined", optimizer="adam",
          learning_rate=1e-2, global_batch=16, sync_every=1, seed=0,
          handle_sigterm=False, multislice_pipeline=True,
          multislice_microbatches=4)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in ("KFTPU_MULTISLICE_PIPELINE", "KFTPU_MULTISLICE_MICROBATCHES",
                 "KFTPU_WEIGHT_UPDATE", aot.AOT_ENABLE_ENV, aot.AOT_DIR_ENV,
                 "KFTPU_CHECKPOINT_DIR", "KFTPU_SPAN_PATH", "KFTPU_TOPOLOGY",
                 "KFTPU_KERNEL_OPTIMIZER", "KFTPU_KERNEL_ATTENTION",
                 "KFTPU_COMPILE_CACHE_DIR", "KFTPU_RUNTIME_SCHEDULE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("KFTPU_NUM_SLICES", "2")


def outcomes() -> dict:
    fam = obsreg.counter("kftpu_aot_executable_total", "",
                         labels=("outcome",))
    return {o: fam.labels(outcome=o).value for o in OUTCOMES}


def counted(before: dict) -> dict:
    return {o: n - before[o] for o, n in outcomes().items() if n != before[o]}


def _records(d) -> list:
    return sorted(f for f in os.listdir(d) if f.endswith(".aotx")) \
        if os.path.isdir(d) else []


def _losses(path) -> list:
    with open(path) as f:
        return [json.loads(line)["loss"] for line in f if '"loss"' in line]


def _fixed_spec(factory, init, tokens):
    """A workload factory whose spec starts from ``init`` and whose batch
    pool is ``tokens``, one batch per draw."""
    def make(**kw):
        it = iter(tokens)
        return dataclasses.replace(
            factory(**kw), init_fn=lambda rng: (init, {}),
            batch_fn=lambda rng, bs: {"tokens": next(it)})
    return make


@pytest.fixture
def fixed(monkeypatch):
    """Both packages' pipelined workload on the same seeded weights
    (the JAX stage init, converted) and the same 4 token batches; the
    port's kwargs for train()."""
    jcfg = J.TransformerConfig(dtype=jnp.float32, **CFG)
    full = jax.device_get(J.multislice_stage_fns(jcfg)[0](
        jax.random.PRNGKey(3), 16))
    rng = np.random.default_rng(5)
    tokens = [rng.integers(0, 64, (16, 16)).astype(np.int32)
              for _ in range(4)]
    name = "transformer-pipelined"
    monkeypatch.setitem(jworker.WORKLOADS, name, _fixed_spec(
        jworker.WORKLOADS[name], full, tokens))
    monkeypatch.setitem(worker.WORKLOADS, name, _fixed_spec(
        worker.WORKLOADS[name], transformer_params_from_jax(full), tokens))
    return dict(KW, device="cpu", workload_kwargs={
        "cfg": T.TransformerConfig(dtype=torch.float32, **CFG)}), jcfg


def test_cold_exports_then_aot_equals_cold_and_both_match_jax(tmp_path,
                                                               fixed):
    port, jcfg = fixed
    d = str(tmp_path / "aot")
    before = outcomes()
    cold = worker.train(steps=3, aot=True, aot_dir=d,
                        metrics_path=str(tmp_path / "cold.jsonl"), **port)
    assert cold.start_kind == "cold"
    assert counted(before) == {"miss": 3, "export": 3}
    assert len(_records(d)) == 3
    before = outcomes()
    warm = worker.train(steps=3, aot=True, aot_dir=d,
                        metrics_path=str(tmp_path / "aot.jsonl"), **port)
    assert warm.start_kind == "aot"
    assert counted(before) == {"hit": 3}
    assert len(_records(d)) == 3
    got = _losses(tmp_path / "cold.jsonl")
    assert _losses(tmp_path / "aot.jsonl") == got
    jworker.train(steps=3, workload_kwargs={"cfg": jcfg},
                  metrics_path=str(tmp_path / "j.jsonl"),
                  **{k: v for k, v in KW.items()})
    np.testing.assert_allclose(got, _losses(tmp_path / "j.jsonl"),
                               rtol=1e-4)


def _engine(micro: int):
    _, embed_fn, block_fn, head_loss_fn = T.multislice_stage_fns(
        T.TransformerConfig(dtype=torch.float32, **CFG))
    return MS.MPMDPipeline(
        devices=MS.stage_devices(2, "cpu"), embed_fn=embed_fn,
        block_fn=block_fn, head_loss_fn=head_loss_fn,
        optimizer=lambda p: recipe.make_optimizer(
            p, "adam", 1e-2, grad_clip=1.0)[0],
        num_microbatches=micro)


def test_static_buffers_equal_the_eager_engine_bit_for_bit(tmp_path):
    """M 4 through the programs' static buffers, whose outputs each
    replay overwrites, against the eager engine: the same losses, grad
    norms, transfers and params, bit for bit; each program runs M times
    a step."""
    tokens = np.random.default_rng(8).integers(0, 64, (8, 16)).astype(
        np.int32)
    runs = []
    for programs in (False, True):
        engine = _engine(4)
        init = T.pipelined_init_fn(T.TransformerConfig(
            dtype=torch.float32, **CFG))
        state = engine.init(lambda r: init(r)[0],
                            torch.Generator().manual_seed(0))
        batch = engine.place_batch({"tokens": tokens})
        if programs:
            keys = engine.export_stages(str(tmp_path), state, batch,
                                        lambda s, kind: f"{s}-{kind}")
            assert keys == ["0-fwd", "0-bwd", "1-fwdbwd"]
            assert len(engine.programs) == engine.num_programs == 3
        metrics = []
        for _ in range(3):
            state, m = engine.step(state, batch)
            rep = engine.last_report
            metrics.append((m["loss"], m["grad_norm"], m["perplexity"],
                            rep.dcn_bytes, rep.dcn_transfers))
        runs.append((metrics, [{n: p.detach().clone() for n, p in
                                s.items()} for s in state.params]))
        if programs:
            assert all(p.replays == 3 * 4 for p in engine.programs.values())
    (want, wp), (got, gp) = runs
    assert got == want
    for a, b in zip(wp, gp):
        for n in a:
            assert torch.equal(a[n], b[n]), n


def test_one_damaged_record_falls_back_alone(tmp_path, fixed):
    port, _ = fixed
    d = str(tmp_path / "aot")
    cold = worker.train(steps=3, aot=True, aot_dir=d,
                        metrics_path=str(tmp_path / "cold.jsonl"), **port)
    name = _records(d)[0]
    path = os.path.join(d, name)
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])
    before = outcomes()
    r = worker.train(steps=3, aot=True, aot_dir=d,
                     metrics_path=str(tmp_path / "r.jsonl"), **port)
    assert counted(before) == {"corrupt": 1, "hit": 2, "export": 1}
    assert r.start_kind != "aot" and r.steps == 3
    assert _losses(tmp_path / "r.jsonl") == _losses(tmp_path / "cold.jsonl")
    assert cold.final_metrics["loss"] == r.final_metrics["loss"]
    with open(path, "rb") as f:
        assert f.read() != blob[:len(blob) // 2]     # written again


def test_a_program_that_does_not_capture_runs_eagerly_alone(
        tmp_path, fixed, monkeypatch):
    port, _ = fixed
    eager = worker.train(steps=3, metrics_path=str(tmp_path / "e.jsonl"),
                         **port)
    real = MS.StageProgram.__init__

    def refuse_bwd(self, engine, state, kind, s, example):
        if kind == MS.BWD:
            raise RuntimeError("not capturable")
        real(self, engine, state, kind, s, example)

    monkeypatch.setattr(MS.StageProgram, "__init__", refuse_bwd)
    seen = []
    real_step = MS.MPMDPipeline.step

    def spy(self, state, batch):
        seen.append(sorted(self.programs))
        return real_step(self, state, batch)

    monkeypatch.setattr(MS.MPMDPipeline, "step", spy)
    before = outcomes()
    r = worker.train(steps=3, aot=True, aot_dir=str(tmp_path / "aot"),
                     metrics_path=str(tmp_path / "r.jsonl"), **port)
    assert counted(before) == {"miss": 3, "export": 2, "export-failed": 1}
    assert len(_records(str(tmp_path / "aot"))) == 2
    assert seen[0] == [(MS.FWD, 0), (MS.FWDBWD, 1)]
    assert r.steps == 3
    assert _losses(tmp_path / "r.jsonl") == _losses(tmp_path / "e.jsonl")
    assert r.final_metrics["loss"] == eager.final_metrics["loss"]


def test_changed_microbatch_count_misses(tmp_path, fixed):
    port, _ = fixed
    d = str(tmp_path / "aot")
    worker.train(steps=1, aot=True, aot_dir=d, **port)
    before = outcomes()
    r = worker.train(steps=1, aot=True, aot_dir=d,
                     **{**port, "multislice_microbatches": 2})
    assert r.start_kind != "aot"
    assert counted(before) == {"miss": 3, "export": 3}
    assert len(_records(d)) == 6
