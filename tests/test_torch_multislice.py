"""The MPMD multislice engine: the port's schedule, engine and worker
path against the JAX package's (``kubeflow_tpu/parallel/multislice.py``,
``tests/test_multislice.py``).

- ``stage_op_order``, ``_deps``, ``model_schedule`` and
  ``ScheduleReport.to_dict()`` equal the JAX ones over S 1–4, M 1–8 with
  seeded durations; ``partition_stacked`` splits as theirs does; ``stage_devices`` puts every stage on the CPU,
  shares one card, and refuses a slice of several cards.
- ``MPMDPipeline`` against JAX's at S 2, M 4 on converted weights of the
  tiny f32 stacked LM, 3 steps of SGD momentum with the cross-stage clip
  at 1.0 acting: loss and grad norm within 1e-5 relative a step, each
  stage's params within 1e-5 of their largest magnitude, the transfers'
  count and bytes equal (int32 tokens); a step calls no collective; a
  batch the microbatches do not divide raises.
- The worker: ``train(multislice_pipeline=True)`` with
  ``KFTPU_NUM_SLICES=2`` writes the ``pipeline-bubble`` spans and the
  ``multislice-profile`` event, which the JAX package's goodput ledger
  reads as nonzero ``pipeline_bubble`` badput summing to wall-clock;
  with fused_adam one K3 a stage a step (counted at its plain version);
  M defaults as the JAX worker's; the refusals come in the JAX package's
  words; the AOT records and checkpoints are written (their round trips
  are in tests/test_torch_mpmd_aot.py and
  tests/test_torch_multislice_ckpt.py).
"""

import json

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import transformer as T
from kubeflow_tpu_torch.models.convert import transformer_params_from_jax
from kubeflow_tpu_torch.parallel import collectives
from kubeflow_tpu_torch.parallel import multislice as MS
from kubeflow_tpu_torch.runtime import recipe, trainstep, worker

RTOL = 1e-5
CFG = dict(vocab_size=64, num_layers=2, embed_dim=32, num_heads=2,
           head_dim=16, mlp_dim=64, max_seq_len=16)
OPT = dict(learning_rate=0.05, momentum=0.9, schedule="constant",
           total_steps=3, grad_clip=None)
KW = dict(workload="transformer-pipelined", optimizer="adam",
          learning_rate=1e-3, global_batch=8, device="cpu",
          handle_sigterm=False, sync_every=2,
          workload_kwargs={"cfg": T.TransformerConfig.tiny()})


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ("KFTPU_MULTISLICE_PIPELINE", "KFTPU_MULTISLICE_MICROBATCHES",
                 "KFTPU_WEIGHT_UPDATE", "KFTPU_AOT", "KFTPU_CHECKPOINT_DIR",
                 "KFTPU_RESUME_FROM", "KFTPU_SPAN_PATH", "KFTPU_TOPOLOGY",
                 "KFTPU_KERNEL_OPTIMIZER", "KFTPU_KERNEL_ATTENTION"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("KFTPU_NUM_SLICES", "2")


def test_schedule_model_matches_jax():
    from kubeflow_tpu.parallel import multislice as J
    rng = np.random.default_rng(11)
    for S in range(1, 5):
        for M in range(1, 9):
            durations = {}
            for s in range(S):
                order = MS.stage_op_order(s, S, M)
                assert order == J.stage_op_order(s, S, M)
                for kind, m in order:
                    assert MS._deps(kind, s, m, S) == J._deps(kind, s, m, S)
                    durations[(kind, s, m)] = float(rng.uniform(0.5, 2.0))
            kw = dict(transfer_s=0.01 * S, serial_wall_s=1.5,
                      dcn_bytes=1000 * M, dcn_transfers=3 * M)
            got = MS.model_schedule(durations, S, M, **kw)
            want = J.model_schedule(durations, S, M, **kw)
            assert got.to_dict() == want.to_dict()
            assert got == MS.ScheduleReport(**vars(want))
            json.dumps(got.to_dict())


def test_partition_groups_and_stage_devices(monkeypatch):
    import jax
    from kubeflow_tpu.parallel import multislice as J
    w = np.arange(8).reshape(8, 1)
    for n in (1, 2, 4):
        got = [c["w"].tolist() for c in MS.partition_stacked({"w": w}, n)]
        want = [jax.device_get(c["w"]).tolist()
                for c in J.partition_stacked({"w": w}, n)]
        assert got == want
    with pytest.raises(ValueError, match="divisible"):
        MS.partition_stacked({"w": np.arange(6).reshape(6, 1)}, 4)
    assert MS.stage_devices(2, "cpu") == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert MS.stage_devices(2) == [torch.device("cuda", 0)] * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert MS.stage_devices(4)[3] == torch.device("cuda", 3)
    with pytest.raises(NotImplementedError, match="inside a stage"):
        MS.stage_devices(2)


def _jax_engine(micro: int):
    import jax
    import jax.numpy as jnp
    from kubeflow_tpu.models import transformer as J
    from kubeflow_tpu.parallel.multislice import MPMDPipeline, stage_meshes
    from kubeflow_tpu.runtime.recipe import make_optimizer as j_make
    init_fn, embed_fn, block_fn, head_loss_fn = J.multislice_stage_fns(
        J.TransformerConfig(dtype=jnp.float32, **CFG))
    engine = MPMDPipeline(
        meshes=stage_meshes(jax.devices()[:2], 2), embed_fn=embed_fn,
        block_fn=block_fn, head_loss_fn=head_loss_fn,
        optimizer=j_make("momentum", **OPT)[0], num_microbatches=micro,
        grad_clip_norm=1.0)
    return engine, init_fn


def _port_engine(micro: int):
    _, embed_fn, block_fn, head_loss_fn = T.multislice_stage_fns(
        T.TransformerConfig(dtype=torch.float32, **CFG))
    return MS.MPMDPipeline(
        devices=MS.stage_devices(2, "cpu"), embed_fn=embed_fn,
        block_fn=block_fn, head_loss_fn=head_loss_fn,
        optimizer=lambda p: recipe.make_optimizer(
            p, "momentum", **{**OPT, "grad_clip": 1.0})[0],
        num_microbatches=micro)


def test_engine_matches_jax():
    import jax
    from kubeflow_tpu_torch.models.convert import flatten_params
    jengine, init_fn = _jax_engine(4)
    full = jax.device_get(init_fn(jax.random.PRNGKey(0), 16))
    jstate = jengine.init(lambda r: full, jax.random.PRNGKey(0))
    engine = _port_engine(4)
    state = engine.init(lambda r: transformer_params_from_jax(full), None)
    tokens = np.random.default_rng(8).integers(
        0, CFG["vocab_size"], (16, 16)).astype(np.int32)
    collectives.reset_counts()
    for i in range(3):
        jstate, jm = jengine.step(jstate, jengine.place_batch(
            {"tokens": tokens}))
        state, m = engine.step(state, engine.place_batch({"tokens": tokens}))
        assert jm["grad_norm"] > 1.0          # the clip acts
        for k in ("loss", "grad_norm", "perplexity"):
            np.testing.assert_allclose(m[k], jm[k], rtol=RTOL,
                                       err_msg=f"step {i} {k}")
        assert 0.0 <= m["bubble_fraction"] < 1.0
        assert m["pipeline_bubble_s"] >= 0.0
        rep, jrep = engine.last_report, jengine.last_report
        assert (rep.dcn_transfers, rep.dcn_bytes) == \
            (jrep.dcn_transfers, jrep.dcn_bytes) == (12, 4 * (2 * 8192
                                                           + 256))
    assert state.step == int(jstate.step) == 3
    assert all(v == 0 for v in collectives.calls.values())
    for s in range(2):
        want = flatten_params(jax.device_get(jstate.params[s]))
        got = state.params[s]
        assert set(got) == set(want)
        for n, w in want.items():
            err = float(np.abs(got[n].detach().numpy() - w).max())
            assert err <= RTOL * float(np.abs(w).max()), (s, n, err)
    # stage 0 holds the embedding and its layer, stage 1 its layer and
    # the head
    assert any(n.startswith("embed.") for n in state.params[0])
    assert not any(n.startswith("head.") for n in state.params[0])
    assert any(n.startswith("head.") for n in state.params[1])
    assert state.params[1]["blocks.attn.qkv.kernel"].shape[0] == 1


def test_microbatch_divisibility_rejected():
    engine = _port_engine(5)
    state = engine.init(lambda r: T.pipelined_init_fn(T.TransformerConfig(
        dtype=torch.float32, **CFG))(torch.Generator().manual_seed(0))[0],
        None)
    with pytest.raises(ValueError, match="not divisible by 5"):
        engine.step(state, {"tokens": np.zeros((16, 16), np.int32)})


def test_worker_writes_the_bubble_spans_and_launches_k3_a_stage(
        tmp_path, monkeypatch):
    from kubeflow_tpu.obs import goodput as jgp
    from kubeflow_tpu.obs.trace import load_spans
    from kubeflow_tpu_torch.obs import goodput as gp
    import importlib
    fo = importlib.import_module("kubeflow_tpu_torch.ops.fused_adam")
    real, calls = fo.fused_adam_multi_plain, []
    monkeypatch.setattr(fo, "fused_adam_multi_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    seen = []

    class Spy(_REAL_BUILDER):
        def __post_init__(self):
            seen.append(self.num_microbatches)
            super().__post_init__()

    monkeypatch.setattr(trainstep, "MultisliceTrainStepBuilder", Spy)
    sink = str(tmp_path / "spans.jsonl")
    r = worker.train(steps=4, span_path=sink, multislice_pipeline=True,
                     kernel_optimizer="fused_adam", global_batch=8,
                     **{k: v for k, v in KW.items() if k != "global_batch"})
    assert r.steps == 4 and np.isfinite(r.final_metrics["loss"])
    assert len(calls) == 2 * 4                    # one K3 a stage a step
    assert seen == [8]                            # 4 x max(2, slices)
    spans = load_spans(sink)
    names = [s["name"] for s in spans]
    assert names.count(gp.SPAN_PIPELINE_BUBBLE) == 2      # a window each
    assert names.count("multislice-profile") == 1
    prof = next(s for s in spans if s["name"] == "multislice-profile")
    assert prof["attrs"]["report"]["numMicrobatches"] == 8
    assert prof["attrs"]["report"]["dcnTransfersPerStep"] == 3 * 8
    ledger = jgp.decompose(spans)
    assert ledger["badputSeconds"][gp.BADPUT_PIPELINE_BUBBLE] > 0
    assert jgp.categories_sum_ok(ledger)
    assert (gp.BADPUT_PIPELINE_BUBBLE, gp.SPAN_PIPELINE_BUBBLE) == \
        (jgp.BADPUT_PIPELINE_BUBBLE, jgp.SPAN_PIPELINE_BUBBLE)
    monkeypatch.setenv("KFTPU_MULTISLICE_MICROBATCHES", "4")
    worker.train(steps=1, multislice_pipeline=True, **KW)
    assert seen == [8, 4]


_REAL_BUILDER = trainstep.MultisliceTrainStepBuilder


@pytest.mark.parametrize("case", ["workload", "eval", "weight_update",
                                  "one_slice"])
def test_refusals_in_the_jax_words(monkeypatch, case):
    from kubeflow_tpu.runtime import worker as jworker
    kw = dict(steps=1, multislice_pipeline=True, handle_sigterm=False)
    if case == "workload":
        kw["workload"] = "transformer"
    else:
        kw["workload"] = "transformer-pipelined"
    if case == "eval":
        kw["eval_every"] = 1
    if case == "weight_update":
        kw["weight_update"] = "sharded"
    if case == "one_slice":
        monkeypatch.setenv("KFTPU_NUM_SLICES", "1")
    with pytest.raises(ValueError) as jerr:
        jworker.train(**kw)
    with pytest.raises(ValueError) as perr:
        worker.train(device="cpu", **kw)
    assert str(perr.value) == str(jerr.value)


def test_aot_and_checkpoints_are_not_ported_on_this_path(tmp_path):
    """Both are ported on this path now: the AOT record writes one
    record per stage program (2S−1; their ladder is in
    tests/test_torch_mpmd_aot.py) and the step is saved; eval still
    raises."""
    r = worker.train(steps=1, multislice_pipeline=True, aot=True,
                     aot_dir=str(tmp_path / "aot"), **KW)
    assert r.steps == 1
    assert len(list((tmp_path / "aot").glob("step-*.aotx"))) == 3
    # checkpoints are ported on this path since the per-stage state tree
    # (tests/test_torch_multislice_ckpt.py): the step is saved
    worker.train(steps=1, multislice_pipeline=True,
                 checkpoint_dir=str(tmp_path / "c"), **KW)
    assert (tmp_path / "c" / "1" / "_CHECKPOINT_METADATA").exists()
    with pytest.raises(NotImplementedError, match="eval is not supported"):
        _REAL_BUILDER(cfg=T.TransformerConfig.tiny(), num_slices=2,
                      num_microbatches=2, optimizer=None,
                      device="cpu").build_eval(None)
