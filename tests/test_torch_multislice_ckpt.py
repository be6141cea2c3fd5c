"""Checkpoints of the MPMD multislice path: the worker saves and restores
the per-stage state (``MultisliceState``: each stage's params and its
optimizer's state) through ``CheckpointManager`` on the same directory
contract and payload as the single-program path, the counterpart of the
JAX worker's ``runtime/worker.py:531-588``.

Two CPU stages (``KFTPU_NUM_SLICES=2``) train the tiny f32 stacked LM
(2 layers; 4 where 4 stages restore) with Adam through K3's plain
version (``--kernel-optimizer fused_adam``), M 2, a save every 2 steps,
on one CPU thread (the stages' ops are too small to share out):

- a run of 4 steps and a run stopped at step 2, then resumed to step 4,
  save the same step-4 tree bit for bit (max|Δparam| 0 and every moment
  equal), with one K3 a stage a step in each segment;
- SIGTERM during step 3 saves that step, and the resume runs on;
- the sentinel trips on a NaN poisoned into every stage's params,
  ``KFTPU_RESUME_STEP`` rolls back to the last-known-good step, and the
  resumed run ends equal to a clean one;
- a restore onto another number of slices raises.
"""

import importlib
from dataclasses import replace

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models import transformer as T
from kubeflow_tpu_torch.runtime import sentinel as TS
from kubeflow_tpu_torch.runtime import worker
from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager

CFG = T.TransformerConfig(vocab_size=64, num_layers=2, embed_dim=16,
                          num_heads=2, head_dim=8, mlp_dim=32,
                          max_seq_len=16, dtype=torch.float32)
KW = dict(workload="transformer-pipelined", optimizer="adam",
          learning_rate=1e-2, global_batch=4, device="cpu",
          handle_sigterm=False, sync_every=1, checkpoint_every=2,
          multislice_pipeline=True, multislice_microbatches=2,
          kernel_optimizer="fused_adam", workload_kwargs={"cfg": CFG})


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch, tmp_path):
    for name in ("KFTPU_MULTISLICE_PIPELINE", "KFTPU_MULTISLICE_MICROBATCHES",
                 "KFTPU_WEIGHT_UPDATE", "KFTPU_AOT", "KFTPU_CHECKPOINT_DIR",
                 "KFTPU_RESUME_FROM", "KFTPU_SPAN_PATH", "KFTPU_TOPOLOGY",
                 "KFTPU_KERNEL_OPTIMIZER", "KFTPU_KERNEL_ATTENTION",
                 "KFTPU_INTEGRITY", "KFTPU_INTEGRITY_CHECK_EVERY",
                 TS.NUMERIC_FAULT_ENV, TS.NUMERIC_FAULT_MARK_ENV,
                 TS.NUMERIC_FAULT_FIRES_ENV, TS.RESUME_STEP_ENV,
                 TS.REPLAY_RANGE_ENV):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("KFTPU_NUM_SLICES", "2")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_equal_trees(a: dict, b: dict) -> None:
    a, b = _flat(a), _flat(b)
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_mpmd_resume_is_exact(tmp_path, monkeypatch):
    fo = importlib.import_module("kubeflow_tpu_torch.ops.fused_adam")
    real, calls = fo.fused_adam_multi_plain, []
    monkeypatch.setattr(fo, "fused_adam_multi_plain",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    straight, split = str(tmp_path / "a"), str(tmp_path / "b")
    full = worker.train(steps=4, checkpoint_dir=straight, **KW)
    assert full.steps == 4 and len(calls) == 2 * 4
    assert worker.train(steps=2, checkpoint_dir=split, **KW).steps == 2
    resumed = worker.train(steps=4, checkpoint_dir=split, **KW)
    assert resumed.steps == 2 and len(calls) == 2 * 8
    assert resumed.final_metrics["loss"] == full.final_metrics["loss"]
    a = CheckpointManager(straight).read_tree(4)
    b = CheckpointManager(split).read_tree(4)
    _assert_equal_trees(a, b)
    # the tree: each stage's params (its half of the stacked blocks,
    # stage 0's embedding, stage 1's head) and K3's moments and count
    assert a["step"] == 4 and set(a["stages"]) == {"0", "1"}
    s0, s1 = a["stages"]["0"], a["stages"]["1"]
    assert "embed.tok_embed.embedding" in s0["params"]
    assert "head.head.kernel" in s1["params"]
    blk = s0["params"]["blocks.attn.qkv.kernel"]
    assert blk.shape[0] == CFG.num_layers // 2
    assert set(s0["opt"]["slots"]) == {"mu", "nu"}
    assert s0["opt"]["count"]["inner"] == 4


class _FlipAfterReads:
    """A guard whose stop flag turns True after 2 reads (one a loop
    iteration): SIGTERM arriving during step 3."""

    def __init__(self, install=True, on_term=None):
        self.reads = 0

    @property
    def stop(self):
        self.reads += 1
        return self.reads > 2

    def uninstall(self):
        pass


def test_mpmd_sigterm_saves_the_step_in_flight(tmp_path, monkeypatch):
    monkeypatch.setattr(worker, "PreemptionGuard", _FlipAfterReads)
    ckpt = str(tmp_path / "ckpt")
    kw = dict(KW, checkpoint_every=1000)
    r = worker.train(steps=200, checkpoint_dir=ckpt, **kw)
    assert r.preempted and r.steps == 3
    mgr = CheckpointManager(ckpt)
    assert mgr.all_steps() == [1, 3]
    assert mgr.verify_step(3) == (True, "verified")
    monkeypatch.undo()
    monkeypatch.setenv("KFTPU_NUM_SLICES", "2")
    r2 = worker.train(steps=5, checkpoint_dir=ckpt, **kw)
    assert not r2.preempted and r2.steps == 2
    assert CheckpointManager(ckpt).latest_step() == 5


def test_mpmd_lkg_rollback_matches_a_clean_run(tmp_path, monkeypatch):
    """``nan:3`` poisons every stage's params after step 3; the sentinel
    trips at step 4 with LKG 2 and nothing newer committed. Resumed with
    ``KFTPU_RESUME_STEP=2``, the run ends on the clean run's state."""
    ckpt, clean = str(tmp_path / "ckpt"), str(tmp_path / "clean")
    monkeypatch.setenv(TS.NUMERIC_FAULT_ENV, "nan:3")
    monkeypatch.setenv(TS.NUMERIC_FAULT_MARK_ENV, str(tmp_path / "mark"))
    kw = dict(KW, integrity=True, integrity_check_every=1,
              integrity_window=4)
    res = worker.train(steps=6, checkpoint_dir=ckpt, **kw)
    assert res.anomaly is not None and res.anomaly["step"] == 4
    assert res.anomaly["lkg"] == 2
    mgr = CheckpointManager(ckpt)
    assert mgr.lkg_step() == 2 and max(mgr.all_steps()) <= 2
    monkeypatch.setenv(TS.RESUME_STEP_ENV, "2")
    res = worker.train(steps=6, checkpoint_dir=ckpt, **kw)
    assert res.anomaly is None and res.steps == 4
    monkeypatch.delenv(TS.NUMERIC_FAULT_ENV)
    monkeypatch.delenv(TS.RESUME_STEP_ENV)
    worker.train(steps=6, checkpoint_dir=clean, **KW)
    _assert_equal_trees(CheckpointManager(ckpt).read_tree(6),
                        CheckpointManager(clean).read_tree(6))


def test_restore_onto_another_slice_count_raises(tmp_path, monkeypatch):
    """A 2-stage checkpoint does not restore onto 4 stages (through
    ``resume_from`` as through the checkpoint directory): the stages'
    chunks would not line up, as the JAX template's list structure
    cannot change."""
    ckpt = str(tmp_path / "ckpt")
    kw4 = dict(KW, workload_kwargs={"cfg": replace(CFG, num_layers=4)})
    worker.train(steps=2, checkpoint_dir=ckpt, **kw4)
    monkeypatch.setenv("KFTPU_NUM_SLICES", "4")
    for kw in (dict(checkpoint_dir=ckpt), dict(resume_from=ckpt)):
        with pytest.raises(ValueError, match="2 MPMD stages and this run "
                                             "has 4"):
            worker.train(steps=4, **{**kw4, "checkpoint_dir": None, **kw})
    assert np.array_equal(CheckpointManager(ckpt).all_steps(), [1, 2])
