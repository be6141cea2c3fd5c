"""Elastic resume through the worker's ``train()`` on gloo CPU ranks
(tests/test_torch_elastic.py holds the state-level cross-degree restore
and the elastic contract):

- a run at degree 2 stopped at step 3 and resumed at degree 1 executes
  steps 4-6 and ends within 1e-3 of an uninterrupted degree-2 run
  (``tests/test_elastic.py`` :611; the reduction order differs across
  degrees); a changed global batch refuses the elastic resume (:637);
- ``resume_from`` warm-starts an empty checkpoint directory (the restore
  a ``ckpt-restore`` span); with the sentinel on two sharded ranks the
  replicas' square norms reach it, agree, and a LKG is tagged;
- preemption (``tests/test_runtime.py`` :381): the stop flag forces a
  save off the cadence and the resumed run executes only the remaining
  steps; ``main()`` exits 75; and a real SIGTERM to the worker CLI in a
  subprocess leaves a committed, verified step and exit 75.

JAX is imported inside the test functions; the rank functions import the
port only.
"""

import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
from kubeflow_tpu_torch.parallel.mesh import build_mesh
from kubeflow_tpu_torch.runtime import worker
from kubeflow_tpu_torch.runtime.bootstrap import WorkerContext
from kubeflow_tpu_torch.runtime.checkpoint import (ORBAX_COMMIT_MARKER,
                                                   CheckpointManager,
                                                   ElasticContractError)
from test_torch_dp import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lm_kw() -> dict:
    from kubeflow_tpu_torch.models.transformer import TransformerConfig
    cfg = TransformerConfig(vocab_size=64, num_layers=1, embed_dim=16,
                            num_heads=2, head_dim=8, mlp_dim=32,
                            max_seq_len=16, dtype=torch.float32)
    return dict(workload="transformer", workload_kwargs={"cfg": cfg},
                optimizer="adam", learning_rate=1e-2, sync_every=1,
                checkpoint_every=2, seed=0, handle_sigterm=False,
                device="cpu")


def _ctx(rank: int, world: int) -> WorkerContext:
    return WorkerContext(device=torch.device("cpu"), process_id=rank,
                         num_processes=world,
                         mesh=build_mesh(ShardingSpec(data=world)))


def _train_rank(rank, world, kw):
    return worker.train(ctx=_ctx(rank, world), **kw).steps


def test_resume_at_a_smaller_degree(tmp_path):
    from kubeflow_tpu_torch.cluster.chaos import final_params
    clean, el = str(tmp_path / "clean"), str(tmp_path / "elastic")
    kw = dict(_lm_kw(), global_batch=8, weight_update="sharded")
    spawn(_train_rank, 2, dict(kw, steps=6, checkpoint_dir=clean))
    spawn(_train_rank, 2, dict(kw, steps=3, checkpoint_dir=el))
    m = CheckpointManager(el)
    assert m.latest_step() == 3
    assert m.run_meta_of(3) == {"replicaDegree": 2, "globalBatch": 8}
    result = worker.train(steps=6, checkpoint_dir=el, **kw)
    assert result.steps == 3
    a, b = final_params(clean, device="cpu"), final_params(el, "cpu")
    delta = max(float((a[k] - b[k]).abs().max()) for k in a)
    assert delta <= 1e-3


def test_changed_global_batch_refuses_elastic_resume(tmp_path):
    d = str(tmp_path / "ck")
    kw = dict(_lm_kw(), checkpoint_every=1)
    spawn(_train_rank, 2, dict(kw, steps=2, global_batch=8,
                               checkpoint_dir=d))
    with pytest.raises(ElasticContractError, match="global batch"):
        worker.train(steps=4, global_batch=16, checkpoint_dir=d, **kw)
    # the same global batch resumes
    assert worker.train(steps=3, global_batch=8, checkpoint_dir=d,
                        **kw).steps == 1


class _FlipAfterReads:
    """A guard whose stop flag turns True after 3 reads (one a loop
    iteration): SIGTERM arriving during step 3."""

    def __init__(self, install=True, on_term=None):
        self.reads = 0

    @property
    def stop(self):
        self.reads += 1
        return self.reads > 2

    def uninstall(self):
        pass


def test_preemption_checkpoints_and_resumes(tmp_path, monkeypatch):
    monkeypatch.setattr(worker, "PreemptionGuard", _FlipAfterReads)
    ckpt = str(tmp_path / "ckpt")
    kw = dict(_lm_kw(), global_batch=2, checkpoint_dir=ckpt,
              checkpoint_every=1000)
    r = worker.train(steps=200, **kw)
    assert r.preempted and r.steps == 3
    mgr = CheckpointManager(ckpt)
    # the forced save of step 3 (the interval took only step 1, the
    # first save of an empty directory)
    assert mgr.all_steps() == [1, 3] and mgr.latest_step() == 3
    assert CheckpointManager(ckpt).verify_step(3) == (True, "verified")
    assert worker.main(["--workload", "transformer", "--device", "cpu",
                        "--steps", "200", "--global-batch", "2",
                        "--optimizer", "adam", "--sync-every", "1",
                        "--checkpoint-dir", str(tmp_path / "cli")]) == \
        worker.PREEMPTED_EXIT_CODE
    monkeypatch.undo()
    r2 = worker.train(steps=5, **kw)
    assert not r2.preempted and r2.steps == 2
    assert CheckpointManager(ckpt).latest_step() == 5


def test_sigterm_to_the_worker_cli(tmp_path):
    """A real SIGTERM to ``python -m kubeflow_tpu_torch.runtime.worker``:
    the step in flight finishes, the save is forced, the exit code is 75
    and the newest step is committed and verified."""
    ckpt = tmp_path / "ckpt"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KFTPU_")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.runtime.worker",
         "--workload", "transformer", "--device", "cpu", "--steps",
         "100000", "--global-batch", "2", "--optimizer", "adam",
         "--sync-every", "1", "--checkpoint-dir", str(ckpt),
         "--checkpoint-every", "5"], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and proc.poll() is None and \
                not (ckpt / "5" / ORBAX_COMMIT_MARKER).exists():
            time.sleep(0.1)
        assert proc.poll() is None, proc.communicate()[1][-3000:]
        proc.send_signal(signal.SIGTERM)
        _out, err = proc.communicate(timeout=120)
    except BaseException:
        proc.kill()
        raise
    assert proc.returncode == worker.PREEMPTED_EXIT_CODE, err[-3000:]
    last = CheckpointManager(str(ckpt)).latest_step()
    assert last is not None and last >= 5
    assert CheckpointManager(str(ckpt)).verify_step(last) == \
        (True, "verified")


def test_resume_from_warm_starts_an_empty_directory(tmp_path):
    """``resume_from`` (and ``KFTPU_RESUME_FROM``): a run whose own
    ``checkpoint_dir`` is empty restores the newest intact step of the
    other directory, executes the remaining steps, saves into its own
    and emits the restore as a ``ckpt-restore`` span before its saves."""
    import json as _json
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    spans = tmp_path / "spans.jsonl"
    kw = dict(_lm_kw(), global_batch=2)
    worker.train(steps=2, checkpoint_dir=src, **kw)
    r = worker.train(steps=4, checkpoint_dir=dst, resume_from=src,
                     span_path=str(spans), **kw)
    assert r.steps == 2
    assert CheckpointManager(dst).all_steps() == [3, 4]
    names = [_json.loads(line)["name"] for line in
             spans.read_text().splitlines()]
    assert names.index("ckpt-restore") < names.index("ckpt-save")
    assert names.count("ckpt-save") == 2


def _probe_rank(rank, world, kw):
    r = worker.train(ctx=_ctx(rank, world), **kw)
    return {"anomaly": r.anomaly, "steps": r.steps,
            "probe": r.final_metrics.get("param_sqnorm_replicas")}


def test_sentinel_reads_the_sharded_steps_replica_norms(tmp_path):
    """Two ranks, the sharded update, the sentinel on every window: the
    replicas' square norms reach it and agree (no false trip), and a LKG
    is tagged after the first clean window past a save."""
    d = str(tmp_path / "ck")
    kw = dict(_lm_kw(), global_batch=4, steps=4, weight_update="sharded",
              checkpoint_dir=d, integrity=True, integrity_check_every=1)
    for out in spawn(_probe_rank, 2, kw):
        assert out["anomaly"] is None and out["steps"] == 4
        assert len(out["probe"]) == 2 and \
            out["probe"][0] == out["probe"][1]
    assert CheckpointManager(d).lkg_step() == 2
