"""Resume and restore across a change of degree, preemption, on gloo CPU
ranks.

- Cross-degree restore (``tests/test_elastic.py``
  ``test_cross_degree_restore_is_lossless``, :508): ranks at degree N
  train 3 steps (adam), save, and ranks at degree M restore, at (2, 4)
  and (4, 2), replicated and sharded (ZeRO-2). The ``[6, 8]`` leaf splits
  dim 0 at degree 2 and dim 1 at degree 4, so the moments are
  reassembled and re-split along another dimension. Params and every
  optimizer entry, assembled from the ranks' blocks, within 1e-5 (that
  test's bar; 0 here), and the restored state steps on.
- A save under one weight-update mode restores under the other.
- ``check_elastic_resume`` gives the JAX package's answers and errors
  (:549, :579) on the same run metadata.
- ``train()``: a run at degree 2 stopped at step 3 and resumed at degree
  1 executes steps 4-6 and ends within 1e-3 of an uninterrupted degree-2
  run (:611; the reduction order differs across degrees); a changed
  global batch refuses the elastic resume (:637).
- ``resume_from`` warm-starts an empty checkpoint directory (the restore
  a ``ckpt-restore`` span); with the sentinel on two sharded ranks the
  replicas' square norms reach it, agree, and a LKG is tagged.
- Preemption (``tests/test_runtime.py`` :381): the stop flag forces a
  save off the cadence and the resumed run executes only the remaining
  steps; ``main()`` exits 75; and a real SIGTERM to the worker CLI in a
  subprocess leaves a committed, verified step and exit 75.

JAX is imported inside the test functions; the rank functions import the
port only.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
from kubeflow_tpu_torch.parallel.mesh import build_mesh
from kubeflow_tpu_torch.runtime import recipe, worker
from kubeflow_tpu_torch.runtime.bootstrap import WorkerContext
from kubeflow_tpu_torch.runtime.checkpoint import (MANIFEST_NAME,
                                                   ORBAX_COMMIT_MARKER,
                                                   CheckpointManager,
                                                   ElasticContractError)
from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder, state_tree
from test_torch_dp import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 32


def _params() -> dict:
    rs = np.random.RandomState(0)
    return {"w": rs.randn(6, 8).astype(np.float32),
            "b": np.zeros((8,), np.float32),
            "s": rs.randn(3).astype(np.float32)}


def _batch() -> dict:
    rs = np.random.RandomState(1)
    return {"x": rs.randn(ROWS, 6).astype(np.float32),
            "y": rs.randn(ROWS, 8).astype(np.float32)}


def _loss(params, variables, batch, rng):
    y = batch["x"] @ params["w"] + params["b"] * params["s"].sum()
    return torch.mean((y - batch["y"]) ** 2), {}


def _builder(world: int, mode: str) -> TrainStepBuilder:
    return TrainStepBuilder(
        loss_fn=_loss, device="cpu", weight_update=mode,
        mesh=build_mesh(ShardingSpec(data=world)),
        optimizer=lambda p: recipe.make_optimizer(p, "adam", 1e-2)[0])


def _split_dim(count) -> int:
    """The one dimension a block grid splits."""
    (d,) = [d for d, n in enumerate(count) if n > 1]
    return d


def _blocks(state) -> dict:
    """This rank's tree as numpy: whole leaves, and each block with its
    dimension."""
    tree = state_tree(state)
    out = {"params": {n: p.detach().numpy().copy()
                      for n, p in tree["params"].items()},
           "slots": {}, "layout": {
               n: _split_dim(b[1]) for n, b in state.update_blocks.items()}}
    for slot, leaves in tree["opt"]["slots"].items():
        out["slots"][slot] = {
            n: (v.block.numpy().copy(), _split_dim(v.count))
            if hasattr(v, "block") else (v.detach().numpy().copy(), None)
            for n, v in leaves.items()}
    return out


def _assemble(ranks: list) -> dict:
    """Global leaves from the ranks' blocks."""
    out = {"params": ranks[0]["params"], "slots": {}}
    for slot, leaves in ranks[0]["slots"].items():
        out["slots"][slot] = {}
        for n, (v, d) in leaves.items():
            out["slots"][slot][n] = v if d is None else np.concatenate(
                [r["slots"][slot][n][0] for r in ranks], axis=d)
    return out


def _save_rank(rank, world, mode, directory):
    b = _builder(world, mode)
    state = b.init(lambda rng: (_params(), {}), None)
    step = b.build()
    for _ in range(3):
        state, _m = step(state, b.place_batch(_batch()))
    mgr = CheckpointManager(directory, run_meta={"replicaDegree": world,
                                                 "globalBatch": ROWS})
    mgr.save(3, state, force=True)
    mgr.close()
    return _blocks(state)


def _restore_rank(rank, world, mode, directory):
    b = _builder(world, mode)
    template = b.init(lambda rng: ({k: v * 0 + 7 for k, v in
                                    _params().items()}, {}), None)
    mgr = CheckpointManager(directory)
    info = mgr.check_elastic_resume(None, world, ROWS)
    state = mgr.restore(template)
    mgr.close()
    out = _blocks(state)
    out["info"], out["step"] = info, state.step
    state, m = b.build()(state, b.place_batch(_batch()))
    out["next"] = (state.step, float(m["loss"]))
    return out


@pytest.mark.parametrize("mode", ["replicated", "sharded"])
@pytest.mark.parametrize("degrees", [(2, 4), (4, 2)])
def test_cross_degree_restore_is_lossless(tmp_path, mode, degrees):
    n, m = degrees
    saved = spawn(_save_rank, n, mode, str(tmp_path))
    # every rank's file under the manifest, process 0's commit verified
    manifest = json.loads((tmp_path / "3" / MANIFEST_NAME).read_text())
    assert {f"state/rank-{r:05d}.pt" for r in range(n)} <= \
        set(manifest["files"])
    assert CheckpointManager(str(tmp_path)).verify_step(3) == \
        (True, "verified")
    restored = spawn(_restore_rank, m, mode, str(tmp_path))
    assert restored[0]["info"] == {"resharded": True, "from": n, "to": m}
    a, b = _assemble(saved), _assemble(restored)
    assert set(a["slots"]) == set(b["slots"]) == {"step", "exp_avg",
                                                   "exp_avg_sq"}
    worst = 0.0
    for n_ in a["params"]:
        worst = max(worst, float(np.abs(a["params"][n_] -
                                        b["params"][n_]).max()))
        for slot in a["slots"]:
            worst = max(worst, float(np.abs(a["slots"][slot][n_] -
                                            b["slots"][slot][n_]).max()))
    assert worst <= 1e-5
    if mode == "sharded":
        # the leaf whose dimension changes with the degree
        assert saved[0]["layout"]["w"] != restored[0]["layout"]["w"]
        assert restored[0]["slots"]["exp_avg"]["w"][0].size == 48 // m
    for r in restored:
        assert r["step"] == 3 and r["next"][0] == 4
        assert np.isfinite(r["next"][1])
        assert r["next"][1] == restored[0]["next"][1]


@pytest.mark.parametrize("modes", [("sharded", "replicated"),
                                   ("replicated", "sharded")])
def test_restore_across_update_modes(tmp_path, modes):
    """A save under one weight-update mode restores under the other
    (``tests/test_weight_update_sharding.py`` :184): the moments of a
    sharded save restore whole, and whole moments split into blocks."""
    saved = spawn(_save_rank, 2, modes[0], str(tmp_path))
    restored = spawn(_restore_rank, 4, modes[1], str(tmp_path))
    a, b = _assemble(saved), _assemble(restored)
    for n_ in a["params"]:
        assert np.array_equal(a["params"][n_], b["params"][n_])
        for slot in a["slots"]:
            assert np.array_equal(a["slots"][slot][n_],
                                  b["slots"][slot][n_]), (slot, n_)
    assert {r["next"][0] for r in restored} == {4}


def test_elastic_contract_matches_jax(tmp_path):
    """The same run metadata through both packages' managers: the same
    answers, the same errors (tests/test_elastic.py :549, :579)."""
    from kubeflow_tpu.runtime.checkpoint import CheckpointManager as JM
    out = {}
    for name, cls, kw in (("jax", JM, {}), ("torch", CheckpointManager, {})):
        d = tmp_path / name
        meta = cls(str(d / "meta"), run_meta={"replicaDegree": 4,
                                              "globalBatch": 32}, **kw)
        bare = cls(str(d / "bare"), **kw)
        for m in (meta, bare):
            m.save(1, {"params": {"w": np.ones((4,), np.float32)}},
                   force=True)
            m.wait()
        obs = [meta.run_meta_of(1), bare.run_meta_of(1),
               bare.check_elastic_resume(None, 8, 32)]
        for degree, gb in ((4, 32), (2, 32), (8, 32), (2, 64), (3, 32),
                           (None, 32)):
            try:
                obs.append(meta.check_elastic_resume(None, degree, gb))
            except ValueError as e:
                obs.append((type(e).__name__, str(e)))
        meta.close()
        bare.close()
        out[name] = obs
    assert out["torch"] == out["jax"]
    assert out["torch"][-3][0] == "ElasticContractError"


# -- train() across degrees -----------------------------------------------------

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


# -- preemption -------------------------------------------------------------------

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
