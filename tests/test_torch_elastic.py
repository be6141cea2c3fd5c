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
- ``train()``'s elastic resume, ``resume_from``, the sentinel on
  sharded ranks and preemption are in tests/test_torch_elastic_worker.py
  (split out so that the test runner's workers take the two halves in
  parallel).

JAX is imported inside the test functions; the rank functions import the
port only.
"""

import json

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
from kubeflow_tpu_torch.parallel.mesh import build_mesh
from kubeflow_tpu_torch.runtime import recipe
from kubeflow_tpu_torch.runtime.checkpoint import (MANIFEST_NAME,
                                                   CheckpointManager)
from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder, state_tree
from test_torch_dp import spawn

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


# -- preemption -------------------------------------------------------------------
