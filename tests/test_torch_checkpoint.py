"""The port's checkpoint manager against the JAX package's, and the
training state through a checkpoint.

- The fault script: both managers (``kubeflow_tpu/runtime/checkpoint.py``
  on orbax, ``kubeflow_tpu_torch/runtime/checkpoint.py`` on torch.save)
  take the same saves of ``{"params": {"w": [64] of the step}}`` and the
  same faults (``tests/test_chaos.py`` TestCheckpointIntegrity and
  ``tests/test_sentinel.py`` TestCheckpointLKG): a truncated newest
  payload, a removed commit marker, a re-save over corrupt remains, LKG
  tags, a corrupt LKG marker, retention of 1 and 2, the rollback
  discard and the capped restore walk. Every observation — the steps on
  disk, the latest intact step, each ``verify_step`` verdict (its first
  word), the LKG, the restored ``w[0]`` and the errors raised — must be
  equal. Each package reads only its own payloads.
- The state: the JAX ``TrainStepBuilder`` trains the tiny LM 3 steps;
  its state, converted (``models/convert.py``), is saved by the port's
  manager and restored into a fresh port ``TrainState``, which takes
  step 4 against JAX's step 4, for adam (stock and fused_adam),
  momentum, LARS, RMSProp and momentum under the runtime schedule.
  Bars of ``tests/test_torch_trainstep.py``: loss and grad norm rtol
  1e-4, params within 1e-5 in all but 0.1% of elements and every
  element within 3 x lr.
- The tree of a ``TrainState`` holds names, not positions, and its
  optimizer state round-trips unchanged for every family; the payload
  layout is the JAX package's directory contract.

JAX is imported inside the test functions.
"""

import json
import os

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.cluster import chaos as TC
from kubeflow_tpu_torch.runtime import checkpoint as TCK
from kubeflow_tpu_torch.runtime import recipe
from kubeflow_tpu_torch.runtime.trainstep import (TrainStepBuilder,
                                                  state_tree)


class _Pkg:
    """One package's manager and corruptors behind one interface."""

    def __init__(self, name: str):
        self.name = name
        if name == "jax":
            from kubeflow_tpu.cluster import chaos
            from kubeflow_tpu.runtime import checkpoint
            self.ck, self.chaos = checkpoint, chaos
        else:
            self.ck, self.chaos = TCK, TC

    def mgr(self, directory, **kw):
        return self.ck.CheckpointManager(str(directory),
                                         retry_backoff_s=0.01, **kw)

    def w0(self, mgr, **kw) -> float:
        if self.name == "torch":
            kw["device"] = "cpu"
        return float(np.asarray(mgr.restore_params(**kw)["w"])[0])


def _save(m, step, value=None):
    return bool(m.save(step, {"params": {"w": np.full(
        (64,), float(step if value is None else value), np.float32)}},
        force=True))


def _verdict(m, step):
    ok, reason = m.verify_step(step)
    return ok, reason.split()[0]


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the observation
        return "ValueError" if isinstance(e, ValueError) \
            else type(e).__name__
    return "none"


def _script_manifest(pkg, d):
    m = pkg.mgr(d, max_to_keep=3, save_interval_steps=1)
    obs = [_save(m, 1), _save(m, 2)]
    m.wait()
    obs += [os.path.exists(d / str(s) / TCK.MANIFEST_NAME) for s in (1, 2)]
    obs += [_verdict(m, 1), _verdict(m, 2), m.latest_step(), pkg.w0(m)]
    m.close()
    return obs


def _script_uncommit(pkg, d):
    m = pkg.mgr(d, max_to_keep=3)
    _save(m, 1), _save(m, 2)
    m.wait()
    pkg.chaos.uncommit_checkpoint(pkg.chaos.latest_step_dir(str(d)))
    obs = [m.latest_step(), _verdict(m, 2), pkg.w0(m), m.all_steps()]
    m.close()
    return obs


def _script_truncate(pkg, d):
    m = pkg.mgr(d, max_to_keep=3)
    _save(m, 1), _save(m, 2)
    m.wait()
    pkg.chaos.truncate_checkpoint_payload(str(d / "2"))
    obs = [_verdict(m, 2), m.latest_step(), pkg.w0(m),
           _error(lambda: pkg.w0(m, step=2)), m.intact_steps()]
    m.close()
    return obs


def _script_resave(pkg, d):
    m = pkg.mgr(d, max_to_keep=3)
    _save(m, 1), _save(m, 2)
    m.wait()
    pkg.chaos.truncate_checkpoint_payload(str(d / "2"))
    obs = [pkg.w0(m), _save(m, 2, 2.5)]
    m.wait()
    obs += [m.latest_step(), pkg.w0(m), _verdict(m, 2)]
    m._clear_corrupt_step(2)            # intact: never cleared
    obs += [m.latest_step()]
    m.close()
    return obs


def _script_lkg(pkg, d):
    m = pkg.mgr(d, max_to_keep=3)
    _save(m, 1), _save(m, 2)
    m.wait()
    obs = [m.lkg_step()]
    m.tag_lkg(1)
    obs.append(m.lkg_step())
    m.tag_lkg(2)
    m.tag_lkg(1)                         # a stale tag never regresses
    obs.append(m.lkg_step())
    m.close()
    m2 = pkg.mgr(d)
    obs.append(m2.lkg_step())            # a restarted worker reads it
    with open(d / TCK.LKG_MARKER, "w") as f:
        f.write("{not json")             # a corrupt marker: no LKG
    obs.append(m2.lkg_step())
    m2.tag_lkg(1)
    obs.append(m2.lkg_step())
    m2.close()
    return obs


def _script_retention(pkg, d):
    m = pkg.mgr(d, max_to_keep=2)
    _save(m, 1)
    m.wait()
    m.tag_lkg(1)
    for step in (2, 3, 4, 5):
        _save(m, step)
    m.wait()
    obs = [m.all_steps(), _verdict(m, 1), m.latest_step()]
    m.close()
    return obs


def _script_keep_one(pkg, d):
    m = pkg.mgr(d, max_to_keep=1)
    _save(m, 1)
    m.wait()
    m.tag_lkg(1)
    _save(m, 2)
    m.wait()
    pkg.chaos.truncate_checkpoint_payload(str(d / "2"))
    obs = [m.latest_step(), pkg.w0(m)]
    _save(m, 3)
    m.wait()
    obs += [m.all_steps(), m.latest_step()]
    m.close()
    return obs


def _script_discard(pkg, d):
    m = pkg.mgr(d, max_to_keep=3)
    for step in (1, 2, 3):
        _save(m, step)
    m.wait()
    m.discard_steps_after(1)
    obs = [m.all_steps(), pkg.w0(m)]
    m.close()
    return obs


def _script_capped_walk(pkg, d):
    m = pkg.mgr(d, max_to_keep=3)
    for step in (1, 2, 3):
        _save(m, step)
    m.wait()
    obs = [m._restore_with_fallback(lambda s: s, None, max_step=2)]
    m.close()
    pkg.chaos.truncate_checkpoint_payload(str(d / "2"))
    m2 = pkg.mgr(d)    # a fresh verify cache: the restarted worker's
    obs.append(m2._restore_with_fallback(lambda s: s, None, max_step=2))
    obs.append(_error(lambda: m2._restore_with_fallback(
        lambda s: s, None, max_step=0)))
    m2.close()
    return obs


def _script_interval(pkg, d):
    m = pkg.mgr(d, max_to_keep=3, save_interval_steps=2)
    obs = [m.should_save(s) for s in (1, 2, 3, 4)]
    obs.append(bool(m.save(1, {"params": {"w": np.ones(4, np.float32)}})))
    obs.append(bool(m.save(2, {"params": {"w": np.ones(4, np.float32)}})))
    m.wait()
    obs += [m.should_save(2), m.should_save(4), m.all_steps()]
    m.close()
    return obs


SCRIPTS = {f.__name__.removeprefix("_script_"): f for f in (
    _script_manifest, _script_uncommit, _script_truncate, _script_resave,
    _script_lkg, _script_retention, _script_keep_one, _script_discard,
    _script_capped_walk, _script_interval)}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_fault_script_matches_jax(tmp_path, script):
    got = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        d.mkdir()
        got[name] = SCRIPTS[script](_Pkg(name), d)
    assert got["torch"] == got["jax"]


def test_on_disk_contract(tmp_path):
    """Step directories by number, the commit marker, the manifest with
    the run block, the LKG marker; no temporary directory left."""
    m = TCK.CheckpointManager(str(tmp_path), run_meta={
        "replicaDegree": 2, "globalBatch": 8})
    _save(m, 3)
    m.wait()
    m.tag_lkg(3)
    m.close()
    assert sorted(os.listdir(tmp_path)) == ["3", TCK.LKG_MARKER]
    step = tmp_path / "3"
    assert {TCK.ORBAX_COMMIT_MARKER, TCK.MANIFEST_NAME} <= set(
        os.listdir(step))
    manifest = json.loads((step / TCK.MANIFEST_NAME).read_text())
    assert manifest["run"] == {"replicaDegree": 2, "globalBatch": 8}
    assert set(manifest["files"]) == {
        TCK.ORBAX_COMMIT_MARKER, "state/index.json", "state/rank-00000.pt"}
    for rel, entry in manifest["files"].items():
        # the crc32 taken while writing is the file's
        assert TCK._crc32_file(str(step / rel)) == entry["crc32"], rel
    assert json.loads((tmp_path / TCK.LKG_MARKER).read_text())["step"] == 3
    assert TCK.CheckpointManager(str(tmp_path)).run_meta_of(3) == \
        manifest["run"]


def test_restore_params_defaults_to_cuda(tmp_path, monkeypatch):
    m = TCK.CheckpointManager(str(tmp_path))
    _save(m, 1)
    m.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.restore_params()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.final_params(str(tmp_path))
    assert TC.final_params(str(tmp_path), device="cpu")["w"].device == \
        torch.device("cpu")


def test_failed_write_surfaces_at_wait(tmp_path, monkeypatch):
    m = TCK.CheckpointManager(str(tmp_path))

    def broken(obj, f):
        raise OSError("disk full")

    monkeypatch.setattr(TCK.torch, "save", broken)
    assert _save(m, 1)
    with pytest.raises(OSError, match="disk full"):
        m.wait()
    monkeypatch.undo()
    assert m.all_steps() == [] and _save(m, 1)
    m.wait()
    assert m.latest_step() == 1


# -- the training state through a checkpoint -------------------------------

FAMILIES = [("adam", "stock", False), ("adam", "fused_adam", False),
            ("momentum", "stock", False), ("lars", "stock", False),
            ("rmsprop", "stock", False), ("momentum", "stock", True)]


def _port_builder(spec, name, kernels, runtime, lr):
    return TrainStepBuilder(
        loss_fn=spec.loss_fn, device="cpu",
        optimizer=lambda p: recipe.make_optimizer(
            p, name, lr, total_steps=4, weight_decay=1e-4,
            kernels=kernels, runtime_schedule=runtime)[0])


@pytest.mark.parametrize("name,kernels,runtime", FAMILIES)
def test_jax_state_restores_and_steps(tmp_path, name, kernels, runtime):
    import jax
    from test_torch_trainstep import TINY, _tokens, numpy_params

    from kubeflow_tpu.models import transformer as J
    from kubeflow_tpu.parallel.mesh import build_mesh
    from kubeflow_tpu.runtime.recipe import make_optimizer as jmake
    from kubeflow_tpu.runtime.trainstep import TrainStepBuilder as JBuilder
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.models.convert import (
        flatten_params, optimizer_tree_from_jax,
        transformer_params_from_jax)

    lr = 1e-3
    seq = 32
    params, tokens = numpy_params(), _tokens()
    jspec = J.workload_spec(J.TransformerConfig(dtype=np.float32, **TINY),
                            seq)
    jopt, _ = jmake(name, lr, total_steps=4, weight_decay=1e-4,
                    kernels=kernels, runtime_schedule=runtime)
    jb = JBuilder(mesh=build_mesh(devices=jax.devices()[:1]),
                  loss_fn=jspec.loss_fn, optimizer=jopt)
    jstate = jb.init(lambda rng: (params, {}), jax.random.PRNGKey(0))
    jstep, jbatch = jb.build(), jb.place_batch({"tokens": tokens})
    for _ in range(3):
        jstate, _m = jstep(jstate, jbatch)
    host = jax.device_get(jstate)
    tree = {"step": 3, "variables": {},
            "params": transformer_params_from_jax(host.params),
            "opt": optimizer_tree_from_jax(host.opt_state, name, kernels,
                                           runtime)}
    jstate, jm = jstep(jstate, jbatch)
    jm = {k: float(v) for k, v in jm.items()}
    j_params = flatten_params(jax.device_get(jstate.params))

    mgr = TCK.CheckpointManager(str(tmp_path))
    mgr.save(3, tree, force=True)
    mgr.wait()
    spec = T.workload_spec(T.TransformerConfig(dtype=torch.float32, **TINY),
                           seq)
    builder = _port_builder(spec, name, kernels, runtime, lr)
    template = builder.init(
        lambda rng: (transformer_params_from_jax(numpy_params(seed=7)), {}),
        None)
    state = mgr.restore(template)
    mgr.close()
    assert state is template and state.step == 3
    state, tm = builder.build()(state, builder.place_batch(
        {"tokens": tokens}))
    assert state.step == 4
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), jm[k], rtol=1e-4,
                                   err_msg=k)
    diffs = np.concatenate([
        np.abs(state.params[n].detach().numpy() - j_params[n]).ravel()
        for n in j_params])
    assert np.mean(diffs > 1e-5) <= 1e-3, np.sort(diffs)[-10:]
    assert diffs.max() <= 3 * lr


@pytest.mark.parametrize("name,kernels,runtime", FAMILIES)
def test_state_tree_round_trip(tmp_path, name, kernels, runtime):
    """Two steps, a save, a restore into a template from other weights:
    the params, every optimizer entry and the counts come back equal, and
    the next step of both states is the same bits."""
    from kubeflow_tpu_torch.models import transformer as T
    tiny = T.TransformerConfig(vocab_size=32, num_layers=1, embed_dim=16,
                               num_heads=2, head_dim=8, mlp_dim=32,
                               max_seq_len=8, dtype=torch.float32)
    spec = T.workload_spec(tiny)
    batch = {"tokens": np.random.default_rng(0).integers(
        0, 32, (2, 8)).astype(np.int32)}

    def fresh(seed):
        b = _port_builder(spec, name, kernels, runtime, 1e-2)
        return b, b.init(spec.init_fn, torch.Generator().manual_seed(seed))

    b, state = fresh(0)
    step = b.build()
    for _ in range(2):
        state, _m = step(state, b.place_batch(batch))
    tree = state_tree(state)
    assert set(tree) == {"step", "params", "variables", "opt"}
    assert set(tree["params"]) == set(state.params)
    for leaves in tree["opt"]["slots"].values():
        assert set(leaves) == set(state.params)   # keyed by name
    mgr = TCK.CheckpointManager(str(tmp_path))
    mgr.save(2, state, force=True)
    mgr.wait()
    b2, other = fresh(1)
    restored = mgr.restore(other)
    mgr.close()
    back = state_tree(restored)
    assert back["step"] == 2 and back["opt"]["count"] == tree["opt"]["count"]
    for n, p in tree["params"].items():
        assert torch.equal(back["params"][n], p)
    for slot, leaves in tree["opt"]["slots"].items():
        for n, v in leaves.items():
            got = back["opt"]["slots"][slot][n]
            assert got.device == v.device and torch.equal(got, v), (slot, n)
    for key, v in tree["opt"]["extra"].items():
        for k, t in v.items():
            assert torch.equal(back["opt"]["extra"][key][k], t)
    _s, m1 = step(state, b.place_batch(batch))
    _s, m2 = b2.build()(restored, b2.place_batch(batch))
    assert float(m1["loss"]) == float(m2["loss"])
    for n in state.params:
        assert torch.equal(state.params[n], restored.params[n])


def test_a_rewritten_byte_is_caught_after_the_write(tmp_path, monkeypatch):
    """The manager takes each file's crc32 while writing it, knows the
    step it commits intact and checks it by the stat of its files; a
    byte rewritten in place after the commit (same size) has the step
    read again, and it fails its checksum, in the same manager and in a
    fresh one."""
    m = TCK.CheckpointManager(str(tmp_path), max_to_keep=3)
    _save(m, 1)
    _save(m, 2)
    m.wait()
    path = str(tmp_path / "2" / "state" / "rank-00000.pt")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    opened = []
    real_open = open
    monkeypatch.setattr("builtins.open", lambda p, *a, **k: (
        opened.append(str(p)), real_open(p, *a, **k))[1])
    assert m.verify_step(1) == (True, "verified (cached)")
    assert str(tmp_path / "1" / "state" / "rank-00000.pt") not in opened
    assert m.verify_step(2) == (False, "checksum mismatch "
                                "state/rank-00000.pt")
    assert path in opened
    monkeypatch.undo()
    assert TCK.CheckpointManager(str(tmp_path)).verify_step(2)[0] is False
    assert m.latest_step() == 1
    m.close()


@pytest.mark.parametrize("fault", ["prepare", "write", "commit"])
def test_save_io_is_retried_with_backoff(tmp_path, monkeypatch, fault):
    """A save's file-system I/O that fails once is retried after the
    backoff, and the step commits and restores: the temporary directory
    (``os.makedirs``), the payload (``torch.save``, on the writer
    thread) and the commit's rename (``os.rename``)."""
    m = TCK.CheckpointManager(str(tmp_path), retry_backoff_s=0.01)
    owner, name = {"prepare": (os, "makedirs"), "write": (torch, "save"),
                   "commit": (os, "rename")}[fault]
    real = getattr(owner, name)
    calls = []

    def flaky(*a, **k):
        calls.append(a)
        if len(calls) == 1:
            raise OSError("transient")
        return real(*a, **k)

    monkeypatch.setattr(owner, name, flaky)
    assert _save(m, 1)
    m.wait()
    monkeypatch.undo()
    assert len(calls) >= 2
    assert m.verify_step(1)[0] and m.latest_step() == 1
    assert float(m.restore_params(device="cpu")["w"][0]) == 1.0
    m.close()


def test_save_fails_once_its_retries_are_spent(tmp_path, monkeypatch):
    """A payload write that keeps failing is tried 1 + ``save_retries``
    times; its error surfaces at ``wait`` and no step is committed."""
    m = TCK.CheckpointManager(str(tmp_path), save_retries=2,
                              retry_backoff_s=0.01)
    calls = []

    def broken(*a, **k):
        calls.append(a)
        raise OSError("disk gone")

    monkeypatch.setattr(torch, "save", broken)
    assert _save(m, 1)
    with pytest.raises(OSError, match="disk gone"):
        m.wait()
    monkeypatch.undo()
    assert len(calls) == 3
    assert m.latest_step() is None and not (tmp_path / "1").exists()
    m.close()
