"""Serving from checkpoints: ``ModelRepository`` with a checkpoint
directory as its version source, for the LM and resnet50, on the CPU.

The scripts of ``tests/test_serving.py`` :57-170 run through both
packages' repositories: a checkpoint round trip (the step is the
version), hot reload of a newer step (none without a checkpoint source),
a server started before the trainer (version 0, then the trainer's first
step) and background polling. Each package saves the same seeded
weights with its own ``CheckpointManager`` (the JAX package with orbax,
in its layout; the port the conversion by ``models/convert.py``, as a
trainer's tree) and reads only its own payloads. The versions and the
reload results must be equal, and the predictions agree within the bars
of ``tests/test_torch_serving.py`` (LM, f32: logits within 1e-4
absolute, ``next_token`` equal) and ``tests/test_torch_resnet.py``
(resnet50 in the servables' bf16: logits within 3e-2 of the largest
logit, ``classes`` equal).

This file holds the round trip and hot reload;
tests/test_torch_serving_ckpt_scripts.py the server started before the
trainer and polling (the files are split so that the test runner's
workers take them in parallel). The port alone, reload from a trainer's
``TrainState`` checkpoints, the int8 reload and the server CLI, is in
tests/test_torch_serving_ckpt_trainer.py.
"""

import time

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models.convert import (resnet_variables_from_jax,
                                               transformer_params_from_jax)
from kubeflow_tpu_torch.models import resnet as TR
from kubeflow_tpu_torch.models import transformer as TT
from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
from kubeflow_tpu_torch.serving import servable as TS

LM = dict(vocab_size=256, num_layers=1, embed_dim=16, num_heads=2,
          head_dim=8, mlp_dim=32, max_seq_len=16, dtype=torch.float32)
RESNET = dict(num_classes=10, image_size=32)
MODELS = {"lm": ("transformer_lm", LM), "resnet": ("resnet50", RESNET)}


def _weights(model: str, seed: int) -> dict:
    """A servable's params tree of seeded weights: the LM's state dict,
    or ResNet's ``{"params", "batch_stats"}``."""
    gen = torch.Generator().manual_seed(seed)
    if model == "lm":
        m = TT.TransformerLM(TT.TransformerConfig(**LM))
        m.init_weights(gen)
        return {k: v.detach().clone() for k, v in m.state_dict().items()}
    params, variables = TR.make_resnet(
        50, num_classes=RESNET["num_classes"]).init(gen)
    return {"params": params, **variables}


def _tree(model: str, weights: dict, step: int) -> dict:
    """The trainer's tree for ``weights``."""
    if model == "lm":
        return {"step": step, "params": weights, "variables": {}}
    return {"step": step, "params": weights["params"],
            "variables": {"batch_stats": weights["batch_stats"]}}


def _save(directory, model: str, step: int, seed: int) -> dict:
    w = _weights(model, seed)
    mgr = CheckpointManager(str(directory))
    mgr.save(step, _tree(model, w, step), force=True)
    mgr.close()
    return w


def _inputs(model: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    if model == "lm":
        return rng.integers(0, LM["vocab_size"], (2, 16)).astype(np.int32)
    return rng.standard_normal((2, 32, 32, 3)).astype(np.float32)


def _load(repo, model: str, directory=None, **kw):
    model_type, cfg = MODELS[model]
    return repo.load(model, model_type, checkpoint_dir=directory and
                     str(directory), device="cpu", **cfg, **kw)


def _same_as(model: str, servable, weights: dict) -> None:
    ref = _load(TS.ModelRepository(), model)
    ref.swap(weights, 1)
    x = _inputs(model)
    got, want = servable.predict(x), ref.predict(x)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# -- the scripts through both repositories ---------------------------------

# the LM of tests/test_torch_serving.py (tests/test_torch_transformer.py's
# CFG) in f32; resnet50 at 32 px, 10 classes, in the builders' bf16
LM_X = dict(vocab_size=256, num_layers=2, embed_dim=64, num_heads=4,
            head_dim=16, mlp_dim=128, max_seq_len=32)
LM_ATOL = 1e-4
RESNET_REL = 3e-2


class _Pkg:
    """One package's repository and checkpoint manager behind one
    interface. JAX is imported inside the methods."""

    def __init__(self, name: str):
        self.name = name

    def repo(self):
        if self.name == "jax":
            from kubeflow_tpu.serving import servable as JS
            return JS.ModelRepository()
        return TS.ModelRepository()

    def load(self, repo, model: str, directory=None):
        if model == "lm":
            if self.name == "jax":
                import jax.numpy as jnp
                kw = dict(LM_X, dtype=jnp.float32)
            else:
                kw = dict(LM_X, dtype=torch.float32)
            model_type = "transformer_lm"
        else:
            kw, model_type = dict(RESNET), "resnet50"
        if self.name == "torch":
            kw["device"] = "cpu"
        return repo.load(model, model_type, checkpoint_dir=directory and
                         str(directory), **kw)

    def save(self, directory, model: str, step: int, seed: int) -> None:
        """Seeded numpy weights in the JAX package's layout (the
        servable's variables tree, as its ``restore_params`` returns
        it); the port saves their conversion as a trainer's tree."""
        if model == "lm":
            from test_torch_transformer import numpy_params
            flax = {"params": numpy_params(seed)}
            port = transformer_params_from_jax(flax)
        else:
            from test_torch_resnet import numpy_variables
            p, stats = numpy_variables(50, RESNET["image_size"], seed)
            flax = {"params": p, "batch_stats": stats}
            tp, ts = resnet_variables_from_jax(p, stats)
            port = {"params": tp, "batch_stats": ts}
        if self.name == "jax":
            from kubeflow_tpu.runtime.checkpoint import \
                CheckpointManager as JaxManager
            mgr = JaxManager(str(directory))
            mgr.save(step, {"params": flax}, force=True)
            mgr.wait()
        else:
            mgr = CheckpointManager(str(directory))
            mgr.save(step, _tree(model, port, step), force=True)
        mgr.close()


def _x_inputs(model: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    if model == "lm":
        return rng.integers(0, LM_X["vocab_size"],
                            (2, LM_X["max_seq_len"])).astype(np.int32)
    return rng.standard_normal((2, 32, 32, 3)).astype(np.float32)


def _script_roundtrip(pkg, model, d):
    pkg.save(d, model, 7, seed=3)
    s = pkg.load(pkg.repo(), model, d)
    return [s.version], s


def _script_hot_reload(pkg, model, d):
    pkg.save(d, model, 1, seed=1)
    repo = pkg.repo()
    s = pkg.load(repo, model, d)
    obs = [s.version, repo.reload(model)]
    pkg.save(d, model, 5, seed=5)
    obs += [repo.reload(model), s.version, repo.reload(model)]
    repo2 = pkg.repo()
    pkg.load(repo2, model)
    obs.append(repo2.reload(model))    # no checkpoint source: a no-op
    return obs, s


def _script_server_before_trainer(pkg, model, d):
    repo = pkg.repo()
    s = pkg.load(repo, model, d)
    obs = [s.version]                   # the seed weights
    pkg.save(d, model, 1, seed=9)
    obs += [repo.reload(model), s.version]
    return obs, s


def _script_polling(pkg, model, d):
    pkg.save(d, model, 1, seed=1)
    repo = pkg.repo()
    s = pkg.load(repo, model, d)
    obs = [s.version]
    repo.start_polling(interval_s=0.05)
    try:
        pkg.save(d, model, 9, seed=4)
        deadline = time.time() + 20
        while s.version != 9 and time.time() < deadline:
            time.sleep(0.05)
        obs.append(s.version)
    finally:
        repo.stop_polling()
    return obs, s


def _both(script, model: str, tmp_path) -> None:
    """Run ``script`` through both packages: equal observations, and the
    final servables' predictions within the model's bar."""
    (jobs, js), (tobs, ts) = (
        script(_Pkg(name), model, tmp_path / name)
        for name in ("jax", "torch"))
    assert tobs == jobs
    x = _x_inputs(model)
    got, want = ts.predict(x), js.predict(x)
    want = {k: np.asarray(v, np.float32) for k, v in want.items()}
    assert set(got) == set(want)
    if model == "lm":
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   atol=LM_ATOL, rtol=0)
        np.testing.assert_array_equal(got["next_token"],
                                      want["next_token"])
    else:
        err = np.abs(got["logits"] - want["logits"]).max()
        assert err <= RESNET_REL * np.abs(want["logits"]).max(), err
        np.testing.assert_array_equal(got["classes"], want["classes"])


@pytest.mark.parametrize("model", sorted(MODELS))
def test_repository_checkpoint_roundtrip(tmp_path, model):
    _both(_script_roundtrip, model, tmp_path)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_hot_reload_picks_up_new_version(tmp_path, model):
    _both(_script_hot_reload, model, tmp_path)
