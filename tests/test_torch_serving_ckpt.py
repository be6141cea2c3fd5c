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

Port only: reload from the trainer's ``TrainState`` checkpoints written
by the port's ``train()`` (the params, and ResNet's ``batch_stats``,
equal to the trainer's, bit for bit); a poll re-hashes no unchanged
step; the int8 tier re-quantizes a reloaded version behind its parity
gate, into the servable a server's batcher holds, so the REST path
serves the new version; the server CLI's ``--model-path`` serves a
trainer's directory and ``--poll-interval`` polls it.
"""

import time

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.cluster.chaos import final_params
from kubeflow_tpu_torch.models.convert import (resnet_variables_from_jax,
                                               transformer_params_from_jax)
from kubeflow_tpu_torch.models import resnet as TR
from kubeflow_tpu_torch.models import transformer as TT
from kubeflow_tpu_torch.runtime import worker
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


@pytest.mark.parametrize("model", sorted(MODELS))
def test_server_before_trainer_picks_up_first_checkpoint(tmp_path, model):
    _both(_script_server_before_trainer, model, tmp_path)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_polling_reloads_in_background(tmp_path, model):
    _both(_script_polling, model, tmp_path)


# -- the port alone ---------------------------------------------------------


def _train_kw(model: str) -> dict:
    if model == "lm":
        return dict(workload="transformer", optimizer="adam",
                    learning_rate=1e-2, global_batch=2,
                    workload_kwargs={"cfg": TT.TransformerConfig(**LM)})
    return dict(workload="resnet50", global_batch=2,
                workload_kwargs=dict(RESNET))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_reload_from_trainer_trainstate_checkpoint(tmp_path, model):
    """The trainer writes whole TrainState trees; the server takes the
    params (and ResNet's batch statistics) out of them."""
    ckpt = str(tmp_path / "ckpt")
    kw = dict(_train_kw(model), device="cpu", handle_sigterm=False,
              sync_every=1, checkpoint_every=1, checkpoint_dir=ckpt)
    worker.train(steps=2, **kw)
    repo = TS.ModelRepository()
    s = _load(repo, model, ckpt)
    assert s.version == 2
    mgr = CheckpointManager(ckpt)
    want = mgr.restore_params(device="cpu", variables=model == "resnet")
    _same_as(model, s, want)
    worker.train(steps=4, **kw)
    assert repo.reload(model) and s.version == 4
    got = s.params["params"] if model == "resnet" else s.params
    fp = final_params(ckpt, device="cpu")
    for k, v in fp.items():
        assert torch.equal(got[k], v), k
    if model == "resnet":
        stats = mgr.read_tree(4, only=("variables",))["variables"]
        for k, v in stats["batch_stats"].items():
            assert torch.equal(s.params["batch_stats"][k], v), k


def test_poll_does_not_rehash_unchanged_steps(tmp_path, monkeypatch):
    """The repository keeps one manager per source: once a step verified
    against its manifest, a later poll finds it in the cache."""
    from kubeflow_tpu_torch.runtime import checkpoint as TCK
    ckpt = tmp_path / "ckpt"
    _save(ckpt, "lm", 1, seed=1)
    repo = TS.ModelRepository()
    _load(repo, "lm", ckpt)
    hashed = []
    real = TCK._crc32_file
    monkeypatch.setattr(TCK, "_crc32_file",
                        lambda path, *a: hashed.append(path) or real(path))
    for _ in range(3):
        assert not repo.reload("lm")
    assert hashed == []


def test_int8_reload_requantizes_behind_the_gate(tmp_path):
    ckpt = tmp_path / "ckpt"
    _save(ckpt, "lm", 1, seed=1)
    repo = TS.ModelRepository()
    s = _load(repo, "lm", ckpt, kernels="int8", quant_max_delta=1.0)
    assert s.version == 1 and s.quant is not None
    w = _save(ckpt, "lm", 2, seed=2)
    assert repo.reload("lm")
    q = repo.get("lm")
    assert q is s and q.version == 2 and q.quant["max_delta"] == 1.0
    ref = _load(TS.ModelRepository(), "lm")
    ref.swap(w, 2)
    want = TS.quantize_servable(ref, max_delta=1.0)
    x = _inputs("lm")
    np.testing.assert_array_equal(q.predict(x)["logits"],
                                  want.predict(x)["logits"])
    # a version the gate refuses keeps the old one serving
    q.quant["max_delta"] = -1.0
    _save(ckpt, "lm", 3, seed=3)
    assert not repo.reload("lm") and repo.get("lm").version == 2


def _serve_cli(monkeypatch, argv: list, while_serving) -> None:
    """Run the server CLI on the small LM until it has started; call
    ``while_serving(server, port)``, then stop it (the CLI otherwise
    blocks until SIGTERM)."""
    from kubeflow_tpu_torch.serving import http_server
    start = http_server.ModelServer.start

    class Served(Exception):
        pass

    def start_serve_stop(self):
        port = start(self)
        try:
            while_serving(self, port)
        finally:
            self.repository.stop_polling()
            self.stop()
        raise Served

    monkeypatch.setattr(http_server.ModelServer, "start", start_serve_stop)
    real = TS._MODEL_BUILDERS["transformer_lm"]
    monkeypatch.setitem(TS._MODEL_BUILDERS, "transformer_lm",
                        lambda **kw: real(**{**LM, **kw}))
    with pytest.raises(Served):
        http_server.main(["--model-type", "transformer_lm", "--device",
                          "cpu", "--no-warmup", "--rest-port", "0",
                          *argv])


def test_int8_reload_is_served_over_rest(tmp_path, monkeypatch):
    """An int8 server on a model path (``--kernel-serving int8
    --poll-interval``) answers with the new version's quantized logits
    once the poll has reloaded it: the version is swapped into the
    servable the server's batcher holds."""
    from kubeflow_tpu_torch.serving import client
    ckpt = tmp_path / "ckpt"
    w = {4: _save(ckpt, "lm", 4, seed=2)}
    seen = {}

    def two_versions(server, port):
        seen[4] = client.predict(f"127.0.0.1:{port}", "model",
                                 _inputs("lm"), dtype="int32")
        w[6] = _save(ckpt, "lm", 6, seed=6)
        s = server.repository.get("model")
        deadline = time.time() + 20
        while s.version != 6 and time.time() < deadline:
            time.sleep(0.05)
        assert s.version == 6
        seen[6] = client.predict(f"127.0.0.1:{port}", "model",
                                 _inputs("lm"), dtype="int32")

    _serve_cli(monkeypatch, ["--model-path", str(ckpt), "--poll-interval",
                             "0.05", "--kernel-serving", "int8",
                             "--int8-max-delta", "1.0"], two_versions)
    for version in (4, 6):
        ref = _load(TS.ModelRepository(), "lm")
        ref.swap(w[version], version)
        want = TS.quantize_servable(ref, max_delta=1.0).predict(
            _inputs("lm"))
        np.testing.assert_array_equal(
            np.asarray(seen[version]["predictions"]["logits"], np.float32),
            want["logits"])


def test_server_cli_serves_a_trainers_directory(tmp_path, monkeypatch):
    """``--model-path`` loads the trainer's newest step and
    ``--poll-interval`` polls the directory; the CLI's server is started,
    answers one request and stops."""
    from kubeflow_tpu_torch.serving import client
    ckpt = tmp_path / "ckpt"
    w = _save(ckpt, "lm", 4, seed=2)
    seen = {}

    def one_request(server, port):
        seen["resp"] = client.predict(f"127.0.0.1:{port}", "model",
                                      _inputs("lm"), dtype="int32")
        seen["version"] = server.repository.get("model").version
        seen["polling"] = server.repository._poll_thread is not None

    _serve_cli(monkeypatch, ["--model-path", str(ckpt), "--poll-interval",
                             "0.05"], one_request)
    assert seen["version"] == 4 and seen["polling"]
    ref = _load(TS.ModelRepository(), "lm")
    ref.swap(w, 1)
    np.testing.assert_array_equal(
        np.asarray(seen["resp"]["predictions"]["next_token"]),
        ref.predict(_inputs("lm"))["next_token"])
