"""Serving from checkpoints, the port alone (the scripts through both
packages are tests/test_torch_serving_ckpt.py and
tests/test_torch_serving_ckpt_scripts.py): reload from the trainer's
``TrainState`` checkpoints written by the port's ``train()`` (the
params, and ResNet's ``batch_stats``, equal to the trainer's, bit for
bit); a poll re-hashes no unchanged step; the int8 tier re-quantizes a
reloaded version behind its parity gate, into the servable a server's
batcher holds, so the REST path serves the new version; the server CLI's
``--model-path`` serves a trainer's directory and ``--poll-interval``
polls it.
"""

import time

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.cluster.chaos import final_params
from kubeflow_tpu_torch.models import transformer as TT
from kubeflow_tpu_torch.runtime import worker
from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
from kubeflow_tpu_torch.serving import servable as TS
from tests.test_torch_serving_ckpt import (LM, MODELS, RESNET, _inputs,
                                           _load, _same_as, _save)


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
