"""The port's ResNet servables against the JAX package's, on the CPU.

Both packages serve the same variables: a flax-shaped (params,
batch_stats) made with numpy from a seed (BN scales 1 + N(0, 0.1), biases
and running means N(0, 0.1), variances U(0.5, 1.5), so no block hides
behind a zero scale), swapped into the JAX servable as they are and into
the port's through ``resnet_variables_from_jax``. Config: resnet50, 10
classes, 32 px, bf16 activations, max_batch 4.

Logits agree within 3e-2 of the largest logit: both round every conv
output and BatchNorm result to bf16 at the same places but sum in another
order, so a value can land one bf16 step (2^-8) away at any of 50 layers
(tests/test_torch_resnet.py's bf16 bar). ``classes`` are equal.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu.models import RESNET_DEPTHS
from kubeflow_tpu.serving import servable as JS
from kubeflow_tpu_torch.models.convert import resnet_variables_from_jax
from kubeflow_tpu_torch.serving import servable as TS
from kubeflow_tpu_torch.serving.http_server import main
from tests.test_torch_resnet import numpy_variables

SIZE, CLASSES, MAX_BATCH = 32, 10, 4
LOGIT_TOL = 3e-2


@pytest.fixture(scope="module")
def variables():
    return numpy_variables(50, SIZE, seed=11)


@pytest.fixture(scope="module")
def servables(variables):
    params, stats = variables
    js = JS.ModelRepository().load("r", "resnet50", num_classes=CLASSES,
                                   image_size=SIZE)
    js.max_batch = MAX_BATCH
    js.swap({"params": params, "batch_stats": stats}, 1)
    ts = TS.ModelRepository().load("r", "resnet50", num_classes=CLASSES,
                                   image_size=SIZE, device="cpu")
    ts.max_batch = MAX_BATCH
    tp, tstats = resnet_variables_from_jax(params, stats)
    ts.swap({"params": tp, "batch_stats": tstats}, 1)
    return js, ts


def images(rows: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (rows, SIZE, SIZE, 3)).astype(np.float32)


def assert_same_predictions(got: dict, ref: dict) -> None:
    assert set(got) == {"logits", "classes"}
    lg, lr = np.asarray(got["logits"]), np.asarray(ref["logits"], np.float32)
    assert lg.dtype == np.float32 and lg.shape == lr.shape
    err = np.abs(lg - lr).max()
    assert err <= LOGIT_TOL * np.abs(lr).max(), err
    np.testing.assert_array_equal(got["classes"], np.asarray(ref["classes"]))


@pytest.mark.parametrize("rows", [1, 3, 6])
def test_bucket_padding_and_oversize_split(servables, rows):
    """3 rows pad to bucket 4; 6 rows split into 4 + 2, each padded; the
    stages aggregate across the chunks."""
    js, ts = servables
    x = images(rows, seed=rows)
    j_out, j_st = js.predict_with_stages(x)
    t_out, t_st = ts.predict_with_stages(x)
    assert_same_predictions(t_out, j_out)
    assert t_out["logits"].shape == (rows, CLASSES)
    for key in ("bucket", "rows", "pad_rows"):
        assert t_st[key] == j_st[key], key


def test_signature_and_shared_init():
    """The JAX builder's signature; two loads share their seeded weights,
    which carry params and batch_stats through the device move."""
    repo = TS.ModelRepository()
    a = repo.load("a", "resnet18", num_classes=CLASSES, image_size=SIZE,
                  device="cpu")
    b = repo.load("b", "resnet18", num_classes=CLASSES, image_size=SIZE,
                  device="cpu")
    assert a.input_signature == JS._build_resnet(
        18, num_classes=CLASSES, image_size=SIZE)[2]
    assert set(a.params) == {"params", "batch_stats"}
    for group in ("params", "batch_stats"):
        assert set(a.params[group]) == set(b.params[group])
        assert all(torch.equal(a.params[group][k], b.params[group][k])
                   for k in a.params[group])


def test_warmup_runs_every_bucket(servables):
    _, ts = servables
    assert ts.warmup() == [1, 2, 4]


def test_int8_matches_jax(variables, servables):
    """The whole variables tree quantizes as the JAX package's does: every
    conv kernel and the head kernel (rank >= 2) to int8 with per-channel
    scales, every BN parameter, bias and running statistic kept float; the
    same counts, bytes, scales and measured delta over the same
    calibration batches."""
    params, stats = variables
    js, ts = servables
    jq, jstats = JS.quantize_params_int8(
        {"params": params, "batch_stats": stats})
    tq, tstats = TS.quantize_params_int8(ts.params)
    assert tstats == jstats
    n_kernels = sum(k.endswith("kernel") for k in ts.params["params"])
    assert tstats["quantized_leaves"] == n_kernels
    for name in ("conv_init.kernel", "stage2_block1.Conv_1.kernel",
                 "head.kernel"):
        leaf = jq["params"]
        for part in name.split("."):
            leaf = leaf[part]
        np.testing.assert_allclose(
            tq["params"][name][TS._SCALE_KEY].numpy(),
            np.asarray(leaf[JS._SCALE_KEY]), rtol=1e-6)
        np.testing.assert_array_equal(tq["params"][name][TS._Q_KEY].numpy(),
                                      np.asarray(leaf[JS._Q_KEY]))
    assert tq["batch_stats"]["bn_init.var"] is ts.params["batch_stats"][
        "bn_init.var"]
    calib = [images(4, seed=20 + i) for i in range(2)]
    jint8 = JS.quantize_servable(js, calib, max_delta=1.0)
    tint8 = TS.quantize_servable(ts, calib, max_delta=1.0)
    assert tint8.quant["accuracy_delta"] == jint8.quant["accuracy_delta"]
    for k in ("quantized_leaves", "float_leaves", "weight_bytes_float",
              "weight_bytes_int8", "calibration_examples"):
        assert tint8.quant[k] == jint8.quant[k], k
    assert_same_predictions(tint8.predict(calib[0]),
                            jint8.predict(calib[0]))


def test_registry_covers_the_family():
    """The servable half of tests/test_ops.py's family test."""
    family = {f"resnet{d}" for d in RESNET_DEPTHS}
    assert family <= set(TS._MODEL_BUILDERS)
    assert family <= set(JS._MODEL_BUILDERS)
    with pytest.raises(KeyError, match="resnet77"):
        TS.ModelRepository().load("r", "resnet77", device="cpu")


def test_server_cli_default_model_type_loads_and_serves(monkeypatch):
    """``http_server`` with no --model-type loads resnet50 at its full
    width (224 px, 1000 classes; the JAX server's default) and answers a
    REST :predict. The CLI blocks until SIGTERM, so its server's start is
    wrapped: it starts, serves one request, stops and leaves the CLI."""
    from kubeflow_tpu_torch.serving import client, http_server
    answered = {}
    start = http_server.ModelServer.start

    class Served(Exception):
        pass

    def start_serve_stop(self):
        port = start(self)
        try:
            resp = client.predict(f"127.0.0.1:{port}", "model",
                                  images_224(1), timeout_s=120.0,
                                  retries=0)
            answered["shape"] = np.asarray(
                resp["predictions"]["logits"]).shape
            answered["models"] = self.repository.names()
        finally:
            self.stop()
        raise Served

    monkeypatch.setattr(http_server.ModelServer, "start", start_serve_stop)
    with pytest.raises(Served):
        main(["--device", "cpu", "--no-warmup", "--max-batch", "1",
              "--rest-port", "0"])
    assert answered == {"shape": (1, 1000), "models": ["model"]}


def images_224(rows: int) -> np.ndarray:
    return np.random.default_rng(0).standard_normal(
        (rows, 224, 224, 3)).astype(np.float32)
