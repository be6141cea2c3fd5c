"""The port's serving data plane against the JAX package's, on the CPU.

Both packages serve the same weights: a flax-shaped params tree made with
numpy from a seed, swapped into the JAX servable as it is and into the
port's through ``transformer_params_from_jax``. Config: 2 layers, embed
64, 4 heads x 16, MLP 128, S 32, vocab 256, f32. Logits agree within
1e-4 absolute (the same arithmetic summed in another order) and
``next_token`` is equal.
"""

import json
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving import servable as JS
from kubeflow_tpu_torch.models.convert import transformer_params_from_jax
from kubeflow_tpu_torch.obs import goodput as gp
from kubeflow_tpu_torch.obs.trace import load_spans
from kubeflow_tpu_torch.serving import client as TC
from kubeflow_tpu_torch.serving import servable as TS
from kubeflow_tpu_torch.serving.batcher import MicroBatcher
from kubeflow_tpu_torch.serving.http_server import ModelServer, serve

from test_torch_transformer import CFG, numpy_params

ATOL = 1e-4
MAX_BATCH = 4


@pytest.fixture(scope="module")
def params():
    return numpy_params(seed=7)


def jax_servable(params, max_batch=MAX_BATCH):
    s = JS.ModelRepository().load("lm", "transformer_lm",
                                  dtype=jnp.float32, **CFG)
    s.max_batch = max_batch
    s.swap({"params": params}, 1)
    return s


def torch_servable(params, max_batch=MAX_BATCH, repo=None):
    repo = repo or TS.ModelRepository()
    s = repo.load("lm", "transformer_lm", dtype=torch.float32,
                  device="cpu", **CFG)
    s.max_batch = max_batch
    s.swap(transformer_params_from_jax({"params": params}), 1)
    return s


def tokens(rows: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (rows, CFG["max_seq_len"])).astype(np.int32)


def assert_same_predictions(got: dict, ref: dict) -> None:
    assert set(got) == {"logits", "next_token"}
    np.testing.assert_allclose(np.asarray(got["logits"], np.float32),
                               np.asarray(ref["logits"]), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(np.asarray(got["next_token"]),
                                  np.asarray(ref["next_token"]))


@pytest.mark.parametrize("rows", [1, 3, 4, 6, 9])
def test_bucket_padding_and_oversize_split(params, rows):
    """3 rows pad to bucket 4; 6 and 9 rows split into max_batch chunks
    (4+2, 4+4+1), each padded; the stages aggregate across chunks."""
    js, ts = jax_servable(params), torch_servable(params)
    x = tokens(rows, seed=rows)
    j_out, j_st = js.predict_with_stages(x)
    t_out, t_st = ts.predict_with_stages(x)
    assert_same_predictions(t_out, j_out)
    for key in ("bucket", "rows", "pad_rows"):
        assert t_st[key] == j_st[key], key
    assert t_out["logits"].shape == (rows, CFG["max_seq_len"],
                                     CFG["vocab_size"])
    assert t_out["logits"].dtype == np.float32
    assert all(t_st[k] >= 0.0 for k in ("h2d_s", "device_s", "drain_s"))
    assert ts.metadata()["stats"]["request_count"] == -(-rows // MAX_BATCH)


def test_warmup_swap_metadata_status(params):
    ts = torch_servable(params)
    assert ts.warmup() == [1, 2, 4]
    assert ts.warmup([2]) == [2]
    assert ts.start_kind == "cold"
    # warmup moves no serving metric
    assert ts.metadata()["stats"]["request_count"] == 0
    ts.swap(transformer_params_from_jax({"params": params}), 5)
    assert ts.metadata()["model_spec"] == {"name": "lm", "version": "5"}
    assert ts.status()["model_version_status"][0]["state"] == "AVAILABLE"
    assert ts.metadata()["signature_def"]["inputs"] == \
        {"shape": [-1, CFG["max_seq_len"]], "dtype": "int32"}


def test_int8_scales_and_delta_match_jax(params):
    """Per-last-axis absmax scales and int8 values are the JAX package's
    exactly; the parity gate measures the same delta on the same
    calibration batches."""
    j_q, j_stats = JS.quantize_params_int8({"params": params})
    t_q, t_stats = TS.quantize_params_int8(
        transformer_params_from_jax({"params": params}))
    assert t_stats == j_stats
    for name, node in t_q.items():
        leaf = j_q["params"]
        for part in name.split("."):
            leaf = leaf[part]
        if TS._is_qleaf(node):
            np.testing.assert_array_equal(node[TS._Q_KEY].numpy(),
                                          np.asarray(leaf[JS._Q_KEY]))
            np.testing.assert_array_equal(node[TS._SCALE_KEY].numpy(),
                                          np.asarray(leaf[JS._SCALE_KEY]))
        else:
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert tuple(t_q["layer0.attn.qkv.kernel"][TS._SCALE_KEY].shape) == \
        (1, 1, 1, CFG["head_dim"])

    calib = [tokens(8, seed=100 + i) for i in range(4)]
    jq = JS.quantize_servable(jax_servable(params), calibration=calib,
                              max_delta=1.0)
    tq = TS.quantize_servable(torch_servable(params), calibration=calib,
                              max_delta=1.0)
    assert tq.quant["accuracy_delta"] == jq.quant["accuracy_delta"]
    assert tq.quant["logits_rel_err"] == pytest.approx(
        jq.quant["logits_rel_err"], abs=1e-4)
    assert tq.quant["calibration_examples"] == 32
    assert_same_predictions(tq.predict(calib[0]), jq.predict(calib[0]))
    with pytest.raises(TS.QuantizationRefused):
        TS.quantize_servable(torch_servable(params), calibration=calib,
                             max_delta=-1.0)


@pytest.mark.parametrize("batching", ["continuous", "window"])
def test_batcher_returns_each_request_its_own_rows(params, batching):
    js, ts = jax_servable(params, max_batch=8), torch_servable(
        params, max_batch=8)
    b = MicroBatcher(ts, max_batch=8, max_latency_ms=50.0,
                     batching=batching)
    requests = [tokens(n, seed=20 + i)
                for i, n in enumerate((1, 3, 2, 1, 3, 2))]
    results: dict = {}

    def send(i):
        results[i] = b.predict(requests[i], timeout=60.0)

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(requests))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        b.shutdown()
    assert sorted(results) == list(range(len(requests)))
    for i, x in enumerate(requests):
        assert results[i]["logits"].shape[0] == x.shape[0]
        assert_same_predictions(results[i], js.predict(x))
    # requests were coalesced: fewer forwards than requests
    assert ts.metadata()["stats"]["request_count"] < len(requests)


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as resp:
        return resp.status, resp.read().decode()


def test_rest_round_trip_matches_jax(params, tmp_path):
    js = jax_servable(params)
    repo = TS.ModelRepository()
    torch_servable(params, repo=repo)
    srv = ModelServer(repo, host="127.0.0.1", port=0, max_batch=MAX_BATCH,
                      span_path=str(tmp_path / "spans.jsonl"),
                      sample_every=1)
    port = srv.start()
    try:
        for i, rows in enumerate((1, 3, 2)):
            x = tokens(rows, seed=40 + i)
            resp = TC.predict(f"127.0.0.1:{port}", "lm", x, dtype="int32",
                              request_id=f"req{i}")
            assert_same_predictions(resp["predictions"], js.predict(x))
        code, body = _get(port, "/healthz")
        assert code == 200 and json.loads(body) == {"status": "ok"}
        code, body = _get(port, "/healthz?verbose=1")
        row = next(m for m in json.loads(body)["models"]
                   if m["model"] == "lm")
        assert code == 200 and row["requests"] == 3
        code, text = _get(port, "/metrics")
        assert code == 200
        assert 'kubeflow_model_request_count{model="lm"}' in text
        assert "kftpu_serving_requests_total" in text
        code, body = _get(port, "/v1/models/lm/metadata")
        assert json.loads(body)["model_spec"]["name"] == "lm"
    finally:
        srv.stop()

    # every request's ledger partitions its wall-clock within 2%
    spans = load_spans(str(tmp_path / "spans.jsonl"))
    summaries = [s for s in spans if s["name"] == gp.SERVING_REQUEST_SPAN]
    assert sorted(s["trace_id"] for s in summaries) == \
        ["req0", "req1", "req2"]
    for s in summaries:
        led = s["attrs"]["ledger"]
        assert set(led["badputSeconds"]) == \
            set(gp.SERVING_BADPUT_CATEGORIES)
        total = led["goodputSeconds"] + sum(led["badputSeconds"].values())
        assert total == pytest.approx(led["wallSeconds"], rel=0.02,
                                      abs=1e-6)
        assert led["goodputSeconds"] > 0.0
    rollup = gp.serving_rollup(str(tmp_path / "spans.jsonl"))
    assert rollup["requests"] == 3
    assert rollup["models"][0]["model"] == "lm"
    # stage spans reconstruct the sampled request in order
    stages = [s["name"] for s in spans if s["trace_id"] == "req1"
              and s["name"] in gp.SERVING_STAGE_SPANS]
    assert stages[0] == "accept" and stages[-1] == "respond"


def test_registry_counts_each_request_before_its_response(params,
                                                          monkeypatch):
    """The request context is finished (ledger, replica registry) before
    the response bytes are written: straight after each of 50 REST
    responses, with no sleep, the registry already counts the request.
    Finishing is slowed by 20 ms, so a response written first would be
    read before its count."""
    from kubeflow_tpu_torch.serving import request_trace
    real = request_trace.RequestTrace.finish

    def slow_finish(self, *a, **kw):
        time.sleep(0.02)
        return real(self, *a, **kw)

    monkeypatch.setattr(request_trace.RequestTrace, "finish", slow_finish)
    repo = TS.ModelRepository()
    torch_servable(params, repo=repo)
    srv = ModelServer(repo, host="127.0.0.1", port=0, max_batch=MAX_BATCH,
                      sample_every=0)
    port = srv.start()
    try:
        x = tokens(1)
        for i in range(50):
            TC.predict(f"127.0.0.1:{port}", "lm", x, dtype="int32")
            row = next(m for m in srv.replica.snapshot()["models"]
                       if m["model"] == "lm")
            assert row["requests"] == i + 1, i
    finally:
        srv.stop()


def test_decompose_request_partitions_the_wall():
    led = gp.decompose_request(0.100, {
        gp.SERVING_QUEUE: 0.02, gp.SERVING_BATCH_FORM: 0.005,
        gp.SERVING_H2D: 0.003, gp.SERVING_DEVICE: 0.05,
        gp.SERVING_PAD_WASTE: 0.01, gp.SERVING_RESPOND: 0.007})
    total = led["goodputSeconds"] + sum(led["badputSeconds"].values())
    assert total == pytest.approx(0.100)
    assert led["badputSeconds"][gp.BADPUT_OTHER] == pytest.approx(0.005)
    assert led["goodputRatio"] == pytest.approx(0.5)
    assert gp._percentile([1.0, 2.0, 3.0, 4.0], 0.5) == 3.0


def test_cli_refuses_grpc_until_ported(params, monkeypatch, capsys):
    """The gRPC surface is ported: ``--grpc-port N`` serves
    PredictionService beside REST on the same MicroBatcher (same answers),
    and without grpcio the CLI says it serves REST only."""
    import socket

    from kubeflow_tpu_torch.serving import grpc_server
    real = TS._MODEL_BUILDERS["transformer_lm"]
    monkeypatch.setitem(TS._MODEL_BUILDERS, "transformer_lm",
                        lambda **kw: real(**{**CFG, **kw,
                                             "dtype": torch.float32}))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        gport = sock.getsockname()[1]
    argv = ["--model-type", "transformer_lm", "--model-name", "lm",
            "--device", "cpu", "--rest-port", "0", "--max-batch", "4",
            "--attention", "flash"]
    running = serve(argv + ["--grpc-port", str(gport)])
    try:
        assert running["grpc"].port == gport
        running["servable"].swap(
            transformer_params_from_jax({"params": params}), 1)
        x = tokens(2, seed=4)
        rest = TC.predict(f"127.0.0.1:{running['server'].port}", "lm", x,
                          dtype="int32")["predictions"]
        got = TC.predict_grpc(f"127.0.0.1:{gport}", "lm", x,
                              dtype="int32")["predictions"]
        assert_same_predictions(got, rest)
        assert running["servable"].start_kind == "cold"
    finally:
        running["grpc"].stop(grace=0)
        running["server"].stop()
    assert f"gRPC PredictionService on :{gport}" in capsys.readouterr().out
    monkeypatch.setattr(grpc_server, "HAVE_GRPC", False)
    running = serve(argv + ["--grpc-port", str(gport), "--no-warmup"])
    running["server"].stop()
    assert running["grpc"] is None
    assert "serving REST only" in capsys.readouterr().out


def test_unknown_model_type_and_resnet_signature():
    repo = TS.ModelRepository()
    with pytest.raises(KeyError, match="resnet77"):
        repo.load("r", "resnet77", device="cpu")
    r = repo.load("r", "resnet50", device="cpu")
    assert r.input_signature["inputs"]["shape"] == [-1, 224, 224, 3]


def test_client_retry_helpers():
    assert TC.retry_after_s({"Retry-After": "2.5"}) == 2.5
    assert TC.retry_after_s({"Retry-After": "soon"}) is None
    assert TC.retry_after_s(None) is None
    for _ in range(20):
        assert 0.2 <= TC.jittered_backoff(0.2) <= 0.3
