"""The port's gRPC PredictionService against the JAX package's, on the CPU.

- The tensor codec: the port encodes and the JAX package decodes, and the
  reverse, for every dtype the wire carries, in tensor_content and in the
  ``*_val`` fields (``half_val``'s bit patterns, the scalar broadcast);
  the copied pb2 is the JAX package's byte for byte.
- Predict on the small LM (2 layers, embed 64, 4 heads x 16, S 32, vocab
  256, f32; weights made with numpy from a seed and carried across by
  ``models/convert.py``): the port's server answers within 1e-4 of the
  JAX server's logits (the same arithmetic summed in another order) with
  ``next_token`` equal, through each package's ``client.predict_grpc``
  against the other's server.
- The status codes of tests/test_grpc_serving.py and the drain:
  NOT_FOUND, INVALID_ARGUMENT, RESOURCE_EXHAUSTED and UNAVAILABLE, each
  through both packages' servers over ChaosServables.

Skips only where grpcio does not import.
"""

import threading
import time

import numpy as np
import pytest

from kubeflow_tpu_torch.serving.grpc_server import HAVE_GRPC

if not HAVE_GRPC:
    pytest.skip("grpcio is not installed", allow_module_level=True)

import grpc  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.cluster import chaos as JC  # noqa: E402
from kubeflow_tpu.serving import client as JCL  # noqa: E402
from kubeflow_tpu.serving import grpc_server as JG  # noqa: E402
from kubeflow_tpu.serving import http_server as JH  # noqa: E402
from kubeflow_tpu.serving import tpu_serving_pb2 as JPB  # noqa: E402
from kubeflow_tpu_torch.cluster import chaos as TC  # noqa: E402
from kubeflow_tpu_torch.serving import client as TCL  # noqa: E402
from kubeflow_tpu_torch.serving import grpc_server as TG  # noqa: E402
from kubeflow_tpu_torch.serving import http_server as TH  # noqa: E402
from kubeflow_tpu_torch.serving import servable as TS  # noqa: E402
from kubeflow_tpu_torch.serving import tpu_serving_pb2 as TPB  # noqa: E402

from test_torch_serving import (ATOL, jax_servable, params,  # noqa: E402,F401
                                tokens, torch_servable)

DTYPES = sorted(TG._NP_TO_DT, key=str)
PACKAGES = {"jax": (JC, JG, JPB), "torch": (TC, TG, TPB)}


def test_pb2_is_the_reference_byte_for_byte():
    with open(JPB.__file__, "rb") as a, open(TPB.__file__, "rb") as b:
        assert a.read() == b.read()
    assert TPB.DESCRIPTOR.serialized_pb == JPB.DESCRIPTOR.serialized_pb
    # both register one tpu_serving.proto: the same message classes
    assert TPB.PredictRequest is JPB.PredictRequest
    assert set(TG._NP_TO_DT) == set(JG._NP_TO_DT)


def _sample(dtype: np.dtype, shape=(2, 3)) -> np.ndarray:
    rng = np.random.default_rng(0)
    if dtype == np.bool_:
        return rng.integers(0, 2, shape).astype(np.bool_)
    if np.issubdtype(dtype, np.floating):
        return rng.standard_normal(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -100), min(info.max, 100),
                        shape).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_codec_tensor_content_both_ways(dtype):
    a = _sample(dtype)
    for enc, dec in ((TG, JG), (JG, TG)):
        t = enc.ndarray_to_tensor(a)
        assert t.SerializeToString() == \
            (JG if enc is TG else TG).ndarray_to_tensor(a).SerializeToString()
        b = dec.tensor_to_ndarray(t)
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_codec_val_fields_and_scalar_broadcast(dtype):
    """Clients that fill ``*_val`` instead of tensor_content decode alike
    in both packages; one value broadcasts to the full shape; float16
    rides ``half_val`` as raw bit patterns."""
    a = _sample(dtype, (2, 2))
    t = TPB.TensorProto()
    t.dtype = TG._NP_TO_DT[np.dtype(dtype)]
    for s in a.shape:
        t.tensor_shape.dim.add().size = s
    one = TPB.TensorProto()
    one.CopyFrom(t)
    if dtype == np.float16:
        t.half_val.extend(int(b) for b in a.ravel().view(np.uint16))
        one.half_val.append(int(a.ravel()[:1].view(np.uint16)[0]))
    else:
        field = TG._DT_VAL_FIELD[t.dtype]
        getattr(t, field).extend(a.ravel().tolist())
        getattr(one, field).append(a.ravel()[0].item())
    for dec in (TG, JG):
        np.testing.assert_array_equal(dec.tensor_to_ndarray(t), a)
    if dtype != np.float16:   # half_val has no broadcast in either
        for dec in (TG, JG):
            np.testing.assert_array_equal(
                dec.tensor_to_ndarray(one), np.full(a.shape, a.ravel()[0]))


def test_codec_bf16_becomes_f32_and_bad_dtype_refused():
    x = np.asarray([[1.5, -2.25]], dtype=jnp.bfloat16)
    for enc in (TG, JG):
        t = enc.ndarray_to_tensor(x)
        assert t.dtype == TPB.DT_FLOAT
        np.testing.assert_array_equal(TG.tensor_to_ndarray(t),
                                      x.astype(np.float32))
    t = TPB.TensorProto()
    t.dtype = TPB.DT_STRING
    with pytest.raises(ValueError, match="unsupported"):
        TG.tensor_to_ndarray(t)


# ---------------------------------------------------------- the small LM


def _serve(pkg: str, servable, **kw):
    """A REST ModelServer (port 0) and a gRPC server over it, of one
    package; returns (model server, grpc server, grpc port)."""
    H, G = (JH, JG) if pkg == "jax" else (TH, TG)
    ms = H.ModelServer(host="127.0.0.1", port=0, sample_every=0, **kw)
    ms.repository.add(servable)
    ms.start()
    gs = G.GrpcPredictServer(ms, host="127.0.0.1", port=0)
    return ms, gs, gs.start()


@pytest.fixture(scope="module")
def lm_servers(params):
    """The port's and the JAX package's servers over the same weights."""
    out = {"jax": _serve("jax", jax_servable(params)),
           "torch": _serve("torch", torch_servable(params))}
    yield out
    for ms, gs, _ in out.values():
        gs.stop(grace=0)
        ms.stop()


def _predict(port: int, pb, x: np.ndarray, enc=TG):
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        req = pb.PredictRequest()
        req.model_spec.name = "lm"
        req.inputs["instances"].CopyFrom(enc.ndarray_to_tensor(x))
        resp = TG.predict_stub(channel)["Predict"](req, timeout=60)
        return {k: TG.tensor_to_ndarray(v) for k, v in resp.outputs.items()}
    finally:
        channel.close()


@pytest.mark.parametrize("rows", [1, 3])
def test_predict_matches_the_jax_server(lm_servers, rows):
    x = tokens(rows, seed=10 + rows)
    got = _predict(lm_servers["torch"][2], TPB, x)
    ref = _predict(lm_servers["jax"][2], JPB, x, enc=JG)
    assert set(got) == set(ref) == {"logits", "next_token"}
    assert got["logits"].dtype == np.float32
    np.testing.assert_allclose(got["logits"], ref["logits"], atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(got["next_token"], ref["next_token"])


def test_each_client_against_the_other_server(lm_servers):
    """The JAX package's client.predict_grpc against the port's server,
    and the port's against the JAX package's: REST-shaped results that
    agree."""
    x = tokens(2, seed=3)
    a = JCL.predict_grpc(f"127.0.0.1:{lm_servers['torch'][2]}", "lm", x,
                         dtype="int32")["predictions"]
    b = TCL.predict_grpc(f"127.0.0.1:{lm_servers['jax'][2]}", "lm", x,
                         dtype="int32")["predictions"]
    np.testing.assert_allclose(np.asarray(a["logits"]),
                               np.asarray(b["logits"]), atol=ATOL, rtol=0)
    assert a["next_token"] == b["next_token"]


def test_get_model_status_and_shared_batchers(lm_servers):
    """GetModelStatus answers the version; gRPC rows go through the REST
    server's MicroBatcher (one device queue per model)."""
    ms, _, gport = lm_servers["torch"]
    channel = grpc.insecure_channel(f"127.0.0.1:{gport}")
    try:
        req = TPB.GetModelStatusRequest()
        req.model_spec.name = "lm"
        resp = TG.predict_stub(channel)["GetModelStatus"](req, timeout=30)
        vs = resp.model_version_status[0]
        assert vs.version == 1 and vs.state == \
            TPB.ModelVersionStatus.AVAILABLE
    finally:
        channel.close()
    assert "lm" in ms._batchers
    before = ms.repository.get("lm").metadata()["stats"]["request_count"]
    TCL.predict(f"127.0.0.1:{ms.port}", "lm", tokens(1), dtype="int32")
    _predict(gport, TPB, tokens(1))
    assert ms.repository.get("lm").metadata()["stats"]["request_count"] \
        == before + 2
    row = next(m for m in ms.replica.snapshot()["models"]
               if m["model"] == "lm")
    assert row["requests"] >= 2


# --------------------------------------------------------- status codes


@pytest.fixture(params=["jax", "torch"])
def chaos_server(request):
    chaos, G, pb = PACKAGES[request.param]
    h = chaos.ServingReplicaHarness("g0", predict_s=0.001)
    h.start()
    gs = G.GrpcPredictServer(h.server, host="127.0.0.1", port=0,
                             drain_grace_s=2.0)
    port = gs.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    yield h, gs, G.predict_stub(channel), pb
    channel.close()
    gs.stop(grace=0.1)
    h.stop()


def _request(pb, model="chaos", inputs=True):
    req = pb.PredictRequest()
    req.model_spec.name = model
    if inputs:
        req.inputs["instances"].CopyFrom(
            TG.ndarray_to_tensor(np.ones((1, 3), np.float32)))
    return req


def test_ok_echo_and_request_id(chaos_server):
    _, _, stub, pb = chaos_server
    resp, call = stub["Predict"].with_call(
        _request(pb), timeout=10, metadata=(("x-request-id", "rid-7"),))
    np.testing.assert_array_equal(
        TG.tensor_to_ndarray(resp.outputs["outputs"]), np.ones((1, 3)))
    assert resp.model_spec.signature_name == "serving_default"
    assert ("x-request-id", "rid-7") in tuple(call.initial_metadata())


@pytest.mark.parametrize("case", ["unknown-model", "no-inputs",
                                  "bad-dtype"])
def test_not_found_and_invalid_argument(chaos_server, case):
    _, _, stub, pb = chaos_server
    if case == "unknown-model":
        req, code = _request(pb, model="ghost"), grpc.StatusCode.NOT_FOUND
    elif case == "no-inputs":
        req, code = _request(pb, inputs=False), \
            grpc.StatusCode.INVALID_ARGUMENT
    else:
        req, code = _request(pb), grpc.StatusCode.INVALID_ARGUMENT
        req.inputs["instances"].dtype = pb.DT_STRING
    with pytest.raises(grpc.RpcError) as err:
        stub["Predict"](req, timeout=10)
    assert err.value.code() == code


def test_shed_is_resource_exhausted(chaos_server):
    """A wedged replica with max_pending 1: the first request is in the
    device call, the second waits, the third is shed."""
    h, _, stub, pb = chaos_server
    h.server.max_pending = 1
    h.servable.wedge()
    codes = []

    def send():
        try:
            stub["Predict"](_request(pb), timeout=10)
            codes.append(grpc.StatusCode.OK)
        except grpc.RpcError as e:
            codes.append(e.code())

    threads = [threading.Thread(target=send) for _ in range(2)]
    for t in threads:
        t.start()
        time.sleep(0.2)
    with pytest.raises(grpc.RpcError) as err:
        stub["Predict"](_request(pb), timeout=10)
    assert err.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
    h.servable.unwedge()
    for t in threads:
        t.join(timeout=10)
    assert codes == [grpc.StatusCode.OK] * 2


def test_draining_and_503_are_unavailable(chaos_server):
    h, _, stub, pb = chaos_server
    h.inject("5xx-burst", n=1, status=503)
    with pytest.raises(grpc.RpcError) as err:
        stub["Predict"](_request(pb), timeout=10)
    assert err.value.code() == grpc.StatusCode.UNAVAILABLE
    h.server.replica.set_draining(True)
    with pytest.raises(grpc.RpcError) as err:
        stub["Predict"](_request(pb), timeout=10)
    assert err.value.code() == grpc.StatusCode.UNAVAILABLE


def test_stop_waits_for_inflight_rpcs():
    """stop(grace) rejects new RPCs and lets the in-flight one finish."""
    h = TC.ServingReplicaHarness("g1", predict_s=0.4)
    h.start()
    gs = TG.GrpcPredictServer(h.server, host="127.0.0.1", port=0)
    port = gs.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    out = {}

    def call():
        try:
            out["resp"] = TG.predict_stub(channel)["Predict"](
                _request(TPB), timeout=10)
        except grpc.RpcError as e:
            out["err"] = e.code()

    t = threading.Thread(target=call)
    t.start()
    time.sleep(0.1)
    gs.stop(grace=5.0)
    t.join(timeout=10)
    channel.close()
    h.stop()
    assert "resp" in out, out


def test_server_enables_the_compile_cache(tmp_path, monkeypatch):
    """A gRPC-only deployment points the kernel builds at the cache too."""
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.runtime import compile_cache as CC
    monkeypatch.setattr(_build, "_cache_dir", None)
    monkeypatch.setattr(CC, "_active", None)
    monkeypatch.setenv(CC.COMPILE_CACHE_ENV, str(tmp_path / "cache"))
    ms = TH.ModelServer(TS.ModelRepository(), host="127.0.0.1", port=0)
    TG.GrpcPredictServer(ms, port=0)
    assert _build.build_dir() == str(tmp_path / "cache")
    assert (tmp_path / "cache").is_dir()
