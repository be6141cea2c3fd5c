"""The gRPC predict surface: TF-Serving's PredictionService on :9000.

The port of ``kubeflow_tpu/serving/grpc_server.py``: the same wire
contract — PredictRequest/PredictResponse and GetModelStatus with
upstream field numbers (serving/tpu_serving_pb2.py, a byte-for-byte copy
of the JAX package's, so both packages register the same
``tpu_serving.proto`` in protobuf's default pool) — so stock TF-Serving
clients work unmodified.

grpcio generic handlers (no generated service stubs: protoc's message
codegen plus method registration by full name), sharing the
ModelServer's MicroBatchers so gRPC and REST rows batch together on the
card. Outputs leave the card as the REST path's do (the servable copies
them to host numpy); a dtype the wire has no code for (bfloat16) is sent
as f32. Messages are unbounded in size both ways: one row of LM logits
is tens of MB, past grpcio's 4 MB default.
"""

from __future__ import annotations

import logging
import time
from concurrent import futures
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

try:
    # one guard for the whole optional surface: grpcio AND the protobuf
    # runtime behind the generated pb2 (neither is a hard dependency; the
    # REST server must keep starting without them)
    import grpc
    from . import tpu_serving_pb2 as pb
    HAVE_GRPC = True
except ImportError:
    grpc = None
    pb = None
    HAVE_GRPC = False

SERVICE = "tensorflow.serving.PredictionService"
# grpcio's channel/server options for unbounded messages both ways
MESSAGE_OPTIONS = (("grpc.max_send_message_length", -1),
                   ("grpc.max_receive_message_length", -1))

if HAVE_GRPC:
    _NP_TO_DT = {
        np.dtype(np.float32): pb.DT_FLOAT,
        np.dtype(np.float64): pb.DT_DOUBLE,
        np.dtype(np.int32): pb.DT_INT32,
        np.dtype(np.uint8): pb.DT_UINT8,
        np.dtype(np.int16): pb.DT_INT16,
        np.dtype(np.int8): pb.DT_INT8,
        np.dtype(np.int64): pb.DT_INT64,
        np.dtype(np.bool_): pb.DT_BOOL,
        np.dtype(np.uint32): pb.DT_UINT32,
        np.dtype(np.uint64): pb.DT_UINT64,
        np.dtype(np.float16): pb.DT_HALF,
    }
    _DT_TO_NP = {v: k for k, v in _NP_TO_DT.items()}

    # repeated-field name per dtype for sparse (non-tensor_content)
    # encoding; DT_HALF is special-cased in tensor_to_ndarray (half_val
    # carries raw float16 bit patterns in int32 slots, TF convention)
    _DT_VAL_FIELD = {
        pb.DT_FLOAT: "float_val", pb.DT_DOUBLE: "double_val",
        pb.DT_INT32: "int_val", pb.DT_UINT8: "int_val",
        pb.DT_INT16: "int_val", pb.DT_INT8: "int_val",
        pb.DT_INT64: "int64_val", pb.DT_BOOL: "bool_val",
        pb.DT_UINT32: "uint32_val", pb.DT_UINT64: "uint64_val",
    }
else:
    _NP_TO_DT = {}
    _DT_TO_NP = {}
    _DT_VAL_FIELD = {}


def tensor_to_ndarray(t) -> np.ndarray:
    """TensorProto → numpy, accepting both tensor_content and *_val forms
    (clients use either; tf.make_tensor_proto prefers tensor_content)."""
    if t.dtype not in _DT_TO_NP:
        raise ValueError(f"unsupported tensor dtype {t.dtype}")
    np_dtype = _DT_TO_NP[t.dtype]
    shape = [d.size for d in t.tensor_shape.dim]
    if t.tensor_content:
        arr = np.frombuffer(t.tensor_content, dtype=np_dtype)
    elif t.dtype == pb.DT_HALF:
        # half_val carries raw float16 bit patterns in int32 slots
        arr = np.array(list(t.half_val), dtype=np.uint16).view(np.float16)
    else:
        field = _DT_VAL_FIELD[t.dtype]
        arr = np.array(list(getattr(t, field)), dtype=np_dtype)
        # TF semantics: a single value broadcasts to the full shape
        n = int(np.prod(shape)) if shape else arr.size
        if arr.size == 1 and n > 1:
            arr = np.full(n, arr[0], dtype=np_dtype)
    return arr.reshape(shape) if shape else arr


def ndarray_to_tensor(a: np.ndarray):
    a = np.asarray(a)
    if a.dtype not in _NP_TO_DT:
        a = a.astype(np.float32)  # e.g. bfloat16 outputs
    t = pb.TensorProto()
    t.dtype = _NP_TO_DT[a.dtype]
    for s in a.shape:
        t.tensor_shape.dim.add().size = s
    t.tensor_content = np.ascontiguousarray(a).tobytes()
    return t


class GrpcPredictServer:
    """PredictionService over a ModelServer (shares its MicroBatchers)."""

    def __init__(self, model_server, host: str = "0.0.0.0",
                 port: int = 9000, max_workers: int = 8,
                 drain_grace_s: float = 10.0):
        if not HAVE_GRPC:
            raise RuntimeError("grpcio is not available")
        # graceful-shutdown budget: stop() lets in-flight RPCs run this
        # long before hard-cancelling (the REST server's drain analog)
        self.drain_grace_s = drain_grace_s
        # a gRPC-only deployment (no REST main()) must point the kernel
        # builds at the cache too, before the first request launches one
        # (no-op without KFTPU_COMPILE_CACHE_DIR; idempotent)
        from ..runtime.compile_cache import enable_compilation_cache
        enable_compilation_cache()
        self.model_server = model_server
        self.host, self.port = host, port
        self.max_workers = max_workers
        self._server = None

    # -- handlers -----------------------------------------------------------

    def _predict(self, request, context):
        from .batcher import QueueFullError
        from .request_trace import REQUEST_ID_HEADER, mint_request_id
        name = request.model_spec.name
        # request id over gRPC metadata (the x-request-id header's
        # wire-equivalent), echoed as initial metadata
        rid = ""
        for k, v in (context.invocation_metadata() or ()):
            if k == REQUEST_ID_HEADER:
                rid = v
                break
        rid = rid or mint_request_id()
        try:
            context.send_initial_metadata(((REQUEST_ID_HEADER, rid),))
        except Exception:  # noqa: BLE001 — metadata is best-effort
            pass
        if self.model_server.replica.draining:
            # draining: refuse new RPCs with retryable UNAVAILABLE (the
            # REST 503 analog); in-flight ones keep running under the
            # stop(grace) budget
            context.abort(grpc.StatusCode.UNAVAILABLE, "draining")
        try:
            batcher = self.model_server.batcher(name)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        if not request.inputs:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          "no inputs in PredictRequest")
        # single-input models take the tensor directly; the conventional
        # key is "instances" (REST parity) or "inputs"
        key = ("instances" if "instances" in request.inputs else
               ("inputs" if "inputs" in request.inputs else
                next(iter(request.inputs))))
        ctx = self.model_server.obs.begin(name, request_id=rid)
        self.model_server.replica.inflight_inc(name)
        try:
            instances = tensor_to_ndarray(request.inputs[key])
            out = batcher.predict(instances, ctx=ctx)
        except QueueFullError as e:
            # bounded-queue shed: explicit RESOURCE_EXHAUSTED, the
            # request's wait recorded as queue badput in its ledger
            ctx.finish("shed", error=str(e))
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except ValueError as e:
            ctx.finish("error", error=f"ValueError: {e}")
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        except Exception as e:  # noqa: BLE001 — surface as INTERNAL
            ctx.finish("error", error=f"{type(e).__name__}: {e}")
            # an exception may carry its own HTTP status (the chaos
            # 5xx-burst fault): 503 maps to retryable UNAVAILABLE
            code = grpc.StatusCode.UNAVAILABLE \
                if int(getattr(e, "http_status", 0)) == 503 \
                else grpc.StatusCode.INTERNAL
            context.abort(code, f"{type(e).__name__}: {e}")
        finally:
            self.model_server.replica.inflight_dec(name)
        t_resp = time.time()
        if ctx.t_pipeline_end is not None:
            t_resp = min(t_resp, max(ctx.t_pipeline_end, ctx.t_accept))
        # response construction can fail too (an output dtype the
        # tensor codec rejects): that request must still land in the
        # ledger and registry, never silently vanish
        try:
            resp = pb.PredictResponse()
            resp.model_spec.name = name
            resp.model_spec.signature_name = (
                request.model_spec.signature_name or "serving_default")
            if isinstance(out, dict):
                wanted = set(request.output_filter)
                for k, v in out.items():
                    if wanted and k not in wanted:
                        continue
                    resp.outputs[k].CopyFrom(
                        ndarray_to_tensor(np.asarray(v)))
            else:
                resp.outputs["outputs"].CopyFrom(
                    ndarray_to_tensor(np.asarray(out)))
        except Exception as e:  # noqa: BLE001 — surface as INTERNAL
            ctx.finish("error", error=f"{type(e).__name__}: {e}")
            context.abort(grpc.StatusCode.INTERNAL,
                          f"{type(e).__name__}: {e}")
        ctx.stage("respond", t_resp, time.time())
        ctx.finish("ok")
        return resp

    def _get_model_status(self, request, context):
        name = request.model_spec.name
        resp = pb.GetModelStatusResponse()
        try:
            servable = self.model_server.repository.get(name)
        except KeyError as e:
            context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        vs = resp.model_version_status.add()
        vs.version = int(servable.version)
        vs.state = pb.ModelVersionStatus.AVAILABLE
        vs.status.error_code = 0
        return resp

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> int:
        handlers = grpc.method_handlers_generic_handler(SERVICE, {
            "Predict": grpc.unary_unary_rpc_method_handler(
                self._predict,
                request_deserializer=pb.PredictRequest.FromString,
                response_serializer=pb.PredictResponse.SerializeToString),
            "GetModelStatus": grpc.unary_unary_rpc_method_handler(
                self._get_model_status,
                request_deserializer=pb.GetModelStatusRequest.FromString,
                response_serializer=(
                    pb.GetModelStatusResponse.SerializeToString)),
        })
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=self.max_workers,
                                       thread_name_prefix="grpc-predict"),
            options=MESSAGE_OPTIONS)
        self._server.add_generic_rpc_handlers((handlers,))
        self.port = self._server.add_insecure_port(
            f"{self.host}:{self.port}")
        self._server.start()
        log.info("gRPC PredictionService on :%d", self.port)
        return self.port

    def stop(self, grace: Optional[float] = None) -> None:
        """Graceful shutdown: new RPCs are rejected at once while
        in-flight ones get ``grace`` seconds (default: the server's
        ``drain_grace_s``) to complete before being cancelled. Blocks
        until the server has fully terminated."""
        if self._server is not None:
            grace = self.drain_grace_s if grace is None else grace
            self._server.stop(grace).wait()


def predict_stub(channel):
    """Client-side multicallables for tests/tools (stub without codegen)."""
    return {
        "Predict": channel.unary_unary(
            f"/{SERVICE}/Predict",
            request_serializer=pb.PredictRequest.SerializeToString,
            response_deserializer=pb.PredictResponse.FromString),
        "GetModelStatus": channel.unary_unary(
            f"/{SERVICE}/GetModelStatus",
            request_serializer=pb.GetModelStatusRequest.SerializeToString,
            response_deserializer=pb.GetModelStatusResponse.FromString),
    }
