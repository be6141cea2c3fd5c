"""Serving client: ``predict()`` over the model server's REST surface and
``predict_grpc()`` over its PredictionService.

The port of ``kubeflow_tpu/serving/client.py``; the retry helpers are
cluster/http_client.py's.

    python -m kubeflow_tpu_torch.serving.client --server 127.0.0.1:8500 \\
        --model lm --npy tokens.npy --dtype int32 [--grpc]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Optional

import numpy as np

from ..cluster.http_client import jittered_backoff, retry_after_s
from .request_trace import (DEADLINE_HEADER, REQUEST_ID_HEADER,
                            mint_request_id)

__all__ = ["predict", "predict_grpc", "retry_after_s", "jittered_backoff"]


def predict(server: str, model: str, instances, dtype: str = "float32",
            timeout_s: float = 60.0, request_id: Optional[str] = None,
            retries: int = 2, backoff_s: float = 0.1) -> dict:
    """POST :predict with bounded retries: transient failures (connect
    errors, 5xx, 429) retry up to ``retries`` times with jittered
    backoff, a server-sent Retry-After is honored, and other 4xx surface
    immediately. One ``x-request-id`` is minted up front and sent on
    every attempt, and the remaining ``timeout_s`` budget rides the
    ``x-request-deadline`` header."""
    url = f"http://{server}/v1/models/{model}:predict"
    if isinstance(instances, np.ndarray):
        instances = instances.tolist()
    payload = json.dumps({"instances": instances, "dtype": dtype}).encode()
    rid = request_id or mint_request_id()
    deadline = time.monotonic() + timeout_s
    delay = backoff_s
    for attempt in range(retries + 1):
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(
                f"predict {model!r}: deadline budget ({timeout_s:.1f}s) "
                f"exhausted after {attempt} attempt(s)")
        req = urllib.request.Request(
            url, data=payload, method="POST",
            headers={"Content-Type": "application/json",
                     REQUEST_ID_HEADER: rid,
                     DEADLINE_HEADER: f"{remaining:.3f}"})
        try:
            with urllib.request.urlopen(req, timeout=remaining) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            e.read()
            transient = e.code == 429 or e.code >= 500
            if not transient or attempt >= retries:
                raise
            sleep = max(jittered_backoff(delay),
                        retry_after_s(e.headers) or 0.0)
        except (urllib.error.URLError, TimeoutError, OSError):
            if attempt >= retries:
                raise
            sleep = jittered_backoff(delay)
        time.sleep(min(sleep, max(0.0, deadline - time.monotonic())))
        delay *= 2
    raise RuntimeError("unreachable")  # pragma: no cover


def predict_grpc(server: str, model: str, instances,
                 dtype: str = "float32", timeout_s: float = 60.0) -> dict:
    """Predict over the gRPC surface (PredictionService on :9000,
    serving/grpc_server.py): binary tensors, a REST-shaped result —
    named outputs become the predictions dict, a single unnamed output
    the bare list."""
    import grpc as grpc_mod

    from . import tpu_serving_pb2 as pb
    from .grpc_server import (MESSAGE_OPTIONS, ndarray_to_tensor,
                              predict_stub, tensor_to_ndarray)
    channel = grpc_mod.insecure_channel(server, options=MESSAGE_OPTIONS)
    try:
        stub = predict_stub(channel)
        req = pb.PredictRequest()
        req.model_spec.name = model
        req.inputs["instances"].CopyFrom(
            ndarray_to_tensor(np.asarray(instances, np.dtype(dtype))))
        resp = stub["Predict"](req, timeout=timeout_s)
        outs = {k: tensor_to_ndarray(v).tolist()
                for k, v in resp.outputs.items()}
        if list(outs) == ["outputs"]:
            return {"predictions": outs["outputs"]}
        return {"predictions": outs}
    finally:
        channel.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="model-server client")
    p.add_argument("--server",
                   help="host:port (default: 127.0.0.1:8500 REST, "
                        "127.0.0.1:9000 with --grpc)")
    p.add_argument("--model", default="model")
    p.add_argument("--npy", required=True,
                   help="input batch (.npy), first axis = rows")
    p.add_argument("--dtype", default=None,
                   help="dtype the server casts the instances to "
                        "(default: the array's)")
    p.add_argument("--grpc", action="store_true",
                   help="use the PredictionService gRPC wire (:9000) "
                        "instead of REST")
    args = p.parse_args(argv)
    batch = np.load(args.npy)
    server = args.server or \
        ("127.0.0.1:9000" if args.grpc else "127.0.0.1:8500")
    send = predict_grpc if args.grpc else predict
    result = send(server, args.model, batch,
                  dtype=args.dtype or str(batch.dtype))
    preds = result.get("predictions") or {}
    if isinstance(preds, dict) and "next_token" in preds:
        print(json.dumps({"next_token": preds["next_token"]}))
    else:
        print(json.dumps(result)[:2000])
    return 0


if __name__ == "__main__":
    sys.exit(main())
