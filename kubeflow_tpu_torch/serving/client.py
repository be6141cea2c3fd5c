"""Serving client: ``predict()`` against the model server's REST surface.

The port of ``kubeflow_tpu/serving/client.py`` (REST only; the gRPC wire
is not yet ported). It keeps its own copies of ``retry_after_s`` and
``jittered_backoff`` from ``kubeflow_tpu/cluster/http_client.py``.

    python -m kubeflow_tpu_torch.serving.client --server 127.0.0.1:8500 \\
        --model lm --npy tokens.npy --dtype int32
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
import urllib.error
import urllib.request
from typing import Optional

import numpy as np

from .request_trace import (DEADLINE_HEADER, REQUEST_ID_HEADER,
                            mint_request_id)


def retry_after_s(headers) -> Optional[float]:
    """A server-sent Retry-After in seconds off a headers mapping, or None
    (numeric form only; unparseable reads as absent)."""
    if headers is None:
        return None
    raw = headers.get("Retry-After")
    if raw is None:
        return None
    try:
        return max(0.0, float(raw))
    except (TypeError, ValueError):
        return None


def jittered_backoff(delay_s: float, rng=random) -> float:
    """One jittered backoff interval: uniform in [delay, 1.5*delay], so a
    fleet of retriers does not hammer a recovering server in lockstep."""
    return delay_s * rng.uniform(1.0, 1.5)


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="model-server REST client")
    p.add_argument("--server", default="127.0.0.1:8500", help="host:port")
    p.add_argument("--model", default="model")
    p.add_argument("--npy", required=True,
                   help="input batch (.npy), first axis = rows")
    p.add_argument("--dtype", default=None,
                   help="dtype the server casts the instances to "
                        "(default: the array's)")
    args = p.parse_args(argv)
    batch = np.load(args.npy)
    result = predict(args.server, args.model, batch,
                     dtype=args.dtype or str(batch.dtype))
    preds = result.get("predictions") or {}
    if isinstance(preds, dict) and "next_token" in preds:
        print(json.dumps({"next_token": preds["next_token"]}))
    else:
        print(json.dumps(result)[:2000])
    return 0


if __name__ == "__main__":
    sys.exit(main())
