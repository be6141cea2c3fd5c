"""Offline batch prediction job — the tf-batch-predict analog.

The port of ``kubeflow_tpu/serving/batch_predict.py``. Input is .npy /
.npz / .jsonl; output is .jsonl with one prediction record per input row,
plus a summary line. A fixed batch size streams each file through the
servable's device; the tail batch is padded to the same shape, so the
kernels see one batch shape per run.

    python -m kubeflow_tpu_torch.serving.batch_predict \\
        --input-file-patterns 'images/*.npy' --output-result-file out.jsonl

``--device`` defaults to cuda and raises where no card is present.
"""

from __future__ import annotations

import glob
import json
import time
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from .servable import ModelRepository, Servable


def _iter_input(path: str) -> Iterator[np.ndarray]:
    if path.endswith(".npy"):
        yield np.load(path)
    elif path.endswith(".npz"):
        data = np.load(path)
        yield data[list(data.files)[0]]
    elif path.endswith(".jsonl"):
        rows = []
        with open(path) as f:
            for line in f:
                if line.strip():
                    rows.append(json.loads(line)["instance"])
        if rows:
            yield np.asarray(rows)
    else:
        raise ValueError(f"unsupported input format: {path}")


def run_batch_predict(servable: Servable, input_patterns: list[str],
                      output_path: str, batch_size: int = 64,
                      input_dtype: Optional[str] = None,
                      request_id: Optional[str] = None) -> dict:
    """Run prediction over all files matching the patterns; returns the
    summary dict that is also appended to the output file.

    The run carries one request id (minted unless the caller propagates an
    inbound one) and, when a span sink is configured (KFTPU_SPAN_PATH),
    emits a request trace per input file plus the per-file ledger
    summaries, so an offline job's device/pad/H2D attribution reads like an
    online request's (obs/goodput.py serving vocabulary)."""
    from .request_trace import ServingObs, mint_request_id
    files: list[str] = []
    for pat in input_patterns:
        files.extend(sorted(glob.glob(pat)))
    if not files:
        raise FileNotFoundError(f"no inputs match {input_patterns}")

    request_id = request_id or mint_request_id()
    obs = ServingObs(component="batch-predict", sample_every=1)
    out = Path(output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    n_total, t0 = 0, time.perf_counter()
    with out.open("w") as f:
        for fi, path in enumerate(files):
            # per-file trace: the run id suffixed per file, so one slow
            # shard is attributable on its own timeline
            ctx = obs.begin(servable.name,
                            request_id=f"{request_id}-f{fi}")
            ctx.note(source=path, run_request_id=request_id)
            file_rows = 0
            try:
                for arr in _iter_input(path):
                    if input_dtype:
                        arr = arr.astype(input_dtype)
                    for i in range(0, arr.shape[0], batch_size):
                        chunk = arr[i:i + batch_size]
                        n = chunk.shape[0]
                        if n < batch_size:  # pad the tail: same shape
                            pad = np.zeros(
                                (batch_size - n,) + chunk.shape[1:],
                                chunk.dtype)
                            chunk = np.concatenate([chunk, pad])
                        tw0 = time.time()
                        preds, stages = \
                            servable.predict_with_stages(chunk)
                        dev_s = stages["device_s"]
                        padded = max(1, batch_size)
                        ctx.stage("h2d", tw0, tw0 + stages["h2d_s"])
                        ctx.device(
                            tw0 + stages["h2d_s"],
                            tw0 + stages["h2d_s"] + dev_s,
                            goodput_s=dev_s * (n / padded),
                            pad_waste_s=dev_s
                            * ((batch_size - n) / padded))
                        preds = {k: np.asarray(v)[:n]
                                 for k, v in preds.items()}
                        tr0 = time.time()
                        for j in range(n):
                            f.write(json.dumps(
                                {"source": path, "index": n_total + j,
                                 "requestId": request_id,
                                 "prediction": {
                                     k: np.asarray(v[j]).tolist()
                                     for k, v in preds.items()}})
                                + "\n")
                        ctx.stage("respond", tr0, time.time())
                        n_total += n
                        file_rows += n
            except Exception as e:
                ctx.note(rows=file_rows)
                ctx.finish("error", error=f"{type(e).__name__}: {e}")
                raise
            ctx.note(rows=file_rows)
            ctx.finish("ok")
    summary = {"instances": n_total, "files": len(files),
               "seconds": round(time.perf_counter() - t0, 3),
               "model": servable.name, "version": servable.version,
               "requestId": request_id}
    with out.open("a") as f:
        f.write(json.dumps({"summary": summary}) + "\n")
    return summary


def main(argv=None) -> int:
    """CLI: the batch-predict job. The flags are the JAX package's, plus
    ``--device``."""
    import argparse
    p = argparse.ArgumentParser("tpu-batch-predict")
    p.add_argument("--model-name", default="model")
    p.add_argument("--model-type", default="resnet50")
    p.add_argument("--model-path", default="")
    p.add_argument("--input-file-patterns", required=True,
                   help="comma-separated globs")
    p.add_argument("--output-result-file", required=True)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--input-dtype", default=None)
    p.add_argument("--request-id", default=None,
                   help="propagate an inbound request id (the job's "
                        "spans carry it; minted otherwise)")
    p.add_argument("--device", default="cuda",
                   help="torch device to predict on (default cuda; raises "
                        "when no card is present)")
    args = p.parse_args(argv)

    # a restarted job loads its kernels from the build cache
    # ($KFTPU_COMPILE_CACHE_DIR); a broken cache volume only warns
    from ..runtime.compile_cache import enable_compilation_cache
    enable_compilation_cache()
    repo = ModelRepository()
    servable = repo.load(args.model_name, args.model_type,
                         checkpoint_dir=args.model_path or None,
                         device=args.device)
    summary = run_batch_predict(
        servable, args.input_file_patterns.split(","),
        args.output_result_file, batch_size=args.batch_size,
        input_dtype=args.input_dtype, request_id=args.request_id)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
