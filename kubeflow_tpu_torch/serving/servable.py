"""Servables: named, versioned predict functions on a device.

The port of ``kubeflow_tpu/serving/servable.py``. A Servable wraps a
``predict_fn(params, batch_tensor) -> dict of tensors`` and its params on
the servable's device: a flat state dict of tensors (the LM), or nested
dicts of them (ResNet's ``{"params": ..., "batch_stats": ...}``, as the
JAX package serves a variables tree). Registered builders:
``transformer_lm`` and ``resnet18`` … ``resnet152``. Inputs are padded
to power-of-two batch buckets, as the JAX package does for its compiled
shapes; PyTorch runs eagerly, so here the buckets bound the shapes the
kernels see and keep batches comparable between the two packages.

Devices: every entry point takes ``device`` and defaults to ``"cuda"``.
A CUDA device with no card present raises; nothing continues on the CPU
unless the caller asked for it (``device="cpu"``, as the tests do).

Not yet ported: loading from a checkpoint directory, ``reload`` and
``start_polling`` (the JAX package restores with orbax); they raise.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models import RESNET_DEPTHS
from ..obs.registry import Registry
from ..runtime.bootstrap import resolve_device

log = logging.getLogger(__name__)

# a state dict, or nested dicts of them: name → tensor | dict
Params = dict
# predict(params, batch_tensor) -> dict of tensors
PredictFn = Callable[[Params, torch.Tensor], Any]

# model-name → builder(device=..., **kw) -> (predict_fn, init_params_fn,
# input_signature)
_MODEL_BUILDERS: dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn):
        _MODEL_BUILDERS[name] = fn
        return fn
    return deco


def next_bucket(n: int, max_batch: int) -> int:
    """Smallest power-of-two >= n (capped): the static-shape bucket."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


# -- int8 quantized serving -----------------------------------------------
#
# Per-channel absmax weight quantization: every float param with ndim >= 2
# is stored as int8 with one f32 scale per OUTPUT channel (the last axis,
# the same axis as the JAX leaf's), absmax/127 over the other axes. At
# predict the weights dequantize to f32, so every matmul accumulates from
# f32 weights. Rank-0/1 params (norm scales, biases, BN running statistics)
# stay float. Nested dicts are walked as the JAX package walks a variables
# tree. The parity gate
# measures the accuracy delta on calibration batches at quantize time,
# ledgers it, and refuses to serve past the threshold.

INT8_MAX_DELTA_ENV = "KFTPU_INT8_MAX_DELTA"
DEFAULT_INT8_MAX_DELTA = 0.02  # ≤2% argmax disagreement by default

_Q_KEY = "__int8_q__"
_SCALE_KEY = "__int8_scale__"


class QuantizationRefused(RuntimeError):
    """The measured int8 accuracy delta exceeds the parity-gate
    threshold: the model must keep serving float."""


def quantize_params_int8(params: Params) -> tuple[Params, dict]:
    """Per-channel absmax int8 quantization of every float param with
    ndim >= 2, at any depth of nested dicts. Returns (qparams, stats);
    quantized params become ``{_Q_KEY: int8, _SCALE_KEY: f32[..., 1,
    channels]}`` dicts."""
    stats = {"quantized_leaves": 0, "float_leaves": 0,
             "weight_bytes_float": 0, "weight_bytes_int8": 0}

    def q(tree: Params) -> Params:
        out: Params = {}
        for name, p in tree.items():
            if isinstance(p, dict):
                out[name] = q(p)
            elif p.dim() >= 2 and p.is_floating_point():
                p32 = p.float()
                amax = p32.abs().amax(dim=tuple(range(p32.dim() - 1)),
                                      keepdim=True)
                scale = amax.clamp_min(1e-12) / 127.0
                qv = torch.clamp(torch.round(p32 / scale), -127, 127
                                 ).to(torch.int8)
                out[name] = {_Q_KEY: qv, _SCALE_KEY: scale}
                stats["quantized_leaves"] += 1
                stats["weight_bytes_float"] += p32.numel() * 4
                stats["weight_bytes_int8"] += qv.numel() + scale.numel() * 4
            else:
                out[name] = p
                stats["float_leaves"] += 1
                stats["weight_bytes_float"] += p.numel() * 4
                stats["weight_bytes_int8"] += p.numel() * 4
        return out

    return q(params), stats


def _is_qleaf(node) -> bool:
    return isinstance(node, dict) and _Q_KEY in node


def dequantize_params(qparams: Params) -> Params:
    """int8 · per-channel f32 scale → f32 weights, at any depth."""
    return {name: (n[_Q_KEY].float() * n[_SCALE_KEY]) if _is_qleaf(n) else
            dequantize_params(n) if isinstance(n, dict) else n
            for name, n in qparams.items()}


def _argmax_fields(out) -> Optional[np.ndarray]:
    """The discrete prediction the accuracy delta is measured on —
    'classes' or 'next_token'; None for models exposing neither (the
    delta then falls back to relative logits error)."""
    if isinstance(out, dict):
        for k in ("classes", "next_token"):
            if k in out:
                return np.asarray(out[k])
    return None


def quantize_servable(
    servable: "Servable",
    calibration: Optional[list] = None,
    *,
    max_delta: Optional[float] = None,
    calib_batches: int = 4,
    calib_batch_size: int = 8,
    seed: int = 0,
) -> "Servable":
    """Build the int8 Servable from a float one, behind the parity gate.

    ``calibration`` is a list of input batches (np arrays); when omitted
    they are synthesized from the input signature with numpy from
    ``seed``. ``max_delta`` is the gate threshold (argmax-disagreement
    fraction); default $KFTPU_INT8_MAX_DELTA or 0.02. Raises
    QuantizationRefused past the threshold. The measured delta is
    ledgered either way: Servable.quant, metadata()['quantization'] and
    the kubeflow_model_quant_accuracy_delta gauge."""
    if max_delta is None:
        max_delta = float(os.environ.get(INT8_MAX_DELTA_ENV, "")
                          or DEFAULT_INT8_MAX_DELTA)
    if calibration is None:
        sig = servable.input_signature.get("inputs") or {}
        shape_tail = list(sig.get("shape") or [])[1:]
        if not shape_tail or any(d is None or d <= 0 for d in shape_tail):
            raise ValueError(
                f"model {servable.name!r} declares no synthesizable "
                f"input shape; pass calibration batches explicitly")
        dtype = np.dtype(sig.get("dtype", "float32"))
        rng = np.random.default_rng(seed)
        if np.issubdtype(dtype, np.integer):
            # token ids small and valid for any vocab >= 256
            calibration = [rng.integers(
                0, 256, size=(calib_batch_size, *shape_tail)).astype(dtype)
                for _ in range(calib_batches)]
        else:
            calibration = [rng.standard_normal(
                (calib_batch_size, *shape_tail)).astype(dtype)
                for _ in range(calib_batches)]

    qparams, qstats = quantize_params_int8(servable.params)
    float_predict = servable.predict_fn

    def predict_int8(qp, x):
        return float_predict(dequantize_params(qp), x)

    quantized = Servable(
        name=servable.name, predict_fn=predict_int8, params=qparams,
        version=servable.version,
        input_signature=servable.input_signature,
        max_batch=servable.max_batch, device=servable.device)

    n_total = n_flipped = 0
    logits_err = 0.0
    for batch in calibration:
        out_f = servable.predict(np.asarray(batch))
        out_q = quantized.predict(np.asarray(batch))
        af, aq = _argmax_fields(out_f), _argmax_fields(out_q)
        if af is not None and aq is not None:
            n_total += af.size
            n_flipped += int(np.sum(af.reshape(-1) != aq.reshape(-1)))
        lf = out_f.get("logits") if isinstance(out_f, dict) else out_f
        lq = out_q.get("logits") if isinstance(out_q, dict) else out_q
        if lf is not None and lq is not None:
            lf, lq = np.asarray(lf, np.float64), np.asarray(lq, np.float64)
            denom = max(float(np.max(np.abs(lf))), 1e-12)
            logits_err = max(logits_err,
                             float(np.max(np.abs(lf - lq))) / denom)
    delta = (n_flipped / n_total) if n_total else logits_err

    quant_info = {
        "kernel": "int8",
        "accuracy_delta": round(float(delta), 6),
        "max_delta": float(max_delta),
        "logits_rel_err": round(float(logits_err), 6),
        "calibration_examples": int(
            sum(np.asarray(b).shape[0] for b in calibration)),
        **qstats,
    }
    quantized.quant = quant_info
    quantized._float_predict = float_predict
    quantized.registry.gauge(
        "kubeflow_model_quant_accuracy_delta",
        "measured int8-vs-float accuracy delta (argmax disagreement)",
        labels=("model",)).labels(model=servable.name).set(float(delta))
    log.info("int8 quantization of %s: delta=%.4f (gate %.4f), "
             "logits_rel_err=%.5f, weight bytes %d -> %d",
             servable.name, delta, max_delta, logits_err,
             qstats["weight_bytes_float"], qstats["weight_bytes_int8"])
    if delta > max_delta:
        err = QuantizationRefused(
            f"int8 accuracy delta {delta:.4f} exceeds the parity gate "
            f"{max_delta:.4f} for model {servable.name!r}: refusing to "
            f"serve quantized (measured on "
            f"{quant_info['calibration_examples']} calibration "
            f"examples; delta ledgered)")
        err.delta = float(delta)
        raise err
    return quantized


def _to_device(params: Params, device: torch.device) -> Params:
    """Every tensor of (nested dicts of) params on ``device``."""
    return {name: _to_device(p, device) if isinstance(p, dict) else
            p.to(device) for name, p in params.items()}


@dataclass
class Servable:
    """One loaded model version behind a predict function on a device."""

    name: str
    predict_fn: PredictFn
    params: Params
    version: int = 1
    input_signature: dict = field(default_factory=dict)
    max_batch: int = 256
    device: Any = "cuda"
    # set by quantize_servable: the ledgered quantization record
    quant: Optional[dict] = None
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = _to_device(self.params, self.device)
        # per-servable stats on their own registry, with the family
        # names the server's exposition bridges (http_server.metrics_text)
        self.registry = Registry()
        self._m_requests = self.registry.counter(
            "kubeflow_model_request_count", "requests served",
            labels=("model",)).labels(model=self.name)
        self._m_predict_s = self.registry.counter(
            "kubeflow_model_predict_seconds_total",
            "cumulative device predict seconds",
            labels=("model",)).labels(model=self.name)
        # no compile cache in the port yet: every start is cold
        self.start_kind = "cold"

    @property
    def _stats(self) -> dict:
        return {"request_count": int(self._m_requests.value),
                "predict_seconds": self._m_predict_s.value}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, x: torch.Tensor) -> dict:
        with torch.inference_mode():
            return self.predict_fn(self.params, x)

    def predict(self, instances: np.ndarray) -> dict:
        """Pad to bucket, run on device, slice back. Thread-safe."""
        out, _ = self.predict_with_stages(instances)
        return out

    def predict_with_stages(self, instances: np.ndarray) -> tuple:
        """predict() plus the per-stage attribution the request tracer
        charges its ledger from: ``(out, {"h2d_s", "device_s",
        "drain_s", "bucket", "rows", "pad_rows"})``. Host-observed split,
        each stage ended by ``torch.cuda.synchronize()`` on a card: h2d
        = the copy of the padded batch to the device, device = the
        forward, drain = the copy of the results back."""
        instances = np.asarray(instances)
        n = instances.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        if n > self.max_batch:
            # split oversized requests; serving never runs > max bucket.
            # Stages aggregate across the chunks.
            parts = []
            agg = {"h2d_s": 0.0, "device_s": 0.0, "drain_s": 0.0,
                   "bucket": self.max_batch, "rows": n, "pad_rows": 0}
            for i in range(0, n, self.max_batch):
                out, st = self.predict_with_stages(
                    instances[i:i + self.max_batch])
                parts.append(out)
                for k in ("h2d_s", "device_s", "drain_s", "pad_rows"):
                    agg[k] += st[k]
            return {k: np.concatenate([p[k] for p in parts], axis=0)
                    for k in parts[0]}, agg
        bucket = next_bucket(n, self.max_batch)
        padded = instances
        if bucket != n:
            pad = np.zeros((bucket - n,) + instances.shape[1:],
                           instances.dtype)
            padded = np.concatenate([instances, pad], axis=0)
        t0 = time.perf_counter()
        dev_in = torch.from_numpy(np.ascontiguousarray(padded)).to(
            self.device)
        self._sync()
        t1 = time.perf_counter()
        out = self._run(dev_in)
        self._sync()
        t2 = time.perf_counter()
        out = {k: v[:n].cpu().numpy() for k, v in out.items()}
        t3 = time.perf_counter()
        self._m_requests.inc()
        self._m_predict_s.inc(t3 - t0)
        stages = {"h2d_s": t1 - t0, "device_s": t2 - t1,
                  "drain_s": t3 - t2, "bucket": bucket, "rows": n,
                  "pad_rows": bucket - n}
        return out, stages

    def warmup(self, buckets: Optional[list[int]] = None) -> list[int]:
        """Run a zero batch through each bucket before serving traffic
        (the kernels build and the allocator reaches its working set on
        the first call); default = every power-of-two bucket up to
        max_batch, plus max_batch itself. Moves no serving metric, and
        ``start_kind`` stays "cold": the port has no compile cache."""
        sig = self.input_signature.get("inputs") or {}
        shape_tail = list(sig.get("shape") or [])[1:]
        if not shape_tail or any(d is None or d <= 0 for d in shape_tail):
            return []  # no synthesizable input shape declared
        if buckets is None:
            buckets, b = [], 1
            while b < self.max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(self.max_batch)
        dtype = np.dtype(sig.get("dtype", "float32"))
        for b in buckets:
            self._run(torch.from_numpy(
                np.zeros((b, *shape_tail), dtype)).to(self.device))
        self._sync()
        return buckets

    def swap(self, params: Params, version: int) -> None:
        """Hot-swap to a newer model version; in-flight predicts finish on
        the old params (they captured the reference)."""
        params = _to_device(params, self.device)
        with self._lock:
            self.params = params
            self.version = version

    def metadata(self) -> dict:
        """TF-Serving /metadata analog."""
        out = {
            "model_spec": {"name": self.name,
                           "version": str(self.version)},
            "signature_def": self.input_signature,
            "stats": dict(self._stats),
        }
        if self.quant is not None:
            out["quantization"] = dict(self.quant)
        return out

    def status(self) -> dict:
        return {"model_version_status": [{
            "version": str(self.version),
            "state": "AVAILABLE",
            "status": {"error_code": "OK", "error_message": ""},
        }]}


class ModelRepository:
    """name → Servable registry."""

    def __init__(self):
        self._models: dict[str, Servable] = {}
        self._lock = threading.Lock()

    def add(self, servable: Servable) -> None:
        with self._lock:
            self._models[servable.name] = servable

    def load(self, name: str, model_type: str,
             checkpoint_dir: Optional[str] = None,
             kernels: Optional[str] = None,
             quant_max_delta: Optional[float] = None,
             device: Any = "cuda", **kw) -> Servable:
        """Load a servable with random weights from the builder's seed;
        ``kernels="int8"`` quantizes behind the parity gate (a
        QuantizationRefused propagates). ``device`` defaults to "cuda"
        and raises where no card is present."""
        if model_type not in _MODEL_BUILDERS:
            raise KeyError(
                f"unknown model type {model_type!r}; "
                f"registered: {sorted(_MODEL_BUILDERS)}")
        if checkpoint_dir:
            raise NotImplementedError(
                "loading from a checkpoint directory is not yet ported "
                "(the JAX package restores with orbax)")
        if kernels is None:
            kernels = os.environ.get("KFTPU_KERNEL_SERVING") or "stock"
        if kernels not in ("stock", "int8"):
            raise ValueError(
                f"kernels.serving {kernels!r} not one of "
                f"('stock', 'int8')")
        device = resolve_device(device)
        predict_fn, init_params, signature = \
            _MODEL_BUILDERS[model_type](**kw)
        servable = Servable(name=name, predict_fn=predict_fn,
                            params=init_params(), version=1,
                            input_signature=signature, device=device)
        if kernels == "int8":
            servable = quantize_servable(servable,
                                         max_delta=quant_max_delta)
        self.add(servable)
        return servable

    def reload(self, name: str) -> bool:
        raise NotImplementedError(
            "checkpoint version reload is not yet ported")

    def start_polling(self, interval_s: float = 30.0) -> None:
        raise NotImplementedError(
            "checkpoint version polling is not yet ported")

    def get(self, name: str) -> Servable:
        with self._lock:
            if name not in self._models:
                raise KeyError(f"model {name!r} not found; "
                               f"loaded: {sorted(self._models)}")
            return self._models[name]

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._models)


@register_model("transformer_lm")
def _build_transformer(vocab_size: int = 32000, **cfg_kw):
    from ..models import transformer as T
    cfg = T.TransformerConfig(vocab_size=vocab_size, **cfg_kw)
    model = T.TransformerLM(cfg)
    # functional_call swaps the module's parameters for the call's
    # duration: one call at a time per model
    lock = threading.Lock()

    def init_params() -> Params:
        # random weights until checkpoint loading is ported: the same
        # seed for every load, so two servables share their weights
        model.init_weights(torch.Generator().manual_seed(0))
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    def predict(params: Params, tokens: torch.Tensor) -> dict:
        with lock:
            logits = torch.func.functional_call(model, params, (tokens,))
        return {"logits": logits,
                "next_token": torch.argmax(logits[:, -1], dim=-1)}

    sig = {"inputs": {"shape": [-1, cfg.max_seq_len], "dtype": "int32"},
           "outputs": {"logits": [-1, cfg.max_seq_len, vocab_size]}}
    return predict, init_params, sig


def _build_resnet(depth: int = 50, num_classes: int = 1000,
                  image_size: int = 224):
    from ..models import resnet as R
    model = R.make_resnet(depth, num_classes=num_classes)

    def init_params() -> Params:
        # random weights until checkpoint loading is ported: the same
        # seed for every load, so two servables share their weights
        params, variables = model.init(torch.Generator().manual_seed(0))
        return {"params": params, **variables}

    def predict(variables: Params, images: torch.Tensor) -> dict:
        logits = model.apply(variables["params"], variables["batch_stats"],
                             images, train=False)
        return {"logits": logits, "classes": torch.argmax(logits, dim=-1)}

    sig = {"inputs": {"shape": [-1, image_size, image_size, 3],
                      "dtype": "float32"},
           "outputs": {"logits": [-1, num_classes], "classes": [-1]}}
    return predict, init_params, sig


for _depth in RESNET_DEPTHS:
    register_model(f"resnet{_depth}")(partial(_build_resnet, depth=_depth))
