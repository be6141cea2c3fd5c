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

Checkpoints: ``ModelRepository.load(checkpoint_dir=...)`` serves the
params (and a ResNet's ``batch_stats``) of the newest intact step a
trainer wrote (runtime/checkpoint.py), the step as the version, and an
empty directory as version 0 with the builder's seed weights; ``reload``
and ``start_polling`` swap in a newer intact step, an int8 servable
through the parity gate again.
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
    quantized._float_predict = float_predict
    quantized._ledger_quant(quant_info)
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

    def _ledger_quant(self, quant: dict) -> None:
        """Record an int8 version's quantization: ``quant`` and the
        accuracy-delta gauge."""
        self.quant = quant
        self.registry.gauge(
            "kubeflow_model_quant_accuracy_delta",
            "measured int8-vs-float accuracy delta (argmax disagreement)",
            labels=("model",)).labels(model=self.name).set(
                quant["accuracy_delta"])

    def swap(self, params: Params, version: int,
             quant: Optional[dict] = None) -> None:
        """Hot-swap to a newer model version; in-flight predicts finish on
        the old params (they captured the reference). An int8 servable
        takes the new version's quantized params and its ``quant``
        record."""
        params = _to_device(params, self.device)
        with self._lock:
            self.params = params
            self.version = version
            if quant is not None:
                self._ledger_quant(quant)

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
    """name → Servable registry, with checkpoint directories as version
    sources (the TF-Serving file-system monitor: a trainer writes newer
    steps, the server serves them as they land)."""

    def __init__(self):
        self._models: dict[str, Servable] = {}
        # name → (CheckpointManager, nested): one manager a source, so
        # its verified-step cache spares a poll re-hashing unchanged steps
        self._sources: dict[str, tuple] = {}
        self._lock = threading.Lock()
        self._stop: Optional[threading.Event] = None
        self._poll_thread: Optional[threading.Thread] = None

    def add(self, servable: Servable) -> None:
        with self._lock:
            self._models[servable.name] = servable

    def load(self, name: str, model_type: str,
             checkpoint_dir: Optional[str] = None,
             kernels: Optional[str] = None,
             quant_max_delta: Optional[float] = None,
             device: Any = "cuda", **kw) -> Servable:
        """Load a servable: from the newest intact step of
        ``checkpoint_dir`` (the step is the version), or with the
        builder's seed weights (version 1; version 0 for an empty
        checkpoint directory, so the trainer's first step is newer);
        ``kernels="int8"`` quantizes behind the parity gate (a
        QuantizationRefused propagates). ``device`` defaults to "cuda"
        and raises where no card is present."""
        if model_type not in _MODEL_BUILDERS:
            raise KeyError(
                f"unknown model type {model_type!r}; "
                f"registered: {sorted(_MODEL_BUILDERS)}")
        if kernels is None:
            kernels = os.environ.get("KFTPU_KERNEL_SERVING") or "stock"
        if kernels not in ("stock", "int8"):
            raise ValueError(
                f"kernels.serving {kernels!r} not one of "
                f"('stock', 'int8')")
        device = resolve_device(device)
        predict_fn, init_params, signature = \
            _MODEL_BUILDERS[model_type](**kw)
        params, version = init_params(), 1
        # the servable takes {"params", **variables} (ResNet) or the
        # params alone (the LM)
        nested = isinstance(params.get("params"), dict)
        mgr = None
        if checkpoint_dir:
            from ..runtime.checkpoint import CheckpointManager
            mgr = CheckpointManager(checkpoint_dir)
            step = mgr.latest_step()
            if step is None:
                version = 0   # nothing written yet: the first step is newer
            else:
                params = mgr.restore_params(step, device=device,
                                            variables=nested)
                version = step
        servable = Servable(name=name, predict_fn=predict_fn,
                            params=params, version=version,
                            input_signature=signature, device=device)
        if kernels == "int8":
            servable = quantize_servable(servable,
                                         max_delta=quant_max_delta)
        self.add(servable)
        if mgr is not None:
            with self._lock:
                self._sources[name] = (mgr, nested)
        return servable

    def reload(self, name: str) -> bool:
        """Swap in a newer intact checkpoint step, if one landed; False
        when the servable is current or has no checkpoint source. An
        int8 servable re-quantizes the new version through the same
        parity gate; a refusal keeps the old version serving. The
        servable object stays the one a server's batcher holds: the new
        version is swapped into it."""
        servable = self.get(name)
        with self._lock:
            source = self._sources.get(name)
        if source is None:
            return False
        mgr, nested = source
        step = mgr.latest_step()
        if step is None or step <= servable.version:
            return False
        params = mgr.restore_params(step, device=servable.device,
                                    variables=nested)
        if servable.quant is not None:
            base = Servable(
                name=servable.name, predict_fn=servable._float_predict,
                params=params, version=step,
                input_signature=servable.input_signature,
                max_batch=servable.max_batch, device=servable.device)
            try:
                newq = quantize_servable(
                    base, max_delta=servable.quant["max_delta"])
            except QuantizationRefused as e:
                log.warning("model %s version %d refused by the int8 "
                            "parity gate (%s); keeping version %d", name,
                            step, e, servable.version)
                return False
            servable.swap(newq.params, step, quant=newq.quant)
            log.info("model %s reloaded to version %d (int8, delta %.4f)",
                     name, step, newq.quant["accuracy_delta"])
            return True
        servable.swap(params, step)
        log.info("model %s reloaded to version %d", name, step)
        return True

    def start_polling(self, interval_s: float = 30.0) -> None:
        """A background thread that reloads every checkpoint-backed model
        each ``interval_s`` seconds."""
        if self._poll_thread is not None:
            return
        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(interval_s):
                for name in self.names():
                    try:
                        self.reload(name)
                    except Exception as e:  # noqa: BLE001 — keep serving
                        log.warning("reload %s failed: %s", name, e)

        self._poll_thread = threading.Thread(target=loop, daemon=True,
                                             name="model-version-poller")
        self._poll_thread.start()

    def stop_polling(self) -> None:
        if self._poll_thread is not None:
            self._stop.set()
            self._poll_thread.join(timeout=5)
            self._poll_thread = None

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
        # random weights from one seed when no checkpoint is given: two
        # servables share their weights
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
        # random weights from one seed when no checkpoint is given: two
        # servables share their weights
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
