"""AOT train-step records: a rebind starts with no ``nvcc`` and no
per-op dispatch.

The port of ``kubeflow_tpu/runtime/aot.py``. The JAX package serializes
its compiled step executable; the port's counterpart of that executable
is the step captured as one CUDA graph
(runtime/trainstep.py ``TrainStepBuilder.build_compiled``), and a graph
cannot be written to disk. So the record holds what a rebind needs to
capture the same step again without building anything:

- ``format``, ``key`` and ``signature`` (the names, shapes and dtypes of
  the state's and the batch's leaves), checked as the reference checks
  them;
- ``libraries``: the kernel libraries the step loaded, as ``(name, file
  name under ops/_build.py build_dir(), sha256)``: the compile cache
  (``KFTPU_COMPILE_CACHE_DIR``) keeps the files, and a rebind loads them
  by these names with no ``nvcc`` run;
- ``static_inputs``: the state's tensors and the batch keys the captured
  step reads from outside its graph.

At first bind the worker captures the step, writes the record under a
key built from everything that shapes the program (:func:`step_key`) and
runs the step it captured; a rebind loads the record, verifies it and
its libraries, captures before its first step and replays the graph for
every step. The MPMD multislice path keeps one record per stage program
(2S−1 of them: FWD and BWD of each stage but the last, its FWDBWD), each
keyed with its stage, kind and microbatch count in ``extra`` and signed
by :func:`program_signature`; the engine captures each program on its
stage's device (parallel/multislice.py ``StageProgram``). Every failure falls back to the next rung (the build cache,
then ``nvcc``) and is counted in ``kftpu_aot_executable_total{outcome}``:
``miss``, ``corrupt``, ``key-mismatch``, ``signature-mismatch``,
``deserialize-failed`` (a named library missing or another: loading it
would need ``nvcc``), ``hit``, ``export`` and ``export-failed``.

Wire contract, as in the JAX package: the operator renders
``spec.warmStart`` as ``KFTPU_AOT`` / ``KFTPU_AOT_DIR``; the directory
defaults to ``<checkpointDir>/.jax-aot-executables`` (the operator's
name, kept; a port key never equals a JAX key, since it holds other
fields). The record is written atomically (tmp + rename).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
from typing import Any, Optional

import torch

from ..obs import registry as obsreg
from ..ops import _build

log = logging.getLogger(__name__)

AOT_ENABLE_ENV = "KFTPU_AOT"
AOT_DIR_ENV = "KFTPU_AOT_DIR"
# records live beside the compile cache on the same volume (the
# operator's directory contract)
AOT_SUBDIR = ".jax-aot-executables"

# bumped when the on-disk record layout changes (old files read as
# key-mismatch and fall back, never crash)
_FORMAT = 1


def default_aot_dir(volume_dir: str) -> str:
    """``<volume>/.jax-aot-executables`` with normalized slashes."""
    return volume_dir.rstrip("/") + "/" + AOT_SUBDIR


def _device_kind(device: Any = None) -> str:
    device = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    if device.type != "cuda":
        return device.type
    return torch.cuda.get_device_name(device)


def step_key(*, topology: str, num_slices: int, model_fingerprint: str,
             weight_update: str, sharding: dict, global_batch: int,
             kernels: Optional[dict] = None,
             extra: Optional[dict] = None, device: Any = None) -> str:
    """Stable key of one captured train step: sha256 (24 hex digits) of
    :func:`step_key_parts` as sorted JSON."""
    parts = step_key_parts(
        topology=topology, num_slices=num_slices,
        model_fingerprint=model_fingerprint, weight_update=weight_update,
        sharding=sharding, global_batch=global_batch, kernels=kernels,
        extra=extra, device=device)
    blob = json.dumps(parts, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:24]


def step_key_parts(*, topology: str, num_slices: int,
                   model_fingerprint: str, weight_update: str,
                   sharding: dict, global_batch: int,
                   kernels: Optional[dict] = None,
                   extra: Optional[dict] = None, device: Any = None) -> dict:
    """Everything that shapes the captured step: the reference's fields
    (the slice geometry, the model + recipe fingerprint, the
    weight-update layout, the sharding axes, the global batch, the kernel
    tier), with the framework's versions in place of jax's: ``torch``,
    ``cuda`` (``torch.version.cuda``), ``nvcc`` (the toolkit's release
    line) and ``deviceKind`` (``torch.cuda.get_device_name``, or the
    device type off the card). An edited kernel keeps the key: its
    library's file name (keyed by the sources) no longer matches the
    record's, which then loads as ``deserialize-failed``."""
    return {
        "topology": topology,
        "numSlices": int(num_slices),
        "model": model_fingerprint,
        "weightUpdate": weight_update,
        "sharding": {k: int(v) for k, v in sorted((sharding or {}).items())},
        "globalBatch": int(global_batch),
        "kernels": {k: str(v) for k, v in sorted((kernels or {}).items())},
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "",
        "nvcc": _build.nvcc_release(),
        "deviceKind": _device_kind(device),
        "format": _FORMAT,
        **(extra or {}),
    }


def _leaves(tree: Any, prefix: str = "") -> list:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree, key=str):
            out += _leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    shape = list(getattr(tree, "shape", ()))
    dtype = str(getattr(tree, "dtype", type(tree).__name__))
    return [[prefix, shape, dtype]]


def abstract_signature(state, batch: dict) -> dict:
    """Names, shapes and dtypes of the state's leaves
    (runtime/trainstep.py ``state_tree``) and the batch's: the load-time
    guard against a key collision feeding a record of other shapes. The
    optimizer's per-param slots are left out: torch makes them at the
    first step, so a fresh and a resumed state differ there, and each is
    shaped as its param."""
    from .trainstep import state_tree
    tree = state_tree(state)
    tree["opt"] = {"extra": tree["opt"]["extra"]}
    return {"args": [{"leaves": _leaves(tree)},
                     {"leaves": _leaves(dict(batch))}]}


def program_signature(params: dict, inputs: dict) -> dict:
    """The signature of one MPMD stage program (parallel/multislice.py
    ``StageProgram``): the names, shapes and dtypes of its stage's params
    and of its inputs (the microbatch's tokens, the incoming activation,
    the cotangent)."""
    return {"args": [{"leaves": _leaves(dict(params))},
                     {"leaves": _leaves(dict(inputs))}]}


def _path(aot_dir: str, key: str) -> str:
    return aot_dir.rstrip("/") + f"/step-{key}.aotx"


def export_step(aot_dir: str, key: str, step, signature: dict
                ) -> Optional[str]:
    """Write the record of a captured step (a trainstep ``CompiledStep``,
    or one MPMD ``StageProgram``) under ``key``. Returns the written path, or None: export is an
    optimization, so every failure downgrades to a warning. The write is
    atomic (tmp + rename): a pod killed mid-export never leaves a
    truncated file a rebind would trip over."""
    try:
        record = {
            "format": _FORMAT,
            "key": key,
            "signature": signature,
            "libraries": _build.loaded_libraries(),
            "static_inputs": list(step.static_inputs),
        }
        os.makedirs(aot_dir, exist_ok=True)
        path = _path(aot_dir, key)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(record, f)
        os.replace(tmp, path)
        log.info("AOT step record exported to %s (%d kernel libraries)",
                 path, len(record["libraries"]))
        _count("export")
        return path
    except Exception as e:  # noqa: BLE001 - export must never kill a gang
        log.warning("AOT export to %s failed: %s", aot_dir, e)
        _count("export-failed")
        return None


def load_step(aot_dir: str, key: str, signature: dict) -> Optional[dict]:
    """The verified record for ``key`` with its kernel libraries loaded
    from the build cache, or None. Every failure falls back to None,
    counted: the file absent (``miss``), unreadable or truncated
    (``corrupt``), written under another key or format
    (``key-mismatch``), of another signature (``signature-mismatch``), a
    named library missing from the cache or of another digest
    (``deserialize-failed``: it would need ``nvcc``). The caller then
    captures the step again; the gang never dies for a stale record."""
    path = _path(aot_dir, key)
    try:
        with open(path, "rb") as f:
            record = pickle.load(f)
    except FileNotFoundError:
        _count("miss")
        return None
    except Exception as e:  # noqa: BLE001 - a corrupt file is a miss
        log.warning("AOT record %s unreadable (%s); falling back", path, e)
        _count("corrupt")
        return None
    try:
        if not isinstance(record, dict) or \
                record.get("format") != _FORMAT or record.get("key") != key:
            have = record if not isinstance(record, dict) else (
                record.get("key"), record.get("format"))
            log.warning("AOT record %s key/format mismatch (have %s, want "
                        "%s/%s); falling back", path, have, key, _FORMAT)
            _count("key-mismatch")
            return None
        if record.get("signature") != signature:
            log.warning("AOT record %s argument-signature mismatch; "
                        "falling back", path)
            _count("signature-mismatch")
            return None
        for name, file_name, digest in record["libraries"]:
            _build.load_recorded(name, file_name, digest)
        _count("hit")
        return record
    except Exception as e:  # noqa: BLE001 - a bad record is a miss
        log.warning("AOT record %s cannot be loaded without a build (%s); "
                    "falling back", path, e)
        _count("deserialize-failed")
        return None


def _count(outcome: str) -> None:
    """The process registry's counter of AOT outcomes: the dashboard side
    of "are rebinds skipping the build"."""
    obsreg.counter(
        "kftpu_aot_executable_total",
        "AOT step-record loads/exports by outcome",
        labels=("outcome",)).labels(outcome=outcome).inc()
