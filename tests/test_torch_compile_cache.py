"""The port's compile cache (the kernel build directory) and the start-kind
rule, on the CPU.

- ``runtime/compile_cache.py`` keeps the JAX package's names, keys and
  warnings: a broken volume and a ``gs://`` path warn and return None (and
  no local ``gs:`` directory appears); ``compile_stats()`` has the JAX
  package's key set.
- With ``_build._start``, ``_build._finish`` and ``ctypes.CDLL`` replaced
  by fakes (there is no nvcc here): a library found in the build directory
  counts as a hit, an nvcc run as a miss; a set cache directory is the
  only place looked in or built into (a library in ``_build/`` is not
  read); ``Servable.warmup`` and ``train()`` report "warm" exactly when
  their window had hits and no nvcc run, and ``/metrics`` exports it.
"""

import importlib
import json
import logging
import os

import numpy as np
import pytest
import torch

from kubeflow_tpu.runtime import compile_cache as JCC
from kubeflow_tpu_torch.obs import registry as obsreg
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.runtime import compile_cache as CC
from kubeflow_tpu_torch.runtime import worker
from kubeflow_tpu_torch.serving import servable as TS
from kubeflow_tpu_torch.serving.http_server import ModelServer

from test_torch_worker import KW

KERNEL = "flash_attention_fwd"
# the module (the package's ops namespace exports the function by its name)
FA = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")


@pytest.fixture(autouse=True)
def clean_cache(monkeypatch, tmp_path):
    """No cache enabled, an empty _build/ of this test's own, no library
    loaded, and the CPU's missing nvcc replaced by fakes that record what
    they were asked."""
    monkeypatch.delenv(CC.COMPILE_CACHE_ENV, raising=False)
    monkeypatch.setattr(_build, "_cache_dir", None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_loaded_paths", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(CC, "_active", None)
    calls = {"nvcc": [], "dlopen": []}

    def start(name, verbose):
        out = _build.library_path(name)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        calls["nvcc"].append(out)
        return None, out + ".tmp", out

    def finish(name, proc, tmp, out):
        with open(out, "wb") as f:
            f.write(b"\x7fELF")
        return ""

    def cdll(path):
        calls["dlopen"].append(path)
        return object()

    monkeypatch.setattr(_build, "_start", start)
    monkeypatch.setattr(_build, "_finish", finish)
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    return calls


def test_names_and_keys_are_the_reference():
    assert (CC.COMPILE_CACHE_ENV, CC.COMPILE_CACHE_SUBDIR,
            CC.SHARED_CACHE_ROOT_ENV) == (JCC.COMPILE_CACHE_ENV,
                                          JCC.COMPILE_CACHE_SUBDIR,
                                          JCC.SHARED_CACHE_ROOT_ENV)
    for root, ns in (("/vol/cache/", "team-a"), ("gs://b/c", "ns")):
        assert CC.namespace_cache_dir(root, ns) == \
            JCC.namespace_cache_dir(root, ns)
        assert CC.default_cache_dir(root) == JCC.default_cache_dir(root)
    assert set(CC.compile_stats()) == set(JCC.compile_stats())


def test_disabled_without_a_path():
    assert CC.enable_compilation_cache() is None
    assert _build.build_dir() == _build.BUILD_DIR


def test_broken_volume_warns_and_returns_none(tmp_path, caplog):
    (tmp_path / "file").write_text("")
    with caplog.at_level(logging.WARNING,
                         logger="kubeflow_tpu_torch.runtime.compile_cache"):
        assert CC.enable_compilation_cache(
            str(tmp_path / "file" / "cache")) is None
    assert "compilation cache disabled" in caplog.text
    assert _build.build_dir() == _build.BUILD_DIR


def test_bucket_uri_warns_and_makes_no_local_directory(tmp_path,
                                                       monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv(CC.COMPILE_CACHE_ENV, "gs://bucket/cache")
    with caplog.at_level(logging.WARNING,
                         logger="kubeflow_tpu_torch.runtime.compile_cache"):
        assert CC.enable_compilation_cache() is None
    assert "gs://bucket/cache" in caplog.text
    assert not (tmp_path / "gs:").exists()
    assert _build.build_dir() == _build.BUILD_DIR


def test_enable_is_idempotent_and_points_the_builds(tmp_path, monkeypatch):
    cache = str(tmp_path / "cache")
    monkeypatch.setenv(CC.COMPILE_CACHE_ENV, cache)
    assert CC.enable_compilation_cache() == cache
    assert CC.enable_compilation_cache() == cache
    assert os.path.isdir(cache) and _build.build_dir() == cache
    assert os.path.dirname(_build.library_path(KERNEL)) == cache


def test_hits_and_misses_are_counted(tmp_path, clean_cache):
    CC.enable_compilation_cache(str(tmp_path / "cache"))
    s0 = CC.compile_stats()
    _build.load_library(KERNEL)                 # cold: nvcc
    _build.load_library(KERNEL)                 # loaded: nothing counted
    s1 = CC.compile_stats()
    assert s1["xla_backend_compiles"] - s0["xla_backend_compiles"] == 1
    assert s1["cache_hits"] == s0["cache_hits"]
    assert CC.start_kind(s0, s1) == "cold"
    _build._loaded.clear()                      # the next process
    _build._loaded_paths.clear()
    _build.load_library(KERNEL)
    s2 = CC.compile_stats()
    assert s2["cache_hits"] - s1["cache_hits"] == 1
    assert s2["xla_backend_compiles"] == s1["xla_backend_compiles"]
    assert s2["cache_requests"] - s0["cache_requests"] == 2
    assert s2["cache_load_s"] >= s1["cache_load_s"]
    assert CC.start_kind(s1, s2) == "warm"
    assert CC.start_kind(s2, s2) == "cold"      # no evidence is cold
    assert len(clean_cache["nvcc"]) == 1
    text = obsreg.default_registry().render()
    assert 'kftpu_compile_cache_events_total{event="hit"}' in text
    assert 'kftpu_compile_cache_events_total{event="miss"}' in text
    assert 'kftpu_xla_compile_seconds_total{stage="cache_load"}' in text
    # build_all's parallel builds: one miss each
    _build.build_all([KERNEL, "fused_adam"])
    assert CC.compile_stats()["xla_backend_compiles"] == \
        s2["xla_backend_compiles"] + 2


def test_a_set_cache_dir_never_reads_build(tmp_path, clean_cache):
    """A library already in _build/ must not make a process with a fresh
    cache directory read as warm: only the cache directory is looked in."""
    in_build = _build.library_path(KERNEL)
    os.makedirs(os.path.dirname(in_build))
    open(in_build, "wb").close()
    cache = str(tmp_path / "cache")
    CC.enable_compilation_cache(cache)
    s0 = CC.compile_stats()
    _build.load_library(KERNEL)
    assert CC.start_kind(s0, CC.compile_stats()) == "cold"
    assert clean_cache["nvcc"] == [os.path.join(
        cache, os.path.basename(in_build))]
    assert all(p.startswith(cache) for p in clean_cache["dlopen"])


def _kernel_servable(name: str) -> TS.Servable:
    """A servable whose forward loads K1's library, as its launch on a
    card would."""
    def predict(params, x):
        _build.load_library(KERNEL)
        return {"y": x * params["w"]}
    return TS.Servable(name=name, predict_fn=predict,
                       params={"w": torch.ones(())}, device="cpu",
                       max_batch=2, input_signature={"inputs": {
                           "shape": [-1, 3], "dtype": "float32"}})


def test_warmup_start_kind_and_metrics(tmp_path):
    CC.enable_compilation_cache(str(tmp_path / "cache"))
    cold = _kernel_servable("m")
    assert cold.warmup() == [1, 2] and cold.start_kind == "cold"
    _build._loaded.clear()                      # a restarted replica
    _build._loaded_paths.clear()
    warm = _kernel_servable("m")
    warm.warmup()
    assert warm.start_kind == "warm"
    server = ModelServer(host="127.0.0.1", port=0)
    server.repository.add(warm)
    text = server.metrics_text()
    assert 'kftpu_serving_start_kind{model="m",kind="warm"} 1' in text
    # loaded already, nothing counted: no evidence, so cold
    again = _kernel_servable("m")
    again.warmup()
    assert again.start_kind == "cold"
    np.testing.assert_array_equal(warm.predict(np.ones((1, 3), np.float32))
                                  ["y"], np.ones((1, 3)))


def test_train_start_kind_follows_the_rule(tmp_path, monkeypatch):
    """train() enables the cache from the env and reads its first step's
    window: nvcc ran → cold; a new process loading from the cache → warm;
    the metric and the first-step event carry it."""
    plain = FA.flash_attention_fwd_plain

    def with_library(*a, **k):
        _build.load_library(KERNEL)
        return plain(*a, **k)

    monkeypatch.setattr(FA, "flash_attention_fwd_plain", with_library)
    monkeypatch.setenv(CC.COMPILE_CACHE_ENV, str(tmp_path / "cache"))
    spans = tmp_path / "spans.jsonl"
    kw = dict(KW, steps=2, kernel_attention="flash",
              span_path=str(spans))
    first = worker.train(**kw)
    assert first.start_kind == "cold"
    _build._loaded.clear()
    _build._loaded_paths.clear()
    second = worker.train(**kw)
    assert second.start_kind == "warm"
    events = [json.loads(line) for line in spans.read_text().splitlines()]
    kinds = [e["attrs"]["start_kind"] for e in events
             if e["name"] == "first-step"]
    assert kinds == ["cold", "warm"]
    text = obsreg.default_registry().render()
    assert 'kftpu_time_to_first_step_seconds_count{start="warm"}' in text


def test_toolkit_release_is_part_of_the_key(monkeypatch):
    """A cache volume shared by nodes with two toolkits keeps a library
    per release: the key holds nvcc --version's release line."""
    monkeypatch.setattr(_build, "nvcc_release", lambda: "release 12.4")
    a = _build.library_path(KERNEL)
    monkeypatch.setattr(_build, "nvcc_release", lambda: "release 12.8")
    assert _build.library_path(KERNEL) != a
    assert os.path.dirname(a) == _build.BUILD_DIR
