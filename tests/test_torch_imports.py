"""The port stands alone and runs where its caller asks, or raises.

- Every module of ``kubeflow_tpu_torch`` imports in a process where
  ``jax``, ``flax`` and ``kubeflow_tpu`` cannot be imported, and the
  package and ``chip_smoke.py`` pass the repository's lint checks.
- Entry points default to ``cuda`` and raise where no card is present.
- The CUDA path has no fallback: without ``nvcc`` the kernel build
  raises.
"""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import kubeflow_tpu_torch
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.serving import servable as TS
from kubeflow_tpu_torch.serving.http_server import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=16, num_layers=1, embed_dim=8, num_heads=1,
            head_dim=8, mlp_dim=16, max_seq_len=8)


def _modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(
        kubeflow_tpu_torch.__path__, prefix="kubeflow_tpu_torch."))


def test_every_module_imports_without_jax():
    modules = _modules()
    assert "kubeflow_tpu_torch.ops.flash_attention" in modules
    assert "kubeflow_tpu_torch.serving.http_server" in modules
    assert "kubeflow_tpu_torch.runtime.worker" in modules
    assert "kubeflow_tpu_torch.ops.fused_adam" in modules
    assert "kubeflow_tpu_torch.ops.fused_block_train" in modules
    assert "kubeflow_tpu_torch.ops.fused_block_train_spatial" in modules
    assert "kubeflow_tpu_torch.models.resnet" in modules
    assert "kubeflow_tpu_torch.ops.fused_block" in modules
    assert "kubeflow_tpu_torch.serving.batch_predict" in modules
    for name in ("data.pipeline", "data.native", "data.imagenet",
                 "data.mp_augment", "data.device_prefetch",
                 "utils.tbevents", "obs.http"):
        assert f"kubeflow_tpu_torch.{name}" in modules, name
    code = "\n".join([
        "import importlib, sys",
        "for name in ('jax', 'flax', 'optax', 'kubeflow_tpu'):",
        "    sys.modules[name] = None",
        f"for m in {modules!r}:",
        "    importlib.import_module(m)",
        "bad = [m for m in sys.modules if m.split('.')[0] in",
        "       ('jax', 'jaxlib', 'flax', 'optax', 'kubeflow_tpu')",
        "       and sys.modules[m] is not None]",
        "assert not bad, bad",
        "print('ok', len(" + repr(modules) + "))",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_data_layer_imports_without_torch():
    """The augment workers are spawned processes that import the data
    layer: the package's ``__init__``, ``data/__init__`` and the modules
    they load must not pull in torch (or its CUDA state)."""
    code = "\n".join([
        "import importlib, sys",
        "for name in ('torch', 'jax', 'kubeflow_tpu'):",
        "    sys.modules[name] = None",
        "for m in ('kubeflow_tpu_torch', 'kubeflow_tpu_torch.data',",
        "          'kubeflow_tpu_torch.data.imagenet',",
        "          'kubeflow_tpu_torch.data.mp_augment'):",
        "    importlib.import_module(m)",
        "print('ok')",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_no_source_line_imports_jax():
    pattern = re.compile(
        r"^\s*(import|from) (jax|flax|optax|kubeflow_tpu)\b", re.M)
    roots = [os.path.join(REPO, "kubeflow_tpu_torch"),
             os.path.join(REPO, "chip_smoke.py")]
    files = [roots[1]] + [os.path.join(d, f)
                          for d, _, fs in os.walk(roots[0])
                          for f in fs if f.endswith(".py")]
    offenders = [f for f in files
                 if pattern.search(open(f, encoding="utf-8").read())]
    assert not offenders


def test_load_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.ModelRepository().load("lm", "transformer_lm", **TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.Servable(name="m", predict_fn=lambda p, x: {}, params={})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--model-type", "transformer_lm", "--no-warmup"])
    # the CPU only when asked for
    s = TS.ModelRepository().load("lm", "transformer_lm", device="cpu",
                                  **TINY)
    assert s.device == torch.device("cpu")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load_library("flash_attention_fwd")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build_all()
    assert _build.sources() == ["flash_attention_bwd", "flash_attention_fwd",
                                "fused_adam", "fused_block",
                                "fused_block_train"]


def test_build_key_follows_the_source(monkeypatch, tmp_path):
    """The library's name is keyed by the source's content and the
    flags, so an edited kernel is rebuilt, never loaded stale."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(src))
    first = _build.library_path("k")
    (src / "k.cu").write_text("// two\n")
    assert _build.library_path("k") != first
    assert os.path.dirname(first) == _build.BUILD_DIR
    with pytest.raises(_build.KernelBuildError, match="no CUDA source"):
        _build.library_path("missing")


def test_port_and_chip_smoke_pass_lint():
    """tests/test_lint.py scans kubeflow_tpu and tests only."""
    from kubeflow_tpu.utils.lint import check_file, check_tree
    findings = check_tree(REPO, ("kubeflow_tpu_torch",)) + \
        check_file(os.path.join(REPO, "chip_smoke.py"))
    assert not findings, "\n" + "\n".join(str(f) for f in findings)
