"""The port's kubebench reporter, configurator and runner against the JAX
package's ``kubeflow_tpu/workflows/kubebench.py``.

- ``report_from_metrics`` from both packages gives one row over the same
  stream: hand-written (multi-step windows, an eval event before the
  first record and one after, warmup 0 and 1) and written by the port's
  own ``train()`` (the tiny LM on the CPU, eval events included), and
  over process 0's file of a two-rank gang.
- ``write_csv_report`` writes the same bytes; ``experiment_paths`` and
  ``configure`` agree; ``CONFIG_MATRIX`` is equal.
- ``run_benchmark``, the Katib study and ``benchmark_matrix`` give the
  JAX rows when ``train`` is one fake in both packages (the device
  columns set aside: training parity is tested where it is today).
- The device columns: the card's name, the cards of the gang, MFU from
  the H100's peak and none on the CPU or an unknown card.
- One real matrix run on the CPU at the JAX slow test's dims.
"""

import csv
import json
import os
import types

import pytest
import torch
from test_torch_bootstrap import spawn_contract

from kubeflow_tpu_torch.models.transformer import TransformerConfig
from kubeflow_tpu_torch.utils import chips as TC
from kubeflow_tpu_torch.workflows import kubebench as TK

DEVICE_COLUMNS = ("device_kind", "chips", "mfu", "vs_baseline")


@pytest.fixture(autouse=True)
def one_thread():
    """The CPU trainings here on one intra-op thread: the suite's workers
    share the machine's cores, and ResNet-50's convolutions on all of
    them in each worker at once run dozens of times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax():
    from kubeflow_tpu.workflows import kubebench
    return kubebench


def _write(path, records):
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    return str(path)


STREAM = [
    {"step": 0, "event": True, "metrics": {"startup_top1": 0.001}},
    {"step": 2, "step_time_s": 0.25, "examples_per_sec": 256.0,
     "loss": 3.5, "grad_norm": 9.0, "window": 2},
    {"step": 5, "step_time_s": 0.125, "examples_per_sec": 512.0,
     "loss": 3.0, "grad_norm": 7.5, "window": 3},
    {"step": 6, "step_time_s": 0.1, "examples_per_sec": 640.0,
     "loss": 2.75, "grad_norm": 7.0, "learning_rate": 0.1},
    {"step": 6, "event": True, "metrics": {"eval_loss": 2.9, "top1": 0.25}},
]


@pytest.mark.parametrize("warmup", [0, 1])
def test_reporter_row_equals_the_jax_one(tmp_path, warmup):
    path = _write(tmp_path / "metrics.jsonl", STREAM)
    env = {TK.ENV_EXP_ID: "e19"}
    got = TK.report_from_metrics(path, job_kind="TFJob", warmup=warmup,
                                 env=env)
    want = _jax().report_from_metrics(path, job_kind="TFJob", warmup=warmup,
                                      env=env)
    assert got == want and list(got) == list(want)
    assert got["metric_top1"] == 0.25 and "metric_startup_top1" not in got
    assert got["steps"] == 6 and got["experiment"] == "e19"


def _tiny_run(path, **kw):
    from kubeflow_tpu_torch.runtime.worker import train
    return train(workload="transformer", device="cpu", optimizer="adam",
                 learning_rate=1e-3, global_batch=4, steps=3,
                 workload_kwargs={"cfg": TransformerConfig.tiny()},
                 metrics_path=path, handle_sigterm=False, **kw)


def test_reporter_reads_the_ports_own_stream(tmp_path):
    """The cross-package reporter contract: the port's worker writes the
    stream (a 2-step window, a 1-step window, eval events), both
    reporters fold it into the same row."""
    path = str(tmp_path / "metrics.jsonl")
    _tiny_run(path, sync_every=2, eval_every=2, eval_batches=1)
    with open(path) as f:
        records = [json.loads(line) for line in f]
    assert [r.get("window", 1) for r in records if not r.get("event")] \
        == [2, 1]
    assert any(r.get("event") for r in records)
    for warmup in (0, 1):
        got = TK.report_from_metrics(path, warmup=warmup, env={})
        want = _jax().report_from_metrics(path, warmup=warmup, env={})
        assert got == want
    assert got["steps"] == 3 and "metric_eval_loss" in got


def _gang_rank(rank, env, out_dir):
    os.environ.update(env)
    row = TK.run_benchmark(
        workload="transformer", steps=3, global_batch=4, device="cpu",
        optimizer="adam", learning_rate=1e-3, sync_every=1,
        workload_kwargs={"cfg": TransformerConfig.tiny()},
        metrics_path=os.path.join(out_dir, "metrics.jsonl"),
        handle_sigterm=False)
    import torch.distributed as dist
    return {"row": row, "group_after": dist.is_initialized()}


def test_gang_rows_count_its_cards_and_the_gangs_rate(tmp_path):
    """Two ranks from the contract env: each row says 2 cards, its rate
    is the gang's (the global batch over the step), the group is gone
    after the run, and process 0's stream gives the JAX reporter's row."""
    ranks = spawn_contract(_gang_rank, 2, str(tmp_path))
    for r in ranks:
        row = r["row"]
        assert row["chips"] == 2 and row["device_kind"] == "cpu"
        assert not r["group_after"]
        assert row["examples_per_sec"] * row["mean_step_time_s"] == \
            pytest.approx(4, rel=1e-3)
    path = str(tmp_path / "metrics.jsonl")
    assert os.path.exists(str(tmp_path / "metrics.p1.jsonl"))
    assert TK.report_from_metrics(path, env={}) == \
        _jax().report_from_metrics(path, env={})


def test_csv_paths_and_configure_equal_the_jax_ones(tmp_path):
    rows = [{"experiment": "a", "examples_per_sec": 1.5, "note": "x,y"},
            {"experiment": "b", "metric_loss": 0.25, "steps": 3}]
    a = TK.write_csv_report(str(tmp_path / "p" / "r.csv"), rows)
    b = _jax().write_csv_report(str(tmp_path / "j" / "r.csv"), rows)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    with pytest.raises(ValueError, match="no rows"):
        TK.write_csv_report(str(tmp_path / "e.csv"), [])
    for env in ({}, {TK.ENV_EXP_ROOT: "/r", TK.ENV_EXP_ID: "i",
                     TK.ENV_CONFIG_ROOT: "/c", TK.ENV_DATA_ROOT: "/d"},
                {TK.ENV_EXP_PATH: "/x/y", TK.ENV_EXP_ID: "i"}):
        assert TK.experiment_paths(env) == _jax().experiment_paths(env)
    for pkg, sub in ((TK, "port"), (_jax(), "jax")):
        env = {TK.ENV_EXP_ROOT: str(tmp_path / sub), TK.ENV_EXP_ID: "e"}
        exp = pkg.configure(env)
        assert exp == str(tmp_path / sub / "e")
        with open(os.path.join(exp, "experiment.json")) as f:
            assert json.load(f)["id"] == "e"
    assert (TK.ENV_CONFIG_ROOT, TK.ENV_DATA_ROOT, TK.ENV_EXP_ROOT,
            TK.ENV_EXP_ID, TK.ENV_EXP_PATH) == (
        _jax().ENV_CONFIG_ROOT, _jax().ENV_DATA_ROOT, _jax().ENV_EXP_ROOT,
        _jax().ENV_EXP_ID, _jax().ENV_EXP_PATH)


def test_config_matrix_equals_the_jax_one():
    assert TK.CONFIG_MATRIX == _jax().CONFIG_MATRIX
    assert list(TK.CONFIG_MATRIX) == list(_jax().CONFIG_MATRIX)


class FakeTrain:
    """One ``train`` for both packages: the numbers are a function of the
    call's arguments, so both packages' runners see the same runs."""

    def __init__(self):
        self.calls = []

    def __call__(self, **kw):
        self.calls.append({k: v for k, v in kw.items()
                           if k not in ("ctx", "device")})
        lr = kw.get("learning_rate", 0.1)
        fused = (kw.get("workload_kwargs") or {}).get("fused", False)
        return types.SimpleNamespace(
            steps=kw["steps"], examples_per_sec=100.0 + 7.0 * fused + lr,
            mean_step_time_s=0.0625, first_window_s=1.25,
            final_metrics={"loss": 2.0 + 4.0 * lr, "grad_norm": 3.5})


def _strip(row):
    return {k: v for k, v in row.items() if k not in DEVICE_COLUMNS}


def test_runners_give_the_jax_rows_with_train_stubbed(tmp_path,
                                                      monkeypatch):
    from kubeflow_tpu.runtime import worker as JW

    from kubeflow_tpu_torch.runtime import worker as TW
    fakes = {"port": FakeTrain(), "jax": FakeTrain()}
    monkeypatch.setattr(TW, "train", fakes["port"])
    monkeypatch.setattr(JW, "train", fakes["jax"])
    monkeypatch.setenv(TK.ENV_EXP_ID, "stub")
    wk = {"image_size": 16, "num_classes": 10}
    port = {
        "run": TK.run_benchmark(steps=4, global_batch=8, device="cpu",
                                report_path=str(tmp_path / "p.csv"),
                                workload_kwargs={**wk, "fused": True}),
        "study": TK._katib_study_benchmark(steps=2, global_batch=8,
                                           trials=3, device="cpu",
                                           workload_kwargs=wk),
        "matrix": TK.benchmark_matrix(str(tmp_path / "pm"), steps=2,
                                      global_batch=8, device="cpu",
                                      workload_kwargs=wk),
    }
    J = _jax()
    jax = {
        "run": J.run_benchmark(steps=4, global_batch=8,
                               report_path=str(tmp_path / "j.csv"),
                               workload_kwargs={**wk, "fused": True}),
        "study": J._katib_study_benchmark(steps=2, global_batch=8,
                                          trials=3, workload_kwargs=wk),
        "matrix": J.benchmark_matrix(str(tmp_path / "jm"), steps=2,
                                     global_batch=8, workload_kwargs=wk),
    }
    assert fakes["port"].calls == fakes["jax"].calls
    assert port["run"]["workload"] == "resnet50-fused"
    assert _strip(port["run"]) == _strip(jax["run"])
    assert _strip(port["study"]) == _strip(jax["study"])
    # the study keeps the lower loss (the lower of three seeded rates)
    lrs = [c["learning_rate"] for c in fakes["port"].calls[1:4]]
    assert port["study"]["metric_best_learning_rate"] == round(min(lrs), 6)
    assert port["study"]["mean_step_time_s"] == 0.0
    assert "mfu" not in port["study"]
    assert list(port["matrix"]) == list(jax["matrix"])
    for name, row in port["matrix"].items():
        assert _strip(row) == _strip(jax["matrix"][name])
        assert [k for k in row if k not in DEVICE_COLUMNS] == \
            [k for k in jax["matrix"][name] if k not in DEVICE_COLUMNS]
        with open(tmp_path / "pm" / f"{name}.csv") as f:
            data = list(csv.DictReader(f))
        assert len(data) == 1 and data[0]["job_kind"] == row["job_kind"]
    # every row has exactly the JAX row's columns, the device ones included
    for p, j in ((port["run"], jax["run"]), (port["study"], jax["study"])):
        assert list(p) == list(j)


def test_matrix_isolates_each_configs_backend_switches(tmp_path,
                                                       monkeypatch):
    """A config that sets a cuDNN switch does not hand it to the next."""
    from kubeflow_tpu_torch.runtime import worker as TW
    fake, seen = FakeTrain(), []

    def train(**kw):
        seen.append(torch.backends.cudnn.benchmark)
        torch.backends.cudnn.benchmark = True
        return fake(**kw)

    monkeypatch.setattr(TW, "train", train)
    before = torch.backends.cudnn.benchmark
    TK.benchmark_matrix(str(tmp_path), steps=1, global_batch=8,
                        device="cpu",
                        configs=["tf_job_simple", "pytorch_ddp"])
    assert seen == [before, before]
    assert torch.backends.cudnn.benchmark == before


def test_device_columns_name_the_card_and_its_peak(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    cuda = torch.device("cuda")
    assert TC.detect_peak_tflops(cuda) == 989.4
    assert TC.device_kind(cuda) == "NVIDIA H100 80GB HBM3"
    cols = TK._device_columns(1000.0, "resnet50-fused", "cuda", 2)
    assert cols == {
        "device_kind": "NVIDIA H100 80GB HBM3", "chips": 2,
        "mfu": round(500.0 * 3 * 4.09e9 / 989.4e12, 4),
        "vs_baseline": round(500.0 / 757.2, 3)}
    assert list(TK._device_columns(1.0, "katib-study", "cuda", 1)) == \
        ["device_kind", "chips"]
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    assert TC.detect_peak_tflops(cuda) is None
    assert TC.resnet50_train_mfu(100.0, cuda) is None
    assert TK._device_columns(10.0, "resnet50", "cuda", 1)["mfu"] == ""
    assert TC.detect_peak_tflops("cpu") is None
    assert TC.device_kind("cpu") == "cpu"
    assert TC.RESNET50_TRAIN_GFLOP_PER_IMAGE == pytest.approx(12.27)


def test_matrix_runs_the_ports_train_on_the_cpu(tmp_path):
    """The JAX slow test's dims (steps 2, batch 8, 16 px, 10 classes)
    through the port's own train(): three CSVs, the fused label, rates
    above zero."""
    out = str(tmp_path / "matrix")
    rows = TK.benchmark_matrix(
        out, steps=2, global_batch=8, device="cpu",
        workload_kwargs={"image_size": 16, "num_classes": 10},
        configs=["tf_job_simple", "tf_job_fused_blocks", "katib_study"])
    assert sorted(os.listdir(out)) == ["katib_study.csv",
                                       "tf_job_fused_blocks.csv",
                                       "tf_job_simple.csv"]
    assert rows["tf_job_simple"]["workload"] == "resnet50"
    assert rows["tf_job_fused_blocks"]["workload"] == "resnet50-fused"
    assert rows["katib_study"]["workload"] == "katib-study/resnet50"
    for row in rows.values():
        assert row["examples_per_sec"] > 0 and row["chips"] == 1
        assert row["device_kind"] == "cpu"
    assert rows["tf_job_simple"]["mfu"] == ""
    assert rows["katib_study"]["metric_best_learning_rate"] > 0


def test_cli_configures_and_reports(tmp_path, monkeypatch):
    """The Workflow's configure → report steps through ``main``: the row
    in ``report.csv`` is the reporter's over the job's stream; without a
    stream the reporter fails; the matrix's default directory is the
    port's own."""
    # main() sets up logging for a container; the test's stays as it is
    monkeypatch.setattr(TK.logging, "basicConfig", lambda **kw: None)
    monkeypatch.setenv(TK.ENV_EXP_ROOT, str(tmp_path))
    monkeypatch.setenv(TK.ENV_EXP_ID, "wf")
    assert TK.main(["configure"]) == 0
    exp = tmp_path / "wf"
    assert TK.main(["report"]) == 1
    path = _write(exp / "metrics.jsonl", STREAM)
    assert TK.main(["report", "--job-kind", "TFJob"]) == 0
    with open(exp / "report.csv") as f:
        (got,) = list(csv.DictReader(f))
    want = TK.report_from_metrics(path, job_kind="TFJob")
    assert got == {k: str(v) for k, v in want.items()}
    seen = {}
    monkeypatch.setattr(TK, "benchmark_matrix",
                        lambda out, **kw: seen.update(out=out, **kw) or {})
    assert TK.main(["matrix", "--steps", "2"]) == 0
    assert seen == {"out": "bench-matrix-torch", "steps": 2,
                    "global_batch": 32, "device": "cuda"}
