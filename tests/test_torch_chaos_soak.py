"""The port's chaos and sentinel soaks on the CPU: the real operator loop
(``FakeCluster``, the controller runtime, ``TrainingJobReconciler``) on a
``GPU: h100-2`` job, around real training segments of the port's
``worker.train`` on the tiny LM with ``device="cpu"``.

They mirror the JAX package's soak tests (``tests/test_chaos.py``,
``test_soak_truncated_checkpoint_parity``, ``test_soak_full_fault_menu``,
``test_soak_chaos_eats_the_lkg_falls_back_to_next_intact``), which run
only in its slow tier:

- a checkpoint truncated at step 3 of 5 → one GangRestart, and the final
  params within 1e-5 of the clean soak's;
- the five-fault menu (pod kill, API burst, watch drop, truncated
  checkpoint, hung chief) → GangPodsVanished and StallTimeout among the
  restart reasons, at least 3 injected API faults, the job Succeeded;
- a NaN at step 5 with the LKG step's payload truncated at the trip →
  one anomaly, one rollback, and the clean soak's params.

Training runs on one intra-op thread: the suite's workers share the
machine's cores.

The soaks' run loops (segment targets, fault injection, restart-reason
collection, the counting of executed steps, the anomaly hand-off) are
also held to the JAX package's ``ChaosSoak`` and ``SentinelSoak``: both
packages' soaks run with one stub ``train`` that keeps step directories
and plays the numeric fault, and their reports and the stub's calls must
be equal, the accelerator keys left out. Those loops run on one
``FakeClock`` each (the ``time`` of both packages' ``cluster/chaos.py``,
``controllers/runtime.py`` and ``controllers/tpujob.py``): the clock moves
only when a loop sleeps, so the resync, the restart backoff, the stall
watchdog and the poll that samples ``Restarting`` see the same times on
any machine, however loaded.
"""

import os
import types

import pytest
import torch

from kubeflow_tpu_torch.cluster.chaos import (ChaosSoak, NaNInjector,
                                              SentinelSoak, SoakFault,
                                              final_params)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _max_delta(a_dir: str, b_dir: str) -> float:
    a = final_params(a_dir, device="cpu")
    b = final_params(b_dir, device="cpu")
    assert a.keys() == b.keys() and a
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def test_soak_truncated_checkpoint_parity(tmp_path):
    injected = ChaosSoak(workdir=str(tmp_path / "injected"),
                         faults=[SoakFault(3, "truncate-ckpt")],
                         total_steps=5, checkpoint_every=2,
                         device="cpu").run()
    assert injected["outcome"] == "succeeded", injected
    assert injected["restart_reasons"] == ["GangRestart"]
    clean = ChaosSoak(workdir=str(tmp_path / "clean"), faults=[],
                      total_steps=5, checkpoint_every=2, device="cpu").run()
    assert clean["outcome"] == "succeeded", clean
    assert (clean["segments"], clean["executed_steps"]) == (1, 5)
    # the truncated step 3 is skipped: the restart resumes from step 2
    assert injected["executed_steps"] == 3 + 3
    assert _max_delta(injected["checkpoint_dir"],
                      clean["checkpoint_dir"]) <= 1e-5


def test_soak_full_fault_menu(tmp_path):
    report = ChaosSoak(
        workdir=str(tmp_path),
        faults=[SoakFault(2, "pod-kill"), SoakFault(3, "api-burst"),
                SoakFault(4, "watch-drop"), SoakFault(5, "truncate-ckpt"),
                SoakFault(6, "hung-chief")],
        total_steps=8, checkpoint_every=2, device="cpu").run()
    assert report["outcome"] == "succeeded", report
    assert len(report["injected"]) == 5
    assert "GangPodsVanished" in report["restart_reasons"]
    assert "StallTimeout" in report["restart_reasons"]
    assert report["api_faults"] >= 3           # the burst really hit
    assert report["gang_restarts"] == 5 and report["final_step"] == 8
    # the chief the operator rendered: one GPU of an h100-2 gang, the
    # torch.distributed env of its contract
    pod = report["chief_pod"]
    assert pod["spec"]["containers"][0]["resources"]["limits"] == \
        {"nvidia.com/gpu": 1}
    env = {e["name"]: e["value"] for e in pod["spec"]["containers"][0]["env"]}
    assert (env["KFTPU_TOPOLOGY"], env["RANK"], env["WORLD_SIZE"]) == \
        ("h100-2", "0", "2")
    assert f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}" == \
        env["KFTPU_COORDINATOR_ADDRESS"]


def test_soak_chaos_eats_the_lkg_falls_back_to_next_intact(tmp_path):
    injected = SentinelSoak(
        workdir=str(tmp_path / "injected"), fault=NaNInjector(at_step=5),
        total_steps=10, checkpoint_every=2, corrupt_lkg=True,
        device="cpu").run()
    assert injected["outcome"] == "succeeded", injected
    assert injected["lkg_corrupted"] is True
    assert len(injected["anomalies"]) == 1
    assert injected["rollbacks"] == 1
    clean = SentinelSoak(workdir=str(tmp_path / "clean"), total_steps=10,
                         checkpoint_every=2, device="cpu").run()
    assert clean["outcome"] == "succeeded", clean
    assert clean["anomalies"] == [] and clean["rollbacks"] == 0
    assert _max_delta(injected["checkpoint_dir"],
                      clean["checkpoint_dir"]) <= 1e-5


def test_soak_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """No fallback: a soak asked for the card with none present raises
    out of its first segment instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChaosSoak(workdir=str(tmp_path), total_steps=2).run()


# -- the run loops against the JAX package's, with train() stubbed -----------

class StubTrain:
    """One ``train`` for both packages' soaks. It resumes from the newest
    intact step directory of ``resume_from`` (at most ``KFTPU_RESUME_STEP``
    when the operator pinned the LKG), "trains" to ``steps``, writes a step
    directory at every ``checkpoint_every`` and at the end, and plays the
    numeric fault of ``KFTPU_CHAOS_NUMERIC`` (``kind:step``) once a
    segment runs past its step: the anomaly trips the step after, with the
    newest intact step at or before the fault's step as its LKG. A step
    directory holds one payload of ``PAYLOAD`` bytes; the soak's truncation
    makes it short, and a short one is not intact. Each call is logged with
    its paths relative to the soak's work directory."""

    PAYLOAD = 64

    def __init__(self, workdir: str):
        self.workdir = workdir
        self.calls: list = []

    def _intact(self, ckpt: str, at_most=None) -> int:
        steps = [int(n) for n in (os.listdir(ckpt) if os.path.isdir(ckpt)
                                  else []) if n.isdigit()]
        ok = [n for n in steps if (at_most is None or n <= at_most) and
              os.path.getsize(os.path.join(ckpt, str(n), "payload.bin"))
              == self.PAYLOAD]
        return max(ok, default=0)

    def _save(self, ckpt: str, step: int) -> None:
        os.makedirs(os.path.join(ckpt, str(step)), exist_ok=True)
        with open(os.path.join(ckpt, str(step), "payload.bin"), "wb") as f:
            f.write(b"\0" * self.PAYLOAD)

    def __call__(self, *, steps, checkpoint_dir, checkpoint_every,
                 resume_from, **kw):
        pin = os.environ.get("KFTPU_RESUME_STEP")
        start = self._intact(resume_from, int(pin) if pin else None) \
            if resume_from else 0
        end, anomaly = steps, None
        spec = os.environ.get("KFTPU_CHAOS_NUMERIC")
        if spec:
            kind, at = spec.split(":")[0], int(spec.split(":")[1])
            mark = os.environ["KFTPU_CHAOS_NUMERIC_MARK"]
            fired = os.path.exists(mark)
            if not fired and start <= at < steps:
                os.makedirs(os.path.dirname(mark), exist_ok=True)
                open(mark, "w").close()
                end = at + 1
        for n in range(start + 1, end + 1):
            if n % checkpoint_every == 0 or n == steps:
                if not (n == end and end < steps):
                    self._save(checkpoint_dir, n)
        if end < steps:
            anomaly = {"kind": kind, "step": end, "value": "nan",
                       "lkg": self._intact(checkpoint_dir, end - 1)}
        rel = (lambda p: p and os.path.relpath(p, self.workdir))
        self.calls.append({
            "steps": steps, "start": start, "executed": end - start,
            "checkpoint_dir": rel(checkpoint_dir),
            "resume_from": rel(resume_from), "resume_step": pin,
            "replay": os.environ.get("KFTPU_REPLAY_RANGE"),
            "checkpoint_every": checkpoint_every,
            **{k: v for k, v in kw.items() if k != "device"}})
        return types.SimpleNamespace(steps=end - start, anomaly=anomaly)


class FakeClock:
    """One clock for a soak's run loop and the control plane under it:
    ``time``, ``monotonic`` and ``perf_counter`` read it, and only
    ``sleep`` moves it. Patched into a module as its ``time``."""

    def __init__(self, start: float = 1.0e6):
        self.now = start

    def time(self) -> float:
        return self.now

    monotonic = perf_counter = time

    def sleep(self, seconds: float) -> None:
        self.now += max(0.0, float(seconds))


#: the modules, in each package, whose clock drives the soaks' loops
CLOCKED = ("cluster.chaos", "controllers.runtime", "controllers.tpujob")


def use_fake_clock(monkeypatch, modules=CLOCKED) -> None:
    """Give each of ``modules`` of both packages its own fresh
    ``FakeClock`` per package, so each package's soak starts at the same
    time."""
    import importlib
    for pkg in ("kubeflow_tpu", "kubeflow_tpu_torch"):
        clock = FakeClock()
        for mod in modules:
            monkeypatch.setattr(importlib.import_module(f"{pkg}.{mod}"),
                                "time", clock)


#: report keys that name the accelerator, a path or a wall-clock count
_REPORT_SKIP = ("chief_pod", "checkpoint_dir", "span_path", "trace_id",
                "api_calls", "quarantined")


def _both(monkeypatch, tmp_path, make_jax, make_port):
    """Run a JAX soak and a port soak with the stub, each package on its
    own fake clock; return both (report, stub calls)."""
    import kubeflow_tpu.runtime.worker as jax_worker

    import kubeflow_tpu_torch.runtime.worker as port_worker
    use_fake_clock(monkeypatch)
    out = []
    for name, mod, make in (("jax", jax_worker, make_jax),
                            ("port", port_worker, make_port)):
        workdir = str(tmp_path / name)
        stub = StubTrain(workdir)
        monkeypatch.setattr(mod, "train", stub)
        report = make(workdir).run()
        out.append(({k: v for k, v in report.items()
                     if k not in _REPORT_SKIP}, stub.calls))
    return out


CHAOS_CASES = {
    "truncate": dict(faults=[(3, "truncate-ckpt")], total_steps=5),
    "menu": dict(faults=[(2, "pod-kill"), (3, "api-burst"),
                         (4, "watch-drop"), (5, "truncate-ckpt"),
                         (6, "hung-chief")], total_steps=8),
    "pod-fail": dict(faults=[(2, "pod-fail"), (4, "pod-fail")],
                     total_steps=6),
    "clean": dict(faults=[], total_steps=5),
}


@pytest.mark.parametrize("case", sorted(CHAOS_CASES))
def test_chaos_soak_run_loop_equals_the_jax_one(case, tmp_path,
                                                monkeypatch):
    from kubeflow_tpu.cluster import chaos as jax_chaos
    c = CHAOS_CASES[case]

    def make(mod, **kw):
        return lambda workdir: mod.ChaosSoak(
            workdir=workdir, total_steps=c["total_steps"],
            checkpoint_every=2,
            faults=[mod.SoakFault(at, kind) for at, kind in c["faults"]],
            **kw)
    import kubeflow_tpu_torch.cluster.chaos as port_chaos
    (jr, jcalls), (pr, pcalls) = _both(
        monkeypatch, tmp_path, make(jax_chaos),
        make(port_chaos, device="cpu"))
    assert jr["outcome"] == "succeeded", jr
    assert pr == jr
    assert pcalls == jcalls
    assert len(jr["injected"]) == len(c["faults"])


SENTINEL_CASES = {
    "nan-corrupt-lkg": dict(fault=("NaNInjector", 5), corrupt_lkg=True),
    "nan": dict(fault=("NaNInjector", 5), corrupt_lkg=False),
    "spike": dict(fault=("LossSpikePoisoner", 3), corrupt_lkg=False),
    "clean": dict(fault=None, corrupt_lkg=False),
}


@pytest.mark.parametrize("case", sorted(SENTINEL_CASES))
def test_sentinel_soak_run_loop_equals_the_jax_one(case, tmp_path,
                                                   monkeypatch):
    from kubeflow_tpu.cluster import chaos as jax_chaos
    c = SENTINEL_CASES[case]

    def make(mod, **kw):
        fault = getattr(mod, c["fault"][0])(at_step=c["fault"][1]) \
            if c["fault"] else None
        return lambda workdir: mod.SentinelSoak(
            workdir=workdir, fault=fault, total_steps=10,
            checkpoint_every=2, corrupt_lkg=c["corrupt_lkg"], **kw)
    import kubeflow_tpu_torch.cluster.chaos as port_chaos
    (jr, jcalls), (pr, pcalls) = _both(
        monkeypatch, tmp_path, make(jax_chaos),
        make(port_chaos, device="cpu"))
    assert jr["outcome"] == "succeeded", jr
    assert pr == jr
    assert pcalls == jcalls
    assert jr["rollbacks"] == (1 if c["fault"] else 0)
    assert jr["lkg_corrupted"] is c["corrupt_lkg"]
