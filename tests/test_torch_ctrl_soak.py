"""The port's control-plane soak and split-brain drill held to the JAX
package's.

``ControlPlaneSoak`` of ``kubeflow_tpu_torch/scheduler/soak.py`` runs its
real control plane — two lease-elected operator replicas and two
scheduler replicas, each over its own ``ControllerChaos`` connection, a
``RecordingKubeClient`` and a ``FencedKubeClient``, on one audit
``FakeCluster`` — around one stub ``train`` patched into both packages'
``runtime/worker.py`` (``test_torch_chaos_soak.StubTrain``). Each package
runs on its own ``FakeClock``: the ``time`` of its ``cluster/chaos.py``
(the partitions), ``cluster/lease.py``, ``controllers/runtime.py``,
``controllers/tpujob.py``, ``scheduler/core.py`` and ``scheduler/soak.py``;
the JAX ``LeaderElector`` binds its clock at import, so the test hands
it the JAX package's fake clock through a subclass patched into
``kubeflow_tpu.cluster.lease``. Only ``sleep`` moves a clock, so the
leases, the partitions' heal and the backoffs fall at the same points on
any machine.

The JAX soak's job is ``TPU: v5e-8`` (two hosts, two pods), the port's
``GPU: h100-2`` on one ``h100-8`` node (two pods). Their reports must be
equal field by field, less the paths and the failover seconds; the
stub's calls too.
"""

import importlib
import logging
import os

import pytest

from test_torch_chaos_soak import CLOCKED, StubTrain, use_fake_clock

#: the modules whose clock drives the control-plane soak, in each package
CTRL_CLOCKED = CLOCKED + ("cluster.lease", "scheduler.core",
                          "scheduler.soak")

#: report keys that hold a path or a duration
_SKIP = ("checkpoint_dir", "chief_pod", "failover_s")
_CALL_SKIP = ("device",)

#: the report fields the parity covers, each named
FIELDS = ("outcome", "injected", "segments", "executed_steps", "failovers",
          "partitions", "gang_restarts", "restart_count_writes",
          "duplicate_pod_creates", "lost_annotation_writes",
          "binding_writes", "never_leader_mutations", "replicas_spawned",
          "fenced_rejections", "final_step")


@pytest.fixture(autouse=True)
def quiet_elections():
    # a partition makes every elector log each failed renewal
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


def _clock_the_jax_elector(monkeypatch):
    """Give the JAX ``LeaderElector`` the JAX package's fake clock (its
    ``clock`` default is ``time.time`` bound at import)."""
    from kubeflow_tpu.cluster import lease as jax_lease
    clock = importlib.import_module("kubeflow_tpu.cluster.chaos").time

    class Clocked(jax_lease.LeaderElector):
        def __post_init__(self):
            self.clock = clock.time
            super().__post_init__()

    monkeypatch.setattr(jax_lease, "LeaderElector", Clocked)


def _both(monkeypatch, tmp_path, **kw):
    import kubeflow_tpu.runtime.worker as jax_worker
    from kubeflow_tpu.scheduler import soak as jax_soak

    import kubeflow_tpu_torch.runtime.worker as port_worker
    from kubeflow_tpu_torch.scheduler import soak as port_soak
    use_fake_clock(monkeypatch, CTRL_CLOCKED)
    _clock_the_jax_elector(monkeypatch)
    out = []
    for name, worker, mod, extra in (
            ("jax", jax_worker, jax_soak, {}),
            ("port", port_worker, port_soak, {"device": "cpu"})):
        workdir = str(tmp_path / name)
        stub = StubTrain(workdir)
        monkeypatch.setattr(worker, "train", stub)
        report = mod.ControlPlaneSoak(workdir=workdir, **kw,
                                      **extra).run()
        assert os.path.relpath(report["checkpoint_dir"], workdir) == "job"
        calls = [{k: v for k, v in c.items() if k not in _CALL_SKIP}
                 for c in stub.calls]
        out.append(({k: v for k, v in report.items() if k not in _SKIP},
                    calls, report))
    return out


CASES = {
    # the reference's defaults: 8 steps, a save every 2, 3 operator
    # kills, 2 scheduler kills, 2 partitions, a 0.5 s lease
    "defaults": {},
    "one-of-each": dict(total_steps=5, operator_kills=1, scheduler_kills=1,
                        partitions=1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_control_plane_soak_run_loop_equals_the_jax_one(case, tmp_path,
                                                        monkeypatch):
    (jr, jcalls, _), (pr, pcalls, praw) = _both(monkeypatch, tmp_path,
                                                **CASES[case])
    assert jr["outcome"] == "succeeded", jr
    assert set(FIELDS) <= set(jr)
    assert pr == jr
    assert pcalls == jcalls
    kw = {"operator_kills": 3, "scheduler_kills": 2, "partitions": 2,
          **CASES[case]}
    assert jr["failovers"]["operator"] >= kw["operator_kills"]
    assert jr["failovers"]["scheduler"] >= kw["scheduler_kills"]
    assert jr["partitions"] == kw["partitions"]
    assert "skipped" not in jr
    assert jr["duplicate_pod_creates"] == 0
    assert jr["lost_annotation_writes"] is False
    assert jr["never_leader_mutations"] == 0
    assert len(praw["failover_s"]) == sum(jr["failovers"].values())


def test_split_brain_drill_equals_the_jax_one(monkeypatch):
    from kubeflow_tpu.scheduler.soak import split_brain_drill as jax_drill

    from kubeflow_tpu_torch.scheduler.soak import split_brain_drill
    use_fake_clock(monkeypatch, CTRL_CLOCKED)
    _clock_the_jax_elector(monkeypatch)
    port, jax = split_brain_drill(0.4), jax_drill(0.4)
    assert port == jax
    assert port == {"initial_leader_elected": True, "pods_created": 2,
                    "stolen_by_standby": True, "old_leader_demoted": True,
                    "fenced_write_rejected": True,
                    "old_leader_writes_after_steal": 0,
                    "fenced_rejections": 1, "doubled_pod_creates": 0,
                    "zombie_write_landed": False}


def test_control_plane_soak_trains_the_lm_on_the_cpu(tmp_path):
    """The soak around real segments of the port's ``train()`` on the
    tiny LM: Succeeded, every check, and the clean run's params."""
    import torch

    from kubeflow_tpu_torch.cluster.chaos import final_params
    from kubeflow_tpu_torch.scheduler.soak import ControlPlaneSoak
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        soak = ControlPlaneSoak(workdir=str(tmp_path), device="cpu",
                                total_steps=4, operator_kills=1,
                                scheduler_kills=1, partitions=1)
        report = soak.run()
        clean = soak.clean_params()
    finally:
        torch.set_num_threads(threads)
    assert report["outcome"] == "succeeded", report
    assert report["failovers"]["operator"] >= 1
    assert report["failovers"]["scheduler"] >= 1
    assert report["partitions"] == 1 and "skipped" not in report
    assert report["duplicate_pod_creates"] == 0
    assert not report["lost_annotation_writes"]
    assert report["never_leader_mutations"] == 0
    got = final_params(report["checkpoint_dir"], device="cpu")
    assert got.keys() == clean.keys() and got
    assert max(float((got[k] - clean[k]).abs().max()) for k in got) == 0.0


def test_control_plane_soak_on_cuda_without_a_card_raises(tmp_path,
                                                          monkeypatch):
    """No fallback: asked for the card with none present, the soak raises
    out of its first segment instead of training on the CPU."""
    import torch

    from kubeflow_tpu_torch.scheduler.soak import ControlPlaneSoak
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ControlPlaneSoak(workdir=str(tmp_path), total_steps=2).run()
