"""The port's scheduler soaks held to the JAX package's.

``PreemptionSoak``, ``ElasticSoak`` and ``HealthSoak`` (quarantine on and
off) of ``kubeflow_tpu_torch/scheduler/soak.py`` run their real control
plane — ``FakeCluster``, ``SliceScheduler`` and the training-job
reconciler — around one stub ``train`` patched into both packages'
``runtime/worker.py`` (``test_torch_chaos_soak.StubTrain``: step
directories, no model), each package on its own ``FakeClock`` (the
``time`` of its ``cluster/chaos.py``, ``controllers/runtime.py``,
``controllers/tpujob.py``, ``scheduler/core.py`` and
``scheduler/soak.py``). The JAX soak contends for ``v5e-8`` pools (two
hosts of four chips), the port's for ``h100-8`` nodes (one node of eight
GPUs): the JAX package deletes a host where the port's device plugin
loses half of a node's GPUs, and its flaky host is host 1 of a pool where
the port's is the pool's node.

The reports and the stub's calls must be equal, less what names the
accelerator or a path: node names, the chief pod and the victim's
manifest, the wording of the elastic soak's events, and the JAX-only
cross-degree restore checks (``roundtrip_delta_*``, with the ``ctx`` and
``weight_update`` the JAX elastic segment passes for them; on the port
that restore is ``tests/test_torch_elastic.py``'s). Both packages read the newest intact
step through the stub, since neither checkpoint manager reads the stub's
directories.
"""

import json
import os

import pytest

from test_torch_chaos_soak import CLOCKED, StubTrain, use_fake_clock

#: the modules whose clock drives a scheduler soak, in each package
SCHED_CLOCKED = CLOCKED + ("scheduler.core", "scheduler.soak")

#: report keys that name the accelerator or a path, or that only the JAX
#: soak computes
_SKIP = ("checkpoint_dir", "chief_pod", "victim_manifest", "flaky_node",
         "roundtrip_delta_at_shrink", "roundtrip_delta_final")
#: train() arguments only the JAX elastic segment passes
_CALL_SKIP = ("ctx", "weight_update", "device")


def _rel(value, workdir):
    return os.path.relpath(value, workdir) if value else value


def _run(monkeypatch, tmp_path, make_jax, make_port):
    import kubeflow_tpu.runtime.worker as jax_worker
    from kubeflow_tpu.scheduler import soak as jax_soak

    import kubeflow_tpu_torch.runtime.worker as port_worker
    from kubeflow_tpu_torch.scheduler import soak as port_soak
    use_fake_clock(monkeypatch, SCHED_CLOCKED)
    out = []
    for name, worker, mod, make in (
            ("jax", jax_worker, jax_soak, make_jax),
            ("port", port_worker, port_soak, make_port)):
        workdir = str(tmp_path / name)
        stub = StubTrain(workdir)
        monkeypatch.setattr(worker, "train", stub)
        latest = staticmethod(lambda d, stub=stub: stub._intact(d) or None)
        for cls in ("PreemptionSoak", "ElasticSoak", "HealthSoak"):
            monkeypatch.setattr(getattr(mod, cls), "_latest_step", latest)
        if name == "jax":
            monkeypatch.setattr(mod.ElasticSoak, "roundtrip_delta",
                                lambda self, *a, **kw: 0.0)
        report = make(mod, workdir).run()
        for key in ("victim_resume_from", "victim_rebind_resume_env"):
            if key in report:
                report[key] = _rel(report[key], workdir)
        calls = [{k: v for k, v in c.items() if k not in _CALL_SKIP}
                 for c in stub.calls]
        out.append(({k: v for k, v in report.items() if k not in _SKIP},
                    calls, report))
    return out


def test_preemption_soak_run_loop_equals_the_jax_one(tmp_path,
                                                     monkeypatch):
    (jr, jcalls, _), (pr, pcalls, praw) = _run(
        monkeypatch, tmp_path,
        lambda mod, wd: mod.PreemptionSoak(workdir=wd),
        lambda mod, wd: mod.PreemptionSoak(workdir=wd, device="cpu"))
    assert jr["outcome"] == "succeeded", jr
    assert pr == jr
    assert pcalls == jcalls
    assert (jr["victim_preempted_count"], jr["victim_resume_step"],
            jr["victim_executed_steps"]) == (1, 4, 8)
    # the victim's pods pinned where its binding put them: the pool and
    # the node of the binding's row
    anns = praw["victim_manifest"]["metadata"]["annotations"]
    binding = json.loads(anns["scheduling.kubeflow.org/binding"])
    assert binding["slices"] == [{"pool": "gpu-pool", "x": 0, "y": 0,
                                  "h": 1, "w": 8}]


def test_elastic_soak_run_loop_equals_the_jax_one(tmp_path, monkeypatch):
    (jr, jcalls, _), (pr, pcalls, _) = _run(
        monkeypatch, tmp_path,
        lambda mod, wd: mod.ElasticSoak(workdir=wd),
        lambda mod, wd: mod.ElasticSoak(workdir=wd, device="cpu"))
    assert jr["outcome"] == "succeeded", jr
    # the events name the accelerator ("8 chips (2 hosts)" against "8
    # GPUs (1 node)"): the same count, and the training ones equal
    jev, pev = jr.pop("events"), pr.pop("events")
    assert len(pev) == len(jev) == 5
    assert [e for e in pev if "step" in e] == \
        [e for e in jev if "step" in e]
    assert pr == jr
    assert pcalls == jcalls
    assert jr["chips_seen"] == [8, 4, 8]
    history = json.loads(jr["resize_history"])
    assert [(h["fromChips"], h["toChips"]) for h in history] == \
        [(8, 4), (4, 8)]


@pytest.mark.parametrize("quarantine", [True, False],
                         ids=["quarantine", "blind"])
def test_health_soak_run_loop_equals_the_jax_one(quarantine, tmp_path,
                                                 monkeypatch):
    (jr, jcalls, _), (pr, pcalls, praw) = _run(
        monkeypatch, tmp_path,
        lambda mod, wd: mod.HealthSoak(workdir=wd, quarantine=quarantine),
        lambda mod, wd: mod.HealthSoak(workdir=wd, quarantine=quarantine,
                                       device="cpu"))
    assert jr["outcome"] == "succeeded", jr
    assert pr == jr
    assert pcalls == jcalls
    assert praw["flaky_node"] == "pool-a-h100-8-0"
    if quarantine:
        assert (jr["fires"], jr["rebinds"], jr["migrated"],
                jr["flaky_quarantined"]) == (1, 1, True, True)
        assert jr["pools"] == [["pool-a"], ["pool-b"]]
    else:
        assert (jr["fires"], jr["restarts"], jr["migrated"]) == \
            (3, 3, False)


def test_a_soak_on_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """No fallback: a scheduler soak asked for the card with none present
    raises out of its first segment instead of training on the CPU."""
    import torch

    from kubeflow_tpu_torch.scheduler.soak import HealthSoak
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HealthSoak(workdir=str(tmp_path), total_steps=2).run()
