"""The port's lease, its fence, the leader gate and the controller-chaos
clients, held to the JAX package's.

The counterparts of ``tests/test_ctrl_chaos.py`` ``TestLeaseContract``,
``TestLeaderElector``, ``TestFencedClient``,
``TestControllerLeaderGating``, ``TestControllerChaos`` and the lease
round trip over the wire. Each scenario runs through both packages —
``kubeflow_tpu`` on a ``TPU: v5e-8`` job (two hosts) over
``add_tpu_slice_nodes``, ``kubeflow_tpu_torch`` on ``GPU: h100-2`` over
one ``h100-8`` node: two pods each, named alike — and what each package
returns must be equal: the acquire results and the Lease objects, who
leads, the tokens, the pods, the annotations the successor writes.

Nothing here reads the wall clock: the electors take a ``FakeClock``
(``test_torch_chaos_soak.FakeClock``) as their ``clock``, and the
partitions and the controllers' retry delays run on one patched into
each package's ``cluster/chaos.py`` and ``controllers/runtime.py``.
"""

import importlib
import logging
import types

import pytest

from test_torch_chaos_soak import FakeClock

TPU_AV = "tpu.kubeflow.org/v1alpha1"
PKGS = ("kubeflow_tpu", "kubeflow_tpu_torch")


@pytest.fixture(autouse=True)
def quiet_elections():
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)


def pkg(name: str):
    """The modules a scenario needs, from one package, with its cluster
    helpers: a node for the gang and the gang's job."""
    m = {mod: importlib.import_module(f"{name}.{path}") for mod, path in (
        ("lease", "cluster.lease"), ("chaos", "cluster.chaos"),
        ("client", "cluster.client"), ("fake", "cluster.fake"),
        ("runtime", "controllers.runtime"), ("tpujob", "controllers.tpujob"),
        ("core", "scheduler.core"), ("queue", "scheduler.queue"),
        ("k8s", "api.k8s"))}
    ns = types.SimpleNamespace(**m)
    jax = name == "kubeflow_tpu"

    def cluster():
        c = ns.fake.FakeCluster()
        if jax:
            c.add_tpu_slice_nodes("v5e-8")
        else:
            c.add_gpu_nodes("h100-8")
        return c

    def job(name="train", scheduled=False):
        replica = {"template": {"spec": {"containers": [
            {"name": "trainer", "image": "trainer:v1"}]}}}
        replica.update({"tpuTopology": "v5e-8"} if jax
                       else {"gpuTopology": "h100-2"})
        spec = {"checkpointDir": f"/ckpt/{name}",
                "replicaSpecs": {"TPU" if jax else "GPU": replica},
                "runPolicy": {"backoffLimit": 5}}
        if scheduled:
            spec["schedulingPolicy"] = {"queue": "research", "priority": 0,
                                        "preemptible": True}
        return {"apiVersion": TPU_AV, "kind": "TPUJob",
                "metadata": {"name": name, "namespace": "kubeflow"},
                "spec": spec}

    ns.cluster, ns.job = cluster, job
    return ns


def both(scenario, monkeypatch=None):
    """Run ``scenario(pkg)`` through both packages, each on a fresh
    FakeClock patched into its chaos and runtime modules; return the two
    results."""
    out = []
    for name in PKGS:
        p = pkg(name)
        p.clock = FakeClock()
        if monkeypatch is not None:
            for mod in (p.chaos, p.runtime):
                monkeypatch.setattr(mod, "time", p.clock)
        out.append(scenario(p))
    return out


def pods(p, cluster) -> list:
    return sorted(p.k8s.name_of(o)
                  for o in cluster.list("v1", "Pod", "kubeflow"))


def running(p, cluster) -> int:
    return sum(1 for o in cluster.list("v1", "Pod", "kubeflow")
               if o.get("status", {}).get("phase") == "Running")


# ------------------------------------------------------------ the lease


def _lease(p, cluster) -> dict:
    obj = cluster.get(p.lease.LEASE_API_VERSION, p.lease.LEASE_KIND,
                      "kubeflow", "op")
    return {"apiVersion": obj["apiVersion"], "kind": obj["kind"],
            "metadata": {"name": obj["metadata"]["name"],
                         "namespace": obj["metadata"]["namespace"]},
            "spec": obj["spec"]}


#: (op, identity, duration, now): one acquire/release script
SCRIPT = [("acquire", "a", 10.0, 100.0), ("acquire", "a", 10.0, 105.0),
          ("acquire", "b", 10.0, 110.0), ("acquire", "b", 10.0, 120.0),
          ("release", "a", None, None), ("release", "b", None, None),
          ("acquire", "a", 300.0, 121.0), ("acquire", "b", 300.0, 122.0)]


def test_acquire_and_release_script_equals_the_jax_one():
    def scenario(p):
        cluster = p.fake.FakeCluster()
        steps = []
        for op, ident, duration, now in SCRIPT:
            if op == "acquire":
                r = p.lease.try_acquire(cluster, "kubeflow", "op", ident,
                                        duration, now=now)
                got = (r.acquired, r.reason, vars(r.record))
            else:
                got = p.lease.release(cluster, "kubeflow", "op", ident)
            steps.append((got, _lease(p, cluster)))
        return steps
    jax, port = both(scenario)
    assert port == jax
    # create (token 1), renew, held, steal (token 2), a foreign release
    # refused, the holder's release, and a free lease taken at once
    assert [s[0][0] if isinstance(s[0], tuple) else s[0]
            for s in port] == [True, True, False, True, False, True,
                               True, False]
    assert port[3][1]["spec"]["leaseTransitions"] == 2
    assert port[5][1]["spec"]["holderIdentity"] == ""


def test_concurrent_steal_has_exactly_one_winner():
    """Two standbys see the same expired lease; the second update 409s
    and loses (the rv precondition)."""
    def scenario(p):
        cluster = p.fake.FakeCluster()
        p.lease.try_acquire(cluster, "kubeflow", "op", "dead", 1.0, now=0.0)

        class Racer:
            """Injects competitor b's steal between a's get and update."""

            def __init__(self, inner):
                self.inner = inner
                self.armed = True

            def get(self, *a, **kw):
                out = self.inner.get(*a, **kw)
                if self.armed and a[1] == p.lease.LEASE_KIND:
                    self.armed = False
                    assert p.lease.try_acquire(
                        self.inner, "kubeflow", "op", "b", 10.0,
                        now=100.0).acquired
                return out

            def __getattr__(self, name):
                return getattr(self.inner, name)

        res = p.lease.try_acquire(Racer(cluster), "kubeflow", "op", "a",
                                  10.0, now=100.0)
        rec = p.lease.lease_record(cluster.get(
            p.lease.LEASE_API_VERSION, p.lease.LEASE_KIND, "kubeflow", "op"))
        return res.acquired, res.reason, rec.holder, rec.transitions
    jax, port = both(scenario)
    assert port == jax == (False, "lost-race", "b", 2)


@pytest.mark.parametrize("spec", [{"leaseDurationSeconds": "garbage"},
                                  {"renewTime": [1]}, None],
                         ids=["duration", "renew", "no-spec"])
def test_malformed_lease_reads_as_free(spec):
    def scenario(p):
        cluster = p.fake.FakeCluster()
        obj = {"apiVersion": p.lease.LEASE_API_VERSION,
               "kind": p.lease.LEASE_KIND,
               "metadata": {"name": "op", "namespace": "kubeflow"}}
        if spec is not None:
            obj["spec"] = spec
        cluster.create(obj)
        rec = p.lease.lease_record(obj)
        res = p.lease.try_acquire(cluster, "kubeflow", "op", "a", 10.0,
                                  now=100.0)
        return vars(rec), res.acquired, _lease(p, cluster)["spec"]
    jax, port = both(scenario)
    assert port == jax
    assert port[1] is True


# ------------------------------------------------------------ the elector


def test_elector_fails_over_when_the_leader_dies():
    def scenario(p):
        cluster = p.fake.FakeCluster()
        chaos_a = p.chaos.ControllerChaos(cluster)
        a = p.lease.LeaderElector(client=chaos_a, identity="a", name="op",
                                  duration_s=0.2, clock=p.clock.time)
        b = p.lease.LeaderElector(client=cluster, identity="b", name="op",
                                  duration_s=0.2, clock=p.clock.time)
        first = (a.ensure(), b.ensure())
        # a dies (its client raises everywhere): no renew possible —
        # local expiry demotes it, b steals after the duration
        chaos_a.kill()
        polls = 0
        while not b.ensure():
            p.clock.sleep(0.05)
            polls += 1
        return first, polls, b.is_leader, a.ensure(), a.token, b.token
    jax, port = both(scenario)
    assert port == jax
    first, polls, b_leads, a_leads, a_token, b_token = port
    assert first == (True, False) and b_leads and not a_leads
    assert b_token > a_token   # the fencing token moved on
    assert 0.2 <= polls * 0.05 <= 0.3


def test_graceful_release_hands_over_without_waiting():
    def scenario(p):
        cluster = p.fake.FakeCluster()
        a = p.lease.LeaderElector(client=cluster, identity="a", name="op",
                                  duration_s=300.0, clock=p.clock.time)
        b = p.lease.LeaderElector(client=cluster, identity="b", name="op",
                                  duration_s=300.0, renew_every_s=0.01,
                                  clock=p.clock.time)
        first = (a.ensure(), b.ensure())
        a.release()
        p.clock.sleep(0.02)
        return first, b.ensure(), a.is_leader
    jax, port = both(scenario)
    assert port == jax == ((True, False), True, False)


def test_the_elector_reads_the_modules_clock(monkeypatch):
    """Without a ``clock`` the port's elector reads its module's ``time``
    at each call (the JAX one binds ``time.time`` at import), so one
    patched clock moves every elector of the port."""
    from kubeflow_tpu_torch.cluster import lease
    from kubeflow_tpu_torch.cluster.fake import FakeCluster
    clock = FakeClock()
    monkeypatch.setattr(lease, "time", clock)
    e = lease.LeaderElector(client=FakeCluster(), identity="a", name="op",
                            duration_s=1.0)
    assert e.ensure() and e.is_leader
    clock.sleep(1.5)
    assert not e.is_leader   # no renew within the duration: demoted


# ------------------------------------------------------------ the fence


def test_fenced_client_rejects_a_followers_writes():
    def scenario(p):
        cluster = p.fake.FakeCluster()
        cluster.create(p.job())
        follower = p.lease.LeaderElector(client=cluster, identity="b",
                                         name="op", duration_s=0.2,
                                         clock=p.clock.time)
        p.lease.try_acquire(cluster, "kubeflow", "op", "a", 300.0,
                            now=p.clock.time())
        follower.ensure()
        fenced = p.lease.FencedKubeClient(cluster, follower)
        reads = (bool(fenced.get(TPU_AV, "TPUJob", "kubeflow", "train")),
                 len(fenced.list(TPU_AV, "TPUJob")))
        refused = []
        for call in (lambda: fenced.patch(
                         TPU_AV, "TPUJob", "kubeflow", "train",
                         {"metadata": {"annotations": {"x": "1"}}}),
                     lambda: fenced.delete(TPU_AV, "TPUJob", "kubeflow",
                                           "train"),
                     lambda: fenced.create(p.job("other"))):
            try:
                call()
                refused.append(False)
            except p.lease.FencingError:
                refused.append(True)
        job = cluster.get(TPU_AV, "TPUJob", "kubeflow", "train")
        return (reads, refused, fenced.rejected,
                "x" in p.k8s.annotations_of(job),
                len(cluster.list(TPU_AV, "TPUJob")))
    jax, port = both(scenario)
    assert port == jax == ((True, 1), [True, True, True], 3, False, 1)


# ------------------------------------------------------- leader gating


def _replica(p, cluster, ident, duration=0.25):
    chaos = p.chaos.ControllerChaos(cluster)
    recorder = p.chaos.RecordingKubeClient(chaos)
    elector = p.lease.LeaderElector(client=chaos, identity=ident, name="op",
                                    duration_s=duration, clock=p.clock.time)
    fenced = p.lease.FencedKubeClient(recorder, elector)
    ctrl = p.runtime.Controller(
        reconciler=p.tpujob.TrainingJobReconciler("TPUJob"), client=fenced,
        elector=elector, retry_backoff_s=0.01, retry_backoff_max_s=0.1)
    ctrl.bind_watches()
    ctrl.enqueue_existing()
    return chaos, recorder, elector, ctrl


def test_a_standby_watches_but_writes_nothing(monkeypatch):
    def scenario(p):
        cluster = p.cluster()
        cluster.create(p.job())
        _, rec_a, el_a, ctrl_a = _replica(p, cluster, "a")
        _, rec_b, el_b, ctrl_b = _replica(p, cluster, "b")
        for _ in range(4):
            ctrl_a.run_pending()
            ctrl_b.run_pending()
            cluster.tick()
        out = (el_a.is_leader, el_b.is_leader, rec_a.mutations,
               rec_b.mutations, pods(p, cluster),
               [r["reason"] for r in ctrl_a.relists],
               [r["reason"] for r in ctrl_b.relists])
        ctrl_a.stop()
        ctrl_b.stop()
        return out
    jax, port = both(scenario, monkeypatch)
    assert port == jax
    a_leads, b_leads, rec_a, rec_b, names, relists_a, relists_b = port
    assert a_leads and not b_leads
    assert rec_a and rec_b == []
    assert names == ["train-worker-0-0", "train-worker-0-1"]
    # the leader relisted once on its gain; the standby never
    assert relists_a == ["leader-gain"] and relists_b == []


def test_the_successor_adopts_the_gang_and_finishes(monkeypatch):
    def scenario(p):
        cluster = p.cluster()
        cluster.create(p.job())
        chaos_a, _, el_a, ctrl_a = _replica(p, cluster, "a")
        _, rec_b, el_b, ctrl_b = _replica(p, cluster, "b")
        for _ in range(4):
            ctrl_a.run_pending()
            ctrl_b.run_pending()
            cluster.tick()
        led = el_a.is_leader
        # the leader process dies; the standby must take over and
        # recover the failed gang
        chaos_a.kill()
        ctrl_a.stop()
        cluster.fail_pod("kubeflow", "train-worker-0-1", "chaos: died")
        polls = 0
        while polls < 250:
            ctrl_b.run_pending()
            cluster.tick()
            if el_b.is_leader and running(p, cluster) == 2:
                break
            p.clock.sleep(0.02)
            polls += 1
        job = cluster.get(TPU_AV, "TPUJob", "kubeflow", "train")
        out = (led, el_b.is_leader, polls, len(rec_b.mutations) > 0,
               p.k8s.annotations_of(job).get(
                   p.tpujob.RESTART_COUNT_ANNOTATION), pods(p, cluster))
        ctrl_b.stop()
        return out
    jax, port = both(scenario, monkeypatch)
    assert port == jax
    assert port[:2] == (True, True) and port[2] < 250
    assert port[3:] == (True, "1",
                        ["train-worker-0-0", "train-worker-0-1"])


# -------------------------------------------------- the controller chaos


def test_die_after_lands_the_write_then_kills():
    def scenario(p):
        cluster = p.fake.FakeCluster()
        chaos = p.chaos.ControllerChaos(cluster)
        chaos.die_after("create", 1)
        with pytest.raises(p.chaos.ControllerCrash):
            chaos.create(p.job())
        landed = bool(cluster.get(TPU_AV, "TPUJob", "kubeflow", "train"))
        with pytest.raises(p.chaos.ControllerCrash):
            chaos.list("v1", "Pod")   # dead means dead
        chaos.revive()
        return landed, len(chaos.list(TPU_AV, "TPUJob")), \
            [(f.op, f.kind) for f in chaos.injected]
    jax, port = both(scenario)
    assert port == jax == (True, 1, [("create", "controller-crash")])


def test_a_lease_renewal_never_fires_a_kill_point():
    def scenario(p):
        cluster = p.fake.FakeCluster()
        chaos = p.chaos.ControllerChaos(cluster)
        chaos.die_after("update", 1)
        el = p.lease.LeaderElector(client=chaos, identity="a", name="op",
                                   duration_s=1.0, renew_every_s=0.01,
                                   clock=p.clock.time)
        el.ensure()
        p.clock.sleep(0.02)
        renewed = el.ensure()        # an update of the Lease: exempt
        cluster.create(p.job())
        job = cluster.get(TPU_AV, "TPUJob", "kubeflow", "train")
        p.k8s.annotations_of(job)
        job["metadata"].setdefault("annotations", {})["k"] = "v"
        with pytest.raises(p.chaos.ControllerCrash):
            chaos.update(job)        # the controller's own write: dies
        return renewed, chaos.dead
    jax, port = both(scenario)
    assert port == jax == (True, True)


def test_partition_raises_everything_then_heals(monkeypatch):
    def scenario(p):
        cluster = p.fake.FakeCluster()
        cluster.create(p.job())
        chaos = p.chaos.ControllerChaos(cluster)
        chaos.partition(0.15)
        raised = []
        for call in (lambda: chaos.get(TPU_AV, "TPUJob", "kubeflow",
                                       "train"),
                     lambda: chaos.list("v1", "Pod")):
            try:
                call()
                raised.append(False)
            except p.chaos.TransientAPIError:
                raised.append(True)
        p.clock.sleep(0.2)
        healed = bool(chaos.get(TPU_AV, "TPUJob", "kubeflow", "train"))
        return raised, healed, chaos.partitioned
    jax, port = both(scenario, monkeypatch)
    assert port == jax == ([True, True], True, False)


def test_death_mid_gang_create_leaves_a_half_gang_the_successor_adopts(
        monkeypatch):
    """The operator dies after creating ONE pod of the two-pod gang; a
    fresh controller (in-memory state lost) completes the gang exactly
    once."""
    def scenario(p):
        cluster = p.cluster()
        chaos = p.chaos.ControllerChaos(cluster)
        ctrl = p.runtime.Controller(
            reconciler=p.tpujob.TrainingJobReconciler("TPUJob"),
            client=chaos, retry_backoff_s=0.01, retry_backoff_max_s=0.05)
        ctrl.bind_watches()
        cluster.create(p.job())
        ctrl.enqueue_existing()
        # the service create is call 1; pod 1 is create call 2 — die there
        chaos.die_after("create", 2)
        for _ in range(6):
            ctrl.run_pending()
            cluster.tick()
        half = (chaos.dead, pods(p, cluster))
        ctrl.stop()
        ctrl2 = p.runtime.Controller(
            reconciler=p.tpujob.TrainingJobReconciler("TPUJob"),
            client=cluster)
        ctrl2.bind_watches()
        ctrl2.enqueue_existing()
        for _ in range(4):
            ctrl2.run_pending()
            cluster.tick()
        out = half, pods(p, cluster)
        ctrl2.stop()
        return out
    jax, port = both(scenario, monkeypatch)
    assert port == jax
    assert port == ((True, ["train-worker-0-0"]),
                    ["train-worker-0-0", "train-worker-0-1"])


def test_scheduler_death_after_its_binding_write_is_adopted(monkeypatch):
    """The scheduler dies right after its binding write lands: the
    successor adopts the binding (zero rewrites) and the operator creates
    the gang on it."""
    def scenario(p):
        cluster = p.cluster()
        chaos = p.chaos.ControllerChaos(cluster)
        sched = p.core.SliceScheduler(p.queue.SchedulerConfig())
        cluster.create(p.job(scheduled=True))
        chaos.die_after("update", 1)   # the binding write is an update
        with pytest.raises(Exception):
            sched.reconcile(chaos, ("", "#cluster-pass"))
        first = cluster.get(TPU_AV, "TPUJob", "kubeflow", "train")
        written = p.queue.binding_of(first) is not None
        mgr = p.runtime.Manager(cluster)
        mgr.add(p.core.SliceScheduler(p.queue.SchedulerConfig()))
        mgr.add(p.tpujob.TrainingJobReconciler("TPUJob"))
        for _ in range(3):
            mgr.run_pending()
            cluster.tick()
        mgr.run_pending()
        fresh = cluster.get(TPU_AV, "TPUJob", "kubeflow", "train")
        key = "scheduling.kubeflow.org/binding"
        return (written, p.k8s.annotations_of(fresh)[key] ==
                p.k8s.annotations_of(first)[key], pods(p, cluster))
    jax, port = both(scenario, monkeypatch)
    assert port == jax == (True, True,
                           ["train-worker-0-0", "train-worker-0-1"])


def test_a_stale_watch_rewind_writes_nothing(monkeypatch):
    def scenario(p):
        cluster = p.cluster()
        chaos = p.chaos.ControllerChaos(cluster)
        recorder = p.chaos.RecordingKubeClient(chaos, ignore_kinds=())
        ctrl = p.runtime.Controller(
            reconciler=p.tpujob.TrainingJobReconciler("TPUJob"),
            client=recorder)
        ctrl.bind_watches()
        cluster.create(p.job())
        ctrl.enqueue_existing()
        for _ in range(4):
            ctrl.run_pending()
            cluster.tick()
        before = list(recorder.mutations)
        replayed = chaos.rewind_watch()
        for _ in range(3):
            ctrl.run_pending()
            cluster.tick()
        ctrl.stop()
        return replayed > 0, recorder.mutations == before, \
            [m[:2] for m in before]
    jax, port = both(scenario, monkeypatch)
    assert port == jax
    assert port[:2] == (True, True) and port[2]


# ------------------------------------------------------- over the wire


def test_lease_round_trip_over_the_ports_apiserver():
    """Leases are ordinary objects at the wire level: the port's HTTP
    client elects against the port's apiserver, and the Lease it writes
    reads the same through the JAX package's ``lease_record``."""
    from kubeflow_tpu.cluster import lease as jax_lease

    from kubeflow_tpu_torch.cluster import lease as L
    from kubeflow_tpu_torch.cluster.apiserver import ClusterAPIServer
    from kubeflow_tpu_torch.cluster.client import ConflictError
    from kubeflow_tpu_torch.cluster.fake import FakeCluster
    from kubeflow_tpu_torch.cluster.http_client import HttpKubeClient
    backend = FakeCluster()
    server = ClusterAPIServer(backend, port=0)
    port = server.start()
    try:
        client = HttpKubeClient(f"http://127.0.0.1:{port}", retries=0)
        assert L.try_acquire(client, "kubeflow", "op", "a", 10.0,
                             now=100.0).acquired
        held = L.try_acquire(client, "kubeflow", "op", "b", 10.0,
                             now=105.0)
        assert not held.acquired and held.reason == "held"
        stolen = L.try_acquire(client, "kubeflow", "op", "b", 10.0,
                               now=120.0)
        assert stolen.acquired and stolen.record.transitions == 2
        obj = backend.get(L.LEASE_API_VERSION, L.LEASE_KIND, "kubeflow",
                          "op")
        assert vars(jax_lease.lease_record(obj)) == vars(stolen.record)
        # a stale resourceVersion 409s over the wire as ConflictError
        stale = client.get(L.LEASE_API_VERSION, L.LEASE_KIND, "kubeflow",
                           "op")
        assert L.release(client, "kubeflow", "op", "b")
        with pytest.raises(ConflictError):
            client.update(stale)
    finally:
        server.stop()
