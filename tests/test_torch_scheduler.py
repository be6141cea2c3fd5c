"""The port's slice scheduler on the CPU: the GPU node inventory on its own
terms, and ``plan()`` held to the JAX package's.

- The inventory (``kubeflow_tpu_torch/scheduler/inventory.py``): a slice
  is a run of GPUs in one node's row and never spans nodes; runs are
  aligned (an ``h100-N`` run starts at a multiple of N); placement is
  fragmentation-first (the largest free aligned run left behind), then
  best-fit, then lexicographic, and deterministic; ``from_nodes`` carves
  down a node's GPUs the device plugin no longer reports (highest first),
  NotReady and quarantined nodes and rows no node claims, and keeps a
  node's row when a middle node is deleted; the binding's wire format is
  the JAX package's (one ``{"pool","x","y","h","w"}`` rect a slice), so
  each package's ``binding_of`` reads the other's.
- ``plan()`` on the scenarios of ``tests/test_scheduler.py``, and on
  the elastic ones of ``tests/test_elastic.py`` (degrade, grow,
  shrink-to-admit, a bind and a shrink folded into one bind): a JAX ``v5e-8`` pool (2 hosts x 4 chips) is one
  ``h100-8`` node, a ``v5e-16`` or ``v5e-32`` pool two or four nodes of
  one pool; a ``v5e-4`` job is ``h100-4``, ``v5e-8`` ``h100-8``,
  ``v5e-16`` and ``v5e-32`` are ``h100-8`` x 2 and x 4 slices. Which jobs
  bind (and at how many chips), queue (and why), get preempted or get
  resized must be equal. Rects are not compared. A multi-slice gang's
  slices may land on any nodes, so only scenarios whose decisions do not
  hang on the JAX grid's 2x2-against-1x4 shapes are held to it; the
  shrink of the lowest-priority gang is checked on the port alone.
"""

import importlib
import json
import random

import pytest

from kubeflow_tpu_torch.api.topology import parse_topology
from kubeflow_tpu_torch.cluster.fake import FakeCluster
from kubeflow_tpu_torch.scheduler import health
from kubeflow_tpu_torch.scheduler.core import plan
from kubeflow_tpu_torch.scheduler.inventory import (Placement, PoolState,
                                                    SliceInventory,
                                                    SliceRect)
from kubeflow_tpu_torch.scheduler.queue import (JobRequest,
                                                SchedulerConfig,
                                                binding_matches,
                                                binding_of)

H8 = parse_topology("h100-8")


def pools(*rows: int) -> SliceInventory:
    """Pools ``pool-0``, ``pool-1``, ... of ``rows[i]`` h100-8 nodes."""
    return SliceInventory([PoolState(f"pool-{i}", H8, n)
                           for i, n in enumerate(rows)])


def gpu_req(name, topo="h100-8", **kw) -> JobRequest:
    return JobRequest(namespace=kw.pop("namespace", "default"), name=name,
                      queue=kw.pop("queue", "default"),
                      priority=kw.pop("priority", 0),
                      preemptible=kw.pop("preemptible", False),
                      topology=parse_topology(topo),
                      num_slices=kw.pop("num_slices", 1),
                      seq=kw.pop("seq", 0), **kw)


# -- the inventory on its own terms -------------------------------------------

def test_a_slice_never_spans_nodes():
    inv = pools(2)
    placed = []
    for i in range(2):
        p = inv.place_gang(H8, 1)
        inv.bind(f"ns/j{i}", p)
        placed.append(p.slices[0])
    assert {(r.x, r.y, r.h, r.w) for r in placed} == {(0, 0, 1, 8),
                                                      (1, 0, 1, 8)}
    assert inv.place_gang(H8, 1) is None
    # two slices of a gang land on two nodes
    inv2 = pools(2)
    gang = inv2.place_gang(H8, 2)
    assert sorted(r.x for r in gang.slices) == [0, 1]
    # four 4-GPU slices fill both nodes exactly, none straddling a row
    inv3 = pools(2)
    for i in range(4):
        p = inv3.place_gang(parse_topology("h100-4"), 1)
        assert p.slices[0].h == 1 and p.slices[0].y in (0, 4)
        inv3.bind(f"ns/q{i}", p)
    assert inv3.free_chips == 0


def test_runs_are_aligned_and_fragmentation_first():
    inv = pools(2)
    one = inv.place_gang(parse_topology("h100-1"), 1)
    inv.bind("ns/one", one)
    assert (one.slices[0].x, one.slices[0].y) == (0, 0)
    # an h100-2 run starts at a multiple of 2: GPU 2, not GPU 1, and on
    # the used node (the empty node stays whole: largest run left 8)
    two = inv.place_gang(parse_topology("h100-2"), 1)
    assert (two.slices[0].x, two.slices[0].y) == (0, 2)
    inv.bind("ns/two", two)
    four = inv.place_gang(parse_topology("h100-4"), 1)
    assert (four.slices[0].x, four.slices[0].y) == (0, 4)
    inv.bind("ns/four", four)
    assert inv.pools["pool-0"].max_free_rect() == 8
    # GPU 1 free but alone: the largest aligned run left in row 0 is 1
    assert inv.pools["pool-0"].grid[0].count("") == 1
    # best-fit between two pools with the same fragmentation score: the
    # tighter pool takes the slice
    inv2 = pools(4, 2)
    assert inv2.place_gang(H8, 1).slices[0].pool == "pool-1"


def test_packing_is_deterministic_under_a_seed():
    def pack(seed):
        rng = random.Random(seed)
        inv = pools(3, 2)
        out, live = [], []
        for i in range(40):
            if live and rng.random() < 0.35:
                inv.release(live.pop(rng.randrange(len(live))))
                continue
            topo = parse_topology(f"h100-{rng.choice((1, 2, 4, 8))}")
            p = inv.place_gang(topo, 1)
            if p is not None:
                inv.bind(f"ns/{i}", p)
                live.append(f"ns/{i}")
            out.append(json.dumps(p.to_dict()) if p else None)
        return out
    assert pack(7) == pack(7)
    assert pack(7) != pack(8)


def _node_cluster():
    """Three h100-8 nodes of one pool, labeled as ``add_gpu_nodes``
    labels its one node."""
    cluster = FakeCluster()
    (node,) = cluster.add_gpu_nodes("h100-8", pool="pool-a")
    for i in (1, 2):
        name = f"pool-a-h100-8-{i}"
        cluster.add_node(name, node["status"]["allocatable"], labels={
            **node["metadata"]["labels"], "kubernetes.io/hostname": name})
    return cluster


def test_from_nodes_carves_lost_gpus_and_unavailable_nodes():
    cluster = _node_cluster()
    cluster.set_node_gpus("pool-a-h100-8-0", 4)
    node = cluster.get("v1", "Node", "", "pool-a-h100-8-2")
    node["metadata"].setdefault("annotations", {})[
        "kubeflow.org/quarantine"] = health.quarantine_record(
            "manual", 0.0, 0.0, None)
    cluster.update(node)
    inv = SliceInventory.from_nodes(cluster.list("v1", "Node"))
    pool = inv.pools["pool-a"]
    assert (pool.rows, pool.cols) == (3, 8)
    assert inv.down_cells == {("pool-a", 0, j) for j in range(4, 8)} | \
        {("pool-a", 2, j) for j in range(8)}
    assert inv.node_at == {("pool-a", i): f"pool-a-h100-8-{i}"
                           for i in range(3)}
    # a binding over the lost GPUs no longer fits; one clear of them does
    assert not inv.valid_binding(Placement("h100-8", 1, [
        SliceRect("pool-a", 0, 0, 1, 8)]))
    assert inv.valid_binding(Placement("h100-4", 1, [
        SliceRect("pool-a", 0, 0, 1, 4)]))
    inv.carve_down()
    assert inv.free_chips == 4 + 8
    # a NotReady node is down whole
    node = cluster.get("v1", "Node", "", "pool-a-h100-8-1")
    node["status"]["conditions"] = [{"type": "Ready", "status": "False"}]
    cluster.update_status(node)
    inv = SliceInventory.from_nodes(cluster.list("v1", "Node"))
    assert {("pool-a", 1, j) for j in range(8)} <= inv.down_cells
    # the device plugin reports every GPU again: the node is whole
    cluster.set_node_gpus("pool-a-h100-8-0", 8)
    inv = SliceInventory.from_nodes(cluster.list("v1", "Node"))
    assert not any(c[1] == 0 for c in inv.down_cells)


def test_a_deleted_middle_node_keeps_the_other_rows():
    cluster = _node_cluster()
    cluster.delete("v1", "Node", "", "pool-a-h100-8-1")
    inv = SliceInventory.from_nodes(cluster.list("v1", "Node"))
    assert inv.node_at == {("pool-a", 0): "pool-a-h100-8-0",
                           ("pool-a", 2): "pool-a-h100-8-2"}
    assert inv.down_cells == {("pool-a", 1, j) for j in range(8)}
    # names that do not number the nodes fall back to positional rows
    inv = SliceInventory.from_nodes([
        {**n, "metadata": {**n["metadata"],
                           "name": n["metadata"]["name"] + "-x9f"}}
        for n in cluster.list("v1", "Node")])
    assert sorted(inv.node_at) == [("pool-a", 0), ("pool-a", 1)]


def test_the_binding_wire_format_is_the_jax_packages():
    from kubeflow_tpu.scheduler import queue as jax_queue
    p = Placement("h100-4", 2, [SliceRect("pool-a", 1, 4, 1, 4),
                                SliceRect("pool-b", 0, 0, 1, 4)],
                  warm_hosts=[{"pool": "pool-a", "host": 1}])
    wire = {"metadata": {"annotations": {
        "scheduling.kubeflow.org/binding": json.dumps(p.to_dict())}}}
    assert binding_of(wire) == p
    back = jax_queue.binding_of(wire)
    assert back.to_dict() == p.to_dict()
    assert back.topology == "h100-4" and back.chips == 8
    jax_wire = {"metadata": {"annotations": {
        "scheduling.kubeflow.org/binding": json.dumps(back.to_dict())}}}
    assert binding_of(jax_wire) == p


def test_shrink_to_admit_takes_the_lowest_priority_gang():
    # (no JAX twin: its v5e-8 gang shrinks onto a 1x4 strip, where a 2x2
    # v5e-4 head does not fit; a GPU run has one shape)
    inv = pools(2)
    bound = []
    for name, prio in (("a", 3), ("b", 0)):
        req = gpu_req(name, priority=prio, min_chips=4, max_chips=8)
        p = inv.place_gang(req.topology, 1)
        inv.bind(req.key, p)
        bound.append((req, p))
    out = plan([gpu_req("head", "h100-4", priority=5, seq=2)], bound, inv,
               SchedulerConfig())
    assert [(r.key, p.chips, why) for r, p, why in out.resizes] == \
        [("default/b", 4, "shrink: admitting blocked head")]
    assert [(r.key, p.slices[0].x) for r, p in out.binds] == \
        [("default/head", 1)]
    assert out.preempts == [] and out.waits == {}


def test_binding_matches_the_elastic_envelope():
    from kubeflow_tpu_torch.api.trainingjob import TrainingJob
    job = TrainingJob.from_manifest({
        "apiVersion": "tpu.kubeflow.org/v1alpha1", "kind": "TPUJob",
        "metadata": {"name": "e", "namespace": "ns"},
        "spec": {"schedulingPolicy": {"minChips": 4, "maxChips": 8},
                 "replicaSpecs": {"GPU": {"gpuTopology": "h100-8"}}}})
    run = lambda n: Placement(f"h100-{n}", 1,  # noqa: E731
                              [SliceRect("p", 0, 0, 1, n)])
    assert [binding_matches(run(n), job) for n in (1, 2, 4, 8)] == \
        [False, False, True, True]
    # the rects must carry the claimed topology's GPUs
    assert not binding_matches(
        Placement("h100-4", 1, [SliceRect("p", 0, 0, 1, 2)]), job)


# -- plan() against the JAX package's -----------------------------------------

#: job shape -> (JAX topology, its slices), (port topology, its slices)
SHAPES = {"4": (("v5e-4", 1), ("h100-4", 1)),
          "8": (("v5e-8", 1), ("h100-8", 1)),
          "16": (("v5e-16", 1), ("h100-8", 2)),
          "32": (("v5e-32", 1), ("h100-8", 4))}
#: pool -> JAX pool topology, port nodes
POOLS = {"8": ("v5e-8", 1), "16": ("v5e-16", 2), "32": ("v5e-32", 4)}


class Side:
    """One package's plan() inputs built from the same scenario."""

    def __init__(self, which: str, pool_shapes: tuple):
        self.which = which
        pkg = "kubeflow_tpu" if which == "jax" else "kubeflow_tpu_torch"
        mod = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
        self.parse = mod("api.topology").parse_topology
        self.core, self.queue = mod("scheduler.core"), mod("scheduler.queue")
        inventory = mod("scheduler.inventory")
        if which == "jax":
            pool_states = [inventory.PoolState(f"pool-{i}",
                                               self.parse(POOLS[s][0]))
                           for i, s in enumerate(pool_shapes)]
        else:
            pool_states = [PoolState(f"pool-{i}", H8, POOLS[s][1])
                           for i, s in enumerate(pool_shapes)]
        self.inv = inventory.SliceInventory(pool_states)

    def req(self, name, shape="8", **kw):
        topo, slices = SHAPES[shape][0 if self.which == "jax" else 1]
        return self.queue.JobRequest(
            namespace=kw.pop("namespace", "default"), name=name,
            queue="default", priority=kw.pop("priority", 0),
            preemptible=kw.pop("preemptible", False),
            topology=self.parse(topo), num_slices=slices,
            seq=kw.pop("seq", 0),
            min_chips=kw.pop("min_chips", None),
            max_chips=kw.pop("max_chips", None))

    def bind(self, req):
        """Place ``req`` with the package's own inventory and bind it."""
        p = self.inv.place_gang(req.topology, req.num_slices)
        assert p is not None, req.key
        self.inv.bind(req.key, p)
        return (req, p)

    def down_half(self, pool: str) -> None:
        """Half of the pool's first node/slice down: the JAX package's
        host 1 of a v5e-8, the port's GPUs 4-7 of the node."""
        pstate = self.inv.pools[pool]
        if self.which == "jax":
            from kubeflow_tpu.scheduler import health as jh
            cells = set(jh.host_cells(pool, pstate.topology, 1))
        else:
            cells = {(pool, 0, j) for j in range(4, 8)}
        self.inv.down_cells |= cells
        self.inv.carve_down()

    def plan(self, queued, bound, quota=None, **policy):
        """``quota``: the default queue's GPUs a namespace may hold;
        ``policy``: SchedulerConfig's switches, as both packages name
        them."""
        queues = {"default": self.queue.QueueSpec("default", dict(quota))} \
            if quota else {}
        out = self.core.plan(queued, bound, self.inv,
                             self.queue.SchedulerConfig(queues=queues,
                                                        **policy))
        return {"binds": sorted((r.key, p.chips) for r, p in out.binds),
                "preempts": sorted(v.key for v in out.preempts),
                "resizes": sorted((r.key, p.chips, why)
                                  for r, p, why in out.resizes),
                "waits": out.waits}


def _priority(s):
    return s.plan([s.req("low", seq=0), s.req("high", priority=5, seq=1)],
                  [])


def _quota(s):
    return s.plan([s.req("a1", namespace="team-a", seq=0),
                   s.req("a2", namespace="team-a", seq=1),
                   s.req("b1", namespace="team-b", seq=2)], [],
                  quota={"team-a": 8})


def _quota_counts_bound(s):
    a1 = s.bind(s.req("a1", seq=0))
    return s.plan([s.req("a2", seq=1)], [a1],
                  quota={"*": 8})


def _cheapest_victim(s):
    bound = [s.bind(s.req("small", "8", preemptible=True, seq=0)),
             s.bind(s.req("big", "16", preemptible=True, seq=1)),
             s.bind(s.req("filler", "8", seq=2))]
    return s.plan([s.req("urgent", "8", priority=10, seq=3)], bound)


def _equal_priority(s):
    peer = s.bind(s.req("peer", priority=5, preemptible=True, seq=0))
    return s.plan([s.req("urgent", priority=5, seq=1)], [peer])


def _non_preemptible(s):
    solid = s.bind(s.req("solid", seq=0))
    return s.plan([s.req("urgent", priority=10, seq=1)], [solid])


def _backfill(s):
    # half of each pool is taken: the head needs a whole pool and is
    # blocked; its reservation (pool-0) keeps the small job to pool-1
    bound = [s.bind(s.req("runner", "4", seq=0)),
             s.bind(s.req("blocker", "4", seq=1))]
    return s.plan([s.req("head", "8", priority=5, seq=2),
                   s.req("small", "4", seq=3)], bound,
                  preemption=False)


def _no_starvation(s):
    blocker = s.bind(s.req("blocker", "16", seq=0))
    queued = [s.req("head", "32", priority=5, seq=1),
              *[s.req(f"small-{i}", "4", seq=2 + i) for i in range(6)]]
    return s.plan(queued, [blocker], preemption=False)


def _fifo(s):
    return s.plan([s.req("first", seq=0),
                   s.req("vip", priority=99, seq=1)], [],
                  priority_order=False, backfill=False, preemption=False)


def _degrade(s):
    s.down_half("pool-0")
    return s.plan([s.req("elastic", min_chips=4, max_chips=8)], [])


def _grow(s):
    req = s.req("elastic", min_chips=4, max_chips=8)
    topo4 = s.parse("v5e-4" if s.which == "jax" else "h100-4")
    p = s.inv.place_gang(topo4, 1)
    s.inv.bind(req.key, p)
    return s.plan([], [(req, p)])


def _shrink_to_admit(s):
    low = s.bind(s.req("low", "16", preemptible=True, min_chips=4,
                       max_chips=16, seq=0))
    return s.plan([s.req("head", "8", priority=5, seq=1)], [low])


def _bind_then_shrink_folds(s):
    return s.plan([s.req("a", "16", priority=1, min_chips=4,
                         max_chips=16, seq=0),
                   s.req("head", "8", priority=5, seq=1)], [])


PLAN_SCENARIOS = {
    # name: (pools, scenario)
    "priority": (("8",), _priority),
    "quota": (("32",), _quota),
    "quota-counts-bound": (("32",), _quota_counts_bound),
    "cheapest-victim": (("32",), _cheapest_victim),
    "equal-priority": (("8",), _equal_priority),
    "non-preemptible": (("8",), _non_preemptible),
    "backfill": (("8", "8"), _backfill),
    "no-starvation": (("32",), _no_starvation),
    "fifo": (("8",), _fifo),
    "degrade": (("8",), _degrade),
    "grow": (("8",), _grow),
    "shrink-to-admit": (("16",), _shrink_to_admit),
    "bind-then-shrink-folds": (("16",), _bind_then_shrink_folds),
}

EXPECTED = {
    "priority": ["default/high"],
    "quota": ["team-a/a1", "team-b/b1"],
    "quota-counts-bound": [],
    "cheapest-victim": ["default/urgent"],
    "equal-priority": [],
    "non-preemptible": [],
    "backfill": ["default/small"],
    "no-starvation": [],
    "fifo": ["default/first"],
    "degrade": ["default/elastic"],
    "grow": [],
    "shrink-to-admit": ["default/head"],
    "bind-then-shrink-folds": ["default/a", "default/head"],
}


@pytest.mark.parametrize("name", list(PLAN_SCENARIOS))
def test_plan_decides_as_the_jax_package_does(name):
    pool_shapes, scenario = PLAN_SCENARIOS[name]
    jax = scenario(Side("jax", pool_shapes))
    port = scenario(Side("port", pool_shapes))
    assert port == jax
    assert [k for k, _ in port["binds"]] == EXPECTED[name]
    if name == "cheapest-victim":
        assert port["preempts"] == ["default/small"]
    if name == "degrade":
        assert port["binds"] == [("default/elastic", 4)]
    if name == "grow":
        assert port["resizes"] == [("default/elastic", 8,
                                    "grow: idle capacity")]
    if name == "shrink-to-admit":
        assert port["resizes"] == [("default/low", 8,
                                    "shrink: admitting blocked head")]
        assert port["preempts"] == [] and port["waits"] == {}
    if name == "bind-then-shrink-folds":
        assert port["resizes"] == [] and port["binds"] == [
            ("default/a", 8), ("default/head", 8)]
    if name == "backfill":
        assert "default/head" in port["waits"]
        assert Side("port", ("8", "8")).inv.pools.keys() == \
            {"pool-0", "pool-1"}
