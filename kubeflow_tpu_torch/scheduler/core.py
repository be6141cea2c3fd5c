"""The gang scheduler: one planning pass + the k8s reconcile loop.

The port's copy of ``kubeflow_tpu/scheduler/core.py`` over the GPU node
inventory (``scheduler/inventory.py``: a slice is a run of GPUs inside
one node). The training-job operator (controllers/tpujob.py) creates NO
pods for a scheduler-managed job (one carrying ``spec.schedulingPolicy``)
until this scheduler writes the slice binding annotation; until then the
job shows a ``Queued`` condition. One planning pass:

1. Build the slice inventory from the cluster's GPU nodes and re-occupy
   it from every live binding.
2. Order the queue (priority desc, submission order; scheduler/queue.py)
   and walk it: quota-blocked jobs wait; placeable jobs bind (the
   placement annotation); the FIRST unplaceable job becomes the blocked
   head of line.
3. The blocked head's fallback ladder: SHRINK lower-priority elastic
   gangs (minChips/maxChips jobs resize to a smaller slice size — a
   checkpointed restart, no work lost) until the head fits; an elastic
   head that still cannot place binds DEGRADED below its nominal shape
   (shrink-to-survive — the lost-GPU case); only then PREEMPT —
   cheapest lower-priority preemptible gangs (fewest GPUs first) are
   unbound until the head fits. A victim is re-queued, not failed — the
   operator tears its gang down through the graceful path (SIGTERM →
   forced checkpoint → exit 75) and the job's own checkpoints make the
   eventual re-bind cheap.
4. Behind a blocked head, BACKFILL continues — but never into the head's
   reserved region (a geometry-only placement of the head's shape whose
   cells only ever drain), so backfill can never starve the head.
5. With nothing waiting on capacity, the idle-GPU passes run: GROW one
   bound elastic gang into free GPUs, or MIGRATE one to enlarge the
   largest free aligned run (defragmentation) — one resize per pass,
   each executed by the operator as a checkpointed gang restart at the
   binding's new shape.

``plan()`` is pure (inventory in, actions out). Every clock read goes
through this module's ``time``.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field
from typing import Optional

from ..api import k8s
from ..api.trainingjob import (BINDING_ANNOTATION, COND_FAILED,
                               COND_SUCCEEDED, PREEMPTED_COUNT_ANNOTATION,
                               QUARANTINE_ANNOTATION,
                               RESIZE_HISTORY_ANNOTATION,
                               SCHED_REASON_ANNOTATION,
                               SCHED_STATE_ANNOTATION, SUSPECT_ANNOTATION,
                               TPU_API_VERSION, TrainingJob)
from ..cluster.client import (KubeClient, NotFoundError, apply_annotations,
                              update_with_conflict_retry)
from ..controllers.runtime import (Key, Reconciler, Result,
                                   ensure_trace_id, trace_job_event)
from ..obs import controlplane as ctrlobs
from ..obs import registry as obsreg
from . import health
from .inventory import POOL_LABEL, Placement, SliceInventory
from .queue import (JobRequest, SchedulerConfig, binding_matches,
                    binding_of, ordered, over_quota, request_of,
                    resize_history)

# resize-history entries kept on the annotation (audit trail + the grow
# cooldown's clock; older entries roll off)
RESIZE_HISTORY_MAX = 20

log = logging.getLogger(__name__)

# scheduler states surfaced via SCHED_STATE_ANNOTATION
STATE_QUEUED = "queued"
STATE_BOUND = "bound"
STATE_PREEMPTED = "preempted"


@dataclass
class Plan:
    """One pass's decisions, in apply order: resizes and victims release
    first (their chips are what the binds below may be counting on)."""

    binds: list = field(default_factory=list)       # (JobRequest, Placement)
    preempts: list = field(default_factory=list)    # JobRequest (victims)
    # elastic resize plans: (JobRequest, new Placement, reason) — the
    # binding rewrites the operator executes as a checkpointed gang
    # restart at the new shape (shrink-to-admit, grow-to-fill, defrag
    # migration; a shrink-to-survive of a QUEUED job rides in ``binds``
    # with a reduced-shape placement instead)
    resizes: list = field(default_factory=list)
    # key -> human reason a job stayed queued (quota, capacity, ...)
    waits: dict = field(default_factory=dict)


def _preempt_for(head: JobRequest, bound: list,
                 inventory: SliceInventory,
                 avoid: Optional[set] = None) -> Optional[list]:
    """Cheapest victim set that lets ``head`` fit, or None. Victims must
    be lower priority AND preemptible; candidates are released
    greedily cheapest-first (fewest chips, then lowest priority, then
    newest — the least sunk work) until the head places, then PRUNED:
    any victim whose chips turn out not to be needed (released early
    from the wrong pool before the one that mattered) is re-bound —
    nobody eats a SIGTERM for a placement they never blocked. The
    inventory is mutated only when a sufficient set exists."""
    # newest-first within equal (chips, priority): least sunk work lost.
    # Two stable sorts because seq may be a (timestamp, uid) tuple —
    # not negatable the way an int tiebreak would be.
    candidates = sorted(
        (r for r, _p in bound
         if r.preemptible and r.priority < head.priority),
        key=lambda r: r.seq, reverse=True)
    candidates.sort(key=lambda r: (r.chips, r.priority))
    if not candidates:
        return None
    placements = {r.key: p for r, p in bound}
    victims: list[JobRequest] = []
    snapshot = [[row[:] for row in p.grid]
                for p in inventory.pools.values()]
    fits = False
    for victim in candidates:
        inventory.release(victim.key)
        victims.append(victim)
        if inventory.place_gang(head.topology, head.num_slices,
                                avoid=avoid) is not None:
            fits = True
            break
    if not fits:
        # insufficient even with every candidate gone: restore occupancy
        for pool, grid in zip(inventory.pools.values(), snapshot):
            pool.grid = [row[:] for row in grid]
        return None
    # prune most-expensive-first so the cheap victims stay the preferred
    # cost when either would do
    for victim in sorted(victims, key=lambda r: -r.chips):
        inventory.bind(victim.key, placements[victim.key])
        if inventory.place_gang(head.topology, head.num_slices,
                                avoid=avoid) is not None:
            victims.remove(victim)    # not actually in the way
        else:
            inventory.release(victim.key)
    return victims


def _rects_free(inventory: SliceInventory, placement) -> bool:
    """Whether every cell of ``placement`` is currently free."""
    for rect in placement.slices:
        pool = inventory.pools.get(rect.pool)
        if pool is None or not pool.fits(rect.x, rect.y, rect.h, rect.w):
            return False
    return True


def _shrink_for(head: JobRequest, bound: list,
                inventory: SliceInventory,
                avoid: Optional[set] = None) -> Optional[list]:
    """Shrink set of elastic lower-priority bound gangs that lets
    ``head`` fit at its nominal shape, or None. The resize analog of
    ``_preempt_for`` and tried BEFORE it: a shrink is a checkpointed
    restart at a smaller replica degree — degraded-mode training — so
    no work is thrown away, where a preemption costs the victim its
    progress since the last checkpoint. Victims shrink one supported
    slice size at a time, lowest priority first (biggest current gang
    breaking ties — most chips freed per restart), until the head
    places; then resizes are PRUNED: any victim whose original rects
    are still free with the head placeable is restored — nobody eats a
    restart for chips the head never needed. Mutates the inventory only
    when a sufficient set exists. Returns [(victim, new Placement)]."""
    from .queue import elastic_topologies, placement_slice_chips
    candidates = []
    for r, p in bound:
        if r.priority >= head.priority or not r.elastic:
            continue
        cur = placement_slice_chips(p)
        opts = [t for t in elastic_topologies(r) if t.num_gpus < cur]
        if opts:
            candidates.append((r, p, opts))
    if not candidates:
        return None
    candidates.sort(key=lambda c: (c[0].priority, -c[1].chips, c[0].key))
    snapshot = [[row[:] for row in p.grid]
                for p in inventory.pools.values()]
    resized: dict[str, tuple] = {}   # key -> (victim, original, new)
    fits = False
    for victim, original, opts in candidates:
        for topo in opts:   # descending: one supported size at a time
            inventory.release(victim.key)
            new_p = inventory.place_gang(topo, victim.num_slices)
            if new_p is None:
                # smaller shape unplaceable (pathological fragmentation):
                # restore the victim's current occupancy and move on
                cur_p = resized[victim.key][2] if victim.key in resized \
                    else original
                inventory.bind(victim.key, cur_p)
                break
            inventory.bind(victim.key, new_p)
            resized[victim.key] = (victim, original, new_p)
            if inventory.place_gang(head.topology, head.num_slices,
                                    avoid=avoid) is not None:
                fits = True
                break
        if fits:
            break
    if not fits:
        for pool, grid in zip(inventory.pools.values(), snapshot):
            pool.grid = [row[:] for row in grid]
        return None
    # prune most-chips-restored-first: keep the cheapest shrink set
    for key, (victim, original, new_p) in sorted(
            resized.items(), key=lambda kv: -kv[1][1].chips):
        inventory.release(victim.key)
        if _rects_free(inventory, original):
            inventory.bind(victim.key, original)
            if inventory.place_gang(head.topology, head.num_slices,
                                    avoid=avoid) is not None:
                del resized[key]    # never actually needed to shrink
                continue
            inventory.release(victim.key)
        inventory.bind(victim.key, new_p)
    return [(v, p) for v, _o, p in resized.values()]


def _place_degraded(inventory: SliceInventory, req: JobRequest,
                    avoid: Optional[set], reserved: set):
    """Shrink-to-survive placement for a QUEUED elastic job: walk the
    allowed shapes BELOW nominal, largest first, honoring the same
    avoid-preference semantics as the nominal attempt (suspect cells are
    a preference; the head-of-line reservation is inviolable). Returns
    the reduced-shape Placement or None — degraded-mode training
    instead of starving behind a lost host or a fragmented pool."""
    from .queue import elastic_topologies
    for topo in elastic_topologies(req):
        if topo.num_gpus >= req.topology.num_gpus:
            continue
        placement = inventory.place_gang(topo, req.num_slices,
                                         avoid=avoid or None)
        if placement is None and avoid and avoid != reserved:
            placement = inventory.place_gang(topo, req.num_slices,
                                             avoid=reserved or None)
        if placement is not None:
            return placement
    return None


def plan(queued: list[JobRequest], bound: list,
         inventory: SliceInventory, config: SchedulerConfig,
         avoid_cells: Optional[dict] = None,
         prefer_cells: Optional[set] = None) -> Plan:
    """Pure planning over a pre-occupied inventory. ``bound`` is
    [(JobRequest, Placement)] for every currently bound gang (their cells
    already occupied in ``inventory``). ``avoid_cells`` maps a job key to
    cells ITS placement must keep clear of — the suspect-host exclusion:
    a job evacuating a flaky host must not be re-placed onto it even
    while the host is still formally schedulable. ``prefer_cells`` are
    the advertised warm-pod slots (scheduler/warmpool.py): placements
    covering them adopt a pre-initialized pod, so ties tip toward them
    (preference only — never worth a worse fragmentation cut). Mutates
    the inventory to reflect its own decisions (callers pass a
    throwaway rebuild)."""
    out = Plan()
    avoid_cells = avoid_cells or {}
    live_bound = list(bound)
    reserved: set = set()
    head_blocked = False
    for req in ordered(queued, config):
        if over_quota(req, live_bound, config):
            out.waits[req.key] = (
                f"quota: queue {req.queue!r} namespace {req.namespace!r} "
                f"bound-chip quota would be exceeded")
            continue
        if head_blocked and not config.backfill:
            out.waits[req.key] = "waiting: behind blocked head of line"
            continue
        req_avoid = reserved | avoid_cells.get(req.key, set())
        placement = inventory.place_gang(req.topology, req.num_slices,
                                         avoid=req_avoid or None,
                                         prefer=prefer_cells)
        if placement is None and avoid_cells.get(req.key):
            # suspect exclusion is PREFERENCE, not a constraint: when
            # no placement clear of the suspect exists (single-pool
            # cluster, full-pool gang), running on the suspect beats
            # starving forever — retry honoring only the head-of-line
            # reservation, which must never be violated
            placement = inventory.place_gang(req.topology,
                                             req.num_slices,
                                             avoid=reserved or None,
                                             prefer=prefer_cells)
        if placement is not None:
            inventory.bind(req.key, placement)
            out.binds.append((req, placement))
            live_bound.append((req, placement))
            continue
        if head_blocked:
            out.waits[req.key] = "capacity: no contiguous slice free " \
                                 "(backfill could not place clear of " \
                                 "the head-of-line reservation)"
            continue
        # The blocked head of line. Resize paths come FIRST — both end
        # at a checkpoint boundary so no work is thrown away: (1) shrink
        # elastic lower-priority gangs until the head fits at nominal
        # (instead of preempting them to zero), (2) shrink the head
        # ITSELF below nominal (degraded-mode training — the lost-host /
        # no-same-size-rectangle case; better to run at half width than
        # to starve or crash-loop). Only then preemption, else reserve —
        # the suspect exclusion stays preference-only throughout: a head
        # that cannot place clear of its suspect falls back to ignoring
        # it rather than deadlocking the queue.
        head_avoid = avoid_cells.get(req.key, set())
        if config.elastic:
            shrunk = _shrink_for(req, live_bound, inventory,
                                 avoid=head_avoid or None)
            if shrunk is None and head_avoid:
                shrunk = _shrink_for(req, live_bound, inventory)
                if shrunk is not None:
                    head_avoid = set()
            if shrunk is not None:
                new_by_key = {v.key: p for v, p in shrunk}
                live_bound = [(r, new_by_key.get(r.key, p))
                              for r, p in live_bound]
                out.resizes.extend(
                    (v, p, "shrink: admitting blocked head")
                    for v, p in shrunk)
                placement = inventory.place_gang(
                    req.topology, req.num_slices,
                    avoid=head_avoid or None)
                if placement is not None:
                    inventory.bind(req.key, placement)
                    out.binds.append((req, placement))
                    live_bound.append((req, placement))
                    continue
            if req.elastic:
                placement = _place_degraded(inventory, req,
                                            avoid=head_avoid or None,
                                            reserved=reserved)
                if placement is not None:
                    # bound at a reduced shape: the binding itself is
                    # the resize plan — grow-to-fill restores the
                    # nominal shape once capacity returns
                    inventory.bind(req.key, placement)
                    out.binds.append((req, placement))
                    live_bound.append((req, placement))
                    continue
        if config.preemption:
            victims = _preempt_for(req, live_bound, inventory,
                                   avoid=head_avoid or None)
            if victims is None and head_avoid:
                victims = _preempt_for(req, live_bound, inventory)
                if victims is not None:
                    head_avoid = set()
            if victims is not None:
                victim_keys = {v.key for v in victims}
                live_bound = [(r, p) for r, p in live_bound
                              if r.key not in victim_keys]
                out.preempts.extend(victims)
                placement = inventory.place_gang(req.topology,
                                                 req.num_slices,
                                                 avoid=head_avoid or None)
                if placement is not None:
                    inventory.bind(req.key, placement)
                    out.binds.append((req, placement))
                    live_bound.append((req, placement))
                    continue
        head_blocked = True
        reserved = inventory.reserve_for(req.topology, req.num_slices,
                                         avoid=head_avoid or None)
        if not reserved and head_avoid:
            reserved = inventory.reserve_for(req.topology,
                                             req.num_slices)
        out.waits[req.key] = (
            "capacity: head of line, waiting for reserved slices to "
            "drain" if reserved else
            "capacity: request can never fit this cluster's pools")
    if config.elastic and not head_blocked:
        _plan_grow_and_defrag(out, live_bound, inventory, config)
    # One action per job per pass: a gang BOUND this pass and then
    # resized by a later head's shrink (or the grow pass) folds into a
    # single bind at the final shape — it has no running pods yet, so
    # there is nothing to restart and no separate resize to record.
    bind_idx = {r.key: i for i, (r, _p) in enumerate(out.binds)}
    folded = []
    for req, placement, reason in out.resizes:
        i = bind_idx.get(req.key)
        if i is not None:
            out.binds[i] = (out.binds[i][0], placement)
        else:
            folded.append((req, placement, reason))
    out.resizes = folded
    return out


def _plan_grow_and_defrag(out: Plan, live_bound: list,
                          inventory: SliceInventory,
                          config: SchedulerConfig) -> None:
    """The idle-capacity passes, run only when nothing is waiting on
    capacity (head not blocked — with backfill on, every remaining wait
    is quota): (1) GROW one bound elastic gang into the idle chips,
    largest allowed shape first, highest priority gang first; (2) if
    nothing grew, MIGRATE one bound elastic gang whose re-placement
    strictly enlarges the cluster's largest contiguous free rectangle
    (defragmentation — stranded slivers are what quietly halve a
    cluster's effective capacity). One resize per pass: each is a
    checkpointed gang restart, and the next pass sees the new state —
    incremental beats a same-pass restart storm. Gangs inside the grow
    cooldown (req.grow_ok False) are skipped; both passes respect
    per-(queue, namespace) quotas via the gang's ACTUAL chip count."""
    from ..api.topology import parse_topology
    from .queue import elastic_topologies, placement_slice_chips

    def actual_bound_chips(queue: str, namespace: str,
                           skip_key: str) -> int:
        return sum(p.chips for r, p in live_bound
                   if r.queue == queue and r.namespace == namespace
                   and r.key != skip_key)

    candidates = sorted(
        ((r, p) for r, p in live_bound if r.elastic and r.grow_ok),
        key=lambda rp: (-rp[0].priority, rp[0].seq, rp[0].key))
    if config.grow:
        for req, placement in candidates:
            cur = placement_slice_chips(placement)
            ups = [t for t in elastic_topologies(req)
                   if t.num_gpus > cur]
            if not ups:
                continue
            quota = config.queue(req.queue).quota_for(req.namespace)
            others = actual_bound_chips(req.queue, req.namespace,
                                        req.key)
            inventory.release(req.key)
            new_p = None
            for topo in ups:    # largest allowed shape first
                total = topo.num_gpus * req.num_slices
                if quota is not None and others + total > quota:
                    continue
                new_p = inventory.place_gang(topo, req.num_slices)
                if new_p is not None:
                    break
            if new_p is None:
                inventory.bind(req.key, placement)
                continue
            inventory.bind(req.key, new_p)
            out.resizes.append((req, new_p, "grow: idle capacity"))
            return
    if not config.defrag:
        return
    def frag_score() -> int:
        return max((p.max_free_rect()
                    for p in inventory.pools.values()), default=0)
    before = frag_score()
    for req, placement in candidates:
        try:
            topo = parse_topology(placement.topology)
        except ValueError:
            continue
        inventory.release(req.key)
        new_p = inventory.place_gang(topo, req.num_slices)
        if new_p is None or new_p.slices == placement.slices:
            inventory.bind(req.key, placement)
            continue
        inventory.bind(req.key, new_p)
        if frag_score() > before:
            out.resizes.append((req, new_p, "defrag: migrating to "
                                "enlarge the largest free rectangle"))
            return
        inventory.release(req.key)
        inventory.bind(req.key, placement)


class SliceScheduler(Reconciler):
    """The reconcile-loop host for plan(): every TPUJob or Node event
    triggers a full scheduling pass (level-triggered — the pass reads
    desired state fresh, so per-key granularity would buy nothing)."""

    # where the deployed scheduler reads its policy (the ConfigMap the
    # tpu-scheduler manifest renders; manifests/training.py)
    CONFIG_MAP = ("kubeflow", "tpu-scheduler-config")
    CONFIG_KEY = "config.json"

    def __init__(self, config: Optional[SchedulerConfig] = None):
        # the whole policy (quotas, backfill, preemption, elastic, health,
        # warm pods). An explicitly passed config wins forever (tests,
        # soaks, embedded use); otherwise each pass reads the
        # tpu-scheduler-config ConfigMap, so the deployed policy is live
        self._explicit_config = config
        self._cm_rv: Optional[str] = None
        self._cm_config = SchedulerConfig()
        # when each still-queued job was first seen waiting: feeds the
        # queue-wait histogram at bind time and the "queued" trace event
        # exactly once per wait (a preempted job re-enters and waits
        # again — that is a second, separately measured wait)
        self._queued_since: dict[str, float] = {}
        # queues ever exported, so a queue that drains to zero exports
        # zeros instead of its stale last depth
        self._known_queues: set = set()
        # last Ready state per GPU node: a True→False transition folds a
        # not-ready health event (flappy hosts quarantine themselves);
        # tracked even with health disabled so re-enabling does not read
        # one old flap as fresh evidence
        self._node_ready: dict[str, bool] = {}
        # nodes whose health gauges were exported (deleted nodes must
        # drop their series, not freeze their last score)
        self._health_exported: set = set()
        self.primary = (TPU_API_VERSION, "TPUJob")
        # reconcile-metrics label (controllers/runtime.py): the primary
        # kind is TPUJob here too, and the operator owns that label
        self.controller_name = "scheduler"
        # Node events (pool added/drained) re-plan too; map_event routes
        # them to a synthetic pass key since nodes carry no owner ref
        self.owns = [("v1", "Node")]

    @property
    def config(self) -> SchedulerConfig:
        return self._explicit_config or self._cm_config

    def _refresh_config(self, client: KubeClient) -> None:
        if self._explicit_config is not None:
            return
        cm = client.get_or_none("v1", "ConfigMap", *self.CONFIG_MAP)
        if cm is None:
            self._cm_rv, self._cm_config = None, SchedulerConfig()
            return
        rv = cm.get("metadata", {}).get("resourceVersion")
        if rv is not None and rv == self._cm_rv:
            return   # unchanged since last pass: keep the parsed config
        try:
            self._cm_config = SchedulerConfig.from_dict(json.loads(
                (cm.get("data") or {}).get(self.CONFIG_KEY, "") or "{}"))
        except (ValueError, TypeError) as e:
            # a malformed ConfigMap must not take the scheduler down —
            # fall back to defaults and keep binding
            log.warning("scheduler: bad %s/%s %s (%s); using defaults",
                        *self.CONFIG_MAP, self.CONFIG_KEY, e)
            self._cm_config = SchedulerConfig()
        self._cm_rv = rv

    def map_event(self, client: KubeClient, obj: dict) -> list[Key]:
        if obj.get("kind") == "Node":
            return [("", "#cluster-pass")]
        return []

    # ---------------------------------------------------------- node health

    def _health_pass(self, client: KubeClient, nodes: list[dict],
                     now: float) -> list[dict]:
        """Score, quarantine, and release GPU nodes from the failure
        evidence in their health annotations (scheduler/health.py).
        Write-on-change throughout: a steady-state pass writes nothing.
        Returns the node list with this pass's patches folded in, so
        the inventory built right after sees them."""
        cfg = self.config.health
        score_g = obsreg.gauge(
            "kftpu_node_health_score",
            "decayed failure score per GPU node (scheduler/health.py)",
            labels=("node",))
        quar_g = obsreg.gauge(
            "kftpu_node_quarantined",
            "1 while the host carries the quarantine annotation",
            labels=("node",))
        tracer_event = None
        from ..obs.trace import default_tracer
        tracer = default_tracer("scheduler")
        if tracer is not None:
            tracer_event = tracer.event
        out, seen = [], set()
        _UNSET = object()
        for node in nodes:
            name = k8s.name_of(node)
            if POOL_LABEL not in k8s.labels_of(node):
                out.append(node)
                continue
            seen.add(name)
            ready = k8s.condition_true(node, "Ready")
            flapped = self._node_ready.get(name) is True and not ready
            self._node_ready[name] = ready
            if cfg.enabled and flapped:
                # Ready→NotReady transition: evidence, exactly once per
                # flap — a chronically flapping host earns quarantine
                rec = health.record_host_event(
                    client, name, health.EVENT_NOT_READY, now=now,
                    half_life_s=cfg.half_life_s)
                if rec is not None:
                    node = client.get_or_none("v1", "Node", "", name) \
                        or node
            score = health.decayed_score(node, now, cfg.half_life_s)
            quarantine = health.quarantine_of(node)
            patch_val = _UNSET
            # spec.unschedulable to set alongside (None = untouched):
            # cell carving alone cannot stop the kube scheduler from
            # placing a gang's pods back on the node (a pod pins by
            # pool label and hostname) — the cordon closes that hole
            cordon = None
            if cfg.enabled:
                if quarantine is None and \
                        score >= cfg.quarantine_threshold:
                    patch_val = health.quarantine_record(
                        f"health score {score:.2f} >= "
                        f"{cfg.quarantine_threshold:g}", score, now,
                        cfg.quarantine_s, cordoned=True)
                    cordon = True
                    obsreg.counter(
                        "kftpu_sched_quarantines_total",
                        "hosts quarantined for crossing the health "
                        "threshold").inc()
                    if tracer_event:
                        tracer_event("node-quarantined", node=name,
                                     score=round(score, 3))
                    log.warning("scheduler: quarantining %s "
                                "(score %.2f)", name, score)
                elif quarantine is not None and \
                        health.release_eligible(node, cfg, now):
                    patch_val = None   # kube null-delete
                    if quarantine["cordoned"]:
                        cordon = False  # only OUR cordon is undone
                    obsreg.counter(
                        "kftpu_sched_quarantine_releases_total",
                        "quarantines auto-released after expiry + score "
                        "decay (probation)").inc()
                    if tracer_event:
                        tracer_event("node-released", node=name,
                                     score=round(score, 3))
                    log.info("scheduler: releasing %s from quarantine "
                             "(score %.2f)", name, score)
                elif quarantine is not None \
                        and quarantine["until"] is not None \
                        and now >= quarantine["until"] \
                        and quarantine["reason"] != health.MANUAL_REASON:
                    # expired but still hot: extend (probation re-up),
                    # one write per expiry period
                    patch_val = health.quarantine_record(
                        quarantine["reason"], score, now,
                        cfg.quarantine_s,
                        cordoned=quarantine["cordoned"])
            elif quarantine is not None and \
                    quarantine["reason"] != health.MANUAL_REASON:
                # health switched OFF: release every auto-quarantine
                # now — "placement-blind" must not strand chips behind
                # annotations nothing will ever expire (manual
                # quarantines are a human's call and stay)
                patch_val = None
                if quarantine["cordoned"]:
                    cordon = False
                obsreg.counter(
                    "kftpu_sched_quarantine_releases_total",
                    "quarantines auto-released after expiry + score "
                    "decay (probation)").inc()
                log.info("scheduler: health disabled; releasing %s "
                         "from quarantine", name)
            if patch_val is not _UNSET:
                # conflict-safe: the operator folds health evidence onto
                # this same node concurrently — a stale-read write here
                # re-reads and re-applies instead of clobbering the fold
                def _mutate(obj: dict, patch_val=patch_val,
                            cordon=cordon) -> dict:
                    apply_annotations(obj, {QUARANTINE_ANNOTATION:
                                            patch_val})
                    if cordon is not None:
                        obj.setdefault("spec", {})["unschedulable"] = \
                            cordon
                    return obj
                try:
                    node = update_with_conflict_retry(
                        client, "v1", "Node", "", name, _mutate)
                except Exception as e:  # noqa: BLE001 — health writes
                    # must never take down the scheduling pass
                    log.warning("scheduler: quarantine patch for %s "
                                "failed: %s", name, e)
            score_g.labels(node=name).set(round(score, 6))
            quar_g.labels(node=name).set(
                1 if health.is_quarantined(node) else 0)
            out.append(node)
        for stale in self._health_exported - seen:
            score_g.remove(node=stale)
            quar_g.remove(node=stale)
            self._node_ready.pop(stale, None)
        self._health_exported = seen
        return out

    # ------------------------------------------------------------- the pass

    def reconcile(self, client: KubeClient, key: Key) -> Result:
        del key  # every pass is cluster-wide
        # the audit seam: direct-drive callers (tests, bench, sim-replay)
        # get write attribution too; under the controller runtime the
        # client arrives already audited and ctrl_pass joins the
        # runtime's open pass context instead of double-counting
        if not isinstance(client, ctrlobs.AuditingKubeClient):
            client = ctrlobs.AuditingKubeClient(client,
                                                self.controller_name)
        with ctrlobs.ctrl_pass(self.controller_name) as pctx:
            return self._plan_pass(client, pctx)

    def _plan_pass(self, client: KubeClient,
                   pctx: "ctrlobs.PassContext") -> Result:
        t_pass = time.perf_counter()
        now = time.time()
        with pctx.phase(ctrlobs.PHASE_SNAPSHOT):
            self._refresh_config(client)
            raw_nodes = client.list("v1", "Node")
        with pctx.phase(ctrlobs.PHASE_HEALTH):
            nodes = self._health_pass(client, raw_nodes, now)
        inventory = SliceInventory.from_nodes(nodes)
        health_on = self.config.health.enabled
        queued: list[JobRequest] = []
        bound: list = []
        manifests: dict[str, dict] = {}
        avoid_cells: dict[str, set] = {}
        with pctx.phase(ctrlobs.PHASE_SNAPSHOT):
            # the job-scan loop is snapshot work (parse + binding
            # validation); its corrective writes (evacuations,
            # stale-binding drops) are timed here too
            jobs_scanned = self._scan_jobs(client, inventory, health_on,
                                           now, queued, bound,
                                           manifests, avoid_cells)
        return self._finish_pass(client, pctx, inventory, queued, bound,
                                 manifests, avoid_cells, jobs_scanned,
                                 len(nodes), t_pass)

    def _scan_jobs(self, client: KubeClient, inventory: SliceInventory,
                   health_on: bool, now: float, queued: list,
                   bound: list, manifests: dict,
                   avoid_cells: dict) -> int:
        """Parse + validate every TPUJob manifest against the inventory
        (the pass's job snapshot): re-occupy valid bindings, queue the
        rest, evacuate gangs off suspect hosts. Returns manifests
        scanned (completed jobs included — the skip is part of the
        scan)."""
        job_manifests = client.list(*self.primary)
        for manifest in job_manifests:
            if k8s.condition_true(manifest, COND_SUCCEEDED) or \
                    k8s.condition_true(manifest, COND_FAILED):
                continue
            try:
                job = TrainingJob.from_manifest(manifest)
            except ValueError as e:
                log.warning("scheduler: skipping unparseable job: %s", e)
                continue
            req = request_of(job, manifest)
            if req is None:
                continue   # not scheduler-managed
            manifest = ensure_trace_id(client, manifest)
            manifests[req.key] = manifest
            placement = binding_of(manifest)
            ok = placement is not None \
                and binding_matches(placement, job) \
                and inventory.valid_binding(placement)
            suspect = health.suspect_of(manifest) if health_on else None
            suspect_cells = inventory.cells_by_node.get(suspect, set()) \
                if suspect else set()
            if ok and suspect_cells and any(
                    not suspect_cells.isdisjoint(r.cells())
                    for r in placement.slices):
                # failure-domain-aware rebind: the operator pinned this
                # gang's last teardown on a host the binding still
                # covers — evacuate instead of crash-looping in place
                log.info("scheduler: evacuating %s off suspect host %s",
                         req.key, suspect)
                self._patch_state(client, manifest, STATE_QUEUED,
                                  f"rebinding: evacuating suspect host "
                                  f"{suspect}", binding=None)
                # counted AFTER the patch succeeded (the pass-wide
                # invariant): a transient apiserver error above requeues
                # the pass, and the retry must not double-count
                obsreg.counter(
                    "kftpu_sched_suspect_evacuations_total",
                    "bindings dropped to migrate a gang off a suspect "
                    "host").inc()
                self._trace_event(manifest, "evacuating-suspect",
                                  node=suspect)
                ok = False
            if ok:
                try:
                    inventory.bind(req.key, placement)
                except ValueError as e:
                    # overlapping bindings (scheduler-replica overlap
                    # during a rollout, a hand-edited annotation): the
                    # LATER job in list order loses its binding and
                    # re-queues — one bad annotation must degrade to a
                    # requeue, never crash every future pass
                    log.warning("scheduler: conflicting binding for "
                                "%s (%s); requeueing it", req.key, e)
                    ok = False
                    self._patch_state(client, manifest, STATE_QUEUED,
                                      "rebinding: binding no longer "
                                      "matches spec/pools", binding=None)
                    queued.append(req)
                    if suspect_cells:
                        avoid_cells[req.key] = suspect_cells
                    continue
            if ok:
                # grow/defrag hysteresis: a gang resized more recently
                # than the cooldown is not grown or migrated again (a
                # shrink stays allowed — it happens via requeue+replan)
                hist = resize_history(manifest)
                if hist:
                    try:
                        last = float(hist[-1].get("time", 0))
                    except (TypeError, ValueError):
                        last = 0.0
                    req.grow_ok = now - last >= self.config.grow_cooldown_s
                bound.append((req, placement))
                if suspect:
                    # bound clear of the suspect (already migrated, or
                    # the node left the cluster): the record is spent —
                    # clear it so future replans stop avoiding the host
                    self._clear_suspect(client, manifest)
            else:
                if placement is not None and \
                        binding_of(manifests[req.key]) is not None and \
                        not suspect_cells:
                    # stale binding (spec reshaped under it, pool gone,
                    # host down/quarantined): drop it so the job
                    # re-queues cleanly
                    self._patch_state(client, manifest, STATE_QUEUED,
                                      "rebinding: binding no longer "
                                      "matches spec/pools/hosts",
                                      binding=None)
                queued.append(req)
                if suspect_cells:
                    # the replan must keep clear of the suspect even
                    # while the host is still formally schedulable
                    avoid_cells[req.key] = suspect_cells
        return len(job_manifests)

    def _finish_pass(self, client: KubeClient,
                     pctx: "ctrlobs.PassContext",
                     inventory: SliceInventory, queued: list, bound: list,
                     manifests: dict, avoid_cells: dict,
                     jobs_scanned: int, nodes_scanned: int,
                     t_pass: float) -> Result:
        """Plan + apply + warm pass, phase-attributed (plan / writes /
        warm-pass)."""
        self._note_queued(queued, manifests)
        with pctx.phase(ctrlobs.PHASE_PLAN):
            inventory.carve_down()
            # warm-pod pools (scheduler/warmpool.py): the slots
            # advertised LAST pass are this pass's placement preference
            # — a bind that lands on one adopts a pre-initialized pod
            # instead of cold-starting, so ties tip toward them
            from . import warmpool
            warm_slots = warmpool.slots_of(client) \
                if self.config.warm_pods > 0 else []
            prefer = warmpool.slot_cells(warm_slots, inventory) or None
            decisions = plan(queued, bound, inventory, self.config,
                             avoid_cells=avoid_cells, prefer_cells=prefer)
        # metrics/events fire AFTER their patch succeeded (the same
        # invariant as the operator's gang-restart counter): a transient
        # apiserver error requeues the whole pass, and the retry must
        # not double-count a preemption or observe a bogus second wait
        with pctx.phase(ctrlobs.PHASE_WRITES):
            for req, new_placement, reason in decisions.resizes:
                old = next((p for r, p in bound if r.key == req.key), None)
                self._apply_resize(client, manifests[req.key], old,
                                   new_placement, reason)
            for victim in decisions.preempts:
                self._apply_preempt(client, manifests[victim.key])
                obsreg.counter(
                    "kftpu_sched_preemptions_total",
                    "gangs reclaimed (requeued, not failed) for "
                    "higher-priority work", labels=("queue",)).labels(
                        queue=victim.queue).inc()
                self._trace_event(manifests[victim.key], "preempted",
                                  queue=victim.queue, chips=victim.chips)
            now = time.time()
            for req, placement in decisions.binds:
                if warm_slots:
                    # stamp the adopted warm slots into the binding: the
                    # operator retires exactly these pre-initialized pods
                    # and marks the gang warm-started
                    placement.warm_hosts = warmpool.covered_slots(
                        placement, warm_slots, inventory)
                # a rebind retires the job's suspect record: the new
                # placement was planned around it, evidence already folded
                extra = {SUSPECT_ANNOTATION: None} \
                    if health.suspect_of(manifests[req.key]) else {}
                resized = placement.chips != req.chips
                extra_fn = None
                if resized:
                    # a non-nominal bind IS the resize — below nominal it
                    # is shrink-to-survive, above it a grow folded into
                    # the bind (gang placed straight into idle capacity)
                    # — recorded on the history annotation so dashboards
                    # and the grow cooldown see it (extra_fn: appended
                    # onto the FRESH object's history per write attempt)
                    reason = ("shrink: degraded bind (no nominal "
                              "rectangle free)"
                              if placement.chips < req.chips else
                              "grow: bound above nominal into idle "
                              "capacity")
                    extra_fn = (lambda obj, req=req, placement=placement,
                                reason=reason, now=now: {
                                    RESIZE_HISTORY_ANNOTATION:
                                    self._history_json(
                                        obj, req.chips, placement.chips,
                                        reason, now)})
                self._patch_state(client, manifests[req.key], STATE_BOUND,
                                  "bound", binding=placement,
                                  extra=extra or None, extra_fn=extra_fn)
                if resized:
                    self._count_resize(manifests[req.key], req.chips,
                                       placement.chips, reason)
                waited = now - self._queued_since.pop(req.key, now)
                obsreg.histogram(
                    "kftpu_sched_queue_wait_seconds",
                    "admission→bind wait per gang (preempted gangs wait "
                    "again)", labels=("queue",)).labels(
                        queue=req.queue).observe(waited)
                self._trace_event(
                    manifests[req.key], "bound", queue=req.queue,
                    chips=req.chips, wait_seconds=round(waited, 3),
                    pools=sorted({r.pool for r in placement.slices}))
            for req in queued:
                if req.key in decisions.waits:
                    self._mark_queued(client, manifests[req.key],
                                      decisions.waits[req.key])
        with pctx.phase(ctrlobs.PHASE_WARM):
            pending_warm = {
                (w["pool"], int(w["host"]))
                for _r, p in [*bound, *decisions.binds]
                for w in (p.warm_hosts or [])}
            self._warm_pass(client, inventory, pending_warm)
        self._export_queue_gauges(queued, bound, decisions)
        obsreg.gauge(
            "kftpu_sched_pass_jobs_scanned",
            "TPUJob manifests scanned by the last plan pass").set(
                jobs_scanned)
        obsreg.gauge(
            "kftpu_sched_pass_nodes_scanned",
            "nodes scanned by the last plan pass").set(nodes_scanned)
        pctx.note(jobs_scanned=jobs_scanned, nodes_scanned=nodes_scanned,
                  queued=len(queued), bound=len(bound),
                  binds=len(decisions.binds),
                  preempts=len(decisions.preempts))
        obsreg.histogram(
            "kftpu_sched_plan_seconds",
            "wall time of one cluster-wide scheduling pass").observe(
                time.perf_counter() - t_pass)
        return Result()

    def _warm_pass(self, client: KubeClient, inventory: SliceInventory,
                   pending_warm: Optional[set] = None) -> None:
        """Advertise up to config.warm_pods still-free hosts as warm
        slots (post-plan occupancy: a host a bind just took is no
        longer free) and reconcile the pre-initialized pods onto them
        (scheduler/warmpool.py). Deterministic slot choice keeps warm
        pods from churning across steady passes; with the knob at 0
        any leftover pods/slots from a previous config are retired.
        Failures downgrade to a warning — warmth is an optimization,
        the pass must bind regardless."""
        import os

        from ..runtime.compile_cache import SHARED_CACHE_ROOT_ENV
        from . import warmpool
        n = max(0, int(self.config.warm_pods))
        try:
            slots = warmpool.free_hosts(inventory)[:n] if n else []
            warmpool.write_slots(client, slots)
            created, deleted = warmpool.reconcile_warm_pods(
                client, slots, inventory,
                cache_dir=os.environ.get(SHARED_CACHE_ROOT_ENV, ""),
                keep=pending_warm)
            obsreg.gauge(
                "kftpu_sched_warm_slots",
                "idle hosts currently advertised as warm-pod slots"
            ).set(len(slots))
            if created or deleted:
                obsreg.counter(
                    "kftpu_sched_warm_pods_total",
                    "warm pods created/retired by the scheduler's "
                    "warm pass", labels=("action",)).labels(
                        action="created").inc(created)
                obsreg.counter(
                    "kftpu_sched_warm_pods_total",
                    "warm pods created/retired by the scheduler's "
                    "warm pass", labels=("action",)).labels(
                        action="deleted").inc(deleted)
                log.info("scheduler: warm pool now %d slots "
                         "(+%d/-%d pods)", len(slots), created, deleted)
        except Exception as e:  # noqa: BLE001 — warmth is optional
            log.warning("scheduler: warm-pool pass failed: %s", e)

    # -------------------------------------------------------- observability

    def _trace_event(self, manifest: dict, name: str, **attrs) -> None:
        trace_job_event("scheduler", manifest, name, **attrs)

    def _note_queued(self, queued: list, manifests: dict) -> None:
        """First-seen bookkeeping for the wait histogram + exactly one
        "queued" trace event per wait; keys that left the queue by any
        path (bound, deleted, finished) are pruned."""
        now = time.time()
        current = {r.key for r in queued}
        for stale in set(self._queued_since) - current:
            del self._queued_since[stale]
        for req in queued:
            if req.key not in self._queued_since:
                self._queued_since[req.key] = now
                self._trace_event(manifests[req.key], "queued",
                                  queue=req.queue, chips=req.chips,
                                  priority=req.priority)

    def _export_queue_gauges(self, queued: list, bound: list,
                             decisions: Plan) -> None:
        """Per-queue depth and capacity gauges; a queue that drains
        exports zeros (not its stale last values)."""
        depth = obsreg.gauge("kftpu_sched_queue_depth",
                             "gangs waiting for a binding",
                             labels=("queue",))
        qchips = obsreg.gauge("kftpu_sched_queued_chips",
                              "chips demanded by waiting gangs",
                              labels=("queue",))
        bgangs = obsreg.gauge("kftpu_sched_bound_gangs",
                              "gangs currently bound to slices",
                              labels=("queue",))
        bchips = obsreg.gauge("kftpu_sched_bound_chips",
                              "chips currently bound to gangs",
                              labels=("queue",))
        newly_bound = {req.key for req, _ in decisions.binds}
        preempted = {req.key for req in decisions.preempts}
        stats: dict[str, list] = {}
        for req in queued:
            s = stats.setdefault(req.queue, [0, 0, 0, 0])
            if req.key not in newly_bound:
                s[0] += 1
                s[1] += req.chips
        for req, _ in bound:
            s = stats.setdefault(req.queue, [0, 0, 0, 0])
            if req.key not in preempted:
                s[2] += 1
                s[3] += req.chips
        for req, _ in decisions.binds:
            s = stats.setdefault(req.queue, [0, 0, 0, 0])
            s[2] += 1
            s[3] += req.chips
        self._known_queues |= set(stats)
        for q in self._known_queues:
            d, qc, bg, bc = stats.get(q, (0, 0, 0, 0))
            depth.labels(queue=q).set(d)
            qchips.labels(queue=q).set(qc)
            bgangs.labels(queue=q).set(bg)
            bchips.labels(queue=q).set(bc)

    # -------------------------------------------------------------- patches

    def _patch_state(self, client: KubeClient, manifest: dict, state: str,
                     reason: str, binding: Optional[Placement],
                     extra: Optional[dict] = None,
                     extra_fn=None) -> None:
        """Conflict-safe state write (cluster/client.py
        update_with_conflict_retry): the operator bumps restart counters
        and gang shapes on the SAME object concurrently — a stale-read
        write here must re-read and re-apply, never clobber.
        ``extra_fn(fresh_obj) -> annotation updates`` computes values
        that depend on the object's CURRENT state (preempt counts,
        resize histories) per attempt, so a retry never replays a stale
        read. Write-on-change: an object already in the desired state is
        left untouched (no MODIFIED event, no reconcile loop)."""

        def _mutate(obj: dict) -> Optional[dict]:
            updates: dict = {SCHED_STATE_ANNOTATION: state,
                             SCHED_REASON_ANNOTATION: reason,
                             **(extra or {})}
            if extra_fn is not None:
                updates.update(extra_fn(obj))
            # kube null-delete semantics: a removed binding writes None
            updates[BINDING_ANNOTATION] = (
                json.dumps(binding.to_dict())
                if binding is not None else None)
            anns = k8s.annotations_of(obj)
            dirty = any(
                (value is None and key in anns)
                or (value is not None and anns.get(key) != value)
                for key, value in updates.items())
            return apply_annotations(obj, updates) if dirty else None

        try:
            update_with_conflict_retry(client, *k8s.key_of(manifest),
                                       _mutate)
        except NotFoundError:
            pass   # deleted mid-pass: the delete event re-plans anyway

    def _clear_suspect(self, client: KubeClient, manifest: dict) -> None:
        def _mutate(obj: dict) -> Optional[dict]:
            if SUSPECT_ANNOTATION not in k8s.annotations_of(obj):
                return None   # already cleared by a concurrent pass
            return apply_annotations(obj, {SUSPECT_ANNOTATION: None})
        try:
            update_with_conflict_retry(client, *k8s.key_of(manifest),
                                       _mutate)
        except NotFoundError:
            pass   # deleted mid-pass: nothing left to clear

    def _mark_queued(self, client: KubeClient, manifest: dict,
                     reason: str) -> None:
        anns = k8s.annotations_of(manifest)
        if anns.get(SCHED_STATE_ANNOTATION) in (STATE_QUEUED,
                                                STATE_PREEMPTED) and \
                anns.get(SCHED_REASON_ANNOTATION) == reason:
            return  # idempotent: no write, no MODIFIED event, no loop
        state = STATE_PREEMPTED \
            if anns.get(SCHED_STATE_ANNOTATION) == STATE_PREEMPTED \
            else STATE_QUEUED
        self._patch_state(client, manifest, state, reason, binding=None)

    @staticmethod
    def _history_json(manifest: dict, from_chips: int, to_chips: int,
                      reason: str, now: float) -> str:
        """The updated resize-history annotation value: prior entries
        (malformed → dropped) plus this resize, capped at
        RESIZE_HISTORY_MAX, newest last."""
        hist = resize_history(manifest)
        hist.append({"time": round(now, 3), "fromChips": from_chips,
                     "toChips": to_chips, "reason": reason})
        return json.dumps(hist[-RESIZE_HISTORY_MAX:])

    def _count_resize(self, manifest: dict, from_chips: int,
                      to_chips: int, reason: str) -> None:
        direction = "grow" if to_chips > from_chips else \
            "shrink" if to_chips < from_chips else "migrate"
        obsreg.counter(
            "kftpu_sched_resizes_total",
            "elastic gang resizes applied (binding rewritten; the "
            "operator executes a checkpointed restart at the new "
            "shape)", labels=("direction",)).labels(
                direction=direction).inc()
        self._trace_event(manifest, "resized", direction=direction,
                          from_chips=from_chips, to_chips=to_chips,
                          reason=reason)

    def _apply_resize(self, client: KubeClient, manifest: dict,
                      old: Optional[Placement], new_placement: Placement,
                      reason: str) -> None:
        """Rewrite a bound gang's binding to the resized placement. The
        operator sees the binding's shape diverge from the running
        gang's and restarts it through the graceful GangResized path
        (SIGTERM → forced checkpoint → exit 75 → recreate at the new
        shape with resumeFrom) — a resize never burns backoff budget
        and never loses work past the forced save."""
        now = time.time()
        from_chips = old.chips if old is not None else 0
        self._patch_state(
            client, manifest, STATE_BOUND, f"resized: {reason}",
            binding=new_placement,
            # history APPENDS, so it must be computed from the object
            # as-written: a retry against a concurrently-updated history
            # re-reads and re-appends instead of dropping entries
            extra_fn=lambda obj: {
                RESIZE_HISTORY_ANNOTATION: self._history_json(
                    obj, from_chips, new_placement.chips, reason, now)})
        # counted AFTER the patch succeeded (the pass-wide invariant)
        self._count_resize(manifest, from_chips, new_placement.chips,
                           reason)
        log.info("scheduler: resized %s/%s %d -> %d chips (%s)",
                 k8s.namespace_of(manifest, "default"),
                 k8s.name_of(manifest), from_chips, new_placement.chips,
                 reason)

    def _apply_preempt(self, client: KubeClient, manifest: dict) -> None:
        """Unbind a victim: the operator observes the missing binding and
        tears the gang down through the graceful path, leaving the job
        QUEUED with resumeFrom set — preemption is a requeue, never a
        failure (no backoff budget burned). The count increments off the
        FRESH read per attempt (extra_fn), so a concurrent writer can
        never make one preemption read as zero or two."""
        self._patch_state(
            client, manifest, STATE_PREEMPTED,
            "preempted by a higher-priority job", binding=None,
            extra_fn=lambda obj: {
                PREEMPTED_COUNT_ANNOTATION: str(int(
                    k8s.annotations_of(obj).get(
                        PREEMPTED_COUNT_ANNOTATION, "0")) + 1)})
