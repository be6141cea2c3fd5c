"""Slice inventory: the cluster's GPUs as node rows.

The port's counterpart of ``kubeflow_tpu/scheduler/inventory.py``. The
JAX package models a TPU pool as the 2D ICI grid of one slice and cuts
contiguous rectangles out of it. On NVIDIA GPUs a slice is the GPUs of
one NVLink domain, which is one node (``api/topology.py``), so **a slice
never spans nodes**:

- A **pool** is the set of nodes carrying ``kubeflow.org/pool``
  (``POOL_LABEL``) whose ``nvidia.com/gpu.product`` label names a known
  generation. Each node is one ROW of ``gpus_per_node`` cells; row ``i``
  is host ``i`` (``health.host_cells``).
- An ``h100-N`` slice is a 1×N run inside one row, at an offset that is
  a multiple of N (aligned runs). On an HGX board every GPU reaches
  every other over NVSwitch, so alignment serves fragmentation only: the
  free runs left behind stay usable by every smaller slice size.
- A node that reports fewer allocatable ``nvidia.com/gpu`` than its
  generation has (the device plugin lost GPUs) gets its missing cells
  carved down, highest indexes first; NotReady and quarantined nodes
  are carved down whole, as are rows no node claims.

Placement scoring is fragmentation-first, as in the JAX package: among
all feasible runs (every pool, every row) the inventory picks the one
that leaves the LARGEST free aligned run behind, then best-fit (tightest
pool first), then warm-slot overlap, then lexicographic — the same
request sequence always produces the same packing.

Wire format: unchanged from the JAX package, one rect per slice with
``x`` the node row and ``h`` 1::

    {"topology": "h100-8", "numSlices": 1, "chips": 8,
     "slices": [{"pool": "pool-a", "x": 0, "y": 0, "h": 1, "w": 8}]}

Stdlib only, like the rest of the control plane.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

from ..api import k8s
from ..api.topology import GENERATIONS, GpuTopology, parse_topology
from ..cluster.fake import GPU_PRODUCT_LABEL, GPU_RESOURCE
from . import health

# node labels the inventory reads (cluster/fake.py add_gpu_nodes renders
# them; GPU feature discovery writes the product label)
POOL_LABEL = "kubeflow.org/pool"
HOSTNAME_LABEL = "kubernetes.io/hostname"

# sentinel owner for cells of unavailable GPUs (NotReady, quarantined or
# missing node, GPUs the device plugin no longer reports): carved out of
# placeable runs by carve_down(), never released by a job teardown
DOWN_OWNER = "\x00down"


def generation_of(node: dict):
    """The GpuGeneration whose product the node's label names, or None."""
    product = k8s.labels_of(node).get(GPU_PRODUCT_LABEL)
    for gen in GENERATIONS.values():
        if product == gen.product:
            return gen
    return None


@dataclass(frozen=True)
class SliceRect:
    """One slice's GPUs: a run of ``w`` cells in row ``x`` of a pool
    (``h`` is 1: a slice is GPUs of one node)."""

    pool: str
    x: int          # node row
    y: int          # first GPU
    h: int
    w: int

    @property
    def chips(self) -> int:
        return self.h * self.w

    def cells(self) -> Iterable[tuple[str, int, int]]:
        for i in range(self.x, self.x + self.h):
            for j in range(self.y, self.y + self.w):
                yield (self.pool, i, j)

    def to_dict(self) -> dict:
        return {"pool": self.pool, "x": self.x, "y": self.y,
                "h": self.h, "w": self.w}

    @classmethod
    def from_dict(cls, d: dict) -> "SliceRect":
        return cls(pool=d["pool"], x=int(d["x"]), y=int(d["y"]),
                   h=int(d["h"]), w=int(d["w"]))


@dataclass
class Placement:
    """A whole gang's assignment: one rect per slice (slices may land in
    different pools — data parallelism over the network does not need
    NVLink ACROSS slices, only within each)."""

    topology: str
    num_slices: int
    slices: list[SliceRect]
    # warm-pod slots this placement covers, stamped by the scheduler at
    # bind time ([{"pool": p, "host": i}] — scheduler/warmpool.py): the
    # operator adopts exactly these pre-initialized pods instead of
    # cold-creating. Advisory: absent/extra entries never invalidate a
    # binding (binding_matches ignores it).
    warm_hosts: list = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.warm_hosts is None:
            self.warm_hosts = []

    @property
    def chips(self) -> int:
        return sum(r.chips for r in self.slices)

    def to_dict(self) -> dict:
        d = {"topology": self.topology, "numSlices": self.num_slices,
             "chips": self.chips,
             "slices": [r.to_dict() for r in self.slices]}
        if self.warm_hosts:
            d["warmHosts"] = [dict(w) for w in self.warm_hosts]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Placement":
        warm = []
        for w in d.get("warmHosts", []) or []:
            if isinstance(w, dict) and "pool" in w and "host" in w:
                warm.append({"pool": str(w["pool"]),
                             "host": int(w["host"])})
        return cls(topology=d["topology"],
                   num_slices=int(d.get("numSlices", 1)),
                   slices=[SliceRect.from_dict(r)
                           for r in d.get("slices", [])],
                   warm_hosts=warm)


class PoolState:
    """Occupancy grid over one pool: ``rows`` nodes of the whole-node
    ``topology`` (``h100-8``), one cell a GPU."""

    def __init__(self, name: str, topology: GpuTopology, rows: int):
        self.name = name
        self.topology = topology
        self.rows, self.cols = rows, topology.num_gpus
        # owner key per cell ("" = free); owners are "ns/name" job keys
        self.grid: list[list[str]] = [[""] * self.cols
                                      for _ in range(rows)]

    @property
    def free_chips(self) -> int:
        return sum(1 for row in self.grid for c in row if not c)

    def fits(self, x: int, y: int, h: int, w: int) -> bool:
        if x < 0 or y < 0 or x + h > self.rows or y + w > self.cols:
            return False
        return all(not self.grid[i][j]
                   for i in range(x, x + h) for j in range(y, y + w))

    def occupy(self, owner: str, rect: SliceRect) -> None:
        for _, i, j in rect.cells():
            if self.grid[i][j]:
                raise ValueError(
                    f"pool {self.name} cell ({i},{j}) already owned by "
                    f"{self.grid[i][j]!r} (binding drift — rebuild the "
                    f"inventory from bindings before placing)")
            self.grid[i][j] = owner

    def release(self, owner: str) -> int:
        freed = 0
        for row in self.grid:
            for j, c in enumerate(row):
                if c == owner:
                    row[j] = ""
                    freed += 1
        return freed

    def max_free_rect(self) -> int:
        """GPUs of the largest free ALIGNED run in any row (a slice
        size of the generation at an offset that is a multiple of it) —
        the fragmentation score's numerator: the largest slice this pool
        can still take."""
        best = 0
        sizes = sorted(self.topology.generation.supported_gpu_counts,
                       reverse=True)
        for row in self.grid:
            for n in sizes:
                if n <= best:
                    break
                if any(not any(row[y:y + n])
                       for y in range(0, self.cols - n + 1, n)):
                    best = n
                    break
        return best


class SliceInventory:
    """All pools of the cluster; the scheduler's placement engine."""

    def __init__(self, pools: Optional[list[PoolState]] = None):
        self.pools: dict[str, PoolState] = {
            p.name: p for p in sorted(pools or [], key=lambda p: p.name)}
        # cells of unavailable GPUs (NotReady / quarantined / missing
        # node, GPUs not reported allocatable): carve_down() occupies the
        # still-free ones AFTER live bindings re-occupy, so a Ready flap
        # never invalidates a healthy gang's binding by itself
        self.down_cells: set = set()
        # node name -> that node's cells (suspect-evacuation lookups)
        self.cells_by_node: dict[str, set] = {}
        # (pool, row) -> node name (the operator pins a bound slice's
        # pods to its node)
        self.node_at: dict[tuple, str] = {}

    # -- construction -------------------------------------------------------

    @classmethod
    def from_nodes(cls, nodes: list[dict]) -> "SliceInventory":
        """Group nodes by pool label; each node of a known GPU product
        is one row. A node's row comes from its NAME (its trailing
        integer) when the pool's names parse consistently — distinct
        indexes, none past twice the node count — so a deleted middle
        node does not shift its neighbors' rows (their bindings stay
        valid; the gap is a down row). A pool whose names do not form
        such a set falls back to positional rows in natural name order
        for the WHOLE pool. A pool's generation is its first node's (in
        that order); a node of another product is left out of it."""
        by_pool: dict[str, list] = {}
        for node in nodes:
            pool = k8s.labels_of(node).get(POOL_LABEL)
            gen = generation_of(node)
            if not pool or gen is None:
                continue
            by_pool.setdefault(pool, []).append((node, gen))
        pools, down, by_node, node_at = [], set(), {}, {}
        for name, members in sorted(by_pool.items()):
            members.sort(key=lambda m: health.host_sort_key(
                k8s.name_of(m[0])))
            gen = members[0][1]
            members = [m for m in members if m[1] is gen]
            topo = parse_topology(f"{gen.name}-{gen.gpus_per_node}")
            idx = [health.host_name_index(k8s.name_of(n))
                   for n, _g in members]
            trusted = (all(i is not None for i in idx)
                       and len(set(idx)) == len(idx)
                       and max(idx) < 2 * len(idx))
            rows = idx if trusted else list(range(len(members)))
            state = PoolState(name, topo, max(rows) + 1)
            for (node, _g), row in zip(members, rows):
                node_name = k8s.name_of(node)
                cells = list(health.host_cells(name, topo, row))
                by_node[node_name] = set(cells)
                node_at[(name, row)] = node_name
                if not k8s.condition_true(node, "Ready") \
                        or health.is_quarantined(node):
                    down |= set(cells)
                    continue
                # GPUs the device plugin does not report: carve the
                # missing cells, highest indexes first
                alloc = (node.get("status", {}).get("allocatable")
                         or {}).get(GPU_RESOURCE, topo.num_gpus)
                have = max(0, min(topo.num_gpus,
                                  int(k8s.parse_quantity(alloc))))
                down |= set(cells[have:])
            # rows no node claims (deleted nodes): their GPUs are down
            for row in set(range(state.rows)) - set(rows):
                down |= set(health.host_cells(name, topo, row))
            pools.append(state)
        inv = cls(pools)
        inv.down_cells = down
        inv.cells_by_node = by_node
        inv.node_at = node_at
        return inv

    def carve_down(self) -> int:
        """Occupy every still-free down cell with the DOWN sentinel so
        placement scoring and run search both see them as unusable.
        Bindings over down cells were already rejected by
        valid_binding, so nothing live sits under the carve."""
        carved = 0
        for pool_name, x, y in self.down_cells:
            pool = self.pools.get(pool_name)
            if pool is None or x >= pool.rows or y >= pool.cols:
                continue
            if not pool.grid[x][y]:
                pool.grid[x][y] = DOWN_OWNER
                carved += 1
        return carved

    # -- accounting ---------------------------------------------------------

    @property
    def free_chips(self) -> int:
        return sum(p.free_chips for p in self.pools.values())

    def bind(self, owner: str, placement: Placement) -> None:
        for rect in placement.slices:
            pool = self.pools.get(rect.pool)
            if pool is None:
                raise ValueError(f"binding names unknown pool {rect.pool!r}")
            pool.occupy(owner, rect)

    def release(self, owner: str) -> int:
        return sum(p.release(owner) for p in self.pools.values())

    def valid_binding(self, placement: Placement) -> bool:
        """Whether a persisted binding still fits this inventory (pool
        exists, run inside one row) AND stays clear of down GPUs — a
        pool deleted, GPUs lost, or a node quarantined under a bound job
        must requeue it for a replan, not crash the pass or leave the
        gang pinned to GPUs that cannot run it."""
        for rect in placement.slices:
            pool = self.pools.get(rect.pool)
            if pool is None or rect.h != 1 or rect.x < 0 or rect.y < 0 \
                    or rect.x + rect.h > pool.rows \
                    or rect.y + rect.w > pool.cols:
                return False
            if self.down_cells and not \
                    self.down_cells.isdisjoint(rect.cells()):
                return False
        return True

    # -- placement ----------------------------------------------------------

    def _candidates(self, topo: GpuTopology,
                    avoid: Optional[set] = None,
                    prefer: Optional[set] = None
                    ) -> Iterable[tuple[tuple, SliceRect]]:
        """Every feasible run for ONE slice, with its score key (lower =
        better): the pool's largest free aligned run AFTER the cut
        (fragmentation), then best-fit (least free pool space), then
        warm-slot overlap (``prefer`` cells — a run covering a
        pre-initialized warm pod adopts it instead of cold-starting),
        then position."""
        n = topo.num_gpus
        for pname in sorted(self.pools):
            pool = self.pools[pname]
            if pool.topology.generation.name != topo.generation.name:
                continue
            for x in range(pool.rows):
                for y in range(0, pool.cols - n + 1, n):
                    if not pool.fits(x, y, 1, n):
                        continue
                    rect = SliceRect(pname, x, y, 1, n)
                    if avoid and not avoid.isdisjoint(rect.cells()):
                        continue
                    pool.occupy("\x00probe", rect)
                    after = pool.max_free_rect()
                    pool.release("\x00probe")
                    warm = len(prefer & set(rect.cells())) \
                        if prefer else 0
                    key = (-after, pool.free_chips, -warm, pname, x, y, 1)
                    yield key, rect

    def place_gang(self, topology: GpuTopology, num_slices: int,
                   avoid: Optional[set] = None,
                   prefer: Optional[set] = None) -> Optional[Placement]:
        """Greedy per-slice best placement for a whole gang, or None when
        any slice cannot be cut. ``avoid`` is a set of (pool, row, gpu)
        cells placements must not touch (the head-of-line reservation —
        scheduler/core.py). ``prefer`` cells tip otherwise-tied
        candidates (warm-pod slots — scheduler/warmpool.py). A GPU slice
        has one shape, a run in one row, so an elastic resize places like
        any other gang. The inventory is left UNCHANGED; callers bind()
        the returned placement explicitly."""
        rects: list[SliceRect] = []
        try:
            for _ in range(num_slices):
                best = min(self._candidates(topology, avoid,
                                            prefer=prefer),
                           key=lambda kr: kr[0], default=None)
                if best is None:
                    return None
                rect = best[1]
                self.pools[rect.pool].occupy("\x00tentative", rect)
                rects.append(rect)
        finally:
            for p in self.pools.values():
                p.release("\x00tentative")
        return Placement(topology=topology.name, num_slices=num_slices,
                         slices=rects)

    def reserve_for(self, topology: GpuTopology, num_slices: int,
                    avoid: Optional[set] = None) -> set:
        """The head-of-line reservation: a geometry-only placement
        (job occupancy ignored — those GPUs free when their gangs
        finish) whose cells backfill jobs must keep clear, so the blocked
        head's target region only ever DRAINS. Down cells DO carry into
        the ghost (a reservation on a dead node would never drain), as
        does the head's own ``avoid`` set. Empty set when the request
        can never fit this cluster (reserving would deadlock the queue
        behind an impossible job)."""
        ghost = SliceInventory(
            [PoolState(p.name, p.topology, p.rows)
             for p in self.pools.values()])
        for name, pool in self.pools.items():
            # mirror ONLY the down sentinel: those cells never drain
            ghost.pools[name].grid = [
                [c if c == DOWN_OWNER else "" for c in row]
                for row in pool.grid]
        placement = ghost.place_gang(topology, num_slices, avoid=avoid)
        if placement is None:
            return set()
        return {cell for rect in placement.slices for cell in rect.cells()}
