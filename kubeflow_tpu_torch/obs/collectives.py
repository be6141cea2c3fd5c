"""The comm profile of one train step: per-collective link accounting.

The port of ``kubeflow_tpu/obs/collectives.py``. The JAX package walks
its compiled step's HLO; the port has no HLO, so the profile is built
from the calls the step makes: while a step is profiled,
``parallel/collectives.py`` ``recording()`` keeps one entry per call (its
op, bytes, tensor shape, group ranks, peer and phase), and
:func:`profile_calls` turns the entries into the reference's
:class:`CommProfile`, with the reference's classification, schema,
gauges and full-reshard verdict.

- **Ops** map onto the HLO vocabulary: ``all_reduce`` → all-reduce,
  ``reduce_scatter`` → reduce-scatter, ``all_gather`` → all-gather,
  ``send``/``recv`` (the pipeline's and the ring's ``ppermute`` hops) →
  collective-permute, and ``broadcast`` (the initial state, never inside
  a step) → all-gather, whose ring load it shares.
- **Payloads** follow the HLO conventions the formulas expect: an
  all-reduce's tensor, an all-gather's gathered result (the block times
  the group), a reduce-scatter's scattered result (the input over the
  group; the classification multiplies it back), a hop's message.
- **Participants** are global ranks, row-major over the mesh axes
  (parallel/mesh.py), and the slices are contiguous blocks of them
  (:func:`slice_assignment`), as the DCN-major mesh order makes them.
- **Wire bytes per participant**, from the reference's formulas:
  ``_ring_factor``, the hierarchical ICI/DCN split of ``_classify_op``,
  a permute's crossing fraction. The profile is one rank's view, so a
  send carries its message and a receive, the other end of a peer's
  send, carries no wire bytes of its own.
- **Phases** are set by the caller (``collectives.phase``): "update"
  around the optimizer update and the ZeRO-2 param gather, "pipeline"
  around the stage hops, "model" otherwise.

Link names stay the reference's, because the gauges and the dashboard
read them: ``ici`` is within a slice (NVLink between H100s), ``dcn``
across slices (the network between hosts). The modeled-seconds rates
are the H100's datasheet figures, not measurements: 450 GB/s a direction
for NVLink 4 on the H100 SXM, and 50 GB/s for one 400 Gb/s NDR
InfiniBand port a GPU. Both are overridden by the reference's env knobs.

Stdlib only: the dashboard and the operator read profiles without
torch.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

COLLECTIVE_OPS = (
    "all-reduce",
    "reduce-scatter",
    "all-gather",
    "all-to-all",
    "collective-permute",
)

# link classes
LINK_ICI = "ici"      # every participant pair inside one slice (NVLink)
LINK_DCN = "dcn"      # at least one group/pair crosses a slice boundary
LINK_LOCAL = "local"  # degenerate single-participant groups: no traffic

# bandwidth-model knobs (GB/s): the H100 SXM's datasheet rates, not
# measurements — NVLink 4 is 900 GB/s a GPU both directions together
# (450 a direction); one 400 Gb/s NDR port a GPU is 50 GB/s
ICI_GBPS_ENV = "KFTPU_COMM_ICI_GBPS"
DCN_GBPS_ENV = "KFTPU_COMM_DCN_GBPS"
DEFAULT_ICI_GBPS = 450.0
DEFAULT_DCN_GBPS = 50.0

# worker wiring: profile mode (env) and the span the profile lands under
COMM_PROFILE_ENV = "KFTPU_COMM_PROFILE"   # "auto" (default) | "0"
COMM_PROFILE_SPAN = "comm-profile"
# ops carried verbatim on the span (largest first)
COMM_TOP_OPS_ENV = "KFTPU_COMM_TOP_OPS"

# op phases (the by-(link, op) table's per-row breakdown)
PHASE_MODEL = "model"        # forward/backward
PHASE_UPDATE = "update"      # optimizer update / param re-gather
PHASE_PIPELINE = "pipeline"  # deliberate stage send/recv

# parallel/collectives.py op -> the HLO vocabulary
OP_KIND = {"all_reduce": "all-reduce", "reduce_scatter": "reduce-scatter",
           "all_gather": "all-gather", "broadcast": "all-gather",
           "send": "collective-permute", "recv": "collective-permute"}


@dataclass
class CollectiveOp:
    """One collective call, with its modeled per-step link traffic; the
    fields the reference's classification reads keep its names."""

    name: str                 # "<port op>.<index in the step>"
    kind: str                 # one of COLLECTIVE_OPS
    payload_bytes: int = 0    # modeled logical payload (module docstring)
    groups: Optional[list] = None           # [the group's ranks]
    pairs: Optional[list] = None            # collective-permute pairs
    op_name: str = ""         # the parallel/collectives.py op
    phase: str = PHASE_MODEL
    # (dtype, dims) of the tensor handed over: a 0-d one is a scalar
    result_shapes: list = field(default_factory=list)
    sends: bool = True        # False: a receive (no wire bytes of its own)
    # filled by classification
    link: str = LINK_LOCAL
    slices_spanned: int = 1
    group_size: int = 1
    dcn_bytes: float = 0.0
    ici_bytes: float = 0.0
    axes: tuple = ()          # mesh axes the group varies over (if known)

    @property
    def in_update_region(self) -> bool:
        return self.phase == PHASE_UPDATE

    def to_dict(self) -> dict:
        return {
            "name": self.name, "kind": self.kind, "link": self.link,
            "phase": self.phase,
            "payloadBytes": int(self.payload_bytes),
            "dcnBytes": round(self.dcn_bytes, 1),
            "iciBytes": round(self.ici_bytes, 1),
            "groupSize": self.group_size,
            "slicesSpanned": self.slices_spanned,
            "axes": list(self.axes),
            "opName": self.op_name, "sourceFile": "",
            "sourceLine": 0,
            "updateRegion": self.in_update_region,
        }


# ---------------------------------------------------------------------------
# classification


def slice_assignment(world: int, num_slices: int) -> list[int]:
    """Global rank → slice id: contiguous blocks of ``world //
    num_slices`` ranks, the DCN-major order of the reference's
    ``slice_assignment`` over virtual devices."""
    per_slice = max(1, world // max(1, num_slices))
    return [r // per_slice for r in range(world)]


def _axes_of_group(group: list, mesh_axes) -> tuple:
    """Mesh axes the group's members vary over (mesh_axes = ordered
    (name, size) pairs; participant id = row-major position)."""
    if not mesh_axes or len(group) < 2:
        return ()
    names = [a for a, _ in mesh_axes]
    sizes = [s for _, s in mesh_axes]
    coords = []
    for p in group:
        c, rem = [], p
        for s in reversed(sizes):
            c.append(rem % s)
            rem //= s
        coords.append(list(reversed(c)))
    varying = []
    for i, name in enumerate(names):
        if len({c[i] for c in coords}) > 1:
            varying.append(name)
    return tuple(varying)


def _ring_factor(kind: str) -> float:
    return 2.0 if kind == "all-reduce" else 1.0


def _classify_op(op: CollectiveOp, slice_of: Sequence[int],
                 mesh_axes=None) -> None:
    n_total = len(slice_of)
    if op.kind == "collective-permute" and op.pairs is not None:
        # a pair id beyond the slice map (wrong world passed) is skipped
        valid = [(s, t) for s, t in op.pairs
                 if 0 <= s < n_total and 0 <= t < n_total]
        real = [(s, t) for s, t in valid if s != t]
        crossing = [(s, t) for s, t in real
                    if slice_of[s] != slice_of[t]]
        op.group_size = len(op.pairs)
        op.slices_spanned = len({slice_of[s] for s, _ in valid}
                                | {slice_of[t] for _, t in valid}) \
            if valid else 1
        if not real:
            op.link = LINK_LOCAL
            return
        frac_dcn = len(crossing) / len(real)
        op.link = LINK_DCN if crossing else LINK_ICI
        op.dcn_bytes = op.payload_bytes * frac_dcn
        op.ici_bytes = op.payload_bytes * (1.0 - frac_dcn)
        return
    groups = op.groups
    if not groups or not any(groups):
        # no group = one group of every participant
        groups = [list(range(n_total))]
    g0 = max(groups, key=len)
    n = len(g0)
    op.group_size = n
    if mesh_axes:
        op.axes = _axes_of_group(g0, mesh_axes)
    if n <= 1:
        op.link = LINK_LOCAL
        op.slices_spanned = 1
        return
    k = len({slice_of[p] for p in g0 if 0 <= p < n_total}) or 1
    op.slices_spanned = k
    n_local = max(1, n // k)
    f = _ring_factor(op.kind)
    # full logical payload: a reduce-scatter's payload is its scattered
    # RESULT, so the pre-scatter input is result x group size
    full = op.payload_bytes * (n if op.kind == "reduce-scatter" else 1)
    op.link = LINK_DCN if k > 1 else LINK_ICI
    if k > 1:
        op.dcn_bytes = f * full * (k - 1) / k
    if n_local > 1:
        op.ici_bytes = f * full * (n_local - 1) / n_local


@dataclass
class CommProfile:
    """Per-step communication profile of one train step."""

    ops: list                   # list[CollectiveOp], classified
    num_slices: int
    ici_gbps: float
    dcn_gbps: float

    @property
    def dcn_bytes_per_step(self) -> float:
        return sum(o.dcn_bytes for o in self.ops)

    @property
    def ici_bytes_per_step(self) -> float:
        return sum(o.ici_bytes for o in self.ops)

    def collectives(self, link: str) -> int:
        return sum(1 for o in self.ops if o.link == link)

    def by_link_op(self) -> dict:
        """{(link, kind): {"count", "bytes", "phases"}}, the gauge label
        space: counts bucket each op under its link class; bytes bucket
        each op's ICI-phase bytes under (ici, kind) and its DCN-phase
        bytes under (dcn, kind), so the per-link sums reconcile with
        ``ici_bytes_per_step`` / ``dcn_bytes_per_step`` (a DCN row may
        carry a zero-count ici sibling row); ``phases`` breaks the count
        down by op phase."""
        out: dict = {}

        def row(link, kind):
            return out.setdefault((link, kind),
                                  {"count": 0, "bytes": 0.0,
                                   "phases": {}})

        for o in self.ops:
            r = row(o.link, o.kind)
            r["count"] += 1
            r["phases"][o.phase] = r["phases"].get(o.phase, 0) + 1
            if o.dcn_bytes:
                row(LINK_DCN, o.kind)["bytes"] += o.dcn_bytes
            if o.ici_bytes:
                row(LINK_ICI, o.kind)["bytes"] += o.ici_bytes
        return out

    @property
    def modeled_ici_seconds(self) -> float:
        return self.ici_bytes_per_step / (self.ici_gbps * 1e9)

    @property
    def modeled_dcn_seconds(self) -> float:
        return self.dcn_bytes_per_step / (self.dcn_gbps * 1e9)

    def to_dict(self, top_ops: Optional[int] = None) -> dict:
        if top_ops is None:
            try:
                top_ops = int(os.environ.get(COMM_TOP_OPS_ENV, "16"))
            except ValueError:
                top_ops = 16
        verdict = detect_full_reshard(self)
        ranked = sorted(self.ops,
                        key=lambda o: o.dcn_bytes + o.ici_bytes,
                        reverse=True)
        return {
            "numSlices": self.num_slices,
            "dcnBytesPerStep": round(self.dcn_bytes_per_step, 1),
            "iciBytesPerStep": round(self.ici_bytes_per_step, 1),
            "collectivesPerStep": {
                link: self.collectives(link)
                for link in (LINK_DCN, LINK_ICI, LINK_LOCAL)},
            "byLinkOp": {f"{link}/{kind}": {
                "count": row["count"], "bytes": round(row["bytes"], 1),
                "phases": dict(sorted(row["phases"].items()))}
                for (link, kind), row in sorted(self.by_link_op().items())},
            "modeledSeconds": {
                "ici": self.modeled_ici_seconds,
                "dcn": self.modeled_dcn_seconds,
                "total": self.modeled_ici_seconds +
                self.modeled_dcn_seconds,
            },
            "bandwidthGBps": {"ici": self.ici_gbps, "dcn": self.dcn_gbps},
            "dcnFullReshard": verdict.to_dict(),
            "topOps": [o.to_dict() for o in ranked[:max(0, top_ops)]],
            "totalOps": len(self.ops),
        }


def _bw(env: str, default: float) -> float:
    """A positive finite rate from the env, else the default (warned):
    a typo'd knob costs a warning and the default model, never the
    training job."""
    raw = os.environ.get(env)
    if not raw:
        return default
    try:
        v = float(raw)
        if v > 0 and math.isfinite(v):
            return v
    except ValueError:
        pass
    import logging
    logging.getLogger(__name__).warning(
        "%s=%r is not a positive number; modeling at the default "
        "%g GB/s", env, raw, default)
    return default


def call_op(i: int, entry) -> CollectiveOp:
    """One ``parallel/collectives.py`` ``CallRecord`` as an unclassified
    :class:`CollectiveOp` (the payload conventions of the module
    docstring)."""
    n = len(entry.ranks)
    payload = entry.nbytes
    if entry.op == "all_gather":
        payload *= n
    elif entry.op == "reduce_scatter":
        payload //= max(1, n)
    pairs = None
    if entry.op == "send":
        pairs = [(entry.rank, entry.peer)]
    elif entry.op == "recv":
        pairs = [(entry.peer, entry.rank)]
    return CollectiveOp(
        name=f"{entry.op}.{i}", kind=OP_KIND[entry.op],
        payload_bytes=payload, groups=[list(entry.ranks)], pairs=pairs,
        op_name=entry.op, phase=entry.phase,
        result_shapes=[("", tuple(entry.shape))],
        sends=entry.op != "recv")


def profile_calls(entries: Sequence, world: int, num_slices: int,
                  mesh_axes=None, ici_gbps: Optional[float] = None,
                  dcn_gbps: Optional[float] = None) -> CommProfile:
    """Classify one step's recorded calls (``collectives.recording()``
    entries) over ``world`` ranks in ``num_slices`` slices; ``mesh_axes``
    (ordered (name, size) pairs, optional) labels each group with the
    axes it spans."""
    slice_of = slice_assignment(world, num_slices)
    ops = []
    for i, entry in enumerate(entries):
        op = call_op(i, entry)
        _classify_op(op, slice_of, mesh_axes)
        if not op.sends:
            op.dcn_bytes = op.ici_bytes = 0.0
        ops.append(op)
    return CommProfile(
        ops=ops, num_slices=len(set(slice_of)) or 1,
        ici_gbps=ici_gbps if ici_gbps else _bw(ICI_GBPS_ENV,
                                               DEFAULT_ICI_GBPS),
        dcn_gbps=dcn_gbps if dcn_gbps else _bw(DCN_GBPS_ENV,
                                               DEFAULT_DCN_GBPS))


# ---------------------------------------------------------------------------
# worker metric export


class CommSeries:
    """Handle over the ``kftpu_comm_*`` series one profile exported, so
    the worker can prune them at teardown: the labeled per-(link, op)
    series are removed, the unlabeled detector flag resets to 0."""

    def __init__(self, bytes_fam, coll_fam, flag_fam, label_sets):
        self._bytes = bytes_fam
        self._coll = coll_fam
        self._flag = flag_fam
        self._label_sets = label_sets

    def prune(self) -> None:
        for kv in self._label_sets:
            self._bytes.remove(**kv)
            self._coll.remove(**kv)
        self._label_sets = []
        self._flag.set(0)


def export_comm_metrics(profile: CommProfile) -> CommSeries:
    """Export one profile as worker gauges:
    ``kftpu_comm_bytes_per_step{link,op}``,
    ``kftpu_comm_collectives_per_step{link,op}``, and
    ``kftpu_comm_dcn_full_reshard`` (0/1)."""
    from . import registry as obsreg
    bytes_fam = obsreg.gauge(
        "kftpu_comm_bytes_per_step",
        "modeled per-step collective bytes of the train step's calls, by "
        "link class and op kind (obs/collectives.py)",
        labels=("link", "op"))
    coll_fam = obsreg.gauge(
        "kftpu_comm_collectives_per_step",
        "collective calls per train step, by link class and op kind",
        labels=("link", "op"))
    flag_fam = obsreg.gauge(
        "kftpu_comm_dcn_full_reshard",
        "1 when the step gathers or permutes across the slice boundary "
        "outside the update and the pipeline hops")
    label_sets = []
    for (link, kind), row in profile.by_link_op().items():
        kv = {"link": link, "op": kind}
        bytes_fam.labels(**kv).set(row["bytes"])
        coll_fam.labels(**kv).set(row["count"])
        label_sets.append(kv)
    flag_fam.set(1 if detect_full_reshard(profile).flagged else 0)
    return CommSeries(bytes_fam, coll_fam, flag_fam, label_sets)


# ---------------------------------------------------------------------------
# the full-reshard detector


@dataclass
class ReshardVerdict:
    """Structured full-reshard verdict."""

    flagged: bool
    ops: list = field(default_factory=list)     # offending op dicts
    reason: str = ""

    def to_dict(self) -> dict:
        return {"flagged": self.flagged, "reason": self.reason,
                "ops": self.ops}


def detect_full_reshard(profile: CommProfile) -> ReshardVerdict:
    """The reference's rule: a DCN-crossing all-gather or
    collective-permute in the model phase (outside the update and the
    pipeline hops) is a re-layout paying the slow link every step;
    gradient reductions, the ZeRO-2 param gather (update phase) and the
    stage hops (pipeline phase) never match."""
    offenders = [
        op for op in profile.ops
        if op.link == LINK_DCN
        and op.kind in ("all-gather", "collective-permute")
        and op.phase == PHASE_MODEL
    ]
    if not offenders:
        return ReshardVerdict(
            flagged=False,
            reason="no DCN-crossing reshard outside the weight-update "
                   "region")
    total = sum(op.dcn_bytes for op in offenders)
    return ReshardVerdict(
        flagged=True,
        ops=[op.to_dict() for op in offenders],
        reason=f"{len(offenders)} DCN-crossing reshard collective(s) in "
               f"the model forward/backward ({total:.0f} modeled DCN "
               f"bytes/step)")


# ---------------------------------------------------------------------------
# the optimizer-update yardstick (the ZeRO-2 decomposition)


def modeled_update_dcn_bytes(profile: CommProfile) -> dict:
    """Modeled optimizer-update DCN bytes/step, the reference's
    yardstick: total wire bytes are conserved between the replicated and
    the sharded update (reduce-scatter + all-gather ≡ all-reduce on the
    wire), so this isolates the phase each owns — the replicated update
    the gradient all-reduce at its factor-2 ring cost, ``2*G*(k-1)/k``;
    the sharded (ZeRO-2) update only the final param gather,
    ``G*(k-1)/k``. The calls are logical already (no split gathers to
    merge, as the HLO has)."""
    sharded_ops = [op for op in profile.ops
                   if op.kind == "reduce-scatter"
                   or (op.kind == "all-gather" and op.in_update_region)]
    if sharded_ops:
        gathers = [op for op in profile.ops
                   if op.kind == "all-gather" and op.in_update_region]
        bytes_ = sum(op.payload_bytes * (op.slices_spanned - 1)
                     / op.slices_spanned
                     for op in gathers if op.slices_spanned > 1)
        param_bytes = sum(op.payload_bytes for op in gathers)
        return {"style": "sharded", "bytes": bytes_,
                "paramBytes": param_bytes}
    ars = [op for op in profile.ops
           if op.kind == "all-reduce"
           and any(dims for _, dims in op.result_shapes)]
    bytes_ = sum(2.0 * op.payload_bytes * (op.slices_spanned - 1)
                 / op.slices_spanned
                 for op in ars if op.slices_spanned > 1)
    return {"style": "replicated", "bytes": bytes_,
            "paramBytes": sum(op.payload_bytes for op in ars)}
