"""The port's comm profile (obs/collectives.py) against the JAX package's
HLO comm analyzer (``kubeflow_tpu/obs/collectives.py``,
``tests/test_comm.py``).

- The classification: for the same (op, payload, group, slice map), the
  port's link, slices spanned, group size, axes and ICI/DCN bytes equal
  the JAX ``_classify_op``'s, for every op kind, hierarchical groups and
  permutes; a receive carries no wire bytes of its own.
- The schema: ``CommProfile.to_dict()`` and each op's dict have the
  reference's keys; the gauges, the recorder's modeled split and the
  update-phase yardstick follow the reference.
- The worker on two gloo ranks with ``KFTPU_NUM_SLICES=2`` (one rank a
  slice): rank 0 alone emits one ``comm-profile`` span per run; the data-
  parallel all-reduce lands on ``dcn``; the profile's calls and bytes by
  op equal ``parallel/collectives.py``'s counters over the same step;
  the ZeRO-2 run's gradient and param wire bytes equal the replicated
  run's (reduce-scatter + all-gather ≡ all-reduce); the JAX dashboard's
  ``GET /api/obs/comm/{ns}/{name}`` serves the port-written profile.
- ``KFTPU_COMM_PROFILE=0`` emits no span.
"""

import json
import os

import pytest
import torch

from kubeflow_tpu_torch.models import transformer as T
from kubeflow_tpu_torch.obs import collectives as C
from kubeflow_tpu_torch.obs.trace import load_spans
from kubeflow_tpu_torch.parallel.collectives import CallRecord
from kubeflow_tpu_torch.runtime import bootstrap, worker

TINY = dict(vocab_size=64, num_layers=2, embed_dim=16, num_heads=2,
            head_dim=8, mlp_dim=32, max_seq_len=16)
TRACE_ID = "comm-trace"


def _jax_op(kind, payload, groups=None, pairs=None):
    from kubeflow_tpu.obs import collectives as J
    return J.CollectiveOp(name="x", kind=kind, is_async_start=False,
                          payload_bytes=payload, groups=groups, pairs=pairs)


CASES = [
    # (kind, payload, groups, pairs, slice map)
    ("all-reduce", 4096, [[0, 1, 2, 3]], None, [0, 0, 1, 1]),
    ("all-reduce", 4096, [[0, 1]], None, [0, 0, 1, 1]),
    ("all-reduce", 4096, [[0, 2]], None, [0, 0, 1, 1]),
    ("reduce-scatter", 1024, [[0, 1, 2, 3]], None, [0, 0, 1, 1]),
    ("all-gather", 4096, [[0, 1, 2, 3, 4, 5, 6, 7]], None,
     [0, 0, 0, 0, 1, 1, 1, 1]),
    ("all-gather", 4096, [[3]], None, [0, 0, 1, 1]),
    ("all-to-all", 4096, [[0, 1, 2, 3]], None, [0, 1, 2, 3]),
    ("collective-permute", 512, None, [(0, 1)], [0, 0, 1, 1]),
    ("collective-permute", 512, None, [(1, 2)], [0, 0, 1, 1]),
    ("collective-permute", 512, None, [(0, 1), (1, 2), (2, 3), (3, 0)],
     [0, 0, 1, 1]),
    ("collective-permute", 512, None, [(2, 2)], [0, 0, 1, 1]),
]
AXES = [("data", 2), ("tensor", 2)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_classification_equals_the_references(case):
    from kubeflow_tpu.obs import collectives as J
    kind, payload, groups, pairs, slice_of = CASES[case]
    want = _jax_op(kind, payload, groups, pairs)
    J._classify_op(want, slice_of, AXES)
    got = C.CollectiveOp(name="x", kind=kind, payload_bytes=payload,
                         groups=groups, pairs=pairs)
    C._classify_op(got, slice_of, AXES)
    for f in ("link", "slices_spanned", "group_size", "dcn_bytes",
              "ici_bytes", "axes"):
        assert getattr(got, f) == getattr(want, f), f


def _rec(op, nbytes, ranks, rank=0, peer=None, phase="model", shape=(8,)):
    return CallRecord(op=op, nbytes=nbytes, shape=shape, ranks=tuple(ranks),
                      rank=rank, peer=peer, phase=phase)


def test_calls_take_the_hlo_payload_conventions():
    """A call's bytes become the payload the reference's formulas read:
    an all-gather's whole result, a reduce-scatter's scattered result, a
    hop's message; a receive carries no wire bytes."""
    entries = [_rec("all_reduce", 400, [0, 1, 2, 3]),
               _rec("all_gather", 100, [0, 1, 2, 3], phase="update"),
               _rec("reduce_scatter", 400, [0, 1, 2, 3]),
               _rec("send", 64, [0, 1, 2, 3], peer=2, phase="pipeline"),
               _rec("recv", 64, [0, 1, 2, 3], peer=3, phase="pipeline"),
               _rec("broadcast", 400, [0, 1, 2, 3], phase="update")]
    prof = C.profile_calls(entries, world=4, num_slices=2,
                           mesh_axes=[("data", 4)])
    ar, ag, rs, snd, rcv, bc = prof.ops
    assert [o.kind for o in prof.ops] == [
        "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
        "collective-permute", "all-gather"]
    assert (ar.payload_bytes, ag.payload_bytes, rs.payload_bytes) == \
        (400, 400, 100)
    # 2 slices of 2: a DCN phase over 2 and an ICI phase over 2
    assert (ar.dcn_bytes, ar.ici_bytes) == (400.0, 400.0)
    assert (ag.dcn_bytes, rs.dcn_bytes, bc.dcn_bytes) == (200.0,) * 3
    assert snd.link == C.LINK_DCN and snd.dcn_bytes == 64
    assert rcv.link == C.LINK_DCN and rcv.dcn_bytes == rcv.ici_bytes == 0
    assert ar.axes == ("data",)
    # reduce-scatter + all-gather moves what one all-reduce moves
    assert rs.dcn_bytes + ag.dcn_bytes == ar.dcn_bytes
    assert not C.detect_full_reshard(prof).flagged   # update + pipeline
    assert C.modeled_update_dcn_bytes(prof)["style"] == "sharded"


def test_schema_gauges_and_recorder_follow_the_reference():
    from kubeflow_tpu.obs import collectives as J
    from kubeflow_tpu_torch.obs import registry as obsreg
    from kubeflow_tpu_torch.runtime.metrics import FlightRecorder
    hlo = ('HloModule m\n\nENTRY %main {\n'
           '  %ar = f32[1000]{0} all-reduce(f32[1000]{0} %g), '
           'replica_groups=[1,8]<=[8], to_apply=%sum\n'
           '  %ag = f32[64]{0} all-gather(f32[8]{0} %p), '
           'replica_groups=[1,8]<=[8], dimensions={0}\n}\n')
    want = J.analyze_hlo(hlo, [0, 0, 0, 0, 1, 1, 1, 1]).to_dict()
    prof = C.profile_calls([_rec("all_reduce", 4000, range(8)),
                            _rec("all_gather", 32, range(8))],
                           world=8, num_slices=2)
    got = prof.to_dict()
    assert set(got) == set(want)
    assert set(got["topOps"][0]) == set(want["topOps"][0])
    assert set(got["byLinkOp"]) == set(want["byLinkOp"])
    for k in ("dcnBytesPerStep", "iciBytesPerStep", "collectivesPerStep"):
        assert got[k] == want[k], k
    # a model-phase all-gather across slices is the reference's red flag
    assert got["dcnFullReshard"]["flagged"] is \
        want["dcnFullReshard"]["flagged"] is True
    assert got["bandwidthGBps"] == {"ici": 450.0, "dcn": 50.0}
    series = C.export_comm_metrics(prof)
    text = obsreg.default_registry().render()
    assert 'kftpu_comm_collectives_per_step{link="dcn",op="all-reduce"} 1' \
        in text
    assert "kftpu_comm_dcn_full_reshard 1" in text
    series.prune()
    text = obsreg.default_registry().render()
    assert 'link="dcn"' not in text and "kftpu_comm_dcn_full_reshard 0" \
        in text
    rec = FlightRecorder(windows=4)
    rec.note_step(data_s=0.01)
    rec.close_window(1, 1, 0.1)
    assert "comm_ici_s" not in rec.snapshot()["records"][-1]
    rec.set_comm_model(0.002, 0.005)
    rec.note_step(data_s=0.01, dispatch_s=0.02)
    rec.note_step(data_s=0.01, dispatch_s=0.02)
    rec.close_window(3, 2, 0.2)
    win = rec.snapshot()["records"][-1]
    assert win["comm_ici_s"] == pytest.approx(0.004)
    assert win["comm_dcn_s"] == pytest.approx(0.010)
    # its own keyed field: the measured device_wait is not reduced by it
    assert win["device_wait_s"] == pytest.approx(0.2 - 0.06, abs=1e-6)
    assert prof.modeled_dcn_seconds == prof.dcn_bytes_per_step / 50e9


def test_bandwidth_knobs(monkeypatch, caplog):
    monkeypatch.setenv(C.DCN_GBPS_ENV, "6,25")
    monkeypatch.setenv(C.ICI_GBPS_ENV, "100")
    with caplog.at_level("WARNING", logger=C.__name__):
        prof = C.profile_calls([], world=1, num_slices=1)
    assert (prof.dcn_gbps, prof.ici_gbps) == (C.DEFAULT_DCN_GBPS, 100.0)
    assert any(C.DCN_GBPS_ENV in r.message for r in caplog.records)


# -- the worker on two gloo ranks ------------------------------------------------


def _comm_rank(rank, env, tmp):
    env = {**env, "KFTPU_NUM_SLICES": "2", "KFTPU_TRACE_ID": TRACE_ID,
           C.COMM_TOP_OPS_ENV: "100000"}
    os.environ.update(env)
    torch.set_num_threads(1)
    ctx = bootstrap.initialize(env, device="cpu")
    try:
        for mode in ("replicated", "sharded"):
            worker.train(ctx=ctx, workload="transformer",
                         workload_kwargs={"cfg": T.TransformerConfig(
                             dtype=torch.float32, **TINY)},
                         optimizer="adam", learning_rate=1e-2,
                         global_batch=4, steps=2, sync_every=1,
                         device="cpu", handle_sigterm=False,
                         weight_update=mode,
                         span_path=os.path.join(tmp, f"{mode}.jsonl"))
    finally:
        bootstrap.shutdown(ctx)
    return rank


def _wire(op: dict) -> float:
    return op["dcnBytes"] + op["iciBytes"]


def _call_bytes(op: dict) -> int:
    """The bytes the rank handed to the call (``bytes_moved``'s count),
    from the op's HLO-convention payload."""
    n = op["groupSize"]
    if op["kind"] == "all-gather":
        return op["payloadBytes"] // n
    return op["payloadBytes"] * (n if op["kind"] == "reduce-scatter" else 1)


def _bookkeeping(op: dict) -> bool:
    """The step's scalar exchanges beside the gradients and params (the
    norm's square sum, the metrics' mean, the ZeRO-2 replica check): at
    most 2 f32 values a rank."""
    return _call_bytes(op) <= 8


@pytest.fixture(scope="module")
def two_rank_spans(tmp_path_factory):
    from test_torch_bootstrap import spawn_contract
    tmp = str(tmp_path_factory.mktemp("comm"))
    spawn_contract(_comm_rank, 2, tmp)
    return {m: os.path.join(tmp, f"{m}.jsonl")
            for m in ("replicated", "sharded")}


def test_two_ranks_profile_on_rank_zero_dcn_and_conserved(two_rank_spans):
    profiles = {}
    for mode, path in two_rank_spans.items():
        spans = [s for s in load_spans(path)
                 if s["name"] == C.COMM_PROFILE_SPAN]
        assert len(spans) == 1, mode                  # rank 0 only
        attrs = spans[0]["attrs"]
        prof, measured = attrs["profile"], attrs["measured"]
        assert attrs["step"] == 1 and prof["numSlices"] == 2
        ops = prof["topOps"]
        assert len(ops) == prof["totalOps"] > 0
        # one rank a slice: every exchange crosses slices
        assert prof["collectivesPerStep"]["dcn"] == prof["totalOps"]
        assert prof["collectivesPerStep"]["ici"] == 0
        assert prof["iciBytesPerStep"] == 0
        assert prof["dcnFullReshard"]["flagged"] is False
        # the profile's calls and bytes by op are the counters'
        by_op: dict = {}
        for o in ops:
            calls, nbytes = by_op.get(o["opName"], (0, 0))
            by_op[o["opName"]] = (calls + 1, nbytes + _call_bytes(o))
        assert {k: v for k, v in measured["calls"].items() if v} == \
            {k: c for k, (c, _) in by_op.items()}
        assert {k: v for k, v in measured["bytes"].items() if v} == \
            {k: b for k, (_, b) in by_op.items()}
        assert measured["hostStaged"] == dict.fromkeys(measured["calls"], 0)
        profiles[mode] = prof
    rep, sh = profiles["replicated"], profiles["sharded"]
    assert "dcn/all-reduce" in rep["byLinkOp"]
    assert {o["kind"] for o in rep["topOps"] if not _bookkeeping(o)} == \
        {"all-reduce"}
    assert {"dcn/reduce-scatter", "dcn/all-gather"} <= set(sh["byLinkOp"])
    # reduce-scatter + all-gather moves what the all-reduce moves
    wire = {m: sum(_wire(o) for o in p["topOps"] if not _bookkeeping(o))
            for m, p in profiles.items()}
    assert wire["sharded"] == pytest.approx(wire["replicated"], rel=1e-9)
    assert wire["replicated"] > 0


def test_jax_dashboard_serves_the_port_profile(two_rank_spans, monkeypatch):
    from kubeflow_tpu.cluster.fake import FakeCluster
    from kubeflow_tpu.obs.trace import SPAN_PATH_ENV, TRACE_ID_ANNOTATION
    from kubeflow_tpu.webapps.dashboard import build_dashboard_app
    sink = two_rank_spans["sharded"]
    monkeypatch.setenv(SPAN_PATH_ENV, sink)
    cluster = FakeCluster()
    cluster.create({
        "apiVersion": "tpu.kubeflow.org/v1alpha1", "kind": "TPUJob",
        "metadata": {"name": "comm-job", "namespace": "kubeflow",
                     "uid": "uid-1",
                     "annotations": {TRACE_ID_ANNOTATION: TRACE_ID}},
        "spec": {"replicaSpecs": {"TPU": {
            "tpuTopology": "v5e-8",
            "template": {"spec": {"containers": [
                {"name": "jax", "image": "trainer:v1"}]}}}}}})
    status, body = build_dashboard_app(cluster).dispatch(
        "GET", "/api/obs/comm/kubeflow/comm-job", None)
    assert status == 200
    (span,) = [s for s in load_spans(sink)
               if s["name"] == C.COMM_PROFILE_SPAN]
    assert body["profile"] == span["attrs"]["profile"]
    assert body["step"] == 1 and body["profile"]["dcnBytesPerStep"] > 0


@pytest.mark.parametrize("mode", ["auto", "0"])
def test_profile_mode(tmp_path, monkeypatch, mode):
    monkeypatch.setenv(C.COMM_PROFILE_ENV, mode)
    monkeypatch.delenv("KFTPU_NUM_SLICES", raising=False)
    sink = str(tmp_path / "spans.jsonl")
    worker.train(workload="transformer", workload_kwargs={
        "cfg": T.TransformerConfig(dtype=torch.float32, **TINY)},
        optimizer="adam", global_batch=2, steps=2, device="cpu",
        handle_sigterm=False, span_path=sink)
    spans = [s for s in load_spans(sink) if s["name"] == C.COMM_PROFILE_SPAN]
    if mode == "0":
        assert spans == []
    else:
        # one process: no exchange to profile, and the span says so
        (span,) = spans
        assert span["attrs"]["profile"]["totalOps"] == 0
        json.dumps(span)
