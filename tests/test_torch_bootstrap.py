"""The worker bootstrap: the topology-contract env → process group → mesh.

- Spawned CPU ranks given only the contract env (``KFTPU_TOPOLOGY``,
  ``KFTPU_COORDINATOR_ADDRESS``, ``KFTPU_NUM_PROCESSES``,
  ``KFTPU_PROCESS_ID``, ``KFTPU_SHARDING``) come up as one gloo group with
  the rank, world, device and sharding the contract names, and
  ``shutdown`` destroys the group.
- An axis in ``UNPORTED_AXES`` raises, citing its ROADMAP item, and
  leaves no group behind; every axis builds, sequence from the contract
  env included.
- ``strict`` with a device-count mismatch raises; without it the
  sharding is refit. A CUDA contract with no card raises before joining.
- The port's copies of ``TopologyContract``'s env, ``ShardingSpec`` and
  the mesh helpers agree with the JAX package's.
"""

import json
import socket
import traceback

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from kubeflow_tpu_torch.api.topology import TopologyContract
from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
from kubeflow_tpu_torch.parallel import mesh as mesh_mod
from kubeflow_tpu_torch.parallel.mesh import (MESH_AXES, Mesh, batch_rows,
                                              build_mesh, data_axes,
                                              local_batch_size, replica_axes,
                                              replica_degree)
from kubeflow_tpu_torch.runtime import bootstrap

JOIN_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def contract_env(rank: int, world: int, port: int, topology: str = "",
                 sharding: dict = None) -> dict:
    env = {"KFTPU_TOPOLOGY": topology or f"h100-{world}",
           "KFTPU_COORDINATOR_ADDRESS": f"localhost:{port}",
           "KFTPU_NUM_PROCESSES": str(world),
           "KFTPU_PROCESS_ID": str(rank)}
    if sharding:
        env["KFTPU_SHARDING"] = json.dumps(sharding)
    return env


def _rank_main(fn, rank, env, queue, args):
    torch.set_num_threads(1)
    try:
        queue.put((rank, fn(rank, env, *args), None))
    except BaseException:  # noqa: BLE001 — reported to the test
        queue.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_contract(fn, world: int, *args, sharding: dict = None) -> list:
    """``fn(rank, env, *args)`` in ``world`` spawned processes, each given
    its contract env; the results by rank."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, contract_env(r, world, port, sharding=sharding), queue, args))
        for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, out, err = queue.get(timeout=JOIN_TIMEOUT_S)
            if err:
                errors.append(f"rank {rank}:\n{err}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    assert not errors, "\n".join(errors)
    return [results[r] for r in range(world)]


def _bring_up(rank, env):
    ctx = bootstrap.initialize(env, device="cpu")
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    out = {"ids": (ctx.process_id, ctx.num_processes, ctx.is_coordinator),
           "device": str(ctx.device), "backend": dist.get_backend(),
           "world": dist.get_world_size(), "sum": float(t),
           "sharding": ctx.sharding.axis_sizes(), "mesh": ctx.mesh.shape,
           "mesh_rank": ctx.mesh.rank, "rows": batch_rows(8, ctx.mesh),
           "replicas": (replica_axes(ctx.mesh), replica_degree(ctx.mesh))}
    bootstrap.shutdown(ctx)
    out["after"] = dist.is_initialized()
    return out


def test_contract_env_gives_rank_world_device_and_sharding():
    ranks = spawn_contract(_bring_up, 2, sharding={"data": 2})
    for r, out in enumerate(ranks):
        assert out["ids"] == (r, 2, r == 0)
        assert out["device"] == "cpu"
        assert (out["backend"], out["world"], out["sum"]) == ("gloo", 2, 3.0)
        assert out["sharding"]["data"] == 2
        assert out["mesh"] == {**dict.fromkeys(MESH_AXES, 1), "data": 2}
        assert out["mesh_rank"] == r
        assert out["rows"] == slice(4 * r, 4 * r + 4)
        assert out["replicas"] == (("data",), 2)
        assert out["after"] is False


def _unported_axes(rank, env, port2):
    """A refused bring-up (an axis in ``UNPORTED_AXES``, the hook that
    stays for the next axis not yet ported: sequence put there for the
    call), then a second group on another port (a rank done with the
    first store must not find the other's still open) from
    ``{"data": 1, "sequence": 2}``: every axis builds, sequence with its
    coordinate, one replica, the whole batch and its chunk's offset."""
    msgs, built = [], {}
    seq_env = dict(env, KFTPU_SHARDING=json.dumps({"data": 1,
                                                   "sequence": 2}))
    mesh_mod.UNPORTED_AXES["sequence"] = "Queue 1 item 0"
    try:
        bootstrap.initialize(seq_env, device="cpu")
    except NotImplementedError as e:
        msgs.append(str(e))
    finally:
        mesh_mod.UNPORTED_AXES.clear()
    left = dist.is_initialized()
    ctx = bootstrap.initialize(dict(
        seq_env, KFTPU_COORDINATOR_ADDRESS=f"localhost:{port2}"),
        device="cpu")
    m = ctx.mesh
    built["contract"] = (m.coords["sequence"], replica_degree(m),
                         batch_rows(8, m), m.chunk_offset(4))
    for axis in ("fsdp", "tensor", "expert", "sequence", "pipeline"):
        try:
            mesh = build_mesh(ShardingSpec(data=1, **{axis: 2}))
            built[axis] = (mesh.coords[axis], replica_degree(mesh),
                           batch_rows(8, mesh))
        except NotImplementedError as e:
            msgs.append(str(e))
    bootstrap.shutdown(ctx)
    return msgs, left, built


def test_an_unported_axis_greater_than_one_raises():
    """An axis in ``UNPORTED_AXES`` raises on every rank, citing its
    ROADMAP item, and leaves no group; with the hook empty every axis
    builds at world 2: sequence from the contract env (``{"sequence":
    2}``: the rank's coordinate its rank, one replica reading the whole
    batch, its chunk of 4 positions at 4·rank), fsdp, tensor, expert and
    pipeline, the rank's coordinate on the axis its rank, the batch
    split over fsdp only."""
    for r, (msgs, left, built) in enumerate(
            spawn_contract(_unported_axes, 2, _free_port())):
        assert not left            # the refused bring-up left no group
        assert len(msgs) == 1, msgs
        for msg in msgs:
            assert "not yet ported" in msg and "item 0" in msg, msg
        assert built == {"contract": (r, 1, slice(0, 8), 4 * r),
                         "fsdp": (r, 2, slice(4 * r, 4 * r + 4)),
                         "tensor": (r, 1, slice(0, 8)),
                         "expert": (r, 1, slice(0, 8)),
                         "sequence": (r, 1, slice(0, 8)),
                         "pipeline": (r, 1, slice(0, 8))}


def test_strict_mismatch_raises_and_the_default_refits():
    env = contract_env(0, 1, _free_port(), topology="h100-8",
                       sharding={"data": 8})
    with pytest.raises(RuntimeError, match="promises 8 devices"):
        bootstrap.initialize(env, device="cpu", strict=True)
    assert not dist.is_initialized()     # the refused group is gone
    ctx = bootstrap.initialize(env, device="cpu")
    try:
        assert ctx.sharding == ShardingSpec()        # refit to pure DP
        assert ctx.mesh.size() == 1 and ctx.mesh.group is None
        assert (ctx.process_id, ctx.num_processes) == (0, 1)
        assert dist.get_world_size() == 1   # a contract of one: a group
    finally:
        bootstrap.shutdown(ctx)
    ok = bootstrap.initialize(contract_env(0, 1, _free_port(),
                                           topology="h100-1"),
                              device="cpu", strict=True)
    assert ok.contract.num_devices == 1
    bootstrap.shutdown(ok)
    assert bootstrap.initialize({}, device="cpu").contract is None
    assert not dist.is_initialized()


def test_a_cuda_contract_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = contract_env(0, 2, _free_port())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bootstrap.initialize(env)             # device defaults to cuda
    assert not dist.is_initialized()


def test_named_backend_brings_up_a_one_process_group():
    env = contract_env(0, 1, _free_port())
    ctx = bootstrap.initialize(env, device="cpu", backend="gloo")
    assert dist.get_backend() == "gloo"
    try:
        assert ctx.owns_group and dist.get_world_size() == 1
        t = torch.ones(3)
        dist.all_reduce(t)
        assert t.tolist() == [1.0, 1.0, 1.0]
        assert ctx.mesh.group is None        # one replica: nothing to reduce
    finally:
        bootstrap.shutdown(ctx)
    assert not dist.is_initialized()


def test_contract_env_matches_the_jax_package():
    from kubeflow_tpu.api.topology import TopologyContract as J
    from kubeflow_tpu.api.topology import parse_topology
    # v5e-32 is 8 hosts a slice, h100-8 8 GPUs: one pod each
    j = J(coordinator_address="job-worker-0.svc:8476", num_processes=16,
          process_id=11, slice_topology=parse_topology("v5e-32"),
          num_slices=2, slice_id=1)
    env = {**j.to_env(), "KFTPU_TOPOLOGY": "h100-8"}
    t = TopologyContract.from_env(env)
    assert t.to_env() == env
    assert t.num_devices == j.slice_topology.num_hosts * j.num_slices
    assert bootstrap.ENV_SHARDING == "KFTPU_SHARDING"


@pytest.mark.parametrize("spec,n", [
    ({}, 8), ({"data": 2, "fsdp": 4}, 8), ({"fsdp": -1, "data": 1}, 4),
    ({"data": 3}, 8), ({"data": -1, "tensor": 3}, 8),
    ({"data": -1, "fsdp": -1}, 8), ({"zeta": 2}, 8), ({"data": 0}, 8)])
def test_sharding_spec_matches_the_jax_package(spec, n):
    from kubeflow_tpu.api.trainingjob import ShardingSpec as J

    def outcome(cls):
        try:
            return cls.from_dict(spec).resolve(n)
        except ValueError as e:
            return type(e)

    assert outcome(ShardingSpec) == outcome(J)


@pytest.mark.parametrize("sizes", [{"data": 8}, {"data": 2, "fsdp": 4},
                                   {"data": 1, "fsdp": 8}, {"data": 1}])
def test_mesh_helpers_match_the_jax_package(sizes):
    import jax
    from kubeflow_tpu.api.trainingjob import ShardingSpec as JSpec
    from kubeflow_tpu.parallel import mesh as J
    n = 1
    for v in sizes.values():
        n *= v
    j = J.build_mesh(JSpec.from_dict(sizes), jax.devices()[:n])
    t = Mesh(shape=ShardingSpec.from_dict(sizes).resolve(n))
    assert tuple(j.axis_names) == tuple(t.shape) == MESH_AXES
    assert data_axes(t) == J.data_axes(j)
    assert replica_axes(t) == J.replica_axes(j)
    assert replica_degree(t) == J.replica_degree(j)
    assert local_batch_size(16, t) == J.local_batch_size(16, j)
    if n > 1:
        with pytest.raises(ValueError, match="not divisible"):
            local_batch_size(2 * n + 1, t)


def test_worker_context_defaults():
    ctx = bootstrap.WorkerContext(device=torch.device("cpu"))
    assert ctx.is_coordinator and ctx.mesh.size() == 1
    assert ctx.sharding == ShardingSpec() and not ctx.owns_group
