"""Worker bootstrap: the topology-contract env → process group → mesh.

The port of ``kubeflow_tpu/runtime/bootstrap.py``. The operator renders
the ``KFTPU_*`` contract (``api/topology.py``) into every worker pod;
:func:`initialize` consumes it:

- a contract joins the gang's ``torch.distributed`` process group at
  ``tcp://`` + the coordinator address, with rank ``KFTPU_PROCESS_ID``
  and world size ``KFTPU_NUM_PROCESSES`` (every pod blocks there until
  the whole gang is up; a one-process contract makes a group of one):
  ``nccl`` for a CUDA device, ``gloo`` for the CPU, unless the caller
  names the backend (ranks that share one card take ``gloo``); with no
  contract (local dev, tests) this process is the whole job and joins no
  group;
- one rank drives one card, ``cuda:{process_id % device_count}``; a CUDA
  device with no card raises;
- ``KFTPU_SHARDING`` (JSON axis sizes) resolves against the group's
  world size into the mesh (``parallel/mesh.py``). A contract whose
  topology promises another device count than the group holds raises
  under ``strict`` and otherwise refits the sharding (pure data
  parallelism when it does not fit), as the JAX package does.

:func:`shutdown` destroys the group the bootstrap created; the worker
calls it in its ``finally``.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from ..api.topology import TopologyContract
from ..api.trainingjob import ShardingSpec
from ..parallel.mesh import Mesh, build_mesh

log = logging.getLogger(__name__)

ENV_SHARDING = "KFTPU_SHARDING"


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA device with no card
    present raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            f"available; pass device='cpu' to run on the CPU")
    return dev


@dataclass
class WorkerContext:
    device: torch.device
    process_id: int = 0
    num_processes: int = 1
    contract: Optional[TopologyContract] = None
    sharding: ShardingSpec = None
    mesh: Optional[Mesh] = None
    owns_group: bool = False       # the bootstrap created the group

    def __post_init__(self):
        if self.sharding is None:
            self.sharding = ShardingSpec()
        if self.mesh is None:
            self.mesh = build_mesh(self.sharding)

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def sharding_from_env(env: Mapping[str, str]) -> ShardingSpec:
    raw = env.get(ENV_SHARDING)
    if not raw:
        return ShardingSpec()
    sizes = json.loads(raw)
    return ShardingSpec(**{k: int(v) for k, v in sizes.items()})


def _rank_device(device, process_id: int) -> torch.device:
    """``cuda`` without an index becomes this rank's card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def initialize(env: Optional[Mapping[str, str]] = None, device="cuda",
               strict: bool = False,
               backend: Optional[str] = None) -> WorkerContext:
    """Bring up the worker on ``device``. With no contract env (local dev,
    tests) this process is the whole job and no group is made. ``strict``
    (production pods) raises where the contract's device count differs
    from the group's; otherwise the sharding is refit to the group.
    ``backend`` overrides the device's (``nccl`` for CUDA, ``gloo`` for
    the CPU)."""
    env = env if env is not None else os.environ
    contract = TopologyContract.from_env(env) \
        if env.get(TopologyContract.ENV_TOPOLOGY) else None
    process_id = contract.process_id if contract else 0
    dev = _rank_device(device, process_id)
    owns = False
    if contract is not None:
        if dist.is_initialized():
            raise RuntimeError("torch.distributed is already initialized "
                               "in this process")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        # the gang's rendezvous: every pod blocks here until the whole
        # group is up (a one-process contract makes a group of one)
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=f"tcp://{contract.coordinator_address}",
            world_size=contract.num_processes, rank=contract.process_id)
        owns = True
    sharding = sharding_from_env(env)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if contract is not None and contract.num_devices is not None and \
            contract.num_devices != world:
        msg = (f"contract promises {contract.num_devices} devices "
               f"({contract.topology} x {contract.num_slices}), the "
               f"process group holds {world}")
        if strict:
            if owns:
                dist.destroy_process_group()
            raise RuntimeError(msg)
        log.warning("%s — falling back to the group's devices", msg)
        sharding = _refit_sharding(sharding, world)
    try:
        mesh = build_mesh(sharding)
    except BaseException:
        if owns:
            dist.destroy_process_group()
        raise
    return WorkerContext(
        device=dev, process_id=process_id,
        num_processes=contract.num_processes if contract else 1,
        contract=contract, sharding=sharding, mesh=mesh, owns_group=owns)


def _refit_sharding(sharding: ShardingSpec,
                    num_devices: int) -> ShardingSpec:
    """The sharding if it fits ``num_devices``, else pure data
    parallelism (dev fallback only)."""
    try:
        sharding.resolve(num_devices)
        return sharding
    except ValueError:
        log.warning("sharding %s does not fit %d devices; using pure DP",
                    sharding.axis_sizes(), num_devices)
        return ShardingSpec()


def shutdown(ctx: WorkerContext) -> None:
    """Destroy the process group the bootstrap created for ``ctx``."""
    if ctx.owns_group and dist.is_initialized():
        dist.destroy_process_group()
        ctx.owns_group = False
