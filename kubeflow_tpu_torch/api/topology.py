"""GPU slice topology model and the topology contract.

The port's counterpart of ``kubeflow_tpu/api/topology.py``. The JAX
package's contract is two-level: the ICI mesh of one TPU slice, and data
parallelism over DCN across slices. On NVIDIA GPUs the same two levels
are:

- **NVLink** (intra-slice): one **slice** is the GPUs of one NVLink
  domain, which is one node. ``h100-8`` is one node of 8 H100s; ``h100-2``
  is two GPUs of one node. A slice never spans nodes.
- **The network** (inter-slice): ``numSlices`` counts nodes joined over
  the network, the DCN-level data parallelism of the JAX contract, so
  ``obs/collectives.py``'s ICI/DCN split maps onto NVLink/network
  unchanged.

**One pod per GPU.** The worker's bootstrap drives one card a rank
(``runtime/bootstrap.py``), so a slice of N GPUs is a gang of N pods,
each asking for ``nvidia.com/gpu: 1``: ``num_processes = gpus x slices``
and ``process_id = slice x gpus + gpu``.

This module is the single source of truth for what a topology name means
(``parse_topology``), and renders the contract every worker pod gets
(``render_contracts``): the six ``KFTPU_*`` names the bootstrap reads
(``from_env``). A TPU name (``v5e-8``) is refused: this package drives
GPUs only.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Mapping, Optional


@dataclass(frozen=True)
class GpuGeneration:
    name: str                      # "h100"
    gpus_per_node: int             # GPUs of one NVLink domain (one node)
    hbm_gib_per_gpu: int
    # the node label NVIDIA's GPU feature discovery writes
    # (``nvidia.com/gpu.product``: the product name, spaces as dashes)
    product: str
    supported_gpu_counts: tuple[int, ...]   # valid slice sizes


GENERATIONS: dict[str, GpuGeneration] = {
    # the SXM H100 of an HGX board: 8 GPUs all to all over NVLink
    "h100": GpuGeneration(
        name="h100", gpus_per_node=8, hbm_gib_per_gpu=80,
        product="NVIDIA-H100-80GB-HBM3", supported_gpu_counts=(1, 2, 4, 8)),
}

_TOPOLOGY_RE = re.compile(r"^([a-z]+\d+[a-z]*)-(\d+)$")
_TPU_RE = re.compile(r"^v\d+[a-z]*-\d+$")


def _expected() -> str:
    return "; ".join(
        f"{g.name}-N with N in {g.supported_gpu_counts} GPUs of one node"
        for g in GENERATIONS.values())


@dataclass(frozen=True)
class GpuTopology:
    """A named, validated GPU slice: the GPUs of one NVLink domain, the
    atomic scheduling unit (the gang of one slice)."""

    name: str                      # "h100-8"
    generation: GpuGeneration
    num_gpus: int

    @property
    def pods_per_slice(self) -> int:
        """Pods the slice schedules: one a GPU."""
        return self.num_gpus

    @property
    def hbm_gib(self) -> int:
        return self.num_gpus * self.generation.hbm_gib_per_gpu

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "generation": self.generation.name,
            "numGpus": self.num_gpus,
            "podsPerSlice": self.pods_per_slice,
            "product": self.generation.product,
        }


def parse_topology(name: str) -> GpuTopology:
    """Parse ``h100-8``-style topology names (the ``gpuTopology`` field of
    a GPU replica)."""
    s = name.strip().lower()
    if _TPU_RE.match(s):
        raise ValueError(
            f"{name!r} is a TPU topology; a GPU replica names a GPU "
            f"topology: {_expected()} (e.g. h100-8)")
    m = _TOPOLOGY_RE.match(s)
    if not m:
        raise ValueError(
            f"invalid GPU topology {name!r}; expected {_expected()} "
            f"(e.g. h100-8)")
    gen_name, gpus_s = m.groups()
    gen = GENERATIONS.get(gen_name)
    if gen is None:
        raise ValueError(
            f"unknown GPU generation {gen_name!r} in {name!r}; expected "
            f"{_expected()}")
    gpus = int(gpus_s)
    if gpus not in gen.supported_gpu_counts:
        raise ValueError(
            f"{gen_name} does not come in {gpus}-GPU slices; a slice is "
            f"GPUs of one node: {_expected()}")
    return GpuTopology(name=f"{gen_name}-{gpus}", generation=gen,
                       num_gpus=gpus)


@dataclass(frozen=True)
class TopologyContract:
    """What the operator renders into each worker pod — the TF_CONFIG
    analog: the process-group bootstrap tuple plus the slice layout."""

    coordinator_address: str       # "<job>-worker-0-0.<svc>.<ns>:8476"
    num_processes: int             # gpus * num_slices
    process_id: int
    slice_topology: GpuTopology
    num_slices: int = 1            # nodes joined over the network
    slice_id: int = 0

    ENV_COORDINATOR = "KFTPU_COORDINATOR_ADDRESS"
    ENV_NUM_PROCESSES = "KFTPU_NUM_PROCESSES"
    ENV_PROCESS_ID = "KFTPU_PROCESS_ID"
    ENV_TOPOLOGY = "KFTPU_TOPOLOGY"
    ENV_NUM_SLICES = "KFTPU_NUM_SLICES"
    ENV_SLICE_ID = "KFTPU_SLICE_ID"

    @property
    def topology(self) -> str:
        return self.slice_topology.name

    @property
    def num_devices(self) -> int:
        """GPUs the contract promises: the slice's times the slices."""
        return self.slice_topology.num_gpus * self.num_slices

    def to_env(self) -> dict[str, str]:
        return {
            self.ENV_COORDINATOR: self.coordinator_address,
            self.ENV_NUM_PROCESSES: str(self.num_processes),
            self.ENV_PROCESS_ID: str(self.process_id),
            self.ENV_TOPOLOGY: self.slice_topology.name,
            self.ENV_NUM_SLICES: str(self.num_slices),
            self.ENV_SLICE_ID: str(self.slice_id),
        }

    @classmethod
    def from_env(cls, env: Mapping[str, str]) -> "TopologyContract":
        return cls(
            coordinator_address=env[cls.ENV_COORDINATOR],
            num_processes=int(env[cls.ENV_NUM_PROCESSES]),
            process_id=int(env[cls.ENV_PROCESS_ID]),
            slice_topology=parse_topology(env[cls.ENV_TOPOLOGY]),
            num_slices=int(env.get(cls.ENV_NUM_SLICES, "1")),
            slice_id=int(env.get(cls.ENV_SLICE_ID, "0")),
        )


def render_contracts(
    job_name: str,
    namespace: str,
    topology: GpuTopology,
    num_slices: int = 1,
    port: int = 8476,
    headless_service: Optional[str] = None,
) -> list[TopologyContract]:
    """One contract per worker pod (one a GPU), coordinator = slice 0 /
    GPU 0, in process-id order: slice-major, then the GPU. Pod DNS
    follows the headless-service convention of the JAX package (one
    service per job, stable pod hostnames)."""
    svc = headless_service or f"{job_name}-workers"
    coord = f"{job_name}-worker-0-0.{svc}.{namespace}:{port}"
    pods = topology.pods_per_slice
    return [
        TopologyContract(
            coordinator_address=coord,
            num_processes=num_slices * pods,
            process_id=s * pods + g,
            slice_topology=topology,
            num_slices=num_slices,
            slice_id=s,
        )
        for s in range(num_slices) for g in range(pods)]
