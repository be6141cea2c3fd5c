"""The topology contract's env half: what the operator renders into every
worker pod.

The port's copy of ``TopologyContract``'s env surface in
``kubeflow_tpu/api/topology.py``: the six ``KFTPU_*`` names, ``from_env``
and ``to_env``. The topology name is kept as the string it arrives as
(``v5e-8``); the port reads only the device count its trailing number
states, for the bootstrap's strict check. A GPU topology vocabulary is
not defined yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional


@dataclass(frozen=True)
class TopologyContract:
    """The process-group bootstrap tuple plus the slice layout."""

    coordinator_address: str       # "<job>-worker-0.<svc>.<ns>:8476"
    num_processes: int             # hosts * num_slices
    process_id: int
    topology: str                  # the topology name, as rendered
    num_slices: int = 1
    slice_id: int = 0

    ENV_COORDINATOR = "KFTPU_COORDINATOR_ADDRESS"
    ENV_NUM_PROCESSES = "KFTPU_NUM_PROCESSES"
    ENV_PROCESS_ID = "KFTPU_PROCESS_ID"
    ENV_TOPOLOGY = "KFTPU_TOPOLOGY"
    ENV_NUM_SLICES = "KFTPU_NUM_SLICES"
    ENV_SLICE_ID = "KFTPU_SLICE_ID"

    @property
    def num_devices(self) -> Optional[int]:
        """Devices the contract promises: the topology name's trailing
        count times the slices, or None when the name carries none."""
        tail = self.topology.rsplit("-", 1)[-1]
        return int(tail) * self.num_slices if tail.isdigit() else None

    def to_env(self) -> dict[str, str]:
        return {
            self.ENV_COORDINATOR: self.coordinator_address,
            self.ENV_NUM_PROCESSES: str(self.num_processes),
            self.ENV_PROCESS_ID: str(self.process_id),
            self.ENV_TOPOLOGY: self.topology,
            self.ENV_NUM_SLICES: str(self.num_slices),
            self.ENV_SLICE_ID: str(self.slice_id),
        }

    @classmethod
    def from_env(cls, env: Mapping[str, str]) -> "TopologyContract":
        return cls(
            coordinator_address=env[cls.ENV_COORDINATOR],
            num_processes=int(env[cls.ENV_NUM_PROCESSES]),
            process_id=int(env[cls.ENV_PROCESS_ID]),
            topology=env[cls.ENV_TOPOLOGY],
            num_slices=int(env.get(cls.ENV_NUM_SLICES, "1")),
            slice_id=int(env.get(cls.ENV_SLICE_ID, "0")),
        )
