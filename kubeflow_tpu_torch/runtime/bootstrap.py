"""Worker bootstrap: the topology-contract env → the device this worker runs on.

The port of ``kubeflow_tpu/runtime/bootstrap.py`` for one process on one
device. The operator renders the same ``KFTPU_*`` contract env for every
worker; a contract for more than one process needs
``torch.distributed`` bring-up, which is not ported yet, and raises
instead of training a single replica that believes it is a gang.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

# the topology-contract env (kubeflow_tpu/api/topology.py TopologyContract)
ENV_TOPOLOGY = "KFTPU_TOPOLOGY"
ENV_NUM_PROCESSES = "KFTPU_NUM_PROCESSES"
ENV_PROCESS_ID = "KFTPU_PROCESS_ID"


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


def initialize(env=None, device="cuda") -> WorkerContext:
    """Bring up the worker on ``device``. With no contract env (local dev,
    tests) or a one-process contract, this process is the whole job."""
    env = env if env is not None else os.environ
    topology = env.get(ENV_TOPOLOGY) or None
    if topology is not None:
        n = int(env.get(ENV_NUM_PROCESSES) or 1)
        if n > 1:
            raise NotImplementedError(
                f"a {n}-process topology contract ({ENV_TOPOLOGY}="
                f"{topology}) needs torch.distributed bring-up, which is "
                f"not yet ported (ROADMAP Queue 1 item 4)")
    return WorkerContext(
        device=resolve_device(device),
        process_id=int(env.get(ENV_PROCESS_ID) or 0) if topology else 0)
