"""Gang-scheduling queue: the quota-aware slice scheduler on GPU nodes.

The port of ``kubeflow_tpu/scheduler``: the GPU node inventory that packs
gangs onto runs of one node's GPUs (``inventory``), priority queues with
namespace quotas (``queue``), the planning pass and its reconcile loop
with backfill, checkpoint-aware preemption, elastic resizes and the node
health feedback (``core``, ``health``), warm pods (``warmpool``) and the
preemption, elastic, health and control-plane soaks around the port's
``train()`` with the split-brain drill (``soak``). Stdlib only at import
time.
"""

from .inventory import Placement, PoolState, SliceInventory, SliceRect
from .queue import (JobRequest, QueueSpec, SchedulerConfig, binding_of,
                    elastic_topologies, ordered, over_quota, request_of,
                    resize_history)
from .core import (Plan, SliceScheduler, STATE_BOUND, STATE_PREEMPTED,
                   STATE_QUEUED, plan)

__all__ = [
    "Placement", "PoolState", "SliceInventory", "SliceRect",
    "JobRequest", "QueueSpec", "SchedulerConfig", "binding_of",
    "elastic_topologies", "ordered", "over_quota", "request_of",
    "resize_history",
    "Plan", "SliceScheduler", "plan",
    "STATE_BOUND", "STATE_PREEMPTED", "STATE_QUEUED",
]
