"""The deployable controller-manager process.

The port's copy of ``kubeflow_tpu/controllers/__main__.py``.
``python -m kubeflow_tpu_torch.controllers --kubeconfig <path>`` runs the
port's reconcilers against an apiserver over HttpKubeClient: the
training-job operator for each kind of ``api/trainingjob.py``
``JOB_KINDS`` (``tpujob``, ``tfjob``, ...) and the slice scheduler
(``scheduler``), which reads its policy from the ``tpu-scheduler-config``
ConfigMap. With ``--leader-elect`` the process runs behind a
``coordination.k8s.io`` Lease (``cluster/lease.py``): every replica
watches, only the lease holder writes, and SIGTERM releases the lease so
a standby takes over without waiting out its duration. The manifests
(``manifests/training.py``) render these flags.

A controller the JAX manager hosts and the port has not ported is refused
with the ROADMAP item that queues it. ``--fake`` runs over an in-memory
FakeCluster (a demo: nothing else can reach it).
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import threading

from ..cluster.fake import FakeCluster
from .runtime import Manager

log = logging.getLogger(__name__)

# name → zero-arg factory; --controllers selects a subset
CONTROLLER_FACTORIES = {}

#: the JAX manager's other controllers, which the port does not have yet;
#: ROADMAP Queue 1 item 20 queues them
UNPORTED_CONTROLLERS = ("application", "autoscaler", "notebook", "profile",
                        "statefulset", "workflow", "experiment", "studyjob",
                        "scheduledworkflow", "persistenceagent")


def _register_defaults() -> None:
    from ..api.trainingjob import JOB_KINDS
    from ..scheduler.core import SliceScheduler
    from .tpujob import TrainingJobReconciler
    for kind in JOB_KINDS:
        CONTROLLER_FACTORIES[kind.lower()] = (
            lambda k=kind: TrainingJobReconciler(k))
    CONTROLLER_FACTORIES["scheduler"] = SliceScheduler


def build_manager(client, controllers: list[str], elector=None) -> Manager:
    """``elector`` (cluster/lease.py LeaderElector) gates EVERY hosted
    controller on one lease: the deployed unit of failover is the
    manager process, so all its controllers lead or follow together."""
    _register_defaults()
    for name in controllers:
        if name in UNPORTED_CONTROLLERS:
            raise SystemExit(
                f"controller {name!r} is not ported to kubeflow_tpu_torch "
                f"yet (ROADMAP Queue 1, item 20)")
        if name not in CONTROLLER_FACTORIES:
            raise SystemExit(
                f"unknown controller {name!r}; "
                f"available: {sorted(CONTROLLER_FACTORIES)}")
    mgr = Manager(client)
    kwargs = {"elector": elector} if elector is not None else {}
    for name in controllers:
        mgr.add(CONTROLLER_FACTORIES[name](), **kwargs)
    return mgr


def main(argv=None) -> int:
    _register_defaults()
    p = argparse.ArgumentParser(
        "kubeflow-tpu-torch-manager",
        description="run the controller manager against an apiserver")
    p.add_argument("--kubeconfig", default="",
                   help="kubeconfig for the target apiserver (required "
                        "unless --fake)")
    p.add_argument("--context", default="",
                   help="kubeconfig context override")
    p.add_argument("--controllers",
                   default=",".join(sorted(CONTROLLER_FACTORIES)),
                   help="comma-separated subset to run")
    p.add_argument("--fake", action="store_true",
                   help="run over an in-memory cluster (demo/testing)")
    p.add_argument("--metrics-port", type=int,
                   default=int(os.environ.get("KFTPU_METRICS_PORT", "0")),
                   help="serve /metrics (+/healthz) for Prometheus on "
                        "this port (0 = off; env fallback "
                        "KFTPU_METRICS_PORT) — the scrape surface the "
                        "tpu-job-operator / tpu-scheduler manifests "
                        "annotate")
    p.add_argument("--leader-elect", action="store_true",
                   help="run behind a coordination.k8s.io Lease "
                        "(cluster/lease.py): every replica watches, "
                        "only the lease holder writes — the HA "
                        "replicas: 2 deployments render this flag")
    p.add_argument("--lease-name", default="kubeflow-tpu-manager",
                   help="Lease object name (one per Deployment; the "
                        "manifests pass the component's lease)")
    p.add_argument("--lease-namespace", default="kubeflow",
                   help="namespace the Lease lives in")
    p.add_argument("--lease-duration", type=float, default=15.0,
                   help="seconds a leader may go un-renewed before a "
                        "standby steals the lease (failover bound)")
    p.add_argument("--identity",
                   default=os.environ.get("KFTPU_POD_NAME", ""),
                   help="this replica's lease identity (default: "
                        "KFTPU_POD_NAME, else hostname.pid)")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        force=True)

    if args.kubeconfig:
        from ..cluster.http_client import HttpKubeClient
        client = HttpKubeClient.from_kubeconfig(
            args.kubeconfig, context=args.context or None)
    elif args.fake:
        client = FakeCluster()
    else:
        p.error("--kubeconfig is required (or --fake)")

    names = [c.strip() for c in args.controllers.split(",") if c.strip()]
    elector = None
    if args.leader_elect:
        import socket

        from ..cluster.lease import FencedKubeClient, LeaderElector
        identity = args.identity or f"{socket.gethostname()}.{os.getpid()}"
        # the elector renews through the RAW client (fencing the lease
        # writes themselves would deadlock re-election); everything the
        # CONTROLLERS write goes through the fence — a deposed leader's
        # in-flight reconcile dies at the client boundary, it cannot
        # race its successor (the second, independent line of defense
        # behind the pop-time leader gate)
        elector = LeaderElector(
            client=client, identity=identity, name=args.lease_name,
            namespace=args.lease_namespace,
            duration_s=args.lease_duration)
        client = FencedKubeClient(client, elector)
        log.info("leader election on: lease %s/%s identity %s "
                 "(duration %.1fs)", args.lease_namespace,
                 args.lease_name, identity, args.lease_duration)
    mgr = build_manager(client, names, elector=elector)
    obs_server = None
    if args.metrics_port:
        from ..obs.http import ObsServer
        obs_server = ObsServer(port=args.metrics_port)
        log.info("metrics on :%d/metrics", obs_server.start())
    log.info("manager running %d controllers: %s", len(mgr.controllers),
             ", ".join(names))
    mgr.start_all()

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    log.info("shutting down")
    mgr.stop_all()
    if elector is not None:
        # graceful handoff: clear the lease so the standby takes over
        # NOW instead of waiting out the lease duration
        elector.release()
    if obs_server is not None:
        obs_server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
