"""The worker's side of the Katib trial contract: report an observation.

The reporter half of ``kubeflow_tpu/katib/vizier.py``. Under a study the
operator injects ``KFTPU_VIZIER_URL``, ``KFTPU_STUDY`` and
``KFTPU_TRIAL`` into the trial's pods; the worker posts each final metric
to ``<url>/api/v1/observation`` as ``{study, trial, metric, value,
step}``. Outside a study (any of the three unset) reporting is a no-op.
The store and its HTTP front stay in the control plane, and with them
the grid, hyperband and Bayesian engines that the StudyJob controller
runs beside the store. The port carries one engine, the random one
(``katib/suggestion.py``), because kubebench's in-process study draws its
trials' learning rates from it and trains them through the port's
``train()`` (``workflows/kubebench.py``). Stdlib only.
"""

from __future__ import annotations

import json
import os
import urllib.request
from typing import Optional

VIZIER_URL_ENV = "KFTPU_VIZIER_URL"
STUDY_ENV = "KFTPU_STUDY"
TRIAL_ENV = "KFTPU_TRIAL"


def report_observation(metric: str, value: float, step: int = 0,
                       url: Optional[str] = None, study: Optional[str] = None,
                       trial: Optional[str] = None) -> bool:
    """Post one observation; False when this process is not under a study.
    An HTTP or connection failure raises (the worker logs it and goes
    on)."""
    url = url or os.environ.get(VIZIER_URL_ENV)
    study = study or os.environ.get(STUDY_ENV)
    trial = trial or os.environ.get(TRIAL_ENV)
    if not (url and study and trial):
        return False
    payload = json.dumps({"study": study, "trial": trial, "metric": metric,
                          "value": value, "step": step}).encode()
    req = urllib.request.Request(
        url.rstrip("/") + "/api/v1/observation", data=payload,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=5) as resp:
        return resp.status == 200
