"""Checkpoint faults and the final-params read of the chaos drills.

The jax-free part of ``kubeflow_tpu/cluster/chaos.py`` the port needs:
the corruptors a chaos drill applies to a checkpoint directory between
training segments (a truncated payload file under a committed step, a
step whose commit marker is gone) and ``final_params``, which restores
the newest intact step's params the way a resumed worker would.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from ..runtime.checkpoint import (MANIFEST_NAME, ORBAX_COMMIT_MARKER,
                                  CheckpointManager)

log = logging.getLogger(__name__)


def latest_step_dir(directory: str) -> Optional[str]:
    """The newest integer-named step directory, committed or not: the raw
    view a corruptor targets (restore never uses it)."""
    try:
        steps = sorted(int(n) for n in os.listdir(directory)
                       if n.isdigit()
                       and os.path.isdir(os.path.join(directory, n)))
    except OSError:
        return None
    return os.path.join(directory, str(steps[-1])) if steps else None


def truncate_checkpoint_payload(step_dir: str, keep_frac: float = 0.5
                                ) -> str:
    """Truncate the largest payload file of a committed step (a node that
    died mid-write). The commit marker stays, so only the manifest can
    catch it. Returns the truncated path."""
    candidates = []
    for root, _dirs, files in os.walk(step_dir):
        for fname in files:
            if fname in (MANIFEST_NAME, ORBAX_COMMIT_MARKER):
                continue
            path = os.path.join(root, fname)
            candidates.append((os.path.getsize(path), path))
    if not candidates:
        raise FileNotFoundError(f"no payload files under {step_dir}")
    size, path = max(candidates)
    with open(path, "r+b") as f:
        f.truncate(max(1, int(size * keep_frac)))
    log.info("chaos: truncated %s to %d/%d bytes", path,
             max(1, int(size * keep_frac)), size)
    return path


def uncommit_checkpoint(step_dir: str) -> None:
    """Remove the commit marker (a writer that died before finalizing):
    ``latest_step()`` must skip the step."""
    marker = os.path.join(step_dir, ORBAX_COMMIT_MARKER)
    if os.path.exists(marker):
        os.remove(marker)


def final_params(checkpoint_dir: str, device="cuda") -> dict:
    """The params of the newest intact step, on ``device`` (cuda unless
    the caller asks for the CPU): corrupted steps fall back."""
    mgr = CheckpointManager(checkpoint_dir)
    try:
        return mgr.restore_params(device=device)
    finally:
        mgr.close()
