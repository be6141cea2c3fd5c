"""The worker's record-fed resume (tests/test_torch_worker.py holds
the rest of the worker on record shards): a resnet18 run from record
shards at 32 px, LARS under the runtime cosine schedule, preempted and
resumed, with the device prefetcher off and on.
"""

import pytest
import torch

from kubeflow_tpu_torch.runtime import worker
from tests.test_torch_worker import records  # noqa: F401 - the fixture


class _StopAtStep2:
    """A guard whose stop flag turns True at its second read: SIGTERM
    arriving during step 2."""

    def __init__(self, install=True, on_term=None):
        self.reads = 0

    @property
    def stop(self):
        self.reads += 1
        return self.reads >= 2

    def uninstall(self):
        pass


@pytest.mark.parametrize("prefetch", [0, 2])
def test_record_fed_resume_continues_the_stream(records, tmp_path,
                                                monkeypatch, prefetch):
    """A run from record shards (LARS under the runtime cosine schedule)
    preempted at step 2 and resumed to step 5 reads batches 2, 3 and 4 of
    the seeded stream (no replay, no skip) with the schedule's state
    restored: its params equal an uninterrupted run's, bit for bit on the
    CPU."""
    from kubeflow_tpu_torch.cluster.chaos import final_params
    kw = dict(workload="resnet18", device="cpu", data_dir=records[0],
              global_batch=4, optimizer="lars", runtime_schedule=True,
              lr_schedule="cosine", warmup_steps=1, sync_every=1,
              checkpoint_every=100, device_prefetch=prefetch, seed=0,
              handle_sigterm=False, steps=5)
    clean, cut = str(tmp_path / "clean"), str(tmp_path / "cut")
    assert worker.train(checkpoint_dir=clean, **kw).steps == 5
    monkeypatch.setattr(worker, "PreemptionGuard", _StopAtStep2)
    first = worker.train(checkpoint_dir=cut, **kw)
    assert first.preempted and first.steps == 2
    monkeypatch.undo()
    assert worker.train(checkpoint_dir=cut, **kw).steps == 3
    a, b = final_params(clean, device="cpu"), final_params(cut, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
