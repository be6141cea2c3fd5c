"""ResNet through the port's worker on the CPU (tests/test_torch_resnet.py
holds the models against flax): the fused path, every stride-1 block
through K4's plain version, and the default path with the eval pass,
through ``train()``.
"""

import numpy as np

from kubeflow_tpu_torch.runtime import worker


def test_worker_trains_resnet_on_cpu(tmp_path):
    """The fused path (every stride-1 block through K4's plain version on
    the CPU) and the default path with the eval pass, through train()."""
    kw = dict(device="cpu", steps=2, global_batch=4, sync_every=1,
              handle_sigterm=False)
    fused = worker.train(workload="resnet50", workload_kwargs={
        "image_size": 32, "num_classes": 10, "fused": True,
        "fused_tile_bt": 1}, metrics_path=str(tmp_path / "f.jsonl"), **kw)
    assert fused.steps == 2
    assert np.isfinite(fused.final_metrics["loss"])
    lines = (tmp_path / "f.jsonl").read_text().splitlines()
    assert len(lines) == 2
    plain = worker.train(workload="resnet18", workload_kwargs={
        "image_size": 32, "num_classes": 10}, eval_every=2, eval_batches=1,
        label_smoothing=0.1, **kw)
    assert np.isfinite(plain.final_metrics["loss"])
    assert {"eval_loss", "top1", "top5", "accuracy"} <= \
        set(plain.final_metrics)
