"""The pipelined worker on {pipeline 2} from the topology contract env:
save, exact resume, and a load into one process.

Two worker processes (``train()`` from the contract env with
``KFTPU_SHARDING={"data": 1, "pipeline": 2}``, gloo on the CPU) train
the tiny stacked LM (4 layers, 2 a stage, M 2) with SGD momentum,
checkpointing every 2 steps:

- a run of 4 steps, and a run stopped at step 2 then resumed to step 4
  on {pipeline 2}, end on the same loss and the same saved tree, bit
  for bit;
- the pipeline-sharded stacked leaves go through the ``kftpu-torch/2``
  block format (each stage's block once, by grid index) and read back
  at their global shapes, so one process with no mesh restores the
  {pipeline 2} step 2 and trains on to step 4: its loss within 1e-5
  relative and its params within 1e-5 of their largest magnitude of the
  two ranks' (the same function summed in another order).
"""

import json
import os
import shutil

import numpy as np
import torch

from kubeflow_tpu_torch.models.transformer import (PipelinedTransformerLM,
                                                   TransformerConfig)
from kubeflow_tpu_torch.runtime import worker
from kubeflow_tpu_torch.runtime.checkpoint import CheckpointManager
from tests.test_torch_bootstrap import spawn_contract
from tests.test_torch_model_parallel_ckpt import _flat

CFG = TransformerConfig(vocab_size=64, num_layers=4, embed_dim=16,
                        num_heads=2, head_dim=8, mlp_dim=32, max_seq_len=16,
                        dtype=torch.float32)
KW = dict(workload="transformer-pipelined",
          workload_kwargs={"cfg": CFG, "num_microbatches": 2},
          optimizer="momentum", learning_rate=0.05, global_batch=4,
          device="cpu", handle_sigterm=False, checkpoint_every=2,
          sync_every=1)
SHARDING = {"data": 1, "pipeline": 2}
RTOL = 1e-5


def _train(rank, env, steps, directory):
    os.environ.update(env)
    r = worker.train(steps=steps, checkpoint_dir=directory, **KW)
    return r.steps, r.final_metrics["loss"]


def test_pipeline_sharded_worker_saves_resumes_and_loads_anywhere(tmp_path):
    straight, split, one = (str(tmp_path / n) for n in ("a", "b", "c"))
    full = spawn_contract(_train, 2, 4, straight, sharding=SHARDING)
    spawn_contract(_train, 2, 2, split, sharding=SHARDING)
    resumed = spawn_contract(_train, 2, 4, split, sharding=SHARDING)
    assert full[0] == full[1] and resumed[0] == resumed[1]
    assert resumed[0][1:] == full[0][1:]
    a = _flat(CheckpointManager(straight).read_tree(4))
    b = _flat(CheckpointManager(split).read_tree(4))
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    # each stage's block written once, by its rank, under its grid index
    pdir = os.path.join(straight, "4", "state")
    with open(os.path.join(pdir, "index.json")) as f:
        leaves = json.load(f)["leaves"]
    assert leaves["params/blocks.attn.qkv.kernel"]["grid"] == [2, 1, 1, 1, 1]
    assert "grid" not in leaves["params/embed.tok_embed.embedding"]
    for rank in (0, 1):
        held = torch.load(os.path.join(pdir, f"rank-{rank:05d}.pt"),
                          weights_only=True)
        assert [k for k in held if k.startswith(
            "params/blocks.attn.qkv.kernel@")] == \
            [f"params/blocks.attn.qkv.kernel@{rank}.0.0.0.0"]
    # global shapes: the one-process model's state dict
    shapes = {f"params/{n}": tuple(p.shape)
              for n, p in PipelinedTransformerLM(CFG).state_dict().items()}
    assert {k: a[k].shape for k in shapes} == shapes
    # one process, no mesh: step 2 of the pipeline-2 run, on to step 4
    shutil.copytree(os.path.join(straight, "2"), os.path.join(one, "2"))
    r = worker.train(steps=4, checkpoint_dir=one, **KW)
    assert r.steps == 2
    np.testing.assert_allclose(r.final_metrics["loss"], full[0][1],
                               rtol=RTOL)
    c = _flat(CheckpointManager(one).read_tree(4))
    for k in shapes:
        err = float(np.abs(c[k] - a[k]).max())
        assert err <= RTOL * float(np.abs(a[k]).max()), (k, err)
