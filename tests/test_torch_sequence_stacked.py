"""The stacked (pipelined) LM over a ``sequence`` axis: gloo ranks
against the JAX package's ``TrainStepBuilder`` on the same
``ShardingSpec`` over the conftest's virtual CPU devices (its
partial-manual ``shard_map`` over ``pipeline`` leaves ``sequence`` to
GSPMD).

The 4-layer stacked LM of tests/test_torch_pipeline_train.py at S 16,
batch 8, M 2, flash attention (its plain versions here, the JAX Pallas
kernels in interpret mode), f32, 3 steps of SGD momentum with the clip
at 0.5 acting every step:

- ``{sequence 2}`` from the contract env (``KFTPU_SHARDING``): the 3
  steps against JAX, K1, K2a and K2b L = 4 a rank a step on the gathered
  sequence; then ``worker.train`` with ``transformer-pipelined``;
- ``{pipeline 2, sequence 2}`` on 4 ranks: the 3 steps against JAX,
  K1/K2a/K2b M·L/S = 4 a rank a step; the hops of a rank's pipeline
  group only, M microbatches of ``[B/M, S/n, E]`` each way a step; the
  embedding equal on every rank.

Bars (tests/test_torch_sequence.py's): loss and grad norm within 1e-5
relative at every step, each param within 1e-5 of its largest magnitude
after 3 steps.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.runtime import bootstrap, worker
from tests.test_torch_bootstrap import spawn_contract
from tests.test_torch_dp import spawn
from tests.test_torch_model_parallel import assemble
from tests.test_torch_pipeline_train import (BATCH, CFG, KERNELS, MICRO,
                                             OPT, RTOL, SEQ, STEPS, _jax_run,
                                             _port_rank, numpy_params)

SEQ2 = {"sequence": 2}
PIPE_SEQ = {"pipeline": 2, "sequence": 2}


def _inputs() -> tuple:
    params = numpy_params()
    tokens = np.random.default_rng(6).integers(
        0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    return params, tokens


def _traffic(rank, world, mesh, params, tokens) -> dict:
    """_port_rank's run, with this rank's point-to-point traffic and its
    pipeline group's global ranks."""
    from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
    from kubeflow_tpu_torch.parallel import collectives
    from kubeflow_tpu_torch.parallel.mesh import build_mesh
    import torch.distributed as dist
    collectives.reset_counts()
    out = _port_rank(rank, world, mesh, params, tokens, False)
    out["calls"] = dict(collectives.calls)
    out["bytes"] = dict(collectives.bytes_moved)
    m = build_mesh(ShardingSpec(**mesh))
    out["pipeline_ranks"] = dist.get_process_group_ranks(
        m.group_of("pipeline"))
    return out


def _seq_rank(rank, env, params, tokens):
    ctx = bootstrap.initialize(env, device="cpu")
    out = {"steps": _port_rank(rank, 2, SEQ2, params, tokens, False)}
    from kubeflow_tpu_torch.models import transformer as T
    cfg = T.TransformerConfig(attention="flash", dtype=torch.float32, **CFG)
    r = worker.train(workload="transformer-pipelined", ctx=ctx, steps=2,
                     global_batch=BATCH, optimizer="momentum",
                     learning_rate=0.05, device="cpu", sync_every=1,
                     handle_sigterm=False,
                     workload_kwargs={"cfg": cfg, "seq_len": SEQ,
                                      "num_microbatches": MICRO})
    out["worker"] = (r.steps, r.final_metrics["loss"])
    bootstrap.shutdown(ctx)
    return out


@pytest.fixture(scope="module")
def seq_runs():
    params, tokens = _inputs()
    ranks = spawn_contract(_seq_rank, 2, params, tokens, sharding=SEQ2)
    return ranks, params, tokens


@pytest.fixture(scope="module")
def pipe_runs():
    params, tokens = _inputs()
    return spawn(_traffic, 4, PIPE_SEQ, params, tokens), params, tokens


def _check(ranks: list, mesh: dict, params, tokens) -> None:
    """The module's bars against JAX; K1/K2a/K2b M·L/S a rank a step
    (L on {sequence 2}, whose stacked LM applies its layers to the whole
    batch); the embedding equal on every rank."""
    j_hist, j_params = _jax_run(mesh, params, tokens)
    assert all(m["grad_norm"] > OPT["grad_clip"] for m in j_hist)
    stages = mesh.get("pipeline", 1)
    per_step = (MICRO if stages > 1 else 1) * CFG["num_layers"] // stages
    for r, out in enumerate(ranks):
        for i, (jm, tm) in enumerate(zip(j_hist, out["hist"])):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(
                    tm[k], jm[k], rtol=RTOL, err_msg=f"rank {r} step {i} {k}")
        for got in out["launches"]:
            assert {k: got[k] for k in KERNELS} == dict.fromkeys(
                KERNELS, per_step), got
    got = assemble(ranks)
    assert set(got) == set(j_params)
    for n, want in j_params.items():
        err = float(np.abs(got[n] - want).max())
        assert err <= RTOL * float(np.abs(want).max()), (n, err)
    for n in ("embed.tok_embed.embedding", "embed.pos_embed.embedding"):
        for out in ranks[1:]:
            assert np.array_equal(ranks[0]["blocks"][n][0],
                                  out["blocks"][n][0]), n


def test_stacked_lm_on_sequence2_matches_jax(seq_runs):
    ranks, params, tokens = seq_runs
    _check([r["steps"] for r in ranks], SEQ2, params, tokens)


def test_stacked_lm_on_pipeline2_sequence2_matches_jax(pipe_runs):
    ranks, params, tokens = pipe_runs
    _check(ranks, PIPE_SEQ, params, tokens)


def test_hops_stay_in_the_ranks_own_sequence_coordinate(pipe_runs):
    """A rank's pipeline group is the two stages of its own sequence
    coordinate (ranks 0, 2 and 1, 3: the mesh is row-major, sequence
    inner), and it sends and receives M microbatches of [B/M, S/n, E]
    f32 a step: stage 0 the activations forward, stage 1 their
    cotangents back."""
    ranks, _, _ = pipe_runs
    assert [r["pipeline_ranks"] for r in ranks] == [[0, 2], [1, 3],
                                                     [0, 2], [1, 3]]
    msg = (BATCH // MICRO) * (SEQ // 2) * CFG["embed_dim"] * 4
    for r, out in enumerate(ranks):
        assert out["calls"]["send"] == out["calls"]["recv"] == \
            STEPS * MICRO, (r, out["calls"])
        assert out["bytes"]["send"] == out["bytes"]["recv"] == \
            STEPS * MICRO * msg, (r, out["bytes"])


def test_worker_trains_the_stacked_lm_on_sequence2(seq_runs):
    """``worker.train`` from the contract env with
    ``transformer-pipelined``: 2 steps, the same loss on both ranks."""
    ranks, _, _ = seq_runs
    assert ranks[0]["worker"] == ranks[1]["worker"]
    steps, loss = ranks[0]["worker"]
    assert steps == 2 and np.isfinite(loss)
