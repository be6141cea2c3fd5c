"""The MoE LM over a ``sequence`` axis: gloo ranks against the JAX
package's ``TrainStepBuilder`` on the same ``ShardingSpec`` over the
conftest's virtual CPU devices, where GSPMD routes the whole sequence.

The tiny MoE LM of tests/test_torch_model_parallel.py (4 experts, top 2)
at a capacity factor of 0.5, so that tokens drop (a capacity of 4 slots
an expert and row over the whole sequence of 16, 2 over a chunk of 8),
f32, 3 steps of SGD momentum with the clip at 0.5 acting every step:

- ``{sequence 2}`` from the contract env (``KFTPU_SHARDING``, the
  worker's bootstrap): the 3 steps against JAX; the MoE layer on a
  rank's chunk against the layer on the whole sequence in one process
  (the hazards: the capacity from the whole sequence, the positions
  after the earlier chunk's choices); one step of the aux loss alone,
  counted once over the axis; then ``worker.train`` with the MoE LM.
- ``{expert 2, sequence 2}`` on 4 ranks: the 3 steps against JAX.

Bars (tests/test_torch_sequence.py's): loss, grad norm and
``moe_aux_loss`` within 1e-5 relative at every step, each param within
1e-5 of its largest magnitude after 3 steps.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.runtime import bootstrap, recipe, worker
from tests.test_torch_bootstrap import spawn_contract
from tests.test_torch_dp import spawn
from tests.test_torch_model_parallel import (BATCH, DENSE, OPT, RTOL, SEQ,
                                             _jax_run, _port_rank, assemble,
                                             numpy_params)

MOE = dict(DENSE, num_experts=4, moe_top_k=2, moe_capacity_factor=0.5)
SEQ2 = {"sequence": 2}
EXPERT_SEQ = {"expert": 2, "sequence": 2}
# one SGD step at lr 1 without the clip: a param's change is its reduced
# gradient
AUX_ONLY = dict(name="sgd", learning_rate=1.0, grad_clip=None)


def _inputs() -> tuple:
    params = numpy_params(MOE, seed=31)
    tokens = np.random.default_rng(32).integers(
        0, MOE["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    return params, tokens


def _cfg(**kw):
    from kubeflow_tpu_torch.models import transformer as T
    return T.TransformerConfig(attention="einsum", dtype=torch.float32,
                               **dict(MOE, **kw))


def _layer(mesh, cfg, layer_params: dict, x: torch.Tensor):
    """layer0's MoE block on ``x`` (name -> tensor params, under
    ``layer0.moe.``): (out, aux)."""
    from kubeflow_tpu_torch.models.moe import MoEMLP
    from torch.func import functional_call
    with torch.device("meta"):
        moe = MoEMLP(cfg.num_experts, cfg.embed_dim, cfg.mlp_dim,
                     top_k=cfg.moe_top_k,
                     capacity_factor=cfg.moe_capacity_factor,
                     aux_loss_weight=cfg.moe_aux_weight, dtype=cfg.dtype,
                     mesh=mesh)
    with torch.no_grad():
        out, aux = functional_call(moe, layer_params, (x,))
    return out.numpy(), float(aux)


def _moe_inputs(full: dict) -> tuple:
    """layer0's MoE params and a seeded activation [B, S, M]."""
    params = {k[len("layer0.moe."):]: v for k, v in full.items()
              if k.startswith("layer0.moe.")}
    x = np.random.default_rng(33).standard_normal(
        (BATCH, SEQ, MOE["embed_dim"])).astype(np.float32)
    return params, torch.tensor(x)


def _sgd_step(mesh, full: dict, tokens, weight: float) -> dict:
    """One step at the aux weight ``weight``: every param's change,
    which is its reduced gradient, and the reported aux."""
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder
    spec = T.workload_spec(_cfg(moe_aux_weight=weight), SEQ, mesh=mesh)
    b = TrainStepBuilder(
        loss_fn=spec.loss_fn, device="cpu", mesh=mesh, rules=spec.rules,
        param_logical_axes=spec.param_logical_axes,
        optimizer=lambda p: recipe.make_optimizer(p, **AUX_ONLY)[0])
    state = b.init(lambda rng: (full, {}), None)
    start = {n: p.detach().clone() for n, p in state.params.items()}
    _, m = b.build()(state, b.place_batch({"tokens": tokens}))
    return {"delta": {n: (start[n] - p.detach()).numpy()
                      for n, p in state.params.items()},
            "aux": float(m["moe_aux_loss"])}


def _aux_only(mesh, full: dict, tokens) -> dict:
    """The aux term's reduced gradient: one step at aux weight 1 less one
    at weight 0 (the routing, and so the task term, is the same), and the
    reported aux at weight 1."""
    one, zero = (_sgd_step(mesh, full, tokens, w) for w in (1.0, 0.0))
    return {"grads": {n: d - zero["delta"][n]
                      for n, d in one["delta"].items()},
            "aux": one["aux"]}


def _seq_rank(rank, env, params, tokens):
    """Every {sequence 2} check of one rank, in one process group."""
    from kubeflow_tpu_torch.models.convert import transformer_params_from_jax
    ctx = bootstrap.initialize(env, device="cpu")
    mesh = ctx.mesh
    out = {"coord": mesh.coords["sequence"]}
    out["steps"] = _port_rank(rank, 2, SEQ2, MOE, "einsum", "replicated",
                              OPT, params, tokens)
    full = transformer_params_from_jax(params)
    layer, x = _moe_inputs(full)
    c = SEQ // 2
    at = mesh.chunk_offset(c)
    out["layer"] = _layer(mesh, _cfg(), layer, x[:, at:at + c])
    out["aux_only"] = _aux_only(mesh, full, tokens)
    r = worker.train(workload="transformer", ctx=ctx, steps=2,
                     global_batch=BATCH, optimizer="momentum",
                     learning_rate=0.05, device="cpu", sync_every=1,
                     handle_sigterm=False,
                     workload_kwargs={"cfg": _cfg(), "seq_len": SEQ})
    out["worker"] = (r.steps, r.final_metrics["loss"],
                     r.final_metrics["moe_aux_loss"])
    bootstrap.shutdown(ctx)
    return out


def _mixed_rank(rank, world, params, tokens):
    return _port_rank(rank, world, EXPERT_SEQ, MOE, "einsum", "replicated",
                      OPT, params, tokens)


@pytest.fixture(scope="module")
def seq_runs():
    params, tokens = _inputs()
    ranks = spawn_contract(_seq_rank, 2, params, tokens, sharding=SEQ2)
    return ranks, params, tokens


@pytest.fixture(scope="module")
def mixed_runs():
    params, tokens = _inputs()
    return spawn(_mixed_rank, 4, params, tokens), params, tokens


def _check_steps(ranks: list, mesh: dict, params, tokens) -> None:
    j_hist, j_params = _jax_run(mesh, MOE, "einsum", "replicated", OPT,
                                params, tokens)
    assert all(m["grad_norm"] > OPT["grad_clip"] for m in j_hist)
    for r, out in enumerate(ranks):
        for i, (jm, tm) in enumerate(zip(j_hist, out["hist"])):
            for k in ("loss", "grad_norm", "moe_aux_loss"):
                np.testing.assert_allclose(
                    tm[k], jm[k], rtol=RTOL, err_msg=f"rank {r} step {i} {k}")
    got = assemble(ranks)
    assert set(got) == set(j_params)
    for n, want in j_params.items():
        err = float(np.abs(got[n] - want).max())
        assert err <= RTOL * float(np.abs(want).max()), (n, err)


def test_three_steps_on_sequence2_match_jax(seq_runs):
    ranks, params, tokens = seq_runs
    assert [r["coord"] for r in ranks] == [0, 1]
    _check_steps([r["steps"] for r in ranks], SEQ2, params, tokens)


def test_three_steps_on_expert2_sequence2_match_jax(mixed_runs):
    """Each rank holds its expert coordinate's 2 experts; the combine's
    partial sums run over the expert group of its own sequence
    coordinate, the counts and the aux statistics over the sequence
    group of its own expert coordinate."""
    ranks, params, tokens = mixed_runs
    _check_steps(ranks, EXPERT_SEQ, params, tokens)


def _one_process_layer(params) -> tuple:
    from kubeflow_tpu_torch.models.convert import transformer_params_from_jax
    return _moe_inputs(transformer_params_from_jax(params))


def test_capacity_is_the_global_one(seq_runs):
    """A rank's MoE output on its chunk is the whole sequence's at its
    positions (one process, no mesh). A chunk routed alone at the same
    capacity factor (the capacity from its own 8 positions, 2 slots) gives
    another output: tokens drop, and the capacity is the whole
    sequence's 4."""
    ranks, params, _ = seq_runs
    layer, x = _one_process_layer(params)
    whole, aux = _layer(None, _cfg(), layer, x)
    c = SEQ // 2
    for r, out in enumerate(ranks):
        got, got_aux = out["layer"]
        mine = whole[:, r * c:(r + 1) * c]
        np.testing.assert_allclose(got, mine, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_aux, aux, rtol=1e-6)
        alone, _ = _layer(None, _cfg(), layer, x[:, r * c:(r + 1) * c])
        assert np.abs(alone - mine).max() > 1e-3, r


def test_rank1_token_is_dropped_because_of_rank0_tokens(seq_runs):
    """Rank 1's chunk routed alone at the whole sequence's capacity (its
    capacity factor doubled: 4 slots) keeps tokens that the whole
    sequence drops, because rank 0's tokens took the slots first (and
    queued the first choices ahead of the second): rows of rank 1's output
    differ from that chunk alone, and equal the whole sequence's."""
    ranks, params, _ = seq_runs
    layer, x = _one_process_layer(params)
    whole, _ = _layer(None, _cfg(), layer, x)
    c = SEQ // 2
    mine = whole[:, c:]
    alone, _ = _layer(None, _cfg(moe_capacity_factor=2 * MOE[
        "moe_capacity_factor"]), layer, x[:, c:])
    moved = np.abs(alone - mine).max(-1) > 1e-3          # [B, S/2]
    assert moved.any()
    got, _ = ranks[1]["layer"]
    np.testing.assert_allclose(got[moved], mine[moved], rtol=1e-5,
                               atol=1e-6)


def test_aux_loss_is_counted_once(seq_runs):
    """One step of the aux loss alone (weight 1; SGD at lr 1, no clip):
    both ranks report the one-process aux, and every param moves by the
    one-process gradient, the router's included, not twice it: the aux is
    whole on every sequence rank, and its gradient enters the sum over the
    axis once."""
    from kubeflow_tpu_torch.models.convert import transformer_params_from_jax
    ranks, params, tokens = seq_runs
    one = _aux_only(None, transformer_params_from_jax(params), tokens)
    assert one["aux"] > 0
    router = "layer0.moe.router"
    assert np.abs(one["grads"][router]).max() > 1e-3
    for r, out in enumerate(ranks):
        got = out["aux_only"]
        np.testing.assert_allclose(got["aux"], one["aux"], rtol=1e-6)
        for n, g in one["grads"].items():
            err = float(np.abs(got["grads"][n] - g).max())
            assert err <= 1e-5 * float(np.abs(g).max()) + 1e-9, (r, n, err)


def test_worker_trains_the_moe_lm_on_sequence2(seq_runs):
    """``worker.train`` from the contract env with the MoE LM: 2 steps,
    the same loss and aux on both ranks."""
    ranks, _, _ = seq_runs
    assert ranks[0]["worker"] == ranks[1]["worker"]
    steps, loss, aux = ranks[0]["worker"]
    assert steps == 2 and np.isfinite(loss) and aux > 0
