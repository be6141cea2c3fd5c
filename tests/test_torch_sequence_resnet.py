"""ResNet over a ``sequence`` axis: the model replicated over it, as the
JAX package runs it. Its ``place_batch`` cuts dimension 1 of rank-2
arrays only, so every sequence rank of a data shard holds that shard's
whole images, and GSPMD runs the default path alike on each.

ResNet-50 at width 8 and 32 px, 10 classes, f32, batch 8, 3 steps of
SGD momentum with the clip at 0.5 acting every step:

- the default path (exact BN over the global batch) on ``{sequence 2}``
  from the contract env and on ``{data 2, sequence 2}`` (4 ranks),
  against the JAX package's ``TrainStepBuilder`` on the same
  ``ShardingSpec`` over the conftest's virtual CPU devices;
- the fused path (K4's plain version on the CPU, every stride-1 block at
  32 px) on ``{sequence 2}``, against the port's one process on the
  whole batch (tests/test_torch_fused_block_model.py holds that against
  the JAX package's Pallas kernels);
- ``worker.train`` with ``resnet50``, default and ``fused``, from the
  contract env.

Pins: ``local_rows`` keeps the images whole; the gradient is counted
once over the axis (the step sums every gradient over it, and every
rank's backward is the whole gradient); BatchNorm's statistics and the
fused moments' mean cover the data group only.

Bars (tests/test_torch_sequence.py's): loss and grad norm within 1e-5
relative at every step, each param and running statistic within 1e-5 of
its largest magnitude after 3 steps (against JAX, of at least 0.01:
``JAX_FLOOR``). The weights are the model's own init: on
tests/test_torch_resnet.py's random draw (every BatchNorm scale near 1)
ResNet-50 at this size is chaotic, its loss moving by 4e-5 and its grad
norm by 1% when the images move by 2^-20 of themselves, in either
package.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
from kubeflow_tpu_torch.models import resnet as R
from kubeflow_tpu_torch.parallel.mesh import MESH_AXES, Mesh, build_mesh
from kubeflow_tpu_torch.runtime import bootstrap, recipe, worker
from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder
from tests.test_torch_bootstrap import spawn_contract
from tests.test_torch_dp import spawn

DEPTH, WIDTH, SIZE, CLASSES, BATCH, STEPS = 50, 8, 32, 10, 8, 3
OPT = dict(name="momentum", learning_rate=0.05, momentum=0.9,
           schedule="constant", total_steps=STEPS, grad_clip=0.5)
RTOL = 1e-5
# against the JAX package, a leaf is held within RTOL of at least this
# magnitude: the biases of BatchNorms before a zero-scaled one start at 0
# and move by ~5e-8 in 3 steps, and the JAX package's own one-device and
# {data 2, sequence 2} runs part there by 4e-5 of that (2e-12)
JAX_FLOOR = 1e-2
SEQ2 = {"sequence": 2}
DATA_SEQ = {"data": 2, "sequence": 2}


def _nest(flat: dict) -> dict:
    """Dotted names -> the flax tree of numpy arrays."""
    out: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.numpy()
    return out


def _inputs() -> tuple:
    """The model's own init at a seed (``ResNet.init``: lecun-normal
    kernels, the last BatchNorm scale of each block zero, as flax's ResNet
    starts) as flax-shaped numpy trees, and a seeded batch."""
    params, variables = _model().init(torch.Generator().manual_seed(41))
    rng = np.random.default_rng(42)
    batch = {"images": rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(
        np.float32),
        "labels": (np.arange(BATCH) * 3 % CLASSES).astype(np.int32)}
    return _nest(params), _nest(variables["batch_stats"]), batch


def _model():
    return R.make_resnet(DEPTH, num_classes=CLASSES, width=WIDTH,
                         dtype=torch.float32)


def _train(mesh, fused: bool, params, stats, batch) -> dict:
    """3 steps of the port's TrainStepBuilder (``mesh`` None: one
    process): the history, the params and the running statistics."""
    from kubeflow_tpu_torch.models.convert import resnet_variables_from_jax
    loss_fn = R.make_fused_loss_fn(_model(), mesh=mesh) if fused else \
        R.make_loss_fn(_model(), mesh=mesh)
    b = TrainStepBuilder(
        loss_fn=loss_fn, device="cpu", mesh=mesh,
        optimizer=lambda p: recipe.make_optimizer(p, **OPT)[0])
    tp, ts = resnet_variables_from_jax(params, stats)
    state = b.init(lambda rng: (tp, {"batch_stats": ts}), None)
    step = b.build()
    placed = b.place_batch(batch)
    hist = []
    for _ in range(STEPS):
        state, m = step(state, placed)
        hist.append({k: float(v) for k, v in m.items()})
    return {"hist": hist,
            "params": {k: p.detach().numpy().copy()
                       for k, p in state.params.items()},
            "stats": {k: v.numpy().copy() for k, v in
                      state.variables["batch_stats"].items()},
            "rows": tuple(placed["images"].shape)}


def _seq_rank(rank, env, params, stats, batch):
    ctx = bootstrap.initialize(env, device="cpu")
    out = {arm: _train(ctx.mesh, arm == "fused", params, stats, batch)
           for arm in ("default", "fused")}
    out["worker"] = {}
    for fused in (False, True):
        r = worker.train(workload="resnet50", ctx=ctx, steps=2,
                         global_batch=4, device="cpu", sync_every=1,
                         handle_sigterm=False,
                         workload_kwargs={"image_size": SIZE,
                                          "num_classes": CLASSES,
                                          "fused": fused})
        out["worker"][fused] = (r.steps, r.final_metrics["loss"])
    bootstrap.shutdown(ctx)
    return out


def _data_seq_rank(rank, world, params, stats, batch):
    import torch.distributed as dist
    mesh = build_mesh(ShardingSpec(**DATA_SEQ))
    out = _train(mesh, False, params, stats, batch)
    out["bn_ranks"] = dist.get_process_group_ranks(R.replica_group(mesh))
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def seq_runs(inputs):
    return spawn_contract(_seq_rank, 2, *inputs, sharding=SEQ2)


@pytest.fixture(scope="module")
def one_runs(inputs):
    """The port's one process on the whole batch, each path."""
    return {arm: _train(None, arm == "fused", *inputs)
            for arm in ("default", "fused")}


@pytest.fixture(scope="module")
def data_seq_runs(inputs):
    return spawn(_data_seq_rank, 4, *inputs)


def _jax_run(mesh_dict, params, stats, batch) -> tuple:
    import jax
    import jax.numpy as jnp
    from kubeflow_tpu.api.trainingjob import ShardingSpec as JSpec
    from kubeflow_tpu.models import resnet as JR
    from kubeflow_tpu.parallel.mesh import build_mesh as j_build_mesh
    from kubeflow_tpu.runtime.recipe import make_optimizer as j_make
    from kubeflow_tpu.runtime.trainstep import TrainStepBuilder as JBuilder
    from kubeflow_tpu_torch.models.convert import flatten_params
    n = int(np.prod(list(mesh_dict.values())))
    mesh = j_build_mesh(JSpec(**{"data": 1, **mesh_dict}),
                        jax.devices()[:n])
    model = JR.make_resnet(DEPTH, num_classes=CLASSES, width=WIDTH,
                           dtype=jnp.float32)
    opt = dict(OPT)
    b = JBuilder(mesh=mesh, loss_fn=JR.make_loss_fn(model),
                 optimizer=j_make(opt.pop("name"), **opt)[0])
    state = b.init(lambda rng: (params, {"batch_stats": stats}),
                   jax.random.PRNGKey(0))
    step = b.build()
    placed = b.place_batch(batch)
    hist = []
    for _ in range(STEPS):
        state, m = step(state, placed)
        hist.append({k: float(v) for k, v in m.items()})
    return hist, flatten_params(jax.device_get(state.params)), \
        flatten_params(jax.device_get(state.variables["batch_stats"]))


def _close(got: dict, want: dict, what: str, floor: float) -> None:
    """Each leaf within RTOL of the larger of its largest magnitude and
    ``floor``."""
    assert set(got) == set(want), what
    for n, w in want.items():
        err = float(np.abs(got[n] - w).max())
        assert err <= RTOL * max(float(np.abs(w).max()), floor), \
            (what, n, err)


def _check(ranks: list, ref: tuple, floor: float = 0.0) -> None:
    hist, params, stats = ref
    assert all(m["grad_norm"] > OPT["grad_clip"] for m in hist)
    for r, out in enumerate(ranks):
        for i, (want, got) in enumerate(zip(hist, out["hist"])):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(
                    got[k], want[k], rtol=RTOL,
                    err_msg=f"rank {r} step {i} {k}")
        _close(out["params"], params, f"rank {r} params", floor)
        _close(out["stats"], stats, f"rank {r} batch_stats", floor)


def test_local_rows_keep_the_images_whole():
    """On {sequence 2} a rank cuts dimension 1 of the rank-2 tokens to its
    chunk and adds ``next_tokens``; the images [B, H, W, C] and the labels
    keep their whole extent, with no ``next_images``: the JAX package's
    ``place_batch``."""
    batch = {"images": np.zeros((4, 32, 32, 3), np.float32),
             "labels": np.arange(4, dtype=np.int32),
             "tokens": np.arange(32, dtype=np.int32).reshape(4, 8)}
    for rank in (0, 1):
        mesh = Mesh(shape={**dict.fromkeys(MESH_AXES, 1), "sequence": 2},
                    rank=rank)
        b = TrainStepBuilder(loss_fn=None, optimizer=None, device="cpu",
                             mesh=mesh)
        got = b.local_rows(batch)
        assert set(got) == {"images", "labels", "tokens", "next_tokens"}
        assert got["images"].shape == (4, 32, 32, 3)
        np.testing.assert_array_equal(got["labels"], batch["labels"])
        np.testing.assert_array_equal(got["tokens"],
                                      batch["tokens"][:, 4 * rank:
                                                      4 * rank + 4])


def test_default_path_on_sequence2_matches_jax(seq_runs, inputs):
    _check([r["default"] for r in seq_runs], _jax_run(SEQ2, *inputs),
           JAX_FLOOR)


def test_default_path_on_data2_sequence2_matches_jax(data_seq_runs, inputs):
    """Each data shard's 4 rows are whole on both of its sequence ranks;
    BatchNorm's statistics over the global batch of 8."""
    for out in data_seq_runs:
        assert out["rows"] == (BATCH // 2, SIZE, SIZE, 3)
    _check(data_seq_runs, _jax_run(DATA_SEQ, *inputs), JAX_FLOOR)


def test_fused_path_on_sequence2_matches_one_process(seq_runs, one_runs):
    """K4's plain version on the whole images of every sequence rank: the
    one process's losses, grad norms, params and running statistics."""
    one = one_runs["fused"]
    ref = (one["hist"], one["params"], one["stats"])
    _check([r["fused"] for r in seq_runs], ref)


def test_gradient_is_counted_once(seq_runs, one_runs):
    """Every sequence rank's backward is the whole gradient and the step
    sums every gradient over the axis: the loss's backward enters it
    divided by the axis's size, so the first step's reduced norm is the
    one process's, not twice it, on both paths."""
    for arm in ("default", "fused"):
        one = one_runs[arm]["hist"][0]["grad_norm"]
        for out in seq_runs:
            np.testing.assert_allclose(out[arm]["hist"][0]["grad_norm"],
                                       one, rtol=1e-6)


def test_batchnorm_covers_the_data_group_only(data_seq_runs):
    """On {data 2, sequence 2} (row-major: rank = 2·data + sequence) the
    BatchNorm sums and the fused moments' mean run over the ranks of the
    rank's own sequence coordinate that differ in data, never the world
    (which would count every row twice)."""
    assert [r["bn_ranks"] for r in data_seq_runs] == [[0, 2], [1, 3],
                                                      [0, 2], [1, 3]]


def test_worker_trains_resnet_on_sequence2(seq_runs):
    """``worker.train`` from the contract env with resnet50 at 32 px,
    default and fused: 2 steps each, the same loss on both ranks."""
    assert seq_runs[0]["worker"] == seq_runs[1]["worker"]
    for fused, (steps, loss) in seq_runs[0]["worker"].items():
        assert steps == 2 and np.isfinite(loss), fused
