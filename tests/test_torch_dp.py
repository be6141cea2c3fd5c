"""Data-parallel training across processes: the port's sharded (ZeRO-2)
and replicated updates on gloo ranks against the JAX package's
``TrainStepBuilder`` on a ``data = N`` mesh of the conftest's 8 virtual
devices.

Each case spawns N CPU ranks (``torch.multiprocessing``, a free port, a
timeout of its own on every join); the ranks import the port only, JAX is
imported inside the test functions. Inputs are numpy from a seed; every
rank reads the same global batch and keeps its block of rows.

The cases follow ``tests/test_weight_update_sharding.py``: the linear
spec with the 0.01 clip active every step (a shard-local norm would
diverge) and SGD momentum, 5 steps, at N = 2 and 4, port sharded, port
replicated and JAX sharded within 1e-5 (loss and grad norm relative, the
loss being about 170 where f32 resolves 1.5e-5; params absolute); the batch-statistics model takes
the BN-state strategy and matches; each rank holds 1/N of the moments;
the per-leaf dimension choice is ``weight_update_spec``'s. Beyond them:
the tiny LM with fused_adam and the clip active (the bars of
``tests/test_torch_trainstep.py``) and LARS under the sharded update.
ResNet's two paths over 2 ranks are in ``tests/test_torch_dp_resnet.py``.
"""

import socket
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from kubeflow_tpu_torch.api.trainingjob import ShardingSpec
from kubeflow_tpu_torch.parallel import collectives
from kubeflow_tpu_torch.parallel import sharding_rules as TR
from kubeflow_tpu_torch.parallel.mesh import build_mesh
from kubeflow_tpu_torch.runtime import recipe
from kubeflow_tpu_torch.runtime.trainstep import TrainStepBuilder

JOIN_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, queue, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        try:
            queue.put((rank, fn(rank, world, *args), None))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the test
        queue.put((rank, None, traceback.format_exc()))


def spawn(fn, world: int, *args) -> list:
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; the results by
    rank. A rank that raises, or outlasts the timeout, fails the test."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, queue, args))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, out, err = queue.get(timeout=JOIN_TIMEOUT_S)
            if err:
                errors.append(f"rank {rank}:\n{err}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    assert not errors, "\n".join(errors)
    return [results[r] for r in range(world)]


# -- the linear spec ------------------------------------------------------------

DIN, DOUT, ROWS = 16, 8, 32


def linear_params(seed: int = 0) -> dict:
    """w (16, 8) shards dim 0, c (3, 8) dim 1 (3 does not divide), s (3,)
    has no divisible dimension and stays replicated."""
    rs = np.random.RandomState(seed)
    return {"w": (rs.randn(DIN, DOUT) * 3.0).astype(np.float32),
            "b": np.zeros((DOUT,), np.float32),
            "c": (rs.randn(3, DOUT) * 0.5).astype(np.float32),
            "s": rs.randn(3).astype(np.float32)}


def linear_batch(seed: int = 0) -> dict:
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(ROWS, DIN).astype(np.float32),
            "y": rs.randn(ROWS, DOUT).astype(np.float32)}


def port_linear_loss(params, variables, batch, rng):
    y = batch["x"] @ params["w"] + params["b"] + \
        params["c"].mean(0) * params["s"].sum()
    return torch.mean((y - batch["y"]) ** 2), {}


def _port_run(rank, world, mode, loss_fn, params, variables, batch, steps,
              opt):
    mesh = build_mesh(ShardingSpec(data=world))
    b = TrainStepBuilder(
        loss_fn=loss_fn, device="cpu", weight_update=mode, mesh=mesh,
        optimizer=lambda p: recipe.make_optimizer(p, **opt)[0])
    state = b.init(lambda rng: (params, variables), None)
    step = b.build()
    placed = b.place_batch(batch)
    hist = []
    for _ in range(steps):
        state, m = step(state, placed)
        hist.append({k: np.asarray(v.detach()) for k, v in m.items()})
    moment_bytes = sum(t.numel() * t.element_size()
                       for st in state.opt_state.inner.state.values()
                       if isinstance(st, dict)
                       for t in st.values()
                       if isinstance(t, torch.Tensor) and t.dim() > 0)
    return {"hist": hist, "strategy": b.strategy,
            "params": {k: p.detach().numpy().copy()
                       for k, p in state.params.items()},
            "variables": {c: {k: v.numpy().copy() for k, v in vs.items()}
                          for c, vs in state.variables.items()},
            "moment_bytes": moment_bytes,
            "staged": dict(collectives.host_staged)}


def _port_modes(rank, world, modes, *args):
    return {mode: _port_run(rank, world, mode, *args) for mode in modes}


def spawn_modes(n: int, modes: tuple, *args) -> dict:
    """``_port_run`` for each of ``modes`` in one spawn of ``n`` ranks:
    {mode: [rank 0's result, ...]}."""
    ranks = spawn(_port_modes, n, modes, *args)
    return {m: [r[m] for r in ranks] for m in modes}


SGD_CLIP = dict(name="momentum", learning_rate=0.1, momentum=0.9,
                grad_clip=0.01)


def _jax_run(loss_fn, params, variables, batch, steps, opt, n, mode):
    import jax
    from kubeflow_tpu.api.trainingjob import ShardingSpec as JSpec
    from kubeflow_tpu.parallel.mesh import build_mesh as j_build_mesh
    from kubeflow_tpu.runtime.trainstep import TrainStepBuilder as JBuilder
    mesh = j_build_mesh(JSpec(data=n), jax.devices()[:n])
    b = JBuilder(mesh=mesh, loss_fn=loss_fn, optimizer=opt,
                 weight_update=mode)
    state = b.init(lambda rng: (params, variables), jax.random.PRNGKey(0))
    step = b.build()
    placed = b.place_batch(batch)
    hist = []
    for _ in range(steps):
        state, m = step(state, placed)
        hist.append({k: np.asarray(v) for k, v in m.items()})
    return hist, jax.device_get(state.params), \
        jax.device_get(state.variables)


def _jax_linear_loss():
    import jax.numpy as jnp

    def loss_fn(params, variables, batch, rng):
        y = batch["x"] @ params["w"] + params["b"] + \
            params["c"].mean(0) * params["s"].sum()
        return jnp.mean((y - batch["y"]) ** 2), {}

    return loss_fn


def _jax_sgd_clip():
    import optax
    return optax.chain(optax.clip_by_global_norm(0.01),
                       optax.sgd(0.1, momentum=0.9))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_and_replicated_match_jax_with_the_clip_active(n):
    params, batch = linear_params(), linear_batch()
    j_hist, j_params, _ = _jax_run(_jax_linear_loss(), params, {}, batch,
                                   5, _jax_sgd_clip(), n, "sharded")
    assert all(float(m["grad_norm"]) > 0.01 for m in j_hist)  # clip acts
    runs = spawn_modes(n, ("sharded", "replicated"), port_linear_loss,
                       params, {}, batch, 5, SGD_CLIP)
    for mode, ranks in runs.items():
        for r, out in enumerate(ranks):
            for i, (jm, tm) in enumerate(zip(j_hist, out["hist"])):
                for k in ("loss", "grad_norm"):
                    np.testing.assert_allclose(
                        tm[k], jm[k], rtol=1e-5,
                        err_msg=f"{mode} rank {r} step {i} {k}")
            for k in params:
                np.testing.assert_allclose(out["params"][k], j_params[k],
                                           rtol=0, atol=1e-5,
                                           err_msg=f"{mode} rank {r} {k}")
            assert out["staged"] == dict.fromkeys(collectives.OPS, 0)
    sharded = runs["sharded"]
    assert {o["strategy"] for o in sharded} == {"zero2-explicit"}
    # the integrity probe: every rank's post-update param sqnorm agrees
    for m in sharded[0]["hist"]:
        probe = m["param_sqnorm_replicas"]
        assert probe.shape == (n,)
        np.testing.assert_allclose(probe, probe[0], rtol=1e-6)
    assert "param_sqnorm_replicas" not in runs["replicated"][0]["hist"][0]


def test_each_rank_holds_one_nth_of_the_moments():
    """Adam's mu and nu: 1/N of each sharded leaf's bytes per rank, the
    replicated leaf whole (the bytes JAX's addressable shards hold)."""
    n = 4
    params, batch = linear_params(1), linear_batch(1)
    opt = dict(name="adam", learning_rate=1e-3, grad_clip=1.0)
    runs = spawn_modes(n, ("sharded", "replicated"), port_linear_loss,
                       params, {}, batch, 1, opt)
    sharded, replicated = runs["sharded"], runs["replicated"]
    full = sum(a.nbytes for a in params.values())
    rep = params["s"].nbytes
    for out in sharded:
        assert out["moment_bytes"] == 2 * ((full - rep) // n + rep)
    for out in replicated:
        assert out["moment_bytes"] == 2 * full

    import jax
    import optax
    from kubeflow_tpu.api.trainingjob import ShardingSpec as JSpec
    from kubeflow_tpu.parallel.mesh import build_mesh as j_build_mesh
    from kubeflow_tpu.runtime.trainstep import TrainStepBuilder as JBuilder
    b = JBuilder(mesh=j_build_mesh(JSpec(data=n), jax.devices()[:n]),
                 loss_fn=_jax_linear_loss(), optimizer=optax.adam(1e-3),
                 weight_update="sharded")
    state = b.init(lambda rng: (params, {}), jax.random.PRNGKey(0))
    per_device = {}
    for leaf in jax.tree.leaves(state.opt_state):
        if getattr(leaf, "ndim", 0) == 0:
            continue
        for s in leaf.addressable_shards:
            per_device[s.device] = per_device.get(s.device, 0) + \
                s.data.nbytes
    assert set(per_device.values()) == {sharded[0]["moment_bytes"]}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape", [(16, 8), (3, 8), (3,), (), (6, 4, 2),
                                   (5, 7, 4), (0, 4), (2, 3)])
def test_leaf_dimension_choice_equals_weight_update_spec(shape, n):
    import jax
    from jax.sharding import PartitionSpec as P
    from kubeflow_tpu.api.trainingjob import ShardingSpec as JSpec
    from kubeflow_tpu.parallel.mesh import build_mesh as j_build_mesh
    from kubeflow_tpu.parallel.sharding_rules import weight_update_spec
    mesh = j_build_mesh(JSpec(data=n), jax.devices()[:n])
    spec = weight_update_spec(P(), shape, mesh, ("data",))
    want = None if spec is None else next(
        i for i, e in enumerate(spec) if e is not None)
    got = TR.weight_update_spec((), shape, {"data": n}, ("data",))
    assert (None if got is None else got.index("data")) == want


# -- the batch-statistics model ---------------------------------------------------

def port_stat_loss(params, variables, batch, rng):
    """A batch-mean statistic EMA'd into the variables, over the global
    batch: the rows' sum summed across the ranks (global_sum)."""
    y = batch["x"] @ params["w"]
    group = dist.group.WORLD if dist.is_initialized() and \
        dist.get_world_size() > 1 else None
    n = y.shape[0] * (dist.get_world_size() if group is not None else 1)
    mean = collectives.global_sum(y.sum(0), group) / n
    stat = 0.9 * variables["v"]["stat"] + 0.1 * mean
    loss = torch.mean((y - batch["y"] + stat) ** 2)
    return loss, {"variables": {"v": {"stat": stat.detach()}}}


def test_batch_stats_model_takes_the_bn_strategy_and_matches():
    import jax.numpy as jnp
    rs = np.random.RandomState(1)
    params = {"w": rs.randn(DIN, DOUT).astype(np.float32)}
    variables = {"stat": np.zeros((DOUT,), np.float32)}
    batch = {"x": rs.randn(ROWS, DIN).astype(np.float32),
             "y": rs.randn(ROWS, DOUT).astype(np.float32)}

    def j_loss(params, variables, batch, rng):
        y = batch["x"] @ params["w"]
        stat = 0.9 * variables["stat"] + 0.1 * jnp.mean(y, axis=0)
        return jnp.mean((y - batch["y"] + stat) ** 2), \
            {"variables": {"stat": stat}}

    j_hist, j_params, j_vars = _jax_run(j_loss, params, variables, batch,
                                        3, _jax_sgd_clip(), 2, "sharded")
    ranks = spawn(_port_run, 2, "sharded", port_stat_loss, params,
                  {"v": variables}, {"x": batch["x"], "y": batch["y"]}, 3,
                  SGD_CLIP)
    for out in ranks:
        assert out["strategy"] == "zero2-gspmd"
        for i, (jm, tm) in enumerate(zip(j_hist, out["hist"])):
            np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5,
                                       err_msg=f"step {i}")
        np.testing.assert_allclose(out["params"]["w"], j_params["w"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(out["variables"]["v"]["stat"],
                                   j_vars["stat"], rtol=0, atol=1e-6)
    # without variables the same builder reports the explicit strategy
    b = TrainStepBuilder(loss_fn=None, optimizer=None, device="cpu",
                         weight_update="sharded")
    assert b.update_strategy() == "replicated"   # one replica


# -- the LM with fused_adam, LARS ---------------------------------------------------

LM_TINY = dict(vocab_size=256, num_layers=2, embed_dim=64, num_heads=4,
               head_dim=16, mlp_dim=128, max_seq_len=128)
LM_SEQ, LM_BATCH, LM_STEPS = 32, 4, 3
LM_OPT = dict(learning_rate=1e-3, schedule="constant", total_steps=LM_STEPS,
              grad_clip=0.5)


def _port_lm(rank, world, params, tokens, mode, kernels):
    from kubeflow_tpu_torch.models import transformer as T
    from kubeflow_tpu_torch.models.convert import transformer_params_from_jax
    spec = T.workload_spec(T.TransformerConfig(
        attention="flash", dtype=torch.float32, **LM_TINY), LM_SEQ)
    return _port_run(rank, world, mode, spec.loss_fn,
                     transformer_params_from_jax(params), {},
                     {"tokens": tokens}, LM_STEPS,
                     dict(name="adam", kernels=kernels, **LM_OPT))


def test_lm_with_fused_adam_sharded_matches_jax():
    """The tiny LM (flash attention, fused_adam, the clip at 0.5 acting
    on every step) over 2 ranks of 2 rows, sharded, against the JAX
    package's sharded step on a data = 2 mesh (its Pallas kernels in
    interpret mode), at the bars of tests/test_torch_trainstep.py: loss,
    grad_norm and perplexity within rtol 1e-4 per step (perplexity is
    the ranks' mean of exp(loss) on both sides), params within 1e-5 in
    all but 0.1% of elements and within 3 x lr everywhere."""
    import jax.numpy as jnp
    from kubeflow_tpu.models import transformer as J
    from kubeflow_tpu.runtime.recipe import make_optimizer as j_make
    from kubeflow_tpu_torch.models.convert import flatten_params
    from tests.test_torch_trainstep import numpy_params
    params = numpy_params(seed=11)
    tokens = np.random.default_rng(12).integers(
        0, LM_TINY["vocab_size"], (LM_BATCH, LM_SEQ)).astype(np.int32)
    spec = J.workload_spec(J.TransformerConfig(
        attention="flash", dtype=jnp.float32, **LM_TINY), LM_SEQ)
    j_hist, j_params, _ = _jax_run(
        spec.loss_fn, params, {}, {"tokens": tokens}, LM_STEPS,
        j_make("adam", kernels="fused_adam", **LM_OPT)[0], 2, "sharded")
    assert all(float(m["grad_norm"]) > 0.5 for m in j_hist)  # clip acts
    j_flat = flatten_params(j_params)
    ranks = spawn(_port_lm, 2, params, tokens, "sharded", "fused_adam")
    for r, out in enumerate(ranks):
        assert out["strategy"] == "zero2-explicit"
        for i, (jm, tm) in enumerate(zip(j_hist, out["hist"])):
            for k in ("loss", "grad_norm", "perplexity"):
                np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4,
                                           err_msg=f"rank {r} step {i} {k}")
        diff = np.concatenate([np.abs(out["params"][n] - j_flat[n]).ravel()
                               for n in j_flat])
        assert diff.max() <= LM_STEPS * LM_OPT["learning_rate"], diff.max()
        assert (diff > 1e-5).mean() <= 1e-3, np.sort(diff)[-10:]
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(v, ranks[1]["params"][k], err_msg=k)


LARS_OPT = dict(name="lars", learning_rate=0.1, weight_decay=1e-4,
                grad_clip=1.0)


def test_lars_sharded_matches_replicated_and_optax():
    """LARS's per-tensor trust ratios over shards: ‖p‖ and ‖u‖
    all-reduced per tensor (b starts at 0: ratio 1), weight decay on the
    rank > 1 leaves; 4 steps over 2 ranks, sharded against replicated
    (1e-6) and against optax.lars in the JAX package's recipe on a
    data = 2 mesh (loss and grad norm rtol 1e-5, params 1e-5)."""
    from kubeflow_tpu.runtime.recipe import make_optimizer as j_make
    params, batch = linear_params(2), linear_batch(2)
    j_hist, j_params, _ = _jax_run(
        _jax_linear_loss(), params, {}, batch, 4,
        j_make(**LARS_OPT)[0], 2, "sharded")
    runs = spawn_modes(2, ("sharded", "replicated"), port_linear_loss,
                       params, {}, batch, 4, LARS_OPT)
    for r in range(2):
        sh, rep = runs["sharded"][r], runs["replicated"][r]
        for k in params:
            np.testing.assert_allclose(sh["params"][k], rep["params"][k],
                                       rtol=0, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(sh["params"][k], j_params[k],
                                       rtol=0, atol=1e-5, err_msg=k)
        for i, (jm, tm) in enumerate(zip(j_hist, sh["hist"])):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5,
                                           err_msg=f"step {i} {k}")
    moved = np.abs(runs["sharded"][0]["params"]["w"] - params["w"]).max()
    assert moved > 1e-4   # the update did act


def test_each_rank_copies_only_its_rows_of_the_global_batch(tmp_path):
    """Every rank reads the same seeded global batch stream from the
    records and stages only its block of rows (the worker's
    ``DevicePrefetcher(map(local_rows, ...), place_local)``): rank r's
    batches are rows 4r..4r+3 of the one-process batches, byte for byte,
    so two ranks together see exactly the samples of one."""
    from kubeflow_tpu_torch.data import imagenet as TI
    from kubeflow_tpu_torch.data.device_prefetch import DevicePrefetcher
    from kubeflow_tpu_torch.parallel.mesh import MESH_AXES, Mesh
    rng = np.random.default_rng(3)
    TI.write_shards(str(tmp_path), rng.integers(0, 256, (24, 32, 32, 3),
                                                dtype=np.uint8),
                    rng.integers(0, 10, 24), shard_records=8, num_classes=10)

    def batches(n):
        src = TI.ImageNetSource(str(tmp_path), batch_size=8, output="uint8")
        try:
            it = src.batches(seed=5)
            return [next(it) for _ in range(n)]
        finally:
            src.close()

    whole = batches(3)
    shards = []
    for rank in range(2):
        # a stand-in group: nothing here calls a collective
        mesh = Mesh(shape={**dict.fromkeys(MESH_AXES, 1), "data": 2},
                    group=object(), rank=rank)
        b = TrainStepBuilder(loss_fn=None, optimizer=None, device="cpu",
                             mesh=mesh)
        it = DevicePrefetcher(map(b.local_rows, iter(batches(3))),
                              b.place_local, depth=2)
        shards.append([next(it) for _ in range(3)])
        it.close()
    for i, full in enumerate(whole):
        for k in ("images", "labels"):
            parts = [s[i][k].numpy() for s in shards]
            assert all(p.shape[0] == 4 for p in parts)
            assert np.concatenate(parts).tobytes() == \
                np.asarray(full[k]).tobytes()
