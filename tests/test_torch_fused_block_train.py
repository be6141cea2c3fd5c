"""K4 and K5 (the fused ghost-BN bottleneck, batch-tiled and spatial):
the port's plain versions against the JAX package's Pallas kernels, and
the routing that defines the ghost batch.

On the CPU the port's blocks run their plain versions
(``reference_bottleneck_train``, ``reference_bottleneck_train_spatial``)
and their autograd gradients; the JAX side runs its Pallas kernels in
interpret mode (its custom_vjp forward and backward), as
tests/test_ops.py does. Inputs come from ``numpy.random.default_rng``,
at test_ops.py's sizes and with its bars: forward values and all 8
statistics within rtol/atol 1e-5, and the gradients of ``sum(sin(out))``
with respect to x and every weight within rtol 1e-3 / atol 1e-4 (f32: the
same arithmetic summed in another order; the kernel's backward formula
against autograd). ``backward_plain``, the backward kernels' own formula
that ``chip_smoke.py`` holds the CUDA backward to, is compared with the
Pallas backward directly, in f32 and in bf16.

The ghost tiles come from the JAX package's VMEM model, kept verbatim:
``fused_block_routing(50, 224)``, ``default_tile_bt`` and
``default_tile_h`` must equal the JAX package's, and its two env
overrides must act the same.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import resnet as JR
from kubeflow_tpu.ops import fused_block_train as J
from kubeflow_tpu.ops import fused_block_train_spatial as JS
from kubeflow_tpu_torch.models import resnet as R
from kubeflow_tpu_torch.models.convert import (flatten_params,
                                               resnet_variables_from_jax)
from kubeflow_tpu_torch.ops import fused_block_train as T
from kubeflow_tpu_torch.ops import fused_block_train_spatial as TS
from tests.test_torch_resnet import numpy_variables


def _params(rng, cin, cmid, cout, proj) -> dict:
    """One block's params as a flax-shaped tree of numpy arrays, made as
    tests/test_ops.py makes them."""
    def arr(*s):
        return rng.normal(0, 0.1, s).astype(np.float32)

    p = {"Conv_0": {"kernel": arr(1, 1, cin, cmid)},
         "BatchNorm_0": {"scale": arr(cmid) + 1, "bias": arr(cmid)},
         "Conv_1": {"kernel": arr(3, 3, cmid, cmid)},
         "BatchNorm_1": {"scale": arr(cmid) + 1, "bias": arr(cmid)},
         "Conv_2": {"kernel": arr(1, 1, cmid, cout)},
         "BatchNorm_2": {"scale": arr(cout) + 1, "bias": arr(cout)}}
    if proj:
        p["conv_proj"] = {"kernel": arr(1, 1, cin, cout)}
        p["norm_proj"] = {"scale": arr(cout) + 1, "bias": arr(cout)}
    return p


def _port(p: dict) -> dict:
    return {f"{m}.{k}": torch.from_numpy(v) for m, d in p.items()
            for k, v in d.items()}


def _forward_pair(rng, proj, n, spatial, tile_bt, tile_h=None):
    cin = 16 if proj else 32
    p = _params(rng, cin, 8, 32, proj)
    x = rng.normal(0, 1, (n, 8, 8, cin)).astype(np.float32)
    if spatial:
        jo, js = JS.fused_bottleneck_train_spatial(
            jnp.asarray(x), p, tile_bt=tile_bt, tile_h=tile_h)
        to, ts = TS.fused_bottleneck_train_spatial(
            torch.from_numpy(x), _port(p), tile_bt=tile_bt, tile_h=tile_h)
    else:
        jo, js = J.fused_bottleneck_train(jnp.asarray(x), p, tile_bt=tile_bt)
        to, ts = T.fused_bottleneck_train(torch.from_numpy(x), _port(p),
                                          tile_bt=tile_bt)
    return (np.asarray(jo), {f"{m}.{k}": np.asarray(v)
                             for m, d in js.items() for k, v in d.items()},
            to.numpy(), {k: v.numpy() for k, v in ts.items()})


@pytest.mark.parametrize("proj", [False, True])
@pytest.mark.parametrize("spatial,n,tile_bt,tile_h", [
    (False, 8, 2, None), (True, 4, 2, 4), (True, 4, 1, 8)])
def test_forward_and_stats_match_jax_kernel(proj, spatial, n, tile_bt,
                                            tile_h):
    jo, js, to, ts = _forward_pair(np.random.default_rng(0), proj, n,
                                   spatial, tile_bt, tile_h)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    assert set(ts) == set(js) and len(ts) == (8 if proj else 6)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def _grads_pair(rng, proj, spatial, n, tile_bt, tile_h):
    cin = 16 if proj else 32
    p = _params(rng, cin, 8, 32, proj)
    wj = J.block_weights(jax.tree.map(jnp.asarray, p))
    x = rng.normal(0, 1, (n, 8, 8, cin)).astype(np.float32)

    def loss_j(x, *w):
        o, _ = (JS._fused(tile_bt, tile_h, 1e-5, x, *w) if spatial else
                J._fused(tile_bt, 1e-5, x, *w))
        return jnp.sum(jnp.sin(o))

    gj = jax.grad(loss_j, argnums=tuple(range(len(wj) + 1)))(
        jnp.asarray(x), *wj)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = [torch.from_numpy(np.array(w)).requires_grad_(True) for w in wj]
    if spatial:
        out, *_ = T.FusedBlock.apply(
            TS.fused_block_train_spatial_fwd,
            TS.fused_block_train_spatial_bwd, (tile_bt, tile_h), 1e-5, xt,
            *wt)
    else:
        out, *_ = T.FusedBlock.apply(
            T.fused_block_train_fwd, T.fused_block_train_bwd, (tile_bt,),
            1e-5, xt, *wt)
    gt = torch.autograd.grad(torch.sin(out).sum(), [xt, *wt])
    return [np.asarray(g) for g in gj], [g.numpy() for g in gt]


@pytest.mark.parametrize("proj", [False, True])
@pytest.mark.parametrize("spatial,n,tile_bt,tile_h", [
    (False, 4, 2, None), (True, 2, 1, 4), (True, 4, 2, 4)])
def test_backward_matches_jax_kernel(proj, spatial, n, tile_bt, tile_h):
    """dx and every weight gradient through the port's autograd Function
    (its plain backward on the CPU) against jax.grad through the Pallas
    backward; with two strips the seam rows and the halo terms of BN1
    count."""
    gj, gt = _grads_pair(np.random.default_rng(1), proj, spatial, n,
                         tile_bt, tile_h)
    assert len(gt) == (13 if proj else 10)
    for i, (a, b) in enumerate(zip(gt, gj)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4,
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("proj,n,tile_bt,tile_h", [
    (False, 4, 2, None), (True, 4, 2, None), (False, 2, 1, 4),
    (True, 2, 1, 4), (True, 4, 2, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_formula_matches_jax_kernel(proj, n, tile_bt, tile_h,
                                             dtype):
    """``backward_plain`` (the backward kernels' formula, rounding where
    they round) against the Pallas backward in interpret mode on the same
    x, g and weights: f32 within 1e-5 of the largest value (the same
    arithmetic summed in another order); bf16 within 2^-7 of it, two bf16
    steps, where a value summed in another order lands on the other side
    of a rounding boundary of da or dx. In f32 it also equals the autograd
    gradients of the plain forward, which tie the formula to the
    function."""
    rng = np.random.default_rng(1)
    cin = 16 if proj else 32
    wj = J.block_weights(jax.tree.map(jnp.asarray,
                                      _params(rng, cin, 8, 32, proj)))
    jdt = getattr(jnp, dtype)
    xj = jnp.asarray(rng.normal(0, 1, (n, 8, 8, cin)), jdt)
    gj = jnp.asarray(rng.normal(0, 1, (n, 8, 8, 32)), jdt)
    if tile_h is None:
        jdx, jgrads = J._pallas_bwd(xj, gj, wj, tile_bt, 1e-5)
    else:
        jdx, jgrads = JS._pallas_bwd(xj, gj, wj, tile_bt, tile_h, 1e-5)

    def port(a):
        return torch.from_numpy(np.array(a, np.float32)).to(
            getattr(torch, dtype))

    x, g = port(xj), port(gj)
    w = tuple(torch.from_numpy(np.array(a)) for a in wj)
    tiles = {"tile_bt": tile_bt, "tile_h": tile_h or 8}
    dx, grads = TS.backward_plain(x, g, w, **tiles)
    assert dx.dtype == x.dtype and len(grads) == len(w)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for i, (a, b) in enumerate(zip((dx, *grads), (jdx, *jgrads))):
        ref = np.asarray(b, np.float32)
        err = np.abs(a.float().numpy() - ref).max()
        assert err <= tol * np.abs(ref).max(), f"gradient {i}: {err}"
    if dtype == "float32":
        ref = TS.reference_bottleneck_train_spatial if tile_h else \
            T.reference_bottleneck_train
        a_dx, a_grads = T.autograd_backward(
            ref, x, g, w, **(tiles if tile_h else {"tile_bt": tile_bt}))
        for a, b in zip((dx, *grads), (a_dx, *a_grads)):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-5 * b.abs().max().item())


def test_spatial_full_height_matches_batch_tiled():
    rng = np.random.default_rng(6)
    p = _port(_params(rng, 32, 8, 32, proj=False))
    x = torch.from_numpy(rng.normal(0, 1, (4, 8, 8, 32)).astype(np.float32))
    out_s, stats_s = TS.fused_bottleneck_train_spatial(x, p, tile_bt=2,
                                                       tile_h=8)
    out_b, stats_b = T.fused_bottleneck_train(x, p, tile_bt=2)
    torch.testing.assert_close(out_s, out_b, rtol=1e-5, atol=1e-5)
    assert set(stats_s) == set(stats_b)
    for k in stats_b:
        torch.testing.assert_close(stats_s[k], stats_b[k], rtol=1e-5,
                                   atol=1e-6)


def test_ghost_stats_are_per_tile_not_per_batch():
    rng = np.random.default_rng(2)
    p = _port(_params(rng, 32, 8, 32, proj=False))
    x = torch.from_numpy(rng.normal(0, 1, (8, 8, 8, 32)).astype(np.float32))
    out_full, _ = T.fused_bottleneck_train(x, p, tile_bt=8)
    out_ghost, _ = T.fused_bottleneck_train(x, p, tile_bt=2)
    assert (out_full - out_ghost).abs().max().item() > 1e-6


def test_tile_must_divide():
    p = _port(_params(np.random.default_rng(3), 32, 8, 32, proj=False))
    with pytest.raises(ValueError, match="divide"):
        T.fused_bottleneck_train(torch.zeros(6, 8, 8, 32), p, tile_bt=4)
    with pytest.raises(ValueError, match="divide"):
        TS.fused_bottleneck_train_spatial(torch.zeros(4, 8, 8, 32), p,
                                          tile_h=3)
    with pytest.raises(ValueError, match="divide"):
        TS.fused_bottleneck_train_spatial(torch.zeros(6, 8, 8, 32), p,
                                          tile_bt=4, tile_h=4)


def test_cuda_path_refuses_what_the_kernel_does_not_take():
    """The launcher checks before it builds anything: a CPU or f32 input
    raises instead of falling back."""
    w = T.block_weights(_port(_params(np.random.default_rng(4), 32, 8, 32,
                                      proj=False)))
    with pytest.raises(ValueError, match="CUDA"):
        T.launch_block(torch.zeros(2, 8, 8, 32), w, 1, 8, 1e-5)


def test_routing_and_tiles_equal_the_jax_package():
    assert R.fused_block_routing(50, 224) == JR.fused_block_routing(50, 224)
    assert R.fused_block_routing(50, 64) == JR.fused_block_routing(50, 64)
    geoms = R.stride1_geometries(50, 224)
    assert geoms == JR.stride1_geometries(50, 224)
    assert sum(g["count"] for g in geoms) == 13
    for g in geoms:
        args = (g["h"], g["h"], g["cin"], g["cmid"], g["cout"])
        assert T.default_tile_bt(64, *args) == J.default_tile_bt(64, *args)
        assert TS.default_tile_h(*args) == JS.default_tile_h(*args)
        assert R._fused_route(*args) == JR._fused_route(*args)
    assert T.VMEM_BUDGET_BYTES == J.VMEM_BUDGET_BYTES
    assert {R.geometry_key(*a) for a in ((7, 7, 2048, 512, 2048),)} == \
        {JR.geometry_key(7, 7, 2048, 512, 2048)}


def test_env_overrides_act_the_same(tmp_path, monkeypatch):
    table = {"routes": {
        R.geometry_key(7, 7, 2048, 512, 2048): "xla",
        R.geometry_key(56, 56, 256, 64, 256): "spatial:28",
        R.geometry_key(14, 14, 1024, 256, 1024): "spatial:7"}}
    path = tmp_path / "routing.json"
    path.write_text(json.dumps(table))
    monkeypatch.setenv("KFTPU_FUSED_ROUTING_TABLE", str(path))
    pinned = R.fused_block_routing(50, 224)
    assert pinned == JR.fused_block_routing(50, 224)
    assert pinned["stage4_block2"] == "xla"
    assert pinned["stage1_block2"] == "fused-spatial(th=28)"
    monkeypatch.setenv("KFTPU_FUSED_DISABLE_SPATIAL", "1")
    assert R.fused_block_routing(50, 224) == JR.fused_block_routing(50, 224)
    assert R._fused_route(56, 56, 256, 64, 256) == ("xla", None)
    monkeypatch.delenv("KFTPU_FUSED_ROUTING_TABLE")
    off = R.fused_block_routing(50, 224)
    assert off == JR.fused_block_routing(50, 224)
    assert off["stage1_block2"] == "xla"
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    monkeypatch.setenv("KFTPU_FUSED_ROUTING_TABLE", str(bad))
    with pytest.raises(RuntimeError, match="KFTPU_FUSED_ROUTING_TABLE"):
        R.fused_block_routing(50, 224)


def test_random_block_params_shapes():
    p = R.random_block_params(torch.Generator().manual_seed(0), 64, 64, 256,
                              True)
    assert tuple(p["conv_proj.kernel"].shape) == (1, 1, 64, 256)
    assert len(T.block_weights(p)) == 12
    assert len(T.block_weights(R.random_block_params(
        torch.Generator().manual_seed(0), 256, 64, 256, False))) == 9


def _jax_fused(params, stats, tile_bt):
    """A function of (images, labels): logits, new batch_stats and the
    gradients of the cross-entropy through the JAX package's
    fused_train_apply (Pallas in interpret mode), f32, as numpy by the
    port's names. Compiled once, for both batches a test feeds it."""
    def f(p, x, labels):
        logits, new = JR.fused_train_apply(
            {"params": p, "batch_stats": stats}, x, tile_bt=tile_bt,
            dtype=jnp.float32)
        return JR.cross_entropy_loss(logits, labels), (logits, new)

    step = jax.jit(jax.value_and_grad(f, has_aux=True))

    def run(images, labels):
        (_, (logits, new)), grads = step(params, images, labels)
        return {"logits": np.asarray(logits),
                **{f"stat {k}": v for k, v in flatten_params(new).items()},
                **{f"grad {k}": v for k, v in flatten_params(grads).items()}}

    return run


@pytest.mark.parametrize("force_spatial", [False, True])
def test_fused_model_matches_jax(force_spatial, monkeypatch):
    """resnet50 @ 64 px, batch 4, tile_bt 2, f32: the port's
    fused_train_apply (plain versions on the CPU) against the JAX
    package's (its Pallas kernels in interpret mode): logits, the new
    batch_stats and every gradient, within 1e-4 of the largest value (of
    all gradients, for gradients) plus twice the JAX values' own noise
    floor, the most they move by when the images move by 2^-20 of
    themselves (at this size the gradients move by up to 6% in norm).
    64 px, not 32: at 32 px stage 4 is 1x1 and a ghost tile of 2 images
    holds 2 samples, where BN's output is ±1 whatever its input and its
    backward is rounding noise times rsqrt(var + eps) (gradients of 4e7
    that no comparison resolves). ``force_spatial`` shrinks the budget in
    both packages' modules (as tests/test_ops.py does) so that stages 1
    and 2 take the spatial kernel (th 4, two or four strips) and stages 3
    and 4 the batch-tiled one: one model through both."""
    if force_spatial:
        budget = JS._strip_bytes(4, 16, 256, 64, 256)
        for mod in (J, JS, T, TS):
            monkeypatch.setattr(mod, "VMEM_BUDGET_BYTES", budget)
    routes = R.fused_block_routing(50, 64)
    assert routes == JR.fused_block_routing(50, 64)
    assert (routes["stage2_block2"] == "fused-spatial(th=4)") == \
        force_spatial
    assert routes["stage4_block2"] == "fused-batch"
    params, stats = numpy_variables(50, 64, seed=7)
    rng = np.random.default_rng(8)
    images = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    labels = np.array([3, 1, 4, 1], np.int32)
    jax_fused = _jax_fused(params, stats, 2)
    ref = jax_fused(images, labels)
    # the noise floor: the most the same function moves when the images
    # move by 2^-20 of themselves (three draws), about what f32 rounding
    # through 50 layers does
    moved = [jax_fused((images * (1 + 2.0 ** -20 * rng.standard_normal(
        images.shape))).astype(np.float32), labels) for _ in range(3)]

    tp, ts = resnet_variables_from_jax(params, stats)
    for p in tp.values():
        p.requires_grad_(True)
    logits, new = R.fused_train_apply(
        {"params": tp, "batch_stats": ts}, torch.from_numpy(images),
        tile_bt=2, dtype=torch.float32)
    loss = R.cross_entropy_loss(logits, torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, list(tp.values()))
    got = {"logits": logits.detach().numpy(),
           **{f"stat {k}": v.numpy() for k, v in new.items()},
           **{f"grad {k}": g.numpy() for k, g in zip(tp, grads)}}
    assert set(got) == set(ref)
    g_max = max(np.abs(v).max() for k, v in ref.items()
                if k.startswith("grad"))
    for k, r in ref.items():
        floor = max(np.abs(m[k] - r).max() for m in moved)
        scale = g_max if k.startswith("grad") else np.abs(r).max()
        err = np.abs(got[k] - r).max()
        assert err <= 1e-4 * scale + 2 * floor, \
            f"{k}: max|d| {err}, noise floor {floor}, scale {scale}"


@pytest.mark.parametrize("n,tile_bt,tile_h", [(4, 2, 8), (2, 1, 4),
                                              (4, 2, 2)])
def test_ghost_statistics_layout(n, tile_bt, tile_h):
    """``ghost_stats_plain`` holds ghost g = t * S + s (batch tile t,
    strip s) at row g of each [G, C] block: BN1's means against a1 = x.w1
    averaged over each ghost's interior by hand, its rsqrt(var + eps)
    against the same, and the ghost average against the forward's
    tile-averaged statistics (f32, within 1e-5 of the largest value)."""
    rng = np.random.default_rng(4)
    w = T.block_weights(_port(_params(rng, 16, 8, 32, True)))
    x = rng.normal(0, 1, (n, 8, 8, 16)).astype(np.float32)
    ghost = TS.ghost_stats_plain(torch.from_numpy(x), w, tile_bt=tile_bt,
                                 tile_h=tile_h).numpy()
    assert ghost.shape == (T.ghost_numel(n, 8, 8, 32, tile_bt, tile_h),)
    s_count = 8 // tile_h
    g_count = (n // tile_bt) * s_count
    m1, rs1 = ghost[:g_count * 8].reshape(g_count, 8), \
        ghost[g_count * 8:2 * g_count * 8].reshape(g_count, 8)
    a1 = x @ w[0].numpy()
    for t in range(n // tile_bt):
        for s in range(s_count):
            rows = a1[t * tile_bt:(t + 1) * tile_bt,
                      s * tile_h:(s + 1) * tile_h].reshape(-1, 8)
            mean = rows.mean(0)
            var = (rows * rows).mean(0) - mean * mean
            np.testing.assert_allclose(m1[t * s_count + s], mean, rtol=0,
                                       atol=1e-5 * np.abs(mean).max())
            np.testing.assert_allclose(rs1[t * s_count + s],
                                       1 / np.sqrt(var + 1e-5), rtol=1e-5)
    _, stats = TS.reference_bottleneck_train_spatial(
        torch.from_numpy(x), w, tile_bt=tile_bt, tile_h=tile_h)
    np.testing.assert_allclose(m1.mean(0), stats[0].numpy(), rtol=0,
                               atol=1e-5 * np.abs(m1).max())


def test_plain_forward_hands_the_backward_nothing_to_carry():
    """On CPU tensors the blocks run their plain versions: the forward
    returns None for its per-ghost statistics (the plain backward's
    autograd recomputes them), and the backward takes the keyword; the
    autograd Function carries what the forward returns."""
    rng = np.random.default_rng(5)
    w = T.block_weights(_port(_params(rng, 32, 8, 32, False)))
    x = torch.from_numpy(rng.normal(0, 1, (2, 8, 8, 32)).astype(np.float32))
    g = torch.ones((2, 8, 8, 32))
    for fwd, bwd, tiles in (
            (T.fused_block_train_fwd, T.fused_block_train_bwd, (2,)),
            (TS.fused_block_train_spatial_fwd,
             TS.fused_block_train_spatial_bwd, (1, 4))):
        out, stats, ghost = fwd(x, w, *tiles)
        assert ghost is None and out.shape == x.shape and len(stats) == 8
        dx, grads = bwd(x, g, w, *tiles, ghost=ghost)
        dx2, _ = bwd(x, g, w, *tiles)
        assert torch.equal(dx, dx2) and len(grads) == 9
