"""K6 (the fused inference bottleneck) and the fused eval forward: the
port's plain versions against the JAX package's Pallas kernel.

On the CPU the port's block runs its plain version
(``fused_bottleneck_eval_plain``); the JAX side runs its Pallas kernel in
interpret mode, as tests/test_ops.py does. Inputs come from
``numpy.random.default_rng``:

- the block at test_ops.py's three cases (Cin 16 → Cout 32 with a
  projection, batch tile 2; 32 → 32 identity, tiles 1 and 4), x (4, 8, 8,
  Cin), Cmid 8. f32 within 1e-5, the JAX test's bar (the same arithmetic
  summed in another order). bf16 within one bf16 step of the JAX kernel's
  output, |d| <= 2^-7 |ref|: both round h1, h2, h3, the projection and the
  residual sum at the same points, so only an f32 sum taken in another
  order that lands on the other side of a rounding boundary can move a
  value, by one step.
- ``fold_block`` against the JAX ``fold_block`` on the same variables,
  within 1e-6 (one f32 rsqrt, product and difference each).
- ``fused_eval_apply`` (resnet50, 10 classes, 32 px, batch 4) against the
  JAX one, on non-trivial variables (BN scales 1 + N(0, 0.1), biases and
  running means N(0, 0.1), variances U(0.5, 1.5): at init the last BN of
  every block has scale 0, which would hide conv3): logits within the JAX
  test's 2e-2 (rtol and atol) and argmax equal; against the port's
  ``ResNet.apply(train=False)`` within 2e-2 of the largest logit (stated
  at the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import resnet as JR
from kubeflow_tpu.ops import fused_block as J
from kubeflow_tpu_torch.models import resnet as R
from kubeflow_tpu_torch.models.convert import (fused_block_weights_from_jax,
                                               resnet_variables_from_jax)
from kubeflow_tpu_torch.ops import fused_block as T
from tests.test_torch_resnet import numpy_variables

CASES = [(16, 32, True, 2), (32, 32, False, 1), (32, 32, False, 4)]
BF16_STEP = 2.0 ** -7


def _weights(rng, cin, cmid, cout, proj) -> J.FusedBlockWeights:
    """test_ops.py's block weights: N(0, 0.1), scales near 1."""
    def arr(*s):
        return rng.normal(0, 0.1, s).astype(np.float32)

    kw = dict(wp=arr(cin, cout), sp=arr(cout) + 1, bp=arr(cout)) \
        if proj else {}
    return J.FusedBlockWeights(
        w1=arr(cin, cmid), s1=arr(cmid) + 1, b1=arr(cmid),
        w2=arr(3, 3, cmid, cmid), s2=arr(cmid) + 1, b2=arr(cmid),
        w3=arr(cmid, cout), s3=arr(cout) + 1, b3=arr(cout), **kw)


def _pair(cin, cout, proj, seed=0):
    rng = np.random.default_rng(seed)
    w = _weights(rng, cin, 8, cout, proj)
    x = rng.normal(0, 1, (4, 8, 8, cin)).astype(np.float32)
    return x, w, fused_block_weights_from_jax(w)


@pytest.mark.parametrize("cin,cout,proj,bt", CASES)
def test_plain_matches_jax_kernel_f32(cin, cout, proj, bt):
    x, jw, tw = _pair(cin, cout, proj)
    want = np.asarray(J.fused_bottleneck_eval(jnp.asarray(x), jw,
                                              block_bt=bt))
    got = T.fused_bottleneck_eval(torch.from_numpy(x), tw, block_bt=bt)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the executable specs agree too, and the kernel's f32 function is the
    # spec's (no bf16 rounding in f32)
    spec = np.asarray(J.reference_bottleneck_eval(jnp.asarray(x), jw))
    np.testing.assert_allclose(
        T.reference_bottleneck_eval(torch.from_numpy(x), tw).numpy(), spec,
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), spec, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,cout,proj,bt", CASES)
def test_plain_matches_jax_kernel_bf16(cin, cout, proj, bt):
    """The rounding points: within one bf16 step of the Pallas kernel,
    where the JAX spec (h3 + res kept in f32) is further away."""
    x, jw, tw = _pair(cin, cout, proj, seed=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(J.fused_bottleneck_eval(xb, jw, block_bt=bt),
                      np.float32)
    got = T.fused_bottleneck_eval(
        torch.from_numpy(x).to(torch.bfloat16), tw, block_bt=bt)
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - want)
    assert (d <= BF16_STEP * np.abs(want)).all(), d.max()
    # the spec is not the kernel's plain version: it rounds once, at the end
    spec = T.reference_bottleneck_eval(
        torch.from_numpy(x).to(torch.bfloat16), tw).float().numpy()
    assert np.abs(spec - want).max() > d.max()


def test_block_bt_changes_nothing_and_is_checked():
    x, _, tw = _pair(32, 32, False)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ref = T.fused_bottleneck_eval(xt, tw)
    for bt in (1, 2, 4):
        assert torch.equal(T.fused_bottleneck_eval(xt, tw, block_bt=bt), ref)
    with pytest.raises(ValueError, match="must divide batch"):
        T.fused_bottleneck_eval(xt, tw, block_bt=3)
    # the JAX package's default tile rule, as a function of the signature
    for n, h, cin, cmid, cout in ((4, 8, 32, 8, 32), (64, 56, 64, 64, 256),
                                  (64, 14, 1024, 256, 1024), (6, 7, 16, 8,
                                                              32)):
        per_image = h * h * ((cin + cout) * 2 + cmid * 12)
        bt = max(1, int((6 * 2 ** 20) // per_image))
        while n % bt:
            bt -= 1
        assert T.default_block_bt(n, h, h, cin, cmid, cout) == bt


def test_missing_projection_rejected():
    _, _, tw = _pair(16, 32, False)
    with pytest.raises(ValueError, match="projection"):
        T.fused_bottleneck_eval(torch.zeros((2, 8, 8, 16)), tw)


@pytest.mark.parametrize("block", ["stage1_block1", "stage1_block2",
                                   "stage3_block4"])
def test_fold_block_matches_jax(block):
    params, stats = numpy_variables(50, 32)
    jw = J.fold_block(params[block], stats[block])
    tp, ts = resnet_variables_from_jax(params, stats)
    tw = T.fold_block(R._block_params(tp, block), R._block_params(ts, block))
    for f in ("w1", "s1", "b1", "w2", "s2", "b2", "w3", "s3", "b3", "wp",
              "sp", "bp"):
        a, b = getattr(tw, f), getattr(jw, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6, err_msg=f)
    assert (tw.wp is not None) == (block == "stage1_block1")


@pytest.fixture(scope="module")
def resnet50_case():
    params, stats = numpy_variables(50, 32, seed=3)
    x = np.random.default_rng(4).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JR.fused_eval_apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    tp, ts = resnet_variables_from_jax(params, stats)
    return tp, ts, torch.from_numpy(x), want


def test_fused_eval_apply_matches_jax(resnet50_case):
    tp, ts, x, want = resnet50_case
    with torch.no_grad():
        got = R.fused_eval_apply({"params": tp, "batch_stats": ts}, x)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)
    assert (got.numpy().argmax(-1) == want.argmax(-1)).all()


def test_fused_eval_apply_matches_default_path(resnet50_case):
    """The served path's function, rounded at other places (the folded
    affine against BN's (x - m)·(rsqrt(v + eps)·γ) + β, the pool in f32
    against bf16) through 50 bf16 layers: within 2e-2 of the largest
    logit, where the JAX package's own two paths differ by 0.8% of it on
    these variables."""
    tp, ts, x, _ = resnet50_case
    with torch.no_grad():
        fused = R.fused_eval_apply({"params": tp, "batch_stats": ts}, x,
                                   block_bt=2)
        default = R.resnet50(num_classes=10).apply(tp, ts, x, train=False)
    err = (fused - default).abs().max().item()
    assert err <= 2e-2 * default.abs().max().item(), err
    assert torch.equal(fused.argmax(-1), default.argmax(-1))


def test_xla_block_eval_matches_jax():
    """A strided block (stage2_block1: 56 → 28 at 224 px; 8 → 4 here) at
    f32 through PyTorch convs and folded BN, within 1e-5 of the largest
    value."""
    params, stats = numpy_variables(50, 32, seed=5)
    x = np.random.default_rng(6).standard_normal(
        (2, 8, 8, 256)).astype(np.float32)
    name = "stage2_block1"
    want = np.asarray(JR._xla_block_eval(jnp.asarray(x), params[name],
                                         stats[name], 2, dtype=jnp.float32))
    tp, ts = resnet_variables_from_jax(params, stats)
    got = R._xla_block_eval(torch.from_numpy(x), R._block_params(tp, name),
                            R._block_params(ts, name), 2,
                            dtype=torch.float32)
    assert got.shape == want.shape == (2, 4, 4, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_fused_eval_apply_refuses_basic_blocks():
    with pytest.raises(ValueError, match="bottleneck"):
        R.fused_eval_apply({"params": {}, "batch_stats": {}},
                           torch.zeros((1, 32, 32, 3)), depth=18)
