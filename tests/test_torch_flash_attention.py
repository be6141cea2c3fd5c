"""The port's flash attention, forward and backward, against the JAX package's.

Inputs are made with numpy from a seed and go through the JAX
``flash_attention`` (its Pallas kernels in interpret mode on the CPU, as
tests/test_ops.py runs them), JAX ``reference_attention``, and the port's
plain versions and ``flash_attention`` on CPU tensors. Tolerances: f32
within 1e-5 absolute (the same arithmetic, summed in another order);
bf16 inputs within 2e-2 absolute (one bf16 rounding of the output, whose
unit in the last place near 1 is 7.8e-3, plus the reference's bf16
probabilities). Gradients: atol 1e-4, rtol 1e-3, the JAX package's own
bar for its backward kernels (tests/test_kernels.py).

The CUDA kernels are held against the plain versions on the card in
tests/test_torch_gpu.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# both packages' ops/__init__ re-export the function under the module's
# name, so the modules are fetched by their full names
jfa = importlib.import_module("kubeflow_tpu.ops.flash_attention")
tfa = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")

F32_ATOL = 1e-5
BF16_ATOL = 2e-2


def _qkv(b=2, s=64, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32)
                 for _ in range(3))


def _jax(*xs, dtype=jnp.float32):
    return tuple(jnp.asarray(x, dtype) for x in xs)


def _torch(*xs, dtype=torch.float32):
    return tuple(torch.from_numpy(x).to(dtype) for x in xs)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("causal", [True, False])
def test_f32_matches_jax_kernel_and_reference(causal):
    q, k, v = _qkv()
    j_out = jfa.flash_attention(*_jax(q, k, v), causal=causal,
                                block_q=32, block_k=32)
    j_ref = jfa.reference_attention(*_jax(q, k, v), causal=causal)
    plain, _ = tfa.flash_attention_fwd_plain(*_torch(q, k, v),
                                             causal=causal)
    launches = tfa.flash_attention.launches
    wrapped = tfa.flash_attention(*_torch(q, k, v), causal=causal)
    ported_ref = tfa.reference_attention(*_torch(q, k, v), causal=causal)
    for name, got in (("plain", plain), ("wrapper", wrapped),
                      ("reference", ported_ref)):
        np.testing.assert_allclose(_np(got), _np(j_out), atol=F32_ATOL,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(_np(got), _np(j_ref), atol=F32_ATOL,
                                   rtol=0, err_msg=name)
    # a CPU tensor takes the plain version, never the kernel
    assert tfa.flash_attention.launches == launches


@pytest.mark.parametrize("causal", [True, False])
def test_uneven_length_with_lse(causal):
    """S = 40 has no 128-aligned block; the JAX kernel tiles it whole in
    interpret mode, the port takes every length."""
    q, k, v = _qkv(b=1, s=40, h=3, d=16, seed=1)
    j_o, j_lse = jfa.flash_attention(*_jax(q, k, v), causal=causal,
                                     with_lse=True)
    t_o, t_lse = tfa.flash_attention(*_torch(q, k, v), causal=causal,
                                     with_lse=True)
    assert tuple(t_o.shape) == (1, 40, 3, 16)
    assert tuple(t_lse.shape) == tuple(j_lse.shape) == (1, 3, 40)
    assert t_lse.dtype == torch.float32
    np.testing.assert_allclose(_np(t_o), _np(j_o), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(_np(t_lse), _np(j_lse), atol=F32_ATOL,
                               rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_inputs(causal):
    q, k, v = _qkv(b=2, s=48, h=2, d=32, seed=2)
    j_out = jfa.flash_attention(*_jax(q, k, v, dtype=jnp.bfloat16),
                                causal=causal, block_q=16, block_k=16)
    j_ref = jfa.reference_attention(*_jax(q, k, v, dtype=jnp.bfloat16),
                                    causal=causal)
    t_out = tfa.flash_attention(*_torch(q, k, v, dtype=torch.bfloat16),
                                causal=causal)
    assert t_out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(t_out), _np(j_out), atol=BF16_ATOL,
                               rtol=0)
    np.testing.assert_allclose(_np(t_out), _np(j_ref), atol=BF16_ATOL,
                               rtol=0)


def test_explicit_scale_matches_jax():
    q, k, v = _qkv(seed=3)
    j_o, j_lse = jfa.flash_attention(*_jax(q, k, v), scale=0.3,
                                     with_lse=True)
    t_o, t_lse = tfa.flash_attention(*_torch(q, k, v), scale=0.3,
                                     with_lse=True)
    np.testing.assert_allclose(_np(t_o), _np(j_o), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(_np(t_lse), _np(j_lse), atol=F32_ATOL,
                               rtol=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches on CUDA tensors or raises: a CPU
    tensor handed to it is an error, not a quiet plain-version run."""
    q, k, v = _torch(*_qkv(b=1, s=8, h=1, d=8))
    launches = tfa.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd_cuda(q, k, v)
    assert tfa.flash_attention.launches == launches


def _loss(o):
    return o * (o.cos() if isinstance(o, torch.Tensor) else jnp.cos(o))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [64, 65])
def test_grad_matches_jax_kernel(causal, s):
    """Autograd through the port's backward (the plain versions of K2a
    and K2b on the CPU) against jax.grad through the JAX Pallas backward
    kernels, on loss sum(o * cos o)."""
    q, k, v = _qkv(b=2, s=s, h=2, d=16, seed=4)
    j_grads = jax.grad(
        lambda *a: jnp.sum(_loss(jfa.flash_attention(*a, causal=causal))),
        argnums=(0, 1, 2))(*_jax(q, k, v))
    tq, tk, tv = (x.requires_grad_(True) for x in _torch(q, k, v))
    launches = (tfa.flash_attention_bwd_dq.launches,
                tfa.flash_attention_bwd_dkv.launches)
    _loss(tfa.flash_attention(tq, tk, tv, causal=causal)).sum().backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), j_grads):
        np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4, rtol=1e-3,
                                   err_msg=f"d{name} s={s}")
    assert (tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == launches


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_matches_autograd_of_reference(causal):
    q, k, v = _torch(*_qkv(b=1, s=40, h=3, d=16, seed=5))
    do = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 40, 3, 16)).astype(np.float32))
    o, lse = tfa.flash_attention_fwd_plain(q, k, v, causal=causal)
    dq, dk, dv = tfa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                               causal=causal)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = tfa.reference_attention(*leaves, causal=causal)
    r_dq, r_dk, r_dv = torch.autograd.grad(ref, leaves, do)
    for got, want in ((dq, r_dq), (dk, r_dk), (dv, r_dv)):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4,
                                   rtol=1e-3)


def test_backward_reads_strided_qkv_slices():
    """The model hands q, k, v as slices of one fused qkv tensor: the
    gradient lands in the fused tensor's slots, equal to the gradient
    through contiguous copies."""
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(
        rng.standard_normal((2, 33, 3, 2, 16)).astype(np.float32))
    fused = qkv.clone().requires_grad_(True)
    _loss(tfa.flash_attention(fused[:, :, 0], fused[:, :, 1],
                              fused[:, :, 2])).sum().backward()
    parts = [qkv[:, :, i].contiguous().requires_grad_(True)
             for i in range(3)]
    _loss(tfa.flash_attention(*parts)).sum().backward()
    want = torch.stack([p.grad for p in parts], dim=2)
    np.testing.assert_allclose(fused.grad.numpy(), want.numpy(), atol=1e-6,
                               rtol=0)


def test_bwd_cuda_wrappers_refuse_cpu_tensors():
    q, k, v = _torch(*_qkv(b=1, s=8, h=1, d=8))
    lse = torch.zeros(1, 1, 8)
    launches = (tfa.flash_attention_bwd_dq.launches,
                tfa.flash_attention_bwd_dkv.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_dq_cuda(q, k, v, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_dkv_cuda(q, k, v, q, lse, lse)
    assert (tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == launches


def _view(base_elems, offset, shape, strides, dtype=torch.bfloat16):
    flat = torch.zeros(base_elems, dtype=dtype)
    return flat.as_strided(shape, strides, storage_offset=offset)


@pytest.mark.parametrize("name,x,ready", [
    ("contiguous", torch.zeros(2, 64, 3, 16, dtype=torch.bfloat16), True),
    # the model's fused-qkv slices: offsets of h*d elements, seq stride
    # 3*h*d
    ("qkv slice k", torch.zeros(2, 64, 3, 3, 16,
                                dtype=torch.bfloat16)[:, :, 1], True),
    ("qkv slice v, d 40", torch.zeros(2, 9, 3, 2, 40,
                                      dtype=torch.bfloat16)[:, :, 2], True),
    ("one element in", _view(4096, 1, (2, 8, 2, 16), (256, 32, 16, 1)),
     False),
    ("head stride 12", _view(4096, 0, (2, 8, 2, 8), (192, 24, 12, 1)),
     False),
    ("seq stride 20", _view(4096, 0, (2, 8, 1, 16), (160, 20, 16, 1)),
     False),
    ("batch stride 100", _view(4096, 0, (2, 4, 2, 8), (100, 16, 8, 1)),
     False),
    # a dim with one index has no stride that matters
    ("single head, odd head stride", _view(4096, 0, (2, 8, 1, 16),
                                           (128, 16, 3, 1)), True),
    ("single batch, odd batch stride", _view(4096, 0, (1, 8, 2, 16),
                                             (7, 32, 16, 1)), True),
])
def test_async_layout_check(name, x, ready):
    """The bf16 kernels' 16-byte copies need 16-byte aligned pointers and
    (batch, seq, head) strides that are multiples of 8 elements: the
    check is a pure function of the view, so crafted CPU views test it."""
    assert x.data_ptr() % 16 == 0 or not ready
    assert tfa.async_ready(x) is ready, name
    if ready:
        tfa.check_async_layout(q=x)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            tfa.check_async_layout(k=x, q=torch.zeros(1, 1, 1, 8))


def test_bf16_wrappers_check_layout_after_device():
    """On the CPU the wrappers refuse the tensor for its device first, so
    the plain versions stay the CPU path; the layout check sits behind."""
    x = _view(4096, 1, (1, 8, 1, 16), (128, 16, 16, 1))
    lse = torch.zeros(1, 1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_dkv_cuda(x, x, x, x, lse, lse)
    o = tfa.flash_attention(x, x, x)      # the plain version takes any view
    assert o.shape == x.shape and o.dtype == torch.bfloat16


@pytest.mark.parametrize("shape,dtype,ok", [
    # every kernel takes a flat grid: any batch*heads
    ((1, 1, 65537, 8), torch.float32, True),
    ((1, 1, 65537, 8), torch.bfloat16, True),
    # the kernels pad any head dim up to 256, in f32 and in bf16 (the
    # tensor-core kernels take multiples of 8 up to 128, the FMA kernels
    # the rest); beyond 256 their f32 tiles would not fit shared memory
    ((1, 1, 2, 36), torch.float32, True),
    ((1, 1, 2, 100), torch.float32, True),
    ((1, 1, 2, 36), torch.bfloat16, True),
    ((1, 1, 2, 136), torch.float32, True),
    ((1, 1, 2, 256), torch.bfloat16, True),
    ((1, 1, 2, 257), torch.float32, False),
    ((1, 1, 2, 264), torch.bfloat16, False),
    ((1, 1, 2, 0), torch.float32, False),
])
def test_kernel_shape_contract(shape, dtype, ok):
    """What the kernels take: any batch*heads; a head dim up to 256. A
    pure function of the shape and dtype, so meta tensors test it."""
    q = torch.empty(shape, dtype=dtype, device="meta")
    if ok:
        tfa._check_head_dim(q)
    else:
        with pytest.raises(ValueError, match="head_dim"):
            tfa._check_head_dim(q)


@pytest.mark.parametrize("d,dtype,tensor_core", [
    (64, torch.bfloat16, True), (128, torch.bfloat16, True),
    (36, torch.bfloat16, False), (136, torch.bfloat16, False),
    (256, torch.bfloat16, False), (64, torch.float32, False),
    (256, torch.float32, False)])
def test_head_dim_picks_the_kernel(d, dtype, tensor_core):
    """bf16 at a multiple of 8 up to 128 goes to the tensor-core kernels
    (and their layout check); every other input to the FMA kernels."""
    q = torch.empty((1, 4, 2, d), dtype=dtype, device="meta")
    assert tfa.tensor_core_route(q) is tensor_core


@pytest.mark.parametrize("d", [36, 100])
def test_f32_head_dims_not_a_multiple_of_8(d):
    """Head dims the f32 kernels now take: the port's forward and
    gradients against the JAX Pallas kernels in interpret mode."""
    q, k, v = _qkv(b=1, s=40, h=2, d=d, seed=8)
    j_o = jfa.flash_attention(*_jax(q, k, v), block_q=16, block_k=16)
    j_grads = jax.grad(
        lambda *a: jnp.sum(_loss(jfa.flash_attention(*a))),
        argnums=(0, 1, 2))(*_jax(q, k, v))
    tq, tk, tv = (x.requires_grad_(True) for x in _torch(q, k, v))
    t_o = tfa.flash_attention(tq, tk, tv)
    np.testing.assert_allclose(_np(t_o.detach()), _np(j_o), atol=F32_ATOL,
                               rtol=0)
    _loss(t_o).sum().backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), j_grads):
        np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4, rtol=1e-3,
                                   err_msg=f"d{name} d={d}")


# bf16 gradients: each side computes in f32 from the same bf16 inputs and
# rounds each gradient to bf16 once (the JAX kernels' o is bf16 too, so
# delta = rowsum(do * o) agrees), so they may land one bf16 step apart:
# 2^-7 of the value, plus a floor for values near 0
BF16_GRAD_ATOL, BF16_GRAD_RTOL = 1e-2, 2.0 ** -7


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dtype", [(256, "float32"), (256, "bfloat16"),
                                     (36, "bfloat16")])
def test_head_dims_the_tensor_cores_do_not_take(d, dtype, causal):
    """Head dims above 128 (f32 and bf16) and a bf16 head dim that is not
    a multiple of 8, which the port's FMA kernels take on the card: its
    plain forward and gradients against the JAX Pallas kernels in
    interpret mode. f32 within the module's bars; bf16 output within
    BF16_ATOL and gradients within one bf16 step."""
    q, k, v = _qkv(b=1, s=24, h=2, d=d, seed=9)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j_o = jfa.flash_attention(*_jax(q, k, v, dtype=jdt), causal=causal,
                              block_q=8, block_k=8)
    j_grads = jax.grad(
        lambda *a: jnp.sum(_loss(jfa.flash_attention(
            *a, causal=causal, block_q=8, block_k=8).astype(jnp.float32))),
        argnums=(0, 1, 2))(*_jax(q, k, v, dtype=jdt))
    tq, tk, tv = (x.requires_grad_(True) for x in _torch(q, k, v, dtype=tdt))
    t_o = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert t_o.dtype == tdt
    f32 = dtype == "float32"
    np.testing.assert_allclose(_np(t_o.detach()), _np(j_o),
                               atol=F32_ATOL if f32 else BF16_ATOL, rtol=0)
    _loss(t_o.float()).sum().backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), j_grads):
        assert got.dtype == tdt
        np.testing.assert_allclose(
            _np(got), _np(ref), atol=1e-4 if f32 else BF16_GRAD_ATOL,
            rtol=1e-3 if f32 else BF16_GRAD_RTOL,
            err_msg=f"d{name} d={d} {dtype}")
