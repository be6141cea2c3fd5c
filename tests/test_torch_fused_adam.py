"""The port's fused Adam (K3) against the JAX package's.

The same numpy params go through the JAX ``fused_adam`` (its Pallas
kernel in interpret mode on the CPU, as tests/test_kernels.py runs it),
the JAX ``reference_adam`` (the stock optax chain), and the port's
``FusedAdam`` on CPU tensors (the kernel's plain version). Leaf shapes
are the odd ones of tests/test_kernels.py, so the TPU kernel pads and the
port does not. Tolerance: params and moments within 1e-5 after 5 steps,
the JAX package's own bar for its fused update against optax.

The CUDA kernel is held against the plain version on the card in
tests/test_torch_gpu.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.ops.fused_adam import fused_adam as j_fused_adam
from kubeflow_tpu.ops.fused_adam import reference_adam
from kubeflow_tpu_torch.models.convert import adam_state_from_jax
from kubeflow_tpu_torch.runtime.recipe import decay_groups, lr_schedule

tfo = importlib.import_module("kubeflow_tpu_torch.ops.fused_adam")

SHAPES = {"dense.kernel": (7, 5), "dense.bias": (5,),
          "head.kernel": (5, 13), "head.bias": (13,)}
ATOL = 1e-5
WD = 1e-4


def _numpy_params(seed=3) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _tree(flat: dict) -> dict:
    out: dict = {}
    for name, a in flat.items():
        mod, leaf = name.split(".")
        out.setdefault(mod, {})[leaf] = jnp.asarray(a)
    return out


def _flat(tree) -> dict:
    return {f"{m}.{l}": np.asarray(a) for m, d in tree.items()
            for l, a in d.items()}


def _mask(params):
    return jax.tree.map(lambda p: p.ndim > 1, params)


def _port(flat: dict):
    params = {k: torch.from_numpy(a.copy()) for k, a in flat.items()}
    opt = tfo.FusedAdam(decay_groups(list(params.values()), WD),
                        lr=lr_schedule("cosine", 1e-2, 10))
    return params, opt


def _jax_steps(opt, params, state, steps, start=0):
    for step in range(start, start + steps):
        g = jax.tree.map(lambda p: jnp.sin(p + step), params)
        up, state = opt.update(g, state, params)
        params = optax.apply_updates(params, up)
    return params, state


def _port_steps(params, opt, steps, start=0):
    for step in range(start, start + steps):
        for p in params.values():
            p.grad = torch.sin(p + step)
        opt.step()


def _moments(opt, params, key) -> dict:
    return {k: opt.state[p][key].numpy() for k, p in params.items()}


def _assert_close(got: dict, want: dict, what: str):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0,
                                   err_msg=f"{what} {k}")


def test_matches_jax_fused_and_reference():
    """5 steps, cosine schedule, wd 1e-4 on the rank > 1 leaves."""
    flat = _numpy_params()
    sched = optax.cosine_decay_schedule(1e-2, decay_steps=10)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=WD, mask=_mask)
    fused, ref = j_fused_adam(sched, **kw), reference_adam(sched, **kw)
    jp = _tree(flat)
    jf, jf_state = _jax_steps(fused, jp, fused.init(jp), 5)
    jr, _ = _jax_steps(ref, jp, ref.init(jp), 5)
    params, opt = _port(flat)
    launches = tfo.fused_adam.launches
    _port_steps(params, opt, 5)
    assert tfo.fused_adam.launches == launches   # CPU: the plain version
    assert opt.count == int(jf_state.count) == 5
    got = {k: p.numpy() for k, p in params.items()}
    _assert_close(got, _flat(jf), "params vs jax fused_adam")
    _assert_close(got, _flat(jr), "params vs reference_adam")
    _assert_close(_moments(opt, params, "mu"), _flat(jf_state.mu), "mu")
    _assert_close(_moments(opt, params, "nu"), _flat(jf_state.nu), "nu")


def test_continues_from_converted_jax_state():
    """Both sides start from the same non-zero moments and count: the JAX
    state after 2 steps, converted by adam_state_from_jax."""
    flat = _numpy_params(seed=4)
    sched = optax.cosine_decay_schedule(1e-2, decay_steps=10)
    fused = j_fused_adam(sched, weight_decay=WD, mask=_mask)
    jp, state = _jax_steps(fused, _tree(flat), fused.init(_tree(flat)), 2)
    conv = adam_state_from_jax(state)
    assert conv["count"] == 2 and set(conv["mu"]) == set(SHAPES)
    params, opt = _port(_flat(jp))
    opt.count = conv["count"]
    for name, p in params.items():
        opt.state[p] = {"mu": conv["mu"][name].clone(),
                        "nu": conv["nu"][name].clone()}
    jp, state = _jax_steps(fused, jp, state, 3, start=2)
    _port_steps(params, opt, 3, start=2)
    _assert_close({k: p.numpy() for k, p in params.items()}, _flat(jp),
                  "params")
    _assert_close(_moments(opt, params, "nu"), _flat(state.nu), "nu")


def test_skips_params_without_grad_and_round_trips_state():
    params, opt = _port(_numpy_params())
    _port_steps(params, opt, 1)
    after_one = {k: p.clone() for k, p in params.items()}
    params["dense.bias"].grad = None
    opt.step()
    assert opt.count == 2
    assert torch.equal(params["dense.bias"], after_one["dense.bias"])
    assert not torch.equal(params["dense.kernel"], after_one["dense.kernel"])
    sd = opt.state_dict()
    assert sd["count"] == 2
    _, fresh = _port(_numpy_params())
    fresh.load_state_dict(sd)
    assert fresh.count == 2


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros(4)
    launches = tfo.fused_adam.launches
    with pytest.raises(ValueError, match="CUDA"):
        tfo.fused_adam_cuda([x], [x], [x], [x], [0.0], lr=1e-3, bc1=0.1,
                            bc2=0.001, b1=0.9, b2=0.999, eps=1e-8)
    assert tfo.fused_adam.launches == launches
