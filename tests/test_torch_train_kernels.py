"""The port's train-mode BN families against the JAX package, on the CPU.

`ops.epilogue.bn_act_train` and `ops.residual.bn_add_act_train` run their
plain versions for CPU tensors; the JAX side runs
`fused_bn_act_train` / `fused_bn_add_act_train` as its own suite does
(tests/test_block_fuse.py:78-130): the Pallas kernels in interpret mode
and the jnp twins. Same seeded numpy inputs, shape (2, 16, 8, 8) (NHWC
(2, 8, 8, 16) on the JAX side), every activation, f32 and bf16.

Compared: the forward output, the batch mean and variance, and the
gradients of sum(out^2) w.r.t. x, gamma, beta (and skip) — torch
autograd through the port's analytic backward against `jax.grad`
through the JAX custom_vjp. Tolerances (those of test_block_fuse.py):
forward and moments 1e-5 (bf16 output 3e-2), gradients 1e-4 (bf16
1e-2). Observed maxima on this CPU are written beside each pin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu.ops.pallas.epilogue import \
    fused_bn_act_train
from real_time_helmet_detection_tpu.ops.pallas.residual import \
    fused_bn_add_act_train
from real_time_helmet_detection_tpu_torch.ops import epilogue, residual
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

ACTS = ("ReLU", "Mish", "Linear")
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def inputs(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 8, 8, 16)) * 2).astype(np.float32)
    skip = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    gamma = (rng.standard_normal(16) * 0.5 + 1).astype(np.float32)
    beta = rng.standard_normal(16).astype(np.float32)
    return x, gamma, beta, skip


def to_port(a: np.ndarray, dtype) -> torch.Tensor:
    """NHWC numpy -> NCHW channels-last tensor of `dtype`, a leaf."""
    t = torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2)
    return t.detach().requires_grad_(True)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def port_run(fn, x, gamma, beta, skip, dtype):
    """Forward + grads of sum(out^2) through the port."""
    xt = to_port(x, dtype)
    gt = torch.from_numpy(gamma).requires_grad_(True)
    bt = torch.from_numpy(beta).requires_grad_(True)
    args = [xt, gt, bt]
    if skip is not None:
        args.append(to_port(skip, dtype))
    out, mean, var = fn(*args)
    assert not mean.requires_grad and not var.requires_grad
    (out.float() ** 2).sum().backward()
    grads = [nhwc(xt.grad), gt.grad.numpy(), bt.grad.numpy()]
    if skip is not None:
        grads.append(nhwc(args[3].grad))
    return nhwc(out), mean.numpy(), var.numpy(), grads


def jax_run(fn, x, gamma, beta, skip, dtype):
    args = [jnp.asarray(x, dtype), jnp.asarray(gamma), jnp.asarray(beta)]
    if skip is not None:
        args.append(jnp.asarray(skip, dtype))
    out, mean, var = fn(*args)

    def loss(*a):
        return jnp.sum(fn(*a)[0].astype(jnp.float32) ** 2)

    grads = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    return (np.asarray(out, np.float32), np.asarray(mean), np.asarray(var),
            [np.asarray(g, np.float32) for g in grads])


def check(port, want, tag):
    out, mean, var, grads = port
    w_out, w_mean, w_var, w_grads = want
    # observed max abs: output f32 9.5e-7, bf16 0; gradients 5% (f32) and
    # 0.6% (bf16) of the allowed error
    ftol = 1e-5 if tag == "f32" else 3e-2
    gtol = 1e-4 if tag == "f32" else 1e-2
    np.testing.assert_allclose(out, w_out, rtol=ftol, atol=ftol)
    # moments are f32 sums of the same values: observed mean 6.0e-8,
    # var 1.9e-6
    np.testing.assert_allclose(mean, w_mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var, w_var, rtol=1e-5, atol=1e-5)
    for name, g, w in zip(("x", "gamma", "beta", "skip"), grads, w_grads):
        np.testing.assert_allclose(g, w, rtol=gtol, atol=gtol,
                                   err_msg="grad %s" % name)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
def test_bn_act_train_matches_jax(act, tag):
    x, gamma, beta, _ = inputs(0)
    tdt, jdt = DTYPES[tag]
    port = port_run(lambda x, g, b: epilogue.bn_act_train(x, g, b, act),
                    x, gamma, beta, None, tdt)
    for interpret in (True, None):  # Pallas interpret, jnp twin
        want = jax_run(lambda x, g, b: fused_bn_act_train(
            x, g, b, activation=act, interpret=interpret),
            x, gamma, beta, None, jdt)
        check(port, want, tag)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
def test_bn_add_act_train_matches_jax(act, tag):
    x, gamma, beta, skip = inputs(1)
    tdt, jdt = DTYPES[tag]
    port = port_run(
        lambda x, g, b, s: residual.bn_add_act_train(x, g, b, s, act),
        x, gamma, beta, skip, tdt)
    for interpret in (True, None):
        want = jax_run(lambda x, g, b, s: fused_bn_add_act_train(
            x, g, b, s, activation=act, interpret=interpret),
            x, gamma, beta, skip, jdt)
        check(port, want, tag)


def test_train_passes_count_no_launch_on_cpu():
    """CPU tensors run the plain versions: no kernel counter moves."""
    x, gamma, beta, skip = inputs(2)
    before = (epilogue.stats_launches, epilogue.bwd_sums_launches,
              epilogue.bwd_dx_launches, residual.bwd_sums_launches,
              residual.bwd_dx_launches, epilogue.launches,
              residual.launches)
    port_run(lambda x, g, b: epilogue.bn_act_train(x, g, b, "ReLU"),
             x, gamma, beta, None, torch.float32)
    port_run(lambda x, g, b, s: residual.bn_add_act_train(x, g, b, s,
                                                          "ReLU"),
             x, gamma, beta, skip, torch.float32)
    assert (epilogue.stats_launches, epilogue.bwd_sums_launches,
            epilogue.bwd_dx_launches, residual.bwd_sums_launches,
            residual.bwd_dx_launches, epilogue.launches,
            residual.launches) == before


def test_grad_in_another_layout_is_converted_and_counted():
    """A gradient that reaches the backward in contiguous NCHW (as the
    nearest-upsample backward can hand it) is copied to channels-last
    and counted; the result equals the channels-last gradient's."""
    x, gamma, beta, _ = inputs(3)
    grads = []
    for fmt in (torch.channels_last, torch.contiguous_format):
        xt = to_port(x, torch.float32)
        out, _, _ = epilogue.bn_act_train(xt, torch.from_numpy(gamma),
                                          torch.from_numpy(beta), "Mish")
        g = torch.ones_like(out).contiguous(memory_format=fmt) * 0.5
        before = epilogue.grad_conversions
        out.backward(g)
        assert epilogue.grad_conversions - before == (
            fmt is torch.contiguous_format)
        grads.append(xt.grad)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("bad", ["layout", "activation", "gamma"])
def test_train_wrappers_refuse_bad_operands(bad):
    x, gamma, beta, skip = inputs(4)
    xt = to_port(x, torch.float32)
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    act = "ReLU"
    if bad == "layout":
        xt = xt.contiguous()
    elif bad == "activation":
        act = "CELU"
    else:
        g = g[:8]
    with pytest.raises((ValueError, NotImplementedError)):
        epilogue.bn_act_train(xt, g, b, act)
    with pytest.raises((ValueError, NotImplementedError)):
        residual.bn_add_act_train(xt, g, b, to_port(skip, torch.float32),
                                  act)
