"""`--fwd-dtype int8` training in the PyTorch port against the JAX package,
on the CPU.

The port's straight-through conv (`ops.quant.ste_conv`: the quantizer,
the int8 conv kernels' plain versions here, a float backward) against
JAX's `make_ste_conv` (ref ops/quant.py:184) on the same numpy inputs:

* the int8 operands and the int32 sums exact; the forward f32 within
  rtol 1e-6 (observed bit-equal), bf16 within one bf16 ulp (the same
  rounding order, acc -> bf16 before the product);
* the backward: bit-equal to the autograd of the port's own float conv
  (`F.conv2d`) at the same cotangent — the estimator is straight through —
  and within rtol 1e-5 of JAX's float-conv VJP (f32; observed 3e-7);
* one train step of the 1-stack width-16 model at 128^2, batch 2, f32,
  from one JAX init: the loss and the gradient against JAX's
  `--fwd-dtype int8` step, each held to what a 1e-6 change of the images
  does to either side's own (the int8 path is discontinuous: see the
  test), and the running statistics likewise;
* the sites: a train step of the flagship (residual, 128 wide) and of
  the edge architecture (ghost, 64 wide) calls the quantizer and the
  dense and depthwise convs as `chip_smoke.ste_walk` derives (the
  counts the card's `train_extras` phase holds the launch counters to);
  eval binds the float conv; the state dict does not change.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.ops import quant as jq
from real_time_helmet_detection_tpu.train import init_variables
from real_time_helmet_detection_tpu.train import loss_fn as jax_loss_fn
from real_time_helmet_detection_tpu_torch import convert
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.data.synthetic import \
    synthetic_target_batch
from real_time_helmet_detection_tpu_torch.models.hourglass import \
    build_model
from real_time_helmet_detection_tpu_torch.ops import qconv, quant
from real_time_helmet_detection_tpu_torch.train import loss_fn

from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

FUSED = dict(epilogue="fused", block_fuse="fused", loss_kernel="xla")
IMSIZE = 128  # see tests/test_torch_train.py SLICE_IMSIZE
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# (groups, Cin, Cout, k)
CONVS = {"dense3": (1, 32, 16, 3), "dense1": (1, 32, 24, 1),
         "depthwise": (16, 16, 16, 3)}


def to_port(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def conv_operands(name, seed=0):
    groups, cin, cout, k = CONVS[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, 9, 7, cin)).astype(np.float32)
    w = rng.normal(0, 0.2, (k, k, cin // groups, cout)).astype(np.float32)
    g = rng.normal(0, 1, (2, 9, 7, cout)).astype(np.float32)
    return groups, k, x, w, g


def port_weight(w, dt):
    return torch.from_numpy(w).permute(3, 2, 0, 1).to(dt).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CONVS))
def test_ste_conv_matches_jax(name, dtype):
    tdt, jdt = DTYPES[dtype]
    groups, k, x, w, g = conv_operands(name)
    fn = jq.make_ste_conv(1, k // 2, groups)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    want, vjp = jax.vjp(fn, jx, jw)
    jgx, jgw = vjp(jnp.asarray(g).astype(jdt))
    xt = to_port(x).to(tdt).contiguous(memory_format=torch.channels_last)
    xt.requires_grad_(True)
    wt = port_weight(w, tdt).requires_grad_(True)
    got = quant.ste_conv(xt, wt, groups)
    assert got.dtype == tdt
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(nhwc(got), want, rtol=1e-6, atol=0)
    else:  # one bf16 ulp of the larger magnitude
        ulp = np.spacing(np.abs(want).astype(np.float32)) * 2 ** 16
        assert np.all(np.abs(nhwc(got) - want) <= ulp + 1e-30)
    gt = to_port(g).to(tdt).contiguous(memory_format=torch.channels_last)
    got.backward(gt)
    # straight through: the float conv's own autograd, bit for bit
    x2 = xt.detach().clone().requires_grad_(True)
    w2 = wt.detach().clone().requires_grad_(True)
    F.conv2d(x2, w2, None, 1, k // 2, 1, groups).backward(gt)
    assert torch.equal(xt.grad, x2.grad) and torch.equal(wt.grad, w2.grad)
    if dtype == "f32":
        np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jgx),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            wt.grad.permute(2, 3, 1, 0).numpy(), np.asarray(jgw),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CONVS))
def test_ste_operands_and_int32_sums_exact(name):
    """The quantized activation (the batch's own abs-max step), the
    per-channel weight codes and the int32 sums equal JAX's."""
    groups, k, x, w, _ = conv_operands(name, seed=3)
    absmax = jnp.max(jnp.abs(jnp.asarray(x)))
    jxq, js = jq.quantize_activations(jnp.asarray(x), absmax)
    jwq, jws = jq.quantize_weights(jnp.asarray(w))
    jacc = jax.lax.conv_general_dilated(
        jxq, jwq, (1, 1), ((k // 2, k // 2),) * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32, feature_group_count=groups)
    xt = to_port(x).contiguous(memory_format=torch.channels_last)
    step = quant.act_step(xt.abs().amax())
    assert step.item() == float(js)
    q = qconv.quantize_act(xt, step)
    np.testing.assert_array_equal(nhwc(q).astype(np.int8), np.asarray(jxq))
    wq, ws = quant.quantize_weights(port_weight(w, torch.float32))
    np.testing.assert_array_equal(wq.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    zero = torch.zeros(ws.shape)
    if groups > 1:
        acc = qconv.conv_dw(q, wq.reshape(wq.shape[0], -1).t().contiguous(),
                            ws, zero, torch.int32, "Linear")
    else:
        acc = qconv.conv_dense(q, wq.permute(0, 2, 3, 1).contiguous(), ws,
                               zero, torch.int32, "Linear")
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jacc))


@pytest.fixture(scope="module")
def int8_pair():
    jcfg = JaxConfig(num_stack=1, hourglass_inch=16, imsize=IMSIZE,
                     batch_size=2, fwd_dtype="int8", **FUSED)
    jmodel = jax_build(jcfg)
    params, stats = jax.device_get(init_variables(
        jmodel, jax.random.key(4), IMSIZE))
    cfg = Config(device="cpu", num_stack=1, hourglass_inch=16,
                 batch_size=2, fwd_dtype="int8")
    return jcfg, jmodel, params, stats, cfg


def test_int8_train_step_matches_jax(int8_pair):
    """The int8 step against JAX's, held to the int8 path's own
    sensitivity. Each quantization step is the abs-max of its input, one
    element: a rounding flip upstream moves it and with it every code of
    the tensor, so images times (1 + 1e-6 N(0, 1)) move JAX's own loss
    by up to 4e-3 relative and its gradient by 45-51% of its norm in L2
    (cosine 0.87-0.90; the bf16 path's by 1e-7). The references: a JAX
    and a port run at such images, each against its own side's result
    at the images. The port's loss error and its gradient's L2 error
    (all 118 leaves as one vector) must be at most 1.5x the largest
    reference distance, and 1.5x the gradient's below its norm, so a
    zeroed or sign-flipped gradient fails (observed: loss 3.2e-3 against
    a yardstick 1.1e-2; gradient 10.5 against 13.7, norm 25.6, cosine
    0.916). The running statistics, whose inputs the codes move too, to
    the same rule in L2. The exact parts are held op by op above."""
    jcfg, jmodel, params, stats, cfg = int8_pair
    arrs = synthetic_target_batch(2, IMSIZE, seed=1)
    fn = jax.jit(lambda p, s, *a: jax.value_and_grad(
        jax_loss_fn, has_aux=True)(p, s, jmodel, *a, jcfg))

    def jax_run(batch):
        (jl, (jstats, _)), jg = fn(params, stats, *map(jnp.asarray, batch))
        g = convert.flax_to_state_dict({"params": jax.device_get(jg)})
        return (float(jl), {n: t.numpy() for n, t in g.items()},
                convert.flatten_tree(jax.device_get(jstats)))

    def port_run(batch):
        model = build_model(cfg).train()
        convert.load_into(model, {"params": params, "batch_stats": stats})
        total, _ = loss_fn(model, *map(torch.from_numpy, batch), cfg)
        total.backward()
        return total.item(), {n: p.grad.numpy().copy()
                              for n, p in model.named_parameters()}, \
            convert.flatten_tree(convert.state_dict_to_flax(
                model.state_dict())["batch_stats"])

    def vec(g):
        return np.concatenate([np.asarray(g[n]).ravel().astype(np.float64)
                               for n in sorted(g)])

    rng = np.random.default_rng(0)

    def perturbed():
        out = list(arrs)
        out[0] = (arrs[0] * (1 + 1e-6 * rng.standard_normal(
            arrs[0].shape))).astype(np.float32)
        return out

    jl, jg, jst = jax_run(arrs)
    pl, pg, pst = port_run(arrs)
    assert sorted(pg) == sorted(jg) and sorted(pst) == sorted(jst)
    loss_d, grad_d, stat_d = [], [], []
    for run, (l0, g0, s0) in ((jax_run, (jl, jg, jst)),
                              (port_run, (pl, pg, pst))):
        for _ in range(1):
            l1, g1, s1 = run(perturbed())
            loss_d.append(abs(l1 - l0))
            grad_d.append(np.linalg.norm(vec(g1) - vec(g0)))
            stat_d.append(np.linalg.norm(vec(s1) - vec(s0)))
    norm = np.linalg.norm(vec(jg))
    assert abs(pl - jl) <= 1.5 * max(loss_d), (pl, jl, loss_d)
    assert 1.5 * max(grad_d) < norm, (grad_d, norm)
    err = np.linalg.norm(vec(pg) - vec(jg))
    assert err <= 1.5 * max(grad_d), (err, grad_d)
    stat_err = np.linalg.norm(vec(pst) - vec(jst))
    assert stat_err <= 1.5 * max(stat_d), (stat_err, stat_d)
    print("int8 step: loss %.7g vs %.7g (yardstick %.3g); gradient rel L2 "
          "%.3g (yardstick %.3g)" % (pl, jl, max(loss_d), err / norm,
                                     max(grad_d) / norm))


@pytest.mark.parametrize("name", ["flagship", "edge-arch"])
def test_int8_train_step_sites(monkeypatch, name):
    """One `--fwd-dtype int8` train step at 64^2, batch 1, calls the
    abs-max and the quantizer once per STE site and each int8 conv as
    derived; eval binds the float conv (no int8 call), and the state
    dict is the bf16 model's."""
    from test_torch_predict import chip_smoke
    from real_time_helmet_detection_tpu_torch.optim import (
        build_optimizer, make_lr_schedule)
    from real_time_helmet_detection_tpu_torch.train import make_train_step
    calls = dict(abs_max=0, quantize_act=0, conv_dense=0, conv_dw=0)
    for attr in calls:
        real = getattr(qconv, attr)

        def wrapper(*a, _real=real, _attr=attr, **kw):
            calls[_attr] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(qconv, attr, wrapper)
    arch = {} if name == "flagship" else chip_smoke.VARIANT_CONFIGS[name]
    cfg = Config(device="cpu", batch_size=1, imsize=64, fwd_dtype="int8",
                 **arch)
    model = build_model(cfg).train()
    step = make_train_step(model, build_optimizer(cfg, model.parameters()),
                           make_lr_schedule(cfg, 1), cfg)
    losses = step(0, *map(torch.from_numpy, synthetic_target_batch(1, 64)))
    assert np.isfinite(float(losses["total"]))
    dense, dw = chip_smoke.ste_walk(cfg)
    sites = dense + len(dw)
    assert calls == dict(abs_max=sites, quantize_act=sites,
                         conv_dense=dense, conv_dw=len(dw)), calls
    assert (dense, len(dw)) == {"flagship": (35, 0),
                                "edge-arch": (34, 34)}[name]
    model.eval()
    with torch.no_grad():
        model(torch.from_numpy(synthetic_target_batch(1, 64)[0]))
    assert calls == dict(abs_max=sites, quantize_act=sites,
                         conv_dense=dense, conv_dw=len(dw))
    plain = build_model(dataclasses.replace(cfg, fwd_dtype="bf16"))
    assert list(plain.state_dict()) == list(model.state_dict())
