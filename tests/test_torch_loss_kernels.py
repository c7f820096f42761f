"""The port's fused detection loss against the JAX package, on the CPU.

`ops.loss.loss_sums` / `loss_sums_bwd` run their plain versions for CPU
tensors; the JAX side runs `fused_stack_loss_sums` and
`fused_detection_loss` with the Pallas kernels in interpret mode (ref
ops/pallas/loss.py), as tests/test_pallas_loss.py does. Inputs are the
shapes of that suite (b 3, 2 stacks, 16^2, 2 classes), made from a seeded
numpy generator and handed to both.

* the four (S, B) sums, f32 and bf16 logits, `normalized` both ways,
  alpha/beta 2/4 and 3/3 and a batch with no positives: rtol 1e-5;
* d(out) from random (S, B) cotangents against `jax.vjp` of the same
  function: rtol 1e-5 plus atol 1e-6 * max|d(out)| in f32, one bf16 ulp
  in bf16 (both sides compute d(out) in f32 and round it once);
* `fused_detection_loss` value and gradient against the JAX fused loss
  and against the port's own composition `stacked_detection_loss` under
  autograd; with logits scaled x20 (saturated sigmoids, p == 1 in f32)
  against the composition only: there the sigmoids of both frameworks
  are 1, but XLA evaluates `log(1 - p + eps)` as if `1 + eps` were
  folded first (1.2e-7 in f32 instead of 1e-7), which moves the
  negative focal sum by about 1%;
* operands the kernels do not take raise, and no launch counter moves on
  the CPU.

Observed maxima on this CPU are written beside each pin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu.ops.pallas import (fused_detection_loss
                                                       as jax_fused_loss)
from real_time_helmet_detection_tpu.ops.pallas import fused_stack_loss_sums
from real_time_helmet_detection_tpu_torch.ops import loss as L
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

CASES = ["plain", "normalized", "alpha3beta3", "no_positives"]


def batch(case, seed=0, b=3, s=2, h=16, w=16, c=2):
    """(out, heat, off, wh, mask) as numpy f32 and the loss options."""
    rng = np.random.default_rng(seed)
    out = (rng.standard_normal((b, s, h, w, c + 4)) * 2).astype(np.float32)
    heat = rng.uniform(0, 1, (b, h, w, c)).astype(np.float32)
    mask = (rng.uniform(0, 1, (b, h, w, 1)) > 0.9).astype(np.float32)
    heat = np.where(mask > 0, 1.0, heat).astype(np.float32)
    off = rng.standard_normal((b, h, w, 2)).astype(np.float32)
    wh = rng.standard_normal((b, h, w, 2)).astype(np.float32)
    kw = dict(alpha=2.0, beta=4.0, normalized=case == "normalized")
    if case == "alpha3beta3":
        kw.update(alpha=3.0, beta=3.0)
    elif case == "no_positives":
        mask[:] = 0.0
    elif case == "saturated":
        out *= 20.0
    return (out, heat, off, wh, mask), kw


def quantize(arrays, tag):
    """bf16: every array rounded to bf16 and back (the JAX side takes
    them in bf16, the port takes bf16 logits and f32 targets of the same
    values)."""
    if tag == "f32":
        return arrays
    return tuple(np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                 for a in arrays)


def port_operands(arrays, tag):
    out, *targets = (torch.from_numpy(np.ascontiguousarray(a))
                     for a in arrays)
    if tag == "bf16":
        out = out.to(torch.bfloat16)
    return out, *targets


def jax_operands(arrays, tag):
    dt = jnp.float32 if tag == "f32" else jnp.bfloat16
    return tuple(jnp.asarray(a, dt) for a in arrays)


def jax_kw(kw):
    return dict(focal_alpha=kw["alpha"], focal_beta=kw["beta"],
                normalized=kw["normalized"], interpret=True)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_loss_sums_match_jax(case, tag):
    """The four (S, B) sums: rtol 1e-5 (observed 3.2e-7 relative; 0
    where both are 0, the no-positive batch's focal positive term)."""
    arrays, kw = batch(case)
    arrays = quantize(arrays, tag)
    got = L.loss_sums(*port_operands(arrays, tag), **kw)
    want = fused_stack_loss_sums(*jax_operands(arrays, tag), **jax_kw(kw))
    for name, g, w in zip(("pos", "neg", "off", "wh"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (2, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=0, err_msg=name)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_loss_sums_backward_matches_jax_vjp(case, tag):
    """d(out) from random (S, B) cotangents against `jax.vjp` of the JAX
    fused sums: f32 rtol 1e-5 + atol 1e-6 * max|d(out)| (observed max
    abs 1.2e-6 * max, inside the rtol part); bf16 within one bf16 ulp of
    the JAX value (observed: equal)."""
    arrays, kw = batch(case, seed=1)
    arrays = quantize(arrays, tag)
    cots = [np.random.default_rng(7 + i).standard_normal((2, 3))
            .astype(np.float32) for i in range(4)]
    ops = port_operands(arrays, tag)
    got = L.loss_sums_bwd(*ops, *map(torch.from_numpy, cots), **kw)
    assert got.dtype == ops[0].dtype and got.shape == ops[0].shape
    jops = jax_operands(arrays, tag)
    _, vjp = jax.vjp(lambda o: fused_stack_loss_sums(o, *jops[1:],
                                                     **jax_kw(kw)), jops[0])
    want = np.asarray(vjp(tuple(map(jnp.asarray, cots)))[0], np.float32)
    got = got.float().numpy()
    if tag == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    else:
        ulp = np.ldexp(1.0, np.frexp(np.abs(want))[1] - 8)
        assert np.all(np.abs(got - want) <= ulp)


def port_loss(fn, arrays, kw, **extra):
    out, heat, off, wh, mask = port_operands(arrays, "f32")
    out.requires_grad_(True)
    losses = fn(out, heat, off, wh, mask, normalized_coord=kw["normalized"],
                **extra)
    losses["total"].backward()
    return {k: v.item() for k, v in losses.items()}, out.grad.numpy()


@pytest.mark.parametrize("case", CASES)
def test_fused_detection_loss_matches_jax_and_composition(case):
    """`fused_detection_loss` against the JAX fused loss (value rtol
    1e-5, observed 1.7e-7; gradient rtol 1e-5 + atol 1e-6 * max,
    observed max abs 3.4e-6 * max, inside the rtol part) and against the
    port's composition `stacked_detection_loss` under autograd (the same
    pins; observed 0 and 2.5e-7 * max)."""
    arrays, kw = batch(case, seed=2)
    alpha_beta = dict(focal_alpha=kw["alpha"], focal_beta=kw["beta"])
    fused, g_fused = port_loss(L.fused_detection_loss, arrays, kw,
                               **alpha_beta)
    comp, g_comp = port_loss(L.stacked_detection_loss, arrays, kw,
                             num_cls=2, **alpha_beta)
    jops = jax_operands(arrays, "f32")

    def jtotal(o):
        return jax_fused_loss(o, *jops[1:], normalized_coord=kw["normalized"],
                              interpret=True, **alpha_beta)

    jl = jtotal(jops[0])
    jgrad = np.asarray(jax.grad(lambda o: jtotal(o)["total"])(jops[0]))
    for k in ("hm", "offset", "size", "total"):
        np.testing.assert_allclose(fused[k], float(jl[k]), rtol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(fused[k], comp[k], rtol=1e-5, err_msg=k)
    for want in (jgrad, g_comp):
        np.testing.assert_allclose(g_fused, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    assert np.isfinite(fused["total"])


@pytest.mark.parametrize("normalized", [False, True])
def test_fused_loss_saturated_matches_composition(normalized):
    """Logits x20: the fused loss against `stacked_detection_loss` under
    autograd, value rtol 1e-5 (observed 1.0e-7) and gradient rtol 1e-5 +
    atol 1e-6 * max (observed 2.0e-7 * max)."""
    arrays, kw = batch("saturated", seed=3)
    kw["normalized"] = normalized
    fused, g_fused = port_loss(L.fused_detection_loss, arrays, kw)
    comp, g_comp = port_loss(L.stacked_detection_loss, arrays, kw,
                             num_cls=2)
    for k in ("hm", "offset", "size", "total"):
        np.testing.assert_allclose(fused[k], comp[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(g_fused, g_comp, rtol=1e-5,
                               atol=1e-6 * np.abs(g_comp).max())


def test_cpu_loss_counts_no_launch():
    arrays, kw = batch("plain")
    before = (L.fwd_launches, L.bwd_launches)
    port_loss(L.fused_detection_loss, arrays, kw)
    assert (L.fwd_launches, L.bwd_launches) == before


@pytest.mark.parametrize("bad", ["out_dtype", "out_layout", "heat_shape",
                                 "mask_dtype", "cotangent_shape"])
def test_loss_wrappers_refuse_bad_operands(bad):
    arrays, kw = batch("plain")
    out, heat, off, wh, mask = port_operands(arrays, "f32")
    cots = [torch.zeros(2, 3) for _ in range(4)]
    if bad == "out_dtype":
        out = out.half()
    elif bad == "out_layout":
        out = out.transpose(2, 3)
    elif bad == "heat_shape":
        heat = heat[..., :1].contiguous()
    elif bad == "mask_dtype":
        mask = mask.double()
    else:
        cots[0] = torch.zeros(3, 2)
    with pytest.raises(ValueError):
        if bad == "cotangent_shape":
            L.loss_sums_bwd(out, heat, off, wh, mask, *cots, **kw)
        else:
            L.loss_sums(out, heat, off, wh, mask, **kw)
