"""The PyTorch port's CUDA kernels against their plain versions, on a card.

Marked `gpu`; each test decides inside itself whether a card is present
and skips without one, so every pytest-xdist worker collects the same
tests. Run on a machine with an H100:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu

Rules: bit-equal for the peak test (both variants, NaN and +-inf
logits: NaN-aware), the ReLU/Linear epilogue (vector and scalar
kernels, ragged counts, misaligned views) and residual tail and the
ReLU/Linear train dx and eval backward passes, and the loss backward's
d(out) (both kernels, non-binary masks, NaN and +-inf logits); Mish
within rtol 1e-6 in f32 and one bf16 ulp in bf16; the reductions
(batch moments, S1/S2, the eval partials) per channel, and the loss
sums per (stack, sample), within 1e-5 of the sum of the absolute values
of their terms, the error bound of a float32 sum taken in another order;
where a test says so, the loss's d(out) within rtol 1e-5 + atol 1e-6 *
max|d(out)|. The int8 kernels (#14 - #16: the dense and depthwise int8
convs, the activation quantizer) bit-equal to their plain versions, in
int32, f32 and bf16, on each of their kernels (dense: wgmma, mma;
depthwise: tiled, gather), at ragged and multi-stage shapes, one image,
Cout past one wgmma width and on views 16 bytes into their storage, the
quantizer on ties, +-inf and NaN; their wrappers' refusals; the int8
twin through the serving engine bit-equal to its eager predict, before
and after a reload.
"""

import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu_torch.ops import (epilogue, loss, peak,
                                                      residual)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, act):
    """act "Mish": the Mish tolerance; anything else: bit-equal."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    if act != "Mish":
        assert torch.equal(got, want)
        return
    g, w = got.float(), want.float()
    if got.dtype == torch.float32:
        assert bool(((g - w).abs() <= 1e-6 * w.abs() + 1e-30).all())
    else:
        _, e = torch.frexp(w)
        assert bool(((g - w).abs() <= torch.ldexp(torch.ones_like(w),
                                                  e - 8)).all())


def _x(shape, dtype, gen):
    x = torch.randn(shape, generator=gen, device="cuda") * 2
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["ReLU", "Mish", "Linear"])
def test_bn_act_kernel_matches_plain(cuda, dtype, act):
    x = _x((4, 128, 64, 64), dtype, cuda)
    a = torch.rand(128, generator=cuda, device="cuda") + 0.5
    b = torch.randn(128, generator=cuda, device="cuda")
    before = epilogue.launches
    got = epilogue.bn_act(x, a, b, act)
    assert epilogue.launches == before + 1
    _close(got, epilogue.bn_act_reference(x, a, b, act), act)
    assert got.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["ReLU", "Mish", "Linear"])
@pytest.mark.parametrize("channels", [8, 64, 128, 6])
def test_bn_act_variants_at_ragged_counts(cuda, dtype, act, channels):
    """Element counts that are no multiple of V x the unroll (8 x 4 bf16,
    4 x 4 f32 vectors): the vector kernel's tail loop; C = 6 takes the
    scalar kernel. Each launch counts once, under its variant."""
    x = _x((3, channels, 5, 7), dtype, cuda)
    a = torch.rand(channels, generator=cuda, device="cuda") + 0.5
    b = torch.randn(channels, generator=cuda, device="cuda")
    want = "scalar" if channels == 6 else "vector"
    before = (epilogue.launches, epilogue.vector_launches,
              epilogue.scalar_launches)
    got = epilogue.bn_act(x, a, b, act)
    assert (epilogue.launches, epilogue.vector_launches,
            epilogue.scalar_launches) == (
        before[0] + 1, before[1] + (want == "vector"),
        before[2] + (want == "scalar"))
    _close(got, epilogue.bn_act_reference(x, a, b, act), act)
    if want == "vector":  # the old kernel, forced, agrees too
        _close(epilogue.bn_act(x, a, b, act, variant="scalar"),
               epilogue.bn_act_reference(x, a, b, act), act)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_act_misaligned_view_takes_the_scalar_kernel(cuda, dtype):
    """x one element into its storage: not 16-byte aligned, so the scalar
    kernel runs; the vector kernel, forced, refuses and the wrapper
    raises."""
    n, c, h, w = 2, 64, 9, 9
    base = torch.randn(n * h * w * c + 1, generator=cuda,
                       device="cuda").to(dtype)
    x = base[1:].view(n, h, w, c).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    a = torch.rand(c, generator=cuda, device="cuda") + 0.5
    b = torch.randn(c, generator=cuda, device="cuda")
    before = epilogue.scalar_launches
    _close(epilogue.bn_act(x, a, b, "ReLU"),
           epilogue.bn_act_reference(x, a, b, "ReLU"), "ReLU")
    assert epilogue.scalar_launches == before + 1
    with pytest.raises(RuntimeError, match="vector"):
        epilogue.bn_act(x, a, b, "ReLU", variant="vector")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["ReLU", "Mish", "Linear"])
def test_bn_add_act_kernel_matches_plain(cuda, dtype, act):
    y, s = _x((4, 128, 64, 64), dtype, cuda), _x((4, 128, 64, 64), dtype,
                                                 cuda)
    a = torch.rand(128, generator=cuda, device="cuda") + 0.5
    b = torch.randn(128, generator=cuda, device="cuda")
    before = residual.launches
    got = residual.bn_add_act(y, a, b, s, act)
    assert residual.launches == before + 1
    _close(got, residual.bn_add_act_reference(y, a, b, s, act), act)


@pytest.mark.parametrize("pool_size", [1, 3, 5])
def test_peak_kernel_matches_plain(cuda, pool_size):
    logits = torch.randn((4, 2, 128, 128, 6), generator=cuda,
                         device="cuda") * 3
    logits[0, 0, 10:14, 10:14, 0] = 5.0  # a plateau: ties count
    before = peak.launches
    got = peak.peak_scores(logits, 2, pool_size)
    assert peak.launches == before + 1
    _close(got, peak.peak_scores_reference(logits, 2, pool_size), "equal")


def _nonfinite(t, gen, share=0.01):
    """t with a seeded `share` of its values each set to NaN, +inf and
    -inf."""
    u = torch.rand(t.shape, generator=gen, device=t.device)
    t = t.masked_fill(u < share, float("nan"))
    t = t.masked_fill((u >= share) & (u < 2 * share), float("inf"))
    return t.masked_fill((u >= 2 * share) & (u < 3 * share), float("-inf"))


def _nan_equal(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = torch.isnan(got)
    assert torch.equal(nan, torch.isnan(want))
    assert torch.equal(got.masked_fill(nan, 0), want.masked_fill(nan, 0))


@pytest.mark.parametrize("pool_size", [3, 5])
@pytest.mark.parametrize("shape,num_cls,variant", [
    ((4, 1, 128, 128, 6), 2, "vector"),
    ((2, 1, 37, 44, 6), 2, "vector"),   # ragged tiles
    ((2, 1, 37, 46, 6), 2, "scalar"),   # w % 4 != 0
    ((2, 2, 37, 44, 7), 3, "scalar"),   # three classes
])
def test_peak_kernel_nan_inf_matches_plain(cuda, shape, num_cls, variant,
                                           pool_size):
    """NaN and +-inf logits: a window that holds a NaN has a NaN max, so
    its cell is 0, as in F.max_pool2d; bit-equal to the plain version, on
    the variant the shape should take."""
    logits = _nonfinite(torch.randn(shape, generator=cuda, device="cuda")
                        * 3, cuda)
    before = (peak.vector_launches, peak.scalar_launches)
    got = peak.peak_scores(logits, num_cls, pool_size)
    assert (peak.vector_launches - before[0],
            peak.scalar_launches - before[1]) == \
        ((1, 0) if variant == "vector" else (0, 1))
    _nan_equal(got, peak.peak_scores_reference(logits, num_cls, pool_size))
    assert not bool(torch.isnan(got).any())


def test_peak_kernel_large_pool_and_misaligned_logits(cuda):
    """Pool size 81 (past 48 KB of shared memory) on both variants, and
    logits one element into their storage (not 8-byte aligned: scalar);
    forcing the vector variant there raises."""
    logits = torch.randn((2, 1, 37, 44, 6), generator=cuda,
                         device="cuda") * 3
    for variant in ("vector", "scalar"):
        got = peak.peak_scores(logits, 2, peak.MAX_POOL_SIZE, variant)
        _close(got, peak.peak_scores_reference(logits, 2,
                                               peak.MAX_POOL_SIZE), "equal")
    base = torch.randn((2 * 64 * 64 * 6 + 1,), generator=cuda,
                       device="cuda") * 3
    view = base[1:].view(2, 1, 64, 64, 6)
    before = peak.scalar_launches
    got = peak.peak_scores(view, 2, 3)
    assert peak.scalar_launches == before + 1
    _close(got, peak.peak_scores_reference(view, 2, 3), "equal")
    with pytest.raises(RuntimeError, match="vector"):
        peak.peak_scores(view, 2, 3, variant="vector")


def _rows(t):
    return t.float().permute(0, 2, 3, 1).reshape(-1, t.shape[1])


def _sums_close(parts, want_parts, terms):
    """Column sums of two partial tensors agree within 1e-5 of the sum of
    |terms| per channel."""
    torch.cuda.synchronize()
    got, want = parts.sum(0), want_parts.sum(0)
    bound = 1e-5 * terms.abs().sum(0) + 1e-30
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_stats_kernel_matches_plain(cuda, dtype):
    x = _x((4, 128, 32, 32), dtype, cuda)
    before = epilogue.stats_launches
    s, ss = epilogue.bn_stats(x)
    assert epilogue.stats_launches == before + 1
    ws, wss = epilogue.bn_stats_reference(x)
    xr = _rows(x)
    _sums_close(s, ws, xr)
    _sums_close(ss, wss, xr * xr)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["ReLU", "Mish", "Linear"])
def test_bn_backward_kernels_match_plain(cuda, dtype, act, skip):
    shape = (4, 128, 32, 32)
    x, g = _x(shape, dtype, cuda), _x(shape, dtype, cuda)
    s = _x(shape, dtype, cuda) if skip else None
    a = torch.rand(128, generator=cuda, device="cuda") + 0.5
    b, k1, k2 = (torch.randn(128, generator=cuda, device="cuda") * 0.1
                 for _ in range(3))
    counters = (residual, "bwd_sums_launches", "bwd_dx_launches") if skip \
        else (epilogue, "bwd_sums_launches", "bwd_dx_launches")
    before = [getattr(counters[0], n) for n in counters[1:]]
    if skip:
        s1, s2 = residual.bn_add_bwd_sums(x, a, b, s, g, act)
        dx, ds = residual.bn_add_bwd_dx(x, a, b, s, g, k1, k2, act)
    else:
        s1, s2 = epilogue.bn_bwd_sums(x, a, b, g, act)
        dx, ds = epilogue.bn_bwd_dx(x, a, b, g, k1, k2, act), None
    assert [getattr(counters[0], n) for n in counters[1:]] == [
        n + 1 for n in before]
    w1, w2 = epilogue.bn_bwd_sums_reference(x, a, b, g, act, skip=s)
    wdx, wds = epilogue.bn_bwd_dx_reference(x, a, b, g, k1, k2, act, skip=s)
    dz = _rows(epilogue._dz_reference(x, a, b, g, act, s))
    _sums_close(s1, w1, dz)
    _sums_close(s2, w2, dz * _rows(x))
    _close(dx, wdx, act)
    assert dx.is_contiguous(memory_format=torch.channels_last)
    if skip:
        _close(ds, wds, act)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["ReLU", "Mish", "Linear"])
def test_bn_eval_backward_kernel_matches_plain(cuda, dtype, act, skip):
    shape = (4, 128, 32, 32)
    x, g = _x(shape, dtype, cuda), _x(shape, dtype, cuda)
    s = _x(shape, dtype, cuda) if skip else None
    a = torch.rand(128, generator=cuda, device="cuda") + 0.5
    b = torch.randn(128, generator=cuda, device="cuda") * 0.1
    mod = residual if skip else epilogue
    before = mod.eval_bwd_launches
    if skip:
        dx, ds, da, db = residual.bn_add_eval_bwd(x, a, b, s, g, act)
    else:
        (dx, da, db), ds = epilogue.bn_eval_bwd(x, a, b, g, act), None
    assert mod.eval_bwd_launches == before + 1
    wdx, wds, wda, wdb = epilogue.eval_bwd_reference(x, a, b, g, act,
                                                     skip=s)
    dz = _rows(epilogue._dz_reference(x, a, b, g, act, s))
    _sums_close(da, wda, dz * _rows(x))
    _sums_close(db, wdb, dz)
    _close(dx, wdx, act)
    assert dx.is_contiguous(memory_format=torch.channels_last)
    if skip:
        _close(ds, wds, act)


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_kernels_match_plain(cuda, dtype, normalized):
    """Both loss kernels at (4, 2, 64, 64, 6), alpha/beta 3/3 (2/4 runs
    in the train step test below) on random targets."""
    b, s, h, c = 4, 2, 64, 2
    out = (torch.randn((b, s, h, h, c + 4), generator=cuda, device="cuda")
           * 3).to(dtype)
    heat, off, wh = (torch.rand((b, h, h, k), generator=cuda, device="cuda")
                     for k in (c, 2, 2))
    mask = (torch.rand((b, h, h, 1), generator=cuda, device="cuda")
            < 0.05).float()
    kw = dict(alpha=3.0, beta=3.0, normalized=normalized)
    ops = (out, heat, off, wh, mask)
    before = (loss.fwd_launches, loss.bwd_launches)
    got = loss.loss_sums(*ops, **kw)
    cots = [torch.randn((s, b), generator=cuda, device="cuda")
            for _ in range(4)]
    dg = loss.loss_sums_bwd(*ops, *cots, **kw)
    assert (loss.fwd_launches, loss.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
    want = loss.loss_sums_reference(*ops, **kw)
    terms = loss.loss_terms_reference(*ops, **kw)
    torch.cuda.synchronize()
    for g, w, t in zip(got, want, terms):
        bound = 1e-5 * t.abs().sum(dim=(2, 3, 4)).t() + 1e-30
        assert bool(((g - w).abs() <= bound).all())
    dw = loss.loss_sums_bwd_reference(*ops, *cots, **kw)
    assert dg.dtype == dw.dtype == dtype and dg.shape == dw.shape
    g32, w32 = dg.float(), dw.float()
    assert bool(((g32 - w32).abs() <= 1e-5 * w32.abs()
                 + 1e-6 * float(w32.abs().max())).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_sums_one_launch_bit_identical(cuda, dtype):
    """`loss_sums` at the flagship's map size (b16, 128^2, 1 stack) is one
    kernel and nothing after it: the four sums are views of one result,
    the profiler sees one kernel on the card per call, two calls agree bit
    for bit, and the per-map counters are back at zero."""
    from torch.profiler import ProfilerActivity, profile
    b, s, h, c = 16, 1, 128, 2
    out = (torch.randn((b, s, h, h, c + 4), generator=cuda, device="cuda")
           * 3).to(dtype)
    heat, off, wh = (torch.rand((b, h, h, k), generator=cuda, device="cuda")
                     for k in (c, 2, 2))
    mask = (torch.rand((b, h, h, 1), generator=cuda, device="cuda")
            < 0.01).float()
    kw = dict(alpha=2.0, beta=4.0, normalized=False)
    ops = (out, heat, off, wh, mask)
    first = loss.loss_sums(*ops, **kw)  # builds, allocates the counters
    torch.cuda.synchronize()
    before = loss.fwd_launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        second = loss.loss_sums(*ops, **kw)
        torch.cuda.synchronize()
    assert loss.fwd_launches == before + 1
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert [e.name for e in kernels if "loss_fwd_kernel" in e.name] \
        and len(kernels) == 1, [e.name for e in kernels]
    assert len({t.untyped_storage().data_ptr() for t in second}) == 1
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert not bool(loss._tickets[out.device][-1].any())
    want = loss.loss_sums_reference(*ops, **kw)
    for g, w, t in zip(second, want,
                       loss.loss_terms_reference(*ops, **kw)):
        bound = 1e-5 * t.abs().sum(dim=(2, 3, 4)).t() + 1e-30
        assert bool(((g - w).abs() <= bound).all())


def _loss_operands(gen, shape, dtype, mask_kind="binary"):
    b, s, h, w, k = shape
    out = (torch.randn(shape, generator=gen, device="cuda") * 3).to(dtype)
    heat, off, wh = (torch.rand((b, h, w, c), generator=gen, device="cuda")
                     for c in (k - 4, 2, 2))
    m = torch.rand((b, h, w, 1), generator=gen, device="cuda")
    mask = (m < 0.05).float() if mask_kind == "binary" else \
        m * (torch.rand(m.shape, generator=gen, device="cuda") < 0.3)
    cots = [torch.randn((s, b), generator=gen, device="cuda")
            for _ in range(4)]
    return (out, heat, off, wh, mask), cots


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_backward_non_binary_mask_bit_equal(cuda, dtype, normalized):
    """A mask of fractions and zeros (a guard for any later branch on the
    mask's value), and NaN and +-inf among the logits: d(out) equal to
    the plain version, NaN where it is NaN."""
    ops, cots = _loss_operands(cuda, (4, 2, 64, 64, 6), dtype, "fractions")
    kw = dict(alpha=2.0, beta=4.0, normalized=normalized)
    before = loss.bwd_vector_launches
    got = loss.loss_sums_bwd(*ops, *cots, **kw)
    assert loss.bwd_vector_launches == before + 1
    assert bool(torch.isfinite(got).all())
    _close(got, loss.loss_sums_bwd_reference(*ops, *cots, **kw), "equal")
    ops = (_nonfinite(ops[0], cuda),) + ops[1:]
    _nan_equal(loss.loss_sums_bwd(*ops, *cots, **kw),
               loss.loss_sums_bwd_reference(*ops, *cots, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_backward_one_launch_bit_identical(cuda, dtype):
    """`loss_sums_bwd` at the flagship's map size is one kernel on the
    card and nothing else, and two calls give the same d(out) bit for
    bit; cotangents that are expanded views at S = 2 are read in place
    (no copy: still one kernel) and give what their copies give."""
    from torch.profiler import ProfilerActivity, profile
    ops, cots = _loss_operands(cuda, (16, 1, 128, 128, 6), dtype)
    kw = dict(alpha=2.0, beta=4.0, normalized=False)
    first = loss.loss_sums_bwd(*ops, *cots, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        second = loss.loss_sums_bwd(*ops, *cots, **kw)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "loss_bwd_vec_kernel" in kernels[0], \
        kernels
    assert torch.equal(first, second)
    ops, _ = _loss_operands(cuda, (4, 2, 64, 64, 6), dtype)
    cots = [torch.randn((2, 1), generator=cuda, device="cuda")
            .expand(2, 4) for _ in range(4)]
    assert not cots[0].is_contiguous()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = loss.loss_sums_bwd(*ops, *cots, **kw)
        torch.cuda.synchronize()
    assert len([e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]) == 1
    _close(got, loss.loss_sums_bwd(*ops, *(c.contiguous() for c in cots),
                                   **kw), "equal")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_backward_scalar_kernel(cuda, dtype):
    """H*W % 4 != 0 and out one element into its storage take the scalar
    kernel, bit-equal to the plain version; forcing the vector kernel on
    them raises."""
    ops, cots = _loss_operands(cuda, (3, 2, 37, 45, 6), dtype)
    kw = dict(alpha=2.0, beta=4.0, normalized=False)
    before = loss.bwd_scalar_launches
    got = loss.loss_sums_bwd(*ops, *cots, **kw)
    assert loss.bwd_scalar_launches == before + 1
    _close(got, loss.loss_sums_bwd_reference(*ops, *cots, **kw), "equal")
    with pytest.raises(RuntimeError, match="vector"):
        loss.loss_sums_bwd(*ops, *cots, **kw, variant="vector")
    (out, *targets), cots = _loss_operands(cuda, (3, 2, 36, 44, 6), dtype)
    base = torch.empty(out.numel() + 1, dtype=dtype, device="cuda")
    view = base[1:].view(out.shape)
    view.copy_(out)
    got = loss.loss_sums_bwd(view, *targets, *cots, **kw)
    assert loss.bwd_scalar_launches == before + 2
    _close(got, loss.loss_sums_bwd_reference(view, *targets, *cots, **kw),
           "equal")


def test_small_eval_gradient_card_matches_cpu(cuda, monkeypatch):
    """The gradient of the fused loss through a small model in eval mode
    (seeded weights, random BN state, TF32 off) through the kernels on
    the card against the CPU path: every parameter gets a non-zero
    gradient on the card, and the gradients taken as one vector are
    within rel L2 1e-4 of the CPU's (convolutions summed in other orders;
    no batch statistics amplify it)."""
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        synthetic_target_batch
    from real_time_helmet_detection_tpu_torch.evaluate import init_weights
    from real_time_helmet_detection_tpu_torch.models.hourglass import (
        BatchNorm, Residual, build_model)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = Config(device="cpu", hourglass_inch=16, batch_size=2)
    arrs = [torch.from_numpy(a) for a in synthetic_target_batch(2, 64)]
    model = init_weights(build_model(cfg), seed=2)
    gen = torch.Generator().manual_seed(2)
    for m in model.modules():
        if hasattr(m, "folded"):
            m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                             generator=gen) * 0.1)
            m.running_var.copy_(torch.rand(m.running_var.shape,
                                           generator=gen) + 0.5)
    card = build_model(cfg)
    card.load_state_dict(model.state_dict())
    before = (epilogue.eval_bwd_launches, residual.eval_bwd_launches)
    grads = []
    for m, dev in ((model.eval(), "cpu"), (card.to("cuda").eval(), "cuda")):
        a = [t.to(dev) for t in arrs]
        loss.fused_detection_loss(m(a[0]), *a[1:])["total"].backward()
        grads.append({n: p.grad.cpu().double() for n, p in
                      m.named_parameters()})
    # one launch per BN site: a tail per Residual block, an epilogue at
    # every other BN (at width 16 the stem has one projection more than
    # the flagship's 20 epilogues)
    tails = sum(isinstance(m, Residual) for m in card.modules())
    sites = sum(isinstance(m, BatchNorm) for m in card.modules())
    assert (epilogue.eval_bwd_launches - before[0],
            residual.eval_bwd_launches - before[1]) == (sites - tails, tails)
    cpu, gpu = grads
    assert all(float(g.abs().max()) > 0 for g in gpu.values())
    num = sum(float((gpu[n] - cpu[n]).square().sum()) for n in cpu)
    den = sum(float(cpu[n].square().sum()) for n in cpu)
    assert (num / den) ** 0.5 <= 1e-4


def test_small_train_step_card_matches_cpu(cuda, monkeypatch):
    """One f32 train step (TF32 off) of a small model through the kernels
    on the card against the CPU path: loss rtol 1e-5, every gradient
    rtol 5e-3, atol 1e-4, the running statistics rtol 1e-3, atol 1e-5
    (cuDNN and oneDNN sum convolutions in other orders).

    The weights are seeded and cuDNN's algorithms deterministic: the f32
    gradient of a narrow random network at batch 2 is sensitive to
    summation order (a last-bit difference can flip a ReLU or max-pool
    decision, and the BatchNorms behind spread that over their
    channels), so for some weights even the card's plain path and the
    CPU path, no kernel involved, differ beyond this pin."""
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        synthetic_target_batch
    from real_time_helmet_detection_tpu_torch.evaluate import init_weights
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        build_model
    from real_time_helmet_detection_tpu_torch.train import loss_fn
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = Config(device="cpu", hourglass_inch=16, batch_size=2)
    arrs = [torch.from_numpy(a) for a in synthetic_target_batch(2, 128)]
    model = init_weights(build_model(cfg), seed=1).train()
    card = build_model(cfg)
    card.load_state_dict(model.state_dict())
    card = card.to("cuda").train()
    results = []
    for m, dev in ((model, "cpu"), (card, "cuda")):
        total, _ = loss_fn(m, *(a.to(dev) for a in arrs), cfg)
        total.backward()
        results.append((total.item(), {n: p.grad.cpu() for n, p in
                                       m.named_parameters()},
                        {n: b.cpu() for n, b in m.named_buffers()}))
    (lc, gc, bc), (lg, gg, bg) = results
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for n in gc:
        torch.testing.assert_close(gg[n], gc[n], rtol=5e-3, atol=1e-4)
    for n in bc:
        torch.testing.assert_close(bg[n], bc[n], rtol=1e-3, atol=1e-5)


def test_small_model_card_matches_cpu(cuda):
    """The whole network through the kernels on the card against the CPU
    path (plain versions); f32 with TF32 off, atol = rtol = 1e-4 for the
    conv summation order."""
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.evaluate import \
        load_eval_state
    cfg = Config(device="cpu", imsize=64, hourglass_inch=32, num_stack=2)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    model = load_eval_state(cfg)
    for m in model.modules():  # BN scales below 1: O(1) logits
        if hasattr(m, "folded"):
            m.weight.data.fill_(0.4)
    with torch.inference_mode():
        want = model(x)
        torch.backends.cudnn.allow_tf32 = False
        got = model.to("cuda")(x.cuda()).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("nms", ["nms", "soft-nms", "maxpool"])
def test_serving_engine_rows_bit_equal_to_eager(cuda, nms):
    """The serving engine on the card (one CUDA graph per bucket, each
    NMS mode inside it): each bucket's rows, served as one batch, equal
    the eager predict at that batch size bit for bit; no bucket is
    captured again."""
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.evaluate import \
        load_eval_state
    from real_time_helmet_detection_tpu_torch.obs.metrics import \
        MetricsRegistry
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    from real_time_helmet_detection_tpu_torch.serving import ServingEngine
    cfg = Config(imsize=64, hourglass_inch=32, topk=16, nms=nms)
    model = load_eval_state(cfg)
    for m in model.modules():  # BN scales below 1: O(1) logits
        if hasattr(m, "folded"):
            m.weight.data.fill_(0.4)
    predict = make_predict_fn(model, cfg, normalize="imagenet")
    images = np.random.default_rng(0).integers(0, 256, (4, 64, 64, 3),
                                               dtype=np.uint8)
    with ServingEngine(predict, None, (64, 64, 3), np.uint8,
                       buckets=(1, 2, 4), max_wait_ms=20.0,
                       metrics=MetricsRegistry()) as engine:
        for b in (1, 2, 4):
            futs = [engine.submit(img) for img in images[:b]]
            rows = [f.result(timeout=60) for f in futs]
            assert all(f.bucket == b for f in futs)
            want = [t.cpu().numpy() for t in predict(images[:b])]
            for i, row in enumerate(rows):
                assert all(np.array_equal(got, leaf[i])
                           for got, leaf in zip(row, want))
        assert engine.stats()["bucket_builds"] == 3


# ------------------------------------------------- int8 kernels (#14 - #16)

# (N, Cin, H, W, Cout, k, storage offset of the input, bytes): W and H
# no multiple of the box, one image at 8^2 and 1^2, Cout 8, 24, 200 and
# 264 (two channel blocks), Cin 16, 48 and 144, a view 16 bytes in
QDENSE = [(2, 16, 5, 7, 8, 1, 0), (3, 48, 9, 13, 24, 3, 0),
          (2, 144, 11, 6, 72, 3, 0), (1, 96, 33, 17, 48, 1, 0),
          (2, 128, 16, 16, 128, 3, 0), (5, 16, 17, 19, 200, 3, 0),
          (1, 128, 8, 8, 128, 3, 0), (1, 64, 1, 1, 96, 3, 0),
          (2, 32, 20, 37, 264, 1, 0), (1, 48, 23, 29, 264, 3, 0),
          (2, 64, 13, 21, 96, 3, 16)]
# (N, C, H, W, storage offset): C % 16 != 0 (the gather kernel only),
# channel tiles of 64 and a ragged one, one image at 8^2 and 1^2
QDW = [(1, 8, 5, 7, 0), (3, 48, 9, 13, 0), (2, 136, 11, 6, 0),
       (1, 48, 8, 8, 0), (1, 16, 1, 1, 0), (2, 144, 19, 37, 0),
       (3, 80, 17, 33, 0), (2, 48, 13, 21, 16)]


def _q_operands(shape, wshape, cout, gen, offset=0):
    n, c, h, w = shape
    base = torch.randint(-127, 128, (n * h * w * c + offset,), generator=gen,
                         device="cuda", dtype=torch.int8)
    q = base[offset:].view(n, h, w, c).permute(0, 3, 1, 2)
    w = torch.randint(-127, 128, wshape, generator=gen, device="cuda",
                      dtype=torch.int8)
    mult = torch.rand((cout,), generator=gen, device="cuda") * 1e-3 + 1e-5
    bias = torch.randn((cout,), generator=gen, device="cuda")
    return q, w, mult, bias


@pytest.mark.parametrize("variant", [None, "wgmma", "mma"])
@pytest.mark.parametrize("case", QDENSE, ids=str)
def test_qconv_dense_matches_plain(cuda, case, variant):
    """Each kernel (None: the plan's) bit-equal to the plain version in
    int32, f32 and bf16; the plan's choice is counted on its kernel."""
    from real_time_helmet_detection_tpu_torch.ops import qconv
    n, cin, h, w, cout, k, offset = case
    q, wq, mult, bias = _q_operands((n, cin, h, w), (cout, k, k, cin), cout,
                                    cuda, offset)
    before = qconv.dense_wgmma_launches
    for dtype in (torch.int32, torch.float32, torch.bfloat16):
        for act in ("Linear", "ReLU"):
            if dtype == torch.int32 and act == "ReLU":
                continue
            got = qconv.conv_dense_variant(q, wq, mult, bias, dtype, act,
                                           variant)
            want = qconv.conv_dense_reference(q, wq, mult, bias, dtype, act)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and torch.equal(got, want)
    if variant is None:
        assert qconv.dense_wgmma_launches == before + 5


@pytest.mark.parametrize("variant", [None, "tiled", "gather"])
@pytest.mark.parametrize("case", QDW, ids=str)
def test_qconv_dw_matches_plain(cuda, case, variant):
    from real_time_helmet_detection_tpu_torch.ops import qconv
    n, c, h, w, offset = case
    if variant == "tiled" and c % 16:
        with pytest.raises(ValueError):
            qconv.dw_plan(n, h, w, c, variant)
        return
    q, wq, mult, bias = _q_operands((n, c, h, w), (9, c), c, cuda, offset)
    for dtype in (torch.int32, torch.float32, torch.bfloat16):
        for act in ("Linear", "ReLU"):
            if dtype == torch.int32 and act == "ReLU":
                continue
            got = qconv.conv_dw_variant(q, wq, mult, bias, dtype, act,
                                        variant)
            want = qconv.conv_dw_reference(q, wq, mult, bias, dtype, act)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_act_matches_plain(cuda, dtype):
    """Random values, ties at .5, +-inf, NaN and saturation; odd element
    counts (the kernel's tail loop)."""
    from real_time_helmet_detection_tpu_torch.ops import qconv
    step = torch.tensor(0.25, device="cuda")
    special = torch.tensor([0.125, -0.125, 0.375, 31.875, -31.875,
                            float("inf"), float("-inf"), float("nan"),
                            1e30, -1e30], device="cuda")
    for shape in ((3, 5, 7, 9), (2, 16, 9, 13)):
        x = torch.randn(shape, generator=cuda, device="cuda") * 20
        x.view(-1)[:special.numel()] = special
        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
        got = qconv.quantize_act(x, step)
        torch.cuda.synchronize()
        assert torch.equal(got, qconv.quantize_act_reference(x, step))
    flat = qconv.quantize_act(
        special.view(1, -1, 1, 1).contiguous(
            memory_format=torch.channels_last), step).view(-1).tolist()
    assert flat == [0, 0, 2, 127, -127, 127, -127, 0, 127, -127]


@pytest.mark.parametrize("variant", ["wgmma", "mma", "tiled", "gather"])
def test_int8_conv_codes_match_plain(cuda, variant):
    """A conv's code outputs on each kernel: the float output (where
    stored) and the codes of it at a channel offset of a wider tensor
    (whose other channels stay) and alone, bit-equal to the plain
    version's."""
    from real_time_helmet_detection_tpu_torch.ops import qconv
    dw = variant in ("tiled", "gather")
    c, cout = (48, 48) if dw else (64, 96)
    shape = (2, c, 13, 21)
    q, wq, mult, bias = _q_operands(shape, (9, c) if dw else (cout, 3, 3, c),
                                    cout, cuda)
    conv = qconv.conv_dw_variant if dw else qconv.conv_dense_variant
    ref = qconv.conv_dw_reference if dw else qconv.conv_dense_reference
    steps = (torch.tensor(0.017, device="cuda"),
             torch.tensor(0.05, device="cuda"))
    for dtype in (torch.float32, torch.bfloat16):
        for store in (True, False):
            outs = [torch.full((2, n, 13, 21), 7, dtype=torch.int8,
                               device="cuda").contiguous(
                                   memory_format=torch.channels_last)
                    for n in (2 * cout, cout)]
            got = conv(q, wq, mult, bias, dtype, "ReLU", variant, store,
                       [(outs[0], steps[0], cout), (outs[1], steps[1], 0)])
            want = ref(q, wq, mult, bias, dtype, "ReLU")
            torch.cuda.synchronize()
            assert (got is None) != store
            if store:
                assert torch.equal(got, want)
            assert torch.equal(outs[0][:, cout:],
                               qconv.quantize_act_reference(want, steps[0]))
            assert bool((outs[0][:, :cout] == 7).all())
            assert torch.equal(outs[1],
                               qconv.quantize_act_reference(want, steps[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_abs_max_and_two_steps_match_plain(cuda, dtype):
    """The abs-max (NaN, +-inf, -0.0; many launches on one ticket) and
    the quantizer at two steps against their plain versions."""
    from real_time_helmet_detection_tpu_torch.ops import qconv
    for shape in ((16, 96, 64, 64), (3, 5, 7, 9), (1, 1, 1, 1)):
        x = (torch.randn(shape, generator=cuda, device="cuda") * 3).to(
            dtype).contiguous(memory_format=torch.channels_last)
        for _ in range(3):
            assert torch.equal(qconv.abs_max(x), qconv.abs_max_reference(x))
        s1 = torch.tensor(0.02, device="cuda")
        s2 = torch.tensor(0.07, device="cuda")
        a, b = qconv.quantize_act(x, s1, s2)
        assert torch.equal(a, qconv.quantize_act_reference(x, s1))
        assert torch.equal(b, qconv.quantize_act_reference(x, s2))
        flat = x.permute(0, 2, 3, 1).view(-1)
        flat[-1] = float("-inf")
        assert qconv.abs_max(x).item() == float("inf")
        flat[0] = float("nan")
        assert bool(torch.isnan(qconv.abs_max(x)))
    zeros = torch.full((4, 8, 4, 4), -0.0, dtype=dtype, device="cuda")
    got = qconv.abs_max(zeros)
    assert got.item() == 0.0 and not bool(torch.signbit(got))


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from real_time_helmet_detection_tpu_torch.ops import qconv
    q, wq, mult, bias = _q_operands((2, 32, 8, 8), (16, 3, 3, 32), 16, cuda)
    base = torch.zeros(2 * 32 * 8 * 8 + 1, dtype=torch.int8, device="cuda")
    cases = [
        lambda: qconv.conv_dense(base[1:].view(2, 8, 8, 32).permute(
            0, 3, 1, 2), wq, mult, bias, torch.float32),     # misaligned
        lambda: qconv.conv_dense(q.contiguous(), wq, mult, bias,
                                 torch.float32),             # NCHW layout
        lambda: qconv.conv_dense(
            q[:, :24].contiguous(memory_format=torch.channels_last),
            wq[..., :24].contiguous(), mult, bias, torch.float32),  # Cin 24
        lambda: qconv.conv_dense(q, wq, mult[:8], bias[:8],
                                 torch.float32),             # vectors
        lambda: qconv.conv_dw(q, torch.zeros((9, 30), dtype=torch.int8,
                                             device="cuda"),
                              mult, bias, torch.float32),    # weights
        lambda: qconv.quantize_act(
            torch.zeros(17, device="cuda")[1:].view(1, 1, 1, 16),
            torch.tensor(1.0, device="cuda")),               # misaligned
        lambda: qconv.quantize_act(
            torch.zeros((1, 8, 2, 2), device="cuda").contiguous(
                memory_format=torch.channels_last),
            torch.tensor(1.0)),                              # step on cpu
    ]
    for fn in cases:
        with pytest.raises(ValueError):
            fn()


def test_int8_serving_rows_bit_equal_to_eager(cuda):
    """The int8 twin through the serving engine at `--tier throughput`'s
    architecture (small): each bucket's rows equal the eager int8 predict
    at that batch size bit for bit; a reload with new weights and scales
    captures nothing."""
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.evaluate import \
        load_eval_state
    from real_time_helmet_detection_tpu_torch.obs.metrics import \
        MetricsRegistry
    from real_time_helmet_detection_tpu_torch.ops import quant
    from real_time_helmet_detection_tpu_torch.predict import make_predict_fn
    from real_time_helmet_detection_tpu_torch.serving import ServingEngine
    cfg = Config(imsize=64, variant="ghost", hourglass_inch=32,
                 stem_width=32, topk=16, infer_dtype="int8", amp=True)
    model = load_eval_state(cfg)
    for m in model.modules():  # BN scales below 1: O(1) logits
        if hasattr(m, "folded"):
            m.weight.data.fill_(0.4)
    images = np.random.default_rng(0).integers(0, 256, (4, 64, 64, 3),
                                               dtype=np.uint8)
    scales = quant.calibrate_scales(cfg, model.state_dict(), [images],
                                    dtype=torch.bfloat16,
                                    normalize="imagenet")
    predict = make_predict_fn(model, cfg, normalize="imagenet",
                              quant_scales=scales)
    with ServingEngine(predict, None, (64, 64, 3), np.uint8,
                       buckets=(1, 2, 4), max_wait_ms=20.0,
                       metrics=MetricsRegistry()) as engine:
        for b in (1, 2, 4):
            futs = [engine.submit(img) for img in images[:b]]
            rows = [f.result(timeout=60) for f in futs]
            assert all(f.bucket == b for f in futs)
            want = [t.cpu().numpy() for t in predict(images[:b])]
            for i, row in enumerate(rows):
                assert all(np.array_equal(got, leaf[i])
                           for got, leaf in zip(row, want))
        for m in model.modules():
            if hasattr(m, "folded"):
                m.weight.data.fill_(0.3)
        engine.reload(model.state_dict(), scales=scales)
        futs = [engine.submit(img) for img in images]
        rows = [f.result(timeout=60) for f in futs]
        want = [t.cpu().numpy() for t in predict(images)]
        for i, row in enumerate(rows):
            assert all(np.array_equal(got, leaf[i])
                       for got, leaf in zip(row, want))
        assert engine.stats()["bucket_builds"] == 3


def _helmet_cases(gen):
    """op -> (its arguments, its plain version, a direct call of its C
    entry into a given output), at small shapes on the card, each on the
    kernel its shape and alignment take."""
    from real_time_helmet_detection_tpu_torch.ops import _build, qconv
    stream = torch.cuda.current_stream().cuda_stream
    x = _x((2, 64, 9, 13), torch.bfloat16, gen)
    skip = _x((2, 64, 9, 13), torch.bfloat16, gen)
    a = torch.rand(64, generator=gen, device="cuda") + 0.5
    b = torch.randn(64, generator=gen, device="cuda")
    logits = torch.randn((2, 1, 37, 44, 6), generator=gen, device="cuda") * 3
    tiles = 2 * peak.tiles(37, 44)[0] * peak.tiles(37, 44)[1]
    step = torch.tensor(0.05, device="cuda")
    q, wq, mult, bias = _q_operands((2, 64, 13, 21), (96, 3, 3, 64), 96, gen)
    qd, wd, md, bd = _q_operands((2, 48, 13, 21), (9, 48), 48, gen)
    plan = qconv.dense_plan(2, 13, 21, 64, 96, 3, 2)
    dw = qconv.dw_plan(2, 13, 21, 48)
    p = lambda t: t.data_ptr()  # noqa: E731
    return {
        "peak_scores": (
            (logits, 2, 3, tiles, "auto"),
            lambda: peak.peak_scores_reference(logits, 2, 3),
            lambda o: _build.load("peak").helmet_peak_scores(
                p(logits), p(o), 2, 2, 37, 44, 6, 1, tiles, 1, stream)),
        "bn_act": (
            (x, a, b, "ReLU", "auto"),
            lambda: epilogue.bn_act_reference(x, a, b, "ReLU"),
            lambda o: _build.load("epilogue").helmet_bn_act_vec(
                p(x), p(a), p(b), p(o), x.numel(), 64, 1, 0, stream)),
        "bn_add_act": (
            (x, a, b, skip, "Linear"),
            lambda: residual.bn_add_act_reference(x, a, b, skip, "Linear"),
            lambda o: _build.load("residual").helmet_bn_add_act(
                p(x), p(a), p(b), p(skip), p(o), x.numel(), 64, 1, 2,
                stream)),
        "quantize_act": (
            (x, step),
            lambda: qconv.quantize_act_reference(x, step),
            lambda o: _build.load("qconv").helmet_quantize(
                p(x), p(step), p(o), None, None, x.numel(), 1, stream)),
        "qconv_dense": (
            (q, wq, mult, bias, 1, "ReLU", plan.variant, plan.box[1],
             plan.box[2], plan.n, plan.stages),
            lambda: qconv.conv_dense_reference(q, wq, mult, bias,
                                               torch.bfloat16, "ReLU"),
            lambda o: _build.load("qconv").helmet_qconv_wgmma(
                p(q), p(wq), p(mult), p(bias), p(o), 2, 13, 21, 64, 96, 3,
                plan.box[1], plan.box[2], plan.n, plan.stages, 1, 0, None,
                stream)),
        "qconv_dw": (
            (qd, wd, md, bd, 1, "Linear", dw.variant, *dw.tile, dw.ct),
            lambda: qconv.conv_dw_reference(qd, wd, md, bd, torch.bfloat16,
                                            "Linear"),
            lambda o: _build.load("qconv").helmet_qconv_dw_tile(
                p(qd), p(wd), p(md), p(bd), p(o), 2, 13, 21, 48, *dw.tile,
                dw.ct, 1, 2, None, stream)),
    }


@pytest.mark.parametrize("name", ["peak_scores", "bn_act", "bn_add_act",
                                  "quantize_act", "qconv_dense", "qconv_dw"])
def test_helmet_op_matches_plain_and_its_c_entry(cuda, name):
    """Each `helmet` op's CUDA implementation, called through
    `torch.ops.helmet`, bit-equal to its plain version and to a direct
    `ctypes` call of its C entry (the route of the wrappers before the
    ops)."""
    args, plain, direct = _helmet_cases(cuda)[name]
    got = getattr(torch.ops.helmet, name)(*args)
    out = torch.empty_like(got)
    assert direct(out) == 0
    torch.cuda.synchronize()
    want = plain()
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(out, got)


def test_c_variant_picks_follow_the_python_rules(cuda):
    """`helmet_peak_pick` and `helmet_bn_act_pick`, the launch-time choices
    of both op registrations, agree with `peak.peak_variant` and
    `epilogue.bn_act_variant` on aligned and misaligned pointers."""
    from real_time_helmet_detection_tpu_torch.ops import _build
    pk, ep = _build.load("peak"), _build.load("epilogue")
    for num_cls, k, w in ((2, 6, 44), (2, 6, 43), (3, 7, 44), (2, 5, 8)):
        for lp, op in ((256, 512), (260, 512), (256, 520), (264, 528)):
            want = peak.peak_variant(num_cls, k, w, lp, op) == "vector"
            assert pk.helmet_peak_pick(lp, op, num_cls, k, w) == want
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for c in (4, 6, 8, 64, 1024, 2048, 2056):
            for xp, op in ((256, 512), (258, 512), (256, 520)):
                want = epilogue.bn_act_variant(c, dtype, xp, op) == "vector"
                assert ep.helmet_bn_act_pick(xp, op, c, code) == want
