"""The PyTorch port's CUDA kernels against their plain versions, on a card.

Marked `gpu`; each test decides inside itself whether a card is present
and skips without one, so every pytest-xdist worker collects the same
tests. Run on a machine with an H100:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu

Rules: bit-equal for the peak test and the ReLU/Linear epilogue and
residual tail; Mish within rtol 1e-6 in f32 and one bf16 ulp in bf16
(the same as chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu_torch.ops import epilogue, peak, residual

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
