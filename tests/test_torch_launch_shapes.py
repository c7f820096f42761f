"""The launch arithmetic of the port's epilogue and loss kernels, on the CPU.

The kernels run only on a card; what decides how they are launched is
Python that runs anywhere:

* `ops.epilogue.bn_act_variant` picks csrc/epilogue.cu's 16-byte vector
  kernel or its scalar kernel from the channel count, the dtype and the
  data pointers' alignment; every BN site of the flagship model (128
  channels, a 64-channel stem) must take the vector kernel in f32 and
  bf16, as the flagship forward on the card requires;
* `ops.loss.fwd_tiles` cuts each (stack, sample) map into the forward
  kernel's blocks of FWD_TILE_PIXELS pixels: every pixel in exactly one
  tile, none empty;
* `ops.loss._ticket_buffer` keeps the forward kernel's per-map counters:
  zeros, reused while large enough, never freed.

The JAX reference is the tiling contract of ref
ops/pallas/epilogue.py:506-510 (the (rows, C) block) and
ops/pallas/loss.py:86 (one program per (stack, sample) map).
"""

import pytest
import torch

from real_time_helmet_detection_tpu_torch.ops import epilogue, loss

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pair(shape, dtype, offset=0):
    """A channels-last x (its storage `offset` elements into a fresh
    buffer) and a fresh output like it."""
    n, c, h, w = shape
    base = torch.zeros(n * h * w * c + offset, dtype=dtype)
    x = base[offset:].view(n, h, w, c).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    return x, torch.empty_like(x)


def _variant(x, out):
    return epilogue.bn_act_variant(x.shape[1], x.dtype, x.data_ptr(),
                                   out.data_ptr())


@pytest.mark.parametrize("tag", DTYPES)
@pytest.mark.parametrize("channels", [8, 64, 128, 256])
def test_epilogue_vector_variant_for_aligned_multiples(tag, channels):
    x, out = _pair((2, channels, 3, 5), DTYPES[tag])
    assert _variant(x, out) == "vector"


@pytest.mark.parametrize("tag,channels", [
    ("f32", 6), ("bf16", 6), ("f32", 2), ("bf16", 4), ("bf16", 12),
    ("f32", 1028), ("bf16", 2056),  # C / V above 256 groups
])
def test_epilogue_scalar_variant_for_other_channel_counts(tag, channels):
    x, out = _pair((1, channels, 2, 3), DTYPES[tag])
    assert _variant(x, out) == "scalar"


@pytest.mark.parametrize("tag", DTYPES)
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_epilogue_scalar_variant_for_misaligned_storage(tag, offset):
    x, out = _pair((2, 64, 4, 4), DTYPES[tag], offset)
    assert x.data_ptr() % 16 != 0
    assert _variant(x, out) == "scalar"
    # the output's alignment counts too
    assert epilogue.bn_act_variant(64, x.dtype, 0, 16 + 2) == "scalar"


def test_epilogue_variant_is_ignored_on_the_cpu():
    """A CPU tensor runs the plain version whatever variant is asked for,
    and no counter moves."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 6, 3, 3), generator=gen).contiguous(
        memory_format=torch.channels_last)
    a, b = torch.rand(6, generator=gen) + 0.5, torch.randn(6, generator=gen)
    before = (epilogue.launches, epilogue.vector_launches,
              epilogue.scalar_launches)
    for variant in (None, "vector", "scalar"):
        got = epilogue.bn_act(x, a, b, "ReLU", variant=variant)
        assert torch.equal(got, epilogue.bn_act_reference(x, a, b, "ReLU"))
    assert (epilogue.launches, epilogue.vector_launches,
            epilogue.scalar_launches) == before


@pytest.mark.parametrize("tag", DTYPES)
def test_flagship_epilogue_sites_take_the_vector_kernel(tag, monkeypatch):
    """Every `bn_act` call of the flagship forward (128 channels, 1 stack;
    a 64x64 input keeps it small, the channel counts are the 512^2
    model's) gets a channel count and dtype the vector kernel takes: the
    card's 20 epilogue launches per forward all go to it."""
    from real_time_helmet_detection_tpu_torch.config import Config
    from real_time_helmet_detection_tpu_torch.evaluate import init_weights
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        build_model
    dtype = DTYPES[tag]
    cfg = Config(device="cpu", imsize=64, batch_size=1,
                 amp=dtype == torch.bfloat16)
    model = init_weights(build_model(cfg, dtype=dtype if cfg.amp else None),
                         0).eval()
    seen = []
    real = epilogue.bn_act

    def spy(x, a, b, activation, variant=None):
        seen.append((x.shape[1], x.dtype,
                     epilogue.bn_act_variant(x.shape[1], x.dtype,
                                             x.data_ptr(), 0)))
        return real(x, a, b, activation, variant)

    monkeypatch.setattr(epilogue, "bn_act", spy)
    x = torch.randn((1, 64, 64, 3), generator=torch.Generator()
                    .manual_seed(0))  # NHWC, as predict feeds the model
    with torch.inference_mode():
        model(x)
    assert len(seen) == 20
    assert {c for c, _, _ in seen} == {64, 128}
    assert {d for _, d, _ in seen} == {dtype}
    assert {v for _, _, v in seen} == {"vector"}


@pytest.mark.parametrize("hw", [64 * 64, 128 * 128, 192 * 192, 33 * 33, 1])
def test_loss_forward_tiles_cover_every_pixel_once(hw):
    size = loss.FWD_TILE_PIXELS
    cut = [range(t * size, min((t + 1) * size, hw))
           for t in range(loss.fwd_tiles(hw))]
    assert [p for tile in cut for p in tile] == list(range(hw))
    assert all(len(tile) > 0 for tile in cut)


def test_loss_forward_grid_at_the_flagship():
    """b16 at 512^2 (128^2 maps, 1 stack): 32 tiles per map, 512 blocks,
    one wave at 4 resident blocks on each of the H100's 132 SMs."""
    assert loss.fwd_tiles(128 * 128) * 16 == 512 <= 4 * 132


def test_loss_ticket_buffer_is_zero_and_kept():
    dev = torch.device("cpu")
    saved = loss._tickets.pop(dev, None)
    try:
        first = loss._ticket_buffer(dev, 16)
        assert first.dtype == torch.int32 and first.numel() >= 16
        assert not bool(first.any())
        assert loss._ticket_buffer(dev, first.numel()) is first
        bigger = loss._ticket_buffer(dev, first.numel() + 1)
        assert bigger.numel() > first.numel() and not bool(bigger.any())
        held = loss._tickets[dev]
        assert len(held) == 2 and held[0] is first and held[1] is bigger
    finally:
        loss._tickets.pop(dev, None)
        if saved is not None:
            loss._tickets[dev] = saved
