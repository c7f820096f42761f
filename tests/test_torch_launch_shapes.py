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
  zeros, reused while large enough, never freed;
* `ops.loss.bwd_variant` picks the backward's kernel that stages tiles
  through shared memory in 16-byte pieces, or its scalar kernel, from
  H*W, the channel count, the dtype and the six pointers' alignment;
  `ops.loss.bwd_tiles` cuts each map into its BWD_TILE_PIXELS tiles;
* `ops.peak.peak_variant` picks the peak kernel's vector variant (two
  classes, 8-byte heat pairs, 16-byte stores) or its scalar one;
  `ops.peak.tiles` cuts each map into TILE_H x TILE_W tiles, and
  `ops.peak.smem_bytes` is a block's shared memory, which MAX_POOL_SIZE
  keeps inside what a block may opt into.

The JAX reference is the tiling contract of ref
ops/pallas/epilogue.py:506-510 (the (rows, C) block),
ops/pallas/loss.py:86 and :126 (one program per (stack, sample) map)
and ops/pallas/peak.py:68 (one program per class map).
"""

import pytest
import torch

from real_time_helmet_detection_tpu_torch.ops import (_build, epilogue, loss,
                                                      peak)

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


# ------------------------------------------------------ loss backward


@pytest.mark.parametrize("tag", DTYPES)
@pytest.mark.parametrize("hw", [128 * 128, 64 * 64, 36 * 44, 4, 1024])
def test_loss_backward_vector_variant_for_whole_vectors(tag, hw):
    assert loss.bwd_variant(hw, 2, DTYPES[tag], *([256] * 6)) == "vector"


@pytest.mark.parametrize("tag", DTYPES)
@pytest.mark.parametrize("hw", [37 * 45, 6, 130, 1023])
def test_loss_backward_scalar_variant_for_ragged_maps(tag, hw):
    """H*W % 4 != 0: a tile's runs would end inside a 16-byte piece."""
    assert loss.bwd_variant(hw, 2, DTYPES[tag], *([256] * 6)) == "scalar"


@pytest.mark.parametrize("tag", DTYPES)
@pytest.mark.parametrize("which", range(6))
def test_loss_backward_scalar_variant_for_misaligned_storage(tag, which):
    """Any one of out, heat, off, wh, mask and dout off a 16-byte
    boundary (by one element) takes the scalar kernel."""
    ptrs = [256] * 6
    ptrs[which] += 2 if which in (0, 5) and tag == "bf16" else 4
    assert loss.bwd_variant(128 * 128, 2, DTYPES[tag], *ptrs) == "scalar"


def test_loss_backward_variant_by_channel_count_and_dtype():
    """bf16 with an odd channel count K = C + 4 needs H*W % 8 == 0 for a
    map of out to be whole 16-byte pieces; f32 does not. A class count
    whose tile outgrows a block's shared memory takes the scalar
    kernel."""
    assert loss.bwd_variant(36, 3, torch.float32, 0) == "vector"
    assert loss.bwd_variant(36, 3, torch.bfloat16, 0) == "scalar"
    assert loss.bwd_variant(40, 3, torch.bfloat16, 0) == "vector"
    big = max(c for c in range(1, 200)
              if loss.bwd_smem_bytes(c, torch.float32)
              <= _build.MAX_DYNAMIC_SMEM)
    assert loss.bwd_variant(64, big, torch.float32, 0) == "vector"
    assert loss.bwd_variant(64, big + 1, torch.float32, 0) == "scalar"
    # the flagship's tile: 26 KB in f32, 20 KB in bf16
    assert loss.bwd_smem_bytes(2, torch.float32) == 512 * (6 * 4 + 7 * 4)
    assert loss.bwd_smem_bytes(2, torch.bfloat16) == 512 * (6 * 2 + 7 * 4)


@pytest.mark.parametrize("hw", [64 * 64, 128 * 128, 36 * 44, 37 * 45, 1])
def test_loss_backward_tiles_cover_every_pixel_once(hw):
    size = loss.BWD_TILE_PIXELS
    cut = [range(t * size, min((t + 1) * size, hw))
           for t in range(loss.bwd_tiles(hw))]
    assert [p for tile in cut for p in tile] == list(range(hw))
    assert all(len(tile) > 0 for tile in cut)
    if hw % 4 == 0:  # every tile is whole 16-byte pieces of every run
        assert all(len(tile) % 4 == 0 for tile in cut)


@pytest.mark.parametrize("tag", DTYPES)
def test_flagship_loss_backward_takes_the_vector_kernel(tag):
    """The train step's loss at b16 512^2: out (16, 1, 128, 128, 6) in
    f32 or bf16, fresh allocations (aligned), 32 tiles per map, 512 tiles
    in all, one wave at 4 resident blocks on each of 132 SMs (the kernel
    fits 6 at 40 registers and 26.6 KB of shared memory, so 4 is the
    least the wave needs)."""
    dtype = DTYPES[tag]
    b, s, h, w, c = 16, 1, 128, 128, 2
    out = torch.zeros((b, s, h, w, c + 4), dtype=dtype)
    ptrs = [t.data_ptr() for t in (
        out, torch.zeros(b, h, w, c), torch.zeros(b, h, w, 2),
        torch.zeros(b, h, w, 2), torch.zeros(b, h, w, 1),
        torch.empty_like(out))]
    assert loss.bwd_variant(h * w, c, dtype, *ptrs) == "vector"
    assert loss.bwd_tiles(h * w) * b * s == 512 <= 4 * 132


def test_loss_backward_variant_is_ignored_on_the_cpu():
    """A CPU tensor runs the plain version whatever variant is asked for,
    with cotangents at any strides, and no counter moves."""
    gen = torch.Generator().manual_seed(0)
    b, s, h, w = 2, 2, 5, 7
    out = torch.randn((b, s, h, w, 6), generator=gen)
    heat, off, wh = (torch.rand((b, h, w, c), generator=gen)
                     for c in (2, 2, 2))
    mask = (torch.rand((b, h, w, 1), generator=gen) < 0.2).float()
    cots = [torch.randn((s, 1), generator=gen).expand(s, b)
            for _ in range(4)]
    kw = dict(alpha=2.0, beta=4.0, normalized=False)
    before = (loss.bwd_launches, loss.bwd_vector_launches,
              loss.bwd_scalar_launches)
    want = loss.loss_sums_bwd_reference(out, heat, off, wh, mask,
                                        *(c.contiguous() for c in cots),
                                        **kw)
    for variant in (None, "vector", "scalar"):
        got = loss.loss_sums_bwd(out, heat, off, wh, mask, *cots, **kw,
                                 variant=variant)
        assert torch.equal(got, want)
    assert (loss.bwd_launches, loss.bwd_vector_launches,
            loss.bwd_scalar_launches) == before


def test_loss_backward_refuses_non_float32_cotangents():
    """The kernels read float32 cotangents in place; another dtype is
    refused rather than copied."""
    out = torch.zeros((1, 1, 2, 2, 6))
    targets = (torch.zeros(1, 2, 2, 2), torch.zeros(1, 2, 2, 2),
               torch.zeros(1, 2, 2, 2), torch.zeros(1, 2, 2, 1))
    cots = [torch.zeros(1, 1, dtype=torch.float64)] * 4
    with pytest.raises(ValueError, match="float32"):
        loss.loss_sums_bwd(out, *targets, *cots, alpha=2.0, beta=4.0,
                           normalized=False)


# ---------------------------------------------------------- peak test


@pytest.mark.parametrize("w", [128, 44, 4, 256])
def test_peak_vector_variant_for_two_classes(w):
    assert peak.peak_variant(2, 6, w, 256, 256) == "vector"


@pytest.mark.parametrize("num_cls,k,w,logits_ptr,out_ptr", [
    (1, 5, 128, 256, 256),   # one class
    (3, 7, 128, 256, 256),   # three classes
    (2, 7, 128, 256, 256),   # K odd: the heat pairs not 8-byte aligned
    (2, 6, 46, 256, 256),    # w % 4 != 0: output rows off 16 bytes
    (2, 6, 130, 256, 256),
    (2, 6, 128, 260, 256),   # logits 4 bytes off 8
    (2, 6, 128, 256, 264),   # output 8 bytes off 16
])
def test_peak_scalar_variant_for_other_shapes(num_cls, k, w, logits_ptr,
                                              out_ptr):
    assert peak.peak_variant(num_cls, k, w, logits_ptr, out_ptr) == "scalar"


@pytest.mark.parametrize("h,w", [(128, 128), (37, 44), (16, 32), (1, 1),
                                 (17, 33), (256, 96)])
def test_peak_tiles_cover_every_cell_once(h, w):
    rows, cols = peak.tiles(h, w)
    seen = {}
    for i in range(rows):
        for j in range(cols):
            cells = [(y, x)
                     for y in range(i * peak.TILE_H,
                                    min((i + 1) * peak.TILE_H, h))
                     for x in range(j * peak.TILE_W,
                                    min((j + 1) * peak.TILE_W, w))]
            assert cells, (i, j)  # no empty tile
            for cell in cells:
                seen[cell] = seen.get(cell, 0) + 1
    assert sorted(seen) == [(y, x) for y in range(h) for x in range(w)]
    assert set(seen.values()) == {1}


def test_flagship_peak_takes_the_vector_variant():
    """predict's peak test at b16 512^2: logits (16, 1, 128, 128, 6) f32,
    two classes, fresh allocations; 32 tiles per map, 512 in all, inside
    one wave (8 resident blocks of 256 threads on each of 132 SMs: the
    10.1 KB tile at pool size 3 leaves room for them)."""
    logits = torch.zeros((16, 1, 128, 128, 6))
    out = torch.empty((16, 1, 2, 128, 128))
    assert peak.peak_variant(2, 6, 128, logits.data_ptr(),
                             out.data_ptr()) == "vector"
    rows, cols = peak.tiles(128, 128)
    assert rows * cols == 32 and 16 * rows * cols == 512 <= 8 * 132
    assert peak.smem_bytes(3, "vector") == 10368
    assert 8 * (peak.smem_bytes(3, "vector") + 1024) <= 228 * 1024


@pytest.mark.parametrize("variant", ["vector", "scalar"])
def test_peak_max_pool_size_fits_shared_memory(variant):
    """MAX_POOL_SIZE is the largest pool the kernel's shared memory takes
    (two planes in the vector variant; the scalar one uses one) up to the
    C entry's bound of p = 40; every odd size up to it fits."""
    for pool_size in range(1, peak.MAX_POOL_SIZE + 1, 2):
        assert peak.smem_bytes(pool_size, variant) \
            <= _build.MAX_DYNAMIC_SMEM
        peak.check_pool_size(pool_size)
    with pytest.raises(ValueError, match="pool_size"):
        peak.check_pool_size(peak.MAX_POOL_SIZE + 2)
    assert peak.smem_bytes(peak.MAX_POOL_SIZE, "vector") == 110592


def test_peak_variant_is_ignored_on_the_cpu():
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((2, 1, 9, 10, 6), generator=gen) * 3
    before = (peak.launches, peak.vector_launches, peak.scalar_launches)
    want = peak.peak_scores_reference(logits, 2, 3)
    for variant in (None, "vector", "scalar"):
        assert torch.equal(peak.peak_scores(logits, 2, 3, variant), want)
    assert (peak.launches, peak.vector_launches,
            peak.scalar_launches) == before
