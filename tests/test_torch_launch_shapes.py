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


# ---------------------------------------------- int8 convs (csrc/qconv.cu)


def _cuda_constants(kernel="mma"):
    """The `constexpr int k... = N;` constants of csrc/qconv.cu: those of
    the mma.sync kernel (the source before the wgmma kernel's section), or
    of the later kernels (kernel="later")."""
    import os
    import re
    with open(os.path.join(_build.CSRC, "qconv.cu")) as f:
        text = f.read()
    cut = text.index("constexpr int kWgRows")
    text = text[:cut] if kernel == "mma" else text[cut:]
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", text)}


def _dense_smem(c, cin):
    """csrc/qconv.cu `dense_smem`: two stages of kBM + kBN rows, each the
    stage's K bytes (at most kMaxBK) + kPadB, and the tile's pixel
    table."""
    row = min(-(-cin // 32) * 32, c["kMaxBK"]) + c["kPadB"]
    return 2 * (c["kBM"] + c["kBN"]) * row + 4 * c["kBM"]


def test_qconv_dense_geometry_fits_the_block():
    c = _cuda_constants()
    # four warps, each two m16 tiles of rows and eight n8 tiles of columns
    assert c["kQThreads"] // 32 * 2 * 16 == c["kBM"] and 8 * 8 == c["kBN"]
    # a thread stages one 16-byte column of kRowsPerThread rows: 8
    # columns x 16 rows of threads cover the widest stage and the tile
    assert c["kMaxBK"] == 8 * 16
    assert (c["kQThreads"] // 8) * (c["kBM"] // (c["kQThreads"] // 8)) \
        == c["kBM"]
    for cin in (16, 48, 64, 96, 128, 144, 256):
        assert _dense_smem(c, cin) <= _build.MAX_DYNAMIC_SMEM
    assert _dense_smem(c, 256) > 48 * 1024  # opted into past the default


@pytest.mark.parametrize("n,h,w,cout", [(16, 256, 256, 48), (16, 128, 128,
                                                              128),
                                        (3, 9, 13, 24), (5, 17, 19, 200),
                                        (1, 1, 1, 8)])
def test_qconv_dense_tiles_cover_every_output_once(n, h, w, cout):
    """The grid: ceil(Cout / kBN) channel blocks x ceil(N*H*W / kBM)
    pixel blocks; every block gets whole n8 tiles."""
    c = _cuda_constants()
    gx, gy = -(-cout // c["kBN"]), -(-(n * h * w) // c["kBM"])
    cols = [min(c["kBN"], cout - bx * c["kBN"]) for bx in range(gx)]
    assert all(0 < x and x % 8 == 0 for x in cols) and sum(cols) == cout
    rows = [min(c["kBM"], n * h * w - by * c["kBM"]) for by in range(gy)]
    assert all(r > 0 for r in rows) and sum(rows) == n * h * w


@pytest.mark.parametrize("cin,k", [(16, 1), (48, 3), (96, 1), (128, 3),
                                   (144, 3), (256, 1)])
def test_qconv_dense_stages_cover_k_once(cin, k):
    """The stages: each tap x chunks of kMaxBK input channels, each
    staged to a whole number of 32-byte mma steps."""
    c = _cuda_constants()
    for tap in range(k * k):
        starts = list(range(0, cin, c["kMaxBK"]))
        widths = [min(c["kMaxBK"], cin - c0) for c0 in starts]
        staged = [-(-x // 32) * 32 for x in widths]
        assert sum(widths) == cin
        assert all(x % 16 == 0 for x in widths)  # Cin % 16 == 0
        assert all(0 <= s - x < 32 and s <= c["kMaxBK"]
                   for s, x in zip(staged, widths))


def test_qconv_wrappers_refuse_other_geometry_on_the_cpu():
    from real_time_helmet_detection_tpu_torch.ops import qconv
    q = torch.zeros((1, 16, 4, 4), dtype=torch.int8).contiguous(
        memory_format=torch.channels_last)
    v = torch.zeros(8)
    with pytest.raises(ValueError):  # a 5x5 kernel
        qconv.conv_dense(q, torch.zeros((8, 5, 5, 16), dtype=torch.int8), v,
                         v, torch.float32)
    with pytest.raises(ValueError):  # not channels-last
        qconv.conv_dense(q.contiguous(), torch.zeros(
            (8, 1, 1, 16), dtype=torch.int8), v, v, torch.float32)
    with pytest.raises(NotImplementedError):  # an activation not fused
        qconv.conv_dense(q, torch.zeros((8, 1, 1, 16), dtype=torch.int8), v,
                         v, torch.float32, "Mish")
    with pytest.raises(ValueError):  # depthwise weights of another width
        qconv.conv_dw(q, torch.zeros((9, 8), dtype=torch.int8), v, v,
                      torch.float32)


@pytest.mark.parametrize("name,kw", [
    ("throughput", dict(tier="throughput")),
    ("flagship-int8", dict(infer_dtype="int8")),
    ("depthwise-int8", dict(infer_dtype="int8", variant="depthwise",
                            hourglass_inch=32)),
    ("quality-int8", dict(infer_dtype="int8", num_stack=2,
                          increase_ch=8, stem_width=48))])
def test_int8_forward_sites_match_the_derivation(name, kw, monkeypatch):
    """Every int8 conv of a forward of the twin (64x64 input; the sites
    do not depend on the size) calls one conv wrapper: as many dense and
    depthwise calls as chip_smoke.py's `qconv_sites` derives, one fewer
    conv in all than `bn_sites` has BN sites (the stem stays float), and
    no BN kernel. The quantizer runs where no int8 conv writes its
    consumer's codes: once a fusing block (at two steps where a
    projection takes the block's input) and once per conv of any other
    block (`quant_walk`); the convs that write codes are `code_walk`'s.
    Throughput tier and flagship: 18 quantizer calls, one of them at two
    steps (19 quantized sites), where the unfused twin makes 70 and 36."""
    import os
    import sys

    from real_time_helmet_detection_tpu_torch.config import (Config,
                                                             apply_tier)
    from real_time_helmet_detection_tpu_torch.ops import qconv, quant
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke
    cfg = apply_tier(Config(device="cpu", imsize=64, **kw))
    twin = quant.make_quant_model(cfg, mode="int8").eval()
    calls = {"quant": 0, "dual": 0, "dense": 0, "dw": 0, "bn": 0,
             "dense_codes": 0, "dw_codes": 0}

    def counting(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            if key == "quant" and (len(a) > 2 or "step2" in k):
                calls["dual"] += 1
            if key in ("dense", "dw") and (k.get("codes")
                                           or (a[7] if len(a) > 7 else ())):
                calls[key + "_codes"] += 1
            return fn(*a, **k)
        return wrapper
    monkeypatch.setattr(qconv, "quantize_act",
                        counting("quant", qconv.quantize_act))
    monkeypatch.setattr(qconv, "conv_dense",
                        counting("dense", qconv.conv_dense))
    monkeypatch.setattr(qconv, "conv_dw", counting("dw", qconv.conv_dw))
    monkeypatch.setattr(epilogue, "bn_act", counting("bn", epilogue.bn_act))
    with torch.inference_mode():
        twin(torch.zeros((1, 64, 64, 3)))
    dense, dw = chip_smoke.qconv_sites(cfg)
    epi, tail = chip_smoke.bn_sites(cfg)
    assert (calls["dense"], calls["dw"]) == (dense, dw)
    assert dense + dw == len(epi) + len(tail) - 1
    assert (calls["quant"], calls["dual"]) == chip_smoke.quant_walk(cfg)
    assert (calls["dense_codes"], calls["dw_codes"]) == \
        chip_smoke.code_walk(cfg)
    assert calls["bn"] == 0
    if name in ("throughput", "flagship-int8"):
        assert (calls["quant"], calls["dual"]) == (18, 1)
        assert dense + dw == {"throughput": 70, "flagship-int8": 36}[name]
    if name == "depthwise-int8":  # no fusion: one quantizer a conv
        assert calls["quant"] == dense + dw


# ------------------------------- the wgmma and tiled depthwise kernels' plans


def _cuda_formulas():
    """csrc/qconv.cu's one-line `constexpr int f(int a, ...) { return
    ...; }` helpers of the later kernels (`wg_smem`, `dw_tile_smem`, ...)
    as Python callables: C's `/` of these positive ints as `//`, its
    `c ? a : b` as `a if c else b`, the `k...` constants substituted."""
    import os
    import re
    with open(os.path.join(_build.CSRC, "qconv.cu")) as f:
        text = f.read()
    text = text[text.index("constexpr int kWgRows"):]
    ns = dict(_cuda_constants("later"))
    for m in re.finditer(r"constexpr int (\w+)\(([^)]*)\)\s*\{\s*return "
                         r"([^;]*);\s*\}", text):
        name, args, expr = m.groups()
        expr = " ".join(expr.split()).replace("/", "//")
        expr = re.sub(r"\(([^()?]+?) \? ([^():]+?) : ([^()]+?)\)",
                      r"(\2 if \1 else \3)", expr)
        assert "?" not in expr, expr
        params = ", ".join(a.split()[-1] for a in args.split(","))
        ns[name] = eval("lambda %s: %s" % (params, expr), ns)
    return ns


# (N, H, W, Cin, Cout, k): every int8 site shape of the throughput tier and
# the flagship at b16 512^2, and ragged ones
WG_SITES = [(16, s, s, cin, cout, k) for s in (8, 16, 32, 64, 128, 256)
            for cin, cout, k in ((96, 48, 1), (128, 128, 3))] + [
    (16, 256, 256, 64, 96, 1), (16, 256, 256, 64, 128, 3),
    (16, 128, 128, 128, 128, 1), (3, 9, 13, 48, 24, 3),
    (5, 17, 19, 16, 200, 3), (1, 1, 1, 32, 264, 3), (2, 20, 37, 32, 264, 1),
    (1, 23, 29, 48, 264, 3), (2, 11, 6, 144, 72, 3)]
LEGAL_S8_N = (8, 16, 24, 32) + tuple(range(48, 257, 16))


def test_qconv_later_kernels_geometry_matches_the_source():
    """ops/qconv.py mirrors csrc/qconv.cu's constants and, evaluated from
    the C source, its shared-memory formulas."""
    from real_time_helmet_detection_tpu_torch.ops import qconv
    c = _cuda_constants("later")
    assert (c["kWgRows"], c["kWgBoxW"], c["kWgConsumers"] // 32,
            c["kWgMaxStages"], c["kWgAlign"]) == (
        qconv.WG_ROWS, qconv.WG_BOX_W, qconv.WG_CONSUMER_WARPS,
        qconv.WG_MAX_STAGES, qconv.WG_ALIGN)
    assert c["kWgThreads"] == c["kWgConsumers"] + 32  # + the producer warp
    assert (c["kDwStrip"], c["kDwAlign"]) == (qconv.DW_STRIP, qconv.DW_ALIGN)
    assert all(n in LEGAL_S8_N for n in qconv.WGMMA_N)
    cu = _cuda_formulas()
    for cin in (16, 48, 64, 96, 128, 144, 256):
        assert cu["wg_planes"](cin) == qconv.wg_planes(cin)
        for k in (1, 3):
            for bh, bn in ((16, 1), (8, 2)):
                assert cu["wg_plane_bytes"](bh, bn, k) == \
                    qconv.wg_plane_bytes(bh, bn, k)
            for n in qconv.WGMMA_N:
                assert cu["wg_b_bytes"](cin, k, n) == \
                    qconv.wg_b_bytes(cin, k, n)
                for stages in range(qconv.WG_MAX_STAGES + 1):
                    for out_bytes in (2, 4):
                        args = (cin, k, 16, 1, n, stages, out_bytes)
                        assert cu["wg_smem"](*args) == qconv.wg_smem(*args)
    for tw, th, ct in ((32, 16, 64), (1, 8, 16), (13, 16, 48), (32, 8, 144)):
        assert cu["dw_box_bytes"](tw, th, ct) == qconv.dw_box_bytes(tw, th,
                                                                    ct)
        assert cu["dw_tile_smem"](tw, th, ct) == qconv.dw_tile_smem(tw, th,
                                                                    ct)


@pytest.mark.parametrize("site", WG_SITES, ids=str)
def test_dense_plan_boxes_cover_every_output_once(site):
    """The tiles' boxes (8 x bh x bn pixels, one channel block each)
    cover every (image, y, x) of every channel block exactly once, in as
    many tiles as csrc/qconv.cu's launch counts; the channel blocks cover
    Cout once."""
    from real_time_helmet_detection_tpu_torch.ops import qconv
    n, h, w, cin, cout, k = site
    plan = qconv.dense_plan(n, h, w, cin, cout, k)
    bw, bh, bn = plan.box
    assert bw * bh * bn == qconv.WG_ROWS
    cblocks = -(-cout // plan.n)
    import numpy as np
    seen = np.zeros((cblocks, n, h, w), dtype=np.int64)
    tiles = 0
    for cb in range(cblocks):
        for n0 in range(0, n, bn):
            for y0 in range(0, h, bh):
                for x0 in range(0, w, bw):
                    tiles += 1
                    # the box, clipped to the image as the stores are
                    seen[cb, n0:n0 + bn, y0:y0 + bh, x0:x0 + bw] += 1
    # launch_wgmma_n: tiles_x * tiles_y * tiles_n * channel blocks
    assert tiles == (-(-w // bw)) * (-(-h // bh)) * (-(-n // bn)) * cblocks
    assert (seen == 1).all()
    cols = [min(plan.n, cout - cb * plan.n) for cb in range(cblocks)]
    assert all(c > 0 and c % 8 == 0 for c in cols) and sum(cols) == cout


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("cin", [16, 48, 64, 96, 128, 144, 256])
def test_dense_plan_k_steps_cover_k_once(cin, k):
    """A tile's wgmmas (tap, pair of 16-channel planes: 32 bytes of K)
    cover every (tap, input channel) of k * k * Cin exactly once; what
    lies past Cin in the last pair is TMA's zero fill."""
    from real_time_helmet_detection_tpu_torch.ops import qconv
    plan = qconv.dense_plan(2, 16, 16, cin, 64, k)
    assert plan.planes == _cuda_formulas()["wg_planes"](cin)
    covered = {}
    for tap in range(k * k):
        for kk in range(plan.planes // 2):
            for ch in range(32 * kk, 32 * kk + 32):
                covered[(tap, ch)] = covered.get((tap, ch), 0) + 1
    assert set(covered.values()) == {1}
    real = {key for key in covered if key[1] < cin}
    assert real == {(tap, ch) for tap in range(k * k) for ch in range(cin)}
    assert 0 <= plan.planes * 16 - cin < 32


@pytest.mark.parametrize("cout", [8, 24, 48, 96, 128, 200, 256, 264])
def test_dense_plan_width_is_a_legal_wgmma_n(cout):
    from real_time_helmet_detection_tpu_torch.ops import qconv
    plan = qconv.dense_plan(1, 16, 16, 64, cout, 3)
    cblocks = -(-cout // plan.n)
    assert plan.n in LEGAL_S8_N and plan.n in qconv.WGMMA_N
    assert plan.n * cblocks >= cout > plan.n * (cblocks - 1)
    assert plan.n >= min(cout, 256)
    # the narrowest kernel width that covers it
    assert all(x < min(cout, 256) for x in qconv.WGMMA_N if x < plan.n)


@pytest.mark.parametrize("out_bytes", [2, 4])
@pytest.mark.parametrize("site", WG_SITES, ids=str)
def test_dense_plan_fits_shared_memory_and_box_limits(site, out_bytes):
    """A wgmma plan's shared memory is what csrc/qconv.cu's `wg_smem`
    (evaluated from the C source) adds up for it and fits what a block
    may opt into, two blocks an SM at n <= 96 wherever a ring of two
    stages fits so (the kernel's launch bounds); every TMA box dimension is
    <= 256, and its inner one 16 bytes (a plane)."""
    from real_time_helmet_detection_tpu_torch.ops import qconv
    n, h, w, cin, cout, k = site
    plan = qconv.dense_plan(n, h, w, cin, cout, k, out_bytes)
    assert plan.variant == "wgmma"
    assert 1 <= plan.stages <= qconv.WG_MAX_STAGES
    bw, bh, bn = plan.box
    cu = _cuda_formulas()
    assert plan.smem == cu["wg_smem"](cin, k, bh, bn, plan.n, plan.stages,
                                      out_bytes)
    assert plan.smem <= _build.MAX_DYNAMIC_SMEM
    per_block = plan.smem + qconv.SMEM_RESERVED
    assert per_block <= qconv.SMEM_PER_SM
    two = cu["wg_smem"](cin, k, bh, bn, plan.n, 2, out_bytes)
    if plan.n <= 96 and 2 * (two + qconv.SMEM_RESERVED) <= qconv.SMEM_PER_SM:
        assert 2 * per_block <= qconv.SMEM_PER_SM
    assert max(16, bw + k - 1, bh + k - 1, bn, plan.n) <= 256
    assert cu["wg_plane_bytes"](bh, bn, k) % qconv.WG_ALIGN == 0


def test_dense_plan_sends_oversized_weights_to_the_mma_kernel():
    """Weights that do not fit shared memory with one input box (3x3,
    Cin 256 -> 128: 288 KB) take the mma.sync kernel; asked for, the
    wgmma kernel is refused; `variant` forces the mma kernel anywhere."""
    from real_time_helmet_detection_tpu_torch.ops import qconv
    assert qconv.dense_plan(1, 8, 8, 256, 128, 3).variant == "mma"
    with pytest.raises(ValueError, match="fit"):
        qconv.dense_plan(1, 8, 8, 256, 128, 3, variant="wgmma")
    assert qconv.dense_plan(16, 256, 256, 64, 96, 1,
                            variant="mma").variant == "mma"
    with pytest.raises(ValueError):
        qconv.dense_plan(1, 8, 8, 64, 64, 3, variant="tiled")


@pytest.mark.parametrize("shape", [(16, 256, 256, 48), (16, 8, 8, 48),
                                   (3, 9, 13, 48), (2, 19, 37, 144),
                                   (3, 17, 33, 80), (1, 1, 1, 16)],
                         ids=str)
def test_dw_plan_tiles_cover_every_output_once(shape):
    """The tiled depthwise kernel's tiles (tw x th pixels of ct channels)
    cover every (image, channel, y, x) once; its two boxes (tile + halo)
    fit shared memory (csrc/qconv.cu's `dw_tile_smem`, evaluated from the
    C source) and TMA's 256-element box limit."""
    from real_time_helmet_detection_tpu_torch.ops import qconv
    n, h, w, c = shape
    plan = qconv.dw_plan(n, h, w, c)
    assert plan.variant == "tiled"
    tw, th = plan.tile
    assert th % qconv.DW_STRIP == 0 and plan.ct % 16 == 0
    assert max(plan.ct, tw + 2, th + 2) <= 256
    assert plan.smem == _cuda_formulas()["dw_tile_smem"](tw, th, plan.ct) \
        <= _build.MAX_DYNAMIC_SMEM
    import numpy as np
    seen = np.zeros((n, c, h, w), dtype=np.int64)
    tiles = 0
    for c0 in range(0, c, plan.ct):
        for i in range(n):
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    tiles += 1
                    seen[i, c0:c0 + plan.ct, y0:y0 + th, x0:x0 + tw] += 1
    # launch_dw_tile: tiles_x * tiles_y * N * channel blocks
    assert tiles == (-(-w // tw)) * (-(-h // th)) * n * (-(-c // plan.ct))
    assert (seen == 1).all()


@pytest.mark.parametrize("c", [8, 24, 136])
def test_dw_plan_takes_the_gather_kernel_off_16(c):
    """TMA needs 16-byte strides: C % 16 != 0 takes the gather kernel, and
    the tiled one is refused."""
    from real_time_helmet_detection_tpu_torch.ops import qconv
    assert qconv.dw_plan(2, 9, 13, c).variant == "gather"
    with pytest.raises(ValueError):
        qconv.dw_plan(2, 9, 13, c, variant="tiled")


@pytest.mark.parametrize("name,kw", [("throughput", dict(tier="throughput")),
                                     ("flagship-int8",
                                      dict(infer_dtype="int8"))])
def test_int8_sites_take_the_wgmma_and_tiled_kernels(name, kw):
    """Every int8 conv site of the throughput tier and the flagship at b16
    512^2 (a 64^2 forward's shapes scaled by 8: the architecture is
    fully convolutional) takes the wgmma kernel (dense) or the tiled one
    (depthwise), in bf16 and f32; the depthwise sites' channel counts are
    what chip_smoke.py's `qconv_walk` derives."""
    import os
    import sys

    from real_time_helmet_detection_tpu_torch.config import (Config,
                                                             apply_tier)
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        QuantConv
    from real_time_helmet_detection_tpu_torch.ops import qconv, quant
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke
    cfg = apply_tier(Config(device="cpu", imsize=64, **kw))
    twin = quant.make_quant_model(cfg, mode="int8").eval()
    sites = []
    hooks = [m.register_forward_hook(
        lambda mod, args, _o: sites.append(
            (mod.depthwise, tuple(args[0].shape), mod.weight.shape[0],
             mod.k)))
        for m in twin.modules() if isinstance(m, QuantConv)]
    with torch.inference_mode():
        twin(torch.zeros((1, 64, 64, 3)))
    for hk in hooks:
        hk.remove()
    dw_channels = []
    for depthwise, (_, c, h, w), cout, k in sites:
        n, h, w = 16, 8 * h, 8 * w
        if depthwise:
            dw_channels.append(c)
            assert qconv.dw_plan(n, h, w, c).variant == "tiled"
        else:
            for out_bytes in (2, 4):
                assert qconv.dense_plan(n, h, w, c, cout, k,
                                        out_bytes).variant == "wgmma"
    dense, walk = chip_smoke.qconv_walk(cfg)
    assert sorted(dw_channels) == sorted(walk)
    assert len(sites) - len(dw_channels) == dense
