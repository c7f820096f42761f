"""Detection losses: CenterNet focal loss + mask-normalized L1, in PyTorch.

Port of ref real_time_helmet_detection_tpu/ops/loss.py:28-163
(`focal_loss`, `normed_l1_loss`, `detection_loss`,
`split_stack_predictions`, `stacked_detection_loss`, `LossLog`; reference
loss.py:9-69) and of the fused loss, ref ops/pallas/loss.py:290
`fused_detection_loss` (its Pallas `_fwd_kernel`, loss.py:86, and
`_bwd_kernel`, loss.py:126).

* `stacked_detection_loss` is the composition (the JAX package's
  `--loss-kernel xla`), kept as the yardstick the tests hold the fused
  loss to.
* `fused_detection_loss` is the loss the port trains with (the JAX TPU
  default, `--loss-kernel fused`): `LossSums`, a
  `torch.autograd.Function` over the kernels of `csrc/loss.cu`, gives
  four (S, B) sums per call — focal positive and negative log terms and
  the masked L1 of offset and size — and a few scalar ops finish the
  loss. Its backward writes d(out) in one pass from the four (S, B)
  cotangents.
* `loss_sums` / `loss_sums_bwd` launch one kernel each for CUDA tensors
  or raise, and run `loss_sums_reference` / `loss_sums_bwd_reference`, the
  plain PyTorch versions, for CPU tensors. `fwd_launches` and
  `bwd_launches` count kernel launches; `bwd_vector_launches` and
  `bwd_scalar_launches` split the backward's by the variant
  `bwd_variant` picks from the shape: the kernel that stages 512-pixel
  tiles through shared memory in 16-byte pieces, or the scalar one.

Reductions match the JAX package exactly: per-sample sums over
(H, W, C), a mean over the batch, and normalization by the global
positive count `clip(sum(mask), 1, 1e30)` (summed over the ranks of a
process group first). Arrays are channels-last,
as the model's output (B, S, H, W, C+4) and the encoded targets are.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Optional, Tuple

import torch

from . import _build, marks
from ..parallel import distributed
from .epilogue import (_DTYPE_CODE, _ELEMENT_BYTES, _VEC_BYTES, check_cuda,
                       plain_device)

EPS = 1e-7            # focal eps, ref ops/pallas/loss.py:47
FWD_TILE_PIXELS = 512  # pixels of one (stack, sample) map per forward block
BWD_TILE_PIXELS = 512  # the same for the vector backward kernel

_tickets: Dict[torch.device, list] = {}  # device -> int32 counter buffers

fwd_launches = 0
bwd_launches = 0
bwd_vector_launches = 0
bwd_scalar_launches = 0


def _num_pos(mask: torch.Tensor) -> torch.Tensor:
    """clip(sum(mask), 1, 1e30) over the global batch: in a process group
    of world > 1 the sum is all-reduced before the clamp, as JAX's GSPMD
    step clamps the global sum (ref ops/pallas/loss.py:311)."""
    return torch.clamp(distributed.all_reduce_sum_(mask.sum()), 1.0, 1e30)


def focal_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
               alpha: float = 2.0, beta: float = 4.0,
               eps: float = 1e-7) -> torch.Tensor:
    """CenterNet focal loss on a post-sigmoid heatmap (ref loss.py:28).

    pred/gt: (B, H, W, C); mask: (B, H, W, 1) positive-center indicator,
    broadcast over the class axis."""
    pred, gt = pred.float(), gt.float()
    neg_weights = torch.pow(1.0 - gt, beta)
    pos = torch.log(pred + eps) * torch.pow(1.0 - pred, alpha) * mask
    neg = (torch.log(1.0 - pred + eps) * torch.pow(pred, alpha)
           * neg_weights * (1.0 - mask))
    pos = pos.sum(dim=(1, 2, 3)).mean()
    neg = neg.sum(dim=(1, 2, 3)).mean()
    return -(pos + neg) / _num_pos(mask)


def normed_l1_loss(pred: torch.Tensor, gt: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Masked L1, summed per sample, batch-meaned, over the global
    positive count (ref loss.py:47)."""
    loss = torch.abs(pred.float() * mask - gt * mask)
    return loss.sum(dim=(1, 2, 3)).mean() / _num_pos(mask)


def detection_loss(pred_heatmap, pred_offset, pred_size, gt_heatmap,
                   gt_offset, gt_size, mask, *, hm_weight: float = 1.0,
                   offset_weight: float = 1.0, size_weight: float = 0.1,
                   focal_alpha: float = 2.0,
                   focal_beta: float = 4.0) -> Dict[str, torch.Tensor]:
    """Weighted total loss of one prediction stack (ref loss.py:56);
    `pred_heatmap` is post-sigmoid. Returns 'hm', 'offset', 'size' and
    'total' scalars."""
    hm = focal_loss(pred_heatmap, gt_heatmap, mask, focal_alpha, focal_beta)
    off = normed_l1_loss(pred_offset, gt_offset, mask)
    size = normed_l1_loss(pred_size, gt_size, mask)
    total = hm * hm_weight + off * offset_weight + size * size_weight
    return {"hm": hm, "offset": off, "size": size, "total": total}


def split_stack_predictions(out: torch.Tensor, num_cls: int,
                            normalized_coord: bool):
    """One stack's raw output (B, H, W, C+4) -> post-activation (heatmap,
    offset, size) (ref loss.py:73)."""
    heat = torch.sigmoid(out[..., :num_cls])
    offset = out[..., num_cls:num_cls + 2]
    size = out[..., num_cls + 2:num_cls + 4]
    if normalized_coord:
        offset, size = torch.sigmoid(offset), torch.sigmoid(size)
    return heat, offset, size


def stacked_detection_loss(out: torch.Tensor, gt_heat: torch.Tensor,
                           gt_off: torch.Tensor, gt_wh: torch.Tensor,
                           mask: torch.Tensor, *, num_cls: int,
                           normalized_coord: bool = False,
                           hm_weight: float = 1.0,
                           offset_weight: float = 1.0,
                           size_weight: float = 0.1,
                           focal_alpha: float = 2.0,
                           focal_beta: float = 4.0
                           ) -> Dict[str, torch.Tensor]:
    """Deep-supervision loss over all stacks of the raw model output
    (B, S, H, W, C+4): sigmoid + per-stack `detection_loss`, summed over
    stacks (ref loss.py:86)."""
    totals: Dict[str, torch.Tensor] = {}
    for s in range(out.shape[1]):
        heat, off, size = split_stack_predictions(out[:, s], num_cls,
                                                  normalized_coord)
        losses = detection_loss(
            heat, off, size, gt_heat, gt_off, gt_wh, mask,
            hm_weight=hm_weight, offset_weight=offset_weight,
            size_weight=size_weight, focal_alpha=focal_alpha,
            focal_beta=focal_beta)
        for k, v in losses.items():
            totals[k] = totals[k] + v if k in totals else v
    return totals


# ------------------------------------------------------------ fused loss


def check_loss_operands(out: torch.Tensor, heat: torch.Tensor,
                        off: torch.Tensor, wh: torch.Tensor,
                        mask: torch.Tensor) -> None:
    """Raise unless out is a contiguous (B, S, H, W, C+4) f32/bf16 tensor
    and the targets are contiguous float32 heat (B, H, W, C), off and wh
    (B, H, W, 2) and mask (B, H, W, 1) on out's device."""
    if out.dim() != 5 or out.shape[-1] < 5:
        raise ValueError("out must be (B, S, H, W, C+4), got %s"
                         % (tuple(out.shape),))
    if out.dtype not in _DTYPE_CODE or not out.is_contiguous():
        raise ValueError("out must be contiguous float32 or bfloat16, got "
                         "%s (contiguous=%s)" % (out.dtype,
                                                 out.is_contiguous()))
    b, _, h, w, k = out.shape
    for name, t, c in (("heat", heat, k - 4), ("off", off, 2),
                       ("wh", wh, 2), ("mask", mask, 1)):
        if tuple(t.shape) != (b, h, w, c) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != out.device:
            raise ValueError("%s must be a contiguous float32 %s tensor on "
                             "%s, got %s %s on %s" % (
                                 name, (b, h, w, c), out.device,
                                 tuple(t.shape), t.dtype, t.device))


def loss_terms_reference(out, heat, off, wh, mask, *, alpha: float,
                         beta: float, normalized: bool):
    """The summands of the four loss sums, f32, each (B, S, H, W, ·):
    focal positive and negative log terms (C channels) and the masked
    L1 of offset and size (2 channels each), with the terms of ref
    ops/pallas/loss.py:104-121, the logits upcast before the sigmoid."""
    x = out.float()
    c = heat.shape[-1]
    m = mask.float().unsqueeze(1)
    g = heat.float().unsqueeze(1)
    p = torch.sigmoid(x[..., :c])
    pos = torch.log(p + EPS) * torch.pow(1.0 - p, alpha) * m
    neg = (torch.log(1.0 - p + EPS) * torch.pow(p, alpha)
           * torch.pow(1.0 - g, beta) * (1.0 - m))
    po, pw = x[..., c:c + 2], x[..., c + 2:c + 4]
    if normalized:
        po, pw = torch.sigmoid(po), torch.sigmoid(pw)
    offl = torch.abs(po * m - off.float().unsqueeze(1) * m)
    whl = torch.abs(pw * m - wh.float().unsqueeze(1) * m)
    return pos, neg, offl, whl


def loss_sums_reference(out, heat, off, wh, mask, *, alpha: float,
                        beta: float, normalized: bool
                        ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the forward kernel: (pos, neg, off_l1,
    wh_l1), each (S, B) float32, before negation, batch mean and the
    positive count (ref ops/pallas/loss.py:86)."""
    return tuple(t.sum(dim=(2, 3, 4)).t().contiguous()
                 for t in loss_terms_reference(
                     out, heat, off, wh, mask, alpha=alpha, beta=beta,
                     normalized=normalized))


def loss_sums_bwd_reference(out, heat, off, wh, mask, gpos, gneg, goff, gwh,
                            *, alpha: float, beta: float, normalized: bool
                            ) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel: d(out) in out's dtype
    from the four (S, B) cotangents, with the formulas of ref
    ops/pallas/loss.py:146-175 — the analytic focal derivatives times
    p(1-p), sign() for |.| (0 at 0), the sigmoid's chain under
    `normalized`."""
    x = out.float()
    c = heat.shape[-1]
    m = mask.float().unsqueeze(1)
    g = heat.float().unsqueeze(1)

    def per_sample(t):  # (S, B) -> (B, S, 1, 1, 1)
        return t.float().t()[:, :, None, None, None]

    p = torch.sigmoid(x[..., :c])
    dpos = (torch.pow(1.0 - p, alpha) / (p + EPS)
            - alpha * torch.pow(1.0 - p, alpha - 1.0)
            * torch.log(p + EPS)) * m
    dneg = ((-torch.pow(p, alpha) / (1.0 - p + EPS)
             + alpha * torch.pow(p, alpha - 1.0) * torch.log(1.0 - p + EPS))
            * torch.pow(1.0 - g, beta) * (1.0 - m))
    parts = [(per_sample(gpos) * dpos + per_sample(gneg) * dneg)
             * p * (1.0 - p)]
    for cot, pred, gt in ((goff, x[..., c:c + 2], off),
                          (gwh, x[..., c + 2:c + 4], wh)):
        if normalized:
            pred = torch.sigmoid(pred)
        d = per_sample(cot) * torch.sign(
            pred * m - gt.float().unsqueeze(1) * m) * m
        if normalized:
            d = d * pred * (1.0 - pred)
        parts.append(d)
    return torch.cat(parts, dim=-1).to(out.dtype).contiguous()


def _loss_args(out):
    """(B, S, H*W, C) of the raw output, as the C entries take them."""
    b, s, h, w, k = out.shape
    return b, s, h * w, k - 4


def fwd_tiles(hw: int) -> int:
    """Blocks per (stack, sample) map of the forward kernel: block t reads
    pixels [t * FWD_TILE_PIXELS, (t + 1) * FWD_TILE_PIXELS) of the map,
    the last one ragged."""
    return -(-hw // FWD_TILE_PIXELS)


def bwd_tiles(hw: int) -> int:
    """Tiles per (stack, sample) map of the vector backward kernel: tile t
    holds pixels [t * BWD_TILE_PIXELS, (t + 1) * BWD_TILE_PIXELS) of the
    map, the last one ragged."""
    return -(-hw // BWD_TILE_PIXELS)


def bwd_smem_bytes(num_cls: int, dtype: torch.dtype) -> int:
    """Shared memory of one vector-backward block (csrc/loss.cu
    `bwd_smem_bytes`): a tile's out in its dtype, heat, off, wh and mask
    in float32."""
    return BWD_TILE_PIXELS * ((num_cls + 4) * _ELEMENT_BYTES[dtype]
                              + (num_cls + 5) * 4)


def bwd_variant(hw: int, num_cls: int, dtype: torch.dtype,
                *pointers: int) -> str:
    """The backward kernel of csrc/loss.cu that `loss_sums_bwd` launches:
    "vector" when every tile's run of out, heat, off, wh, mask and dout is
    whole 16-byte pieces on 16-byte boundaries (hw % 4 == 0, a map of out
    a multiple of 16 bytes, every pointer 16-byte aligned) and the stage
    fits a block's shared memory, else "scalar". A choice by shape, not a
    fallback on failure."""
    if hw % 4 == 0 \
            and hw * (num_cls + 4) * _ELEMENT_BYTES[dtype] % _VEC_BYTES == 0 \
            and all(p % _VEC_BYTES == 0 for p in pointers) \
            and bwd_smem_bytes(num_cls, dtype) <= _build.MAX_DYNAMIC_SMEM:
        return "vector"
    return "scalar"


def _ticket_buffer(device: torch.device, maps: int) -> torch.Tensor:
    """The forward kernel's per-map counters on `device`: int32 zeros at
    allocation, left at zero by every launch. A buffer is kept for the
    life of the process (a CUDA graph may hold its address); a larger one
    is added when a launch needs more maps. One stream at a time: two
    concurrent launches on one device would share the counters."""
    held = _tickets.setdefault(device, [])
    if not held or held[-1].numel() < maps:
        held.append(torch.zeros(max(maps, 256), device=device,
                                dtype=torch.int32))
    return held[-1]


@marks.kernel("loss_fwd")
def loss_sums(out: torch.Tensor, heat: torch.Tensor, off: torch.Tensor,
              wh: torch.Tensor, mask: torch.Tensor, *, alpha: float,
              beta: float, normalized: bool) -> Tuple[torch.Tensor, ...]:
    """The four (S, B) float32 loss sums of the raw output (ref
    ops/pallas/loss.py:86 `_fwd_kernel`), one launch of csrc/loss.cu's
    forward kernel: its blocks write per-tile partials and the last block
    of each (stack, sample) folds them in a fixed order, so what follows
    the launch is views of its (4, S, B) result."""
    global fwd_launches
    check_loss_operands(out, heat, off, wh, mask)
    kw = dict(alpha=alpha, beta=beta, normalized=normalized)
    if plain_device(out):
        return loss_sums_reference(out, heat, off, wh, mask, **kw)
    check_cuda("loss_sums", out)
    b, s, hw, c = _loss_args(out)
    tiles = fwd_tiles(hw)
    part = torch.empty((4, s, b, tiles), device=out.device,
                       dtype=torch.float32)
    sums = torch.empty((4, s, b), device=out.device, dtype=torch.float32)
    if part.numel() == 0:
        return tuple(torch.zeros((s, b), device=out.device) for _ in range(4))
    tickets = _ticket_buffer(out.device, s * b)
    lib = _build.load("loss")
    err = lib.helmet_loss_fwd(out.data_ptr(), heat.data_ptr(),
                              off.data_ptr(), wh.data_ptr(), mask.data_ptr(),
                              part.data_ptr(), tickets.data_ptr(),
                              sums.data_ptr(), b, s, hw, c, tiles,
                              float(alpha), float(beta), int(normalized),
                              _DTYPE_CODE[out.dtype],
                              _build.stream_handle(out.device))
    _build.check(err, "loss_sums")
    fwd_launches += 1
    return sums.unbind(0)


@marks.kernel("loss_bwd")
def loss_sums_bwd(out: torch.Tensor, heat: torch.Tensor, off: torch.Tensor,
                  wh: torch.Tensor, mask: torch.Tensor, gpos: torch.Tensor,
                  gneg: torch.Tensor, goff: torch.Tensor, gwh: torch.Tensor,
                  *, alpha: float, beta: float, normalized: bool,
                  variant: Optional[str] = None) -> torch.Tensor:
    """d(out) from the four (S, B) cotangents of `loss_sums` (ref
    ops/pallas/loss.py:126 `_bwd_kernel`), in out's dtype, one launch of
    csrc/loss.cu's backward; the cotangents are read in place, at their
    own strides. `variant` ("vector" or "scalar") forces a kernel on a
    CUDA tensor; None takes `bwd_variant`'s choice. The vector kernel
    refuses, and this raises on, a shape it cannot take."""
    global bwd_launches, bwd_vector_launches, bwd_scalar_launches
    check_loss_operands(out, heat, off, wh, mask)
    cots = (gpos, gneg, goff, gwh)
    for t in cots:
        if tuple(t.shape) != (out.shape[1], out.shape[0]) \
                or t.device != out.device or t.dtype != torch.float32:
            raise ValueError("cotangents must be float32 (S, B) = %s on %s, "
                             "got %s %s on %s" % (
                                 (out.shape[1], out.shape[0]), out.device,
                                 t.dtype, tuple(t.shape), t.device))
    kw = dict(alpha=alpha, beta=beta, normalized=normalized)
    if plain_device(out):
        return loss_sums_bwd_reference(out, heat, off, wh, mask, *cots, **kw)
    check_cuda("loss_sums_bwd", out)
    dout = torch.empty_like(out)
    if dout.numel() == 0:
        return dout
    b, s, hw, c = _loss_args(out)
    ptrs = [t.data_ptr() for t in (out, heat, off, wh, mask)]
    if variant is None:
        variant = bwd_variant(hw, c, out.dtype, *ptrs, dout.data_ptr())
    strides = (ctypes.c_int * 8)(*(n for t in cots for n in t.stride()))
    lib = _build.load("loss")
    head = (*ptrs, *(t.data_ptr() for t in cots), ctypes.addressof(strides),
            dout.data_ptr(), b, s, hw, c)
    tail = (float(alpha), float(beta), int(normalized),
            _DTYPE_CODE[out.dtype], _build.stream_handle(out.device))
    if variant == "vector":
        err = lib.helmet_loss_bwd_vec(*head, bwd_tiles(hw), *tail)
    elif variant == "scalar":
        err = lib.helmet_loss_bwd(*head, *tail)
    else:
        raise ValueError("variant must be 'vector' or 'scalar', got %r"
                         % (variant,))
    _build.check(err, "loss_sums_bwd (%s kernel)" % variant)
    bwd_launches += 1
    if variant == "vector":
        bwd_vector_launches += 1
    else:
        bwd_scalar_launches += 1
    return dout


class LossSums(torch.autograd.Function):
    """(out, heat, off, wh, mask) -> the four (S, B) loss sums, ref
    ops/pallas/loss.py:178 `_make_loss_sums`: the forward kernel, and a
    backward that recomputes the terms from the saved inputs and writes
    d(out) in one pass. Differentiable w.r.t. `out` only; the targets are
    labels."""

    @staticmethod
    def forward(ctx, out, heat, off, wh, mask, alpha, beta, normalized):
        ctx.save_for_backward(out, heat, off, wh, mask)
        ctx.kw = dict(alpha=alpha, beta=beta, normalized=normalized)
        return loss_sums(out, heat, off, wh, mask, **ctx.kw)

    @staticmethod
    def backward(ctx, gpos, gneg, goff, gwh):
        dout = loss_sums_bwd(*ctx.saved_tensors, gpos, gneg, goff, gwh,
                             **ctx.kw)
        return dout, None, None, None, None, None, None, None


def fused_detection_loss(out: torch.Tensor, gt_heat: torch.Tensor,
                         gt_off: torch.Tensor, gt_wh: torch.Tensor,
                         mask: torch.Tensor, *, hm_weight: float = 1.0,
                         offset_weight: float = 1.0,
                         size_weight: float = 0.1,
                         focal_alpha: float = 2.0, focal_beta: float = 4.0,
                         normalized_coord: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """Deep-supervision loss over all stacks of the raw output
    (B, S, H, W, C+4), fused (ref ops/pallas/loss.py:290): the same
    {'hm', 'offset', 'size', 'total'} scalars as `stacked_detection_loss`
    — per-sample sums, the batch mean per stack, the global positive
    count clip(sum(mask), 1, 1e30), summed over stacks — with the logits
    upcast to f32 before the sigmoid."""
    pos, neg, off, wh = LossSums.apply(
        out, gt_heat, gt_off, gt_wh, mask, float(focal_alpha),
        float(focal_beta), bool(normalized_coord))
    num_pos = _num_pos(mask.float())
    hm = (-(pos.mean(1) + neg.mean(1)) / num_pos).sum()
    off_l = (off.mean(1) / num_pos).sum()
    size_l = (wh.mean(1) / num_pos).sum()
    total = hm * hm_weight + off_l * offset_weight + size_l * size_weight
    return {"hm": hm, "offset": off_l, "size": size_l, "total": total}


class LossLog:
    """Host-side loss history (ref loss.py:115; reference loss.py:9),
    appended once per step and kept in checkpoints. `state_dict()` tags
    the key -> list dict with the JAX package's schema name; the
    constructor also reads an untagged dict of the four loss keys."""

    KEYS = ("hm", "offset", "size", "total")
    # `--telemetry`'s norms (obs/telemetry.py): empty lists when it is off
    TELEMETRY_KEYS = ("grad_norm", "update_norm", "param_norm")
    SCHEMA = "loss-log-v2"

    def __init__(self, log: Optional[Mapping[str, list]] = None):
        log = log or {}
        schema = log.get("schema")
        if schema is not None and schema != self.SCHEMA:
            raise ValueError("unknown loss-log schema %r (this build reads "
                             "untagged logs and %s)" % (schema, self.SCHEMA))
        self.log = {k: list(log.get(k, []))
                    for k in self.KEYS + self.TELEMETRY_KEYS}

    def append(self, losses: Mapping[str, float]) -> None:
        for k in self.KEYS:
            self.log[k].append(float(losses[k]))
        for k in self.TELEMETRY_KEYS:  # only when the step made them
            if k in losses:
                self.log[k].append(float(losses[k]))

    def get_log(self, length: int = 100) -> str:
        parts = []
        for key in self.KEYS:
            n = min(length, len(self.log[key]))
            avg = sum(self.log[key][-n:]) / n if n else float("nan")
            parts.append("%s: %5.2f" % (key, avg))
        return ", ".join(parts)

    def state_dict(self) -> Dict:
        out: Dict = {"schema": self.SCHEMA}
        out.update({k: list(v) for k, v in self.log.items()})
        return out
