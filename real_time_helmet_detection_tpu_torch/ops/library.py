"""The `helmet` operator namespace: the eval path's kernels as torch.library
operators, so that `torch.export` records them and a program exported
with them still runs the hand-written kernels.

The JAX package forces its Pallas kernels off when it exports (ref
real_time_helmet_detection_tpu/export.py:80), so that its StableHLO does
not pin a libtpu; the port's exported program keeps its kernels. Each
eval-path kernel is one operator:

| op | kernel | wrapper |
| --- | --- | --- |
| `helmet::peak_scores` | #1, csrc/peak.cu | `ops.peak.peak_scores` |
| `helmet::bn_act` | #2, csrc/epilogue.cu | `ops.epilogue.bn_act` |
| `helmet::bn_add_act` | #8, csrc/residual.cu | `ops.residual.bn_add_act` |
| `helmet::quantize_act`, `quantize_act2` (two steps) | #16, csrc/qconv.cu | `ops.qconv.quantize_act` |
| `helmet::qconv_dense`, `qconv_dense_codes` | #14, csrc/qconv.cu | `ops.qconv.conv_dense` |
| `helmet::qconv_dw`, `qconv_dw_codes` | #15, csrc/qconv.cu | `ops.qconv.conv_dw` |

The `*_codes` conv ops write the conv's int8 codes into the tensors they
are given (`Tensor(a!)`: the export records the mutation) and store the
float output only with `store`; they are ops of their own because
AOTInductor cannot lower an op with a mutable argument called with none
(a lone `getitem` of its result). `quantize_act2` quantizes at two steps
in one launch and returns both.

* Each op has a CUDA implementation (the launch: output allocation, the
  C entry through `ctypes` on PyTorch's current stream, the launch
  counters of its module), a CPU implementation (its plain version,
  written into an output laid out as the fake one) and a fake
  implementation (`register_fake`: shape, dtype and strides, no storage).
  The CUDA implementation launches its kernel or raises.
* The wrappers check their arguments and compute everything a launch
  needs that depends only on shapes (`qconv.dense_plan` / `dw_plan`, the
  peak test's tiles) as op arguments, at call or trace time. What depends
  on pointers stays a run-time choice inside the C entries
  (`helmet_peak_pick`, `helmet_bn_act_pick`, the int8 entries' 16-byte
  checks), the one decision this process and the C++ op library
  (csrc/torch_ops.cpp, the same schema strings) both run.
* The namespace is defined with `torch.library.Library("helmet", "DEF")`
  and plain `impl` registrations: the dispatcher calls the Python kernel
  with no extra wrapping of `torch.library.custom_op`.

This process never loads csrc/torch_ops.cpp's library: a namespace is
defined once a process.
"""

from __future__ import annotations

import torch

from . import _build, epilogue, peak, qconv, residual

# op -> schema, the same strings as csrc/torch_ops.cpp's TORCH_LIBRARY
SCHEMAS = {
    "peak_scores": "peak_scores(Tensor logits, int num_cls, int pool_size, "
                   "int tiles, str variant) -> Tensor",
    "bn_act": "bn_act(Tensor x, Tensor eff_scale, Tensor eff_bias, "
              "str activation, str variant) -> Tensor",
    "bn_add_act": "bn_add_act(Tensor y, Tensor eff_scale, Tensor eff_bias, "
                  "Tensor skip, str activation) -> Tensor",
    "quantize_act": "quantize_act(Tensor x, Tensor step) -> Tensor",
    "quantize_act2": "quantize_act2(Tensor x, Tensor step, Tensor step2) "
                     "-> (Tensor, Tensor)",
    "qconv_dense": "qconv_dense(Tensor q, Tensor w, Tensor mult, "
                   "Tensor bias, int out_dtype, str activation, "
                   "str variant, int bh, int bn, int wn, int stages) "
                   "-> Tensor",
    "qconv_dense_codes": "qconv_dense_codes(Tensor q, Tensor w, "
                         "Tensor mult, Tensor bias, int out_dtype, "
                         "str activation, str variant, int bh, int bn, "
                         "int wn, int stages, bool store, "
                         "Tensor(a!) codes, Tensor code_step, "
                         "int code_offset, Tensor(b!)? codes2=None, "
                         "Tensor? code_step2=None, int code_offset2=0) "
                         "-> Tensor",
    "qconv_dw": "qconv_dw(Tensor q, Tensor w, Tensor mult, Tensor bias, "
                "int out_dtype, str activation, str variant, int tw, "
                "int th, int ct) -> Tensor",
    "qconv_dw_codes": "qconv_dw_codes(Tensor q, Tensor w, Tensor mult, "
                      "Tensor bias, int out_dtype, str activation, "
                      "str variant, int tw, int th, int ct, bool store, "
                      "Tensor(a!) codes, Tensor code_step, "
                      "int code_offset, Tensor(b!)? codes2=None, "
                      "Tensor? code_step2=None, int code_offset2=0) "
                      "-> Tensor",
}
# the kernel each op launches (its row in a count, `obs.roofline`): the
# code-writing forms and the quantizer at two steps are the same kernels
KERNEL_OF = {"quantize_act2": "quantize_act",
             "qconv_dense_codes": "qconv_dense",
             "qconv_dw_codes": "qconv_dw"}

# qconv.cu's output codes
OUT_DTYPES = {code: dtype for dtype, code in qconv._OUT_CODE.items()}

LIB = torch.library.Library("helmet", "DEF")
for _schema in SCHEMAS.values():
    LIB.define(_schema)


def _check_q(err: int, what: str) -> None:
    """An int8 entry's error: a misaligned operand is the caller's
    ValueError, any other code a launch failure."""
    if err == qconv.MISALIGNED:
        raise ValueError("%s: the int8 input or weights are not 16-byte "
                         "aligned" % what)
    _build.check(err, what)


def _pick(variant: str, pick) -> bool:
    """True for the vector variant: `pick()` (the C entry's choice) for
    "auto", else the variant asked for."""
    return bool(pick()) if variant == "auto" else variant == "vector"


def _channels_last_empty(shape, like: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device,
                       memory_format=torch.channels_last)


def _code_list(codes=None, code_step=None, code_offset=0, codes2=None,
               code_step2=None, code_offset2=0):
    """A `*_codes` conv op's code arguments (those after `store`) as the
    wrappers' `codes`: a list of (tensor, step, offset)."""
    return [(t, s, o) for t, s, o in ((codes, code_step, code_offset),
                                      (codes2, code_step2, code_offset2))
            if t is not None]


def _code_array(code_args):
    """A conv op's code arguments as its C entry's `codes`: None, or the
    8 values {pointer, step pointer, offset, channel stride} twice."""
    import ctypes
    codes = _code_list(*code_args)
    if not codes:
        return None
    vals = []
    for t, step, off in codes + [(None, None, 0)] * (2 - len(codes)):
        vals += [t.data_ptr(), step.data_ptr(), off, t.shape[1]] \
            if t is not None else [0, 0, 0, 0]
    return (ctypes.c_longlong * 8)(*vals)


def _conv_out(shape, like, out_dtype, store):
    """A conv op's float output: empty (0,) without `store`."""
    if not store:
        return like.new_empty((0,), dtype=OUT_DTYPES[out_dtype])
    return _channels_last_empty(shape, like, OUT_DTYPES[out_dtype])


# ------------------------------------------------------------ peak_scores


def _peak_fake(logits, num_cls, pool_size, tiles, variant):
    b, s, h, w, _ = logits.shape
    return logits.new_empty((b, s, num_cls, h, w))


def _peak_cpu(logits, num_cls, pool_size, tiles, variant):
    return peak.peak_scores_reference(logits, num_cls, pool_size)


def _peak_cuda(logits, num_cls, pool_size, tiles, variant):
    b, s, h, w, k = logits.shape
    out = _peak_fake(logits, num_cls, pool_size, tiles, variant)
    if out.numel() == 0:
        return out
    lib = _build.load("peak")
    vec = _pick(variant, lambda: lib.helmet_peak_pick(
        logits.data_ptr(), out.data_ptr(), num_cls, k, w))
    err = lib.helmet_peak_scores(logits.data_ptr(), out.data_ptr(), b * s,
                                 num_cls, h, w, k, (pool_size - 1) // 2,
                                 tiles, int(vec),
                                 _build.stream_handle(logits.device))
    _build.check(err, "peak_scores (%s variant)"
                 % ("vector" if vec else "scalar"))
    peak.launches += 1
    if vec:
        peak.vector_launches += 1
    else:
        peak.scalar_launches += 1
    return out


# ----------------------------------------------------------------- bn_act


def _bn_act_fake(x, eff_scale, eff_bias, activation, variant):
    return torch.empty_like(x)


def _bn_act_cpu(x, eff_scale, eff_bias, activation, variant):
    return torch.empty_like(x).copy_(
        epilogue.bn_act_reference(x, eff_scale, eff_bias, activation))


def _bn_act_cuda(x, eff_scale, eff_bias, activation, variant):
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.load("epilogue")
    dtype = epilogue._DTYPE_CODE[x.dtype]
    vec = _pick(variant, lambda: lib.helmet_bn_act_pick(
        x.data_ptr(), out.data_ptr(), x.shape[1], dtype))
    entry = lib.helmet_bn_act_vec if vec else lib.helmet_bn_act
    err = entry(x.data_ptr(), eff_scale.data_ptr(), eff_bias.data_ptr(),
                out.data_ptr(), x.numel(), x.shape[1], dtype,
                epilogue._ACT_CODE[activation],
                _build.stream_handle(x.device))
    _build.check(err, "bn_act (%s kernel)" % ("vector" if vec else "scalar"))
    epilogue.launches += 1
    if vec:
        epilogue.vector_launches += 1
    else:
        epilogue.scalar_launches += 1
    return out


# ------------------------------------------------------------- bn_add_act


def _bn_add_act_fake(y, eff_scale, eff_bias, skip, activation):
    return torch.empty_like(y)


def _bn_add_act_cpu(y, eff_scale, eff_bias, skip, activation):
    return torch.empty_like(y).copy_(residual.bn_add_act_reference(
        y, eff_scale, eff_bias, skip, activation))


def _bn_add_act_cuda(y, eff_scale, eff_bias, skip, activation):
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    err = _build.load("residual").helmet_bn_add_act(
        y.data_ptr(), eff_scale.data_ptr(), eff_bias.data_ptr(),
        skip.data_ptr(), out.data_ptr(), y.numel(), y.shape[1],
        epilogue._DTYPE_CODE[y.dtype], epilogue._ACT_CODE[activation],
        _build.stream_handle(y.device))
    _build.check(err, "bn_add_act")
    residual.launches += 1
    return out


# ----------------------------------------------------------- quantize_act


def _quant_fake(x, step):
    return _channels_last_empty(x.shape, x, torch.int8)


def _quant_cpu(x, step):
    return _quant_fake(x, step).copy_(qconv.quantize_act_reference(x, step))


def _quantize(x, steps):
    """One launch of the quantizer at one or two steps."""
    outs = [_quant_fake(x, s) for s in steps]
    if x.numel() == 0:
        return outs
    dual = len(steps) == 2
    err = _build.load("qconv").helmet_quantize(
        x.data_ptr(), steps[0].data_ptr(), outs[0].data_ptr(),
        steps[1].data_ptr() if dual else None,
        outs[1].data_ptr() if dual else None, x.numel(),
        epilogue._DTYPE_CODE[x.dtype], _build.stream_handle(x.device))
    _check_q(err, "quantize_act")
    qconv.quant_launches += 1
    qconv.quant_dual_launches += dual
    return outs


def _quant_cuda(x, step):
    return _quantize(x, (step,))[0]


def _quant2_fake(x, step, step2):
    return _quant_fake(x, step), _quant_fake(x, step2)


def _quant2_cpu(x, step, step2):
    return tuple(o.copy_(r) for o, r in zip(
        _quant2_fake(x, step, step2),
        qconv.quantize_act_reference(x, step, step2)))


def _quant2_cuda(x, step, step2):
    return tuple(_quantize(x, (step, step2)))


# ------------------------------------------------- qconv_dense, qconv_dw


def _dense_fake(q, w, mult, bias, out_dtype, activation, variant, bh, bn,
                wn, stages, store=True, *code_args):
    n, _, h, wd = q.shape
    return _conv_out((n, w.shape[0], h, wd), q, out_dtype, store)


def _dense_cpu(q, w, mult, bias, out_dtype, activation, variant, bh, bn,
               wn, stages, store=True, *code_args):
    out = _dense_fake(q, w, mult, bias, out_dtype, activation, variant, bh,
                      bn, wn, stages, store)
    y = qconv.conv_dense_reference(q, w, mult, bias, OUT_DTYPES[out_dtype],
                                   activation, True, _code_list(*code_args))
    return out.copy_(y) if store else out


def _dense_cuda(q, w, mult, bias, out_dtype, activation, variant, bh, bn,
                wn, stages, store=True, *code_args):
    out = _dense_fake(q, w, mult, bias, out_dtype, activation, variant, bh,
                      bn, wn, stages, store)
    n, cin, h, wd = q.shape
    if n * h * wd * w.shape[0] == 0:
        return out
    lib = _build.load("qconv")
    codes = _code_array(code_args)
    ptrs = (q.data_ptr(), w.data_ptr(), mult.data_ptr(), bias.data_ptr(),
            out.data_ptr() if store else None, n, h, wd, cin, w.shape[0],
            w.shape[1])
    act = qconv._ACT_CODE[activation]
    stream = _build.stream_handle(q.device)
    if variant == "wgmma":
        err = lib.helmet_qconv_wgmma(*ptrs, bh, bn, wn, stages, out_dtype,
                                     act, codes, stream)
    else:
        err = lib.helmet_qconv_dense(*ptrs, out_dtype, act, codes, stream)
    _check_q(err, "conv_dense (%s kernel)" % variant)
    qconv.dense_launches += 1
    if variant == "wgmma":
        qconv.dense_wgmma_launches += 1
    else:
        qconv.dense_mma_launches += 1
    if codes is not None:
        qconv.dense_code_launches += 1
    return out


def _dw_fake(q, w, mult, bias, out_dtype, activation, variant, tw, th, ct,
             store=True, *code_args):
    return _conv_out(q.shape, q, out_dtype, store)


def _dw_cpu(q, w, mult, bias, out_dtype, activation, variant, tw, th, ct,
            store=True, *code_args):
    out = _dw_fake(q, w, mult, bias, out_dtype, activation, variant, tw, th,
                   ct, store)
    y = qconv.conv_dw_reference(q, w, mult, bias, OUT_DTYPES[out_dtype],
                                activation, True, _code_list(*code_args))
    return out.copy_(y) if store else out


def _dw_cuda(q, w, mult, bias, out_dtype, activation, variant, tw, th, ct,
             store=True, *code_args):
    out = _dw_fake(q, w, mult, bias, out_dtype, activation, variant, tw, th,
                   ct, store)
    if q.numel() == 0:
        return out
    n, c, h, wd = q.shape
    lib = _build.load("qconv")
    codes = _code_array(code_args)
    ptrs = (q.data_ptr(), w.data_ptr(), mult.data_ptr(), bias.data_ptr(),
            out.data_ptr() if store else None, n, h, wd, c)
    act = qconv._ACT_CODE[activation]
    stream = _build.stream_handle(q.device)
    if variant == "tiled":
        err = lib.helmet_qconv_dw_tile(*ptrs, tw, th, ct, out_dtype, act,
                                       codes, stream)
    else:
        err = lib.helmet_qconv_dw(*ptrs, out_dtype, act, codes, stream)
    _check_q(err, "conv_dw (%s kernel)" % variant)
    qconv.dw_launches += 1
    if variant == "tiled":
        qconv.dw_tiled_launches += 1
    else:
        qconv.dw_gather_launches += 1
    if codes is not None:
        qconv.dw_code_launches += 1
    return out


IMPLS = {  # op -> (fake, CPU, CUDA)
    "peak_scores": (_peak_fake, _peak_cpu, _peak_cuda),
    "bn_act": (_bn_act_fake, _bn_act_cpu, _bn_act_cuda),
    "bn_add_act": (_bn_add_act_fake, _bn_add_act_cpu, _bn_add_act_cuda),
    "quantize_act": (_quant_fake, _quant_cpu, _quant_cuda),
    "quantize_act2": (_quant2_fake, _quant2_cpu, _quant2_cuda),
    "qconv_dense": (_dense_fake, _dense_cpu, _dense_cuda),
    "qconv_dense_codes": (_dense_fake, _dense_cpu, _dense_cuda),
    "qconv_dw": (_dw_fake, _dw_cpu, _dw_cuda),
    "qconv_dw_codes": (_dw_fake, _dw_cpu, _dw_cuda),
}
for _name, (_fake, _cpu, _cuda) in IMPLS.items():
    LIB.impl(_name, _cpu, "CPU")
    LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake("helmet::" + _name, _fake, lib=LIB)
