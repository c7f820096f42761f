"""Marks of the hand-written kernels' calls, for a count of the work a
path does (`obs.roofline.OpCount`, the port of ref scripts/roofline.py:556
`substitute_epilogue_analytic`).

A count walks the ATen operations a predict or a train step dispatches
and gives each hand-written kernel one row of its own, named after the
kernel, whatever runs it: the launch on a card, or the plain version on
the CPU and the fake on `meta` tensors, whose ATen operations must not
appear as rows. The `helmet::*` ops (`ops.library`) reach the count's
dispatch mode as one operation each. The other wrappers launch through
ctypes inside `torch.autograd.Function`s, which a dispatch mode does not
see, so they carry `@kernel("<name>")`: while a count runs (`recorder`
set) the call goes through the count, which records the kernel and runs
the wrapper with its inner operations hidden; otherwise the wrapper runs
as it is, at the cost of one test of `recorder`.
"""

from __future__ import annotations

import functools

recorder = None  # the count running now (obs.roofline.OpCount), or None


def kernel(name: str):
    """Decorate the wrapper of hand-written kernel `name` (its row in a
    count; `obs.roofline.KERNELS`)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if recorder is None:
                return fn(*args, **kwargs)
            return recorder.kernel(name, fn, args, kwargs)
        return call
    return wrap
