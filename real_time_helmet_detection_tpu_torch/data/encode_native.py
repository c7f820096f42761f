"""ctypes binding of the native host GT encoder (cpp/encode.cc), the
train collate's batch encoder.

Port of ref real_time_helmet_detection_tpu/ops/encode_native.py:36-146
(`encode_boxes_native`, `encode_boxes_batch_native`) with two
departures:

* No silent numpy fallback. JAX's binding returns None when g++ is
  missing and its caller encodes with numpy; here the library is built
  at first use with `g++` (a plain C ABI: no Python or torch headers)
  into `build/torch_kernels/hostops_encode-<hash>.so` at the repo root,
  keyed by a hash of the source and flags, written to a temporary file
  and moved into place with `os.replace` (two processes that build at
  once never share a file), and a failed build raises. The numpy
  encoder `ops/encode.py` `encode_boxes_batch` stays the plain version
  the tests hold this one to, bit for bit.
* It lives in `data/`, not `ops/`: the process loader's workers import
  the collate, and must not import torch (importing anything under
  `ops/` registers the `helmet` operators, which imports torch). Its
  import chain is numpy and the standard library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "cpp", "encode.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
CXX_COMMAND = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_COMMAND).encode())
    return os.path.join(BUILD_DIR,
                        "hostops_encode-%s.so" % digest.hexdigest()[:16])


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="hostops_encode-", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*CXX_COMMAND, SOURCE, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("building the native encoder failed (g++ "
                               "exit %d):\n%s" % (proc.returncode,
                                                  proc.stderr[-2000:]))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load() -> ctypes.CDLL:
    """The native library, built at first use; raises if it cannot be
    built or opened."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i32, f32 = ctypes.c_int32, ctypes.c_float
        lib.encode_boxes_f32.argtypes = [
            f32p, i32p, i32, i32, i32, f32, i32, i32, f32p, f32p, f32p,
            f32p]
        lib.encode_boxes_f32.restype = None
        lib.encode_boxes_batch_f32.argtypes = [
            f32p, i32p, i32p, i32, i32, i32, i32, f32, i32, i32, f32p, f32p,
            f32p, f32p]
        lib.encode_boxes_batch_f32.restype = None
        _lib = lib
        return lib


def encode_boxes_native(boxes, labels, imsize, scale_factor: int = 4,
                        num_cls: int = 2, normalized: bool = False
                        ) -> Tuple[np.ndarray, ...]:
    """`ops.encode.encode_boxes` of one image: (heat, offset, size, mask)
    channels-last float32 maps at imsize // scale_factor."""
    lib = load()
    width = int(imsize[0]) // scale_factor
    height = int(imsize[1]) // scale_factor
    heat, offset, size, mask = (np.zeros((height, width, c), np.float32)
                                for c in (num_cls, 2, 2, 1))
    n = 0 if boxes is None else len(boxes)
    if n:
        b = np.ascontiguousarray(np.asarray(boxes, np.float32).reshape(-1, 4))
        lb = np.ascontiguousarray(np.asarray(labels, np.int32).reshape(-1))
        lib.encode_boxes_f32(b, lb, n, width, height, float(scale_factor),
                             num_cls, int(normalized), heat, offset, size,
                             mask)
    return heat, offset, size, mask


def encode_boxes_batch_native(boxes: np.ndarray, labels: np.ndarray,
                              counts: np.ndarray, imsize,
                              scale_factor: int = 4, num_cls: int = 2,
                              normalized: bool = False,
                              out: Optional[Tuple[np.ndarray, ...]] = None
                              ) -> Tuple[np.ndarray, ...]:
    """A whole batch in one native call: boxes (B, max_boxes, 4) padded,
    labels (B, max_boxes), counts (B,) boxes to encode per image. `out`:
    optional C-contiguous, ZERO-initialized float32 (heat, offset, size,
    mask) destinations (the process loader's shared-memory views)."""
    lib = load()
    batch, max_boxes = labels.shape
    width = int(imsize[0]) // scale_factor
    height = int(imsize[1]) // scale_factor
    if out is None:
        out = tuple(np.zeros((batch, height, width, c), np.float32)
                    for c in (num_cls, 2, 2, 1))
    heat, offset, size, mask = out
    lib.encode_boxes_batch_f32(
        np.ascontiguousarray(boxes, dtype=np.float32),
        np.ascontiguousarray(labels, dtype=np.int32),
        np.ascontiguousarray(counts, dtype=np.int32),
        batch, max_boxes, width, height, float(scale_factor), num_cls,
        int(normalized), heat, offset, size, mask)
    return heat, offset, size, mask
