"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

The JAX package compiles its kernels through Pallas inside `jax.jit`
(ref ops/pallas/peak.py:83 `pl.pallas_call`); the port compiles its CUDA
C++ sources with `nvcc` into one shared library per source, with a plain
C interface, and binds them with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/<name>-<hash>.so

* Libraries are built at first use into `build/torch_kernels/` at the
  repo root, keyed by a hash of the sources and flags, so a stale library
  is never loaded and an unchanged one is never rebuilt. A library lands
  under its final name by `os.replace`, so a concurrent reader never sees
  a half-written file.
* `build()` starts one `nvcc` per source, all at once, and waits for all.
* Every C entry returns `cudaGetLastError()`; `check()` raises on a
  non-zero code.

Nothing here imports torch or touches a GPU at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Optional

from ..utils import atomic_write_bytes

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float

# dynamic shared memory a block may opt into on sm_90 (common.cuh
# kMaxDynamicSmem)
MAX_DYNAMIC_SMEM = 227 * 1024

# source name -> {C entry: argtypes}; every entry returns an int error code
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "peak": {"helmet_peak_scores": (_P, _P, _I, _I, _I, _I, _I, _I, _L, _I,
                                     _P)},
    "epilogue": {"helmet_bn_act": (_P, _P, _P, _P, _L, _I, _I, _I, _P),
                 "helmet_bn_act_vec": (_P, _P, _P, _P, _L, _I, _I, _I, _P)},
    "residual": {"helmet_bn_add_act": (_P, _P, _P, _P, _P, _L, _I, _I, _I,
                                       _P)},
    "bn_train": {
        "helmet_bn_stats": (_P, _P, _P, _L, _I, _I, _I, _P),
        "helmet_bn_bwd_sums": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I,
                               _I, _I, _I, _P),
        "helmet_bn_bwd_dx": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I,
                             _I, _P),
    },
    "loss": {
        "helmet_loss_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _F, _F, _I, _I, _P),
        "helmet_loss_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                            _I, _I, _I, _F, _F, _I, _I, _P),
        "helmet_loss_bwd_vec": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _F, _F, _I, _I, _P),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: `nvcc` on PATH, else under $CUDA_HOME or the
    toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return path


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC)):
        if fname == name + ".cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC, fname), "rb") as f:
                h.update(fname.encode() + f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    if name not in SIGNATURES:
        raise KeyError("unknown kernel source %r (have %s)"
                       % (name, sorted(SIGNATURES)))
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, _digest(name)))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source (default: all) that has no current
    library, one `nvcc` each, all started together. Returns
    {name: compiler output} (the `-Xptxas -v` register / shared-memory /
    spill report), read back from the log kept beside each library."""
    names = list(SIGNATURES if names is None else names)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if todo:
        nvcc = nvcc_path()
        os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in todo:
        so = library_path(name)
        tmp = "%s.tmp.%d" % (so, os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), so, tmp)
    failed = []
    for name, (proc, so, tmp) in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        atomic_write_bytes(so + ".log", out.encode())
        if proc.returncode == 0:
            os.replace(tmp, so)
        else:
            failed.append("%s (nvcc exit %d):\n%s"
                          % (name, proc.returncode, out))
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    logs = {}
    for name in names:
        log = library_path(name) + ".log"
        logs[name] = ""
        if os.path.exists(log):
            with open(log) as f:
                logs[name] = f.read()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed, with every
    entry's argtypes/restype declared."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError("%s: CUDA error %d at launch" % (what, err))


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on `device`, as the integer the C
    entries take."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
