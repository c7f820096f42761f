"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

The JAX package compiles its kernels through Pallas inside `jax.jit`
(ref ops/pallas/peak.py:83 `pl.pallas_call`); the port compiles its CUDA
C++ sources with `nvcc` into one shared library per source, with a plain
C interface, and binds them with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v [--split-compile=0]
         -o build/torch_kernels/<name>-<hash>.so

* Libraries are built at first use into `build/torch_kernels/` at the
  repo root, keyed by a hash of the sources and flags, so a stale library
  is never loaded and an unchanged one is never rebuilt. A library lands
  under its final name by `os.replace`, so a concurrent reader never sees
  a half-written file.
* `build()` starts one `nvcc` per source, all at once, and waits for all;
  each writes a temporary file of its own (`tempfile.mkstemp` in the
  build directory), so two threads or processes that build one library
  at once never write the same file.
* `load()` holds a module lock, so threads that reach one library at
  first use (the serving engine's warm-up, its dispatcher, a caller)
  build and open it once.
* Every C entry returns `cudaGetLastError()`; `check()` raises on a
  non-zero code.
* `build_ops()` builds what an exported program needs to run without
  Python, with `g++` against the installed torch (include and library
  paths from `torch.utils.cpp_extension`, torch's C++ ABI, rpaths to
  torch's libraries and to this directory; no ninja, no cmake): the op
  library `torch_ops-<hash>.so` (csrc/torch_ops.cpp: the `helmet`
  operators, linked to the eval path's kernel libraries) and the runner
  `torch_runner-<hash>` (cpp/runner.cc), both keyed like the kernel
  libraries. This process never loads the op library (`ops.library`
  registers the namespace here).

Nothing here imports torch or touches a GPU at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional

from ..utils import atomic_write_bytes

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
OPS_SOURCE = os.path.join(CSRC, "torch_ops.cpp")
RUNNER_SOURCE = os.path.join(_PKG, "cpp", "runner.cc")
# the kernel libraries of the eval path, which the op library calls
OP_KERNELS = ("peak", "epilogue", "residual", "qconv")
# the C++ compiler of everything an export builds: the op library, the
# runner and the AOTInductor package's wrapper (which needs OpenMP)
CXX = "g++"
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# nvcc's own threads for one source's kernels (`--split-compile`, CUDA
# 12.1 on): the build's speed, not its code (the same SASS), so not part
# of a library's digest
SPLIT_COMPILE_FROM = (12, 1)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float

# dynamic shared memory a block may opt into on sm_90 (common.cuh
# kMaxDynamicSmem)
MAX_DYNAMIC_SMEM = 227 * 1024

# source name -> {C entry: argtypes}; every entry returns an int error code
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "peak": {"helmet_peak_scores": (_P, _P, _I, _I, _I, _I, _I, _I, _L, _I,
                                     _P),
             "helmet_peak_pick": (_P, _P, _I, _I, _I)},
    "epilogue": {"helmet_bn_act": (_P, _P, _P, _P, _L, _I, _I, _I, _P),
                 "helmet_bn_act_vec": (_P, _P, _P, _P, _L, _I, _I, _I, _P),
                 "helmet_bn_act_pick": (_P, _P, _I, _I)},
    "residual": {"helmet_bn_add_act": (_P, _P, _P, _P, _P, _L, _I, _I, _I,
                                       _P)},
    "bn_train": {
        "helmet_bn_stats": (_P, _P, _P, _L, _I, _I, _I, _P),
        "helmet_bn_bwd_sums": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I,
                               _I, _I, _I, _P),
        "helmet_bn_bwd_dx": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I,
                             _I, _P),
    },
    "qconv": {  # each conv entry's last but one: its code outputs
        "helmet_qconv_dense": (_P, _P, _P, _P, _P) + (_I,) * 8 + (_P, _P),
        "helmet_qconv_dw": (_P, _P, _P, _P, _P) + (_I,) * 6 + (_P, _P),
        "helmet_qconv_wgmma": (_P, _P, _P, _P, _P) + (_I,) * 12 + (_P, _P),
        "helmet_qconv_dw_tile": (_P, _P, _P, _P, _P) + (_I,) * 9 + (_P, _P),
        "helmet_quantize": (_P, _P, _P, _P, _P, _L, _I, _P),
        "helmet_abs_max": (_P, _L, _I, _P, _I, _P, _P, _P),
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
_load_lock = threading.Lock()


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


def _toolkit_version(nvcc: str) -> Optional[tuple]:
    """(major, minor) of `nvcc`'s release, from `nvcc --version`
    ("Cuda compilation tools, release 12.8, V12.8.93"); None where it
    does not say."""
    try:
        out = subprocess.run([nvcc, "--version"], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, timeout=60).stdout
        release = out.decode(errors="replace").split("release ", 1)[1]
        return tuple(int(v) for v in release.split(",", 1)[0].split("."))
    except (OSError, subprocess.SubprocessError, IndexError, ValueError,
            AttributeError, TypeError):
        return None


def nvcc_command(nvcc: str) -> List[str]:
    """`nvcc` and its flags: NVCC_FLAGS, and `--split-compile=0` (as many
    threads as the host has) where the toolkit has it."""
    version = _toolkit_version(nvcc)
    split = version is not None and version >= SPLIT_COMPILE_FROM
    return [nvcc, *NVCC_FLAGS, *(["--split-compile=0"] if split else [])]


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
        fd, tmp = tempfile.mkstemp(prefix=os.path.basename(so) + ".",
                                   suffix=".tmp", dir=BUILD_DIR)
        os.close(fd)
        cmd = nvcc_command(nvcc) + ["-o", tmp,
                                    os.path.join(CSRC, name + ".cu")]
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
    entry's argtypes/restype declared; one build and one open per
    process, whichever threads ask."""
    with _load_lock:
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


# ------------------------------------------- the op library and the runner


def _torch_flags() -> Dict[str, object]:
    """What a C++ build against the installed torch needs: its version,
    include and library directories, and its C++ ABI."""
    import torch
    from torch.utils import cpp_extension
    return {"version": torch.__version__,
            "include": list(cpp_extension.include_paths()),
            "lib": list(cpp_extension.library_paths()),
            "abi": int(torch._C._GLIBCXX_USE_CXX11_ABI)}


def kernel_digests() -> Dict[str, str]:
    """{kernel library: its digest} of the libraries the op library
    calls."""
    return {name: _digest(name) for name in OP_KERNELS}


def _cxx_digest(source: str, *extra: str) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    flags = _torch_flags()
    h.update(("%s %d" % (flags["version"], flags["abi"])).encode())
    for part in extra:
        h.update(part.encode())
    with open(source, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def ops_digest() -> str:
    """The op library's digest: its source, the kernel libraries' digests,
    the torch it is built against and the flags."""
    return _cxx_digest(OPS_SOURCE, *("%s=%s" % kv
                                     for kv in kernel_digests().items()))


def ops_library_path() -> str:
    return os.path.join(BUILD_DIR, "torch_ops-%s.so" % ops_digest())


def runner_path() -> str:
    return os.path.join(BUILD_DIR, "torch_runner-%s" % _cxx_digest(
        RUNNER_SOURCE))


def _cxx_commands() -> Dict[str, List[str]]:
    """{target path: g++ command writing it} of the op library and the
    runner (each command's output path is the target's; `build_ops`
    swaps in a temporary one)."""
    flags = _torch_flags()
    cuda_include = os.path.join(os.path.dirname(os.path.dirname(
        nvcc_path())), "include")
    inc = ["-I" + d for d in flags["include"] + [cuda_include]]
    torch_libs = ["-L" + d for d in flags["lib"]] \
        + ["-Wl,-rpath," + d for d in flags["lib"]]
    cxx = [CXX, *CXX_FLAGS,
           "-D_GLIBCXX_USE_CXX11_ABI=%d" % flags["abi"], *inc]
    kernels = kernel_digests()
    ops = ops_library_path()
    runner = runner_path()
    return {
        ops: cxx + [
            "-shared", '-DHELMET_OPS_DIGEST="%s"' % ops_digest(),
            '-DHELMET_KERNEL_DIGESTS="%s"'
            % ",".join("%s=%s" % kv for kv in kernels.items()),
            OPS_SOURCE, "-o", ops, "-L" + BUILD_DIR,
            *("-l:" + os.path.basename(library_path(n)) for n in kernels),
            *torch_libs, "-lc10", "-lc10_cuda", "-ltorch_cpu",
            "-Wl,-rpath,$ORIGIN"],
        runner: cxx + [
            '-DHELMET_TORCH_VERSION="%s"' % flags["version"],
            RUNNER_SOURCE, "-o", runner, *torch_libs,
            "-Wl,--no-as-needed", "-ltorch", "-ltorch_cuda", "-ltorch_cpu",
            "-lc10", "-lc10_cuda", "-Wl,--as-needed", "-ldl"],
    }


def build_ops() -> Dict[str, float]:
    """Build the eval path's kernel libraries, then the op library and
    the runner (two `g++`, started together), each only where it has no
    current build. Returns {target file name: seconds its g++ took} of
    what was built."""
    build(OP_KERNELS)
    todo = {t: c for t, c in _cxx_commands().items()
            if not os.path.exists(t)}
    os.makedirs(BUILD_DIR, exist_ok=True)

    def one(target: str, cmd: List[str]):
        fd, tmp = tempfile.mkstemp(prefix=os.path.basename(target) + ".",
                                   suffix=".tmp", dir=BUILD_DIR)
        os.close(fd)
        cmd = [tmp if part == target else part for part in cmd]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        secs = time.perf_counter() - t0
        out = proc.stdout.decode(errors="replace")
        atomic_write_bytes(target + ".log", out.encode())
        if proc.returncode != 0:
            os.remove(tmp)
            return target, secs, "%s (g++ exit %d):\n%s" % (
                os.path.basename(target), proc.returncode, out[-8000:])
        os.chmod(tmp, 0o755)
        os.replace(tmp, target)
        return target, secs, None

    with ThreadPoolExecutor(max(1, len(todo))) as pool:
        results = list(pool.map(lambda kv: one(*kv), todo.items()))
    failed = [err for _, _, err in results if err]
    if failed:
        raise RuntimeError("C++ build failed: " + "\n".join(failed))
    return {os.path.basename(t): secs for t, secs, _ in results}
