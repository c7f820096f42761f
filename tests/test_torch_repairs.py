"""Two repairs the serving engine needs, on the CPU.

* `ops/_build.py` is thread-safe: eight threads that load one library at
  first use build and open it once (ctypes and the build monkeypatched:
  no nvcc here), and two concurrent builds of one source write distinct
  temporary files that land under the one final name.
* The eval BN forward runs without its autograd Function when grad mode
  is off: under `no_grad` and `inference_mode` the epilogue and the
  residual tail give outputs bit-equal to the grad-mode path, with no
  `grad_fn`, and `BNEval.forward` is not entered (it still is with grad
  on, which `tests/test_torch_eval_grad.py` holds).
"""

import os
import sys
import threading

import pytest
import torch

from real_time_helmet_detection_tpu_torch.ops import (_build, epilogue,
                                                      residual)


class _FakeLib:
    def __init__(self, path):
        self.path = path
        self.entries = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.entries.setdefault(name, type("Fn", (), {})())


def test_concurrent_load_opens_one_library(monkeypatch):
    opened, built = [], []
    gate = threading.Barrier(8)

    def fake_cdll(path):
        opened.append(path)
        return _FakeLib(path)

    def slow_build(names):
        built.append(list(names))
        threading.Event().wait(0.05)  # widen the race window
        return {}

    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    got = []

    def worker():
        gate.wait()
        got.append(_build.load("epilogue"))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(opened) == 1 and built == [["epilogue"]]
    assert len(got) == 8 and all(lib is got[0] for lib in got)
    assert set(got[0].entries) == set(_build.SIGNATURES["epilogue"])


class _FakePopen:
    """nvcc stand-in: writes the `-o` target when waited on."""
    targets = []
    lock = threading.Lock()

    def __init__(self, cmd, stdout=None, stderr=None):
        self.out = cmd[cmd.index("-o") + 1]
        with self.lock:
            self.targets.append(self.out)
        self.returncode = 0

    def communicate(self):
        threading.Event().wait(0.05)  # both builds in flight at once
        with open(self.out, "wb") as f:
            f.write(b"lib")
        return (b"ptxas info: fake\n", None)


def test_concurrent_builds_use_distinct_temporary_files(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_FakePopen, "targets", [])
    monkeypatch.setattr(_build.subprocess, "Popen", _FakePopen)
    gate = threading.Barrier(2)
    errors = []

    def worker():
        gate.wait()
        try:
            _build.build(["peak"])
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors
    targets = _FakePopen.targets
    assert len(targets) == 2 and len(set(targets)) == 2
    final = _build.library_path("peak")
    assert all(os.path.dirname(t) == str(tmp_path) and t != final
               for t in targets)
    assert os.path.exists(final) and os.path.exists(final + ".log")
    left = sorted(os.listdir(tmp_path))
    assert left == sorted([os.path.basename(final),
                           os.path.basename(final) + ".log"])


def _operands(c=8, seed=0):
    gen = torch.Generator().manual_seed(seed)
    shape = (2, c, 5, 6)
    x = torch.randn(shape, generator=gen).contiguous(
        memory_format=torch.channels_last)
    skip = torch.randn(shape, generator=gen).contiguous(
        memory_format=torch.channels_last)
    a = torch.rand(c, generator=gen) + 0.5
    b = torch.randn(c, generator=gen)
    return x, skip, a, b


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
@pytest.mark.parametrize("act", ["ReLU", "Mish", "Linear"])
def test_eval_bn_skips_the_autograd_function_without_grad(monkeypatch,
                                                         mode, act):
    x, skip, a, b = _operands()
    x.requires_grad_(True)
    a.requires_grad_(True)
    want_epi = epilogue.bn_act_eval(x, a, b, act)
    want_res = residual.bn_add_act_eval(x, a, b, skip, act)
    assert want_epi.grad_fn is not None and want_res.grad_fn is not None
    entered = []
    real = epilogue.BNEval.forward

    def counting(ctx, *args):
        entered.append(1)
        return real(ctx, *args)
    monkeypatch.setattr(epilogue.BNEval, "forward", staticmethod(counting))
    off = torch.no_grad() if mode == "no_grad" else torch.inference_mode()
    with off:
        got_epi = epilogue.bn_act_eval(x, a, b, act)
        got_res = residual.bn_add_act_eval(x, a, b, skip, act)
    assert entered == []
    assert got_epi.grad_fn is None and got_res.grad_fn is None
    assert torch.equal(got_epi, want_epi.detach())
    assert torch.equal(got_res, want_res.detach())
    assert got_epi.is_contiguous(memory_format=torch.channels_last)
    # with grad on the Function runs, so the gradient reaches x and a
    epilogue.bn_act_eval(x, a, b, act).sum().backward()
    assert entered == [1] and x.grad is not None and a.grad is not None
