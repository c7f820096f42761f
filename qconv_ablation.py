"""Where the wgmma int8 conv's time goes, by taking parts of it out.

    python3 qconv_ablation.py            # on a CUDA card

Copies the port's package into build/qconv_ablation/<variant>/, edits
one copy of csrc/qconv.cu per variant, and times `conv_dense` of each at
the int8 sites phase qtiming of chip_smoke.py times (CUDA graph replay,
bf16 and int32 out), in turns (each variant, then again in reverse):

* full: the kernel as it is;
* no-epilogue: every tile's epilogue skipped (a branch the compiler cannot
  drop): the loads and the wgmmas;
* loads-only: no epilogue and no wgmma: the TMA loads, the ring;
* mma-only: no epilogue and no input box loaded (the ring's barriers
  complete on zero bytes): the wgmmas on the weights and whatever the
  ring holds;
* lockstep: the two consumer warpgroups issue their wgmmas at once
  instead of taking turns.

The outputs of the edited copies are wrong by design: this measures
time, never results. Prints one line a variant and site, the card's
name and power limit first. The JAX package has no analogue: its int8
conv is XLA's (ref real_time_helmet_detection_tpu/models/hourglass.py:287).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "real_time_helmet_detection_tpu_torch"
OUT = os.path.join(REPO, "build", "qconv_ablation")

SKIP_EPILOGUE = (
    "    constexpr int kCols = 128 / (int)sizeof(OutT);  // channels a pass\n",
    "    if (p.N >= 0) continue;\n"
    "    constexpr int kCols = 128 / (int)sizeof(OutT);  // channels a pass\n")
SKIP_MMA = ("    wgmma_fence();\n    for (int tap = 0; tap < taps; ++tap) {",
            "    wgmma_fence();\n    if (p.N < 0)\n"
            "    for (int tap = 0; tap < taps; ++tap) {")
SKIP_LOADS = ("      mbar_expect_tx(full0 + 8 * slot, atx);\n"
              "      for (int g = 0; g < p.planes; ++g)",
              "      mbar_expect_tx(full0 + 8 * slot, p.N >= 0 ? 0 : atx);\n"
              "      if (p.N < 0)\n      for (int g = 0; g < p.planes; ++g)")
NO_TURNS = [
    ('''    if (wg == 1)
      asm volatile("bar.sync 3, %0;\\n" ::"n"(kWgConsumers) : "memory");
    else if (i > 0)
      asm volatile("bar.sync 2, %0;\\n" ::"n"(kWgConsumers) : "memory");
''', ""),
    ('''    if (wg == 0)
      asm volatile("bar.arrive 3, %0;\\n" ::"n"(kWgConsumers) : "memory");
    else if (t + (int)gridDim.x < p.tiles)
      asm volatile("bar.arrive 2, %0;\\n" ::"n"(kWgConsumers) : "memory");
''', "")]
VARIANTS = {
    "full": [],
    "no-epilogue": [SKIP_EPILOGUE],
    "loads-only": [SKIP_EPILOGUE, SKIP_MMA],
    "mma-only": [SKIP_EPILOGUE, SKIP_LOADS],
    "lockstep": NO_TURNS,
}
# (N, Cin, H, W, Cout, k): the throughput tier's largest 1x1, the
# flagship's 3x3 at 256^2 and at 128^2 (b16 512^2)
SITES = [(16, 64, 256, 256, 96, 1), (16, 128, 256, 256, 128, 3),
         (16, 128, 128, 128, 128, 3)]


def make_copy(name: str) -> str:
    """build/qconv_ablation/<name>/ holding the package with the variant's
    edits applied to csrc/qconv.cu (each edit must match once). Runs in
    the parent process, which never imports the package itself: each
    child imports its own copy."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "port_utils", os.path.join(REPO, PKG, "utils.py"))
    utils = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(utils)
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(root, PKG),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, PKG, "csrc", "qconv.cu")
    with open(path) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError("%s: an edit does not match csrc/qconv.cu "
                               "once" % name)
        text = text.replace(old, new)
    utils.atomic_write_bytes(path, text.encode())
    return root


def time_variant(root: str) -> None:
    """Run in a child process, whose package is the copy at `root` (the
    timing is chip_smoke.py's `graph_ms`)."""
    sys.path.insert(0, root)
    import torch
    from chip_smoke import graph_ms
    from real_time_helmet_detection_tpu_torch.ops import _build, qconv
    if not _build.CSRC.startswith(root):
        raise RuntimeError("imported %s, not the copy" % _build.CSRC)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, c, h, w, cout, k in SITES:
        q = torch.randint(-127, 128, (n, h, w, c), generator=gen,
                          device="cuda", dtype=torch.int8).permute(0, 3, 1, 2)
        wq = torch.randint(-127, 128, (cout, k, k, c), generator=gen,
                           device="cuda", dtype=torch.int8)
        mult = torch.rand(cout, generator=gen, device="cuda") * 1e-3
        bias = torch.randn(cout, generator=gen, device="cuda")
        ms = [graph_ms(lambda: qconv.conv_dense(  # noqa: B023
            q, wq, mult, bias, dt)) for dt in (torch.bfloat16, torch.int32)]
        print("%-12s (%d, %d, %d, %d) -> %d, k %d: bf16 %.4f ms, int32 "
              "%.4f ms" % (os.path.basename(root), n, c, h, w, cout, k,
                           *ms), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        time_variant(sys.argv[2])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    roots = {name: make_copy(name) for name in VARIANTS}
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for name in order:
        rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                              "--time", roots[name]])
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
