"""Convert a JAX-package orbax checkpoint into the PyTorch port's npz.

    python scripts/orbax_to_npz.py CKPT_DIR OUT.npz [--ema]

Reads a `check_point_N` directory written by the JAX package's
`save_checkpoint` (ref real_time_helmet_detection_tpu/train.py:788) with
its own structure-free restore, `_restore_raw` (train.py:919), and takes
`["state"]`'s `params` (or, with `--ema`, its `ema_params`, as
`restore_variables(prefer_ema=True)` does, train.py:1031-1045) and
`batch_stats`. It writes them in the format the port's `--model-load`
reads (`real_time_helmet_detection_tpu_torch/convert.py` `save_npz`): one
`np.savez` entry per leaf under its flattened `params/a/b/c` key. The
optimizer state and the step are left out.

It needs jax and orbax, so it runs where the JAX package runs, and not on
a machine that has only the port; it imports nothing of the port.
"""

from __future__ import annotations

import argparse
import io
import os
import sys
from typing import Dict, Mapping

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {"a/b/c": array}, as the port's convert.flatten_tree."""
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = "%s/%s" % (prefix, key) if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten_tree(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def checkpoint_variables(path: str, ema: bool = False) -> Dict:
    """{"params", "batch_stats"} of a JAX checkpoint dir as numpy trees."""
    from real_time_helmet_detection_tpu.train import _restore_raw
    state = _restore_raw(path)["state"]
    key = "params"
    if ema:
        if "ema_params" not in state:
            raise ValueError("--ema: checkpoint %s has no EMA weights "
                             "(trained without --ema-decay)" % path)
        key = "ema_params"
    return {"params": _numpy_tree(state[key]),
            "batch_stats": _numpy_tree(state.get("batch_stats", {}))}


def _numpy_tree(tree: Mapping) -> Dict:
    return {k: _numpy_tree(v) if isinstance(v, Mapping)
            else np.asarray(v, np.float32) for k, v in tree.items()}


def convert(path: str, out: str, ema: bool = False) -> int:
    """Write `out`; returns the number of leaves written."""
    from real_time_helmet_detection_tpu.utils import atomic_write_bytes
    flat = flatten_tree(checkpoint_variables(path, ema))
    buf = io.BytesIO()
    np.savez(buf, **flat)
    atomic_write_bytes(out, buf.getvalue())
    return len(flat)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", help="a check_point_N dir of the JAX "
                    "package")
    ap.add_argument("out", help="the .npz to write")
    ap.add_argument("--ema", action="store_true",
                    help="take the EMA weights (--ema-decay runs)")
    args = ap.parse_args(argv)
    if not args.out.endswith(".npz"):
        ap.error("the port's --model-load reads an .npz: %r" % args.out)
    n = convert(args.checkpoint, args.out, args.ema)
    print("%s: %d leaves -> %s" % (args.checkpoint, n, args.out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
