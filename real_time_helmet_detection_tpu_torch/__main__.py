"""CLI entry of the PyTorch port: eval over a VOC split, or a one-image
demo when `--data` is an image file (ref main.py:32-37; reference
main.py:9-17 and evaluate.py:245).

    python -m real_time_helmet_detection_tpu_torch --data DIR|IMG \\
        --imsize 512 [--model-load w.npz] [--amp] [--device cpu]

Runs on the CUDA card unless `--device cpu` is given; without a card the
default raises rather than running on the CPU.
"""

from __future__ import annotations

import os
import time

from .config import parse_args


def main(argv=None) -> None:
    cfg = parse_args(argv)
    if cfg.data is None:
        raise SystemExit("--data is required (a VOC root or an image file)")
    tic = time.time()
    if os.path.isfile(cfg.data):
        from .evaluate import demo
        demo(cfg)
    else:
        from .evaluate import evaluate
        evaluate(cfg)
    print("%s: total run time: %.2fs" % (time.ctime(), time.time() - tic),
          flush=True)


if __name__ == "__main__":
    main()
