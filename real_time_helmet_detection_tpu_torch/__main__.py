"""CLI entry of the PyTorch port: training with `--train-flag`, else eval
over a VOC split, or a one-image demo when `--data` is an image file
(ref main.py:25-37; reference main.py:9-17, train.py:23 and
evaluate.py:245); with `--export-flag`, the predict program's export
(ref main.py:28-31, `export.export_predict`) into `--save-path`.

    python -m real_time_helmet_detection_tpu_torch --train-flag --data DIR \\
        [--batch-size 16] [--amp] [--num-stack 1] [--device cpu]
    python -m real_time_helmet_detection_tpu_torch --data DIR|IMG \\
        --imsize 512 [--model-load w.npz] [--amp] [--device cpu] \\
        [--tier edge|quality] [--serve-buckets 1 2 4 8 16] \\
        [--serve-max-wait-ms 5] [--serve-depth 2] [--serve-queue 128]
    python -m real_time_helmet_detection_tpu_torch --export-flag \
        --imsize 512 [--model-load w.npz] [--export-raw-input] \
        [--export-serve] [--infer-dtype int8] [--save-path DIR]

Training takes `--grad-accum k` (k micro-batches a step, one update) and
`--sub-divisions k` (one update every k steps). Train and eval run on N
cards as N processes, one per card (the reference's convention), each
started with its rank; `--batch-size` is the global batch:

    python -m real_time_helmet_detection_tpu_torch --train-flag --data DIR \
        --batch-size 16 --amp --world-size N --rank R \
        --dist-url tcp://HOST:PORT        # R = 0 .. N-1, one per card
    python -m real_time_helmet_detection_tpu_torch --data DIR --imsize 512 \
        --model-load w.npz --world-size N --rank R --dist-url tcp://HOST:PORT

Rank R runs on cuda:(R % cards) over NCCL; `--device cpu` runs the ranks
on the CPU over gloo (`--dist-backend gloo` also puts several ranks on
one card). Rank 0 prints and writes the checkpoints and eval files.

Eval and the demo predict through the serving engine (one CUDA graph per
bucket). `--tier` applies its preset before anything runs. Runs on the
CUDA card unless `--device cpu` is given; without a card the default
raises rather than running on the CPU.

Every run writes its config snapshot (`argument.json`, `argument.txt`)
into `--save-path` (rank 0 of a multi-process run). `--model-load` of an
eval, demo or export takes a `.npz`, a checkpoint dir (`check_point_N`)
or a save dir (its newest complete checkpoint), and the architecture of
the snapshot beside that checkpoint (`config.get_config`).
"""

from __future__ import annotations

import os
import time

from .config import get_config, save_config


def main(argv=None) -> None:
    cfg = get_config(argv)
    if cfg.data is None and not (cfg.export_flag and not cfg.train_flag):
        raise SystemExit("--data is required (a VOC root or an image file)")
    from .predict import resolve_device
    resolve_device(cfg.device)  # a missing card raises before any write
    if cfg.rank == 0:
        save_config(cfg, cfg.save_path)
    tic = time.time()
    if cfg.train_flag:
        from .train import train
        train(cfg)
    elif cfg.export_flag:
        from .export import export_predict
        paths = export_predict(cfg)
        print("exported:", *[p for p in paths if p])
    elif os.path.isfile(cfg.data):
        from .evaluate import demo
        demo(cfg)
    else:
        from .evaluate import evaluate
        evaluate(cfg)
    print("%s: total run time: %.2fs" % (time.ctime(), time.time() - tic),
          flush=True)


if __name__ == "__main__":
    main()
