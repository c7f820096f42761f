"""Data parallelism of the port: one process per card.

The port's counterparts of ref real_time_helmet_detection_tpu/parallel/
mesh.py:35 `init_distributed`, :66 `fit_data_mesh` and :104
`shard_batch`. JAX puts every device of every host into one mesh and
lets GSPMD shard the batch; the port runs one process per card (the
reference's convention) and wraps the model in DistributedDataParallel,
with the BN moments, the BN backward sums and the loss's positive count
summed over the ranks (`ops/epilogue.py` `BNTrain`, `ops/loss.py`
`_num_pos`) so that a step computes what JAX's global-batch step does.

* `rank_device(cfg)`: `cuda:(rank % device_count)`, or the CPU;
* `init_distributed(cfg)`: the rank's device made current, then the
  process group (`distributed.init_process_group`);
* `local_batch_size(cfg)`: JAX's multi-host check (ref train.py:1713-1724)
  and each rank's share of `--batch-size`.
"""

from __future__ import annotations

import torch

from .distributed import (all_gather_arrays, all_reduce_sum_,  # noqa
                          barrier_synced_build, coordination_barrier,
                          destroy_process_group, init_process_group, rank,
                          world_size)


def rank_device(cfg) -> torch.device:
    """This rank's device: `cuda:(rank % device_count)` for a card in a
    multi-process run (`--device` as given at world 1; CUDA without a
    card raises), else the CPU."""
    from ..predict import resolve_device
    dev = resolve_device(cfg.device)
    if dev.type == "cuda" and dev.index is None and cfg.world_size > 1:
        dev = torch.device("cuda", cfg.rank % torch.cuda.device_count())
    return dev


def init_distributed(cfg) -> torch.device:
    """Make the rank's device current and join the process group (world
    > 1); returns the device."""
    dev = rank_device(cfg)
    if dev.type == "cuda" and cfg.world_size > 1:
        torch.cuda.set_device(dev)
    init_process_group(cfg, dev)
    return dev


def local_batch_size(cfg) -> int:
    """`--batch-size // --world-size`, after JAX's multi-host check: the
    micro-batch (`--batch-size / --grad-accum`) must split evenly over
    the ranks."""
    micro = cfg.batch_size // max(1, cfg.grad_accum)
    if micro % cfg.world_size:
        raise ValueError(
            "multi-host run: the micro-batch %d (--batch-size %d / "
            "--grad-accum %d) must be divisible by the data mesh axis "
            "%d (devices %d / spatial %d)"
            % (micro, cfg.batch_size, cfg.grad_accum, cfg.world_size,
               cfg.world_size, cfg.spatial))
    return cfg.batch_size // cfg.world_size
