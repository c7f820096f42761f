"""Configuration of the PyTorch port's eval/predict path.

A dataclass copy of the JAX package's flags that this path reads
(ref real_time_helmet_detection_tpu/config.py:88 `Config`; reference
config.py:139-169), with the same names and defaults, plus `--device`.
Field name -> CLI flag: underscores become dashes.

Values the port has not built yet raise `NotImplementedError` instead of
running something else: NMS other than hard "nms" here; activations
other than ReLU/Mish/Linear, pools other than Max/None, a neck pool
other than None, variants other than "residual" and `--num-stack` < 1
where the model is built (models/hourglass.py). The JAX flags that only
choose between a kernel and its XLA composition (`--use-pallas`,
`--epilogue`, `--block-fuse`) and `--infer-dtype` have no field: the
port has one path, its kernels, and the parser refuses those flags.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass
class Config:
    # device
    device: str = "cuda"          # torch device; "cpu" runs the kernels'
    # plain versions (tests). cuda without a card raises.
    random_seed: int = 777

    # data
    data: Optional[str] = None
    batch_size: int = 16
    save_path: str = "./WEIGHTS/"
    print_interval: int = 100

    # precision: bf16 weights and activations, float32 BN fold + output
    amp: bool = False

    # evaluation, demo
    imsize: Optional[int] = None
    topk: int = 100
    conf_th: float = 0.0
    nms_th: float = 0.5
    pool_size: int = 3
    model_load: Optional[str] = None  # npz of the flax variable tree
    nms: str = "nms"
    fontsize: int = 10

    # network
    variant: str = "residual"
    stem_width: int = 0
    scale_factor: int = 4
    num_cls: int = 2
    pretrained: str = "imagenet"
    normalized_coord: bool = False
    num_stack: int = 1
    hourglass_inch: int = 128
    increase_ch: int = 0
    activation: str = "ReLU"
    pool: str = "Max"
    neck_activation: str = "ReLU"
    neck_pool: str = "None"

    def __post_init__(self):
        def only(flag, value, allowed):
            if value not in allowed:
                raise NotImplementedError(
                    "--%s %r is not ported yet (have %s)"
                    % (flag, value, ", ".join(allowed)))

        only("nms", self.nms, ("nms",))
        if self.scale_factor != 4:
            raise ValueError("--scale-factor must be 4: the stem's 4x "
                             "downsample is structural")
        if self.stem_width < 0:
            raise ValueError("--stem-width must be >= 0, got %d"
                             % self.stem_width)
        if self.pool_size % 2 != 1 or self.pool_size < 1:
            raise ValueError("--pool-size must be odd and >= 1, got %d"
                             % self.pool_size)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m real_time_helmet_detection_tpu_torch",
        description="Helmet detection eval/demo, PyTorch port")
    for f in dataclasses.fields(Config):
        flag = "--" + f.name.replace("_", "-")
        if f.type in ("bool", bool):
            parser.add_argument(flag, action=argparse.BooleanOptionalAction,
                                default=f.default)
        elif f.type == "Optional[int]":
            parser.add_argument(flag, type=int, default=f.default)
        elif f.type == "Optional[str]":
            parser.add_argument(flag, type=str, default=f.default)
        else:
            parser.add_argument(flag, type=type(f.default), default=f.default)
    return parser


def parse_args(argv=None) -> Config:
    ns = vars(build_parser().parse_args(argv))
    return Config(**{f.name: ns[f.name] for f in dataclasses.fields(Config)})
