"""The train CLI's layer table (`--summary`, on by default) against the
JAX package, on the CPU.

JAX prints `nn.tabulate(depth=2)` of the model on the chief at train
start (ref train.py:1832-1842, config.py:456-458; the reference prints
torchsummary on rank 0). The port prints `models.hourglass.layer_summary`
from shape inference on `meta` tensors: its total must equal the model's
parameter count and JAX's (`sum(x.size for x in leaves(params))`, from
`jax.eval_shape` of the init) for the flagship, the ghost and depthwise
variants and a 2-stack model; `--no-summary` prints nothing, and neither
does a rank other than the chief.
"""

import jax
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.train import init_variables
from real_time_helmet_detection_tpu_torch.__main__ import main
from real_time_helmet_detection_tpu_torch.config import Config, parse_args
from real_time_helmet_detection_tpu_torch.data.synthetic import \
    make_synthetic_voc
from real_time_helmet_detection_tpu_torch.models.hourglass import (
    build_model, format_summary, layer_summary)
from real_time_helmet_detection_tpu_torch.train import print_layer_table

from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

ARCHS = {
    "flagship": {},
    "ghost": dict(variant="ghost", hourglass_inch=96, stem_width=96),
    "depthwise": dict(variant="depthwise"),
    "2-stack": dict(num_stack=2, hourglass_inch=32),
}


def jax_count(kw):
    model = jax_build(JaxConfig(**kw))
    params, _ = jax.eval_shape(
        lambda: init_variables(model, jax.random.key(0), 64))
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))


@pytest.mark.parametrize("name", list(ARCHS))
def test_total_equals_the_model_and_jax(name):
    kw = ARCHS[name]
    rows, total = layer_summary(Config(device="cpu", **kw), 128)
    assert total == sum(p.numel() for p in build_model(
        Config(device="cpu", **kw)).parameters())
    assert total == jax_count(kw)
    assert sum(r[3] for r in rows) == total
    names = [r[0] for r in rows]
    assert names[0] == "PreLayer_0.Convolution_0" \
        and "Head_0.Convolution_0" in names
    assert dict((r[0], r[2]) for r in rows)["Head_0.Convolution_0"] \
        == (1, 6, 32, 32)
    assert format_summary(rows, total).splitlines()[-1] \
        == "total params: %d" % total


def test_shape_inference_touches_no_real_tensor():
    """The table's forward runs on `meta` tensors: the kernels' wrappers
    take their fakes and plain versions there, and no tensor with data
    is made."""
    made = []

    class Spy(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (list, tuple)) else (out,)):
                if isinstance(t, torch.Tensor) and t.device.type != "meta":
                    made.append(str(func))
            return out

    with Spy():
        _, total = layer_summary(Config(device="cpu"), 256)
    assert total > 0 and made == []


def test_chief_prints_and_flags(capsys):
    cfg = Config(device="cpu", hourglass_inch=16, imsize=64)
    print_layer_table(cfg, chief=True)
    out = capsys.readouterr().out
    _, total = layer_summary(cfg, 64)
    assert out.splitlines()[-1] == "total params: %d" % total
    print_layer_table(cfg, chief=False)
    print_layer_table(parse_args(["--no-summary", "--hourglass-inch",
                                  "16"]), chief=True)
    assert capsys.readouterr().out == ""
    assert parse_args([]).summary and not parse_args(["--no-summary"]).summary


def test_cli_train_prints_the_table_once(tmp_path, capsys):
    root = make_synthetic_voc(str(tmp_path / "voc"), num_train=4,
                              num_test=0, imsize=(96, 72), seed=1)
    argv = ["--train-flag", "--device", "cpu", "--data", root,
            "--batch-size", "4", "--end-epoch", "1", "--hourglass-inch",
            "16", "--multiscale", "32", "64", "32", "--num-workers", "0"]
    main(argv + ["--save-path", str(tmp_path / "a")])
    out = capsys.readouterr().out
    totals = [ln for ln in out.splitlines() if ln.startswith("total params")]
    _, total = layer_summary(Config(device="cpu", hourglass_inch=16), 64)
    assert totals == ["total params: %d" % total]
    main(argv + ["--no-summary", "--save-path", str(tmp_path / "b")])
    assert "total params" not in capsys.readouterr().out
