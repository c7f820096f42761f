"""A JAX-package orbax checkpoint through `scripts/orbax_to_npz.py` into
the port, on the CPU.

The JAX package's own `create_train_state` and `save_checkpoint` (ref
train.py:103, :788) write `check_point_1` for a ghost + PReLU model (so
the grouped kernels and the scalar PReLU slopes cross too) with a random
BN state; the script converts it; the port's eval loader
(`load_eval_state`, what `--model-load` runs) reads the npz, and its
eval logits equal JAX `apply` on the tree that the JAX package's
`restore_variables` restores from the same directory, within atol = rtol
1e-4 (observed max abs 3.6e-7). The eval CLI then runs on the npz to a
printed mAP. With `--ema` on a checkpoint without EMA weights the script
refuses.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu import optim as jax_optim
from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.ops.loss import LossLog
from real_time_helmet_detection_tpu.train import (create_train_state,
                                                  restore_variables,
                                                  save_checkpoint)
from real_time_helmet_detection_tpu_torch.__main__ import main
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.data.synthetic import \
    make_synthetic_voc
from real_time_helmet_detection_tpu_torch.evaluate import load_eval_state

from test_torch_model import randomize_bn
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(imsize=64, hourglass_inch=16, num_cls=2, variant="ghost",
            activation="PReLU")


def load_script():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_npz", os.path.join(REPO, "scripts", "orbax_to_npz.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_orbax_checkpoint_loads_into_the_port(tmp_path, capsys):
    jcfg = JaxConfig(**ARCH)
    jmodel = jax_build(jcfg)
    state = create_train_state(jmodel, jcfg, jax.random.key(0), 64,
                               jax_optim.build_optimizer(jcfg, 1))
    tree = randomize_bn(jax.device_get({"params": state.params,
                                        "batch_stats": state.batch_stats}),
                        seed=4)
    state = state.replace(params=tree["params"],
                          batch_stats=tree["batch_stats"])
    ckpt = save_checkpoint(str(tmp_path / "jax"), 0, state, LossLog())
    assert os.path.basename(ckpt) == "check_point_1"
    out = str(tmp_path / "w.npz")
    script = load_script()
    assert script.main([ckpt, out]) == 0
    with np.load(out) as f:
        keys = set(f.files)
        slope = ("params/Hourglass_0/Residual_0/Activation_0/PReLU_0/"
                 "negative_slope")
        assert f[slope].shape == ()
        assert not any(k.startswith("opt_state") or k == "step"
                       for k in keys)
    with pytest.raises(ValueError, match="EMA"):
        script.main([ckpt, str(tmp_path / "ema.npz"), "--ema"])

    params, stats = restore_variables(ckpt, state.params, state.batch_stats)
    images = np.random.default_rng(2).normal(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jmodel.apply, static_argnames=("train",))(
        {"params": params, "batch_stats": stats}, jnp.asarray(images),
        train=False))
    model = load_eval_state(Config(device="cpu", model_load=out, **ARCH))
    with torch.inference_mode():
        got = model(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, 1, 16, 16, 6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    voc = make_synthetic_voc(str(tmp_path / "voc"), num_train=0, num_test=2,
                             imsize=(96, 72), seed=1)
    capsys.readouterr()
    main(["--data", voc, "--device", "cpu", "--imsize", "64",
          "--hourglass-inch", "16", "--variant", "ghost", "--activation",
          "PReLU", "--batch-size", "2", "--model-load", out,
          "--save-path", str(tmp_path / "eval")])
    assert ": mAP " in capsys.readouterr().out
