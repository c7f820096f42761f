"""Config snapshots and the checkpoint-dir restore of the PyTorch port,
and its train-extras flags, against the JAX package, on the CPU.

The repair: the port wrote no `argument.json` and `--model-load` took
only an `.npz` with the command line's architecture, so the JAX recipe's
eval of a save dir or a `check_point_N` dir raised, and a checkpoint of
another architecture could not be evaluated without restating it. Now
(ref config.py:853-913, train.py:874-915):

* every CLI run writes `argument.json`/`argument.txt` into `--save-path`
  (rank 0 only), JAX's keys, so each package reads the other's;
* eval, demo and export with `--model-load` resolve a save dir to its
  newest complete checkpoint (a port checkpoint is complete when both
  `checkpoint.pt` and `weights.npz` are written) and take the
  `ARCHITECTURE_FIELDS` of the snapshot beside it, by JAX's rule; a
  checkpoint dir reads its `weights.npz`; an `.npz` works as before.
"""

import dataclasses
import os
import pickle
import shutil

import numpy as np
import pytest

from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.config import get_config as jax_get_config
from real_time_helmet_detection_tpu.config import \
    load_config as jax_load_config
from real_time_helmet_detection_tpu.config import parse_args as jax_parse
from real_time_helmet_detection_tpu.config import \
    save_config as jax_save_config
from real_time_helmet_detection_tpu_torch import evaluate as evaluate_mod
from real_time_helmet_detection_tpu_torch.__main__ import main
from real_time_helmet_detection_tpu_torch.config import (
    ARCHITECTURE_FIELDS, Config, get_config, load_config, parse_args)
from real_time_helmet_detection_tpu_torch.data.synthetic import \
    make_synthetic_voc

from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

ARCH = ["--hourglass-inch", "16", "--stem-width", "16", "--variant", "ghost",
        "--num-stack", "2", "--neck-pool", "SPP"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A save dir of a port training run of a non-default architecture:
    its snapshot, a complete check_point_1 and an incomplete
    check_point_2 (its checkpoint.pt only, as a kill between the two
    writes leaves it)."""
    root = tmp_path_factory.mktemp("snap")
    voc = make_synthetic_voc(str(root / "voc"), num_train=4, num_test=3,
                             seed=1)
    save = str(root / "save")
    main(["--train-flag", "--data", voc, "--device", "cpu", "--batch-size",
          "4", "--end-epoch", "1", "--multiscale", "32", "64", "32",
          "--num-workers", "2", "--save-path", save] + ARCH)
    os.makedirs(os.path.join(save, "check_point_2"))
    shutil.copy(os.path.join(save, "check_point_1", "checkpoint.pt"),
                os.path.join(save, "check_point_2", "checkpoint.pt"))
    return voc, save


def eval_map(argv, capsys):
    capsys.readouterr()
    main(argv)
    out = capsys.readouterr().out
    return float(out.split(": mAP ")[1].split()[0])


@pytest.mark.parametrize("which", ["save-dir", "checkpoint-dir"])
def test_model_load_restores_architecture_and_checkpoint(trained, which,
                                                         tmp_path, capsys):
    voc, save = trained
    ckpt = os.path.join(save, "check_point_1")
    arg = save if which == "save-dir" else ckpt
    common = ["--data", voc, "--device", "cpu", "--imsize", "64",
              "--batch-size", "3"]
    # the fault: the command line's architecture cannot take the weights
    with pytest.raises(RuntimeError, match="size mismatch"):
        main(common + ["--model-load", os.path.join(ckpt, "weights.npz"),
                       "--save-path", str(tmp_path / "bad")])
    cfg = get_config(common + ["--model-load", arg])
    assert os.path.normpath(cfg.model_load) == os.path.normpath(ckpt)
    want = jax_get_config([a for a in common if a not in ("--device",
                                                          "cpu")]
                          + ["--model-load", ckpt, "--save-path",
                             str(tmp_path / "jax")])
    for f in ARCHITECTURE_FIELDS:
        assert getattr(cfg, f) == getattr(want, f), f
    assert (cfg.num_stack, cfg.variant, cfg.neck_pool) == (2, "ghost", "SPP")
    out = str(tmp_path / "eval")
    got = eval_map(common + ["--model-load", arg, "--save-path", out],
                   capsys)
    ref = eval_map(common + ["--model-load", os.path.join(
        ckpt, "weights.npz"), "--save-path", str(tmp_path / "npz")] + ARCH,
        capsys)
    assert abs(got - ref) <= 1e-3
    with open(os.path.join(out, "prediction_results.pickle"), "rb") as f:
        a = pickle.load(f)
    with open(os.path.join(tmp_path / "npz",
                           "prediction_results.pickle"), "rb") as f:
        b = pickle.load(f)
    for k in b:
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # the eval's own snapshot carries the restored architecture
    assert load_config(os.path.join(out, "argument.json")).num_stack == 2


def test_snapshots_cross_packages(trained, tmp_path):
    """JAX reads the port's snapshot and the port JAX's, to the same
    architecture fields."""
    _, save = trained
    snap = os.path.join(save, "argument.json")
    port, jax_cfg = load_config(snap), jax_load_config(snap)
    for f in ARCHITECTURE_FIELDS:
        assert getattr(port, f) == getattr(jax_cfg, f), f
    jcfg = JaxConfig(num_stack=3, hourglass_inch=32, variant="depthwise",
                     activation="Mish", increase_ch=8, pool="Avg")
    jax_save_config(jcfg, str(tmp_path))
    back = load_config(os.path.join(tmp_path, "argument.json"))
    for f in ARCHITECTURE_FIELDS:
        assert getattr(back, f) == getattr(jcfg, f), f


def test_jax_snapshot_with_unported_train_options(trained, tmp_path,
                                                  capsys):
    """A JAX run's snapshot with train and runtime options the port
    refuses (device augmentation, 4 devices, a spatial mesh) still gives
    the architecture, and an eval of a checkpoint beside it runs."""
    voc, save = trained
    jcfg = JaxConfig(device_augment=True, num_devices=4, spatial=2,
                     **{f: getattr(load_config(os.path.join(
                         save, "argument.json")), f)
                        for f in ARCHITECTURE_FIELDS})
    jsave = str(tmp_path / "jax_save")
    jax_save_config(jcfg, jsave)
    snap = os.path.join(jsave, "argument.json")
    back, want = load_config(snap), jax_load_config(snap)
    assert (want.device_augment, want.num_devices, want.spatial) == \
        (True, 4, 2)
    for f in ARCHITECTURE_FIELDS:
        assert getattr(back, f) == getattr(want, f), f
    shutil.copytree(os.path.join(save, "check_point_1"),
                    os.path.join(jsave, "check_point_1"))
    common = ["--data", voc, "--device", "cpu", "--imsize", "64",
              "--batch-size", "3"]
    cfg = get_config(common + ["--model-load", jsave])
    assert (cfg.num_stack, cfg.variant, cfg.neck_pool) == (2, "ghost", "SPP")
    assert not cfg.device_augment
    got = eval_map(common + ["--model-load", jsave, "--save-path",
                             str(tmp_path / "eval")], capsys)
    ref = eval_map(common + ["--model-load", os.path.join(
        save, "check_point_1"), "--save-path", str(tmp_path / "port")],
        capsys)
    assert got == ref


def test_only_rank_zero_writes_the_snapshot(trained, tmp_path, monkeypatch):
    voc, _ = trained
    monkeypatch.setattr(evaluate_mod, "evaluate", lambda cfg: None)
    for rank in (1, 0):
        out = str(tmp_path / ("r%d" % rank))
        main(["--data", voc, "--device", "cpu", "--world-size", "2",
              "--rank", str(rank), "--save-path", out])
        assert os.path.exists(os.path.join(out, "argument.json")) == \
            (rank == 0)
    txt = open(os.path.join(tmp_path, "r0", "argument.txt")).read()
    assert "world_size: 2\n" in txt and "rank: 0\n" in txt


# ------------------------------------------------ the train-extras flags

EXTRAS = [
    ["--remat", "stacks"], ["--remat", "full"], ["--remat", "none"],
    ["--fwd-dtype", "int8"], ["--amp", "--param-policy", "bf16-compute"],
    ["--ema-decay", "0.99", "--ema-eval"], ["--no-ema-eval"],
    ["--sentinel", "--sentinel-spike", "50", "--sentinel-backoff", "0.25",
     "--sentinel-divergence", "5", "--sentinel-rollbacks", "1"],
    ["--distill", "t", "--distill-alpha", "0.3"],
    ["--amp", "--param-policy", "bf16-compute", "--grad-accum", "2",
     "--batch-size", "4"],
]


@pytest.mark.parametrize("argv", EXTRAS, ids=lambda a: " ".join(a))
def test_extras_parse_like_jax(argv):
    port, jax_cfg = parse_args(argv), jax_parse(argv)
    for f in ("remat", "fwd_dtype", "param_policy", "ema_decay", "ema_eval",
              "sentinel", "sentinel_spike", "sentinel_backoff",
              "sentinel_divergence", "sentinel_rollbacks", "distill",
              "distill_alpha", "amp", "grad_accum"):
        assert getattr(port, f) == getattr(jax_cfg, f), f


BAD = [
    dict(remat="some"), dict(fwd_dtype="int4"), dict(param_policy="fp16"),
    dict(param_policy="bf16-compute"),
    dict(param_policy="bf16-compute", amp=True, sub_divisions=2),
    dict(distill_alpha=0.0), dict(sentinel_spike=-1.0),
    dict(sentinel_backoff=0.0), dict(sentinel_backoff=1.5),
    dict(sentinel_divergence=0), dict(sentinel_rollbacks=-1),
]


@pytest.mark.parametrize("kw", BAD, ids=lambda k: ",".join(
    "%s=%s" % i for i in sorted(k.items())))
def test_extras_refused_like_jax(kw):
    with pytest.raises(ValueError) as jax_err:
        JaxConfig(**kw)
    with pytest.raises(ValueError) as port_err:
        Config(**kw)
    assert str(port_err.value) == str(jax_err.value)


def test_remat_bool_compatibility():
    for value, want in ((True, "stacks"), (False, "none")):
        assert Config(remat=value).remat == JaxConfig(remat=value).remat \
            == want
    assert dataclasses.replace(Config(), remat=True).remat == "stacks"
