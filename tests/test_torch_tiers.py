"""The port's serving fields and latency tiers against the JAX package's
`Config`, and `--tier` through the CLI, on the CPU.

* the six `serve_*` fields have the JAX defaults, and the same bad values
  raise the same errors;
* `apply_tier` for edge, throughput and quality sets the same fields to
  the same values as JAX `apply_tier`, `tier_of` and `resolve_buckets`
  agree; the int8 fields (`infer_dtype`, `quant_scales`,
  `calib_batches`, `calib_percentile`) have the JAX defaults and
  validation; a train run takes `--tier throughput` and `--infer-dtype
  int8` as JAX's does: it trains the tier's float architecture (JAX's
  train never reads `infer_dtype`) — one step against JAX's at width 16
  and 64^2, and the train CLI's checkpoint evaluated at the tier;
* `--tier edge` and `--tier quality` run eval through the serving engine,
  with the tier's buckets up to the batch size;
* `--tier throughput` runs eval through the engine on the int8 twin,
  calibrating on the first eval batch: the scales artifact within rtol
  1e-6 of the JAX eval's, the mAP within 1e-3 of it on the same weights,
  and the demo self-calibrates on its image through the engine.
"""

import dataclasses
import os

import pytest

from real_time_helmet_detection_tpu import config as jax_config
from real_time_helmet_detection_tpu.serving import \
    resolve_buckets as jax_resolve_buckets
from real_time_helmet_detection_tpu_torch import config, evaluate
from real_time_helmet_detection_tpu_torch.__main__ import main
from real_time_helmet_detection_tpu_torch.data.synthetic import \
    make_synthetic_voc
from real_time_helmet_detection_tpu_torch.serving import (ServingEngine,
                                                          resolve_buckets)
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

SERVE_FIELDS = ("serve_buckets", "serve_max_wait_ms", "serve_depth",
                "serve_queue", "serve_max_retries", "serve_hang_timeout_ms",
                "tier")
INT8_FIELDS = ("infer_dtype", "quant_scales", "calib_batches",
               "calib_percentile")
BAD = [("serve_buckets", []), ("serve_buckets", [0, 2]),
       ("serve_buckets", [4, -1]), ("serve_max_wait_ms", -1.0),
       ("serve_depth", 0), ("serve_queue", 0), ("serve_max_retries", -1),
       ("serve_hang_timeout_ms", -0.5), ("tier", "fast")]
BAD_INT8 = [("infer_dtype", "int4"), ("calib_batches", 0),
            ("calib_percentile", 0.0), ("calib_percentile", 100.5)]


def test_serve_defaults_match_jax():
    ours, theirs = config.Config(), jax_config.Config()
    for name in SERVE_FIELDS:
        assert getattr(ours, name) == getattr(theirs, name), name
    names = {f.name: f.type for f in dataclasses.fields(config.Config)}
    jax_names = {f.name: f.type for f in dataclasses.fields(
        jax_config.Config)}
    for name in SERVE_FIELDS:
        assert names[name] == jax_names[name], name


@pytest.mark.parametrize("field,value", BAD,
                         ids=["%s=%r" % fv for fv in BAD])
def test_serve_validation_matches_jax(field, value):
    with pytest.raises(ValueError) as ours:
        config.Config(**{field: value})
    with pytest.raises(ValueError) as theirs:
        jax_config.Config(**{field: value})
    assert str(ours.value) == str(theirs.value)


def test_int8_defaults_match_jax():
    ours, theirs = config.Config(), jax_config.Config()
    names = {f.name: f.type for f in dataclasses.fields(config.Config)}
    jax_names = {f.name: f.type for f in dataclasses.fields(
        jax_config.Config)}
    for name in INT8_FIELDS:
        assert getattr(ours, name) == getattr(theirs, name), name
        assert names[name] == jax_names[name], name
    cfg = config.parse_args(["--infer-dtype", "int8", "--quant-scales",
                             "s.json", "--calib-batches", "2",
                             "--calib-percentile", "99.5"])
    assert (cfg.infer_dtype, cfg.quant_scales, cfg.calib_batches,
            cfg.calib_percentile) == ("int8", "s.json", 2, 99.5)


@pytest.mark.parametrize("field,value", BAD_INT8,
                         ids=["%s=%r" % fv for fv in BAD_INT8])
def test_int8_validation_matches_jax(field, value):
    with pytest.raises(ValueError) as ours:
        config.Config(**{field: value})
    with pytest.raises(ValueError) as theirs:
        jax_config.Config(**{field: value})
    assert str(ours.value) == str(theirs.value)


def test_int8_refused_for_training():
    """(The refusal is lifted.) `--infer-dtype int8 --train-flag` parses
    to JAX's fields, and the model training builds from it is the float
    one: no int8 module, the float model's parameters."""
    from real_time_helmet_detection_tpu_torch.models.hourglass import (
        QuantConv, build_model)
    argv = ["--infer-dtype", "int8", "--train-flag"]
    ours, theirs = config.parse_args(argv), jax_config.parse_args(argv)
    assert (ours.infer_dtype, ours.train_flag) == ("int8", True)
    for name in INT8_FIELDS + ("train_flag",):
        assert getattr(ours, name) == getattr(theirs, name), name
    model = build_model(ours)
    float_model = build_model(config.Config())
    assert not any(isinstance(m, QuantConv) for m in model.modules())
    assert [p.shape for p in model.parameters()] \
        == [p.shape for p in float_model.parameters()]


@pytest.mark.parametrize("tier", ["edge", "quality", "throughput"])
def test_apply_tier_matches_jax(tier):
    ours = config.apply_tier(config.Config(tier=tier, hourglass_inch=32,
                                           serve_buckets=[8]))
    theirs = jax_config.apply_tier(jax_config.Config(
        tier=tier, hourglass_inch=32, serve_buckets=[8]))
    assert config.TIER_PRESETS[tier] == jax_config.TIER_PRESETS[tier]
    shared = ({f.name for f in dataclasses.fields(config.Config)}
              & {f.name for f in dataclasses.fields(jax_config.Config)})
    for name in sorted(shared):
        assert getattr(ours, name) == getattr(theirs, name), name
    for name, value in config.TIER_PRESETS[tier].items():
        assert getattr(ours, name) == value
    assert config.tier_of(ours) == jax_config.tier_of(theirs) == tier
    assert resolve_buckets(ours) == jax_resolve_buckets(theirs)
    assert config.apply_tier(config.Config()) == config.Config()


def test_tier_of_other_architectures_matches_jax():
    for kw in ({}, dict(hourglass_inch=64), dict(variant="depthwise"),
               dict(num_stack=2)):
        assert config.tier_of(config.Config(**kw)) \
            == jax_config.tier_of(jax_config.Config(**kw))


def test_throughput_tier_is_refused():
    """(The refusal is lifted.) `--tier throughput --train-flag` trains
    the tier's float ghost architecture as JAX's does: the preset's
    fields equal JAX's, and one train step of it (at width 16, stem 16 and
    64^2) from one JAX init through the port's `make_train_step` and
    JAX's step body gives tests/test_torch_train.py's step pins: losses
    rtol 1e-5 on the first step, 1e-4 on the second (after an SGD
    update), the running statistics rtol 1e-2 atol 2e-5."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from real_time_helmet_detection_tpu import optim as jax_optim
    from real_time_helmet_detection_tpu.models import \
        build_model as jax_build
    from real_time_helmet_detection_tpu.train import (
        TrainState, init_variables, make_train_step_body)
    from real_time_helmet_detection_tpu_torch import convert
    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        synthetic_target_batch
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        build_model
    from real_time_helmet_detection_tpu_torch.optim import (
        build_optimizer, make_lr_schedule)
    from real_time_helmet_detection_tpu_torch.train import make_train_step
    assert config.TIER_PRESETS["throughput"] \
        == jax_config.TIER_PRESETS["throughput"]
    small = dict(hourglass_inch=16, stem_width=16, batch_size=2,
                 optim="SGD", lr=1e-3)
    ours = dataclasses.replace(config.apply_tier(config.parse_args(
        ["--tier", "throughput", "--train-flag"])), **small)
    theirs = dataclasses.replace(jax_config.apply_tier(jax_config.parse_args(
        ["--tier", "throughput", "--train-flag"])), epilogue="fused",
        block_fuse="fused", loss_kernel="xla", **small)
    for name in ("variant", "num_stack", "increase_ch", "infer_dtype",
                 "train_flag"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert (ours.variant, ours.infer_dtype) == ("ghost", "int8")
    jmodel = jax_build(theirs)
    params, stats = jax.device_get(init_variables(jmodel, jax.random.key(3),
                                                  64))
    tx = jax_optim.build_optimizer(theirs, 10)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params))
    body = jax.jit(make_train_step_body(jmodel, tx, theirs))
    ours = dataclasses.replace(ours, device="cpu")
    model = build_model(ours).train()
    convert.load_into(model, {"params": params, "batch_stats": stats})
    step = make_train_step(model, build_optimizer(ours, model.parameters()),
                           make_lr_schedule(ours, 10), ours)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for count, seed in enumerate((0, 1)):
            arrs = synthetic_target_batch(2, 64, seed=seed)
            state, jl = body(state, *map(jnp.asarray, arrs))
            pl = step(count, *map(torch.from_numpy, arrs))
            np.testing.assert_allclose(float(pl["total"]),
                                       float(jl["total"]),
                                       rtol=1e-5 if count == 0 else 1e-4)
    finally:
        torch.set_num_threads(threads)
    got = convert.flatten_tree(convert.state_dict_to_flax(
        model.state_dict())["batch_stats"])
    want = convert.flatten_tree(jax.device_get(state.batch_stats))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-2,
                                   atol=2e-5, err_msg=k)


def test_cli_throughput_tier_trains_then_evaluates(tmp_path, capsys):
    """The train CLI under `--tier throughput` writes a checkpoint of the
    float ghost-96 model (its snapshot says int8 inference), the eval CLI
    at the tier evaluates it through the int8 twin with no conversion
    step, and `--distill` trains a tier student from it."""
    root = make_synthetic_voc(str(tmp_path / "voc"), num_train=4,
                              num_test=2, imsize=(96, 72), seed=4)
    save = str(tmp_path / "w")
    main(["--train-flag", "--tier", "throughput", "--device", "cpu",
          "--data", root, "--batch-size", "2", "--end-epoch", "1",
          "--multiscale", "32", "64", "32", "--num-workers", "0",
          "--no-summary", "--save-path", save])
    snap = config.load_config(os.path.join(save, "argument.json"))
    assert (snap.variant, snap.hourglass_inch, snap.stem_width) \
        == ("ghost", 96, 96)
    assert os.path.isfile(os.path.join(save, "check_point_1",
                                       "weights.npz"))
    capsys.readouterr()
    main(["--tier", "throughput", "--device", "cpu", "--data", root,
          "--imsize", "64", "--batch-size", "2", "--model-load", save,
          "--save-path", str(tmp_path / "eval")])
    out = capsys.readouterr().out
    assert "int8 calibration" in out and ": mAP " in out
    assert os.path.isfile(os.path.join(str(tmp_path / "eval"),
                                       "calibration", "quant_scales.json"))
    # a tier student distilled from a teacher checkpoint (JAX's --distill
    # into the throughput tier): the soft loss joins every step's total
    # beyond the hard losses' weighted sum
    import torch
    main(["--train-flag", "--tier", "throughput", "--device", "cpu",
          "--data", root, "--batch-size", "2", "--end-epoch", "1",
          "--multiscale", "32", "64", "32", "--num-workers", "0",
          "--no-summary", "--distill", save, "--save-path",
          str(tmp_path / "student")])
    log = torch.load(os.path.join(str(tmp_path / "student"), "check_point_1",
                                  "checkpoint.pt"), map_location="cpu",
                     weights_only=False)["loss_log"]
    c = config.Config()
    soft = [t - (h * c.hm_weight + o * c.offset_weight + z * c.size_weight)
            for t, h, o, z in zip(log["total"], log["hm"], log["offset"],
                                  log["size"])]
    assert len(soft) == 2 and all(v > 1e-3 for v in soft), soft


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    return make_synthetic_voc(str(root), num_train=0, num_test=3,
                              imsize=(96, 72), seed=2)


@pytest.mark.parametrize("tier,buckets", [("edge", (1, 2)),
                                          ("quality", (1, 2))])
def test_cli_tier_evaluates_through_the_engine(voc, tmp_path, capsys,
                                               monkeypatch, tier, buckets):
    engines = []

    class Recording(ServingEngine):
        def __init__(self, predict, *args, **kw):
            super().__init__(predict, *args, **kw)
            engines.append((self, predict.model))
    monkeypatch.setattr(evaluate, "ServingEngine", Recording)
    out = str(tmp_path / "out")
    main(["--data", voc, "--imsize", "64", "--batch-size", "2",
          "--tier", tier, "--hourglass-inch", "8", "--device", "cpu",
          "--save-path", out])
    printed = capsys.readouterr().out
    assert "--tier %s:" % tier in printed and ": mAP " in printed
    assert len(engines) == 1
    engine, model = engines[0]
    assert engine.buckets == buckets
    st = engine.stats()
    assert st["completed"] == 3 and st["bucket_builds"] == len(buckets)
    assert len(os.listdir(os.path.join(out, "results", "txt"))) == 3
    # the preset's architecture won over --hourglass-inch 8
    preset = config.TIER_PRESETS[tier]
    assert model.num_stack == preset["num_stack"]
    assert any(getattr(m, "out_channels", None) == preset["hourglass_inch"]
               for m in model.modules())
    assert not any(getattr(m, "out_channels", None) == 8
                   for m in model.modules())


def test_cli_throughput_tier_evaluates_int8_through_the_engine(
        voc, tmp_path, capsys, monkeypatch):
    """JAX `evaluate` and the port's CLI at `--tier throughput` on the same
    fixture and weights (the JAX init through the npz bridge): each
    calibrates on its first eval batch and predicts with the int8 twin
    through its engine; the scales within rtol 1e-6, the mAP within
    1e-3."""
    import jax
    import numpy as np

    from real_time_helmet_detection_tpu.evaluate import \
        evaluate as jax_evaluate
    from real_time_helmet_detection_tpu.evaluate import \
        load_eval_state as jax_load_eval_state
    from real_time_helmet_detection_tpu_torch import convert
    from real_time_helmet_detection_tpu_torch.ops.quant import load_scales
    engines = []

    class Recording(ServingEngine):
        def __init__(self, predict, *args, **kw):
            super().__init__(predict, *args, **kw)
            engines.append((self, predict))
    monkeypatch.setattr(evaluate, "ServingEngine", Recording)
    common = dict(data=voc, imsize=64, batch_size=4, calib_batches=1,
                  random_seed=7)
    jcfg = jax_config.apply_tier(jax_config.Config(
        tier="throughput", save_path=str(tmp_path / "jax"), num_workers=1,
        **common))
    jm = jax_evaluate(jcfg)
    _, variables = jax_load_eval_state(jcfg)
    npz = str(tmp_path / "w.npz")
    convert.save_npz(npz, jax.device_get(variables))
    out = str(tmp_path / "out")
    main(["--data", voc, "--imsize", "64", "--batch-size", "4",
          "--calib-batches", "1", "--tier", "throughput", "--model-load",
          npz, "--device", "cpu", "--save-path", out])
    printed = capsys.readouterr().out
    assert "int8 calibration (1 batches" in printed and ": mAP " in printed
    (engine, predict), = engines
    assert predict.int8 and engine.buckets == (4,)
    assert engine.stats()["completed"] == 3
    assert len(os.listdir(os.path.join(out, "results", "txt"))) == 3
    ours = convert.flatten_tree(load_scales(
        os.path.join(out, "calibration", "quant_scales.json")))
    theirs = convert.flatten_tree(load_scales(
        os.path.join(str(tmp_path / "jax"), "calibration",
                     "quant_scales.json")))
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-6)
    served = float(printed.split(": mAP ", 1)[1].split()[0])
    assert abs(served - jm["map"]) <= 1e-3


def test_cli_throughput_tier_demo_self_calibrates(tmp_path, capsys,
                                                  monkeypatch):
    import numpy as np
    from PIL import Image
    engines = []

    class Recording(ServingEngine):
        def __init__(self, predict, *args, **kw):
            super().__init__(predict, *args, **kw)
            engines.append((self, predict))
    monkeypatch.setattr(evaluate, "ServingEngine", Recording)
    img = str(tmp_path / "x.jpg")
    Image.fromarray(np.random.default_rng(0).integers(
        0, 256, (72, 96, 3), dtype=np.uint8)).save(img)
    out = str(tmp_path / "demo")
    main(["--data", img, "--imsize", "64", "--tier", "throughput",
          "--device", "cpu", "--save-path", out])
    (engine, predict), = engines
    assert predict.int8 and engine.buckets == (1,)
    assert engine.stats()["completed"] == 1
    assert os.path.exists(os.path.join(out, "image.png"))
