"""The port's serving fields and latency tiers against the JAX package's
`Config`, and `--tier` through the CLI, on the CPU.

* the six `serve_*` fields have the JAX defaults, and the same bad values
  raise the same errors;
* `apply_tier` for edge and quality sets the same fields to the same
  values as JAX `apply_tier`, `tier_of` and `resolve_buckets` agree;
  `--tier throughput` raises NotImplementedError (int8 is not ported);
* `--tier edge` and `--tier quality` run eval through the serving engine,
  with the tier's buckets up to the batch size.
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

SERVE_FIELDS = ("serve_buckets", "serve_max_wait_ms", "serve_depth",
                "serve_queue", "serve_max_retries", "serve_hang_timeout_ms",
                "tier")
BAD = [("serve_buckets", []), ("serve_buckets", [0, 2]),
       ("serve_buckets", [4, -1]), ("serve_max_wait_ms", -1.0),
       ("serve_depth", 0), ("serve_queue", 0), ("serve_max_retries", -1),
       ("serve_hang_timeout_ms", -0.5), ("tier", "fast")]


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


@pytest.mark.parametrize("tier", ["edge", "quality"])
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
    assert config.TIER_PRESETS["throughput"] \
        == jax_config.TIER_PRESETS["throughput"]
    with pytest.raises(NotImplementedError, match="int8"):
        config.Config(tier="throughput")
    with pytest.raises(NotImplementedError, match="int8"):
        config.parse_args(["--tier", "throughput"])


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
