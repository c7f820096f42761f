"""The port's command line against the JAX package's, flag by flag.

Walks every option string of JAX's `build_parser()` (ref
real_time_helmet_detection_tpu/config.py:615, with its reference-compat
aliases `--multiscale_flag` and `--scale_factor`, :636-640). Each one,
given a sample value (its JAX default; a typed value where the default
is None), either

* parses in the port to the same values of every `Config` field the two
  packages share, or
* is listed in NOT_PORTED: the port's parser rejects it (argparse exits
  2) or the port refuses the value (NotImplementedError).

A listed flag that the port has come to accept fails the test, so the
list only shrinks as the port grows.
"""

import dataclasses

import pytest

from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.config import build_parser as jax_parser
from real_time_helmet_detection_tpu.config import parse_args as jax_parse
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.config import parse_args

# JAX option strings the port does not take yet (ROADMAP.md §1): argparse
# rejects them, or the sample value raises NotImplementedError
NOT_PORTED = {
    # TPU / XLA switches and kernel-vs-composition choices
    "--platform", "--use-pallas", "--no-use-pallas", "--loss-kernel",
    "--epilogue", "--block-fuse",
    # --preset sweep-best reads the sweep that a benchmark writes: it
    # waits for the port's benchmark
    "--preset",
}
# the layer table and the profiler trace, ported with the train CLI
TRAIN_VIEW_FLAGS = ("--summary", "--no-summary", "--profile",
                    "--no-profile")

CASCADE_STREAM_FLAGS = (
    "--cascade", "--no-cascade", "--cascade-threshold", "--cascade-tiers",
    "--stream", "--no-stream", "--stream-threshold", "--stream-tile-grid",
    "--stream-ema", "--stream-track-radius")

# sample values of the flags whose JAX default is None
SAMPLES = {"data": "x", "imsize": "64", "model_load": "w.npz",
           "distill": "t.npz", "scale_factor": "4", "quant_scales": "s.json",
           "cascade_threshold": "0.5", "stream_threshold": "0.5"}


def jax_options():
    out = []
    for action in jax_parser()._actions:
        for opt in action.option_strings:
            if opt not in ("-h", "--help"):
                out.append((opt, action))
    return out


def sample_argv(opt, action):
    if action.nargs == 0:  # store_true, BooleanOptionalAction
        return [opt]
    if action.nargs == "+":
        return [opt] + [str(v) for v in action.default]
    if action.default is None:
        return [opt, SAMPLES[action.dest]]
    return [opt, str(action.default)]


def shared_fields():
    return sorted({f.name for f in dataclasses.fields(JaxConfig)}
                  & {f.name for f in dataclasses.fields(Config)})


def port_parses(argv):
    try:
        return parse_args(argv)
    except (SystemExit, NotImplementedError):
        return None


def assert_same_fields(port, jax_cfg, argv):
    for name in shared_fields():
        assert getattr(port, name) == getattr(jax_cfg, name), (argv, name)


@pytest.mark.parametrize("opt,action", jax_options(),
                         ids=[o for o, _ in jax_options()])
def test_every_jax_flag_parses_or_is_listed(opt, action, capsys):
    argv = sample_argv(opt, action)
    port = port_parses(argv)
    if opt in NOT_PORTED:
        assert port is None, "%s parses in the port now: take it off " \
            "NOT_PORTED" % opt
        return
    assert port is not None, "%s does not parse in the port: %s" % (
        opt, capsys.readouterr().err[-300:])
    assert_same_fields(port, jax_parse(argv), argv)


def test_not_ported_lists_only_jax_flags():
    assert NOT_PORTED <= {o for o, _ in jax_options()}


@pytest.mark.parametrize("argv", [
    ["--multiscale_flag"], ["--scale_factor", "4"],
    ["--sub-divisions", "3"], ["--grad-accum", "2"],
    ["--sub-divisions", "2", "--grad-accum", "4", "--batch-size", "8"],
    ["--world-size", "2", "--rank", "1"],
    ["--dist-url", "tcp://10.0.0.1:23456"], ["--dist-backend", "xla"],
    ["--num-devices", "1"], ["--num-devices", "0"], ["--spatial", "1"],
], ids=lambda a: " ".join(a))
def test_slice_flags_parse_like_jax(argv):
    """The flags of this slice and the reference aliases give the port
    the values JAX's parser gives."""
    port, jax_cfg = parse_args(argv), jax_parse(argv)
    assert_same_fields(port, jax_cfg, argv)
    for name in ("multiscale_flag", "scale_factor", "sub_divisions",
                 "grad_accum", "world_size", "rank", "dist_url",
                 "dist_backend", "num_devices", "spatial"):
        assert getattr(port, name) == getattr(jax_cfg, name), name


RUNTIME_FLAGS = (
    "--loader", "--device-prefetch", "--device-augment", "--cache-device",
    "--no-cache-device", "--ckpt-interval", "--keep-ckpt", "--async-ckpt",
    "--no-async-ckpt", "--auto-resume", "--resume-backoff-s",
    "--async-eval", "--no-async-eval", "--prewarm", "--no-prewarm",
    "--hang-warn-seconds", "--telemetry", "--no-telemetry", "--span-log",
    "--fault-inject")


def test_not_ported_is_the_tpu_switches_and_cascade_streams():
    """The training runtime's 20 option strings, the 10 cascade/stream
    ones and `--summary`/`--profile` with their negations are ported;
    what is left are the 6 TPU switches and `--preset`."""
    assert len(NOT_PORTED) == 7 and len(set(RUNTIME_FLAGS)) == 20
    assert len(set(CASCADE_STREAM_FLAGS)) == 10
    ported = set(RUNTIME_FLAGS) | set(CASCADE_STREAM_FLAGS) \
        | set(TRAIN_VIEW_FLAGS)
    assert not NOT_PORTED & ported
    assert ported <= {o for o, _ in jax_options()}


@pytest.mark.parametrize("argv", [[], ["--no-summary"], ["--summary"],
                                  ["--profile"], ["--no-profile"],
                                  ["--profile", "--no-summary"]],
                         ids=lambda a: " ".join(a) or "defaults")
def test_summary_and_profile_parse_like_jax(argv):
    port, jax_cfg = parse_args(argv), jax_parse(argv)
    assert (port.summary, port.profile) == (jax_cfg.summary,
                                            jax_cfg.profile)


@pytest.mark.parametrize("argv", [
    ["--cascade", "--cascade-threshold", "0.25"],
    ["--cascade", "--cascade-tiers", "throughput", "quality",
     "--cascade-threshold", "-1.5"],
    ["--no-cascade", "--cascade-tiers", "edge", "quality"],
    ["--stream", "--stream-threshold", "12.5", "--stream-tile-grid", "4",
     "--stream-ema", "0.25", "--stream-track-radius", "3.5"],
    ["--no-stream", "--stream-ema", "0.0"],
], ids=lambda a: " ".join(a))
def test_cascade_stream_flags_parse_like_jax(argv):
    """Every value of the cascade and stream options gives the port the
    shared fields JAX's parser gives."""
    port, jax_cfg = parse_args(argv), jax_parse(argv)
    assert_same_fields(port, jax_cfg, argv)
    for name in ("cascade", "cascade_threshold", "cascade_tiers", "stream",
                 "stream_threshold", "stream_tile_grid", "stream_ema",
                 "stream_track_radius"):
        assert getattr(port, name) == getattr(jax_cfg, name), name


@pytest.mark.parametrize("argv,match", [
    (["--cascade", "--cascade-tiers", "edge", "edge"], "two distinct"),
    (["--cascade", "--cascade-tiers", "edge", "fast"], "tier presets"),
    (["--cascade-threshold", "nan"], "finite"),
    (["--stream-threshold", "inf"], "finite"),
    (["--stream-tile-grid", "0"], ">= 1"),
    (["--stream-ema", "1.0"], r"\[0, 1\)"),
])
def test_cascade_stream_refusals_match_jax(argv, match):
    """The port refuses what JAX refuses, with JAX's message."""
    with pytest.raises(ValueError, match=match):
        jax_parse(argv)
    with pytest.raises(ValueError, match=match):
        parse_args(argv)


@pytest.mark.parametrize("argv", [
    ["--loader", "process", "--device-prefetch", "3"],
    ["--device-augment", "--cache-device", "--prewarm"],
    ["--ckpt-interval", "4", "--keep-ckpt", "2", "--async-ckpt"],
    ["--auto-resume", "3", "--resume-backoff-s", "0.5",
     "--fault-inject", "2:7"],
    ["--async-eval", "--hang-warn-seconds", "12.5"],
    ["--telemetry", "--span-log", "/tmp/spans.jsonl"],
], ids=lambda a: " ".join(a))
def test_runtime_flags_parse_like_jax(argv):
    port, jax_cfg = parse_args(argv), jax_parse(argv)
    assert_same_fields(port, jax_cfg, argv)


def test_slice_defaults_are_jax_defaults():
    port, jax_cfg = Config(), JaxConfig()
    for name in ("sub_divisions", "grad_accum", "world_size", "rank",
                 "dist_backend", "dist_url", "num_devices", "spatial"):
        assert getattr(port, name) == getattr(jax_cfg, name), name


def test_scale_factor_alias_reaches_the_must_be_4_check():
    """`--scale_factor 8` raises the port's own ValueError, as JAX's
    does, instead of argparse's exit 2."""
    with pytest.raises(ValueError, match="must be 4"):
        jax_parse(["--scale_factor", "8"])
    with pytest.raises(ValueError, match="must be 4"):
        parse_args(["--scale_factor", "8"])


@pytest.mark.parametrize("argv,match", [
    (["--num-devices", "2"], "--world-size"),
    (["--spatial", "2"], "more than one card"),
    (["--dist-backend", "mpi"], "--dist-backend"),
    (["--world-size", "2", "--rank", "2"], "--rank"),
])
def test_port_refusals(argv, match):
    """What one process per card cannot do is refused with a message
    that says what to run instead."""
    with pytest.raises((ValueError, NotImplementedError), match=match):
        parse_args(argv)
