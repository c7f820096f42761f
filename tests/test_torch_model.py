"""The PyTorch port's detector and weight bridge against the JAX model.

JAX `model.init` (jitted, CPU) -> numpy -> `convert` ->
`load_state_dict(strict=True)`: every leaf round-trips, and eval-mode
logits agree with JAX `model.apply(train=False)` both under the XLA BN
composition (`--epilogue xla --block-fuse xla`, the CPU `auto`) and under
the fused jnp twins (`fused`/`fused`), for 1 and 2 stacks. BatchNorm
state is randomised so the fold algebra matters, with scales in
[0.2, 0.6] so the logits stay O(1) as a trained net's do (near 1 the
random residual stream grows to |logit| ~ 1e3 and a fixed tolerance
would measure only that growth). Tolerance atol = rtol = 1e-4: conv sums
run in another order on the two sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu_torch import convert
from real_time_helmet_detection_tpu_torch.config import Config, parse_args
from real_time_helmet_detection_tpu_torch.models.hourglass import \
    build_model

ARCH = dict(imsize=64, hourglass_inch=32, num_cls=2)


def randomize_bn(variables, seed):
    """A copy of a flax variable tree with random BatchNorm state."""
    rng = np.random.default_rng(seed)
    flat = {}
    for coll in ("params", "batch_stats"):
        for path, v in convert.flatten_tree(variables[coll]).items():
            v = np.asarray(v)
            leaf = path.rsplit("/", 1)[-1]
            if "BatchNorm" in path:
                if leaf == "scale":
                    v = rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
                elif leaf == "var":
                    v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                else:  # bias, mean
                    v = rng.normal(0, 0.2, v.shape).astype(np.float32)
            flat["%s/%s" % (coll, path)] = v
    return convert.unflatten_tree(flat)


@pytest.fixture(scope="module")
def jax_stack():
    """{num_stack: (jax init vars with random BN, input images)}."""
    out = {}
    rng = np.random.default_rng(0)
    images = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    for ns in (1, 2):
        model = jax_build(JaxConfig(num_stack=ns, epilogue="xla",
                                    block_fuse="xla", **ARCH))
        variables = jax.jit(model.init, static_argnames=("train",))(
            jax.random.key(ns), jnp.asarray(images), train=False)
        out[ns] = (randomize_bn(jax.device_get(variables), seed=ns), images)
    return out


def port_model(ns, variables):
    model = build_model(Config(device="cpu", num_stack=ns, **ARCH))
    return convert.load_into(model, variables).eval()


@pytest.mark.parametrize("ns", [1, 2])
def test_weight_bridge_round_trips_every_leaf(jax_stack, ns, tmp_path):
    variables, _ = jax_stack[ns]
    path = str(tmp_path / "w.npz")
    convert.save_npz(path, variables)
    loaded = convert.load_npz(path)
    model = port_model(ns, loaded)
    state = model.state_dict()
    flat = {c: convert.flatten_tree(variables[c])
            for c in ("params", "batch_stats")}
    n_leaves = sum(len(f) for f in flat.values())
    assert len(state) == n_leaves  # strict load: nothing missing or extra
    names = {"kernel": "weight", "scale": "weight", "bias": "bias",
             "mean": "running_mean", "var": "running_var"}
    for coll, leaves in flat.items():
        for path, value in leaves.items():
            *mods, leaf = path.split("/")
            got = state[".".join(mods + [names[leaf]])].numpy()
            if leaf == "kernel":
                got = got.transpose(2, 3, 1, 0)  # OIHW -> HWIO
            np.testing.assert_array_equal(got, np.asarray(value))
    # conv weights sit in channels-last memory, as the kernels want
    w = model.PreLayer_0.Convolution_0.Conv_0.weight
    assert w.is_contiguous(memory_format=torch.channels_last)


def test_weight_bridge_refuses_foreign_leaves(jax_stack):
    variables, _ = jax_stack[1]
    bad = {"params": dict(variables["params"], Extra_0={"kernel": np.zeros(
        (1, 1, 2, 2), np.float32)}), "batch_stats": variables["batch_stats"]}
    with pytest.raises(RuntimeError, match="Extra_0"):
        port_model(1, bad)


@pytest.mark.parametrize("mode", ["xla", "fused"])
@pytest.mark.parametrize("ns", [1, 2])
def test_eval_logits_match_jax(jax_stack, ns, mode):
    variables, images = jax_stack[ns]
    jcfg = JaxConfig(num_stack=ns, epilogue=mode, block_fuse=mode, **ARCH)
    jmodel = jax_build(jcfg)
    want = np.asarray(jax.jit(jmodel.apply, static_argnames=("train",))(
        variables, jnp.asarray(images), train=False))
    model = port_model(ns, variables)
    with torch.inference_mode():
        got = model(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, ns, 16, 16, 6)
    assert got.dtype == np.float32
    assert np.abs(want).max() > 1.0  # not a degenerate all-zero net
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("field,value", [
    ("activation", "CELU"), ("neck_activation", "PReLU"), ("pool", "SPP"),
    ("neck_pool", "SPP"), ("variant", "ghost"), ("num_stack", 0)])
def test_model_rejects_unported_architecture(field, value):
    cfg = dataclasses.replace(Config(device="cpu", **ARCH), **{field: value})
    with pytest.raises(NotImplementedError):
        build_model(cfg)


@pytest.mark.parametrize("field,value", [
    ("nms", "soft-nms"), ("nms", "maxpool")])
def test_config_rejects_unported_paths(field, value):
    with pytest.raises(NotImplementedError):
        Config(**{field: value})


@pytest.mark.parametrize("flag", [
    "--no-use-pallas", "--infer-dtype=int8", "--epilogue=xla",
    "--block-fuse=xla"])
def test_cli_refuses_jax_only_path_flags(flag, capsys):
    """The port has one path per op, its kernel: the JAX CLI's switches to
    an XLA composition or int8 are not flags of the port's CLI."""
    with pytest.raises(SystemExit):
        parse_args(["--data", "x", "--device", "cpu", flag])
    assert "unrecognized arguments" in capsys.readouterr().err
