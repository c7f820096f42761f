"""The PyTorch port's detector and weight bridge against the JAX model.

JAX `model.init` (jitted, CPU) -> numpy -> `convert` ->
`load_state_dict(strict=True)`: every leaf round-trips, and eval-mode
logits agree with JAX `model.apply(train=False)` both under the XLA BN
composition (`--epilogue xla --block-fuse xla`, the CPU `auto`) and under
the fused jnp twins (`fused`/`fused`), for 1 and 2 stacks and for every
architecture option of the JAX model (VARIANT_CASES: the three variants,
the seven activations as `--activation` and as `--neck-activation`, the
five pools and the SPP neck pool, the s2d stem, `increase_ch`,
`stem_width`), whose weights the port seeds and the bridge carries to
flax (its tree must equal `jax.eval_shape` of the JAX init, leaf for
leaf). BatchNorm state is randomised so the fold algebra matters, with
scales in [0.2, 0.6] so the logits stay O(1) as a trained net's do (near
1 the random residual stream grows to |logit| ~ 1e3 and a fixed tolerance
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
from real_time_helmet_detection_tpu_torch.evaluate import init_weights
from real_time_helmet_detection_tpu_torch.models.hourglass import \
    build_model

ARCH = dict(imsize=64, hourglass_inch=32, num_cls=2)
# architecture options beside ARCH, each case against JAX in both BN
# modes; each of the seven activations is an --activation in one case
# and a --neck-activation in another
VARIANT_CASES = {
    "depthwise": dict(variant="depthwise"),
    "depthwise-mish": dict(variant="depthwise", activation="Mish",
                           neck_activation="LReLU"),
    "ghost": dict(variant="ghost"),
    "ghost-prelu-convpool-sppneck": dict(
        variant="ghost", activation="PReLU", neck_activation="Mish",
        pool="Conv", neck_pool="SPP"),
    "lrelu-avgpool": dict(activation="LReLU", neck_activation="Sigmoid",
                          pool="Avg"),
    "sigmoid-spppool": dict(activation="Sigmoid", neck_activation="CELU",
                            pool="SPP"),
    "celu-nopool": dict(activation="CELU", neck_activation="PReLU",
                        pool="None"),
    "linear-s2d": dict(activation="Linear", neck_activation="ReLU",
                       stem_s2d=True),
    "prelu-inc8-stem48-sppneck": dict(
        activation="PReLU", neck_activation="Linear", increase_ch=8,
        stem_width=48, neck_pool="SPP"),
}


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


def shape_tree(tree, prefix=""):
    """{"a/b/c": shape} of a nested tree of arrays or shape structs."""
    out = {}
    for k, v in tree.items():
        path = "%s/%s" % (prefix, k) if prefix else k
        if hasattr(v, "items"):
            out.update(shape_tree(v, path))
        else:
            out[path] = tuple(v.shape)
    return out


@pytest.fixture(scope="module")
def variant_cases():
    """{case: (port model with seeded weights and a random BN state and
    PReLU slopes, its flax tree, input images)}, built on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            cfg = Config(device="cpu", **ARCH, **VARIANT_CASES[case])
            model = init_weights(build_model(cfg), 11)
            tree = convert.state_dict_to_flax(model.state_dict())
            flat = convert.flatten_tree(randomize_bn(tree, seed=12))
            rng = np.random.default_rng(13)
            for k in flat:
                if k.endswith("negative_slope"):
                    flat[k] = np.float32(rng.uniform(0.1, 0.4))
            tree = convert.unflatten_tree(flat)
            convert.load_into(model, tree).eval()
            images = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
            cache[case] = (model, tree, images)
        return cache[case]
    return get


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
@pytest.mark.parametrize("ns", [1, 2] + list(VARIANT_CASES))
def test_eval_logits_match_jax(jax_stack, variant_cases, ns, mode):
    """`ns` is a stack count (JAX init) or a VARIANT_CASES name (port
    init, 1 stack). Observed max abs error over the variant cases 6.6e-6
    (ghost + PReLU), |logit| max 0.25-1.2."""
    if ns in (1, 2):
        variables, images = jax_stack[ns]
        jcfg = JaxConfig(num_stack=ns, epilogue=mode, block_fuse=mode,
                         **ARCH)
        model, floor = port_model(ns, variables), 1.0
    else:
        model, variables, images = variant_cases(ns)
        jcfg = JaxConfig(epilogue=mode, block_fuse=mode, **ARCH,
                         **VARIANT_CASES[ns])
        floor = 0.1
    jmodel = jax_build(jcfg)
    if ns not in (1, 2):  # the port's tree is the JAX model's, leaf for leaf
        abstract = jax.eval_shape(lambda: jmodel.init(
            jax.random.key(0), jnp.asarray(images), train=False))
        assert shape_tree({c: dict(abstract[c]) for c in abstract}) \
            == shape_tree(variables)
    want = np.asarray(jax.jit(jmodel.apply, static_argnames=("train",))(
        variables, jnp.asarray(images), train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(images)).numpy()
    stacks = ns if ns in (1, 2) else 1
    side = 32 if jcfg.pool in ("SPP", "None") else 16  # no 2x pool: H/2
    assert got.shape == want.shape == (2, stacks, side, side, 6)
    assert got.dtype == np.float32
    assert np.abs(want).max() > floor  # not a degenerate all-zero net
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_weight_bridge_round_trips_variant_leaves():
    """flax -> port -> flax for ghost + PReLU + Conv pool + SPP neck: the
    JAX init's every leaf comes back bit-equal under its own path; the
    depthwise kernels (HWIO (3, 3, 1, C) <-> OIHW (C, 1, 3, 3)) and the
    scalar PReLU slopes are checked by name."""
    arch = dict(ARCH, variant="ghost", activation="PReLU", pool="Conv",
                neck_pool="SPP")
    jmodel = jax_build(JaxConfig(**arch))
    variables = jax.device_get(jax.jit(jmodel.init, static_argnames=(
        "train",))(jax.random.key(3), jnp.zeros((1, 64, 64, 3)),
                   train=False))
    variables = {c: variables[c] for c in ("params", "batch_stats")}
    model = convert.load_into(build_model(Config(device="cpu", **arch)),
                              variables)
    back = convert.flatten_tree(convert.state_dict_to_flax(
        model.state_dict()))
    want = convert.flatten_tree(variables)
    assert sorted(back) == sorted(want)
    for k in want:
        assert back[k].shape == np.shape(want[k]), k
        np.testing.assert_array_equal(back[k], np.asarray(want[k]),
                                      err_msg=k)
    dw = ("params/Hourglass_0/Residual_0/GhostModule_0/Convolution_1/"
          "Conv_0/kernel")
    assert np.shape(want[dw]) == (3, 3, 1, 16)
    w = model.Hourglass_0.Residual_0.GhostModule_0.Convolution_1.Conv_0
    assert tuple(w.weight.shape) == (16, 1, 3, 3) and w.groups == 16
    np.testing.assert_array_equal(w.weight.detach().numpy(),
                                  np.asarray(want[dw]).transpose(3, 2, 0, 1))
    slopes = [k for k in want if k.endswith("/PReLU_0/negative_slope")]
    # the stem conv, then in each of the hourglass's 13 ghost blocks the
    # first ghost module's two convs and the post-add activation (the
    # PreLayer's and the neck's blocks are ReLU)
    assert ("params/Hourglass_0/Residual_0/Activation_0/PReLU_0/"
            "negative_slope") in slopes
    assert ("params/PreLayer_0/Convolution_0/Activation_0/PReLU_0/"
            "negative_slope") in slopes
    assert len(slopes) == 1 + 3 * 13
    for k in slopes:
        assert np.shape(want[k]) == () and back[k].shape == ()
        np.testing.assert_array_equal(back[k], np.float32(0.25))
    assert model.Hourglass_0.Residual_0.Activation_0.PReLU_0 \
        .negative_slope.shape == ()
    assert "params/Neck_0/Pool_0/SPP_0/Conv_1/kernel" in want
    assert "params/Hourglass_0/Pool_0/Conv_0/bias" in want


def test_spp_pools_equal_direct_pools():
    """The SPP's 9 x 9 and 13 x 13 pools, taken as 5 x 5 pools of the pool
    before, equal the direct pools bit for bit, ties, -inf and the
    borders included."""
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        spp_pools
    x = torch.from_numpy(np.round(np.random.default_rng(8).normal(
        0, 2, (2, 6, 19, 23)), 1).astype(np.float32))
    x[0, 0, :3] = -np.inf
    x = x.contiguous(memory_format=torch.channels_last)
    got = spp_pools(x)
    assert torch.equal(got[0], x)
    for k, g in zip((5, 9, 13), got[1:]):
        assert torch.equal(g, torch.nn.functional.max_pool2d(
            x, k, 1, (k - 1) // 2)), k


@pytest.mark.parametrize("change,error", [
    (dict(activation="GELU"), NotImplementedError),
    (dict(neck_pool="Max"), NotImplementedError),
    (dict(pool="Stride"), NotImplementedError),
    (dict(variant="inverted"), NotImplementedError),
    (dict(variant="ghost", hourglass_inch=33), ValueError),
    (dict(num_stack=0), NotImplementedError)])
def test_model_rejects_unported_architecture(change, error):
    """Values the JAX model does not build, or the port does not: an
    unknown activation, pool or variant, a neck pool other than None/SPP,
    no stack; a ghost model at an odd width is invalid (ref
    hourglass.py:585-588)."""
    cfg = dataclasses.replace(Config(device="cpu", **ARCH), **change)
    with pytest.raises(error):
        build_model(cfg)


@pytest.mark.parametrize("field,value", [
    ("fwd_dtype", "int8"), ("remat", "stacks")])
def test_config_rejects_unported_paths(field, value):
    """Both paths are ported now (they were refused before): the config
    takes the value and the model builds it — the int8 train forward at
    every BN'd, bias-free conv but the stem, the per-stack recompute —
    with the state dict of the plain model."""
    cfg = Config(device="cpu", **{field: value})
    assert getattr(cfg, field) == value
    model = build_model(cfg)
    plain = build_model(Config(device="cpu"))
    assert list(model.state_dict()) == list(plain.state_dict())
    if field == "fwd_dtype":
        from real_time_helmet_detection_tpu_torch.models.hourglass import \
            Convolution
        ste = [m.ste for m in model.modules() if isinstance(m, Convolution)]
        assert sum(ste) == 35 and not model.PreLayer_0.Convolution_0.ste
    else:
        assert model.remat == "stacks" and plain.remat == "none"


@pytest.mark.parametrize("flag", [
    "--no-use-pallas", "--infer-dtype=int8", "--epilogue=xla",
    "--block-fuse=xla"])
def test_cli_refuses_jax_only_path_flags(flag, capsys):
    """The port has one path per op, its kernel: the JAX CLI's switches to
    an XLA composition are not flags of the port's CLI. `--infer-dtype
    int8` is one (the int8 twin and its kernels) for eval and the demo;
    a train run takes it as JAX's does and trains the float model."""
    if flag == "--infer-dtype=int8":
        assert parse_args(["--data", "x", "--device", "cpu",
                           flag]).infer_dtype == "int8"
        cfg = parse_args(["--data", "x", "--device", "cpu", "--train-flag",
                          flag])
        assert (cfg.infer_dtype, cfg.train_flag) == ("int8", True)
        return
    with pytest.raises(SystemExit):
        parse_args(["--data", "x", "--device", "cpu", flag])
    assert "unrecognized arguments" in capsys.readouterr().err
