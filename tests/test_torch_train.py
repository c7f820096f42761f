"""The PyTorch port's train path against the JAX package, on the CPU.

The port is held against the JAX **fused** configuration
(`epilogue="fused", block_fuse="fused"`, with `loss_kernel="xla"` and with
`loss_kernel="fused"`, the JAX TPU default, whose Pallas loss kernels run
in interpret mode here): off the TPU its BN sites run the jnp twins of
the Pallas kernels, with the kernels' formulas. The port itself trains
with its fused loss. (The JAX package's fused and xla configurations disagree with
each other in train mode beyond their own pins — moment reassociation
amplified by every later BN, tests/test_epilogue.py:123-127 — so the
xla composition is not the reference here.)

* module level: `Convolution` and `Residual` in train mode, one call:
  output and the updated running statistics;
* loss: `stacked_detection_loss` value and gradient w.r.t. the raw
  output at 1 and 2 stacks, including a batch with no positives;
* data: `collate` of one synthetic VOC fixture at the same (seed, epoch,
  batch index): image, heatmap, offset, wh and mask;
* optimizer: Adam, AdamW and SGD with the MultiStep schedule, fed the
  same gradients for 5 updates across a milestone;
* the whole slice: one `loss_fn` + step from one JAX init carried across
  by the weight bridge, at imsize 128 (see SLICE_IMSIZE), batch 2, 1 and
  2 stacks: loss, grads, running statistics, and the losses of 3 steps;
* the CLI: `--train-flag --device cpu` for 2 epochs, then the eval CLI
  on the checkpoint; the default device raises without a card.

Every tolerance is stated at its pin with the maximum observed on this
CPU beside it.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu import optim as jax_optim
from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.data.pipeline import \
    collate as jax_collate
from real_time_helmet_detection_tpu.data.pipeline import \
    load_dataset as jax_load_dataset
from real_time_helmet_detection_tpu.data.pipeline import \
    seed_augmentor_for_batch as jax_seed_augmentor
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.models.hourglass import \
    Convolution as JaxConvolution
from real_time_helmet_detection_tpu.models.hourglass import \
    Residual as JaxResidual
from real_time_helmet_detection_tpu.ops.encode import \
    encode_boxes as jax_encode_boxes
from real_time_helmet_detection_tpu.ops.loss import \
    stacked_detection_loss as jax_stacked_loss
from real_time_helmet_detection_tpu.train import TrainState, init_variables
from real_time_helmet_detection_tpu.train import loss_fn as jax_loss_fn
from real_time_helmet_detection_tpu.train import make_train_step_body
from real_time_helmet_detection_tpu_torch import convert
from real_time_helmet_detection_tpu_torch.__main__ import main
from real_time_helmet_detection_tpu_torch.config import Config, parse_args
from real_time_helmet_detection_tpu_torch.data.pipeline import (
    collate, load_dataset, seed_augmentor_for_batch)
from real_time_helmet_detection_tpu_torch.data.synthetic import (
    make_synthetic_voc, synthetic_target_batch)
from real_time_helmet_detection_tpu_torch.models.hourglass import (
    Convolution, Residual, build_model)
from real_time_helmet_detection_tpu_torch.ops import epilogue, residual
from real_time_helmet_detection_tpu_torch.ops import loss as loss_ops
from real_time_helmet_detection_tpu_torch.ops.loss import \
    stacked_detection_loss
from real_time_helmet_detection_tpu_torch.optim import (build_optimizer,
                                                        make_lr_schedule,
                                                        set_lr)
from real_time_helmet_detection_tpu_torch.train import (loss_fn,
                                                        make_train_step)

FUSED = dict(epilogue="fused", block_fuse="fused", loss_kernel="xla")
# the JAX TPU default: the same with the Pallas loss kernels
FUSED_LOSS = dict(FUSED, loss_kernel="fused")
# The slice tests run at 128^2, not 64^2: at 64^2 the innermost hourglass
# level is 1x1, so its BatchNorms see batch-2 = 2 values per channel and
# normalize them to +-1 whatever they are; the gradient through them is
# rounding noise (measured: 83 of 118 parameter gradients off by up to 5%
# between the port and JAX, and between JAX's own fused and xla
# configurations alike). At 128^2 the bottom level has 8 values per
# channel and every gradient agrees within 4.7e-6.
SLICE_IMSIZE = 128


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch during each test: the suite runs
    several pytest workers on the CPU's cores, and torch's default of a
    thread per core in each of them oversubscribes the cores (a CLI test
    of small ops ran 30x slower so). The test files of the train path
    import this fixture."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_port(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW channels-last float32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def stats_of(module: torch.nn.Module) -> dict:
    """The running statistics as a flat flax-path dict."""
    tree = convert.state_dict_to_flax(module.state_dict())["batch_stats"]
    return convert.flatten_tree(tree)


def assert_close(got: dict, want: dict, rtol, atol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


# ------------------------------------------------------------ module level


@pytest.mark.parametrize("block", ["conv", "residual", "residual_proj"])
def test_modules_train_mode_match_flax(block):
    """One train-mode call of the port's module against the flax module
    under the fused config (same weights by the bridge): output atol =
    rtol 1e-5 (observed max abs 1.2e-6), running statistics 1e-5
    (observed 1.2e-7)."""
    rng = np.random.default_rng(5)
    in_ch = 16 if block != "residual_proj" else 8
    x = rng.normal(0, 1, (2, 8, 8, in_ch)).astype(np.float32)
    if block == "conv":
        jmod = JaxConvolution(16, 3, 1, use_bias=False, bn=True,
                              activation="Mish", epilogue="fused")
        port = Convolution(in_ch, 16, 3, 1, use_bias=False, bn=True,
                           activation="Mish")
    else:
        jmod = JaxResidual(16, activation="ReLU", epilogue="fused",
                           block_fuse="fused")
        port = Residual(in_ch, 16, "ReLU")
    variables = jax.jit(jmod.init, static_argnames=("train",))(
        jax.random.key(1), jnp.asarray(x), train=False)
    variables = jax.device_get(variables)
    # a non-trivial BN state, so the momentum update is visible
    flat = convert.flatten_tree(variables)
    for k, v in flat.items():
        if k.startswith("batch_stats"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith("scale"):
            flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    variables = convert.unflatten_tree(flat)
    want, mutated = jmod.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    convert.load_into(port, variables)
    port = port.to(memory_format=torch.channels_last).train()
    got = port(to_port(x).contiguous(memory_format=torch.channels_last))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert_close(stats_of(port), convert.flatten_tree(
        jax.device_get(mutated["batch_stats"])), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("positives", [True, False])
@pytest.mark.parametrize("ns", [1, 2])
def test_stacked_detection_loss_matches_jax(ns, positives):
    """Value rtol 1e-6 (observed 2.2e-7 relative) and the gradient w.r.t.
    the raw output atol = rtol 1e-6 (observed max abs 6.0e-8); the
    no-positive batch takes the clip(sum(mask), 1) branch."""
    rng = np.random.default_rng(ns)
    out = rng.normal(0, 2, (2, ns, 16, 16, 6)).astype(np.float32)
    heat, off, wh = (rng.uniform(0, 1, (2, 16, 16, c)).astype(np.float32)
                     for c in (2, 2, 2))
    mask = (rng.uniform(0, 1, (2, 16, 16, 1)) < 0.05).astype(np.float32)
    if not positives:
        mask[:] = 0.0
    kw = dict(num_cls=2, size_weight=0.1)

    def jtotal(o):
        return jax_stacked_loss(o, heat, off, wh, mask, **kw)["total"]

    jl = jax_stacked_loss(jnp.asarray(out), heat, off, wh, mask, **kw)
    jgrad = np.asarray(jax.grad(jtotal)(jnp.asarray(out)))
    ot = torch.from_numpy(out).requires_grad_(True)
    pl = stacked_detection_loss(ot, *(torch.from_numpy(a) for a in
                                      (heat, off, wh, mask)), **kw)
    pl["total"].backward()
    for k in ("hm", "offset", "size", "total"):
        np.testing.assert_allclose(pl[k].item(), float(jl[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(ot.grad.numpy(), jgrad, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------- data


def test_collate_matches_jax(tmp_path):
    """The same (seed, epoch, batch index) gives the same batch: images
    bit-equal; target maps equal to the JAX numpy encoder on the same
    augmented boxes (tolerance 0) and to the JAX collate, whose native
    C++ encoder this machine builds, within atol 1e-6 (observed 6.0e-8:
    the C++ Gaussian rounds apart)."""
    root = make_synthetic_voc(str(tmp_path / "voc"), num_train=6,
                              num_test=0, imsize=(160, 120), seed=3)
    kw = dict(data=root, train_flag=True, multiscale=[64, 128, 32],
              multiscale_flag=True, random_seed=11)
    jset, jaug = jax_load_dataset(JaxConfig(**kw))
    pset, paug = load_dataset(Config(device="cpu", **kw))
    idx = [4, 1, 5]
    for epoch, bi in ((0, 0), (3, 2)):
        jax_seed_augmentor(jaug, 11, epoch, bi)
        seed_augmentor_for_batch(paug, 11, epoch, bi)
        want = jax_collate([jset[i] for i in idx], jaug)
        got = collate([pset[i] for i in idx], paug)
        np.testing.assert_array_equal(got.image, want.image)
        for name in ("heatmap", "offset", "wh", "mask"):
            np.testing.assert_allclose(getattr(got, name),
                                       getattr(want, name), rtol=0,
                                       atol=1e-6, err_msg=name)
        # the JAX numpy encoder on the boxes the JAX augmentor produced
        jax_seed_augmentor(jaug, 11, epoch, bi)
        samples = [jset[i] for i in idx]
        imgs, boxes, labels = jaug([s[0] for s in samples],
                                   [s[1] for s in samples],
                                   [s[2] for s in samples])
        size = imgs[0].shape[0]
        for j, (b, lb) in enumerate(zip(boxes, labels)):
            maps = jax_encode_boxes(b, lb, (size, size))
            for name, m in zip(("heatmap", "offset", "wh", "mask"), maps):
                np.testing.assert_array_equal(getattr(got, name)[j], m,
                                              err_msg=name)


# -------------------------------------------------------------- optimizer


@pytest.mark.parametrize("name", ["Adam", "AdamW", "SGD"])
def test_optimizer_and_schedule_match_optax(name):
    """5 updates with the same gradients across the milestone boundary
    (steps_per_epoch 2, milestone 1: the LR drops at update count 2, so
    counts 1, 2, 3 straddle it): parameters rtol 1e-6, atol 1e-7
    (observed max abs 1.2e-7, 8% of the allowed error). The schedule
    itself is checked against optax's at every count (rtol 1e-6,
    observed 7e-8 relative)."""
    cfg = Config(device="cpu", optim=name, lr=0.05, lr_milestone=[1, 40],
                 lr_gamma=0.1)
    jcfg = JaxConfig(optim=name, lr=0.05, lr_milestone=[1, 40],
                     lr_gamma=0.1)
    sched = make_lr_schedule(cfg, 2)
    jsched = jax_optim.make_lr_schedule(jcfg, 2)
    for count in range(6):
        np.testing.assert_allclose(sched(count), float(jsched(count)),
                                   rtol=1e-6)
    assert sched(1) == 0.05 and sched(2) == pytest.approx(0.005)
    rng = np.random.default_rng(0)
    p0 = {"w": rng.normal(0, 1, (4, 3)).astype(np.float32),
          "b": rng.normal(0, 1, (3,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    tx = jax_optim.build_optimizer(jcfg, 2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = build_optimizer(cfg, list(tp.values()))
    for count, g in enumerate(grads):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        set_lr(opt, sched(count))
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7,
                                       err_msg="%s count %d" % (k, count))


# -------------------------------------------------------------- the slice


@pytest.fixture(scope="module", params=[1, 2])
def slice_pair(request):
    """The JAX fused model, its config and init variables, the port model
    loaded with the same variables, and 3 synthetic batches."""
    ns = request.param
    jcfg = JaxConfig(num_stack=ns, hourglass_inch=16, imsize=SLICE_IMSIZE,
                     batch_size=2, **FUSED)
    jmodel = jax_build(jcfg)
    params, stats = jax.device_get(init_variables(
        jmodel, jax.random.key(ns), SLICE_IMSIZE))
    batches = [synthetic_target_batch(2, SLICE_IMSIZE, seed=s)
               for s in range(3)]
    cfg = Config(device="cpu", num_stack=ns, hourglass_inch=16,
                 batch_size=2)
    return dict(ns=ns, jcfg=jcfg, jmodel=jmodel, params=params,
                stats=stats, batches=batches, cfg=cfg,
                model=build_model(cfg).train())


def jax_grads(jmodel, jcfg, params, stats, arrs):
    fn = jax.jit(lambda params, stats, *a: jax.value_and_grad(
        jax_loss_fn, has_aux=True)(params, stats, jmodel, *a, jcfg))
    (loss, (new_stats, _)), grads = fn(params, stats, *map(jnp.asarray, arrs))
    return float(loss), jax.device_get(new_stats), convert.flax_to_state_dict(
        {"params": jax.device_get(grads)})


@pytest.mark.parametrize("jax_cfg", [FUSED, FUSED_LOSS],
                         ids=["xla_loss", "fused_loss"])
def test_slice_loss_grads_and_stats_match_jax(slice_pair, jax_cfg):
    """One `loss_fn` + backward from the JAX init, against the JAX step
    with its XLA loss composition and with its Pallas loss kernels (the
    same pins for both): loss rtol 1e-5
    (observed 1.2e-6 relative against the Pallas loss, 9.7e-7 against
    the composition) and running statistics rtol 1e-2, atol 2e-5
    (observed max abs 1.3e-4, 2.3% of the allowed error).

    Gradients, 1 stack: every element within the JAX package's own
    fused-vs-xla pin, rtol 5e-3, atol 1e-4 (tests/test_epilogue.py:
    151-154; observed max abs 1.2e-5, 6% of the allowed error). 2
    stacks: the JAX package's two
    configurations themselves differ beyond that pin there (every later
    BN amplifies the moment reassociation), so the yardstick is their
    own disagreement: the port's largest element error is at most 2.5x
    the largest between JAX fused and JAX xla (observed 2.97e-3 against
    1.53e-3, both in the stem conv's kernel, 0.5% and 0.27% of its
    largest gradient: the port's CPU convolutions are oneDNN's, a
    rounding source the two JAX configurations share)."""
    p = slice_pair
    arrs = p["batches"][0]
    jcfg = dataclasses.replace(p["jcfg"], **jax_cfg)
    jl, jstats, want = jax_grads(p["jmodel"], jcfg, p["params"],
                                 p["stats"], arrs)
    model = p["model"]
    convert.load_into(model, {"params": p["params"],
                              "batch_stats": p["stats"]})
    model.zero_grad(set_to_none=True)
    total, _ = loss_fn(model, *map(torch.from_numpy, arrs), p["cfg"])
    total.backward()
    np.testing.assert_allclose(total.item(), jl, rtol=1e-5)
    assert_close(stats_of(model), convert.flatten_tree(jstats), rtol=1e-2,
                 atol=2e-5)
    got = {n: q.grad.numpy() for n, q in model.named_parameters()}
    assert sorted(got) == sorted(want)
    if p["ns"] == 1:
        for n in want:
            np.testing.assert_allclose(got[n], want[n].numpy(), rtol=5e-3,
                                       atol=1e-4, err_msg=n)
        return
    xcfg = dataclasses.replace(jcfg, epilogue="xla", block_fuse="xla")
    _, _, xla = jax_grads(jax_build(xcfg), xcfg, p["params"], p["stats"],
                          arrs)
    yardstick = max(float((xla[n] - want[n]).abs().max()) for n in want)
    worst = max(float(np.abs(got[n] - want[n].numpy()).max()) for n in want)
    assert worst <= 2.5 * yardstick, (worst, yardstick)


def test_slice_three_steps_match_jax(slice_pair):
    """Three steps on three batches through the JAX step body (ref
    train.py:442) and the port's `make_train_step`, from one init: each
    step's losses rtol 1e-4 (observed 3.3e-5 relative).

    The steps use SGD (momentum 0.9, lr 1e-3), whose update is
    proportional to the gradient. Adam's first updates are
    lr * g / (|g| + eps), about +-lr for every entry whatever its size,
    so entries whose gradient is rounding noise (the biases of the convs
    before a BN, betas whose sum cancels) take lr-sized steps in
    directions that differ between any two implementations: by the third
    Adam step the JAX package's own fused and xla configurations differ
    by 2.7e-3 at 2 stacks. Adam's arithmetic is held to optax on
    identical gradients in test_optimizer_and_schedule_match_optax."""
    p = slice_pair
    jcfg = dataclasses.replace(p["jcfg"], optim="SGD", lr=1e-3)
    cfg = dataclasses.replace(p["cfg"], optim="SGD", lr=1e-3)
    tx = jax_optim.build_optimizer(jcfg, 10)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=p["params"],
                       batch_stats=p["stats"],
                       opt_state=tx.init(p["params"]))
    body = jax.jit(make_train_step_body(p["jmodel"], tx, jcfg))
    model = p["model"]
    convert.load_into(model, {"params": p["params"],
                              "batch_stats": p["stats"]})
    step = make_train_step(model, build_optimizer(cfg, model.parameters()),
                           make_lr_schedule(cfg, 10), cfg)
    for count, arrs in enumerate(p["batches"]):
        state, jl = body(state, *map(jnp.asarray, arrs))
        pl = step(count, *map(torch.from_numpy, arrs))
        for k in ("hm", "offset", "size", "total"):
            np.testing.assert_allclose(float(pl[k]), float(jl[k]),
                                       rtol=1e-4,
                                       err_msg="step %d %s" % (count, k))


def test_flagship_train_step_launch_sites(monkeypatch):
    """One train step at the flagship width runs the BN passes at every
    site: 37 batch-moment passes, 20 epilogue and 17 residual-tail
    forwards, and 20 + 17 of each backward pass, and the fused loss once
    each way (the counts chip_smoke.py holds the CUDA launch counters
    to); on the CPU no counter moves."""
    calls = {}

    def counting(mod, name):
        real = getattr(mod, name)
        calls[name] = 0

        def wrapper(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    for name in ("bn_act", "bn_stats", "bn_bwd_sums", "bn_bwd_dx"):
        counting(epilogue, name)
    for name in ("bn_add_act", "bn_add_bwd_sums", "bn_add_bwd_dx"):
        counting(residual, name)
    for name in ("loss_sums", "loss_sums_bwd"):
        counting(loss_ops, name)
    cfg = Config(device="cpu", batch_size=1)  # 128 channels, 1 stack
    model = build_model(cfg).train()
    opt = build_optimizer(cfg, model.parameters())
    step = make_train_step(model, opt, make_lr_schedule(cfg, 1), cfg)
    before = (epilogue.stats_launches, epilogue.bwd_sums_launches,
              residual.bwd_dx_launches, epilogue.launches,
              loss_ops.fwd_launches, loss_ops.bwd_launches)
    step(0, *map(torch.from_numpy, synthetic_target_batch(1, 64)))
    assert calls == {"bn_act": 20, "bn_stats": 37, "bn_bwd_sums": 20,
                     "bn_bwd_dx": 20, "bn_add_act": 17,
                     "bn_add_bwd_sums": 17, "bn_add_bwd_dx": 17,
                     "loss_sums": 1, "loss_sums_bwd": 1}
    assert (epilogue.stats_launches, epilogue.bwd_sums_launches,
            residual.bwd_dx_launches, epilogue.launches,
            loss_ops.fwd_launches, loss_ops.bwd_launches) == before


@pytest.mark.parametrize("name", ["edge-arch", "quality-arch",
                                  "depthwise-128", "options"])
def test_variant_train_step_launch_sites(monkeypatch, name):
    """One train step of each of chip_smoke.py's configurations at 64^2
    runs the BN passes at every site of tests/test_torch_predict.py's
    VARIANT_SITES: a moment pass at each, each epilogue site's forward and
    backward sums and dx, each tail site's, the loss once each way (the
    counts chip_smoke.py's variants_train holds the launch counters to);
    no launch counter moves on the CPU."""
    from test_torch_predict import VARIANT_SITES, chip_smoke
    calls = {}

    def counting(mod, attr):
        real = getattr(mod, attr)
        calls[attr] = 0

        def wrapper(*args, **kw):
            calls[attr] += 1
            return real(*args, **kw)
        monkeypatch.setattr(mod, attr, wrapper)

    for attr in ("bn_act", "bn_stats", "bn_bwd_sums", "bn_bwd_dx"):
        counting(epilogue, attr)
    for attr in ("bn_add_act", "bn_add_bwd_sums", "bn_add_bwd_dx"):
        counting(residual, attr)
    for attr in ("loss_sums", "loss_sums_bwd"):
        counting(loss_ops, attr)
    cfg = Config(device="cpu", batch_size=1, imsize=64,
                 **chip_smoke.VARIANT_CONFIGS[name])
    model = build_model(cfg).train()
    step = make_train_step(model, build_optimizer(cfg, model.parameters()),
                           make_lr_schedule(cfg, 1), cfg)
    before = (epilogue.stats_launches, epilogue.bwd_sums_launches,
              residual.bwd_dx_launches, loss_ops.bwd_launches)
    losses = step(0, *map(torch.from_numpy, synthetic_target_batch(1, 64)))
    assert np.isfinite(float(losses["total"]))
    epi, tail = VARIANT_SITES[name]
    assert calls == {"bn_act": epi, "bn_stats": epi + tail,
                     "bn_bwd_sums": epi, "bn_bwd_dx": epi,
                     "bn_add_act": tail, "bn_add_bwd_sums": tail,
                     "bn_add_bwd_dx": tail, "loss_sums": 1,
                     "loss_sums_bwd": 1}
    want = chip_smoke.expected_launches(cfg, "train", torch.float32)
    assert {k: want[n] for k, n in (
        ("bn_stats", "bn_stats"), ("bn_bwd_dx", "bn_bwd_dx"),
        ("bn_add_bwd_dx", "bn_add_bwd_dx"), ("loss_sums_bwd", "loss_bwd"))} \
        == {"bn_stats": epi + tail, "bn_bwd_dx": epi, "bn_add_bwd_dx": tail,
            "loss_sums_bwd": 1}
    assert (epilogue.stats_launches, epilogue.bwd_sums_launches,
            residual.bwd_dx_launches, loss_ops.bwd_launches) == before


# -------------------------------------------------------------------- CLI


def test_cli_train_then_eval_on_cpu(tmp_path, capsys):
    """`--train-flag --device cpu` for 2 epochs on a synthetic fixture:
    the loss falls (the last epoch's mean total below the first's), one
    checkpoint per epoch beside the config snapshot (`argument.json`,
    `argument.txt`), and the eval CLI loads the written weights to a
    printed mAP; resuming from the checkpoint continues at epoch 2."""
    voc = make_synthetic_voc(str(tmp_path / "voc"), num_train=8,
                             num_test=2, seed=0)
    out = str(tmp_path / "w")
    common = ["--data", voc, "--device", "cpu", "--hourglass-inch", "16"]
    main(common + ["--train-flag", "--batch-size", "2", "--end-epoch", "2",
                   "--multiscale", "32", "64", "32", "--print-interval", "1",
                   "--lr", "2e-3", "--num-workers", "2",
                   "--save-path", out])
    from real_time_helmet_detection_tpu_torch.train import load_checkpoint
    ckpt = load_checkpoint(os.path.join(out, "check_point_2"))
    totals = ckpt["loss_log"]["total"]
    assert ckpt["epoch"] == 1 and ckpt["step"] == len(totals) == 8
    assert np.mean(totals[4:]) < np.mean(totals[:4])
    assert sorted(os.listdir(out)) == ["argument.json", "argument.txt",
                                       "check_point_1", "check_point_2",
                                       "training_log"]
    assert sorted(os.listdir(os.path.join(out, "training_log"))) == sorted(
        "e%d_i%d_%s.png" % (e, i, k) for e in range(2) for i in range(4)
        for k in ("gt", "pred"))
    capsys.readouterr()
    main(common + ["--imsize", "64", "--batch-size", "2", "--model-load",
                   os.path.join(out, "check_point_2", "weights.npz"),
                   "--save-path", str(tmp_path / "eval")])
    assert ": mAP " in capsys.readouterr().out
    main(common + ["--train-flag", "--batch-size", "2", "--end-epoch", "3",
                   "--multiscale", "32", "64", "32", "--num-workers", "2",
                   "--model-load", os.path.join(out, "check_point_2"),
                   "--save-path", out])
    assert "resumed from" in capsys.readouterr().out
    assert load_checkpoint(os.path.join(out, "check_point_3"))["step"] == 12


def test_cli_train_default_device_refuses_cpu_only_box(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    voc = make_synthetic_voc(str(tmp_path / "voc"), num_train=2,
                             num_test=0, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--train-flag", "--data", voc])


@pytest.mark.parametrize("flag", [
    "--sub-divisions=2", "--grad-accum=2", "--remat=full",
    "--param-policy=bf16-compute", "--ema-decay=0.99", "--sentinel",
    "--distill=t", "--device-augment", "--fwd-dtype=int8"])
def test_unported_train_options_raise(flag):
    """The train options the port once refused; every one is ported now
    (`--device-augment` last), keeps its case here and parses to its
    value (`--param-policy bf16-compute` with the `--amp` it requires, as
    in JAX)."""
    argv = ["--train-flag", "--data", "x", "--device", "cpu", flag]
    if flag == "--param-policy=bf16-compute":
        argv.append("--amp")
    name, _, value = flag[2:].partition("=")
    name = name.replace("-", "_")
    cfg = parse_args(argv)
    if not value:
        assert getattr(cfg, name) is True
        return
    want = {"int": int, "float": float}.get(
        type(getattr(Config(), name)).__name__, str)(value)
    assert getattr(cfg, name) == want


def test_cli_refuses_loss_kernel_flag(capsys):
    """The port has one loss path; `--loss-kernel` is not its flag."""
    with pytest.raises(SystemExit):
        parse_args(["--data", "x", "--loss-kernel=xla"])
    assert "unrecognized arguments" in capsys.readouterr().err


def test_state_dict_to_flax_round_trips(tmp_path):
    """The inverse bridge writes the npz the forward bridge reads back
    into an identical state dict."""
    model = build_model(Config(device="cpu", imsize=64, hourglass_inch=16,
                               num_stack=2))
    for i, t in enumerate(model.state_dict().values()):
        t.copy_(torch.arange(t.numel(), dtype=torch.float32).view(t.shape)
                + i)
    path = str(tmp_path / "w.npz")
    convert.save_npz(path, convert.state_dict_to_flax(model.state_dict()))
    back = convert.flax_to_state_dict(convert.load_npz(path))
    want = model.state_dict()
    assert sorted(back) == sorted(want)
    for k in want:
        assert torch.equal(back[k], want[k].contiguous()), k
