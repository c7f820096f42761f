"""The PyTorch port's gradient accumulation against the JAX package, on
the CPU: `--grad-accum k` (JAX `_make_accum_step_body`, ref
train.py:359), `--sub-divisions k` (`optax.MultiSteps` over `scale(k)`,
ref optim.py:120-142) with its epoch-end flush (ref train.py:582
`make_state_accum_flush`), their composition, and the schedule counted
in updates (ref optim.py:112 `_updates_per_epoch`).

Two kinds of pin, as the JAX package's own tests have them:

* accumulation against its un-accumulated equivalent in the same
  implementation — one `--grad-accum k` step against k hand-rolled
  micro-batch backward passes and one update on their summed gradients,
  one `--grad-accum 2` step against two `--sub-divisions 2` steps on its
  halves: parameters and running statistics rtol 1e-5, atol 1e-7 (JAX
  tests/test_train.py:180, :238; tests/test_scaleout.py:53);
* the port against JAX on the same weights (the bridge) and batches:
  losses rtol 1e-5 (observed at most 2.2e-6 relative); the summed
  gradient, read from the SGD update (p - p0) / -lr, within relative L2
  5e-3 over all parameters (chip_smoke.py's STEP_TOL for two BN
  formulations of one step; a mean for a sum would be 0.5), observed at
  most 9.5e-4; the running statistics within tests/test_torch_train.py's
  rtol 1e-2 atol 2e-5. The port and JAX take BN moments and sums in
  another f32 order, and every BN backward passes the difference on:
  one plain step at batch 4 here puts the stem kernel's gradient 7.7e-4
  apart (JAX's own fused and xla configurations 4.6e-4; a grad-accum 2
  step 2.4e-4 against JAX's own 4.3e-3) and the running variances up to
  5.9e-4, far above 1e-5: the tight pin holds within one package, not
  across the two.

The model is the 1-stack, width-16 hourglass in f32 at 128^2, not 64^2:
at 64^2 the innermost level is 1x1 and its BatchNorms see 2 values per
channel in a micro-batch of 2, which makes their gradient rounding noise
(tests/test_torch_train.py SLICE_IMSIZE). Every JAX step is JAX's
`make_train_step_body` in the fused configuration (`epilogue`,
`block_fuse` "fused"; the XLA loss), as in tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu import optim as jax_optim
from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.train import (TrainState, init_variables,
                                                  make_state_accum_flush,
                                                  make_train_step_body)
from real_time_helmet_detection_tpu_torch import convert
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.data.synthetic import \
    synthetic_target_batch
from real_time_helmet_detection_tpu_torch.models.hourglass import build_model
from real_time_helmet_detection_tpu_torch.optim import (build_optimizer,
                                                        make_lr_schedule,
                                                        set_lr,
                                                        updates_per_epoch)
from real_time_helmet_detection_tpu_torch.train import (loss_fn,
                                                        make_train_step,
                                                        train_epoch)
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

IMSIZE = 128
LR = 1e-2
FUSED = dict(epilogue="fused", block_fuse="fused", loss_kernel="xla")
XLA = dict(epilogue="xla", block_fuse="xla", loss_kernel="xla")
TIGHT = dict(rtol=1e-5, atol=1e-7)        # within one implementation
GRAD_REL_L2 = 5e-3                        # port vs JAX, summed gradient,
YARDSTICK = 2.5                           # or 2.5x JAX's own disagreement
STATS = dict(rtol=1e-2, atol=2e-5)        # port vs JAX, running stats


@pytest.fixture(scope="module")
def init():
    """One JAX init (params, batch_stats) of the tiny model."""
    jcfg = JaxConfig(num_stack=1, hourglass_inch=16, num_cls=2, **FUSED)
    params, stats = jax.device_get(init_variables(
        jax_build(jcfg), jax.random.key(0), IMSIZE))
    return params, stats


def batches(n, b=4):
    return [synthetic_target_batch(b, IMSIZE, seed=11 + i) for i in range(n)]


def flat(tree):
    return convert.flatten_tree(jax.device_get(tree))


def port_state(model):
    """{"params/...": ..., "batch_stats/...": ...} of the port's model."""
    return convert.flatten_tree(convert.state_dict_to_flax(model.state_dict()))


def jax_state(state):
    return flat({"params": state.params, "batch_stats": state.batch_stats})


class Jax:
    """JAX's step body (jitted) and TrainState for a config."""

    def __init__(self, init, steps_per_epoch=10, formulation=FUSED, **kw):
        self.cfg = JaxConfig(num_stack=1, hourglass_inch=16, num_cls=2,
                             optim="SGD", lr=LR, **formulation, **kw)
        params, stats = init
        tx = jax_optim.build_optimizer(self.cfg, steps_per_epoch)
        self.state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                batch_stats=stats,
                                opt_state=tx.init(params))
        self.body = jax.jit(make_train_step_body(
            jax_build(self.cfg), tx, self.cfg))
        self.flush = make_state_accum_flush(self.cfg, steps_per_epoch)

    def step(self, arrs):
        self.state, losses = self.body(self.state, *map(jnp.asarray, arrs))
        return float(losses["total"])


class Port:
    """The port's model from the same init, its optimizer and step."""

    def __init__(self, init, steps_per_epoch=10, optim="SGD", **kw):
        self.cfg = Config(device="cpu", num_stack=1, hourglass_inch=16,
                          optim=optim, lr=LR, **kw)
        params, stats = init
        self.model = build_model(self.cfg).train()
        convert.load_into(self.model, {"params": params,
                                       "batch_stats": stats})
        self.opt = build_optimizer(self.cfg, self.model.parameters())
        self.schedule = make_lr_schedule(
            self.cfg, updates_per_epoch(self.cfg, steps_per_epoch))
        self.run = make_train_step(self.model, self.opt, self.schedule,
                                   self.cfg)
        self.count = 0

    def step(self, arrs, update=True):
        losses = self.run(self.count, *map(torch.from_numpy, arrs),
                          update=update)
        self.count += update
        return float(losses["total"])


def assert_tree(got, want, keys=None, **tol):
    keys = sorted(want) if keys is None else keys
    assert sorted(got) == sorted(want)
    for k in keys:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), err_msg=k,
                                   **tol)


def summed_grad(state, p0):
    """The summed gradient of one SGD update from p0, as one float64
    vector in key order."""
    return np.concatenate([
        ((np.asarray(state[k], np.float64) - p0[k]) / -LR).ravel()
        for k in sorted(p0)])


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_matches_jax(port, jax_side, jax_xla, p0):
    """The port's state against JAX's: the summed gradient read from the
    SGD update(s) and the running statistics (see the module
    docstring)."""
    got, want = port_state(port.model), jax_state(jax_side.state)
    assert sorted(got) == sorted(want)
    for k in want:
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       err_msg=k, **STATS)
    g, w = summed_grad(got, p0), summed_grad(want, p0)
    x = summed_grad(jax_state(jax_xla.state), p0)
    port_err, jax_err = rel_l2(g, w), rel_l2(x, w)
    print("summed gradient rel L2: port vs JAX %.3g, JAX xla vs fused %.3g"
          % (port_err, jax_err))
    assert port_err <= max(GRAD_REL_L2, YARDSTICK * jax_err), \
        (port_err, jax_err)


def hand_rolled(init, micro_batches, **kw):
    """The reference semantics by hand: loss + backward of each
    micro-batch in turn (running statistics updating each time), the
    gradients summed, then one plain SGD update at the base LR. Returns
    (state, the micro-batches' mean loss)."""
    p = Port(init, **kw)
    p.model.zero_grad(set_to_none=True)
    totals = []
    for arrs in micro_batches:
        total, _ = loss_fn(p.model, *map(torch.from_numpy, arrs), p.cfg)
        total.backward()
        totals.append(total.item())
    set_lr(p.opt, LR)
    p.opt.step()
    return port_state(p.model), float(np.mean(totals))


def run_both(init, batch_list, flags, steps_per_epoch=10, flush=False,
             **kw):
    """The same host steps (update flags `flags`) through the port and
    JAX's step (fused and xla), from one init; JAX's epoch-end flush
    after them when `flush`. Losses: rtol 1e-5 while the parameters are
    the init's, 1e-4 after an update (tests/test_torch_train.py's
    three-step pin: the updates differ as the gradients do). Returns
    (port, JAX fused, JAX xla) and checks their states."""
    port = Port(init, steps_per_epoch, **kw)
    sides = [Jax(init, steps_per_epoch, formulation=f, **kw)
             for f in (FUSED, XLA)]
    for arrs, update in zip(batch_list, flags):
        pl = port.step(arrs, update=update)
        jl = [j.step(arrs) for j in sides][0]
        rtol = 1e-5 if port.count - update == 0 else 1e-4
        np.testing.assert_allclose(pl, jl, rtol=rtol)
    if flush:
        for j in sides:
            assert int(j.state.opt_state.mini_step) == 1
            j.state = j.flush(j.state)
    p0 = {"params/" + n: v for n, v in flat(init[0]).items()}
    if port.count:
        assert_matches_jax(port, *sides, p0)
    else:  # no update yet: the running statistics alone have moved
        got, want = port_state(port.model), jax_state(sides[0].state)
        assert_tree(got, want, keys=[k for k in want if k not in p0],
                    **STATS)
    return port, sides[0]


# -------------------------------------------------------------- grad-accum


@pytest.mark.parametrize("k", [2, 4])
def test_grad_accum_step_matches_jax(init, k):
    """One `--grad-accum k` step on a batch of 4: the loss (the
    micro-batches' mean) against JAX's `make_train_step` with
    `grad_accum=k`, its summed gradient and running statistics against
    JAX's; and the step against the hand-rolled k micro-batches, TIGHT."""
    (arrs,) = batches(1)
    port, _ = run_both(init, [arrs], [True], grad_accum=k, batch_size=4)
    rows = 4 // k
    want, mean_loss = hand_rolled(
        init, [tuple(a[i * rows:(i + 1) * rows] for a in arrs)
               for i in range(k)], batch_size=4)
    assert_tree(port_state(port.model), want, **TIGHT)
    np.testing.assert_allclose(Port(init, grad_accum=k, batch_size=4).step(
        arrs), mean_loss, rtol=1e-6)


def test_grad_accum_equals_sub_divisions(init):
    """THE accumulation convention (JAX tests/test_scaleout.py:53): one
    `--grad-accum 2` step on a batch of 4 and two `--sub-divisions 2`
    steps on its halves feed SGD the same summed gradient and update the
    running statistics in the same order: TIGHT."""
    (arrs,) = batches(1)
    a = Port(init, grad_accum=2, batch_size=4)
    a.step(arrs)
    b = Port(init, sub_divisions=2, batch_size=2)
    b.step(tuple(x[:2] for x in arrs), update=False)
    b.step(tuple(x[2:] for x in arrs), update=True)
    assert_tree(port_state(a.model), port_state(b.model), **TIGHT)


# ------------------------------------------------------------ sub-divisions


def test_sub_divisions_two_steps_match_jax(init):
    """`--sub-divisions 2` over 2 steps (JAX tests/test_train.py:127-145):
    after step 1 nothing has moved (params bit-equal to the init; the
    running statistics have), after step 2 the update applies the sum:
    against JAX's MultiSteps step, and TIGHT against the hand-rolled sum
    of the two batches' gradients."""
    b1, b2 = batches(2)
    port, j = run_both(init, [b1], [False], sub_divisions=2, batch_size=4)
    p0 = {"params/" + n: v for n, v in flat(init[0]).items()}
    got = port_state(port.model)
    for k in p0:
        np.testing.assert_array_equal(got[k], p0[k], err_msg=k)
    np.testing.assert_array_equal(jax.tree.leaves(j.state.params)[0],
                                  jax.tree.leaves(init[0])[0])
    port, _ = run_both(init, [b1, b2], [False, True], sub_divisions=2,
                       batch_size=4)
    assert port.count == 1
    want, _ = hand_rolled(init, [b1, b2], batch_size=4)
    assert_tree(port_state(port.model), want, **TIGHT)


def test_sub_divisions_epoch_flush_matches_jax(init):
    """Three steps at k = 2 in an epoch of 3 (JAX tests/test_train.py:
    183-217): an update after step 2 on the sum of two gradients, then the
    epoch's last step flushes its lone gradient (the reference's
    `iteration == len(dataloader)`); JAX applies it with
    `make_state_accum_flush`. SGD with momentum, so a missing flush or a
    mean for a sum both show; both updates are linear in the gradients,
    so the summed-gradient pin reads them together."""
    port, j = run_both(init, batches(3), [False, True, True],
                       steps_per_epoch=3, flush=True, sub_divisions=2,
                       batch_size=4)
    assert int(j.state.opt_state.gradient_step) == 2 and port.count == 2


def test_sub_divisions_times_grad_accum_matches_jax(init):
    """`--sub-divisions 2` x `--grad-accum 2`: two host steps of two
    micro-batches each, one update on the sum of four gradients, against
    JAX's composition; TIGHT against the hand-rolled four micro-batches."""
    b1, b2 = batches(2)
    port, _ = run_both(init, [b1, b2], [False, True], sub_divisions=2,
                       grad_accum=2, batch_size=4)
    micro = [tuple(a[r:r + 2] for a in b) for b in (b1, b2) for r in (0, 2)]
    want, _ = hand_rolled(init, micro, batch_size=4)
    assert_tree(port_state(port.model), want, **TIGHT)


# ----------------------------------------------------- schedule and flags


@pytest.mark.parametrize("name", ["Adam", "SGD"])
def test_milestone_inside_accumulating_epoch(name):
    """Two epochs of 3 steps at `--sub-divisions 2`, milestone 1: 2 updates
    an epoch (ceil(3 / 2), the flush making the second), so the LR drops
    at update 2, the first of epoch 2, in the middle of its steps. The
    same gradients through JAX's MultiSteps optimizer + its epoch-end
    flush and through the port's accumulation (p.grad summed, updates on
    `train_epoch`'s flags): parameters after every step rtol 1e-6 atol
    1e-7 (tests/test_torch_train.py's optimizer pin), the schedule equal
    to JAX's at every update, and Adam's bias-correction count 4."""
    kw = dict(optim=name, lr=0.05, lr_milestone=[1, 40], lr_gamma=0.1,
              sub_divisions=2)
    jcfg, cfg = JaxConfig(**kw), Config(device="cpu", **kw)
    spe = 3
    assert updates_per_epoch(cfg, spe) == \
        jax_optim._updates_per_epoch(jcfg, spe) == 2
    sched = make_lr_schedule(cfg, updates_per_epoch(cfg, spe))
    jsched = jax_optim.make_lr_schedule(
        jcfg, jax_optim._updates_per_epoch(jcfg, spe))
    for count in range(6):
        np.testing.assert_allclose(sched(count), float(jsched(count)),
                                   rtol=1e-6)
    assert sched(1) == 0.05 and sched(2) == pytest.approx(0.005)
    rng = np.random.default_rng(0)
    p0 = {"w": rng.normal(0, 1, (4, 3)).astype(np.float32),
          "b": rng.normal(0, 1, (3,)).astype(np.float32)}
    tx = jax_optim.build_optimizer(jcfg, spe)
    flush = jax.jit(jax_optim.make_accum_flush(jcfg, spe))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = build_optimizer(cfg, list(tp.values()))
    count = 0
    for epoch in range(2):
        for i in range(spe):
            g = {k: rng.normal(0, 1, v.shape).astype(np.float32)
                 for k, v in p0.items()}
            upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jp)
            jp = jax.tree.map(lambda p, u: p + u, jp, upd)
            if i == spe - 1:
                jp, jstate = flush(jp, jstate)
            for k, p in tp.items():
                gk = torch.from_numpy(g[k])
                p.grad = gk if p.grad is None else p.grad + gk
            if (i + 1) % 2 == 0 or i == spe - 1:
                set_lr(opt, sched(count))
                opt.step()
                opt.zero_grad(set_to_none=True)
                count += 1
            for k in p0:
                np.testing.assert_allclose(
                    tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                    atol=1e-7, err_msg="%s epoch %d step %d" % (k, epoch, i))
    assert count == 4
    if name == "Adam":
        assert opt.param_groups[0]["count"] == 4


class _Loader:
    def __init__(self, n):
        self.n = n

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return self.n

    def __iter__(self):
        from real_time_helmet_detection_tpu_torch.data.pipeline import Batch
        z = np.zeros((1, 1), np.float32)
        for _ in range(self.n):
            yield Batch(image=z, heatmap=z, offset=z, wh=z, mask=z,
                        infos=[])


@pytest.mark.parametrize("k,n,flags", [
    (1, 3, [1, 1, 1]), (2, 4, [0, 1, 0, 1]), (2, 3, [0, 1, 1]),
    (3, 7, [0, 0, 1, 0, 0, 1, 1]), (4, 2, [0, 1])])
def test_train_epoch_update_flags(k, n, flags):
    """`train_epoch` updates on every k-th step and on the epoch's last
    (ref train.py:124), and returns the update count."""
    from real_time_helmet_detection_tpu_torch.ops.loss import LossLog
    seen = []

    def step(count, *arrays, update):
        seen.append((count, update))
        return {key: torch.zeros(()) for key in LossLog.KEYS}

    cfg = Config(device="cpu", sub_divisions=k, print_interval=100)
    out = train_epoch(cfg, 0, _Loader(n), step, torch.device("cpu"),
                      LossLog(), 5, chief=False)
    assert [int(u) for _, u in seen] == flags
    assert out == 5 + sum(flags)
    assert [c for c, _ in seen] == [5 + sum(flags[:i]) for i in range(n)]


# ----------------------------------------------------------------- config


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, grad_accum=3), dict(batch_size=4, grad_accum=0),
    dict(amp=True, param_policy="bf16-compute", sub_divisions=2)])
def test_config_errors_match_jax(kw):
    """The accumulation refusals raise JAX's ValueError with its message
    (ref config.py:498-512)."""
    with pytest.raises(ValueError) as want:
        JaxConfig(**kw)
    with pytest.raises(ValueError) as got:
        Config(device="cpu", **kw)
    assert str(got.value) == str(want.value)
