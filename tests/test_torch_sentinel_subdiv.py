"""`--sentinel` with `--sub-divisions k` > 1: the port against the JAX
package on the CPU.

JAX's sentinel takes the whole train state back on a bad host step with
one select (ref train.py:331-357), `optax.MultiSteps`' `mini_step` and
`acc_grads` included (ref optim.py:140-142): a skipped micro-step
neither adds to the window's sum nor moves the window, and the update
falls on the k-th good micro-step; the epoch-end flush applies a partial
window (ref train.py:582 `make_state_accum_flush`, gated on
`mini_step > 0`). The port keeps the window on the device
(`train.make_gated_step`, `Sentinel.acc` / `.mini`) and gates the update
and the flush there.

Each case runs an epoch of n micro-steps (k does not divide n) with the
images of one micro-batch made NaN (or none), through JAX's sentinel
step over MultiSteps plus its flush and through the port's gated step
(its flush on the epoch's last step), from one init, with SGD so that
the summed gradient reads off the update. The tolerances are
tests/test_torch_accum.py's: losses rtol 1e-5 while the parameters are
the init's, 1e-4 after an update; the summed gradient rel L2 5e-3 (or
2.5x JAX's own fused-vs-xla disagreement); the running statistics rtol
1e-2 atol 2e-5. The skip flags, the number of updates (the flush's
included) and the schedule's count are equal.

The LR is tests/test_torch_train.py's three-step 1e-3, not
test_torch_accum.py's 1e-2: there every case has one update, here the
k = 3 epochs take two, and the second gradient is computed where the
first update put each package. At 1e-2 the sum of three gradients moves
the parameters far enough that the 1e-3 the two packages' first updates
differ by (JAX fused vs xla: the same) grows to 1.6e-2 by the second
update of the epoch (0, 2, 3 | 4), for plain `--sub-divisions 3` steps
and hand-rolled SGD steps alike, while the second gradient taken at the
same parameters agrees to 1.8e-3 (JAX's fused vs xla: 3.0e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu import optim as jax_optim
from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.train import (TrainState,
                                                  make_state_accum_flush,
                                                  make_train_step_body)
from real_time_helmet_detection_tpu_torch import convert
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.models.hourglass import build_model
from real_time_helmet_detection_tpu_torch.optim import (build_optimizer,
                                                        make_lr_schedule,
                                                        updates_per_epoch)
from real_time_helmet_detection_tpu_torch.train import (Sentinel,
                                                        init_train_state,
                                                        make_train_step,
                                                        train_epoch)

from test_torch_accum import (FUSED, STATS, XLA, batches, flat,  # noqa
                              init, jax_state, port_state, rel_l2)
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

LR = 1e-3
GRAD_REL_L2 = 5e-3
YARDSTICK = 2.5
# (k, n): an epoch of n micro-steps, k not dividing n
CASES = [(2, 3, None), (2, 3, 0), (2, 3, 1), (3, 5, 0), (3, 5, 1),
         (3, 5, 2)]


class JaxSide:
    """JAX's sentinel step over MultiSteps (jitted once per k and
    formulation) and its epoch-end flush."""

    bodies = {}

    def __init__(self, init, k, n, formulation):
        self.cfg = JaxConfig(num_stack=1, hourglass_inch=16, num_cls=2,
                             optim="SGD", lr=LR, sentinel=True,
                             sub_divisions=k, batch_size=4, **formulation)
        params, stats = init
        tx = jax_optim.build_optimizer(self.cfg, n)
        self.state = TrainState(step=jnp.zeros((), jnp.int32),
                                params=params, batch_stats=stats,
                                opt_state=tx.init(params))
        key = (k, n, formulation["epilogue"])
        if key not in self.bodies:
            self.bodies[key] = (
                jax.jit(make_train_step_body(jax_build(self.cfg), tx,
                                             self.cfg)),
                make_state_accum_flush(self.cfg, n))
        self.body, self.flush = self.bodies[key]

    def step(self, arrs):
        self.state, losses = self.body(self.state, *map(jnp.asarray, arrs),
                                       jnp.float32(1.0))
        return float(losses["total"]), float(losses["sentinel_bad"])

    def end_epoch(self):
        if int(self.state.opt_state.mini_step) > 0:  # JAX's host check
            self.state = self.flush(self.state)

    @property
    def updates(self):
        return int(self.state.opt_state.gradient_step)


class PortSide:
    def __init__(self, init, k, n):
        self.cfg = Config(device="cpu", num_stack=1, hourglass_inch=16,
                          optim="SGD", lr=LR, sentinel=True,
                          sub_divisions=k, batch_size=4)
        params, stats = init
        self.model = build_model(self.cfg).train()
        convert.load_into(self.model, {"params": params,
                                       "batch_stats": stats})
        opt = build_optimizer(self.cfg, self.model.parameters())
        self.sentinel = Sentinel(self.cfg, self.model, opt, None, "cpu")
        self.run = make_train_step(
            self.model, opt, make_lr_schedule(
                self.cfg, updates_per_epoch(self.cfg, n)), self.cfg,
            sentinel=self.sentinel)

    def step(self, arrs, last):
        out = self.run(0, *map(torch.from_numpy, arrs), update=last)
        return float(out["total"]), float(out["sentinel_bad"])


def summed_grad(state, p0):
    """The SGD updates' gradient sum from p0, one float64 vector."""
    return np.concatenate([
        ((np.asarray(state[k], np.float64) - p0[k]) / -LR).ravel()
        for k in sorted(p0)])


def poisoned(n, pos):
    out = batches(n)
    if pos is not None:
        img = np.full_like(out[pos][0], np.nan)
        out[pos] = (img,) + tuple(out[pos][1:])
    return out


@pytest.mark.parametrize("k,n,pos", CASES,
                         ids=["k%d_n%d_poison%s" % c for c in CASES])
def test_gated_window_matches_jax(init, k, n, pos):
    epoch = poisoned(n, pos)
    port = PortSide(init, k, n)
    jside = JaxSide(init, k, n, FUSED)
    updates = 0
    for i, arrs in enumerate(epoch):
        pl, pbad = port.step(arrs, last=i == n - 1)
        jl, jbad = jside.step(arrs)
        assert pbad == jbad == float(i == pos), (i, pbad, jbad)
        if pos != i:
            rtol = 1e-5 if updates == 0 else 1e-4
            np.testing.assert_allclose(pl, jl, rtol=rtol, err_msg=str(i))
        else:
            assert not np.isfinite(pl) and not np.isfinite(jl)
        updates = jside.updates
    jside.end_epoch()
    good = n - (pos is not None)
    want_updates = -(-good // k)  # full windows, then the flush's
    assert jside.updates == want_updates
    assert float(port.sentinel.count) == want_updates
    assert float(port.sentinel.mini) == 0.0
    assert all(float(a.abs().sum()) == 0.0 for a in port.sentinel.acc)
    got, want = port_state(port.model), jax_state(jside.state)
    p0 = {"params/" + name: v for name, v in flat(init[0]).items()}
    for key in want:
        if key.startswith("batch_stats/"):
            np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                       err_msg=key, **STATS)
    g, w = summed_grad(got, p0), summed_grad(want, p0)
    port_err = rel_l2(g, w)
    if port_err > GRAD_REL_L2:  # the yardstick: JAX's xla formulation
        jxla = JaxSide(init, k, n, XLA)
        for arrs in epoch:
            jxla.step(arrs)
        jxla.end_epoch()
        jax_err = rel_l2(summed_grad(jax_state(jxla.state), p0), w)
        assert port_err <= YARDSTICK * jax_err, (port_err, jax_err)


def test_skip_leaves_the_window_bit_equal():
    """Within the port: a poisoned micro-step changes no state tensor (the
    device window, the sum, the LR count among them), so an epoch with it
    ends bit-equal to the same epoch without it."""
    def run(epoch):
        cfg = Config(device="cpu", num_stack=1, hourglass_inch=16,
                     sentinel=True, sub_divisions=2, ema_decay=0.9, lr=1e-3)
        torch.manual_seed(0)
        model = build_model(cfg).train()
        opt, ema = init_train_state(cfg, model, torch.device("cpu"))
        sentinel = Sentinel(cfg, model, opt, ema, "cpu")
        step = make_train_step(model, opt, make_lr_schedule(cfg, 10), cfg,
                               ema=ema, sentinel=sentinel)
        for i, arrs in enumerate(epoch):
            step(0, *map(torch.from_numpy, arrs), update=i == len(epoch) - 1)
        return sentinel.tensors()

    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        synthetic_target_batch
    epoch = [synthetic_target_batch(2, 64, seed=s) for s in range(4)]
    bad = list(epoch)
    bad.insert(1, (np.full_like(epoch[1][0], np.nan),) + epoch[1][1:])
    a, b = run(bad), run(epoch)
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


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


def test_train_epoch_flags_only_the_epochs_end():
    """Under the gated window `train_epoch` passes `update` on the
    epoch's last step only (the flush request); its host count stays the
    schedule's."""
    from real_time_helmet_detection_tpu_torch.ops.loss import LossLog
    seen = []

    def step(count, *arrays, update):
        seen.append(update)
        return {key: torch.zeros(()) for key in LossLog.KEYS}

    cfg = Config(device="cpu", sentinel=True, sub_divisions=3,
                 print_interval=100)
    out = train_epoch(cfg, 0, _Loader(5), step, torch.device("cpu"),
                      LossLog(), 0, chief=False)
    assert seen == [False, False, False, False, True]
    assert out == 2
