"""`--telemetry` and the flight recorder of the port's train loop, on the
CPU.

* The step's gradient, update and parameter norms against the JAX
  package's (`obs/telemetry.py` `telemetry_scalars` inside its step body)
  from one init on one batch, at the train-step parity tolerances of
  tests/test_torch_train.py (one SGD step from the same weights): the
  gradient and update norms rtol 1e-3 (observed 2.0e-4: one step's
  gradients of the two packages differ within the JAX package's own
  fused-vs-xla pin, rtol 5e-3 elementwise), the parameter norm rtol
  1e-6; and against the norms recomputed from the state
  before and after the step, rtol 1e-5.
* A CPU train CLI run with the host-side runtime flags (`--loader
  process --device-prefetch 2 --async-ckpt --keep-ckpt 1
  --ckpt-interval 1 --telemetry --span-log`) has the losses and the
  weights of the same run without them, bit for bit, and its loss log
  carries the norms.
* Its span log holds the JAX flight recorder's names (`loader-wait`,
  `h2d`, `step`, `fetch`, `checkpoint`, `context`, each step under its
  `step-train-e<E>-i<N>` trace), and the `train.*` metrics count.
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
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.train import (TrainState, init_variables,
                                                  make_train_step_body)
from real_time_helmet_detection_tpu_torch import convert
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.data.synthetic import (
    make_synthetic_voc, synthetic_target_batch)
from real_time_helmet_detection_tpu_torch.models.hourglass import \
    build_model
from real_time_helmet_detection_tpu_torch.obs.metrics import \
    default_registry
from real_time_helmet_detection_tpu_torch.obs.spans import read_spans
from real_time_helmet_detection_tpu_torch.obs.telemetry import NORM_KEYS
from real_time_helmet_detection_tpu_torch.optim import (build_optimizer,
                                                        make_lr_schedule)
from real_time_helmet_detection_tpu_torch.train import (load_checkpoint,
                                                        make_train_step)

from test_torch_runtime import assert_weights_equal, train_cli
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

IMSIZE = 128  # see test_torch_train.SLICE_IMSIZE
FUSED = dict(epilogue="fused", block_fuse="fused", loss_kernel="xla")


def test_step_norms_match_jax():
    jcfg = JaxConfig(hourglass_inch=16, imsize=IMSIZE, batch_size=2,
                     optim="SGD", lr=1e-3, telemetry=True, **FUSED)
    jmodel = jax_build(jcfg)
    params, stats = jax.device_get(init_variables(jmodel, jax.random.key(0),
                                                  IMSIZE))
    arrs = synthetic_target_batch(2, IMSIZE, seed=0)
    tx = jax_optim.build_optimizer(jcfg, 10)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params))
    _, jl = jax.jit(make_train_step_body(jmodel, tx, jcfg))(
        state, *map(jnp.asarray, arrs))
    cfg = Config(device="cpu", hourglass_inch=16, batch_size=2,
                 optim="SGD", lr=1e-3, telemetry=True)
    model = build_model(cfg).train()
    convert.load_into(model, {"params": params, "batch_stats": stats})
    before = [p.detach().clone() for p in model.parameters()]
    step = make_train_step(model, build_optimizer(cfg, model.parameters()),
                           make_lr_schedule(cfg, 10), cfg)
    pl = step(0, *map(torch.from_numpy, arrs))
    for k in ("grad_norm", "update_norm"):
        np.testing.assert_allclose(float(pl[k]), float(jl[k]), rtol=1e-3,
                                   err_msg=k)
    np.testing.assert_allclose(float(pl["param_norm"]),
                               float(jl["param_norm"]), rtol=1e-6)
    after = [p.detach() for p in model.parameters()]
    norm = lambda ts: float(torch.sqrt(sum(  # noqa: E731
        (t.double() ** 2).sum() for t in ts)))
    want = {"grad_norm": norm([p.grad for p in model.parameters()]),
            "update_norm": norm([a - b for a, b in zip(after, before)]),
            "param_norm": norm(after)}
    for k in NORM_KEYS:
        np.testing.assert_allclose(float(pl[k]), want[k], rtol=1e-5,
                                   err_msg=k)
    # off: the losses dict is the plain step's
    plain = make_train_step(model, build_optimizer(cfg, model.parameters()),
                            make_lr_schedule(cfg, 10),
                            dataclasses.replace(cfg, telemetry=False))
    assert not set(NORM_KEYS) & set(plain(0, *map(torch.from_numpy, arrs)))


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    return make_synthetic_voc(str(tmp_path_factory.mktemp("voc")),
                              num_train=8, num_test=2, seed=0)


def test_host_runtime_flags_leave_the_run_bit_equal(voc, tmp_path):
    reg = default_registry()
    steps0 = reg.counter("train.steps").value
    plain, flagged = str(tmp_path / "plain"), str(tmp_path / "flags")
    spans = str(tmp_path / "spans.jsonl")
    train_cli(voc, plain)
    train_cli(voc, flagged, "--loader", "process", "--device-prefetch", "2",
              "--async-ckpt", "--keep-ckpt", "1", "--ckpt-interval", "1",
              "--telemetry", "--span-log", spans)
    for ck in ("check_point_1", "check_point_2"):
        assert_weights_equal(os.path.join(plain, ck, "weights.npz"),
                             os.path.join(flagged, ck, "weights.npz"))
    a = load_checkpoint(os.path.join(plain, "check_point_2"))["loss_log"]
    b = load_checkpoint(os.path.join(flagged, "check_point_2"))["loss_log"]
    for k in ("hm", "offset", "size", "total"):
        assert a[k] == b[k], k
    for k in NORM_KEYS:
        assert a[k] == [] and len(b[k]) == 4 and all(v > 0 for v in b[k])
    # the flight recorder: JAX's span names, one trace per step
    recs = read_spans(spans)
    names = {r.get("name") for r in recs}
    assert {"loader-wait", "h2d", "step", "fetch", "checkpoint",
            "context"} <= names
    steps = [r for r in recs if r.get("name") == "step"]
    assert len(steps) == 4 and all(r["rank"] == 0 for r in steps)
    assert steps[0]["trace"] == "step-train-e0-i000000"
    assert steps[-1]["trace"] == "step-train-e1-i000003"
    assert reg.counter("train.steps").value - steps0 == 8
    for h in ("train.step_ms", "train.loader_wait_ms", "train.fetch_ms"):
        assert reg.histogram(h).snapshot()["count"] > 0, h
