"""The PyTorch port's data parallelism on the CPU: 2 gloo processes.

The port runs one process per card with DistributedDataParallel and sums
the BN moments, the BN backward sums and the loss's positive count over
the ranks (`ops/epilogue.py` `BNTrain`, `ops/loss.py` `_num_pos`), so that
a step computes JAX's global-batch GSPMD step (ref parallel/mesh.py,
train.py:1705-1731). Held here, each worker a process of its own (this
file's `__main__` block: `python tests/test_torch_distributed.py MODE
RANK WORLD PORT DIR`), 120 s each, one thread each, every worker killed
when the test ends:

* one step (SGD) at world 2 on a global batch of 4: loss, parameters and
  running statistics bit-equal on the two ranks; against the port's own
  single-process step on the same batch, the loss rtol 1e-5 and every
  element rtol 1e-4 atol 1e-6 (JAX's 2-process bound; only the order of
  the f32 sums differs, observed at most 2.5e-5 relative); against JAX's
  single-process step (JAX tests/test_distributed.py:103's bound, rel
  1e-4): the loss rel 1e-4, the parameters rel 1e-4 (relative L2 over
  all of them), the update they took (the gradient) relative L2 5e-3
  (tests/test_torch_accum.py's port-vs-JAX pin), the running statistics
  within tests/test_torch_train.py's pin (rtol 1e-2, atol 2e-5: the
  port's and JAX's BN moments differ in their f32 order; single
  elements of the gradient differ up to ~1e-3 relative, see
  tests/test_torch_accum.py);
* the same with `--grad-accum 2`: micro-batch j of the world holds slice
  j of every rank's local batch, so JAX gets the rows [r0 s0, r1 s0,
  r0 s1, r1 s1];
* `--fwd-dtype int8 --sentinel --ema-decay 0.99`: the STE sites'
  global abs-max, one skip verdict on both ranks for a NaN batch on one
  of them, the EMA, against the single process and JAX's global step
  (see `check_extras`);
* `--sentinel --ema-decay 0.99` in f32: the same skip, and the clean
  step's update and EMA against the single process and JAX's global
  sentinel step at the bounds of the plain step above (see
  `check_sentinel`);
* `epoch_indices`' wrap-padded shards against JAX's (in process);
* the `DEADLINE_EXCEEDED:` barrier error when a rank never arrives;
* eval at world 2: the mAP of every rank equal to the single-process
  eval's on the synthetic VOC fixture, the detections equal, and the txt
  files and the pickle written by rank 0 alone.

The model is the 1-stack width-16 hourglass at 128^2 in f32 (see
tests/test_torch_accum.py for why not 64^2).
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
IMSIZE = 128
LR = 1e-2
BATCH = 4
WORKER_TIMEOUT_S = 120.0
FUSED = dict(epilogue="fused", block_fuse="fused", loss_kernel="xla")
SAME_PORT = dict(rtol=1e-4, atol=1e-6)
STATS = dict(rtol=1e-2, atol=2e-5)
GRAD_REL_L2 = 5e-3


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(tmp_path, mode, world=2):
    """Run `world` workers of `mode`; every one exits 0 within
    WORKER_TIMEOUT_S or the test fails, and none outlives it."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen(
        [sys.executable, HERE, mode, str(rank), str(world), str(port),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=REPO) for rank in range(world)]
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "rank %d exit %s:\n%s" % (
            rank, p.returncode, out[-4000:])
    return [torch.load(os.path.join(tmp_path, "%s-%d.pt" % (mode, r)),
                       weights_only=False) for r in range(world)]


# ------------------------------------------------------------- the worker


def worker_cfg(rank, world, port, **kw):
    from real_time_helmet_detection_tpu_torch.config import Config
    return Config(device="cpu", num_stack=1, hourglass_inch=16,
                  batch_size=BATCH, optim="SGD", lr=LR, world_size=world,
                  rank=rank, dist_url="tcp://localhost:%d" % port, **kw)


def port_step(cfg, init_path, local_rows, net_wrap):
    """One step of the port's train path on `local_rows` of the global
    batch from the weights in `init_path`; returns (the global loss,
    {flax path: array})."""
    from real_time_helmet_detection_tpu_torch import convert
    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        synthetic_target_batch
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        build_model
    from real_time_helmet_detection_tpu_torch.optim import (
        build_optimizer, make_lr_schedule)
    from real_time_helmet_detection_tpu_torch.parallel import (
        all_reduce_sum_, world_size)
    from real_time_helmet_detection_tpu_torch.train import make_train_step
    model = build_model(cfg).train()
    convert.load_into(model, convert.load_npz(init_path))
    net = net_wrap(model)
    opt = build_optimizer(cfg, model.parameters())
    step = make_train_step(model, opt, make_lr_schedule(cfg, 10), cfg,
                           net=net)
    arrs = synthetic_target_batch(BATCH, IMSIZE, seed=5)
    losses = step(0, *(torch.from_numpy(a[local_rows]) for a in arrs))
    total = all_reduce_sum_(losses["total"].clone()) / world_size()
    state = convert.flatten_tree(convert.state_dict_to_flax(
        model.state_dict()))
    return float(total), state


EXTRAS = dict(fwd_dtype="int8", sentinel=True, ema_decay=0.99)
SENTINEL = dict(sentinel=True, ema_decay=0.99)


def port_extras(cfg, init_path, local_rows, net_wrap, poison):
    """Two steps of the port's `--fwd-dtype int8 --sentinel --ema-decay
    0.99` path: a clean one, recording each STE site's quantization step,
    then one whose `poison` rows are NaN images. Returns the global loss
    and the state (parameters, statistics, EMA) after step 1, the steps,
    both verdicts and whether step 2 left every state tensor as it was."""
    from real_time_helmet_detection_tpu_torch import convert
    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        synthetic_target_batch
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        build_model
    from real_time_helmet_detection_tpu_torch.ops import qconv
    from real_time_helmet_detection_tpu_torch.optim import make_lr_schedule
    from real_time_helmet_detection_tpu_torch.parallel import (
        all_reduce_sum_, world_size)
    from real_time_helmet_detection_tpu_torch.train import (
        Sentinel, init_train_state, make_train_step)
    model = build_model(cfg)
    convert.load_into(model, convert.load_npz(init_path))
    opt, ema = init_train_state(cfg, model, "cpu")
    net = net_wrap(model)
    sentinel = Sentinel(cfg, model, opt, ema, "cpu")
    step = make_train_step(model, opt, make_lr_schedule(cfg, 10), cfg,
                           net=net, ema=ema, sentinel=sentinel)
    arrs = [a[local_rows] for a in synthetic_target_batch(BATCH, IMSIZE,
                                                          seed=5)]
    steps, local, real = [], [], qconv.quantize_act

    def recording(x, step_):
        steps.append(float(step_))
        local.append(float(x.abs().amax()))
        return real(x, step_)
    qconv.quantize_act = recording
    try:
        losses = step(0, *map(torch.from_numpy, arrs))
    finally:
        qconv.quantize_act = real
    total = float(all_reduce_sum_(losses["total"].clone()) / world_size())
    state = convert.flatten_tree(convert.state_dict_to_flax(
        model.state_dict()))
    state.update({"ema/" + k: v for k, v in convert.flatten_tree(
        convert.state_dict_to_flax(ema.model_state(model))["params"]).items()})
    before = [t.clone() for t in sentinel.tensors()]
    bad_arrs = list(arrs)
    if poison is not None and poison is not False:
        rows = slice(None) if poison is True else poison
        bad_arrs[0] = bad_arrs[0].copy()
        bad_arrs[0][rows] = np.nan
    losses2 = step(1, *map(torch.from_numpy, bad_arrs))
    kept = all(torch.equal(a, b) for a, b in zip(before, sentinel.tensors()))
    return dict(loss=total, state=state, steps=steps, local=local,
                bad=(float(losses["sentinel_bad"]),
                     float(losses2["sentinel_bad"])), kept=kept)


def worker(mode, rank, world, port, out_dir):
    torch.set_num_threads(1)
    from real_time_helmet_detection_tpu_torch import parallel
    result = {}
    if mode in ("step", "accum"):
        cfg = worker_cfg(rank, world, port,
                         grad_accum=2 if mode == "accum" else 1)
        parallel.init_distributed(cfg)
        b = parallel.local_batch_size(cfg)
        result["loss"], result["state"] = port_step(
            cfg, os.path.join(out_dir, "init.npz"),
            slice(rank * b, (rank + 1) * b),
            lambda m: torch.nn.parallel.DistributedDataParallel(
                m, broadcast_buffers=False))
    elif mode in ("extras", "sentinel"):
        cfg = worker_cfg(rank, world, port,
                         **(EXTRAS if mode == "extras" else SENTINEL))
        parallel.init_distributed(cfg)
        b = parallel.local_batch_size(cfg)
        result.update(port_extras(
            cfg, os.path.join(out_dir, "init.npz"),
            slice(rank * b, (rank + 1) * b),
            lambda m: torch.nn.parallel.DistributedDataParallel(
                m, broadcast_buffers=False), poison=rank == 1))
    elif mode == "barrier":
        cfg = worker_cfg(rank, world, port)
        parallel.init_distributed(cfg)
        if rank == 0:
            try:
                parallel.coordination_barrier("rank-1-never-comes",
                                              timeout_s=3.0)
                result["error"] = None
            except RuntimeError as e:
                result["error"] = str(e)
        parallel.coordination_barrier("all-here", timeout_s=60.0)
    elif mode == "eval":
        from real_time_helmet_detection_tpu_torch.evaluate import evaluate
        cfg = worker_cfg(rank, world, port)
        cfg = eval_cfg(out_dir, "rank%d" % rank, world_size=world,
                       rank=rank, dist_url=cfg.dist_url)
        m = evaluate(cfg)
        result["map"] = m["map"]
    parallel.destroy_process_group()
    torch.save(result, os.path.join(out_dir, "%s-%d.pt" % (mode, rank)))


def eval_cfg(out_dir, name, **kw):
    from real_time_helmet_detection_tpu_torch.config import Config
    return Config(device="cpu", data=os.path.join(out_dir, "voc"),
                  imsize=64, hourglass_inch=16, batch_size=2,
                  serve_buckets=[1, 2], serve_max_wait_ms=0.0,
                  save_path=os.path.join(out_dir, name), **kw)


# -------------------------------------------------------------- the tests


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """A JAX init of the tiny model, saved as the npz the workers load."""
    import jax

    from real_time_helmet_detection_tpu.config import Config as JaxConfig
    from real_time_helmet_detection_tpu.models import \
        build_model as jax_build
    from real_time_helmet_detection_tpu.train import init_variables
    from real_time_helmet_detection_tpu_torch import convert
    jcfg = JaxConfig(num_stack=1, hourglass_inch=16, num_cls=2, **FUSED)
    params, stats = jax.device_get(init_variables(
        jax_build(jcfg), jax.random.key(3), IMSIZE))
    path = str(tmp_path_factory.mktemp("init") / "init.npz")
    convert.save_npz(path, {"params": params, "batch_stats": stats})
    return path, params, stats


def jax_step(params, stats, rows, grad_accum):
    """JAX's single-process step on the global batch's `rows`."""
    import jax
    import jax.numpy as jnp

    from real_time_helmet_detection_tpu import optim as jax_optim
    from real_time_helmet_detection_tpu.config import Config as JaxConfig
    from real_time_helmet_detection_tpu.models import \
        build_model as jax_build
    from real_time_helmet_detection_tpu.train import (TrainState,
                                                      make_train_step_body)
    from real_time_helmet_detection_tpu_torch import convert
    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        synthetic_target_batch
    jcfg = JaxConfig(num_stack=1, hourglass_inch=16, num_cls=2,
                     batch_size=BATCH, optim="SGD", lr=LR,
                     grad_accum=grad_accum, **FUSED)
    tx = jax_optim.build_optimizer(jcfg, 10)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params))
    body = jax.jit(make_train_step_body(jax_build(jcfg), tx, jcfg))
    arrs = synthetic_target_batch(BATCH, IMSIZE, seed=5)
    state, losses = body(state, *(jnp.asarray(a[rows]) for a in arrs))
    return float(losses["total"]), convert.flatten_tree(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))


def jax_sentinel_step(params, stats, extras):
    """JAX's single-process `--sentinel` step (loss scale 1) with
    `extras` on the global batch: (loss, {flax path: array}, the EMA's
    included under "ema/")."""
    import jax
    import jax.numpy as jnp

    from real_time_helmet_detection_tpu import optim as jax_optim
    from real_time_helmet_detection_tpu.config import Config as JaxConfig
    from real_time_helmet_detection_tpu.models import \
        build_model as jax_build
    from real_time_helmet_detection_tpu.train import (TrainState,
                                                      make_train_step_body)
    from real_time_helmet_detection_tpu_torch import convert
    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        synthetic_target_batch
    jcfg = JaxConfig(num_stack=1, hourglass_inch=16, num_cls=2,
                     batch_size=BATCH, optim="SGD", lr=LR, **extras,
                     **FUSED)
    tx = jax_optim.build_optimizer(jcfg, 10)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params),
                       ema_params=jax.tree.map(jnp.copy, params))
    body = jax.jit(make_train_step_body(jax_build(jcfg), tx, jcfg))
    arrs = synthetic_target_batch(BATCH, IMSIZE, seed=5)
    state, jl = body(state, *map(jnp.asarray, arrs), jnp.float32(1.0))
    assert float(jl["sentinel_bad"]) == 0.0
    jstate = convert.flatten_tree(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    jstate.update({"ema/" + k: v for k, v in convert.flatten_tree(
        jax.device_get(state.ema_params)).items()})
    return float(jl["total"]), jstate


def check_skip_and_ranks(r0, r1):
    """The clean step taken and the NaN step on rank 1 skipped by both
    ranks, each keeping its whole state; the ranks bit-equal."""
    assert r0["bad"] == r1["bad"] == (0.0, 1.0)
    assert r0["kept"] and r1["kept"]
    assert r0["loss"] == r1["loss"]
    assert sorted(r0["state"]) == sorted(r1["state"])
    for k in r0["state"]:
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k],
                                      err_msg=k)


def check_ema_recurrence(sides, p0, names):
    """The EMA after one update is d p0 + (1 - d) p1 of each side's own
    parameters (rtol 1e-6)."""
    d = SENTINEL["ema_decay"]
    for side in sides:
        for n in names:
            e = "ema/" + n[len("params/"):]
            np.testing.assert_allclose(
                side[e], np.float32(d) * p0[n] + np.float32(1 - d) * side[n],
                rtol=1e-6, atol=1e-9, err_msg=e)


def moved(side, p0, names, prefix=""):
    """What the parameters (or, with prefix "ema/", the EMA) moved by
    in the step, as one float64 vector."""
    return np.concatenate([
        (np.asarray(side[prefix + (n if not prefix else n[len("params/"):])],
                    np.float64) - p0[n]).ravel() for n in names])


@pytest.mark.parametrize("mode", ["step", "accum", "extras", "sentinel"])
def test_two_process_step_matches_single_and_jax(tmp_path, jax_init, mode):
    """One step at world 2 against itself across ranks, the port's
    single-process step and JAX's (see the module docstring)."""
    import shutil

    import jax

    from real_time_helmet_detection_tpu_torch import convert
    init_path, params_tree, stats = jax_init
    shutil.copy(init_path, tmp_path / "init.npz")
    r0, r1 = run_world(tmp_path, mode)
    if mode == "extras":
        return check_extras(r0, r1, init_path, params_tree, stats)
    if mode == "sentinel":
        return check_sentinel(r0, r1, init_path, params_tree, stats)
    assert r0["loss"] == r1["loss"]
    assert sorted(r0["state"]) == sorted(r1["state"])
    for k in r0["state"]:
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k],
                                      err_msg=k)
    k = 2 if mode == "accum" else 1
    # the port alone on the global batch
    from real_time_helmet_detection_tpu_torch.config import Config
    cfg = Config(device="cpu", num_stack=1, hourglass_inch=16,
                 batch_size=BATCH, optim="SGD", lr=LR, grad_accum=k)
    # micro-batch j of the world: slice j of each rank's local rows
    order = [0, 2, 1, 3] if k == 2 else [0, 1, 2, 3]
    loss, single = port_step(cfg, init_path, order, lambda m: m)
    np.testing.assert_allclose(r0["loss"], loss, rtol=1e-5)
    for name in single:
        np.testing.assert_allclose(r0["state"][name], single[name],
                                   err_msg=name, **SAME_PORT)
    # JAX's single-process step on the same global batch
    jloss, jstate = jax_step(params_tree, stats, order, k)
    np.testing.assert_allclose(r0["loss"], jloss, rtol=1e-4)
    assert sorted(jstate) == sorted(single)
    params = sorted(n for n in jstate if n.startswith("params/"))
    for name in sorted(set(jstate) - set(params)):
        np.testing.assert_allclose(r0["state"][name], jstate[name],
                                   err_msg=name, **STATS)
    p0 = convert.flatten_tree({"params": jax.device_get(params_tree)})
    vec = lambda state, base=None: np.concatenate([
        (np.asarray(state[n], np.float64)
         - (0.0 if base is None else base[n])).ravel() for n in params])
    assert rel_l2(vec(r0["state"]), vec(jstate)) <= 1e-4
    # the gradient, read from the SGD update
    err = rel_l2(vec(r0["state"], p0), vec(jstate, p0))
    print("%s: update rel L2 port vs JAX %.3g" % (mode, err))
    assert err <= GRAD_REL_L2, err


def check_extras(r0, r1, init_path, params_tree, stats):
    """`--fwd-dtype int8 --sentinel --ema-decay 0.99` at world 2: each
    STE site quantizes with the abs-max of the global batch (on both
    ranks max(rank 0's, rank 1's abs-max) / 127; the first site's step
    equals the single process's, the later ones within rtol 5e-2: the BN
    sums' order moves their inputs by ulps, and a code that flips moves
    every later input, observed 2.1e-2); a NaN batch on
    rank 1 alone is skipped by both ranks, whose whole state stays as it
    was; the ranks bit-equal, EMA included; the EMA is d p0 + (1 - d) p1
    of each side's own parameters (rtol 1e-6); against the single
    process and JAX's global sentinel step (loss_scale 1), the loss rtol
    1e-2 (a 1e-6 change of the images moves the int8 loss up to 4e-3)
    and the update and the EMA's movement relative L2 under 1.0 — the
    int8 path's own sensitivity (tests/test_torch_fwd_int8.py: a 1e-6
    change of the images moves the gradient ~50%), so this only refuses
    a missing or flipped update (observed 0.35 against the single
    process, 0.44 against JAX). The sentinel and the EMA under DDP are
    held to the single process and JAX at the plain step's bounds by the
    f32 case, `check_sentinel`."""
    import jax

    from real_time_helmet_detection_tpu_torch import convert
    from real_time_helmet_detection_tpu_torch.config import Config
    check_skip_and_ranks(r0, r1)
    cfg = Config(device="cpu", num_stack=1, hourglass_inch=16,
                 batch_size=BATCH, optim="SGD", lr=LR, **EXTRAS)
    from test_torch_predict import chip_smoke
    dense, dw = chip_smoke.ste_walk(cfg)
    assert r0["steps"] == r1["steps"] and len(r0["steps"]) == dense + len(dw)
    single = port_extras(cfg, init_path, slice(None), lambda m: m,
                         poison=slice(2, 4))
    assert single["bad"] == (0.0, 1.0) and single["kept"]
    from real_time_helmet_detection_tpu_torch.ops.quant import act_step
    for i, step_ in enumerate(r0["steps"]):  # the global abs-max
        assert step_ == float(act_step(torch.tensor(max(
            r0["local"][i], r1["local"][i])))), i
    assert r0["steps"][0] == single["steps"][0]
    np.testing.assert_allclose(r0["steps"], single["steps"], rtol=5e-2)
    jloss, jstate = jax_sentinel_step(params_tree, stats, EXTRAS)
    p0 = convert.flatten_tree({"params": jax.device_get(params_tree)})
    names = sorted(p0)
    check_ema_recurrence((r0["state"], single["state"], jstate), p0, names)
    for other, what in ((single, "single"),
                        ({"state": jstate, "loss": jloss}, "JAX")):
        np.testing.assert_allclose(r0["loss"], other["loss"], rtol=1e-2,
                                   err_msg=what)
        for prefix in ("", "ema/"):
            a = moved(r0["state"], p0, names, prefix)
            b = moved(other["state"], p0, names, prefix)
            err = np.linalg.norm(a - b) / np.linalg.norm(b)
            print("extras: %s %supdate rel L2 %.3g" % (what, prefix, err))
            assert err < 1.0, (what, prefix, err)


def check_sentinel(r0, r1, init_path, params_tree, stats):
    """`--sentinel --ema-decay 0.99` at world 2 in f32: the NaN batch on
    rank 1 skipped by both ranks with their whole state kept, the ranks
    bit-equal; the clean step against the port's single process on the
    global batch (loss rtol 1e-5, every element of the parameters,
    statistics and EMA within SAME_PORT) and against JAX's global
    sentinel step at the plain step's bounds: loss rel 1e-4, parameters
    and EMA relative L2 1e-4, the update and the EMA's movement relative
    L2 GRAD_REL_L2, the running statistics within STATS, and the EMA the
    recurrence of each side's own parameters (rtol 1e-6)."""
    import jax

    from real_time_helmet_detection_tpu_torch import convert
    from real_time_helmet_detection_tpu_torch.config import Config
    check_skip_and_ranks(r0, r1)
    assert r0["steps"] == []  # no STE site in f32
    cfg = Config(device="cpu", num_stack=1, hourglass_inch=16,
                 batch_size=BATCH, optim="SGD", lr=LR, **SENTINEL)
    single = port_extras(cfg, init_path, slice(None), lambda m: m,
                         poison=slice(2, 4))
    assert single["bad"] == (0.0, 1.0) and single["kept"]
    np.testing.assert_allclose(r0["loss"], single["loss"], rtol=1e-5)
    assert sorted(r0["state"]) == sorted(single["state"])
    for name in single["state"]:
        np.testing.assert_allclose(r0["state"][name], single["state"][name],
                                   err_msg=name, **SAME_PORT)
    jloss, jstate = jax_sentinel_step(params_tree, stats, SENTINEL)
    np.testing.assert_allclose(r0["loss"], jloss, rtol=1e-4)
    assert sorted(jstate) == sorted(r0["state"])
    p0 = convert.flatten_tree({"params": jax.device_get(params_tree)})
    names = sorted(p0)
    check_ema_recurrence((r0["state"], single["state"], jstate), p0, names)
    for name in sorted(n for n in jstate if n.startswith("batch_stats/")):
        np.testing.assert_allclose(r0["state"][name], jstate[name],
                                   err_msg=name, **STATS)
    zero = {n: np.zeros_like(p0[n]) for n in names}
    for prefix in ("", "ema/"):
        a = moved(r0["state"], p0, names, prefix)
        b = moved(jstate, p0, names, prefix)
        err = np.linalg.norm(a - b) / np.linalg.norm(b)
        print("sentinel: JAX %supdate rel L2 %.3g" % (prefix, err))
        assert err <= GRAD_REL_L2, (prefix, err)
        err = rel_l2(moved(r0["state"], zero, names, prefix),
                     moved(jstate, zero, names, prefix))
        assert err <= 1e-4, (prefix, err)


def test_epoch_indices_shards_match_jax():
    """Each rank's shard, wrap-padded to a multiple of the world, equals
    JAX's `epoch_indices` (ref data/pipeline.py:206) for shuffled and
    ordered splits; together the shards cover every index."""
    from real_time_helmet_detection_tpu.data.pipeline import \
        epoch_indices as jax_epoch_indices
    from real_time_helmet_detection_tpu_torch.data.pipeline import \
        epoch_indices
    for n, world, shuffle in ((10, 3, True), (7, 2, False), (8, 4, True),
                              (1, 2, True), (5, 1, False)):
        shards = []
        for rank in range(world):
            got = epoch_indices(n, 9, 2, shuffle=shuffle, rank=rank,
                                world_size=world)
            want = jax_epoch_indices(n, 9, 2, shuffle=shuffle, rank=rank,
                                     world_size=world)
            np.testing.assert_array_equal(got, want)
            assert len(got) == -(-n // world)
            shards.append(got)
        assert set(np.concatenate(shards)) == set(range(n))


def test_barrier_deadline_when_a_rank_never_arrives(tmp_path):
    """Rank 1 skips a barrier: rank 0 raises a RuntimeError that starts
    with `DEADLINE_EXCEEDED:` and names the barrier, after its timeout;
    then both meet at the next one."""
    r0, _ = run_world(tmp_path, "barrier")
    assert r0["error"] is not None
    assert r0["error"].startswith("DEADLINE_EXCEEDED:")
    assert "'rank-1-never-comes'" in r0["error"]


def test_two_process_eval_matches_single(tmp_path):
    """Eval at world 2 on the synthetic VOC fixture (7 test images, so
    the shards wrap): every rank's mAP equals the single-process eval's,
    rank 0's pickle holds the same detections, and only rank 0 writes
    txt files and the pickle."""
    import glob
    import pickle

    from real_time_helmet_detection_tpu_torch.data.synthetic import \
        make_synthetic_voc
    from real_time_helmet_detection_tpu_torch.evaluate import evaluate
    make_synthetic_voc(str(tmp_path / "voc"), num_train=0, num_test=7,
                       imsize=(96, 80), seed=4)
    r0, r1 = run_world(tmp_path, "eval")
    single = evaluate(eval_cfg(str(tmp_path), "single"))
    assert r0["map"] == r1["map"] == single["map"]
    txt = lambda name: sorted(os.path.basename(p) for p in glob.glob(
        str(tmp_path / name / "results" / "txt" / "*.txt")))
    assert txt("rank0") == txt("single") and len(txt("single")) == 7
    assert txt("rank1") == []
    assert not (tmp_path / "rank1" / "prediction_results.pickle").exists()
    with open(tmp_path / "rank0" / "prediction_results.pickle", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "single" / "prediction_results.pickle", "rb") as f:
        want = pickle.load(f)
    assert sorted(got) == sorted(want)
    # the ranks' batches (buckets 1 and 2) are not the single eval's, and
    # CPU convolutions round by batch size: boxes within 1e-4 px
    for k in want:
        np.testing.assert_array_equal(got[k]["cls"], want[k]["cls"])
        np.testing.assert_allclose(got[k]["score"], want[k]["score"],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k]["box"], want[k]["box"],
                                   rtol=1e-5, atol=1e-4, err_msg=k)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
           int(sys.argv[4]), sys.argv[5])
