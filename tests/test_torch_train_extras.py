"""The train-step extras of the PyTorch port against the JAX package, on
the CPU: `--param-policy bf16-compute`, the EMA, `--remat` and
`--distill`.

The model is tests/test_torch_train.py's slice (1 stack, width 16,
128^2, batch 2, the JAX fused configuration) unless a test says
otherwise; the JAX init is carried across by the weight bridge. Every
tolerance is stated at its pin with what this CPU showed.
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
from real_time_helmet_detection_tpu.config import \
    load_config as jax_load_config
from real_time_helmet_detection_tpu.config import \
    update_config_for_eval as jax_update_for_eval
from real_time_helmet_detection_tpu.models import build_model as jax_build
from real_time_helmet_detection_tpu.train import (
    Distiller as JaxDistiller, TrainState, _optimizer_update,
    create_train_state, init_variables, make_state_accum_flush,
    make_train_step_body)
from real_time_helmet_detection_tpu_torch import convert
from real_time_helmet_detection_tpu_torch.config import (ARCHITECTURE_FIELDS,
                                                         Config, save_config)
from real_time_helmet_detection_tpu_torch.data.synthetic import \
    synthetic_target_batch
from real_time_helmet_detection_tpu_torch.models.hourglass import \
    build_model
from real_time_helmet_detection_tpu_torch.ops import epilogue, residual
from real_time_helmet_detection_tpu_torch.optim import (make_lr_schedule,
                                                        set_lr)
from real_time_helmet_detection_tpu_torch.train import (
    EMA, Distiller, init_train_state, loss_fn, make_distiller,
    make_train_step, save_checkpoint)
from real_time_helmet_detection_tpu_torch.ops.loss import LossLog

from test_torch_train import (FUSED, assert_close, jax_grads,  # noqa: F401
                              one_torch_thread, stats_of)

IMSIZE = 128  # see tests/test_torch_train.py SLICE_IMSIZE


@pytest.fixture(scope="module")
def ref():
    jcfg = JaxConfig(num_stack=1, hourglass_inch=16, imsize=IMSIZE,
                     batch_size=2, **FUSED)
    params, stats = jax.device_get(init_variables(
        jax_build(jcfg), jax.random.key(2), IMSIZE))
    batches = [synthetic_target_batch(2, IMSIZE, seed=s) for s in range(3)]
    cfg = Config(device="cpu", num_stack=1, hourglass_inch=16, batch_size=2)
    return dict(jcfg=jcfg, params=params, stats=stats, batches=batches,
                cfg=cfg)


def port_model(cfg, params, stats, dtype=None):
    model = build_model(cfg, dtype=dtype)
    convert.load_into(model, {"params": params, "batch_stats": stats})
    return model


def flat_params(model):
    return {n: p.detach().float().numpy().copy()
            for n, p in model.named_parameters()}


def tensors(arrs):
    return [torch.from_numpy(a) for a in arrs]


# ------------------------------------------------------- bf16-compute


def test_bf16_policy_state_dtypes_match_jax(ref):
    """The train state's dtypes under the policy (with an EMA): JAX's
    `create_train_state` and the port's `init_train_state` both hold
    bf16 parameters, float32 masters, a bf16 EMA and float32 running
    statistics, leaf for leaf."""
    jcfg = dataclasses.replace(ref["jcfg"], amp=True,
                               param_policy="bf16-compute", ema_decay=0.99)
    tx = jax_optim.build_optimizer(jcfg, 10)
    state = create_train_state(jax_build(jcfg, dtype=jnp.bfloat16), jcfg,
                               jax.random.key(0), 64, tx)
    cfg = dataclasses.replace(ref["cfg"], amp=True,
                              param_policy="bf16-compute", ema_decay=0.99)
    model = build_model(cfg, dtype=torch.bfloat16)
    opt, ema = init_train_state(cfg, model, "cpu")

    def kinds(leaves):
        return sorted(str(np.dtype(x.dtype)) if hasattr(x, "dtype")
                      else "?" for x in leaves)
    jl = jax.tree.leaves
    n = len(jl(state.params))
    assert n == len(list(model.parameters())) == len(opt.masters)
    assert {str(x.dtype) for x in jl(state.params)} == {"bfloat16"}
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert {str(x.dtype) for x in jl(state.opt_state.master)} == {"float32"}
    assert {m.dtype for m in opt.masters} == {torch.float32}
    assert {str(x.dtype) for x in jl(state.ema_params)} == {"bfloat16"}
    assert {t.dtype for t in ema.tensors} == {torch.bfloat16}
    assert {str(x.dtype) for x in jl(state.batch_stats)} == {"float32"}
    assert {b.dtype for b in model.buffers()} == {torch.float32}
    assert len(jl(state.batch_stats)) == len(list(model.buffers()))
    assert kinds(jl(state.params)) == ["bfloat16"] * n


def port_masters(model, opt):
    named = dict(zip([n for n, _ in model.named_parameters()],
                     opt.masters if hasattr(opt, "masters")
                     else list(model.parameters())))
    return convert.flatten_tree(convert.state_dict_to_flax(named)["params"])


def test_bf16_policy_steps_match_jax(ref):
    """Steps 1 and 3 under the policy (--amp, SGD lr 1e-3) by JAX's step
    body and by the port's step, from one init. Both compute in bf16, and
    through 37 BatchNorms at this random init their bf16 gradients sit
    far from the float32 one (JAX's update is 33% from it in relative
    L2), each in its own rounding. So the yardstick is the float32 step
    (the port's fp32 policy without --amp, which tests/test_torch_train.py
    holds to JAX's): the port's update (the float32 masters' movement) is
    no further from it than 1.5x JAX's (chip_smoke.py's bf16 rule;
    observed 0.375 against 0.347 at step 1, 0.383 against 0.349 at step
    3). The loss of step 1 within tests/test_param_policy.py's rtol 1e-3
    of JAX's (observed 4.6e-4), of step 3, after two bf16 updates on
    each side, within one bf16 ulp, 2^-8 relative (observed 2.6e-3). The
    parameters are bf16 of the masters."""
    jcfg = dataclasses.replace(ref["jcfg"], amp=True,
                               param_policy="bf16-compute", optim="SGD",
                               lr=1e-3)
    tx = jax_optim.build_optimizer(jcfg, 10)
    jmodel = jax_build(jcfg, dtype=jnp.bfloat16)
    state = create_train_state(jmodel, jcfg, jax.random.key(2), IMSIZE, tx)
    params0 = jax.device_get(state.opt_state.master)
    stats0 = jax.device_get(state.batch_stats)
    body = jax.jit(make_train_step_body(jmodel, tx, jcfg))
    runs = {}
    for name, kw, dtype in (
            ("policy", dict(amp=True, param_policy="bf16-compute"),
             torch.bfloat16), ("f32", {}, None)):
        cfg = dataclasses.replace(ref["cfg"], optim="SGD", lr=1e-3, **kw)
        model = port_model(cfg, params0, stats0, dtype)
        opt, _ = init_train_state(cfg, model, "cpu")
        runs[name] = (model, opt, make_train_step(
            model, opt, make_lr_schedule(cfg, 10), cfg))
    p0 = convert.flatten_tree(params0)
    names = sorted(p0)

    def moved(tree):
        return np.concatenate([(np.asarray(tree[n], np.float64)
                                - p0[n]).ravel() for n in names])

    for count, arrs in enumerate(ref["batches"]):
        state, jl = body(state, *map(jnp.asarray, arrs))
        got = {k: float(v[2](count, *tensors(arrs))["total"])
               for k, v in runs.items()}
        if count == 1:
            continue
        np.testing.assert_allclose(got["policy"], float(jl["total"]),
                                   rtol=1e-3 if count == 0 else 2 ** -8,
                                   err_msg="step %d" % count)
        truth = moved(port_masters(*runs["f32"][:2]))
        port = moved(port_masters(*runs["policy"][:2]))
        jax_u = moved(convert.flatten_tree(jax.device_get(
            state.opt_state.master)))
        e_port = np.linalg.norm(port - truth) / np.linalg.norm(truth)
        e_jax = np.linalg.norm(jax_u - truth) / np.linalg.norm(truth)
        print("policy step %d: loss %.6g vs %.6g; update from f32's: port "
              "%.3g, JAX %.3g" % (count, got["policy"], float(jl["total"]),
                                  e_port, e_jax))
        assert e_port <= 1.5 * e_jax, (count, e_port, e_jax)
    model, opt, _ = runs["policy"]
    for p, m in zip(model.parameters(), opt.masters):
        assert p.dtype == torch.bfloat16 and torch.equal(p, m.bfloat16())


def test_bf16_policy_grad_accum_sums_in_float32(ref):
    """`--grad-accum 2` under the policy: the masters' gradient is the
    float32 sum of the two micro-batches' bf16 gradients, bit for bit
    (JAX sums them in float32 too, ref train.py:386-401); a bf16 sum
    would differ."""
    cfg = dataclasses.replace(ref["cfg"], amp=True, batch_size=4,
                              param_policy="bf16-compute", grad_accum=2,
                              optim="SGD")
    arrs = synthetic_target_batch(4, 64, seed=9)
    halves = []
    for j in range(2):
        model = port_model(cfg, ref["params"], ref["stats"], torch.bfloat16)
        opt, _ = init_train_state(cfg, model, "cpu")
        total, _ = loss_fn(model, *tensors(a[2 * j:2 * j + 2] for a in arrs),
                           cfg)
        total.backward()
        halves.append([p.grad.clone() for p in model.parameters()])
    model = port_model(cfg, ref["params"], ref["stats"], torch.bfloat16)
    opt, _ = init_train_state(cfg, model, "cpu")
    step = make_train_step(model, opt, make_lr_schedule(cfg, 10), cfg)
    step(0, *tensors(arrs))
    differs = False
    for m, g1, g2 in zip(opt.masters, *halves):
        assert m.grad.dtype == torch.float32
        assert torch.equal(m.grad, g1.float() + g2.float())
        differs |= not torch.equal(m.grad, (g1 + g2).float())
    assert differs


# ------------------------------------------------------------------ EMA


def test_ema_update_matches_jax(ref):
    """One Adam update with the EMA (decay 0.99) from the same weights
    and gradients: the parameters within rtol 1e-6 atol 1e-9 of JAX's
    `_optimizer_update` (observed 1.8e-7 relative), the EMA within rtol
    1e-6 atol 1e-9 (observed bit-equal but for the parameters' own
    difference)."""
    jcfg = dataclasses.replace(ref["jcfg"], ema_decay=0.99)
    params, stats = ref["params"], ref["stats"]
    rng = np.random.default_rng(0)
    grads = jax.tree.map(
        lambda x: rng.normal(0, 1, x.shape).astype(np.float32), params)
    tx = jax_optim.build_optimizer(jcfg, 10)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params),
                       ema_params=jax.tree.map(jnp.copy, params))
    new = _optimizer_update(state, tx, jcfg, grads, stats)
    cfg = dataclasses.replace(ref["cfg"], ema_decay=0.99)
    model = port_model(cfg, params, stats)
    opt, ema = init_train_state(cfg, model, "cpu")
    g = convert.flax_to_state_dict({"params": grads})
    for n, p in model.named_parameters():
        p.grad = g[n].clone()
    set_lr(opt, make_lr_schedule(cfg, 10)(0))
    opt.step()
    ema.update()
    want_p = convert.flax_to_state_dict({"params": jax.device_get(
        new.params)})
    want_e = convert.flax_to_state_dict({"params": jax.device_get(
        new.ema_params)})
    got_e = ema.state_dict()
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[n].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=n)
        np.testing.assert_allclose(got_e[n].numpy(), want_e[n].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=n)


def test_ema_sub_divisions_flush_matches_jax(ref):
    """An epoch of 3 steps under `--sub-divisions 2 --ema-decay 0.9`
    (SGD, lr 1e-2): JAX's step body (optax.MultiSteps: the EMA moves on
    every host step) and its epoch-end flush against the port's steps
    (no update, an update, the flush). The port's EMA is JAX's recurrence
    over the port's own parameters after each step, within rtol 1e-6
    atol 1e-9. Against JAX the EMA can only carry the parameters'
    difference: three SGD steps at lr 1e-2 take the port's parameters
    3.2e-2 from JAX's in relative L2 of their movement (one step's
    gradients differ by ~3e-3, tests/test_torch_distributed.py, and the
    steps compound it); the EMA's movement must be no further from
    JAX's EMA's than that (observed 1.8e-2)."""
    d = 0.9
    jcfg = dataclasses.replace(ref["jcfg"], sub_divisions=2, ema_decay=d,
                               optim="SGD", lr=1e-2)
    params, stats = ref["params"], ref["stats"]
    tx = jax_optim.build_optimizer(jcfg, 3)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params),
                       ema_params=jax.tree.map(jnp.copy, params))
    body = jax.jit(make_train_step_body(jax_build(jcfg), tx, jcfg))
    for arrs in ref["batches"]:
        state, _ = body(state, *map(jnp.asarray, arrs))
    assert int(state.opt_state.mini_step) == 1
    state = make_state_accum_flush(jcfg, 3)(state)
    jema = convert.flax_to_state_dict({"params": jax.device_get(
        state.ema_params)})
    cfg = dataclasses.replace(ref["cfg"], sub_divisions=2, ema_decay=d,
                              optim="SGD", lr=1e-2)
    model = port_model(cfg, params, stats)
    opt, ema = init_train_state(cfg, model, "cpu")
    step = make_train_step(model, opt, make_lr_schedule(cfg, 2), cfg,
                           ema=ema)
    e = flat_params(model)
    p0 = dict(e)
    flags = [(False, False), (True, False), (True, True)]
    for i, (arrs, (update, flush)) in enumerate(zip(ref["batches"], flags)):
        before = flat_params(model)
        step(i, *tensors(arrs), update=update)
        after = flat_params(model)
        if flush:
            e = {n: np.float32(d) * e[n] + np.float32(1 - d) * before[n]
                 for n in e}
        e = {n: np.float32(d) * e[n] + np.float32(1 - d) * after[n]
             for n in e}
        assert (i == 0) == all(np.array_equal(before[n], after[n])
                               for n in after)
    got = {n: t.numpy() for n, t in ema.state_dict().items()}
    for n in e:
        np.testing.assert_allclose(got[n], e[n], rtol=1e-6, atol=1e-9,
                                   err_msg=n)
    names = sorted(got)
    jparams = convert.flax_to_state_dict({"params": jax.device_get(
        state.params)})
    last = flat_params(model)

    def rel(tree, jtree):
        a = np.concatenate([(tree[n] - p0[n]).ravel() for n in names])
        b = np.concatenate([(jtree[n].numpy() - p0[n]).ravel()
                            for n in names])
        return np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(got, jema) <= rel(last, jparams), (rel(got, jema),
                                                  rel(last, jparams))


# ---------------------------------------------------------------- remat


def count_calls(monkeypatch):
    from real_time_helmet_detection_tpu_torch.ops import qconv
    calls = {}
    for mod, attr in ((epilogue, "bn_act"), (epilogue, "bn_stats"),
                      (residual, "bn_add_act"), (epilogue, "bn_bwd_dx"),
                      (qconv, "quantize_act"), (qconv, "conv_dense")):
        real = getattr(mod, attr)
        calls[attr] = 0

        def wrapper(*a, _real=real, _attr=attr, **kw):
            calls[_attr] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, attr, wrapper)
    return calls


@pytest.mark.parametrize("remat", ["stacks", "full"])
def test_remat_bit_equal_to_none(monkeypatch, remat):
    """2 stacks at 64^2, batch 2, f32, with and without `--fwd-dtype
    int8`: the loss, every gradient and every running statistic of a
    `--remat` step bit-equal to `--remat none`'s from the same weights
    (the statistics therefore moved once); the recompute reruns the
    forward passes `chip_smoke.expected_launches` derives (BN moments,
    epilogue, tail, quantizer, int8 conv), the backward ones run once."""
    from test_torch_predict import chip_smoke
    arrs = tensors(synthetic_target_batch(2, 64, seed=4))
    for fwd in ("bf16", "int8"):
        results = {}
        for mode in ("none", remat):
            cfg = Config(device="cpu", num_stack=2, hourglass_inch=16,
                         batch_size=2, imsize=64, remat=mode, fwd_dtype=fwd)
            model = build_model(cfg)
            torch.manual_seed(0)
            for p in model.parameters():
                p.data.normal_(0, 0.3)
            model.train()
            calls = count_calls(monkeypatch)
            total, _ = loss_fn(model, *arrs, cfg)
            total.backward()
            want = chip_smoke.expected_launches(cfg, "train", torch.float32)
            assert calls == {k: want[k] for k in (
                "bn_act", "bn_stats", "bn_add_act", "bn_bwd_dx")} | {
                "quantize_act": want["quantize_act"],
                "conv_dense": want["qconv_dense"]}, (mode, fwd, calls)
            results[mode] = (total.detach(),
                             {n: p.grad for n, p in model.named_parameters()},
                             dict(model.named_buffers()))
            monkeypatch.undo()
        (l0, g0, b0), (l1, g1, b1) = results["none"], results[remat]
        assert torch.equal(l0, l1), fwd
        for n in g0:
            assert torch.equal(g0[n], g1[n]), (fwd, n)
        for n in b0:
            assert torch.equal(b0[n], b1[n]), (fwd, n)


def test_remat_stacks_matches_jax_remat_step(ref):
    """One loss + backward under `--remat stacks` against JAX's (its
    per-stack `nn.remat`, bit-equal to its own plain step here), from the
    JAX init: tests/test_torch_train.py's 1-stack pins — loss rtol 1e-5,
    gradients rtol 5e-3 atol 1e-4 per element (observed 1.2e-5 max abs),
    running statistics rtol 1e-2 atol 2e-5. (On this init the next
    seed's batch sits on a tie that moves the stem's gradient by 3.3e-3
    between the port and JAX with or without remat.)"""
    jcfg = dataclasses.replace(ref["jcfg"], remat="stacks")
    arrs = ref["batches"][0]
    jl, jstats, want = jax_grads(jax_build(jcfg), jcfg, ref["params"],
                                 ref["stats"], arrs)
    cfg = dataclasses.replace(ref["cfg"], remat="stacks")
    model = port_model(cfg, ref["params"], ref["stats"]).train()
    total, _ = loss_fn(model, *tensors(arrs), cfg)
    total.backward()
    np.testing.assert_allclose(total.item(), jl, rtol=1e-5)
    assert_close(stats_of(model), convert.flatten_tree(jstats), rtol=1e-2,
                 atol=2e-5)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(),
                                   rtol=5e-3, atol=1e-4, err_msg=n)


# -------------------------------------------------------------- distill


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    """A 2-stack width-16 teacher: its JAX init, and a port save dir
    holding its snapshot and a checkpoint of those weights."""
    tj = JaxConfig(num_stack=2, hourglass_inch=16, imsize=64, **FUSED)
    tmodel = jax_build(tj)
    tparams, tstats = jax.device_get(init_variables(
        tmodel, jax.random.key(7), 64))
    save = str(tmp_path_factory.mktemp("teacher"))
    tcfg = Config(device="cpu", num_stack=2, hourglass_inch=16, imsize=64)
    save_config(tcfg, save)
    model = port_model(tcfg, tparams, tstats)
    from real_time_helmet_detection_tpu_torch.optim import build_optimizer
    save_checkpoint(save, 0, 0, model, build_optimizer(
        tcfg, model.parameters()), LossLog())
    return dict(jcfg=tj, jmodel=tmodel, params=tparams, stats=tstats,
                save=save)


def test_distill_soft_losses_match_jax(teacher):
    """`Distiller.soft_losses` of one student output (2 stacks, raw
    logits drawn from a seed) against the teacher's last stack: each of
    hm, offset, size and total within rtol 1e-5 of JAX's on the same
    teacher weights (observed 4e-7)."""
    rng = np.random.default_rng(1)
    images, heat, off, wh, mask = synthetic_target_batch(2, 64, seed=2)
    out = rng.normal(0, 2, (2, 2, 16, 16, 6)).astype(np.float32)
    jd = JaxDistiller(teacher["jmodel"], teacher["params"], teacher["stats"],
                      0.5, 2, False)
    want = jd.soft_losses(jnp.asarray(out), jnp.asarray(images),
                          jnp.asarray(mask), teacher["jcfg"])
    tcfg = Config(device="cpu", num_stack=2, hourglass_inch=16)
    tm = port_model(tcfg, teacher["params"], teacher["stats"]).eval()
    got = Distiller(tm, 0.5, 2, False).soft_losses(
        torch.from_numpy(out), torch.from_numpy(images),
        torch.from_numpy(mask), tcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_distill_teacher_architecture_from_snapshot(teacher):
    """`--distill <save dir>`: the teacher is its newest checkpoint, built
    with the architecture of the snapshot beside it (2 stacks under an
    edge-architecture student), the fields JAX's `update_config_for_eval`
    takes from the same snapshot; the step's losses carry `distill` and
    total = hard + alpha * distill (rtol 1e-6)."""
    cfg = Config(device="cpu", variant="ghost", hourglass_inch=8,
                 stem_width=8, batch_size=2, imsize=64,
                 distill=teacher["save"], distill_alpha=0.25)
    d = make_distiller(cfg, "cpu")
    assert d.model.num_stack == 2 and not d.model.training
    jcfg = jax_update_for_eval(
        JaxConfig(variant="ghost", hourglass_inch=8, stem_width=8),
        jax_load_config(os.path.join(teacher["save"], "argument.json")))
    assert jcfg.num_stack == 2 and jcfg.variant == "residual"
    arrs = tensors(synthetic_target_batch(2, 64, seed=3))
    want = port_model(Config(device="cpu", num_stack=2, hourglass_inch=16),
                      teacher["params"], teacher["stats"]).eval()
    with torch.no_grad():
        np.testing.assert_array_equal(d.model(arrs[0]).numpy(),
                                      want(arrs[0]).numpy())
    model = build_model(cfg).train()
    torch.manual_seed(0)
    total, losses = loss_fn(model, *arrs, cfg, d)
    assert "distill" in losses
    model2 = build_model(cfg).train()
    model2.load_state_dict(model.state_dict())
    hard, _ = loss_fn(model2, *arrs, cfg)
    np.testing.assert_allclose(
        total.item(), hard.item() + 0.25 * losses["distill"].item(),
        rtol=1e-6)
    for f in ARCHITECTURE_FIELDS:
        if f in ("num_stack", "hourglass_inch", "variant", "stem_width"):
            assert getattr(jcfg, f) == {"num_stack": 2,
                                        "hourglass_inch": 16,
                                        "variant": "residual",
                                        "stem_width": 0}[f]
