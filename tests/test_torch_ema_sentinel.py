"""The EMA checkpoints and `--ema-eval`, and the train sentinel of the
PyTorch port, on the CPU.

* EMA: the train CLI with `--ema-decay` writes the EMA into
  `checkpoint.pt` and `ema.npz` (the tree `scripts/orbax_to_npz.py --ema`
  writes); `--ema-eval` on that checkpoint gives the mAP of the EMA
  weights loaded as an `.npz`, bit for bit the same detections; it
  raises JAX's error on a checkpoint without an EMA; resuming across an
  EMA mismatch seeds or drops the stream as JAX does (ref
  tests/test_ema.py:134).
* Sentinel: a NaN batch leaves every state tensor bit-identical —
  parameters, moments, Adam's count, the LR count, the running
  statistics, the EMA, the bf16 policy's masters — and a finite spike
  above `--sentinel-spike` is skipped the same way, all with no host
  read inside the step; a clean step under the sentinel takes the
  update the plain step takes (rtol 1e-6: Adam's bias correction on the
  device); `SentinelMonitor` fed JAX's flag sequences gives JAX's scales,
  counters and raise; `--sentinel-divergence` consecutive skips roll the
  train CLI back to its last checkpoint, within `--sentinel-rollbacks`.
"""

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.runtime.errors import \
    TrainingDivergenceError as JaxDivergence
from real_time_helmet_detection_tpu.train import \
    SentinelMonitor as JaxMonitor
from real_time_helmet_detection_tpu_torch.__main__ import main
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.convert import (load_npz,
                                                          state_dict_to_flax)
from real_time_helmet_detection_tpu_torch.data.synthetic import (
    make_synthetic_voc, synthetic_target_batch)
from real_time_helmet_detection_tpu_torch.models.hourglass import \
    build_model
from real_time_helmet_detection_tpu_torch.obs.metrics import \
    default_registry
from real_time_helmet_detection_tpu_torch.optim import make_lr_schedule
from real_time_helmet_detection_tpu_torch.runtime.errors import \
    TrainingDivergenceError
from real_time_helmet_detection_tpu_torch.train import (
    Sentinel, SentinelMonitor, init_train_state, load_checkpoint,
    make_train_step)

from test_torch_train import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    return make_synthetic_voc(str(tmp_path_factory.mktemp("voc")),
                              num_train=8, num_test=2, seed=0)


def train_cli(voc, out, *extra, epochs=1):
    main(["--train-flag", "--data", voc, "--device", "cpu",
          "--hourglass-inch", "8", "--stem-width", "8", "--batch-size", "4",
          "--end-epoch", str(epochs), "--multiscale", "32", "64", "32",
          "--print-interval", "1", "--num-workers", "2", "--lr", "2e-3",
          "--save-path", out, *extra])


def eval_cli(voc, out, model_load, *extra):
    main(["--data", voc, "--device", "cpu", "--imsize", "64",
          "--batch-size", "2", "--hourglass-inch", "8", "--stem-width", "8",
          "--model-load", model_load, "--save-path", out, *extra])
    with open(os.path.join(out, "prediction_results.pickle"), "rb") as f:
        import pickle
        return pickle.load(f)


# ------------------------------------------------------------------ EMA


def test_ema_checkpoint_and_ema_eval(voc, tmp_path, capsys):
    save = str(tmp_path / "w")
    train_cli(voc, save, "--ema-decay", "0.9", epochs=2)
    ckpt_dir = os.path.join(save, "check_point_2")
    ckpt = load_checkpoint(ckpt_dir)
    ema = load_npz(os.path.join(ckpt_dir, "ema.npz"))
    want = state_dict_to_flax(dict(ckpt["state_dict"], **ckpt["ema"]))
    for coll in ("params", "batch_stats"):
        from real_time_helmet_detection_tpu_torch.convert import flatten_tree
        a, b = flatten_tree(ema[coll]), flatten_tree(want[coll])
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the EMA is not the raw weights
    assert any(not torch.equal(ckpt["ema"][n], ckpt["state_dict"][n])
               for n in ckpt["ema"])
    capsys.readouterr()
    # --ema-eval on the save dir (its newest checkpoint) == the EMA npz
    got = eval_cli(voc, str(tmp_path / "e1"), save, "--ema-eval")
    m1 = capsys.readouterr().out.split(": mAP ")[1].split()[0]
    want = eval_cli(voc, str(tmp_path / "e2"),
                    os.path.join(ckpt_dir, "ema.npz"))
    m2 = capsys.readouterr().out.split(": mAP ")[1].split()[0]
    assert m1 == m2
    raw = eval_cli(voc, str(tmp_path / "e3"), ckpt_dir)
    assert sorted(got) == sorted(want) == sorted(raw)
    for k in got:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ema_eval_without_ema_raises(voc, tmp_path):
    save = str(tmp_path / "w")
    train_cli(voc, save)
    with pytest.raises(ValueError, match="no EMA weights"):
        main(["--data", voc, "--device", "cpu", "--imsize", "64",
              "--model-load", save, "--ema-eval", "--save-path",
              str(tmp_path / "e")])
    with pytest.raises(ValueError, match="--ema-eval takes a port"):
        main(["--data", voc, "--device", "cpu", "--imsize", "64",
              "--model-load", os.path.join(save, "check_point_1",
                                           "weights.npz"),
              "--ema-eval", "--save-path", str(tmp_path / "e")])


def test_resume_across_ema_mismatch(voc, tmp_path, capsys):
    """A checkpoint without an EMA resumed with `--ema-decay` seeds the
    stream from the restored weights; one with an EMA resumed without
    drops it (ref train.py:942-1014)."""
    off, on = str(tmp_path / "off"), str(tmp_path / "on")
    train_cli(voc, off)
    capsys.readouterr()
    train_cli(voc, off, "--ema-decay", "0.5", "--model-load",
              os.path.join(off, "check_point_1"), epochs=2)
    assert "seeding EMA from the restored params" in capsys.readouterr().out
    assert load_checkpoint(os.path.join(off, "check_point_2"))["ema"]
    train_cli(voc, on, "--ema-decay", "0.5")
    capsys.readouterr()
    train_cli(voc, on, "--model-load", on, epochs=2)
    assert "dropping it" in capsys.readouterr().out
    ck = load_checkpoint(os.path.join(on, "check_point_2"))
    assert ck["ema"] is None
    assert not os.path.exists(os.path.join(on, "check_point_2", "ema.npz"))


# ------------------------------------------------------------- sentinel


def trainer(**kw):
    cfg = Config(device="cpu", hourglass_inch=8, stem_width=8, batch_size=2,
                 sentinel=True, ema_decay=0.9, lr=1e-3, **kw)
    model = build_model(cfg, dtype=torch.bfloat16 if cfg.amp else None)
    torch.manual_seed(0)
    for p in model.parameters():
        p.data.normal_(0, 0.3)
    opt, ema = init_train_state(cfg, model, "cpu")
    sentinel = Sentinel(cfg, model, opt, ema, "cpu")
    monitor = SentinelMonitor(cfg)
    step = make_train_step(model, opt, make_lr_schedule(cfg, 1), cfg,
                           ema=ema, sentinel=sentinel,
                           loss_scale=monitor.scale_value)
    return cfg, model, opt, ema, sentinel, step


def state_bits(sentinel, opt):
    ts = [t.detach().clone() for t in sentinel.tensors()]
    counts = [g["count"] for g in getattr(opt, "inner", opt).param_groups]
    return ts, [c.clone() if torch.is_tensor(c) else c for c in counts]


@contextlib.contextmanager
def no_host_reads():
    """Inside: any read of a tensor's value on the host raises (what a
    device -> host sync would be on a card)."""
    names = ("item", "tolist", "numpy", "cpu", "__bool__", "__float__",
             "__int__", "__index__")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def refuse(*a, **kw):
        raise AssertionError("a host read inside the step")
    try:
        for n in names:
            setattr(torch.Tensor, n, refuse)
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


@pytest.mark.parametrize("case", ["nan", "spike", "nan-bf16-policy"])
def test_sentinel_skip_keeps_every_state_tensor(case):
    kw = dict(amp=True, param_policy="bf16-compute") \
        if case.endswith("policy") else {}
    if case == "spike":
        kw["sentinel_spike"] = 1e-6
    cfg, model, opt, ema, sentinel, step = trainer(**kw)
    arrs = [torch.from_numpy(a) for a in synthetic_target_batch(2, 64)]
    if case != "spike":  # one clean step first: moments, count, EMA move
        losses = step(0, *arrs)
        assert float(losses["sentinel_bad"]) == 0.0
        assert float(sentinel.count) == 1.0
    before, counts = state_bits(sentinel, opt)
    bad = list(arrs)
    if case != "spike":
        bad[0] = torch.full_like(arrs[0], float("nan"))
    with no_host_reads():
        losses = step(1, *bad)
    assert float(losses["sentinel_bad"]) == 1.0
    assert {"sentinel_bad", "sentinel_grad_norm",
            "sentinel_scale"} <= set(losses)
    after, counts_after = state_bits(sentinel, opt)
    assert len(before) == len(after) > 3 * len(list(model.parameters()))
    for a, b in zip(before, after):
        assert torch.equal(a, b) or (a.isnan().all() and b.isnan().all())
    for a, b in zip(counts, counts_after):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    if case == "spike":
        assert np.isfinite(float(losses["total"]))
        assert float(losses["sentinel_grad_norm"]) > 1e-6
    # the state is the pre-step one: the next clean step moves it again
    losses = step(2, *arrs)
    assert float(losses["sentinel_bad"]) == float(case == "spike")


def test_sentinel_clean_step_is_the_plain_step():
    """With nothing to skip and a loss scale of 1/4 (a power of two, so
    the scaling is exact), the sentinel's step takes the update of the
    plain step: parameters within rtol 1e-6 (Adam's bias corrections are
    computed on the device under the sentinel), the losses equal."""
    cfg, model, opt, ema, sentinel, _ = trainer()
    step = make_train_step(model, opt, make_lr_schedule(cfg, 1), cfg,
                           ema=ema, sentinel=sentinel,
                           loss_scale=lambda: 0.25)
    plain_cfg = dataclasses.replace(cfg, sentinel=False)
    plain = build_model(plain_cfg)
    plain.load_state_dict(model.state_dict())
    popt, pema = init_train_state(plain_cfg, plain, "cpu")
    pstep = make_train_step(plain, popt, make_lr_schedule(plain_cfg, 1),
                            plain_cfg, ema=pema)
    for i in range(2):
        arrs = [torch.from_numpy(a)
                for a in synthetic_target_batch(2, 64, seed=i)]
        a, b = step(i, *arrs), pstep(i, *arrs)
        assert float(a["sentinel_scale"]) == 0.25
        for k in ("hm", "offset", "size", "total"):
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-6)
    for (n, p), q in zip(model.named_parameters(), plain.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=n)
    for t, u in zip(ema.tensors, pema.tensors):
        np.testing.assert_allclose(t.numpy(), u.numpy(), rtol=1e-6,
                                   atol=1e-9)


MONITOR_WINDOWS = [
    [1, 0], [1, 0], [0, 0, 0, 0], [0], [0], [1, 1, 0, 1],
    [1, 1], [0] * 3, [1] * 2,
]


@pytest.mark.parametrize("backoff,divergence", [(0.5, 3), (0.25, 10),
                                                (1.0, 2)])
def test_monitor_matches_jax(backoff, divergence):
    """The same flag windows through JAX's `SentinelMonitor` and the
    port's: the same scale, skip count and consecutive count after each
    window, the raise at the same window, the same reset on a rollback;
    and the port's counters on its metrics registry."""
    kw = dict(sentinel=True, sentinel_backoff=backoff,
              sentinel_divergence=divergence)
    jm, pm = JaxMonitor(JaxConfig(**kw)), SentinelMonitor(Config(**kw))
    reg = default_registry()
    skipped0 = reg.counter("train.skipped_steps").value
    raised = []
    for w, flags in enumerate(MONITOR_WINDOWS + [[1] * 40]):
        window = [{"sentinel_bad": float(f)} for f in flags]
        outcome = []
        for mon, err in ((jm, JaxDivergence), (pm, TrainingDivergenceError)):
            try:
                mon.observe(window)
                outcome.append(None)
            except err as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], w
        if outcome[0]:
            raised.append(w)
            jm.note_rollback()
            pm.note_rollback()
        assert (jm.scale, jm.skipped, jm.consecutive_bad, jm.rollbacks) == \
            (pm.scale, pm.skipped, pm.consecutive_bad, pm.rollbacks), w
    assert raised and pm.scale == 1.0
    assert reg.counter("train.skipped_steps").value - skipped0 == pm.skipped
    assert reg.gauge("train.loss_scale").value == pm.scale


def test_divergence_rolls_back_to_the_last_checkpoint(voc, tmp_path,
                                                      capsys, monkeypatch):
    """Epoch 0 clean (4 steps of batch 2), then every batch NaN: epoch 1
    reaches `--sentinel-divergence` 3 consecutive skips, the run restores
    check_point_1 — the model bit for bit its state there — and reruns
    the epoch, twice (`--sentinel-rollbacks 2`), then raises."""
    from real_time_helmet_detection_tpu_torch import train as train_mod
    real_stage, real_restore = train_mod.stage, train_mod.restore
    staged, restored = [0], []

    def poisoning_stage(batch, device):
        arrays = real_stage(batch, device)
        staged[0] += 1
        if staged[0] > 4:
            arrays = (torch.full_like(arrays[0], float("nan")),) + arrays[1:]
        return arrays

    def recording_restore(ckpt, model, optimizer, ema):
        real_restore(ckpt, model, optimizer, ema)
        restored.append({n: t.clone() for n, t in model.state_dict().items()})

    monkeypatch.setattr(train_mod, "stage", poisoning_stage)
    monkeypatch.setattr(train_mod, "restore", recording_restore)
    save = str(tmp_path / "w")
    with pytest.raises(TrainingDivergenceError, match="consecutive"):
        train_cli(voc, save, "--sentinel", "--sentinel-divergence", "3",
                  "--sentinel-rollbacks", "2", "--batch-size", "2", epochs=3)
    out = capsys.readouterr().out
    assert "rollback 1/2" in out and "rollback 2/2" in out
    assert sorted(os.listdir(save)) == ["argument.json", "argument.txt",
                                        "check_point_1", "training_log"]
    ck = load_checkpoint(os.path.join(save, "check_point_1"))
    assert ck["step"] == 4 and len(restored) == 2
    for state in restored:
        assert sorted(state) == sorted(ck["state_dict"])
        for n, t in ck["state_dict"].items():
            assert torch.equal(state[n], t), n


def test_sentinel_refuses_sub_divisions(voc, tmp_path):
    """(The refusal is lifted.) `--sentinel --sub-divisions k` is taken
    as JAX's Config takes it, and the train CLI runs it: 8 images at
    batch 4 are an epoch of 2 micro-steps, one window of 3 is flushed at
    its end, so each epoch takes one update and its checkpoint counts
    them (tests/test_torch_sentinel_subdiv.py holds the steps to
    JAX's)."""
    cfg = Config(sentinel=True, sub_divisions=2)
    jcfg = JaxConfig(sentinel=True, sub_divisions=2)
    assert (cfg.sentinel, cfg.sub_divisions) \
        == (jcfg.sentinel, jcfg.sub_divisions)
    Config(sentinel=True, grad_accum=2)
    save = str(tmp_path / "w")
    train_cli(voc, save, "--sentinel", "--sub-divisions", "3", epochs=2)
    ck = load_checkpoint(os.path.join(save, "check_point_2"))
    assert ck["step"] == 2 and len(ck["loss_log"]["total"]) == 4
