"""The port's training runtime on the CPU: errors and recovery,
checkpoints, background eval, and the refusals, against the JAX
package where it defines the behaviour.

* The transient-error classifier gives JAX's verdict on a table of
  exception types and messages; `FaultInjector` fires where JAX's does.
* `HangWatchdog` mirrors tests/test_watchdog.py: it warns once on a
  stall, stays silent while beaten or paused, re-arms after a resume,
  is off at 0, mirrors its beats to a heartbeat file and appends its
  status line.
* `--async-ckpt`: the checkpoint's tensors are bit-equal to a
  synchronous one of the same state; `--keep-ckpt` / `--ckpt-interval`
  leave the dirs JAX's rule leaves (one more under `--async-ckpt`).
* `--fault-inject 1:1 --auto-resume 1 --resume-backoff-s 0` ends with
  the weights and the loss log of a clean run, bit for bit; a fault
  with nothing to resume from raises.
* The chaos sites: `train:batch=nan-batch` under `--sentinel` is a
  skipped step; `train:rank=worker-death` raises the transient
  `UNAVAILABLE:` and `--auto-resume` recovers from it.
* `--async-eval` (a `--device cpu` subprocess, its source importing only
  the port) scores each checkpoint it takes with the mAP the eval CLI
  gives it (within 1e-3; the same device, so observed equal); a
  boundary that finds an eval running is skipped and counted; its
  environment drops the heartbeat path.
* The refusal matrix of the new flags is JAX's: each combination JAX
  refuses (in its Config or at the top of its `train`) the port
  refuses.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu import train as jax_train
from real_time_helmet_detection_tpu.config import Config as JaxConfig
from real_time_helmet_detection_tpu.runtime import errors as jax_errors
from real_time_helmet_detection_tpu_torch.__main__ import main
from real_time_helmet_detection_tpu_torch.config import Config
from real_time_helmet_detection_tpu_torch.convert import load_npz
from real_time_helmet_detection_tpu_torch.data.synthetic import \
    make_synthetic_voc
from real_time_helmet_detection_tpu_torch.evaluate import init_weights
from real_time_helmet_detection_tpu_torch.models.hourglass import \
    build_model
from real_time_helmet_detection_tpu_torch.ops.loss import LossLog
from real_time_helmet_detection_tpu_torch.runtime import errors
from real_time_helmet_detection_tpu_torch.runtime.faults import (
    ChaosInjector, FaultSchedule)
from real_time_helmet_detection_tpu_torch.runtime.heartbeat import (
    HEARTBEAT_ENV, HangWatchdog, heartbeat_age_s, read_heartbeat)
from real_time_helmet_detection_tpu_torch.train import (
    AsyncEvaluator, CheckpointWriter, FaultInjector, init_train_state,
    load_checkpoint, save_checkpoint, train)

from test_torch_train import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    return make_synthetic_voc(str(tmp_path_factory.mktemp("voc")),
                              num_train=8, num_test=4, seed=0)


ARGS = ["--device", "cpu", "--hourglass-inch", "8", "--stem-width", "8",
        "--batch-size", "4", "--multiscale", "32", "64", "32",
        "--print-interval", "1", "--num-workers", "2", "--lr", "2e-3",
        "--hang-warn-seconds", "0"]


def train_cli(voc, out, *extra, epochs=2):
    main(["--train-flag", "--data", voc, *ARGS, "--end-epoch", str(epochs),
          "--save-path", out, *extra])


def cfg_of(voc, out, *extra, epochs=2):
    from real_time_helmet_detection_tpu_torch.config import parse_args
    return parse_args(["--train-flag", "--data", voc, *ARGS, "--end-epoch",
                       str(epochs), "--save-path", out, *extra])


def assert_weights_equal(a, b):
    wa, wb = load_npz(a), load_npz(b)
    from real_time_helmet_detection_tpu_torch.convert import flatten_tree
    fa, fb = flatten_tree(wa), flatten_tree(wb)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


# ------------------------------------------------------------ classifier


class XlaRuntimeError(RuntimeError):
    """A stand-in with XLA's error type name."""


CASES = [
    (RuntimeError, "UNAVAILABLE: socket closed"),
    (RuntimeError, "DEADLINE_EXCEEDED: fetch"),
    (RuntimeError, "Unable to initialize backend 'cuda'"),
    (RuntimeError, "grpc: Socket closed"),
    (RuntimeError, "INTERNAL: generic"),
    (XlaRuntimeError, "INTERNAL: tunnel died"),
    (RuntimeError, "bad connection string in the data loader"),
    (ValueError, "UNAVAILABLE: not a backend type"),
    (OSError, "DEADLINE_EXCEEDED: not a backend type"),
    (RuntimeError, "CUDA error: an illegal memory access was encountered"),
]


@pytest.mark.parametrize("kind,msg", CASES)
def test_classifier_matches_jax(kind, msg):
    e = kind(msg)
    assert errors.is_transient_backend_error(e) == \
        jax_errors.is_transient_backend_error(e)
    assert errors.classify_exception(e) == jax_errors.classify_exception(e)
    assert errors.classify_error_text(msg) == \
        jax_errors.classify_error_text(msg)
    injected = errors.InjectedBackendError("x")
    assert errors.classify_exception(injected) == "transient"
    assert errors.EXIT_TRANSIENT == jax_errors.EXIT_TRANSIENT == 75


@pytest.mark.parametrize("spec", ["", "1:2", "0:0"])
def test_fault_injector_matches_jax(spec):
    fired = []
    for cls, pkg in ((FaultInjector, errors),
                     (jax_train.FaultInjector, jax_errors)):
        inj, hits = cls(spec), []
        for epoch in range(3):
            for i in range(4):
                try:
                    inj.maybe_fire(epoch, i)
                except pkg.InjectedBackendError as e:
                    assert pkg.is_transient_backend_error(e)
                    hits.append((epoch, i, str(e)))
        fired.append(hits)
    assert fired[0] == fired[1] and len(fired[0]) == (1 if spec else 0)
    with pytest.raises(ValueError, match="EPOCH:ITER"):
        FaultInjector("3")


# -------------------------------------------------------------- watchdog


def _wait_for(pred, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def test_watchdog_warns_once_on_stall_with_status(capsys):
    wd = HangWatchdog(0.3, where="test")
    wd.set_status_fn(lambda: "loader workers: w0=up")
    try:
        assert _wait_for(lambda: wd._warned)
        time.sleep(0.3)
    finally:
        wd.stop()
    out = capsys.readouterr().out
    assert out.count("WATCHDOG: no test progress") == 1
    assert "last: start" in out and "| loader workers: w0=up" in out


def test_watchdog_beats_and_pause(capsys):
    wd = HangWatchdog(0.6, where="test")
    try:
        for _ in range(6):
            wd.beat("step")
            time.sleep(0.15)
        assert not wd._warned
        wd.pause("checkpoint")
        time.sleep(1.0)
        assert not wd._warned and wd._paused
        wd.resume("ckpt done")
        assert _wait_for(lambda: wd._warned)
    finally:
        wd.stop()
    assert "last: ckpt done" in capsys.readouterr().out
    off = HangWatchdog(0)
    assert off._thread is None
    off.beat("x")
    off.stop()


def test_watchdog_mirrors_beats_to_file(tmp_path):
    path = str(tmp_path / "hb.json")
    wd = HangWatchdog(0, beat_file=path)
    try:
        assert read_heartbeat(path)["label"] == "start"
        wd.beat("iter 5")
        assert read_heartbeat(path)["label"] == "iter 5"
        wd.pause("ckpt")
        assert read_heartbeat(path)["label"] == "paused: ckpt"
        wd.resume("ckpt done")
        assert read_heartbeat(path)["label"] == "ckpt done"
        assert 0.0 <= heartbeat_age_s(path) < 60.0
    finally:
        wd.stop()
    assert read_heartbeat(str(tmp_path / "none.json")) is None
    assert heartbeat_age_s(str(tmp_path / "none.json")) is None


# ------------------------------------------------------------ checkpoints


def test_async_checkpoint_equals_sync(tmp_path):
    cfg = Config(device="cpu", hourglass_inch=8, stem_width=8,
                 ema_decay=0.9)
    model = init_weights(build_model(cfg), 3)
    opt, ema = init_train_state(cfg, model, "cpu")
    opt.init_state()
    log = LossLog({"hm": [1.0], "offset": [2.0], "size": [3.0],
                   "total": [4.0]})
    sync = save_checkpoint(str(tmp_path / "sync"), 2, 7, model, opt, log,
                           ema)
    writer = CheckpointWriter(async_save=True)
    path = writer.save(str(tmp_path / "async"), 2, 7, model, opt, log, ema)
    # the state moves on while the save is in flight: the snapshot holds
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    writer.finalize()
    a, s = load_checkpoint(path), load_checkpoint(sync)
    assert (a["epoch"], a["step"], a["loss_log"]) == \
        (s["epoch"], s["step"], s["loss_log"])
    for part in ("state_dict", "ema"):
        assert sorted(a[part]) == sorted(s[part])
        for k in s[part]:
            assert torch.equal(a[part][k], s[part][k]), (part, k)
    for k, v in s["optimizer"]["state"].items():
        for name, t in v.items():
            assert torch.equal(a["optimizer"]["state"][k][name], t)
    for name in ("weights.npz", "ema.npz"):
        assert_weights_equal(os.path.join(path, name),
                             os.path.join(sync, name))


@pytest.mark.parametrize("async_ckpt,left", [
    (False, ["check_point_5"]), (True, ["check_point_4", "check_point_5"])])
def test_retention_and_interval(voc, tmp_path, async_ckpt, left):
    """5 epochs, `--ckpt-interval 2 --keep-ckpt 1`: saves after epochs
    1, 3 and 4 (the last is always saved); one is kept, two under
    `--async-ckpt`. A previous run's checkpoint is never removed."""
    out = str(tmp_path / "w")
    os.makedirs(os.path.join(out, "check_point_9"))
    extra = ["--ckpt-interval", "2", "--keep-ckpt", "1"]
    if async_ckpt:
        extra.append("--async-ckpt")
    train_cli(voc, out, *extra, epochs=5)
    assert sorted(d for d in os.listdir(out) if d.startswith("check")) \
        == sorted(left + ["check_point_9"])
    assert load_checkpoint(os.path.join(out, "check_point_5"))["step"] == 10


def test_auto_resume_bit_equal_to_clean_run(voc, tmp_path, capsys):
    clean, faulty = str(tmp_path / "clean"), str(tmp_path / "faulty")
    train_cli(voc, clean)
    train_cli(voc, faulty, "--fault-inject", "1:1", "--auto-resume", "1",
              "--resume-backoff-s", "0")
    out = capsys.readouterr().out
    assert "recovery 1/1" in out and "auto-resumed from" in out
    assert_weights_equal(os.path.join(clean, "check_point_2", "weights.npz"),
                         os.path.join(faulty, "check_point_2",
                                      "weights.npz"))
    a = load_checkpoint(os.path.join(clean, "check_point_2"))
    b = load_checkpoint(os.path.join(faulty, "check_point_2"))
    assert a["loss_log"] == b["loss_log"] and a["step"] == b["step"] == 4
    # a fault before the first checkpoint restarts from the entry state
    early = str(tmp_path / "early")
    train_cli(voc, early, "--fault-inject", "0:1", "--auto-resume", "1",
              "--resume-backoff-s", "0", epochs=1)
    assert "restarted from its entry state" in capsys.readouterr().out
    assert_weights_equal(os.path.join(clean, "check_point_1", "weights.npz"),
                         os.path.join(early, "check_point_1", "weights.npz"))
    # no budget: the injected fault propagates
    with pytest.raises(errors.InjectedBackendError):
        train_cli(voc, str(tmp_path / "raise"), "--fault-inject", "0:0",
                  epochs=1)


def test_chaos_sites(voc, tmp_path, capsys):
    nan = ChaosInjector(FaultSchedule.parse("train:batch=nan-batch@2"))
    out = train(cfg_of(voc, str(tmp_path / "nan"), "--sentinel",
                       epochs=1), chaos=nan)
    assert out["monitor"].skipped == 1 and out["step"] == 1
    assert [e.kind for e in nan.fired] == ["nan-batch"]
    death = ChaosInjector(FaultSchedule.parse("train:rank=worker-death@3"))
    with pytest.raises(errors.InjectedBackendError, match="UNAVAILABLE"):
        train(cfg_of(voc, str(tmp_path / "dead")), chaos=death)
    death = ChaosInjector(FaultSchedule.parse("train:rank=worker-death@3"))
    out = train(cfg_of(voc, str(tmp_path / "back"), "--auto-resume", "1",
                       "--resume-backoff-s", "0"), chaos=death)
    assert out["step"] == 4
    train_cli(voc, str(tmp_path / "clean"))
    assert_weights_equal(
        str(tmp_path / "clean" / "check_point_2" / "weights.npz"),
        str(tmp_path / "back" / "check_point_2" / "weights.npz"))


def test_async_eval_matches_eval_cli(voc, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(HEARTBEAT_ENV, str(tmp_path / "hb.json"))
    out = str(tmp_path / "w")
    res = train(cfg_of(voc, out, "--async-eval"))
    ev = res["evaluator"]
    # one eval in flight at a time: a boundary that finds one running is
    # skipped and counted
    assert ev.completed and len(ev.completed) + ev.skipped == 2
    for rec in ev.completed:
        assert rec["ok"], rec
        ck = os.path.join(out, "check_point_%d" % (rec["epoch"] + 1))
        eout = str(tmp_path / ("e%d" % rec["epoch"]))
        main(["--data", voc, "--device", "cpu", "--imsize", "64",
              "--hourglass-inch", "8", "--stem-width", "8",
              "--batch-size", "2", "--model-load", ck, "--save-path", eout])
        line = [ln for ln in capsys.readouterr().out.splitlines()
                if ": mAP " in ln][-1]
        assert abs(float(line.split(": mAP ")[1].split()[0])
                   - rec["map"]) <= 1e-3
    spec = AsyncEvaluator(Config(device="cpu")).eval_config("ck", "out")
    assert spec["train_flag"] is False and spec["async_eval"] is False
    # the subprocess never beat the trainer's heartbeat
    assert read_heartbeat(str(tmp_path / "hb.json"))["pid"] == os.getpid()


# --------------------------------------------------------------- refusals


REFUSALS = [
    dict(grad_accum=2, device_augment=True),
    dict(cache_device=True),
    dict(async_eval=True, async_ckpt=True),
    dict(async_eval=True, data="/nonexistent/voc"),
    dict(auto_resume=1, async_ckpt=True),
]


def jax_refuses(voc, tmp_path, kw):
    """Does JAX refuse `kw`, in its Config or at the top of `train` (run
    for 0 epochs, so nothing trains if it does not)?"""
    base = dict(train_flag=True, data=voc, hourglass_inch=8,
                multiscale=[32, 64, 32], batch_size=4, end_epoch=0,
                save_path=str(tmp_path / "jax"), num_devices=1)
    try:
        cfg = JaxConfig(**{**base, **kw})
        jax_train.train(cfg)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("kw", REFUSALS, ids=lambda kw: ",".join(kw))
def test_refusals_match_jax(voc, tmp_path, kw):
    want = jax_refuses(voc, tmp_path, kw)
    assert want is not None
    base = dict(train_flag=True, data=voc, device="cpu", batch_size=4)
    with pytest.raises(ValueError) as got:
        Config(**{**base, **kw})
    # the same reason, in JAX's words
    assert str(got.value).split(" (")[0][:40] == want.split(" (")[0][:40]


@pytest.mark.parametrize("flag", ["async_ckpt", "auto_resume",
                                  "cache_device"])
def test_multi_process_refusals(flag):
    kw = {flag: 1 if flag == "auto_resume" else True, "world_size": 2,
          "rank": 1, "device_augment": flag == "cache_device",
          "train_flag": True}
    with pytest.raises(ValueError, match="single-process only"):
        Config(**kw)
    Config(**dict(kw, world_size=1, rank=0))


def test_combinations_jax_accepts_parse():
    for kw in (dict(device_augment=True, cache_device=True, prewarm=True),
               dict(async_ckpt=True, keep_ckpt=2, ckpt_interval=3),
               dict(loader="process", device_prefetch=2, telemetry=True),
               dict(auto_resume=2, resume_backoff_s=0.0,
                    fault_inject="1:2", async_eval=True)):
        Config(**kw)
        JaxConfig(**kw)
    Config(cache_device=True, async_ckpt=True, auto_resume=1)  # not a run
    with pytest.raises(ValueError, match="--loader"):
        Config(loader="fork")
    with pytest.raises(ValueError, match="--device-prefetch"):
        Config(device_prefetch=-1)
    assert dataclasses.asdict(Config())["hang_warn_seconds"] == \
        JaxConfig().hang_warn_seconds
