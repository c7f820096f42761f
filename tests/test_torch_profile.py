"""`--profile` on the CPU: the train CLI traces steps 2-7 of its first
epoch with torch.profiler into `<save_path>/trace` (ref
train.py:1634-1668), and tracing changes nothing the run computes.

* the trace is `<save>/trace/trace.json`, written into a temp dir that is
  then renamed (no temp dir left), its path printed; it holds exactly
  the ProfilerStep markers of steps 2-7 and CPU activity inside them;
* an epoch shorter than 8 steps closes its trace at the epoch's end;
* the losses and every tensor of the checkpoint are bit-equal to the
  same run without `--profile`.
"""

import json
import os

import torch

from real_time_helmet_detection_tpu_torch.__main__ import main
from real_time_helmet_detection_tpu_torch.data.synthetic import \
    make_synthetic_voc

from test_torch_train import one_torch_thread  # noqa: F401 (autouse)


def train(root, save, *extra):
    main(["--train-flag", "--device", "cpu", "--data", root,
          "--batch-size", "2", "--end-epoch", "1", "--hourglass-inch", "8",
          "--multiscale", "32", "64", "32", "--num-workers", "0",
          "--print-interval", "4", "--no-summary", "--save-path", save,
          *extra])
    return torch.load(os.path.join(save, "check_point_1", "checkpoint.pt"),
                      map_location="cpu", weights_only=False)


def markers(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted({int(e["name"].split("#", 1)[1]) for e in events
                   if e.get("name", "").startswith("ProfilerStep#")}), events


def test_profile_traces_steps_2_to_7_and_changes_nothing(tmp_path, capsys):
    root = make_synthetic_voc(str(tmp_path / "voc"), num_train=18,
                              num_test=0, imsize=(96, 72), seed=3)
    plain = train(root, str(tmp_path / "plain"))
    save = str(tmp_path / "prof")
    traced = train(root, save, "--profile")
    out = capsys.readouterr().out
    trace_dir = os.path.join(save, "trace")
    assert "profiler trace -> %s" % trace_dir in out
    assert os.listdir(trace_dir) == ["trace.json"]
    assert not [d for d in os.listdir(save) if ".tmp-" in d]
    steps, events = markers(os.path.join(trace_dir, "trace.json"))
    assert steps == [2, 3, 4, 5, 6, 7]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert traced["loss_log"] == plain["loss_log"]
    a, b = traced["state_dict"], plain["state_dict"]
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_short_epoch_closes_its_trace(tmp_path, capsys):
    root = make_synthetic_voc(str(tmp_path / "voc"), num_train=8,
                              num_test=0, imsize=(96, 72), seed=3)
    save = str(tmp_path / "w")
    train(root, save, "--profile")
    steps, _ = markers(os.path.join(save, "trace", "trace.json"))
    assert steps == [2, 3]  # 4 steps in the epoch
