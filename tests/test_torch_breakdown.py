"""The port's component breakdown (`obs/breakdown.py`) against the JAX
package's `scripts/mfu_breakdown.py`, on the CPU: JAX's components and
record keys; `--analytic` counts every component at the flagship's
shapes on `meta` with no card, with the roofline count's FLOPs and
bytes; the records' arithmetic; a CPU run at JAX's off-chip shapes
carries no device metric; no card without `--device cpu`."""

import json
import os
import re

import pytest
import torch

from real_time_helmet_detection_tpu_torch.obs import breakdown as B
from real_time_helmet_detection_tpu_torch.obs import roofline as R
from tests.test_torch_train import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SRC = os.path.join(REPO, "scripts", "mfu_breakdown.py")
CONST = R.card_constants(R.TARGET_CARD)


def jax_components():
    src = open(JAX_SRC).read()
    return set(re.findall(r'measure\(\s*"(\w+)"', src)) | set(
        re.findall(r'\["components"\]\["(\w+)"\]', src))


def test_components_are_jax_s():
    assert set(B.COMPONENTS) == jax_components()


@pytest.fixture(scope="module")
def analytic(tmp_path_factory):
    out = tmp_path_factory.mktemp("bd") / "a.json"
    return B.main(["--analytic", "--out", str(out)]), out


def test_analytic_on_meta_at_flagship_shapes(analytic):
    rec, path = analytic
    assert json.load(open(path)) == rec
    assert rec["analytic"] and rec["imsize"] == 512 and rec["batch"] == 16
    assert rec["device_kind"] == "meta" and rec["card"] is None
    assert rec["constants_of"] == R.TARGET_CARD
    assert set(rec["components"]) == set(B.COMPONENTS)
    keys = {"gflops", "t_mxu_ms", "gbytes", "t_hbm_ms", "t_roofline_ms",
            "roofline_mfu", "binds"}
    for name, c in rec["components"].items():
        assert "ms" not in c and "mfu" not in c
        want = keys if name != "upsample2x_64sq" else {"gbytes", "t_hbm_ms"}
        assert set(c) == want, name
    conv = rec["components"]["conv3x3_128ch_128sq"]
    assert conv["gflops"] == round(2 * 16 * 128 * 128 * 128 * 9 * 128 / 1e9,
                                   2)
    assert conv["binds"] == "mxu"
    s2d, direct = (rec["components"][k] for k in ("conv7x7s2_s2d",
                                                  "conv7x7s2_3to64"))
    assert s2d["gflops"] > direct["gflops"]  # the 8x8 kernel's zero taps


def test_train_step_is_the_roofline_count(analytic):
    rec, _ = analytic
    args = R.build_parser().parse_args(["--device", "cpu"])
    rows, _ = R.count_rows(R.build_step(args, "meta"))
    fl = sum(r["flops"] for r in rows)
    by = sum(r["bytes"] for r in rows)
    assert rec["components"]["train_step"] == B.analytic_rec(fl, by, CONST)


def test_analytic_rec_arithmetic():
    r = B.analytic_rec(989.4e9, 3.35e9 * 2, CONST)
    assert r["t_mxu_ms"] == 1.0 and r["t_hbm_ms"] == 2.0
    assert r["t_roofline_ms"] == 2.0 and r["roofline_mfu"] == 0.5
    assert r["binds"] == "hbm"
    assert B.analytic_rec(0.0, 1e9, CONST) == {
        "gbytes": 1.0, "t_hbm_ms": round(1e9 / 3.35e12 * 1e3, 4)}


def test_cpu_run_has_no_device_metric():
    out = B.breakdown("cpu", names=("head_fwd", "upsample2x_64sq"))
    assert out["platform"] == "cpu" and (out["imsize"], out["batch"]) == \
        (64, 2)
    for rec in out["components"].values():
        assert rec["timing"] == "host" and rec["ms"] > 0
        assert "mfu" not in rec and "hbm_util" not in rec


def test_wants_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        B.breakdown("cuda", names=("head_fwd",))
