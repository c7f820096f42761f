"""The port's roofline attribution (`obs/roofline.py`) against the JAX
package's `scripts/roofline.py`, on the CPU:

* `op_class`, `class_totals`, `classify` and `diff_rooflines` equal
  JAX's on the same rows, the committed artifacts/r07/roofline/*.json
  among them (`classify`'s bound reads "tensor" where JAX's reads
  "mxu");
* the conv and dot FLOPs of one predict and one train step at imsize 64,
  width 32, batch 2 equal JAX's `parse_hlo` + `attribute` count of
  `build_predict` / `build_step` (one scanned step; the compiled module
  printed with its operand shapes, which this XLA leaves out by
  default and `_conv_flops` reads) within rel 1e-6, once XLA's rewrites
  are named: it runs the 1x1 convolutions as dots (same FLOPs) and cuts
  the window of a 3x3 convolution on a map smaller than 3x3 to the taps
  that touch the map, in the forward and in the backward's input
  gradient (not in its weight gradient);
* each epilogue and residual site's kernel bytes, at the flagship's
  512^2 b16 shapes on `meta`, equal JAX's `site_kernel_bytes` for the
  same sites; the hand kernels' rows launch as `chip_smoke.
  expected_launches` derives;
* `quality.cost.counts` gives what its own FlopCounterMode + ConvBytes
  model gave before it became a caller of this count;
* the CLI: JAX's flags and defaults less the refused TPU switches, which
  exit 2; no card without `--device cpu`; the artifact carries JAX's
  keys; `--diff` of JAX's committed artifacts;
* the timing's join: a device operation joins the label around its
  launch, by kernel name where it has none, else `unattributed`; busy is
  the union of the device ranges; on a CPU profile every counted
  operation lies in its own label, and the labels do not overlap.
"""

import argparse
import copy
import importlib.util
import json
import math
import os
import types

import pytest
import torch

import chip_smoke
from real_time_helmet_detection_tpu_torch.obs import roofline as R
from real_time_helmet_detection_tpu_torch.quality import cost
from tests.test_torch_train import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R07 = [os.path.join(REPO, "artifacts", "r07", "roofline", f)
       for f in ("roofline_cpu_b16_512_cost.json",
                 "roofline_cpu_b2_128_traced.json")]
SMALL = ["--batch", "2", "--imsize", "64", "--hourglass-inch", "32",
         "--device", "cpu"]
REFUSED = ("--platform", "--loss-kernel", "--epilogue", "--block-fuse",
           "--cpu")


@pytest.fixture(scope="module")
def jax_roofline():
    spec = importlib.util.spec_from_file_location(
        "jax_roofline", os.path.join(REPO, "scripts", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(path):
    with open(path) as f:
        return json.load(f)


# ------------------------------------------------------ dict arithmetic
def test_op_class_equals_jax(jax_roofline):
    cases = [(r["name"], r["opcode"]) for p in R07 for r in load(p)["fusions"]]
    cases += [("convolution(2x3x64x64:bf16)", "convolution"),
              ("_to_copy(64:f32)", "convert"), ("mm(2x3:f32)", "dot"),
              ("max_pool2d_with_indices(1:f32)", "reduce-window"),
              ("bn_act", "custom-call"), ("dot.4", "dot"),
              ("convert_convert_fusion", "fusion")]
    assert [R.op_class(*c) for c in cases] == \
        [jax_roofline.op_class(*c) for c in cases]


@pytest.mark.parametrize("path", R07, ids=os.path.basename)
def test_class_totals_equal_jax(jax_roofline, path):
    rows = load(path)["fusions"]
    assert R.class_totals(rows) == jax_roofline.class_totals(rows)


@pytest.mark.parametrize("path", R07, ids=os.path.basename)
def test_classify_equals_jax(jax_roofline, path):
    art = load(path)
    durations = {r["name"]: [r["time_us"] * 2, r.get("trace_calls", 1)]
                 for r in art["fusions"] if r.get("time_us") is not None}
    mine, theirs = (copy.deepcopy(art["fusions"]) for _ in range(2))
    got = R.classify(mine, art["peak_flops"], art["hbm_bytes_per_s"],
                     durations or None, steps=2)
    want = jax_roofline.classify(theirs, art["peak_flops"],
                                 art["hbm_bytes_per_s"], durations or None,
                                 steps=2)
    assert got == want
    for r in theirs:
        r["bound"] = {"mxu": "tensor"}.get(r["bound"], r["bound"])
    assert mine == theirs


def test_diff_equals_jax(jax_roofline):
    a, b = load(R07[0]), load(R07[1])
    assert R.diff_rooflines(a, b) == jax_roofline.diff_rooflines(a, b)
    assert R.diff_rooflines(b, a) == jax_roofline.diff_rooflines(b, a)
    assert R._diff_markdown(R.diff_rooflines(a, b)).splitlines()[:12] == \
        jax_roofline._diff_markdown(
            jax_roofline.diff_rooflines(a, b)).splitlines()[:12]
    with pytest.raises(ValueError, match="not a roofline-v1"):
        R.diff_rooflines(dict(a, schema="x"), b)


def test_diff_cli_reads_jax_artifacts(tmp_path, capsys):
    out = tmp_path / "d.json"
    d = R.main(["--diff", *R07, "--out", str(out)])
    assert d["schema"] == R.DIFF_SCHEMA and out.exists()
    assert (tmp_path / "d.md").exists()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["out"] == str(out)


# ------------------------------------------------------------ conv FLOPs
def jax_conv_dot(jax_roofline, mode):
    """JAX's conv + dot FLOPs of `mode` at imsize 64, width 32, batch 2."""
    import jax
    from jax._src.lib import xla_client
    args = types.SimpleNamespace(
        batch=2, imsize=64, num_stack=1, hourglass_inch=32, mode=mode,
        variant="residual", steps=1, remat="none", loss_kernel="auto",
        param_policy="fp32", epilogue="auto", block_fuse="auto",
        fwd_dtype="bf16")
    if mode == "predict":
        compiled, _ = jax_roofline.build_predict(jax, args)
    else:
        compiled = jax_roofline.build_step(jax, args, "auto")[0]
    opts = xla_client._xla.HloPrintOptions()
    opts.print_operand_shape = True
    opts.print_metadata = True
    text = compiled.runtime_executable().hlo_modules()[0].to_string(opts)
    rows = jax_roofline.attribute(*jax_roofline.parse_hlo(text))
    cls = jax_roofline.class_totals(rows)
    return (cls["conv"]["flops"] + cls["dot"]["flops"]) / args.steps


def xla_window_cut(rows, passes):
    """The FLOPs XLA leaves out of the port's count by cutting the window
    of each convolution on a map smaller than its kernel to the taps that
    touch the map, in `passes` convolutions per forward one."""
    cut = 0.0
    for r in rows:
        if not r["name"].startswith("convolution("):
            continue
        (x, _), (w, _) = r["operands"][:2]
        taps = min(w[2], x[2]) * min(w[3], x[3])
        cut += r["flops"] * (1.0 - taps / (w[2] * w[3])) * passes
    return cut


@pytest.mark.parametrize("mode", ["predict", "train"])
def test_conv_flops_equal_jax_count(jax_roofline, mode):
    args = R.build_parser().parse_args(SMALL + ["--mode", mode])
    build = R.build_predict if mode == "predict" else R.build_step
    rows, _ = R.count_rows(build(args, "meta"))
    port = sum(r["flops"] for r in rows if r["class"] in ("conv", "dot"))
    assert all(not r["approx"] for r in rows if r["class"] == "conv")
    want = jax_conv_dot(jax_roofline, mode)
    # forward only in predict; the forward and the input gradient in train
    got = port - xla_window_cut(rows, 1 if mode == "predict" else 2)
    assert got == pytest.approx(want, rel=1e-6)
    assert port > want  # the cut is real: maps of 2x2 and 1x1 at imsize 64


# ------------------------------------------------ hand kernels, flagship
@pytest.fixture(scope="module")
def flagship_counts():
    out = {}
    for mode in ("predict", "train"):
        args = R.build_parser().parse_args(["--mode", mode, "--device",
                                            "cpu"])
        build = R.build_predict if mode == "predict" else R.build_step
        out[mode] = R.count_rows(build(args, "meta"))
    return out


# activation-sized transfers of each BN kernel's call (chip_smoke's rule)
SITE_MOVES = {"bn_act": 2, "bn_add_act": 3, "bn_stats": 1, "bn_bwd_sums": 2,
              "bn_add_bwd_sums": 3, "bn_bwd_dx": 3, "bn_add_bwd_dx": 5}


def test_site_bytes_equal_jax_site_kernel_bytes(flagship_counts):
    """Per site shape (elements, itemsize): the port's BN kernels' bytes
    add up to JAX's `site_kernel_bytes` of the sites at that shape (the
    forward call, #2/#5 or #8, marks a site of its family); each call
    moves its rule's activation-sized tensors."""
    from real_time_helmet_detection_tpu.ops.pallas import epilogue, residual
    family = {"bn_act": epilogue, "bn_add_act": residual}
    for mode, kind in (("predict", "eval"), ("train", "train")):
        calls = flagship_counts[mode][1].kernel_calls
        bn = [c for c in calls if c[0] in SITE_MOVES]
        assert all(b == SITE_MOVES[n] * e * s for n, e, s, b in bn)
        keys = {(e, s) for n, e, s, _ in bn if n in family}
        assert {(e, s) for _, e, s, _ in bn} == keys
        for key in keys:
            want = sum(family[n].site_kernel_bytes(kind, *key)
                       for n, e, s, _ in bn
                       if n in family and (e, s) == key)
            got = sum(b for _, e, s, b in bn if (e, s) == key)
            assert got == want, (mode, key)


def test_kernel_rows_launch_as_derived(flagship_counts):
    from real_time_helmet_detection_tpu_torch.config import Config
    for mode, path in (("predict", "predict"), ("train", "train")):
        rows, _ = flagship_counts[mode]
        got = {r["name"]: r["calls"] for r in rows if r.get("kernel")}
        want = {k: v for k, v in chip_smoke.expected_launches(
            Config(amp=True, imsize=512), path, torch.bfloat16).items()
            if v and k in R.KERNELS}
        assert got == want
        assert all(r["opcode"] == "custom-call" for r in rows
                   if r.get("kernel"))


def test_no_plain_version_rows(flagship_counts):
    """The plain versions' operations on the CPU / meta are no rows: no
    row at an activation's shape but the network's own ops."""
    rows, _ = flagship_counts["train"]
    names = [r["name"] for r in rows]
    assert not any(n.startswith(("var_mean", "native_batch_norm", "pow(",
                                 "sigmoid(16x1x128x128"))
                   for n in names), names
    assert not any(n.startswith("clone(16x") for n in names)


# ------------------------------------------------- quality/cost.counts
class _OldConvBytes(torch.utils._python_dispatch.TorchDispatchMode):
    """quality/cost.py's ConvBytes before it called the roofline count."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.convolution.default:
            x, w, b = args[:3]
            self.bytes += cost.ACT_BYTES * (x.numel() + w.numel()
                                            + out.numel())
            if b is not None:
                self.bytes += cost.PARAM_BYTES * b.numel()
        return out


@pytest.mark.parametrize("tier", ["edge", "throughput", "quality"])
def test_cost_counts_unchanged(tier):
    from torch.utils.flop_counter import FlopCounterMode

    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        build_model
    cfg = cost.preset_config(tier, 64)
    got = cost.counts(cfg, 64)
    with torch.device("meta"):
        model = build_model(cfg).eval()
    with FlopCounterMode(display=False) as fc, _OldConvBytes() as cb, \
            torch.no_grad():
        model(torch.empty(1, 64, 64, 3, device="meta"))
    flops = fc.get_flop_counts()["Global"]
    assert got["predict_gflops"] == round(fc.get_total_flops() / 1e9, 3)
    assert got["conv_flops"] == int(sum(v for k, v in flops.items()
                                        if "convolution" in str(k)))
    assert got["conv_bytes"] == cb.bytes > 0


# -------------------------------------------------------------- the CLI
def jax_parser(jax_roofline, monkeypatch):
    class Got(Exception):
        pass

    def grab(self, args=None, namespace=None):
        raise Got(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Got) as e:
        jax_roofline.main()
    monkeypatch.undo()
    return e.value.args[0]


def test_cli_flags_equal_jax_less_refused(jax_roofline, monkeypatch):
    theirs = {a.dest: (a.option_strings, a.default, a.choices)
              for a in jax_parser(jax_roofline, monkeypatch)._actions
              if not set(a.option_strings) & set(REFUSED + ("-h",))}
    mine = {a.dest: (a.option_strings, a.default, a.choices)
            for a in R.build_parser()._actions
            if a.dest not in ("help", "device")}
    assert mine == theirs
    for flag in REFUSED:
        with pytest.raises(SystemExit) as e:
            R.build_parser().parse_args([flag, "x"])
        assert e.value.code == 2


def test_cli_wants_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        R.main(["--no-trace", "--batch", "1", "--imsize", "64"])


@pytest.mark.parametrize("mode", ["train", "predict"])
def test_cpu_artifact_carries_jax_keys(mode, tmp_path, capsys):
    out = tmp_path / "r.json"
    meta = R.main(SMALL + ["--mode", mode, "--out", str(out),
                           "--ab-loss-kernel", "--top", "5"])
    art = load(out)
    jax_art = load(R07[1])
    assert set(jax_art) <= set(art) and art["schema"] == R.SCHEMA
    assert art["platform"] == "cpu" and art["card"] is None
    assert art["trace"].startswith("not measured")
    row_keys = set(jax_art["fusions"][0]) - {"trace_calls"}
    assert all(row_keys <= set(r) for r in art["fusions"])
    assert all(r["time_us"] is None for r in art["fusions"])
    assert set(jax_art["summary"]) <= set(art["summary"])
    assert "mfu" not in art["summary"]  # no device metric off the card
    assert set(art["summary"]["by_class"]) == set(R.OP_CLASSES)
    assert (tmp_path / "r.md").read_text().startswith("# Roofline")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["n_ops"] == len(art["fusions"]) == len(meta["fusions"])
    if mode == "train":
        ab = art["loss_kernel_ab"]
        assert {"step_xla", "step_fused", "loss_only_xla",
                "loss_only_fused", "fused_bytes_basis",
                "loss_bytes_delta_pct"} <= set(ab)
        assert ab["loss_only_fused"]["kernel_bytes_analytic"] > 0
        # the fused kernels move fewer bytes than the composition
        assert ab["loss_bytes_delta_pct"] > 0
    else:
        assert "loss_kernel_ab" not in art


def test_card_constants_refuse_an_unlisted_card():
    assert R.card_constants("NVIDIA H100 80GB HBM3")["bf16"] == 989.4e12
    with pytest.raises(ValueError, match="NVIDIA A100"):
        R.card_constants("NVIDIA A100-SXM4-80GB")


def test_l2_flag_and_per_dtype_peak():
    const = R.card_constants(R.TARGET_CARD)
    rows = [dict(name="a", opcode="convolution", flops=1e12, bytes=1e6,
                 calls=1, peak_dtype="bf16"),
            dict(name="b", opcode="add", flops=1e6, bytes=2e9, calls=10,
                 peak_dtype="fp32"),
            dict(name="c", opcode="add", flops=1e6, bytes=2e9, calls=100,
                 peak_dtype="fp32"),
            # 60 MB a call, 40 MB of it operands: one may be in the L2
            dict(name="d", opcode="add", flops=1e6, bytes=6e8, calls=10,
                 operand_bytes=4e8, peak_dtype="fp32")]
    R.classify(rows, const["bf16"], const["hbm_bytes_per_s"],
               constants=const)
    by = {r["name"]: r for r in rows}
    assert by["a"]["bound"] == "tensor"
    assert by["a"]["t_roofline_us"] == round(1e12 / 989.4e12 * 1e6, 3)
    assert by["b"]["bound"] == "hbm" and not by["b"]["l2_resident_possible"]
    assert by["c"]["l2_resident_possible"]  # 20 MB a call, twice in 50 MB
    assert by["d"]["l2_resident_possible"]


# ---------------------------------------------------------- the join
def test_join_device_times():
    L = R.LABEL
    events = [  # (name, on the card, start ns, end ns, correlation id)
        (L + "add(2:f32)", False, 0, 10_000, 1),
        ("aten::add", False, 1_000, 9_000, 2),
        ("cudaLaunchKernel", False, 2_000, 3_000, 7),
        ("cudaLaunchKernel", False, 20_000, 21_000, 8),  # no label around
        ("elementwise_kernel", True, 30_000, 34_000, 7),
        ("void bn_stats_kernel<float>", True, 40_000, 46_000, 8),
        ("void bn_bwd_sums_kernel<float, 0, true, false>", True, 44_000,
         52_000, 9),
        # a label's mirror on the card's timeline: no operation
        (L + "add(2:f32)", True, 29_000, 35_000, 1)]
    got, busy = R.join_device_times(events, runs=2)
    assert got == {"add(2:f32)": [2.0, 0.5], "bn_stats": [3.0, 0.5],
                   R.UNATTRIBUTED: [4.0, 0.5]}
    # the union of the device ranges: 30-34 and 40-52 us, per run
    assert busy == 8.0
    assert sum(v[0] for v in got.values()) > busy  # 44-46 counted twice


def test_labels_hold_their_ops_on_a_cpu_profile():
    """Every counted operation's host range lies in its own label's, and
    the labels do not overlap (the join's lookup)."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(4, 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with R.OpCount("cpu", label=True) as count:
            (x * 2 + x).sum()
    events = R.profiled_events(prof)
    labels = sorted((s, e, n[len(R.LABEL):]) for n, _, s, e, _ in events
                    if n.startswith(R.LABEL))
    assert sorted(lab[2] for lab in labels) == \
        sorted(r["name"] for r in count.table())
    assert all(a[1] <= b[0] for a, b in zip(labels, labels[1:]))
    for start, end, row in labels:
        ops = [n for n, _, s, e, _ in events
               if n.startswith("aten::") and start <= s and e <= end]
        assert "aten::" + row.split("(")[0] in ops, (row, ops)
    assert {r["name"].split("(")[0] for r in count.table()} == \
        {"mul", "add", "sum"}


def test_counts_are_shapes_only():
    """The same rows whatever runs the kernels: a train step counted on
    the CPU (the plain versions run) and on `meta` (shapes alone)."""
    args = R.build_parser().parse_args(SMALL)
    meta_rows, _ = R.count_rows(R.build_step(args, "meta"))
    cpu_rows, _ = R.count_rows(R.build_step(args, "cpu"), device="cpu")
    def key(rows):
        return {r["name"]: (r["calls"], r["flops"], r["bytes"])
                for r in rows}
    assert key(meta_rows) == key(cpu_rows)
    assert not math.isnan(sum(r["bytes"] for r in meta_rows))
