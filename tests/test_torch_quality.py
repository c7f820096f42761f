"""The port's quality matrix (`real_time_helmet_detection_tpu_torch/
quality/`) against the JAX package's `scripts/quality_matrix.py`, on the
CPU:

* the sweeps: on seeded per-image confidences and detections, the
  blended mAP at each threshold equals JAX's `metrics.compute_map` on the
  same blend within 1e-9 (and the rows carry it rounded as JAX's do);
  both selection rules pick the row a direct numpy derivation picks; the
  cascade sweep's ends are the all-edge and all-quality mAPs, the stream
  sweep's t = 0 row full inference;
* the records: one `--tiers`, `--cascade` and `--streams` `--smoke` run
  with `--device cpu` (64^2, width 8, 8 train / 4 test images, 1 epoch;
  2 videos of 4 frames)
  writes only under its work dir; its key sets are those of JAX's
  committed `artifacts/r15/quality_matrix.json`, `r16/cascade.json` and
  `r17/streams.json` plus the port's named additions (PORT_KEYS), and
  JAX's perfgate readers give the same metric keys from the port's
  records as from JAX's;
* the counting model: its convolution FLOPs equal 2 * sum of
  k^2 * c_in / groups * c_out * H * W over the convolutions' shapes;
* the loader: a port record from a full card run wins, a smoke or CPU
  one does not, and JAX's loaders on this repo still resolve to
  artifacts/r16 and artifacts/r17.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from real_time_helmet_detection_tpu import config as jax_config
from real_time_helmet_detection_tpu.metrics import \
    compute_map as jax_compute_map
from real_time_helmet_detection_tpu_torch import config
from real_time_helmet_detection_tpu_torch.ops.decode import Detections
from real_time_helmet_detection_tpu_torch.quality import cost, matrix, sweeps
from test_torch_train import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# keys the port's records add to JAX's: the card each ran on, and in a
# tier row the label of the count, the convolution FLOPs and the p99
PORT_KEYS = {"record": {"device"},
             "row": {"count", "conv_flops", "serve_wire_p99_ms_b1",
                     "serve_wire_requests"}}


# ------------------------------------------------------------------ sweeps
def seeded_dets(seed, n=12):
    """Ground truth and two tiers' host detections of n images: boxes
    near the truth with seeded jitter, spurious boxes and scores."""
    rng = np.random.default_rng(seed)
    gt_b, gt_l, dets = {}, {}, {}
    for i in range(n):
        k = int(rng.integers(1, 5))
        xy = rng.uniform(0, 400, (k, 2))
        wh = rng.uniform(20, 100, (k, 2))
        boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        labels = rng.integers(0, 2, k)
        gt_b["%03d" % i], gt_l["%03d" % i] = boxes, labels
        tiers = {}
        for tier, jitter in (("edge", 30.0), ("quality", 4.0)):
            m = int(rng.integers(0, 6))
            pick = rng.integers(0, k, m)
            b = boxes[pick] + rng.normal(0, jitter, (m, 4)).astype(
                np.float32)
            tiers[tier] = {"box": b.astype(np.float32),
                           "cls": np.where(rng.random(m) < 0.85,
                                           labels[pick], 1 - labels[pick]),
                           "score": rng.random(m).astype(np.float32)}
        tiers["confidence"] = float(rng.normal(0.1, 0.2))
        dets["%03d" % i] = tiers
    return gt_b, gt_l, dets


def jax_blend(gt_b, gt_l, dets, esc):
    pick = {k: "quality" if k in esc else "edge" for k in dets}
    return float(jax_compute_map(
        gt_b, gt_l, {k: dets[k][pick[k]]["box"] for k in dets},
        {k: dets[k][pick[k]]["cls"] for k in dets},
        {k: dets[k][pick[k]]["score"] for k in dets}, num_cls=2)["map"])


@pytest.mark.parametrize("seed", [0, 1])
def test_cascade_sweep_matches_jax_compute_map(seed):
    gt_b, gt_l, dets = seeded_dets(seed)
    sw = sweeps.cascade_sweep(gt_b, gt_l, dets)
    confs = {k: d["confidence"] for k, d in dets.items()}
    # JAX's candidates: each distinct confidence, then "escalate all"
    cand = sorted(set(confs.values()))
    cand.append(cand[-1] + 1.0)
    assert len(sw["sweep"]) == len(cand)
    for t, row in zip(cand, sw["sweep"]):
        assert row["threshold"] == round(t, 6)
        esc = {k for k, c in confs.items() if c < t}
        want = jax_blend(gt_b, gt_l, dets, esc)
        got = sweeps.blended_map(
            gt_b, gt_l, dets, lambda k: "quality" if k in esc else "edge")
        assert abs(got - want) <= 1e-9
        assert row["blended_mAP"] == round(want, 4)
        assert row["escalation_rate"] == round(len(esc) / len(dets), 4)
    # the ends: nothing escalates below the least confidence, everything
    # above the greatest
    first, last = sw["sweep"][0], sw["sweep"][-1]
    assert first["escalation_rate"] == 0.0 and last["escalation_rate"] == 1.0
    assert first["blended_mAP"] == sw["all_edge_mAP"] \
        == round(jax_blend(gt_b, gt_l, dets, set()), 4)
    assert last["blended_mAP"] == sw["all_quality_mAP"] \
        == round(jax_blend(gt_b, gt_l, dets, set(dets)), 4)
    rates = [r["escalation_rate"] for r in sw["sweep"]]
    assert rates == sorted(rates)
    # the rule, derived directly
    rate = np.array(rates)
    delta = np.array([r["delta_vs_all_quality"] for r in sw["sweep"]])
    ok = np.flatnonzero(delta >= -0.02)
    want = ok[np.argmin(rate[ok])]
    assert {k: v for k, v in sw["selected"].items() if k != "rule"} \
        == sw["sweep"][want]


def seeded_stream(seed, n_seq=3, frames=5, grid=2):
    rng = np.random.default_rng(seed)
    origins = [(y, x) for y in (0, 64) for x in (0, 64)][:grid * grid]
    preds, deltas, gt_b, gt_l = {}, {}, {}, {}
    for s in range(n_seq):
        for f in range(frames):
            if f:
                deltas[(s, f)] = rng.uniform(0, 20, grid * grid).astype(
                    np.float32)
            bs, ls = [], []
            for k, (y0, x0) in enumerate(origins):
                xy = rng.uniform(0, 40, (2, 2))
                box = np.concatenate([xy, xy + 20], 1).astype(np.float32)
                lab = rng.integers(0, 2, 2)
                bs.append(box + np.array([x0, y0, x0, y0], np.float32))
                ls.append(lab)
                noise = rng.normal(0, 3, (2, 4)).astype(np.float32)
                preds[(s, f, k)] = Detections(
                    boxes=np.concatenate([box + noise, np.zeros((2, 4),
                                                               np.float32)]),
                    classes=np.concatenate([lab, [0, 1]]).astype(np.int32),
                    scores=rng.random(4).astype(np.float32),
                    valid=np.array([True, True, rng.random() < 0.5, False]))
            fid = "s%02d_f%02d" % (s, f)
            gt_b[fid], gt_l[fid] = np.concatenate(bs), np.concatenate(ls)
    return preds, deltas, gt_b, gt_l, origins, n_seq, frames


def jax_replay(preds, deltas, gt_b, gt_l, origins, n_seq, frames, t):
    """JAX's `blended` (ref scripts/quality_matrix.py:921-952), unrounded,
    scored by JAX's compute_map."""
    computed = total = 0
    db, dc, ds = {}, {}, {}
    for s in range(n_seq):
        cache = [None] * len(origins)
        for f in range(frames):
            fid = "s%02d_f%02d" % (s, f)
            bs, cs, ss = [], [], []
            for k in range(len(origins)):
                total += 1
                if f == 0 or cache[k] is None or float(
                        deltas[(s, f)][k]) >= t:
                    cache[k] = preds[(s, f, k)]
                    computed += 1
                row = cache[k]
                y0, x0 = origins[k]
                bs.append(row.boxes[row.valid]
                          + np.array([x0, y0, x0, y0], np.float32))
                cs.append(row.classes[row.valid])
                ss.append(row.scores[row.valid])
            db[fid], dc[fid], ds[fid] = (np.concatenate(bs),
                                         np.concatenate(cs),
                                         np.concatenate(ss))
    m = jax_compute_map(gt_b, gt_l, db, dc, ds, num_cls=2)
    return float(m["map"]), 1.0 - computed / total


@pytest.mark.parametrize("seed", [0, 1])
def test_stream_sweep_matches_jax_compute_map(seed):
    args = seeded_stream(seed)
    sw = sweeps.stream_sweep(*args)
    for row in sw["sweep"]:
        want, skip = jax_replay(*args, row["threshold"])
        got, got_skip = sweeps.stream_replay(*args, row["threshold"])
        assert abs(got - want) <= 1e-9 and got_skip == skip
        assert row["blended_video_mAP"] == round(want, 4)
        assert row["tile_skip_rate"] == round(skip, 4)
    assert sw["sweep"][0]["threshold"] == 0.0
    assert sw["sweep"][0]["tile_skip_rate"] == 0.0
    assert sw["sweep"][0]["blended_video_mAP"] == sw["full_video_mAP"]
    skip = np.array([r["tile_skip_rate"] for r in sw["sweep"]])
    delta = np.array([r["delta_vs_full"] for r in sw["sweep"]])
    ok = np.flatnonzero(delta >= -0.02)
    want = ok[np.argmax(skip[ok])]
    assert {k: v for k, v in sw["selected"].items() if k != "rule"} \
        == sw["sweep"][want]


# ------------------------------------------------------------------- cost
class ConvShapes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.convolution.default:
            w = args[1]
            c_out, c_in_g, kh, kw = w.shape
            self.flops += 2 * kh * kw * c_in_g * c_out * out.shape[0] \
                * out.shape[2] * out.shape[3]
        return out


@pytest.mark.parametrize("tier", ["edge", "throughput", "quality"])
def test_cost_conv_flops_equal_the_layer_shapes(tier):
    from real_time_helmet_detection_tpu_torch.models.hourglass import \
        build_model
    cfg = cost.preset_config(tier, 64)
    got = cost.counts(cfg, 64)
    with torch.device("meta"):
        model = build_model(cfg).eval()
    with ConvShapes() as cs, torch.no_grad():
        model(torch.empty(1, 64, 64, 3, device="meta"))
    assert got["conv_flops"] == cs.flops > 0
    assert got["count"] == "port-analytic"
    assert got["params_m"] == round(sum(p.numel() for p in
                                        model.parameters()) / 1e6, 4)


# ---------------------------------------------------------------- records
@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    # module scope comes before the function-scoped one_torch_thread
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield run_smoke(str(tmp_path_factory.mktemp("qmatrix")))
    finally:
        torch.set_num_threads(threads)


def tree_state(*roots):
    """{path: mtime} of every file and directory under `roots`."""
    out = {}
    for root in roots:
        for d, dirs, files in os.walk(root):
            for name in [""] + files:
                path = os.path.join(d, name)
                out[path] = os.stat(path).st_mtime_ns
    return out


def run_smoke(work):
    watched = (matrix.CALIBRATION_DIR, os.path.join(REPO, "artifacts"))
    before = tree_state(*watched)
    common = ["--smoke", "--device", "cpu", "--epochs", "1", "--train", "8",
              "--test", "4", "--width-scale", "16", "--frames", "4",
              "--seqs", "2", "--work-dir", work]
    out = {mode: matrix.main(["--" + mode] + common)
           for mode in ("tiers", "cascade", "streams")}
    return work, out, tree_state(*watched) == before


def load(rel):
    with open(os.path.join(REPO, rel)) as f:
        return json.load(f)


def test_smoke_records_are_written_only_under_the_work_dir(smoke_run):
    work, out, untouched = smoke_run
    assert untouched
    for name in ("quality_matrix.json", "cascade.json", "streams.json"):
        assert os.path.isfile(os.path.join(work, "tiers_smoke", name))
    assert out["tiers"]["tier_meta"]["platform"] == "cpu"
    assert out["cascade"]["device"] == {"platform": "cpu", "name": "cpu",
                                        "power_limit": None}
    assert all(r["smoke"] for r in (out["cascade"], out["streams"]))


def test_tier_record_keys_are_jax(smoke_run):
    _, out, _ = smoke_run
    ours, theirs = out["tiers"], load("artifacts/r15/quality_matrix.json")
    assert set(ours) == set(theirs) | PORT_KEYS["record"]
    assert set(ours["tier_meta"]) == set(theirs["tier_meta"])
    assert set(ours["tiers"]) == set(theirs["tiers"])
    for tier, row in theirs["tiers"].items():
        extra = PORT_KEYS["row"] if "serve_wire_ms_b1" in row else set()
        assert set(ours["tiers"][tier]) == set(row) | extra, tier
    for name, row in ours["tiers"].items():
        if "preset" in row:
            assert row["preset"] == jax_config.TIER_PRESETS[name]
            assert row["map_arch"]["width"] == 8
    assert [set(r) for r in ours["tier_pareto"]] \
        == [set(r) for r in theirs["tier_pareto"]]
    assert ours["tiers"]["edge"]["distill_vs_scratch_dmap"] == round(
        ours["tiers"]["edge"]["mAP"] - ours["tiers"]["edge_scratch"]["mAP"],
        4)


@pytest.mark.parametrize("mode,rel", [("cascade", "artifacts/r16/cascade.json"),
                                      ("streams", "artifacts/r17/streams.json")])
def test_calibration_record_keys_are_jax(smoke_run, mode, rel):
    _, out, _ = smoke_run
    ours, theirs = out[mode], load(rel)
    assert set(ours) == set(theirs) | PORT_KEYS["record"]
    for key in ("fixture", "selected"):
        assert set(ours[key]) == set(theirs[key]), key
    assert {frozenset(r) for r in ours["sweep"]} \
        == {frozenset(r) for r in theirs["sweep"]}
    sweep = ours["sweep"]
    if mode == "cascade":
        # escalation never falls as the threshold rises; the ends are
        # the all-edge and all-quality answers
        rates = [r["escalation_rate"] for r in sweep]
        assert rates == sorted(rates) and rates[-1] == 1.0
        assert sweep[0]["blended_mAP"] == ours["all_edge_mAP"]
        assert sweep[-1]["blended_mAP"] == ours["all_quality_mAP"]
    else:
        assert sweep[0]["threshold"] == 0.0
        assert sweep[0]["tile_skip_rate"] == 0.0
        assert sweep[0]["blended_video_mAP"] == ours["full_video_mAP"]


@pytest.fixture(scope="module")
def perfgate():
    spec = importlib.util.spec_from_file_location(
        "perfgate", os.path.join(REPO, "scripts", "perfgate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_keys(reader, rec):
    """The reader's metric keys; the edge_scratch row's arch is the width
    it trained at (16 in JAX's record, 8 here), so that width is left out."""
    keys = set()
    for o in reader(rec, 17, "x"):
        k = o.key
        if ",edge_scratch," in k:
            k = k[:k.rindex(",w")] + ",w*" + k[k.index("]"):]
        keys.add(k)
    return keys


@pytest.mark.parametrize("mode,reader,rel", [
    ("tiers", "obs_from_quality_matrix", "artifacts/r15/quality_matrix.json"),
    ("cascade", "obs_from_cascade_calibration", "artifacts/r16/cascade.json"),
    ("streams", "obs_from_streams_calibration", "artifacts/r17/streams.json")])
def test_perfgate_reads_the_same_metrics(smoke_run, perfgate, mode, reader,
                                         rel):
    _, out, _ = smoke_run
    read = getattr(perfgate, reader)
    ours, theirs = metric_keys(read, out[mode]), metric_keys(read, load(rel))
    assert ours == theirs and ours


# ----------------------------------------------------------------- loader
def write_record(root, rel, **fields):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(fields, f)


PORT_CASCADE = "real_time_helmet_detection_tpu_torch/calibration/cascade.json"
PORT_STREAMS = "real_time_helmet_detection_tpu_torch/calibration/streams.json"


@pytest.mark.parametrize("kind,rel,fn", [
    ("cascade", PORT_CASCADE, "cascade_overrides"),
    ("streams", PORT_STREAMS, "stream_overrides")])
def test_port_card_record_wins_over_jax(tmp_path, kind, rel, fn):
    root = str(tmp_path)
    write_record(root, "artifacts/r16/%s.json" % kind,
                 selected={"threshold": 0.25})
    field = {"cascade": "cascade_threshold",
             "streams": "stream_threshold"}[kind]
    jax_only = getattr(config, fn)(repo_root=root)
    assert jax_only == {field: 0.25,
                        "_source": "artifacts/r16/%s.json" % kind}
    # a smoke record, a CPU record and one without a threshold do not win
    for bad in (dict(platform="gpu", smoke=True), dict(platform="cpu",
                                                       smoke=False),
                dict(platform="gpu"), dict(platform="gpu", smoke=False,
                                           selected={})):
        write_record(root, rel, **dict(dict(selected={"threshold": 9.0}),
                                       **bad))
        assert getattr(config, fn)(repo_root=root) == jax_only, bad
    write_record(root, rel, platform="gpu", smoke=False,
                 selected={"threshold": 0.5})
    assert getattr(config, fn)(repo_root=root) == {field: 0.5,
                                                   "_source": rel}
    # JAX's loader never reads the port's directory
    assert getattr(jax_config, fn)(repo_root=root)[field] == 0.25


def test_jax_loaders_still_resolve_to_the_committed_rounds():
    assert jax_config.cascade_overrides()["_source"] \
        == os.path.join("artifacts", "r16", "cascade.json")
    assert jax_config.stream_overrides()["_source"] \
        == os.path.join("artifacts", "r17", "streams.json")


def test_runs_on_the_card_by_default_and_raises_without_one(tmp_path):
    """No `--device cpu`: the matrix asks for cuda and, with no card,
    raises before it writes anything (never falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        matrix.main(["--tiers", "--smoke", "--work-dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []
