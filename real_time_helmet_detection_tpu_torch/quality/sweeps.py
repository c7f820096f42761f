"""The threshold sweeps of the quality matrix, as pure functions over
host detections (ref scripts/quality_matrix.py:600-700, :920-982, where
they are nested in `run_cascade` and `run_streams`).

* The cascade sweep: an image escalates iff its edge confidence is below
  t and then takes the quality tier's answer; each candidate t gives an
  escalation rate and the blended mAP. The operating point is the
  smallest escalation rate whose blended mAP is at least the
  all-quality mAP less 0.02 (ref scripts/quality_matrix.py:670-676).
* The stream replay: a tile recomputes iff it is in the first frame or
  its delta is at least t, otherwise its last computed answer stands;
  each t gives the tile skip rate and the blended video mAP. The
  operating point is the largest skip rate whose blended video mAP is at
  least the full-inference mAP less 0.02 (ref scripts/quality_matrix.py:
  977-982).

Candidates are every distinct observed value (the curves' only knees)
plus the end that makes the sweep total, thinned to at most 33 quantile
points. Rows carry JAX's rounding (4 places; thresholds 6), and the
selection reads the rounded rows, as JAX's does."""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from ..metrics import compute_map
from .fixture import frame_id

TOLERANCE = 0.02      # blended mAP may fall this far below the full answer
MAX_CANDIDATES = 33   # thresholds of one sweep


def host_row(row, rescale=None) -> Dict[str, np.ndarray]:
    """One image's valid detections as numpy {"box", "cls", "score"},
    boxes times `rescale` (x, y, x, y factors) when given."""
    keep = np.asarray(row.valid)
    boxes = np.asarray(row.boxes)[keep]
    if rescale is not None:
        boxes = boxes * rescale
    return {"box": boxes, "cls": np.asarray(row.classes)[keep],
            "score": np.asarray(row.scores)[keep]}


def thin(cand: Sequence[float]) -> List[float]:
    """At most MAX_CANDIDATES of the sorted candidates, evenly by rank."""
    cand = list(cand)
    if len(cand) > MAX_CANDIDATES:
        idx = np.linspace(0, len(cand) - 1,
                          MAX_CANDIDATES).round().astype(int)
        cand = [cand[i] for i in sorted(set(idx.tolist()))]
    return cand


def blended_map(gt_boxes, gt_labels, dets: Dict[str, Dict],
                pick: Callable[[str], str], num_cls: int = 2) -> float:
    """Unrounded mAP of a per-image tier choice: `dets[id][pick(id)]`."""
    m = compute_map(gt_boxes, gt_labels,
                    {k: dets[k][pick(k)]["box"] for k in dets},
                    {k: dets[k][pick(k)]["cls"] for k in dets},
                    {k: dets[k][pick(k)]["score"] for k in dets},
                    num_cls=num_cls)
    return float(m["map"])


def escalated(confidence: Dict[str, float], t: float) -> set:
    return {k for k, c in confidence.items() if c < t}


def cascade_sweep(gt_boxes, gt_labels, dets: Dict[str, Dict],
                  num_cls: int = 2, log=lambda msg: None) -> Dict:
    """`dets[id]` = {"edge": host row, "quality": host row, "confidence":
    the edge tier's}: the record's all_edge_mAP, all_quality_mAP,
    confidence digest, sweep and selected point."""
    def map_of(pick):
        return round(blended_map(gt_boxes, gt_labels, dets, pick, num_cls),
                     4)

    map_edge = map_of(lambda k: "edge")
    map_quality = map_of(lambda k: "quality")
    confs = {k: dets[k]["confidence"] for k in dets}
    cand = sorted(set(confs.values()))
    cand.append(max(cand) + 1.0)   # escalate everything
    sweep = []
    for t in thin(cand):
        esc = escalated(confs, t)
        row = {"threshold": round(float(t), 6),
               "escalation_rate": round(len(esc) / len(confs), 4),
               "blended_mAP": map_of(
                   lambda k: "quality" if k in esc else "edge")}
        row["delta_vs_all_quality"] = round(row["blended_mAP"]
                                            - map_quality, 4)
        sweep.append(row)
        log("t=%.4f: escalation %.0f%%, blended mAP %.4f (%+.4f vs "
            "all-quality)" % (t, 100 * row["escalation_rate"],
                              row["blended_mAP"],
                              row["delta_vs_all_quality"]))
    vals = list(confs.values())
    return {"all_edge_mAP": map_edge, "all_quality_mAP": map_quality,
            "confidence": {"min": round(min(vals), 4),
                           "median": round(float(np.median(vals)), 4),
                           "max": round(max(vals), 4)},
            "sweep": sweep, "selected": select_cascade(sweep)}


def select_cascade(sweep: List[Dict]) -> Dict:
    """The smallest escalation rate within TOLERANCE of all-quality
    routing (always met: escalating everything is all-quality)."""
    ok = [r for r in sweep if r["delta_vs_all_quality"] >= -TOLERANCE]
    sel = dict(min(ok, key=lambda r: r["escalation_rate"]))
    sel["rule"] = ("min escalation rate with blended mAP >= "
                   "all-quality - 0.02")
    return sel


def stream_replay(preds: Dict[Tuple[int, int, int], object],
                  deltas: Dict[Tuple[int, int], np.ndarray],
                  gt_boxes, gt_labels, origins, n_seq: int, frames: int,
                  t: float, num_cls: int = 2) -> Tuple[float, float]:
    """The session cache replayed offline at threshold `t`: (unrounded
    blended video mAP, tile skip rate). Tile k of frame f computes iff
    f == 0 or deltas[(s, f)][k] >= t (streams.py's rule); otherwise its
    last computed detections answer."""
    tiles = len(origins)
    computed = total = 0
    db, dc, ds = {}, {}, {}
    for s in range(n_seq):
        cache = [None] * tiles
        for f in range(frames):
            bs, cs, ss = [], [], []
            for k in range(tiles):
                total += 1
                if (f == 0 or cache[k] is None
                        or float(deltas[(s, f)][k]) >= t):
                    cache[k] = preds[(s, f, k)]
                    computed += 1
                row = host_row(cache[k])
                y0, x0 = origins[k]
                bs.append(row["box"] + np.array([x0, y0, x0, y0],
                                                np.float32))
                cs.append(row["cls"])
                ss.append(row["score"])
            fid = frame_id(s, f)
            db[fid] = np.concatenate(bs)
            dc[fid] = np.concatenate(cs)
            ds[fid] = np.concatenate(ss)
    m = compute_map(gt_boxes, gt_labels, db, dc, ds, num_cls=num_cls)
    return float(m["map"]), 1.0 - computed / total


def stream_sweep(preds, deltas, gt_boxes, gt_labels, origins, n_seq: int,
                 frames: int, num_cls: int = 2,
                 log=lambda msg: None) -> Dict:
    """The record's full_video_mAP, delta digest, sweep and selected
    point; t = 0 is full inference (every delta is >= 0)."""
    def at(t):
        m, skip = stream_replay(preds, deltas, gt_boxes, gt_labels,
                                origins, n_seq, frames, t, num_cls)
        return round(m, 4), round(skip, 4)

    full_map, _ = at(0.0)
    dvals = np.concatenate([deltas[k] for k in sorted(deltas)])
    cand = sorted(set([0.0] + [round(float(v), 4) for v in dvals]))
    sweep = []
    for t in thin(cand):
        m, skip = at(t)
        row = {"threshold": round(float(t), 6), "tile_skip_rate": skip,
               "blended_video_mAP": m,
               "delta_vs_full": round(m - full_map, 4)}
        sweep.append(row)
        log("t=%.4f: skip %.0f%%, blended video mAP %.4f (%+.4f vs full)"
            % (t, 100 * skip, m, row["delta_vs_full"]))
    return {"full_video_mAP": full_map,
            "delta": {"min": round(float(dvals.min()), 4),
                      "median": round(float(np.median(dvals)), 4),
                      "max": round(float(dvals.max()), 4)},
            "sweep": sweep, "selected": select_stream(sweep)}


def select_stream(sweep: List[Dict]) -> Dict:
    """The largest tile skip rate within TOLERANCE of full inference
    (always met: t = 0 is full inference)."""
    ok = [r for r in sweep if r["delta_vs_full"] >= -TOLERANCE]
    sel = dict(max(ok, key=lambda r: r["tile_skip_rate"]))
    sel["rule"] = ("max tile_skip_rate with blended video mAP >= "
                   "full - 0.02")
    return sel
