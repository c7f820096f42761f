"""The port's transfer audit (`analysis/transfer_audit.py`) on the CPU.

* every registered entry measures, and the measurement gates clean
  against the committed `analysis/transfer_manifest.json` (leaf counts
  exact, bytes within 2%); the manifest names exactly the registered
  entries, with no host-sync op in any;
* predict and serve b1/b2/b4 fetch the leaves (count, shape, dtype) of
  the JAX package's committed manifest entries of the same names;
* the train step's fetch is one stacked row whatever the option (the
  sentinel's and telemetry's scalars ride it);
* `counting_syncs` counts host fetches by call and restores the real
  methods; `entries_for_changed` maps modules to entries.
"""

import json
import os

import numpy as np
import pytest
import torch

from real_time_helmet_detection_tpu_torch.analysis import \
    transfer_audit as xa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MANIFEST = os.path.join(REPO, "real_time_helmet_detection_tpu",
                            "analysis", "transfer_manifest.json")


@pytest.fixture(scope="module")
def measured():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return xa.measure_repo_entry_points()
    finally:
        torch.set_num_threads(threads)


def test_manifest_gate_passes(measured):
    manifest = xa.load_manifest()
    assert manifest["schema"] == xa.SCHEMA
    assert sorted(manifest["entries"]) == sorted(xa.ENTRY_POINTS)
    res = xa.gate_manifest(measured, manifest)
    assert res["findings"] == [], [(f.rule, f.context, f.message)
                                   for f in res["findings"]]
    assert res["improved"] == [] and res["stale"] == []
    assert all(m["host_callbacks"] == 0 for m in measured.values())


@pytest.mark.parametrize("name", ["predict", "serve_predict[b=1]",
                                  "serve_predict[b=2]",
                                  "serve_predict[b=4]",
                                  "stream_tile_predict[b=2]",
                                  "predict_cascade_summary[tier=edge]",
                                  "stream_delta_summary[grid=2]"])
def test_fetched_leaves_equal_jaxs(measured, name):
    with open(JAX_MANIFEST) as f:
        jax_entry = json.load(f)["entries"][name]
    ours = measured[name]["d2h"]
    assert ours["leaves"] == jax_entry["d2h"]["leaves"]
    assert ours["shapes"] == jax_entry["d2h"]["shapes"]
    assert ours["bytes"] == jax_entry["d2h"]["bytes"]


def test_train_fetch_is_one_row(measured):
    rows = {name: m["d2h"] for name, m in measured.items()
            if name.startswith("train_step")}
    assert len(rows) == 6
    assert all(r["leaves"] == 1 for r in rows.values())
    assert rows["train_step"]["shapes"] == ["float32[4]"]
    for name in ("train_step[sentinel]", "train_step[telemetry]"):
        assert rows[name]["shapes"] == ["float32[7]"]
    assert all(measured[n]["h2d_fresh"]["leaves"] == 5 for n in rows)


def test_gate_flags_growth():
    base = xa.Entry(lambda b: (b * 2.0,), (np.zeros(100, np.float32),),
                    (torch.zeros(3),))
    m0 = xa.measure_entry(base)
    manifest = {"schema": xa.SCHEMA, "entries": {"e": m0}}
    grown = xa.measure_entry(xa.Entry(lambda b: (b * 2.0, b[:1]),
                                      base.host, base.resident))
    rules = {f.rule for f in xa.gate_manifest({"e": grown},
                                              manifest)["findings"]}
    assert rules == {"xfer/extra-fetch-leaf"}
    synced = xa.measure_entry(xa.Entry(lambda b: (b * float(b.sum().item()),),
                                       base.host, base.resident))
    assert synced["host_callbacks"] == 1
    with pytest.raises(ValueError, match="unmeasurable"):
        xa.write_manifest({"e": {"error": "boom"}}, path=os.devnull)


def test_write_manifest_round_trips(tmp_path, measured):
    path = xa.write_manifest(measured, path=str(tmp_path / "m.json"))
    assert xa.load_manifest(path)["entries"] == json.loads(json.dumps(
        measured))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "other"}))
    with pytest.raises(ValueError, match="manifest"):
        xa.load_manifest(str(bad))


def test_counting_syncs():
    real = {n: getattr(torch.Tensor, n) for n in ("item", "cpu", "tolist",
                                                  "numpy")}
    with xa.counting_syncs() as c:
        x = torch.arange(6.0)
        x.sum().item()
        x.tolist()
        x.cpu().numpy()
        x + 1
    assert c.count == 4
    assert [k for k, _ in c.calls] == ["item", "tolist", "cpu", "numpy"]
    assert all(getattr(torch.Tensor, n) is f for n, f in real.items())
    with pytest.raises(RuntimeError):
        with xa.counting_syncs():
            raise RuntimeError("body")
    assert torch.Tensor.item is real["item"]


def test_entries_for_changed():
    pkg = "real_time_helmet_detection_tpu_torch/"
    assert "stream_delta_summary[grid=2]" in xa.entries_for_changed(
        [pkg + "ops/delta.py"])
    touched = xa.entries_for_changed([pkg + "serving/engine.py"])
    assert {"serve_predict[b=1]", "stream_tile_predict[b=2]"} <= touched
    assert "train_step" not in touched
    assert xa.entries_for_changed([pkg + "README.md"]) == set()
