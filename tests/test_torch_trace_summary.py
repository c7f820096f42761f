"""The port's trace summary (`obs/trace_summary.py`) against the JAX
package's `scripts/trace_summary.py`, on the CPU: `op_durations` and
`summarize` give JAX's results on seeded synthetic traces and on a real
CPU torch.profiler trace (where no event is a device kernel); a card's
kernels (`cat` "kernel") form one track per stream, with the stream's
busy share; the module imports the standard library alone; the CLI
finds torch.profiler's `trace.json`."""

import ast
import contextlib
import gzip
import importlib.util
import io
import json
import os
import random
import subprocess
import sys

import pytest
import torch

from real_time_helmet_detection_tpu_torch.obs import trace_summary as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_ts():
    spec = importlib.util.spec_from_file_location(
        "jax_trace_summary", os.path.join(REPO, "scripts",
                                          "trace_summary.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def synthetic_events(seed, kernels=False):
    """A seeded Chrome trace: 3 processes (2 threads each) of 'X' events
    with XLA-style uniquified names, metadata, instants; with `kernels`,
    device kernels on two streams of a 'GPU 0' process."""
    rng = random.Random(seed)
    events = [{"ph": "M", "name": "process_name", "pid": p,
               "args": {"name": "/device:TPU:%d" % p}} for p in range(3)]
    names = ["fusion.%d" % i for i in range(6)] + \
        ["%convolution.12", "copy.3", "reduce", "%add.1"]
    for _ in range(200):
        events.append({"ph": "X", "pid": rng.randrange(3),
                       "tid": rng.randrange(2), "name": rng.choice(names),
                       "ts": rng.uniform(0, 1e4),
                       "dur": rng.uniform(0.5, 40.0)})
    events.append({"ph": "i", "pid": 0, "name": "instant", "ts": 5.0})
    if kernels:
        events.append({"ph": "M", "name": "process_name", "pid": 9,
                       "args": {"name": "GPU 0"}})
        for tid in (7, 13):
            events.append({"ph": "M", "name": "thread_name", "pid": 9,
                           "tid": tid, "args": {"name": "stream %d" % tid}})
        for i in range(60):
            events.append({"ph": "X", "cat": "kernel", "pid": 9,
                           "tid": (7, 13)[i % 2],
                           "name": "void k%d<float>(float*)" % (i % 4),
                           "ts": 100.0 + 10 * i, "dur": 4.0 + i % 3})
    return events


def printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_trace_equals_jax(jax_ts, seed):
    events = synthetic_events(seed)
    assert T.op_durations(events) == jax_ts.op_durations(events)
    for top in (3, 20):
        assert printed(T.summarize, events, top) == \
            printed(jax_ts.summarize, events, top)


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    """A real torch.profiler trace of a few CPU ops, exported as the train
    CLI's `--profile` does."""
    from torch.profiler import ProfilerActivity, profile
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    x = torch.randn(8, 16, 16, 16)
    conv = torch.nn.Conv2d(16, 16, 3, padding=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            conv(x).relu().sum()
    prof.export_chrome_trace(str(path))
    return path


def test_cpu_profiler_trace_equals_jax(jax_ts, cpu_trace):
    events = T.load_events(str(cpu_trace))
    assert events == jax_ts.load_events(str(cpu_trace))
    assert not any(e.get("cat") == "kernel" for e in events)
    assert T.op_durations(events) == jax_ts.op_durations(events)
    out = printed(T.summarize, events, 10)
    assert out == printed(jax_ts.summarize, events, 10)
    assert "aten::conv" in out


def test_kernels_one_track_per_stream(jax_ts):
    events = synthetic_events(3, kernels=True)
    tracks, span = T.tracks(events)
    assert {"GPU 0 stream 7", "GPU 0 stream 13"} <= set(tracks)
    assert "GPU 0" not in tracks
    k7 = [e for e in events if e.get("cat") == "kernel" and e["tid"] == 7]
    assert sum(tracks["GPU 0 stream 7"].values()) == \
        pytest.approx(sum(e["dur"] for e in k7))
    assert span["GPU 0 stream 7"] == [min(e["ts"] for e in k7),
                                      max(e["ts"] + e["dur"] for e in k7)]
    out = printed(T.summarize, events, 2)
    assert "== GPU 0 stream 13" in out and out.count("void k") == 4
    # the processes' own tracks are JAX's
    cpu = [e for e in events if e.get("cat") != "kernel"]
    assert printed(T.summarize, cpu, 5) == printed(jax_ts.summarize, cpu, 5)


def test_stdlib_only():
    tree = ast.parse(open(T.__file__).read())
    mods = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert mods <= set(sys.stdlib_module_names), mods


def test_cli_finds_torch_traces(tmp_path, cpu_trace):
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "trace.json").write_bytes(cpu_trace.read_bytes())
    with gzip.open(tmp_path / "x.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": synthetic_events(4)}, f)
    (tmp_path / "other.json").write_text("{}")
    assert [os.path.relpath(p, tmp_path) for p in T.find_traces(
        str(tmp_path))] == ["a/trace.json", "x.pt.trace.json.gz"]
    proc = subprocess.run(
        [sys.executable, "-m",
         "real_time_helmet_detection_tpu_torch.obs.trace_summary",
         str(tmp_path), "--top", "3"], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("# ") == 2 and "% busy)" in proc.stdout
    with pytest.raises(SystemExit, match="no trace"):
        T.main([str(tmp_path / "a" / "none")])
