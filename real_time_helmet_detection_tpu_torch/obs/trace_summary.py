"""Summarize a torch.profiler trace: the top device kernels by summed
duration (the port of ref scripts/trace_summary.py:1-16: `find_traces`
:28, `load_events` :36, `op_durations` :43, `summarize` :63, `main` :93).

Reads the Chrome trace-event JSON that torch.profiler's
`export_chrome_trace` writes (`train.StepTrace`: `--profile`'s
<save>/trace/trace.json; `.json.gz` too) with the standard library alone,
and prints, for each track, the top-N names by summed duration and the
share of the track's traced window they cover. A track is a process
(JAX's grouping of its trace's events), except that the device kernels
(`cat` "kernel") of a process form one track per stream: for a card's
trace, the kernels of each stream and the busy share of that stream.

    python -m real_time_helmet_detection_tpu_torch.obs.trace_summary \\
        <dir> [--top N]
"""

from __future__ import annotations

import gzip
import json
import os
import re
import sys
from collections import defaultdict


def find_traces(root: str):
    """Every trace file under `root`: JAX's `*.trace.json[.gz]` and
    torch.profiler's `trace.json[.gz]` / `*.pt.trace.json[.gz]`."""
    out = []
    for dirpath, _, files in os.walk(root):
        out += [os.path.join(dirpath, f) for f in files
                if f.endswith(("trace.json.gz", "trace.json"))]
    return sorted(out)


def load_events(path: str):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", [])


def op_durations(events):
    """Raw-name total durations: {name: [total_us, count]} of the
    duration events (ph == 'X'), track dropped (ref trace_summary.py:43)."""
    out = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        name = e.get("name", "")
        rec = out.setdefault(name, [0.0, 0])
        rec[0] += float(e.get("dur", 0.0))
        rec[1] += 1
    return out


def tracks(events):
    """{track: {name: summed us}} and {track: [first start, last end]}
    (module docstring: a process, or a process's stream of kernels);
    names lose XLA's uniquifier suffix and a leading '%'."""
    procs, threads = {}, {}
    for e in events:
        if e.get("ph") != "M":
            continue
        name = e.get("args", {}).get("name", "")
        if e.get("name") == "process_name":
            procs[e.get("pid")] = name
        elif e.get("name") == "thread_name":
            threads[(e.get("pid"), e.get("tid"))] = name
    by_track = defaultdict(lambda: defaultdict(float))
    span = defaultdict(lambda: [float("inf"), 0.0])
    for e in events:
        if e.get("ph") != "X":
            continue
        pid = e.get("pid")
        track = procs.get(pid, str(pid))
        if e.get("cat") == "kernel":
            tid = e.get("tid")
            track = "%s %s" % (track, threads.get((pid, tid),
                                                  "stream %s" % tid))
        dur = float(e.get("dur", 0.0))  # microseconds
        name = re.sub(r"\.\d+$", "", e.get("name", "?")).lstrip("%")
        by_track[track][name] += dur
        ts = float(e.get("ts", 0.0))
        span[track][0] = min(span[track][0], ts)
        span[track][1] = max(span[track][1], ts + dur)
    return by_track, span


def summarize(events, top: int):
    """Print each track's top-`top` names (ref trace_summary.py:63)."""
    by_track, span = tracks(events)
    for track, ops in sorted(by_track.items()):
        total = sum(ops.values())
        wall = max(span[track][1] - span[track][0], 1e-9)
        print("\n== %s  (sum %.3f ms over wall %.3f ms, %.0f%% busy)"
              % (track, total / 1e3, wall / 1e3, 100.0 * total / wall))
        for name, dur in sorted(ops.items(), key=lambda kv: -kv[1])[:top]:
            print("  %8.3f ms  %5.1f%%  %s"
                  % (dur / 1e3, 100.0 * dur / total, name[:100]))


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        raise SystemExit(__doc__)
    root = argv[0]
    top = 20
    for i, a in enumerate(argv):
        if a == "--top" and i + 1 < len(argv):
            top = int(argv[i + 1])
    traces = find_traces(root)
    if not traces:
        raise SystemExit("no trace.json[.gz] under %s: no profiler trace "
                         "written there" % root)
    for t in traces:
        print("# %s" % t)
        summarize(load_events(t), top)


if __name__ == "__main__":
    main()
