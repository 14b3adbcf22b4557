"""Summarize a jax.profiler trace: device-lane op durations by name.

Usage: python scripts/parse_trace.py <profile_dir> [top_n]

Finds the newest trace.json.gz under a ``jax.profiler`` profile dir, sums
complete events on the GPU's device lanes (processes named
``/device:GPU:<n>``), and prints the top ops plus the total device time.
"""

import collections
import glob
import gzip
import json
import sys


def load_trace(root):
    paths = glob.glob(f"{root}/**/*.trace.json.gz", recursive=True)
    if not paths:
        raise SystemExit(f"no trace.json.gz under {root}")
    with gzip.open(sorted(paths)[-1], "rt") as f:
        return json.load(f)


def device_events(trace):
    """Yield (name, duration_us) for complete events on device lanes."""
    # map pid -> process name to find the device lanes
    proc = {}
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            proc[ev["pid"]] = ev["args"].get("name", "")
    device_pids = {pid for pid, name in proc.items()
                   if name.startswith("/device:")}
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("pid") in device_pids:
            yield ev["name"], float(ev.get("dur", 0.0))


def summarize(root, top_n=15):
    trace = load_trace(root)
    agg = collections.defaultdict(float)
    for name, dur in device_events(trace):
        agg[name] += dur
    total = sum(agg.values())
    rows = sorted(agg.items(), key=lambda kv: -kv[1])[:top_n]
    width = max((len(n) for n, _ in rows), default=10)
    for name, dur in rows:
        print(f"{name:<{width}}  {dur/1000.0:9.3f} ms  {100*dur/max(total,1e-9):5.1f}%")
    print(f"{'TOTAL':<{width}}  {total/1000.0:9.3f} ms")
    return agg, total


if __name__ == "__main__":
    root = sys.argv[1]
    top_n = int(sys.argv[2]) if len(sys.argv) > 2 else 15
    summarize(root, top_n)
