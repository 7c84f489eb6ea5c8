#!/usr/bin/env python
"""Reduce a jax.profiler trace to device metrics.

For every GPU plane of the newest .xplane.pb under a trace directory:
the window from the first to the last device operation, the busy time
(union of the operation intervals), the idle share (1 - busy/window),
and the operations that took the most device time.

Usage: python bench/trace_summary.py TRACE_DIR [--top N]
Prints one JSON object.
"""

import argparse
import glob
import json
import os
from collections import defaultdict

# per-module and per-step lines repeat the time of the operations
# they contain
SKIP_LINES = ("XLA Modules", "Steps", "Launch Stats", "Source")


def newest_xplane(trace_dir: str) -> str:
    files = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return max(files, key=os.path.getmtime)


def busy_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize_planes(planes, top: int = 10) -> dict:
    """planes: iterable of (plane name, [(line name, [(op name,
    start_ns, duration_ns)])])."""
    out = {}
    for pname, lines in planes:
        if not pname.startswith("/device:GPU"):
            continue
        ops, by_name = [], defaultdict(float)
        for lname, events in lines:
            if lname in SKIP_LINES:
                continue
            for name, start, dur in events:
                ops.append((start, start + dur))
                by_name[name] += dur
        if not ops:
            continue
        window = max(e for _, e in ops) - min(s for s, _ in ops)
        busy = busy_ns(ops)
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        out[pname] = {
            "window_ms": window / 1e6, "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / window if window else 0.0,
            "n_ops": len(ops),
            "top_ops_ms": [(n, d / 1e6) for n, d in ranked]}
    return out


def summarize(trace_dir: str, top: int = 10) -> dict:
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(newest_xplane(trace_dir))
    planes = [(p.name, [(line.name, [(ev.name, ev.start_ns,
                                       ev.duration_ns)
                                      for ev in line.events])
                        for line in p.lines])
              for p in pd.planes]
    return summarize_planes(planes, top)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args()
    print(json.dumps(summarize(args.trace_dir, args.top)))


if __name__ == "__main__":
    main()
