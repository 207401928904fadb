#!/usr/bin/env python3
"""Summarise a jax.profiler Chrome trace by op name.

``jax.profiler.trace(logdir)`` writes TensorBoard profile runs under
``<logdir>/plugins/profile/<run>/``.  This tool reads the
``*.trace.json.gz`` Chrome trace and prints total device-time per HLO/
kernel name (merging fusion suffixes), so a grid-sampler segment's step
cost splits into phases without opening XProf:

    python scripts/trace_summary.py traces [-n 30]

Device events are those on GPU lanes (process names such as
"/device:GPU:0" and their CUDA streams); host python/runtime lanes are
skipped.
"""

import argparse
import collections
import glob
import gzip
import json
import os
import re


def load_events(logdir):
    pats = sorted(glob.glob(os.path.join(
        logdir, "plugins", "profile", "*", "*.trace.json.gz")))
    if not pats:
        raise SystemExit(f"no *.trace.json.gz under {logdir}")
    path = pats[-1]  # latest run
    with gzip.open(path, "rt") as fh:
        data = json.load(fh)
    return path, data.get("traceEvents", [])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("logdir")
    ap.add_argument("-n", type=int, default=30, help="rows to print")
    ap.add_argument("--host", action="store_true",
                    help="summarise host lanes instead of device lanes")
    args = ap.parse_args()

    path, events = load_events(args.logdir)

    # pid -> process name from metadata events
    pid_name = {}
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_name[ev["pid"]] = ev.get("args", {}).get("name", "")

    def is_device(pid):
        name = pid_name.get(pid, "")
        dev = any(w in name for w in ("/device:", "GPU", "Stream",
                                      "XLA Ops"))
        return dev if not args.host else not dev

    total = collections.Counter()
    count = collections.Counter()
    wall = 0.0
    for ev in events:
        if ev.get("ph") != "X" or not is_device(ev.get("pid", -1)):
            continue
        dur = float(ev.get("dur", 0.0))  # microseconds
        # merge "fusion.123"/"fusion.45" and kernel launch suffixes
        name = re.sub(r"\.\d+$", "", ev.get("name", "?"))
        name = re.sub(r"__\d+$", "", name)
        total[name] += dur
        count[name] += 1
        wall += dur

    print(f"# {path}")
    print(f"# total device-event time {wall / 1e6:.3f} s "
          f"across {sum(count.values())} events")
    print(f"{'total_ms':>10}  {'n':>7}  {'us/ev':>8}  name")
    for name, dur in total.most_common(args.n):
        print(f"{dur / 1e3:10.1f}  {count[name]:7d}  "
              f"{dur / max(count[name], 1):8.1f}  {name[:90]}")


if __name__ == "__main__":
    main()
