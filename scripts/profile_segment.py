#!/usr/bin/env python3
"""XProf-trace a grid-sampler segment to split step cost by phase.

Runs the README 64-point workload's segment program for a few short
segments under ``jax.profiler.trace`` and prints where to find the
trace.  Inspect with XProf/TensorBoard, or grep the .json.gz event
names: the fused secular kernels, the proposal isgood graph, and the
acceptance arithmetic all carry distinct HLO op names.

    python scripts/profile_segment.py          # 1920 lanes, 3x20 steps
    N_POINTS=16 STEPS=50 python scripts/profile_segment.py
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    n_points = int(os.environ.get("N_POINTS", 64))
    steps = int(os.environ.get("STEPS", 20))
    logdir = os.environ.get("LOGDIR", "traces")

    from bench import cascadia_grid
    from pysurfinv_tpu import profiling
    from pysurfinv_tpu.parallel.grid import invert_grid

    pts, lls = cascadia_grid(n_points)
    runN = 30 * steps          # 30 chains/pt at chainL=steps
    out = tempfile.mkdtemp(prefix="profile_segment_")
    # warm up: compile + first segments outside the trace
    invert_grid(pts, lls, outdir=f"{out}/warm", runN=runN,
                chainL=steps, seed=1, segment=steps)
    t0 = time.time()
    with profiling.trace(logdir):
        invert_grid(pts, lls, outdir=f"{out}/traced", runN=runN,
                    chainL=steps, seed=1, segment=steps)
    print(f"traced run: {time.time() - t0:.2f}s "
          f"({n_points * runN} samples) -> {logdir}")


if __name__ == "__main__":
    main()
