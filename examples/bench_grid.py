#!/usr/bin/env python3
"""End-to-end sharded-grid MCMC throughput (the README workload row).

Runs ``invert_grid`` on N_POINTS Cascadia-ocean points x RUN_N Metropolis
samples (every sample = one full 18-period dispersion solve) and reports
effective solves/s — the number that matters for real inversions, as
opposed to bench.py's raw batched-forward ceiling.

    N_POINTS=64 RUN_N=24000 CHAIN_L=800 python examples/bench_grid.py

Environment knobs: MAX_LANES (default auto), SEGMENT (default 100),
OUT (default grid_bench_out).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from examples.invert_point import (  # noqa: E402
    localInfo, periods, setting, uncers, vels)
from pysurfinv_tpu.inversion.point import PointCascadia  # noqa: E402
from pysurfinv_tpu.parallel.grid import invert_grid  # noqa: E402


def main():
    n_points = int(os.environ.get("N_POINTS", 64))
    runN = int(os.environ.get("RUN_N", 24000))
    chainL = int(os.environ.get("CHAIN_L", 800))
    segment = int(os.environ.get("SEGMENT", 100))
    max_lanes = os.environ.get("MAX_LANES", "auto")
    if max_lanes != "auto":
        max_lanes = int(max_lanes)
    outdir = os.environ.get("OUT", "grid_bench_out")

    rng = np.random.default_rng(0)
    pts, lls = [], []
    for k in range(n_points):
        local = dict(localInfo)
        local["sedthk"] = float(0.02 + 0.9 * rng.random())
        local["lithoAge"] = float(0.5 + 8.0 * rng.random())
        pts.append(PointCascadia(setting, local, periods=periods,
                                 vels=vels, uncers=uncers))
        lls.append((228.0 + 0.1 * (k % 8), 45.0 + 0.1 * (k // 8)))

    n_lanes = n_points * (runN // chainL)
    print(f"{n_points} points x {runN} samples (chainL={chainL}, "
          f"{n_lanes} lanes, segment={segment}, max_lanes={max_lanes})")
    t0 = time.time()
    invert_grid(pts, lls, outdir=outdir, runN=runN, chainL=chainL,
                seed=1, segment=segment, max_lanes=max_lanes)
    dt = time.time() - t0
    total = n_points * runN
    print(f"wall {dt:.1f}s  ->  {total / dt:,.0f} effective solves/s "
          f"({total:,} samples)")


if __name__ == "__main__":
    main()
