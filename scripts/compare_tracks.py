#!/usr/bin/env python3
"""Chain-statistics comparator for grid-sampler A/B output dirs.

Solver-knob variants (coarse, nscan, nbisect, ...) change root
*accuracy*, not the chain algebra — so their safety criterion is that
the recorded chains are statistically indistinguishable: same
acceptance rate, same misfit distribution, same best model.  This
prints per-dir aggregates and the deltas.

    python scripts/compare_tracks.py runs/base runs/variant

mcTrack columns (inversion/point.py PostPoint._loadValues):
[misfit, L, accept, theta...] — misfit col 0, likelihood col 1,
accept flag col 2.
"""

import glob
import os
import sys

import numpy as np


def stats(outdir):
    accs, mis_min, mis_med, n = [], [], [], 0
    for f in sorted(glob.glob(os.path.join(outdir, "*.npz"))):
        d = np.load(f)
        t = d["mcTrack"]
        acc = t[:, 2] > 0.5
        accs.append(acc.mean())
        m = t[acc, 0] if acc.any() else t[:, 0]
        mis_min.append(m.min())
        mis_med.append(np.median(m))
        n += 1
    return dict(points=n,
                acceptance=float(np.mean(accs)),
                min_misfit_mean=float(np.mean(mis_min)),
                min_misfit_max=float(np.max(mis_min)),
                med_misfit_mean=float(np.mean(mis_med)))


def main():
    dirs = sys.argv[1:]
    if len(dirs) < 2:
        sys.exit(__doc__)
    rows = [(d, stats(d)) for d in dirs]
    keys = ["points", "acceptance", "min_misfit_mean", "min_misfit_max",
            "med_misfit_mean"]
    print(f"{'dir':40s} " + " ".join(f"{k:>16s}" for k in keys))
    for d, s in rows:
        print(f"{d:40s} " + " ".join(f"{s[k]:16.6g}" for k in keys))
    base = rows[0][1]
    for d, s in rows[1:]:
        print(f"\ndelta vs {rows[0][0]} for {d}:")
        for k in keys[1:]:
            print(f"  {k}: {s[k] - base[k]:+.6g}")


if __name__ == "__main__":
    main()
