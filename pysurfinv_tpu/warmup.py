"""Compile-cache warmup CLI for production grid inversions.

A fresh process running ``invert_grid`` pays, once per model structure:
host tracing of the segment/init programs (~20-30 s) plus XLA
compilation of the fused sampler program (minutes cold; seconds when
the persistent compile cache at ``~/.cache/pysurfinv_jit`` already
holds it).  The compiled program is keyed by *shapes* — lane count
(points x chains), period count, segment length, chainL — so priming
the cache requires running the exact production shapes once.

This CLI does exactly that: it builds a same-structure dummy grid,
traces + compiles the production programs, executes ONE segment (so the
compile actually happens and lands in the persistent cache), then
stops.  Run it once per machine (or after a jax/library upgrade):

    python -m pysurfinv_tpu.warmup --points 256 --runN 24000 \
        --chainL 800 --segment 100

    # with a custom model setting + localInfo (structure must match
    # the production points):
    python -m pysurfinv_tpu.warmup --setting my_setting.yml \
        --local '{"topo": -2, "sedthk": 0.5, "lithoAge": 4}' ...

After warmup, a fresh production process on the same machine pays only
host tracing; the XLA compile is a cache load.  The JSON line this
tool prints gives the local numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def _example_point(setting_path=None, local=None, periods=None,
                   vels=None, uncers=None):
    from pysurfinv_tpu.inversion.point import Point, PointCascadia

    if setting_path:
        import yaml
        with open(setting_path) as f:
            setting = yaml.safe_load(f)
        from examples.invert_point import (localInfo as ex_local,
                                           periods as ex_T,
                                           uncers as ex_u, vels as ex_c)
        cls = (PointCascadia if "Cascadia" in str(
            setting.get("Info", {}).get("modelType", "")) else Point)
        return cls(setting, local if local is not None else ex_local,
                   periods=periods or ex_T, vels=vels or ex_c,
                   uncers=uncers or ex_u)
    from examples.invert_point import (localInfo, periods as ex_T,
                                       setting, uncers as ex_u,
                                       vels as ex_c)
    return PointCascadia(setting, local if local is not None else localInfo,
                         periods=periods or ex_T, vels=vels or ex_c,
                         uncers=uncers or ex_u)


def warmup(n_points=64, runN=24000, chainL=800, segment=100,
           setting=None, local=None, verbose=True):
    """Trace + compile + run one segment of the production programs."""
    from pysurfinv_tpu.parallel.grid import invert_grid
    from pysurfinv_tpu.utils import configure_jit_cache

    configure_jit_cache()
    point = _example_point(setting, local)
    pts = [point] * n_points
    lls = [(228.0 + 0.01 * i, 45.0) for i in range(n_points)]
    out = tempfile.mkdtemp(prefix="pysurfinv_warmup_")
    t0 = time.time()
    try:
        invert_grid(pts, lls, outdir=out, runN=runN, chainL=chainL,
                    segment=segment, seed=0, verbose=False,
                    _abort_after_segments=1)
    except KeyboardInterrupt:
        pass  # the abort hook signals "one segment done"
    finally:
        shutil.rmtree(out, ignore_errors=True)
    dt = time.time() - t0
    info = {"warmup_s": round(dt, 1), "points": n_points, "runN": runN,
            "chainL": chainL, "segment": segment,
            "cache": os.environ.get("PYSURFINV_JIT_CACHE",
                                    "~/.cache/pysurfinv_jit")}
    if verbose:
        print(json.dumps(info))
    return info


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pysurfinv_tpu.warmup",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--setting", help="model-setting YAML "
                    "(default: the Cascadia example fixture)")
    ap.add_argument("--local", type=json.loads,
                    help='localInfo JSON, e.g. \'{"topo": -2}\'')
    ap.add_argument("--points", type=int, default=64)
    ap.add_argument("--runN", type=int, default=24000)
    ap.add_argument("--chainL", type=int, default=800)
    ap.add_argument("--segment", type=int, default=100)
    args = ap.parse_args(argv)
    warmup(n_points=args.points, runN=args.runN, chainL=args.chainL,
           segment=args.segment, setting=args.setting, local=args.local)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
