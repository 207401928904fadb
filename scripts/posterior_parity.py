#!/usr/bin/env python3
"""Posterior-parity harness: device batched sampler vs host MCinv oracle.

Runs both samplers on the 18-period Cascadia fixture point (the
reference's own end-to-end example, ``/root/reference/point.py:400-410``)
and compares their posteriors with the chain-replicate permutation test
in ``pysurfinv_tpu.inversion.parity`` — acceptance rate, per-theta
posterior mean/std, Vs(z) quantiles.

    # full validation (hours on one CPU core for the host side; the
    # device side runs on the accelerator):
    python scripts/posterior_parity.py --out parity_out --runN 24000 \
        --chainL 800 --seeds 0 1 2 3

    # reuse previously written npz dirs (skip whichever side exists):
    python scripts/posterior_parity.py --out parity_out --runN 24000 \
        --chainL 800 --seeds 0 1 2 3 --compare-only

    # compare two arbitrary npz dirs (e.g. an on-chip device run
    # against an archived host-oracle run):
    python scripts/posterior_parity.py --host-dir HOST --device-dir DEV

Prints one JSON verdict line: per-statistic z-scores (worst first), the
max |z| and its permutation p-value.  p < 0.01 = the two samplers'
posteriors are statistically distinguishable at the run's power.

The host oracle runs with the compiled prior injected
(``parity.fast_host_prior`` — bit-compatible with host ``isgood`` by
tests/test_priors.py) so its proposal/misfit semantics stay host-exact
while >=1e4-step runs remain tractable on one CPU (~0.25 s/step vs
~1.7 s).  Set --slow-prior to use the pure host prior.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_point():
    from examples.invert_point import (localInfo, periods, setting,
                                       uncers, vels)
    from pysurfinv_tpu.inversion.point import PointCascadia
    return PointCascadia(setting, localInfo, periods=periods, vels=vels,
                         uncers=uncers)


def run_host(point, outdir, runN, chainL, seeds, slow_prior=False):
    from pysurfinv_tpu.inversion.parity import fast_host_prior
    prior = None if slow_prior else fast_host_prior(point.initMod)
    os.makedirs(outdir, exist_ok=True)
    for s in seeds:
        pid = f"host_seed{s}"
        if os.path.exists(os.path.join(outdir, pid + ".npz")):
            print(f"# {pid} exists, skipping", file=sys.stderr)
            continue
        t0 = time.time()
        point.MCinv(outdir=outdir, pid=pid, runN=runN, chainL=chainL,
                    seed=s, isgood=prior)
        print(f"# host seed {s}: {time.time() - t0:.0f}s", file=sys.stderr)


def run_device(point, outdir, runN, chainL, seeds):
    os.makedirs(outdir, exist_ok=True)
    for s in seeds:
        pid = f"device_seed{s}"
        if os.path.exists(os.path.join(outdir, pid + ".npz")):
            print(f"# {pid} exists, skipping", file=sys.stderr)
            continue
        t0 = time.time()
        point.MCinvMP(outdir=outdir, pid=pid, runN=runN, chainL=chainL,
                      seed=s, verbose=False)
        print(f"# device seed {s}: {time.time() - t0:.0f}s",
              file=sys.stderr)


def compare(host_dir, device_dir, point, zdeps, n_perm):
    from pysurfinv_tpu.inversion.parity import (chain_statistics,
                                                compare_posteriors,
                                                glob_npz,
                                                pooled_threshold)
    hf, df = glob_npz(host_dir), glob_npz(device_dir)
    if not hf or not df:
        sys.exit(f"missing npz files: host={len(hf)} device={len(df)}")
    thres = pooled_threshold([hf, df])
    mod = point.initMod if point is not None else None
    sh, _ = chain_statistics(hf, zdeps=zdeps, thres=thres, vs_model=mod)
    sd, _ = chain_statistics(df, zdeps=zdeps, thres=thres, vs_model=mod)
    res = compare_posteriors(sh, sd, n_perm=n_perm)
    ranked = sorted(res["z"].items(), key=lambda kv: -abs(kv[1]))
    out = {
        "p_value": res["p_value"], "max_abs_z": res["max_abs_z"],
        "worst": res["worst"], "n_host_chains": res["n_a"],
        "n_device_chains": res["n_b"], "threshold": thres,
        "host_acc": float(__import__("numpy").nanmean(sh["acceptance"])),
        "device_acc": float(__import__("numpy").nanmean(sd["acceptance"])),
        "top_z": {k: round(v, 2) for k, v in ranked[:8]},
    }
    print(json.dumps(out))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="parity_out")
    ap.add_argument("--host-dir")
    ap.add_argument("--device-dir")
    ap.add_argument("--runN", type=int, default=24000)
    ap.add_argument("--chainL", type=int, default=800)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--zdeps", type=float, nargs="+",
                    default=[5, 15, 30, 60, 100, 150])
    ap.add_argument("--n-perm", type=int, default=4000)
    ap.add_argument("--compare-only", action="store_true")
    ap.add_argument("--slow-prior", action="store_true")
    ap.add_argument("--skip-host", action="store_true")
    ap.add_argument("--skip-device", action="store_true")
    args = ap.parse_args()

    if args.skip_host and not args.skip_device:
        pass
    elif args.skip_device or args.compare_only:
        # Host-only (or compare-only) runs pin JAX to the LOCAL CPU:
        # otherwise the fast host prior's jit dispatches every tiny
        # isgood call to the accelerator, a launch and a round trip
        # each.
        from pysurfinv_tpu.testing import force_cpu
        force_cpu(1)

    point = build_point()
    host_dir = args.host_dir or os.path.join(args.out, "host")
    device_dir = args.device_dir or os.path.join(args.out, "device")
    if not args.compare_only:
        if not args.skip_device:
            run_device(point, device_dir, args.runN, args.chainL,
                       args.seeds)
        if not args.skip_host:
            run_host(point, host_dir, args.runN, args.chainL, args.seeds,
                     slow_prior=args.slow_prior)
    compare(host_dir, device_dir, point, args.zdeps, args.n_perm)


if __name__ == "__main__":
    main()
