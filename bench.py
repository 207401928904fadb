#!/usr/bin/env python3
"""Benchmark: batched surface-wave dispersion solves per second per device.

One "solve" = a full fundamental-mode Rayleigh phase+group dispersion
curve (18 periods, Cascadia-ocean-like 86-layer model, attenuation +
earth-flattening + per-period root search), i.e. exactly one reference
``fast_surf`` call (models.py:27).

The parent process never imports JAX: it runs each phase (forward,
MCMC, primed fresh-process MCMC) as a child process in turn, so only
one process holds the device at a time.  After each phase it prints the
merged result as one JSON line; the LAST line is authoritative.  A
failed phase exits non-zero after the lines already printed.

    python bench.py                  # all phases
    python bench.py --phase forward  # one phase, in this process
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

PERIODS = [10, 12, 14, 16, 18, 20, 22, 24, 26, 28, 30, 32, 36, 40, 50, 60,
           70, 80]


def build_batch(B, rng):
    """B perturbed Cascadia-ocean-like layered models (86 real layers,
    padded up to a multiple of 8)."""
    from pysurfinv_tpu.models.model1d import buildModel1D
    from pysurfinv_tpu.utils import host_eager

    yml = {
        "OceanWater": {"H": 2},
        "OceanSedimentCascadia": {"H": 0.5},
        "OceanCrust": {"H": 7, "Vs": [3.25, 3.94]},
        "OceanMantleHybrid": {
            "BottomDepth": 200, "Conversion": "Ritzwoller",
            "ThermAge": 4.0,
            "Vs": [[0.02, "fixed"], [0.01, "fixed"],
                   [-0.01, "fixed"], [-0.02, "fixed"]],
        },
        "Info": {"modelType": "CascadiaOcean", "period": 10,
                 "refLayer": True, "lithoAgeQ": True},
    }
    with host_eager():
        mod = buildModel1D(yml, {"topo": -2, "sedthk": 0.5,
                                 "lithoAge": 4.0})
        h, vs, vp, rho, qs, qp, _ = mod.seisPropLayers(refLayer=True)
    keep = h > 1e-3
    h, vs, vp, rho, qs = h[keep], vs[keep], vp[keep], rho[keep], qs[keep]
    nlay = len(h)
    L = int(-(-(nlay + 1) // 8) * 8)
    pad = L - nlay

    def p(x, fill):
        return np.concatenate([x, np.full(pad, fill)])

    base = np.stack([p(h, 0.0), p(vp, vp[-1]), p(vs, vs[-1]),
                     p(rho, rho[-1]), p(1.0 / qs, 1.0 / qs[-1])])
    batch = np.repeat(base[None], B, axis=0)
    # +-0.5% multiplicative jitter on Vs (keeps models physical)
    jit = 1.0 + 0.005 * rng.standard_normal((B, L))
    batch[:, 2] *= np.where(base[0] > 0, jit, 1.0)
    batch[:, 1] *= np.where(base[0] > 0, jit, 1.0)
    return batch, nlay


def bench_cfgs():
    """(Rayleigh, Love) solver configs of the forward bench.

    nbisect=8 Illinois from the 2*dc warm bracket; nscan=12 at coarse=2
    with warm_backoff=4 covers c(T) steps up to 0.16 km/s between
    adjacent periods, ~4x the largest step of the shipped model
    families; coarse_first=16 halves the cold first-period sweep.  Love
    runs 2 fewer Illinois iterations: its secular function is far better
    conditioned.  Accuracy against the XLA oracle is checked by
    chip_smoke.py; the timings behind these choices predate the GPU
    and are to be re-measured (ROADMAP §1).
    """
    from pysurfinv_tpu.ops.dispersion import SurfConfig

    e = os.environ.get
    cfg = SurfConfig(
        nmodes=1,
        nscan_first=int(e("BENCH_NSCAN_FIRST", 512)),
        nscan=int(e("BENCH_NSCAN", 12)),
        nbisect=int(e("BENCH_NBISECT", 8)),
        nnewton=int(e("BENCH_NNEWTON", 0)),
        newton_sep=int(e("BENCH_NEWTON_SEP", 0)),
        warm_backoff=int(e("BENCH_BACKOFF", 4)),
        coarse_first=int(e("BENCH_COARSE_FIRST", 16)),
        backend=e("BENCH_BACKEND", "auto"),
        compute_group=e("BENCH_GROUP", "1") == "1")
    return cfg, cfg._replace(nbisect=int(e("BENCH_NBISECT_LOVE", 6)))


def cascadia_grid(n_points, seed=0):
    """(points, lonlats): ``n_points`` Cascadia points of
    examples/invert_point.py with random sediment thickness and plate
    age — one model structure, so one compiled sampler serves all."""
    from examples.invert_point import (localInfo, periods, setting,
                                       uncers, vels)
    from pysurfinv_tpu.inversion.point import PointCascadia

    rng = np.random.default_rng(seed)
    pts, lls = [], []
    for k in range(n_points):
        local = dict(localInfo)
        local["sedthk"] = float(0.02 + 0.9 * rng.random())
        local["lithoAge"] = float(0.5 + 8.0 * rng.random())
        pts.append(PointCascadia(setting, local, periods=periods,
                                 vels=vels, uncers=uncers))
        lls.append((228.0 + 0.1 * (k % 8), 45.0 + 0.1 * (k // 8)))
    return pts, lls


def phase_forward():
    import jax.numpy as jnp

    from pysurfinv_tpu.ops.dispersion import (surf_forward_batch,
                                              surf_forward_joint)
    from pysurfinv_tpu.utils import configure_jit_cache
    configure_jit_cache()

    B = int(os.environ.get("BENCH_BATCH", 65536))
    periods = jnp.asarray(np.array(PERIODS, dtype=np.float32))
    batch, nlay = build_batch(B, np.random.default_rng(0))
    H, VP, VS, RHO, QSI = (jnp.asarray(batch[:, i], jnp.float32)
                           for i in range(5))
    NL = jnp.full((B,), nlay, dtype=jnp.int32)
    cfg, cfg_love = bench_cfgs()

    def make_run(wave):
        wcfg = cfg_love if wave == "love" else cfg

        def run():
            c, u, ok = surf_forward_batch(H, VP, VS, RHO, QSI, periods,
                                          NL, wave=wave, cfg=wcfg)
            return c, ok
        return run

    def run_joint():
        cr, ur, okr, cl, ul, okl = surf_forward_joint(
            H, VP, VS, RHO, QSI, periods, NL, cfg=cfg, cfg_love=cfg_love)
        return cl, okr & okl

    def time_best(run):
        """Best of 3 windows of BENCH_ITERS calls, each synced by a
        one-row host fetch of every result."""
        c, ok = run()   # warmup / compile
        np.asarray(c[:1])
        frac_ok = float(np.asarray(ok[:, :, 0]).all(axis=1).mean())
        n_iter = int(os.environ.get("BENCH_ITERS", 2))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            outs = [run() for _ in range(n_iter)]
            for cc, _ in outs:
                np.asarray(cc[:1])
            best = min(best, (time.perf_counter() - t0) / n_iter)
        return best, frac_ok

    t_r, ok_r = time_best(make_run("rayleigh"))
    t_l, ok_l = time_best(make_run("love"))
    t_j, ok_j = time_best(run_joint)
    return {
        "metric": "rayleigh_dispersion_solves_per_sec_per_chip",
        "value": round(B / t_r, 1),
        "unit": "solves/s (18-period fundamental-mode curve, batch "
                f"{B}, ok={ok_r:.3f})",
        "love_solves_per_sec": round(B / t_l, 1),
        "love_ok": round(ok_l, 3),
        "joint_rl_solves_per_sec": round(B / t_j, 1),
        "joint_rl_ok": round(ok_j, 3),
    }


def _mcmc_workload():
    e = os.environ.get
    return (int(e("BENCH_MCMC_POINTS", 64)), int(e("BENCH_MCMC_RUNN", 6000)),
            int(e("BENCH_MCMC_CHAINL", 200)))


def _run_grid(n_points, runN, chainL):
    import tempfile

    from pysurfinv_tpu.parallel.grid import invert_grid

    pts, lls = cascadia_grid(n_points)
    with tempfile.TemporaryDirectory(prefix="bench_mcmc_") as out:
        t0 = time.perf_counter()
        invert_grid(pts, lls, outdir=out, runN=runN, chainL=chainL,
                    seed=1, segment=100, verbose=False)
        return time.perf_counter() - t0


def phase_mcmc():
    """End-to-end sharded MCMC throughput (BASELINE configs 4-5).

    One effective "solve" = one Metropolis sample (proposal build +
    prior checks + fused 18-period forward + accept + chain record)
    of ``invert_grid``.  Steady state = the second call: the traced
    sampler program is cached per model structure.  The cold first
    call is reported alongside.
    """
    from pysurfinv_tpu.utils import configure_jit_cache
    configure_jit_cache()
    n_points, runN, chainL = _mcmc_workload()
    times = [_run_grid(n_points, runN, chainL) for _ in range(2)]
    return {
        "mcmc_effective_solves_per_sec": round(n_points * runN
                                               / min(times), 1),
        "mcmc_workload": f"{n_points} pts x {runN} samples "
                         f"(chainL={chainL}, "
                         f"{n_points * runN // chainL} lanes), "
                         "steady state",
        "mcmc_cold_first_call_s": round(times[0], 1),
    }


def phase_primed():
    """First call of a fresh process on a primed compile cache (the MCMC
    phase filled it): host tracing + executable load + the run."""
    t0 = time.perf_counter()
    from pysurfinv_tpu.utils import configure_jit_cache
    configure_jit_cache()
    _run_grid(*_mcmc_workload())
    return {"mcmc_primed_fresh_process_s":
            round(time.perf_counter() - t0, 1)}


PHASES = {"forward": phase_forward, "mcmc": phase_mcmc,
          "primed": phase_primed}


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--phase":
        print("BENCH_PHASE " + json.dumps(PHASES[sys.argv[2]]()),
              flush=True)
        return 0
    phases = ["forward"]
    if os.environ.get("BENCH_MCMC", "1") == "1":
        phases.append("mcmc")
        if os.environ.get("BENCH_MCMC_PRIMED", "1") == "1":
            phases.append("primed")
    result = {}
    for phase in phases:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--phase", phase],
            stdout=subprocess.PIPE, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("BENCH_PHASE ")]
        if proc.returncode != 0 or not lines:
            print(f"# bench phase {phase} failed (rc={proc.returncode})",
                  file=sys.stderr, flush=True)
            return 1
        result.update(json.loads(lines[-1][len("BENCH_PHASE "):]))
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
