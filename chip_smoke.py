#!/usr/bin/env python3
"""Smoke test of the main path on an NVIDIA GPU.

Run from the repository root on a machine with a card:

    python chip_smoke.py             # one card: kernels, forward, MCMC
    python chip_smoke.py --cards 4   # only the sharded grid, 4 vs 1 card

Phases on one card, all in float32:

  1. device   JAX must run on a GPU (else exit 2, printing no result);
              the card's name and power limit print on every record.
  2. kernels  each Triton kernel at B = 65,536 bench models, L = 88,
              18 periods, Rayleigh and Love, against the plain XLA
              reference (``ops/secular.py`` vmapped over the lanes);
              the lowered ``surf_forward_batch`` must hold the Triton
              custom call (compiled, not interpreted).
  3. forward  ``surf_forward_batch`` (Rayleigh, Love) and
              ``surf_forward_joint`` at the bench shape against the
              vmapped XLA oracle (``backend="xla"``) on 4,096 models.
  4. mcmc     ``invert_grid`` on 64 Cascadia points x 24,000 samples
              (chainL 800: 1,920 lanes), ``retries=0``.

``--cards 4`` runs only that grid on four cards and on one, and compares
them chain by chain and point by point.

Every record is one JSON line.  Any failed phase exits 1 and never
prints the final line, which is exactly
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
# the XLA oracle's scan unroll changes its speed, not its results; rolled
# scans compile several times faster, and compiling the oracle is most
# of this script's cold run
os.environ.setdefault("PYSURFINV_SCAN_UNROLL", "1")
B_KERNEL = 65536
N_SUBSET = 4096
RUN_N, CHAIN_L = 24000, 800   # the reference's production chain shape
N_POINTS = 64                 # grid points of the MCMC phases
# forward tolerances against the XLA oracle (km/s): |dc| q99, |du| q99
# (the 0.1% parity budget at ~4 km/s), and max |dc| relative to c
DC_Q99, DU_Q99, DC_MAX_REL = 1e-4, 4e-3, 1e-3
# the sampler's solver config (parallel.grid.mcmc_solver_cfg: 8*dc
# brackets, 3 separated Newton launches) is held to its own committed
# gate, tests/test_warm_roots.py: |dc| q99 <= 1.5e-3, max <= 8e-3 km/s
MCMC_DC_Q99, MCMC_DC_MAX = 1.5e-3, 8e-3
NOISE = 1e-3  # secular-value noise floor, relative to the median |F|
# Group velocity is ill-conditioned in f32 on a few lanes (F_T/F_c at
# a root, or at an off-root probe where F_c ~ 0): there the kernel and
# the f32 reference each stray from an f64 evaluation.  Bounded counts,
# not quantiles alone, so that a tangent regression fails the run:
# kernels: share of probes whose F_T/F_c is beyond 2e-3 of the reference
# (H100: 0.08% Rayleigh, 0.11% Love); forward: lanes of the 4,096 x 18
# subset with |du| beyond 0.1 and beyond 0.01 km/s (H100: at most 4
# and 81).
TANGENT_BAD_SHARE = 2e-3
DU_OUTLIERS = ((0.1, 10), (0.01, 200))
# --cards 4 against one card.  Batch width changes the f32 code XLA
# generates for the sampler (480-lane tiles on one card give the same
# gap as four cards), and the sampler's solver moves a root within its
# gate on such a change, after which one flipped accept decision
# re-routes a chain.  Start thetas must be equal; a start-row misfit,
# the RMS of residuals over uncertainties, may move by at most
# 2 * MCMC_DC_MAX / min(uncertainty).  Per point, acceptance and the
# late misfit are held to what a different seed gives on one card
# (H100: acceptance within 0.034, late misfit within 85% per point and
# 15% over a 16-point shard).
CARDS_ACC, CARDS_LATE_POINT, CARDS_LATE_SHARD = 0.05, 1.0, 0.25


def card_info():
    """``name, power.limit`` of the cards as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"


def gpu_devices(n):
    """The first ``n`` GPU devices; RuntimeError if JAX has fewer."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        raise RuntimeError(
            f"needs {n} GPU(s); JAX runs on {len(devs)} "
            f"{devs[0].platform} device(s)")
    return devs[:n]


class Smoke:
    def __init__(self, card):
        self.card = card
        self.failed = []

    def emit(self, **rec):
        rec["card"] = self.card
        print(json.dumps(rec, default=float), flush=True)

    def check(self, phase, cond, what):
        if not cond:
            self.failed.append(f"{phase}: {what}")
            self.emit(phase=phase, check_failed=what)

    def run(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            fn(self, *args)
        except Exception as e:  # noqa: BLE001 — report, then fail the run
            traceback.print_exc()
            self.failed.append(f"{name}: {type(e).__name__}: {e}")
            self.emit(phase=name, error=f"{type(e).__name__}: {e}"[:2000])
        self.emit(phase=name, seconds=time.perf_counter() - t0)


def _bench_models(B):
    import jax.numpy as jnp
    import numpy as np

    from bench import build_batch
    batch, nlay = build_batch(B, np.random.default_rng(0))
    arrs = tuple(jnp.asarray(batch[:, i], jnp.float32) for i in range(5))
    return arrs, jnp.full((B,), nlay, jnp.int32)


def _quantiles(x):
    import numpy as np
    return {"q50": float(np.quantile(x, 0.5)),
            "q99": float(np.quantile(x, 0.99)), "max": float(x.max())}


def _signs(F, Fx):
    """Sign agreement of kernel and reference secular values.

    Both renormalise the recursion every layer but round differently
    (the kernel multiplies by 1/(rho c^2) where the reference divides),
    so where a probe sits within ~1e-6 km/s of a root, F is f32 noise
    and its sign is not shared.  Disagreements must all lie below
    NOISE x the median |F| of the batch; what they do to roots is
    bounded by the forward phase's |dc|.
    """
    import numpy as np
    bad = np.sign(F) != np.sign(Fx)
    floor = NOISE * float(np.median(np.abs(Fx)))
    return {"sign_mismatch": int(bad.sum()),
            "sign_mismatch_above_noise": int((bad & (np.abs(Fx) > floor))
                                             .sum()),
            "noise_floor": floor}


def phase_kernels(sm):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import PERIODS, bench_cfgs
    from pysurfinv_tpu.ops import pallas_secular as ps
    from pysurfinv_tpu.ops import xla_lanes as ref
    from pysurfinv_tpu.ops.dispersion import lane_model, surf_forward_batch

    (H, VP, VS, RHO, QSI), NL = _bench_models(B_KERNEL)
    per = np.asarray(PERIODS, np.float32)
    cs = np.linspace(3.0, 4.6, 4, dtype=np.float32)
    ones = np.ones((1, B_KERNEL), np.float32)
    c = jnp.asarray(np.repeat(cs, len(per))[:, None] * ones)
    t = jnp.asarray(np.tile(per, len(cs))[:, None] * ones)
    zero = jnp.zeros(c.shape, jnp.int32)
    for wave in ("rayleigh", "love"):
        _, mT = lane_model(H, VP, VS, RHO, QSI, NL, wave)
        F, bhs, mm = map(np.asarray,
                         ps.secular_lanes(c, t, zero, *mT, NL, wave=wave))
        Fx, bx, mx = map(np.asarray,
                         ref.secular_lanes(c, t, zero, *mT, NL, wave=wave))
        rec = dict(phase="kernels", kernel="secular_lanes", wave=wave,
                   lanes=int(F.size), mm_mismatch=int((mm != mx).sum()),
                   bhs_max_rel=float(np.max(np.abs(bhs - bx) / np.abs(bx))),
                   **_signs(F, Fx))
        sm.emit(**rec)
        sm.check("kernels", rec["mm_mismatch"] == 0, f"{wave} mm differs")
        sm.check("kernels", rec["bhs_max_rel"] <= 1e-6,
                 f"{wave} b_hs beyond rtol 1e-6")
        sm.check("kernels", rec["sign_mismatch_above_noise"] == 0,
                 f"{wave} secular sign differs above the noise floor")

        mmf = jnp.asarray(np.maximum(mx, 2))
        Ff = np.asarray(ps.secular_lanes_frozen(c, t, mmf, *mT, NL,
                                                wave=wave))
        Ffx = np.asarray(ref.secular_lanes_frozen(c, t, mmf, *mT, NL,
                                                  wave=wave))
        Fg, Fc, Ft = map(np.asarray, ps.secular_lanes_grad(
            c, t, mmf, *mT, NL, wave=wave))
        _, Fcx, Ftx = map(np.asarray, ref.secular_lanes_grad(
            c, t, mmf, *mT, NL, wave=wave))
        # F_T/F_c is what the group velocity consumes (the tangents
        # themselves carry each path's renormalisation factors)
        ratio = np.abs(Ft / Fc - Ftx / Fcx) / np.maximum(
            np.abs(Ftx / Fcx), 1e-6)
        frozen = _signs(Ff, Ffx)
        rec = dict(phase="kernels", kernel="frozen+grad", wave=wave,
                   frozen=frozen,
                   grad_primal_equals_frozen=bool(np.array_equal(Fg, Ff)),
                   tangent_ratio_rel=_quantiles(ratio))
        sm.emit(**rec)
        sm.check("kernels", frozen["sign_mismatch_above_noise"] == 0,
                 f"{wave} frozen secular sign differs above the noise")
        sm.check("kernels", rec["grad_primal_equals_frozen"],
                 f"{wave} grad kernel primal differs from frozen kernel")
        bad = float(np.mean(ratio > 2e-3))
        sm.emit(phase="kernels", wave=wave, tangent_ratio_bad_share=bad)
        sm.check("kernels", bad <= TANGENT_BAD_SHARE,
                 f"{wave} share of tangent ratios beyond 2e-3 "
                 f"> {TANGENT_BAD_SHARE}")

    # refine_lanes (the nnewton opt-in) against the default refinement,
    # and the compiled program holds the Triton call
    cfg, _ = bench_cfgs()
    P = jnp.asarray(per)
    args = (H, VP, VS, RHO, QSI, P, NL)
    c0, _, ok0 = surf_forward_batch(*args, wave="rayleigh", cfg=cfg)
    c1, _, ok1 = surf_forward_batch(*args, wave="rayleigh",
                                    cfg=cfg._replace(nnewton=2))
    both = np.asarray(ok0 & ok1)
    dc = np.abs(np.asarray(c0) - np.asarray(c1))[both]
    sm.emit(phase="kernels", kernel="refine_lanes", wave="rayleigh",
            ok_equal=bool(np.array_equal(ok0, ok1)), dc=_quantiles(dc))
    sm.check("kernels", np.quantile(dc, 0.99) <= DC_Q99,
             "refine_lanes roots beyond |dc| q99")
    lowered = surf_forward_batch.lower(*args, wave="rayleigh", cfg=cfg)
    has_triton = "__gpu$xla.gpu.triton" in lowered.as_text()
    mem = lowered.compile().memory_analysis()
    sm.emit(phase="kernels", hlo_has_triton_call=has_triton,
            memory_analysis=str(mem))
    sm.check("kernels", has_triton, "no Triton call in the lowered HLO")
    jax.clear_caches()


def _compare(sm, name, cp, up, okp, cx, ux, okx, dc_q99=DC_Q99,
             dc_max=None, check_du_outliers=True):
    import numpy as np
    cp, up, okp, cx, ux, okx = map(np.asarray, (cp, up, okp, cx, ux, okx))
    both = okp & okx
    dc = np.abs(cp - cx)[both]
    du = np.abs(up - ux)[both]
    rel = (dc / cx[both]).max()
    outliers = {f"du_gt_{lim}": int((du > lim).sum())
                for lim, _ in DU_OUTLIERS}
    sm.emit(phase="forward", case=name, ok_fraction=float(okp.mean()),
            ok_fraction_oracle=float(okx.mean()), dc=_quantiles(dc),
            du=_quantiles(du), dc_max_rel=float(rel), precision="float32",
            **outliers)
    sm.check("forward", np.array_equal(okp, okx), f"{name} ok masks differ")
    sm.check("forward", np.quantile(dc, 0.99) <= dc_q99,
             f"{name} |dc| q99 > {dc_q99}")
    sm.check("forward", rel <= DC_MAX_REL, f"{name} max |dc|/c > 0.1%")
    if dc_max is not None:
        sm.check("forward", dc.max() <= dc_max,
                 f"{name} max |dc| > {dc_max}")
    sm.check("forward", np.quantile(du, 0.99) <= DU_Q99,
             f"{name} |du| q99 > {DU_Q99}")
    if check_du_outliers:
        for lim, most in DU_OUTLIERS:
            sm.check("forward", outliers[f"du_gt_{lim}"] <= most,
                     f"{name} more than {most} lanes with |du| > {lim}")


def phase_forward(sm):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bench import PERIODS, bench_cfgs
    from pysurfinv_tpu.ops.dispersion import (surf_forward_batch,
                                              surf_forward_joint)

    (H, VP, VS, RHO, QSI), NL = _bench_models(B_KERNEL)
    P = jnp.asarray(np.asarray(PERIODS, np.float32))
    cfg, cfg_love = bench_cfgs()
    sub = slice(0, B_KERNEL, B_KERNEL // N_SUBSET)
    args = (H, VP, VS, RHO, QSI, P, NL)
    args_s = (H[sub], VP[sub], VS[sub], RHO[sub], QSI[sub], P, NL[sub])
    oracle = {}
    for wave, wcfg in (("rayleigh", cfg), ("love", cfg_love)):
        t0 = time.perf_counter()
        c, u, ok = jax.block_until_ready(
            surf_forward_batch(*args, wave=wave, cfg=wcfg))
        sec = time.perf_counter() - t0
        sm.emit(phase="forward", case=wave, models=B_KERNEL,
                first_call_s=sec,
                ok_fraction_all=float(np.asarray(ok).mean()))
        oracle[wave] = surf_forward_batch(
            *args_s, wave=wave, cfg=wcfg._replace(backend="xla"))
        _compare(sm, wave, c[sub], u[sub], ok[sub], *oracle[wave])
    cR, uR, okR, cL, uL, okL = jax.block_until_ready(
        surf_forward_joint(*args, cfg=cfg, cfg_love=cfg_love))
    _compare(sm, "joint_rayleigh", cR[sub], uR[sub], okR[sub],
             *oracle["rayleigh"])
    _compare(sm, "joint_love", cL[sub], uL[sub], okL[sub], *oracle["love"])
    jax.clear_caches()


class _CompileClock:
    """Sums backend compile seconds reported through jax.monitoring."""

    def __init__(self):
        import jax
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration


def _grid(mesh, outdir, clock):
    import numpy as np

    from bench import cascadia_grid
    from pysurfinv_tpu.parallel.grid import invert_grid

    pts, lls = cascadia_grid(N_POINTS)
    c0 = clock.seconds
    t0 = time.perf_counter()
    paths = invert_grid(pts, lls, outdir=outdir, runN=RUN_N, chainL=CHAIN_L,
                        seed=1, segment=100, retries=0, mesh=mesh,
                        verbose=True)
    wall = time.perf_counter() - t0
    tracks = [np.load(p, allow_pickle=True)["mcTrack"] for p in paths]
    return pts, paths, tracks, wall, clock.seconds - c0


def phase_mcmc(sm, clock):
    import jax.numpy as jnp
    import numpy as np

    from pysurfinv_tpu.inversion.compiled import CompiledModel
    from pysurfinv_tpu.ops.dispersion import surf_forward_batch
    from pysurfinv_tpu.parallel.grid import mcmc_solver_cfg
    from pysurfinv_tpu.parallel.mesh import points_mesh

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out:
        pts, paths, tracks, wall, comp = _grid(points_mesh(1), out, clock)
    n_ch = RUN_N // CHAIN_L
    sm.emit(phase="mcmc", points=N_POINTS, samples_per_point=RUN_N,
            chainL=CHAIN_L, lanes=N_POINTS * n_ch, wall_s=wall,
            compile_s=comp, run_s=wall - comp)
    sm.check("mcmc", len(paths) == N_POINTS, "npz count")
    acc = np.mean([t[:, 2].mean() for t in tracks])
    finite = all(np.isfinite(t).all() for t in tracks)
    # misfit at each chain's first row vs its last quarter
    mis = [t[:, 0].reshape(n_ch, CHAIN_L) for t in tracks]
    falls = np.mean([m[:, -CHAIN_L // 4:].mean() < m[:, 0].mean()
                     for m in mis])
    sm.emit(phase="mcmc", finite=finite, acceptance=float(acc),
            share_of_points_whose_misfit_falls=float(falls))
    sm.check("mcmc", finite, "non-finite track values")
    sm.check("mcmc", 0.02 <= acc <= 0.9, "acceptance outside [0.02, 0.9]")
    sm.check("mcmc", falls >= 0.9, "misfits do not fall")

    # the first forward of the initial models, kernels vs XLA oracle
    cm = CompiledModel(pts[0].initMod)
    th = jnp.stack([cm.spec_of(p.initMod).theta0 for p in pts])
    ps_ = jnp.stack([jnp.asarray(cm.psi_of(p.initMod)) for p in pts])
    prof = cm.build_profile_batch(th.astype(jnp.float32),
                                  ps_.astype(jnp.float32))
    per = jnp.asarray(np.asarray(pts[0].obs["T"], np.float32))
    scfg = mcmc_solver_cfg()
    cp, up, okp = surf_forward_batch(*prof[:5], per, prof[5], cfg=scfg)
    cx, ux, okx = surf_forward_batch(*prof[:5], per, prof[5],
                                     cfg=scfg._replace(backend="xla"))
    _compare(sm, "mcmc_initial_models", cp, up, okp, cx, ux, okx,
             dc_q99=MCMC_DC_Q99, dc_max=MCMC_DC_MAX,
             check_du_outliers=False)


def phase_cards(sm, n_cards, clock):
    import numpy as np

    from examples.invert_point import uncers
    from pysurfinv_tpu.parallel.mesh import points_mesh

    runs = {}
    for n in (n_cards, 1):
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{n}_") as out:
            _, _, tracks, wall, comp = _grid(points_mesh(n), out, clock)
        # (point, chain, step, [misfit, L, accept] + theta)
        runs[n] = np.stack(tracks).reshape(N_POINTS, RUN_N // CHAIN_L,
                                           CHAIN_L, -1)
        sm.emit(phase="cards", cards=n, points=N_POINTS, wall_s=wall,
                compile_s=comp, run_s=wall - comp)
    X, Y = runs[n_cards], runs[1]
    n_diff = sum(not np.array_equal(a, b) for a, b in zip(X, Y))
    # row 0 of every chain evaluates its start, before any accept decision
    theta0_equal = bool(np.array_equal(X[:, :, 0, 3:], Y[:, :, 0, 3:]))
    d0 = np.abs(X[:, :, 0, 0] - Y[:, :, 0, 0])
    d0_most = 2 * MCMC_DC_MAX / min(uncers)
    acc = [R[..., 2].mean((1, 2)) for R in (X, Y)]
    late = [R[:, :, -CHAIN_L // 4:, 0].mean((1, 2)) for R in (X, Y)]
    d_acc = np.abs(acc[0] - acc[1])
    d_late = np.abs(late[0] - late[1]) / late[1]
    shard = [v.reshape(n_cards, -1).mean(1) for v in late]
    d_shard = np.abs(shard[0] - shard[1]) / shard[1]
    sm.emit(phase="cards", points_bitwise_equal=N_POINTS - n_diff,
            start_theta_equal=theta0_equal,
            chains_start_misfit_differs=int((d0 > 0).sum()),
            start_misfit_absdiff=_quantiles(d0), start_misfit_bound=d0_most,
            acceptance_absdiff=_quantiles(d_acc),
            late_misfit_reldiff=_quantiles(d_late),
            late_misfit_reldiff_per_shard=d_shard.tolist(),
            acceptance=[float(a.mean()) for a in acc],
            late_misfit=[float(v.mean()) for v in late])
    sm.check("cards", theta0_equal, "start thetas differ")
    sm.check("cards", d0.max() <= d0_most,
             f"a start-row misfit moved by more than {d0_most}")
    sm.check("cards", d_acc.max() <= CARDS_ACC,
             f"a point's acceptance differs by more than {CARDS_ACC}")
    sm.check("cards", d_late.max() <= CARDS_LATE_POINT,
             f"a point's late misfit differs by more than "
             f"{CARDS_LATE_POINT:.0%}")
    sm.check("cards", d_shard.max() <= CARDS_LATE_SHARD,
             f"a shard's late misfit differs by more than "
             f"{CARDS_LATE_SHARD:.0%}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded grid, 4 cards vs 1")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    import jax

    import pysurfinv_tpu  # noqa: F401 — fails outside a checkout
    try:
        devs = gpu_devices(args.cards)
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    card = card_info()
    print(f"card: {card}", flush=True)
    from pysurfinv_tpu.utils import configure_jit_cache
    configure_jit_cache()
    sm = Smoke(card)
    sm.emit(phase="device", platform=devs[0].platform,
            kind=devs[0].device_kind, count=len(devs),
            jax=jax.__version__)
    clock = _CompileClock()
    if args.cards == 1:
        sm.run("kernels", phase_kernels)
        sm.run("forward", phase_forward)
        sm.run("mcmc", phase_mcmc, clock)
    else:
        sm.run("cards", phase_cards, args.cards, clock)
    if sm.failed:
        print("chip_smoke FAILED: " + "; ".join(sm.failed), flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
