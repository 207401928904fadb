"""Adaptive-covariance Metropolis (AM) — the tuned-proposal capability.

The reference's random walk proposes every Brownian parameter
independently with a hand-tuned per-parameter step from the YAML
(``/root/reference/brownian.py:20-27``); correlated posteriors (the
B-spline Vs coefficients; crustal thickness vs sediment velocity) make
such axis-aligned steps mix slowly.  This sampler learns a full
proposal covariance Haario-style (Adaptive Metropolis, Haario et al.
2001) and then FREEZES it before recording, so the recorded phase is an
exactly valid symmetric-proposal Metropolis chain:

  * warmup phase 1 — diagonal proposals (the reference's own step
    scales) with Robbins-Monro adaptation of a global log-scale toward
    a target acceptance;
  * warmup phase 2 — same proposals; posterior samples pooled across
    all lanes into a Welford mean/covariance estimate (all lanes target
    the same posterior, so pooling multiplies the sample count);
  * warmup phase 3 — proposals from the Cholesky factor of
    ``cov + eps*diag(step^2)``, Robbins-Monro re-tuning of the global
    scale (the classic s_d = 2.38/sqrt(d) anchor is the starting
    point);
  * recording — the proposal is frozen; a proposal violating the
    bounds or the ``isgood`` prior is rejected by MH (alpha = 0),
    which targets exactly posterior x prior-indicator (the same
    convention as :mod:`pysurfinv_tpu.inversion.mala`).

Warmup rows are burn-in and are not recorded; wall time includes
them.  Rows follow
the reference npz convention (``[misfit, L, accept] + theta``), so
PostPoint / Model3D / the parity comparator consume AM chains
unchanged.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from pysurfinv_tpu.inversion.compiled import BrownianSpec, CompiledModel
from pysurfinv_tpu.inversion.mcmc import ChainConfig, make_segmented_sampler
from pysurfinv_tpu.ops.dispersion import SurfConfig, surf_forward_batch

# RNG fold base for this sampler's draw streams: far above the RWM
# init folds (2*chain_len, 2*chain_len + 1; mcmc.py) for any practical
# chain_len, so no key collision is possible (the advisor's round-4
# MALA finding).
_FOLD_BASE = 1 << 20

# tuned_rwm_point traced-program cache (see its body)
_TRWM_PROGRAMS: dict = {}


class AdaptConfig(NamedTuple):
    warmup1: int = 384        # diag proposals, scale adaptation
    warmup2: int = 512        # diag proposals, covariance accumulation
    warmup3: int = 384        # chol proposals, scale re-adaptation
    target_acc: float = 0.27  # RM target (d-dimensional RWM optimum
    #                           0.234, nudged up for the bounded prior)
    gamma: float = 0.08       # Robbins-Monro rate on log-scale
    eps: float = 0.05         # diagonal regularisation, in units of
    #                           diag(step^2) — keeps the proposal full
    #                           rank when warmup samples underspan
    chain_len: int = 1000
    misfit_fail: float = 88888.0


def make_adaptive_sampler(cm: CompiledModel, pcls, scfg: SurfConfig,
                          wave: str, acfg: AdaptConfig):
    """(init_fn, warmup_fn, run_fn) over batched lanes.

    ``warmup_fn(carry, lane_keys, spec_b, ctx_b) -> (carry, chol, scale)``
    runs the three warmup phases and returns the frozen proposal;
    ``run_fn(carry, lane_keys, spec_b, ctx_b, chol, scale) ->
    (carry, rows)`` records ``chain_len`` rows (row 0 evaluates the
    start model with accept forced — the reference reset-row
    convention).
    """
    misfit_from_c = pcls._misfit_from_c

    def isgood(theta, ctx):
        return cm.isgood(theta, ctx[0])

    def eval_batch(thetas, ctx_b, c_warm):
        psi_b, per_b, c_b, u_b, m_b = ctx_b
        h, vp, vs, rho, qsi, nlay = cm.build_profile_batch(thetas, psi_b)
        c, _, okk = surf_forward_batch(h, vp, vs, rho, qsi, per_b, nlay,
                                       wave=wave, cfg=scfg,
                                       c_warm=c_warm)
        cP = jnp.where(okk[:, :, 0], c[:, :, 0], 0.0)
        m, chi, L = jax.vmap(
            lambda cp, t, oc, u, mk:
            misfit_from_c(cp, t, oc, u, mk, valid=mk))(
                cP, per_b, c_b, u_b, m_b)
        return m, chi, L, cP

    ccfg = ChainConfig(chain_len=acfg.chain_len)
    rwm_init, _ = make_segmented_sampler(isgood,
                                         lambda th, cx, aux: None,
                                         ccfg,
                                         aux_init=lambda s, c: None)

    def init_fn(lane_keys, spec_b, ctx_b, theta_init_b, use_init_b):
        theta, *_ = rwm_init(lane_keys, spec_b, ctx_b, theta_init_b,
                             use_init_b)
        N, P = theta.shape[0], ctx_b[1].shape[1]
        z = jnp.zeros((N,), theta.dtype)
        m, chi, L, cP = eval_batch(theta, ctx_b,
                                   jnp.zeros((N, P), theta.dtype))
        return (theta, m, chi, L, cP)

    def _one_step(carry, lane_keys, spec_b, ctx_b, fold, draw,
                  force=None):
        """Shared MH step: ``draw(kz, theta) -> prop``; returns
        (new_carry, accept, row_parts).  ``force``: traced bool —
        accept unconditionally (the row-0 evaluate-the-start
        convention; the proposal must equal theta0 there)."""
        theta0, m0, chi0, L0, cw = carry
        kz = jax.vmap(lambda lk: jax.random.fold_in(lk, fold))(lane_keys)
        prop = draw(kz, theta0)
        in_b = jnp.all((prop >= spec_b.vmin) & (prop <= spec_b.vmax),
                       axis=-1)
        okp = in_b & jax.vmap(isgood, in_axes=(0, 0))(prop, ctx_b)
        # prior/bounds-rejected proposals are rejected regardless of
        # their likelihood — evaluate the forward at the CURRENT state
        # there instead: the row's misfit is discarded by the
        # true-chain reconstruction, and out-of-bounds parameter
        # vectors would otherwise build unphysical models that knock
        # the solver off its warm-start window (a measured 44x step
        # cost in the round-5 full-covariance ladder)
        prop_s = jnp.where(okp[:, None], prop, theta0)
        m1, chi1, L1, cP1 = eval_batch(prop_s, ctx_b, cw)
        u = jax.vmap(lambda lk: jax.random.uniform(
            jax.random.fold_in(lk, fold + 1),
            dtype=theta0.dtype))(lane_keys)
        accept = ((chi1 < chi0)
                  | (u > 1.0 - jnp.exp(-(chi1 - chi0) / 2.0)))
        accept = accept & okp & (m1 < acfg.misfit_fail)
        if force is not None:
            accept = force | accept
        acc = accept[:, None]
        new = (jnp.where(acc, prop, theta0),
               jnp.where(accept, m1, m0),
               jnp.where(accept, chi1, chi0),
               jnp.where(accept, L1, L0),
               cP1)
        return new, accept, (m1, L1, prop)

    def warmup_fn(carry, lane_keys, spec_b, ctx_b):
        N, k = spec_b.theta0.shape
        dtype = spec_b.theta0.dtype
        sd = spec_b.step                      # (N, k) reference scales

        def diag_draw(kz, theta):
            z = jax.vmap(lambda kk, s: jax.random.normal(
                kk, s.shape, s.dtype))(kz, sd)
            return theta + z * sd

        # phase 1: RM scale on diagonal proposals ----------------------
        def p1(state, r):
            carry, log_s = state
            s = jnp.exp(log_s)
            carry, accept, _ = _one_step(
                carry, lane_keys, spec_b, ctx_b, _FOLD_BASE + 2 * r,
                lambda kz, th: th + s * (diag_draw(kz, th) - th))
            log_s = log_s + acfg.gamma * (jnp.mean(accept)
                                          - acfg.target_acc)
            return (carry, log_s), None

        (carry, log_s), _ = lax.scan(
            p1, (carry, jnp.zeros((), dtype)),
            jnp.arange(acfg.warmup1))

        # phase 2: accumulate pooled Welford mean/cov ------------------
        f2 = _FOLD_BASE + 2 * acfg.warmup1

        def p2(state, r):
            carry, log_s, cnt, mean, M2 = state
            s = jnp.exp(log_s)
            carry, accept, _ = _one_step(
                carry, lane_keys, spec_b, ctx_b, f2 + 2 * r,
                lambda kz, th: th + s * (diag_draw(kz, th) - th))
            log_s = log_s + acfg.gamma * (jnp.mean(accept)
                                          - acfg.target_acc)
            th = carry[0]
            cnt2 = cnt + N
            delta = th - mean[None, :]
            mean2 = mean + jnp.sum(delta, 0) / cnt2
            M2b = M2 + delta.T @ (th - mean2[None, :])
            return (carry, log_s, cnt2, mean2, M2b), None

        st0 = (carry, log_s, jnp.zeros((), dtype), jnp.zeros((k,), dtype),
               jnp.zeros((k, k), dtype))
        (carry, log_s, cnt, mean, M2), _ = lax.scan(
            p2, st0, jnp.arange(acfg.warmup2))
        cov = M2 / jnp.maximum(cnt - 1.0, 1.0)
        # regularise toward the reference's diagonal scales and anchor
        # the global scale at the d-dimensional optimum 2.38/sqrt(d)
        sd0 = sd[0]
        cov = cov + acfg.eps * jnp.diag(sd0 * sd0)
        chol = jnp.linalg.cholesky(cov)
        s_d = 2.38 / jnp.sqrt(jnp.asarray(float(k), dtype))

        def chol_draw(scale):
            def draw(kz, theta):
                z = jax.vmap(lambda kk: jax.random.normal(
                    kk, (k,), dtype))(kz)
                return theta + scale * (z @ chol.T)
            return draw

        # phase 3: RM re-tune of the global scale on the chol proposal -
        f3 = f2 + 2 * acfg.warmup2

        def p3(state, r):
            carry, log_s3 = state
            carry, accept, _ = _one_step(
                carry, lane_keys, spec_b, ctx_b, f3 + 2 * r,
                chol_draw(jnp.exp(log_s3)))
            log_s3 = log_s3 + acfg.gamma * (jnp.mean(accept)
                                            - acfg.target_acc)
            return (carry, log_s3), None

        (carry, log_s3), _ = lax.scan(
            p3, (carry, jnp.log(s_d)), jnp.arange(acfg.warmup3))
        return carry, chol, jnp.exp(log_s3)

    def run_fn(carry, lane_keys, spec_b, ctx_b, chol, scale):
        N, k = spec_b.theta0.shape
        dtype = spec_b.theta0.dtype
        f4 = _FOLD_BASE + 2 * (acfg.warmup1 + acfg.warmup2
                               + acfg.warmup3)

        def draw(kz, theta):
            z = jax.vmap(lambda kk: jax.random.normal(
                kk, (k,), dtype))(kz)
            return theta + scale * (z @ chol.T)

        def step(carry, r):
            at_init = r == 0
            new, accept, (m1, L1, prop) = _one_step(
                carry, lane_keys, spec_b, ctx_b, f4 + 2 * r,
                lambda kz, th: jnp.where(at_init, th, draw(kz, th)),
                force=at_init)
            row = jnp.concatenate(
                [jnp.stack([m1, L1, accept.astype(dtype)], axis=1),
                 prop], axis=1)
            return new, row

        carry, rows = lax.scan(step, carry, jnp.arange(acfg.chain_len))
        return carry, rows

    return init_fn, warmup_fn, run_fn


def tuned_rwm_point(point, outdir="MCtest_trwm", pid=None, runN=6000,
                    chainL=1000, seed=42, wave="rayleigh",
                    scfg: SurfConfig | None = None,
                    target_acc: float = 0.15, std_steps: int = 128,
                    rm_rounds: int = 4, rm_steps: int = 32,
                    gamma: float = 0.6, warm_lanes: int = 48,
                    verbose=False):
    # rm_rounds/gamma are retained for call compatibility with the
    # earlier sequential Robbins-Monro tuner; the shipped tuner is the
    # single parallel ladder segment (2*rm_steps long) below.
    """Auto-tuned random walk: the EXISTING RWM sampler with adapted
    per-component step sizes.

    The reference carries hand-tuned per-parameter steps in the YAML
    (``brownian.py:7``); on the Cascadia fixture they yield ~15%
    acceptance and a min-over-components ESS limited by the
    worst-scaled parameter.  This driver adapts them in two phases and
    then FREEZES them, so the recorded chains are the unmodified
    reference sampler algorithm (truncated-normal proposals,
    retry-until-prior, reference Metropolis rule) at different step
    values — the sampler targets the same posterior for any step
    sizes, so all parity machinery applies unchanged:

      1. scale shape: run ``std_steps`` warmup steps with the
         reference steps, set ``step_i = lambda * std_i`` from the
         pooled true-chain posterior stds (the diagonal-AM recipe —
         proposal scale proportional to posterior scale equalises
         per-component mixing, which directly lifts the
         min-over-components ESS);
      2. global scale: one parallel ladder segment picks ``lambda``
         by interpolating the measured acceptance curve at
         ``target_acc``.  The default 0.15 (recorded acceptance lands
         ~0.11) measured the best ESS/s on the fixture — BELOW the
         textbook Gaussian-target optimum 0.234, because larger steps
         hop between posterior modes.

    Warmup cost is SEQUENTIAL steps (lanes are nearly free), so
    both phases run on ``warm_lanes`` parallel lanes regardless of
    ``runN`` — 48 lanes x 128 steps pool ~3k posterior samples for
    the stds and average the acceptance estimate over 1.5k proposals
    per RM round, at the wall cost of only ~256 sequential steps
    (~26% of a chainL=1000 recorded phase).

    Unlike the full-covariance AM above, the per-step cost is
    IDENTICAL to the production sampler (same programs, same
    warm-started forward), so the entire ESS/step gain lands in
    ESS/s.  Writes the reference-format npz; wall time includes all
    warmup.
    """
    import time

    from pysurfinv_tpu.parallel.grid import mcmc_solver_cfg
    from pysurfinv_tpu.utils import host_eager

    t0 = time.time()
    scfg = scfg or mcmc_solver_cfg()
    with host_eager():
        cm = CompiledModel(point.initMod)
        spec1 = cm.spec_of(point.initMod)
        psi1 = cm.psi_of(point.initMod)
    n_chains = max(runN // chainL, 1)
    n_warm = max(n_chains, warm_lanes)
    T, c_obs, unc, m_obs = point._obs_arrays()

    def make_batch(n):
        rp = lambda x: jnp.repeat(jnp.asarray(x)[None], n, 0)  # noqa
        return (BrownianSpec(*[rp(f) for f in spec1]),
                (rp(psi1), rp(T), rp(c_obs), rp(unc), rp(m_obs)))

    spec, ctx = make_batch(n_chains)
    spec_w, ctx_w = make_batch(n_warm)
    misfit_from_c = type(point)._misfit_from_c

    def isgood(theta, ctx1):
        return cm.isgood(theta, ctx1[0])

    def chi_b(thetas, ctx_b, c_warm):
        psi_b, per_b, c_b, u_b, mk_b = ctx_b
        h, vp, vs, rho, qsi, nlay = cm.build_profile_batch(thetas, psi_b)
        c, _, okk = surf_forward_batch(h, vp, vs, rho, qsi, per_b, nlay,
                                       wave=wave, cfg=scfg,
                                       c_warm=c_warm)
        cP = jnp.where(okk[:, :, 0], c[:, :, 0], 0.0)
        m, chi, L = jax.vmap(
            lambda cp, t, oc, u, mk:
            misfit_from_c(cp, t, oc, u, mk, valid=mk))(
                cP, per_b, c_b, u_b, mk_b)
        return m, chi, L, cP

    cfg = ChainConfig(chain_len=chainL)
    # traced-program cache across calls (host tracing of the segment
    # program costs ~20 s on a 1-CPU host — without this, every
    # tuned_rwm_point call re-traces and the warmup looks 40x more
    # expensive than it is; same pattern as parallel.grid's
    # _batched_programs)
    from pysurfinv_tpu.parallel.grid import _structure_key
    pkey = (_structure_key(cm), type(point).__qualname__, scfg, wave,
            chainL, n_chains, bool(jax.config.jax_enable_x64))
    progs = _TRWM_PROGRAMS.get(pkey)
    if progs is None:
        init_fn, seg_fn = make_segmented_sampler(
            isgood, chi_b, cfg,
            aux_init=lambda spec_b, ctx_b: jnp.zeros_like(ctx_b[1]))
        progs = {"init": jax.jit(init_fn), "seg_fn": seg_fn, "seg": {}}
        _TRWM_PROGRAMS[pkey] = progs
        while len(_TRWM_PROGRAMS) > 8:
            _TRWM_PROGRAMS.pop(next(iter(_TRWM_PROGRAMS)))
    init_j = progs["init"]
    seg_fn = progs["seg_fn"]
    seg_j = progs["seg"]

    def run_seg(carry, keys, sp, cx, s0, n):
        if n not in seg_j:
            seg_j[n] = jax.jit(
                lambda c, k, spb, cx_, s0_, n=n: seg_fn(c, k, spb, cx_,
                                                        s0_, n))
        return seg_j[n](carry, keys, sp, cx,
                        jnp.asarray(s0, jnp.int32))

    key0 = jax.random.PRNGKey(seed)
    k_warm = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.fold_in(key0, 777), i))(jnp.arange(n_warm))
    use_init_w = jnp.arange(n_warm) == 0

    # ---- phase 1: posterior stds with the reference steps ------------
    carry = init_j(k_warm, spec_w, ctx_w, spec_w.theta0, use_init_w)
    carry, rows = run_seg(carry, k_warm, spec_w, ctx_w, 0, std_steps)
    rows = np.asarray(rows)                    # (std_steps, N, 3+k)
    k = spec.theta0.shape[1]
    # true-chain states: rejected rows inherit the previous state
    th = rows[:, :, 3:].copy()
    acc = rows[:, :, 2] > 0.5
    for r in range(1, th.shape[0]):
        stay = ~acc[r]
        th[r][stay] = th[r - 1][stay]
    # drop the first half as burn-in, pool lanes
    samp = th[std_steps // 2:].reshape(-1, k)
    stds = np.maximum(samp.std(axis=0), 1e-8)
    # never exceed the half-range cap the reference enforces
    # (brownian.py:7)
    half = 0.5 * (np.asarray(spec1.vmax) - np.asarray(spec1.vmin))

    # ---- phase 2: parallel global-scale ladder ----------------------
    # the proposal scale is per-LANE data, so a whole ladder of
    # candidate global multipliers runs in ONE segment: lanes split
    # into groups, each proposing at lambda_g * stds.  The probe runs
    # through the SAME symmetric plain-Gaussian +
    # bounds/prior-rejection kernel that the recorded phase uses (the
    # make_adaptive_sampler step) — the reference's truncated+retry
    # kernel reads systematically HIGHER acceptance at the same scale
    # (its in-bounds retries never waste a proposal on the bounds), so
    # probing with it mis-calibrates the pick (measured: target 0.234
    # -> recorded 0.06).
    dt = np.asarray(spec1.step).dtype
    lam0 = float(np.median(np.asarray(spec1.step) / stds))
    cand = lam0 * np.power(2.0, np.arange(-1.0, 5.0))     # 6 octaves
    n_grp = len(cand)
    lam_lane = np.asarray(cand)[np.arange(n_warm) % n_grp]

    rec = _TRWM_PROGRAMS.get((pkey, "rec"))
    if rec is None:
        ai, aw, ar = make_adaptive_sampler(
            cm, type(point), scfg, wave, AdaptConfig(chain_len=chainL))
        _, _, ar_p = make_adaptive_sampler(
            cm, type(point), scfg, wave,
            AdaptConfig(chain_len=2 * rm_steps))
        rec = {"init": jax.jit(ai), "run": jax.jit(ar),
               "probe": jax.jit(ar_p)}
        _TRWM_PROGRAMS[(pkey, "rec")] = rec

    chol_w = jnp.asarray(np.diag(stds.astype(dt)))
    scale_lane = jnp.asarray(lam_lane.astype(dt))[:, None]
    # phase-1 carry layout (theta, m, chi, L, aux-cP) is exactly the
    # adaptive carry (theta, m, chi, L, c_warm)
    carry, rows = rec["probe"](carry, k_warm, spec_w, ctx_w, chol_w,
                               scale_lane)
    rows = np.asarray(rows)
    rows = rows[1:]                 # drop the forced-accept init row
    acc_r = rows[:, :, 2] > 0.5                 # (steps, N)
    th_r = rows[:, :, 3:].copy()
    for r in range(1, th_r.shape[0]):
        stay = ~acc_r[r]
        th_r[r][stay] = th_r[r - 1][stay]
    jumps = ((np.diff(th_r, axis=0) / stds[None, None, :]) ** 2
             ).sum(axis=2)                      # (steps-1, N)
    esjd = np.array([jumps[:, np.arange(n_warm) % n_grp == g].mean()
                     for g in range(n_grp)])
    accs = np.array([acc_r[:, np.arange(n_warm) % n_grp == g].mean()
                     for g in range(n_grp)])
    # pick lambda by log-interpolating the measured (monotone-
    # decreasing) acceptance curve at target_acc.  Raw ESJD is logged
    # but NOT used as the objective: on this multi-modal bounded
    # posterior it rises monotonically with lambda (rare huge accepted
    # teleports dominate the mean square jump) and drives the pick to
    # a degenerate ~2% acceptance (measured round 5); the acceptance
    # band around 0.23-0.36 is where the measured chain ESS actually
    # peaks.
    ll = np.log(cand)
    if accs[0] <= target_acc:
        lam = float(cand[0])
    elif accs[-1] >= target_acc:
        lam = float(cand[-1])
    else:
        lam = float(np.exp(np.interp(-target_acc, -accs, ll)))
    step_fin = np.minimum(lam * stds, half).astype(dt)
    rep_c = lambda x: jnp.repeat(jnp.asarray(x)[None], n_chains, 0)  # noqa
    spec_t = spec._replace(step=rep_c(step_fin))

    # ---- phase 3: record runN rows with the frozen tuned steps -------
    # The recorded phase runs SYMMETRIC plain-Gaussian proposals with
    # bounds/prior rejection (the make_adaptive_sampler step with a
    # diagonal Cholesky), NOT the reference's truncated-normal +
    # retry-until-in-bounds kernel: the reference applies no
    # Metropolis-Hastings correction for the truncation asymmetry,
    # which is negligible at its small hand-tuned steps but grows with
    # step size — recording tuned (larger) steps through the truncated
    # kernel measurably SHIFTS the stationary distribution
    # (round-5 comparator: theta-std z = 28 vs the device RWM
    # posterior; pooled theta1 std 0.26 vs 0.066).  The symmetric
    # kernel targets posterior x prior-indicator exactly at ANY step
    # size, so the tuned chains stay parity-comparable.
    lane_keys = jax.vmap(lambda i: jax.random.fold_in(key0, i))(
        jnp.arange(n_chains))
    use_init = jnp.arange(n_chains) == 0
    chol_d = jnp.asarray(np.diag(step_fin))
    carry = rec["init"](lane_keys, spec_t, ctx, spec_t.theta0, use_init)
    carry, rows = rec["run"](carry, lane_keys, spec_t, ctx, chol_d,
                             jnp.asarray(1.0, dtype=spec_t.theta0.dtype))
    rows = np.asarray(rows)
    track = np.moveaxis(rows, 0, 1).reshape(-1, rows.shape[-1])
    pid = pid or point.pid
    point._save_npz(outdir, pid, track, chainL)
    if verbose:
        lad = ", ".join(f"{c:.2f}:a{a:.2f}/j{e:.2f}"
                        for c, a, e in zip(cand, accs, esjd))
        print(f"tuned_rwm_point: {n_chains} x {chainL} "
              f"(+{std_steps + 2 * rm_steps} warmup @ {n_warm} lanes) "
              f"in {time.time() - t0:.1f}s, acceptance "
              f"{track[:, 2].mean():.3f}, lambda {lam:.3f} "
              f"[ladder {lad}]")
    return os.path.join(outdir, f"{pid}.npz")


def adaptive_point(point, outdir="MCtest_am", pid=None, runN=6000,
                   chainL=1000, seed=42, wave="rayleigh",
                   acfg: AdaptConfig | None = None,
                   scfg: SurfConfig | None = None, verbose=False,
                   init_all=False):
    """Run AM chains for one Point; write the reference-format npz.

    Lanes = runN//chainL independent chain segments (chain 0 starts
    from ``initMod``, the rest from prior-accepted uniform draws) —
    the ``Point.MCinvMP`` layout, so outputs feed PostPoint / Model3D /
    the parity comparator unchanged.
    """
    import time

    from pysurfinv_tpu.parallel.grid import mcmc_solver_cfg
    from pysurfinv_tpu.utils import host_eager

    t0 = time.time()
    scfg = scfg or mcmc_solver_cfg()
    acfg = acfg or AdaptConfig(chain_len=chainL)
    if acfg.chain_len != chainL:
        acfg = acfg._replace(chain_len=chainL)
    with host_eager():
        cm = CompiledModel(point.initMod)
        spec1 = cm.spec_of(point.initMod)
        psi1 = cm.psi_of(point.initMod)
    n_chains = max(runN // chainL, 1)
    spec = BrownianSpec(*[jnp.repeat(jnp.asarray(f)[None], n_chains, 0)
                          for f in spec1])
    T, c_obs, unc, m_obs = point._obs_arrays()
    rep = lambda x: jnp.repeat(jnp.asarray(x)[None], n_chains, 0)  # noqa
    ctx = (rep(psi1), rep(T), rep(c_obs), rep(unc), rep(m_obs))

    init_fn, warmup_fn, run_fn = make_adaptive_sampler(
        cm, type(point), scfg, wave, acfg)
    key0 = jax.random.PRNGKey(seed)
    lane_keys = jax.vmap(lambda i: jax.random.fold_in(key0, i))(
        jnp.arange(n_chains))
    use_init = (jnp.ones(n_chains, bool) if init_all
                else jnp.arange(n_chains) == 0)

    carry = jax.jit(init_fn)(lane_keys, spec, ctx, spec.theta0, use_init)
    carry, chol, scale = jax.jit(warmup_fn)(carry, lane_keys, spec, ctx)
    carry, rows = jax.jit(run_fn)(carry, lane_keys, spec, ctx, chol,
                                  scale)
    rows = np.asarray(rows)                       # (chainL, N, 3+k)
    track = np.moveaxis(rows, 0, 1).reshape(-1, rows.shape[-1])
    pid = pid or point.pid
    point._save_npz(outdir, pid, track, chainL)
    if verbose:
        acc = track[:, 2].mean()
        print(f"adaptive_point: {n_chains} x {chainL} steps "
              f"(+{acfg.warmup1 + acfg.warmup2 + acfg.warmup3} warmup) "
              f"in {time.time() - t0:.1f}s, acceptance {acc:.3f}, "
              f"scale {float(scale):.3f}")
    return os.path.join(outdir, f"{pid}.npz")
