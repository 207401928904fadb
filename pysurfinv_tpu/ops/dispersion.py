"""Batched surface-wave dispersion curves with uniform control flow.

Replaces the reference's sequential bracket + Neville refinement
(``/root/reference/fast_surf_src/calcul.f:104-223``,
``surfa.f:2-83``) with a batch-friendly three-phase scheme:

  1. **Bracket (sequential over periods, wide over the c-grid):** per
     period, evaluate the secular function on a coarse c-grid *in
     parallel* and take the first sign change — preserving the
     reference's guarantee of landing on the fundamental (lowest)
     root.  The cold first period narrows its hit cell to ``dc``; warm
     periods hand the ``coarse*dc`` cell straight to the refinement.
     Each period warm-starts just below the previous period's bracket;
     each overtone starts just above the previous mode's root
     (calcul.f:138-151).
  2. **Refine (parallel over all (period, mode) lanes):** a single
     fixed-iteration Illinois (regula-falsi) loop refines every bracket
     at once.  The halfspace truncation is frozen at each bracket's
     upper end, matching how NEVILL inherits ``mmax`` from the last
     bracketing evaluation (calcul.f:156-172).  This is the key perf
     move vs a per-period refinement: the refinement's sequential depth
     drops by a factor of P (periods no longer serialize the many
     small secular evaluations).
  3. **Group velocity (parallel):** implicit differentiation of the
     secular function at the root, u = c / (1 - (T/c) * F_T / F_c),
     with the attenuated+flattened model held fixed — the exact
     continuum limit of the reference's eigenfunction energy integrals
     (surfa.f LEIGEN / REIGEN), evaluated by forward-mode tangents
     (in-kernel on the fast path, ``jax.jvp`` on the XLA path) for all
     lanes at once; the same tangents Newton-polish the root for free.

Everything is shape-static and branch-free, so ``jax.vmap`` over models
turns the whole solve into wide VPU lanes.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from pysurfinv_tpu.ops.flatten import (H_MIN, FlatFactors,
                                       flatten_factors, model_preamble)
from pysurfinv_tpu.ops.secular import (
    attenuation_rescale,
    effective_halfspace,
    love_secular,
    rayleigh_secular,
)

# H_MIN (thin-layer threshold, models.py:20) is re-exported from
# ops.flatten, the home of the shared model preamble.


class SurfConfig(NamedTuple):
    """Static solver configuration (defaults mirror fast_surf/init.f:25)."""

    dc: float = 0.01          # bracket step (final bracket is one dc cell)
    nscan_first: int = 512    # c-grid coverage (in dc), first period
    nscan: int = 64           # c-grid coverage (in dc), warm-started periods
    nbisect: int = 12         # Illinois refinement iterations. From a dc-wide
    #                           bracket, Illinois' supra-linear convergence
    #                           reaches well past the reference NEVILL
    #                           tolerance of 1e-6 (surfa.f:10) in ~10 steps.
    nnewton: int = 0          # >0 routes refinement through the fused
    #                           refine_lanes kernel: nbisect Illinois +
    #                           nnewton bracket-clamped Newton iterations
    #                           (the last evaluation-only, yielding group
    #                           velocity from its tangents).  Default 0 =
    #                           separate Illinois launches + one tangent
    #                           launch; the GPU A/B is ROADMAP §3.  XLA
    #                           path ignores this.
    coarse: int = 2           # warm-period sweep step, in dc.  The hit cell
    #                           is handed to the refinement at coarse*dc
    #                           width (Illinois absorbs it in ~1 extra
    #                           iteration), so the only failure class is a
    #                           *pair* of roots inside one coarse cell (no
    #                           net sign change) — possible only when the
    #                           NEXT mode lies within coarse*dc of the
    #                           target, tighter than typical mode
    #                           separation; the reference's own dc stepping
    #                           has the same failure class at 0.01 km/s.
    #                           Overtone sweeps always run at dc.
    coarse_first: int = 4     # cold-period (first-period) sweep step, in dc;
    #                           the cold sweep spans up to 5 km/s (water top
    #                           starts at c = 0.5), so it pays to be coarser;
    #                           the fundamental is well separated from mode 1
    #                           at short periods.
    warm_backoff: int = 10    # warm start = previous bracket lo minus this
    #                           many dc — guards mildly non-monotonic c(T)
    #                           (the reference seeds *at* the previous root
    #                           and assumes monotone-up, calcul.f:190-200)
    fact: float = 4.0         # halfspace truncation, wavelengths
    t_base: float = 1.0       # physical-dispersion reference period
    atten: bool = True        # KEY_ATTEN (init.f:43)
    flat: bool = True         # KEY_FLAT  (init.f:45)
    nmodes: int = 1           # fundamental only by default
    compute_group: bool = True  # group velocity via implicit diff
    backend: str = "auto"     # "auto" | "xla" | "xla_assoc" | "pallas"
    #                           | "pallas_interpret".  "auto" picks the
    #                           compiled Triton kernels on a GPU and the
    #                           vmapped XLA oracle elsewhere, never the
    #                           interpreter; "pallas" off a GPU raises.
    #                           Only the batched entry point dispatches
    #                           (single-model surf_forward is always XLA).
    fuse_illinois: bool = False  # route the nbisect Illinois iterations
    #                           through ONE refine_lanes launch (plain
    #                           secular body only, no Newton tail) instead
    #                           of nbisect separate frozen launches.
    #                           Meant for runs where per-launch overhead
    #                           dominates the refine phase (small lane
    #                           counts: the MCMC sampler at O(1k) lanes);
    #                           its GPU A/B is ROADMAP §3.  Group velocity
    #                           still comes from the separate tangent
    #                           launch.  Kernel batched path only.
    fhandoff: bool = False    # seed the refinement with the bracket
    #                           sweep's endpoint secular values, skipping
    #                           the two Illinois init launches (and
    #                           newton_sep's sign-probe launch).  Default
    #                           OFF (its GPU A/B is ROADMAP §3).  Opt-in
    #                           candidate for small-lane launch-bound
    #                           runs (the MCMC grid sampler).  Gates ONLY the
    #                           phase-2 refinement handoff: the between-
    #                           mode root estimate (nmodes>1) always
    #                           seeds its secant from the sweep endpoint
    #                           values regardless of this flag (covered
    #                           by the 6-mode overtone parity test).
    #                           With OFF, the phase-2 program is the
    #                           identical pre-handoff program (the unused
    #                           gather chain is XLA dead code).  Kernel
    #                           batched path only.
    wseed_nscan: int = 0      # fused c_warm sweep window span (in dc);
    #                           0 = use ``nscan``.  Lets a caller with a
    #                           tightly-predicted seed (the cross-wave
    #                           continuation of ``surf_forward_joint``)
    #                           run a narrower warm window than the cold
    #                           fallback chain's ``nscan`` without
    #                           touching the fallback itself.
    wseed_backoff: int = -1   # fused c_warm sweep backoff (in dc);
    #                           -1 = use ``warm_backoff``.  Same purpose
    #                           as ``wseed_nscan``.
    wseed_coarse: int = 0     # fused c_warm sweep probe step (in dc);
    #                           0 = use ``coarse``.  A coarse probe
    #                           step is BLIND to narrow spurious
    #                           sign-flip pairs (truncation-boundary
    #                           artifacts flip and flip back inside one
    #                           cell), which is why the MCMC warm
    #                           window at coarse=8 never catches them
    #                           while a dc-fine seeded sweep can: a
    #                           joint seed window at coarse=2 spanning
    #                           [-6,+6]dc was seen to land >1% of lanes
    #                           ~6.5dc below the true root.
    newton_sep: int = 0       # >0 replaces the refinement on the kernel
    #                           batched path with this many SEPARATED
    #                           safeguarded-Newton iterations: each
    #                           iteration is ONE gradient-kernel launch
    #                           (F, F_c, F_T: ~2.7x a plain row on an
    #                           H100) whose
    #                           Newton step is clamped to the live
    #                           bracket (midpoint fallback), with the
    #                           bracket side updated from sign(F) like
    #                           Illinois.  Quadratic convergence from
    #                           the dc/2dc bracket reaches the f32 noise
    #                           floor in 3 iterations where Illinois
    #                           needs ~9-11 plain launches — and the
    #                           last iteration's tangents yield the
    #                           group velocity for free, so the whole
    #                           refine+group phase is n_newt grad
    #                           launches.  Unlike `nnewton` (the FUSED
    #                           refine kernel), each launch here is the
    #                           plain secular_lanes_grad.
    #                           nbisect is ignored when set.  The XLA
    #                           path ignores it (it is the oracle path).


def _secular_fn(wave: str, assoc: bool = False):
    if assoc:
        from pysurfinv_tpu.ops.secular_assoc import (love_secular_assoc,
                                                     rayleigh_secular_assoc)
        if wave in ("rayleigh", "ray", "R"):
            return lambda c, t, mdl, mm: rayleigh_secular_assoc(
                c, t, *mdl, mm)
        if wave in ("love", "lov", "L"):
            return lambda c, t, mdl, mm: love_secular_assoc(
                c, t, mdl[1], mdl[2], mdl[3], mm)
    if wave in ("rayleigh", "ray", "R"):
        return lambda c, t, mdl, mm: rayleigh_secular(c, t, *mdl, mm)
    if wave in ("love", "lov", "L"):
        return lambda c, t, mdl, mm: love_secular(c, t, mdl[1], mdl[2], mdl[3], mm)
    raise ValueError(f"unknown wave type: {wave}")


def _sign(x):
    return jnp.where(x >= 0, 1.0, -1.0)


def _model_at_period(t, vp, vs, rho, qsinv, fac, cfg: SurfConfig):
    """Attenuated + flattened model arrays for one period (calcul.f:112-133)."""
    if cfg.atten:
        a_t, b_t = attenuation_rescale(vp, vs, qsinv, t, cfg.t_base)
    else:
        a_t, b_t = vp, vs
    return (a_t * fac.vel_fac, b_t * fac.vel_fac,
            rho * fac.rho_fac, fac.h_flat)


def _first_flip(F, cs, t, mdl, nlay, cfg):
    """Evaluate F on a c-grid; return the first sign-change interval."""
    b, d = mdl[1], mdl[3]

    def eval_at(cv):
        mm = effective_halfspace(cv, t, b, d, nlay, cfg.fact)
        return F(cv, t, mdl, mm), mm

    fs, mms = jax.vmap(eval_at)(cs)
    sgn = _sign(fs)
    # search window: stop at c >= b(mmax) + 0.3 (calcul.f:165-167)
    b_hs = b[mms - 1]
    within = cs < (b_hs + 0.3)
    cand = (sgn[:-1] != sgn[1:]) & within[1:]
    found = jnp.any(cand)
    i = jnp.argmax(cand)
    return i, found, mms


def _bracket(F, c_start, t, mdl, nlay, cfg: SurfConfig, nscan: int,
             coarse: int):
    """First sign change above ``c_start``, narrowed to a dc-wide cell.

    Sweeps a ``coarse * dc`` grid spanning ``nscan * dc``, then re-scans
    the hit cell at ``dc``.  Returns ``(c_lo, found, mm)`` where the
    root lies in ``[c_lo, c_lo + dc]`` and ``mm`` is the halfspace
    truncation frozen at the bracket's upper end (the NEVILL
    convention, calcul.f:156-172).
    """
    dc = cfg.dc
    dtype = c_start.dtype
    if coarse > 1:
        k = max(nscan // coarse, 1)
        cs = c_start + (coarse * dc) * jnp.arange(k + 1, dtype=dtype)
        ic, found_c, _ = _first_flip(F, cs, t, mdl, nlay, cfg)
        cs = cs[ic] + dc * jnp.arange(coarse + 1, dtype=dtype)
        i, found_f, mms = _first_flip(F, cs, t, mdl, nlay, cfg)
        found = found_c & found_f
    else:
        cs = c_start + dc * jnp.arange(nscan + 1, dtype=dtype)
        i, found, mms = _first_flip(F, cs, t, mdl, nlay, cfg)
    # reject brackets whose root would sit above the halfspace shear
    # velocity (calcul.f:191); c_lo <= b_hs keeps roots within one dc
    b_hs = mdl[1][mms[i + 1] - 1]
    found = found & (cs[i] <= b_hs)
    return cs[i], found, mms[i + 1]


def _illinois(F_eval, lo, hi, n_iter: int, f_lo=None, f_hi=None):
    """Fixed-iteration Illinois (regula falsi) on elementwise brackets.

    ``F_eval`` maps a c array (same shape as ``lo``) to secular values;
    all state updates are elementwise ``where`` masks, so this runs any
    number of lanes in lockstep — scalars in phase 1's mini-refine, the
    full (period, mode) lane set in phase 2.

    ``f_lo``/``f_hi``: optional pre-computed endpoint values — the
    bracket sweep already evaluated F at both bracket ends, so handing
    them over saves the two init launches (~20% of the refine phase on
    the fused-kernel path).  Sweep values carry the DYNAMIC halfspace
    truncation while refinement interior points use the FROZEN one;
    the endpoint values only steer the secant (signs drive the bracket
    bookkeeping), so a rare dynamic/frozen sign disagreement costs at
    most convergence-to-a-bracket-end — bounded by the bracket width
    and recovered by the free Newton polish (accuracy pinned vs a
    40-iteration oracle, tests/test_warm_roots.py and the bench
    ladders).
    """
    if f_lo is None:
        f_lo = F_eval(lo)
    if f_hi is None:
        f_hi = F_eval(hi)
    side0 = jnp.zeros(jnp.shape(lo), jnp.int32)

    def step(_, state):
        lo, hi, flo, fhi, side = state
        denom = fhi - flo
        denom = jnp.where(jnp.abs(denom) > 0, denom, 1.0)
        x = (lo * fhi - hi * flo) / denom
        bad = ~((x > lo) & (x < hi))
        x = jnp.where(bad, 0.5 * (lo + hi), x)
        fx = F_eval(x)
        same_lo = _sign(fx) == _sign(flo)
        nlo = jnp.where(same_lo, x, lo)
        nflo = jnp.where(same_lo, fx, flo)
        nhi = jnp.where(same_lo, hi, x)
        nfhi = jnp.where(same_lo, fhi, fx)
        # Illinois halving of the stale end when the same end repeats
        nfhi = jnp.where(same_lo & (side == -1), 0.5 * nfhi, nfhi)
        nflo = jnp.where(~same_lo & (side == 1), 0.5 * nflo, nflo)
        side = jnp.where(same_lo, jnp.int32(-1), jnp.int32(1))
        return nlo, nhi, nflo, nfhi, side

    lo, hi, flo, fhi, _ = lax.fori_loop(0, n_iter, step,
                                        (lo, hi, f_lo, f_hi, side0))
    denom = jnp.where(jnp.abs(fhi - flo) > 0, fhi - flo, 1.0)
    root = (lo * fhi - hi * flo) / denom
    return jnp.clip(root, lo, hi)


def _group_velocity(F, root, t, mdl, mm):
    """u = c / (1 - (T/c) F_T/F_c): implicit differentiation at the root.

    F_T is the partial period derivative at FIXED material properties
    (the attenuated+flattened ``mdl`` is built outside and held
    constant).  This matches the reference's convention exactly: its
    group velocity is the variational dw/dk from energy integrals of
    eigenfunctions computed for the model *at that period*
    (``senskernel-1.0/src/SURF_PERTURB/surfa.f:715`` ugr=I1/(c I0) for
    Love, ``:1331`` for Rayleigh) — no material-dispersion term.
    (Empirically, adding the d(model)/dT chain shifts u by ~1e-3
    relative and breaks TEST1 group parity.)
    """
    # forward-mode: two scalar tangents through the layer scan cost two
    # tangent-augmented forward passes and save no residuals, unlike
    # reverse mode which spills the whole recursion to memory
    _, f_c = jax.jvp(lambda cc: F(cc, t, mdl, mm), (root,),
                     (jnp.ones_like(root),))
    _, f_t = jax.jvp(lambda tt: F(root, tt, mdl, mm), (t,),
                     (jnp.ones_like(t),))
    f_c = jnp.where(jnp.abs(f_c) > 0, f_c, 1.0)
    return root / (1.0 - (t / root) * f_t / f_c)


def _first_active(h, vs, nlay):
    """Indices of the first/second non-thin layers (halfspace counts)."""
    L = h.shape[0]
    idx = jnp.arange(L)
    act = ((idx < nlay - 1) & (h > H_MIN)) | (idx == nlay - 1)
    first = jnp.argmax(act)
    second = jnp.argmax(act & (idx > first))
    return first, second


def _initial_c(h, vs, qsinv, nlay, t1, wave, cfg: SurfConfig):
    """Starting phase velocity for the first period (fast_surf.f:156-171)."""
    first, second = _first_active(h, vs, nlay)
    b1 = vs[first]
    water_top = b1 < 0.1
    ilay = jnp.where(water_top, second, first)
    qq = vs[ilay]
    if wave in ("rayleigh", "ray", "R"):
        qq = 0.9 * qq
    b_corr = (qsinv[ilay] * jnp.log(cfg.t_base / t1) / jnp.pi
              if cfg.atten else 0.0)
    c1 = qq * (1.0 + b_corr)
    return jnp.where(water_top, jnp.asarray(0.5, c1.dtype), c1)


def _mode_chain(ok):
    """Mode ordering: mode m is only valid if modes < m were found."""
    return ok & jnp.concatenate(
        [jnp.ones((1,), bool),
         jnp.cumprod(ok[:-1].astype(jnp.int32)).astype(bool)])


@partial(jax.jit, static_argnames=("wave", "cfg"))
def surf_forward(h, vp, vs, rho, qsinv, periods, nlay,
                 wave: str = "rayleigh", cfg: SurfConfig = SurfConfig()):
    """Dispersion curves for one padded layered model.

    Args:
      h, vp, vs, rho, qsinv: (L,) padded model; layer ``nlay-1`` is the
        halfspace, pads replicate it with h = 0.  ``qsinv`` is 1/Qs
        (the reference convention, models.py:22).
      periods: (P,) periods in seconds, ascending.
      nlay: scalar int, number of real layers including the halfspace.
      wave: 'rayleigh' or 'love'.
      cfg:  SurfConfig (static).

    Returns:
      c:     (P, nmodes) phase velocities (0 where not found),
      u:     (P, nmodes) group velocities (0 where not found),
      valid: (P, nmodes) bool.
    """
    dtype = h.dtype
    L = h.shape[0]
    idx = jnp.arange(L)
    kind = 1 if wave in ("love", "lov", "L") else 2
    h_eff, fac = model_preamble(h, nlay, kind, cfg.flat)

    F = _secular_fn(wave, assoc=(cfg.backend == "xla_assoc"))
    nmodes = cfg.nmodes
    P = periods.shape[0]
    dc = cfg.dc

    # ================= phase 1: bracket every (period, mode) ============
    def bracket_period(t, starts, nscan, coarse0):
        """dc-wide brackets for all modes at one period."""
        mdl = _model_at_period(t, vp, vs, rho, qsinv, fac, cfg)
        c_los, mms, founds = [], [], []
        root_est = None
        for iq in range(nmodes):
            start = starts[iq]
            if iq > 0:
                # overtones never start below the previous mode's root
                # (calcul.f:145-151, 199); coarse sweeps are reserved for
                # the fundamental — overtones can osculate (< coarse*dc
                # apart, e.g. TEST1 R/L mode 1 at T = 20 s).  The margin
                # above the estimate must clear the estimator's downside
                # error or the next mode's sweep re-brackets the SAME
                # root (measured: eus T=7 s R mode 4 duplicated mode 3,
                # shifting every later mode) — 12 Illinois iterations
                # put the estimate within ~1e-4 dc of the root, and the
                # 0.1 dc margin is far above that yet below any
                # dc-resolvable mode separation.
                start = jnp.maximum(start, root_est + 0.1 * dc)
            c_lo, found, mm = _bracket(F, start, t, mdl, nlay, cfg, nscan,
                                       coarse0 if iq == 0 else 1)
            if iq < nmodes - 1:
                # root estimate anchoring the next overtone's start
                root_est = _illinois(lambda c: F(c, t, mdl, mm),
                                     c_lo, c_lo + dc, 12)
            c_los.append(c_lo)
            mms.append(mm)
            founds.append(found)
        return jnp.stack(c_los), jnp.stack(mms), jnp.stack(founds)

    # ---- first period: cold start from the top-layer estimate ----------
    t1 = periods[0]
    c_init = _initial_c(h_eff, vs, qsinv, nlay, t1, wave, cfg)
    starts0 = jnp.full((nmodes,), c_init, dtype=dtype)
    lo0, mm0, ok0 = bracket_period(t1, starts0, cfg.nscan_first,
                                   cfg.coarse_first)
    if nmodes > 1:
        ok0 = _mode_chain(ok0)

    # ---- remaining periods: warm-started sweeps -------------------------
    def step(carry, t):
        c_start, alive = carry
        lok, mmk, okk = bracket_period(t, c_start, cfg.nscan, cfg.coarse)
        okk = okk & alive
        if nmodes > 1:
            okk = _mode_chain(okk)
        new_start = jnp.where(okk, lok - cfg.warm_backoff * dc, c_start)
        return (new_start, okk), (lok, mmk, okk)

    if P > 1:
        carry0 = (jnp.where(ok0, lo0 - cfg.warm_backoff * dc, starts0), ok0)
        _, (lor, mmr, okr) = lax.scan(step, carry0, periods[1:])
        c_lo = jnp.concatenate([lo0[None], lor], axis=0)   # (P, nmodes)
        mm = jnp.concatenate([mm0[None], mmr], axis=0)
        ok = jnp.concatenate([ok0[None], okr], axis=0)

        # ---- rescue pass: failed lanes re-bracketed from a cold start.
        # A sparse period list (e.g. T = [10, 30, 60]) can move the root
        # farther than the warm-start window (nscan*dc) reaches, failing
        # the period AND killing every later one through `alive` — where
        # the reference's bracketing walks dc steps indefinitely and
        # cannot miss (calcul.f:156-168).  Re-solve every failed
        # (period, mode) lane independently with the first-period
        # cold-start settings; found lanes keep their warm results
        # bit-for-bit, and the lax.cond skips the work entirely when
        # nothing failed (the dense-period MCMC hot path).
        def _rescue(carry):
            c_lo, mm, ok = carry

            def cold(t):
                ci = _initial_c(h_eff, vs, qsinv, nlay, t, wave, cfg)
                return bracket_period(t, jnp.full((nmodes,), ci, dtype),
                                      cfg.nscan_first, cfg.coarse_first)

            lo_c, mm_c, ok_c = jax.vmap(cold)(periods)
            if nmodes > 1:
                ok_c = jax.vmap(_mode_chain)(ok_c)
            use = ~ok & ok_c
            ok_new = ok | ok_c
            if nmodes > 1:
                ok_new = jax.vmap(_mode_chain)(ok_new)
            return (jnp.where(use, lo_c, c_lo), jnp.where(use, mm_c, mm),
                    ok_new)

        c_lo, mm, ok = lax.cond(jnp.all(ok), lambda x: x, _rescue,
                                (c_lo, mm, ok))
    else:
        c_lo, mm, ok = lo0[None], mm0[None], ok0[None]

    # ================= phase 2: refine all lanes in parallel ============
    t_l = jnp.repeat(periods, nmodes)                       # (P*nmodes,)
    lo_l = c_lo.reshape(-1)
    mm_l = mm.reshape(-1)
    ok_l = ok.reshape(-1)

    mdls = jax.vmap(
        lambda t: _model_at_period(t, vp, vs, rho, qsinv, fac, cfg))(t_l)
    F_lane = jax.vmap(lambda c, t, a, b, r, d, m: F(c, t, (a, b, r, d), m))

    def F_eval(c):
        return F_lane(c, t_l, *mdls, mm_l)

    root_l = _illinois(F_eval, lo_l, lo_l + dc, cfg.nbisect)
    # root must not exceed the halfspace shear velocity (calcul.f:191)
    b_hs_l = jnp.take_along_axis(mdls[1], (mm_l - 1)[:, None], axis=1)[:, 0]
    ok_l = ok_l & (root_l <= b_hs_l)

    # ================= phase 3: group velocity in parallel ==============
    if cfg.compute_group:
        u_l = jax.vmap(
            lambda c, t, a, b, r, d, m: _group_velocity(
                F, c, t, (a, b, r, d), m))(root_l, t_l, *mdls, mm_l)
    else:
        u_l = jnp.zeros_like(root_l)

    c_out = jnp.where(ok_l, root_l, 0.0).reshape(P, nmodes)
    u_out = jnp.where(ok_l, u_l, 0.0).reshape(P, nmodes)
    return c_out, u_out, ok_l.reshape(P, nmodes)


@partial(jax.jit, static_argnames=("cfg",))
def surf_ellipticity(h, vp, vs, rho, qsinv, periods, nlay,
                     cfg: SurfConfig = SurfConfig()):
    """Rayleigh surface H/V ellipticity curves (DLTAR4 mup=2 capability).

    Solves the dispersion roots, then evaluates the ellipticity ratio at
    each root (``surfa.f:360-364``).  Returns (ell, c, valid) with shape
    (P, nmodes) each.
    """
    from pysurfinv_tpu.ops.secular import rayleigh_ellipticity

    c_all, _, ok_all = surf_forward(h, vp, vs, rho, qsinv, periods, nlay,
                                    wave="rayleigh",
                                    cfg=cfg._replace(compute_group=False))
    L = h.shape[0]
    idx = jnp.arange(L)
    h_eff, fac = model_preamble(h, nlay, 2, cfg.flat)

    nmodes = cfg.nmodes
    t_l = jnp.repeat(periods, nmodes)
    c_l = c_all.reshape(-1)
    ok_l = ok_all.reshape(-1)

    def one(t, c0, ok):
        mdl = _model_at_period(t, vp, vs, rho, qsinv, fac, cfg)
        mm = effective_halfspace(c0, t, mdl[1], mdl[3], nlay, cfg.fact)
        c_safe = jnp.where(ok, c0, mdl[1][0] + 0.5)
        return rayleigh_ellipticity(c_safe, t, *mdl, mm)

    ell = jax.vmap(one)(t_l, c_l, ok_l)
    ell = jnp.where(ok_l, ell, 0.0).reshape(c_all.shape)
    return ell, c_all, ok_all


@partial(jax.jit, static_argnames=("cfg",))
def surf_amplitude(h, vp, vs, rho, qsinv, periods, nlay,
                   cfg: SurfConfig = SurfConfig()):
    """Rayleigh amplitude-response curves (DLTAR4 mup=3 capability).

    Solves the dispersion roots, then evaluates the amplitude response
    at each root (``surfa.f:366-371``): the e2-seeded closure
    magnitude, modulated by the water-column standing-wave factor
    ``cos(wvno d1 sqrt(|c^2/a1^2 - 1|))`` when the top layer is liquid.
    Per-layer renormalisation makes only *relative* amplitudes across
    nearby (c, T) meaningful (see ``rayleigh_amplitude``).  Returns
    (amp, c, valid), each (P, nmodes).
    """
    from pysurfinv_tpu.ops.secular import rayleigh_amplitude

    c_all, _, ok_all = surf_forward(h, vp, vs, rho, qsinv, periods, nlay,
                                    wave="rayleigh",
                                    cfg=cfg._replace(compute_group=False))
    L = h.shape[0]
    idx = jnp.arange(L)
    h_eff, fac = model_preamble(h, nlay, 2, cfg.flat)

    nmodes = cfg.nmodes
    t_l = jnp.repeat(periods, nmodes)
    c_l = c_all.reshape(-1)
    ok_l = ok_all.reshape(-1)

    def one(t, c0, ok):
        mdl = _model_at_period(t, vp, vs, rho, qsinv, fac, cfg)
        mm = effective_halfspace(c0, t, mdl[1], mdl[3], nlay, cfg.fact)
        c_safe = jnp.where(ok, c0, mdl[1][0] + 0.5)
        return rayleigh_amplitude(c_safe, t, *mdl, mm)

    amp = jax.vmap(one)(t_l, c_l, ok_l)
    amp = jnp.where(ok_l, amp, 0.0).reshape(c_all.shape)
    return amp, c_all, ok_all


def _lane_backend(cfg: SurfConfig):
    """Resolve ``cfg.backend`` for the batched solver: None for the
    vmapped XLA oracle (:func:`surf_forward`), else the Triton kernels'
    ``interpret`` flag.

    "auto" takes the compiled kernels on a GPU and the oracle anywhere
    else — never the interpreter, which only a test asks for by name
    ("pallas_interpret").  "pallas" off a GPU is an error, not a
    fallback.
    """
    backend = cfg.backend
    if backend in ("xla", "xla_assoc"):
        return None
    if backend == "pallas_interpret":
        return True
    on_gpu = jax.default_backend() == "gpu"
    if backend == "auto":
        return False if on_gpu else None
    if backend == "pallas":
        if not on_gpu:
            raise ValueError(
                f"backend='pallas' needs a GPU; JAX runs on "
                f"{jax.default_backend()!r} (use 'auto', 'xla' or "
                f"'pallas_interpret')")
        return False
    raise ValueError(f"unknown SurfConfig.backend {backend!r}")


@partial(jax.jit, static_argnames=("wave", "cfg"))
def surf_forward_batch(h, vp, vs, rho, qsinv, periods, nlay,
                       wave: str = "rayleigh", cfg: SurfConfig = SurfConfig(),
                       c_warm=None):
    """Batched dispersion solve over a leading model axis.

    On a GPU (``cfg.backend`` "auto" or "pallas") the lane-grid solver
    drives the compiled Triton secular kernels
    (:mod:`pysurfinv_tpu.ops.pallas_secular`); elsewhere, or with
    ``backend="xla"``, this is a plain vmap of :func:`surf_forward`,
    the oracle.  Both paths share the bracket / refine / implicit-diff
    algorithm and the same dc-cell semantics.

    ``periods`` may be (P,) shared across the batch, or (B, P) per
    model (the padded per-grid-point period lists of
    ``parallel.grid.invert_grid``).

    ``c_warm``: optional (B, P) previous-solution phase velocities (an
    MCMC sampler's roots from the last evaluated proposal; 0 = unknown).
    When given (fundamental mode, kernel path), the per-period
    bracketing collapses into ONE fused sweep seeded at
    ``c_warm - warm_backoff*dc`` — replacing the cold first-period scan
    and the sequential period chain.  Lanes whose window misses (root
    drifted beyond the window, or c_warm = 0) fall back to the full
    cold bracketing chain, so results match the cold path to Illinois
    tolerance (~1e-5 km/s) for ANY c_warm.  The XLA fallback path
    ignores it (same roots, cold brackets).
    """
    interp = _lane_backend(cfg)
    if interp is not None:
        return _surf_forward_batch_fast(h, vp, vs, rho, qsinv, periods,
                                        nlay, wave, cfg, interp,
                                        c_warm=c_warm)
    if periods.ndim == 2:
        return jax.vmap(
            lambda h_, vp_, vs_, rho_, q_, per_, n_: surf_forward(
                h_, vp_, vs_, rho_, q_, per_, n_, wave=wave, cfg=cfg),
        )(h, vp, vs, rho, qsinv, periods, nlay)
    return jax.vmap(
        lambda h_, vp_, vs_, rho_, q_, n_: surf_forward(
            h_, vp_, vs_, rho_, q_, periods, n_, wave=wave, cfg=cfg),
        in_axes=(0, 0, 0, 0, 0, 0),
    )(h, vp, vs, rho, qsinv, nlay)


def lane_model(h, vp, vs, rho, qsinv, nlay, wave, flat=True):
    """(B, L) model batch -> (h_eff, model_T): thin layers zeroed, and the
    7 transposed (L, B) arrays the lane evaluators take — (vp, vs, rho,
    qsinv, h_flat, vel_fac, rho_fac), flattened for ``wave`` when
    ``flat``."""
    L = h.shape[1]
    idx = jnp.arange(L)[None, :]
    nl = nlay[:, None]
    thin = (idx < nl - 1) & (h <= H_MIN)
    h_eff = jnp.where(thin | (idx >= nl - 1), 0.0, h)
    kind = 1 if wave in ("love", "lov", "L") else 2
    if flat:
        fac = jax.vmap(flatten_factors, in_axes=(0, 0, None))(
            h_eff, nlay, kind)
    else:
        ones = jnp.ones_like(h_eff)
        fac = FlatFactors(h_flat=h_eff, vel_fac=ones, rho_fac=ones)
    return h_eff, (vp.T, vs.T, rho.T, qsinv.T,
                   fac.h_flat.T, fac.vel_fac.T, fac.rho_fac.T)


def _surf_forward_batch_fast(h, vp, vs, rho, qsinv, periods, nlay,
                             wave, cfg: SurfConfig, interpret: bool,
                             c_warm=None):
    """Batched solver driving the fused Pallas secular kernel.

    Same three phases as :func:`surf_forward`, restructured so every
    secular evaluation is one ``secular_lanes`` call on a (K, B) lane
    grid (K probes x B models):

      1. bracket: per period, ONE dc-resolution sweep of the warm
         window for all models at once (the XLA path's two-stage
         coarse+fine narrowing exists to save vmapped evaluations; in
         the fused kernel a full-dc sweep is a single cheap call and
         has the same dc-sampling failure class as the reference);
      2. refine: batched Illinois over all (period, mode, model) lanes
         with the truncation frozen at each bracket's upper end;
      3. group velocity: implicit diff from the in-kernel forward-mode
         tangents (``secular_lanes_grad``), one launch for all lanes.
    """
    from pysurfinv_tpu.ops.pallas_secular import (refine_lanes,
                                                  secular_lanes,
                                                  secular_lanes_frozen,
                                                  secular_lanes_grad)

    B, L = h.shape
    dtype = h.dtype
    h_eff, model_T = lane_model(h, vp, vs, rho, qsinv, nlay, wave, cfg.flat)

    def Fv(c, t, mmf):
        return secular_lanes(c, t, mmf, *model_T, nlay, wave=wave,
                             fact=cfg.fact, t_base=cfg.t_base,
                             atten=cfg.atten, interpret=interpret)

    dc = cfg.dc
    zero_mm = lambda shp: jnp.zeros(shp, jnp.int32)  # noqa: E731

    def sweep(c_start, t_b, K, step):
        """First dc(-or-coarser) sign change above c_start, all models.

        Mirrors ``_bracket``/``_first_flip``: the search window stops at
        c >= b_halfspace + 0.3 (calcul.f:165-167) and brackets whose
        root would exceed the halfspace shear velocity are rejected
        (calcul.f:191).  Returns (c_lo, found, mm_at_upper_end,
        F(c_lo), F(c_lo + step)) — the endpoint secular values feed the
        refinement so it skips its own init evaluations.
        ``t_b`` is the per-model period vector (B,).
        """
        cs = c_start[None, :] + step * jnp.arange(K + 1, dtype=dtype)[:, None]
        tt = jnp.broadcast_to(t_b[None, :], cs.shape)
        F, bhs, mm = Fv(cs, tt, zero_mm(cs.shape))
        sgn = _sign(F)
        within = cs < (bhs + 0.3)
        cand = (sgn[:-1] != sgn[1:]) & within[1:]
        found = jnp.any(cand, axis=0)
        i = jnp.argmax(cand, axis=0)
        c_lo = jnp.take_along_axis(cs, i[None], 0)[0]
        bhs_up = jnp.take_along_axis(bhs, (i + 1)[None], 0)[0]
        mm_up = jnp.take_along_axis(mm, (i + 1)[None], 0)[0]
        found = found & (c_lo <= bhs_up)
        f_lo = jnp.take_along_axis(F, i[None], 0)[0]
        f_hi = jnp.take_along_axis(F, (i + 1)[None], 0)[0]
        return c_lo, found, mm_up, f_lo, f_hi

    def illinois_lanes(t_kb, lo, hi, mm_kb, n_iter, f_lo=None, f_hi=None):
        """`_illinois` on (K, B) lanes via the frozen-truncation kernel.

        Refinement always runs inside a bracket with the closure layer
        pinned, so the dynamic truncation walk of ``secular_lanes`` is
        dead weight here — the frozen kernel skips it.
        """
        def Ff(cc):
            return secular_lanes_frozen(
                cc, t_kb, mm_kb, *model_T, nlay, wave=wave,
                t_base=cfg.t_base, atten=cfg.atten, interpret=interpret)

        return _illinois(Ff, lo, hi, n_iter, f_lo=f_lo, f_hi=f_hi)

    nmodes = cfg.nmodes
    # periods: (P,) shared or (B, P) per model; handled as (B, P)
    periods2 = (jnp.broadcast_to(periods[None], (B, periods.shape[0]))
                if periods.ndim == 1 else periods).astype(dtype)
    P = periods2.shape[1]

    def bracket_period(t, starts, nscan, coarse0, narrow):
        """(nmodes, B) brackets at one period (cf. bracket_period above).

        ``narrow``: re-scan the coarse hit cell down to dc (the cold
        first period, whose coarse step is large).  Warm periods skip
        the re-scan: the bracket stays ``coarse0 * dc`` wide and the
        Illinois refinement absorbs it (one extra iteration) — one
        kernel launch and ``coarse0 + 1`` probe rows cheaper per period.
        Bracket widths are static; :func:`_bracket_widths` mirrors the
        branch structure here.
        """
        c_los, mms, founds, flos, fhis = [], [], [], [], []
        root_est = None
        for iq in range(nmodes):
            start = starts[iq]
            if iq > 0:
                # 0.1 dc margin over a 12-iteration estimate — see the
                # XLA bracket_period above for the measured failure
                # mode this guards against
                start = jnp.maximum(start, root_est + 0.1 * dc)
            if iq == 0 and coarse0 > 1:
                k = max(nscan // coarse0, 1)
                c_lo, found, mm, flo, fhi = sweep(start, t, k,
                                                  coarse0 * dc)
                width = coarse0 * dc
                if narrow:
                    c_lo2, found_f, mm2, flo, fhi = sweep(c_lo, t,
                                                          coarse0, dc)
                    c_lo, mm = c_lo2, mm2
                    found = found & found_f
                    width = dc
            else:
                c_lo, found, mm, flo, fhi = sweep(start, t, nscan, dc)
                width = dc
            if iq < nmodes - 1:
                root_est = illinois_lanes(
                    t[None], c_lo[None], c_lo[None] + width, mm[None],
                    12, f_lo=flo[None], f_hi=fhi[None])[0]
            c_los.append(c_lo)
            mms.append(mm)
            founds.append(found)
            flos.append(flo)
            fhis.append(fhi)
        return (jnp.stack(c_los), jnp.stack(mms), jnp.stack(founds),
                jnp.stack(flos), jnp.stack(fhis))

    def _bracket_widths(coarse0, narrow):
        """Static per-mode bracket widths matching bracket_period."""
        w0 = dc if (narrow or coarse0 <= 1) else coarse0 * dc
        return [w0] + [dc] * (nmodes - 1)

    def cold_bracket():
        """Standard phase 1: cold first-period scan + warm-started
        period chain + rescue.  Returns (c_lo, mm, ok, f_lo, f_hi),
        each (P, nmodes, B)."""
        t1 = periods2[:, 0]
        c_init = jax.vmap(
            lambda h_, vs_, q_, n_, t_: _initial_c(h_, vs_, q_, n_, t_,
                                                   wave, cfg)
        )(h_eff, vs, qsinv, nlay, t1)
        starts0 = jnp.broadcast_to(c_init[None], (nmodes, B)).astype(dtype)
        lo0, mm0, ok0, fl0, fh0 = bracket_period(
            t1, starts0, cfg.nscan_first, cfg.coarse_first, narrow=True)
        if nmodes > 1:
            ok0 = jax.vmap(_mode_chain, in_axes=1, out_axes=1)(ok0)

        def step(carry, t):
            c_start, alive = carry
            lok, mmk, okk, flk, fhk = bracket_period(
                t, c_start, cfg.nscan, cfg.coarse, narrow=False)
            okk = okk & alive
            if nmodes > 1:
                okk = jax.vmap(_mode_chain, in_axes=1, out_axes=1)(okk)
            new_start = jnp.where(okk, lok - cfg.warm_backoff * dc,
                                  c_start)
            return (new_start, okk), (lok, mmk, okk, flk, fhk)

        if P == 1:
            return lo0[None], mm0[None], ok0[None], fl0[None], fh0[None]

        carry0 = (jnp.where(ok0, lo0 - cfg.warm_backoff * dc, starts0),
                  ok0)
        _, (lor, mmr, okr, flr, fhr) = lax.scan(step, carry0,
                                                periods2[:, 1:].T)
        c_lo = jnp.concatenate([lo0[None], lor], 0)    # (P, nmodes, B)
        mm = jnp.concatenate([mm0[None], mmr], 0)
        ok = jnp.concatenate([ok0[None], okr], 0)
        f_lo = jnp.concatenate([fl0[None], flr], 0)
        f_hi = jnp.concatenate([fh0[None], fhr], 0)

        # ---- rescue pass (see surf_forward): sparse period lists can
        # outrun the warm-start window; re-bracket failed lanes from a
        # cold start.  narrow=False keeps bracket widths equal to the
        # warm convention so the static w_pm table below stays valid;
        # lax.map (not vmap) because the fused kernel has no batching
        # rule.  The lax.cond skips all of it when nothing failed — the
        # dense-period MCMC hot path pays only the predicate.
        chain_b = (lambda o: jax.vmap(jax.vmap(
            _mode_chain, in_axes=1, out_axes=1))(o)) if nmodes > 1 \
            else (lambda o: o)

        def _rescue(carry):
            c_lo, mm, ok, f_lo, f_hi = carry

            def cold(t_b):
                ci = jax.vmap(
                    lambda h_, vs_, q_, n_, t_: _initial_c(
                        h_, vs_, q_, n_, t_, wave, cfg)
                )(h_eff, vs, qsinv, nlay, t_b)
                st = jnp.broadcast_to(ci[None], (nmodes, B)).astype(dtype)
                return bracket_period(t_b, st, cfg.nscan_first,
                                      cfg.coarse, narrow=False)

            lo_c, mm_c, ok_c, fl_c, fh_c = lax.map(cold,
                                                   periods2[:, 1:].T)
            ok_c = chain_b(ok_c)
            use = ~ok[1:] & ok_c
            ok_new = jnp.concatenate([ok[:1], chain_b(ok[1:] | ok_c)], 0)
            mix = lambda a, b: jnp.concatenate(  # noqa: E731
                [a[:1], jnp.where(use, b, a[1:])], 0)
            return (mix(c_lo, lo_c), mix(mm, mm_c), ok_new,
                    mix(f_lo, fl_c), mix(f_hi, fh_c))

        return lax.cond(jnp.all(ok), lambda x: x, _rescue,
                        (c_lo, mm, ok, f_lo, f_hi))

    use_warm = c_warm is not None and nmodes == 1
    if use_warm:
        # ---- fused warm bracket: ONE sweep for all (period, model)
        # lanes, seeded from the caller's previous roots.  Replaces the
        # cold first-period scan (~74 probe rows) and the sequential
        # per-period sweep chain (P-1 dependent launches) with a single
        # (P*(nprobe+1), B) kernel call: per-step root drift in MCMC is
        # small (measured on Cascadia chains: median 0.5*dc, p99
        # 2.7*dc, max 7.3*dc per evaluated step), so a backoff/nscan
        # window centred on the previous root almost always hits.
        w_nscan = cfg.wseed_nscan if cfg.wseed_nscan > 0 else cfg.nscan
        w_back = (cfg.wseed_backoff if cfg.wseed_backoff >= 0
                  else cfg.warm_backoff)
        w_coarse = cfg.wseed_coarse if cfg.wseed_coarse > 0 else cfg.coarse
        nprobe = max(w_nscan // w_coarse, 1)
        step_w = w_coarse * dc
        starts_w = (c_warm.T - w_back * dc).astype(dtype)        # (P,B)
        ladder = step_w * jnp.arange(nprobe + 1, dtype=dtype)
        cs = (starts_w[:, None, :] + ladder[None, :, None]).reshape(-1, B)
        tt = jnp.broadcast_to(periods2.T[:, None, :],
                              (P, nprobe + 1, B)).reshape(-1, B)
        F, bhs, mm_all = Fv(cs, tt, zero_mm(cs.shape))
        sgn = _sign(F).reshape(P, nprobe + 1, B)
        csr = cs.reshape(P, nprobe + 1, B)
        bhs_r = bhs.reshape(P, nprobe + 1, B)
        mm_r = mm_all.reshape(P, nprobe + 1, B)
        cand = (sgn[:, :-1] != sgn[:, 1:]) & (csr[:, 1:] < bhs_r[:, 1:]
                                              + 0.3)
        w_found = jnp.any(cand, axis=1)                       # (P, B)
        i = jnp.argmax(cand, axis=1)
        tk0 = lambda a: jnp.take_along_axis(a, i[:, None], 1)[:, 0]
        tk1 = lambda a: jnp.take_along_axis(a, (i + 1)[:, None], 1)[:, 0]
        w_lo = tk0(csr)
        w_found = w_found & (w_lo <= tk1(bhs_r)) & (c_warm.T > 0.05)
        w_mm = tk1(mm_r)
        Fr = F.reshape(P, nprobe + 1, B)
        # expand the nmodes=1 axis to match cold_bracket's layout
        warm = (w_lo[:, None], w_mm[:, None], w_found[:, None],
                tk0(Fr)[:, None], tk1(Fr)[:, None])

        def _fill_cold(wargs):
            w_lo, w_mm, w_ok, w_fl, w_fh = wargs
            c_lo, mm, ok, f_lo, f_hi = cold_bracket()
            return (jnp.where(w_ok, w_lo, c_lo),
                    jnp.where(w_ok, w_mm, mm), w_ok | ok,
                    jnp.where(w_ok, w_fl, f_lo),
                    jnp.where(w_ok, w_fh, f_hi), w_ok)

        c_lo, mm, ok, f_lo, f_hi, from_warm = lax.cond(
            jnp.all(warm[2]), lambda w: (*w, w[2]), _fill_cold, warm)
    else:
        c_lo, mm, ok, f_lo, f_hi = cold_bracket()
        from_warm = None

    # ---- phase 2: batched Illinois over (P*nmodes, B) lanes ----------
    KL = P * nmodes
    t_l = jnp.repeat(periods2.T, nmodes, axis=0)       # (P*nmodes, B)
    lo_l = c_lo.reshape(KL, B)
    mm_l = mm.reshape(KL, B)
    ok_l = ok.reshape(KL, B)
    # endpoint handoff — see the SurfConfig.fhandoff doc (measured a
    # NET LOSS at bench scale; opt-in for launch-overhead-bound runs)
    if cfg.fhandoff:
        flo_l = f_lo.reshape(KL, B)
        fhi_l = f_hi.reshape(KL, B)
    else:
        flo_l = fhi_l = None

    # static per-(period, mode) bracket widths -> (KL, 1); warm-seeded
    # lanes always carry a coarse*dc bracket instead
    w_pm = ([_bracket_widths(cfg.coarse_first, True)]
            + [_bracket_widths(cfg.coarse, False)] * (P - 1))
    w_l = jnp.asarray([w for per in w_pm for w in per],
                      dtype).reshape(KL, 1)
    if from_warm is not None:
        wc = cfg.wseed_coarse if cfg.wseed_coarse > 0 else cfg.coarse
        w_l = jnp.where(from_warm.reshape(KL, B),
                        jnp.asarray(wc * dc, dtype), w_l)
    hi_l = jnp.broadcast_to(lo_l + w_l, lo_l.shape)

    if cfg.newton_sep >= 1:
        # separated safeguarded Newton: the bracket side comes from the
        # sweep's own endpoint value (no probe launch); then newton_sep
        # gradient launches iterate from the bracket midpoint — Newton
        # step clamped by the live bracket with midpoint fallback
        # (guaranteed progress), except the LAST step, which is a
        # CLIPPED Newton polish (the same convention as the Illinois
        # path's free polish; a midpoint bounce there would throw a
        # converged lane back to the middle of whatever bracket
        # remains).
        def Fg(cc):
            return secular_lanes_grad(
                cc, t_l, mm_l, *model_T, nlay, wave=wave,
                t_base=cfg.t_base, atten=cfg.atten, interpret=interpret)

        s_lo = _sign(flo_l) if flo_l is not None else _sign(
            secular_lanes_frozen(
                lo_l, t_l, mm_l, *model_T, nlay, wave=wave,
                t_base=cfg.t_base, atten=cfg.atten, interpret=interpret))
        cur_lo, cur_hi = lo_l, hi_l
        x = 0.5 * (lo_l + hi_l)
        for j in range(cfg.newton_sep):
            f_j, fc_j, _ = Fg(x)
            same_lo = _sign(f_j) == s_lo
            cur_lo = jnp.where(same_lo, x, cur_lo)
            cur_hi = jnp.where(same_lo, cur_hi, x)
            fc_safe = jnp.where(jnp.abs(fc_j) > 0, fc_j, 1.0)
            xn = x - f_j / fc_safe
            if j == cfg.newton_sep - 1:
                x = jnp.clip(xn, cur_lo, cur_hi)
            else:
                bad = ~((xn > cur_lo) & (xn < cur_hi))
                x = jnp.where(bad, 0.5 * (cur_lo + cur_hi), xn)
        root_l = x
        if cfg.compute_group:
            # group velocity from tangents AT the refined root (the
            # Illinois path's convention — u away from the root is
            # amplified by the tangent-ratio sensitivity), plus the
            # free clipped Newton polish from the same launch
            f_g, fc_g, ft_g = Fg(root_l)
            fc_safe = jnp.where(jnp.abs(fc_g) > 0, fc_g, 1.0)
            u_l = root_l / (1.0 - (t_l / root_l) * ft_g / fc_safe)
            root_l = jnp.clip(root_l - f_g / fc_safe, cur_lo, cur_hi)
        else:
            u_l = jnp.zeros_like(root_l)
    elif cfg.nnewton >= 1:
        # fused refine: all Illinois iterations + Newton tail + group
        # tangents in ONE kernel launch
        root_l, u_l = refine_lanes(
            lo_l, hi_l, t_l, mm_l, *model_T, nlay, wave=wave,
            t_base=cfg.t_base, atten=cfg.atten, n_ill=cfg.nbisect,
            n_newton=cfg.nnewton, compute_group=cfg.compute_group,
            interpret=interpret)
    else:
        if cfg.fuse_illinois:
            # all Illinois iterations in ONE plain-body kernel launch
            # (same algorithm as illinois_lanes)
            root_l, _ = refine_lanes(
                lo_l, hi_l, t_l, mm_l, *model_T, nlay, wave=wave,
                t_base=cfg.t_base, atten=cfg.atten, n_ill=cfg.nbisect,
                n_newton=0, compute_group=False, interpret=interpret)
        else:
            root_l = illinois_lanes(t_l, lo_l, hi_l, mm_l, cfg.nbisect,
                                    f_lo=flo_l, f_hi=fhi_l)
        # ---- group velocity, u = c / (1 - (T/c) F_T/F_c) ------------
        # Exact forward-mode tangents *inside* the fused kernel
        # (secular_lanes_grad): one launch for all lanes, primal
        # residuals reused by both tangents.  Finite differences
        # through the kernel fail at shallow roots where the
        # renormalised f32 secular value sits at the noise floor.
        if cfg.compute_group:
            f0_l, fc_l, ft_l = secular_lanes_grad(
                root_l, t_l, mm_l, *model_T, nlay, wave=wave,
                t_base=cfg.t_base, atten=cfg.atten, interpret=interpret)
            fc_l = jnp.where(jnp.abs(fc_l) > 0, fc_l, 1.0)
            u_l = root_l / (1.0 - (t_l / root_l) * ft_l / fc_l)
            # free Newton polish: the tangent launch already evaluated
            # (F, F_c) at the Illinois root, so one clamped Newton step
            # costs nothing and buys ~2 Illinois iterations of accuracy
            root_l = jnp.clip(root_l - f0_l / fc_l, lo_l, hi_l)
        else:
            u_l = jnp.zeros_like(root_l)

    # root <= b_halfspace (calcul.f:191): b_hs for the frozen truncation
    # is layer mm-1's attenuated+flattened shear velocity — a pure XLA
    # gather, one kernel launch cheaper than re-evaluating the secular.
    idx_h = (mm_l - 1).astype(jnp.int32)
    lnt_l = (jnp.log(cfg.t_base / t_l) / jnp.pi if cfg.atten
             else jnp.zeros_like(t_l))
    gat = lambda a: jnp.take_along_axis(a, idx_h, axis=0)  # noqa: E731
    bhs_l = (gat(model_T[1]) * (1.0 + gat(model_T[3]) * lnt_l)
             * gat(model_T[5]))
    ok_l = ok_l & (root_l <= bhs_l)

    c_out = jnp.where(ok_l, root_l, 0.0)
    u_out = jnp.where(ok_l, u_l, 0.0)
    # (P*nmodes, B) -> (B, P, nmodes)
    reshape = lambda x: jnp.moveaxis(x.reshape(P, nmodes, B), 2, 0)  # noqa
    return reshape(c_out), reshape(u_out), reshape(ok_l)


@partial(jax.jit, static_argnames=("cfg", "cfg_love", "nsub",
                                   "wseed_nscan", "wseed_backoff",
                                   "wseed_coarse"))
def surf_forward_joint(h, vp, vs, rho, qsinv, periods, nlay,
                       cfg: SurfConfig = SurfConfig(),
                       cfg_love: SurfConfig | None = None,
                       nsub: int = 512, wseed_nscan: int = 8,
                       wseed_backoff: int = 4, wseed_coarse: int = 0):
    """Joint Rayleigh+Love curves with calibrated cross-wave continuation.

    The reference computes both waves independently (``fast_surf.f:2-5``
    returns uR, uL, cR, cL from one call but runs two full period
    loops).  Here the joint solve exploits the tight empirical coupling
    between the two fundamental branches of the SAME model: Love roots
    sit a slowly-varying offset above Rayleigh roots (measured on the
    bench family: cL - cR in [0.398, 0.469] km/s, per-period spread
    ~+-0.01 around the family median).  The scheme:

      1. solve Love cold (the cheaper 2x2 recursion);
      2. cold-solve Rayleigh on a strided ``nsub``-model calibration
         subset (~``nsub/B`` of a full solve) and take the per-period
         MEDIAN offset ``offs(T) = median(cL - cR)`` over valid lanes;
      3. solve Rayleigh for the full batch seeded at ``cL - offs(T)``
         through the fused ``c_warm`` sweep with a ``wseed_nscan * dc``
         window (backoff ``wseed_backoff * dc``).

    Correctness does NOT depend on the calibration quality: lanes whose
    window misses the root fall back to the full cold bracketing chain
    (the ``c_warm`` contract), and the window sits well inside the
    warm-sweep band validated root-adjacent by the MCMC warm-start
    evidence (zero spurious brackets in 147k transitions at wider
    windows).  Roots match the independent solves to Illinois
    tolerance; gated by ``tests/test_joint_forward.py`` and, on the
    card, by ``chip_smoke.py``.

    Returns ``(cR, uR, okR, cL, uL, okL)``, each ``(B, P, nmodes)``.
    """
    cfg_l = cfg_love if cfg_love is not None else cfg
    interp = _lane_backend(cfg)
    if interp is None or cfg.nmodes != 1:
        cR, uR, okR = surf_forward_batch(h, vp, vs, rho, qsinv, periods,
                                         nlay, wave="rayleigh", cfg=cfg)
        cL, uL, okL = surf_forward_batch(h, vp, vs, rho, qsinv, periods,
                                         nlay, wave="love", cfg=cfg_l)
        return cR, uR, okR, cL, uL, okL

    cL, uL, okL = _surf_forward_batch_fast(h, vp, vs, rho, qsinv,
                                           periods, nlay, "love", cfg_l,
                                           interp)

    B = h.shape[0]
    ns = min(nsub, B)
    stride = max(B // ns, 1)
    sl = slice(0, stride * ns, stride)
    per_sub = periods[sl] if periods.ndim == 2 else periods
    # calibration solve: bracket-accuracy roots are plenty for a median
    # offset (the seed window is +-wseed_nscan/2 dc wide), so trim the
    # refinement and skip group velocity
    cfg_sub = cfg._replace(compute_group=False, nbisect=3)
    cRs, _, okRs = _surf_forward_batch_fast(
        h[sl], vp[sl], vs[sl], rho[sl], qsinv[sl], per_sub, nlay[sl],
        "rayleigh", cfg_sub, interp)
    d = cL[sl][:, :, 0] - cRs[:, :, 0]                       # (ns, P)
    valid = okL[sl][:, :, 0] & okRs[:, :, 0]
    offs = jnp.nanmedian(jnp.where(valid, d, jnp.nan), axis=0)   # (P,)

    # NaN offsets (no valid calibration lane at that period) poison the
    # seed -> the sweep finds nothing -> full cold fallback.  Exactly
    # the right failure semantics, and NaN-free for found lanes.
    c_pred = jnp.where(okL[:, :, 0], cL[:, :, 0] - offs[None, :], 0.0)
    cfg_seed = cfg._replace(wseed_nscan=wseed_nscan,
                            wseed_backoff=wseed_backoff,
                            wseed_coarse=wseed_coarse)
    cR, uR, okR = _surf_forward_batch_fast(h, vp, vs, rho, qsinv,
                                           periods, nlay, "rayleigh",
                                           cfg_seed, interp,
                                           c_warm=c_pred)
    return cR, uR, okR, cL, uL, okL
