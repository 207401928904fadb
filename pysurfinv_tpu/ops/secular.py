"""Thomson–Haskell / Dunkin secular functions as masked JAX layer scans.

Behavioural spec from the reference Fortran:

  * Love wave: 2x2 Haskell propagation of (displacement, stress) from the
    effective halfspace up to the free surface; the secular function is
    the negated surface stress (``/root/reference/fast_surf_src/surfa.f:135-183``,
    function DLTAR1).
  * Rayleigh wave: Dunkin reduced-delta formulation — a 5-component
    subdeterminant vector propagated from the free surface down through
    the stack, closed with the halfspace condition
    (``surfa.f:185-372``, function DLTAR4, dispersion branch mup=1),
    including the liquid-surface-layer branch (``surfa.f:216-251``).
  * Dynamic halfspace truncation: layers deeper than ``fact = 4``
    wavelengths of cumulative evanescent (c < vs) thickness are replaced
    by a halfspace (``surfa.f:92-106``).
  * Per-period physical-dispersion (attenuation) rescale of velocities
    (``calcul.f:121-130``) with t_base = 1 s.

Design notes:
  * All branches (liquid layer, evanescent/oscillatory/critical regimes,
    truncation) are ``where``-masks, not control flow; one trace serves
    every (model, period, c) lane.
  * Layers are padded to a static length L; zero-thickness layers are
    exact identity updates in both recursions, so padding is free.
  * The per-layer matrix entries are computed *inside* the scan body
    from the raw (vp, vs, rho, d) rows.  Precomputing them would
    materialize an (L, 15, lanes) tensor in device memory: the scan
    would become memory-bound where recomputing is compute-bound.
  * The 5-vector / 2-vector state is renormalised by its max-abs every
    layer (the reference relies on float32 range plus truncation); the
    rescale is sign-preserving and wrapped in ``stop_gradient`` so both
    root locations and every AD derivative of the secular function are
    exactly those of the unscaled recursion.
  * The unselected branch of every ``where`` is computed on clamped
    arguments (the classic double-where trick) so ``jax.grad`` through
    the secular function is NaN-free.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
from jax import lax

# Scan unrolling trades compile time for runtime: each loop iteration
# carries fixed overhead that dominates this tiny-state scan, but
# unrolling multiplies HLO size, which hurts CPU test compile times
# badly. Tests set this to 1.
SCAN_UNROLL = int(os.environ.get("PYSURFINV_SCAN_UNROLL", "8"))

TWO_PI = 6.283185307179586
ACCUR = 1e-8  # regime-switch tolerance, surfa.f:191-192


def attenuation_rescale(vp_ref, vs_ref, qsinv, t, t_base=1.0):
    """Physical-dispersion velocity rescale at period ``t``.

    calcul.f:121-130:  qsq = qsinv*ln(t_base/t)/pi,
    qpq = qsq*(4/3)*(vs_ref/vp_ref)^2, b = b_ref*(1+qsq), a = a_ref*(1+qpq).
    """
    qsq = qsinv * jnp.log(t_base / t) / jnp.pi
    vp_safe = jnp.where(jnp.abs(vp_ref) > 0, vp_ref, 1.0)
    qpq = qsq * 1.33333333 * (vs_ref / vp_safe) ** 2
    return vp_ref * (1.0 + qpq), vs_ref * (1.0 + qsq)


def effective_halfspace(c, t, b, d, nlay, fact=4.0):
    """1-based effective layer count after 4-wavelength truncation.

    Mirrors DLTAR's idrop block (surfa.f:92-106): walk the stack, summing
    thicknesses of layers with c < vs; the first layer at which that sum
    exceeds ``fact * c * t`` becomes the halfspace.  Clamped to >= 2.
    """
    L = b.shape[0]
    idx = jnp.arange(L)
    dmax = fact * c * t
    cond = (c < b) & (idx < nlay)
    csum = jnp.cumsum(jnp.where(cond, d, 0.0))
    exceed = cond & (csum > dmax)
    m = jnp.where(jnp.any(exceed), jnp.argmax(exceed) + 1, nlay)
    return jnp.maximum(m, 2)


def _pq_terms(r, wd):
    """Branchless (r*sin, sin/r, cos) analogues for one wavenumber regime.

    Matches surfa.f:212-219 — ``r`` carries the reference sign convention
    (negative for evanescent, positive for oscillatory):
      r < 0:   rsin = -r*sinh(wd*r),  sinr = sinh(wd*r)/r,  cosx = cosh(wd*r)
      r > 0:   rsin =  r*sin(wd*r),   sinr = sin(wd*r)/r,   cosx = cos(wd*r)
      |r|~0:   rsin = 0,              sinr = wd,            cosx = 1
    """
    ev = r < -ACCUR
    osc = r > ACCUR
    pm = wd * r
    pm_ev = jnp.where(ev, pm, 0.0)
    pm_osc = jnp.where(osc, pm, 0.0)
    r_safe = jnp.where(jnp.abs(r) > ACCUR, r, 1.0)
    # sinh/cosh from one exp (pm_ev <= 0, so e <= 1 and 1/e is bounded by
    # the truncation window) — one transcendental instead of two; this is
    # also exactly how the reference evaluates them (surfa.f:267-269)
    e = jnp.exp(pm_ev)
    einv = 1.0 / e
    sh, ch = 0.5 * (e - einv), 0.5 * (e + einv)
    sn, cs = jnp.sin(pm_osc), jnp.cos(pm_osc)
    rsin = jnp.where(ev, -r * sh, jnp.where(osc, r * sn, 0.0))
    sinr = jnp.where(ev, sh / r_safe, jnp.where(osc, sn / r_safe, wd))
    cosx = jnp.where(ev, ch, jnp.where(osc, cs, 1.0))
    return rsin, sinr, cosx


def _vertical_wavenumbers(c, a, b):
    """Signed ra, rb and g, g1 (surfa.f:211-258); liquid-safe."""
    csq = c * c
    arga = 1.0 - csq / (a * a)
    ra_abs = jnp.sqrt(jnp.abs(arga))
    ra = jnp.where(arga > 0.0, -ra_abs, ra_abs)
    liquid = jnp.abs(b) <= ACCUR
    b_safe = jnp.where(liquid, 1.0, b)
    argb = 1.0 - csq / (b_safe * b_safe)
    rb_abs = jnp.sqrt(jnp.abs(argb))
    rb = jnp.where(argb > 0.0, -rb_abs, rb_abs)
    g = 2.0 * b_safe * b_safe / csq
    return ra, rb, g, g - 1.0, liquid


def _dunkin_entries(c, csq, wvno, a_m, b_m, rho_m, d_m):
    """Per-layer Dunkin 5x5 subdeterminant entries (surfa.f:259-320).

    Returns the 15 independent entries plus the liquid-layer mask; shared
    by the dispersion (mup=1) and ellipticity/amplitude (mup=2/3)
    recursions.
    """
    ra, rb, g, g1, liquid = _vertical_wavenumbers(c, a_m, b_m)
    wd = wvno * d_m
    rsinp, sinpr, cosp = _pq_terms(ra, wd)
    rsinq, sinqr, cosq = _pq_terms(rb, wd)

    rhoc = rho_m * csq
    rr = rsinp * rsinq
    ss = sinpr * sinqr
    cc = cosp * cosq
    rs1 = rsinp * cosq
    rs2 = sinqr * cosp
    rs3 = sinpr * cosq
    rs4 = rsinq * cosp
    gm = 2.0 * g - 1.0
    gs = g * g
    g1s = g1 * g1
    ccm = 1.0 - cc
    gg1 = g * g1
    rhocs = rhoc * rhoc
    suu = gs * rr + g1s * ss

    e11 = (2.0 * gs - gm) * cc - suu - 2.0 * gg1
    e12 = -(rs1 + rs2) / rhoc
    e13 = -2.0 * (gm * ccm + g1 * ss + g * rr) / rhoc
    e14 = (rs3 + rs4) / rhoc
    e15 = (2.0 * ccm + rr + ss) / rhocs
    e21 = rhoc * (g1s * rs3 + gs * rs4)
    e22 = cc
    e23 = 2.0 * (g * rs4 + g1 * rs3)
    e24 = sinpr * rsinq
    e31 = rhoc * (gg1 * gm * ccm + g1s * g1 * ss + gs * g * rr)
    e32 = g1 * rs2 + g * rs1
    e33 = 1.0 + 2.0 * (2.0 * gg1 * ccm + suu)
    e41 = -rhoc * (g1s * rs2 + gs * rs1)
    e42 = rsinp * sinqr
    e51 = rhocs * (2.0 * gs * g1s * ccm + gs * gs * rr + g1s * g1s * ss)

    # liquid-surface-layer override (surfa.f:216-251)
    zero = jnp.zeros_like(e11)
    e11_l = jnp.where(liquid, cosp, e11)
    e21_l = jnp.where(liquid, rhoc * sinpr, e21)
    liq0 = jnp.where(liquid, zero, jnp.ones_like(e11))
    out = dict(
        e11=e11_l, e21=e21_l,
        e12=e12 * liq0, e13=e13 * liq0, e14=e14 * liq0, e15=e15 * liq0,
        e22=e22 * liq0, e23=e23 * liq0, e24=e24 * liq0,
        e31=e31 * liq0, e32=e32 * liq0, e33=e33 * liq0,
        e41=e41 * liq0, e42=e42 * liq0, e51=e51 * liq0,
    )
    return out, liquid


def _dunkin_update(e, b1, b2, b3, b4, b5):
    """Symmetric 5-vector update (surfa.f:326-335)."""
    bb1 = (e["e11"] * b1 + e["e12"] * b2 + e["e13"] * b3
           + e["e14"] * b4 + e["e15"] * b5)
    bb2 = (e["e21"] * b1 + e["e22"] * b2 + e["e23"] * b3
           + e["e24"] * b4 - e["e14"] * b5)
    bb3 = (e["e31"] * b1 + e["e32"] * b2 + e["e33"] * b3
           - 0.5 * e["e23"] * b4 + 0.5 * e["e13"] * b5)
    bb4 = (e["e41"] * b1 + e["e42"] * b2 - 2.0 * e["e32"] * b3
           + e["e22"] * b4 - e["e12"] * b5)
    bb5 = (e["e51"] * b1 - e["e41"] * b2 + 2.0 * e["e31"] * b3
           - e["e21"] * b4 + e["e11"] * b5)
    return jnp.stack([bb1, bb2, bb3, bb4, bb5])


def _dunkin_closure(c, csq, a_h, b_h, rho_h, bvec):
    """Halfspace closure row applied to a propagated 5-vector
    (surfa.f:340-354)."""
    ra_h, rb_h, g_h, g1_h, _ = _vertical_wavenumbers(c, a_h, b_h)
    ra_h = jnp.where(jnp.abs(ra_h) > ACCUR, ra_h, -ACCUR)
    den = rho_h * a_h * a_h
    gra = g_h * ra_h
    rba = rb_h - 1.0 / ra_h
    A11 = (-2.0 * rb_h * (b_h * b_h) / (a_h * a_h)
           + csq * (g1_h * g1_h) / ((a_h * a_h) * gra))
    A12 = -1.0 / (g_h * den)
    A13 = -rb_h / den + g1_h / (den * gra)
    A14 = rb_h / (den * gra)
    A15 = rba / ((rho_h * a_h) ** 2 * csq * g_h)
    return (A11 * bvec[0] + A12 * bvec[1] + 2.0 * A13 * bvec[2]
            + A14 * bvec[3] + A15 * bvec[4])


def rayleigh_secular(c, t, a, b, rho, d, mmax):
    """Dunkin reduced-delta Rayleigh secular function (DLTAR4, mup=1).

    Args:
      c, t:  trial phase velocity and period (scalars).
      a, b, rho, d: (L,) flattened+attenuated padded model arrays.
      mmax:  effective 1-based layer count (from ``effective_halfspace``).

    Returns the (renormalised) secular determinant; only its sign and the
    ratios of its partials at a root are meaningful.
    """
    wvno = TWO_PI / (c * t)
    csq = c * c
    L = a.shape[0]
    apply_mask = jnp.arange(L) < (mmax - 1)

    def body(bvec, xs):
        a_m, b_m, rho_m, d_m, apply = xs
        ra, rb, g, g1, liquid = _vertical_wavenumbers(c, a_m, b_m)
        wd = wvno * d_m
        rsinp, sinpr, cosp = _pq_terms(ra, wd)
        rsinq, sinqr, cosq = _pq_terms(rb, wd)

        # solid-layer matrix entries (surfa.f:259-320)
        rhoc = rho_m * csq
        rr = rsinp * rsinq
        ss = sinpr * sinqr
        cc = cosp * cosq
        rs1 = rsinp * cosq
        rs2 = sinqr * cosp
        rs3 = sinpr * cosq
        rs4 = rsinq * cosp
        gm = 2.0 * g - 1.0
        gs = g * g
        g1s = g1 * g1
        ccm = 1.0 - cc
        gg1 = g * g1
        rhocs = rhoc * rhoc
        suu = gs * rr + g1s * ss

        e11 = (2.0 * gs - gm) * cc - suu - 2.0 * gg1
        e12 = -(rs1 + rs2) / rhoc
        e13 = -2.0 * (gm * ccm + g1 * ss + g * rr) / rhoc
        e14 = (rs3 + rs4) / rhoc
        e15 = (2.0 * ccm + rr + ss) / rhocs
        e21 = rhoc * (g1s * rs3 + gs * rs4)
        e22 = cc
        e23 = 2.0 * (g * rs4 + g1 * rs3)
        e24 = sinpr * rsinq
        e31 = rhoc * (gg1 * gm * ccm + g1s * g1 * ss + gs * g * rr)
        e32 = g1 * rs2 + g * rs1
        e33 = 1.0 + 2.0 * (2.0 * gg1 * ccm + suu)
        e41 = -rhoc * (g1s * rs2 + gs * rs1)
        e42 = rsinp * sinqr
        e51 = rhocs * (2.0 * gs * g1s * ccm + gs * gs * rr
                       + g1s * g1s * ss)

        # liquid-surface-layer override (surfa.f:216-251)
        zero = jnp.zeros_like(e11)
        e11 = jnp.where(liquid, cosp, e11)
        e21 = jnp.where(liquid, rhoc * sinpr, e21)
        e12, e13, e14, e15 = [jnp.where(liquid, zero, x)
                              for x in (e12, e13, e14, e15)]
        e22, e23, e24 = [jnp.where(liquid, zero, x)
                         for x in (e22, e23, e24)]
        e31, e32, e33 = [jnp.where(liquid, zero, x)
                         for x in (e31, e32, e33)]
        e41, e42, e51 = [jnp.where(liquid, zero, x)
                         for x in (e41, e42, e51)]

        # symmetric 5-vector update (surfa.f:326-335)
        b1, b2, b3, b4, b5 = bvec
        bb1 = e11 * b1 + e12 * b2 + e13 * b3 + e14 * b4 + e15 * b5
        bb2 = e21 * b1 + e22 * b2 + e23 * b3 + e24 * b4 - e14 * b5
        bb3 = (e31 * b1 + e32 * b2 + e33 * b3 - 0.5 * e23 * b4
               + 0.5 * e13 * b5)
        bb4 = e41 * b1 + e42 * b2 - 2.0 * e32 * b3 + e22 * b4 - e12 * b5
        bb5 = e51 * b1 - e41 * b2 + 2.0 * e31 * b3 - e21 * b4 + e11 * b5
        new = jnp.stack([bb1, bb2, bb3, bb4, bb5])
        new = jnp.where(apply, new, bvec)
        # stop_gradient: the rescale must be an AD constant, or it
        # contaminates the second derivatives behind group kernels
        scale = lax.stop_gradient(jnp.max(jnp.abs(new)))
        return new / jnp.where(scale > 0.0, scale, 1.0), None

    bvec0 = jnp.zeros((5,), dtype=a.dtype).at[0].set(1.0)
    xs = (a[:-1], b[:-1], rho[:-1], d[:-1], apply_mask[:-1])
    bvec, _ = lax.scan(body, bvec0, xs, unroll=SCAN_UNROLL)

    # --- halfspace closure (surfa.f:340-354) -----------------------------
    h = mmax - 1
    a_h, b_h, rho_h = a[h], b[h], rho[h]
    ra_h, rb_h, g_h, g1_h, _ = _vertical_wavenumbers(c, a_h, b_h)
    ra_h = jnp.where(jnp.abs(ra_h) > ACCUR, ra_h, -ACCUR)
    den = rho_h * a_h * a_h
    gra = g_h * ra_h
    rba = rb_h - 1.0 / ra_h
    A11 = (-2.0 * rb_h * (b_h * b_h) / (a_h * a_h)
           + csq * (g1_h * g1_h) / ((a_h * a_h) * gra))
    A12 = -1.0 / (g_h * den)
    A13 = -rb_h / den + g1_h / (den * gra)
    A14 = rb_h / (den * gra)
    A15 = rba / ((rho_h * a_h) ** 2 * csq * g_h)
    bb1 = (A11 * bvec[0] + A12 * bvec[1] + 2.0 * A13 * bvec[2]
           + A14 * bvec[3] + A15 * bvec[4])
    return -bb1


def love_secular(c, t, b, rho, d, mmax):
    """Haskell Love-wave secular function (DLTAR1, mup=1).

    Propagates (transverse displacement, stress) from the effective
    halfspace (index mmax-1) up to the surface; water layers (vs = 0) are
    skipped (surfa.f:150-152).  Returns the negated surface stress.
    """
    wvno = TWO_PI / (c * t)
    L = b.shape[0]
    idx = jnp.arange(L)

    # Halfspace initial state (surfa.f:143-148).
    h = mmax - 1
    b_h = jnp.where(jnp.abs(b[h]) > ACCUR, b[h], 1.0)
    rb_h = jnp.sqrt(jnp.abs((c / b_h) ** 2 - 1.0))
    ut0 = jnp.ones((), dtype=b.dtype)
    tt0 = rho[h] * b_h * b_h * rb_h
    scale0 = lax.stop_gradient(jnp.maximum(jnp.abs(ut0), jnp.abs(tt0)))
    state0 = jnp.stack([ut0, tt0]) / jnp.where(scale0 > 0, scale0, 1.0)

    apply_mask = (idx <= (mmax - 2)) & (jnp.abs(b) > ACCUR)

    def body(state, xs):
        b_m, rho_m, d_m, apply = xs
        water = jnp.abs(b_m) <= ACCUR
        b_safe = jnp.where(water, 1.0, b_m)
        rb = jnp.sqrt(jnp.abs((c / b_safe) ** 2 - 1.0))
        hmu = rho_m * b_safe * b_safe
        q = -wvno * d_m * rb
        # regimes (surfa.f:156-172)
        osc = (c > b_safe) & (rb >= 1e-20)
        ev = (c < b_safe) & (rb >= 1e-20)
        q_osc = jnp.where(osc, q, 0.0)
        q_ev = jnp.where(ev, q, 0.0)
        rb_safe = jnp.where(rb >= 1e-20, rb, 1.0)
        eq = jnp.exp(q_ev)  # q_ev <= 0
        shq, chq = 0.5 * (eq - 1.0 / eq), 0.5 * (eq + 1.0 / eq)
        y = jnp.where(osc, jnp.sin(q_osc) / rb_safe,
                      jnp.where(ev, shq / rb_safe, -wvno * d_m))
        z = jnp.where(osc, rb * jnp.sin(q_osc),
                      jnp.where(ev, -rb * shq, 0.0))
        cosq = jnp.where(osc, jnp.cos(q_osc), jnp.where(ev, chq, 1.0))
        ut, tt = state
        eut = cosq * ut - y * tt / hmu
        ett = hmu * z * ut + cosq * tt
        new = jnp.stack([eut, ett])
        new = jnp.where(apply, new, state)
        scale = lax.stop_gradient(jnp.max(jnp.abs(new)))
        return new / jnp.where(scale > 0, scale, 1.0), None

    xs = (b[:-1], rho[:-1], d[:-1], apply_mask[:-1])
    state, _ = lax.scan(body, state0, xs, reverse=True, unroll=SCAN_UNROLL)
    return -state[1]


def _dunkin_pair(c, t, a, b, rho, d, mmax):
    """Propagate the e2- and e3-seeded Dunkin recursions jointly.

    DLTAR4's mup=2/3 modes rerun the recursion from unit vectors e2 and
    e3 instead of e1, and skip liquid layers entirely
    (``surfa.f:196-207, 218``: ``if(mup.gt.1) goto 50``).  The reference
    runs them sequentially without renormalisation; here both 5-vectors
    share one scan state and one scale factor, so their *ratio* — the
    only quantity mup=2 consumes — is exactly that of the unscaled
    recursions.
    """
    wvno = TWO_PI / (c * t)
    csq = c * c
    L = a.shape[0]
    apply_mask = jnp.arange(L) < (mmax - 1)

    def body(state, xs):
        a_m, b_m, rho_m, d_m, apply = xs
        e, liquid = _dunkin_entries(c, csq, wvno, a_m, b_m, rho_m, d_m)
        u, v = state
        new_u = _dunkin_update(e, *u)
        new_v = _dunkin_update(e, *v)
        keep = apply & ~liquid
        new_u = jnp.where(keep, new_u, u)
        new_v = jnp.where(keep, new_v, v)
        scale = lax.stop_gradient(
            jnp.maximum(jnp.max(jnp.abs(new_u)), jnp.max(jnp.abs(new_v))))
        inv = 1.0 / jnp.where(scale > 0.0, scale, 1.0)
        return (new_u * inv, new_v * inv), None

    e2 = jnp.zeros((5,), dtype=a.dtype).at[1].set(1.0)
    e3 = jnp.zeros((5,), dtype=a.dtype).at[2].set(1.0)
    xs = (a[:-1], b[:-1], rho[:-1], d[:-1], apply_mask[:-1])
    (u, v), _ = lax.scan(body, (e2, e3), xs, unroll=SCAN_UNROLL)

    h = mmax - 1
    F2 = _dunkin_closure(c, csq, a[h], b[h], rho[h], u)
    F3 = _dunkin_closure(c, csq, a[h], b[h], rho[h], v)
    return F2, F3


def rayleigh_ellipticity(c, t, a, b, rho, d, mmax):
    """Surface H/V ellipticity at a Rayleigh root (DLTAR4, mup=2).

    ``surfa.f:360-364``: ellipticity = 0.5 * bb1(jump=3) / bb1(jump=2),
    evaluated at the dispersion root ``c``.
    """
    F2, F3 = _dunkin_pair(c, t, a, b, rho, d, mmax)
    F2 = jnp.where(jnp.abs(F2) > 0, F2, ACCUR)
    return 0.5 * F3 / F2


def rayleigh_amplitude(c, t, a, b, rho, d, mmax):
    """Amplitude response |bb1| at a Rayleigh root (DLTAR4, mup=3).

    ``surfa.f:366-371``: the e2-seeded recursion's closure magnitude;
    when the surface layer is liquid the response is modulated by the
    water-column standing-wave factor cos(wvno * d1 * sqrt(|c^2/a1^2
    - 1|)).  NOTE: unlike the reference, the returned magnitude is
    renormalised per layer, so only *relative* amplitudes across nearby
    (c, t) are meaningful — matching how SURF_AMP consumes it.
    """
    F2, _ = _dunkin_pair(c, t, a, b, rho, d, mmax)
    amp = jnp.abs(F2)
    liquid_top = jnp.abs(b[0]) <= ACCUR
    wvno = TWO_PI / (c * t)
    ra = c / a[0]
    rad = wvno * d[0] * jnp.sqrt(jnp.abs(ra * ra - 1.0))
    return jnp.where(liquid_top, jnp.abs(amp * jnp.cos(rad)), amp)
