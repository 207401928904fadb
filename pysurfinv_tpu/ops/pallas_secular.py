"""Pallas GPU kernels (Triton route) for the secular-function hot loop.

The root search (``ops/dispersion.py``) spends ~99% of its FLOPs
evaluating the Rayleigh/Love secular functions: a layer recursion on a
5-vector (Dunkin, ``fast_surf_src/surfa.f:185-372``) or
2-vector (Haskell, ``surfa.f:135-183``) per (model, period, trial-c)
lane.  The XLA path (``ops/secular.py``) expresses that as
``vmap(lax.scan)`` — correct and differentiable, but each scan step
round-trips the lane state through device memory.

These kernels fuse the *entire* evaluation — per-period attenuation
rescale, dynamic 4-wavelength halfspace truncation, the layer
recursion with per-layer renormalisation, and the halfspace closure —
into one pass per lane tile whose state never leaves registers:

  * lanes are laid out (K, B): K "probes" (c-grid points or periods)
    by B models; one program owns a (kb, bb) tile of them;
  * model arrays are stored transposed, (L, B), so each per-layer row
    load is one coalesced read across the tile's bb models, shared by
    its kb probes; the programs of one model strip run back to back
    (probe axis first in the launch grid), so the strip stays in L2;
  * the truncation (``surfa.f:92-106``) runs inline: a running
    evanescent-thickness sum closes each lane at its own ``mmax`` and
    records the halfspace row on the fly, instead of a separate
    pre-pass;
  * ``mm_frozen > 0`` pins the closure layer per lane, reproducing the
    NEVILL convention of refining inside a bracket with the truncation
    frozen at the bracket's upper end (``calcul.f:156-172``).

Rows are indexed one at a time inside the layer loop (``ref[l]``), so
only the (bb,) row loads need power-of-two sizes; the layer count L is
free.  Each wrapper pads K and B up to whole tiles and slices the
padding off again.

The XLA implementation remains the single source of truth for AD
(group velocity, sensitivity kernels) and for float64 golden tests;
``tests/test_pallas_secular.py`` pins the two paths against each other
in interpret mode.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

TWO_PI = 6.283185307179586
ACCUR = 1e-8  # regime-switch tolerance, surfa.f:191-192


class Tile(NamedTuple):
    """Launch shape of the kernels."""

    kb: int      # probes per program
    bb: int      # models per program (a power of two)
    warps: int   # num_warps of the Triton launch


# Chosen by timing the kernels on an H100 at the bench shape (PERF.md):
# one lane per thread.  Other (kb, bb, warps) with 4 warps timed the
# same; 8 warps slowed the tangent kernel; unrolling the layer loop by
# 2 or 4 was slower and compiled 4-20x longer, so the loop stays rolled.
TILE = Tile(kb=1, bb=128, warps=4)


def _pq(r, wd):
    """Branchless (r*sin, sin/r, cos) for one signed wavenumber regime.

    Mirrors ``ops/secular.py::_pq_terms`` exactly (surfa.f:212-219).
    """
    ev = r < -ACCUR
    osc = r > ACCUR
    pm = wd * r
    pm_ev = jnp.where(ev, pm, 0.0)
    pm_osc = jnp.where(osc, pm, 0.0)
    r_safe = jnp.where(jnp.abs(r) > ACCUR, r, 1.0)
    e = jnp.exp(pm_ev)  # pm_ev <= 0 within the truncation window
    einv = 1.0 / e
    sh, ch = 0.5 * (e - einv), 0.5 * (e + einv)
    sn, cs = jnp.sin(pm_osc), jnp.cos(pm_osc)
    rsin = jnp.where(ev, -r * sh, jnp.where(osc, r * sn, 0.0))
    sinr = jnp.where(ev, sh / r_safe, jnp.where(osc, sn / r_safe, wd))
    cosx = jnp.where(ev, ch, jnp.where(osc, cs, 1.0))
    return rsin, sinr, cosx


def _wavenumbers(c, a, b):
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


def _ray_prop(cv, tv, b1, b2, b3, b4, b5, a_l, b_l, rho_l, d_l):
    """Unscaled Dunkin 5-vector update through one layer (surfa.f:259-335).

    Pure elementwise function of the trial (c, T) and the incoming
    5-vector, with the layer material held constant — the form both the
    plain kernels and the ``jax.linearize``-based gradient kernel share.
    """
    csq = cv * cv
    wvno = TWO_PI / (cv * tv)
    zero = jnp.zeros_like(cv)
    one = jnp.ones_like(cv)

    ra, rb, g, g1, liquid = _wavenumbers(cv, a_l, b_l)
    wd = wvno * d_l
    rsinp, sinpr, cosp = _pq(ra, wd)
    rsinq, sinqr, cosq = _pq(rb, wd)

    rhoc = rho_l * csq
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
    inv_rhoc = 1.0 / rhoc

    e11 = (2.0 * gs - gm) * cc - suu - 2.0 * gg1
    e12 = -(rs1 + rs2) * inv_rhoc
    e13 = -2.0 * (gm * ccm + g1 * ss + g * rr) * inv_rhoc
    e14 = (rs3 + rs4) * inv_rhoc
    e15 = (2.0 * ccm + rr + ss) * inv_rhoc * inv_rhoc
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
    e11 = jnp.where(liquid, cosp, e11)
    e21 = jnp.where(liquid, rhoc * sinpr, e21)
    liq0 = jnp.where(liquid, zero, one)
    e12, e13, e14, e15 = (x * liq0 for x in (e12, e13, e14, e15))
    e22, e23, e24 = (x * liq0 for x in (e22, e23, e24))
    e31, e32, e33 = (x * liq0 for x in (e31, e32, e33))
    e41, e42, e51 = (x * liq0 for x in (e41, e42, e51))

    bb1 = e11 * b1 + e12 * b2 + e13 * b3 + e14 * b4 + e15 * b5
    bb2 = e21 * b1 + e22 * b2 + e23 * b3 + e24 * b4 - e14 * b5
    bb3 = (e31 * b1 + e32 * b2 + e33 * b3 - 0.5 * e23 * b4
           + 0.5 * e13 * b5)
    bb4 = e41 * b1 + e42 * b2 - 2.0 * e32 * b3 + e22 * b4 - e12 * b5
    bb5 = e51 * b1 - e41 * b2 + 2.0 * e31 * b3 - e21 * b4 + e11 * b5
    return bb1, bb2, bb3, bb4, bb5


def _renorm(vec):
    """Divide a state vector by its max-abs (sign-preserving)."""
    scale = jnp.abs(vec[0])
    for x in vec[1:]:
        scale = jnp.maximum(scale, jnp.abs(x))
    inv = 1.0 / jnp.where(scale > 0.0, scale, 1.0)
    return tuple(x * inv for x in vec), inv


def _ray_closure(cv, b1, b2, b3, b4, b5, a_h, b_h, rho_h):
    """Halfspace closure -> secular value (surfa.f:340-354)."""
    csq = cv * cv
    ra_h, rb_h, g_h, g1_h, _ = _wavenumbers(cv, a_h, b_h)
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
    return -(A11 * b1 + A12 * b2 + 2.0 * A13 * b3 + A14 * b4
             + A15 * b5)


def _love_prop(cv, tv, ut, tt, b_l, rho_l, d_l):
    """Unscaled Haskell (u, stress) update through one layer
    (surfa.f:156-172); water layers are the caller's mask."""
    wvno = TWO_PI / (cv * tv)
    water = jnp.abs(b_l) <= ACCUR
    b_safe = jnp.where(water, 1.0, b_l)
    rb = jnp.sqrt(jnp.abs((cv / b_safe) ** 2 - 1.0))
    hmu = rho_l * b_safe * b_safe
    q = -wvno * d_l * rb
    osc = (cv > b_safe) & (rb >= 1e-20)
    ev = (cv < b_safe) & (rb >= 1e-20)
    q_osc = jnp.where(osc, q, 0.0)
    q_ev = jnp.where(ev, q, 0.0)
    rb_safe = jnp.where(rb >= 1e-20, rb, 1.0)
    eq = jnp.exp(q_ev)  # q_ev <= 0
    shq, chq = 0.5 * (eq - 1.0 / eq), 0.5 * (eq + 1.0 / eq)
    sn = jnp.sin(q_osc)
    y = jnp.where(osc, sn / rb_safe,
                  jnp.where(ev, shq / rb_safe, -wvno * d_l))
    z = jnp.where(osc, rb * sn, jnp.where(ev, -rb * shq, 0.0))
    cosq = jnp.where(osc, jnp.cos(q_osc), jnp.where(ev, chq, 1.0))
    eut = cosq * ut - y * tt / hmu
    ett = hmu * z * ut + cosq * tt
    return eut, ett


def _love_init(cv, b_h, rho_h):
    """Halfspace initial (u, stress) for Love (surfa.f:143-148)."""
    b_hs = jnp.where(jnp.abs(b_h) > ACCUR, b_h, 1.0)
    rb_h = jnp.sqrt(jnp.abs((cv / b_hs) ** 2 - 1.0))
    return jnp.ones_like(cv), rho_h * b_hs * b_hs * rb_h


def _make_layer_model(vp_ref, vs_ref, rho_ref, qsi_ref, hf_ref, vf_ref,
                      rf_ref, lnt, atten):
    """Attenuated + flattened (a, b, rho, d) row accessor, material at
    the period behind ``lnt`` (the fixed-material group convention)."""
    def layer_model(l):
        vp_l = vp_ref[l][None, :]
        vs_l = vs_ref[l][None, :]
        rho_l = rho_ref[l][None, :]
        qsi_l = qsi_ref[l][None, :]
        hf_l = hf_ref[l][None, :]
        vf_l = vf_ref[l][None, :]
        rf_l = rf_ref[l][None, :]
        if atten:
            qsq = qsi_l * lnt
            vp_s = jnp.where(jnp.abs(vp_l) > 0, vp_l, 1.0)
            qpq = qsq * 1.33333333 * (vs_l / vp_s) ** 2
            a_l = vp_l * (1.0 + qpq) * vf_l
            b_l = vs_l * (1.0 + qsq) * vf_l
        else:
            a_l = vp_l * vf_l
            b_l = vs_l * vf_l
        return a_l, b_l, rho_l * rf_l, hf_l

    return layer_model


def _dynamic_truncation(c, t, fact, mmf, nlay, layer_model, L):
    """Inline truncation walk (surfa.f:92-106) for one lane tile.

    Returns (a_h, b_h, rho_h, mm): each lane's closure-layer material
    and 1-based layer count.  ``mmf > 0`` pins the closure layer
    instead (NEVILL convention).
    """
    dmax = fact * c * t
    frozen = mmf > 0
    shape = c.shape
    nlay_b = jnp.broadcast_to(nlay, shape)

    def body(l, carry):
        closed, csum, pending, a_h, b_h, rho_h, mm = carry
        a_l, b_l, rho_l, d_l = layer_model(l)
        cond = (c < b_l) & (l < nlay)
        csum = csum + jnp.where(cond, d_l, 0.0)
        exceed = cond & (csum > dmax)
        close_dyn = pending | exceed | (l == nlay - 1)
        close_sel = jnp.where(frozen, l == mmf - 1, close_dyn)
        close_now = ~closed & (l >= 1) & close_sel
        pending = pending | (exceed & (l == 0))
        a_h = jnp.where(close_now, a_l, a_h)
        b_h = jnp.where(close_now, b_l, b_h)
        rho_h = jnp.where(close_now, rho_l, rho_h)
        mm = jnp.where(close_now, l + 1, mm)
        return closed | close_now, csum, pending, a_h, b_h, rho_h, mm

    false = jnp.zeros(shape, jnp.bool_)
    one = jnp.ones_like(c)
    carry = (false, jnp.zeros_like(c), false, one, one, one, nlay_b)
    closed, _, _, a_h, b_h, rho_h, mm = jax.lax.fori_loop(0, L - 1, body, carry)
    # lanes never closed in 0..L-2 close with the last (halfspace) row
    a_last, b_last, rho_last, _ = layer_model(L - 1)
    return (jnp.where(closed, a_h, a_last), jnp.where(closed, b_h, b_last),
            jnp.where(closed, rho_h, rho_last),
            jnp.where(closed, mm, nlay_b))


def _rayleigh_kernel(vp_ref, vs_ref, rho_ref, qsi_ref,
                     hf_ref, vf_ref, rf_ref, nlay_ref,
                     c_ref, t_ref, tm_ref, mmf_ref,
                     f_out, bhs_out, mm_out, *, fact, t_base, atten, L):
    """One (kb, bb) lane tile of Rayleigh secular evaluations.

    ``t`` drives the wavenumber/truncation; ``tm`` drives the material
    (physical-dispersion) rescale.  They are equal in normal use and
    differ only for the fixed-material finite differences behind the
    group velocity (see dispersion._group_velocity's convention).
    Pass 1 walks down to find each lane's closure layer; pass 2 runs
    the Dunkin recursion above it, the same code as the frozen kernel.
    """
    c = c_ref[...]
    t = t_ref[...]
    lnt = jnp.log(t_base / tm_ref[...]) / jnp.pi if atten else None
    layer_model = _make_layer_model(vp_ref, vs_ref, rho_ref, qsi_ref,
                                    hf_ref, vf_ref, rf_ref, lnt, atten)
    a_h, b_h, rho_h, mm = _dynamic_truncation(
        c, t, fact, mmf_ref[...], nlay_ref[...], layer_model, L)
    f_out[...] = _ray_secular_tile(c, t, mm, layer_model, a_h, b_h, rho_h,
                                   L)
    bhs_out[...] = b_h
    mm_out[...] = mm.astype(jnp.int32)


def _love_kernel(vp_ref, vs_ref, rho_ref, qsi_ref,
                 hf_ref, vf_ref, rf_ref, nlay_ref,
                 c_ref, t_ref, tm_ref, mmf_ref,
                 f_out, bhs_out, mm_out, *, fact, t_base, atten, L):
    """One (kb, bb) lane tile of Love secular evaluations.

    Pass 1 walks down to find each lane's closure layer and halfspace
    row; pass 2 propagates (ut, tt) from the halfspace back to the
    surface (DLTAR1, surfa.f:135-183).
    """
    c = c_ref[...]
    t = t_ref[...]
    lnt = jnp.log(t_base / tm_ref[...]) / jnp.pi if atten else None
    layer_model = _make_layer_model(vp_ref, vs_ref, rho_ref, qsi_ref,
                                    hf_ref, vf_ref, rf_ref, lnt, atten)
    _, b_h, rho_h, mm = _dynamic_truncation(
        c, t, fact, mmf_ref[...], nlay_ref[...], layer_model, L)
    f_out[...] = _love_secular_tile(c, t, mm, layer_model, b_h, rho_h, L)
    bhs_out[...] = b_h
    mm_out[...] = mm.astype(jnp.int32)


def _capture_halfspace(layer_model, mmf, shape, L):
    """(a, b, rho) of each lane's frozen closure layer ``mmf - 1``."""
    a_last, b_last, rho_last, _ = layer_model(L - 1)

    def cap_body(l, carry):
        a_h, b_h, rho_h = carry
        a_l, b_l, rho_l, _ = layer_model(l)
        capture = l == mmf - 1
        return (jnp.where(capture, a_l, a_h),
                jnp.where(capture, b_l, b_h),
                jnp.where(capture, rho_l, rho_h))

    bc = lambda x: jnp.broadcast_to(x, shape)  # noqa: E731
    return jax.lax.fori_loop(0, L - 1, cap_body,
                             (bc(a_last), bc(b_last), bc(rho_last)))


def _ray_secular_tile(cv, t, mmf, layer_model, a_h, b_h, rho_h, L):
    """Secular value at frozen mm for one lane tile (plain, no tangents)."""
    one = jnp.ones_like(cv)
    zero = jnp.zeros_like(cv)

    def body(l, carry):
        nb = _ray_prop(cv, t, *carry, *layer_model(l))
        apply = l < (mmf - 1)
        nb = [jnp.where(apply, p, o) for p, o in zip(nb, carry)]
        return _renorm(nb)[0]

    b = jax.lax.fori_loop(0, L - 1, body, (one, zero, zero, zero, zero))
    return _ray_closure(cv, *b, a_h, b_h, rho_h)


def _ray_secular_grad_tile(cv, t, mmf, layer_model, a_h, b_h, rho_h, L):
    """(F, dF/dc, dF/dT) at frozen mm — per-layer ``jax.linearize``
    with the tangents riding the loop carry (renorm factor an AD
    constant, like ``ops.secular``'s stop_gradient)."""
    one = jnp.ones_like(cv)
    zero = jnp.zeros_like(cv)

    def body(l, carry):
        b, dc, dt = carry[0:5], carry[5:10], carry[10:15]
        a_l, b_l, rho_l, d_l = layer_model(l)
        apply = l < (mmf - 1)

        def prop(x, tv, *bv):
            return _ray_prop(x, tv, *bv, a_l, b_l, rho_l, d_l)

        primal, lin = jax.linearize(prop, cv, t, *b)
        dcs = lin(one, zero, *dc)
        dts = lin(zero, one, *dt)
        nb = [jnp.where(apply, p, o) for p, o in zip(primal, b)]
        ndc = [jnp.where(apply, p, o) for p, o in zip(dcs, dc)]
        ndt = [jnp.where(apply, p, o) for p, o in zip(dts, dt)]
        nb, inv = _renorm(nb)
        return nb + tuple(x * inv for x in ndc + ndt)

    carry = (one, zero, zero, zero, zero) + (zero,) * 10
    carry = jax.lax.fori_loop(0, L - 1, body, carry)

    def clos(x, *bv):
        return _ray_closure(x, *bv, a_h, b_h, rho_h)

    F, lin = jax.linearize(clos, cv, *carry[0:5])
    return F, lin(one, *carry[5:10]), lin(zero, *carry[10:15])


def _love_secular_tile(cv, t, mmf, layer_model, b_h, rho_h, L):
    """Love secular value at closure layer count ``mmf`` for one tile:
    (ut, tt) propagated from the halfspace up to the surface."""
    (ut, tt), _ = _renorm(_love_init(cv, b_h, rho_h))

    def body(i, carry):
        l = L - 2 - i
        _, b_l, rho_l, d_l = layer_model(l)
        water = jnp.abs(b_l) <= ACCUR
        apply = (l <= mmf - 2) & ~water
        pu, ps = _love_prop(cv, t, *carry, b_l, rho_l, d_l)
        new = (jnp.where(apply, pu, carry[0]),
               jnp.where(apply, ps, carry[1]))
        return _renorm(new)[0]

    ut, tt = jax.lax.fori_loop(0, L - 1, body, (ut, tt))
    return -tt


def _love_secular_grad_tile(cv, t, mmf, layer_model, b_h, rho_h, L):
    """(F, dF/dc, dF/dT) Love analogue of :func:`_ray_secular_grad_tile`."""
    one = jnp.ones_like(cv)
    zero = jnp.zeros_like(cv)

    (ut, tt), lin0 = jax.linearize(lambda x: _love_init(x, b_h, rho_h), cv)
    utc, ttc = lin0(one)
    (ut, tt), inv0 = _renorm((ut, tt))
    utc, ttc = utc * inv0, ttc * inv0

    def body(i, carry):
        ut, tt, utc, ttc, utt, ttt = carry
        l = L - 2 - i
        _, b_l, rho_l, d_l = layer_model(l)
        water = jnp.abs(b_l) <= ACCUR
        apply = (l <= mmf - 2) & ~water

        def prop(x, tv, u, s):
            return _love_prop(x, tv, u, s, b_l, rho_l, d_l)

        (pu, ps), lin = jax.linearize(prop, cv, t, ut, tt)
        duc, dsc = lin(one, zero, utc, ttc)
        dut, dst = lin(zero, one, utt, ttt)
        new = [jnp.where(apply, p, o) for p, o in
               zip((pu, ps, duc, dsc, dut, dst), carry)]
        (nut, ntt), inv = _renorm(new[:2])
        return (nut, ntt) + tuple(x * inv for x in new[2:])

    ut, tt, utc, ttc, utt, ttt = jax.lax.fori_loop(0, 
        L - 1, body, (ut, tt, utc, ttc, zero, zero))
    return -tt, -ttc, -ttt


def _grad_kernel(vp_ref, vs_ref, rho_ref, qsi_ref,
                 hf_ref, vf_ref, rf_ref, nlay_ref,
                 c_ref, t_ref, mmf_ref,
                 f_out, fc_out, ft_out, *, wave, t_base, atten, L):
    """(F, dF/dc, dF/dT) at a *frozen* truncation, one lane tile.

    Forward-mode tangents via ``jax.linearize`` of the per-layer update:
    the primal recursion runs once, and the two tangents (w.r.t. the
    trial c and the wavenumber period T) reuse its residuals — no extra
    transcendentals.  The material (attenuation) is held at ``t``,
    matching the reference's fixed-material group-velocity convention
    (see dispersion._group_velocity), and the per-layer
    renormalisation factor is treated as an AD constant exactly like the
    ``stop_gradient`` in ``ops.secular``.  Powers the group velocity
    u = c / (1 - (T/c) F_T/F_c) without leaving the fused kernel.
    """
    c = c_ref[...]
    t = t_ref[...]
    mmf = mmf_ref[...]                # int32, always >= 2 here
    lnt = jnp.log(t_base / t) / jnp.pi if atten else None
    layer_model = _make_layer_model(vp_ref, vs_ref, rho_ref, qsi_ref,
                                    hf_ref, vf_ref, rf_ref, lnt, atten)
    a_h, b_h, rho_h = _capture_halfspace(layer_model, mmf, c.shape, L)
    if _is_rayleigh(wave):
        F, Fc, Ft = _ray_secular_grad_tile(c, t, mmf, layer_model, a_h,
                                           b_h, rho_h, L)
    else:
        F, Fc, Ft = _love_secular_grad_tile(c, t, mmf, layer_model, b_h,
                                            rho_h, L)
    f_out[...] = F
    fc_out[...] = Fc
    ft_out[...] = Ft


def _frozen_kernel(vp_ref, vs_ref, rho_ref, qsi_ref,
                   hf_ref, vf_ref, rf_ref, nlay_ref,
                   c_ref, t_ref, mmf_ref, f_out, *, wave, t_base, atten,
                   L):
    """Plain secular evaluation at a *frozen* truncation (no tangents).

    The refinement phase always evaluates inside a bracket whose
    closure layer is pinned (NEVILL convention), so the dynamic
    truncation walk of the main kernel — the running evanescent sum,
    close/pending bookkeeping — is dead weight there.  This kernel
    captures the halfspace row once and runs the bare recursion.
    """
    c = c_ref[...]
    t = t_ref[...]
    mmf = mmf_ref[...]
    lnt = jnp.log(t_base / t) / jnp.pi if atten else None
    layer_model = _make_layer_model(vp_ref, vs_ref, rho_ref, qsi_ref,
                                    hf_ref, vf_ref, rf_ref, lnt, atten)
    a_h, b_h, rho_h = _capture_halfspace(layer_model, mmf, c.shape, L)
    if _is_rayleigh(wave):
        f_out[...] = _ray_secular_tile(c, t, mmf, layer_model, a_h, b_h,
                                       rho_h, L)
    else:
        f_out[...] = _love_secular_tile(c, t, mmf, layer_model, b_h,
                                        rho_h, L)


def _refine_kernel(vp_ref, vs_ref, rho_ref, qsi_ref,
                   hf_ref, vf_ref, rf_ref, nlay_ref,
                   lo_ref, hi_ref, t_ref, mmf_ref,
                   root_out, u_out, *, wave, t_base, atten, L,
                   n_ill, n_newton, compute_group):
    """Bracket -> root -> group velocity, one launch per lane tile.

    Replaces the ``nbisect`` separate Illinois kernel launches of the
    batched solver (plus the tangent launch behind group velocity) with
    a single fused pass:

      1. ``n_ill + 2`` Illinois (regula falsi) iterations — the first
         two evaluate the bracket endpoints — shrink [lo, hi];
      2. ``n_newton`` bracket-clamped Newton iterations using the
         in-kernel forward-mode tangent (quadratic tail convergence);
      3. the last Newton iteration's (F_c, F_T) give the group velocity
         u = c / (1 - (T/c) F_T/F_c) for free — the implicit-diff
         replacement of the reference's eigenfunction energy integrals
         (surfa.f LEIGEN/REIGEN).

    The truncation is frozen per lane (``mmf``, NEVILL convention).
    """
    lo = lo_ref[...]
    hi = hi_ref[...]
    t = t_ref[...]
    mmf = mmf_ref[...]
    lnt = jnp.log(t_base / t) / jnp.pi if atten else None
    layer_model = _make_layer_model(vp_ref, vs_ref, rho_ref, qsi_ref,
                                    hf_ref, vf_ref, rf_ref, lnt, atten)
    a_h, b_h, rho_h = _capture_halfspace(layer_model, mmf, lo.shape, L)
    if _is_rayleigh(wave):
        F_of = lambda x: _ray_secular_tile(  # noqa: E731
            x, t, mmf, layer_model, a_h, b_h, rho_h, L)
        Fg_of = lambda x: _ray_secular_grad_tile(  # noqa: E731
            x, t, mmf, layer_model, a_h, b_h, rho_h, L)
    else:
        F_of = lambda x: _love_secular_tile(  # noqa: E731
            x, t, mmf, layer_model, b_h, rho_h, L)
        Fg_of = lambda x: _love_secular_grad_tile(  # noqa: E731
            x, t, mmf, layer_model, b_h, rho_h, L)

    sgn = lambda x: jnp.where(x >= 0, 1.0, -1.0)  # noqa: E731
    zero = jnp.zeros_like(lo)

    # ---- phase A: Illinois; iterations 0/1 evaluate the endpoints ----
    def ill_step(j, st):
        lo, hi, flo, fhi, side = st
        denom = fhi - flo
        denom = jnp.where(jnp.abs(denom) > 0, denom, 1.0)
        x_int = (lo * fhi - hi * flo) / denom
        bad = ~((x_int > lo) & (x_int < hi))
        x_reg = jnp.where(bad, 0.5 * (lo + hi), x_int)
        is0 = j == 0
        is1 = j == 1
        x = jnp.where(is0, lo, jnp.where(is1, hi, x_reg))
        fx = F_of(x)
        same_lo = sgn(fx) == sgn(flo)
        nlo = jnp.where(same_lo, x, lo)
        nflo = jnp.where(same_lo, fx, flo)
        nhi = jnp.where(same_lo, hi, x)
        nfhi = jnp.where(same_lo, fhi, fx)
        nfhi = jnp.where(same_lo & (side == -1), 0.5 * nfhi, nfhi)
        nflo = jnp.where(~same_lo & (side == 1), 0.5 * nflo, nflo)
        nside = jnp.where(same_lo, -1.0, 1.0)
        # endpoint-evaluation phases leave the bracket untouched
        ep = is0 | is1
        nlo = jnp.where(ep, lo, nlo)
        nhi = jnp.where(ep, hi, nhi)
        nflo = jnp.where(is0, fx, jnp.where(is1, flo, nflo))
        nfhi = jnp.where(is1, fx, jnp.where(is0, fhi, nfhi))
        nside = jnp.where(ep, zero, nside)
        return nlo, nhi, nflo, nfhi, nside

    lo, hi, flo, fhi, _ = jax.lax.fori_loop(
        0, n_ill + 2, ill_step, (lo, hi, zero, zero, zero))
    denom = fhi - flo
    denom = jnp.where(jnp.abs(denom) > 0, denom, 1.0)
    x = jnp.clip((lo * fhi - hi * flo) / denom, lo, hi)

    if n_newton == 0:
        # Illinois-only fuse: no gradient tile is traced at all
        root_out[...] = x
        u_out[...] = zero
        return
    slo = sgn(flo)

    # ---- phase B: bracket-clamped Newton with in-kernel tangents -----
    # The LAST iteration is evaluation-only: near the root the f32
    # secular value sits at its noise floor, so a final Newton step
    # would jitter x by |F_noise / F_c| inside whatever bracket
    # remains; instead it just reads the tangents at the polished x
    # for the group velocity.
    def newt_step(j, st):
        x, lo, hi, u = st
        F, Fc, Ft = Fg_of(x)
        same_lo = sgn(F) == slo
        nlo = jnp.where(same_lo, x, lo)
        nhi = jnp.where(same_lo, hi, x)
        fc_safe = jnp.where(jnp.abs(Fc) > 0, Fc, 1.0)
        xn = x - F / fc_safe
        bad = ~((xn > nlo) & (xn < nhi))
        xn = jnp.where(bad, 0.5 * (nlo + nhi), xn)
        xn = jnp.where(j < n_newton - 1, xn, x)
        if compute_group:
            ratio = Ft / fc_safe
            u = x / (1.0 - (t / x) * ratio)
        return xn, nlo, nhi, u

    x, lo, hi, u = jax.lax.fori_loop(0, n_newton, newt_step,
                                     (x, lo, hi, zero))
    root_out[...] = x
    u_out[...] = u


def _is_rayleigh(wave):
    return wave in ("rayleigh", "ray", "R")


def _pad_to(x, n, axis, fill):
    pad = n - x.shape[axis]
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=fill)


def _lane_call(kernel, interpret, model, nlay, lanes, fills, out_dtypes):
    """Launch ``kernel`` over a (K, B) lane grid in ``TILE``s.

    ``model``: the 7 transposed (L, B) model arrays; ``nlay``: (B,);
    ``lanes``: (K, B) per-lane inputs, padded up to whole tiles with
    ``fills`` (inert values: padded lanes compute finite garbage that
    is sliced off).  Returns the (K, B) outputs.
    """
    K, B = lanes[0].shape
    L = model[0].shape[0]
    kb, bb = TILE.kb, TILE.bb
    Kp, Bp = -(-K // kb) * kb, -(-B // bb) * bb
    lanes = [_pad_to(_pad_to(x, Kp, 0, f), Bp, 1, f)
             for x, f in zip(lanes, fills)]
    model = [_pad_to(x, Bp, 1, 1.0) for x in model]
    nlay2 = _pad_to(nlay.astype(jnp.int32)[None, :], Bp, 1, 2)
    body = partial(kernel, L=L)

    mspec = pl.BlockSpec((L, bb), lambda i, j: (0, j))
    nspec = pl.BlockSpec((1, bb), lambda i, j: (0, j))
    lspec = pl.BlockSpec((kb, bb), lambda i, j: (i, j))
    outs = pl.pallas_call(
        body,
        grid=(Kp // kb, Bp // bb),
        in_specs=[mspec] * 7 + [nspec] + [lspec] * len(lanes),
        out_specs=tuple(lspec for _ in out_dtypes),
        out_shape=tuple(jax.ShapeDtypeStruct((Kp, Bp), d)
                        for d in out_dtypes),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=TILE.warps,
                                                num_stages=1),
        interpret=interpret,
        name=kernel.func.__name__.strip("_"),
    )(*model, nlay2, *lanes)
    return tuple(o[:K, :B] for o in outs)


@partial(jax.jit, static_argnames=("wave", "fact", "t_base", "atten",
                                   "interpret"))
def secular_lanes(c, t, mm_frozen, vp, vs, rho, qsi, h_flat, vel_fac,
                  rho_fac, nlay, wave: str = "rayleigh", fact: float = 4.0,
                  t_base: float = 1.0, atten: bool = True,
                  interpret: bool = False, t_mat=None):
    """Evaluate the secular function on a (K, B) lane grid.

    Args:
      c, t:       (K, B) trial phase velocities and periods.
      mm_frozen:  (K, B) int32; 0 = dynamic truncation, >0 = pinned
                  1-based closure layer count (NEVILL convention).
      vp..rho_fac: (L, B) transposed padded model arrays; ``h_flat``,
                  ``vel_fac``, ``rho_fac`` from ``ops.flatten`` (pass
                  ones/h for an unflattened run).
      nlay:       (B,) int32 real-layer counts.
      t_mat:      optional (K, B) material period (default ``t``).

    Returns:
      F:    (K, B) secular values (sign/roots as ``ops.secular``),
      b_hs: (K, B) shear velocity of each lane's closure halfspace,
      mm:   (K, B) int32 closure layer counts actually used.
    """
    kern = _rayleigh_kernel if _is_rayleigh(wave) else _love_kernel
    t_mat = t if t_mat is None else t_mat
    return _lane_call(
        partial(kern, fact=fact, t_base=t_base, atten=atten),
        interpret, (vp, vs, rho, qsi, h_flat, vel_fac, rho_fac), nlay,
        (c, t, t_mat, mm_frozen), (1.0, 1.0, 1.0, 2),
        (c.dtype, c.dtype, jnp.int32))


@partial(jax.jit, static_argnames=("wave", "t_base", "atten", "interpret"))
def secular_lanes_frozen(c, t, mm_frozen, vp, vs, rho, qsi, h_flat,
                         vel_fac, rho_fac, nlay, wave: str = "rayleigh",
                         t_base: float = 1.0, atten: bool = True,
                         interpret: bool = False):
    """Secular values on a (K, B) lane grid at frozen truncation.

    Same contract as :func:`secular_lanes` with ``mm_frozen >= 2``
    everywhere, returning only F — the refinement-phase fast path.
    """
    f, = _lane_call(
        partial(_frozen_kernel, wave=wave, t_base=t_base, atten=atten),
        interpret, (vp, vs, rho, qsi, h_flat, vel_fac, rho_fac),
        nlay, (c, t, mm_frozen), (1.0, 1.0, 2), (c.dtype,))
    return f


@partial(jax.jit, static_argnames=("wave", "t_base", "atten", "interpret"))
def secular_lanes_grad(c, t, mm_frozen, vp, vs, rho, qsi, h_flat, vel_fac,
                       rho_fac, nlay, wave: str = "rayleigh",
                       t_base: float = 1.0, atten: bool = True,
                       interpret: bool = False):
    """(F, dF/dc, dF/dT) on a (K, B) lane grid at frozen truncation.

    Same lane layout and model transposition as :func:`secular_lanes`;
    ``mm_frozen`` must be >= 2 everywhere (the NEVILL frozen-mm
    convention — this entry point has no dynamic-truncation mode).
    The tangents follow the fixed-material convention of
    ``dispersion._group_velocity``:  dF/dT is the partial through the
    wavenumbers only, with the attenuated material held at ``t``.
    """
    return _lane_call(
        partial(_grad_kernel, wave=wave, t_base=t_base, atten=atten),
        interpret, (vp, vs, rho, qsi, h_flat, vel_fac, rho_fac),
        nlay, (c, t, mm_frozen), (1.0, 1.0, 2), (c.dtype,) * 3)


@partial(jax.jit, static_argnames=("wave", "t_base", "atten", "n_ill",
                                   "n_newton", "compute_group",
                                   "interpret"))
def refine_lanes(lo, hi, t, mm_frozen, vp, vs, rho, qsi, h_flat, vel_fac,
                 rho_fac, nlay, wave: str = "rayleigh",
                 t_base: float = 1.0, atten: bool = True, n_ill: int = 6,
                 n_newton: int = 2, compute_group: bool = True,
                 interpret: bool = False):
    """Refine (K, B) brackets to roots + group velocities, one kernel.

    Args mirror :func:`secular_lanes`; ``lo``/``hi`` bound each lane's
    root (a sign change inside is the caller's contract — lanes without
    one converge somewhere inside the cell and are masked by the
    caller's ``ok``).  Returns ``(root, u)``; ``u`` is zeros when
    ``compute_group`` is False or ``n_newton`` == 0.
    """
    return _lane_call(
        partial(_refine_kernel, wave=wave, t_base=t_base, atten=atten,
                n_ill=n_ill, n_newton=n_newton,
                compute_group=compute_group),
        interpret, (vp, vs, rho, qsi, h_flat, vel_fac, rho_fac), nlay,
        (lo, hi, t, mm_frozen), (1.0, 1.1, 1.0, 2), (lo.dtype,) * 2)
