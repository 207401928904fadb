"""Plain XLA (K, B) lane evaluators: the reference the kernels of
``ops/pallas_secular.py`` are checked against on the card.

Built from ``ops/secular.py`` (attenuation rescale, effective
halfspace, ``rayleigh_secular`` / ``love_secular``) vmapped over the
lane grid, with the kernels' signatures (``chip_smoke.py`` phase 2).
Run as the solver's lane evaluator on an H100 it was 20x slower end to
end than the Triton kernels (PERF.md), so it is a reference only.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from pysurfinv_tpu.ops.secular import (attenuation_rescale,
                                       effective_halfspace, love_secular,
                                       rayleigh_secular)


def _lane_model(tm, model, t_base, atten):
    """Attenuated + flattened (a, b, rho, d) columns at period ``tm``."""
    vp, vs, rho, qsi, hf, vf, rf = model
    a, b = (attenuation_rescale(vp, vs, qsi, tm, t_base) if atten
            else (vp, vs))
    return a * vf, b * vf, rho * rf, hf


def _lane_F(wave, c, t, mdl, mm):
    a, b, r, d = mdl
    if wave in ("rayleigh", "ray", "R"):
        return rayleigh_secular(c, t, a, b, r, d, mm)
    return love_secular(c, t, b, r, d, mm)


def _over_lanes(fn, c, t, mm, model, nlay, extra=()):
    """vmap ``fn(c, t, mm, *extra, model, nlay)`` over (K, B) lanes."""
    over_k = jax.vmap(fn, in_axes=(0, 0, 0) + (0,) * len(extra)
                      + (None, None))
    over_b = jax.vmap(over_k, in_axes=(1, 1, 1) + (1,) * len(extra)
                      + (1, 0), out_axes=1)
    return over_b(c, t, mm, *extra, model, nlay)


@partial(jax.jit, static_argnames=("wave", "fact", "t_base", "atten"))
def secular_lanes(c, t, mm_frozen, vp, vs, rho, qsi, h_flat, vel_fac,
                  rho_fac, nlay, wave: str = "rayleigh", fact: float = 4.0,
                  t_base: float = 1.0, atten: bool = True, t_mat=None):
    """XLA twin of :func:`pallas_secular.secular_lanes`."""
    model = (vp, vs, rho, qsi, h_flat, vel_fac, rho_fac)

    def lane(cv, tv, mmf, tmv, model, nl):
        mdl = _lane_model(tmv, model, t_base, atten)
        mm = jnp.where(mmf > 0, mmf,
                       effective_halfspace(cv, tv, mdl[1], mdl[3], nl, fact))
        return _lane_F(wave, cv, tv, mdl, mm), mdl[1][mm - 1], \
            mm.astype(jnp.int32)

    t_mat = t if t_mat is None else t_mat
    return _over_lanes(lane, c, t, mm_frozen, model, nlay, (t_mat,))


@partial(jax.jit, static_argnames=("wave", "t_base", "atten"))
def secular_lanes_frozen(c, t, mm_frozen, vp, vs, rho, qsi, h_flat,
                         vel_fac, rho_fac, nlay, wave: str = "rayleigh",
                         t_base: float = 1.0, atten: bool = True):
    """XLA twin of :func:`pallas_secular.secular_lanes_frozen`."""
    model = (vp, vs, rho, qsi, h_flat, vel_fac, rho_fac)

    def lane(cv, tv, mmf, model, nl):
        return _lane_F(wave, cv, tv, _lane_model(tv, model, t_base, atten),
                       mmf)

    return _over_lanes(lane, c, t, mm_frozen, model, nlay)


@partial(jax.jit, static_argnames=("wave", "t_base", "atten"))
def secular_lanes_grad(c, t, mm_frozen, vp, vs, rho, qsi, h_flat, vel_fac,
                       rho_fac, nlay, wave: str = "rayleigh",
                       t_base: float = 1.0, atten: bool = True):
    """XLA twin of :func:`pallas_secular.secular_lanes_grad` (tangents by
    ``jax.jvp`` with the material held at ``t``)."""
    model = (vp, vs, rho, qsi, h_flat, vel_fac, rho_fac)

    def lane(cv, tv, mmf, model, nl):
        mdl = _lane_model(tv, model, t_base, atten)

        def F(x, y):
            return _lane_F(wave, x, y, mdl, mmf)

        f, fc = jax.jvp(lambda x: F(x, tv), (cv,), (jnp.ones_like(cv),))
        _, ft = jax.jvp(lambda y: F(cv, y), (tv,), (jnp.ones_like(tv),))
        return f, fc, ft

    return _over_lanes(lane, c, t, mm_frozen, model, nlay)
