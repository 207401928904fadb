"""Gradient-informed (MALA) sampler — the AD-native capability.

The reference's Fortran stack can only do random-walk Metropolis: its
forward is an opaque f2py call, so no gradient of the likelihood
exists.  Here the whole forward — layer parameterisation, thermal
models, earth flattening, attenuation, secular function — is
differentiable JAX, so the Metropolis-adjusted Langevin algorithm
(MALA) comes almost for free:

    theta' = theta + (tau^2/2) M grad(log pi)(theta) + tau sqrt(M) xi
    log pi  = -chi^2_capped / 2   (+ prior indicator)

with the exact Metropolis-Hastings correction for the asymmetric
proposal.  ``M = diag(step_i^2)`` is the natural per-parameter
preconditioner — the same Brownian step scales the reference's YAML
carries for random walks.

Gradient path: the likelihood gradient w.r.t. theta runs through the
implicit function theorem at the solved roots,

    d chi / d theta = sum_p (d chi/d c_p) * ( -F_theta,p / F_c,p ),

evaluated as ONE vjp of the period-stacked XLA secular function
composed with the compiled model build (all plain AD; the roots come
from the fast Pallas solver and are held fixed — the same frozen-root
convention as ``ops.kernels.sensitivity_kernels``).

Proposal semantics differ deliberately from the RWM samplers: no
retry-until-prior loop — a proposal violating the bounds or the
``isgood`` prior is REJECTED by MH (alpha = 0), which targets exactly
posterior x prior-indicator.  Chains are validated against the host
oracle with the same statistical machinery as the RWM sampler
(``inversion.parity``; tests/test_posterior_parity.py's MALA variant).

Chain/row format is the reference npz convention (rows
``[misfit, L, accept] + theta`` per proposal, lanes = independent
chainL-step segments), so PostPoint / Model3D consume MALA chains
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
from pysurfinv_tpu.ops.dispersion import (SurfConfig, _secular_fn,
                                          surf_forward_batch)
from pysurfinv_tpu.ops.flatten import effective_thickness
from pysurfinv_tpu.ops.kernels import _flat_model
from pysurfinv_tpu.ops.secular import effective_halfspace


class MalaConfig(NamedTuple):
    tau: float = 0.8          # global step scale on the Brownian-step
    #                           preconditioner; tau=1 puts the NOISE at
    #                           the RWM step size while the drift pulls
    #                           downhill — MALA typically tolerates
    #                           larger tau than RWM at equal acceptance
    drift_max: float = 0.5    # truncated-MALA drift cap, in units of
    #                           the proposal NOISE scale (tau * step):
    #                           the chi^2 surface is steep near the
    #                           posterior (gradients reach O(1e2-1e3)
    #                           in step units), so the raw Langevin
    #                           drift overshoots catastrophically
    #                           (measured 2% acceptance); and a cap
    #                           LARGER than the noise kills the
    #                           reverse-density term instead (clipped
    #                           forward drift cannot be undone by a
    #                           clipped reverse drift, so |2D| >> noise
    #                           makes log q(rev) - log q(fwd) ~
    #                           -(2 drift_max)^2/... per parameter).
    #                           Capping at half the noise sd bounds the
    #                           asymmetry penalty at O(1).  The clip is
    #                           applied consistently in the proposal
    #                           AND both q densities — standard tMALA,
    #                           MH stays exact.
    chain_len: int = 1000
    misfit_fail: float = 88888.0


def _grad_chi_lane(cm, pcls, scfg: SurfConfig, wave: str):
    """Per-lane d(chi_capped)/d(theta) at frozen roots (vmappable)."""
    misfit_from_c = pcls._misfit_from_c
    kind = 1 if wave in ("love", "lov", "L") else 2
    F = _secular_fn(wave)

    def one(theta, psi, T, c_star, obs_c, uncer, obs_m):
        ok_p = c_star > 0.0
        # d chi / d c at the solved roots (soft cap included)
        def chi_of_c(c):
            return misfit_from_c(c, T, obs_c, uncer, obs_m,
                                 valid=obs_m)[1]
        dchi_dc = jax.grad(chi_of_c)(c_star)

        h0, vp0, vs0, rho0, qsi0, nlay = cm.build_profile(theta, psi)
        he0 = effective_thickness(h0, nlay)
        c_safe = jnp.where(ok_p, c_star, vs0[0] + 0.5)

        def mm_of(t, c0):
            mdl = _flat_model(t, vp0, vs0, rho0, he0, qsi0, nlay, kind,
                              scfg)
            return effective_halfspace(c0, t, mdl[1], mdl[3], nlay,
                                       scfg.fact)
        mms = jax.vmap(mm_of)(T, c_safe)

        def Fvec(th):
            h, vp, vs, rho, qsi, _ = cm.build_profile(th, psi)
            he = effective_thickness(h, nlay)

            def one_p(t, c0, mm):
                mdl = _flat_model(t, vp, vs, rho, he, qsi, nlay, kind,
                                  scfg)
                return F(c0, t, mdl, mm)
            return jax.vmap(one_p)(T, c_safe, mms)

        # F_c per period (frozen model of THIS theta)
        def Fc_p(t, c0, mm):
            mdl = _flat_model(t, vp0, vs0, rho0, he0, qsi0, nlay, kind,
                              scfg)
            return jax.grad(lambda cc: F(cc, t, mdl, mm))(c0)
        f_c = jax.vmap(Fc_p)(T, c_safe, mms)
        f_c = jnp.where(jnp.abs(f_c) > 0, f_c, 1.0)

        cot = jnp.where(ok_p, dchi_dc / f_c, 0.0)
        _, vjp = jax.vjp(Fvec, theta)
        g = -vjp(cot)[0]
        # failed lanes carry no usable gradient: fall back to pure
        # random walk there (zero drift)
        return jnp.where(jnp.any(ok_p), g, jnp.zeros_like(g))

    return one


def make_mala_sampler(cm: CompiledModel, pcls, scfg: SurfConfig,
                      wave: str, mcfg: MalaConfig):
    """(init_fn, run_fn) over batched lanes (lanes = chain segments).

    run_fn(carry, lane_keys, spec_b, ctx_b) -> (carry, rows) where rows
    is (chain_len, N, 3 + k): row 0 evaluates the start model with
    accept forced (the reference's reset-row convention), rows 1..
    are MALA proposals.
    """
    misfit_from_c = pcls._misfit_from_c
    glane = _grad_chi_lane(cm, pcls, scfg, wave)

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

    def grad_batch(thetas, ctx_b, cP):
        psi_b, per_b, c_b, u_b, m_b = ctx_b
        return jax.vmap(glane)(thetas, psi_b, per_b, cP, c_b, u_b, m_b)

    # start thetas: reuse the RWM init machinery (prior-accepted
    # uniform draws / the injected initMod theta)
    ccfg = ChainConfig(chain_len=mcfg.chain_len)
    rwm_init, _ = make_segmented_sampler(isgood,
                                         lambda th, cx, aux: None,
                                         ccfg,
                                         aux_init=lambda s, c: None)

    def init_fn(lane_keys, spec_b, ctx_b, theta_init_b, use_init_b):
        theta, *_ = rwm_init(lane_keys, spec_b, ctx_b, theta_init_b,
                             use_init_b)
        N, P = theta.shape[0], ctx_b[1].shape[1]
        z = jnp.zeros((N,), theta.dtype)
        return (theta, z, z, z, jnp.zeros_like(theta),
                jnp.zeros((N, P), theta.dtype))

    def run_fn(carry, lane_keys, spec_b, ctx_b):
        tau = mcfg.tau
        sd = spec_b.step            # (N, k) per-parameter scales
        M = sd * sd
        dmax = mcfg.drift_max * tau * sd

        def drift_of(ga):
            return jnp.clip(-0.25 * tau * tau * M * ga, -dmax, dmax)

        def logq(b, a, ga):
            """log q(a -> b) for the truncated drift at a."""
            mu = a + drift_of(ga)
            d = b - mu
            return -jnp.sum(d * d / (2.0 * tau * tau * M), axis=-1)

        # Step RNG folds start past the init folds (2*CL, 2*CL+1 used
        # by make_segmented_sampler's init, mcmc.py) so no step's
        # proposal/accept key can collide with an init draw for any
        # chain_len (advisor round-4 finding: 3r folds overlapped).
        fold0 = 2 * mcfg.chain_len + 2

        def step(carry, r):
            theta0, m0, chi0, L0, g0, cw = carry
            at_init = r == 0
            kx = jax.vmap(lambda lk: jax.random.fold_in(
                lk, fold0 + 3 * r))(lane_keys)
            xi = jax.vmap(lambda k, s: jax.random.normal(
                k, s.shape, s.dtype))(kx, sd)
            prop = theta0 + drift_of(g0) + tau * sd * xi
            prop = jnp.where(at_init, theta0, prop)

            in_b = jnp.all((prop >= spec_b.vmin) & (prop <= spec_b.vmax),
                           axis=-1)
            okp = in_b & jax.vmap(isgood, in_axes=(0, 0))(
                prop, ctx_b)

            m1, chi1, L1, cP1 = eval_batch(prop, ctx_b, cw)
            g1 = grad_batch(prop, ctx_b, cP1)

            log_a = (-(chi1 - chi0) / 2.0
                     + logq(theta0, prop, g1) - logq(prop, theta0, g0))
            u = jax.vmap(lambda lk: jax.random.uniform(
                jax.random.fold_in(lk, fold0 + 3 * r + 1),
                dtype=theta0.dtype))(lane_keys)
            accept = (jnp.log(u) < log_a) & okp \
                & (m1 < mcfg.misfit_fail)
            accept = at_init | accept

            dtype = theta0.dtype
            row = jnp.concatenate(
                [jnp.stack([m1, L1, accept.astype(dtype)], axis=1),
                 prop], axis=1)
            acc = accept[:, None]
            new = (jnp.where(acc, prop, theta0),
                   jnp.where(accept, m1, m0),
                   jnp.where(accept, chi1, chi0),
                   jnp.where(accept, L1, L0),
                   jnp.where(acc, g1, g0),
                   cP1)
            return new, row

        carry, rows = lax.scan(step, carry, jnp.arange(mcfg.chain_len))
        return carry, rows

    return init_fn, run_fn


def mala_point(point, outdir="MCtest_mala", pid=None, runN=6000,
               chainL=200, seed=42, tau=0.8, wave="rayleigh",
               scfg: SurfConfig | None = None, verbose=False,
               init_all=False):
    """Run MALA chains for one Point; write the reference-format npz.

    Lanes = runN//chainL independent chain segments (chain 0 starts
    from ``initMod``, the rest from prior-accepted uniform draws), so
    the output is directly comparable to ``Point.MCinvMP`` /
    ``invert_grid`` chains — including by the posterior-parity
    comparator (``inversion.parity``).

    ``init_all``: start EVERY lane from ``initMod`` instead of uniform
    draws.  MALA's capped drift mixes slowly, so short uniform-start chains may not descend to the
    posterior within chainL; initMod starts isolate posterior
    correctness from burn-in for the parity gate.
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
    spec = BrownianSpec(*[jnp.repeat(jnp.asarray(f)[None], n_chains, 0)
                          for f in spec1])
    T, c_obs, unc, m_obs = point._obs_arrays()
    rep = lambda x: jnp.repeat(jnp.asarray(x)[None], n_chains, 0)  # noqa
    ctx = (rep(psi1), rep(T), rep(c_obs), rep(unc), rep(m_obs))

    mcfg = MalaConfig(tau=tau, chain_len=chainL)
    init_fn, run_fn = make_mala_sampler(cm, type(point), scfg, wave,
                                        mcfg)
    key0 = jax.random.PRNGKey(seed)
    lane_keys = jax.vmap(lambda i: jax.random.fold_in(key0, i))(
        jnp.arange(n_chains))
    use_init = (jnp.ones(n_chains, bool) if init_all
                else jnp.arange(n_chains) == 0)
    theta0_b = spec.theta0

    init = jax.jit(init_fn)
    run = jax.jit(run_fn)
    carry = init(lane_keys, spec, ctx, theta0_b, use_init)
    carry, rows = run(carry, lane_keys, spec, ctx)
    rows = np.asarray(rows)                       # (chainL, N, 3+k)
    track = np.moveaxis(rows, 0, 1).reshape(-1, rows.shape[-1])
    pid = pid or point.pid
    point._save_npz(outdir, pid, track, chainL)
    if verbose:
        acc = track[:, 2].mean()
        print(f"mala_point: {n_chains} x {chainL} steps in "
              f"{time.time() - t0:.1f}s, acceptance {acc:.3f}")
    return os.path.join(outdir, f"{pid}.npz")
